"""Structured-config plumbing: nested dataclass <-> dict conversion and
dotted-path CLI overrides with type coercion (a copy of
`areal_tpu/utils/structured.py`, same names and semantics):

- YAML files populate nested dataclasses field-by-field; unknown keys raise.
- ``key.subkey=value`` overrides are applied after the file, coerced to the
  annotated type (including Optional[...], lists, bools and enums).
"""

from __future__ import annotations

import dataclasses
import types
import typing
from typing import Any


def is_dataclass_type(tp) -> bool:
    return isinstance(tp, type) and dataclasses.is_dataclass(tp)


def _unwrap_optional(tp):
    """Return (inner_type, is_optional) for Optional[...]/X|None annotations."""
    origin = typing.get_origin(tp)
    if origin is typing.Union or origin is types.UnionType:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0], True
        return tp, True
    return tp, False


def to_dict(obj: Any) -> Any:
    """Recursively convert dataclasses to plain dicts (YAML-safe)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            f.name: to_dict(getattr(obj, f.name)) for f in dataclasses.fields(obj)
        }
    if isinstance(obj, dict):
        return {k: to_dict(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_dict(v) for v in obj]
    return obj


def from_dict(cls, data: dict | None, ignore_unknown: bool = False):
    """Build dataclass `cls` from a nested dict, validating field names.
    `ignore_unknown=True` drops keys `cls` lacks: a reader of a subset
    view (the launcher reads an entry point's YAML as
    `BaseExperimentConfig`)."""
    if data is None:
        return cls()
    if not is_dataclass_type(cls):
        raise TypeError(f"{cls} is not a dataclass")
    field_map = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in data.items():
        if key not in field_map:
            if ignore_unknown:
                continue
            raise ValueError(f"unknown config field {cls.__name__}.{key}")
        f = field_map[key]
        tp, _ = _unwrap_optional(f.type if not isinstance(f.type, str) else _resolve(cls, f.name))
        if is_dataclass_type(tp) and isinstance(value, dict):
            kwargs[key] = from_dict(tp, value, ignore_unknown=ignore_unknown)
        else:
            kwargs[key] = value
    return cls(**kwargs)


def _resolve(cls, field_name: str):
    """Resolve string annotations (from __future__ annotations)."""
    hints = typing.get_type_hints(cls)
    return hints[field_name]


class UnknownFieldError(ValueError):
    """An override names a field the target config class does not have."""


def apply_override(obj: Any, dotted_key: str, raw_value: str) -> None:
    """Apply one `a.b.c=value` override in place, coercing to the field type."""
    parts = dotted_key.split(".")
    target = obj
    for part in parts[:-1]:
        if not hasattr(target, part):
            raise UnknownFieldError(f"unknown config field {dotted_key!r}")
        nxt = getattr(target, part)
        if nxt is None:
            # Instantiate Optional nested configs on demand.
            hints = typing.get_type_hints(type(target))
            tp, _ = _unwrap_optional(hints[part])
            if is_dataclass_type(tp):
                nxt = tp()
                setattr(target, part, nxt)
            else:
                raise ValueError(f"cannot descend into None field {part!r}")
        target = nxt
    leaf = parts[-1]
    if not hasattr(target, leaf):
        raise UnknownFieldError(f"unknown config field {dotted_key!r}")
    hints = typing.get_type_hints(type(target))
    tp, optional = _unwrap_optional(hints[leaf])
    setattr(target, leaf, coerce(raw_value, tp, optional))


def coerce(raw: Any, tp, optional: bool = False):
    """Coerce a raw (usually string) CLI value to annotation `tp`."""
    if raw is None:
        return None
    if isinstance(raw, str) and optional and raw.lower() in ("none", "null", "~"):
        return None
    origin = typing.get_origin(tp)
    if origin in (list, tuple):
        inner = (typing.get_args(tp) or (str,))[0]
        if isinstance(raw, str):
            raw = [x for x in raw.strip("[]").split(",") if x != ""]
        seq = [coerce(x.strip() if isinstance(x, str) else x, inner) for x in raw]
        return tuple(seq) if origin is tuple else seq
    if origin is dict:
        if isinstance(raw, dict):
            return raw
        raise ValueError(f"cannot coerce {raw!r} to dict")
    if tp is bool:
        if isinstance(raw, bool):
            return raw
        if raw.lower() in ("1", "true", "yes", "on"):
            return True
        if raw.lower() in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"cannot coerce {raw!r} to bool")
    if tp is int:
        return int(raw)
    if tp is float:
        return float(raw)
    if tp is str or tp is Any:
        return str(raw)
    if is_dataclass_type(tp) and isinstance(raw, dict):
        return from_dict(tp, raw)
    return raw
