"""Trainer -> decode-server weight transfer: the "dcn" wire format
(counterpart of `areal_tpu/core/weight_transfer.py`, byte for byte).

One POST body ("frame") per bucket:

    [8 bytes little-endian manifest length][manifest JSON][raw tensor bytes]

The manifest lists {name, shape, dtype, offset, nbytes, part_offset,
total_nbytes} per tensor part, in that key order and with `json.dumps`'
default separators, so the same named arrays give the same bytes in both
packages. Tensor bytes are the arrays' native layouts (bfloat16 stays
bfloat16). A frame holds at most `chunk_mb`; a larger tensor is split
into byte-range parts across frames.

`pack_frames` yields each frame as a list of buffers (the header, then
zero-copy byte views of the tensors) for a sender that writes them to the
socket one by one; `pack_buckets` joins them into the JAX package's
`bytes` frames. `WeightStaging` reassembles frames in any order, counting
each byte once (duplicate and re-split retry frames are safe) and
rejecting a torn frame before anything of it is staged; finished tensors
are host torch tensors.

The KV-session frames (`pack_kv_session`, `unpack_kv_sessions`) come with
session migration, ROADMAP.md queue 1, item 3.4.
"""

from __future__ import annotations

import collections
import json
import struct
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from areal_tpu_torch.core import fault_injection
from areal_tpu_torch.utils import logging

logger = logging.getLogger("weight_transfer")

# wire dtype names (numpy's, and "bfloat16" as ml_dtypes names it)
_DTYPES = {
    "float64": torch.float64,
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int64": torch.int64,
    "int32": torch.int32,
    "int16": torch.int16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "bool": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def torch_wire_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"wire dtype {name!r} not in {sorted(_DTYPES)}")
    return _DTYPES[name]


def wire_dtype_name(arr) -> str:
    if isinstance(arr, torch.Tensor):
        return _NAMES[arr.dtype]
    return np.asarray(arr).dtype.name


def _shape(arr) -> list[int]:
    # a 0-d array travels as shape [1], as numpy's ascontiguousarray
    # makes it in the JAX packer
    return [int(d) for d in arr.shape] or [1]


def _byte_view(arr) -> memoryview:
    """The flat bytes of a host tensor or array, without a copy when it is
    already contiguous."""
    if isinstance(arr, torch.Tensor):
        if arr.device.type != "cpu":
            raise ValueError("pack a host tensor: copy it off the device first")
        return memoryview(arr.contiguous().reshape(-1).view(torch.uint8).numpy())
    return memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def flatten_named(tree: Any, prefix: tuple[str, ...] = ()) -> dict[str, Any]:
    """Nested dict -> {"a/b/c": leaf}; leaves are kept as they are."""
    return dict(named_leaves(tree, prefix))


def named_leaves(tree: Any, prefix: tuple[str, ...] = ()) -> Iterator[tuple[str, Any]]:
    """Lazy `flatten_named`: yields ("a/b/c", leaf) without touching the
    leaves' bytes."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, prefix + (str(k),))
    else:
        yield "/".join(prefix), tree


def iter_prefetched(items: Iterable[tuple[str, Any]], window: int = 2
                    ) -> Iterator[tuple[str, Any]]:
    """Yield (name, host tensor) with the copies of the next `window`
    device tensors to the host already running: each copy goes on a side
    stream into a pinned buffer, and a tensor is yielded once its copy's
    event has completed, so packing and sending tensor N overlap the
    copies of N+1..N+window. Host tensors and arrays pass through."""
    window = max(int(window), 1)
    pending: collections.deque = collections.deque()
    streams: dict[torch.device, torch.cuda.Stream] = {}

    def start(name: str, leaf: Any):
        if not (isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda"):
            return name, leaf, None
        side = streams.get(leaf.device)
        if side is None:
            side = streams[leaf.device] = torch.cuda.Stream(leaf.device)
        side.wait_stream(torch.cuda.current_stream(leaf.device))
        with torch.cuda.stream(side):
            host = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
            host.copy_(leaf, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        # the producer may drop the device tensor now: its memory is not
        # reused until the side stream's copy has read it
        leaf.record_stream(side)
        return name, host, done

    def finish(rec):
        name, host, done = rec
        if done is not None:
            done.synchronize()
        return name, host

    for name, leaf in items:
        pending.append(start(name, leaf))
        if len(pending) > window:
            yield finish(pending.popleft())
    while pending:
        yield finish(pending.popleft())


def set_named(tree: Any, named: dict[str, Any], cast=None) -> Any:
    """Replace leaves of a nested dict by name; an unknown name raises
    KeyError, a missing one keeps the old leaf. Returns a new tree."""
    used: set[str] = set()

    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, prefix + (str(k),)) for k, v in node.items()}
        name = "/".join(prefix)
        if name in named:
            used.add(name)
            return cast(named[name], node) if cast is not None else named[name]
        return node

    new = walk(tree, ())
    unknown = set(named) - used
    if unknown:
        raise KeyError(f"weight names not in target tree: {sorted(unknown)[:5]}")
    return new


def pack_frames(named: dict[str, Any] | Iterable[tuple[str, Any]], chunk_mb: float = 512
                ) -> Iterator[list]:
    """Yield each frame as [header bytes, byte views...], its parts in
    wire order. A frame is at most `chunk_mb`; a larger tensor is split
    into parts. `named` is a dict or any (name, host tensor or array)
    iterable, consumed lazily, so a prefetching producer
    (`iter_prefetched`) overlaps the sends downstream."""
    limit = max(int(chunk_mb * 1024 * 1024), 1)
    manifest: list[dict] = []
    chunks: list[memoryview] = []
    size = 0

    def flush() -> list:
        nonlocal manifest, chunks, size
        mjson = json.dumps(manifest).encode()
        parts = [struct.pack("<Q", len(mjson)) + mjson, *chunks]
        manifest, chunks, size = [], [], 0
        return parts

    items = named.items() if hasattr(named, "items") else named
    for name, arr in items:
        raw = _byte_view(arr)
        shape, dtype = _shape(arr), wire_dtype_name(arr)
        total = raw.nbytes
        part_off = 0
        while True:
            take = min(limit - size, total - part_off)
            manifest.append(dict(name=name, shape=shape, dtype=dtype, offset=size,
                                 nbytes=take, part_offset=part_off, total_nbytes=total))
            chunks.append(raw[part_off : part_off + take])
            size += take
            part_off += take
            if size >= limit:
                yield flush()
            if part_off >= total:
                break
    if manifest:
        yield flush()


def pack_buckets(named: dict[str, Any] | Iterable[tuple[str, Any]], chunk_mb: float = 512
                 ) -> Iterator[bytes]:
    """`pack_frames` with each frame joined into one `bytes`: the JAX
    package's frames, byte for byte."""
    for parts in pack_frames(named, chunk_mb):
        yield b"".join(parts)


def frame_nbytes(parts: list) -> int:
    return sum(memoryview(p).nbytes for p in parts)


def raw_wire_nbytes(name: str, nbytes: int, dtype: str) -> int:
    """bf16-equivalent wire cost of one tensor (part): an int8 `.../q`
    leaf stands for a bf16 kernel of twice its bytes, and its `.../scale`
    sibling would not exist on the fp wire; everything else counts as
    sent. Raw over sent is the weight sync's compression ratio."""
    leaf = name.rsplit("/", 1)[-1]
    if leaf == "q" and dtype == "int8":
        return nbytes * 2
    if leaf == "scale" and dtype == "float32":
        return 0
    return nbytes


def _manifest(payload) -> tuple[list[dict], int]:
    view = memoryview(payload)
    if view.nbytes < 8:
        raise ValueError(f"torn weight frame: {view.nbytes} bytes, no header")
    (mlen,) = struct.unpack_from("<Q", view, 0)
    if view.nbytes < 8 + mlen:
        raise ValueError(
            f"torn weight frame: manifest needs {8 + mlen} bytes, got {view.nbytes}"
        )
    return json.loads(bytes(view[8 : 8 + mlen]).decode()), 8 + mlen


def frame_raw_nbytes(payload) -> int:
    """`raw_wire_nbytes` summed over one frame's manifest."""
    manifest, _ = _manifest(payload)
    return sum(raw_wire_nbytes(s["name"], s["nbytes"], s["dtype"]) for s in manifest)


def unpack_bucket_parts(payload) -> list[tuple[dict, memoryview]]:
    """One frame -> [(spec, raw bytes view)], the parts of possibly split
    tensors. A torn frame (shorter than its manifest says) raises
    ValueError before anything is staged; the sender's retry sends the
    whole frame again."""
    manifest, base = _manifest(payload)
    view = memoryview(payload)
    need = max((s["offset"] + s["nbytes"] for s in manifest), default=0)
    if view.nbytes < base + need:
        raise ValueError(
            f"torn weight frame: body needs {need} tensor bytes, got {view.nbytes - base}"
        )
    return [(s, view[base + s["offset"] : base + s["offset"] + s["nbytes"]]) for s in manifest]


def _merge_interval(intervals: list[tuple[int, int]], start: int, end: int
                    ) -> list[tuple[int, int]]:
    """Insert [start, end) into sorted disjoint intervals, merging overlaps
    and neighbours."""
    out: list[tuple[int, int]] = []
    placed = False
    for s, e in intervals:
        if e < start or s > end:  # disjoint, not even touching
            if s > end and not placed:
                out.append((start, end))
                placed = True
            out.append((s, e))
        else:
            start, end = min(s, start), max(e, end)
    if not placed:
        out.append((start, end))
        out.sort()
    return out


class WeightStaging:
    """Server-side accumulator: frames in any order, a tensor finished
    once all its bytes have arrived. Coverage is kept as merged byte
    intervals, so duplicate frames (a retried POST the server had already
    applied) and a retry that splits a tensor differently count each byte
    once and never finish a tensor with a hole; parts of a finished tensor
    are dropped."""

    def __init__(self):
        self._bufs: dict[str, bytearray] = {}
        self._meta: dict[str, dict] = {}
        self._parts: dict[str, list[tuple[int, int]]] = {}
        self.ready: dict[str, torch.Tensor] = {}

    def __len__(self) -> int:
        return len(self.ready)

    @property
    def n_partial(self) -> int:
        """Tensors with some bytes staged and some missing."""
        return len(self._bufs)

    def reset(self) -> None:
        self._bufs.clear()
        self._meta.clear()
        self._parts.clear()
        self.ready.clear()

    def add_bucket(self, payload) -> None:
        # staging seam (JAX :305-313): an abort is a frame lost between the
        # receive and the staging; a torn frame fails the manifest length
        # check in `unpack_bucket_parts` before a byte stages. Either way the
        # client's retry sends the whole frame again.
        inj = fault_injection.get()
        if inj is not None:
            inj.fire("weight.stage.add", nbytes=memoryview(payload).nbytes)
            payload = inj.tear("weight.stage.add", payload)
        for spec, raw in unpack_bucket_parts(payload):
            name = spec["name"]
            if name in self.ready:
                continue
            total = spec["total_nbytes"]
            if name not in self._bufs:
                self._bufs[name] = bytearray(total)
                self._meta[name] = spec
                self._parts[name] = []
            off = spec["part_offset"]
            self._bufs[name][off : off + raw.nbytes] = raw
            self._parts[name] = _merge_interval(self._parts[name], off, off + raw.nbytes)
            if sum(e - s for s, e in self._parts[name]) >= total:
                m = self._meta.pop(name)
                buf = self._bufs.pop(name)
                self._parts.pop(name)
                dtype = torch_wire_dtype(m["dtype"])
                t = torch.frombuffer(buf, dtype=dtype) if total else torch.empty(0, dtype=dtype)
                self.ready[name] = t.reshape(m["shape"])

    def finalize(self) -> dict[str, torch.Tensor]:
        if self._bufs:
            raise RuntimeError(
                f"incomplete weight transfer: missing bytes for {sorted(self._bufs)[:5]}"
            )
        out, self.ready = self.ready, {}
        return out


def unpack_bucket(payload) -> dict[str, torch.Tensor]:
    """One complete frame -> its tensors."""
    st = WeightStaging()
    st.add_bucket(payload)
    return st.finalize()
