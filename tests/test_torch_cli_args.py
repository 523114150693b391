"""The port's config classes against the JAX package's, field for field.

- Every dataclass the two `cli_args.py` share: the same field names in the
  same order, the same annotations (`JaxDecodeConfig` is the port's
  `TorchDecodeConfig`) and the same defaults, nested configs included
  (compared through `to_dict`). Exact equality.
- Every `examples/configs/*.yaml` under every experiment class: whatever
  the JAX `load_expr_config` accepts, the port's accepts with the same
  values, and its `check_supported` methods either pass or refuse with
  `NotImplementedError` naming a ROADMAP queue-1 item; never an unknown
  field. The same for one override of each of the nine fields the port
  used to reject.
- The refusals: a value that selects an unported feature names its item;
  the defaults pass every check.
"""

import dataclasses
from pathlib import Path

import pytest

from areal_tpu.api import cli_args as j_cli
from areal_tpu.utils import structured as j_struct
from areal_tpu_torch.api import cli_args as t_cli
from areal_tpu_torch.utils import structured as t_struct

ROOT = Path(__file__).resolve().parents[1]
YAMLS = sorted((ROOT / "examples" / "configs").glob("*.yaml"))
EXPERIMENTS = ("GRPOConfig", "PPOConfig", "SFTConfig", "RWConfig")
# the port's name for a JAX class
RENAMED = {"JaxDecodeConfig": "TorchDecodeConfig"}


def _shared() -> list[str]:
    names = []
    for name, obj in vars(j_cli).items():
        if isinstance(obj, type) and dataclasses.is_dataclass(obj):
            if hasattr(t_cli, RENAMED.get(name, name)):
                names.append(name)
    return sorted(names)


SHARED = _shared()


def test_every_jax_dataclass_is_shared():
    """Every dataclass of the JAX module has its counterpart in the port."""
    jax_classes = {n for n, o in vars(j_cli).items()
                   if isinstance(o, type) and dataclasses.is_dataclass(o)}
    assert set(SHARED) == jax_classes
    assert len(SHARED) >= 31


def _default(f):
    if f.default is not dataclasses.MISSING:
        return f.default
    if f.default_factory is not dataclasses.MISSING:
        return f.default_factory()
    return dataclasses.MISSING


def _annotation(tp: str) -> str:
    for j, t in RENAMED.items():
        tp = tp.replace(j, t)
    return tp


@pytest.mark.parametrize("name", SHARED)
def test_dataclass_fields_match(name):
    jc, tc = getattr(j_cli, name), getattr(t_cli, RENAMED.get(name, name))
    jf, tf = dataclasses.fields(jc), dataclasses.fields(tc)
    assert [f.name for f in jf] == [f.name for f in tf]
    for a, b in zip(jf, tf):
        assert _annotation(str(a.type)) == str(b.type), (name, a.name)
        da, db = _default(a), _default(b)
        if dataclasses.is_dataclass(da):
            assert j_struct.to_dict(da) == t_struct.to_dict(db), (name, a.name)
        else:
            assert da == db, (name, a.name)


def _checks(cfg):
    """Every `check_supported` of the config tree, the root's first."""
    out = []

    def walk(node):
        if dataclasses.is_dataclass(node):
            if hasattr(node, "check_supported"):
                out.append(node.check_supported)
            for f in dataclasses.fields(node):
                walk(getattr(node, f.name))

    walk(cfg)
    return out


def _load_both(argv, cls_name):
    """(JAX config or its exception, the port's config or its exception)."""
    out = []
    for mod in (j_cli, t_cli):
        try:
            out.append(mod.load_expr_config(argv, getattr(mod, cls_name))[0])
        except Exception as e:  # noqa: BLE001 — compared below
            out.append(e)
    return out


def _port_accepts(jc, tc, what):
    """The port loads what JAX loaded, to the same values, and each of its
    checks passes or names a queue-1 item."""
    assert not isinstance(tc, Exception), f"{what}: the port raised {tc!r}"
    tj, tt = j_struct.to_dict(jc), t_struct.to_dict(tc)
    assert tj == tt, what
    refused = []
    for check in _checks(tc):
        try:
            check()
        except NotImplementedError as e:
            assert "ROADMAP.md queue 1, item" in str(e), (what, str(e))
            refused.append(str(e))
    return refused


@pytest.mark.parametrize("yaml_path", YAMLS, ids=[p.stem for p in YAMLS])
def test_example_yaml_loads_as_in_jax(yaml_path, tmp_path):
    accepted = 0
    for cls_name in EXPERIMENTS:
        argv = ["--config", str(yaml_path), f"cluster.fileroot={tmp_path}"]
        jc, tc = _load_both(argv, cls_name)
        if isinstance(jc, Exception):
            continue
        accepted += 1
        _port_accepts(jc, tc, f"{yaml_path.name} as {cls_name}")
    assert accepted, f"the JAX loader accepts {yaml_path.name} under no experiment class"


# the nine overrides the port's loader used to reject (ROADMAP queue 3,
# fault 1), on the GRPO smoke yaml
OVERRIDES = [
    "gconfig.top_k=50", "gconfig.max_tokens=512", "train_dataset.num_workers=4",
    "recover.retries=5", "stats_logger.tensorboard.path=/tmp/tb", "total_train_n_seqs=1000",
    "rollout.weight_sync_overlap=false", "actor.jax.zero1_optimizer=false", "cluster.n_nodes=2",
    # refused until the fault-injection harness came (ROADMAP queue 1, item 7)
    "rollout.fault_injection.enabled=true",
    # refused until the host KV tier and the gather paths came (item 3)
    "decode.paged_attn_impl=xla", "decode.kv_layout=workspace", "decode.kv_host_pool_mb=64",
    # refused until the router and the supervisor came (item 4.2)
    "launcher.supervisor.enabled=true",
    # refused until the prefill/decode roles came (item 4.3)
    "decode.role=prefill", "decode.role=decode",
]


@pytest.mark.parametrize("override", OVERRIDES)
def test_override_loads_as_in_jax(override):
    argv = ["--config", str(ROOT / "examples/configs/arith_grpo_smoke.yaml"), override]
    jc, tc = _load_both(argv, "GRPOConfig")
    assert not isinstance(jc, Exception), jc
    _port_accepts(jc, tc, override)


# a value that selects an unported feature, and the item that ports it
REFUSALS = [
    ("stats_logger.wandb.mode=online", "item 7"),
    ("stats_logger.swanlab.mode=cloud", "item 7"),
    ("stats_logger.tensorboard.path=/tmp/tb", "item 7"),
    # prefill replicas need more than one generation server (item 4.1);
    # the roles themselves are accepted since they came (items 4.3-4.4)
    ("launcher.prefill_replicas=1", "item 4.1"),
    # the supervisor runs as its own process and is accepted since it came
    # (item 4.2); tensor-parallel serving is still refused
    ("decode.tensor_parallel_size=2", "item 5"),
    ("cluster.n_nodes=2", "item 5"),
    ("launcher.prefill_replicas=2", "item 4.1"),
    ("decode.tensor_parallel_size=4", "item 5"),
    ("actor.jax.virtual_pp_size=2", "item 5"),
    ("actor.jax.mesh_num_slices=2", "item 5"),
    ("actor.jax.offload_params=true", "item 7"),
]


@pytest.mark.parametrize("override,item", REFUSALS, ids=[o for o, _ in REFUSALS])
def test_unported_value_is_refused_with_its_item(override, item):
    argv = ["--config", str(ROOT / "examples/configs/arith_grpo_smoke.yaml"), override]
    jc, tc = _load_both(argv, "GRPOConfig")
    assert not isinstance(jc, Exception), jc
    refused = _port_accepts(jc, tc, override)
    assert refused and all(f"queue 1, {item}" in r for r in refused), refused


@pytest.mark.parametrize("cls_name", EXPERIMENTS)
def test_defaults_pass_every_check(cls_name):
    for check in _checks(getattr(t_cli, cls_name)()):
        check()


def test_unknown_field_still_raises():
    with pytest.raises(t_struct.UnknownFieldError):
        t_cli.load_expr_config(["--config", str(YAMLS[0]), "decode.no_such_knob=1"],
                               t_cli.GRPOConfig)
