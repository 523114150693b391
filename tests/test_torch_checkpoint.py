"""Checkpoints and recovery of the port against the JAX package, on the CPU.

- HF export (`models/hf_io.py`): the port's `model.safetensors`, read by
  the JAX `load_hf_params` and moved into the port by `convert.py`, equals
  the port's parameters bit for bit; the JAX `save_hf_params` file, read by
  the port, equals the JAX parameters bit for bit; both writers write the
  same names, dtypes (bf16 as F32) and values. Tied and untied heads,
  scanned and unscanned layouts.
- The engine's recovery format ("torch"): parameters, AdamW's moments and
  count, step count and version come back exactly, through
  `torch.load(weights_only=True)`; the next step equals the step of the
  engine that was saved, bit for bit; `train_meta.json` has the JAX keys;
  "orbax" is refused.
- `tests/test_recover.py`'s cases, each run on the JAX `RecoverHandler`
  and the port's with the same stand-in engine and compared (layouts,
  counters, the step loaded, the gates' firing), plus the saver's and the
  evaluator's gates and a full-state round trip on `TorchLMEngine`.
- 2 steps, a dump, a resume and 2 more steps of the SFT entry point equal
  4 uninterrupted steps bit for bit (losses and final parameters). On the
  CPU the embedding's backward (an accumulating `index_put_`) adds from
  several threads in no fixed order, so these runs set
  `torch.use_deterministic_algorithms`.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from areal_tpu.api import cli_args as j_cli
from areal_tpu.api import io_struct as j_io
from areal_tpu.models import hf_io as j_hf
from areal_tpu.models import qwen2 as jq
from areal_tpu.utils import recover as j_rec
from areal_tpu_torch.api import cli_args as t_cli
from areal_tpu_torch.api import io_struct as t_io
from areal_tpu_torch.api.io_struct import FinetuneSpec, SaveLoadMeta, StepInfo
from areal_tpu_torch.dataset import SimpleDataLoader
from areal_tpu_torch.engine import torch_engine
from areal_tpu_torch.engine.sft.lm_engine import TorchLMEngine
from areal_tpu_torch.models import hf_io as t_hf
from areal_tpu_torch.models import qwen2 as tq
from areal_tpu_torch.models.convert import params_from_numpy
from areal_tpu_torch.utils import recover as t_rec
from areal_tpu_torch.utils.data import pad_sequences_to_tensors
from areal_tpu_torch.utils.evaluator import Evaluator
from areal_tpu_torch.utils.saver import Saver

MODEL = dict(vocab_size=64, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2)
FT = FinetuneSpec(total_train_epochs=2, dataset_size=16, train_batch_size=4)


@pytest.fixture
def deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


# ---------------------------------------------------------------------------
# HF safetensors, both ways
# ---------------------------------------------------------------------------

HF_CASES = [(True, "bfloat16", False), (False, "bfloat16", True), (False, "float32", False)]
HF_IDS = ["tied-bf16", "untied-bf16-scanned", "untied-f32"]


def _jax_weights(tie: bool, dtype: str):
    kw = dict(MODEL, tie_word_embeddings=tie, dtype=dtype, param_dtype=dtype)
    jcfg = jq.ModelConfig(**kw)
    jparams = jax.jit(jq.init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(7))
    return kw, jcfg, jparams, jax.tree.map(np.asarray, jparams)


def _equal(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("tie,dtype,scan", HF_CASES, ids=HF_IDS)
def test_port_export_read_by_jax(tie, dtype, scan, tmp_path):
    kw, jcfg, _, tree = _jax_weights(tie, dtype)
    tcfg = tq.ModelConfig(**kw, scan_layers=scan)
    params = params_from_numpy(tree, tcfg)
    t_hf.save_hf_params(params, tcfg, str(tmp_path))
    back = jax.tree.map(np.asarray, j_hf.load_hf_params(str(tmp_path), jcfg))
    _equal(params_from_numpy(back, tcfg), params)


@pytest.mark.parametrize("tie,dtype,scan", HF_CASES, ids=HF_IDS)
def test_jax_export_read_by_port(tie, dtype, scan, tmp_path):
    kw, jcfg, jparams, tree = _jax_weights(tie, dtype)
    tcfg = tq.ModelConfig(**kw, scan_layers=scan)
    j_hf.save_hf_params(jparams, jcfg, str(tmp_path / "jax"))
    _equal(t_hf.load_hf_params(str(tmp_path / "jax"), tcfg), params_from_numpy(tree, tcfg))
    # the two writers write the same tensors: names, dtypes, values
    t_hf.save_hf_params(params_from_numpy(tree, tcfg), tcfg, str(tmp_path / "port"))
    a = t_hf.read_safetensors(str(tmp_path / "jax" / "model.safetensors"))
    b = t_hf.read_safetensors(str(tmp_path / "port" / "model.safetensors"))
    _equal(a, b)
    assert {t.dtype for t in b.values()} == {torch.float32}
    assert ("lm_head.weight" in b) == (not tie)


def test_hf_refuses_other_families(tmp_path):
    cfg = tq.ModelConfig(**MODEL, model_type="gpt2")
    with pytest.raises(NotImplementedError, match="item 6.7"):
        t_hf.load_hf_params(str(tmp_path), cfg)


def test_hf_reads_the_vision_tower(tmp_path):
    """A checkpoint holding a language model and a Qwen2.5-VL tower: the
    language loader skips `visual.*`, and `load_hf_vision_params` reads
    the tower, equal to JAX's loader leaf for leaf and to the tensors
    written (`tests/test_torch_qwen2_vl.py` holds both families)."""
    from areal_tpu.models import qwen2_vl as jv
    from areal_tpu_torch.models import qwen2_vl as tv

    vc = dict(hidden_size=16, depth=2, num_heads=2, intermediate_size=32, patch_size=2,
              temporal_patch_size=1, out_hidden_size=MODEL["hidden_size"])
    vcfg, jvcfg = tv.VisionConfig.from_hf_dict(vc), jv.VisionConfig.from_hf_dict(vc)
    vis = tv.init_vision_params(vcfg, torch.Generator().manual_seed(5))
    tensors = {"visual.patch_embed.proj.weight": vis["patch_embed/kernel"].t().reshape(
        16, 3, 1, 2, 2).contiguous(), "visual.merger.ln_q.weight": vis["merger/ln_q/scale"]}
    for k in ("fc1", "fc2"):
        i = "0" if k == "fc1" else "2"
        tensors[f"visual.merger.mlp.{i}.weight"] = vis[f"merger/{k}_kernel"].t().contiguous()
        tensors[f"visual.merger.mlp.{i}.bias"] = vis[f"merger/{k}_bias"]
    for b in range(2):
        p = f"visual.blocks.{b}."
        tensors[p + "norm1.weight"] = vis["blocks/norm1/scale"][b]
        tensors[p + "norm2.weight"] = vis["blocks/norm2/scale"][b]
        tensors[p + "attn.qkv.weight"] = vis["blocks/attn/qkv_kernel"][b].reshape(
            16, 48).t().contiguous()
        tensors[p + "attn.qkv.bias"] = vis["blocks/attn/qkv_bias"][b].reshape(48)
        tensors[p + "attn.proj.weight"] = vis["blocks/attn/proj_kernel"][b].reshape(
            16, 16).t().contiguous()
        tensors[p + "attn.proj.bias"] = vis["blocks/attn/proj_bias"][b]
        for m in ("gate", "up", "down"):
            tensors[p + f"mlp.{m}_proj.weight"] = vis[f"blocks/mlp/{m}_kernel"][b].t().contiguous()
            tensors[p + f"mlp.{m}_proj.bias"] = vis[f"blocks/mlp/{m}_bias"][b]
    cfg = tq.ModelConfig(**MODEL)
    lm = tq.init_params(cfg, torch.Generator().manual_seed(6))
    t_hf.save_hf_params(lm, cfg, str(tmp_path))
    t_hf.write_safetensors(tensors, str(tmp_path / "visual.safetensors"))
    shards = {"model.safetensors": t_hf.read_safetensors(str(tmp_path / "model.safetensors")),
              "visual.safetensors": tensors}
    weight_map = {n: f for f, ts in shards.items() for n in ts}
    (tmp_path / "model.safetensors.index.json").write_text(
        json.dumps(dict(metadata=dict(total_size=0), weight_map=weight_map)))
    got = t_hf.load_hf_vision_params(str(tmp_path), vcfg)
    assert set(got) == set(vis)
    for name, t in vis.items():
        assert torch.equal(got[name], t), name
    want = j_hf.load_hf_vision_params(str(tmp_path), jvcfg)
    flat = {}
    for k, v in want.items():
        for k2, v2 in v.items():
            if isinstance(v2, dict):
                flat.update({f"{k}/{k2}/{k3}": v3 for k3, v3 in v2.items()})
            else:
                flat[f"{k}/{k2}"] = v2
    assert set(flat) == set(got)
    for name, arr in flat.items():
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(arr))
    reread = t_hf.load_hf_params(str(tmp_path), cfg)
    for name, t in lm.items():
        assert torch.equal(reread[name], t), name


# ---------------------------------------------------------------------------
# the engine's recovery format
# ---------------------------------------------------------------------------


def _train_cfg(opt: bool = True, dtype: str = "float32"):
    return t_cli.TrainEngineConfig(
        experiment_name="rec", trial_name="t", init_from_scratch=True, dtype=dtype,
        mb_spec=t_cli.MicroBatchSpec(max_tokens_per_mb=32),
        optimizer=t_cli.OptimizerConfig(lr=1e-2, warmup_steps_proportion=0.0,
                                        lr_scheduler_type="constant", moment_dtype="float32")
        if opt else None,
        gradient_checkpointing=False,
    )


def _engine(dtype: str = "float32", opt: bool = True):
    eng = TorchLMEngine(_train_cfg(opt, dtype), device="cpu")
    eng.model_config = tq.ModelConfig(**MODEL, dtype=dtype, param_dtype=dtype)
    eng.create_process_group()
    eng.initialize(None, FT)
    return eng


def _batch(seed: int = 0):
    rng = np.random.RandomState(seed)
    seqs = []
    for L in (9, 13, 7, 11):
        mask = np.zeros(L, dtype=np.int32)
        mask[L // 2:] = 1
        seqs.append(dict(input_ids=rng.randint(1, 64, (L,)), loss_mask=mask))
    return pad_sequences_to_tensors(seqs)


def _state(eng) -> dict:
    out = {f"p/{k}": v.detach().clone() for k, v in eng.params.items()}
    opt = eng.optimizer
    for i, k in enumerate(eng.params):
        out[f"mu/{k}"], out[f"nu/{k}"] = opt.mu[i].clone(), opt.nu[i].clone()
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_torch_state_round_trip(dtype, tmp_path, deterministic):
    eng = _engine(dtype)
    for s in range(2):
        eng.train_lm(_batch(s))
    eng.set_version(5)
    eng.save(SaveLoadMeta(path=str(tmp_path), weight_format="torch", with_optim=True))
    state = torch.load(tmp_path / torch_engine.STATE_FILE, weights_only=True)
    assert set(state) == {"params", "optim"} and state["optim"]["count"] == 2
    with open(tmp_path / torch_engine.TRAIN_META) as f:
        assert json.load(f) == dict(step_count=2, version=5, layer_layout="model")

    eng2 = _engine(dtype)
    eng2.load(SaveLoadMeta(path=str(tmp_path), weight_format="torch", with_optim=True))
    _equal(_state(eng2), _state(eng))
    assert (eng2.optimizer.count, eng2._step_count, eng2.get_version()) == (2, 2, 5)
    assert eng2.optimizer.mu[0].dtype == torch.float32
    assert eng2.optimizer.nu[0].dtype == tq.torch_dtype(dtype)
    s1, s2 = eng.train_lm(_batch(9)), eng2.train_lm(_batch(9))
    assert s1["loss"] == s2["loss"] and s1["grad_norm"] == s2["grad_norm"]
    _equal(_state(eng2), _state(eng))


def test_engine_hf_save_with_optim_round_trip(tmp_path, deterministic):
    eng = _engine("bfloat16")
    eng.train_lm(_batch(0))
    eng.train_lm(_batch(1))
    eng.save(SaveLoadMeta(path=str(tmp_path), weight_format="hf", with_optim=True))
    assert (tmp_path / "model.safetensors").exists()
    assert (tmp_path / "optim" / torch_engine.STATE_FILE).exists()
    eng2 = _engine("bfloat16")
    eng2.load(SaveLoadMeta(path=str(tmp_path), weight_format="hf", with_optim=True))
    _equal(_state(eng2), _state(eng))
    # weights only: an engine without an optimizer
    eng3 = _engine("bfloat16", opt=False)
    eng3.load(SaveLoadMeta(path=str(tmp_path), weight_format="hf"))
    _equal({k: v.detach() for k, v in eng3.params.items()},
           {k: v.detach() for k, v in eng.params.items()})


def test_train_meta_has_the_jax_keys(tmp_path, cpu_devices):
    """JAX's orbax recovery writes the same train_meta.json keys."""
    from areal_tpu.api.alloc_mode import ParallelStrategy
    from areal_tpu.engine.sft.lm_engine import JaxLMEngine

    jcfg = j_cli.TrainEngineConfig(
        experiment_name="rec", trial_name="t", init_from_scratch=True, dtype="float32",
        mb_spec=j_cli.MicroBatchSpec(max_tokens_per_mb=32),
        optimizer=j_cli.OptimizerConfig(lr=1e-2, warmup_steps_proportion=0.0),
        gradient_checkpointing=False)
    jeng = JaxLMEngine(jcfg)
    jeng.model_config = jq.ModelConfig(**MODEL, dtype="float32", param_dtype="float32")
    jeng.create_process_group(ParallelStrategy(data_parallel_size=8))
    jeng.initialize(None, FinetuneSpec(2, 16, 4))
    jeng.set_version(3)
    jeng.save(j_io.SaveLoadMeta(path=str(tmp_path / "jax"), weight_format="orbax",
                                with_optim=True))
    jeng.destroy()
    eng = _engine()
    eng.set_version(3)
    eng.save(SaveLoadMeta(path=str(tmp_path / "port"), weight_format="torch", with_optim=True))
    with open(tmp_path / "jax" / "train_meta.json") as f:
        want = json.load(f)
    with open(tmp_path / "port" / "train_meta.json") as f:
        assert json.load(f) == want


def test_orbax_is_refused(tmp_path):
    eng = _engine()
    for op in (eng.save, eng.load):
        with pytest.raises(NotImplementedError, match="torch state dict"):
            op(SaveLoadMeta(path=str(tmp_path), weight_format="orbax"))


# ---------------------------------------------------------------------------
# Saver, Evaluator, RecoverHandler
# ---------------------------------------------------------------------------


def test_saver_freq_gate(tmp_path):
    cfg = t_cli.SaverConfig(experiment_name="rec", trial_name="t", fileroot=str(tmp_path),
                            freq_steps=2)
    eng = _engine()
    saver = Saver(cfg, FT)
    assert saver.save(eng, epoch=0, step=0, global_step=0) is None
    p1 = saver.save(eng, epoch=0, step=1, global_step=1)
    assert p1 is not None and os.path.exists(os.path.join(p1, "model.safetensors"))
    jcfg = j_cli.SaverConfig(experiment_name="rec", trial_name="t", fileroot=str(tmp_path))
    from areal_tpu.utils.saver import Saver as JSaver

    assert p1 == JSaver.get_save_checkpoint_path(jcfg, 0, 1, 1)
    assert Saver.get_save_checkpoint_root(cfg) == JSaver.get_save_checkpoint_root(jcfg)


def test_saver_failure_degrades(tmp_path):
    cfg = t_cli.SaverConfig(experiment_name="rec", trial_name="t", fileroot=str(tmp_path),
                            freq_steps=1)
    saver = Saver(cfg, FT)
    assert saver.save(_RaisingEngine(), 0, 0, 0) is None
    assert saver.save_failures == 1


def test_evaluator_freq_gate():
    ev = Evaluator(t_cli.EvaluatorConfig(experiment_name="rec", trial_name="t", freq_steps=3), FT)
    assert sum(ev.evaluate(lambda: None, 0, s, s) for s in range(6)) == 2


def test_recover_roundtrip(tmp_path, deterministic):
    """`tests/test_recover.py::test_recover_roundtrip` on the port: the
    engine's parameters and optimizer, the saver's gate, the dataloader's
    position and the version come back; training goes on from them as the
    saved engine does."""
    rcfg = t_cli.RecoverConfig(experiment_name="rec", trial_name="t", fileroot=str(tmp_path),
                               mode="auto", freq_steps=1)
    assert not t_rec.check_if_auto_recover(rcfg)
    eng = _engine()
    dl = SimpleDataLoader(list(range(16)), batch_size=4, seed=3)
    it = iter(dl)
    next(it), next(it)
    for s in range(3):
        eng.train_lm(_batch(s))
    eng.set_version(3)
    scfg = t_cli.SaverConfig(experiment_name="rec", trial_name="t", fileroot=str(tmp_path),
                             freq_steps=2)
    saver = Saver(scfg, FT)
    saver.freq_ctl.check(steps=1)
    step_info = StepInfo(epoch=0, epoch_step=2, global_step=2, steps_per_epoch=4)
    assert t_rec.RecoverHandler(rcfg, FT).dump(eng, step_info, saver=saver, dataloader=dl)
    assert t_rec.check_if_auto_recover(rcfg)

    eng2, saver2 = _engine(), Saver(scfg, FT)
    dl2 = SimpleDataLoader(list(range(16)), batch_size=4, seed=3)
    info = t_rec.RecoverHandler(rcfg, FT).load(eng2, saver=saver2, dataloader=dl2)
    assert info.last_step_info.global_step == 2 and eng2.get_version() == 3
    assert saver2.state_dict() == saver.state_dict()
    assert dl2.state_dict() == dl.state_dict()
    _equal(_state(eng2), _state(eng))
    assert eng2.train_lm(_batch(99))["loss"] == eng.train_lm(_batch(99))["loss"]
    t_rec.discard_recover_state(rcfg)
    assert not t_rec.check_if_auto_recover(rcfg)


class _FakeStateEngine:
    """`tests/test_recover.py`'s stand-in engine: the checkpoint is one
    json file."""

    def __init__(self, weight=0.0):
        self.weight = float(weight)
        self._version = 0

    def save(self, meta):
        os.makedirs(meta.path, exist_ok=True)
        with open(os.path.join(meta.path, "state.json"), "w") as f:
            json.dump(dict(weight=self.weight, version=self._version), f)

    def load(self, meta):
        with open(os.path.join(meta.path, "state.json")) as f:
            self.weight = json.load(f)["weight"]

    def get_version(self):
        return self._version

    def set_version(self, v):
        self._version = v

    def update_weights(self, meta):
        pass


class _RaisingEngine(_FakeStateEngine):
    def save(self, meta):
        raise OSError("disk full")


PKGS = {
    "jax": (j_rec, j_cli.RecoverConfig, j_io.StepInfo, j_io.FinetuneSpec),
    "torch": (t_rec, t_cli.RecoverConfig, t_io.StepInfo, t_io.FinetuneSpec),
}


def _both(scenario, tmp_path):
    """Run `scenario(rec, cfg_fn, si, ft, root)` on each package in its own
    directory; return the two records, which must be equal."""
    out = {}
    for name, (rec, cfg_cls, si_cls, ft_cls) in PKGS.items():
        root = tmp_path / name

        def cfg_fn(root=root, cfg_cls=cfg_cls, **kw):
            kw.setdefault("freq_steps", 1)
            return cfg_cls(experiment_name="atom", trial_name="t", fileroot=str(root),
                           mode="auto", **kw)

        def si(g, si_cls=si_cls):
            return si_cls(epoch=0, epoch_step=g, global_step=g, steps_per_epoch=100)

        rec.reset_metrics()
        out[name] = scenario(rec, cfg_fn, si, ft_cls(2, 16, 4))
    assert out["torch"] == out["jax"]
    return out["torch"]


def _listing(rec, cfg):
    return sorted(os.listdir(rec.recover_root(cfg)))


def test_dump_layout_is_committed_and_verified(tmp_path):
    def scenario(rec, cfg_fn, si, ft):
        cfg = cfg_fn()
        path = rec.RecoverHandler(cfg, ft).dump(_FakeStateEngine(1.5), si(0), force=True)
        return dict(name=os.path.basename(path), ok=rec.verify_step_dir(path),
                    manifest=os.path.isfile(os.path.join(path, "MANIFEST.json")),
                    listing=_listing(rec, cfg), auto=rec.check_if_auto_recover(cfg))

    got = _both(scenario, tmp_path)
    assert got == dict(name="step-0", ok=(True, "ok"), manifest=True, listing=["step-0"],
                       auto=True)


def test_keep_last_prunes_oldest(tmp_path):
    def scenario(rec, cfg_fn, si, ft):
        cfg = cfg_fn(keep_last=2)
        h = rec.RecoverHandler(cfg, ft)
        for g in range(4):
            h.dump(_FakeStateEngine(), si(g), force=True)
        return dict(listing=_listing(rec, cfg), metrics=rec.get_metrics())

    got = _both(scenario, tmp_path)
    assert got["listing"] == ["step-2", "step-3"]
    assert got["metrics"] == dict(recover_dumps_total=4, recover_pruned_total=2)


def test_load_skips_torn_newest_falls_back(tmp_path):
    def scenario(rec, cfg_fn, si, ft):
        cfg = cfg_fn(keep_last=2)
        h = rec.RecoverHandler(cfg, ft)
        eng = _FakeStateEngine(10.0)
        h.dump(eng, si(0), force=True)
        eng.weight = 20.0
        eng.set_version(1)
        newest = h.dump(eng, si(1), force=True)
        with open(os.path.join(newest, "checkpoint", "state.json"), "w") as f:
            f.write("{")
        eng2 = _FakeStateEngine()
        info = rec.RecoverHandler(cfg, ft).load(eng2)
        return dict(torn_ok=rec.verify_step_dir(newest)[0], auto=rec.check_if_auto_recover(cfg),
                    step=info.last_step_info.global_step, weight=eng2.weight,
                    version=eng2.get_version(),
                    skipped=rec.get_metrics().get("recover_torn_skipped_total", 0))

    got = _both(scenario, tmp_path)
    assert got == dict(torn_ok=False, auto=True, step=0, weight=10.0, version=0, skipped=1)


def test_check_if_auto_recover_reports_half_deleted_dir(tmp_path):
    def scenario(rec, cfg_fn, si, ft):
        cfg = cfg_fn()
        path = rec.RecoverHandler(cfg, ft).dump(_FakeStateEngine(), si(0), force=True)
        os.remove(os.path.join(path, "recover_info.pkl"))
        return dict(auto=rec.check_if_auto_recover(cfg),
                    loaded=rec.RecoverHandler(cfg, ft).load(_FakeStateEngine()))

    assert _both(scenario, tmp_path) == dict(auto=False, loaded=None)


def test_dump_failure_degrades_not_raises(tmp_path):
    """A dump whose engine save fails (here: the engine raises, as the JAX
    test's injected abort does) logs and counts, leaves the committed step
    alone, and the next gate retries."""
    def scenario(rec, cfg_fn, si, ft):
        cfg = cfg_fn(keep_last=2)
        h = rec.RecoverHandler(cfg, ft)
        h.dump(_FakeStateEngine(7.0), si(0), force=True)
        failed = h.dump(_RaisingEngine(), si(1), force=True)
        info = rec.RecoverHandler(cfg, ft).load(_FakeStateEngine())
        retried = h.dump(_FakeStateEngine(8.0), si(1), force=True)
        return dict(failed=failed, step=info.last_step_info.global_step,
                    retried=os.path.basename(retried), listing=_listing(rec, cfg),
                    failures=rec.get_metrics().get("recover_dump_failures_total", 0))

    got = _both(scenario, tmp_path)
    assert got == dict(failed=None, step=0, retried="step-1", listing=["step-0", "step-1"],
                       failures=1)


def test_recover_handler_freq_ctl_roundtrip(tmp_path):
    def scenario(rec, cfg_fn, si, ft):
        cfg = cfg_fn(freq_steps=3)
        h = rec.RecoverHandler(cfg, ft)
        eng = _FakeStateEngine()
        fired = [h.dump(eng, si(g)) is not None for g in range(4)]
        h2 = rec.RecoverHandler(cfg, ft)
        assert h2.load(_FakeStateEngine()) is not None
        fired2 = [h2.dump(eng, si(g)) is not None for g in range(4, 8)]
        return dict(fired=fired, fired2=fired2)

    got = _both(scenario, tmp_path)
    assert got == dict(fired=[False, False, True, False], fired2=[False, False, True, False])


def test_replayed_step_redump_displaces_atomically(tmp_path):
    def scenario(rec, cfg_fn, si, ft):
        cfg = cfg_fn()
        h = rec.RecoverHandler(cfg, ft)
        p = h.dump(_FakeStateEngine(1.0), si(0), force=True)
        p2 = h.dump(_FakeStateEngine(2.0), si(0), force=True)
        eng2 = _FakeStateEngine()
        rec.RecoverHandler(cfg, ft).load(eng2)
        return dict(same=p == p2, ok=rec.verify_step_dir(p2), weight=eng2.weight,
                    listing=_listing(rec, cfg))

    got = _both(scenario, tmp_path)
    assert got == dict(same=True, ok=(True, "ok"), weight=2.0, listing=["step-0"])


# ---------------------------------------------------------------------------
# resume through the SFT entry point
# ---------------------------------------------------------------------------


def test_sft_resume_equals_uninterrupted_bit_for_bit(tmp_path, monkeypatch, deterministic):
    from areal_tpu_torch.examples.gsm8k_sft import main

    finals = []
    destroy = TorchLMEngine.destroy

    def destroy_(self):
        finals.append({k: v.detach().clone() for k, v in self.params.items()})
        destroy(self)

    monkeypatch.setattr(TorchLMEngine, "destroy", destroy_)
    base = ["--config", "examples/configs/arith_sft_smoke.yaml", "evaluator.freq_steps=null",
            "train_dataset.batch_size=64", "model.optimizer.lr_scheduler_type=cosine",
            "model.optimizer.warmup_steps_proportion=0.3"]
    a = main(base + [f"cluster.fileroot={tmp_path}/A", "total_train_steps=4"], device="cpu")
    b = main(base + [f"cluster.fileroot={tmp_path}/B", "total_train_steps=2",
                     "recover.mode=auto", "recover.freq_steps=2", "recover.keep_last=1"],
             device="cpu")
    c = main(base + [f"cluster.fileroot={tmp_path}/B", "total_train_steps=4",
                     "recover.mode=resume"], device="cpu")
    assert [r["global_step"] for r in b] == [0, 1]
    assert [r["global_step"] for r in c] == [2, 3]
    assert [r["loss"] for r in a] == [r["loss"] for r in b + c]
    assert [r["lr"] for r in a] == [r["lr"] for r in b + c]
    _equal(finals[2], finals[0])
