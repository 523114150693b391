"""The port's MoE decoder and Qwen3's q/k norms against the JAX package.

`moe_mlp` (capacity routing, its drops and its aux loss), the packed
`forward` with its aux and gradients, the serving functions (`prefill`
with a pad mask and one routing group per row, `decode_step_paged` with
inactive slots, `verify_step_paged`, the workspace `verify_step`), the
int8 weight rule that leaves a MoE layer's MLP in fp, `init_params`, the
trainer's aux term, the weight push's frames, and the decode engine's
greedy streams, each beside the JAX package on the CPU in f32 at a tiny
size (2 layers, 8 experts, 2 a token, widths <= 64).

Tolerances: 1e-5 on `moe_mlp`, logits, hidden states, aux losses and KV
rows (f32, sums in another order); gradients 1e-4, or 1e-5 of the
largest element; the engines' greedy tokens exactly and their logprobs
within 1e-5. Routing decisions are discrete: equal inputs within 1e-6 of
each other give equal picks unless two router probabilities tie within
that distance, which these seeds do not produce.

MoE streams depend on their batchmates (capacity is per group), so the
engine tests run the port and a live `JaxDecodeEngine` on the same
schedule: one admission wave, released together.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from areal_tpu.api.cli_args import GenerationHyperparameters as JaxGen
from areal_tpu.api.cli_args import InferenceEngineConfig as JaxInferenceConfig
from areal_tpu.api.cli_args import JaxDecodeConfig
from areal_tpu.api.io_struct import ModelRequest as JaxRequest
from areal_tpu.core import weight_transfer as jwt
from areal_tpu.engine import jax_decode as jd
from areal_tpu.models import qwen2 as jq
from areal_tpu_torch.api.cli_args import GenerationHyperparameters, TorchDecodeConfig
from areal_tpu_torch.api.io_struct import ModelRequest
from areal_tpu_torch.core import weight_transfer as twt
from areal_tpu_torch.engine import torch_decode as td
from areal_tpu_torch.models import qwen2 as tq
from areal_tpu_torch.models.convert import params_from_numpy, unstack_layers
from tests.test_torch_decode_sched import _wave

ATOL = 1e-5
GRAD_ATOL = 1e-4
GRAD_SCALE_TOL = 1e-5

BASE = dict(vocab_size=64, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, dtype="float32",
            param_dtype="float32", attn_impl="dense")
# each family's flags, as `from_hf_config` sets them
FAMILIES = {
    "qwen3_moe": dict(model_type="qwen3_moe", qkv_bias=False, qk_norm=True, num_experts=8,
                      num_experts_per_tok=2, moe_intermediate_size=16, norm_topk_prob=True),
    "qwen2_moe": dict(model_type="qwen2_moe", qkv_bias=True, num_experts=8,
                      num_experts_per_tok=2, moe_intermediate_size=16,
                      shared_expert_intermediate_size=24, norm_topk_prob=False),
    "mixtral": dict(model_type="mixtral", qkv_bias=False, num_experts=4, num_experts_per_tok=2,
                    moe_intermediate_size=48, norm_topk_prob=True),
    "qwen3": dict(model_type="qwen3", qkv_bias=False, qk_norm=True),
}


def _cfgs(family, **over):
    kw = dict(BASE, **FAMILIES[family], **over)
    return jq.ModelConfig(**kw), tq.ModelConfig(**kw)


def _params(jcfg, tcfg, seed=0):
    jparams = jax.jit(jq.init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(seed))
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)


# ---------------------------------------------------------------------------
# moe_mlp
# ---------------------------------------------------------------------------


def _mlp_params(rng, H, E, M, shared):
    p = {"router_kernel": rng.standard_normal((H, E)),
         "gate_kernel": rng.standard_normal((E, H, M)) * 0.3,
         "up_kernel": rng.standard_normal((E, H, M)) * 0.3,
         "down_kernel": rng.standard_normal((E, M, H)) * 0.3}
    if shared:
        p.update(shared_gate_kernel=rng.standard_normal((H, shared)) * 0.3,
                 shared_up_kernel=rng.standard_normal((H, shared)) * 0.3,
                 shared_down_kernel=rng.standard_normal((shared, H)) * 0.3,
                 shared_router_kernel=rng.standard_normal((H, 1)))
    return {k: v.astype(np.float32) for k, v in p.items()}


MLP_CASES = {
    # name: (T, E, K, capacity_factor, shared, norm_topk_prob, group, masked)
    "qwen3-moe": (40, 8, 2, 1.25, 0, True, 1024, False),
    "qwen2-moe-shared": (40, 8, 2, 1.25, 24, False, 1024, False),
    "mixtral": (40, 4, 2, 1.25, 0, True, 1024, False),
    "valid-mask": (40, 8, 2, 0.5, 0, True, 1024, True),
    "forced-drops": (48, 8, 2, 0.3, 12, False, 1024, False),
    "prime-T-groups-of-1": (37, 8, 3, 1.25, 0, True, 16, False),
    "groups-of-12": (36, 8, 2, 0.5, 0, True, 16, True),
}


@pytest.mark.parametrize("case", sorted(MLP_CASES))
def test_moe_mlp_matches_jax(case):
    T, E, K, cf, shared, norm, group, masked = MLP_CASES[case]
    H, M = 16, 8
    rng = np.random.default_rng(sorted(MLP_CASES).index(case))
    kw = dict(hidden_size=H, num_experts=E, num_experts_per_tok=K, moe_intermediate_size=M,
              capacity_factor=cf, shared_expert_intermediate_size=shared, norm_topk_prob=norm,
              moe_group_size=group)
    p = _mlp_params(rng, H, E, M, shared)
    x = rng.standard_normal((T, H)).astype(np.float32)
    valid = None
    if masked:
        valid = rng.random(T) > 0.3
        valid[-5:] = False
    jy, jaux = jq.moe_mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                          jq.ModelConfig(**kw), valid=None if valid is None else jnp.asarray(valid))
    ty, taux = tq.moe_mlp({f"mlp/{k}": torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x), tq.ModelConfig(**kw),
                          valid=None if valid is None else torch.from_numpy(valid))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), atol=ATOL, rtol=0)
    if valid is not None and not shared:
        assert np.all(ty.numpy()[~valid] == 0)  # a masked token gets no routed output


def test_moe_mlp_drops_past_capacity():
    """C = 1 slot per expert in one group: at most E picks survive, each
    surviving token's output is its one pick, and the rest are zero rows."""
    rng = np.random.default_rng(3)
    T, H, E = 32, 8, 2
    cfg = tq.ModelConfig(hidden_size=H, num_experts=E, num_experts_per_tok=1,
                         moe_intermediate_size=4, capacity_factor=0.06)
    p = {f"mlp/{k}": torch.from_numpy(v) for k, v in _mlp_params(rng, H, E, 4, 0).items()}
    y, _ = tq.moe_mlp(p, torch.from_numpy(rng.standard_normal((T, H)).astype(np.float32)), cfg)
    assert int((y.abs().sum(-1) > 0).sum()) <= E


def test_moe_mlp_rows_route_on_their_own():
    """`seq_len` cuts x into rows that group on their own: B rows at once
    equal B calls of JAX's one-sequence moe_mlp (the JAX engine's vmapped
    prefill), each with its own pad mask."""
    rng = np.random.default_rng(4)
    B, T, H, E, M = 3, 24, 16, 8, 8
    kw = dict(hidden_size=H, num_experts=E, num_experts_per_tok=2, moe_intermediate_size=M,
              capacity_factor=0.5)
    p = _mlp_params(rng, H, E, M, 0)
    x = rng.standard_normal((B, T, H)).astype(np.float32)
    lens = np.array([24, 17, 9])
    valid = np.arange(T)[None] < lens[:, None]
    ty, _ = tq.moe_mlp({f"mlp/{k}": torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x.reshape(B * T, H)), tq.ModelConfig(**kw),
                       valid=torch.from_numpy(valid.reshape(-1)), seq_len=T)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    for b in range(B):
        jy, _ = jq.moe_mlp(jp, jnp.asarray(x[b]), jq.ModelConfig(**kw),
                           valid=jnp.asarray(valid[b]))
        np.testing.assert_allclose(ty.numpy().reshape(B, T, H)[b], np.asarray(jy),
                                   atol=ATOL, rtol=0)


def test_moe_group_size_matches_jax():
    for T in (1, 7, 36, 37, 64, 1000, 1031, 4096):
        for target in (1, 16, 1024):
            assert tq._moe_group_size(T, target) == jq._moe_group_size(T, target)


# ---------------------------------------------------------------------------
# the packed forward, its aux loss and its gradients
# ---------------------------------------------------------------------------


def _packed(vocab, lens=(23, 30, 11), pad=8, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, sum(lens) + pad).astype(np.int32)
    seg = np.concatenate([np.full(n, i) for i, n in enumerate(lens)]
                         + [np.full(pad, -1)]).astype(np.int32)
    pos = np.concatenate([np.arange(n) for n in lens] + [np.arange(pad)]).astype(np.int32)
    return ids, pos, seg


@pytest.mark.parametrize("scan", [True, False])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_and_aux_match_jax(family, scan):
    jcfg, tcfg = _cfgs(family, scan_layers=scan)
    jparams, tparams = _params(jcfg, tcfg, seed=1)
    ids, pos, seg = _packed(jcfg.vocab_size)
    jl, jaux = jq.forward(jparams, ids, pos, seg, jcfg, with_aux=True)
    tl, taux = tq.forward(tparams, torch.from_numpy(ids).long(), torch.from_numpy(pos).long(),
                          torch.from_numpy(seg), tcfg, with_aux=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), atol=ATOL, rtol=0)
    assert (float(taux) > 0) == bool(tcfg.num_experts)
    # with_aux is off by default: the logits alone
    assert torch.equal(tq.forward(tparams, torch.from_numpy(ids).long(),
                                  torch.from_numpy(pos).long(), torch.from_numpy(seg), tcfg), tl)


@pytest.mark.parametrize("family", ["qwen3_moe", "qwen2_moe"])
def test_loss_and_aux_grads_match_jax(family):
    """d/dparams of sum(logits * w) + coef * aux, the trainer's loss shape,
    against jax.grad: the port in the trainer's layout (one tensor per
    layer leaf, per-layer remat returning each layer's aux), JAX scanned."""
    coef = 0.05
    jcfg, _ = _cfgs(family, capacity_factor=0.75)
    tcfg = tq.ModelConfig(**dataclasses.asdict(jcfg) | dict(scan_layers=False, remat=True))
    jparams = jax.jit(jq.init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(2))
    tree = jax.tree.map(np.asarray, jparams)
    ids, pos, seg = _packed(jcfg.vocab_size, seed=1)
    w = np.random.default_rng(2).standard_normal((len(ids), jcfg.vocab_size)).astype(np.float32)

    def jloss(p):
        logits, aux = jq.forward(p, ids, pos, seg, jcfg, with_aux=True)
        return jnp.sum(logits * w) + coef * aux

    jgrads = jax.jit(jax.grad(jloss))(jparams)
    params = {k: v.requires_grad_() for k, v in params_from_numpy(tree, tcfg).items()}
    logits, aux = tq.forward(params, torch.from_numpy(ids).long(), torch.from_numpy(pos).long(),
                             torch.from_numpy(seg), tcfg, with_aux=True)
    ((logits * torch.from_numpy(w)).sum() + coef * aux).backward()
    want = tq.flatten_names(unstack_layers(jax.tree.map(np.asarray, jgrads)))
    assert set(want) == set(params)
    for name, p in params.items():
        atol = max(GRAD_ATOL, GRAD_SCALE_TOL * np.abs(want[name]).max())
        np.testing.assert_allclose(p.grad.numpy(), want[name], atol=atol, rtol=GRAD_ATOL,
                                   err_msg=name)
    assert params["layers_0/mlp/router_kernel"].grad.abs().max() > 0


# ---------------------------------------------------------------------------
# the serving functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["qwen3_moe", "qwen2_moe"])
def test_prefill_rows_and_pad_mask_match_jax(family):
    """A batched prefill [B, bucket] with each row's pad tail masked equals
    JAX's one-sequence prefill of each row with its `valid` (the JAX
    engine's vmap), logits and KV."""
    jcfg, tcfg = _cfgs(family, capacity_factor=0.5)
    jparams, tparams = _params(jcfg, tcfg, seed=3)
    rng = np.random.default_rng(3)
    B, T = 3, 24
    ids = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    lens = np.array([24, 15, 7])
    valid = np.arange(T)[None] < lens[:, None]
    pos = np.arange(T, dtype=np.int32)
    tl, tk, tv = tq.prefill(tparams, torch.from_numpy(ids).long(), torch.from_numpy(pos), tcfg,
                            valid=torch.from_numpy(valid))
    jfn = jax.jit(jq.prefill, static_argnums=3)
    for b in range(B):
        jl, jk, jv = jfn(jparams, jnp.asarray(ids[b]), jnp.asarray(pos), jcfg, jnp.asarray(valid[b]))
        np.testing.assert_allclose(tl[b].numpy(), np.asarray(jl), atol=ATOL, rtol=0)
        np.testing.assert_allclose(tk[b].numpy(), np.asarray(jk), atol=ATOL, rtol=0)
        np.testing.assert_allclose(tv[b].numpy(), np.asarray(jv), atol=ATOL, rtol=0)


def _pool_case(jcfg, rng, R=4, bsz=16, nb=3):
    L, nKV, hd = jcfg.num_hidden_layers, jcfg.num_key_value_heads, jcfg.head_dim_
    n_blocks = R * nb + 1
    shape = (L, n_blocks, bsz, nKV, hd)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    table = (1 + rng.permutation(R * nb)).reshape(R, nb).astype(np.int32)
    return k0, v0, table


@pytest.mark.parametrize("family", ["qwen3_moe", "qwen2_moe", "qwen3"])
def test_decode_step_paged_matches_jax(family):
    """One decode step of 6 slots, two inactive (they claim no capacity,
    at C = 1 per expert), against JAX's: logits of the active slots and
    every pool row outside the null block."""
    jcfg, tcfg = _cfgs(family, capacity_factor=0.75)
    jparams, tparams = _params(jcfg, tcfg, seed=4)
    rng = np.random.default_rng(5)
    R = 6
    k0, v0, table = _pool_case(jcfg, rng, R=R)
    positions = np.array([5, 40, 17, 9, 33, 2], np.int32)
    active = np.array([True, True, False, True, False, True])
    tokens = rng.integers(0, jcfg.vocab_size, R).astype(np.int32)
    jl, jkp, jvp = jax.jit(lambda p, t, pos, k, v, bt, act: jq.decode_step_paged(
        p, t, pos, k, v, bt, jcfg, active=act, attn_impl="xla"))(
        jparams, jnp.asarray(tokens), jnp.asarray(positions), jnp.asarray(k0),
        jnp.asarray(v0), jnp.asarray(table), jnp.asarray(active))
    kp, vp = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    tl = tq.decode_step_paged(tparams, torch.from_numpy(tokens).long(),
                              torch.from_numpy(positions), kp, vp, torch.from_numpy(table),
                              tcfg, active=torch.from_numpy(active))
    np.testing.assert_allclose(tl[active].numpy(), np.asarray(jl)[active], atol=ATOL, rtol=0)
    np.testing.assert_allclose(kp.numpy()[:, 1:], np.asarray(jkp)[:, 1:], atol=ATOL, rtol=0)
    np.testing.assert_allclose(vp.numpy()[:, 1:], np.asarray(jvp)[:, 1:], atol=ATOL, rtol=0)


@pytest.mark.parametrize("family", ["qwen3_moe", "qwen2_moe"])
def test_verify_step_paged_and_workspace_match_jax(family):
    """W = 4 positions of 3 slots, one inactive: `verify_step_paged` and the
    workspace `verify_step` route the R x W tokens as JAX's do."""
    jcfg, tcfg = _cfgs(family, capacity_factor=0.5)
    jparams, tparams = _params(jcfg, tcfg, seed=5)
    rng = np.random.default_rng(6)
    R, W, bsz, nb = 3, 4, 16, 3
    k0, v0, table = _pool_case(jcfg, rng, R=R, bsz=bsz, nb=nb)
    tokens = rng.integers(0, jcfg.vocab_size, (R, W)).astype(np.int32)
    pos0 = np.array([0, 13, 30], np.int32)
    active = np.array([True, False, True])
    jl, jk, _ = jq.verify_step_paged(
        jparams, jnp.asarray(tokens), jnp.asarray(pos0), jnp.asarray(k0), jnp.asarray(v0),
        jnp.asarray(table), jcfg, active=jnp.asarray(active), attn_impl="xla")
    kp, vp = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    tl = tq.verify_step_paged(tparams, torch.from_numpy(tokens).long(), torch.from_numpy(pos0),
                              kp, vp, torch.from_numpy(table), tcfg,
                              active=torch.from_numpy(active))
    np.testing.assert_allclose(tl[active].numpy(), np.asarray(jl)[active], atol=ATOL, rtol=0)
    np.testing.assert_allclose(kp.numpy()[:, 1:], np.asarray(jk)[:, 1:], atol=ATOL, rtol=0)
    # the workspace layout: each slot's blocks gathered into a dense cache
    L, nKV, hd = jcfg.num_hidden_layers, jcfg.num_key_value_heads, jcfg.head_dim_
    kc = k0[:, table].reshape(L, R, nb * bsz, nKV, hd)
    vc = v0[:, table].reshape(L, R, nb * bsz, nKV, hd)
    jwl, jkc, _ = jq.verify_step(jparams, jnp.asarray(tokens), jnp.asarray(pos0),
                                 jnp.asarray(kc), jnp.asarray(vc), jcfg,
                                 active=jnp.asarray(active))
    tkc, tvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    twl = tq.verify_step(tparams, torch.from_numpy(tokens).long(), torch.from_numpy(pos0),
                         tkc, tvc, tcfg, active=torch.from_numpy(active))
    np.testing.assert_allclose(twl[active].numpy(), np.asarray(jwl)[active], atol=ATOL, rtol=0)
    np.testing.assert_allclose(tkc.numpy(), np.asarray(jkc), atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# parameters: shapes, init, int8
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scan", [True, False])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_param_shapes_match_jax(family, scan):
    jcfg, tcfg = _cfgs(family, scan_layers=scan)

    def tuples(tree):
        return {k: tuples(v) if isinstance(v, dict) else tuple(v) for k, v in tree.items()}

    assert tuples(tq.param_shapes(tcfg)) == tuples(jq.param_shapes(jcfg))


def test_init_params_moe_shapes_and_fan_in():
    _, tcfg = _cfgs("qwen2_moe", scan_layers=True, hidden_size=64)
    p = tq.init_params(tcfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in p.items()} == tq.named_shapes(tcfg)
    assert torch.equal(p["layers/attn/q_bias"], torch.zeros_like(p["layers/attn/q_bias"]))
    # truncated standard normal on [-2, 2] (std 0.8796) over the fan-in:
    # the hidden size for the router, the experts' gate/up and the shared
    # expert's router; the expert width for down
    for name, fan_in in (("layers/mlp/router_kernel", 64), ("layers/mlp/gate_kernel", 64),
                         ("layers/mlp/up_kernel", 64), ("layers/mlp/shared_router_kernel", 64),
                         ("layers/mlp/down_kernel", 16), ("layers/mlp/shared_down_kernel", 24)):
        w = p[name]
        assert w.abs().max() <= 2.0 / math.sqrt(fan_in) + 1e-6, name
        if w.numel() > 1000:
            assert abs(w.std().item() * math.sqrt(fan_in) - 0.8796) < 0.05, name
    _, q3 = _cfgs("qwen3_moe", scan_layers=True)
    p = tq.init_params(q3, torch.Generator().manual_seed(0))
    assert torch.equal(p["layers/attn/q_norm"], torch.ones(2, 8))
    assert torch.equal(p["layers/attn/k_norm"], torch.ones(2, 8))


@pytest.mark.parametrize("scan", [True, False])
def test_quantize_weights_leaves_moe_layers_fp(scan):
    """JAX `_map_wq_layer`: attention quantizes, a MoE layer's router,
    experts and shared expert stay fp; the same names, equal tensors."""
    jcfg, tcfg = _cfgs("qwen2_moe", scan_layers=scan)
    jparams, tparams = _params(jcfg, tcfg, seed=6)
    jq8 = tq.flatten_names(jax.tree.map(np.asarray, jq.quantize_weights(jparams)))
    tq8 = tq.quantize_weights(tparams)
    assert set(tq8) == set(jq8)
    for name, t in tq8.items():
        if t.dtype == torch.int8:
            assert np.abs(t.numpy().astype(np.int32) - jq8[name].astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(t.numpy(), jq8[name], rtol=1e-6, atol=0, err_msg=name)
    mlp = [n for n in tq8 if "/mlp/" in n]
    assert mlp and all(tq8[n].dtype == torch.float32 for n in mlp)
    assert any(n.endswith("attn/q_kernel/q") for n in tq8)
    assert tq.is_weight_quantized(tq8)
    # one leaf at a time (the trainer's int8 push): the expert stack alone
    # stays fp too
    name = ("layers/" if scan else "layers_0/") + "mlp/gate_kernel"
    assert list(tq.quantize_weights({name: tparams[name]})) == [name]


# ---------------------------------------------------------------------------
# the trainer's aux term and the weight push
# ---------------------------------------------------------------------------


def test_train_batch_adds_the_aux_loss():
    """`train_batch` adds router_aux_loss_coef x aux to each micro-batch's
    loss before its weight (JAX :1466-1483): the reported loss and the
    gradient step equal a hand-built loss of the same terms."""
    from areal_tpu_torch.api import cli_args as targs
    from areal_tpu_torch.api.io_struct import FinetuneSpec
    from areal_tpu_torch.engine import torch_engine
    from areal_tpu_torch.utils import data as tdata

    _, tcfg = _cfgs("qwen3_moe", router_aux_loss_coef=0.5, scan_layers=False, attn_impl="auto")
    cfg = targs.TrainEngineConfig(experiment_name="", trial_name="", path="",
                                  init_from_scratch=True, dtype="float32",
                                  mb_spec=targs.MicroBatchSpec(max_tokens_per_mb=40),
                                  optimizer=targs.OptimizerConfig(lr=0.0))
    eng = torch_engine.TorchTrainEngine(cfg, device="cpu")
    eng.model_config = tcfg
    eng.create_process_group()
    eng.initialize(None, FinetuneSpec(1, 4, 4))
    rng = np.random.default_rng(7)
    lens = np.array([14, 11, 9, 12])
    mask = (np.arange(14)[None] < lens[:, None]).astype(np.int64)
    batch = dict(input_ids=rng.integers(0, tcfg.vocab_size, (4, 14)) * mask, attention_mask=mask)

    def loss_fn(logits, mb):
        return logits.float().square().mean()

    want, auxes = 0.0, []
    mbs = tdata.split_padded_tensor_dict_into_mb_list(batch, cfg.mb_spec)
    assert len(mbs.mbs) > 1
    for mb in mbs.mbs:
        dev = eng._device_mb(mb)
        with torch.no_grad():
            logits, aux = eng._model_out(dev, loss_fn, with_aux=True)
        auxes.append(float(aux))
        want += float(loss_fn(logits, dev) + 0.5 * aux)
    stats = eng.train_batch(batch, loss_fn, lambda mb: 1.0)
    assert min(auxes) > 0
    assert stats["loss"] == pytest.approx(want / len(mbs.mbs), rel=1e-5)


@pytest.mark.parametrize("weight_dtype", ["fp", "int8"])
@pytest.mark.parametrize("scan", [True, False])
def test_moe_push_frames_equal_jax_push(scan, weight_dtype):
    """The port trainer's push of a qwen2_moe tree and the JAX trainer's
    push of the same weights (its bf16 cast, then `quantize_weights` for
    int8): the same names in the same order, byte-equal frames, the
    experts fp in both. The port's staging reads the JAX frames back."""
    from areal_tpu_torch.api import cli_args as targs
    from areal_tpu_torch.engine import torch_engine

    jcfg, _ = _cfgs("qwen2_moe", scan_layers=scan)
    jparams = jax.jit(jq.init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(8))
    eng = torch_engine.TorchTrainEngine(
        targs.TrainEngineConfig(init_from_scratch=True, dtype="float32", optimizer=None),
        device="cpu")
    eng.model_config = tq.ModelConfig(**dataclasses.asdict(jcfg))
    eng.create_process_group()
    unscanned = tq.ModelConfig(**dataclasses.asdict(jcfg) | dict(scan_layers=False))
    eng.initialize(None, None,
                   params=params_from_numpy(jax.tree.map(np.asarray, jparams), unscanned))
    cast = jax.jit(lambda t: jax.tree.map(
        lambda x: x.astype(jnp.bfloat16) if jnp.issubdtype(x.dtype, jnp.floating) else x,
        t))(jparams)
    if weight_dtype == "int8":
        cast = jax.jit(jq.quantize_weights)(cast)
    want = list(jwt.pack_buckets(jwt.iter_prefetched(jwt.named_leaves(cast)), chunk_mb=0.01))
    got = list(twt.pack_buckets(eng._dcn_payload(2, weight_dtype), chunk_mb=0.01))
    assert len(got) == len(want) > 1
    assert got == want
    st = twt.WeightStaging()
    for frame in want:
        st.add_bucket(frame)
    staged = st.finalize()
    assert any(n.endswith("mlp/gate_kernel") and t.dtype == torch.bfloat16
               for n, t in staged.items())


# ---------------------------------------------------------------------------
# the decode engine against a live JaxDecodeEngine
# ---------------------------------------------------------------------------

ENGINE = dict(page_size=16, dtype="float32", kv_cache_dtype="float32", context_length=96,
              max_running_requests=4, new_tokens_per_chunk=8)


@pytest.fixture(scope="module")
def moe_weights():
    jcfg, tcfg = _cfgs("qwen3_moe", capacity_factor=0.5, attn_impl="auto")
    jparams, tparams = _params(jcfg, tcfg, seed=9)
    return jcfg, tcfg, jparams, tparams


PROMPTS = [[1 + (7 * i + 3 * j) % 60 for j in range(n)] for i, n in enumerate((21, 9, 30))]


@pytest.mark.parametrize("mode", ["fp", "int8-weights", "spec"])
def test_engine_greedy_streams_match_jax_engine(moe_weights, mode):
    """Three prompts (one admission wave, bucket-padded prefill rows of
    different lengths, capacity 0.5 so routing drops picks) through the
    port's engine and a live JaxDecodeEngine on the same 2-layer
    qwen3_moe: tokens equal, logprobs within 1e-5. `int8-weights`
    quantizes attention only (the MoE layers stay fp); `spec` turns on
    n-gram speculation (verify over R x W tokens) without run-ahead: a
    rejected draft token still claims capacity, so a draft made from a
    chunk that landed early or late (device timing, under run-ahead)
    routes differently, in either package."""
    jcfg, tcfg, jparams, tparams = moe_weights
    extra = {"fp": {}, "int8-weights": dict(weight_dtype="int8"),
             "spec": dict(spec_decode="ngram", decode_runahead_chunks=0)}[mode]
    jeng = jd.JaxDecodeEngine(JaxDecodeConfig(**ENGINE, **extra), JaxInferenceConfig())
    jeng.set_model(jparams, jcfg)
    jeng.initialize()
    teng = td.TorchDecodeEngine(TorchDecodeConfig(**ENGINE, **extra), device="cpu")
    teng.set_model(tparams, tcfg)
    teng.initialize()
    try:
        jout = _wave(jeng, [JaxRequest(input_ids=p, gconfig=JaxGen(max_new_tokens=12, greedy=True))
                            for p in PROMPTS])
        tout = _wave(teng, [ModelRequest(input_ids=p, gconfig=GenerationHyperparameters(
            max_new_tokens=12, greedy=True)) for p in PROMPTS])
        assert (teng.verify_dispatches > 0) == (mode == "spec")
    finally:
        jeng.destroy()
        teng.destroy()
    for a, b in zip(jout, tout):
        assert list(b.output_tokens) == list(a.output_tokens)
        np.testing.assert_allclose(b.output_logprobs, a.output_logprobs, atol=ATOL, rtol=0)
        assert len(b.output_tokens) == 12
