"""The port's dcn weight wire (`areal_tpu_torch/core/weight_transfer.py`)
against the JAX package's, on the CPU.

- `pack_buckets` frames are byte-equal to JAX's for the same named arrays:
  bf16, f32 and int8, a tensor split into parts across frames, an
  iterable producer and non-contiguous inputs (mirrors
  `tests/test_weight_transfer.py:54-270`).
- Each package's `WeightStaging` assembles the other's frames, delivered
  twice or re-split, never finishes a tensor with a hole, and rejects a
  torn frame before staging it.
- The trainer's push (`TorchTrainEngine._wire_leaves`, the bf16 cast in
  the JAX wire layout of the configured `scan_layers`, int8 kernels with
  `weight_dtype="int8"`) frames byte for byte as the JAX trainer's
  `_push_cast_fn` (+ `quantize_weights`) of the same weights does.
- `models/convert.to_layout` stacks and unstacks the layer layouts.
"""

import json
import struct

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from areal_tpu.core import weight_transfer as jwt
from areal_tpu.models import qwen2 as jq
from areal_tpu_torch.api import cli_args as t_cli
from areal_tpu_torch.core import weight_transfer as twt
from areal_tpu_torch.engine import torch_engine
from areal_tpu_torch.models import qwen2 as tq
from areal_tpu_torch.models.convert import params_from_numpy, to_layout

MODEL = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=3,
             num_attention_heads=4, num_key_value_heads=2)


def _torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _named(kind: str) -> dict[str, np.ndarray]:
    rng = np.random.RandomState(0)
    if kind == "bf16":
        return {"a/w": rng.randn(16, 8).astype(ml_dtypes.bfloat16),
                "a/b": rng.randn(8).astype(ml_dtypes.bfloat16)}
    if kind == "f32":
        return {"w": rng.randn(33, 7).astype(np.float32), "s": np.float32(rng.randn())}
    if kind == "int8":
        return {"k/q": rng.randint(-127, 128, (24, 12)).astype(np.int8),
                "k/scale": rng.rand(1, 12).astype(np.float32)}
    if kind == "split":  # ~4.7 MiB at 1 MiB frames: five frames and more
        return {"big": rng.randn(1200, 1024).astype(np.float32),
                "small": np.ones(4, np.float32)}
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["bf16", "f32", "int8", "split"])
def test_frames_byte_equal_to_jax(kind):
    named = _named(kind)
    chunk = 1 if kind == "split" else 512
    want = list(jwt.pack_buckets(named, chunk_mb=chunk))
    got = list(twt.pack_buckets({k: _torch(np.asarray(v)) for k, v in named.items()},
                                chunk_mb=chunk))
    assert got == want
    # numpy input frames the same, and the buffer lists join to the frames
    assert list(twt.pack_buckets(named, chunk_mb=chunk)) == want
    parts = list(twt.pack_frames(named, chunk_mb=chunk))
    assert [b"".join(p) for p in parts] == want
    assert [twt.frame_nbytes(p) for p in parts] == [len(b) for b in want]
    if kind == "split":
        assert len(want) >= 5


def test_iterable_and_noncontiguous_inputs_frame_as_jax():
    rng = np.random.RandomState(6)
    base = rng.randn(64, 48).astype(np.float32)
    named = {"t": base.T, "s": base[::2, 1:5]}
    want = list(jwt.pack_buckets(iter(named.items()), chunk_mb=0.005))
    tb = torch.from_numpy(base)
    got = list(twt.pack_buckets(iter([("t", tb.T), ("s", tb[::2, 1:5])]), chunk_mb=0.005))
    assert got == want and len(want) > 2


@pytest.mark.parametrize("kind", ["bf16", "f32", "int8", "split"])
def test_staging_takes_the_other_packages_frames(kind):
    named = _named(kind)
    chunk = 1 if kind == "split" else 512
    st = twt.WeightStaging()
    for frame in jwt.pack_buckets(named, chunk_mb=chunk):
        st.add_bucket(frame)
        st.add_bucket(frame)  # a retried POST
    got = st.finalize()
    assert set(got) == set(named)
    for k, v in named.items():
        assert got[k].dtype == twt.torch_wire_dtype(np.asarray(v).dtype.name)
        np.testing.assert_array_equal(_numpy(got[k]), np.asarray(v))
    js = jwt.WeightStaging()
    for frame in twt.pack_buckets({k: _torch(np.asarray(v)) for k, v in named.items()},
                                  chunk_mb=chunk):
        js.add_bucket(frame)
        js.add_bucket(frame)
    jgot = js.finalize()
    for k, v in named.items():
        np.testing.assert_array_equal(jgot[k], np.asarray(v))


def _frame(data: bytes, parts) -> bytes:
    """One frame holding byte ranges [(offset, n), ...] of a 100-byte uint8
    tensor "w" (tests/test_weight_transfer.py's re-split frames)."""
    manifest, chunks, size = [], [], 0
    for off, n in parts:
        manifest.append(dict(name="w", shape=[100], dtype="uint8", offset=size, nbytes=n,
                             part_offset=off, total_nbytes=100))
        chunks.append(data[off : off + n])
        size += n
    mjson = json.dumps(manifest).encode()
    return struct.pack("<Q", len(mjson)) + mjson + b"".join(chunks)


@pytest.mark.parametrize("staging", [twt.WeightStaging, jwt.WeightStaging],
                         ids=["torch", "jax"])
def test_overlapping_resplit_never_materializes_holes(staging):
    data = np.random.RandomState(5).randint(0, 255, 100, dtype=np.uint8).tobytes()
    st = staging()
    st.add_bucket(_frame(data, [(0, 60)]))
    st.add_bucket(_frame(data, [(0, 40)]))  # lengths sum to 100, union is [0, 60)
    assert "w" not in st.ready
    with pytest.raises(RuntimeError, match="incomplete"):
        st.finalize()
    st.add_bucket(_frame(data, [(40, 60)]))
    out = st.finalize()
    np.testing.assert_array_equal(np.asarray(out["w"]), np.frombuffer(data, np.uint8))


@pytest.mark.parametrize("producer", ["torch", "jax"])
@pytest.mark.parametrize("cut", ["header", "manifest", "body"])
def test_torn_frames_rejected_before_staging(producer, cut):
    named = _named("f32")
    frame = (list(jwt.pack_buckets(named)) if producer == "jax" else
             list(twt.pack_buckets({k: _torch(np.asarray(v)) for k, v in named.items()})))[0]
    (mlen,) = struct.unpack_from("<Q", frame, 0)
    torn = {"header": frame[:5], "manifest": frame[: 8 + mlen // 2],
            "body": frame[:-3]}[cut]
    for staging in (twt.WeightStaging(), jwt.WeightStaging()):
        with pytest.raises(ValueError, match="torn"):
            staging.add_bucket(torn)
        assert not staging.ready and not staging._bufs
        for b in (frame,):  # the full frame still lands after the torn one
            staging.add_bucket(b)
        assert set(staging.finalize()) == set(named)


def test_raw_wire_bytes_match_jax():
    named = {**_named("int8"), **_named("bf16")}
    for jf, tf in zip(jwt.pack_buckets(named, chunk_mb=0.001),
                      twt.pack_buckets(named, chunk_mb=0.001)):
        assert twt.frame_raw_nbytes(tf) == jwt.frame_raw_nbytes(jf)
    for args in (("a/k/q", 10, "int8"), ("a/k/scale", 8, "float32"), ("a/b", 6, "bfloat16")):
        assert twt.raw_wire_nbytes(*args) == jwt.raw_wire_nbytes(*args)


def test_unpack_bucket_and_staging_reset():
    named = {"w": np.zeros((600, 1024), np.float32)}
    frames = list(twt.pack_buckets(named, chunk_mb=1))
    st = twt.WeightStaging()
    st.add_bucket(frames[0])
    assert st.n_partial == 1
    st.reset()
    for b in frames:
        st.add_bucket(b)
    assert tuple(st.finalize()["w"].shape) == (600, 1024)
    out = twt.unpack_bucket(list(twt.pack_buckets(_named("bf16")))[0])
    assert out["a/w"].dtype == torch.bfloat16


def test_iter_prefetched_passes_host_tensors_through():
    items = [("a", torch.arange(4)), ("b", np.ones(3)), ("c", torch.zeros(2, 2))]
    got = list(twt.iter_prefetched(iter(items), window=2))
    assert [n for n, _ in got] == ["a", "b", "c"]
    assert all(g is v for (_, g), (_, v) in zip(got, items))


def test_flatten_set_named_match_jax():
    tree = {"a": {"b": np.ones(2), "c": np.zeros(3)}, "d": np.arange(4)}
    assert list(twt.flatten_named(tree)) == list(jwt.flatten_named(tree))
    new = twt.set_named(tree, {"a/c": np.full(3, 7.0)})
    np.testing.assert_array_equal(new["a"]["c"], np.full(3, 7.0))
    with pytest.raises(KeyError):
        twt.set_named(tree, {"x/y": np.zeros(1)})


@pytest.mark.parametrize("scan", [True, False])
def test_to_layout_round_trip(scan):
    cfg = tq.ModelConfig(**MODEL, dtype="float32", param_dtype="float32", scan_layers=scan)
    named = tq.init_params(cfg, torch.Generator().manual_seed(0))
    other = tq.ModelConfig(**MODEL, dtype="float32", param_dtype="float32",
                           scan_layers=not scan)
    moved = to_layout(named, other)
    assert {k: tuple(v.shape) for k, v in moved.items()} == tq.named_shapes(other)
    back = to_layout(moved, cfg)
    assert set(back) == set(named)
    for k in named:
        assert torch.equal(back[k], named[k])
    assert to_layout(named, cfg).keys() == named.keys()
    if not scan:
        partial = {k: v for k, v in named.items() if not k.startswith("layers_0/")}
        with pytest.raises(KeyError, match="layers"):
            to_layout(partial, other)


def _trainer(scan: bool, jparams) -> torch_engine.TorchTrainEngine:
    eng = torch_engine.TorchTrainEngine(
        t_cli.TrainEngineConfig(init_from_scratch=True, dtype="float32", optimizer=None),
        device="cpu")
    eng.model_config = tq.ModelConfig(**MODEL, dtype="float32", param_dtype="float32",
                                      scan_layers=scan)
    eng.create_process_group()
    cfg = tq.ModelConfig(**MODEL, dtype="float32", param_dtype="float32", scan_layers=False)
    eng.initialize(None, None, params=params_from_numpy(jax.tree.map(np.asarray, jparams), cfg))
    return eng


@pytest.mark.parametrize("weight_dtype", ["fp", "int8"])
@pytest.mark.parametrize("scan", [True, False])
def test_trainer_push_frames_equal_jax_push(scan, weight_dtype, cpu_devices):
    """The port trainer's push and the JAX trainer's push of the same
    weights: same names in the same order, byte-equal frames."""
    jcfg = jq.ModelConfig(**MODEL, dtype="float32", param_dtype="float32", scan_layers=scan)
    jparams = jq.init_params(jcfg, jax.random.PRNGKey(4))
    eng = _trainer(scan, jparams)
    # the JAX engine's jitted `_push_cast_fn`, then `quantize_weights`
    cast = jax.jit(lambda t: jax.tree.map(
        lambda x: x.astype(jnp.bfloat16) if jnp.issubdtype(x.dtype, jnp.floating) else x,
        t))(jparams)
    if weight_dtype == "int8":
        cast = jax.jit(jq.quantize_weights)(cast)
    want = list(jwt.pack_buckets(jwt.iter_prefetched(jwt.named_leaves(cast)), chunk_mb=0.01))
    got = list(twt.pack_buckets(eng._dcn_payload(2, weight_dtype), chunk_mb=0.01))
    assert len(got) == len(want) > 1
    assert got == want
    with pytest.raises(ValueError, match="weight_dtype"):
        list(eng._wire_leaves("fp8"))
