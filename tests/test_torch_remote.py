"""The decoupled rollout wire across the packages, on the CPU.

A JAX `DecodeServer` (in a thread, its `JaxDecodeEngine` in interpret
mode) and the port's `DecodeServer` (its `TorchDecodeEngine` on the CPU,
weights moved from JAX with `models/convert.py`, served unscanned so
pushes of the scanned wire layout go through `convert.to_layout`) serve
the same TINY f32 model. Each is driven by the OTHER package's client:

- greedy streams through the client equal the in-process engines' of
  both packages token for token, logprobs within 1e-6 of the server's own
  engine and 1e-5 of the other package's (`test_torch_decode.py`'s
  tolerance); the interrupt-resume loop gives the uninterrupted stream
  (mirrors `tests/test_remote_inf_engine.py:116-200`);
- version fan-out, rid affinity over a fleet of both servers, and the
  xid idempotency table;
- the push-id fence: an older push id answers 409 to a frame and to a
  commit;
- a dcn push from each package's trainer into the other package's server
  installs the trainer's bf16-cast weights under its version, and so
  does a disk push (an HF checkpoint), last because they change weights.
"""

import asyncio
import threading
import time

import jax
import numpy as np
import pytest
import torch

from areal_tpu.api import cli_args as j_cli
from areal_tpu.api import io_struct as j_io
from areal_tpu.api.alloc_mode import ParallelStrategy as JParallelStrategy
from areal_tpu.core import weight_transfer as jwt
from areal_tpu.core.remote_inf_engine import RemoteInfEngine as JRemote
from areal_tpu.engine.jax_decode import JaxDecodeEngine
from areal_tpu.engine.sft.lm_engine import JaxLMEngine
from areal_tpu.models import qwen2 as jq
from areal_tpu.utils import http as jhttp
from areal_tpu_torch.api import cli_args as t_cli
from areal_tpu_torch.api.io_struct import ModelRequest, WeightUpdateMeta
from areal_tpu_torch.core import weight_transfer as twt
from areal_tpu_torch.core.remote_inf_engine import RemoteInfEngine as TRemote
from areal_tpu_torch.engine.torch_decode import TorchDecodeEngine
from areal_tpu_torch.engine.torch_engine import TorchTrainEngine
from areal_tpu_torch.launcher.decode_server import DecodeServer as TServer
from areal_tpu_torch.models import hf_io
from areal_tpu_torch.models import qwen2 as tq
from areal_tpu_torch.models.convert import params_from_numpy, to_layout
from areal_tpu_torch.utils import http as thttp
from tests.test_remote_inf_engine import TINY, _ServerThread

KW = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, dtype="float32", param_dtype="float32")
DECODE = dict(context_length=96, max_running_requests=4, new_tokens_per_chunk=4,
              dtype="float32", kv_cache_dtype="float32")
SAME_ENGINE_TOL = 1e-6
CROSS_PACKAGE_TOL = 1e-5
DIRECTIONS = ["torch-client/jax-server", "jax-client/torch-server"]


@pytest.fixture(scope="module")
def fleet(cpu_devices):
    """Both servers on the same weights, and each package's client on the
    other's server."""
    jparams = jq.init_params(TINY, jax.random.PRNGKey(0))
    jeng = JaxDecodeEngine(j_cli.JaxDecodeConfig(**DECODE), j_cli.InferenceEngineConfig())
    jeng.set_model(jparams, TINY)
    jeng.initialize()
    jst = _ServerThread(jeng)
    tcfg = tq.ModelConfig(**KW, scan_layers=False)
    teng = TorchDecodeEngine(t_cli.TorchDecodeConfig(**DECODE), t_cli.InferenceEngineConfig(),
                             device="cpu")
    teng.set_model(params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg), tcfg)
    teng.initialize()
    tsrv = TServer(t_cli.TorchDecodeConfig(**DECODE), engine=teng)
    taddr = tsrv.start("127.0.0.1", 0)
    tclient = TRemote(t_cli.InferenceEngineConfig(setup_timeout=30, request_timeout=60))
    tclient.initialize(addr=jst.addr)
    jclient = JRemote(j_cli.InferenceEngineConfig(setup_timeout=30, request_timeout=60))
    jclient.initialize(addr=taddr)
    f = {
        "torch-client/jax-server": dict(client=tclient, engine=jeng, other=teng,
                                        addr=jst.addr, cli=t_cli, post=_t_post),
        "jax-client/torch-server": dict(client=jclient, engine=teng, other=jeng,
                                        addr=taddr, cli=j_cli, post=_j_post),
    }
    yield f
    tclient.destroy()
    jclient.destroy()
    tsrv.stop()
    jst.stop()
    teng.destroy()
    jeng.destroy()


def _t_post(addr, endpoint, payload=None, data=None):
    return thttp.request_with_retry(addr, endpoint, payload=payload, data=data, max_retries=1,
                                    timeout=60)


def _j_post(addr, endpoint, payload=None, data=None):
    async def run():
        try:
            return await jhttp.arequest_with_retry(addr, endpoint, payload=payload, data=data,
                                                   max_retries=1, timeout=60)
        finally:
            await jhttp.close_current_session()

    return asyncio.run(run())


def _req(cli, prompt, n, rid=None):
    kw = dict(input_ids=list(prompt), gconfig=cli.GenerationHyperparameters(
        greedy=True, max_new_tokens=n))
    if rid:
        kw["rid"] = rid
    if cli is t_cli:
        return ModelRequest(**kw)
    return j_io.ModelRequest(**kw)


def _local(engine, prompt, n):
    cli = t_cli if isinstance(engine, TorchDecodeEngine) else j_cli
    return engine.generate(_req(cli, prompt, n))


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_greedy_matches_in_process_engines(fleet, direction):
    f = fleet[direction]
    cli = t_cli if isinstance(f["client"], TRemote) else j_cli
    for prompt in ([3, 14, 15, 9, 2], [1, 2, 3], [7] * 11):
        remote = asyncio.run(f["client"].agenerate(_req(cli, prompt, 12)))
        own, other = _local(f["engine"], prompt, 12), _local(f["other"], prompt, 12)
        assert remote.output_tokens == own.output_tokens == other.output_tokens
        np.testing.assert_allclose(remote.output_logprobs, own.output_logprobs,
                                   atol=SAME_ENGINE_TOL, rtol=0)
        np.testing.assert_allclose(remote.output_logprobs, other.output_logprobs,
                                   atol=CROSS_PACKAGE_TOL, rtol=0)
        assert remote.output_versions == [0] * 12
        assert remote.stop_reason == "length"


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_interrupt_resume_loop(fleet, direction):
    """Pause + abort once the request holds a slot, as a weight swap does:
    the client resumes with its partial tokens and ends with the
    uninterrupted stream."""
    f = fleet[direction]
    eng = f["engine"]
    cli = t_cli if isinstance(f["client"], TRemote) else j_cli
    prompt, n = [5, 11, 7], 64
    uninterrupted = _local(eng, prompt, n).output_tokens
    result = {}

    def run():
        result["resp"] = asyncio.run(f["client"].agenerate(_req(cli, prompt, n)))

    t = threading.Thread(target=run)
    t.start()
    deadline = time.monotonic() + 60
    while not any(s is not None for s in eng._slots):
        assert time.monotonic() < deadline and "resp" not in result, "never admitted"
        time.sleep(0.001)
    eng.pause_generation()
    interrupted = eng.abort_all()
    eng.continue_generation()
    t.join(timeout=60)
    assert not t.is_alive()
    assert interrupted == 1, "the request finished before it could be interrupted"
    resp = result["resp"]
    assert resp.output_tokens == uninterrupted
    assert len(resp.output_logprobs) == len(resp.output_versions) == n


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_set_version_fans_out(fleet, direction):
    f = fleet[direction]
    cli = t_cli if isinstance(f["client"], TRemote) else j_cli
    f["client"].set_version(7)
    try:
        assert f["engine"].get_version() == 7
        resp = asyncio.run(f["client"].agenerate(_req(cli, [1, 2, 3], 4)))
        assert resp.output_versions == [7] * 4
    finally:
        f["client"].set_version(0)


@pytest.mark.parametrize("client_cls", [TRemote, JRemote], ids=["torch", "jax"])
def test_rid_affinity_over_a_mixed_fleet(fleet, client_cls):
    """One client over both servers: a rid keeps its server, fresh rids
    alternate, and a stream is the same whichever server serves it."""
    addrs = [fleet[d]["addr"] for d in DIRECTIONS]
    cli = t_cli if client_cls is TRemote else j_cli
    c = client_cls(cli.InferenceEngineConfig(setup_timeout=30, request_timeout=60))
    c.initialize(addr=addrs)
    try:
        a1 = c.choose_server("rid-x")
        assert c.choose_server("rid-x") == a1
        others = {c.choose_server(f"fresh-{i}") for i in range(4)}
        assert others == set(addrs)
        c._release_local("rid-x")
        outs = [asyncio.run(c.agenerate(_req(cli, [4, 8, 15], 6, rid=f"r{i}")))
                for i in range(2)]
        assert outs[0].output_tokens == outs[1].output_tokens
    finally:
        c.destroy()


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_xid_dedup(fleet, direction):
    """A duplicate delivery (same xid) never generates twice: the second
    reply is the cached one, the first's tokens."""
    f = fleet[direction]
    body = dict(rid="dup", input_ids=[2, 9, 4], xid="xid-dup-" + direction,
                gconfig=dict(greedy=True, max_new_tokens=5))
    first = f["post"](f["addr"], "/generate", payload=body)
    second = f["post"](f["addr"], "/generate", payload=body)
    assert "dedup" not in first and second["dedup"] == "completed"
    assert second["output_tokens"] == first["output_tokens"]
    metrics = thttp.request_with_retry(f["addr"], "/metrics", method="GET", max_retries=1)
    assert metrics["idem_hits_total"] >= 1 and metrics["idem_entries"] >= 1


def test_concurrent_duplicates_generate_once(fleet):
    """Two deliveries of one xid in flight at once on the port's server:
    one generation (the engine's token count grows by one stream)."""
    f = fleet["jax-client/torch-server"]
    eng = f["engine"]
    body = dict(rid="dup2", input_ids=[6, 1, 6], xid="xid-concurrent",
                gconfig=dict(greedy=True, max_new_tokens=16))
    tokens0 = eng.decode_tokens
    eng.pause_generation()  # both deliveries arrive before it runs
    outs = []
    ts = [threading.Thread(target=lambda: outs.append(_t_post(f["addr"], "/generate", body)))
          for _ in range(2)]
    for t in ts:
        t.start()
    time.sleep(0.5)
    eng.continue_generation()
    for t in ts:
        t.join(timeout=60)
    assert len(outs) == 2 and outs[0]["output_tokens"] == outs[1]["output_tokens"]
    assert sorted(o.get("dedup", "") for o in outs) == ["", "in_progress"]
    assert eng.decode_tokens - tokens0 == 16


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_stale_push_id_answers_409(fleet, direction):
    f = fleet[direction]
    err = thttp.HttpRequestError if f["post"] is _t_post else jhttp.HttpRequestError
    frame = list(jwt.pack_buckets({"final_norm": np.ones(32, np.float32)}))[0]
    newer, older = "00000000000000000002-b", "00000000000000000001-a"
    assert f["post"](f["addr"], f"/update_weights_from_tensor?push_id={newer}",
                     data=frame)["staged"] == 1
    with pytest.raises(err) as e:
        f["post"](f["addr"], f"/update_weights_from_tensor?push_id={older}", data=frame)
    assert e.value.status == 409
    with pytest.raises(err) as e:
        f["post"](f["addr"], "/commit_weights", payload=dict(version=1, push_id=older))
    assert e.value.status == 409
    # a torn frame is refused before staging (a 5xx the client retries)
    with pytest.raises(err) as e:
        f["post"](f["addr"], f"/update_weights_from_tensor?push_id={newer}", data=frame[:-2])
    assert e.value.status is None or e.value.status >= 500
    out = f["post"](f["addr"], "/abort_weights", payload=dict(push_id=newer))
    assert out["dropped"] == 1
    with pytest.raises(err) as e:
        f["post"](f["addr"], "/commit_weights", payload=dict(version=1))
    assert e.value.status == 400  # nothing staged
    assert f["engine"].get_version() == 0


def test_unported_routes_answer_501(fleet):
    """The four routes that answered 501 until the prefill/decode roles and
    the KV fabric came serve now (no route answers 501): each package's
    server gives the same 400 to a bad body, `/prefill` parks a prompt, and
    `/set_role` flips the role `/health` reports."""
    addr = fleet["jax-client/torch-server"]["addr"]
    jaddr = fleet["torch-client/jax-server"]["addr"]
    bad = (("/kv_fetch", {}, "target required"),
           ("/kv_fetch", {"target": "127.0.0.1:1"}, "keys or top required"),
           ("/warm_start", {}, "peers required"),
           ("/set_role", {"role": "neither"}, "bad role 'neither'"))
    for route, body, message in bad:
        for a in (addr, jaddr):
            with pytest.raises(thttp.HttpRequestError) as e:
                _t_post(a, route, payload=body)
            assert e.value.status == 400 and e.value.body["message"] == message, (a, route)
    for a in (addr, jaddr):
        out = _t_post(a, "/prefill", payload=dict(rid=f"pf-{a}", input_ids=[3, 14, 15, 9, 2],
                                                   gconfig=dict(max_new_tokens=4)))
        assert out["stop_reason"] == "prefill" and out["migrated"] is False
        flip = _t_post(a, "/set_role", payload={"role": "decode"})
        assert (flip["old_role"], flip["role"]) == ("unified", "decode")
        assert thttp.request_with_retry(a, "/health", method="GET")["role"] == "decode"
        assert _t_post(a, "/set_role", payload={"role": "unified"})["role"] == "unified"
    info = thttp.request_with_retry(addr, "/info", method="GET")
    assert info["kv_layout"] == "paged" and info["role"] == "unified"
    m = thttp.request_with_retry(addr, "/metrics", method="GET")
    for key in ("running_requests", "queued_requests", "active_tokens", "itl_p50_ms",
                "device_busy_s", "device_idle_frac", "weight_sync", "kernel_launches"):
        assert key in m
    assert m["kernel_launches"]["decode_steps"] > 0 and m["itl_p50_ms"] > 0
    # the CPU path launches no kernel: its ops run their plain versions
    assert m["kernel_launches"]["paged_attention"] == 0
    assert m["device_memory_peak"] is None  # the card's allocator only
    eng = fleet["jax-client/torch-server"]["engine"]
    eng.reset_timing_windows()
    m = thttp.request_with_retry(addr, "/metrics", method="GET")
    assert m["itl_p50_ms"] == m["device_busy_s"] == 0 and m["generated_tokens_total"] > 0


# -- weight pushes last: they change the served weights ------------------


def _bf16_f32(x) -> np.ndarray:
    return torch.from_numpy(np.array(x, np.float32)).to(torch.bfloat16).float().numpy()


def _port_trainer(seed: int) -> tuple[TorchTrainEngine, dict]:
    jp = jq.init_params(TINY, jax.random.PRNGKey(seed))
    eng = TorchTrainEngine(t_cli.TrainEngineConfig(init_from_scratch=True, dtype="float32",
                                                   optimizer=None), device="cpu")
    eng.model_config = tq.ModelConfig(**KW)  # scanned: the JAX wire layout
    eng.create_process_group()
    eng.initialize(None, None, params=params_from_numpy(
        jax.tree.map(np.asarray, jp), tq.ModelConfig(**KW, scan_layers=False)))
    return eng, twt.flatten_named(jax.tree.map(np.asarray, jp))


def _jax_trainer() -> tuple[JaxLMEngine, dict]:
    """A JAX trainer on the 8 CPU devices (its weights are its own init,
    unlike the servers')."""
    jcfg = j_cli.TrainEngineConfig(
        experiment_name="push", trial_name="t", init_from_scratch=True, dtype="float32",
        mb_spec=j_cli.MicroBatchSpec(max_tokens_per_mb=32),
        optimizer=j_cli.OptimizerConfig(lr=1e-2, warmup_steps_proportion=0.0),
        gradient_checkpointing=False)
    eng = JaxLMEngine(jcfg)
    eng.model_config = TINY
    eng.create_process_group(JParallelStrategy(data_parallel_size=8))
    eng.initialize(None, j_io.FinetuneSpec(1, 8, 4))
    return eng, jwt.flatten_named(jax.tree.map(np.asarray, eng._export_params()))


def _served(engine) -> dict[str, np.ndarray]:
    """The server engine's weights as scanned f32 numpy, by wire name."""
    if isinstance(engine, TorchDecodeEngine):
        named = to_layout({k: v.float() for k, v in engine.params.items()},
                          tq.ModelConfig(**KW))
        return {k: v.numpy() for k, v in named.items()}
    return jwt.flatten_named(jax.tree.map(lambda x: np.asarray(x, np.float32), engine.params))


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_dcn_push_from_the_other_packages_trainer(fleet, direction):
    f = fleet[direction]
    cli = t_cli if isinstance(f["client"], TRemote) else j_cli
    if isinstance(f["client"], TRemote):
        trainer, want = _port_trainer(99)
        meta = WeightUpdateMeta(type="dcn", weight_chunked_mem_mb=1)
    else:
        trainer, want = _jax_trainer()
        meta = j_io.WeightUpdateMeta(type="dcn", weight_chunked_mem_mb=1)
    trainer.connect_engine(f["client"], meta)
    trainer.set_version(5)
    trainer.update_weights(meta)
    assert f["engine"].get_version() == 5 and f["client"].get_version() == 5
    served = _served(f["engine"])
    assert set(served) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(served[k], _bf16_f32(v), err_msg=k)
    resp = asyncio.run(f["client"].agenerate(_req(cli, [3, 1, 4], 4)))
    assert resp.output_versions == [5] * 4
    stats = f["client"].get_metrics()
    assert stats["n_pushes"] >= 1 and stats["wire_bytes"] > 0
    ws = thttp.request_with_retry(f["addr"], "/metrics", method="GET")
    if "weight_sync" in ws:
        assert ws["weight_sync"]["n_pushes"] >= 1


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_disk_push_from_the_other_packages_trainer(fleet, direction, tmp_path):
    f = fleet[direction]
    if isinstance(f["client"], TRemote):
        trainer, want = _port_trainer(7)
        meta = WeightUpdateMeta(type="disk", path=str(tmp_path / "w"))
    else:
        trainer, want = _jax_trainer()
        meta = j_io.WeightUpdateMeta(type="disk", path=str(tmp_path / "w"))
    trainer.connect_engine(f["client"], meta)
    f["client"].set_version(6)
    trainer.update_weights(meta)
    assert f["engine"].get_version() == 6
    served = _served(f["engine"])
    for k, v in want.items():
        np.testing.assert_array_equal(served[k], np.asarray(v, np.float32), err_msg=k)


def test_disk_swap_reads_the_checkpoint_before_the_pause(fleet, tmp_path, monkeypatch):
    """The port's server reads the HF checkpoint with generation live and
    pauses only for the install and the version stamp; a client's pause
    is kept across the swap."""
    f = fleet["jax-client/torch-server"]
    eng = f["engine"]
    trainer, want = _port_trainer(11)
    path = str(tmp_path / "w")
    hf_io.save_hf_params(trainer.params, trainer.model_config, path)
    seen = []
    read, install = eng.read_disk_weights, eng.update_weights_from_tensor

    def spy_read(meta):
        seen.append(("read", eng._gen_paused.is_set()))
        return read(meta)

    def spy_install(named, version=None):
        seen.append(("install", version))
        return install(named, version=version)

    monkeypatch.setattr(eng, "read_disk_weights", spy_read)
    monkeypatch.setattr(eng, "update_weights_from_tensor", spy_install)
    _t_post(f["addr"], "/update_weights_from_disk", payload={"path": path, "version": 8})
    assert seen == [("read", False), ("install", 8)]
    assert eng.get_version() == 8 and not eng._gen_paused.is_set()
    served = _served(eng)
    for k, v in want.items():
        np.testing.assert_array_equal(served[k], np.asarray(v, np.float32), err_msg=k)
    _t_post(f["addr"], "/pause_generation", payload={"abort": False})
    try:
        _t_post(f["addr"], "/update_weights_from_disk", payload={"path": path, "version": 9})
        assert eng.get_version() == 9 and eng._gen_paused.is_set()
    finally:
        _t_post(f["addr"], "/continue_generation", payload={})
    assert not eng._gen_paused.is_set()
