"""The decoupled path's plumbing on the CPU: the allocation grammar, name
records, experiment status, the HTTP client, the decode server's CLI and
the local launcher end to end.

- `api/alloc_mode.AllocationMode.from_str` (parsed by hand: the card
  machine has no `lark`) agrees with the JAX grammar on every allocation
  string in `tests/` and `examples/configs/` and on edge spellings: the
  same type, backends and sizes, the same error class for a string JAX
  rejects, or a refusal naming its ROADMAP item (more than one device:
  item 5; other backends and MoE sections: items 5 and 6).
- nfs name records written by one package are read by the other, within
  a process and across two processes; experiment status likewise.
- `utils/http.py` keeps the JAX retry rules (5xx and torn replies retried
  on the same backoff schedule, a 4xx raised at once with its body) and
  sends a list of buffers as one body.
- The decode server's CLI refuses unported flags with their item, and
  with no card and no `--device cpu` it raises.
- `run_experiment` with `allocation_mode=jax:d1+d1` runs 2 GRPO steps:
  the server as `python -m areal_tpu_torch.launcher.decode_server
  --device cpu`, the trainer as a `python -c` calling `main(...,
  device="cpu")`; the server is torn down and its port released. Its
  restart loop restarts a killed trainer and gives up on a failing one.
"""

import json
import os
import random
import re
import signal
import socket
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import pytest
import torch

from areal_tpu.api import alloc_mode as j_alloc
from areal_tpu.utils import experiment as j_exp
from areal_tpu.utils import http as jhttp
from areal_tpu.utils import name_resolve as j_nr
from areal_tpu.utils import names as j_names
from areal_tpu_torch.api import alloc_mode as t_alloc
from areal_tpu_torch.api.cli_args import BaseExperimentConfig, NameResolveConfig, load_expr_config
from areal_tpu_torch.launcher import decode_server, local
from areal_tpu_torch.launcher.base import JobFailure, JobInfo, JobState, kill_process_tree
from areal_tpu_torch.models.smoke import SMOKE_MODEL_DICT
from areal_tpu_torch.utils import experiment as t_exp
from areal_tpu_torch.utils import http as thttp
from areal_tpu_torch.utils import name_resolve as t_nr
from areal_tpu_torch.utils import names as t_names

ROOT = Path(__file__).resolve().parents[1]
YAML = "examples/configs/arith_grpo_smoke.yaml"
E2E_TIMEOUT = 240


# ---------------------------------------------------------------------------
# allocation grammar
# ---------------------------------------------------------------------------


def _summary(mod, expr):
    """(type, gen backend, train backend, gen sizes, train sizes), or the
    error's class name, or "refused: item N" for the port's refusals."""
    try:
        m = mod.AllocationMode.from_str(expr)
    except NotImplementedError as e:
        return "refused: " + re.search(r"item \d+", str(e)).group(0)
    except Exception as e:  # noqa: BLE001 — compared by class name
        return type(e).__name__

    def sizes(s):
        return None if s is None else (s.data_parallel_size, s.tensor_parallel_size,
                                       s.pipeline_parallel_size, s.context_parallel_size,
                                       s.expert_parallel_size, s.world_size)

    return (m.type_.name, m.gen_backend, m.train_backend, sizes(m.gen), sizes(m.train))


ONE_DEVICE = ["", "  ", "jax:d1+d1", "jax:d1t1+d1", "jax: d1 t1 + jax:d1p1", "jax:d1 + d 1",
              "jax:t1d1+d1t1p1c1", "d1", "d1t1p1", "jax:d1|d1", "jax:d1|jax:d1", "jax:d1",
              "jax:d1+eval", "jax:d1+cpu", "(attn:d1|ffn:d1)", "jax:attn:d1|ffn:d1+d1"]
REJECTED = ["d0", "d01", "jax:d1+", "jax:d1t1+d1+d1", "eval", "jax:d1|eval", "d2d4",
            "d1 d1", "jax:d1d1+d1", "notavalidmode:::", "jax:e1+d1", "jax:c1+d1",
            "megatron:d4+jax:d4", "jax:d2|d8", "(attn:d2t2|ffn:d2e2", "(attn:d4t2|ffn:d2e2)",
            "jax:(attn:d2t2|ffn:d2e2)", "jax:d4c2", "JAX:d1+d1"]
REFUSED = {"d2": "item 5", "jax:d2+d1": "item 5", "jax:d1+d2": "item 5", "jax:d1t2+d1": "item 5",
           "jax:d4t2+eval": "item 5", "d4t2p1": "item 5", "fsdp:d1": "item 5",
           "jax:d1+fsdp:d1": "item 5", "sglang:d1+d1": "item 6", "vllm:d1": "item 6",
           "(attn:d2|ffn:e2)": "item 5", "(attn:d1t2|ffn:e2)": "item 5"}


@pytest.mark.parametrize("expr", ONE_DEVICE + REJECTED)
def test_from_str_agrees_with_jax(expr):
    assert _summary(t_alloc, expr) == _summary(j_alloc, expr)


@pytest.mark.parametrize("expr", sorted(REFUSED))
def test_from_str_refuses_with_its_item(expr):
    jax_side = _summary(j_alloc, expr)
    assert isinstance(jax_side, tuple), jax_side  # JAX accepts it
    assert _summary(t_alloc, expr) == f"refused: {REFUSED[expr]}"


def test_every_allocation_string_of_the_repo():
    found = set()
    pattern = re.compile(r"""(?:from_str\(|allocation_mode[=:]\s*)["']?([^"'\s)\]]*)""")
    for path in list((ROOT / "tests").glob("*.py")) + list((ROOT / "examples/configs").glob("*")):
        for m in pattern.finditer(path.read_text()):
            found.add(m.group(1).rstrip(","))
    assert {"jax:d1t1+d1", "d4t2p1", "jax:d4t2+jax:d8"} <= found
    for expr in sorted(found):
        t, j = _summary(t_alloc, expr), _summary(j_alloc, expr)
        assert t == j or (isinstance(j, tuple) and t.startswith("refused: item")), (expr, t, j)


# ---------------------------------------------------------------------------
# name records and experiment status
# ---------------------------------------------------------------------------


def test_nfs_records_cross_packages(tmp_path):
    tr, jr = t_nr.NfsNameRecordRepository(str(tmp_path)), j_nr.NfsNameRecordRepository(str(tmp_path))
    key = t_names.gen_server("exp", "trial", "127.0.0.1:1")
    assert key == j_names.gen_server("exp", "trial", "127.0.0.1:1")
    tr.add(key, "127.0.0.1:1", delete_on_exit=False)
    assert jr.get(key) == "127.0.0.1:1"
    jr.add(j_names.gen_server("exp", "trial", "127.0.0.1:2"), "127.0.0.1:2")
    root = t_names.gen_servers("exp", "trial")
    assert tr.get_subtree(root) == jr.get_subtree(root) == ["127.0.0.1:1", "127.0.0.1:2"]
    assert tr.find_subtree(root) == jr.find_subtree(root)
    with pytest.raises(t_nr.NameEntryExistsError):
        tr.add(key, "x")
    tr.add("a/ttl", "v", keepalive_ttl=30.0)
    assert jr.get("a/ttl") == "v" and (tmp_path / "a/ttl/ENTRY.ttl").read_text() == "30.0"
    jr.delete(key)
    with pytest.raises(t_nr.NameEntryNotFoundError):
        tr.get(key)
    tr.clear_subtree(root)
    assert jr.get_subtree(root) == []
    assert tr.wait("a/ttl", timeout=1) == "v"
    with pytest.raises(TimeoutError):
        tr.wait("a/none", timeout=0.2)
    tr.reset()
    with pytest.raises(j_nr.NameEntryNotFoundError):
        jr.get("a/ttl")
    mem = t_nr.MemoryNameRecordRepository()
    mem.add("x/y", 1)
    assert mem.get_subtree("x") == ["1"] and mem.find_subtree("x") == ["x/y"]


def test_nfs_records_cross_processes(tmp_path):
    """A port process writes, this process reads with JAX; then JAX
    writes here and a port process reads."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), **t_nr.to_env(
        NameResolveConfig(type="nfs", nfs_record_root=str(tmp_path))))
    code = ("from areal_tpu_torch.utils import name_resolve as nr; nr.reconfigure_from_env(); "
            "import sys; k, v = sys.argv[1:3]; "
            "print(nr.get(k)) if v == '?' else nr.add(k, v, delete_on_exit=False)")
    run = lambda *a: subprocess.run([sys.executable, "-c", code, *a], env=env, cwd=ROOT,  # noqa: E731
                                    capture_output=True, text=True, timeout=120, check=True)
    run("areal_tpu/e/t/gen_servers/s0", "127.0.0.1:9")
    jr = j_nr.NfsNameRecordRepository(str(tmp_path))
    assert jr.get("areal_tpu/e/t/gen_servers/s0") == "127.0.0.1:9"
    jr.add("areal_tpu/e/t/trainer/0", "ready", delete_on_exit=False)
    assert run("areal_tpu/e/t/trainer/0", "?").stdout.strip() == "ready"


def test_name_resolve_backends():
    with pytest.raises(NotImplementedError, match="item 5"):
        t_nr.reconfigure(NameResolveConfig(type="etcd3"))
    with pytest.raises(NotImplementedError, match="not known"):
        t_nr.reconfigure(NameResolveConfig(type="zk"))
    assert t_nr.to_env(NameResolveConfig()) == j_nr.to_env(j_nr.NameResolveConfig())


def test_experiment_status_cross_packages(tmp_path):
    t_nr.reconfigure(NameResolveConfig(type="nfs", nfs_record_root=str(tmp_path)))
    j_nr.reconfigure(j_nr.NameResolveConfig(type="nfs", nfs_record_root=str(tmp_path)))
    seen = []
    done = threading.Event()
    t = t_exp.watch_until_terminal("e", "t", lambda s: (seen.append(s), done.set()),
                                   poll_interval=0.02)
    assert t_exp.get_status("e", "t") is None
    j_exp.publish_status("e", "t", j_exp.ExpStatus.RUNNING)
    time.sleep(0.2)
    assert t_exp.get_status("e", "t") == t_exp.ExpStatus.RUNNING
    j_exp.publish_status("e", "t", "COMPLETE")
    assert done.wait(5) and seen == [t_exp.ExpStatus.COMPLETE]
    t.join(timeout=5)
    assert not t.is_alive()
    statuses = []

    def fake_main(argv, **kw):
        statuses.append((t_exp.get_status("e2", "t2"), kw))
        return "out"

    argv = ["experiment_name=e2", "trial_name=t2", "cluster.name_resolve.type=nfs",
            f"cluster.name_resolve.nfs_record_root={tmp_path}"]
    assert t_exp.run_with_status(fake_main, argv, device="cpu") == "out"
    assert statuses == [(t_exp.ExpStatus.RUNNING, {"device": "cpu"})]
    assert j_exp.get_status("e2", "t2") == j_exp.ExpStatus.COMPLETE
    with pytest.raises(ValueError):
        t_exp.run_with_status(lambda a: (_ for _ in ()).throw(ValueError("x")), argv)
    assert j_exp.get_status("e2", "t2") == j_exp.ExpStatus.ABORTED
    t_nr.reconfigure(NameResolveConfig(type="memory"))
    j_nr.reconfigure(j_nr.NameResolveConfig(type="memory"))


# ---------------------------------------------------------------------------
# the HTTP client
# ---------------------------------------------------------------------------


class _Canned(BaseHTTPRequestHandler):
    """Answers from a script: (status, body) per request, in order; a
    status of 0 closes the connection without answering."""

    protocol_version = "HTTP/1.1"
    script: list = []
    seen: list = []

    def log_message(self, *args):
        pass

    def do_POST(self):
        n = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(n)
        self.seen.append(body)
        status, out = self.script.pop(0)
        if status == 0:
            self.close_connection = True
            return
        data = out.encode()
        self.send_response(status)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


@pytest.fixture
def canned():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Canned)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    _Canned.script, _Canned.seen = [], []
    yield f"127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def test_http_retry_rules(canned):
    _Canned.script = [(503, "{}"), (200, "{not json"), (200, '{"ok": 1}')]
    assert thttp.request_with_retry(canned, "/x", {"a": 1}, retry_delay=0.01) == {"ok": 1}
    assert [json.loads(b) for b in _Canned.seen] == [{"a": 1}] * 3
    _Canned.script = [(404, '{"message": "no", "retry_after": 2}')]
    with pytest.raises(thttp.HttpRequestError) as e:
        thttp.request_with_retry(canned, "/x", {}, retry_delay=0.01)
    assert e.value.status == 404 and e.value.body["retry_after"] == 2
    _Canned.script = [(500, "{}")] * 2
    with pytest.raises(thttp.HttpRequestError, match="after 2 retries") as e:
        thttp.request_with_retry(canned, "/x", {}, max_retries=2, retry_delay=0.01)
    assert e.value.__cause__.status == 500
    # a list of buffers goes out as one body
    _Canned.seen = []
    _Canned.script = [(200, "{}")]
    parts = [b"head", memoryview(bytearray(b"0123456789"))[2:7], b"tail"]
    thttp.request_with_retry(canned, "/x", data=parts)
    assert _Canned.seen == [b"head23456tail"]


def test_http_replaces_a_closed_idle_connection(canned):
    """The server drops the pooled connection between two requests: the
    second goes out on a new connection, not as a retry."""
    _Canned.script = [(200, '{"n": 1}')]
    assert thttp.request_with_retry(canned, "/x", {}, max_retries=1) == {"n": 1}
    for conn in thttp._idle[canned]:
        conn.sock.shutdown(socket.SHUT_RDWR)  # as a server's idle timeout leaves it
    _Canned.script = [(200, '{"n": 2}')]
    assert thttp.request_with_retry(canned, "/x", {}, max_retries=1) == {"n": 2}


def test_backoff_schedule_matches_jax():
    random.seed(3)
    want = list(jhttp.backoff_delays(0.5, 6, jitter=0.25, cap=4.0))
    random.seed(3)
    assert list(thttp.backoff_delays(0.5, 6, jitter=0.25, cap=4.0)) == want


# ---------------------------------------------------------------------------
# the decode server's CLI and the launcher's refusals
# ---------------------------------------------------------------------------


SCRATCH = ["--scratch-model", json.dumps(SMOKE_MODEL_DICT), "--dtype", "float32"]


# the roles serve since they came (items 4.3-4.4; `tests/test_torch_disagg.py`
# starts a server with one); tensor-parallel serving is refused with any
@pytest.mark.parametrize("flags,item", [
    (["--role", "prefill", "--tp-size", "2"], "item 5"),
    (["--role", "decode", "--tp-size", "8"], "item 5"),
    (["--tp-size", "4"], "item 5"),
    (["--tp-size", "2"], "item 5"),
    (["--dtype", "float32", "--role", "decode", "--tp-size", "3"], "item 5"),
])
def test_server_refuses_unported_flags(flags, item):
    with pytest.raises(NotImplementedError, match=item):
        decode_server.main(SCRATCH + flags + ["--device", "cpu"])


def test_server_needs_a_model_and_a_device():
    # a hub id with no local directory fails on its config.json, as in
    # JAX, before a tokenizer load could reach for the hub
    with pytest.raises(FileNotFoundError, match="config.json"):
        decode_server.main(["--model-path", "Qwen/Qwen2.5-1.5B", "--device", "cpu"])
    if not torch.cuda.is_available():
        # no card and no --device cpu: no silent fallback to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            decode_server.main(SCRATCH)


def _config(tmp_path, *overrides):
    argv = ["--config", YAML, f"cluster.fileroot={tmp_path}",
            f"cluster.name_resolve.nfs_record_root={tmp_path}/nr", *overrides]
    return argv, load_expr_config(argv, BaseExperimentConfig, ignore_unknown=True)[0]


def test_launcher_refusals(tmp_path):
    _, cfg = _config(tmp_path, "allocation_mode=jax:d1+d1", "cluster.name_resolve.type=memory")
    with pytest.raises(ValueError, match="name_resolve"):
        local.run_experiment(cfg, ["true"], device="cpu")
    _, cfg = _config(tmp_path, "allocation_mode=jax:d2+d1")
    with pytest.raises(NotImplementedError, match="item 5"):
        local.run_experiment(cfg, ["true"], device="cpu")
    # the supervisor is accepted since item 4.2 came; prefill replicas are
    # still refused: they need more than one generation server (item 4.1)
    _, cfg = _config(tmp_path, "allocation_mode=jax:d1+d1", "launcher.prefill_replicas=1")
    with pytest.raises(NotImplementedError, match="item 4.1"):
        local.run_experiment(cfg, ["true"], device="cpu")
    with pytest.raises(SystemExit):
        local.main(["not-a-script"])
    launcher = local.LocalLauncher("e", "t", str(tmp_path))
    with pytest.raises(NotImplementedError, match="item 5"):
        launcher.submit_trainers(["true"], n_procs=2)


def test_job_states_and_process_tree_kill(tmp_path):
    launcher = local.LocalLauncher("e", "t", str(tmp_path))
    job = launcher.submit("sleeper", [sys.executable, "-c", "import time; time.sleep(60)"])
    assert job.state is JobState.RUNNING and job.state.active()
    t0 = time.monotonic()
    kill_process_tree(job.proc, grace_seconds=5)
    assert time.monotonic() - t0 < 5
    assert job.state is JobState.FAILED and job.recoverable()
    assert JobInfo("x", ["true"]).state is JobState.PENDING
    ok = launcher.submit("ok", ["true"])
    ok.proc.wait(timeout=30)
    assert ok.state is JobState.COMPLETED and not ok.recoverable()
    launcher.stop_all()
    assert launcher.jobs == []


def test_restart_loop(tmp_path, monkeypatch):
    """A trainer killed by SIGKILL (a preemption) restarts the experiment
    up to `max_restarts`; one that exits 1 fails at once."""
    monkeypatch.setattr(local, "RECOVER_TIME_INTERVAL", 0.0)
    _, cfg = _config(tmp_path)
    marker = tmp_path / "tries"
    code = ("import os, signal, sys; p = sys.argv[1]; n = len(open(p).read()) "
            "if os.path.exists(p) else 0; open(p, 'a').write('x'); "
            "os.kill(os.getpid(), signal.SIGKILL) if n < 2 else None")
    local.run_experiment(cfg, [sys.executable, "-c", code, str(marker)], max_restarts=2,
                         timeout=60)
    assert marker.read_text() == "xxx"
    marker.unlink()
    with pytest.raises(JobFailure) as e:
        local.run_experiment(cfg, [sys.executable, "-c", code, str(marker)], max_restarts=1,
                             timeout=60)
    assert e.value.recoverable and marker.read_text() == "xx"
    with pytest.raises(JobFailure) as e:
        local.run_experiment(cfg, [sys.executable, "-c", "raise SystemExit(1)"],
                             max_restarts=3, timeout=60)
    assert not e.value.recoverable


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------


def test_run_experiment_decoupled_two_steps(tmp_path):
    argv, cfg = _config(tmp_path, "allocation_mode=jax:d1+d1", "total_train_steps=2",
                        "evaluator.freq_steps=null")
    code = ("import sys; from areal_tpu_torch.examples.gsm8k_grpo import main; "
            "from areal_tpu_torch.utils.experiment import run_with_status; "
            "run_with_status(main, sys.argv[1:], device='cpu')")
    t0 = time.monotonic()
    local.run_experiment(cfg, [sys.executable, "-c", code, *argv], device="cpu",
                         timeout=E2E_TIMEOUT)
    assert time.monotonic() - t0 < E2E_TIMEOUT
    logs = tmp_path / "logs" / cfg.experiment_name / cfg.trial_name
    trainer = (logs / "trainer_0.log").read_text()
    server = (logs / "decode_server_0.log").read_text()
    assert "(global step 1)" in trainer and "(global step 2)" not in trainer
    assert "Traceback" not in trainer and "Traceback" not in server
    assert "decode server listening" in server
    # the server registered, was torn down, and released its port
    t_nr.reconfigure(cfg.cluster.name_resolve)
    try:
        (addr,) = t_nr.get_subtree(t_names.gen_servers(cfg.experiment_name, cfg.trial_name))
    finally:
        t_nr.reconfigure(NameResolveConfig(type="memory"))
    host, port = addr.rsplit(":", 1)
    with socket.socket() as s:
        assert s.connect_ex((host, int(port))) != 0
    assert t_exp.ExpStatus.COMPLETE.value in (
        tmp_path / "nr" / t_names.experiment_status(cfg.experiment_name, cfg.trial_name)
        / "ENTRY").read_text()
