"""The port's checkpoint watcher (`evaluation/auto.py`) against the JAX
package's, on the CPU.

- The four cases of `tests/test_auto_eval.py` (discovery and publishing in
  step order, a failed job that does not block later steps, a restart
  that counts existing outputs as published, the concurrency bound), each
  run through both packages' `AutomaticEvaluator` with the same fake
  evaluation command: equal publications and statuses.
- The default command runs the port's evaluation CLI
  (`python -m areal_tpu_torch.evaluation.eval_and_aggregate`) with the
  JAX command's arguments, `{ckpt}` and `{out}` substituted as plain
  substrings.
"""

import os
import sys

import pytest

from areal_tpu.evaluation import auto as jauto
from areal_tpu_torch.evaluation import auto as tauto
from tests.test_auto_eval import _fake_eval_cmd, _make_ckpt

PKGS = {"jax": jauto, "torch": tauto}


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_discovers_evaluates_and_publishes_in_order(pkg, tmp_path):
    ckpt_root, out_root = str(tmp_path / "ckpts"), str(tmp_path / "out")
    published = []
    ev = PKGS[pkg].AutomaticEvaluator(ckpt_root, out_root, eval_cmd=_fake_eval_cmd(),
                                      publish=lambda g, r: published.append((g, r["score"])),
                                      max_concurrent_jobs=2)
    # checkpoints appear out of order, and a directory that is no checkpoint
    _make_ckpt(ckpt_root, 0, 5, 10)
    _make_ckpt(ckpt_root, 0, 2, 4)
    os.makedirs(os.path.join(ckpt_root, "not-a-checkpoint"))
    ev.drain(timeout=30)
    _make_ckpt(ckpt_root, 1, 1, 12)
    ev.drain(timeout=30)
    assert published == [(4, 4), (10, 10), (12, 12)]
    assert ev.statuses == {4: "logged", 10: "logged", 12: "logged"}
    assert os.path.exists(os.path.join(out_root, "globalstep4", "result.json"))
    assert os.path.exists(os.path.join(out_root, "globalstep4", "eval_job.log"))


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_failed_job_does_not_block_later_steps(pkg, tmp_path):
    ckpt_root, out_root = str(tmp_path / "ckpts"), str(tmp_path / "out")
    published = []
    ev = PKGS[pkg].AutomaticEvaluator(ckpt_root, out_root, eval_cmd=_fake_eval_cmd(fail_for=4),
                                      publish=lambda g, r: published.append(g))
    _make_ckpt(ckpt_root, 0, 2, 4)
    _make_ckpt(ckpt_root, 0, 5, 10)
    ev.drain(timeout=30)
    assert published == [10]
    assert ev.statuses == {4: "failed", 10: "logged"}


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_restart_treats_existing_output_as_logged(pkg, tmp_path):
    ckpt_root, out_root = str(tmp_path / "ckpts"), str(tmp_path / "out")
    os.makedirs(os.path.join(out_root, "globalstep4"))
    _make_ckpt(ckpt_root, 0, 2, 4)
    _make_ckpt(ckpt_root, 0, 3, 6)
    published = []
    ev = PKGS[pkg].AutomaticEvaluator(ckpt_root, out_root, eval_cmd=_fake_eval_cmd(),
                                      publish=lambda g, r: published.append(g))
    ev.drain(timeout=30)
    assert published == [6]  # step 4 is not evaluated again after the restart
    assert ev.statuses == {4: "logged", 6: "logged"}


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_concurrency_bound(pkg, tmp_path):
    ckpt_root, out_root = str(tmp_path / "ckpts"), str(tmp_path / "out")
    slow = [sys.executable, "-c",
            ("import json,os,sys,time\n"
             "time.sleep(0.3)\n"
             "os.makedirs(sys.argv[2], exist_ok=True)\n"
             "json.dump({'score': 1}, open(os.path.join(sys.argv[2],'result.json'),'w'))\n"),
            "{ckpt}", "{out}"]
    ev = PKGS[pkg].AutomaticEvaluator(ckpt_root, out_root, eval_cmd=slow,
                                      max_concurrent_jobs=1, publish=lambda g, r: None)
    for g in (1, 2, 3):
        _make_ckpt(ckpt_root, 0, g, g)
    ev.step()
    assert ev.statuses == {1: "running", 2: "pending", 3: "pending"}
    with pytest.raises(TimeoutError, match="still busy"):
        ev.drain(timeout=0.01)
    ev.drain(timeout=30)
    assert all(s == "logged" for s in ev.statuses.values())


def test_default_command_names_the_port_cli(tmp_path):
    kw = dict(data_names="gsm8k,math500", tokenizer_path="/tok", max_gen_tokens=64,
              n_sampling=4, max_problems=16)
    cmds = {}
    for pkg, mod in PKGS.items():
        ev = mod.AutomaticEvaluator(str(tmp_path / "ckpts"), str(tmp_path / "out"), **kw)
        step = mod.EvalStep(3, "/ck/epoch0epochstep3globalstep3", str(tmp_path / "out" / "g3"))
        cmds[pkg] = ev._cmd(step)
    assert cmds["torch"][:3] == [sys.executable, "-m",
                                 "areal_tpu_torch.evaluation.eval_and_aggregate"]
    assert cmds["jax"][2] == "areal_tpu.evaluation.eval_and_aggregate"
    assert cmds["torch"][3:] == cmds["jax"][3:] == [
        "--data-names", "gsm8k,math500", "--model-path", "/ck/epoch0epochstep3globalstep3",
        "--output-path", str(tmp_path / "out" / "g3"), "--n-sampling", "4",
        "--max-gen-tokens", "64", "--tokenizer-path", "/tok", "--max-problems", "16"]
    # eval_cmd: {ckpt} and {out} substituted as substrings, braces kept
    ev = tauto.AutomaticEvaluator("r", "o", eval_cmd=["x", "-c", "{'a': 1} {ckpt}", "{out}/r"])
    assert ev._cmd(tauto.EvalStep(1, "/c", "/o")) == ["x", "-c", "{'a': 1} /c", "/o/r"]
