"""The decode scheduler against a parent tree's, on one H100: the (g)
group wave of `chip_smoke.py`'s sched phase on the Qwen2.5-7B serve
engine (a cold wave, a weight push, then a warm one) and the GRPO-loop
cell (c) untraced and without its recovery dump, from two trees in the
order parent, change, change, parent.

Run from the repository root, with the parent unpacked at PARENT_ROOT
(default `build/parent`, e.g. `git archive <commit> | tar -x -C
build/parent`):

    python3 tools/sched_ab.py [PARENT_ROOT]

Each run is a child process started at its tree's root, so each imports
and builds its own tree. It prints one JSON line a run (the wave's
prefill forwards and device seconds, decode tok/s, TTFT p50 and wall;
the loop's five step timers and admission counts) and the card's name
and power limit before and after.
"""

import json
import subprocess
import sys
import time

CHILD = r'''
import asyncio, dataclasses, json, sys, threading, time
import numpy as np, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from areal_tpu_torch.ops import _build
_build.build_all()
dev = cs.resolve_device()
engine, cfg, info = cs._serve_engine(dev, cs.SERVE)
rng = np.random.default_rng(cs.SEED + 12)
reqs = []
for i, n in enumerate((256, 512, 768, 1024)):
    ids = rng.integers(0, cfg.vocab_size, n).tolist()
    for j, g in enumerate((dict(greedy=True), dict(greedy=True), dict(temperature=1.0),
                           dict(temperature=1.0, top_p=0.9))):
        reqs.append(cs.ModelRequest(rid=f"g{i}-{j}", input_ids=ids,
                                    gconfig=cs.GenerationHyperparameters(max_new_tokens=256, **g)))
def counts():
    return dict(prefill_calls=engine.prefill_calls, prefill_s=engine.prefill_seconds,
                decode_tokens=engine.decode_tokens, decode_s=engine.decode_seconds,
                decode_steps=engine.decode_steps)
def wave(tag):
    c0 = counts()
    engine.pause_generation()
    out = []
    rs = [cs.ModelRequest(rid=f"{tag}-{r.rid}", input_ids=r.input_ids, gconfig=r.gconfig) for r in reqs]
    t = threading.Thread(target=lambda: out.extend(asyncio.run(cs._serve_wave(engine, rs))))
    t.start()
    while engine._request_q.qsize() < len(rs):
        time.sleep(0.001)
    t0 = time.perf_counter()
    engine.continue_generation()
    t.join()
    wall = time.perf_counter() - t0
    c1 = counts()
    d = {k: c1[k] - c0[k] for k in c0}
    return dict(wall_s=wall, prefill_calls=d["prefill_calls"], prefill_s=d["prefill_s"],
                decode_steps=d["decode_steps"], decode_tok_s=d["decode_tokens"] / d["decode_s"],
                ttft_p50_ms=float(np.percentile([r.ttft * 1e3 for r in out], 50)))
# the first wave meets each prefill shape cold; the second (new prompts'
# keys, same prompts: after a push nothing is reused) is the warm reading
cold = wave("cold")
engine.update_weights_from_tensor({"final_norm": engine.params["final_norm"]}, version=1)
g = dict(cold=cold, warm=wave("warm"))
engine.destroy()
del engine
torch.cuda.empty_cache()
over = [o for o in cs.FULL_OVERRIDES if not o.startswith("recover.")]
run = cs._loop_run(dev, "full", over, model_config=dataclasses.replace(cs.QWEN25_1_5B, remat=True),
                   reward_fn=cs.parity_reward)
steps = [{k: r[f"{k}_s"] for k in cs.LOOP_TIMINGS} for r in run["steps"]]
print("AB " + json.dumps(dict(g=g, loop=dict(steps=steps, prefill_calls=run["prefill_calls"],
                                             admissions=run.get("admissions"),
                                             decode_steps=run["decode_steps"],
                                             wall_s=run["wall_s"]))), flush=True)
'''


def main() -> int:
    parent = sys.argv[1] if len(sys.argv) > 1 else "build/parent"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    for name, root in (("parent", parent), ("change", "."), ("change", "."), ("parent", parent)):
        t0 = time.time()
        p = subprocess.run([sys.executable, "-c", CHILD], cwd=root, capture_output=True, text=True,
                           timeout=900)
        line = next((ln for ln in p.stdout.splitlines() if ln.startswith("AB ")), None)
        if line is None:
            print(name, "FAILED", p.returncode, p.stdout[-3000:], p.stderr[-3000:], flush=True)
            return 1
        print(json.dumps(dict(tree=name, seconds=time.time() - t0, **json.loads(line[3:]))),
              flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
