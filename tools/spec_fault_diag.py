"""Where the spec step's planted fault shows, on one H100: after the spec
serve wave of `chip_smoke.py`, its spec-step batch on the served pool, and
per slot the planted off-by-one horizon's effect on the logits (against
W sequential decode steps), the verify forward's own distance from them,
and the share of the slot's valid layer-0 K rows that are zero. Runs the
parent tree (registry-free engine), then this tree with the registered
donor blocks freed first ("release") and kept ("keep").

Run from the repository root, with the parent unpacked at PARENT_ROOT
(default `build/parent`):

    python3 tools/spec_fault_diag.py [PARENT_ROOT]

It prints one line a run.
"""

import subprocess
import sys

CHILD = r'''
import json, sys, math
import numpy as np, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from areal_tpu_torch.ops import _build
from areal_tpu_torch.ops import paged_attention as pa
_build.build_all()
dev = cs.resolve_device()
engine, cfg, launches = cs.phase_serve_spec(dev, cs.SERVE, "serve_spec")
release = sys.argv[1] == "release"
if release:
    for slot in list(engine._prefix_lookup.values()):
        engine._release_slot_blocks(slot)
rng = np.random.default_rng(cs.SEED + 8)
engine.pause_generation()
width = cs.SPEC_K + 1
table, positions, _, lengths = cs._served_batch(engine, cfg, rng, width=width)
R = len(lengths)
tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (R, width)), device=dev)
active = torch.ones(R, dtype=torch.bool, device=dev)
kp, vp = engine._k_pool, engine._v_pool
bsz = kp.shape[2]
zero_share = []
for r in range(R):
    n = int(lengths[r])
    pos = torch.arange(n, device=dev)
    rows = kp[0][table[r].long()[pos // bsz], pos % bsz]
    zero_share.append(float((rows.abs().amax(dim=(-1, -2)) == 0).float().mean()))
ks, vs = kp.clone(), vp.clone()
def verify(attn):
    return cs.verify_step_paged(engine.params, tokens, positions, kp, vp, table, cfg, active=active, attn_fn=attn, layers=engine._layers)
def off_by_one(q, k_pool, v_pool, table, valid):
    return pa.paged_attention_qlen(q, k_pool, v_pool, table, torch.cat([valid[:, 1:], valid[:, -1:]], dim=1))
with torch.no_grad():
    a = verify(pa.paged_attention_qlen)
    s = torch.stack([cs.decode_step_paged(engine.params, tokens[:, j], positions + j, ks, vs, table, cfg, active=active, attn_fn=pa.paged_attention, layers=engine._layers) for j in range(width)], dim=1)
    f = verify(off_by_one)
    torch.cuda.synchronize()
per_slot = (f - s).abs().amax(dim=(1, 2)).tolist()
noise = (a - s).abs().amax(dim=(1, 2)).tolist()
print("DIAG " + json.dumps(dict(release=release, lengths=[int(x) for x in lengths], zero_share=zero_share,
      fault_per_slot=per_slot, verify_vs_seq_per_slot=noise, used_blocks=int(engine._alloc.usable_blocks - engine._alloc.free_blocks),
      scale=float(a.abs().max()))), flush=True)
'''


def main() -> int:
    parent = sys.argv[1] if len(sys.argv) > 1 else "build/parent"
    for root, arg in ((parent, "keep"), (".", "release"), (".", "keep")):
        p = subprocess.run([sys.executable, "-c", CHILD, arg], cwd=root, capture_output=True,
                           text=True, timeout=900)
        line = next((ln for ln in p.stdout.splitlines() if ln.startswith("DIAG ")), None)
        print(root, arg, line if line else "FAILED " + p.stdout[-2000:] + p.stderr[-3000:],
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
