#!/usr/bin/env python3
"""Time the whole-run CUDA kernel of two or more trees of cytvdn_tpu_torch on
one card, in turns.

    python3 tools/torch_resident_ab.py PARENT_ROOT . . PARENT_ROOT

Each ROOT is the root of a checkout (for example a ``git archive`` of the
parent commit unpacked into a directory that ``.gitignore`` lists). For
each ROOT, in the order given, a child process imports that tree's
``cytvdn_tpu_torch`` and ``chip_smoke``, builds its kernels, and times on
one (64, 64, 512) unaccelerated Jia-Zhao state: one 7500-iteration launch
of the whole-run kernel (two launches, CUDA events) and 200-iteration
launches at those of 66, 132, 264, 396 and 528 blocks that lie below the
full cooperative grid, and at the full grid; then 200-iteration launches
at every state of ``chip_smoke.SWEEP``. It prints one JSON line per run
and, at the end, the mean of each tree's runs, with each tree's ptxas lines
of the one-iteration kernel (``dual_kernel``, ``recon_kernel``,
``finalize_kernel``) and of the whole-run kernel, and whether the
one-iteration kernel's lines are the same in every tree. Needs one CUDA
device; exits non-zero without one or if a child fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CHILD = r"""
import json, sys, torch
import chip_smoke as cs
from cytvdn_tpu_torch.kernels import build
from cytvdn_tpu_torch.kernels.resident import cooperative_grid, resident_solve
if not torch.cuda.is_available():
    sys.exit("no CUDA device")
build.load()
ptx = cs.ptxas_summary(open(build.LOG).read()).split("; ")
shape = cs.CFG1
gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
orig = torch.randn(shape, generator=gen, device="cuda") * 0.3 + 2.0
li = torch.full((3,), 16.0, device="cuda")
lm = torch.full((3,), 1 / 16, device="cuda")
ms = cs.time_ms(lambda: resident_solve(
    orig, orig.clone(), [torch.zeros_like(orig) for _ in range(3)], None,
    None, li, lm, n_iters=7500, fista=False, bc=2), 2)
full = cooperative_grid(torch.device("cuda"), 3, False, False, False)
grids = cs.time_resident_grids(shape, sorted(
    {g for g in (66, 132, 264, 396, 528) if g < full} | {full}))
sweep = {}
for sshape, schedule, with_ref in cs.SWEEP:
    fista = schedule == "fista"
    orig, state, li, lm, _ = cs.random_state(sshape, fista, torch.float32,
                                             gen, jz=True)
    nd = len(sshape)
    ref = orig.clone() if with_ref else None
    rhos = torch.full((200,), 0.37, device="cuda") if fista else None
    sweep[f"{sshape} {schedule}{' ref' if with_ref else ''}"] = cs.time_ms(
        lambda: resident_solve(orig, state[0], state[1:1 + nd],
                               state[1 + nd:] if fista else None, rhos, li,
                               lm, n_iters=200, fista=fista, bc=2, ref=ref),
        2) / 200
    del orig, state, ref
    torch.cuda.empty_cache()
print(json.dumps({
    "k1_ptxas": [p for p in ptx if p.split("<")[0] in
                 ("dual_kernel", "recon_kernel", "finalize_kernel")],
    "resident_ptxas": [p for p in ptx if p.startswith("resident_kernel")],
    "ms_7500": ms, "us_per_iteration": ms / 7500 * 1e3, "full_grid": full,
    "grid_ms_per_iteration": {str(g): t for g, t in grids.items()},
    "sweep_ms_per_iteration": sweep,
    "device": torch.cuda.get_device_name(0)}))
"""


def main(roots) -> int:
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    runs = {}
    for root in roots:
        root = os.path.abspath(root)
        env = dict(os.environ, PYTHONPATH=root)
        out = subprocess.run([sys.executable, "-c", CHILD], cwd=root, env=env,
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"root": root, **rec}), flush=True)
        runs.setdefault(root, []).append(rec)
    means = {}
    for root, recs in runs.items():
        grid_keys = recs[0]["grid_ms_per_iteration"]
        means[root] = {
            "us_per_iteration": [r["us_per_iteration"] for r in recs],
            "mean_us_per_iteration": sum(r["us_per_iteration"] for r in recs)
            / len(recs),
            "grid_ms_per_iteration": {
                g: sum(r["grid_ms_per_iteration"][g] for r in recs) / len(recs)
                for g in grid_keys},
            "sweep_ms_per_iteration": {
                k: sum(r["sweep_ms_per_iteration"][k] for r in recs)
                / len(recs) for k in recs[0]["sweep_ms_per_iteration"]},
            "resident_ptxas": recs[0]["resident_ptxas"],
        }
    k1 = {tuple(r["k1_ptxas"]) for recs in runs.values() for r in recs}
    print(json.dumps({"means": means, "k1_ptxas_identical": len(k1) == 1,
                      "k1_ptxas": sorted(k1)[0], "nvidia_smi": smi}))
    return 0 if len(k1) == 1 else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
