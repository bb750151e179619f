#!/usr/bin/env python3
"""Time the pair CUDA kernel of two or more trees of cytvdn_tpu_torch on one
card, in turns.

    python3 tools/torch_pair_ab.py PARENT_ROOT . . PARENT_ROOT

Each ROOT is the root of a checkout (for example a ``git archive`` of the
parent commit unpacked into a directory that ``.gitignore`` lists). For
each ROOT, in the order given, a child process imports that tree's
``cytvdn_tpu_torch`` and ``chip_smoke``, builds its kernels, and times, on
one Jia-Zhao FISTA state at each of (256,256,128,128), (128,128,64,64)
and (256,256,2048), ms per pair of: the pair kernel as the tree launches
it by default, at strip widths W = 8, 16, 32 and N1 (the whole-row
schedule; in a tree whose wrapper takes a strip), and two launches of the
one-iteration kernel (CUDA events). It also runs one pair of the whole-row schedule on a small
state (37,45,19,23) and keeps its six sums, so that a tree's W = N1 can
be checked bit for bit against a parent without strips. It prints one
JSON line per run and, at the end, the mean of each tree's runs, each
tree's ptxas lines of the pair kernel, and whether the small state's sums
are the same in every tree. Needs one CUDA device; exits non-zero without
one or if a child fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CHILD = r"""
import inspect, json, sys, torch
import chip_smoke as cs
from cytvdn_tpu_torch.kernels import build
from cytvdn_tpu_torch.kernels.temporal import fused_pair_iteration
if not torch.cuda.is_available():
    sys.exit("no CUDA device")
build.load()
ptx = [p for p in cs.ptxas_summary(open(build.LOG).read()).split("; ")
       if p.startswith("pair_kernel")]
strips = "strip" in inspect.signature(fused_pair_iteration).parameters
ms = {}
for shape, n in ((cs.CFG4, 3), (cs.CFG3, 10), (cs.CFG2, 10)):
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    orig, state, li, lm, rho = cs.random_state(shape, True, torch.float32,
                                               gen, jz=True)
    fns = {"pair": cs.pair_fn(fused_pair_iteration, orig, state, li, lm, rho,
                              True)}
    if strips:
        for w in sorted({8, 16, 32, shape[1]}):
            fns[f"W={w}"] = cs.pair_fn(fused_pair_iteration, orig, state, li,
                                       lm, rho, True, strip=w)
    fns["k1x2"] = cs.pair_fn(cs.two_k1, orig, state, li, lm, rho, True)
    ms[str(shape)] = {name: cs.time_ms(fn, n) for name, fn in fns.items()}
    del orig, state, fns
    torch.cuda.empty_cache()
gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
orig, state, li, lm, rho = cs.random_state(cs.ODD, True, torch.float32, gen,
                                           jz=True)
kw = dict(strip=cs.ODD[1]) if strips else {}
sums = cs.pair_fn(fused_pair_iteration, orig, state, li, lm, rho, True, **kw)()
print(json.dumps({
    "pair_ptxas": ptx, "strips": strips, "ms_per_pair": ms,
    "whole_row_sums": [float(x) for x in sums],
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
        means[root] = {
            shape: {name: sum(r["ms_per_pair"][shape][name] for r in recs)
                    / len(recs) for name in row}
            for shape, row in recs[0]["ms_per_pair"].items()}
        means[root]["pair_ptxas"] = recs[0]["pair_ptxas"]
    sums = {tuple(r["whole_row_sums"]) for recs in runs.values() for r in recs}
    print(json.dumps({"means": means, "whole_row_sums_identical": len(sums) == 1,
                      "nvidia_smi": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
