#!/usr/bin/env python3
"""Time the K-step CUDA kernel of two or more trees of cytvdn_tpu_torch on
one card, in turns.

    python3 tools/torch_kstep_ab.py PARENT_ROOT . . PARENT_ROOT
    python3 tools/torch_kstep_ab.py --quick PARENT_ROOT . . PARENT_ROOT
    python3 tools/torch_kstep_ab.py --rows .

Each ROOT is the root of a checkout (for example a ``git archive`` of the
parent commit unpacked into a directory that ``.gitignore`` lists). For
each ROOT, in the order given, a child process imports that tree's
``cytvdn_tpu_torch`` and ``chip_smoke``, builds its kernels, and times
(CUDA events) ms per launch of the K-step kernel at every depth K, up and
down, on one Jia-Zhao state at each of (64,64,512) unaccelerated (config
1), (1024,64,2048) unaccelerated (2.7 GB, 512 KB rows), and, without
``--quick``, (256,256,2048), (128,128,64,64) and (256,256,128,128) FISTA
(configs 2-4). With ``--rows`` it times instead the K=8 launch at R = 1,
2, 4, 8 and 16 axis-0 rows per stage (``rows_per_stage=``), up and down,
at config 1 unaccelerated and FISTA, (1024,64,2048) unaccelerated, configs
2 and 3, (64,128,128,128) FISTA (8 MiB rows) and config 4 (16 MiB rows),
and reports the wrapper's default R (``kstep_rows``) at each: the sweep
behind that rule. It also runs one launch at every K on two small states,
(37,45,19,23) FISTA (ragged edges) and (17,13,64) unaccelerated (a last
extent that is a multiple of 4), and keeps their sums and a digest of the
state after each, so that trees can be checked bit for bit against each
other. It prints one JSON line per run and, at the end, the mean of each
tree's runs, each tree's ptxas lines of the K-step kernel and its blocks
per SM, and whether the small states' digests and sums are the same in
every tree. Needs one CUDA device; exits non-zero without one, if a child
fails, or if the digests differ.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CHILD = r"""
import hashlib, json, sys, torch
import chip_smoke as cs
from cytvdn_tpu_torch.kernels import build
from cytvdn_tpu_torch.kernels.kstep import (KSTEP_CANDIDATES, cooperative_grid,
                                            fused_kstep_iteration)
if not torch.cuda.is_available():
    sys.exit("no CUDA device")
mode = sys.argv[1]
build.load()
ptx = [p for p in cs.ptxas_summary(open(build.LOG).read()).split("; ")
       if p.startswith("kstep")]
ks = sorted(KSTEP_CANDIDATES)
sms = torch.cuda.get_device_properties(0).multi_processor_count
per_sm = {f"{nd}D {'FISTA' if f else 'unacc'} K={k}":
          cooperative_grid(torch.device("cuda"), nd, f, k) / sms
          for nd in (3, 4) for f in (True, False) for k in ks}
shapes = [((64, 64, 512), False, 400), ((1024, 64, 2048), False, 16)]
if mode == "rows":
    shapes = [((64, 64, 512), False, 320), ((64, 64, 512), True, 320),
              ((1024, 64, 2048), False, 24), ((256, 256, 2048), True, 24),
              ((128, 128, 64, 64), True, 24), ((64, 128, 128, 128), True, 24),
              ((256, 256, 128, 128), True, 8)]
elif mode == "full":
    shapes += [((256, 256, 2048), True, 16), ((128, 128, 64, 64), True, 16),
               ((256, 256, 128, 128), True, 8)]
# timed in turns, up and down: every depth K at the default rows per stage,
# or (--rows) K=8 at each R
if mode == "rows":
    k8 = max(ks)
    variants = {f"R={rr}": (k8, rr) for rr in (1, 2, 4, 8, 16)}
else:
    variants = {str(k): (k, None) for k in ks}
ms, default_rows = {}, {}
for shape, fista, iters in shapes:
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    orig, state, li, lm, _ = cs.random_state(shape, fista, torch.float32, gen,
                                             jz=True)
    rhos = torch.full((max(ks),), 0.37, device="cuda")
    runs = {name: [] for name in variants}
    for name in [*variants, *reversed(variants)]:
        k, rr = variants[name]
        # a tree without rows per stage takes no rows_per_stage= argument
        kw = {} if rr is None else dict(rows_per_stage=rr)
        fn = cs.kstep_fn(fused_kstep_iteration, orig, state, li, lm, rhos[:k],
                         k, fista, **kw)
        runs[name].append(cs.time_ms(fn, max(1, iters // k)))
    key = f"{shape} {'FISTA' if fista else 'unacc'}"
    ms[key] = {name: sum(v) / len(v) for name, v in runs.items()}
    if mode == "rows":
        from cytvdn_tpu_torch.kernels.kstep import kstep_rows
        default_rows[key] = kstep_rows(shape)
    del orig, state
    torch.cuda.empty_cache()
digests, sums = {}, {}
for shape, fista in (((37, 45, 19, 23), True), ((17, 13, 64), False)):
    for k in ks:
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
        orig, state, li, lm, _ = cs.random_state(shape, fista, torch.float32,
                                                 gen, jz=True)
        rhos = torch.linspace(0.0, 0.6, k, device="cuda")
        s = cs.kstep_fn(fused_kstep_iteration, orig, state, li, lm, rhos, k,
                        fista)()
        key = f"{shape} K={k}"
        h = hashlib.sha256()
        for x in state:
            h.update(x.cpu().numpy().tobytes())
        digests[key] = h.hexdigest()
        sums[key] = [float(x) for x in s]
print(json.dumps({
    "kstep_ptxas": ptx, "blocks_per_sm": per_sm, "ms_per_launch": ms,
    "default_rows_per_stage": default_rows, "digests": digests, "sums": sums,
    "device": torch.cuda.get_device_name(0)}))
"""


def main(argv) -> int:
    mode = "quick" if "--quick" in argv else "rows" if "--rows" in argv \
        else "full"
    roots = [a for a in argv if a not in ("--quick", "--rows")]
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
        out = subprocess.run([sys.executable, "-c", CHILD, mode],
                             cwd=root, env=env, capture_output=True, text=True,
                             timeout=1200)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"root": root, **rec}), flush=True)
        runs.setdefault(root, []).append(rec)
    means = {}
    for root, recs in runs.items():
        means[root] = {
            shape: {k: sum(r["ms_per_launch"][shape][k] for r in recs)
                    / len(recs) for k in row}
            for shape, row in recs[0]["ms_per_launch"].items()}
        means[root]["kstep_ptxas"] = recs[0]["kstep_ptxas"]
        means[root]["blocks_per_sm"] = recs[0]["blocks_per_sm"]
        means[root]["default_rows_per_stage"] = \
            recs[0]["default_rows_per_stage"]
    digests = {json.dumps(r["digests"], sort_keys=True)
               for recs in runs.values() for r in recs}
    sums = {json.dumps(r["sums"], sort_keys=True)
            for recs in runs.values() for r in recs}
    print(json.dumps({"means": means, "digests_identical": len(digests) == 1,
                      "sums_identical": len(sums) == 1, "nvidia_smi": smi}))
    return 0 if len(digests) == 1 else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
