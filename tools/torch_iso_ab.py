#!/usr/bin/env python3
"""Time the K=1 kernel's launches of two or more trees of cytvdn_tpu_torch
on one card, in turns, and show what their passes compiled to.

    python3 tools/torch_iso_ab.py [--crossing] PARENT_ROOT . . PARENT_ROOT

Each ROOT is the root of a checkout (for example a ``git archive`` of the
parent commit unpacked into a directory that ``.gitignore`` lists). For
each ROOT, in the order given, a child process imports that tree's
``cytvdn_tpu_torch`` and ``chip_smoke``, builds its kernels, and times
(CUDA events) ms per launch of ``fused_iteration`` at the tree's defaults
on Jia-Zhao FISTA float32 states, each set in turns up and down: at
config 4 (256,256,128,128) the exact anisotropic launch, the lossy launch
(bfloat16 d, the same recon and b) and iso R and Q; at config 4's 2-rank
shard (128,256,128,128) the plain version with iso R and Q, then the
kernel with iso R and Q, iso R only, iso Q only and anisotropic; at config
2 (256,256,2048) the 3D launch. It also runs one launch of every mode on
small states — 4D (37,45,19,23), (9,11,7,33) and (9,10,11,32) (last extent
a multiple of 4), 3D (13,45,70) and (6,13,64): every boundary condition,
FISTA and unaccelerated, iso R, Q and both, lossy — holds each state
bitwise against the plain version and keeps a digest of it, so that trees
can be checked bit for bit against each other. With ``--crossing`` it also
times, iso R+Q FISTA, ms per iteration of the whole-run kernel (launches of
50 iterations, the size rule lifted) against K=1 launches at
(32,32,64,128) (335.5 MB of state, just under ``RESIDENT_BYTES``),
(64,32,64,128) (671 MB), (128,32,64,128) (1.34 GB) and (128,128,64,128)
(5.4 GB), in turns.

For every ROOT it then prints the ptxas lines (registers, spill bytes,
stack frame) of its K=1 passes (``dual_kernel``, and where the tree has
them the vector walk's ``dualwalk_kernel`` and ``reconwalk_kernel``) and,
from its library's SASS (``tools/torch_sass_order.py`` of this tree), each
instantiation's stores sent while their own load is in flight and its
local-memory loads and stores, a digest of each K=1 instantiation's
instructions; and the same from ``csrc/fused_iteration.cu`` built with
``-lineinfo``, each in-flight store with its source line. Prints one JSON
line per run and, at the end, the mean of each tree's runs and whether
the small states' digests are the same in every tree. Needs one CUDA
device and a CUDA toolkit; exits non-zero without one, if a child fails,
or if the digests differ.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
#: the K=1 kernel's passes whose ptxas lines and stores are printed (the
#: vector walk's where a tree has them)
PASSES = ("dual_kernel", "dualwalk_kernel", "reconwalk_kernel")

CHILD = r"""
import hashlib, json, sys, torch
import chip_smoke as cs
from cytvdn_tpu_torch.kernels import build
from cytvdn_tpu_torch.kernels import resident as resident_mod
from cytvdn_tpu_torch.kernels.fused import (fused_iteration,
                                            fused_iteration_reference)
from cytvdn_tpu_torch.kernels.resident import resident_solve
from cytvdn_tpu_torch.utils.perf import (launch_bound_seconds, peak_bandwidth,
                                         peak_f32)
if not torch.cuda.is_available():
    sys.exit("no CUDA device")
crossing = sys.argv[1] == "1"
build.load()
name = torch.cuda.get_device_name(0)
bw, f32 = peak_bandwidth(name), peak_f32(name)
MODES = {"rq": dict(iso_r=True, iso_q=True), "r": dict(iso_r=True),
         "q": dict(iso_q=True), "aniso": {}}


def turns(fns, order, n):
    # order, then order reversed; the plain version once per turn
    runs = {k: [] for k in order}
    for k in order + order[::-1]:
        runs[k].append(cs.time_ms(fns[k], 1 if k == "plain" else n))
    return runs


def state(shape, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return cs.random_state(shape, True, torch.float32, gen, jz=True)


def bound(shape, lossy=False):
    if not (bw and f32):
        return float("nan")
    return launch_bound_seconds(shape, True, 1, bw, f32,
                                d_itemsize=2 if lossy else None)[0] * 1e3


runs, bounds = {}, {}
# config 4: exact, lossy (bfloat16 d, the same recon and b) and iso R+Q
cfg4 = (256, 256, 128, 128)
orig, st, li, lm, rho = state(cfg4, cs.SEED + 25)
lossy = st[:5] + [d.to(torch.bfloat16) for d in st[5:]]
fns = {"exact": cs.step_fn(fused_iteration, orig, st, li, lm, rho, True),
       "lossy": cs.step_fn(fused_iteration, orig, lossy, li, lm, rho, True),
       "rq": cs.step_fn(fused_iteration, orig, st, li, lm, rho, True,
                        **MODES["rq"])}
runs["cfg4"] = turns(fns, ["exact", "lossy", "rq"], 3)
bounds["cfg4"] = {"exact": bound(cfg4), "lossy": bound(cfg4, True)}
del orig, st, lossy, fns
torch.cuda.empty_cache()
# config 4's 2-rank shard: the plain version and every iso mode
shard = (128, 256, 128, 128)
orig, st, li, lm, rho = state(shard, cs.SEED + 15)
fns = {m: cs.step_fn(fused_iteration, orig, st, li, lm, rho, True, **kw)
       for m, kw in MODES.items()}
fns["plain"] = cs.step_fn(fused_iteration_reference, orig, st, li, lm, rho,
                          True, **MODES["rq"])
runs["shard"] = turns(fns, ["plain", "rq", "r", "q", "aniso"], 3)
bounds["shard"] = {"aniso": bound(shard)}
del orig, st, fns
torch.cuda.empty_cache()
# config 2, 3D
cfg2 = (256, 256, 2048)
orig, st, li, lm, rho = state(cfg2, cs.SEED + 2)
fns = {"exact3d": cs.step_fn(fused_iteration, orig, st, li, lm, rho, True)}
runs["cfg2"] = turns(fns, ["exact3d"], 5)
bounds["cfg2"] = {"exact3d": bound(cfg2)}
del orig, st, fns
torch.cuda.empty_cache()
ms = {c: {k: sum(v) / len(v) for k, v in r.items()} for c, r in runs.items()}

# small states: every mode, bitwise the plain version, digests
cases = []
for shape in ((37, 45, 19, 23), (9, 11, 7, 33), (9, 10, 11, 32),
              (13, 45, 70), (6, 13, 64)):
    for fista in (True, False):
        for bc in (0, 1, 2):
            cases.append((shape, fista, bc, "aniso", False))
        if len(shape) == 4:
            for mode in ("rq", "r", "q"):
                cases.append((shape, fista, 2, mode, False))
    cases.append((shape, True, 2, "aniso", True))
digests = {}
for shape, fista, bc, mode, lossy in cases:
    outs = []
    for step in (fused_iteration, fused_iteration_reference):
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
        orig, st, li, lm, rho = cs.random_state(shape, fista, torch.float32,
                                                gen, jz=True)
        if lossy:
            st[1 + len(shape):] = [d.to(torch.bfloat16)
                                   for d in st[1 + len(shape):]]
        cs.step_fn(step, orig, st, li, lm, rho, fista, bc=bc,
                   **MODES[mode])()
        outs.append(st)
    key = (f"{shape} bc{bc} {mode} {'FISTA' if fista else 'unacc'}"
           f"{' lossy' if lossy else ''}")
    if not all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(*outs)):
        sys.exit(f"kernel differs from its plain version: {key}")
    h = hashlib.sha256()
    for x in outs[0]:
        h.update(x.cpu().view(torch.uint8).numpy().tobytes())
    digests[key] = h.hexdigest()
cross = {}
if crossing:
    saved = resident_mod.RESIDENT_BYTES
    resident_mod.RESIDENT_BYTES = 1 << 62
    t_res = 50
    for shape in ((32, 32, 64, 128), (64, 32, 64, 128), (128, 32, 64, 128),
                  (128, 128, 64, 128)):
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
        orig, st, li, lm, rho = cs.random_state(shape, True, torch.float32,
                                                gen, jz=True)
        rhos = torch.full((t_res,), 0.37, device="cuda")
        f = {"whole-run": (lambda: resident_solve(
                 orig, st[0], st[1:5], st[5:], rhos, li, lm,
                 n_iters=t_res, fista=True, bc=2, iso_r=True, iso_q=True),
                 t_res),
             "k1": (cs.step_fn(fused_iteration, orig, st, li, lm, rho,
                               True, **MODES["rq"]), 1)}
        r = {k: [] for k in f}
        for k in ("whole-run", "k1", "k1", "whole-run"):
            fn, it = f[k]
            r[k].append(cs.time_ms(fn, max(1, 200 // it)) / it)
        cross[str(shape)] = {k: sum(v) / len(v) for k, v in r.items()}
        del orig, st, f
        torch.cuda.empty_cache()
    resident_mod.RESIDENT_BYTES = saved
print(json.dumps({"ms_per_launch": ms, "runs": runs, "bound_ms": bounds,
                  "crossing_ms_per_iteration": cross, "digests": digests,
                  "device": name}))
"""


def static(root: str):
    """ptxas lines, library SASS and -lineinfo SASS of a tree's K=1
    passes."""
    import chip_smoke as cs
    import torch_sass_order as so

    build_dir = os.path.join(root, "cytvdn_tpu_torch", "_build")
    with open(os.path.join(build_dir, "build.log")) as f:
        ptx = [p for p in cs.ptxas_summary(f.read()).split("; ")
               if p.startswith(PASSES)]
    cuobjdump = os.path.join(os.path.dirname(so.build.nvcc_path()),
                             "cuobjdump")
    lib = subprocess.run([cuobjdump, "-sass",
                          os.path.join(build_dir, "libcytvdn_cuda.so")],
                         capture_output=True, text=True, check=True).stdout
    sass, _ = so.report(lib, list(PASSES))
    # a digest of each pass's instructions (offsets left out), to show
    # which instantiations compiled to the same code in two trees
    digests = so.digests(lib, list(PASSES) + ["recon_kernel",
                                              "finalize_kernel"])
    lined = so.lineinfo_sass(
        [os.path.join(root, "cytvdn_tpu_torch", "csrc", "fused_iteration.cu")],
        os.path.join(build_dir, "lineinfo"))
    lines, _ = so.report(lined, list(PASSES))
    return {"dual_ptxas": ptx, "dual_sass": sass, "dual_sass_lineinfo": lines,
            "sass_digests": digests}


def main(argv) -> int:
    crossing = "--crossing" in argv
    roots = [a for a in argv if a != "--crossing"]
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
        out = subprocess.run([sys.executable, "-c", CHILD,
                              "1" if crossing else "0"],
                             cwd=root, env=env, capture_output=True, text=True,
                             timeout=1200)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"root": root, **rec}), flush=True)
        runs.setdefault(root, []).append(rec)
    sys.path.insert(0, os.path.dirname(HERE))
    for root in runs:
        print(json.dumps({"root": root, **static(root)}), flush=True)
    means = {}
    for root, recs in runs.items():
        means[root] = {
            "ms_per_launch": {
                c: {k: sum(r["ms_per_launch"][c][k] for r in recs)
                    / len(recs) for k in row}
                for c, row in recs[0]["ms_per_launch"].items()},
            "bound_ms": recs[0]["bound_ms"]}
        if recs[0]["crossing_ms_per_iteration"]:
            means[root]["crossing_ms_per_iteration"] = {
                s: {k: sum(r["crossing_ms_per_iteration"][s][k] for r in recs)
                    / len(recs) for k in row}
                for s, row in recs[0]["crossing_ms_per_iteration"].items()}
    same = len({json.dumps(r["digests"], sort_keys=True)
                for recs in runs.values() for r in recs}) == 1
    print(json.dumps({"means": means, "digests_equal": same, "smi": smi}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
