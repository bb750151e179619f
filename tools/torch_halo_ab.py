#!/usr/bin/env python3
"""Time the K=1 kernel's launches with halos of two or more trees of
cytvdn_tpu_torch on one card, in turns, and check that the trees agree bit
for bit.

    python3 tools/torch_halo_ab.py PARENT_ROOT . . PARENT_ROOT

Each ROOT is the root of a checkout (for example a ``git archive`` of the
parent commit unpacked into a directory that ``.gitignore`` lists). For
each ROOT, in the order given, a child process imports that tree's
``cytvdn_tpu_torch`` and ``chip_smoke``, builds its kernels and times
(CUDA events) ms per launch of ``fused_iteration`` on FISTA float32
Jia-Zhao states, each set in turns up and down, with an interior block's
seams (nonzero slabs from the state itself) on axes 0 and 1 and without:
at config 4's stream slab (64,256,128,128) exact and lossy (bfloat16 d,
the same recon and b); at config 4's (1,2,1,1) shard (256,128,128,128)
and its (2,2,1,1) shard (128,128,128,128) exact; at config 2's stream
slab (64,256,2048) exact (3D: axis 1 is the walk's tiled axis). Each
time's share of the launch's bound (``utils/perf.py``, the seam slabs
read once) is printed beside it.

It also runs three launches with halos on small states — the first, an
interior and the last block along axis 0 and along axis 1, the corners of
a 2 x 2 grid and blocks of extent 1, 4D and 3D, ragged and 128-bit last
extents, exact FISTA, unaccelerated and lossy — holds each state bitwise
against the tree's plain version and keeps a digest of it, so that the
trees can be checked bit for bit against each other (the parent's scalar
passes against the change's walk).

For every ROOT it then prints the ptxas lines and SASS checks of its K=1
passes (``tools/torch_iso_ab.py``'s). Prints one JSON line per run and, at
the end, the mean of each tree's runs and whether the small states'
digests are the same in every tree. Needs one CUDA device and a CUDA
toolkit; exits non-zero without one, if a child fails, or if the digests
differ.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

CHILD = r"""
import hashlib, itertools, json, sys, torch
import chip_smoke as cs
from cytvdn_tpu_torch.kernels import build
from cytvdn_tpu_torch.kernels.fused import (fused_iteration,
                                            fused_iteration_reference)
from cytvdn_tpu_torch.utils.perf import (k1_halo_elements,
                                         launch_bound_seconds, peak_bandwidth,
                                         peak_f32)
if not torch.cuda.is_available():
    sys.exit("no CUDA device")
build.load()
name = torch.cuda.get_device_name(0)
bw, f32 = peak_bandwidth(name), peak_f32(name)


def seams(st, nd, fista=True):
    # an interior block's seams on axes 0 and 1: slabs of the state itself
    r, acc = st[0], st[1:1 + nd]
    h = {"prev0": r[-1:], "next0_recon": r[:1], "next0_acc": acc[0][-1:],
         "prev1": r[:, -1:], "next1_recon": r[:, :1],
         "next1_acc": acc[1][:, -1:]}
    if fista:
        h["next0_d"] = st[1 + nd][-1:].float()
        h["next1_d"] = st[2 + nd][:, -1:].float()
    return {k: v.contiguous().clone() for k, v in h.items()}


def turns(fns, order, n):
    runs = {k: [] for k in order}
    for k in order + order[::-1]:
        runs[k].append(cs.time_ms(fns[k], n))
    return runs


def bound(shape, halos=None, lossy=False):
    if not (bw and f32):
        return float("nan")
    elems = k1_halo_elements(shape, list(halos)) if halos else 0
    return launch_bound_seconds(shape, True, 1, bw, f32, halo_elems=elems,
                                d_itemsize=2 if lossy else None)[0] * 1e3


runs, bounds = {}, {}
for label, shape, lossy in (("slab4", (64, 256, 128, 128), True),
                            ("shard41", (256, 128, 128, 128), False),
                            ("shard22", (128, 128, 128, 128), False),
                            ("slab2", (64, 256, 2048), False)):
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 6)
    orig, st, li, lm, rho = cs.random_state(shape, True, torch.float32, gen,
                                            jz=True)
    nd = len(shape)
    h = seams(st, nd)
    fns = {"halo": cs.step_fn(fused_iteration, orig, st, li, lm, rho, True,
                              halos=h),
           "k1": cs.step_fn(fused_iteration, orig, st, li, lm, rho, True)}
    bounds[label] = {"halo": bound(shape, h), "k1": bound(shape)}
    if lossy:
        lst = st[:1 + nd] + [d.to(torch.bfloat16) for d in st[1 + nd:]]
        fns["lossy_halo"] = cs.step_fn(fused_iteration, orig, lst, li, lm,
                                       rho, True, halos=seams(lst, nd))
        fns["lossy_k1"] = cs.step_fn(fused_iteration, orig, lst, li, lm, rho,
                                     True)
        bounds[label]["lossy_halo"] = bound(shape, h, True)
        bounds[label]["lossy_k1"] = bound(shape, None, True)
    runs[label] = turns(fns, list(fns), 5)
    del orig, st, fns, h
    if lossy:
        del lst
    torch.cuda.empty_cache()
ms = {c: {k: sum(v) / len(v) for k, v in r.items()} for c, r in runs.items()}

# small states with halos, bitwise the plain version, digests
digests = {}
layouts = {"axis0": ((3, 1), [(0, 0), (1, 0), (2, 0)]),
           "axis1": ((1, 3), [(0, 0), (0, 1), (0, 2)]),
           "grid": ((2, 2), [(0, 0), (0, 1), (1, 0), (1, 1)]),
           "extent1": ((6, 6), [(0, 0), (2, 3), (5, 5)])}
for shape in ((6, 6, 7, 33), (6, 6, 5, 32), (6, 6, 70), (6, 12, 64)):
    nd = len(shape)
    for lay, (g2, blocks) in layouts.items():
        for fista, lossy in ((True, False), (False, False), (True, True)):
            for c2 in blocks:
                grid = g2 + (1,) * (nd - 2)
                sl = [slice(c * (n // w), (c + 1) * (n // w))
                      for n, w, c in zip(shape, grid, c2 + (0,) * (nd - 2))]
                outs = []
                for step in (fused_iteration, fused_iteration_reference):
                    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
                    orig, st, li, lm, rho = cs.random_state(
                        shape, fista, torch.float32, gen)
                    if lossy:
                        st[1 + nd:] = [d.to(torch.bfloat16)
                                       for d in st[1 + nd:]]
                    # the block's halos: neighbours' slabs, the Jia-Zhao
                    # values at the cube's edges
                    h = {}
                    for ax in (0, 1):
                        a0, a1 = sl[ax].start, sl[ax].stop
                        def cut(x, i, ax=ax):
                            s = list(sl)
                            s[ax] = slice(i, i + 1)
                            return x[tuple(s)].float().contiguous()
                        h[f"prev{ax}"] = cut(st[0], max(a0 - 1, 0))
                        last = a1 == shape[ax]
                        h[f"next{ax}_recon"] = cut(st[0], a1 - last)
                        z = torch.zeros_like(h[f"next{ax}_recon"])
                        h[f"next{ax}_acc"] = z if last else cut(st[1 + ax],
                                                                a1)
                        if fista:
                            h[f"next{ax}_d"] = z if last else cut(
                                st[1 + nd + ax], a1)
                    blk = [x[tuple(sl)].contiguous() for x in st]
                    o = orig[tuple(sl)].contiguous()
                    f = cs.step_fn(step, o, blk, li, lm, rho, fista, halos=h)
                    for _ in range(3):
                        f()
                    outs.append(blk)
                key = (f"{shape} {lay} {c2} {'FISTA' if fista else 'unacc'}"
                       f"{' lossy' if lossy else ''}")
                if not all(a.dtype == b.dtype and torch.equal(a, b)
                           for a, b in zip(*outs)):
                    sys.exit(f"kernel differs from its plain version: {key}")
                hs = hashlib.sha256()
                for x in outs[0]:
                    hs.update(x.cpu().view(torch.uint8).numpy().tobytes())
                digests[key] = hs.hexdigest()
print(json.dumps({"ms_per_launch": ms, "runs": runs, "bound_ms": bounds,
                  "walk_launches": fused_iteration.walk_launches,
                  "digests": digests, "device": name}))
"""


def main(argv) -> int:
    from torch_iso_ab import static

    roots = list(argv)
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
        out = subprocess.run([sys.executable, "-c", CHILD], cwd=root,
                             env=env, capture_output=True, text=True,
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
    same = len({json.dumps(r["digests"], sort_keys=True)
                for recs in runs.values() for r in recs}) == 1
    print(json.dumps({"means": means, "digests_equal": same, "smi": smi}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
