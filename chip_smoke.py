#!/usr/bin/env python3
"""Drive cytvdn_tpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints one line or a few; any failure raises and exits
non-zero — nothing is caught):

0. device: name, ``nvidia-smi`` name and power limit, TF32 off;
1. build: the CUDA kernels from ``cytvdn_tpu_torch/csrc`` with nvcc, one
   process per source, with the build time and each kernel
   instantiation's registers and spills from ptxas;
2. kernels vs plain: 3 iterations of the fused-iteration kernel against its
   plain PyTorch version on the same inputs — state bitwise equal, the
   three sums within rtol 1e-5 — for every boundary condition, FISTA and
   unaccelerated, half-isotropic pairs, float32 and float64, also at the
   main path's shapes (256,256,2048); two pairs of the pair kernel against
   its plain version, and four launches of the fused-iteration kernel
   against it too (state bitwise equal, sums within rtol 1e-5), at N0 =
   4..7 and on ragged shapes at axis-1 strip widths 1, 2, 3, N1 and the
   default (whole rows), at the main path's shapes at whole rows and W = 32,
   at forced grids
   of 1, 7 and all blocks with a grid one larger refused (the race check),
   and at strips that do not divide N1 or start off the tile grid; at
   (256,256,128,128) two iterations of the fused-iteration kernel, one
   pair and two plain iterations, all bitwise equal (compared off the
   card); then ms per pair of the pair kernel, of two fused-iteration
   launches and of the plain pair at (128,128,64,64), (256,256,2048) and
   (256,256,128,128), and each CUDA kernel's device time from
   ``torch.profiler`` at the last; the pair kernel's strip sweep: ms per
   pair at W = 4, 8, 12, 16, 32, 64 and N1 (the whole-row schedule, the
   default), in turns with two fused-iteration launches, at rows of 2 to 16
   MB (STRIP_SWEEP), and ``run_solver`` x48 there and at (N0,64,2048) for
   N0 = 128, 192, 1024 along the engine's pick, K=8, pairs and the K=1
   loop (the whole-run kernel off); two launches
   of the K-step kernel (K = 3, 4, 6, 8) against its plain version, K
   fused-iteration launches and (K even) K/2 pair launches (state bitwise
   equal, sums within rtol 1e-5) at N0 = 2K and 2K+1 in 3D and 4D and on
   ragged shapes, at forced grids of 1, 7 and all blocks with a grid one
   larger refused, and one launch of every K against its plain version at
   (256,256,2048); ms per launch and per iteration of every K, the pair
   kernel, the fused-iteration kernel and the plain iteration at
   (64,64,512) unaccelerated, (256,256,2048), (128,128,64,64) and
   (256,256,128,128) FISTA (the four BASELINE shapes);
   the ``torch.profiler`` split of all three kernels at (256,256,2048);
   the whole-run kernel (T = 16 and 64 iterations per launch) against its
   plain version and T fused-iteration launches (state bitwise equal, sums
   within rtol 1e-5) for every boundary condition, FISTA, unaccelerated and
   hybrid momentum, with and without a reference cube, iso pairs, at forced
   grids of 1, 7 and all blocks with a grid one larger refused, at its tile
   edges (last extents 1 to 129, ND-2 extents 1, 7 and 9) at the full grid
   and at 1 and 7 blocks, and at (64,64,512) T = 16 against 16
   fused-iteration launches; its size sweep:
   ms per iteration of the whole-run kernel, the K-step (or pair) kernel
   and the fused-iteration kernel, and of ``run_solver`` with the
   whole-run kernel on and off and on the K=1 loop, at 64×64×N
   unaccelerated (N = 128 .. 4096)
   and at (64,64,512) FISTA and with a reference cube;
3. main path: ``denoise4D`` on a 256×256×128×128 float32 cube (the
   BASELINE config-4 size), 20 FISTA iterations (10 pair launches, no
   fused-iteration launch) and 21 (10 + 1), with the launch counts, the
   peak device memory, and the iteration rate with pairs on and off;
4. 3D paths: ``denoise3D`` at (64,64,512) unaccelerated with the default
   7500 iterations (one whole-run launch), ``run_solver`` there with the
   whole-run kernel, with the K-step kernel (whole-run off) and with pairs
   (the engine's row-size rule for pairs lifted), one 7500-iteration
   whole-run launch timed on the device, a stop-aware run there (whole-run
   chunks) against the K=1 loop and the plain backend, ``run_solver`` at
   (256,256,2048) FISTA with the K-step kernel forced and off, a hybrid 3D
   run through the K-step, pair (rule lifted) and fused-iteration kernels
   and hybrid 4D runs (pairs, rule lifted, without an early stop; the K=1
   loop with one in the second phase) against the plain backend on the
   card;
5. one JSON line on the kernels (launches on the path that reaches each,
   error, ms, the plain version's ms and the least time the card could
   take), the card's name and power limit, and the ``{"ok": true, ...}``
   line last.

Needs one CUDA device; exits non-zero without one. Inputs are made from
fixed seeds.
"""

from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from cytvdn_tpu_torch import denoise3D, denoise4D, ops
from cytvdn_tpu_torch.config import SolverOptions
from cytvdn_tpu_torch.kernels import build
from cytvdn_tpu_torch.kernels import resident as resident_mod
from cytvdn_tpu_torch.kernels.fused import fused_iteration, fused_iteration_reference
from cytvdn_tpu_torch.kernels.kstep import (
    KSTEP_CANDIDATES,
    best_kstep,
    fused_kstep_iteration,
    fused_kstep_iteration_reference,
)
from cytvdn_tpu_torch.kernels.kstep import cooperative_grid as kstep_grid
from cytvdn_tpu_torch.kernels.resident import (
    resident_solve,
    resident_solve_reference,
    resident_state_bytes,
)
from cytvdn_tpu_torch.kernels.resident import cooperative_grid as res_grid
from cytvdn_tpu_torch.kernels.temporal import (
    cooperative_grid,
    fused_pair_iteration,
    fused_pair_iteration_reference,
)
from cytvdn_tpu_torch.solver import engine
from cytvdn_tpu_torch.solver.engine import (
    _pairs_pay,
    _resolve_kstep,
    _resolve_resident,
    _resolve_temporal,
    run_solver,
)
from cytvdn_tpu_torch.utils.perf import (
    launch_bound_seconds,
    model_seconds,
    peak_bandwidth,
    peak_f32,
)

SEED = 0
CFG4 = (256, 256, 128, 128)   # BASELINE.json config 4
CFG3 = (128, 128, 64, 64)     # BASELINE.json config 3
CFG1 = (64, 64, 512)          # BASELINE.json config 1
CFG2 = (256, 256, 2048)       # BASELINE.json config 2
ODD = (37, 45, 19, 23)        # ragged tile edges on every axis
# the pair kernel's stages where only some row operations have a row
SMALL_N0 = [(n0, 9, 10, 33) for n0 in (4, 5, 6, 7)] \
    + [(n0, 13, 70) for n0 in (4, 5, 6, 7)]
RHO2 = 0.41                   # the second momentum ratio of a pair
# the pair kernel's forced axis-1 strip widths (None: the wrapper's default,
# whole rows; "N1": one strip, forced); strips that do not divide N1,
# and 3D strips wider than the 8-row tile, whose tiles start off its grid
PAIR_STRIPS = (None, 1, 2, 3, "N1")
RAGGED_STRIPS = [((5, 10, 9, 33), 3), ((6, 13, 70), 5), ((6, 45, 70), 11),
                 ((5, 45, 19, 23), 20), ((6, 45, 70), 20)]
# the strip sweep: rows of 16 MB (config 4), 8 MB, 2 MB (configs 3 and 2,
# 64^2 x 8192) and 4 MB (64^2 x 16384; the last two are 3D unaccelerated
# states above the whole-run kernel's 336 MB: 671 MB and 1.34 GB); all but
# config 4 also through run_solver, the gate's pick against K=8 and the
# K=1 loop
STRIP_SWEEP = [(CFG4, True), ((64, 128, 128, 128), True), (CFG3, True),
               (CFG2, True), ((64, 64, 8192), False), ((64, 64, 16384), False)]
STRIP_WIDTHS = (4, 8, 12, 16, 32, 64)
# 3D unaccelerated states of 336 MB, 503 MB and 2.7 GB whose K=8 stage fits
# the L2 (512 KB rows), so that the K-step gate decides: run_solver only
SOLVER_ONLY = [((128, 64, 2048), False), ((192, 64, 2048), False),
               ((1024, 64, 2048), False)]
KS = tuple(sorted(KSTEP_CANDIDATES))
SHAPE3 = (13, 45, 70)         # a ragged 3D shape


def ragged_cases():
    """The whole-run kernel's tile edges as (shape, bc, iso, schedule,
    ref): last extents around its four-element groups and 32-lane
    segments, ND-2 extents around its tile rows, every BC (mirror where
    every extent is >= 2), schedule and iso pair, with and without a
    reference cube (the cases of tests/test_torch_cuda.py)."""
    cases = []
    schedules = ("fista", "unacc", "hybrid")
    for i, last in enumerate((1, 3, 5, 31, 33, 127, 129)):
        for j, m in enumerate((1, 7, 9)):
            bc = (i + j) % 3
            if bc == 1 and min(m, last) < 2:
                bc = 2 * (i % 2)
            cases.append(((3, m, last), bc, (False, False),
                          schedules[(i + 2 * j) % 3], (i + j) % 2 == 0))
    for i, (m, last) in enumerate(((1, 3), (7, 33), (9, 129), (7, 5),
                                   (9, 31), (1, 127))):
        iso = ((True, False), (False, True), (True, True))[i % 3]
        cases.append(((2, 3, m, last), 2, iso, schedules[i % 3], i % 2 == 1))
    cases.append(((3, 2, 9, 33), 0, (False, False), "fista", True))
    cases.append(((3, 2, 7, 5), 1, (False, False), "unacc", False))
    return cases


RAGGED = ragged_cases()
# the whole-run kernel's size sweep: unaccelerated 64x64xN from 10.5 to
# 335 MB of state, config 1 FISTA (67.1 MB) and with a reference cube
# (50.3 MB), and 4D FISTA at 10.5 and 168 MB
SWEEP = [((64, 64, n), "unacc", False)
         for n in (128, 256, 512, 768, 1024, 2048, 4096)] \
    + [(CFG1, "fista", False), (CFG1, "unacc", True),
       ((16, 16, 32, 32), "fista", False), ((32, 32, 64, 64), "fista", False)]


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def random_state(shape, fista, dtype, gen, jz=False):
    """orig, recon, accs[, ds] on the card, plus per-axis scalars whose clip
    radii are small enough that the projections bind. ``jz`` zeroes each
    accumulator's leading slab along its own axis, the Jia-Zhao invariant
    the pair kernel relies on."""
    ndim = len(shape)

    def rnd(scale):
        return torch.randn(shape, generator=gen, device="cuda", dtype=dtype) * scale

    orig = rnd(0.5) + 2.0
    state = [orig + rnd(0.05)] + [rnd(0.2) for _ in range(ndim)]
    if fista:
        state += [rnd(0.2) for _ in range(ndim)]
    if jz:
        for j, x in enumerate(state[1:]):
            x.select(j % ndim, 0).zero_()
    li = torch.linspace(0.2, 0.35, ndim, device="cuda", dtype=dtype)
    lm = torch.linspace(1 / 32, 1 / 48, ndim, device="cuda", dtype=dtype)
    rho = torch.tensor(0.37, device="cuda", dtype=dtype)
    return orig, state, li, lm, rho


def step_fn(step, orig, state, li, lm, rho, fista, **kw):
    ndim = orig.dim()
    accs = state[1:1 + ndim]
    ds = state[1 + ndim:] if fista else None
    return lambda: step(orig, state[0], accs, ds, rho, li, lm, fista=fista, **kw)


def pair_fn(step, orig, state, li, lm, rho, fista, **kw):
    """One call of a pair function (momentum rho, then RHO2) on ``state``,
    returning its six sums."""
    ndim = orig.dim()
    accs = state[1:1 + ndim]
    ds = state[1 + ndim:] if fista else None
    rho2 = torch.full_like(rho, RHO2)
    return lambda: step(orig, state[0], accs, ds, rho, rho2, li, lm,
                        fista=fista, **kw)[3:]


def two_k1(orig, recon, accs, ds, rho1, rho2, li, lm, fista):
    """Two launches of the fused-iteration kernel, shaped as a pair call."""
    sums = []
    for rho in (rho1, rho2):
        sums += list(fused_iteration(orig, recon, accs, ds, rho, li, lm,
                                     fista=fista)[3:])
    return (recon, accs, ds, *sums)



def compare_case(shape, bc, fista, dtype, iso_r=False, iso_q=False, iters=3):
    """Kernel vs plain from the same state; returns max |Δstate|."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    orig, state, li, lm, rho = random_state(shape, fista, dtype, gen)
    kw = dict(bc=bc, iso_r=iso_r, iso_q=iso_q)
    results = []
    for step in (fused_iteration, fused_iteration_reference):
        s = [x.clone() for x in state]
        fn = step_fn(step, orig, s, li, lm, rho, fista, **kw)
        sums = [torch.stack(fn()[3:]).double() for _ in range(iters)]
        torch.cuda.synchronize()
        results.append((s, torch.stack(sums).cpu()))
    (ks, ksum), (ps, psum) = results
    err = max((a - b).abs().max().item() for a, b in zip(ks, ps))
    bitwise = all(torch.equal(a, b) for a, b in zip(ks, ps))
    require(bitwise, f"kernel != plain: shape {shape} bc {bc} fista {fista} "
                     f"iso ({iso_r},{iso_q}) {dtype}: max |Δ| {err}")
    rel = ((ksum - psum).abs() / psum.abs().clamp_min(1e-300)).max().item()
    require(rel <= 1e-5, f"sums differ by rtol {rel} at {shape} bc {bc}")
    return err


def compare_pair_case(shape, fista, grids=(None,), strips=(None,)):
    """Two pairs of the pair kernel at each forced grid of ``grids`` and
    each forced axis-1 strip width of ``strips`` (None: the full
    cooperative grid, the wrapper's default strip, whole rows; "N1": the
    whole-row schedule, forced) against its plain version, and four fused-iteration launches
    against the plain version too, from the same Jia-Zhao state; returns
    max |Δstate|."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    orig, state, li, lm, rho = random_state(shape, fista, torch.float32, gen,
                                            jz=True)

    def run(step):
        s = [x.clone() for x in state]
        fn = pair_fn(step, orig, s, li, lm, rho, fista)
        sums = [torch.stack(fn()).double() for _ in range(2)]
        torch.cuda.synchronize()
        return s, torch.stack(sums).cpu()

    ps, psum = run(fused_pair_iteration_reference)
    steps = [("4 fused-iteration launches", two_k1)] + [
        (f"grid {g} strip {w}",
         lambda *a, g=g, w=w, **k: fused_pair_iteration(
             *a, grid=g, strip=shape[1] if w == "N1" else w, **k))
        for g in grids for w in strips]
    err = 0.0
    for label, step in steps:
        ks, ksum = run(step)
        err = max(err, max((a - b).abs().max().item() for a, b in zip(ks, ps)))
        require(all(torch.equal(a, b) for a, b in zip(ks, ps)),
                f"{label} state differs from the plain pair: shape {shape} "
                f"fista {fista}: max |Δ| {err}")
        rel = ((ksum - psum).abs() / psum.abs().clamp_min(1e-300)).max().item()
        require(rel <= 1e-5, f"{label} sums differ by rtol {rel} at {shape}")
        del ks
    del ps, state, orig
    torch.cuda.empty_cache()
    return err


def pair_refuses_oversized_grid(shape, strip):
    """A pair launch one block above the cooperative grid raises; returns
    the full grid."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    orig, state, li, lm, rho = random_state(shape, True, torch.float32, gen,
                                            jz=True)
    full = cooperative_grid(torch.device("cuda"), len(shape), True)
    try:
        pair_fn(fused_pair_iteration, orig, state, li, lm, rho, True,
                grid=full + 1, strip=strip)()
    except RuntimeError as e:
        require("launch failed" in str(e), f"unexpected error {e}")
        return full
    raise AssertionError(f"a pair grid of {full + 1} blocks was accepted")


def compare_offcard(shape, fista):
    """At a state too large to hold twice on the card (Jia-Zhao, float32):
    two fused-iteration launches, whose result is kept on the host; then,
    each from the same state rebuilt from the seed, one pair-kernel launch
    and two plain iterations, each array brought back alone and compared
    bitwise with the host copy. Returns max |Δstate| and the sums' largest
    relative difference."""
    def run(step):
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        orig, state, li, lm, rho = random_state(shape, fista, torch.float32,
                                                gen, jz=True)
        sums = torch.stack(pair_fn(step, orig, state, li, lm, rho, fista)())
        return state, sums.double().cpu()

    state, want_sums = run(two_k1)
    host = [x.cpu() for x in state]
    del state
    torch.cuda.empty_cache()
    err, rel = 0.0, 0.0
    for name, step in (("pair kernel", fused_pair_iteration),
                       ("plain", fused_pair_iteration_reference)):
        state, sums = run(step)
        bitwise = True
        for i, p in enumerate(state):
            k = host[i].cuda()
            err = max(err, (k - p).abs().max().item())
            bitwise = bitwise and torch.equal(k, p)
            del k
        del state
        torch.cuda.empty_cache()
        require(bitwise, f"{name} != two fused-iteration launches at {shape} "
                         f"fista {fista}: max |Δ| {err}")
        rel = max(rel, ((sums - want_sums).abs()
                        / want_sums.abs().clamp_min(1e-300)).max().item())
        require(rel <= 1e-5, f"{name} sums differ by rtol {rel} at {shape}")
    return err, rel


def ptxas_summary(log: str) -> str:
    """Registers and spill stores/loads of every kernel instantiation, from
    the build log's ``ptxas -v`` lines, as ``name<template args> R regs,
    S/L spill``."""
    rows, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = re.search(r"([a-z]+_kernel)I(.+?)EEv", m.group(1))
            args = [a or b for a, b in
                    re.findall(r"([fd])(?=L|E|$)|L[ib](\d+)", k.group(2))]
            name = f"{k.group(1)}<{','.join(args)}>"
            spill = ""
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = f"{m.group(1)}/{m.group(2)}"
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            rows.append(f"{name} {m.group(1)} regs, spill {spill}")
    return "; ".join(rows)


def kstep_fn(step, orig, state, li, lm, rhos, k, fista, **kw):
    """One call of a K-step function of depth ``k`` on ``state``, returning
    its 3k sums (sum|b|, sum|dR|, sum|R| per level)."""
    ndim = orig.dim()
    accs = state[1:1 + ndim]
    ds = state[1 + ndim:] if fista else None
    return lambda: torch.stack(step(orig, state[0], accs, ds, rhos, li, lm,
                                    k=k, fista=fista, **kw)[3:], 1).reshape(-1)


def k1_steps(orig, recon, accs, ds, rhos, li, lm, *, k, fista):
    """K launches of the fused-iteration kernel, shaped as a K-step call."""
    sums = [torch.stack(fused_iteration(orig, recon, accs, ds,
                                        rhos[t] if fista else None, li, lm,
                                        fista=fista)[3:]) for t in range(k)]
    return (recon, accs, ds, *torch.stack(sums).unbind(1))


def pair_steps(orig, recon, accs, ds, rhos, li, lm, *, k, fista):
    """K/2 launches of the pair kernel, shaped as a K-step call."""
    sums = []
    for t in range(0, k, 2):
        r1, r2 = (rhos[t], rhos[t + 1]) if fista else (None, None)
        out = fused_pair_iteration(orig, recon, accs, ds, r1, r2, li, lm,
                                   fista=fista)
        sums += [torch.stack(out[3:6]), torch.stack(out[6:9])]
    return (recon, accs, ds, *torch.stack(sums).unbind(1))


def compare_kstep_case(shape, k, fista, grids=(None,), launches=2,
                       plain_only=False):
    """``launches`` launches of the K-step kernel of depth ``k`` (at each
    forced grid of ``grids``; None is the full cooperative grid) against
    its plain version and, unless ``plain_only``, K fused-iteration
    launches and (K even) K/2 pair launches per launch, from the same
    Jia-Zhao state with distinct momentum ratios: state bitwise equal, sums
    within rtol 1e-5. Returns max |Δstate|."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    orig, state, li, lm, _ = random_state(shape, fista, torch.float32, gen,
                                          jz=True)
    rhos = torch.linspace(0.0, 0.6, launches * k, device="cuda")
    steps = [lambda *a, g=g, **kw: fused_kstep_iteration(*a, grid=g, **kw)
             for g in grids] + [fused_kstep_iteration_reference]
    if not plain_only:
        steps.append(k1_steps)
        if k % 2 == 0:
            steps.append(pair_steps)
    results = []
    for step in steps:
        s = [x.clone() for x in state]
        sums = torch.cat([kstep_fn(step, orig, s, li, lm, rhos[i:i + k], k,
                                   fista)()
                          for i in range(0, launches * k, k)]).double()
        torch.cuda.synchronize()
        results.append((s, sums.cpu()))
        del s
    del orig, state
    ks, ksum = results[0]
    err = 0.0
    for ps, psum in results[1:]:
        err = max(err, max((a - b).abs().max().item() for a, b in zip(ks, ps)))
        require(all(torch.equal(a, b) for a, b in zip(ks, ps)),
                f"K-step kernel state differs: shape {shape} K {k} fista "
                f"{fista} grids {grids}: max |Δ| {err}")
        rel = ((ksum - psum).abs() / psum.abs().clamp_min(1e-300)).max().item()
        require(rel <= 1e-5, f"K-step sums differ by rtol {rel} at {shape} "
                             f"K {k}")
    del results
    torch.cuda.empty_cache()
    return err


def refuses_oversized_grid(shape, k):
    """A K-step launch one block above the cooperative grid raises."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    orig, state, li, lm, _ = random_state(shape, True, torch.float32, gen,
                                          jz=True)
    rhos = torch.full((k,), 0.37, device="cuda")
    full = kstep_grid(torch.device("cuda"), len(shape), True, k)
    try:
        kstep_fn(fused_kstep_iteration, orig, state, li, lm, rhos, k, True,
                 grid=full + 1)()
    except RuntimeError as e:
        require("launch failed" in str(e), f"unexpected error {e}")
        return
    raise AssertionError(f"a grid of {full + 1} blocks at K {k} was accepted")


def time_kstep(shape, fista, n_kernel, n_plain):
    """ms per launch of every K-step depth, of the pair kernel, of the
    fused-iteration kernel and of one plain iteration, on one Jia-Zhao
    state (momentum 0.37), in turns: plain, pair, K=1, every K up and down,
    K=1, pair, plain. Returns {name: (ms per launch, iterations per
    launch)} with the means of the two runs, and the raw runs."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    orig, state, li, lm, rho = random_state(shape, fista, torch.float32, gen,
                                            jz=True)
    ndim = len(shape)
    accs = state[1:1 + ndim]
    ds = state[1 + ndim:] if fista else None
    rhos = torch.full((max(KS),), 0.37, device="cuda")
    fns = {
        "pair": (lambda: fused_pair_iteration(
            orig, state[0], accs, ds, rho, rho, li, lm, fista=fista), 2),
        "k1": (lambda: fused_iteration(
            orig, state[0], accs, ds, rho, li, lm, fista=fista), 1),
        "plain": (lambda: fused_iteration_reference(
            orig, state[0], accs, ds, rho, li, lm, fista=fista), 1),
    }
    for k in KS:
        fns[k] = (lambda k=k: fused_kstep_iteration(
            orig, state[0], accs, ds, rhos[:k], li, lm, k=k, fista=fista), k)
    order = ["plain", "pair", "k1", *KS, *reversed(KS), "k1", "pair", "plain"]
    runs = []
    for name in order:
        fn, iters = fns[name]
        n = n_plain if name == "plain" else max(1, round(n_kernel * 2 / iters))
        runs.append((name, time_ms(fn, n)))
    del orig, state, accs, ds, fns
    torch.cuda.empty_cache()
    per_iter = {"pair": 2, "k1": 1, "plain": 1, **{k: k for k in KS}}
    mean = {name: (sum(t for n, t in runs if n == name) / 2, per_iter[name])
            for name in per_iter}
    return mean, [(str(n), round(t, 4)) for n, t in runs]


@contextlib.contextmanager
def pairs_at_any_row():
    """Lift the engine's row-size rule for pairs (``_pairs_pay``), so that
    a small cube runs its phases in pairs."""
    saved = engine.PAIR_MIN_ROW_BYTES
    engine.PAIR_MIN_ROW_BYTES = 0
    try:
        yield
    finally:
        engine.PAIR_MIN_ROW_BYTES = saved


def expected_launches(opts, shape):
    """(whole-run, K-step, pair, fused-iteration) launches ``run_solver``
    makes for a fixed schedule, from the engine's own gates: one whole-run
    launch where ``_resolve_resident`` allows; else each phase runs
    floor(n/K) K-step launches, then pairs where ``_pairs_pay``, then the
    remainder."""
    if opts.iterations_fista + opts.iterations_unacc and \
            _resolve_resident(opts, shape, torch.float32):
        return (1, 0, 0, 0)
    out = [0, 0, 0, 0]
    for n, fista in ((opts.iterations_fista, True),
                     (opts.iterations_unacc, False)):
        if not n:
            continue
        k = _resolve_kstep(opts, shape, torch.float32, fista)
        nk = n // k if k else 0
        rem = n - nk * k
        pairs = rem // 2 if _resolve_temporal(opts, shape, torch.float32) \
            and _pairs_pay(shape, torch.float32) else 0
        out[1] += nk
        out[2] += pairs
        out[3] += rem - 2 * pairs
    return tuple(out)


def launch_counts():
    """(whole-run, K-step, pair, fused-iteration) launches since the last
    ``reset_counts``."""
    return (resident_solve.launches, fused_kstep_iteration.launches,
            fused_pair_iteration.launches, fused_iteration.launches)


def reset_counts():
    resident_solve.launches = 0
    fused_kstep_iteration.launches = 0
    fused_pair_iteration.launches = 0
    fused_iteration.launches = 0


def res_state(shape, schedule, with_ref, n_iters, gen):
    """A random state on the card (``random_state``), the momentum ratios of
    ``schedule`` (None for "unacc"; "hybrid": the second half 0) and, with
    ``with_ref``, a reference cube."""
    fista = schedule != "unacc"
    orig, state, li, lm, _ = random_state(shape, fista, torch.float32, gen)
    ref = (torch.randn(shape, generator=gen, device="cuda") * 0.5 + 2.0
           if with_ref else None)
    rhos = None
    if fista:
        rhos = torch.linspace(0.1, 0.6, n_iters, device="cuda")
        if schedule == "hybrid":
            rhos[n_iters // 2:] = 0.0
    return orig, state, li, lm, rhos, ref


def res_fn(step, orig, state, li, lm, rhos, ref, n_iters, bc, iso, **kw):
    """One call of a whole-run function on ``state``, returning its (3 or
    4, n_iters) sums."""
    ndim = orig.dim()
    accs = state[1:1 + ndim]
    ds = state[1 + ndim:] if rhos is not None else None
    return lambda: torch.stack(step(
        orig, state[0], accs, ds, rhos, li, lm, n_iters=n_iters,
        fista=rhos is not None, bc=bc, ref=ref, iso_r=iso[0], iso_q=iso[1],
        **kw)[3:])


def k1_res_steps(orig, recon, accs, ds, rhos, li, lm, *, n_iters, fista, bc,
                 ref, iso_r, iso_q):
    """``n_iters`` launches of the fused-iteration kernel (and the SSE after
    each), shaped as a whole-run call."""
    sums = []
    for t in range(n_iters):
        row = list(fused_iteration(orig, recon, accs, ds,
                                   rhos[t] if fista else None, li, lm,
                                   fista=fista, bc=bc, iso_r=iso_r,
                                   iso_q=iso_q)[3:])
        if ref is not None:
            row.append(ops.sum_square_error(ref, recon))
        sums.append(torch.stack(row))
    return (recon, accs, ds, *torch.stack(sums).unbind(1))


def compare_resident_case(shape, bc, schedule, with_ref, n_iters,
                          iso=(False, False), grids=(None,), k1=True):
    """One whole-run launch of ``n_iters`` iterations (at each forced grid
    of ``grids``; None is the full cooperative grid) against its plain
    version and, with ``k1``, ``n_iters`` fused-iteration launches, from
    the same random state: state bitwise equal, sums within rtol 1e-5.
    Returns max |Δstate|."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    orig, state, li, lm, rhos, ref = res_state(shape, schedule, with_ref,
                                               n_iters, gen)
    steps = [lambda *a, g=g, **kw: resident_solve(*a, grid=g, **kw)
             for g in grids] + [resident_solve_reference]
    if k1:
        steps.append(k1_res_steps)
    results = []
    for step in steps:
        s = [x.clone() for x in state]
        sums = res_fn(step, orig, s, li, lm, rhos, ref, n_iters, bc, iso)()
        torch.cuda.synchronize()
        results.append((s, sums.double().cpu()))
        del s
    ks, ksum = results[0]
    err = 0.0
    for ps, psum in results[1:]:
        err = max(err, max((a - b).abs().max().item() for a, b in zip(ks, ps)))
        require(all(torch.equal(a, b) for a, b in zip(ks, ps)),
                f"whole-run kernel state differs: shape {shape} bc {bc} "
                f"{schedule} ref {with_ref} iso {iso} T {n_iters} grids "
                f"{grids}: max |Δ| {err}")
        rel = ((ksum - psum).abs() / psum.abs().clamp_min(1e-300)).max().item()
        require(rel <= 1e-5, f"whole-run sums differ by rtol {rel} at {shape} "
                             f"bc {bc} {schedule} T {n_iters}")
    del results, orig, state
    torch.cuda.empty_cache()
    return err


def resident_refuses_oversized_grid(shape, schedule, with_ref,
                                    iso=(False, False)):
    """A whole-run launch one block above its cooperative grid raises;
    returns the full grid."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    orig, state, li, lm, rhos, ref = res_state(shape, schedule, with_ref, 4,
                                               gen)
    full = res_grid(torch.device("cuda"), len(shape), rhos is not None,
                    any(iso), with_ref)
    try:
        res_fn(resident_solve, orig, state, li, lm, rhos, ref, 4, 2, iso,
               grid=full + 1)()
    except RuntimeError as e:
        require("launch failed" in str(e), f"unexpected error {e}")
        return full
    raise AssertionError(f"a whole-run grid of {full + 1} blocks was accepted")


def time_resident_grids(shape, grids, n_iters=200):
    """ms per iteration of the whole-run kernel (unaccelerated, launches of
    ``n_iters`` iterations) on one state at each forced grid of ``grids``
    (None: the full cooperative grid), in turns up and down; the mean of
    the two runs of each."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    orig, state, li, lm, _ = random_state(shape, False, torch.float32, gen)
    runs = []
    for g in list(grids) + list(reversed(grids)):
        runs.append((g, time_ms(lambda: resident_solve(
            orig, state[0], state[1:], None, None, li, lm, n_iters=n_iters,
            fista=False, bc=2, grid=g), 2) / n_iters))
    del orig, state
    torch.cuda.empty_cache()
    return {g: sum(t for h, t in runs if h == g) / 2 for g in grids}


def time_resident(shape, schedule, with_ref, n_iters):
    """ms per iteration, on one Jia-Zhao state (momentum 0.37 under
    FISTA), of: the whole-run kernel (launches of 200 iterations), the
    K-step kernel at the depth the rule picks (the pair kernel where it
    picks none), and back-to-back fused-iteration launches (each followed by
    the SSE with a reference cube, as the engine's loop does), in turns:
    whole-run, K-step, K=1, K=1, K-step, whole-run; then ``run_solver`` for
    ``n_iters`` iterations with the whole-run kernel on, off (the engine's
    next pick), and on the K=1 loop (host clock, the size rule lifted,
    after a short warm-up run of each), in turns on, off, K=1, K=1, off, on.
    Returns ({name: ms per iteration}, the temporal kernel's label, the raw
    runs)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    fista = schedule == "fista"
    orig, state, li, lm, rho = random_state(shape, fista, torch.float32, gen,
                                            jz=True)
    ref = (torch.randn(shape, generator=gen, device="cuda") * 0.5 + 2.0
           if with_ref else None)
    ndim = len(shape)
    accs = state[1:1 + ndim]
    ds = state[1 + ndim:] if fista else None
    t_res = 200
    rhos = torch.full((t_res,), 0.37, device="cuda")
    k = best_kstep(shape, torch.float32, 2, fista)

    def k1():
        fused_iteration(orig, state[0], accs, ds, rho, li, lm, fista=fista)
        if ref is not None:
            ops.sum_square_error(ref, state[0])

    fns = {
        "resident": (lambda: resident_solve(
            orig, state[0], accs, ds, rhos if fista else None, li, lm,
            n_iters=t_res, fista=fista, bc=2, ref=ref), t_res),
        "k1": (k1, 1),
        "temporal": ((lambda: fused_kstep_iteration(
            orig, state[0], accs, ds, rhos[:k], li, lm, k=k, fista=fista), k)
            if k else (lambda: fused_pair_iteration(
                orig, state[0], accs, ds, rho, rho, li, lm, fista=fista), 2)),
    }
    runs = []
    for name in ("resident", "temporal", "k1", "k1", "temporal", "resident"):
        fn, iters = fns[name]
        runs.append((name, time_ms(fn, max(1, 400 // iters)) / iters))
    del fns
    # end to end: the engine's choice with the whole-run kernel on and off,
    # and the K=1 loop
    paths = {"on": dict(), "off": dict(vmem_resident=False),
             "k1": dict(vmem_resident=False, temporal_kstep=False,
                        temporal_pairs=False)}
    saved = resident_mod.RESIDENT_BYTES
    resident_mod.RESIDENT_BYTES = 1 << 62
    try:
        for kw in paths.values():  # warm-up: the allocator's first blocks
            run_solver(orig, li, lm, SolverOptions(
                ndim=ndim, iterations_fista=16 if fista else 0,
                iterations_unacc=0 if fista else 16, calculate_mse=with_ref,
                **kw), ref)
        for path in ("on", "off", "k1", "k1", "off", "on"):
            opts = SolverOptions(ndim=ndim, iterations_fista=n_iters if fista
                                 else 0, iterations_unacc=0 if fista
                                 else n_iters, calculate_mse=with_ref,
                                 **paths[path])
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_solver(orig, li, lm, opts, ref)
            torch.cuda.synchronize()
            runs.append((f"solver_{path}",
                         (time.perf_counter() - t0) * 1e3 / n_iters))
            require(launch_counts() == expected_launches(opts, shape),
                    f"sweep {shape}: launches {launch_counts()}")
    finally:
        resident_mod.RESIDENT_BYTES = saved
    del orig, state, accs, ds, ref
    torch.cuda.empty_cache()
    mean = {name: sum(t for n, t in runs if n == name) / 2
            for name in ("resident", "temporal", "k1", "solver_on",
                         "solver_off", "solver_k1")}
    label = f"K-step K={k}" if k else "pair"
    return mean, label, [(n, round(t, 5)) for n, t in runs]


def profile_kernels(shape, iters=6, kstep=None):
    """Device ms per FISTA float32 iteration of each CUDA kernel, from
    ``torch.profiler``'s ``key_averages()``, over ``iters`` iterations run
    as fused-iteration launches, then as pair-kernel launches, then (with
    ``kstep`` = K) as K-step launches, and the bytes per second that the
    traffic model's traversals imply: the dual pass 4n+1 (17 in 4D), the
    reconstruction pass n+3, the pair and K-step kernels the two-pass 5n+4
    per iteration (the top of their bands)."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    orig, state, li, lm, rho = random_state(shape, True, torch.float32, gen,
                                            jz=True)
    runs = [(pair_fn(two_k1, orig, state, li, lm, rho, True), iters // 2),
            (pair_fn(fused_pair_iteration, orig, state, li, lm, rho, True),
             iters // 2)]
    if kstep:
        rhos = torch.full((kstep,), 0.37, device="cuda")
        runs.append((kstep_fn(fused_kstep_iteration, orig, state, li, lm,
                              rhos, kstep, True), iters // kstep))
    for fn, _ in runs:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fn, n in runs:
            for _ in range(n):
                fn()
        torch.cuda.synchronize()
    del orig, state, runs
    torch.cuda.empty_cache()
    n = len(shape)
    nbytes = int(np.prod(shape)) * 4
    trav = {"dual_kernel": 4 * n + 1, "recon_kernel": n + 3,
            "finalize_kernel": 0, "pair_kernel": 5 * n + 4,
            "kstep_kernel": 5 * n + 4}
    rows = []
    for e in prof.key_averages():
        for key, t in trav.items():
            if key in e.key:
                # each kernel's launches covered ``iters`` iterations
                ms = e.device_time_total / 1e3 / iters
                rate = t * nbytes / (ms / 1e3) if t and ms > 0 else None
                rows.append(f"{key} {ms:.3f} ms" + (
                    f" ({t} traversals, {rate / 1e12:.2f} TB/s)" if rate else ""))
    return rows


def time_ms(fn, n, warm=1):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def time_all(shape, n_kernel, n_plain):
    """ms per pair of FISTA float32 iterations on one Jia-Zhao state, in
    turns: plain pair, pair kernel, two fused-iteration launches (twice),
    pair kernel, plain pair. Returns the means {"pair", "k1x2", "plain"}
    and the six runs."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    orig, state, li, lm, rho = random_state(shape, True, torch.float32, gen,
                                            jz=True)
    fns = {name: pair_fn(step, orig, state, li, lm, rho, True)
           for name, step in (("pair", fused_pair_iteration), ("k1x2", two_k1),
                              ("plain", fused_pair_iteration_reference))}
    runs = [(name, time_ms(fns[name], n_plain if name == "plain" else n_kernel))
            for name in ("plain", "pair", "k1x2", "k1x2", "pair", "plain")]
    del orig, state, fns
    torch.cuda.empty_cache()
    mean = {name: sum(t for n, t in runs if n == name) / 2
            for name in ("pair", "k1x2", "plain")}
    return mean, [(n, round(t, 3)) for n, t in runs]


def time_strips(shape, fista, n_kernel):
    """ms per pair on one Jia-Zhao state (momentum 0.37, then RHO2) of the
    pair kernel at each strip width of STRIP_WIDTHS below N1 and at N1 (the
    whole-row schedule, the wrapper's default), and of two fused-iteration
    launches, in turns: K=1, every width up, every width down, K=1. Returns
    ({width or "k1x2": mean ms}, the raw runs)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    orig, state, li, lm, rho = random_state(shape, fista, torch.float32, gen,
                                            jz=True)
    widths = sorted({w for w in STRIP_WIDTHS if w < shape[1]} | {shape[1]})
    fns = {w: pair_fn(fused_pair_iteration, orig, state, li, lm, rho, fista,
                      strip=w) for w in widths}
    fns["k1x2"] = pair_fn(two_k1, orig, state, li, lm, rho, fista)
    runs = [(name, time_ms(fns[name], n_kernel))
            for name in ["k1x2", *widths, *reversed(widths), "k1x2"]]
    del orig, state, fns
    torch.cuda.empty_cache()
    mean = {name: sum(t for n, t in runs if n == name) / 2
            for name in ["k1x2", *widths]}
    return mean, [(n, round(t, 4)) for n, t in runs]


def time_solver_paths(shape, fista, iters):
    """Host-clock ms per iteration of ``run_solver`` (a fixed schedule of
    ``iters`` iterations on a random cube on the card, the whole-run kernel
    off) along the engine's own pick, with the K-step kernel forced to K=8,
    in pairs (K-step off, the row-size rule lifted), and on the K=1 loop
    (pairs and K-step off), in turns up and down, after a warm-up run of
    each; with the launches of each. Returns ({path: mean ms}, {path:
    launches}, the raw runs)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    orig = torch.randn(shape, generator=gen, device="cuda") * 0.5 + 2.0
    ndim = len(shape)
    li = torch.full((ndim,), 16.0, device="cuda")
    lm = torch.full((ndim,), 1 / 16, device="cuda")
    base = dict(ndim=ndim, iterations_fista=iters if fista else 0,
                iterations_unacc=0 if fista else iters, vmem_resident=False)
    paths = {"gate": dict(), "k8": dict(temporal_k=8),
             "pairs": dict(temporal_kstep=False),
             "k1": dict(temporal_pairs=False)}
    launches, runs = {}, []
    for name in [*paths, *reversed(paths)]:
        opts = SolverOptions(**base, **paths[name])
        with pairs_at_any_row() if name == "pairs" else contextlib.nullcontext():
            if name not in launches:
                run_solver(orig, li, lm, opts)
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_solver(orig, li, lm, opts)
            torch.cuda.synchronize()
            runs.append((name, (time.perf_counter() - t0) * 1e3 / iters))
            launches[name] = launch_counts()
            require(launches[name] == expected_launches(opts, shape),
                    f"{shape} {name}: launches {launches[name]}")
    del orig
    torch.cuda.empty_cache()
    mean = {name: sum(t for n, t in runs if n == name) / 2 for name in paths}
    return mean, launches, [(n, round(t, 4)) for n, t in runs]


def solver_ms(shape, iters, stop):
    """Host-clock ms per unaccelerated iteration of ``run_solver``'s
    one-iteration loop on a random cube on the card; ``stop`` set to a
    threshold that never triggers adds the per-iteration stop check (one
    host sync)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    orig = torch.randn(shape, generator=gen, device="cuda") * 0.5 + 2.0
    ndim = len(shape)
    div = 32.0 if ndim == 4 else 16.0
    li = torch.full((ndim,), div, device="cuda")
    lm = torch.full((ndim,), 1 / div, device="cuda")
    # the one-iteration loop in both runs (the whole-run kernel and the
    # pairs off): the stop check's own cost
    opts = SolverOptions(ndim=ndim, iterations_fista=0, iterations_unacc=iters,
                         stopping_relative_change=stop, temporal_pairs=False,
                         vmem_resident=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_solver(orig, li, lm, opts)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / iters * 1e3
    require(out["iterations_run"] == iters, "the stop check must not trigger")
    return ms


def piecewise_4d(shape, rng):
    """Noisy piecewise-constant 4D cube, generated directly in float32:
    a checkerboard of 64×64 scan tiles plus a bright disk on the detector."""
    t0 = time.perf_counter()
    cube = rng.standard_normal(shape, dtype=np.float32)
    cube *= np.float32(0.3)
    i0 = np.arange(shape[0]) // 64
    i1 = np.arange(shape[1]) // 64
    scan = (1.0 + 0.5 * ((i0[:, None] + i1[None, :]) % 2)).astype(np.float32)
    q0, q1 = np.meshgrid(np.arange(shape[2]), np.arange(shape[3]), indexing="ij")
    r = np.hypot(q0 - shape[2] / 2, q1 - shape[3] / 2)
    det = np.where(r < shape[2] / 4, 2.0, 0.0).astype(np.float32)
    cube += scan[:, :, None, None]
    cube += det[None, None]
    return cube, scan, det, time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    total_t0 = time.perf_counter()
    # phase 0: device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    total_mem = torch.cuda.get_device_properties(0).total_memory
    log(f"phase 0 device: {name}; nvidia-smi: {smi}; "
        f"memory {total_mem / 2**30:.1f} GiB; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; tf32 off")

    # phase 1: build
    t0 = time.perf_counter()
    build.load()
    with open(build.LOG) as f:
        ptxas = ptxas_summary(f.read())
    log(f"phase 1 build: nvcc {build.build_seconds:.2f} s (one process per "
        f"source, in parallel), load {time.perf_counter() - t0:.2f} s; "
        f"{ptxas.count(';') + 1} kernel instantiations; ptxas "
        f"(registers, spill stores/loads in bytes): {ptxas}")

    # phase 2: kernel vs plain on the card
    max_err = 0.0
    n_cases = 0
    for shape in (CFG3, CFG1, ODD):
        for bc in (0, 1, 2):
            for fista in (True, False):
                max_err = max(max_err, compare_case(shape, bc, fista, torch.float32))
                n_cases += 1
        if len(shape) == 4:
            for iso in ((True, False), (False, True), (True, True)):
                for fista in (True, False):
                    max_err = max(max_err, compare_case(
                        shape, 2, fista, torch.float32, *iso))
                    n_cases += 1
    for bc in (0, 2):
        max_err = max(max_err, compare_case(ODD, bc, True, torch.float64))
        n_cases += 1
    max_err = max(max_err, compare_case(CFG3, 2, True, torch.float64,
                                        True, True))
    n_cases += 1
    for fista in (True, False):
        max_err = max(max_err, compare_case(CFG2, 2, fista, torch.float32))
        n_cases += 1
    log(f"phase 2 kernel vs plain: {n_cases} cases, 3 iterations each, state "
        f"bitwise equal (max |Δ| {max_err}), sums within rtol 1e-5")
    t0 = time.perf_counter()
    pair_err = 0.0
    n_pair = 0
    for shape in SMALL_N0 + [ODD, CFG3, CFG1, CFG2]:
        strips = PAIR_STRIPS if shape[0] < 64 else (None, 32)
        for fista in (True, False):
            pair_err = max(pair_err, compare_pair_case(shape, fista,
                                                       strips=strips))
            n_pair += len(strips)
    full = {nd: cooperative_grid(torch.device("cuda"), nd, True) for nd in (3, 4)}
    for shape in (ODD, SMALL_N0[-1]):
        pair_err = max(pair_err, compare_pair_case(
            shape, True, grids=(1, 7, full[len(shape)]), strips=PAIR_STRIPS))
        for w in PAIR_STRIPS:
            pair_refuses_oversized_grid(shape, shape[1] if w == "N1" else w)
    for shape, w in RAGGED_STRIPS:
        for fista in (True, False):
            pair_err = max(pair_err, compare_pair_case(
                shape, fista, grids=(None, 1, 7), strips=(w,)))
    log(f"phase 2 pair kernel vs plain pair, and 4 fused-iteration launches "
        f"vs plain pair: {n_pair} cases (N0 4..7 in 3D and 4D and {ODD} at "
        f"strips {PAIR_STRIPS} (None: the default, whole rows); {CFG3}, "
        f"{CFG1}, {CFG2} at whole rows and W=32; FISTA and unaccelerated), 2 "
        f"pairs each, "
        f"state bitwise equal (max |Δ| {pair_err}), sums within rtol 1e-5; "
        f"the same state at every one of those strips at forced grids of 1, "
        f"7 and {full[4]} (4D) / {full[3]} (3D) blocks at {ODD} and "
        f"{SMALL_N0[-1]}, a grid one block larger refused; ragged strips "
        f"{RAGGED_STRIPS} at the full grid and 1 and 7 blocks; "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    err4, rel4 = compare_offcard(CFG4, True)
    max_err = max(max_err, err4)
    pair_err = max(pair_err, err4)
    log(f"phase 2 at the main path's {CFG4}, FISTA f32 (state held on the "
        f"host): 2 fused-iteration launches = 1 pair-kernel launch = 2 plain "
        f"iterations, 9 arrays bitwise equal (max |Δ| {err4}), sums within "
        f"rtol {rel4:.2e}; {time.perf_counter() - t0:.1f} s")
    times = {}
    for shape, n_k, n_p in ((CFG3, 10, 3), (CFG2, 10, 3), (CFG4, 3, 1)):
        times[shape], raw = time_all(shape, n_k, n_p)
        t = times[shape]
        log(f"phase 2 time per pair of FISTA f32 iterations at {shape}: pair "
            f"kernel {t['pair']:.3f} ms, 2 fused-iteration launches "
            f"{t['k1x2']:.3f} ms, plain pair {t['plain']:.3f} ms (runs {raw}) "
            f"[{smi}]")
    k4, p4 = times[CFG4]["k1x2"] / 2, times[CFG4]["plain"] / 2
    log(f"phase 2 time per FISTA f32 iteration at {CFG4}: fused-iteration "
        f"kernel {k4:.3f} ms, plain {p4:.3f} ms; at {CFG3}: "
        f"{times[CFG3]['k1x2'] / 2:.3f} / {times[CFG3]['plain'] / 2:.3f} ms "
        f"[{smi}]")
    prof = profile_kernels(CFG4)
    log(f"phase 2 torch.profiler device time per FISTA f32 iteration at "
        f"{CFG4}: {'; '.join(prof) or 'no device events seen'} [{smi}]")
    # the pair kernel's strip sweep (the whole-row schedule is W = N1)
    t0 = time.perf_counter()
    strip_ms = {}
    for shape, fista in STRIP_SWEEP:
        n_k = 2 if np.prod(shape) > 2**29 else 8
        strip_ms[shape], raw = time_strips(shape, fista, n_k)
        t = strip_ms[shape]
        row_mb = int(np.prod(shape[1:])) * 4 / 2**20
        log(f"phase 2 pair strip sweep at {shape} "
            f"{'FISTA' if fista else 'unaccelerated'} f32 ({row_mb:g} MiB "
            f"rows), ms per pair by strip width W: "
            + ", ".join(f"W={w}{' (N1, whole rows)' if w == shape[1] else ''}"
                        f" {v:.4f}" for w, v in t.items() if w != "k1x2")
            + f"; 2 fused-iteration launches {t['k1x2']:.4f} (runs {raw}) "
            f"[{smi}]")
    b4 = launch_bound_seconds(CFG4, True, 2, peak_bandwidth(name),
                              peak_f32(name))[0] * 1e3 \
        if peak_bandwidth(name) and peak_f32(name) else float("nan")
    t4 = strip_ms[CFG4]
    w4 = CFG4[1]
    best = min((w for w in t4 if w != "k1x2"), key=t4.get)
    log(f"phase 2 pair kernel at {CFG4} FISTA f32: {t4[w4]:.3f} ms per pair "
        f"at whole rows, the default W={w4} ({b4 / t4[w4]:.3f} of the "
        f"{b4:.2f} ms bound; "
        f"91.36 ms, 0.27, in PERF.md for the parent's whole-row kernel); "
        f"W=8 (a 512 KB row-tile) {t4[8]:.3f} ms ({b4 / t4[8]:.3f}); the "
        f"fastest width W={best} {t4[best]:.3f} ms; 2 fused-iteration "
        f"launches {t4['k1x2']:.3f} ms; sweep {time.perf_counter() - t0:.1f}"
        f" s [{smi}]")
    for shape, fista in STRIP_SWEEP[1:] + SOLVER_ONLY:  # config 4: phase 3
        mean, launches, raw = time_solver_paths(shape, fista, 48)
        mb = resident_state_bytes(shape, fista, False) / 1e6
        log(f"phase 2 run_solver {shape} {'FISTA' if fista else 'unaccelerated'}"
            f" ({mb:.1f} MB of state) x48 on the card, whole-run off, ms per "
            f"iteration: the gate's pick {mean['gate']:.4f} (launches "
            f"whole-run/K-step/pair/fused {launches['gate']}), K=8 forced "
            f"{mean['k8']:.4f} ({launches['k8']}), pairs {mean['pairs']:.4f} "
            f"({launches['pairs']}), K=1 loop {mean['k1']:.4f} "
            f"({launches['k1']}) (runs {raw}) [{smi}]")

    # the K-step kernel: every depth against its plain version, K
    # fused-iteration launches and K/2 pair launches, then at forced grids
    t0 = time.perf_counter()
    kstep_err = 0.0
    n_kstep = 0
    for k in KS:
        for shape in ((2 * k, 9, 10, 33), (2 * k + 1, 9, 10, 33),
                      (2 * k, 13, 70), (2 * k + 1, 13, 70), ODD):
            for fista in (True, False):
                kstep_err = max(kstep_err, compare_kstep_case(shape, k, fista))
                n_kstep += 1
    grids = {}
    for k in KS:
        for shape in (ODD, (2 * k + 1, 13, 70)):
            full_k = kstep_grid(torch.device("cuda"), len(shape), True, k)
            grids[(k, len(shape))] = full_k
            kstep_err = max(kstep_err, compare_kstep_case(
                shape, k, True, grids=(1, 7, full_k), plain_only=True))
            refuses_oversized_grid(shape, k)
    log(f"phase 2 K-step kernel vs plain, vs K fused-iteration launches and "
        f"(K even) vs K/2 pair launches: {n_kstep} cases (K {KS}; N0 = 2K, "
        f"2K+1 in 3D and 4D, {ODD}; FISTA and unaccelerated), 2 launches each, "
        f"state bitwise equal (max |Δ| {kstep_err}), sums within rtol 1e-5; "
        f"the same state at forced grids of 1, 7 and the full grid "
        f"{ {f'K{k} {nd}D': g for (k, nd), g in grids.items()} } at {ODD} and "
        f"(2K+1, 13, 70), a grid one block larger refused; "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for k in KS:
        for fista in (True, False):
            kstep_err = max(kstep_err, compare_kstep_case(
                CFG2, k, fista, launches=1, plain_only=True))
    log(f"phase 2 K-step kernel vs plain at {CFG2}: K {KS}, FISTA and "
        f"unaccelerated, one launch each, state bitwise equal (max |Δ| "
        f"{kstep_err}), sums within rtol 1e-5; {time.perf_counter() - t0:.1f} s")
    ktimes = {}
    for shape, fista, n_k, n_p in ((CFG1, False, 100, 20), (CFG2, True, 8, 2),
                                   (CFG3, True, 8, 2), (CFG4, True, 2, 1)):
        ktimes[shape], raw = time_kstep(shape, fista, n_k, n_p)
        t = ktimes[shape]
        per_launch = ", ".join(f"K={k} {t[k][0]:.4f} ms/launch "
                               f"{t[k][0] / k:.4f} ms/it" for k in KS)
        log(f"phase 2 K-step timing at {shape} "
            f"{'FISTA' if fista else 'unaccelerated'} f32: {per_launch}; "
            f"pair {t['pair'][0]:.4f} ms/launch {t['pair'][0] / 2:.4f} ms/it; "
            f"fused-iteration {t['k1'][0]:.4f} ms/it; plain "
            f"{t['plain'][0]:.4f} ms/it; so per K iterations "
            + ", ".join(f"K={k}: K-step {t[k][0]:.4f}, K/2 pairs "
                        f"{t['pair'][0] * k / 2:.4f}, K fused-iteration "
                        f"{t['k1'][0] * k:.4f}, plain {t['plain'][0] * k:.4f} ms"
                        for k in KS)
            + f" (runs {raw}) [{smi}]")
    kprof = profile_kernels(CFG2, iters=16, kstep=max(KS))
    log(f"phase 2 torch.profiler device time per FISTA f32 iteration at "
        f"{CFG2}, 16 iterations each as fused-iteration, pair and K={max(KS)} "
        f"launches: {'; '.join(kprof) or 'no device events seen'} [{smi}]")

    # the whole-run kernel: against its plain version and T fused-iteration
    # launches (T = 16 and 64), every BC, FISTA / unaccelerated / hybrid,
    # with and without a reference cube, iso pairs; then forced grids
    t0 = time.perf_counter()
    res_err = 0.0
    n_res = 0
    for shape in (ODD, SHAPE3, CFG1):
        for bc in (0, 1, 2):
            for j, schedule in enumerate(("fista", "unacc", "hybrid")):
                for n_iters in (16, 64):
                    res_err = max(res_err, compare_resident_case(
                        shape, bc, schedule, (bc + j) % 2 == 1, n_iters))
                    n_res += 1
    for iso in ((True, False), (False, True), (True, True)):
        for j, schedule in enumerate(("fista", "unacc", "hybrid")):
            res_err = max(res_err, compare_resident_case(
                ODD, 2, schedule, j == 1, 16, iso=iso))
            n_res += 1
    for shape, bc, iso, schedule, with_ref in RAGGED:
        res_err = max(res_err, compare_resident_case(
            shape, bc, schedule, with_ref, 16, iso=iso, grids=(None, 1, 7)))
        n_res += 1
    res_grids = {}
    for shape, schedule, with_ref, iso in (
            (ODD, "hybrid", True, (False, False)),
            (ODD, "fista", False, (True, True)),
            (SHAPE3, "unacc", True, (False, False)),
            (SHAPE3, "fista", False, (False, False))):
        full_r = resident_refuses_oversized_grid(shape, schedule, with_ref,
                                                 iso)
        res_grids[f"{len(shape)}D {schedule}{' ref' if with_ref else ''}"
                  f"{' iso' if any(iso) else ''}"] = full_r
        res_err = max(res_err, compare_resident_case(
            shape, 2, schedule, with_ref, 16, iso=iso, grids=(1, 7, full_r),
            k1=False))
    log(f"phase 2 whole-run kernel vs plain and vs T fused-iteration "
        f"launches: {n_res} cases (T 16 and 64; {ODD}, {SHAPE3}, {CFG1}; BC "
        f"0/1/2; FISTA, unaccelerated and hybrid momentum; with and without "
        f"a reference cube; iso pairs at {ODD}; {len(RAGGED)} tile-edge "
        f"shapes, last extents 1..129 and ND-2 extents 1, 7, 9, each also at "
        f"forced grids of 1 and 7 blocks), state bitwise equal (max "
        f"|Δ| {res_err}), sums within rtol 1e-5; the same state at forced "
        f"grids of 1, 7 and the full grid {res_grids}, a grid one block "
        f"larger refused; {time.perf_counter() - t0:.1f} s")
    res_err = max(res_err, compare_resident_case(CFG1, 2, "unacc", False, 16))
    log(f"phase 2 whole-run kernel at {CFG1} unaccelerated, T = 16, vs 16 "
        f"fused-iteration launches and 16 plain iterations: state bitwise "
        f"equal (max |Δ| {res_err}), sums within rtol 1e-5")
    sweep = {}
    for shape, schedule, with_ref in SWEEP:
        mean, label, raw = time_resident(shape, schedule, with_ref, 400)
        sweep[(shape, schedule, with_ref)] = mean
        mb = resident_state_bytes(shape, schedule == "fista", with_ref) / 1e6
        log(f"phase 2 whole-run sweep {shape} {schedule}"
            f"{' with ref' if with_ref else ''} ({mb:.1f} MB of state): ms per "
            f"iteration whole-run {mean['resident']:.5f}, {label} "
            f"{mean['temporal']:.5f}, fused-iteration "
            f"{mean['k1']:.5f}{' (+ SSE)' if with_ref else ''}; run_solver "
            f"x400 whole-run on {mean['solver_on']:.5f}, off "
            f"{mean['solver_off']:.5f}, K=1 loop {mean['solver_k1']:.5f} ms "
            f"per iteration (runs {raw}) [{smi}]")
    full1 = res_grid(torch.device("cuda"), 3, False, False, False)
    scale = time_resident_grids(CFG1, sorted(
        {g for g in (66, 132, 264, 396, 528) if g < full1} | {full1}))
    floor = time_resident_grids((2, 8, 32), (full1,))
    log(f"phase 2 whole-run kernel at {CFG1} unaccelerated by forced grid "
        f"(blocks: ms per iteration): "
        f"{ {g: round(t, 5) for g, t in scale.items()} }; at (2, 8, 32) "
        f"(one work item per phase, the barriers and the sums alone) "
        f"{floor[full1]:.5f} ms per iteration with {full1} blocks [{smi}]")

    # phase 3: the main path at full size
    rng = np.random.default_rng(SEED)
    cube, scan, det, gen_s = piecewise_4d(CFG4, rng)
    log(f"phase 3 data: {CFG4} float32 ({cube.nbytes / 2**30:.2f} GiB) made "
        f"in {gen_s:.2f} s on the host")
    mu = np.full(4, 1.0, np.float32)
    counts = {}
    for iters in (20, 21):
        torch.cuda.reset_peak_memory_stats()
        want = expected_launches(SolverOptions(
            ndim=4, iterations_fista=iters, iterations_unacc=0), CFG4)
        reset_counts()
        t0 = time.perf_counter()
        recon, b_norm, delta = denoise4D(cube, mu, iterations=iters,
                                         FISTA=True, quiet=True, device="cuda")
        wall = time.perf_counter() - t0
        counts[iters] = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        iterations_run = int(np.count_nonzero(delta))
        require(counts[iters] == want and iterations_run == iters,
                f"x{iters}: (whole-run, K-step, pair, fused-iteration) launches "
                f"{counts[iters]}, expected {want}, iterations_run "
                f"{iterations_run}")
        require(recon.shape == CFG4 and recon.dtype == np.float32, "recon shape")
        require(bool(np.isfinite(recon).all()), "recon not finite")
        require(bool((b_norm > 0).all() and (delta > 0).all()),
                "traces not positive")
        require(peak <= 40.1 * 2**30, f"peak memory {peak / 2**30:.2f} GiB")
        # denoising moves the cube toward the clean signal (first 8 scan rows)
        clean8 = scan[:8, :, None, None] + det[None, None]
        err_in = float(np.abs(cube[:8] - clean8).mean())
        err_out = float(np.abs(recon[:8] - clean8).mean())
        require(err_out < err_in, f"recon error {err_out} !< input {err_in}")
        del recon
        log(f"phase 3 main path: denoise4D {CFG4} FISTA x{iters} wall "
            f"{wall:.3f} s (host copies included); launches: whole-run "
            f"{counts[iters][0]}, K-step kernel {counts[iters][1]}, pair kernel "
            f"{counts[iters][2]}, fused iteration {counts[iters][3]}; "
            f"iterations_run {iterations_run}; peak device memory "
            f"{peak / 2**30:.2f} GiB of {total_mem / 2**30:.1f}; mean "
            f"|recon-clean| {err_out:.4f} < |noisy-clean| {err_in:.4f}")
    # iteration rate on the device alone (no host↔device copies), pairs on
    # and off in turns
    orig = torch.from_numpy(cube).cuda()
    li = torch.full((4,), 32.0, device="cuda")
    lm = torch.full((4,), 1 / 32, device="cuda")
    solve = {True: [], False: []}
    for pairs in (True, False, False, True):
        opts = SolverOptions(ndim=4, iterations_fista=20, iterations_unacc=0,
                             temporal_pairs=pairs)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        run_solver(orig, li, lm, opts)
        torch.cuda.synchronize()
        solve[pairs].append(time.perf_counter() - t1)
    del orig
    torch.cuda.empty_cache()
    n_vox = int(np.prod(CFG4))
    bw = peak_bandwidth(name)
    for pairs, label in ((True, "pairs on"), (False, "pairs off")):
        solve_s = sum(solve[pairs]) / 2
        rate = n_vox * 20 / solve_s
        shares = {m: (model_seconds(CFG4, True, m, bw) * 20 / solve_s
                      if bw else float("nan"))
                  for m in ("pair_floor", "two_pass")}
        log(f"phase 3 rate, {label}: run_solver 20 iterations on the card "
            f"{solve_s:.4f} s (runs {[round(x, 4) for x in solve[pairs]]}) = "
            f"{rate / 1e9:.3f} G voxel-updates/s; of the traffic model at the "
            f"{bw} B/s published peak: {shares['two_pass']:.3f} of the "
            f"two-pass 24 traversals, {shares['pair_floor']:.3f} of the pair "
            f"floor 9.5 [{smi}]")

    # phase 4: 3D paths and a hybrid run against the plain backend
    rng = np.random.default_rng(SEED + 1)
    tiles = ((np.arange(CFG2[0]) // 64)[:, None]
             + (np.arange(CFG2[1]) // 64)[None, :]) % 2
    clean3 = np.empty(CFG2, np.float32)
    clean3[...] = (1.0 + 0.5 * tiles)[:, :, None]
    clean3[:, :, CFG2[2] // 2:] += 1.0   # a step along the energy axis
    # low-dose noise (σ = 2 against steps of 0.5 and 1): the relative change
    # stays above 0.05 for the first few iterations, so the stop check runs
    # on several iterations before it triggers
    noisy3 = clean3 + rng.standard_normal(CFG2, dtype=np.float32) * np.float32(2.0)
    t0 = time.perf_counter()
    _, _, d3, mse3 = denoise3D(noisy3, np.full(3, 1.0, np.float32),
                               iterations=500, FISTA=True,
                               stopping_relative_change=0.05,
                               reference_data=clean3, quiet=True,
                               device="cuda")
    s3 = time.perf_counter() - t0
    n3 = int(np.count_nonzero(d3))
    stopped = n3 < 500
    require(bool(np.all(d3[n3:] == 0)), "3D trace padding")
    require(stopped and n3 >= 4, f"expected an early stop after 4 or more "
                                 f"iterations, got {n3}: {d3[:n3]}")
    require(d3[n3 - 1] < 0.05 and bool(np.all(d3[:n3 - 1] >= 0.05)),
            "early stop inconsistent with the delta trace")
    require(mse3[n3] < mse3[0], f"MSE did not fall: {mse3[0]} -> {mse3[n3]}")
    log(f"phase 4 denoise3D {CFG2} FISTA stop 0.05: {n3} iterations, "
        f"early_stopped {stopped}, delta {[round(float(x), 4) for x in d3[:n3]]}, "
        f"SSE {mse3[0]:.1f} -> {mse3[n3]:.1f}, {s3:.3f} s wall")
    del noisy3, clean3

    cube1 = (np.random.default_rng(SEED + 2).standard_normal(CFG1, dtype=np.float32)
             * np.float32(0.3) + np.float32(2.0))
    mu3 = np.full(3, 1.0, np.float32)
    cfg1 = dict(iterations_fista=0, iterations_unacc=7500)
    want1 = expected_launches(SolverOptions(ndim=3, **cfg1), CFG1)
    k1_depth = _resolve_kstep(SolverOptions(ndim=3, **cfg1), CFG1,
                              torch.float32, False)
    require(k1_depth >= 3, f"config 1 must have a K-step depth: {k1_depth}")
    reset_counts()
    t0 = time.perf_counter()
    r1, b1, d1 = denoise3D(cube1, mu3, quiet=True, device="cuda")
    s1 = time.perf_counter() - t0
    counts1 = launch_counts()
    require(counts1 == want1, f"config 1 (whole-run, K-step, pair, "
                              f"fused-iteration) launches {counts1}, expected "
                              f"{want1}")
    require(bool(np.isfinite(r1).all() and (d1 > 0).all()), "cfg1 result")
    log(f"phase 4 main path: denoise3D {CFG1} unaccelerated, default 7500 "
        f"iterations: launches whole-run {counts1[0]}, K-step {counts1[1]}, "
        f"pair {counts1[2]}, fused iteration {counts1[3]}; {s1:.3f} s wall = "
        f"{int(np.prod(CFG1)) * 7500 / s1 / 1e9:.3f} G voxel-updates/s (host "
        f"copies included) [{smi}]")
    # the same schedule through run_solver on the card: the whole-run
    # kernel, the K-step kernel (whole-run off) and the pairs (both off),
    # in turns
    orig1 = torch.from_numpy(cube1).cuda()
    li3 = torch.full((3,), 16.0, device="cuda")
    lm3 = torch.full((3,), 1 / 16, device="cuda")

    def solve_s(orig, li, lm, **kw):
        opts = SolverOptions(ndim=3, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        run_solver(orig, li, lm, opts)
        torch.cuda.synchronize()
        return time.perf_counter() - t1

    paths1 = {"resident": dict(), "kstep": dict(vmem_resident=False),
              "pairs": dict(vmem_resident=False, temporal_kstep=False)}
    ks1 = {path: [] for path in paths1}
    c1 = {}
    for path in ("resident", "kstep", "pairs", "pairs", "kstep", "resident"):
        # pairs with the row-size rule lifted (config 1's rows are 128 KB)
        with pairs_at_any_row() if path == "pairs" else contextlib.nullcontext():
            reset_counts()
            ks1[path].append(solve_s(orig1, li3, lm3, **cfg1, **paths1[path]))
            c1[path] = launch_counts()
            require(c1[path] == expected_launches(
                SolverOptions(ndim=3, **cfg1, **paths1[path]), CFG1),
                f"config 1 {path} launches {c1[path]}")
    mean1 = {path: sum(v) / 2 for path, v in ks1.items()}
    floor_s = model_seconds(CFG1, False, "kstep_floor", bw, k=k1_depth) * 7500 \
        if bw else float("nan")
    log(f"phase 4 run_solver {CFG1} unaccelerated x7500 on the card: "
        f"whole-run {mean1['resident']:.4f} s (launches {c1['resident']}), "
        f"K-step {mean1['kstep']:.4f} s ({floor_s / mean1['kstep']:.4f} of "
        f"the K={k1_depth} traffic floor of {9 / k1_depth} traversals per "
        f"iteration at {bw} B/s; launches {c1['kstep']}), pairs "
        f"{mean1['pairs']:.4f} s (launches {c1['pairs']}) (runs "
        f"{ {n: [round(x, 4) for x in v] for n, v in ks1.items()} }) [{smi}]")
    # one 7500-iteration whole-run launch, timed on the device
    res_ms = time_ms(lambda: resident_solve(
        orig1, orig1.clone(), [torch.zeros_like(orig1) for _ in range(3)],
        None, None, li3, lm3, n_iters=7500, fista=False, bc=2), 2)
    log(f"phase 4 one whole-run launch {CFG1} unaccelerated x7500: "
        f"{res_ms:.3f} ms = {res_ms / 7500 * 1e3:.3f} us per iteration "
        f"[{smi}]")

    # a stop-aware config 1 run: a K=1 prologue, whole-run chunks behind the
    # guard, the K=1 loop's exact stop; against the plain backend on the
    # card and against the K=1 loop (whole-run off)
    probe = run_solver(orig1, li3, lm3, SolverOptions(
        ndim=3, iterations_fista=0, iterations_unacc=800))
    dp = probe["delta"].cpu().numpy()
    thr = float(dp[:600].min()) * (1 - 1e-4)
    below = np.nonzero(dp[600:] < thr)[0]
    require(below.size > 0, f"no delta after iteration 600 below {thr}")
    stop_at = 600 + int(below[0]) + 1
    require(bool(np.all(np.abs(dp[:stop_at] / thr - 1) > 1e-5)),
            f"a delta lies within rtol 1e-5 of the threshold {thr}")
    stop_runs = {}
    for path, kw in (("chunks", {}), ("k1", dict(vmem_resident=False)),
                     ("torch", dict(backend="torch"))):
        reset_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = run_solver(orig1, li3, lm3, SolverOptions(
            ndim=3, iterations_fista=0, iterations_unacc=800,
            stopping_relative_change=thr, **kw))
        torch.cuda.synchronize()
        stop_runs[path] = (out, time.perf_counter() - t1, launch_counts())
        require(out["iterations_run"] == stop_at and out["early_stopped"],
                f"config 1 stop ({path}) after {out['iterations_run']}, "
                f"expected {stop_at}")
    chunks1 = stop_runs["chunks"][2]
    require(chunks1[0] > 0 and chunks1[1:3] == (0, 0),
            f"the stop run made no whole-run chunk: {chunks1}")
    require(stop_runs["k1"][2][:3] == (0, 0, 0), "the K=1 stop run")
    for path in ("k1", "torch"):
        require(torch.equal(stop_runs["chunks"][0]["recon"],
                            stop_runs[path][0]["recon"]),
                f"config 1 stop run recon != {path}")
    np.testing.assert_allclose(stop_runs["chunks"][0]["delta"].cpu().numpy(),
                               stop_runs["torch"][0]["delta"].cpu().numpy(),
                               rtol=1e-5)
    log(f"phase 4 stop-aware {CFG1} unaccelerated, stop {thr:.6e}: "
        f"all three stop after {stop_at} iterations, recon bitwise equal "
        f"to the K=1 loop and to backend='torch', deltas within rtol 1e-5; "
        f"whole-run chunks (launches whole-run/K-step/pair/fused {chunks1}) "
        f"{stop_runs['chunks'][1]:.4f} s = "
        f"{stop_runs['chunks'][1] / stop_at * 1e3:.4f} ms per iteration; "
        f"K=1 loop {stop_runs['k1'][1]:.4f} s = "
        f"{stop_runs['k1'][1] / stop_at * 1e3:.4f} ms per iteration; plain "
        f"{stop_runs['torch'][1]:.4f} s [{smi}]")
    del probe, stop_runs

    # a hybrid 3D run through the K-step, pair and fused-iteration kernels
    # (whole-run off, pairs at any row size) against the plain backend
    hyb = dict(ndim=3, iterations_fista=9, iterations_unacc=7,
               vmem_resident=False)
    with pairs_at_any_row():
        want_h = expected_launches(SolverOptions(**hyb), CFG1)
        reset_counts()
        got = run_solver(orig1, li3, lm3, SolverOptions(**hyb))
        counts_h = launch_counts()
    require(counts_h == want_h and counts_h[0] == 0 and min(counts_h[1:]) > 0,
            f"hybrid 3D launches {counts_h}, expected {want_h}")
    ref = run_solver(orig1, li3, lm3, SolverOptions(**hyb, backend="torch"))
    require(torch.equal(got["recon"], ref["recon"]),
            "hybrid 3D recon not bitwise equal")
    for key in ("b_norm", "delta"):
        np.testing.assert_allclose(got[key].cpu().numpy(),
                                   ref[key].cpu().numpy(), rtol=1e-5)
    log(f"phase 4 hybrid (9,7) {CFG1} kernels vs backend='torch' on the card: "
        f"recon bitwise equal, traces within rtol 1e-5; launches whole-run "
        f"{counts_h[0]}, K-step {counts_h[1]}, pair {counts_h[2]}, fused "
        f"iteration {counts_h[3]}")
    del orig1, got, ref
    # config 2 FISTA x24: the K-step kernel at K=8, forced, against pairs
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    orig2 = torch.randn(CFG2, generator=gen, device="cuda") * 0.5 + 2.0
    ks2 = {True: [], False: []}
    c2 = {}
    for on in (True, False, False, True):
        kw = dict(iterations_fista=24, iterations_unacc=0)
        kw.update(temporal_k=max(KS)) if on else kw.update(temporal_kstep=False)
        reset_counts()
        ks2[on].append(solve_s(orig2, li3, lm3, **kw))
        c2[on] = launch_counts()
        require(c2[on] == expected_launches(SolverOptions(ndim=3, **kw), CFG2),
                f"config 2 x24 launches {c2[on]}")
    del orig2
    torch.cuda.empty_cache()
    n2 = int(np.prod(CFG2)) * 24
    log(f"phase 4 run_solver {CFG2} FISTA x24 on the card: K-step K={max(KS)} "
        f"(launches whole-run/K-step/pair/fused {c2[True]}) {sum(ks2[True]) / 2:.4f} s = "
        f"{n2 / (sum(ks2[True]) / 2) / 1e9:.3f} G voxel-updates/s; K-step off "
        f"({c2[False]}) {sum(ks2[False]) / 2:.4f} s = "
        f"{n2 / (sum(ks2[False]) / 2) / 1e9:.3f} G (runs on "
        f"{[round(x, 4) for x in ks2[True]]}, off "
        f"{[round(x, 4) for x in ks2[False]]}) [{smi}]")
    for shape, iters in ((CFG1, 2000), (CFG3, 30)):
        t = [solver_ms(shape, iters, None), solver_ms(shape, iters, 1e-30),
             solver_ms(shape, iters, 1e-30), solver_ms(shape, iters, None)]
        log(f"phase 4 stop-check cost at {shape}, unaccelerated, ms per "
            f"iteration without / with stopping_relative_change: "
            f"{(t[0] + t[3]) / 2:.4f} / {(t[1] + t[2]) / 2:.4f} "
            f"(runs {[round(x, 4) for x in t]}) [{smi}]")

    cube3 = (np.random.default_rng(SEED + 3).standard_normal(CFG3, dtype=np.float32)
             * np.float32(0.5) + np.float32(2.0))
    mu4 = np.full(4, 1.0, np.float32)

    def hybrid(stop):
        kw = dict(iterations=(10, 10), stopping_relative_change=stop,
                  quiet=True, device="cuda")
        # pairs at any row size (config 3's rows are 2 MiB), so that the
        # run without a stop switches from FISTA to unaccelerated pairs;
        # stop-aware runs stay on the K=1 loop
        with pairs_at_any_row():
            reset_counts()
            got = denoise4D(cube3, mu4, **kw)
            want = expected_launches(SolverOptions(
                ndim=4, iterations_fista=10, iterations_unacc=10), CFG3)[:3] \
                if stop is None else (0, 0, 0)
        counts = launch_counts()[:3]
        require(counts == want and (stop is not None or counts[2] > 0),
                f"hybrid (stop {stop}): (whole-run, K-step, pair) launches "
                f"{counts}, expected {want} with pairs")
        want = denoise4D(cube3, mu4, backend="torch", **kw)
        require(np.array_equal(got[0], want[0]),
                f"hybrid recon not bitwise equal (stop {stop})")
        np.testing.assert_array_equal(np.nonzero(got[2])[0],
                                      np.nonzero(want[2])[0])
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5)
        np.testing.assert_allclose(got[2], want[2], rtol=1e-5)
        return got[2]

    d = hybrid(None)
    hyb4 = launch_counts()
    require(bool((d > 0).all()), "hybrid trace not positive over 20 entries")
    # a threshold no iteration before the 16th crosses: the second phase,
    # with the accumulators FISTA left, runs at least 6 iterations and stops.
    # It keeps a margin from every delta, as the plain backend's traces
    # differ from the kernel's in the last bits.
    thr = float(d[:15].min()) * (1 - 1e-4)
    require(bool(np.all(np.abs(d[15:] / thr - 1) > 1e-5)),
            f"a delta lies within rtol 1e-5 of the threshold {thr}: {d}")
    below = np.nonzero(d[15:] < thr)[0]
    require(below.size > 0, f"no delta after iteration 15 below {thr}: {d}")
    stop_at = 15 + int(below[0]) + 1
    ds = hybrid(thr)
    n_run = int(np.count_nonzero(ds))
    require(n_run == stop_at and bool(np.all(ds[n_run:] == 0)),
            f"hybrid stop after {n_run} iterations, expected {stop_at}")
    # the two runs' traces may come from different kernels (the full run's
    # from pairs where the engine pairs): their sums differ in the last bits
    np.testing.assert_allclose(ds[:n_run], d[:n_run], rtol=1e-5)
    log(f"phase 4 hybrid (10,10) {CFG3} kernels vs backend='torch' on the "
        f"card: recon bitwise equal, traces within rtol 1e-5, without a stop "
        f"(launches whole-run/K-step/pair/fused {hyb4}, 20 iterations, delta "
        f"{d[0]:.3e} .. "
        f"{d[9]:.3e} | {d[10]:.3e} .. {d[19]:.3e}) and with stop {thr:.6e} (both stop after {n_run} "
        f"iterations, {n_run - 10} of them unaccelerated)")

    # launches: each kernel's count in the run of the path that reaches it
    # (x21: the odd iteration; x20: the pairs; config 1 through run_solver
    # with the whole-run kernel off: the K-step; config 1 through denoise3D:
    # the whole-run kernel); ms at the shape of that run (the whole-run
    # kernel: one 7500-iteration launch; its plain_ms: the plain iteration's
    # ms x 7500); bound_ms: the least time the card could take for one
    # launch of the same work (utils/perf.py)
    f32 = peak_f32(name)
    kd = k1_depth

    def bound(shape, fista, iters):
        if not (bw and f32):
            return None, None
        t, by = launch_bound_seconds(shape, fista, iters, bw, f32)
        return t * 1e3, by

    rows = [
        ("fused_iteration", "fused_iteration.cu", "fused.py:872", counts[21][3],
         max_err, k4, p4, bound(CFG4, True, 1)),
        ("fused_pair_iteration", "temporal_pair.cu", "temporal.py:947",
         counts[20][2], pair_err, times[CFG4]["pair"], times[CFG4]["plain"],
         bound(CFG4, True, 2)),
        ("fused_kstep_iteration", "temporal_kstep.cu", "kstep.py:395",
         c1["kstep"][1], kstep_err, ktimes[CFG1][kd][0],
         ktimes[CFG1]["plain"][0] * kd, bound(CFG1, False, kd)),
        ("resident_solve", "resident.cu", "resident.py:293", counts1[0],
         res_err, res_ms, ktimes[CFG1]["plain"][0] * 7500,
         bound(CFG1, False, 7500)),
    ]
    kernels = [{
        "name": kname,
        "route": "cuda",
        "source": f"cytvdn_tpu_torch/csrc/{src}",
        "replaces": f"cytvdn_tpu/kernels/{tpu}",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        # no single PyTorch call computes a TV iteration
        "library_ms": None,
    } for kname, src, tpu, launches, err, ms, plain_ms, (b_ms, b_by) in rows]
    log(f"total {time.perf_counter() - total_t0:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
