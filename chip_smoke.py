#!/usr/bin/env python3
"""Drive cytvdn_tpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints one line or a few; any failure raises and exits
non-zero — nothing is caught):

0. device: name, ``nvidia-smi`` name and power limit, TF32 off;
1. build: the CUDA kernels from ``cytvdn_tpu_torch/csrc`` with nvcc, one
   process per source, with the build time and each kernel
   instantiation's registers and spills from ptxas, the pair kernel's with
   and without its reference-cube SSE (REF) and their cooperative grids;
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
   card); the pair kernel with a reference cube against two plain
   iterations with their ``ops.sum_square_error`` (state bitwise equal,
   the eight sums within rtol 1e-5) at N0 = 4..7 and ragged shapes, FISTA
   and unaccelerated, at the full grid and at forced grids of 1, 7 and all
   blocks, at (128,128,64,64) and (256,256,2048), and at
   (256,256,128,128) compared off the card; ms per pair there with and
   without the reference cube and of the plain pair with it;
   then ms per pair of the pair kernel, of two fused-iteration
   launches and of the plain pair at (128,128,64,64), (256,256,2048) and
   (256,256,128,128), and each CUDA kernel's device time from
   ``torch.profiler`` at the last; the pair kernel's strip sweep: ms per
   pair at W = 4, 8, 12, 16, 32, 64 and N1 (the whole-row schedule, the
   default), in turns with two fused-iteration launches, at rows of 2 to 16
   MB (STRIP_SWEEP), and ``run_solver`` x48 there (x16 at config 4), at
   (N0,64,2048) for N0 = 128, 192, 1024, at (128,128,64,64) unaccelerated
   and at N0 = 2K with large rows, (16,512,128,128) FISTA and
   (12,1024,2048) unaccelerated, along the engine's pick, K=8, pairs and
   the K=1 loop (the whole-run kernel off); two launches
   of the K-step kernel (K = 3, 4, 6, 8) against its plain version, K
   fused-iteration launches and (K even) K/2 pair launches (state bitwise
   equal, sums within rtol 1e-5) at N0 = 2K and 2K+1 in 3D and 4D and on
   ragged shapes, at forced grids of 1, 7 and all blocks with a grid one
   larger refused, at last extents that are a multiple of 4 (its 128-bit
   walk) and at its tile edges (last extents 1 to 129, ND-2 extents 1, 7
   and 9) at the full grid and at 1 and 7 blocks, at 2 and 3 axis-0 rows
   per stage, and one launch of every K against its plain version at
   (64,64,512), (256,256,2048) and (128,128,64,64) at the default rows per
   stage, with each instantiation's blocks per SM; at (256,256,128,128)
   FISTA one K=8 launch at the defaults and 8 plain iterations, all 9
   arrays bitwise equal and the 24 sums within rtol 1e-5 (compared off the
   card); ms per launch and per iteration of every K (default rows per
   stage), the pair
   kernel, the fused-iteration kernel and the plain iteration at
   (64,64,512) unaccelerated, (256,256,2048), (128,128,64,64) and
   (256,256,128,128) FISTA (the four BASELINE shapes) and (1024,64,2048)
   unaccelerated;
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
   whole-run kernel on and off, off with K=8 forced, and on the K=1 loop,
   at 64×64×N
   unaccelerated (N = 128 .. 4096)
   and at (64,64,512) FISTA and with a reference cube;
3. main path: ``denoise4D`` on a 256×256×128×128 float32 cube (the
   BASELINE config-4 size; its noise drawn on the card), 20 FISTA iterations (2 K=8 launches and 2 pair
   launches, no fused-iteration launch) and 21 (2 + 2 + 1), with the launch
   counts, the peak device memory, and the iteration rate of the engine's
   pick, of pairs alone and of the K=1 loop;
4. 3D paths: ``denoise3D`` at (64,64,512) unaccelerated with the default
   7500 iterations (one whole-run launch), ``run_solver`` there with the
   whole-run kernel, with the K-step kernel (whole-run off) and with pairs
   (the engine's row-size rule for pairs lifted), one 7500-iteration
   whole-run launch timed on the device, a stop-aware run there (whole-run
   chunks) against the K=1 loop and the plain backend, ``run_solver`` at
   (256,256,2048) FISTA with the K-step kernel forced and off, a hybrid 3D
   run through the K-step, pair (rule lifted) and fused-iteration kernels
   and hybrid 4D runs (pairs, rule lifted, without an early stop; K-steps
   and pairs behind the guard with one in the second phase) against the
   plain backend on the card;
5. stop and MSE paths: stop-aware ``run_solver`` at (256,256,2048) FISTA
   with the stop near iteration 100 and at (256,256,128,128) FISTA near 48
   (thresholds from a fixed run's delta trace), the engine's pick (K=8
   launches and pairs behind the guard, one checkpoint per block) against
   the K=1 loop and, at (256,256,2048), the plain backend: the same stop,
   recon bitwise, traces within rtol 1e-5, launches, seconds and (at
   config 4) the peak device memory; a forced guard beat (a recorded
   plateau) at (256,256,2048) for one K=8 launch and one pair, discarded
   bitwise; and a config-4 MSE run (the clean cube as reference), pairs
   with the reference cube against the K=1 loop with
   ``ops.sum_square_error``: recon bitwise, MSE trace within rtol 1e-5;
6. chunked runs: config 4 FISTA x100 in chunks of 25 through the chunk
   loop on the card, ``run_chunked`` and ``denoise4D(progress=True)``
   against the unchunked ``run_solver`` (recon bitwise, launches,
   seconds, peak device memory);
   config 1's 7500 iterations through ``denoise3D(progress=True)`` (41
   whole-run launches) against one launch; config 3 hybrid (20, 12) with a
   checkpoint file every 8 iterations, killed after the second chunk and
   resumed (recon bitwise, the seconds per save, the file size); phase
   5's config-2 stop run in chunks of 25 (the same stop and recon); and the
   device-memory fallback ladder: phase 5's config-4 stop run through the
   API's ``_run`` on a card left with ~60 GiB free, where the block
   checkpoint cannot be allocated, down its three rungs to the K=1 loop
   (the same stop and recon as phase 5's K=1 loop). Outside this last
   run, a ladder warning is an error;
7. one JSON line on the kernels (launches on the path that reaches each,
   error, ms, the plain version's ms and the least time the card could
   take), the card's name and power limit, and the ``{"ok": true, ...}``
   line last.

Needs one CUDA device; exits non-zero without one. Inputs are made from
fixed seeds.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from cytvdn_tpu_torch import api, denoise3D, denoise4D, ops
from cytvdn_tpu_torch.config import SolverOptions
from cytvdn_tpu_torch.kernels import build
from cytvdn_tpu_torch.kernels import resident as resident_mod
from cytvdn_tpu_torch.kernels.fused import fused_iteration, fused_iteration_reference
from cytvdn_tpu_torch.kernels.kstep import (
    KSTEP_CANDIDATES,
    best_kstep,
    fused_kstep_iteration,
    fused_kstep_iteration_reference,
    kstep_rows,
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
from cytvdn_tpu_torch.utils import checkpoint
from cytvdn_tpu_torch.utils.checkpoint import progress_chunk_size, run_chunked
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
# run_solver only: 3D unaccelerated states of 336 MB, 503 MB and 2.7 GB
# with 512 KB rows; 4D unaccelerated (config 3's shape, 1.6 GB); N0 = 2K of
# the depth the gate picks with large rows, where most of a launch's stages
# fill or drain the staircase: 32 MiB rows at K=8 (4D FISTA, 5.4 GB) and
# 8 MiB rows at K=6 (3D unaccelerated, 503 MB)
BIG3 = (1024, 64, 2048)
SOLVER_ONLY = [((128, 64, 2048), False), ((192, 64, 2048), False),
               (BIG3, False), (CFG3, False), ((16, 512, 128, 128), True),
               ((12, 1024, 2048), False)]
KS = tuple(sorted(KSTEP_CANDIDATES))
# the K-step kernel's cases at depth K: ragged edges (its element-by-element
# walk) and last extents that are a multiple of 4 (its 128-bit walk, VEC)
KSTEP_SHAPES = [(2, 9, 10, 33), (3, 9, 10, 33), (2, 13, 70), (3, 13, 70),
                (2, 9, 10, 32), (3, 13, 64), (2, 16, 512)]


def kstep_shape(shape, k):
    """A KSTEP_SHAPES entry at depth k: its leading 2 is N0 = 2K, 3 is
    2K + 1."""
    return (2 * k + shape[0] - 2,) + shape[1:]


def kstep_edge_cases():
    """The K-step kernel's tile edges as (shape, K, fista), also the cases
    of tests/test_torch_cuda.py: last extents around its four-element
    groups and 32-lane segments (1, 4, 5, 128, 129), ND-2 extents around its
    tile rows (1, 7, 9), every depth, N0 = 2K and 2K + 1, FISTA and
    unaccelerated, 3D and 4D."""
    cases = []
    for i, last in enumerate((1, 4, 5, 128, 129)):
        for j, m in enumerate((1, 7, 9)):
            k = KS[(i + j) % len(KS)]
            cases.append(((2 * k + (i + j) % 2, m, last), k,
                          (i + 2 * j) % 2 == 0))
    for i, (m, last) in enumerate(((1, 4), (7, 129), (9, 5), (7, 128))):
        cases.append(((2 * KS[i] + i % 2, 3, m, last), KS[i], i % 2 == 1))
    return cases

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


def offcard_equal(shape, fista, runs):
    """At a state too large to hold twice on the card (Jia-Zhao, float32):
    ``runs`` is a list of (name, fn), fn(orig, state, li, lm, rho) updating
    ``state`` in place and returning its sums. The first run's state is kept
    on the host; each later run starts from the same state rebuilt from the
    seed, and each of its arrays is brought back alone and compared bitwise
    with the host copy, its sums within rtol 1e-5. Returns max |Δstate| and
    the sums' largest relative difference."""
    def run(fn):
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        orig, state, li, lm, rho = random_state(shape, fista, torch.float32,
                                                gen, jz=True)
        sums = fn(orig, state, li, lm, rho)
        return state, sums.double().cpu()

    (first, fn), *rest = runs
    state, want_sums = run(fn)
    host = [x.cpu() for x in state]
    del state
    torch.cuda.empty_cache()
    err, rel = 0.0, 0.0
    for name, fn in rest:
        state, sums = run(fn)
        bitwise = True
        for i, p in enumerate(state):
            k = host[i].cuda()
            err = max(err, (k - p).abs().max().item())
            bitwise = bitwise and torch.equal(k, p)
            del k
        del state
        torch.cuda.empty_cache()
        require(bitwise, f"{name} != {first} at {shape} fista {fista}: "
                         f"max |Δ| {err}")
        rel = max(rel, ((sums - want_sums).abs()
                        / want_sums.abs().clamp_min(1e-300)).max().item())
        require(rel <= 1e-5, f"{name} sums differ by rtol {rel} at {shape}")
    return err, rel


def compare_offcard(shape, fista):
    """Two fused-iteration launches, one pair-kernel launch and two plain
    iterations from the same state, compared off the card
    (``offcard_equal``)."""
    def pair(step):
        return lambda orig, state, li, lm, rho: torch.stack(
            pair_fn(step, orig, state, li, lm, rho, fista)())

    return offcard_equal(shape, fista, [
        ("two fused-iteration launches", pair(two_k1)),
        ("pair kernel", pair(fused_pair_iteration)),
        ("plain", pair(fused_pair_iteration_reference))])


def ref_cube(shape, seed=SEED + 1):
    """A reference cube on the card for the pair kernel's SSE."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=gen, device="cuda") * 0.5 + 2.0


def compare_pair_ref_case(shape, fista, grids=(None,)):
    """Two pairs of the pair kernel with a reference cube (its REF
    instantiation) at each forced grid of ``grids`` (None: the full
    cooperative grid) against its plain version (two plain iterations, each
    followed by ``ops.sum_square_error``) from the same Jia-Zhao state:
    state bitwise equal, the eight sums per pair within rtol 1e-5. Returns
    max |Δstate| and the two SSEs' largest relative difference."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    orig, state, li, lm, rho = random_state(shape, fista, torch.float32, gen,
                                            jz=True)
    ref = ref_cube(shape)

    def run(step):
        s = [x.clone() for x in state]
        fn = pair_fn(step, orig, s, li, lm, rho, fista, ref=ref)
        sums = [torch.stack(fn()).double() for _ in range(2)]
        torch.cuda.synchronize()
        return s, torch.stack(sums).cpu()

    ps, psum = run(fused_pair_iteration_reference)
    require(psum.shape == (2, 8), f"plain pair with ref sums {psum.shape}")
    err, rel_sse = 0.0, 0.0
    for g in grids:
        ks, ksum = run(lambda *a, g=g, **k: fused_pair_iteration(*a, grid=g,
                                                                 **k))
        err = max(err, max((a - b).abs().max().item() for a, b in zip(ks, ps)))
        require(all(torch.equal(a, b) for a, b in zip(ks, ps)),
                f"pair kernel with ref, grid {g}: state differs from the "
                f"plain pair at {shape} fista {fista}: max |Δ| {err}")
        rel = (ksum - psum).abs() / psum.abs().clamp_min(1e-300)
        require(rel.max().item() <= 1e-5,
                f"pair kernel with ref, grid {g}: sums differ by rtol "
                f"{rel.max().item()} at {shape}")
        rel_sse = max(rel_sse, rel[:, 6:].max().item())
    del orig, state, ref
    torch.cuda.empty_cache()
    return err, rel_sse


def compare_offcard_ref(shape):
    """One pair-kernel launch with a reference cube and two plain
    iterations with their ``ops.sum_square_error``, FISTA, from the same
    state, compared off the card (``offcard_equal``)."""
    def pair(step):
        def fn(orig, state, li, lm, rho):
            ref = ref_cube(shape)
            return torch.stack(pair_fn(step, orig, state, li, lm, rho, True,
                                       ref=ref)())
        return fn

    return offcard_equal(shape, True, [
        ("pair kernel with ref", pair(fused_pair_iteration)),
        ("plain with ref", pair(fused_pair_iteration_reference))])


def time_pair_ref(shape, n_kernel, n_plain):
    """ms per pair of FISTA float32 iterations on one Jia-Zhao state, in
    turns: the pair kernel without and with a reference cube (its REF
    instantiation) and the plain pair with it. Returns the means
    {"pair", "pair_ref", "plain_ref"} and the runs."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    orig, state, li, lm, rho = random_state(shape, True, torch.float32, gen,
                                            jz=True)
    ref = ref_cube(shape)
    fns = {"pair": pair_fn(fused_pair_iteration, orig, state, li, lm, rho,
                           True),
           "pair_ref": pair_fn(fused_pair_iteration, orig, state, li, lm, rho,
                               True, ref=ref),
           "plain_ref": pair_fn(fused_pair_iteration_reference, orig, state,
                                li, lm, rho, True, ref=ref)}
    order = ("plain_ref", "pair", "pair_ref", "pair_ref", "pair", "plain_ref")
    runs = [(name, time_ms(fns[name],
                           n_plain if name == "plain_ref" else n_kernel))
            for name in order]
    del orig, state, ref, fns
    torch.cuda.empty_cache()
    mean = {name: sum(t for n, t in runs if n == name) / 2
            for name in ("pair", "pair_ref", "plain_ref")}
    return mean, [(n, round(t, 3)) for n, t in runs]


def compare_kstep_offcard(shape, fista, k):
    """One K-step launch of depth ``k`` at the wrapper's defaults (the full
    cooperative grid, ``kstep_rows`` rows per stage) and ``k`` plain
    iterations from the same state, with distinct momentum ratios, compared
    off the card (``offcard_equal``): every array bitwise, the 3k sums
    within rtol 1e-5."""
    rhos = torch.linspace(0.0, 0.6, k, device="cuda")

    def kstep(step):
        return lambda orig, state, li, lm, _: kstep_fn(
            step, orig, state, li, lm, rhos, k, fista)()

    return offcard_equal(shape, fista, [
        ("K-step kernel", kstep(fused_kstep_iteration)),
        ("plain", kstep(fused_kstep_iteration_reference))])


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
                       plain_only=False, rows=None):
    """``launches`` launches of the K-step kernel of depth ``k`` (at each
    forced grid of ``grids``, None the full cooperative grid; at ``rows``
    axis-0 rows per stage, None the wrapper's default) against
    its plain version and, unless ``plain_only``, K fused-iteration
    launches and (K even) K/2 pair launches per launch, from the same
    Jia-Zhao state with distinct momentum ratios: state bitwise equal, sums
    within rtol 1e-5. Returns max |Δstate|."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    orig, state, li, lm, _ = random_state(shape, fista, torch.float32, gen,
                                          jz=True)
    rhos = torch.linspace(0.0, 0.6, launches * k, device="cuda")
    steps = [lambda *a, g=g, **kw: fused_kstep_iteration(
        *a, grid=g, rows_per_stage=rows, **kw)
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
    next pick), off with the K-step kernel forced to K=8, and on the K=1
    loop (host clock, the size rule lifted, after a short warm-up run of
    each), in turns on, off, K=8, K=1, K=1, K=8, off, on; every path's
    recon must equal the K=1 loop's bitwise.
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
    # K=8 forced, and the K=1 loop
    paths = {"on": dict(), "off": dict(vmem_resident=False),
             "k8": dict(vmem_resident=False, temporal_k=8),
             "k1": dict(vmem_resident=False, temporal_kstep=False,
                        temporal_pairs=False)}
    saved = resident_mod.RESIDENT_BYTES
    resident_mod.RESIDENT_BYTES = 1 << 62
    recon = {}
    try:
        for kw in paths.values():  # warm-up: the allocator's first blocks
            run_solver(orig, li, lm, SolverOptions(
                ndim=ndim, iterations_fista=16 if fista else 0,
                iterations_unacc=0 if fista else 16, calculate_mse=with_ref,
                **kw), ref)
        for path in ("on", "off", "k8", "k1", "k1", "k8", "off", "on"):
            opts = SolverOptions(ndim=ndim, iterations_fista=n_iters if fista
                                 else 0, iterations_unacc=0 if fista
                                 else n_iters, calculate_mse=with_ref,
                                 **paths[path])
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run_solver(orig, li, lm, opts, ref)
            torch.cuda.synchronize()
            runs.append((f"solver_{path}",
                         (time.perf_counter() - t0) * 1e3 / n_iters))
            require(launch_counts() == expected_launches(opts, shape),
                    f"sweep {shape}: launches {launch_counts()}")
            recon.setdefault(path, out["recon"])
            del out
    finally:
        resident_mod.RESIDENT_BYTES = saved
    # dispatch changes no result: every path's recon is the K=1 loop's
    require(all(torch.equal(r, recon["k1"]) for r in recon.values()),
            f"sweep {shape}: run_solver recon differs between paths")
    del recon
    del orig, state, accs, ds, ref
    torch.cuda.empty_cache()
    mean = {name: sum(t for n, t in runs if n == name) / 2
            for name in ("resident", "temporal", "k1", "solver_on",
                         "solver_off", "solver_k8", "solver_k1")}
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
    each, whose recon must equal the K=1 loop's bitwise; with the launches
    of each. Returns ({path: mean ms}, {path: launches}, the raw runs)."""
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
    launches, runs, recon = {}, [], {}
    for name in [*paths, *reversed(paths)]:
        opts = SolverOptions(**base, **paths[name])
        with pairs_at_any_row() if name == "pairs" else contextlib.nullcontext():
            if name not in launches:
                recon[name] = run_solver(orig, li, lm, opts)["recon"]
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_solver(orig, li, lm, opts)
            torch.cuda.synchronize()
            runs.append((name, (time.perf_counter() - t0) * 1e3 / iters))
            launches[name] = launch_counts()
            require(launches[name] == expected_launches(opts, shape),
                    f"{shape} {name}: launches {launches[name]}")
    # dispatch changes no result: every path's recon is the K=1 loop's
    require(all(torch.equal(r, recon["k1"]) for r in recon.values()),
            f"{shape}: run_solver recon differs between paths")
    del orig, recon
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


def stop_threshold(delta, target):
    """A stop threshold from a fixed run's delta trace that stops a run as
    near ``target`` iterations as the trace allows: a delta below every
    earlier one ends the run, with the threshold the geometric mean of it
    and the least delta before it, more than rtol 1e-5 from every delta up
    to the stop (so that traces from different kernels, their sums in
    another order, stop at the same iteration). Returns the threshold and
    the iterations the stop-aware run makes."""
    dp = delta.cpu().numpy().astype(np.float64)
    best = None
    for j in range(2, dp.size):
        low = dp[:j].min()
        if not 0 < dp[j] < low:
            continue
        thr = float(np.sqrt(dp[j] * low))
        if not np.all(np.abs(dp[:j + 1] / thr - 1) > 1e-5):
            continue
        if best is None or abs(j + 1 - target) < abs(best[1] - target):
            best = (thr, j + 1)
    require(best is not None, f"no delta of {dp.size} below all earlier "
                              f"ones with a margin of rtol 1e-5")
    return best


def timed_run(fn):
    """``fn()`` with the launch counts set to 0 just before it and read just
    after: returns (its result, seconds, launches, peak device memory)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return out, secs, launch_counts(), torch.cuda.max_memory_allocated()


def counted_run(orig, li, lm, opts, ref=None):
    """One ``run_solver`` run through :func:`timed_run`: returns (its
    outputs with the tensors brought to the host, seconds, launches, peak
    bytes)."""
    out, secs, launches, peak = timed_run(
        lambda: run_solver(orig, li, lm, opts, reference_data=ref))
    host = {k: v.cpu() if torch.is_tensor(v) else v for k, v in out.items()}
    del out
    torch.cuda.empty_cache()
    return host, secs, launches, peak


def forced_guard_beat(orig, li, lm, phase):
    """A stop-aware K=8 (``phase`` "kstep") or pair phase on a
    ``_PhaseState`` whose recorded deltas plateau at 1 (the guard predicts
    1 >= 0.5 and lets the launch run) while the real ones fall far below
    0.5: the launch's first delta beats the guard, and the block must be
    discarded, leaving state, traces, index and latch bitwise as before.
    Returns the launches made."""
    n, ndim = 64, orig.dim()
    delta = torch.zeros(n, device="cuda")
    delta[:2] = 1.0
    st = engine._PhaseState(
        i=2, done=False, recon=orig.clone(),
        accs=[torch.zeros_like(orig) for _ in range(ndim)],
        ds=[torch.zeros_like(orig) for _ in range(ndim)],
        b_norm=torch.zeros(n, device="cuda"), delta=delta, mse=None,
        tk=torch.ones((), device="cuda"))
    arrays = [st.recon, *st.accs, *st.ds, st.b_norm, st.delta]
    before = [x.clone() for x in arrays]
    opts = SolverOptions(ndim=ndim, iterations_fista=n, iterations_unacc=0,
                         stopping_relative_change=0.5)
    rhos = torch.as_tensor(engine.fista_tk_ratios(n),
                           dtype=torch.float32).cuda()
    reset_counts()
    if phase == "kstep":
        engine._run_phase_kstep(True, n, st, orig, rhos, li, lm, opts, None,
                                max(KS))
    else:
        engine._run_phase_paired(True, n, st, orig, rhos, li, lm, opts, None)
    launches = launch_counts()
    require(launches == ((0, 1, 0, 0) if phase == "kstep" else (0, 0, 1, 0)),
            f"forced guard beat ({phase}): launches {launches}")
    require(st.i == 2 and not st.done,
            f"forced guard beat ({phase}): i {st.i}, done {st.done}")
    require(all(torch.equal(a, b) for a, b in zip(arrays, before)),
            f"forced guard beat ({phase}): the block was not discarded "
            f"bitwise")
    del st, arrays, before
    torch.cuda.empty_cache()
    return launches


def same_result(runs, want, what, keys=("b_norm", "delta")):
    """Each of ``runs`` (``counted_run`` results) stops as ``want`` does,
    with its recon bitwise equal and its ``keys`` traces within rtol
    1e-5."""
    for out, _, _, _ in runs:
        require(out["iterations_run"] == want["iterations_run"]
                and out["early_stopped"] == want["early_stopped"],
                f"{what}: {out['iterations_run']} iterations, expected "
                f"{want['iterations_run']}")
        require(torch.equal(out["recon"], want["recon"]),
                f"{what}: recon not bitwise equal")
        for key in keys:
            np.testing.assert_allclose(out[key].numpy(), want[key].numpy(),
                                       rtol=1e-5, err_msg=f"{what} {key}")


def cfg2_cube():
    """Config 2's random cube on the card, from the fixed seed."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    return torch.randn(CFG2, generator=gen, device="cuda") * 0.5 + 2.0


def stop_phase(smi, cube, scan, det):
    """Phase 5: stop-aware runs through the K-step and pair kernels and
    MSE runs through the pair kernel's SSE, against the K=1 loop (and at
    config 2 the plain backend). Returns the MSE pair launches of the
    config-4 MSE run, the stop runs' launches, and for phase 6 the config-2
    stop run's options and the engine's pick (its outputs on the host) and
    the config-4 stop run's options and its K=1 loop's outputs."""
    t_phase = time.perf_counter()
    orig2 = cfg2_cube()
    li3 = torch.full((3,), 16.0, device="cuda")
    lm3 = torch.full((3,), 1 / 16, device="cuda")
    n2 = 130
    fixed = run_solver(orig2, li3, lm3, SolverOptions(
        ndim=3, iterations_fista=n2, iterations_unacc=0, temporal_pairs=False))
    thr2, stop2 = stop_threshold(fixed["delta"], 100)
    del fixed
    base2 = dict(ndim=3, iterations_fista=n2, iterations_unacc=0,
                 stopping_relative_change=thr2)
    paths2 = {"pick": {}, "k1": dict(temporal_pairs=False),
              "torch": dict(backend="torch")}
    runs2 = {path: [] for path in paths2}
    for path in ("pick", "k1", "torch", "k1", "pick"):
        runs2[path].append(counted_run(orig2, li3, lm3, SolverOptions(
            **base2, **paths2[path])))
    want2 = runs2["k1"][0][0]
    require(want2["iterations_run"] == stop2 and want2["early_stopped"],
            f"config 2 stop after {want2['iterations_run']}, expected {stop2}")
    for path, runs in runs2.items():
        same_result(runs, want2, f"config 2 stop ({path})")
    l2 = {path: runs[0][2] for path, runs in runs2.items()}
    require(l2["pick"][0] == 0 and l2["pick"][1] > 0,
            f"config 2 stop: the engine's pick made no K-step launch: "
            f"{l2['pick']}")
    require(l2["k1"][:3] == (0, 0, 0) and l2["torch"] == (0, 0, 0, 0),
            f"config 2 stop: K=1 loop {l2['k1']}, plain {l2['torch']}")
    s2 = {path: [round(r[1], 4) for r in runs] for path, runs in runs2.items()}
    m2 = {path: sum(v) / len(v) for path, v in s2.items()}
    log(f"phase 5 stop-aware {CFG2} FISTA x{n2}, stop {thr2:.6e}: all paths "
        f"stop after {stop2} iterations, recon "
        f"bitwise equal to the K=1 loop's, traces within rtol 1e-5; launches "
        f"whole-run/K-step/pair/fused: the engine's pick {l2['pick']}, K=1 "
        f"loop {l2['k1']}; seconds: pick {m2['pick']:.4f} "
        f"({m2['pick'] / stop2 * 1e3:.4f} ms per iteration), K=1 loop "
        f"{m2['k1']:.4f} ({m2['k1'] / stop2 * 1e3:.4f}), plain "
        f"{m2['torch']:.4f} (runs {s2}) [{smi}]")
    pick2 = runs2["pick"][0][0]
    del runs2
    beats = {phase: forced_guard_beat(orig2, li3, lm3, phase)
             for phase in ("kstep", "pair")}
    log(f"phase 5 forced guard beat at {CFG2} FISTA (recorded deltas 1, 1; "
        f"stop 0.5): one K={max(KS)} launch {beats['kstep']} and one pair "
        f"{beats['pair']} ran and were discarded, recon, accumulators, "
        f"shadow duals, traces, index and latch bitwise as before")
    del orig2
    torch.cuda.empty_cache()

    # config 4, the stop near iteration 48
    orig4 = torch.from_numpy(cube).cuda()
    li4 = torch.full((4,), 32.0, device="cuda")
    lm4 = torch.full((4,), 1 / 32, device="cuda")
    n4 = 64
    fixed = run_solver(orig4, li4, lm4, SolverOptions(
        ndim=4, iterations_fista=n4, iterations_unacc=0))
    thr4, stop4 = stop_threshold(fixed["delta"], 48)
    trace4 = [float(f"{x:.4g}") for x in fixed["delta"].tolist()]
    del fixed
    torch.cuda.empty_cache()
    base4 = dict(ndim=4, iterations_fista=n4, iterations_unacc=0,
                 stopping_relative_change=thr4)
    need4 = engine.stop_ckpt_bytes(SolverOptions(**base4), CFG4,
                                   torch.float32)
    fits4 = need4 <= engine.STOP_CKPT_MAX_BYTES
    runs4 = {path: counted_run(orig4, li4, lm4, SolverOptions(**base4, **kw))
             for path, kw in (("pick", {}), ("k1", dict(temporal_pairs=False)))}
    want4 = runs4["k1"][0]
    require(want4["iterations_run"] == stop4 and want4["early_stopped"],
            f"config 4 stop after {want4['iterations_run']}, expected {stop4}")
    same_result([runs4["pick"]], want4, "config 4 stop")
    l4 = {path: r[2] for path, r in runs4.items()}
    require((l4["pick"][1] > 0) == fits4 and l4["k1"][:3] == (0, 0, 0),
            f"config 4 stop launches {l4} (byte rule admits it: {fits4})")
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"phase 5 stop-aware {CFG4} FISTA x{n4}, stop {thr4:.6e}: both stop "
        f"after {stop4} iterations, recon bitwise equal, traces within rtol "
        f"1e-5; state + checkpoint {need4 / 2**30:.2f} GiB "
        f"({'within' if fits4 else 'above'} STOP_CKPT_MAX_BYTES "
        f"{engine.STOP_CKPT_MAX_BYTES / 2**30:.2f} GiB); launches "
        f"whole-run/K-step/pair/fused: the engine's pick {l4['pick']}, K=1 "
        f"loop {l4['k1']}; seconds: pick {runs4['pick'][1]:.4f} "
        f"({runs4['pick'][1] / stop4 * 1e3:.3f} ms per iteration), K=1 loop "
        f"{runs4['k1'][1]:.4f} ({runs4['k1'][1] / stop4 * 1e3:.3f}); peak "
        f"device memory: pick {runs4['pick'][3] / 2**30:.3f} GiB, K=1 loop "
        f"{runs4['k1'][3] / 2**30:.3f} GiB of {total / 2**30:.3f}; the fixed "
        f"run's delta trace {trace4} [{smi}]")
    del runs4

    # config 4 with a reference cube (the clean signal): the MSE run in
    # pairs (the K-step gate refuses MSE) against the K=1 loop
    ref4 = (torch.from_numpy(scan).cuda()[:, :, None, None]
            + torch.from_numpy(det).cuda()[None, None]).contiguous()
    base_m = dict(ndim=4, iterations_fista=20, iterations_unacc=0,
                  calculate_mse=True)
    runs_m = {"pairs": [], "k1": []}
    for path in ("pairs", "k1", "k1", "pairs"):
        kw = {} if path == "pairs" else dict(temporal_pairs=False)
        runs_m[path].append(counted_run(orig4, li4, lm4,
                                        SolverOptions(**base_m, **kw),
                                        ref=ref4))
    want_m = runs_m["k1"][0][0]
    require(want_m["iterations_run"] == 20, "config 4 MSE run length")
    for path, runs in runs_m.items():
        same_result(runs, want_m, f"config 4 MSE ({path})",
                    keys=("b_norm", "delta", "mse"))
    lm_ = {path: runs[0][2] for path, runs in runs_m.items()}
    require(lm_["pairs"] == (0, 0, 10, 0) and lm_["k1"] == (0, 0, 0, 20),
            f"config 4 MSE launches {lm_}")
    mse = want_m["mse"].numpy()
    require(bool(np.all(mse > 0)) and mse[-1] < mse[0],
            f"config 4 MSE did not fall: {mse[0]} -> {mse[-1]}")
    sm = {path: [round(r[1], 4) for r in runs] for path, runs in runs_m.items()}
    mm = {path: sum(v) / len(v) for path, v in sm.items()}
    log(f"phase 5 MSE {CFG4} FISTA x20 with the clean cube as reference: "
        f"pairs with the reference cube (launches {lm_['pairs']}) and the K=1 "
        f"loop with ops.sum_square_error ({lm_['k1']}): recon bitwise equal, "
        f"MSE trace within rtol 1e-5 (SSE {mse[0]:.4e} -> {mse[-1]:.4e}); "
        f"seconds: pairs {mm['pairs']:.4f} ({mm['pairs'] / 20 * 1e3:.3f} ms "
        f"per iteration), K=1 loop {mm['k1']:.4f} "
        f"({mm['k1'] / 20 * 1e3:.3f}); peak device memory pairs "
        f"{runs_m['pairs'][0][3] / 2**30:.3f} GiB, K=1 loop "
        f"{runs_m['k1'][0][3] / 2**30:.3f} GiB (runs {sm}); phase "
        f"{time.perf_counter() - t_phase:.1f} s [{smi}]")
    del orig4, ref4, runs_m
    torch.cuda.empty_cache()
    return {"mse_pairs": lm_["pairs"][2], "stop2": l2["pick"],
            "stop4": l4["pick"], "cfg2": (base2, pick2),
            "cfg4": (base4, want4)}


class Killed(Exception):
    """Raised by phase 6's progress callback: the run is killed there."""


def quietly(fn):
    """``fn()`` with its standard output (a progress run's lines) captured:
    returns its result and the lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue().splitlines()


def scalars_np(ndim):
    """``denoise*``'s default clip radii and ratios for mu = 1, as numpy."""
    div = 32.0 if ndim == 4 else 16.0
    return (np.full(ndim, div, np.float32),
            np.full(ndim, 1 / div, np.float32))


def chunk_phase(smi, cube, cube1, r1, cube3, stop5):
    """Phase 6: chunked runs (``progress=True``, ``run_chunked``), a run
    killed and resumed from its checkpoint file, a chunked stop run, and
    the device-memory fallback ladder forced by a filled card."""
    GiB = 2**30
    mu4 = np.full(4, 1.0, np.float32)
    li4, lm4 = scalars_np(4)
    to4 = [torch.from_numpy(x).cuda() for x in (li4, lm4)]

    # (a) config 4 x100 in memory: progress chunks of 25 and run_chunked
    # with checkpoint_every=25 against the unchunked run_solver
    t_a = time.perf_counter()
    n_a, every_a = 100, 25
    require(progress_chunk_size(n_a) == every_a, "config 4 progress chunk")
    opts_a = SolverOptions(ndim=4, iterations_fista=n_a, iterations_unacc=0)
    orig4 = torch.from_numpy(cube).cuda()
    out, s_un, l_un, p_un = timed_run(lambda: run_solver(orig4, *to4, opts_a))
    want_a = out["recon"].cpu().numpy()
    del out

    def run_chunk(state, i_stop):
        return run_solver(orig4, *to4, opts_a, state=state, i_stop=i_stop,
                          keep_state=True)

    # the chunk loop alone, on the cube already on the card: what chunking
    # costs
    dev, s_dev, l_dev, p_dev = timed_run(lambda: checkpoint.chunk_driver(
        run_chunk, n_a, None, every_a, False, {}, CFG4))
    require(np.array_equal(dev["recon"].cpu().numpy(), want_a),
            "config 4 chunk loop recon not bitwise the unchunked run's")
    del dev, orig4
    (prog, lines_a), s_pr, l_pr, p_pr = timed_run(lambda: quietly(
        lambda: denoise4D(cube, mu4, iterations=n_a, FISTA=True, quiet=True,
                          progress=True, device="cuda")))
    ck_a, s_ck, l_ck, p_ck = timed_run(lambda: run_chunked(
        cube, li4, lm4, opts_a, None, every_a, device="cuda"))
    per_chunk = expected_launches(SolverOptions(
        ndim=4, iterations_fista=every_a, iterations_unacc=0), CFG4)
    want_l = tuple(x * (n_a // every_a) for x in per_chunk)
    require(l_un == expected_launches(opts_a, CFG4),
            f"config 4 x{n_a} unchunked launches {l_un}")
    require(l_pr == want_l and l_ck == want_l and l_dev == want_l,
            f"config 4 x{n_a} chunked launches {l_pr}, {l_ck}, {l_dev}, "
            f"expected {want_l}")
    require(np.array_equal(prog[0], want_a) and np.array_equal(ck_a["recon"],
                                                               want_a),
            "config 4 chunked recon not bitwise the unchunked run's")
    require(ck_a["iterations_run"] == n_a,
            f"config 4 chunked: {ck_a['iterations_run']} iterations")
    require(max(p_pr, p_ck, p_dev) <= p_un + 2**26,
            f"config 4 chunked peak {p_dev / GiB:.3f} / {p_ck / GiB:.3f} / "
            f"{p_pr / GiB:.3f} GiB above the unchunked {p_un / GiB:.3f}")
    del prog, ck_a, want_a
    log(f"phase 6 (a) {CFG4} FISTA x{n_a} in chunks of {every_a}: recon "
        f"bitwise equal to the unchunked run; launches whole-run/K-step/"
        f"pair/fused: unchunked run_solver {l_un}, the chunk loop on the "
        f"card {l_dev}, run_chunked {l_ck}, denoise4D(progress=True) "
        f"{l_pr}; seconds: run_solver {s_un:.4f} ({s_un / n_a * 1e3:.3f} ms "
        f"per iteration), the chunk loop on the card {s_dev:.4f} "
        f"({(s_dev / s_un - 1) * 100:+.2f}%), run_chunked on the host cube "
        f"{s_ck:.4f}, denoise4D(progress=True) {s_pr:.4f} (host copies "
        f"included in both); peak device memory {p_un / GiB:.3f} / "
        f"{p_dev / GiB:.3f} / {p_ck / GiB:.3f} / {p_pr / GiB:.3f} GiB; "
        f"{len(lines_a)} progress lines on stdout {lines_a[-1:]}; "
        f"{time.perf_counter() - t_a:.1f} s [{smi}]")

    # (b) config 1, denoise3D's default 7500 iterations: whole-run chunks
    t_b = time.perf_counter()
    mu3 = np.full(3, 1.0, np.float32)
    every_b = progress_chunk_size(7500)
    n_chunks = -(-7500 // every_b)
    runs_b = {"one": [], "progress": []}
    for path in ("one", "progress", "progress", "one"):
        (res, lines_b), secs, launches, _ = timed_run(lambda: quietly(
            lambda: denoise3D(cube1, mu3, quiet=True, device="cuda",
                              progress=path == "progress")))
        require(np.array_equal(res[0], r1),
                f"config 1 ({path}) recon not bitwise phase 4's")
        require(launches == ((n_chunks, 0, 0, 0) if path == "progress"
                             else (1, 0, 0, 0)),
                f"config 1 ({path}) launches {launches}")
        runs_b[path].append(secs)
    m_b = {k: sum(v) / len(v) for k, v in runs_b.items()}
    log(f"phase 6 (b) denoise3D {CFG1} unaccelerated x7500, progress=True: "
        f"{n_chunks} whole-run launches of <= {every_b} iterations against "
        f"one, recon bitwise equal to phase 4's; seconds (host copies "
        f"included): one launch {m_b['one']:.4f}, progress "
        f"{m_b['progress']:.4f} ({(m_b['progress'] / m_b['one'] - 1) * 100:+.1f}%; "
        f"runs { {k: [round(x, 4) for x in v] for k, v in runs_b.items()} }); "
        f"{time.perf_counter() - t_b:.1f} s [{smi}]")

    # (c) config 3, hybrid (20, 12), a checkpoint every 8 iterations on
    # disk: killed after the second chunk, resumed
    t_c = time.perf_counter()
    opts_c = SolverOptions(ndim=4, iterations_fista=20, iterations_unacc=12)
    orig3 = torch.from_numpy(cube3).cuda()
    out = run_solver(orig3, *to4, opts_c)
    want_c = {k: out[k].cpu().numpy() for k in ("recon", "delta")}
    want_i = out["iterations_run"]
    del out, orig3
    tmp = tempfile.mkdtemp(prefix="cytv_ckpt_")
    saves = []
    real_save = checkpoint.save_state

    def timed_save(*a, **k):
        t0 = time.perf_counter()
        real_save(*a, **k)
        saves.append(time.perf_counter() - t0)

    def killer(done, total, delta):
        if done >= 16:
            raise Killed(done)

    try:
        free = shutil.disk_usage(tmp).free
        path = os.path.join(tmp, "config3.npz")
        checkpoint.save_state = timed_save
        try:
            run_chunked(cube3, li4, lm4, opts_c, path, 8, progress=killer,
                        device="cuda")
            require(False, "the progress callback did not kill the run")
        except Killed:
            pass
        state, _ = checkpoint.load_state(path)
        require(int(state["i"]) == 16 and len(state["ds"]) == 4,
                f"killed run's checkpoint at i = {int(state['i'])}")
        del state
        size = os.path.getsize(path)
        got_c, s_res, l_res, _ = timed_run(lambda: run_chunked(
            cube3, li4, lm4, opts_c, path, 8, resume=True, device="cuda"))
    finally:
        checkpoint.save_state = real_save
        shutil.rmtree(tmp, ignore_errors=True)
    require(got_c["iterations_run"] == want_i == 32,
            f"config 3 resumed run: {got_c['iterations_run']} iterations, "
            f"expected {want_i}")
    require(np.array_equal(got_c["recon"], want_c["recon"]),
            "config 3 resumed recon not bitwise the uninterrupted run's")
    np.testing.assert_allclose(got_c["delta"], want_c["delta"], rtol=1e-4)
    require(len(saves) == 4, f"config 3: {len(saves)} saves, expected 4")
    log(f"phase 6 (c) {CFG3} hybrid (20, 12), a checkpoint every 8 "
        f"iterations, killed after the second chunk and resumed: recon "
        f"bitwise equal to the uninterrupted run, both {want_i} iterations; "
        f"file {size / 1e9:.3f} GB, seconds per save "
        f"{[round(x, 3) for x in saves]} (mean "
        f"{sum(saves) / len(saves):.3f}, {size / 1e9 / (sum(saves) / len(saves)):.2f} "
        f"GB/s); free disk beforehand {free / 1e9:.1f} GB; the resumed run "
        f"{s_res:.3f} s, launches whole-run/K-step/pair/fused {l_res}; "
        f"{time.perf_counter() - t_c:.1f} s [{smi}]")

    # (d) config 2's stop run of phase 5 in chunks of 25, in memory
    t_d = time.perf_counter()
    base2, pick2 = stop5["cfg2"]
    li3, lm3 = scalars_np(3)
    cube2 = cfg2_cube().cpu().numpy()
    got_d, s_d, l_d, _ = timed_run(lambda: run_chunked(
        cube2, li3, lm3, SolverOptions(**base2), None, 25, device="cuda"))
    del cube2
    require(got_d["iterations_run"] == pick2["iterations_run"],
            f"config 2 chunked stop after {got_d['iterations_run']}, phase "
            f"5's pick after {pick2['iterations_run']}")
    require(np.array_equal(got_d["recon"], pick2["recon"].numpy()),
            "config 2 chunked stop recon not bitwise phase 5's pick")
    np.testing.assert_allclose(got_d["delta"], pick2["delta"].numpy(),
                               rtol=1e-4)
    log(f"phase 6 (d) {CFG2} FISTA stop {base2['stopping_relative_change']:.6e} "
        f"in chunks of 25: stops after {got_d['iterations_run']} iterations "
        f"as phase 5's pick, recon bitwise equal; launches "
        f"whole-run/K-step/pair/fused {l_d} (phase 5's pick "
        f"{stop5['stop2']}); {s_d:.4f} s (host copies included); "
        f"{time.perf_counter() - t_d:.1f} s [{smi}]")

    # (e) the ladder: config 4's stop run through the API's _run on a card
    # with ~60 GiB free, where the block checkpoint (36 GiB beside the 40 GiB
    # state) cannot be allocated
    t_e = time.perf_counter()
    base4, want4 = stop5["cfg4"]
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    fill = free - 60 * GiB
    filler = torch.empty(fill, dtype=torch.uint8, device="cuda")
    free_e = torch.cuda.mem_get_info()[0]
    starts = []
    real_run = api.run_solver

    def recording(*a, **k):
        torch.cuda.synchronize()
        starts.append((torch.cuda.memory_allocated(), time.perf_counter()))
        return real_run(*a, **k)

    api.run_solver = recording
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            out, s_e, l_e, p_e = timed_run(lambda: api._run(
                cube, li4, lm4, SolverOptions(**base4), None, "cuda"))
        t_end = time.perf_counter()
    finally:
        api.run_solver = real_run
        del filler
    msgs = [str(w.message) for w in rec
            if "device memory exhausted" in str(w.message)]
    rungs = [m.split("retrying with ")[1].split("=")[0] for m in msgs]
    require(rungs == ["vmem_resident", "temporal_kstep", "temporal_pairs"],
            f"ladder rungs {rungs}")
    require(len(starts) == 4 and len({m for m, _ in starts}) == 1,
            f"ladder attempts started at {[m for m, _ in starts]} bytes")
    require(out["iterations_run"] == want4["iterations_run"]
            and out["early_stopped"],
            f"ladder run stopped after {out['iterations_run']}, the K=1 "
            f"loop after {want4['iterations_run']}")
    require(torch.equal(out["recon"].cpu(), want4["recon"]),
            "ladder run recon not bitwise the K=1 loop's")
    t_starts = [t for _, t in starts] + [t_end]
    attempt_s = [round(b - a, 3) for a, b in zip(t_starts, t_starts[1:])]
    del out
    torch.cuda.empty_cache()
    log(f"phase 6 (e) the ladder: config 4 FISTA stop "
        f"{base4['stopping_relative_change']:.6e} through api._run with "
        f"{free_e / GiB:.2f} GiB of the card left free by a filler: "
        f"{len(starts)} attempts, each started at "
        f"{starts[0][0] / GiB:.3f} GiB allocated, seconds per attempt "
        f"{attempt_s}; warnings {msgs}; the last, the K=1 loop, stops after "
        f"{want4['iterations_run']} iterations with recon bitwise phase 5's "
        f"K=1 loop; launches whole-run/K-step/pair/fused {l_e} (the failed "
        f"attempts' prologues included); peak {(p_e - fill) / GiB:.3f} GiB "
        f"besides the filler's {fill / GiB:.2f}; {s_e:.3f} s in all "
        f"(the cube's copy to the card included); "
        f"{time.perf_counter() - t_e:.1f} s [{smi}]")


def piecewise_4d(shape, seed):
    """Noisy piecewise-constant 4D cube in float32 on the host: a
    checkerboard of 64×64 scan tiles plus a bright disk on the detector,
    the noise drawn on the card from ``seed`` (numpy takes ~20 s for 4 GiB
    of it on one core)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    noise = torch.randn(shape, generator=gen, device="cuda")
    noise *= 0.3
    cube = noise.cpu().numpy()
    del noise
    torch.cuda.empty_cache()
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
    # the fallback ladder may hide a kernel nowhere but in phase 6 (e)
    warnings.filterwarnings("error", message="device memory exhausted")
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
    pair_ptx = [row for row in ptxas.split("; ") if row.startswith("pair_kernel")]
    ref_grid = {f"{nd}D {'FISTA' if f else 'unacc'}":
                (cooperative_grid(torch.device("cuda"), nd, f),
                 cooperative_grid(torch.device("cuda"), nd, f, True))
                for nd in (3, 4) for f in (True, False)}
    log(f"phase 1 pair kernel instantiations <ND,FISTA,REF> (REF: the "
        f"reference-cube SSE): {'; '.join(pair_ptx)}; full cooperative grid "
        f"without / with REF: {ref_grid}")

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
    # the pair kernel with a reference cube (its REF instantiation)
    t0 = time.perf_counter()
    ref_err, ref_rel = 0.0, 0.0
    for shape in SMALL_N0 + [ODD]:
        for fista in (True, False):
            full_r = cooperative_grid(torch.device("cuda"), len(shape), fista,
                                      True)
            e, r = compare_pair_ref_case(shape, fista, grids=(None, 1, 7,
                                                              full_r))
            ref_err, ref_rel = max(ref_err, e), max(ref_rel, r)
    for shape in (CFG3, CFG2):
        e, r = compare_pair_ref_case(shape, True)
        ref_err, ref_rel = max(ref_err, e), max(ref_rel, r)
    log(f"phase 2 pair kernel with a reference cube vs the plain pair (two "
        f"plain iterations, each with ops.sum_square_error): N0 4..7 in 3D "
        f"and 4D and {ODD}, FISTA and unaccelerated, at the full grid and "
        f"at forced grids of 1, 7 and all blocks, and {CFG3}, {CFG2} FISTA, "
        f"2 pairs each: state bitwise equal (max |Δ| {ref_err}), the eight "
        f"sums within rtol 1e-5 (the SSEs within {ref_rel:.2e}); "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    err4r, rel4r = compare_offcard_ref(CFG4)
    ref_err = max(ref_err, err4r)
    log(f"phase 2 at the main path's {CFG4}, FISTA f32, with a reference "
        f"cube (state held on the host): 1 pair-kernel launch = 2 plain "
        f"iterations with their SSE, 9 arrays bitwise equal (max |Δ| "
        f"{err4r}), the eight sums within rtol {rel4r:.2e}; "
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
    tref, raw = time_pair_ref(CFG4, 3, 1)
    b4r = launch_bound_seconds(CFG4, True, 2, peak_bandwidth(name),
                               peak_f32(name), ref=True)[0] * 1e3 \
        if peak_bandwidth(name) and peak_f32(name) else float("nan")
    log(f"phase 2 time per pair of FISTA f32 iterations at {CFG4} with and "
        f"without a reference cube: pair kernel {tref['pair']:.3f} ms, with "
        f"ref {tref['pair_ref']:.3f} ms ({b4r / tref['pair_ref']:.3f} of its "
        f"{b4r:.2f} ms bound, one more traversal), plain pair with ref "
        f"{tref['plain_ref']:.3f} ms (runs {raw}) [{smi}]")
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
    for shape, fista in STRIP_SWEEP + SOLVER_ONLY:
        n_it = 16 if shape == CFG4 else 48
        mean, launches, raw = time_solver_paths(shape, fista, n_it)
        mb = resident_state_bytes(shape, fista, False) / 1e6
        log(f"phase 2 run_solver {shape} {'FISTA' if fista else 'unaccelerated'}"
            f" ({mb:.1f} MB of state) x{n_it} on the card, whole-run off, ms per "
            f"iteration: the gate's pick {mean['gate']:.4f} (launches "
            f"whole-run/K-step/pair/fused {launches['gate']}), K=8 forced "
            f"{mean['k8']:.4f} ({launches['k8']}), pairs {mean['pairs']:.4f} "
            f"({launches['pairs']}), K=1 loop {mean['k1']:.4f} "
            f"({launches['k1']}); recon bitwise equal on every path (runs "
            f"{raw}) [{smi}]")

    # the K-step kernel: every depth against its plain version, K
    # fused-iteration launches and K/2 pair launches, then at forced grids
    t0 = time.perf_counter()
    kstep_err = 0.0
    n_kstep = 0
    for k in KS:
        for shape in [kstep_shape(s, k) for s in KSTEP_SHAPES] + [ODD]:
            for fista in (True, False):
                kstep_err = max(kstep_err, compare_kstep_case(shape, k, fista))
                n_kstep += 1
    edges = kstep_edge_cases()
    for shape, k, fista in edges:
        kstep_err = max(kstep_err, compare_kstep_case(shape, k, fista,
                                                      grids=(None, 1, 7)))
    for k in KS:
        for rr in (2, 3):
            n0 = 2 * k + 1 if (2 * k + 1) % rr else 2 * k + 2
            for shape, fista in (((n0, 9, 10, 33), True), ((n0, 13, 64), False)):
                kstep_err = max(kstep_err, compare_kstep_case(
                    shape, k, fista, grids=(None, 1, 7), rows=rr))
    grids = {}
    for k in KS:
        for shape in (ODD, (2 * k + 1, 13, 70)):
            full_k = kstep_grid(torch.device("cuda"), len(shape), True, k)
            grids[(k, len(shape))] = full_k
            kstep_err = max(kstep_err, compare_kstep_case(
                shape, k, True, grids=(1, 7, full_k), plain_only=True))
            refuses_oversized_grid(shape, k)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_sm = {f"{nd}D {'FISTA' if f else 'unacc'} K={k}":
              kstep_grid(torch.device("cuda"), nd, f, k) / sms
              for nd in (3, 4) for f in (True, False) for k in KS}
    log(f"phase 2 K-step kernel vs plain, vs K fused-iteration launches and "
        f"(K even) vs K/2 pair launches: {n_kstep} cases (K {KS}; N0 = 2K, "
        f"2K+1 in 3D and 4D at {KSTEP_SHAPES[:4]} (ragged) and "
        f"{KSTEP_SHAPES[4:]} (last extent a multiple of 4: 128-bit loads), "
        f"{ODD}; FISTA and unaccelerated), 2 launches each, and {len(edges)} "
        f"tile-edge cases (last extents 1, 4, 5, 128, 129; ND-2 extents 1, "
        f"7, 9) each at the full grid and at 1 and 7 blocks, and at 2 and "
        f"3 rows per stage (N0 not a multiple) at (N0, 9, 10, 33) FISTA and "
        f"(N0, 13, 64) unaccelerated at those grids, "
        f"state bitwise equal (max |Δ| {kstep_err}), sums within rtol 1e-5; "
        f"the same state at forced grids of 1, 7 and the full grid "
        f"{ {f'K{k} {nd}D': g for (k, nd), g in grids.items()} } at {ODD} and "
        f"(2K+1, 13, 70), a grid one block larger refused; blocks per SM "
        f"(cooperative occupancy, {sms} SMs): {per_sm}; "
        f"{time.perf_counter() - t0:.1f} s")
    # the BASELINE shapes at the wrapper's default rows per stage (several
    # super-rows each), then config 4's K=8 launch of the main path off the
    # card
    t0 = time.perf_counter()
    for shape in (CFG1, CFG2, CFG3):
        for k in KS:
            for fista in (True, False):
                kstep_err = max(kstep_err, compare_kstep_case(
                    shape, k, fista, launches=1, plain_only=True))
    log(f"phase 2 K-step kernel vs plain at {CFG1}, {CFG2} and {CFG3} (R = "
        f"{kstep_rows(CFG1)}, {kstep_rows(CFG2)} and {kstep_rows(CFG3)} rows "
        f"per stage, the default; {-(-CFG1[0] // kstep_rows(CFG1))}, "
        f"{-(-CFG2[0] // kstep_rows(CFG2))} and "
        f"{-(-CFG3[0] // kstep_rows(CFG3))} super-rows): K {KS}, FISTA and "
        f"unaccelerated, one launch each, state bitwise equal (max |Δ| "
        f"{kstep_err}), sums within rtol 1e-5; {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    err4k, rel4k = compare_kstep_offcard(CFG4, True, max(KS))
    kstep_err = max(kstep_err, err4k)
    log(f"phase 2 K-step kernel at the main path's {CFG4}, FISTA f32 (state "
        f"held on the host): one K={max(KS)} launch at the defaults (the full "
        f"grid of its capped 4D FISTA entry, R = {kstep_rows(CFG4)} rows per "
        f"stage) = {max(KS)} plain iterations, 9 arrays bitwise equal (max "
        f"|Δ| {err4k}), {3 * max(KS)} sums within rtol {rel4k:.2e}; "
        f"{time.perf_counter() - t0:.1f} s")
    ktimes = {}
    for shape, fista, n_k, n_p in ((CFG1, False, 100, 20), (CFG2, True, 8, 2),
                                   (CFG3, True, 8, 2), (CFG4, True, 2, 1),
                                   (BIG3, False, 8, 1)):
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
            f"{mean['solver_off']:.5f}, off with K=8 forced "
            f"{mean['solver_k8']:.5f}, K=1 loop {mean['solver_k1']:.5f} ms "
            f"per iteration, recon bitwise equal on every path (runs {raw}) "
            f"[{smi}]")
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
    cube, scan, det, gen_s = piecewise_4d(CFG4, SEED)
    log(f"phase 3 data: {CFG4} float32 ({cube.nbytes / 2**30:.2f} GiB) made "
        f"in {gen_s:.2f} s (noise drawn on the card)")
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
    # iteration rate on the device alone (no host↔device copies), in turns:
    # the engine's pick (K=8 launches, pairs for the remainder), pairs alone
    # (the K-step kernel off), the K=1 loop (both off)
    orig = torch.from_numpy(cube).cuda()
    li = torch.full((4,), 32.0, device="cuda")
    lm = torch.full((4,), 1 / 32, device="cuda")
    paths3 = {"engine": dict(), "pairs": dict(temporal_kstep=False),
              "K=1 loop": dict(temporal_pairs=False)}
    solve, c3 = {path: [] for path in paths3}, {}
    for path in [*paths3, *reversed(paths3)]:
        opts = SolverOptions(ndim=4, iterations_fista=20, iterations_unacc=0,
                             **paths3[path])
        reset_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        run_solver(orig, li, lm, opts)
        torch.cuda.synchronize()
        solve[path].append(time.perf_counter() - t1)
        c3[path] = launch_counts()
    del orig
    torch.cuda.empty_cache()
    n_vox = int(np.prod(CFG4))
    bw = peak_bandwidth(name)
    for path, runs3 in solve.items():
        solve_s = sum(runs3) / 2
        rate = n_vox * 20 / solve_s
        shares = {m: (model_seconds(CFG4, True, m, bw) * 20 / solve_s
                      if bw else float("nan"))
                  for m in ("pair_floor", "two_pass")}
        log(f"phase 3 rate, {path} (launches whole-run/K-step/pair/fused "
            f"{c3[path]}): run_solver 20 iterations on the card "
            f"{solve_s:.4f} s (runs {[round(x, 4) for x in runs3]}) = "
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
    for path, kw in (("chunks", {}),
                     ("k1", dict(vmem_resident=False, temporal_pairs=False)),
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
    # whole-run chunks, then (after a beaten chunk guard) the stop-aware
    # K-steps may take the rest; config 1's rows take no pairs
    require(chunks1[0] > 0 and chunks1[2] == 0,
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
        # stop-aware runs take K-steps and pairs behind the guard, as many
        # as the deltas allow
        with pairs_at_any_row():
            reset_counts()
            got = denoise4D(cube3, mu4, **kw)
            want = expected_launches(SolverOptions(
                ndim=4, iterations_fista=10, iterations_unacc=10), CFG3)[:3]
        counts = launch_counts()[:3]
        require(counts[0] == 0 and (stop is not None or (
            counts == want and counts[2] > 0)),
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
    # each of the hybrid runs ends with a plain-backend run, which launches
    # nothing: the counts read here are those of the kernels' run
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
    hyb4s = launch_counts()
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
        f"iterations, {n_run - 10} of them unaccelerated; launches {hyb4s})")

    # phase 5: stop-aware K-steps and pairs, MSE pairs
    stop5 = stop_phase(smi, cube, scan, det)

    # phase 6: chunked runs, a killed run resumed, the fallback ladder
    t6 = time.perf_counter()
    chunk_phase(smi, cube, cube1, r1, cube3, stop5)
    log(f"phase 6 {time.perf_counter() - t6:.1f} s")

    # launches: each kernel's count in the run of the path that reaches it
    # (x21: the odd iteration; x20: the pairs; config 1 through run_solver
    # with the whole-run kernel off: the K-step; config 1 through denoise3D:
    # the whole-run kernel); ms at the shape of that run (the whole-run
    # kernel: one 7500-iteration launch; its plain_ms: the plain iteration's
    # ms x 7500); bound_ms: the least time the card could take for one
    # launch of the same work (utils/perf.py)
    f32 = peak_f32(name)
    kd = k1_depth

    def bound(shape, fista, iters, ref=False):
        if not (bw and f32):
            return None, None
        t, by = launch_bound_seconds(shape, fista, iters, bw, f32, ref=ref)
        return t * 1e3, by

    rows = [
        ("fused_iteration", "fused_iteration.cu", "fused.py:872", counts[21][3],
         max_err, k4, p4, bound(CFG4, True, 1)),
        ("fused_pair_iteration", "temporal_pair.cu", "temporal.py:947",
         counts[20][2], pair_err, times[CFG4]["pair"], times[CFG4]["plain"],
         bound(CFG4, True, 2)),
        # the MSE pair launch (the REF instantiation) on the config-4 MSE
        # path of phase 5
        ("fused_pair_iteration_ref", "temporal_pair.cu", "temporal.py:947",
         stop5["mse_pairs"], ref_err, tref["pair_ref"], tref["plain_ref"],
         bound(CFG4, True, 2, ref=True)),
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
