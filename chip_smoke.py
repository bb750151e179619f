#!/usr/bin/env python3
"""Drive cytvdn_tpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints one line or a few; any failure raises and exits
non-zero — nothing is caught):

0. device: name, ``nvidia-smi`` name and power limit, TF32 off;
1. build: the CUDA kernels from ``cytvdn_tpu_torch/csrc`` with nvcc, one
   process per source;
2. kernels vs plain: 3 iterations of the fused-iteration kernel against its
   plain PyTorch version on the same inputs — state bitwise equal, the
   three sums within rtol 1e-5 — for every boundary condition, FISTA and
   unaccelerated, half-isotropic pairs, float32 and float64, also at the
   main path's shapes (256,256,2048); two pairs of the pair kernel against
   its plain version and against four launches of the fused-iteration
   kernel (state bitwise equal, sums within rtol 1e-5) at N0 = 4..7, on
   ragged shapes and at the main path's shapes, and at forced grids of 1,
   7 and all blocks (the race check); at (256,256,128,128) two iterations
   of the fused-iteration kernel, one pair and two plain iterations, all
   bitwise equal (compared off the card); then ms per pair of the pair
   kernel, of two fused-iteration launches and of the plain pair at
   (128,128,64,64), (256,256,2048) and (256,256,128,128), and each CUDA
   kernel's device time from ``torch.profiler`` at the last;
3. main path: ``denoise4D`` on a 256×256×128×128 float32 cube (the
   BASELINE config-4 size), 20 FISTA iterations (10 pair launches, no
   fused-iteration launch) and 21 (10 + 1), with the launch counts, the
   peak device memory, and the iteration rate with pairs on and off;
4. 3D paths, and hybrid 4D runs (without and with an early stop in the
   second phase) against the plain backend on the card;
5. one JSON line on the kernels, the card's name and power limit, and the
   ``{"ok": true, ...}`` line last.

Needs one CUDA device; exits non-zero without one. Inputs are made from
fixed seeds.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from cytvdn_tpu_torch import denoise3D, denoise4D
from cytvdn_tpu_torch.config import SolverOptions
from cytvdn_tpu_torch.kernels import build
from cytvdn_tpu_torch.kernels.fused import fused_iteration, fused_iteration_reference
from cytvdn_tpu_torch.kernels.temporal import (
    cooperative_grid,
    fused_pair_iteration,
    fused_pair_iteration_reference,
)
from cytvdn_tpu_torch.solver.engine import run_solver
from cytvdn_tpu_torch.utils.perf import model_seconds, peak_bandwidth

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


def compare_pair_case(shape, fista, grids=(None,)):
    """Two pairs of the pair kernel (at each forced grid of ``grids``;
    None is the full cooperative grid) against its plain version and four
    fused-iteration launches from the same Jia-Zhao state; returns max
    |Δstate|."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    orig, state, li, lm, rho = random_state(shape, fista, torch.float32, gen,
                                            jz=True)
    steps = [lambda *a, g=g, **k: fused_pair_iteration(*a, grid=g, **k)
             for g in grids] + [fused_pair_iteration_reference, two_k1]
    results = []
    for step in steps:
        s = [x.clone() for x in state]
        fn = pair_fn(step, orig, s, li, lm, rho, fista)
        sums = [torch.stack(fn()).double() for _ in range(2)]
        torch.cuda.synchronize()
        results.append((s, torch.stack(sums).cpu()))
    (ks, ksum) = results[0]
    err = 0.0
    for ps, psum in results[1:]:
        err = max(err, max((a - b).abs().max().item() for a, b in zip(ks, ps)))
        require(all(torch.equal(a, b) for a, b in zip(ks, ps)),
                f"pair kernel state differs: shape {shape} fista {fista} "
                f"grids {grids}: max |Δ| {err}")
        rel = ((ksum - psum).abs() / psum.abs().clamp_min(1e-300)).max().item()
        require(rel <= 1e-5, f"pair sums differ by rtol {rel} at {shape}")
    return err


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


def profile_kernels(shape, iters=3):
    """Device ms per FISTA float32 iteration of each CUDA kernel, from
    ``torch.profiler``'s ``key_averages()``, over ``iters`` pairs of
    iterations run as two fused-iteration launches and then ``iters``
    pair-kernel launches, and the bytes per second that the traffic
    model's traversals imply: the dual pass 17 in 4D, the reconstruction
    pass 7, the pair kernel the two-pass 24 per iteration (the top of its
    band)."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    orig, state, li, lm, rho = random_state(shape, True, torch.float32, gen,
                                            jz=True)
    k1 = pair_fn(two_k1, orig, state, li, lm, rho, True)
    pair = pair_fn(fused_pair_iteration, orig, state, li, lm, rho, True)
    k1()
    pair()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            k1()
        for _ in range(iters):
            pair()
        torch.cuda.synchronize()
    del orig, state, k1, pair
    torch.cuda.empty_cache()
    n = len(shape)
    nbytes = int(np.prod(shape)) * 4
    trav = {"dual_kernel": 4 * n + 1, "recon_kernel": n + 3,
            "finalize_kernel": 0, "pair_kernel": 5 * n + 4}
    rows = []
    for e in prof.key_averages():
        for key, t in trav.items():
            if key in e.key:
                # per iteration: the K=1 kernels ran 2 * iters times, the
                # pair kernel iters times for 2 * iters iterations
                ms = e.device_time_total / 1e3 / (2 * iters)
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
    # the one-iteration loop in both runs: the stop check's own cost
    opts = SolverOptions(ndim=ndim, iterations_fista=0, iterations_unacc=iters,
                         stopping_relative_change=stop, temporal_pairs=False)
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
        regs = [ln.strip() for ln in f if "registers" in ln]
    log(f"phase 1 build: nvcc {build.build_seconds:.2f} s, load "
        f"{time.perf_counter() - t0:.2f} s; {len(regs)} kernels; "
        f"ptxas: {' | '.join(regs)}")

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
    pair_err = 0.0
    n_pair = 0
    for shape in SMALL_N0 + [ODD, CFG3, CFG1, CFG2]:
        for fista in (True, False):
            pair_err = max(pair_err, compare_pair_case(shape, fista))
            n_pair += 1
    full = {nd: cooperative_grid(torch.device("cuda"), nd, True) for nd in (3, 4)}
    for shape in (ODD, SMALL_N0[-1]):
        pair_err = max(pair_err, compare_pair_case(
            shape, True, grids=(1, 7, full[len(shape)])))
    log(f"phase 2 pair kernel vs plain pair and vs 4 fused-iteration "
        f"launches: {n_pair} cases (N0 4..7 in 3D and 4D, {ODD}, {CFG3}, "
        f"{CFG1}, {CFG2}; FISTA and unaccelerated), 2 pairs each, state "
        f"bitwise equal (max |Δ| {pair_err}), sums within rtol 1e-5; the "
        f"same state at forced grids of 1, 7 and {full[4]} (4D) / {full[3]} "
        f"(3D) blocks at {ODD} and {SMALL_N0[-1]}")
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

    # phase 3: the main path at full size
    rng = np.random.default_rng(SEED)
    cube, scan, det, gen_s = piecewise_4d(CFG4, rng)
    log(f"phase 3 data: {CFG4} float32 ({cube.nbytes / 2**30:.2f} GiB) made "
        f"in {gen_s:.2f} s on the host")
    mu = np.full(4, 1.0, np.float32)
    counts = {}
    for iters in (20, 21):
        torch.cuda.reset_peak_memory_stats()
        fused_iteration.launches = 0
        fused_pair_iteration.launches = 0
        t0 = time.perf_counter()
        recon, b_norm, delta = denoise4D(cube, mu, iterations=iters,
                                         FISTA=True, quiet=True, device="cuda")
        wall = time.perf_counter() - t0
        counts[iters] = (fused_pair_iteration.launches, fused_iteration.launches)
        peak = torch.cuda.max_memory_allocated()
        iterations_run = int(np.count_nonzero(delta))
        require(counts[iters] == (iters // 2, iters % 2)
                and iterations_run == iters,
                f"x{iters}: (pair, fused-iteration) launches {counts[iters]}, "
                f"iterations_run {iterations_run}")
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
            f"{wall:.3f} s (host copies included); launches: pair kernel "
            f"{counts[iters][0]}, fused iteration {counts[iters][1]}; "
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
    fused_iteration.launches = 0
    fused_pair_iteration.launches = 0
    t0 = time.perf_counter()
    r1, b1, d1 = denoise3D(cube1, np.full(3, 1.0, np.float32), quiet=True,
                           device="cuda")
    s1 = time.perf_counter() - t0
    require((fused_pair_iteration.launches, fused_iteration.launches)
            == (3750, 0), "3750 pair launches and no other expected")
    require(bool(np.isfinite(r1).all() and (d1 > 0).all()), "cfg1 result")
    log(f"phase 4 denoise3D {CFG1} unaccelerated, default 7500 iterations "
        f"(3750 pair launches): {s1:.3f} s wall = {int(np.prod(CFG1)) * 7500 / s1 / 1e9:.3f} G "
        f"voxel-updates/s (host loop included) [{smi}]")

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
        fused_pair_iteration.launches = 0
        got = denoise4D(cube3, mu4, **kw)
        # pairs without a stop; stop-aware runs stay on the K=1 loop
        require(fused_pair_iteration.launches == (10 if stop is None else 0),
                f"hybrid (stop {stop}): {fused_pair_iteration.launches} pairs")
        want = denoise4D(cube3, mu4, backend="torch", **kw)
        require(np.array_equal(got[0], want[0]),
                f"hybrid recon not bitwise equal (stop {stop})")
        np.testing.assert_array_equal(np.nonzero(got[2])[0],
                                      np.nonzero(want[2])[0])
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5)
        np.testing.assert_allclose(got[2], want[2], rtol=1e-5)
        return got[2]

    d = hybrid(None)
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
    # the full run's traces come from the pair kernel, the stopped run's
    # from the fused-iteration kernel: their sums differ in the last bits
    np.testing.assert_allclose(ds[:n_run], d[:n_run], rtol=1e-5)
    log(f"phase 4 hybrid (10,10) {CFG3} kernels vs backend='torch' on the "
        f"card: recon bitwise equal, traces within rtol 1e-5, without a stop "
        f"(10 pair launches, 20 iterations, delta {d[0]:.3e} .. "
        f"{d[9]:.3e} | {d[10]:.3e} .. {d[19]:.3e}) and with stop {thr:.6e} (both stop after {n_run} "
        f"iterations, {n_run - 10} of them unaccelerated)")

    # launches: each kernel's count in the main-path run that reaches it
    # (x21: the odd iteration; x20: the pairs); ms at 256^2 x 128^2
    kernels = [{
        "name": "fused_iteration",
        "route": "cuda",
        "source": "cytvdn_tpu_torch/csrc/fused_iteration.cu",
        "replaces": "cytvdn_tpu/kernels/fused.py:872",
        "launches": counts[21][1],
        "max_abs_err": max_err,
        "ms": k4,
        "plain_ms": p4,
    }, {
        "name": "fused_pair_iteration",
        "route": "cuda",
        "source": "cytvdn_tpu_torch/csrc/temporal_pair.cu",
        "replaces": "cytvdn_tpu/kernels/temporal.py:947",
        "launches": counts[20][0],
        "max_abs_err": pair_err,
        "ms": times[CFG4]["pair"],
        "plain_ms": times[CFG4]["plain"],
    }]
    log(f"total {time.perf_counter() - total_t0:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
