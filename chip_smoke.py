#!/usr/bin/env python3
"""Drive cytvdn_tpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints one line or a few; any failure raises and exits
non-zero — nothing is caught):

0. device: name, ``nvidia-smi`` name and power limit, TF32 off;
1. build: the CUDA kernels from ``cytvdn_tpu_torch/csrc`` with nvcc;
2. kernel vs plain: 3 iterations of the fused-iteration kernel against its
   plain PyTorch version on the same inputs — state bitwise equal, the
   three sums within rtol 1e-5 — for every boundary condition, FISTA and
   unaccelerated, half-isotropic pairs, float32 and float64, also at the
   main path's shapes (256,256,2048) and (256,256,128,128); then the time
   per iteration of both at (128,128,64,64) and (256,256,128,128), and
   each CUDA kernel's device time from ``torch.profiler`` at the latter;
3. main path: ``denoise4D`` on a 256×256×128×128 float32 cube (the
   BASELINE config-4 size), 20 FISTA iterations, with the kernel's launch
   count, the peak device memory and the iteration rate;
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
from cytvdn_tpu_torch.solver.engine import run_solver
from cytvdn_tpu_torch.utils.perf import model_seconds, peak_bandwidth

SEED = 0
CFG4 = (256, 256, 128, 128)   # BASELINE.json config 4
CFG3 = (128, 128, 64, 64)     # BASELINE.json config 3
CFG1 = (64, 64, 512)          # BASELINE.json config 1
CFG2 = (256, 256, 2048)       # BASELINE.json config 2
ODD = (37, 45, 19, 23)        # ragged tile edges on every axis


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


def random_state(shape, fista, dtype, gen):
    """orig, recon, accs[, ds] on the card, plus per-axis scalars whose clip
    radii are small enough that the projections bind."""
    ndim = len(shape)

    def rnd(scale):
        return torch.randn(shape, generator=gen, device="cuda", dtype=dtype) * scale

    orig = rnd(0.5) + 2.0
    state = [orig + rnd(0.05)] + [rnd(0.2) for _ in range(ndim)]
    if fista:
        state += [rnd(0.2) for _ in range(ndim)]
    li = torch.linspace(0.2, 0.35, ndim, device="cuda", dtype=dtype)
    lm = torch.linspace(1 / 32, 1 / 48, ndim, device="cuda", dtype=dtype)
    rho = torch.tensor(0.37, device="cuda", dtype=dtype)
    return orig, state, li, lm, rho


def step_fn(step, orig, state, li, lm, rho, fista, **kw):
    ndim = orig.dim()
    accs = state[1:1 + ndim]
    ds = state[1 + ndim:] if fista else None
    return lambda: step(orig, state[0], accs, ds, rho, li, lm, fista=fista, **kw)


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


def compare_offcard(shape, fista, iters=3):
    """compare_case (Jia-Zhao, float32) for a state too large to hold twice
    on the card: the kernel's result is copied to the host and freed, the
    same state is rebuilt from the seed for the plain version, and each
    array is then brought back alone and compared. Returns max |Δstate|."""
    def run(step):
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        orig, state, li, lm, rho = random_state(shape, fista, torch.float32, gen)
        fn = step_fn(step, orig, state, li, lm, rho, fista, bc=2)
        sums = torch.stack([torch.stack(fn()[3:]).double() for _ in range(iters)])
        return state, sums.cpu()

    state, ksum = run(fused_iteration)
    host = [x.cpu() for x in state]
    del state
    torch.cuda.empty_cache()
    state, psum = run(fused_iteration_reference)
    err, bitwise = 0.0, True
    for i, p in enumerate(state):
        k = host[i].cuda()
        host[i] = None
        err = max(err, (k - p).abs().max().item())
        bitwise = bitwise and torch.equal(k, p)
        del k
    del state, host
    torch.cuda.empty_cache()
    require(bitwise, f"kernel != plain: shape {shape} bc 2 fista {fista} "
                     f"float32: max |Δ| {err}")
    rel = ((ksum - psum).abs() / psum.abs().clamp_min(1e-300)).max().item()
    require(rel <= 1e-5, f"sums differ by rtol {rel} at {shape}")
    return err, rel


def profile_kernels(shape, iters=3):
    """Device ms per FISTA float32 iteration of each CUDA kernel, from
    ``torch.profiler``'s ``key_averages()``, and the bytes per second that
    the traffic model's traversals of the dual pass (17 in 4D) and the
    reconstruction pass (7) imply."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    orig, state, li, lm, rho = random_state(shape, True, torch.float32, gen)
    kern = step_fn(fused_iteration, orig, state, li, lm, rho, True)
    kern()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            kern()
        torch.cuda.synchronize()
    del orig, state, kern
    torch.cuda.empty_cache()
    n = len(shape)
    nbytes = int(np.prod(shape)) * 4
    trav = {"dual_kernel": 4 * n + 1, "recon_kernel": n + 3, "finalize_kernel": 0}
    rows = []
    for e in prof.key_averages():
        for key, t in trav.items():
            if key in e.key:
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


def time_pair(shape, n_kernel, n_plain):
    """ms per FISTA float32 iteration: plain, kernel, kernel, plain, on one
    state; returns the mean kernel and plain times and the four runs."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    orig, state, li, lm, rho = random_state(shape, True, torch.float32, gen)
    kern = step_fn(fused_iteration, orig, state, li, lm, rho, True)
    plain = step_fn(fused_iteration_reference, orig, state, li, lm, rho, True)
    p1 = time_ms(plain, n_plain)
    k1 = time_ms(kern, n_kernel)
    k2 = time_ms(kern, n_kernel)
    p2 = time_ms(plain, n_plain)
    del orig, state, kern, plain
    torch.cuda.empty_cache()
    return (k1 + k2) / 2, (p1 + p2) / 2, (k1, k2, p1, p2)


def solver_ms(shape, iters, stop):
    """Host-clock ms per unaccelerated iteration of ``run_solver`` on a
    random cube on the card; ``stop`` set to a threshold that never
    triggers adds the per-iteration stop check (one host sync)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    orig = torch.randn(shape, generator=gen, device="cuda") * 0.5 + 2.0
    ndim = len(shape)
    div = 32.0 if ndim == 4 else 16.0
    li = torch.full((ndim,), div, device="cuda")
    lm = torch.full((ndim,), 1 / div, device="cuda")
    opts = SolverOptions(ndim=ndim, iterations_fista=0, iterations_unacc=iters,
                         stopping_relative_change=stop)
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
    t0 = time.perf_counter()
    err4, rel4 = compare_offcard(CFG4, True)
    max_err = max(max_err, err4)
    log(f"phase 2 kernel vs plain at the main path's {CFG4}, FISTA f32, "
        f"3 iterations through fused_iteration (kernel state held on the "
        f"host): 9 arrays bitwise equal (max |Δ| {err4}), sums within rtol "
        f"{rel4:.2e}; {time.perf_counter() - t0:.1f} s")
    k3, p3, raw3 = time_pair(CFG3, 20, 5)
    log(f"phase 2 time per FISTA f32 iteration at {CFG3}: kernel {k3:.3f} ms, "
        f"plain {p3:.3f} ms (k1 k2 p1 p2 = {[round(x, 3) for x in raw3]}) "
        f"[{smi}]")
    k4, p4, raw4 = time_pair(CFG4, 6, 2)
    log(f"phase 2 time per FISTA f32 iteration at {CFG4}: kernel {k4:.3f} ms, "
        f"plain {p4:.3f} ms (k1 k2 p1 p2 = {[round(x, 3) for x in raw4]}) "
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
    torch.cuda.reset_peak_memory_stats()
    fused_iteration.launches = 0
    t0 = time.perf_counter()
    recon, b_norm, delta = denoise4D(cube, mu, iterations=20, FISTA=True,
                                     quiet=True, device="cuda")
    wall = time.perf_counter() - t0
    launches = fused_iteration.launches
    peak = torch.cuda.max_memory_allocated()
    iterations_run = int(np.count_nonzero(delta))
    require(launches == iterations_run == 20,
            f"launches {launches}, iterations_run {iterations_run}")
    require(recon.shape == CFG4 and recon.dtype == np.float32, "recon shape")
    require(bool(np.isfinite(recon).all()), "recon not finite")
    require(bool((b_norm > 0).all() and (delta > 0).all()), "traces not positive")
    require(peak < total_mem, "peak memory above the card's")
    # denoising moves the cube toward the clean signal (first 8 scan rows)
    clean8 = scan[:8, :, None, None] + det[None, None]
    err_in = float(np.abs(cube[:8] - clean8).mean())
    err_out = float(np.abs(recon[:8] - clean8).mean())
    require(err_out < err_in, f"recon error {err_out} !< input {err_in}")
    del recon
    # iteration rate on the device alone (no host↔device copies)
    orig = torch.from_numpy(cube).cuda()
    li = torch.full((4,), 32.0, device="cuda")
    lm = torch.full((4,), 1 / 32, device="cuda")
    opts = SolverOptions(ndim=4, iterations_fista=20, iterations_unacc=0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    run_solver(orig, li, lm, opts)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t1
    del orig
    torch.cuda.empty_cache()
    n_vox = int(np.prod(CFG4))
    rate = n_vox * 20 / solve_s
    bw = peak_bandwidth(name)
    share = (model_seconds(CFG4, True, "two_pass", bw) * 20 / solve_s
             if bw else float("nan"))
    log(f"phase 3 main path: denoise4D {CFG4} FISTA x20 wall {wall:.3f} s "
        f"(host copies included); launches {launches} = iterations_run; "
        f"peak device memory {peak / 2**30:.2f} GiB of "
        f"{total_mem / 2**30:.1f}; mean |recon-clean| {err_out:.4f} < "
        f"|noisy-clean| {err_in:.4f}")
    log(f"phase 3 rate: run_solver 20 iterations on the card {solve_s:.4f} s "
        f"= {rate / 1e9:.3f} G voxel-updates/s; {share:.3f} of the two-pass "
        f"traffic model (24 traversals) at the {bw} B/s published peak "
        f"[{smi}]")

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
    t0 = time.perf_counter()
    r1, b1, d1 = denoise3D(cube1, np.full(3, 1.0, np.float32), quiet=True,
                           device="cuda")
    s1 = time.perf_counter() - t0
    require(fused_iteration.launches == 7500, "7500 launches expected")
    require(bool(np.isfinite(r1).all() and (d1 > 0).all()), "cfg1 result")
    log(f"phase 4 denoise3D {CFG1} unaccelerated, default 7500 iterations: "
        f"{s1:.3f} s wall = {int(np.prod(CFG1)) * 7500 / s1 / 1e9:.3f} G "
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
        got = denoise4D(cube3, mu4, **kw)
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
    require(np.array_equal(ds[:n_run], d[:n_run]),
            "the stopped run's trace differs from the full run's")
    log(f"phase 4 hybrid (10,10) {CFG3} kernel vs backend='torch' on the card: "
        f"recon bitwise equal, traces within rtol 1e-5, without a stop (20 "
        f"iterations, delta {d[0]:.3e} .. {d[9]:.3e} | {d[10]:.3e} .. "
        f"{d[19]:.3e}) and with stop {thr:.6e} (both stop after {n_run} "
        f"iterations, {n_run - 10} of them unaccelerated)")

    kernels = [{
        "name": "fused_iteration",
        "route": "cuda",
        "source": "cytvdn_tpu_torch/csrc/fused_iteration.cu",
        "replaces": "cytvdn_tpu/kernels/fused.py:872",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k4,
        "plain_ms": p4,
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
