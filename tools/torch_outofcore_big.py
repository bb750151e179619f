#!/usr/bin/env python3
"""One out-of-core run of a state larger than the card's memory, on the
card (cytvdn_tpu_torch.solver.outofcore.denoise_outofcore).

    python3 tools/torch_outofcore_big.py [--n0 5120] [--slabs 8] [--k 8]
                                          [--iterations 16]

The default is a 3D FISTA cube of 5120×256×2048 float32 (10 GiB; 80 GiB of
state: orig, recon, 3 accumulators, 3 shadow duals), above the 79.18 GiB an
H100 gives PyTorch, in temporal mode (K iterations per slab residency),
then two stream-mode iterations, then two iterations in temporal mode with
K=2. The cube is drawn on the card from a fixed seed, a noisy step along
the energy axis. No in-core run can be compared (the state does not fit
the card), so the checks are the result's shape, that it is finite and
that the delta trace falls, and that the two modes agree: both are bitwise
the in-core run, so the K=2 run's recon must be bitwise the stream run's
(kept on the card meanwhile). The smaller states of ``chip_smoke.py``
phase 8 hold the same code bitwise against in-core runs.
Prints one line per run: seconds per iteration, bytes and rates each way,
pinned host memory and its seconds, peak device memory, launches; the
card's name and power limit; and the host's available memory before.
Needs one CUDA device and about 91 GiB of host memory (the cube and
the page-locked state).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cytvdn_tpu_torch.kernels import fused_iteration, fused_pair_iteration  # noqa: E402
from cytvdn_tpu_torch.solver import outofcore  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--n0", type=int, default=5120)
    p.add_argument("--slabs", type=int, default=8)
    p.add_argument("--k", type=int, default=8)
    p.add_argument("--iterations", type=int, default=16)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    with open("/proc/meminfo") as f:
        avail = [int(ln.split()[1]) * 1024 for ln in f
                 if ln.startswith("MemAvailable")][0]
    shape = (args.n0, 256, 2048)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    cube = np.empty(shape, np.float32)
    for lo in range(0, args.n0, 512):
        hi = min(lo + 512, args.n0)
        x = torch.randn((hi - lo,) + shape[1:], generator=gen, device="cuda")
        x[:, :, shape[2] // 2:] += 1.0
        cube[lo:hi] = x.cpu().numpy()
    del x
    torch.cuda.empty_cache()
    state_gib = cube.nbytes * 8 / 2**30
    card_gib = torch.cuda.get_device_properties(0).total_memory / 2**30
    print(f"{smi}; host memory available {avail / 2**30:.1f} GiB; cube "
          f"{shape} float32 {cube.nbytes / 2**30:.2f} GiB, FISTA state "
          f"{state_gib:.2f} GiB against the card's {card_gib:.2f} GiB; "
          f"made in {time.perf_counter() - t0:.1f} s", flush=True)
    mu = np.full(3, 1.0, np.float32)
    stream = None  # the stream run's recon, on the card
    for k, iters in ((args.k, args.iterations), (1, 2), (2, 2)):
        torch.cuda.reset_peak_memory_stats()
        l0 = (fused_iteration.launches, fused_iteration.halo_launches,
              fused_pair_iteration.launches)
        t0 = time.perf_counter()
        recon, b_norm, delta = outofcore.denoise_outofcore(
            cube, mu, iterations=iters, FISTA=True, n_slabs=args.slabs,
            temporal_k=k, device="cuda")
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        held = " (the stream run's recon held on the card)" \
            if stream is not None else ""
        run = dict(outofcore.last_run)
        d = delta[np.nonzero(delta)]
        finite = all(bool(np.isfinite(recon[lo:lo + 256]).all())
                     for lo in range(0, args.n0, 256))
        ok = (recon.shape == shape and finite and d.size
              and (d.size == 1 or d[-1] < d[0]))
        same = ""
        if k == 1:
            stream = torch.from_numpy(recon).cuda()
        elif stream is not None:
            ok = ok and torch.equal(stream, torch.from_numpy(recon).cuda())
            same = ", recon bitwise the stream run's"
            stream = None
            torch.cuda.empty_cache()
        launches = (fused_iteration.launches - l0[0],
                    fused_iteration.halo_launches - l0[1],
                    fused_pair_iteration.launches - l0[2])
        print(f"{'stream' if k == 1 else f'temporal K={k}'}, {args.slabs} "
              f"slabs, FISTA x{iters}: {'ok' if ok else 'FAILED'} (finite, "
              f"delta {d[0]:.4e} -> {d[-1]:.4e}{same}); "
              f"{run['sweep_seconds'] / iters:.4f} s per iteration, wall "
              f"{wall:.2f} s; {run['h2d_bytes'] / 1e9 / iters:.2f} GB in at "
              f"{run['h2d_bytes'] / run['h2d_seconds'] / 1e9:.2f} GB/s, "
              f"{run['d2h_bytes'] / 1e9 / iters:.2f} GB out at "
              f"{run['d2h_bytes'] / run['d2h_seconds'] / 1e9:.2f} GB/s per "
              f"iteration; pinned {run['pinned_bytes'] / 2**30:.2f} GiB in "
              f"{run['pin_seconds']:.2f} s; peak device memory "
              f"{peak / 2**30:.2f} GiB{held}; "
              f"launches (K=1, of them with halos, pair) {launches} [{smi}]",
              flush=True)
        if not ok:
            return 1
        del recon
    return 0


if __name__ == "__main__":
    sys.exit(main())
