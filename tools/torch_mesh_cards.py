#!/usr/bin/env python3
"""Mesh runs with one card per rank (cytvdn_tpu_torch.parallel), against
the single-device run of the same cube.

    python3 tools/torch_mesh_cards.py          # on a host of 2 or more cards
    python3 tools/torch_mesh_cards.py --cpu    # rehearsal: 4 CPU ranks, gloo

On the cards: config 4 (256²×128² FISTA, the noisy piecewise cube of
``chip_smoke.py``) ×20 on a (N, 1, 1, 1) mesh of N = the host's cards and
on (2, 1, 1, 1), ×4 on (2, 2, 1, 1) where there are 4 cards, each through
NCCL (every rank has a card of its own, the backend rule of
``init_distributed``), and ×20 on (N, 1, 1, 1) through gloo forced (the
slabs staged through host memory); each rank is a process of
``chip_smoke.py --sharded-worker``, reading its block lazily from a
``.npy``. Each mesh first runs 2 iterations in the same process group (a
warm-up: NCCL builds a communicator for each pair of ranks at their first
exchange, ~1.4 s), then the measured run. Each rank's block and rank 0's
gathered recon must be bitwise the single-device ``denoise4D`` recon
(sha256 digests), its traces within rtol 1e-5, in both runs. Prints, per
measured run and rank, the seconds per iteration of the solve, the
exchange's seconds and bytes, the launches and the peak device memory
(``chip_smoke.rank_lines``), ``run_solver``'s seconds per iteration on
one card for the same schedules, and the card's name and power limit.
With NCCL the exchange's seconds are those the host spends in the calls
(the transfers run on NCCL's stream); the solve's seconds end with the
traces on the host.

``--cpu`` runs the same program at 16×8×6×5 on 4 CPU ranks (gloo), with
(4, 1, 1, 1) and (2, 2, 1, 1) meshes: the rehearsal of the plumbing.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from cytvdn_tpu_torch import denoise4D  # noqa: E402
from cytvdn_tpu_torch.config import SolverOptions  # noqa: E402
from cytvdn_tpu_torch.kernels import build  # noqa: E402
from cytvdn_tpu_torch.solver.engine import run_solver  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on 4 CPU ranks at a small size")
    args = ap.parse_args()
    if args.cpu:
        device, n, shape, smi = "cpu", 4, (16, 8, 6, 5), "CPU rehearsal"
        cube = (np.random.default_rng(0).standard_normal(shape) * 0.5
                + 2.0).astype(np.float32)
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
            print("torch_mesh_cards: needs 2 or more CUDA devices",
                  file=sys.stderr)
            return 1
        device, n, shape = "cuda", torch.cuda.device_count(), cs.CFG4
        smi = cs.smi_line()
        build.load()
        cube, _, _, _ = cs.piecewise_4d(shape, cs.SEED)
    mu = np.full(4, 1.0, np.float32)
    meshes = [("nccl_N", (n, 1, 1, 1), 20, None)]
    if n > 2:
        meshes.append(("nccl_2", (2, 1, 1, 1), 20, None))
    if n >= 4:
        meshes.append(("nccl_2x2", (2, 2, 1, 1), 4, None))
    meshes.append(("gloo_N", (n, 1, 1, 1), 20, "gloo"))
    tmp = tempfile.mkdtemp(prefix="cytv_cards_")
    try:
        npy = os.path.join(tmp, "cube.npy")
        np.save(npy, cube)
        want, digests, ms_single = {}, {}, {}
        orig = torch.from_numpy(cube).to(device)
        li = torch.full((4,), 32.0, device=device)
        lm = torch.full((4,), 1 / 32, device=device)
        for iters in sorted({2} | {m[2] for m in meshes}):
            want[iters] = cs.single(lambda: denoise4D(
                cube, mu, iterations=iters, quiet=True, device=device))
            opts = SolverOptions(ndim=4, iterations_fista=iters,
                                 iterations_unacc=0)
            run_solver(orig, li, lm, opts)
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_solver(orig, li, lm, opts)
            if device == "cuda":
                torch.cuda.synchronize()
            ms_single[iters] = (time.perf_counter() - t0) / iters * 1e3
        for name, shard, iters, _ in meshes:
            for k in (2, iters):
                digests[name, k] = cs.blocks(want[k]["recon"], shard)
        del cube, orig
        if device == "cuda":
            torch.cuda.empty_cache()
        cs.log(f"single device: run_solver {shape} FISTA on {device}, the "
               f"second of two runs: "
               + ", ".join(f"x{k} {v:.2f} ms per iteration"
                           for k, v in ms_single.items()) + f" [{smi}]")
        for name, shard, iters, backend in meshes:
            ranks = int(np.prod(shard))
            t0 = time.perf_counter()
            res = cs.run_mesh(tmp, ranks, [
                dict(name=f"{name}_warm", input=npy, ndim=4, iterations=2,
                     shard=list(shard)),
                dict(name=name, input=npy, ndim=4, iterations=iters,
                     shard=list(shard))], timeout=600, device=device,
                **({"backend": backend} if backend else {}))
            cs.check_mesh_run(f"{name}_warm", res, want[2],
                              *digests[name, 2])
            runs = cs.check_mesh_run(name, res, want[iters],
                                     *digests[name, iters])
            cs.log(f"{name}: config {shape} FISTA x{iters} on {shard}, "
                   f"{ranks} ranks ({runs[0]['backend']}), after a x2 "
                   f"warm-up: recon bitwise the single-device run's, traces "
                   f"within rtol 1e-5, in both runs; "
                   f"{time.perf_counter() - t0:.1f} s with the processes' "
                   f"start [{smi}]")
            cs.rank_lines(name, runs, smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cs.log(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
