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
   every instantiation listed in ``tools/sass_digests.json`` compiled to
   the same code (the digests of ``tools/torch_sass_order.py``);
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
   ``torch.profiler`` at the last, the lossy K=1 launch's passes (d
   bfloat16) apart in the same session; the pair kernel's strip sweep: ms per
   pair at W = 8, 16, 64 and N1 (the whole-row schedule, the
   default), in turns with two fused-iteration launches, at rows of 2 to 16
   MB (STRIP_SWEEP), and ``run_solver`` x24 there (x16 at config 4), at
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
6. chunked runs: config 4 FISTA x50 in chunks of 25 through the chunk
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
7. the command line ``cytv-torch`` on the card: config 4 from a .npy
   file with ``--preset stem4d`` through ``cli.main`` in this process
   (launches, and the wall time split into load, solve and EMD write),
   and config 1, a synthetic low-dose EELS cube, from a .dm4 file with
   ``--preset eels3d`` through ``python -m cytvdn_tpu_torch.cli`` (the
   stop iteration and launches from its log); each recon bitwise the
   ``denoise4D``/``denoise3D`` run with the same arguments;
   ``--out-of-core 2 --shard 2`` in one process exits 2 with the
   ``torchrun`` to start; ``--backend cpp`` (the C++ host kernels, built
   with g++ from ``csrc/tvdn_cpu.cpp`` into ``cytvdn_tpu_torch/_build/``)
   on config 1 x200 in its own process, against ``--device cpu`` (the
   plain PyTorch version on the host) within rtol 1e-5, its solve's
   seconds and OpenMP threads. Where h5py is missing, the command's
   load-and-solve step stands in for it;
8. out-of-core runs (``solver/outofcore.py``): (a) the K=1 kernel with
   operand halos against its plain version with the same halos, 3
   launches each (state bitwise, sums within rtol 1e-5), FISTA and
   unaccelerated, 3D and 4D, float32 and float64, ragged shapes, the
   first, an interior and the last of three slabs with nonzero halo
   values, and the interior slabs the main path launches with halos
   (configs 4 and 2 in 4 slabs: (64,256,128,128) and (64,256,2048),
   float32); configs 2 and 3 cut into 1, 3 and 4 slabs with halos against
   one in-core launch (bitwise); ms of the halo launch at config 4's slab
   (64,256,128,128) FISTA, of the same launch without halos and of the
   plain version; (b) config 4 through ``denoise_outofcore``, 4 slabs,
   stream mode x4 and temporal K=8 x16, against ``denoise4D`` on the same
   cube (recon bitwise, traces within rtol 1e-5, at the sweep ends in
   temporal mode), with seconds per iteration, bytes and rates each way,
   the shares of two bounds taken from the fastest of 6 pinned copies of
   one slab array each way, measured here (one copy stream: the two
   directions one after the other; the PCIe link: both at once), peak
   device memory, launches, and the host memory
   pinned and its seconds; (c) config 2 in stream mode with stop 0.05
   and a reference cube against the K=1 loop (the same stop, recon
   bitwise, MSE within rtol 1e-5); (d) config 3 temporal K=4 killed after
   a checkpoint save and resumed (bitwise the uninterrupted run); (e)
   config 3 through ``cli.load_and_solve --out-of-core 3 --temporal 4``
   from a ``.npy`` (bitwise the API run); (f) multi-process out of core:
   processes of this script (``--cli-worker``, torchrun's environment,
   gloo) sharing the card run ``cli.load_and_solve``: config 4 x16
   ``--out-of-core 4 --temporal 8`` on 2 processes, each reading its 128
   rows of the ``.npy``, each rank's rows bitwise (b)'s temporal K=8
   recon, 24 pairs and 16 K=1 launches per rank, per rank the seconds of
   load, pin and solve, s per iteration, GB/s each way, the band
   exchange's seconds and bytes and the peak device memory, the host's
   available memory before; config 3 hybrid (8, 4) ``--out-of-core 2
   --temporal 4 --lossy-duals`` on 3 processes (43, 43 and 42 rows) with
   a part every 4 iterations, every process stopped after the first
   generation and killed, then resumed from 4 on every rank (the FISTA
   sweep in LOSSY pairs and K=1 launches), bitwise the in-core lossy run;
   slabs split over several cards: (iii) config 4 x16 ``--out-of-core 4
   --temporal 8 --shard 2`` on 2 processes, each reading its 128 columns,
   each rank's column block bitwise (b)'s temporal K=8 recon, 24 HALO1
   pairs and 16 K=1 HALO launches per rank, per rank the seconds of load,
   pin and solve, s per iteration, GB/s each way, the column exchange's
   calls, seconds and bytes and the peak device memory, beside (b)'s
   one-process run and (i)'s row split; then, in the same 2 processes,
   ``denoise_outofcore(shard_w=2)`` of a small seeded cube
   (``SPLIT_CALL``), rank 0's stitched recon (gathered through gloo)
   bitwise the one-process ``denoise_outofcore`` at the same K, through
   HALO1 pairs; (iv) config 3 hybrid (8, 4)
   ``--lossy-duals --out-of-core 2 --temporal 4 --shard 2`` on 4
   processes (a 2 x 2 grid: 64 rows x 64 columns each), a part every 4
   iterations, every process stopped after the first generation and
   killed, then resumed from 4 on every rank (the FISTA sweep in LOSSY
   HALO1 pairs and LOSSY K=1 HALO launches), each block bitwise the
   in-core lossy run;
9. sharded runs (``cytvdn_tpu_torch.parallel``): (a) the pair kernel with
   axis-0 bands (``HALO0``) against the plain pair with the same bands
   (state bitwise, sums within rtol 1e-5) on the first, an interior and
   the last 4-row slab of small cubes, FISTA and unaccelerated, with and
   without a reference cube, at forced grids and strips; the small cubes
   in 1-3 slabs with bands against one pair launch (bitwise); at config 4's
   2-rank shard (128,256,128,128) FISTA as the second rank (nonzero own row
   0, the cube's last row), the first rank with a reference cube, and an
   interior shard; ms per HALO0 pair there, of the pair without bands and
   of the plain pair; the K=1 kernel with halos against its plain version
   at the shards (c) and (e) launch it on, (128,128,128,128) with
   neighbours on axes 0 and 1 and (128,256,2048) with neighbours on axis 0
   (state bitwise); the pair kernel with axis-1 bands (``HALO1``) the same
   way on the first, an interior and the last column shard (2 and 3
   columns), FISTA, unaccelerated and LOSSY, and without a reference cube
   also against two K=1 HALO launches with the axis-1 halos the bands
   give; the small cubes in 2-4 column shards against one pair launch; at
   config 4's (1,2,1,1) shard (256,128,128,128) FISTA both ranks' sides
   and an interior shard, against the plain pair and two K=1 HALO
   launches, and ms per HALO1 pair there, of the pair without bands, of
   two K=1 HALO launches and of the plain pair, against its bound; (b)
   config 4 x20 on a (2,1,1,1) mesh of 2 processes
   of this script (``--sharded-worker``, torchrun's environment,
   ``init_distributed``, gloo) sharing the card, through
   ``denoise_sharded`` from a ``.npy``: each block and the gathered recon
   bitwise ``denoise4D``'s (sha256 digests), traces within rtol 1e-5, 10
   HALO0 pairs per rank; (b1) config 4 x20 on a (1,2,1,1) mesh of 2
   processes the same way, 10 HALO1 pairs per rank, bitwise the same
   single-device run, and x4 there on the K=1 loop (the pair rule set
   above every row), bitwise, for the exchange's bytes per two
   iterations either way; (d) at half of config 4's rows on (2,1,1,1) a
   stop run and an MSE x20 run, each stopping and ending as on one device,
   bitwise; (e) config 2 FISTA with stop 0.05 on (2,1,1), blocks read
   lazily, K=1 halo steps, bitwise; (c) config 4 x4 on a (2,2,1,1) mesh of
   4 processes on the K=1 loop, the default for 2D grids (4 K=1 halo
   launches per rank along both axes), bitwise, and the same with
   ``pairfix.PAIR_2D_GRIDS`` set, in 2 HALO0 pairs per rank with the
   axis-1 seam repair (``parallel/pairfix.py``), bitwise, each rank's
   seconds per iteration both ways and the seam repair's exchanges, bytes
   and seconds; (f) per rank
   the seconds per iteration, the exchange's seconds and bytes, the
   backend and the peak device memory; (g) the command line on meshes of 2
   processes of this script (``--cli-worker``: ``cli.load_and_solve``,
   with h5py also ``cli.write_output``, the steps of ``python -m
   cytvdn_tpu_torch.cli``), torchrun's environment, gloo: (i) config 4
   x20 FISTA ``--shard 2,1,1,1`` from the ``.npy``, each block and the
   gathered recon bitwise ``denoise4D``'s, 10 HALO0 pairs per rank, per
   rank the seconds of load, solve, gather and write; (ii) config 3 hybrid
   (20, 12) ``--shard 2,1,1,1 --checkpoint-every 8``, both processes
   killed once the second generation (master and part) is on disk, then
   ``--resume 1``: resumed from iteration 16 on both ranks, recon bitwise
   phase 6's uninterrupted run, per rank the seconds of each part save
   (copy to the host and write apart) and its bytes; (iii) the same with
   rank 1's part swapped for an older generation: both ranks warn and
   start afresh, bitwise. Any rank's failure fails the phase;
10. sharded runs in the K=1 kernel's mesh-only modes: (a) the kernel with
   ring halos (periodic), mirror halos with their edge flags, iso seams and
   corners and in-block halos of axes 2 and 3 against its plain version,
   bitwise — every mode of ``tests/torch_halo_blocks.py`` on small cubes
   (the first, an interior and the last block, FISTA and unaccelerated,
   float32 and float64, blocks reassembled against one launch) and one
   launch at each shard the meshes of (b) give it — and ms per launch at
   config 4's (2,1,1,1) shard with stem4d-iso's options and at config 2's
   periodic (2,1,1) shard against their bounds; (b) meshes of 2 and 4
   processes sharing the card against the single-device runs (sha256 of
   each block and of the gathered cube; traces within rtol 1e-5): config 4
   with stem4d-iso's options on (2,1,1,1) and (2,2,1,1), config 2 periodic
   and mirror on (2,1,1) and (2,2,1), config 4 Jia-Zhao on (1,1,2,1),
   config 3 iso Q on (1,1,2,2), a mirror stop run and a periodic MSE run
   at config 2, every iteration a K=1 launch in its mode; (c) per rank the
   seconds per iteration, the exchange's seconds and bytes and the peak
   device memory;
11. lossy shadow duals (``lossy_duals``: d stored as bfloat16): (a) the
   K=1 kernel's LOSSY instantiation against its plain version, 3
   iterations each, state bitwise with d, at ragged 3D and 4D shapes
   (last extents 1 and 33) at the wrapper's grid and forced grids of 1 and
   7 blocks, with halos on the first, an interior and the last of three
   slabs, on config 4's interior stream slab and on two mesh shards'
   operands, and on config 4's whole cube, compared off the card; the
   pair kernel's LOSSY instantiations (iteration 1's d rounded in the
   middle of the pair) against the plain pair and four LOSSY K=1 launches,
   two pairs each, state bitwise with d, at N0 = 4..7 and ragged shapes,
   with and without the reference cube, at forced grids of 1 and 7 blocks
   and a forced strip, with HALO0 bands on the first, an interior and the
   last slab (the stash against one plain K=1 step), ``round_bf16`` in
   CUDA against torch's bfloat16 cast on canary values (through the
   stash), and on config 4's whole cube against two plain iterations
   (off the card) and two LOSSY K=1 launches (on it); the K-step kernel's
   LOSSY instantiations (every level's d rounded at its store) against
   the plain version, K LOSSY K=1 launches and K/2 LOSSY pairs at every
   depth, N0 = 2K and 2K+1, 3D and 4D, at forced grids of 1 and 7 blocks
   and its tile edges, and one K=8 launch on config 4's whole cube against
   8 plain lossy iterations (off the card); (b) config 4 through
   ``denoise4D(lossy_duals=True)`` x20: 2 LOSSY K=8 launches, 2 LOSSY
   pairs and no other launch, recon bitwise the lossy K=1 loop's, s per
   iteration with and without the host copies, the peak device memory,
   the recon's rel-L2 against the exact run, and ms of one lossy K=8
   launch, the exact K=8, one lossy K=1 launch, one lossy pair (with and
   without the reference cube), the exact pair and their plain versions
   at config 4 against the lossy bounds (d at 2 bytes); config 2 lossy
   x24 (3 LOSSY K=8 launches) bitwise the lossy K=1 loop, and ms of the
   lossy K=8, the exact K=8 and the lossy K=1 launch there; a lossy MSE
   x20 in REF+LOSSY pairs and a lossy stop run on K-steps behind the
   guard, each bitwise the lossy K=1 loop; (c) config 4 lossy in
   stream mode, 4 slabs x2, and in temporal mode, K=8 in 4 slabs x16,
   each bitwise the in-core lossy run, s per iteration and GB/s each way;
   (d) a small 4D cube lossy x4 on a (2, 1, 1, 1) and a (1, 2, 1, 1) mesh
   of 2 processes sharing the card, in LOSSY HALO0 and LOSSY HALO1 pairs,
   bitwise the single-device lossy run. Phase 1's SASS check covers the 4
   LOSSY instantiations of the K=1 dual pass and the 12 of the pair kernel
   (no store in flight, no local memory), the pair kernel's 12 HALO1
   instantiations (no store in flight), and the 8 of the K-step kernel
   (no store in flight; no
   local memory in 3D, no more than the exact twin in the capped 4D
   launch, which spills);
12. one JSON line on the kernels (launches on the path that reaches each,
   error, ms, the plain version's ms and the least time the card could
   take), the card's name and power limit, and the ``{"ok": true, ...}``
   line last.

Needs one CUDA device; exits non-zero without one. Inputs are made from
fixed seeds. ``--sharded-worker SPEC`` runs one rank of a phase-9 or
phase-10 mesh, ``--cli-worker SPEC`` one rank of a phase-8 (f) or phase-9
(g) command line (both started by the script itself).
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from cytvdn_tpu_torch import api, denoise3D, denoise4D, ops
from cytvdn_tpu_torch.config import SolverOptions
from cytvdn_tpu_torch.kernels import build
from cytvdn_tpu_torch.kernels import fused as fused_mod
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
from cytvdn_tpu_torch.kernels import temporal as temporal_mod
from cytvdn_tpu_torch.kernels.temporal import (
    cooperative_grid,
    fused_pair_iteration,
    fused_pair_iteration_reference,
    halo0_bands,
    halo1_bands,
)
from cytvdn_tpu_torch.solver import engine, outofcore
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

# phase 10 builds its blocks' halos with the tests' builder (numpy or torch)
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))

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
# (whole rows won or tied at every row size swept, PERF.md section 6; the
# sweep keeps three widths)
STRIP_WIDTHS = (8, 16, 64)
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


#: the page-locked host buffers ``offcard_equal`` copies states into within
#: ``pinned_copies``; None outside it (pageable copies)
_PINNED = None


@contextlib.contextmanager
def pinned_copies():
    """Within it, :func:`offcard_equal` copies its states to page-locked
    host buffers (exact-size ``cudaHostAlloc``, ``build.host_empty``),
    allocated by the first comparison, reused by the next ones and freed at
    the end: a config-4 state (38.6 GB) then crosses the link at the
    page-locked rate, several times the pageable one, and is pinned once
    for all of a phase's comparisons."""
    global _PINNED
    _PINNED = []
    try:
        yield
    finally:
        _PINNED = None


def host_copy(i: int, x: torch.Tensor) -> torch.Tensor:
    """``x`` (on the card) on the host: in the ``i``-th page-locked buffer
    within :func:`pinned_copies` (``i`` counting up from 0 over a state's
    arrays), else a pageable copy."""
    if _PINNED is None:
        return x.cpu()
    nbytes = x.numel() * x.element_size()
    if len(_PINNED) == i:
        _PINNED.append(build.host_empty((nbytes,), np.uint8))
    elif _PINNED[i].size < nbytes:
        _PINNED[i] = build.host_empty((nbytes,), np.uint8)
    h = torch.from_numpy(_PINNED[i][:nbytes]).view(x.dtype).view(x.shape)
    h.copy_(x)
    return h


def offcard_equal(shape, fista, runs, lossy=False):
    """At a state too large to hold twice on the card (Jia-Zhao, float32;
    with ``lossy``, FISTA's d cast to bfloat16): ``runs`` is a list of
    (name, fn), fn(orig, state, li, lm, rho) updating ``state`` in place
    and returning its sums. The first run's state is kept on the host; each
    later run starts from the same state rebuilt from the seed, and each of
    its arrays is brought back alone and compared bitwise with the host
    copy, its sums within rtol 1e-5. Returns max |Δstate| and the sums'
    largest relative difference."""
    def run(fn):
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        orig, state, li, lm, rho = random_state(shape, fista, torch.float32,
                                                gen, jz=True)
        if lossy:
            for i in range(1 + len(shape), len(state)):
                state[i] = state[i].to(torch.bfloat16)
        sums = fn(orig, state, li, lm, rho)
        return state, sums.double().cpu()

    (first, fn), *rest = runs
    state, want_sums = run(fn)
    host = [host_copy(i, x) for i, x in enumerate(state)]
    del state
    torch.cuda.empty_cache()
    err, rel = 0.0, 0.0
    for name, fn in rest:
        state, sums = run(fn)
        bitwise = True
        for i, p in enumerate(state):
            k = host[i].cuda()
            err = max(err, (k.float() - p.float()).abs().max().item())
            bitwise = bitwise and k.dtype == p.dtype and torch.equal(k, p)
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


def compare_kstep_offcard(shape, fista, k, lossy=False):
    """One K-step launch of depth ``k`` at the wrapper's defaults (the full
    cooperative grid, ``kstep_rows`` rows per stage) and ``k`` plain
    iterations from the same state, with distinct momentum ratios, compared
    off the card (``offcard_equal``; ``lossy``: d bfloat16): every array
    bitwise, the 3k sums within rtol 1e-5."""
    rhos = torch.linspace(0.0, 0.6, k, device="cuda")

    def kstep(step):
        return lambda orig, state, li, lm, _: kstep_fn(
            step, orig, state, li, lm, rhos, k, fista)()

    return offcard_equal(shape, fista, [
        ("K-step kernel", kstep(fused_kstep_iteration)),
        ("plain", kstep(fused_kstep_iteration_reference))], lossy=lossy)


def kernel_args(mangled: str):
    """(kernel name, template arguments) of a kernel instantiation's
    mangled name, the arguments as strings ("f", "4", "1", ...)."""
    k = re.search(r"([a-z]+_kernel)I(.+?)EEv", mangled)
    return k.group(1), [a or b for a, b in re.findall(
        r"([fd])(?=L|E|$)|L[ib](\d+)", k.group(2))]


def ptxas_summary(log: str) -> str:
    """Registers, spill stores/loads and stack frame of every kernel
    instantiation, from the build log's ``ptxas -v`` lines, as
    ``name<template args> R regs, spill S/L, stack F``."""
    rows, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            kname, args = kernel_args(m.group(1))
            name = f"{kname}<{','.join(args)}>"
            spill = stack = ""
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            stack, spill = m.group(1), f"{m.group(2)}/{m.group(3)}"
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            rows.append(f"{name} {m.group(1)} regs, spill {spill}, "
                        f"stack {stack}")
    return "; ".join(rows)


def store_order():
    """Each instantiation of the K=1 kernel's dual pass, of the pair kernel
    and of the K-step kernel's two entry points in the built library's SASS
    (``tools/torch_sass_order.py``), by kernel name: (template arguments,
    <T,ND,FISTA,HALO,ISO,LOSSY> of dual_kernel, <ND,FISTA,REF,HALO,LOSSY>
    of pair_kernel (HALO 0 none, 1 axis-0 bands, 2 axis-1 bands),
    <ND,FISTA,K,LOSSY> of kstep_kernel or <K,LOSSY> of kstepcap_kernel;
    ISO; LOSSY; stores; stores sent while their own load is in flight; LDL;
    STL); under "digests", a digest of every kernel instantiation's
    instructions by its label."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "tools"))
    import torch_sass_order as so

    rows = {"dual_kernel": [], "pair_kernel": [], "kstep_kernel": [],
            "kstepcap_kernel": []}
    sass = so.library_sass()
    # every kernel's instantiations by their code (tools/sass_digests.json)
    rows["digests"] = so.digests(sass, ["_kernel"])
    for mangled, fn in so.functions(sass):
        name = next((k for k in rows if k in mangled), None)
        if name is None:
            continue
        _, args = kernel_args(mangled)
        stores, _, in_flight = so.store_order(fn)
        iso = name == "dual_kernel" and args[4] == "1"
        rows[name].append((f"<{','.join(args)}>", iso, args[-1] == "1",
                           stores, len(in_flight), *so.local_memory(fn)))
    return rows


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
                       plain_only=False, rows=None, lossy=False):
    """``launches`` launches of the K-step kernel of depth ``k`` (at each
    forced grid of ``grids``, None the full cooperative grid; at ``rows``
    axis-0 rows per stage, None the wrapper's default) against
    its plain version and, unless ``plain_only``, K fused-iteration
    launches and (K even) K/2 pair launches per launch, from the same
    Jia-Zhao state with distinct momentum ratios (``lossy``: FISTA's d
    bfloat16, the LOSSY instantiations of all three kernels): state bitwise
    equal, d included, sums within rtol 1e-5. Returns max |Δstate|."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    orig, state, li, lm, _ = random_state(shape, fista, torch.float32, gen,
                                          jz=True)
    if lossy:
        for i in range(1 + len(shape), len(state)):
            state[i] = state[i].to(torch.bfloat16)
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
        err = max(err, max((a.float() - b.float()).abs().max().item()
                           for a, b in zip(ks, ps)))
        require(all(a.dtype == b.dtype and torch.equal(a, b)
                    for a, b in zip(ks, ps)),
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
def pairs_at_any_row(min_bytes=0):
    """Set the engine's row-size rule for pairs (``_pairs_pay``) to
    ``min_bytes``: 0 lifts it, so that a small cube runs its phases in
    pairs; infinity keeps every phase on the K=1 loop."""
    saved = engine.PAIR_MIN_ROW_BYTES
    engine.PAIR_MIN_ROW_BYTES = min_bytes
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
    fused_kstep_iteration.lossy_launches = 0
    fused_pair_iteration.launches = 0
    fused_pair_iteration.lossy_launches = 0
    fused_iteration.launches = 0
    fused_iteration.halo_launches = 0
    fused_iteration.mode_launches = 0
    fused_iteration.lossy_launches = 0


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


def profile_kernels(shape, iters=6, kstep=None, lossy=False):
    """Device ms per FISTA float32 iteration of each CUDA kernel, from
    ``torch.profiler``'s device events, over ``iters`` iterations run
    as fused-iteration launches, then as pair-kernel launches, then (with
    ``kstep`` = K) as K-step launches, and the bytes per second that the
    traffic model's traversals imply: the dual pass 4n+1 (17 in 4D), the
    reconstruction pass n+3, the pair and K-step kernels the two-pass 5n+4
    per iteration (the top of their bands). With ``lossy``, ``iters``
    lossy fused-iteration launches follow in the same session on the same
    state, its d cast to bfloat16; each launch runs one dual, one recon
    and one finalize kernel, so the lossy launches' are the last
    ``iters`` of each, reported apart (the dual pass then moves 12n+4
    bytes per voxel, 52 in 4D)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    orig, state, li, lm, rho = random_state(shape, True, torch.float32, gen,
                                            jz=True)
    n = len(shape)
    runs = [(pair_fn(two_k1, orig, state, li, lm, rho, True), iters // 2),
            (pair_fn(fused_pair_iteration, orig, state, li, lm, rho, True),
             iters // 2)]
    if kstep:
        rhos = torch.full((kstep,), 0.37, device="cuda")
        runs.append((kstep_fn(fused_kstep_iteration, orig, state, li, lm,
                              rhos, kstep, True), iters // kstep))
    for fn, _ in runs:
        fn()
    if lossy:
        # the LOSSY instantiation's first launch, outside the session
        small = random_state((4, 4, 4, 4)[:n], True, torch.float32, gen,
                             jz=True)
        small[1][1 + n:] = [d.to(torch.bfloat16) for d in small[1][1 + n:]]
        step_fn(fused_iteration, small[0], small[1], *small[2:], True)()
        del small
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fn, k in runs:
            for _ in range(k):
                fn()
        if lossy:
            for i in range(1 + n, len(state)):
                state[i] = state[i].to(torch.bfloat16)
            fn = step_fn(fused_iteration, orig, state, li, lm, rho, True)
            for _ in range(iters):
                fn()
        torch.cuda.synchronize()
    del orig, state, runs
    torch.cuda.empty_cache()
    nvox = int(np.prod(shape))
    # bytes per voxel each kernel moves per iteration
    per_vox = {"dual_kernel": 4 * (4 * n + 1), "recon_kernel": 4 * (n + 3),
               "finalize_kernel": 0, "pair_kernel": 4 * (5 * n + 4),
               "kstep_kernel": 4 * (5 * n + 4)}
    lossy_vox = {"dual_kernel": 12 * n + 4, "recon_kernel": 4 * (n + 3),
                 "finalize_kernel": 0}
    events = sorted((e for e in prof.events()
                     if e.device_type != DeviceType.CPU),
                    key=lambda e: e.time_range.start)

    def row(key, evs, bpv, label=""):
        # the launches of ``evs`` covered ``iters`` iterations
        ms = sum(e.device_time_total for e in evs) / 1e3 / iters
        rate = bpv * nvox / (ms / 1e3) if bpv and ms > 0 else None
        return f"{label}{key} {ms:.3f} ms" + (
            f" ({bpv} B per voxel, {rate / 1e12:.2f} TB/s)" if rate else "")

    rows, lossy_rows = [], []
    for key, bpv in per_vox.items():
        evs = [e for e in events if key in e.name]
        if not evs:
            continue
        if lossy and key in lossy_vox:
            if len(evs) != 2 * iters:
                lossy_rows.append(f"{key}: {len(evs)} device events, not "
                                  f"{2 * iters}; not measured")
                continue
            lossy_rows.append(row(key, evs[iters:], lossy_vox[key], "lossy "))
            evs = evs[:iters]
        rows.append(row(key, evs, bpv))
    return rows + lossy_rows


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


def cfg2_eels():
    """Config 2 as a clean piecewise-constant 3D cube and its noisy copy
    on the host, from the fixed seed: the relative change stays above 0.05
    for the first few iterations (σ = 2 against steps of 0.5 and 1)."""
    rng = np.random.default_rng(SEED + 1)
    tiles = ((np.arange(CFG2[0]) // 64)[:, None]
             + (np.arange(CFG2[1]) // 64)[None, :]) % 2
    clean = np.empty(CFG2, np.float32)
    clean[...] = (1.0 + 0.5 * tiles)[:, :, None]
    clean[:, :, CFG2[2] // 2:] += 1.0   # a step along the energy axis
    noisy = clean + rng.standard_normal(CFG2, dtype=np.float32) * np.float32(2.0)
    return clean, noisy


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

    # (a) config 4 x50 in memory: progress chunks of 25 and run_chunked
    # with checkpoint_every=25 against the unchunked run_solver
    t_a = time.perf_counter()
    n_a, every_a = 50, 25
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
    # phase 9 (g) (ii) holds the command's resumed mesh run to this recon
    cfg3_digest = digest(want_c["recon"])
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
    return cfg3_digest


def eels_3d(shape, seed, dose=0.5):
    """A synthetic low-dose EELS spectrum image: Poisson counts of a
    power-law background with an edge halfway along the energy axis, its
    amplitude a checkerboard of 16×16 scan tiles (0.29 counts per voxel at
    the default dose)."""
    e = np.arange(shape[2], dtype=np.float64)
    spec = 64.0 / (e + 32.0)
    half = shape[2] // 2
    spec[half:] += 0.5 * np.exp(-(e[half:] - half) / 128.0)
    tiles = ((np.arange(shape[0]) // 16)[:, None]
             + (np.arange(shape[1]) // 16)[None, :]) % 2
    lam = dose * (1.0 + 0.5 * tiles)[:, :, None] * spec[None, None, :]
    return np.random.default_rng(seed).poisson(lam).astype(np.float32)


def cli_log_value(pattern, text, what):
    m = re.search(pattern, text)
    require(m is not None, f"the command's log has no {what}: {text[-2000:]}")
    return m.groups()


def cli_phase(smi, cube):
    """Phase 7: the command line ``cytv-torch`` on the card. (a) config 4
    from a .npy file, ``--preset stem4d``, in this process; (b) config 1,
    a synthetic EELS cube, from a .dm4 file, ``--preset eels3d``, as a
    separate process; each recon bitwise the API's run with the same
    arguments. (c) ``--out-of-core 2 --shard 2`` in one process exits 2
    with the ``torchrun`` to start (phase 8 (f) runs it on processes);
    ``--backend cpp`` on config 1 x200 in its own process against the
    command's ``--device cpu`` run of the same file (the plain PyTorch
    version on the host), within rtol 1e-5."""
    from cytvdn_tpu_torch import cli
    from cytvdn_tpu_torch.io.dm import write_dm

    try:
        import h5py  # noqa: F401
        has_h5py = True
    except ImportError:
        has_h5py = False
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="cytv_cli_")
    root = os.path.dirname(os.path.abspath(__file__))
    try:
        free = shutil.disk_usage(tmp).free
        log(f"phase 7 the command line: h5py "
            f"{'imports' if has_h5py else 'is missing, so the EMD output cannot be written here: the command load-and-solve step (cli.load_and_solve) runs in place of cli.main'}; "
            f"{free / 1e9:.1f} GB free in the temporary directory")
        if has_h5py:
            from cytvdn_tpu_torch.io.emd import read_emd

        # (a) config 4, in this process
        npy = os.path.join(tmp, "config4.npy")
        out = os.path.join(tmp, "config4.emd")
        t0 = time.perf_counter()
        np.save(npy, cube)
        s_save = time.perf_counter() - t0
        argv = ["-i", npy, "-o", out, "-m", "1.0", "--preset", "stem4d",
                "-v", "0"]
        seconds = {}
        reset_counts()
        t0 = time.perf_counter()
        if has_h5py:
            rc = cli.main(argv, seconds=seconds)
            wall = time.perf_counter() - t0
            la = launch_counts()
            require(rc == 0, f"cytv-torch (config 4) returned {rc}")
        else:
            run = cli.load_and_solve(argv)
            wall = time.perf_counter() - t0
            la = launch_counts()
            seconds, got = run.seconds, run.recon
            del run
        os.remove(npy)
        s_read = 0.0
        if has_h5py:
            t0 = time.perf_counter()
            got = read_emd(out)
            s_read = time.perf_counter() - t0
            os.remove(out)
        want4 = expected_launches(SolverOptions(
            ndim=4, iterations_fista=10, iterations_unacc=0), CFG4)
        require(la == want4, f"cytv-torch config 4 launches {la}, "
                             f"expected {want4}")
        t0 = time.perf_counter()
        want = denoise4D(cube, np.full(4, 1.0, np.float32), iterations=10,
                         FISTA=True, BC_mode=2, quiet=True, device="cuda")[0]
        s_api = time.perf_counter() - t0
        require(got.shape == CFG4 and got.dtype == np.float32,
                f"config 4 output {got.shape} {got.dtype}")
        require(np.array_equal(got, want),
                "cytv-torch config 4 recon not bitwise denoise4D's")
        del got, want
        split = ", ".join(f"{k} {v:.3f} s" for k, v in seconds.items())
        log(f"phase 7 (a) cytv-torch --preset stem4d on {CFG4} float32 "
            f"from .npy ({cube.nbytes / 1e9:.3f} GB), in process: rc 0, "
            f"recon bitwise denoise4D's with the same arguments; wall "
            f"{wall:.3f} s = {split} (load maps the file; solve reads it "
            f"from the page cache and includes the copies to and from the "
            f"card); denoise4D on the cube in memory {s_api:.3f} s; "
            f"launches whole-run/K-step/pair/fused {la}; set-up np.save "
            f"{s_save:.3f} s, EMD read-back {s_read:.3f} s [{smi}]")

        # (b) config 1 from a .dm4 file, as its own process
        cube_e = eels_3d(CFG1, SEED + 4)
        dm4 = os.path.join(tmp, "config1.dm4")
        out1 = os.path.join(tmp, "config1.emd")
        write_dm(dm4, cube_e, version=4)
        argv1 = ["-i", dm4, "-o", out1, "-m", "1.0", "--preset", "eels3d",
                 "-v", "1"]
        if has_h5py:
            cmd = [sys.executable, "-m", "cytvdn_tpu_torch.cli", *argv1]
        else:
            out1 = os.path.join(tmp, "config1.npy")
            cmd = [sys.executable, "-c",
                   "import sys, numpy as np; from cytvdn_tpu_torch import cli; "
                   "r = cli.load_and_solve(sys.argv[2:]); "
                   "np.save(sys.argv[1], r.recon)", out1, *argv1]
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, env.get("PYTHONPATH")) if p)
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                              text=True, timeout=300)
        s_proc = time.perf_counter() - t0
        require(proc.returncode == 0,
                f"cytv-torch (config 1) rc {proc.returncode}: "
                f"{proc.stderr[-3000:]}")
        got1 = read_emd(out1) if has_h5py else np.load(out1)
        n_cli, = cli_log_value(r"; (\d+) iterations; final delta",
                               proc.stdout, "iteration count")
        l_cli = tuple(int(x) for x in cli_log_value(
            r"kernel launches: whole-run (\d+), K-step (\d+), pair (\d+), "
            r"K=1 (\d+)", proc.stdout, "launch counts"))
        s_load, = cli_log_value(r"loaded .* in ([0-9.]+)s", proc.stdout,
                                "load time")
        s_solve, = cli_log_value(r"denoising took ([0-9.]+)s", proc.stdout,
                                 "solve time")
        s_write = (cli_log_value(r"wrote .* in ([0-9.]+)s", proc.stdout,
                                 "write time")[0] + " s") if has_h5py \
            else "not run"
        reset_counts()
        t0 = time.perf_counter()
        r1, _, d1 = denoise3D(cube_e, np.full(3, 1.0, np.float32),
                              iterations=7500, FISTA=False, BC_mode=2,
                              stopping_relative_change=0.05, quiet=True,
                              device="cuda")
        l_api = launch_counts()
        s_api = time.perf_counter() - t0
        n_api = int(np.count_nonzero(d1))
        require(np.array_equal(got1, r1),
                "cytv-torch config 1 recon not bitwise denoise3D's")
        require(int(n_cli) == n_api and n_api < 7500,
                f"config 1 stop: the command ran {n_cli} iterations, "
                f"denoise3D {n_api}")
        require(l_cli == l_api, f"config 1 launches: the command {l_cli}, "
                                f"denoise3D {l_api}")
        how = "python -m cytvdn_tpu_torch.cli" if has_h5py \
            else "cli.load_and_solve (no EMD written)"
        log(f"phase 7 (b) {how} --preset eels3d on {CFG1} float32 "
            f"(synthetic EELS counts, mean {cube_e.mean():.3f}) from .dm4, "
            f"its own process: rc "
            f"0, stop after {n_cli} iterations as denoise3D, recon bitwise "
            f"denoise3D's; launches whole-run/K-step/pair/fused {l_cli}; "
            f"the process {s_proc:.3f} s, of which load {s_load} s, solve "
            f"{s_solve} s, write {s_write}; denoise3D in this process "
            f"{s_api:.3f} s [{smi}]")

        # (c) the command itself: its help, and a flag it refuses before
        # the input is read
        for flags, rc_want, item in (
                (["--help"], 0, None),
                # slabs split over 2 cards need 2 processes
                (["-i", dm4, "-o", out1, "-m", "1.0", "-n", "2",
                  "--out-of-core", "2", "--shard", "2"], 2,
                 "this launch has 1 (WORLD_SIZE), not a multiple of 2; "
                 "start 2 (or a multiple): torchrun --nproc-per-node 2")):
            proc = subprocess.run(
                [sys.executable, "-m", "cytvdn_tpu_torch.cli", *flags],
                cwd=root, env=env, capture_output=True, text=True,
                timeout=120)
            said = proc.stderr.strip() if item else proc.stdout.split("\n")[0]
            require(proc.returncode == rc_want and (
                item in said if item
                else said.startswith("usage: cytv-torch")),
                f"{flags}: rc {proc.returncode}, {proc.stdout!r} "
                f"{proc.stderr!r}")
            log(f"phase 7 (c) python -m cytvdn_tpu_torch.cli "
                f"{' '.join(flags[8:]) if item else flags[0]}: rc "
                f"{proc.returncode}, {said}")
        cpp_phase(smi, cli, dm4, out1, tmp, root, env)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 7 {time.perf_counter() - t_phase:.1f} s")


#: iterations of phase 7 (c)'s ``--backend cpp`` run at config 1 (the
#: ``--device cpu`` run beside it took 108 ms per iteration on the host of
#: an NVIDIA H100 80GB HBM3, 700 W machine)
CPP_ITERS = 200


def cpp_phase(smi, cli, dm4, out1, tmp, root, env):
    """Phase 7 (c), ``--backend cpp``: the command on config 1's .dm4 x200
    unaccelerated in its own process (it builds ``csrc/tvdn_cpu.cpp`` with
    g++ where the build is stale), against the command's ``--device cpu``
    run of the same file in this process, within rtol 1e-5; the solve's
    seconds of both and the C++ kernels' OpenMP threads."""
    from cytvdn_tpu_torch.cpp import native_num_threads

    argv = ["-i", dm4, "-o", out1, "-m", "1.0", "-n", str(CPP_ITERS)]
    out_c = os.path.join(tmp, "config1_cpp.npy")
    cmd = [sys.executable, "-c",
           "import sys, numpy as np; from cytvdn_tpu_torch import cli; "
           "r = cli.load_and_solve(sys.argv[2:]); np.save(sys.argv[1], "
           "r.recon)", out_c, *argv, "-v", "1", "--backend", "cpp"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                          text=True, timeout=300)
    s_proc = time.perf_counter() - t0
    require(proc.returncode == 0,
            f"cytv-torch --backend cpp rc {proc.returncode}: "
            f"{proc.stderr[-3000:]}")
    s_cpp, = cli_log_value(r"denoising took ([0-9.]+)s", proc.stdout,
                           "solve time")
    threads, = cli_log_value(r"the C\+\+ host kernels on (\d+) OpenMP",
                             proc.stdout, "threads")
    got = np.load(out_c)
    plain = cli.load_and_solve(argv + ["-v", "0", "--device", "cpu"])
    rel = float(np.max(np.abs(got - plain.recon)
                       / np.maximum(np.abs(plain.recon), 1e-30)))
    require(got.shape == plain.recon.shape and rel <= 1e-5,
            f"--backend cpp recon against --device cpu: max rel {rel}")
    n_threads = native_num_threads()
    log(f"phase 7 (c) --backend cpp on {CFG1} x{CPP_ITERS} unaccelerated "
        f"from .dm4, its own process (rc 0, {s_proc:.3f} s in all): solve "
        f"{s_cpp} s on {threads} OpenMP threads (native_num_threads() "
        f"{n_threads} here); --device cpu, the plain PyTorch version on the "
        f"host, solve {plain.seconds['solve']:.3f} s; recon max rel "
        f"{rel:.3e} (rtol 1e-5) [{smi}]")


# phase 8: the K=1 kernel's halos on ragged slabs (3D and 4D), the
# configurations cut into slabs, and the config-4 slab of a 4-slab run
HALO_SHAPES = [(15, 45, 19, 23), (12, 13, 70), (9, 9, 10, 33), (7, 5, 3, 129)]
SLAB4 = (CFG4[0] // 4,) + CFG4[1:]


class Killed(Exception):
    """Raised by phase 8's checkpoint hook: the run is killed there."""


def seams(state, ndim, a0, a1, fista):
    """Slab [a0, a1)'s seam operands from a cube's state ([recon, accs...,
    ds...]) as the stream mode gives them: axis 0 from the neighbours (the
    own edge rows at the cube's edges, zero acc/d past the last), axis 1
    the Jia-Zhao edge values."""
    n0 = state[0].shape[0]
    r, acc0 = state[0], state[1]
    own = r[a0:a1]
    zc = torch.zeros_like(own[:, 0:1])
    last = a1 == n0
    h = {"prev0": r[a0 - 1:a0] if a0 > 0 else own[0:1],
         "prev1": own[:, 0:1], "next1_recon": own[:, -1:], "next1_acc": zc,
         "next0_recon": own[-1:] if last else r[a1:a1 + 1],
         "next0_acc": torch.zeros_like(own[-1:]) if last
         else acc0[a1:a1 + 1]}
    if fista:
        d0 = state[1 + ndim]
        h["next0_d"] = torch.zeros_like(own[-1:]) if last else d0[a1:a1 + 1]
        h["next1_d"] = zc
    return {k: v.contiguous() for k, v in h.items()}


def block_seams(state, ndim, fista):
    """The seam operands of the block [1:-1, 1:-1] of a state, both axes
    from the neighbours, as an interior shard of a (2, 2, ...)-style mesh
    takes them (``engine._k1_halos``): ``prev{ax}`` the -1 neighbour's last
    recon slab, ``next{ax}_*`` the +1 neighbour's first recon, accumulator
    and shadow-dual slabs along ``ax``."""
    r, accs = state[0], state[1:1 + ndim]
    inner = (slice(1, -1), slice(1, -1))
    h = {"prev0": r[0:1, inner[1]], "next0_recon": r[-1:, inner[1]],
         "next0_acc": accs[0][-1:, inner[1]],
         "prev1": r[inner[0], 0:1], "next1_recon": r[inner[0], -1:],
         "next1_acc": accs[1][inner[0], -1:]}
    if fista:
        ds = state[1 + ndim:]
        h["next0_d"] = ds[0][-1:, inner[1]]
        h["next1_d"] = ds[1][inner[0], -1:]
    return {k: v.contiguous() for k, v in h.items()}


def compare_halo_case(shape, fista, dtype, where, iters=3):
    """``iters`` launches with halos against the plain version with the same
    halos, on the first, an interior or the last of three slabs of a random
    state of ``shape``, or (``where="slab"``) on the interior slab of
    ``shape`` itself, cut from a state one row longer on each side (nonzero
    axis-0 halo values), or (``where="block"``) on ``shape`` itself cut
    from a state one row and one column longer on each side (nonzero
    axis-0 and axis-1 halo values): state bitwise, sums within rtol 1e-5.
    Returns the largest |difference| of the state."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    n = shape[0]
    ndim = len(shape)
    if where == "slab":
        shape = (n + 2,) + tuple(shape[1:])
        a0, a1 = 1, n + 1
    elif where == "block":
        shape = (n + 2, shape[1] + 2) + tuple(shape[2:])
    else:
        n //= 3
        a0, a1 = {"first": (0, n), "interior": (n, 2 * n),
                  "last": (2 * n, shape[0])}[where]
    orig, state, li, lm, rho = random_state(shape, fista, dtype, gen)
    if where == "block":
        cut = (slice(1, -1), slice(1, -1))
        h = block_seams(state, ndim, fista)
    else:
        cut = (slice(a0, a1),)
        h = seams(state, ndim, a0, a1, fista)
    o = orig[cut].contiguous()
    runs = []
    for step in (fused_iteration, fused_iteration_reference):
        st = [x[cut].clone() for x in state]
        fn = step_fn(step, o, st, li, lm, rho, fista, halos=h)
        sums = [torch.stack(fn()[3:]).double().cpu() for _ in range(iters)]
        torch.cuda.synchronize()
        runs.append((st, torch.stack(sums)))
    (ks, ksum), (ps, psum) = runs
    err = max((a - b).abs().max().item() for a, b in zip(ks, ps))
    require(all(torch.equal(a, b) for a, b in zip(ks, ps)),
            f"halo kernel {shape} {where} fista={fista} {dtype}: state "
            f"differs from the plain version (max |Δ| {err})")
    torch.testing.assert_close(ksum, psum, rtol=1e-5, atol=0)
    del runs, ks, ps, st, fn, state, orig, h, o
    torch.cuda.empty_cache()
    return err


def slabs_equal_one_launch(shape, fista, n_slabs):
    """A Jia-Zhao state cut into ``n_slabs`` axis-0 slabs, each launched
    with halos from the pre-update state and put back: bitwise one
    in-core launch."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    orig, state, li, lm, rho = random_state(shape, fista, torch.float32, gen,
                                            jz=True)
    ndim = len(shape)
    whole = [x.clone() for x in state]
    step_fn(fused_iteration, orig, whole, li, lm, rho, fista)()
    cut = [x.clone() for x in state]
    for a0, a1 in outofcore._slab_bounds(shape[0], n_slabs):
        st = [x[a0:a1].clone() for x in state]
        step_fn(fused_iteration, orig[a0:a1].contiguous(), st, li, lm, rho,
                fista, halos=seams(state, ndim, a0, a1, fista))()
        for dst, src in zip(cut, st):
            dst[a0:a1] = src
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(cut, whole)),
            f"{shape} fista={fista} in {n_slabs} slabs with halos != one "
            f"launch")
    del whole, cut, state, orig
    torch.cuda.empty_cache()


def time_halo(shape, n_kernel, n_plain):
    """ms per launch at the slab ``shape`` FISTA f32 of the kernel with
    halos (an interior slab), without halos, and of the plain version with
    halos, in turns (plain, halo, no halo, no halo, halo, plain)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    orig, state, li, lm, rho = random_state(shape, True, torch.float32, gen)
    ndim = len(shape)
    # an interior slab's seams: rows and columns of nonzero values
    r, acc0, d0 = state[0], state[1], state[1 + ndim]
    h = {k: v.contiguous().clone() for k, v in (
        ("prev0", r[-1:]), ("prev1", r[:, -1:]),
        ("next0_recon", r[:1]), ("next0_acc", acc0[-1:]),
        ("next0_d", d0[-1:]), ("next1_recon", r[:, :1]),
        ("next1_acc", acc0[:, -1:]), ("next1_d", d0[:, -1:]))}
    fns = {"halo": step_fn(fused_iteration, orig, state, li, lm, rho, True,
                           halos=h),
           "k1": step_fn(fused_iteration, orig, state, li, lm, rho, True),
           "plain": step_fn(fused_iteration_reference, orig, state, li, lm,
                            rho, True, halos=h)}
    raw = {k: [] for k in fns}
    for name in ("plain", "halo", "k1", "k1", "halo", "plain"):
        raw[name].append(time_ms(fns[name],
                                 n_plain if name == "plain" else n_kernel))
    del state, orig, h, fns
    torch.cuda.empty_cache()
    return {k: sum(v) / len(v) for k, v in raw.items()}, raw


def link_rates(numel, n=6):
    """GB/s of the fastest of ``n`` pinned copies of ``numel`` floats (one
    slab array) to the card and back, each timed alone after one warm-up:
    the link's rate that the out-of-core runs' bound is taken from."""
    h = torch.empty(numel, pin_memory=True)
    d = torch.empty(numel, device="cuda")
    rates = {}
    for kind, fn in (("h2d", lambda: d.copy_(h, non_blocking=True)),
                     ("d2h", lambda: h.copy_(d, non_blocking=True))):
        rates[kind] = max(numel * 4 / (time_ms(fn, 1) / 1e3) / 1e9
                          for _ in range(n))
    del h, d
    return rates


def ooc_run(fn):
    """``fn()`` (an out-of-core run) with the launch counts set to 0 just
    before it; returns (its result, launches incl. halo launches, the
    run's ``last_run`` record, peak device memory)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return (out, launch_counts() + (fused_iteration.halo_launches,),
            dict(outofcore.last_run), torch.cuda.max_memory_allocated())


def outofcore_phase(smi, name, cube, cube3):
    """Phase 8: out-of-core runs on the card. (a) the K=1 kernel's halos
    against the plain version, and configs 2 and 3 cut into slabs against
    one launch, and the halo launch timed at config 4's slab; (b) config 4
    through ``denoise_outofcore`` in stream mode (×4) and temporal K=8
    (×16), 4 slabs, against ``denoise4D``; (c) config 2 in stream mode
    with a stop and a reference cube against the K=1 loop; (d) config 3
    temporal K=4 killed after a checkpoint save and resumed; (e) config 3
    through ``cli.load_and_solve --out-of-core 3 --temporal 4``; (f)
    multi-process out of core (:func:`outofcore_mesh_phase`). Returns
    the numbers of the kernels line's halo row."""
    from cytvdn_tpu_torch import cli

    t_phase = time.perf_counter()
    with open("/proc/meminfo") as f:
        mem = {ln.split(":")[0]: int(ln.split()[1]) * 1024 for ln in f
               if ln.startswith(("MemTotal", "MemAvailable"))}
    log(f"phase 8 out-of-core: host memory {mem['MemTotal'] / 2**30:.1f} GiB, "
        f"{mem['MemAvailable'] / 2**30:.1f} GiB available")

    # (a) the halo kernel against its plain version
    t0 = time.perf_counter()
    err, n_cases = 0.0, 0
    for shape in HALO_SHAPES:
        for fista in (True, False):
            for where in ("first", "interior", "last"):
                for dtype in (torch.float32, torch.float64):
                    err = max(err, compare_halo_case(shape, fista, dtype,
                                                     where))
                    n_cases += 1
    # the slabs the main path launches with halos: config 4's and config
    # 2's interior slab of a 4-slab stream run
    slab2 = (CFG2[0] // 4,) + CFG2[1:]
    for shape in (SLAB4, slab2):
        for fista in (True, False):
            err = max(err, compare_halo_case(shape, fista, torch.float32,
                                             "slab"))
            n_cases += 1
    for shape in (CFG2, CFG3):
        for fista in (True, False):
            for n_slabs in (1, 3, 4):
                slabs_equal_one_launch(shape, fista, n_slabs)
    t_halo, raw = time_halo(SLAB4, 5, 1)
    bw, f32 = peak_bandwidth(name), peak_f32(name)
    b_ms, b_by = (launch_bound_seconds(SLAB4, True, 1, bw, f32)
                  if bw and f32 else (float("nan"), None))
    b_ms *= 1e3
    log(f"phase 8 (a) K=1 kernel with halos vs plain: {n_cases} cases "
        f"({HALO_SHAPES}: FISTA and unaccelerated, first, interior and last "
        f"of three slabs, f32 and f64; the interior slabs {SLAB4} and "
        f"{slab2} of 4-slab runs of configs 4 and 2, FISTA and "
        f"unaccelerated, f32), 3 launches each, state bitwise equal "
        f"(max |Δ| {err}), sums within rtol 1e-5; {CFG2} and {CFG3}, FISTA "
        f"and unaccelerated, in 1, 3 and 4 slabs with halos = one launch, "
        f"bitwise; at config 4's slab {SLAB4} FISTA f32 (an interior slab): "
        f"halo launch {t_halo['halo']:.3f} ms ({b_ms / t_halo['halo']:.3f} of "
        f"its {b_ms:.2f} ms bound, {b_by}), the same launch without halos "
        f"{t_halo['k1']:.3f} ms, plain with halos {t_halo['plain']:.3f} ms "
        f"(runs {raw}); {time.perf_counter() - t0:.1f} s [{smi}]")

    # (b) config 4 out of core against in core
    rates = link_rates(math.prod(SLAB4))
    log(f"phase 8 (b) link: the fastest of 6 pinned copies of one config-4 "
        f"slab array ({math.prod(SLAB4) * 4 / 1e9:.3f} GB) "
        f"{rates['h2d']:.2f} GB/s to the card, {rates['d2h']:.2f} GB/s back "
        f"[{smi}]")
    mu = np.full(4, 1.0, np.float32)
    halo_launches = None
    for mode, k, iters in (("stream", 1, 4), ("temporal", 8, 16)):
        t0 = time.perf_counter()
        want = denoise4D(cube, mu, iterations=iters, FISTA=True, quiet=True,
                         device="cuda")
        s_in = time.perf_counter() - t0
        (got, la, run, peak) = ooc_run(lambda: outofcore.denoise_outofcore(
            cube, mu, iterations=iters, FISTA=True, n_slabs=4, temporal_k=k,
            device="cuda"))
        require(np.array_equal(got[0], want[0]),
                f"config 4 out of core ({mode}) recon != denoise4D's")
        idx = np.arange(iters) if k == 1 else np.arange(k - 1, iters, k)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g[idx], w[idx], rtol=1e-5)
            require(not np.delete(g, idx).any(), "temporal traces between "
                                                 "sweeps not zero")
        n_pairs, n_k1 = (0, 0) if k == 1 else (
            iters // k * 4 * ((k - 1) // 2), iters // k * 4 * (k - 2 * ((k - 1) // 2)))
        want_la = (0, 0, 0, 4 * iters, 4 * iters) if k == 1 else             (0, 0, n_pairs, n_k1, 0)
        require(la == want_la, f"config 4 {mode}: launches (whole-run, "
                               f"K-step, pair, K=1, K=1 with halos) {la}, "
                               f"expected {want_la}")
        secs = run["sweep_seconds"] / iters
        if k == 1:
            halo_launches = la[4]
        else:
            # (f) holds each process's rows of a 2-process run, and each
            # column block of a 2-card split, to these
            rows16 = [digest(want[0][slice(*outofcore.process_row_range(
                CFG4[0], 2, r))]) for r in range(2)]
            half = CFG4[1] // 2
            cols16 = [digest(want[0][:, c * half:(c + 1) * half])
                      for c in range(2)]
            one16 = {"s_per_it": secs, "peak": peak,
                     "pin_seconds": run["pin_seconds"],
                     "h2d": run["h2d_bytes"] / run["h2d_seconds"] / 1e9,
                     "d2h": run["d2h_bytes"] / run["d2h_seconds"] / 1e9}
        link_s = (run["h2d_bytes"] / (rates["h2d"] * 1e9)
                  + run["d2h_bytes"] / (rates["d2h"] * 1e9))
        duplex_s = max(run["h2d_bytes"] / (rates["h2d"] * 1e9),
                       run["d2h_bytes"] / (rates["d2h"] * 1e9))
        log(f"phase 8 (b) config 4 {CFG4} FISTA x{iters} out of core, "
            f"{mode}{f' K={k}' if k > 1 else ''}, 4 slabs: recon bitwise "
            f"denoise4D's, traces within rtol 1e-5"
            f"{' at the sweep ends' if k > 1 else ''}; {secs:.4f} s per "
            f"iteration ({run['sweep_seconds']:.3f} s of sweeps; in core "
            f"{s_in / iters:.4f} s per iteration with host copies); "
            f"{run['h2d_bytes'] / 1e9 / iters:.2f} GB in and "
            f"{run['d2h_bytes'] / 1e9 / iters:.2f} GB out per iteration at "
            f"{run['h2d_bytes'] / run['h2d_seconds'] / 1e9:.2f} and "
            f"{run['d2h_bytes'] / run['d2h_seconds'] / 1e9:.2f} GB/s (copy "
            f"stream busy {run['h2d_seconds'] + run['d2h_seconds']:.3f} s); "
            f"{link_s / run['sweep_seconds']:.3f} of the one-copy-stream "
            f"bound (bytes each way at the link's rates, one direction at "
            f"a time: {link_s / iters:.4f} s per iteration), "
            f"{duplex_s / run['sweep_seconds']:.3f} of the PCIe bound "
            f"(both directions at once: {duplex_s / iters:.4f} s); peak "
            f"device memory "
            f"{peak / 2**30:.3f} GiB; launches (whole-run, K-step, pair, "
            f"K=1, K=1 with halos) {la}; host memory pinned "
            f"{run['pinned_bytes'] / 2**30:.2f} GiB in "
            f"{run['pin_seconds']:.3f} s [{smi}]")
        del got, want
    # (c) config 2 stream mode, stop 0.05 and a reference cube, against the
    # K=1 loop on the card
    t0 = time.perf_counter()
    clean2, noisy2 = cfg2_eels()
    mu3 = np.full(3, 1.0, np.float32)
    o2, r2 = torch.from_numpy(noisy2).cuda(), torch.from_numpy(clean2).cuda()
    li3 = torch.full((3,), 16.0, device="cuda")
    lm3 = torch.full((3,), 1 / 16, device="cuda")
    k1 = run_solver(o2, li3, lm3, SolverOptions(
        ndim=3, iterations_fista=500, iterations_unacc=0,
        stopping_relative_change=0.05, calculate_mse=True,
        vmem_resident=False, temporal_kstep=False, temporal_pairs=False),
        reference_data=r2)
    k1 = {key: v.cpu().numpy() if torch.is_tensor(v) else v
          for key, v in k1.items()}
    del o2, r2
    (got, la, run, _) = ooc_run(lambda: outofcore.denoise_outofcore(
        noisy2, mu3, iterations=500, FISTA=True,
        stopping_relative_change=0.05, n_slabs=4, reference_data=clean2,
        device="cuda"))
    n2 = int(np.count_nonzero(got[2]))
    require(n2 == k1["iterations_run"] < 500,
            f"config 2 stream stop after {n2}, the K=1 loop after "
            f"{k1['iterations_run']}")
    require(np.array_equal(got[0], k1["recon"]),
            "config 2 stream stop: recon != the K=1 loop's")
    np.testing.assert_allclose(got[3][:n2 + 1], k1["mse"][:n2 + 1], rtol=1e-5)
    np.testing.assert_allclose(got[2], k1["delta"], rtol=1e-5)
    log(f"phase 8 (c) config 2 {CFG2} FISTA stream mode, 4 slabs, stop 0.05 "
        f"with the clean cube as reference: stops after {n2} iterations as "
        f"the K=1 loop on the card, recon bitwise, MSE {got[3][0]:.1f} -> "
        f"{got[3][n2]:.1f} within rtol 1e-5; launches {la}; "
        f"{run['sweep_seconds'] / n2:.4f} s per iteration (host SSE "
        f"included); {time.perf_counter() - t0:.1f} s [{smi}]")
    del got, k1, clean2, noisy2

    # (d) config 3 temporal K=4, a checkpoint every 8 iterations, killed
    # after the first save and resumed
    t0 = time.perf_counter()
    mu4 = np.full(4, 1.0, np.float32)
    kw = dict(iterations=(8, 4), n_slabs=4, temporal_k=4, device="cuda")
    want3 = denoise4D(cube3, mu4, iterations=(8, 4), quiet=True,
                      device="cuda")
    plain3 = outofcore.denoise_outofcore(cube3, mu4, **kw)
    require(np.array_equal(plain3[0], want3[0]),
            "config 3 temporal K=4 recon != denoise4D's")
    tmp = tempfile.mkdtemp(prefix="cytv_ooc_")
    saves = []
    try:
        ck = os.path.join(tmp, "ooc.npz")

        def kill(it_run):
            saves.append((it_run, time.perf_counter()))
            raise Killed

        outofcore._POST_CKPT_HOOK = kill
        t_kill = time.perf_counter()
        try:
            outofcore.denoise_outofcore(cube3, mu4, checkpoint_path=ck,
                                        checkpoint_every=8, **kw)
            require(False, "the checkpoint hook did not kill the run")
        except Killed:
            pass
        finally:
            outofcore._POST_CKPT_HOOK = None
        size = os.path.getsize(ck)
        got = outofcore.denoise_outofcore(cube3, mu4, checkpoint_path=ck,
                                          checkpoint_every=8, resume=True,
                                          **kw)
        for g, w in zip(got, plain3):
            require(np.array_equal(g, w), "config 3 resumed run != the "
                                          "uninterrupted run")
        # (e) the command line, from a .npy file
        npy = os.path.join(tmp, "config3.npy")
        np.save(npy, cube3)
        run_cli = cli.load_and_solve(
            ["-i", npy, "-o", os.path.join(tmp, "o.emd"), "-m", "1.0", "-n",
             "8", "4", "--out-of-core", "3", "--temporal", "4", "-v", "0"])
        api = outofcore.denoise_outofcore(cube3, mu4, iterations=(8, 4),
                                          n_slabs=3, temporal_k=4,
                                          device="cuda")
        for g, w in zip((run_cli.recon, run_cli.b_norm, run_cli.delta), api):
            require(np.array_equal(g, w), "cytv-torch --out-of-core 3 "
                                          "--temporal 4 != the API run")
        require(np.array_equal(api[0], want3[0]), "config 3 in 3 slabs != "
                                                  "denoise4D")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 8 (d) config 3 {CFG3} hybrid (8, 4) temporal K=4, 4 slabs, a "
        f"checkpoint every 8 iterations ({size / 1e9:.3f} GB): killed after "
        f"the save at iteration {saves[0][0]} "
        f"({saves[0][1] - t_kill:.2f} s into the run) and resumed, all "
        f"outputs bitwise the uninterrupted run's, its recon bitwise "
        f"denoise4D's; (e) cli.load_and_solve --out-of-core 3 --temporal 4 "
        f"from a .npy: bitwise the API run's (solve "
        f"{run_cli.seconds['solve']:.3f} s); "
        f"{time.perf_counter() - t0:.1f} s")
    del plain3, got, api, run_cli
    outofcore_mesh_phase(smi, cube, rows16, cube3, cols16, one16)
    log(f"phase 8 {time.perf_counter() - t_phase:.1f} s")
    return {"launches": halo_launches, "err": err, "ms": t_halo["halo"],
            "plain_ms": t_halo["plain"], "bound": (b_ms, b_by)}


def mem_available() -> float:
    """The host's available memory in GiB (``/proc/meminfo``)."""
    with open("/proc/meminfo") as f:
        for ln in f:
            if ln.startswith("MemAvailable"):
                return int(ln.split()[1]) * 1024 / 2**30
    return float("nan")


def ooc_generations(path, n_ranks):
    """The iteration of each process's out-of-core checkpoint part
    (``path.ooc<p>``) on disk, -1 where it is not there yet (parts are
    renamed into place whole)."""
    gens = []
    for r in range(n_ranks):
        try:
            with np.load(f"{path}.ooc{r}") as z:
                gens.append(int(z["i"]))
        except FileNotFoundError:
            gens.append(-1)
    return gens


def outofcore_mesh_phase(smi, cube, rows16, cube3, cols16, one16):
    """Phase 8 (f): multi-process out of core, processes of this script
    (``--cli-worker``) sharing the card (gloo). (i) config 4 through
    ``cli.load_and_solve --out-of-core 4 --temporal 8`` x16 FISTA on 2
    processes, each reading only its 128 rows of the ``.npy``: each rank's
    rows bitwise phase 8 (b)'s temporal K=8 x16 recon's (``rows16``, their
    digests), 24 pairs and 16 K=1 launches per rank; (ii) config 3 hybrid
    (8, 4) ``--lossy-duals --out-of-core 2 --temporal 4`` on 3 processes
    (uneven rows), a part every 4 iterations, every process stopped after
    the first generation and killed, then ``--resume 1``: every rank
    resumed from 4, the FISTA sweep in LOSSY pairs and K=1 launches, its
    rows bitwise the in-core lossy run's; slabs split over several cards
    (:func:`split_slabs_phase`)."""
    try:
        import h5py  # noqa: F401
        write = True
    except ImportError:
        write = False
    how = ("cli.load_and_solve + cli.write_output" if write else
           "cli.load_and_solve (h5py is missing: no EMD output written)")
    t_f = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="cytv_oocmesh_")
    try:
        npy = os.path.join(tmp, "config4.npy")
        np.save(npy, cube)
        avail = mem_available()
        out4 = os.path.join(tmp, "config4.emd")
        t0 = time.perf_counter()
        g1 = run_mesh(tmp, 2, None, timeout=300, worker="--cli-worker",
                      write=write, argv=[
                          "-i", npy, "-o", out4, "-m", "1.0", "-n", "16",
                          "-f", "1", "--out-of-core", "4", "--temporal",
                          "8"])
        s_i = time.perf_counter() - t0
        for r in g1:
            rank = r["rank"]
            require(r["block"] == rows16[rank],
                    f"8 (f) (i) rank {rank}: rows not bitwise phase 8 (b)'s "
                    f"temporal K=8 recon")
            require(tuple(r["launches"]) == (0, 0, 24, 16)
                    and r["iterations_run"] == 2,
                    f"8 (f) (i) rank {rank}: launches {r['launches']}, "
                    f"{r['iterations_run']} sweep-final trace entries")
        if write:
            from cytvdn_tpu_torch.io.emd import read_emd

            got = read_emd(out4)
            for rank in range(2):
                require(digest(got[slice(*outofcore.process_row_range(
                    CFG4[0], 2, rank))]) == rows16[rank],
                        "8 (f) (i) the EMD output is not bitwise")
            del got
        log(f"phase 8 (f) (i) {how} --out-of-core 4 --temporal 8 on config "
            f"4 {CFG4} FISTA x16 from a .npy, 2 processes sharing the card "
            f"(gloo), each reading its 128 rows: each rank's rows bitwise "
            f"phase 8 (b)'s temporal K=8 recon (sha256), 24 pairs and 16 "
            f"K=1 launches per rank; host memory available before "
            f"{avail:.1f} GiB; {s_i:.1f} s [{smi}]")
        for r in g1:
            o, ex, sec = r["ooc"], r["exchange"], r["seconds"]
            log(f"phase 8 (f) (i) rank {r['rank']}: load {sec['load']} s, "
                f"pin {o['pinned_bytes'] / 2**30:.2f} GiB in "
                f"{o['pin_seconds']} s, solve {sec['solve']} s, "
                f"{o['sweep_seconds'] / 16} s per iteration "
                f"({o['sweeps']:.0f} sweeps), "
                f"{o['h2d_bytes'] / o['h2d_seconds'] / 1e9:.2f} GB/s in and "
                f"{o['d2h_bytes'] / o['d2h_seconds'] / 1e9:.2f} GB/s out; "
                f"band exchanges {ex['exchanges']} ({ex['exchange_seconds']} "
                f"s, {ex['bytes_sent']} bytes sent, {ex['bytes_received']} "
                f"received, "
                f"{ex['bytes_sent'] / max(ex['exchange_seconds'], 1e-9) / 1e9:.3f}"
                f" GB/s); launches whole-run/K-step/pair/K=1 "
                f"{tuple(r['launches'])}; peak device memory "
                f"{r['peak'] / 2**30:.3f} GiB [{smi}]")

        # (ii) config 3 lossy on 3 processes, killed after the first
        # generation
        t0 = time.perf_counter()
        want3 = denoise4D(cube3, np.full(4, 1.0, np.float32),
                          iterations=(8, 4), lossy_duals=True, quiet=True,
                          device="cuda")[0]
        npy3 = os.path.join(tmp, "config3.npy")
        np.save(npy3, cube3)
        ck = os.path.join(tmp, "config3.ckpt.npz")
        argv3 = ["-i", npy3, "-o", os.path.join(tmp, "config3.emd"), "-m",
                 "1.0", "-n", "8", "4", "-f", "1", "--lossy-duals",
                 "--out-of-core", "2", "--temporal", "4", "--checkpoint", ck,
                 "--checkpoint-every", "4"]
        killed = run_mesh(tmp, 3, None, timeout=300, worker="--cli-worker",
                          poll=lambda: min(ooc_generations(ck, 3)) >= 4,
                          write=write, argv=argv3, hang_after_save=True)
        require(killed is None, "8 (f) (ii) the run ended before its first "
                                "checkpoint generation")
        gens = ooc_generations(ck, 3)
        require(gens == [4, 4, 4], f"8 (f) (ii) parts after the kill: {gens}")
        s_kill = time.perf_counter() - t0
        g2 = run_mesh(tmp, 3, None, timeout=300, worker="--cli-worker",
                      write=write, argv=argv3 + ["--resume", "1"])
        for r in g2:
            rank = r["rank"]
            rows = slice(*outofcore.process_row_range(CFG3[0], 3, rank))
            require(r["resumed_from"] == 4 and not r["warnings"],
                    f"8 (f) (ii) rank {rank}: resumed from "
                    f"{r['resumed_from']}, warnings {r['warnings']}")
            require(r["block"] == digest(want3[rows]),
                    f"8 (f) (ii) rank {rank}: rows not bitwise the in-core "
                    f"lossy run's")
            # resumed from 4: the FISTA sweep (2 slabs, 1 pair and 2 K=1
            # launches each) in LOSSY launches, then the unaccelerated one,
            # which has no shadow duals
            require(tuple(r["launches"]) == (0, 0, 4, 8)
                    and r["lossy"] == [2, 4],
                    f"8 (f) (ii) rank {rank}: launches {r['launches']}, "
                    f"LOSSY pairs and K=1 launches {r['lossy']}")
        log(f"phase 8 (f) (ii) {how} --lossy-duals --out-of-core 2 "
            f"--temporal 4 on config 3 {CFG3} hybrid (8, 4), 3 processes (rows "
            f"{[outofcore.process_row_range(CFG3[0], 3, q) for q in range(3)]}"
            f"), a part every 4 iterations: every process stopped after the "
            f"parts of iteration 4 were on disk and killed ({s_kill:.1f} s), "
            f"then --resume 1: every rank resumed from 4, its rows bitwise "
            f"the in-core lossy run's, the FISTA sweep's 2 pairs and 4 K=1 "
            f"launches LOSSY; launches per rank "
            f"{[tuple(r['launches']) for r in g2]}, band exchanges "
            f"{[r['exchange']['exchanges'] for r in g2]}; "
            f"{time.perf_counter() - t0:.1f} s [{smi}]")
        # (iii) reads the config-4 .npy that (i) read
        split_slabs_phase(smi, tmp, npy, cube3, want3, cols16, one16, g1,
                          s_i, write, how)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 8 (f) {time.perf_counter() - t_f:.1f} s")
    return g1


#: phase 8 (f) (iii)'s library call: ``denoise_outofcore(shard_w=2)`` of a
#: seeded cube of ``shape``, FISTA, at ``temporal_k`` over ``n_slabs``
SPLIT_CALL = {"shape": [32, 64, 24, 24], "seed": 23, "mu": 1.0,
              "iterations": 8, "n_slabs": 2, "temporal_k": 4}


def split_call(call, **kw):
    """``denoise_outofcore`` of ``SPLIT_CALL``'s cube on the card with
    ``kw`` (``shard_w=2`` on the ranks of a mesh); its recon (None off
    rank 0)."""
    cube = np.random.default_rng(call["seed"]).standard_normal(
        call["shape"], dtype=np.float32)
    return outofcore.denoise_outofcore(
        cube, call["mu"], iterations=call["iterations"],
        n_slabs=call["n_slabs"], temporal_k=call["temporal_k"],
        device="cuda", **kw)[0]


def split_slabs_phase(smi, tmp, npy, cube3, want3, cols16, one16, g1, s_i,
                      write, how):
    """Phase 8 (f) (iii) and (iv): out-of-core slabs split over several
    cards, processes of this script (``--cli-worker``) sharing the card
    (gloo). (iii) config 4 through ``cli.load_and_solve --out-of-core 4
    --temporal 8 --shard 2`` x16 FISTA on 2 processes, each reading only
    its 128 columns of the ``.npy`` ``npy`` (deleted here): each rank's
    column block bitwise phase
    8 (b)'s temporal K=8 x16 recon's (``cols16``), 24 ``HALO1`` pairs and
    16 K=1 ``HALO`` launches per rank, with the per-rank numbers beside
    (b)'s one-process run (``one16``) and (i)'s row split (``g1``,
    ``s_i``), then ``denoise_outofcore(shard_w=2)`` of ``SPLIT_CALL`` in
    the same processes, rank 0's recon bitwise the one-process call's;
    (iv) config 3 hybrid (8, 4) ``--lossy-duals --out-of-core 2
    --temporal 4 --shard 2`` on a 2 x 2 grid of 4 processes, a part every
    4 iterations, every process stopped after the first generation and
    killed, then ``--resume 1``: every rank resumed from 4, its block
    bitwise the in-core lossy run's (``want3``)."""
    avail = mem_available()
    out4 = os.path.join(tmp, "config4-split.emd")
    t0 = time.perf_counter()
    g3 = run_mesh(tmp, 2, None, timeout=300, worker="--cli-worker",
                  write=write, argv=[
                      "-i", npy, "-o", out4, "-m", "1.0", "-n", "16", "-f",
                      "1", "--out-of-core", "4", "--temporal", "8",
                      "--shard", "2"], split_call=SPLIT_CALL)
    s_iii = time.perf_counter() - t0
    os.remove(npy)
    t0 = time.perf_counter()
    lib = digest(split_call(SPLIT_CALL))
    require(g3[0]["split_call"]["recon"] == lib
            and g3[1]["split_call"]["recon"] is None
            and all(r["split_call"]["halo1"] > 0 for r in g3),
            f"8 (f) (iii) denoise_outofcore(shard_w=2): rank 0's recon is "
            f"not bitwise the one-process call's, or a rank returned one "
            f"off rank 0, or ran no HALO1 pair "
            f"({[r['split_call'] for r in g3]})")
    log(f"phase 8 (f) (iii) denoise_outofcore(shard_w=2) of "
        f"{tuple(SPLIT_CALL['shape'])} FISTA x{SPLIT_CALL['iterations']} "
        f"at temporal_k={SPLIT_CALL['temporal_k']} over "
        f"{SPLIT_CALL['n_slabs']} slabs on the same 2 processes: rank 0's "
        f"stitched recon (gathered through gloo) bitwise the one-process "
        f"call's, HALO1 pairs per rank "
        f"{[r['split_call']['halo1'] for r in g3]}, "
        f"{[r['split_call']['seconds'] for r in g3]} s per rank "
        f"({time.perf_counter() - t0:.1f} s for the one-process call) "
        f"[{smi}]")
    for r in g3:
        rank = r["rank"]
        require(r["block"] == cols16[rank],
                f"8 (f) (iii) rank {rank}: its columns are not bitwise phase "
                f"8 (b)'s temporal K=8 recon")
        require(tuple(r["launches"]) == (0, 0, 24, 16) and r["halo1"] == 24
                and r["k1_halo"] == 16 and r["iterations_run"] == 2,
                f"8 (f) (iii) rank {rank}: launches {r['launches']}, HALO1 "
                f"pairs {r['halo1']}, K=1 HALO launches {r['k1_halo']}, "
                f"{r['iterations_run']} sweep-final trace entries")
    if write:
        from cytvdn_tpu_torch.io.emd import read_emd

        got = read_emd(out4)
        half = CFG4[1] // 2
        for c in range(2):
            require(digest(got[:, c * half:(c + 1) * half]) == cols16[c],
                    "8 (f) (iii) the EMD output is not bitwise")
        del got
    row_s = [r["ooc"]["sweep_seconds"] / 16 for r in g1]
    log(f"phase 8 (f) (iii) {how} --out-of-core 4 --temporal 8 --shard 2 "
        f"on config 4 {CFG4} FISTA x16 from a .npy, 2 processes sharing "
        f"the card (gloo), each reading its {CFG4[1] // 2} columns: each "
        f"rank's "
        f"column block bitwise phase 8 (b)'s temporal K=8 recon (sha256), "
        f"24 HALO1 pairs and 16 K=1 HALO launches per rank; s per "
        f"iteration per rank {[r['ooc']['sweep_seconds'] / 16 for r in g3]}"
        f", the same run in one process (8 (b)) {one16['s_per_it']} s, the "
        f"row split on 2 processes (8 (f) (i)) {row_s} s; host memory "
        f"available before {avail:.1f} GiB; {s_iii:.1f} s (the row split "
        f"{s_i:.1f} s) [{smi}]")
    for r in g3:
        o, ex, sec = r["ooc"], r["column_exchange"], r["seconds"]
        log(f"phase 8 (f) (iii) rank {r['rank']} (columns "
            f"[{r['cols'][0]}, {r['cols'][1]}) of {r['cols'][2]}): "
            f"load {sec['load']} s, pin {o['pinned_bytes'] / 2**30:.2f} GiB "
            f"in {o['pin_seconds']} s, solve {sec['solve']} s, "
            f"{o['sweep_seconds'] / 16} s per iteration "
            f"({o['sweeps']:.0f} sweeps), "
            f"{o['h2d_bytes'] / o['h2d_seconds'] / 1e9:.2f} GB/s in and "
            f"{o['d2h_bytes'] / o['d2h_seconds'] / 1e9:.2f} GB/s out "
            f"({o['h2d_bytes'] / 1e9:.2f} GB in, {o['d2h_bytes'] / 1e9:.2f} "
            f"GB out); column exchanges {ex['exchanges']} "
            f"({ex['exchange_seconds']} s, {ex['bytes_sent']} bytes sent, "
            f"{ex['bytes_received']} received, "
            f"{ex['bytes_sent'] / max(ex['exchange_seconds'], 1e-9) / 1e9:.3f}"
            f" GB/s; {ex['buffers']} pool buffers, {ex['buffer_bytes']} "
            f"device bytes); launches whole-run/K-step/pair/K=1 "
            f"{tuple(r['launches'])}; peak device memory "
            f"{r['peak'] / 2**30:.3f} GiB (one process, 8 (b): "
            f"{one16['peak'] / 2**30:.3f} GiB; its pin {one16['pin_seconds']}"
            f" s, {one16['h2d']:.2f} GB/s in and {one16['d2h']:.2f} GB/s "
            f"out) [{smi}]")

    # (iv) config 3 lossy on a 2 x 2 grid, killed after the first
    # generation
    t0 = time.perf_counter()
    npy3 = os.path.join(tmp, "config3-split.npy")
    np.save(npy3, cube3)
    ck = os.path.join(tmp, "config3-split.ckpt.npz")
    argv = ["-i", npy3, "-o", os.path.join(tmp, "config3-split.emd"), "-m",
            "1.0", "-n", "8", "4", "-f", "1", "--lossy-duals",
            "--out-of-core", "2", "--temporal", "4", "--shard", "2",
            "--checkpoint", ck, "--checkpoint-every", "4"]
    killed = run_mesh(tmp, 4, None, timeout=300, worker="--cli-worker",
                      poll=lambda: min(ooc_generations(ck, 4)) >= 4,
                      write=write, argv=argv, hang_after_save=True)
    require(killed is None, "8 (f) (iv) the run ended before its first "
                            "checkpoint generation")
    gens = ooc_generations(ck, 4)
    require(gens == [4] * 4, f"8 (f) (iv) parts after the kill: {gens}")
    s_kill = time.perf_counter() - t0
    g4 = run_mesh(tmp, 4, None, timeout=300, worker="--cli-worker",
                  write=write, argv=argv + ["--resume", "1"])
    half = CFG3[1] // 2
    for r in g4:
        rank = r["rank"]
        rows = slice(*outofcore.process_row_range(CFG3[0], 2, rank // 2))
        cols = slice(rank % 2 * half, (rank % 2 + 1) * half)
        require(r["resumed_from"] == 4 and not r["warnings"],
                f"8 (f) (iv) rank {rank}: resumed from {r['resumed_from']}, "
                f"warnings {r['warnings']}")
        require(r["block"] == digest(want3[rows, cols]),
                f"8 (f) (iv) rank {rank}: its block is not bitwise the "
                f"in-core lossy run's")
        # resumed from 4: the FISTA sweep (2 slabs, 1 pair and 2 K=1
        # launches each) in LOSSY launches, then the unaccelerated one
        require(tuple(r["launches"]) == (0, 0, 4, 8) and r["halo1"] == 4
                and r["k1_halo"] == 8 and r["lossy"] == [2, 4],
                f"8 (f) (iv) rank {rank}: launches {r['launches']}, HALO1 "
                f"{r['halo1']}, K=1 HALO {r['k1_halo']}, LOSSY pairs and "
                f"K=1 launches {r['lossy']}")
    log(f"phase 8 (f) (iv) {how} --lossy-duals --out-of-core 2 --temporal 4 "
        f"--shard 2 on config 3 {CFG3} hybrid (8, 4), 4 processes on a 2 x "
        f"2 grid (blocks of {CFG3[0] // 2} rows x {half} columns), a part "
        f"every 4 "
        f"iterations: every process stopped after the parts of iteration 4 "
        f"were on disk and killed ({s_kill:.1f} s), then --resume 1: every "
        f"rank resumed from 4, its block bitwise the in-core lossy run's, "
        f"the FISTA sweep's 2 HALO1 pairs and 4 K=1 HALO launches LOSSY; "
        f"launches per rank {[tuple(r['launches']) for r in g4]}, band "
        f"exchanges {[r['exchange']['exchanges'] for r in g4]}, column "
        f"exchanges {[r['column_exchange']['exchanges'] for r in g4]}; "
        f"{time.perf_counter() - t0:.1f} s [{smi}]")


# phase 9: sharded runs on scan-axis meshes: the pair kernel's axis-0 bands
# (HALO0) against its plain version, and meshes of processes sharing the
# card through gloo against the single-device runs

HALO0_SMALL = ((12, 13, 19, 23), (16, 9, 70), (8, 4, 10, 33), (12, 37, 9))
SHARD4 = (128, 256, 128, 128)   # config 4's block on a (2, 1, 1, 1) mesh
HALF4 = (128, 256, 128, 128)    # half of config 4's rows, for (d)
QUAD4 = (128, 128, 128, 128)    # config 4's block on a (2, 2, 1, 1) mesh
SHARD2 = (128, 256, 2048)       # config 2's block on a (2, 1, 1) mesh


def halo0_state(shape, fista, gen, lossy=False):
    """A random Jia-Zhao state of a whole cube on the card: each
    accumulator's leading slab along its own axis is zero, so the own row 0
    of every axis-0 slab but the first holds nonzero axis-0 accumulators
    (the wrap a shard must not read). ``lossy``: FISTA's d in bfloat16."""
    orig, state, li, lm, _ = random_state(shape, fista, torch.float32, gen,
                                          jz=True)
    if lossy:
        nd = len(shape)
        state = state[:1 + nd] + [d.to(torch.bfloat16)
                                  for d in state[1 + nd:]]
    return orig, state, li, lm


def halo0_pair(step, orig, state, fista, li, lm, a0, a1, ref=None,
               bands=None, **kw):
    """One pair of ``step`` on rows [a0, a1) of ``state`` with the bands
    cut from it (or ``bands``: (halos0, first0, last0)); returns the slab's
    state and its sums (float64, on the host)."""
    ndim = orig.dim()
    accs, ds = state[1:1 + ndim], state[1 + ndim:] if fista else None
    h, f0, l0 = bands or halo0_bands(orig, state[0], accs, ds, a0, a1)
    s = [x[a0:a1].clone() for x in state]
    out = step(orig[a0:a1].contiguous(), s[0], s[1:1 + ndim],
               s[1 + ndim:] if fista else None,
               torch.tensor(0.37, device="cuda"),
               torch.tensor(RHO2, device="cuda"), li, lm, fista=fista,
               halos0=h, first0=f0, last0=l0,
               ref=None if ref is None else ref[a0:a1].contiguous(), **kw)
    sums = torch.stack(out[3:]).double().cpu()
    torch.cuda.synchronize()
    return s, sums


def compare_halo0(shape, fista, with_ref, a0, a1, grids=(None,),
                  strips=(None,), lossy=False):
    """The HALO0 pair on rows [a0, a1) of a random cube at each forced grid
    and strip against the plain pair with the same bands: state bitwise
    (``lossy``: d bfloat16, bands widened, the LOSSY instantiation), sums
    within rtol 1e-5; returns max |Δstate|."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    orig, state, li, lm = halo0_state(shape, fista, gen, lossy)
    if a0 > 0:
        require(state[1][a0].abs().max().item() > 0,
                "the slab's own axis-0 row 0 is zero")
    ref = orig + 0.1 if with_ref else None
    ps, psum = halo0_pair(fused_pair_iteration_reference, orig, state, fista,
                          li, lm, a0, a1, ref)
    err = 0.0
    for g in grids:
        for w in strips:
            ks, ksum = halo0_pair(fused_pair_iteration, orig, state, fista,
                                  li, lm, a0, a1, ref, grid=g,
                                  strip=shape[1] if w == "N1" else w)
            err = max(err, max((a.float() - b.float()).abs().max().item()
                               for a, b in zip(ks, ps)))
            require(all(a.dtype == b.dtype and torch.equal(a, b)
                        for a, b in zip(ks, ps)),
                    f"HALO0 pair {shape} rows [{a0}, {a1}) fista {fista} ref "
                    f"{with_ref} lossy {lossy} grid {g} strip {w}: state "
                    f"differs from the plain pair (max |Δ| {err})")
            torch.testing.assert_close(ksum, psum, rtol=1e-5, atol=0)
            del ks
    del ps, state, orig, ref
    torch.cuda.empty_cache()
    return err


def halo0_slabs_equal_one_launch(shape, fista, with_ref, n_slabs):
    """Axis-0 slabs of a random cube, each paired by the HALO0 kernel with
    bands from the pre-update state and put back: bitwise one pair launch
    of the whole cube, the slabs' sums adding up to its sums."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    orig, state, li, lm = halo0_state(shape, fista, gen)
    ndim = len(shape)
    ref = orig + 0.1 if with_ref else None
    whole = [x.clone() for x in state]
    out = fused_pair_iteration(
        orig, whole[0], whole[1:1 + ndim], whole[1 + ndim:] if fista else None,
        torch.tensor(0.37, device="cuda"), torch.tensor(RHO2, device="cuda"),
        li, lm, fista=fista, ref=ref)
    want = torch.stack(out[3:]).double().cpu()
    n0 = shape[0]
    bounds = [n0 * i // n_slabs for i in range(n_slabs + 1)]
    got = 0
    for a0, a1 in zip(bounds[:-1], bounds[1:]):
        s, sums = halo0_pair(fused_pair_iteration, orig, state, fista, li, lm,
                             a0, a1, ref)
        got = got + sums
        require(all(torch.equal(a, b[a0:a1]) for a, b in zip(s, whole)),
                f"{shape} fista {fista} ref {with_ref} in {n_slabs} slabs "
                f"with bands != one pair launch")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    del whole, state, orig
    torch.cuda.empty_cache()


def shard_bands(shape, fista, gen, first0, last0):
    """Random bands for a shard of ``shape`` (the Jia-Zhao invariant held
    along the in-row axes): zeros where the shard holds a global edge."""
    ndim = len(shape)
    row = (1,) + tuple(shape[1:])

    def rnd(rows, scale, k=None):
        t = torch.randn((rows,) + row[1:], generator=gen, device="cuda") * scale
        if k:
            t.select(k, 0).zero_()
        return t

    h = {"p_r0": rnd(2, 0.05) + 2.0, "p_orig": rnd(1, 0.5) + 2.0,
         "n_r0": rnd(2, 0.05) + 2.0, "n_orig": rnd(1, 0.5) + 2.0,
         "n_acc0_r1": rnd(1, 0.2)}
    for k in range(ndim):
        h[f"p_acc{k}"], h[f"n_acc{k}"] = rnd(1, 0.2, k), rnd(1, 0.2, k)
        if fista:
            h[f"p_d{k}"], h[f"n_d{k}"] = rnd(1, 0.2, k), rnd(1, 0.2, k)
    if fista:
        h["n_d0_r1"] = rnd(1, 0.2)
    for key in h:
        if first0 and key.startswith("p_") or last0 and key.startswith("n_"):
            h[key].zero_()
    return h, first0, last0


def compare_halo0_shard(shape, fista, with_ref, first0, last0):
    """The HALO0 pair on a shard of ``shape`` (own rows random, row 0's
    axis-0 accumulators nonzero unless ``first0``) with random bands,
    against the plain pair: state bitwise, sums within rtol 1e-5."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    orig, state, li, lm = halo0_state(shape, fista, gen)
    if not first0:
        state[1][0].normal_(generator=gen).mul_(0.2)
    bands = shard_bands(shape, fista, gen, first0, last0)
    ref = orig + 0.1 if with_ref else None
    n0 = shape[0]
    ps, psum = halo0_pair(fused_pair_iteration_reference, orig, state, fista,
                          li, lm, 0, n0, ref, bands)
    ks, ksum = halo0_pair(fused_pair_iteration, orig, state, fista, li, lm, 0,
                          n0, ref, bands)
    err = max((a - b).abs().max().item() for a, b in zip(ks, ps))
    require(all(torch.equal(a, b) for a, b in zip(ks, ps)),
            f"HALO0 pair at the shard {shape} (first0 {first0}, last0 "
            f"{last0}, ref {with_ref}): state differs (max |Δ| {err})")
    torch.testing.assert_close(ksum, psum, rtol=1e-5, atol=0)
    del ks, ps, state, orig, bands, ref
    torch.cuda.empty_cache()
    return err


def time_halo0(shape, n_kernel, n_plain):
    """ms per pair at the shard ``shape`` FISTA f32 of the HALO0 kernel (an
    interior shard: bands on both sides), of the pair kernel without bands
    and of the plain pair with bands, in turns (plain, halo0, pair, pair,
    halo0, plain)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    orig, state, li, lm = halo0_state(shape, True, gen)
    ndim = len(shape)
    h = shard_bands(shape, True, gen, False, False)[0]
    rho1 = torch.tensor(0.37, device="cuda")
    rho2 = torch.tensor(RHO2, device="cuda")
    args = (orig, state[0], state[1:1 + ndim], state[1 + ndim:], rho1, rho2,
            li, lm)
    fns = {"halo0": lambda: fused_pair_iteration(
               *args, fista=True, halos0=h, first0=False, last0=False),
           "pair": lambda: fused_pair_iteration(*args, fista=True),
           "plain": lambda: fused_pair_iteration_reference(
               *args, fista=True, halos0=h, first0=False, last0=False)}
    raw = {k: [] for k in fns}
    for name in ("plain", "halo0", "pair", "pair", "halo0", "plain"):
        raw[name].append(time_ms(fns[name],
                                 n_plain if name == "plain" else n_kernel))
    del state, orig, h, fns, args
    torch.cuda.empty_cache()
    return {k: sum(v) / len(v) for k, v in raw.items()}, raw


# the pair kernel's axis-1 bands (HALO1): column shards of small cubes (2
# columns and more, ragged trailing axes, 3D and 4D) and config 4's block
# on a (1, 2, 1, 1) mesh
HALO1_SMALL = ((6, 12, 19, 23), (9, 9, 70), (5, 8, 10, 33), (7, 15, 9))
SHARD41 = (256, 128, 128, 128)  # config 4's block on a (1, 2, 1, 1) mesh


def halo1_pair(step, orig, state, fista, li, lm, j0, j1, ref=None,
               bands=None, **kw):
    """One pair of ``step`` on columns [j0, j1) of ``state`` with the bands
    cut from it (or ``bands``: (halos1, first1, last1)); returns the
    shard's state and its sums (float64, on the host)."""
    ndim = orig.dim()
    accs, ds = state[1:1 + ndim], state[1 + ndim:] if fista else None
    h, f1, l1 = bands or halo1_bands(orig, state[0], accs, ds, j0, j1)
    s = [x[:, j0:j1].clone(memory_format=torch.contiguous_format)
         for x in state]
    out = step(orig[:, j0:j1].contiguous(), s[0], s[1:1 + ndim],
               s[1 + ndim:] if fista else None,
               torch.tensor(0.37, device="cuda"),
               torch.tensor(RHO2, device="cuda"), li, lm, fista=fista,
               halos1=h, first1=f1, last1=l1,
               ref=None if ref is None else ref[:, j0:j1].contiguous(), **kw)
    sums = torch.stack(out[3:]).double().cpu()
    torch.cuda.synchronize()
    return s, sums


def halo1_k1_halos(orig, state, fista, li, lm, bands):
    """The K=1 halos of a HALO1 pair's two iterations on ``state`` (a
    shard) from its ``bands`` (``kernels/temporal.py::_pair_seams``, axis
    1): two functions of the current recon."""
    ndim = orig.dim()
    h, f1, l1 = bands
    return temporal_mod._pair_seams(
        orig, state[0], state[1:1 + ndim], state[1 + ndim:] if fista else None,
        torch.tensor(0.37, device="cuda"), li, lm, fista, 1, h, f1, l1)


def halo1_two_k1(orig, state, fista, li, lm, j0, j1, bands=None):
    """Two K=1 kernel launches (its HALO instantiation) on columns [j0, j1)
    with the axis-1 halos the shard's bands give: the HALO1 pair's
    reference in K=1 launches. Returns the shard's state."""
    ndim = orig.dim()
    accs, ds = state[1:1 + ndim], state[1 + ndim:] if fista else None
    bands = bands or halo1_bands(orig, state[0], accs, ds, j0, j1)
    s = [x[:, j0:j1].clone(memory_format=torch.contiguous_format)
         for x in state]
    o = orig[:, j0:j1].contiguous()
    seams = halo1_k1_halos(o, s, fista, li, lm, bands)
    for rho, seam in zip((0.37, RHO2), seams):
        fused_iteration(o, s[0], s[1:1 + ndim], s[1 + ndim:] if fista else None,
                        torch.tensor(rho, device="cuda"), li, lm, fista=fista,
                        halos=seam(s[0]))
    torch.cuda.synchronize()
    return s


def compare_halo1(shape, fista, with_ref, j0, j1, grids=(None,),
                  strips=(None,), lossy=False):
    """The HALO1 pair on columns [j0, j1) of a random cube at each forced
    grid and strip against the plain pair with the same bands: state
    bitwise (``lossy``: d bfloat16, the LOSSY instantiation), sums within
    rtol 1e-5; without a reference cube also against two K=1 HALO launches,
    bitwise. Returns max |Δstate|."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    orig, state, li, lm = halo0_state(shape, fista, gen, lossy)
    if j0 > 0:
        require(state[2][:, j0].abs().max().item() > 0,
                "the shard's own axis-1 column 0 is zero")
    ref = orig + 0.1 if with_ref else None
    ps, psum = halo1_pair(fused_pair_iteration_reference, orig, state, fista,
                          li, lm, j0, j1, ref)
    err = 0.0
    for g in grids:
        for w in strips:
            ks, ksum = halo1_pair(fused_pair_iteration, orig, state, fista,
                                  li, lm, j0, j1, ref, grid=g,
                                  strip=shape[1] if w == "N1" else w)
            err = max(err, max((a.float() - b.float()).abs().max().item()
                               for a, b in zip(ks, ps)))
            require(all(a.dtype == b.dtype and torch.equal(a, b)
                        for a, b in zip(ks, ps)),
                    f"HALO1 pair {shape} columns [{j0}, {j1}) fista {fista} "
                    f"ref {with_ref} lossy {lossy} grid {g} strip {w}: state "
                    f"differs from the plain pair (max |Δ| {err})")
            torch.testing.assert_close(ksum, psum, rtol=1e-5, atol=0)
            del ks
    if ref is None:
        k1 = halo1_two_k1(orig, state, fista, li, lm, j0, j1)
        require(all(a.dtype == b.dtype and torch.equal(a, b)
                    for a, b in zip(k1, ps)),
                f"HALO1 pair {shape} columns [{j0}, {j1}) fista {fista} lossy "
                f"{lossy}: two K=1 HALO launches differ from the plain pair")
        del k1
    del ps, state, orig, ref
    torch.cuda.empty_cache()
    return err


def halo1_shards_equal_one_launch(shape, fista, with_ref, n_shards):
    """Column shards of a random cube, each paired by the HALO1 kernel with
    bands from the pre-update state and put back: bitwise one pair launch
    of the whole cube, the shards' sums adding up to its sums."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    orig, state, li, lm = halo0_state(shape, fista, gen)
    ndim = len(shape)
    ref = orig + 0.1 if with_ref else None
    whole = [x.clone() for x in state]
    out = fused_pair_iteration(
        orig, whole[0], whole[1:1 + ndim], whole[1 + ndim:] if fista else None,
        torch.tensor(0.37, device="cuda"), torch.tensor(RHO2, device="cuda"),
        li, lm, fista=fista, ref=ref)
    want = torch.stack(out[3:]).double().cpu()
    n1 = shape[1]
    bounds = [n1 * i // n_shards for i in range(n_shards + 1)]
    got = 0
    for j0, j1 in zip(bounds[:-1], bounds[1:]):
        s, sums = halo1_pair(fused_pair_iteration, orig, state, fista, li, lm,
                             j0, j1, ref)
        got = got + sums
        require(all(torch.equal(a, b[:, j0:j1]) for a, b in zip(s, whole)),
                f"{shape} fista {fista} ref {with_ref} in {n_shards} column "
                f"shards with bands != one pair launch")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    del whole, state, orig
    torch.cuda.empty_cache()


def column_bands(shape, fista, gen, first1, last1):
    """Random column bands for a shard of ``shape`` (the Jia-Zhao invariant
    held along axis 0 and the trailing axes): zeros where the shard holds
    a global edge."""
    ndim = len(shape)
    col = (shape[0], 1) + tuple(shape[2:])

    def rnd(scale, k=None):
        t = torch.randn(col, generator=gen, device="cuda") * scale
        if k is not None and k != 1:
            t.select(k, 0).zero_()
        return t

    h = {"p_r0_m2": rnd(0.05) + 2.0, "p_r0_m1": rnd(0.05) + 2.0,
         "p_orig_m1": rnd(0.5) + 2.0, "n_r0_c0": rnd(0.05) + 2.0,
         "n_r0_c1": rnd(0.05) + 2.0, "n_orig_c0": rnd(0.5) + 2.0,
         "n_acc1_c1": rnd(0.2)}
    for k in range(ndim):
        h[f"p_acc{k}_m1"], h[f"n_acc{k}_c0"] = rnd(0.2, k), rnd(0.2, k)
        if fista:
            h[f"p_d{k}_m1"], h[f"n_d{k}_c0"] = rnd(0.2, k), rnd(0.2, k)
    if fista:
        h["n_d1_c1"] = rnd(0.2)
    for key in h:
        if first1 and key.startswith("p_") or last1 and key.startswith("n_"):
            h[key].zero_()
    return h, first1, last1


def compare_halo1_shard(shape, fista, with_ref, first1, last1):
    """The HALO1 pair on a shard of ``shape`` (own state random, column 0's
    axis-1 accumulators nonzero unless ``first1``) with random column
    bands, against the plain pair and (without a reference cube) two K=1
    HALO launches: state bitwise, sums within rtol 1e-5. One copy of the
    shard's state at a time beside the plain one (config 4's (1, 2, 1, 1)
    shard: 21.5 GB each)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    orig, state, li, lm = halo0_state(shape, fista, gen)
    if not first1:
        state[2][:, 0].normal_(generator=gen).mul_(0.2)
    bands = column_bands(shape, fista, gen, first1, last1)
    ref = orig + 0.1 if with_ref else None
    n1 = shape[1]
    ps, psum = halo1_pair(fused_pair_iteration_reference, orig, state, fista,
                          li, lm, 0, n1, ref, bands)
    ks, ksum = halo1_pair(fused_pair_iteration, orig, state, fista, li, lm, 0,
                          n1, ref, bands)
    err = max((a - b).abs().max().item() for a, b in zip(ks, ps))
    require(all(torch.equal(a, b) for a, b in zip(ks, ps)),
            f"HALO1 pair at the shard {shape} (first1 {first1}, last1 "
            f"{last1}, ref {with_ref}): state differs (max |Δ| {err})")
    torch.testing.assert_close(ksum, psum, rtol=1e-5, atol=0)
    del ks
    if ref is None:
        k1 = halo1_two_k1(orig, state, fista, li, lm, 0, n1, bands)
        require(all(torch.equal(a, b) for a, b in zip(k1, ps)),
                f"HALO1 pair at the shard {shape} (first1 {first1}, last1 "
                f"{last1}): two K=1 HALO launches differ")
        del k1
    del ps, state, orig, bands, ref
    torch.cuda.empty_cache()
    return err


def time_halo1(shape, n_kernel, n_plain):
    """ms per pair at the shard ``shape`` FISTA f32 of the HALO1 kernel (an
    interior shard: bands on both sides), of the pair kernel without bands,
    of two K=1 HALO launches with the pair's axis-1 halos (built once,
    outside the timing) and of the plain pair with bands, in turns (plain,
    halo1, pair, k1, k1, pair, halo1, plain)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    orig, state, li, lm = halo0_state(shape, True, gen)
    ndim = len(shape)
    bands = column_bands(shape, True, gen, False, False)
    h = bands[0]
    rho1 = torch.tensor(0.37, device="cuda")
    rho2 = torch.tensor(RHO2, device="cuda")
    accs, ds = state[1:1 + ndim], state[1 + ndim:]
    args = (orig, state[0], accs, ds, rho1, rho2, li, lm)
    seams = halo1_k1_halos(orig, state, True, li, lm, bands)
    k1_halos = [seam(state[0]) for seam in seams]

    def two_k1():
        for rho, halos in zip((rho1, rho2), k1_halos):
            fused_iteration(orig, state[0], accs, ds, rho, li, lm, fista=True,
                            halos=halos)

    fns = {"halo1": lambda: fused_pair_iteration(
               *args, fista=True, halos1=h, first1=False, last1=False),
           "pair": lambda: fused_pair_iteration(*args, fista=True),
           "k1": two_k1,
           "plain": lambda: fused_pair_iteration_reference(
               *args, fista=True, halos1=h, first1=False, last1=False)}
    raw = {k: [] for k in fns}
    for name in ("plain", "halo1", "pair", "k1", "k1", "pair", "halo1",
                 "plain"):
        raw[name].append(time_ms(fns[name],
                                 n_plain if name == "plain" else n_kernel))
    del state, orig, h, bands, fns, args, k1_halos, seams
    torch.cuda.empty_cache()
    return {k: sum(v) / len(v) for k, v in raw.items()}, raw


#: bytes per piece of an array that :func:`digest` hashes on its own thread
DIGEST_PIECE = 64 * 2**20


def digest(a) -> str:
    """sha256 of the sha256 digests of an array's bytes (C order) in
    pieces of :data:`DIGEST_PIECE`, hashed on up to 8 threads (hashlib lets
    go of the GIL): equal digests, equal bits. One sha256 over a config-4
    cube's 4.29 GB takes seconds on one core, and the mesh phases hash
    dozens of them."""
    b = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    pieces = [b[i:i + DIGEST_PIECE]
              for i in range(0, max(b.size, 1), DIGEST_PIECE)]
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        parts = pool.map(lambda x: hashlib.sha256(x).digest(), pieces)
        return hashlib.sha256(b"".join(parts)).hexdigest()


def clean_handle(scan, det, rows):
    """The clean config-4 signal of the first ``rows`` scan rows as a lazy
    input: each block made when it is read."""
    shape = (rows,) + scan.shape[1:] + det.shape

    def read(sl):
        return (scan[sl[0], sl[1]][:, :, None, None]
                + det[sl[2], sl[3]][None, None])

    from cytvdn_tpu_torch.io.loaders import InputHandle

    return InputHandle(shape, np.float32, read)


def sharded_worker(spec_path: str) -> int:
    """One rank of a phase-9 or phase-10 mesh, started by :func:`run_mesh` with
    torchrun's environment: joins the group through ``init_distributed``
    (the spec's ``backend`` and ``device``, by default the rule's backend
    on the card), runs every run of the spec through ``denoise_sharded``
    and writes, per run, its digests, traces, seconds, exchange, launches
    and peak device memory to ``rank{R}.json`` beside the spec."""
    import torch.distributed as dist

    from cytvdn_tpu_torch.parallel import (
        denoise_sharded,
        init_distributed,
        pairfix,
    )

    with open(spec_path) as f:
        spec = json.load(f)
    on_card = spec.get("device", "cuda") == "cuda"
    require(init_distributed(backend=spec.get("backend"),
                             device=spec.get("device", "cuda")),
            "init_distributed found no environment")
    rank = dist.get_rank()
    backend = str(dist.get_backend())
    if on_card:
        build.load()
    results = []
    for run in spec["runs"]:
        src = run["input"]
        if run.get("rows"):
            src = np.load(src, mmap_mode="r")[:run["rows"]]
        ref = None
        if run.get("clean"):
            z = np.load(run["clean"])
            ref = clean_handle(z["scan"], z["det"], run["rows"])
        if run.get("reference"):
            ref = np.load(run["reference"], mmap_mode="r")
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        # every rank starts the run together (rank 0 digests the last
        # run's gathered cube meanwhile), so the seconds are the run's own
        dist.barrier()
        reset_counts()
        fused_pair_iteration.halo0_launches = 0
        fused_pair_iteration.halo1_launches = 0
        # "any_row": pairs at any row size (a small cube's mesh pairs);
        # "k1_loop": no pairs (the K=1 loop a mesh run pairs instead of);
        # "grid2d_pairs": 2D grids pair, with the seam repair
        rule = 0 if run.get("any_row") else \
            float("inf") if run.get("k1_loop") else None
        pairfix.PAIR_2D_GRIDS = bool(run.get("grid2d_pairs"))
        with pairs_at_any_row(rule) if rule is not None \
                else contextlib.nullcontext():
            out = denoise_sharded(
                src, np.full(run["ndim"], 1.0, np.float32),
                iterations=run["iterations"], FISTA=True,
                stopping_relative_change=run.get("stop"), reference_data=ref,
                shard=tuple(run["shard"]), quiet=True,
                **run.get("options", {}))
        res = {
            "name": run["name"], "rank": rank, "backend": backend,
            "launches": launch_counts(),
            "halo0": fused_pair_iteration.halo0_launches,
            "halo1": fused_pair_iteration.halo1_launches,
            "pair_lossy": fused_pair_iteration.lossy_launches,
            "k1_halo": fused_iteration.halo_launches,
            "modes": fused_iteration.mode_launches,
            "peak": torch.cuda.max_memory_allocated() if on_card else 0,
            "iterations_run": out["iterations_run"],
            "b_norm": out["b_norm"].tolist(), "delta": out["delta"].tolist(),
            "mse": out["mse"].tolist() if "mse" in out else None,
            "seconds": out["seconds"], "exchange": out["exchange"],
            "block": digest(out["block"]),
            "slices": [[s.start, s.stop] for s in out["slices"]],
            "recon": digest(out["recon"]) if out["recon"] is not None
            else None,
        }
        results.append(res)
        del out
    with open(os.path.join(os.path.dirname(spec_path),
                           f"rank{rank}.json"), "w") as f:
        json.dump(results, f)
    dist.destroy_process_group()
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_mesh(tmp, n_ranks, runs, timeout, worker="--sharded-worker",
             poll=None, **spec_kw):
    """Start ``n_ranks`` processes of this script as the ranks of a mesh
    (torchrun's environment: all on this host; ``worker``: the script's
    ``--sharded-worker`` or ``--cli-worker``), wait for them within
    ``timeout`` seconds, and return each rank's results. Any rank's
    failure, or the timeout, kills the others and raises. ``poll()``,
    where given, is called every 50 ms while the ranks run: once it
    returns True every rank is killed and the result is None.
    ``spec_kw`` (``backend``, ``device``; the command's ``argv``) goes to
    the workers' spec."""
    sub = tempfile.mkdtemp(prefix=f"mesh{n_ranks}_", dir=tmp)
    spec = os.path.join(sub, "spec.json")
    with open(spec, "w") as f:
        json.dump({"runs": runs, **spec_kw}, f)
    port = free_port()
    root = os.path.dirname(os.path.abspath(__file__))
    procs, logs = [], []
    for r in range(n_ranks):
        env = dict(os.environ, WORLD_SIZE=str(n_ranks), RANK=str(r),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n_ranks),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   PYTHONPATH=root)
        log_f = open(os.path.join(sub, f"rank{r}.log"), "w")
        logs.append(log_f)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), worker, spec],
            cwd=root, env=env, stdout=log_f, stderr=subprocess.STDOUT))
    t_end = time.perf_counter() + timeout
    stopped = False
    try:
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.poll() not in (None, 0)]
            if failed or time.perf_counter() > t_end:
                break
            if poll is not None and poll():
                stopped = True
                break
            time.sleep(0.05 if poll is not None else 0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    if stopped:
        return None
    rcs = [p.returncode for p in procs]
    if any(rcs):
        tails = []
        for r in range(n_ranks):
            with open(os.path.join(sub, f"rank{r}.log")) as f:
                tails.append(f"rank {r} (rc {rcs[r]}):\n" + f.read()[-3000:])
        raise AssertionError(f"mesh of {n_ranks} ranks failed: "
                             + "\n".join(tails))
    out = []
    for r in range(n_ranks):
        with open(os.path.join(sub, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def cli_worker(spec_path: str) -> int:
    """One rank of a phase-8 (f) or phase-9 (g) command-line mesh, started by
    :func:`run_mesh` with torchrun's environment: the command's steps with
    the spec's ``argv`` — ``cli.load_and_solve``, and ``cli.write_output``
    where the spec says so (h5py present) — with every rank's log lines
    (``CYTV_LOG_ALL_PROCS``); writes the rank's digests (block, and the
    gathered recon on rank 0), launches, seconds, checkpoint saves, resume
    point, checkpoint warnings, the exchange's statistics, an out-of-core
    run's rows and ``outofcore.last_run`` record, and peak device memory
    to ``rank{R}.json`` beside the spec. ``hang_after_save`` in the spec
    stops the rank after its first checkpoint save, to be killed there;
    ``split_call`` then runs :func:`split_call` with ``shard_w=2`` on the
    same group and records its recon's digest and HALO1 pairs."""
    import torch.distributed as dist

    from cytvdn_tpu_torch import cli

    with open(spec_path) as f:
        spec = json.load(f)
    os.environ["CYTV_LOG_ALL_PROCS"] = "1"
    if spec.get("hang_after_save"):
        # stop after the first checkpoint generation (after its post-save
        # collective: every part is on disk), to be killed there
        outofcore._POST_CKPT_HOOK = lambda it_run: time.sleep(3600)
    on_card = torch.cuda.is_available()
    if on_card:
        build.load()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    fused_pair_iteration.halo0_launches = 0
    fused_pair_iteration.halo1_launches = 0
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        run = cli.load_and_solve(spec["argv"])
        if spec["write"]:
            cli.write_output(run)
    rank = dist.get_rank()
    res = {
        "rank": rank, "launches": launch_counts(),
        "halo0": fused_pair_iteration.halo0_launches,
        "halo1": fused_pair_iteration.halo1_launches,
        "k1_halo": fused_iteration.halo_launches,
        "iterations_run": int(np.count_nonzero(run.delta)),
        "seconds": run.seconds, "saves": run.saves,
        "resumed_from": run.resumed_from,
        "warnings": [str(w.message) for w in rec
                     if "disagree" in str(w.message)],
        "exchange": run.exchange, "rows": run.rows, "cols": run.cols,
        "column_exchange": run.column_exchange,
        "lossy": [fused_pair_iteration.lossy_launches,
                  fused_iteration.lossy_launches],
        "ooc": dict(outofcore.last_run) if run.rows else None,
        "peak": torch.cuda.max_memory_allocated() if on_card else 0,
        "block": digest(run.block),
        "recon": digest(run.recon) if run.recon is not None else None,
    }
    if spec.get("split_call"):
        h1, t0 = fused_pair_iteration.halo1_launches, time.perf_counter()
        recon = split_call(spec["split_call"], shard_w=2)
        res["split_call"] = {
            "recon": digest(recon) if recon is not None else None,
            "halo1": fused_pair_iteration.halo1_launches - h1,
            "seconds": time.perf_counter() - t0}
    with open(os.path.join(os.path.dirname(spec_path),
                           f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
    return 0


def checkpoint_generations(path, n_ranks=2):
    """The iteration of each rank's part of a checkpoint on disk (-1 where
    it is not there yet). Parts are renamed into place whole, so a part
    that exists is complete."""
    gens = []
    for r in range(n_ranks):
        try:
            with np.load(path if r == 0 else f"{path}.p{r}") as z:
                gens.append(int(z["i"]))
        except FileNotFoundError:
            gens.append(-1)
    return gens


def cli_mesh_phase(smi, tmp, cube_npy, digests4, cube3, cfg3_digest):
    """Phase 9 (g): the command line on meshes of 2 processes sharing the
    card. (i) config 4 x20 from the .npy against ``denoise4D``'s digests;
    (ii) config 3 hybrid (20, 12) with a checkpoint every 8 iterations,
    killed after the second generation and resumed, against phase 6's
    uninterrupted run; (iii) the same resume with rank 1's part swapped
    for an older generation. Returns the ranks' results of (i) and
    (ii)."""
    try:
        import h5py  # noqa: F401
        write = True
    except ImportError:
        write = False
    how = ("cli.load_and_solve + cli.write_output (the steps of python -m "
           "cytvdn_tpu_torch.cli)" if write else
           "cli.load_and_solve (h5py is missing: no EMD output written)")

    def lines(tag, runs):
        for r in runs:
            sec = r["seconds"]
            wrote = (f"write {sec['write']} s" if "write" in sec
                     else "write not run (no h5py)")
            log(f"phase 9 (g) {tag} rank {r['rank']}: load "
                f"{sec['load']} s, solve {sec['solve']} s, gather "
                f"{sec['gather']} s, {wrote}; launches "
                f"whole-run/K-step/pair/fused {tuple(r['launches'])}, HALO0 "
                f"pairs {r['halo0']}, K=1 halo launches {r['k1_halo']}; "
                f"saves (copy s, write s, bytes) "
                f"{[(sv['copy'], sv['write'], sv['bytes']) for sv in r['saves']]}"
                f"; peak device memory {r['peak'] / 2**30:.3f} GiB [{smi}]")

    # (i) config 4 x20
    t0 = time.perf_counter()
    out4 = os.path.join(tmp, "config4.emd")
    g1 = run_mesh(tmp, 2, None, timeout=300, worker="--cli-worker",
                  write=write, argv=["-i", cube_npy, "-o", out4, "-m", "1.0",
                                     "-n", "20", "-f", "1", "--shard",
                                     "2,1,1,1"])
    blocks_want, full_want = digests4
    for r in g1:
        require(r["block"] == blocks_want[r["rank"]],
                f"(g) (i) rank {r['rank']}: block not bitwise denoise4D's")
        require(tuple(r["launches"]) == (0, 0, 10, 0) and r["halo0"] == 10
                and r["iterations_run"] == 20,
                f"(g) (i) rank {r['rank']}: launches {r['launches']}, HALO0 "
                f"{r['halo0']}, {r['iterations_run']} iterations")
    require(g1[0]["recon"] == full_want,
            "(g) (i) the gathered recon is not bitwise denoise4D's")
    if write:
        from cytvdn_tpu_torch.io.emd import read_emd

        require(digest(read_emd(out4)) == full_want,
                "(g) (i) the EMD output is not bitwise denoise4D's recon")
        os.remove(out4)
    log(f"phase 9 (g) (i) {how} --shard 2,1,1,1 on config 4 {CFG4} FISTA "
        f"x20 from a .npy, 2 processes sharing the card (gloo): each block "
        f"and the gathered recon bitwise denoise4D's (sha256), 10 HALO0 "
        f"pairs per rank; {time.perf_counter() - t0:.1f} s [{smi}]")
    lines("(i)", g1)

    # (ii) config 3 hybrid (20, 12), a checkpoint every 8, killed, resumed
    t0 = time.perf_counter()
    cfg3_npy = os.path.join(tmp, "config3.npy")
    np.save(cfg3_npy, cube3)
    ck = os.path.join(tmp, "config3.ckpt.npz")
    old = os.path.join(tmp, "config3.ckpt.old")
    argv3 = ["-i", cfg3_npy, "-o", os.path.join(tmp, "config3.emd"), "-m",
             "1.0", "-n", "20", "12", "--shard", "2,1,1,1", "--checkpoint",
             ck, "--checkpoint-every", "8"]
    seen = {}

    def second_generation():
        gens = checkpoint_generations(ck)
        seen["gens"] = gens
        if gens[1] == 8 and not os.path.exists(old):
            # rank 1's first part, kept for (iii)
            shutil.copy(ck + ".p1", old)
        return min(gens) >= 16

    killed = run_mesh(tmp, 2, None, timeout=300, worker="--cli-worker",
                      poll=second_generation, write=write, argv=argv3)
    s_kill = time.perf_counter() - t0
    require(killed is None, "(g) (ii) the run ended before its second "
                            "checkpoint generation")
    gens = checkpoint_generations(ck)
    require(gens == [16, 16], f"(g) (ii) parts on disk after the kill: {gens}")
    with np.load(old) as z:
        old_i = int(z["i"])
    t1 = time.perf_counter()
    g2 = run_mesh(tmp, 2, None, timeout=300, worker="--cli-worker",
                  write=write, argv=argv3 + ["--resume", "1"])
    s_res = time.perf_counter() - t1
    for r in g2:
        require(r["resumed_from"] == 16 and not r["warnings"]
                and r["iterations_run"] == 32 and len(r["saves"]) == 2,
                f"(g) (ii) rank {r['rank']}: resumed from "
                f"{r['resumed_from']}, warnings {r['warnings']}, "
                f"{r['iterations_run']} iterations, {len(r['saves'])} saves")
        require(tuple(r["launches"]) == (0, 0, 0, 16) and r["k1_halo"] == 16,
                f"(g) (ii) rank {r['rank']}: launches {r['launches']}")
    require(g2[0]["recon"] == cfg3_digest,
            "(g) (ii) the resumed recon is not bitwise phase 6's "
            "uninterrupted run")
    log(f"phase 9 (g) (ii) {how} on config 3 {CFG3} hybrid (20, 12) "
        f"--shard 2,1,1,1 --checkpoint-every 8: both processes killed once "
        f"the parts of iteration 16 were on disk ({gens}; "
        f"{s_kill:.1f} s), then --resume 1: both ranks resumed from "
        f"iteration 16, 16 K=1 halo launches each, recon bitwise phase 6's "
        f"uninterrupted run; the resumed launch {s_res:.1f} s [{smi}]")
    lines("(ii)", g2)

    # (iii) rank 1's part one or two generations older: a fresh start
    t1 = time.perf_counter()
    os.replace(old, ck + ".p1")
    g3 = run_mesh(tmp, 2, None, timeout=300, worker="--cli-worker",
                  write=write, argv=argv3 + ["--resume", "1"])
    for r in g3:
        require(r["resumed_from"] is None and len(r["warnings"]) == 1
                and r["iterations_run"] == 32 and len(r["saves"]) == 4,
                f"(g) (iii) rank {r['rank']}: resumed from "
                f"{r['resumed_from']}, warnings {r['warnings']}, "
                f"{len(r['saves'])} saves")
    require(g3[0]["recon"] == cfg3_digest,
            "(g) (iii) the restarted recon is not bitwise phase 6's run")
    log(f"phase 9 (g) (iii) the same with rank 1's part of iteration "
        f"{old_i} beside rank 0's of 32: both ranks warned "
        f"({g3[0]['warnings'][0]!r}) and started afresh, recon bitwise "
        f"phase 6's run; {time.perf_counter() - t1:.1f} s [{smi}]")
    lines("(iii)", g3)
    return g1, g2


def check_mesh_run(name, results, want, blocks_want, full_want, mse=False,
                   gather=True):
    """Each rank's result of run ``name`` against the single-device run:
    the block and (rank 0) the gathered cube bitwise (their digests; a run
    started with ``gather=False`` has the blocks alone, and no gathered
    cube), the stop iteration, traces within rtol 1e-5."""
    runs = [next(x for x in res if x["name"] == name) for res in results]
    n_run = int(np.count_nonzero(want["delta"]))
    for run in runs:
        r = run["rank"]
        require(run["iterations_run"] == n_run,
                f"{name} rank {r}: {run['iterations_run']} iterations, the "
                f"single-device run {n_run}")
        require(run["block"] == blocks_want[r],
                f"{name} rank {r}: block not bitwise the single-device "
                f"recon's")
        for key in ("b_norm", "delta") + (("mse",) if mse else ()):
            np.testing.assert_allclose(np.asarray(run[key], np.float32),
                                       want[key], rtol=1e-5,
                                       err_msg=f"{name} rank {r} {key}")
    if gather:
        require(runs[0]["recon"] == full_want,
                f"{name}: the gathered recon on rank 0 is missing or not "
                f"bitwise the single-device recon")
    else:
        require(runs[0]["recon"] is None,
                f"{name}: started with gather=False, yet rank 0 has a "
                f"gathered recon")
    return runs


def rank_lines(name, runs, smi):
    """One line per rank of run ``name`` (phase 9 (f)): the seconds per
    iteration of the solve, the exchange's seconds and bytes, the backend,
    the launches and the peak device memory."""
    for run in runs:
        n = max(run["iterations_run"], 1)
        x = run["exchange"]
        log(f"{name} rank {run['rank']} ({run['backend']}): "
            f"solve {run['seconds']['solve']:.3f} s = "
            f"{run['seconds']['solve'] / n * 1e3:.2f} ms per iteration; "
            f"exchange {x['exchange_seconds']:.3f} s in {x['exchanges']} "
            f"exchanges, {x['bytes_sent'] / 1e9:.3f} GB sent, "
            f"{x['bytes_received'] / 1e9:.3f} GB received; allsum "
            f"{x['allsum_seconds']:.3f} s in {x['allsums']} (waits for the "
            f"other ranks included); load {run['seconds']['load']:.2f} s, "
            f"gather of the recon {run['seconds']['gather']:.2f} s "
            f"({x['gather_bytes'] / 1e9:.3f} GB); launches whole-run/K-step/"
            f"pair/fused {tuple(run['launches'])}, of them HALO0 pairs "
            f"{run['halo0']}, HALO1 pairs {run['halo1']}, K=1 halo launches "
            f"{run['k1_halo']}; peak "
            f"device memory {run['peak'] / 2**30:.2f} GiB [{smi}]")


def single(fn, want_keys=("recon", "b_norm", "delta")):
    """A single-device API run's outputs as a dict, with the device memory
    given back."""
    out = fn()
    torch.cuda.empty_cache()
    return dict(zip(want_keys + (("mse",) if len(out) == 4 else ()), out))


def blocks(recon, shard):
    """The digest of each rank's block of ``recon`` on ``shard``, in rank
    order, and of the whole."""
    from cytvdn_tpu_torch.parallel.multihost import block_slices, rank_coords

    n = math.prod(shard)
    return ([digest(recon[block_slices(recon.shape, shard,
                                       rank_coords(shard, r))])
             for r in range(n)], digest(recon))


def halo1_cases(smi, bw, f32):
    """Phase 9 (a), the HALO1 part: the pair with axis-1 bands against its
    plain version on the first (2 columns), an interior (3) and the last
    (2) column shard of small cubes, FISTA and unaccelerated, with and
    without a reference cube, at grids full, 1 and 7 and strips default, 1
    and N1, and without a reference cube against two K=1 HALO launches;
    the LOSSY HALO1 instantiations the same at the default grid and a
    forced strip of 2; the cubes in 2, 3 and 4 column shards against one
    launch; config 4's (1, 2, 1, 1) shard (both ranks' sides, one with a
    reference cube, and an interior shard) against its plain version and
    two K=1 HALO launches; and its time at that shard against its bound.
    Returns the kernels line's numbers."""
    t0 = time.perf_counter()
    n_cases, err = 0, 0.0
    for shape in HALO1_SMALL:
        n1 = shape[1]
        for fista in (True, False):
            for with_ref in (False, True):
                for j0, j1 in ((0, 2), (2, 5), (n1 - 2, n1)):
                    err = max(err, compare_halo1(
                        shape, fista, with_ref, j0, j1, grids=(None, 1, 7),
                        strips=(None, 1, "N1")))
                    n_cases += 1
                    if fista:
                        err = max(err, compare_halo1(
                            shape, True, with_ref, j0, j1, strips=(None, 2),
                            lossy=True))
                        n_cases += 1
                for n_shards in (2, 3, 4):
                    if n1 // n_shards >= 2:
                        halo1_shards_equal_one_launch(shape, fista, with_ref,
                                                      n_shards)
    big = {}
    for with_ref, first1, last1 in ((False, False, True), (True, True, False),
                                    (False, False, False)):
        big[(with_ref, first1, last1)] = compare_halo1_shard(
            SHARD41, True, with_ref, first1, last1)
    err = max(err, *big.values())
    t_h1, raw = time_halo1(SHARD41, 3, 1)
    # the interior shard's bands: 11 column slabs from the -1 shard, 13
    # from the +1 shard
    halo_elems = 24 * SHARD41[0] * SHARD41[2] * SHARD41[3]
    b_ms, b_by = (launch_bound_seconds(SHARD41, True, 2, bw, f32,
                                       halo_elems=halo_elems)
                  if bw and f32 else (float("nan"), None))
    b_ms *= 1e3
    log(f"phase 9 (a) HALO1 pair vs the plain pair with the same column "
        f"bands: {n_cases} shard cases ({HALO1_SMALL}; FISTA, unaccelerated "
        f"and LOSSY, with and without a reference cube, the first, an "
        f"interior and the last column shard of 2, 3 and 2 columns; grids "
        f"full, 1 and 7, strips default, 1 and N1; LOSSY at the full grid, "
        f"strips default and 2) and config 4's (1, 2, 1, 1) shard {SHARD41} "
        f"FISTA (the second rank, with a nonzero own column 0 and the cube's "
        f"last column; the first with a reference cube; an interior shard), "
        f"state bitwise (max |Δ| {err}), sums within rtol 1e-5; without a "
        f"reference cube also bitwise two K=1 HALO launches with the axis-1 "
        f"halos the bands give; the small cubes in 2, 3 and 4 column shards "
        f"with bands = one pair launch, bitwise; at {SHARD41} FISTA "
        f"(interior): HALO1 pair {t_h1['halo1']:.3f} ms "
        f"({b_ms / t_h1['halo1']:.3f} of its {b_ms:.2f} ms bound, {b_by}, "
        f"24 column slabs), the pair without bands {t_h1['pair']:.3f} ms, "
        f"two K=1 HALO launches {t_h1['k1']:.3f} ms, plain pair with bands "
        f"{t_h1['plain']:.3f} ms (runs {raw}); "
        f"{time.perf_counter() - t0:.1f} s [{smi}]")
    return {"err": err, "ms": t_h1["halo1"], "plain_ms": t_h1["plain"],
            "bound": (b_ms, b_by)}


def sharded_phase(smi, name, cube, scan, det, cube3, cfg3_digest):
    """Phase 9: (a) the HALO0 pair against its plain version (small cubes
    cut into slabs at forced grids and strips, reassembled against one
    launch, and config 4's 2-rank shard with and without a reference cube)
    and its time, and the HALO1 pair the same way (:func:`halo1_cases`);
    (b) config 4 x20 on a (2, 1, 1, 1) mesh of 2 processes sharing the
    card, and on a (1, 2, 1, 1) mesh in HALO1 pairs against the same
    single-device run, (d) a stop run and an MSE x20 run on (2, 1, 1, 1) at
    half of config 4's rows, (e) config 2 with stop 0.05 on (2, 1, 1) read
    lazily from a .npy, and (c) config 4 x4 on a (2, 2, 1, 1) mesh of 4
    processes, each against the single-device run; (f) per-rank seconds,
    exchange and memory; (g) the command line on meshes of 2 processes
    (:func:`cli_mesh_phase`; config 3 ``cube3`` against phase 6's recon,
    ``cfg3_digest``); (a) also holds the K=1 kernel's halos against its
    plain version at the shards (c) and (e) give it. Returns the numbers of
    the kernels line's HALO0 and HALO1 rows."""
    t_phase = time.perf_counter()
    # (a) the kernel against its plain version
    t0 = time.perf_counter()
    n_cases, err = 0, 0.0
    for shape in HALO0_SMALL:
        n0 = shape[0]
        for fista in (True, False):
            for with_ref in (False, True):
                for a0, a1 in ((0, 4), (4, 8), (n0 - 4, n0)):
                    err = max(err, compare_halo0(
                        shape, fista, with_ref, a0, a1, grids=(None, 1, 7),
                        strips=(None, 1, 2, "N1")))
                    n_cases += 1
                for n_slabs in (1, 2, 3):
                    if n0 // n_slabs >= 4:
                        halo0_slabs_equal_one_launch(shape, fista, with_ref,
                                                     n_slabs)
    big = {}
    for with_ref, first0, last0 in ((False, False, True), (True, True, False),
                                    (False, False, False)):
        big[(with_ref, first0, last0)] = compare_halo0_shard(
            SHARD4, True, with_ref, first0, last0)
    err = max(err, *big.values())
    # the K=1 halo launches of (c) and (e) at their shards: config 4's
    # (2, 2, 1, 1) block with neighbours on both axes, config 2's (2, 1, 1)
    # block with neighbours on axis 0
    k1_err = 0.0
    for shape, where in ((QUAD4, "block"), (SHARD2, "slab")):
        for fista in (True, False):
            k1_err = max(k1_err, compare_halo_case(shape, fista,
                                                   torch.float32, where))
    log(f"phase 9 (a) K=1 kernel with halos vs its plain version (3 "
        f"launches each, FISTA and unaccelerated f32): {QUAD4} with "
        f"neighbours' halos on axes 0 and 1, {SHARD2} with neighbours' "
        f"halos on axis 0; state bitwise (max |Δ| {k1_err}), sums within "
        f"rtol 1e-5 [{smi}]")
    t_h0, raw = time_halo0(SHARD4, 3, 1)
    bw, f32 = peak_bandwidth(name), peak_f32(name)
    # the interior shard's bands: 11 rows from the -1 shard, 13 from the +1
    # shard
    band_rows = 11 + 13
    b_ms, b_by = (launch_bound_seconds(SHARD4, True, 2, bw, f32,
                                       band_rows=band_rows)
                  if bw and f32 else (float("nan"), None))
    b_ms *= 1e3
    h1 = halo1_cases(smi, bw, f32)
    log(f"phase 9 (a) HALO0 pair vs the plain pair with the same bands: "
        f"{n_cases} slab cases ({HALO0_SMALL}; FISTA and unaccelerated, with "
        f"and without a reference cube, the first, an interior and the last "
        f"4-row slab; grids full, 1 and 7, strips default, 1, 2 and N1) and "
        f"config 4's 2-rank shard {SHARD4} FISTA (the second rank, with a "
        f"nonzero own row 0 and the cube's last row; the first with a "
        f"reference cube; an interior shard), state bitwise (max |Δ| {err}), "
        f"sums within rtol 1e-5; the small cubes in 1, 2 and 3 slabs with "
        f"bands = one pair launch, bitwise; at {SHARD4} FISTA (interior): "
        f"HALO0 pair {t_h0['halo0']:.3f} ms ({b_ms / t_h0['halo0']:.3f} of "
        f"its {b_ms:.2f} ms bound, {b_by}, {band_rows} band rows), the pair "
        f"without bands {t_h0['pair']:.3f} ms, plain pair with bands "
        f"{t_h0['plain']:.3f} ms (runs {raw}); "
        f"{time.perf_counter() - t0:.1f} s [{smi}]")

    # single-device references, then the meshes
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="cytv_mesh_")
    try:
        mu4 = np.full(4, 1.0, np.float32)
        cube_npy = os.path.join(tmp, "config4.npy")
        np.save(cube_npy, cube)
        clean_npz = os.path.join(tmp, "clean.npz")
        np.savez(clean_npz, scan=scan, det=det)
        half = cube[:HALF4[0]]
        ref_half = (scan[:HALF4[0], :, None, None]
                    + det[None, None]).astype(np.float32)
        want = {}
        want["b"] = single(lambda: denoise4D(cube, mu4, iterations=20,
                                             quiet=True, device="cuda"))
        want["c"] = single(lambda: denoise4D(cube, mu4, iterations=4,
                                             quiet=True, device="cuda"))
        fixed = single(lambda: denoise4D(half, mu4, iterations=64,
                                         quiet=True, device="cuda"))
        thr_d, stop_d = stop_threshold(torch.from_numpy(fixed["delta"]), 40)
        want["d1"] = single(lambda: denoise4D(
            half, mu4, iterations=64, stopping_relative_change=thr_d,
            quiet=True, device="cuda"))
        require(int(np.count_nonzero(want["d1"]["delta"])) == stop_d,
                f"half config 4 stop after "
                f"{np.count_nonzero(want['d1']['delta'])}, expected {stop_d}")
        want["d2"] = single(lambda: denoise4D(
            half, mu4, iterations=20, reference_data=ref_half, quiet=True,
            device="cuda"))
        clean2, noisy2 = cfg2_eels()
        del clean2
        cfg2_npy = os.path.join(tmp, "config2.npy")
        np.save(cfg2_npy, noisy2)
        want["e"] = single(lambda: denoise3D(
            noisy2, np.full(3, 1.0, np.float32), iterations=500, FISTA=True,
            stopping_relative_change=0.05, quiet=True, device="cuda"))
        del noisy2, ref_half, fixed
        shards = {"b": (2, 1, 1, 1), "c": (2, 2, 1, 1), "d1": (2, 1, 1, 1),
                  "d2": (2, 1, 1, 1), "e": (2, 1, 1), "b1": (1, 2, 1, 1),
                  "b1k": (1, 2, 1, 1)}
        # (b1): config 4 x20 on (1, 2, 1, 1) in pairs, held to (b)'s
        # single-device run; x4 there on the K=1 loop, held to (c)'s
        want["b1"], want["b1k"] = want["b"], want["c"]
        digests = {k: blocks(w["recon"], shards[k]) for k, w in want.items()}
        for w in want.values():
            w.pop("recon", None)
        torch.cuda.empty_cache()
        log(f"phase 9 single-device references (config 4 x20 and x4, "
            f"{HALF4} stop {thr_d:.6e} after {stop_d} and MSE x20, config 2 "
            f"stop 0.05 after {int(np.count_nonzero(want['e']['delta']))}), "
            f"the .npy inputs and the digests: "
            f"{time.perf_counter() - t0:.1f} s")

        # two ranks on the card: (b), (d), (e)
        t0 = time.perf_counter()
        runs2 = [
            dict(name="b", input=cube_npy, ndim=4, iterations=20,
                 shard=shards["b"]),
            dict(name="b1", input=cube_npy, ndim=4, iterations=20,
                 shard=shards["b1"]),
            # the blocks alone: the K=1 loop's runs skip the gather
            dict(name="b1k", input=cube_npy, ndim=4, iterations=4,
                 shard=shards["b1k"], k1_loop=True,
                 options={"gather": False}),
            dict(name="d1", input=cube_npy, rows=HALF4[0], ndim=4,
                 iterations=64, stop=thr_d, shard=shards["d1"]),
            dict(name="d2", input=cube_npy, rows=HALF4[0], ndim=4,
                 iterations=20, clean=clean_npz, shard=shards["d2"]),
            dict(name="e", input=cfg2_npy, ndim=3, iterations=500,
                 stop=0.05, shard=shards["e"]),
        ]
        res2 = run_mesh(tmp, 2, runs2, timeout=420)
        wall2 = time.perf_counter() - t0
        rows = {}
        for run in runs2:
            k = run["name"]
            rows[k] = check_mesh_run(
                k, res2, want[k], *digests[k], mse=k == "d2",
                gather=run.get("options", {}).get("gather", True))
        b = rows["b"]
        require(all(tuple(r["launches"]) == (0, 0, 10, 0) and r["halo0"] == 10
                    for r in b),
                f"(b) launches per rank {[r['launches'] for r in b]}, "
                f"HALO0 {[r['halo0'] for r in b]}: expected 10 HALO0 pairs")
        require(all(r["halo0"] == 10 and r["k1_halo"] == 0
                    for r in rows["d2"]), "(d) MSE run: 10 HALO0 pairs each")
        require(all(r["halo0"] > 0 for r in rows["d1"]),
                "(d) stop run: no HALO0 pair")
        require(all(r["halo0"] == 0 and r["k1_halo"] == r["iterations_run"]
                    for r in rows["e"]), "(e) config 2: K=1 halo steps only")
        log(f"phase 9 (b) config 4 {CFG4} FISTA x20 on a (2, 1, 1, 1) mesh, "
            f"2 processes sharing the one card (gloo): recon bitwise "
            f"denoise4D's on one device (each block and the gathered cube), "
            f"traces within rtol 1e-5 on both ranks; 10 HALO0 pairs per rank "
            f"({[r['launches'] for r in b]}); the 2-rank group's 4 runs and "
            f"its start {wall2:.1f} s [{smi}]")
        rank_lines("phase 9 (f) (b)", b, smi)
        b1 = rows["b1"]
        require(all(tuple(r["launches"]) == (0, 0, 10, 0) and r["halo1"] == 10
                    and r["halo0"] == 0 and r["k1_halo"] == 0 for r in b1),
                f"(b1) launches per rank {[r['launches'] for r in b1]}, "
                f"HALO1 {[r['halo1'] for r in b1]}: expected 10 HALO1 pairs")
        log(f"phase 9 (b1) config 4 {CFG4} FISTA x20 on a (1, 2, 1, 1) mesh, "
            f"2 processes sharing the card (gloo), shards {SHARD41} (8 MiB "
            f"rows): recon bitwise (b)'s denoise4D run on one device (each "
            f"block and the gathered cube, sha256), traces within rtol 1e-5 "
            f"on both ranks; 10 HALO1 pairs per rank "
            f"({[r['launches'] for r in b1]}), no K=1 launch [{smi}]")
        rank_lines("phase 9 (f) (b1)", b1, smi)
        b1k = rows["b1k"]
        require(all(tuple(r["launches"]) == (0, 0, 0, 4) and r["k1_halo"] == 4
                    for r in b1k),
                f"(b1k) launches per rank {[r['launches'] for r in b1k]}")

        def per_pair(r, n_pairs):
            x = r["exchange"]
            return (f"rank {r['rank']}: {x['bytes_sent'] / n_pairs / 1e9:.4f}"
                    f" GB sent, {x['bytes_received'] / n_pairs / 1e9:.4f} GB "
                    f"received")

        log(f"phase 9 (b1) the exchange per two iterations on (1, 2, 1, 1): "
            f"in HALO1 pairs (x20, the orig columns once) "
            f"{[per_pair(r, 10) for r in b1]}; on the K=1 loop (x4, config 4 "
            f"with the pair rule set above every row, bitwise (c)'s "
            f"single-device x4 run, 4 K=1 halo launches per rank) "
            f"{[per_pair(r, 2) for r in b1k]} [{smi}]")
        rank_lines("phase 9 (f) (b1k)", b1k, smi)
        log(f"phase 9 (d) {HALF4} FISTA on (2, 1, 1, 1): the stop run "
            f"(stop {thr_d:.6e}) stops after {rows['d1'][0]['iterations_run']} "
            f"as on one device, HALO0 pairs behind the guard "
            f"{[r['halo0'] for r in rows['d1']]} and K=1 halo steps "
            f"{[r['k1_halo'] for r in rows['d1']]} per rank, peak "
            f"{[round(r['peak'] / 2**30, 2) for r in rows['d1']]} GiB (state "
            f"and block checkpoint); the MSE x20 run with the clean cube: "
            f"10 HALO0 pairs with the reference cube per rank, MSE within "
            f"rtol 1e-5; both recons bitwise. Config 4 itself does not fit "
            f"this way: 2 x (20 GiB state + 20 GiB checkpoint) is more than "
            f"the one card [{smi}]")
        rank_lines("phase 9 (f) (d) stop", rows["d1"], smi)
        rank_lines("phase 9 (f) (d) MSE", rows["d2"], smi)
        log(f"phase 9 (e) config 2 {CFG2} FISTA stop 0.05 on (2, 1, 1), "
            f"blocks read lazily from a .npy: stops after "
            f"{rows['e'][0]['iterations_run']} as on one device, recon "
            f"bitwise; its 2 MiB rows take the K=1 kernel with halos "
            f"({[r['k1_halo'] for r in rows['e']]} halo launches) [{smi}]")
        rank_lines("phase 9 (f) (e)", rows["e"], smi)

        # four ranks on the card: (c), in pairs with the seam repair
        # (2D-grid pairs set) and on the K=1 loop (the default there)
        t0 = time.perf_counter()
        res4 = run_mesh(tmp, 4, [
            dict(name="c", input=cube_npy, ndim=4, iterations=4,
                 shard=shards["c"], grid2d_pairs=True),
            dict(name="ck", input=cube_npy, ndim=4, iterations=4,
                 shard=shards["c"], options={"gather": False})],
            timeout=300)
        c = check_mesh_run("c", res4, want["c"], *digests["c"])
        ck = check_mesh_run("ck", res4, want["c"], *digests["c"],
                            gather=False)
        require(all(tuple(r["launches"]) == (0, 0, 2, 0) and r["halo0"] == 2
                    and r["k1_halo"] == 0 for r in c),
                f"(c) launches per rank {[r['launches'] for r in c]}, HALO0 "
                f"{[r['halo0'] for r in c]}: expected 2 HALO0 pairs")
        require(all(r["k1_halo"] == 4 and r["halo0"] == 0
                    and r["exchange"]["seam_exchanges"] == 0 for r in ck),
                f"(c) K=1 loop (the 2D grid's default): K=1 halo launches "
                f"{[r['k1_halo'] for r in ck]}, HALO0 pairs "
                f"{[r['halo0'] for r in ck]}")

        def per_it(runs):
            return [round(r["seconds"]["solve"] / r["iterations_run"], 4)
                    for r in runs]

        def seam(r):
            x = r["exchange"]
            return (f"rank {r['rank']}: {x['seam_exchanges']} exchanges, "
                    f"{x['seam_bytes_sent'] / 1e9:.4f} GB sent, "
                    f"{x['seam_bytes_received'] / 1e9:.4f} GB received, "
                    f"{x['seam_exchange_seconds']:.3f} s")

        log(f"phase 9 (c) config 4 FISTA x4 on a (2, 2, 1, 1) mesh, 4 "
            f"processes sharing the card (gloo), shards {QUAD4}: in 2 HALO0 "
            f"pairs per rank with the axis-1 seam repair (2D-grid pairs "
            f"set), recon bitwise denoise4D's (each block and the gathered "
            f"cube), traces within rtol 1e-5; on the K=1 loop (the 2D "
            f"grid's default) 4 K=1 halo launches per rank, bitwise; s per "
            f"iteration per rank in pairs {per_it(c)}, on the K=1 loop "
            f"{per_it(ck)}; "
            f"the seam repair's exchanges (columns and strip rows) "
            f"{[seam(r) for r in c]}; {time.perf_counter() - t0:.1f} s "
            f"[{smi}]")
        rank_lines("phase 9 (f) (c)", c, smi)
        rank_lines("phase 9 (f) (c) K=1 loop", ck, smi)

        # (g) the command line on meshes of 2 processes
        t0 = time.perf_counter()
        cli_mesh_phase(smi, tmp, cube_npy, digests["b"], cube3, cfg3_digest)
        log(f"phase 9 (g) {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 9 {time.perf_counter() - t_phase:.1f} s")
    return {"launches": b[0]["halo0"], "err": err, "ms": t_h0["halo0"],
            "plain_ms": t_h0["plain"], "bound": (b_ms, b_by),
            "halo1": dict(h1, launches=b1[0]["halo1"])}


# phase 10: the K=1 kernel's mesh-only modes (ring halos, mirror edges, iso
# seams and corners, in-block halos) against its plain version, and meshes
# in those modes against the single-device runs

QUAD2 = (128, 128, 2048)        # config 2's block on a (2, 2, 1) mesh
QSPLIT4 = (256, 256, 64, 128)   # config 4's block on a (1, 1, 2, 1) mesh
STEM4D_ISO = {k: v for k, v in (("isotropic_R", True),
                                ("isotropic_Q", True))}
#: the mesh shards of (b), each mode on the shards the mesh gives it:
#: (name, shard, grid, mode, the shards' coordinates)
MODE_SHARDS = [
    ("iso R+Q seams, stem4d-iso", SHARD4, (2, 1, 1, 1),
     dict(iso_r=True, iso_q=True), [(0, 0, 0, 0), (1, 0, 0, 0)]),
    ("iso R+Q corners, stem4d-iso", QUAD4, (2, 2, 1, 1),
     dict(iso_r=True, iso_q=True), [(0, 0, 0, 0), (0, 1, 0, 0),
                                    (1, 1, 0, 0)]),
    ("periodic", SHARD2, (2, 1, 1), dict(bc=0), [(0, 0, 0), (1, 0, 0)]),
    ("periodic 2D", QUAD2, (2, 2, 1), dict(bc=0), [(1, 1, 0)]),
    ("mirror", SHARD2, (2, 1, 1), dict(bc=1), [(0, 0, 0), (1, 0, 0)]),
    ("mirror 2D", QUAD2, (2, 2, 1), dict(bc=1), [(0, 0, 0), (1, 1, 0)]),
    ("in-block Jia-Zhao", QSPLIT4, (1, 1, 2, 1), dict(),
     [(0, 0, 0, 0), (0, 0, 1, 0)]),
    ("iso Q corners", (128, 128, 32, 32), (1, 1, 2, 2), dict(iso_q=True),
     [(0, 0, 0, 0), (0, 0, 0, 1), (0, 0, 1, 1)]),
]


def shard_halos(state, fista, mode, grid, coords, gen):
    """The halos of a shard at ``coords`` of ``grid`` with the operand set
    of ``engine._k1_halos``: random slabs (nonzero; recon near the
    state's) from each neighbour the shard has (both on a ring), the
    boundary's edge values at the global edges, the partner accumulator
    of a split iso axis, the corner where its partner is split too
    (random where the diagonal shard exists), and the mirror's edge
    flags. Returns ``(halos, edge_next)``."""
    from cytvdn_tpu_torch.ops.stencil import _slab

    ndim = state[0].dim()
    recon, accs = state[0], state[1:1 + ndim]
    ds = state[1 + ndim:] if fista else None
    bc = mode.get("bc", 2)
    split = {ax for ax in range(ndim) if grid[ax] > 1}
    partner = {}
    if bc != 0:
        for p, q in ([(0, 1)] if mode.get("iso_r") else []) \
                + ([(2, 3)] if mode.get("iso_q") else []):
            partner.update({p: q, q: p})

    def rnd(like, scale, base=0.0):
        return torch.randn(like.shape, generator=gen, device="cuda",
                           dtype=like.dtype) * scale + base

    def own(t):
        return t.clone(memory_format=torch.contiguous_format)

    h = {}
    for ax in sorted({0, 1} | split):
        first, last = _slab(recon, ax, 0), _slab(recon, ax, -1)
        has_prev = ax in split and (bc == 0 or coords[ax] > 0)
        has_next = ax in split and (bc == 0 or coords[ax] < grid[ax] - 1)
        if has_prev:
            h[f"prev{ax}"] = rnd(first, 0.05, 2.0)
        else:
            h[f"prev{ax}"] = own(last if bc == 0 else _slab(recon, ax, 1)
                                 if bc == 1 else first)
        keys = [("acc", accs[ax])] + ([("d", ds[ax])] if fista else [])
        if ax in split and ax in partner:
            keys.append((f"acc{partner[ax]}", accs[partner[ax]]))
        if has_next:
            h[f"next{ax}_recon"] = rnd(first, 0.05, 2.0)
            for key, _ in keys:
                h[f"next{ax}_{key}"] = rnd(first, 0.2)
        elif bc == 0:
            h[f"next{ax}_recon"] = own(first)
            for key, a in keys:
                h[f"next{ax}_{key}"] = own(_slab(a, ax, 0))
        else:
            h[f"next{ax}_recon"] = own(last)
            for key, _ in keys:
                h[f"next{ax}_{key}"] = torch.zeros_like(
                    first, memory_format=torch.contiguous_format)
    for s_, o in partner.items():
        if s_ in split and o in split:
            nr = h[f"next{s_}_recon"]
            h[f"corner{s_}"] = rnd(_slab(nr, o, 0), 0.05, 2.0) \
                if coords[o] > 0 else own(_slab(nr, o, 0))
    edge = [coords[ax] == grid[ax] - 1 for ax in range(ndim)] \
        if bc == 1 else None
    return h, edge


def compare_mode_shard(shape, fista, mode, grid, coords):
    """One launch of the K=1 kernel with the halos of a shard at ``coords``
    (:func:`shard_halos`) against its plain version with the same halos on
    the same state (the state's first slab along each split axis nonzero,
    as a non-first shard's is): state bitwise, sums within rtol 1e-5.
    The plain version runs in place on the state the kernel's copy came
    from, so the card holds the state twice, not three times. Returns the
    largest |difference| of the state."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    orig, state, li, lm, rho = random_state(shape, fista, torch.float32, gen,
                                            jz=True)
    ndim = len(shape)
    for ax in range(ndim):
        if grid[ax] > 1 and coords[ax] > 0:
            for j in (ax, ax + ndim):
                if j < len(state) - 1:
                    state[1 + j].select(ax, 0).normal_(generator=gen)
    h, edge = shard_halos(state, fista, mode, grid, coords, gen)
    kern = [x.clone() for x in state]
    ksum = torch.stack(step_fn(fused_iteration, orig, kern, li, lm, rho,
                               fista, halos=h, edge_next=edge, **mode)()[3:])
    psum = torch.stack(step_fn(fused_iteration_reference, orig, state, li, lm,
                               rho, fista, halos=h, edge_next=edge,
                               **mode)()[3:])
    torch.cuda.synchronize()
    err = max((a - b).abs().max().item() for a, b in zip(kern, state))
    require(all(torch.equal(a, b) for a, b in zip(kern, state)),
            f"K=1 kernel {mode} at the shard {shape} {coords} of {grid} "
            f"fista={fista}: state differs from the plain version (max |Δ| "
            f"{err})")
    torch.testing.assert_close(ksum.double().cpu(), psum.double().cpu(),
                               rtol=1e-5, atol=0)
    del kern, state, orig, h
    torch.cuda.empty_cache()
    return err


def compare_mode_blocks(name, fista, dtype):
    """A small cube of ``tests/torch_halo_blocks.py``'s mode ``name``: two
    launches of the kernel with each block's halos against the plain
    version on its first, an interior and its last block, and (float32)
    every block launched and put back against one launch of the whole
    cube: bitwise. Returns the largest |difference|."""
    import itertools

    from torch_halo_blocks import (HALO_MODES, block_bounds, block_halos,
                                   block_state, mode_coords)

    mode, shape, grid, ax = HALO_MODES[name]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    orig, state, li, lm, rho = random_state(shape, fista, dtype, gen, jz=True)
    ndim = len(shape)

    def block(step, coords, iters):
        h, edge = block_halos(state[0], state[1:1 + ndim],
                              state[1 + ndim:] if fista else None, grid,
                              coords, **mode)
        o, *st = block_state([orig] + state, grid, coords)
        fn = step_fn(step, o, st, li, lm, rho, fista, halos=h,
                     edge_next=edge, **mode)
        sums = torch.stack([torch.stack(fn()[3:]).double().cpu()
                            for _ in range(iters)])
        return st, sums

    err = 0.0
    for i in range(3):
        coords = mode_coords(grid, ax, i)
        ks, ksum = block(fused_iteration, coords, 2)
        ps, psum = block(fused_iteration_reference, coords, 2)
        err = max(err, max((a - b).abs().max().item() for a, b in zip(ks, ps)))
        require(all(torch.equal(a, b) for a, b in zip(ks, ps)),
                f"K=1 kernel {name} {shape} block {coords} fista={fista} "
                f"{dtype}: state differs from the plain version (max |Δ| "
                f"{err})")
        torch.testing.assert_close(ksum, psum, rtol=1e-5, atol=0)
    if dtype == torch.float32:
        whole = [x.clone() for x in state]
        step_fn(fused_iteration, orig, whole, li, lm, rho, fista, **mode)()
        cut = [x.clone() for x in state]
        for coords in itertools.product(*(range(w) for w in grid)):
            st, _ = block(fused_iteration, coords, 1)
            sl = tuple(slice(*b) for b in block_bounds(shape, grid, coords))
            for dst, src in zip(cut, st):
                dst[sl] = src
        require(all(torch.equal(a, b) for a, b in zip(cut, whole)),
                f"{name} {shape} fista={fista}: blocks with halos != one "
                f"launch of the whole cube")
    return err


def time_mode(shape, mode, grid, coords, n_kernel, n_plain, extra=None):
    """ms per launch at the shard ``shape`` FISTA f32 (coordinates
    ``coords`` of ``grid``) of the K=1 kernel with the shard's halos in
    ``mode``, of the launch without halos, of the launches without halos
    in the modes of ``extra`` ({name: options}), and of the plain version
    with the halos, in turns (plain, halo, k1, extra..., extra reversed,
    k1, halo, plain); the elements of its halo operands; and the max |Δ|
    of one launch without halos against its plain version from the same
    state (bitwise required)."""
    from cytvdn_tpu_torch.utils.perf import k1_halo_elements

    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    orig, state, li, lm, rho = random_state(shape, True, torch.float32, gen,
                                            jz=True)
    h, edge = shard_halos(state, True, mode, grid, coords, gen)
    extra = extra or {}
    fns = {"halo": step_fn(fused_iteration, orig, state, li, lm, rho, True,
                           halos=h, edge_next=edge, **mode),
           "k1": step_fn(fused_iteration, orig, state, li, lm, rho, True,
                         **mode),
           "plain": step_fn(fused_iteration_reference, orig, state, li, lm,
                            rho, True, halos=h, edge_next=edge, **mode)}
    fns.update({k: step_fn(fused_iteration, orig, state, li, lm, rho, True,
                           **kw) for k, kw in extra.items()})
    up = ["plain", "halo", "k1", *extra]
    raw = {k: [] for k in fns}
    for name in up + up[::-1]:
        raw[name].append(time_ms(fns[name],
                                 n_plain if name == "plain" else n_kernel))
    elems = k1_halo_elements(shape, list(h))
    del h, fns
    twin = [x.clone() for x in state]
    step_fn(fused_iteration, orig, state, li, lm, rho, True, **mode)()
    step_fn(fused_iteration_reference, orig, twin, li, lm, rho, True,
            **mode)()
    err = max((a - b).abs().max().item() for a, b in zip(state, twin))
    require(all(torch.equal(a, b) for a, b in zip(state, twin)),
            f"K=1 launch at {shape} {mode} differs from its plain version: "
            f"max |Δ| {err}")
    del state, orig, twin
    torch.cuda.empty_cache()
    return {k: sum(v) / len(v) for k, v in raw.items()}, raw, elems, err


def time_iso_cube(n_kernel, n_plain):
    """ms per launch at config 4's whole cube, FISTA f32 with stem4d-iso's
    options (iso R and Q, the ISO instantiation), of the K=1 kernel and of
    its plain version, in turns (plain, k1, k1, plain)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    orig, state, li, lm, rho = random_state(CFG4, True, torch.float32, gen,
                                            jz=True)
    fns = {"k1": step_fn(fused_iteration, orig, state, li, lm, rho, True,
                         iso_r=True, iso_q=True),
           "plain": step_fn(fused_iteration_reference, orig, state, li, lm,
                            rho, True, iso_r=True, iso_q=True)}
    raw = {k: [] for k in fns}
    for k in ("plain", "k1", "k1", "plain"):
        raw[k].append(time_ms(fns[k], n_plain if k == "plain" else n_kernel))
    del orig, state, fns
    torch.cuda.empty_cache()
    return {k: sum(v) / len(v) for k, v in raw.items()}, raw


def modes_phase(smi, name, cube, cube3):
    """Phase 10: (a) the K=1 kernel in its mesh-only modes against its
    plain version — every mode of ``tests/torch_halo_blocks.py`` on small
    cubes (first, interior and last blocks, FISTA and unaccelerated,
    float32 and float64, blocks reassembled against one launch) and at the
    shards the meshes of (b) give it — and its time at config 4's (2, 1,
    1, 1) shard with stem4d-iso's options and at config 2's periodic
    shard; (b) meshes of 2 and 4 processes sharing the card in those
    modes against the single-device runs (sha256 of each block and of the
    gathered cube): config 4 with stem4d-iso's options on (2, 1, 1, 1) and
    (2, 2, 1, 1), config 2 periodic and mirror on (2, 1, 1) and (2, 2, 1),
    config 4 Jia-Zhao on (1, 1, 2, 1), config 3 iso Q on (1, 1, 2, 2), a
    mirror stop run and a periodic MSE run at config 2; (c) per rank the
    seconds per iteration, the exchange's seconds and bytes and the peak
    device memory. Returns the numbers of the kernels line's row."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    from torch_halo_blocks import HALO_MODES

    err, n_small = 0.0, 0
    for mname in sorted(HALO_MODES):
        for fista in (True, False):
            for dtype in (torch.float32, torch.float64):
                err = max(err, compare_mode_blocks(mname, fista, dtype))
                n_small += 1
    n_shard = 0
    for _, shape, grid, mode, coords_list in MODE_SHARDS:
        for coords in coords_list:
            for fista in (True, False):
                err = max(err, compare_mode_shard(shape, fista, mode, grid,
                                                  coords))
                n_shard += 1
    log(f"phase 10 (a) K=1 kernel in its mesh-only modes vs its plain "
        f"version: {n_small} small-cube cases ({sorted(HALO_MODES)}; FISTA "
        f"and unaccelerated, float32 and float64; the first, an interior and "
        f"the last block, two launches each; float32 blocks reassembled = "
        f"one launch) and {n_shard} launches at the meshes' shards "
        f"({[(m[0], m[1], m[2], m[4]) for m in MODE_SHARDS]}, FISTA and "
        f"unaccelerated); state bitwise (max |Δ| {err}), sums within rtol "
        f"1e-5; {time.perf_counter() - t0:.1f} s [{smi}]")
    bw, f32 = peak_bandwidth(name), peak_f32(name)
    timed = {}
    # the iso shard also times the launch without halos with iso R only,
    # iso Q only and anisotropic
    iso_split = {"iso R": dict(iso_r=True), "iso Q": dict(iso_q=True),
                 "aniso": {}}
    for key, shape, mode, grid, coords, extra in (
            ("iso", SHARD4, dict(iso_r=True, iso_q=True), (3, 1, 1, 1),
             (1, 0, 0, 0), iso_split),
            ("periodic", SHARD2, dict(bc=0), (2, 1, 1), (0, 0, 0), None)):
        t, raw, elems, e = time_mode(shape, mode, grid, coords, 3, 1, extra)
        err = max(err, e)
        b_ms, b_by = (launch_bound_seconds(shape, True, 1, bw, f32,
                                           halo_elems=elems)
                      if bw and f32 else (float("nan"), None))
        b0 = (launch_bound_seconds(shape, True, 1, bw, f32)[0] * 1e3
              if bw and f32 else float("nan"))
        timed[key] = (t, raw, b_ms * 1e3, b_by, elems)
        log(f"phase 10 (a) time at the shard {shape} FISTA f32 {mode} "
            f"(neighbours on both sides of axis 0): K=1 with halos "
            f"{t['halo']:.3f} ms ({b_ms * 1e3 / t['halo']:.3f} of its "
            f"{b_ms * 1e3:.2f} ms bound, {b_by}, {elems} halo elements), "
            f"without halos {t['k1']:.3f} ms ({b0 / t['k1']:.3f} of its "
            f"{b0:.2f} ms bound)"
            + "".join(f", {k} without halos {t[k]:.3f} ms "
                      f"({b0 / t[k]:.3f})" for k in extra or ())
            + f", plain with halos {t['plain']:.3f} ms; one launch without "
            f"halos bitwise its plain version (max |Δ| {e}) (runs {raw}) "
            f"[{smi}]")

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="cytv_modes_")
    try:
        mu4 = np.full(4, 1.0, np.float32)
        mu3 = np.full(3, 1.0, np.float32)
        cube_npy = os.path.join(tmp, "config4.npy")
        np.save(cube_npy, cube)
        cube3_npy = os.path.join(tmp, "config3.npy")
        np.save(cube3_npy, cube3)
        clean2, noisy2 = cfg2_eels()
        cfg2_npy = os.path.join(tmp, "config2.npy")
        np.save(cfg2_npy, noisy2)
        clean2_npy = os.path.join(tmp, "clean2.npy")
        np.save(clean2_npy, clean2)
        n4, n2, n3 = 10, 10, 10
        runs = {
            # name: (ranks, input, ndim, iterations, shard, options, extra)
            "iso2": (2, cube_npy, 4, n4, (2, 1, 1, 1), STEM4D_ISO, {}),
            "jzq": (2, cube_npy, 4, n4, (1, 1, 2, 1), {}, {}),
            "per2": (2, cfg2_npy, 3, n2, (2, 1, 1), dict(BC_mode=0), {}),
            "mir2": (2, cfg2_npy, 3, n2, (2, 1, 1), dict(BC_mode=1), {}),
            "stop": (2, cfg2_npy, 3, 500, (2, 1, 1), dict(BC_mode=1),
                     dict(stop=0.05)),
            "mse": (2, cfg2_npy, 3, n2, (2, 1, 1), dict(BC_mode=0),
                    dict(reference=clean2_npy)),
            "iso4": (4, cube_npy, 4, n4, (2, 2, 1, 1), STEM4D_ISO, {}),
            "per4": (4, cfg2_npy, 3, n2, (2, 2, 1), dict(BC_mode=0), {}),
            "mir4": (4, cfg2_npy, 3, n2, (2, 2, 1), dict(BC_mode=1), {}),
            "isoq": (4, cube3_npy, 4, n3, (1, 1, 2, 2),
                     dict(isotropic_Q=True), {}),
        }
        inputs = {cube_npy: cube, cfg2_npy: noisy2, cube3_npy: cube3}
        want, digests = {}, {}
        for key, (_, inp, ndim, iters, shard, options, extra) in runs.items():
            data = inputs[inp]
            fn = denoise4D if ndim == 4 else denoise3D
            kw = dict(iterations=iters, FISTA=True, quiet=True, device="cuda",
                      stopping_relative_change=extra.get("stop"), **options)
            if "reference" in extra:
                kw["reference_data"] = clean2
            reset_counts()
            torch.cuda.synchronize()
            t_ref = time.perf_counter()
            with warnings.catch_warnings():
                warnings.filterwarnings("ignore", "BC_mode=1")
                want[key] = single(lambda: fn(
                    data, mu4 if ndim == 4 else mu3, **kw))
            if key == "iso2":
                # config 4 stem4d-iso x10 on one device: every iteration a
                # K=1 launch (the ISO instantiation)
                iso_wall = time.perf_counter() - t_ref
                iso_launches = launch_counts()
                require(iso_launches == (0, 0, 0, n4),
                        f"config 4 stem4d-iso x{n4} on one device: launches "
                        f"whole-run/K-step/pair/fused {iso_launches}")
            digests[key] = blocks(want[key]["recon"], shard)
            del want[key]["recon"]
        del clean2, noisy2
        torch.cuda.empty_cache()
        log(f"phase 10 single-device references (config 4 stem4d-iso and "
            f"Jia-Zhao x{n4}, config 2 periodic and mirror x{n2}, its mirror "
            f"stop 0.05 after {int(np.count_nonzero(want['stop']['delta']))} "
            f"and periodic MSE x{n2}, config 3 iso Q x{n3}), the .npy inputs "
            f"and the digests: {time.perf_counter() - t0:.1f} s")
        cube_ms, cube_raw = time_iso_cube(3, 1)
        b4 = (launch_bound_seconds(CFG4, True, 1, bw, f32)[0] * 1e3
              if bw and f32 else float("nan"))
        log(f"phase 10 config 4 {CFG4} stem4d-iso (iso R and Q) FISTA x{n4} "
            f"on one device: {iso_wall / n4:.4f} s per iteration "
            f"(denoise4D wall {iso_wall:.3f} s, host copies included; "
            f"launches whole-run/K-step/pair/fused {iso_launches}); the K=1 "
            f"launch at {CFG4} with those options {cube_ms['k1']:.3f} ms "
            f"({b4 / cube_ms['k1']:.3f} of its {b4:.2f} ms bound), plain "
            f"{cube_ms['plain']:.3f} ms (runs {cube_raw}) [{smi}]")

        rows = {}
        for n_ranks, timeout in ((2, 420), (4, 420)):
            t0 = time.perf_counter()
            spec = [dict(name=k, input=r[1], ndim=r[2], iterations=r[3],
                         shard=r[4], options=r[5], **r[6])
                    for k, r in runs.items() if r[0] == n_ranks]
            res = run_mesh(tmp, n_ranks, spec, timeout=timeout)
            wall = time.perf_counter() - t0
            for run in spec:
                k = run["name"]
                rows[k] = check_mesh_run(
                    k, res, want[k], *digests[k], mse=k == "mse",
                    gather=run["options"].get("gather", True))
                n_it = rows[k][0]["iterations_run"]
                require(all(r["modes"] == n_it and r["launches"][3] == n_it
                            for r in rows[k]),
                        f"{k}: K=1 launches in the mesh-only modes "
                        f"{[r['modes'] for r in rows[k]]}, fused "
                        f"{[r['launches'] for r in rows[k]]}, expected "
                        f"{n_it} each")
            log(f"phase 10 (b) {n_ranks} processes sharing the card (gloo): "
                f"{[(r['name'], r['shard'], r.get('options')) for r in spec]}"
                f"; every block and the gathered recon bitwise the "
                f"single-device run's (sha256), traces within rtol 1e-5, the "
                f"stop at the single-device iteration, every iteration a K=1 "
                f"launch in its mode; the group's runs and its start "
                f"{wall:.1f} s [{smi}]")
        for k in runs:
            rank_lines(f"phase 10 (c) {k}", rows[k], smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 10 {time.perf_counter() - t_phase:.1f} s")
    t, raw, b_ms, b_by, _ = timed["iso"]
    return {"launches": rows["iso2"][0]["modes"], "err": err,
            "ms": t["halo"], "plain_ms": t["plain"], "bound": (b_ms, b_by),
            "iso_launches": iso_launches[3], "iso_ms": cube_ms["k1"],
            "iso_plain_ms": cube_ms["plain"]}


# phase 11: lossy shadow duals (the K=1 kernel's LOSSY instantiation): its
# shapes against the plain version (ragged edges, 3D and 4D, last extents
# 1 and 33), the slabs and shards it takes with halos, and the small cube
# of the lossy mesh run
LOSSY_SHAPES = [ODD, (13, 17, 70), (7, 9, 5, 1), (9, 5, 7, 33)]
LOSSY_MESH = (16, 8, 16, 32)


def lossy_case(shape, where=None, grids=(None,), iters=3):
    """``iters`` lossy launches (bfloat16 d) of the kernel against its
    plain version from the same state, at each forced grid of ``grids``
    (None: the wrapper's): on the whole cube (``where`` None), or with the
    halos of :func:`compare_halo_case`'s ``where`` (the first, an interior
    or the last of three slabs; ``"slab"``, an interior slab of ``shape``;
    ``"block"``, ``shape`` as an interior shard of a 2D mesh), the
    bfloat16 d seams widened to float32 as the engine widens them. State
    bitwise, d included; sums within rtol 1e-5. Returns the largest
    |difference| of the state and the launches made."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    ndim = len(shape)
    cut, full = (slice(None),), shape
    if where == "slab":
        full = (shape[0] + 2,) + tuple(shape[1:])
        cut = (slice(1, shape[0] + 1),)
    elif where == "block":
        full = (shape[0] + 2, shape[1] + 2) + tuple(shape[2:])
        cut = (slice(1, -1), slice(1, -1))
    elif where is not None:
        n = shape[0] // 3
        cut = ({"first": slice(0, n), "interior": slice(n, 2 * n),
                "last": slice(2 * n, shape[0])}[where],)
    orig, state, li, lm, rho = random_state(full, True, torch.float32, gen)
    state = state[:1 + ndim] + [d.to(torch.bfloat16)
                                for d in state[1 + ndim:]]
    h = None
    if where == "block":
        h = block_seams(state, ndim, True)
    elif where is not None:
        h = seams(state, ndim, cut[0].start, cut[0].stop, True)
    if h is not None:
        h = {k: v.float() if v.dtype == torch.bfloat16 else v
             for k, v in h.items()}
    o = orig[cut].contiguous()
    err, launches = 0.0, fused_iteration.lossy_launches
    saved = fused_mod.MAX_BLOCKS
    try:
        for grid in grids:
            fused_mod.MAX_BLOCKS = saved if grid is None else grid
            runs = []
            for step in (fused_iteration, fused_iteration_reference):
                st = [x[cut].clone() for x in state]
                fn = step_fn(step, o, st, li, lm, rho, True, halos=h)
                sums = [torch.stack(fn()[3:]).double().cpu()
                        for _ in range(iters)]
                torch.cuda.synchronize()
                runs.append((st, torch.stack(sums)))
            (ks, ksum), (ps, psum) = runs
            err = max([err] + [(a.float() - b.float()).abs().max().item()
                               for a, b in zip(ks, ps)])
            require(all(a.dtype == b.dtype and torch.equal(a, b)
                        for a, b in zip(ks, ps)),
                    f"lossy kernel {shape} {where} grid {grid}: state "
                    f"differs from the plain version (max |Δ| {err})")
            torch.testing.assert_close(ksum, psum, rtol=1e-5, atol=0)
    finally:
        fused_mod.MAX_BLOCKS = saved
    del state, orig, h, o, runs
    torch.cuda.empty_cache()
    return err, fused_iteration.lossy_launches - launches


def compare_lossy_offcard(shape=CFG4, iters=3):
    """``iters`` lossy launches of the kernel and of its plain version from
    one random Jia-Zhao FISTA state of ``shape``, d bfloat16, compared off
    the card (``offcard_equal``): the state bitwise, d included, the sums
    within rtol 1e-5. Returns max |Δstate| and the launches made."""
    def launches(step):
        def fn(orig, state, li, lm, rho):
            f = step_fn(step, orig, state, li, lm, rho, True)
            return torch.stack([torch.stack(f()[3:]) for _ in range(iters)])
        return fn

    before = fused_iteration.lossy_launches
    err, _ = offcard_equal(shape, True, [
        ("lossy kernel", launches(fused_iteration)),
        ("plain", launches(fused_iteration_reference))], lossy=True)
    return err, fused_iteration.lossy_launches - before


def rel_l2_on_card(a: torch.Tensor, b: np.ndarray) -> float:
    """||a - b|| / ||a|| in float64, ``b`` brought to the card in
    32-row chunks."""
    num = den = 0.0
    for i in range(0, a.shape[0], 32):
        x = a[i:i + 32].double()
        y = torch.from_numpy(b[i:i + 32]).cuda().double()
        num += float(((x - y) ** 2).sum())
        den += float((x ** 2).sum())
    return math.sqrt(num / den)


# the pair kernel's LOSSY cases: N0 = 4..7 in 3D and 4D (stages where only
# some row operations have a row) and ragged edges on every axis, at the
# wrapper's grid, 1 and 7 blocks and a forced strip of 3
LOSSY_PAIR_SHAPES = [(4, 9, 10, 33), (7, 9, 10, 33), (5, 13, 70),
                     (7, 13, 70), ODD]
LOSSY_PAIR_GRIDS = ((None, None), (1, None), (7, None), (None, 3))


def lossy_pair_case(shape, with_ref=False, grids=LOSSY_PAIR_GRIDS):
    """Two pairs of the pair kernel's LOSSY instantiation (bfloat16 d) at
    each forced (grid, strip) of ``grids`` against the plain pair and,
    without a reference cube, against four LOSSY K=1 launches, from one
    Jia-Zhao state: state bitwise, d included, sums within rtol 1e-5.
    Returns max |Δstate| and the lossy pair launches made."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    orig, state, li, lm, rho = random_state(shape, True, torch.float32, gen,
                                            jz=True)
    nd = len(shape)
    state = state[:1 + nd] + [d.to(torch.bfloat16) for d in state[1 + nd:]]
    ref = {"ref": ref_cube(shape)} if with_ref else {}

    def run(step, **kw):
        s = [x.clone() for x in state]
        fn = pair_fn(step, orig, s, li, lm, rho, True, **kw)
        sums = torch.stack([torch.stack(fn()).double() for _ in range(2)])
        torch.cuda.synchronize()
        return s, sums.cpu()

    wants = [("plain pair", run(fused_pair_iteration_reference, **ref))]
    if not with_ref:
        wants.append(("four LOSSY K=1 launches", run(two_k1)))
    err, before = 0.0, fused_pair_iteration.lossy_launches
    for g, w in grids:
        ks, ksum = run(fused_pair_iteration, grid=g, strip=w, **ref)
        for what, (ps, psum) in wants:
            err = max([err] + [(a.float() - b.float()).abs().max().item()
                               for a, b in zip(ks, ps)])
            require(all(a.dtype == b.dtype and torch.equal(a, b)
                        for a, b in zip(ks, ps)),
                    f"lossy pair {shape} ref {with_ref} grid {g} strip {w}: "
                    f"state differs from the {what} (max |Δ| {err})")
            torch.testing.assert_close(ksum, psum, rtol=1e-5, atol=0)
    launches = fused_pair_iteration.lossy_launches - before
    require(launches == 2 * len(grids),
            f"lossy pair {shape}: {launches} lossy launches")
    del state, orig, wants, ks, ref
    torch.cuda.empty_cache()
    return err, launches


def lossy_halo0_stash(shape, a0, a1):
    """The LOSSY HALO0 pair's 2-row stash on rows [a0, a1) (a1 below the
    cube's last row): the +1 shard's row-0 b_0 and d_0 after iteration 1,
    bitwise one plain lossy K=1 step of the whole cube at row a1, d_0 on
    the bfloat16 grid (wavefront.cuh round_bf16)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    orig, state, li, lm = halo0_state(shape, True, gen, lossy=True)
    nd = len(shape)
    stash = torch.full((2,) + tuple(shape[1:]), float("nan"), device="cuda")
    halo0_pair(fused_pair_iteration, orig, state, True, li, lm, a0, a1,
               stash=stash)
    s = [x.clone() for x in state]
    fused_iteration_reference(orig, s[0], s[1:1 + nd], s[1 + nd:],
                              torch.tensor(0.37, device="cuda"), li, lm,
                              fista=True)
    require(torch.equal(stash[0], s[1][a1])
            and torch.equal(stash[1], s[1 + nd][a1].float()),
            f"lossy HALO0 stash {shape} rows [{a0}, {a1}) != one plain "
            f"lossy K=1 step at row {a1}")


def bf16_canaries() -> np.ndarray:
    """The lossy duals' rounding canaries (tests/test_torch_lossy.py::
    _torture): ties, denormals, the carry to infinity, and 4096 random
    values over 26 decades; 4118 float32 values."""
    torture = np.array([
        0.0, -0.0, 1.0, -1.0, 1.0 + 2.0 ** -9, 1.0 + 3.0 * 2.0 ** -9,
        1.0 + 2.0 ** -9 + 2.0 ** -20, np.float32(np.pi), -np.float32(np.e),
        1e-38, -1e-38, 1.1754944e-38, 1e-41, -3e-44, 3.3895314e38, 3.39e38,
        -3.39e38, 65535.5, 65504.0, 2.0 ** 127, np.finfo(np.float32).max,
        np.finfo(np.float32).tiny], dtype=np.float32)
    rng = np.random.default_rng(7)
    rand = (rng.standard_normal(4096)
            * np.exp(rng.uniform(-30, 30, 4096))).astype(np.float32)
    return np.concatenate([torture, rand])


def round_bf16_through_stash():
    """``wavefront.cuh::round_bf16`` on :func:`bf16_canaries` through the
    stash of one LOSSY HALO0 pair: with this shard's last recon row and the
    +1 shard's row-0 recon band zero and the axis-0 clip radius the largest
    float, the stashed row-0 d_0 of the +1 shard is round_bf16(0 + b) for
    the band b of canary values. Returns it and torch's float -> bfloat16
    -> float cast of 0 + b (0 + -0.0 is +0.0), both as int32 bits."""
    vals = torch.from_numpy(bf16_canaries()).cuda()
    shape = (4, 71, 58)  # a row of 4118 elements, one per canary value
    nd = len(shape)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    orig, state, li, lm = halo0_state(shape, True, gen, lossy=True)
    state[0][-1].zero_()
    h, _, _ = halo0_bands(orig, state[0], state[1:1 + nd], state[1 + nd:], 0,
                          shape[0])
    h = {k: torch.zeros_like(v) for k, v in h.items() if k.startswith("n_")}
    h["n_acc0"] = vals.view(h["n_acc0"].shape).clone()
    li[0] = torch.finfo(torch.float32).max
    stash = torch.full((2,) + shape[1:], float("nan"), device="cuda")
    fused_pair_iteration(
        orig, state[0], state[1:1 + nd], state[1 + nd:],
        torch.tensor(0.37, device="cuda"), torch.tensor(RHO2, device="cuda"),
        li, lm, fista=True, halos0=h, first0=True, last0=False, stash=stash)
    want = (torch.zeros_like(vals) + vals).to(torch.bfloat16).float()
    return (stash[1].reshape(-1).view(torch.int32).cpu(),
            want.view(torch.int32).cpu())


def compare_lossy_pair_cfg4():
    """One lossy pair at config 4 (256²×128² FISTA, d bfloat16): against
    two plain lossy iterations, compared off the card (``offcard_equal``),
    and against two LOSSY K=1 launches on the card from one state (each
    of the 9 arrays bitwise, the sums within rtol 1e-5). Returns max
    |Δstate| and the lossy pair launches made."""
    def pair(step):
        return lambda orig, state, li, lm, rho: torch.stack(
            pair_fn(step, orig, state, li, lm, rho, True)())

    before = fused_pair_iteration.lossy_launches
    err, _ = offcard_equal(CFG4, True, [
        ("lossy pair kernel", pair(fused_pair_iteration)),
        ("plain", pair(fused_pair_iteration_reference))], lossy=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    orig, state, li, lm, rho = random_state(CFG4, True, torch.float32, gen,
                                            jz=True)
    for i in range(5, 9):
        state[i] = state[i].to(torch.bfloat16)
    torch.cuda.empty_cache()
    k1 = [x.clone() for x in state]
    sp = torch.stack(pair_fn(fused_pair_iteration, orig, state, li, lm, rho,
                             True)()).double().cpu()
    sk = torch.stack(pair_fn(two_k1, orig, k1, li, lm, rho,
                             True)()).double().cpu()
    for a, b in zip(state, k1):
        err = max(err, (a.float() - b.float()).abs().max().item())
        require(a.dtype == b.dtype and torch.equal(a, b),
                f"lossy pair at {CFG4} != two LOSSY K=1 launches (max |Δ| "
                f"{err})")
    torch.testing.assert_close(sp, sk, rtol=1e-5, atol=0)
    del orig, state, k1
    torch.cuda.empty_cache()
    return err, fused_pair_iteration.lossy_launches - before


def lossy_pair_cases():
    """Phase 11 (a), the pair kernel's part: :func:`lossy_pair_case` at
    LOSSY_PAIR_SHAPES with and without a reference cube, the LOSSY HALO0
    pair on the first, an interior and the last 4-row slab of HALO0_SMALL
    (with and without a reference cube, at the grids and strip of
    LOSSY_PAIR_GRIDS) and its stash, ``round_bf16`` through the stash on
    the canaries, and config 4's whole cube. Returns (max |Δstate|,
    cases, lossy pair launches)."""
    err, n_cases, launches = 0.0, 0, 0
    for shape in LOSSY_PAIR_SHAPES:
        for with_ref in (False, True):
            e, n = lossy_pair_case(shape, with_ref)
            err, n_cases, launches = max(err, e), n_cases + 1, launches + n
    before = fused_pair_iteration.lossy_launches
    grids = [g for g, _ in LOSSY_PAIR_GRIDS if g is not None]
    for shape in HALO0_SMALL:
        for a0, a1 in ((0, 4), (4, 8), (shape[0] - 4, shape[0])):
            for with_ref in (False, True):
                err = max(err, compare_halo0(
                    shape, True, with_ref, a0, a1, grids=(None, *grids),
                    lossy=True))
                err = max(err, compare_halo0(
                    shape, True, with_ref, a0, a1, strips=(3,), lossy=True))
                n_cases += 1
            if a1 < shape[0]:
                lossy_halo0_stash(shape, a0, a1)
    got, want = round_bf16_through_stash()
    require(torch.equal(got, want), f"round_bf16 in CUDA != torch's bfloat16 "
                                    f"cast at {(got != want).sum().item()} of "
                                    f"{got.numel()} canary values")
    launches += fused_pair_iteration.lossy_launches - before
    e, n = compare_lossy_pair_cfg4()
    return max(err, e), n_cases + 2, launches + n


# the K-step kernel's LOSSY cases (FISTA): every depth at N0 = 2K and 2K+1
# (kstep_shape), 3D and 4D (the capped 4D entry), ragged edges and 128-bit
# shapes (VEC: 64-bit bfloat16 accesses), at the wrapper's grid and 1 and 7
# blocks
LOSSY_KSTEP_SHAPES = [(2, 9, 10, 33), (3, 13, 70), (3, 13, 64),
                      (2, 9, 10, 32)]


def lossy_kstep_cases():
    """Phase 11 (a), the K-step kernel's part: :func:`compare_kstep_case`
    with bfloat16 d at every depth on LOSSY_KSTEP_SHAPES (the wrapper's
    grid and 1 and 7 blocks) against the plain version, K LOSSY K=1
    launches and (K even) K/2 LOSSY pairs per launch; the tile edges of
    :func:`kstep_edge_cases` (last extents 1 to 129) at the wrapper's grid
    against the same; config 2's whole cube at every depth (the wrapper's
    default rows per stage, the main path's 3D shape), one launch against
    its plain version; one K=8 launch at config 4 against 8 plain lossy
    iterations off the card. Returns (max |Δstate|, cases, lossy K-step
    launches)."""
    before = fused_kstep_iteration.lossy_launches
    err, n_cases = 0.0, 0
    for k in KS:
        for shape in LOSSY_KSTEP_SHAPES:
            err = max(err, compare_kstep_case(kstep_shape(shape, k), k, True,
                                              grids=(None, 1, 7),
                                              lossy=True))
            n_cases += 1
    for shape, k, _ in kstep_edge_cases():
        err = max(err, compare_kstep_case(shape, k, True, lossy=True))
        n_cases += 1
    for k in KS:
        err = max(err, compare_kstep_case(CFG2, k, True, launches=1,
                                          plain_only=True, lossy=True))
        n_cases += 1
    e, _ = compare_kstep_offcard(CFG4, True, max(KS), lossy=True)
    return (max(err, e), n_cases + 1,
            fused_kstep_iteration.lossy_launches - before)


def lossy_turns(orig, lossy_state, li, lm, extra=None):
    """The launches on a lossy run's ``lossy_state`` (recon, b, bfloat16
    d), in turns, each timed once and then again in reverse order: one
    LOSSY K=8 launch ("kstep"), the exact K=8 on the same state with d
    widened to float32 ("exact_kstep"), one LOSSY K=1 launch ("k1"), and
    the functions of ``extra(lossy_state, exact_state, rho)`` by name (the
    plain versions, named "plain...", first and once per turn, the
    kernels 5 times). Returns the mean ms and the runs by name."""
    rho = torch.tensor(0.5, device="cuda")
    rhos = torch.full((8,), 0.5, device="cuda")
    nd = orig.dim()
    exact_state = [*lossy_state[:1 + nd],
                   *(d.float() for d in lossy_state[1 + nd:])]
    fns = {"kstep": kstep_fn(fused_kstep_iteration, orig, lossy_state, li,
                             lm, rhos, 8, True),
           "exact_kstep": kstep_fn(fused_kstep_iteration, orig, exact_state,
                                   li, lm, rhos, 8, True),
           "k1": step_fn(fused_iteration, orig, lossy_state, li, lm, rho,
                         True),
           **(extra(lossy_state, exact_state, rho) if extra else {})}
    order = sorted(fns, key=lambda k: not k.startswith("plain"))
    raw = {k: [] for k in fns}
    for k in order + order[::-1]:
        raw[k].append(time_ms(fns[k], 1 if k.startswith("plain") else 5))
    del exact_state, fns
    torch.cuda.empty_cache()
    return {k: sum(v) / len(v) for k, v in raw.items()}, raw


def lossy_phase(smi, name, cube, scan, det, tmp):
    """Phase 11: lossy shadow duals. (a) the K=1 kernel's LOSSY
    instantiation against its plain version, bitwise with d, at ragged 3D
    and 4D shapes and forced grids of 1 and 7 blocks, its HALO form on
    slabs (config 4's stream slab among them) and on a mesh shard's
    operands, and on config 4's whole cube, compared off the card; the pair
    kernel's LOSSY instantiations (:func:`lossy_pair_cases`); the K-step
    kernel's (:func:`lossy_kstep_cases`); (b) config 4 through
    ``denoise4D(lossy_duals=True)`` x20 (2 LOSSY K=8 launches and 2 LOSSY
    pairs, no other launch), bitwise the lossy K=1 loop, its time with and
    without the host copies, the peak device memory and the recon's rel-L2
    against the exact run; the lossy K=8 launch, the exact K=8, the lossy
    K=1 launch, the lossy pair (with and without the clean cube as
    reference), the exact pair and the plain versions at config 4 in turns,
    against the lossy bounds; config 2 lossy x24 (3 LOSSY K=8 launches)
    bitwise the lossy K=1 loop, and the lossy K=8, exact K=8 and lossy K=1
    launches there in turns; a lossy MSE x20 in REF+LOSSY pairs and a
    lossy stop run near 48 on K-steps and pairs behind the guard, each
    bitwise the lossy K=1 loop; (c) config 4 lossy out of core, stream mode
    in 4 slabs x2 and temporal mode K=8 in 4 slabs x16, each bitwise the
    in-core lossy run; (d) a 2-rank (2, 1, 1, 1) lossy mesh of processes
    sharing the card, in LOSSY HALO0 pairs, bitwise the single-device lossy
    run. Returns the numbers of the kernels line's rows."""
    t_phase = t0 = time.perf_counter()
    # (a)'s off-card comparisons at config 4 share one page-locked state
    pinned = contextlib.ExitStack()
    pinned.enter_context(pinned_copies())
    err, n_cases, launches = 0.0, 0, 0
    for shape in LOSSY_SHAPES:
        e, n = lossy_case(shape, grids=(None, 1, 7))
        err, n_cases, launches = max(err, e), n_cases + 1, launches + n
    for shape in HALO_SHAPES:
        for where in ("first", "interior", "last"):
            e, n = lossy_case(shape, where, grids=(None, 7))
            err, n_cases, launches = max(err, e), n_cases + 1, launches + n
    for shape, where in ((SLAB4, "slab"), ((16, 18, 19, 23), "block"),
                         ((14, 13, 70), "block")):
        e, n = lossy_case(shape, where)
        err, n_cases, launches = max(err, e), n_cases + 1, launches + n
    # the whole cube of run (b), its state held on the host
    e, n = compare_lossy_offcard(CFG4)
    err, n_cases, launches = max(err, e), n_cases + 1, launches + n
    log(f"phase 11 (a) lossy K=1 kernel (LOSSY: bfloat16 d) vs its plain "
        f"version: {n_cases} cases, {launches} launches ({LOSSY_SHAPES} at "
        f"the wrapper's grid and 1 and 7 blocks; with halos the first, an "
        f"interior and the last slab of {HALO_SHAPES} at the wrapper's grid "
        f"and 7 blocks, config 4's interior stream slab {SLAB4} and two "
        f"mesh shards with neighbours on axes 0 and 1; config 4's whole "
        f"cube {CFG4}, compared off the card), 3 iterations each: state "
        f"bitwise equal, d included (max |Δ| {err}), sums within rtol "
        f"1e-5; {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    perr, p_cases, p_launches = lossy_pair_cases()
    log(f"phase 11 (a) lossy pair kernel (LOSSY: bfloat16 d, iteration 1's "
        f"d rounded in the middle of the pair) vs the plain pair and four "
        f"LOSSY K=1 launches: {p_cases} cases, {p_launches} lossy pair "
        f"launches ({LOSSY_PAIR_SHAPES} with and without a reference cube, "
        f"2 pairs at (grid, strip) {LOSSY_PAIR_GRIDS}; HALO0 on the first, "
        f"an interior and the last 4-row slab of {HALO0_SMALL} at those "
        f"grids and strip, with and without a reference cube, the stash "
        f"bitwise one plain lossy K=1 step; round_bf16 in CUDA bitwise "
        f"torch's bfloat16 cast on {bf16_canaries().size} canary values; "
        f"config 4's whole cube against two plain iterations off the card "
        f"and two LOSSY K=1 launches on it): state bitwise equal, d "
        f"included (max |Δ| {perr}), sums within rtol 1e-5; "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kerr, k_cases, k_launches = lossy_kstep_cases()
    pinned.close()
    log(f"phase 11 (a) lossy K-step kernel (LOSSY: bfloat16 d, every "
        f"level's d rounded at its store) vs its plain version, K LOSSY K=1 "
        f"launches and (K even) K/2 LOSSY pairs: {k_cases} cases, "
        f"{k_launches} lossy K-step launches (K {KS} at N0 = 2K and 2K+1 "
        f"of {LOSSY_KSTEP_SHAPES}, 2 launches at the wrapper's grid and 1 "
        f"and 7 blocks; the tile edges {kstep_edge_cases()} at the "
        f"wrapper's grid; config 2's whole cube {CFG2} at every K, one "
        f"launch against its plain version, R = {kstep_rows(CFG2)} rows per "
        f"stage; config 4's whole cube {CFG4}, one K=8 launch "
        f"against 8 plain lossy iterations off the card): state bitwise "
        f"equal, d included (max |Δ| {kerr}), sums within rtol 1e-5; "
        f"{time.perf_counter() - t0:.1f} s")

    # (b) config 4 x20 through the API, then on the card alone
    t0 = time.perf_counter()
    mu = np.full(4, 1.0, np.float32)
    opts = SolverOptions(ndim=4, iterations_fista=20, iterations_unacc=0,
                         lossy_duals=True)
    k1_opts = SolverOptions(ndim=4, iterations_fista=20, iterations_unacc=0,
                            lossy_duals=True, temporal_pairs=False)
    want = expected_launches(opts, CFG4)
    require(want == (0, 2, 2, 0), f"lossy config 4 plan {want}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t1 = time.perf_counter()
    recon, b_norm, delta = denoise4D(cube, mu, iterations=20, FISTA=True,
                                     lossy_duals=True, quiet=True,
                                     device="cuda")
    wall = time.perf_counter() - t1
    counts = launch_counts()
    n_lossy = fused_pair_iteration.lossy_launches
    n_lossy_k = fused_kstep_iteration.lossy_launches
    peak = torch.cuda.max_memory_allocated()
    require(counts == want and n_lossy == 2 and n_lossy_k == 2,
            f"lossy config 4: launches (whole-run, K-step, pair, K=1) "
            f"{counts}, {n_lossy_k} lossy K-steps and {n_lossy} lossy pairs "
            f"among them; expected {want}")
    require(recon.shape == CFG4 and bool(np.isfinite(recon).all())
            and bool((delta > 0).all()), "lossy config 4 result")
    orig = torch.from_numpy(cube).cuda()
    li = torch.full((4,), 32.0, device="cuda")
    lm = torch.full((4,), 1 / 32, device="cuda")
    k1 = run_solver(orig, li, lm, k1_opts)
    require(torch.equal(k1["recon"].cpu(), torch.from_numpy(recon)),
            "lossy config 4: the K-steps' and pairs' recon != the lossy K=1 "
            "loop's")
    np.testing.assert_allclose(k1["delta"].cpu().numpy(), delta, rtol=1e-5)
    del k1
    torch.cuda.empty_cache()
    exact = run_solver(orig, li, lm, SolverOptions(
        ndim=4, iterations_fista=20, iterations_unacc=0))["recon"]
    torch.cuda.empty_cache()
    drift = rel_l2_on_card(exact, recon)
    del exact
    torch.cuda.empty_cache()
    require(math.isfinite(drift) and drift > 0,
            f"lossy config 4 rel-L2 against the exact run {drift}")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    st = run_solver(orig, li, lm, opts, keep_state=True)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t1
    require(torch.equal(st["recon"].cpu(), torch.from_numpy(recon)),
            "lossy config 4: run_solver recon != denoise4D's")
    # the launches at config 4 on the run's state, in turns: the lossy K=8
    # launch, the exact K=8, the lossy K=1 launch, the lossy pair, the exact
    # pair and the plain versions; then the lossy pair with the clean cube
    # as reference
    lossy_state = [st["recon"], *st["accs"], *st["ds"]]
    rho = torch.tensor(0.5, device="cuda")
    rhos = torch.full((8,), 0.5, device="cuda")

    def extra4(lossy, exact, rho):
        return {"plain_kstep": kstep_fn(fused_kstep_iteration_reference,
                                        orig, lossy, li, lm, rhos, 8, True),
                "plain": step_fn(fused_iteration_reference, orig, lossy, li,
                                 lm, rho, True),
                "pair": pair_fn(fused_pair_iteration, orig, lossy, li, lm,
                                rho, True),
                "plain_pair": pair_fn(fused_pair_iteration_reference, orig,
                                      lossy, li, lm, rho, True),
                "exact_pair": pair_fn(fused_pair_iteration, orig, exact, li,
                                      lm, rho, True)}

    ms, raw = lossy_turns(orig, lossy_state, li, lm, extra4)
    ref4 = (torch.from_numpy(scan).cuda()[:, :, None, None]
            + torch.from_numpy(det).cuda()[None, None]).contiguous()
    fn_ref = pair_fn(fused_pair_iteration, orig, lossy_state, li, lm, rho,
                     True, ref=ref4)
    raw["pair_ref"] = [time_ms(fn_ref, 5) for _ in range(2)]
    ms["pair_ref"] = sum(raw["pair_ref"]) / 2
    bw, f32 = peak_bandwidth(name), peak_f32(name)

    def bound(iters, ref=False):
        if not (bw and f32):
            return float("nan"), None
        t, by = launch_bound_seconds(CFG4, True, iters, bw, f32, ref=ref,
                                     d_itemsize=2)
        return t * 1e3, by

    b_k1, b_pair, b_ref = bound(1), bound(2), bound(2, ref=True)
    b_k8 = bound(8)
    del st, lossy_state, fn_ref
    torch.cuda.empty_cache()
    log(f"phase 11 (b) config 4 {CFG4} FISTA x20 lossy_duals: denoise4D "
        f"{wall:.3f} s = {wall / 20:.4f} s per iteration with the host "
        f"copies, run_solver on the card {solve_s:.4f} s = "
        f"{solve_s / 20:.4f} s per iteration without; launches whole-run/"
        f"K-step/pair/K=1 {counts}, {n_lossy_k} LOSSY K=8 launches and "
        f"{n_lossy} LOSSY pairs; recon bitwise "
        f"the lossy K=1 loop's (run_solver, temporal_pairs=False), traces "
        f"within rtol 1e-5; peak device memory {peak / 2**30:.3f} GiB; "
        f"recon rel-L2 against the exact run {drift:.6e}; one lossy pair "
        f"{ms['pair']:.3f} ms ({b_pair[0] / ms['pair']:.3f} of its "
        f"{b_pair[0]:.2f} ms bound, 60 B per voxel), plain "
        f"{ms['plain_pair']:.3f} ms; the exact pair on the same state (d "
        f"widened) {ms['exact_pair']:.3f} ms; one lossy K=8 launch "
        f"{ms['kstep']:.3f} ms ({b_k8[0] / ms['kstep']:.3f} of its "
        f"{b_k8[0]:.2f} ms bound), the exact K=8 {ms['exact_kstep']:.3f} ms, "
        f"8 lossy K=1 launches {8 * ms['k1']:.3f} ms, 4 lossy pairs "
        f"{4 * ms['pair']:.3f} ms, the plain lossy K-step (8 plain "
        f"iterations) {ms['plain_kstep']:.3f} ms; with the clean cube as "
        f"reference {ms['pair_ref']:.3f} ms ({b_ref[0] / ms['pair_ref']:.3f}"
        f" of {b_ref[0]:.2f} ms); one lossy K=1 launch {ms['k1']:.3f} ms "
        f"({b_k1[0] / ms['k1']:.3f} of {b_k1[0]:.2f} ms), plain "
        f"{ms['plain']:.3f} ms (runs "
        f"{ {k: [round(x, 3) for x in v] for k, v in raw.items()} }); "
        f"{time.perf_counter() - t0:.1f} s [{smi}]")

    # (b) config 2 lossy x24 in LOSSY K=8 launches against the lossy K=1
    # loop, then the launches on the run's state in turns
    t0 = time.perf_counter()
    orig2 = cfg2_cube()
    li3 = torch.full((3,), 16.0, device="cuda")
    lm3 = torch.full((3,), 1 / 16, device="cuda")
    opts2 = SolverOptions(ndim=3, iterations_fista=24, iterations_unacc=0,
                          lossy_duals=True)
    want2 = expected_launches(opts2, CFG2)
    require(want2 == (0, 3, 0, 0), f"lossy config 2 plan {want2}")
    run2, secs2, l2, peak2 = timed_run(
        lambda: run_solver(orig2, li3, lm3, opts2, keep_state=True))
    lossy_k2 = fused_kstep_iteration.lossy_launches
    require(l2 == want2 and lossy_k2 == 3,
            f"lossy config 2 launches {l2}, {lossy_k2} lossy K-steps")
    k1_2 = counted_run(orig2, li3, lm3, SolverOptions(
        ndim=3, iterations_fista=24, iterations_unacc=0, lossy_duals=True,
        temporal_kstep=False, temporal_pairs=False))
    require(torch.equal(k1_2[0]["recon"], run2["recon"].cpu()),
            "lossy config 2: the K-steps' recon != the lossy K=1 loop's")
    np.testing.assert_allclose(k1_2[0]["delta"].numpy(),
                               run2["delta"].cpu().numpy(), rtol=1e-5)
    ms2, raw2 = lossy_turns(orig2, [run2["recon"], *run2["accs"],
                                    *run2["ds"]], li3, lm3)
    b2 = launch_bound_seconds(CFG2, True, 8, bw, f32, d_itemsize=2)[0] \
        * 1e3 if bw and f32 else float("nan")
    del run2, orig2
    torch.cuda.empty_cache()
    log(f"phase 11 (b) config 2 {CFG2} FISTA x24 lossy_duals: run_solver "
        f"{secs2:.4f} s = {secs2 / 24:.4f} s per iteration, launches "
        f"whole-run/K-step/pair/K=1 {l2}, all LOSSY K=8; recon bitwise the "
        f"lossy K=1 loop's ({k1_2[1]:.4f} s, launches {k1_2[2]}), traces "
        f"within rtol 1e-5; peak device memory {peak2 / 2**30:.3f} GiB; in "
        f"turns on the run's state: one lossy K=8 launch {ms2['kstep']:.3f} "
        f"ms ({b2 / ms2['kstep']:.3f} of its {b2:.2f} ms bound), the exact "
        f"K=8 {ms2['exact_kstep']:.3f} ms, 8 lossy K=1 launches "
        f"{8 * ms2['k1']:.3f} ms (runs "
        f"{ {k: [round(x, 3) for x in v] for k, v in raw2.items()} }); "
        f"{time.perf_counter() - t0:.1f} s [{smi}]")
    del k1_2

    # (b) the lossy MSE run in REF+LOSSY pairs and the lossy stop run behind
    # the guard, each against the lossy K=1 loop
    t0 = time.perf_counter()
    mse_kw = dict(ndim=4, iterations_fista=20, iterations_unacc=0,
                  calculate_mse=True, lossy_duals=True)
    runs_m = {path: counted_run(orig, li, lm, SolverOptions(**mse_kw, **kw),
                                ref=ref4)
              for path, kw in (("pairs", {}),
                               ("k1", dict(temporal_pairs=False)))}
    lossy_m = fused_iteration.lossy_launches
    want_m = runs_m["k1"][0]
    same_result([runs_m["pairs"]], want_m, "config 4 lossy MSE",
                keys=("b_norm", "delta", "mse"))
    lm_ = {path: r[2] for path, r in runs_m.items()}
    require(lm_["pairs"] == (0, 0, 10, 0) and lm_["k1"] == (0, 0, 0, 20)
            and lossy_m == 20, f"config 4 lossy MSE launches {lm_}")
    mse = want_m["mse"].numpy()
    require(bool(np.all(mse > 0)) and mse[-1] < mse[0],
            f"config 4 lossy MSE did not fall: {mse[0]} -> {mse[-1]}")
    secs_m = {path: r[1] for path, r in runs_m.items()}
    del ref4, runs_m
    torch.cuda.empty_cache()
    n4 = 64
    fixed = run_solver(orig, li, lm, SolverOptions(
        ndim=4, iterations_fista=n4, iterations_unacc=0, lossy_duals=True))
    thr4, stop4 = stop_threshold(fixed["delta"], 48)
    del fixed
    torch.cuda.empty_cache()
    base4 = dict(ndim=4, iterations_fista=n4, iterations_unacc=0,
                 stopping_relative_change=thr4, lossy_duals=True)
    need4 = engine.stop_ckpt_bytes(SolverOptions(**base4), CFG4,
                                   torch.float32)
    runs4, lossy4 = {}, {}
    for path, kw in (("pick", {}), ("k1", dict(temporal_kstep=False,
                                              temporal_pairs=False))):
        runs4[path] = counted_run(orig, li, lm, SolverOptions(**base4, **kw))
        lossy4[path] = (fused_iteration.lossy_launches,
                        fused_pair_iteration.lossy_launches,
                        fused_kstep_iteration.lossy_launches)
    want4 = runs4["k1"][0]
    require(want4["iterations_run"] == stop4 and want4["early_stopped"],
            f"config 4 lossy stop after {want4['iterations_run']}, expected "
            f"{stop4}")
    same_result([runs4["pick"]], want4, "config 4 lossy stop")
    l4 = {path: r[2] for path, r in runs4.items()}
    k1_stop, pair_stop, kstep_stop = lossy4["pick"]
    require(need4 <= engine.STOP_CKPT_MAX_BYTES and l4["pick"][0] == 0
            and l4["pick"][1] == kstep_stop > 0
            and l4["pick"][2] == pair_stop
            and l4["pick"][3] == k1_stop > 0 and l4["k1"][:3] == (0, 0, 0)
            and lossy4["k1"][0] == l4["k1"][3],
            f"config 4 lossy stop launches {l4}")
    log(f"phase 11 (b) config 4 lossy MSE x20 with the clean cube as "
        f"reference: REF+LOSSY pairs (launches {lm_['pairs']}) and the lossy "
        f"K=1 loop ({lm_['k1']}, all LOSSY): recon bitwise equal, MSE trace "
        f"within rtol 1e-5 (SSE {mse[0]:.4e} -> {mse[-1]:.4e}), seconds "
        f"pairs {secs_m['pairs']:.4f}, K=1 loop {secs_m['k1']:.4f}; lossy stop "
        f"{thr4:.6e}: both stop after {stop4} iterations, recon bitwise "
        f"equal, traces within rtol 1e-5; state + checkpoint "
        f"{need4 / 2**30:.2f} GiB; launches whole-run/K-step/pair/K=1: the "
        f"engine's pick {l4['pick']} (all LOSSY: K-steps behind the guard), "
        f"the lossy K=1 loop "
        f"{l4['k1']}; seconds: pick {runs4['pick'][1]:.4f} "
        f"({runs4['pick'][1] / stop4 * 1e3:.3f} ms per iteration), K=1 loop "
        f"{runs4['k1'][1]:.4f} ({runs4['k1'][1] / stop4 * 1e3:.3f}); peak "
        f"device memory: pick {runs4['pick'][3] / 2**30:.3f} GiB, K=1 loop "
        f"{runs4['k1'][3] / 2**30:.3f} GiB; {time.perf_counter() - t0:.1f} s "
        f"[{smi}]")
    del runs4, orig
    torch.cuda.empty_cache()

    # (c) config 4 lossy out of core, stream and temporal mode, against in
    # core
    t0 = time.perf_counter()
    want_c = denoise4D(cube, mu, iterations=2, FISTA=True, lossy_duals=True,
                       quiet=True, device="cuda")
    torch.cuda.empty_cache()
    (got, la, run, peak_c) = ooc_run(lambda: outofcore.denoise_outofcore(
        cube, mu, iterations=2, FISTA=True, n_slabs=4, lossy_duals=True,
        device="cuda"))
    require(np.array_equal(got[0], want_c[0]),
            "config 4 lossy out of core recon != denoise4D's")
    for g, w in zip(got[1:], want_c[1:]):
        np.testing.assert_allclose(g, w, rtol=1e-5)
    require(la == (0, 0, 0, 8, 8), f"config 4 lossy out of core launches "
                                   f"(whole-run, K-step, pair, K=1, K=1 with "
                                   f"halos) {la}")
    log(f"phase 11 (c) config 4 lossy out of core, stream mode, 4 slabs, x2: "
        f"recon bitwise denoise4D's, traces within rtol 1e-5; "
        f"{run['sweep_seconds'] / 2:.4f} s per iteration; "
        f"{run['h2d_bytes'] / 2e9:.2f} GB in and {run['d2h_bytes'] / 2e9:.2f}"
        f" GB out per iteration at "
        f"{run['h2d_bytes'] / run['h2d_seconds'] / 1e9:.2f} and "
        f"{run['d2h_bytes'] / run['d2h_seconds'] / 1e9:.2f} GB/s; host memory "
        f"pinned {run['pinned_bytes'] / 2**30:.2f} GiB in "
        f"{run['pin_seconds']:.3f} s; peak device memory "
        f"{peak_c / 2**30:.3f} GiB; launches {la}; "
        f"{time.perf_counter() - t0:.1f} s [{smi}]")
    del got, want_c
    t0 = time.perf_counter()
    n_t = 16
    want_t = denoise4D(cube, mu, iterations=n_t, FISTA=True,
                       lossy_duals=True, quiet=True, device="cuda")
    torch.cuda.empty_cache()
    (got, la, run, peak_t) = ooc_run(lambda: outofcore.denoise_outofcore(
        cube, mu, iterations=n_t, FISTA=True, n_slabs=4, temporal_k=8,
        lossy_duals=True, device="cuda"))
    lossy_t = (fused_pair_iteration.lossy_launches,
               fused_iteration.lossy_launches)
    require(np.array_equal(got[0], want_t[0]),
            "config 4 lossy temporal out of core recon != denoise4D's")
    np.testing.assert_allclose(got[2][7::8], want_t[2][7::8], rtol=1e-5)
    require(la == (0, 0, 24, 16, 0) and lossy_t == (24, 16),
            f"config 4 lossy temporal out of core launches (whole-run, "
            f"K-step, pair, K=1, K=1 with halos) {la}, lossy pair and K=1 "
            f"{lossy_t}")
    log(f"phase 11 (c) config 4 lossy out of core, temporal mode K=8, 4 "
        f"slabs, x{n_t}: recon bitwise denoise4D's, sweep-end deltas within "
        f"rtol 1e-5; {run['sweep_seconds'] / n_t:.4f} s per iteration "
        f"(the exact run's in PERF.md: 0.2101); {run['h2d_bytes'] / 2e9:.2f}"
        f" GB in and "
        f"{run['d2h_bytes'] / 2e9:.2f} GB out per sweep; host memory pinned "
        f"{run['pinned_bytes'] / 2**30:.2f} GiB in {run['pin_seconds']:.3f} "
        f"s; peak device memory {peak_t / 2**30:.3f} GiB; launches {la}, all "
        f"LOSSY; {time.perf_counter() - t0:.1f} s [{smi}]")
    del got, want_t

    # (d) a 2-rank lossy mesh of processes sharing the card, in pairs at
    # its small rows
    t0 = time.perf_counter()
    small = piecewise_4d(LOSSY_MESH, SEED + 12)[0]
    src = os.path.join(tmp, "lossy_mesh.npy")
    np.save(src, small)
    with pairs_at_any_row():
        want_d = single(lambda: denoise4D(small, mu, iterations=4, FISTA=True,
                                          lossy_duals=True, quiet=True,
                                          device="cuda"))
    shards = {"lossy": (2, 1, 1, 1), "lossy1": (1, 2, 1, 1)}
    res = run_mesh(tmp, 2, [dict(name=k, input=src, ndim=4, iterations=4,
                                 shard=list(v), any_row=True,
                                 options=dict(lossy_duals=True))
                            for k, v in shards.items()], 300)
    for k, v in shards.items():
        runs = check_mesh_run(k, res, want_d, *blocks(want_d["recon"], v))
        halo = "halo1" if v[1] > 1 else "halo0"
        require(all(tuple(r["launches"]) == (0, 0, 2, 0) and r[halo] == 2
                    and r["pair_lossy"] == 2 for r in runs),
                f"lossy mesh {v} launches {[r['launches'] for r in runs]}")
    log(f"phase 11 (d) {LOSSY_MESH} lossy x4 on a (2, 1, 1, 1) and a (1, 2, "
        f"1, 1) mesh of 2 processes sharing the card, pairs at any row "
        f"size: each block and the gathered recon bitwise the single-device "
        f"lossy run (sha256), traces within rtol 1e-5; 2 LOSSY HALO0 and 2 "
        f"LOSSY HALO1 pairs per rank; {time.perf_counter() - t0:.1f} s")
    log(f"phase 11 {time.perf_counter() - t_phase:.1f} s")
    return {"k1": {"launches": k1_stop, "err": err, "ms": ms["k1"],
                   "plain_ms": ms["plain"], "bound": b_k1},
            "pair": {"launches": n_lossy, "err": perr, "ms": ms["pair"],
                     "plain_ms": ms["plain_pair"], "bound": b_pair},
            "kstep": {"launches": n_lossy_k, "err": kerr, "ms": ms["kstep"],
                      "plain_ms": ms["plain_kstep"], "bound": b_k8}}


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
    dev = torch.device("cuda")
    ref_grid = {f"{nd}D {'FISTA' if f else 'unacc'}":
                (cooperative_grid(dev, nd, f), cooperative_grid(dev, nd, f, True))
                for nd in (3, 4) for f in (True, False)}
    lossy_grid = {f"{nd}D": (cooperative_grid(dev, nd, True, lossy=True),
                             cooperative_grid(dev, nd, True, True, lossy=True))
                  for nd in (3, 4)}
    log(f"phase 1 pair kernel instantiations <ND,FISTA,REF,HALO,LOSSY> "
        f"(REF: the reference-cube SSE; LOSSY: bfloat16 d): "
        f"{'; '.join(pair_ptx)}; full cooperative grid without / with REF: "
        f"{ref_grid}, LOSSY (FISTA): {lossy_grid}")
    # the dual pass's SASS check runs beside phase 2 (cuobjdump takes ~11 s)
    t_sass = time.perf_counter()
    pool = ThreadPoolExecutor(1)
    sass_check = pool.submit(store_order)
    pool.shutdown(wait=False)

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
    orders = sass_check.result()
    order = orders["dual_kernel"]
    dual_ptx = [row for row in ptxas.split("; ")
                if row.startswith("dual_kernel")]
    log(f"phase 1 K=1 dual pass dual_kernel<T,ND,FISTA,HALO,ISO,LOSSY> (ISO: "
        f"the 4D half-isotropic launches, loads first, b before d; LOSSY: "
        f"bfloat16 d, b before d): ptxas "
        f"{'; '.join(dual_ptx)}; SASS (tools/torch_sass_order.py) stores / "
        f"sent while their own load is in flight / LDL / STL: "
        + "; ".join(f"{a} {st}/{fl}/{ldl}/{stl}"
                    for a, _, _, st, fl, ldl, stl in order)
        + f"; checked beside phase 2, {time.perf_counter() - t_sass:.1f} s")
    iso_rows = [r for r in order if r[1]]
    require(len(iso_rows) == 8, f"expected 8 ISO instantiations of "
                                f"dual_kernel, found {iso_rows}")
    require(all(r[4] == 0 for r in iso_rows),
            f"an ISO instantiation of dual_kernel sends a store while its "
            f"own load is in flight: {iso_rows}")
    # phase 11 (e): the LOSSY instantiations (float, FISTA, ND 3 and 4,
    # with and without HALO)
    lossy_rows = [r for r in order if r[2]]
    require(len(lossy_rows) == 4, f"expected 4 LOSSY instantiations of "
                                  f"dual_kernel, found {lossy_rows}")
    require(all(r[4:] == (0, 0, 0) for r in lossy_rows),
            f"a LOSSY instantiation of dual_kernel sends a store while its "
            f"own load is in flight, or uses local memory: {lossy_rows}")
    # the pair kernel's LOSSY instantiations (ND 3 and 4, with and without
    # REF, no bands, HALO0 and HALO1), beside its exact ones
    pair_order = orders["pair_kernel"]
    pair_lossy = [r for r in pair_order if r[2]]
    log(f"phase 1 pair kernel pair_kernel<ND,FISTA,REF,HALO,LOSSY> (HALO: 0 "
        f"no bands, 1 HALO0, 2 HALO1; LOSSY: "
        f"bfloat16 d, iteration 1's d rounded in the middle of the pair): "
        f"ptxas "
        f"{'; '.join(r for r in pair_ptx if r.split('>')[0].endswith(',1'))}"
        f"; SASS stores / sent while their own load is in flight / LDL / "
        f"STL: " + "; ".join(f"{a} {st}/{fl}/{ldl}/{stl}"
                             for a, _, _, st, fl, ldl, stl in pair_order))
    require(len(pair_lossy) == 12, f"expected 12 LOSSY instantiations of "
                                   f"pair_kernel, found {pair_lossy}")
    halo1_rows = [r for r in pair_order if r[0].split(",")[3] == "2"]
    require(len(halo1_rows) == 12 and all(r[4] == 0 for r in halo1_rows),
            f"expected 12 HALO1 instantiations of pair_kernel, none sending a "
            f"store while its own load is in flight: {halo1_rows}")
    # the instantiations of every kernel that must keep their code, by the
    # digests of their instructions (tools/sass_digests.json, written by
    # tools/torch_sass_order.py --digests)
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tools", "sass_digests.json")) as f:
        kept = json.load(f)
    built = orders["digests"]
    have = set(built.values())
    lost = sorted(lab for lab, dig in kept.items() if dig not in have)
    new = sorted(lab for lab, dig in built.items()
                 if dig not in set(kept.values()))
    log(f"phase 1 SASS digests: {len(kept) - len(lost)} of {len(kept)} "
        f"instantiations in tools/sass_digests.json compiled to the same "
        f"code; {len(built)} built, with new code: {new}")
    require(not lost, f"instantiations whose code changed: {lost}")
    require(all(r[4:] == (0, 0, 0) for r in pair_lossy),
            f"a LOSSY instantiation of pair_kernel sends a store while its "
            f"own load is in flight, or uses local memory: {pair_lossy}")
    # the K-step kernel's LOSSY instantiations (ND 3 and 4, K 3, 4, 6, 8;
    # the 4D ones through the capped entry, whose exact twins spill under
    # the 128-register cap), beside its exact ones
    kstep_order = [(n, r) for n in ("kstep_kernel", "kstepcap_kernel")
                   for r in orders[n]]
    twin_local = {(n, r[0]): r[5:] for n, r in kstep_order if not r[2]}
    kstep_lossy = [(n, r) for n, r in kstep_order if r[2]]
    kstep_ptx = [row for row in ptxas.split("; ")
                 if row.startswith("kstep")]
    log(f"phase 1 K-step kernel kstep_kernel<ND,FISTA,K,LOSSY> and "
        f"kstepcap_kernel<K,LOSSY> (LOSSY: bfloat16 d, every level's d "
        f"rounded at its store): ptxas {'; '.join(kstep_ptx)}; SASS stores / "
        f"sent while their own load is in flight / LDL / STL: "
        + "; ".join(f"{n}{a} {st}/{fl}/{ldl}/{stl}"
                    for n in ("kstep_kernel", "kstepcap_kernel")
                    for a, _, _, st, fl, ldl, stl in orders[n]))
    require(len(kstep_lossy) == 8, f"expected 8 LOSSY instantiations of the "
                                   f"K-step kernel, found {kstep_lossy}")
    # no local memory, but for the capped 4D entry: no more than its exact
    # twin (its spill is open work, ROADMAP Queue 2 item 4)
    require(all(r[4] == 0 and (all(
                m <= t for m, t in zip(r[5:], twin_local[n, r[0][:-2] + "0>"]))
                if n == "kstepcap_kernel" else r[5:] == (0, 0))
                for n, r in kstep_lossy),
            f"a LOSSY instantiation of the K-step kernel sends a store while "
            f"its own load is in flight, uses local memory (3D) or uses more "
            f"than its exact twin (the capped 4D entry): {kstep_lossy}, "
            f"exact {twin_local}")
    # the off-card comparisons at config 4 share one page-locked host state
    pinned = contextlib.ExitStack()
    pinned.enter_context(pinned_copies())
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
    prof = profile_kernels(CFG4, lossy=True)
    log(f"phase 2 torch.profiler device time per FISTA f32 iteration at "
        f"{CFG4}, exact launches, then lossy (bfloat16 d) K=1 launches on "
        f"the same state: {'; '.join(prof) or 'no device events seen'} "
        f"[{smi}]")
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
        n_it = 16 if shape == CFG4 else 24
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
    pinned.close()
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
    clean3, noisy3 = cfg2_eels()
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
    cfg3_digest = chunk_phase(smi, cube, cube1, r1, cube3, stop5)
    log(f"phase 6 {time.perf_counter() - t6:.1f} s")

    # phase 7: the command line on the card
    cli_phase(smi, cube)

    # phase 8: out-of-core runs
    halo8 = outofcore_phase(smi, name, cube, cube3)

    # phase 9: sharded runs
    torch.cuda.empty_cache()
    halo9 = sharded_phase(smi, name, cube, scan, det, cube3, cfg3_digest)

    # phase 10: sharded runs in the K=1 kernel's mesh-only modes
    torch.cuda.empty_cache()
    modes10 = modes_phase(smi, name, cube, cube3)

    # phase 11: lossy shadow duals
    torch.cuda.empty_cache()
    tmp11 = tempfile.mkdtemp(prefix="cytv_lossy_")
    try:
        lossy11 = lossy_phase(smi, name, cube, scan, det, tmp11)
    finally:
        shutil.rmtree(tmp11, ignore_errors=True)

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
        # the K=1 kernel's HALO instantiation: its launches on the config-4
        # stream-mode run of phase 8 (b), its time at that run's slab
        ("fused_iteration_halo", "fused_iteration.cu", "fused.py:872",
         halo8["launches"], halo8["err"], halo8["ms"], halo8["plain_ms"],
         halo8["bound"]),
        # the pair kernel's HALO0 instantiation: its launches per rank on
        # the config-4 (2, 1, 1, 1) mesh run of phase 9 (b), its time at
        # that run's shard (bands on both sides)
        ("fused_pair_iteration_halo0", "temporal_pair.cu", "temporal.py:947",
         halo9["launches"], halo9["err"], halo9["ms"], halo9["plain_ms"],
         halo9["bound"]),
        # the pair kernel's HALO1 instantiation: its launches per rank on
        # the config-4 (1, 2, 1, 1) mesh run of phase 9 (b1), its time at
        # that run's shard (bands on both sides)
        ("fused_pair_iteration_halo1", "temporal_pair.cu", "temporal.py:947",
         halo9["halo1"]["launches"], halo9["halo1"]["err"],
         halo9["halo1"]["ms"], halo9["halo1"]["plain_ms"],
         halo9["halo1"]["bound"]),
        # the K=1 kernel's HALO instantiation in its mesh-only modes: its
        # launches per rank on the config-4 stem4d-iso (2, 1, 1, 1) mesh
        # run of phase 10 (b), its time at that run's shard
        ("fused_iteration_mesh_modes", "fused_iteration.cu", "fused.py:872",
         modes10["launches"], modes10["err"], modes10["ms"],
         modes10["plain_ms"], modes10["bound"]),
        # the K=1 kernel's ISO instantiation (half-isotropic, no halos): its
        # launches on the single-device config-4 stem4d-iso x10 run of phase
        # 10, its time at that run's cube
        ("fused_iteration_iso", "fused_iteration.cu", "fused.py:872",
         modes10["iso_launches"], max(max_err, modes10["err"]),
         modes10["iso_ms"], modes10["iso_plain_ms"], bound(CFG4, True, 1)),
        # the K=1 kernel's LOSSY instantiation (bfloat16 d): its launches on
        # the config-4 lossy stop run of phase 11 (b) (its prologue and the
        # steps where the guard refuses), its time at config 4, the bound
        # with d at 2 bytes
        ("fused_iteration_lossy", "fused_iteration.cu", "fused.py:872",
         lossy11["k1"]["launches"], lossy11["k1"]["err"], lossy11["k1"]["ms"],
         lossy11["k1"]["plain_ms"], lossy11["k1"]["bound"]),
        # the pair kernel's LOSSY instantiation (bfloat16 d, iteration 1's d
        # rounded in the middle of the pair): its launches on the config-4
        # lossy x20 run of phase 11 (b), its time at that run's cube
        ("fused_pair_iteration_lossy", "temporal_pair.cu", "temporal.py:947",
         lossy11["pair"]["launches"], lossy11["pair"]["err"],
         lossy11["pair"]["ms"], lossy11["pair"]["plain_ms"],
         lossy11["pair"]["bound"]),
        # the K-step kernel's LOSSY instantiation (bfloat16 d, every level's
        # d rounded at its store): its launches on the config-4 lossy x20
        # run of phase 11 (b), its time at that run's cube (K=8), the bound
        # with d at 2 bytes
        ("fused_kstep_iteration_lossy", "temporal_kstep.cu", "kstep.py:395",
         lossy11["kstep"]["launches"], lossy11["kstep"]["err"],
         lossy11["kstep"]["ms"], lossy11["kstep"]["plain_ms"],
         lossy11["kstep"]["bound"]),
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
    if len(sys.argv) == 3 and sys.argv[1] == "--sharded-worker":
        sys.exit(sharded_worker(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--cli-worker":
        sys.exit(cli_worker(sys.argv[2]))
    sys.exit(main())
