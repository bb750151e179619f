"""K TV iterations per launch (K ∈ {3, 4, 6, 8}): the CUDA K-step kernel
and its plain PyTorch version.

Replaces the TPU kernel ``cytvdn_tpu/kernels/kstep.py::
fused_kstep_iteration`` (K iterations per Pallas pass, bit-identical to K
passes of the one-iteration kernel). The TPU kernel keeps levels 1..K-1 in
VMEM ring carries; on the H100 the kernel (``csrc/temporal_kstep.cu``) is
the pair kernel's wavefront made K levels deep: one cooperative launch
walks dual-1, recon-1, ..., dual-K, recon-K along axis 0, each op a few
rows behind the last, with a grid-wide barrier between stages, so the state
is updated in place without races and without a second copy (the schedule
and why it is race-free are in the source's header). Each row operation
walks its row with the whole-run kernel's vector walk
(``csrc/vec_walk.cuh``): four elements per thread with 128-bit loads, every
load of a work item before its first store, neighbours along the last axis
from lanes and along axis ndim-2 from shared memory. Its element arithmetic
is that of ``csrc/fused_iteration.cu``, so the state is bitwise equal to K
K=1 launches and to K/2 pair launches; the 3K sums are per-block partials
combined in a fixed order, within rtol 1e-5 of K K=1 launches' sums.

A launch has ceil(N0 / R) + 3K − 1 stages for K iterations, R axis-0 rows
to a stage (:func:`kstep_rows`). At small rows, where the grid barriers set
the pace, that is what the kernel saves over the pairs' N0 + 5 per two
iterations; its HBM traffic lies between K two-pass iterations and one
fused pass per K iterations (``utils/perf.py``, ``kstep_upper`` and
``kstep_floor``).

Lossy duals (``lossy_duals``): under FISTA ``ds`` may be bfloat16. The TPU
kernel rounds every intermediate level's ``d`` onto the bfloat16 grid
(``qd``, ``kstep.py:251-254, :329``) and stores the last level's as
bfloat16 (``:339-340, :480-482``). The CUDA kernel keeps every level's
``d`` in the ``d`` array itself, so its ``LOSSY`` instantiations round
each level's ``d`` at its bfloat16 store, and the next level reads it back
widened; the plain version's K lossy K=1 steps round in their ``copy_``.
So a lossy K-step is bitwise K lossy K=1 launches, ``d`` included.

Scope, as the TPU kernel's on one device: float32, Jia-Zhao boundaries,
anisotropic duals, 3D and 4D, FISTA and unaccelerated, N0 ≥ 2K, bfloat16
``ds`` under FISTA. :func:`fused_kstep_iteration` launches the kernel for
CUDA tensors and runs :func:`fused_kstep_iteration_reference` for CPU
tensors; there is no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from cytvdn_tpu_torch.config import BCMode
from cytvdn_tpu_torch.kernels import build
from cytvdn_tpu_torch.kernels.fused import (
    _check_state,
    _launch_args,
    fused_iteration_reference,
)
from cytvdn_tpu_torch.kernels.resident import resident_work_items

Tensor = torch.Tensor

#: the compiled depths, deepest first (the automatic choice takes the first
#: one the shape admits)
KSTEP_CANDIDATES = (8, 6, 4, 3)

#: the most consecutive axis-0 rows the wavefront takes as one super-row
#: by default, and the bytes of one array's super-row it aims at
#: (:func:`kstep_rows`)
MAX_ROWS_PER_STAGE = 16
SUPER_ROW_BYTES = 32 * 2**20

#: the full cooperative grid per (device, ndim, fista, k, lossy): each depth
#: and mode is its own instantiation with its own registers and shared
#: memory, so its own occupancy
_GRID: Dict[Tuple[int, int, bool, int, bool], int] = {}


def kstep_supported(shape, dtype, bc, k: int, fista: bool) -> bool:
    """Whether the K-step kernel covers this configuration at depth ``k``:
    float32, 3D/4D, Jia-Zhao, one of the compiled depths, N0 ≥ 2K (the TPU
    kernel's gate without its single-strip VMEM plan). ``fista`` is part of
    the signature as in the JAX package; both variants are compiled."""
    if dtype != torch.float32 or len(shape) not in (3, 4) or min(shape) < 1:
        return False
    if BCMode(bc) != BCMode.JIA_ZHAO or k not in KSTEP_CANDIDATES:
        return False
    return shape[0] >= 2 * k


def kstep_rows(shape) -> int:
    """R, the consecutive axis-0 rows the wavefront takes as one super-row
    by default: as many as make one array's super-row
    :data:`SUPER_ROW_BYTES` (32 MiB), from 1 to :data:`MAX_ROWS_PER_STAGE`
    and at most N0. A launch then has ceil(N0 / R) + 3K - 1 grid barriers
    instead of N0 + 3K - 1, and each stage R times the work items. Set by
    measurement (``tools/torch_kstep_ab.py --rows``, K=8 at R = 1 to 16,
    PERF.md §6, NVIDIA H100 80GB HBM3 at 700 W): at rows of 128 KB to
    16 MiB the rule's R was within 1.4% of the fastest R (1.46x over R = 1
    at 64x64x512; R = 4 at 8 MiB rows, R = 2 at 16 MiB rows, where R = 1
    was the fastest). Rows above 16 MiB take R = 1, untimed against other
    R. The result does not depend on R."""
    row = 4
    for e in shape[1:]:
        row *= e
    return max(1, min(MAX_ROWS_PER_STAGE, SUPER_ROW_BYTES // row, shape[0]))


def best_kstep(shape, dtype, bc, fista: bool,
               forced: Optional[int] = None) -> int:
    """The staircase depth for this run, or 0 to leave it to the pairs or
    the one-iteration loop (the engine's choice).

    A forced depth of 3 or more is checked with :func:`kstep_supported`
    only, and one with no compiled kernel raises; a forced depth below 3
    gives 0. The automatic choice is the deepest candidate with N0 ≥ 2K,
    wherever the kernel covers the run. Measured (``chip_smoke.py``'s
    dispatch and size sweeps, PERF.md §6, NVIDIA H100 80GB HBM3 at 700 W):
    ``run_solver`` with the whole-run kernel off ran faster at this depth
    than on the one-iteration loop and than in pairs at every state of the
    dispatch sweep, 336 MB to 42.9 GB: 3D and 4D, FISTA and unaccelerated,
    rows of 512 KB to 32 MiB, N0 from 2K (K = 6 and 8) to 1024 (1.005-1.37x
    over the loop, host clock). From 10.5 to 336 MB (3D unaccelerated and
    FISTA, 4D FISTA) a K=8 launch took less device time per iteration than
    the one-iteration kernel (1.17-4.6x). Default paths reach it where the
    whole-run kernel does not take the run. The choice is purely a
    throughput decision: the result is bitwise the same.
    """
    if forced:
        if forced < 3:
            return 0
        if forced not in KSTEP_CANDIDATES:
            raise ValueError(f"temporal_k={forced}: the K-step kernel is "
                             f"compiled for K in {sorted(KSTEP_CANDIDATES)}")
        return forced if kstep_supported(shape, dtype, bc, forced, fista) \
            else 0
    for k in KSTEP_CANDIDATES:
        if kstep_supported(shape, dtype, bc, k, fista):
            return k
    return 0


def kstep_stages(shape, k: int, rows_per_stage: int = 1):
    """The kernel's schedule for ``shape`` at depth ``k``, with R =
    ``rows_per_stage`` consecutive axis-0 rows taken as one super-row:
    yields ``(stage, op, lo, hi)`` for every row operation that has rows,
    in launch order. ``op`` 2l is dual-(l+1) and 2l+1 recon-(l+1); in stage
    ``st`` an op's super-row is ``st - 3(op // 2) - 2(op % 2)`` and its
    rows are ``[lo, hi)``, R of them (fewer in the last super-row). There
    are ceil(N0 / R) + 3k - 1 stages, with a grid barrier after each;
    within a stage the ops touch disjoint rows, so they may run in any
    order. R = 1 is one row per stage."""
    n0, rr = shape[0], rows_per_stage
    supers = -(-n0 // rr)
    for st in range(supers + 3 * k - 1):
        for op in range(2 * k):
            s = st - 3 * (op // 2) - 2 * (op % 2)
            if 0 <= s < supers:
                yield st, op, s * rr, min((s + 1) * rr, n0)


def fused_kstep_iteration_reference(
    orig: Tensor,
    recon: Tensor,
    accs: Sequence[Tensor],
    ds: Optional[Sequence[Tensor]],
    rhos: Optional[Tensor],
    lambda_inv: Tensor,
    lam_mu: Tensor,
    *,
    k: int,
    fista: bool,
):
    """The plain version of :func:`fused_kstep_iteration`: ``k`` Jia-Zhao
    iterations of :func:`fused_iteration_reference`, in place, returning
    ``(recon, accs, ds, bn, dnum, dden)`` with (k,) sums. Bfloat16 ``ds``
    (lossy duals) round after each iteration, in the K=1 steps'
    ``copy_``, as the kernel rounds each level's ``d``."""
    sums = []
    for t in range(k):
        sums.append(torch.stack(fused_iteration_reference(
            orig, recon, accs, ds, rhos[t] if fista else None, lambda_inv,
            lam_mu, fista=fista, bc=BCMode.JIA_ZHAO)[3:]))
    bn, dnum, dden = torch.stack(sums).unbind(1)
    return recon, accs, ds, bn, dnum, dden


def cooperative_grid(device: torch.device, ndim: int, fista: bool,
                     k: int, lossy: bool = False) -> int:
    """Blocks of the full cooperative grid of the (ndim, fista, k, lossy)
    kernel on ``device``: resident blocks per SM of that instantiation
    times SMs."""
    key = (device.index if device.index is not None
           else torch.cuda.current_device(), ndim, fista, k, lossy)
    if key not in _GRID:
        lib = build.load()
        blocks = ctypes.c_int(0)
        with torch.cuda.device(key[0]):
            build.check(lib.tv_kstep_max_blocks(ndim, int(fista), k,
                                                int(lossy),
                                                ctypes.byref(blocks)))
        _GRID[key] = blocks.value
    return _GRID[key]


def fused_kstep_iteration(
    orig: Tensor,
    recon: Tensor,
    accs: Sequence[Tensor],
    ds: Optional[Sequence[Tensor]],
    rhos: Optional[Tensor],
    lambda_inv: Tensor,
    lam_mu: Tensor,
    *,
    k: int,
    fista: bool,
    grid: Optional[int] = None,
    rows_per_stage: Optional[int] = None,
):
    """``k`` full Jia-Zhao TV iterations, updating ``recon``, ``accs`` and
    ``ds`` in place.

    ``rhos`` holds the ``k`` FISTA momentum ratios, contiguous on the
    data's device (ignored when ``fista`` is false); ``lambda_inv`` and
    ``lam_mu`` are per-axis tensors there too. The state must keep each
    accumulator's leading slab along its own axis at zero, as every
    Jia-Zhao run does (the kernel's axis-0 wrap reads it). ``grid`` forces
    the number of blocks (the race tests); by default the launch takes the
    full cooperative grid of this depth. A grid above the cooperative limit
    raises. ``rows_per_stage`` forces R, the consecutive axis-0 rows the
    wavefront takes as one super-row (:func:`kstep_stages`; at least 1,
    clipped to N0); by default :func:`kstep_rows`. The result does not
    depend on it.

    Lossy duals: under FISTA ``ds`` may be bfloat16 (float32 data). The old
    ``d`` widens exactly, the arithmetic stays float32, and each level's
    new ``d`` is stored rounded to nearest even before the next level reads
    it (the kernel's ``LOSSY`` instantiations; the plain version's K lossy
    K=1 steps).

    Returns ``(recon, accs, ds, bn, dnum, dden)`` — the state objects
    passed in and the per-iteration sums as (k,) tensors.
    ``fused_kstep_iteration.launches`` counts kernel launches,
    ``fused_kstep_iteration.lossy_launches`` those with bfloat16 ``ds``;
    ``fused_kstep_iteration.calls`` counts every call that passed the
    checks, on the CPU too.
    """
    ndim = orig.dim()
    if not kstep_supported(tuple(orig.shape), orig.dtype, BCMode.JIA_ZHAO, k,
                           fista):
        raise ValueError(
            f"fused_kstep_iteration does not cover shape {tuple(orig.shape)}, "
            f"dtype {orig.dtype} at K={k} (float32, 3D/4D, K in "
            f"{sorted(KSTEP_CANDIDATES)}, N0 >= 2K)")
    lossy = _check_state(orig, recon, accs, ds, fista, lossy_ok=True)
    rr = kstep_rows(orig.shape) if rows_per_stage is None \
        else int(rows_per_stage)
    if rr < 1:
        raise ValueError(f"rows_per_stage={rows_per_stage}: at least 1")
    rr = min(rr, orig.shape[0])
    if orig.device.type == "cpu":
        fused_kstep_iteration.calls += 1
        return fused_kstep_iteration_reference(
            orig, recon, accs, ds, rhos, lambda_inv, lam_mu, k=k, fista=fista)
    if orig.device.type != "cuda":
        raise ValueError(f"fused_kstep_iteration runs on CUDA or CPU tensors, "
                         f"not {orig.device}")
    scalars = [("lambda_inv", lambda_inv, ndim), ("lam_mu", lam_mu, ndim)]
    if fista:
        scalars.append(("rhos", rhos, k))
    bs, dd, dims, stream = _launch_args(orig, accs, ds if fista else None,
                                        scalars)
    # a stage's work items: 2k row operations of R axis-0 slabs each, in
    # the whole-run kernel's tiles (the walk of csrc/vec_walk.cuh)
    work = 2 * k * rr * resident_work_items(tuple(orig.shape)) \
        // orig.shape[0]
    rows = orig.numel() // (orig.shape[-2] * orig.shape[-1])
    if work >= 2**31 or rows >= 2**32:
        raise ValueError(f"shape {tuple(orig.shape)}: {work} work items per "
                         f"stage, {rows} rows; the kernel's 32-bit index "
                         "arithmetic takes < 2**31 and < 2**32")
    lib = build.load()
    nblocks = grid if grid is not None else cooperative_grid(
        orig.device, ndim, fista, k, lossy)
    partials = torch.empty(3 * k * nblocks, dtype=torch.float64,
                           device=orig.device)
    out = torch.empty(k, 3, dtype=orig.dtype, device=orig.device)
    err = lib.tv_kstep_iteration_f32(
        orig.data_ptr(), recon.data_ptr(), *bs, *dd,
        lambda_inv.data_ptr(), lam_mu.data_ptr(),
        rhos.data_ptr() if fista else None,
        partials.data_ptr(), out.data_ptr(), ndim, *dims, int(fista),
        int(lossy), k, rr, nblocks, stream)
    build.check(err)
    fused_kstep_iteration.calls += 1
    fused_kstep_iteration.launches += 1
    fused_kstep_iteration.lossy_launches += lossy
    return (recon, accs, ds, *out.unbind(1))


fused_kstep_iteration.launches = 0
fused_kstep_iteration.lossy_launches = 0
fused_kstep_iteration.calls = 0
