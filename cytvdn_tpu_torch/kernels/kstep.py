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
and why it is race-free are in the source's header). Its element arithmetic
is that of ``csrc/fused_iteration.cu``, so the state is bitwise equal to K
K=1 launches and to K/2 pair launches; the 3K sums are per-block partials
combined in a fixed order, within rtol 1e-5 of K K=1 launches' sums.

A launch has N0 + 3K − 1 stages for K iterations. At small rows, where the
grid barriers set the pace, that is what the kernel saves over the pairs'
N0 + 5 per two iterations; its HBM traffic lies between K two-pass
iterations and one fused pass per K iterations (``utils/perf.py``,
``kstep_upper`` and ``kstep_floor``).

Scope, as the TPU kernel's on one device: float32, Jia-Zhao boundaries,
anisotropic duals, 3D and 4D, FISTA and unaccelerated, N0 ≥ 2K.
:func:`fused_kstep_iteration` launches the kernel for CUDA tensors and runs
:func:`fused_kstep_iteration_reference` for CPU tensors; there is no
fallback.
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
    _work_items,
    fused_iteration_reference,
)

Tensor = torch.Tensor

#: the compiled depths, deepest first (the automatic choice takes the first
#: one the shape admits)
KSTEP_CANDIDATES = (8, 6, 4, 3)

#: the H100's L2 cache, 50 MB (NVIDIA's Hopper white paper)
L2_BYTES = 50_000_000

#: the largest state (:func:`state_bytes`) the automatic choice sends to
#: the K-step kernel (``best_kstep``), set by measurement (``chip_smoke.py``,
#: ``run_solver`` with the whole-run kernel off, K=8 against the
#: one-iteration loop; PERF.md §6, NVIDIA H100 80GB HBM3 at 700 W): K=8 was
#: faster up to 67.1 MB (2.1-5.2x at 10.5 MB, 2% at 41.9 MB, 12% at
#: 64x64x512 FISTA) and slower from 83.9 MB (25% there, 35% at 336 MB,
#: 5-39% from 503 MB to 5.4 GB)
KSTEP_MAX_STATE_BYTES = 70_000_000

#: the full cooperative grid per (device, ndim, fista, k): each depth is its
#: own instantiation with its own registers and shared memory, so its own
#: occupancy
_GRID: Dict[Tuple[int, int, bool, int], int] = {}


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


def stage_bytes(shape, k: int, fista: bool) -> int:
    """Bytes one stage of the depth-``k`` wavefront touches: ``k`` levels,
    each the rows of one fused pass (4n+3 arrays under FISTA, 2n+3
    without) of one axis-0 slab."""
    n = len(shape)
    row = 4
    for e in shape[1:]:
        row *= e
    return k * row * ((4 * n + 3) if fista else (2 * n + 3))


def state_bytes(shape, fista: bool) -> int:
    """Bytes of a run's state: orig, recon, one accumulator per axis [, one
    shadow dual per axis under FISTA], float32."""
    n = len(shape)
    vox = 1
    for e in shape:
        vox *= e
    return 4 * vox * (2 + n + (n if fista else 0))


def best_kstep(shape, dtype, bc, fista: bool,
               forced: Optional[int] = None) -> int:
    """The staircase depth for this run, or 0 to leave it to the pairs or
    the one-iteration loop (the engine's choice).

    A forced depth of 3 or more is checked with :func:`kstep_supported`
    only, and one with no compiled kernel raises; a forced depth below 3
    gives 0. The automatic choice is the H100 rule: the deepest candidate
    with N0 ≥ 2K, on shapes where one stage at that depth fits the 50 MB
    L2 (:func:`stage_bytes`) and the state (:func:`state_bytes`) is at
    most :data:`KSTEP_MAX_STATE_BYTES`; elsewhere 0. On small states the
    one-iteration loop is bound by its launches and K=8 wins; from ~84 MB
    K=8 is the slower one (``run_solver`` with
    the whole-run kernel off: K=8 0.0976 against 0.1000 ms per iteration
    at config 1, 41.9 MB; 0.162 against 0.129 at 83.9 MB; PERF.md §6, the
    dispatch sweep). Default paths reach it only where the whole-run
    kernel does not take the run. The choice is purely a throughput
    decision: the result is bitwise the same.
    """
    if forced:
        if forced < 3:
            return 0
        if forced not in KSTEP_CANDIDATES:
            raise ValueError(f"temporal_k={forced}: the K-step kernel is "
                             f"compiled for K in {sorted(KSTEP_CANDIDATES)}")
        return forced if kstep_supported(shape, dtype, bc, forced, fista) \
            else 0
    if state_bytes(shape, fista) > KSTEP_MAX_STATE_BYTES:
        return 0
    for k in KSTEP_CANDIDATES:
        if kstep_supported(shape, dtype, bc, k, fista):
            return k if stage_bytes(shape, k, fista) <= L2_BYTES else 0
    return 0


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
    ``(recon, accs, ds, bn, dnum, dden)`` with (k,) sums."""
    sums = []
    for t in range(k):
        sums.append(torch.stack(fused_iteration_reference(
            orig, recon, accs, ds, rhos[t] if fista else None, lambda_inv,
            lam_mu, fista=fista, bc=BCMode.JIA_ZHAO)[3:]))
    bn, dnum, dden = torch.stack(sums).unbind(1)
    return recon, accs, ds, bn, dnum, dden


def cooperative_grid(device: torch.device, ndim: int, fista: bool,
                     k: int) -> int:
    """Blocks of the full cooperative grid of the (ndim, fista, k) kernel on
    ``device``: resident blocks per SM of that instantiation times SMs."""
    key = (device.index if device.index is not None
           else torch.cuda.current_device(), ndim, fista, k)
    if key not in _GRID:
        lib = build.load()
        blocks = ctypes.c_int(0)
        with torch.cuda.device(key[0]):
            build.check(lib.tv_kstep_max_blocks(ndim, int(fista), k,
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
    raises.

    Returns ``(recon, accs, ds, bn, dnum, dden)`` — the state objects
    passed in and the per-iteration sums as (k,) tensors.
    ``fused_kstep_iteration.launches`` counts kernel launches;
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
    _check_state(orig, recon, accs, ds, fista)
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
    # a stage's work items: 2k row operations of one axis-0 slab each
    work = 2 * k * _work_items(tuple(orig.shape)) // orig.shape[0]
    if work >= 2**31:
        raise ValueError(f"shape {tuple(orig.shape)}: {work} work items per "
                         "stage; the kernel's 32-bit index arithmetic takes "
                         "< 2**31")
    lib = build.load()
    nblocks = grid if grid is not None else cooperative_grid(
        orig.device, ndim, fista, k)
    partials = torch.empty(3 * k * nblocks, dtype=torch.float64,
                           device=orig.device)
    out = torch.empty(k, 3, dtype=orig.dtype, device=orig.device)
    err = lib.tv_kstep_iteration_f32(
        orig.data_ptr(), recon.data_ptr(), *bs, *dd,
        lambda_inv.data_ptr(), lam_mu.data_ptr(),
        rhos.data_ptr() if fista else None,
        partials.data_ptr(), out.data_ptr(), ndim, *dims, int(fista), k,
        nblocks, stream)
    build.check(err)
    fused_kstep_iteration.calls += 1
    fused_kstep_iteration.launches += 1
    return (recon, accs, ds, *out.unbind(1))


fused_kstep_iteration.launches = 0
fused_kstep_iteration.calls = 0
