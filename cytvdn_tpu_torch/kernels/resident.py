"""A whole run of T TV iterations in one launch: the CUDA whole-run kernel
and its plain PyTorch version.

Replaces the TPU kernel ``cytvdn_tpu/kernels/resident.py::resident_solve``,
which holds a small cube's whole state in VMEM for ``grid=(T,)`` steps. The
H100 has no on-chip store of that size; its nearest is the 50 MB L2. The
kernel (``csrc/resident.cu``) is one persistent cooperative launch: every
block lives for all T iterations, each iteration is a dual phase and a
reconstruction phase with a grid barrier after each (the one-iteration
kernel's two launches, with barriers in place of launch boundaries), and the
state stays in device memory, where the L2 can hold it between iterations
when it is small. A thread owns four consecutive elements of the last axis
(128-bit loads where the last extent is a multiple of 4), issues every load
of a work item before its first store, and takes its neighbours along the
last axis from the neighbouring lane and along axis ndim-2 from the tile's
neighbouring row in shared memory (:func:`resident_work_items`). Each
element's arithmetic is ``csrc/fused_iteration.cu``'s, in its order, so the
state is bitwise equal to T one-iteration launches; the per-iteration sums
(sum|b|, sum|recon_new - recon|, sum|recon| and, with a reference cube, the
SSE) are per-block partials combined in a fixed order, within rtol 1e-5 of
T launches' sums.

Scope, as the TPU kernel's on one device: float32, 3D and 4D with N0 ≥ 2,
all three boundary conditions (mirror needs every extent ≥ 2), iso pairs in
4D under Jia-Zhao, FISTA with a per-iteration momentum ratio (a ratio of 0
gives the unaccelerated update exactly, so a hybrid schedule is one launch)
or unaccelerated, an optional reference cube. The state is updated in place,
so a fresh run is the caller's allocation (recon a copy of orig, zero
accumulators and shadow duals) and a resumed run is the state it hands in.
:func:`resident_supported` adds the H100 size rule (:data:`RESIDENT_BYTES`).
:func:`resident_solve` launches the kernel for CUDA tensors and runs
:func:`resident_solve_reference` for CPU tensors; there is no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from cytvdn_tpu_torch import ops
from cytvdn_tpu_torch.config import BCMode
from cytvdn_tpu_torch.kernels import build
from cytvdn_tpu_torch.kernels.fused import (
    _check,
    _check_state,
    _launch_args,
    fused_iteration_reference,
)

Tensor = torch.Tensor

#: the largest state (bytes of orig, recon, the accumulators, the shadow
#: duals and the reference cube) the engine sends to the whole-run kernel,
#: set by measurement (``chip_smoke.py``'s size sweep, PERF.md; NVIDIA H100
#: 80GB HBM3 at 700 W): ``run_solver`` was faster with the whole-run kernel
#: than on its other path (K-step, pairs, or the one-iteration loop with
#: MSE) at every state of the sweep, 10.5 to 335.5 MB (1.3-4.9x), and the
#: kernel alone faster than back-to-back one-iteration launches there too
#: (1.2-8.4x), so the budget is the sweep's largest state; larger ones are
#: not measured
RESIDENT_BYTES = 336_000_000

#: the full cooperative grid per (device, ndim, fista, iso, ref): each
#: instantiation has its own registers, so its own occupancy
_GRID: Dict[Tuple[int, int, bool, bool, bool], int] = {}

#: threads of a block, and elements of a thread along the last axis
_NT, _VW = 256, 4


def resident_state_bytes(shape, fista: bool, with_mse: bool) -> int:
    """Bytes of the state a whole run keeps: orig, recon, one accumulator
    per axis [, one shadow dual per axis under FISTA] [, the reference cube
    with MSE], float32."""
    n = len(shape)
    vox = 1
    for e in shape:
        vox *= e
    return 4 * vox * (2 + n + (n if fista else 0) + (1 if with_mse else 0))


def _lanes(last: int) -> int:
    """Lanes of a row segment for a last extent of ``last``: the least power
    of two, at most 32, whose lanes' four elements each cover it."""
    lw = 1
    while lw < 32 and _VW * lw < last:
        lw *= 2
    return lw


def resident_work_items(shape) -> int:
    """The whole-run kernel's (row, tile) work items: the leading axes
    flattened into rows, times its tiles of the two trailing axes, each
    256 / lw rows of axis ndim-2 by 4 lw elements of axis ndim-1
    (``csrc/resident.cu``)."""
    rows = 1
    for n in shape[:-2]:
        rows *= n
    lw = _lanes(shape[-1])
    return rows * -(-shape[-2] // (_NT // lw)) * -(-shape[-1] // (_VW * lw))


def _covers(shape, dtype, bc, iso_r: bool, iso_q: bool) -> bool:
    """The kernel's envelope, without the size rule."""
    if dtype != torch.float32 or len(shape) not in (3, 4) or min(shape) < 1:
        return False
    if shape[0] < 2:
        return False
    bc = BCMode(bc)
    if (iso_r or iso_q) and (len(shape) != 4 or bc != BCMode.JIA_ZHAO):
        return False
    return not (bc == BCMode.MIRROR and min(shape) < 2)


def resident_supported(shape, dtype, bc, fista: bool, isotropic_R=False,
                       isotropic_Q=False, with_mse: bool = False) -> bool:
    """Whether the engine runs this configuration through the whole-run
    kernel: float32, 3D/4D with N0 ≥ 2, iso pairs only in 4D under
    Jia-Zhao, mirror only where every extent is ≥ 2 (the TPU kernel's
    envelope without its VMEM plan and 3D flat fold), and the H100 size
    rule: :func:`resident_state_bytes` ≤ :data:`RESIDENT_BYTES`. It depends
    on the shape, dtype and options only, never on the device."""
    return _covers(tuple(shape), dtype, bc, isotropic_R, isotropic_Q) and \
        resident_state_bytes(shape, fista, with_mse) <= RESIDENT_BYTES


def resident_solve_reference(
    orig: Tensor,
    recon: Tensor,
    accs: Sequence[Tensor],
    ds: Optional[Sequence[Tensor]],
    rhos: Optional[Tensor],
    lambda_inv: Tensor,
    lam_mu: Tensor,
    *,
    n_iters: int,
    fista: bool,
    bc: int,
    ref: Optional[Tensor] = None,
    iso_r: bool = False,
    iso_q: bool = False,
):
    """The plain version of :func:`resident_solve`: ``n_iters`` calls of
    :func:`fused_iteration_reference` with momentum ``rhos[t]``, and with
    ``ref`` the SSE after each, in place; returns ``(recon, accs, ds, bn,
    dnum, dden[, sse])`` with (n_iters,) traces."""
    sums = []
    for t in range(n_iters):
        row = list(fused_iteration_reference(
            orig, recon, accs, ds, rhos[t] if fista else None, lambda_inv,
            lam_mu, fista=fista, bc=bc, iso_r=iso_r, iso_q=iso_q)[3:])
        if ref is not None:
            row.append(ops.sum_square_error(ref, recon))
        sums.append(torch.stack(row))
    return (recon, accs, ds, *torch.stack(sums).unbind(1))


def cooperative_grid(device: torch.device, ndim: int, fista: bool, iso: bool,
                     ref: bool) -> int:
    """Blocks of the full cooperative grid of the (ndim, fista, iso, ref)
    kernel on ``device``: resident blocks per SM of that instantiation
    times SMs."""
    key = (device.index if device.index is not None
           else torch.cuda.current_device(), ndim, fista, iso, ref)
    if key not in _GRID:
        lib = build.load()
        blocks = ctypes.c_int(0)
        with torch.cuda.device(key[0]):
            build.check(lib.tv_resident_max_blocks(
                ndim, int(fista), int(iso), int(ref), ctypes.byref(blocks)))
        _GRID[key] = blocks.value
    return _GRID[key]


def resident_solve(
    orig: Tensor,
    recon: Tensor,
    accs: Sequence[Tensor],
    ds: Optional[Sequence[Tensor]],
    rhos: Optional[Tensor],
    lambda_inv: Tensor,
    lam_mu: Tensor,
    *,
    n_iters: int,
    fista: bool,
    bc: int,
    ref: Optional[Tensor] = None,
    iso_r: bool = False,
    iso_q: bool = False,
    grid: Optional[int] = None,
):
    """``n_iters`` full TV iterations in one launch, updating ``recon``,
    ``accs`` and ``ds`` in place.

    ``rhos`` holds the ``n_iters`` FISTA momentum ratios, contiguous on the
    data's device (ignored when ``fista`` is false; zeros give unaccelerated
    iterations); ``lambda_inv`` and ``lam_mu`` are per-axis tensors there
    too. ``bc``: 0 periodic, 1 mirror, 2 Jia-Zhao; ``iso_r``/``iso_q``
    jointly project the (0,1)/(2,3) pairs (4D, Jia-Zhao only). ``ref``, a
    cube like ``orig``, adds the per-iteration SSE trace. ``grid`` forces
    the number of blocks (the race tests); by default the launch takes the
    full cooperative grid of its instantiation. A grid above the cooperative
    limit raises.

    Returns ``(recon, accs, ds, bn, dnum, dden[, sse])`` — the state objects
    passed in and the per-iteration sums as (n_iters,) tensors.
    ``resident_solve.launches`` counts kernel launches;
    ``resident_solve.calls`` counts every call that passed the checks, on
    the CPU too.
    """
    ndim = orig.dim()
    shape = tuple(orig.shape)
    if n_iters < 1 or not _covers(shape, orig.dtype, bc, iso_r, iso_q):
        raise ValueError(
            f"resident_solve does not cover shape {shape}, dtype "
            f"{orig.dtype}, bc {int(bc)}, iso ({iso_r}, {iso_q}), "
            f"{n_iters} iterations (float32, 3D/4D, N0 >= 2, iso 4D "
            f"Jia-Zhao only, n_iters >= 1)")
    _check_state(orig, recon, accs, ds, fista)
    if ref is not None:
        _check(ref, orig, "ref")
    if orig.device.type == "cpu":
        resident_solve.calls += 1
        return resident_solve_reference(
            orig, recon, accs, ds, rhos, lambda_inv, lam_mu, n_iters=n_iters,
            fista=fista, bc=bc, ref=ref, iso_r=iso_r, iso_q=iso_q)
    if orig.device.type != "cuda":
        raise ValueError(f"resident_solve runs on CUDA or CPU tensors, not "
                         f"{orig.device}")
    scalars = [("lambda_inv", lambda_inv, ndim), ("lam_mu", lam_mu, ndim)]
    if fista:
        scalars.append(("rhos", rhos, n_iters))
    bs, dd, dims, stream = _launch_args(orig, accs, ds if fista else None,
                                        scalars)
    work = resident_work_items(shape)
    if work >= 2**31:
        raise ValueError(f"shape {shape}: {work} work items; the kernel's "
                         "32-bit index arithmetic takes < 2**31")
    lib = build.load()
    iso = ndim == 4 and (iso_r or iso_q)
    nblocks = grid if grid is not None else cooperative_grid(
        orig.device, ndim, fista, iso, ref is not None)
    partials = torch.empty(4 * nblocks, dtype=torch.float64,
                           device=orig.device)
    traces = torch.empty(4, n_iters, dtype=orig.dtype, device=orig.device)
    err = lib.tv_resident_solve_f32(
        orig.data_ptr(), recon.data_ptr(), *bs, *dd,
        lambda_inv.data_ptr(), lam_mu.data_ptr(),
        rhos.data_ptr() if fista else None,
        ref.data_ptr() if ref is not None else None,
        partials.data_ptr(), traces.data_ptr(), ndim, *dims, int(fista),
        int(bc), int(iso_r), int(iso_q), n_iters, nblocks, stream)
    build.check(err)
    resident_solve.calls += 1
    resident_solve.launches += 1
    n_out = 4 if ref is not None else 3
    return (recon, accs, ds, *traces[:n_out].unbind())


resident_solve.launches = 0
resident_solve.calls = 0
