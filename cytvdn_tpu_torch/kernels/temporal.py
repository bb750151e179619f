"""Two TV iterations per launch: the CUDA pair kernel and its plain
PyTorch version.

Replaces the TPU kernel ``cytvdn_tpu/kernels/temporal.py::
fused_pair_iteration`` (two iterations per Pallas pass, bit-identical to
two passes of the one-iteration kernel). The TPU kernel keeps iteration-1
rows in VMEM carries; on the H100 the kernel (``csrc/temporal_pair.cu``)
is one cooperative launch that walks a wavefront of row operations along
axis 0 — dual-1, recon-1, dual-2, recon-2, each a few rows behind the
last — with a grid-wide barrier between stages, so the state is updated in
place without races and without a second copy (the schedule and why it is
race-free are in the source's header). Its element arithmetic is that of
``csrc/fused_iteration.cu``, so the state is bitwise equal to two K=1
launches; the six sums are per-block partials combined in a fixed order,
within rtol 1e-5 of two K=1 launches' sums.

What bounds it is HBM bytes: between two K=1 passes (5n+4 traversals per
iteration, when a stage's rows do not stay in the 50 MB L2) and the
one-pass floor (4n+3)/2 per iteration (``utils/perf.py``, ``pair_upper``
and ``pair_floor``).

Scope, as the TPU kernel's on one device without reference data: float32,
Jia-Zhao boundaries, anisotropic duals, 3D and 4D, FISTA and unaccelerated,
N0 ≥ 4. :func:`fused_pair_iteration` launches the kernel for CUDA tensors
and runs :func:`fused_pair_iteration_reference` for CPU tensors; there is
no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from cytvdn_tpu_torch.config import BCMode
from cytvdn_tpu_torch.kernels import build
from cytvdn_tpu_torch.kernels.fused import (
    _check,
    _work_items,
    fused_iteration_reference,
)

Tensor = torch.Tensor

#: the full cooperative grid per (device, ndim, fista), read once from the
#: device's occupancy, so the order of the partial sums depends only on the
#: shape and the device
_GRID: Dict[Tuple[int, int, bool], int] = {}


def pair_supported(shape, dtype, bc, isotropic_R=False, isotropic_Q=False) -> bool:
    """Whether the pair kernel covers this configuration: the JAX gate
    (``cytvdn_tpu/kernels/temporal.py::pair_supported``) without its VMEM
    block plan."""
    if dtype != torch.float32 or len(shape) not in (3, 4) or min(shape) < 1:
        return False
    if BCMode(bc) != BCMode.JIA_ZHAO or isotropic_R or isotropic_Q:
        return False
    return shape[0] >= 4  # the TPU kernel's row pipeline depth


def fused_pair_iteration_reference(
    orig: Tensor,
    recon: Tensor,
    accs: Sequence[Tensor],
    ds: Optional[Sequence[Tensor]],
    rho1: Optional[Tensor],
    rho2: Optional[Tensor],
    lambda_inv: Tensor,
    lam_mu: Tensor,
    *,
    fista: bool,
):
    """The plain version of :func:`fused_pair_iteration`: two Jia-Zhao
    iterations of :func:`fused_iteration_reference`, in place, returning
    ``(recon, accs, ds, bnorm1, dnum1, dden1, bnorm2, dnum2, dden2)``."""
    sums = []
    for rho in (rho1, rho2):
        sums += fused_iteration_reference(
            orig, recon, accs, ds, rho, lambda_inv, lam_mu, fista=fista,
            bc=BCMode.JIA_ZHAO)[3:]
    return (recon, accs, ds, *sums)


def cooperative_grid(device: torch.device, ndim: int, fista: bool) -> int:
    """Blocks of the full cooperative grid of the (ndim, fista) kernel on
    ``device``: resident blocks per SM times SMs."""
    key = (device.index if device.index is not None
           else torch.cuda.current_device(), ndim, fista)
    if key not in _GRID:
        lib = build.load()
        blocks = ctypes.c_int(0)
        with torch.cuda.device(key[0]):
            build.check(lib.tv_pair_max_blocks(ndim, int(fista),
                                               ctypes.byref(blocks)))
        _GRID[key] = blocks.value
    return _GRID[key]


def fused_pair_iteration(
    orig: Tensor,
    recon: Tensor,
    accs: Sequence[Tensor],
    ds: Optional[Sequence[Tensor]],
    rho1: Optional[Tensor],
    rho2: Optional[Tensor],
    lambda_inv: Tensor,
    lam_mu: Tensor,
    *,
    fista: bool,
    grid: Optional[int] = None,
):
    """Two full Jia-Zhao TV iterations, updating ``recon``, ``accs`` and
    ``ds`` in place.

    ``rho1``/``rho2`` are the FISTA momentum ratios of the pair's two
    iterations as 0-d tensors on the data's device (ignored when ``fista``
    is false); ``lambda_inv`` and ``lam_mu`` are per-axis tensors there too.
    The state must keep each accumulator's leading slab along its own axis
    at zero, as every Jia-Zhao run does (the kernel's axis-0 wrap reads it).
    ``grid`` forces the number of blocks (the race tests); by default the
    launch takes the full cooperative grid. A grid above the cooperative
    limit raises.

    Returns ``(recon, accs, ds, bnorm1, dnum1, dden1, bnorm2, dnum2,
    dden2)`` — the state objects passed in and both iterations' sums as 0-d
    tensors. ``fused_pair_iteration.launches`` counts kernel launches;
    ``fused_pair_iteration.calls`` counts every call that passed the checks,
    on the CPU too.
    """
    ndim = orig.dim()
    if not pair_supported(tuple(orig.shape), orig.dtype, BCMode.JIA_ZHAO):
        raise ValueError(
            f"fused_pair_iteration does not cover shape {tuple(orig.shape)}, "
            f"dtype {orig.dtype} (float32, 3D/4D, N0 >= 4)")
    if len(accs) != ndim or (fista and (ds is None or len(ds) != ndim)):
        raise ValueError("need one accumulator (and one shadow dual under "
                         "FISTA) per axis")
    _check(orig, orig, "orig")
    _check(recon, orig, "recon")
    for k in range(ndim):
        _check(accs[k], orig, f"accs[{k}]")
        if fista:
            _check(ds[k], orig, f"ds[{k}]")
    if orig.device.type == "cpu":
        fused_pair_iteration.calls += 1
        return fused_pair_iteration_reference(
            orig, recon, accs, ds, rho1, rho2, lambda_inv, lam_mu, fista=fista)
    if orig.device.type != "cuda":
        raise ValueError(f"fused_pair_iteration runs on CUDA or CPU tensors, "
                         f"not {orig.device}")
    scalars = [("lambda_inv", lambda_inv, ndim), ("lam_mu", lam_mu, ndim)]
    if fista:
        scalars += [("rho1", rho1, 1), ("rho2", rho2, 1)]
    for name, t, n in scalars:
        if t is None or t.device != orig.device or t.dtype != orig.dtype \
                or t.numel() != n or not t.is_contiguous():
            raise ValueError(f"{name}: expected {n} contiguous {orig.dtype} "
                             f"value(s) on {orig.device}")
    # a stage's work items: four row operations of one axis-0 slab each
    work = 4 * _work_items(tuple(orig.shape)) // orig.shape[0]
    if work >= 2**31:
        raise ValueError(f"shape {tuple(orig.shape)}: {work} work items per "
                         "stage; the kernel's 32-bit index arithmetic takes "
                         "< 2**31")
    lib = build.load()
    nblocks = grid if grid is not None else cooperative_grid(
        orig.device, ndim, fista)
    partials = torch.empty(6 * nblocks, dtype=torch.float64, device=orig.device)
    out = torch.empty(6, dtype=orig.dtype, device=orig.device)

    def pad4(xs):
        return list(xs) + [None] * (4 - len(xs))

    bs = pad4([a.data_ptr() for a in accs])
    dd = pad4([d.data_ptr() for d in ds] if fista else [])
    dims = list(orig.shape) + [1] * (4 - ndim)
    stream = torch.cuda.current_stream(orig.device).cuda_stream
    err = lib.tv_pair_iteration_f32(
        orig.data_ptr(), recon.data_ptr(), *bs, *dd,
        lambda_inv.data_ptr(), lam_mu.data_ptr(),
        rho1.data_ptr() if fista else None, rho2.data_ptr() if fista else None,
        partials.data_ptr(), out.data_ptr(), ndim, *dims, int(fista), nblocks,
        stream)
    build.check(err)
    fused_pair_iteration.calls += 1
    fused_pair_iteration.launches += 1
    return (recon, accs, ds, *out.unbind())


fused_pair_iteration.launches = 0
fused_pair_iteration.calls = 0
