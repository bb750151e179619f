"""One whole TV iteration: the CUDA kernel and its plain PyTorch version.

Replaces the TPU kernel ``cytvdn_tpu/kernels/fused.py::fused_iteration``
(one Pallas pass per iteration). On the H100 the iteration is bound by HBM
bytes: a few flops per element against the state's reads and writes. The
kernel (``csrc/fused_iteration.cu``) updates the state in place in two
launches — a dual pass that writes every axis's ``b`` and ``d`` and reads
only the old ``recon``, then a reconstruction pass that reads the new ``b``
and rewrites ``recon`` element by element — because concurrent blocks
updating one pass in place would race on tile faces and a second copy of
the state does not fit (10 × 4.29 GB for the 256²×128² FISTA cube). That
costs 5n+4 cube traversals per FISTA iteration against the one-pass floor
of 4n+3 (``utils/perf.py``); fusing the passes is later work. The three
sums are per-block partials combined in a fixed order on the device, so
traces repeat exactly from run to run.

:func:`fused_iteration` launches the kernel for CUDA tensors and runs
:func:`fused_iteration_reference` — built from ``ops/stencil.py`` in the
order the JAX engine uses — for CPU tensors. There is no fallback: a CUDA
tensor reaches the kernel or an exception.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from cytvdn_tpu_torch import ops
from cytvdn_tpu_torch.config import BCMode
from cytvdn_tpu_torch.kernels import build

Tensor = torch.Tensor

#: grid size cap of both passes (blocks of 32×8 threads stride over the
#: cube's (row, tile) work items); fixed, so the order of the per-block
#: partial sums depends on the shape alone
MAX_BLOCKS = 2048
_TX, _TY = 32, 8


def fused_supported(shape, dtype, bc, isotropic_R=False, isotropic_Q=False) -> bool:
    """Whether the kernel covers this configuration."""
    if dtype not in (torch.float32, torch.float64):
        return False
    if len(shape) not in (3, 4) or min(shape) < 1:
        return False
    if BCMode(bc) == BCMode.MIRROR and min(shape) < 2:
        return False  # the mirror's backward edge reads a_1
    if isotropic_R or isotropic_Q:
        # half-isotropic pairs: 4D, Jia-Zhao only (reference
        # halfisotropic.pyx:70-82)
        if len(shape) != 4 or BCMode(bc) != BCMode.JIA_ZHAO:
            return False
    return True


def _work_items(shape: Tuple[int, ...]) -> int:
    """(row, tile) work items: the leading axes flattened into rows, times
    the 8×32 tiles of the two trailing axes."""
    rows = 1
    for n in shape[:-2]:
        rows *= n
    return rows * (-(-shape[-2] // _TY)) * (-(-shape[-1] // _TX))


def fused_iteration_reference(
    orig: Tensor,
    recon: Tensor,
    accs: Sequence[Tensor],
    ds: Optional[Sequence[Tensor]],
    rho: Optional[Tensor],
    lambda_inv: Tensor,
    lam_mu: Tensor,
    *,
    fista: bool,
    bc: int = 2,
    iso_r: bool = False,
    iso_q: bool = False,
):
    """The plain version of :func:`fused_iteration`, on any device.

    Per-axis dual updates in the JAX engine's order
    (``cytvdn_tpu/solver/engine.py::_accumulator_phase``), then the
    reconstruction update. Each axis's new ``b``/``d`` is copied into the
    caller's tensors as soon as it is computed (it reads only ``recon`` and
    its own axis), and ``recon`` after the reconstruction update: the same
    in-place contract as the kernel.
    """
    bc = BCMode(bc)
    ndim = orig.dim()
    bnorm = torch.zeros((), dtype=orig.dtype, device=orig.device)

    def aniso(ax):
        if fista:
            b, d, n = ops.accumulator_update_fista(
                recon, accs[ax], ds[ax], rho, ax, lambda_inv[ax], bc)
            ds[ax].copy_(d)
        else:
            b, n = ops.accumulator_update(recon, accs[ax], ax, lambda_inv[ax], bc)
        accs[ax].copy_(b)
        return n

    def iso(ax1, ax2):
        # the pair shares one clip radius (reference cyTVDN.py:160-162)
        if fista:
            b1, b2, d1, d2, n = ops.iso_accumulator_update_fista(
                recon, accs[ax1], accs[ax2], ds[ax1], ds[ax2], rho,
                ax1, ax2, lambda_inv[ax1])
            ds[ax1].copy_(d1)
            ds[ax2].copy_(d2)
        else:
            b1, b2, n = ops.iso_accumulator_update(
                recon, accs[ax1], accs[ax2], ax1, ax2, lambda_inv[ax1])
        accs[ax1].copy_(b1)
        accs[ax2].copy_(b2)
        return n

    if ndim == 4:
        norms = [iso(0, 1)] if iso_r else [aniso(0), aniso(1)]
        norms += [iso(2, 3)] if iso_q else [aniso(2), aniso(3)]
    else:
        norms = [aniso(ax) for ax in range(3)]
    for n in norms:
        bnorm = bnorm + n
    recon_new, dnum, dden = ops.datacube_update(orig, recon, accs, lam_mu, bc)
    recon.copy_(recon_new)
    return recon, accs, ds, bnorm, dnum, dden


def _check(t: Tensor, like: Tensor, name: str) -> None:
    if t.device != like.device or t.dtype != like.dtype:
        raise ValueError(f"{name}: expected {like.dtype} on {like.device}, "
                         f"got {t.dtype} on {t.device}")
    if t.shape != like.shape:
        raise ValueError(f"{name}: expected shape {tuple(like.shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_state(orig: Tensor, recon: Tensor, accs, ds, fista: bool) -> None:
    """The state a kernel updates in place: one accumulator (and one shadow
    dual under FISTA) per axis, each like ``orig``."""
    ndim = orig.dim()
    if len(accs) != ndim or (fista and (ds is None or len(ds) != ndim)):
        raise ValueError("need one accumulator (and one shadow dual under "
                         "FISTA) per axis")
    _check(orig, orig, "orig")
    _check(recon, orig, "recon")
    for k in range(ndim):
        _check(accs[k], orig, f"accs[{k}]")
        if fista:
            # a bfloat16 d (lossy duals, ROADMAP.md Queue 1 item 7) fails here
            _check(ds[k], orig, f"ds[{k}]")


def _launch_args(orig: Tensor, accs, ds, scalars):
    """Checks a CUDA launch's scalars (``(name, tensor, count)``: contiguous,
    of the data's dtype, on its device) and returns the per-axis state
    pointers padded to four axes (``ds`` None: no shadow duals), the
    extents padded with 1 and the current stream."""
    for name, t, n in scalars:
        if t is None or t.device != orig.device or t.dtype != orig.dtype \
                or t.numel() != n or not t.is_contiguous():
            raise ValueError(f"{name}: expected {n} contiguous {orig.dtype} "
                             f"value(s) on {orig.device}")

    def pad4(xs):
        return list(xs) + [None] * (4 - len(xs))

    bs = pad4([a.data_ptr() for a in accs])
    dd = pad4([d.data_ptr() for d in ds] if ds is not None else [])
    dims = list(orig.shape) + [1] * (4 - orig.dim())
    return bs, dd, dims, torch.cuda.current_stream(orig.device).cuda_stream


def fused_iteration(
    orig: Tensor,
    recon: Tensor,
    accs: Sequence[Tensor],
    ds: Optional[Sequence[Tensor]],
    rho: Optional[Tensor],
    lambda_inv: Tensor,
    lam_mu: Tensor,
    *,
    fista: bool,
    bc: int = 2,
    iso_r: bool = False,
    iso_q: bool = False,
    halos=None,
):
    """One full TV iteration, updating ``recon``, ``accs`` and ``ds`` in
    place.

    ``rho`` is the FISTA momentum ratio as a 0-d tensor on the data's
    device (ignored when ``fista`` is false); ``lambda_inv`` and ``lam_mu``
    are per-axis tensors there too. ``bc``: 0 periodic, 1 mirror,
    2 Jia-Zhao; ``iso_r``/``iso_q`` jointly project the (0,1)/(2,3) pairs
    (4D, Jia-Zhao only).

    Returns ``(recon, accs, ds, bnorm, delta_num, recon_norm)`` — the state
    objects passed in, and the three sums as 0-d tensors of the data type.
    ``fused_iteration.launches`` counts the kernel launches;
    ``fused_iteration.calls`` counts every call that passed the checks, on
    the CPU too.
    """
    if halos is not None:
        raise NotImplementedError(
            "operand halos (sharded and out-of-core runs) are not ported "
            "yet (ROADMAP.md Queue 1 item 10)")
    ndim = orig.dim()
    if not fused_supported(tuple(orig.shape), orig.dtype, bc, iso_r, iso_q):
        raise ValueError(
            f"fused_iteration does not cover shape {tuple(orig.shape)}, "
            f"dtype {orig.dtype}, bc {int(bc)}, iso ({iso_r}, {iso_q})")
    _check_state(orig, recon, accs, ds, fista)
    if orig.device.type == "cpu":
        fused_iteration.calls += 1
        return fused_iteration_reference(
            orig, recon, accs, ds, rho, lambda_inv, lam_mu,
            fista=fista, bc=bc, iso_r=iso_r, iso_q=iso_q)
    if orig.device.type != "cuda":
        raise ValueError(f"fused_iteration runs on CUDA or CPU tensors, "
                         f"not {orig.device}")
    scalars = [("lambda_inv", lambda_inv, ndim), ("lam_mu", lam_mu, ndim)]
    if fista:
        scalars.append(("rho", rho, 1))
    bs, dd, dims, stream = _launch_args(orig, accs, ds if fista else None,
                                        scalars)
    lib = build.load()
    fn = (lib.tv_fused_iteration_f32 if orig.dtype == torch.float32
          else lib.tv_fused_iteration_f64)
    work = _work_items(tuple(orig.shape))
    if work >= 2**31:
        raise ValueError(f"shape {tuple(orig.shape)}: {work} work items; the "
                         "kernel's 32-bit index arithmetic takes < 2**31")
    nblocks = min(work, MAX_BLOCKS)
    partials = torch.empty(3 * nblocks, dtype=torch.float64, device=orig.device)
    out = torch.empty(3, dtype=orig.dtype, device=orig.device)
    err = fn(orig.data_ptr(), recon.data_ptr(), *bs, *dd,
             lambda_inv.data_ptr(), lam_mu.data_ptr(),
             rho.data_ptr() if fista else None,
             partials.data_ptr(), out.data_ptr(), ndim, *dims,
             int(fista), int(bc), int(iso_r), int(iso_q), nblocks, stream)
    build.check(err)
    fused_iteration.calls += 1
    fused_iteration.launches += 1
    return recon, accs, ds, out[0], out[1], out[2]


fused_iteration.launches = 0
fused_iteration.calls = 0
