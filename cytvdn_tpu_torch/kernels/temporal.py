"""Two TV iterations per launch: the CUDA pair kernel and its plain
PyTorch version.

Replaces the TPU kernel ``cytvdn_tpu/kernels/temporal.py::
fused_pair_iteration`` (two iterations per Pallas pass, bit-identical to
two passes of the one-iteration kernel). The TPU kernel walks axis-1
strips outer and rows inner, and keeps iteration-1 rows in VMEM carries; on
the H100 the kernel (``csrc/temporal_pair.cu``) is one cooperative launch
that runs axis-1 strips of W indices one after another, and in each strip
walks a wavefront of row operations along axis 0 — dual-1, recon-1,
dual-2, recon-2, each a few rows behind the last and shifted a few axis-1
indices to the left (:data:`LAGS`) — with a grid-wide barrier between
stages, so the state is updated in place without races and without a
second copy (the schedule and why it is race-free are in the source's
header; :func:`pair_stages` lists the same schedule). Its element
arithmetic is that of ``csrc/fused_iteration.cu``, so the state is bitwise
equal to two K=1 launches at every strip width; the six sums are per-block
partials combined in a fixed order, within rtol 1e-5 of two K=1 launches'
sums. With a reference cube (``ref``, per-iteration MSE runs) the kernel's
``REF`` instantiation also returns each iteration's sum of squared errors
against it, read at the second reconstruction's element, where both
iterations' recon meet (the TPU kernel reduces them at the same place).

Its HBM traffic lies between two K=1 passes (5n+4 traversals per
iteration, when a stage's rows do not stay in the 50 MB L2) and the
one-pass floor (4n+3)/2 per iteration (``utils/perf.py``, ``pair_upper``
and ``pair_floor``); narrow strips keep the rows in the L2. But on the H100
the kernel is bound by its L2 requests, not by HBM: whole rows were the
fastest or within 4% at every row size swept, 2 to 16 MiB (PERF.md §6, the
strip sweep; NVIDIA H100 80GB HBM3, 700 W), so the wrapper walks whole rows
(W = N1, one strip) unless a strip is forced.

With ``halos0`` the cube is one shard of a mesh split along axis 0, and
the neighbour shards' pre-update bands (:data:`HALO0_KEYS`) stand in for
the Jia-Zhao row edges at its seams: the kernel's ``HALO0`` instantiation
recomputes the iteration-1 values the seams need from the bands, with the
neighbour's own arithmetic (``temporal.py:230-249``), so the shards of a
cube, each paired with bands cut from the pre-update state and put back
together, are bitwise one pair of the whole cube. The pair kernel's
axis-1 mode (``halos1``) and the lossy duals' ``qd1`` are not ported yet
(ROADMAP.md Queue 1 items 6 and 12).

Scope, as the TPU kernel's: float32, Jia-Zhao boundaries, anisotropic
duals, 3D and 4D, FISTA and unaccelerated, N0 ≥ 4, with or without a
reference cube and ``halos0``. :func:`fused_pair_iteration` launches the
kernel for CUDA tensors and runs :func:`fused_pair_iteration_reference`
for CPU tensors; there is no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from cytvdn_tpu_torch import ops
from cytvdn_tpu_torch.config import BCMode
from cytvdn_tpu_torch.kernels import build
from cytvdn_tpu_torch.kernels.fused import (
    _TY,
    _check,
    _check_state,
    _launch_args,
    _work_items,
    fused_iteration_reference,
)

Tensor = torch.Tensor

#: the full cooperative grid per (device, ndim, fista, ref, halo0), read
#: once from the device's occupancy (each instantiation has its own
#: registers), so the order of the partial sums depends only on the shape,
#: the mode and the device
_GRID: Dict[Tuple[int, int, bool, bool, bool], int] = {}

#: the axis-0 seam bands of a mesh shard (``cytvdn_tpu``'s ``halos0``,
#: ``temporal.py:982-988``), each a contiguous float32 tensor of rows of
#: the shard's axis-0 slab shape: ``p_*`` from the -1 shard (``p_r0`` its
#: recon rows [-2, -1], the rest its row -1), ``n_*`` from the +1 shard
#: (``n_r0`` its recon rows [0, 1], the rest its row 0, ``*_r1`` its row 1);
#: the ``_d`` bands under FISTA only. Two rows: ``p_r0``, ``n_r0``.
HALO0_KEYS = ("p_r0", "p_orig", "p_acc0", "p_acc1", "p_acc2", "p_acc3",
              "p_d0", "p_d1", "p_d2", "p_d3", "n_r0", "n_orig", "n_acc0",
              "n_acc1", "n_acc2", "n_acc3", "n_d0", "n_d1", "n_d2", "n_d3",
              "n_acc0_r1", "n_d0_r1")


def _halo0_keys(ndim: int, fista: bool):
    """The :data:`HALO0_KEYS` a (ndim, fista) pair takes."""
    kinds = ("acc", "d") if fista else ("acc",)
    keys = ["p_r0", "p_orig", "n_r0", "n_orig"]
    keys += [f"{s}_{kind}{k}" for s in "pn" for kind in kinds
             for k in range(ndim)]
    return keys + [f"n_{kind}0_r1" for kind in kinds]


def _check_halos0(halos0, orig: Tensor, fista: bool, first0: bool,
                  last0: bool) -> None:
    """Every band the pair takes, each a contiguous tensor like ``orig`` of
    one row (two for ``p_r0``, ``n_r0``); nothing else. The bands of a
    missing neighbour (``p_*`` with ``first0``, ``n_*`` with ``last0``),
    which the kernel never reads, may be left out."""
    want = set(_halo0_keys(orig.dim(), fista))
    extra = sorted(set(halos0) - want)
    if extra:
        raise ValueError(f"halos0: unexpected bands {extra}")
    for key in sorted(want):
        t = halos0.get(key)
        if t is None:
            if first0 and key.startswith("p_") or \
                    last0 and key.startswith("n_"):
                continue
            raise ValueError(f"halos0[{key!r}] is missing")
        rows = 2 if key in ("p_r0", "n_r0") else 1
        shape = (rows,) + tuple(orig.shape[1:])
        if t.device != orig.device or t.dtype != orig.dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"halos0[{key!r}]: expected a contiguous "
                             f"{orig.dtype} tensor of shape {shape} on "
                             f"{orig.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def pair_supported(shape, dtype, bc, isotropic_R=False, isotropic_Q=False,
                   with_mse=False) -> bool:
    """Whether the pair kernel covers this configuration: the JAX gate
    (``cytvdn_tpu/kernels/temporal.py::pair_supported``) without its VMEM
    block plan, which is where ``with_mse`` (one more operand) counts
    there; here the reference cube changes nothing the kernel covers."""
    if dtype != torch.float32 or len(shape) not in (3, 4) or min(shape) < 1:
        return False
    if BCMode(bc) != BCMode.JIA_ZHAO or isotropic_R or isotropic_Q:
        return False
    return shape[0] >= 4  # the TPU kernel's row pipeline depth


#: the axis-1 lag of each row operation of a stage: dual-1, recon-1,
#: dual-2, recon-2 (``csrc/temporal_pair.cu``, ``op_range``)
LAGS = (0, 1, 1, 2)


def strip_ranges(n1: int, strip: int):
    """For each strip of ``strip`` axis-1 indices out of ``n1``, the range
    ``(lo, hi)`` of each row operation: ``[jW - lag, (j+1)W - lag)``
    clipped at 0 (empty where it would end before it starts), the last
    strip's running up to ``n1``."""
    strips = -(-n1 // strip)
    out = []
    for j in range(strips):
        ranges = []
        for lag in LAGS:
            lo = max(0, j * strip - lag)
            hi = n1 if j == strips - 1 else max(lo, (j + 1) * strip - lag)
            ranges.append((lo, hi))
        out.append(ranges)
    return out


def pair_stages(shape, strip: int):
    """The kernel's schedule for ``shape`` at strip width ``strip``: yields
    ``(stage, op, row, lo, hi)`` for every row operation that has work, in
    launch order. ``op`` 0..3 is dual-1, recon-1, dual-2, recon-2; stages
    count on across strips (N0 + 5 per strip), with a grid barrier after
    each; ``[lo, hi)`` is the op's axis-1 range. Within a stage the ops
    touch disjoint rows, so they may run in any order."""
    n0 = shape[0]
    per_strip = n0 + 5
    for j, ranges in enumerate(strip_ranges(shape[1], strip)):
        for st in range(per_strip):
            for op, (lo, hi) in enumerate(ranges):
                row = st - 3 * (op // 2) - 2 * (op % 2)
                if 0 <= row < n0 and lo < hi:
                    yield j * per_strip + st, op, row, lo, hi


def _stage_work(shape, strip: int) -> int:
    """The most work items one stage of the kernel has: four row
    operations, each over its axis-1 range times the tiles of the other
    in-row axes (in 3D, tiles of axis 1 itself)."""
    if len(shape) == 4:
        per1 = _work_items((1, 1) + tuple(shape[2:]))
        return max(sum(hi - lo for lo, hi in r) for r in
                   strip_ranges(shape[1], strip)) * per1
    per1 = _work_items((1, 1, shape[2]))
    return max(sum(-(-(hi - lo) // _TY) for lo, hi in r) for r in
               strip_ranges(shape[1], strip)) * per1


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
    ref: Optional[Tensor] = None,
    halos0: Optional[Dict[str, Tensor]] = None,
    first0=None,
    last0=None,
):
    """The plain version of :func:`fused_pair_iteration`: two Jia-Zhao
    iterations of :func:`fused_iteration_reference`, in place, returning
    ``(recon, accs, ds, bnorm1, dnum1, dden1, bnorm2, dnum2, dden2)`` and,
    with ``ref``, ``(sse1, sse2)``: ``ops.sum_square_error`` after each
    iteration. With ``halos0`` each iteration takes the axis-0 K=1 halos
    that the bands give (:func:`_pair_seams`)."""
    if halos0 is not None:
        _check_halos0(halos0, orig, fista, _edge_flag(first0),
                      _edge_flag(last0))
        halos = _pair_seams(orig, recon, accs, ds, rho1, lambda_inv,
                            lam_mu, fista, halos0, first0, last0)
    else:
        halos = (None, None)
    sums, sse = [], []
    for rho, seams in zip((rho1, rho2), halos):
        h = seams(recon) if seams is not None else None
        sums += fused_iteration_reference(
            orig, recon, accs, ds, rho, lambda_inv, lam_mu, fista=fista,
            bc=BCMode.JIA_ZHAO, halos=h)[3:]
        if ref is not None:
            sse.append(ops.sum_square_error(recon, ref))
    return (recon, accs, ds, *sums, *sse)


def halo0_bands(orig: Tensor, recon: Tensor, accs: Sequence[Tensor],
                ds: Optional[Sequence[Tensor]], a0: int, a1: int):
    """The bands of the slab of rows [a0, a1) of a whole-cube state, cut
    from it as an axis-0 mesh's neighbours would send them: returns
    ``(halos0, first0, last0)``, zeros in place of a missing neighbour's
    bands. A slab paired with them is bitwise rows [a0, a1) of one pair of
    the whole cube."""
    n0, nd = orig.shape[0], orig.dim()
    first0, last0 = a0 == 0, a1 == n0

    def rows(x, i, j):
        if first0 and i < 0 or last0 and j > 0:
            return torch.zeros_like(x[:j - i])
        return x[a0 + i:a0 + j].contiguous() if i < 0 else \
            x[a1 + i:a1 + j].contiguous()

    h = {"p_r0": rows(recon, -2, 0), "p_orig": rows(orig, -1, 0),
         "n_r0": rows(recon, 0, 2), "n_orig": rows(orig, 0, 1),
         "n_acc0_r1": rows(accs[0], 1, 2)}
    for k in range(nd):
        h[f"p_acc{k}"] = rows(accs[k], -1, 0)
        h[f"n_acc{k}"] = rows(accs[k], 0, 1)
        if ds is not None:
            h[f"p_d{k}"] = rows(ds[k], -1, 0)
            h[f"n_d{k}"] = rows(ds[k], 0, 1)
    if ds is not None:
        h["n_d0_r1"] = rows(ds[0], 1, 2)
    return {k: v.clone() for k, v in h.items()}, first0, last0


def _edge_flag(flag) -> bool:
    if flag is None:
        raise ValueError("halos0 needs first0 and last0")
    return bool(float(flag))


def _pair_seams(orig, recon, accs, ds, rho1, lambda_inv, lam_mu, fista,
                halos0, first0, last0):
    """The K=1 halos of the pair's two iterations from the bands, as two
    functions of the current recon: iteration 1's from the bands
    themselves; iteration 2's from the neighbours' band rows advanced one
    iteration with :func:`fused_iteration_reference` on one-row cubes (the
    -1 shard's row -1 against this shard's row 0, the +1 shard's row 0
    against this shard's last row and its own row 1), before this shard's
    state changes. The axis-1 halos are the Jia-Zhao edge values."""
    first0, last0 = _edge_flag(first0), _edge_flag(last0)
    nd = orig.dim()
    h = halos0

    def row1(x, i=0):
        return x[i:i + 1].clone()

    def k1_halos(cube_recon, prev0, nxt):
        """Axis 0 from ``prev0`` and ``nxt`` (recon, acc, d); axis 1 the
        Jia-Zhao edges of ``cube_recon``."""
        zcol = torch.zeros_like(cube_recon[:, :1])
        out = {"prev0": prev0, "next0_recon": nxt[0], "next0_acc": nxt[1],
               "prev1": cube_recon[:, :1].contiguous(),
               "next1_recon": cube_recon[:, -1:].contiguous(),
               "next1_acc": zcol}
        if fista:
            out["next0_d"] = nxt[2]
            out["next1_d"] = zcol
        return out

    def edge_next(cube_recon):
        z = torch.zeros_like(cube_recon[-1:])
        return (cube_recon[-1:].clone(), z, z)

    def advance(o, r, a, d, prev0, nxt):
        """One iteration of a one-row cube in place."""
        fused_iteration_reference(
            o, r, a, d, rho1, lambda_inv, lam_mu, fista=fista,
            bc=BCMode.JIA_ZHAO, halos=k1_halos(r, prev0, nxt))

    prev_r1 = nxt1 = None
    if not first0:
        # the -1 shard's row -1 after iteration 1
        prev_r1 = row1(h["p_r0"], 1)
        advance(h["p_orig"], prev_r1,
                [h[f"p_acc{k}"].clone() for k in range(nd)],
                [h[f"p_d{k}"].clone() for k in range(nd)] if fista else None,
                row1(h["p_r0"], 0),
                (row1(recon), row1(accs[0]),
                 row1(ds[0]) if fista else None))
    if not last0:
        # the +1 shard's row 0 after iteration 1
        r = row1(h["n_r0"], 0)
        a = [h[f"n_acc{k}"].clone() for k in range(nd)]
        d = [h[f"n_d{k}"].clone() for k in range(nd)] if fista else None
        advance(h["n_orig"], r, a, d, recon[-1:].clone(),
                (row1(h["n_r0"], 1), h["n_acc0_r1"],
                 h["n_d0_r1"] if fista else None))
        nxt1 = (r, a[0], d[0] if fista else None)

    def seams1(cube_recon):
        prev0 = cube_recon[:1].clone() if first0 else h["p_r0"][1:2]
        nxt = edge_next(cube_recon) if last0 else \
            (h["n_r0"][:1], h["n_acc0"], h["n_d0"] if fista else None)
        return k1_halos(cube_recon, prev0, nxt)

    def seams2(cube_recon):
        prev0 = cube_recon[:1].clone() if first0 else prev_r1
        nxt = edge_next(cube_recon) if last0 else nxt1
        return k1_halos(cube_recon, prev0, nxt)

    return seams1, seams2


def cooperative_grid(device: torch.device, ndim: int, fista: bool,
                     ref: bool = False, halo0: bool = False) -> int:
    """Blocks of the full cooperative grid of the (ndim, fista, ref, halo0)
    kernel on ``device``: resident blocks per SM times SMs."""
    key = (device.index if device.index is not None
           else torch.cuda.current_device(), ndim, fista, ref, halo0)
    if key not in _GRID:
        lib = build.load()
        blocks = ctypes.c_int(0)
        with torch.cuda.device(key[0]):
            build.check(lib.tv_pair_max_blocks(ndim, int(fista), int(ref),
                                               int(halo0),
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
    strip: Optional[int] = None,
    ref: Optional[Tensor] = None,
    halos0: Optional[Dict[str, Tensor]] = None,
    first0=None,
    last0=None,
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
    limit raises. ``strip`` forces the strip width W along axis 1 (the race
    tests and the sweep); by default, and at W ≥ N1, the launch walks whole
    rows. Neither changes the state. ``ref``, a reference cube like
    ``orig``, runs the kernel's ``REF`` instantiation. ``halos0``, a dict
    of :data:`HALO0_KEYS` bands (a missing neighbour's may be left out),
    with ``first0``/``last0`` (true on the shards that hold the cube's
    first and last rows), runs its ``HALO0`` instantiation: the cube is a
    shard of an axis-0 mesh.

    Returns ``(recon, accs, ds, bnorm1, dnum1, dden1, bnorm2, dnum2,
    dden2)`` — the state objects passed in and both iterations' sums as 0-d
    tensors — and, with ``ref``, ``(sse1, sse2)``, the sum of squared
    errors of each iteration's recon against ``ref``.
    ``fused_pair_iteration.launches`` counts kernel launches,
    ``fused_pair_iteration.halo0_launches`` those of them with ``halos0``;
    ``fused_pair_iteration.calls`` counts every call that passed the checks,
    on the CPU too.
    """
    ndim = orig.dim()
    if not pair_supported(tuple(orig.shape), orig.dtype, BCMode.JIA_ZHAO):
        raise ValueError(
            f"fused_pair_iteration does not cover shape {tuple(orig.shape)}, "
            f"dtype {orig.dtype} (float32, 3D/4D, N0 >= 4)")
    _check_state(orig, recon, accs, ds, fista)
    if ref is not None:
        _check(ref, orig, "ref")
    if halos0 is not None:
        flags = (_edge_flag(first0), _edge_flag(last0))
        _check_halos0(halos0, orig, fista, *flags)
    if strip is not None and int(strip) < 1:
        raise ValueError(f"strip must be >= 1, got {strip}")
    strip = orig.shape[1] if strip is None else min(int(strip), orig.shape[1])
    if orig.device.type == "cpu":
        fused_pair_iteration.calls += 1
        return fused_pair_iteration_reference(
            orig, recon, accs, ds, rho1, rho2, lambda_inv, lam_mu, fista=fista,
            ref=ref, halos0=halos0, first0=first0, last0=last0)
    if orig.device.type != "cuda":
        raise ValueError(f"fused_pair_iteration runs on CUDA or CPU tensors, "
                         f"not {orig.device}")
    scalars = [("lambda_inv", lambda_inv, ndim), ("lam_mu", lam_mu, ndim)]
    if fista:
        scalars += [("rho1", rho1, 1), ("rho2", rho2, 1)]
    bs, dd, dims, stream = _launch_args(orig, accs, ds if fista else None,
                                        scalars)
    work = _stage_work(tuple(orig.shape), strip)
    if work >= 2**31:
        raise ValueError(f"shape {tuple(orig.shape)}: {work} work items per "
                         "stage; the kernel's 32-bit index arithmetic takes "
                         "< 2**31")
    lib = build.load()
    nblocks = grid if grid is not None else cooperative_grid(
        orig.device, ndim, fista, ref is not None, halos0 is not None)
    n_out = 6 if ref is None else 8
    partials = torch.empty(n_out * nblocks, dtype=torch.float64,
                           device=orig.device)
    out = torch.empty(n_out, dtype=orig.dtype, device=orig.device)
    table, first, last = None, 0, 0
    if halos0 is not None:
        first, last = (int(f) for f in flags)
        # the +1 shard's recomputed row-0 b_0 (and d_0) at level 1, left by
        # recon-1 for recon-2 at the last row; read only with a +1 shard
        stash = None if last else torch.empty(
            (2,) + tuple(orig.shape[1:]), dtype=orig.dtype,
            device=orig.device)
        ptrs = [halos0[k].data_ptr() if halos0.get(k) is not None else None
                for k in HALO0_KEYS]
        ptrs.append(stash.data_ptr() if stash is not None else None)
        table = (ctypes.c_void_p * len(ptrs))(*ptrs)
    err = lib.tv_pair_iteration_f32(
        orig.data_ptr(), recon.data_ptr(), *bs, *dd,
        lambda_inv.data_ptr(), lam_mu.data_ptr(),
        rho1.data_ptr() if fista else None, rho2.data_ptr() if fista else None,
        ref.data_ptr() if ref is not None else None,
        partials.data_ptr(), out.data_ptr(), table, first, last, ndim, *dims,
        strip, int(fista), nblocks, stream)
    build.check(err)
    fused_pair_iteration.calls += 1
    fused_pair_iteration.launches += 1
    fused_pair_iteration.halo0_launches += halos0 is not None
    return (recon, accs, ds, *out.unbind())


fused_pair_iteration.launches = 0
fused_pair_iteration.halo0_launches = 0
fused_pair_iteration.calls = 0
