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
together, are bitwise one pair of the whole cube. With ``halos1`` the
cube is one shard of a mesh split along axis 1, and the neighbour shards'
pre-update column slabs (:data:`HALO1_KEYS`) stand in for the Jia-Zhao
column edges: the kernel's ``HALO1`` instantiation recomputes, per row,
the -1 shard's last-column recon and the +1 shard's first-column ``b_1``
after iteration 1 from them (``temporal.py:321-334, :649-688, :816-869``),
and keeps the latter in a two-column-slab stash between the pair's two
reconstructions. A launch takes one halo mode or none, as the TPU kernel
does (``temporal.py:995``).

Lossy duals (``lossy_duals``): under FISTA ``ds`` may be bfloat16. The
kernel's ``LOSSY`` instantiations round iteration 1's ``d`` onto the
bfloat16 grid in the middle of the pair, as the TPU kernel's ``qd1`` does
(``temporal.py:414-424, :474-482, :621-625``): dual-1 stores it as
bfloat16 and dual-2 reads it back, and the +1 shard's recomputed row-0
``d`` of a ``halos0`` launch goes through ``round_bf16`` in CUDA. So a
lossy pair is bitwise two lossy K=1 launches, d included.
:func:`round_bf16` is that rounding in PyTorch.

Scope, as the TPU kernel's: float32, Jia-Zhao boundaries, anisotropic
duals, 3D and 4D, FISTA and unaccelerated, N0 ≥ 4, with or without a
reference cube, ``halos0`` or ``halos1`` (N1 ≥ 2), bfloat16 ``ds`` under
FISTA. :func:`fused_pair_iteration` launches the
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


def round_bf16(v: Tensor) -> Tensor:
    """Round-to-nearest-even onto the bfloat16 grid, staying float32: the
    lossy duals' per-iteration rounding (``cytvdn_tpu``'s ``round_bf16``,
    ``temporal.py:83-100``), bit for bit what storing ``d`` as bfloat16 and
    widening it again gives.

    Integer bit arithmetic on the float's bits, in int64 so that no add
    overflows: ``(u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000``. It is RNE
    for every finite value, denormals and the carry to infinity included,
    and no compiler can fold it away as excess precision, as it may a
    ``.to(bfloat16).to(float32)`` round trip inside one fused
    computation."""
    if v.dtype != torch.float32:
        raise ValueError(f"round_bf16 takes float32, got {v.dtype}")
    u = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    # back to int32's range before the cast: bit 31 is the sign
    r = r - ((r >> 31) << 32)
    return r.to(torch.int32).view(torch.float32).view(v.shape)


#: the full cooperative grid per (device, ndim, fista, ref, halo, lossy),
#: read once from the device's occupancy (each instantiation has its own
#: registers), so the order of the partial sums depends only on the shape,
#: the mode and the device; ``halo`` is the kernel's halo mode
#: (:data:`NO_HALO`, :data:`HALO_AXIS0`, :data:`HALO_AXIS1`)
_GRID: Dict[Tuple[int, int, bool, bool, int, bool], int] = {}

#: the kernel's halo modes (``csrc/temporal_pair.cu``): no bands, axis-0
#: bands (``halos0``), axis-1 bands (``halos1``)
NO_HALO, HALO_AXIS0, HALO_AXIS1 = 0, 1, 2

#: the axis-0 seam bands of a mesh shard (``cytvdn_tpu``'s ``halos0``,
#: ``temporal.py:982-988``), each a contiguous float32 tensor of rows of
#: the shard's axis-0 slab shape: ``p_*`` from the -1 shard (``p_r0`` its
#: recon rows [-2, -1], the rest its row -1), ``n_*`` from the +1 shard
#: (``n_r0`` its recon rows [0, 1], the rest its row 0, ``*_r1`` its row 1);
#: the ``_d`` bands under FISTA only, float32 also under lossy duals (the
#: neighbour's bfloat16 rows widened exactly). Two rows: ``p_r0``, ``n_r0``.
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


def _check_bands(name: str, bands, want, orig: Tensor, first: bool,
                 last: bool) -> None:
    """The bands ``want`` (``{key: shape}``) and nothing else, each a
    contiguous tensor of ``orig``'s dtype and device. The bands of a
    missing neighbour (``p_*`` with ``first``, ``n_*`` with ``last``),
    which the kernel never reads, may be left out."""
    extra = sorted(set(bands) - set(want))
    if extra:
        raise ValueError(f"{name}: unexpected bands {extra}")
    for key, shape in sorted(want.items()):
        t = bands.get(key)
        if t is None:
            if first and key.startswith("p_") or \
                    last and key.startswith("n_"):
                continue
            raise ValueError(f"{name}[{key!r}] is missing")
        if t.device != orig.device or t.dtype != orig.dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}[{key!r}]: expected a contiguous "
                             f"{orig.dtype} tensor of shape {shape} on "
                             f"{orig.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _check_halos0(halos0, orig: Tensor, fista: bool, first0: bool,
                  last0: bool) -> None:
    """Every band the pair takes, each a contiguous tensor like ``orig`` of
    one row (two for ``p_r0``, ``n_r0``); nothing else; a missing
    neighbour's may be left out."""
    tail = tuple(orig.shape[1:])
    want = {k: (2 if k in ("p_r0", "n_r0") else 1,) + tail
            for k in _halo0_keys(orig.dim(), fista)}
    _check_bands("halos0", halos0, want, orig, first0, last0)


#: the axis-1 seam bands of a mesh shard (``cytvdn_tpu``'s ``halos1``,
#: ``engine.py:995-1022``), each a contiguous float32 column slab of the
#: shard (its shape with axis 1 collapsed to 1): ``p_*`` from the -1 shard
#: (``p_r0_m2``/``p_r0_m1`` its recon columns -2 and -1, the rest its
#: column -1), ``n_*`` from the +1 shard (``n_r0_c0``/``n_r0_c1`` its
#: recon columns 0 and 1, ``n_acc1_c1``/``n_d1_c1`` its column 1, the rest
#: its column 0); the ``_d`` bands under FISTA only, float32 also under
#: lossy duals.
HALO1_KEYS = ("p_r0_m2", "p_r0_m1", "p_orig_m1", "p_acc0_m1", "p_acc1_m1",
              "p_acc2_m1", "p_acc3_m1", "p_d0_m1", "p_d1_m1", "p_d2_m1",
              "p_d3_m1", "n_r0_c0", "n_r0_c1", "n_orig_c0", "n_acc0_c0",
              "n_acc1_c0", "n_acc2_c0", "n_acc3_c0", "n_d0_c0", "n_d1_c0",
              "n_d2_c0", "n_d3_c0", "n_acc1_c1", "n_d1_c1")


def _halo1_keys(ndim: int, fista: bool):
    """The :data:`HALO1_KEYS` a (ndim, fista) pair takes."""
    kinds = ("acc", "d") if fista else ("acc",)
    keys = ["p_r0_m2", "p_r0_m1", "p_orig_m1", "n_r0_c0", "n_r0_c1",
            "n_orig_c0"]
    keys += [f"{s}_{kind}{k}_{c}" for s, c in (("p", "m1"), ("n", "c0"))
             for kind in kinds for k in range(ndim)]
    return keys + [f"n_{kind}1_c1" for kind in kinds]


def _column_shape(orig: Tensor):
    """A column slab of ``orig``: its shape with axis 1 collapsed to 1."""
    return (orig.shape[0], 1) + tuple(orig.shape[2:])


def _check_halos1(halos1, orig: Tensor, fista: bool, first1: bool,
                  last1: bool) -> None:
    """Every band the pair takes, each a contiguous column slab like
    ``orig``'s; nothing else; a missing neighbour's may be left out. The
    seam recomputes read two columns of the shard: N1 ≥ 2 (the JAX gate,
    ``engine.py:514-515``)."""
    if orig.shape[1] < 2:
        raise ValueError(f"halos1 needs 2 columns along axis 1, the shard "
                         f"has {orig.shape[1]}")
    col = _column_shape(orig)
    _check_bands("halos1", halos1, {k: col for k in
                                    _halo1_keys(orig.dim(), fista)},
                 orig, first1, last1)


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
    halos1: Optional[Dict[str, Tensor]] = None,
    first1=None,
    last1=None,
):
    """The plain version of :func:`fused_pair_iteration`: two Jia-Zhao
    iterations of :func:`fused_iteration_reference`, in place, returning
    ``(recon, accs, ds, bnorm1, dnum1, dden1, bnorm2, dnum2, dden2)`` and,
    with ``ref``, ``(sse1, sse2)``: ``ops.sum_square_error`` after each
    iteration. With ``halos0`` (``halos1``) each iteration takes the
    axis-0 (axis-1) K=1 halos that the bands give (:func:`_pair_seams`).
    Bfloat16 ``ds`` (lossy duals) round after each iteration, in the K=1
    steps' ``copy_``."""
    if halos0 is not None and halos1 is not None:
        raise ValueError("halos0 and halos1: one split axis at a time")
    if halos0 is not None:
        _check_halos0(halos0, orig, fista, _edge_flag(first0, "halos0"),
                      _edge_flag(last0, "halos0"))
        halos = _pair_seams(orig, recon, accs, ds, rho1, lambda_inv,
                            lam_mu, fista, 0, halos0, first0, last0)
    elif halos1 is not None:
        _check_halos1(halos1, orig, fista, _edge_flag(first1, "halos1"),
                      _edge_flag(last1, "halos1"))
        halos = _pair_seams(orig, recon, accs, ds, rho1, lambda_inv,
                            lam_mu, fista, 1, halos1, first1, last1)
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
    bands. Bfloat16 ``ds`` rows (lossy duals) widen exactly to ``orig``'s
    dtype, as the engine widens them at the pack. A slab paired with them
    is bitwise rows [a0, a1) of one pair of the whole cube."""
    n0, nd = orig.shape[0], orig.dim()
    first0, last0 = a0 == 0, a1 == n0

    def rows(x, i, j):
        if first0 and i < 0 or last0 and j > 0:
            return torch.zeros_like(x[:j - i], dtype=orig.dtype)
        return (x[a0 + i:a0 + j] if i < 0 else x[a1 + i:a1 + j]).to(
            orig.dtype).contiguous()

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


def halo1_bands(orig: Tensor, recon: Tensor, accs: Sequence[Tensor],
                ds: Optional[Sequence[Tensor]], j0: int, j1: int):
    """The bands of the column shard [j0, j1) of a whole-cube state (axis 1
    sliced), cut from it as an axis-1 mesh's neighbours would send them:
    returns ``(halos1, first1, last1)``, zeros in place of a missing
    neighbour's bands. Bfloat16 ``ds`` columns (lossy duals) widen exactly
    to ``orig``'s dtype. Every shard has 2 columns or more (the JAX gate),
    the neighbours too. A shard paired with them is bitwise columns
    [j0, j1) of one pair of the whole cube."""
    n1 = orig.shape[1]
    first1, last1 = j0 == 0, j1 == n1
    if j1 - j0 < 2 or not first1 and j0 < 2 or not last1 and j1 + 2 > n1:
        raise ValueError(f"columns [{j0}, {j1}) of {n1}: every shard needs "
                         "2 columns")

    def col(x, j):
        if first1 and j < j0 or last1 and j >= j1:
            return torch.zeros_like(x[:, :1], dtype=orig.dtype)
        return x[:, j:j + 1].to(orig.dtype).contiguous()

    h = {"p_r0_m2": col(recon, j0 - 2), "p_r0_m1": col(recon, j0 - 1),
         "p_orig_m1": col(orig, j0 - 1), "n_r0_c0": col(recon, j1),
         "n_r0_c1": col(recon, j1 + 1), "n_orig_c0": col(orig, j1),
         "n_acc1_c1": col(accs[1], j1 + 1)}
    for k in range(orig.dim()):
        h[f"p_acc{k}_m1"] = col(accs[k], j0 - 1)
        h[f"n_acc{k}_c0"] = col(accs[k], j1)
        if ds is not None:
            h[f"p_d{k}_m1"] = col(ds[k], j0 - 1)
            h[f"n_d{k}_c0"] = col(ds[k], j1)
    if ds is not None:
        h["n_d1_c1"] = col(ds[1], j1 + 1)
    return {k: v.clone() for k, v in h.items()}, first1, last1


def _edge_flag(flag, name: str) -> bool:
    if flag is None:
        axis = name[-1]
        raise ValueError(f"{name} needs first{axis} and last{axis}")
    return bool(float(flag))


def _seam_bands(bands, ax: int, nd: int):
    """The bands of split axis ``ax`` (:data:`HALO0_KEYS` or
    :data:`HALO1_KEYS`) by role: the -1 shard's slabs -2 (``p_far``) and
    -1 (``p_near``) of recon and its slab -1 of orig, b_k and d_k; the +1
    shard's slabs 0 (``n_near``) and 1 (``n_far``) of recon, its slab 0 of
    orig, b_k and d_k and its slab 1 of b_ax and d_ax (``n_acc_far``,
    ``n_d_far``). A missing neighbour's are None."""
    g = bands.get
    if ax == 0:
        def rows(key, i):
            t = g(key)
            return t[i:i + 1] if t is not None else None

        return dict(p_far=rows("p_r0", 0), p_near=rows("p_r0", 1),
                    p_orig=g("p_orig"), n_near=rows("n_r0", 0),
                    n_far=rows("n_r0", 1), n_orig=g("n_orig"),
                    p_acc=[g(f"p_acc{k}") for k in range(nd)],
                    p_d=[g(f"p_d{k}") for k in range(nd)],
                    n_acc=[g(f"n_acc{k}") for k in range(nd)],
                    n_d=[g(f"n_d{k}") for k in range(nd)],
                    n_acc_far=g("n_acc0_r1"), n_d_far=g("n_d0_r1"))
    return dict(p_far=g("p_r0_m2"), p_near=g("p_r0_m1"),
                p_orig=g("p_orig_m1"), n_near=g("n_r0_c0"),
                n_far=g("n_r0_c1"), n_orig=g("n_orig_c0"),
                p_acc=[g(f"p_acc{k}_m1") for k in range(nd)],
                p_d=[g(f"p_d{k}_m1") for k in range(nd)],
                n_acc=[g(f"n_acc{k}_c0") for k in range(nd)],
                n_d=[g(f"n_d{k}_c0") for k in range(nd)],
                n_acc_far=g("n_acc1_c1"), n_d_far=g("n_d1_c1"))


def _pair_seams(orig, recon, accs, ds, rho1, lambda_inv, lam_mu, fista, ax,
                bands, first, last):
    """The K=1 halos of the pair's two iterations from the bands of split
    axis ``ax`` (0: ``halos0``, 1: ``halos1``), as two functions of the
    current recon: iteration 1's from the bands themselves; iteration 2's
    from the neighbours' seam slabs advanced one iteration with
    :func:`fused_iteration_reference` on one-slab cubes (the -1 shard's
    slab -1 against this shard's slab 0, the +1 shard's slab 0 against
    this shard's last slab and its own slab 1), before this shard's state
    changes. The other of axes 0 and 1 takes the Jia-Zhao edge values,
    its forward wrap the cube's own leading accumulator slab along it, as
    the kernel reads it (``csrc/temporal_pair.cu``: recon-1 at the last
    index reads b at index 0 after dual-1, recon-2 after dual-2): zero by
    the Jia-Zhao invariant where the cube holds the whole other axis, and
    not zero on a 2D grid's shard, whose wrong columns the seam repair
    (``parallel/pairfix.py``) then knows.

    Lossy duals (bfloat16 ``ds``): the bands are float32, every ``d`` that
    enters a K=1 halo operand widens to float32, and the +1 shard's
    advanced slab-0 ``d`` is rounded with :func:`round_bf16` before
    iteration 2 reads it, as that shard's own bfloat16 store rounds it (the
    TPU kernel's ``qd1`` of ``s_d1n0``)."""
    name = f"halos{ax}"
    first, last = _edge_flag(first, name), _edge_flag(last, name)
    nd = orig.dim()
    other = 1 - ax
    b = _seam_bands(bands, ax, nd)
    lossy = fista and ds[0].dtype == torch.bfloat16

    def slab(x, axis, i):
        """Slab ``i`` of ``x`` along ``axis``, a contiguous float copy."""
        i = i % x.shape[axis]
        return x.narrow(axis, i, 1).to(orig.dtype, copy=True).contiguous()

    def k1_halos(cube, prev, nxt):
        """Axis ``ax`` from ``prev`` and ``nxt`` (recon, acc, d); the other
        axis the Jia-Zhao edges of ``cube`` (recon, accs, ds): its own
        first recon slab backward, and forward the recompute of its own
        leading accumulator slab (a zero difference on the pre-update
        b and d, the slab's own dual update)."""
        r, a, d = cube
        out = {f"prev{ax}": prev, f"next{ax}_recon": nxt[0],
               f"next{ax}_acc": nxt[1],
               f"prev{other}": slab(r, other, 0),
               f"next{other}_recon": slab(r, other, -1),
               f"next{other}_acc": slab(a[other], other, 0)}
        if fista:
            out[f"next{ax}_d"] = nxt[2]
            out[f"next{other}_d"] = slab(d[other], other, 0)
        return out

    def edge_next(cube_recon):
        z = torch.zeros_like(slab(cube_recon, ax, -1))
        return (slab(cube_recon, ax, -1), z, z)

    def advance(o, r, a, d, prev, nxt):
        """One iteration of a one-slab cube in place."""
        fused_iteration_reference(
            o, r, a, d, rho1, lambda_inv, lam_mu, fista=fista,
            bc=BCMode.JIA_ZHAO, halos=k1_halos((r, a, d), prev, nxt))

    prev_r1 = nxt1 = None
    if not first:
        # the -1 shard's seam slab after iteration 1
        prev_r1 = b["p_near"].clone()
        advance(b["p_orig"], prev_r1, [x.clone() for x in b["p_acc"]],
                [x.clone() for x in b["p_d"]] if fista else None,
                b["p_far"],
                (slab(recon, ax, 0), slab(accs[ax], ax, 0),
                 slab(ds[ax], ax, 0) if fista else None))
    if not last:
        # the +1 shard's seam slab after iteration 1
        r = b["n_near"].clone()
        a = [x.clone() for x in b["n_acc"]]
        d = [x.clone() for x in b["n_d"]] if fista else None
        advance(b["n_orig"], r, a, d, slab(recon, ax, -1),
                (b["n_far"], b["n_acc_far"], b["n_d_far"] if fista else None))
        nxt1 = (r, a[ax], (round_bf16(d[ax]) if lossy else d[ax]) if fista
                else None)

    def seams1(cube_recon):
        prev = slab(cube_recon, ax, 0) if first else b["p_near"]
        nxt = edge_next(cube_recon) if last else \
            (b["n_near"], b["n_acc"][ax], b["n_d"][ax] if fista else None)
        return k1_halos((cube_recon, accs, ds), prev, nxt)

    def seams2(cube_recon):
        prev = slab(cube_recon, ax, 0) if first else prev_r1
        nxt = edge_next(cube_recon) if last else nxt1
        return k1_halos((cube_recon, accs, ds), prev, nxt)

    return seams1, seams2


def cooperative_grid(device: torch.device, ndim: int, fista: bool,
                     ref: bool = False, halo: int = NO_HALO,
                     lossy: bool = False) -> int:
    """Blocks of the full cooperative grid of the (ndim, fista, ref, halo,
    lossy) kernel on ``device``: resident blocks per SM times SMs. ``halo``
    is the halo mode (:data:`NO_HALO`, :data:`HALO_AXIS0`,
    :data:`HALO_AXIS1`)."""
    key = (device.index if device.index is not None
           else torch.cuda.current_device(), ndim, fista, ref, int(halo),
           lossy)
    if key not in _GRID:
        lib = build.load()
        blocks = ctypes.c_int(0)
        with torch.cuda.device(key[0]):
            build.check(lib.tv_pair_max_blocks(ndim, int(fista), int(ref),
                                               int(halo), int(lossy),
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
    halos1: Optional[Dict[str, Tensor]] = None,
    first1=None,
    last1=None,
    stash: Optional[Tensor] = None,
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
    shard of an axis-0 mesh; ``stash``, a (2, N1, …) tensor like the cube's
    rows, is its 2-row scratch (default: allocated per call). ``halos1``,
    a dict of :data:`HALO1_KEYS` column slabs, with ``first1``/``last1``,
    runs its ``HALO1`` instantiation: the cube (N1 ≥ 2) is a shard of an
    axis-1 mesh, and ``stash`` is a (2, N0, 1, …) tensor of two column
    slabs. ``halos0`` and ``halos1`` are not taken together.

    Lossy duals: under FISTA ``ds`` may be bfloat16. The old ``d`` widens
    exactly, the arithmetic stays float32, and each iteration's new ``d``
    is stored rounded to nearest even, iteration 1's before iteration 2
    reads it (the kernel's ``LOSSY`` instantiations; the plain version's two
    lossy K=1 steps). The ``halos0`` and ``halos1`` bands stay float32.

    Returns ``(recon, accs, ds, bnorm1, dnum1, dden1, bnorm2, dnum2,
    dden2)`` — the state objects passed in and both iterations' sums as 0-d
    tensors — and, with ``ref``, ``(sse1, sse2)``, the sum of squared
    errors of each iteration's recon against ``ref``.
    ``fused_pair_iteration.launches`` counts kernel launches,
    ``fused_pair_iteration.halo0_launches`` those of them with ``halos0``,
    ``fused_pair_iteration.halo1_launches`` those with ``halos1``,
    ``fused_pair_iteration.lossy_launches`` those with bfloat16 ``ds``;
    ``fused_pair_iteration.calls`` counts every call that passed the checks,
    on the CPU too.
    """
    ndim = orig.dim()
    if not pair_supported(tuple(orig.shape), orig.dtype, BCMode.JIA_ZHAO):
        raise ValueError(
            f"fused_pair_iteration does not cover shape {tuple(orig.shape)}, "
            f"dtype {orig.dtype} (float32, 3D/4D, N0 >= 4)")
    lossy = _check_state(orig, recon, accs, ds, fista, lossy_ok=True)
    if ref is not None:
        _check(ref, orig, "ref")
    if halos0 is not None and halos1 is not None:
        raise ValueError("halos0 and halos1: one split axis at a time")
    halo, bands = NO_HALO, None
    if halos0 is not None:
        halo, bands = HALO_AXIS0, halos0
        flags = (_edge_flag(first0, "halos0"), _edge_flag(last0, "halos0"))
        _check_halos0(halos0, orig, fista, *flags)
    if halos1 is not None:
        halo, bands = HALO_AXIS1, halos1
        flags = (_edge_flag(first1, "halos1"), _edge_flag(last1, "halos1"))
        _check_halos1(halos1, orig, fista, *flags)
    if strip is not None and int(strip) < 1:
        raise ValueError(f"strip must be >= 1, got {strip}")
    strip = orig.shape[1] if strip is None else min(int(strip), orig.shape[1])
    if orig.device.type == "cpu":
        fused_pair_iteration.calls += 1
        return fused_pair_iteration_reference(
            orig, recon, accs, ds, rho1, rho2, lambda_inv, lam_mu, fista=fista,
            ref=ref, halos0=halos0, first0=first0, last0=last0,
            halos1=halos1, first1=first1, last1=last1)
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
        orig.device, ndim, fista, ref is not None, halo, lossy)
    n_out = 6 if ref is None else 8
    partials = torch.empty(n_out * nblocks, dtype=torch.float64,
                           device=orig.device)
    out = torch.empty(n_out, dtype=orig.dtype, device=orig.device)
    table, first, last = None, 0, 0
    if bands is not None:
        first, last = (int(f) for f in flags)
        # the +1 shard's recomputed first b slab (and d slab) at level 1,
        # left by recon-1 for recon-2 at the last row (HALO0) or at every
        # row's last column (HALO1); read only with a +1 shard
        shape = (2,) + (tuple(orig.shape[1:]) if halo == HALO_AXIS0
                        else _column_shape(orig))
        if last:
            stash = None
        elif stash is None:
            stash = torch.empty(shape, dtype=orig.dtype, device=orig.device)
        else:
            _check(stash, orig.new_empty(shape), "stash")
        keys = HALO0_KEYS if halo == HALO_AXIS0 else HALO1_KEYS
        ptrs = [bands[k].data_ptr() if bands.get(k) is not None else None
                for k in keys]
        ptrs.append(stash.data_ptr() if stash is not None else None)
        table = (ctypes.c_void_p * len(ptrs))(*ptrs)
    err = lib.tv_pair_iteration_f32(
        orig.data_ptr(), recon.data_ptr(), *bs, *dd,
        lambda_inv.data_ptr(), lam_mu.data_ptr(),
        rho1.data_ptr() if fista else None, rho2.data_ptr() if fista else None,
        ref.data_ptr() if ref is not None else None,
        partials.data_ptr(), out.data_ptr(), table, halo, first, last, ndim,
        *dims, strip, int(fista), int(lossy), nblocks, stream)
    build.check(err)
    fused_pair_iteration.calls += 1
    fused_pair_iteration.launches += 1
    fused_pair_iteration.halo0_launches += halo == HALO_AXIS0
    fused_pair_iteration.halo1_launches += halo == HALO_AXIS1
    fused_pair_iteration.lossy_launches += lossy
    return (recon, accs, ds, *out.unbind())


fused_pair_iteration.launches = 0
fused_pair_iteration.halo0_launches = 0
fused_pair_iteration.halo1_launches = 0
fused_pair_iteration.lossy_launches = 0
fused_pair_iteration.calls = 0
