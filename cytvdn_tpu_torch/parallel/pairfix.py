"""Axis-1 seam repair for pairs on 2D grids (meshes split on axes 0 and 1).

Counterpart of ``cytvdn_tpu/parallel/pairfix.py``. The pair kernel takes
the bands of one split axis per launch (``kernels/temporal.py``): a shard of
a 2D grid pairs with its axis-0 bands (``halos0``, the kernel's ``HALO0``)
and with the Jia-Zhao edges of axis 1, and this module repairs the
columns that this gets wrong, after each launch:

1. before the launch, one packed exchange along axis 1 (both directions)
   of the own 4 edge columns of the pre-pair state (recon, the
   accumulators, under FISTA the shadow duals, widened to float32), and
   once per phase of orig's (:func:`orig_columns`, :func:`edge_columns`);
2. after it, 4-column strips advanced two iterations through the plain
   ops (``ops/stencil.py``, the K=1 spec the kernels are bitwise on the
   card) with axis-0 halos exchanged along the mesh's axis 0 (all strips
   of a shard in one message per halo); the strips' exact columns
   overwrite the wrong ones (:func:`repair_axis1_seams`);
3. the launch's six sums, and with a reference cube its two sums of
   squared errors, corrected by (correct − what the launch computed) over
   exactly the wrong cells.

Wrong sets, per shard of m ≥ 4 columns (the JAX ones): at a left seam
(every shard but the first along axis 1) iteration 1's axis-1 dual at
column 0, recon-1 at column 0, iteration 2's duals at column 0 (and the
axis-1 one at column 1), recon-2 at columns {0, 1}; at the right edge
recon-1 at column m−1, iteration 2's duals at m−1 and recon-2 at
{m−2, m−1}.

The port's right edge differs from JAX's: the port's Jia-Zhao forward wrap
reads b₁ at the shard's own column 0 (``csrc/fused_iteration.cu``,
``csrc/temporal_pair.cu``), where JAX's kernel reads a literal zero. On
every shard but the first along axis 1 that b₁ is not zero, so the right
edge is wrong on the last shard too, and is repaired there against a
literal-zero wrap (the cube's edge); and what the launch computed at the
right edge is rebuilt with the wrap it read: b₁ at column 0 after each
iteration, the left strip's own (``kernels/temporal.py::_pair_seams``
gives the plain pair the same wrap, so the CPU and the card agree).

The engine takes this path only where :func:`can_pair` allows, which by
default it does not (:data:`PAIR_2D_GRIDS`): 2D grids then run the K=1
loop.

Exactness: the strips run the plain ops, bitwise the kernels, so the
repaired state is bitwise the single-device run's (where JAX's repair is
within ulps); only the traces differ, by the float sums' order.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Sequence

import torch

from cytvdn_tpu_torch import ops
from cytvdn_tpu_torch.config import BCMode
from cytvdn_tpu_torch.kernels.temporal import round_bf16

Tensor = torch.Tensor

#: columns taken from each side of a seam (the strips are 4 + 4 wide)
SW = 4

#: Whether 2D grids run in pairs at all. Off by default: on the one
#: workload measured, config 4 on (2, 2, 1, 1) (four gloo ranks sharing an
#: NVIDIA H100 80GB HBM3, 700 W; ``chip_smoke.py`` phase 9 (c)), pairs with
#: the repair took 0.73-0.74 s per iteration per rank against 0.20 on the
#: K=1 loop. The repair's column exchanges (0.30 GB per pair per rank
#: there) and its strips' plain ops cost more than the pair kernel saves
#: (a few ms per pair). The state is bitwise the same either way.
PAIR_2D_GRIDS = False


def can_pair(shape) -> bool:
    """Whether a 2D grid's shard of ``shape`` runs in pairs: where
    :data:`PAIR_2D_GRIDS` is set and the shard holds the strips' ``SW``
    columns. The shape alone, so every rank decides alike."""
    return PAIR_2D_GRIDS and shape[1] >= SW

_STATS = ("exchanges", "bytes_sent", "bytes_received", "exchange_seconds")


@contextlib.contextmanager
def _seam_stats(comm):
    """Count the exchanges made inside also as the seam repair's
    (``comm.stats["seam_*"]``)."""
    before = [comm.stats[k] for k in _STATS]
    try:
        yield
    finally:
        for k, b in zip(_STATS, before):
            comm.stats["seam_" + k] += comm.stats[k] - b


@dataclasses.dataclass
class OrigColumns:
    """orig's 4 edge columns and the axis-1 neighbours' (None at a global
    edge): exchanged once per phase, since orig never changes."""
    lo: Tensor
    hi: Tensor
    prev: Optional[Tensor]
    next: Optional[Tensor]


@dataclasses.dataclass
class EdgeColumns:
    """The pre-pair state's edge columns (:func:`edge_columns`): the own
    first and last 4 columns and the -1 neighbour's last and the +1
    neighbour's first 4 (None at a global edge), each a list of recon,
    the accumulators [, the shadow duals in float32]."""
    lo: List[Tensor]
    hi: List[Tensor]
    prev: Optional[List[Tensor]]
    next: Optional[List[Tensor]]


def orig_columns(comm, orig: Tensor) -> OrigColumns:
    """orig's edge columns and the neighbours', in one exchange along axis
    1 (views into its buffers, valid until its next call)."""
    lo, hi = orig[:, :SW], orig[:, -SW:]
    with _seam_stats(comm):
        got_p, got_n = comm.exchange_pieces(1, [hi], [lo], name="seam_orig")
    return OrigColumns(lo, hi, got_p[0] if got_p is not None else None,
                       got_n[0] if got_n is not None else None)


def edge_columns(comm, recon: Tensor, accs: Sequence[Tensor],
                 ds: Optional[Sequence[Tensor]]) -> EdgeColumns:
    """Before a pair launch: the own 4 first and last columns of recon,
    the accumulators [and the shadow duals, bfloat16 widened exactly] kept
    in the pool (the launch updates the state in place), and sent in one
    exchange along axis 1 each way: the last ones to the +1 neighbour, the
    first ones to the -1 neighbour."""
    arrays = [recon, *accs] + (list(ds) if ds is not None else [])
    shape = (len(arrays), recon.shape[0], SW) + tuple(recon.shape[2:])
    tag = "" if ds is None else "_d"
    lo = comm.buffer("seam_lo" + tag, shape, recon.dtype, recon.device)
    hi = comm.buffer("seam_hi" + tag, shape, recon.dtype, recon.device)
    for k, a in enumerate(arrays):
        lo[k].copy_(a[:, :SW])
        hi[k].copy_(a[:, -SW:])
    with _seam_stats(comm):
        got_p, got_n = comm.exchange_pieces(1, [hi], [lo],
                                            name="seam" + tag)
    return EdgeColumns(list(lo.unbind()), list(hi.unbind()),
                       list(got_p[0].unbind()) if got_p is not None else None,
                       list(got_n[0].unbind()) if got_n is not None else None)


@dataclasses.dataclass
class _Strip:
    """A strip's state through its two iterations: orig, recon, the
    accumulators [, the shadow duals]; ``c0`` the first of the two strip
    columns that stand for the shard's wrong columns; ``wrap`` the axis-1
    forward wrap of its reconstructions: None (the Jia-Zhao wrap inside the
    strip, its own column 0), "zero" (the cube's last column) or "left"
    (b₁ at the shard's column 0, from the first strip). After iteration 1
    ``r1`` keeps recon at the two columns and ``b1`` the axis-1
    accumulator at the first."""
    orig: Tensor
    recon: Tensor
    accs: List[Tensor]
    ds: Optional[List[Tensor]]
    c0: int
    wrap: Optional[str] = None
    r1: Optional[Tensor] = None
    b1: Optional[Tensor] = None

    def cols(self, x: Tensor, j: int = 0, n: int = 2) -> Tensor:
        """``n`` of ``x``'s columns from the strip's column ``c0 + j``."""
        return x[:, self.c0 + j:self.c0 + j + n]


def _advance(comm, strips: List[_Strip], rhos, lambda_inv: Tensor,
             lam_mu: Tensor, lossy: bool) -> None:
    """Two Jia-Zhao iterations of every strip, through the ops of
    ``fused_iteration_reference`` in its order, in place of each strip's
    state. Axis 0: the -1 neighbour's last recon row before the duals and
    the +1 neighbour's first updated b₀ row before the reconstructions, of
    every strip in one exchange each (the cube's edges: the own first row
    and a literal zero). Under lossy duals each iteration's d is rounded
    onto the bfloat16 grid as the state's store rounds it."""
    nd = strips[0].recon.dim()
    zero_row = None
    for it, rho in enumerate(rhos):
        got, _ = comm.exchange_pieces(
            0, [s.recon[-1:] for s in strips], (), name=f"seam_r{len(strips)}")
        for j, s in enumerate(strips):
            new_b, new_d = [], []
            for ax in range(nd):
                halo = got[j] if ax == 0 and got is not None else None
                if s.ds is not None:
                    b, d, _ = ops.accumulator_update_fista(
                        s.recon, s.accs[ax], s.ds[ax], rho, ax,
                        lambda_inv[ax], BCMode.JIA_ZHAO, halo)
                    new_d.append(round_bf16(d) if lossy else d)
                else:
                    b, _ = ops.accumulator_update(
                        s.recon, s.accs[ax], ax, lambda_inv[ax],
                        BCMode.JIA_ZHAO, halo)
                new_b.append(b)
            s.accs = new_b
            if s.ds is not None:
                s.ds = new_d
        _, got = comm.exchange_pieces(
            0, (), [s.accs[0][:1] for s in strips], name=f"seam_b{len(strips)}")
        for j, s in enumerate(strips):
            nxt = [None] * nd
            if got is not None:
                nxt[0] = got[j]
            else:
                if zero_row is None:
                    # wide enough for every strip
                    shape = (1, 2 * SW) + tuple(s.recon.shape[2:])
                    zero_row = comm.buffer("seam_zero", shape, s.recon.dtype,
                                           s.recon.device, zero=True)
                nxt[0] = zero_row[:, :s.recon.shape[1]]
            if s.wrap == "zero":
                nxt[1] = torch.zeros_like(s.accs[1][:, :1])
            elif s.wrap == "left":
                nxt[1] = strips[0].accs[1][:, :1]
            s.recon, _, _ = ops.datacube_update(s.orig, s.recon, s.accs,
                                                lam_mu, BCMode.JIA_ZHAO, nxt)
            if it == 0:
                s.r1 = s.cols(s.recon).clone()
                s.b1 = s.cols(s.accs[1], n=1).clone()


def _strips(oc: OrigColumns, pre: EdgeColumns, nd: int):
    """The strips of a shard: [0] its own first 4 columns as the launch
    saw them (the Jia-Zhao edge at column 0); [1] the same at its last 4
    columns, with the launch's wrap; [2] its last 4 columns with the +1
    neighbour's first 4, or alone with a literal-zero wrap on the cube's
    last shard; [3] the -1 neighbour's last 4 with its own first 4, on
    every shard but the first. The shard's wrong columns are the strips'
    columns 0 and 1 in [0], 2 and 3 in [1] and [2], 4 and 5 in [3]."""
    def strip(o, cols, c0, wrap=None):
        return _Strip(o, cols[0], list(cols[1:1 + nd]),
                      list(cols[1 + nd:]) if len(cols) > 1 + nd else None,
                      c0, wrap)

    def cat(a, b):
        return torch.cat([a, b], dim=1)

    out = [strip(oc.lo, pre.lo, 0), strip(oc.hi, pre.hi, 2, "left")]
    if pre.next is not None:
        out.append(strip(cat(oc.hi, oc.next),
                         [cat(a, b) for a, b in zip(pre.hi, pre.next)], 2))
    else:
        out.append(strip(oc.hi, pre.hi, 2, "zero"))
    if pre.prev is not None:
        out.append(strip(cat(oc.prev, oc.lo),
                         [cat(a, b) for a, b in zip(pre.prev, pre.lo)], 4))
    return out


def advance_strips(comm, oc: OrigColumns, pre: EdgeColumns, rho1, rho2,
                   lambda_inv: Tensor, lam_mu: Tensor, lossy: bool):
    """The strips of :func:`_strips`, advanced two iterations
    (:func:`_advance`)."""
    strips = _strips(oc, pre, oc.lo.dim())
    with _seam_stats(comm):
        _advance(comm, strips, (rho1, rho2), lambda_inv, lam_mu, lossy)
    return strips


def _abs_sum(x: Tensor) -> Tensor:
    return torch.sum(torch.abs(x), dtype=torch.float64)


def _sq_sum(a: Tensor, b: Tensor) -> Tensor:
    d = a.double() - b.double()
    return torch.sum(d * d)


def repair_axis1_seams(comm, oc: OrigColumns, pre: EdgeColumns,
                       recon: Tensor, accs: Sequence[Tensor],
                       ds: Optional[Sequence[Tensor]], rho1, rho2,
                       lambda_inv: Tensor, lam_mu: Tensor, sums: Tensor,
                       ref: Optional[Tensor] = None) -> Tensor:
    """Repair one pair launch on a 2D grid's shard: ``pre`` the pre-pair
    edge columns (:func:`edge_columns`), ``recon``/``accs``/``ds`` the
    state the launch left (updated in place: recon, the accumulators and
    the shadow duals at the wrong columns), ``sums`` its local
    ``(bn1, dn1, dd1, bn2, dn2, dd2[, sse1, sse2])`` (the SSE with
    ``ref``, the shard's reference block). Returns the corrected sums, of
    ``sums``' dtype, before the all-reduce."""
    nd = recon.dim()
    m = recon.shape[1]
    lossy = ds is not None and ds[0].dtype == torch.bfloat16
    strips = advance_strips(comm, oc, pre, rho1, rho2, lambda_inv, lam_mu,
                            lossy)
    corr = torch.zeros(len(sums), dtype=torch.float64, device=recon.device)

    def fix(ok: _Strip, bad: _Strip, left: bool, r0: Tensor, ref_cols):
        """Add (correct − launch's) to ``corr`` over one edge's wrong
        cells, the two columns of each strip: recon-2 at both; recon-1 and
        iteration 2's duals (all axes) at the first (left) or the second
        (right); at a left seam also iteration 1's axis-1 dual at the first
        and iteration 2's at the second."""
        w = 0 if left else 1
        if left:
            corr[0] += _abs_sum(ok.b1) - _abs_sum(bad.b1)
        r1, r1b = ok.r1[:, w:w + 1], bad.r1[:, w:w + 1]
        corr[1] += _abs_sum(r1 - r0) - _abs_sum(r1b - r0)
        corr[5] += _abs_sum(r1) - _abs_sum(r1b)
        for k in range(nd):
            corr[3] += _abs_sum(ok.cols(ok.accs[k], w, 1)) \
                - _abs_sum(bad.cols(bad.accs[k], w, 1))
        if left:
            corr[3] += _abs_sum(ok.cols(ok.accs[1], 1, 1)) \
                - _abs_sum(bad.cols(bad.accs[1], 1, 1))
        r2, r2b = ok.cols(ok.recon), bad.cols(bad.recon)
        corr[4] += _abs_sum(r2 - ok.r1) - _abs_sum(r2b - bad.r1)
        if ref is not None:
            f1 = ref_cols[:, w:w + 1]
            corr[6] += _sq_sum(r1, f1) - _sq_sum(r1b, f1)
            corr[7] += _sq_sum(r2, ref_cols) - _sq_sum(r2b, ref_cols)

    def put(lo: int, s: _Strip):
        """The shard's columns [lo, lo + 2) from the strip's two."""
        recon[:, lo:lo + 2].copy_(s.cols(s.recon))
        for k in range(nd):
            accs[k][:, lo:lo + 2].copy_(s.cols(s.accs[k]))
            if ds is not None:
                # on the bfloat16 grid under lossy duals: an exact store
                ds[k][:, lo:lo + 2].copy_(s.cols(s.ds[k]))

    left_w, right_w, right = strips[:3]
    # the right edge, on every shard: its columns {m-2, m-1}
    fix(right, right_w, False, pre.hi[0][:, 3:4],
        ref[:, m - 2:] if ref is not None else None)
    if len(strips) > 3:
        # the left seam: columns {0, 1}
        fix(strips[3], left_w, True, pre.lo[0][:, :1],
            ref[:, :2] if ref is not None else None)
        put(0, strips[3])
    put(m - 2, right)
    return (sums.double() + corr).to(sums.dtype)


def reserve(comm, orig: Tensor, recon: Tensor, accs: Sequence[Tensor],
            ds: Optional[Sequence[Tensor]]) -> None:
    """Allocate, under ``comm.reserving()``, every pool buffer of the
    repair: the column exchanges' and the strips' row exchanges' (whose
    contents are then undefined, so the strips run on them and their
    results are dropped; the state is not written)."""
    ones = torch.ones(orig.dim(), dtype=orig.dtype, device=orig.device)
    rho = ones[0]
    oc = orig_columns(comm, orig)
    pre = edge_columns(comm, recon, accs, ds)
    lossy = ds is not None and ds[0].dtype == torch.bfloat16
    advance_strips(comm, oc, pre, rho, rho, ones, ones, lossy)
