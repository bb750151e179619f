"""The iteration engine on one device: a host loop over fused iterations.

Counterpart of ``cytvdn_tpu/solver/engine.py`` on its main path
(``run_solver``, ``_run_phase``, ``iteration_step``, ``fista_tk_ratios``,
``vmem_fallback``). The JAX engine runs each phase as a
``lax.while_loop`` with the stop check in its predicate; PyTorch has no
device-side loop, so each phase here is a Python loop with the same
semantics:

- the traces are recorded before the stop check, so the converging
  iteration is included (reference cyTVDN/cyTVDN.py:182-194);
- without ``stopping_relative_change`` the loop never waits for the device;
  with it, each iteration makes one ``.item()`` host sync to read the stop
  flag (a device-side flag is ROADMAP.md Queue 1 S3);
- hybrid runs run FISTA first, then always the unaccelerated phase, which
  shares the accumulators, with the stop latch reset between the phases.

- lossy runs (``lossy_duals``: the shadow duals stored as bfloat16) take
  K-steps on one device, pairs where they pay on one device and on an
  axis-0 or axis-1 mesh, and the one-iteration loop for the rest, as exact
  runs do:
  the K-step kernel rounds every level's duals at its store and the pair
  kernel iteration 1's in the middle of the pair (their ``LOSSY``
  instantiations), so the state is that of the lossy one-iteration loop.
  The whole-run kernel refuses them, as the JAX gate does;
- float32 runs whose whole state is small (``_resolve_resident``) run the
  whole schedule in one launch of the whole-run kernel; with
  ``stopping_relative_change`` (``_resolve_resident_chunks``) each phase
  runs a few one-iteration steps, then ``_RESIDENT_CHUNK`` iterations per
  launch behind a predictive guard (``_run_phase_resident``), and the
  one-iteration loop makes the exact stop; capped or resumed runs without
  a stop take one whole-run launch per phase and chunk;
- Jia-Zhao float32 runs advance K iterations per launch through the
  K-step kernel where ``_resolve_kstep`` picks a depth (``_run_phase_kstep``;
  not with ``calculate_mse``), then two per launch through the pair kernel
  (``_run_phase_paired``; with ``calculate_mse`` its in-kernel SSE) where
  its rows are large enough to pay (``_pairs_pay``), and the one-iteration
  loop finishes each phase; the state and traces are those of the
  one-iteration loop;
- with ``stopping_relative_change``, those phases follow a one-iteration
  prologue and run behind a predictive guard in blocks of
  ``2 * _STOP_CKPT_PAIRS`` iterations, with one checkpoint of the state per
  block and one host sync per launch; a guard beaten inside a block
  discards it (``_run_blocks``), and the one-iteration loop makes the exact
  stop. Runs whose state and checkpoint exceed ``STOP_CKPT_MAX_BYTES``
  stay on the one-iteration loop.

State lives in place: ``recon``, the accumulators and the shadow duals are
allocated once (or handed in with ``state=``) and updated by every
iteration (the JAX engine gets the same effect from buffer donation).
``i_stop`` caps a call's global iteration index, so a run can go in
chunks (``utils/checkpoint.py``). :func:`vmem_fallback` retries a run that
exhausts device memory with the multi-iteration kernels turned off in turn.

With ``comm`` (a ``parallel/halo.py::MeshComm``) the cube is one shard of
an evenly tiled mesh (any axes split, any boundary, half-isotropic pairs),
and every process runs the same schedule on its block (``cytvdn_tpu``'s
engine under ``shard_map``): K=1 steps take operand halos from the
neighbours (``_k1_halos``: ring halos under periodic boundaries, the
mirror's edge flags, iso seams and corners, in-block halos of axes 2 and
3; the plain backend takes ``prev_halo``/``next_halo``), an axis-0
Jia-Zhao mesh runs its pairs with the pair kernel's 2-row bands
(``halos0``) and an axis-1 one with its 2-column bands (``halos1``) where
they pay (a 2D grid, axes 0 and 1 split, with the 2-row bands and the
seam repair of ``parallel/pairfix.py`` only where ``pairfix.can_pair``
allows), every sum goes through ``comm.allsum``, and
the stop, the guard and the block discards read only the summed traces,
so all ranks take the same branches. Every buffer a step uses is reserved
in ``comm``'s pool before the run's first collective (``prepare_run``).
Under a mesh the K-step and whole-run kernels never run
(``engine.py:563-564, :723-724``). The state is bitwise that of the
single-device run.
"""

from __future__ import annotations

import dataclasses
import gc
import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from cytvdn_tpu_torch import ops
from cytvdn_tpu_torch.config import Backend, BCMode, SolverOptions
from cytvdn_tpu_torch.kernels.fused import fused_iteration, fused_iteration_reference
from cytvdn_tpu_torch.kernels.kstep import best_kstep, fused_kstep_iteration
from cytvdn_tpu_torch.kernels.resident import resident_solve, resident_supported
from cytvdn_tpu_torch.kernels.temporal import fused_pair_iteration, pair_supported
from cytvdn_tpu_torch.ops.stencil import _slab

Tensor = torch.Tensor


def fista_tk_ratios(n: int) -> np.ndarray:
    """The FISTA momentum schedule, computed on the host in float64 exactly
    as the reference's Python-float loop does (reference cyTVDN.py:153-156):
    ``t' = (1+sqrt(1+4t²))/2``, ``ratio_i = (t-1)/t'`` from ``t=1``."""
    ratios = np.zeros((max(n, 1),), dtype=np.float64)
    tk = 1.0
    for i in range(n):
        tk_new = (1.0 + np.sqrt(1.0 + 4.0 * tk * tk)) / 2.0
        ratios[i] = (tk - 1.0) / tk_new
        tk = tk_new
    return ratios


def lossy_duals(opts: SolverOptions) -> bool:
    """Whether the run stores its shadow duals as bfloat16: ``lossy_duals``
    with a FISTA phase (``engine.py:1332``)."""
    return bool(opts.lossy_duals and opts.iterations_fista > 0)


def d_dtype(opts: SolverOptions, dtype: torch.dtype) -> torch.dtype:
    """The shadow duals' storage dtype: bfloat16 under lossy duals
    (``engine.py:1456``), else the data's."""
    return torch.bfloat16 if lossy_duals(opts) else dtype


def _k1_halos(comm, opts: SolverOptions, recon: Tensor, accs: List[Tensor],
              ds: Optional[List[Tensor]]):
    """The K=1 kernel's operand halos on a mesh (``engine.py:253-340``),
    from the neighbours' pre-update state, per halo axis (0 and 1, and each
    split axis above them, ``engine.py:266``) in one packed exchange each
    way:
    ``prev{ax}``, the -1 neighbour's last recon slab, and
    ``next{ax}_recon``/``_acc``/``_d``, the +1 neighbour's first slabs.
    Periodic runs exchange on a ring (an unsplit axis's wrap is its own
    slabs). Elsewhere the global edges get the values that realize the
    boundary: Jia-Zhao the own first slab as ``prev``, the own last recon
    slab and zeros as ``next`` (the identically-zero wrap); mirror the
    cube's slab 1 as ``prev`` (the own slab 1, or the +1 neighbour's first
    slab where the shard is one slab thick) and, as the JAX engine, the
    Jia-Zhao values as ``next``, which the kernel does not read where the
    ``edge_next`` flag is set. A split axis ``s`` of a half-isotropic pair
    with partner ``o`` also takes the +1 neighbour's first slab of
    ``accs[o]`` (``next{s}_acc{o}``) and, where ``o`` is split too, the
    diagonal neighbour's corner (``corner{s}``: the -1-along-``o``
    neighbour's ``next{s}_recon``'s last slab along ``o``; its own leading
    slab at the partner's leading edge).

    Under lossy duals the ``next{ax}_d`` slabs are the neighbour's
    bfloat16 slab widened exactly to the data's dtype.

    Every tensor returned lives in ``comm``'s buffer pool (received views
    and edge values copied into pool slabs), as do the kernel's scratch
    slabs: returns ``(halos, edge_next, scratch)``."""
    periodic = opts.bc_mode == BCMode.PERIODIC
    mirror = opts.bc_mode == BCMode.MIRROR
    split = set(comm.split_axes)
    partner = {}
    if not periodic:
        for p, q in ([(0, 1)] if opts.isotropic_R else []) + \
                ([(2, 3)] if opts.isotropic_Q else []):
            partner.update({p: q, q: p})
    tag = "k1" if ds is None else "k1d"

    def pool(name, src=None, like=None, zero=False):
        t = comm.buffer(f"{tag}_{name}", (src if src is not None
                                          else like).shape, recon.dtype,
                        recon.device, zero=zero)
        if src is not None:
            t.copy_(src)
        return t

    halos, scratch = {}, {}
    for ax in sorted({0, 1} | split):
        first, last = _slab(recon, ax, 0), _slab(recon, ax, -1)
        iso_s = ax in partner and ax in split
        to_prev = [first, _slab(accs[ax], ax, 0)]
        if ds is not None:
            # a bfloat16 d slab (lossy duals) widens exactly to the data's
            # dtype as it is packed into the exchange's buffer, so the
            # message stays one dtype and the kernel's next_d operand
            # float32 (the JAX engine sends it as bfloat16 and widens it on
            # arrival, ``engine.py:293-299``: the same bits)
            to_prev.append(_slab(ds[ax], ax, 0))
        if iso_s:
            to_prev.append(_slab(accs[partner[ax]], ax, 0))
        got_p, got_n = comm.exchange_pieces(ax, [last], to_prev,
                                            name=f"{tag}_{ax}", ring=periodic)
        if got_n is None:
            # the trailing edge (or an unsplit axis): the own first slabs
            # on a ring, else the Jia-Zhao zero wrap
            if periodic:
                got_n = [pool(f"n{ax}_{i}", p) for i, p in enumerate(to_prev)]
            else:
                zero = pool(f"z{ax}", like=first, zero=True)
                got_n = [pool(f"n{ax}", last)] + [zero] * (len(to_prev) - 1)
        if got_p is not None:
            prev = got_p[0]
        elif periodic:
            prev = pool(f"p{ax}", last)
        elif mirror:
            prev = pool(f"p{ax}", _slab(recon, ax, 1)) \
                if recon.shape[ax] > 1 else got_n[0]
        else:
            prev = pool(f"p{ax}", first)
        halos[f"prev{ax}"] = prev
        halos[f"next{ax}_recon"], halos[f"next{ax}_acc"] = got_n[:2]
        if ds is not None:
            halos[f"next{ax}_d"] = got_n[2]
        if iso_s:
            halos[f"next{ax}_acc{partner[ax]}"] = got_n[-1]
        scratch[ax] = comm.buffer(f"k1_bhat{ax}", first.shape, recon.dtype,
                                  recon.device)
    for s_, o in sorted(partner.items()):
        if s_ in split and o in split:
            nr = halos[f"next{s_}_recon"]
            got, _ = comm.exchange_pieces(o, [_slab(nr, o, -1)], (),
                                          name=f"{tag}_corner{s_}")
            halos[f"corner{s_}"] = got[0] if got is not None \
                else pool(f"c{s_}", _slab(nr, o, 0))
    edge_next = [comm.is_last(ax) for ax in range(opts.ndim)] \
        if mirror else None
    return halos, edge_next, scratch


def _plain_mesh_step(orig, recon, accs, ds, rho, lambda_inv, lam_mu,
                     opts: SolverOptions, comm):
    """One iteration of the plain spec on a mesh shard, in place: the dual
    updates with the -1 neighbours' recon slabs (``comm.prev_halo``), then
    the reconstruction with the +1 neighbours' updated accumulator slabs
    (``comm.next_halo``), as ``engine.py:76-135, :384-393`` run it: per-axis
    or half-isotropic pairs, on a ring under periodic boundaries, the
    cube's slab 1 and the own updated last slab at mirror edges.
    Returns the shard's ``(bnorm, dnum, dden)``. It is kept apart from
    ``fused_iteration_reference`` with :func:`_k1_halos` on purpose: the
    exchange after the dual update needs no seam recomputation, so
    ``backend="torch"`` on a mesh is a witness independent of the kernels'
    pre-update halos."""
    bc = opts.bc_mode
    ndim = opts.ndim
    prev = [comm.prev_halo(recon, ax) for ax in range(ndim)]
    bnorm = torch.zeros((), dtype=orig.dtype, device=orig.device)

    def aniso(ax):
        if ds is not None:
            b, d, n = ops.accumulator_update_fista(
                recon, accs[ax], ds[ax], rho, ax, lambda_inv[ax], bc,
                halo_prev=prev[ax])
            ds[ax].copy_(d)
        else:
            b, n = ops.accumulator_update(recon, accs[ax], ax, lambda_inv[ax],
                                          bc, halo_prev=prev[ax])
        accs[ax].copy_(b)
        return n

    def iso(ax1, ax2):
        if ds is not None:
            b1, b2, d1, d2, n = ops.iso_accumulator_update_fista(
                recon, accs[ax1], accs[ax2], ds[ax1], ds[ax2], rho,
                ax1, ax2, lambda_inv[ax1], prev[ax1], prev[ax2])
            ds[ax1].copy_(d1)
            ds[ax2].copy_(d2)
        else:
            b1, b2, n = ops.iso_accumulator_update(
                recon, accs[ax1], accs[ax2], ax1, ax2, lambda_inv[ax1],
                prev[ax1], prev[ax2])
        accs[ax1].copy_(b1)
        accs[ax2].copy_(b2)
        return n

    if ndim == 4:
        norms = [iso(0, 1)] if opts.isotropic_R else [aniso(0), aniso(1)]
        norms += [iso(2, 3)] if opts.isotropic_Q else [aniso(2), aniso(3)]
    else:
        norms = [aniso(ax) for ax in range(3)]
    for n in norms:
        bnorm = bnorm + n
    nxt = [comm.next_halo(accs[ax], ax) for ax in range(ndim)]
    recon_new, dnum, dden = ops.datacube_update(orig, recon, accs, lam_mu, bc,
                                                halos_next=nxt)
    recon.copy_(recon_new)
    return bnorm, dnum, dden


def iteration_step(
    orig: Tensor,
    recon: Tensor,
    accs: List[Tensor],
    ds: Optional[List[Tensor]],
    rho: Optional[Tensor],
    lambda_inv: Tensor,
    lam_mu: Tensor,
    opts: SolverOptions,
    comm=None,
):
    """One full TV iteration, in place; returns ``(bnorm, delta)``.

    ``Backend.TORCH`` runs the plain spec on any device; otherwise the
    fused iteration runs — the CUDA kernel on a CUDA tensor, the plain spec
    on a CPU tensor. With ``comm`` the cube is a mesh shard: the fused
    iteration takes the operand halos of :func:`_k1_halos` (the plain spec
    the ``prev_halo``/``next_halo`` slabs) and the sums are all-reduced.
    """
    if comm is not None:
        if opts.backend == Backend.TORCH:
            bnorm, dnum, dden = _plain_mesh_step(
                orig, recon, accs, ds, rho, lambda_inv, lam_mu, opts, comm)
        else:
            halos, edge_next, scratch = _k1_halos(comm, opts, recon, accs, ds)
            _, _, _, bnorm, dnum, dden = fused_iteration(
                orig, recon, accs, ds, rho, lambda_inv, lam_mu,
                fista=ds is not None, bc=int(opts.bc_mode),
                iso_r=opts.isotropic_R, iso_q=opts.isotropic_Q,
                halos=halos, edge_next=edge_next, scratch=scratch)
        bnorm, dnum, dden = comm.allsum(torch.stack((bnorm, dnum, dden)))
        return bnorm, dnum / dden
    step = fused_iteration_reference if opts.backend == Backend.TORCH \
        else fused_iteration
    _, _, _, bnorm, dnum, dden = step(
        orig, recon, accs, ds, rho, lambda_inv, lam_mu,
        fista=ds is not None, bc=int(opts.bc_mode),
        iso_r=opts.isotropic_R, iso_q=opts.isotropic_Q)
    return bnorm, dnum / dden


@dataclasses.dataclass
class _PhaseState:
    i: int                        # global iteration/trace index
    done: bool                    # early-stop latch
    recon: Tensor
    accs: List[Tensor]
    ds: Optional[List[Tensor]]    # shadow duals, FISTA phase only
    b_norm: Tensor                # full-length trace
    delta: Tensor                 # full-length trace
    mse: Optional[Tensor]         # full-length (+1) trace
    tk: Tensor                    # float32 momentum (fista_restart only)
    # block-checkpoint buffers allocated before a mesh run's first
    # collective (recon, n accumulators [, n shadow duals], then the
    # traces); None: ``_run_blocks`` allocates them per phase
    ckpt: Optional[List[Tensor]] = None


def _run_phase(
    fista: bool,
    i_bound: int,
    st: _PhaseState,
    orig: Tensor,
    tk_ratios: Tensor,
    lambda_inv: Tensor,
    lam_mu: Tensor,
    opts: SolverOptions,
    reference_data: Optional[Tensor],
    comm=None,
) -> None:
    """Advance ``st`` through one phase (FISTA or unaccelerated) up to the
    global index ``i_bound`` or the stop, as ``cytvdn_tpu``'s
    ``_run_phase`` does (``engine.py:409-485``); on a mesh shard
    (``comm``) with the summed traces and SSE."""
    stopping = opts.stopping_relative_change
    restart = fista and opts.fista_restart
    while st.i < i_bound and not st.done:
        i = st.i
        if restart:
            # device-side momentum with adaptive restart, in float32
            tk_new = (1.0 + torch.sqrt(1.0 + 4.0 * st.tk * st.tk)) / 2.0
            rho = ((st.tk - 1.0) / tk_new).to(orig.dtype)
        elif fista:
            rho = tk_ratios[i]
        else:
            rho = None
        bnorm, delta = iteration_step(
            orig, st.recon, st.accs, st.ds if fista else None, rho,
            lambda_inv, lam_mu, opts, comm)
        st.b_norm[i] = bnorm
        st.delta[i] = delta
        if opts.calculate_mse:
            sse = ops.sum_square_error(reference_data, st.recon)
            st.mse[i + 1] = sse if comm is None else comm.allsum(sse)
        if stopping is not None:
            st.done = bool(delta < stopping)  # the one host sync
        if restart:
            prev = st.delta[i - 1].float() if i > 0 \
                else torch.full((), float("inf"), device=orig.device)
            st.tk = torch.where(delta.float() > prev,
                                torch.ones_like(tk_new), tk_new.float())
        st.i = i + 1


def _resolve_temporal(opts: SolverOptions, shape, dtype) -> bool:
    """Whether the phases may run in pairs through the pair kernel, as
    ``cytvdn_tpu``'s ``_resolve_temporal`` (``engine.py:488-543``) decides
    on one device: ``temporal_pairs`` on, a backend other than ``TORCH``
    (the JAX gate needs the fused kernel), no ``fista_restart``, no iso
    pairs, Jia-Zhao, and :func:`pair_supported` (with ``calculate_mse``,
    the kernel's reference-cube SSE). Stop-aware runs pair too, behind the
    guard (:func:`_run_blocks`). Pairing changes no result: the state is
    bitwise that of two one-iteration steps, lossy runs included: the pair
    kernel rounds iteration 1's bfloat16 duals in the middle of the pair,
    as the JAX engine's pairs do (``engine.py:1332-1348``). (What
    :func:`pair_supported` admits, the fused kernel covers too.)"""
    if not opts.temporal_pairs or opts.backend == Backend.TORCH:
        return False
    if opts.fista_restart or opts.isotropic_R or opts.isotropic_Q:
        return False
    if opts.bc_mode != BCMode.JIA_ZHAO:
        return False
    return pair_supported(shape, dtype, opts.bc_mode,
                          with_mse=opts.calculate_mse)


#: the least bytes of one array's axis-0 slab (a row of the pair kernel's
#: wavefront) at which the phases run in pairs: the measured crossing. On
#: the H100 (PERF.md §6, the strip and dispatch sweeps; NVIDIA H100 80GB
#: HBM3, 700 W) ``run_solver`` in pairs took 9% less time than the
#: one-iteration loop at 16 MiB rows (config 4), tied with it at 8 MiB
#: (from 1.2% less to 0.3% more in three calls, the spread between calls),
#: and
#: took 0.3-12% more at 2 and 4 MiB rows.
PAIR_MIN_ROW_BYTES = 8 * 2**20


def _pairs_pay(shape, dtype) -> bool:
    """Whether pairs beat the one-iteration loop on this shape: one array's
    axis-0 slab is at least :data:`PAIR_MIN_ROW_BYTES`. A throughput rule of
    the H100 port, kept apart from :func:`_resolve_temporal`, which is the
    JAX gate; the result is bitwise the same either way."""
    row = dtype.itemsize
    for e in shape[1:]:
        row *= e
    return row >= PAIR_MIN_ROW_BYTES


def _orig_bands(comm, orig: Tensor, ax: int):
    """The neighbours' orig slabs of the pair's bands of split axis ``ax``
    (the -1 shard's slab -1, ``p_orig`` or ``p_orig_m1``; the +1 shard's
    slab 0, ``n_orig`` or ``n_orig_c0``) in one exchange: orig never
    changes, so a phase exchanges them once."""
    got_p, got_n = comm.exchange_pieces(
        ax, [orig.narrow(ax, orig.shape[ax] - 1, 1)], [orig.narrow(ax, 0, 1)],
        name=f"pair_orig{ax}")
    keys = ("p_orig", "n_orig") if ax == 0 else ("p_orig_m1", "n_orig_c0")
    return {k: got[0] for k, got in zip(keys, (got_p, got_n))
            if got is not None}


def _pair_halos0(comm, orig_bands, recon: Tensor, accs: List[Tensor],
                 ds: Optional[List[Tensor]]):
    """The pair kernel's axis-0 bands on an axis-0 mesh
    (``engine.py:1027-1071``), from the neighbours' pre-update state in one
    packed exchange per direction: to the +1 neighbour the own rows [-2, -1]
    of recon and row -1 of every accumulator [and shadow dual]; to the -1
    neighbour rows [0, 1] of recon, rows 0 and 1 of the axis-0 accumulator
    [and shadow dual] and row 0 of the others; with ``orig_bands``
    (:func:`_orig_bands`). Returns ``(halos0, first0, last0)``; a missing
    neighbour's bands are left out, as the kernel never reads them
    (``first0``/``last0``).

    Under lossy duals the bfloat16 d rows widen exactly to the data's
    dtype as they are packed into the exchange's buffer (whose dtype is
    recon's, the first piece's), as in :func:`_k1_halos`: the message keeps
    one dtype and the kernel's ``_d`` bands are float32."""
    nd = recon.dim()
    to_next = [recon[-2:], *(a[-1:] for a in accs)]
    to_prev = [recon[:2], accs[0][:1], accs[0][1:2],
               *(a[:1] for a in accs[1:])]
    if ds is not None:
        to_next += [d[-1:] for d in ds]
        to_prev += [ds[0][:1], ds[0][1:2], *(d[:1] for d in ds[1:])]
    got_p, got_n = comm.exchange_pieces(
        0, to_next, to_prev, name="pair" if ds is None else "pair_d")
    h = dict(orig_bands)
    if got_p is not None:
        h["p_r0"] = got_p[0]
        for k in range(nd):
            h[f"p_acc{k}"] = got_p[1 + k]
            if ds is not None:
                h[f"p_d{k}"] = got_p[1 + nd + k]
    if got_n is not None:
        h["n_r0"], h["n_acc0"], h["n_acc0_r1"] = got_n[:3]
        for k in range(1, nd):
            h[f"n_acc{k}"] = got_n[2 + k]
        if ds is not None:
            base = 2 + nd
            h["n_d0"], h["n_d0_r1"] = got_n[base], got_n[base + 1]
            for k in range(1, nd):
                h[f"n_d{k}"] = got_n[base + 1 + k]
    return h, comm.is_first(0), comm.is_last(0)


def _pair_halos1(comm, orig_bands, recon: Tensor, accs: List[Tensor],
                 ds: Optional[List[Tensor]]):
    """The pair kernel's axis-1 bands on an axis-1 mesh
    (``engine.py:995-1022``), from the neighbours' pre-update state in one
    packed exchange per direction: to the +1 neighbour the own columns
    [-2, -1] of recon and column -1 of every accumulator [and shadow dual];
    to the -1 neighbour columns [0, 1] of recon, column 0 of every
    accumulator and column 1 of the axis-1 one [and the same of the shadow
    duals]; with ``orig_bands`` (:func:`_orig_bands`). Returns
    ``(halos1, first1, last1)``; a missing neighbour's bands are left out.
    Bfloat16 d columns widen exactly into the exchange's float32 buffer, as
    in :func:`_pair_halos0`."""
    nd = recon.dim()
    to_next = [recon[:, -2:-1], recon[:, -1:], *(a[:, -1:] for a in accs)]
    to_prev = [recon[:, :1], recon[:, 1:2], *(a[:, :1] for a in accs),
               accs[1][:, 1:2]]
    if ds is not None:
        to_next += [d[:, -1:] for d in ds]
        to_prev += [*(d[:, :1] for d in ds), ds[1][:, 1:2]]
    got_p, got_n = comm.exchange_pieces(
        1, to_next, to_prev, name="pair1" if ds is None else "pair1_d")
    h = dict(orig_bands)
    if got_p is not None:
        h["p_r0_m2"], h["p_r0_m1"] = got_p[:2]
        for k in range(nd):
            h[f"p_acc{k}_m1"] = got_p[2 + k]
            if ds is not None:
                h[f"p_d{k}_m1"] = got_p[2 + nd + k]
    if got_n is not None:
        h["n_r0_c0"], h["n_r0_c1"] = got_n[:2]
        for k in range(nd):
            h[f"n_acc{k}_c0"] = got_n[2 + k]
        h["n_acc1_c1"] = got_n[2 + nd]
        if ds is not None:
            for k in range(nd):
                h[f"n_d{k}_c0"] = got_n[3 + nd + k]
            h["n_d1_c1"] = got_n[3 + 2 * nd]
    return h, comm.is_first(1), comm.is_last(1)


def _pair_axis(comm) -> Optional[int]:
    """The split axis whose bands a mesh shard's pairs take (0 or 1; 0 on
    a 2D grid), or None without a split axis."""
    split = tuple(comm.split_axes) if comm is not None else ()
    return split[0] if split else None


def _grid2d(comm) -> bool:
    """Whether ``comm`` is a 2D grid, split on axes 0 and 1 alone: its
    pairs take the axis-0 bands and the seam repair
    (``parallel/pairfix.py``)."""
    return comm is not None and set(comm.split_axes) == {0, 1}


def _pair_stash(comm, orig: Tensor, ax: int = 0) -> Tensor:
    """The pair kernel's scratch of a mesh shard, from ``comm``'s buffer
    pool: on an axis-0 mesh two rows (the +1 shard's recomputed row-0 b_0
    and d_0), on an axis-1 mesh two column slabs (its column-0 b_1 and
    d_1)."""
    if ax == 0:
        return comm.buffer("pair_stash", (2,) + tuple(orig.shape[1:]),
                           orig.dtype, orig.device)
    return comm.buffer("pair_stash1", (2, orig.shape[0], 1)
                       + tuple(orig.shape[2:]), orig.dtype, orig.device)


def _pair_bands(comm, orig: Tensor, ax: int):
    """The per-phase part of a mesh shard's pair bands (the orig slabs) and
    the function that assembles a launch's bands: axis-0 (``halos0``) or
    axis-1 (``halos1``) keywords of :func:`fused_pair_iteration`, with the
    stash."""
    orig_bands = _orig_bands(comm, orig, ax)
    halos = _pair_halos0 if ax == 0 else _pair_halos1

    def kwargs(recon, accs, ds):
        h, first, last = halos(comm, orig_bands, recon, accs, ds)
        return {f"halos{ax}": h, f"first{ax}": first, f"last{ax}": last,
                "stash": _pair_stash(comm, orig, ax)}

    return kwargs


def _run_phase_paired(
    fista: bool,
    i_bound: int,
    st: _PhaseState,
    orig: Tensor,
    tk_ratios: Tensor,
    lambda_inv: Tensor,
    lam_mu: Tensor,
    opts: SolverOptions,
    reference_data: Optional[Tensor],
    comm=None,
) -> None:
    """Advance ``st`` two iterations per pair-kernel launch, for
    ``floor((i_bound - i) / 2)`` pairs, recording both iterations' trace
    entries as the one-iteration loop would (``cytvdn_tpu``'s
    ``_run_phase_paired``, ``engine.py:897-1183``); with ``calculate_mse``
    the launch takes the reference cube and records both iterations' SSE.
    On an axis-0 or axis-1 mesh (``comm``) each launch takes the
    neighbours' bands (:func:`_pair_halos0`, :func:`_pair_halos1`) and its
    sums are all-reduced. On a 2D grid (axes 0 and 1 split) each launch
    takes the axis-0 bands, and ``parallel/pairfix.py`` repairs its axis-1
    seams and corrects its sums before the all-reduce
    (``engine.py:1085-1097``): the pre-pair edge columns are exchanged
    before the launch, orig's once per phase.
    The caller's :func:`_run_phase` finishes an odd remainder. Without
    ``stopping_relative_change`` nothing here waits for the device (on one
    device); with it the pairs run behind a guard of horizon 4 in
    checkpointed blocks (:func:`_run_blocks`)."""
    ref = reference_data if opts.calculate_mse else None
    ax = _pair_axis(comm)
    bands = _pair_bands(comm, orig, ax) if ax is not None else None
    oc = None
    if _grid2d(comm):
        from cytvdn_tpu_torch.parallel import pairfix

        oc = pairfix.orig_columns(comm, orig)

    def launch(i):
        rho1, rho2 = (tk_ratios[i], tk_ratios[i + 1]) if fista \
            else (None, None)
        ds = st.ds if fista else None
        kw = bands(st.recon, st.accs, ds) if bands is not None else {}
        pre = pairfix.edge_columns(comm, st.recon, st.accs, ds) \
            if oc is not None else None
        out = fused_pair_iteration(
            orig, st.recon, st.accs, ds, rho1, rho2,
            lambda_inv, lam_mu, fista=fista, ref=ref, **kw)
        sums = out[3:]
        if comm is not None:
            sums = torch.stack(sums)
            if pre is not None:
                sums = pairfix.repair_axis1_seams(
                    comm, oc, pre, st.recon, st.accs, ds, rho1, rho2,
                    lambda_inv, lam_mu, sums, ref)
            sums = comm.allsum(sums).unbind()
        st.b_norm[i] = sums[0]
        st.b_norm[i + 1] = sums[3]
        deltas = torch.stack((sums[1] / sums[2], sums[4] / sums[5]))
        st.delta[i:i + 2] = deltas
        if ref is not None:
            # the one-iteration loop records the SSE after iteration i at
            # i + 1
            st.mse[i + 1] = sums[6]
            st.mse[i + 2] = sums[7]
        return deltas

    if opts.stopping_relative_change is not None:
        _run_blocks(fista, i_bound, st, orig, tk_ratios, lambda_inv, lam_mu,
                    opts, reference_data, 2, 4, launch, comm)
        return
    while st.i + 2 <= i_bound:
        launch(st.i)
        st.i += 2


def _resolve_kstep(opts: SolverOptions, shape, dtype, fista: bool) -> int:
    """The K-step depth of a phase, or 0 to leave it to the pairs, as
    ``cytvdn_tpu``'s ``_resolve_kstep`` (``engine.py:546-570``) decides on
    one device: ``temporal_kstep`` on, the pair gate
    (:func:`_resolve_temporal`), no ``calculate_mse`` (the K-step kernel
    has no SSE), and :func:`best_kstep` with ``temporal_k``. Lossy runs
    K-step too, as in the JAX engine: the kernel rounds every level's
    bfloat16 duals (its ``LOSSY`` instantiations). It depends on the shape,
    dtype and options only, never on the device."""
    if not opts.temporal_kstep or opts.calculate_mse:
        return 0
    if not _resolve_temporal(opts, shape, dtype):
        return 0
    return best_kstep(shape, dtype, opts.bc_mode, fista,
                      forced=opts.temporal_k)


def _run_phase_kstep(
    fista: bool,
    i_bound: int,
    st: _PhaseState,
    orig: Tensor,
    tk_ratios: Tensor,
    lambda_inv: Tensor,
    lam_mu: Tensor,
    opts: SolverOptions,
    reference_data: Optional[Tensor],
    k: int,
) -> None:
    """Advance ``st`` K iterations per K-step launch, for
    ``floor((i_bound - i) / k)`` launches, recording the K trace entries
    as the one-iteration loop would (``cytvdn_tpu``'s
    ``_run_phase_kstep``, ``engine.py:573-700``). The pairs and the
    one-iteration loop finish the remainder. Without
    ``stopping_relative_change`` nothing here waits for the device; with
    it the launches run behind a guard of horizon 2K in checkpointed
    blocks (:func:`_run_blocks`)."""
    def launch(i):
        _, _, _, bn, dnum, dden = fused_kstep_iteration(
            orig, st.recon, st.accs, st.ds if fista else None,
            tk_ratios[i:i + k] if fista else None, lambda_inv, lam_mu,
            k=k, fista=fista)
        deltas = dnum / dden
        st.b_norm[i:i + k] = bn
        st.delta[i:i + k] = deltas
        return deltas

    if opts.stopping_relative_change is not None:
        _run_blocks(fista, i_bound, st, orig, tk_ratios, lambda_inv, lam_mu,
                    opts, reference_data, k, 2 * k, launch)
        return
    while st.i + k <= i_bound:
        launch(st.i)
        st.i += k


def _resident_gates(opts: SolverOptions, shape, dtype) -> bool:
    """The gate ladder the whole-run kernel's two serving modes (whole run
    and stop-aware chunks) share, as ``cytvdn_tpu``'s ``_resident_gates``
    (``engine.py:703-739``) decides on one device: ``vmem_resident`` on,
    exact duals, a backend other than ``TORCH``, no ``fista_restart``, and
    :func:`resident_supported`, whose size rule is the H100's own. It
    depends on the shape, dtype and options only, never on the device."""
    if not opts.vmem_resident or opts.lossy_duals:
        return False
    if opts.backend == Backend.TORCH or opts.fista_restart:
        return False
    return resident_supported(shape, dtype, opts.bc_mode,
                              fista=opts.iterations_fista > 0,
                              isotropic_R=opts.isotropic_R,
                              isotropic_Q=opts.isotropic_Q,
                              with_mse=opts.calculate_mse)


def _resolve_resident(opts: SolverOptions, shape, dtype) -> bool:
    """Whether the whole schedule runs as one whole-run launch
    (``engine.py:742-754``): runs without ``stopping_relative_change``
    that pass :func:`_resident_gates`."""
    if opts.stopping_relative_change is not None:
        return False
    return _resident_gates(opts, shape, dtype)


#: iterations per whole-run launch in stop-aware runs (``engine.py:760``):
#: enough to amortize the launch and the host sync, few enough that the
#: guard's look-ahead stays sharp
_RESIDENT_CHUNK = 16


def _resolve_resident_chunks(opts: SolverOptions, shape, dtype) -> bool:
    """Whether the phases may advance through whole-run launches with the
    state handed in (``engine.py:769-789``): a schedule of at least
    ``_RESIDENT_CHUNK`` iterations and :func:`_resident_gates`. They serve
    (a) stop-aware runs, ``_RESIDENT_CHUNK`` iterations per launch behind
    the guard, and (b) capped or resumed runs (``i_stop``, ``state``),
    one launch per phase and call."""
    if opts.total_iterations < _RESIDENT_CHUNK:
        return False
    return _resident_gates(opts, shape, dtype)


def _history_bound(st: _PhaseState, i_bound: int) -> int:
    """Where the one-iteration prologue of a stop-aware phase ends
    (``_paired_history_stop``, ``engine.py:1288-1299``): at ``st.i`` when
    the two deltas before it are recorded and positive, else two
    iterations later, so the guard never decides blind."""
    i = st.i
    hist = i >= 2 and all(d > 0 for d in st.delta[i - 2:i].tolist())
    return min(i_bound, i if hist else i + 2)


def _guard_allows(d1: float, d2: float, stopping: float,
                  horizon: int) -> bool:
    """The predictive guard of a launch (``engine.py:834-848`` for a
    whole-run chunk, ``:617-625`` for a K-step launch, ``:959-975`` for a
    pair), in float32 as there: the last two deltas are positive and
    ``d1·r^horizon`` with ``r = clip(d1/d2, 0, 1)`` stays at or above the
    threshold, so the threshold is not expected to be crossed within the
    next launch. The horizon is twice the launch's iterations (the decay
    rate doubling in log terms): 2T for a chunk, 2K for a K-step launch, 4
    for a pair."""
    d1, d2 = np.float32(d1), np.float32(d2)
    if not (d1 > 0 and d2 > 0):
        return False
    r = np.float32(min(max(d1 / d2, np.float32(0)), np.float32(1)))
    # r ** horizon by repeated squaring, as lax.integer_pow computes it
    p, n = None, horizon
    while n:
        if n & 1:
            p = r if p is None else np.float32(p * r)
        n >>= 1
        if n:
            r = np.float32(r * r)
    return bool(np.float32(d1 * p) >= np.float32(stopping))


#: pairs per block of a stop-aware phase (``engine.py:766``): the state is
#: checkpointed once per block of ``2 * _STOP_CKPT_PAIRS`` iterations, and
#: a beaten guard sends at most that many iterations back to the next
#: phases
_STOP_CKPT_PAIRS = 16


def _ckpt_buffers(st: _PhaseState, live: List[Tensor]) -> List[Tensor]:
    """Buffers like ``live`` (the cubes, then the traces) for a block
    checkpoint: those allocated up front (``st.ckpt``, the FISTA phase's
    full set, of which an unaccelerated phase takes its cubes and the
    traces), or new ones."""
    if st.ckpt is None:
        return [torch.empty_like(x) for x in live]
    n_cubes = sum(x.dim() > 1 for x in live)
    n_traces = len(live) - n_cubes
    return st.ckpt[:n_cubes] + st.ckpt[len(st.ckpt) - n_traces:]


def _run_blocks(fista, i_bound, st, orig, tk_ratios, lambda_inv, lam_mu,
                opts, reference_data, k, horizon, launch, comm=None) -> None:
    """The stop-aware loop of the whole-run chunk (``k`` = T), K-step
    (``k`` = K) and pair (``k`` = 2) phases, as ``cytvdn_tpu``'s
    ``_run_phase_kstep`` and ``_run_phase_paired`` run it
    (``engine.py:588-700, 920-949, 1148-1183``): ``launch(i)`` advances the
    state ``k`` iterations from ``i``, records their traces and returns
    their deltas on the device.

    Launches run where :func:`_guard_allows` (horizon ``horizon``) says the
    threshold is not crossed within the launch, in blocks of
    ``2 * _STOP_CKPT_PAIRS`` iterations: before a block's first launch,
    recon, the accumulators [, the shadow duals] and the traces are copied
    into buffers allocated once per phase. After each launch one host read
    of its deltas: a crossing at the last latches ``done``, so the run ends
    at the converging iteration; a crossing at an earlier one (the guard
    beaten) restores the block's checkpoint, leaves ``st.i`` where the
    block began and ends the phase, so the next phases (at the last, the
    one-iteration loop) redo those iterations with their exact stop.

    Where the guard refuses, one exact one-iteration step runs (and closes
    the block) and the guard is asked again, until fewer than ``k``
    iterations are left: the fast early decay of a run would otherwise end
    the launches before its slow tail, where they pay. (The JAX engine
    hands over to the next phase at the first refusal.) The state and
    traces are bitwise those of the one-iteration loop in every case.

    On a mesh shard every decision reads the all-reduced deltas, so every
    rank takes the same branch; the checkpoint buffers are those the run
    allocated before its first collective (``st.ckpt``)."""
    stopping = opts.stopping_relative_change
    if st.done or st.i < 2 or st.i + k > i_bound:
        return
    d2, d1 = st.delta[st.i - 2:st.i].tolist()
    live = [st.recon, *st.accs] + (list(st.ds) if fista else []) \
        + [st.b_norm, st.delta] + ([st.mse] if st.mse is not None else [])
    ckpt = _ckpt_buffers(st, live)
    start = limit = st.i
    while st.i + k <= i_bound and not st.done:
        i = st.i
        if not _guard_allows(d1, d2, stopping, horizon):
            _run_phase(fista, i + 1, st, orig, tk_ratios, lambda_inv, lam_mu,
                       opts, reference_data, comm)
            d2, d1 = d1, st.delta[i].item()
            limit = st.i
            continue
        if i >= limit:
            for c, x in zip(ckpt, live):
                c.copy_(x)
            start, limit = i, i + 2 * _STOP_CKPT_PAIRS
        host = launch(i).cpu()  # the launch's one host sync
        if bool((host[:k - 1] < stopping).any()):
            for c, x in zip(ckpt, live):
                x.copy_(c)
            st.i = start
            return
        st.i = i + k
        st.done = bool(host[k - 1] < stopping)
        d2, d1 = host[-2:].tolist()


def _run_phase_resident(
    fista: bool,
    i_bound: int,
    st: _PhaseState,
    orig: Tensor,
    tk_ratios: Tensor,
    lambda_inv: Tensor,
    lam_mu: Tensor,
    opts: SolverOptions,
    reference_data: Optional[Tensor],
) -> None:
    """Advance a phase through whole-run launches on the state in place
    (``cytvdn_tpu``'s ``_run_phase_resident``, ``engine.py:792-894``).

    A stop-aware phase goes ``_RESIDENT_CHUNK`` iterations per launch
    behind the guard of horizon 2T, in the checkpointed blocks of
    :func:`_run_blocks`; the gate keeps the state, and so its checkpoint,
    small. (The JAX engine also discards a chunk whose last delta crosses;
    here that latches the stop, as the K-step and pair phases do. The
    result is bitwise the same.) A capped run without a stop makes one
    launch up to ``i_bound``: the kernel takes any iteration count, where
    the JAX engine's jit needs fixed 16-iteration launches and finishes
    the remainder in pairs and single steps."""
    ref = reference_data if opts.calculate_mse else None

    def launch(i, n=_RESIDENT_CHUNK):
        out = resident_solve(
            orig, st.recon, st.accs, st.ds if fista else None,
            tk_ratios[i:i + n] if fista else None, lambda_inv, lam_mu,
            n_iters=n, fista=fista, bc=int(opts.bc_mode), ref=ref,
            iso_r=opts.isotropic_R, iso_q=opts.isotropic_Q)
        deltas = out[4] / out[5]
        st.b_norm[i:i + n] = out[3]
        st.delta[i:i + n] = deltas
        if ref is not None:
            st.mse[i + 1:i + n + 1] = out[6]
        return deltas

    if opts.stopping_relative_change is None:
        if st.i < i_bound:
            launch(st.i, i_bound - st.i)
            st.i = i_bound
        return
    T = _RESIDENT_CHUNK
    _run_blocks(fista, i_bound, st, orig, tk_ratios, lambda_inv, lam_mu,
                opts, reference_data, T, 2 * T, launch)


#: the most bytes a stop-aware run's state, block checkpoint and reference
#: cube (:func:`stop_ckpt_bytes`) may take for its K-step and pair phases;
#: above it the run stays on the one-iteration loop. Config 4 (256²×128²
#: FISTA) takes 19 cubes of 4 GiB, 76 GiB: its stop run peaked at 76.008
#: GiB (``torch.cuda.max_memory_allocated``) of the card's 79.179 GiB
#: (``chip_smoke.py`` phase 5; NVIDIA H100 80GB HBM3, 700 W). A reference
#: cube more (80 GiB) does not fit.
STOP_CKPT_MAX_BYTES = 76 * 2**30


def stop_ckpt_bytes(opts: SolverOptions, shape, dtype) -> int:
    """Device bytes of a stop-aware temporal run: the state (orig, recon,
    n accumulators [, n shadow duals]), its block checkpoint (recon, n
    accumulators [, n shadow duals]) [, the reference cube]; lossy shadow
    duals at 2 bytes. It depends on the shape, dtype and options only."""
    n = len(shape)
    cubes = 1 + 2 * (1 + n) + int(opts.calculate_mse)
    vox = 1
    for e in shape:
        vox *= e
    d_bytes = 2 * n * vox * d_dtype(opts, dtype).itemsize \
        if opts.iterations_fista else 0
    return cubes * vox * dtype.itemsize + d_bytes


def _plan(opts: SolverOptions, shape, dtype, comm=None):
    """The phases' kernels: ``(temporal, paired, chunks)``. ``temporal``:
    the K-step and pair phases may run (:func:`_resolve_temporal`; a
    stop-aware run only where :func:`stop_ckpt_bytes` is within
    :data:`STOP_CKPT_MAX_BYTES`); ``paired``: the pairs pay
    (:func:`_pairs_pay`); ``chunks``: whole-run launches on the state
    (:func:`_resolve_resident_chunks`). On a mesh shard (``comm``, ``shape``
    the shard's) there are no whole-run launches and no K-steps
    (:func:`_run_phases`), and pairs on a mesh split along axis 0 alone
    (``halos0``) or along axis 1 alone with shards of 2 columns or more
    (``halos1``), as the JAX gate decides (``engine.py:510-517``). A 2D
    grid (axes 0 and 1 split) pairs, with ``halos0`` and the seam repair,
    only where ``parallel/pairfix.py::can_pair`` allows, which by default
    it does not: there the K=1 loop, whose state is the same, took less
    time. Meshes that split axis 2 or 3 run the K=1 loop. Shape, dtype,
    options and the mesh's split axes only, so every rank of an evenly
    tiled mesh plans alike."""
    temporal = _resolve_temporal(opts, shape, dtype) and (
        opts.stopping_relative_change is None
        or stop_ckpt_bytes(opts, shape, dtype) <= STOP_CKPT_MAX_BYTES)
    if comm is not None:
        split = set(comm.split_axes)
        if split == {0, 1}:
            from cytvdn_tpu_torch.parallel import pairfix

            temporal = temporal and pairfix.can_pair(shape)
        else:
            temporal = temporal and (split <= {0}
                                     or split == {1} and shape[1] >= 2)
        return temporal, temporal and _pairs_pay(shape, dtype), False
    paired = temporal and _pairs_pay(shape, dtype)
    chunks = _resolve_resident_chunks(opts, shape, dtype)
    return temporal, paired, chunks


def holds_block_checkpoint(opts: SolverOptions, shape, dtype,
                           comm=None) -> bool:
    """Whether a run keeps a block checkpoint of its state (recon, the
    accumulators [, the shadow duals]) beside it: a stop-aware run whose
    phases go through :func:`_run_blocks`."""
    if opts.stopping_relative_change is None:
        return False
    temporal, paired, chunks = _plan(opts, shape, dtype, comm)
    if comm is not None:
        return paired
    return chunks or paired or temporal and any(
        _resolve_kstep(opts, shape, dtype, f)
        for f, n in ((True, opts.iterations_fista),
                     (False, opts.iterations_unacc)) if n)


def _run_phases(
    st: _PhaseState,
    orig: Tensor,
    tk_ratios: Tensor,
    lambda_inv: Tensor,
    lam_mu: Tensor,
    opts: SolverOptions,
    reference_data: Optional[Tensor],
    i_stop: int,
    keep_state: bool,
    comm=None,
) -> None:
    """The FISTA phase, then the unaccelerated one, each up to ``i_stop``
    as: the one-iteration prologue of a stop-aware run (where it has
    whole-run chunks or temporal phases), whole-run launches (stop-aware
    chunks, or one per phase in a capped run), K-step launches, pairs
    (where :func:`_pairs_pay`), and the one-iteration loop for the rest
    (``engine.py:1498-1596``); no launch crosses the cap. A FISTA phase
    cut short by the cap (not by the stop) keeps its index, and the
    unaccelerated phase waits for the next call. With ``keep_state`` the
    shadow duals stay in ``st``, frozen through the unaccelerated phase,
    as the JAX engine returns them. On a mesh shard (``comm``) the phases
    are the prologue, the pairs of an axis-0 or axis-1 mesh and the K=1
    loop."""
    n_f, n_u = opts.iterations_fista, opts.iterations_unacc
    n_total = n_f + n_u
    shape, dtype = tuple(orig.shape), orig.dtype
    stopping = opts.stopping_relative_change
    temporal, paired, chunks = _plan(opts, shape, dtype, comm)
    ds = st.ds
    for fista, i_bound, n in ((True, n_f, n_f), (False, n_total, n_u)):
        if not n:
            continue
        bound = min(i_bound, i_stop)
        if stopping is not None and (temporal or chunks):
            _run_phase(fista, _history_bound(st, bound), st, orig,
                       tk_ratios, lambda_inv, lam_mu, opts, reference_data,
                       comm)
        if chunks:
            _run_phase_resident(fista, bound, st, orig, tk_ratios,
                                lambda_inv, lam_mu, opts, reference_data)
        k = _resolve_kstep(opts, shape, dtype, fista) \
            if temporal and comm is None else 0
        if k:
            _run_phase_kstep(fista, bound, st, orig, tk_ratios, lambda_inv,
                             lam_mu, opts, reference_data, k)
        if paired:
            _run_phase_paired(fista, bound, st, orig, tk_ratios, lambda_inv,
                              lam_mu, opts, reference_data, comm)
        _run_phase(fista, bound, st, orig, tk_ratios, lambda_inv, lam_mu,
                   opts, reference_data, comm)
        if fista:
            st.ds = None  # the unaccelerated phase carries no shadow duals
            if not st.done and st.i < n_f:
                break  # capped mid-FISTA: the next call resumes it
            if n_u:
                # the second phase starts at its own first index and
                # ignores the first phase's stop (reference
                # cyTVDN.py:195-201)
                st.i = max(st.i, n_f)
                st.done = False
    if keep_state:
        st.ds = ds


def check_mesh(opts: SolverOptions, comm, shape) -> None:
    """Check a mesh run: the comm's boundary is the run's, and a mirror
    mesh's every axis holds at least two slabs of the cube (the mirror's
    backward edge reads slab 1). Every mode of the JAX package's sharded
    K=1 path is ported; its folded 3D energy axis is a TPU layout
    (ROADMAP "Not to port")."""
    if BCMode(comm.bc) != opts.bc_mode:
        raise ValueError(f"the mesh's MeshComm has bc {BCMode(comm.bc)!r}, "
                         f"the run {opts.bc_mode!r}")
    if opts.bc_mode == BCMode.MIRROR:
        for ax, e in enumerate(shape):
            if e * comm.size(ax) < 2:
                raise ValueError(f"mirror boundaries need 2 slabs along "
                                 f"axis {ax}, the cube has "
                                 f"{e * comm.size(ax)}")


def _reserve_mesh(comm, run_opts: SolverOptions, orig: Tensor,
                  st: "_PhaseState") -> None:
    """Allocate, before the run's first collective, every buffer of
    ``comm``'s pool its steps will use — each exchange's send and receive
    buffers both ways, the edge values, the K=1 kernel's scratch slabs, the
    pair's bands and 2-row stash — by running the steps' halo assembly
    under ``comm.reserving()`` (which allocates and does not communicate),
    once per phase's state, and on a 2D grid the seam repair's column and
    strip exchanges (``pairfix.reserve``); then seal the pool."""
    n_f, n_u = run_opts.iterations_fista, run_opts.iterations_unacc
    variants = ([st.ds] if n_f and st.ds is not None else []) \
        + ([None] if n_u or not n_f else [])
    _, paired, _ = _plan(run_opts, tuple(orig.shape), orig.dtype, comm)
    pair_ax = _pair_axis(comm) if paired else None
    with comm.reserving():
        for ds in variants:
            if run_opts.backend == Backend.TORCH:
                for ax in range(run_opts.ndim):
                    comm.prev_halo(st.recon, ax)
                    comm.next_halo(st.accs[ax], ax)
            else:
                _k1_halos(comm, run_opts, st.recon, st.accs, ds)
            if pair_ax is not None:
                _pair_bands(comm, orig, pair_ax)(st.recon, st.accs, ds)
                if _grid2d(comm):
                    from cytvdn_tpu_torch.parallel import pairfix

                    pairfix.reserve(comm, orig, st.recon, st.accs, ds)
    comm.sealed = True


@dataclasses.dataclass
class PreparedRun:
    """A run whose device memory is allocated and which has made no
    collective yet (:func:`prepare_run`); :func:`run_prepared` runs it."""
    st: _PhaseState
    orig: Tensor
    tk_ratios: Tensor
    lambda_inv: Tensor
    lam_mu: Tensor
    opts: SolverOptions
    reference_data: Optional[Tensor]
    i_stop: int
    keep_state: bool
    comm: Any
    fresh: bool


def prepare_run(
    orig: Tensor,
    lambda_inv: Tensor,
    lam_mu: Tensor,
    opts: SolverOptions,
    reference_data: Optional[Tensor] = None,
    state: Optional[Dict[str, Any]] = None,
    i_stop: Optional[int] = None,
    keep_state: bool = False,
    comm=None,
) -> PreparedRun:
    """The first half of :func:`run_solver`: check the run, adopt or
    allocate its state and, on a mesh shard whose stop-aware pairs keep a
    block checkpoint, allocate that too. It makes no collective, so a
    mesh run can agree on a failed allocation before its first one
    (``parallel/sharded.py::run_sharded``)."""
    if opts.backend == Backend.CUDA and orig.device.type != "cuda":
        raise ValueError(f"backend='cuda' needs CUDA tensors, got {orig.device}")
    if opts.backend == Backend.CPP:
        raise ValueError("backend='cpp' runs on the host through "
                         "cpp/backend.py::solve_cpp (denoise3D/4D); the "
                         "engine takes 'auto', 'torch' or 'cuda'")
    if comm is not None:
        check_mesh(opts, comm, tuple(orig.shape))
    dtype, device = orig.dtype, orig.device
    if lossy_duals(opts) and dtype != torch.float32:
        raise ValueError("lossy_duals requires float32 data")
    if reference_data is not None:
        reference_data = reference_data.to(dtype)
    n_f, n_u = opts.iterations_fista, opts.iterations_unacc
    n_total = n_f + n_u
    i_stop = n_total if i_stop is None else min(int(i_stop), n_total)
    # schedule computed on the host in float64, stored at the data dtype
    # (reference cyTVDN.py:153-156 passes a Python float into a
    # ``_float``-typed kernel argument)
    tk_ratios = torch.as_tensor(fista_tk_ratios(n_f), dtype=dtype).to(device)

    if state is not None:
        st = _adopt(state, orig, opts)
    else:
        mse = None
        if opts.calculate_mse:
            mse = torch.zeros(n_total + 1, dtype=dtype, device=device)
            if comm is None:
                mse[0] = ops.sum_square_error(orig, reference_data)
        st = _PhaseState(
            i=0,
            done=False,
            recon=orig.clone(),
            accs=[torch.zeros_like(orig) for _ in range(opts.ndim)],
            ds=[torch.zeros_like(orig, dtype=d_dtype(opts, dtype))
                for _ in range(opts.ndim)] if n_f else None,
            b_norm=torch.zeros(n_total, dtype=dtype, device=device),
            delta=torch.zeros(n_total, dtype=dtype, device=device),
            mse=mse,
            tk=torch.ones((), dtype=torch.float32, device=device),
        )
    if comm is not None and holds_block_checkpoint(opts, tuple(orig.shape),
                                                   dtype, comm):
        cubes = [st.recon, *st.accs] + (list(st.ds) if n_f else [])
        traces = [st.b_norm, st.delta] + ([st.mse] if opts.calculate_mse
                                          else [])
        st.ckpt = [torch.empty_like(x) for x in cubes + traces]
    if comm is not None:
        _reserve_mesh(comm, opts, orig, st)
    return PreparedRun(st, orig, tk_ratios, lambda_inv, lam_mu, opts,
                       reference_data, i_stop, keep_state, comm,
                       state is None)


def run_prepared(run: PreparedRun) -> Dict[str, object]:
    """The second half of :func:`run_solver`: the schedule on a prepared
    state."""
    st, orig, opts, comm = run.st, run.orig, run.opts, run.comm
    tk_ratios, reference_data = run.tk_ratios, run.reference_data
    lambda_inv, lam_mu = run.lambda_inv, run.lam_mu
    dtype, device = orig.dtype, orig.device
    n_f, n_u = opts.iterations_fista, opts.iterations_unacc
    n_total = n_f + n_u
    if comm is not None and run.fresh and opts.calculate_mse:
        st.mse[0] = comm.allsum(ops.sum_square_error(orig, reference_data))
    shape = tuple(orig.shape)
    if (run.fresh and run.i_stop >= n_total and n_total and comm is None
            and not (run.keep_state and n_f and n_u)
            and _resolve_resident(opts, shape, dtype)):
        # the whole schedule in one launch; a hybrid run's unaccelerated
        # iterations are FISTA iterations with momentum 0
        # (``engine.py:1411-1454``), so its shadow duals move on and are
        # not returned. Nothing waits for the device.
        rhos = torch.zeros(n_total, dtype=dtype, device=device)
        rhos[:n_f] = tk_ratios[:n_f]
        out = resident_solve(
            orig, st.recon, st.accs, st.ds, rhos, lambda_inv, lam_mu,
            n_iters=n_total, fista=bool(n_f), bc=int(opts.bc_mode),
            ref=reference_data if opts.calculate_mse else None,
            iso_r=opts.isotropic_R, iso_q=opts.isotropic_Q)
        st.b_norm = out[3]
        st.delta = out[4] / out[5]
        if opts.calculate_mse:
            st.mse[1:] = out[6]
        st.i = n_total
        if n_u:
            st.ds = None
    else:
        _run_phases(st, orig, tk_ratios, lambda_inv, lam_mu, opts,
                    reference_data, run.i_stop, run.keep_state, comm)

    out = {
        "recon": st.recon,
        "b_norm": st.b_norm,
        "delta": st.delta,
        "iterations_run": st.i,
        "early_stopped": st.done,
    }
    if opts.calculate_mse:
        out["mse"] = st.mse
    if run.keep_state:
        out["accs"] = st.accs
        out["ds"] = st.ds if st.ds is not None else []
        out["i"] = st.i
        out["tk"] = st.tk
    return out


def run_solver(
    orig: Tensor,
    lambda_inv: Tensor,
    lam_mu: Tensor,
    opts: SolverOptions,
    reference_data: Optional[Tensor] = None,
    state: Optional[Dict[str, Any]] = None,
    i_stop: Optional[int] = None,
    keep_state: bool = False,
    comm=None,
) -> Dict[str, object]:
    """Run the full (possibly hybrid) TV-denoising schedule on ``orig``'s
    device.

    When both phase lengths are nonzero, the FISTA phase runs first and
    the unaccelerated phase *always* follows (even if FISTA stopped early),
    sharing the accumulators; trace entries of skipped iterations stay zero
    (reference cyTVDN.py:100-108, 127-128, 195-201). Where
    :func:`_resolve_resident` allows, a fresh uncapped run is one launch of
    the whole-run kernel; otherwise :func:`_run_phases` runs each phase.

    ``state``/``i_stop``/``keep_state`` run a schedule in chunks
    (``cytvdn_tpu``'s ``run_solver``, ``engine.py:1302-1327``): ``state``
    is the dict ``keep_state=True`` returns (``recon``, ``accs``, ``ds``,
    ``b_norm``, ``delta``, ``mse``, ``i``, ``tk``; tensors on ``orig``'s
    device, e.g. from ``utils/state.py``), and ``i_stop`` caps the global
    iteration index. Unlike the JAX engine's functional result, the
    handed-in tensors are adopted and updated in place: the returned
    ``recon``, ``accs``, ``ds`` and traces are the objects passed in, and
    no second copy of the state is made.

    ``comm`` (``parallel/halo.py::MeshComm``) makes ``orig`` (and the
    state, and ``reference_data``) one shard of an evenly tiled mesh;
    every rank calls this with its shard, and the traces are those of the
    whole cube (``parallel/sharded.py::run_sharded``). :func:`check_mesh`
    checks the mesh against the options.

    Returns a dict with ``recon``, ``b_norm``, ``delta`` [, ``mse``] as
    tensors on the device, ``iterations_run`` (int) and ``early_stopped``
    (bool) [, with ``keep_state``: ``accs``, ``ds`` (empty without a
    FISTA phase, and after a whole-run hybrid launch), ``i`` (int) and
    ``tk``].
    """
    return run_prepared(prepare_run(orig, lambda_inv, lam_mu, opts,
                                    reference_data, state, i_stop,
                                    keep_state, comm))


def _adopt(state: Dict[str, Any], orig: Tensor,
           opts: SolverOptions) -> _PhaseState:
    """A handed-in state as the phases' ``_PhaseState``, its tensors
    adopted as they are (``engine.py:1458-1467``): the shadow duals only
    with a FISTA phase, cast to the run's storage dtype where they differ
    (bfloat16 under lossy duals; the JAX engine casts them so, ``:1460``;
    a cast makes a new tensor), the MSE trace only with ``calculate_mse``."""
    accs = list(state["accs"])
    ds = list(state.get("ds") or ()) if opts.iterations_fista else None
    if len(accs) != opts.ndim or (ds is not None and len(ds) != opts.ndim):
        raise ValueError(f"state holds {len(accs)} accumulators and "
                         f"{len(ds or ())} shadow duals; a {opts.ndim}D "
                         f"run needs {opts.ndim} of each it uses")
    d_dt = d_dtype(opts, orig.dtype)
    if ds is not None:
        ds = [d if d.dtype == d_dt else d.to(d_dt) for d in ds]
    checks = [(a, orig.dtype) for a in (state["recon"], *accs)]
    checks += [(d, d_dt) for d in ds or ()]
    for a, want in checks:
        if a.shape != orig.shape or a.dtype != want \
                or a.device != orig.device:
            raise ValueError(
                f"state array {tuple(a.shape)} {a.dtype} on {a.device} does "
                f"not match orig {tuple(orig.shape)} {orig.dtype} on "
                f"{orig.device}")
    return _PhaseState(
        i=int(state["i"]),
        done=False,
        recon=state["recon"],
        accs=accs,
        ds=ds,
        b_norm=state["b_norm"],
        delta=state["delta"],
        mse=state["mse"] if opts.calculate_mse else None,
        tk=torch.as_tensor(state.get("tk", 1.0), dtype=torch.float32,
                           device=orig.device),
    )


#: the options :func:`vmem_fallback` turns off, in order: each drops a
#: multi-iteration kernel, and with it the memory its path holds beside the
#: state (a stop run's block checkpoint)
_FALLBACK_KNOBS = ("vmem_resident", "temporal_kstep", "temporal_pairs")


def vmem_fallback(opts: SolverOptions, call):
    """Run ``call(opts)``; where it exhausts device memory
    (``torch.OutOfMemoryError``), turn the next option of
    :data:`_FALLBACK_KNOBS` that is on off and retry (``cytvdn_tpu``'s ``vmem_fallback``,
    ``engine.py:1193-1285``, without its pair-strip rung, which is
    TPU-only). The multi-iteration kernels are throughput choices with
    results bitwise those of the one-iteration loop, so the worst case is
    that loop, not a crash: on the H100 a stop run's block checkpoint
    (:func:`stop_ckpt_bytes`) may not fit beside memory held elsewhere on
    the card, where the one-iteration loop's state alone does. When no
    knob is left the error is raised again. Nothing else is caught: a
    launch error, an illegal address or a build failure propagates.

    The retry starts after the failed attempt's frames, and the state they
    held, are gone: the ``except`` block has ended, ``gc.collect()`` has run
    and the allocator's cache is emptied. ``call`` must start from inputs
    the attempt left untouched (``run_solver`` on a fresh state does)."""
    attempt = opts
    while True:
        try:
            return call(attempt)
        except torch.OutOfMemoryError as e:
            kind = type(e).__name__
            knob = next((k for k in _FALLBACK_KNOBS if getattr(attempt, k)),
                        None)
            if knob is None:
                raise
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        warnings.warn(
            f"device memory exhausted while running the solver ({kind}); "
            f"retrying with {knob}=False (a path that holds less device "
            f"memory — results are identical, throughput lower)",
            stacklevel=2)
        attempt = dataclasses.replace(attempt, **{knob: False})
