"""The iteration engine on one device: a host loop over fused iterations.

Counterpart of ``cytvdn_tpu/solver/engine.py`` on its main path
(``run_solver``, ``_run_phase``, ``iteration_step``, ``fista_tk_ratios``).
The JAX engine runs each phase as a ``lax.while_loop`` with the stop check
in its predicate; PyTorch has no device-side loop, so each phase here is a
Python loop with the same semantics:

- the traces are recorded before the stop check, so the converging
  iteration is included (reference cyTVDN/cyTVDN.py:182-194);
- without ``stopping_relative_change`` the loop never waits for the device;
  with it, each iteration makes one ``.item()`` host sync to read the stop
  flag (a device-side flag is ROADMAP.md Queue 1 item 3's open part);
- hybrid runs run FISTA first, then always the unaccelerated phase, which
  shares the accumulators, with the stop latch reset between the phases.

- float32 runs whose whole state is small (``_resolve_resident``) run the
  whole schedule in one launch of the whole-run kernel; with
  ``stopping_relative_change`` (``_resolve_resident_chunks``) each phase
  runs a few one-iteration steps, then ``_RESIDENT_CHUNK`` iterations per
  launch behind a predictive guard (``_run_phase_resident``), and the
  one-iteration loop makes the exact stop;
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
allocated once and updated by every iteration (the JAX engine gets the same
effect from buffer donation).

Not here yet: chunked execution (``state``/``i_stop``/``keep_state``) and
sharded runs (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from cytvdn_tpu_torch import ops
from cytvdn_tpu_torch.config import Backend, BCMode, SolverOptions
from cytvdn_tpu_torch.kernels.fused import fused_iteration, fused_iteration_reference
from cytvdn_tpu_torch.kernels.kstep import best_kstep, fused_kstep_iteration
from cytvdn_tpu_torch.kernels.resident import resident_solve, resident_supported
from cytvdn_tpu_torch.kernels.temporal import fused_pair_iteration, pair_supported

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


def iteration_step(
    orig: Tensor,
    recon: Tensor,
    accs: List[Tensor],
    ds: Optional[List[Tensor]],
    rho: Optional[Tensor],
    lambda_inv: Tensor,
    lam_mu: Tensor,
    opts: SolverOptions,
):
    """One full TV iteration, in place; returns ``(bnorm, delta)``.

    ``Backend.TORCH`` runs the plain spec on any device; otherwise the
    fused iteration runs — the CUDA kernel on a CUDA tensor, the plain spec
    on a CPU tensor.
    """
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
) -> None:
    """Advance ``st`` through one phase (FISTA or unaccelerated) up to the
    global index ``i_bound`` or the stop, as ``cytvdn_tpu``'s
    ``_run_phase`` does (``engine.py:409-485``)."""
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
            lambda_inv, lam_mu, opts)
        st.b_norm[i] = bnorm
        st.delta[i] = delta
        if opts.calculate_mse:
            st.mse[i + 1] = ops.sum_square_error(reference_data, st.recon)
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
    bitwise that of two one-iteration steps. (What :func:`pair_supported`
    admits, the fused kernel covers too.)"""
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
) -> None:
    """Advance ``st`` two iterations per pair-kernel launch, for
    ``floor((i_bound - i) / 2)`` pairs, recording both iterations' trace
    entries as the one-iteration loop would (``cytvdn_tpu``'s
    ``_run_phase_paired``, ``engine.py:897-1183``); with ``calculate_mse``
    the launch takes the reference cube and records both iterations' SSE.
    The caller's :func:`_run_phase` finishes an odd remainder. Without
    ``stopping_relative_change`` nothing here waits for the device; with
    it the pairs run behind a guard of horizon 4 in checkpointed blocks
    (:func:`_run_blocks`)."""
    ref = reference_data if opts.calculate_mse else None

    def launch(i):
        rho1, rho2 = (tk_ratios[i], tk_ratios[i + 1]) if fista \
            else (None, None)
        out = fused_pair_iteration(
            orig, st.recon, st.accs, st.ds if fista else None, rho1, rho2,
            lambda_inv, lam_mu, fista=fista, ref=ref)
        st.b_norm[i] = out[3]
        st.b_norm[i + 1] = out[6]
        deltas = torch.stack((out[4] / out[5], out[7] / out[8]))
        st.delta[i:i + 2] = deltas
        if ref is not None:
            # the one-iteration loop records the SSE after iteration i at
            # i + 1
            st.mse[i + 1] = out[9]
            st.mse[i + 2] = out[10]
        return deltas

    if opts.stopping_relative_change is not None:
        _run_blocks(fista, i_bound, st, orig, tk_ratios, lambda_inv, lam_mu,
                    opts, reference_data, 2, 4, launch)
        return
    while st.i + 2 <= i_bound:
        launch(st.i)
        st.i += 2


def _resolve_kstep(opts: SolverOptions, shape, dtype, fista: bool) -> int:
    """The K-step depth of a phase, or 0 to leave it to the pairs, as
    ``cytvdn_tpu``'s ``_resolve_kstep`` (``engine.py:546-570``) decides on
    one device: ``temporal_kstep`` on, the pair gate
    (:func:`_resolve_temporal`), no ``calculate_mse`` (the K-step kernel
    has no SSE), and :func:`best_kstep` with ``temporal_k``. It depends on
    the shape, dtype and options only, never on the device."""
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
    """Whether the phases may advance ``_RESIDENT_CHUNK`` iterations per
    whole-run launch (``engine.py:769-789``): a schedule of at least one
    chunk and :func:`_resident_gates`. The port runs chunks in stop-aware
    runs only (capped and resumed runs are not ported)."""
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


def _run_blocks(fista, i_bound, st, orig, tk_ratios, lambda_inv, lam_mu,
                opts, reference_data, k, horizon, launch) -> None:
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
    traces are bitwise those of the one-iteration loop in every case."""
    stopping = opts.stopping_relative_change
    if st.done or st.i < 2 or st.i + k > i_bound:
        return
    d2, d1 = st.delta[st.i - 2:st.i].tolist()
    live = [st.recon, *st.accs] + (list(st.ds) if fista else []) \
        + [st.b_norm, st.delta] + ([st.mse] if st.mse is not None else [])
    ckpt = [torch.empty_like(x) for x in live]
    start = limit = st.i
    while st.i + k <= i_bound and not st.done:
        i = st.i
        if not _guard_allows(d1, d2, stopping, horizon):
            _run_phase(fista, i + 1, st, orig, tk_ratios, lambda_inv, lam_mu,
                       opts, reference_data)
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
    """Advance a stop-aware phase ``_RESIDENT_CHUNK`` iterations per
    whole-run launch (``cytvdn_tpu``'s ``_run_phase_resident``,
    ``engine.py:792-894``) behind the guard of horizon 2T, in the
    checkpointed blocks of :func:`_run_blocks`; the gate keeps the state,
    and so its checkpoint, small. (The JAX engine also discards a chunk
    whose last delta crosses; here that latches the stop, as the K-step and
    pair phases do. The result is bitwise the same.)"""
    T = _RESIDENT_CHUNK
    ref = reference_data if opts.calculate_mse else None

    def launch(i):
        out = resident_solve(
            orig, st.recon, st.accs, st.ds if fista else None,
            tk_ratios[i:i + T] if fista else None, lambda_inv, lam_mu,
            n_iters=T, fista=fista, bc=int(opts.bc_mode), ref=ref,
            iso_r=opts.isotropic_R, iso_q=opts.isotropic_Q)
        deltas = out[4] / out[5]
        st.b_norm[i:i + T] = out[3]
        st.delta[i:i + T] = deltas
        if ref is not None:
            st.mse[i + 1:i + T + 1] = out[6]
        return deltas

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
    accumulators [, n shadow duals]) [, the reference cube]. It depends on
    the shape, dtype and options only."""
    n = len(shape)
    per_state = 1 + n + (n if opts.iterations_fista else 0)
    cubes = 1 + 2 * per_state + int(opts.calculate_mse)
    vox = 1
    for e in shape:
        vox *= e
    return cubes * vox * dtype.itemsize


def _run_phases(
    st: _PhaseState,
    orig: Tensor,
    tk_ratios: Tensor,
    lambda_inv: Tensor,
    lam_mu: Tensor,
    opts: SolverOptions,
    reference_data: Optional[Tensor],
) -> None:
    """The FISTA phase, then the unaccelerated one, each as: the
    one-iteration prologue of a stop-aware run (where it has whole-run
    chunks or temporal phases), the whole-run chunks, K-step launches,
    pairs (where :func:`_pairs_pay`), and the one-iteration loop for the
    rest (``engine.py:1498-1580``). A stop-aware run takes the K-step and
    pair phases only where :func:`stop_ckpt_bytes` is within
    :data:`STOP_CKPT_MAX_BYTES`."""
    n_f, n_u = opts.iterations_fista, opts.iterations_unacc
    n_total = n_f + n_u
    shape, dtype = tuple(orig.shape), orig.dtype
    stopping = opts.stopping_relative_change
    temporal = _resolve_temporal(opts, shape, dtype) and (
        stopping is None
        or stop_ckpt_bytes(opts, shape, dtype) <= STOP_CKPT_MAX_BYTES)
    paired = temporal and _pairs_pay(shape, dtype)
    chunks = stopping is not None and \
        _resolve_resident_chunks(opts, shape, dtype)
    for fista, i_bound, n in ((True, n_f, n_f), (False, n_total, n_u)):
        if not n:
            continue
        if stopping is not None and (temporal or chunks):
            _run_phase(fista, _history_bound(st, i_bound), st, orig,
                       tk_ratios, lambda_inv, lam_mu, opts, reference_data)
        if chunks:
            _run_phase_resident(fista, i_bound, st, orig, tk_ratios,
                                lambda_inv, lam_mu, opts, reference_data)
        k = _resolve_kstep(opts, shape, dtype, fista) if temporal else 0
        if k:
            _run_phase_kstep(fista, i_bound, st, orig, tk_ratios, lambda_inv,
                             lam_mu, opts, reference_data, k)
        if paired:
            _run_phase_paired(fista, i_bound, st, orig, tk_ratios, lambda_inv,
                              lam_mu, opts, reference_data)
        _run_phase(fista, i_bound, st, orig, tk_ratios, lambda_inv, lam_mu,
                   opts, reference_data)
        if fista:
            st.ds = None  # the unaccelerated phase carries no shadow duals
            if n_u:
                # the second phase starts at its own first index and
                # ignores the first phase's stop (reference
                # cyTVDN.py:195-201)
                st.i = max(st.i, n_f)
                st.done = False


def run_solver(
    orig: Tensor,
    lambda_inv: Tensor,
    lam_mu: Tensor,
    opts: SolverOptions,
    reference_data: Optional[Tensor] = None,
) -> Dict[str, object]:
    """Run the full (possibly hybrid) TV-denoising schedule on ``orig``'s
    device.

    When both phase lengths are nonzero, the FISTA phase runs first and
    the unaccelerated phase *always* follows (even if FISTA stopped early),
    sharing the accumulators; trace entries of skipped iterations stay zero
    (reference cyTVDN.py:100-108, 127-128, 195-201). Where
    :func:`_resolve_resident` allows, the whole schedule is one launch of
    the whole-run kernel; otherwise :func:`_run_phases` runs each phase.

    Returns a dict with ``recon``, ``b_norm``, ``delta`` [, ``mse``] as
    tensors on the device, and ``iterations_run`` (int) and
    ``early_stopped`` (bool).
    """
    if opts.backend == Backend.CUDA and orig.device.type != "cuda":
        raise ValueError(f"backend='cuda' needs CUDA tensors, got {orig.device}")
    dtype, device = orig.dtype, orig.device
    if reference_data is not None:
        reference_data = reference_data.to(dtype)
    n_f, n_u = opts.iterations_fista, opts.iterations_unacc
    n_total = n_f + n_u
    # schedule computed on the host in float64, stored at the data dtype
    # (reference cyTVDN.py:153-156 passes a Python float into a
    # ``_float``-typed kernel argument)
    tk_ratios = torch.as_tensor(fista_tk_ratios(n_f), dtype=dtype).to(device)

    mse = None
    if opts.calculate_mse:
        mse = torch.zeros(n_total + 1, dtype=dtype, device=device)
        mse[0] = ops.sum_square_error(orig, reference_data)
    st = _PhaseState(
        i=0,
        done=False,
        recon=orig.clone(),
        accs=[torch.zeros_like(orig) for _ in range(opts.ndim)],
        ds=[torch.zeros_like(orig) for _ in range(opts.ndim)] if n_f else None,
        b_norm=torch.zeros(n_total, dtype=dtype, device=device),
        delta=torch.zeros(n_total, dtype=dtype, device=device),
        mse=mse,
        tk=torch.ones((), dtype=torch.float32, device=device),
    )
    shape = tuple(orig.shape)
    if n_total and _resolve_resident(opts, shape, dtype):
        # the whole schedule in one launch; a hybrid run's unaccelerated
        # iterations are FISTA iterations with momentum 0
        # (``engine.py:1411-1454``). Nothing waits for the device.
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
    else:
        _run_phases(st, orig, tk_ratios, lambda_inv, lam_mu, opts,
                    reference_data)

    out = {
        "recon": st.recon,
        "b_norm": st.b_norm,
        "delta": st.delta,
        "iterations_run": st.i,
        "early_stopped": st.done,
    }
    if opts.calculate_mse:
        out["mse"] = st.mse
    return out
