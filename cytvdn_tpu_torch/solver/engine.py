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
- fixed-schedule Jia-Zhao float32 runs advance K iterations per launch
  through the K-step kernel where ``_resolve_kstep`` picks a depth
  (``_run_phase_kstep``), then two per launch through the pair kernel
  (``_run_phase_paired``), and the one-iteration loop finishes each
  phase's odd remainder; the state and traces are those of the
  one-iteration loop.

State lives in place: ``recon``, the accumulators and the shadow duals are
allocated once and updated by every iteration (the JAX engine gets the same
effect from buffer donation).

Not here yet: chunked execution (``state``/``i_stop``/``keep_state``),
stop-aware pairing and K-stepping, the pair kernel's in-kernel SSE, and
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
    pairs, Jia-Zhao, and :func:`pair_supported`.

    Unlike the JAX gate, runs with ``stopping_relative_change`` or
    ``calculate_mse`` are refused: stop-aware pairing and the pair kernel's
    in-kernel SSE are not ported yet (ROADMAP.md), so those runs stay on
    the exact one-iteration loop. Pairing changes no result: the state is
    bitwise that of two one-iteration steps. (What :func:`pair_supported`
    admits, the fused kernel covers too.)"""
    if not opts.temporal_pairs or opts.backend == Backend.TORCH:
        return False
    if opts.fista_restart or opts.isotropic_R or opts.isotropic_Q:
        return False
    if opts.bc_mode != BCMode.JIA_ZHAO:
        return False
    if opts.stopping_relative_change is not None or opts.calculate_mse:
        return False
    return pair_supported(shape, dtype, opts.bc_mode)


def _run_phase_paired(
    fista: bool,
    i_bound: int,
    st: _PhaseState,
    orig: Tensor,
    tk_ratios: Tensor,
    lambda_inv: Tensor,
    lam_mu: Tensor,
) -> None:
    """Advance ``st`` two iterations per pair-kernel launch, for
    ``floor((i_bound - i) / 2)`` pairs, recording both iterations' trace
    entries as the one-iteration loop would (``cytvdn_tpu``'s
    ``_run_phase_paired``, ``engine.py:897-1146``, without its stop-aware
    blocks). The caller's :func:`_run_phase` finishes an odd remainder.
    Nothing here waits for the device."""
    while st.i + 2 <= i_bound:
        i = st.i
        rho1, rho2 = (tk_ratios[i], tk_ratios[i + 1]) if fista else (None, None)
        _, _, _, bn1, dn1, dd1, bn2, dn2, dd2 = fused_pair_iteration(
            orig, st.recon, st.accs, st.ds if fista else None, rho1, rho2,
            lambda_inv, lam_mu, fista=fista)
        st.b_norm[i] = bn1
        st.b_norm[i + 1] = bn2
        st.delta[i] = dn1 / dd1
        st.delta[i + 1] = dn2 / dd2
        st.i = i + 2


def _resolve_kstep(opts: SolverOptions, shape, dtype, fista: bool) -> int:
    """The K-step depth of a phase, or 0 to leave it to the pairs, as
    ``cytvdn_tpu``'s ``_resolve_kstep`` (``engine.py:546-570``) decides on
    one device: ``temporal_kstep`` on, the pair gate
    (:func:`_resolve_temporal`, which also refuses stop and MSE runs in
    the port), and :func:`best_kstep` with ``temporal_k``. It depends on
    the shape, dtype and options only, never on the device."""
    if not opts.temporal_kstep or not _resolve_temporal(opts, shape, dtype):
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
    k: int,
) -> None:
    """Advance ``st`` K iterations per K-step launch, for
    ``floor((i_bound - i) / k)`` launches, recording the K trace entries
    as the one-iteration loop would (``cytvdn_tpu``'s
    ``_run_phase_kstep``, ``engine.py:573-667``, without its stop-aware
    blocks). The pairs and the one-iteration loop finish the remainder.
    Nothing here waits for the device."""
    while st.i + k <= i_bound:
        i = st.i
        _, _, _, bn, dnum, dden = fused_kstep_iteration(
            orig, st.recon, st.accs, st.ds if fista else None,
            tk_ratios[i:i + k] if fista else None, lambda_inv, lam_mu,
            k=k, fista=fista)
        st.b_norm[i:i + k] = bn
        st.delta[i:i + k] = dnum / dden
        st.i = i + k


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


def _guard_allows(d1: float, d2: float, stopping: float) -> bool:
    """The predictive guard of a chunk (``engine.py:834-848``), in float32
    as there: the last two deltas are positive and ``d1·r^(2T)`` with
    ``r = clip(d1/d2, 0, 1)`` stays at or above the threshold, so the
    threshold is not expected to be crossed within the next chunk."""
    d1, d2 = np.float32(d1), np.float32(d2)
    if not (d1 > 0 and d2 > 0):
        return False
    r = np.float32(min(max(d1 / d2, np.float32(0)), np.float32(1)))
    # r ** (2T) by repeated squaring, as lax.integer_pow computes it
    p, n = None, 2 * _RESIDENT_CHUNK
    while n:
        if n & 1:
            p = r if p is None else np.float32(p * r)
        n >>= 1
        if n:
            r = np.float32(r * r)
    return bool(np.float32(d1 * p) >= np.float32(stopping))


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
    ``engine.py:792-894``) where :func:`_guard_allows` says the threshold
    is not crossed within the chunk, until fewer than a chunk's iterations
    are left; the one-iteration loop after it makes the exact stop.

    Where the guard refuses, one exact one-iteration step runs and the
    guard is asked again. (The JAX engine hands such runs over to its
    stop-aware pairs at the first refusal; the port has none, and the fast
    early decay of a run would otherwise end the chunks before its slow
    tail, where they pay.)

    Before each chunk, recon, the accumulators [and shadow duals] are
    copied into buffers allocated once per phase (the gate keeps the state
    small), and the chunk's traces stay in its own outputs. If a delta of
    the chunk crosses the threshold anyway (the guard beaten), the state is
    restored from the copy, the traces and ``st.i`` are left as they were
    and the phase ends here, so the one-iteration loop redoes those
    iterations: the result is bitwise that of the one-iteration loop in
    every case. One host sync per chunk (its deltas)."""
    T = _RESIDENT_CHUNK
    stopping = opts.stopping_relative_change
    if st.done or st.i < 2 or st.i + T > i_bound:
        return
    d2, d1 = st.delta[st.i - 2:st.i].tolist()
    state = [st.recon, *st.accs] + (list(st.ds) if fista else [])
    snapshot = [torch.empty_like(x) for x in state]
    ref = reference_data if opts.calculate_mse else None
    while st.i + T <= i_bound and not st.done:
        i = st.i
        if not _guard_allows(d1, d2, stopping):
            _run_phase(fista, i + 1, st, orig, tk_ratios, lambda_inv, lam_mu,
                       opts, reference_data)
            d2, d1 = d1, st.delta[i].item()
            continue
        for s, x in zip(snapshot, state):
            s.copy_(x)
        out = resident_solve(
            orig, st.recon, st.accs, st.ds if fista else None,
            tk_ratios[i:i + T] if fista else None, lambda_inv, lam_mu,
            n_iters=T, fista=fista, bc=int(opts.bc_mode), ref=ref,
            iso_r=opts.isotropic_R, iso_q=opts.isotropic_Q)
        deltas = out[4] / out[5]
        host = deltas.cpu()  # the chunk's one host sync
        if bool((host < stopping).any()):
            for s, x in zip(snapshot, state):
                x.copy_(s)
            return
        st.b_norm[i:i + T] = out[3]
        st.delta[i:i + T] = deltas
        if ref is not None:
            st.mse[i + 1:i + T + 1] = out[6]
        st.i = i + T
        d2, d1 = host[-2:].tolist()


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
    one-iteration prologue and the whole-run chunks of a stop-aware run,
    K-step launches, pairs, and the one-iteration loop for the rest
    (``engine.py:1498-1580``)."""
    n_f, n_u = opts.iterations_fista, opts.iterations_unacc
    n_total = n_f + n_u
    shape, dtype = tuple(orig.shape), orig.dtype
    paired = _resolve_temporal(opts, shape, dtype)
    chunks = opts.stopping_relative_change is not None and \
        _resolve_resident_chunks(opts, shape, dtype)
    for fista, i_bound, n in ((True, n_f, n_f), (False, n_total, n_u)):
        if not n:
            continue
        if chunks:
            _run_phase(fista, _history_bound(st, i_bound), st, orig,
                       tk_ratios, lambda_inv, lam_mu, opts, reference_data)
            _run_phase_resident(fista, i_bound, st, orig, tk_ratios,
                                lambda_inv, lam_mu, opts, reference_data)
        k = _resolve_kstep(opts, shape, dtype, fista)
        if k:
            _run_phase_kstep(fista, i_bound, st, orig, tk_ratios, lambda_inv,
                             lam_mu, k)
        if paired:
            _run_phase_paired(fista, i_bound, st, orig, tk_ratios, lambda_inv,
                              lam_mu)
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
