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
stop-aware pairing and K-stepping, the pair kernel's in-kernel SSE, the
resident phase, and sharded runs (ROADMAP.md).
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
    :func:`_resolve_kstep` picks a depth, each phase runs K-step launches
    first; where :func:`_resolve_temporal` allows, pairs follow, and the
    one-iteration loop finishes it (``engine.py:1515-1580``).

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
    paired = _resolve_temporal(opts, shape, dtype)
    if n_f:
        k_f = _resolve_kstep(opts, shape, dtype, True)
        if k_f:
            _run_phase_kstep(True, n_f, st, orig, tk_ratios, lambda_inv,
                             lam_mu, k_f)
        if paired:
            _run_phase_paired(True, n_f, st, orig, tk_ratios, lambda_inv,
                              lam_mu)
        _run_phase(True, n_f, st, orig, tk_ratios, lambda_inv, lam_mu, opts,
                   reference_data)
        st.ds = None  # the unaccelerated phase carries no shadow duals
        if n_u:
            # the second phase starts at its own first index and ignores
            # the first phase's stop (reference cyTVDN.py:195-201)
            st.i = max(st.i, n_f)
            st.done = False
    if n_u:
        k_u = _resolve_kstep(opts, shape, dtype, False)
        if k_u:
            _run_phase_kstep(False, n_total, st, orig, tk_ratios, lambda_inv,
                             lam_mu, k_u)
        if paired:
            _run_phase_paired(False, n_total, st, orig, tk_ratios, lambda_inv,
                              lam_mu)
        _run_phase(False, n_total, st, orig, tk_ratios, lambda_inv, lam_mu,
                   opts, reference_data)

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
