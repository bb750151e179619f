"""Plain PyTorch stencil ops — the executable spec of the TV iteration.

Counterpart of ``cytvdn_tpu/ops/stencil.py``, op for op and in the same
order of floating-point operations: the CUDA kernel
(``csrc/fused_iteration.cu``) is held bitwise against these ops on the
card, and the CPU tests hold them against the JAX ops.

- :func:`accumulator_update`        ⇔ ``accumulator_update_{3D,4D}``
  (reference cyTVDN/anisotropic.pyx:17-84)
- :func:`accumulator_update_fista`  ⇔ ``accumulator_update_{3D,4D}_FISTA``
  (reference cyTVDN/anisotropic.pyx:89-164)
- :func:`iso_accumulator_update` / :func:`iso_accumulator_update_fista`
  ⇔ ``iso_accumulator_update_4D[_FISTA]`` (reference halfisotropic.pyx)
- :func:`datacube_update`           ⇔ ``datacube_update_{3D,4D}``
  (reference cyTVDN/utils.pyx:54-199)
- :func:`sum_square_error`          ⇔ ``sum_square_error_{3D,4D}``

The ops are functional: they return new tensors and never write their
inputs. Every op accepts optional *operand halos* (one-slab neighbour
tensors for the boundary of each difference operator), as the JAX ops do
for the sharded solver. Scalars (``clip``, ``tk_ratio``, ``lam_mu``) may be
Python numbers or tensors on the data's device; the engine passes 0-d
device tensors so that no op waits on the host.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from cytvdn_tpu_torch.config import BCMode

Tensor = torch.Tensor


def _slab(a: Tensor, ax: int, idx: int) -> Tensor:
    """One-thick slab ``a[..., idx:idx+1, ...]`` along axis ``ax``."""
    if idx < 0:
        idx += a.shape[ax]
    return a.narrow(ax, idx, 1)


def shift_backward(
    a: Tensor,
    ax: int,
    bc: BCMode,
    halo_prev: Optional[Tensor] = None,
) -> Tensor:
    """Return ``s`` with ``s_i = a_{i-1}`` along ``ax``.

    The boundary slab ``s_0`` is ``halo_prev`` when given, else ``a_{N-1}``
    (periodic), ``a_1`` (mirror) or ``a_0`` (Jia-Zhao: zero difference)
    (reference anisotropic.pyx:67-73).
    """
    body = a.narrow(ax, 0, a.shape[ax] - 1)
    if halo_prev is not None:
        first = halo_prev
    elif bc == BCMode.PERIODIC:
        first = _slab(a, ax, -1)
    elif bc == BCMode.MIRROR:
        first = _slab(a, ax, 1)
    else:  # JIA_ZHAO
        first = _slab(a, ax, 0)
    return torch.cat([first, body], dim=ax)


def shift_forward(
    b: Tensor,
    ax: int,
    bc: BCMode,
    halo_next: Optional[Tensor] = None,
) -> Tensor:
    """Return ``s`` with ``s_i = b_{i+1}`` along ``ax``.

    The trailing slab ``s_{N-1}`` is ``halo_next`` when given, else ``b_0``
    for periodic *and* Jia-Zhao (identical by the JZ zero-slab invariant,
    reference utils.pyx:63-65, 98-101), or ``b_{N-1}`` for the corrected
    mirror (zero trailing difference).
    """
    body = b.narrow(ax, 1, b.shape[ax] - 1)
    if halo_next is not None:
        last = halo_next
    elif bc in (BCMode.PERIODIC, BCMode.JIA_ZHAO):
        last = _slab(b, ax, 0)
    else:  # MIRROR (corrected)
        last = _slab(b, ax, -1)
    return torch.cat([body, last], dim=ax)


def _clip(x: Tensor, clip) -> Tensor:
    """``min(max(x, -clip), clip)`` (reference anisotropic.pyx:11-12)."""
    return torch.clamp(x, -clip, clip)


def accumulator_update(
    a: Tensor,
    b: Tensor,
    ax: int,
    clip,
    bc: BCMode = BCMode.JIA_ZHAO,
    halo_prev: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Unaccelerated dual-accumulator update along one axis.

    ``b_new = clip(a - shift_backward(a) + b)``; returns
    ``(b_new, ||b_new||_1)`` (reference anisotropic.pyx:17-84).
    """
    diff = a - shift_backward(a, ax, bc, halo_prev)
    b_new = _clip(diff + b, clip)
    return b_new, torch.sum(torch.abs(b_new))


def accumulator_update_fista(
    a: Tensor,
    b: Tensor,
    d: Tensor,
    tk_ratio,
    ax: int,
    clip,
    bc: BCMode = BCMode.JIA_ZHAO,
    halo_prev: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """FISTA-accelerated dual update along one axis.

    ``d_new = clip(a - shift_backward(a) + b)``;
    ``b_new = d_new + tk_ratio * (d_new - d)`` — only ``d`` is projected
    (reference anisotropic.pyx:127-132). Returns
    ``(b_new, d_new, ||b_new||_1)``.
    """
    diff = a - shift_backward(a, ax, bc, halo_prev)
    d_new = _clip(diff + b, clip)
    b_new = d_new + tk_ratio * (d_new - d)
    return b_new, d_new, torch.sum(torch.abs(b_new))


def _iso_project(delta1: Tensor, delta2: Tensor, clip) -> Tuple[Tensor, Tensor]:
    """Joint projection of the 2-vector onto the L2 ball of radius ``clip``
    (reference halfisotropic.pyx:84-95), division guarded for mag=0.

    ``clip`` is made a tensor first: ``number / tensor`` in PyTorch is a
    reciprocal and a product (two roundings), not a true division.
    """
    clip = torch.as_tensor(clip, dtype=delta1.dtype, device=delta1.device)
    mag = torch.hypot(delta1, delta2)
    scale = torch.where(mag > clip, clip / torch.where(mag > 0, mag, 1.0), 1.0)
    return delta1 * scale, delta2 * scale


def iso_accumulator_update(
    a: Tensor,
    b1: Tensor,
    b2: Tensor,
    ax1: int,
    ax2: int,
    clip,
    halo_prev1: Optional[Tensor] = None,
    halo_prev2: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Half-isotropic paired-axis update (Jia-Zhao only, as in reference):
    the two backward differences are jointly projected onto the L2 ball of
    radius ``clip``; the norm is ``Σ|b1| + Σ|b2|``
    (reference halfisotropic.pyx:17-97)."""
    bc = BCMode.JIA_ZHAO
    delta1 = a - shift_backward(a, ax1, bc, halo_prev1) + b1
    delta2 = a - shift_backward(a, ax2, bc, halo_prev2) + b2
    b1_new, b2_new = _iso_project(delta1, delta2, clip)
    norm = torch.sum(torch.abs(b1_new)) + torch.sum(torch.abs(b2_new))
    return b1_new, b2_new, norm


def iso_accumulator_update_fista(
    a: Tensor,
    b1: Tensor,
    b2: Tensor,
    d1: Tensor,
    d2: Tensor,
    tk_ratio,
    ax1: int,
    ax2: int,
    clip,
    halo_prev1: Optional[Tensor] = None,
    halo_prev2: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """FISTA variant of the half-isotropic update
    (reference halfisotropic.pyx:102-188). Returns
    ``(b1_new, b2_new, d1_new, d2_new, norm)``."""
    bc = BCMode.JIA_ZHAO
    delta1 = a - shift_backward(a, ax1, bc, halo_prev1) + b1
    delta2 = a - shift_backward(a, ax2, bc, halo_prev2) + b2
    d1_new, d2_new = _iso_project(delta1, delta2, clip)
    b1_new = d1_new + tk_ratio * (d1_new - d1)
    b2_new = d2_new + tk_ratio * (d2_new - d2)
    norm = torch.sum(torch.abs(b1_new)) + torch.sum(torch.abs(b2_new))
    return b1_new, b2_new, d1_new, d2_new, norm


def datacube_update(
    orig: Tensor,
    recon: Tensor,
    bs: Sequence[Tensor],
    lam_mu,
    bc: BCMode = BCMode.JIA_ZHAO,
    halos_next: Optional[Sequence[Optional[Tensor]]] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Reconstruction update ``recon_new = orig - Σ_k λμ_k (b_k - S_k⁺ b_k)``
    (reference utils.pyx:96-102).

    Returns ``(recon_new, delta_num, recon_norm)`` with
    ``delta_num = Σ|recon_new - recon|`` and ``recon_norm = Σ|recon|``; the
    convergence statistic is their ratio (reference utils.pyx:103-104).
    """
    if halos_next is None:
        halos_next = [None] * len(bs)
    div = torch.zeros_like(orig)
    for k, (b_k, halo) in enumerate(zip(bs, halos_next)):
        div = div + lam_mu[k] * (b_k - shift_forward(b_k, k, bc, halo))
    recon_new = orig - div
    delta_num = torch.sum(torch.abs(recon_new - recon))
    recon_norm = torch.sum(torch.abs(recon))
    return recon_new, delta_num, recon_norm


def sum_square_error(a: Tensor, b: Tensor) -> Tensor:
    """Sum of squared differences — *not* divided by N, despite the MSE
    naming in the reference (reference utils.pyx:14-49, cyTVDN.py:124-125)."""
    diff = a - b
    return torch.sum(diff * diff)


def tv_energy(
    u: Tensor,
    f: Tensor,
    lam: Tensor,
    mu: Tensor,
    bc: BCMode = BCMode.JIA_ZHAO,
) -> Tensor:
    """The anisotropic ROF objective the Jia-Zhao iteration minimizes:

        E(u) = Σ_k λ_k ‖D_k⁻ u‖₁ + (μ̄/2) ‖u − f‖²   (μ̄ = mean of μ_k)
    """
    e = 0.5 * torch.mean(mu) * torch.sum((u - f) ** 2)
    for ax in range(u.ndim):
        diff = u - shift_backward(u, ax, bc)
        e = e + lam[ax] * torch.sum(torch.abs(diff))
    return e
