"""Public API — the signatures and semantics of ``cytvdn_tpu.api``
(and of the reference's ``denoise3D`` / ``denoise4D``,
reference cyTVDN/cyTVDN.py:19-247, 250-435), on PyTorch.

numpy in, numpy out. The one addition is the keyword ``device``
(default ``"cuda"``): the run happens on that device, and the package never
picks the CPU by itself. float64 needs no flag.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence, Union

import numpy as np
import torch

from cytvdn_tpu_torch.config import (
    Backend,
    BCMode,
    SolverOptions,
    normalize_iterations,
)
from cytvdn_tpu_torch.solver.engine import run_solver

__all__ = ["denoise3D", "denoise4D", "denoise"]


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()  # torch.from_numpy warns on read-only arrays
    return torch.from_numpy(a).to(device)


def _run(datacube, lambda_inv, lam_mu, opts: SolverOptions, reference_data,
         device):
    device = torch.device(device)
    ref = _to_device(reference_data, device) if opts.calculate_mse else None
    return run_solver(_to_device(datacube, device),
                      _to_device(lambda_inv, device),
                      _to_device(lam_mu, device), opts, ref)


def _validate_and_derive(datacube, mu, lam, ndim, default_lam_div):
    """Shared parameter validation/derivation
    (reference cyTVDN/cyTVDN.py:62-78, 289-304)."""
    datacube = np.asarray(datacube)
    if datacube.ndim != ndim:
        raise ValueError(f"datacube must be {ndim}D, got shape {datacube.shape}")
    if datacube.dtype not in (np.float32, np.float64):
        raise TypeError("datacube must be float32 or float64.")
    mu = np.asarray(mu)
    if mu.ndim == 0:
        mu = np.full((ndim,), mu, dtype=datacube.dtype)
    if lam is None:
        # default regularization: lam = mu/32 in 4D, mu/16 in 3D
        # (reference cyTVDN.py:67-68, 294-295)
        lam = mu * (1.0 / default_lam_div)
    lam = np.asarray(lam)
    if lam.dtype != datacube.dtype:
        raise TypeError("Lambda must have same dtype as datacube.")
    if mu.dtype != datacube.dtype:
        raise TypeError("Mu must have same dtype as datacube.")
    lambda_inv = (1.0 / lam).astype(datacube.dtype)
    lam_mu = (lam / mu).astype(datacube.dtype)
    return datacube, mu, lam, lambda_inv, lam_mu


def _resolve_progress(progress: Optional[bool]) -> None:
    """The live progress bar rides chunked execution, which is not ported
    yet: an explicit ``progress=True`` raises, the default is no bar."""
    if progress:
        raise NotImplementedError(
            "progress=True needs chunked execution, which is not ported to "
            "cytvdn_tpu_torch yet (ROADMAP.md Queue 1 item 5)")


def _bc_note(bc_mode: int) -> None:
    """Surface the deliberate mirror-BC deviation from the reference, whose
    mirror branch is defective (reference cyTVDN/utils.pyx:117-120,
    192-197): BC_mode=1 results intentionally differ from it."""
    if BCMode(bc_mode) == BCMode.MIRROR:
        warnings.warn(
            "BC_mode=1 (mirror) is implemented correctly here; the "
            "reference's mirror branch is defective (cyTVDN utils.pyx:"
            "117-120,192-197), so results deliberately differ from the "
            "reference in this mode.",
            stacklevel=3,
        )


def _memory_note(datacube, fista, ndim, quiet):
    if quiet:
        return
    n_arrays = 2 + (2 * ndim if fista else ndim)  # orig+recon+accs(+ds)
    gib = datacube.nbytes * n_arrays / 2**30
    label = "FISTA accelerated" if fista else "Unaccelerated"
    print(
        f"{label} TV denoising holds {n_arrays} cube-size arrays "
        f"≈ {gib:.2f} GiB of device memory"
    )


def _finish(result, calculate_mse):
    """Device→host transfer and the reference's return contract
    (reference cyTVDN.py:244-247)."""
    recon = result["recon"].cpu().numpy()
    b_norm = result["b_norm"].cpu().numpy()
    delta = result["delta"].cpu().numpy()
    if calculate_mse:
        return recon, b_norm, delta, result["mse"].cpu().numpy()
    return recon, b_norm, delta


def denoise4D(
    datacube: np.ndarray,
    mu: np.ndarray,
    iterations: Union[int, Sequence[int]] = 10,
    FISTA: bool = True,
    stopping_relative_change: Optional[float] = None,
    isotropic_R: bool = False,
    isotropic_Q: bool = False,
    reference_data: Optional[np.ndarray] = None,
    BC_mode: int = 2,
    lam: Optional[np.ndarray] = None,
    quiet: bool = False,
    backend: Union[str, Backend] = Backend.AUTO,
    fista_restart: bool = False,
    progress: Optional[bool] = None,
    lossy_duals: bool = False,
    *,
    device: Union[str, torch.device] = "cuda",
):
    """Proximal anisotropic (or half-isotropic) TV denoising of a 4D datacube.

    Signature, defaults and return contract match the reference
    (reference cyTVDN/cyTVDN.py:19-247): returns
    ``(recon, b_norm, delta_recon[, MSE])``. ``device`` selects where the
    run happens. ``progress=True`` and ``lossy_duals=True`` are not ported
    yet and raise ``NotImplementedError``.
    """
    datacube, mu, lam, lambda_inv, lam_mu = _validate_and_derive(
        datacube, mu, lam, 4, 32.0
    )
    _bc_note(BC_mode)
    if not quiet:
        ratios = ", ".join(f"1/{m / l:.0f}" for m, l in zip(mu, lam))
        print(f"λ/μ ≈ [{ratios}]")
    # stability: 0 < λ/μ <= 1/32 — warning only, as in the reference
    # (reference cyTVDN.py:89-90)
    if (np.any(lam_mu > (1.0 / 32.0)) or np.any(lam_mu <= 0)) and not quiet:
        print(
            "WARNING: Parameters must satisfy 0 < λ/μ <= 1/32 "
            "or result may diverge!"
        )

    n_f, n_u = normalize_iterations(iterations, FISTA)
    calculate_mse = reference_data is not None
    opts = SolverOptions(
        ndim=4,
        iterations_fista=n_f,
        iterations_unacc=n_u,
        bc_mode=BCMode(BC_mode),
        stopping_relative_change=stopping_relative_change,
        isotropic_R=isotropic_R,
        isotropic_Q=isotropic_Q,
        calculate_mse=calculate_mse,
        backend=backend,
        fista_restart=fista_restart,
        lossy_duals=lossy_duals,
    )
    _resolve_progress(progress)
    _memory_note(datacube, n_f > 0, 4, quiet)

    result = _run(datacube, lambda_inv, lam_mu, opts, reference_data, device)
    return _finish(result, calculate_mse)


def denoise3D(
    datacube: np.ndarray,
    mu: np.ndarray,
    iterations: Union[int, Sequence[int]] = 7_500,
    stopping_relative_change: Optional[float] = None,
    BC_mode: int = 2,
    FISTA: bool = False,
    reference_data: Optional[np.ndarray] = None,
    lam: Optional[np.ndarray] = None,
    quiet: bool = False,
    backend: Union[str, Backend] = Backend.AUTO,
    fista_restart: bool = False,
    progress: Optional[bool] = None,
    lossy_duals: bool = False,
    *,
    device: Union[str, torch.device] = "cuda",
):
    """Proximal anisotropic TV denoising of a 3D cube (EELS SI).

    Signature, defaults (``iterations=7500``, ``FISTA=False``) and return
    contract match the reference (reference cyTVDN/cyTVDN.py:250-435).
    ``device`` selects where the run happens.
    """
    datacube, mu, lam, lambda_inv, lam_mu = _validate_and_derive(
        datacube, mu, lam, 3, 16.0
    )
    _bc_note(BC_mode)
    # hard bound in 3D (reference cyTVDN.py:306-308; the reference's message
    # says 1/8 but its check is 1/16 — we state the actual bound)
    if not (np.all(lam_mu <= (1.0 / 16.0)) and np.all(lam_mu > 0)):
        raise ValueError("Parameters must satisfy 0 < λ/μ <= 1/16")
    if not quiet:
        ratios = ", ".join(f"1/{m / l:.0f}" for m, l in zip(mu, lam))
        print(f"λ/μ ≈ [{ratios}]")

    n_f, n_u = normalize_iterations(iterations, FISTA)
    calculate_mse = reference_data is not None
    opts = SolverOptions(
        ndim=3,
        iterations_fista=n_f,
        iterations_unacc=n_u,
        bc_mode=BCMode(BC_mode),
        stopping_relative_change=stopping_relative_change,
        calculate_mse=calculate_mse,
        backend=backend,
        fista_restart=fista_restart,
        lossy_duals=lossy_duals,
    )
    _resolve_progress(progress)
    _memory_note(datacube, n_f > 0, 3, quiet)

    result = _run(datacube, lambda_inv, lam_mu, opts, reference_data, device)
    return _finish(result, calculate_mse)


def denoise(datacube, mu, **kwargs):
    """Rank-dispatching convenience wrapper: calls :func:`denoise3D` or
    :func:`denoise4D` based on ``datacube.ndim``."""
    nd = np.asarray(datacube).ndim
    if nd == 3:
        return denoise3D(datacube, mu, **kwargs)
    if nd == 4:
        return denoise4D(datacube, mu, **kwargs)
    raise ValueError(f"datacube must be 3D or 4D, got {nd}D")
