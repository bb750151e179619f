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
from cytvdn_tpu_torch.solver.engine import (
    _resolve_resident,
    _resolve_resident_chunks,
    d_dtype,
    holds_block_checkpoint,
    run_solver,
    vmem_fallback,
)
from cytvdn_tpu_torch.utils.state import to_numpy

__all__ = ["denoise3D", "denoise4D", "denoise"]


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()  # torch.from_numpy warns on read-only arrays
    return torch.from_numpy(a).to(device)


def _run(datacube, lambda_inv, lam_mu, opts: SolverOptions, reference_data,
         device, progress: bool = False):
    """The solve on ``device``, inside the device-memory fallback ladder
    (:func:`vmem_fallback`), as ``cytvdn_tpu.api._run`` runs it.

    ``progress`` routes the run through chunked execution so a live
    per-iteration bar can be shown (the reference's tqdm operator
    experience, cyTVDN.py:147-152). The state is bitwise that of the
    unchunked run; the b_norm/delta traces can differ in the last ulp
    where a chunk boundary changes which kernel sums an iteration. The
    plain run's inputs go to the device once; a retry starts from them
    untouched.
    """
    device = torch.device(device)
    if progress:
        from cytvdn_tpu_torch.utils.checkpoint import (
            progress_chunk_size,
            run_chunked,
        )
        from cytvdn_tpu_torch.utils.log import make_progress

        n_total = opts.total_iterations
        cb = make_progress("TV denoising")
        try:
            return vmem_fallback(opts, lambda o: run_chunked(
                datacube, lambda_inv, lam_mu, o,
                checkpoint_path=None,
                checkpoint_every=progress_chunk_size(n_total),
                reference_data=reference_data, progress=cb, device=device))
        finally:
            cb.close()
    orig = _to_device(datacube, device)
    li = _to_device(lambda_inv, device)
    lm = _to_device(lam_mu, device)
    ref = _to_device(reference_data, device) if opts.calculate_mse else None
    return vmem_fallback(opts, lambda o: run_solver(orig, li, lm, o, ref))


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


def _resolve_progress(progress: Optional[bool], quiet: bool,
                      opts: SolverOptions, datacube) -> bool:
    """Default: live progress for long, non-quiet runs (the reference's
    always-on tqdm, without a host sync per iteration), as
    ``cytvdn_tpu.api._resolve_progress`` decides: off when quiet, below
    500 iterations, or where the whole-run kernel serves the run (one
    launch, or its chunks), since such a run ends in well under a second
    and chunking would only add launches. An explicit ``progress`` wins."""
    if progress is not None:
        return bool(progress)
    if quiet or opts.total_iterations < 500:
        return False
    shape = datacube.shape
    dtype = torch.from_numpy(np.empty(0, datacube.dtype)).dtype
    if _resolve_resident(opts, shape, dtype):
        return False
    return not _resolve_resident_chunks(opts, shape, dtype)


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


def _memory_note(datacube, opts: SolverOptions, quiet):
    """The device memory the run holds: orig, recon, the accumulators [,
    the shadow duals, at 2 bytes an element under lossy duals], and a stop
    run's block checkpoint of recon, the accumulators [and shadow duals]
    where its phases keep one (``holds_block_checkpoint``)."""
    if quiet:
        return
    fista, ndim = opts.iterations_fista > 0, opts.ndim
    state = 1 + (2 * ndim if fista else ndim)  # recon+accs(+ds)
    dtype = torch.from_numpy(np.empty(0, datacube.dtype)).dtype
    ckpt = holds_block_checkpoint(opts, datacube.shape, dtype)
    n_arrays = 1 + state + (state if ckpt else 0)
    n_ds = ndim * (1 + ckpt) if fista else 0
    d_size = d_dtype(opts, dtype).itemsize
    gib = datacube.size * ((n_arrays - n_ds) * dtype.itemsize
                           + n_ds * d_size) / 2**30
    label = "FISTA accelerated" if fista else "Unaccelerated"
    extra = " (a stop run's block checkpoint included)" if ckpt else ""
    if d_size != dtype.itemsize:
        extra += f" ({n_ds} of them bfloat16 shadow duals)"
    print(
        f"{label} TV denoising holds {n_arrays} cube-size arrays{extra} "
        f"≈ {gib:.2f} GiB of device memory"
    )


def _lossy_note(lossy_duals: bool, n_f: int, quiet: bool) -> None:
    """Warn once per call that ``lossy_duals`` trades exactness for memory
    and traffic (``cytvdn_tpu.api._lossy_note``); it is never a default."""
    if lossy_duals and n_f and not quiet:
        warnings.warn(
            "lossy_duals: FISTA shadow duals stored as bfloat16 — "
            "reconstruction is NOT bit-exact vs float32 (measured drift "
            "saturates ~6.8e-4 rel-L2, EXPERIMENT_BF16_DUALS.json) in "
            "exchange for a smaller state and less memory traffic",
            stacklevel=3)


def _finish(result, calculate_mse):
    """Device→host transfer and the reference's return contract
    (reference cyTVDN.py:244-247)."""
    recon = to_numpy(result["recon"])
    b_norm = to_numpy(result["b_norm"])
    delta = to_numpy(result["delta"])
    if calculate_mse:
        return recon, b_norm, delta, to_numpy(result["mse"])
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
    run happens.

    ``progress``: live per-iteration progress (tqdm when available, log
    lines otherwise) via chunked execution (state bitwise that of the
    unchunked run; traces to the last ulp); defaults to on for long
    non-quiet runs that the whole-run kernel does not serve.

    ``lossy_duals``: opt-in LOSSY mode (float32 Jia-Zhao anisotropic FISTA
    runs) — the FISTA shadow duals are stored as bfloat16 and rounded at
    every iteration, the arithmetic stays float32. The state shrinks by n
    half-size arrays (config 4: 32 GiB instead of 40); the recon is not
    bitwise the exact run's. Such runs take pairs where they pay and K=1
    launches, each bitwise the per-iteration rounding, and no K-step or
    whole-run launch (ROADMAP.md Queue 1 item 12(c)). Warns unless
    ``quiet``.
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
    _lossy_note(lossy_duals, n_f, quiet)
    _memory_note(datacube, opts, quiet)

    result = _run(datacube, lambda_inv, lam_mu, opts, reference_data, device,
                  _resolve_progress(progress, quiet, opts, datacube))
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
    ``device`` selects where the run happens; ``progress`` and
    ``lossy_duals`` as in :func:`denoise4D`.
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
    _lossy_note(lossy_duals, n_f, quiet)
    _memory_note(datacube, opts, quiet)

    result = _run(datacube, lambda_inv, lam_mu, opts, reference_data, device,
                  _resolve_progress(progress, quiet, opts, datacube))
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
