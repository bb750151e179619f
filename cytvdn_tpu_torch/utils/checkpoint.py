"""Periodic checkpoint / resume for the TV solver — ``cytvdn_tpu``'s
``utils/checkpoint.py`` on PyTorch, single-process.

The solver runs in chunks of ``checkpoint_every`` iterations (``run_solver``
with ``i_stop``), and the state is written atomically to an .npz after
each chunk. Resume picks up mid-phase, mid-schedule, with the state bitwise
that of an uninterrupted run. Between chunks the state stays on the device
and is updated in place; it reaches the host only inside
:func:`save_state`.

The file format is the JAX package's (the same keys, ``meta`` JSON and
format version; ``i`` int32, ``tk`` float32, ``mse`` zero-length without
MSE, the ``early_stopped`` latch), so a checkpoint written by either
package resumes in the other. A lossy run's bfloat16 shadow duals are
stored, as the JAX package stores them, as their uint16 bit patterns, named
in the meta's ``bf16_keys`` (``np.savez`` cannot hold bfloat16), and come
back from :func:`load_state` as bfloat16 CPU tensors. Not ported:
multi-process part files (``blocks`` in the meta; ROADMAP.md Queue 1 item
9), which :func:`load_state` refuses.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from cytvdn_tpu_torch.config import BCMode, SolverOptions, normalize_iterations
from cytvdn_tpu_torch.utils.state import (
    bf16_bits,
    from_bf16_bits,
    state_from_numpy,
    to_numpy,
)

_FMT_VERSION = 1


def _atomic_savez(path: str, arrays: Dict[str, np.ndarray]):
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".ckpt.tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_state(path: str, state: Dict[str, Any], meta: Dict[str, Any]):
    """Atomic .npz checkpoint write (tmp file + rename) of a state dict
    (tensors on any device, or numpy arrays), in the JAX package's
    single-process format; bfloat16 arrays (tensors or ``ml_dtypes``
    arrays) as their uint16 bit patterns, listed in the meta's
    ``bf16_keys``."""
    mse = state.get("mse")
    arrays = {
        "b_norm": to_numpy(state["b_norm"]),
        "delta": to_numpy(state["delta"]),
        "mse": np.zeros(0) if mse is None else to_numpy(mse),
        "i": np.asarray(int(state["i"]), np.int32),
        "tk": np.asarray(to_numpy(state.get("tk", 1.0)), np.float32),
        "early_stopped": np.asarray(bool(state.get("early_stopped", False))),
        "recon": to_numpy(state["recon"]),
    }
    for k, a in enumerate(state["accs"]):
        arrays[f"acc{k}"] = to_numpy(a)
    bf16_keys = []
    for k, a in enumerate(state.get("ds") or ()):
        bits = bf16_bits(a)
        if bits is not None:
            bf16_keys.append(f"d{k}")
        arrays[f"d{k}"] = bits if bits is not None else to_numpy(a)
    extra = {"bf16_keys": bf16_keys} if bf16_keys else {}
    arrays["meta"] = np.frombuffer(
        json.dumps({**meta, "version": _FMT_VERSION, **extra}).encode(),
        dtype=np.uint8)
    _atomic_savez(path, arrays)


def load_state(path: str):
    """Load a checkpoint; returns ``(state, meta)`` with numpy arrays, and
    the arrays the meta's ``bf16_keys`` names as bfloat16 CPU tensors."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        if meta.get("blocks") is not None:
            raise NotImplementedError(
                f"{path} is one part of a multi-process checkpoint "
                f"({meta.get('num_processes')} processes); multi-process "
                f"runs are not ported to cytvdn_tpu_torch yet (ROADMAP.md "
                f"Queue 1 item 9)")
        bf16_keys = set(meta.get("bf16_keys") or ())

        def data(k):
            return from_bf16_bits(z[k]) if k in bf16_keys else z[k]

        ndim = meta["ndim"]
        state = {
            "recon": data("recon"),
            "b_norm": z["b_norm"],
            "delta": z["delta"],
            "mse": z["mse"],
            "i": z["i"],
            "tk": z["tk"] if "tk" in z.files else np.float32(1.0),
            "accs": tuple(data(f"acc{k}") for k in range(ndim)),
            "ds": tuple(data(f"d{k}") for k in range(ndim)
                        if f"d{k}" in z.files),
        }
        if "early_stopped" in z.files:
            state["early_stopped"] = bool(z["early_stopped"])
    return state, meta


def progress_chunk_size(n_total: int) -> int:
    """Chunk length for progress-driven chunked execution: frequent
    enough for a live bar, long enough to amortize the per-chunk host
    work."""
    return max(25, min(250, n_total // 40 or 1))


def checkpoint_exists(path: Optional[str]) -> bool:
    """Whether a resumable checkpoint exists at ``path``."""
    return bool(path) and os.path.exists(path)


def chunk_driver(
    run_chunk,
    n_total: int,
    checkpoint_path: Optional[str],
    checkpoint_every: int,
    resume: bool,
    meta: Dict[str, Any],
    expected_shape,
    progress=None,
):
    """The chunked-execution loop.

    ``run_chunk(engine_state_or_None, i_stop) -> out_dict`` runs the solver
    up to the global iteration cap and returns the ``keep_state=True``
    result dict; the state it is handed is a loaded checkpoint (numpy
    arrays) or the previous chunk's result, still on the device. The loop
    persists state (including the early-stop latch, so resuming a converged
    job is an idempotent no-op) and stops on convergence or completion.
    """
    state = None
    if resume and checkpoint_exists(checkpoint_path):
        state, ck_meta = load_state(checkpoint_path)
        if ck_meta["shape"] != list(expected_shape):
            raise ValueError(
                f"checkpoint shape {ck_meta['shape']} does not match input "
                f"{list(expected_shape)}"
            )
        for k, v in meta.items():
            # a checkpoint from a different schedule would silently
            # misinterpret the saved iteration index / momentum state
            if k != "shape" and ck_meta.get(k, v) != v:
                raise ValueError(
                    f"checkpoint {k}={ck_meta.get(k)!r} does not match the "
                    f"requested run's {k}={v!r}"
                )

    out = None
    while True:
        if state is not None and (
            state.get("early_stopped", False)
            or int(state["i"]) >= n_total
        ):
            break
        i_now = int(state["i"]) if state is not None else 0
        i_stop = (min(i_now + checkpoint_every, n_total)
                  if checkpoint_every > 0 else n_total)
        engine_state = (
            {k: v for k, v in state.items() if k != "early_stopped"}
            if state is not None else None
        )
        out = run_chunk(engine_state, i_stop)
        state = {
            "recon": out["recon"],
            "accs": out["accs"],
            "ds": out["ds"],
            "b_norm": out["b_norm"],
            "delta": out["delta"],
            "mse": out.get("mse"),
            "i": out["i"],
            "tk": out["tk"],
            "early_stopped": bool(out["early_stopped"]),
        }
        if checkpoint_path:
            save_state(checkpoint_path, state, meta)
        if progress is not None:
            d = to_numpy(out["delta"])
            nz = d[np.nonzero(d)]
            progress(int(out["iterations_run"]), n_total,
                     float(nz[-1]) if nz.size else float("nan"))
        if state["early_stopped"] or int(out["iterations_run"]) >= n_total:
            break
    if out is None:
        # the checkpoint already covered the whole schedule: run one
        # zero-iteration chunk so the result comes back through the
        # engine's output contract
        engine_state = {k: v for k, v in state.items()
                        if k != "early_stopped"}
        out = run_chunk(engine_state, int(state["i"]))
        out = {**out, "early_stopped": state.get("early_stopped", False)}
    return out


def run_chunked(
    datacube: np.ndarray,
    lambda_inv: np.ndarray,
    lam_mu: np.ndarray,
    opts: SolverOptions,
    checkpoint_path: Optional[str],
    checkpoint_every: int,
    resume: bool = False,
    reference_data: Optional[np.ndarray] = None,
    progress=None,
    *,
    device="cuda",
) -> Dict[str, Any]:
    """Run the solver on ``device`` in checkpointed chunks; returns the
    result dict (``recon``, ``b_norm``, ``delta`` [, ``mse``] as numpy
    arrays, ``iterations_run``).

    ``checkpoint_path`` falsy keeps no file. ``progress``: optional
    callback ``(iterations_done, n_total, delta)`` invoked after each chunk
    (the reference's per-iteration tqdm, reference cyTVDN.py:147-152). The
    state stays on the device for the whole run; its peak memory is the
    unchunked run's."""
    from cytvdn_tpu_torch.api import _to_device
    from cytvdn_tpu_torch.solver.engine import run_solver

    n_total = opts.total_iterations
    meta = {
        "ndim": opts.ndim,
        "shape": list(datacube.shape),
        "iterations_fista": opts.iterations_fista,
        "iterations_unacc": opts.iterations_unacc,
        # the JAX package's tag: an exact checkpoint resumed lossy (or vice
        # versa) would change the duals' rounding mid-run
        "lossy_duals": bool(opts.lossy_duals and opts.iterations_fista),
    }
    device = torch.device(device)
    orig = _to_device(datacube, device)
    li = _to_device(lambda_inv, device)
    lm = _to_device(lam_mu, device)
    ref = _to_device(reference_data, device) if opts.calculate_mse else None

    def run_chunk(engine_state, i_stop):
        if engine_state is not None and \
                not torch.is_tensor(engine_state["recon"]):
            engine_state = state_from_numpy(engine_state, device)
        return run_solver(orig, li, lm, opts, ref, state=engine_state,
                          i_stop=i_stop, keep_state=True)

    out = chunk_driver(run_chunk, n_total, checkpoint_path,
                       checkpoint_every, resume, meta, datacube.shape,
                       progress=progress)

    result = {
        "recon": to_numpy(out["recon"]),
        "b_norm": to_numpy(out["b_norm"]),
        "delta": to_numpy(out["delta"]),
        "iterations_run": int(out["iterations_run"]),
    }
    if opts.calculate_mse:
        result["mse"] = to_numpy(out["mse"])
    return result


def run_with_checkpointing(
    datacube: np.ndarray,
    mu,
    lam=None,
    iterations=10,
    FISTA=True,
    stopping_relative_change=None,
    BC_mode=2,
    isotropic_R=False,
    isotropic_Q=False,
    reference_data=None,
    quiet=True,
    backend="auto",
    checkpoint_path: str = "",
    checkpoint_every: int = 0,
    resume: bool = False,
    lossy_duals: bool = False,
    *,
    device="cuda",
) -> Dict[str, Any]:
    """User-level checkpointed run with the ``denoise*`` parameter surface
    and the ``device`` keyword of this package's API."""
    from cytvdn_tpu_torch.api import _memory_note, _validate_and_derive

    ndim = np.asarray(datacube).ndim
    datacube, mu, lam, lambda_inv, lam_mu = _validate_and_derive(
        datacube, mu, lam, ndim, 32.0 if ndim == 4 else 16.0
    )
    n_f, n_u = normalize_iterations(iterations, FISTA)
    opts = SolverOptions(
        ndim=ndim,
        iterations_fista=n_f,
        iterations_unacc=n_u,
        bc_mode=BCMode(BC_mode),
        stopping_relative_change=stopping_relative_change,
        isotropic_R=isotropic_R,
        isotropic_Q=isotropic_Q,
        calculate_mse=reference_data is not None,
        backend=backend,
        lossy_duals=lossy_duals,
    )
    _memory_note(datacube, opts, quiet)
    return run_chunked(
        datacube, lambda_inv, lam_mu, opts, checkpoint_path,
        checkpoint_every, resume, reference_data, device=device,
    )
