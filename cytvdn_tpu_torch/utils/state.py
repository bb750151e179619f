"""Solver state across the two packages.

The JAX engine's ``run_solver(..., keep_state=True)`` returns a dict with
``recon``, ``accs``, ``ds``, ``b_norm``, ``delta``, ``mse``, ``i`` and
``tk``. These helpers move such a dict, as numpy arrays, onto a torch
device and back, so a run started in one package can be continued in the
other. Accumulators keep the JAX axis order (accumulator k differences
along axis k); missing entries (``ds`` after an unaccelerated phase,
``mse`` without reference data) stay empty.

Lossy runs store their shadow duals as bfloat16, which numpy has no type
for: the JAX package hands them over as ``ml_dtypes`` bfloat16 arrays,
checkpoints hold their uint16 bit patterns, and here they are bfloat16
tensors. :func:`state_from_numpy` takes all three; :func:`to_numpy` widens
a bfloat16 tensor to float32, exactly, and an engine casts such duals back
when it adopts them (``solver/engine.py::_adopt``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


def bf16_bits(x) -> Optional[np.ndarray]:
    """The uint16 bit patterns of a bfloat16 tensor or ``ml_dtypes``
    bfloat16 array, on the host; None for any other array."""
    if torch.is_tensor(x):
        if x.dtype != torch.bfloat16:
            return None
        return x.detach().cpu().contiguous().view(torch.int16).numpy() \
            .view(np.uint16)
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else None


def from_bf16_bits(bits: np.ndarray) -> torch.Tensor:
    """A bfloat16 CPU tensor from uint16 bit patterns (copied)."""
    return torch.from_numpy(np.array(bits, np.uint16).view(np.int16)) \
        .view(torch.bfloat16)


def _t(a, device) -> torch.Tensor:
    if torch.is_tensor(a):
        return a.detach().to(device, copy=True)
    bits = bf16_bits(a)
    if bits is not None:
        return from_bf16_bits(bits).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def state_from_numpy(d: Dict[str, Any], device) -> Dict[str, Any]:
    """numpy (or array-like, or CPU tensor) state dict → torch tensors on
    ``device``; bfloat16 duals stay bfloat16."""
    device = torch.device(device)
    return {
        "recon": _t(d["recon"], device),
        "accs": [_t(a, device) for a in d["accs"]],
        "ds": [_t(a, device) for a in d.get("ds", ())],
        "b_norm": _t(d["b_norm"], device),
        "delta": _t(d["delta"], device),
        "mse": _t(d["mse"], device) if d.get("mse") is not None else None,
        "i": int(np.asarray(d["i"])),
        "tk": _t(np.asarray(d.get("tk", 1.0), np.float32), device),
    }


def to_numpy(x) -> np.ndarray:
    """A tensor on any device (or an array-like) as a numpy array on the
    host; a bfloat16 tensor widened exactly to float32."""
    if not torch.is_tensor(x):
        return np.asarray(x)
    x = x.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def state_to_numpy(s: Dict[str, Any]) -> Dict[str, Any]:
    """torch state dict → numpy arrays on the host (the JAX layout)."""
    n = to_numpy
    return {
        "recon": n(s["recon"]),
        "accs": tuple(n(a) for a in s["accs"]),
        "ds": tuple(n(a) for a in (s.get("ds") or ())),
        "b_norm": n(s["b_norm"]),
        "delta": n(s["delta"]),
        "mse": n(s["mse"]) if s.get("mse") is not None else None,
        "i": np.int32(s["i"]),
        "tk": n(s["tk"]),
    }
