"""Solver state across the two packages.

The JAX engine's ``run_solver(..., keep_state=True)`` returns a dict with
``recon``, ``accs``, ``ds``, ``b_norm``, ``delta``, ``mse``, ``i`` and
``tk``. These helpers move such a dict, as numpy arrays, onto a torch
device and back, so a run started in one package can be continued in the
other. Accumulators keep the JAX axis order (accumulator k differences
along axis k); missing entries (``ds`` after an unaccelerated phase,
``mse`` without reference data) stay empty.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _t(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def state_from_numpy(d: Dict[str, Any], device) -> Dict[str, Any]:
    """numpy (or array-like) state dict → torch tensors on ``device``."""
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


def state_to_numpy(s: Dict[str, Any]) -> Dict[str, Any]:
    """torch state dict → numpy arrays on the host (the JAX layout)."""
    def n(t):
        return t.detach().cpu().numpy()

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
