"""ctypes bindings and the host solver loop of the native CPU kernels.

The counterpart of ``cytvdn_tpu/cpp/backend.py`` (the reference driver's
control flow, reference cyTVDN/cyTVDN.py:147-242): per iteration the
accumulator updates (anisotropic, or half-isotropic pairs), the
reconstruction update, the optional SSE against a reference cube, the
early stop, and the hybrid FISTA → unaccelerated schedule, on numpy arrays
in place through the C++/OpenMP kernels of ``csrc/tvdn_cpu.cpp``
(:mod:`cytvdn_tpu_torch.cpp.build`). It is ``backend="cpp"``: a host-only
path that touches no card and no PyTorch kernel.

The kernels' sums are OpenMP reductions, whose order is not fixed: the
traces may differ in the last bits from run to run; the state does not.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np
import torch

from cytvdn_tpu_torch.config import SolverOptions
from cytvdn_tpu_torch.cpp import build as _build

_lib: Optional[ctypes.CDLL] = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64p = ctypes.POINTER(ctypes.c_int64)
    dp = ctypes.POINTER(ctypes.c_double)
    cint, cdbl = ctypes.c_int, ctypes.c_double
    for suffix, fptr in (("f32", ctypes.POINTER(ctypes.c_float)),
                         ("f64", dp)):
        acc = getattr(lib, f"tv_acc_update_{suffix}")
        acc.restype = cdbl
        acc.argtypes = [fptr, fptr, fptr, cdbl, i64p, cint, cint, cdbl, cint]
        iso = getattr(lib, f"tv_iso_update_{suffix}")
        iso.restype = cdbl
        iso.argtypes = [fptr] * 5 + [cdbl, i64p, cint, cint, cdbl]
        r3 = getattr(lib, f"tv_recon_update_3d_{suffix}")
        r3.restype = None
        r3.argtypes = [fptr] * 6 + [i64p, cint, dp, dp]
        r4 = getattr(lib, f"tv_recon_update_4d_{suffix}")
        r4.restype = None
        r4.argtypes = [fptr] * 7 + [i64p, cint, dp, dp]
        s = getattr(lib, f"tv_sse_{suffix}")
        s.restype = cdbl
        s.argtypes = [fptr, fptr, ctypes.c_int64]
    lib.tv_num_threads.restype = cint
    lib.tv_num_threads.argtypes = []
    return lib


def load() -> ctypes.CDLL:
    """Build the library where needed, load and bind it. Raises
    ``RuntimeError`` with the compiler's (or the loader's) message where it
    cannot."""
    global _lib
    if _lib is None:
        path = _build.build()
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            # e.g. no libgomp on this host
            raise RuntimeError(f"the C++ backend's library {path} does not "
                               f"load: {e}") from None
        _lib = _bind(lib)
    return _lib


def native_available() -> bool:
    """Whether the C++ backend builds and loads on this host."""
    try:
        load()
    except RuntimeError:
        return False
    return True


def native_num_threads() -> int:
    """The OpenMP threads the kernels run on (0 where the backend is not
    available)."""
    return load().tv_num_threads() if native_available() else 0


def _suffix(dtype) -> str:
    return "f32" if dtype == np.float32 else "f64"


def _ptr(arr: np.ndarray):
    """A C pointer to a C-contiguous float32 or float64 array, which the
    kernels read and write through flat indices."""
    if arr.dtype not in (np.float32, np.float64) \
            or not arr.flags.c_contiguous:
        raise ValueError(f"the C++ kernels take C-contiguous float32 or "
                         f"float64 arrays, got {arr.dtype}"
                         f"{'' if arr.flags.c_contiguous else ', strided'}")
    return arr.ctypes.data_as(ctypes.POINTER(
        ctypes.c_float if arr.dtype == np.float32 else ctypes.c_double))


def _shape(a: np.ndarray):
    return (ctypes.c_int64 * a.ndim)(*a.shape)


def acc_update(a, b, ax, clip, bc, d=None, tk=0.0) -> float:
    """One accumulator update along ``ax`` in place (``d``: FISTA with
    momentum ``tk``); returns the L1 norm of the updated ``b``."""
    fn = getattr(load(), f"tv_acc_update_{_suffix(a.dtype)}")
    return fn(_ptr(a), _ptr(b), _ptr(d) if d is not None else None,
              float(tk), _shape(a), a.ndim, int(ax), float(clip), int(bc))


def iso_update(a, b1, b2, ax1, ax2, clip, d1=None, d2=None, tk=0.0) -> float:
    """The half-isotropic update of the pair (``ax1``, ``ax2``) in place;
    returns the L1 norm of both updated accumulators."""
    fn = getattr(load(), f"tv_iso_update_{_suffix(a.dtype)}")
    return fn(_ptr(a), _ptr(b1), _ptr(b2),
              _ptr(d1) if d1 is not None else None,
              _ptr(d2) if d2 is not None else None, float(tk), _shape(a),
              int(ax1), int(ax2), float(clip))


def recon_update(orig, recon, bs, lam_mu, bc) -> float:
    """The reconstruction update in place; returns delta, the relative L1
    change (NaN for an all-zero recon, the 0/0 of the device paths)."""
    lib = load()
    dn, rn = ctypes.c_double(), ctypes.c_double()
    w = np.ascontiguousarray(lam_mu, dtype=orig.dtype)
    fn = getattr(lib, f"tv_recon_update_{orig.ndim}d_{_suffix(orig.dtype)}")
    fn(_ptr(orig), _ptr(recon), *(_ptr(b) for b in bs), _ptr(w),
       _shape(orig), int(bc), ctypes.byref(dn), ctypes.byref(rn))
    return dn.value / rn.value if rn.value else float("nan")


def sum_square_error(a, b) -> float:
    """Σ (a - b)², not divided by N (reference utils.pyx:14-49)."""
    fn = getattr(load(), f"tv_sse_{_suffix(a.dtype)}")
    return fn(_ptr(a), _ptr(b), a.size)


def _host(x, dtype=None) -> np.ndarray:
    """``x`` (a numpy array or a CPU tensor) as a C-contiguous numpy array,
    of ``dtype`` where given."""
    if torch.is_tensor(x):
        if x.device.type != "cpu":
            raise ValueError(f"backend='cpp' runs on host arrays, got a "
                             f"tensor on {x.device}")
        x = x.detach().numpy()
    return np.ascontiguousarray(x, dtype=dtype)


def solve_cpp(
    orig,
    lambda_inv,
    lam_mu,
    opts: SolverOptions,
    reference_data=None,
) -> Dict[str, object]:
    """The whole schedule on the host through the native kernels
    (``cytvdn_tpu/cpp/backend.py::solve_cpp``). Takes numpy arrays (or CPU
    tensors) and returns the dict of the engine's ``run_solver``:
    ``recon``, ``b_norm``, ``delta`` [, ``mse``] as CPU tensors,
    ``iterations_run`` (int) and ``early_stopped`` (bool). Raises
    ``RuntimeError`` with the compiler's output where the backend cannot be
    built; nothing falls back to another backend."""
    load()
    orig = _host(orig)
    dtype = orig.dtype
    lambda_inv = _host(lambda_inv, dtype)
    ndim = opts.ndim
    if reference_data is not None:
        reference_data = _host(reference_data, dtype)
        if reference_data.shape != orig.shape:
            raise ValueError("reference_data shape must match the datacube")
    n_f, n_u = opts.iterations_fista, opts.iterations_unacc
    n_total = n_f + n_u
    stopping = opts.stopping_relative_change
    bc = int(opts.bc_mode)

    accs = [np.zeros_like(orig) for _ in range(ndim)]
    ds = [np.zeros_like(orig) for _ in range(ndim)] if n_f else None
    recon = orig.copy()
    b_norm = np.zeros(n_total, dtype=dtype)
    delta = np.zeros(n_total, dtype=dtype)
    mse = None
    if opts.calculate_mse:
        mse = np.zeros(n_total + 1, dtype=dtype)
        mse[0] = sum_square_error(orig, reference_data)

    def axis_pass(fista: bool, tk_ratio: float) -> float:
        total = 0.0
        aniso = []
        if ndim == 4 and opts.isotropic_R:
            total += iso_update(
                recon, accs[0], accs[1], 0, 1, lambda_inv[0],
                ds[0] if fista else None, ds[1] if fista else None, tk_ratio)
        else:
            aniso = [0, 1] if ndim == 4 else [0, 1, 2]
        if ndim == 4:
            if opts.isotropic_Q:
                total += iso_update(
                    recon, accs[2], accs[3], 2, 3, lambda_inv[2],
                    ds[2] if fista else None, ds[3] if fista else None,
                    tk_ratio)
            else:
                aniso += [2, 3]
        for ax in aniso:
            total += acc_update(recon, accs[ax], ax, lambda_inv[ax], bc,
                                ds[ax] if fista else None, tk_ratio)
        return total

    def step(i: int, fista: bool, tk_ratio: float) -> bool:
        b_norm[i] = axis_pass(fista, tk_ratio)
        delta[i] = recon_update(orig, recon, accs, lam_mu, bc)
        if mse is not None:
            mse[i + 1] = sum_square_error(reference_data, recon)
        return stopping is not None and delta[i] < stopping

    it_run, stopped = 0, False
    tk = 1.0
    for i in range(n_f):
        # the momentum in float64, as the reference's Python floats
        tk_new = (1.0 + np.sqrt(1.0 + 4.0 * tk * tk)) / 2.0
        tk_ratio = (tk - 1.0) / tk_new
        tk = tk_new
        stopped = step(i, True, tk_ratio)
        it_run = i + 1
        if stopped:
            break
    if n_u:
        stopped = False  # the second phase runs regardless (reference)
    for i in range(n_f, n_total):
        stopped = step(i, False, 0.0)
        it_run = i + 1
        if stopped:
            break

    out = {"recon": torch.from_numpy(recon),
           "b_norm": torch.from_numpy(b_norm),
           "delta": torch.from_numpy(delta),
           "iterations_run": it_run, "early_stopped": stopped}
    if mse is not None:
        out["mse"] = torch.from_numpy(mse)
    return out
