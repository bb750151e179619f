"""Build-on-first-use for the package's CUDA kernels.

``nvcc`` compiles each ``cytvdn_tpu_torch/csrc/*.cu`` into an object, all
sources at once in parallel processes, and links the objects into one
shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers: a build takes seconds, not minutes). The library lands in
``cytvdn_tpu_torch/_build/`` and is rebuilt when the hash of the sources,
the flags or the compiler changes (the scheme of
``cytvdn_tpu/cpp/build.py``). A missing ``nvcc`` or a failed build raises:
there is no fallback to the plain version.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
import weakref
from typing import Optional

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_LIB = os.path.join(BUILD_DIR, "libcytvdn_cuda.so")
_STAMP = _LIB + ".hash"
LOG = os.path.join(BUILD_DIR, "build.log")

FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no FMA contraction: the kernels are held bitwise against PyTorch's
    # separate multiply and add kernels
    "--fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LOCK = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: wall seconds of the last nvcc run in this process (0.0 if cached)
build_seconds = 0.0


def _sources():
    return sorted(glob.glob(os.path.join(_SRC_DIR, "*.cu")))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                       "the CUDA kernels cannot be built")


def _hash(nvcc: str) -> str:
    h = hashlib.sha256()
    headers = glob.glob(os.path.join(_SRC_DIR, "*.cuh"))
    for src in sorted(_sources() + headers):
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(FLAGS).encode())
    h.update(subprocess.run([nvcc, "--version"], capture_output=True,
                            text=True, check=True).stdout.encode())
    return h.hexdigest()


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in ("tv_fused_iteration_f32", "tv_fused_iteration_f64"):
        fn = getattr(lib, name)
        # the state, scalars and sums, then the seam pointer table (null: no
        # halos) and the trailing-edge bits; fista, bc, iso_r, iso_q, lossy
        # and the grid
        fn.argtypes = [vp] * 16 + [i] * 2 + [ll] * 4 + [i] * 6 + [vp]
        fn.restype = i
    # the state, scalars and sums, then the HALO0 band table (null: no
    # halos) and the first0/last0 flags; fista, lossy, the grid
    lib.tv_pair_iteration_f32.argtypes = \
        [vp] * 18 + [i] * 3 + [ll] * 5 + [i] * 3 + [vp]
    lib.tv_pair_iteration_f32.restype = i
    lib.tv_pair_max_blocks.argtypes = [i, i, i, i, i, ctypes.POINTER(i)]
    lib.tv_pair_max_blocks.restype = i
    # the state, scalars and sums, ndim, the extents; fista, lossy, k, R,
    # the grid
    lib.tv_kstep_iteration_f32.argtypes = \
        [vp] * 15 + [i] + [ll] * 4 + [i] * 5 + [vp]
    lib.tv_kstep_iteration_f32.restype = i
    lib.tv_kstep_max_blocks.argtypes = [i, i, i, i, ctypes.POINTER(i)]
    lib.tv_kstep_max_blocks.restype = i
    lib.tv_resident_solve_f32.argtypes = \
        [vp] * 16 + [i] + [ll] * 4 + [i] * 6 + [vp]
    lib.tv_resident_solve_f32.restype = i
    lib.tv_resident_max_blocks.argtypes = [i, i, i, i, ctypes.POINTER(i)]
    lib.tv_resident_max_blocks.restype = i
    lib.tv_host_alloc.argtypes = [ctypes.c_size_t, ctypes.POINTER(vp)]
    lib.tv_host_alloc.restype = i
    lib.tv_host_free.argtypes = [vp]
    lib.tv_host_free.restype = i
    lib.tv_error_string.argtypes = [i]
    lib.tv_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """Build the library if its sources changed, load it, bind it."""
    global _lib, build_seconds
    with _LOCK:
        if _lib is not None:
            return _lib
        nvcc = nvcc_path()
        want = _hash(nvcc)
        have = None
        if os.path.exists(_LIB) and os.path.exists(_STAMP):
            with open(_STAMP) as f:
                have = f.read().strip()
        if have != want:
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{_LIB}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            # one nvcc per source, all started together, then one link
            steps = []
            for src in _sources():
                obj = f"{tmp}.{os.path.basename(src)}.o"
                cmd = [nvcc, *FLAGS, "-c", "-o", obj, src]
                steps.append((cmd, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            log, failed = [], []
            for cmd, _, proc in steps:
                out = proc.communicate()[0]
                log.append(" ".join(cmd) + "\n" + out)
                if proc.returncode != 0:
                    failed.append(f"{cmd[-1]} (rc {proc.returncode}):\n"
                                  f"{out[-4000:]}")
            if not failed:
                cmd = [nvcc, *FLAGS[:2], "-shared", "-o", tmp,
                       *(o for _, o, _ in steps)]
                proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                log.append(" ".join(cmd) + "\n" + proc.stdout)
                if proc.returncode != 0:
                    failed.append(f"link (rc {proc.returncode}):\n"
                                  f"{proc.stdout[-4000:]}")
            for _, obj, _ in steps:
                if os.path.exists(obj):
                    os.remove(obj)
            build_seconds = time.perf_counter() - t0
            with open(LOG, "w") as f:
                f.write("\n".join(log))
            if failed:
                raise RuntimeError("nvcc failed: " + "\n".join(failed))
            os.replace(tmp, _LIB)
            with open(_STAMP, "w") as f:
                f.write(want)
        _lib = _bind(ctypes.CDLL(_LIB))
        return _lib


def host_empty(shape, dtype=np.float32) -> np.ndarray:
    """An uninitialised numpy array in page-locked host memory
    (``cudaHostAlloc``, exactly sized), freed when its last view goes."""
    lib = load()
    nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
    ptr = ctypes.c_void_p()
    check(lib.tv_host_alloc(max(nbytes, 1), ctypes.byref(ptr)))
    buf = (ctypes.c_char * max(nbytes, 1)).from_address(ptr.value)
    weakref.finalize(buf, lib.tv_host_free, ptr.value).atexit = False
    return np.frombuffer(buf, dtype, count=int(np.prod(shape))).reshape(shape)


def check(err: int) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = load().tv_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel launch failed: error {err} ({msg})")
