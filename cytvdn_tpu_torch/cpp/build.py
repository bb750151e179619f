"""Build-on-first-use for the native CPU kernels of ``backend="cpp"``.

The counterpart of ``cytvdn_tpu/cpp/build.py``: the shared C++ source
``csrc/tvdn_cpu.cpp`` at the repository's root (the JAX package builds the
same file) is compiled once with the system compiler, ``g++ -O3 -fopenmp
-shared -fPIC -std=c++17 -march=native`` (again without ``-march=native``
where the toolchain refuses it), into ``cytvdn_tpu_torch/_build/``. The
cache key is the source's hash, the host's CPU feature flags and the
compiler's version, never an mtime: a ``-march=native`` binary built on an
AVX-512 host would load on another host of a shared filesystem and fault
there at its first call.

A missing source or compiler, or a failed compile, raises with the
compiler's output: no path falls back to another backend.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(os.path.dirname(_PKG_DIR), "csrc", "tvdn_cpu.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
LIB = os.path.join(BUILD_DIR, "libtvdn_cpu.so")
_STAMP = LIB + ".hash"
FLAGS = ["-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17"]

_LOCK = threading.Lock()
_built: Optional[str] = None
#: the error of a failed build, raised again on every later call
_failure: Optional[str] = None


def compiler() -> Optional[str]:
    """The first C++ compiler on ``PATH``: ``g++``, ``clang++``, ``c++``."""
    for cc in ("g++", "clang++", "c++"):
        if shutil.which(cc):
            return cc
    return None


def _key(cc: str) -> str:
    """The source's hash, the CPU's feature flags and the compiler's
    version (``cytvdn_tpu/cpp/build.py:30-58``)."""
    h = hashlib.sha256()
    with open(SRC, "rb") as f:
        h.update(f.read())
    h.update(os.uname().machine.encode())
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    h.update(line.encode())
                    break
    except OSError:
        pass
    try:
        out = subprocess.run([cc, "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"the C++ backend cannot be built: {cc} "
                           f"--version: {e}") from None
    h.update(out.splitlines()[0].encode() if out else b"")
    h.update(" ".join(FLAGS).encode())
    return h.hexdigest()


def _compile(cc: str, out: str) -> None:
    """Compile the source into ``out``, with ``-march=native`` first."""
    errors: List[str] = []
    for extra in (["-march=native"], []):
        cmd = [cc, *FLAGS, *extra, SRC, "-o", out]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"the C++ backend cannot be built: "
                               f"{' '.join(cmd)}: {e}") from None
        if proc.returncode == 0:
            return
        errors.append(f"{' '.join(cmd)} (rc {proc.returncode}):\n"
                      f"{proc.stderr[-4000:]}")
    raise RuntimeError("the C++ backend failed to build:\n"
                       + "\n".join(errors))


def build(force: bool = False) -> str:
    """Compile the library where its key changed (or with ``force``) and
    return its path. Raises ``RuntimeError`` with the compiler's output
    where it cannot be built, then and on every later call unless
    ``force``."""
    global _built, _failure
    with _LOCK:
        if not force:
            if _built is not None:
                return _built
            if _failure is not None:
                raise RuntimeError(_failure)
        _built = None
        try:
            if not os.path.exists(SRC):
                raise RuntimeError(f"the C++ backend's source {SRC} is "
                                   "missing")
            cc = compiler()
            if cc is None:
                raise RuntimeError("the C++ backend needs a C++ compiler "
                                   "(g++, clang++ or c++) on PATH")
            want = _key(cc)
            have = None
            if not force and os.path.exists(LIB) and os.path.exists(_STAMP):
                with open(_STAMP) as f:
                    have = f.read().strip()
            if have != want:
                os.makedirs(BUILD_DIR, exist_ok=True)
                # built beside and renamed: a process that loads the
                # library meanwhile sees the old file or the new one whole
                tmp = f"{LIB}.{os.getpid()}.tmp"
                try:
                    _compile(cc, tmp)
                    os.replace(tmp, LIB)
                finally:
                    if os.path.exists(tmp):
                        os.remove(tmp)
                with open(_STAMP, "w") as f:
                    f.write(want)
        except Exception as e:
            _failure = str(e)
            raise
        _failure = None
        _built = LIB
        return LIB
