"""Device/RAM-aware memory advisor — ``cytvdn_tpu.utils.memory`` on
PyTorch (the reference's ``check_memory``, reference cyTVDN.py:438-467,
with honest live-array counts, SURVEY.md §2.7):

- 4D FISTA: 10 cube-size arrays (orig, recon, 4 accs, 4 shadow duals)
- 4D unaccelerated: 6; 3D FISTA: 8; 3D unaccelerated: 5

The device figure is the free memory ``torch.cuda.mem_get_info`` reports
for the current CUDA device, when there is one.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch


def _live_arrays(ndim: int, fista: bool) -> int:
    return 2 + (2 * ndim if fista else ndim)


def _fmt(nbytes: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(nbytes) < 1024.0:
            return f"{nbytes:.1f} {unit}"
        nbytes /= 1024.0
    return f"{nbytes:.1f} PiB"


def _device_memory() -> Optional[int]:
    """Free bytes on the current CUDA device, or None without one."""
    if not torch.cuda.is_available():
        return None
    free, _total = torch.cuda.mem_get_info()
    return int(free)


def _host_memory() -> Optional[int]:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable"):
                    return int(line.split()[1]) * 1024
    except OSError:
        return None
    return None


def check_memory(datacube: np.ndarray, n_devices: int = 1) -> List[List[str]]:
    """Tabulate memory needed per algorithm vs free device memory and host
    RAM. ``n_devices``: devices the cube would be split over (per-device
    need scales as 1/n). Returns the table rows (also printed)."""
    ndim = datacube.ndim
    if ndim not in (3, 4):
        raise ValueError("datacube must be 3D or 4D")
    dcsize = datacube.nbytes
    dev = _device_memory()
    ram = _host_memory()

    def ok(total: int) -> str:
        per_dev = total / max(n_devices, 1)
        marks = []
        if dev is not None:
            marks.append("GPU:" + ("✅" if per_dev < dev else "❌"))
        if ram is not None:
            marks.append("RAM:" + ("✅" if total < ram else "❌"))
        return " ".join(marks) if marks else "?"

    rows = []
    for name, fista in (
        ("Anisotropic Unaccelerated", False),
        ("Anisotropic FISTA", True),
        ("(Half-)Isotropic Unaccelerated", False),
        ("(Half-)Isotropic FISTA", True),
    ):
        if "Isotropic" in name and ndim == 3:
            continue  # iso is 4D-only (reference README.md:15-16)
        total = dcsize * _live_arrays(ndim, fista)
        rows.append([name, _fmt(total), ok(total)])

    lines = [f"Datacube size is {_fmt(dcsize)} with dtype {datacube.dtype}"]
    if dev is not None:
        lines.append(
            f"Free GPU memory per device: {_fmt(dev)} × {n_devices} device(s)")
    if ram is not None:
        lines.append(f"Available host RAM: {_fmt(ram)}")
    width = max(len(r[0]) for r in rows)
    for r in rows:
        lines.append(f"{r[0]:<{width}}  {r[1]:>10}  {r[2]}")
    print("\n".join(lines))
    return rows
