"""Traffic model of the TV iteration (hardware-neutral).

The workload is memory-bandwidth-bound (O(1) flops per voxel and pass,
reference README.md:114), so throughput is cube traversals per iteration
against the card's memory bandwidth.
"""

from __future__ import annotations

from typing import Optional

#: published peak memory bandwidth (bytes/s), matched against
#: ``torch.cuda.get_device_name()`` (NVIDIA data sheets)
PEAK_BW = {
    "H100 80GB HBM3": 3.35e12,   # H100 SXM
}


def peak_bandwidth(device_name: str) -> Optional[float]:
    """Published peak bytes/s of a card by name, or None if unknown."""
    for key, bw in PEAK_BW.items():
        if key in device_name:
            return bw
    return None


def traversals_per_iteration(ndim: int, fista: bool, backend: str) -> float:
    """Cube-size array read+write traversals per full TV iteration.

    - ``fused`` (one pass): reads orig, recon, n accs [, n ds]; writes
      recon, n accs [, n ds]  →  4n+3 (FISTA) / 2n+3 (plain).
    - ``two_pass`` (the CUDA kernel of ``kernels/fused.py``): a dual pass
      (read recon, rw n accs [, rw n ds]) then a reconstruction pass that
      reads the accumulators again (read orig, n accs; rw recon)
      →  5n+4 / 3n+4.
    - the pair kernel (``kernels/temporal.py``) lies in a band:
      ``pair_upper``, when no row of its wavefront survives in L2 between
      the sub-stages that touch it, is the two-pass traffic; ``pair_floor``,
      when every iteration-1 row is re-read from L2, is one pass of the
      fused traffic per two iterations →  (4n+3)/2 / (2n+3)/2 (9.5 in 4D
      FISTA; ``cytvdn_tpu``'s ``pair`` adds its seam bands to this).
    """
    n = ndim
    if backend == "fused":
        return (4 * n + 3) if fista else (2 * n + 3)
    if backend in ("two_pass", "pair_upper"):
        return (5 * n + 4) if fista else (3 * n + 4)
    if backend == "pair_floor":
        return ((4 * n + 3) if fista else (2 * n + 3)) / 2
    raise ValueError(backend)


def model_seconds(shape, fista: bool, backend: str, bandwidth: float,
                  itemsize: int = 4) -> float:
    """Least time per iteration the traffic model allows at ``bandwidth``."""
    n_vox = 1
    for e in shape:
        n_vox *= e
    trav = traversals_per_iteration(len(shape), fista, backend)
    return trav * n_vox * itemsize / bandwidth
