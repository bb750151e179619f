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

#: published peak float32 rate outside the tensor cores (operations/s), by
#: the same names
PEAK_F32 = {
    "H100 80GB HBM3": 67e12,
}


def _lookup(table, device_name: str) -> Optional[float]:
    for key, value in table.items():
        if key in device_name:
            return value
    return None


def peak_bandwidth(device_name: str) -> Optional[float]:
    """Published peak bytes/s of a card by name, or None if unknown."""
    return _lookup(PEAK_BW, device_name)


def peak_f32(device_name: str) -> Optional[float]:
    """Published peak float32 operations/s of a card by name, or None."""
    return _lookup(PEAK_F32, device_name)


def traversals_per_iteration(ndim: int, fista: bool, backend: str,
                             k: int = 2) -> float:
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
    - the K-step kernel (``kernels/kstep.py``, depth ``k``) lies in the same
      band made K deep: ``kstep_upper``, when no row survives in L2, is the
      two-pass traffic; ``kstep_floor``, one fused pass per K iterations,
      is (4n+3)/K / (2n+3)/K.
    """
    n = ndim
    one_pass = (4 * n + 3) if fista else (2 * n + 3)
    if backend == "fused":
        return one_pass
    if backend in ("two_pass", "pair_upper", "kstep_upper"):
        return (5 * n + 4) if fista else (3 * n + 4)
    if backend == "pair_floor":
        return one_pass / 2
    if backend == "kstep_floor":
        return one_pass / k
    raise ValueError(backend)


def _voxels(shape) -> int:
    n_vox = 1
    for e in shape:
        n_vox *= e
    return n_vox


def model_seconds(shape, fista: bool, backend: str, bandwidth: float,
                  itemsize: int = 4, k: int = 2) -> float:
    """Least time per iteration the traffic model allows at ``bandwidth``."""
    trav = traversals_per_iteration(len(shape), fista, backend, k)
    return trav * _voxels(shape) * itemsize / bandwidth


def launch_bytes(shape, fista: bool, itemsize: int = 4,
                 ref: bool = False, band_rows: int = 0) -> int:
    """Bytes one launch of any of the port's kernels (one, two or K
    iterations) must move: each input read once (orig, recon, n
    accumulators [, n shadow duals] [, the reference cube]) and each output
    written once (recon, n accumulators [, n shadow duals]), i.e. 4n+3
    (FISTA) or 2n+3 cube traversals, one more with a reference cube; plus
    ``band_rows`` axis-0 rows of the shape moved once (a mesh shard's
    seam bands)."""
    trav = traversals_per_iteration(len(shape), fista, "fused") + int(ref)
    row = _voxels(shape) // shape[0]
    return (trav * _voxels(shape) + band_rows * row) * itemsize


def launch_operations(shape, fista: bool, iterations: int,
                      ref: bool = False) -> int:
    """Arithmetic operations of ``iterations`` TV iterations: per voxel and
    axis the dual update (difference, add, max, min, abs, sum; FISTA adds
    subtract, multiply, add) and the divergence (subtract, multiply, add),
    then per voxel the reconstruction (subtract) and its two sums (subtract,
    two abs, two adds) [, and against a reference cube its squared error
    (subtract, multiply, add)]."""
    n = len(shape)
    per_voxel = n * ((9 if fista else 6) + 3) + 6 + (3 if ref else 0)
    return per_voxel * _voxels(shape) * iterations


def launch_bound_seconds(shape, fista: bool, iterations: int,
                         bandwidth: float, flops: float, ref: bool = False,
                         band_rows: int = 0):
    """The least time one launch could take on a card with ``bandwidth``
    bytes/s and ``flops`` operations/s: the larger of :func:`launch_bytes`
    over the bandwidth and :func:`launch_operations` over the rate, and
    which of the two it is (``"bytes"`` or ``"operations"``). ``ref``: the
    launch also reads a reference cube and sums each iteration's squared
    error against it (the pair kernel's MSE launch); ``band_rows``: rows
    of seam bands it also moves (the pair kernel's ``HALO0`` launch)."""
    t_bytes = launch_bytes(shape, fista, ref=ref,
                           band_rows=band_rows) / bandwidth
    t_ops = launch_operations(shape, fista, iterations, ref=ref) / flops
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
