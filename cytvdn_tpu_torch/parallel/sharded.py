"""The solver on a mesh of processes: the counterpart of
``cytvdn_tpu/parallel/sharded.py`` (``resolve_shard``,
``temporal_mesh_preference``, ``run_sharded``), the replacement for the
reference's MPI runtime ``run_MPI`` (reference cyTVDN/mpi.py:27-501).

The JAX package runs one program over a device mesh (``shard_map``); here
every process runs the same engine on its own block, with a
``parallel/halo.py::MeshComm`` for the seams and the sums — one engine for
one device and for a mesh, as in the JAX package. The mesh splits the scan
axes (0, 1 or both, as the reference splits them, mpi.py:357-358) into
even tiles: every rank's block has the same shape, so the engine's plan,
which depends on the shape, dtype and options only, is the same on every
rank, and so is every collective it makes.
"""

from __future__ import annotations

import dataclasses
import gc
import warnings
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from cytvdn_tpu_torch.config import BCMode, SolverOptions
from cytvdn_tpu_torch.kernels.temporal import pair_supported
from cytvdn_tpu_torch.parallel.partition import choose_grid
from cytvdn_tpu_torch.solver.engine import prepare_run, run_prepared


def resolve_shard(
    shard: Union[str, Sequence[int], None],
    shape: Tuple[int, ...],
    n_devices: int,
    prefer_axis0: bool = False,
) -> Tuple[int, ...]:
    """Normalize the ``shard`` argument to a per-data-axis tile-count tuple,
    as ``cytvdn_tpu``'s ``resolve_shard`` does.

    ``'auto'`` chooses a grid over the two scan axes with the
    edge-minimizing partitioner (the reference's policy, mpi.py:130-153).
    ``prefer_axis0``: where the run may take the pair kernel, take
    ``(N, 1, ...)`` whenever axis 0 tiles evenly with >= 4 rows per shard,
    else ``(1, N, ...)`` when axis 1 tiles with >= 2 columns; the JAX
    package's TPU-only HBM gate (``pair_hbm_viable``) is the port's
    :func:`pair_supported` on the local shape. Where the scan axes do not
    tile over ``n_devices``, the largest count that tiles evenly is taken
    (even tiling is what keeps a mesh run bit-exact)."""
    ndim = len(shape)
    if shard is None:
        return (1,) * ndim
    if shard == "auto":
        if prefer_axis0:
            if shape[0] % n_devices == 0 and shape[0] // n_devices >= 4:
                local = (shape[0] // n_devices,) + tuple(shape[1:])
                if pair_supported(local, torch.float32, BCMode.JIA_ZHAO):
                    return (n_devices,) + (1,) * (ndim - 1)
            if shape[0] >= 4 and shape[1] % n_devices == 0 \
                    and shape[1] // n_devices >= 2:
                local = (shape[0], shape[1] // n_devices) + tuple(shape[2:])
                if pair_supported(local, torch.float32, BCMode.JIA_ZHAO):
                    return (1, n_devices) + (1,) * (ndim - 2)
        for n in range(n_devices, 0, -1):
            try:
                grid = choose_grid(n, shape[:2])
            except ValueError:
                continue
            return tuple(grid) + (1,) * (ndim - 2)
        return (1,) * ndim
    shard = tuple(int(s) for s in shard)
    if len(shard) != ndim:
        raise ValueError(f"shard must have {ndim} entries, got {shard}")
    for ax, (w, e) in enumerate(zip(shard, shape)):
        if e % w:
            raise ValueError(
                f"axis {ax} extent {e} not divisible by {w} tiles; choose a "
                f"divisible tiling (or pad the cube)"
            )
    return shard


def temporal_mesh_preference(opts: SolverOptions, dtype) -> bool:
    """Whether an ``'auto'`` mesh should favour a single-axis split: the
    run is eligible for the pair kernel (``temporal_pairs``, Jia-Zhao,
    anisotropic, no ``fista_restart``, float32)."""
    return (
        opts.temporal_pairs
        and opts.bc_mode == BCMode.JIA_ZHAO
        and not (opts.isotropic_R or opts.isotropic_Q)
        and not opts.fista_restart
        and np.dtype(dtype) == np.float32
    )


def run_sharded(
    orig: torch.Tensor,
    lambda_inv: torch.Tensor,
    lam_mu: torch.Tensor,
    opts: SolverOptions,
    comm,
    reference_data: Optional[torch.Tensor] = None,
    state: Optional[Dict[str, Any]] = None,
    i_stop: Optional[int] = None,
    keep_state: bool = False,
) -> Dict[str, object]:
    """This rank's part of a mesh run: ``orig`` (and ``reference_data``,
    and the tensors of ``state``) are its block, ``comm`` its
    ``MeshComm``; every rank of the mesh calls this with the same
    options. Same return contract as ``run_solver``, with the traces of
    the whole cube and this rank's block of the state.

    The device-memory ladder (knob ``temporal_pairs`` only, as
    ``sharded.py:274-279``: under a mesh the whole-run and K-step kernels
    never run) decides collectively: each attempt allocates its buffers
    (``engine.prepare_run``) before its first collective, then all ranks
    agree on whether any of them ran out of device memory (an all-reduce
    of the largest flag) and retry together with pairs off, or all raise
    where no knob is left. An out-of-memory error after that point
    propagates: no rank retries alone."""
    attempt = opts
    while True:
        prepared, oom = None, None
        try:
            prepared = prepare_run(orig, lambda_inv, lam_mu, attempt,
                                   reference_data, state, i_stop,
                                   keep_state, comm)
        except torch.OutOfMemoryError as e:
            oom = f"{type(e).__name__}: {e}"
        if not comm.allmax(int(oom is not None)):
            return run_prepared(prepared)
        prepared = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        if not attempt.temporal_pairs:
            raise torch.OutOfMemoryError(
                oom or f"rank {comm.rank}: another rank of the mesh ran "
                       f"out of device memory allocating its state")
        warnings.warn(
            f"device memory exhausted on a rank of the mesh while "
            f"allocating the solver state ({oom or 'on another rank'}); "
            f"all ranks retry with temporal_pairs=False (a path that holds "
            f"less device memory — results are identical, throughput "
            f"lower)", stacklevel=2)
        attempt = dataclasses.replace(attempt, temporal_pairs=False)
