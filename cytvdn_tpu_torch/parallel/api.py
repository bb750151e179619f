"""User-level sharded denoising: ``cytvdn_tpu/parallel/api.py::
denoise_sharded`` on a mesh of processes — the ``cyTVMPI`` replacement as a
library call (the reference exposes distribution only through its MPI
console script, reference cyTVDN/mpi.py).

Every process of the group calls :func:`denoise_sharded` with the same
arguments (``torchrun --nproc-per-node N script.py``, after
``init_distributed()``). Each reads only its block of the cube, runs the
engine on it with a ``MeshComm``, and exchanges halos and sums with the
others; the state, gathered, is bitwise that of the single-device run.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from cytvdn_tpu_torch.config import (
    Backend,
    BCMode,
    SolverOptions,
    normalize_iterations,
)
from cytvdn_tpu_torch.io.loaders import InputHandle, open_input
from cytvdn_tpu_torch.parallel.distributed import distributed_device
from cytvdn_tpu_torch.parallel.halo import MeshComm
from cytvdn_tpu_torch.parallel.multihost import (
    block_slices,
    load_sharded_block,
    rank_coords,
)
from cytvdn_tpu_torch.parallel.sharded import (
    resolve_shard,
    run_sharded,
    temporal_mesh_preference,
)
from cytvdn_tpu_torch.utils.state import state_from_numpy, to_numpy


def _rank_device(device) -> torch.device:
    """The caller's device, or the one ``init_distributed`` gave this
    rank, or the current CUDA device."""
    if device is not None:
        return torch.device(device)
    return distributed_device() or torch.device(
        "cuda", torch.cuda.current_device())


def _mesh_progress(progress: Optional[bool], quiet: bool,
                   opts: SolverOptions) -> bool:
    """Whether to run in chunks for a live bar, decided alike on every rank
    (``cytvdn_tpu.api._resolve_progress`` for sharded callers): an explicit
    ``progress`` wins; else long (≥ 500 iterations), non-quiet runs."""
    if progress is not None:
        return bool(progress)
    return not quiet and opts.total_iterations >= 500


def denoise_sharded(
    datacube: Union[np.ndarray, str, InputHandle],
    mu,
    lam=None,
    iterations=10,
    FISTA: bool = True,
    stopping_relative_change: Optional[float] = None,
    BC_mode: int = 2,
    isotropic_R: bool = False,
    isotropic_Q: bool = False,
    reference_data: Optional[np.ndarray] = None,
    quiet: bool = True,
    backend="auto",
    shard="auto",
    group=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    progress: Optional[bool] = None,
    lossy_duals: bool = False,
    *,
    device=None,
    gather: bool = True,
) -> Dict[str, Any]:
    """Denoise a datacube on a mesh of processes; every rank of ``group``
    (default: the group of ``init_distributed``) calls this with the same
    arguments.

    ``datacube`` is an array (every rank slices its block from it) or a
    path or open ``InputHandle`` (every rank reads only its block, cast to
    float32 as the reference's loader does, mpi.py:223-230). ``shard``:
    ``'auto'`` (a grid over the scan axes 0 and 1) or a tile count per
    axis whose product is the group's size; any axis may be split evenly,
    with any ``BC_mode`` and half-isotropic pairs. ``device`` defaults to
    the rank's card.

    Returns on every rank ``b_norm``, ``delta``, ``iterations_run`` [,
    ``mse``] (numpy; the whole cube's traces), ``block`` (this rank's
    recon block), ``slices`` (its place in the cube), ``grid`` and
    ``exchange`` (the ``MeshComm.stats`` of the run) and ``seconds``
    (this rank's wall seconds of the block's load and copy to the device,
    the solve up to the traces on the host, and the gather); ``recon`` is the
    gathered cube on rank 0 and None on the others, and None on every rank
    with ``gather=False`` (a cube too large to assemble on one host: each
    rank keeps its ``block``, as the JAX package's multi-process run keeps
    its sharded recon); ``gathered`` says which, alike on every rank. The
    progress bar shows on rank 0 only.
    ``lossy_duals`` stores the shadow duals as bfloat16 on every rank
    (float32 Jia-Zhao anisotropic FISTA runs), and the gathered recon is
    bitwise the single-device lossy run's.

    ``checkpoint_path`` with ``checkpoint_every``: the run goes in chunks,
    and after each one every rank writes its part of the checkpoint
    (``utils/checkpoint.py``; one file on a mesh of one rank). ``resume``
    continues from it where every rank has its part, or cuts every rank's
    block from a single-process checkpoint; the ranks vote, so all resume
    or all start afresh. ``saves`` holds this rank's seconds and bytes of
    each save, ``resumed_from`` the iteration it resumed from (or None).
    """
    from cytvdn_tpu_torch.api import _validate_and_derive
    from cytvdn_tpu_torch.utils.checkpoint import (
        checkpoint_exists,
        chunk_driver,
    )

    if group is None:
        if not dist.is_initialized():
            raise ValueError("denoise_sharded needs a process group: call "
                             "init_distributed() first, or pass group=")
        group = dist.group.WORLD
    rank, world = group.rank(), group.size()
    device = _rank_device(device)

    lazy = isinstance(datacube, (str, InputHandle))
    if lazy:
        if isinstance(datacube, str):
            with open_input(datacube) as h:
                shape = tuple(h.shape)
        else:
            shape = tuple(datacube.shape)
        dtype = np.dtype(np.float32)
    else:
        datacube = np.asarray(datacube)
        shape, dtype = datacube.shape, datacube.dtype
    ndim = len(shape)
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
        backend=Backend(backend),
        lossy_duals=lossy_duals,
    )
    grid = resolve_shard(shard, shape, world,
                         prefer_axis0=temporal_mesh_preference(opts, dtype))
    if math.prod(grid) != world:
        raise ValueError(f"shard {grid} holds {math.prod(grid)} blocks; the "
                         f"group has {world} ranks")
    comm = MeshComm(group, grid, rank, opts.bc_mode)

    if lazy:
        mu = np.asarray(mu, dtype=np.float32)
        if mu.ndim == 0:
            mu = np.full((ndim,), mu, dtype=np.float32)
        if lam is None:
            lam = mu * (1.0 / (32.0 if ndim == 4 else 16.0))
        lam = np.asarray(lam, dtype=np.float32)
        lambda_inv = (1.0 / lam).astype(np.float32)
        lam_mu = (lam / mu).astype(np.float32)
    else:
        datacube, mu, lam, lambda_inv, lam_mu = _validate_and_derive(
            datacube, mu, lam, ndim, 32.0 if ndim == 4 else 16.0)
    t0 = time.perf_counter()
    block = load_sharded_block(datacube, grid, rank, dtype)
    orig = torch.from_numpy(block).to(device)
    li = torch.from_numpy(lambda_inv).to(device)
    lm = torch.from_numpy(lam_mu).to(device)
    ref = None
    if reference_data is not None:
        ref = torch.from_numpy(load_sharded_block(
            reference_data, grid, rank, dtype)).to(device)
    del block
    t1 = time.perf_counter()

    checkpointing = bool(checkpoint_path and checkpoint_every)
    resuming = bool(resume) and checkpoint_exists(checkpoint_path, comm)
    if resume:
        # every rank resumes only if every rank has its checkpoint (a job
        # that died between two ranks' first saves leaves one rank without
        # a part): diverging resume-or-fresh programs would deadlock the
        # collectives; stale parts are overwritten at the next save
        resuming = not comm.allmax(int(not resuming))
    # the choice between one shot and chunks is the same on every rank
    want_progress = _mesh_progress(progress, quiet, opts)
    if not checkpointing and not resuming and not want_progress:
        out = run_sharded(orig, li, lm, opts, comm, ref)
        out.update(saves=[], resumed_from=None)
    else:
        from cytvdn_tpu_torch.utils.checkpoint import progress_chunk_size

        def run_chunk(engine_state, i_stop):
            if engine_state is not None and \
                    not torch.is_tensor(engine_state["recon"]):
                engine_state = state_from_numpy(engine_state, device)
            return run_sharded(orig, li, lm, opts, comm, ref,
                               state=engine_state, i_stop=i_stop,
                               keep_state=True)

        every = checkpoint_every
        if want_progress and not every:
            every = progress_chunk_size(opts.total_iterations)
        meta = {
            "ndim": ndim,
            "shape": list(shape),
            "iterations_fista": n_f,
            "iterations_unacc": n_u,
            "lossy_duals": bool(lossy_duals and n_f),
        }
        cb = None
        if rank == 0 and want_progress:
            from cytvdn_tpu_torch.utils.log import make_progress

            cb = make_progress("TV denoising (sharded)")
        try:
            out = chunk_driver(run_chunk, opts.total_iterations,
                               checkpoint_path, every, resuming, meta, shape,
                               progress=cb, comm=comm)
        finally:
            if cb is not None:
                cb.close()

    b_norm, delta = to_numpy(out["b_norm"]), to_numpy(out["delta"])
    t2 = time.perf_counter()
    slices = block_slices(shape, grid, rank_coords(grid, rank))
    result = {
        "recon": (comm.gather_blocks(out["recon"], shape, slices)
                  if gather else None),
        "gathered": bool(gather),
        "block": to_numpy(out["recon"]),
        "slices": slices,
        "grid": grid,
        "b_norm": b_norm,
        "delta": delta,
        "iterations_run": int(out["iterations_run"]),
        "exchange": dict(comm.stats),
        "saves": out["saves"],
        "resumed_from": out["resumed_from"],
    }
    result["seconds"] = {"load": t1 - t0, "solve": t2 - t1,
                         "gather": time.perf_counter() - t2}
    if opts.calculate_mse:
        result["mse"] = to_numpy(out["mse"])
    return result
