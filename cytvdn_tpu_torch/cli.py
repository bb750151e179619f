"""Command-line launcher ``cytv-torch`` — the ``cytv`` command of
``cytvdn_tpu/cli.py`` (the reference's ``cyTVMPI`` console script,
reference cyTVDN/mpi.py:27-501, flag surface mpi.py:47-76) on PyTorch and
one NVIDIA GPU.

The flags, their types, defaults and the preset rules are ``cytv``'s:
``-i/--input`` (.h5/.emd/.dm3/.dm4/.npy), ``-o/--output`` (EMD v0.7),
``-d``, ``-f``, ``-n`` (one value, or two for the hybrid schedule), ``-L``,
``-m``, ``-v``, ``--preset``, ``--bc-mode``, ``--stop``, ``--iso-r``,
``--iso-q``, ``--dtype``, ``--checkpoint``/``--checkpoint-every``/
``--resume`` and ``--profile`` (a ``torch.profiler`` trace). Two
differences: ``--backend`` takes the port's backends (``auto``, ``torch``,
``cuda``), and ``--device`` (default ``cuda``) says where the run happens,
as the API's ``device`` keyword does; the command never picks the CPU by
itself.

``--out-of-core N [--temporal K]`` runs ``denoise_outofcore``
(``solver/outofcore.py``): the state stays in host memory and streams
through the card in N slabs, K iterations per slab residency; the flags it
cannot honour (``--bc-mode``, ``--iso-r/--iso-q``, ``--backend``,
``--dtype``) exit 2 with ``cytv``'s message.

A mesh run is one process per block, started by ``torchrun`` (or
anything that sets its environment), every process with the same flags::

    torchrun --nproc-per-node 2 -m cytvdn_tpu_torch.cli -i cube.npy \
        -o out.emd -m 1.0 -n 20 -f 1 --shard 2,1,1,1

The processes join one group (``parallel/distributed.py::
init_distributed``: NCCL where every rank has a card of its own, gloo
where they share one or run on the CPU), and run ``denoise_sharded``: each
reads only its block of a float32 input (float64 inputs are loaded whole,
as ``cytv`` does). ``--shard`` gives the tiles per axis, whose product is
the number of processes, or ``auto``, the default of a launch of several
processes. In one process ``--shard auto`` (or a tiling of one block) is
the one-device run. Log lines are tagged ``[cytv-torch p<rank>]`` and
printed by rank 0 only, unless ``CYTV_LOG_ALL_PROCS`` is set.
``--checkpoint``/``--checkpoint-every`` write one part per rank
(``utils/checkpoint.py``), and ``--resume 1`` resumes where every rank
has its part. The output is written by ``io/emd.py::write_emd_sharded``:
rank 0 writes the gathered cube up to 4 GiB; a larger cube is never
assembled in one process: every rank writes a ``.partN.h5`` beside the
output and rank 0 stitches them.

``--out-of-core N [--temporal K]`` in a launch of several processes runs
``solve_outofcore_multihost``, one card per process: each rank reads only
its axis-0 row range of the input (``process_row_range``) and keeps only
its rows of the state in host memory, in N slabs of its own; the output is
written by ``io/emd.py::write_emd_rows_multihost``, every rank its own
rows into the one file, or, where the ranks share no filesystem (or
``CYTV_NO_SHARED_FS=1``), ``write_emd_rows_gathered``, rank 0 writing the
rows it receives in slab-sized chunks. ``--shard auto`` (the default there)
and ``--shard 1`` are one card per process. ``--out-of-core N --shard W``
splits every slab over W processes, one card each, in a launch of P·W
processes (``solve_outofcore_multihost(shard_w=W)``): rank r·W + c reads
only its rows × columns block (the rows of process-row r, column block c
of N1/W columns), and the output goes through
``io/emd.py::write_emd_sharded`` (rank 0 writes the gathered cube up to
4 GiB, else every rank its part). A ``WORLD_SIZE`` that is not a multiple
of W (one process among them) exits 2 before the input is read::

    torchrun --nproc-per-node 2 -m cytvdn_tpu_torch.cli -i cube.npy \
        -o out.emd -m 1.0 -n 16 -f 1 --out-of-core 4 --temporal 8 --shard 2

What the port cannot run yet is refused with exit code 2 before the input
is read, naming its ROADMAP.md item: ``--backend cpp`` (Queue 1 item 13).

``--lossy-duals`` stores the FISTA shadow duals as bfloat16 (float32
Jia-Zhao anisotropic FISTA runs; the other combinations exit 2 with
``cytv``'s message), in core, with ``--checkpoint`` and out of core, in
stream and in temporal mode.

    cytv-torch -i cube.dm4 -o out.emd -m 1.0 --preset eels3d
    python -m cytvdn_tpu_torch.cli -i cube.npy -o out.emd -m 1.0 -n 20 -f 1
    cytv-torch -i cube.npy -o out.emd -m 1.0 -n 20 -f 1 --out-of-core 4 --temporal 8
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np


def str2bool(v) -> bool:
    # same accepted spellings as the reference (reference mpi.py:37-45)
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def _backend(v: str) -> str:
    if v in ("jax", "pallas"):
        raise argparse.ArgumentTypeError(
            f"{v!r} is a backend of the JAX package's cytv; cytv-torch runs "
            "'torch' (the plain PyTorch version) or 'cuda' (the CUDA "
            "kernels), or 'auto'")
    return v


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cytv-torch",
        description="TV denoising of 3D/4D microscopy datacubes on an "
                    "NVIDIA GPU (PyTorch and CUDA).",
    )
    p.add_argument("-i", "--input", type=os.path.abspath, required=True,
                   help="input file (.h5/.emd/.dm3/.dm4/.npy)")
    p.add_argument("-o", "--output", type=os.path.abspath, required=True,
                   help="output file (written as EMD v0.7, extension "
                        "forced to .emd)")
    p.add_argument("-d", "--dimensions", type=int, choices=(3, 4),
                   help="number of dimensions (inferred from input if "
                        "omitted)")
    p.add_argument("-f", "--fista", type=str2bool, default=None,
                   help="use FISTA acceleration (0 or 1)")
    p.add_argument("-n", "--niterations", type=int, nargs="+", default=None,
                   help="iterations (two values = hybrid FISTA+unacc); "
                        "required unless --preset supplies it")
    p.add_argument("-L", "--lambda", dest="lam", type=float, nargs="+",
                   help="per-axis lambda (default mu/32 in 4D, mu/16 in 3D)")
    p.add_argument("-m", "--mu", type=float, nargs="+", required=True,
                   help="per-axis mu")
    p.add_argument("-v", "--verbose", type=str2bool, default=True)
    p.add_argument("--preset", default=None,
                   help="named solver preset (cytvdn_tpu_torch.presets, e.g. "
                        "'eels3d', 'stem4d-converged'); explicit flags "
                        "override preset values")
    p.add_argument("--bc-mode", type=int, default=None, choices=(0, 1, 2),
                   help="boundary conditions: 0 periodic, 1 mirror, "
                        "2 Jia-Zhao (default)")
    p.add_argument("--stop", type=float, default=None,
                   help="stopping_relative_change (e.g. 0.05)")
    p.add_argument("--iso-r", type=str2bool, default=None,
                   help="half-isotropic on axes 0,1 (4D only)")
    p.add_argument("--iso-q", type=str2bool, default=None,
                   help="half-isotropic on axes 2,3 (4D only)")
    p.add_argument("--backend", default="auto", type=_backend,
                   choices=("auto", "torch", "cuda", "cpp"),
                   help="auto: the CUDA kernels on the card, the plain "
                        "PyTorch version on the CPU; cpp is not ported yet")
    p.add_argument("--shard", default=None,
                   help="'auto' or comma-separated per-axis tile counts "
                        "(e.g. 2,4,1,1) to run over a mesh of processes, "
                        "one per tile (torchrun --nproc-per-node N)")
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "float64"))
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file for periodic state saves")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save solver state every N iterations")
    p.add_argument("--resume", type=str2bool, default=False,
                   help="resume from --checkpoint if it exists")
    p.add_argument("--profile", default=None, metavar="LOGDIR",
                   help="capture a torch.profiler trace of the host and the "
                        "card into LOGDIR/trace.json")
    p.add_argument("--out-of-core", type=int, default=0, metavar="N_SLABS",
                   help="stream the cube through the device in N slabs with "
                        "host-resident state (for states larger than the "
                        "card's memory)")
    p.add_argument("--temporal", type=int, default=1, metavar="K",
                   help="with --out-of-core: K iterations per slab "
                        "residency (temporal blocking; cuts host-device "
                        "traffic K-fold)")
    p.add_argument("--lossy-duals", action="store_true",
                   help="LOSSY opt-in: store the FISTA shadow duals as "
                        "bfloat16 (a smaller state, less memory traffic; "
                        "not bit-exact). Float32 Jia-Zhao anisotropic FISTA "
                        "runs only")
    p.add_argument("--device", default="cuda",
                   help="torch device of the run (default cuda; cpu runs the "
                        "plain PyTorch version on the host)")
    return p


def _apply_preset(args) -> bool:
    """Fill unset flags from ``--preset``; explicit flags always win
    (unset flags parse as None sentinels). Returns False on a missing
    ``-n`` with no preset to supply it."""
    if args.preset:
        from cytvdn_tpu_torch.presets import get_preset

        pr = get_preset(args.preset)  # raises KeyError listing presets
        if args.niterations is None and "iterations" in pr:
            v = pr["iterations"]
            args.niterations = (list(v) if isinstance(v, (list, tuple))
                                else [v])
        if args.fista is None:
            args.fista = pr.get("FISTA")
        if args.bc_mode is None:
            args.bc_mode = pr.get("BC_mode")
        if args.stop is None:
            args.stop = pr.get("stopping_relative_change")
        if args.iso_r is None:
            args.iso_r = pr.get("isotropic_R")
        if args.iso_q is None:
            args.iso_q = pr.get("isotropic_Q")
    if args.niterations is None:
        return False
    # resolve remaining sentinels to the documented defaults
    args.fista = bool(args.fista)
    args.bc_mode = 2 if args.bc_mode is None else args.bc_mode
    args.iso_r = bool(args.iso_r)
    args.iso_q = bool(args.iso_q)
    return True


class CliError(Exception):
    """An argument the command refuses: :func:`main` prints it and returns
    2, the convention of every argument failure."""


def _not_ported(what: str, item) -> CliError:
    """``item``: a Queue 1 item's number, or the words naming items."""
    from cytvdn_tpu_torch.config import _not_ported as msg

    where = f"item {item}" if isinstance(item, int) else item
    return CliError(str(msg(what, f"Queue 1 {where}")))


def parse_args(argv=None) -> argparse.Namespace:
    """Parse ``argv``, fill it from ``--preset`` and refuse what the port
    cannot run, all before the input is read. Raises :class:`CliError`."""
    args = build_parser().parse_args(argv)
    try:
        ok = _apply_preset(args)
    except KeyError as e:
        # get_preset's message lists the presets
        raise CliError(e.args[0]) from None
    if not ok:
        raise CliError("-n/--niterations is required (or use a --preset "
                       "that supplies it)")
    world = _world()
    if args.out_of_core and args.shard:
        w = _ooc_shard(args.shard)
        if world % w:
            raise CliError(
                f"--out-of-core with --shard {w} splits every slab over {w} "
                f"processes, one card each, but this launch has {world} "
                f"(WORLD_SIZE), not a multiple of {w}; start {w} (or a "
                f"multiple): torchrun --nproc-per-node {w} -m "
                f"cytvdn_tpu_torch.cli ...")
    tiles = None if args.out_of_core else _tiles(args.shard)
    if tiles is not None and math.prod(tiles) != world:
        n = math.prod(tiles)
        raise CliError(
            f"--shard {args.shard} tiles the cube into {n} blocks, one per "
            f"process, but this launch has {world} (WORLD_SIZE); start {n}: "
            f"torchrun --nproc-per-node {n} -m cytvdn_tpu_torch.cli ...")
    if args.temporal != 1 and not args.out_of_core:
        raise CliError("--temporal requires --out-of-core")
    if args.lossy_duals:
        if args.bc_mode != 2 or args.iso_r or args.iso_q \
                or args.dtype != "float32" or not args.fista:
            # without FISTA there ARE no shadow duals
            raise CliError("--lossy-duals covers float32 Jia-Zhao "
                           "anisotropic FISTA runs only")
    if args.out_of_core:
        # the flags out-of-core runs would silently ignore (cytv's check)
        bad = []
        if args.bc_mode != 2:
            bad.append("--bc-mode")
        if args.iso_r or args.iso_q:
            bad.append("--iso-r/--iso-q")
        if args.backend != "auto":
            bad.append("--backend")
        if args.dtype != "float32":
            bad.append("--dtype")
        if bad:
            raise CliError(f"--out-of-core does not support {', '.join(bad)} "
                           "(Jia-Zhao anisotropic float32)")
    if args.backend == "cpp":
        raise _not_ported("--backend cpp", 13)

    import torch

    try:
        device = torch.device(args.device)
    except RuntimeError as e:
        raise CliError(f"--device {args.device!r}: {e}") from None
    if device.type == "cuda" and not torch.cuda.is_available():
        raise CliError(f"--device {args.device}: no CUDA device is available "
                       "(torch.cuda.is_available() is false); --device cpu "
                       "runs the plain PyTorch version on the host")
    return args


def _world() -> int:
    """The launch's process count (``WORLD_SIZE``, as torchrun sets it)."""
    return int(os.environ.get("WORLD_SIZE") or 1)


def _ooc_shard(shard: Optional[str]) -> int:
    """``--shard`` of an out-of-core run: the processes, one card each,
    that split every slab (``auto``, 0 and 1: one card per process)."""
    if not shard or shard == "auto":
        return 1
    try:
        return max(int(shard), 1)
    except ValueError:
        raise CliError(
            "--out-of-core does not support --shard (out-of-core takes a "
            "device COUNT or 'auto', not a per-axis tiling) (Jia-Zhao "
            "anisotropic float32)") from None


def _tiles(shard: Optional[str]) -> Optional[Tuple[int, ...]]:
    """``--shard``'s tile counts, or None for ``auto`` and no flag."""
    if not shard or shard == "auto":
        return None
    try:
        return tuple(int(x) for x in shard.split(","))
    except ValueError:
        raise CliError(f"--shard {shard!r}: 'auto' or comma-separated tile "
                       f"counts per axis (e.g. 2,1,1,1)") from None


def _logger(args, rank: int = 0, world: int = 1):
    """The command's log: ``[cytv-torch]`` lines, or ``[cytv-torch
    p<rank>]`` in a launch of several processes, printed by rank 0 only
    unless ``CYTV_LOG_ALL_PROCS`` is set (the reference's head-rank
    logging, mpi.py:298-305)."""
    verbose = args.verbose and (
        rank == 0 or bool(os.environ.get("CYTV_LOG_ALL_PROCS")))
    tag = f"[cytv-torch p{rank}]" if world > 1 else "[cytv-torch]"

    def log(msg):
        if verbose:
            print(f"{tag} {msg}", flush=True)

    return log


@dataclasses.dataclass
class Solved:
    """What :func:`load_and_solve` returns: the parsed arguments, the
    solver's ``recon``/``b_norm``/``delta`` (numpy, on the host) and the
    wall seconds of each step (``load``; ``solve``, the host-device copies
    included; on a mesh also ``gather``).

    In a launch of several processes each rank returns its own: ``recon``
    is the gathered cube on rank 0 (None on the others, and on every rank
    where the cube is too large to gather), ``block`` and ``slices`` the
    rank's block and its place in the cube, ``gathered`` whether the run
    gathered the cube (alike on every rank), ``grid`` the mesh, ``saves``
    the seconds (``copy``, ``write``) and ``bytes`` of each checkpoint
    save of the rank's part, ``resumed_from`` the iteration it resumed
    from (or None), ``exchange`` the rank's ``MeshComm`` statistics. A
    multi-process out-of-core run gives no ``recon`` and no ``grid``:
    ``block`` is the rank's rows and ``rows`` their range ``(g0, g1,
    n0)``, which the write step takes as it is; where its slabs are split
    over several cards, ``block`` is the rank's rows × columns block,
    ``slices`` its place, ``cols`` its columns ``(c0, c1, n1)`` and
    ``column_exchange`` the slab mesh's statistics."""

    args: argparse.Namespace
    recon: Optional[np.ndarray]
    b_norm: np.ndarray
    delta: np.ndarray
    seconds: Dict[str, float]
    block: Optional[np.ndarray] = None
    slices: Optional[Tuple[slice, ...]] = None
    grid: Optional[Tuple[int, ...]] = None
    gathered: bool = False
    saves: List[Dict[str, float]] = dataclasses.field(default_factory=list)
    resumed_from: Optional[int] = None
    rows: Optional[Tuple[int, int, int]] = None
    exchange: Optional[Dict[str, float]] = None
    cols: Optional[Tuple[int, int, int]] = None
    column_exchange: Optional[Dict[str, float]] = None


def _outofcore_mesh(args, shape, ndim, mu, lam, iterations, world, rank,
                    seconds, log) -> Dict:
    """This rank's part of a multi-process out-of-core run: it reads only
    its axis-0 rows of the input (the reference's per-rank reads,
    mpi.py:93-124) and runs ``solve_outofcore_multihost`` on them."""
    from cytvdn_tpu_torch.api import _validate_and_derive
    from cytvdn_tpu_torch.config import SolverOptions, normalize_iterations
    from cytvdn_tpu_torch.io.loaders import open_input
    from cytvdn_tpu_torch.parallel.distributed import distributed_device
    from cytvdn_tpu_torch.solver.outofcore import (
        process_row_range,
        solve_outofcore_multihost,
    )

    # a (P, W) grid of the ranks: process-row r's rows, column block c
    w = _ooc_shard(args.shard)
    r, c = divmod(rank, w)
    g0, g1 = process_row_range(shape[0], world // w, r)
    c0, c1 = c * (shape[1] // w), (c + 1) * (shape[1] // w)
    t0 = time.perf_counter()
    with open_input(args.input) as h:
        local = np.ascontiguousarray(h.read_block(
            (slice(g0, g1), slice(c0, c1)) + (slice(None),) * (ndim - 2)),
            dtype=np.float32)
    seconds["load"] += time.perf_counter() - t0
    log(f"multi-process out-of-core: rows [{g0}, {g1}) of {shape[0]}"
        + (f", columns [{c0}, {c1}) of {shape[1]}" if w > 1 else "")
        + f", {world} processes"
        + (f" ({world // w} process-rows of {w})" if w > 1 else ""))
    local, _, _, lambda_inv, lam_mu = _validate_and_derive(
        local, mu, lam, ndim, 32.0 if ndim == 4 else 16.0)
    n_f, n_u = normalize_iterations(iterations, bool(args.fista))
    return solve_outofcore_multihost(
        local, lambda_inv, lam_mu,
        SolverOptions(ndim=ndim, iterations_fista=n_f, iterations_unacc=n_u,
                      stopping_relative_change=args.stop,
                      lossy_duals=bool(args.lossy_duals)),
        args.out_of_core, max(args.temporal, 1),
        global_rows=(g0, g1, shape[0]), shard_w=w,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every, resume=bool(args.resume),
        device=distributed_device(), global_cols=(c0, c1, shape[1]))


def load_and_solve(argv=None) -> Solved:
    """Parse, load the input and denoise it on ``--device``: every step of
    :func:`main` but the output file. In a launch of several processes
    (``WORLD_SIZE`` > 1) every process calls it: it joins the group and
    returns this rank's part of the mesh run. Raises :class:`CliError`."""
    from cytvdn_tpu_torch import denoise3D, denoise4D
    from cytvdn_tpu_torch.io.emd import gathers
    from cytvdn_tpu_torch.io.loaders import load_input, open_input
    from cytvdn_tpu_torch.kernels import (
        fused_iteration,
        fused_kstep_iteration,
        fused_pair_iteration,
        resident_solve,
    )
    from cytvdn_tpu_torch.solver.outofcore import denoise_outofcore
    from cytvdn_tpu_torch.utils.checkpoint import run_with_checkpointing
    from cytvdn_tpu_torch.utils.log import profile_trace

    args = parse_args(argv)
    world, rank = _world(), 0
    if world > 1:
        # join the group first: every process of the launch runs this
        # same command (the reference's one MPI rank per node)
        import torch.distributed as dist

        from cytvdn_tpu_torch.parallel.distributed import init_distributed

        if not init_distributed(device=args.device):
            raise CliError(
                f"WORLD_SIZE={world} without RANK: start the processes "
                f"with torchrun (torchrun --nproc-per-node {world} -m "
                f"cytvdn_tpu_torch.cli ...)")
        rank = dist.get_rank()
    log = _logger(args, rank, world)
    if world > 1 and not args.shard:
        log("multi-process run without --shard: defaulting to --shard auto")
        args.shard = "auto"
    mesh = world > 1
    if args.shard and not mesh:
        log(f"--shard {args.shard} in one process is one block: the "
            f"one-device run")
    seconds = {}

    t0 = time.perf_counter()
    if mesh and args.dtype == "float32":
        # each rank reads only its block (the reference's memmap/MPI-IO
        # opens, mpi.py:93-124); here only the shape
        with open_input(args.input) as h:
            shape, in_dtype = tuple(h.shape), h.dtype
        data = args.input
        seconds["load"] = time.perf_counter() - t0
        log(f"opened {args.input} lazily: shape {shape}, {in_dtype}")
    else:
        data = load_input(args.input, dtype=np.dtype(args.dtype))
        shape = data.shape
        seconds["load"] = time.perf_counter() - t0
        log(f"loaded {args.input}: shape {data.shape}, {data.dtype}, "
            f"{data.nbytes / 2**20:.1f} MiB in {seconds['load']:.3f}s")

    ndim = args.dimensions or len(shape)
    if len(shape) != ndim:
        raise CliError(f"input is {len(shape)}D but -d {ndim} given")

    run_dtype = np.dtype(args.dtype)
    mu = np.asarray(args.mu, dtype=run_dtype)
    if mu.size == 1:
        mu = np.full(ndim, mu[0], dtype=run_dtype)
    lam = None
    if args.lam is not None:
        lam = np.asarray(args.lam, dtype=run_dtype)
        if lam.size == 1:
            lam = np.full(ndim, lam[0], dtype=run_dtype)

    iterations = (args.niterations[0] if len(args.niterations) == 1
                  else tuple(args.niterations[:2]))

    kwargs = dict(
        mu=mu,
        lam=lam,
        iterations=iterations,
        FISTA=bool(args.fista),
        stopping_relative_change=args.stop,
        BC_mode=args.bc_mode,
        # the same on every rank: it feeds the choice between one shot and
        # progress chunks, which must not diverge
        quiet=not args.verbose,
        backend=args.backend,
        device=args.device,
    )
    if args.lossy_duals:
        kwargs["lossy_duals"] = True

    kernels = (("whole-run", resident_solve), ("K-step", fused_kstep_iteration),
               ("pair", fused_pair_iteration), ("K=1", fused_iteration))
    before = [k.launches for _, k in kernels]
    mesh_out = {}
    rows = None
    t0 = time.perf_counter()
    # the trace of rank 0 (its waits for the others included)
    with profile_trace(args.profile if rank == 0 else None):
        if args.out_of_core and mesh:
            mesh_out = _outofcore_mesh(args, shape, ndim, mu, lam,
                                       iterations, world, rank, seconds, log)
            g0, g1, n0 = (int(v) for v in mesh_out["global_rows"])
            rows = (g0, g1, n0)
            recon, b_norm, delta = (None, mesh_out["b_norm"],
                                    mesh_out["delta"])
            mesh_out.update(block=mesh_out["recon"], gathered=False)
            if "global_cols" in mesh_out:
                mesh_out["cols"] = tuple(
                    int(v) for v in mesh_out["global_cols"])
            else:
                mesh_out["slices"] = (slice(g0, g1),) \
                    + (slice(None),) * (ndim - 1)
        elif args.out_of_core:
            recon, b_norm, delta = denoise_outofcore(
                data, mu, lam=lam, iterations=iterations,
                FISTA=bool(args.fista), stopping_relative_change=args.stop,
                n_slabs=args.out_of_core, temporal_k=args.temporal,
                quiet=not args.verbose, checkpoint_path=args.checkpoint,
                checkpoint_every=args.checkpoint_every, resume=args.resume,
                lossy_duals=bool(args.lossy_duals), device=args.device)
        elif mesh:
            from cytvdn_tpu_torch.parallel.api import denoise_sharded

            tiles = _tiles(args.shard)
            mesh_out = denoise_sharded(
                data, shard=tiles or "auto", isotropic_R=args.iso_r,
                isotropic_Q=args.iso_q, checkpoint_path=args.checkpoint,
                checkpoint_every=args.checkpoint_every, resume=args.resume,
                gather=gathers(shape, run_dtype), **kwargs)
            recon, b_norm, delta = (mesh_out["recon"], mesh_out["b_norm"],
                                    mesh_out["delta"])
        elif args.checkpoint and args.checkpoint_every:
            result = run_with_checkpointing(
                data, checkpoint_path=args.checkpoint,
                checkpoint_every=args.checkpoint_every, resume=args.resume,
                isotropic_R=args.iso_r, isotropic_Q=args.iso_q, **kwargs)
            recon, b_norm, delta = (result["recon"], result["b_norm"],
                                    result["delta"])
        elif ndim == 3:
            recon, b_norm, delta = denoise3D(data, **kwargs)[:3]
        else:
            recon, b_norm, delta = denoise4D(
                data, isotropic_R=args.iso_r, isotropic_Q=args.iso_q,
                **kwargs)[:3]
    seconds["solve"] = time.perf_counter() - t0
    if rows is not None:
        ex = mesh_out["exchange"]
        cx = mesh_out.get("column_exchange")
        log(f"rank {rank}'s rows [{rows[0]}, {rows[1]})"
            + (f", columns [{mesh_out['cols'][0]}, {mesh_out['cols'][1]})"
               if cx else "")
            + f": solve {seconds['solve']:.3f}s; band exchanges "
            f"{ex['exchanges']}, "
            f"{ex['exchange_seconds']:.3f}s, {ex['bytes_sent']} bytes sent, "
            f"{ex['bytes_received']} received"
            + (f"; column exchanges {cx['exchanges']}, "
               f"{cx['exchange_seconds']:.3f}s, {cx['bytes_sent']} bytes "
               f"sent, {cx['bytes_received']} received" if cx else "")
            + (f"; resumed from iteration {mesh_out['resumed_from']}"
               if mesh_out["resumed_from"] is not None else ""))
    elif mesh_out:
        # the block's read and copy to the card, the solve and the gather
        seconds["load"] += mesh_out["seconds"]["load"]
        seconds.update(solve=mesh_out["seconds"]["solve"],
                       gather=mesh_out["seconds"]["gather"])
        log(f"mesh {mesh_out['grid']} of {world} processes: rank {rank}'s "
            f"block {mesh_out['slices']}; load {seconds['load']:.3f}s, "
            f"gather {seconds['gather']:.3f}s"
            + (f"; resumed from iteration {mesh_out['resumed_from']}"
               if mesh_out["resumed_from"] is not None else ""))
        for k, sv in enumerate(mesh_out["saves"]):
            log(f"checkpoint save {k + 1}: copy {sv['copy']:.3f}s, write "
                f"{sv['write']:.3f}s, {sv['bytes']} bytes")
    ran = delta[np.nonzero(delta)]
    log(f"denoising took {seconds['solve']:.3f}s; {ran.size} iterations; "
        f"final delta {ran[-1] if ran.size else 0:.5f}")
    log("kernel launches: " + ", ".join(
        f"{name} {k.launches - b}" for (name, k), b in zip(kernels, before)))
    return Solved(args, recon, b_norm, delta, seconds,
                  block=mesh_out.get("block"), slices=mesh_out.get("slices"),
                  grid=mesh_out.get("grid"),
                  gathered=mesh_out.get("gathered", False),
                  saves=mesh_out.get("saves", []),
                  resumed_from=mesh_out.get("resumed_from"), rows=rows,
                  exchange=mesh_out.get("exchange"),
                  cols=mesh_out.get("cols"),
                  column_exchange=mesh_out.get("column_exchange"))


def write_output(run: Solved) -> str:
    """The EMD v0.7 output of :func:`load_and_solve`'s result: one file,
    or, in a launch of several processes, every rank's block through
    ``write_emd_sharded``, or every rank's rows of a multi-process
    out-of-core run through ``write_emd_rows_multihost`` (every rank its
    rows into the one file) or, where that finds no filesystem every rank
    shares, ``write_emd_rows_gathered`` (every rank calls it), or, where
    its slabs were split over several cards, every rank's rows × columns
    block through ``write_emd_sharded``. Records the seconds in
    ``run.seconds["write"]``; returns the output's path."""
    from cytvdn_tpu_torch.io.emd import (
        emd_path,
        write_emd,
        write_emd_rows_gathered,
        write_emd_rows_multihost,
        write_emd_sharded,
    )

    rank = 0
    t0 = time.perf_counter()
    how = ""
    if run.block is None:
        out = write_emd(run.args.output, run.recon)
    elif run.cols is not None:
        import torch.distributed as dist

        from cytvdn_tpu_torch.parallel.halo import MeshComm

        rank, world = dist.get_rank(), dist.get_world_size()
        w = _ooc_shard(run.args.shard)
        comm = MeshComm(dist.group.WORLD, (world // w, w), rank)
        shape = (run.rows[2], run.cols[2]) + run.block.shape[2:]
        out = write_emd_sharded(run.args.output, run.block, run.slices,
                                shape, comm)
        how = " (every rank its block)"
    elif run.rows is not None:
        import torch.distributed as dist

        from cytvdn_tpu_torch.parallel.halo import MeshComm

        rank, world = dist.get_rank(), dist.get_world_size()
        comm = MeshComm(dist.group.WORLD, (world,), rank)
        g0, g1, n0 = run.rows
        shape = (n0,) + run.block.shape[1:]
        out = write_emd_rows_multihost(run.args.output, shape, np.float32,
                                       run.block, (g0, g1), comm)
        how = " (every rank its rows)"
        if out is None:
            ch = max(1, -(-n0 // (world * run.args.out_of_core)))
            write_emd_rows_gathered(run.args.output, shape, np.float32,
                                    run.block, (g0, g1), ch, comm)
            out = emd_path(run.args.output)
            how = f" (rows gathered to rank 0 in chunks of {ch})"
    else:
        import torch.distributed as dist

        from cytvdn_tpu_torch.parallel.halo import MeshComm

        rank = dist.get_rank()
        comm = MeshComm(dist.group.WORLD, run.grid, rank)
        shape = tuple(n * w for n, w in zip(run.block.shape, run.grid))
        out = write_emd_sharded(
            run.args.output, run.block, run.slices, shape, comm,
            gathered=run.gathered, recon=run.recon)
    run.seconds["write"] = time.perf_counter() - t0
    _logger(run.args, rank, _world())(
        f"wrote {out}{how} in {run.seconds['write']:.3f}s")
    return out


def main(argv=None, seconds: Optional[Dict[str, float]] = None) -> int:
    """The command: :func:`load_and_solve`, then :func:`write_output`; in
    a launch of several processes it leaves the group at the end.
    ``seconds``, where given, receives the wall seconds of the load, the
    solve and the write."""
    try:
        run = load_and_solve(argv)
    except CliError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    write_output(run)
    if seconds is not None:
        seconds.update(run.seconds)
    if run.block is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
