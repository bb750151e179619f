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

What the port cannot run yet is refused with exit code 2 before the input
is read, naming its ROADMAP.md item: ``--shard`` and multi-process
launches (``WORLD_SIZE`` > 1; Queue 1 item 10, also with
``--out-of-core``, item 11), ``--lossy-duals`` (item 12) and ``--backend
cpp`` (item 13). Sharded runs are a library call for now
(``cytvdn_tpu_torch.parallel.denoise_sharded``).

    cytv-torch -i cube.dm4 -o out.emd -m 1.0 --preset eels3d
    python -m cytvdn_tpu_torch.cli -i cube.npy -o out.emd -m 1.0 -n 20 -f 1
    cytv-torch -i cube.npy -o out.emd -m 1.0 -n 20 -f 1 --out-of-core 4 --temporal 8
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import Dict, Optional

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
                        "(e.g. 2,4,1,1) to run over a device mesh (not "
                        "ported yet)")
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
                        "bfloat16 (not ported yet)")
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


def _not_ported(what: str, item: int) -> CliError:
    from cytvdn_tpu_torch.config import _not_ported as msg

    return CliError(str(msg(what, f"Queue 1 item {item}")))


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
    world = int(os.environ.get("WORLD_SIZE") or 1)
    if world > 1:
        raise _not_ported(f"a multi-process launch (WORLD_SIZE={world})", 10)
    if args.shard:
        raise _not_ported("--shard", 10)
    if args.temporal != 1 and not args.out_of_core:
        raise CliError("--temporal requires --out-of-core")
    if args.lossy_duals:
        if args.bc_mode != 2 or args.iso_r or args.iso_q \
                or args.dtype != "float32" or not args.fista:
            # without FISTA there ARE no shadow duals
            raise CliError("--lossy-duals covers float32 Jia-Zhao "
                           "anisotropic FISTA runs only")
        raise _not_ported("--lossy-duals", 12)
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


def _logger(verbose: bool):
    def log(msg):
        if verbose:
            print(f"[cytv-torch] {msg}", flush=True)

    return log


@dataclasses.dataclass
class Solved:
    """What :func:`load_and_solve` returns: the parsed arguments, the
    solver's ``recon``/``b_norm``/``delta`` (numpy, on the host) and the
    wall seconds of each step (``load``; ``solve``, the host-device copies
    included)."""

    args: argparse.Namespace
    recon: np.ndarray
    b_norm: np.ndarray
    delta: np.ndarray
    seconds: Dict[str, float]


def load_and_solve(argv=None) -> Solved:
    """Parse, load the whole input and denoise it on ``--device``: every
    step of :func:`main` but the output file. Raises :class:`CliError`."""
    from cytvdn_tpu_torch import denoise3D, denoise4D
    from cytvdn_tpu_torch.io.loaders import load_input
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
    log = _logger(args.verbose)
    seconds = {}

    t0 = time.perf_counter()
    data = load_input(args.input, dtype=np.dtype(args.dtype))
    seconds["load"] = time.perf_counter() - t0
    log(f"loaded {args.input}: shape {data.shape}, {data.dtype}, "
        f"{data.nbytes / 2**20:.1f} MiB in {seconds['load']:.3f}s")

    ndim = args.dimensions or data.ndim
    if data.ndim != ndim:
        raise CliError(f"input is {data.ndim}D but -d {ndim} given")

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
        quiet=not args.verbose,
        backend=args.backend,
        device=args.device,
    )

    kernels = (("whole-run", resident_solve), ("K-step", fused_kstep_iteration),
               ("pair", fused_pair_iteration), ("K=1", fused_iteration))
    before = [k.launches for _, k in kernels]
    t0 = time.perf_counter()
    with profile_trace(args.profile):
        if args.out_of_core:
            recon, b_norm, delta = denoise_outofcore(
                data, mu, lam=lam, iterations=iterations,
                FISTA=bool(args.fista), stopping_relative_change=args.stop,
                n_slabs=args.out_of_core, temporal_k=args.temporal,
                quiet=not args.verbose, checkpoint_path=args.checkpoint,
                checkpoint_every=args.checkpoint_every, resume=args.resume,
                device=args.device)
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
    ran = delta[np.nonzero(delta)]
    log(f"denoising took {seconds['solve']:.3f}s; {ran.size} iterations; "
        f"final delta {ran[-1] if ran.size else 0:.5f}")
    log("kernel launches: " + ", ".join(
        f"{name} {k.launches - b}" for (name, k), b in zip(kernels, before)))
    return Solved(args, recon, b_norm, delta, seconds)


def main(argv=None, seconds: Optional[Dict[str, float]] = None) -> int:
    """The command: :func:`load_and_solve`, then the EMD v0.7 output.
    ``seconds``, where given, receives the wall seconds of the load, the
    solve and the write."""
    from cytvdn_tpu_torch.io.emd import write_emd

    try:
        run = load_and_solve(argv)
    except CliError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    out = write_emd(run.args.output, run.recon)
    run.seconds["write"] = time.perf_counter() - t0
    _logger(run.args.verbose)(f"wrote {out} in {run.seconds['write']:.3f}s")
    if seconds is not None:
        seconds.update(run.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
