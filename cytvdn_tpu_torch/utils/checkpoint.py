"""Periodic checkpoint / resume for the TV solver — ``cytvdn_tpu``'s
``utils/checkpoint.py`` on PyTorch.

The solver runs in chunks of ``checkpoint_every`` iterations (``run_solver``
with ``i_stop``), and the state is written atomically to an .npz after
each chunk. Resume picks up mid-phase, mid-schedule, with the state bitwise
that of an uninterrupted run. Between chunks the state stays on the device
and is updated in place; it reaches the host only inside
:func:`save_state`.

The file format is the JAX package's (the same keys, ``meta`` JSON and
format version; ``i`` int32, ``tk`` float32, ``mse`` zero-length without
MSE, the ``early_stopped`` latch), so a checkpoint written by either
package resumes in the other. A lossy run's bfloat16 shadow duals are
stored, as the JAX package stores them, as their uint16 bit patterns, named
in the meta's ``bf16_keys`` (``np.savez`` cannot hold bfloat16), and come
back from :func:`load_state` as bfloat16 CPU tensors.

A mesh of several processes (a ``parallel/halo.py::MeshComm`` of more than
one rank) writes one self-contained part per rank, in the JAX package's
multi-process format: rank 0 at ``path``, rank p at ``path.p<p>``, each
with the rank's block under ``recon.b0``, ``acc{k}.b0`` and ``d{k}.b0``,
the replicated scalars and traces, and a meta whose ``blocks`` gives each
key's global shape, dtype, block bounds and ``bf16`` flag, beside
``num_processes``. The ranks meet in one collective after every save. On
resume every rank checks its own part (the process count, the part's
presence, its bounds), any rank's refusal is every rank's, and parts of
different generations are discarded by every rank alike: a fresh start. A
single-process checkpoint resumes on a mesh: every rank cuts its block
from it.
"""

from __future__ import annotations

import json
import os
import struct
import tempfile
import time
import warnings
import zipfile
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from cytvdn_tpu_torch.config import BCMode, SolverOptions, normalize_iterations
from cytvdn_tpu_torch.parallel.multihost import block_slices, state_block
from cytvdn_tpu_torch.utils.state import (
    bf16_bits,
    from_bf16_bits,
    state_from_numpy,
    to_numpy,
)

_FMT_VERSION = 1


def _atomic_savez(path: str, arrays: Dict[str, np.ndarray]):
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".ckpt.tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _distributed(comm) -> bool:
    """Whether ``comm`` is a mesh of more than one process: its ranks
    write and read part files."""
    return comm is not None and comm.world > 1


def _part_path(path: str, rank: int) -> str:
    return f"{path}.p{rank}" if rank else path


def _read_meta(path: str) -> Dict[str, Any]:
    with np.load(path) as z:
        return json.loads(bytes(z["meta"]).decode())


def _bounds(comm, shape) -> Tuple[Tuple[int, int], ...]:
    """This rank's block of a cube of ``shape`` as ``((lo, hi), ...)``, the
    key of the JAX package's ``ShardedBlocks``."""
    return tuple((s.start, s.stop) for s in block_slices(
        shape, comm.grid, comm.coords))


def save_state(path: str, state: Dict[str, Any], meta: Dict[str, Any],
               comm=None) -> Dict[str, float]:
    """Atomic .npz checkpoint write (tmp file + rename) of a state dict
    (tensors on any device, or numpy arrays), in the JAX package's format;
    bfloat16 arrays (tensors or ``ml_dtypes`` arrays) as their uint16 bit
    patterns.

    With a ``comm`` of more than one rank, ``state`` holds this rank's
    block and the rank writes its part (``path``, or ``path.p<rank>``),
    then waits in one collective until every rank has written its part;
    where any rank's save failed, every rank raises.
    Returns the seconds of the copy to the host (``copy``, after the
    device has finished its work) and of the write (``write``), and the
    file's ``bytes``."""
    recon = state["recon"]
    if torch.is_tensor(recon) and recon.is_cuda:
        torch.cuda.synchronize(recon.device)
    t0 = time.perf_counter()
    if _distributed(comm):
        path = _part_path(path, comm.rank)

    def dump():
        arrays = _arrays(state, meta, comm)
        t1 = time.perf_counter()
        _atomic_savez(path, arrays)
        return t1, time.perf_counter()

    if _distributed(comm):
        # the one collective after the save: no rank may resume until
        # every part of this generation exists, and one rank's failed
        # save (a full disk) is every rank's
        t1, t2 = comm.together(dump, "failed to save its checkpoint part")
    else:
        t1, t2 = dump()
    return {"copy": t1 - t0, "write": t2 - t1,
            "bytes": os.path.getsize(path)}


def _arrays(state: Dict[str, Any], meta: Dict[str, Any],
            comm) -> Dict[str, np.ndarray]:
    """The arrays of :func:`save_state`'s file, on the host."""
    recon = state["recon"]
    mse = state.get("mse")
    arrays = {
        "b_norm": to_numpy(state["b_norm"]),
        "delta": to_numpy(state["delta"]),
        "mse": np.zeros(0) if mse is None else to_numpy(mse),
        "i": np.asarray(int(state["i"]), np.int32),
        "tk": np.asarray(to_numpy(state.get("tk", 1.0)), np.float32),
        "early_stopped": np.asarray(bool(state.get("early_stopped", False))),
    }
    items = [("recon", recon)]
    items += [(f"acc{k}", a) for k, a in enumerate(state["accs"])]
    items += [(f"d{k}", a) for k, a in enumerate(state.get("ds") or ())]
    if _distributed(comm):
        shape = [int(n) * w for n, w in zip(np.shape(recon), comm.grid)]
        bounds = [list(b) for b in _bounds(comm, shape)]
        blocks = {}
        for k, a in items:
            bits = bf16_bits(a)
            arrays[f"{k}.b0"] = bits if bits is not None else to_numpy(a)
            blocks[k] = {"shape": shape,
                         "dtype": "bfloat16" if bits is not None
                         else arrays[f"{k}.b0"].dtype.name,
                         "bounds": [bounds], "bf16": bits is not None}
        extra = {"blocks": blocks, "num_processes": comm.world}
    else:
        bf16_keys = []
        for k, a in items:
            bits = bf16_bits(a)
            if bits is not None:
                bf16_keys.append(k)
            arrays[k] = bits if bits is not None else to_numpy(a)
        extra = {"bf16_keys": bf16_keys} if bf16_keys else {}
    arrays["meta"] = np.frombuffer(
        json.dumps({**meta, "version": _FMT_VERSION, **extra}).encode(),
        dtype=np.uint8)
    return arrays


def _read(path: str, comm=None):
    """One file's state and meta. A part file must be this rank's: the
    process count, the part's presence and its bounds are checked (the JAX
    package's messages); a single-process file is cut to the rank's block
    on a mesh."""
    rank = comm.rank if _distributed(comm) else 0
    world = comm.world if _distributed(comm) else 1
    own = _part_path(path, rank)
    path = own if os.path.exists(own) else path
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        blocks = meta.get("blocks")
        if blocks is not None:
            if meta["num_processes"] != world:
                raise ValueError(
                    f"checkpoint was written by {meta['num_processes']} "
                    f"processes; this run has {world}")
            if path != own:
                raise ValueError(
                    f"process {rank} found the multi-process checkpoint "
                    f"master but not its own part '{own}' — resume on the "
                    f"same hosts (or copy each part to its host) with the "
                    f"same process count")
        bf16_keys = set(meta.get("bf16_keys") or ())

        def data(k):
            if blocks is None:
                return z[k]
            bm = blocks[k]
            have = [tuple(map(tuple, b)) for b in bm["bounds"]]
            want = _bounds(comm, bm["shape"])
            if want not in have:
                raise ValueError(
                    f"checkpoint resume asked for block {want} but this "
                    f"process saved {sorted(have)} — resume must use the "
                    f"same process count, device order and --shard tiling "
                    f"as the run that wrote the checkpoint")
            return z[f"{k}.b{have.index(want)}"]

        ndim = meta["ndim"]
        d_keys = [f"d{k}" for k in range(ndim)
                  if f"d{k}" in z.files or (blocks and f"d{k}" in blocks)]
        state = {
            "recon": data("recon"),
            "b_norm": z["b_norm"],
            "delta": z["delta"],
            "mse": z["mse"],
            "i": z["i"],
            "tk": z["tk"] if "tk" in z.files else np.float32(1.0),
            "accs": tuple(data(f"acc{k}") for k in range(ndim)),
            "ds": tuple(data(k) for k in d_keys),
        }
        if "early_stopped" in z.files:
            state["early_stopped"] = bool(z["early_stopped"])
    if blocks is None and _distributed(comm):
        state = state_block(state, comm.grid, comm.rank)
    if blocks is not None:
        bf16_keys = {k for k, bm in blocks.items() if bm.get("bf16")}

    def decode(k, a):
        return from_bf16_bits(a) if k in bf16_keys else a

    state["recon"] = decode("recon", state["recon"])
    state["accs"] = tuple(decode(f"acc{k}", a)
                          for k, a in enumerate(state["accs"]))
    state["ds"] = tuple(decode(k, a) for k, a in zip(d_keys, state["ds"]))
    return state, meta


def load_state(path: str, comm=None, check=None):
    """Load a checkpoint; returns ``(state, meta)`` with numpy arrays, and
    bfloat16 arrays (the meta's ``bf16_keys``, or blocks flagged ``bf16``)
    as bfloat16 CPU tensors. ``check(meta)``, where given, may refuse the
    checkpoint by raising ``ValueError``.

    With a ``comm`` of more than one rank every rank of the mesh must call
    this: each reads its own part (or cuts its block from a single-process
    file), then the ranks agree in one collective. Where any rank could
    not read its part (any error: a missing or corrupt file, another
    mesh's part) or ``check`` refused it, every rank raises (its own
    error, or one naming the ranks that failed); where the parts hold
    different iterations (a job that died between two ranks' saves), or
    some ranks found parts and others a single-process file, every rank
    warns and returns ``(None, meta)``: the run starts afresh."""
    def read():
        state, meta = _read(path, comm)
        if check is not None:
            check(meta)
        return state, meta

    if not _distributed(comm):
        return read()
    state, meta = comm.together(read, f"could not resume from {path}",
                                ValueError)
    votes = comm.gather_values([int(state["i"]),
                                meta.get("blocks") is not None])
    gens = votes[:, 0].astype(np.int64)
    if int(gens.min()) != int(gens.max()) \
            or votes[:, 1].min() != votes[:, 1].max():
        warnings.warn(
            f"checkpoint parts disagree on iteration ({gens}) — the job "
            f"died mid-save; discarding the checkpoint and restarting from "
            f"scratch", stacklevel=2)
        return None, meta
    return state, meta


def _npz_member(path: str, key: str) -> np.ndarray:
    """The array ``key`` of the .npz at ``path`` as a read-only memmap of
    its member (``np.savez`` stores members uncompressed, so a slice of it
    reads only the slice's bytes), or read whole from a compressed file."""
    with zipfile.ZipFile(path) as zf:
        info = zf.getinfo(key + ".npy")
    if info.compress_type != zipfile.ZIP_STORED:
        with np.load(path) as z:
            return z[key]
    fmt = np.lib.format
    with open(path, "rb") as f:
        # the member's local header: 30 bytes, then its name and extra field
        f.seek(info.header_offset + 26)
        name_len, extra_len = struct.unpack("<HH", f.read(4))
        f.seek(info.header_offset + 30 + name_len + extra_len)
        version = fmt.read_magic(f)
        read = (fmt.read_array_header_1_0 if version == (1, 0)
                else fmt.read_array_header_2_0)
        shape, fortran, dtype = read(f)
        offset = f.tell()
    return np.memmap(path, dtype=dtype, mode="r", offset=offset,
                     shape=shape, order="F" if fortran else "C")


def load_state_block(path: str, sl: Sequence[slice], check=None
                     ) -> Dict[str, Any]:
    """A single-process checkpoint's state, as :func:`load_state` gives
    it, with ``recon``, the accumulators and the shadow duals cut to the
    block ``sl`` of the cube (contiguous copies). Each is read through a
    memmap of its member, so only the block's bytes are read: the ranks of
    a host cut their blocks from one file without any of them holding the
    whole state. ``check(meta)``, where given, may refuse the checkpoint
    by raising ``ValueError``, as does a multi-process part."""
    sl = tuple(sl)
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        if meta.get("blocks") is not None:
            raise ValueError(f"'{path}' is a multi-process checkpoint part, "
                             f"not a single-process checkpoint")
        if check is not None:
            check(meta)
        state = {k: z[k] for k in ("b_norm", "delta", "mse", "i")}
        state["tk"] = z["tk"] if "tk" in z.files else np.float32(1.0)
        if "early_stopped" in z.files:
            state["early_stopped"] = bool(z["early_stopped"])
        d_keys = [f"d{k}" for k in range(meta["ndim"])
                  if f"d{k}" in z.files]
    bf16_keys = set(meta.get("bf16_keys") or ())

    def cut(k):
        a = np.ascontiguousarray(_npz_member(path, k)[sl])
        return from_bf16_bits(a) if k in bf16_keys else a

    state["recon"] = cut("recon")
    state["accs"] = tuple(cut(f"acc{k}") for k in range(meta["ndim"]))
    state["ds"] = tuple(cut(k) for k in d_keys)
    return state


def progress_chunk_size(n_total: int) -> int:
    """Chunk length for progress-driven chunked execution: frequent
    enough for a live bar, long enough to amortize the per-chunk host
    work."""
    return max(25, min(250, n_total // 40 or 1))


def checkpoint_exists(path: Optional[str], comm=None) -> bool:
    """Whether a resumable checkpoint exists at ``path``; on a mesh of
    several ranks, whether this rank has one: its own part, or a master
    file without parts of this mesh (a single-process checkpoint, which
    every rank cuts, or one of another process count, which every rank
    refuses). A master whose part of this rank is missing is no
    checkpoint; an unreadable master is one, so that the resume reports
    it on every rank."""
    if not path:
        return False
    if not _distributed(comm):
        return os.path.exists(path)
    if os.path.exists(_part_path(path, comm.rank)):
        return True
    if not os.path.exists(path):
        return False
    try:
        meta = _read_meta(path)
    except Exception:
        # an unreadable master: the ranks' resume, which reads it, fails
        # on every rank alike
        return True
    return meta.get("blocks") is None \
        or meta.get("num_processes") != comm.world


def _meta_check(meta: Dict[str, Any], expected_shape):
    """A refusal of checkpoints of another cube or schedule."""

    def check(ck_meta):
        if ck_meta["shape"] != list(expected_shape):
            raise ValueError(
                f"checkpoint shape {ck_meta['shape']} does not match input "
                f"{list(expected_shape)}"
            )
        for k, v in meta.items():
            # a checkpoint from a different schedule would silently
            # misinterpret the saved iteration index / momentum state
            if k != "shape" and ck_meta.get(k, v) != v:
                raise ValueError(
                    f"checkpoint {k}={ck_meta.get(k)!r} does not match the "
                    f"requested run's {k}={v!r}"
                )

    return check


def chunk_driver(
    run_chunk,
    n_total: int,
    checkpoint_path: Optional[str],
    checkpoint_every: int,
    resume: bool,
    meta: Dict[str, Any],
    expected_shape,
    progress=None,
    comm=None,
):
    """The chunked-execution loop.

    ``run_chunk(engine_state_or_None, i_stop) -> out_dict`` runs the solver
    up to the global iteration cap and returns the ``keep_state=True``
    result dict; the state it is handed is a loaded checkpoint (numpy
    arrays) or the previous chunk's result, still on the device. The loop
    persists state (including the early-stop latch, so resuming a converged
    job is an idempotent no-op) and stops on convergence or completion.

    ``comm``: a mesh's ``MeshComm``; every rank runs the loop, each with
    its block, and saves and loads its part. There ``resume`` is the
    ranks' joint decision (``parallel/api.py::denoise_sharded`` votes),
    taken as it is. The result carries ``saves`` (each save's
    :func:`save_state` seconds and bytes) and ``resumed_from`` (the
    iteration of the loaded checkpoint, or None).
    """
    state = None
    if resume and (_distributed(comm) or checkpoint_exists(checkpoint_path)):
        state, _ = load_state(checkpoint_path, comm,
                              check=_meta_check(meta, expected_shape))
    resumed_from = int(state["i"]) if state is not None else None

    out = None
    saves = []
    while True:
        if state is not None and (
            state.get("early_stopped", False)
            or int(state["i"]) >= n_total
        ):
            break
        i_now = int(state["i"]) if state is not None else 0
        i_stop = (min(i_now + checkpoint_every, n_total)
                  if checkpoint_every > 0 else n_total)
        engine_state = (
            {k: v for k, v in state.items() if k != "early_stopped"}
            if state is not None else None
        )
        out = run_chunk(engine_state, i_stop)
        state = {
            "recon": out["recon"],
            "accs": out["accs"],
            "ds": out["ds"],
            "b_norm": out["b_norm"],
            "delta": out["delta"],
            "mse": out.get("mse"),
            "i": out["i"],
            "tk": out["tk"],
            "early_stopped": bool(out["early_stopped"]),
        }
        if checkpoint_path:
            saves.append(save_state(checkpoint_path, state, meta, comm))
        if progress is not None:
            d = to_numpy(out["delta"])
            nz = d[np.nonzero(d)]
            progress(int(out["iterations_run"]), n_total,
                     float(nz[-1]) if nz.size else float("nan"))
        if state["early_stopped"] or int(out["iterations_run"]) >= n_total:
            break
    if out is None:
        # the checkpoint already covered the whole schedule: run one
        # zero-iteration chunk so the result comes back through the
        # engine's output contract
        engine_state = {k: v for k, v in state.items()
                        if k != "early_stopped"}
        out = run_chunk(engine_state, int(state["i"]))
        out = {**out, "early_stopped": state.get("early_stopped", False)}
    return {**out, "saves": saves, "resumed_from": resumed_from}


def run_chunked(
    datacube: np.ndarray,
    lambda_inv: np.ndarray,
    lam_mu: np.ndarray,
    opts: SolverOptions,
    checkpoint_path: Optional[str],
    checkpoint_every: int,
    resume: bool = False,
    reference_data: Optional[np.ndarray] = None,
    progress=None,
    *,
    device="cuda",
) -> Dict[str, Any]:
    """Run the solver on ``device`` in checkpointed chunks; returns the
    result dict (``recon``, ``b_norm``, ``delta`` [, ``mse``] as numpy
    arrays, ``iterations_run``).

    ``checkpoint_path`` falsy keeps no file. ``progress``: optional
    callback ``(iterations_done, n_total, delta)`` invoked after each chunk
    (the reference's per-iteration tqdm, reference cyTVDN.py:147-152). The
    state stays on the device for the whole run; its peak memory is the
    unchunked run's."""
    from cytvdn_tpu_torch.api import _to_device
    from cytvdn_tpu_torch.solver.engine import run_solver

    n_total = opts.total_iterations
    meta = {
        "ndim": opts.ndim,
        "shape": list(datacube.shape),
        "iterations_fista": opts.iterations_fista,
        "iterations_unacc": opts.iterations_unacc,
        # the JAX package's tag: an exact checkpoint resumed lossy (or vice
        # versa) would change the duals' rounding mid-run
        "lossy_duals": bool(opts.lossy_duals and opts.iterations_fista),
    }
    device = torch.device(device)
    orig = _to_device(datacube, device)
    li = _to_device(lambda_inv, device)
    lm = _to_device(lam_mu, device)
    ref = _to_device(reference_data, device) if opts.calculate_mse else None

    def run_chunk(engine_state, i_stop):
        if engine_state is not None and \
                not torch.is_tensor(engine_state["recon"]):
            engine_state = state_from_numpy(engine_state, device)
        return run_solver(orig, li, lm, opts, ref, state=engine_state,
                          i_stop=i_stop, keep_state=True)

    out = chunk_driver(run_chunk, n_total, checkpoint_path,
                       checkpoint_every, resume, meta, datacube.shape,
                       progress=progress)

    result = {
        "recon": to_numpy(out["recon"]),
        "b_norm": to_numpy(out["b_norm"]),
        "delta": to_numpy(out["delta"]),
        "iterations_run": int(out["iterations_run"]),
    }
    if opts.calculate_mse:
        result["mse"] = to_numpy(out["mse"])
    return result


def run_with_checkpointing(
    datacube: np.ndarray,
    mu,
    lam=None,
    iterations=10,
    FISTA=True,
    stopping_relative_change=None,
    BC_mode=2,
    isotropic_R=False,
    isotropic_Q=False,
    reference_data=None,
    quiet=True,
    backend="auto",
    checkpoint_path: str = "",
    checkpoint_every: int = 0,
    resume: bool = False,
    lossy_duals: bool = False,
    *,
    device="cuda",
) -> Dict[str, Any]:
    """User-level checkpointed run with the ``denoise*`` parameter surface
    and the ``device`` keyword of this package's API."""
    from cytvdn_tpu_torch.api import _memory_note, _validate_and_derive

    ndim = np.asarray(datacube).ndim
    datacube, mu, lam, lambda_inv, lam_mu = _validate_and_derive(
        datacube, mu, lam, ndim, 32.0 if ndim == 4 else 16.0
    )
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
        backend=backend,
        lossy_duals=lossy_duals,
    )
    _memory_note(datacube, opts, quiet)
    return run_chunked(
        datacube, lambda_inv, lam_mu, opts, checkpoint_path,
        checkpoint_every, resume, reference_data, device=device,
    )
