"""Out-of-core runs on one card: the state lives in host memory and streams
through the device in axis-0 slabs.

Counterpart of the single-host part of ``cytvdn_tpu/solver/outofcore.py``
(``solve_outofcore``, ``solve_outofcore_temporal``, ``denoise_outofcore``).
It is how one card runs a state larger than its memory, at the price of
moving the state over PCIe.

- **Stream mode** (:func:`solve_outofcore`): each iteration sweeps the slabs
  in order, one K=1 launch with operand halos per slab
  (``kernels/fused.py``). The halos come from the pre-update host state —
  the -1 neighbour's last row is read before that neighbour's results are
  written back, the +1 neighbour's first rows before it runs — so the
  arithmetic is that of the in-core run, bitwise, and the traces, the stop
  and the MSE are exact per iteration.
- **Temporal mode** (:func:`solve_outofcore_temporal`): each slab is
  loaded with K-row margins and iterated K times on the card (pairs for the
  bulk, the last one or two iterations as K=1 launches, all without halos)
  before its core rows are written back. The stencil's light cone moves
  one row per iteration, so the margins absorb the wrong edges and the core
  is bitwise the in-core run; traffic per iteration drops K-fold. Traces,
  the stop and the MSE are taken at sweep-final iterations only.

On the card the JAX version's async dispatch and buffer donation become an
explicit pipeline:

- the host state is page-locked (numpy arrays, exactly sized, with
  tensors over them for the copies), since a copy from pageable memory is
  synchronous and slow; the returned recon is one of those arrays;
- copies run on one copy stream, the kernels on the current stream, ordered
  by events: a slab's kernels wait for its host-to-device copies, its
  device-to-host copies wait for its kernels. Program order on the copy
  stream keeps the rule that makes the run exact: slab i+1's copies (its
  halo rows and margins among them) are queued before slab i's results,
  and a pinned copy reads host memory when it runs;
- two generations of slab buffers on the device, so one slab computes
  while the next is copied in; a generation is reused only after its
  results have been copied out (program order on the copy stream);
- each slab's sums stay on the device until the sweep ends; they are read
  once per sweep and added in slab order as Python floats.

``device="cpu"`` runs the same sweeps with the kernels' plain versions and
synchronous copies, because the caller asked for it. There is no fallback:
a CUDA run reaches the kernels or raises.

Lossy duals (``lossy_duals``): the host's shadow duals are bfloat16,
page-locked (``outofcore.py:303-310, :385``), which halves their host
memory and PCIe bytes; the slabs' duals on the card are bfloat16 too. In
stream mode the +1 neighbour's first d row, copied in as bfloat16, widens
exactly to float32 on the card for the kernel's seam operand
(``:456-457``); in temporal mode the pairs and K=1 launches run on the
slabs' bfloat16 d (the pair kernel's and the K=1 kernel's ``LOSSY``
instantiations), and a margin's zeroed first d row is a bfloat16 zero. A
lossy run is bitwise the in-core lossy run in either mode.

Several processes (:func:`solve_outofcore_multihost`): each owns a
balanced axis-0 row range of the cube (:func:`process_row_range`), holds
only its rows of the host state, with K ghost rows on each interior edge,
and runs the temporal-mode pipeline above on its own slabs, one card per
process. One exchange of the K-row pre-sweep bands of every state array
per sweep (``parallel/halo.py::MeshComm``, point to point, its buffers
reserved before the first collective) refreshes the ghost rows; the slabs'
sums are added across the processes in rank order, so every process takes
the same stop decision; each process writes its own checkpoint part
(``path.ooc<p>``) in the JAX package's format. The stitched recon is
bitwise the in-core run.

Slabs split over several cards (:func:`solve_outofcore_sharded_temporal`,
``solve_outofcore_multihost(shard_w=W)``, ``denoise_outofcore(shard_w=W)``):
a group of P·W processes, one card each, forms a (P, W) grid in row-major
order. Process-row r owns the axis-0 rows ``process_row_range(n0, P, r)``,
and each of its W ranks one axis-1 column block of N1/W columns, of which
alone it holds the host state. The ranks of a process-row sweep the same
slabs, each its columns of every slab, and advance them together
(:class:`_Cols`): the pairs take the pair kernel's axis-1 bands
(``HALO1``) and the K=1 launches their operand halos (``HALO``) from the
neighbouring columns, while the unsplit axis 0 keeps the slab's own edges.
The K-row band exchange runs between the P ranks of each column; the sums
are added over all P·W ranks. The stitched blocks are bitwise the in-core
run.
"""

from __future__ import annotations

import gc
import os
import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from cytvdn_tpu_torch.api import _validate_and_derive
from cytvdn_tpu_torch.config import (
    BCMode,
    SolverOptions,
    normalize_iterations,
)
from cytvdn_tpu_torch.kernels import build
from cytvdn_tpu_torch.kernels.fused import fused_iteration, fused_supported
from cytvdn_tpu_torch.kernels.temporal import fused_pair_iteration, pair_supported
from cytvdn_tpu_torch.parallel.halo import MeshComm
from cytvdn_tpu_torch.solver.engine import (
    _k1_halos,
    _pair_bands,
    d_dtype,
    fista_tk_ratios,
)

Tensor = torch.Tensor

#: slab-buffer generations on the device: one computes while the next is
#: copied in
GENERATIONS = 2

#: what the last run moved and how long it took: pinned host bytes and the
#: seconds to allocate and fill them; bytes copied each way and the copy
#: stream's seconds for them (CUDA events on the card, the host clock on
#: the CPU); sweeps run and their wall seconds (the host clock, from each
#: sweep's first copy to its sums on the host)
last_run: Dict[str, float] = {}

#: test hook — called with ``it_run`` after each completed checkpoint save
_POST_CKPT_HOOK = None


def _ckpt_meta(opts: SolverOptions, shape, mode: str) -> Dict:
    """Schedule/geometry fingerprint stored in out-of-core checkpoints (the
    JAX package's keys): a resume against a different schedule would
    misread the saved iteration index."""
    return {
        "shape": list(shape), "ndim": opts.ndim,
        "iterations_fista": opts.iterations_fista,
        "iterations_unacc": opts.iterations_unacc,
        "stopping": opts.stopping_relative_change,
        "bc_mode": int(opts.bc_mode),
        "mode": mode,
        "lossy": bool(opts.lossy_duals),
    }


def _ckpt_resume(path, resume: bool, meta: Dict, shape):
    """Load and validate an out-of-core checkpoint, or None."""
    from cytvdn_tpu_torch.utils.checkpoint import (
        _meta_check,
        checkpoint_exists,
        load_state,
    )

    if not (resume and checkpoint_exists(path)):
        return None
    return load_state(path, check=_meta_check(meta, shape))[0]


def _restore_state(st, sl, recon, accs, ds, b_norm, delta, mse):
    """Restore a loaded checkpoint into the rows ``sl`` of the run's host
    arrays in place (the whole arrays in one process, the own rows between
    the ghost rows of a multi-process run; ``ds``: the host's shadow-dual
    tensors, bfloat16 under lossy duals, where the checkpoint's are
    bfloat16 tensors too). Returns ``(start, resumed_stop)``."""
    recon[sl] = np.asarray(st["recon"], np.float32)
    for k, a in enumerate(accs):
        a[sl] = np.asarray(st["accs"][k], np.float32)
    for k, d in enumerate(ds):
        x = st["ds"][k]
        d[sl].copy_(x if torch.is_tensor(x)
                    else torch.from_numpy(np.asarray(x, np.float32)))
    b_norm[:] = st["b_norm"]
    delta[:] = st["delta"]
    if mse is not None and np.asarray(st["mse"]).size == mse.size:
        mse[:] = st["mse"]
    return int(st["i"]), bool(st.get("early_stopped", False))


def _ckpt_save(path, meta, it_run, recon, accs, ds, b_norm, delta, mse,
               stopped: bool):
    """Atomic full-state save of a host-resident out-of-core run, in the
    JAX package's format."""
    from cytvdn_tpu_torch.utils.checkpoint import save_state

    save_state(path, {
        "recon": recon,
        "accs": tuple(accs),
        "ds": tuple(ds),
        "b_norm": b_norm,
        "delta": delta,
        "mse": mse if mse is not None else np.zeros(0, np.float32),
        "i": np.int32(it_run),
        "early_stopped": bool(stopped),
    }, meta)


def _host_sse(a: np.ndarray, b: np.ndarray) -> float:
    """SSE over host arrays, float64-accumulated in row chunks of 8."""
    tot = 0.0
    for lo in range(0, a.shape[0], 8):
        d = (a[lo:lo + 8].astype(np.float64)
             - b[lo:lo + 8].astype(np.float64)).ravel()
        tot += float(np.dot(d, d))
    return tot


def _slab_bounds(n0: int, n_slabs: int):
    """Balanced split of ``n0`` rows into ``n_slabs`` contiguous slabs
    (sizes differ by at most one)."""
    n_slabs = max(1, min(n_slabs, n0))
    base, extra = divmod(n0, n_slabs)
    bounds = []
    start = 0
    for i in range(n_slabs):
        stop = start + base + (1 if i < extra else 0)
        bounds.append((start, stop))
        start = stop
    return bounds


def _check_options(opts: SolverOptions, orig: np.ndarray) -> np.ndarray:
    if opts.bc_mode != BCMode.JIA_ZHAO or opts.isotropic_R or opts.isotropic_Q:
        raise ValueError("out-of-core mode covers Jia-Zhao anisotropic runs")
    orig = np.ascontiguousarray(orig)
    if orig.dtype != np.float32:
        raise ValueError("out-of-core mode requires float32 data, got "
                         f"{orig.dtype}")
    return orig


class _HostState:
    """The run's state in host memory: orig, recon, the accumulators and
    (FISTA) the shadow duals (of ``d_dt``: bfloat16 under lossy duals), as
    tensors over numpy arrays (a bfloat16 tensor over an int16 array). On a
    CUDA run the arrays are page-locked, each exactly sized
    (``kernels/build.py::host_empty``): PyTorch's pinned allocator
    (``pin_memory=True``) rounds each allocation up to a power of two and
    keeps it locked in its cache after the run, and locking ordinary pages
    in place (``cudaHostRegister``) took 2.5-3 times as long."""

    def __init__(self, orig: np.ndarray, ndim: int, fista: bool,
                 device: torch.device, d_dt: torch.dtype = torch.float32,
                 pad: Tuple[int, int] = (0, 0)):
        self.cuda = device.type == "cuda"
        t0 = time.perf_counter()
        # a multi-process run's ghost rows: ``pad`` rows before and after
        # the own rows, zero until the first exchange fills them
        tg, bg = pad
        shape = (tg + orig.shape[0] + bg,) + orig.shape[1:]

        def empty(dtype=torch.float32):
            if not self.cuda:
                return torch.empty(shape, dtype=dtype)
            if dtype == torch.bfloat16:
                return torch.from_numpy(build.host_empty(
                    shape, np.int16)).view(torch.bfloat16)
            return torch.from_numpy(build.host_empty(shape))

        def filled():
            t = empty()
            a = t.numpy()
            a[:tg] = 0
            a[tg:tg + orig.shape[0]] = orig
            a[tg + orig.shape[0]:] = 0
            return t

        self.orig = filled()
        self.recon = filled()
        self.accs = [empty().zero_() for _ in range(ndim)]
        self.ds = [empty(d_dt).zero_() for _ in range(ndim)] if fista else []
        last_run["pinned_bytes"] = float(sum(
            t.numel() * t.element_size() for t in self.arrays(fista))) \
            if self.cuda else 0.0
        last_run["pin_seconds"] = time.perf_counter() - t0

    def arrays(self, fista: bool) -> List[Tensor]:
        """orig, recon, the accumulators [, the shadow duals]."""
        return [self.orig, self.recon, *self.accs,
                *(self.ds if fista else [])]

    def close(self) -> None:
        """Wait for the card's copies, so that no copy is pending when the
        arrays are freed (also after an exception)."""
        if self.cuda:
            torch.cuda.synchronize()


class _Slabs:
    """Device buffers for ``GENERATIONS`` slabs of up to ``rows`` rows:
    orig, recon, the accumulators [, the shadow duals, of ``d_dt``], and
    per generation the seam operands of a stream-mode launch (float32; a
    bfloat16 d row as it arrives, ``next0_d16``, under lossy duals). A slab
    of fewer rows uses the leading rows (contiguous views)."""

    def __init__(self, rows: int, tail: Tuple[int, ...], ndim: int,
                 fista: bool, device: torch.device, halos: bool,
                 d_dt: torch.dtype = torch.float32):
        def empty(r, *t, dtype=torch.float32):
            return torch.empty((r, *t), dtype=dtype, device=device)

        self.gens = []
        for _ in range(GENERATIONS):
            arrays = [empty(rows, *tail) for _ in range(2 + ndim)]
            if fista:
                arrays += [empty(rows, *tail, dtype=d_dt)
                           for _ in range(ndim)]
            g = {"arrays": arrays}
            if halos:
                col = (1,) + tail[1:]
                g["prev0"], g["next0_recon"], g["next0_acc"], g["next0_d"] = (
                    empty(1, *tail) for _ in range(4))
                if fista and d_dt != torch.float32:
                    g["next0_d16"] = empty(1, *tail, dtype=d_dt)
                g["prev1"], g["next1_recon"] = (empty(rows, *col)
                                                for _ in range(2))
            self.gens.append(g)
        if halos:
            # axis 1 is never cut: its +1 acc/d halos are the JZ zeros, as
            # are axis 0's at the last slab
            self.zero_row = torch.zeros((1, *tail), dtype=torch.float32,
                                        device=device)
            self.zero_col = torch.zeros((rows, 1) + tail[1:],
                                        dtype=torch.float32, device=device)

    def arrays(self, si: int, rows: int, fista: bool, ndim: int):
        """Slab ``si``'s (orig, recon, accs, ds) views of ``rows`` rows."""
        a = [x[:rows] for x in self.gens[si % GENERATIONS]["arrays"]]
        return a[0], a[1], a[2:2 + ndim], (a[2 + ndim:] if fista else None)


class _Pipe:
    """Host↔device copies on one copy stream, ordered against the kernels
    on the current stream by events, with their bytes and copy-stream
    seconds counted in :data:`last_run`. On the CPU the copies are plain
    synchronous copies."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.copy = torch.cuda.Stream(device)
            self.compute = torch.cuda.current_stream(device)
        self.timed: List[Tuple[str, object, object]] = []
        for k in ("h2d_bytes", "h2d_seconds", "d2h_bytes", "d2h_seconds"):
            last_run[k] = 0.0

    def _event(self, stream=None):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def copies(self, kind: str, pairs, after=None, zero=()):
        """Queue ``dst.copy_(src)`` for each pair on the copy stream (after
        the event ``after``), then ``t.zero_()`` for each of ``zero``;
        returns the event of their end."""
        last_run[f"{kind}_bytes"] += float(sum(s.numel() * s.element_size()
                                               for _, s in pairs))
        if not self.cuda:
            t0 = time.perf_counter()
            for dst, src in pairs:
                dst.copy_(src)
            last_run[f"{kind}_seconds"] += time.perf_counter() - t0
            for t in zero:
                t.zero_()
            return None
        if after is not None:
            self.copy.wait_event(after)
        with torch.cuda.stream(self.copy):
            start = self._event(self.copy)
            for dst, src in pairs:
                dst.copy_(src, non_blocking=True)
            end = self._event(self.copy)
            for t in zero:
                t.zero_()
        self.timed.append((kind, start, end))
        return self._event(self.copy) if zero else end

    def compute_after(self, ev) -> None:
        """The kernels queued next wait for the copies of ``ev``."""
        if ev is not None:
            self.compute.wait_event(ev)

    def computed(self):
        """An event at the end of the kernels queued so far."""
        return self._event(self.compute) if self.cuda else None

    def drain(self) -> None:
        """Wait for everything queued; add the copy seconds up."""
        if not self.cuda:
            return
        torch.cuda.synchronize()
        for kind, start, end in self.timed:
            last_run[f"{kind}_seconds"] += start.elapsed_time(end) / 1e3
        self.timed.clear()


def _scalars(lambda_inv, lam_mu, n_f: int, device):
    """λ⁻¹, λ/μ and the FISTA momentum ratios on ``device``."""
    li = torch.from_numpy(np.asarray(lambda_inv, np.float32).copy()).to(device)
    lm = torch.from_numpy(np.asarray(lam_mu, np.float32).copy()).to(device)
    rhos = torch.from_numpy(fista_tk_ratios(n_f).astype(np.float32)).to(device)
    return li, lm, rhos


def _run_schedule(opts, start, resumed_stop, sweep, record, save, k_max):
    """Drive the sweeps of both phases, as the JAX solvers do: the
    unaccelerated phase's trace slots start at ``n_f`` whatever the FISTA
    phase did, its stop latch is reset, and a sweep never crosses the
    phase boundary. ``sweep(fista, t0, count)`` runs ``count`` iterations
    of a phase from its position ``t0`` and returns (bnorm, delta, sse) of
    the last; ``record(it_run, bn, dl, sse)`` writes the traces;
    ``save(it_run, done, stopped)`` saves. Returns (it_run, stopped)."""
    n_f, n_u = opts.iterations_fista, opts.iterations_unacc
    stopping = opts.stopping_relative_change
    it_run, stopped = start, resumed_stop
    if resumed_stop or start >= opts.total_iterations:
        return it_run, stopped
    for fista, count, base in ((True, n_f, 0), (False, n_u, n_f)):
        if not count:
            continue
        if not fista:
            stopped = False  # the second phase runs regardless (reference)
        t = min(max(start - base, 0), count)
        while t < count and not stopped:
            k_t = min(k_max, count - t)
            bn, dl, sse = sweep(fista, t, k_t)
            t += k_t
            it_run = base + t
            record(it_run, bn, dl, sse)
            if stopping is not None and dl < stopping:
                stopped = True
            else:
                save(it_run, False, False)
    save(it_run, True, stopped)
    return it_run, stopped


class _Run:
    """What every mode shares: a run's host state, traces, checkpoint and
    copy pipe, and :meth:`solve`, which drives the schedule through
    pipelined sweeps built from each mode's slab steps. ``procs`` (a
    :class:`_Procs`) makes it one process's part of a multi-process run:
    its host arrays carry ghost rows, each sweep starts with the band
    exchange, the sums are added across the processes, and the checkpoint
    is this process's part. ``cols`` (a :class:`_Cols`) makes ``orig``
    the process's column block: the part's meta records it, and a resume
    that finds no part cuts the block from a one-file checkpoint of the
    whole cube (:meth:`_Cols.one_file`)."""

    def __init__(self, orig, opts, reference, checkpoint_path,
                 checkpoint_every, resume, mode: str, device, procs=None,
                 cols=None):
        n_total = opts.total_iterations
        self.opts, self.reference, self.procs = opts, reference, procs
        pad = (procs.tg, procs.bg) if procs else (0, 0)
        #: the own rows of the host arrays
        self.own = slice(pad[0], pad[0] + orig.shape[0])

        def alloc():
            return _HostState(orig, opts.ndim, opts.fista, device,
                              d_dtype(opts, torch.float32), pad)

        self.host = host = alloc() if procs is None else procs.comm.together(
            alloc, "could not allocate its out-of-core host state",
            RuntimeError)
        self.pipe = _Pipe(device)
        self.b_norm = np.zeros(n_total, np.float32)
        self.delta = np.zeros(n_total, np.float32)
        with_mse = opts.calculate_mse and reference is not None
        self.mse = np.zeros(n_total + 1, np.float32) if with_mse else None
        if with_mse:
            sse0 = _host_sse(orig, reference)
            self.mse[0] = procs.sums([sse0])[0] if procs else sse0
        meta, fallback = None, None
        if checkpoint_path:
            meta = _ckpt_meta(opts, orig.shape, mode)
            if cols:
                fallback = cols.one_file(checkpoint_path, resume, opts, mode,
                                         procs, orig.shape)
            if procs:
                checkpoint_path = f"{checkpoint_path}.ooc{procs.pid}"
                meta.update(proc=procs.pid, nproc=procs.nproc,
                            grows=[procs.g0, procs.g1, procs.n0])
            if cols:
                meta["gcols"] = [cols.c0, cols.c1, cols.n1]
        self.start, self.resumed_stop, self.resumed = 0, False, False
        if checkpoint_path:
            try:
                st = procs.resume(checkpoint_path, resume, meta, orig.shape,
                                  fallback) if procs else _ckpt_resume(
                    checkpoint_path, resume, meta, orig.shape)
            except BaseException:
                host.close()
                raise
            self.resumed = st is not None
            if st is not None:
                self.start, self.resumed_stop = _restore_state(
                    st, self.own, host.recon.numpy(),
                    [a.numpy() for a in host.accs], host.ds, self.b_norm,
                    self.delta, self.mse)
        self.save = self._saver(checkpoint_path, checkpoint_every, meta)
        self.cols = cols
        last_run["sweeps"] = 0.0
        last_run["sweep_seconds"] = 0.0

    def _saver(self, checkpoint_path, every, meta):
        """``save(it_run, done, stopped)``: a save at the first sweep end at
        or past each multiple of ``every`` (every multiple, in stream
        mode), and the terminal save; only the terminal save may record a
        stop. In a multi-process run each process saves its own rows to its
        part, and the processes meet in one collective after it, so that no
        process takes a generation as resumable before every part of it
        exists, and one process's failed save is every process's."""
        if not checkpoint_path:
            return lambda it_run, done, stopped: None
        host, own, procs = self.host, self.own, self.procs
        nxt = (self.start // every + 1) * every if every > 0 else None

        def save(it_run, done, stopped):
            nonlocal nxt
            due = nxt is not None and it_run >= nxt and not done
            if done or due:
                def write():
                    _ckpt_save(checkpoint_path, meta, it_run,
                               host.recon.numpy()[own],
                               [a.numpy()[own] for a in host.accs],
                               [d[own] for d in host.ds], self.b_norm,
                               self.delta, self.mse, done and stopped)

                if procs:
                    procs.comm.together(
                        write, "failed to save its out-of-core checkpoint "
                        "part")
                else:
                    write()
                if _POST_CKPT_HOOK is not None:
                    _POST_CKPT_HOOK(it_run)
            if due:
                nxt = (it_run // every + 1) * every

        return save

    def _record(self, it_run, bn, dl, sse):
        self.b_norm[it_run - 1] = bn
        self.delta[it_run - 1] = dl
        if self.mse is not None:
            self.mse[it_run] = sse

    def solve(self, n: int, k_max: int, load, compute, store, sse):
        """Run the schedule, up to ``k_max`` iterations per sweep. A sweep
        is one pass over the ``n`` slabs: ``load(si, fista)`` queues slab
        si's copies in and returns their event; ``compute(si, fista, t,
        count)`` queues its kernels behind them and returns its (bnorm,
        delta numerator, delta denominator) on the device; slab si+1's
        copies are queued next, before slab si's results overwrite the host
        rows they read; ``store(si, fista, after)`` queues slab si's
        results out behind its kernels. The slabs' sums are read once per
        sweep and added in slab order; ``sse()`` is then the recon's SSE
        against the reference. In a multi-process run a sweep starts with
        the band exchange, and the sums (the SSE among them) are added
        across the processes in rank order."""
        pipe, procs, host = self.pipe, self.procs, self.host

        def sweep(fista, t, count):
            t0 = time.perf_counter()
            if procs and procs.rows > 1:
                # the bands are the pre-sweep state: every write-back of
                # the last sweep has landed (drained), none of this one
                # is queued yet, and the exchange returns only once both
                # neighbours have packed theirs
                pipe.drain()
                procs.exchange([host.recon, *host.accs, *host.ds],
                               "ooc_state")
            sums = []
            ready = load(0, fista)
            for si in range(n):
                # slab si+1's copies are queued before slab si's kernels:
                # on the copy stream this is the order of one copy after
                # the other, and where queueing the kernels waits on the
                # host (a column split's exchanges) the copies are
                # already under way
                nxt = load(si + 1, fista) if si + 1 < n else None
                pipe.compute_after(ready)
                sums.append(compute(si, fista, t, count))
                store(si, fista, pipe.computed())
                ready = nxt
            pipe.drain()
            bn = dn = dd = 0.0
            for s in torch.stack(sums).cpu().tolist():
                bn += s[0]
                dn += s[1]
                dd += s[2]
            err = sse() if self.mse is not None else 0.0
            if procs:
                bn, dn, dd, err = procs.sums([bn, dn, dd, err])
            last_run["sweeps"] += 1
            last_run["sweep_seconds"] += time.perf_counter() - t0
            # all-zero input: the in-core 0/0 -> NaN instead of raising
            return bn, dn / dd if dd else float("nan"), err

        try:
            it_run, stopped = _run_schedule(
                self.opts, self.start, self.resumed_stop, sweep,
                self._record, self.save, k_max)
        finally:
            host.close()
        out = {
            "recon": host.recon.numpy()[self.own],
            "b_norm": self.b_norm,
            "delta": self.delta,
            "iterations_run": np.int32(it_run),
            "early_stopped": np.bool_(stopped),
        }
        if self.mse is not None:
            out["mse"] = self.mse
        if procs:
            out["global_rows"] = np.asarray([procs.g0, procs.g1, procs.n0],
                                            np.int64)
            out["exchange"] = dict(procs.comm.stats)
            out["resumed_from"] = self.start if self.resumed else None
        if self.cols:
            c = self.cols
            out["global_cols"] = np.asarray([c.c0, c.c1, c.n1], np.int64)
            out["slices"] = (slice(procs.g0, procs.g1), slice(c.c0, c.c1)) \
                + tuple(slice(0, e) for e in out["recon"].shape[2:])
            out["column_exchange"] = dict(c.comm.stats)
        return out


def solve_outofcore(
    orig: np.ndarray,
    lambda_inv: np.ndarray,
    lam_mu: np.ndarray,
    opts: SolverOptions,
    n_slabs: int,
    reference: Optional[np.ndarray] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Run the full schedule with host-resident state, streaming slabs:
    one K=1 launch with operand halos per slab and iteration.

    Requirements: float32, Jia-Zhao boundaries, anisotropic axes; each slab
    must have at least 2 rows. ``reference`` (with ``opts.calculate_mse``):
    per-iteration SSE against the host-resident reference cube, per slab
    in slab order — ``mse[0]`` the input's, ``mse[i+1]`` after iteration
    ``i``. ``checkpoint_path``/``checkpoint_every``/``resume``: atomic
    full-state saves every N iterations in the JAX package's format and a
    bitwise resume; resuming a finished or stopped run changes nothing.
    ``opts.lossy_duals``: the shadow duals live as bfloat16, on the host
    and on the card.
    """
    orig = _check_options(opts, orig)
    device = torch.device(device)
    ndim, n0, tail = opts.ndim, orig.shape[0], orig.shape[1:]
    bounds = _slab_bounds(n0, n_slabs)
    if min(b - a for a, b in bounds) < 2:
        raise ValueError("slabs must have at least 2 rows")
    for a, b in bounds:
        if not fused_supported((b - a,) + tail, torch.float32, opts.bc_mode):
            raise ValueError(f"slab shape {(b - a,) + tail} unsupported by "
                             "the fused kernel")
    li, lm, rhos = _scalars(lambda_inv, lam_mu, opts.iterations_fista, device)
    slabs = _Slabs(max(b - a for a, b in bounds), tail, ndim,
                   opts.iterations_fista > 0, device, halos=True,
                   d_dt=d_dtype(opts, torch.float32))
    run = _Run(orig, opts, reference, checkpoint_path, checkpoint_every,
               resume, "stream", device)
    host, last = run.host, len(bounds) - 1
    H_recon, H_acc0 = host.recon, host.accs[0]
    H_d0 = host.ds[0] if host.ds else None

    def load(si, fista):
        """Slab ``si``'s inputs and axis-0 halos, from pre-update host
        state: queued before slab si-1's results are copied back."""
        a0, a1 = bounds[si]
        g = slabs.gens[si % GENERATIONS]
        pairs = [(dst[:a1 - a0], src[a0:a1]) for dst, src in
                 zip(g["arrays"], host.arrays(fista))]
        # the -1 neighbour's last row; at the leading edge the own first
        # row (zero difference)
        pairs.append((g["prev0"], H_recon[max(a0 - 1, 0):max(a0, 1)]))
        if si < last:
            pairs += [(g["next0_recon"], H_recon[a1:a1 + 1]),
                      (g["next0_acc"], H_acc0[a1:a1 + 1])]
            if fista:
                # a bfloat16 row lands in its own buffer and widens on the
                # card (halos); a copy that converts would go through
                # pageable host memory
                pairs.append((g.get("next0_d16", g["next0_d"]),
                              H_d0[a1:a1 + 1]))
        else:
            pairs.append((g["next0_recon"], H_recon[a1 - 1:a1]))
        return run.pipe.copies("h2d", pairs)

    def halos(si, fista, r):
        a0, a1 = bounds[si]
        g = slabs.gens[si % GENERATIONS]
        rows = a1 - a0
        # axis 1 is whole: its halos are the JZ edge values, copied on the
        # card from the slab's own pre-update edge columns
        g["prev1"][:rows].copy_(r[:, 0:1])
        g["next1_recon"][:rows].copy_(r[:, -1:])
        zc = slabs.zero_col[:rows]
        h = {"prev0": g["prev0"], "prev1": g["prev1"][:rows],
             "next0_recon": g["next0_recon"],
             "next0_acc": g["next0_acc"] if si < last else slabs.zero_row,
             "next1_recon": g["next1_recon"][:rows], "next1_acc": zc}
        if fista:
            if si < last and "next0_d16" in g:
                g["next0_d"].copy_(g["next0_d16"])  # exact
            h["next0_d"] = g["next0_d"] if si < last else slabs.zero_row
            h["next1_d"] = zc
        return h

    def compute(si, fista, t, count):
        a0, a1 = bounds[si]
        o, r, accs, ds = slabs.arrays(si, a1 - a0, fista, ndim)
        out = fused_iteration(o, r, accs, ds, rhos[t] if fista else None,
                              li, lm, fista=fista, halos=halos(si, fista, r))
        return torch.stack(out[3:])

    def store(si, fista, after):
        a0, a1 = bounds[si]
        g = slabs.gens[si % GENERATIONS]
        pairs = [(dst[a0:a1], src[:a1 - a0]) for dst, src in
                 zip(host.arrays(fista)[1:], g["arrays"][1:])]
        run.pipe.copies("d2h", pairs, after=after)

    def sse():
        rn = host.recon.numpy()
        return sum(_host_sse(rn[a0:a1], reference[a0:a1])
                   for a0, a1 in bounds)

    return run.solve(len(bounds), 1, load, compute, store, sse)


def _extents(bounds, k: int, tg: int, total: int):
    """Each slab's rows with K-row margins, ``(lo, hi, a0, a1)`` in the
    rows of the host arrays (``tg`` ghost rows first, ``total`` rows in
    all), its core ``[a0, a1)``."""
    return [(max(tg + a - k, 0), min(tg + b + k, total), tg + a, tg + b)
            for a, b in bounds]


def _check_extents(ext, tail, opts) -> None:
    for lo, hi, _, _ in ext:
        if hi - lo < 2 or not fused_supported((hi - lo,) + tail,
                                              torch.float32, opts.bc_mode):
            raise ValueError(f"extended slab shape {(hi - lo,) + tail} "
                             "unsupported by the fused kernel")


def solve_outofcore_temporal(
    orig: np.ndarray,
    lambda_inv: np.ndarray,
    lam_mu: np.ndarray,
    opts: SolverOptions,
    n_slabs: int,
    temporal_k: int,
    reference: Optional[np.ndarray] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Out-of-core solve with temporal blocking: ``temporal_k`` iterations
    per slab residency.

    Each slab is loaded with a K-row margin on every interior side and
    iterated K times on the card before its core rows are written back, so
    host↔device traffic per iteration drops K-fold; the core is bitwise
    the in-core run. ``b_norm``/``delta`` (and the SSE with ``reference``)
    hold true values at sweep-final iterations only (zeros between), the
    stop is checked at sweep ends, and a sweep never crosses the
    FISTA→unaccelerated boundary. ``temporal_k`` ≤ 1 is the stream mode.
    ``opts.lossy_duals``: the shadow duals live as bfloat16, on the host
    and in the slabs on the card.
    """
    if temporal_k <= 1:
        return solve_outofcore(orig, lambda_inv, lam_mu, opts, n_slabs,
                               reference=reference,
                               checkpoint_path=checkpoint_path,
                               checkpoint_every=checkpoint_every,
                               resume=resume, device=device)
    orig = _check_options(opts, orig)
    n0, tail = orig.shape[0], orig.shape[1:]
    K = int(temporal_k)
    bounds = _slab_bounds(n0, n_slabs)
    min_core = min(b - a for a, b in bounds)
    if K > min_core:
        # a margin deeper than one neighbour slab would read rows whose
        # results were already written back
        raise ValueError(
            f"temporal_k={K} exceeds the smallest slab core ({min_core} "
            f"rows); use fewer slabs or a smaller temporal_k")
    ext = _extents(bounds, K, 0, n0)
    _check_extents(ext, tail, opts)
    return _run_temporal(orig, lambda_inv, lam_mu, opts, ext, K, reference,
                         checkpoint_path, checkpoint_every, resume,
                         f"temporal{K}", torch.device(device))


def _run_temporal(orig, lambda_inv, lam_mu, opts, ext, K, reference,
                  checkpoint_path, checkpoint_every, resume, mode, device,
                  procs=None, cols=None):
    """The temporal-mode pipeline over the slabs ``ext`` (``_extents``) of
    the host arrays, K iterations per residency; with ``procs``, one
    process's part of a multi-process run; with ``cols``, ``orig`` is its
    column block, and each slab's launches take their axis-1 bands and
    halos from the process-row's other ranks."""
    ndim, tail = opts.ndim, orig.shape[1:]
    fista_run = opts.iterations_fista > 0

    def alloc(pairs=True):
        scalars = _scalars(lambda_inv, lam_mu, opts.iterations_fista, device)
        rows = max(hi - lo for lo, hi, _, _ in ext)
        slabs = _Slabs(rows, tail, ndim, fista_run, device, halos=False,
                       d_dt=d_dtype(opts, torch.float32))
        # the K-1st recon of a chunk, for the last iteration's delta
        r_prev = torch.empty((rows,) + tail, dtype=torch.float32,
                             device=device)
        if cols is not None:
            # one slab of each extended-slab shape (first, interior, last
            # slabs differ by their margins) for the pool's reservation
            views = {hi - lo: slabs.arrays(0, hi - lo, fista_run, ndim)
                     for lo, hi, _, _ in ext}
            cols.reserve(opts, list(views.values()), pairs)
        return scalars, slabs, r_prev

    if procs is None:
        got = alloc()
    elif cols is None:
        got = procs.comm.together(alloc, "could not allocate its slab "
                                  "buffers", RuntimeError)
    else:
        got = cols.prepare(alloc, procs.comm)
    (li, lm, rhos), slabs, r_prev = got
    run = _Run(orig, opts, reference, checkpoint_path, checkpoint_every,
               resume, mode, device, procs, cols)
    host = run.host
    # the global row of the host arrays' row 0
    row0 = procs.g0 - procs.tg if procs else 0
    if procs:
        # orig is constant: its ghost rows are fetched once
        procs.exchange([host.orig], "ooc_orig")

    def load(si, fista):
        """Slab ``si`` with its margins. Where the slab's first row is not
        the cube's first row (keyed on its global position), the slab's
        first accumulator (and shadow dual, bfloat16 under lossy duals) row
        along axis 0 is set to zero: the margin's first row is then a
        Jia-Zhao edge, whose b stays exactly zero, as the kernels' axis-0
        wrap needs wherever the slab ends at the cube's last row; the
        change stays inside the discarded margin."""
        lo, hi, _, _ = ext[si]
        arrays = slabs.gens[si % GENERATIONS]["arrays"]
        pairs = [(dst[:hi - lo], src[lo:hi]) for dst, src in
                 zip(arrays, host.arrays(fista))]
        zero = [arrays[2][0]] + ([arrays[2 + ndim][0]] if fista else []) \
            if row0 + lo > 0 else []
        return run.pipe.copies("h2d", pairs, zero=zero)

    def compute(si, fista, t, count):
        """``count`` iterations on the resident extended slab: pairs for
        the bulk, the last one or two as K=1 launches; returns the core's
        (bnorm, delta numerator, delta denominator) after the last. On a
        column split the pairs are ``HALO1`` launches with the slab's
        axis-1 bands, the K=1 launches ``HALO`` launches with its operand
        halos, both from the neighbouring columns' pre-update state."""
        lo, hi, a0, a1 = ext[si]
        o, r, accs, ds = slabs.arrays(si, hi - lo, fista, ndim)

        def rho(j):
            return rhos[t + j] if fista else None

        n_pairs = max((count - 1) // 2, 0)
        if not pair_supported(tuple(o.shape), o.dtype, BCMode.JIA_ZHAO) \
                or (cols is not None and not cols.pairs):
            n_pairs = 0
        bands = _pair_bands(cols.comm, o, 1) if cols and n_pairs else None
        for p in range(n_pairs):
            fused_pair_iteration(o, r, accs, ds, rho(2 * p), rho(2 * p + 1),
                                 li, lm, fista=fista,
                                 **(bands(r, accs, ds) if bands else {}))
        rp = r_prev[:hi - lo]
        for j in range(2 * n_pairs, count):
            if j == count - 1:
                rp.copy_(r)
            kw = {}
            if cols is not None:
                halos, _, scratch = _k1_halos(cols.comm, opts, r, accs, ds)
                kw = dict(halos=halos, scratch=scratch)
            fused_iteration(o, r, accs, ds, rho(j), li, lm, fista=fista,
                            **kw)
        off, clen = a0 - lo, a1 - a0
        bn = torch.zeros((), dtype=torch.float32, device=device)
        for a in accs:
            bn = bn + torch.sum(torch.abs(a[off:off + clen]))
        rc, rpc = r[off:off + clen], rp[off:off + clen]
        return torch.stack([bn, torch.sum(torch.abs(rc - rpc)),
                            torch.sum(torch.abs(rpc))])

    def store(si, fista, after):
        lo, _, a0, a1 = ext[si]
        off, clen = a0 - lo, a1 - a0
        pairs = [(dst[a0:a1], src[off:off + clen]) for dst, src in
                 zip(host.arrays(fista)[1:],
                     slabs.gens[si % GENERATIONS]["arrays"][1:])]
        run.pipe.copies("d2h", pairs, after=after)

    return run.solve(len(ext), K, load, compute, store,
                     lambda: _host_sse(host.recon.numpy()[run.own],
                                       reference))


def process_row_range(n0: int, nproc: int, pid: int) -> Tuple[int, int]:
    """Balanced axis-0 row range owned by process ``pid`` of ``nproc`` in
    a multi-process out-of-core run (sizes differ by at most one; the
    policy of :func:`_slab_bounds`)."""
    base, extra = divmod(n0, nproc)
    g0 = pid * base + min(pid, extra)
    return g0, g0 + base + (1 if pid < extra else 0)


class _Procs:
    """One process's side of a multi-process out-of-core run: its rows
    ``[g0, g1)`` of ``n0``, its ghost rows (K before the own rows unless
    they start the cube, K after unless they end it), and the
    ``MeshComm`` over the group, on a grid ``(P, W, 1, ...)``: P
    process-rows of W ranks (W = 1 without a column split).

    The band exchange goes through ``MeshComm.exchange_pieces`` on axis 0,
    between the P ranks of this rank's column, each array's head K rows to
    the -1 neighbour and its tail K rows to the +1 neighbour, all arrays in
    one message each way (bfloat16 duals widened to float32 in the
    message; narrowed back exactly, since they come off the bfloat16
    grid). Under gloo the host rows are the message's pieces; under NCCL
    they are staged through a device buffer. Every buffer is reserved
    (:meth:`reserve`) before the run's first collective. The group's
    collectives (the sums, the votes, ``together``) span all P·W ranks."""

    def __init__(self, comm: MeshComm, grows, k: int, device):
        self.comm = comm
        self.pid, self.nproc = comm.rank, comm.world
        #: the process-rows, between which the bands go
        self.rows = comm.size(0)
        self.g0, self.g1, self.n0 = (int(v) for v in grows)
        self.k = k
        self.tg = k if self.g0 > 0 else 0
        self.bg = k if self.g1 < self.n0 else 0
        self.m = self.g1 - self.g0
        self.device = device
        self.staged = comm.backend == "nccl"

    def sums(self, values) -> List[float]:
        """Every process's ``values`` added up in rank order, in float64:
        the same bits on every process."""
        parts = self.comm.gather_values(values)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return [float(v) for v in total]

    def _pieces(self, arrays, name):
        """The tails (to the +1 neighbour) and heads (to the -1 neighbour)
        of ``arrays``, as the message's pieces."""
        k, tg, m = self.k, self.tg, self.m
        if not self.staged:
            return ([x[tg + m - k:tg + m] for x in arrays],
                    [x[tg:tg + k] for x in arrays])
        rest = tuple(arrays[0].shape[1:])
        stage = self.comm.buffer(f"{name}_stage", (len(arrays), 2 * k) + rest,
                                 torch.float32, self.device)
        for j, x in enumerate(arrays):
            stage[j, :k].copy_(x[tg:tg + k].float())
            stage[j, k:].copy_(x[tg + m - k:tg + m].float())
        return [stage[j, k:] for j in range(len(arrays))], \
            [stage[j, :k] for j in range(len(arrays))]

    def exchange(self, arrays, name) -> None:
        """Refresh the ghost rows of the host ``arrays`` from the
        neighbours' bands (their rows next to this process's)."""
        if self.rows == 1:
            return
        to_next, to_prev = self._pieces(arrays, name)
        from_prev, from_next = self.comm.exchange_pieces(
            0, to_next, to_prev, name=name)
        tg, m = self.tg, self.m
        for got, rows in ((from_prev, slice(0, tg)),
                          (from_next, slice(tg + m, tg + m + self.bg))):
            if got is None:
                continue
            for x, g in zip(arrays, got):
                x[rows].copy_(g.cpu() if self.staged else g)

    def reserve(self, rest, dtypes) -> None:
        """Allocate the buffers of both exchanges (orig once; recon, the
        accumulators and the shadow duals, of ``dtypes``, each sweep),
        then seal the pool."""
        if self.rows == 1:
            return
        shape = (self.tg + self.m + self.bg,) + tuple(rest)

        def like(dtype):
            # the shape and dtype of a host array, with no memory behind it
            return torch.zeros((), dtype=dtype).expand(shape)

        with self.comm.reserving():
            for name, arrays in (
                    ("ooc_orig", [like(torch.float32)]),
                    ("ooc_state", [like(dt) for dt in dtypes])):
                self.comm.exchange_pieces(0, *self._pieces(arrays, name),
                                          name=name)
        self.comm.sealed = True

    def _agree(self, read, what):
        """``read()`` (a state, None, or a ``ValueError`` raised) on every
        process, then one vote: any refusal is every process's
        ``ValueError``; where every process read a state of one
        iteration, the state; where some read one and others none or
        another iteration, every process warns and gets None."""
        def step():
            try:
                return read(), None
            except ValueError as e:
                return None, e

        st, err = self.comm.together(
            step, f"could not read its out-of-core checkpoint {what}",
            ValueError)
        votes = self.comm.gather_values([
            2 if err is not None else (1 if st is not None else 0),
            int(st["i"]) if st is not None else -1])
        if int(votes[:, 0].max()) == 2:
            raise ValueError(
                "multihost out-of-core resume rejected on at least one "
                "process: " + (str(err) if err is not None
                               else "a peer's checkpoint meta does not "
                                    "match this run"))
        if int(votes[:, 0].min()) == 1 \
                and votes[:, 1].min() == votes[:, 1].max():
            return st
        if int(votes[:, 0].max()) == 1:
            warnings.warn(
                "multihost out-of-core checkpoint parts disagree or are "
                "incomplete — discarding and restarting fresh",
                stacklevel=5)
        return None

    def resume(self, path, resume, meta, shape, fallback=None):
        """This process's part, read and agreed on by every process: a
        part that cannot be read fails every process; a meta mismatch on
        any process is every process's ``ValueError``; parts of different
        generations (or some missing) make every process warn and start
        afresh. Where no process has a part, ``fallback()`` (each
        process's cut of a one-file checkpoint, or None) is agreed on the
        same way. Returns the state, or None."""
        def part():
            return _ckpt_resume(path, resume, meta, shape)

        if fallback is None or self.comm.allmax(
                int(resume and os.path.exists(path))):
            return self._agree(part, "part")
        return self._agree(fallback, "file")


class _Cols:
    """One rank's side of a slab split over several cards: its column
    block ``[c0, c1)`` of the ``n1`` columns of every slab, and a
    ``MeshComm`` over the W ranks of its process-row r on the grid
    ``(1, W, 1, ...)`` (``ranks=``: the group's ranks r·W to r·W + W - 1).
    Through it each resident slab's pairs take their axis-1 bands
    (``engine._pair_bands``, the pair kernel's ``HALO1`` launch) and its
    K=1 launches their operand halos (``engine._k1_halos``, the ``HALO``
    launch, where the unsplit axis 0 gets the Jia-Zhao edge values: the
    slab's own edges, as in one process). Its pool holds every buffer of
    those exchanges, reserved for each extended-slab shape before the
    run's first exchange and sealed; ``pairs`` goes off at the memory
    ladder's rung (:meth:`prepare`)."""

    def __init__(self, group, w: int, r: int, c: int, n1: int, ndim: int):
        width = n1 // w
        self.w, self.n1 = w, n1
        self.c0, self.c1 = c * width, (c + 1) * width
        self.comm = MeshComm(group, (1, w) + (1,) * (ndim - 2), c,
                             ranks=[r * w + j for j in range(w)])
        self.pairs = True

    def reserve(self, opts: SolverOptions, views, pairs: bool) -> None:
        """Allocate, without communicating, every pool buffer the launches
        on the slabs ``views`` (one ``(orig, recon, accs, ds)`` of each
        extended-slab shape) take, for each phase's shadow duals (those of
        the FISTA phase, none in the unaccelerated one), then seal the
        pool."""
        n_f, n_u = opts.iterations_fista, opts.iterations_unacc
        with self.comm.reserving():
            for o, r, accs, ds in views:
                for d in ([ds] if n_f else []) + ([None] if n_u else []):
                    _k1_halos(self.comm, opts, r, accs, d)
                    if pairs:
                        _pair_bands(self.comm, o, 1)(r, accs, d)
        self.comm.sealed = True

    def prepare(self, alloc, comm: MeshComm):
        """``alloc(pairs)`` on every rank, with the memory ladder's rung
        of ``parallel/sharded.py::run_sharded``: one collective of the
        whole group (``comm``) says whether any rank ran out of device
        memory; then every rank frees what it holds and, once, warns and
        retries with the pairs off (K=1 ``HALO`` launches only, which hold
        no pair bands), or raises where they were off already. It comes
        before the run's first exchange."""
        pairs = True
        while True:
            def attempt():
                try:
                    return alloc(pairs), None
                except torch.OutOfMemoryError as e:
                    return None, f"{type(e).__name__}: {e}"

            got, oom = comm.together(attempt, "could not allocate its "
                                     "slab buffers", RuntimeError)
            if not comm.allmax(int(oom is not None)):
                self.pairs = pairs
                return got
            got = None  # this rank's attempt, freed before the retry
            self.comm.release()
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            if not pairs:
                raise torch.OutOfMemoryError(
                    oom or f"rank {comm.rank}: another rank ran out of "
                           f"device memory allocating its slab buffers")
            warnings.warn(
                f"device memory exhausted on a rank of the out-of-core "
                f"run while allocating its slab buffers "
                f"({oom or 'on another rank'}); all ranks retry with "
                f"temporal_pairs=False (K=1 launches only, which hold less "
                f"device memory — results are identical, throughput "
                f"lower)", stacklevel=4)
            pairs = False

    def one_file(self, path, resume, opts, mode, procs, shape):
        """The resume that finds no part: this rank's block cut from a
        one-file checkpoint of the whole cube at ``path`` (the JAX
        package's ``solve_outofcore_sharded_temporal`` writes one, mode
        ``sharded_temporal{K}``), or None. Each rank reads only its
        block's bytes of the file."""
        from cytvdn_tpu_torch.utils.checkpoint import (
            _meta_check,
            load_state_block,
        )

        whole = (procs.n0, self.n1) + tuple(shape[2:])
        meta = _ckpt_meta(opts, whole,
                          "sharded_temporal" + mode.rsplit("temporal", 1)[1])

        def read():
            if not (resume and os.path.exists(path)):
                return None
            return load_state_block(
                path, (slice(procs.g0, procs.g1), slice(self.c0, self.c1)),
                check=_meta_check(meta, whole))

        return read


def _default_group(group, name: str):
    if group is not None:
        return group
    if not dist.is_initialized():
        raise ValueError(f"{name} needs a process group: call "
                         f"init_distributed() first, or pass group=")
    return dist.group.WORLD


def _column_block(a: Optional[np.ndarray], c0: int, c1: int, given: bool):
    """A full-width array's column block (a contiguous copy), or ``a``
    itself where the caller gave the block."""
    if a is None or given:
        return a
    return np.ascontiguousarray(a[:, c0:c1])


def solve_outofcore_multihost(
    orig_local: np.ndarray,
    lambda_inv: np.ndarray,
    lam_mu: np.ndarray,
    opts: SolverOptions,
    n_slabs: int,
    temporal_k: int,
    global_rows: Tuple[int, int, int],
    shard_w: int = 0,
    devices=None,
    reference_local: Optional[np.ndarray] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    *,
    device=None,
    group=None,
    global_cols: Optional[Tuple[int, int, int]] = None,
) -> Dict[str, np.ndarray]:
    """Multi-process out-of-core solve: each process of ``group`` (default:
    the group of ``init_distributed``) runs its own axis-0 row range of the
    host-resident state on its own card, all with the same arguments but
    their rows (the reference's MPI ranks owning row ranges, mpi.py:130-153).

    ``orig_local`` holds only this process's rows; ``global_rows = (g0,
    g1, n0)`` gives them and the cube's axis-0 extent (the ranges must tile
    ``[0, n0)`` in process order: :func:`process_row_range` gives balanced
    ones). Each process keeps K ghost rows on each interior edge, refreshed
    at the start of every sweep by one exchange of the K-row pre-sweep bands
    of every state array with its axis-0 neighbours (a TV iteration reads
    only iteration-t state, so this is the in-core run's Jacobi order), and
    sweeps its own slabs with K-row margins through the temporal-mode
    pipeline of :func:`solve_outofcore_temporal`; ghost rows are never
    written back. ``temporal_k`` ≤ 1 runs one iteration per sweep with
    1-row margins (one K=1 launch per slab), bitwise as stream mode is.
    The sums (and with ``reference_local``, this process's rows of the
    reference cube, the SSE) are added across the processes in rank order,
    so every process records the same traces at the sweep-final entries
    (zeros between) and takes the same stop decision. ``opts.lossy_duals``:
    bfloat16 shadow duals on the host and in the slabs.

    ``shard_w`` of 0 takes W = ``len(devices)`` as the JAX package does,
    and W = 1 without ``devices``. W = 1 is one card per process:
    ``device``, or the one device of ``devices``, else the rank's card.
    ``shard_w`` = W > 1 splits
    every slab over W processes, one card each (the JAX package's local
    devices): the group's P·W ranks form a (P, W) grid in row-major order,
    the W ranks of process-row r (ranks r·W to r·W + W - 1) all hold its
    rows, ``orig_local`` at full width, and rank r·W + c keeps only
    column block c of N1/W columns (N1/W ≥ 2), or, with the port-only
    ``global_cols = (c0, c1, n1)``, ``orig_local`` (and
    ``reference_local``) is that block alone; rank c of a row takes
    ``devices[c]`` where ``devices`` holds W devices. The band exchange
    then goes between the ranks of a column, and each slab's launches take
    their axis-1 bands and halos from the row's other ranks (``HALO1``
    pairs, ``HALO`` K=1 launches).

    Checkpoints: each process saves its own part,
    ``checkpoint_path.ooc<p>``, in the JAX package's format (with the
    column split its meta's ``gcols`` gives the block, and the mode is
    ``sharded_temporal{K}`` where P = 1), and the processes agree on a
    resume in one collective; parts of different generations make every
    process warn and start afresh. With the column split, where no process
    finds a part, each cuts its block from a one-file ``sharded_temporal{K}``
    checkpoint at ``checkpoint_path`` (the JAX package's
    :func:`solve_outofcore_sharded_temporal` writes one).

    Every refusal and every failure of one process (a range that does not
    tile, a wrong row count, an axis 1 that does not split, a margin deeper
    than a slab, a part that cannot be read or saved) raises on every
    process. Returns this process's ``recon`` rows (its block), the traces,
    ``iterations_run``, ``early_stopped``, ``global_rows``, ``exchange``
    (the band exchange's ``MeshComm`` statistics), ``resumed_from`` (the
    iteration of the checkpoint it resumed from, or None) [and ``mse``];
    with the column split also ``global_cols``, ``slices`` (the block's
    place in the cube) and ``column_exchange`` (the slab mesh's
    statistics).
    """
    if opts.bc_mode != BCMode.JIA_ZHAO or opts.isotropic_R \
            or opts.isotropic_Q:
        raise ValueError("out-of-core mode covers Jia-Zhao anisotropic runs")
    group = _default_group(group, "solve_outofcore_multihost")
    w = int(shard_w)
    if w <= 0:
        # as the JAX package: one column block per device given
        w = len(devices) if devices is not None else 1
    w = max(w, 1)
    return _solve_grid(orig_local, lambda_inv, lam_mu, opts, n_slabs,
                       max(int(temporal_k), 1), global_rows, w, devices,
                       reference_local, checkpoint_path, checkpoint_every,
                       resume, device, group, global_cols, sharded=False)


def _solve_grid(orig_local, lambda_inv, lam_mu, opts, n_slabs, K,
                global_rows, w, devices, reference_local, checkpoint_path,
                checkpoint_every, resume, device, group, global_cols,
                sharded: bool):
    """The run of :func:`solve_outofcore_multihost` and
    :func:`solve_outofcore_sharded_temporal` on a (P, W) grid of the
    group's ranks: validation in one collective, then the temporal
    pipeline with the band exchange (P > 1) and the column split
    (W > 1)."""
    from cytvdn_tpu_torch.parallel.api import _rank_device

    size, rank = group.size(), group.rank()
    if size % w:
        raise ValueError(f"a group of {size} processes does not form "
                         f"process-rows of shard_w={w} (one card each)")
    if devices is not None and len(devices) not in (1, w):
        raise ValueError(f"devices holds {len(devices)} devices; a slab split "
                         f"over shard_w={w} processes takes one per process "
                         f"(rank c of a process-row takes devices[c]) or one")
    p_rows = size // w
    r, c = divmod(rank, w)
    if devices is not None and device is None:
        device = devices[c if len(devices) == w else 0]
    device = _rank_device(device)
    ndim = opts.ndim
    comm = MeshComm(group, (p_rows, w) + (1,) * (ndim - 2), rank)
    orig_local = np.ascontiguousarray(orig_local)
    given = global_cols is not None
    n1 = int(global_cols[2]) if given else int(orig_local.shape[1])
    width = n1 // w
    c0, c1 = c * width, (c + 1) * width
    block_ok = not given or (
        (int(global_cols[0]), int(global_cols[1])) == (c0, c1)
        and orig_local.shape[1] == c1 - c0)
    cols_ok = n1 % w == 0 and (w == 1 or width >= 2) and block_ok
    procs = _Procs(comm, global_rows, K, device)
    m = procs.m
    rest = (c1 - c0,) + tuple(orig_local.shape[2:])
    bounds = _slab_bounds(m, n_slabs)
    min_core = min(b - a for a, b in bounds)
    ok = (orig_local.dtype == np.float32 and orig_local.shape[0] == m
          and K <= min_core and K <= m and cols_ok)
    # this process's refusal or failure that only it can see: it rides the
    # validation collective, so that every process raises
    local_err = None
    ext, cols = [], None
    if ok:
        try:
            ext = _extents(bounds, K, procs.tg, procs.tg + m + procs.bg)
            _check_extents(ext, rest, opts)
            d_dt = d_dtype(opts, torch.float32)
            procs.reserve(rest, [torch.float32] * (1 + ndim)
                          + ([d_dt] * ndim if opts.iterations_fista else []))
            if w > 1:
                cols = _Cols(group, w, r, c, n1, ndim)
        except Exception as e:
            local_err = e
    votes = comm.gather_values([procs.g0, procs.g1, orig_local.shape[0],
                                orig_local.dtype == np.float32,
                                local_err is not None, n1, block_ok])
    g = votes.astype(np.int64)
    if not g[:, 3].all():
        raise ValueError("out-of-core mode requires float32 data")
    for q in range(procs.nproc):
        if g[q, 2] != g[q, 1] - g[q, 0]:
            raise ValueError(f"orig_local has {g[q, 2]} rows; global_rows "
                             f"declares {g[q, 1] - g[q, 0]}")
    # the process-rows' ranges, from the first rank of each; every rank of
    # a row declares its range
    ranges = g[::w, :2].tolist()
    for q in range(procs.nproc):
        if g[q, :2].tolist() != ranges[q // w]:
            raise ValueError(
                f"process {q} declares rows {g[q, :2].tolist()}, the first "
                f"process of its process-row {ranges[q // w]}: the "
                f"shard_w={w} processes of a row hold the same rows")
    expect = 0
    for q in range(p_rows):
        if ranges[q][0] != expect:
            raise ValueError(f"process ranges {ranges} do not tile "
                             f"[0, {procs.n0}) in process order")
        expect = ranges[q][1]
    if expect != procs.n0:
        raise ValueError(f"process ranges {ranges} do not cover "
                         f"[0, {procs.n0})")
    for q in range(procs.nproc):
        nq = int(g[q, 5])
        if nq % w:
            raise ValueError(f"axis-1 extent {nq} not divisible by {w} "
                             f"devices")
        if w > 1 and nq // w < 2:
            raise ValueError(f"axis-1 extent {nq} over {w} devices leaves "
                             f"{nq // w} column per device; the pair "
                             f"kernel's axis-1 bands need 2")
        if not g[q, 6]:
            raise ValueError(f"process {q}'s global_cols is not column "
                             f"block {q % w} of {nq // w} columns of its "
                             f"orig_local")
    for q in range(p_rows):
        mq = ranges[q][1] - ranges[q][0]
        core_q = min(b - a for a, b in _slab_bounds(mq, n_slabs))
        if K > core_q or K > mq:
            raise ValueError(
                f"temporal_k={K} exceeds the smallest local slab core "
                f"({core_q} rows of {mq}); use fewer slabs or a smaller "
                f"temporal_k")
    failed = np.flatnonzero(g[:, 4]).tolist()
    if failed:
        if local_err is not None:
            raise local_err
        raise RuntimeError(f"processes {failed} could not prepare their "
                           f"out-of-core run (see their errors)")
    mode = "sharded" if p_rows == 1 and (w > 1 or sharded) else "multihost"
    return _run_temporal(
        _column_block(orig_local, c0, c1, given or w == 1), lambda_inv,
        lam_mu, opts, ext, K,
        _column_block(reference_local, c0, c1, given or w == 1),
        checkpoint_path, checkpoint_every, resume, f"{mode}_temporal{K}",
        device, procs, cols)


def solve_outofcore_sharded_temporal(
    orig: np.ndarray,
    lambda_inv: np.ndarray,
    lam_mu: np.ndarray,
    opts: SolverOptions,
    n_slabs: int,
    temporal_k: int,
    shard_w: int = 0,
    devices=None,
    reference: Optional[np.ndarray] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    *,
    device=None,
    group=None,
) -> Dict[str, np.ndarray]:
    """Out-of-core solve with each resident slab split over several cards
    on axis 1: the BASELINE config-5 deployment shape (512²×256², ~640 GiB
    of FISTA state, fits no set of cards, so the host streams slabs while
    its cards split each slab), as ``cytvdn_tpu``'s
    ``solve_outofcore_sharded_temporal``.

    The JAX package drives the local devices of one process; here each
    card is a process of ``group`` (default: the group of
    ``init_distributed``), and every one calls this with the same
    arguments and the same whole ``orig``. ``shard_w`` is the group's size
    (0: take it). Rank c keeps only column block c of the host state
    (N1/W columns, N1/W ≥ 2) on ``devices[c]`` where ``devices`` holds W
    devices (one device: that one; none: ``device``, else the rank's
    card), sweeps the axis-0 slabs with ``temporal_k``-row margins as
    :func:`solve_outofcore_temporal` does, and advances its columns of
    each slab in ``HALO1`` pairs and ``HALO`` K=1 launches with the other
    ranks' axis-1 bands (the P = 1 case of
    ``solve_outofcore_multihost(shard_w=W)``). Traces, the stop and the
    MSE are those of the temporal mode, the same on every rank; where a
    rank runs out of device memory allocating its slabs, every rank warns
    and runs K=1 launches only. Checkpoints are parts, one per rank
    (``checkpoint_path.ooc<rank>``, mode ``sharded_temporal{K}``); a
    resume that finds none cuts every rank's block from a one-file
    checkpoint of the JAX function at ``checkpoint_path``.

    Returns on every rank the traces, ``iterations_run``,
    ``early_stopped`` [, ``mse``], this rank's ``block`` and its
    ``slices`` in the cube, and ``recon``: the stitched cube on rank 0,
    None on the others, and None on every rank above
    ``io/emd.py::gathers``' size (``gathered`` says which); the stitched
    recon is bitwise the in-core run.
    """
    from cytvdn_tpu_torch.io.emd import gathers

    if opts.bc_mode != BCMode.JIA_ZHAO or opts.isotropic_R \
            or opts.isotropic_Q:
        raise ValueError("out-of-core mode covers Jia-Zhao anisotropic runs")
    orig = np.ascontiguousarray(orig)
    if orig.dtype != np.float32:
        raise ValueError("out-of-core mode requires float32 data")
    group = _default_group(group, "solve_outofcore_sharded_temporal")
    size = group.size()
    w = size if shard_w <= 0 else int(shard_w)
    if w != size:
        raise ValueError(f"shard_w={w}: each process of the group holds one "
                         f"column block of every slab, so shard_w is the "
                         f"group's size, {size} (or 0)")
    if orig.shape[1] % w:
        raise ValueError(f"axis-1 extent {orig.shape[1]} not divisible by "
                         f"{w} devices")
    n0 = orig.shape[0]
    K = max(int(temporal_k), 1)
    min_core = min(b - a for a, b in _slab_bounds(n0, n_slabs))
    if K > min_core:
        raise ValueError(
            f"temporal_k={K} exceeds the smallest slab core ({min_core} "
            f"rows); use fewer slabs or a smaller temporal_k")
    out = _solve_grid(orig, lambda_inv, lam_mu, opts, n_slabs, K,
                      (0, n0, n0), w, devices, reference, checkpoint_path,
                      checkpoint_every, resume, device, group, None,
                      sharded=True)
    block = out.pop("recon")
    slices = out.get("slices") or tuple(slice(0, e) for e in orig.shape)
    out.update(block=block, slices=slices,
               gathered=gathers(orig.shape, np.float32))
    out["recon"] = None
    if out["gathered"]:
        comm = MeshComm(group, (1, w) + (1,) * (orig.ndim - 2), group.rank())
        t = torch.from_numpy(block)
        if comm.backend == "nccl":
            # NCCL moves tensors on the card only
            t = t.cuda()
        out["recon"] = comm.gather_blocks(t, orig.shape, slices)
    return out


def denoise_outofcore(
    datacube: np.ndarray,
    mu,
    lam=None,
    iterations=10,
    FISTA: bool = True,
    stopping_relative_change: Optional[float] = None,
    n_slabs: int = 4,
    quiet: bool = True,
    temporal_k: int = 1,
    shard_w: int = 1,
    devices=None,
    reference_data: Optional[np.ndarray] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    lossy_duals: bool = False,
    *,
    device="cuda",
    group=None,
):
    """User-level out-of-core denoising (float32, Jia-Zhao, anisotropic)
    with ``cytvdn_tpu.solver.outofcore.denoise_outofcore``'s keywords, on
    ``device``.

    ``temporal_k > 1`` runs K iterations per slab residency
    (:func:`solve_outofcore_temporal`), cutting host↔device traffic per
    iteration K-fold. ``lossy_duals`` stores the shadow duals as bfloat16
    on the host and the card, in either mode.
    ``shard_w != 1`` or ``devices`` splits every slab over the cards of
    the processes of ``group`` (the port-only keyword; default: the group
    of ``init_distributed``), one card each, every process calling this
    with the same arguments: :func:`solve_outofcore_sharded_temporal`,
    with K = ``max(temporal_k, 1)`` as in the JAX package; ``recon`` is
    then the stitched cube on rank 0 and None on the others. Several
    processes, each its own rows on one card, run
    :func:`solve_outofcore_multihost`, as in the JAX package.

    Returns ``(recon, b_norm, delta)`` like ``denoise3D/4D``, plus the
    ``mse`` trace when ``reference_data`` is given (per iteration in the
    streaming mode; at sweep ends under temporal blocking, like the
    traces).
    """
    ndim = np.asarray(datacube).ndim
    datacube, mu, lam, lambda_inv, lam_mu = _validate_and_derive(
        datacube, mu, lam, ndim, 32.0 if ndim == 4 else 16.0
    )
    if not quiet:
        # the shadow duals count half under lossy duals
        n_state = 2 + ndim + (ndim / (2 if lossy_duals else 1) if FISTA
                              else 0)
        per_slab = datacube.nbytes * n_state / n_slabs / 2**30
        print(f"out-of-core: {n_slabs} slabs, ~{per_slab:.2f} GiB of device "
              f"memory per slab, {GENERATIONS} slabs on the device at once "
              f"(host holds the full "
              f"{datacube.nbytes * n_state / 2**30:.1f} GiB state)")
    n_f, n_u = normalize_iterations(iterations, FISTA)
    with_mse = reference_data is not None
    if with_mse:
        reference_data = np.ascontiguousarray(reference_data,
                                              dtype=np.float32)
        if reference_data.shape != datacube.shape:
            raise ValueError("reference_data shape mismatch")
    opts = SolverOptions(
        ndim=ndim,
        iterations_fista=n_f,
        iterations_unacc=n_u,
        stopping_relative_change=stopping_relative_change,
        calculate_mse=with_mse,
        lossy_duals=lossy_duals,
    )
    ck = dict(checkpoint_path=checkpoint_path,
              checkpoint_every=checkpoint_every, resume=resume, device=device)
    if shard_w != 1 or devices is not None:
        if devices is not None:
            ck["device"] = None
        out = solve_outofcore_sharded_temporal(
            datacube, lambda_inv, lam_mu, opts, n_slabs,
            max(temporal_k, 1), shard_w=shard_w, devices=devices,
            reference=reference_data, group=group, **ck)
    elif temporal_k > 1:
        out = solve_outofcore_temporal(datacube, lambda_inv, lam_mu, opts,
                                       n_slabs, temporal_k,
                                       reference=reference_data, **ck)
    else:
        out = solve_outofcore(datacube, lambda_inv, lam_mu, opts, n_slabs,
                              reference=reference_data, **ck)
    if with_mse:
        return out["recon"], out["b_norm"], out["delta"], out["mse"]
    return out["recon"], out["b_norm"], out["delta"]
