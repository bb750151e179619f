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

Not here (ROADMAP.md Queue 1 item 11): slabs sharded over several devices
(``shard_w``), multi-process runs and their band exchange; bfloat16 shadow
duals (``lossy_duals``, item 12).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cytvdn_tpu_torch.api import _validate_and_derive
from cytvdn_tpu_torch.config import (
    BCMode,
    SolverOptions,
    _not_ported,
    normalize_iterations,
)
from cytvdn_tpu_torch.kernels import build
from cytvdn_tpu_torch.kernels.fused import fused_iteration, fused_supported
from cytvdn_tpu_torch.kernels.temporal import fused_pair_iteration, pair_supported
from cytvdn_tpu_torch.solver.engine import fista_tk_ratios

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
    from cytvdn_tpu_torch.utils.checkpoint import checkpoint_exists, load_state

    if not (resume and checkpoint_exists(path)):
        return None
    state, ck_meta = load_state(path)
    if ck_meta["shape"] != list(shape):
        raise ValueError(
            f"checkpoint shape {ck_meta['shape']} does not match input "
            f"{list(shape)}")
    for k, v in meta.items():
        if k != "shape" and ck_meta.get(k, v) != v:
            raise ValueError(
                f"checkpoint {k}={ck_meta.get(k)!r} does not match the "
                f"requested run's {k}={v!r}")
    return state


def _restore_state(st, recon, accs, ds, b_norm, delta, mse):
    """Restore a loaded checkpoint into the run's host arrays in place.
    Returns ``(start, resumed_stop)``."""
    recon[...] = np.asarray(st["recon"], np.float32)
    for k, a in enumerate(accs):
        a[...] = np.asarray(st["accs"][k], np.float32)
    for k, d in enumerate(ds):
        d[...] = np.asarray(st["ds"][k], np.float32)
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
    if _POST_CKPT_HOOK is not None:
        _POST_CKPT_HOOK(it_run)


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
    (FISTA) the shadow duals, as tensors over numpy arrays. On a CUDA run
    the arrays are page-locked, each exactly sized
    (``kernels/build.py::host_empty``): PyTorch's pinned allocator
    (``pin_memory=True``) rounds each allocation up to a power of two and
    keeps it locked in its cache after the run, and locking ordinary pages
    in place (``cudaHostRegister``) took 2.5-3 times as long."""

    def __init__(self, orig: np.ndarray, ndim: int, fista: bool,
                 device: torch.device):
        self.cuda = device.type == "cuda"
        t0 = time.perf_counter()

        def empty():
            if self.cuda:
                return torch.from_numpy(build.host_empty(orig.shape))
            return torch.empty(orig.shape, dtype=torch.float32)

        self.orig = empty()
        self.orig.numpy()[...] = orig
        self.recon = empty()
        self.recon.numpy()[...] = orig
        self.accs = [empty().zero_() for _ in range(ndim)]
        self.ds = [empty().zero_() for _ in range(ndim)] if fista else []
        n = 2 + len(self.accs) + len(self.ds)
        last_run["pinned_bytes"] = float(orig.nbytes * n) if self.cuda else 0.0
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
    orig, recon, the accumulators [, the shadow duals], and per generation
    the seam operands of a stream-mode launch. A slab of fewer rows uses
    the leading rows (contiguous views)."""

    def __init__(self, rows: int, tail: Tuple[int, ...], ndim: int,
                 fista: bool, device: torch.device, halos: bool):
        n_arrays = 2 + ndim * (2 if fista else 1)

        def empty(r, *t):
            return torch.empty((r, *t), dtype=torch.float32, device=device)

        self.gens = []
        for _ in range(GENERATIONS):
            g = {"arrays": [empty(rows, *tail) for _ in range(n_arrays)]}
            if halos:
                col = (1,) + tail[1:]
                g["prev0"], g["next0_recon"], g["next0_acc"], g["next0_d"] = (
                    empty(1, *tail) for _ in range(4))
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
        last_run[f"{kind}_bytes"] += float(sum(s.numel() * 4 for _, s in pairs))
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
    """What both modes share: a run's host state, traces, checkpoint and
    copy pipe, and :meth:`solve`, which drives the schedule through
    pipelined sweeps built from each mode's slab steps."""

    def __init__(self, orig, opts, reference, checkpoint_path,
                 checkpoint_every, resume, mode: str, device):
        n_total = opts.total_iterations
        self.opts, self.reference = opts, reference
        self.host = host = _HostState(orig, opts.ndim, opts.fista, device)
        self.pipe = _Pipe(device)
        self.b_norm = np.zeros(n_total, np.float32)
        self.delta = np.zeros(n_total, np.float32)
        with_mse = opts.calculate_mse and reference is not None
        self.mse = np.zeros(n_total + 1, np.float32) if with_mse else None
        if with_mse:
            self.mse[0] = _host_sse(orig, reference)
        meta = _ckpt_meta(opts, orig.shape, mode) if checkpoint_path else None
        self.start, self.resumed_stop = 0, False
        if checkpoint_path:
            try:
                st = _ckpt_resume(checkpoint_path, resume, meta, orig.shape)
            except BaseException:
                host.close()
                raise
            if st is not None:
                self.start, self.resumed_stop = _restore_state(
                    st, host.recon.numpy(), [a.numpy() for a in host.accs],
                    [d.numpy() for d in host.ds], self.b_norm, self.delta,
                    self.mse)
        self.save = self._saver(checkpoint_path, checkpoint_every, meta)
        last_run["sweeps"] = 0.0
        last_run["sweep_seconds"] = 0.0

    def _saver(self, checkpoint_path, every, meta):
        """``save(it_run, done, stopped)``: a save at the first sweep end at
        or past each multiple of ``every`` (every multiple, in stream
        mode), and the terminal save; only the terminal save may record a
        stop."""
        if not checkpoint_path:
            return lambda it_run, done, stopped: None
        host = self.host
        nxt = (self.start // every + 1) * every if every > 0 else None

        def save(it_run, done, stopped):
            nonlocal nxt
            due = nxt is not None and it_run >= nxt and not done
            if done or due:
                _ckpt_save(checkpoint_path, meta, it_run, host.recon.numpy(),
                           [a.numpy() for a in host.accs],
                           [d.numpy() for d in host.ds], self.b_norm,
                           self.delta, self.mse, done and stopped)
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
        against the reference."""
        pipe = self.pipe

        def sweep(fista, t, count):
            t0 = time.perf_counter()
            sums = []
            ready = load(0, fista)
            for si in range(n):
                pipe.compute_after(ready)
                sums.append(compute(si, fista, t, count))
                done = pipe.computed()
                if si + 1 < n:
                    ready = load(si + 1, fista)
                store(si, fista, done)
            pipe.drain()
            bn = dn = dd = 0.0
            for s in torch.stack(sums).cpu().tolist():
                bn += s[0]
                dn += s[1]
                dd += s[2]
            last_run["sweeps"] += 1
            last_run["sweep_seconds"] += time.perf_counter() - t0
            # all-zero input: the in-core 0/0 -> NaN instead of raising
            return (bn, dn / dd if dd else float("nan"),
                    sse() if self.mse is not None else 0.0)

        try:
            it_run, stopped = _run_schedule(
                self.opts, self.start, self.resumed_stop, sweep,
                self._record, self.save, k_max)
        finally:
            self.host.close()
        out = {
            "recon": self.host.recon.numpy(),
            "b_norm": self.b_norm,
            "delta": self.delta,
            "iterations_run": np.int32(it_run),
            "early_stopped": np.bool_(stopped),
        }
        if self.mse is not None:
            out["mse"] = self.mse
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
                   opts.iterations_fista > 0, device, halos=True)
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
                pairs.append((g["next0_d"], H_d0[a1:a1 + 1]))
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
    """
    if temporal_k <= 1:
        return solve_outofcore(orig, lambda_inv, lam_mu, opts, n_slabs,
                               reference=reference,
                               checkpoint_path=checkpoint_path,
                               checkpoint_every=checkpoint_every,
                               resume=resume, device=device)
    orig = _check_options(opts, orig)
    device = torch.device(device)
    ndim, n0, tail = opts.ndim, orig.shape[0], orig.shape[1:]
    K = int(temporal_k)
    bounds = _slab_bounds(n0, n_slabs)
    min_core = min(b - a for a, b in bounds)
    if K > min_core:
        # a margin deeper than one neighbour slab would read rows whose
        # results were already written back
        raise ValueError(
            f"temporal_k={K} exceeds the smallest slab core ({min_core} "
            f"rows); use fewer slabs or a smaller temporal_k")
    ext = [(max(a - K, 0), min(b + K, n0), a, b) for a, b in bounds]
    for lo, hi, _, _ in ext:
        if hi - lo < 2 or not fused_supported((hi - lo,) + tail,
                                              torch.float32, opts.bc_mode):
            raise ValueError(f"extended slab shape {(hi - lo,) + tail} "
                             "unsupported by the fused kernel")
    li, lm, rhos = _scalars(lambda_inv, lam_mu, opts.iterations_fista, device)
    rows = max(hi - lo for lo, hi, _, _ in ext)
    slabs = _Slabs(rows, tail, ndim, opts.iterations_fista > 0, device,
                   halos=False)
    # the K-1st recon of a chunk, for the last iteration's delta
    r_prev = torch.empty((rows,) + tail, dtype=torch.float32, device=device)
    run = _Run(orig, opts, reference, checkpoint_path, checkpoint_every,
               resume, f"temporal{K}", device)
    host = run.host

    def load(si, fista):
        """Slab ``si`` with its margins. Below a top margin the slab's
        first accumulator (and shadow dual) row along axis 0 is set to
        zero: the margin's first row is then a Jia-Zhao edge, whose b stays
        exactly zero, as the kernels' axis-0 wrap needs wherever the slab
        ends at the cube's last row; the change stays inside the
        discarded margin."""
        lo, hi, _, _ = ext[si]
        arrays = slabs.gens[si % GENERATIONS]["arrays"]
        pairs = [(dst[:hi - lo], src[lo:hi]) for dst, src in
                 zip(arrays, host.arrays(fista))]
        zero = [arrays[2][0]] + ([arrays[2 + ndim][0]] if fista else []) \
            if lo > 0 else []
        return run.pipe.copies("h2d", pairs, zero=zero)

    def compute(si, fista, t, count):
        """``count`` iterations on the resident extended slab: pairs for
        the bulk, the last one or two as K=1 launches; returns the core's
        (bnorm, delta numerator, delta denominator) after the last."""
        lo, hi, a0, a1 = ext[si]
        o, r, accs, ds = slabs.arrays(si, hi - lo, fista, ndim)

        def rho(j):
            return rhos[t + j] if fista else None

        n_pairs = max((count - 1) // 2, 0)
        if not pair_supported(tuple(o.shape), o.dtype, BCMode.JIA_ZHAO):
            n_pairs = 0
        for p in range(n_pairs):
            fused_pair_iteration(o, r, accs, ds, rho(2 * p), rho(2 * p + 1),
                                 li, lm, fista=fista)
        rp = r_prev[:hi - lo]
        for j in range(2 * n_pairs, count):
            if j == count - 1:
                rp.copy_(r)
            fused_iteration(o, r, accs, ds, rho(j), li, lm, fista=fista)
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
                     lambda: _host_sse(host.recon.numpy(), reference))


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
):
    """User-level out-of-core denoising (float32, Jia-Zhao, anisotropic)
    with ``cytvdn_tpu.solver.outofcore.denoise_outofcore``'s keywords, on
    ``device``.

    ``temporal_k > 1`` runs K iterations per slab residency
    (:func:`solve_outofcore_temporal`), cutting host↔device traffic per
    iteration K-fold. ``shard_w != 1``/``devices`` (slabs sharded over
    several cards) and ``lossy_duals`` are not ported and raise
    ``NotImplementedError``.

    Returns ``(recon, b_norm, delta)`` like ``denoise3D/4D``, plus the
    ``mse`` trace when ``reference_data`` is given (per iteration in the
    streaming mode; at sweep ends under temporal blocking, like the
    traces).
    """
    if shard_w != 1 or devices is not None:
        raise _not_ported("out-of-core slabs sharded over several devices "
                          "(shard_w, devices)", "Queue 1 item 11")
    if lossy_duals:
        raise _not_ported("lossy_duals", "Queue 1 item 12")
    ndim = np.asarray(datacube).ndim
    datacube, mu, lam, lambda_inv, lam_mu = _validate_and_derive(
        datacube, mu, lam, ndim, 32.0 if ndim == 4 else 16.0
    )
    if not quiet:
        n_state = 2 + 2 * ndim if FISTA else 2 + ndim
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
    )
    ck = dict(checkpoint_path=checkpoint_path,
              checkpoint_every=checkpoint_every, resume=resume, device=device)
    if temporal_k > 1:
        out = solve_outofcore_temporal(datacube, lambda_inv, lam_mu, opts,
                                       n_slabs, temporal_k,
                                       reference=reference_data, **ck)
    else:
        out = solve_outofcore(datacube, lambda_inv, lam_mu, opts, n_slabs,
                              reference=reference_data, **ck)
    if with_mse:
        return out["recon"], out["b_norm"], out["delta"], out["mse"]
    return out["recon"], out["b_norm"], out["delta"]
