"""Observability: phase timing, progress and profiler traces —
``cytvdn_tpu``'s ``utils/log.py`` on PyTorch.

The reference's profiling story is wall-clock ``time()`` deltas logged
around every phase of its MPI loop (reference cyTVDN/mpi.py:94, 126-128,
316-319, 373-392, 397-403, 424-438). :func:`timed` keeps that operator
experience; :func:`profile_trace` records a ``torch.profiler`` trace of
the host and the card, written as a Chrome trace (viewable in Perfetto or
``chrome://tracing``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def timed(label: str, verbose: bool = True, sink=print) -> Iterator[None]:
    """Wall-clock phase timing, reference-style log lines."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if verbose:
            sink(f"[cytv] {label} took {time.perf_counter() - t0:.3f} s")


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]) -> Iterator[None]:
    """Record a ``torch.profiler`` trace of the host and, where there is
    one, the CUDA device, into ``logdir/trace.json`` (no-op when ``logdir``
    is falsy)."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def progress_iter(iterable, desc: str, enable: bool = True):
    """tqdm progress when available (the reference wraps its loops in tqdm,
    reference cyTVDN.py:148, 196); silently plain otherwise."""
    if not enable:
        return iterable
    try:
        from tqdm import tqdm

        return tqdm(iterable, desc=desc)
    except Exception:
        return iterable


def make_progress(desc: str, sink=print):
    """Build a ``(done, total, delta) -> None`` callback for chunked solver
    runs: a live tqdm bar when available, reference-style log lines
    otherwise (reference cyTVDN.py:147-152 / mpi.py:298-305). Call the
    returned object's ``.close()`` when finished."""
    state = {"bar": None, "last": 0}
    try:
        from tqdm import tqdm
    except Exception:
        tqdm = None

    def cb(done: int, total: int, delta: float) -> None:
        if tqdm is not None:
            if state["bar"] is None:
                state["bar"] = tqdm(total=total, desc=desc, unit="it")
            state["bar"].update(done - state["last"])
            state["bar"].set_postfix(delta=f"{delta:.3e}", refresh=False)
        else:
            sink(f"[cytv] {desc}: iteration {done}/{total}, "
                 f"delta {delta:.3e}")
        state["last"] = done

    def close() -> None:
        if state["bar"] is not None:
            state["bar"].close()

    cb.close = close
    return cb
