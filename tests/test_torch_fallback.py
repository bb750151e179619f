"""The port's device-memory fallback ladder
(``cytvdn_tpu_torch.solver.engine.vmem_fallback``, wrapped around every
solve by ``cytvdn_tpu_torch.api._run``) against the JAX package's
(``cytvdn_tpu.solver.engine.vmem_fallback``), the memory note, the
progress default and ``utils/log.py``.

The device OOM is simulated: a kernel wrapper in the engine module raises
``torch.OutOfMemoryError``, as an allocation on the card does. The JAX
ladder is fed the same sequence of failing and passing attempts (as its
Mosaic error text) and must flip the same knobs in the same order. The
result after the ladder equals the one-iteration run bitwise (on the CPU
every kernel wrapper runs its plain version, the one-iteration loop's
iterations).
"""

import gc
import json
import re
import sys
import warnings
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import cytvdn_tpu.api as japi  # noqa: E402
from cytvdn_tpu.config import SolverOptions as JOptions  # noqa: E402
from cytvdn_tpu.solver import engine as jengine  # noqa: E402
from cytvdn_tpu.utils import log as jlog  # noqa: E402
import cytvdn_tpu_torch as ttv  # noqa: E402
from cytvdn_tpu_torch import api as tapi  # noqa: E402
from cytvdn_tpu_torch.config import SolverOptions as TOptions  # noqa: E402
from cytvdn_tpu_torch.solver import engine as tengine  # noqa: E402
from cytvdn_tpu_torch.utils import log as tlog  # noqa: E402

_JAX_OOM = ("XLA:TPU compile permanent error. Ran out of memory in memory "
            "space vmem. Used 200.00M of 128.00M vmem.")
KNOBS = ("vmem_resident", "temporal_kstep", "temporal_pairs")
WRAPPERS = ("resident_solve", "fused_kstep_iteration",
            "fused_pair_iteration", "fused_iteration")


def _cube(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 0.3 + 1.0).astype(np.float32)


def _rungs(records):
    """The knobs the ladder turned off, in order, from its warnings."""
    return [re.search(r"retrying with (\w+)=False", str(w.message)).group(1)
            for w in records
            if "device memory exhausted" in str(w.message)]


def _raise_in(monkeypatch, names, err_factory):
    def boom(*a, **k):
        raise err_factory()

    for name in names:
        monkeypatch.setattr(tengine, name, boom)


def _record_attempts(monkeypatch):
    """Wrap the API's ladder so that each attempt's knobs and outcome are
    recorded."""
    attempts = []
    real = tengine.vmem_fallback

    def recording(opts, call):
        def wrapped(o):
            knobs = tuple(getattr(o, k) for k in KNOBS)
            try:
                out = call(o)
            except torch.OutOfMemoryError:
                attempts.append((knobs, True))
                raise
            attempts.append((knobs, False))
            return out
        return real(opts, wrapped)

    monkeypatch.setattr(tapi, "vmem_fallback", recording)
    return attempts


def _jax_ladder(attempts, jopts):
    """The JAX ladder fed the port's sequence of failing attempts: returns
    the knobs of each of its attempts, its rungs and whether it raised."""
    seen = []
    script = iter(raised for _, raised in attempts)

    def call(o):
        seen.append(tuple(getattr(o, k) for k in KNOBS))
        if next(script):
            raise RuntimeError(_JAX_OOM)
        return "done"

    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        try:
            jengine.vmem_fallback(jopts, call)
            raised = False
        except RuntimeError:
            raised = True
    return seen, _rungs(rec), raised


# which wrappers raise -> the rungs the ladder must take
LADDER_CASES = [
    ((), []),
    (("resident_solve",), ["vmem_resident"]),
    (("resident_solve", "fused_kstep_iteration"),
     ["vmem_resident", "temporal_kstep"]),
    (("resident_solve", "fused_kstep_iteration", "fused_pair_iteration"),
     ["vmem_resident", "temporal_kstep", "temporal_pairs"]),
    (("fused_kstep_iteration",), []),
    (WRAPPERS, ["vmem_resident", "temporal_kstep", "temporal_pairs"]),
]


@pytest.mark.parametrize("progress", [False, True])
@pytest.mark.parametrize("raising,rungs", LADDER_CASES,
                         ids=["none", "resident", "resident+kstep",
                              "resident+kstep+pair", "kstep", "all"])
def test_ladder_matches_jax(monkeypatch, raising, rungs, progress):
    """``denoise3D`` (plain and ``progress=True``) with the named kernels
    exhausting device memory: the rungs come in the JAX order, each
    attempt with the JAX ladder's knobs, and the result equals the
    one-iteration run bitwise; with every kernel failing, the last
    ``OutOfMemoryError`` is raised, as JAX re-raises."""
    monkeypatch.setattr(tengine, "PAIR_MIN_ROW_BYTES", 0)
    cube = _cube((16, 6, 64), 3)
    mu = np.full(3, 1.0, np.float32)
    kw = dict(iterations=20, FISTA=True, quiet=True, device="cpu",
              progress=progress)
    want = ttv.denoise3D(cube, mu, **kw)  # before any kernel raises
    _raise_in(monkeypatch, raising, lambda: torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 36.00 GiB"))
    attempts = _record_attempts(monkeypatch)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        if "fused_iteration" in raising:
            with pytest.raises(torch.OutOfMemoryError):
                ttv.denoise3D(cube, mu, **kw)
            got = None
        else:
            got = ttv.denoise3D(cube, mu, **kw)
    assert _rungs(rec) == rungs
    seen, jrungs, jraised = _jax_ladder(
        attempts, JOptions(ndim=3, iterations_fista=20, iterations_unacc=0))
    assert jrungs == rungs and seen == [k for k, _ in attempts]
    assert jraised == (got is None)
    if got is not None:
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("err", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("CUDA out of memory (the text alone is not the type)"),
    ValueError("nvcc failed"),
], ids=["illegal-address", "oom-text", "build"])
def test_non_oom_errors_propagate(monkeypatch, err):
    """Only ``torch.OutOfMemoryError`` is caught: any other error leaves
    the first attempt untouched, with no rung taken."""
    _raise_in(monkeypatch, ("resident_solve",), lambda: err)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        with pytest.raises(type(err)) as info:
            ttv.denoise3D(_cube((8, 6, 64)), np.full(3, 1.0, np.float32),
                          iterations=5, FISTA=True, quiet=True, device="cpu")
    assert info.value is err
    assert _rungs(rec) == []


def test_retry_starts_after_the_failed_attempt_is_freed():
    """The failed attempt's frames and what they held (here a tensor in a
    reference cycle, which only the collector frees) are gone before the
    retry starts."""
    held = []

    def call(o):
        if o.vmem_resident:
            state = [torch.zeros(1000)]
            state.append(state)  # a cycle: freed by gc.collect() alone
            held.append(weakref.ref(state[0]))
            raise torch.OutOfMemoryError("CUDA out of memory")
        assert held[0]() is None, "the failed attempt's state is alive"
        return "ok"

    gc.disable()
    try:
        with pytest.warns(UserWarning, match="vmem_resident=False"):
            assert tengine.vmem_fallback(
                TOptions(ndim=3, iterations_fista=4, iterations_unacc=0),
                call) == "ok"
    finally:
        gc.enable()


def test_ladder_skips_knobs_already_off():
    """A knob the caller turned off is no rung: the ladder goes on to the
    next one that is on, then raises the error again."""
    seen = []

    def call(o):
        seen.append(tuple(getattr(o, k) for k in KNOBS))
        raise torch.OutOfMemoryError("CUDA out of memory")

    opts = TOptions(ndim=4, iterations_fista=4, iterations_unacc=0,
                    vmem_resident=False)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        with pytest.raises(torch.OutOfMemoryError):
            tengine.vmem_fallback(opts, call)
    assert _rungs(rec) == ["temporal_kstep", "temporal_pairs"]
    assert seen == [(False, True, True), (False, False, True),
                    (False, False, False)]


def test_stop_run_ladder_ends_on_the_k1_loop(monkeypatch):
    """A stop run whose K-step and pair blocks cannot allocate their
    checkpoint (``torch.empty_like`` raising, as on a full card) goes down
    the ladder to the one-iteration loop: the same stop and recon as that
    loop."""
    monkeypatch.setattr(tengine, "PAIR_MIN_ROW_BYTES", 0)
    shape = (16, 6, 64)
    o = torch.from_numpy(_cube(shape, 5) + np.float32(1.0))
    li, lm = torch.full((3,), 16.0), torch.full((3,), 1 / 16)
    base = dict(ndim=3, iterations_fista=40, iterations_unacc=0)
    probe = tengine.run_solver(o, li, lm, TOptions(**base,
                                                   temporal_pairs=False))
    d = probe["delta"].numpy().astype(np.float64)
    thr = float(np.sqrt(d[30] * min(d[29], d[30] * 4)))
    opts = TOptions(**base, stopping_relative_change=thr,
                    vmem_resident=False)
    want = tengine.run_solver(o, li, lm, TOptions(
        **base, stopping_relative_change=thr, temporal_pairs=False))
    real = torch.empty_like

    def full_card(x, *a, **k):
        if x.dim() == 3:  # a cube of the block checkpoint
            raise torch.OutOfMemoryError("CUDA out of memory")
        return real(x, *a, **k)

    monkeypatch.setattr(torch, "empty_like", full_card)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        got = tengine.vmem_fallback(
            opts, lambda x: tengine.run_solver(o, li, lm, x))
    assert _rungs(rec) == ["temporal_kstep", "temporal_pairs"]
    assert got["iterations_run"] == want["iterations_run"] == 31
    for key in ("recon", "b_norm", "delta"):
        assert torch.equal(got[key], want[key]), key


# -- the memory note --------------------------------------------------------

CFG4, CFG2, CFG1 = (256, 256, 128, 128), (256, 256, 2048), (64, 64, 512)


@pytest.mark.parametrize("shape,fista,stop,kw,n_arrays", [
    (CFG4, True, 1e-3, {}, 19),                      # K-steps: checkpoint
    (CFG4, True, None, {}, 10),
    (CFG4, True, 1e-3, dict(calculate_mse=True), 10),  # above the rule
    (CFG4, True, 1e-3, dict(backend="torch"), 10),
    (CFG2, True, 1e-3, {}, 15),
    (CFG1, False, 1e-3, {}, 9),                      # whole-run chunks
    (CFG1, False, None, {}, 5),
], ids=str)
def test_memory_note_counts_the_block_checkpoint(capsys, shape, fista, stop,
                                                 kw, n_arrays):
    """The note counts a stop run's block checkpoint where its phases keep
    one; without it the line is the JAX package's."""
    ndim = len(shape)
    cube = np.broadcast_to(np.float32(0), shape)  # no memory behind it
    opts = TOptions(ndim=ndim, iterations_fista=60 if fista else 0,
                    iterations_unacc=0 if fista else 60,
                    stopping_relative_change=stop, **kw)
    tapi._memory_note(cube, opts, False)
    line = capsys.readouterr().out
    assert f"holds {n_arrays} cube-size arrays" in line
    assert f"≈ {cube.nbytes * n_arrays / 2**30:.2f} GiB" in line
    japi._memory_note(cube, fista, ndim, False)
    jline = capsys.readouterr().out
    assert (line == jline) == (n_arrays == 2 + ndim * (2 if fista else 1))
    tapi._memory_note(cube, opts, True)
    assert capsys.readouterr().out == ""


# -- the progress default ---------------------------------------------------

@pytest.mark.parametrize("shape,dtype,iters,quiet,progress,want", [
    ((64, 64, 512), np.float32, 7500, False, None, False),  # whole-run
    ((256, 256, 2048), np.float32, 500, False, None, True),
    ((256, 256, 2048), np.float32, 499, False, None, False),
    ((256, 256, 2048), np.float32, 500, True, None, False),
    ((64, 64, 512), np.float64, 7500, False, None, True),   # f64: no kernel
    ((64, 64, 512), np.float32, 10, True, True, True),      # explicit
    ((256, 256, 2048), np.float32, 5000, False, False, False),
], ids=str)
def test_progress_default(shape, dtype, iters, quiet, progress, want):
    """Auto-on for long non-quiet runs that the whole-run kernel does not
    serve (``cytvdn_tpu/api.py:112-145`` with the port's gates)."""
    cube = np.broadcast_to(np.zeros((), dtype), shape)
    opts = TOptions(ndim=len(shape), iterations_fista=0,
                    iterations_unacc=iters)
    assert tapi._resolve_progress(progress, quiet, opts, cube) is want
    if not tengine._resolve_resident_chunks(opts, shape, torch.float32):
        # where no whole-run kernel serves the run, the JAX rule agrees
        jopts = JOptions(ndim=len(shape), iterations_fista=0,
                         iterations_unacc=iters)
        assert japi._resolve_progress(progress, quiet, jopts, cube) is want


# -- utils/log.py -----------------------------------------------------------

def test_progress_lines_without_tqdm(monkeypatch):
    """Without tqdm (as on a machine that lacks it) the callback prints the
    JAX package's lines."""
    monkeypatch.setitem(sys.modules, "tqdm", None)
    lines = {}
    for name, mod in (("torch", tlog), ("jax", jlog)):
        out = []
        cb = mod.make_progress("TV denoising", sink=out.append)
        for done, delta in ((25, 0.5), (50, 0.25), (60, float("nan"))):
            cb(done, 60, delta)
        cb.close()
        lines[name] = out
    assert lines["torch"] == lines["jax"]
    assert lines["torch"][0] == ("[cytv] TV denoising: iteration 25/60, "
                                 "delta 5.000e-01")
    assert tlog.progress_iter([1, 2], "x") == [1, 2]
    assert tlog.progress_iter(range(3), "x", enable=False) == range(3)


def test_timed_line():
    out = []
    with tlog.timed("chunk", sink=out.append):
        pass
    with tlog.timed("quiet", verbose=False, sink=out.append):
        pass
    assert len(out) == 1
    assert re.fullmatch(r"\[cytv\] chunk took \d+\.\d{3} s", out[0])


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "prof"
    with tlog.profile_trace(str(logdir)):
        torch.ones(64).add_(1).sum()
    with open(logdir / "trace.json") as f:
        assert "traceEvents" in json.load(f)
    with tlog.profile_trace(None):
        pass
