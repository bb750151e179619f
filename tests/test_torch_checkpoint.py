"""Chunked execution, checkpoint and resume in the port
(``cytvdn_tpu_torch.utils.checkpoint``, ``run_solver``'s ``state`` /
``i_stop`` / ``keep_state``) against the JAX package's
(``cytvdn_tpu.utils.checkpoint``) and against the port's unchunked runs.

On the CPU the kernels' wrappers run their plain versions, whose state and
traces are those of the one-iteration loop, so a chunked port run equals
the unchunked one bitwise in state and traces here (on the card the
traces may move by an ulp where a chunk boundary changes the kernel that
sums an iteration; tests/test_torch_cuda.py holds the state bitwise
there). Against JAX: the tolerances of tests/test_torch_resident.py —
state rtol 2e-5 / atol 2e-6, b_norm rtol 1e-5, delta rtol 1e-4.
"""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from cytvdn_tpu.config import SolverOptions as JOptions  # noqa: E402
from cytvdn_tpu.solver import engine as jengine  # noqa: E402
from cytvdn_tpu.utils import checkpoint as jck  # noqa: E402
from cytvdn_tpu_torch.config import SolverOptions as TOptions  # noqa: E402
from cytvdn_tpu_torch.kernels import fused as tfused  # noqa: E402
from cytvdn_tpu_torch.kernels import kstep as tkstep  # noqa: E402
from cytvdn_tpu_torch.kernels import resident as tres  # noqa: E402
from cytvdn_tpu_torch.kernels import temporal as ttemporal  # noqa: E402
from cytvdn_tpu_torch.solver import engine as tengine  # noqa: E402
from cytvdn_tpu_torch.utils import checkpoint as tck  # noqa: E402

RTOL, ATOL = 2e-5, 2e-6
COUNTERS = (tres.resident_solve, tkstep.fused_kstep_iteration,
            ttemporal.fused_pair_iteration, tfused.fused_iteration)


def _cube(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 0.5 + 2.0).astype(dtype)


def _scalars(ndim, mu=0.8, dtype=np.float32):
    lam = np.full(ndim, mu / (16.0 if ndim == 3 else 32.0), dtype)
    return (1.0 / lam).astype(dtype), (lam / mu).astype(dtype)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _close_run(got, want, mse=False):
    """A port run against a JAX run (numpy result dicts)."""
    _close(got["recon"], want["recon"])
    _close(got["b_norm"], want["b_norm"], rtol=1e-5, atol=0)
    _close(got["delta"], want["delta"], rtol=1e-4, atol=0)
    if mse:
        _close(got["mse"], want["mse"], rtol=1e-5, atol=0)


def _equal_run(got, want, keys=("recon", "b_norm", "delta")):
    for key in keys:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _calls():
    return [c.calls for c in COUNTERS]


# -- the JAX checkpoint tests (tests/test_io_cli.py::TestCheckpoint) --------

def _io_cube(seed):
    """The float64 cube and mu of tests/test_io_cli.py::TestCheckpoint."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((6, 7, 8)) * 0.5 + 2.0, np.full(3, 0.8)


def test_chunked_matches_uninterrupted(tmp_path):
    cube, mu = _io_cube(1)
    kw = dict(iterations=(5, 6), device="cpu")
    a = tck.run_with_checkpointing(cube, mu, checkpoint_every=0,
                                   checkpoint_path="", **kw)
    ck = str(tmp_path / "state.ckpt.npz")
    b = tck.run_with_checkpointing(cube, mu, checkpoint_every=3,
                                   checkpoint_path=ck, **kw)
    _equal_run(b, a)
    assert os.path.exists(ck)
    want = jck.run_with_checkpointing(cube, mu, iterations=(5, 6),
                                      checkpoint_every=3,
                                      checkpoint_path=str(tmp_path / "j.npz"))
    _close_run(b, want)
    assert b["iterations_run"] == int(want["iterations_run"]) == 11


def test_resume_from_partial_checkpoint(tmp_path):
    cube, mu = _io_cube(2)
    full = tck.run_with_checkpointing(cube, mu, iterations=(5, 6),
                                      checkpoint_every=0, checkpoint_path="",
                                      device="cpu")
    ck = str(tmp_path / "partial.npz")
    tck.run_with_checkpointing(cube, mu, iterations=(5, 6),
                               checkpoint_every=4, checkpoint_path=ck,
                               device="cpu")
    state, meta = tck.load_state(ck)
    assert meta["ndim"] == 3 and int(state["i"]) == 11
    resumed = tck.run_with_checkpointing(cube, mu, iterations=(5, 6),
                                         checkpoint_every=4,
                                         checkpoint_path=ck, resume=True,
                                         device="cpu")
    _equal_run(resumed, full, keys=("recon", "delta"))


def test_resume_mid_phase_exact(tmp_path):
    """The first chunk's file (i = 4 < n_fista = 5) resumed: bitwise the
    uninterrupted run."""
    cube, mu = _io_cube(3)
    li, lm = _scalars(3, 0.8, np.float64)
    opts = TOptions(ndim=3, iterations_fista=5, iterations_unacc=6)
    full = tck.run_chunked(cube, li, lm, opts, "", 0, device="cpu")
    ck = str(tmp_path / "mid.npz")

    def crash(done, total, delta):
        raise KeyboardInterrupt  # killed after the first chunk's save

    with pytest.raises(KeyboardInterrupt):
        tck.run_chunked(cube, li, lm, opts, ck, 4, progress=crash,
                        device="cpu")
    state, _ = tck.load_state(ck)
    assert int(state["i"]) == 4 and len(state["ds"]) == 3
    resumed = tck.run_chunked(cube, li, lm, opts, ck, 4, resume=True,
                              device="cpu")
    _equal_run(resumed, full)
    assert int(tck.load_state(ck)[0]["i"]) == 11


def test_progress_callback_chunks():
    """Progress-enabled runs are bitwise and report monotone iteration
    counts ending at the total (tests/test_io_cli.py)."""
    from cytvdn_tpu_torch import denoise3D

    cube = (np.random.default_rng(4).standard_normal((6, 6, 32))
            .astype(np.float32) * 0.2 + 1.0)
    mu = np.full(3, 2.0, np.float32)
    a = denoise3D(cube, mu, iterations=60, quiet=True, device="cpu")
    lam = mu / 16.0
    opts = TOptions(ndim=3, iterations_fista=0, iterations_unacc=60)
    seen = []
    out = tck.run_chunked(cube, (1.0 / lam).astype(np.float32),
                          (lam / mu).astype(np.float32), opts,
                          checkpoint_path=None, checkpoint_every=25,
                          progress=lambda d, t, dl: seen.append((d, t)),
                          device="cpu")
    np.testing.assert_array_equal(out["recon"], a[0])
    assert seen == [(25, 60), (50, 60), (60, 60)]


def test_resume_after_convergence_is_idempotent(tmp_path):
    """Resuming a run that already stopped returns the checkpointed result
    unchanged (the early-stop latch is saved)."""
    cube, mu = _io_cube(5)
    ck = str(tmp_path / "conv.npz")
    kw = dict(iterations=100, FISTA=False, stopping_relative_change=0.2,
              checkpoint_path=ck, checkpoint_every=5, device="cpu")
    first = tck.run_with_checkpointing(cube, mu, **kw)
    assert first["iterations_run"] < 100
    before = _calls()
    again = tck.run_with_checkpointing(cube, mu, resume=True, **kw)
    assert _calls() == before  # nothing ran
    _equal_run(again, first, keys=("recon", "delta"))
    assert again["iterations_run"] == first["iterations_run"]


# -- whole-run chunks and K-step chunks (tests/test_resident.py:200,
#    tests/test_kstep.py:296) -----------------------------------------------

@pytest.mark.parametrize("iters", [(0, 40), (40, 0), (20, 20)])
def test_chunked_runs_ride_resident_chunks(monkeypatch, iters):
    """Capped runs take the whole-run kernel without a stop: one launch
    per phase and chunk, bitwise the unchunked run of the one-iteration
    loop, and within tolerance of the JAX package's chunked run."""
    shape = (8, 6, 64)
    orig = _cube(shape, 41)
    li, lm = _scalars(3)
    base = dict(ndim=3, iterations_fista=iters[0], iterations_unacc=iters[1])
    want = tengine.run_solver(torch.from_numpy(orig), torch.from_numpy(li),
                              torch.from_numpy(lm),
                              TOptions(**base, vmem_resident=False,
                                       temporal_pairs=False))
    lengths = []
    real = tres.resident_solve

    def counting(*a, **k):
        lengths.append(k["n_iters"])
        return real(*a, **k)

    monkeypatch.setattr(tengine, "resident_solve", counting)
    got = tck.run_chunked(orig, li, lm, TOptions(**base),
                          checkpoint_path=None, checkpoint_every=20,
                          device="cpu")
    assert lengths == [20, 20]
    assert got["iterations_run"] == 40
    np.testing.assert_array_equal(got["recon"], want["recon"].numpy())
    np.testing.assert_array_equal(got["delta"], want["delta"].numpy())
    jwant = jck.run_chunked(orig, li, lm, JOptions(**base), None, 20)
    _close_run(got, jwant)


def test_kstep_chunked_resume_bitexact(tmp_path):
    """Chunks that cut K-step launches short (K = 3, chunks of 5) equal
    the unchunked run, across a checkpoint file (tests/test_kstep.py)."""
    shape = (16, 6, 64)
    orig = _cube(shape, 5)
    li, lm = _scalars(3)
    opts = TOptions(ndim=3, iterations_fista=8, iterations_unacc=5,
                    vmem_resident=False, temporal_k=3)
    want = tengine.run_solver(torch.from_numpy(orig), torch.from_numpy(li),
                              torch.from_numpy(lm), opts)
    before = _calls()
    got = tck.run_chunked(orig, li, lm, opts,
                          checkpoint_path=str(tmp_path / "ck.npz"),
                          checkpoint_every=5, device="cpu")
    assert _calls()[1] > before[1], "no K-step launch"
    np.testing.assert_array_equal(got["recon"], want["recon"].numpy())
    jwant = jengine.run_solver(jnp.asarray(orig), jnp.asarray(li),
                               jnp.asarray(lm),
                               JOptions(ndim=3, iterations_fista=8,
                                        iterations_unacc=5))
    _close_run(got, {k: np.asarray(v) for k, v in jwant.items()})


# -- every engine path, chunked ---------------------------------------------

def _stop_threshold(orig, li, lm, iters, stop_at):
    """A threshold between the one-iteration run's deltas of iterations
    ``stop_at - 1`` and ``stop_at``, far from both."""
    probe = tengine.run_solver(orig, li, lm, TOptions(
        ndim=orig.dim(), iterations_fista=iters[0], iterations_unacc=iters[1],
        temporal_pairs=False, vmem_resident=False))
    d = probe["delta"].numpy().astype(np.float64)
    assert 0 < d[stop_at] < d[stop_at - 1], d
    return float(np.sqrt(d[stop_at] * min(d[stop_at - 1], d[stop_at] * 4)))


# (name, shape, (n_fista, n_unacc), options, MSE, stop iteration or None,
#  the kernel the path must launch: 0 whole-run, 1 K-step, 2 pair, 3 K=1,
#  and the least chunk that launches it)
PATHS = [
    ("whole-run", (8, 6, 64), (0, 30), {}, False, None, 0, 1),
    ("whole-run-mse", (6, 4, 6, 16), (12, 9), {}, True, None, 0, 1),
    ("kstep", (16, 6, 64), (30, 0), dict(vmem_resident=False,
                                         temporal_k=3), False, None, 1, 3),
    ("pair", (7, 12, 6, 16), (30, 0), dict(vmem_resident=False,
                                           temporal_kstep=False), False,
     None, 2, 2),
    ("k1", (16, 6, 64), (12, 9), dict(vmem_resident=False,
                                      temporal_pairs=False), False, None, 3, 1),
    ("hybrid", (16, 6, 64), (12, 9), dict(vmem_resident=False), False, None,
     1, 8),
    ("mse", (16, 6, 64), (20, 7), dict(vmem_resident=False), True, None, 2, 2),
    ("stop", (16, 6, 64), (12, 40), dict(vmem_resident=False), False, 40, 1,
     8),
    ("stop-chunks", (8, 6, 64), (0, 200), {}, False, 150, 0, 16),
]


@pytest.mark.parametrize("every", [1, 3, 7, 25])
@pytest.mark.parametrize("name,shape,iters,kw,mse,stop_at,kernel,least",
                         PATHS, ids=[p[0] for p in PATHS])
def test_every_path_chunked_equals_unchunked(monkeypatch, name, shape, iters,
                                             kw, mse, stop_at, kernel, least,
                                             every):
    """Each engine path run in chunks of 1, 3, 7 and 25 iterations through
    ``run_chunked``: the same stop, recon, traces (and MSE trace) bitwise
    as the port's unchunked run, and the path's kernel launched where a
    chunk holds a launch."""
    monkeypatch.setattr(tengine, "PAIR_MIN_ROW_BYTES", 0)
    ndim = len(shape)
    orig = _cube(shape, 11)
    ref = _cube(shape, 12) * np.float32(0.2) + np.float32(1.6) if mse \
        else None
    li, lm = _scalars(ndim)
    to = [torch.from_numpy(x) for x in (orig, li, lm)]
    base = dict(ndim=ndim, iterations_fista=iters[0],
                iterations_unacc=iters[1], calculate_mse=mse, **kw)
    if stop_at is not None:
        base["stopping_relative_change"] = _stop_threshold(*to, iters,
                                                           stop_at)
    opts = TOptions(**base)
    want = tengine.run_solver(*to, opts,
                              torch.from_numpy(ref) if mse else None)
    if stop_at is not None:
        assert want["iterations_run"] == stop_at + 1
        assert want["early_stopped"]
    before = _calls()
    got = tck.run_chunked(orig, li, lm, opts, None, every,
                          reference_data=ref, device="cpu")
    launched = [c - b for c, b in zip(_calls(), before)]
    assert got["iterations_run"] == want["iterations_run"]
    keys = ("recon", "b_norm", "delta") + (("mse",) if mse else ())
    _equal_run(got, {k: want[k].numpy() for k in keys}, keys)
    if every >= least:
        assert launched[kernel] > 0, launched


# -- state in place, frozen shadow duals ------------------------------------

def test_state_adopted_in_place():
    """``run_solver(state=...)`` updates the handed-in tensors and returns
    them: no second copy of the state."""
    shape = (16, 6, 64)
    to = [torch.from_numpy(x) for x in (_cube(shape, 2), *_scalars(3))]
    opts = TOptions(ndim=3, iterations_fista=10, iterations_unacc=6,
                    vmem_resident=False)
    first = tengine.run_solver(*to, opts, i_stop=4, keep_state=True)
    state = {k: first[k] for k in ("recon", "accs", "ds", "b_norm", "delta",
                                   "i", "tk")}
    state["mse"] = None
    before = state["recon"].clone()
    out = tengine.run_solver(*to, opts, state=state, i_stop=13,
                             keep_state=True)
    assert out["recon"] is state["recon"] and out["i"] == 13
    assert all(a is b for a, b in zip(out["accs"], state["accs"]))
    assert all(a is b for a, b in zip(out["ds"], state["ds"]))
    assert out["delta"] is state["delta"]
    assert not torch.equal(state["recon"], before)


def test_hybrid_keep_state_freezes_shadow_duals():
    """A hybrid run capped in its unaccelerated phase returns the FISTA
    phase's shadow duals unchanged (``engine.py:1553``), as the JAX
    engine does; a FISTA phase cut by the cap keeps its index and skips
    the unaccelerated phase."""
    shape = (16, 6, 64)
    orig = _cube(shape, 8)
    li, lm = _scalars(3)
    to = [torch.from_numpy(x) for x in (orig, li, lm)]
    opts = TOptions(ndim=3, iterations_fista=9, iterations_unacc=7,
                    vmem_resident=False)
    at_nf = tengine.run_solver(*to, opts, i_stop=9, keep_state=True)
    ds_nf = [d.clone() for d in at_nf["ds"]]
    got = tengine.run_solver(*to, opts, i_stop=13, keep_state=True)
    assert got["i"] == 13
    for a, b in zip(got["ds"], ds_nf):
        assert torch.equal(a, b)
    cut = tengine.run_solver(*to, opts, i_stop=5, keep_state=True)
    assert cut["i"] == 5 and not cut["early_stopped"]
    assert float(cut["delta"][5:].abs().sum()) == 0
    jopts = JOptions(ndim=3, iterations_fista=9, iterations_unacc=7)
    want = jengine.run_solver(jnp.asarray(orig), jnp.asarray(li),
                              jnp.asarray(lm), jopts, i_stop=13,
                              keep_state=True)
    assert int(want["i"]) == 13
    for a, b in zip(got["ds"], want["ds"]):
        _close(a.numpy(), b)
    for a, b in zip(got["accs"], want["accs"]):
        _close(a.numpy(), b)
    _close(got["recon"].numpy(), want["recon"])


# -- across the two packages ------------------------------------------------

def _jax_state(orig, li, lm, jopts, i_stop, ref):
    out = jengine.run_solver(jnp.asarray(orig), jnp.asarray(li),
                             jnp.asarray(lm), jopts,
                             reference_data=None if ref is None
                             else jnp.asarray(ref),
                             i_stop=i_stop, keep_state=True)
    return {
        "recon": np.asarray(out["recon"]),
        "accs": tuple(np.asarray(a) for a in out["accs"]),
        "ds": tuple(np.asarray(d) for d in out["ds"]),
        "b_norm": np.asarray(out["b_norm"]),
        "delta": np.asarray(out["delta"]),
        "mse": np.asarray(out.get("mse", np.zeros(0))),
        "i": np.asarray(out["i"]),
        "tk": np.asarray(out["tk"]),
        "early_stopped": bool(out["early_stopped"]),
    }


@pytest.mark.parametrize("mse", [False, True])
@pytest.mark.parametrize("cut", [3, 8], ids=["mid-fista", "mid-hybrid"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_resumes_across_packages(tmp_path, writer, cut, mse):
    """A checkpoint written mid-FISTA (i = 3) or mid-hybrid (i = 8, in the
    unaccelerated phase) by one package's ``save_state`` resumes in the
    other's ``run_chunked`` and matches that package's uninterrupted run;
    both files hold the same keys, dtypes and meta."""
    shape = (7, 12, 6, 16)
    orig = _cube(shape, 21)
    li, lm = _scalars(4)
    ref = _cube(shape, 22) * np.float32(0.2) + np.float32(1.6) if mse \
        else None
    base = dict(ndim=4, iterations_fista=6, iterations_unacc=5,
                calculate_mse=mse)
    jopts, topts = JOptions(**base), TOptions(**base)
    meta = dict(ndim=4, shape=list(shape), iterations_fista=6,
                iterations_unacc=5, lossy_duals=False)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jck.save_state(jpath, _jax_state(orig, li, lm, jopts, cut, ref), meta)
    to = [torch.from_numpy(x) for x in (orig, li, lm)]
    tout = tengine.run_solver(*to, topts,
                              torch.from_numpy(ref) if mse else None,
                              i_stop=cut, keep_state=True)
    tck.save_state(tpath, {**tout, "mse": tout.get("mse")}, meta)
    with np.load(jpath) as zj, np.load(tpath) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert zj[k].dtype == zt[k].dtype and zj[k].shape == zt[k].shape, k
        assert json.loads(bytes(zj["meta"])) == json.loads(bytes(zt["meta"]))
        assert int(zt["i"]) == cut and zt["i"].dtype == np.int32
        assert zt["mse"].shape == ((12,) if mse else (0,))

    if writer == "jax":
        got = tck.run_chunked(orig, li, lm, topts, jpath, 4, resume=True,
                              reference_data=ref, device="cpu")
        want = tck.run_chunked(orig, li, lm, topts, None, 0,
                               reference_data=ref, device="cpu")
    else:
        got = jck.run_chunked(orig, li, lm, jopts, tpath, 4, resume=True,
                              reference_data=ref)
        want = jck.run_chunked(orig, li, lm, jopts, None, 0,
                               reference_data=ref)
    assert int(got["iterations_run"]) == int(want["iterations_run"]) == 11
    _close_run(got, want, mse)


@pytest.mark.parametrize("key,item", [("blocks", "item 9"),
                                      ("bf16_keys", "item 12")])
def test_load_refuses_unported_checkpoints(tmp_path, key, item):
    """Multi-process part files and bfloat16 shadow duals are refused with
    the ROADMAP item that ports them."""
    value = {"recon": {"shape": [4], "dtype": "float32", "bounds": []}} \
        if key == "blocks" else ["d0"]
    meta = {"ndim": 1, "shape": [4], key: value, "num_processes": 2,
            "version": 1}
    path = str(tmp_path / "x.npz")
    np.savez(path, meta=np.frombuffer(json.dumps(meta).encode(), np.uint8))
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue 1 {item}"):
        tck.load_state(path)


@pytest.mark.parametrize("change", ["schedule", "shape"])
def test_resume_refuses_another_run(tmp_path, change):
    cube, mu = _io_cube(6)
    ck = str(tmp_path / "a.npz")
    tck.run_with_checkpointing(cube, mu, iterations=(3, 2),
                               checkpoint_every=2, checkpoint_path=ck,
                               device="cpu")
    kw = dict(iterations=(3, 2), checkpoint_every=2, checkpoint_path=ck,
              resume=True, device="cpu")
    if change == "schedule":
        kw["iterations"] = (4, 2)
    else:
        cube = cube[:5]
    with pytest.raises(ValueError, match="does not match"):
        tck.run_with_checkpointing(cube, mu, **kw)


def test_progress_chunk_size_matches_jax():
    for n in (0, 1, 10, 100, 999, 1000, 7500, 10000, 10001, 10 ** 6):
        assert tck.progress_chunk_size(n) == jck.progress_chunk_size(n)


def test_killed_run_resumes_bitwise(tmp_path):
    """A hybrid (20, 12) run with a checkpoint every 8 iterations, killed
    after its second chunk (its progress callback raises) and resumed,
    equals the uninterrupted run: chip_smoke.py phase 6 (c) at a small
    size."""
    shape = (16, 6, 64)
    orig = _cube(shape, 31)
    li, lm = _scalars(3)
    opts = TOptions(ndim=3, iterations_fista=20, iterations_unacc=12,
                    vmem_resident=False)
    ck = str(tmp_path / "kill.npz")
    seen = []

    def killer(done, total, delta):
        seen.append(done)
        if len(seen) == 2:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        tck.run_chunked(orig, li, lm, opts, ck, 8, progress=killer,
                        device="cpu")
    assert seen == [8, 16] and int(tck.load_state(ck)[0]["i"]) == 16
    got = tck.run_chunked(orig, li, lm, opts, ck, 8, resume=True,
                          progress=lambda d, t, dl: seen.append(d),
                          device="cpu")
    assert seen == [8, 16, 24, 32]
    want = tengine.run_solver(*(torch.from_numpy(x) for x in (orig, li, lm)),
                              opts)
    assert got["iterations_run"] == want["iterations_run"] == 32
    _equal_run(got, {k: want[k].numpy() for k in ("recon", "b_norm",
                                                  "delta")})


@pytest.mark.parametrize("fn", ["denoise3D", "denoise4D"])
def test_api_progress_true(fn):
    """``progress=True`` runs chunked (log lines without tqdm) and equals
    the plain call bitwise."""
    import cytvdn_tpu_torch as ttv

    shape = (6, 6, 32) if fn == "denoise3D" else (5, 6, 4, 8)
    cube = _cube(shape, 9) * np.float32(0.2)
    mu = np.full(len(shape), 2.0, np.float32)
    a = getattr(ttv, fn)(cube, mu, iterations=(30, 30), quiet=True,
                         device="cpu")
    b = getattr(ttv, fn)(cube, mu, iterations=(30, 30), quiet=True,
                         progress=True, device="cpu")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
