"""Lossy shadow duals on the K-step kernel (``lossy_duals``: the FISTA ``d``
stored as bfloat16) in the port, against the JAX package's K-step kernel
and lossy runs on the CPU, and against the port's own K=1 lossy loop.

The JAX K-step kernel rounds every intermediate level's ``d`` onto the
bfloat16 grid (``qd``, ``cytvdn_tpu/kernels/kstep.py:251-254, :329``) and
stores the last level's as bfloat16 (``:339-340, :480-482``), so K lossy
iterations in one launch are K lossy K=1 iterations. On the CPU the
port's wrapper runs its plain version, K lossy K=1 steps (each K=1 step's
``copy_`` into the bfloat16 ``d`` rounds to nearest even); the CUDA
kernel's ``LOSSY`` instantiations are held bitwise against it on the card
(tests/test_torch_cuda.py, ``chip_smoke.py`` phase 11).

Tolerances, tests/test_torch_lossy.py's: a recon or ``b`` against the
JAX package's within atol 5e-7, rtol 0, over at most 6 iterations (past
that an f32 ulp between the packages can tip one bfloat16 rounding), but
the ``b`` of one K-step within K float32 ulps of recon's largest value
(each level passes the packages' one-ulp difference in recon on to b);
the bfloat16 ``d`` of one K-step equal where the two packages' float32 ``d``
before the last rounding agree and within one bfloat16 ulp where they
differ; traces within rtol 2e-5. Everything the port runs in K-steps is
bitwise its K=1 lossy loop.
"""

import warnings

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

import cytvdn_tpu.kernels.kstep as KS  # noqa: E402
from cytvdn_tpu import cli as jcli  # noqa: E402
from cytvdn_tpu.config import SolverOptions as JOptions  # noqa: E402
from cytvdn_tpu.io.emd import read_emd as jread  # noqa: E402
from cytvdn_tpu.utils import checkpoint as jck  # noqa: E402
import cytvdn_tpu_torch as ttv  # noqa: E402
from cytvdn_tpu_torch import cli as tcli  # noqa: E402
from cytvdn_tpu_torch.config import SolverOptions as TOptions  # noqa: E402
from cytvdn_tpu_torch.io.emd import read_emd as tread  # noqa: E402
from cytvdn_tpu_torch.kernels import fused as tfused  # noqa: E402
from cytvdn_tpu_torch.kernels import kstep as tkstep  # noqa: E402
from cytvdn_tpu_torch.kernels import resident as tres  # noqa: E402
from cytvdn_tpu_torch.kernels import temporal as ttemporal  # noqa: E402
from cytvdn_tpu_torch.kernels.temporal import round_bf16  # noqa: E402
from cytvdn_tpu_torch.solver import engine as tengine  # noqa: E402
from cytvdn_tpu_torch.utils import checkpoint as tck  # noqa: E402
from cytvdn_tpu_torch.utils.state import state_from_numpy  # noqa: E402

from test_torch_fallback import (  # noqa: E402
    _jax_ladder, _raise_in, _record_attempts, _rungs)
from test_torch_lossy import (  # noqa: E402
    ATOL, S3, S4, TRACE_RTOL, _bf16_ulp, _cube, _emulate, _jax_launch,
    _jax_run, _launch_state, _opts, _port_run, _rel_l2)

#: the launch counters of the engine's kernels: K-step, pair, K=1, whole-run
COUNTERS = (tkstep.fused_kstep_iteration, ttemporal.fused_pair_iteration,
            tfused.fused_iteration, tres.resident_solve)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _calls():
    return tuple(c.calls for c in COUNTERS)


def _since(before):
    return tuple(c.calls - b for c, b in zip(COUNTERS, before))


def _rhos(k, seed=0):
    return np.linspace(0.1, 0.6, k).astype(np.float32) + np.float32(seed / 97)


def _port_kstep(state, rhos, d_dtype):
    """One K-step of the port (its plain version on the CPU) from
    ``state``, ``d`` of ``d_dtype``: its recon, b, d (float32 numpy) and
    (k, 3) sums."""
    orig, recon, accs, ds, li, lm = state
    r, a = _t(recon), [_t(x) for x in accs]
    d = [_t(x).to(d_dtype) for x in ds]
    out = tkstep.fused_kstep_iteration(_t(orig), r, a, d, _t(rhos), _t(li),
                                       _t(lm), k=len(rhos), fista=True)
    assert all(x.dtype == d_dtype for x in d)
    return (r.numpy(), [x.numpy() for x in a], [x.float().numpy() for x in d],
            torch.stack(out[3:], 1).double().numpy())


def _jax_kstep(state, rhos):
    """One K-step of the JAX kernel (interpret mode) with bfloat16 ``ds``."""
    orig, recon, accs, ds, li, lm = state
    out = KS.fused_kstep_iteration(
        jnp.asarray(orig), jnp.asarray(recon),
        tuple(jnp.asarray(a) for a in accs),
        tuple(jnp.asarray(d).astype(jnp.bfloat16) for d in ds),
        jnp.asarray(rhos), jnp.asarray(li), jnp.asarray(lm), k=len(rhos),
        fista=True, interpret=True)
    assert all(d.dtype == jnp.bfloat16 for d in out[2])
    return (np.asarray(out[0]), [np.asarray(a) for a in out[1]],
            [np.asarray(d.astype(jnp.float32)) for d in out[2]],
            np.stack([np.asarray(x, np.float64) for x in out[3:]], 1))


def _before_last_rounding(launch, state, rhos):
    """Each level's ``d`` before its rounding is the K=1 launch's float32
    ``d`` from the previous level's lossy state: ``k - 1`` lossy K=1
    launches of ``launch`` (a package's), then one with the duals widened.
    Returns that last launch's float32 ``d``."""
    orig, recon, accs, ds, li, lm = state
    for rho in rhos[:-1]:
        recon, accs, ds = launch(orig, recon, accs, ds, li, lm, float(rho),
                                 "bf16")
    return launch(orig, recon, accs, ds, li, lm, float(rhos[-1]), "f32")[2]


def _port_k1(orig, recon, accs, ds, li, lm, rho, kind):
    d_dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    r, a = _t(recon), [_t(x) for x in accs]
    d = [_t(x).to(d_dtype) for x in ds]
    tfused.fused_iteration(_t(orig), r, a, d, torch.tensor(rho), _t(li),
                           _t(lm), fista=True)
    return r.numpy(), [x.numpy() for x in a], [x.float().numpy() for x in d]


def _jax_k1(orig, recon, accs, ds, li, lm, rho, kind):
    return _jax_launch(orig, recon, accs, ds, li, lm, rho,
                       jnp.bfloat16 if kind == "bf16" else jnp.float32)


# -- one K-step ----------------------------------------------------------------

@pytest.mark.parametrize("shape,k", [(S3, 3), (S3, 4), (S4, 3),
                                     ((8, 4, 6, 16), 4)], ids=str)
def test_lossy_kstep_matches_jax_kstep_kernel(shape, k):
    """One lossy K-step against the JAX K-step kernel with bfloat16 ``ds``
    in interpret mode: recon within atol 5e-7, b within K float32 ulps of
    recon's largest value, the sums within rtol 2e-5. ``d``: each package's float32 ``d`` before the last level's
    rounding (its K=1 launches: K-1 lossy, then one widened); where those
    agree the bfloat16 ``d`` are equal, where they differ within one
    bfloat16 ulp. The port's bfloat16 ``d`` is its float32 ``d`` rounded
    to nearest even, and the lossy K-step is not the exact one: its
    intermediate levels round.

    The JAX K-step is bitwise the JAX package's K lossy K=1 launches, d
    included, as the port's is its own: what separates the packages is
    their K=1 arithmetic, a float32 ulp of recon that each level passes
    on to b (so b's tolerance grows with the level count, one ulp of
    recon per level; in the K=1 chains as in the K-steps)."""
    state = _launch_state(shape, seed=sum(shape) + k)
    rhos = _rhos(k, k)
    got = _port_kstep(state, rhos, torch.bfloat16)
    want = _jax_kstep(state, rhos)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=ATOL)
    b_atol = k * float(np.spacing(np.abs(want[0]).max()))
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, rtol=0, atol=b_atol)
    np.testing.assert_allclose(got[3], want[3], rtol=TRACE_RTOL)
    orig, chain = state[0], state[1:4]
    for rho in rhos:
        chain = _jax_k1(orig, *chain, *state[4:], float(rho), "bf16")
    np.testing.assert_array_equal(want[0], chain[0])
    for q in range(len(shape)):
        np.testing.assert_array_equal(want[1][q], chain[1][q])
        np.testing.assert_array_equal(want[2][q], chain[2][q])
    got32 = _before_last_rounding(_port_k1, state, rhos)
    want32 = _before_last_rounding(_jax_k1, state, rhos)
    for q in range(len(shape)):
        np.testing.assert_array_equal(
            got[2][q], round_bf16(torch.from_numpy(got32[q].copy())).numpy())
        same = got32[q] == want32[q]
        assert same.mean() > 0.5
        np.testing.assert_array_equal(got[2][q][same], want[2][q][same])
        diff = np.abs(got[2][q] - want[2][q])[~same]
        assert np.all(diff <= _bf16_ulp(want[2][q][~same]))
    exact = _port_kstep(state, rhos, torch.float32)
    assert max(np.max(np.abs(g - e)) for g, e in zip(got[1], exact[1])) \
        > 10 * ATOL


def _small_state(n0, ndim, seed):
    shape = (n0, 5, 12) if ndim == 3 else (n0, 3, 4, 8)
    return _launch_state(shape, seed)


@pytest.mark.parametrize("ndim", [3, 4])
@pytest.mark.parametrize("extra", [0, 1], ids=["n0=2k", "n0=2k+1"])
@pytest.mark.parametrize("k", [3, 4, 6, 8])
def test_plain_lossy_kstep_is_lossy_k1_steps(k, extra, ndim):
    """The plain lossy K-step (the wrapper on CPU tensors) at N0 = 2K and
    2K+1 is bitwise K plain lossy K=1 steps and, K even, K/2 plain lossy
    pairs, the bfloat16 ``d`` included; the sums within rtol 1e-5 of
    theirs."""
    state = _small_state(2 * k + extra, ndim, seed=10 * k + extra + ndim)
    orig, recon, accs, ds, li, lm = state
    rhos = _rhos(k, extra)
    got = _port_kstep(state, rhos, torch.bfloat16)
    runs = []
    for step in ("k1", "pair")[:1 + (k % 2 == 0)]:
        r, a = _t(recon), [_t(x) for x in accs]
        d = [_t(x).to(torch.bfloat16) for x in ds]
        sums = []
        for i in range(0, k, 1 if step == "k1" else 2):
            if step == "k1":
                out = tfused.fused_iteration(_t(orig), r, a, d,
                                             torch.tensor(rhos[i]), _t(li),
                                             _t(lm), fista=True)
                sums.append([float(x) for x in out[3:]])
            else:
                out = ttemporal.fused_pair_iteration(
                    _t(orig), r, a, d, torch.tensor(rhos[i]),
                    torch.tensor(rhos[i + 1]), _t(li), _t(lm), fista=True)
                sums += [[float(x) for x in out[3:6]],
                         [float(x) for x in out[6:9]]]
        assert all(x.dtype == torch.bfloat16 for x in d)
        runs.append((r.numpy(), [x.numpy() for x in a],
                     [x.float().numpy() for x in d], np.array(sums)))
    for want in runs:
        np.testing.assert_array_equal(got[0], want[0])
        for q in range(ndim):
            np.testing.assert_array_equal(got[1][q], want[1][q])
            np.testing.assert_array_equal(got[2][q], want[2][q])
        np.testing.assert_allclose(got[3], want[3], rtol=1e-5)


@pytest.mark.parametrize("shape,n", [((16, 6, 64), 16), ((16, 4, 6, 16), 8)],
                         ids=["3d", "4d"])
def test_lossy_ksteps_keep_the_per_iteration_cadence(shape, n):
    """A lossy run in K=8 launches is bitwise the every-iteration emulation
    (tests/test_lossy.py::_emulate, ``round_every=1``) and more than 1e-4
    from the every-second-iteration one: the cadence is per iteration, not
    per launch or per pair."""
    orig, li, lm = _cube(shape, seed=3)
    before = _calls()
    got = _port_run(orig, li, lm, _opts("port", shape, n), keep_state=True)
    assert _since(before) == (n // 8, 0, 0, 0)
    assert all(d.dtype == torch.bfloat16 for d in got["ds"])
    rec = got["recon"].numpy()
    np.testing.assert_array_equal(rec, _emulate(orig, li, lm, n, 1))
    assert np.max(np.abs(rec - _emulate(orig, li, lm, n, 2))) > 1e-4


# -- the engine ----------------------------------------------------------------

def _both(orig, li, lm, **kw):
    """A lossy run on the engine's default path and the port's lossy K=1
    loop (``temporal_kstep=False, temporal_pairs=False``) from the same
    input; the launches the first made (K-step, pair, K=1, whole-run)."""
    base = dict(ndim=orig.ndim, lossy_duals=True, **kw)
    before = _calls()
    run = _port_run(orig, li, lm, TOptions(**base), keep_state=True)
    launches = _since(before)
    k1 = _port_run(orig, li, lm, TOptions(**base, temporal_kstep=False,
                                          temporal_pairs=False),
                   keep_state=True)
    return run, k1, launches


def _assert_bitwise(got, want):
    assert torch.equal(got["recon"], want["recon"])
    for g, w in zip(got["ds"], want["ds"]):
        assert g.dtype == w.dtype == torch.bfloat16 and torch.equal(g, w)
    for g, w in zip(got["accs"], want["accs"]):
        assert torch.equal(g, w)
    assert got["iterations_run"] == want["iterations_run"]
    assert got["early_stopped"] == want["early_stopped"]
    for key in ("b_norm", "delta"):
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   rtol=1e-5)


# (shape, options, the launches: K-step, pair, K=1, whole-run)
ENGINE_CASES = {
    "fixed-3d": (S3, dict(iterations_fista=8, iterations_unacc=0),
                 (2, 0, 0, 0)),
    "fixed-4d": (S4, dict(iterations_fista=6, iterations_unacc=0),
                 (2, 0, 0, 0)),
    "odd": (S3, dict(iterations_fista=11, iterations_unacc=0), (2, 0, 3, 0)),
    "hybrid": (S3, dict(iterations_fista=8, iterations_unacc=9),
               (4, 0, 1, 0)),
    "k3": ((16, 6, 64), dict(iterations_fista=7, iterations_unacc=0,
                             temporal_k=3), (2, 0, 1, 0)),
    "k4": ((16, 4, 6, 16), dict(iterations_fista=9, iterations_unacc=0,
                                temporal_k=4), (2, 0, 1, 0)),
    "k6": ((16, 6, 64), dict(iterations_fista=13, iterations_unacc=0,
                             temporal_k=6), (2, 0, 1, 0)),
    "k8": ((16, 4, 6, 16), dict(iterations_fista=16, iterations_unacc=0,
                                temporal_k=8), (2, 0, 0, 0)),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_lossy_engine_ksteps_equal_k1_loop(case):
    """Lossy runs on the engine's default path take K-steps (fixed 3D and
    4D, an odd remainder, hybrid with both phases K-stepping, the
    unaccelerated one with no duals, and forced depths 3, 4, 6, 8) and are
    bitwise the port's K=1 lossy loop, the bfloat16 duals included; no
    whole-run launch."""
    shape, kw, launches = ENGINE_CASES[case]
    orig, li, lm = _cube(shape, seed=61)
    run, k1, got = _both(orig, li, lm, **kw)
    assert got == launches
    _assert_bitwise(run, k1)


@pytest.mark.parametrize("shape,n", [(S3, 6), (S4, 6)], ids=["3d", "4d"])
def test_lossy_ksteps_match_jax_kstep_run(shape, n):
    """A lossy run of 6 iterations in K=3 launches against the JAX
    engine's lossy run at ``temporal_k=3`` (its K-step kernel in interpret
    mode): recon within atol 5e-7, traces within rtol 2e-5."""
    orig, li, lm = _cube(shape, seed=2)
    before = _calls()
    got = _port_run(orig, li, lm, _opts("port", shape, n, temporal_k=3))
    assert _since(before) == (n // 3, 0, 0, 0)
    want = _jax_run(orig, li, lm, _opts("jax", shape, n, temporal_k=3,
                                        vmem_resident=False))
    np.testing.assert_allclose(got["recon"].numpy(), np.asarray(want["recon"]),
                               rtol=0, atol=ATOL)
    for key in ("b_norm", "delta"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=TRACE_RTOL)


@pytest.mark.parametrize("guard", ["real", "always"])
def test_lossy_stop_run_ksteps_behind_the_guard(monkeypatch, guard):
    """A stop-aware lossy run K-steps behind the guard (its block
    checkpoint holds the bfloat16 duals) and stops at the K=1 loop's
    iteration with recon and ``d`` bitwise. With a guard that always
    allows, a launch runs past the stop: the block checkpoint is restored,
    bfloat16 duals included, and the K=1 loop makes the exact stop."""
    orig, li, lm = _cube((16, 6, 64), seed=5)
    if guard == "always":
        monkeypatch.setattr(tengine, "_guard_allows", lambda *a: True)
    run, k1, (ks, pairs, ones, res) = _both(
        orig, li, lm, iterations_fista=60, iterations_unacc=0,
        stopping_relative_change=2e-3)
    n = run["iterations_run"]
    assert run["early_stopped"] and 10 < n < 60
    assert ks > 0 and pairs == res == 0
    # every K-step kept: prologue + launches + K=1 steps; a beaten guard
    # discards a launch's iterations, which the K=1 loop redoes
    assert (n == 8 * ks + ones) == (guard == "real")
    _assert_bitwise(run, k1)


def test_lossy_guard_beat_restores_bfloat16_checkpoint():
    """A recorded plateau lets a lossy K=8 launch run; its first delta
    falls far below the threshold: the guard is beaten, and the state
    (the bfloat16 duals, off their zero start), traces, index and latch are
    bitwise as before the block (tests/test_torch_stop.py's case, lossy)."""
    shape, n = (16, 6, 64), 40
    o = _t(_cube(shape, seed=7)[0])
    rng = np.random.default_rng(8)
    ds = [torch.from_numpy((rng.standard_normal(shape) * 0.01)
                           .astype(np.float32)).to(torch.bfloat16)
          for _ in range(3)]
    for q, d in enumerate(ds):
        d.select(q, 0).zero_()
    delta = torch.zeros(n)
    delta[:2] = 1.0
    st = tengine._PhaseState(
        i=2, done=False, recon=o.clone(),
        accs=[torch.zeros_like(o) for _ in range(3)], ds=ds,
        b_norm=torch.zeros(n), delta=delta, mse=None, tk=torch.ones(()))
    arrays = [st.recon, *st.accs, *st.ds, st.b_norm, st.delta]
    before = [x.clone() for x in arrays]
    opts = TOptions(ndim=3, iterations_fista=n, iterations_unacc=0,
                    stopping_relative_change=0.5, lossy_duals=True)
    rhos = torch.as_tensor(tengine.fista_tk_ratios(n), dtype=torch.float32)
    li, lm = torch.full((3,), 16.0), torch.full((3,), 1 / 16.0)
    calls = tkstep.fused_kstep_iteration.calls
    tengine._run_phase_kstep(True, n, st, o, rhos, li, lm, opts, None, 8)
    assert tkstep.fused_kstep_iteration.calls == calls + 1
    assert st.i == 2 and not st.done
    for a, b in zip(arrays, before):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert st.ds[0].dtype == torch.bfloat16


# -- chunks, checkpoints, resume ---------------------------------------------

@pytest.mark.parametrize("every", [1, 3, 7])
def test_chunked_lossy_kstep_runs_equal_unchunked(every):
    """A lossy run in K=3 launches, in chunks of 1, 3 and 7 iterations (no
    launch crosses a chunk's cap; the bfloat16 duals handed from chunk to
    chunk), is bitwise the unchunked run; chunks of 3 and 7 K-step."""
    orig, li, lm = _cube(S3, seed=7)
    opts = _opts("port", S3, 10, temporal_k=3)
    want = _port_run(orig, li, lm, opts)
    calls = tkstep.fused_kstep_iteration.calls
    got = tck.run_chunked(orig, li, lm, opts, None, every, device="cpu")
    assert (tkstep.fused_kstep_iteration.calls > calls) == (every >= 3)
    np.testing.assert_array_equal(got["recon"], want["recon"].numpy())
    np.testing.assert_array_equal(got["delta"], want["delta"].numpy())


def test_lossy_kstep_run_killed_and_resumed(tmp_path):
    """A lossy run in K=4 launches, killed after its second checkpoint save
    (chunks of 5: a K-step and a K=1 step each), resumes bitwise the
    straight run and the lossy K=1 loop; the checkpoint holds the bfloat16
    duals."""
    orig, li, lm = _cube(S3, seed=7)
    opts = _opts("port", S3, 14)
    straight = _port_run(orig, li, lm, opts)
    k1 = _port_run(orig, li, lm, _opts("port", S3, 14, temporal_kstep=False))
    assert torch.equal(straight["recon"], k1["recon"])
    kill = str(tmp_path / "kill.npz")
    seen = []

    def killer(done, total, delta):
        seen.append(done)
        if len(seen) == 2:
            raise KeyboardInterrupt

    calls = tkstep.fused_kstep_iteration.calls
    with pytest.raises(KeyboardInterrupt):
        tck.run_chunked(orig, li, lm, opts, kill, 5, progress=killer,
                        device="cpu")
    assert tkstep.fused_kstep_iteration.calls == calls + 2
    state, meta = tck.load_state(kill)
    assert int(state["i"]) == 10 and meta["bf16_keys"] == ["d0", "d1", "d2"]
    assert state["ds"][0].dtype == torch.bfloat16
    got = tck.run_chunked(orig, li, lm, opts, kill, 5, resume=True,
                          device="cpu")
    assert tkstep.fused_kstep_iteration.calls == calls + 3
    np.testing.assert_array_equal(got["recon"], straight["recon"].numpy())
    np.testing.assert_array_equal(got["delta"], straight["delta"].numpy())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_lossy_kstep_checkpoints_cross_packages(tmp_path, writer):
    """A lossy checkpoint written mid-run by either package, each running
    K-steps, is resumed by the other in K-steps: the port's resumed run is
    bitwise its run resumed from the same state in memory, and each
    package's resumed run ends within 1e-4 in relative L2 of its own
    straight run (tests/test_torch_lossy.py says why not closer)."""
    orig, li, lm = _cube(S3, seed=9)
    n, cut = 12, 4
    jopts = _opts("jax", S3, n, temporal_k=4, vmem_resident=False)
    topts = _opts("port", S3, n)
    meta = dict(ndim=3, shape=list(S3), iterations_fista=n,
                iterations_unacc=0, lossy_duals=True)
    calls = tkstep.fused_kstep_iteration.calls
    if writer == "jax":
        jpart = _jax_run(orig, li, lm, jopts, i_stop=cut, keep_state=True)
        jstate = {k: (tuple(np.asarray(x) for x in v) if k in ("accs", "ds")
                      else np.asarray(v))
                  for k, v in jpart.items() if k not in ("iterations_run",
                                                         "early_stopped")}
        jstate["early_stopped"] = False
        path = str(tmp_path / "j.npz")
        jck.save_state(path, jstate, meta)
        got = tck.run_chunked(orig, li, lm, topts, path, 8, resume=True,
                              device="cpu")
        assert tkstep.fused_kstep_iteration.calls - calls == 2
        mem = _port_run(orig, li, lm, topts,
                        state=state_from_numpy(jstate, "cpu"))
        np.testing.assert_array_equal(got["recon"], mem["recon"].numpy())
        want = tck.run_chunked(orig, li, lm, topts, None, 0, device="cpu")
    else:
        tpart = _port_run(orig, li, lm, topts, i_stop=cut, keep_state=True)
        assert tkstep.fused_kstep_iteration.calls - calls == 1
        assert tpart["ds"][0].dtype == torch.bfloat16
        path = str(tmp_path / "t.npz")
        tck.save_state(path, tpart, meta)
        got = jck.run_chunked(orig, li, lm, jopts, path, 8, resume=True)
        want = jck.run_chunked(orig, li, lm, jopts, None, 0)
    assert int(got["iterations_run"]) == n
    assert _rel_l2(got["recon"], want["recon"]) < 1e-4


# -- the fallback ladder and the command line ---------------------------------

@pytest.mark.parametrize("raising", [
    ("fused_kstep_iteration",),
    ("resident_solve", "fused_kstep_iteration"),
    ("fused_kstep_iteration", "fused_pair_iteration")], ids=str)
def test_lossy_ladder_matches_jax(monkeypatch, raising):
    """A lossy ``denoise3D`` whose K-step launches exhaust device memory:
    the ladder takes the JAX ladder's rungs, each attempt with its knobs
    (tests/test_torch_fallback.py), and the result after it is bitwise the
    run before any kernel raised. The whole-run kernel never takes a lossy
    run, so its rung passes on to the K-step rung."""
    monkeypatch.setattr(tengine, "PAIR_MIN_ROW_BYTES", 0)
    cube = _cube((16, 6, 64), 3)[0]
    mu = np.full(3, 1.0, np.float32)
    kw = dict(iterations=20, FISTA=True, quiet=True, device="cpu",
              lossy_duals=True)
    want = ttv.denoise3D(cube, mu, **kw)
    _raise_in(monkeypatch, raising, lambda: torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 36.00 GiB"))
    attempts = _record_attempts(monkeypatch)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        got = ttv.denoise3D(cube, mu, **kw)
    rungs = _rungs(rec)
    assert rungs == ["vmem_resident", "temporal_kstep"] + (
        ["temporal_pairs"] if "fused_pair_iteration" in raising else [])
    seen, jrungs, jraised = _jax_ladder(
        attempts, JOptions(ndim=3, iterations_fista=20, iterations_unacc=0,
                           lossy_duals=True))
    assert jrungs == rungs and seen == [k for k, _ in attempts]
    assert not jraised
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_cli_lossy_ksteps_match_jax_cli(tmp_path):
    """``cytv-torch --device cpu --lossy-duals`` on a 3D cube K-steps (K=6
    at N0 = 12) and matches ``cytv --lossy-duals`` on the same file (recon
    within atol 5e-7), and bitwise the port's lossy K=1 loop."""
    cube = _cube((12, 8, 16), seed=31)[0]
    inp = str(tmp_path / "in.npy")
    np.save(inp, cube)
    common = ["-i", inp, "-m", "1.0", "-f", "1", "-n", "6", "--lossy-duals",
              "-v", "0"]
    jout, tout = str(tmp_path / "j.emd"), str(tmp_path / "t.emd")
    assert jcli.main([*common, "-o", jout]) == 0
    before = _calls()
    assert tcli.main([*common, "-o", tout, "--device", "cpu"]) == 0
    assert _since(before) == (1, 0, 0, 0)
    np.testing.assert_allclose(tread(tout), jread(jout), rtol=0, atol=ATOL)
    li = np.full(3, 16.0, np.float32)
    k1 = _port_run(cube, li, 1 / li, _opts("port", cube.shape, 6,
                                            temporal_kstep=False))
    np.testing.assert_array_equal(tread(tout), k1["recon"].numpy())
