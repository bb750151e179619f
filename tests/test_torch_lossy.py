"""Lossy shadow duals in the port (``lossy_duals``: the FISTA ``d`` stored
as bfloat16, the arithmetic in float32) against the JAX package's lossy
runs, on the CPU, and the port's own invariants.

The JAX side runs as tests/test_lossy.py runs it: ``Backend.PALLAS`` in
interpret mode (the K=1 kernel with bfloat16 ``ds``). On the CPU the
port's K=1 wrapper runs its plain version, whose ``copy_`` into the
bfloat16 ``d`` rounds to nearest even; the CUDA kernel's ``LOSSY``
instantiation is held bitwise against it on the card
(tests/test_torch_cuda.py, ``chip_smoke.py`` phase 11).

Tolerances: a lossy recon against the JAX lossy run or the cadence
emulation within atol 5e-7, rtol 0 (tests/test_lossy.py's), over runs of
up to 7 iterations, as tests/test_lossy.py runs them; traces at rtol 2e-5
(tests/test_torch_solver.py's). A single launch's bfloat16 ``d`` is
compared exactly where the two packages' float32 ``d`` before rounding
agree, and within one bfloat16 ulp where they differ. Over longer runs a
float32 ulp between the two packages' arithmetic can tip one element's
bfloat16 rounding, which moves that element by up to λ/μ times a bfloat16
ulp of its ``d`` (6.7e-4 at iteration 7 of one 8×6×64 cube, between the
JAX lossy run and the every-iteration emulation): the JAX kernel's
run and the JAX ops emulation drift apart so, while the port's plain ops
reproduce the JAX package's eager emulation (tests/test_lossy.py::
_emulate) bit for bit. So longer runs are held bitwise to that emulation,
and to the JAX run by their stop index; resumed runs across packages
within 1e-4 in relative L2 of a straight run (a few tipped elements over
three iterations; the lossy drift itself is ~1e-3). Chunked, resumed,
out-of-core and mesh lossy runs are bitwise the port's single-device
lossy run.
"""

import json
import warnings

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_lossy as jax_lossy  # noqa: E402
from test_torch_sharded import on_mesh  # noqa: E402

import cytvdn_tpu as jtv  # noqa: E402
from cytvdn_tpu import cli as jcli  # noqa: E402
from cytvdn_tpu.config import Backend as JBackend  # noqa: E402
from cytvdn_tpu.config import SolverOptions as JOptions  # noqa: E402
from cytvdn_tpu.io.emd import read_emd as jread  # noqa: E402
from cytvdn_tpu.kernels.temporal import round_bf16 as j_round_bf16  # noqa: E402
from cytvdn_tpu.solver import engine as jengine  # noqa: E402
from cytvdn_tpu.utils import checkpoint as jck  # noqa: E402
import cytvdn_tpu_torch as ttv  # noqa: E402
from cytvdn_tpu_torch import cli as tcli  # noqa: E402
from cytvdn_tpu_torch import ops  # noqa: E402
from cytvdn_tpu_torch.config import BCMode  # noqa: E402
from cytvdn_tpu_torch.config import SolverOptions as TOptions  # noqa: E402
from cytvdn_tpu_torch.io.emd import read_emd as tread  # noqa: E402
from cytvdn_tpu_torch.kernels import fused as tfused  # noqa: E402
from cytvdn_tpu_torch.kernels import kstep as tkstep  # noqa: E402
from cytvdn_tpu_torch.kernels import temporal as ttemporal  # noqa: E402
from cytvdn_tpu_torch.kernels.temporal import round_bf16  # noqa: E402
from cytvdn_tpu_torch.parallel import denoise_sharded  # noqa: E402
from cytvdn_tpu_torch.solver import engine as tengine  # noqa: E402
from cytvdn_tpu_torch.solver import outofcore as tooc  # noqa: E402
from cytvdn_tpu_torch.utils import checkpoint as tck  # noqa: E402
from cytvdn_tpu_torch.utils import perf  # noqa: E402
from cytvdn_tpu_torch.utils.state import state_from_numpy, state_to_numpy  # noqa: E402

ATOL = 5e-7           # a lossy recon against the JAX lossy run
TRACE_RTOL = 2e-5     # traces: the same sums in another order
S3, S4 = (8, 6, 64), (6, 4, 6, 16)


def _cube(shape, seed=0):
    """tests/test_lossy.py's cube and scalars (λ⁻¹ 32, λ/μ 1/32)."""
    rng = np.random.default_rng(seed)
    orig = (rng.standard_normal(shape) * 0.4 + 1.0).astype(np.float32)
    ndim = len(shape)
    return (orig, np.full(ndim, 32.0, np.float32),
            np.full(ndim, 1 / 32.0, np.float32))


def _opts(pkg, shape, n, **kw):
    base = dict(ndim=len(shape), iterations_fista=n, iterations_unacc=0,
                lossy_duals=True)
    if pkg == "jax":
        return JOptions(**base, backend=JBackend.PALLAS, **kw)
    return TOptions(**base, **kw)


def _jax_run(orig, li, lm, opts, **kw):
    return jengine.run_solver(jnp.asarray(orig), jnp.asarray(li),
                              jnp.asarray(lm), opts, **kw)


def _port_run(orig, li, lm, opts, **kw):
    t = torch.from_numpy
    return tengine.run_solver(t(orig.copy()), t(li), t(lm), opts, **kw)


def _emulate(orig, li, lm, n, round_every):
    """FISTA on the port's plain ops with ``d`` rounded onto the bfloat16
    grid (:func:`round_bf16`) after every ``round_every``-th iteration:
    1 is the lossy mode's cadence, 2 the wrong one a pair kernel without
    its mid-pair rounding would give (tests/test_lossy.py::_emulate)."""
    t = torch.from_numpy
    o, li, lm = t(orig), t(li), t(lm)
    tks = torch.from_numpy(tengine.fista_tk_ratios(n).astype(np.float32))
    recon = o.clone()
    accs = [torch.zeros_like(o) for _ in range(o.dim())]
    ds = [torch.zeros_like(o) for _ in range(o.dim())]
    for i in range(n):
        new_a, new_d = [], []
        for ax in range(o.dim()):
            b, d, _ = ops.accumulator_update_fista(
                recon, accs[ax], ds[ax], tks[i], ax, li[ax], BCMode.JIA_ZHAO)
            new_a.append(b)
            new_d.append(d)
        recon, _, _ = ops.datacube_update(o, recon, new_a, lm,
                                          BCMode.JIA_ZHAO)
        accs = new_a
        ds = [round_bf16(d) for d in new_d] if (i + 1) % round_every == 0 \
            else new_d
    return recon.numpy()


def _jax_emulate(orig, li, lm, n, round_every):
    """The JAX package's own cadence emulation (tests/test_lossy.py, eager
    JAX ops), as numpy."""
    return np.asarray(jax_lossy._emulate(jnp.asarray(orig), jnp.asarray(li),
                                         jnp.asarray(lm), n, round_every))


# -- round_bf16 ---------------------------------------------------------------

def _torture():
    """tests/test_lossy.py:389-427's values: ties, denormals, the carry to
    infinity, and 4096 random values over 26 decades."""
    torture = np.array([
        0.0, -0.0, 1.0, -1.0, 1.0 + 2.0 ** -9, 1.0 + 3.0 * 2.0 ** -9,
        1.0 + 2.0 ** -9 + 2.0 ** -20, np.float32(np.pi), -np.float32(np.e),
        1e-38, -1e-38, 1.1754944e-38, 1e-41, -3e-44, 3.3895314e38, 3.39e38,
        -3.39e38, 65535.5, 65504.0, 2.0 ** 127, np.finfo(np.float32).max,
        np.finfo(np.float32).tiny], dtype=np.float32)
    rng = np.random.default_rng(7)
    rand = (rng.standard_normal(4096)
            * np.exp(rng.uniform(-30, 30, 4096))).astype(np.float32)
    return np.concatenate([torture, rand]), rand


@pytest.mark.parametrize("against", ["jax", "ml_dtypes", "torch-cast"])
def test_round_bf16_bitwise(against):
    """The port's ``round_bf16`` is bit for bit the JAX ``round_bf16``, the
    ``ml_dtypes`` convert round trip and torch's own bfloat16 cast (the
    rounding the plain version's ``copy_`` does), on every value, and
    really rounds."""
    x, rand = _torture()
    got = round_bf16(torch.from_numpy(x)).numpy()
    if against == "jax":
        want = np.asarray(jax.jit(j_round_bf16)(jnp.asarray(x)))
    elif against == "ml_dtypes":
        want = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    else:
        want = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert not np.array_equal(round_bf16(torch.from_numpy(rand)).numpy(),
                              rand)
    with pytest.raises(ValueError, match="float32"):
        round_bf16(torch.from_numpy(x).double())


# -- one K=1 launch -------------------------------------------------------------

def _launch_state(shape, seed):
    """A Jia-Zhao state with nonzero duals already on the bfloat16 grid."""
    rng = np.random.default_rng(seed)
    ndim = len(shape)
    orig = (rng.standard_normal(shape) * 0.5 + 2.0).astype(np.float32)
    recon = (orig + rng.standard_normal(shape) * 0.05).astype(np.float32)
    accs = [(rng.standard_normal(shape) * 0.2).astype(np.float32)
            for _ in range(ndim)]
    ds = [(rng.standard_normal(shape) * 0.2).astype(ml_dtypes.bfloat16)
          .astype(np.float32) for _ in range(ndim)]
    for k in range(ndim):
        idx = tuple(0 if i == k else slice(None) for i in range(ndim))
        accs[k][idx] = 0
        ds[k][idx] = 0
    li = np.linspace(0.2, 0.35, ndim).astype(np.float32)
    lm = np.linspace(1 / 32, 1 / 48, ndim).astype(np.float32)
    return orig, recon, accs, ds, li, lm


def _jax_launch(orig, recon, accs, ds, li, lm, rho, d_dtype):
    opts = JOptions(ndim=orig.ndim, iterations_fista=1, iterations_unacc=0,
                    backend=JBackend.PALLAS, temporal_pairs=False,
                    temporal_kstep=False, vmem_resident=False,
                    lossy_duals=d_dtype == jnp.bfloat16)
    r, a, d, _, _ = jengine.iteration_step(
        jnp.asarray(orig), jnp.asarray(recon),
        tuple(jnp.asarray(x) for x in accs),
        tuple(jnp.asarray(x).astype(d_dtype) for x in ds),
        jnp.float32(rho), jnp.asarray(li), jnp.asarray(lm), opts)
    return (np.asarray(r), [np.asarray(x) for x in a],
            [np.asarray(x.astype(jnp.float32)) for x in d])


def _port_launch(orig, recon, accs, ds, li, lm, rho, d_dtype):
    t = torch.from_numpy
    r = t(recon.copy())
    a = [t(x.copy()) for x in accs]
    d = [t(x.copy()).to(d_dtype) for x in ds]
    tfused.fused_iteration(t(orig), r, a, d, torch.tensor(rho), t(li), t(lm),
                           fista=True)
    return r.numpy(), [x.numpy() for x in a], [x.float().numpy() for x in d]


def _bf16_ulp(x):
    """One bfloat16 ulp at each value of ``x`` (on the bfloat16 grid)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7).astype(np.float32)


@pytest.mark.parametrize("shape", [S3, S4], ids=["3d", "4d"])
def test_one_lossy_launch_matches_jax_kernel(shape):
    """One K=1 launch with bfloat16 ``ds`` against the JAX fused kernel
    with bfloat16 ``ds`` (interpret mode): recon and b within atol 5e-7.
    ``d``: the same launch with the duals widened to float32 gives each
    package's ``d`` before rounding; where those agree bitwise the
    bfloat16 ``d`` are equal, and where they differ (by float32 ulps) the
    bfloat16 ``d`` are within one bfloat16 ulp. Each package's bfloat16
    ``d`` is its float32 ``d`` rounded to nearest even."""
    state = _launch_state(shape, seed=len(shape))
    got = _port_launch(*state, 0.37, torch.bfloat16)
    want = _jax_launch(*state, 0.37, jnp.bfloat16)
    got32 = _port_launch(*state, 0.37, torch.float32)
    want32 = _jax_launch(*state, 0.37, jnp.float32)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=ATOL)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    for k in range(len(shape)):
        for d16, d32 in ((got[2][k], got32[2][k]), (want[2][k], want32[2][k])):
            np.testing.assert_array_equal(
                d16, round_bf16(torch.from_numpy(d32.copy())).numpy())
        same = got32[2][k] == want32[2][k]
        np.testing.assert_array_equal(got[2][k][same], want[2][k][same])
        diff = np.abs(got[2][k] - want[2][k])[~same]
        assert np.all(diff <= _bf16_ulp(want[2][k][~same]))
    # the widened launch's recon and b are the lossy launch's (the old d
    # widens exactly)
    np.testing.assert_array_equal(got[0], got32[0])


# -- run_solver ----------------------------------------------------------------

@pytest.mark.parametrize("shape,n", [(S3, 5), (S4, 6)], ids=["3d", "4d"])
def test_lossy_run_matches_jax_and_cadence(shape, n):
    """A lossy ``run_solver`` against the JAX lossy run (K=1 kernel in
    interpret mode) within atol 5e-7, traces within rtol 2e-5; bitwise the
    every-iteration emulation (the port's ops with :func:`round_bf16`, and
    the JAX package's eager one), and more than 1e-4 from the
    every-second-iteration one; every iteration a K=1 step, none in pairs
    or K-steps; ``d`` kept as bfloat16."""
    orig, li, lm = _cube(shape)
    calls = tfused.fused_iteration.calls
    pair, kst = (ttemporal.fused_pair_iteration.calls,
                 tkstep.fused_kstep_iteration.calls)
    got = _port_run(orig, li, lm, _opts("port", shape, n), keep_state=True)
    assert tfused.fused_iteration.calls - calls == n
    assert (ttemporal.fused_pair_iteration.calls,
            tkstep.fused_kstep_iteration.calls) == (pair, kst)
    assert all(d.dtype == torch.bfloat16 for d in got["ds"])
    want = _jax_run(orig, li, lm, _opts("jax", shape, n,
                                        temporal_pairs=False))
    np.testing.assert_allclose(got["recon"].numpy(), np.asarray(want["recon"]),
                               rtol=0, atol=ATOL)
    for key in ("b_norm", "delta"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=TRACE_RTOL)
    # the cadence: bitwise the every-iteration emulation, the port's and
    # the JAX package's, and far from the every-second-iteration one
    np.testing.assert_array_equal(got["recon"].numpy(),
                                  _emulate(orig, li, lm, n, 1))
    np.testing.assert_array_equal(got["recon"].numpy(),
                                  _jax_emulate(orig, li, lm, n, 1))
    assert np.max(np.abs(got["recon"].numpy()
                         - _emulate(orig, li, lm, n, 2))) > 1e-4


def test_lossy_run_matches_jax_paired_run():
    """The JAX engine pairs lossy runs (its pair kernel's mid-pair
    rounding); at this cube's rows the port's pairs do not pay, so it runs
    the K=1 loop. The JAX paired run is bitwise its K=1 run, so the port's
    lossy run meets it within atol 5e-7 too (the port's lossy pairs against
    it: tests/test_torch_lossy_pair.py)."""
    orig, li, lm = _cube(S4, seed=2)
    got = _port_run(orig, li, lm, _opts("port", S4, 6))
    want = _jax_run(orig, li, lm, _opts("jax", S4, 6, temporal_pairs=True))
    np.testing.assert_allclose(got["recon"].numpy(), np.asarray(want["recon"]),
                               rtol=0, atol=ATOL)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_lossy_hybrid_and_stop_runs():
    """A hybrid lossy run (the unaccelerated phase carries no duals)
    against the JAX package's within atol 5e-7; a stop-aware one stops at
    the JAX run's iteration and is bitwise the JAX package's eager
    every-iteration emulation of that many iterations (the module
    docstring says why not the JAX run); both on the K=1 loop."""
    orig, li, lm = _cube(S3, seed=5)
    calls = tfused.fused_iteration.calls
    hyb = dict(ndim=3, iterations_fista=4, iterations_unacc=3,
               lossy_duals=True)
    got = _port_run(orig, li, lm, TOptions(**hyb))
    want = _jax_run(orig, li, lm, JOptions(**hyb, backend=JBackend.PALLAS))
    np.testing.assert_allclose(got["recon"].numpy(), np.asarray(want["recon"]),
                               rtol=0, atol=ATOL)
    stop = dict(ndim=3, iterations_fista=40, iterations_unacc=0,
                stopping_relative_change=3e-3, lossy_duals=True)
    got = _port_run(orig, li, lm, TOptions(**stop))
    want = _jax_run(orig, li, lm, JOptions(**stop, backend=JBackend.PALLAS))
    n = got["iterations_run"]
    assert 2 < n < 40 and got["early_stopped"]
    assert n == int(want["iterations_run"])
    assert tfused.fused_iteration.calls - calls == 7 + n
    np.testing.assert_array_equal(got["recon"].numpy(),
                                  _jax_emulate(orig, li, lm, n, 1))


def test_lossy_drift_envelope_and_denoising():
    """tests/test_lossy.py:117-145 on the port: the lossy run drifts from
    the exact one (nonzero) within the envelope, and still denoises."""
    shape = (16, 12, 10, 10)
    rng = np.random.default_rng(3)
    clean = np.zeros(shape, np.float32)
    clean[:, :, 5:] = 1.0
    noisy = (clean + rng.standard_normal(shape) * 0.25).astype(np.float32)
    li = np.full(4, 32.0, np.float32)
    lm = np.full(4, 1 / 32.0, np.float32)
    t = torch.from_numpy
    runs = [tengine.run_solver(
        t(noisy), t(li), t(lm),
        TOptions(ndim=4, iterations_fista=60, iterations_unacc=0,
                 calculate_mse=True, lossy_duals=lossy), t(clean))
        for lossy in (False, True)]
    a, b = (r["recon"].double().numpy() for r in runs)
    drift = np.linalg.norm(a - b) / np.linalg.norm(a)
    assert 1e-5 < drift < 1e-2
    mse = runs[1]["mse"].numpy()
    assert mse[-1] < mse[0] * 0.75


# -- chunks, checkpoints, resume ---------------------------------------------

@pytest.mark.parametrize("every", [1, 3, 7])
def test_chunked_lossy_runs_equal_unchunked(every):
    """A lossy run in chunks of 1, 3 and 7 iterations (the state handed
    from chunk to chunk on the device, bfloat16 duals included) is bitwise
    the unchunked run."""
    orig, li, lm = _cube(S3, seed=7)
    opts = _opts("port", S3, 9)
    want = _port_run(orig, li, lm, opts)
    got = tck.run_chunked(orig, li, lm, opts, None, every, device="cpu")
    np.testing.assert_array_equal(got["recon"], want["recon"].numpy())
    np.testing.assert_array_equal(got["delta"], want["delta"].numpy())


def test_lossy_checkpoint_roundtrip_and_kill_resume(tmp_path):
    """tests/test_lossy.py:148-176 on the port: a mid-run state's bfloat16
    duals survive a checkpoint (uint16 bit patterns, ``bf16_keys``) and a
    run killed after its second save resumes bitwise; an exact resume of
    the lossy checkpoint is refused."""
    orig, li, lm = _cube(S3, seed=7)
    opts = _opts("port", S3, 9)
    straight = _port_run(orig, li, lm, opts)
    part = _port_run(orig, li, lm, opts, i_stop=5, keep_state=True)
    ck = str(tmp_path / "lossy.npz")
    tck.save_state(ck, part, {"ndim": 3})
    state, meta = tck.load_state(ck)
    assert meta["bf16_keys"] == ["d0", "d1", "d2"]
    for d, w in zip(state["ds"], part["ds"]):
        assert d.dtype == torch.bfloat16 and torch.equal(d, w)
    resumed = _port_run(orig, li, lm, opts,
                        state=state_from_numpy(state, "cpu"))
    assert torch.equal(resumed["recon"], straight["recon"])

    kill = str(tmp_path / "kill.npz")
    seen = []

    def killer(done, total, delta):
        seen.append(done)
        if len(seen) == 2:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        tck.run_chunked(orig, li, lm, opts, kill, 3, progress=killer,
                        device="cpu")
    got = tck.run_chunked(orig, li, lm, opts, kill, 3, resume=True,
                          device="cpu")
    np.testing.assert_array_equal(got["recon"], straight["recon"].numpy())
    with pytest.raises(ValueError, match="lossy"):
        tck.run_chunked(orig, li, lm, TOptions(ndim=3, iterations_fista=9,
                                               iterations_unacc=0),
                        kill, 3, resume=True, device="cpu")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_lossy_checkpoints_cross_packages(tmp_path, writer):
    """A lossy checkpoint written by either package has the other's keys,
    dtypes and meta (the duals as uint16 bit patterns named in
    ``bf16_keys``), and the other package loads it bit for bit and resumes
    it: the port's resumed run is bitwise its run resumed from the same
    state in memory, and each package's resumed run ends within 1e-4 in
    relative L2 of its own straight run (the module docstring says why
    not closer)."""
    orig, li, lm = _cube(S3, seed=9)
    n, cut = 8, 5
    jopts = _opts("jax", S3, n, temporal_pairs=False)
    topts = _opts("port", S3, n)
    meta = dict(ndim=3, shape=list(S3), iterations_fista=n,
                iterations_unacc=0, lossy_duals=True)
    jpart = _jax_run(orig, li, lm, jopts, i_stop=cut, keep_state=True)
    jstate = {k: (tuple(np.asarray(x) for x in v) if k in ("accs", "ds")
                  else np.asarray(v))
              for k, v in jpart.items() if k not in ("iterations_run",
                                                     "early_stopped")}
    jstate["early_stopped"] = False
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jck.save_state(jpath, jstate, meta)
    tpart = _port_run(orig, li, lm, topts, i_stop=cut, keep_state=True)
    tck.save_state(tpath, tpart, meta)
    with np.load(jpath) as zj, np.load(tpath) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert zj[k].dtype == zt[k].dtype and zj[k].shape == zt[k].shape, k
        assert zt["d0"].dtype == np.uint16
        assert json.loads(bytes(zj["meta"])) == json.loads(bytes(zt["meta"]))
    if writer == "jax":
        loaded, _ = tck.load_state(jpath)
        for d, w in zip(loaded["ds"], jstate["ds"]):
            np.testing.assert_array_equal(
                d.view(torch.int16).numpy().view(np.uint16), w.view(np.uint16))
        got = tck.run_chunked(orig, li, lm, topts, jpath, 4, resume=True,
                              device="cpu")
        mem = _port_run(orig, li, lm, topts,
                        state=state_from_numpy(jstate, "cpu"))
        np.testing.assert_array_equal(got["recon"], mem["recon"].numpy())
        want = tck.run_chunked(orig, li, lm, topts, None, 0, device="cpu")
    else:
        loaded, _ = jck.load_state(tpath)
        for d, w in zip(loaded["ds"], tpart["ds"]):
            np.testing.assert_array_equal(
                np.asarray(d).view(np.uint16),
                w.view(torch.int16).numpy().view(np.uint16))
        got = jck.run_chunked(orig, li, lm, jopts, tpath, 4, resume=True)
        want = jck.run_chunked(orig, li, lm, jopts, None, 0)
    assert int(got["iterations_run"]) == n
    assert _rel_l2(got["recon"], want["recon"]) < 1e-4


def test_state_helpers_carry_bfloat16():
    """A JAX lossy state (``ml_dtypes`` bfloat16 duals) moves onto a torch
    device as bfloat16 tensors, bit for bit; the port's bfloat16 duals go
    back to numpy widened exactly to float32, and the engine casts them
    back when it adopts them."""
    orig, li, lm = _cube(S4, seed=4)
    jpart = _jax_run(orig, li, lm, _opts("jax", S4, 6, temporal_pairs=False),
                     i_stop=3, keep_state=True)
    st = state_from_numpy({k: (tuple(np.asarray(x) for x in v)
                               if k in ("accs", "ds") else np.asarray(v))
                           for k, v in jpart.items()}, "cpu")
    for d, w in zip(st["ds"], jpart["ds"]):
        assert d.dtype == torch.bfloat16
        np.testing.assert_array_equal(d.float().numpy(),
                                      np.asarray(w).astype(np.float32))
    back = state_to_numpy(st)
    assert back["ds"][0].dtype == np.float32
    opts = _opts("port", S4, 6)
    resumed = _port_run(orig, li, lm, opts,
                        state=state_from_numpy(back, "cpu"), keep_state=True)
    assert resumed["ds"][0].dtype == torch.bfloat16
    straight = _port_run(orig, li, lm, opts)
    np.testing.assert_allclose(resumed["recon"].numpy(),
                               straight["recon"].numpy(), rtol=0, atol=ATOL)


# -- out of core ----------------------------------------------------------------

@pytest.mark.parametrize("shape,slabs", [((12, 8, 64), 3), ((10, 6, 8, 16), 4)],
                         ids=["3d", "4d"])
def test_outofcore_lossy_stream_equals_incore(shape, slabs):
    """Stream mode with bfloat16 host duals is bitwise the in-core lossy
    run (recon; the traces within rtol 1e-5, summed in slab order) and the
    JAX package's eager cadence emulation (the JAX out-of-core run is its
    in-core kernel run, bitwise, tests/test_lossy.py:232-266); it moves
    the duals at 2 bytes an element."""
    cube = _cube(shape, seed=23)[0]
    mu = np.full(len(shape), 1.0, np.float32)
    got = tooc.denoise_outofcore(cube, mu, iterations=6, n_slabs=slabs,
                                 lossy_duals=True, device="cpu")
    fn = ttv.denoise4D if len(shape) == 4 else ttv.denoise3D
    want = fn(cube, mu, iterations=6, FISTA=True, lossy_duals=True,
              quiet=True, device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):  # sums in slab order
        np.testing.assert_allclose(g, w, rtol=1e-5)
    h2d = tooc.last_run["h2d_bytes"]
    exact = tooc.denoise_outofcore(cube, mu, iterations=6, n_slabs=slabs,
                                   device="cpu")
    assert np.max(np.abs(got[0] - exact[0])) > 1e-6
    # per sweep the slabs' d arrays and the interior slabs' axis-0 d halo
    # row go in at 2 bytes an element, not 4
    nd, vox = len(shape), int(np.prod(shape))
    row = vox // shape[0]
    assert tooc.last_run["h2d_bytes"] - h2d == \
        6 * (nd * vox + (slabs - 1) * row) * 2
    # the default λ = μ/16 (3D), μ/32 (4D)
    div = 32.0 if nd == 4 else 16.0
    np.testing.assert_array_equal(got[0], _jax_emulate(
        cube, np.full(nd, div, np.float32), np.full(nd, 1 / div, np.float32),
        6, 1))


def test_outofcore_lossy_kill_and_resume(tmp_path, monkeypatch):
    """tests/test_lossy.py:269-305 on the port: a lossy stream run killed
    after its first checkpoint save resumes bitwise; the checkpoint holds
    the bfloat16 duals, and an exact resume of it is refused."""
    shape = (12, 8, 64)
    cube = _cube(shape, seed=29)[0]
    mu = np.full(3, 1.0, np.float32)
    straight = tooc.denoise_outofcore(cube, mu, iterations=6, n_slabs=3,
                                      lossy_duals=True, device="cpu")
    ck = str(tmp_path / "ooc.npz")
    real, calls = tooc._ckpt_save, []

    def killing(*a, **kw):
        real(*a, **kw)
        calls.append(1)
        raise KeyboardInterrupt

    monkeypatch.setattr(tooc, "_ckpt_save", killing)
    with pytest.raises(KeyboardInterrupt):
        tooc.denoise_outofcore(cube, mu, iterations=6, n_slabs=3,
                               lossy_duals=True, checkpoint_path=ck,
                               checkpoint_every=3, device="cpu")
    monkeypatch.undo()
    state, meta = tck.load_state(ck)
    assert meta["lossy"] and state["ds"][0].dtype == torch.bfloat16
    got = tooc.denoise_outofcore(cube, mu, iterations=6, n_slabs=3,
                                 lossy_duals=True, checkpoint_path=ck,
                                 checkpoint_every=3, resume=True,
                                 device="cpu")
    for g, w in zip(got, straight):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="lossy"):
        tooc.denoise_outofcore(cube, mu, iterations=6, n_slabs=3,
                               checkpoint_path=ck, checkpoint_every=3,
                               resume=True, device="cpu")


# -- meshes -----------------------------------------------------------------------

@pytest.mark.parametrize("shard,shape", [((2, 1, 1), (16, 6, 64)),
                                         ((1, 2, 1, 1), (6, 8, 6, 16))],
                         ids=["axis0-3d", "axis1-4d"])
def test_sharded_lossy_matches_single_device(shard, shape):
    """tests/test_lossy.py::test_sharded_lossy_k1_matches_single_device on
    2 gloo ranks: the K=1 halo steps with the neighbour's bfloat16 d slab
    widened at the pack give the single-device lossy run, bitwise, and
    every rank's block keeps bfloat16 duals."""
    orig, li, lm = _cube(shape, seed=13)
    mu = np.full(len(shape), 1.0, np.float32)
    fn = ttv.denoise4D if len(shape) == 4 else ttv.denoise3D
    want = fn(orig, mu, iterations=5, FISTA=True, lossy_duals=True,
              quiet=True, device="cpu")
    res = on_mesh(2, lambda pg, r: denoise_sharded(
        orig, mu, iterations=5, shard=shard, group=pg, device="cpu",
        lossy_duals=True))
    np.testing.assert_array_equal(res[0]["recon"], want[0])
    for out in res:
        np.testing.assert_array_equal(out["block"], want[0][out["slices"]])
        np.testing.assert_allclose(out["delta"], want[2], rtol=1e-5)


# -- the command line, the API, the refusals -------------------------------------

@pytest.mark.parametrize("flags", [["-n", "6"],
                                   ["-n", "6", "--out-of-core", "3"],
                                   ["-n", "9", "--checkpoint", "CK",
                                    "--checkpoint-every", "4"]],
                         ids=["in-core", "out-of-core", "checkpoint"])
def test_cli_lossy_matches_jax_cli(tmp_path, flags):
    """``cytv-torch --device cpu --lossy-duals`` against ``cytv
    --lossy-duals`` on the same file (recon within atol 5e-7), and bitwise
    the port's API run."""
    cube = _cube((12, 8, 16), seed=31)[0]
    inp = str(tmp_path / "in.npy")
    np.save(inp, cube)
    flags = [str(tmp_path / "ck.npz") if f == "CK" else f for f in flags]
    common = ["-i", inp, "-m", "1.0", "-f", "1", "--lossy-duals", "-v", "0",
              *flags]
    jout, tout = str(tmp_path / "j.emd"), str(tmp_path / "t.emd")
    assert jcli.main([*common, "-o", jout]) == 0
    if "--checkpoint" in flags:
        flags[flags.index("--checkpoint") + 1] = str(tmp_path / "ck2.npz")
        common = common[:-len(flags)] + flags
    assert tcli.main([*common, "-o", tout, "--device", "cpu"]) == 0
    np.testing.assert_allclose(tread(tout), jread(jout), rtol=0, atol=ATOL)
    want = ttv.denoise3D(cube, np.full(3, 1.0, np.float32),
                         iterations=int(flags[1]), FISTA=True,
                         lossy_duals=True, quiet=True, device="cpu")
    np.testing.assert_array_equal(tread(tout), want[0])


def test_api_warns_and_notes_memory(capsys):
    """``denoise3D(lossy_duals=True)`` warns unless quiet, as the JAX API
    does, and the memory note counts the duals at 2 bytes."""
    noisy = _cube((8, 8, 32))[0]
    mu = np.full(3, 2.0, np.float32)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        recon, _, _ = ttv.denoise3D(noisy, mu, iterations=6, FISTA=True,
                                    lossy_duals=True, quiet=False,
                                    device="cpu")
    assert any("lossy_duals" in str(x.message) for x in w)
    assert np.all(np.isfinite(recon))
    out = capsys.readouterr().out
    assert "holds 8 cube-size arrays (3 of them bfloat16 shadow duals)" in out
    assert f"≈ {noisy.nbytes * 6.5 / 2**30:.2f} GiB" in out
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ttv.denoise3D(noisy, mu, iterations=6, FISTA=True, lossy_duals=True,
                      quiet=True, device="cpu")
        jtv.denoise3D(noisy, mu, iterations=2, FISTA=True, lossy_duals=True,
                      quiet=True)
    assert not any("lossy_duals" in str(x.message) for x in w)


def test_lossy_validation_matches_jax():
    """The same refusals as the JAX package, with the same kinds of error:
    half-isotropic and non-Jia-Zhao options, and float64 data at run time.
    The engine's gates let lossy runs pair (the pair kernel rounds
    iteration 1's bfloat16 duals in the middle of the pair,
    tests/test_torch_lossy_pair.py) and keep them off the K-step and
    whole-run kernels, which refuse bfloat16 duals (their own tests)."""
    for kw, match in ((dict(ndim=4, isotropic_R=True), "half-isotropic"),
                      (dict(ndim=4, isotropic_Q=True), "half-isotropic"),
                      (dict(ndim=3, bc_mode=BCMode.MIRROR), "Jia-Zhao"),
                      (dict(ndim=3, bc_mode=BCMode.PERIODIC), "Jia-Zhao")):
        for cls in (JOptions, TOptions):
            with pytest.raises(ValueError, match=match):
                cls(iterations_fista=4, iterations_unacc=0, lossy_duals=True,
                    **kw)
    t = torch.from_numpy
    orig, li, lm = _cube((4, 4, 8))
    with pytest.raises(ValueError, match="float32"):
        tengine.run_solver(t(orig).double(), t(li).double(), t(lm).double(),
                           _opts("port", (4, 4, 8), 2))
    opts = _opts("port", S3, 20)
    f32 = torch.float32
    assert tengine._resolve_temporal(opts, S3, f32)
    assert not tengine._resolve_kstep(opts, S3, f32, True)
    assert not tengine._resident_gates(opts, S3, f32)


def test_byte_counts_take_bfloat16_duals():
    """``utils/perf.py``: a lossy 4D FISTA K=1 launch moves 11 × 4 + 8 × 2 =
    60 bytes per voxel (76 exact), a 3D one 9 × 4 + 6 × 2 = 48 (60), so the
    bound at config 4 is 60/76 of the exact one's; ``stop_ckpt_bytes``
    counts the duals of the state and of its checkpoint at 2 bytes."""
    cfg4 = (256, 256, 128, 128)
    vox = int(np.prod(cfg4))
    assert perf.launch_bytes(cfg4, True) == 76 * vox
    assert perf.launch_bytes(cfg4, True, d_itemsize=2) == 60 * vox
    assert perf.launch_bytes((4, 5, 6), True, d_itemsize=2) == 48 * 120
    assert perf.launch_bytes((4, 5, 6), False, d_itemsize=2) == 36 * 120
    exact = perf.launch_bound_seconds(cfg4, True, 1, 3.35e12, 67e12)
    lossy = perf.launch_bound_seconds(cfg4, True, 1, 3.35e12, 67e12,
                                      d_itemsize=2)
    assert lossy[1] == "bytes"
    assert lossy[0] == pytest.approx(exact[0] * 60 / 76, rel=1e-12)
    assert lossy[0] * 1e3 == pytest.approx(19.23, abs=0.01)
    opts = TOptions(ndim=4, iterations_fista=4, iterations_unacc=0,
                    stopping_relative_change=1e-3)
    lossy_opts = TOptions(ndim=4, iterations_fista=4, iterations_unacc=0,
                          stopping_relative_change=1e-3, lossy_duals=True)
    f32 = torch.float32
    assert tengine.stop_ckpt_bytes(opts, cfg4, f32) == 19 * 4 * vox
    assert tengine.stop_ckpt_bytes(lossy_opts, cfg4, f32) == \
        (11 * 4 + 8 * 2) * vox
