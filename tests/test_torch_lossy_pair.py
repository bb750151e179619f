"""Lossy shadow duals on the pair kernel (``lossy_duals``: the FISTA ``d``
stored as bfloat16) in the port, against the JAX package's pair kernel and
lossy runs on the CPU, and against the port's own K=1 lossy loop.

The port's pair rounds iteration 1's ``d`` onto the bfloat16 grid in the
middle of the pair, as the JAX kernel's ``qd1`` does
(``cytvdn_tpu/kernels/temporal.py:414-424, :474-482, :621-625``). On the
CPU its wrapper runs the plain version, two lossy K=1 steps (the K=1
step's ``copy_`` into the bfloat16 ``d`` rounds to nearest even), with
the mesh seams' rounding in ``_pair_seams``; the CUDA kernel's ``LOSSY``
instantiations are held bitwise against it on the card
(tests/test_torch_cuda.py, ``chip_smoke.py`` phase 11).

Tolerances, tests/test_torch_lossy.py's: a recon or ``b`` against the
JAX package's within atol 5e-7, rtol 0, over at most 6 iterations (past
that an f32 ulp between the packages can tip one bfloat16 rounding); the
bfloat16 ``d`` of one pair equal where the two packages' float32 ``d``
before rounding agree and within one bfloat16 ulp where they differ;
traces within rtol 2e-5. Everything the port runs in pairs is bitwise its
K=1 lossy loop.
"""

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

import cytvdn_tpu.kernels.temporal as T  # noqa: E402
from cytvdn_tpu import cli as jcli  # noqa: E402
from cytvdn_tpu.io.emd import read_emd as jread  # noqa: E402
import cytvdn_tpu_torch as ttv  # noqa: E402
from cytvdn_tpu_torch import cli as tcli  # noqa: E402
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

from test_torch_lossy import (  # noqa: E402
    ATOL, S3, S4, TRACE_RTOL, _bf16_ulp, _cube, _emulate, _jax_run,
    _launch_state, _opts, _port_run)
from test_torch_sharded import on_mesh  # noqa: E402

RHO1, RHO2 = 0.37, 0.52


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _port_pair(state, d_dtype, ref=None, a0=0, a1=None, bands=False):
    """One pair of the port on rows [a0, a1) of ``state`` (bands cut from
    the whole state with ``bands``), ``d`` of ``d_dtype``: its recon, b, d
    (as float32 numpy) and sums."""
    orig, recon, accs, ds, li, lm = state
    a1 = orig.shape[0] if a1 is None else a1
    kw = {}
    if bands:
        h, f0, l0 = ttemporal.halo0_bands(
            _t(orig), _t(recon), [_t(a) for a in accs],
            [_t(d).to(d_dtype) for d in ds], a0, a1)
        kw = dict(halos0=h, first0=f0, last0=l0)
    r = _t(recon[a0:a1])
    a = [_t(x[a0:a1]) for x in accs]
    d = [_t(x[a0:a1]).to(d_dtype) for x in ds]
    out = ttemporal.fused_pair_iteration(
        _t(orig[a0:a1]), r, a, d, torch.tensor(RHO1), torch.tensor(RHO2),
        _t(li), _t(lm), fista=True,
        ref=None if ref is None else _t(ref[a0:a1]), **kw)
    assert all(x.dtype == d_dtype for x in d)
    return (r.numpy(), [x.numpy() for x in a], [x.float().numpy() for x in d],
            np.array([float(x) for x in out[3:]]))


def _jax_pair(state, d_dtype, ref=None):
    """One pair of the JAX pair kernel (interpret mode), ``ds`` of
    ``d_dtype``."""
    orig, recon, accs, ds, li, lm = state
    out = T.fused_pair_iteration(
        jnp.asarray(orig), jnp.asarray(recon),
        tuple(jnp.asarray(a) for a in accs),
        tuple(jnp.asarray(d).astype(d_dtype) for d in ds),
        jnp.float32(RHO1), jnp.float32(RHO2), jnp.asarray(li),
        jnp.asarray(lm), fista=True, interpret=True,
        ref=None if ref is None else jnp.asarray(ref))
    assert all(d.dtype == d_dtype for d in out[2])
    return (np.asarray(out[0]), [np.asarray(a) for a in out[1]],
            [np.asarray(d.astype(jnp.float32)) for d in out[2]],
            np.array([float(x) for x in out[3:]]))


# -- one pair ------------------------------------------------------------------

@pytest.mark.parametrize("with_ref", [False, True])
@pytest.mark.parametrize("shape", [S3, S4], ids=["3d", "4d"])
def test_plain_lossy_pair_is_two_lossy_k1_steps(shape, with_ref):
    """The plain lossy pair (the wrapper on CPU tensors) is bitwise two
    lossy K=1 steps, d included (tests/test_lossy.py:93, one launch); its
    sums within rtol 1e-5 of theirs; with a reference cube its SSEs are
    the K=1 steps' squared errors; and it rounds in the middle of the
    pair: iteration 2's b reads iteration 1's rounded d, so its b is not
    the exact pair's, while its d is the exact pair's d rounded (iteration
    2's new d reads no old d)."""
    state = _launch_state(shape, seed=len(shape) + 40)
    orig, recon, accs, ds, li, lm = state
    ref = orig * np.float32(0.9) if with_ref else None
    got = _port_pair(state, torch.bfloat16, ref)
    r, a = _t(recon), [_t(x) for x in accs]
    d = [_t(x).to(torch.bfloat16) for x in ds]
    sums = []
    for rho in (RHO1, RHO2):
        out = tfused.fused_iteration(_t(orig), r, a, d, torch.tensor(rho),
                                     _t(li), _t(lm), fista=True)
        sums += [float(x) for x in out[3:]]
        if with_ref:
            sums.append(float(((r - _t(ref)) ** 2).double().sum()))
    if with_ref:
        sums = sums[:3] + sums[4:7] + [sums[3], sums[7]]
    np.testing.assert_array_equal(got[0], r.numpy())
    for k in range(len(shape)):
        np.testing.assert_array_equal(got[1][k], a[k].numpy())
        np.testing.assert_array_equal(got[2][k], d[k].float().numpy())
    np.testing.assert_allclose(got[3], sums, rtol=1e-5)
    exact = _port_pair(state, torch.float32, ref)
    assert any(not np.array_equal(g, e) for g, e in zip(got[1], exact[1]))
    for k in range(len(shape)):
        np.testing.assert_array_equal(
            got[2][k], round_bf16(torch.from_numpy(exact[2][k])).numpy())


@pytest.mark.parametrize("with_ref", [False, True])
@pytest.mark.parametrize("shape", [S3, S4], ids=["3d", "4d"])
def test_lossy_pair_matches_jax_pair_kernel(shape, with_ref):
    """One lossy pair, with and without a reference cube, against the JAX
    pair kernel with bfloat16 ``ds`` in interpret mode: recon and b within
    atol 5e-7, the sums within rtol 2e-5. ``d``: iteration 2's new d does
    not read iteration 1's d, so the exact pair from the same state gives
    each package's float32 d before rounding; where those agree the
    bfloat16 d are equal, where they differ within one bfloat16 ulp. Each
    package's bfloat16 d is its float32 d rounded to nearest even, and
    iteration 2's b reads iteration 1's d rounded (qd1): the JAX kernel's
    lossy b, not its exact b."""
    state = _launch_state(shape, seed=len(shape) + 50)
    ref = state[0] * np.float32(0.9) if with_ref else None
    got = _port_pair(state, torch.bfloat16, ref)
    want = _jax_pair(state, jnp.bfloat16, ref)
    got32 = _port_pair(state, torch.float32, ref)
    want32 = _jax_pair(state, jnp.float32, ref)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=ATOL)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got[3], want[3], rtol=TRACE_RTOL)
    for k in range(len(shape)):
        for d16, d32 in ((got[2][k], got32[2][k]), (want[2][k], want32[2][k])):
            np.testing.assert_array_equal(
                d16, round_bf16(torch.from_numpy(d32.copy())).numpy())
        same = got32[2][k] == want32[2][k]
        np.testing.assert_array_equal(got[2][k][same], want[2][k][same])
        diff = np.abs(got[2][k] - want[2][k])[~same]
        assert np.all(diff <= _bf16_ulp(want[2][k][~same]))
    # the JAX kernel's own mid-pair rounding shows in its b: the exact pair's
    # b differs from the lossy pair's by more than the tolerance
    assert max(np.max(np.abs(w16 - w32))
               for w16, w32 in zip(want[1], want32[1])) > 10 * ATOL


@pytest.mark.parametrize("n_slabs", [2, 3])
@pytest.mark.parametrize("shape", [(12, 5, 6, 8), (12, 9, 16)], ids=str)
def test_plain_lossy_pair_with_bands_reassembles(shape, n_slabs):
    """The plain lossy pair with ``halos0`` bands (bfloat16 d rows widened
    to float32 at the cut) on the first, interior and last slabs of a cube,
    put back: bitwise the whole cube's lossy pair, d included, the slabs'
    sums within rtol 1e-5 of its sums. The +1 shard's recomputed row-0 d
    of iteration 1 is rounded before iteration 2 reads it: without that
    rounding the last row's b of the slab before it would differ."""
    state = _launch_state(shape, seed=sum(shape) + n_slabs)
    n0 = shape[0]
    whole = _port_pair(state, torch.bfloat16)
    bounds = [n0 * i // n_slabs for i in range(n_slabs + 1)]
    sums = 0
    for a0, a1 in zip(bounds[:-1], bounds[1:]):
        got = _port_pair(state, torch.bfloat16, a0=a0, a1=a1, bands=True)
        sums = sums + got[3]
        np.testing.assert_array_equal(got[0], whole[0][a0:a1])
        for k in range(len(shape)):
            np.testing.assert_array_equal(got[1][k], whole[1][k][a0:a1])
            np.testing.assert_array_equal(got[2][k], whole[2][k][a0:a1])
    np.testing.assert_allclose(sums, whole[3], rtol=1e-5)
    h, _, _ = ttemporal.halo0_bands(
        *(_t(x) for x in state[:2]), [_t(a) for a in state[2]],
        [_t(d).to(torch.bfloat16) for d in state[3]], 4, 8)
    assert all(v.dtype == torch.float32 for v in h.values())


# -- the engine ----------------------------------------------------------------

def _both(monkeypatch, orig, li, lm, ref=None, **kw):
    """A lossy run in pairs (rows of any size pay) and the port's K=1 lossy
    loop (``temporal_pairs=False``) from the same input; the pair calls the
    first made."""
    monkeypatch.setattr(tengine, "PAIR_MIN_ROW_BYTES", 0)
    base = dict(ndim=orig.ndim, lossy_duals=True, **kw)
    rr = None if ref is None else _t(ref)
    calls = ttemporal.fused_pair_iteration.calls
    paired = _port_run(orig, li, lm, TOptions(**base), reference_data=rr,
                       keep_state=True)
    n_pairs = ttemporal.fused_pair_iteration.calls - calls
    k1 = _port_run(orig, li, lm, TOptions(**base, temporal_pairs=False),
                   reference_data=rr, keep_state=True)
    return paired, k1, n_pairs


def _assert_bitwise(got, want, keys=("recon",)):
    for key in keys:
        assert torch.equal(got[key], want[key]), key
    for g, w in zip(got.get("ds") or (), want.get("ds") or ()):
        assert g.dtype == torch.bfloat16 and torch.equal(g, w)
    assert got["iterations_run"] == want["iterations_run"]
    for key in ("b_norm", "delta") + (("mse",) if "mse" in got else ()):
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   rtol=1e-5)


@pytest.mark.parametrize("case", ["fixed-3d", "fixed-4d", "hybrid", "mse",
                                  "odd"])
def test_lossy_engine_pairs_equal_k1_loop(monkeypatch, case):
    """Lossy runs that pair (``PAIR_MIN_ROW_BYTES`` patched to 0): fixed
    3D and 4D, hybrid (the unaccelerated phase pairs too, with no duals),
    with a reference cube (the pair's SSE) and an odd count (one K=1
    remainder) are bitwise the port's K=1 lossy loop, the bfloat16 duals
    included, and the launch counters show the pairs; no K-step and no
    whole-run call."""
    shape, kw = {
        "fixed-3d": (S3, dict(iterations_fista=8, iterations_unacc=0)),
        "fixed-4d": (S4, dict(iterations_fista=8, iterations_unacc=0)),
        "hybrid": (S3, dict(iterations_fista=4, iterations_unacc=4)),
        "mse": (S4, dict(iterations_fista=6, iterations_unacc=0,
                         calculate_mse=True)),
        "odd": (S3, dict(iterations_fista=7, iterations_unacc=0)),
    }[case]
    orig, li, lm = _cube(shape, seed=61)
    ref = orig * np.float32(0.95) if kw.get("calculate_mse") else None
    kst = tkstep.fused_kstep_iteration.calls
    paired, k1, n_pairs = _both(monkeypatch, orig, li, lm, ref, **kw)
    assert tkstep.fused_kstep_iteration.calls == kst
    n_f, n_u = kw["iterations_fista"], kw["iterations_unacc"]
    assert n_pairs == n_f // 2 + n_u // 2
    _assert_bitwise(paired, k1)


def test_lossy_stop_run_pairs_behind_the_guard(monkeypatch):
    """A stop-aware lossy run pairs behind the guard (its block checkpoint
    holds the bfloat16 duals) and stops at the K=1 loop's iteration with
    its recon bitwise; so does a stop-aware MSE run."""
    orig, li, lm = _cube(S3, seed=5)
    for mse in (False, True):
        ref = orig * np.float32(0.95) if mse else None
        paired, k1, n_pairs = _both(
            monkeypatch, orig, li, lm, ref, iterations_fista=40,
            iterations_unacc=0, stopping_relative_change=3e-3,
            calculate_mse=mse)
        n = paired["iterations_run"]
        assert paired["early_stopped"] and 2 < n < 40
        assert n_pairs > 0
        _assert_bitwise(paired, k1)


@pytest.mark.parametrize("shape,n", [(S3, 12), (S4, 10)], ids=["3d", "4d"])
def test_lossy_pairs_keep_the_per_iteration_cadence(monkeypatch, shape, n):
    """A long lossy run in pairs is bitwise the every-iteration emulation
    (tests/test_lossy.py::_emulate, ``round_every=1``) and more than 1e-4
    from the every-second-iteration one, which a pair without its mid-pair
    rounding would give: the cadence is per iteration, not per pair."""
    orig, li, lm = _cube(shape, seed=3)
    paired, _, n_pairs = _both(monkeypatch, orig, li, lm,
                               iterations_fista=n, iterations_unacc=0)
    assert n_pairs == n // 2
    got = paired["recon"].numpy()
    np.testing.assert_array_equal(got, _emulate(orig, li, lm, n, 1))
    assert np.max(np.abs(got - _emulate(orig, li, lm, n, 2))) > 1e-4


@pytest.mark.parametrize("shape,n", [(S3, 5), (S4, 6)], ids=["3d", "4d"])
def test_lossy_pairs_match_jax_paired_run(monkeypatch, shape, n):
    """A lossy run of at most 6 iterations in pairs against the JAX
    engine's paired lossy run (its pair kernel in interpret mode): recon
    within atol 5e-7, traces within rtol 2e-5."""
    monkeypatch.setattr(tengine, "PAIR_MIN_ROW_BYTES", 0)
    orig, li, lm = _cube(shape, seed=2)
    calls = ttemporal.fused_pair_iteration.calls
    got = _port_run(orig, li, lm, _opts("port", shape, n))
    assert ttemporal.fused_pair_iteration.calls - calls == n // 2
    want = _jax_run(orig, li, lm, _opts("jax", shape, n, temporal_pairs=True))
    np.testing.assert_allclose(got["recon"].numpy(), np.asarray(want["recon"]),
                               rtol=0, atol=ATOL)
    for key in ("b_norm", "delta"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=TRACE_RTOL)


@pytest.mark.parametrize("every", [1, 3, 7])
def test_chunked_lossy_pair_runs_equal_unchunked(monkeypatch, every):
    """A lossy run that pairs, in chunks of 1, 3 and 7 iterations (no pair
    crosses a chunk's cap; the bfloat16 duals handed from chunk to chunk),
    is bitwise the unchunked run."""
    monkeypatch.setattr(tengine, "PAIR_MIN_ROW_BYTES", 0)
    orig, li, lm = _cube(S3, seed=7)
    opts = _opts("port", S3, 9)
    want = _port_run(orig, li, lm, opts)
    calls = ttemporal.fused_pair_iteration.calls
    got = tck.run_chunked(orig, li, lm, opts, None, every, device="cpu")
    assert (ttemporal.fused_pair_iteration.calls > calls) == (every > 1)
    np.testing.assert_array_equal(got["recon"], want["recon"].numpy())
    np.testing.assert_array_equal(got["delta"], want["delta"].numpy())


@pytest.mark.parametrize("shard,shape,iters", [
    ((2, 1, 1), (16, 6, 64), 6),
    ((2, 1, 1, 1), (8, 4, 6, 8), (5, 2))], ids=["3d", "4d-hybrid"])
def test_axis0_lossy_mesh_pairs_equal_single_device(monkeypatch, shard, shape,
                                                    iters):
    """A 2-rank gloo axis-0 lossy mesh that pairs (bands with the bfloat16
    d rows widened at the pack, the +1 shard's recomputed d rounded) is
    bitwise the single-device lossy run, every rank's block too (the JAX
    package: tests/test_lossy.py:216-217)."""
    monkeypatch.setattr(tengine, "PAIR_MIN_ROW_BYTES", 0)
    orig = _cube(shape, seed=13)[0]
    mu = np.full(len(shape), 1.0, np.float32)
    fn = ttv.denoise4D if len(shape) == 4 else ttv.denoise3D
    kw = dict(iterations=iters, FISTA=True, lossy_duals=True)
    want = fn(orig, mu, quiet=True, device="cpu", **kw)
    calls = ttemporal.fused_pair_iteration.calls
    res = on_mesh(2, lambda pg, r: denoise_sharded(
        orig, mu, shard=shard, group=pg, device="cpu", **kw))
    n_f, n_u = iters if isinstance(iters, tuple) else (iters, 0)
    assert ttemporal.fused_pair_iteration.calls - calls == \
        2 * (n_f // 2 + n_u // 2)
    np.testing.assert_array_equal(res[0]["recon"], want[0])
    for out in res:
        np.testing.assert_array_equal(out["block"], want[0][out["slices"]])
        np.testing.assert_allclose(out["delta"], want[2], rtol=1e-5)


# -- out of core, temporal mode ----------------------------------------------

@pytest.mark.parametrize("temporal_k", [2, 4])
@pytest.mark.parametrize("shape", [(12, 8, 64), (12, 6, 8, 16)],
                         ids=["3d", "4d"])
def test_outofcore_temporal_lossy_equals_incore(shape, temporal_k):
    """Out-of-core temporal mode with bfloat16 host and slab duals (its
    slabs' pairs and K=1 launches lossy) in 3 slabs is bitwise the in-core
    lossy run, recon and sweep-final traces; K=4 sweeps pair."""
    cube = _cube(shape, seed=27)[0]
    mu = np.full(len(shape), 1.0, np.float32)
    calls = ttemporal.fused_pair_iteration.calls
    got = tooc.denoise_outofcore(cube, mu, iterations=8, n_slabs=3,
                                 temporal_k=temporal_k, lossy_duals=True,
                                 device="cpu")
    assert (ttemporal.fused_pair_iteration.calls > calls) == (temporal_k > 2)
    fn = ttv.denoise4D if len(shape) == 4 else ttv.denoise3D
    want = fn(cube, mu, iterations=8, FISTA=True, lossy_duals=True,
              quiet=True, device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    ends = np.arange(temporal_k - 1, 8, temporal_k)
    np.testing.assert_allclose(got[2][ends], want[2][ends], rtol=1e-5)
    exact = tooc.denoise_outofcore(cube, mu, iterations=8, n_slabs=3,
                                   temporal_k=temporal_k, device="cpu")
    assert np.max(np.abs(got[0] - exact[0])) > 1e-6


def test_outofcore_temporal_lossy_kill_and_resume(tmp_path, monkeypatch):
    """A lossy temporal-mode run killed after its first checkpoint save
    resumes bitwise; the checkpoint holds the bfloat16 duals."""
    shape = (12, 8, 64)
    cube = _cube(shape, seed=29)[0]
    mu = np.full(3, 1.0, np.float32)
    kw = dict(iterations=8, n_slabs=3, temporal_k=4, lossy_duals=True,
              device="cpu")
    straight = tooc.denoise_outofcore(cube, mu, **kw)
    ck = str(tmp_path / "ooc.npz")
    real = tooc._ckpt_save

    def killing(*a, **k):
        real(*a, **k)
        raise KeyboardInterrupt

    monkeypatch.setattr(tooc, "_ckpt_save", killing)
    with pytest.raises(KeyboardInterrupt):
        tooc.denoise_outofcore(cube, mu, checkpoint_path=ck,
                               checkpoint_every=4, **kw)
    monkeypatch.undo()
    state, meta = tck.load_state(ck)
    assert meta["lossy"] and meta["mode"] == "temporal4"
    assert int(state["i"]) == 4 and state["ds"][0].dtype == torch.bfloat16
    got = tooc.denoise_outofcore(cube, mu, checkpoint_path=ck,
                                 checkpoint_every=4, resume=True, **kw)
    for g, w in zip(got, straight):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("temporal", ["2", "4"])
def test_cli_outofcore_temporal_lossy_matches_jax_cli(tmp_path, temporal):
    """``cytv-torch --device cpu --out-of-core 3 --temporal K --lossy-duals``
    against ``cytv`` with the same flags (recon within atol 5e-7), and
    bitwise the port's ``denoise_outofcore``."""
    cube = _cube((12, 8, 16), seed=31)[0]
    inp = str(tmp_path / "in.npy")
    np.save(inp, cube)
    common = ["-i", inp, "-m", "1.0", "-n", "6", "-f", "1", "--lossy-duals",
              "-v", "0", "--out-of-core", "3", "--temporal", temporal]
    jout, tout = str(tmp_path / "j.emd"), str(tmp_path / "t.emd")
    assert jcli.main([*common, "-o", jout]) == 0
    assert tcli.main([*common, "-o", tout, "--device", "cpu"]) == 0
    np.testing.assert_allclose(tread(tout), jread(jout), rtol=0, atol=ATOL)
    want = tooc.denoise_outofcore(cube, np.full(3, 1.0, np.float32),
                                  iterations=6, n_slabs=3,
                                  temporal_k=int(temporal), lossy_duals=True,
                                  device="cpu")
    np.testing.assert_array_equal(tread(tout), want[0])
