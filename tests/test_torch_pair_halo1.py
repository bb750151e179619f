"""The pair kernel's axis-1 bands (``halos1``) in the port, on the CPU:
the plain pair with column bands (``fused_pair_iteration_reference``,
which the wrapper runs for CPU tensors) against the JAX pair kernel with
``halos1`` in interpret mode, column shards put back together against one
pair of the whole cube, the wrapper's band checks, and the engine's paired
phase on axis-1 meshes against the JAX ``run_sharded`` that pairs there
(its Pallas kernels in interpret mode on the fake CPU devices) and against
the port's single-device run.

Tolerances (tests/test_torch_sharded_pair.py's): against the JAX kernel
and the JAX mesh runs the state within rtol 2e-5 / atol 2e-6 and the sums
and traces within rtol 1e-5; shards put back together are bitwise one pair
of the whole cube, their sums within rtol 1e-5 of its sums; mesh runs are
bitwise the port's single-device run, traces within rtol 1e-5. The CUDA
kernel's ``HALO1`` instantiations are held bitwise against the plain pair
and two K=1 ``HALO`` launches on the card (tests/test_torch_cuda.py and
``chip_smoke.py`` phase 9).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import cytvdn_tpu.kernels.temporal as T  # noqa: E402
import cytvdn_tpu.solver.engine as JE  # noqa: E402
from cytvdn_tpu.config import Backend as JBackend  # noqa: E402
from cytvdn_tpu.config import SolverOptions as JOptions  # noqa: E402
from cytvdn_tpu.parallel import sharded as jsharded  # noqa: E402
from cytvdn_tpu_torch import denoise3D, denoise4D  # noqa: E402
from cytvdn_tpu_torch.kernels import temporal as ttemporal  # noqa: E402
from cytvdn_tpu_torch.parallel import denoise_sharded  # noqa: E402
from cytvdn_tpu_torch.solver import engine as tengine  # noqa: E402

from test_torch_sharded import on_mesh  # noqa: E402
from test_torch_sharded_pair import (  # noqa: E402
    ATOL,
    RHO1,
    RHO2,
    RTOL,
    SUM_RTOL,
    _state,
    _t,
)


def _port_shard(state, j0, j1, fista, ref=None, whole_cube=False,
                drop=False):
    """The port's pair on columns [j0, j1) with bands cut from the whole
    state (``halo1_bands``; with ``drop`` a missing neighbour's left out);
    with ``whole_cube`` the pair of the whole cube without bands. Returns
    the shard's recon, accs, ds and sums."""
    orig, recon, accs, ds, li, lm = state
    if whole_cube:
        kw = {}
    else:
        h, f1, l1 = ttemporal.halo1_bands(
            _t(orig), _t(recon), [_t(a) for a in accs],
            [_t(d) for d in ds] if fista else None, j0, j1)
        if drop:
            h = {k: v for k, v in h.items()
                 if not (f1 and k.startswith("p_") or
                         l1 and k.startswith("n_"))}
        kw = dict(halos1=h, first1=f1, last1=l1)
    r = _t(recon[:, j0:j1])
    a = [_t(x[:, j0:j1]) for x in accs]
    d = [_t(x[:, j0:j1]) for x in ds] if fista else None
    out = ttemporal.fused_pair_iteration(
        _t(orig[:, j0:j1]), r, a, d, torch.tensor(RHO1), torch.tensor(RHO2),
        _t(li), _t(lm), fista=fista,
        ref=None if ref is None else _t(ref[:, j0:j1]), **kw)
    return r, a, d, np.array([float(x) for x in out[3:]])


# 4D and 3D cubes whose axis 1 cuts into shards of 2 and more columns
SHAPES = [(6, 8, 5, 7), (7, 9, 11)]
COLUMNS = {"first": (0, 2), "interior": (2, 5), "last": (5, 8)}


@pytest.mark.parametrize("with_ref", [False, True])
@pytest.mark.parametrize("where", sorted(COLUMNS))
@pytest.mark.parametrize("fista", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_pair_with_column_bands_matches_jax_kernel(shape, fista,
                                                         where, with_ref):
    """The plain pair with ``halos1`` against the JAX pair kernel with the
    same bands (interpret mode) on the first (2 columns), an interior (3)
    and the last (3, or 4 in 3D) column shard, with and without a
    reference cube."""
    state = _state(shape, fista, seed=31)
    orig, recon, accs, ds, li, lm = state
    j0, j1 = COLUMNS[where]
    if where == "last":
        j1 = shape[1]
    ref = orig * np.float32(0.9) if with_ref else None
    h, f1, l1 = ttemporal.halo1_bands(
        _t(orig), _t(recon), [_t(a) for a in accs],
        [_t(d) for d in ds] if fista else None, j0, j1)

    def cols(x):
        return jnp.asarray(x[:, j0:j1])

    want = T.fused_pair_iteration(
        cols(orig), cols(recon), tuple(cols(a) for a in accs),
        tuple(cols(d) for d in ds) if fista else None, jnp.float32(RHO1),
        jnp.float32(RHO2), jnp.asarray(li), jnp.asarray(lm), fista=fista,
        interpret=True,
        halos1={k: jnp.asarray(v.numpy()) for k, v in h.items()},
        first1=jnp.float32(f1), last1=jnp.float32(l1),
        ref=None if ref is None else cols(ref))
    r, a, d, sums = _port_shard(state, j0, j1, fista, ref)
    np.testing.assert_allclose(r.numpy(), np.asarray(want[0]), rtol=RTOL,
                               atol=ATOL)
    for k in range(len(shape)):
        np.testing.assert_allclose(a[k].numpy(), np.asarray(want[1][k]),
                                   rtol=RTOL, atol=ATOL)
        if fista:
            np.testing.assert_allclose(d[k].numpy(), np.asarray(want[2][k]),
                                       rtol=RTOL, atol=ATOL)
    n_sums = 8 if with_ref else 6
    np.testing.assert_allclose(sums, [float(x) for x in want[3:3 + n_sums]],
                               rtol=SUM_RTOL)


@pytest.mark.parametrize("with_ref", [False, True])
@pytest.mark.parametrize("fista,lossy", [(True, False), (False, False),
                                         (True, True)])
@pytest.mark.parametrize("shape,bounds", [
    ((6, 8, 5, 7), (0, 2, 4, 6, 8)),
    ((6, 8, 5, 7), (0, 3, 8)),
    ((7, 9, 11), (0, 2, 5, 7, 9)),
    ((5, 4, 3, 6), (0, 2, 4)),
], ids=str)
def test_plain_pair_column_shards_reassemble_to_one_pair(shape, bounds,
                                                         fista, with_ref,
                                                         lossy):
    """Column shards of 2 columns and more, each paired with bands from
    the pre-update state and put back: bitwise one pair of the whole cube,
    the shards' sums adding up to its sums. Lossy duals (FISTA): bfloat16
    ``ds``, the bands widened, the +1 shard's recomputed column-0 ``d``
    rounded (``round_bf16``)."""
    state = list(_state(shape, fista, seed=sum(shape) + len(bounds)))
    ref = state[0] * np.float32(0.9) if with_ref else None
    if lossy:
        # the duals on the bfloat16 grid, as a lossy run stores them
        state[3] = [_t(d).to(torch.bfloat16).float().numpy()
                    for d in state[3]]

    def run(j0, j1, whole=False):
        orig, recon, accs, ds, li, lm = state
        if whole:
            kw = {}
        else:
            dsb = [_t(d).to(torch.bfloat16) for d in ds] if lossy else \
                ([_t(d) for d in ds] if fista else None)
            h, f1, l1 = ttemporal.halo1_bands(
                _t(orig), _t(recon), [_t(a) for a in accs], dsb, j0, j1)
            kw = dict(halos1=h, first1=f1, last1=l1)
        r = _t(recon[:, j0:j1])
        a = [_t(x[:, j0:j1]) for x in accs]
        d = [_t(x[:, j0:j1]) for x in ds] if fista else None
        if lossy:
            d = [x.to(torch.bfloat16) for x in d]
        out = ttemporal.fused_pair_iteration(
            _t(orig[:, j0:j1]), r, a, d, torch.tensor(RHO1),
            torch.tensor(RHO2), _t(li), _t(lm), fista=fista,
            ref=None if ref is None else _t(ref[:, j0:j1]), **kw)
        return [r, *a, *(d or [])], np.array([float(x) for x in out[3:]])

    whole, wsums = run(0, shape[1], whole=True)
    sums = 0
    for j0, j1 in zip(bounds[:-1], bounds[1:]):
        got, s = run(j0, j1)
        sums = sums + s
        for x, w in zip(got, whole):
            assert x.dtype == w.dtype and torch.equal(x, w[:, j0:j1])
    np.testing.assert_allclose(sums, wsums, rtol=SUM_RTOL)


@pytest.mark.parametrize("fista", [True, False])
def test_last_shard_reads_no_own_column0_wrap(fista):
    """On the last column shard the forward difference of the last column
    is the Jia-Zhao zero, not the shard's own column 0, whose axis-1
    accumulator is nonzero here (it is the cube's column 4): bitwise the
    whole cube's pair."""
    shape = (6, 8, 5, 7)
    state = _state(shape, fista, seed=41)
    assert np.abs(state[2][1][:, 4]).max() > 0
    wr, wa, _, _ = _port_shard(state, 0, 8, fista, whole_cube=True)
    r, a, _, _ = _port_shard(state, 4, 8, fista)
    assert torch.equal(r, wr[:, 4:]) and torch.equal(a[1], wa[1][:, 4:])


@pytest.mark.parametrize("where", ["first", "last"])
@pytest.mark.parametrize("fista", [True, False])
def test_missing_neighbour_column_bands_may_be_left_out(fista, where):
    """On the first and the last column shard the missing neighbour's
    bands (which the engine does not send) may be left out: the same state
    and sums as with zero bands."""
    shape = (6, 8, 5, 7)
    state = _state(shape, fista, seed=42)
    j0, j1 = (0, 3) if where == "first" else (5, 8)
    wr, wa, wd, wsums = _port_shard(state, j0, j1, fista)
    r, a, d, sums = _port_shard(state, j0, j1, fista, drop=True)
    assert torch.equal(r, wr)
    assert all(torch.equal(x, y) for x, y in zip(a + (d or []),
                                                 wa + (wd or [])))
    np.testing.assert_array_equal(sums, wsums)


def test_pair_wrapper_checks_the_column_bands():
    """A missing band, an extra band, a band of the wrong shape, a
    non-contiguous band, missing edge flags, a 1-column shard, and
    ``halos0`` with ``halos1``: each refused, on the CPU as on the card."""
    shape = (6, 8, 5, 7)
    orig, recon, accs, ds, li, lm = _state(shape, True, seed=43)
    h, f1, l1 = ttemporal.halo1_bands(
        _t(orig), _t(recon), [_t(a) for a in accs], [_t(d) for d in ds],
        2, 5)
    h0, f0, l0 = ttemporal.halo0_bands(
        _t(orig[:, 2:5]), _t(recon[:, 2:5]), [_t(a[:, 2:5]) for a in accs],
        [_t(d[:, 2:5]) for d in ds], 0, 6)

    def call(**kw):
        return ttemporal.fused_pair_iteration(
            _t(orig[:, 2:5]), _t(recon[:, 2:5]),
            [_t(a[:, 2:5]) for a in accs], [_t(d[:, 2:5]) for d in ds],
            torch.tensor(RHO1), torch.tensor(RHO2), _t(li), _t(lm),
            fista=True, **kw)

    bad = dict(h)
    del bad["n_d1_c1"]
    with pytest.raises(ValueError, match="n_d1_c1"):
        call(halos1=bad, first1=f1, last1=l1)
    with pytest.raises(ValueError, match="unexpected"):
        call(halos1=dict(h, n_acc0_r1=h["n_acc0_c0"]), first1=f1, last1=l1)
    with pytest.raises(ValueError, match="p_r0_m2"):
        call(halos1=dict(h, p_r0_m2=h["p_r0_m2"][:1].clone()), first1=f1,
             last1=l1)
    wide = torch.zeros((6, 2, 5, 7))
    with pytest.raises(ValueError, match="n_orig_c0"):
        call(halos1=dict(h, n_orig_c0=wide[:, :1]), first1=f1, last1=l1)
    with pytest.raises(ValueError, match="first1 and last1"):
        call(halos1=h)
    with pytest.raises(ValueError, match="one split axis"):
        call(halos1=h, first1=f1, last1=l1, halos0=h0, first0=f0, last0=l0)
    with pytest.raises(ValueError, match="one split axis"):
        ttemporal.fused_pair_iteration_reference(
            _t(orig[:, 2:5]), _t(recon[:, 2:5]),
            [_t(a[:, 2:5]) for a in accs], [_t(d[:, 2:5]) for d in ds],
            torch.tensor(RHO1), torch.tensor(RHO2), _t(li), _t(lm),
            fista=True, halos1=h, first1=f1, last1=l1, halos0=h0, first0=f0,
            last0=l0)
    one = {k: v[:, :1].clone() for k, v in h.items()}
    with pytest.raises(ValueError, match="2 columns"):
        ttemporal.fused_pair_iteration(
            _t(orig[:, 2:3]), _t(recon[:, 2:3]),
            [_t(a[:, 2:3]) for a in accs], [_t(d[:, 2:3]) for d in ds],
            torch.tensor(RHO1), torch.tensor(RHO2), _t(li), _t(lm),
            fista=True, halos1=one, first1=False, last1=False)
    with pytest.raises(ValueError, match="2 columns"):
        ttemporal.halo1_bands(_t(orig), _t(recon), [_t(a) for a in accs],
                              None, 1, 5)


# -- the engine's paired phase on axis-1 meshes -------------------------------

MESHES = [((8, 8, 6, 16), (1, 2, 1, 1)), ((8, 16, 6, 16), (1, 4, 1, 1)),
          ((8, 16, 6, 16), (1, 8, 1, 1)), ((6, 12, 64), (1, 4, 1))]
RUNS = {"fixed": dict(iterations=6, FISTA=True),
        "hybrid": dict(iterations=(3, 2)),
        "mse": dict(iterations=5, FISTA=True, reference=True),
        "lossy": dict(iterations=4, FISTA=True, lossy_duals=True)}
CASES = [(shape, shard, run) for shape, shard in MESHES
         for run in ("fixed", "hybrid")] + [
    (MESHES[0][0], MESHES[0][1], "mse"), (MESHES[3][0], MESHES[3][1], "mse"),
    (MESHES[0][0], MESHES[0][1], "lossy"),
    (MESHES[3][0], MESHES[3][1], "lossy")]


def _count_pairs(monkeypatch):
    """Record the engine's pair calls (on every rank's thread): True for a
    call with ``halos1``."""
    calls = []
    real = tengine.fused_pair_iteration

    def counted(*args, **kw):
        calls.append(kw.get("halos1") is not None)
        return real(*args, **kw)

    monkeypatch.setattr(tengine, "fused_pair_iteration", counted)
    return calls


def _scalars(nd):
    # denoise3D/4D's lambda for mu = 1 (tests/test_torch_sharded.py)
    li = np.full(nd, 32.0 if nd == 4 else 16.0, np.float32)
    return li, np.float32(1) / li


@pytest.mark.parametrize("shape,shard,run", CASES, ids=str)
def test_axis1_mesh_pairs_match_jax_and_single_device(monkeypatch, shape,
                                                      shard, run):
    """The engine's paired phase on an axis-1 mesh (column bands exchanged
    over gloo, the port's plain pair with ``halos1``; ``PAIR_MIN_ROW_BYTES``
    lifted) against the JAX ``run_sharded`` that pairs with ``halos1``
    (``backend="pallas"``, interpret mode on the fake CPU devices) and
    bitwise the port's single-device run: fixed, hybrid, MSE and lossy
    schedules, every pair of every rank with ``halos1``."""
    monkeypatch.setattr(tengine, "PAIR_MIN_ROW_BYTES", 0)
    kw = dict(RUNS[run])
    cube = (np.random.default_rng(sum(shape)).standard_normal(shape) * 0.5
            + 2.0).astype(np.float32)
    ref = (cube * np.float32(0.9)) if kw.pop("reference", False) else None
    n_f, n_u = kw["iterations"] if isinstance(kw["iterations"], tuple) \
        else (kw["iterations"], 0)
    nd = len(shape)
    li, lm = _scalars(nd)
    jopts = JOptions(ndim=nd, iterations_fista=n_f, iterations_unacc=n_u,
                     backend=JBackend.PALLAS, calculate_mse=ref is not None,
                     lossy_duals=bool(kw.get("lossy_duals")))
    local = (shape[0], shape[1] // shard[1]) + tuple(shape[2:])
    # the JAX mesh run pairs with halos1 too
    assert JE._resolve_temporal(jopts, local, jnp.float32,
                                type("C", (), {"split_axes": (1,)})())
    want = jsharded.run_sharded(cube, li, lm, jopts, reference_data=ref,
                                shard=shard)
    single_fn = denoise4D if nd == 4 else denoise3D
    single = single_fn(cube, np.full(nd, 1.0, np.float32), quiet=True,
                       device="cpu", reference_data=ref, **kw)
    calls = _count_pairs(monkeypatch)
    n = int(np.prod(shard))
    res = on_mesh(n, lambda pg, r: denoise_sharded(
        cube, 1.0, shard=shard, group=pg, device="cpu", reference_data=ref,
        **kw))
    assert len(calls) == n * (n_f // 2 + n_u // 2) and all(calls)
    np.testing.assert_array_equal(res[0]["recon"], single[0])
    np.testing.assert_allclose(res[0]["recon"], np.asarray(want["recon"]),
                               rtol=RTOL, atol=ATOL)
    keys = ("b_norm", "delta") + (("mse",) if ref is not None else ())
    for r, out in enumerate(res):
        np.testing.assert_array_equal(out["block"],
                                      single[0][out["slices"]])
        for i, key in enumerate(keys):
            np.testing.assert_allclose(out[key], np.asarray(want[key]),
                                       rtol=SUM_RTOL)
            np.testing.assert_allclose(out[key], single[1 + i],
                                       rtol=SUM_RTOL)


@pytest.mark.parametrize("shape,shard", [MESHES[0], MESHES[3]], ids=str)
def test_axis1_mesh_stop_run_pairs(monkeypatch, shape, shard):
    """A stop-aware run on an axis-1 mesh: the prologue, ``halos1`` pairs
    behind the guard and the K=1 loop's exact stop read only the
    all-reduced deltas, and stop where the JAX ``run_sharded`` and the
    port's single-device run stop, recon bitwise the latter's."""
    monkeypatch.setattr(tengine, "PAIR_MIN_ROW_BYTES", 0)
    cube = (np.random.default_rng(5).standard_normal(shape) * 0.5
            + 2.0).astype(np.float32)
    nd = len(shape)
    single_fn = denoise4D if nd == 4 else denoise3D
    mu = np.full(nd, 1.0, np.float32)
    fixed = single_fn(cube, mu, iterations=30, FISTA=True, quiet=True,
                      device="cpu")[2]
    # between the 17th and 18th deltas, far from both
    thr = float(np.sqrt(fixed[16] * fixed[17]))
    single = single_fn(cube, mu, iterations=30, FISTA=True, quiet=True,
                       device="cpu", stopping_relative_change=thr)
    stop = int(np.count_nonzero(single[2]))
    assert stop == 18
    li, lm = _scalars(nd)
    want = jsharded.run_sharded(
        cube, li, lm, JOptions(ndim=nd, iterations_fista=30,
                               iterations_unacc=0, backend=JBackend.PALLAS,
                               stopping_relative_change=thr), shard=shard)
    calls = _count_pairs(monkeypatch)
    n = int(np.prod(shard))
    res = on_mesh(n, lambda pg, r: denoise_sharded(
        cube, 1.0, iterations=30, FISTA=True, shard=shard, group=pg,
        device="cpu", stopping_relative_change=thr))
    assert calls and all(calls)
    assert int(np.count_nonzero(np.asarray(want["delta"]))) == stop
    for out in res:
        assert out["iterations_run"] == stop
        np.testing.assert_array_equal(out["block"],
                                      single[0][out["slices"]])
        np.testing.assert_allclose(out["delta"], single[2], rtol=SUM_RTOL)
    np.testing.assert_allclose(res[0]["recon"], np.asarray(want["recon"]),
                               rtol=RTOL, atol=ATOL)
