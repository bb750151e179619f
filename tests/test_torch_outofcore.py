"""Out-of-core runs in the port (``cytvdn_tpu_torch.solver.outofcore``)
and the K=1 kernel's operand halos (``kernels/fused.py``), on the CPU,
against the JAX package (``cytvdn_tpu.solver.outofcore``, its fused
Pallas kernel in interpret mode) and against the port's in-core runs.

On the CPU the wrappers run their plain versions. A slab run with halos
from the pre-update state, reassembled, is bitwise one in-core iteration,
and an out-of-core run's recon is bitwise the port's in-core run's, in
both modes; the sums add up in slab order, so the traces agree within
rtol 1e-5 (stream mode) and 2e-4 (temporal mode, sweep-final entries,
summed over each core in float32, the tolerance of
tests/test_outofcore.py). Against JAX: the state at rtol 2e-5 /
atol 2e-6 (tests/test_torch_fused.py's and tests/test_outofcore.py's
tolerance on the recon is 2e-6), the traces at rtol 2e-4. The kernel
itself is held bitwise against the plain version on the card
(tests/test_torch_cuda.py and ``chip_smoke.py`` phase 8).
"""

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from cytvdn_tpu.kernels.fused import fused_iteration as j_fused  # noqa: E402
from cytvdn_tpu.solver import outofcore as jooc  # noqa: E402
from cytvdn_tpu_torch import denoise3D, denoise4D  # noqa: E402
from cytvdn_tpu_torch.config import SolverOptions  # noqa: E402
from cytvdn_tpu_torch.kernels import fused as tfused  # noqa: E402
from cytvdn_tpu_torch.kernels import temporal as ttemporal  # noqa: E402
from cytvdn_tpu_torch.solver import outofcore as tooc  # noqa: E402

RTOL, ATOL = 2e-5, 2e-6


def _cube(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 0.5 + 2.0).astype(np.float32)


def _state(shape, fista, seed, dtype=np.float32):
    """A random state in the clip ball's range, the Jia-Zhao invariant
    held (each accumulator's leading slab along its axis is zero)."""
    rng = np.random.default_rng(seed)
    ndim = len(shape)
    orig = (rng.standard_normal(shape) * 0.5 + 2.0).astype(dtype)
    recon = (orig + rng.standard_normal(shape) * 0.05).astype(dtype)
    accs = [(rng.standard_normal(shape) * 0.2).astype(dtype)
            for _ in range(ndim)]
    ds = [(rng.standard_normal(shape) * 0.2).astype(dtype)
          for _ in range(ndim)] if fista else None
    for k in range(ndim):
        idx = [slice(None)] * ndim
        idx[k] = 0
        accs[k][tuple(idx)] = 0
        if fista:
            ds[k][tuple(idx)] = 0
    lambda_inv = np.linspace(0.2, 0.35, ndim).astype(dtype)
    lam_mu = np.linspace(1 / 32, 1 / 48, ndim).astype(dtype)
    return orig, recon, accs, ds, lambda_inv, lam_mu


def _halos(recon, accs, ds, a0, a1, fista):
    """Slab [a0, a1)'s seam operands from the cube's pre-update state, as
    the stream mode gives them: axis 0 from the neighbours (the own edge
    rows at the cube's edges), axis 1 the Jia-Zhao edge values."""
    n0 = recon.shape[0]
    r = recon[a0:a1]
    zcol = np.zeros_like(r[:, 0:1])
    h = {"prev0": recon[a0 - 1:a0] if a0 > 0 else r[0:1],
         "prev1": r[:, 0:1], "next1_recon": r[:, -1:], "next1_acc": zcol}
    if a1 < n0:
        h["next0_recon"] = recon[a1:a1 + 1]
        h["next0_acc"] = accs[0][a1:a1 + 1]
        if fista:
            h["next0_d"] = ds[0][a1:a1 + 1]
    else:
        h["next0_recon"] = r[-1:]
        h["next0_acc"] = np.zeros_like(r[-1:])
        if fista:
            h["next0_d"] = np.zeros_like(r[-1:])
    if fista:
        h["next1_d"] = zcol
    return {k: np.ascontiguousarray(v) for k, v in h.items()}


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _slab_run(state, a0, a1, rho, fista, step=tfused.fused_iteration):
    """One port iteration of slab [a0, a1) with halos; returns its state
    and sums."""
    orig, recon, accs, ds, li, lm = state
    h = {k: _t(v) for k, v in _halos(recon, accs, ds, a0, a1, fista).items()}
    r = _t(recon[a0:a1])
    a = [_t(x[a0:a1]) for x in accs]
    d = [_t(x[a0:a1]) for x in ds] if fista else None
    out = step(_t(orig[a0:a1]), r, a, d, torch.tensor(rho, dtype=r.dtype),
               _t(li), _t(lm), fista=fista, halos=h)
    return r, a, d, [float(x) for x in out[3:]]


# -- the K=1 kernel's halos ---------------------------------------------------

SLAB_CUBES = [(10, 6, 8, 16), (9, 7, 13), (11, 5, 4, 9)]


@pytest.mark.parametrize("where", ["first", "interior", "last"])
@pytest.mark.parametrize("fista", [True, False])
@pytest.mark.parametrize("shape", [(12, 6, 8, 16), (15, 7, 13)], ids=str)
def test_plain_halo_iteration_matches_jax_kernel(shape, fista, where):
    """The plain iteration with halos against the JAX fused kernel with
    the same halos (interpret mode), on the first, an interior and the
    last of three slabs, with nonzero halo values."""
    state = _state(shape, fista, seed=1)
    orig, recon, accs, ds, li, lm = state
    n = shape[0] // 3
    a0, a1 = {"first": (0, n), "interior": (n, 2 * n),
              "last": (2 * n, shape[0])}[where]
    h = _halos(recon, accs, ds, a0, a1, fista)
    r, a, d, bn, dn, dd = j_fused(
        jnp.asarray(orig[a0:a1]), jnp.asarray(recon[a0:a1]),
        tuple(jnp.asarray(x[a0:a1]) for x in accs),
        tuple(jnp.asarray(x[a0:a1]) for x in ds) if fista else None,
        jnp.float32(0.37), jnp.asarray(li), jnp.asarray(lm), fista=fista,
        interpret=True, halos={k: jnp.asarray(v) for k, v in h.items()})
    tr, ta, td, sums = _slab_run(state, a0, a1, 0.37, fista)
    np.testing.assert_allclose(tr.numpy(), np.asarray(r), rtol=RTOL,
                               atol=ATOL)
    for got, want in zip(ta + (td or []), list(a) + list(d or ())):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(sums, [float(bn), float(dn), float(dd)],
                               rtol=1e-5)


@pytest.mark.parametrize("n_slabs", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("fista", [True, False])
@pytest.mark.parametrize("shape", SLAB_CUBES, ids=str)
def test_slabs_with_halos_reassemble_bitwise(shape, fista, dtype, n_slabs):
    """A cube cut into ragged axis-0 slabs, each run with halos from the
    pre-update state and put back: bitwise one in-core iteration; the sums
    add up in slab order."""
    state = _state(shape, fista, seed=2, dtype=dtype)
    orig, recon, accs, ds, li, lm = state
    R, A = _t(recon), [_t(x) for x in accs]
    D = [_t(x) for x in ds] if fista else None
    want = tfused.fused_iteration_reference(
        _t(orig), R, A, D, torch.tensor(0.37, dtype=R.dtype), _t(li), _t(lm),
        fista=fista)
    got_r, got_a = recon.copy(), [x.copy() for x in accs]
    got_d = [x.copy() for x in ds] if fista else []
    total = np.zeros(3)
    for a0, a1 in tooc._slab_bounds(shape[0], n_slabs):
        r, a, d, sums = _slab_run(state, a0, a1, 0.37, fista)
        got_r[a0:a1] = r.numpy()
        for k in range(len(shape)):
            got_a[k][a0:a1] = a[k].numpy()
            if fista:
                got_d[k][a0:a1] = d[k].numpy()
        total += sums
    np.testing.assert_array_equal(got_r, R.numpy())
    for got, w in zip(got_a + got_d, A + (D or [])):
        np.testing.assert_array_equal(got, w.numpy())
    np.testing.assert_allclose(total, [float(x) for x in want[3:]],
                               rtol=1e-5 if dtype == np.float32 else 1e-12)


REFUSED_HALOS = {
    "inblock-prev2": ({"prev2": (3, 6, 1, 16)}, {}),
    "folded": ({"next2_recon": (3, 6, 1, 16)}, {}),
    "iso-partner": ({"next0_acc1": (1, 6, 8, 16)}, {}),
    "corner": ({"corner0": (1, 1, 8, 16)}, {}),
    "periodic": ({}, {"bc": 0}),
    "mirror": ({}, {"bc": 1}),
    "iso": ({}, {"iso_r": True}),
}


@pytest.mark.parametrize("case", sorted(REFUSED_HALOS))
def test_sharded_only_halos_refused(case):
    """The halo variants only a sharded run uses raise, naming ROADMAP
    Queue 1 item 8."""
    extra, kw = REFUSED_HALOS[case]
    state = _state((3, 6, 8, 16), True, seed=3)
    orig, recon, accs, ds, li, lm = state
    h = {k: _t(v) for k, v in _halos(recon, accs, ds, 0, 3, True).items()}
    h.update({k: torch.zeros(s) for k, s in extra.items()})
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        tfused.fused_iteration(_t(orig), _t(recon), [_t(x) for x in accs],
                               [_t(x) for x in ds], torch.tensor(0.3),
                               _t(li), _t(lm), fista=True, halos=h, **kw)


def test_halo_operands_checked():
    state = _state((3, 6, 8, 16), True, seed=4)
    orig, recon, accs, ds, li, lm = state
    args = (_t(orig), _t(recon), [_t(x) for x in accs], [_t(x) for x in ds],
            torch.tensor(0.3), _t(li), _t(lm))
    h = {k: _t(v) for k, v in _halos(recon, accs, ds, 0, 3, True).items()}
    # the sharded mirror runs' edge_next is not a keyword of the port
    with pytest.raises(TypeError, match="edge_next"):
        tfused.fused_iteration(*args, fista=True, halos=h,
                               edge_next=torch.ones(4))
    with pytest.raises(ValueError, match="next0_d"):
        tfused.fused_iteration(*args, fista=True,
                               halos={k: v for k, v in h.items()
                                      if k != "next0_d"})
    bad = dict(h, prev1=torch.zeros((3, 6, 1, 16)))
    with pytest.raises(ValueError, match="prev1"):
        tfused.fused_iteration(*args, fista=True, halos=bad)
    # unaccelerated runs take no shadow-dual halos
    h.pop("next0_d")
    h.pop("next1_d")
    tfused.fused_iteration(*args[:3], None, None, *args[5:], fista=False,
                           halos=h)


# -- out-of-core runs ---------------------------------------------------------

@pytest.mark.parametrize("n0,n_slabs", [(10, 3), (8, 4), (10, 4), (7, 7),
                                        (5, 9), (1, 1), (256, 4), (13, 5)])
def test_slab_bounds_match_jax(n0, n_slabs):
    assert tooc._slab_bounds(n0, n_slabs) == jooc._slab_bounds(n0, n_slabs)


C4, C3 = (10, 6, 8, 16), (12, 8, 16)
MU = {4: np.full(4, 1.0, np.float32), 3: np.full(3, 1.0, np.float32)}

INCORE = {
    # name: (shape, keywords of both runs, temporal_k, n_slabs)
    "stream-2-fista": (C4, dict(iterations=7, FISTA=True), 1, 2),
    "stream-3-fista": (C4, dict(iterations=7, FISTA=True), 1, 3),
    "stream-2-unaccelerated": (C4, dict(iterations=7, FISTA=False), 1, 2),
    "stream-3-unaccelerated": (C4, dict(iterations=7, FISTA=False), 1, 3),
    "stream-hybrid": (C4, dict(iterations=(4, 3)), 1, 3),
    "stream-3d": (C3, dict(iterations=6, FISTA=True), 1, 5),
    "temporal-2-2-fista": (C4, dict(iterations=7, FISTA=True), 2, 2),
    "temporal-3-3-fista": (C4, dict(iterations=7, FISTA=True), 3, 3),
    "temporal-2-5-fista": (C4, dict(iterations=7, FISTA=True), 5, 2),
    "temporal-2-2-unaccelerated": (C4, dict(iterations=7, FISTA=False), 2,
                                   2),
    "temporal-3-3-unaccelerated": (C4, dict(iterations=7, FISTA=False), 3,
                                   3),
    "temporal-2-5-unaccelerated": (C4, dict(iterations=7, FISTA=False), 5,
                                   2),
    "temporal-hybrid": ((9, 6, 8, 16), dict(iterations=(5, 4)), 3, 2),
    "temporal-3d-pairs": (C3, dict(iterations=(9, 5)), 4, 3),
}


def _sweep_ends(n_f, n_u, k):
    return sorted({min(i + k, n_f) - 1 for i in range(0, n_f, k)}
                  | {n_f + min(i + k, n_u) - 1 for i in range(0, n_u, k)})


@pytest.mark.parametrize("case", sorted(INCORE))
def test_outofcore_bitwise_incore(case):
    """The port's out-of-core run on the CPU against its in-core
    ``denoise3D/4D``: recon bitwise, traces within rtol 1e-5 (stream) and
    2e-4 at the sweep ends (temporal), zeros between."""
    shape, kw, k, n_slabs = INCORE[case]
    cube = _cube(shape, 5)
    mu = MU[len(shape)]
    incore = denoise4D if len(shape) == 4 else denoise3D
    want = incore(cube, mu, quiet=True, device="cpu", **kw)
    got = tooc.denoise_outofcore(cube, mu, n_slabs=n_slabs, temporal_k=k,
                                 device="cpu", **kw)
    np.testing.assert_array_equal(got[0], want[0])
    it = kw["iterations"]
    n_f, n_u = it if isinstance(it, tuple) else \
        ((it, 0) if kw.get("FISTA", True) else (0, it))
    idx = _sweep_ends(n_f, n_u, k)
    rtol = 1e-5 if k == 1 else 2e-4
    np.testing.assert_allclose(got[1][idx], want[1][idx], rtol=rtol)
    np.testing.assert_allclose(got[2][idx], want[2][idx], rtol=rtol)
    others = [i for i in range(n_f + n_u) if i not in idx]
    assert not got[1][others].any() and not got[2][others].any()


def test_temporal_margin_zero_row_keeps_the_last_slab_exact():
    """Under temporal blocking the last slab ends at the cube's last row
    and starts inside the cube: the kernels' axis-0 wrap at that global
    edge reads the slab's first accumulator row, which the load sets to
    zero. Without it the second sweep's last rows would differ."""
    cube = _cube(C4, 6)
    want = denoise4D(cube, MU[4], iterations=4, FISTA=False, quiet=True,
                     device="cpu")
    got = tooc.denoise_outofcore(cube, MU[4], iterations=4, FISTA=False,
                                 n_slabs=2, temporal_k=2, device="cpu")
    np.testing.assert_array_equal(got[0][-2:], want[0][-2:])


JAX_CASES = {
    "stream-fista": (C4, dict(iterations=5, FISTA=True, n_slabs=2)),
    "stream-unaccelerated": (C4, dict(iterations=5, FISTA=False, n_slabs=3)),
    "temporal-fista": (C4, dict(iterations=7, FISTA=True, n_slabs=2,
                                temporal_k=2)),
    "temporal-hybrid-3d": (C3, dict(iterations=(4, 3), n_slabs=2,
                                    temporal_k=2)),
    "stream-3d-stop": (C3, dict(iterations=60, FISTA=False, n_slabs=3,
                                stopping_relative_change=0.05)),
    "stream-mse": (C4, dict(iterations=5, FISTA=False, n_slabs=3,
                            reference_data="ref")),
    "temporal-mse": (C3, dict(iterations=6, FISTA=False, n_slabs=2,
                              temporal_k=3, reference_data="ref")),
}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_outofcore_matches_jax(case):
    """The port's ``denoise_outofcore`` on the CPU against the JAX one on
    the same cube: recon within rtol 2e-5 / atol 2e-6, traces (and the MSE
    trace) within rtol 2e-4, the same iterations run."""
    shape, kw = JAX_CASES[case]
    cube = _cube(shape, 7)
    mu = MU[len(shape)]
    if kw.get("reference_data") == "ref":
        kw = dict(kw, reference_data=_cube(shape, 8))
    want = jooc.denoise_outofcore(cube, mu, **kw)
    got = tooc.denoise_outofcore(cube, mu, device="cpu", **kw)
    assert len(got) == len(want)
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(np.nonzero(got[2])[0],
                                  np.nonzero(want[2])[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=1e-7)


def test_mse_traces_match_incore():
    """Stream mode: the SSE after every iteration; temporal mode: at the
    sweep ends (zeros between); both within rtol 1e-5 of the in-core
    trace."""
    cube, ref = _cube(C3, 9), _cube(C3, 10)
    want = denoise3D(cube, MU[3], iterations=6, FISTA=False, quiet=True,
                     device="cpu", reference_data=ref)
    stream = tooc.denoise_outofcore(cube, MU[3], iterations=6, FISTA=False,
                                    n_slabs=3, reference_data=ref,
                                    device="cpu")
    np.testing.assert_allclose(stream[3], want[3], rtol=1e-5)
    temporal = tooc.denoise_outofcore(cube, MU[3], iterations=6, FISTA=False,
                                      n_slabs=2, temporal_k=3,
                                      reference_data=ref, device="cpu")
    for i in (0, 3, 6):
        np.testing.assert_allclose(temporal[3][i], want[3][i], rtol=1e-5)
    assert not temporal[3][[1, 2, 4, 5]].any()
    np.testing.assert_array_equal(temporal[0], want[0])


def test_stream_stop_bitwise_incore():
    """A 3D stream-mode stop run stops at the in-core run's iteration with
    its recon bitwise (the traces are exact per iteration)."""
    cube = _cube(C3, 11)
    kw = dict(iterations=40, FISTA=False, quiet=True)
    full = denoise3D(cube, MU[3], device="cpu", **kw)[2]
    thr = float(full[:5].min()) * (1 - 1e-3)
    want = denoise3D(cube, MU[3], stopping_relative_change=thr,
                     device="cpu", **kw)
    got = tooc.denoise_outofcore(cube, MU[3], iterations=40, FISTA=False,
                                 stopping_relative_change=thr, n_slabs=4,
                                 device="cpu")
    n = int(np.count_nonzero(want[2]))
    assert 5 < n < 40 and int(np.count_nonzero(got[2])) == n
    np.testing.assert_array_equal(got[0], want[0])


def test_temporal_phase2_trace_slots_absolute():
    """A phase-1 stop does not shift the unaccelerated phase's trace
    slots: phase 2 records at n_f + j and stops at its first sweep, as the
    JAX solver does (tests/test_outofcore.py)."""
    cube = _cube(C3, 12)
    li = np.full(3, 16.0, np.float32)
    lm = np.full(3, 1 / 16.0, np.float32)
    probe = tooc.solve_outofcore_temporal(
        cube, li, lm, SolverOptions(ndim=3, iterations_fista=4,
                                    iterations_unacc=4), 2, 2, device="cpu")
    stop_at = float(probe["delta"][1]) * 1.01
    opts = SolverOptions(ndim=3, iterations_fista=4, iterations_unacc=4,
                         stopping_relative_change=stop_at)
    out = tooc.solve_outofcore_temporal(cube, li, lm, opts, 2, 2,
                                        device="cpu")
    d = out["delta"]
    assert 0 < d[1] < stop_at and d[2] == 0 and d[3] == 0
    assert d[4] == 0 and d[5] > 0
    assert int(out["iterations_run"]) == 6 and bool(out["early_stopped"])
    j = jooc.solve_outofcore_temporal(cube, li, lm, opts, 2, 2)
    np.testing.assert_array_equal(np.nonzero(d)[0], np.nonzero(j["delta"])[0])
    assert int(j["iterations_run"]) == 6


@pytest.mark.parametrize("k", [1, 3])
def test_cpu_run_launches_no_kernel(k, capsys):
    """On the CPU the plain versions run: no launch is counted, calls are;
    the memory note speaks of device memory."""
    before = (tfused.fused_iteration.launches,
              ttemporal.fused_pair_iteration.launches)
    calls = (tfused.fused_iteration.calls,
             ttemporal.fused_pair_iteration.calls)
    tooc.denoise_outofcore(_cube(C4, 13), MU[4], iterations=4, n_slabs=2,
                           temporal_k=k, quiet=False, device="cpu")
    assert (tfused.fused_iteration.launches,
            ttemporal.fused_pair_iteration.launches) == before
    # stream: 2 slabs x 4 iterations; temporal K=3: sweeps of 3 and 1
    # iterations over 2 slabs, one pair and one K=1 launch, then one K=1
    assert (tfused.fused_iteration.calls - calls[0],
            ttemporal.fused_pair_iteration.calls - calls[1]) == \
        ((8, 0) if k == 1 else (4, 2))
    assert "device memory" in capsys.readouterr().out


def test_traffic_counted():
    """``last_run`` counts the bytes each way: per stream sweep 2+2n
    cube-size arrays in (and the axis-0 halo rows), 1+2n out."""
    cube = _cube(C4, 14)
    tooc.denoise_outofcore(cube, MU[4], iterations=3, n_slabs=3,
                           device="cpu")
    run = tooc.last_run
    row = cube[0].nbytes
    # per sweep: prev0 3 rows, next0 recon/acc/d on two slabs, recon on one
    halo_rows = 3 + 2 * 3 + 1
    assert run["sweeps"] == 3
    assert run["h2d_bytes"] == 3 * (10 * cube.nbytes + halo_rows * row)
    assert run["d2h_bytes"] == 3 * 9 * cube.nbytes
    assert run["pinned_bytes"] == 0 and run["pin_seconds"] >= 0
    tooc.denoise_outofcore(cube, MU[4], iterations=2, n_slabs=2,
                           temporal_k=2, device="cpu")
    # one sweep: ext slabs of 7 rows in, cores of 5 rows out
    assert tooc.last_run["h2d_bytes"] == 10 * 14 * row
    assert tooc.last_run["d2h_bytes"] == 9 * 10 * row


# -- refusals -----------------------------------------------------------------

def test_refusals():
    cube = _cube(C4, 15)
    mu = MU[4]
    for kw, exc, match in (
            (dict(shard_w=2), NotImplementedError, "Queue 1 item 11"),
            (dict(shard_w=0), NotImplementedError, "Queue 1 item 11"),
            (dict(devices=["cuda:0"]), NotImplementedError, "Queue 1 item 11"),
            (dict(lossy_duals=True), NotImplementedError, "Queue 1 item 12"),
            (dict(n_slabs=4, temporal_k=5), ValueError, "temporal_k"),
            (dict(n_slabs=8), ValueError, "at least 2 rows")):
        with pytest.raises(exc, match=match):
            tooc.denoise_outofcore(cube, mu, iterations=4, device="cpu", **kw)
    with pytest.raises(ValueError, match="float32"):
        tooc.denoise_outofcore(cube.astype(np.float64), mu.astype(np.float64),
                               iterations=2, device="cpu")
    li, lm = np.full(4, 32.0, np.float32), np.full(4, 1 / 32, np.float32)
    for bad in (dict(bc_mode=0), dict(isotropic_R=True)):
        opts = SolverOptions(ndim=4, iterations_fista=2, iterations_unacc=0,
                             **bad)
        with pytest.raises(ValueError, match="Jia-Zhao anisotropic"):
            tooc.solve_outofcore(cube, li, lm, opts, 2, device="cpu")


# -- checkpoints --------------------------------------------------------------

class _Killed(Exception):
    pass


def _kill_at(monkeypatch, module, nth):
    """Make ``module._ckpt_save`` raise after its ``nth`` completed save;
    returns the list of the saved ``it_run``s."""
    real = module._ckpt_save
    calls = []

    def killing(*a, **kw):
        real(*a, **kw)
        calls.append(a[2])
        if len(calls) == nth:
            raise _Killed

    monkeypatch.setattr(module, "_ckpt_save", killing)
    return calls


KILL = {
    # name: (shape, keywords, nth save to kill after, its it_run)
    "stream": (C4, dict(iterations=(4, 3), n_slabs=2, checkpoint_every=2),
               1, 2),
    "temporal": (C3, dict(iterations=8, FISTA=False, n_slabs=2,
                          temporal_k=2, checkpoint_every=2), 1, 2),
    "temporal-phase2": (C3, dict(iterations=(4, 4), n_slabs=2, temporal_k=2,
                                 checkpoint_every=3), 2, 6),
    "stream-mse": ((10, 6, 16), dict(iterations=6, FISTA=False, n_slabs=2,
                                     checkpoint_every=2,
                                     reference_data="ref"), 1, 2),
}


@pytest.mark.parametrize("case", sorted(KILL))
def test_kill_and_resume_bitwise(tmp_path, monkeypatch, case):
    """A run killed after a checkpoint save and resumed gives the
    uninterrupted run's recon and traces bitwise; resuming the finished
    run changes nothing."""
    shape, kw, nth, it_at = KILL[case]
    cube = _cube(shape, 16)
    if kw.get("reference_data") == "ref":
        kw = dict(kw, reference_data=_cube(shape, 17))
    plain = {k: v for k, v in kw.items() if k != "checkpoint_every"}
    want = tooc.denoise_outofcore(cube, MU[len(shape)], device="cpu", **plain)
    ck = str(tmp_path / "ooc.npz")
    calls = _kill_at(monkeypatch, tooc, nth)
    with pytest.raises(_Killed):
        tooc.denoise_outofcore(cube, MU[len(shape)], checkpoint_path=ck,
                               device="cpu", **kw)
    assert calls[-1] == it_at
    monkeypatch.undo()
    got = tooc.denoise_outofcore(cube, MU[len(shape)], checkpoint_path=ck,
                                 resume=True, device="cpu", **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    again = tooc.denoise_outofcore(cube, MU[len(shape)], checkpoint_path=ck,
                                   resume=True, device="cpu", **kw)
    for g, a in zip(got, again):
        np.testing.assert_array_equal(g, a)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("k", [1, 2])
def test_checkpoints_cross_packages(tmp_path, monkeypatch, writer, k):
    """An out-of-core checkpoint written by either package, killed after
    its first save (mid-FISTA of a hybrid run), resumes in the other: the
    same meta, and the resumed run within the JAX tolerance of the other
    package's uninterrupted run."""
    cube = _cube(C3, 18)
    kw = dict(iterations=(4, 2), n_slabs=2, temporal_k=k, checkpoint_every=2)
    ck = str(tmp_path / f"{writer}.npz")
    first, second = (jooc, tooc) if writer == "jax" else (tooc, jooc)
    dev = {tooc: dict(device="cpu"), jooc: {}}
    _kill_at(monkeypatch, first, 1)
    with pytest.raises(_Killed):
        first.denoise_outofcore(cube, MU[3], checkpoint_path=ck, **kw,
                                **dev[first])
    monkeypatch.undo()
    with np.load(ck) as z:
        assert int(z["i"]) == 2
    got = second.denoise_outofcore(cube, MU[3], checkpoint_path=ck,
                                   resume=True, **kw, **dev[second])
    want = first.denoise_outofcore(cube, MU[3], n_slabs=2, temporal_k=k,
                                   iterations=(4, 2), **dev[first])
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[1], want[1], rtol=2e-4)
    with np.load(ck) as z:
        assert int(z["i"]) == 6


def test_schedule_mismatch_rejected(tmp_path):
    cube = _cube((10, 6, 16), 19)
    ck = str(tmp_path / "m.npz")
    tooc.denoise_outofcore(cube, MU[3], iterations=4, FISTA=False, n_slabs=2,
                           checkpoint_path=ck, checkpoint_every=2,
                           device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        tooc.denoise_outofcore(cube, MU[3], iterations=6, FISTA=False,
                               n_slabs=2, checkpoint_path=ck,
                               checkpoint_every=2, resume=True, device="cpu")
    with pytest.raises(ValueError, match="mode"):
        tooc.denoise_outofcore(cube, MU[3], iterations=4, FISTA=False,
                               n_slabs=2, temporal_k=2, checkpoint_path=ck,
                               resume=True, device="cpu")
