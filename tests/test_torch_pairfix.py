"""Pairs on 2D grids (meshes split on axes 0 and 1) in the port, on the
CPU: the seam repair ``parallel/pairfix.py::repair_axis1_seams`` against
the JAX package's on the same pre-pair state and each package's own pair
outputs, and the engine's paired phase on 2D grids (ranks as gloo
threads, ``PAIR_MIN_ROW_BYTES`` patched to 0 and ``pairfix.PAIR_2D_GRIDS``
set) against the port's
single-device run and its K=1 mesh run, and against the JAX
``run_sharded`` that pairs there with its own repair (its Pallas kernels
in interpret mode on the fake CPU devices): the cases of
tests/test_temporal.py's ``test_sharded_pairs_2d_grid`` and
``test_pair_mse_sharded_2d_grid_matches_single`` and of
tests/test_lossy.py's 2D-grid case, and a stop run with a forced guard
beat.

Tolerances: the port's repaired state is bitwise one pair of the whole
cube, and mesh runs are bitwise the port's single-device and K=1 mesh
runs (recon, accumulators, shadow duals), traces within rtol 1e-5;
against the JAX repair and the JAX mesh runs the state within rtol 2e-5 /
atol 2e-6 (tests/test_torch_sharded_pair.py's), the sums and the MSE
trace within rtol 1e-5, b_norm within rtol 2e-5 and delta within rtol
2e-4 (tests/test_temporal.py's 2D-grid tolerances).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import cytvdn_tpu.kernels.temporal as T  # noqa: E402
import cytvdn_tpu.solver.engine as JE  # noqa: E402
from cytvdn_tpu.config import Backend as JBackend  # noqa: E402
from cytvdn_tpu.config import BCMode as JBCMode  # noqa: E402
from cytvdn_tpu.config import SolverOptions as JOptions  # noqa: E402
from cytvdn_tpu.parallel import sharded as jsharded  # noqa: E402
from cytvdn_tpu.parallel.halo import MeshComm as JMeshComm  # noqa: E402
from cytvdn_tpu.parallel.pairfix import (  # noqa: E402
    repair_axis1_seams as jrepair,
)
from cytvdn_tpu_torch.config import SolverOptions as TOptions  # noqa: E402
from cytvdn_tpu_torch.kernels import temporal as ttemporal  # noqa: E402
from cytvdn_tpu_torch.parallel import MeshComm, pairfix  # noqa: E402
from cytvdn_tpu_torch.parallel import run_sharded  # noqa: E402
from cytvdn_tpu_torch.parallel import sharded as tsharded  # noqa: E402
from cytvdn_tpu_torch.parallel.multihost import (  # noqa: E402
    block_slices,
    load_sharded_block,
    rank_coords,
)
from cytvdn_tpu_torch.solver import engine as tengine  # noqa: E402
from cytvdn_tpu_torch.utils.state import to_numpy  # noqa: E402

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

# -- the repair of one pair, against the JAX repair ---------------------------


def _port_pairs(state, grid, fista, ref):
    """Every shard of ``grid`` (2D: rows x columns) paired by the port with
    its axis-0 bands and repaired, ranks as gloo threads: returns per rank
    its repaired recon, accs, ds and corrected sums."""
    orig, recon, accs, ds, li, lm = state
    n0, n1 = orig.shape[:2]
    h0, w1 = n0 // grid[0], n1 // grid[1]

    def run(pg, rank):
        i, j = divmod(rank, grid[1])
        cols = slice(j * w1, (j + 1) * w1)
        a0, a1 = i * h0, (i + 1) * h0

        def cut(x):
            return x[:, cols]

        h, f0, l0 = ttemporal.halo0_bands(
            _t(cut(orig)), _t(cut(recon)), [_t(cut(a)) for a in accs],
            [_t(cut(d)) for d in ds] if fista else None, a0, a1)
        comm = MeshComm(pg, tuple(grid) + (1,) * (orig.ndim - 2), rank)
        o = _t(orig[a0:a1, cols])
        r = _t(recon[a0:a1, cols])
        a = [_t(x[a0:a1, cols]) for x in accs]
        d = [_t(x[a0:a1, cols]) for x in ds] if fista else None
        rs = _t(ref[a0:a1, cols]) if ref is not None else None
        oc = pairfix.orig_columns(comm, o)
        pre = pairfix.edge_columns(comm, r, a, d)
        rho1, rho2 = torch.tensor(RHO1), torch.tensor(RHO2)
        out = ttemporal.fused_pair_iteration(
            o, r, a, d, rho1, rho2, _t(li), _t(lm), fista=fista, ref=rs,
            halos0=h, first0=f0, last0=l0)
        sums = pairfix.repair_axis1_seams(
            comm, oc, pre, r, a, d, rho1, rho2, _t(li), _t(lm),
            torch.stack(out[3:]), rs)
        return r, a, d, sums.numpy()

    return on_mesh(grid[0] * grid[1], run)


def _jax_pairs(state, grid, fista, ref):
    """The same with the JAX pair kernel (interpret mode, axis-0 bands
    from the same pre-pair state) and the JAX repair under ``shard_map``
    on a (rows, columns) mesh of the fake devices: the repaired state and
    every shard's corrected sums (and SSE), as whole arrays."""
    from jax.sharding import Mesh, PartitionSpec as P

    orig, recon, accs, ds, li, lm = state
    nd = orig.ndim
    n0, n1 = orig.shape[:2]
    h0, w1 = n0 // grid[0], n1 // grid[1]
    outs = np.zeros(tuple(grid) + (6,), np.float32)
    sse = np.zeros(tuple(grid) + (2,), np.float32)
    kr, ka, kd = np.empty_like(recon), [np.empty_like(a) for a in accs], \
        [np.empty_like(d) for d in ds] if fista else None
    for i in range(grid[0]):
        for j in range(grid[1]):
            cols = slice(j * w1, (j + 1) * w1)
            rows = slice(i * h0, (i + 1) * h0)

            def cut(x):
                return x[:, cols]

            h, f0, l0 = ttemporal.halo0_bands(
                _t(cut(orig)), _t(cut(recon)), [_t(cut(a)) for a in accs],
                [_t(cut(d)) for d in ds] if fista else None, rows.start,
                rows.stop)

            def blk(x):
                return jnp.asarray(x[rows, cols])

            got = T.fused_pair_iteration(
                blk(orig), blk(recon), tuple(blk(a) for a in accs),
                tuple(blk(d) for d in ds) if fista else None,
                jnp.float32(RHO1), jnp.float32(RHO2), jnp.asarray(li),
                jnp.asarray(lm), fista=fista, interpret=True,
                halos0={k: jnp.asarray(v.numpy()) for k, v in h.items()},
                first0=jnp.float32(f0), last0=jnp.float32(l0),
                ref=None if ref is None else blk(ref))
            kr[rows, cols] = np.asarray(got[0])
            for k in range(nd):
                ka[k][rows, cols] = np.asarray(got[1][k])
                if fista:
                    kd[k][rows, cols] = np.asarray(got[2][k])
            outs[i, j] = [float(x) for x in got[3:9]]
            if ref is not None:
                sse[i, j] = [float(got[9]), float(got[10])]
    mesh = Mesh(np.array(jax.devices()[:grid[0] * grid[1]]).reshape(grid),
                ("x0", "x1"))
    spec = P("x0", "x1")
    n_state = 1 + nd * (2 if fista else 1)

    def body(*xs):
        comm = JMeshComm({0: "x0", 1: "x1"}, JBCMode.JIA_ZHAO)
        o, r0 = xs[0], xs[1]
        a0 = tuple(xs[2:2 + nd])
        d0 = tuple(xs[2 + nd:2 + 2 * nd]) if fista else None
        k = 2 + (2 if fista else 1) * nd
        r2, a2 = xs[k], tuple(xs[k + 1:k + 1 + nd])
        d2 = tuple(xs[k + 1 + nd:k + 1 + 2 * nd]) if fista else None
        k += n_state
        sums = tuple(xs[k].reshape(6))
        rf = xs[k + 2] if ref is not None else None
        s12 = tuple(xs[k + 1].reshape(2)) if ref is not None else None
        r2, a2, d2, sums, s12 = jrepair(
            comm, o, r0, a0, d0, r2, a2, d2, jnp.float32(RHO1),
            jnp.float32(RHO2), jnp.asarray(li), jnp.asarray(lm), sums,
            ref=rf, sse=s12)
        out = [r2, *a2, *(d2 or ()), jnp.stack(sums).reshape(1, 1, 6)]
        if ref is not None:
            out.append(jnp.stack(s12).reshape(1, 1, 2))
        return tuple(out)

    args = [orig, recon, *accs, *(ds or []), kr, *ka, *(kd or []), outs,
            sse] + ([ref] if ref is not None else [])
    n_out = n_state + 1 + (ref is not None)
    fn = jax.jit(jax.shard_map(body, mesh=mesh,
                               in_specs=(spec,) * len(args),
                               out_specs=(spec,) * n_out, check_vma=False))
    got = [np.asarray(x) for x in fn(*[jnp.asarray(a) for a in args])]
    sums = got[n_state]
    if ref is not None:
        sums = np.concatenate([sums, got[n_state + 1]], axis=-1)
    return got[:n_state], sums


@pytest.mark.parametrize("with_ref", [False, True])
@pytest.mark.parametrize("fista", [True, False])
@pytest.mark.parametrize("shape,grid", [((8, 12, 5, 7), (2, 2)),
                                        ((8, 16, 5, 6), (2, 4)),
                                        ((12, 8, 9), (3, 2))], ids=str)
def test_repair_matches_jax_repair(shape, grid, fista, with_ref):
    """One pair on every shard of a 2D grid (shards of 6 and 4 columns,
    3D and 4D) from the same pre-pair state: the port's plain pair with
    axis-0 bands and its repair, against the JAX pair kernel and the JAX
    repair; the port's repaired state bitwise one pair of the whole cube
    and its corrected sums adding up to that pair's sums."""
    state = _state(shape, fista, seed=sum(shape) + grid[1])
    orig, recon, accs, ds, li, lm = state
    ref = orig * np.float32(0.9) if with_ref else None
    res = _port_pairs(state, grid, fista, ref)
    jstate, jsums = _jax_pairs(state, grid, fista, ref)
    wr, wa = _t(recon), [_t(a) for a in accs]
    wd = [_t(d) for d in ds] if fista else None
    wout = ttemporal.fused_pair_iteration(
        _t(orig), wr, wa, wd, torch.tensor(RHO1), torch.tensor(RHO2),
        _t(li), _t(lm), fista=fista, ref=None if ref is None else _t(ref))
    whole = [wr, *wa, *(wd or [])]
    n0, n1 = shape[:2]
    h0, w1 = n0 // grid[0], n1 // grid[1]
    total = 0
    for rank, (r, a, d, sums) in enumerate(res):
        i, j = divmod(rank, grid[1])
        blk = (slice(i * h0, (i + 1) * h0), slice(j * w1, (j + 1) * w1))
        for x, w, jx in zip([r, *a, *(d or [])], whole, jstate):
            assert torch.equal(x, w[blk])
            np.testing.assert_allclose(x.numpy(), jx[blk], rtol=RTOL,
                                       atol=ATOL)
        np.testing.assert_allclose(sums, jsums[i, j], rtol=SUM_RTOL)
        total = total + sums.astype(np.float64)
    np.testing.assert_allclose(total, [float(x) for x in wout[3:]],
                               rtol=SUM_RTOL)


# -- the engine's pairs on 2D grids --------------------------------------------

def _pairs_everywhere(monkeypatch):
    """Lift the row rule for pairs and let 2D grids pair."""
    monkeypatch.setattr(tengine, "PAIR_MIN_ROW_BYTES", 0)
    monkeypatch.setattr(pairfix, "PAIR_2D_GRIDS", True)


def _count_pairs(monkeypatch):
    """Record the engine's pair calls on every rank's thread: True for a
    call with ``halos0``."""
    calls = []
    real = tengine.fused_pair_iteration

    def counted(*args, **kw):
        calls.append(kw.get("halos0") is not None)
        return real(*args, **kw)

    monkeypatch.setattr(tengine, "fused_pair_iteration", counted)
    return calls


def _scalars(nd):
    li = np.full(nd, 32.0 if nd == 4 else 16.0, np.float32)
    return li, np.float32(1) / li


def _mesh_state(cube, opts, shard, ref=None):
    """``run_sharded`` with ``keep_state`` on every rank's block: per rank
    its block's recon, accumulators and shadow duals (bfloat16 widened) as
    numpy, the traces and the iterations run."""
    li, lm = _scalars(cube.ndim)

    def run(pg, rank):
        comm = MeshComm(pg, shard, rank)
        orig = torch.from_numpy(load_sharded_block(cube, shard, rank))
        rf = torch.from_numpy(load_sharded_block(ref, shard, rank)) \
            if ref is not None else None
        out = run_sharded(orig, torch.from_numpy(li), torch.from_numpy(lm),
                          opts, comm, rf, keep_state=True)
        keys = ("b_norm", "delta") + (("mse",) if ref is not None else ())
        return ([to_numpy(x) for x in [out["recon"], *out["accs"],
                                       *out["ds"]]],
                {k: to_numpy(out[k]) for k in keys}, out["iterations_run"],
                dict(comm.stats))

    return on_mesh(int(np.prod(shard)), run)


def _single_state(cube, opts, ref=None):
    li, lm = _scalars(cube.ndim)
    out = tengine.run_solver(
        torch.from_numpy(cube), torch.from_numpy(li), torch.from_numpy(lm),
        opts, None if ref is None else torch.from_numpy(ref),
        keep_state=True)
    keys = ("b_norm", "delta") + (("mse",) if ref is not None else ())
    return ([to_numpy(x) for x in [out["recon"], *out["accs"],
                                   *out["ds"]]],
            {k: to_numpy(out[k]) for k in keys}, out["iterations_run"])


def _same(res, want, shard, traces=True):
    """Every rank's state bitwise its block of ``want``'s, the same
    iteration count, the traces within rtol 1e-5."""
    arrays, tr, n_run = want
    for rank, (got, gtr, g_run, _) in enumerate(res):
        sl = block_slices(arrays[0].shape, shard, rank_coords(shard, rank))
        assert g_run == n_run
        assert len(got) == len(arrays)
        for x, w in zip(got, arrays):
            np.testing.assert_array_equal(x, w[sl])
        if traces:
            for k in tr:
                np.testing.assert_allclose(gtr[k], tr[k], rtol=SUM_RTOL)


CASES = {
    # tests/test_temporal.py::test_sharded_pairs_2d_grid
    "smallest-2x2": ((8, 8, 6, 16), (2, 2, 1, 1), (4, 0), {}),
    "odd-2x4": ((8, 16, 6, 16), (2, 4, 1, 1), (5, 0), {}),
    "hybrid-4x2": ((16, 8, 6, 16), (4, 2, 1, 1), (3, 2), {}),
    "3d-unaccelerated": ((8, 8, 64), (2, 2, 1), (0, 4), {}),
    "unaccelerated-2x2": ((8, 8, 6, 16), (2, 2, 1, 1), (0, 6), {}),
    # ::test_pair_mse_sharded_2d_grid_matches_single
    "mse-2x2": ((8, 8, 6, 16), (2, 2, 1, 1), (8, 0), dict(mse=True)),
    "mse-3d": ((8, 8, 64), (2, 2, 1), (0, 6), dict(mse=True)),
    "mse-hybrid-2x4": ((8, 16, 6, 16), (2, 4, 1, 1), (5, 2),
                       dict(mse=True)),
    # tests/test_lossy.py::test_sharded_lossy_matches_single_device
    "lossy-2x2": ((8, 8, 6, 16), (2, 2, 1, 1), (4, 0), dict(lossy=True)),
    # 6-column shards: the right edge's wrap is not its strip's
    "lossy-6-columns": ((8, 12, 6, 16), (2, 2, 1, 1), (6, 2),
                        dict(lossy=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_2d_grid_pairs_match_single_device_and_jax(monkeypatch, case):
    """The engine's pairs on a 2D grid (``halos0`` and the seam repair):
    every pair call of every rank takes ``halos0``; recon, accumulators
    and shadow duals bitwise the port's single-device run and its K=1 mesh
    run, traces within rtol 1e-5; the recon and traces against the JAX
    ``run_sharded``, which pairs there with its own repair."""
    shape, shard, (n_f, n_u), kw = CASES[case]
    _pairs_everywhere(monkeypatch)
    nd = len(shape)
    cube = (np.random.default_rng(sum(shape) + n_f).standard_normal(shape)
            * 0.5 + 2.0).astype(np.float32)
    ref = (cube * np.float32(0.9)) if kw.get("mse") else None
    base = dict(ndim=nd, iterations_fista=n_f, iterations_unacc=n_u,
                calculate_mse=ref is not None,
                lossy_duals=bool(kw.get("lossy")))
    local = tuple(e // w for e, w in zip(shape, shard))
    opts = TOptions(**base)
    assert tengine._plan(opts, local, torch.float32,
                         type("C", (), {"split_axes": (0, 1)})())[1]
    single = _single_state(cube, opts, ref)
    k1 = _mesh_state(cube, TOptions(**base, temporal_pairs=False), shard,
                     ref)
    calls = _count_pairs(monkeypatch)
    res = _mesh_state(cube, opts, shard, ref)
    n = int(np.prod(shard))
    assert len(calls) == n * (n_f // 2 + n_u // 2) and all(calls)
    assert all(r[3]["seam_exchanges"] > 0 for r in res)
    assert all(r[3]["seam_exchanges"] == 0 for r in k1)
    _same(res, single, shard)
    _same(k1, single, shard)
    # the JAX mesh run pairs there too, with its seam repair
    li, lm = _scalars(nd)
    jopts = JOptions(**base, backend=JBackend.PALLAS)
    assert JE._resolve_temporal(jopts, local, jnp.float32,
                                type("C", (), {"split_axes": (0, 1)})())
    want = jsharded.run_sharded(cube, li, lm, jopts, reference_data=ref,
                                shard=shard)
    got = np.empty_like(cube)
    for rank, r in enumerate(res):
        got[block_slices(shape, shard, rank_coords(shard, rank))] = r[0][0]
    np.testing.assert_allclose(got, np.asarray(want["recon"]), rtol=RTOL,
                               atol=ATOL)
    tr = res[0][1]
    np.testing.assert_allclose(tr["b_norm"], np.asarray(want["b_norm"]),
                               rtol=2e-5)
    np.testing.assert_allclose(tr["delta"], np.asarray(want["delta"]),
                               rtol=2e-4)
    if ref is not None:
        np.testing.assert_allclose(tr["mse"], np.asarray(want["mse"]),
                                   rtol=SUM_RTOL)


@pytest.mark.parametrize("guard", ["real", "always"])
def test_2d_grid_stop_run_pairs(monkeypatch, guard):
    """A stop-aware run on a (2, 2, 1, 1) grid: the prologue, pairs with
    the seam repair behind the guard in checkpointed blocks, and the K=1
    loop's exact stop, every decision on the all-reduced deltas. The
    threshold is crossed at a pair's first iteration: with a guard that
    always allows, that pair beats it, and its block is discarded on every
    rank and redone on the K=1 loop. Stops where the port's single-device
    run stops, its state bitwise."""
    _pairs_everywhere(monkeypatch)
    shape, shard = (8, 8, 6, 16), (2, 2, 1, 1)
    cube = (np.random.default_rng(5).standard_normal(shape) * 0.5
            + 2.0).astype(np.float32)
    base = dict(ndim=4, iterations_fista=30, iterations_unacc=0)
    fixed = _single_state(cube, TOptions(**base))[1]["delta"]
    # between the 16th and 17th deltas, far from both: the pair of
    # iterations 17 and 18 (after a 2-iteration prologue) crosses at its
    # first
    thr = float(np.sqrt(fixed[15] * fixed[16]))
    opts = TOptions(**base, stopping_relative_change=thr)
    single = _single_state(cube, opts)
    assert single[2] == 17
    if guard == "always":
        monkeypatch.setattr(tengine, "_guard_allows", lambda *a: True)
    steps = []
    real_step = tengine.iteration_step

    def counted(*args, **kw):
        steps.append(1)
        return real_step(*args, **kw)

    monkeypatch.setattr(tengine, "iteration_step", counted)
    calls = _count_pairs(monkeypatch)
    res = _mesh_state(cube, opts, shard)
    assert calls and all(calls)
    _same(res, single, shard)
    # every iteration once, or a discarded block redone
    ran = (2 * len(calls) + len(steps)) // 4
    assert (ran > single[2]) == (guard == "always"), ran


def test_2d_grid_shards_under_4_columns_stay_on_k1(monkeypatch):
    """Shards of 2 columns (a (2, 4, 1, 1) grid of an 8-column cube) take
    no pairs (the strips take 4 columns a side): the K=1 loop, bitwise the
    single-device run."""
    _pairs_everywhere(monkeypatch)
    shape, shard = (8, 8, 6, 16), (2, 4, 1, 1)
    local = (4, 2, 6, 16)
    opts = TOptions(ndim=4, iterations_fista=6, iterations_unacc=0)
    assert not tengine._plan(opts, local, torch.float32,
                             type("C", (), {"split_axes": (0, 1)})())[1]
    cube = (np.random.default_rng(3).standard_normal(shape) * 0.5
            + 2.0).astype(np.float32)
    calls = _count_pairs(monkeypatch)
    res = _mesh_state(cube, opts, shard)
    assert not calls
    assert all(r[3]["seam_exchanges"] == 0 for r in res)
    _same(res, _single_state(cube, opts), shard)


def test_2d_grid_runs_the_k1_loop_by_default(monkeypatch):
    """Without ``pairfix.PAIR_2D_GRIDS`` a 2D grid takes no pairs, at any
    row size: the K=1 loop, no seam exchange, bitwise the single-device
    run. Axis-0 and axis-1 meshes of the same shards still pair."""
    monkeypatch.setattr(tengine, "PAIR_MIN_ROW_BYTES", 0)
    assert not pairfix.PAIR_2D_GRIDS
    shape, shard = (8, 8, 6, 16), (2, 2, 1, 1)
    local = (4, 4, 6, 16)
    opts = TOptions(ndim=4, iterations_fista=6, iterations_unacc=0)

    def plan(split):
        return tengine._plan(opts, local, torch.float32,
                             type("C", (), {"split_axes": split})())[1]

    assert not plan((0, 1))
    assert plan((0,)) and plan((1,))
    cube = (np.random.default_rng(4).standard_normal(shape) * 0.5
            + 2.0).astype(np.float32)
    calls = _count_pairs(monkeypatch)
    res = _mesh_state(cube, opts, shard)
    assert not calls
    assert all(r[3]["seam_exchanges"] == 0 for r in res)
    _same(res, _single_state(cube, opts), shard)


def test_2d_grid_repair_buffers_reserved_before_the_first_collective(
        monkeypatch):
    """Every buffer of the seam repair (the column exchanges, the strips'
    row exchanges, the zero row) is in the pool before the run's first
    collective: the sealed pool allocates nothing later, and the run is
    bitwise the single-device run."""
    _pairs_everywhere(monkeypatch)
    shape, shard = (8, 12, 6, 16), (2, 2, 1, 1)
    cube = (np.random.default_rng(9).standard_normal(shape) * 0.5
            + 2.0).astype(np.float32)
    opts = TOptions(ndim=4, iterations_fista=4, iterations_unacc=3)
    counts = []
    real = tsharded.run_prepared

    def counted(run):
        before = run.comm.stats["buffers"]
        assert run.comm.sealed
        out = real(run)
        counts.append(run.comm.stats["buffers"] - before)
        return out

    monkeypatch.setattr(tsharded, "run_prepared", counted)
    res = _mesh_state(cube, opts, shard)
    assert counts == [0] * 4
    assert all(r[3]["seam_exchanges"] > 0 for r in res)
    _same(res, _single_state(cube, opts), shard)
