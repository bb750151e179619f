"""Sharded runs in the port (``cytvdn_tpu_torch.parallel``) on the CPU:
mesh runs against the port's single-device run and against the JAX
package's ``run_sharded`` on the 8 fake CPU devices of tests/conftest.py.

The ranks of a mesh run as threads of this process, each with its own
``ProcessGroupGloo`` over one in-memory store: no process start, real
gloo point-to-point and collectives. Every group has a timeout of a few
tens of seconds and every thread join a limit, so a deadlock fails the
test instead of hanging the suite.

Against the port's single-device run the gathered recon is bitwise equal
and the traces within rtol 1e-5 (their sums are added in another order).
Against the JAX ``run_sharded`` (the same state fed to both): float64
runs within tests/test_sharded.py's tolerances (recon atol 1e-13, b_norm
rtol 1e-12, delta rtol 1e-10), float32 runs within rtol 2e-5 / atol 2e-6
(tests/test_torch_solver.py's).
"""

import datetime
import itertools
import os
import socket
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from cytvdn_tpu.config import SolverOptions as JOptions  # noqa: E402
from cytvdn_tpu.parallel import partition as jpartition  # noqa: E402
from cytvdn_tpu.parallel import sharded as jsharded  # noqa: E402
from cytvdn_tpu_torch import denoise3D, denoise4D  # noqa: E402
from cytvdn_tpu_torch.config import SolverOptions as TOptions  # noqa: E402
from cytvdn_tpu_torch.parallel import (  # noqa: E402
    MeshComm,
    denoise_sharded,
    run_sharded,
    state_block,
)
from cytvdn_tpu_torch.parallel import distributed as tdist  # noqa: E402
from cytvdn_tpu_torch.parallel import partition as tpartition  # noqa: E402
from cytvdn_tpu_torch.parallel import sharded as tsharded  # noqa: E402
from cytvdn_tpu_torch.solver import engine as tengine  # noqa: E402
from cytvdn_tpu_torch.utils.state import state_from_numpy  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 60
_STORE = dist.HashStore()
_GROUPS = itertools.count()


def on_mesh(n, fn, timeout=TIMEOUT):
    """``fn(group, rank)`` on ``n`` ranks, each a thread with its own gloo
    group; returns the ranks' results, re-raising the first error."""
    prefix = f"mesh{next(_GROUPS)}"
    res, errs = [None] * n, [None] * n

    def run(r):
        try:
            pg = dist.ProcessGroupGloo(dist.PrefixStore(prefix, _STORE), r, n,
                                       datetime.timedelta(seconds=timeout))
            res[r] = fn(pg, r)
        except BaseException as e:  # re-raised in the test's thread
            errs[r] = e

    threads = [threading.Thread(target=run, args=(r,), daemon=True)
               for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout + 30)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    for e in errs:
        if e is not None:
            raise e
    return res


def _cube(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 0.5 + 2.0).astype(dtype)


def _sharded(cube, shard, **kw):
    n = int(np.prod(shard))
    return on_mesh(n, lambda pg, r: denoise_sharded(
        cube, kw.pop("mu_", np.full(cube.ndim, 1.0, cube.dtype)),
        shard=shard, group=pg, device="cpu", **kw))


def _single(cube, **kw):
    fn = denoise4D if cube.ndim == 4 else denoise3D
    return fn(cube, np.full(cube.ndim, 1.0, cube.dtype), quiet=True,
              device="cpu", **kw)


def _check(res, want, mse=False):
    """Gathered recon bitwise, traces within rtol 1e-5, on every rank."""
    np.testing.assert_array_equal(res[0]["recon"], want[0])
    n_run = np.count_nonzero(want[2])
    for r, out in enumerate(res):
        assert out["iterations_run"] == n_run
        np.testing.assert_array_equal(out["block"], want[0][out["slices"]])
        np.testing.assert_allclose(out["b_norm"], want[1], rtol=1e-5)
        np.testing.assert_allclose(out["delta"], want[2], rtol=1e-5)
        if mse:
            np.testing.assert_allclose(out["mse"], want[3], rtol=1e-5)
        if r:
            assert out["recon"] is None
            # every rank holds the same traces, bit for bit
            np.testing.assert_array_equal(out["delta"], res[0]["delta"])


# -- mesh runs against the port's single-device run ---------------------------

MESHES = [
    ((16, 8, 6, 5), (2, 1, 1, 1)),
    ((16, 8, 6, 5), (4, 1, 1, 1)),
    ((12, 8, 6, 5), (1, 2, 1, 1)),
    ((16, 8, 6, 5), (2, 2, 1, 1)),
    ((16, 9, 20), (2, 1, 1)),
]
SCHEDULES = {"fista": dict(iterations=7, FISTA=True),
             "unacc": dict(iterations=7, FISTA=False),
             "hybrid": dict(iterations=(5, 4))}


@pytest.mark.parametrize("pairs", [True, False])
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("shape,shard", MESHES, ids=str)
def test_mesh_run_bitwise_single_device(monkeypatch, shape, shard, schedule,
                                        pairs):
    """Axis-0, axis-1 and 2D meshes, 3D and 4D, FISTA, unaccelerated and
    hybrid, with pairs (the engine's row rule lifted: axis-0 meshes take
    the pair kernel's bands) and without."""
    if pairs:
        monkeypatch.setattr(tengine, "PAIR_MIN_ROW_BYTES", 0)
    cube = _cube(shape, seed=sum(shape))
    kw = SCHEDULES[schedule]
    _check(_sharded(cube, shard, **kw), _single(cube, **kw))


@pytest.mark.parametrize("shard", [(2, 1, 1, 1), (1, 2, 1, 1), (2, 2, 1, 1)],
                         ids=str)
def test_mesh_stop_run_bitwise_single_device(monkeypatch, shard):
    """A stop-aware run: the prologue, pairs behind the guard (axis-0) and
    the K=1 loop's exact stop read only the all-reduced deltas, and stop at
    the single-device iteration."""
    monkeypatch.setattr(tengine, "PAIR_MIN_ROW_BYTES", 0)
    cube = _cube((16, 8, 6, 5), seed=4)
    fixed = _single(cube, iterations=40)[2]
    # between the 19th and 20th deltas, far from both
    thr = float(np.sqrt(fixed[18] * fixed[19]))
    kw = dict(iterations=40, stopping_relative_change=thr)
    want = _single(cube, **kw)
    assert np.count_nonzero(want[2]) == 20
    _check(_sharded(cube, shard, **kw), want)


@pytest.mark.parametrize("shard", [(2, 1, 1, 1), (2, 2, 1, 1)], ids=str)
def test_mesh_mse_run_bitwise_single_device(monkeypatch, shard):
    """A run with a reference cube: the SSE of every iteration is summed
    over the mesh (the pair kernel's REF with bands on the axis-0 mesh)."""
    monkeypatch.setattr(tengine, "PAIR_MIN_ROW_BYTES", 0)
    cube = _cube((16, 8, 6, 5), seed=5)
    ref = (cube * 0.9).astype(np.float32)
    kw = dict(iterations=9, reference_data=ref)
    _check(_sharded(cube, shard, **kw), _single(cube, **kw), mse=True)


@pytest.mark.parametrize("shard", [(2, 1, 1, 1), (1, 2, 1, 1)], ids=str)
def test_mesh_fista_restart_and_plain_backend(shard):
    """``fista_restart`` on the K=1 path (its momentum from the summed
    deltas, tests/test_sharded.py:154) and ``backend="torch"`` (the plain
    spec with ``prev_halo``/``next_halo``), each bitwise the port's
    single-device run."""
    cube = _cube((16, 8, 6, 5), seed=6)
    want = _single(cube, iterations=12, fista_restart=True)
    # denoise_sharded has no fista_restart keyword: run_sharded takes it
    opts = TOptions(ndim=4, iterations_fista=12, iterations_unacc=0,
                    fista_restart=True)
    res = on_mesh(2, lambda pg, r: _run_block(cube, opts, pg, r, shard))
    np.testing.assert_array_equal(np.concatenate(
        [x["recon"] for x in res], axis=shard.index(2)), want[0])
    np.testing.assert_allclose(res[0]["delta"], want[2], rtol=1e-5)
    kw = dict(iterations=(4, 3), backend="torch")
    _check(_sharded(cube, shard, **kw), _single(cube, **kw))


def _run_block(cube, opts, pg, rank, shard, state=None, i_stop=None):
    """``run_sharded`` on this rank's block of ``cube`` (the 4D defaults:
    λ = μ/32), outputs as numpy."""
    from cytvdn_tpu_torch.parallel.multihost import load_sharded_block

    comm = MeshComm(pg, shard, rank)
    orig = torch.from_numpy(load_sharded_block(cube, shard, rank))
    nd = cube.ndim
    li = torch.full((nd,), 32.0 if nd == 4 else 16.0)
    lm = torch.full((nd,), 1 / 32 if nd == 4 else 1 / 16)
    out = run_sharded(orig, li, lm, opts, comm, state=state, i_stop=i_stop,
                      keep_state=True)
    return {k: (v.numpy() if torch.is_tensor(v) else
                [x.numpy() for x in v] if isinstance(v, list) else v)
            for k, v in out.items()}


@pytest.mark.parametrize("every", [1, 3, 5])
def test_mesh_chunked_run_through_state(monkeypatch, every):
    """A run in chunks through ``state``/``i_stop``/``keep_state`` (each
    rank keeps its block of the state between calls): bitwise the
    unchunked mesh run and the single-device run."""
    monkeypatch.setattr(tengine, "PAIR_MIN_ROW_BYTES", 0)
    cube = _cube((16, 8, 6, 5), seed=7)
    opts = TOptions(ndim=4, iterations_fista=6, iterations_unacc=5)
    shard = (2, 1, 1, 1)

    def chunked(pg, r):
        state, out = None, None
        for i_stop in range(every, 11 + every, every):
            out = _run_block(cube, opts, pg, r, shard,
                             state=state, i_stop=min(i_stop, 11))
            state = state_from_numpy(out, "cpu")
        return out

    res = on_mesh(2, chunked)
    want = _single(cube, iterations=(6, 5))
    np.testing.assert_array_equal(
        np.concatenate([x["recon"] for x in res]), want[0])
    np.testing.assert_allclose(res[1]["delta"], want[2], rtol=1e-5)


def test_mesh_progress_run_in_chunks(monkeypatch):
    """``progress=True`` runs the mesh in chunks (``chunk_driver``), the
    bar on rank 0 only: bitwise the unchunked run."""
    monkeypatch.setattr(tengine, "PAIR_MIN_ROW_BYTES", 0)
    cube = _cube((16, 8, 6, 5), seed=8)
    kw = dict(iterations=30)
    _check(_sharded(cube, (2, 1, 1, 1), progress=True, **kw),
           _single(cube, **kw))


def test_mesh_reads_blocks_from_a_file(tmp_path, monkeypatch):
    """A path in place of the cube: every rank reads only its block (cast
    to float32), bitwise the single-device run of the file's cube."""
    monkeypatch.setattr(tengine, "PAIR_MIN_ROW_BYTES", 0)
    cube = _cube((16, 9, 20), seed=9)
    path = str(tmp_path / "cube.npy")
    np.save(path, cube.astype(np.float64))
    kw = dict(iterations=6, FISTA=True)
    res = on_mesh(2, lambda pg, r: denoise_sharded(
        path, 1.0, shard=(2, 1, 1), group=pg, device="cpu", **kw))
    _check(res, _single(cube, **kw))


# -- against the JAX package's run_sharded ------------------------------------

def _jax_state(cube, n_f, n_u, dtype):
    """A mid-run state in the JAX layout: the port's single-device run of
    3 iterations, kept."""
    nd = cube.ndim
    opts = TOptions(ndim=nd, iterations_fista=n_f, iterations_unacc=n_u)
    li = torch.full((nd,), 32.0 if nd == 4 else 16.0, dtype=dtype)
    lm = torch.full((nd,), 1 / 32 if nd == 4 else 1 / 16, dtype=dtype)
    out = tengine.run_solver(torch.from_numpy(cube.copy()), li, lm, opts,
                             i_stop=3, keep_state=True)
    st = {k: v for k, v in out.items() if k in (
        "recon", "accs", "ds", "b_norm", "delta", "i", "tk")}
    st["mse"] = None
    from cytvdn_tpu_torch.utils.state import state_to_numpy

    return state_to_numpy(st)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("shape,shard,n_f,n_u", [
    ((8, 8, 6, 8), (2, 1, 1, 1), 7, 0),
    ((8, 8, 6, 8), (2, 2, 1, 1), 4, 3),
    ((8, 8, 16), (1, 2, 1), 0, 8),
], ids=str)
def test_mesh_matches_jax_run_sharded(shape, shard, n_f, n_u, dtype):
    """The same mid-run state fed to both packages (``state_block`` cuts
    the port's blocks from it): the port's mesh run against the JAX
    ``run_sharded`` on the fake CPU devices."""
    cube = _cube(shape, seed=11, dtype=dtype)
    nd = len(shape)
    state = _jax_state(cube, n_f, n_u, torch.float64 if dtype == np.float64
                       else torch.float32)
    li = np.full(nd, 32.0 if nd == 4 else 16.0, dtype)
    lm = np.full(nd, 1 / 32 if nd == 4 else 1 / 16, dtype)
    jst = {"recon": jnp.asarray(state["recon"]),
           "accs": tuple(jnp.asarray(a) for a in state["accs"]),
           "ds": tuple(jnp.asarray(a) for a in state["ds"]),
           "b_norm": jnp.asarray(state["b_norm"]),
           "delta": jnp.asarray(state["delta"]),
           "mse": jnp.zeros((0,), dtype), "i": jnp.int32(3),
           "tk": jnp.float32(1.0)}
    want = jsharded.run_sharded(
        cube, li, lm, JOptions(ndim=nd, iterations_fista=n_f,
                               iterations_unacc=n_u),
        shard=shard, state=jst, keep_state=True)
    opts = TOptions(ndim=nd, iterations_fista=n_f, iterations_unacc=n_u)

    def rank(pg, r):
        comm = MeshComm(pg, shard, r)
        blk = state_from_numpy(state_block(state, shard, r), "cpu")
        from cytvdn_tpu_torch.parallel.multihost import load_sharded_block

        orig = torch.from_numpy(load_sharded_block(cube, shard, r, dtype))
        out = run_sharded(orig, torch.from_numpy(li), torch.from_numpy(lm),
                          opts, comm, state=blk)
        return comm.gather_blocks(out["recon"], shape), out

    res = on_mesh(int(np.prod(shard)), rank)
    recon, out = res[0]
    if dtype == np.float64:
        tol = dict(recon=dict(atol=1e-13, rtol=0),
                   b_norm=dict(rtol=1e-12), delta=dict(rtol=1e-10))
    else:
        tol = {k: dict(rtol=2e-5, atol=2e-6)
               for k in ("recon", "b_norm", "delta")}
    np.testing.assert_allclose(recon, np.asarray(want["recon"]),
                               **tol["recon"])
    for key in ("b_norm", "delta"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(want[key]),
                                   **tol[key])
    assert out["iterations_run"] == int(want["iterations_run"])


def test_mesh_stop_matches_jax_run_sharded():
    """A stop-aware float64 run on an axis-0 mesh stops where the JAX
    ``run_sharded`` stops, with the same recon within atol 1e-13."""
    cube = _cube((8, 8, 12), seed=12, dtype=np.float64)
    li = np.full(3, 16.0)
    lm = np.full(3, 1 / 16)
    fixed = jsharded.run_sharded(cube, li, lm, JOptions(
        ndim=3, iterations_fista=30, iterations_unacc=0), shard=(2, 1, 1))
    d = np.asarray(fixed["delta"])
    thr = float(np.sqrt(d[10] * d[11]))
    jopts = JOptions(ndim=3, iterations_fista=30, iterations_unacc=0,
                     stopping_relative_change=thr)
    want = jsharded.run_sharded(cube, li, lm, jopts, shard=(2, 1, 1))
    res = _sharded(cube, (2, 1, 1), iterations=30,
                   stopping_relative_change=thr, mu_=np.full(3, 1.0))
    assert res[0]["iterations_run"] == int(want["iterations_run"]) == 12
    np.testing.assert_allclose(res[0]["recon"], np.asarray(want["recon"]),
                               atol=1e-13, rtol=0)
    np.testing.assert_allclose(res[0]["delta"], np.asarray(want["delta"]),
                               rtol=1e-10)


# -- resolve_shard and choose_grid against the JAX package --------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12])
@pytest.mark.parametrize("extents", [(8, 8), (250, 250), (64, 48), (7, 5),
                                     (256, 256, 128, 128)], ids=str)
def test_choose_grid_matches_jax(extents, n):
    try:
        want = jpartition.choose_grid(n, extents)
    except ValueError:
        with pytest.raises(ValueError):
            tpartition.choose_grid(n, extents)
        return
    assert tpartition.choose_grid(n, extents) == want


@pytest.mark.parametrize("prefer", [False, True])
@pytest.mark.parametrize("shard,shape,n", [
    ("auto", (256, 256, 128, 128), 2), ("auto", (256, 256, 128, 128), 4),
    ("auto", (250, 250, 16), 8), ("auto", (12, 8, 6, 5), 4),
    ("auto", (6, 64, 32), 4), ("auto", (64, 64, 512), 8),
    ((2, 2, 1, 1), (8, 8, 6, 5), 4), (None, (8, 8, 6), 2),
], ids=str)
def test_resolve_shard_matches_jax(shard, shape, n, prefer):
    """The port's rules (even tiling, the 'auto' partitioner, the axis-0
    preference) give the JAX package's grids. Where the JAX package's
    TPU-only HBM model (``pair_hbm_viable``, the v5e's 15.3 GB) refuses the
    axis-0 shard's pair state, as at config 4 on 2 devices, the port, whose
    gate is the pair kernel's own, keeps the axis-0 split."""
    from cytvdn_tpu.kernels.temporal import pair_hbm_viable

    got = tsharded.resolve_shard(shard, shape, n, prefer_axis0=prefer)
    local = (shape[0] // n,) + tuple(shape[1:])
    if prefer and shard == "auto" and shape[0] % n == 0 \
            and shape[0] // n >= 4 and not pair_hbm_viable(local):
        assert got == (n,) + (1,) * (len(shape) - 1)
        return
    assert got == jsharded.resolve_shard(shard, shape, n, prefer_axis0=prefer)


def test_resolve_shard_refuses_uneven_tiles():
    for mod in (tsharded, jsharded):
        with pytest.raises(ValueError, match="not divisible"):
            mod.resolve_shard((3, 1, 1), (8, 8, 8), 3)


@pytest.mark.parametrize("kw", [
    dict(), dict(temporal_pairs=False), dict(fista_restart=True),
    dict(bc_mode=1), dict(isotropic_R=True)], ids=str)
def test_temporal_mesh_preference_matches_jax(kw):
    nd = 4
    for dtype in (np.float32, np.float64):
        assert tsharded.temporal_mesh_preference(
            TOptions(ndim=nd, iterations_fista=3, iterations_unacc=0, **kw),
            dtype) == jsharded.temporal_mesh_preference(
            JOptions(ndim=nd, iterations_fista=3, iterations_unacc=0, **kw),
            dtype)


# -- refusals -----------------------------------------------------------------

@pytest.mark.parametrize("kw,item", [
    (dict(shard=(1, 1, 2, 1)), "Queue 1 item 8"),
    (dict(shard=(2, 1, 1, 1), isotropic_R=True), "Queue 1 item 8"),
    (dict(shard=(2, 1, 1, 1), BC_mode=1), "Queue 1 item 8"),
    (dict(shard=(2, 1, 1, 1), BC_mode=0), "Queue 1 item 8"),
    (dict(shard=(2, 1, 1, 1), checkpoint_path="x.npz",
          checkpoint_every=2), "Queue 1 item 9"),
    (dict(shard=(2, 1, 1, 1), resume=True), "Queue 1 item 9"),
    (dict(shard=(2, 1, 1, 1), lossy_duals=True), "Queue 1 item 12"),
], ids=str)
def test_unported_mesh_runs_name_their_item(kw, item):
    cube = _cube((8, 8, 6, 4), seed=13)
    with pytest.raises(NotImplementedError, match=item):
        _sharded(cube, kw.pop("shard"), iterations=2, **kw)


def test_denoise_sharded_needs_a_group_and_matching_shard():
    cube = _cube((8, 8, 6, 4), seed=13)
    if not dist.is_initialized():
        with pytest.raises(ValueError, match="init_distributed"):
            denoise_sharded(cube, 1.0, device="cpu")
    with pytest.raises(ValueError, match="ranks"):
        _sharded(cube, (4, 1, 1, 1)[:0] or (2, 2, 1, 1), iterations=2) \
            if False else on_mesh(2, lambda pg, r: denoise_sharded(
                cube, 1.0, shard=(2, 2, 1, 1), group=pg, device="cpu"))


# -- MeshComm -----------------------------------------------------------------

def test_meshcomm_exchanges_and_sums():
    """Slabs move to the right neighbours along each axis of a (2, 2)
    grid, edges get the given slab (shift) or zeros (packed), and every
    rank's allsum holds the same bits, added in rank order."""
    grid = (2, 2, 1)

    def rank(pg, r):
        comm = MeshComm(pg, grid, r)
        a = torch.full((3, 4, 5), float(r)) + torch.arange(3.0)[:, None, None]
        edge = torch.full((1, 4, 5), -1.0)
        got = {
            "prev0": comm.shift_from_prev(a, 0, edge),
            "next0": comm.shift_from_next(a, 0, edge),
            "prev1": comm.shift_from_prev(a, 1, torch.full((3, 1, 5), -1.0)),
            "packed": comm.pack_exchange_next([a[:1], a[1:2]], 0),
            "sum": comm.allsum(torch.tensor([0.1 * (r + 1), 1e-8 * r],
                                            dtype=torch.float32)),
            "max": comm.allmax(r == 2),
        }
        return comm.coords, got, dict(comm.stats)

    res = on_mesh(4, rank)
    for coords, got, stats in res:
        c0, c1 = coords[:2]
        r_prev0 = (c0 - 1) * 2 + c1
        r_next0 = (c0 + 1) * 2 + c1
        if c0 == 0:
            assert torch.equal(got["prev0"], torch.full((1, 4, 5), -1.0))
            assert float(got["next0"][0, 0, 0]) == r_next0
            assert float(got["packed"][1][0, 0, 0]) == r_next0 + 1
        else:
            assert float(got["prev0"][0, 0, 0]) == r_prev0 + 2
            assert torch.equal(got["next0"], torch.full((1, 4, 5), -1.0))
            assert torch.equal(got["packed"][0], torch.zeros(1, 4, 5))
        if c1 == 1:
            assert float(got["prev1"][2, 0, 0]) == c0 * 2 + 2
        else:
            assert torch.equal(got["prev1"], torch.full((3, 1, 5), -1.0))
        assert torch.equal(got["sum"], res[0][1]["sum"])
        want = sum(np.float64(np.float32(0.1 * (q + 1))) for q in range(4))
        assert float(got["sum"][0]) == np.float32(want)
        assert got["max"] == 1
        assert stats["exchanges"] == 4 and stats["allsums"] == 1
        assert stats["bytes_sent"] > 0


def test_meshcomm_refuses_periodic_and_mirror_meshes():
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        on_mesh(2, lambda pg, r: MeshComm(pg, (2, 1, 1), r, bc=0))
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        on_mesh(2, lambda pg, r: MeshComm(pg, (2, 1, 1), r, bc=1))


# -- the collective device-memory ladder --------------------------------------

def test_mesh_ladder_agrees_on_one_rank_out_of_memory(monkeypatch):
    """One rank runs out of device memory allocating a stop run's block
    checkpoint: all ranks retry together with temporal_pairs off (one
    warning each) and the result is bitwise the single-device run; where
    the retry runs out of memory too, no knob is left and every rank
    raises."""
    monkeypatch.setattr(tengine, "PAIR_MIN_ROW_BYTES", 0)
    real = tengine.prepare_run
    failed = []

    def flaky(orig, li, lm, opts, *a, **kw):
        comm = a[-1] if a else kw.get("comm")
        if comm.rank == 1 and opts.temporal_pairs:
            failed.append(1)
            raise torch.OutOfMemoryError("simulated")
        return real(orig, li, lm, opts, *a, **kw)

    monkeypatch.setattr(tsharded, "prepare_run", flaky)
    cube = _cube((16, 8, 6, 5), seed=14)
    fixed = _single(cube, iterations=30)[2]
    kw = dict(iterations=30,
              stopping_relative_change=float(np.sqrt(fixed[9] * fixed[10])))
    with pytest.warns(UserWarning, match="all ranks retry"):
        res = _sharded(cube, (2, 1, 1, 1), **kw)
    assert failed == [1]
    _check(res, _single(cube, **kw))

    def always(orig, li, lm, opts, *a, **kw):
        comm = a[-1] if a else kw.get("comm")
        if comm.rank == 1:
            failed.append(opts.temporal_pairs)
            raise torch.OutOfMemoryError("simulated")
        return real(orig, li, lm, opts, *a, **kw)

    monkeypatch.setattr(tsharded, "prepare_run", always)
    failed.clear()

    def rank(pg, r):
        comm = MeshComm(pg, (2, 1, 1, 1), r)
        o = torch.from_numpy(cube[8 * r:8 * (r + 1)].copy())
        opts = TOptions(ndim=4, iterations_fista=3, iterations_unacc=0,
                        temporal_pairs=True)
        try:
            run_sharded(o, torch.full((4,), 32.0), torch.full((4,), 1 / 32),
                        opts, comm)
        except torch.OutOfMemoryError as e:
            return str(e)

    with pytest.warns(UserWarning, match="all ranks retry"):
        msgs = on_mesh(2, rank)
    assert failed == [True, False]
    assert "another rank" in msgs[0] and "simulated" in msgs[1]


# -- two real processes through init_distributed ------------------------------

WORKER = """
import sys
import numpy as np
from cytvdn_tpu_torch import denoise4D
from cytvdn_tpu_torch.parallel import denoise_sharded, init_distributed
assert init_distributed(device="cpu")
assert not init_distributed() or True
cube = (np.random.default_rng(15).standard_normal((16, 8, 6, 5)) * 0.5
        + 2.0).astype(np.float32)
out = denoise_sharded(cube, 1.0, iterations=5, shard=(2, 1, 1, 1),
                      device="cpu")
if out["recon"] is not None:
    want = denoise4D(cube, np.full(4, 1.0, np.float32), iterations=5,
                     quiet=True, device="cpu")
    assert np.array_equal(out["recon"], want[0])
    np.testing.assert_allclose(out["delta"], want[2], rtol=1e-5)
print("rank done", out["grid"], out["iterations_run"])
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_processes_through_init_distributed():
    """Two processes started with torchrun's environment join one gloo
    group through ``init_distributed`` (no card: the CPU) and run a mesh
    whose gathered recon is bitwise the single-device run's."""
    port = _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, WORLD_SIZE="2", RANK=str(r),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE="2",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   PYTHONPATH=REPO)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert "rank done (2, 1, 1, 1) 5" in out


def test_init_distributed_without_an_environment(monkeypatch):
    for key in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    assert tdist.init_distributed(device="cpu") is False


@pytest.mark.parametrize("local,cards,kind,want", [
    (1, 1, "cuda", "nccl"), (2, 1, "cuda", "gloo"), (4, 4, "cuda", "nccl"),
    (8, 4, "cuda", "gloo"), (2, 0, "cpu", "gloo")])
def test_backend_rule(local, cards, kind, want):
    assert tdist.choose_backend(local, cards, kind) == want
