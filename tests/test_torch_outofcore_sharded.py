"""Out-of-core slabs split over several cards in the port
(``cytvdn_tpu_torch.solver.outofcore``: ``solve_outofcore_sharded_temporal``,
``solve_outofcore_multihost(shard_w=W)``, ``denoise_outofcore(shard_w=W)``)
on the CPU: the ranks are threads, each with its own gloo group
(``test_torch_sharded.py::on_mesh``), on ``device="cpu"`` (the kernels'
plain versions), with small cubes made from a seed. A group of P·W ranks
is a (P, W) grid: process-row r holds its rows, and each of its W ranks
one column block of every slab.

Tolerances:
- the stitched blocks of W = 2 and 4 (P = 1) and of 2 × 2 grids (P = 2,
  uneven rows), 3D and 4D, FISTA, unaccelerated, hybrid and lossy, are
  bitwise the port's in-core ``denoise3D/4D`` run and its one-process
  ``denoise_outofcore`` at the same K; a killed and resumed run is bitwise
  the uninterrupted one; a resume of a finished JAX one-file checkpoint is
  bitwise its recon, cut and stitched;
- the traces within rtol 2e-4 of the one-process run at the sweep-final
  entries, zeros between (tests/test_torch_outofcore_multihost.py's), the
  same bits on every rank; a stop run stops where the one-process run
  does;
- against the JAX package (``solve_outofcore_sharded_temporal`` with
  ``shard_w`` = 2 and 4 on the forced 8 CPU devices): the recon within
  rtol 2e-5 / atol 2e-6, the traces within rtol 2e-4.

Every refusal (an axis 1 that does not split, blocks of fewer than 2
columns, a group that does not form process-rows of W, a ``devices`` of
another length, one rank's wrong ``global_cols``) raises on every rank,
and no rank hangs (each group has a timeout, each join a limit).
"""

import os
import shutil
import threading
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from test_torch_outofcore_multihost import (  # noqa: E402
    ATOL,
    RTOL,
    TRACE_RTOL,
    Killed,
    _cube,
    _errors,
    _incore,
    _mu,
    _one_process,
    _opts,
    _scalars,
)
from test_torch_sharded import on_mesh  # noqa: E402
from cytvdn_tpu.config import SolverOptions as JOptions  # noqa: E402
from cytvdn_tpu.solver import outofcore as jooc  # noqa: E402
from cytvdn_tpu_torch.config import SolverOptions  # noqa: E402
from cytvdn_tpu_torch.io import emd as temd  # noqa: E402
from cytvdn_tpu_torch.solver import outofcore as tooc  # noqa: E402
from cytvdn_tpu_torch.utils import checkpoint as tcheckpoint  # noqa: E402
from cytvdn_tpu_torch.utils.checkpoint import _read_meta  # noqa: E402


def _grid(pg, rank, p, w, cube, k, n_slabs, opts, ref=None, **kw):
    """Rank ``rank`` of a (p, w) grid: its process-row's rows of ``cube``
    at full width through ``solve_outofcore_multihost(shard_w=w)``."""
    g0, g1 = tooc.process_row_range(cube.shape[0], p, rank // w)
    li, lm = _scalars(cube.ndim)
    return tooc.solve_outofcore_multihost(
        cube[g0:g1], li, lm, SolverOptions(**opts), n_slabs, k,
        (g0, g1, cube.shape[0]), shard_w=w,
        reference_local=None if ref is None else ref[g0:g1],
        device="cpu", group=pg, **kw)


def _on_grid(p, w, cube, k, n_slabs, opts, **kw):
    return on_mesh(p * w, lambda pg, r: _grid(pg, r, p, w, cube, k, n_slabs,
                                              opts, **kw))


def _stitch(res, shape):
    out = np.full(shape, np.nan, np.float32)
    for r in res:
        out[r["slices"]] = r["recon"]
    assert not np.isnan(out).any()
    return out


def _same_traces(res, want):
    """Every rank's traces: the same bits on every rank, within TRACE_RTOL
    of ``want`` (the one-process run's), zeros between the sweep ends."""
    for out in res:
        for key, j in (("b_norm", 1), ("delta", 2)):
            np.testing.assert_array_equal(out[key], res[0][key])
            np.testing.assert_allclose(out[key], want[j], rtol=TRACE_RTOL)
            assert ((out[key] != 0) == (want[j] != 0)).all()


class _Calls:
    """Counts the solver's pair calls with ``halos1`` and its K=1 calls
    with ``halos`` (the ``HALO1`` and ``HALO`` launches on the card), from
    every rank's thread."""

    def __init__(self, monkeypatch):
        self.pairs, self.k1, self.plain = [], [], []
        real_pair, real_k1 = tooc.fused_pair_iteration, tooc.fused_iteration

        def pair(*a, **kw):
            (self.pairs if kw.get("halos1") is not None
             else self.plain).append(1)
            return real_pair(*a, **kw)

        def k1(*a, **kw):
            (self.k1 if kw.get("halos") is not None
             else self.plain).append(1)
            return real_k1(*a, **kw)

        monkeypatch.setattr(tooc, "fused_pair_iteration", pair)
        monkeypatch.setattr(tooc, "fused_iteration", k1)


# -- (a) bitwise the port's in-core and one-process runs -----------------------

GRIDS = {
    # name: (P, W, shape, K, n_slabs, iterations, FISTA, lossy)
    "4d-1x2-k3-fista": (1, 2, (13, 4, 5, 6), 3, 2, 7, True, False),
    "4d-1x4-k4-hybrid": (1, 4, (14, 8, 3, 4), 4, 2, (5, 4), True, False),
    "3d-1x2-k2-unacc": (1, 2, (17, 6, 10), 2, 3, 5, False, False),
    "3d-1x4-k3-lossy": (1, 4, (17, 8, 10), 3, 2, 7, True, True),
    "4d-2x2-k3-fista": (2, 2, (13, 4, 5, 6), 3, 2, 7, True, False),
    "4d-2x2-k1-unacc": (2, 2, (11, 4, 3, 4), 1, 2, 3, False, False),
    "3d-2x2-k2-hybrid-lossy": (2, 2, (17, 6, 10), 2, 2, (5, 3), True, True),
    "3d-2x2-k4-fista": (2, 2, (19, 4, 9), 4, 2, 9, True, False),
}


@pytest.mark.parametrize("case", sorted(GRIDS))
def test_grid_bitwise_incore_and_one_process(case, monkeypatch):
    """The stitched blocks are bitwise the in-core run and the one-process
    ``denoise_outofcore`` at the same K; the traces are the one-process
    run's within TRACE_RTOL, alike on every rank; each slab's bulk ran in
    pairs with axis-1 bands and its last iterations as K=1 launches with
    halos, on every rank."""
    p, w, shape, k, n_slabs, iters, fista, lossy = GRIDS[case]
    cube = _cube(shape, 100 + len(case))
    kw = dict(lossy_duals=True) if lossy else {}
    want = _incore(cube, iters, FISTA=fista, **kw)
    one = _one_process(cube, iters, k, n_slabs=n_slabs, FISTA=fista, **kw)
    np.testing.assert_array_equal(one[0], want[0])
    calls = _Calls(monkeypatch)
    res = _on_grid(p, w, cube, k, n_slabs, _opts(len(shape), iters,
                                                 FISTA=fista, **kw))
    np.testing.assert_array_equal(_stitch(res, shape), want[0])
    _same_traces(res, one)
    for q, out in enumerate(res):
        c = q % w
        width = shape[1] // w
        assert out["slices"][1] == slice(c * width, (c + 1) * width)
        assert tuple(out["global_cols"]) == (c * width, (c + 1) * width,
                                             shape[1])
        assert out["column_exchange"]["exchanges"] > 0
        assert (out["exchange"]["exchanges"] > 0) == (p > 1)
    assert not calls.plain
    assert calls.k1
    assert bool(calls.pairs) == (k >= 3)


def test_denoise_outofcore_split_returns_recon_on_rank_zero(monkeypatch):
    """``denoise_outofcore(shard_w=2)`` on 2 ranks: rank 0 returns the
    stitched recon (bitwise the in-core run) and the traces and MSE of the
    one-process run within TRACE_RTOL; rank 1 returns None for the recon.
    ``temporal_k`` ≤ 1 runs with K = 1, as the JAX package's
    ``max(temporal_k, 1)``; ``devices`` of one device takes it on every
    rank, and ``solve_outofcore_sharded_temporal`` gives each rank its
    block and slices, and no recon above the gather threshold."""
    cube, ref = _cube((12, 6, 4, 5), 110), _cube((12, 6, 4, 5), 111)
    mu = _mu(4)
    want = _incore(cube, 5)
    for k in (0, 1, 3):
        one = _one_process(cube, 5, max(k, 1), n_slabs=2,
                           reference_data=ref)
        res = on_mesh(2, lambda pg, r: tooc.denoise_outofcore(
            cube, mu, iterations=5, n_slabs=2, temporal_k=k, shard_w=2,
            reference_data=ref, device="cpu", group=pg,
            devices=["cpu"] if k == 3 else None))
        np.testing.assert_array_equal(res[0][0], want[0])
        assert res[1][0] is None
        for out in res:
            for g, w_ in zip(out[1:], one[1:]):
                np.testing.assert_allclose(g, w_, rtol=TRACE_RTOL)
    li, lm = _scalars(4)
    monkeypatch.setattr(temd, "_GATHER_MAX_BYTES", cube.nbytes - 1)
    res = on_mesh(2, lambda pg, r: tooc.solve_outofcore_sharded_temporal(
        cube, li, lm, SolverOptions(**_opts(4, 5)), 2, 3, group=pg,
        device="cpu"))
    for r, out in enumerate(res):
        assert out["recon"] is None and not out["gathered"]
        assert out["slices"][:2] == (slice(0, 12), slice(3 * r, 3 * r + 3))
        np.testing.assert_array_equal(out["block"], want[0][out["slices"]])


# -- (b) against the JAX package -----------------------------------------------

JAX_CASES = {
    # name: (W, shape, K, iterations, FISTA)
    "4d-w2-k3": (2, (12, 4, 5, 6), 3, 6, True),
    "3d-w4-k2-hybrid": (4, (12, 8, 10), 2, (4, 2), True),
}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_matches_jax_sharded_temporal(case):
    """The JAX ``solve_outofcore_sharded_temporal`` with ``shard_w`` = W
    on W of the 8 fake CPU devices, and the port's on W ranks: the recon
    within rtol 2e-5 / atol 2e-6, the traces within rtol 2e-4 at the
    sweep ends, zeros between."""
    w, shape, k, iters, fista = JAX_CASES[case]
    cube = _cube(shape, 120 + w)
    li, lm = _scalars(len(shape))
    o = _opts(len(shape), iters, FISTA=fista)
    j = jooc.solve_outofcore_sharded_temporal(
        cube, li, lm, JOptions(**o), 2, k, shard_w=w,
        devices=jax.devices()[:w])
    res = on_mesh(w, lambda pg, r: tooc.solve_outofcore_sharded_temporal(
        cube, li, lm, SolverOptions(**o), 2, k, shard_w=w, group=pg,
        device="cpu"))
    np.testing.assert_allclose(res[0]["recon"], np.asarray(j["recon"]),
                               rtol=RTOL, atol=ATOL)
    for out in res:
        for key in ("b_norm", "delta"):
            np.testing.assert_allclose(out[key], j[key], rtol=TRACE_RTOL)
            assert ((out[key] != 0) == (np.asarray(j[key]) != 0)).all()
        assert int(out["iterations_run"]) == int(j["iterations_run"])


# -- (c) stop and MSE ----------------------------------------------------------

@pytest.mark.parametrize("p", [1, 2])
def test_stop_at_the_one_process_sweep(p):
    """A stop run stops at the sweep end where the one-process run stops,
    on every rank, bitwise."""
    cube = _cube((17, 6, 10), 130)
    free = _one_process(cube, 30, 2)
    d = free[2][free[2] != 0]
    # halfway between two sweep ends' deltas: far from both
    m = len(d) // 2
    thr = float(d[m] + d[m - 1]) / 2
    want = _one_process(cube, 30, 2, stopping_relative_change=thr)
    n_want = np.count_nonzero(want[2])
    assert n_want < np.count_nonzero(free[2])
    res = _on_grid(p, 2, cube, 2, 2, _opts(3, 30,
                                           stopping_relative_change=thr))
    np.testing.assert_array_equal(_stitch(res, cube.shape), want[0])
    for out in res:
        assert out["early_stopped"]
        assert np.count_nonzero(out["delta"]) == n_want
    _same_traces(res, want)


@pytest.mark.parametrize("p", [1, 2])
def test_mse_matches_the_one_process_run(p):
    cube, ref = _cube((13, 4, 5, 6), 131), _cube((13, 4, 5, 6), 132)
    want = _one_process(cube, 6, 3, reference_data=ref)
    res = _on_grid(p, 2, cube, 3, 2, _opts(4, 6, calculate_mse=True),
                   ref=ref)
    np.testing.assert_array_equal(_stitch(res, cube.shape), want[0])
    for out in res:
        np.testing.assert_allclose(out["mse"], want[3], rtol=TRACE_RTOL)
        np.testing.assert_array_equal(out["mse"], res[0]["mse"])
    assert (res[0]["mse"] != 0).sum() == (want[3] != 0).sum()


# -- (d) checkpoints -----------------------------------------------------------

@pytest.mark.parametrize("p,lossy", [(1, False), (2, True)],
                         ids=["1x2", "2x2-lossy"])
def test_kill_and_resume_bitwise(tmp_path, monkeypatch, p, lossy):
    """Every rank killed after the first generation of parts and resumed:
    every rank resumes from it, bitwise the uninterrupted run; each part's
    meta gives its rows, its columns and the mode (``sharded_temporal2``
    on one process-row, ``multihost_temporal2`` on two)."""
    cube = _cube((13, 4, 5, 6), 140 + p)
    o = _opts(4, (6, 4), lossy_duals=lossy)
    want = _on_grid(p, 2, cube, 2, 2, o)
    path = str(tmp_path / "ooc.npz")

    def kill(it_run):
        raise Killed(it_run)

    monkeypatch.setattr(tooc, "_POST_CKPT_HOOK", kill)
    errs = _errors(2 * p, lambda pg, r: _grid(
        pg, r, p, 2, cube, 2, 2, o, checkpoint_path=path,
        checkpoint_every=4))
    assert all(isinstance(e, Killed) and e.args == (4,) for e in errs)
    monkeypatch.setattr(tooc, "_POST_CKPT_HOOK", None)
    mode = "sharded_temporal2" if p == 1 else "multihost_temporal2"
    for q in range(2 * p):
        meta = _read_meta(f"{path}.ooc{q}")
        g0, g1 = tooc.process_row_range(13, p, q // 2)
        assert meta["mode"] == mode and meta["grows"] == [g0, g1, 13]
        assert meta["gcols"] == [2 * (q % 2), 2 * (q % 2) + 2, 4]
        assert meta["shape"] == [g1 - g0, 2, 5, 6]
    got = _on_grid(p, 2, cube, 2, 2, o, checkpoint_path=path,
                   checkpoint_every=4, resume=True)
    for g, w in zip(got, want):
        for key in ("recon", "b_norm", "delta", "iterations_run"):
            np.testing.assert_array_equal(g[key], w[key])
        assert g["resumed_from"] == 4


def test_mixed_generations_warn_on_every_rank(tmp_path, monkeypatch):
    """Rank 1's part a generation older than the others': every rank warns
    and starts afresh, bitwise the uninterrupted run."""
    cube = _cube((17, 6, 10), 150)
    o = _opts(3, 8)
    want = _on_grid(1, 2, cube, 2, 2, o)
    path = str(tmp_path / "ooc.npz")
    old = path + ".old"
    lock = threading.Lock()

    def keep(it_run):
        with lock:
            if it_run == 2 and not os.path.exists(old):
                shutil.copy(path + ".ooc1", old)

    monkeypatch.setattr(tooc, "_POST_CKPT_HOOK", keep)
    _on_grid(1, 2, cube, 2, 2, o, checkpoint_path=path, checkpoint_every=2)
    monkeypatch.setattr(tooc, "_POST_CKPT_HOOK", None)
    os.replace(old, path + ".ooc1")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        got = _on_grid(1, 2, cube, 2, 2, o, checkpoint_path=path,
                       checkpoint_every=2, resume=True)
    said = [str(w.message) for w in rec
            if "disagree or are incomplete" in str(w.message)]
    assert len(said) == 2  # one on each rank
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["recon"], w["recon"])
        assert g["resumed_from"] is None


@pytest.mark.parametrize("lossy", [False, True], ids=["exact", "lossy"])
def test_resume_cuts_a_jax_one_file_checkpoint(tmp_path, monkeypatch,
                                               lossy):
    """A one-file checkpoint of the JAX ``solve_outofcore_sharded_temporal``
    and no part: every rank cuts its block from it. From the finished
    file the stitched recon is bitwise the JAX recon; from a file killed
    after its save at iteration 4, every rank resumes from 4 and ends
    within tolerance of the JAX run."""
    cube = _cube((12, 4, 5, 6), 160)
    li, lm = _scalars(4)
    o = _opts(4, 8, lossy_duals=lossy)
    done = str(tmp_path / "done.npz")
    j = jooc.solve_outofcore_sharded_temporal(
        cube, li, lm, JOptions(**o), 2, 2, shard_w=2,
        devices=jax.devices()[:2], checkpoint_path=done)
    res = on_mesh(2, lambda pg, r: tooc.solve_outofcore_sharded_temporal(
        cube, li, lm, SolverOptions(**o), 2, 2, group=pg, device="cpu",
        checkpoint_path=done, resume=True))
    np.testing.assert_array_equal(res[0]["recon"], np.asarray(j["recon"]))
    assert [r["resumed_from"] for r in res] == [8, 8]

    mid = str(tmp_path / "mid.npz")
    real = jooc._ckpt_save

    def save_once(path, *a, **kw):
        real(path, *a, **kw)
        raise Killed

    monkeypatch.setattr(jooc, "_ckpt_save", save_once)
    with pytest.raises(Killed):
        jooc.solve_outofcore_sharded_temporal(
            cube, li, lm, JOptions(**o), 2, 2, shard_w=2,
            devices=jax.devices()[:2], checkpoint_path=mid,
            checkpoint_every=4)
    monkeypatch.setattr(jooc, "_ckpt_save", real)
    res = on_mesh(2, lambda pg, r: tooc.solve_outofcore_sharded_temporal(
        cube, li, lm, SolverOptions(**o), 2, 2, group=pg, device="cpu",
        checkpoint_path=mid, checkpoint_every=4, resume=True))
    assert [r["resumed_from"] for r in res] == [4, 4]
    np.testing.assert_allclose(res[0]["recon"], np.asarray(j["recon"]),
                               rtol=RTOL, atol=5e-7 if lossy else ATOL)
    for r in range(2):
        assert os.path.exists(f"{mid}.ooc{r}")


@pytest.mark.parametrize("stored", [True, False],
                         ids=["stored", "compressed"])
def test_block_read_of_a_one_file_checkpoint(tmp_path, stored):
    """``load_state_block`` gives ``load_state``'s state with the cube
    arrays cut to the block, bfloat16 shadow duals included; from a file
    that ``np.savez`` wrote, each array is a memmap of its member (only
    the block's bytes are read), and a compressed file is read whole."""
    cube = _cube((12, 4, 5, 6), 170)
    li, lm = _scalars(4)
    o = _opts(4, 4, lossy_duals=True)
    path = str(tmp_path / "one.npz")
    jooc.solve_outofcore_sharded_temporal(
        cube, li, lm, JOptions(**o), 2, 2, shard_w=2,
        devices=jax.devices()[:2], checkpoint_path=path)
    if not stored:
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        np.savez_compressed(path, **arrays)
    assert isinstance(tcheckpoint._npz_member(path, "recon"),
                      np.memmap) == stored
    whole = tcheckpoint.load_state(path)[0]
    sl = (slice(3, 10), slice(2, 4))
    got = tcheckpoint.load_state_block(path, sl)
    for k in ("recon", "accs", "ds"):
        want = whole[k] if k != "recon" else (whole[k],)
        have = got[k] if k != "recon" else (got[k],)
        assert len(have) == len(want) > 0
        for g, w_ in zip(have, want):
            if torch.is_tensor(w_):
                assert g.dtype == torch.bfloat16
                assert torch.equal(g, w_[sl])
            else:
                np.testing.assert_array_equal(g, w_[sl])
    for k in ("b_norm", "delta", "mse", "i", "early_stopped"):
        np.testing.assert_array_equal(got[k], whole[k])


# -- (e) the memory ladder and the pool ------------------------------------------

def test_out_of_memory_on_one_rank_takes_the_ladder(monkeypatch):
    """Rank 1 runs out of device memory reserving its pair bands: every
    rank warns once and runs K=1 launches with halos only, bitwise."""
    cube = _cube((13, 4, 5, 6), 170)
    want = _incore(cube, 7)
    real = tooc._pair_bands
    failed = []

    def bands(comm, orig, ax):
        if comm.ranks[comm.rank] == 1 and not failed:
            failed.append(1)
            raise torch.OutOfMemoryError("CUDA out of memory (simulated)")
        return real(comm, orig, ax)

    monkeypatch.setattr(tooc, "_pair_bands", bands)
    calls = _Calls(monkeypatch)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        res = _on_grid(1, 2, cube, 3, 2, _opts(4, 7))
    said = [w for w in rec if "temporal_pairs=False" in str(w.message)]
    assert len(said) == 2  # once on each rank
    np.testing.assert_array_equal(_stitch(res, cube.shape), want[0])
    assert not calls.pairs and not calls.plain and calls.k1


def test_pool_is_sealed_after_the_reservation(monkeypatch):
    """Three slabs (first, interior and last extended-slab shapes): every
    buffer the exchanges use was reserved before the first exchange, or
    the sealed pool would have refused it; a later allocation raises."""
    cube = _cube((15, 4, 3, 4), 171)
    seen = []
    real = tooc._Cols.reserve

    def reserve(self, *a, **kw):
        real(self, *a, **kw)
        assert self.comm.sealed
        seen.append(self)

    monkeypatch.setattr(tooc._Cols, "reserve", reserve)
    res = _on_grid(1, 2, cube, 3, 3, _opts(4, 6))
    np.testing.assert_array_equal(_stitch(res, cube.shape),
                                  _incore(cube, 6)[0])
    for cols in seen:
        with pytest.raises(RuntimeError, match="was not reserved"):
            cols.comm.buffer("late", (1,), torch.float32, "cpu")


# -- (f) refusals --------------------------------------------------------------

REFUSALS = {
    # name: (ranks, shape, keywords, message)
    "not-divisible": (2, (12, 5, 6), {}, "axis-1 extent 5 not divisible "
                                         "by 2 devices"),
    "one-column": (4, (12, 4, 6), {"shard_w": 4},
                   "axis-1 extent 4 over 4 devices leaves 1 column per "
                   "device"),
    "group-not-rows": (3, (12, 6, 6), {}, "a group of 3 processes does not "
                                          "form process-rows of shard_w=2"),
    "devices-length": (2, (12, 6, 6), {"devices": ["cpu"] * 3},
                       "devices holds 3 devices"),
    "global-cols": (2, (12, 6, 6), {"bad_cols": True},
                    "process 1's global_cols is not column block 1"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_on_every_rank(case):
    """Each refusal raises on every rank (the JAX message for the axis-1
    split), though one rank alone may be at fault."""
    n, shape, kw, match = REFUSALS[case]
    cube = _cube(shape, 180)
    li, lm = _scalars(3)
    kw = dict(kw)
    bad = kw.pop("bad_cols", False)
    w = kw.pop("shard_w", 2)

    def run(pg, r):
        cols = None
        local = cube
        if bad:
            c0, c1 = 3 * r, 3 * r + 3
            if r == 1:
                c0, c1 = 0, 3
            cols, local = (c0, c1, 6), cube[:, c0:c1]
        tooc.solve_outofcore_multihost(
            local, li, lm, SolverOptions(**_opts(3, 4)), 2, 2, (0, 12, 12),
            shard_w=w, device="cpu", group=pg, global_cols=cols, **kw)

    errs = _errors(n, run)
    for e in errs:
        assert isinstance(e, ValueError), repr(e)
        assert match in str(e), str(e)
    if case == "not-divisible":
        with pytest.raises(ValueError, match=match):
            jooc.solve_outofcore_sharded_temporal(
                cube, li, lm, JOptions(**_opts(3, 4)), 2, 2, shard_w=2,
                devices=jax.devices()[:2])


def test_sharded_temporal_refuses_a_width_not_the_group():
    cube = _cube((12, 6, 6), 181)
    li, lm = _scalars(3)
    errs = _errors(2, lambda pg, r: tooc.solve_outofcore_sharded_temporal(
        cube, li, lm, SolverOptions(**_opts(3, 4)), 2, 2, shard_w=3,
        group=pg, device="cpu"))
    for e in errs:
        assert isinstance(e, ValueError) and "shard_w=3" in str(e)
    with pytest.raises(ValueError, match="needs a process group"):
        tooc.solve_outofcore_sharded_temporal(
            cube, li, lm, SolverOptions(**_opts(3, 4)), 2, 2, device="cpu")
