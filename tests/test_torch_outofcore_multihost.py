"""Multi-process out-of-core runs in the port
(``cytvdn_tpu_torch.solver.outofcore.solve_outofcore_multihost``) and the
raw-offset EMD row writers (``cytvdn_tpu_torch.io.emd``), on the CPU: the
ranks are threads, each with its own gloo group
(``test_torch_sharded.py::on_mesh``), on ``device="cpu"`` (the kernels'
plain versions), with small cubes made from a seed.

Tolerances:
- the stitched recon of 2 and 3 ranks (even and uneven row ranges) is
  bitwise the port's in-core ``denoise3D/4D`` run and its one-process
  ``denoise_outofcore`` at the same K, exact and lossy; a lossy run's
  bfloat16 duals (through the checkpoint parts) bitwise the in-core lossy
  run's; a killed and resumed run bitwise the uninterrupted one;
- the traces within rtol 2e-4 of the one-process run at the sweep-final
  entries (its sums are added per core in float32, then over the ranks,
  in another order; tests/test_torch_outofcore.py's temporal tolerance),
  zeros between; a stop run stops where the one-process run does;
- against the JAX package (``solve_outofcore_multihost`` in this one
  process and ``denoise_outofcore``): the recon within rtol 2e-5 / atol
  2e-6, the traces within rtol 2e-4 (tests/test_torch_outofcore.py's);
- every EMD output's datacube bitwise the port's ``write_emd`` of the
  whole cube, and the file's groups and attributes the JAX ``write_emd``'s.

Every refusal and every failure of one rank (a range that does not tile,
a wrong row count, a margin deeper than a slab core, a meta mismatch, a
truncated part, a failed write) raises on every rank, and no rank hangs
(each group has a timeout, each join a limit). ``shard_w`` > 1 (slabs
split over several cards) runs; tests/test_torch_outofcore_sharded.py
holds it.
"""

import json
import os
import re
import shutil
import threading
import warnings
import zipfile

import h5py
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from test_torch_sharded import on_mesh  # noqa: E402
from cytvdn_tpu.config import SolverOptions as JOptions  # noqa: E402
from cytvdn_tpu.io import emd as jemd  # noqa: E402
from cytvdn_tpu.solver import outofcore as jooc  # noqa: E402
from cytvdn_tpu_torch import denoise3D, denoise4D  # noqa: E402
from cytvdn_tpu_torch.config import SolverOptions, normalize_iterations  # noqa: E402
from cytvdn_tpu_torch.io import emd as temd  # noqa: E402
from cytvdn_tpu_torch.parallel.halo import MeshComm  # noqa: E402
from cytvdn_tpu_torch.solver import outofcore as tooc  # noqa: E402
from cytvdn_tpu_torch.utils import checkpoint as tck  # noqa: E402

RTOL, ATOL, TRACE_RTOL = 2e-5, 2e-6, 2e-4
C4 = (16, 4, 5, 6)
C3 = (17, 6, 10)
C4_25 = (25, 4, 5, 6)


class Killed(Exception):
    pass


def _cube(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 0.5 + 2.0).astype(np.float32)


def _mu(nd):
    return np.full(nd, 1.0, np.float32)


def _opts(nd, iterations, FISTA=True, **kw):
    n_f, n_u = normalize_iterations(iterations, FISTA)
    return dict(ndim=nd, iterations_fista=n_f, iterations_unacc=n_u, **kw)


def _scalars(nd):
    """λ⁻¹ and λ/μ of μ = 1 and the default λ = μ/32 (4D), μ/16 (3D)."""
    div = 32.0 if nd == 4 else 16.0
    return np.full(nd, div, np.float32), np.full(nd, 1 / div, np.float32)


def _solve(pg, r, n, cube, k, n_slabs, opts, ref=None, **kw):
    """Rank ``r`` of ``n``: its rows of ``cube`` through
    ``solve_outofcore_multihost``."""
    g0, g1 = tooc.process_row_range(cube.shape[0], n, r)
    li, lm = _scalars(cube.ndim)
    return tooc.solve_outofcore_multihost(
        cube[g0:g1], li, lm, SolverOptions(**opts), n_slabs, k,
        (g0, g1, cube.shape[0]),
        reference_local=None if ref is None else ref[g0:g1],
        device="cpu", group=pg, **kw)


def _ranks(n, cube, k, n_slabs, opts, **kw):
    return on_mesh(n, lambda pg, r: _solve(pg, r, n, cube, k, n_slabs, opts,
                                           **kw))


def _errors(n, fn):
    """``fn(group, rank)`` on ``n`` ranks; each rank's error (or None)."""

    def rank(pg, r):
        try:
            fn(pg, r)
        except Exception as e:
            return e

    return on_mesh(n, rank)


def _stitch(res):
    return np.concatenate([out["recon"] for out in res])


def _incore(cube, iterations, FISTA=True, **kw):
    fn = denoise4D if cube.ndim == 4 else denoise3D
    return fn(cube, _mu(cube.ndim), iterations=iterations, FISTA=FISTA,
              quiet=True, device="cpu", **kw)


def _one_process(cube, iterations, k, n_slabs=2, FISTA=True, **kw):
    return tooc.denoise_outofcore(cube, _mu(cube.ndim), iterations=iterations,
                                  FISTA=FISTA, n_slabs=n_slabs, temporal_k=k,
                                  device="cpu", **kw)


def _same_traces(res, want):
    """Every rank's traces: the same bits on every rank, within
    TRACE_RTOL of ``want`` (the one-process run's), zeros between the
    sweep-final entries."""
    for out in res:
        np.testing.assert_array_equal(out["b_norm"], res[0]["b_norm"])
        np.testing.assert_array_equal(out["delta"], res[0]["delta"])
        np.testing.assert_allclose(out["b_norm"], want[1], rtol=TRACE_RTOL)
        np.testing.assert_allclose(out["delta"], want[2], rtol=TRACE_RTOL)
        assert (out["delta"] == 0).sum() == (want[2] == 0).sum()


# -- (a) the row ranges ---------------------------------------------------------

@pytest.mark.parametrize("nproc", [1, 2, 3, 4, 5])
def test_process_row_range_matches_jax(nproc):
    for n0 in range(1, 41):
        got = [tooc.process_row_range(n0, nproc, p) for p in range(nproc)]
        assert got == [jooc.process_row_range(n0, nproc, p)
                       for p in range(nproc)]
        assert got[0][0] == 0 and got[-1][1] == n0
        sizes = [b - a for a, b in got]
        assert max(sizes) - min(sizes) <= 1


# -- (b) bitwise the in-core and the one-process runs -------------------------

RUNS = {
    # name: (ranks, shape, K, slabs per rank, iterations, FISTA)
    "2r-4d-k1-fista": (2, C4, 1, 2, 5, True),
    "2r-4d-k2-fista": (2, C4, 2, 2, 6, True),
    "2r-4d-k4-fista": (2, C4, 4, 2, 8, True),
    "2r-4d-k2-unacc": (2, C4, 2, 2, 6, False),
    "2r-4d-k4-hybrid": (2, C4, 4, 1, (5, 6), True),
    "2r-3d-k2-hybrid": (2, (16, 6, 10), 2, 2, (4, 3), True),
    "3r-3d-k1-fista": (3, C3, 1, 2, 4, True),
    "3r-3d-k2-fista": (3, C3, 2, 2, 6, True),
    "3r-3d-k2-hybrid": (3, C3, 2, 2, (3, 4), True),
    "3r-4d-k2-unacc": (3, (17, 4, 5, 6), 2, 2, 5, False),
    "3r-4d-k4-fista": (3, C4_25, 4, 2, 9, True),
    "3r-4d-k4-hybrid": (3, C4_25, 4, 2, (6, 5), True),
}


@pytest.mark.parametrize("case", sorted(RUNS))
def test_matches_incore_and_one_process(case):
    """The stitched recon of every rank's rows is bitwise the in-core run
    and the one-process out-of-core run at the same K; the traces, the
    same on every rank, within TRACE_RTOL of the one-process run's,
    sweep-final entries only (every entry at K=1); every rank reports its
    rows and the run's iterations."""
    n, shape, k, slabs, iters, fista = RUNS[case]
    cube = _cube(shape, 1 + len(case))
    res = _ranks(n, cube, k, slabs, _opts(len(shape), iters, fista))
    want = _incore(cube, iters, fista)
    np.testing.assert_array_equal(_stitch(res), want[0])
    one = _one_process(cube, iters, k, FISTA=fista)
    np.testing.assert_array_equal(one[0], want[0])
    _same_traces(res, one)
    final = one[2] != 0
    np.testing.assert_allclose(res[0]["delta"][final], want[2][final],
                               rtol=TRACE_RTOL)
    for r, out in enumerate(res):
        g0, g1 = tooc.process_row_range(shape[0], n, r)
        assert out["global_rows"].tolist() == [g0, g1, shape[0]]
        assert out["iterations_run"] == np.count_nonzero(want[2])
        assert not out["early_stopped"] and out["resumed_from"] is None
        # one exchange per sweep, and orig's once; an edge rank has one
        # neighbour, an interior one two
        sweeps = np.count_nonzero(out["delta"])
        ex = out["exchange"]
        assert ex["exchanges"] == sweeps + 1
        # the pool: one lane for orig's exchange, one for the state's
        assert ex["bytes_sent"] > 0 and ex["buffers"] == 2


def test_the_last_slab_is_the_band():
    """One slab per rank at K = its rows: every band a rank sends is rows
    its last (and only) slab wrote back in the sweep before; bitwise."""
    cube = _cube((8, 4, 5, 6), 61)
    res = _ranks(2, cube, 4, 1, _opts(4, 8))
    np.testing.assert_array_equal(_stitch(res), _incore(cube, 8)[0])


@pytest.mark.parametrize("lossy", [False, True], ids=["exact", "lossy"])
def test_bands_staged_as_under_nccl(monkeypatch, lossy):
    """The bands staged through a pooled buffer of the run's device, as
    under NCCL (here the CPU's, over gloo), bfloat16 duals widened to
    float32 and narrowed back: bitwise, with every buffer reserved before
    the first collective (the pool is sealed after it)."""
    real = tooc._Procs.__init__

    def staged(self, *a, **kw):
        real(self, *a, **kw)
        self.staged = True

    monkeypatch.setattr(tooc._Procs, "__init__", staged)
    cube = _cube((17, 4, 5, 6), 60)
    res = _ranks(3, cube, 2, 2, _opts(4, 6, lossy_duals=lossy))
    np.testing.assert_array_equal(_stitch(res),
                                  _incore(cube, 6, lossy_duals=lossy)[0])
    for out in res:
        # two lanes and the two stage buffers
        assert out["exchange"]["buffers"] == 4


# -- (c) stop and MSE ----------------------------------------------------------

@pytest.mark.parametrize("n,k", [(2, 2), (3, 1)])
def test_stop_at_the_one_process_iteration(n, k):
    """A stop run stops at the same sweep end on every rank, where the
    one-process run stops, with its recon bitwise."""
    cube = _cube(C3, 62)
    free = _one_process(cube, 30, k)
    d = free[2][free[2] != 0]
    # halfway between two sweep ends' deltas: far from both, beyond the
    # traces' tolerance
    m = len(d) // 2
    thr = float(d[m] + d[m - 1]) / 2
    want = _one_process(cube, 30, k, stopping_relative_change=thr)
    n_want = np.count_nonzero(want[2])
    assert n_want < np.count_nonzero(free[2])
    res = _ranks(n, cube, k, 2, _opts(3, 30, stopping_relative_change=thr))
    np.testing.assert_array_equal(_stitch(res), want[0])
    for out in res:
        assert out["early_stopped"]
        assert np.count_nonzero(out["delta"]) == n_want
        assert out["iterations_run"] == \
            (np.nonzero(want[2])[0][-1] + 1)
    _same_traces(res, want)


@pytest.mark.parametrize("n,k", [(2, 2), (3, 4)])
def test_mse_entries_match_the_one_process_run(n, k):
    cube, ref = _cube(C4_25, 63), _cube(C4_25, 64)
    want = _one_process(cube, 8, k, reference_data=ref)
    res = _ranks(n, cube, k, 2, _opts(4, 8, calculate_mse=True), ref=ref)
    np.testing.assert_array_equal(_stitch(res), want[0])
    for out in res:
        np.testing.assert_allclose(out["mse"], want[3], rtol=TRACE_RTOL)
        np.testing.assert_array_equal(out["mse"], res[0]["mse"])
    assert (res[0]["mse"] != 0).sum() == (want[3] != 0).sum()


# -- (d) lossy duals -----------------------------------------------------------

@pytest.mark.parametrize("n,k", [(2, 2), (3, 1), (2, 4)])
def test_lossy_bitwise_incore_duals_included(tmp_path, n, k):
    """A lossy run (bfloat16 d on the host and in the slabs) is bitwise the
    in-core lossy run: the recon, and d through the terminal checkpoint
    parts against the in-core checkpointed run's."""
    shape = C4_25 if k == 4 else (17, 4, 5, 6)
    cube = _cube(shape, 65 + k)
    path = str(tmp_path / "ooc.npz")
    res = _ranks(n, cube, k, 2, _opts(4, 8, lossy_duals=True),
                 checkpoint_path=path)
    want = _incore(cube, 8, lossy_duals=True)
    np.testing.assert_array_equal(_stitch(res), want[0])
    exact = _incore(cube, 8)
    assert np.max(np.abs(want[0] - exact[0])) > 1e-6
    incore = str(tmp_path / "incore.npz")
    tck.run_with_checkpointing(cube, _mu(4), iterations=8, lossy_duals=True,
                               checkpoint_path=incore, checkpoint_every=8,
                               device="cpu")
    with np.load(incore) as z:
        d_want = [z[f"d{j}"] for j in range(4)]
    parts = [np.load(f"{path}.ooc{r}") for r in range(n)]
    try:
        for j in range(4):
            d_got = np.concatenate([p[f"d{j}"] for p in parts])
            assert d_got.dtype == np.uint16
            np.testing.assert_array_equal(d_got, d_want[j])
    finally:
        for p in parts:
            p.close()


# -- (e) against the JAX package ----------------------------------------------

@pytest.mark.parametrize("k", [2, 4])
def test_matches_jax_multihost_and_denoise_outofcore(k):
    """The port's 3-rank run against the JAX ``solve_outofcore_multihost``
    in this one process (one process, one device) and the JAX
    ``denoise_outofcore`` at the same K."""
    cube = _cube(C4_25, 70 + k)
    iters = (6, 3) if k == 2 else (4, 4)
    o = _opts(4, iters)
    res = _ranks(3, cube, k, 2, o)
    li, lm = _scalars(4)
    j = jooc.solve_outofcore_multihost(
        cube, li, lm, JOptions(**o), 2, k, global_rows=(0, 25, 25),
        shard_w=1, devices=[jax.devices()[0]])
    got = _stitch(res)
    np.testing.assert_allclose(got, np.asarray(j["recon"]), rtol=RTOL,
                               atol=ATOL)
    for key in ("b_norm", "delta"):
        np.testing.assert_allclose(res[0][key], j[key], rtol=TRACE_RTOL)
    jd = jooc.denoise_outofcore(cube, _mu(4), iterations=iters, n_slabs=3,
                                temporal_k=k)
    np.testing.assert_allclose(got, np.asarray(jd[0]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(res[0]["delta"], jd[2], rtol=TRACE_RTOL)


# -- (f) checkpoints -----------------------------------------------------------

def _meta(path):
    with np.load(path) as z:
        return json.loads(bytes(z["meta"]).decode()), \
            {k: z[k] for k in z.files if k != "meta"}


@pytest.mark.parametrize("lossy", [False, True], ids=["exact", "lossy"])
def test_parts_are_jax_parts(tmp_path, lossy):
    """Each part holds what the JAX ``_ckpt_save`` writes for the same
    meta (keys, meta, arrays); the JAX ``_ckpt_resume`` reads it."""
    cube = _cube(C3, 80)
    path = str(tmp_path / "ooc.npz")
    o = _opts(3, (4, 2), lossy_duals=lossy)
    res = _ranks(2, cube, 2, 2, o, checkpoint_path=path, checkpoint_every=2)
    for r in range(2):
        g0, g1 = tooc.process_row_range(17, 2, r)
        part = f"{path}.ooc{r}"
        meta, arrays = _meta(part)
        want_meta = {**jooc._ckpt_meta(JOptions(**o), (g1 - g0, 6, 10),
                                       "multihost_temporal2"),
                     "proc": r, "nproc": 2, "grows": [g0, g1, 17]}
        assert {k: v for k, v in meta.items()
                if k not in ("version", "bf16_keys")} == want_meta
        np.testing.assert_array_equal(arrays["recon"], res[r]["recon"])
        assert int(arrays["i"]) == 6 and not bool(arrays["early_stopped"])
        jpath = str(tmp_path / f"jax{r}.npz")
        ds = [arrays[f"d{j}"] for j in range(3)]
        if lossy:
            import ml_dtypes

            ds = [d.view(ml_dtypes.bfloat16) for d in ds]
        jooc._ckpt_save(jpath, want_meta, 6, arrays["recon"],
                        [arrays[f"acc{j}"] for j in range(3)], ds,
                        arrays["b_norm"], arrays["delta"], None, False)
        jmeta, jarrays = _meta(jpath)
        assert meta == jmeta
        assert sorted(arrays) == sorted(jarrays)
        for key in arrays:
            np.testing.assert_array_equal(arrays[key], jarrays[key])
        st = jooc._ckpt_resume(part, True, want_meta, (g1 - g0, 6, 10))
        np.testing.assert_array_equal(st["recon"], res[r]["recon"])
        assert int(st["i"]) == 6


@pytest.mark.parametrize("n", [2, 3])
def test_kill_and_resume_bitwise(tmp_path, monkeypatch, n):
    """Every rank killed after the first generation (the hook runs after
    the post-save collective: every part is on disk) and resumed: every
    rank resumes from it, bitwise the uninterrupted run, the interior rank
    of three too; resuming the finished run changes nothing."""
    cube = _cube(C4_25, 81 + n)
    o = _opts(4, (6, 4))
    want = _ranks(n, cube, 2, 2, o)
    path = str(tmp_path / "ooc.npz")

    def kill(it_run):
        raise Killed(it_run)

    monkeypatch.setattr(tooc, "_POST_CKPT_HOOK", kill)
    errs = _errors(n, lambda pg, r: _solve(pg, r, n, cube, 2, 2, o,
                                           checkpoint_path=path,
                                           checkpoint_every=4))
    assert all(isinstance(e, Killed) and e.args == (4,) for e in errs)
    monkeypatch.setattr(tooc, "_POST_CKPT_HOOK", None)
    for _ in range(2):
        got = _ranks(n, cube, 2, 2, o, checkpoint_path=path,
                     checkpoint_every=4, resume=True)
        for g, w in zip(got, want):
            for key in ("recon", "b_norm", "delta", "iterations_run"):
                np.testing.assert_array_equal(g[key], w[key])
    assert [g["resumed_from"] for g in got] == [10] * n


def test_mixed_generations_warn_and_restart(tmp_path, monkeypatch):
    """Rank 1's part a generation older than rank 0's: every rank warns and
    starts afresh, bitwise the uninterrupted run."""
    cube = _cube(C3, 84)
    o = _opts(3, 8)
    want = _ranks(2, cube, 2, 2, o)
    path = str(tmp_path / "ooc.npz")
    old = path + ".old"
    lock = threading.Lock()

    def keep(it_run):
        # after the first generation's collective: rank 1's part of
        # iteration 2 is on disk, and no part of 4 is yet
        with lock:
            if it_run == 2 and not os.path.exists(old):
                shutil.copy(path + ".ooc1", old)

    monkeypatch.setattr(tooc, "_POST_CKPT_HOOK", keep)
    _ranks(2, cube, 2, 2, o, checkpoint_path=path, checkpoint_every=2)
    monkeypatch.setattr(tooc, "_POST_CKPT_HOOK", None)
    os.replace(old, path + ".ooc1")
    with np.load(path + ".ooc1") as z:
        assert int(z["i"]) == 2
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        got = _ranks(2, cube, 2, 2, o, checkpoint_path=path,
                     checkpoint_every=2, resume=True)
    said = [str(w.message) for w in rec
            if "disagree or are incomplete" in str(w.message)]
    assert len(said) == 2  # one on each rank
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["recon"], w["recon"])
        assert g["resumed_from"] is None


def test_a_meta_mismatch_on_one_rank_raises_on_every_rank(tmp_path):
    cube = _cube(C3, 85)
    o = _opts(3, 4)
    path = str(tmp_path / "ooc.npz")
    _ranks(2, cube, 2, 2, o, checkpoint_path=path, checkpoint_every=2)
    # rank 1's part from a run of another schedule
    st, meta = tck.load_state(path + ".ooc1")
    meta["iterations_fista"] = 6
    tck.save_state(path + ".ooc1", st, meta)
    errs = _errors(2, lambda pg, r: _solve(
        pg, r, 2, cube, 2, 2, o, checkpoint_path=path, checkpoint_every=2,
        resume=True))
    for e in errs:
        assert isinstance(e, ValueError)
        assert str(e).startswith("multihost out-of-core resume rejected on "
                                 "at least one process: ")
    assert "iterations_fista=6" in str(errs[1])
    assert "a peer's checkpoint meta" in str(errs[0])


@pytest.mark.parametrize("broken", [0, 1])
def test_a_truncated_part_raises_on_every_rank(tmp_path, broken):
    cube = _cube(C3, 86)
    o = _opts(3, 4)
    path = str(tmp_path / "ooc.npz")
    _ranks(2, cube, 2, 2, o, checkpoint_path=path, checkpoint_every=2)
    part = f"{path}.ooc{broken}"
    with open(part, "rb") as f:
        head = f.read()[:1000]
    with open(part, "wb") as f:
        f.write(head)
    errs = _errors(2, lambda pg, r: _solve(
        pg, r, 2, cube, 2, 2, o, checkpoint_path=path, checkpoint_every=2,
        resume=True))
    assert isinstance(errs[broken], zipfile.BadZipFile)
    other = errs[1 - broken]
    assert isinstance(other, ValueError)
    assert str(other).startswith(
        f"ranks [{broken}] of the mesh could not read its out-of-core "
        f"checkpoint part")


def test_a_failed_save_raises_on_every_rank(tmp_path, monkeypatch):
    cube = _cube(C3, 87)
    path = str(tmp_path / "ooc.npz")
    real = tck._atomic_savez

    def savez(p, arrays):
        if p.endswith(".ooc1"):
            raise OSError(28, "No space left on device")
        real(p, arrays)

    monkeypatch.setattr(tck, "_atomic_savez", savez)
    errs = _errors(2, lambda pg, r: _solve(
        pg, r, 2, cube, 2, 2, _opts(3, 4), checkpoint_path=path,
        checkpoint_every=2))
    assert "No space left on device" in str(errs[1])
    assert isinstance(errs[0], OSError) and str(errs[0]).startswith(
        "ranks [1] of the mesh failed to save its out-of-core checkpoint part")


# -- (g) validation ------------------------------------------------------------

REFUSALS = {
    # name: (per-rank (rows given, global_rows), keywords, error, message)
    "ranges-do-not-tile": (lambda r: ((0, 8), (0, 8, 17)) if r == 0
                           else ((9, 17), (9, 17, 17)), {}, ValueError,
                           "do not tile"),
    "ranges-do-not-cover": (lambda r: ((0, 8), (0, 8, 17)) if r == 0
                            else ((8, 16), (8, 16, 17)), {}, ValueError,
                            "do not cover"),
    "wrong-row-count": (lambda r: ((0, 8), (0, 8, 17)) if r == 0
                        else ((8, 16), (8, 17, 17)), {}, ValueError,
                        "orig_local has 8 rows; global_rows declares 9"),
    "k-over-core": (lambda r: ((0, 8), (0, 8, 17)) if r == 0
                    else ((8, 17), (8, 17, 17)), {"k": 5}, ValueError,
                    "temporal_k=5 exceeds the smallest local slab core "
                    "\\(4 rows of 8\\)"),
    # ported (Queue 1 item 11(b)): the two ranks split every slab on axis 1,
    # each holding all 17 rows and its 3 of the 6 columns; they run
    "shard-w": (lambda r: ((0, 17), (0, 17, 17)), {"shard_w": 2}, None,
                None),
    "devices": (lambda r: ((0, 17), (0, 17, 17)),
                {"devices": ["cpu", "cpu"]}, None, None),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_on_every_rank(case):
    """Each refusal raises the JAX message on every rank, though only one
    rank's arguments are at fault. The cases since ported (slabs split
    over two ranks' cards: ``shard_w=2``, or two ``devices`` with the
    default ``shard_w=0``, one device each) run: each rank's column block
    is bitwise the in-core run's."""
    rows, kw, exc, match = REFUSALS[case]
    cube = _cube(C3, 90)
    li, lm = _scalars(3)
    kw = dict(kw)
    k = kw.pop("k", 2)

    def run(pg, r):
        (a, b), grows = rows(r)
        return tooc.solve_outofcore_multihost(
            cube[a:b], li, lm, SolverOptions(**_opts(3, 4)), 2, k, grows,
            device="cpu", group=pg, **kw)

    if exc is None:
        want = _incore(cube, 4)[0]
        for r, out in enumerate(on_mesh(2, run)):
            assert out["slices"][1] == slice(3 * r, 3 * r + 3)
            np.testing.assert_array_equal(out["recon"],
                                          want[out["slices"]])
        return
    errs = _errors(2, run)
    for e in errs:
        assert isinstance(e, exc), repr(e)
        assert re.search(match, str(e)), str(e)
    if case in ("ranges-do-not-tile", "wrong-row-count"):
        # the JAX function raises the same message
        (a, b), grows = rows(1)
        with pytest.raises(ValueError, match=match):
            jooc.solve_outofcore_multihost(
                cube[a:b], li, lm, JOptions(**_opts(3, 4)), 2, 2, grows,
                shard_w=1, devices=[jax.devices()[0]])


# -- (h) the EMD row writers ----------------------------------------------------

def _surface(path):
    """Every object of an HDF5 file but the datacube's data: name, kind,
    shape, dtype, attributes."""
    out = []

    def visit(name, obj):
        entry = [name, type(obj).__name__,
                 sorted((k, repr(v)) for k, v in obj.attrs.items())]
        if isinstance(obj, h5py.Dataset):
            entry += [obj.shape, obj.dtype.str]
            if not name.endswith("/data"):
                entry.append(obj[...].tobytes())
        out.append(entry)

    with h5py.File(path, "r") as f:
        f.visititems(visit)
        top = sorted(f.attrs.keys())
    return top, out


WRITERS = {
    # name: (ranks, rows, environment, writer)
    "raw-2": (2, 16, {}, "multihost"),
    "raw-3-uneven": (3, 17, {}, "multihost"),
    "ring-3-uneven": (3, 17, {"CYTV_NO_RAW_WRITES": "1"}, "multihost"),
    "no-shared-fs-2": (2, 17, {"CYTV_NO_SHARED_FS": "1"}, "multihost"),
    "no-shared-fs-3": (3, 17, {"CYTV_NO_SHARED_FS": "1"}, "multihost"),
    "gathered-3-uneven": (3, 17, {}, "gathered"),
}


@pytest.mark.parametrize("case", sorted(WRITERS))
def test_row_writers(tmp_path, monkeypatch, case):
    """Every rank writes its rows: the datacube is bitwise the port's
    ``write_emd`` of the whole cube, and the file's groups and attributes
    are the JAX ``write_emd``'s (no probe nonce left). Where the ranks
    share no filesystem the row writer returns None on every rank and
    removes its file, and the gathered writer (chunks of 5 rows) writes
    it on rank 0."""
    n, n0, env, writer = WRITERS[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cube = _cube((n0, 5, 6, 7), 91)
    out = str(tmp_path / "out.emd")

    def write(pg, r):
        comm = MeshComm(pg, (n,), r)
        g0, g1 = tooc.process_row_range(n0, n, r)
        got = None
        if writer == "multihost":
            got = temd.write_emd_rows_multihost(out, cube.shape, np.float32,
                                                cube[g0:g1], (g0, g1), comm)
        if got is None:
            got = temd.write_emd_rows_gathered(out, cube.shape, np.float32,
                                               cube[g0:g1], (g0, g1), 5,
                                               comm)
            return ("gathered", got)
        return ("rows", got)

    res = on_mesh(n, write)
    kind = "gathered" if "no-shared" in case or writer == "gathered" \
        else "rows"
    assert [k for k, _ in res] == [kind] * n
    if kind == "rows":
        assert [p for _, p in res] == [out] * n
    else:
        assert res[0][1] == out and all(p is None for _, p in res[1:])
    np.testing.assert_array_equal(temd.read_emd(out), cube)
    whole = temd.write_emd(str(tmp_path / "whole.emd"), cube)
    jwhole = jemd.write_emd(str(tmp_path / "jwhole.emd"), cube)
    # the root's attributes among them: no probe nonce left
    assert _surface(out) == _surface(whole) == _surface(jwhole)


@pytest.mark.parametrize("writer", ["raw", "ring", "gathered"])
def test_a_failed_row_write_raises_on_every_rank(tmp_path, monkeypatch,
                                                 writer):
    """Rank 1's rows cannot be written (raw or ring), or rank 0 cannot
    write the gathered chunks: every rank raises, none hangs."""
    n, n0 = 2, 17
    cube = _cube((n0, 5, 6, 7), 92)
    out = str(tmp_path / "out.emd")
    if writer == "raw":
        real = temd._pwrite_rows

        def pwrite(path, offset, row_bytes, rows, g0, dtype):
            if g0 > 0:
                raise OSError(5, "Input/output error")
            return real(path, offset, row_bytes, rows, g0, dtype)

        monkeypatch.setattr(temd, "_pwrite_rows", pwrite)
    elif writer == "ring":
        monkeypatch.setenv("CYTV_NO_RAW_WRITES", "1")
    else:
        out = str(tmp_path / "missing" / "out.emd")

    def write(pg, r):
        comm = MeshComm(pg, (n,), r)
        g0, g1 = tooc.process_row_range(n0, n, r)
        rows = cube[g0:g1]
        if writer == "ring" and r == 1:
            rows = cube[g0:g1, :4]  # rows of another shape: the write fails
        if writer == "gathered":
            return temd.write_emd_rows_gathered(
                out, cube.shape, np.float32, rows, (g0, g1), 5, comm)
        return temd.write_emd_rows_multihost(out, cube.shape, np.float32,
                                             rows, (g0, g1), comm)

    errs = _errors(n, write)
    failing = 0 if writer == "gathered" else 1
    assert errs[failing] is not None
    other = errs[1 - failing]
    assert isinstance(other, OSError), repr(other)
    assert str(other).startswith(f"ranks [{failing}] of the mesh")
