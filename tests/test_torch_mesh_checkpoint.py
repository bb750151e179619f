"""Checkpoints of mesh runs in the port: the part files of
``cytvdn_tpu_torch.utils.checkpoint`` written by ``denoise_sharded`` on a
mesh of ranks (threads with their own gloo groups,
``test_torch_sharded.py::on_mesh``), the collective resume, and the EMD
writer of a mesh (``cytvdn_tpu_torch.io.emd.write_emd_sharded``), against
the JAX package's checkpoints (``cytvdn_tpu.utils.checkpoint``), its
``denoise_sharded`` on the 8 fake CPU devices and its EMD part writers.

Parts are bitwise the slices of the port's single-device checkpoint at the
same iteration (state; traces within rtol 1e-5, their sums added in
another order); against the JAX checkpoint the state is held to
``test_torch_sharded.py::test_mesh_matches_jax_run_sharded``'s float32
tolerance, rtol 2e-5 / atol 2e-6, and the lossy run's bfloat16 duals to
within one bfloat16 rounding step of the JAX lossy run's (rtol 2**-7).
A resumed mesh run is bitwise the uninterrupted mesh run (recon and
traces) and, in recon, the single-device run.
"""

import json
import os
import shutil
import zipfile

import h5py
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.experimental import multihost_utils  # noqa: E402

from test_torch_sharded import _cube, _single, on_mesh  # noqa: E402
from cytvdn_tpu.io import emd as jemd  # noqa: E402
from cytvdn_tpu.parallel.api import denoise_sharded as jdenoise  # noqa: E402
from cytvdn_tpu.utils import checkpoint as jck  # noqa: E402
from cytvdn_tpu_torch.config import SolverOptions as TOptions  # noqa: E402
from cytvdn_tpu_torch.io import emd as temd  # noqa: E402
from cytvdn_tpu_torch.parallel import MeshComm, denoise_sharded  # noqa: E402
from cytvdn_tpu_torch.parallel.multihost import (  # noqa: E402
    block_slices,
    rank_coords,
)
from cytvdn_tpu_torch.utils import checkpoint as tck  # noqa: E402

MESHES = {
    "2x1x1x1": ((16, 8, 6, 5), (2, 1, 1, 1), {}),
    "2x2x1x1": ((16, 8, 6, 5), (2, 2, 1, 1), {}),
    "3d-2x1x1": ((16, 9, 20), (2, 1, 1), {}),
    "lossy-2x1x1x1": ((16, 8, 6, 5), (2, 1, 1, 1), {"lossy_duals": True}),
}


class Killed(Exception):
    pass


def _mu(nd):
    return np.full(nd, 1.0, np.float32)


def _mesh_run(cube, shard, path=None, every=0, resume=False, catch=False,
              **kw):
    """``denoise_sharded`` on every rank of ``shard``; with ``catch`` each
    rank's error comes back as its result."""

    def rank(pg, r):
        try:
            return denoise_sharded(
                cube, _mu(cube.ndim), shard=shard, group=pg, device="cpu",
                checkpoint_path=path, checkpoint_every=every, resume=resume,
                **kw)
        except (ValueError, Killed) as e:
            if not catch:
                raise
            return e

    return on_mesh(int(np.prod(shard)), rank)


def _kill_after(monkeypatch, i_kill):
    """Saves go on; the first save at iteration ``i_kill`` or later raises
    ``Killed`` after it, on every rank (after the post-save collective)."""
    real = tck.save_state

    def save(path, state, meta, comm=None):
        out = real(path, state, meta, comm)
        if int(state["i"]) >= i_kill:
            raise Killed(int(state["i"]))
        return out

    monkeypatch.setattr(tck, "save_state", save)
    return real


def _part(path, r):
    return path if r == 0 else f"{path}.p{r}"


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}, json.loads(bytes(z["meta"]))


def _bits_or_float(a, bf16):
    """A part's array as float32 (bfloat16 bits widened exactly)."""
    if not bf16:
        return a
    return (a.astype(np.uint32) << 16).view(np.float32)


# -- the parts against the JAX checkpoint and the single-device one -----------

@pytest.mark.parametrize("case", sorted(MESHES))
def test_parts_match_jax_and_single_device(tmp_path, case):
    """A mesh run checkpointing every 2 iterations leaves one part per rank
    in the JAX package's multi-process format; each part holds its rank's
    slice of the JAX ``denoise_sharded`` checkpoint of the same run (the
    same generation: the last) and, bitwise, of the port's single-device
    ``run_chunked`` checkpoint."""
    shape, shard, kw = MESHES[case]
    cube = _cube(shape, seed=41)
    nd, n = len(shape), int(np.prod(shard))
    # a lossy run within the JAX lossy run's tolerance for a few
    # iterations only: past them one bfloat16 rounding of the two packages
    # tips apart (tests/test_torch_lossy.py)
    iters = 4 if kw.get("lossy_duals") else 6
    path = str(tmp_path / "mesh.npz")
    res = _mesh_run(cube, shard, path, every=2, iterations=iters, **kw)
    assert [len(r["saves"]) for r in res] == [iters // 2] * n
    assert all(s["bytes"] == os.path.getsize(_part(path, r))
               for r, out in enumerate(res) for s in out["saves"][-1:])

    jpath = str(tmp_path / "jax.npz")
    jdenoise(cube, 1.0, iterations=iters, shard=shard,
             devices=jax.devices()[:n], checkpoint_path=jpath,
             checkpoint_every=2, quiet=True, **kw)
    spath = str(tmp_path / "single.npz")
    div = 32.0 if nd == 4 else 16.0
    tck.run_chunked(cube, np.full(nd, div, np.float32),
                    np.full(nd, 1 / div, np.float32),
                    TOptions(ndim=nd, iterations_fista=iters,
                             iterations_unacc=0, **kw),
                    spath, 2, device="cpu")
    jz, jmeta = _load(jpath)
    sz, smeta = _load(spath)
    lossy = bool(kw.get("lossy_duals"))
    bf16 = set(smeta.get("bf16_keys", ()))
    assert bf16 == ({f"d{k}" for k in range(nd)} if lossy else set())
    for r in range(n):
        z, meta = _load(_part(path, r))
        sl = block_slices(shape, shard, rank_coords(shard, r))
        bounds = [[s.start, s.stop] for s in sl]
        assert meta["num_processes"] == n and meta["version"] == 1
        assert {k: meta[k] for k in ("ndim", "shape", "iterations_fista",
                                     "iterations_unacc", "lossy_duals")} \
            == {k: jmeta[k] for k in ("ndim", "shape", "iterations_fista",
                                      "iterations_unacc", "lossy_duals")}
        keys = ["recon"] + [f"{p}{k}" for p in ("acc", "d")
                            for k in range(nd)]
        assert sorted(meta["blocks"]) == sorted(keys)
        for key in keys:
            bm = meta["blocks"][key]
            is_bf16 = key in bf16
            assert bm == {"shape": list(shape),
                          "dtype": "bfloat16" if is_bf16 else "float32",
                          "bounds": [bounds], "bf16": is_bf16}
            got = z[f"{key}.b0"]
            assert got.dtype == (np.uint16 if is_bf16 else np.float32)
            np.testing.assert_array_equal(got, sz[key][sl], err_msg=key)
            want = jz[key]
            if is_bf16:
                np.testing.assert_allclose(
                    _bits_or_float(got, True),
                    _bits_or_float(want[sl], True), rtol=2**-7, atol=2e-6,
                    err_msg=key)
            else:
                np.testing.assert_allclose(got, want[sl], rtol=2e-5,
                                           atol=2e-6, err_msg=key)
        for key in ("i", "tk", "early_stopped", "mse"):
            np.testing.assert_array_equal(z[key], sz[key], err_msg=key)
            assert z[key].dtype == jz[key].dtype, key
        assert int(z["i"]) == iters
        for key in ("b_norm", "delta"):
            np.testing.assert_allclose(z[key], sz[key], rtol=1e-5)
            np.testing.assert_allclose(z[key], jz[key], rtol=2e-5, atol=2e-6)
            np.testing.assert_array_equal(z[key], _load(path)[0][key])


@pytest.mark.parametrize("case", ["2x2x1x1", "lossy-2x1x1x1"])
def test_jax_load_state_reads_port_parts(tmp_path, monkeypatch, case):
    """The JAX package's own ``load_state``, as process r of a
    multi-process run, reads the port's part r: its ``ShardedBlocks`` give
    back the port's block bitwise at the rank's index (bfloat16 duals
    as bfloat16), and its scalars are the part's."""
    shape, shard, kw = MESHES[case]
    cube = _cube(shape, seed=42)
    n = int(np.prod(shard))
    path = str(tmp_path / "mesh.npz")
    _mesh_run(cube, shard, path, every=3, iterations=3, **kw)
    monkeypatch.setattr(jax, "process_count", lambda: n)
    monkeypatch.setattr(multihost_utils, "process_allgather",
                        lambda x: np.stack([np.asarray(x)] * n))
    for r in range(n):
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        state, meta = jck.load_state(path)
        z, _ = _load(_part(path, r))
        index = block_slices(shape, shard, rank_coords(shard, r))
        assert int(state["i"]) == 3 and meta["num_processes"] == n
        for key, blocks in [("recon", state["recon"])] + [
                (f"acc{k}", a) for k, a in enumerate(state["accs"])] + [
                (f"d{k}", a) for k, a in enumerate(state["ds"])]:
            got = np.asarray(blocks.lookup(index))
            if kw.get("lossy_duals") and key.startswith("d"):
                assert got.dtype == jck._BF16
                got = got.view(np.uint16)
            np.testing.assert_array_equal(got, z[f"{key}.b0"], err_msg=key)
        np.testing.assert_array_equal(state["delta"], z["delta"])


# -- kill and resume ------------------------------------------------------------

KILLS = {
    "fista-2x1x1x1": ((16, 8, 6, 5), (2, 1, 1, 1), dict(iterations=8), 4),
    "hybrid-2x2x1x1": ((16, 8, 6, 5), (2, 2, 1, 1),
                       dict(iterations=(5, 4)), 6),
    "3d-2x1x1": ((16, 9, 20), (2, 1, 1), dict(iterations=7, FISTA=True), 2),
    "lossy-2x1x1x1": ((16, 8, 6, 5), (2, 1, 1, 1),
                      dict(iterations=8, lossy_duals=True), 4),
    # the checkpoint covers the whole schedule: resuming runs nothing
    "finished": ((16, 8, 6, 5), (2, 1, 1, 1), dict(iterations=6), 6),
}


@pytest.mark.parametrize("case", sorted(KILLS))
def test_kill_and_resume_bitwise(tmp_path, monkeypatch, case):
    """A mesh run stopped on every rank after a save and resumed
    (``resume=True``) is bitwise the uninterrupted mesh run and, in recon,
    the single-device run."""
    shape, shard, kw, i_kill = KILLS[case]
    cube = _cube(shape, seed=43)
    n = int(np.prod(shard))
    path = str(tmp_path / "mesh.npz")
    want = _mesh_run(cube, shard, **kw)
    real = _kill_after(monkeypatch, i_kill)
    killed = _mesh_run(cube, shard, path, every=2, catch=True, **kw)
    assert all(isinstance(e, Killed) for e in killed)
    monkeypatch.setattr(tck, "save_state", real)
    got = _mesh_run(cube, shard, path, every=2, resume=True, **kw)
    assert [g["resumed_from"] for g in got] == [i_kill] * n
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["block"], w["block"])
        np.testing.assert_array_equal(g["delta"], w["delta"])
        np.testing.assert_array_equal(g["b_norm"], w["b_norm"])
    np.testing.assert_array_equal(got[0]["recon"], want[0]["recon"])
    single = _single(cube, **kw)
    np.testing.assert_array_equal(got[0]["recon"], single[0])


def test_resume_of_an_early_stopped_run(tmp_path):
    """A stop run's last checkpoint holds the latch: resuming it runs no
    iteration and gives the stopped run's recon and traces."""
    cube = _cube((16, 8, 6, 5), seed=44)
    fixed = _single(cube, iterations=30)[2]
    kw = dict(iterations=30,
              stopping_relative_change=float(np.sqrt(fixed[9] * fixed[10])))
    n_stop = int(np.count_nonzero(_single(cube, **kw)[2]))
    assert n_stop == 11
    path = str(tmp_path / "mesh.npz")
    first = _mesh_run(cube, (2, 1, 1, 1), path, every=4, **kw)
    assert first[0]["iterations_run"] == n_stop
    with np.load(path) as z:
        assert bool(z["early_stopped"]) and int(z["i"]) == n_stop
    again = _mesh_run(cube, (2, 1, 1, 1), path, every=4, resume=True, **kw)
    for g, w in zip(again, first):
        assert g["resumed_from"] == n_stop and g["saves"] == []
        assert g["iterations_run"] == n_stop
        np.testing.assert_array_equal(g["block"], w["block"])
        np.testing.assert_array_equal(g["delta"], w["delta"])


# -- the vote, the generations, the refusals -------------------------------------

@pytest.mark.parametrize("lost", ["part", "master"])
def test_missing_part_starts_every_rank_afresh(tmp_path, lost):
    """One rank's part (or the master) missing: no rank resumes, every
    rank starts afresh, bitwise the uninterrupted run."""
    cube = _cube((16, 8, 6, 5), seed=45)
    path = str(tmp_path / "mesh.npz")
    want = _mesh_run(cube, (2, 1, 1, 1), path, every=2, iterations=6)
    os.remove(path + ".p1" if lost == "part" else path)
    got = _mesh_run(cube, (2, 1, 1, 1), path, every=2, resume=True,
                    iterations=6)
    for g, w in zip(got, want):
        assert g["resumed_from"] is None and len(g["saves"]) == 3
        np.testing.assert_array_equal(g["block"], w["block"])
        np.testing.assert_array_equal(g["delta"], w["delta"])


def test_mixed_generations_warn_and_start_afresh(tmp_path, monkeypatch):
    """Rank 1's part one generation older than rank 0's (a job that died
    between two ranks' saves): every rank warns and starts afresh, bitwise
    the uninterrupted run."""
    cube = _cube((16, 8, 6, 5), seed=46)
    path = str(tmp_path / "mesh.npz")
    want = _mesh_run(cube, (2, 1, 1, 1), iterations=8)
    real = _kill_after(monkeypatch, 2)
    _mesh_run(cube, (2, 1, 1, 1), path, every=2, catch=True, iterations=8)
    shutil.copy(path + ".p1", str(tmp_path / "old.p1"))
    _kill_after(monkeypatch, 4)
    _mesh_run(cube, (2, 1, 1, 1), path, every=2, resume=True, catch=True,
              iterations=8)
    with np.load(path) as z0, np.load(str(tmp_path / "old.p1")) as z1:
        assert (int(z0["i"]), int(z1["i"])) == (4, 2)
    shutil.copy(str(tmp_path / "old.p1"), path + ".p1")
    monkeypatch.setattr(tck, "save_state", real)
    with pytest.warns(UserWarning, match=r"disagree on iteration \(\[4 2\]\)"
                      ) as rec:
        got = _mesh_run(cube, (2, 1, 1, 1), path, every=2, resume=True,
                        iterations=8)
    assert sum("disagree on iteration" in str(w.message) for w in rec) == 2
    for g, w in zip(got, want):
        assert g["resumed_from"] is None
        np.testing.assert_array_equal(g["block"], w["block"])
        np.testing.assert_array_equal(g["delta"], w["delta"])


def test_refusals_reach_every_rank(tmp_path, monkeypatch):
    """Parts written by 2 ranks resumed on 4, and parts of a (2, 2, 1, 1)
    mesh resumed on (4, 1, 1, 1): every rank raises the JAX package's
    message, none hangs."""
    cube = _cube((16, 8, 6, 5), seed=47)
    two = str(tmp_path / "two.npz")
    _mesh_run(cube, (2, 1, 1, 1), two, every=2, iterations=4)
    errs = _mesh_run(cube, (4, 1, 1, 1), two, every=2, resume=True,
                     catch=True, iterations=4)
    msg = "checkpoint was written by 2 processes; this run has 4"
    assert [str(e) for e in errs] == [msg] * 4
    monkeypatch.setattr(jax, "process_count", lambda: 4)
    with pytest.raises(ValueError, match=msg):
        jck.load_state(two)
    monkeypatch.undo()

    quad = str(tmp_path / "quad.npz")
    _mesh_run(cube, (2, 2, 1, 1), quad, every=2, iterations=4)
    errs = _mesh_run(cube, (4, 1, 1, 1), quad, every=2, resume=True,
                     catch=True, iterations=4)
    assert all(isinstance(e, ValueError) for e in errs)
    for r, e in enumerate(errs):
        assert str(e).startswith("checkpoint resume asked for block "
                                 f"({(4 * r, 4 * r + 4)}, (0, 8), (0, 6), "
                                 f"(0, 5)) but this process saved [(")
        assert "same process count, device order and --shard tiling" \
            in str(e)
    # a checkpoint of another schedule: every rank refuses it alike
    errs = _mesh_run(cube, (2, 2, 1, 1), quad, every=2, resume=True,
                     catch=True, iterations=5)
    assert all("iterations_fista=4" in str(e) for e in errs)


def test_load_state_without_the_own_part(tmp_path, monkeypatch):
    """``load_state`` called on every rank where rank 1's part is gone:
    rank 1 raises the JAX package's message, rank 0 one naming rank 1,
    and neither waits for the other (``denoise_sharded``'s vote starts
    such a run afresh instead)."""
    cube = _cube((16, 8, 6, 5), seed=50)
    path = str(tmp_path / "mesh.npz")
    _mesh_run(cube, (2, 1, 1, 1), path, every=2, iterations=4)
    os.remove(path + ".p1")

    def rank(pg, r):
        try:
            tck.load_state(path, MeshComm(pg, (2, 1, 1, 1), r))
        except ValueError as e:
            return str(e)

    msgs = on_mesh(2, rank)
    own = (f"process 1 found the multi-process checkpoint master but not "
           f"its own part '{path}.p1'")
    assert msgs[1].startswith(own)
    assert msgs[0].startswith("ranks [1] of the mesh could not resume")
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "process_index", lambda: 1)
    with pytest.raises(ValueError) as e:
        jck.load_state(path)
    assert str(e.value) == msgs[1]


def _errors(n, fn):
    """``fn(group, rank)`` on ``n`` ranks; each rank's error (or None)."""

    def rank(pg, r):
        try:
            fn(pg, r)
        except Exception as e:
            return e

    return on_mesh(n, rank)


@pytest.mark.parametrize("failing", [0, 1])
def test_a_failed_save_reaches_every_rank(tmp_path, monkeypatch, failing):
    """One rank's part cannot be written (a full disk): that rank raises
    its error and the other one naming it, in the post-save collective;
    neither waits for the other."""
    cube = _cube((16, 8, 6, 5), seed=51)
    path = str(tmp_path / "mesh.npz")
    real = tck._atomic_savez

    def savez(p, arrays):
        if p == _part(path, failing):
            raise OSError(28, "No space left on device")
        real(p, arrays)

    monkeypatch.setattr(tck, "_atomic_savez", savez)
    errs = _errors(2, lambda pg, r: denoise_sharded(
        cube, _mu(4), shard=(2, 1, 1, 1), group=pg, device="cpu",
        checkpoint_path=path, checkpoint_every=2, iterations=4))
    assert "No space left on device" in str(errs[failing])
    other = errs[1 - failing]
    assert isinstance(other, OSError)
    assert str(other).startswith(
        f"ranks [{failing}] of the mesh failed to save its checkpoint part")


@pytest.mark.parametrize("broken", ["part", "master", "master-alone"])
def test_a_corrupt_checkpoint_reaches_every_rank(tmp_path, broken):
    """A truncated part (rank 1's, or the master, which is rank 0's; or
    the master with rank 1's part gone, which rank 1 then reads): the
    ranks vote to resume, the rank that reads the broken file raises its
    read error, every other rank an error naming it, and none hangs."""
    cube = _cube((16, 8, 6, 5), seed=52)
    path = str(tmp_path / "mesh.npz")
    _mesh_run(cube, (2, 1, 1, 1), path, every=2, iterations=4)
    bad = path + ".p1" if broken == "part" else path
    with open(bad, "rb") as f:
        head = f.read()[:1000]
    with open(bad, "wb") as f:
        f.write(head)
    if broken == "master-alone":
        os.remove(path + ".p1")
    errs = _errors(2, lambda pg, r: denoise_sharded(
        cube, _mu(4), shard=(2, 1, 1, 1), group=pg, device="cpu",
        checkpoint_path=path, checkpoint_every=2, resume=True,
        iterations=4))
    readers = {"part": [1], "master": [0], "master-alone": [0, 1]}[broken]
    for r, e in enumerate(errs):
        assert e is not None
        if r in readers:
            assert isinstance(e, zipfile.BadZipFile)
        else:
            assert isinstance(e, ValueError)
            assert str(e).startswith(
                f"ranks {readers} of the mesh could not resume from {path}")


def test_a_failed_emd_write_reaches_every_rank(tmp_path, monkeypatch):
    """Rank 1 cannot write its ``.part1.h5``: it raises its error, rank 0
    one naming it, and rank 0 stitches nothing."""
    monkeypatch.setattr(temd, "_GATHER_MAX_BYTES", 0)
    real = temd.write_emd_part

    def part(path, r, regions):
        if r == 1:
            raise OSError(13, "Permission denied")
        return real(path, r, regions)

    monkeypatch.setattr(temd, "write_emd_part", part)
    cube = _cube((16, 8, 6, 5), seed=53)
    out = str(tmp_path / "out.h5")

    def rank(pg, r):
        sl = block_slices(cube.shape, (2, 1, 1, 1), rank_coords((2, 1, 1, 1),
                                                                r))
        temd.write_emd_sharded(out, cube[sl].copy(), sl, cube.shape,
                               MeshComm(pg, (2, 1, 1, 1), r))

    errs = _errors(2, rank)
    assert "Permission denied" in str(errs[1])
    assert str(errs[0]).startswith(
        "ranks [1] of the mesh failed to write its part of the EMD output")
    assert not os.path.exists(str(tmp_path / "out.emd"))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_single_process_checkpoint_resumes_on_a_mesh(tmp_path, monkeypatch,
                                                     writer):
    """A single-process checkpoint (the port's or the JAX package's
    ``run_chunked``, killed after its save at iteration 4) resumes on a
    (2, 2, 1, 1) mesh, every rank cutting its block: bitwise the port's
    single-device resume of the same file."""
    cube = _cube((16, 8, 6, 5), seed=48)
    li, lm = np.full(4, 32.0, np.float32), np.full(4, 1 / 32, np.float32)
    path = str(tmp_path / "single.npz")
    mod = jck if writer == "jax" else tck
    real = mod.save_state

    def save(p, state, meta, *a):
        real(p, state, meta, *a)
        if int(np.asarray(state["i"])) >= 4:
            raise Killed

    monkeypatch.setattr(mod, "save_state", save)
    if writer == "jax":
        from cytvdn_tpu.config import SolverOptions as JOptions

        with pytest.raises(Killed):
            jck.run_chunked(cube, li, lm, JOptions(
                ndim=4, iterations_fista=6, iterations_unacc=3), path, 2)
    else:
        with pytest.raises(Killed):
            tck.run_chunked(cube, li, lm, TOptions(
                ndim=4, iterations_fista=6, iterations_unacc=3), path, 2,
                device="cpu")
    monkeypatch.setattr(mod, "save_state", real)
    mesh_path = str(tmp_path / "mesh.npz")
    shutil.copy(path, mesh_path)
    got = _mesh_run(cube, (2, 2, 1, 1), mesh_path, every=2, resume=True,
                    iterations=(6, 3))
    want = tck.run_chunked(cube, li, lm, TOptions(
        ndim=4, iterations_fista=6, iterations_unacc=3), path, 2,
        resume=True, device="cpu")
    assert [g["resumed_from"] for g in got] == [4] * 4
    np.testing.assert_array_equal(got[0]["recon"], want["recon"])
    np.testing.assert_allclose(got[0]["delta"], want["delta"], rtol=1e-5)
    # the mesh's own saves after the resume are parts
    with np.load(mesh_path + ".p3") as z:
        assert int(z["i"]) == 9


# -- the EMD writer of a mesh ---------------------------------------------------

def _surface(path):
    """Every object of an HDF5 file: name, kind, shape, dtype, attributes
    and, for datasets, the data (tests/test_torch_io.py's)."""
    out = []

    def visit(name, obj):
        entry = [name, type(obj).__name__,
                 sorted((k, repr(v)) for k, v in obj.attrs.items())]
        if isinstance(obj, h5py.Dataset):
            entry += [obj.shape, obj.dtype.str, obj[...].tobytes(),
                      obj.is_virtual]
        out.append(entry)

    with h5py.File(path, "r") as f:
        f.visititems(visit)
    return out


EMD_CASES = {
    # (shard, stitch, _GATHER_MAX_BYTES, _SOLID_STITCH_MAX_BYTES, kind)
    "gather-below": ((2, 1, 1, 1), "auto", 1 << 30, 1 << 30, "gather"),
    "gather-at": ((2, 2, 1, 1), "auto", 16 * 8 * 6 * 5 * 4, 0, "gather"),
    "solid-above": ((2, 1, 1, 1), "auto", 16 * 8 * 6 * 5 * 4 - 1, 1 << 30,
                    "solid"),
    "solid-at": ((2, 2, 1, 1), "auto", 0, 16 * 8 * 6 * 5 * 4, "solid"),
    "virtual-above": ((2, 2, 1, 1), "auto", 0, 16 * 8 * 6 * 5 * 4 - 1,
                      "virtual"),
    "stitch-solid": ((2, 1, 1, 1), "solid", 1 << 30, 0, "solid"),
    "stitch-virtual": ((2, 1, 1, 1), "virtual", 1 << 30, 1 << 30, "virtual"),
}


@pytest.mark.parametrize("case", sorted(EMD_CASES))
def test_write_emd_sharded(tmp_path, monkeypatch, case):
    """Every rank hands ``write_emd_sharded`` its block: the gathered cube
    written by rank 0 up to ``_GATHER_MAX_BYTES``, else parts stitched
    solid (parts deleted) up to ``_SOLID_STITCH_MAX_BYTES`` or virtual
    (parts kept), or as ``stitch=`` says. The JAX ``read_emd`` reads the
    cube back, and the files are, group for group, what the JAX package's
    ``write_emd``/``write_emd_part``/``stitch_emd_*`` write from the same
    regions."""
    shard, stitch, gmax, smax, kind = EMD_CASES[case]
    monkeypatch.setattr(temd, "_GATHER_MAX_BYTES", gmax)
    monkeypatch.setattr(temd, "_SOLID_STITCH_MAX_BYTES", smax)
    cube = _cube((16, 8, 6, 5), seed=49)
    n = int(np.prod(shard))
    out = str(tmp_path / "t" / "out.h5")
    os.makedirs(os.path.dirname(out))

    def rank(pg, r):
        comm = MeshComm(pg, shard, r)
        sl = block_slices(cube.shape, shard, rank_coords(shard, r))
        return temd.write_emd_sharded(out, cube[sl].copy(), sl, cube.shape,
                                      comm, stitch=stitch)

    got = on_mesh(n, rank)
    assert got == [str(tmp_path / "t" / "out.emd")] * n
    np.testing.assert_array_equal(jemd.read_emd(got[0]), cube)
    parts = sorted(p for p in os.listdir(tmp_path / "t") if ".part" in p)
    assert parts == ([f"out.emd.part{r}.h5" for r in range(n)]
                     if kind == "virtual" else [])

    jout = str(tmp_path / "j" / "out.emd")
    os.makedirs(os.path.dirname(jout))
    if kind == "gather":
        jemd.write_emd(jout, cube)
    else:
        for r in range(n):
            sl = block_slices(cube.shape, shard, rank_coords(shard, r))
            jemd.write_emd_part(jout, r, [(sl, cube[sl])])
        getattr(jemd, f"stitch_emd_{kind}")(jout, cube.shape, cube.dtype, n)
    assert _surface(got[0]) == _surface(jout)
    if kind == "virtual":
        for r in range(n):
            assert _surface(f"{got[0]}.part{r}.h5") \
                == _surface(f"{jout}.part{r}.h5")
