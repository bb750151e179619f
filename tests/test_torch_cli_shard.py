"""The port's command line on a mesh: ``cytv-torch --device cpu --shard``
in two real processes with torchrun's environment (gloo), against the JAX
package's ``cytv --shard`` in this process (its 8 fake CPU devices) and
the port's one-process ``cytv-torch --device cpu`` on the same ``.npy``;
and ``cytv-torch --out-of-core N --temporal K`` in two processes (each its
rows, the row writers), against the port's one-process ``--out-of-core``
and the JAX ``cytv --out-of-core``.

The mesh's recon is bitwise the one-process run's, and within
tests/test_torch_cli.py's tolerances of the JAX command's (rtol 2e-5 /
atol 2e-6 in float32, 1e-12 in float64). Each launch has a time limit of
its own, so a rank that hangs fails the test.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_mesh_checkpoint import Killed, _kill_after, _mesh_run  # noqa: E402
from test_torch_sharded import REPO, _free_port, on_mesh  # noqa: E402
from cytvdn_tpu import cli as jcli  # noqa: E402
from cytvdn_tpu.io.emd import read_emd as jread  # noqa: E402
from cytvdn_tpu_torch import cli as tcli  # noqa: E402
from cytvdn_tpu_torch.config import SolverOptions  # noqa: E402
from cytvdn_tpu_torch.io.emd import read_emd as tread  # noqa: E402
from cytvdn_tpu_torch.solver import outofcore as tooc  # noqa: E402
from cytvdn_tpu_torch.utils import checkpoint as tck  # noqa: E402

TOL = {np.float32: dict(rtol=2e-5, atol=2e-6),
       np.float64: dict(rtol=1e-12, atol=1e-12)}
SHAPE = (8, 4, 6, 8)
FLAGS = ["-m", "1.0", "-n", "6", "-f", "1"]
LAUNCH_TIMEOUT = 120


def _cube(dtype=np.float32, seed=61):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(SHAPE) * 0.3 + 1.0).astype(dtype)


def _launch(argv, n=2, env=None):
    """``python -m cytvdn_tpu_torch.cli ARGV`` as ``n`` processes with
    torchrun's environment; returns each rank's (rc, stdout, stderr)."""
    port = _free_port()
    procs = []
    for r in range(n):
        e = dict(os.environ, WORLD_SIZE=str(n), RANK=str(r),
                 LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n),
                 MASTER_ADDR="localhost", MASTER_PORT=str(port),
                 PYTHONPATH=REPO, **(env or {}))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "cytvdn_tpu_torch.cli", *argv], cwd=REPO,
            env=e, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=LAUNCH_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            p.kill()
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]


def _ok(runs):
    for r, (rc, out, err) in enumerate(runs):
        assert rc == 0, f"rank {r}: {err[-3000:]}"
    return runs


def _one_process(tmp_path, inp, *flags):
    out = str(tmp_path / "one.emd")
    assert tcli.main(["-i", inp, "-o", out, "-v", "0", "--device", "cpu",
                      *flags]) == 0
    return tread(out)


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
def test_shard_command_matches_cytv(tmp_path, dtype):
    """``--shard 2,1,1,1`` in two processes: bitwise the one-process
    command, and the JAX ``cytv --shard 2,1,1,1``'s recon within
    tolerance. A float32 input is opened lazily (each rank reads its
    block), a float64 one loaded whole; only rank 0 logs, with its tag."""
    inp = str(tmp_path / "in.npy")
    np.save(inp, _cube(dtype))
    dflags = ["--dtype", "float64"] if dtype == np.float64 else []
    out = str(tmp_path / "mesh.emd")
    runs = _ok(_launch(["-i", inp, "-o", out, "--device", "cpu", *FLAGS,
                        *dflags, "--shard", "2,1,1,1"]))
    log0 = runs[0][1]
    assert ("opened" if dtype == np.float32 else "loaded") in log0
    assert "[cytv-torch p0] mesh (2, 1, 1, 1) of 2 processes" in log0
    assert f"[cytv-torch p0] wrote {out}" in log0
    assert runs[1][1] == ""
    got = tread(out)
    assert got.dtype == dtype
    np.testing.assert_array_equal(
        got, _one_process(tmp_path, inp, *FLAGS, *dflags))
    jout = str(tmp_path / "j.emd")
    assert jcli.main(["-i", inp, "-o", jout, "-v", "0", *FLAGS, *dflags,
                      "--shard", "2,1,1,1"]) == 0
    np.testing.assert_allclose(got, jread(jout), **TOL[dtype])


def test_shard_command_checkpoint_and_resume(tmp_path, monkeypatch):
    """Two processes without ``--shard`` (``auto``) and with
    ``--checkpoint``: every rank writes its part, each log line carries its
    rank (``CYTV_LOG_ALL_PROCS``), and the recon is bitwise the
    one-process command's and within tolerance of ``cytv --shard 2,1,1,1
    --checkpoint``'s. Then parts of the same run killed at iteration 2 (a
    mesh of threads) resume in the command (``--resume 1``): bitwise the
    uninterrupted run."""
    cube = _cube()
    inp = str(tmp_path / "in.npy")
    np.save(inp, cube)
    one = _one_process(tmp_path, inp, *FLAGS)
    ck = str(tmp_path / "ck.npz")
    out = str(tmp_path / "mesh.emd")
    runs = _ok(_launch(["-i", inp, "-o", out, "--device", "cpu", *FLAGS,
                        "--checkpoint", ck, "--checkpoint-every", "2"],
                       env={"CYTV_LOG_ALL_PROCS": "1"}))
    for r, (_, log, _) in enumerate(runs):
        assert f"[cytv-torch p{r}] multi-process run without --shard: " \
               f"defaulting to --shard auto" in log
        assert f"[cytv-torch p{r}] checkpoint save 3: copy" in log
    np.testing.assert_array_equal(tread(out), one)
    for part in (ck, ck + ".p1"):
        with np.load(part) as z:
            assert int(z["i"]) == 6 and "recon.b0" in z.files
    jout = str(tmp_path / "j.emd")
    assert jcli.main(["-i", inp, "-o", jout, "-v", "0", *FLAGS, "--shard",
                      "2,1,1,1", "--checkpoint", str(tmp_path / "j.npz"),
                      "--checkpoint-every", "2"]) == 0
    np.testing.assert_allclose(tread(out), jread(jout), **TOL[np.float32])

    killed = str(tmp_path / "killed.npz")
    _kill_after(monkeypatch, 2)
    errs = _mesh_run(cube, (2, 1, 1, 1), killed, every=2, catch=True,
                     iterations=6)
    assert all(isinstance(e, Killed) for e in errs)
    with np.load(killed + ".p1") as z:
        assert int(z["i"]) == 2
    out2 = str(tmp_path / "resumed.emd")
    runs = _ok(_launch(["-i", inp, "-o", out2, "--device", "cpu", *FLAGS,
                        "--shard", "2,1,1,1", "--checkpoint", killed,
                        "--checkpoint-every", "2", "--resume", "1"]))
    assert "; resumed from iteration 2" in runs[0][1]
    np.testing.assert_array_equal(tread(out2), one)
    with np.load(killed) as z:
        assert int(z["i"]) == 6
    assert tck.checkpoint_exists(killed)


OOC = ["-m", "1.0", "-n", "6", "-f", "1", "--out-of-core", "2", "--temporal",
       "2"]


@pytest.mark.parametrize("shared", [True, False], ids=["rows", "gathered"])
def test_outofcore_command_on_two_processes(tmp_path, shared):
    """``--out-of-core 2 --temporal 2`` in two processes: each reads only its
    rows and writes them, every rank into the one file or (with
    ``CYTV_NO_SHARED_FS=1``) gathered to rank 0 in slab-sized chunks; the
    datacube is bitwise the one-process command's and within tolerance of
    the JAX ``cytv --out-of-core 2 --temporal 2``'s."""
    inp = str(tmp_path / "in.npy")
    np.save(inp, _cube())
    out = str(tmp_path / "mesh.emd")
    env = {"CYTV_LOG_ALL_PROCS": "1"}
    if not shared:
        env["CYTV_NO_SHARED_FS"] = "1"
    runs = _ok(_launch(["-i", inp, "-o", out, "--device", "cpu", *OOC],
                       env=env))
    for r, (_, log, _) in enumerate(runs):
        rows = tooc.process_row_range(SHAPE[0], 2, r)
        assert (f"[cytv-torch p{r}] multi-process out-of-core: rows "
                f"[{rows[0]}, {rows[1]}) of {SHAPE[0]}, 2 processes") in log
        how = ("every rank its rows" if shared else
               "rows gathered to rank 0 in chunks of 2")
        assert f"[cytv-torch p{r}] wrote {out} ({how})" in log
    got = tread(out)
    np.testing.assert_array_equal(got, _one_process(tmp_path, inp, *OOC))
    jout = str(tmp_path / "j.emd")
    assert jcli.main(["-i", inp, "-o", jout, "-v", "0", *OOC]) == 0
    np.testing.assert_allclose(got, jread(jout), **TOL[np.float32])


def test_outofcore_command_resumes_killed_parts(tmp_path, monkeypatch):
    """Parts of the same run killed after their first generation (every
    rank stopped after the post-save collective; ranks as threads) resume
    in the command (``--resume 1``): every rank from iteration 2, bitwise
    the uninterrupted one-process command."""
    cube = _cube()
    inp = str(tmp_path / "in.npy")
    np.save(inp, cube)
    one = _one_process(tmp_path, inp, *OOC)
    ck = str(tmp_path / "ck.npz")

    def kill(it_run):
        raise Killed(it_run)

    monkeypatch.setattr(tooc, "_POST_CKPT_HOOK", kill)
    li, lm = np.full(4, 32.0, np.float32), np.full(4, 1 / 32, np.float32)

    def rank(pg, r):
        g0, g1 = tooc.process_row_range(SHAPE[0], 2, r)
        try:
            tooc.solve_outofcore_multihost(
                cube[g0:g1], li, lm, SolverOptions(
                    ndim=4, iterations_fista=6, iterations_unacc=0), 2, 2,
                (g0, g1, SHAPE[0]), checkpoint_path=ck, checkpoint_every=2,
                device="cpu", group=pg)
        except Killed as e:
            return e.args[0]

    assert on_mesh(2, rank) == [2, 2]
    monkeypatch.setattr(tooc, "_POST_CKPT_HOOK", None)
    out = str(tmp_path / "resumed.emd")
    runs = _ok(_launch(["-i", inp, "-o", out, "--device", "cpu", *OOC,
                        "--checkpoint", ck, "--checkpoint-every", "2",
                        "--resume", "1"], env={"CYTV_LOG_ALL_PROCS": "1"}))
    for r, (_, log, _) in enumerate(runs):
        assert "; resumed from iteration 2" in log
    np.testing.assert_array_equal(tread(out), one)
    for r in range(2):
        with np.load(f"{ck}.ooc{r}") as z:
            assert int(z["i"]) == 6


def test_outofcore_command_refuses_split_slabs(tmp_path):
    """In two processes ``--out-of-core`` with ``--shard 2`` (slabs split
    over two cards, Queue 1 item 11(b)) runs: bitwise the one-process
    command. A per-axis tiling exits 2 with ``cytv``'s message, and
    ``--shard 3`` (not a divisor of the launch's 2 processes) with the
    ``torchrun`` to start, on both ranks, before the input is read."""
    inp = str(tmp_path / "in.npy")
    np.save(inp, _cube())
    out = str(tmp_path / "mesh.emd")
    _ok(_launch(["-i", inp, "-o", out, "--device", "cpu", *OOC,
                 "--shard", "2"]))
    np.testing.assert_array_equal(tread(out), _one_process(tmp_path, inp,
                                                           *OOC))
    missing = str(tmp_path / "missing.npy")
    for shard, said in (("2,1,1,1", "out-of-core takes a device COUNT or "
                                    "'auto', not a per-axis tiling"),
                        ("3", "this launch has 2 (WORLD_SIZE), not a "
                              "multiple of 3; start 3 (or a multiple): "
                              "torchrun --nproc-per-node 3")):
        runs = _launch(["-i", missing, "-o", out, "--device", "cpu", *OOC,
                        "--shard", shard])
        for rc, _, err in runs:
            assert rc == 2 and said in err, err


def _incore_recon(cube, iterations=6):
    from cytvdn_tpu_torch import denoise4D

    return denoise4D(cube, np.full(4, 1.0, np.float32),
                     iterations=iterations, quiet=True, device="cpu")[0]


@pytest.mark.parametrize("n", [2, 4], ids=["1x2", "2x2"])
def test_outofcore_split_slabs_command(tmp_path, n):
    """``--out-of-core 2 --temporal 2 --shard 2`` on 2 processes (one
    process-row) and on 4 (a 2 × 2 grid): each rank reads only its rows ×
    columns block and logs it, and the EMD output's datacube, written
    through ``write_emd_sharded`` (gathered to rank 0), is bitwise the
    in-core recon and the one-process command's, and within tolerance of
    the JAX ``cytv --out-of-core 2 --temporal 2 --shard 2``'s."""
    cube = _cube()
    inp = str(tmp_path / "in.npy")
    np.save(inp, cube)
    out = str(tmp_path / "mesh.emd")
    runs = _ok(_launch(["-i", inp, "-o", out, "--device", "cpu", *OOC,
                        "--shard", "2"], n=n,
                       env={"CYTV_LOG_ALL_PROCS": "1"}))
    for q, (_, log, _) in enumerate(runs):
        r, c = divmod(q, 2)
        g0, g1 = tooc.process_row_range(SHAPE[0], n // 2, r)
        assert (f"[cytv-torch p{q}] multi-process out-of-core: rows "
                f"[{g0}, {g1}) of {SHAPE[0]}, columns [{2 * c}, {2 * c + 2}) "
                f"of {SHAPE[1]}, {n} processes ({n // 2} process-rows of "
                f"2)") in log
        assert f"[cytv-torch p{q}] wrote {out} (every rank its block)" in log
    got = tread(out)
    np.testing.assert_array_equal(got, _incore_recon(cube))
    np.testing.assert_array_equal(got, _one_process(tmp_path, inp, *OOC))
    jout = str(tmp_path / "j.emd")
    assert jcli.main(["-i", inp, "-o", jout, "-v", "0", *OOC, "--shard",
                      "2"]) == 0
    np.testing.assert_allclose(got, jread(jout), **TOL[np.float32])
