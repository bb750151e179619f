"""The port's command line ``cytv-torch`` (``cytvdn_tpu_torch.cli``, run
with ``--device cpu``) against the JAX package's ``cytv``
(``cytvdn_tpu.cli``) on the same input files made from a seed, and the
port's own paths: checkpoints, DM input, profiles, presets, exit codes and
the flags it refuses. Output recons are compared at the tolerances of
tests/test_torch_solver.py: rtol 2e-5 / atol 2e-6 in float32, 1e-12 in
float64.
"""

import json
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import cytvdn_tpu as jtv  # noqa: E402
from cytvdn_tpu import cli as jcli  # noqa: E402
from cytvdn_tpu import presets as jpresets  # noqa: E402
from cytvdn_tpu.io.emd import read_emd as jread  # noqa: E402
from cytvdn_tpu.utils import checkpoint as jck  # noqa: E402
from cytvdn_tpu_torch import cli as tcli  # noqa: E402
from cytvdn_tpu_torch import presets as tpresets  # noqa: E402
from cytvdn_tpu_torch.io.dm import write_dm  # noqa: E402
from cytvdn_tpu_torch.io.emd import read_emd as tread  # noqa: E402

TOL = {np.float32: dict(rtol=2e-5, atol=2e-6),
       np.float64: dict(rtol=1e-12, atol=1e-12)}
S3, S4 = (6, 8, 16), (6, 4, 4, 8)


def _cube(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 0.3 + 1.0).astype(dtype)


def _npy(tmp_path, data, name="in.npy"):
    path = str(tmp_path / name)
    np.save(path, data)
    return path


def _port(inp, out, *flags):
    return tcli.main(["-i", inp, "-o", out, "-v", "0", "--device", "cpu",
                      *flags])


def _jax(inp, out, *flags):
    return jcli.main(["-i", inp, "-o", out, "-v", "0", *flags])


CASES = {
    "3d-fista": (S3, ["-m", "1.0", "-n", "5", "-f", "1"]),
    "3d-unaccelerated": (S3, ["-m", "1.0", "-n", "7"]),
    "3d-hybrid": (S3, ["-m", "1.0", "-n", "4", "3"]),
    "3d-per-axis-mu-lambda": (S3, ["-m", "1.0", "0.5", "2.0", "-L", "0.02",
                                   "-n", "5", "-f", "1", "-d", "3"]),
    "3d-bc-periodic": (S3, ["-m", "1.0", "-n", "5", "-f", "1",
                            "--bc-mode", "0"]),
    "3d-bc-mirror": (S3, ["-m", "1.0", "-n", "5", "-f", "1",
                          "--bc-mode", "1"]),
    "3d-preset-eels3d-fista": (S3, ["-m", "1.0", "--preset", "eels3d-fista",
                                    "-n", "6"]),
    "4d-stem4d": (S4, ["-m", "1.0", "--preset", "stem4d"]),
    "4d-stem4d-hybrid": (S4, ["-m", "1.0", "--preset", "stem4d-hybrid"]),
    "4d-iso": (S4, ["-m", "1.0", "-n", "5", "-f", "1", "--iso-r", "1",
                    "--iso-q", "1"]),
    "4d-preset-stem4d-iso": (S4, ["-m", "1.0", "--preset", "stem4d-iso"]),
    "4d-bc-periodic-unaccelerated": (S4, ["-m", "1.0", "-n", "5",
                                          "--bc-mode", "0"]),
    "4d-backend-torch": (S4, ["-m", "1.0", "-n", "4", "-f", "1",
                              "--backend", "torch"]),
}


@pytest.mark.filterwarnings("ignore:BC_mode=1")
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_port_cli_matches_jax_cli(tmp_path, case, dtype):
    shape, flags = CASES[case]
    if "--backend" in flags:
        # the JAX CLI names its plain backend "jax"
        jflags = [("jax" if f == "torch" else f) for f in flags]
    else:
        jflags = flags
    dflags = ["--dtype", "float64"] if dtype == np.float64 else []
    inp = _npy(tmp_path, _cube(shape, 3))
    tout, jout = str(tmp_path / "t.emd"), str(tmp_path / "j.emd")
    assert _jax(inp, jout, *jflags, *dflags) == 0
    assert _port(inp, tout, *flags, *dflags) == 0
    got, want = tread(tout), jread(jout)
    assert got.dtype == want.dtype == dtype and got.shape == shape
    np.testing.assert_allclose(got, want, **TOL[dtype])
    assert not np.array_equal(got, _cube(shape, 3).astype(dtype))


def _stop_threshold(delta, k):
    """A threshold no delta before index ``k`` crosses and some later one
    does, with a margin of 1e-3 from every delta up to the stop."""
    thr = float(delta[:k].min()) * (1 - 1e-3)
    below = np.nonzero(delta[k:] < thr)[0]
    assert below.size, delta
    stop_at = k + int(below[0]) + 1
    assert np.all(np.abs(delta[:stop_at] / thr - 1) > 1e-3)
    return thr, stop_at


@pytest.mark.parametrize("shape,fista", [(S3, True), (S3, False),
                                         (S4, True)],
                         ids=["3d-fista", "3d-unaccelerated", "4d-fista"])
def test_stop_runs_same_iterations(tmp_path, capsys, shape, fista):
    """``--stop``: the port's command stops after the iterations the JAX
    solver runs, and its recon matches the JAX command's."""
    data = _cube(shape, 4)
    mu = np.full(len(shape), 1.0, np.float32)
    fn = jtv.denoise3D if len(shape) == 3 else jtv.denoise4D
    kw = dict(iterations=40, FISTA=fista, quiet=True)
    _, _, full = fn(data, mu, **kw)[:3]
    thr, stop_at = _stop_threshold(full, 6)
    want_n = np.count_nonzero(fn(data, mu, stopping_relative_change=thr,
                                 **kw)[2])
    assert want_n == stop_at < 40
    inp = _npy(tmp_path, data)
    flags = ["-m", "1.0", "-n", "40", "-f", str(int(fista)),
             "--stop", repr(thr)]
    assert _jax(inp, str(tmp_path / "j.emd"), *flags) == 0
    capsys.readouterr()
    assert tcli.main(["-i", inp, "-o", str(tmp_path / "t.emd"),
                      "--device", "cpu", *flags]) == 0
    log = capsys.readouterr().out
    got_n = int(re.search(r"; (\d+) iterations; final delta", log).group(1))
    assert got_n == want_n
    np.testing.assert_allclose(tread(str(tmp_path / "t.emd")),
                               jread(str(tmp_path / "j.emd")),
                               **TOL[np.float32])


def test_checkpointed_run_bitwise(tmp_path):
    """``--checkpoint F --checkpoint-every 3`` gives the uninterrupted
    run's recon bitwise and leaves the finished state in F."""
    inp = _npy(tmp_path, _cube((6, 7, 8), 5))
    flags = ["-m", "0.8", "-n", "5", "6"]
    ck = str(tmp_path / "state.ckpt.npz")
    assert _port(inp, str(tmp_path / "a.emd"), *flags) == 0
    assert _port(inp, str(tmp_path / "b.emd"), *flags, "--checkpoint", ck,
                 "--checkpoint-every", "3") == 0
    np.testing.assert_array_equal(tread(str(tmp_path / "a.emd")),
                                  tread(str(tmp_path / "b.emd")))
    with np.load(ck) as z:
        assert int(z["i"]) == 11


class _Killed(Exception):
    pass


@pytest.mark.parametrize("dims", [3, 4])
def test_jax_checkpoint_resumes_in_port(tmp_path, monkeypatch, dims):
    """A run of the JAX command killed after its first checkpoint (i = 3,
    mid-FISTA) resumes in the port's command and matches the JAX
    command's uninterrupted run."""
    shape = S3 if dims == 3 else S4
    inp = _npy(tmp_path, _cube(shape, 6))
    flags = ["-m", "0.8", "-n", "5", "6"]
    ck = str(tmp_path / "state.ckpt.npz")
    real_save = jck.save_state

    def save_then_kill(*a, **k):
        real_save(*a, **k)
        raise _Killed

    monkeypatch.setattr(jck, "save_state", save_then_kill)
    with pytest.raises(_Killed):
        _jax(inp, str(tmp_path / "killed.emd"), *flags, "--checkpoint", ck,
             "--checkpoint-every", "3")
    monkeypatch.setattr(jck, "save_state", real_save)
    with np.load(ck) as z:
        assert int(z["i"]) == 3
    assert not os.path.exists(str(tmp_path / "killed.emd"))
    assert _port(inp, str(tmp_path / "t.emd"), *flags, "--checkpoint", ck,
                 "--checkpoint-every", "3", "--resume", "1") == 0
    assert _jax(inp, str(tmp_path / "j.emd"), *flags) == 0
    np.testing.assert_allclose(tread(str(tmp_path / "t.emd")),
                               jread(str(tmp_path / "j.emd")),
                               **TOL[np.float32])
    with np.load(ck) as z:
        assert int(z["i"]) == 11


@pytest.mark.parametrize("shape", [S3, S4])
def test_dm4_input_bitwise_npy(tmp_path, shape):
    data = _cube(shape, 7)
    npy = _npy(tmp_path, data)
    dm4 = str(tmp_path / "in.dm4")
    write_dm(dm4, data)
    flags = ["-m", "1.0", "-n", "5", "-f", "1"]
    assert _port(npy, str(tmp_path / "a.emd"), *flags) == 0
    assert _port(dm4, str(tmp_path / "b.emd"), *flags) == 0
    np.testing.assert_array_equal(tread(str(tmp_path / "a.emd")),
                                  tread(str(tmp_path / "b.emd")))


def test_emd_input_and_output_extension(tmp_path):
    """An EMD file the command wrote is a valid input; the output's
    extension is forced to .emd, as the JAX command does."""
    inp = _npy(tmp_path, _cube(S4, 8))
    assert _port(inp, str(tmp_path / "first.h5"), "-m", "1.0", "-n", "2",
                 "-f", "1") == 0
    first = str(tmp_path / "first.emd")
    assert os.path.exists(first)
    assert _port(first, str(tmp_path / "second"), "-m", "1.0", "-n",
                 "3", "-f", "1") == 0
    from cytvdn_tpu_torch import denoise4D

    want = denoise4D(tread(first), np.full(4, 1.0, np.float32),
                     iterations=3, quiet=True, device="cpu")[0]
    np.testing.assert_array_equal(tread(str(tmp_path / "second.emd")), want)


def test_profile_writes_trace(tmp_path):
    inp = _npy(tmp_path, _cube(S3, 9))
    logdir = str(tmp_path / "prof")
    assert _port(inp, str(tmp_path / "o.emd"), "-m", "1.0", "-n", "3",
                 "--profile", logdir) == 0
    with open(os.path.join(logdir, "trace.json")) as f:
        trace = json.load(f)
    assert trace["traceEvents"]


def test_seconds_and_log(tmp_path, capsys):
    """``main(seconds=...)`` receives the load, solve and write times; the
    verbose log names each step, the iterations and the launches."""
    inp = _npy(tmp_path, _cube(S3, 10))
    seconds = {}
    assert tcli.main(["-i", inp, "-o", str(tmp_path / "o.emd"), "-m", "1.0",
                      "-n", "4", "-f", "1", "--device", "cpu"],
                     seconds=seconds) == 0
    assert sorted(seconds) == ["load", "solve", "write"]
    assert all(v >= 0 for v in seconds.values())
    out = capsys.readouterr().out
    for line in ("loaded ", "; 4 iterations; final delta",
                 "kernel launches: whole-run 0, K-step 0, pair 0, K=1 0",
                 "wrote "):
        assert line in out
    assert tcli.main(["-i", inp, "-o", str(tmp_path / "q.emd"), "-m", "1.0",
                      "-n", "4", "-v", "0", "--device", "cpu"]) == 0
    assert capsys.readouterr().out == ""


def test_load_and_solve_matches_api(tmp_path):
    """The load-and-solve step is ``denoise4D`` with the command's
    arguments, bitwise, and writes nothing."""
    data = _cube(S4, 11)
    inp = _npy(tmp_path, data)
    out = str(tmp_path / "o.emd")
    run = tcli.load_and_solve(["-i", inp, "-o", out, "-m", "1.0", "-v", "0",
                               "--preset", "stem4d", "--device", "cpu"])
    from cytvdn_tpu_torch import denoise4D

    want = denoise4D(data, np.full(4, 1.0, np.float32), iterations=10,
                     FISTA=True, BC_mode=2, quiet=True, device="cpu")
    for got, w in zip((run.recon, run.b_norm, run.delta), want):
        np.testing.assert_array_equal(got, w)
    assert sorted(run.seconds) == ["load", "solve"]
    assert not os.path.exists(out)


# -- presets -----------------------------------------------------------------

def test_presets_equal():
    assert tpresets.PRESETS == jpresets.PRESETS
    assert sorted(tpresets.PRESETS) == sorted(jpresets.PRESETS)
    for name in jpresets.PRESETS:
        assert tpresets.get_preset(name) == jpresets.get_preset(name)
    for mod in (tpresets, jpresets):
        with pytest.raises(KeyError) as e:
            mod.get_preset("nope")
    assert "available" in e.value.args[0]


def test_denoise_preset_matches_jax():
    data = _cube(S4, 12)
    mu = np.full(4, 1.0, np.float32)
    got = tpresets.denoise_preset(data, mu, "stem4d-hybrid", quiet=True,
                                  device="cpu")
    want = jpresets.denoise_preset(data, mu, "stem4d-hybrid", quiet=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL[np.float32])


OVERRIDES = {
    "none": [],
    "iterations": ["-n", "7"],
    "hybrid": ["-n", "3", "4"],
    "fista-off": ["-f", "0"],
    "bc-stop-iso": ["--bc-mode", "1", "--stop", "0.1", "--iso-r", "0",
                    "--iso-q", "1"],
}


@pytest.mark.parametrize("override", sorted(OVERRIDES))
@pytest.mark.parametrize("preset", sorted(jpresets.PRESETS) + [None])
def test_apply_preset_matches_jax(preset, override):
    argv = ["-i", "x", "-o", "y", "-m", "1.0"] + OVERRIDES[override]
    if preset:
        argv += ["--preset", preset]
    a, b = tcli.build_parser().parse_args(argv), \
        jcli.build_parser().parse_args(argv)
    assert tcli._apply_preset(a) == jcli._apply_preset(b)
    keys = ("niterations", "fista", "bc_mode", "stop", "iso_r", "iso_q")
    assert [getattr(a, k) for k in keys] == [getattr(b, k) for k in keys]


def test_flags_match_jax():
    """The 23 flags of ``cytv`` with their names, types and defaults, plus
    ``--device``."""
    def flags(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.nargs,
                         a.required)
                for a in parser._actions if a.dest != "help"}

    got, want = flags(tcli.build_parser()), flags(jcli.build_parser())
    assert len(want) == 23
    assert got.pop("device") == (("--device",), "cuda", None, False)
    assert got == want


# -- exit codes --------------------------------------------------------------

EXIT2 = {
    "dims-mismatch": ["-m", "1.0", "-n", "2", "-d", "4"],
    "missing-n": ["-m", "1.0"],
    "unknown-preset": ["-m", "1.0", "--preset", "nope"],
    "temporal-alone": ["-m", "1.0", "-n", "2", "--temporal", "2"],
    "lossy-unaccelerated": ["-m", "1.0", "-n", "2", "--lossy-duals"],
    "lossy-bc": ["-m", "1.0", "-n", "2", "-f", "1", "--lossy-duals",
                 "--bc-mode", "0"],
    "lossy-iso": ["-m", "1.0", "-n", "2", "-f", "1", "--lossy-duals",
                  "--iso-q", "1"],
    "lossy-float64": ["-m", "1.0", "-n", "2", "-f", "1", "--lossy-duals",
                      "--dtype", "float64"],
    # cytv's out-of-core flag-combination check
    "ooc-bc": ["-m", "1.0", "-n", "2", "--out-of-core", "2", "--bc-mode", "0"],
    "ooc-iso": ["-m", "1.0", "-n", "2", "--out-of-core", "2", "--iso-r", "1"],
    "ooc-backend": ["-m", "1.0", "-n", "2", "--out-of-core", "2", "--backend",
                    "cpp"],
    "ooc-float64": ["-m", "1.0", "-n", "2", "--out-of-core", "2", "--dtype",
                    "float64"],
    "ooc-temporal-bc": ["-m", "1.0", "-n", "2", "--out-of-core", "2",
                        "--temporal", "2", "--bc-mode", "1"],
}


@pytest.mark.parametrize("case", sorted(EXIT2))
def test_exit_2_as_jax(tmp_path, capsys, case):
    inp = _npy(tmp_path, _cube(S3, 13))
    assert _jax(inp, str(tmp_path / "j.emd"), *EXIT2[case]) == 2
    capsys.readouterr()
    out = str(tmp_path / "t.emd")
    assert _port(inp, out, *EXIT2[case]) == 2
    assert capsys.readouterr().err.startswith("error: ")
    assert not os.path.exists(out)


REFUSED = {
    # ported (Queue 1 item 11(b)): slabs split over 2 cards need 2
    # processes (tests/test_torch_cli_shard.py runs them)
    "out-of-core": (["--out-of-core", "2", "--shard", "2"],
                    "splits every slab over 2 processes, one card each, but "
                    "this launch has 1 (WORLD_SIZE), not a multiple of 2"),
    # ported (Queue 1 item 12(b)): lossy duals in temporal mode, whose
    # slabs' pairs round the bfloat16 duals in the middle of the pair
    "out-of-core-temporal": (["--out-of-core", "2", "--temporal", "2", "-f",
                              "1", "--lossy-duals"], None),
    # ported (Queue 1 item 10): a tiling of 2 blocks needs 2 processes
    # (tests/test_torch_cli_shard.py runs them)
    "shard": (["--shard", "2,1,1,1"], "tiles the cube into 2 blocks, one per "
                                      "process, but this launch has 1"),
    # ported (Queue 1 item 10): in one process, the one-device run
    "shard-auto": (["--shard", "auto"], None),
    # ported (Queue 1 item 12(a)): runs as cytv --lossy-duals does
    "lossy-duals": (["-f", "1", "--lossy-duals"], None),
    "backend-cpp": (["--backend", "cpp"], "Queue 1 item 13"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_flags_name_roadmap_item(tmp_path, capsys, case):
    """Each refused flag exits 2 before the input is read, naming its
    ROADMAP item (or, for a tiling the launch cannot run, why); a flag
    since ported (item None) runs, and its recon is the JAX ``cytv``'s with
    the same flags (within atol 5e-7 for lossy duals, as
    tests/test_lossy.py holds the JAX lossy runs)."""
    flags, item = REFUSED[case]
    out = str(tmp_path / "t.emd")
    if item is None:
        inp = _npy(tmp_path, _cube(S4, 17))
        jout = str(tmp_path / "j.emd")
        assert _jax(inp, jout, "-m", "1.0", "-n", "6", *flags) == 0
        assert _port(inp, out, "-m", "1.0", "-n", "6", *flags) == 0
        np.testing.assert_allclose(tread(out), jread(jout), rtol=0,
                                   atol=5e-7)
        return
    # the input does not exist: the refusal comes before any load
    rc = _port(str(tmp_path / "missing.npy"), out, "-m", "1.0", "-n", "2",
               *flags)
    assert rc == 2
    err = capsys.readouterr().err
    if item.startswith("Queue"):
        assert "not ported to cytvdn_tpu_torch yet" in err
        assert f"(ROADMAP.md {item})" in err
    else:
        assert item in err and "torchrun --nproc-per-node 2" in err
    assert not os.path.exists(out)


OOC = {
    "stream-fista": (S4, ["-n", "5", "-f", "1", "--out-of-core", "2"]),
    "stream-3d-hybrid": (S3, ["-n", "4", "3", "--out-of-core", "3"]),
    "temporal-fista": (S4, ["-n", "5", "-f", "1", "--out-of-core", "2",
                            "--temporal", "2"]),
    "temporal-3d-stop": (S3, ["-n", "40", "--out-of-core", "2", "--temporal",
                              "3", "--stop", "0.05"]),
}


@pytest.mark.parametrize("case", sorted(OOC))
def test_out_of_core_matches_jax_cli(tmp_path, case):
    """``cytv-torch --device cpu --out-of-core N [--temporal K]`` against
    the JAX ``cytv --out-of-core`` on the same file, and bitwise the port's
    ``denoise_outofcore`` with the same arguments."""
    from cytvdn_tpu_torch.solver.outofcore import denoise_outofcore

    shape, flags = OOC[case]
    data = _cube(shape, 16)
    inp = _npy(tmp_path, data)
    tout, jout = str(tmp_path / "t.emd"), str(tmp_path / "j.emd")
    assert _jax(inp, jout, "-m", "1.0", *flags) == 0
    assert _port(inp, tout, "-m", "1.0", *flags) == 0
    np.testing.assert_allclose(tread(tout), jread(jout), **TOL[np.float32])
    run = tcli.load_and_solve(["-i", inp, "-o", tout, "-m", "1.0", "-v", "0",
                               "--device", "cpu", *flags])
    args = run.args
    want = denoise_outofcore(
        data, np.full(len(shape), 1.0, np.float32),
        iterations=(args.niterations[0] if len(args.niterations) == 1
                    else tuple(args.niterations)),
        FISTA=bool(args.fista), stopping_relative_change=args.stop,
        n_slabs=args.out_of_core, temporal_k=args.temporal, device="cpu")
    for got, w in zip((run.recon, run.b_norm, run.delta), want):
        np.testing.assert_array_equal(got, w)


@pytest.mark.parametrize("temporal", ["1", "2"])
def test_out_of_core_checkpoint_and_resume(tmp_path, monkeypatch, temporal):
    """``--out-of-core`` with ``--checkpoint``: the run is bitwise the run
    without one and leaves the finished state in the file; a JAX
    ``cytv --out-of-core`` run killed after its first save resumes in the
    port's command (``--resume 1``) and matches the JAX command's
    uninterrupted run."""
    from cytvdn_tpu.solver import outofcore as jooc

    inp = _npy(tmp_path, _cube(S3, 17))
    flags = ["-m", "0.8", "-n", "4", "3", "--out-of-core", "2",
             "--temporal", temporal]
    ck = str(tmp_path / "ooc.ckpt.npz")
    assert _port(inp, str(tmp_path / "a.emd"), *flags) == 0
    assert _port(inp, str(tmp_path / "b.emd"), *flags, "--checkpoint", ck,
                 "--checkpoint-every", "2") == 0
    np.testing.assert_array_equal(tread(str(tmp_path / "a.emd")),
                                  tread(str(tmp_path / "b.emd")))
    with np.load(ck) as z:
        assert int(z["i"]) == 7
    os.remove(ck)
    real = jooc._ckpt_save

    def save_then_kill(*a, **k):
        real(*a, **k)
        raise _Killed

    monkeypatch.setattr(jooc, "_ckpt_save", save_then_kill)
    with pytest.raises(_Killed):
        _jax(inp, str(tmp_path / "killed.emd"), *flags, "--checkpoint", ck,
             "--checkpoint-every", "2")
    monkeypatch.setattr(jooc, "_ckpt_save", real)
    with np.load(ck) as z:
        assert int(z["i"]) == 2
    assert _port(inp, str(tmp_path / "t.emd"), *flags, "--checkpoint", ck,
                 "--checkpoint-every", "2", "--resume", "1") == 0
    assert _jax(inp, str(tmp_path / "j.emd"), *flags) == 0
    np.testing.assert_allclose(tread(str(tmp_path / "t.emd")),
                               jread(str(tmp_path / "j.emd")),
                               **TOL[np.float32])


def test_multi_process_launch_refused(tmp_path, capsys, monkeypatch):
    """A launch of several processes (``WORLD_SIZE`` > 1) runs a mesh
    (tests/test_torch_cli_shard.py starts its processes); one without
    torchrun's ``RANK`` cannot join its group and exits 2. With
    ``--out-of-core`` it runs (Queue 1 item 11(a)): two processes with
    torchrun's environment write the one-process command's recon, bitwise;
    with ``--shard 2`` (slabs split over two cards, item 11(b)) it runs
    too, and the same launch without ``RANK`` exits 2 before the input is
    read."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("RANK", raising=False)
    out = str(tmp_path / "t.emd")
    inp = _npy(tmp_path, _cube(S3, 14))
    assert _port(inp, out, "-m", "1.0", "-n", "2") == 2
    err = capsys.readouterr().err
    assert "WORLD_SIZE=2 without RANK" in err and "torchrun" in err
    assert not os.path.exists(out)
    assert _port(str(tmp_path / "missing.npy"), out, "-m", "1.0", "-n", "2",
                 "--out-of-core", "2", "--shard", "2") == 2
    assert "WORLD_SIZE=2 without RANK" in capsys.readouterr().err
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert _port(inp, out, "-m", "1.0", "-n", "2") == 0
    from test_torch_cli_shard import _launch, _ok

    mesh = str(tmp_path / "ooc-mesh.emd")
    _ok(_launch(["-i", inp, "-o", mesh, "-v", "0", "--device", "cpu", "-m",
                 "1.0", "-n", "2", "--out-of-core", "2"]))
    one = str(tmp_path / "ooc-one.emd")
    assert _port(inp, one, "-m", "1.0", "-n", "2", "--out-of-core", "2") == 0
    np.testing.assert_array_equal(tread(mesh), tread(one))
    split = str(tmp_path / "ooc-split.emd")
    _ok(_launch(["-i", inp, "-o", split, "-v", "0", "--device", "cpu", "-m",
                 "1.0", "-n", "2", "--out-of-core", "2", "--shard", "2"]))
    np.testing.assert_array_equal(tread(split), tread(one))


@pytest.mark.parametrize("backend", ["jax", "pallas"])
def test_jax_backends_refused(tmp_path, capsys, backend):
    with pytest.raises(SystemExit) as e:
        _port(str(tmp_path / "missing.npy"), str(tmp_path / "t.emd"),
              "-m", "1.0", "-n", "2", "--backend", backend)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "'torch'" in err and "'cuda'" in err


def test_default_device_never_falls_back_to_cpu(tmp_path, capsys):
    """Without ``--device`` the run is on the card; where there is none,
    the command exits non-zero and writes nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default run would use it")
    inp = _npy(tmp_path, _cube(S3, 15))
    out = str(tmp_path / "t.emd")
    assert tcli.main(["-i", inp, "-o", out, "-m", "1.0", "-n", "2"]) != 0
    assert "torch.cuda.is_available() is false" in capsys.readouterr().err
    assert not os.path.exists(out)
    with pytest.raises(tcli.CliError):
        tcli.load_and_solve(["-i", inp, "-o", out, "-m", "1.0", "-n", "2"])


def test_bad_device_refused(tmp_path, capsys):
    out = str(tmp_path / "t.emd")
    assert _port(str(tmp_path / "missing.npy"), out, "-m", "1.0", "-n", "2",
                 "--device", "nonsense") == 2
    assert "--device" in capsys.readouterr().err
