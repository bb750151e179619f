"""The port's C++ CPU backend (``cytvdn_tpu_torch.cpp``, ``backend="cpp"``)
against the golden model, the port's plain PyTorch backend and the JAX
package's ``backend="cpp"``, on the case list of tests/test_cpp.py.

Both packages build the one source ``csrc/tvdn_cpu.cpp`` with the same
flags, so against the JAX ``cpp`` backend the recon is bitwise and the
traces (OpenMP reductions, whose order is not fixed) within rtol 1e-6.
Against the golden model and ``backend="torch"`` the tolerances are
tests/test_cpp.py's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import golden  # noqa: E402
import cytvdn_tpu as jtv  # noqa: E402
from cytvdn_tpu import cli as jcli  # noqa: E402
from cytvdn_tpu.cpp import backend as jcpp  # noqa: E402
from cytvdn_tpu.io.emd import read_emd as jread  # noqa: E402
import cytvdn_tpu_torch as ttv  # noqa: E402
from cytvdn_tpu_torch import cli as tcli  # noqa: E402
from cytvdn_tpu_torch import ops  # noqa: E402
from cytvdn_tpu_torch.config import Backend, SolverOptions  # noqa: E402
from cytvdn_tpu_torch.cpp import backend as cpp  # noqa: E402
from cytvdn_tpu_torch.cpp import build as cbuild  # noqa: E402
from cytvdn_tpu_torch.io.emd import read_emd as tread  # noqa: E402

pytestmark = pytest.mark.skipif(
    not (cpp.native_available() and jcpp.native_available()),
    reason="no C++ toolchain available")

TRACE_RTOL = 1e-6


def _rng(seed):
    return np.random.default_rng(seed)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_native_threads_reported():
    """Threads reported, as the JAX backend reports them; the library is
    the port's own build, under ``cytvdn_tpu_torch/_build/``."""
    assert cpp.native_num_threads() >= 1
    assert cpp.native_num_threads() == jcpp.native_num_threads()
    assert cbuild.build().startswith(cbuild.BUILD_DIR)


@pytest.mark.parametrize("bc", [0, 1, 2])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_acc_update_matches_golden(bc, dtype):
    """Each axis's accumulator update against the golden model, the port's
    plain op and the JAX backend's update (bitwise: the same kernel)."""
    rng = _rng(5)
    a = rng.standard_normal((5, 6, 7, 8)).astype(dtype)
    tol = 1e-6 if dtype == np.float32 else 1e-14
    for ax in range(4):
        b = (rng.standard_normal(a.shape) * 0.1).astype(dtype)
        want_b, want_n = golden.accumulator_update(a, b, ax, dtype(0.3), bc)
        got_b = b.copy()
        got_n = cpp.acc_update(a, got_b, ax, 0.3, bc)
        np.testing.assert_allclose(got_b, want_b, atol=tol)
        np.testing.assert_allclose(got_n, want_n, rtol=1e-5)
        plain_b, plain_n = ops.accumulator_update(_t(a), _t(b), ax,
                                                  dtype(0.3), bc)
        np.testing.assert_allclose(got_b, plain_b.numpy(), atol=tol)
        np.testing.assert_allclose(got_n, float(plain_n), rtol=1e-5)
        jax_b = b.copy()
        jax_n = jcpp.acc_update(a, jax_b, ax, 0.3, bc)
        np.testing.assert_array_equal(got_b, jax_b)
        np.testing.assert_allclose(got_n, jax_n, rtol=TRACE_RTOL)


def test_acc_update_fista_matches_golden():
    rng = _rng(6)
    a = rng.standard_normal((6, 7, 8))
    for ax in range(3):
        b = rng.standard_normal(a.shape) * 0.1
        d = rng.standard_normal(a.shape) * 0.1
        want_b, want_d, want_n = golden.accumulator_update_fista(
            a, b, d, 0.7, ax, 0.3, 2)
        got_b, got_d = b.copy(), d.copy()
        got_n = cpp.acc_update(a, got_b, ax, 0.3, 2, d=got_d, tk=0.7)
        np.testing.assert_allclose(got_b, want_b, atol=1e-14)
        np.testing.assert_allclose(got_d, want_d, atol=1e-14)
        np.testing.assert_allclose(got_n, want_n, rtol=1e-12)
        pb, pd, pn = ops.accumulator_update_fista(_t(a), _t(b), _t(d), 0.7,
                                                  ax, 0.3, 2)
        np.testing.assert_allclose(got_b, pb.numpy(), atol=1e-14)
        np.testing.assert_allclose(got_d, pd.numpy(), atol=1e-14)
        np.testing.assert_allclose(got_n, float(pn), rtol=1e-12)
        jb, jd = b.copy(), d.copy()
        jn = jcpp.acc_update(a, jb, ax, 0.3, 2, d=jd, tk=0.7)
        np.testing.assert_array_equal(got_b, jb)
        np.testing.assert_array_equal(got_d, jd)
        np.testing.assert_allclose(got_n, jn, rtol=TRACE_RTOL)


def test_iso_update_matches_golden():
    rng = _rng(7)
    a = rng.standard_normal((4, 5, 6, 7))
    b1 = rng.standard_normal(a.shape) * 0.1
    b2 = rng.standard_normal(a.shape) * 0.1
    for ax1, ax2 in [(0, 1), (2, 3)]:
        want1, want2, wn = golden.iso_accumulator_update(a, b1, b2, ax1, ax2,
                                                         0.2)
        g1, g2 = b1.copy(), b2.copy()
        gn = cpp.iso_update(a, g1, g2, ax1, ax2, 0.2)
        np.testing.assert_allclose(g1, want1, atol=1e-14)
        np.testing.assert_allclose(g2, want2, atol=1e-14)
        np.testing.assert_allclose(gn, wn, rtol=1e-12)
        p1, p2, pn = ops.iso_accumulator_update(_t(a), _t(b1), _t(b2), ax1,
                                                ax2, 0.2)
        np.testing.assert_allclose(g1, p1.numpy(), atol=1e-14)
        np.testing.assert_allclose(g2, p2.numpy(), atol=1e-14)
        np.testing.assert_allclose(gn, float(pn), rtol=1e-12)
        j1, j2 = b1.copy(), b2.copy()
        jn = jcpp.iso_update(a, j1, j2, ax1, ax2, 0.2)
        np.testing.assert_array_equal(g1, j1)
        np.testing.assert_array_equal(g2, j2)
        np.testing.assert_allclose(gn, jn, rtol=TRACE_RTOL)


@pytest.mark.parametrize("bc", [0, 1, 2])
def test_recon_update_matches_golden(bc):
    rng = _rng(8 + bc)
    for shape in [(5, 6, 7), (4, 5, 6, 7)]:
        nd = len(shape)
        orig = rng.standard_normal(shape)
        recon = rng.standard_normal(shape)
        bs = [rng.standard_normal(shape) * 0.2 for _ in range(nd)]
        lam_mu = np.full(nd, 1.0 / 32)
        want, want_delta = golden.datacube_update(orig, recon, bs, lam_mu, bc)
        got = recon.copy()
        got_delta = cpp.recon_update(orig, got, bs, lam_mu, bc)
        np.testing.assert_allclose(got, want, atol=1e-14)
        np.testing.assert_allclose(got_delta, want_delta, rtol=1e-12)
        pr, pdn, prn = ops.datacube_update(_t(orig), _t(recon),
                                           [_t(b) for b in bs],
                                           _t(lam_mu), bc)
        np.testing.assert_allclose(got, pr.numpy(), atol=1e-14)
        np.testing.assert_allclose(got_delta, float(pdn / prn), rtol=1e-12)
        jr = recon.copy()
        jd = jcpp.recon_update(orig, jr, bs, lam_mu, bc)
        np.testing.assert_array_equal(got, jr)
        np.testing.assert_allclose(got_delta, jd, rtol=TRACE_RTOL)


def _three(fn, cube, mu, **kw):
    """``fn`` (denoise3D or denoise4D) of both packages: the port's cpp
    and torch (on the CPU) runs and the JAX package's cpp run."""
    got = getattr(ttv, fn)(cube, mu, backend="cpp", **kw)
    plain = getattr(ttv, fn)(cube, mu, backend="torch", device="cpu", **kw)
    want = getattr(jtv, fn)(cube, mu, backend="cpp", **kw)
    return got, plain, want


def _check(got, plain, want, rtol=1e-10, atol=1e-12):
    assert len(got) == len(plain) == len(want)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=TRACE_RTOL)
    for g, p in zip(got, plain):
        np.testing.assert_allclose(g, p, rtol=rtol, atol=atol)


def test_solver_cpp_3d_matches_jax():
    cube = _rng(9).standard_normal((6, 7, 8)) * 0.5 + 2.0
    _check(*_three("denoise3D", cube, np.full(3, 0.8), iterations=10,
                   FISTA=True, quiet=True))


def test_solver_cpp_4d_iso_hybrid_matches_jax():
    cube = _rng(10).standard_normal((4, 5, 6, 7)) * 0.5 + 2.0
    _check(*_three("denoise4D", cube, np.full(4, 1.0), iterations=(4, 3),
                   isotropic_R=True, isotropic_Q=True, quiet=True))


def test_solver_cpp_early_stop_and_mse():
    rng = _rng(11)
    cube = rng.standard_normal((6, 7, 8)) * 0.5 + 2.0
    ref = rng.standard_normal((6, 7, 8)) * 0.5 + 2.0
    got, plain, want = _three(
        "denoise3D", cube, np.full(3, 0.8), iterations=200,
        stopping_relative_change=0.05, reference_data=ref, quiet=True)
    assert len(got) == 4
    assert 0 < np.count_nonzero(got[2]) < 200
    _check(got, plain, want, rtol=1e-9)


def test_cpp_noncontiguous_reference_data():
    """A Fortran-order reference cube gives the MSE of the contiguous one
    (it is made contiguous before the native call)."""
    rng = _rng(12)
    cube = rng.standard_normal((6, 7, 8)) * 0.5 + 2.0
    ref = np.asfortranarray(rng.standard_normal((6, 7, 8)) * 0.5 + 2.0)
    got, plain, want = _three("denoise3D", cube, np.full(3, 0.8),
                              iterations=4, reference_data=ref, quiet=True)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-10)
    np.testing.assert_allclose(got[3], plain[3], rtol=1e-10)


def test_cpp_float32_4d_fista_matches_jax():
    """The float32 main path's shape of run (4D FISTA, Jia-Zhao): bitwise
    the JAX cpp recon, the port's torch run within float32's
    tolerance."""
    cube = (_rng(13).standard_normal((6, 4, 5, 8)) * 0.3 + 1.0).astype(
        np.float32)
    mu = np.full(4, 1.0, np.float32)
    got, plain, want = _three("denoise4D", cube, mu, iterations=8,
                              quiet=True)
    assert got[0].dtype == np.float32
    _check(got, plain, want, rtol=2e-5, atol=2e-6)


def test_solve_cpp_returns_the_engine_dict():
    """``solve_cpp`` takes CPU tensors too and returns the keys and types
    of the engine's ``run_solver``."""
    cube = (_rng(14).standard_normal((5, 6, 7)) + 2).astype(np.float32)
    opts = SolverOptions(ndim=3, iterations_fista=3, iterations_unacc=2,
                         backend="cpp", calculate_mse=True)
    assert opts.backend is Backend.CPP
    li, lm = np.full(3, 16.0, np.float32), np.full(3, 1 / 16, np.float32)
    out = cpp.solve_cpp(_t(cube), _t(li), lm, opts, _t(cube * 0.9))
    assert sorted(out) == ["b_norm", "delta", "early_stopped",
                           "iterations_run", "mse", "recon"]
    assert out["iterations_run"] == 5 and out["early_stopped"] is False
    assert all(torch.is_tensor(out[k]) for k in ("recon", "b_norm", "delta",
                                                 "mse"))
    assert out["mse"].shape == (6,)


def test_cpp_refused_by_the_engine_and_checkpoints(tmp_path):
    """The engine and the chunked runs take no ``backend="cpp"``: it runs
    only through ``denoise3D/4D`` on the host."""
    from cytvdn_tpu_torch.solver.engine import run_solver
    from cytvdn_tpu_torch.utils.checkpoint import run_with_checkpointing

    cube = np.ones((4, 5, 6), np.float32)
    opts = SolverOptions(ndim=3, iterations_fista=2, iterations_unacc=0,
                         backend="cpp")
    with pytest.raises(ValueError, match="solve_cpp"):
        run_solver(_t(cube), torch.ones(3), torch.ones(3), opts)
    with pytest.raises(ValueError, match="backend='cpp'"):
        run_with_checkpointing(cube, 1.0, iterations=2, backend="cpp",
                               checkpoint_path=str(tmp_path / "c.npz"),
                               checkpoint_every=1, device="cpu")


@pytest.mark.parametrize("flags", [["-n", "6", "-f", "1"],
                                   ["-n", "4", "3", "--iso-r", "1"]],
                         ids=["fista", "hybrid-iso"])
def test_cli_backend_cpp_matches_cytv(tmp_path, flags):
    """``cytv-torch --backend cpp`` and ``cytv --backend cpp`` on the same
    ``.npy``: the same recon, bitwise."""
    cube = (_rng(15).standard_normal((6, 4, 4, 8)) * 0.3 + 1.0).astype(
        np.float32)
    inp = str(tmp_path / "in.npy")
    np.save(inp, cube)
    out, jout = str(tmp_path / "t.emd"), str(tmp_path / "j.emd")
    common = ["-i", inp, "-v", "0", "-m", "1.0", "--backend", "cpp", *flags]
    assert jcli.main(["-o", jout, *common]) == 0
    # the port's command never needs a card for it: --device stays cuda
    assert tcli.main(["-o", out, *common]) == 0
    np.testing.assert_array_equal(tread(out), jread(jout))


@pytest.mark.parametrize("flags", [["--shard", "auto"],
                                   ["--checkpoint", "c.npz",
                                    "--checkpoint-every", "2"],
                                   ["--out-of-core", "2"]],
                         ids=["shard", "checkpoint", "out-of-core"])
def test_cli_backend_cpp_refusals(tmp_path, capsys, flags):
    """``--backend cpp`` runs in one process, unchunked, in core: with
    ``--shard``, ``--checkpoint`` or ``--out-of-core`` the command exits 2
    before the input is read."""
    out = str(tmp_path / "t.emd")
    rc = tcli.main(["-i", str(tmp_path / "missing.npy"), "-o", out, "-m",
                    "1.0", "-n", "2", "--backend", "cpp", *flags])
    assert rc == 2
    err = capsys.readouterr().err
    assert err.startswith("error: ") and "--backend" in err
    assert not tmp_path.joinpath("t.emd").exists()


def test_forced_build_failure_raises_and_runs_nothing(monkeypatch):
    """A compiler that does not exist: the build raises with what failed,
    ``native_available`` is False, and ``denoise3D(backend="cpp")`` raises
    the same error rather than fall back to another backend."""
    from cytvdn_tpu_torch import kernels

    monkeypatch.setattr(cpp, "_lib", None)
    monkeypatch.setattr(cbuild, "_built", None)
    monkeypatch.setattr(cbuild, "_failure", None)
    monkeypatch.setattr(cbuild, "compiler", lambda: "no-such-compiler-xyz")
    with pytest.raises(RuntimeError, match="no-such-compiler-xyz"):
        cbuild.build(force=True)
    assert not cpp.native_available()
    assert cpp.native_num_threads() == 0
    steps = (kernels.fused_iteration, kernels.fused_pair_iteration,
             kernels.fused_kstep_iteration, kernels.resident_solve)
    calls = [k.calls for k in steps]
    with pytest.raises(RuntimeError, match="no-such-compiler-xyz"):
        ttv.denoise3D(np.ones((4, 5, 6)), np.full(3, 0.8), iterations=2,
                      quiet=True, backend="cpp")
    assert [k.calls for k in steps] == calls
    # the working build is back once the compiler is
    monkeypatch.undo()
    assert cpp.native_available()
