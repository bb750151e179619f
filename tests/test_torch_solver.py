"""The port's whole slice — ``denoise3D`` / ``denoise4D`` → ``run_solver``
→ fused iteration — against ``cytvdn_tpu`` on the CPU, with the JAX ops
(``backend="jax"``) and the Pallas kernels in interpret mode
(``backend="pallas"``) as references. Tolerances: rtol 2e-5 / atol 2e-6
in float32 (tests/test_pallas.py), 1e-12 in float64.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import cytvdn_tpu as jtv  # noqa: E402
import cytvdn_tpu_torch as ttv  # noqa: E402
from cytvdn_tpu.config import SolverOptions as JOptions  # noqa: E402
from cytvdn_tpu_torch.config import SolverOptions as TOptions  # noqa: E402


def _cube(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 0.5 + 2.0).astype(dtype)


def _compare(got, want, rtol=2e-5, atol=2e-6):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def _both(fn_name, cube, mu, ref_backend, **kw):
    want = getattr(jtv, fn_name)(cube, mu, quiet=True, backend=ref_backend, **kw)
    got = getattr(ttv, fn_name)(cube, mu, quiet=True, device="cpu", **kw)
    return got, want


REFS = ["jax", "pallas"]


@pytest.mark.parametrize("ref", REFS)
def test_denoise3d_fista(ref):
    cube = _cube((6, 8, 16), 1)
    _compare(*_both("denoise3D", cube, np.full(3, 1.0, np.float32), ref,
                    iterations=6, FISTA=True))


@pytest.mark.parametrize("ref", REFS)
def test_denoise3d_unaccelerated(ref):
    cube = _cube((6, 8, 16), 2)
    _compare(*_both("denoise3D", cube, np.full(3, 0.8, np.float32), ref,
                    iterations=12))


@pytest.mark.parametrize("ref", REFS)
def test_denoise4d_hybrid(ref):
    cube = _cube((5, 6, 8, 16), 3)
    _compare(*_both("denoise4D", cube, np.full(4, 1.0, np.float32), ref,
                    iterations=(4, 3)))


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("iterations", [80, (3, 40)])
def test_early_stop_same_iteration_and_zero_padding(ref, iterations):
    """The stop lands on the same iteration, the converging iteration is
    in the trace, and the rest stays zero; in a hybrid run the first phase
    runs its course and the second stops."""
    cube = _cube((6, 8, 16), 4)
    fn = "denoise3D" if isinstance(iterations, int) else "denoise4D"
    if fn == "denoise4D":
        cube = _cube((5, 6, 8, 16), 4)
    mu = np.full(cube.ndim, 1.0, np.float32)
    got, want = _both(fn, cube, mu, ref, iterations=iterations,
                      stopping_relative_change=0.02)
    _compare(got, want)
    n_total = iterations if isinstance(iterations, int) else sum(iterations)
    nz_got, nz_want = np.nonzero(got[2])[0], np.nonzero(want[2])[0]
    np.testing.assert_array_equal(nz_got, nz_want)
    assert nz_got[-1] < n_total - 1 and got[2][nz_got[-1]] < 0.02


def test_fista_restart_matches_jax():
    cube = _cube((8, 8, 32), 5)
    _compare(*_both("denoise3D", cube, np.full(3, 1.0, np.float32), "jax",
                    iterations=30, FISTA=True, fista_restart=True))


@pytest.mark.parametrize("ref", REFS)
def test_mse_trace(ref):
    cube = _cube((5, 6, 8, 16), 6)
    clean = np.full(cube.shape, 2.0, np.float32)
    got, want = _both("denoise4D", cube, np.full(4, 1.0, np.float32), ref,
                      iterations=8, reference_data=clean)
    _compare(got, want)
    assert got[3][-1] < got[3][0]


@pytest.mark.parametrize("bc", [0, 1])
def test_denoise4d_periodic_and_mirror(bc):
    cube = _cube((5, 6, 8, 16), 7)
    mu = np.linspace(1.0, 2.0, 4).astype(np.float32)
    with pytest.warns(UserWarning) if bc == 1 else contextlib.nullcontext():
        got = ttv.denoise4D(cube, mu, iterations=(3, 2), BC_mode=bc,
                            quiet=True, device="cpu")
    with pytest.warns(UserWarning) if bc == 1 else contextlib.nullcontext():
        want = jtv.denoise4D(cube, mu, iterations=(3, 2), BC_mode=bc,
                             quiet=True, backend="pallas")
    _compare(got, want)


def test_denoise4d_half_isotropic():
    cube = _cube((6, 8, 6, 16), 8)
    mu = np.asarray([1.0, 1.0, 2.0, 2.0], np.float32)
    _compare(*_both("denoise4D", cube, mu, "pallas", iterations=(3, 2),
                    isotropic_R=True, isotropic_Q=True))


def test_float64_matches_jax():
    cube = _cube((5, 6, 7, 8), 9, np.float64)
    _compare(*_both("denoise4D", cube, np.full(4, 1.0), "jax",
                    iterations=(5, 4)), rtol=1e-12, atol=1e-12)
    cube3 = _cube((6, 7, 8), 10, np.float64)
    _compare(*_both("denoise3D", cube3, np.full(3, 0.8), "jax",
                    iterations=12, stopping_relative_change=0.01),
             rtol=1e-12, atol=1e-12)


def test_validation_errors_match_jax():
    cube = _cube((6, 7, 8), 11, np.float64)
    cases = [
        (ValueError, dict(lam=np.full(3, 0.8)), cube),        # λ/μ = 1 > 1/16
        (TypeError, {}, cube.astype(np.int32)),                # int cube
        (TypeError, dict(mu=np.full(3, 0.8, np.float32)), cube),  # mu dtype
        (ValueError, {}, cube[0]),                             # wrong rank
        (ValueError, dict(BC_mode=5), cube),                   # no such BC
    ]
    for exc, kw, c in cases:
        kw = dict(kw)
        mu = kw.pop("mu", np.full(3, 0.8))
        for mod, extra in ((jtv, {}), (ttv, {"device": "cpu"})):
            with pytest.raises(exc):
                mod.denoise3D(c, mu, iterations=2, quiet=True, **kw, **extra)
    with pytest.raises(ValueError):
        ttv.denoise(np.zeros((3, 3), np.float32), 1.0, device="cpu")


@pytest.mark.parametrize("kw", [dict(lossy_duals=True), dict(backend="cpp")])
def test_not_ported_options_raise(kw):
    """``backend='cpp'`` is not ported and raises, naming its ROADMAP item.
    ``lossy_duals`` is ported (Queue 1 item 12(a)): the run happens, equals
    the JAX package's lossy run (the recon within atol 5e-7, its own
    tolerance, tests/test_lossy.py) and is not the exact run."""
    cube = _cube((4, 5, 6, 7), 12)
    mu = np.full(4, 1.0, np.float32)
    if "backend" in kw:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ttv.denoise4D(cube, mu, iterations=2, quiet=True, device="cpu",
                          **kw)
        return
    got, want = _both("denoise4D", cube, mu, "pallas", iterations=6, **kw)
    _compare(got[:1], want[:1], rtol=0, atol=5e-7)
    _compare(got[1:], want[1:])  # the traces: sums, in another order
    exact = ttv.denoise4D(cube, mu, iterations=6, quiet=True, device="cpu")
    assert np.max(np.abs(got[0] - exact[0])) > 1e-6


def test_solver_options_rejections_match_jax():
    bad = [dict(ndim=5), dict(ndim=3, isotropic_R=True),
           dict(ndim=4, bc_mode=7), dict(ndim=4, backend="nope")]
    for kw in bad:
        kw = dict(dict(iterations_fista=1, iterations_unacc=0), **kw)
        with pytest.raises(ValueError):
            JOptions(**kw)
        with pytest.raises(ValueError):
            TOptions(**kw)
    base = dict(ndim=4, iterations_fista=1, iterations_unacc=0)
    # pairs are on by default, as in cytvdn_tpu, and may be switched off
    assert TOptions(**base).temporal_pairs is True
    assert JOptions(**base).temporal_pairs is True
    assert TOptions(**base, temporal_pairs=False).temporal_pairs is False
    # the K-step kernel is on by default, as in cytvdn_tpu, with the depth
    # left to the rule unless pinned
    for opts in (TOptions(**base), JOptions(**base)):
        assert opts.temporal_kstep is True and opts.temporal_k is None
    assert TOptions(**base, temporal_kstep=False).temporal_kstep is False
    assert TOptions(**base, temporal_k=4).temporal_k == 4
    # the whole-run kernel is on by default, as in cytvdn_tpu, and may be
    # switched off
    for opts in (TOptions(**base), JOptions(**base)):
        assert opts.vmem_resident is True
    assert TOptions(**base, vmem_resident=False).vmem_resident is False


def test_check_memory_and_traffic_model():
    from cytvdn_tpu.utils.perf import traversals_per_iteration as j_trav
    from cytvdn_tpu_torch.utils.perf import (model_seconds, peak_bandwidth,
                                             traversals_per_iteration)

    cube = np.zeros((4, 5, 6, 7), np.float32)
    got = [r[:2] for r in ttv.check_memory(cube)]
    want = [r[:2] for r in jtv.check_memory(cube)]
    assert got == want
    for fista in (True, False):
        for nd in (3, 4):
            assert traversals_per_iteration(nd, fista, "two_pass") == \
                j_trav(nd, fista, "xla")
            assert traversals_per_iteration(nd, fista, "fused") == \
                j_trav(nd, fista, "fused")
    assert traversals_per_iteration(4, True, "two_pass") == 24
    # the pair kernel's band: two passes down to half the one-pass traffic
    assert traversals_per_iteration(4, True, "pair_upper") == 24
    assert traversals_per_iteration(4, True, "pair_floor") == 9.5
    assert traversals_per_iteration(3, False, "pair_floor") == \
        j_trav(3, False, "pair") - 1
    assert peak_bandwidth("NVIDIA H100 80GB HBM3") == 3.35e12
    assert peak_bandwidth("NVIDIA A100") is None
    assert model_seconds((10, 10, 10, 10), True, "two_pass", 1e9) == \
        pytest.approx(24 * 1e4 * 4 / 1e9)
