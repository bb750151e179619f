"""The port's K-step kernel (``cytvdn_tpu_torch.kernels.kstep``) and the
engine's K-step phase against the JAX package's K-step kernel, run as the
JAX tests run it on the CPU (interpret mode, tests/test_kstep.py), and
against the JAX engine.

On the CPU the port's wrapper runs its plain version (K plain iterations);
the CUDA kernel itself is held bitwise against that plain version on the
card (tests/test_torch_cuda.py and ``chip_smoke.py``). Tolerances: state
rtol 2e-5 / atol 2e-6 in float32 (tests/test_pallas.py), sums rtol 1e-5;
whole runs: recon rtol 2e-5, b_norm rtol 1e-5, delta rtol 1e-4
(tests/test_kstep.py). States are random and keep each accumulator's
leading slab along its own axis at zero, the Jia-Zhao invariant both
K-step kernels rely on.
"""

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

import cytvdn_tpu.kernels.kstep as KS  # noqa: E402
from cytvdn_tpu.config import Backend as JBackend  # noqa: E402
from cytvdn_tpu.config import SolverOptions as JOptions  # noqa: E402
from cytvdn_tpu.solver import engine as jengine  # noqa: E402
from cytvdn_tpu_torch.config import SolverOptions as TOptions  # noqa: E402
from cytvdn_tpu_torch.kernels import fused as tfused  # noqa: E402
from cytvdn_tpu_torch.kernels import kstep as tkstep  # noqa: E402
from cytvdn_tpu_torch.kernels import temporal as ttemporal  # noqa: E402
from cytvdn_tpu_torch.solver import engine as tengine  # noqa: E402
from cytvdn_tpu_torch.utils import perf  # noqa: E402
from cytvdn_tpu_torch.utils.state import state_from_numpy, state_to_numpy  # noqa: E402

RTOL, ATOL, SUM_RTOL = 2e-5, 2e-6, 1e-5


def _state(shape, fista, seed):
    """Random Jia-Zhao state in the clip ball's range, with clip radii small
    enough that the projections bind."""
    rng = np.random.default_rng(seed)
    ndim = len(shape)
    orig = (rng.standard_normal(shape) * 0.5 + 2.0).astype(np.float32)
    recon = (orig + rng.standard_normal(shape) * 0.05).astype(np.float32)
    accs = [(rng.standard_normal(shape) * 0.2).astype(np.float32)
            for _ in range(ndim)]
    ds = [(rng.standard_normal(shape) * 0.2).astype(np.float32)
          for _ in range(ndim)] if fista else None
    for k in range(ndim):
        idx = [slice(None)] * ndim
        idx[k] = 0
        accs[k][tuple(idx)] = 0
        if fista:
            ds[k][tuple(idx)] = 0
    lambda_inv = np.linspace(0.2, 0.35, ndim).astype(np.float32)
    lam_mu = np.linspace(1 / 32, 1 / 48, ndim).astype(np.float32)
    return orig, recon, accs, ds, lambda_inv, lam_mu


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# (shape, K, fista): the cases of tests/test_kstep.py
CASES = [
    ((8, 6, 64), 3, True),
    ((8, 6, 64), 3, False),
    ((8, 6, 64), 4, True),
    ((16, 6, 64), 6, True),
    ((16, 6, 64), 8, False),
    ((8, 4, 6, 16), 3, True),
    ((8, 4, 6, 16), 4, False),
    ((6, 5, 256), 3, True),
]


@pytest.mark.parametrize("shape,k,fista", CASES)
def test_kstep_matches_pallas_kstep(shape, k, fista):
    """Two launches with distinct momentum ratios from a random state."""
    orig, recon, accs, ds, li, lm = _state(shape, fista, seed=sum(shape) + k)
    rhos = np.linspace(0.0, 0.6, 2 * k).astype(np.float32)

    r, a = jnp.asarray(recon), tuple(jnp.asarray(x) for x in accs)
    d = tuple(jnp.asarray(x) for x in ds) if fista else None
    want_sums = []
    for i in (0, k):
        out = KS.fused_kstep_iteration(
            jnp.asarray(orig), r, a, d, jnp.asarray(rhos[i:i + k]),
            jnp.asarray(li), jnp.asarray(lm), k=k, fista=fista,
            interpret=True)
        r, a, d = out[:3]
        want_sums += np.stack([np.asarray(x) for x in out[3:]], 1).tolist()

    t = torch.from_numpy
    o, tr = t(orig), t(recon.copy())
    ta = [t(x.copy()) for x in accs]
    td = [t(x.copy()) for x in ds] if fista else None
    calls = tkstep.fused_kstep_iteration.calls
    got_sums = []
    for i in (0, k):
        out = tkstep.fused_kstep_iteration(
            o, tr, ta, td, t(rhos[i:i + k]), t(li), t(lm), k=k, fista=fista)
        got_sums += torch.stack(out[3:], 1).tolist()
    assert tkstep.fused_kstep_iteration.calls == calls + 2

    _close(tr.numpy(), r)
    for q in range(len(shape)):
        _close(ta[q].numpy(), a[q])
        if fista:
            _close(td[q].numpy(), d[q])
    _close(got_sums, want_sums, rtol=SUM_RTOL, atol=0)


def test_kstep_resumes_jax_engine_state():
    """A JAX K-step FISTA run stopped after 8 iterations (keep_state) and
    resumed for two K=4 launches in the port equals the 16-iteration JAX
    run."""
    shape = (16, 6, 64)
    cube = _state(shape, False, seed=79)[0]
    li = np.full(3, 16.0, np.float32)
    lm = np.full(3, 1 / 16.0, np.float32)

    def jrun(n):
        opts = JOptions(ndim=3, iterations_fista=n, iterations_unacc=0,
                        backend=JBackend.PALLAS, temporal_k=4,
                        vmem_resident=False)
        out = jengine.run_solver(jnp.asarray(cube), jnp.asarray(li),
                                 jnp.asarray(lm), opts, keep_state=True)
        return {k: (tuple(np.asarray(x) for x in v) if isinstance(v, tuple)
                    else np.asarray(v)) for k, v in out.items()}

    part, full = jrun(8), jrun(16)
    st = state_from_numpy(part, "cpu")
    assert st["i"] == 8
    rhos = torch.as_tensor(tengine.fista_tk_ratios(16), dtype=torch.float32)
    bn, dl = [], []
    for i in (8, 12):
        out = tkstep.fused_kstep_iteration(
            torch.from_numpy(cube), st["recon"], st["accs"], st["ds"],
            rhos[i:i + 4], torch.from_numpy(li), torch.from_numpy(lm), k=4,
            fista=True)
        bn += out[3].tolist()
        dl += (out[4] / out[5]).tolist()
    back = state_to_numpy(st)
    _close(back["recon"], full["recon"])
    for q in range(3):
        _close(back["accs"][q], full["accs"][q])
        _close(back["ds"][q], full["ds"][q])
    _close(bn, full["b_norm"][8:16], rtol=SUM_RTOL, atol=0)
    _close(dl, full["delta"][8:16], rtol=SUM_RTOL, atol=0)


# (iterations, temporal_k, the port's (K-step, pair, K=1) launches): the
# schedules of tests/test_kstep.py; the automatic depth at (16, 6, 64) is 8
SCHEDULES = [
    ((7, 0), 3, (2, 0, 1)),     # K=3 x2 + K=1
    ((0, 9), 4, (2, 0, 1)),     # unaccelerated, K=4 x2 + K=1
    ((8, 5), None, (1, 2, 1)),  # hybrid: K=8 x1 | pairs x2 + K=1
    ((11, 0), 3, (3, 1, 0)),    # K=3 x3 + a pair
    ((3, 0), None, (0, 1, 1)),  # a phase shorter than the depth
    ((5, 2), 4, (1, 1, 1)),     # K=4 + K=1 | a pair
]


@pytest.mark.parametrize("iters,tk,split", SCHEDULES, ids=str)
def test_solver_kstep_matches_jax_kstep_solver(monkeypatch, iters, tk, split):
    # pairs take the remainders as in the JAX engine: the port's row-size
    # rule, which keeps rows this small off the pairs, is lifted
    monkeypatch.setattr(tengine, "PAIR_MIN_ROW_BYTES", 0)
    shape = (16, 6, 64)
    cube = _state(shape, False, seed=3)[0]
    li = np.full(3, 16.0, np.float32)
    lm = np.full(3, 1 / 16.0, np.float32)
    base = dict(ndim=3, iterations_fista=iters[0], iterations_unacc=iters[1],
                temporal_k=tk)
    want = jengine.run_solver(
        jnp.asarray(cube), jnp.asarray(li), jnp.asarray(lm),
        JOptions(**base, backend=JBackend.PALLAS, vmem_resident=False))
    counters = (tkstep.fused_kstep_iteration, ttemporal.fused_pair_iteration,
                tfused.fused_iteration)
    before = [c.calls for c in counters]
    # the whole-run kernel would take these small cubes: off, so the
    # K-step phase runs
    got = tengine.run_solver(torch.from_numpy(cube), torch.from_numpy(li),
                             torch.from_numpy(lm),
                             TOptions(**base, vmem_resident=False))
    assert tuple(c.calls - b for c, b in zip(counters, before)) == split
    assert got["iterations_run"] == sum(iters)
    _close(got["recon"].numpy(), want["recon"])
    _close(got["b_norm"].numpy(), want["b_norm"], rtol=1e-5, atol=0)
    _close(got["delta"].numpy(), want["delta"], rtol=1e-4, atol=0)


def _gate_variants():
    """(ndim, jax options, port options) for the K-step gate: the knob
    off, a forced K=2, MSE, each non-Jia-Zhao BC, iso pairs, adaptive
    restart, the plain backends, forced depths, and the defaults."""
    out = []
    for ndim in (3, 4):
        kws = [dict(), dict(temporal_kstep=False), dict(temporal_k=2),
               dict(temporal_k=3), dict(temporal_k=4), dict(calculate_mse=True),
               dict(bc_mode=0), dict(bc_mode=1), dict(fista_restart=True),
               dict(temporal_pairs=False)]
        if ndim == 4:
            kws += [dict(isotropic_R=True), dict(isotropic_Q=True)]
        for kw in kws:
            out.append((ndim, dict(kw, backend=JBackend.PALLAS), kw))
        out.append((ndim, dict(backend=JBackend.JAX), dict(backend="torch")))
    return out


@pytest.mark.parametrize("ndim,jkw,tkw", _gate_variants(), ids=str)
def test_kstep_gate_matches_jax(ndim, jkw, tkw):
    """The port's ``_resolve_kstep`` against the JAX engine's decision on
    one device (the K-step runs only where the pair gate passes,
    ``engine.py:1515-1528``): float32 and float64, FISTA and unaccelerated
    phases, on shapes where the JAX VMEM plan fits, with N0 below 2K for
    the deeper depths."""
    base = dict(ndim=ndim, iterations_fista=8, iterations_unacc=0)
    jopts = JOptions(**dict(base, vmem_resident=False, **jkw))
    topts = TOptions(**dict(base, **tkw))
    shapes = [(16, 6, 64), (10, 6, 64), (5, 6, 64)] if ndim == 3 \
        else [(8, 4, 6, 16), (7, 4, 6, 16)]
    for shape in shapes:
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.float64, torch.float64)):
            for fista in (True, False):
                want = jengine._resolve_kstep(jopts, shape, jdt, None, fista) \
                    if jengine._resolve_temporal(jopts, shape, jdt, None) else 0
                got = tengine._resolve_kstep(topts, shape, tdt, fista)
                assert got == want, (shape, tdt, fista)


def test_kstep_gate_port_rules(monkeypatch):
    """What the port decides on its own: stop runs stay on the exact K=1
    loop in this slice (the JAX engine K-steps them), a forced depth with
    no compiled kernel raises, and config 1 (64x64x512) gets a depth."""
    shape = (16, 6, 64)
    base = dict(ndim=3, iterations_fista=8, iterations_unacc=0)
    stop = dict(stopping_relative_change=1e-6)
    assert jengine._resolve_kstep(
        JOptions(**base, backend=JBackend.PALLAS, **stop), shape,
        jnp.float32, None, True) >= 3
    assert tengine._resolve_kstep(TOptions(**base, **stop), shape,
                                  torch.float32, True) == 0
    for k in (5, 7, 9, 16):
        with pytest.raises(ValueError, match="compiled for K"):
            tengine._resolve_kstep(TOptions(**base, temporal_k=k), shape,
                                   torch.float32, True)
    cfg1 = dict(ndim=3, iterations_fista=0, iterations_unacc=7500)
    assert tengine._resolve_kstep(TOptions(**cfg1), (64, 64, 512),
                                  torch.float32, False) == 8
    assert tkstep.best_kstep((64, 64, 512), torch.float32, 2, False) == 8
    # rows of MBs stay on the pairs (the H100 rule); a forced depth does not
    for shp, fista in (((256, 256, 2048), True), ((128, 128, 64, 64), True),
                       ((256, 256, 128, 128), True)):
        assert tkstep.best_kstep(shp, torch.float32, 2, fista) == 0
        assert tkstep.best_kstep(shp, torch.float32, 2, fista, forced=6) == 6
    assert tkstep.best_kstep((11, 6, 64), torch.float32, 2, True) == 4
    assert tkstep.best_kstep((11, 6, 64), torch.float32, 2, True,
                             forced=8) == 0
    assert tkstep.best_kstep((16, 6, 64), torch.float32, 2, True,
                             forced=2) == 0
    # above 70 MB of state the one-iteration loop is faster than K=8, even
    # where a stage fits the L2; forced depths run
    assert tkstep.stage_bytes((1024, 64, 2048), 8, False) <= tkstep.L2_BYTES
    assert tkstep.best_kstep((1024, 64, 2048), torch.float32, 2, False) == 0
    assert tkstep.best_kstep((1024, 64, 2048), torch.float32, 2, False,
                             forced=8) == 8
    assert tkstep.best_kstep((128, 64, 2048), torch.float32, 2, False) == 0
    assert tkstep.best_kstep((32, 64, 2048), torch.float32, 2, False) == 0
    assert tkstep.state_bytes((24, 64, 2048), False) == 62_914_560
    assert tkstep.best_kstep((24, 64, 2048), torch.float32, 2, False) == 8
    assert tkstep.state_bytes((64, 64, 512), True) == 67_108_864
    assert tkstep.best_kstep((64, 64, 512), torch.float32, 2, True) == 8
    # stop runs through denoise3D make no K-step call (with the whole-run
    # kernel off, which would take this small cube)
    from cytvdn_tpu_torch import denoise3D

    monkeypatch.setattr(tengine, "_resolve_resident", lambda *a: False)

    calls = tkstep.fused_kstep_iteration.calls
    cube = _state(shape, False, seed=6)[0]
    denoise3D(cube, np.full(3, 1.0, np.float32), iterations=8, FISTA=True,
              stopping_relative_change=1e-9, quiet=True, device="cpu")
    assert tkstep.fused_kstep_iteration.calls == calls
    denoise3D(cube, np.full(3, 1.0, np.float32), iterations=8, FISTA=True,
              quiet=True, device="cpu")
    assert tkstep.fused_kstep_iteration.calls == calls + 1


def test_kstep_wrapper_rejects_what_the_kernel_does_not_take():
    t = torch.from_numpy
    orig, recon, accs, ds, li, lm = _state((8, 5, 6), True, seed=4)
    rhos = torch.full((3,), 0.5)
    args = (t(orig), t(recon), [t(a) for a in accs], [t(d) for d in ds],
            rhos, t(li), t(lm))
    calls = tkstep.fused_kstep_iteration.calls
    with pytest.raises(ValueError, match="does not cover"):
        tkstep.fused_kstep_iteration(
            *(x.double() if isinstance(x, torch.Tensor) else
              [y.double() for y in x] for x in args), k=3, fista=True)
    for k in (5, 8):  # uncompiled; N0 = 8 < 2K
        with pytest.raises(ValueError, match="does not cover"):
            tkstep.fused_kstep_iteration(*args, k=k, fista=True)
    with pytest.raises(ValueError, match="ds"):
        tkstep.fused_kstep_iteration(
            *args[:3], [d.to(torch.bfloat16) for d in args[3]], *args[4:],
            k=3, fista=True)
    with pytest.raises(ValueError, match="per axis"):
        tkstep.fused_kstep_iteration(*args[:3], None, *args[4:], k=3,
                                     fista=True)
    assert tkstep.fused_kstep_iteration.calls == calls
    assert tkstep.kstep_supported((8, 5, 6), torch.float32, 2, 4, True)
    assert not tkstep.kstep_supported((8, 5, 6), torch.float32, 0, 4, True)
    assert not tkstep.kstep_supported((8, 5, 6), torch.float32, 2, 2, True)


def test_kstep_traffic_band_and_launch_bound():
    """The K-step band (two-pass top, one fused pass per K iterations at
    the floor) and the per-launch bound of all three kernels: each input
    read once and each output written once at 3.35 TB/s."""
    t = perf.traversals_per_iteration
    assert t(4, True, "kstep_upper") == 24
    assert t(4, True, "kstep_floor", 8) == 19 / 8
    assert t(3, False, "kstep_floor", 4) == 9 / 4
    assert t(4, True, "kstep_floor", 2) == t(4, True, "pair_floor")
    bw, f32 = 3.35e12, 67e12
    for shape, fista, iters, ms in (((256, 256, 128, 128), True, 1, 24.36),
                                    ((256, 256, 128, 128), True, 2, 24.36),
                                    ((256, 256, 2048), True, 8, 2.40),
                                    ((64, 64, 512), False, 8, 0.0225)):
        s, by = perf.launch_bound_seconds(shape, fista, iters, bw, f32)
        assert by == "bytes" and s * 1e3 == pytest.approx(ms, rel=3e-3)
    # operations bound only far beyond these depths
    s, by = perf.launch_bound_seconds((64, 64, 512), False, 1000, bw, f32)
    assert by == "operations"
    assert perf.peak_f32("NVIDIA H100 80GB HBM3") == 67e12
