"""The port's pair kernel (``cytvdn_tpu_torch.kernels.temporal``) and the
engine's paired phase against the JAX package's pair kernel, run as the
JAX tests run it on the CPU (interpret mode, tests/test_temporal.py).

On the CPU the port's wrapper runs its plain version (two plain
iterations); the CUDA kernel itself is held bitwise against that plain
version on the card (tests/test_torch_cuda.py and ``chip_smoke.py``).
Tolerances: state rtol 2e-5 / atol 2e-6 in float32 (tests/test_pallas.py),
sums rtol 1e-5. States keep each accumulator's leading slab along its own
axis at zero, the Jia-Zhao invariant both pair kernels rely on.
"""

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

import cytvdn_tpu.kernels.fused as F  # noqa: E402
import cytvdn_tpu.kernels.temporal as T  # noqa: E402
from cytvdn_tpu.config import Backend as JBackend  # noqa: E402
from cytvdn_tpu.config import SolverOptions as JOptions  # noqa: E402
from cytvdn_tpu.solver import engine as jengine  # noqa: E402
from cytvdn_tpu_torch.config import SolverOptions as TOptions  # noqa: E402
from cytvdn_tpu_torch.kernels import temporal as ttemporal  # noqa: E402
from cytvdn_tpu_torch.solver import engine as tengine  # noqa: E402
from cytvdn_tpu_torch.utils.state import state_from_numpy, state_to_numpy  # noqa: E402

RTOL, ATOL, SUM_RTOL = 2e-5, 2e-6, 1e-5
RHOS = [0.0, 0.28, 0.43, 0.52]


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


# (shape, fista, fused-budget override (3D flat layout), pair block cap
# (strip seams)) — the cases of tests/test_temporal.py
CASES = [
    ((6, 4, 6, 16), True, None, None),      # 4D, single strip
    ((6, 4, 6, 16), False, None, None),
    ((7, 12, 6, 16), True, None, 16384),    # 4D, 3 strips
    ((7, 12, 6, 16), False, None, 16384),
    ((5, 24, 6, 16), True, None, 16384),    # many strips
    ((5, 24, 6, 16), True, None, 4096),     # single-column strips
    ((8, 6, 64), True, None, None),         # 3D single layout
    ((6, 5, 256), True, 3000, 4096),        # 3D flat fold, b1=1 strips
    ((6, 5, 256), False, 3000, None),       # 3D flat fold, single strip
]


@pytest.mark.parametrize("shape,fista,budget,cap", CASES)
def test_pair_matches_pallas_pair(monkeypatch, shape, fista, budget, cap):
    if budget is not None:
        monkeypatch.setattr(F, "_BLOCK_BYTES_TARGET", budget)
    if cap is not None:
        monkeypatch.setattr(T, "_PAIR_BLOCK_CAP", cap)
    orig, recon, accs, ds, li, lm = _state(shape, fista, seed=sum(shape))

    r, a = jnp.asarray(recon), tuple(jnp.asarray(x) for x in accs)
    d = tuple(jnp.asarray(x) for x in ds) if fista else None
    want_sums = []
    for i in (0, 2):
        out = T.fused_pair_iteration(
            jnp.asarray(orig), r, a, d, jnp.float32(RHOS[i]),
            jnp.float32(RHOS[i + 1]), jnp.asarray(li), jnp.asarray(lm),
            fista=fista, interpret=True)
        r, a, d = out[:3]
        want_sums += [float(x) for x in out[3:9]]

    t = torch.from_numpy
    o, tr = t(orig), t(recon.copy())
    ta = [t(x.copy()) for x in accs]
    td = [t(x.copy()) for x in ds] if fista else None
    calls = ttemporal.fused_pair_iteration.calls
    got_sums = []
    for i in (0, 2):
        out = ttemporal.fused_pair_iteration(
            o, tr, ta, td, torch.tensor(RHOS[i]), torch.tensor(RHOS[i + 1]),
            t(li), t(lm), fista=fista)
        got_sums += [float(x) for x in out[3:]]
    assert ttemporal.fused_pair_iteration.calls == calls + 2

    _close(tr.numpy(), r)
    for k in range(len(shape)):
        _close(ta[k].numpy(), a[k])
        if fista:
            _close(td[k].numpy(), d[k])
    _close(got_sums, want_sums, rtol=SUM_RTOL, atol=0)


def test_pair_resumes_jax_engine_state():
    """A JAX paired FISTA run stopped after 4 iterations (keep_state) and
    resumed for two pairs in the port equals the 8-iteration JAX run."""
    cube, _, _, _, _, _ = _state((7, 12, 6, 16), False, seed=78)
    li = np.full(4, 32.0, np.float32)
    lm = np.full(4, 1 / 32.0, np.float32)

    def jrun(n):
        opts = JOptions(ndim=4, iterations_fista=n, iterations_unacc=0,
                        backend=JBackend.PALLAS, temporal_pairs=True,
                        temporal_kstep=False, vmem_resident=False)
        out = jengine.run_solver(jnp.asarray(cube), jnp.asarray(li),
                                 jnp.asarray(lm), opts, keep_state=True)
        return {k: (tuple(np.asarray(x) for x in v) if isinstance(v, tuple)
                    else np.asarray(v)) for k, v in out.items()}

    part, full = jrun(4), jrun(8)
    st = state_from_numpy(part, "cpu")
    assert st["i"] == 4
    rhos = torch.as_tensor(tengine.fista_tk_ratios(8), dtype=torch.float32)
    sums = []
    for i in (4, 6):
        out = ttemporal.fused_pair_iteration(
            torch.from_numpy(cube), st["recon"], st["accs"], st["ds"],
            rhos[i], rhos[i + 1], torch.from_numpy(li), torch.from_numpy(lm),
            fista=True)
        sums.append([float(x) for x in out[3:]])
    back = state_to_numpy(st)
    _close(back["recon"], full["recon"])
    for k in range(4):
        _close(back["accs"][k], full["accs"][k])
        _close(back["ds"][k], full["ds"][k])
    bn = [s[j] for s in sums for j in (0, 3)]
    dl = [s[j] / s[j + 1] for s in sums for j in (1, 4)]
    _close(bn, full["b_norm"][4:8], rtol=SUM_RTOL, atol=0)
    _close(dl, full["delta"][4:8], rtol=SUM_RTOL, atol=0)


@pytest.mark.parametrize("iters", [(4, 0), (5, 0), (0, 6), (3, 4), (5, 3)])
def test_solver_pairs_match_jax_paired_solver(iters):
    """Whole schedules (odd counts, hybrid) through both engines with pairs
    on and the K-step kernel off; each phase runs floor(n/2) pairs, and its
    odd remainder as one K=1 step (the iterations the pairs do not account
    for)."""
    shape = (7, 12, 6, 16)
    cube, _, _, _, _, _ = _state(shape, False, seed=3)
    li = np.full(4, 32.0, np.float32)
    lm = np.full(4, 1 / 32.0, np.float32)
    base = dict(ndim=4, iterations_fista=iters[0], iterations_unacc=iters[1],
                temporal_pairs=True, temporal_kstep=False)
    want = jengine.run_solver(jnp.asarray(cube), jnp.asarray(li),
                              jnp.asarray(lm),
                              JOptions(**base, backend=JBackend.PALLAS))
    pairs = ttemporal.fused_pair_iteration.calls
    # the whole-run kernel would take these small cubes: off, so the pairs
    # run
    got = tengine.run_solver(torch.from_numpy(cube), torch.from_numpy(li),
                             torch.from_numpy(lm),
                             TOptions(**base, vmem_resident=False))
    pairs = ttemporal.fused_pair_iteration.calls - pairs
    assert pairs == iters[0] // 2 + iters[1] // 2
    assert got["iterations_run"] - 2 * pairs == iters[0] % 2 + iters[1] % 2
    for key in ("recon", "b_norm", "delta"):
        _close(got[key].numpy(), want[key])


def _gate_variants():
    """(jax options, port options) pairs for the gate: BCs, iso, restart,
    the knob off, and the plain backends."""
    out = []
    for ndim in (3, 4):
        kws = [dict(), dict(bc_mode=0), dict(bc_mode=1),
               dict(fista_restart=True), dict(temporal_pairs=False),
               dict(iterations_fista=0, iterations_unacc=4)]
        if ndim == 4:
            kws += [dict(isotropic_R=True), dict(isotropic_Q=True)]
        for kw in kws:
            out.append((ndim, dict(kw, backend=JBackend.PALLAS), kw))
        out.append((ndim, dict(backend=JBackend.JAX), dict(backend="torch")))
    return out


@pytest.mark.parametrize("ndim,jkw,tkw", _gate_variants(), ids=str)
def test_gate_matches_jax(ndim, jkw, tkw):
    """The port's ``_resolve_temporal`` against the JAX one (single
    device): float32 and float64, N0 = 3 (refused) and 4."""
    base = dict(ndim=ndim, iterations_fista=4, iterations_unacc=0)
    jopts = JOptions(**dict(base, **jkw))
    topts = TOptions(**dict(base, **tkw))
    for n0 in (3, 4):
        shape = (n0, 6, 8, 16) if ndim == 4 else (n0, 8, 64)
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.float64, torch.float64)):
            want = jengine._resolve_temporal(jopts, shape, jdt, None)
            got = tengine._resolve_temporal(topts, shape, tdt)
            assert got == want, (shape, tdt)


def test_gate_refuses_stop_and_mse_in_this_slice(monkeypatch):
    """The JAX engine pairs stop-aware and MSE runs; the port sends them to
    the exact one-iteration loop until stop-aware pairing and the in-kernel
    SSE are ported."""
    shape = (6, 6, 8, 16)
    base = dict(ndim=4, iterations_fista=4, iterations_unacc=0)
    assert tengine._resolve_temporal(TOptions(**base), shape, torch.float32)
    for kw in (dict(stopping_relative_change=0.01), dict(calculate_mse=True)):
        assert jengine._resolve_temporal(
            JOptions(**base, backend=JBackend.PALLAS, **kw), shape,
            jnp.float32, None)
        assert not tengine._resolve_temporal(TOptions(**base, **kw), shape,
                                             torch.float32)
    from cytvdn_tpu_torch import denoise4D

    # the whole-run kernel off, which would take this small cube
    monkeypatch.setattr(tengine, "_resolve_resident", lambda *a: False)
    pairs = ttemporal.fused_pair_iteration.calls
    cube, _, _, _, _, _ = _state(shape, False, seed=5)
    denoise4D(cube, np.full(4, 1.0, np.float32), iterations=4, quiet=True,
              stopping_relative_change=1e-9, device="cpu")
    denoise4D(cube, np.full(4, 1.0, np.float32), iterations=4, quiet=True,
              reference_data=cube, device="cpu")
    assert ttemporal.fused_pair_iteration.calls == pairs


def test_pair_wrapper_rejects_what_the_kernel_does_not_take():
    t = torch.from_numpy
    orig, recon, accs, ds, li, lm = _state((4, 5, 6), True, seed=4)
    rho = torch.tensor(0.5)
    args = (t(orig), t(recon), [t(a) for a in accs], [t(d) for d in ds],
            rho, rho, t(li), t(lm))
    calls = ttemporal.fused_pair_iteration.calls
    with pytest.raises(ValueError, match="does not cover"):
        ttemporal.fused_pair_iteration(
            *(x.double() if isinstance(x, torch.Tensor) else
              [y.double() for y in x] for x in args), fista=True)
    thin = [x[:3] for x in (args[0], args[1])]
    with pytest.raises(ValueError, match="does not cover"):
        ttemporal.fused_pair_iteration(
            *thin, [a[:3] for a in args[2]], [d[:3] for d in args[3]],
            *args[4:], fista=True)
    with pytest.raises(ValueError, match="ds"):
        ttemporal.fused_pair_iteration(
            *args[:3], [d.to(torch.bfloat16) for d in args[3]], *args[4:],
            fista=True)
    with pytest.raises(ValueError, match="per axis"):
        ttemporal.fused_pair_iteration(*args[:3], None, *args[4:], fista=True)
    assert ttemporal.fused_pair_iteration.calls == calls
    assert not ttemporal.pair_supported((6, 5, 6, 7), torch.float32, 1)
    assert not ttemporal.pair_supported((6, 5, 6, 7), torch.float32, 2,
                                        isotropic_R=True)
    assert ttemporal.pair_supported((4, 5, 6), torch.float32, 2)
