"""The port's fused iteration (``cytvdn_tpu_torch.kernels.fused``) against
the JAX package's fused Pallas kernel, run as the JAX tests run it on the
CPU (interpret mode, through ``cytvdn_tpu.solver.engine.iteration_step``
with ``backend=PALLAS``, which also supplies the periodic/mirror wrap
halos).

On the CPU the port's wrapper runs its plain version; the kernel itself is
held bitwise against that plain version on the card
(tests/test_torch_cuda.py and ``chip_smoke.py``). Tolerances: rtol 2e-5 / atol 2e-6 in
float32, as tests/test_pallas.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from cytvdn_tpu.config import Backend as JBackend  # noqa: E402
from cytvdn_tpu.config import SolverOptions as JOptions  # noqa: E402
from cytvdn_tpu.kernels.fused import fused_supported as j_supported  # noqa: E402
from cytvdn_tpu.solver import engine as jengine  # noqa: E402
from cytvdn_tpu_torch.kernels import fused as tfused  # noqa: E402
from cytvdn_tpu_torch.solver.engine import fista_tk_ratios  # noqa: E402
from cytvdn_tpu_torch.utils.state import state_from_numpy, state_to_numpy  # noqa: E402

RTOL, ATOL = 2e-5, 2e-6


def _state(shape, fista, bc, seed):
    """Random state in the clip ball's range; under Jia-Zhao the leading
    slab of each accumulator along its axis is zero (the invariant the
    TPU kernel relies on, SURVEY.md §8.1)."""
    rng = np.random.default_rng(seed)
    ndim = len(shape)
    orig = (rng.standard_normal(shape) * 0.5 + 2.0).astype(np.float32)
    recon = (orig + rng.standard_normal(shape) * 0.05).astype(np.float32)
    accs = [(rng.standard_normal(shape) * 0.2).astype(np.float32)
            for _ in range(ndim)]
    ds = [(rng.standard_normal(shape) * 0.2).astype(np.float32)
          for _ in range(ndim)] if fista else None
    if bc == 2:
        for k in range(ndim):
            idx = [slice(None)] * ndim
            idx[k] = 0
            accs[k][tuple(idx)] = 0
            if fista:
                ds[k][tuple(idx)] = 0
    # clip radii small enough that the projections bind
    lambda_inv = np.linspace(0.2, 0.35, ndim).astype(np.float32)
    lam_mu = np.linspace(1 / 32, 1 / 48, ndim).astype(np.float32)
    return orig, recon, accs, ds, lambda_inv, lam_mu


def _jax_steps(orig, recon, accs, ds, rhos, lambda_inv, lam_mu, bc,
               iso_r=False, iso_q=False):
    ndim = orig.ndim
    opts = JOptions(ndim=ndim, iterations_fista=len(rhos) if ds else 0,
                    iterations_unacc=0 if ds else len(rhos), bc_mode=bc,
                    isotropic_R=iso_r, isotropic_Q=iso_q,
                    backend=JBackend.PALLAS, temporal_pairs=False,
                    temporal_kstep=False, vmem_resident=False)
    assert j_supported(orig.shape, jnp.float32, bc, iso_r, iso_q)
    o = jnp.asarray(orig)
    r = jnp.asarray(recon)
    a = tuple(jnp.asarray(x) for x in accs)
    d = tuple(jnp.asarray(x) for x in ds) if ds else None
    traces = []
    for rho in rhos:
        r, a, d, bnorm, delta = jengine.iteration_step(
            o, r, a, d, jnp.float32(rho) if ds else None,
            jnp.asarray(lambda_inv), jnp.asarray(lam_mu), opts)
        traces.append((float(bnorm), float(delta)))
    return r, a, d, traces


def _torch_steps(orig, recon, accs, ds, rhos, lambda_inv, lam_mu, bc,
                 iso_r=False, iso_q=False):
    t = torch.from_numpy
    o, r = t(orig.copy()), t(recon.copy())
    a = [t(x.copy()) for x in accs]
    d = [t(x.copy()) for x in ds] if ds else None
    li, lm = t(lambda_inv), t(lam_mu)
    traces = []
    for rho in rhos:
        _, _, _, bnorm, dnum, dden = tfused.fused_iteration(
            o, r, a, d, torch.tensor(rho, dtype=torch.float32), li, lm,
            fista=ds is not None, bc=bc, iso_r=iso_r, iso_q=iso_q)
        traces.append((float(bnorm), float(dnum / dden)))
    return r, a, d, traces


def _compare(got, want):
    g_r, g_a, g_d, g_tr = got
    w_r, w_a, w_d, w_tr = want
    np.testing.assert_allclose(g_r.numpy(), np.asarray(w_r), rtol=RTOL, atol=ATOL)
    for g, w in zip(g_a, w_a):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
    if w_d is not None:
        for g, w in zip(g_d, w_d):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                       atol=ATOL)
    np.testing.assert_allclose(np.asarray(g_tr), np.asarray(w_tr), rtol=RTOL)


@pytest.mark.parametrize("shape", [(6, 8, 16), (5, 6, 8, 16)])
@pytest.mark.parametrize("bc", [0, 1, 2])
@pytest.mark.parametrize("fista", [True, False])
def test_fused_iteration_matches_pallas(shape, bc, fista):
    state = _state(shape, fista, bc, seed=10 * bc + fista + len(shape))
    rhos = [0.0, 0.28, 0.43]
    want = _jax_steps(*state[:4], rhos, *state[4:], bc)
    got = _torch_steps(*state[:4], rhos, *state[4:], bc)
    _compare(got, want)


@pytest.mark.parametrize("iso_r,iso_q", [(True, False), (False, True),
                                         (True, True)])
@pytest.mark.parametrize("fista", [True, False])
def test_fused_iteration_iso_matches_pallas(iso_r, iso_q, fista):
    shape = (6, 8, 6, 16)
    state = _state(shape, fista, 2, seed=40 + 2 * iso_r + iso_q)
    rhos = [0.0, 0.28, 0.43]
    want = _jax_steps(*state[:4], rhos, *state[4:], 2, iso_r, iso_q)
    got = _torch_steps(*state[:4], rhos, *state[4:], 2, iso_r, iso_q)
    _compare(got, want)


def test_resume_jax_state_in_port():
    """A JAX FISTA run stopped after 4 iterations (keep_state) and resumed
    for 3 more in the port equals the 7-iteration JAX run."""
    rng = np.random.default_rng(77)
    cube = (rng.standard_normal((5, 6, 8, 16)) * 0.5 + 2.0).astype(np.float32)
    mu = np.full(4, 1.0, np.float32)
    lam = mu / 32.0
    li, lm = (1.0 / lam).astype(np.float32), (lam / mu).astype(np.float32)

    def jrun(n):
        opts = JOptions(ndim=4, iterations_fista=n, iterations_unacc=0,
                        backend=JBackend.PALLAS, temporal_pairs=False,
                        temporal_kstep=False, vmem_resident=False)
        out = jengine.run_solver(jnp.asarray(cube), jnp.asarray(li),
                                 jnp.asarray(lm), opts, keep_state=True)
        return {k: (tuple(np.asarray(x) for x in v) if isinstance(v, tuple)
                    else np.asarray(v)) for k, v in out.items()}

    part, full = jrun(4), jrun(7)
    st = state_from_numpy(part, "cpu")
    assert st["i"] == 4
    orig = torch.from_numpy(cube)
    rhos = torch.as_tensor(fista_tk_ratios(7), dtype=torch.float32)
    bn, dl = [], []
    for i in range(4, 7):
        _, _, _, b, num, den = tfused.fused_iteration(
            orig, st["recon"], st["accs"], st["ds"], rhos[i],
            torch.from_numpy(li), torch.from_numpy(lm), fista=True)
        bn.append(float(b))
        dl.append(float(num / den))
    back = state_to_numpy(st)
    np.testing.assert_allclose(back["recon"], full["recon"], rtol=RTOL, atol=ATOL)
    for k in range(4):
        np.testing.assert_allclose(back["accs"][k], full["accs"][k],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(back["ds"][k], full["ds"][k],
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(bn, full["b_norm"][4:7], rtol=RTOL)
    np.testing.assert_allclose(dl, full["delta"][4:7], rtol=RTOL)


def test_cpu_path_never_counts_launches():
    from cytvdn_tpu_torch import denoise4D

    before = tfused.fused_iteration.launches
    cube = np.random.default_rng(5).standard_normal((4, 5, 6, 7)).astype(np.float32)
    denoise4D(cube, np.full(4, 1.0, np.float32), iterations=3, quiet=True,
              device="cpu")
    assert tfused.fused_iteration.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    from cytvdn_tpu_torch import denoise3D

    orig, recon, accs, ds, li, lm = _state((4, 5, 6), True, 2, seed=3)
    t = torch.from_numpy
    args = (t(orig), t(recon), [t(a) for a in accs], [t(d) for d in ds],
            torch.tensor(0.5), t(li), t(lm))
    with pytest.raises(ValueError, match="cuda"):
        denoise3D(orig, np.full(3, 1.0, np.float32), iterations=2,
                  quiet=True, backend="cuda", device="cpu")
    # operand halos are ported for axis-0 slabs; an in-block axis's halo
    # (Q-axis meshes, ROADMAP Queue 1 item 8) is not
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        tfused.fused_iteration(*args, fista=True,
                               halos={"prev2": torch.zeros((4, 5, 1))})
    lossy = [d.to(torch.bfloat16) for d in args[3]]
    with pytest.raises(ValueError, match="ds"):
        tfused.fused_iteration(*args[:3], lossy, *args[4:], fista=True)
    thin = torch.zeros((1, 5, 6))
    with pytest.raises(ValueError, match="does not cover"):
        tfused.fused_iteration(thin, thin.clone(), [thin.clone()] * 3, None,
                               None, t(li), t(lm), fista=False, bc=1)
    with pytest.raises(ValueError, match="does not cover"):
        tfused.fused_iteration(*args, fista=True, iso_r=True)
