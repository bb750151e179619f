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
from cytvdn_tpu_torch.kernels.temporal import round_bf16  # noqa: E402
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


ISO_PAIRS = [(True, False), (False, True), (True, True)]


# each iso pair at (6, 8, 6, 16) and at a ragged shape (odd extents on every
# axis, a last extent past one 32-wide tile)
@pytest.mark.parametrize(
    "iso_r,iso_q,shape",
    [(r, q, (6, 8, 6, 16)) for r, q in ISO_PAIRS]
    + [(r, q, (5, 7, 9, 33)) for r, q in ISO_PAIRS],
    ids=[f"{r}-{q}" for r, q in ISO_PAIRS]
    + [f"{r}-{q}-ragged" for r, q in ISO_PAIRS])
@pytest.mark.parametrize("fista", [True, False])
def test_fused_iteration_iso_matches_pallas(iso_r, iso_q, shape, fista):
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
    # bfloat16 shadow duals (lossy duals) run: recon and b are the exact
    # launch's on the widened duals, and the new d is its d rounded to
    # nearest even; float64 data and mirror boundaries refuse them
    lossy = [d.to(torch.bfloat16) for d in args[3]]
    exact = [d.float() for d in lossy]
    runs = []
    for ds in (lossy, exact):
        r, a = args[1].clone(), [x.clone() for x in args[2]]
        tfused.fused_iteration(args[0], r, a, ds, *args[4:], fista=True)
        runs.append((r, a, ds))
    assert torch.equal(runs[0][0], runs[1][0])
    for k in range(3):
        assert torch.equal(runs[0][1][k], runs[1][1][k])
        assert runs[0][2][k].dtype == torch.bfloat16
        assert torch.equal(runs[0][2][k].float(), round_bf16(runs[1][2][k]))
    with pytest.raises(ValueError, match="ds"):
        tfused.fused_iteration(*(x.double() for x in args[:2]),
                               [x.double() for x in args[2]], lossy,
                               *(x.double() for x in args[4:]), fista=True)
    with pytest.raises(ValueError, match="Jia-Zhao"):
        tfused.fused_iteration(*args[:3], lossy, *args[4:], fista=True, bc=1)
    thin = torch.zeros((1, 5, 6))
    with pytest.raises(ValueError, match="does not cover"):
        tfused.fused_iteration(thin, thin.clone(), [thin.clone()] * 3, None,
                               None, t(li), t(lm), fista=False, bc=1)
    with pytest.raises(ValueError, match="does not cover"):
        tfused.fused_iteration(*args, fista=True, iso_r=True)


@pytest.mark.parametrize("fista", [True, False])
def test_wrapper_runs_inblock_halos(fista):
    """An in-block axis's halos (``prev2`` and the +1 neighbour's slabs of
    axis 2, as a mesh that splits the energy axis gives them, with axes 0
    and 1's Jia-Zhao edge values): the cube of the rejection test above cut
    in two along axis 2, each half run with its halos and put back, is
    bitwise one iteration of the whole cube."""
    orig, recon, accs, ds, li, lm = _state((4, 5, 6), fista, 2, seed=3)
    if not fista:
        ds = None
    t = torch.from_numpy
    R, A = t(recon.copy()), [t(a.copy()) for a in accs]
    D = [t(d.copy()) for d in ds] if fista else None
    tfused.fused_iteration(t(orig), R, A, D, torch.tensor(0.5), t(li), t(lm),
                           fista=fista)
    grid = (1, 1, 2)
    got = np.concatenate([
        _inblock_half(orig, recon, accs, ds, li, lm, grid, c, fista)
        for c in ((0, 0, 0), (0, 0, 1))], axis=2)
    np.testing.assert_array_equal(got, R.numpy())


def _inblock_half(orig, recon, accs, ds, li, lm, grid, coords, fista):
    from torch_halo_blocks import block_halos, block_state

    h, _ = block_halos(recon, accs, ds, grid, coords)
    assert "prev2" in h
    bs = block_state([orig, recon], grid, coords)
    blk = [torch.from_numpy(x) for x in block_state(accs + (ds or []), grid,
                                                     coords)]
    r = torch.from_numpy(bs[1])
    tfused.fused_iteration(torch.from_numpy(bs[0]), r, blk[:3],
                           blk[3:] if fista else None, torch.tensor(0.5),
                           torch.from_numpy(li), torch.from_numpy(lm),
                           fista=fista,
                           halos={k: torch.from_numpy(v)
                                  for k, v in h.items()})
    return r.numpy()


def test_launch_route_tiling_and_item_guard():
    """The wrapper's pure-Python launch plan: float32 launches without
    halos take the vector walk, float64 launches the scalar passes (launches
    with halos: test_launch_route_with_halos); the walk's tiling
    (``csrc/vec_walk.cuh::set_tiles``) and default item order; each
    entry's 2**31 work-item guard in its own tiling."""
    assert tfused.takes_walk(torch.float32, None)
    assert not tfused.takes_walk(torch.float64, None)
    # (lw, tiles of 256 / lw rows, tiles of 4 lw elements)
    assert tfused.walk_tiles((256, 256, 128, 128)) == (32, 16, 1)
    assert tfused.walk_tiles((256, 256, 2048)) == (32, 32, 16)
    assert tfused.walk_tiles((7, 9, 5, 1)) == (1, 1, 1)
    assert tfused.walk_tiles((5, 7, 9, 30)) == (8, 1, 1)
    assert tfused.walk_tiles((9, 17, 33)) == (16, 2, 1)
    assert tfused.walk_tiles((6, 300, 129)) == (32, 38, 2)
    assert tfused.launch_items((256, 256, 128, 128), torch.float32,
                               None) == (True, 65536 * 16)
    assert tfused.launch_items((256, 256, 128, 128), torch.float64,
                               None) == (False, 65536 * 64)
    assert tfused.walk_rows((6, 13, 64)) == 6
    assert tfused.walk_band((6, 13, 64)) == 1
    assert tfused.walk_rows((5, 7, 9, 30)) == 35
    # 2**29 rows of one walk tile and of four scalar tiles: the walk takes
    # them, the scalar passes refuse them; 2**31 rows neither
    big = (2**15, 2**14, 8, 128)
    assert tfused.launch_items(big, torch.float32, None) == (True, 2**29)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        tfused.launch_items(big, torch.float64, None)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        tfused.launch_items((2**16, 2**15, 8, 128), torch.float32, None)


def _halo_dict(axes, fista=True, iso_keys=()):
    """A halo dict's keys for ``axes`` (values are never read by the
    route)."""
    keys = [k for ax in axes for k in tfused.halo_keys(ax, fista)]
    return {k: torch.zeros(1) for k in keys + list(iso_keys)}


@pytest.mark.parametrize("case", [
    # (shape, dtype, halo axes, bc, iso, takes the walk): Jia-Zhao
    # anisotropic float32 launches with halos on axes 0 and 1 only take
    # the walk (out-of-core slabs, axis-0, axis-1 and 2D-grid shards, 3D
    # and 4D); float64, halos on axes 2 and 3, rings, mirror edges and iso
    # pairs the scalar passes
    ((64, 256, 128, 128), torch.float32, (0, 1), 2, False, True),
    ((64, 256, 2048), torch.float32, (0, 1), 2, False, True),
    ((64, 256, 128, 128), torch.float32, (0,), 2, False, True),
    ((64, 256, 128, 128), torch.float64, (0, 1), 2, False, False),
    ((64, 256, 2048), torch.float64, (0, 1), 2, False, False),
    ((64, 256, 128, 128), torch.float32, (0, 1, 2), 2, False, False),
    ((64, 256, 128, 128), torch.float32, (0, 1, 3), 2, False, False),
    ((64, 256, 2048), torch.float32, (0, 1, 2), 2, False, False),
    ((64, 256, 128, 128), torch.float32, (0, 1), 0, False, False),
    ((64, 256, 128, 128), torch.float32, (0, 1), 1, False, False),
    ((64, 256, 2048), torch.float32, (0, 1), 0, False, False),
    ((64, 256, 128, 128), torch.float32, (0, 1), 2, True, False),
], ids=str)
def test_launch_route_with_halos(case):
    """``takes_walk``/``launch_items`` with halos: the entry a CUDA launch
    takes and its work items in that entry's tiling (the walk's tiles of
    256 / lw rows by 4 lw elements, the scalar passes' 8 x 32 tiles)."""
    shape, dtype, axes, bc, iso, walk = case
    halos = _halo_dict(axes)
    assert tfused.takes_walk(dtype, halos, bc, iso) is walk
    lw, tm, tl = tfused.walk_tiles(shape)
    rows = tfused.walk_rows(shape)
    work = rows * tm * tl if walk else \
        rows * -(-shape[-2] // 8) * -(-shape[-1] // 32)
    assert tfused.launch_items(shape, dtype, halos, bc, iso) == (walk, work)


def test_wrapper_checks_the_walk_launch_options():
    """``band`` and ``grid`` belong to the vector walk: the CPU path runs
    the plain version whatever valid values they take, and refuses a band
    outside 1 .. N1 (1 in 3D), a grid below 1, and either on a float64
    launch."""
    orig, recon, accs, ds, li, lm = _state((3, 4, 5, 6), True, 2, seed=3)
    t = torch.from_numpy
    outs = []
    for kw in ({}, dict(band=1, grid=7), dict(band=4, grid=1)):
        r, a, d = t(recon.copy()), [t(x.copy()) for x in accs], \
            [t(x.copy()) for x in ds]
        tfused.fused_iteration(t(orig), r, a, d, torch.tensor(0.5), t(li),
                               t(lm), fista=True, **kw)
        outs.append([r] + a + d)
    for other in outs[1:]:
        assert all(torch.equal(x, y) for x, y in zip(outs[0], other))
    args = (t(orig), t(recon), [t(a) for a in accs], [t(d) for d in ds],
            torch.tensor(0.5), t(li), t(lm))
    for kw, what in ((dict(band=0), "band"), (dict(band=5), "band"),
                     (dict(grid=0), "grid")):
        with pytest.raises(ValueError, match=what):
            tfused.fused_iteration(*args, fista=True, **kw)
    with pytest.raises(ValueError, match="vector walk"):
        tfused.fused_iteration(*(x.double() for x in args[:2]),
                               [x.double() for x in args[2]],
                               [x.double() for x in args[3]],
                               *(x.double() for x in args[4:]), fista=True,
                               band=1)
    o3, r3, a3, d3, li3, lm3 = _state((4, 5, 6), True, 2, seed=3)
    with pytest.raises(ValueError, match="band"):
        tfused.fused_iteration(t(o3), t(r3), [t(a) for a in a3],
                               [t(d) for d in d3], torch.tensor(0.5),
                               t(li3), t(lm3), fista=True, band=2)
