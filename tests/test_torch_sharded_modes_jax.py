"""The K=1 kernel's mesh-only halo modes against the JAX package, on the
CPU: the plain iteration with ring halos (periodic), mirror halos with the
``edge_next`` flags, half-isotropic seams (axis 0, axis 1) and corners, and
in-block halos of axes 2 and 3 (Jia-Zhao, iso Q with in-block corners, the
3D energy axis) against the JAX fused kernel with the same operands in
interpret mode, on the first, an interior and the last of three blocks;
blocks run with those halos and put back, bitwise one whole-cube
iteration; and mesh runs of the port against the JAX ``run_sharded`` on
the 8 fake CPU devices.

The halo operands come from the whole cube's pre-update state
(``torch_halo_blocks.py``), with nonzero values at every seam. Tolerances:
against the JAX kernel rtol 2e-5 / atol 2e-6 on the state and rtol 1e-5 on
the sums (tests/test_torch_outofcore.py's); against the JAX
``run_sharded`` those of tests/test_torch_sharded.py (float32 rtol 2e-5 /
atol 2e-6, float64 tests/test_sharded.py's: recon atol 1e-13, b_norm rtol
1e-12, delta rtol 1e-10). The JAX kernel projects an iso pair with
``sqrt(a*a + b*b)``, the port with ``hypot``: within those tolerances.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_halo_blocks import (  # noqa: E402
    HALO_MODES,
    block_bounds,
    block_halos,
    block_state,
    mode_coords,
)
from test_torch_outofcore import _state  # noqa: E402
from test_torch_sharded import _cube, _jax_state, on_mesh  # noqa: E402
from cytvdn_tpu.config import BCMode as JBC  # noqa: E402
from cytvdn_tpu.config import SolverOptions as JOptions  # noqa: E402
from cytvdn_tpu.kernels.fused import fused_iteration as j_fused  # noqa: E402
from cytvdn_tpu.parallel import sharded as jsharded  # noqa: E402
from cytvdn_tpu_torch.config import SolverOptions as TOptions  # noqa: E402
from cytvdn_tpu_torch.kernels import fused as tfused  # noqa: E402
from cytvdn_tpu_torch.parallel import MeshComm, run_sharded, state_block  # noqa: E402
from cytvdn_tpu_torch.parallel.multihost import (  # noqa: E402
    block_slices,
    load_sharded_block,
    rank_coords,
)
from cytvdn_tpu_torch.utils.state import state_from_numpy  # noqa: E402

RTOL, ATOL = 2e-5, 2e-6


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _block_step(state, grid, coords, fista, mode, step=tfused.fused_iteration):
    """One port iteration of a block with the halos of ``mode``; returns the
    block's state and sums."""
    orig, recon, accs, ds, li, lm = state
    h, edge = block_halos(recon, accs, ds, grid, coords, **mode)
    nd = recon.ndim
    bs = block_state([orig, recon] + accs + (ds or []), grid, coords)
    r, a = _t(bs[1]), [_t(x) for x in bs[2:2 + nd]]
    d = [_t(x) for x in bs[2 + nd:]] if fista else None
    out = step(_t(bs[0]), r, a, d, torch.tensor(0.37, dtype=r.dtype), _t(li),
               _t(lm), fista=fista, halos={k: _t(v) for k, v in h.items()},
               edge_next=edge, **{k: v for k, v in mode.items() if k != "bc"},
               bc=mode.get("bc", 2))
    return r, a, d, [float(x) for x in out[3:]], h, edge, bs


@pytest.mark.parametrize("fista", [True, False])
@pytest.mark.parametrize("name", sorted(HALO_MODES))
def test_plain_halo_modes_match_jax_kernel(name, fista):
    mode, shape, grid, ax = HALO_MODES[name]
    state = _state(shape, fista, seed=1)
    nd = len(shape)
    for i in range(3):
        r, a, d, sums, h, edge, bs = _block_step(
            state, grid, mode_coords(grid, ax, i), fista, mode)
        want = j_fused(
            jnp.asarray(bs[0]), jnp.asarray(bs[1]),
            tuple(jnp.asarray(x) for x in bs[2:2 + nd]),
            tuple(jnp.asarray(x) for x in bs[2 + nd:]) if fista else None,
            jnp.float32(0.37), jnp.asarray(state[4]), jnp.asarray(state[5]),
            fista=fista, interpret=True,
            halos={k: jnp.asarray(v) for k, v in h.items()},
            edge_next=jnp.asarray(edge, jnp.float32), **mode)
        for got, w in zip([r] + a + (d or []),
                          [want[0], *want[1], *(want[2] or ())]):
            np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                       rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(sums, [float(x) for x in want[3:]],
                                   rtol=1e-5)


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("fista", [True, False])
@pytest.mark.parametrize("name", sorted(HALO_MODES))
def test_halo_mode_blocks_reassemble_bitwise(name, fista, dtype):
    """Every block of the grid run with its halos and put back: bitwise
    one iteration of the whole cube, the sums adding up (float64 iso runs
    within 1 ulp: torch's CPU ``hypot`` differs between its vector and
    scalar paths)."""
    mode, shape, grid, _ = HALO_MODES[name]
    state = _state(shape, fista, seed=2, dtype=dtype)
    orig, recon, accs, ds, li, lm = state
    R, A = _t(recon), [_t(x) for x in accs]
    D = [_t(x) for x in ds] if fista else None
    want = tfused.fused_iteration_reference(
        _t(orig), R, A, D, torch.tensor(0.37, dtype=R.dtype), _t(li), _t(lm),
        fista=fista, **mode)
    got = [x.copy() for x in [recon] + accs + (ds or [])]
    total = np.zeros(3)
    for coords in itertools.product(*(range(w) for w in grid)):
        r, a, d, sums, *_ = _block_step(state, grid, coords, fista, mode)
        sl = tuple(slice(*b) for b in block_bounds(shape, grid, coords))
        for g, x in zip(got, [r] + a + (d or [])):
            g[sl] = x.numpy()
        total += sums
    iso = mode.get("iso_r") or mode.get("iso_q")
    for g, w in zip(got, [R] + A + (D or [])):
        if iso and dtype == np.float64:
            np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=1e-15)
        else:
            np.testing.assert_array_equal(g, w.numpy())
    np.testing.assert_allclose(total, [float(x) for x in want[3:]],
                               rtol=1e-5 if dtype == np.float32 else 1e-12)


# -- mesh runs against the JAX run_sharded ------------------------------------

JAX_MESHES = [
    ((8, 6, 16), (2, 1, 2), dict(bc_mode=0), 5, 0),
    ((8, 8, 6, 8), (2, 2, 1, 1), dict(bc_mode=1), 4, 3),
    ((8, 8, 6, 8), (2, 2, 1, 1), dict(isotropic_R=True), 7, 0),
    ((4, 6, 8, 8), (1, 1, 2, 2), dict(isotropic_Q=True), 0, 6),
    ((4, 6, 8, 8), (1, 1, 2, 1), dict(), 4, 2),
]


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("case", JAX_MESHES, ids=[
    f"{c[0]}-{c[1]}-{c[2]}" for c in JAX_MESHES])
def test_mode_mesh_matches_jax_run_sharded(case, dtype):
    """The same mid-run state fed to both packages: the port's mesh run
    against the JAX ``run_sharded`` on the fake CPU devices."""
    shape, shard, kw, n_f, n_u = case
    cube = _cube(shape, seed=31, dtype=dtype)
    nd = len(shape)
    state = _jax_state(cube, n_f, n_u, torch.float64 if dtype == np.float64
                       else torch.float32)
    li = np.full(nd, 32.0 if nd == 4 else 16.0, dtype)
    lm = np.full(nd, 1 / 32 if nd == 4 else 1 / 16, dtype)
    jst = {"recon": jnp.asarray(state["recon"]),
           "accs": tuple(jnp.asarray(a) for a in state["accs"]),
           "ds": tuple(jnp.asarray(a) for a in state["ds"]),
           "b_norm": jnp.asarray(state["b_norm"]),
           "delta": jnp.asarray(state["delta"]),
           "mse": jnp.zeros((0,), dtype), "i": jnp.int32(3),
           "tk": jnp.float32(1.0)}
    jkw = dict(kw, bc_mode=JBC(kw["bc_mode"])) if "bc_mode" in kw else kw
    want = jsharded.run_sharded(
        cube, li, lm, JOptions(ndim=nd, iterations_fista=n_f,
                               iterations_unacc=n_u, **jkw),
        shard=shard, state=jst, keep_state=True)
    opts = TOptions(ndim=nd, iterations_fista=n_f, iterations_unacc=n_u,
                    **kw)

    def rank(pg, r):
        comm = MeshComm(pg, shard, r)
        blk = state_from_numpy(state_block(state, shard, r), "cpu")
        orig = torch.from_numpy(load_sharded_block(cube, shard, r, dtype))
        out = run_sharded(orig, torch.from_numpy(li), torch.from_numpy(lm),
                          opts, comm, state=blk)
        return comm.gather_blocks(out["recon"], shape, block_slices(
            shape, shard, rank_coords(shard, r))), out

    recon, out = on_mesh(int(np.prod(shard)), rank)[0]
    if dtype == np.float64:
        tol = dict(recon=dict(atol=1e-13, rtol=0),
                   b_norm=dict(rtol=1e-12), delta=dict(rtol=1e-10))
    else:
        tol = {k: dict(rtol=2e-5, atol=2e-6)
               for k in ("recon", "b_norm", "delta")}
    np.testing.assert_allclose(recon, np.asarray(want["recon"]),
                               **tol["recon"])
    for key in ("b_norm", "delta"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(want[key]),
                                   **tol[key])
    assert out["iterations_run"] == int(want["iterations_run"])
