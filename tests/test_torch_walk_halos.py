"""The K=1 iteration with Jia-Zhao anisotropic halos on axes 0 and 1 — the
launches the CUDA kernel's vector walk takes with seams (out-of-core slabs,
axis-0, axis-1 and 2D-grid mesh shards) — in the two block layouts that
the slab and mode tests (tests/test_torch_outofcore.py,
tests/test_torch_sharded_modes_jax.py) do not cut: the four corners of a
2 x 2 grid (seams on both axes, neighbours on each), and blocks of extent
1 on a halo axis, whose leading edge is also their trailing edge.

On the CPU the port's wrapper runs its plain version. It is held against
the JAX fused kernel with the same operands in interpret mode (as
tests/test_torch_sharded_modes_jax.py runs it), and every block of the
grid, run with its halos and put back, against one iteration of the whole
cube, bitwise. The kernel's walk itself is held bitwise against the plain
version on the card (tests/test_torch_cuda.py, ``chip_smoke.py`` phase 8).

Halo operands come from the whole cube's pre-update state
(``torch_halo_blocks.py``). Tolerances: against the JAX kernel rtol 2e-5 /
atol 2e-6 on the state and rtol 1e-5 on the sums
(tests/test_torch_sharded_modes_jax.py's).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_halo_blocks import block_bounds, block_halos, block_state  # noqa: E402
from test_torch_outofcore import _state  # noqa: E402
from cytvdn_tpu.kernels.fused import fused_iteration as j_fused  # noqa: E402
from cytvdn_tpu_torch.kernels import fused as tfused  # noqa: E402

RTOL, ATOL = 2e-5, 2e-6

#: (cube, grid, blocks taken): the corners of a 2 x 2 grid, and blocks of
#: extent 1 on axis 0 and on both axes (on axis 0 only in 3D where axis 1
#: keeps 2 rows), in 4D and 3D, the last extent ragged
LAYOUTS = {
    "grid-4d": ((6, 6, 5, 13), (2, 2, 1, 1),
                [(0, 0, 0, 0), (0, 1, 0, 0), (1, 0, 0, 0), (1, 1, 0, 0)]),
    "grid-3d": ((6, 8, 13), (2, 2, 1),
                [(0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0)]),
    "extent1-4d": ((3, 3, 5, 13), (3, 3, 1, 1),
                   [(0, 0, 0, 0), (1, 1, 0, 0), (2, 2, 0, 0), (0, 2, 0, 0)]),
    "extent1-3d": ((3, 6, 13), (3, 3, 1), [(0, 0, 0), (1, 1, 0), (2, 2, 0)]),
}


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _block_step(state, grid, coords, fista):
    """One port iteration of a block with its halos; returns the block's
    state, its sums, the halos and the block's pre-update arrays."""
    orig, recon, accs, ds, li, lm = state
    h, edge = block_halos(recon, accs, ds, grid, coords)
    assert set(tfused.halo_axes(h)) == {0, 1}
    assert tfused.takes_walk(torch.float32, h)
    nd = recon.ndim
    bs = block_state([orig, recon] + accs + (ds or []), grid, coords)
    r, a = _t(bs[1]), [_t(x) for x in bs[2:2 + nd]]
    d = [_t(x) for x in bs[2 + nd:]] if fista else None
    out = tfused.fused_iteration(
        _t(bs[0]), r, a, d, torch.tensor(0.37), _t(li), _t(lm), fista=fista,
        halos={k: _t(v) for k, v in h.items()}, edge_next=edge)
    return r, a, d, [float(x) for x in out[3:]], h, bs


@pytest.mark.parametrize("fista", [True, False])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_plain_walk_halo_layouts_match_jax_kernel(layout, fista):
    """Each block of the layout: the port's iteration with halos against the
    JAX fused kernel with the same halos in interpret mode."""
    shape, grid, blocks = LAYOUTS[layout]
    state = _state(shape, fista, seed=4)
    nd = len(shape)
    for coords in blocks:
        r, a, d, sums, h, bs = _block_step(state, grid, coords, fista)
        want = j_fused(
            jnp.asarray(bs[0]), jnp.asarray(bs[1]),
            tuple(jnp.asarray(x) for x in bs[2:2 + nd]),
            tuple(jnp.asarray(x) for x in bs[2 + nd:]) if fista else None,
            jnp.float32(0.37), jnp.asarray(state[4]), jnp.asarray(state[5]),
            fista=fista, interpret=True,
            halos={k: jnp.asarray(v) for k, v in h.items()})
        for got, w in zip([r] + a + (d or []),
                          [want[0], *want[1], *(want[2] or ())]):
            np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                       rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(sums, [float(x) for x in want[3:]],
                                   rtol=1e-5)


@pytest.mark.parametrize("fista", [True, False])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_walk_halo_layout_blocks_reassemble_bitwise(layout, fista):
    """Every block of the layout's grid run with its halos and put back:
    bitwise one iteration of the whole cube, the sums adding up."""
    shape, grid, _ = LAYOUTS[layout]
    state = _state(shape, fista, seed=5)
    orig, recon, accs, ds, li, lm = state
    R, A = _t(recon), [_t(x) for x in accs]
    D = [_t(x) for x in ds] if fista else None
    want = tfused.fused_iteration(_t(orig), R, A, D, torch.tensor(0.37),
                                  _t(li), _t(lm), fista=fista)
    got = [x.copy() for x in [recon] + accs + (ds or [])]
    total = np.zeros(3)
    for coords in itertools.product(*(range(w) for w in grid)):
        r, a, d, sums, *_ = _block_step(state, grid, coords, fista)
        sl = tuple(slice(*b) for b in block_bounds(shape, grid, coords))
        for g, x in zip(got, [r] + a + (d or [])):
            g[sl] = x.numpy()
        total += sums
    for g, w in zip(got, [R] + A + (D or [])):
        np.testing.assert_array_equal(g, w.numpy())
    np.testing.assert_allclose(total, [float(x) for x in want[3:]],
                               rtol=1e-5)
