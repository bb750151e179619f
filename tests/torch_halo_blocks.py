"""Halo operands of one block of a whole cube, built from the cube's
pre-update state by slicing — independent of ``parallel/halo.py`` and the
engine — as a mesh shard receives them (``cytvdn_tpu/solver/engine.py:
253-340``): for the tests of the K=1 kernel's halo modes (on the CPU and
on the card, numpy arrays or torch tensors; ``chip_smoke.py`` phase 10).

``block_halos(state, grid, coords, bc, iso_r, iso_q)`` gives, for the block
at ``coords`` of an even ``grid``, the seams of its halo axes (0, 1 and
every split axis): ``prev``/``next*`` slabs from its neighbours, on a ring
under periodic boundaries; at a global edge the Jia-Zhao values (own first
slab; own last slab and zeros), the mirror's slab 1; for a split axis of a
half-isotropic pair the partner accumulator slab and, where the partner is
split too, the diagonal corner; and the ``edge_next`` flags.
"""

import numpy as np

PERIODIC, MIRROR, JIA_ZHAO = 0, 1, 2

#: (mode, cube, grid, the axis along which the first, an interior and the
#: last block are taken; the block's other coordinates are the grid's
#: last): rings, mirror edges, iso R seams on axis 0 and axis 1, iso R
#: corners (axis 1 split too), in-block Jia-Zhao on axes 2 and 3, iso Q
#: with in-block corners, the 3D energy axis
HALO_MODES = {
    "ring": (dict(bc=0), (12, 6, 8, 16), (3, 2, 1, 1), 0),
    "mirror": (dict(bc=1), (12, 6, 8, 16), (3, 2, 1, 1), 0),
    "iso-seam0": (dict(iso_r=True), (12, 6, 8, 16), (3, 1, 1, 1), 0),
    "iso-seam1": (dict(iso_r=True), (12, 6, 8, 16), (1, 3, 1, 1), 1),
    "iso-corner": (dict(iso_r=True), (12, 6, 8, 16), (3, 2, 1, 1), 0),
    "inblock2": (dict(), (4, 6, 12, 16), (1, 1, 3, 1), 2),
    "inblock3": (dict(), (4, 6, 8, 24), (1, 1, 1, 3), 3),
    "iso-q-corner": (dict(iso_q=True), (4, 6, 12, 16), (1, 1, 3, 2), 2),
    "energy": (dict(), (6, 8, 15), (1, 1, 3), 2),
}


def mode_coords(grid, ax, i):
    """The coordinates of block ``i`` along ``ax``, the grid's last along
    the other axes."""
    coords = [w - 1 for w in grid]
    coords[ax] = i
    return tuple(coords)


def block_bounds(shape, grid, coords):
    return [(c * (n // w), (c + 1) * (n // w))
            for n, w, c in zip(shape, grid, coords)]


def _take(a, sl):
    """A contiguous copy of ``a``'s part ``sl`` (never a view)."""
    x = a[tuple(slice(x, y) for x, y in sl)]
    if isinstance(x, np.ndarray):
        return np.array(x, copy=True, order="C")
    import torch

    return x.clone(memory_format=torch.contiguous_format)


def _zeros(x):
    return x.new_zeros(x.shape) if hasattr(x, "new_zeros") \
        else np.zeros_like(x)


def block_state(state, grid, coords):
    """The block's part of every array of ``state`` (a list)."""
    b = block_bounds(state[0].shape, grid, coords)
    return [_take(x, b) for x in state]


def block_halos(recon, accs, ds, grid, coords, bc=JIA_ZHAO, iso_r=False,
                iso_q=False):
    """``(halos, edge_next)`` of the block (arrays or tensors like
    ``recon``; ``ds`` None: unaccelerated)."""
    shape = recon.shape
    nd = len(shape)
    bounds = block_bounds(shape, grid, coords)
    split = {ax for ax in range(nd) if grid[ax] > 1}
    axes = sorted({0, 1} | split)
    partner = {}
    if bc != PERIODIC:
        for p, q in ([(0, 1)] if iso_r else []) + ([(2, 3)] if iso_q else []):
            partner.update({p: q, q: p})

    def slab(a, ax, i, over=None):
        sl = list(over or bounds)
        sl[ax] = (i, i + 1)
        return _take(a, sl)

    def next_index(ax, over=None):
        """The +1 neighbour's first index along ax, or None at the edge
        (a ring wraps)."""
        a1 = (over or bounds)[ax][1]
        if a1 < shape[ax]:
            return a1
        return 0 if bc == PERIODIC else None

    h = {}
    for ax in axes:
        a0, a1 = bounds[ax]
        if a0 > 0:
            h[f"prev{ax}"] = slab(recon, ax, a0 - 1)
        elif bc == PERIODIC:
            h[f"prev{ax}"] = slab(recon, ax, shape[ax] - 1)
        elif bc == MIRROR:
            h[f"prev{ax}"] = slab(recon, ax, 1)
        else:
            h[f"prev{ax}"] = slab(recon, ax, a0)
        j = next_index(ax)
        if j is not None:
            h[f"next{ax}_recon"] = slab(recon, ax, j)
            h[f"next{ax}_acc"] = slab(accs[ax], ax, j)
            if ds is not None:
                h[f"next{ax}_d"] = slab(ds[ax], ax, j)
        else:
            h[f"next{ax}_recon"] = slab(recon, ax, a1 - 1)
            h[f"next{ax}_acc"] = _zeros(h[f"next{ax}_recon"])
            if ds is not None:
                h[f"next{ax}_d"] = _zeros(h[f"next{ax}_recon"])
        o = partner.get(ax)
        if o is not None and ax in split:
            h[f"next{ax}_acc{o}"] = slab(accs[o], ax, j) if j is not None \
                else _zeros(h[f"next{ax}_acc"])
            if o in split:
                # the -1-along-o neighbour's next{ax}_recon, its last slab
                # along o; the own halo's leading slab at o's leading edge
                b0 = bounds[o][0]
                over = list(bounds)
                over[o] = (b0 - 1, b0) if b0 > 0 else (b0, b0 + 1)
                jj = next_index(ax, over)
                h[f"corner{ax}"] = slab(recon, ax, jj if jj is not None
                                        else a1 - 1, over)
    edge_next = [float(bounds[ax][1] == shape[ax]) for ax in range(nd)]
    return h, edge_next
