"""Per-rank input loading: each rank reads only its own block.

Counterpart of ``cytvdn_tpu/parallel/multihost.py::load_sharded_array``,
the replacement for the reference's parallel-HDF5 collective reads
(reference cyTVDN/mpi.py:111-118, 233-236). Where JAX builds one global
array from per-device callbacks, each rank here reads its block through
``InputHandle.read_block`` (or slices an in-memory array), so no rank ever
holds the full cube. :func:`state_block` cuts a state dict in the JAX
package's layout (numpy, as ``save_state`` writes it) into a rank's block,
which is how a state is carried into a mesh run.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple, Union

import numpy as np

from cytvdn_tpu_torch.io.loaders import InputHandle, open_input


def block_slices(shape: Sequence[int], grid: Sequence[int],
                 coords: Sequence[int]) -> Tuple[slice, ...]:
    """The slices of the block at ``coords`` of an evenly tiled ``shape``."""
    out = []
    for e, w, c in zip(shape, grid, coords):
        if e % w:
            raise ValueError(f"extent {e} does not tile evenly into {w}")
        n = e // w
        out.append(slice(c * n, (c + 1) * n))
    return tuple(out)


def rank_coords(grid: Sequence[int], rank: int) -> Tuple[int, ...]:
    """A rank's coordinates on the grid (row-major, as ``MeshComm``)."""
    return tuple(int(c) for c in np.unravel_index(int(rank), tuple(grid)))


def load_sharded_block(
    source: Union[str, InputHandle, np.ndarray],
    grid: Sequence[int],
    rank: int,
    dtype=np.float32,
) -> np.ndarray:
    """The block of ``rank`` on ``grid`` of a datacube, as a contiguous
    numpy array of ``dtype``. ``source`` may be a file path (read lazily:
    only the block), an open :class:`InputHandle` or an in-memory array."""
    close = False
    if isinstance(source, str):
        handle: Union[InputHandle, np.ndarray] = open_input(source)
        close = True
    else:
        handle = source
    try:
        sl = block_slices(handle.shape, grid, rank_coords(grid, rank))
        if isinstance(handle, np.ndarray):
            block = handle[sl]
        else:
            block = handle.read_block(sl)
        return np.ascontiguousarray(block).astype(dtype, copy=False)
    finally:
        if close:
            handle.close()


def state_block(state: Dict[str, Any], grid: Sequence[int],
                rank: int) -> Dict[str, Any]:
    """A rank's block of a state dict in the JAX package's layout (numpy
    ``recon``, ``accs``, ``ds`` over the whole cube; ``b_norm``,
    ``delta``, ``mse``, ``i``, ``tk`` replicated): the cube arrays cut to
    the block (contiguous copies), the rest as they are."""
    shape = np.shape(state["recon"])
    sl = block_slices(shape, grid, rank_coords(grid, rank))

    def cut(a):
        return np.ascontiguousarray(np.asarray(a)[sl])

    out = dict(state)
    out["recon"] = cut(state["recon"])
    out["accs"] = tuple(cut(a) for a in state["accs"])
    out["ds"] = tuple(cut(a) for a in (state.get("ds") or ()))
    return out
