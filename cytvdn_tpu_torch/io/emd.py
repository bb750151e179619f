"""EMD v0.7 writer/reader — byte-compatible group/attribute layout with the
reference's hard-coded collective writer (reference cyTVDN/mpi.py:444-498).

``cytvdn_tpu/io/emd.py`` kept inside the port: the same skeleton, dim
datasets and data, so a file written by either package reads in the other.
Multi-shard output is written as sequential region writes into one file
(:func:`write_emd_regions`), the single-process analog of the reference's
per-rank ``write_direct`` with ``dest_sel`` region selections
(mpi.py:493-497). A mesh of processes writes through
:func:`write_emd_sharded`: rank 0 writes the gathered cube up to
``_GATHER_MAX_BYTES``; above, every rank writes its block to a
``.partN.h5`` sidecar and rank 0 stitches the master, copied into one file
(:func:`stitch_emd_solid`) or as a virtual dataset over the parts
(:func:`stitch_emd_virtual`), as the JAX package's multi-process writer
does. Not ported: the raw-offset row writers of multi-host out-of-core
runs (ROADMAP.md Queue 1 item 11).
"""

from __future__ import annotations

import os
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

try:
    import h5py
except Exception:  # pragma: no cover - h5py is expected in the image
    h5py = None


def _require_h5py():
    if h5py is None:
        raise RuntimeError("h5py is required for EMD I/O")


_DIM_META = [
    ("dim1", "R_x", "[pix]"),
    ("dim2", "R_y", "[pix]"),
    ("dim3", "Q_x", "[pix]"),
    ("dim4", "Q_y", "[pix]"),
]


def _create_structure(fout, shape, dtype, virtual_layout=None):
    """Create the EMD v0.7 skeleton (groups, attrs, dim axes) exactly as
    the reference lays it out (reference cyTVDN/mpi.py:449-491); the
    datacube a virtual dataset with ``virtual_layout``."""
    top = fout.create_group("4DSTEM_experiment")
    top.attrs.create("emd_group_type", 2)
    top.attrs.create("version_major", 0)
    top.attrs.create("version_minor", 7)

    top.create_group("metadata")
    data = top.create_group("data")
    datacubes = data.create_group("datacubes")
    data.create_group("counted_datacubes")
    data.create_group("diffractionslices")
    data.create_group("realslices")
    data.create_group("pointlists")
    data.create_group("pointlistarrays")

    dc = datacubes.create_group("datacube_0")
    if virtual_layout is not None:
        dset = dc.create_virtual_dataset("data", virtual_layout)
    else:
        dset = dc.create_dataset("data", shape, dtype=dtype)
    dc.attrs.create("emd_group_type", 1)
    dc.attrs.create("metadata", -1)

    for ax, (dim_name, name, units) in enumerate(_DIM_META[: len(shape)]):
        dim = dc.create_dataset(dim_name, (shape[ax],))
        dim[...] = np.arange(0, shape[ax])
        dim.attrs.create("name", np.bytes_(name))
        dim.attrs.create("units", np.bytes_(units))
    return dset


def emd_path(path: str) -> str:
    """The reference forces the output extension to .emd
    (reference mpi.py:447)."""
    if path.endswith(".emd"):
        return path
    stem = path.rsplit(".", 1)[0] if "." in path else path
    return stem + ".emd"


def write_emd(path: str, data: np.ndarray) -> str:
    """Write a full array as an EMD v0.7 file. Returns the actual path."""
    _require_h5py()
    path = emd_path(path)
    with h5py.File(path, "w") as fout:
        dset = _create_structure(fout, data.shape, data.dtype)
        dset[...] = data
    return path


def write_emd_regions(
    path: str,
    global_shape: Tuple[int, ...],
    dtype,
    regions: Iterable[Tuple[Tuple[slice, ...], np.ndarray]],
) -> str:
    """Create the EMD structure once, then write non-overlapping regions —
    the single-writer analog of the reference's per-rank region writes
    (reference mpi.py:493-497)."""
    _require_h5py()
    path = emd_path(path)
    with h5py.File(path, "w") as fout:
        dset = _create_structure(fout, global_shape, dtype)
        for sel, block in regions:
            dset[sel] = block
    return path


#: outputs up to this size are gathered and written by rank 0 alone (no
#: part files, no shared filesystem needed)
_GATHER_MAX_BYTES = 4 << 30
#: part-based outputs up to this size are stitched into one self-contained
#: file; larger ones keep the virtual-dataset master unless
#: ``stitch="solid"`` is asked for. Part files need a filesystem that every
#: rank sees, as the reference's MPI-IO writer does (mpi.py:115,447).
_SOLID_STITCH_MAX_BYTES = 8 << 30


def gathers(shape: Sequence[int], dtype, stitch: str = "auto") -> bool:
    """Whether :func:`write_emd_sharded` writes a cube of ``shape`` and
    ``dtype`` from the gathered cube (``stitch="auto"`` and at most
    ``_GATHER_MAX_BYTES``): the mesh run should then gather it."""
    nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
    return stitch == "auto" and nbytes <= _GATHER_MAX_BYTES


def write_emd_sharded(path: str, block: np.ndarray,
                      slices: Sequence[slice], shape: Sequence[int], comm,
                      stitch: str = "auto", gathered: bool = False,
                      recon: Optional[np.ndarray] = None) -> str:
    """Write a cube held as one block per rank of a mesh (``comm``, a
    ``parallel/halo.py::MeshComm``) as one EMD v0.7 output; every rank
    calls it with its ``block`` and the block's ``slices`` of the cube of
    ``shape``. Returns the output's path on every rank.

    - ``gathered``: the run has gathered the cube already, into ``recon``
      on rank 0 (``denoise_sharded``'s result and its ``gathered`` flag,
      the same on every rank); rank 0 writes one file. Else, where
      :func:`gathers` says so, the blocks are gathered here first.
    - Else every rank writes its block to ``<output>.partN.h5``; after one
      collective rank 0 stitches the master: ``"auto"`` copies the parts
      into one file (and deletes them) up to ``_SOLID_STITCH_MAX_BYTES``
      and keeps the virtual-dataset master above; ``"solid"`` always
      copies, ``"virtual"`` never does (the parts stay beside the master).
      The ranks meet once more before they return.
    """
    _require_h5py()
    block = np.asarray(block)
    shape = tuple(int(e) for e in shape)
    nbytes = int(np.prod(shape)) * block.dtype.itemsize
    failure = "failed to write its part of the EMD output"
    if gathered or gathers(shape, block.dtype, stitch):
        if not gathered:
            import torch

            t = torch.from_numpy(block)
            if comm.backend == "nccl":
                # NCCL moves tensors on the card only
                t = t.cuda()
            recon = comm.gather_blocks(t, shape)
        comm.together(lambda: write_emd(path, recon)
                      if comm.rank == 0 else None, failure)
        return emd_path(path)
    comm.together(lambda: write_emd_part(path, comm.rank,
                                         [(tuple(slices), block)]), failure)

    def stitch_parts():
        if comm.rank != 0:
            return
        if stitch == "solid" or (stitch == "auto"
                                 and nbytes <= _SOLID_STITCH_MAX_BYTES):
            stitch_emd_solid(path, shape, block.dtype, comm.world)
        else:
            stitch_emd_virtual(path, shape, block.dtype, comm.world)

    comm.together(stitch_parts, "failed to stitch the EMD output")
    return emd_path(path)


def _part_path(path: str, rank: int) -> str:
    return emd_path(path) + f".part{rank}.h5"


def write_emd_part(path: str, rank: int, regions) -> str:
    """Write one rank's regions ``[(slices, block), ...]`` to its sidecar
    part file, each block's place in the cube in its ``start`` attribute."""
    _require_h5py()
    part = _part_path(path, rank)
    with h5py.File(part, "w") as f:
        for i, (sel, block) in enumerate(regions):
            d = f.create_dataset(f"block{i}", data=np.asarray(block))
            d.attrs["start"] = [s.start or 0 for s in sel]
    return part


def _part_blocks(f):
    """``(name, selection in the cube)`` of each block of an open part."""
    for name in f:
        blk = f[name]
        start = [int(s) for s in blk.attrs["start"]]
        yield name, tuple(slice(st, st + ext)
                          for st, ext in zip(start, blk.shape))


def stitch_emd_virtual(path: str, global_shape, dtype, num_parts: int) -> str:
    """Create the EMD master whose datacube is a virtual dataset over the
    ``.partN.h5`` sidecars."""
    _require_h5py()
    path = emd_path(path)
    layout = h5py.VirtualLayout(shape=tuple(global_shape), dtype=dtype)
    for p in range(num_parts):
        part = _part_path(path, p)
        with h5py.File(part, "r") as f:
            for name, sel in _part_blocks(f):
                layout[sel] = h5py.VirtualSource(
                    os.path.basename(part), name, shape=f[name].shape)
    with h5py.File(path, "w") as fout:
        _create_structure(fout, tuple(global_shape), dtype,
                          virtual_layout=layout)
    return path


def stitch_emd_solid(path: str, global_shape, dtype, num_parts: int) -> str:
    """Copy the ``.partN.h5`` sidecar blocks into one self-contained EMD
    file, block by block (no cube-size host buffer), and delete the parts:
    the reference's single-file output (mpi.py:444-498) for a cube too
    large to gather."""
    _require_h5py()
    path = emd_path(path)
    with h5py.File(path, "w") as fout:
        dset = _create_structure(fout, tuple(global_shape), dtype)
        for p in range(num_parts):
            with h5py.File(_part_path(path, p), "r") as f:
                for name, sel in _part_blocks(f):
                    dset[sel] = f[name][...]
    for p in range(num_parts):
        try:
            os.remove(_part_path(path, p))
        except FileNotFoundError:
            pass
    return path


def read_emd(path: str, lazy: bool = False):
    """Read the datacube from an EMD v0.7 file (layout per the reference
    writer). With ``lazy=True`` returns ``(h5py.File, h5py.Dataset)`` for
    block reads; the caller closes the file."""
    _require_h5py()
    f = h5py.File(path, "r")
    try:
        dset = f["4DSTEM_experiment/data/datacubes/datacube_0/data"]
    except KeyError:
        # fall back: first dataset named "data" anywhere (EMD variants)
        found = []

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset) and name.endswith("/data"):
                found.append(obj)

        f.visititems(visit)
        if not found:
            f.close()
            raise ValueError(f"no datacube dataset found in {path}")
        dset = found[0]
    if lazy:
        return f, dset
    arr = dset[...]
    f.close()
    return arr
