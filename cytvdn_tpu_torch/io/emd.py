"""EMD v0.7 writer/reader — byte-compatible group/attribute layout with the
reference's hard-coded collective writer (reference cyTVDN/mpi.py:444-498).

The single-process part of ``cytvdn_tpu/io/emd.py``, kept inside the port:
the same skeleton, dim datasets and data, so a file written by either
package reads in the other. Multi-shard output is written as sequential
region writes into one file (:func:`write_emd_regions`), the
single-process analog of the reference's per-rank ``write_direct`` with
``dest_sel`` region selections (mpi.py:493-497). The JAX package's
multi-process writers (sharded arrays, part files and their stitching, the
raw-offset row writers) are not ported yet (ROADMAP.md Queue 1 item 10).
"""

from __future__ import annotations

from typing import Iterable, Tuple

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


def _create_structure(fout, shape, dtype):
    """Create the EMD v0.7 skeleton (groups, attrs, dim axes) exactly as
    the reference lays it out (reference cyTVDN/mpi.py:449-491)."""
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
