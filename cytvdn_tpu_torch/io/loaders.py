"""Input loaders — the reference's memory-mapped open paths rebuilt
(reference cyTVDN/mpi.py:93-124); a copy of ``cytvdn_tpu/io/loaders.py``
kept inside the port, reading through the port's own ``dm`` and ``emd``:

- ``.dm3``/``.dm4`` via ncempy (3D EELS, reference mpi.py:97-101) or
  py4DSTEM (4D, mpi.py:107-109) when installed, falling back to the
  dependency-free built-in tag-tree reader (``cytvdn_tpu_torch/io/dm.py``) —
  DM files read out of the box;
- ``.h5``/``.emd`` via h5py (mpi.py:111-118) with lazy handles for
  per-shard block reads (the replacement for MPI-IO collective reads);
- ``.npy`` via numpy memmap (convenience addition).

The reference's 3D loader bug (x slice used twice, mpi.py:219) has no
analog here: block reads take explicit per-axis slices.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np


class InputHandle:
    """Uniform lazy view of an input datacube: ``.shape``, ``.dtype``,
    ``.read_block(slices)`` and ``.read()``; close when done."""

    def __init__(self, shape, dtype, reader, closer=None):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self._reader = reader
        self._closer = closer

    def read_block(self, slices: Tuple[slice, ...]) -> np.ndarray:
        return np.asarray(self._reader(tuple(slices)))

    def read(self) -> np.ndarray:
        return self.read_block(tuple(slice(None) for _ in self.shape))

    def close(self):
        if self._closer:
            self._closer()
            self._closer = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _open_h5(path: str) -> InputHandle:
    from cytvdn_tpu_torch.io.emd import read_emd

    f, dset = read_emd(path, lazy=True)
    return InputHandle(dset.shape, dset.dtype,
                       lambda sel: dset[sel], f.close)


def _open_dm(path: str) -> InputHandle:
    """Lazy ``.dm3``/``.dm4`` open, 3D and 4D.

    3D (EELS SI): ncempy memmap, the reference's path (mpi.py:97-101).
    4D (4D-STEM): the reference uses a py4DSTEM DM memmap (mpi.py:107-109);
    here py4DSTEM is tried first for fidelity, ncempy's own memmap of the
    4D dataset second, and the built-in dependency-free tag-tree reader
    (``cytvdn_tpu_torch/io/dm.py``) last — all lazy, none loads the cube.
    """
    data = None
    try:
        # py4DSTEM's DM reader knows 4D-STEM scan-shape conventions
        from py4DSTEM.io.filereaders import read_dm

        dc = read_dm(path, mem="MEMMAP")
        data = getattr(dc, "data", dc)
        if getattr(data, "ndim", 0) < 3:
            data = None
    except Exception:
        data = None
    if data is None:
        try:
            from ncempy.io.dm import fileDM
            dmf = fileDM(path)
        except ImportError:
            dmf = None  # built-in reader below
        if dmf is not None:
            # the reference hard-codes dataset index 2 (mpi.py:97-98); DM
            # files differ in thumbnail layout, so scan down from 2 to
            # the first mappable dataset with real rank
            for idx in (2, 1, 0):
                try:
                    cand = dmf.getMemmap(idx)
                except Exception:
                    continue
                if getattr(cand, "ndim", 0) >= 2:
                    data = cand
                    break
            if data is None:
                raise RuntimeError(f"no mappable dataset found in {path}")
    if data is None:
        from cytvdn_tpu_torch.io.dm import read_dm_datasets

        dsets = read_dm_datasets(path)
        # the same index scan as the ncempy branch (thumbnails live at
        # the low indices; the reference's own files put data at 2)
        for idx in (2, 1, 0):
            if idx < len(dsets) and len(dsets[idx].shape) >= 2:
                data = dsets[idx].memmap()
                break
        if data is None:
            raise RuntimeError(f"no mappable dataset found in {path}")
    # squeeze leading singleton dims while retaining the memmap, as the
    # reference does (reference mpi.py:100-101)
    while data.ndim > 1 and data.shape[0] == 1:
        data = data.reshape(data.shape[1:])
    return InputHandle(data.shape, data.dtype, lambda sel: data[sel])


def _open_npy(path: str) -> InputHandle:
    data = np.load(path, mmap_mode="r")
    return InputHandle(data.shape, data.dtype, lambda sel: data[sel])


def open_input(path: str) -> InputHandle:
    """Open any supported input as a lazy handle."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".h5", ".hdf5", ".emd"):
        return _open_h5(path)
    if ext in (".dm3", ".dm4"):
        return _open_dm(path)
    if ext == ".npy":
        return _open_npy(path)
    raise ValueError(f"unsupported input format: {path}")


def load_input(path: str, dtype=np.float32) -> np.ndarray:
    """Load a whole input datacube as a contiguous array of ``dtype``
    (the reference loads float32 contiguous blocks, mpi.py:223-236)."""
    with open_input(path) as h:
        return np.ascontiguousarray(h.read()).astype(dtype, copy=False)
