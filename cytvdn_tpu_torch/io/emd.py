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
does. A multi-process out-of-core run, whose processes hold axis-0 row
ranges, writes through :func:`write_emd_rows_multihost`: rank 0 creates
the file with the datacube's space allocated early, and, where every rank
sees the file, every rank writes its own rows at their raw byte offset
(``os.pwrite``), the boundary pages in a serialized ring (the HDF5 token
ring where the raw span is not usable); where some rank does not see it
(or ``CYTV_NO_SHARED_FS=1``), :func:`write_emd_rows_gathered` streams the
rows to rank 0 in fixed-size chunks. Each collective of the JAX writers is
a ``parallel/halo.py::MeshComm`` collective here, and each write that may
fail on one rank goes through ``MeshComm.together``, so that every rank
raises with it.
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


def _create_structure(fout, shape, dtype, virtual_layout=None,
                      alloc_early=False):
    """Create the EMD v0.7 skeleton (groups, attrs, dim axes) exactly as
    the reference lays it out (reference cyTVDN/mpi.py:449-491); the
    datacube a virtual dataset with ``virtual_layout``.

    ``alloc_early`` allocates the (contiguous) datacube's file space at
    creation, never filled: its raw byte span has an offset before any
    write, which the concurrent row writers need; every byte is then
    written by some rank, and the dataset reads as the default writer's."""
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
    elif alloc_early:
        space = h5py.h5s.create_simple(tuple(shape))
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
        dcpl.set_fill_time(h5py.h5d.FILL_TIME_NEVER)
        did = h5py.h5d.create(dc.id, b"data",
                              h5py.h5t.py_create(np.dtype(dtype), logical=1),
                              space, dcpl)
        dset = h5py.Dataset(did)
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
    ``shape`` (the blocks may differ in shape: balanced row ranges).
    Returns the output's path on every rank.

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
            recon = comm.gather_blocks(t, shape, tuple(slices))
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


_DSET_PATH = "4DSTEM_experiment/data/datacubes/datacube_0/data"


def _raw_row_span(path: str, global_shape, dtype):
    """``(byte_offset, row_bytes)`` of the datacube's contiguous span in
    the file, or None where raw-offset writes cannot be used (a layout
    that is not contiguous, space not yet allocated, a byte order that is
    not the host's). Axis-0 rows of a C-order contiguous dataset are
    contiguous byte ranges, so each rank's rows are one span.
    ``CYTV_NO_RAW_WRITES=1`` turns the raw path off (the ranks then write
    through HDF5 in turns: the same bytes)."""
    if os.environ.get("CYTV_NO_RAW_WRITES"):
        return None
    try:
        with h5py.File(path, "r") as f:
            d = f[_DSET_PATH]
            if tuple(d.shape) != tuple(global_shape):
                return None
            if d.id.get_create_plist().get_layout() != h5py.h5d.CONTIGUOUS:
                return None
            off = d.id.get_offset()
            # numpy's dtype equality knows the byte order: a big-endian
            # file or host takes the HDF5 ring
            if off is None or d.dtype != np.dtype(dtype).newbyteorder("="):
                return None
            return int(off), int(np.prod(global_shape[1:])) * d.dtype.itemsize
    except Exception:
        return None


#: the page size of the raw writer's split between the ranks' concurrent
#: bulk writes and the boundary fragments written in turns: a client of a
#: page-caching filesystem (NFS) writes whole pages back, so two ranks must
#: never write one page at once
_RAW_PAGE = 4096


def _pwrite_span(fd, buf, pos: int) -> None:
    """A positioned write of one byte span, in 1 GiB pieces (Linux caps a
    single ``pwrite`` near 2 GiB)."""
    done = 0
    while done < len(buf):
        done += os.pwrite(fd, buf[done:done + (1 << 30)], pos + done)


def _pwrite_rows(path: str, offset: int, row_bytes: int, rows: np.ndarray,
                 g0: int, dtype):
    """Write the page-aligned interior of the byte span of ``rows``
    (axis-0 rows from the cube's row ``g0``) with positioned writes, which
    take no HDF5 lock: every rank writes its bulk at once, and no two ranks
    write one page. Returns the up to two boundary fragments ``(file
    position, bytes)`` that share a page with a neighbour's rows (or with
    HDF5 metadata), for the ring."""
    data = np.ascontiguousarray(rows, dtype=np.dtype(dtype).newbyteorder("="))
    buf = memoryview(data).cast("B")
    pos0 = offset + g0 * row_bytes
    pos1 = pos0 + len(buf)
    a0 = min(-(-pos0 // _RAW_PAGE) * _RAW_PAGE, pos1)  # up to a page
    a1 = max((pos1 // _RAW_PAGE) * _RAW_PAGE, a0)      # down to a page
    frags = []
    if a0 > pos0:
        frags.append((pos0, bytes(buf[:a0 - pos0])))
    if pos1 > a1:
        frags.append((a1, bytes(buf[a1 - pos0:])))
    if a1 > a0:
        fd = os.open(path, os.O_WRONLY)
        try:
            _pwrite_span(fd, buf[a0 - pos0:a1 - pos0], a0)
        finally:
            os.close(fd)
    return frags


def _pwrite_frags(path: str, frags) -> None:
    """This rank's boundary fragments (its turn in the ring), the file
    opened and closed in the turn, so that a page-caching client sees the
    pages earlier turns wrote."""
    if not frags:
        return
    fd = os.open(path, os.O_WRONLY)
    try:
        for pos, chunk in frags:
            _pwrite_span(fd, memoryview(chunk), pos)
    finally:
        os.close(fd)


def _drop_nonce(path: str) -> None:
    """Remove the visibility probe's token: the finished file keeps the
    reference writer's attributes."""
    with h5py.File(path, "r+") as fout:
        if "cytv_run_nonce" in fout.attrs:
            del fout.attrs["cytv_run_nonce"]


def write_emd_rows_multihost(path: str, global_shape, dtype,
                             rows: np.ndarray, row_range,
                             comm) -> Optional[str]:
    """Every rank of ``comm`` writes its own axis-0 ``rows`` (the cube's
    rows ``row_range = (g0, g1)``) into one EMD file: the reference's
    parallel-HDF5 region writes through MPI-IO (mpi.py:444-498) on
    plain h5py. Every rank calls it.

    Rank 0 creates the file, the datacube contiguous with its space
    allocated early and a fresh nonce in an attribute. Every rank reads
    the nonce back; where some rank does not read rank 0's nonce (its
    filesystem is not shared, or ``CYTV_NO_SHARED_FS=1``), rank 0 removes
    the file and every rank returns None: the caller then gathers
    (:func:`write_emd_rows_gathered`). Else, where every rank finds the
    same raw byte span (:func:`_raw_row_span`), each writes its rows there
    at once (``os.pwrite``) and the page-sharing boundary fragments in
    turns; otherwise the ranks write their rows through HDF5 in turns.
    Either way the file is the one ``write_emd`` writes. Every decision is
    taken in a collective, alike on every rank, and every write goes
    through ``comm.together``. Returns the written path on every rank, or
    None."""
    _require_h5py()
    path = emd_path(path)
    rank = comm.rank
    g0, g1 = int(row_range[0]), int(row_range[1])
    failure = "failed to write its rows of the EMD output"

    def create():
        if rank != 0:
            return
        # a fresh nonce per run: a stale file of the same shape on a rank's
        # own disk must not pass the probe (the rows would be scattered
        # over local files); 48 bits, exact in the float64 vote
        nonce = int.from_bytes(os.urandom(6), "little") | 1
        with h5py.File(path, "w") as fout:
            _create_structure(fout, tuple(global_shape), dtype,
                              alloc_early=True)
            fout.attrs["cytv_run_nonce"] = np.int64(nonce)

    comm.together(create, "failed to create the EMD output")
    observed = 0
    if not os.environ.get("CYTV_NO_SHARED_FS"):
        try:
            with h5py.File(path, "r") as f:
                if tuple(f[_DSET_PATH].shape) == tuple(global_shape):
                    observed = int(f.attrs.get("cytv_run_nonce", 0))
        except Exception:
            observed = 0
    seen = comm.gather_values([observed])[:, 0]
    if seen.min() == 0 or seen.min() != seen.max():
        comm.together(lambda: os.remove(path) if rank == 0 else None,
                      "failed to remove the unshared EMD output")
        return None
    span = _raw_row_span(path, global_shape, dtype)
    offs = comm.gather_values([span[0] if span else -1])[:, 0]
    if offs.min() == offs.max() and offs.min() >= 0:
        frags = comm.together(lambda: _pwrite_rows(
            path, span[0], span[1], rows, g0, dtype), failure)

        def write():
            _pwrite_frags(path, frags)
    else:
        def write():
            with h5py.File(path, "r+") as fout:
                fout[_DSET_PATH][(slice(g0, g1),) + (slice(None),)
                                 * (len(global_shape) - 1)] = rows

    # the boundary fragments, or the rows through HDF5, one rank at a time
    for p in range(comm.world):
        comm.together(lambda: write() if p == rank else None, failure)
    comm.together(lambda: _drop_nonce(path) if rank == 0 else None, failure)
    return path


def write_emd_rows_gathered(path: str, global_shape, dtype,
                            rows: np.ndarray, row_range, chunk_rows: int,
                            comm) -> Optional[str]:
    """The writer for ranks that share no filesystem: every rank's axis-0
    rows go to rank 0 in chunks of ``chunk_rows`` rows of the cube (each
    rank's part of a chunk padded to the chunk's size, so every message has
    one shape), and rank 0 writes each chunk as it comes; no rank holds the
    whole cube. The row ranges are gathered first, so any contiguous
    partition works, uneven ones too. Every rank calls it; returns the
    written path on rank 0 and None on the others. Rank 0's writes go
    through ``comm.together``."""
    import torch

    _require_h5py()
    rank = comm.rank
    g0, g1 = int(row_range[0]), int(row_range[1])
    ranges = comm.gather_values([g0, g1]).astype(np.int64)
    n0, rest = int(global_shape[0]), tuple(global_shape[1:])
    ch = max(1, int(chunk_rows))
    failure = "failed to write the EMD output"
    out = {}

    def create():
        if rank == 0:
            out["file"] = h5py.File(emd_path(path), "w")
            out["dset"] = _create_structure(out["file"], tuple(global_shape),
                                            dtype)

    def close():
        if "file" in out:
            out.pop("file").close()

    comm.together(create, failure)
    try:
        for c0 in range(0, n0, ch):
            c1 = min(c0 + ch, n0)
            senders = [q for q in range(comm.world)
                       if max(c0, ranges[q][0]) < min(c1, ranges[q][1])]
            pad = np.zeros((ch,) + rest, dtype)
            o0, o1 = max(c0, g0), min(c1, g1)
            if o1 > o0:
                pad[o0 - c0:o1 - c0] = rows[o0 - g0:o1 - g0]
            t = torch.from_numpy(pad)
            if comm.backend == "nccl":
                # NCCL moves tensors on the card only
                t = t.cuda()
            got = comm.gather_pieces(t, senders)

            def write():
                if got is None:
                    return
                block = np.zeros((c1 - c0,) + rest, dtype)
                for q, piece in zip(senders, got):
                    a0 = max(c0, ranges[q][0])
                    a1 = min(c1, ranges[q][1])
                    block[a0 - c0:a1 - c0] = \
                        piece.cpu().numpy()[a0 - c0:a1 - c0]
                out["dset"][c0:c1] = block

            comm.together(write, failure)
    finally:
        # every rank reaches the close together (an error above was every
        # rank's)
        close()
    return emd_path(path) if rank == 0 else None


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
