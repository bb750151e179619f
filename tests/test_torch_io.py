"""The port's I/O (``cytvdn_tpu_torch.io``: ``dm``, ``emd``, ``loaders``)
against the JAX package's (``cytvdn_tpu.io``) on the same numpy data made
from a seed: DM files byte for byte, EMD files group for group, and every
input format through both ``open_input``s. The cases of tests/test_dm.py
and tests/test_io_cli.py's single-process I/O tests run on both packages.
"""

import struct

import h5py
import numpy as np
import pytest

from cytvdn_tpu.io import dm as jdm
from cytvdn_tpu.io import emd as jemd
from cytvdn_tpu.io import loaders as jloaders
from cytvdn_tpu_torch import io as tio
from cytvdn_tpu_torch.io import dm as tdm
from cytvdn_tpu_torch.io import emd as temd
from cytvdn_tpu_torch.io import loaders as tloaders

PACKAGES = {"jax": (jdm, jemd, jloaders), "torch": (tdm, temd, tloaders)}


def _data(shape, seed, dtype=np.float32, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(dtype)


# -- DM ----------------------------------------------------------------------

@pytest.mark.parametrize("version", [3, 4])
@pytest.mark.parametrize("dtype", [np.float32, np.uint16, np.float64])
def test_dm_files_identical_and_cross_read(tmp_path, version, dtype):
    """Both writers emit the same bytes; each parser maps the other's file
    back losslessly, thumbnail at index 0 and data at index 1."""
    data = _data((5, 6, 7), 41, scale=100).astype(dtype)
    paths = {}
    for name, (dm, _, _) in PACKAGES.items():
        paths[name] = str(tmp_path / f"{name}.dm{version}")
        assert dm.write_dm(paths[name], data, version=version) == paths[name]
    with open(paths["jax"], "rb") as a, open(paths["torch"], "rb") as b:
        assert a.read() == b.read()
    for reader in (jdm, tdm):
        for path in paths.values():
            dsets = reader.read_dm_datasets(path)
            assert [d.shape for d in dsets] == [(4, 4), data.shape]
            assert dsets[1].dtype.newbyteorder("=") == np.dtype(dtype)
            np.testing.assert_array_equal(dsets[1].memmap(), data)


@pytest.mark.parametrize("thumbnail", [True, False])
@pytest.mark.parametrize("version", [3, 4])
def test_dm_datasets_match(tmp_path, version, thumbnail):
    """The two parsers give the same datasets: offsets, dtypes, dims."""
    data = _data((3, 4, 5, 6), 42)
    path = str(tmp_path / f"c.dm{version}")
    tdm.write_dm(path, data, version=version, thumbnail=thumbnail)
    got = [(d.offset, d.dtype, d.dims, d.shape, d.size)
           for d in tdm.read_dm_datasets(path)]
    want = [(d.offset, d.dtype, d.dims, d.shape, d.size)
            for d in jdm.read_dm_datasets(path)]
    assert got == want


def test_dm_bad_version_refused(tmp_path):
    for dm in (jdm, tdm):
        with pytest.raises(ValueError, match="DM version must be 3 or 4"):
            dm.write_dm(str(tmp_path / "x.dm4"), np.zeros(3), version=5)


@pytest.mark.parametrize("shape", [(6, 8, 10), (3, 4, 5, 6)])
def test_dm_open_input(tmp_path, shape):
    """3D (EELS) and 4D (4D-STEM) .dm4 files through both lazy handles:
    the index scan skips the thumbnail, block reads slice the memmap."""
    data = _data(shape, 43, scale=0.3) + np.float32(1.0)
    p = str(tmp_path / "cube.dm4")
    tdm.write_dm(p, data)
    sel = (slice(1, 3),) + tuple(slice(None) for _ in shape[1:])
    for loaders in (jloaders, tloaders):
        with loaders.open_input(p) as h:
            assert h.shape == shape
            assert h.dtype.newbyteorder("=") == np.float32
            np.testing.assert_array_equal(h.read_block(sel), data[1:3])
            np.testing.assert_array_equal(h.read(), data)
        np.testing.assert_array_equal(loaders.load_input(p), data)


def test_dm_no_thumbnail(tmp_path):
    """Data at index 0 (no thumbnail) still opens: the scan walks down
    from index 2 (the reference hard-codes 2, mpi.py:97-98)."""
    data = _data((4, 5, 6), 44)
    p = str(tmp_path / "flat.dm4")
    tdm.write_dm(p, data, thumbnail=False)
    for loaders in (jloaders, tloaders):
        with loaders.open_input(p) as h:
            assert h.shape == data.shape
            np.testing.assert_array_equal(h.read(), data)


def test_dm_leading_singleton_squeeze(tmp_path):
    """A (1, R, Q1, Q2) acquisition squeezes its leading singleton while
    staying lazy — the reference's reshape at mpi.py:100-101."""
    data = _data((1, 4, 6, 8), 45)
    p = str(tmp_path / "sq.dm4")
    tdm.write_dm(p, data)
    for loaders in (jloaders, tloaders):
        with loaders.open_input(p) as h:
            assert h.shape == (4, 6, 8)
            np.testing.assert_array_equal(h.read(), data[0])


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_dm_garbage_rejected(tmp_path, package):
    """Non-DM bytes fail loudly with the file named."""
    loaders = PACKAGES[package][2]
    p = tmp_path / "junk.dm4"
    p.write_bytes(b"\x00" * 64)
    with pytest.raises(ValueError, match="unsupported DM version"):
        loaders.open_input(str(p))
    short = tmp_path / "short.dm3"
    short.write_bytes(b"\x03")
    with pytest.raises(ValueError, match="too short"):
        loaders.open_input(str(short))


def test_dm_corrupt_dims_skipped(tmp_path):
    """An entry whose Dimensions product disagrees with its Data length is
    skipped by both parsers; the good entry still loads."""
    data = _data((4, 5, 6), 46)
    p = str(tmp_path / "c.dm4")
    tdm.write_dm(p, data)
    raw = bytearray(open(p, "rb").read())
    # the thumbnail's first Dimensions scalar (u4le 4) becomes 7
    pat = np.asarray([4], "<u4").tobytes()
    idx = raw.find(pat, raw.find(b"Dimensions"))
    assert idx > 0
    raw[idx:idx + 4] = struct.pack("<I", 7)
    open(p, "wb").write(bytes(raw))
    for dm in (jdm, tdm):
        shapes = [d.shape for d in dm.read_dm_datasets(p)]
        assert shapes == [data.shape]
    with tloaders.open_input(p) as h:
        np.testing.assert_array_equal(h.read(), data)


# -- EMD ---------------------------------------------------------------------

def _surface(path):
    """Every object of an HDF5 file: name, kind, shape, dtype, attributes
    and, for datasets, the data."""
    out = []

    def visit(name, obj):
        entry = [name, type(obj).__name__,
                 sorted((k, repr(v)) for k, v in obj.attrs.items())]
        if isinstance(obj, h5py.Dataset):
            entry += [obj.shape, obj.dtype.str, obj[...].tobytes()]
        out.append(entry)

    with h5py.File(path, "r") as f:
        f.visititems(visit)
        out.append(["/", "File", sorted((k, repr(v))
                                        for k, v in f.attrs.items())])
    return out


@pytest.mark.parametrize("shape", [(6, 7, 8), (4, 5, 6, 7)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_emd_same_layout(tmp_path, shape, dtype):
    """Both writers lay out the same groups, attributes, dim datasets,
    dtype and data; each package's read_emd reads the other's file."""
    data = _data(shape, 47, dtype)
    paths = {name: emd.write_emd(str(tmp_path / f"{name}.h5"), data)
             for name, (_, emd, _) in PACKAGES.items()}
    assert all(p.endswith(".emd") for p in paths.values())
    assert _surface(paths["jax"]) == _surface(paths["torch"])
    for reader in (jemd, temd):
        for path in paths.values():
            back = reader.read_emd(path)
            assert back.dtype == dtype
            np.testing.assert_array_equal(back, data)


def test_emd_reference_layout(tmp_path):
    """The port's file carries the reference writer's skeleton
    (reference mpi.py:449-491), as tests/test_io_cli.py checks the JAX
    writer's."""
    data = _data((4, 5, 6, 7), 48)
    path = temd.write_emd(str(tmp_path / "out.emd"), data)
    with h5py.File(path, "r") as f:
        top = f["4DSTEM_experiment"]
        assert (top.attrs["emd_group_type"], top.attrs["version_major"],
                top.attrs["version_minor"]) == (2, 0, 7)
        for grp in ("metadata", "data/datacubes", "data/counted_datacubes",
                    "data/diffractionslices", "data/realslices",
                    "data/pointlists", "data/pointlistarrays"):
            assert grp in top
        dc = top["data/datacubes/datacube_0"]
        assert dc.attrs["emd_group_type"] == 1
        assert dc.attrs["metadata"] == -1
        assert dc["dim1"].attrs["name"] == b"R_x"
        assert dc["dim4"].attrs["units"] == b"[pix]"
        np.testing.assert_array_equal(dc["dim2"][...], np.arange(5))


def test_emd_regions_same_layout(tmp_path):
    data = _data((8, 6, 4, 4), 49)
    regions = [
        ((slice(0, 4), slice(None), slice(None), slice(None)), data[:4]),
        ((slice(4, 8), slice(None), slice(None), slice(None)), data[4:]),
    ]
    paths = {name: emd.write_emd_regions(str(tmp_path / f"{name}"),
                                         data.shape, data.dtype, regions)
             for name, (_, emd, _) in PACKAGES.items()}
    assert _surface(paths["jax"]) == _surface(paths["torch"])
    np.testing.assert_array_equal(temd.read_emd(paths["jax"]), data)


@pytest.mark.parametrize("path", ["out.emd", "out.h5", "dir.x/out", "out"])
def test_emd_path(path):
    assert temd.emd_path(path) == jemd.emd_path(path)


def test_emd_read_fallback_and_missing(tmp_path):
    """A file without the EMD datacube path falls back to the first
    dataset named "data"; one without any raises the same ValueError."""
    data = _data((3, 4, 5), 50)
    other = str(tmp_path / "other.h5")
    with h5py.File(other, "w") as f:
        f.create_dataset("grp/data", data=data)
    np.testing.assert_array_equal(temd.read_emd(other), jemd.read_emd(other))
    empty = str(tmp_path / "empty.h5")
    with h5py.File(empty, "w") as f:
        f.create_dataset("grp/other", data=data)
    for emd in (jemd, temd):
        with pytest.raises(ValueError, match="no datacube dataset"):
            emd.read_emd(empty)


def test_emd_needs_h5py(tmp_path, monkeypatch):
    monkeypatch.setattr(temd, "h5py", None)
    with pytest.raises(RuntimeError, match="h5py is required"):
        temd.write_emd(str(tmp_path / "x.emd"), np.zeros((2, 2, 2)))
    with pytest.raises(RuntimeError, match="h5py is required"):
        temd.read_emd(str(tmp_path / "x.emd"))


# -- loaders -----------------------------------------------------------------

def _write(fmt, tmp_path, data):
    path = str(tmp_path / f"cube.{fmt}")
    if fmt == "npy":
        np.save(path, data)
    elif fmt == "dm4":
        tdm.write_dm(path, data)
    else:
        temd.write_emd(path, data)
    return path


@pytest.mark.parametrize("fmt", ["npy", "dm4", "emd"])
@pytest.mark.parametrize("shape", [(6, 7, 8), (4, 4, 5, 6)])
def test_open_input_matches(tmp_path, fmt, shape):
    """Both open_inputs give the same shape, dtype and block reads for
    each format, 3D and 4D; load_input converts to the asked dtype."""
    data = _data(shape, 51)
    path = _write(fmt, tmp_path, data)
    sel = (slice(1, 3), slice(None), slice(2, 5)) + \
        tuple(slice(None) for _ in shape[3:])
    with tloaders.open_input(path) as got, jloaders.open_input(path) as want:
        assert got.shape == want.shape == shape
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.read_block(sel), data[sel])
        np.testing.assert_array_equal(got.read_block(sel),
                                      want.read_block(sel))
    for dtype in (np.float32, np.float64):
        got = tio.load_input(path, dtype=dtype)
        want = jloaders.load_input(path, dtype=dtype)
        assert got.dtype == want.dtype == dtype and got.flags.c_contiguous
        np.testing.assert_array_equal(got, want)


def test_open_input_unsupported(tmp_path):
    for loaders in (jloaders, tloaders):
        with pytest.raises(ValueError, match="unsupported input format"):
            loaders.open_input(str(tmp_path / "cube.tif"))


def test_input_handle_closes(tmp_path):
    """The .emd handle owns its file: closing it closes the file once."""
    path = _write("emd", tmp_path, _data((3, 4, 5), 52))
    h = tloaders.open_input(path)
    h.close()
    h.close()
    with h5py.File(path, "r+"):  # not held open any more
        pass


def test_io_exports():
    import cytvdn_tpu.io as jio

    assert tio.__all__ == jio.__all__
