"""Minimal native DigitalMicrograph (.dm3/.dm4) reader + fixture writer.

A copy of ``cytvdn_tpu/io/dm.py`` kept inside the port (importing the JAX
package would import jax): the same parser, and a writer whose files are
byte for byte the JAX writer's.

The reference reads DM files only through optional heavyweight extras —
ncempy's ``fileDM`` memmap for 3D EELS (reference cyTVDN/mpi.py:97-101)
and py4DSTEM's DM memmap for 4D-STEM (mpi.py:107-109). Those stay the
first choices in ``cytvdn_tpu_torch/io/loaders.py`` for fidelity; this module
is the dependency-free fallback so `.dm3`/`.dm4` — the primary microscopy
input format — is readable out of the box.

Scope (the standard uncompressed case every DM-writing tool produces):

- DM3 and DM4 tag trees, big-endian tag metadata, little- or big-endian
  payloads (the header's byteOrder field);
- image data located at ``ImageList/[n]/ImageData/Data`` with its shape
  from the ``Dimensions`` group (x-fastest order → numpy shape is the
  reverse), returned as ``np.memmap`` views — nothing is loaded eagerly,
  matching the reference's memmap semantics;
- datasets are numbered in ImageList order INCLUDING thumbnails, the
  same convention ncempy's ``fileDM.getMemmap`` uses (the reference
  hard-codes dataset index 2, mpi.py:97-98 — the caller's index scan in
  ``loaders._open_dm`` handles files with fewer entries).

The writer exists for fixtures and round-trip tests: it emits a
spec-conformant DM4 (or DM3) file with an optional thumbnail entry so
the dataset-index scan is exercised against real bytes.

Format notes (public structure, as documented by the ncempy / dm3_lib /
HyperSpy readers): header = version i32be, root-length (u32be DM3 /
u64be DM4), byteOrder u32be (1 = little-endian payloads). A tag
directory = sorted u8, closed u8, count (u32be / u64be), then entries.
An entry = kind u8 (20 directory / 21 data), name-length u16be, name
bytes, and for DM4 a u64be byte count of the remainder. A data tag =
b"%%%%", ninfo (u32be / u64be), ninfo info values (i32be / i64be), then
the payload. Info encodings: ``[t]`` scalar of simple type t;
``[20, t, n]`` array; ``[15, 0, nf, (0, t)*nf]`` struct. Simple types:
2 i2, 3 i4, 4 u2, 5 u4, 6 f4, 7 f8, 8 bool/u1, 9 char/i1, 10 i1,
11 i8, 12 u8.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

#: DM simple tag types -> numpy dtype char (endianness applied later)
_TAG_DTYPES = {
    2: "i2", 3: "i4", 4: "u2", 5: "u4", 6: "f4", 7: "f8",
    8: "u1", 9: "i1", 10: "i1", 11: "i8", 12: "u8",
}
_DTYPE_TAGS = {np.dtype(v): k for k, v in _TAG_DTYPES.items()
               if k not in (9, 12)}  # prefer 10 for i1, 5 for u4


class DMDataset:
    """One image entry: lazy ``memmap()`` plus shape/dtype metadata."""

    def __init__(self, path: str, offset: int, dtype: np.dtype,
                 dims: Tuple[int, ...]):
        self.path = path
        self.offset = int(offset)
        self.dtype = np.dtype(dtype)
        #: DM dimension order (x fastest); numpy shape is the reverse
        self.dims = tuple(int(d) for d in dims)
        self.shape = tuple(reversed(self.dims))

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) if self.shape else 0

    def memmap(self) -> np.ndarray:
        return np.memmap(self.path, dtype=self.dtype, mode="r",
                         offset=self.offset, shape=self.shape)


class _Parser:
    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self.buf = f.read()
        if len(self.buf) < 16:
            raise ValueError(f"{path}: too short to be a DM file")
        self.pos = 0
        version = self._be("i", 4)
        if version not in (3, 4):
            raise ValueError(f"{path}: unsupported DM version {version}")
        self.dm4 = version == 4
        self._be("Q" if self.dm4 else "I", 8 if self.dm4 else 4)  # rootlen
        byteorder = self._be("I", 4)
        self.payload_le = byteorder == 1
        self.datasets: List[DMDataset] = []

    def _be(self, fmt: str, size: int):
        v = struct.unpack_from(">" + fmt, self.buf, self.pos)[0]
        self.pos += size
        return v

    def _count(self):
        return self._be("Q" if self.dm4 else "I", 8 if self.dm4 else 4)

    def parse(self) -> List[DMDataset]:
        root = self._read_dir()
        for group in root.get("ImageList", {}).values():
            if not isinstance(group, dict):
                continue
            img = group.get("ImageData")
            if not isinstance(img, dict):
                continue
            data = img.get("Data")
            if not isinstance(data, tuple):
                continue
            offset, dt, n = data
            dims_dir = img.get("Dimensions", {})
            # insertion order IS file order (x fastest first)
            dims = [v for v in dims_dir.values()
                    if isinstance(v, (int, np.integer))]
            if not dims:
                dims = [n]
            if int(np.prod(dims, dtype=np.int64)) != n:
                continue  # corrupt entry: skip rather than mis-shape
            self.datasets.append(DMDataset(self.path, offset, dt, dims))
        return self.datasets

    def _read_dir(self) -> Dict:
        self.pos += 2  # sorted, closed
        n = self._count()
        out: Dict = {}
        for i in range(n):
            kind = self._be("B", 1)
            if kind == 0:  # defensive: explicit end marker
                break
            namelen = self._be("H", 2)
            name = self.buf[self.pos:self.pos + namelen].decode(
                "latin-1") or f"[{i}]"
            self.pos += namelen
            if self.dm4:
                tlen = self._be("Q", 8)
                end = self.pos + tlen
            else:
                end = None
            if kind == 20:
                out[name] = self._read_dir()
            elif kind == 21:
                out[name] = self._read_data(name)
            else:
                if end is None:
                    raise ValueError(
                        f"{self.path}: unknown tag kind {kind}")
                out[name] = None
            if end is not None:
                self.pos = end  # tlen is authoritative in DM4
        return out

    def _read_data(self, name: str):
        """Returns an int/float for scalars, ``(offset, dtype, n)`` for
        arrays, or None for exotic payloads we skip over."""
        if self.buf[self.pos:self.pos + 4] != b"%%%%":
            raise ValueError(f"{self.path}: bad tag marker at {name}")
        self.pos += 4
        ninfo = self._count()
        ifmt = ("q", 8) if self.dm4 else ("i", 4)
        info = [self._be(*ifmt) for _ in range(ninfo)]
        bo = "<" if self.payload_le else ">"
        if len(info) == 1 and info[0] in _TAG_DTYPES:
            dt = np.dtype(bo + _TAG_DTYPES[info[0]])
            v = np.frombuffer(self.buf, dt, count=1, offset=self.pos)[0]
            self.pos += dt.itemsize
            return v.item()
        if len(info) == 3 and info[0] == 20 and info[1] in _TAG_DTYPES:
            dt = np.dtype(bo + _TAG_DTYPES[info[1]])
            n = int(info[2])
            off = self.pos
            self.pos += dt.itemsize * n
            return (off, dt, n)
        # structs / nested arrays / strings: compute the span and skip
        span = _info_span(info)
        if span is None:
            raise ValueError(
                f"{self.path}: unsupported tag encoding {info} at {name}")
        self.pos += span
        return None


def _info_span(info: List[int]) -> Optional[int]:
    """Payload byte length of one info encoding, or None if unknown."""

    def one(i: int) -> Tuple[Optional[int], int]:
        t = info[i]
        if t in _TAG_DTYPES:
            return np.dtype(_TAG_DTYPES[t]).itemsize, i + 1
        if t == 15:  # struct: 15, namelen, nfields, (fnamelen, ftype)*
            nf = info[i + 2]
            total = 0
            j = i + 3
            for _ in range(nf):
                sz, _ = one(j + 1)
                if sz is None:
                    return None, j
                total += sz
                j += 2
            return total, j
        if t == 20:  # array: 20, elem..., n
            elem, j = one(i + 1)
            if elem is None:
                return None, j
            return elem * info[j], j + 1
        if t == 18:  # string: 18, length
            return info[i + 1], i + 2
        return None, i + 1

    span, end = one(0)
    return span if end == len(info) else None


def read_dm_datasets(path: str) -> List[DMDataset]:
    """Parse a .dm3/.dm4 file; returns its image datasets in ImageList
    order (thumbnails included — ncempy's numbering)."""
    return _Parser(path).parse()


# ---------------------------------------------------------------------------
# writer (fixtures / round-trip tests)
# ---------------------------------------------------------------------------


class _Writer:
    def __init__(self, dm4: bool):
        self.dm4 = dm4

    def _count(self, n: int) -> bytes:
        return struct.pack(">Q" if self.dm4 else ">I", n)

    def data_tag(self, name: str, info: List[int], payload: bytes) -> bytes:
        ifmt = ">q" if self.dm4 else ">i"
        body = b"%%%%" + self._count(len(info))
        body += b"".join(struct.pack(ifmt, v) for v in info)
        body += payload
        return self._entry(21, name, body)

    def dir_tag(self, name: str, entries: List[bytes]) -> bytes:
        return self._entry(20, name, self.dir_body(entries))

    def dir_body(self, entries: List[bytes]) -> bytes:
        return b"\x01\x00" + self._count(len(entries)) + b"".join(entries)

    def _entry(self, kind: int, name: str, body: bytes) -> bytes:
        nm = name.encode("latin-1")
        head = struct.pack(">BH", kind, len(nm)) + nm
        if self.dm4:
            head += struct.pack(">Q", len(body))
        return head + body

    def scalar(self, name: str, value: int, t: int = 3) -> bytes:
        dt = np.dtype("<" + _TAG_DTYPES[t])
        return self.data_tag(name, [t], np.asarray([value], dt).tobytes())

    def array(self, name: str, arr: np.ndarray) -> bytes:
        dt = np.dtype(arr.dtype).newbyteorder("<")
        t = _DTYPE_TAGS[np.dtype(arr.dtype).newbyteorder("=")]
        payload = np.ascontiguousarray(arr, dt).tobytes()
        return self.data_tag(name, [20, t, arr.size], payload)

    def image_group(self, arr: np.ndarray) -> bytes:
        # dimension entries and the group itself are UNNAMED, as real
        # acquisition software writes them (the parser indexes them)
        dims = [self.scalar("", d, 5) for d in reversed(arr.shape)]
        img = self.dir_tag("ImageData", [
            self.array("Data", arr.reshape(-1)),
            self.dir_tag("Dimensions", dims),
            self.scalar("DataType", 0, 3),
        ])
        return self.dir_tag("", [img, self.dir_tag("ImageTags", [])])


def write_dm(path: str, data: np.ndarray, version: int = 4,
             thumbnail: bool = True) -> str:
    """Write ``data`` as a minimal spec-conformant .dm3/.dm4 file.

    ``thumbnail=True`` prepends a small 2D entry at dataset index 0 (as
    real acquisition software does), so the data lands at index 1 and
    readers that hard-code an index (the reference uses 2, mpi.py:97-98)
    must scan — exactly what ``loaders._open_dm`` does."""
    if version not in (3, 4):
        raise ValueError("DM version must be 3 or 4")
    w = _Writer(version == 4)
    groups = []
    if thumbnail:
        thumb = np.zeros((4, 4), np.uint8)
        groups.append(w.image_group(thumb))
    groups.append(w.image_group(np.asarray(data)))
    root = w.dir_body([
        w.dir_tag("ImageList", groups),
        w.scalar("InImageMode", 1, 3),
    ])
    header = struct.pack(">i", version)
    header += struct.pack(">Q" if version == 4 else ">I", len(root))
    header += struct.pack(">I", 1)  # little-endian payloads
    with open(path, "wb") as f:
        f.write(header + root)
    return path
