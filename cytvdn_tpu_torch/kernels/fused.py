"""One whole TV iteration: the CUDA kernel and its plain PyTorch version.

Replaces the TPU kernel ``cytvdn_tpu/kernels/fused.py::fused_iteration``
(one Pallas pass per iteration). On the H100 the iteration is bound by HBM
bytes: a few flops per element against the state's reads and writes. The
kernel (``csrc/fused_iteration.cu``) updates the state in place in two
launches — a dual pass that writes every axis's ``b`` and ``d`` and reads
only the old ``recon``, then a reconstruction pass that reads the new ``b``
and rewrites ``recon`` element by element — because concurrent blocks
updating one pass in place would race on tile faces and a second copy of
the state does not fit (10 × 4.29 GB for the 256²×128² FISTA cube). That
costs 5n+4 cube traversals per FISTA iteration against the one-pass floor
of 4n+3 (``utils/perf.py``); fusing the passes is later work. The three
sums are per-block partials combined in a fixed order on the device, so
traces repeat exactly from run to run.

With ``halos`` the cube is one block of a larger cube: an axis-0 slab of
an out-of-core run (``solver/outofcore.py``) or a shard of a mesh
(``parallel/``). Seam operands stand in for the edges of the halo axes —
axes 0 and 1 always, axes 2 and 3 where given — with the TPU kernel's
operand set and meaning (``cytvdn_tpu/kernels/fused.py:316-356,
:890-897``): the -1 neighbour's last recon slab for the backward
difference, the +1 neighbour's pre-update first slabs from which its first
updated accumulator slab is recomputed for the forward difference, the
partner accumulator and the diagonal neighbour's corner of a split
half-isotropic pair (the joint projection), and per-axis ``edge_next``
flags for mirror boundaries (the shard holding the trailing edge reads its
own updated last slab). A cube cut into blocks, each run with halos taken
from the pre-update state and put back together, is bitwise one iteration
of the whole cube; its sums add up in block order. The kernel's ``HALO``
instantiation computes each +1 neighbour's first updated accumulator slab
in the dual pass and leaves it in a scratch slab for the reconstruction
pass.

Float32 launches take the kernel's vector walk (``tv_fused_walk_f32``:
four elements of the last axis per thread, 128-bit accesses, every load of
a work item before its first store, b before d, b and d stored
evict-first; work items ordered so that an element's axis-0 neighbour is
still in L2 when it is read again; each pass on at most
:data:`WALK_PER_SM` blocks per SM that fit on the card at once) without
halos, and with halos where the launch is Jia-Zhao and anisotropic and
every halo axis is 0 or 1 (:func:`takes_walk`): every out-of-core slab,
and every step of an axis-0, axis-1 or 2D-grid mesh that does not pair.
The walk's items then read the seam slabs at their edges and recompute
the +1 neighbour's first b slab beside their stores. Float64 launches,
and launches with halos on axes 2 and 3, periodic or mirror boundaries
or iso pairs, take the scalar passes (``tv_fused_iteration_f32``/
``_f64``).

:func:`fused_iteration` launches the kernel for CUDA tensors and runs
:func:`fused_iteration_reference` — built from ``ops/stencil.py`` in the
order the JAX engine uses — for CPU tensors. There is no fallback: a CUDA
tensor reaches the kernel or an exception.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from cytvdn_tpu_torch import ops
from cytvdn_tpu_torch.config import BCMode
from cytvdn_tpu_torch.kernels import build

Tensor = torch.Tensor

#: grid size cap of both passes (blocks of 32×8 threads stride over the
#: cube's (row, tile) work items); fixed, so the order of the per-block
#: partial sums depends on the shape alone (and, for the walk, on the
#: mode and the device: :func:`walk_grid`)
MAX_BLOCKS = 2048
_TX, _TY = 32, 8
#: elements of a walk thread along the last axis
_VW = 4
#: blocks per SM of each walk pass at most: more blocks in flight than
#: this ran slower at 256²×128² FISTA on an H100 (PERF.md §6)
WALK_PER_SM = 2
#: the walk's grids per (device, ndim, fista, iso, lossy, halo), read once
#: from the device's occupancy (each instantiation has its own registers)
_WALK_GRID: Dict[Tuple[int, int, bool, bool, bool, bool],
                 Tuple[int, int]] = {}


def fused_supported(shape, dtype, bc, isotropic_R=False, isotropic_Q=False,
                    halo_axes=()) -> bool:
    """Whether the kernel covers this configuration; ``halo_axes``: the
    axes whose edges come from operand halos (their extent may be 1)."""
    if dtype not in (torch.float32, torch.float64):
        return False
    if len(shape) not in (3, 4) or min(shape) < 1:
        return False
    if BCMode(bc) == BCMode.MIRROR and min(
            (e for ax, e in enumerate(shape) if ax not in halo_axes),
            default=2) < 2:
        return False  # the mirror's backward edge reads a_1
    if isotropic_R or isotropic_Q:
        # half-isotropic pairs: 4D, Jia-Zhao only (reference
        # halfisotropic.pyx:70-82)
        if len(shape) != 4 or BCMode(bc) != BCMode.JIA_ZHAO:
            return False
    return True


def walk_rows(shape: Tuple[int, ...]) -> int:
    """The rows of a cube: the product of its leading ndim-2 extents."""
    rows = 1
    for n in shape[:-2]:
        rows *= n
    return rows


def _work_items(shape: Tuple[int, ...]) -> int:
    """The scalar passes' (row, tile) work items: the leading axes
    flattened into rows, times the 8×32 tiles of the two trailing axes."""
    return walk_rows(shape) * (-(-shape[-2] // _TY)) * (-(-shape[-1] // _TX))


#: the halo axes whose seams the walk takes: the row axes in 4D, axis 0
#: and the tiled axis 1 in 3D
WALK_HALO_AXES = (0, 1)


def takes_walk(dtype, halos=None, bc=BCMode.JIA_ZHAO, iso=False) -> bool:
    """Whether a CUDA launch takes the vector walk and not the scalar
    passes: float32, and with ``halos`` only Jia-Zhao anisotropic launches
    (``iso``: a half-isotropic pair) whose halo axes all lie in
    :data:`WALK_HALO_AXES`."""
    if dtype != torch.float32:
        return False
    return halos is None or (
        BCMode(bc) == BCMode.JIA_ZHAO and not iso
        and set(halo_axes(halos)) <= set(WALK_HALO_AXES))


def walk_tiles(shape: Tuple[int, ...]) -> Tuple[int, int, int]:
    """The walk's tiling of the two trailing axes
    (``csrc/vec_walk.cuh::set_tiles``): ``(lw, tiles_m, tiles_l)``, lw the
    lanes of a row segment (the least power of two, at most 32, whose four
    elements each cover the last extent), tiles of 256 / lw rows along
    axis ndim-2 and of 4 lw elements along the last axis."""
    m, last = shape[-2], shape[-1]
    lw = 1
    while lw < 32 and _VW * lw < last:
        lw *= 2
    return lw, -(-m // (_TX * _TY // lw)), -(-last // (_VW * lw))


def _walk_items(shape: Tuple[int, ...]) -> int:
    """The walk's (row, tile) work items: the leading axes flattened into
    rows, times :func:`walk_tiles`' tiles of one row."""
    _, tm, tl = walk_tiles(shape)
    return walk_rows(shape) * tm * tl


def walk_band(shape: Tuple[int, ...]) -> int:
    """The default band of the walk's item order: the axis-1 indices per
    band (4D), so that an element's axis-0 neighbour is that many work
    items away; 1 in 3D, where rows are axis 0 alone."""
    return shape[1] if len(shape) == 4 else 1


def launch_items(shape: Tuple[int, ...], dtype, halos, bc=BCMode.JIA_ZHAO,
                 iso=False) -> Tuple[bool, int]:
    """``(walk, work items)`` of a CUDA launch: whether it takes the vector
    walk (:func:`takes_walk`), and its work items in that entry's tiling.
    Raises at 2**31 work items or more (the kernels' 32-bit index
    arithmetic)."""
    walk = takes_walk(dtype, halos, bc, iso)
    work = _walk_items(shape) if walk else _work_items(shape)
    if work >= 2**31:
        raise ValueError(f"shape {tuple(shape)}: {work} work items; the "
                         "kernel's 32-bit index arithmetic takes < 2**31")
    return walk, work


def walk_grid(device: torch.device, ndim: int, fista: bool, iso: bool,
              lossy: bool, halo: bool = False) -> Tuple[int, int]:
    """Blocks of the walk's dual and recon passes on ``device``: per pass,
    the blocks per SM that fit on the card at once (that instantiation's
    registers), at most :data:`WALK_PER_SM`, times SMs."""
    key = (device.index if device.index is not None
           else torch.cuda.current_device(), ndim, fista, iso, lossy, halo)
    if key not in _WALK_GRID:
        lib = build.load()
        occ = [ctypes.c_int(0) for _ in range(3)]
        with torch.cuda.device(key[0]):
            build.check(lib.tv_walk_occupancy(
                ndim, int(fista), int(iso), int(lossy), int(halo),
                *(ctypes.byref(c) for c in occ)))
        dual, recon, sms = (c.value for c in occ)
        _WALK_GRID[key] = (min(dual, WALK_PER_SM) * sms,
                           min(recon, WALK_PER_SM) * sms)
    return _WALK_GRID[key]


# The seam operands of one halo axis A are ``prevA``, ``nextA_recon``,
# ``nextA_acc`` and, under FISTA, ``nextA_d`` (:func:`halo_keys`); axes 0
# and 1 always take them, axes 2 and 3 where split. A split axis ``s`` of a
# half-isotropic pair with partner ``o`` also takes ``next{s}_acc{o}`` (the
# +1 neighbour's first slab of its partner-axis accumulator) and, where
# ``o`` is split too, ``corner{s}`` (the diagonal neighbour's recon, axes
# ``s`` and ``o`` collapsed to 1).

#: the pointer table's fields, four axes each, in the order of
#: ``csrc/tv_elem.cuh::Halos``
_TABLE = ("prev", "next_recon", "next_acc", "next_d", "next_accp", "corner",
          "bhat")


def halo_keys(ax: int, fista: bool) -> Tuple[str, ...]:
    """The seam operands of halo axis ``ax``."""
    keys = (f"prev{ax}", f"next{ax}_recon", f"next{ax}_acc")
    return keys + ((f"next{ax}_d",) if fista else ())


def halo_axes(halos) -> Tuple[int, ...]:
    """The axes a halo dict gives seams for: those with a ``prevA``."""
    return tuple(ax for ax in range(4) if f"prev{ax}" in halos)


def iso_partners(ndim: int, iso_r: bool, iso_q: bool):
    """``{axis: partner}`` of the half-isotropic pairs."""
    pairs = ([(0, 1)] if iso_r else []) + ([(2, 3)] if iso_q else [])
    return {p: q for pr in pairs for p, q in (pr, pr[::-1]) if ndim == 4}


def _check_halos(halos, orig: Tensor, fista: bool, bc: int, iso_r: bool,
                 iso_q: bool, edge_next=None) -> Tuple[int, ...]:
    """Check the seam operands (the TPU kernel's set, ``cytvdn_tpu/kernels/
    fused.py:890-897``): every halo axis's slabs, each like ``orig`` with
    the axis collapsed to 1, axes 0 and 1 among them; a half-isotropic
    pair's partner slabs and corners only on a halo axis of an iso pair;
    ``edge_next`` one flag per axis. Returns the halo axes."""
    ndim = orig.dim()
    axes = halo_axes(halos)
    if 0 not in axes or 1 not in axes:
        raise ValueError("halos need the seams of axes 0 and 1 (prev0, "
                         "prev1, ...)")
    partner = iso_partners(ndim, iso_r, iso_q)
    want = {}
    for ax in axes:
        if ax >= ndim:
            raise ValueError(f"halos: axis {ax} of a {ndim}D cube")
        for key in halo_keys(ax, fista):
            want[key] = (ax,)
        o = partner.get(ax)
        if o is not None and f"next{ax}_acc{o}" in halos:
            want[f"next{ax}_acc{o}"] = (ax,)
            if f"corner{ax}" in halos:
                if o not in axes:
                    raise ValueError(f"halos[corner{ax}]: the partner axis "
                                     f"{o} has no halos")
                want[f"corner{ax}"] = (ax, o)
    extra = sorted(set(halos) - set(want))
    if extra:
        raise ValueError(f"halos: unexpected operands {extra} (halo axes "
                         f"{axes}, fista {fista}, iso ({iso_r}, {iso_q}))")
    for key, collapsed in want.items():
        t = halos.get(key)
        if t is None:
            raise ValueError(f"halos[{key!r}] is missing")
        shape = [1 if ax in collapsed else e
                 for ax, e in enumerate(orig.shape)]
        if t.device != orig.device or t.dtype != orig.dtype \
                or list(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"halos[{key!r}]: expected a contiguous "
                             f"{orig.dtype} tensor of shape {tuple(shape)} "
                             f"on {orig.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if edge_next is not None and len(edge_next) != ndim:
        raise ValueError(f"edge_next: one flag per axis ({ndim}), got "
                         f"{len(edge_next)}")
    return axes


def _edge_bits(edge_next, ndim: int) -> int:
    """``edge_next`` as a bit mask (bit A: the block holds the cube's
    trailing edge of axis A); None: every axis (one device)."""
    if edge_next is None:
        return (1 << ndim) - 1
    return sum(1 << ax for ax, f in enumerate(edge_next) if float(f) > 0)


def _seam_b(halos, recon: Tensor, rho, lambda_inv: Tensor, ax: int,
            fista: bool, partner: Optional[int]) -> Tensor:
    """The +1 neighbour's first updated accumulator slab along ``ax``,
    recomputed from its pre-update slabs with its own arithmetic: the
    accumulator update of that one slab, whose backward neighbour is this
    cube's last slab. With the partner slab ``next{ax}_acc{partner}`` it is
    the ``ax`` component of the pair's joint projection; the partner's
    backward difference at the slab's leading index reads
    ``corner{ax}`` (the partner axis split) or is Jia-Zhao's zero."""
    own_last = recon.narrow(ax, recon.shape[ax] - 1, 1)
    nr, na = halos[f"next{ax}_recon"], halos[f"next{ax}_acc"]
    accp = halos.get(f"next{ax}_acc{partner}") if partner is not None \
        else None
    if accp is None:
        bc = BCMode.JIA_ZHAO
        if fista:
            return ops.accumulator_update_fista(
                nr, na, halos[f"next{ax}_d"], rho, ax, lambda_inv[ax], bc,
                halo_prev=own_last)[0]
        return ops.accumulator_update(nr, na, ax, lambda_inv[ax], bc,
                                      halo_prev=own_last)[0]
    lo, hi = sorted((ax, partner))
    prev = {ax: own_last, partner: halos.get(f"corner{ax}")}
    b = {ax: na, partner: accp}
    if fista:
        # the partner's shadow dual moves only the partner's component,
        # which is dropped
        d = {ax: halos[f"next{ax}_d"], partner: torch.zeros_like(accp)}
        out = ops.iso_accumulator_update_fista(
            nr, b[lo], b[hi], d[lo], d[hi], rho, lo, hi, lambda_inv[lo],
            prev[lo], prev[hi])
    else:
        out = ops.iso_accumulator_update(nr, b[lo], b[hi], lo, hi,
                                         lambda_inv[lo], prev[lo], prev[hi])
    return out[0] if ax == lo else out[1]


def fused_iteration_reference(
    orig: Tensor,
    recon: Tensor,
    accs: Sequence[Tensor],
    ds: Optional[Sequence[Tensor]],
    rho: Optional[Tensor],
    lambda_inv: Tensor,
    lam_mu: Tensor,
    *,
    fista: bool,
    bc: int = 2,
    iso_r: bool = False,
    iso_q: bool = False,
    halos=None,
    edge_next=None,
    scratch=None,
):
    """The plain version of :func:`fused_iteration`, on any device.

    Per-axis dual updates in the JAX engine's order
    (``cytvdn_tpu/solver/engine.py::_accumulator_phase``), then the
    reconstruction update. Each axis's new ``b``/``d`` is copied into the
    caller's tensors as soon as it is computed (it reads only ``recon`` and
    its own axis), and ``recon`` after the reconstruction update: the same
    in-place contract as the kernel. With ``halos``, the backward
    differences of each halo axis take its ``prev`` slab at the leading
    edge, and the forward differences at the trailing edge the +1
    neighbour's first updated accumulator slab (:func:`_seam_b`), computed
    before ``recon`` changes — except under mirror boundaries on an axis
    whose ``edge_next`` flag is set, which reads the own updated last slab.
    ``scratch`` is the kernel's; the plain version takes and ignores it.
    Bfloat16 ``ds`` (lossy duals) are read widened, and the new ``d``
    rounds to nearest even in its ``copy_``.
    """
    bc = BCMode(bc)
    ndim = orig.dim()
    axes = _check_halos(halos, orig, fista, bc, iso_r, iso_q, edge_next) \
        if halos is not None else ()
    prev = [halos[f"prev{ax}"] if ax in axes else None for ax in range(ndim)]
    bnorm = torch.zeros((), dtype=orig.dtype, device=orig.device)

    def aniso(ax):
        if fista:
            b, d, n = ops.accumulator_update_fista(
                recon, accs[ax], ds[ax], rho, ax, lambda_inv[ax], bc,
                halo_prev=prev[ax])
            ds[ax].copy_(d)
        else:
            b, n = ops.accumulator_update(recon, accs[ax], ax, lambda_inv[ax],
                                          bc, halo_prev=prev[ax])
        accs[ax].copy_(b)
        return n

    def iso(ax1, ax2):
        # the pair shares one clip radius (reference cyTVDN.py:160-162)
        if fista:
            b1, b2, d1, d2, n = ops.iso_accumulator_update_fista(
                recon, accs[ax1], accs[ax2], ds[ax1], ds[ax2], rho,
                ax1, ax2, lambda_inv[ax1], prev[ax1], prev[ax2])
            ds[ax1].copy_(d1)
            ds[ax2].copy_(d2)
        else:
            b1, b2, n = ops.iso_accumulator_update(
                recon, accs[ax1], accs[ax2], ax1, ax2, lambda_inv[ax1],
                prev[ax1], prev[ax2])
        accs[ax1].copy_(b1)
        accs[ax2].copy_(b2)
        return n

    if ndim == 4:
        norms = [iso(0, 1)] if iso_r else [aniso(0), aniso(1)]
        norms += [iso(2, 3)] if iso_q else [aniso(2), aniso(3)]
    else:
        norms = [aniso(ax) for ax in range(3)]
    for n in norms:
        bnorm = bnorm + n
    partner = iso_partners(ndim, iso_r, iso_q)
    edge = _edge_bits(edge_next, ndim)
    nxt = [None] * ndim
    for ax in axes:
        if bc == BCMode.MIRROR and edge >> ax & 1:
            continue  # the corrected mirror's own last slab
        nxt[ax] = _seam_b(halos, recon, rho, lambda_inv, ax, fista,
                          partner.get(ax))
    recon_new, dnum, dden = ops.datacube_update(orig, recon, accs, lam_mu, bc,
                                                halos_next=nxt)
    recon.copy_(recon_new)
    return recon, accs, ds, bnorm, dnum, dden


def _check(t: Tensor, like: Tensor, name: str, dtype=None) -> None:
    """``t`` is contiguous, of ``like``'s shape and device, and of its
    dtype (or of ``dtype``)."""
    dtype = like.dtype if dtype is None else dtype
    if t.device != like.device or t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype} on {like.device}, "
                         f"got {t.dtype} on {t.device}")
    if t.shape != like.shape:
        raise ValueError(f"{name}: expected shape {tuple(like.shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_state(orig: Tensor, recon: Tensor, accs, ds, fista: bool,
                 lossy_ok: bool = False) -> bool:
    """The state a kernel updates in place: one accumulator (and one shadow
    dual under FISTA) per axis, each like ``orig``; with ``lossy_ok`` (the
    K=1, pair and K-step kernels) the shadow duals of float32 data may all
    be bfloat16 (lossy duals). Returns whether they are."""
    ndim = orig.dim()
    if len(accs) != ndim or (fista and (ds is None or len(ds) != ndim)):
        raise ValueError("need one accumulator (and one shadow dual under "
                         "FISTA) per axis")
    _check(orig, orig, "orig")
    _check(recon, orig, "recon")
    # the whole-run kernel refuses a bfloat16 d: its JAX gate keeps lossy
    # runs off it
    lossy = bool(lossy_ok and fista and orig.dtype == torch.float32
                 and ds[0].dtype == torch.bfloat16)
    for k in range(ndim):
        _check(accs[k], orig, f"accs[{k}]")
        if fista:
            _check(ds[k], orig, f"ds[{k}]",
                   torch.bfloat16 if lossy else None)
    return lossy


def _launch_args(orig: Tensor, accs, ds, scalars):
    """Checks a CUDA launch's scalars (``(name, tensor, count)``: contiguous,
    of the data's dtype, on its device) and returns the per-axis state
    pointers padded to four axes (``ds`` None: no shadow duals), the
    extents padded with 1 and the current stream."""
    for name, t, n in scalars:
        if t is None or t.device != orig.device or t.dtype != orig.dtype \
                or t.numel() != n or not t.is_contiguous():
            raise ValueError(f"{name}: expected {n} contiguous {orig.dtype} "
                             f"value(s) on {orig.device}")

    def pad4(xs):
        return list(xs) + [None] * (4 - len(xs))

    bs = pad4([a.data_ptr() for a in accs])
    dd = pad4([d.data_ptr() for d in ds] if ds is not None else [])
    dims = list(orig.shape) + [1] * (4 - orig.dim())
    return bs, dd, dims, torch.cuda.current_stream(orig.device).cuda_stream


def seam_scratch(halos) -> Dict[int, Tensor]:
    """The kernel's scratch slabs for a halo dict: per halo axis, one slab
    like ``next{A}_recon`` that the dual pass fills with the +1
    neighbour's recomputed first accumulator slab."""
    return {ax: torch.empty_like(halos[f"next{ax}_recon"])
            for ax in halo_axes(halos)}


def _halo_table(halos, scratch, fista: bool, ndim: int, iso_r: bool,
                iso_q: bool):
    """The kernel's seam pointer table (``csrc/fused_iteration.cu::launch``):
    :data:`_TABLE`'s fields for axes 0 to 3, null where an axis has no
    halos or a field no operand."""
    axes = halo_axes(halos)
    partner = iso_partners(ndim, iso_r, iso_q)
    ptrs = []
    for field in _TABLE:
        for ax in range(4):
            if ax not in axes or (field == "next_d" and not fista):
                t = None
            elif field == "bhat":
                _check(scratch[ax], halos[f"next{ax}_recon"],
                       f"scratch[{ax}]")
                t = scratch[ax]
            elif field == "next_accp":
                t = halos.get(f"next{ax}_acc{partner.get(ax)}")
            elif field == "corner":
                t = halos.get(f"corner{ax}")
            else:
                t = halos[f"{field[:4]}{ax}{field[4:]}"]
            ptrs.append(t.data_ptr() if t is not None else None)
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def fused_iteration(
    orig: Tensor,
    recon: Tensor,
    accs: Sequence[Tensor],
    ds: Optional[Sequence[Tensor]],
    rho: Optional[Tensor],
    lambda_inv: Tensor,
    lam_mu: Tensor,
    *,
    fista: bool,
    bc: int = 2,
    iso_r: bool = False,
    iso_q: bool = False,
    halos=None,
    edge_next=None,
    scratch=None,
    band: Optional[int] = None,
    grid: Union[int, Tuple[int, int], None] = None,
):
    """One full TV iteration, updating ``recon``, ``accs`` and ``ds`` in
    place.

    ``rho`` is the FISTA momentum ratio as a 0-d tensor on the data's
    device (ignored when ``fista`` is false); ``lambda_inv`` and ``lam_mu``
    are per-axis tensors there too. ``bc``: 0 periodic, 1 mirror,
    2 Jia-Zhao; ``iso_r``/``iso_q`` jointly project the (0,1)/(2,3) pairs
    (4D, Jia-Zhao only).

    ``halos`` makes the cube one block of a larger one: per halo axis A
    (0 and 1, and 2 or 3 where given; see :func:`halo_keys`) ``prevA``,
    the -1 neighbour's pre-update last recon slab, and
    ``nextA_recon``/``nextA_acc``[/``nextA_d``], the +1 neighbour's
    pre-update first slabs, each like the cube with axis A collapsed to 1;
    a split axis ``s`` of a half-isotropic pair with partner ``o`` adds
    ``next{s}_acc{o}`` and, where ``o`` is split too, ``corner{s}`` (axes
    ``s`` and ``o`` collapsed). A global edge is given by values: Jia-Zhao
    the own edge slab as ``prev`` and the own last slab with zero
    ``acc``/``d`` as ``next``; mirror the own slab 1 as ``prev``; periodic
    the ring neighbours' slabs. ``edge_next`` (mirror): one flag per axis,
    set where the block holds the cube's trailing edge, which then reads
    its own updated last slab (default: every axis, as on one device).
    ``scratch``: ``{axis: slab}`` like ``nextA_recon`` for the kernel's
    recomputed slabs (default: allocated per call).

    ``band`` and ``grid`` (launches on the card that take the vector walk,
    :func:`takes_walk`): the item order's axis-1 indices per band,
    1 to N1 in 4D and 1 in 3D (default :func:`walk_band`), and the blocks
    of both passes, or a ``(dual, recon)`` pair (default
    :func:`walk_grid`'s, capped by :data:`MAX_BLOCKS` and the work items).
    The state does not depend on them; the sums' order does.

    Returns ``(recon, accs, ds, bnorm, delta_num, recon_norm)`` — the state
    objects passed in, and the three sums as 0-d tensors of the data type.
    ``fused_iteration.launches`` counts the kernel launches,
    ``fused_iteration.halo_launches`` those of them with halos,
    ``fused_iteration.mode_launches`` those with a mesh-only mode (a halo
    axis above 1, periodic or mirror boundaries, or iso pairs with halos),
    ``fused_iteration.lossy_launches`` those with bfloat16 shadow duals,
    ``fused_iteration.walk_launches`` those through the vector walk (with
    halos or without);
    ``fused_iteration.calls`` counts every call that passed the checks, on
    the CPU too.

    Lossy duals: with float32 data under FISTA, ``ds`` may be bfloat16
    (Jia-Zhao, anisotropic). The old ``d`` widens exactly, the arithmetic
    stays float32 and the new ``d`` is stored rounded to nearest even (the
    kernel's ``LOSSY`` instantiation; the plain version's ``copy_`` into
    the bfloat16 tensor). The seam operand ``nextA_d`` stays float32.
    """
    ndim = orig.dim()
    axes = halo_axes(halos) if halos is not None else ()
    if not fused_supported(tuple(orig.shape), orig.dtype, bc, iso_r, iso_q,
                           axes):
        raise ValueError(
            f"fused_iteration does not cover shape {tuple(orig.shape)}, "
            f"dtype {orig.dtype}, bc {int(bc)}, iso ({iso_r}, {iso_q})")
    lossy = _check_state(orig, recon, accs, ds, fista, lossy_ok=True)
    if lossy and (BCMode(bc) != BCMode.JIA_ZHAO or iso_r or iso_q):
        raise ValueError("bfloat16 shadow duals (lossy duals) cover Jia-Zhao "
                         "anisotropic launches only")
    if halos is not None:
        _check_halos(halos, orig, fista, bc, iso_r, iso_q, edge_next)
    iso = ndim == 4 and (iso_r or iso_q)
    walk = takes_walk(orig.dtype, halos, bc, iso)
    if not walk and (band is not None or grid is not None):
        raise ValueError("band and grid set the vector walk's launch: "
                         "float32, with halos only Jia-Zhao anisotropic on "
                         "axes 0 and 1")
    most = orig.shape[1] if ndim == 4 else 1
    if band is not None and not 1 <= band <= most:
        raise ValueError(f"band: 1 to {most} axis-1 indices, got {band}")
    if grid is not None:
        grid = (grid, grid) if isinstance(grid, int) else tuple(grid)
        if len(grid) != 2 or min(grid) < 1:
            raise ValueError(f"grid: at least one block per pass, got "
                             f"{grid}")
    if orig.device.type == "cpu":
        fused_iteration.calls += 1
        return fused_iteration_reference(
            orig, recon, accs, ds, rho, lambda_inv, lam_mu,
            fista=fista, bc=bc, iso_r=iso_r, iso_q=iso_q, halos=halos,
            edge_next=edge_next)
    if orig.device.type != "cuda":
        raise ValueError(f"fused_iteration runs on CUDA or CPU tensors, "
                         f"not {orig.device}")
    scalars = [("lambda_inv", lambda_inv, ndim), ("lam_mu", lam_mu, ndim)]
    if fista:
        scalars.append(("rho", rho, 1))
    bs, dd, dims, stream = _launch_args(orig, accs, ds if fista else None,
                                        scalars)
    lib = build.load()
    walk, work = launch_items(tuple(orig.shape), orig.dtype, halos, bc, iso)
    table = None
    if halos is not None:
        if scratch is None:
            scratch = seam_scratch(halos)
        table = _halo_table(halos, scratch, fista, ndim, iso_r, iso_q)
    if walk:
        blocks = grid if grid is not None else tuple(
            min(work, MAX_BLOCKS, g)
            for g in walk_grid(orig.device, ndim, fista, iso, lossy,
                               halos is not None))
        partials = torch.empty(blocks[0] + 2 * blocks[1],
                               dtype=torch.float64, device=orig.device)
        out = torch.empty(3, dtype=orig.dtype, device=orig.device)
        err = lib.tv_fused_walk_f32(
            orig.data_ptr(), recon.data_ptr(), *bs, *dd,
            lambda_inv.data_ptr(), lam_mu.data_ptr(),
            rho.data_ptr() if fista else None,
            partials.data_ptr(), out.data_ptr(), table, ndim, *dims,
            int(fista), int(bc), int(iso_r), int(iso_q), int(lossy),
            band if band is not None else walk_band(tuple(orig.shape)),
            *blocks, stream)
        build.check(err)
        fused_iteration.calls += 1
        fused_iteration.launches += 1
        fused_iteration.walk_launches += 1
        fused_iteration.halo_launches += halos is not None
        fused_iteration.lossy_launches += lossy
        return recon, accs, ds, out[0], out[1], out[2]
    fn = (lib.tv_fused_iteration_f32 if orig.dtype == torch.float32
          else lib.tv_fused_iteration_f64)
    nblocks = min(work, MAX_BLOCKS)
    partials = torch.empty(3 * nblocks, dtype=torch.float64, device=orig.device)
    out = torch.empty(3, dtype=orig.dtype, device=orig.device)
    err = fn(orig.data_ptr(), recon.data_ptr(), *bs, *dd,
             lambda_inv.data_ptr(), lam_mu.data_ptr(),
             rho.data_ptr() if fista else None,
             partials.data_ptr(), out.data_ptr(), table,
             _edge_bits(edge_next, ndim), ndim, *dims,
             int(fista), int(bc), int(iso_r), int(iso_q), int(lossy), nblocks,
             stream)
    build.check(err)
    fused_iteration.calls += 1
    fused_iteration.launches += 1
    fused_iteration.halo_launches += halos is not None
    fused_iteration.lossy_launches += lossy
    fused_iteration.mode_launches += halos is not None and (
        any(ax > 1 for ax in axes) or BCMode(bc) != BCMode.JIA_ZHAO
        or iso_r or iso_q)
    return recon, accs, ds, out[0], out[1], out[2]


fused_iteration.launches = 0
fused_iteration.halo_launches = 0
fused_iteration.mode_launches = 0
fused_iteration.lossy_launches = 0
fused_iteration.walk_launches = 0
fused_iteration.calls = 0
