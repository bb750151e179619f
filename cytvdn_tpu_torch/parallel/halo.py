"""Halo exchange between the shards of a mesh over ``torch.distributed``.

Counterpart of ``cytvdn_tpu/parallel/halo.py::MeshComm``, the replacement
for the reference's MPI ``Isend/Irecv`` face exchange (reference
cyTVDN/mpi.py:322-434). It keeps the JAX package's corrected seam scheme
(SURVEY.md §8.3): halos are kernel operands, never stored into state
slots; a backward difference at a seam takes the -1 neighbour's last slab
of recon, a forward difference the +1 neighbour's first slab of the updated
accumulator (or the pre-update slabs it is recomputed from); global edges
get the values that realize the boundary condition.

One process (or, in the tests, one thread) holds one shard. The ranks of
the process group are laid out on the shard grid in row-major order (rank
→ one coordinate per data axis), as ``jax.sharding.Mesh`` lays out
devices. Point-to-point exchanges go in an even/odd order along the
exchanged axis (even coordinates send first, odd ones receive first), so no
pairing can deadlock, under gloo (whose sends do not block) or NCCL (whose
sends wait for their receive). Under gloo a CUDA slab goes through page-
locked host memory: gloo's point-to-point takes CPU tensors, so the stage
is the transport. Sums go through :meth:`MeshComm.allsum`: every rank
gathers every rank's partials and adds them in rank order in float64, so
every rank holds the same bits (stop decisions hang on them). A step of
the host that may fail on one rank alone (a file's write or read) goes
through :meth:`MeshComm.together`, so that every rank raises with it.

Boundaries: a Jia-Zhao or mirror mesh exchanges along a path (the shards
at the global edges have one neighbour), a periodic mesh along a ring
(:meth:`MeshComm.ring_from_prev`/:meth:`ring_from_next`; an odd ring goes
one direction at a time, so that no two shards that both send first meet).

Every buffer an exchange uses — what it sends, what it receives, the page-
locked stage — lives in a pool keyed by the exchange (:meth:`MeshComm.
buffer`). A run reserves the buffers of its steps before its first
collective (``solver/engine.py::prepare_run`` calls the steps' halo
assembly under :meth:`MeshComm.reserving`, which allocates and does not
communicate) and then seals the pool: a later allocation raises, so no rank
can run out of device memory alone inside an exchange while the others
wait in it.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from cytvdn_tpu_torch.config import BCMode
from cytvdn_tpu_torch.ops.stencil import _slab

Tensor = torch.Tensor


def _group_backend(group) -> str:
    """``"gloo"`` or ``"nccl"``: the backend of a registered group, or of a
    bare gloo backend object (as the tests make them)."""
    if isinstance(group, dist.ProcessGroupGloo):
        return "gloo"
    return str(dist.get_backend(group))


#: message tags: slabs sent to the +1 neighbour, to the -1 neighbour, and
#: the blocks of a gathered result
_TAG_NEXT, _TAG_PREV, _TAG_GATHER = 0, 2, 1


def _numel(shape) -> int:
    n = 1
    for e in shape:
        n *= int(e)
    return n


def _views(flat: Tensor, shapes) -> List[Tensor]:
    """Contiguous views of consecutive pieces of a flat buffer."""
    out, off = [], 0
    for shape in shapes:
        n = _numel(shape)
        out.append(flat[off:off + n].view(shape))
        off += n
    return out


class _Lane:
    """The buffers of one exchange: per direction with a neighbour, the
    flat message sent and the one received (on the slabs' device; under a
    staged transport also a page-locked host copy of each), and the
    received pieces as views."""

    def __init__(self, comm, next_shapes, prev_shapes, dtype, device,
                 has_prev: bool, has_next: bool):
        staged = device.type == "cuda" and comm.backend != "nccl"

        def flat(shapes, needed):
            n = sum(_numel(x) for x in shapes)
            if not needed or not n:
                return None, None
            dev = torch.empty(n, dtype=dtype, device=device)
            host = torch.empty(n, dtype=dtype, pin_memory=True) \
                if staged else None
            return dev, host

        # to the +1 neighbour and back from the -1 neighbour: the to_next
        # pieces; the other way the to_prev pieces
        self.send_next = flat(next_shapes, has_next)
        self.send_prev = flat(prev_shapes, has_prev)
        self.recv_prev = flat(next_shapes, has_prev)
        self.recv_next = flat(prev_shapes, has_next)
        self.from_prev = _views(self.recv_prev[0], next_shapes) \
            if self.recv_prev[0] is not None else None
        self.from_next = _views(self.recv_next[0], prev_shapes) \
            if self.recv_next[0] is not None else None
        # device bytes (the page-locked stage is host memory)
        self.nbytes = sum(
            pair[0].numel() * pair[0].element_size() for pair in (
                self.send_next, self.send_prev, self.recv_prev,
                self.recv_next) if pair[0] is not None)


class MeshComm:
    """The communication strategy of one shard.

    ``group`` is a ``torch.distributed`` process group (or a bare
    ``ProcessGroupGloo``) of ``prod(grid)`` ranks; ``grid`` gives the tile
    count of every data axis; ``rank`` is this process's rank in ``group``;
    ``bc`` the run's boundary condition (``prev_halo``/``next_halo`` realize
    it at the global edges; ``run_sharded`` sets it from the options).
    ``axis_names`` maps each split data axis to a name (``{0: "ax0"}``),
    as the JAX mesh names them; ``split_axes`` lists those axes.

    ``stats`` counts the halo exchanges, the sums and the gathers of a
    result: calls, bytes sent and received, and the host seconds spent in
    them (staging copies and waits for the other ranks included), and the
    buffers of the pool (``buffers``, ``buffer_bytes``: device bytes).

    ``ranks`` lays the grid over some of the group's ranks: the group rank
    of each grid position in row-major order, ``rank`` then being this
    process's position. Such a mesh only exchanges slabs (its sums and
    gathers would span the whole group, so they raise): it is how an
    out-of-core run splits each slab over the ranks of one process-row
    (``solver/outofcore.py::_Cols``).
    """

    def __init__(self, group, grid: Sequence[int], rank: int,
                 bc: BCMode = BCMode.JIA_ZHAO,
                 ranks: Optional[Sequence[int]] = None):
        self.group = group
        self.grid = tuple(int(w) for w in grid)
        self.rank = int(rank)
        self.bc = BCMode(bc)
        self.backend = _group_backend(group)
        n = int(np.prod(self.grid))
        if not 0 <= self.rank < n:
            raise ValueError(f"rank {rank} outside a grid of {n} shards")
        self.ranks = None if ranks is None else tuple(int(q) for q in ranks)
        if self.ranks is not None and len(self.ranks) != n:
            raise ValueError(f"{len(self.ranks)} ranks for a grid of {n} "
                             f"shards")
        self.coords = tuple(int(c) for c in np.unravel_index(self.rank,
                                                             self.grid))
        self.world = n
        self.axis_names: Dict[int, str] = {
            ax: f"ax{ax}" for ax, w in enumerate(self.grid) if w > 1}
        self.split_axes = tuple(sorted(self.axis_names))
        self._pool: Dict[tuple, object] = {}
        self._reserving = False
        #: set once a run's buffers are reserved: allocating another raises
        self.sealed = False
        self.stats = {"exchanges": 0, "bytes_sent": 0, "bytes_received": 0,
                      "exchange_seconds": 0.0, "allsums": 0,
                      "allsum_seconds": 0.0, "gather_bytes": 0,
                      "gather_seconds": 0.0, "buffers": 0,
                      "buffer_bytes": 0}

    # -- the grid ----------------------------------------------------------

    def size(self, ax: int) -> int:
        return self.grid[ax] if ax < len(self.grid) else 1

    def is_first(self, ax: int) -> bool:
        """Whether this shard holds the global leading edge of ``ax``."""
        return ax >= len(self.grid) or self.coords[ax] == 0

    def is_last(self, ax: int) -> bool:
        """Whether this shard holds the global trailing edge of ``ax``."""
        return ax >= len(self.grid) or self.coords[ax] == self.grid[ax] - 1

    def _neighbour(self, ax: int, step: int,
                   ring: bool = False) -> Optional[int]:
        """The rank ``step`` tiles away along ``ax`` (wrapping on a ring of
        more than one tile), or None."""
        if self.size(ax) == 1:
            return None
        c = list(self.coords)
        c[ax] += step
        if ring:
            c[ax] %= self.grid[ax]
        if not 0 <= c[ax] < self.grid[ax]:
            return None
        pos = int(np.ravel_multi_index(tuple(c), self.grid))
        return pos if self.ranks is None else self.ranks[pos]

    def _whole_group(self, what: str) -> None:
        if self.ranks is not None:
            raise RuntimeError(f"{what} on a mesh over part of its group: "
                               f"it exchanges slabs only")

    # -- the buffer pool ---------------------------------------------------

    @contextlib.contextmanager
    def reserving(self):
        """Within it, exchanges allocate their buffers and return them
        without communicating (their contents undefined), and pool buffers
        may be allocated though the pool is sealed: a run's halo assembly
        called here reserves what its steps will use."""
        self._reserving = True
        try:
            yield self
        finally:
            self._reserving = False

    def _pooled(self, key, make):
        got = self._pool.get(key)
        if got is None:
            if self.sealed and not self._reserving:
                raise RuntimeError(
                    f"mesh buffer {key[:2]} was not reserved before the run's "
                    f"first collective (engine.prepare_run)")
            got = self._pool[key] = make()
            self.stats["buffers"] += 1
            self.stats["buffer_bytes"] += got.nbytes if isinstance(
                got, _Lane) else got.numel() * got.element_size()
        return got

    def buffer(self, name: str, shape, dtype, device,
               zero: bool = False) -> Tensor:
        """The pool's tensor ``name`` of ``shape``/``dtype`` on ``device``
        (zero-filled when first made, with ``zero``)."""
        key = ("buffer", name, tuple(int(e) for e in shape), dtype,
               torch.device(device), zero)
        make = torch.zeros if zero else torch.empty
        return self._pooled(key, lambda: make(
            tuple(key[2]), dtype=dtype, device=device))

    def release(self) -> None:
        """Drop the pool (the device-memory ladder's retry), unsealed."""
        self._pool.clear()
        self.sealed = False

    # -- transport ---------------------------------------------------------

    def _exchange(self, name: str, ax: int, to_next: Sequence[Tensor],
                  to_prev: Sequence[Tensor], ring: bool = False):
        """Send the pieces ``to_next`` to the +1 neighbour along ``ax`` and
        ``to_prev`` to the -1 neighbour (on a ring the neighbours wrap),
        each as one message; return the -1 neighbour's ``to_next`` pieces
        and the +1 neighbour's ``to_prev`` pieces, as contiguous views into
        this exchange's buffers (None at a global edge or for a direction
        nobody sends). Every shard of the mesh makes the same call with
        pieces of the same shapes."""
        t0 = time.perf_counter()
        prev = self._neighbour(ax, -1, ring)
        nxt = self._neighbour(ax, +1, ring)
        like = (list(to_next) + list(to_prev))[0]
        key = ("lane", name, ax, ring,
               tuple(tuple(p.shape) for p in to_next),
               tuple(tuple(p.shape) for p in to_prev), like.dtype,
               like.device)
        lane = self._pooled(key, lambda: _Lane(
            self, key[4], key[5], like.dtype, like.device,
            prev is not None, nxt is not None))
        if self._reserving:
            return lane.from_prev, lane.from_next

        def pack(buf, pieces):
            dev, host = buf
            for v, p in zip(_views(dev, [x.shape for x in pieces]), pieces):
                v.copy_(p)
            if host is not None:
                host.copy_(dev)
            return host if host is not None else dev

        sends_n, sends_p, recvs_n, recvs_p = [], [], [], []
        if lane.send_next[0] is not None:
            sends_n.append((pack(lane.send_next, to_next), nxt, _TAG_NEXT))
        if lane.send_prev[0] is not None:
            sends_p.append((pack(lane.send_prev, to_prev), prev, _TAG_PREV))
        wire = [(b[1] if b[1] is not None else b[0]) if b[0] is not None
                else None for b in (lane.recv_prev, lane.recv_next)]
        if wire[0] is not None:
            recvs_n.append((wire[0], prev, _TAG_NEXT))
        if wire[1] is not None:
            recvs_p.append((wire[1], nxt, _TAG_PREV))
        odd = self.coords[ax] % 2

        def order(sends, recvs):
            return ([("r", *x) for x in recvs] + [("s", *x) for x in sends]
                    if odd else
                    [("s", *x) for x in sends] + [("r", *x) for x in recvs])

        if ring and self.size(ax) % 2 and self.size(ax) > 1:
            # an odd ring's wrap joins two even shards: one direction at a
            # time, each a cycle that a receiving odd shard keeps moving
            rounds = [order(sends_n, recvs_n), order(sends_p, recvs_p)]
        else:
            rounds = [order(sends_n + sends_p, recvs_n + recvs_p)]
        for ops in rounds:
            works = []
            for kind, t, peer, tag in ops:
                if kind == "s":
                    works.append(self.group.send([t], peer, tag))
                else:
                    works.append(self.group.recv([t], peer, tag))
            for w in works:
                w.wait()
        for dev, host in (lane.recv_prev, lane.recv_next):
            if host is not None:
                dev.copy_(host)
        self.stats["exchanges"] += 1
        self.stats["bytes_sent"] += sum(t.numel() * t.element_size()
                                        for t, _, _ in sends_n + sends_p)
        self.stats["bytes_received"] += sum(t.numel() * t.element_size()
                                            for t, _, _ in recvs_n + recvs_p)
        self.stats["exchange_seconds"] += time.perf_counter() - t0
        return lane.from_prev, lane.from_next

    def _wire(self, t: Tensor) -> Tensor:
        """``t`` as the backend sends it: a page-locked host copy of a CUDA
        tensor under gloo, else ``t`` itself (contiguous)."""
        if t.device.type == "cuda" and self.backend != "nccl":
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t)
            return host
        return t.contiguous()

    # -- sums --------------------------------------------------------------

    def _gather(self, x: Tensor) -> List[Tensor]:
        self._whole_group("a collective")
        flat = x.detach().reshape(-1).to(torch.float64)
        if self.backend == "nccl":
            flat = flat.to(x.device)
        else:
            flat = flat.cpu()
        out = [torch.empty_like(flat) for _ in range(self.world)]
        self.group.allgather([out], [flat]).wait()
        return out

    def allsum(self, x: Tensor) -> Tensor:
        """Every shard's ``x`` (a tensor of any shape) added up elementwise
        in rank order, in float64, cast back to ``x``'s dtype on its
        device: the same bits on every rank."""
        t0 = time.perf_counter()
        parts = self._gather(x)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        self.stats["allsums"] += 1
        self.stats["allsum_seconds"] += time.perf_counter() - t0
        return total.reshape(x.shape).to(device=x.device, dtype=x.dtype)

    def allmax(self, flag: int) -> int:
        """The largest of every rank's integer ``flag``."""
        return int(self.gather_values([flag]).max())

    def gather_values(self, values: Sequence[float]) -> np.ndarray:
        """Every rank's short list of numbers, as a ``(ranks, len)``
        float64 array in rank order, the same on every rank."""
        parts = self._gather(torch.tensor([float(v) for v in values],
                                          dtype=torch.float64,
                                          device=self._sum_device()))
        return np.stack([p.cpu().numpy() for p in parts])

    def together(self, step, failure: str, error=OSError):
        """``step()`` on this rank, then one collective in which every rank
        says whether its step raised; returns the step's result. Where any
        rank's step raised, every rank raises (its own error, or an
        ``error`` naming the ranks that ``failure``), so that no rank is
        left waiting for it in a later collective."""
        out, err = None, None
        try:
            out = step()
        except Exception as e:
            err = e
        failed = np.flatnonzero(self.gather_values([err is not None])[:, 0])
        if failed.size:
            if err is not None:
                raise err
            raise error(f"ranks {failed.tolist()} of the mesh {failure} "
                        f"(see their errors)")
        return out

    def _sum_device(self):
        if self.backend == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def gather_blocks(self, block: Tensor, shape: Sequence[int],
                      slices: Sequence[slice]) -> Optional[np.ndarray]:
        """Every rank's ``block`` of a cube of ``shape``, put together as
        one numpy array on rank 0; None on the other ranks. Each rank gives
        its block's ``slices`` in the cube (blocks may differ in shape:
        balanced row ranges)."""
        self._whole_group("a gather")
        t0 = time.perf_counter()
        bounds = self.gather_values(
            [v for s in slices for v in (s.start, s.stop)]).astype(
                np.int64).reshape(self.world, -1, 2)
        nbytes = block.numel() * block.element_size()
        if self.rank != 0:
            self.group.send([self._wire(block)], 0, _TAG_GATHER).wait()
            self.stats["gather_bytes"] += nbytes
            self.stats["gather_seconds"] += time.perf_counter() - t0
            return None
        out = np.empty(tuple(shape),
                       torch.empty(0, dtype=block.dtype).numpy().dtype)
        for r in range(self.world):
            sl = tuple(slice(int(a), int(b)) for a, b in bounds[r])
            if r == 0:
                got = block
            else:
                like = tuple(s.stop - s.start for s in sl)
                got = torch.empty(like, dtype=block.dtype,
                                  pin_memory=block.device.type == "cuda"
                                  and self.backend != "nccl")
                if self.backend == "nccl":
                    got = torch.empty(like, dtype=block.dtype,
                                      device=block.device)
                self.group.recv([got], r, _TAG_GATHER).wait()
                self.stats["gather_bytes"] += got.numel() * got.element_size()
            out[sl] = got.cpu().numpy()
        self.stats["gather_seconds"] += time.perf_counter() - t0
        return out

    def gather_pieces(self, piece: Tensor,
                      senders: Sequence[int]) -> Optional[List[Tensor]]:
        """The ``piece`` of every rank in ``senders`` (all of one shape and
        dtype; a rank not in it sends nothing), by rank in ``senders``'
        order, on rank 0; None on the other ranks. Every rank makes the
        call with the same ``senders``."""
        self._whole_group("a gather")
        t0 = time.perf_counter()
        nbytes = piece.numel() * piece.element_size()
        if self.rank != 0:
            if self.rank in senders:
                self.group.send([self._wire(piece)], 0, _TAG_GATHER).wait()
                self.stats["gather_bytes"] += nbytes
            self.stats["gather_seconds"] += time.perf_counter() - t0
            return None
        out = []
        for r in senders:
            if r == 0:
                out.append(piece)
                continue
            got = torch.empty_like(piece) if self.backend == "nccl" else \
                torch.empty(piece.shape, dtype=piece.dtype,
                            pin_memory=piece.device.type == "cuda")
            self.group.recv([got], r, _TAG_GATHER).wait()
            self.stats["gather_bytes"] += nbytes
            out.append(got)
        self.stats["gather_seconds"] += time.perf_counter() - t0
        return out

    # -- halos -------------------------------------------------------------

    def prev_halo(self, a: Tensor, ax: int) -> Optional[Tensor]:
        """-1 neighbour's last slab of ``a`` along ``ax`` (the backward
        difference's operand) on a ring under periodic boundaries; at the
        global leading edge the own first slab (Jia-Zhao's zero difference)
        or the cube's slab 1 (mirror: the own slab 1, or the +1
        neighbour's first slab where a shard is one slab thick); None where
        ``ax`` is not split."""
        if self.size(ax) == 1:
            return None
        if self.bc == BCMode.PERIODIC:
            return self.ring_from_prev(a, ax)
        if self.bc == BCMode.MIRROR:
            edge = _slab(a, ax, 1) if a.shape[ax] > 1 \
                else self.slab_from_next(a, ax, 0)
        else:
            edge = _slab(a, ax, 0)
        return self.shift_from_prev(a, ax, edge, name="prev_halo")

    def next_halo(self, b: Tensor, ax: int) -> Optional[Tensor]:
        """+1 neighbour's first slab of the updated ``b`` along ``ax`` (the
        forward difference's operand), on a ring under periodic boundaries;
        None where ``ax`` is not split. At the global trailing edge,
        Jia-Zhao's wrap slab, identically zero by its invariant (SURVEY.md
        §8.1), or the own last slab (the corrected mirror)."""
        if self.size(ax) == 1:
            return None
        if self.bc == BCMode.PERIODIC:
            return self.ring_from_next(b, ax)
        edge = _slab(b, ax, -1) if self.bc == BCMode.MIRROR else \
            self.buffer("next_halo_zero", _slab(b, ax, 0).shape, b.dtype,
                        b.device, zero=True)
        return self.shift_from_next(b, ax, edge, name="next_halo")

    def shift_from_prev(self, arr: Tensor, ax: int, edge_slab: Tensor,
                        name: str = "shift_prev") -> Tensor:
        """-1 neighbour's last slab of ``arr``; ``edge_slab`` on the shard
        at the global leading edge and where ``ax`` is not split."""
        if self.size(ax) == 1:
            return edge_slab
        got, _ = self._exchange(name, ax, [_slab(arr, ax, -1)], ())
        return edge_slab if got is None else got[0]

    def shift_from_next(self, arr: Tensor, ax: int, edge_slab: Tensor,
                        name: str = "shift_next") -> Tensor:
        """+1 neighbour's first slab of ``arr``; ``edge_slab`` on the shard
        at the global trailing edge and where ``ax`` is not split."""
        if self.size(ax) == 1:
            return edge_slab
        _, got = self._exchange(name, ax, (), [_slab(arr, ax, 0)])
        return edge_slab if got is None else got[0]

    def slab_from_next(self, arr: Tensor, ax: int, idx: int,
                       name: str = "slab_next") -> Tensor:
        """+1 neighbour's slab at (its own) index ``idx`` along ``ax``;
        zeros at the global trailing edge."""
        zero = self.buffer(name + "_zero", _slab(arr, ax, idx).shape,
                           arr.dtype, arr.device, zero=True)
        return self.shift_from_next(arr.narrow(ax, idx % arr.shape[ax], 1),
                                    ax, zero, name=name)

    def ring_from_prev(self, arr: Tensor, ax: int,
                       name: str = "ring_prev") -> Tensor:
        """Ring -1 neighbour's last slab of ``arr``; the own last slab where
        ``ax`` is not split (the whole axis is on the shard: the wrap is
        local)."""
        if self.size(ax) == 1:
            return _slab(arr, ax, -1)
        got, _ = self._exchange(name, ax, [_slab(arr, ax, -1)], (),
                                ring=True)
        return got[0]

    def ring_from_next(self, arr: Tensor, ax: int,
                       name: str = "ring_next") -> Tensor:
        """Ring +1 neighbour's first slab of ``arr``; the own first slab
        where ``ax`` is not split."""
        if self.size(ax) == 1:
            return _slab(arr, ax, 0)
        _, got = self._exchange(name, ax, (), [_slab(arr, ax, 0)],
                                ring=True)
        return got[0]

    def exchange_pieces(self, ax: int, to_next: Sequence[Tensor],
                        to_prev: Sequence[Tensor], name: str = "pieces",
                        ring: bool = False
                        ) -> Tuple[Optional[List[Tensor]],
                                   Optional[List[Tensor]]]:
        """Both directions of a packed exchange in one call: the pieces of
        ``to_next`` go to the +1 neighbour and those of ``to_prev`` to the
        -1 neighbour, each list as one message (neighbours wrapping with
        ``ring``). Returns the -1 neighbour's ``to_next`` pieces and the +1
        neighbour's ``to_prev`` pieces, as contiguous views into the
        exchange's buffers ``name`` (valid until its next call), or None at
        a global edge and where ``ax`` is not split."""
        if self.size(ax) == 1:
            return None, None
        return self._exchange(name, ax, to_next, to_prev, ring=ring)

    def pack_exchange_prev(self, pieces: Sequence[Tensor],
                           ax: int) -> List[Tensor]:
        """Send the own ``pieces`` to the +1 neighbour in one message and
        return the -1 neighbour's; zeros at the global leading edge."""
        got, _ = self.exchange_pieces(ax, pieces, (), name="pack_prev")
        return got if got is not None else [torch.zeros_like(p)
                                            for p in pieces]

    def pack_exchange_next(self, pieces: Sequence[Tensor],
                           ax: int) -> List[Tensor]:
        """Send the own ``pieces`` to the -1 neighbour in one message and
        return the +1 neighbour's; zeros at the global trailing edge."""
        _, got = self.exchange_pieces(ax, (), pieces, name="pack_next")
        return got if got is not None else [torch.zeros_like(p)
                                            for p in pieces]
