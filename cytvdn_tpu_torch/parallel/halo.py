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
every rank holds the same bits (stop decisions hang on them).

Jia-Zhao only: periodic and mirror meshes, with the ring, band and
``slab_from_*`` helpers, are ROADMAP.md Queue 1 item 8.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from cytvdn_tpu_torch.config import BCMode, _not_ported
from cytvdn_tpu_torch.ops.stencil import _slab

Tensor = torch.Tensor


def _group_backend(group) -> str:
    """``"gloo"`` or ``"nccl"``: the backend of a registered group, or of a
    bare gloo backend object (as the tests make them)."""
    if isinstance(group, dist.ProcessGroupGloo):
        return "gloo"
    return str(dist.get_backend(group))


class MeshComm:
    """The communication strategy of one shard.

    ``group`` is a ``torch.distributed`` process group (or a bare
    ``ProcessGroupGloo``) of ``prod(grid)`` ranks; ``grid`` gives the tile
    count of every data axis; ``rank`` is this process's rank in ``group``.
    ``axis_names`` maps each split data axis to a name (``{0: "ax0"}``),
    as the JAX mesh names them; ``split_axes`` lists those axes.

    ``stats`` counts the halo exchanges, the sums and the gathers of a
    result: calls, bytes sent and received, and the host seconds spent in
    them (staging copies and waits for the other ranks included).
    """

    def __init__(self, group, grid: Sequence[int], rank: int,
                 bc: BCMode = BCMode.JIA_ZHAO):
        self.group = group
        self.grid = tuple(int(w) for w in grid)
        self.rank = int(rank)
        if BCMode(bc) != BCMode.JIA_ZHAO:
            raise _not_ported("periodic and mirror boundaries on a mesh "
                              "(ring halos, edge_next)", "Queue 1 item 8")
        self.backend = _group_backend(group)
        n = int(np.prod(self.grid))
        if not 0 <= self.rank < n:
            raise ValueError(f"rank {rank} outside a grid of {n} shards")
        self.coords = tuple(int(c) for c in np.unravel_index(self.rank,
                                                             self.grid))
        self.world = n
        self.axis_names: Dict[int, str] = {
            ax: f"ax{ax}" for ax, w in enumerate(self.grid) if w > 1}
        self.split_axes = tuple(sorted(self.axis_names))
        self.stats = {"exchanges": 0, "bytes_sent": 0, "bytes_received": 0,
                      "exchange_seconds": 0.0, "allsums": 0,
                      "allsum_seconds": 0.0, "gather_bytes": 0,
                      "gather_seconds": 0.0}

    # -- the grid ----------------------------------------------------------

    def size(self, ax: int) -> int:
        return self.grid[ax] if ax < len(self.grid) else 1

    def is_first(self, ax: int) -> bool:
        """Whether this shard holds the global leading edge of ``ax``."""
        return ax >= len(self.grid) or self.coords[ax] == 0

    def is_last(self, ax: int) -> bool:
        """Whether this shard holds the global trailing edge of ``ax``."""
        return ax >= len(self.grid) or self.coords[ax] == self.grid[ax] - 1

    def _neighbour(self, ax: int, step: int) -> Optional[int]:
        c = list(self.coords)
        c[ax] += step
        if not 0 <= c[ax] < self.grid[ax]:
            return None
        return int(np.ravel_multi_index(tuple(c), self.grid))

    # -- transport ---------------------------------------------------------

    def _staged(self, t: Tensor) -> bool:
        return t.device.type == "cuda" and self.backend != "nccl"

    def _wire(self, t: Tensor) -> Tensor:
        """``t`` as the backend sends it: a page-locked host copy of a CUDA
        tensor under gloo, else ``t`` itself (contiguous)."""
        if self._staged(t):
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t)
            return host
        return t.contiguous()

    def _recv_buffer(self, like: Tensor) -> Tensor:
        if self._staged(like):
            return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
        return torch.empty_like(like, memory_format=torch.contiguous_format)

    def _exchange(self, ax: int, to_next: Optional[Tensor],
                  to_prev: Optional[Tensor]
                  ) -> Tuple[Optional[Tensor], Optional[Tensor]]:
        """Send ``to_next`` to the +1 neighbour along ``ax`` and ``to_prev``
        to the -1 neighbour; return what the -1 neighbour sent as its
        ``to_next`` and the +1 neighbour as its ``to_prev`` (None at a
        global edge or for a direction nobody sends). Every shard of the
        mesh makes the same call with tensors of the same shapes."""
        t0 = time.perf_counter()
        prev, nxt = self._neighbour(ax, -1), self._neighbour(ax, +1)
        sends, recvs = [], []
        from_prev = from_next = None
        if to_next is not None and nxt is not None:
            sends.append((self._wire(to_next), nxt))
        if to_prev is not None and prev is not None:
            sends.append((self._wire(to_prev), prev))
        if to_next is not None and prev is not None:
            from_prev = self._recv_buffer(to_next)
            recvs.append((from_prev, prev))
        if to_prev is not None and nxt is not None:
            from_next = self._recv_buffer(to_prev)
            recvs.append((from_next, nxt))
        ops = ([("s", *x) for x in sends] + [("r", *x) for x in recvs])
        if self.coords[ax] % 2:
            ops = [("r", *x) for x in recvs] + [("s", *x) for x in sends]
        works = []
        for kind, t, peer in ops:
            if kind == "s":
                works.append(self.group.send([t], peer, 0))
            else:
                works.append(self.group.recv([t], peer, 0))
        for w in works:
            w.wait()
        like = to_next if to_next is not None else to_prev
        dev = like.device if like is not None else None
        if from_prev is not None and from_prev.device != dev:
            from_prev = from_prev.to(dev)
        if from_next is not None and from_next.device != dev:
            from_next = from_next.to(dev)
        self.stats["exchanges"] += 1
        self.stats["bytes_sent"] += sum(t.numel() * t.element_size()
                                        for t, _ in sends)
        self.stats["bytes_received"] += sum(t.numel() * t.element_size()
                                            for t, _ in recvs)
        self.stats["exchange_seconds"] += time.perf_counter() - t0
        return from_prev, from_next

    # -- sums --------------------------------------------------------------

    def _gather(self, x: Tensor) -> List[Tensor]:
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
        parts = self._gather(torch.tensor([float(flag)],
                                          device=self._sum_device()))
        return int(max(float(p[0]) for p in parts))

    def _sum_device(self):
        if self.backend == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def gather_blocks(self, block: Tensor,
                      shape: Sequence[int]) -> Optional[np.ndarray]:
        """Every rank's ``block`` of an evenly tiled cube of ``shape``, put
        together as one numpy array on rank 0; None on the other ranks."""
        t0 = time.perf_counter()
        nbytes = block.numel() * block.element_size()
        if self.rank != 0:
            self.group.send([self._wire(block)], 0, 1).wait()
            self.stats["gather_bytes"] += nbytes
            self.stats["gather_seconds"] += time.perf_counter() - t0
            return None
        out = np.empty(tuple(shape),
                       torch.empty(0, dtype=block.dtype).numpy().dtype)
        for r in range(self.world):
            if r == 0:
                got = block
            else:
                got = self._recv_buffer(block)
                self.group.recv([got], r, 1).wait()
                self.stats["gather_bytes"] += nbytes
            sl = tuple(slice(c * n, (c + 1) * n) for c, n in zip(
                np.unravel_index(r, self.grid), block.shape))
            out[sl] = got.cpu().numpy()
        self.stats["gather_seconds"] += time.perf_counter() - t0
        return out

    # -- halos -------------------------------------------------------------

    def prev_halo(self, a: Tensor, ax: int) -> Optional[Tensor]:
        """-1 neighbour's last slab of ``a`` along ``ax`` (the backward
        difference's operand), the own first slab (Jia-Zhao's zero
        difference) at the global leading edge; None where ``ax`` is not
        split."""
        if self.size(ax) == 1:
            return None
        return self.shift_from_prev(a, ax, _slab(a, ax, 0))

    def next_halo(self, b: Tensor, ax: int) -> Optional[Tensor]:
        """+1 neighbour's first slab of the updated ``b`` along ``ax`` (the
        forward difference's operand); None where ``ax`` is not split. At
        the global trailing edge, Jia-Zhao's wrap slab: identically zero by
        its invariant (SURVEY.md §8.1)."""
        if self.size(ax) == 1:
            return None
        return self.shift_from_next(b, ax, torch.zeros_like(_slab(b, ax, 0)))

    def shift_from_prev(self, arr: Tensor, ax: int,
                        edge_slab: Tensor) -> Tensor:
        """-1 neighbour's last slab of ``arr``; ``edge_slab`` on the shard
        at the global leading edge and where ``ax`` is not split."""
        if self.size(ax) == 1:
            return edge_slab
        got, _ = self._exchange(ax, _slab(arr, ax, -1), None)
        return edge_slab if got is None else got

    def shift_from_next(self, arr: Tensor, ax: int,
                        edge_slab: Tensor) -> Tensor:
        """+1 neighbour's first slab of ``arr``; ``edge_slab`` on the shard
        at the global trailing edge and where ``ax`` is not split."""
        if self.size(ax) == 1:
            return edge_slab
        _, got = self._exchange(ax, None, _slab(arr, ax, 0))
        return edge_slab if got is None else got

    def exchange_pieces(self, ax: int, to_next: Sequence[Tensor],
                        to_prev: Sequence[Tensor]
                        ) -> Tuple[Optional[List[Tensor]],
                                   Optional[List[Tensor]]]:
        """Both directions of a packed exchange in one call: the pieces of
        ``to_next`` go to the +1 neighbour and those of ``to_prev`` to the
        -1 neighbour, each list concatenated along ``ax`` into one message.
        Returns the -1 neighbour's ``to_next`` pieces and the +1
        neighbour's ``to_prev`` pieces, each split back (contiguous), or
        None at a global edge."""
        def pack(pieces):
            return torch.cat(list(pieces), dim=ax) if pieces else None

        def unpack(t, pieces):
            if t is None:
                return None
            out, off = [], 0
            for p in pieces:
                n = p.shape[ax]
                out.append(t.narrow(ax, off, n).contiguous())
                off += n
            return out

        if self.size(ax) == 1:
            return None, None
        got_p, got_n = self._exchange(ax, pack(to_next), pack(to_prev))
        return unpack(got_p, to_next), unpack(got_n, to_prev)

    def pack_exchange_prev(self, pieces: Sequence[Tensor],
                           ax: int) -> List[Tensor]:
        """Send the own ``pieces`` to the +1 neighbour in one message and
        return the -1 neighbour's; zeros at the global leading edge."""
        got, _ = self.exchange_pieces(ax, pieces, ())
        return got if got is not None else [torch.zeros_like(p)
                                            for p in pieces]

    def pack_exchange_next(self, pieces: Sequence[Tensor],
                           ax: int) -> List[Tensor]:
        """Send the own ``pieces`` to the -1 neighbour in one message and
        return the +1 neighbour's; zeros at the global trailing edge."""
        _, got = self.exchange_pieces(ax, (), pieces)
        return got if got is not None else [torch.zeros_like(p)
                                            for p in pieces]
