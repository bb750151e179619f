"""Mesh runs of the port with the K=1 kernel's mesh-only modes, on the CPU:
periodic boundaries (ring halos), mirror boundaries (edge flags), half-
isotropic pairs split across shards (iso seams and corners) and splits of
axes 2 and 3 (in-block halos), through ``denoise_sharded``/``run_sharded``
against the port's single-device run, and the buffer pool that a run
reserves before its first collective.

The ranks run as threads (``test_torch_sharded.py::on_mesh``). The
gathered recon is bitwise the single-device run's and the traces within
rtol 1e-5. The cubes are float32: torch's CPU ``hypot`` in float64 takes a
vector path and a scalar path that differ by an ulp, so an iso pair's
blocks are not bitwise the whole cube there (the CUDA kernel has one
path). Every non-first shard's own slab 0 along a split axis holds nonzero
accumulators after the first iteration (asserted below), so a kernel that
read that slab in place of the seam would fail.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_sharded import (  # noqa: E402
    _check,
    _cube,
    _sharded,
    _single,
    on_mesh,
)
from cytvdn_tpu_torch.config import SolverOptions as TOptions  # noqa: E402
from cytvdn_tpu_torch.parallel import MeshComm, run_sharded  # noqa: E402
from cytvdn_tpu_torch.parallel.multihost import load_sharded_block  # noqa: E402
from cytvdn_tpu_torch.solver import engine as tengine  # noqa: E402

#: (cube, mesh, options): rings (an odd one), mirrors with 1 and 2 slabs per
#: shard, iso R on axis 0, axis 1 and a 2D grid, Jia-Zhao and iso Q splits
#: of axes 2 and 3 (the Q pair's in-block corners), 3D energy-axis splits,
#: and shards one slab thick along a split ring, iso R and iso Q axis
MODES = [
    ((12, 8, 6, 5), (2, 1, 1, 1), dict(BC_mode=0)),
    ((12, 8, 6, 5), (2, 2, 1, 1), dict(BC_mode=0)),
    ((9, 8, 10), (3, 1, 1), dict(BC_mode=0)),
    ((12, 8, 10), (2, 2, 1), dict(BC_mode=1)),
    ((4, 8, 10), (4, 1, 1), dict(BC_mode=1)),
    ((8, 8, 10), (4, 1, 1), dict(BC_mode=1)),
    ((12, 8, 6, 5), (2, 1, 1, 1), dict(isotropic_R=True)),
    ((12, 8, 6, 5), (1, 2, 1, 1), dict(isotropic_R=True)),
    ((12, 8, 6, 5), (2, 2, 1, 1), dict(isotropic_R=True)),
    ((8, 6, 8, 6), (1, 1, 2, 1), dict()),
    ((8, 6, 8, 6), (1, 1, 1, 2), dict()),
    ((8, 6, 8, 6), (1, 1, 2, 2), dict(isotropic_Q=True)),
    ((8, 6, 8, 6), (2, 1, 1, 2), dict(isotropic_Q=True, isotropic_R=True)),
    ((8, 6, 10), (1, 1, 2), dict()),
    ((8, 6, 10), (2, 1, 2), dict(BC_mode=0)),
    ((8, 6, 10), (1, 2, 2), dict(BC_mode=1)),
    ((3, 8, 6, 5), (3, 1, 1, 1), dict(BC_mode=0)),
    ((4, 8, 6, 5), (4, 1, 1, 1), dict(isotropic_R=True)),
    ((4, 4, 6, 5), (4, 2, 1, 1), dict(isotropic_R=True)),
    ((4, 6, 2, 5), (1, 1, 2, 1), dict(isotropic_Q=True)),
]
SCHEDULES = {"fista": dict(iterations=7, FISTA=True),
             "unacc": dict(iterations=7, FISTA=False),
             "hybrid": dict(iterations=(4, 3))}


def _id(case):
    shape, shard, kw = case
    return f"{shape}-{shard}-{'-'.join(f'{k}={v}' for k, v in kw.items())}"


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("case", MODES, ids=[_id(c) for c in MODES])
def test_mode_mesh_bitwise_single_device(case, schedule):
    shape, shard, kw = case
    cube = _cube(shape, seed=sum(shape) + len(kw))
    kw = dict(kw, **SCHEDULES[schedule])
    _check(_sharded(cube, shard, **kw), _single(cube, **kw))


STOP_MSE = [MODES[1], MODES[4], MODES[8], MODES[11]]


@pytest.mark.parametrize("case", STOP_MSE, ids=[_id(c) for c in STOP_MSE])
def test_mode_mesh_stop_and_mse(case):
    """A stop run stops at the single-device iteration; an MSE run sums
    every iteration's SSE over the mesh; both recons bitwise."""
    shape, shard, kw = case
    cube = _cube(shape, seed=21)
    kw = dict(kw, FISTA=True)
    fixed = _single(cube, iterations=30, **kw)[2]
    thr = float(np.sqrt(fixed[11] * fixed[12]))
    stop = dict(kw, iterations=30, stopping_relative_change=thr)
    want = _single(cube, **stop)
    assert np.count_nonzero(want[2]) == 13
    _check(_sharded(cube, shard, **stop), want)
    ref = (cube * 0.9).astype(np.float32)
    mse = dict(kw, iterations=6, reference_data=ref)
    _check(_sharded(cube, shard, **mse), _single(cube, **mse), mse=True)


@pytest.mark.parametrize("case", MODES[::2], ids=[_id(c) for c in MODES[::2]])
def test_mode_mesh_plain_backend(case):
    """``backend="torch"``: the plain spec with ``prev_halo``/``next_halo``
    exchanged after the dual update (rings, the mirror's slab 1 and own
    last slab, iso pairs), bitwise the single-device run."""
    shape, shard, kw = case
    kw = dict(kw, iterations=(3, 2), backend="torch")
    cube = _cube(shape, seed=22)
    _check(_sharded(cube, shard, **kw), _single(cube, **kw))


@pytest.mark.parametrize("kw", [
    dict(shard=(1, 1, 2, 1)),
    dict(shard=(2, 1, 1, 1), isotropic_R=True),
    dict(shard=(2, 1, 1, 1), BC_mode=1),
    dict(shard=(2, 1, 1, 1), BC_mode=0),
], ids=str)
def test_formerly_refused_mesh_runs(kw):
    """The mesh runs that named ROADMAP Queue 1 item 8 when refused (a
    split of axis 2, iso R, mirror, periodic; the cube and iterations of
    ``test_torch_sharded.py::test_unported_mesh_runs_name_their_item``)
    run, bitwise the single-device run."""
    cube = _cube((8, 8, 6, 4), seed=13)
    shard = kw.pop("shard")
    _check(_sharded(cube, shard, iterations=2, FISTA=True, **kw),
           _single(cube, iterations=2, FISTA=True, **kw))


def _block_run(cube, opts, shard, pg, r, **kw):
    comm = MeshComm(pg, shard, r)
    orig = torch.from_numpy(load_sharded_block(cube, shard, r))
    nd = cube.ndim
    out = run_sharded(orig, torch.full((nd,), 32.0), torch.full((nd,), 1 / 32),
                      opts, comm, keep_state=True, **kw)
    return comm, out


def test_non_first_shards_hold_nonzero_own_slab0():
    """After one iteration every non-first shard's own slab 0 of the
    accumulator along a split axis is nonzero: the seams above are tested
    where a read of the own b_0 in place of the halo would differ."""
    cube = _cube((8, 6, 8, 6), seed=23)
    shard = (2, 1, 2, 1)
    opts = TOptions(ndim=4, iterations_fista=1, iterations_unacc=0)

    def rank(pg, r):
        comm, out = _block_run(cube, opts, shard, pg, r)
        return [(ax, float(out["accs"][ax].narrow(ax, 0, 1).abs().max()))
                for ax in (0, 2) if not comm.is_first(ax)]

    got = [x for res in on_mesh(4, rank) for x in res]
    assert len(got) == 4 and all(v > 0 for _, v in got), got


# -- the buffer pool and the collective ladder --------------------------------

def test_mesh_buffers_reserved_before_the_first_collective():
    """``prepare_run`` reserves every buffer a step uses and seals the
    pool: the run allocates none after it (an unreserved one would raise),
    and an exchange outside the reserved set raises."""
    cube = _cube((8, 6, 8, 6), seed=24)
    shard = (2, 1, 2, 1)
    opts = TOptions(ndim=4, iterations_fista=3, iterations_unacc=2,
                    isotropic_Q=True)

    def rank(pg, r):
        comm = MeshComm(pg, shard, r)
        orig = torch.from_numpy(load_sharded_block(cube, shard, r))
        li, lm = torch.full((4,), 32.0), torch.full((4,), 1 / 32)
        run = tengine.prepare_run(orig, li, lm, opts, comm=comm)
        before = dict(comm.stats)
        assert comm.sealed and before["buffers"] > 0
        tengine.run_prepared(run)
        assert comm.stats["buffers"] == before["buffers"]
        assert comm.stats["exchanges"] > 0
        with pytest.raises(RuntimeError, match="not reserved"):
            comm.exchange_pieces(0, [orig[:1]], [], name="unreserved")
        return comm.stats["buffer_bytes"]

    assert all(b > 0 for b in on_mesh(4, rank))


def test_first_exchange_oom_takes_the_ladder_together(monkeypatch):
    """One rank runs out of device memory allocating its first exchange's
    buffers: that happens in ``prepare_run``, before any collective, so
    every rank takes the ladder together (one warning each) and the retry
    is bitwise the single-device run; where every attempt fails, every
    rank raises, and none waits for the group timeout."""
    real = MeshComm._pooled
    failed = []

    def flaky(self, key, make):
        if self.rank == 1 and key[0] == "lane" and key not in self._pool \
                and len(failed) < limit[0]:
            failed.append(key[1])
            raise torch.OutOfMemoryError("simulated at the first exchange")
        return real(self, key, make)

    monkeypatch.setattr(MeshComm, "_pooled", flaky)
    limit = [1]
    cube = _cube((12, 8, 6, 5), seed=25)
    kw = dict(iterations=6, isotropic_R=True)
    with pytest.warns(UserWarning, match="all ranks retry"):
        res = _sharded(cube, (2, 2, 1, 1), **kw)
    assert len(failed) == 1
    _check(res, _single(cube, **kw))

    limit[0] = 10
    failed.clear()

    def rank(pg, r):
        opts = TOptions(ndim=4, iterations_fista=3, iterations_unacc=0,
                        bc_mode=1)
        try:
            _block_run(cube, opts, (2, 1, 1, 1), pg, r)
        except torch.OutOfMemoryError as e:
            return str(e)

    with pytest.warns(UserWarning, match="all ranks retry"):
        msgs = on_mesh(2, rank, timeout=20)
    assert len(failed) == 2
    assert "another rank" in msgs[0] and "first exchange" in msgs[1]


# -- MeshComm with rings and mirror edges -------------------------------------

def test_meshcomm_ring_and_mirror_halos():
    """A periodic MeshComm exchanges on a ring (here of 3 shards, an odd
    ring), every shard receiving both neighbours' slabs; a mirror one gives
    the cube's slab 1 at the leading edge (the +1 neighbour's first slab
    where a shard is one slab thick) and the own updated last slab at the
    trailing edge."""
    def rank(pg, r):
        ring = MeshComm(pg, (3, 1, 1), r, bc=0)
        a = torch.full((2, 3, 4), float(r)) + torch.arange(2.0)[:, None, None]
        got = {"prev": ring.prev_halo(a, 0), "next": ring.next_halo(a, 0),
               "ring_prev": ring.ring_from_prev(a, 0),
               "ring_next": ring.ring_from_next(a, 0),
               "unsplit": ring.ring_from_prev(a, 1)}
        mirror = MeshComm(pg, (3, 1, 1), r, bc=1)
        got["m_prev"] = mirror.prev_halo(a, 0).clone()
        got["m_prev1"] = mirror.prev_halo(a[:1], 0).clone()
        got["m_next"] = mirror.next_halo(a, 0)
        return got

    res = on_mesh(3, rank)
    for r, got in enumerate(res):
        p, n = (r - 1) % 3, (r + 1) % 3
        assert torch.equal(got["prev"], torch.full((1, 3, 4), p + 1.0))
        assert torch.equal(got["ring_prev"], got["prev"])
        assert torch.equal(got["next"], torch.full((1, 3, 4), float(n)))
        assert torch.equal(got["ring_next"], got["next"])
        assert torch.equal(got["unsplit"], torch.full((2, 1, 4), float(r))
                           + torch.arange(2.0)[:, None, None])
        want_prev = 1.0 if r == 0 else p + 1.0
        assert torch.equal(got["m_prev"], torch.full((1, 3, 4), want_prev))
        want_prev1 = 1.0 if r == 0 else float(p)
        assert torch.equal(got["m_prev1"], torch.full((1, 3, 4), want_prev1))
        want_next = 3.0 if r == 2 else float(n)
        assert torch.equal(got["m_next"], torch.full((1, 3, 4), want_next))


def test_mesh_refuses_a_mirror_axis_of_one_slab():
    cube = _cube((1, 8, 6, 5), seed=26)
    opts = TOptions(ndim=4, iterations_fista=2, iterations_unacc=0,
                    bc_mode=1)
    with pytest.raises(ValueError, match="2 slabs along axis 0"):
        on_mesh(2, lambda pg, r: _block_run(cube, opts, (1, 2, 1, 1), pg, r))
