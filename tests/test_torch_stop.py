"""The port's stop-aware K-step and pair phases (``_run_blocks`` in
``cytvdn_tpu_torch.solver.engine``): a beaten guard discards the block, the
block length does not change the result, and the checkpoint's byte rule.

These cases are the port's own: the guard is beaten from a fabricated
``_PhaseState`` (a recorded plateau that the real deltas fall far below)
or by a guard that always allows.
Every run is held bitwise against the one-iteration loop: on the CPU the
kernels' wrappers run their plain versions, which are that loop's
iterations. JAX is not needed.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cytvdn_tpu_torch.config import SolverOptions as TOptions  # noqa: E402
from cytvdn_tpu_torch.kernels import fused as tfused  # noqa: E402
from cytvdn_tpu_torch.kernels import kstep as tkstep  # noqa: E402
from cytvdn_tpu_torch.kernels import resident as tres  # noqa: E402
from cytvdn_tpu_torch.kernels import temporal as ttemporal  # noqa: E402
from cytvdn_tpu_torch.solver import engine as tengine  # noqa: E402

COUNTERS = (tkstep.fused_kstep_iteration, ttemporal.fused_pair_iteration,
            tfused.fused_iteration, tres.resident_solve)


def _cube(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * 0.5
                             + 2.0).astype(np.float32))


def _scalars(ndim):
    div = 16.0 if ndim == 3 else 32.0
    return torch.full((ndim,), div), torch.full((ndim,), 1 / div)


@pytest.mark.parametrize("phase,fista,mse", [
    ("kstep", True, False), ("kstep", False, False),
    ("pair", True, False), ("pair", False, True)], ids=str)
def test_block_discarded_on_guard_beat(phase, fista, mse):
    """A recorded plateau (d1 = d2 = 1, so the guard predicts 1 >= 0.5)
    lets the launch run; its first delta falls far below 0.5, before its
    last: the guard is beaten, and state, traces (the MSE trace too),
    index and latch are bitwise as before the block."""
    shape = (16, 6, 64) if phase == "kstep" else (7, 12, 6, 16)
    ndim = len(shape)
    o = _cube(shape, seed=7)
    ref = _cube(shape, seed=8) if mse else None
    n = 40
    delta = torch.zeros(n)
    delta[:2] = 1.0
    st = tengine._PhaseState(
        i=2, done=False, recon=o.clone(),
        accs=[torch.zeros_like(o) for _ in range(ndim)],
        ds=[torch.zeros_like(o) for _ in range(ndim)] if fista else None,
        b_norm=torch.zeros(n), delta=delta,
        mse=torch.full((n + 1,), 3.0) if mse else None, tk=torch.ones(()))
    arrays = [st.recon, *st.accs, *(st.ds or []), st.b_norm, st.delta] \
        + ([st.mse] if mse else [])
    before = [x.clone() for x in arrays]
    opts = TOptions(ndim=ndim, iterations_fista=n if fista else 0,
                    iterations_unacc=0 if fista else n,
                    stopping_relative_change=0.5, calculate_mse=mse)
    rhos = torch.as_tensor(tengine.fista_tk_ratios(n), dtype=torch.float32)
    li, lm = _scalars(ndim)
    counter = COUNTERS[0] if phase == "kstep" else COUNTERS[1]
    calls = counter.calls
    if phase == "kstep":
        tengine._run_phase_kstep(fista, n, st, o, rhos, li, lm, opts, ref, 8)
    else:
        tengine._run_phase_paired(fista, n, st, o, rhos, li, lm, opts, ref)
    assert counter.calls == calls + 1, "the launch must run"
    assert st.i == 2 and not st.done
    for a, b in zip(arrays, before):
        assert torch.equal(a, b)


def _stop_case(shape, iters, stop_at, mse):
    """A cube, its scalars, the reference cube (``mse``) and a threshold
    between the deltas of iterations ``stop_at - 1`` and ``stop_at`` of the
    one-iteration run."""
    cube = _cube(shape, seed=3)
    ref = _cube(shape, seed=4) * 0.2 + 1.6 if mse else None
    li, lm = _scalars(len(shape))
    probe = tengine.run_solver(cube, li, lm, TOptions(
        ndim=len(shape), iterations_fista=iters[0], iterations_unacc=iters[1],
        temporal_pairs=False, vmem_resident=False))
    d = probe["delta"].numpy().astype(np.float64)
    assert d[stop_at] > 0 and d[stop_at] < d[stop_at - 1], d
    thr = float(np.sqrt(d[stop_at] * min(d[stop_at - 1], d[stop_at] * 4)))
    return cube, li, lm, ref, thr


@pytest.mark.parametrize("ckpt_pairs", [1, 2, 3, 5])
@pytest.mark.parametrize("guard", ["real", "always"])
@pytest.mark.parametrize("mse", [False, True])
@pytest.mark.parametrize("chunks", [False, True])
def test_stop_run_equals_k1_loop_at_every_block_length(monkeypatch,
                                                       ckpt_pairs, guard,
                                                       mse, chunks):
    """A stop-aware hybrid run (K=8 launches and pairs; pairs alone with
    ``calculate_mse``; with ``chunks``, 16-iteration whole-run chunks
    first) equals the one-iteration loop bitwise in ``iterations_run``,
    ``early_stopped``, recon and every trace, with blocks of 2, 4, 6 and
    10 iterations. With a guard that always allows, the launches run into
    the stop: a crossing before a launch's last delta discards its block,
    and the next phase redoes it; with the real guard the run ends as the
    one-iteration loop's does."""
    monkeypatch.setattr(tengine, "PAIR_MIN_ROW_BYTES", 0)
    monkeypatch.setattr(tengine, "_STOP_CKPT_PAIRS", ckpt_pairs)
    shape, iters, stop_at = (16, 6, 64), (12, 40), 40
    cube, li, lm, ref, thr = _stop_case(shape, iters, stop_at, mse)
    base = dict(ndim=3, iterations_fista=iters[0], iterations_unacc=iters[1],
                stopping_relative_change=thr, calculate_mse=mse)
    want = tengine.run_solver(cube, li, lm,
                              TOptions(**base, temporal_pairs=False,
                                       vmem_resident=False),
                              reference_data=ref)
    if guard == "always":
        monkeypatch.setattr(tengine, "_guard_allows", lambda *a: True)
    before = [c.calls for c in COUNTERS]
    got = tengine.run_solver(cube, li, lm,
                             TOptions(**base, vmem_resident=chunks),
                             reference_data=ref)
    ks, pairs, k1, res = (c.calls - b for c, b in zip(COUNTERS, before))
    assert got["iterations_run"] == want["iterations_run"] == stop_at + 1
    assert got["early_stopped"] and want["early_stopped"]
    keys = ("recon", "b_norm", "delta") + (("mse",) if mse else ())
    for key in keys:
        assert torch.equal(got[key], want[key]), key
    # the real guard refuses the chunks' 32-iteration horizon here
    assert (res > 0) == (chunks and guard == "always")
    assert ks + pairs + res > 0 and (ks == 0 or not mse)
    launched = 16 * res + 8 * ks + 2 * pairs + k1
    if guard == "always":
        # the discarded blocks' iterations ran and were redone
        assert launched > got["iterations_run"]
    else:
        assert launched == got["iterations_run"]


@pytest.mark.parametrize("shape,fista,mse,fits", [
    ((256, 256, 128, 128), True, False, True),    # config 4: 19 cubes, 76 GiB
    ((256, 256, 128, 128), True, True, False),    # + the reference cube
    ((264, 256, 128, 128), True, False, False),   # N0 + 8: 78.4 GiB
    ((256, 256, 128, 128), False, True, True),    # unaccelerated: 12 cubes
    ((256, 256, 2048), True, True, True),         # config 2 with a reference
], ids=str)
def test_stop_ckpt_byte_rule(shape, fista, mse, fits):
    """State + checkpoint (+ reference cube) against STOP_CKPT_MAX_BYTES,
    on shapes either side of it: a rule on shape, dtype and options."""
    n = len(shape)
    opts = TOptions(ndim=n, iterations_fista=8 if fista else 0,
                    iterations_unacc=0 if fista else 8,
                    stopping_relative_change=1e-3, calculate_mse=mse)
    cubes = 1 + 2 * (1 + n + (n if fista else 0)) + int(mse)
    got = tengine.stop_ckpt_bytes(opts, shape, torch.float32)
    assert got == cubes * int(np.prod(shape)) * 4
    assert (got <= tengine.STOP_CKPT_MAX_BYTES) is fits


@pytest.mark.parametrize("side", ["below", "at"])
def test_stop_run_above_byte_rule_stays_on_k1_loop(monkeypatch, side):
    """With the rule set one byte below a run's state and checkpoint, its
    stop-aware run makes no K-step or pair launch; at its bytes it does.
    Both equal the one-iteration loop bitwise."""
    monkeypatch.setattr(tengine, "PAIR_MIN_ROW_BYTES", 0)
    shape, iters, stop_at = (16, 6, 64), (48, 0), 40
    cube, li, lm, _, thr = _stop_case(shape, iters, stop_at, False)
    opts = TOptions(ndim=3, iterations_fista=iters[0], iterations_unacc=0,
                    stopping_relative_change=thr, vmem_resident=False)
    need = tengine.stop_ckpt_bytes(opts, shape, torch.float32)
    monkeypatch.setattr(tengine, "STOP_CKPT_MAX_BYTES",
                        need - 1 if side == "below" else need)
    before = [c.calls for c in COUNTERS]
    got = tengine.run_solver(cube, li, lm, opts)
    ks, pairs, _, _ = (c.calls - b for c, b in zip(COUNTERS, before))
    assert (ks + pairs == 0) == (side == "below")
    want = tengine.run_solver(cube, li, lm,
                              dataclasses.replace(opts, temporal_pairs=False))
    assert got["iterations_run"] == want["iterations_run"] == stop_at + 1
    for key in ("recon", "b_norm", "delta"):
        assert torch.equal(got[key], want[key]), key
