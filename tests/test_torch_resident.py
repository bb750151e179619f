"""The port's whole-run kernel (``cytvdn_tpu_torch.kernels.resident``), the
engine's whole-run path and its stop-aware chunks against the JAX
package's whole-run kernel, run as the JAX tests run it on the CPU
(interpret mode, tests/test_resident.py), and against the JAX engine.

On the CPU the port's wrapper runs its plain version (T plain iterations);
the CUDA kernel itself is held bitwise against that plain version on the
card (tests/test_torch_cuda.py and ``chip_smoke.py``). Tolerances: state
rtol 2e-5 / atol 2e-6 in float32 (tests/test_pallas.py), sums rtol 1e-5;
whole runs: recon rtol 2e-5, b_norm rtol 1e-5, delta rtol 1e-4
(tests/test_resident.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

import cytvdn_tpu.kernels.resident as JR  # noqa: E402
from cytvdn_tpu.config import Backend as JBackend  # noqa: E402
from cytvdn_tpu.config import SolverOptions as JOptions  # noqa: E402
from cytvdn_tpu.solver import engine as jengine  # noqa: E402
from cytvdn_tpu_torch.config import SolverOptions as TOptions  # noqa: E402
from cytvdn_tpu_torch.kernels import fused as tfused  # noqa: E402
from cytvdn_tpu_torch.kernels import kstep as tkstep  # noqa: E402
from cytvdn_tpu_torch.kernels import resident as tres  # noqa: E402
from cytvdn_tpu_torch.kernels import temporal as ttemporal  # noqa: E402
from cytvdn_tpu_torch.solver import engine as tengine  # noqa: E402
from cytvdn_tpu_torch.utils.state import state_from_numpy, state_to_numpy  # noqa: E402

RTOL, ATOL, SUM_RTOL = 2e-5, 2e-6, 1e-5
COUNTERS = (tres.resident_solve, tkstep.fused_kstep_iteration,
            ttemporal.fused_pair_iteration, tfused.fused_iteration)


def _cube(shape, seed):
    """The cube and clip radii of tests/test_resident.py::_state."""
    rng = np.random.default_rng(seed)
    ndim = len(shape)
    orig = (rng.standard_normal(shape) * 0.4 + 1.0).astype(np.float32)
    li = np.full(ndim, 32.0, np.float32)
    lm = np.full(ndim, 1 / 32.0, np.float32)
    return orig, li, lm


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _fresh(orig, fista):
    """A fresh port state: recon a copy of orig, zero accumulators (and
    shadow duals)."""
    o = torch.from_numpy(orig)
    accs = [torch.zeros_like(o) for _ in range(o.dim())]
    ds = [torch.zeros_like(o) for _ in range(o.dim())] if fista else None
    return o, o.clone(), accs, ds


def _split():
    return [c.calls for c in COUNTERS]


# (shape, bc, rhos, iso_r, iso_q, with ref): FISTA, unaccelerated and hybrid
# momentum schedules (zeros at the end), every BC, iso pairs, the SSE trace
_RAMP = np.linspace(0.0, 0.6, 5).astype(np.float32)
_HYBRID = np.array([0.0, 0.28, 0.43, 0.0, 0.0], np.float32)
KERNEL_CASES = [
    ((8, 6, 64), 2, _RAMP, False, False, False),
    ((8, 6, 64), 2, None, False, False, False),
    ((8, 6, 64), 2, _HYBRID, False, False, True),
    ((8, 6, 64), 0, _RAMP, False, False, False),
    ((8, 6, 64), 1, None, False, False, True),
    ((8, 6, 64), 1, _HYBRID, False, False, False),
    ((6, 4, 6, 16), 2, _RAMP, False, False, True),
    ((6, 4, 6, 16), 2, None, False, False, False),
    ((6, 4, 6, 16), 0, _HYBRID, False, False, False),
    ((6, 4, 6, 16), 1, _RAMP, False, False, False),
    ((6, 4, 6, 16), 2, _RAMP, True, False, False),
    ((6, 4, 6, 16), 2, None, False, True, True),
    ((6, 4, 6, 16), 2, _HYBRID, True, True, False),
]


@pytest.mark.parametrize("shape,bc,rhos,iso_r,iso_q,with_ref", KERNEL_CASES,
                         ids=str)
def test_resident_matches_pallas_resident(shape, bc, rhos, iso_r, iso_q,
                                          with_ref):
    """A fresh five-iteration run through both whole-run kernels."""
    fista = rhos is not None
    n = 5
    orig, li, lm = _cube(shape, seed=sum(shape) + bc)
    ref = (np.random.default_rng(1).standard_normal(shape)
           .astype(np.float32)) if with_ref else None
    want = JR.resident_solve(
        jnp.asarray(orig), jnp.asarray(rhos if fista else np.zeros(n)),
        jnp.asarray(li), jnp.asarray(lm), n_iters=n, fista=fista,
        interpret=True, bc=bc, ref=jnp.asarray(ref) if with_ref else None,
        iso_r=iso_r, iso_q=iso_q)

    o, recon, accs, ds = _fresh(orig, fista)
    calls = tres.resident_solve.calls
    got = tres.resident_solve(
        o, recon, accs, ds, torch.from_numpy(rhos) if fista else None,
        torch.from_numpy(li), torch.from_numpy(lm), n_iters=n, fista=fista,
        bc=bc, ref=torch.from_numpy(ref) if with_ref else None, iso_r=iso_r,
        iso_q=iso_q)
    assert tres.resident_solve.calls == calls + 1
    assert len(got) == len(want) == (7 if with_ref else 6)
    assert got[0] is recon and got[1] is accs  # updated in place
    _close(recon.numpy(), want[0])
    for k in range(len(shape)):
        _close(accs[k].numpy(), want[1][k])
        if fista:
            _close(ds[k].numpy(), want[2][k])
    for g, w in zip(got[3:], want[3:]):
        assert g.shape == (n,)
        _close(g.numpy(), w, rtol=SUM_RTOL, atol=0)


def test_resident_resumes_jax_engine_state():
    """A JAX FISTA run stopped after 5 iterations (keep_state) and resumed
    in the port for 3 more in one whole-run call equals the 8-iteration JAX
    run (the state travels through utils/state.py)."""
    shape = (8, 6, 64)
    orig, li, lm = _cube(shape, seed=19)

    def jrun(n):
        opts = JOptions(ndim=3, iterations_fista=n, iterations_unacc=0,
                        backend=JBackend.PALLAS)
        out = jengine.run_solver(jnp.asarray(orig), jnp.asarray(li),
                                 jnp.asarray(lm), opts, keep_state=True)
        return {k: (tuple(np.asarray(x) for x in v) if isinstance(v, tuple)
                    else np.asarray(v)) for k, v in out.items()}

    part, full = jrun(5), jrun(8)
    st = state_from_numpy(part, "cpu")
    assert st["i"] == 5
    rhos = torch.as_tensor(tengine.fista_tk_ratios(8), dtype=torch.float32)
    out = tres.resident_solve(
        torch.from_numpy(orig), st["recon"], st["accs"], st["ds"], rhos[5:8],
        torch.from_numpy(li), torch.from_numpy(lm), n_iters=3, fista=True,
        bc=2)
    back = state_to_numpy(st)
    _close(back["recon"], full["recon"])
    for q in range(3):
        _close(back["accs"][q], full["accs"][q])
        _close(back["ds"][q], full["ds"][q])
    _close(out[3].numpy(), full["b_norm"][5:8], rtol=SUM_RTOL, atol=0)
    _close((out[4] / out[5]).numpy(), full["delta"][5:8], rtol=SUM_RTOL,
           atol=0)


# (shape, iterations, MSE): fixed, unaccelerated, hybrid and MSE schedules
# of tests/test_resident.py
SCHEDULES = [
    ((8, 6, 64), (5, 0), False),
    ((8, 6, 64), (0, 6), False),
    ((8, 6, 64), (3, 4), False),
    ((6, 4, 6, 16), (4, 0), False),
    ((6, 4, 6, 16), (0, 3), True),
    ((8, 6, 64), (3, 4), True),
]


@pytest.mark.parametrize("shape,iters,mse", SCHEDULES, ids=str)
def test_solver_whole_run_matches_jax_resident_solver(shape, iters, mse):
    """``run_solver`` makes one whole-run call and no other kernel call,
    and matches the JAX engine's whole-run path."""
    orig, li, lm = _cube(shape, seed=7)
    ref = np.random.default_rng(24).standard_normal(shape).astype(
        np.float32) if mse else None
    base = dict(ndim=len(shape), iterations_fista=iters[0],
                iterations_unacc=iters[1], calculate_mse=mse)
    jopts = JOptions(**base, backend=JBackend.PALLAS)
    assert jengine._resolve_resident(jopts, shape, jnp.float32, None)[0]
    want = jengine.run_solver(jnp.asarray(orig), jnp.asarray(li),
                              jnp.asarray(lm), jopts,
                              reference_data=jnp.asarray(ref) if mse else None)
    before = _split()
    got = tengine.run_solver(torch.from_numpy(orig), torch.from_numpy(li),
                             torch.from_numpy(lm), TOptions(**base),
                             torch.from_numpy(ref) if mse else None)
    assert [c.calls - b for c, b in zip(COUNTERS, before)] == [1, 0, 0, 0]
    assert got["iterations_run"] == sum(iters) and not got["early_stopped"]
    _close(got["recon"].numpy(), want["recon"])
    _close(got["b_norm"].numpy(), want["b_norm"], rtol=1e-5, atol=0)
    _close(got["delta"].numpy(), want["delta"], rtol=1e-4, atol=0)
    if mse:
        assert got["mse"].shape == (sum(iters) + 1,)
        _close(got["mse"].numpy(), want["mse"], rtol=1e-5, atol=0)


def _stopping(orig, li, lm, iters, stop_at):
    """The threshold of tests/test_resident.py::_stop_case: between the
    deltas of iterations stop_at-1 and stop_at of the full run."""
    probe = jengine.run_solver(
        jnp.asarray(orig), jnp.asarray(li), jnp.asarray(lm),
        JOptions(ndim=3, iterations_fista=iters[0], iterations_unacc=iters[1],
                 backend=JBackend.PALLAS, vmem_resident=False,
                 temporal_pairs=False))
    d = np.asarray(probe["delta"])
    assert d[stop_at] > 0 and d[stop_at] < d[stop_at - 1]
    return float(np.sqrt(d[stop_at] * min(d[stop_at - 1], d[stop_at] * 4)))


@pytest.mark.parametrize("iters,stop_at,n_chunks",
                         [((60, 0), 45, 1), ((0, 60), 50, 0),
                          ((0, 200), 150, 7)])
def test_stop_aware_chunks_match_jax(iters, stop_at, n_chunks):
    """Stop-aware runs: a K=1 prologue, whole-run chunks where the guard
    allows them and single K=1 steps where it refuses, then the K=1 loop's
    exact stop; the same stop and recon as the JAX engine's stop-aware
    resident chunks. The FISTA run's first deltas plateau, so the guard
    lets one chunk run; the unaccelerated runs decay fast at first, so the
    guard refuses until their decay slows, which the 60-iteration run does
    not reach and the 200-iteration run does."""
    shape = (8, 6, 64)
    orig, li, lm = _cube(shape, seed=23)
    stopping = _stopping(orig, li, lm, iters, stop_at)
    base = dict(ndim=3, iterations_fista=iters[0], iterations_unacc=iters[1],
                stopping_relative_change=stopping)
    jopts = JOptions(**base, backend=JBackend.PALLAS)
    assert jengine._resolve_resident_chunks(jopts, shape, jnp.float32,
                                            None)[0]
    want = jengine.run_solver(jnp.asarray(orig), jnp.asarray(li),
                              jnp.asarray(lm), jopts)
    topts = TOptions(**base)
    assert tengine._resolve_resident_chunks(topts, shape, torch.float32)
    assert not tengine._resolve_resident(topts, shape, torch.float32)
    before = _split()
    got = tengine.run_solver(torch.from_numpy(orig), torch.from_numpy(li),
                             torch.from_numpy(lm), topts)
    chunks, ksteps, pairs, k1 = (c.calls - b for c, b in
                                 zip(COUNTERS, before))
    assert (chunks, ksteps, pairs) == (n_chunks, 0, 0)
    assert got["iterations_run"] == stop_at + 1 == 16 * chunks + k1
    assert got["iterations_run"] == int(want["iterations_run"])
    assert got["early_stopped"] == bool(want["early_stopped"])
    _close(got["recon"].numpy(), want["recon"])
    _close(got["delta"].numpy(), want["delta"], rtol=1e-4, atol=0)
    _close(got["b_norm"].numpy(), want["b_norm"], rtol=1e-5, atol=0)


def test_resident_chunk_bails_exactly_on_guard_beat():
    """When a delta crosses the threshold inside a chunk (the guard
    beaten), the chunk is discarded: state, traces, index and stop latch
    are bitwise as before, so the K=1 loop redoes those iterations (the
    port's analogue of tests/test_resident.py's guard-beat test)."""
    shape = (8, 6, 64)
    orig, li, lm = _cube(shape, seed=7)
    n = 40
    o = torch.from_numpy(orig)
    # a recorded plateau (d1 = d2 = 1, so r = 1 and the guard predicts 1 >=
    # 0.5) lets the chunk run; a fresh state's deltas are far below 0.5
    delta = torch.zeros(n)
    delta[:2] = 1.0
    st = tengine._PhaseState(
        i=2, done=False, recon=o.clone(),
        accs=[torch.zeros_like(o) for _ in range(3)], ds=None,
        b_norm=torch.zeros(n), delta=delta, mse=None, tk=torch.ones(()))
    before = [x.clone() for x in (st.recon, *st.accs, st.b_norm, st.delta)]
    opts = TOptions(ndim=3, iterations_fista=0, iterations_unacc=n,
                    stopping_relative_change=0.5)
    calls = tres.resident_solve.calls
    tengine._run_phase_resident(False, n, st, o, torch.zeros(1),
                                torch.from_numpy(li), torch.from_numpy(lm),
                                opts, None)
    assert tres.resident_solve.calls == calls + 1, "the chunk must run"
    assert st.i == 2 and not st.done
    for a, b in zip((st.recon, *st.accs, st.b_norm, st.delta), before):
        assert torch.equal(a, b)


def test_guard_matches_jax_prediction():
    """The host guard in float32 against the JAX predicates' arithmetic at
    the engine's horizons: 2T = 32 for a whole-run chunk, 2K = 16 for a
    K=8 launch (``d1 * r ** h``, repeated squaring) and 4 for a pair, where
    the JAX paired loop multiplies ``d1 * r * r * r * r`` in turn."""
    T = tengine._RESIDENT_CHUNK
    cases = ((0.5, 0.5, 0.4), (1e-3, 2e-3, 1e-12), (1e-3, 2e-3, 1e-9),
             (0.9, 0.91, 0.6), (0.0, 0.1, 0.0), (0.1, 0.0, 0.0),
             (2e-3, 1e-3, 1e-3), (0.02, 0.021, 0.0163), (0.02, 0.021, 0.0165),
             (0.02, 0.021, 0.009), (0.3, 0.5, 0.04), (0.3, 0.5, 0.0002))
    allowed = {}
    for horizon in (4, 16, 2 * T):
        for d1, d2, thr in cases:
            r = jnp.clip(jnp.float32(d1) / jnp.float32(d2 if d2 > 0 else 1.0),
                         0.0, 1.0)
            want = bool(d1 > 0 and d2 > 0 and
                        jnp.float32(d1) * r ** horizon >= jnp.float32(thr))
            if horizon == 4:
                pair = bool(d1 > 0 and d2 > 0 and
                            jnp.float32(d1) * r * r * r * r
                            >= jnp.float32(thr))
                assert pair == want, (d1, d2, thr)
            got = tengine._guard_allows(d1, d2, thr, horizon)
            assert got == want, (d1, d2, thr, horizon)
            allowed[horizon] = allowed.get(horizon, 0) + got
    # a longer horizon never allows more, and these cases tell them apart
    assert allowed[4] > allowed[16] > allowed[2 * T] > 0


def _gate_variants():
    """(ndim, jax options, port options) for the whole-run gate: the knob
    off, restart, each BC, iso pairs, MSE, the plain backends, stop runs
    and short runs (the chunk gate)."""
    out = []
    for ndim in (3, 4):
        kws = [dict(), dict(vmem_resident=False), dict(fista_restart=True),
               dict(bc_mode=0), dict(bc_mode=1), dict(calculate_mse=True),
               dict(stopping_relative_change=0.01),
               dict(iterations_fista=0, iterations_unacc=20),
               dict(iterations_fista=10, iterations_unacc=10)]
        if ndim == 4:
            kws += [dict(isotropic_R=True), dict(isotropic_Q=True),
                    dict(isotropic_R=True, bc_mode=0)]
        for kw in kws:
            out.append((ndim, dict(kw, backend=JBackend.PALLAS), kw))
        out.append((ndim, dict(backend=JBackend.JAX), dict(backend="torch")))
    return out


@pytest.mark.parametrize("ndim,jkw,tkw", _gate_variants(), ids=str)
def test_resident_gates_match_jax(ndim, jkw, tkw):
    """The port's whole-run and chunk gates against the JAX engine's on one
    device (its ``backend="pallas"`` decision), float32 and float64, on
    shapes the JAX plan holds without the 3D flat fold, N0 = 1 refused."""
    base = dict(ndim=ndim, iterations_fista=8, iterations_unacc=0)
    jopts = JOptions(**dict(base, **jkw))
    topts = TOptions(**dict(base, **tkw))
    shapes = [(8, 6, 64), (2, 6, 64), (1, 6, 64)] if ndim == 3 \
        else [(6, 4, 6, 16), (2, 3, 6, 16), (1, 4, 6, 16)]
    for shape in shapes:
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.float64, torch.float64)):
            for jfn, tfn in ((jengine._resolve_resident,
                              tengine._resolve_resident),
                             (jengine._resolve_resident_chunks,
                              tengine._resolve_resident_chunks)):
                assert tfn(topts, shape, tdt) == jfn(jopts, shape, jdt,
                                                     None)[0], (shape, tdt)


def test_resident_size_rule():
    """What the port decides on its own: the state must fit
    RESIDENT_BYTES. Config 1 (64x64x512) unaccelerated is 41.9 MB."""
    f32 = torch.float32
    assert tres.resident_state_bytes((64, 64, 512), False, False) == \
        5 * 64 * 64 * 512 * 4
    assert tres.resident_state_bytes((64, 64, 512), True, True) == \
        9 * 64 * 64 * 512 * 4
    assert tres.resident_state_bytes((6, 4, 6, 16), True, False) == \
        10 * 6 * 4 * 6 * 16 * 4
    cfg1 = dict(ndim=3, iterations_fista=0, iterations_unacc=7500)
    for shape, fista, mse in (((64, 64, 512), False, False),
                              ((64, 64, 512), True, False),
                              ((64, 64, 512), False, True),
                              ((64, 64, 1024), False, False),
                              ((256, 256, 2048), True, False),
                              ((128, 128, 64, 64), True, False)):
        fits = tres.resident_state_bytes(shape, fista, mse) <= \
            tres.RESIDENT_BYTES
        assert tres.resident_supported(shape, f32, 2, fista,
                                       with_mse=mse) == fits
    assert tres.resident_supported((64, 64, 512), f32, 2, False)
    assert tengine._resolve_resident(TOptions(**cfg1), (64, 64, 512), f32)
    assert not tres.resident_supported((256, 256, 2048), f32, 2, True)
    # config 1 through denoise3D: one whole-run call and no other
    from cytvdn_tpu_torch import denoise3D

    before = _split()
    cube = _cube((8, 6, 64), seed=3)[0]
    denoise3D(cube, np.full(3, 1.0, np.float32), iterations=12, quiet=True,
              device="cpu")
    assert [c.calls - b for c, b in zip(COUNTERS, before)] == [1, 0, 0, 0]


@pytest.mark.parametrize("shape,want", [
    # lanes per row segment: the least power of two (at most 32) whose four
    # elements each cover the last axis; tiles of 256 / lanes rows
    ((64, 64, 512), 64 * 8 * 4),        # config 1: 32 lanes, 8 x 128 tiles
    ((256, 256, 128, 128), 256 * 256 * 16),
    ((13, 17, 70), 13 * 3),             # 32 lanes, 70 of 128 columns
    ((3, 9, 129), 3 * 2 * 2),           # one column past a 128 tile
    ((37, 45, 19, 23), 37 * 45),        # 8 lanes: one 32 x 32 tile
    ((2, 3, 7, 5), 6),                  # 2 lanes: one 128 x 8 tile
    ((3, 1, 1), 3),                     # 1 lane: one 256 x 4 tile
])
def test_resident_work_items(shape, want):
    """The whole-run kernel's own (row, tile) count, which the wrapper
    holds below 2**31 for its 32-bit index arithmetic."""
    assert tres.resident_work_items(shape) == want


def test_resident_wrapper_rejects_what_the_kernel_does_not_take():
    t = torch.from_numpy
    orig, li, lm = _cube((4, 5, 6), seed=4)
    o, recon, accs, ds = _fresh(orig, True)
    rhos = torch.full((3,), 0.5)
    args = (o, recon, accs, ds, rhos, t(li), t(lm))
    calls = tres.resident_solve.calls
    with pytest.raises(ValueError, match="does not cover"):
        tres.resident_solve(
            *(x.double() if isinstance(x, torch.Tensor) else
              [y.double() for y in x] for x in args), n_iters=3, fista=True,
            bc=2)
    with pytest.raises(ValueError, match="does not cover"):
        tres.resident_solve(*args, n_iters=3, fista=True, bc=2, iso_r=True)
    with pytest.raises(ValueError, match="does not cover"):
        tres.resident_solve(*args, n_iters=0, fista=True, bc=2)
    thin = [x[:1] for x in (o, recon)]
    with pytest.raises(ValueError, match="does not cover"):
        tres.resident_solve(*thin, [a[:1] for a in accs], [d[:1] for d in ds],
                            *args[4:], n_iters=3, fista=True, bc=2)
    with pytest.raises(ValueError, match="ds"):
        tres.resident_solve(*args[:3], [d.to(torch.bfloat16) for d in ds],
                            *args[4:], n_iters=3, fista=True, bc=2)
    with pytest.raises(ValueError, match="ref"):
        tres.resident_solve(*args, n_iters=3, fista=True, bc=2,
                            ref=o[:2].clone())
    assert tres.resident_solve.calls == calls
