"""The port's K-step kernel (``cytvdn_tpu_torch.kernels.kstep``) and the
engine's K-step phase against the JAX package's K-step kernel, run as the
JAX tests run it on the CPU (interpret mode, tests/test_kstep.py), and
against the JAX engine.

On the CPU the port's wrapper runs its plain version (K plain iterations);
the CUDA kernel itself is held bitwise against that plain version on the
card (tests/test_torch_cuda.py and ``chip_smoke.py``). Tolerances: state
rtol 2e-5 / atol 2e-6 in float32 (tests/test_pallas.py), sums rtol 1e-5;
whole runs: recon rtol 2e-5, b_norm rtol 1e-5, delta rtol 1e-4
(tests/test_kstep.py). States are random and keep each accumulator's
leading slab along its own axis at zero, the Jia-Zhao invariant both
K-step kernels rely on.
"""

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

import cytvdn_tpu.kernels.kstep as KS  # noqa: E402
from cytvdn_tpu.config import Backend as JBackend  # noqa: E402
from cytvdn_tpu.config import SolverOptions as JOptions  # noqa: E402
from cytvdn_tpu.solver import engine as jengine  # noqa: E402
from cytvdn_tpu_torch import ops as tops  # noqa: E402
from cytvdn_tpu_torch.config import SolverOptions as TOptions  # noqa: E402
from cytvdn_tpu_torch.kernels import fused as tfused  # noqa: E402
from cytvdn_tpu_torch.kernels import kstep as tkstep  # noqa: E402
from cytvdn_tpu_torch.kernels import temporal as ttemporal  # noqa: E402
from cytvdn_tpu_torch.solver import engine as tengine  # noqa: E402
from cytvdn_tpu_torch.utils import perf  # noqa: E402
from cytvdn_tpu_torch.utils.state import state_from_numpy, state_to_numpy  # noqa: E402

RTOL, ATOL, SUM_RTOL = 2e-5, 2e-6, 1e-5


def _state(shape, fista, seed):
    """Random Jia-Zhao state in the clip ball's range, with clip radii small
    enough that the projections bind."""
    rng = np.random.default_rng(seed)
    ndim = len(shape)
    orig = (rng.standard_normal(shape) * 0.5 + 2.0).astype(np.float32)
    recon = (orig + rng.standard_normal(shape) * 0.05).astype(np.float32)
    accs = [(rng.standard_normal(shape) * 0.2).astype(np.float32)
            for _ in range(ndim)]
    ds = [(rng.standard_normal(shape) * 0.2).astype(np.float32)
          for _ in range(ndim)] if fista else None
    for k in range(ndim):
        idx = [slice(None)] * ndim
        idx[k] = 0
        accs[k][tuple(idx)] = 0
        if fista:
            ds[k][tuple(idx)] = 0
    lambda_inv = np.linspace(0.2, 0.35, ndim).astype(np.float32)
    lam_mu = np.linspace(1 / 32, 1 / 48, ndim).astype(np.float32)
    return orig, recon, accs, ds, lambda_inv, lam_mu


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# (shape, K, fista): the cases of tests/test_kstep.py
CASES = [
    ((8, 6, 64), 3, True),
    ((8, 6, 64), 3, False),
    ((8, 6, 64), 4, True),
    ((16, 6, 64), 6, True),
    ((16, 6, 64), 8, False),
    ((8, 4, 6, 16), 3, True),
    ((8, 4, 6, 16), 4, False),
    ((6, 5, 256), 3, True),
]


@pytest.mark.parametrize("shape,k,fista", CASES)
def test_kstep_matches_pallas_kstep(shape, k, fista):
    """Two launches with distinct momentum ratios from a random state."""
    orig, recon, accs, ds, li, lm = _state(shape, fista, seed=sum(shape) + k)
    rhos = np.linspace(0.0, 0.6, 2 * k).astype(np.float32)

    r, a = jnp.asarray(recon), tuple(jnp.asarray(x) for x in accs)
    d = tuple(jnp.asarray(x) for x in ds) if fista else None
    want_sums = []
    for i in (0, k):
        out = KS.fused_kstep_iteration(
            jnp.asarray(orig), r, a, d, jnp.asarray(rhos[i:i + k]),
            jnp.asarray(li), jnp.asarray(lm), k=k, fista=fista,
            interpret=True)
        r, a, d = out[:3]
        want_sums += np.stack([np.asarray(x) for x in out[3:]], 1).tolist()

    t = torch.from_numpy
    o, tr = t(orig), t(recon.copy())
    ta = [t(x.copy()) for x in accs]
    td = [t(x.copy()) for x in ds] if fista else None
    calls = tkstep.fused_kstep_iteration.calls
    got_sums = []
    for i in (0, k):
        out = tkstep.fused_kstep_iteration(
            o, tr, ta, td, t(rhos[i:i + k]), t(li), t(lm), k=k, fista=fista)
        got_sums += torch.stack(out[3:], 1).tolist()
    assert tkstep.fused_kstep_iteration.calls == calls + 2

    _close(tr.numpy(), r)
    for q in range(len(shape)):
        _close(ta[q].numpy(), a[q])
        if fista:
            _close(td[q].numpy(), d[q])
    _close(got_sums, want_sums, rtol=SUM_RTOL, atol=0)


def test_kstep_resumes_jax_engine_state():
    """A JAX K-step FISTA run stopped after 8 iterations (keep_state) and
    resumed for two K=4 launches in the port equals the 16-iteration JAX
    run."""
    shape = (16, 6, 64)
    cube = _state(shape, False, seed=79)[0]
    li = np.full(3, 16.0, np.float32)
    lm = np.full(3, 1 / 16.0, np.float32)

    def jrun(n):
        opts = JOptions(ndim=3, iterations_fista=n, iterations_unacc=0,
                        backend=JBackend.PALLAS, temporal_k=4,
                        vmem_resident=False)
        out = jengine.run_solver(jnp.asarray(cube), jnp.asarray(li),
                                 jnp.asarray(lm), opts, keep_state=True)
        return {k: (tuple(np.asarray(x) for x in v) if isinstance(v, tuple)
                    else np.asarray(v)) for k, v in out.items()}

    part, full = jrun(8), jrun(16)
    st = state_from_numpy(part, "cpu")
    assert st["i"] == 8
    rhos = torch.as_tensor(tengine.fista_tk_ratios(16), dtype=torch.float32)
    bn, dl = [], []
    for i in (8, 12):
        out = tkstep.fused_kstep_iteration(
            torch.from_numpy(cube), st["recon"], st["accs"], st["ds"],
            rhos[i:i + 4], torch.from_numpy(li), torch.from_numpy(lm), k=4,
            fista=True)
        bn += out[3].tolist()
        dl += (out[4] / out[5]).tolist()
    back = state_to_numpy(st)
    _close(back["recon"], full["recon"])
    for q in range(3):
        _close(back["accs"][q], full["accs"][q])
        _close(back["ds"][q], full["ds"][q])
    _close(bn, full["b_norm"][8:16], rtol=SUM_RTOL, atol=0)
    _close(dl, full["delta"][8:16], rtol=SUM_RTOL, atol=0)


# (iterations, temporal_k, the port's (K-step, pair, K=1) launches): the
# schedules of tests/test_kstep.py; the automatic depth at (16, 6, 64) is 8
SCHEDULES = [
    ((7, 0), 3, (2, 0, 1)),     # K=3 x2 + K=1
    ((0, 9), 4, (2, 0, 1)),     # unaccelerated, K=4 x2 + K=1
    ((8, 5), None, (1, 2, 1)),  # hybrid: K=8 x1 | pairs x2 + K=1
    ((11, 0), 3, (3, 1, 0)),    # K=3 x3 + a pair
    ((3, 0), None, (0, 1, 1)),  # a phase shorter than the depth
    ((5, 2), 4, (1, 1, 1)),     # K=4 + K=1 | a pair
]


@pytest.mark.parametrize("iters,tk,split", SCHEDULES, ids=str)
def test_solver_kstep_matches_jax_kstep_solver(monkeypatch, iters, tk, split):
    # pairs take the remainders as in the JAX engine: the port's row-size
    # rule, which keeps rows this small off the pairs, is lifted
    monkeypatch.setattr(tengine, "PAIR_MIN_ROW_BYTES", 0)
    shape = (16, 6, 64)
    cube = _state(shape, False, seed=3)[0]
    li = np.full(3, 16.0, np.float32)
    lm = np.full(3, 1 / 16.0, np.float32)
    base = dict(ndim=3, iterations_fista=iters[0], iterations_unacc=iters[1],
                temporal_k=tk)
    want = jengine.run_solver(
        jnp.asarray(cube), jnp.asarray(li), jnp.asarray(lm),
        JOptions(**base, backend=JBackend.PALLAS, vmem_resident=False))
    counters = (tkstep.fused_kstep_iteration, ttemporal.fused_pair_iteration,
                tfused.fused_iteration)
    before = [c.calls for c in counters]
    # the whole-run kernel would take these small cubes: off, so the
    # K-step phase runs
    got = tengine.run_solver(torch.from_numpy(cube), torch.from_numpy(li),
                             torch.from_numpy(lm),
                             TOptions(**base, vmem_resident=False))
    assert tuple(c.calls - b for c, b in zip(counters, before)) == split
    assert got["iterations_run"] == sum(iters)
    _close(got["recon"].numpy(), want["recon"])
    _close(got["b_norm"].numpy(), want["b_norm"], rtol=1e-5, atol=0)
    _close(got["delta"].numpy(), want["delta"], rtol=1e-4, atol=0)


def _stopping(cube, li, lm, iters, stop_at):
    """A threshold between the deltas of iterations ``stop_at - 1`` and
    ``stop_at`` of the JAX engine's one-iteration run (the rule of
    tests/test_temporal.py::_stop_case), so the stop lands mid-run."""
    probe = jengine.run_solver(
        jnp.asarray(cube), jnp.asarray(li), jnp.asarray(lm),
        JOptions(ndim=cube.ndim, iterations_fista=iters[0],
                 iterations_unacc=iters[1], backend=JBackend.PALLAS,
                 vmem_resident=False, temporal_pairs=False))
    d = np.asarray(probe["delta"])
    assert d[stop_at] > 0 and d[stop_at] < d[stop_at - 1], d
    return float(np.sqrt(d[stop_at] * min(d[stop_at - 1], d[stop_at] * 4)))


@pytest.mark.parametrize("iters,stop_at,tk", [
    ((48, 0), 40, 3),      # stop mid-FISTA, forced K=3
    ((0, 48), 40, 4),      # unaccelerated, forced K=4
    ((48, 0), 40, None),   # the default depth, K=8
    ((10, 40), 41, None),  # hybrid, the stop in the second phase
], ids=str)
def test_stop_aware_kstep_matches_jax(monkeypatch, iters, stop_at, tk):
    """Stop-aware runs through the K-step kernel against the JAX engine's
    stop-aware K-step run (tests/test_kstep.py::
    test_stop_aware_kstep_matches_unblocked): the same stop, recon and
    traces. The launches split as a two-step prologue per phase, K-steps
    behind the 2K-horizon guard, one-iteration steps where it refuses, and
    the exact stop; every launch's iterations are kept (no guard beat).
    (The stops lie late enough in the run for the guard to let K-steps
    run.)"""
    # pairs take what the K-steps leave, as in the JAX engine: the port's
    # row-size rule is lifted
    monkeypatch.setattr(tengine, "PAIR_MIN_ROW_BYTES", 0)
    shape = (16, 6, 64)
    cube = _state(shape, False, seed=3)[0]
    li = np.full(3, 16.0, np.float32)
    lm = np.full(3, 1 / 16.0, np.float32)
    stopping = _stopping(cube, li, lm, iters, stop_at)
    base = dict(ndim=3, iterations_fista=iters[0], iterations_unacc=iters[1],
                stopping_relative_change=stopping, temporal_k=tk,
                vmem_resident=False)
    want = jengine.run_solver(jnp.asarray(cube), jnp.asarray(li),
                              jnp.asarray(lm),
                              JOptions(**base, backend=JBackend.PALLAS))
    counters = (tkstep.fused_kstep_iteration, ttemporal.fused_pair_iteration,
                tfused.fused_iteration)
    before = [c.calls for c in counters]
    got = tengine.run_solver(torch.from_numpy(cube), torch.from_numpy(li),
                             torch.from_numpy(lm), TOptions(**base))
    ks, pairs, k1 = (c.calls - b for c, b in zip(counters, before))
    k = tk or 8
    assert ks > 0
    assert got["iterations_run"] == int(want["iterations_run"]) == stop_at + 1
    assert got["iterations_run"] == k * ks + 2 * pairs + k1
    assert got["early_stopped"] == bool(want["early_stopped"]) is True
    _close(got["recon"].numpy(), want["recon"])
    _close(got["b_norm"].numpy(), want["b_norm"], rtol=1e-5, atol=0)
    _close(got["delta"].numpy(), want["delta"], rtol=1e-4, atol=0)


def _gate_variants():
    """(ndim, jax options, port options) for the K-step gate: the knob
    off, a forced K=2, MSE, each non-Jia-Zhao BC, iso pairs, adaptive
    restart, the plain backends, forced depths, lossy duals (alone and at
    a forced depth), and the defaults."""
    out = []
    for ndim in (3, 4):
        kws = [dict(), dict(temporal_kstep=False), dict(temporal_k=2),
               dict(temporal_k=3), dict(temporal_k=4), dict(calculate_mse=True),
               dict(bc_mode=0), dict(bc_mode=1), dict(fista_restart=True),
               dict(temporal_pairs=False), dict(lossy_duals=True),
               dict(lossy_duals=True, temporal_k=3)]
        if ndim == 4:
            kws += [dict(isotropic_R=True), dict(isotropic_Q=True)]
        for kw in kws:
            out.append((ndim, dict(kw, backend=JBackend.PALLAS), kw))
        out.append((ndim, dict(backend=JBackend.JAX), dict(backend="torch")))
    return out


@pytest.mark.parametrize("ndim,jkw,tkw", _gate_variants(), ids=str)
def test_kstep_gate_matches_jax(ndim, jkw, tkw):
    """The port's ``_resolve_kstep`` against the JAX engine's decision on
    one device (the K-step runs only where the pair gate passes,
    ``engine.py:1515-1528``): float32 and float64, FISTA and unaccelerated
    phases, on shapes where the JAX VMEM plan fits, with N0 below 2K for
    the deeper depths."""
    base = dict(ndim=ndim, iterations_fista=8, iterations_unacc=0)
    jopts = JOptions(**dict(base, vmem_resident=False, **jkw))
    topts = TOptions(**dict(base, **tkw))
    shapes = [(16, 6, 64), (10, 6, 64), (5, 6, 64)] if ndim == 3 \
        else [(8, 4, 6, 16), (7, 4, 6, 16)]
    for shape in shapes:
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.float64, torch.float64)):
            for fista in (True, False):
                want = jengine._resolve_kstep(jopts, shape, jdt, None, fista) \
                    if jengine._resolve_temporal(jopts, shape, jdt, None) else 0
                got = tengine._resolve_kstep(topts, shape, tdt, fista)
                assert got == want, (shape, tdt, fista)


def test_kstep_gate_port_rules(monkeypatch):
    """What the port decides on its own: stop runs get the JAX engine's
    depth (their K-steps run behind the guard), a forced depth with no
    compiled kernel raises, and config 1 (64x64x512) gets a depth."""
    shape = (16, 6, 64)
    base = dict(ndim=3, iterations_fista=8, iterations_unacc=0)
    stop = dict(stopping_relative_change=1e-6)
    want = jengine._resolve_kstep(
        JOptions(**base, backend=JBackend.PALLAS, **stop), shape,
        jnp.float32, None, True)
    assert want >= 3
    assert tengine._resolve_kstep(TOptions(**base, **stop), shape,
                                  torch.float32, True) == want
    for k in (5, 7, 9, 16):
        with pytest.raises(ValueError, match="compiled for K"):
            tengine._resolve_kstep(TOptions(**base, temporal_k=k), shape,
                                   torch.float32, True)
    cfg1 = dict(ndim=3, iterations_fista=0, iterations_unacc=7500)
    assert tengine._resolve_kstep(TOptions(**cfg1), (64, 64, 512),
                                  torch.float32, False) == 8
    assert tkstep.best_kstep((64, 64, 512), torch.float32, 2, False) == 8
    # the H100 rule: the deepest depth the shape admits, at every size and
    # row (the BASELINE shapes, 1024x64x2048, rows of 16 MiB)
    for shp, fista in (((256, 256, 2048), True), ((128, 128, 64, 64), True),
                       ((256, 256, 128, 128), True), ((64, 64, 512), True),
                       ((1024, 64, 2048), False), ((128, 64, 2048), False)):
        assert tkstep.best_kstep(shp, torch.float32, 2, fista) == 8
        assert tkstep.best_kstep(shp, torch.float32, 2, fista, forced=6) == 6
    assert tkstep.best_kstep((11, 6, 64), torch.float32, 2, True) == 4
    assert tkstep.best_kstep((11, 6, 64), torch.float32, 2, True,
                             forced=8) == 0
    assert tkstep.best_kstep((16, 6, 64), torch.float32, 2, True,
                             forced=2) == 0
    assert tkstep.best_kstep((5, 6, 64), torch.float32, 2, True) == 0
    assert tkstep.best_kstep((16, 6, 64), torch.float64, 2, True) == 0
    assert tkstep.best_kstep((16, 6, 64), torch.float32, 0, True) == 0
    # stop runs through denoise3D K-step after their two-step prologue
    # (with the whole-run kernel off, which would take this small cube): 8
    # iterations leave 6, fewer than K, and 10 leave one launch
    from cytvdn_tpu_torch import denoise3D

    monkeypatch.setattr(tengine, "_resolve_resident", lambda *a: False)

    calls = tkstep.fused_kstep_iteration.calls
    cube = _state(shape, False, seed=6)[0]
    for n, launches in ((8, 0), (10, 1)):
        denoise3D(cube, np.full(3, 1.0, np.float32), iterations=n,
                  FISTA=True, stopping_relative_change=1e-9, quiet=True,
                  device="cpu")
        assert tkstep.fused_kstep_iteration.calls == calls + launches
        calls += launches
    denoise3D(cube, np.full(3, 1.0, np.float32), iterations=8, FISTA=True,
              quiet=True, device="cpu")
    assert tkstep.fused_kstep_iteration.calls == calls + 1


def test_kstep_wrapper_rejects_what_the_kernel_does_not_take():
    t = torch.from_numpy
    orig, recon, accs, ds, li, lm = _state((8, 5, 6), True, seed=4)
    rhos = torch.full((3,), 0.5)
    args = (t(orig), t(recon), [t(a) for a in accs], [t(d) for d in ds],
            rhos, t(li), t(lm))
    calls = tkstep.fused_kstep_iteration.calls
    with pytest.raises(ValueError, match="does not cover"):
        tkstep.fused_kstep_iteration(
            *(x.double() if isinstance(x, torch.Tensor) else
              [y.double() for y in x] for x in args), k=3, fista=True)
    for k in (5, 8):  # uncompiled; N0 = 8 < 2K
        with pytest.raises(ValueError, match="does not cover"):
            tkstep.fused_kstep_iteration(*args, k=k, fista=True)
    # bfloat16 ds (lossy duals) are taken with float32 FISTA data, all of
    # them (tests/test_torch_lossy_kstep.py), not mixed with float32 ones
    # and not with float64 data
    with pytest.raises(ValueError, match="ds"):
        tkstep.fused_kstep_iteration(
            *args[:3], [args[3][0].to(torch.bfloat16), *args[3][1:]],
            *args[4:], k=3, fista=True)
    with pytest.raises(ValueError, match="does not cover"):
        tkstep.fused_kstep_iteration(
            *(x.double() for x in args[:2]), [a.double() for a in args[2]],
            [d.to(torch.bfloat16) for d in args[3]],
            *(x.double() for x in args[4:]), k=3, fista=True)
    with pytest.raises(ValueError, match="per axis"):
        tkstep.fused_kstep_iteration(*args[:3], None, *args[4:], k=3,
                                     fista=True)
    assert tkstep.fused_kstep_iteration.calls == calls
    assert tkstep.kstep_supported((8, 5, 6), torch.float32, 2, 4, True)
    assert not tkstep.kstep_supported((8, 5, 6), torch.float32, 0, 4, True)
    assert not tkstep.kstep_supported((8, 5, 6), torch.float32, 2, 2, True)


def _replay_ksteps(orig, recon, accs, ds, rhos, li, lm, k, fista,
                   rows_per_stage, order):
    """``k`` iterations, in place on CPU tensors, by the CUDA kernel's
    schedule (:func:`kstep_stages`): each row operation computes the plain
    full-array update from the state it reads and commits only its rows.
    Within a stage the operations run in launch order ("forward"), in
    reverse, or all reading the stage's start state ("snapshot"). Returns
    the 3k sums in float64."""
    ndim = orig.dim()
    stages = {}
    for st, op, lo, hi in tkstep.kstep_stages(tuple(orig.shape), k,
                                              rows_per_stage):
        stages.setdefault(st, []).append((op, lo, hi))
    sums = [0.0] * (3 * k)
    for st in sorted(stages):
        items = stages[st][::-1] if order == "reverse" else stages[st]
        src = (recon, accs, ds)
        if order == "snapshot":
            src = (recon.clone(), [a.clone() for a in accs],
                   [d.clone() for d in ds] if fista else None)
        for op, lo, hi in items:
            r, a, d = src
            lev = op // 2
            if op % 2 == 0:
                for q in range(ndim):
                    if fista:
                        b_new, d_new, _ = tops.accumulator_update_fista(
                            r, a[q], d[q], rhos[lev], q, li[q])
                        ds[q][lo:hi] = d_new[lo:hi]
                    else:
                        b_new, _ = tops.accumulator_update(r, a[q], q, li[q])
                    accs[q][lo:hi] = b_new[lo:hi]
                    sums[3 * lev] += float(b_new[lo:hi].double().abs().sum())
            else:
                r_new, _, _ = tops.datacube_update(orig, r, a, lm)
                sums[3 * lev + 1] += float(
                    (r_new[lo:hi] - r[lo:hi]).double().abs().sum())
                sums[3 * lev + 2] += float(r[lo:hi].double().abs().sum())
                recon[lo:hi] = r_new[lo:hi]
    return sums


def _replay_cases():
    """(shape, K, fista, R): every depth at 1, 2 and 3 rows per stage, with
    N0 >= 2K not a multiple of R, in 3D and 4D, FISTA and unaccelerated."""
    cases = []
    for i, k in enumerate((3, 4, 6, 8)):
        for rr in (1, 2, 3):
            n0 = 2 * k + 1 if (2 * k + 1) % rr or rr == 1 else 2 * k + 2
            for j, (tail, fista) in enumerate((((5, 6), True),
                                               ((3, 4, 5), False))):
                fista = fista if (i + rr) % 2 else not fista
                cases.append(((n0, *tail), k, fista, rr))
    return cases


@pytest.mark.parametrize("shape,k,fista,rr", _replay_cases(), ids=str)
def test_kstep_stage_plan_replays_k_plain_iterations(shape, k, fista, rr):
    """The kernel's wavefront schedule at R rows per stage, replayed in
    place with the plain element updates in each of three orders within a
    stage, equals k plain iterations bitwise: every element is computed
    once at every level, and no operation reads a value another has already
    moved on."""
    orig, recon, accs, ds, li, lm = _state(shape, fista, seed=sum(shape) + rr)
    t = torch.from_numpy
    rhos = torch.linspace(0.0, 0.6, k)
    want = tkstep.fused_kstep_iteration_reference(
        t(orig), t(recon.copy()), [t(x.copy()) for x in accs],
        [t(x.copy()) for x in ds] if fista else None, rhos, t(li), t(lm),
        k=k, fista=fista)
    want_sums = torch.stack(want[3:], 1).reshape(-1).tolist()
    for order in ("forward", "reverse", "snapshot"):
        r = t(recon.copy())
        a = [t(x.copy()) for x in accs]
        d = [t(x.copy()) for x in ds] if fista else None
        got_sums = _replay_ksteps(t(orig), r, a, d, rhos, t(li), t(lm), k,
                                  fista, rr, order)
        assert torch.equal(r, want[0]), order
        for q in range(len(shape)):
            assert torch.equal(a[q], want[1][q]), (order, q)
            if fista:
                assert torch.equal(d[q], want[2][q]), (order, q)
        _close(got_sums, want_sums, rtol=SUM_RTOL, atol=0)


@pytest.mark.parametrize("n0,k", [(6, 3), (7, 3), (16, 8), (17, 8), (11, 4)])
def test_kstep_stage_plan_covers_each_row_once(n0, k):
    """At every R from 1 to N0 + 1, each row operation covers every row
    exactly once, in ceil(N0 / R) + 3K - 1 stages, and in each stage the
    ops that write recon and those that write b and d hold disjoint rows
    from those the others read across rows."""
    for rr in range(1, n0 + 2):
        seen = np.zeros((2 * k, n0), int)
        stages = {}
        for st, op, lo, hi in tkstep.kstep_stages((n0, 4, 4), k, rr):
            seen[op, lo:hi] += 1
            stages.setdefault(st, []).append((op, lo, hi))
        assert (seen == 1).all(), rr
        assert max(stages) == -(-n0 // rr) + 3 * k - 2
        for ops in stages.values():
            # rows written: recon by recon ops, b/d by dual ops; rows read
            # across rows: recon at lo-1 by duals, b at hi by recons
            w_r = {x for op, lo, hi in ops if op % 2 for x in range(lo, hi)}
            w_b = {x for op, lo, hi in ops if not op % 2
                   for x in range(lo, hi)}
            r_r = {x for op, lo, hi in ops if not op % 2
                   for x in range(lo - 1, hi)}
            r_b = {x for op, lo, hi in ops if op % 2
                   for x in range(lo, hi + 1)}
            assert not w_r & r_r and not w_b & r_b, (rr, ops)


@pytest.mark.parametrize("shape,rr", [
    ((64, 64, 512), 16),            # config 1: 128 KB rows
    ((1024, 64, 2048), 16),         # 512 KB rows
    ((256, 256, 2048), 16),         # config 2: 2 MiB rows
    ((128, 128, 64, 64), 16),       # config 3: 2 MiB rows
    ((64, 128, 128, 128), 4),       # 8 MiB rows
    ((256, 256, 128, 128), 2),      # config 4: 16 MiB rows
    ((8, 64, 512), 8),              # at most N0
    ((6, 1024, 16384), 1),          # 64 MiB rows: at least 1
])
def test_kstep_rows_rule(shape, rr):
    """R by the bytes of one array's axis-0 row: a 32 MiB super-row, from 1
    to 16 rows and at most N0."""
    assert tkstep.kstep_rows(shape) == rr


def test_kstep_wrapper_takes_rows_per_stage_on_the_cpu():
    """A forced R runs the plain version on the CPU (the result does not
    depend on it); R below 1 is refused."""
    t = torch.from_numpy
    orig, recon, accs, ds, li, lm = _state((7, 5, 6), True, seed=9)
    rhos = torch.linspace(0.1, 0.5, 3)
    outs = []
    for rr in (None, 1, 2, 3, 50):
        r, a, d = t(recon.copy()), [t(x.copy()) for x in accs], \
            [t(x.copy()) for x in ds]
        out = tkstep.fused_kstep_iteration(t(orig), r, a, d, rhos, t(li),
                                           t(lm), k=3, fista=True,
                                           rows_per_stage=rr)
        outs.append((r, torch.stack(out[3:])))
    for r, s in outs[1:]:
        assert torch.equal(r, outs[0][0]) and torch.equal(s, outs[0][1])
    for rr in (0, -1):
        with pytest.raises(ValueError, match="rows_per_stage"):
            tkstep.fused_kstep_iteration(t(orig), t(recon), [t(x) for x in accs],
                                         [t(x) for x in ds], rhos, t(li), t(lm),
                                         k=3, fista=True, rows_per_stage=rr)


def test_kstep_traffic_band_and_launch_bound():
    """The K-step band (two-pass top, one fused pass per K iterations at
    the floor) and the per-launch bound of all three kernels: each input
    read once and each output written once at 3.35 TB/s."""
    t = perf.traversals_per_iteration
    assert t(4, True, "kstep_upper") == 24
    assert t(4, True, "kstep_floor", 8) == 19 / 8
    assert t(3, False, "kstep_floor", 4) == 9 / 4
    assert t(4, True, "kstep_floor", 2) == t(4, True, "pair_floor")
    bw, f32 = 3.35e12, 67e12
    for shape, fista, iters, ms in (((256, 256, 128, 128), True, 1, 24.36),
                                    ((256, 256, 128, 128), True, 2, 24.36),
                                    ((256, 256, 2048), True, 8, 2.40),
                                    ((64, 64, 512), False, 8, 0.0225)):
        s, by = perf.launch_bound_seconds(shape, fista, iters, bw, f32)
        assert by == "bytes" and s * 1e3 == pytest.approx(ms, rel=3e-3)
    # operations bound only far beyond these depths
    s, by = perf.launch_bound_seconds((64, 64, 512), False, 1000, bw, f32)
    assert by == "operations"
    assert perf.peak_f32("NVIDIA H100 80GB HBM3") == 67e12
