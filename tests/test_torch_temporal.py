"""The port's pair kernel (``cytvdn_tpu_torch.kernels.temporal``) and the
engine's paired phase against the JAX package's pair kernel, run as the
JAX tests run it on the CPU (interpret mode, tests/test_temporal.py).

On the CPU the port's wrapper runs its plain version (two plain
iterations); the CUDA kernel itself is held bitwise against that plain
version on the card (tests/test_torch_cuda.py and ``chip_smoke.py``).
Tolerances: state rtol 2e-5 / atol 2e-6 in float32 (tests/test_pallas.py),
sums rtol 1e-5. States keep each accumulator's leading slab along its own
axis at zero, the Jia-Zhao invariant both pair kernels rely on.
"""

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

import cytvdn_tpu.kernels.fused as F  # noqa: E402
import cytvdn_tpu.kernels.temporal as T  # noqa: E402
from cytvdn_tpu.config import Backend as JBackend  # noqa: E402
from cytvdn_tpu.config import SolverOptions as JOptions  # noqa: E402
from cytvdn_tpu.solver import engine as jengine  # noqa: E402
from cytvdn_tpu_torch import ops as tops  # noqa: E402
from cytvdn_tpu_torch.config import SolverOptions as TOptions  # noqa: E402
from cytvdn_tpu_torch.kernels import temporal as ttemporal  # noqa: E402
from cytvdn_tpu_torch.solver import engine as tengine  # noqa: E402
from cytvdn_tpu_torch.utils.state import state_from_numpy, state_to_numpy  # noqa: E402

RTOL, ATOL, SUM_RTOL = 2e-5, 2e-6, 1e-5
RHOS = [0.0, 0.28, 0.43, 0.52]


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


# (shape, fista, fused-budget override (3D flat layout), pair block cap
# (strip seams)) — the cases of tests/test_temporal.py
CASES = [
    ((6, 4, 6, 16), True, None, None),      # 4D, single strip
    ((6, 4, 6, 16), False, None, None),
    ((7, 12, 6, 16), True, None, 16384),    # 4D, 3 strips
    ((7, 12, 6, 16), False, None, 16384),
    ((5, 24, 6, 16), True, None, 16384),    # many strips
    ((5, 24, 6, 16), True, None, 4096),     # single-column strips
    ((8, 6, 64), True, None, None),         # 3D single layout
    ((6, 5, 256), True, 3000, 4096),        # 3D flat fold, b1=1 strips
    ((6, 5, 256), False, 3000, None),       # 3D flat fold, single strip
]


@pytest.mark.parametrize("shape,fista,budget,cap", CASES)
def test_pair_matches_pallas_pair(monkeypatch, shape, fista, budget, cap):
    if budget is not None:
        monkeypatch.setattr(F, "_BLOCK_BYTES_TARGET", budget)
    if cap is not None:
        monkeypatch.setattr(T, "_PAIR_BLOCK_CAP", cap)
    orig, recon, accs, ds, li, lm = _state(shape, fista, seed=sum(shape))

    r, a = jnp.asarray(recon), tuple(jnp.asarray(x) for x in accs)
    d = tuple(jnp.asarray(x) for x in ds) if fista else None
    want_sums = []
    for i in (0, 2):
        out = T.fused_pair_iteration(
            jnp.asarray(orig), r, a, d, jnp.float32(RHOS[i]),
            jnp.float32(RHOS[i + 1]), jnp.asarray(li), jnp.asarray(lm),
            fista=fista, interpret=True)
        r, a, d = out[:3]
        want_sums += [float(x) for x in out[3:9]]

    t = torch.from_numpy
    o, tr = t(orig), t(recon.copy())
    ta = [t(x.copy()) for x in accs]
    td = [t(x.copy()) for x in ds] if fista else None
    calls = ttemporal.fused_pair_iteration.calls
    got_sums = []
    for i in (0, 2):
        out = ttemporal.fused_pair_iteration(
            o, tr, ta, td, torch.tensor(RHOS[i]), torch.tensor(RHOS[i + 1]),
            t(li), t(lm), fista=fista)
        got_sums += [float(x) for x in out[3:]]
    assert ttemporal.fused_pair_iteration.calls == calls + 2

    _close(tr.numpy(), r)
    for k in range(len(shape)):
        _close(ta[k].numpy(), a[k])
        if fista:
            _close(td[k].numpy(), d[k])
    _close(got_sums, want_sums, rtol=SUM_RTOL, atol=0)


# (shape, fista): 3D and 4D, FISTA and unaccelerated, for the reference
# cube's SSE
REF_CASES = [((6, 4, 6, 16), True), ((6, 4, 6, 16), False),
             ((8, 6, 64), True), ((8, 6, 64), False)]


@pytest.mark.parametrize("shape,fista", REF_CASES, ids=str)
def test_pair_with_ref_matches_pallas_pair(shape, fista):
    """With a reference cube, two pairs of the port (its plain version on
    the CPU) against the JAX pair kernel with ``ref`` in interpret mode:
    the state, the six sums and both iterations' SSE of each pair."""
    orig, recon, accs, ds, li, lm = _state(shape, fista, seed=sum(shape) + 1)
    ref = (np.random.default_rng(31).standard_normal(shape) * 0.5
           + 2.0).astype(np.float32)

    r, a = jnp.asarray(recon), tuple(jnp.asarray(x) for x in accs)
    d = tuple(jnp.asarray(x) for x in ds) if fista else None
    want_sums = []
    for i in (0, 2):
        out = T.fused_pair_iteration(
            jnp.asarray(orig), r, a, d, jnp.float32(RHOS[i]),
            jnp.float32(RHOS[i + 1]), jnp.asarray(li), jnp.asarray(lm),
            fista=fista, interpret=True, ref=jnp.asarray(ref))
        assert len(out) == 11
        r, a, d = out[:3]
        want_sums += [float(x) for x in out[3:]]

    t = torch.from_numpy
    o, tr = t(orig), t(recon.copy())
    ta = [t(x.copy()) for x in accs]
    td = [t(x.copy()) for x in ds] if fista else None
    got_sums = []
    for i in (0, 2):
        out = ttemporal.fused_pair_iteration(
            o, tr, ta, td, torch.tensor(RHOS[i]), torch.tensor(RHOS[i + 1]),
            t(li), t(lm), fista=fista, ref=t(ref))
        assert len(out) == 11
        got_sums += [float(x) for x in out[3:]]

    _close(tr.numpy(), r)
    for k in range(len(shape)):
        _close(ta[k].numpy(), a[k])
        if fista:
            _close(td[k].numpy(), d[k])
    assert all(x > 0 for x in got_sums[6:8] + got_sums[14:16])
    _close(got_sums, want_sums, rtol=SUM_RTOL, atol=0)


def test_pair_resumes_jax_engine_state():
    """A JAX paired FISTA run stopped after 4 iterations (keep_state) and
    resumed for two pairs in the port equals the 8-iteration JAX run."""
    cube, _, _, _, _, _ = _state((7, 12, 6, 16), False, seed=78)
    li = np.full(4, 32.0, np.float32)
    lm = np.full(4, 1 / 32.0, np.float32)

    def jrun(n):
        opts = JOptions(ndim=4, iterations_fista=n, iterations_unacc=0,
                        backend=JBackend.PALLAS, temporal_pairs=True,
                        temporal_kstep=False, vmem_resident=False)
        out = jengine.run_solver(jnp.asarray(cube), jnp.asarray(li),
                                 jnp.asarray(lm), opts, keep_state=True)
        return {k: (tuple(np.asarray(x) for x in v) if isinstance(v, tuple)
                    else np.asarray(v)) for k, v in out.items()}

    part, full = jrun(4), jrun(8)
    st = state_from_numpy(part, "cpu")
    assert st["i"] == 4
    rhos = torch.as_tensor(tengine.fista_tk_ratios(8), dtype=torch.float32)
    sums = []
    for i in (4, 6):
        out = ttemporal.fused_pair_iteration(
            torch.from_numpy(cube), st["recon"], st["accs"], st["ds"],
            rhos[i], rhos[i + 1], torch.from_numpy(li), torch.from_numpy(lm),
            fista=True)
        sums.append([float(x) for x in out[3:]])
    back = state_to_numpy(st)
    _close(back["recon"], full["recon"])
    for k in range(4):
        _close(back["accs"][k], full["accs"][k])
        _close(back["ds"][k], full["ds"][k])
    bn = [s[j] for s in sums for j in (0, 3)]
    dl = [s[j] / s[j + 1] for s in sums for j in (1, 4)]
    _close(bn, full["b_norm"][4:8], rtol=SUM_RTOL, atol=0)
    _close(dl, full["delta"][4:8], rtol=SUM_RTOL, atol=0)


@pytest.mark.parametrize("iters", [(4, 0), (5, 0), (0, 6), (3, 4), (5, 3)])
def test_solver_pairs_match_jax_paired_solver(monkeypatch, iters):
    """Whole schedules (odd counts, hybrid) through both engines with pairs
    on and the K-step kernel off; each phase runs floor(n/2) pairs, and its
    odd remainder as one K=1 step (the iterations the pairs do not account
    for). The port's row-size rule, which keeps rows this small off the
    pairs, is lifted."""
    monkeypatch.setattr(tengine, "PAIR_MIN_ROW_BYTES", 0)
    shape = (7, 12, 6, 16)
    cube, _, _, _, _, _ = _state(shape, False, seed=3)
    li = np.full(4, 32.0, np.float32)
    lm = np.full(4, 1 / 32.0, np.float32)
    base = dict(ndim=4, iterations_fista=iters[0], iterations_unacc=iters[1],
                temporal_pairs=True, temporal_kstep=False)
    want = jengine.run_solver(jnp.asarray(cube), jnp.asarray(li),
                              jnp.asarray(lm),
                              JOptions(**base, backend=JBackend.PALLAS))
    pairs = ttemporal.fused_pair_iteration.calls
    # the whole-run kernel would take these small cubes: off, so the pairs
    # run
    got = tengine.run_solver(torch.from_numpy(cube), torch.from_numpy(li),
                             torch.from_numpy(lm),
                             TOptions(**base, vmem_resident=False))
    pairs = ttemporal.fused_pair_iteration.calls - pairs
    assert pairs == iters[0] // 2 + iters[1] // 2
    assert got["iterations_run"] - 2 * pairs == iters[0] % 2 + iters[1] % 2
    for key in ("recon", "b_norm", "delta"):
        _close(got[key].numpy(), want[key])


@pytest.mark.parametrize("iters", [(8, 0), (0, 8), (5, 4)])
def test_solver_mse_pairs_match_jax_paired_mse(monkeypatch, iters):
    """Per-iteration MSE runs in pairs with the reference cube (the K-step
    phase refuses them), against the JAX engine's paired MSE run
    (tests/test_temporal.py::test_pair_mse_matches_k1): every pair launch
    takes ``ref``, and recon, the traces and the MSE trace agree."""
    monkeypatch.setattr(tengine, "PAIR_MIN_ROW_BYTES", 0)
    shape = (8, 6, 4, 16)
    cube, _, _, _, _, _ = _state(shape, True, seed=11)
    ref = np.random.default_rng(12).standard_normal(shape).astype(np.float32)
    li = np.full(4, 32.0, np.float32)
    lm = np.full(4, 1 / 32.0, np.float32)
    base = dict(ndim=4, iterations_fista=iters[0], iterations_unacc=iters[1],
                calculate_mse=True, vmem_resident=False)
    want = jengine.run_solver(jnp.asarray(cube), jnp.asarray(li),
                              jnp.asarray(lm),
                              JOptions(**base, backend=JBackend.PALLAS),
                              reference_data=jnp.asarray(ref))
    real = ttemporal.fused_pair_iteration
    refs = []

    def spy(*a, **kw):
        refs.append(kw.get("ref") is not None)
        return real(*a, **kw)

    monkeypatch.setattr(tengine, "fused_pair_iteration", spy)
    got = tengine.run_solver(torch.from_numpy(cube), torch.from_numpy(li),
                             torch.from_numpy(lm), TOptions(**base),
                             reference_data=torch.from_numpy(ref))
    assert refs == [True] * (iters[0] // 2 + iters[1] // 2)
    assert got["iterations_run"] == sum(iters)
    _close(got["recon"].numpy(), want["recon"])
    _close(got["b_norm"].numpy(), want["b_norm"], rtol=1e-5, atol=0)
    _close(got["delta"].numpy(), want["delta"], rtol=1e-4, atol=0)
    assert got["mse"].shape == (sum(iters) + 1,)
    assert bool((got["mse"] > 0).all())
    _close(got["mse"].numpy(), want["mse"], rtol=1e-5, atol=0)


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


@pytest.mark.parametrize("iters,stop_at", [((16, 0), 9), ((0, 16), 10),
                                           ((6, 12), 13)])
def test_stop_aware_pairs_match_jax(monkeypatch, iters, stop_at):
    """Stop-aware runs in pairs (the K-step kernel off) against the JAX
    engine's stop-aware paired run (tests/test_temporal.py::
    test_stop_aware_pairs_match_unpaired): the same stop, recon and
    traces; the pairs ran."""
    monkeypatch.setattr(tengine, "PAIR_MIN_ROW_BYTES", 0)
    shape = (7, 12, 6, 16)
    cube, _, _, _, _, _ = _state(shape, True, seed=3)
    li = np.full(4, 32.0, np.float32)
    lm = np.full(4, 1 / 32.0, np.float32)
    stopping = _stopping(cube, li, lm, iters, stop_at)
    base = dict(ndim=4, iterations_fista=iters[0], iterations_unacc=iters[1],
                stopping_relative_change=stopping, temporal_kstep=False,
                vmem_resident=False)
    want = jengine.run_solver(jnp.asarray(cube), jnp.asarray(li),
                              jnp.asarray(lm),
                              JOptions(**base, backend=JBackend.PALLAS))
    pairs = ttemporal.fused_pair_iteration.calls
    got = tengine.run_solver(torch.from_numpy(cube), torch.from_numpy(li),
                             torch.from_numpy(lm), TOptions(**base))
    assert ttemporal.fused_pair_iteration.calls > pairs
    assert got["iterations_run"] == int(want["iterations_run"]) == stop_at + 1
    assert got["early_stopped"] == bool(want["early_stopped"]) is True
    _close(got["recon"].numpy(), want["recon"])
    _close(got["b_norm"].numpy(), want["b_norm"], rtol=1e-5, atol=0)
    _close(got["delta"].numpy(), want["delta"], rtol=1e-4, atol=0)


def _gate_variants():
    """(jax options, port options) pairs for the gate: BCs, iso, restart,
    the knob off, and the plain backends."""
    out = []
    for ndim in (3, 4):
        kws = [dict(), dict(bc_mode=0), dict(bc_mode=1),
               dict(fista_restart=True), dict(temporal_pairs=False),
               dict(iterations_fista=0, iterations_unacc=4)]
        if ndim == 4:
            kws += [dict(isotropic_R=True), dict(isotropic_Q=True)]
        for kw in kws:
            out.append((ndim, dict(kw, backend=JBackend.PALLAS), kw))
        out.append((ndim, dict(backend=JBackend.JAX), dict(backend="torch")))
    return out


@pytest.mark.parametrize("ndim,jkw,tkw", _gate_variants(), ids=str)
def test_gate_matches_jax(ndim, jkw, tkw):
    """The port's ``_resolve_temporal`` against the JAX one (single
    device): float32 and float64, N0 = 3 (refused) and 4."""
    base = dict(ndim=ndim, iterations_fista=4, iterations_unacc=0)
    jopts = JOptions(**dict(base, **jkw))
    topts = TOptions(**dict(base, **tkw))
    for n0 in (3, 4):
        shape = (n0, 6, 8, 16) if ndim == 4 else (n0, 8, 64)
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.float64, torch.float64)):
            want = jengine._resolve_temporal(jopts, shape, jdt, None)
            got = tengine._resolve_temporal(topts, shape, tdt)
            assert got == want, (shape, tdt)


def test_gate_refuses_stop_and_mse_in_this_slice(monkeypatch):
    """The gates on stop and MSE options, against the JAX engine's on one
    device: both pair stop-aware and MSE runs (``_resolve_temporal``), and
    the K-step gate refuses MSE runs only (``_resolve_kstep``; the K-step
    kernel has no SSE). Through ``denoise4D`` a stop run and an MSE run now
    pair, the MSE run with its reference cube."""
    shape = (6, 6, 8, 16)
    base = dict(ndim=4, iterations_fista=4, iterations_unacc=0)
    for kw in (dict(), dict(stopping_relative_change=0.01),
               dict(calculate_mse=True),
               dict(stopping_relative_change=0.01, calculate_mse=True)):
        jopts = JOptions(**base, backend=JBackend.PALLAS, **kw)
        topts = TOptions(**base, **kw)
        want = jengine._resolve_temporal(jopts, shape, jnp.float32, None)
        assert want
        assert tengine._resolve_temporal(topts, shape, torch.float32) == want
        for fista in (True, False):
            want_k = jengine._resolve_kstep(jopts, shape, jnp.float32, None,
                                            fista)
            assert (want_k == 0) == ("calculate_mse" in kw), kw
            assert tengine._resolve_kstep(topts, shape, torch.float32,
                                          fista) == want_k, kw
    from cytvdn_tpu_torch import denoise4D

    # the whole-run kernel off, which would take this small cube, and the
    # port's row-size rule lifted, which keeps these rows off the pairs
    monkeypatch.setattr(tengine, "_resolve_resident", lambda *a: False)
    monkeypatch.setattr(tengine, "PAIR_MIN_ROW_BYTES", 0)
    real = ttemporal.fused_pair_iteration
    refs = []

    def spy(*a, **kw):
        refs.append(kw.get("ref") is not None)
        return real(*a, **kw)

    monkeypatch.setattr(tengine, "fused_pair_iteration", spy)
    cube, _, _, _, _, _ = _state(shape, False, seed=5)
    # 10 iterations: a two-step prologue, two K=3 launches, then one pair
    denoise4D(cube, np.full(4, 1.0, np.float32), iterations=10, quiet=True,
              stopping_relative_change=1e-9, device="cpu")
    assert refs == [False]
    refs.clear()
    denoise4D(cube, np.full(4, 1.0, np.float32), iterations=4, quiet=True,
              reference_data=cube, device="cpu")
    assert refs == [True, True]


def test_pair_wrapper_rejects_what_the_kernel_does_not_take():
    t = torch.from_numpy
    orig, recon, accs, ds, li, lm = _state((4, 5, 6), True, seed=4)
    rho = torch.tensor(0.5)
    args = (t(orig), t(recon), [t(a) for a in accs], [t(d) for d in ds],
            rho, rho, t(li), t(lm))
    calls = ttemporal.fused_pair_iteration.calls
    with pytest.raises(ValueError, match="does not cover"):
        ttemporal.fused_pair_iteration(
            *(x.double() if isinstance(x, torch.Tensor) else
              [y.double() for y in x] for x in args), fista=True)
    thin = [x[:3] for x in (args[0], args[1])]
    with pytest.raises(ValueError, match="does not cover"):
        ttemporal.fused_pair_iteration(
            *thin, [a[:3] for a in args[2]], [d[:3] for d in args[3]],
            *args[4:], fista=True)
    # bfloat16 shadow duals (lossy duals) run, all of them or none
    # (tests/test_torch_lossy_pair.py): a mix is refused
    with pytest.raises(ValueError, match="ds"):
        ttemporal.fused_pair_iteration(
            *args[:3], [args[3][0].to(torch.bfloat16), *args[3][1:]],
            *args[4:], fista=True)
    with pytest.raises(ValueError, match="per axis"):
        ttemporal.fused_pair_iteration(*args[:3], None, *args[4:], fista=True)
    assert ttemporal.fused_pair_iteration.calls == calls
    assert not ttemporal.pair_supported((6, 5, 6, 7), torch.float32, 1)
    assert not ttemporal.pair_supported((6, 5, 6, 7), torch.float32, 2,
                                        isotropic_R=True)
    assert ttemporal.pair_supported((4, 5, 6), torch.float32, 2)


def _replay_pairs(orig, recon, accs, ds, rhos, li, lm, fista, strip, order):
    """Two iterations, in place on CPU tensors, by the CUDA kernel's
    schedule (:func:`pair_stages`): each row operation computes the plain
    full-array update from the state it reads and commits only its row and
    axis-1 range. Within a stage the operations run in launch order
    ("forward"), in reverse, or all reading the stage's start state
    ("snapshot"). Returns the six sums in float64."""
    ndim = orig.dim()
    stages = {}
    for stage, op, row, lo, hi in ttemporal.pair_stages(tuple(orig.shape),
                                                        strip):
        stages.setdefault(stage, []).append((op, row, lo, hi))
    sums = [0.0] * 6
    for stage in sorted(stages):
        items = stages[stage][::-1] if order == "reverse" else stages[stage]
        src = (recon, accs, ds)
        if order == "snapshot":
            src = (recon.clone(), [a.clone() for a in accs],
                   [d.clone() for d in ds] if fista else None)
        for op, row, lo, hi in items:
            r, a, d = src
            at = (row, slice(lo, hi))
            lev = op // 2
            if op % 2 == 0:
                for k in range(ndim):
                    if fista:
                        b_new, d_new, _ = tops.accumulator_update_fista(
                            r, a[k], d[k], rhos[lev], k, li[k])
                        ds[k][at] = d_new[at]
                    else:
                        b_new, _ = tops.accumulator_update(r, a[k], k, li[k])
                    accs[k][at] = b_new[at]
                    sums[3 * lev] += float(b_new[at].double().abs().sum())
            else:
                r_new, _, _ = tops.datacube_update(orig, r, a, lm)
                sums[3 * lev + 1] += float(
                    (r_new[at] - r[at]).double().abs().sum())
                sums[3 * lev + 2] += float(r[at].double().abs().sum())
                recon[at] = r_new[at]
    return sums


# N0 = 4..7, 3D and 4D, ragged in-row extents; strips 1, 2, 3, N1-1, N1
REPLAY_SHAPES = [(4, 7, 5), (6, 9, 4), (5, 6, 3, 4), (7, 5, 2, 3)]
REPLAY_CASES = [(shape, fista, strip) for shape in REPLAY_SHAPES
                for fista in (True, False)
                for strip in sorted({1, 2, 3, shape[1] - 1, shape[1]})]


@pytest.mark.parametrize("shape,fista,strip", REPLAY_CASES, ids=str)
def test_pair_stage_plan_replays_two_plain_iterations(shape, fista, strip):
    """The kernel's strip-and-wavefront schedule, replayed in place with the
    plain element updates in each of three orders within a stage, equals
    two plain iterations bitwise: every element is computed once, and no
    operation reads a value another has already moved on."""
    orig, recon, accs, ds, li, lm = _state(shape, fista, seed=sum(shape))
    t = torch.from_numpy
    rhos = [torch.tensor(RHOS[1]), torch.tensor(RHOS[2])]
    want = ttemporal.fused_pair_iteration_reference(
        t(orig), t(recon.copy()), [t(x.copy()) for x in accs],
        [t(x.copy()) for x in ds] if fista else None, *rhos, t(li), t(lm),
        fista=fista)
    want_sums = [float(x) for x in want[3:]]
    for order in ("forward", "reverse", "snapshot"):
        r = t(recon.copy())
        a = [t(x.copy()) for x in accs]
        d = [t(x.copy()) for x in ds] if fista else None
        got_sums = _replay_pairs(t(orig), r, a, d, rhos, t(li), t(lm), fista,
                                 strip, order)
        assert torch.equal(r, want[0]), order
        for k in range(len(shape)):
            assert torch.equal(a[k], want[1][k]), (order, k)
            if fista:
                assert torch.equal(d[k], want[2][k]), (order, k)
        _close(got_sums, want_sums, rtol=SUM_RTOL, atol=0)


@pytest.mark.parametrize("shape", REPLAY_SHAPES, ids=str)
def test_pair_stage_plan_covers_each_element_once(shape):
    """Each row operation covers every (row, axis-1 index) exactly once, at
    every strip width, and the stages per strip are N0 + 5."""
    n0, n1 = shape[:2]
    for strip in range(1, n1 + 2):
        seen = np.zeros((4, n0, n1), int)
        stages = set()
        for stage, op, row, lo, hi in ttemporal.pair_stages(shape, strip):
            seen[op, row, lo:hi] += 1
            stages.add(stage)
        assert (seen == 1).all(), strip
        assert max(stages) < -(-n1 // strip) * (n0 + 5)


# (shape, strip): the BASELINE shapes at whole rows (the wrapper's default)
# and at strips the sweep times, and ragged strips in 3D and 4D
STAGE_WORK = [
    ((256, 256, 128, 128), 256),   # config 4: 4 ops x 256 x 64 tiles
    ((256, 256, 128, 128), 8),
    ((256, 256, 2048), 64),        # config 2
    ((128, 128, 64, 64), 32),      # config 3
    ((6, 45, 70), 11),             # 3D tiles that start off the 8-row grid
    ((7, 10, 9, 33), 3),           # W does not divide N1
]


@pytest.mark.parametrize("shape,strip", STAGE_WORK, ids=str)
def test_pair_stage_work(shape, strip):
    """The wrapper's 2**31 check counts the busiest stage's work items as
    the kernel numbers them: each active row operation's axis-1 range (in
    3D in tiles of 8 rows from its lo) times the tiles of the other in-row
    axes. With N0 >= 6 some stage runs all four operations."""
    ty, tx = 8, 32
    if len(shape) == 4:
        per1 = -(-shape[2] // ty) * -(-shape[3] // tx)
    else:
        per1 = -(-shape[2] // tx)
    stages = {}
    for stage, _, _, lo, hi in ttemporal.pair_stages(shape, strip):
        n1 = hi - lo if len(shape) == 4 else -(-(hi - lo) // ty)
        stages[stage] = stages.get(stage, 0) + n1 * per1
    assert ttemporal._stage_work(shape, strip) == max(stages.values())
    if shape == (256, 256, 128, 128) and strip == 256:
        assert max(stages.values()) == 4 * 256 * 16 * 4


def test_pair_wrapper_takes_a_strip_on_the_cpu():
    """A forced strip runs the plain version on the CPU (the result does
    not depend on it); a strip below 1 is refused."""
    t = torch.from_numpy
    orig, recon, accs, ds, li, lm = _state((5, 6, 3, 4), True, seed=9)
    rho = torch.tensor(0.5)
    outs = []
    for strip in (None, 2, 100):
        r = t(recon.copy())
        a = [t(x.copy()) for x in accs]
        d = [t(x.copy()) for x in ds]
        out = ttemporal.fused_pair_iteration(t(orig), r, a, d, rho, rho,
                                             t(li), t(lm), fista=True,
                                             strip=strip)
        outs.append((r, a, d, out[3:]))
    for r, a, d, sums in outs[1:]:
        assert torch.equal(r, outs[0][0])
        assert all(torch.equal(x, y) for x, y in zip(a + d,
                                                     outs[0][1] + outs[0][2]))
        assert all(torch.equal(x, y) for x, y in zip(sums, outs[0][3]))
    calls = ttemporal.fused_pair_iteration.calls
    with pytest.raises(ValueError, match="strip"):
        ttemporal.fused_pair_iteration(
            t(orig), t(recon.copy()), [t(x.copy()) for x in accs],
            [t(x.copy()) for x in ds], rho, rho, t(li), t(lm), fista=True,
            strip=0)
    assert ttemporal.fused_pair_iteration.calls == calls


@pytest.mark.parametrize("shape,pays", [
    ((256, 256, 128, 128), True),   # 16 MiB rows: config 4
    ((64, 128, 128, 128), True),    # 8 MiB rows
    ((64, 64, 16384), False),       # 4 MiB rows
    ((128, 128, 64, 64), False),    # 2 MiB rows: config 3
    ((256, 256, 2048), False),      # 2 MiB rows: config 2
    ((6, 6, 8, 16), False),
], ids=str)
def test_pair_row_rule(shape, pays):
    """The port's own rule on top of the JAX gate: pairs where one array's
    axis-0 slab is at least 8 MiB (the crossing the H100 measured)."""
    assert tengine._pairs_pay(shape, torch.float32) is pays
    assert tengine._resolve_temporal(
        TOptions(ndim=len(shape), iterations_fista=4, iterations_unacc=0),
        shape, torch.float32)


def test_solver_skips_pairs_below_the_row_rule(monkeypatch):
    """A fixed schedule on a small cube runs the one-iteration loop, not
    pairs, and the same state as with the rule lifted."""
    shape = (7, 12, 6, 16)
    cube, _, _, _, _, _ = _state(shape, False, seed=11)
    li, lm = torch.full((4,), 32.0), torch.full((4,), 1 / 32.0)
    opts = TOptions(ndim=4, iterations_fista=4, iterations_unacc=2,
                    temporal_kstep=False, vmem_resident=False)
    pairs = ttemporal.fused_pair_iteration.calls
    got = tengine.run_solver(torch.from_numpy(cube), li, lm, opts)
    assert ttemporal.fused_pair_iteration.calls == pairs
    monkeypatch.setattr(tengine, "PAIR_MIN_ROW_BYTES", 0)
    want = tengine.run_solver(torch.from_numpy(cube), li, lm, opts)
    assert ttemporal.fused_pair_iteration.calls == pairs + 3
    assert torch.equal(got["recon"], want["recon"])
