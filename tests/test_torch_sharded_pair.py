"""The pair kernel's axis-0 bands (``halos0``) in the port, on the CPU:
the plain pair with bands (``fused_pair_iteration_reference``, which the
wrapper runs for CPU tensors) against one pair of the whole cube, against
the JAX pair kernel with ``halos0`` in interpret mode, and the engine's
paired phase on an axis-0 mesh against the JAX ``run_sharded`` that pairs
(its Pallas kernels in interpret mode).

Tolerances: slabs put back together are bitwise one pair of the whole
cube, their sums within rtol 1e-5 of its sums; against the JAX kernel the
state within rtol 2e-5 / atol 2e-6 and the sums within rtol 1e-5
(tests/test_torch_temporal.py's). The CUDA kernel's ``HALO0``
instantiation is held bitwise against the plain pair on the card
(tests/test_torch_cuda.py and ``chip_smoke.py`` phase 9).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import cytvdn_tpu.kernels.temporal as T  # noqa: E402
from cytvdn_tpu.config import Backend as JBackend  # noqa: E402
from cytvdn_tpu.config import SolverOptions as JOptions  # noqa: E402
from cytvdn_tpu.parallel import sharded as jsharded  # noqa: E402
from cytvdn_tpu_torch.kernels import temporal as ttemporal  # noqa: E402
from cytvdn_tpu_torch.parallel import denoise_sharded  # noqa: E402
from cytvdn_tpu_torch.solver import engine as tengine  # noqa: E402

from test_torch_sharded import on_mesh  # noqa: E402

RTOL, ATOL, SUM_RTOL = 2e-5, 2e-6, 1e-5
RHO1, RHO2 = 0.37, 0.52


def _state(shape, fista, seed):
    """A random Jia-Zhao state of a whole cube: each accumulator's leading
    slab along its own axis is zero, so every slab but the first has a
    nonzero axis-0 row 0 (the wrap a shard must not read)."""
    rng = np.random.default_rng(seed)
    nd = len(shape)
    orig = (rng.standard_normal(shape) * 0.5 + 2.0).astype(np.float32)
    recon = (orig + rng.standard_normal(shape) * 0.05).astype(np.float32)
    accs = [(rng.standard_normal(shape) * 0.2).astype(np.float32)
            for _ in range(nd)]
    ds = [(rng.standard_normal(shape) * 0.2).astype(np.float32)
          for _ in range(nd)] if fista else None
    for k in range(nd):
        idx = [slice(None)] * nd
        idx[k] = 0
        accs[k][tuple(idx)] = 0
        if fista:
            ds[k][tuple(idx)] = 0
    li = np.linspace(0.2, 0.35, nd).astype(np.float32)
    lm = np.linspace(1 / 32, 1 / 48, nd).astype(np.float32)
    return orig, recon, accs, ds, li, lm


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _port_slab(state, a0, a1, fista, ref=None, whole_cube=False):
    """The port's pair on rows [a0, a1) with bands cut from the whole
    state (``halo0_bands``); with ``whole_cube`` the pair of the whole cube
    without bands. Returns the slab's recon, accs, ds and sums."""
    orig, recon, accs, ds, li, lm = state
    if whole_cube:
        kw = {}
    else:
        h, f0, l0 = ttemporal.halo0_bands(
            _t(orig), _t(recon), [_t(a) for a in accs],
            [_t(d) for d in ds] if fista else None, a0, a1)
        kw = dict(halos0=h, first0=f0, last0=l0)
    r = _t(recon[a0:a1])
    a = [_t(x[a0:a1]) for x in accs]
    d = [_t(x[a0:a1]) for x in ds] if fista else None
    out = ttemporal.fused_pair_iteration(
        _t(orig[a0:a1]), r, a, d, torch.tensor(RHO1), torch.tensor(RHO2),
        _t(li), _t(lm), fista=fista,
        ref=None if ref is None else _t(ref[a0:a1]), **kw)
    return r, a, d, np.array([float(x) for x in out[3:]])


SHAPES = [(12, 5, 6, 7), (16, 9, 11), (8, 4, 10, 9)]


@pytest.mark.parametrize("with_ref", [False, True])
@pytest.mark.parametrize("fista", [True, False])
@pytest.mark.parametrize("shape,n_slabs", [
    (shape, n) for shape in SHAPES for n in (1, 2, 3)
    if shape[0] // n >= 4], ids=str)
def test_plain_pair_slabs_reassemble_to_one_pair(shape, n_slabs, fista,
                                                 with_ref):
    """Axis-0 slabs of at least 4 rows (the pair kernel's least), each
    paired with bands from the pre-update state and put back: bitwise one
    pair of the whole cube, the slabs' sums adding up to its sums."""
    n0 = shape[0]
    state = _state(shape, fista, seed=sum(shape) + n_slabs)
    ref = state[0] * np.float32(0.9) if with_ref else None
    wr, wa, wd, wsums = _port_slab(state, 0, n0, fista, ref, whole_cube=True)
    bounds = [n0 * i // n_slabs for i in range(n_slabs + 1)]
    sums = 0
    for a0, a1 in zip(bounds[:-1], bounds[1:]):
        r, a, d, s = _port_slab(state, a0, a1, fista, ref)
        sums = sums + s
        assert torch.equal(r, wr[a0:a1])
        for k in range(len(shape)):
            assert torch.equal(a[k], wa[k][a0:a1])
            if fista:
                assert torch.equal(d[k], wd[k][a0:a1])
    np.testing.assert_allclose(sums, wsums, rtol=SUM_RTOL)


@pytest.mark.parametrize("where", ["first", "interior", "last"])
@pytest.mark.parametrize("fista", [True, False])
@pytest.mark.parametrize("shape", [(12, 5, 6, 8), (12, 9, 16)], ids=str)
def test_plain_pair_with_bands_matches_jax_kernel(shape, fista, where):
    """The plain pair with bands against the JAX pair kernel with the same
    ``halos0`` (interpret mode) on the first, an interior and the last of
    three slabs."""
    state = _state(shape, fista, seed=3)
    orig, recon, accs, ds, li, lm = state
    a0, a1 = {"first": (0, 4), "interior": (4, 8), "last": (8, 12)}[where]
    h, f0, l0 = ttemporal.halo0_bands(
        _t(orig), _t(recon), [_t(a) for a in accs],
        [_t(d) for d in ds] if fista else None, a0, a1)
    want = T.fused_pair_iteration(
        jnp.asarray(orig[a0:a1]), jnp.asarray(recon[a0:a1]),
        tuple(jnp.asarray(a[a0:a1]) for a in accs),
        tuple(jnp.asarray(d[a0:a1]) for d in ds) if fista else None,
        jnp.float32(RHO1), jnp.float32(RHO2), jnp.asarray(li),
        jnp.asarray(lm), fista=fista, interpret=True,
        halos0={k: jnp.asarray(v.numpy()) for k, v in h.items()},
        first0=jnp.float32(f0), last0=jnp.float32(l0))
    r, a, d, sums = _port_slab(state, a0, a1, fista)
    np.testing.assert_allclose(r.numpy(), np.asarray(want[0]), rtol=RTOL,
                               atol=ATOL)
    for k in range(len(shape)):
        np.testing.assert_allclose(a[k].numpy(), np.asarray(want[1][k]),
                                   rtol=RTOL, atol=ATOL)
        if fista:
            np.testing.assert_allclose(d[k].numpy(), np.asarray(want[2][k]),
                                       rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(sums, [float(x) for x in want[3:9]],
                               rtol=SUM_RTOL)


@pytest.mark.parametrize("fista", [True, False])
def test_last_slab_reads_no_own_row0_wrap(fista):
    """On the last slab the forward difference of the last row is the
    Jia-Zhao zero, not the slab's own row 0, whose axis-0 accumulator is
    nonzero here (it is the cube's row 4): bitwise the whole cube's
    pair."""
    shape = (8, 5, 6, 7)
    state = _state(shape, fista, seed=21)
    assert np.abs(state[2][0][4]).max() > 0
    wr, wa, _, _ = _port_slab(state, 0, 8, fista, whole_cube=True)
    r, a, _, _ = _port_slab(state, 4, 8, fista)
    assert torch.equal(r, wr[4:]) and torch.equal(a[0], wa[0][4:])


def test_pair_wrapper_checks_the_bands():
    shape = (12, 5, 6, 7)
    orig, recon, accs, ds, li, lm = _state(shape, True, seed=22)
    h, f0, l0 = ttemporal.halo0_bands(
        _t(orig), _t(recon), [_t(a) for a in accs], [_t(d) for d in ds],
        4, 8)
    args = (_t(orig[4:8]), _t(recon[4:8]), [_t(a[4:8]) for a in accs],
            [_t(d[4:8]) for d in ds], torch.tensor(RHO1), torch.tensor(RHO2),
            _t(li), _t(lm))
    bad = dict(h)
    del bad["n_d0_r1"]
    with pytest.raises(ValueError, match="n_d0_r1"):
        ttemporal.fused_pair_iteration(*args, fista=True, halos0=bad,
                                       first0=f0, last0=l0)
    bad = dict(h, p_r0=h["p_r0"][:1].clone())
    with pytest.raises(ValueError, match="p_r0"):
        ttemporal.fused_pair_iteration(*args, fista=True, halos0=bad,
                                       first0=f0, last0=l0)
    with pytest.raises(ValueError, match="first0 and last0"):
        ttemporal.fused_pair_iteration(*args, fista=True, halos0=h)
    with pytest.raises(ValueError, match="unexpected"):
        ttemporal.fused_pair_iteration(*args, fista=True,
                                       halos0=dict(h, halos1=h["p_orig"]),
                                       first0=f0, last0=l0)


@pytest.mark.parametrize("with_ref", [False, True])
@pytest.mark.parametrize("where", ["first", "last"])
@pytest.mark.parametrize("fista", [True, False])
def test_missing_neighbour_bands_may_be_left_out(fista, where, with_ref):
    """On the first and the last slab the missing neighbour's bands (which
    the engine does not send) may be left out: the same state and sums as
    with zero bands. An interior slab still needs them all."""
    shape = (12, 5, 6, 7)
    state = _state(shape, fista, seed=23)
    orig, recon, accs, ds, li, lm = state
    a0, a1 = (0, 4) if where == "first" else (8, 12)
    ref = orig + np.float32(0.1) if with_ref else None
    want = _port_slab(state, a0, a1, fista, ref=ref)
    h, f0, l0 = ttemporal.halo0_bands(
        _t(orig), _t(recon), [_t(a) for a in accs],
        [_t(d) for d in ds] if fista else None, a0, a1)
    side = "p_" if where == "first" else "n_"
    h = {k: v for k, v in h.items() if not k.startswith(side)}
    r = _t(recon[a0:a1])
    a = [_t(x[a0:a1]) for x in accs]
    d = [_t(x[a0:a1]) for x in ds] if fista else None
    out = ttemporal.fused_pair_iteration(
        _t(orig[a0:a1]), r, a, d, torch.tensor(RHO1), torch.tensor(RHO2),
        _t(li), _t(lm), fista=fista,
        ref=None if ref is None else _t(ref[a0:a1]), halos0=h, first0=f0,
        last0=l0)
    assert torch.equal(r, want[0])
    assert all(torch.equal(x, y) for x, y in zip(a, want[1]))
    if fista:
        assert all(torch.equal(x, y) for x, y in zip(d, want[2]))
    np.testing.assert_array_equal([float(x) for x in out[3:]], want[3])
    with pytest.raises(ValueError, match="is missing"):
        ttemporal.fused_pair_iteration(
            _t(orig[4:8]), _t(recon[4:8]), [_t(x[4:8]) for x in accs],
            [_t(x[4:8]) for x in ds] if fista else None, torch.tensor(RHO1),
            torch.tensor(RHO2), _t(li), _t(lm), fista=fista, halos0=h,
            first0=False, last0=False)


@pytest.mark.parametrize("kw", [dict(iterations=6),
                                dict(iterations=(3, 4)),
                                dict(iterations=6, reference=True)], ids=str)
def test_mesh_pairs_match_jax_paired_run_sharded(monkeypatch, kw):
    """The engine's paired phase on a (2, 1, 1, 1) mesh (bands exchanged
    over gloo, the port's plain pair with bands) against the JAX
    ``run_sharded`` that pairs with ``halos0`` (``backend="pallas"``, its
    kernels in interpret mode on the fake CPU devices)."""
    monkeypatch.setattr(tengine, "PAIR_MIN_ROW_BYTES", 0)
    shape = (8, 4, 6, 8)
    rng = np.random.default_rng(23)
    cube = (rng.standard_normal(shape) * 0.5 + 2.0).astype(np.float32)
    ref = (cube * np.float32(0.9)) if kw.get("reference") else None
    n_f, n_u = kw["iterations"] if isinstance(kw["iterations"], tuple) \
        else (kw["iterations"], 0)
    li = np.full(4, 32.0, np.float32)
    lm = np.full(4, 1 / 32, np.float32)
    jopts = JOptions(ndim=4, iterations_fista=n_f, iterations_unacc=n_u,
                     backend=JBackend.PALLAS, calculate_mse=ref is not None)
    assert jsharded.temporal_mesh_preference(jopts, np.float32)
    want = jsharded.run_sharded(cube, li, lm, jopts, reference_data=ref,
                                shard=(2, 1, 1, 1))
    calls = ttemporal.fused_pair_iteration.calls
    res = on_mesh(2, lambda pg, r: denoise_sharded(
        cube, 1.0, iterations=kw["iterations"], shard=(2, 1, 1, 1),
        group=pg, device="cpu", reference_data=ref))
    assert ttemporal.fused_pair_iteration.calls - calls == 2 * ((n_f // 2)
                                                                + n_u // 2)
    np.testing.assert_allclose(res[0]["recon"], np.asarray(want["recon"]),
                               rtol=RTOL, atol=ATOL)
    for key in ("b_norm", "delta") + (("mse",) if ref is not None else ()):
        np.testing.assert_allclose(res[1][key], np.asarray(want[key]),
                                   rtol=SUM_RTOL)
