"""The PyTorch port's stencil ops (``cytvdn_tpu_torch.ops``) against the
JAX ops (``cytvdn_tpu.ops``) and the numpy golden model, on the CPU.

The cases are those of tests/test_ops.py. Tolerances: rtol 2e-5 /
atol 2e-6 in float32 (tests/test_pallas.py; the two frameworks may round
differently by an ulp or two in the sums), 1e-12 in float64.
"""

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

import golden  # noqa: E402
from cytvdn_tpu import ops as jops  # noqa: E402
from cytvdn_tpu.config import BCMode as JBC  # noqa: E402
from cytvdn_tpu_torch import ops as tops  # noqa: E402
from cytvdn_tpu_torch.config import BCMode  # noqa: E402
from cytvdn_tpu_torch.ops import stencil as tstencil  # noqa: E402

SHAPES = {3: (5, 6, 7), 4: (4, 5, 6, 7)}
DTYPES = [np.float32, np.float64]


def rand(rng, shape, dtype, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(dtype)


def close(got, want, dtype):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    if dtype == np.float32:
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-6)
    else:
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12,
                                   atol=1e-12)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("ndim", [3, 4])
@pytest.mark.parametrize("bc", [0, 1, 2])
@pytest.mark.parametrize("dtype", DTYPES)
def test_accumulator_update_matches_jax_and_golden(ndim, bc, dtype):
    rng = np.random.default_rng(100 + 10 * ndim + bc)
    clip = dtype(0.3)
    for ax in range(ndim):
        a = rand(rng, SHAPES[ndim], dtype)
        b = rand(rng, SHAPES[ndim], dtype, 0.1)
        got_b, got_n = tops.accumulator_update(t(a), t(b), ax, t(clip),
                                               BCMode(bc))
        want_b, want_n = jops.accumulator_update(jnp.asarray(a), jnp.asarray(b),
                                                 ax, clip, JBC(bc))
        close(got_b, want_b, dtype)
        close(got_n, want_n, dtype)
        gold_b, gold_n = golden.accumulator_update(a, b, ax, clip, bc)
        close(got_b, gold_b, dtype)


@pytest.mark.parametrize("ndim", [3, 4])
@pytest.mark.parametrize("bc", [0, 1, 2])
@pytest.mark.parametrize("dtype", DTYPES)
def test_accumulator_update_fista_matches_jax_and_golden(ndim, bc, dtype):
    rng = np.random.default_rng(200 + 10 * ndim + bc)
    clip, tk = dtype(0.3), dtype(0.7)
    for ax in range(ndim):
        a = rand(rng, SHAPES[ndim], dtype)
        b = rand(rng, SHAPES[ndim], dtype, 0.1)
        d = rand(rng, SHAPES[ndim], dtype, 0.1)
        got = tops.accumulator_update_fista(t(a), t(b), t(d), t(tk), ax,
                                            t(clip), BCMode(bc))
        want = jops.accumulator_update_fista(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(d), jnp.asarray(tk),
            ax, clip, JBC(bc))
        for g, w in zip(got, want):
            close(g, w, dtype)
        gold = golden.accumulator_update_fista(a, b, d, tk, ax, clip, bc)
        close(got[0], gold[0], dtype)
        close(got[1], gold[1], dtype)


@pytest.mark.parametrize("fista", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_iso_accumulator_update_matches_jax_and_golden(fista, dtype):
    rng = np.random.default_rng(300 + fista)
    a = rand(rng, SHAPES[4], dtype)
    b1, b2 = rand(rng, SHAPES[4], dtype, 0.1), rand(rng, SHAPES[4], dtype, 0.1)
    d1, d2 = rand(rng, SHAPES[4], dtype, 0.1), rand(rng, SHAPES[4], dtype, 0.1)
    # a zero pair exercises the mag=0 guard
    a[0, 0] = 0
    b1[0, 0] = 0
    b2[0, 0] = 0
    clip, tk = dtype(0.2), dtype(0.6)
    for ax1, ax2 in [(0, 1), (2, 3)]:
        if fista:
            got = tops.iso_accumulator_update_fista(
                t(a), t(b1), t(b2), t(d1), t(d2), t(tk), ax1, ax2, t(clip))
            want = jops.iso_accumulator_update_fista(
                *(jnp.asarray(x) for x in (a, b1, b2, d1, d2)),
                jnp.asarray(tk), ax1, ax2, clip)
            gold = golden.iso_accumulator_update_fista(
                a, b1, b2, d1, d2, tk, ax1, ax2, clip)
        else:
            got = tops.iso_accumulator_update(t(a), t(b1), t(b2), ax1, ax2,
                                              t(clip))
            want = jops.iso_accumulator_update(
                jnp.asarray(a), jnp.asarray(b1), jnp.asarray(b2), ax1, ax2,
                clip)
            gold = golden.iso_accumulator_update(a, b1, b2, ax1, ax2, clip)
        for g, w, o in zip(got, want, gold):
            close(g, w, dtype)
            close(g, o, dtype)


@pytest.mark.parametrize("ndim", [3, 4])
@pytest.mark.parametrize("bc", [0, 1, 2])
@pytest.mark.parametrize("dtype", DTYPES)
def test_datacube_update_matches_jax_and_golden(ndim, bc, dtype):
    rng = np.random.default_rng(400 + 10 * ndim + bc)
    orig = rand(rng, SHAPES[ndim], dtype)
    recon = rand(rng, SHAPES[ndim], dtype)
    bs = [rand(rng, SHAPES[ndim], dtype, 0.2) for _ in range(ndim)]
    lam_mu = np.linspace(1 / 32, 1 / 40, ndim).astype(dtype)
    got_r, got_num, got_den = tops.datacube_update(
        t(orig), t(recon), [t(b) for b in bs], t(lam_mu), BCMode(bc))
    want_r, want_num, want_den = jops.datacube_update(
        jnp.asarray(orig), jnp.asarray(recon), [jnp.asarray(b) for b in bs],
        jnp.asarray(lam_mu), JBC(bc))
    close(got_r, want_r, dtype)
    close(got_num, want_num, dtype)
    close(got_den, want_den, dtype)
    gold_r, gold_delta = golden.datacube_update(orig, recon, bs, lam_mu, bc)
    close(got_r, gold_r, dtype)
    close(float(got_num) / float(got_den), gold_delta, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sum_square_error_and_tv_energy(dtype):
    rng = np.random.default_rng(500)
    a, b = rand(rng, SHAPES[4], dtype), rand(rng, SHAPES[4], dtype)
    close(tops.sum_square_error(t(a), t(b)), golden.sum_square_error(a, b),
          dtype)
    from cytvdn_tpu.ops import stencil as jstencil

    lam = np.linspace(0.02, 0.05, 4).astype(dtype)
    mu = np.linspace(0.8, 1.2, 4).astype(dtype)
    for bc in (0, 1, 2):
        got = tstencil.tv_energy(t(a), t(b), t(lam), t(mu), BCMode(bc))
        want = jstencil.tv_energy(jnp.asarray(a), jnp.asarray(b),
                                  jnp.asarray(lam), jnp.asarray(mu), JBC(bc))
        close(got, want, dtype)


def test_halo_operands_equal_full_array_slices():
    """A halo slab stands in for the neighbour shard's slab exactly, for
    both difference operators (tests/test_ops.py's halo cases)."""
    rng = np.random.default_rng(600)
    a = rand(rng, (8, 6, 4), np.float64)
    b = rand(rng, (8, 6, 4), np.float64, 0.1)
    full_b, _ = golden.accumulator_update(a, b, 0, 0.3, 2)
    got_b, _ = tops.accumulator_update(t(a[4:]), t(b[4:]), 0, 0.3,
                                       BCMode.JIA_ZHAO, halo_prev=t(a[3:4]))
    np.testing.assert_allclose(got_b.numpy(), full_b[4:], atol=1e-14)

    orig, recon = rand(rng, (8, 6, 4), np.float64), rand(rng, (8, 6, 4), np.float64)
    bs = [rand(rng, (8, 6, 4), np.float64, 0.2) for _ in range(3)]
    lam_mu = np.full(3, 1.0 / 32)
    want, _ = golden.datacube_update(orig, recon, bs, lam_mu, 2)
    got, _, _ = tops.datacube_update(
        t(orig[:4]), t(recon[:4]), [t(x[:4]) for x in bs], t(lam_mu),
        BCMode.JIA_ZHAO, [t(bs[0][4:5]), None, None])
    np.testing.assert_allclose(got.numpy(), want[:4], atol=1e-14)
