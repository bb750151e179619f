"""The CUDA kernels of ``cytvdn_tpu_torch.kernels`` against their plain
PyTorch versions, on the card: state bitwise equal, the sums within
rtol 1e-5 (their summation order differs). The pair kernel is also held
bitwise against two launches of the one-iteration kernel, the K-step
kernel against K launches of it and (K even) K/2 pair launches, and both
against themselves at forced grid sizes (the race check of their in-place
schedules).

This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a card each test skips.
"""

import pytest

torch = pytest.importorskip("torch")

from cytvdn_tpu_torch.kernels import fused as tfused  # noqa: E402
from cytvdn_tpu_torch.kernels import kstep as tkstep  # noqa: E402
from cytvdn_tpu_torch.kernels import temporal as ttemporal  # noqa: E402

CASES = [
    # (shape, bc, iso_r, iso_q): odd extents catch the ragged tile edges
    ((37, 45, 19, 23), 0, False, False),
    ((37, 45, 19, 23), 1, False, False),
    ((37, 45, 19, 23), 2, False, False),
    ((37, 45, 19, 23), 2, True, True),
    ((13, 17, 70), 0, False, False),
    ((13, 17, 70), 1, False, False),
    ((13, 17, 70), 2, False, False),
    ((9, 10, 11, 12), 2, True, False),
    ((9, 10, 11, 12), 2, False, True),
]


def _run_both(shape, bc, iso_r, iso_q, fista, dtype, seed=0, iters=3):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ndim = len(shape)

    def rnd(scale):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=dtype) * scale

    orig = rnd(0.5) + 2.0
    state = [orig + rnd(0.05)] + [rnd(0.2) for _ in range(ndim)]
    if fista:
        state += [rnd(0.2) for _ in range(ndim)]
    li = torch.linspace(0.2, 0.35, ndim, device="cuda", dtype=dtype)
    lm = torch.linspace(1 / 32, 1 / 48, ndim, device="cuda", dtype=dtype)
    rho = torch.tensor(0.37, device="cuda", dtype=dtype)
    runs = []
    for step in (tfused.fused_iteration, tfused.fused_iteration_reference):
        s = [x.clone() for x in state]
        d = s[1 + ndim:] if fista else None
        sums = []
        for _ in range(iters):
            out = step(orig, s[0], s[1:1 + ndim], d, rho, li, lm,
                       fista=fista, bc=bc, iso_r=iso_r, iso_q=iso_q)
            sums.append(torch.stack(out[3:]).double().cpu())
        torch.cuda.synchronize()
        runs.append((s, torch.stack(sums)))
    return runs


@pytest.mark.cuda
@pytest.mark.parametrize("fista", [True, False])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_kernel_bitwise_equals_plain(case, fista):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    (ks, ksum), (ps, psum) = _run_both(*case, fista, torch.float32)
    for a, b in zip(ks, ps):
        assert torch.equal(a, b), (a - b).abs().max().item()
    torch.testing.assert_close(ksum, psum, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_kernel_bitwise_equals_plain_float64():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    (ks, ksum), (ps, psum) = _run_both((37, 45, 19, 23), 2, False, False,
                                       True, torch.float64)
    for a, b in zip(ks, ps):
        assert torch.equal(a, b), (a - b).abs().max().item()
    torch.testing.assert_close(ksum, psum, rtol=1e-12, atol=0)


@pytest.mark.cuda
def test_kernel_counts_launches_and_repeats_exactly():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    before = tfused.fused_iteration.launches
    a = _run_both((37, 45, 19, 23), 2, False, False, True, torch.float32)
    b = _run_both((37, 45, 19, 23), 2, False, False, True, torch.float32)
    assert tfused.fused_iteration.launches - before == 6
    # the partial sums are combined in a fixed order: traces repeat bitwise
    assert torch.equal(a[0][1], b[0][1])


# pair kernel: N0 = 4..7 (stages where only some row operations have a
# row), 3D and 4D, and ragged tile edges on every axis
PAIR_SHAPES = [(n0, 9, 10, 33) for n0 in (4, 5, 6, 7)] \
    + [(n0, 13, 70) for n0 in (4, 5, 6, 7)] + [(37, 45, 19, 23)]
RHOS = (0.0, 0.28, 0.43, 0.52)


def _jz_state(shape, fista, seed=0):
    """Random float32 state on the card that keeps each accumulator's
    leading slab along its own axis at zero (the Jia-Zhao invariant)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ndim = len(shape)

    def rnd(scale):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    orig = rnd(0.5) + 2.0
    state = [orig + rnd(0.05)] + [rnd(0.2) for _ in range(ndim)]
    if fista:
        state += [rnd(0.2) for _ in range(ndim)]
    for j, x in enumerate(state[1:]):
        x.select(j % ndim, 0).zero_()
    li = torch.linspace(0.2, 0.35, ndim, device="cuda")
    lm = torch.linspace(1 / 32, 1 / 48, ndim, device="cuda")
    rhos = [torch.tensor(r, device="cuda") for r in RHOS]
    return orig, state, li, lm, rhos


def _pairs(step, orig, state, li, lm, rhos, fista, **kw):
    """Two pairs of ``step`` (a pair function) on a copy of ``state``;
    returns the state and the 12 sums."""
    ndim = orig.dim()
    s = [x.clone() for x in state]
    d = s[1 + ndim:] if fista else None
    sums = []
    for i in (0, 2):
        out = step(orig, s[0], s[1:1 + ndim], d, rhos[i], rhos[i + 1], li, lm,
                   fista=fista, **kw)
        sums += list(out[3:])
    torch.cuda.synchronize()
    return s, torch.stack(sums).double().cpu()


def _two_k1_launches(orig, recon, accs, ds, rho1, rho2, li, lm, fista):
    """Two launches of the one-iteration kernel, shaped as a pair call."""
    sums = []
    for rho in (rho1, rho2):
        sums += list(tfused.fused_iteration(orig, recon, accs, ds, rho, li, lm,
                                            fista=fista)[3:])
    return (recon, accs, ds, *sums)


@pytest.mark.cuda
@pytest.mark.parametrize("fista", [True, False])
@pytest.mark.parametrize("shape", PAIR_SHAPES, ids=str)
def test_pair_kernel_bitwise_equals_plain_and_two_k1_launches(shape, fista):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    args = _jz_state(shape, fista)
    before = ttemporal.fused_pair_iteration.launches
    ks, ksum = _pairs(ttemporal.fused_pair_iteration, *args, fista)
    assert ttemporal.fused_pair_iteration.launches - before == 2
    ps, psum = _pairs(ttemporal.fused_pair_iteration_reference, *args, fista)
    k1s, k1sum = _pairs(_two_k1_launches, *args, fista)
    for a, b, c in zip(ks, ps, k1s):
        assert torch.equal(a, b), (a - b).abs().max().item()
        assert torch.equal(a, c), (a - c).abs().max().item()
    torch.testing.assert_close(ksum, psum, rtol=1e-5, atol=0)
    torch.testing.assert_close(ksum, k1sum, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(37, 45, 19, 23), (7, 13, 70)], ids=str)
def test_pair_kernel_state_independent_of_grid(shape):
    """The in-place schedule is race-free: one block, 7 blocks and the full
    cooperative grid give the same state bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    args = _jz_state(shape, True, seed=1)
    full = ttemporal.cooperative_grid(torch.device("cuda"), len(shape), True)
    runs = [_pairs(ttemporal.fused_pair_iteration, *args, True, grid=g)
            for g in (1, 7, full)]
    for s, sums in runs[1:]:
        for a, b in zip(runs[0][0], s):
            assert torch.equal(a, b), (a - b).abs().max().item()
        torch.testing.assert_close(sums, runs[0][1], rtol=1e-5, atol=0)
    with pytest.raises(RuntimeError, match="launch failed"):
        _pairs(ttemporal.fused_pair_iteration, *args, True, grid=full + 1)


@pytest.mark.cuda
def test_pair_kernel_repeats_exactly():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    args = _jz_state((37, 45, 19, 23), True, seed=2)
    a = _pairs(ttemporal.fused_pair_iteration, *args, True)
    b = _pairs(ttemporal.fused_pair_iteration, *args, True)
    assert torch.equal(a[1], b[1])
    for x, y in zip(a[0], b[0]):
        assert torch.equal(x, y)


# K-step kernel: N0 = 2K and 2K+1 (stages where only some of the 2K row
# operations have a row), 3D and 4D, and ragged tile edges on every axis
KS = (3, 4, 6, 8)
KSTEP_SHAPES = [(n0, 9, 10, 33) for n0 in ("2K", "2K+1")] \
    + [(n0, 13, 70) for n0 in ("2K", "2K+1")] + [(37, 45, 19, 23)]


def _at(shape, k):
    n0 = {"2K": 2 * k, "2K+1": 2 * k + 1}.get(shape[0], shape[0])
    return (n0,) + shape[1:]


def _ksteps(step, orig, state, li, lm, k, fista, **kw):
    """Two launches of ``step`` (a K-step function of depth ``k``) on a
    copy of ``state`` with 2k distinct momentum ratios; returns the state
    and the 6k sums."""
    ndim = orig.dim()
    s = [x.clone() for x in state]
    d = s[1 + ndim:] if fista else None
    rhos = torch.linspace(0.0, 0.6, 2 * k, device="cuda")
    sums = []
    for i in (0, k):
        out = step(orig, s[0], s[1:1 + ndim], d, rhos[i:i + k], li, lm, k=k,
                   fista=fista, **kw)
        sums += list(torch.stack(out[3:], 1).reshape(-1))
    torch.cuda.synchronize()
    return s, torch.stack(sums).double().cpu()


def _k1_launches(orig, recon, accs, ds, rhos, li, lm, k, fista):
    """K launches of the one-iteration kernel, shaped as a K-step call."""
    sums = [torch.stack(tfused.fused_iteration(
        orig, recon, accs, ds, rhos[t] if fista else None, li, lm,
        fista=fista)[3:]) for t in range(k)]
    return (recon, accs, ds, *torch.stack(sums).unbind(1))


def _pair_launches(orig, recon, accs, ds, rhos, li, lm, k, fista):
    """K/2 launches of the pair kernel, shaped as a K-step call."""
    sums = []
    for t in range(0, k, 2):
        r1, r2 = (rhos[t], rhos[t + 1]) if fista else (None, None)
        out = ttemporal.fused_pair_iteration(orig, recon, accs, ds, r1, r2,
                                             li, lm, fista=fista)
        sums += [torch.stack(out[3:6]), torch.stack(out[6:9])]
    return (recon, accs, ds, *torch.stack(sums).unbind(1))


@pytest.mark.cuda
@pytest.mark.parametrize("fista", [True, False])
@pytest.mark.parametrize("shape", KSTEP_SHAPES, ids=str)
@pytest.mark.parametrize("k", KS)
def test_kstep_kernel_bitwise_equals_plain_k1_and_pairs(k, shape, fista):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    shape = _at(shape, k)
    orig, state, li, lm, _ = _jz_state(shape, fista)
    args = (orig, state, li, lm, k, fista)
    before = tkstep.fused_kstep_iteration.launches
    ks, ksum = _ksteps(tkstep.fused_kstep_iteration, *args)
    assert tkstep.fused_kstep_iteration.launches - before == 2
    others = [_ksteps(tkstep.fused_kstep_iteration_reference, *args),
              _ksteps(_k1_launches, *args)]
    if k % 2 == 0:
        others.append(_ksteps(_pair_launches, *args))
    for s, sums in others:
        for a, b in zip(ks, s):
            assert torch.equal(a, b), (a - b).abs().max().item()
        torch.testing.assert_close(ksum, sums, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(37, 45, 19, 23), ("2K+1", 13, 70)],
                         ids=str)
@pytest.mark.parametrize("k", KS)
def test_kstep_kernel_state_independent_of_grid(k, shape):
    """The in-place schedule is race-free at every depth: one block, 7
    blocks and the full cooperative grid of that depth give the same state
    bitwise; a grid one block larger is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    shape = _at(shape, k)
    orig, state, li, lm, _ = _jz_state(shape, True, seed=1)
    full = tkstep.cooperative_grid(torch.device("cuda"), len(shape), True, k)
    runs = [_ksteps(tkstep.fused_kstep_iteration, orig, state, li, lm, k,
                    True, grid=g) for g in (1, 7, full)]
    for s, sums in runs[1:]:
        for a, b in zip(runs[0][0], s):
            assert torch.equal(a, b), (a - b).abs().max().item()
        torch.testing.assert_close(sums, runs[0][1], rtol=1e-5, atol=0)
    with pytest.raises(RuntimeError, match="launch failed"):
        _ksteps(tkstep.fused_kstep_iteration, orig, state, li, lm, k, True,
                grid=full + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("k", KS)
def test_kstep_kernel_repeats_exactly(k):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    orig, state, li, lm, _ = _jz_state((37, 45, 19, 23), True, seed=2)
    a = _ksteps(tkstep.fused_kstep_iteration, orig, state, li, lm, k, True)
    b = _ksteps(tkstep.fused_kstep_iteration, orig, state, li, lm, k, True)
    assert torch.equal(a[1], b[1])
    for x, y in zip(a[0], b[0]):
        assert torch.equal(x, y)
