"""The CUDA kernel of ``cytvdn_tpu_torch.kernels.fused`` against its plain
PyTorch version, on the card: state bitwise equal, the three sums within
rtol 1e-5 (their summation order differs).

This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a card each test skips.
"""

import pytest

torch = pytest.importorskip("torch")

from cytvdn_tpu_torch.kernels import fused as tfused  # noqa: E402

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
