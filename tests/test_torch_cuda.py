"""The CUDA kernels of ``cytvdn_tpu_torch.kernels`` against their plain
PyTorch versions, on the card: state bitwise equal, the sums within
rtol 1e-5 (their summation order differs). The pair kernel is also held
bitwise against two launches of the one-iteration kernel, the K-step
kernel against K launches of it and (K even) K/2 pair launches, and both
against themselves at forced grid sizes (the race check of their in-place
schedules), the pair kernel also at forced axis-1 strip widths, the K-step
kernel also at its tile edges, the pair kernel also with a reference
cube (its SSE). Stop-aware runs through the K-step and pair kernels equal
the one-iteration loop. The
whole-run kernel is held bitwise against its plain version and against T
launches of the one-iteration kernel, at forced grid sizes too. The
one-iteration kernel with operand halos (out-of-core slabs) is held
bitwise against its plain version with the same halos, slabs launched
with halos and reassembled against one launch of the whole cube, and
``denoise_outofcore`` on the card against ``denoise4D`` there; so is each
of its mesh-only modes (rings, mirror edges, iso seams and corners,
in-block axes), and mesh runs in those modes, ranks as threads sharing
the card, against the single-device run; so is its LOSSY instantiation
(bfloat16 shadow duals), with and without halos, at forced grids, d
included, and lossy runs on the card against the plain backend and
stream-mode ``denoise_outofcore``; so is the pair kernel's LOSSY
instantiations (bfloat16 shadow duals rounded in the middle of the pair),
plain, with a reference cube and with axis-0 bands, at forced grids and
strips, against two LOSSY K=1 launches, its seam rounding against torch's
bfloat16 cast on canary values, and lossy runs that pair on the card; so
is the K-step kernel's LOSSY instantiations (bfloat16 shadow duals rounded
at every level), at every depth, its tile edges, forced grids, rows per
stage and bfloat16 views off 16-byte boundaries, against K LOSSY K=1
launches and (K even) K/2 LOSSY pairs, and lossy runs that K-step on the
card against the lossy K=1 loop. The K=1 kernel's vector walk (its
float32 launches without halos, and with Jia-Zhao anisotropic halos on
axes 0 and 1) is held against its plain version at ragged last extents,
forced grids, item orders and states off 16-byte boundaries, d included,
and repeats exactly; with halos on the first, interior and last blocks
along axis 0 and axis 1, the corners of a 2 x 2 grid and blocks of extent
1, seam slabs off 16-byte boundaries too, and blocks put back against one
launch; float64 launches and the other launches with halos (axes 2 and 3,
rings, mirror edges, iso pairs) take the scalar passes.

This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a card each test skips.
"""

import pytest

torch = pytest.importorskip("torch")

# the K-step kernel's tile-edge cases and the K=1 kernel's vector-walk
# cases (with halos too), shared with the card smoke run
from chip_smoke import (  # noqa: E402
    WALK_HALO_LAYOUTS,
    WALK_HALO_MODES,
    WALK_HALO_SHAPES,
    compare_walk_halo_case,
    kstep_edge_cases,
    walk_cases,
    walk_halo_blocks_equal_one_launch,
    walk_state,
)
from cytvdn_tpu_torch.kernels import fused as tfused  # noqa: E402
from cytvdn_tpu_torch.kernels import kstep as tkstep  # noqa: E402
from cytvdn_tpu_torch.kernels import resident as tres  # noqa: E402
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


# the dual pass's ISO instantiations (4D launches with a half-isotropic
# pair): odd extents on every axis, last extents 1, 31 and 33
ISO_SHAPES = [(7, 9, 5, 1), (5, 7, 9, 31), (9, 5, 7, 33)]
ISO_PAIRS = [(True, False), (False, True), (True, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("fista", [True, False])
@pytest.mark.parametrize("iso", ISO_PAIRS, ids=["R", "Q", "RQ"])
@pytest.mark.parametrize("shape", ISO_SHAPES, ids=str)
def test_iso_kernel_bitwise_equals_plain_at_forced_grids(monkeypatch, shape,
                                                         iso, fista, dtype):
    """Three launches of the ISO instantiation at the wrapper's grid and at
    forced grids of 1, 7 and all blocks (one per work item) against the
    plain version: state bitwise, sums within rtol 1e-5 (1e-12 in
    float64)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    for grid in (None, 1, 7, tfused._work_items(shape)):
        if grid is not None:
            monkeypatch.setattr(tfused, "MAX_BLOCKS", grid)
        (ks, ksum), (ps, psum) = _run_both(shape, 2, *iso, fista, dtype)
        for a, b in zip(ks, ps):
            assert torch.equal(a, b), (grid, (a - b).abs().max().item())
        torch.testing.assert_close(ksum, psum, rtol=rtol, atol=0)


# pair kernel: N0 = 4..7 (stages where only some row operations have a
# row), 3D and 4D, and ragged tile edges on every axis
PAIR_SHAPES = [(n0, 9, 10, 33) for n0 in (4, 5, 6, 7)] \
    + [(n0, 13, 70) for n0 in (4, 5, 6, 7)] + [(37, 45, 19, 23)]
# forced axis-1 strip widths: one index, two, three, and N1 (the
# whole-row schedule); None is the wrapper's default, whole rows too
PAIR_STRIPS = (None, 1, 2, 3, "N1")
RHOS = (0.0, 0.28, 0.43, 0.52)


def _strip(strip, shape):
    return shape[1] if strip == "N1" else strip


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
@pytest.mark.parametrize("strip", PAIR_STRIPS, ids=str)
@pytest.mark.parametrize("fista", [True, False])
@pytest.mark.parametrize("shape", PAIR_SHAPES, ids=str)
def test_pair_kernel_bitwise_equals_plain_and_two_k1_launches(shape, fista,
                                                              strip):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    args = _jz_state(shape, fista)
    before = ttemporal.fused_pair_iteration.launches
    ks, ksum = _pairs(ttemporal.fused_pair_iteration, *args, fista,
                      strip=_strip(strip, shape))
    assert ttemporal.fused_pair_iteration.launches - before == 2
    ps, psum = _pairs(ttemporal.fused_pair_iteration_reference, *args, fista)
    k1s, k1sum = _pairs(_two_k1_launches, *args, fista)
    for a, b, c in zip(ks, ps, k1s):
        assert torch.equal(a, b), (a - b).abs().max().item()
        assert torch.equal(a, c), (a - c).abs().max().item()
    torch.testing.assert_close(ksum, psum, rtol=1e-5, atol=0)
    torch.testing.assert_close(ksum, k1sum, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("strip", PAIR_STRIPS, ids=str)
@pytest.mark.parametrize("shape", [(37, 45, 19, 23), (7, 13, 70)], ids=str)
def test_pair_kernel_state_independent_of_grid(shape, strip):
    """The in-place schedule is race-free at every strip width: one block,
    7 blocks and the full cooperative grid give the plain pair's state
    bitwise; a grid one block larger is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    args = _jz_state(shape, True, seed=1)
    strip = _strip(strip, shape)
    full = ttemporal.cooperative_grid(torch.device("cuda"), len(shape), True)
    want = _pairs(ttemporal.fused_pair_iteration_reference, *args, True)
    runs = [_pairs(ttemporal.fused_pair_iteration, *args, True, grid=g,
                   strip=strip) for g in (1, 7, full)]
    for s, sums in runs:
        for a, b in zip(want[0], s):
            assert torch.equal(a, b), (a - b).abs().max().item()
        torch.testing.assert_close(sums, want[1], rtol=1e-5, atol=0)
    with pytest.raises(RuntimeError, match="launch failed"):
        _pairs(ttemporal.fused_pair_iteration, *args, True, grid=full + 1,
               strip=strip)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,strip", [
    ((5, 10, 9, 33), 3),     # 4D, W does not divide N1
    ((6, 13, 70), 5),        # 3D, W does not divide N1
    ((6, 45, 70), 11),       # 3D, strips wider than the 8-row tile: each
    ((5, 45, 19, 23), 20),   # op's tiles start at jW - lag, off the 8-grid
    ((6, 45, 70), 20),
], ids=str)
@pytest.mark.parametrize("fista", [True, False])
def test_pair_kernel_ragged_strips(shape, strip, fista):
    """Strips that do not divide axis 1, and 3D strips wider than a tile
    whose tiles start off the tile grid, at the full grid and at 1 and 7
    blocks: the plain pair's and two K=1 launches' state bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    args = _jz_state(shape, fista, seed=3)
    want = _pairs(ttemporal.fused_pair_iteration_reference, *args, fista)
    k1s = _pairs(_two_k1_launches, *args, fista)
    for g in (None, 1, 7):
        ks, ksum = _pairs(ttemporal.fused_pair_iteration, *args, fista,
                          grid=g, strip=strip)
        for other in (want, k1s):
            for a, b in zip(ks, other[0]):
                assert torch.equal(a, b), (g, (a - b).abs().max().item())
            torch.testing.assert_close(ksum, other[1], rtol=1e-5, atol=0)


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


@pytest.mark.cuda
@pytest.mark.parametrize("fista", [True, False])
@pytest.mark.parametrize("shape", PAIR_SHAPES, ids=str)
def test_pair_kernel_with_ref_bitwise_equals_plain(shape, fista):
    """With a reference cube (the REF instantiation): the plain pair's
    state bitwise and its eight sums per pair (both SSEs among them) within
    rtol 1e-5, at the full grid and at forced grids of 1 and 7 blocks. The
    launch without a reference cube gives the same state and six sums."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    args = _jz_state(shape, fista, seed=4)
    gen = torch.Generator(device="cuda").manual_seed(5)
    ref = torch.randn(shape, generator=gen, device="cuda") * 0.5 + 2.0
    want = _pairs(ttemporal.fused_pair_iteration_reference, *args, fista,
                  ref=ref)
    assert want[1].numel() == 16
    full = ttemporal.cooperative_grid(torch.device("cuda"), len(shape), fista,
                                      True)
    for g in (None, 1, 7, full):
        ks, ksum = _pairs(ttemporal.fused_pair_iteration, *args, fista,
                          grid=g, ref=ref)
        for a, b in zip(ks, want[0]):
            assert torch.equal(a, b), (g, (a - b).abs().max().item())
        torch.testing.assert_close(ksum, want[1], rtol=1e-5, atol=0)
    plain, psum = _pairs(ttemporal.fused_pair_iteration, *args, fista)
    for a, b in zip(plain, want[0]):
        assert torch.equal(a, b)
    keep = [j for j in range(16) if j % 8 < 6]
    torch.testing.assert_close(psum, want[1][keep], rtol=1e-5, atol=0)


def _stop_threshold(delta, stop_at):
    """A threshold between the deltas of iterations ``stop_at - 1`` and
    ``stop_at`` of a fixed run's trace."""
    d = delta.double().cpu()
    assert 0 < d[stop_at] < d[stop_at - 1]
    return float((d[stop_at] * min(d[stop_at - 1], d[stop_at] * 4)).sqrt())


@pytest.mark.cuda
@pytest.mark.parametrize("guard", ["real", "always"])
@pytest.mark.parametrize("mse", [False, True])
def test_stop_aware_run_solver_equals_k1_loop(monkeypatch, guard, mse):
    """A stop-aware hybrid run on the card through K=8 launches and pairs
    (with ``calculate_mse``: pairs with the reference cube) equals the
    one-iteration loop bitwise in recon and stop, the traces within rtol
    1e-5; with a guard that always allows, blocks are discarded and
    redone."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from cytvdn_tpu_torch.config import SolverOptions
    from cytvdn_tpu_torch.solver import engine

    monkeypatch.setattr(engine, "PAIR_MIN_ROW_BYTES", 0)
    shape = (16, 9, 10, 64)
    gen = torch.Generator(device="cuda").manual_seed(6)
    orig = torch.randn(shape, generator=gen, device="cuda") * 0.5 + 2.0
    ref = torch.randn(shape, generator=gen, device="cuda") * 0.1 + 2.0 \
        if mse else None
    li = torch.full((4,), 32.0, device="cuda")
    lm = torch.full((4,), 1 / 32, device="cuda")
    base = dict(ndim=4, iterations_fista=12, iterations_unacc=40,
                calculate_mse=mse, vmem_resident=False)
    probe = engine.run_solver(orig, li, lm, SolverOptions(
        **base, temporal_pairs=False), reference_data=ref)
    stop = dict(stopping_relative_change=_stop_threshold(probe["delta"], 40))
    want = engine.run_solver(orig, li, lm, SolverOptions(
        **base, **stop, temporal_pairs=False), reference_data=ref)
    if guard == "always":
        monkeypatch.setattr(engine, "_guard_allows", lambda *a: True)
    counters = (tkstep.fused_kstep_iteration, ttemporal.fused_pair_iteration)
    before = [c.launches for c in counters]
    got = engine.run_solver(orig, li, lm, SolverOptions(**base, **stop),
                            reference_data=ref)
    ks, pairs = (c.launches - b for c, b in zip(counters, before))
    assert ks + pairs > 0 and (ks == 0) == mse
    assert got["iterations_run"] == want["iterations_run"] == 41
    assert got["early_stopped"] and want["early_stopped"]
    assert torch.equal(got["recon"], want["recon"])
    for key in ("b_norm", "delta") + (("mse",) if mse else ()):
        torch.testing.assert_close(got[key], want[key], rtol=1e-5, atol=0)


# K-step kernel: N0 = 2K and 2K+1 (stages where only some of the 2K row
# operations have a row), 3D and 4D, ragged tile edges on every axis (the
# element-by-element walk) and last extents that are a multiple of 4 (the
# 128-bit walk, VEC)
KS = (3, 4, 6, 8)
KSTEP_SHAPES = [(n0, 9, 10, 33) for n0 in ("2K", "2K+1")] \
    + [(n0, 13, 70) for n0 in ("2K", "2K+1")] + [(37, 45, 19, 23)] \
    + [("2K", 9, 10, 32), ("2K+1", 13, 64), ("2K", 16, 512)]


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
@pytest.mark.parametrize("shape,k,fista", kstep_edge_cases(), ids=str)
def test_kstep_kernel_tile_edges(shape, k, fista):
    """At the vector walk's tile edges: the full grid, 1 block and 7 blocks
    give the plain version's state, K one-iteration launches' and (K even)
    K/2 pair launches', bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    orig, state, li, lm, _ = _jz_state(shape, fista, seed=3)
    args = (orig, state, li, lm, k, fista)
    ks, ksum = _ksteps(tkstep.fused_kstep_iteration, *args)
    runs = [_ksteps(tkstep.fused_kstep_iteration, *args, grid=g)
            for g in (1, 7)]
    runs += [_ksteps(tkstep.fused_kstep_iteration_reference, *args),
             _ksteps(_k1_launches, *args)]
    if k % 2 == 0:
        runs.append(_ksteps(_pair_launches, *args))
    for s, sums in runs:
        for a, b in zip(ks, s):
            assert torch.equal(a, b), (a - b).abs().max().item()
        torch.testing.assert_close(ksum, sums, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [("N0", 9, 10, 33), ("N0", 13, 64)],
                         ids=str)
@pytest.mark.parametrize("rr", (1, 2, 3))
@pytest.mark.parametrize("k", KS)
def test_kstep_kernel_rows_per_stage(k, rr, shape):
    """R axis-0 rows per stage, N0 not a multiple of R (4D FISTA ragged, 3D
    unaccelerated 128-bit), at the full grid and at 1 and 7 blocks: the
    plain version's state and K one-iteration launches', bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    n0 = 2 * k + 1 if (2 * k + 1) % rr or rr == 1 else 2 * k + 2
    shape = (n0,) + shape[1:]
    fista = len(shape) == 4
    orig, state, li, lm, _ = _jz_state(shape, fista, seed=5)
    args = (orig, state, li, lm, k, fista)
    runs = [_ksteps(tkstep.fused_kstep_iteration, *args, grid=g,
                    rows_per_stage=rr) for g in (None, 1, 7)]
    runs += [_ksteps(tkstep.fused_kstep_iteration_reference, *args),
             _ksteps(_k1_launches, *args)]
    for s, sums in runs[1:]:
        for a, b in zip(runs[0][0], s):
            assert torch.equal(a, b), (a - b).abs().max().item()
        torch.testing.assert_close(runs[0][1], sums, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_kstep_kernel_unaligned_state():
    """An array that starts off a 16-byte boundary (here orig) sends the
    kernel to its element-by-element walk even where the last extent is a
    multiple of 4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    orig, state, li, lm, _ = _jz_state((9, 9, 32), True, seed=4)
    orig = torch.empty(orig.numel() + 1, device="cuda")[1:].view(
        orig.shape).copy_(orig)
    assert orig.data_ptr() % 16
    args = (orig, state, li, lm, 4, True)
    ks, ksum = _ksteps(tkstep.fused_kstep_iteration, *args)
    s, sums = _ksteps(tkstep.fused_kstep_iteration_reference, *args)
    for a, b in zip(ks, s):
        assert torch.equal(a, b), (a - b).abs().max().item()
    torch.testing.assert_close(ksum, sums, rtol=1e-5, atol=0)


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


# whole-run kernel: (shape, bc, iso_r, iso_q, momentum schedule, with ref),
# every BC, iso pairs, FISTA / unaccelerated / hybrid (FISTA with trailing
# zero momenta), the SSE trace, ragged tile edges and N0 = 2
RES_T = 6
RES_CASES = [
    ((37, 45, 19, 23), 0, False, False, "fista", False),
    ((37, 45, 19, 23), 1, False, False, "unacc", True),
    ((37, 45, 19, 23), 2, False, False, "hybrid", True),
    ((37, 45, 19, 23), 2, True, True, "fista", False),
    ((9, 10, 11, 12), 2, True, False, "unacc", True),
    ((9, 10, 11, 12), 2, False, True, "hybrid", False),
    ((13, 17, 70), 0, False, False, "hybrid", True),
    ((13, 17, 70), 1, False, False, "fista", False),
    ((13, 17, 70), 2, False, False, "unacc", False),
    ((2, 17, 70), 2, False, False, "fista", True),
]


def _res_state(shape, schedule, with_ref, seed=0):
    """Random float32 state on the card, the momentum ratios of the
    schedule (None unaccelerated) and, with ``with_ref``, a reference
    cube."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ndim = len(shape)
    fista = schedule != "unacc"

    def rnd(scale):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    orig = rnd(0.5) + 2.0
    state = [orig + rnd(0.05)] + [rnd(0.2) for _ in range(ndim)]
    if fista:
        state += [rnd(0.2) for _ in range(ndim)]
    ref = rnd(0.5) + 2.0 if with_ref else None
    li = torch.linspace(0.2, 0.35, ndim, device="cuda")
    lm = torch.linspace(1 / 32, 1 / 48, ndim, device="cuda")
    rhos = None
    if fista:
        rhos = torch.linspace(0.1, 0.6, RES_T, device="cuda")
        if schedule == "hybrid":
            rhos[RES_T // 2:] = 0.0
    return orig, state, li, lm, rhos, ref


def _res_run(step, orig, state, li, lm, rhos, ref, bc, iso_r, iso_q, **kw):
    """``step`` (a whole-run function) for RES_T iterations on a copy of
    ``state``; returns the state and the (3 or 4, RES_T) sums."""
    ndim = orig.dim()
    s = [x.clone() for x in state]
    d = s[1 + ndim:] if rhos is not None else None
    out = step(orig, s[0], s[1:1 + ndim], d, rhos, li, lm, n_iters=RES_T,
               fista=rhos is not None, bc=bc, ref=ref, iso_r=iso_r,
               iso_q=iso_q, **kw)
    torch.cuda.synchronize()
    return s, torch.stack(out[3:]).double().cpu()


def _res_k1_launches(orig, recon, accs, ds, rhos, li, lm, *, n_iters, fista,
                     bc, ref, iso_r, iso_q):
    """``n_iters`` launches of the one-iteration kernel (and the SSE after
    each), shaped as a whole-run call."""
    sums = []
    for t in range(n_iters):
        row = list(tfused.fused_iteration(
            orig, recon, accs, ds, rhos[t] if fista else None, li, lm,
            fista=fista, bc=bc, iso_r=iso_r, iso_q=iso_q)[3:])
        if ref is not None:
            row.append(((ref - recon) ** 2).sum())
        sums.append(torch.stack(row))
    return (recon, accs, ds, *torch.stack(sums).unbind(1))


@pytest.mark.cuda
@pytest.mark.parametrize("case", RES_CASES, ids=str)
def test_resident_kernel_bitwise_equals_plain_and_k1_launches(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    shape, bc, iso_r, iso_q, schedule, with_ref = case
    orig, state, li, lm, rhos, ref = _res_state(shape, schedule, with_ref)
    args = (orig, state, li, lm, rhos, ref, bc, iso_r, iso_q)
    before = tres.resident_solve.launches
    ks, ksum = _res_run(tres.resident_solve, *args)
    assert tres.resident_solve.launches - before == 1
    assert ksum.shape == (4 if with_ref else 3, RES_T)
    for step in (tres.resident_solve_reference, _res_k1_launches):
        s, sums = _res_run(step, *args)
        for a, b in zip(ks, s):
            assert torch.equal(a, b), (a - b).abs().max().item()
        torch.testing.assert_close(ksum, sums, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [RES_CASES[2], RES_CASES[3], RES_CASES[6]],
                         ids=str)
def test_resident_kernel_state_independent_of_grid(case):
    """The grid-stride schedule with its grid barriers is race-free: one
    block, 7 blocks and the full cooperative grid give the same state
    bitwise; a grid one block larger is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    shape, bc, iso_r, iso_q, schedule, with_ref = case
    args = _res_state(shape, schedule, with_ref, seed=1)
    args = (*args, bc, iso_r, iso_q)
    full = tres.cooperative_grid(torch.device("cuda"), len(shape),
                                 schedule != "unacc", iso_r or iso_q,
                                 with_ref)
    runs = [_res_run(tres.resident_solve, *args, grid=g) for g in (1, 7, full)]
    for s, sums in runs[1:]:
        for a, b in zip(runs[0][0], s):
            assert torch.equal(a, b), (a - b).abs().max().item()
        torch.testing.assert_close(sums, runs[0][1], rtol=1e-5, atol=0)
    with pytest.raises(RuntimeError, match="launch failed"):
        _res_run(tres.resident_solve, *args, grid=full + 1)


def _ragged_cases():
    """The whole-run kernel's tile edges: last-axis lengths around its
    four-element groups and 32-lane segments, ND-2 lengths around its tile
    rows, every BC (mirror where every extent is >= 2), every momentum
    schedule, with and without a reference cube, iso pairs in 4D."""
    cases = []
    schedules = ("fista", "unacc", "hybrid")
    for i, last in enumerate((1, 3, 5, 31, 33, 127, 129)):
        for j, m in enumerate((1, 7, 9)):
            bc = (i + j) % 3
            if bc == 1 and min(m, last) < 2:
                bc = 2 * (i % 2)
            cases.append(((3, m, last), bc, False, False,
                          schedules[(i + 2 * j) % 3], (i + j) % 2 == 0))
    for i, (m, last) in enumerate(((1, 3), (7, 33), (9, 129), (7, 5),
                                   (9, 31), (1, 127))):
        iso = ((True, False), (False, True), (True, True))[i % 3]
        cases.append(((2, 3, m, last), 2, *iso, schedules[i % 3], i % 2 == 1))
    cases.append(((3, 2, 9, 33), 0, False, False, "fista", True))
    cases.append(((3, 2, 7, 5), 1, False, False, "unacc", False))
    return cases


RAGGED_CASES = _ragged_cases()


@pytest.mark.cuda
@pytest.mark.parametrize("case", RAGGED_CASES, ids=str)
def test_resident_kernel_ragged_edges(case):
    """At the tiles' ragged edges: the full grid, 1 block and 7 blocks give
    the plain version's state and T one-iteration launches' bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    shape, bc, iso_r, iso_q, schedule, with_ref = case
    args = (*_res_state(shape, schedule, with_ref, seed=3), bc, iso_r, iso_q)
    ks, ksum = _res_run(tres.resident_solve, *args)
    runs = [_res_run(tres.resident_solve, *args, grid=g) for g in (1, 7)]
    runs += [_res_run(step, *args) for step in (tres.resident_solve_reference,
                                                 _res_k1_launches)]
    for s, sums in runs:
        for a, b in zip(ks, s):
            assert torch.equal(a, b), (a - b).abs().max().item()
        torch.testing.assert_close(ksum, sums, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_resident_kernel_unaligned_state():
    """An array that starts off a 16-byte boundary (here orig and ref) sends
    the kernel to its scalar loads even where the last extent is a multiple
    of 4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    orig, state, li, lm, rhos, ref = _res_state((3, 9, 32), "fista", True,
                                                seed=4)

    def shifted(x):
        return torch.empty(x.numel() + 1, device="cuda")[1:].view(
            x.shape).copy_(x)

    orig, ref = shifted(orig), shifted(ref)
    assert orig.data_ptr() % 16 and ref.data_ptr() % 16
    args = (orig, state, li, lm, rhos, ref, 1, False, False)
    ks, ksum = _res_run(tres.resident_solve, *args)
    s, sums = _res_run(tres.resident_solve_reference, *args)
    for a, b in zip(ks, s):
        assert torch.equal(a, b), (a - b).abs().max().item()
    torch.testing.assert_close(ksum, sums, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_resident_kernel_repeats_exactly():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    shape, bc, iso_r, iso_q, schedule, with_ref = RES_CASES[2]
    args = (*_res_state(shape, schedule, with_ref, seed=2), bc, iso_r, iso_q)
    a = _res_run(tres.resident_solve, *args)
    b = _res_run(tres.resident_solve, *args)
    assert torch.equal(a[1], b[1])
    for x, y in zip(a[0], b[0]):
        assert torch.equal(x, y)


# chunked runs on the card (``run_chunked``, ``run_solver``'s ``state`` and
# ``i_stop``): (name, shape, (n_fista, n_unacc), options, MSE, stop
# iteration or None, the kernel the path launches, the least chunk that
# holds a launch of it)
CHUNK_PATHS = [
    ("whole-run", (8, 6, 64), (0, 40), {}, False, None, "resident", 1),
    ("whole-run-mse-hybrid", (6, 4, 6, 16), (12, 9), {}, True, None,
     "resident", 1),
    ("kstep", (16, 9, 10, 64), (30, 0), dict(vmem_resident=False), False,
     None, "kstep", 8),
    ("pair", (7, 12, 6, 16), (30, 0),
     dict(vmem_resident=False, temporal_kstep=False), False, None, "pair", 2),
    ("k1", (16, 9, 10, 64), (12, 9),
     dict(vmem_resident=False, temporal_pairs=False), False, None, "fused", 1),
    ("hybrid", (16, 9, 10, 64), (12, 9), dict(vmem_resident=False), False,
     None, "kstep", 8),
    ("mse", (16, 9, 10, 64), (20, 7), dict(vmem_resident=False), True, None,
     "pair", 2),
    ("stop", (16, 9, 10, 64), (12, 40), dict(vmem_resident=False), False, 40,
     "kstep", 8),
]


@pytest.mark.cuda
@pytest.mark.parametrize("every", [1, 3, 7, 25])
@pytest.mark.parametrize("name,shape,iters,kw,mse,stop_at,kernel,least",
                         CHUNK_PATHS, ids=[p[0] for p in CHUNK_PATHS])
def test_chunked_run_solver_equals_unchunked(monkeypatch, name, shape, iters,
                                             kw, mse, stop_at, kernel, least,
                                             every):
    """Each engine path in chunks of 1, 3, 7 and 25 iterations on the card:
    recon bitwise the unchunked run's and the same stop; the traces within
    rtol 1e-5 (delta 1e-4), since a chunk boundary may change which kernel
    sums an iteration."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import numpy as np

    from cytvdn_tpu_torch.config import SolverOptions
    from cytvdn_tpu_torch.solver import engine
    from cytvdn_tpu_torch.utils.checkpoint import run_chunked

    monkeypatch.setattr(engine, "PAIR_MIN_ROW_BYTES", 0)
    ndim = len(shape)
    rng = np.random.default_rng(sum(shape))
    orig = (rng.standard_normal(shape) * 0.5 + 2.0).astype(np.float32)
    ref = (rng.standard_normal(shape) * 0.1 + 2.0).astype(np.float32) \
        if mse else None
    div = 16.0 if ndim == 3 else 32.0
    li = np.full(ndim, div, np.float32)
    lm = np.full(ndim, 1 / div, np.float32)
    to = [torch.from_numpy(x).cuda() for x in (orig, li, lm)]
    tref = torch.from_numpy(ref).cuda() if mse else None
    base = dict(ndim=ndim, iterations_fista=iters[0],
                iterations_unacc=iters[1], calculate_mse=mse, **kw)
    if stop_at is not None:
        probe = engine.run_solver(*to, SolverOptions(
            **base, temporal_pairs=False), reference_data=tref)
        base["stopping_relative_change"] = _stop_threshold(probe["delta"],
                                                           stop_at)
    opts = SolverOptions(**base)
    want = engine.run_solver(*to, opts, reference_data=tref)
    counters = {"resident": tres.resident_solve,
                "kstep": tkstep.fused_kstep_iteration,
                "pair": ttemporal.fused_pair_iteration,
                "fused": tfused.fused_iteration}
    before = counters[kernel].launches
    got = run_chunked(orig, li, lm, opts, None, every, reference_data=ref,
                      device="cuda")
    assert got["iterations_run"] == want["iterations_run"]
    if stop_at is not None:
        assert want["iterations_run"] == stop_at + 1
    assert np.array_equal(got["recon"], want["recon"].cpu().numpy())
    for key, rtol in (("b_norm", 1e-5), ("delta", 1e-4)) \
            + ((("mse", 1e-5),) if mse else ()):
        np.testing.assert_allclose(got[key], want[key].cpu().numpy(),
                                   rtol=rtol, atol=0, err_msg=key)
    if every >= least:
        assert counters[kernel].launches > before


@pytest.mark.cuda
def test_ladder_forced_oom_on_the_card():
    """A stop run on a card filled so that its state fits and its block
    checkpoint does not: the K-step phase's checkpoint raises
    ``torch.OutOfMemoryError``, the ladder turns ``vmem_resident`` and then
    ``temporal_kstep`` off (2 MiB rows take no pairs), each retry starts at
    the memory the first attempt started from, and the one-iteration loop
    stops where the unfilled K=1 run does, with its recon bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import warnings

    from cytvdn_tpu_torch.config import SolverOptions
    from cytvdn_tpu_torch.solver import engine

    shape = (64, 256, 2048)  # 128 MiB per cube
    gen = torch.Generator(device="cuda").manual_seed(9)
    orig = torch.randn(shape, generator=gen, device="cuda") * 0.5 + 2.0
    li = torch.full((3,), 16.0, device="cuda")
    lm = torch.full((3,), 1 / 16, device="cuda")
    base = dict(ndim=3, iterations_fista=0, iterations_unacc=60)
    probe = engine.run_solver(orig, li, lm, SolverOptions(
        **base, temporal_pairs=False))
    opts = SolverOptions(**base, stopping_relative_change=_stop_threshold(
        probe["delta"], 45))
    want = engine.run_solver(orig, li, lm, SolverOptions(
        **base, stopping_relative_change=opts.stopping_relative_change,
        temporal_pairs=False))
    want = {k: v.cpu() if torch.is_tensor(v) else v for k, v in want.items()}
    del probe
    torch.cuda.empty_cache()
    cube = orig.numel() * 4
    free, _ = torch.cuda.mem_get_info()
    # the state besides orig (recon, 3 accumulators) fits with 256 MiB to
    # spare; its checkpoint (4 cubes more) does not
    filler = torch.empty(free - 4 * cube - 256 * 2**20, dtype=torch.uint8,
                         device="cuda")
    starts = []

    def call(o):
        starts.append(torch.cuda.memory_allocated())
        return engine.run_solver(orig, li, lm, o)

    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            got = engine.vmem_fallback(opts, call)
        rungs = [str(w.message).split("retrying with ")[1].split("=")[0]
                 for w in rec if "device memory exhausted" in str(w.message)]
        assert rungs == ["vmem_resident", "temporal_kstep"]
        assert len(starts) == 3 and len(set(starts)) == 1, starts
        assert got["iterations_run"] == want["iterations_run"] == 46
        assert torch.equal(got["recon"].cpu(), want["recon"])
    finally:
        del filler
        torch.cuda.empty_cache()


# -- the K=1 kernel's operand halos and out-of-core runs ---------------------

HALO_SHAPES = [(15, 45, 19, 23), (12, 13, 70), (9, 9, 10, 33)]


def _halo_state(shape, fista, dtype, seed=0):
    """A random state on the card and, for the slab [a0, a1) of each of
    three slabs, its seam operands from that state (nonzero values)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ndim = len(shape)

    def rnd(scale, s=shape):
        return torch.randn(s, generator=gen, device="cuda",
                           dtype=dtype) * scale

    orig = rnd(0.5) + 2.0
    state = [orig + rnd(0.05)] + [rnd(0.2) for _ in range(ndim)]
    if fista:
        state += [rnd(0.2) for _ in range(ndim)]
    return orig, state


def _seams(state, ndim, a0, a1, fista):
    n0 = state[0].shape[0]
    r, acc0 = state[0], state[1]
    d0 = state[1 + ndim] if fista else None
    own = r[a0:a1]
    z = torch.zeros_like(own[:, 0:1])
    h = {"prev0": r[a0 - 1:a0] if a0 > 0 else own[0:1],
         "prev1": own[:, 0:1], "next1_recon": own[:, -1:], "next1_acc": z}
    last = a1 == n0
    h["next0_recon"] = own[-1:] if last else r[a1:a1 + 1]
    h["next0_acc"] = torch.zeros_like(own[-1:]) if last else acc0[a1:a1 + 1]
    if fista:
        h["next0_d"] = torch.zeros_like(own[-1:]) if last else d0[a1:a1 + 1]
        h["next1_d"] = z
    return {k: v.contiguous() for k, v in h.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("where", ["first", "interior", "last"])
@pytest.mark.parametrize("fista", [True, False])
@pytest.mark.parametrize("shape", HALO_SHAPES, ids=str)
def test_halo_kernel_bitwise_equals_plain(shape, fista, where, dtype):
    """The kernel's HALO instantiation against the plain version with the
    same halos, three iterations on the first, an interior and the last
    of three slabs: state bitwise equal, sums within rtol 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    ndim = len(shape)
    orig, state = _halo_state(shape, fista, dtype)
    n = shape[0] // 3
    a0, a1 = {"first": (0, n), "interior": (n, 2 * n),
              "last": (2 * n, shape[0])}[where]
    h = _seams(state, ndim, a0, a1, fista)
    li = torch.linspace(0.2, 0.35, ndim, device="cuda", dtype=dtype)
    lm = torch.linspace(1 / 32, 1 / 48, ndim, device="cuda", dtype=dtype)
    rho = torch.tensor(0.37, device="cuda", dtype=dtype)
    runs = []
    for step in (tfused.fused_iteration, tfused.fused_iteration_reference):
        s = [x[a0:a1].clone() for x in state]
        sums = []
        for _ in range(3):
            out = step(orig[a0:a1].contiguous(), s[0], s[1:1 + ndim],
                       s[1 + ndim:] if fista else None, rho, li, lm,
                       fista=fista, halos=h)
            sums.append(torch.stack(out[3:]).double().cpu())
        torch.cuda.synchronize()
        runs.append((s, torch.stack(sums)))
    (ks, ksum), (ps, psum) = runs
    for a, b in zip(ks, ps):
        assert torch.equal(a, b), (a - b).abs().max().item()
    torch.testing.assert_close(ksum, psum, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_slabs", [1, 3, 4])
@pytest.mark.parametrize("fista", [True, False])
@pytest.mark.parametrize("shape", HALO_SHAPES, ids=str)
def test_halo_slabs_reassemble_to_one_launch(shape, fista, n_slabs):
    """A cube cut into ragged slabs, each launched with halos from the
    pre-update state, reassembled: bitwise one in-core K=1 launch (the
    Jia-Zhao invariant held, as in a run)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from cytvdn_tpu_torch.solver.outofcore import _slab_bounds

    ndim = len(shape)
    orig, state = _halo_state(shape, fista, torch.float32, seed=1)
    for k in range(ndim):
        for x in (state[1 + k], state[1 + ndim + k] if fista else None):
            if x is not None:
                x.narrow(k, 0, 1).zero_()
    li = torch.linspace(0.2, 0.35, ndim, device="cuda")
    lm = torch.linspace(1 / 32, 1 / 48, ndim, device="cuda")
    rho = torch.tensor(0.37, device="cuda")
    whole = [x.clone() for x in state]
    tfused.fused_iteration(orig, whole[0], whole[1:1 + ndim],
                           whole[1 + ndim:] if fista else None, rho, li, lm,
                           fista=fista)
    cut = [x.clone() for x in state]
    for a0, a1 in _slab_bounds(shape[0], n_slabs):
        h = _seams(state, ndim, a0, a1, fista)
        s = [x[a0:a1].clone() for x in state]
        tfused.fused_iteration(orig[a0:a1].contiguous(), s[0],
                               s[1:1 + ndim], s[1 + ndim:] if fista else None,
                               rho, li, lm, fista=fista, halos=h)
        for dst, src in zip(cut, s):
            dst[a0:a1] = src
    torch.cuda.synchronize()
    for a, b in zip(cut, whole):
        assert torch.equal(a, b), (a - b).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("temporal_k", [1, 3])
def test_outofcore_on_the_card_bitwise_incore(temporal_k):
    """``denoise_outofcore`` on the card (pinned host state, the copy
    stream, halo launches or margins with pairs) against ``denoise4D`` on
    the card: recon bitwise, hybrid schedule."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import numpy as np

    from cytvdn_tpu_torch import denoise4D
    from cytvdn_tpu_torch.solver.outofcore import denoise_outofcore

    cube = (np.random.default_rng(3).standard_normal((22, 9, 10, 33)) * 0.5
            + 2.0).astype(np.float32)
    mu = np.full(4, 1.0, np.float32)
    before = tfused.fused_iteration.launches
    got = denoise_outofcore(cube, mu, iterations=(5, 4), n_slabs=3,
                            temporal_k=temporal_k, device="cuda")
    assert tfused.fused_iteration.launches > before
    want = denoise4D(cube, mu, iterations=(5, 4), quiet=True, device="cuda")
    np.testing.assert_array_equal(got[0], want[0])


# -- the pair kernel's axis-0 bands (HALO0) and mesh runs --------------------

HALO0_SHAPES = [(12, 13, 19, 23), (16, 9, 70), (8, 4, 10, 33), (12, 37, 9)]


def _halo0_state(shape, fista, seed=0):
    """A random Jia-Zhao state of a whole cube on the card: each
    accumulator's leading slab along its own axis is zero, so the own row 0
    of every slab but the first holds nonzero axis-0 accumulators (the
    Jia-Zhao wrap a shard must not read there)."""
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
    return orig, state, li, lm


def _halo0_slab(step, orig, state, li, lm, fista, a0, a1, ref=None,
                drop=False, **kw):
    """One pair of ``step`` on rows [a0, a1) with the bands cut from the
    whole state (with ``drop``, a missing neighbour's bands left out, as
    the engine leaves them); returns the slab's state and its sums."""
    ndim = orig.dim()
    accs, ds = state[1:1 + ndim], state[1 + ndim:] if fista else None
    h, f0, l0 = ttemporal.halo0_bands(orig, state[0], accs, ds, a0, a1)
    if drop:
        h = {k: v for k, v in h.items()
             if not (f0 and k.startswith("p_") or l0 and k.startswith("n_"))}
    s = [x[a0:a1].clone() for x in state]
    rho1 = torch.tensor(0.37, device="cuda")
    rho2 = torch.tensor(0.52, device="cuda")
    out = step(orig[a0:a1].contiguous(), s[0], s[1:1 + ndim],
               s[1 + ndim:] if fista else None, rho1, rho2, li, lm,
               fista=fista, halos0=h, first0=f0, last0=l0,
               ref=None if ref is None else ref[a0:a1].contiguous(), **kw)
    return s, torch.stack(out[3:]).double().cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("grid,strip", [(None, None), (1, None), (7, 3),
                                        (None, 1), (None, 2)])
@pytest.mark.parametrize("with_ref", [False, True])
@pytest.mark.parametrize("where", ["first", "interior", "last"])
@pytest.mark.parametrize("fista", [True, False])
@pytest.mark.parametrize("shape", HALO0_SHAPES, ids=str)
def test_pair_halo0_kernel_bitwise_equals_plain(shape, fista, where,
                                                with_ref, grid, strip):
    """The HALO0 pair on the first, an interior and the last 4-row axis-0
    slab of a cube, at forced grids and strips: state bitwise
    the plain pair with the same bands, sums within rtol 1e-5. The last
    slab's own row 0 holds nonzero axis-0 accumulators (the wrap case)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    orig, state, li, lm = _halo0_state(shape, fista, seed=sum(shape))
    n = 4  # the pair kernel's least rows
    a0, a1 = {"first": (0, n), "interior": (n, 2 * n),
              "last": (shape[0] - n, shape[0])}[where]
    if a0 > 0:
        assert state[1][a0].abs().max().item() > 0
    ref = orig + 0.1 if with_ref else None
    before = ttemporal.fused_pair_iteration.halo0_launches
    ks, ksum = _halo0_slab(ttemporal.fused_pair_iteration, orig, state, li,
                           lm, fista, a0, a1, ref=ref, grid=grid, strip=strip)
    assert ttemporal.fused_pair_iteration.halo0_launches == before + 1
    ps, psum = _halo0_slab(ttemporal.fused_pair_iteration_reference, orig,
                           state, li, lm, fista, a0, a1, ref=ref)
    for a, b in zip(ks, ps):
        assert torch.equal(a, b), (a - b).abs().max().item()
    torch.testing.assert_close(ksum, psum, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("with_ref", [False, True])
@pytest.mark.parametrize("where", ["first", "last"])
@pytest.mark.parametrize("fista", [True, False])
@pytest.mark.parametrize("shape", HALO0_SHAPES, ids=str)
def test_pair_halo0_missing_neighbour_bands_left_out(shape, fista, where,
                                                     with_ref):
    """On the first and the last slab the missing neighbour's bands may be
    left out (null pointers the kernel never reads): state bitwise the
    launch with zero bands and the plain pair without them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    orig, state, li, lm = _halo0_state(shape, fista, seed=sum(shape) + 1)
    a0, a1 = (0, 4) if where == "first" else (shape[0] - 4, shape[0])
    ref = orig + 0.1 if with_ref else None
    runs = [_halo0_slab(step, orig, state, li, lm, fista, a0, a1, ref=ref,
                        drop=drop)
            for step, drop in ((ttemporal.fused_pair_iteration, True),
                               (ttemporal.fused_pair_iteration, False),
                               (ttemporal.fused_pair_iteration_reference,
                                True))]
    (ks, ksum), (zs, zsum), (ps, psum) = runs
    for a, b, c in zip(ks, zs, ps):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(ksum, zsum)
    torch.testing.assert_close(ksum, psum, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("with_ref", [False, True])
@pytest.mark.parametrize("fista", [True, False])
@pytest.mark.parametrize("shape,n_slabs", [
    (shape, n) for shape in HALO0_SHAPES for n in (1, 2, 3)
    if shape[0] // n >= 4], ids=str)
def test_pair_halo0_slabs_reassemble_to_one_launch(shape, n_slabs, fista,
                                                   with_ref):
    """A cube cut into axis-0 slabs of at least 4 rows, each paired by the
    HALO0 kernel with bands from the pre-update state and put back: bitwise
    one pair launch of the whole cube; the slabs' sums add up to its sums
    within rtol 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    n0 = shape[0]
    orig, state, li, lm = _halo0_state(shape, fista, seed=7)
    ndim = len(shape)
    ref = orig + 0.1 if with_ref else None
    whole = [x.clone() for x in state]
    out = ttemporal.fused_pair_iteration(
        orig, whole[0], whole[1:1 + ndim], whole[1 + ndim:] if fista else None,
        torch.tensor(0.37, device="cuda"), torch.tensor(0.52, device="cuda"),
        li, lm, fista=fista, ref=ref)
    want_sums = torch.stack(out[3:]).double().cpu()
    bounds = [n0 * i // n_slabs for i in range(n_slabs + 1)]
    got_sums = 0
    for a0, a1 in zip(bounds[:-1], bounds[1:]):
        s, sums = _halo0_slab(ttemporal.fused_pair_iteration, orig, state, li,
                              lm, fista, a0, a1, ref=ref)
        got_sums = got_sums + sums
        for a, b in zip(s, whole):
            assert torch.equal(a, b[a0:a1]), (a - b[a0:a1]).abs().max().item()
    torch.testing.assert_close(got_sums, want_sums, rtol=1e-5, atol=0)


# -- the pair kernel's axis-1 bands (HALO1) ----------------------------------

# 3D and 4D, ragged trailing axes; axis-1 extents that cut into column
# shards of 2 (the least), 3 and wider
HALO1_SHAPES = [(6, 12, 19, 23), (9, 9, 70), (5, 8, 10, 33), (7, 15, 9)]


def _halo1_cols(shape, where, width):
    """The column range of the first, an interior or the last shard of
    ``width`` columns."""
    n1 = shape[1]
    return {"first": (0, width), "interior": (width, 2 * width),
            "last": (n1 - width, n1)}[where]


def _halo1_shard(step, orig, state, li, lm, fista, j0, j1, ref=None,
                 drop=False, **kw):
    """One pair of ``step`` on columns [j0, j1) with the bands cut from the
    whole state (with ``drop``, a missing neighbour's bands left out);
    returns the shard's state and its sums."""
    ndim = orig.dim()
    accs, ds = state[1:1 + ndim], state[1 + ndim:] if fista else None
    h, f1, l1 = ttemporal.halo1_bands(orig, state[0], accs, ds, j0, j1)
    if drop:
        h = {k: v for k, v in h.items()
             if not (f1 and k.startswith("p_") or l1 and k.startswith("n_"))}
    s = [x[:, j0:j1].clone(memory_format=torch.contiguous_format)
         for x in state]
    rho1 = torch.tensor(0.37, device="cuda")
    rho2 = torch.tensor(0.52, device="cuda")
    out = step(orig[:, j0:j1].contiguous(), s[0], s[1:1 + ndim],
               s[1 + ndim:] if fista else None, rho1, rho2, li, lm,
               fista=fista, halos1=h, first1=f1, last1=l1,
               ref=None if ref is None else ref[:, j0:j1].contiguous(), **kw)
    return s, torch.stack(out[3:]).double().cpu()


def _halo1_two_k1(orig, state, li, lm, fista, j0, j1):
    """Two K=1 kernel launches with the axis-1 halos the shard's bands give
    (``kernels/temporal.py::_pair_seams``): the pair's reference in K=1
    HALO launches."""
    ndim = orig.dim()
    accs, ds = state[1:1 + ndim], state[1 + ndim:] if fista else None
    h, f1, l1 = ttemporal.halo1_bands(orig, state[0], accs, ds, j0, j1)
    s = [x[:, j0:j1].clone(memory_format=torch.contiguous_format)
         for x in state]
    o = orig[:, j0:j1].contiguous()
    rhos = [torch.tensor(r, device="cuda") for r in (0.37, 0.52)]
    seams = ttemporal._pair_seams(o, s[0], s[1:1 + ndim],
                                  s[1 + ndim:] if fista else None, rhos[0],
                                  li, lm, fista, 1, h, f1, l1)
    for rho, seam in zip(rhos, seams):
        tfused.fused_iteration(o, s[0], s[1:1 + ndim],
                               s[1 + ndim:] if fista else None, rho, li, lm,
                               fista=fista, bc=2, halos=seam(s[0]))
    return s


@pytest.mark.cuda
@pytest.mark.parametrize("grid,strip", [(None, None), (1, None), (7, 3),
                                        (None, 1), (None, 2)])
@pytest.mark.parametrize("with_ref", [False, True])
@pytest.mark.parametrize("where,width", [("first", 2), ("interior", 3),
                                         ("last", 2), ("last", 4)])
@pytest.mark.parametrize("fista", [True, False])
@pytest.mark.parametrize("shape", HALO1_SHAPES, ids=str)
def test_pair_halo1_kernel_bitwise_equals_plain(shape, fista, where, width,
                                                with_ref, grid, strip):
    """The HALO1 pair on the first, an interior and the last column shard
    (2, 3 and 4 columns) of a cube, at forced grids and strips: state
    bitwise the plain pair with the same bands and (without a reference
    cube) two K=1 HALO launches, sums within rtol 1e-5. The last shard's
    own column 0 holds nonzero axis-1 accumulators (the wrap case)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    orig, state, li, lm = _halo0_state(shape, fista, seed=sum(shape) + 2)
    j0, j1 = _halo1_cols(shape, where, width)
    if j0 > 0:
        assert state[2][:, j0].abs().max().item() > 0
    ref = orig + 0.1 if with_ref else None
    before = ttemporal.fused_pair_iteration.halo1_launches
    ks, ksum = _halo1_shard(ttemporal.fused_pair_iteration, orig, state, li,
                            lm, fista, j0, j1, ref=ref, grid=grid,
                            strip=strip)
    assert ttemporal.fused_pair_iteration.halo1_launches == before + 1
    ps, psum = _halo1_shard(ttemporal.fused_pair_iteration_reference, orig,
                            state, li, lm, fista, j0, j1, ref=ref)
    for a, b in zip(ks, ps):
        assert torch.equal(a, b), (a - b).abs().max().item()
    torch.testing.assert_close(ksum, psum, rtol=1e-5, atol=0)
    if ref is None and grid is None and strip is None:
        for a, b in zip(ks, _halo1_two_k1(orig, state, li, lm, fista, j0,
                                          j1)):
            assert torch.equal(a, b), (a - b).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["first", "last"])
@pytest.mark.parametrize("fista", [True, False])
@pytest.mark.parametrize("shape", HALO1_SHAPES, ids=str)
def test_pair_halo1_missing_neighbour_bands_left_out(shape, fista, where):
    """On the first and the last column shard the missing neighbour's bands
    may be left out: state bitwise the launch with zero bands and the
    plain pair without them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    orig, state, li, lm = _halo0_state(shape, fista, seed=sum(shape) + 3)
    j0, j1 = _halo1_cols(shape, where, 3)
    runs = [_halo1_shard(step, orig, state, li, lm, fista, j0, j1, drop=drop)
            for step, drop in ((ttemporal.fused_pair_iteration, True),
                               (ttemporal.fused_pair_iteration, False),
                               (ttemporal.fused_pair_iteration_reference,
                                True))]
    (ks, ksum), (zs, zsum), (ps, psum) = runs
    for a, b, c in zip(ks, zs, ps):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(ksum, zsum)
    torch.testing.assert_close(ksum, psum, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("with_ref", [False, True])
@pytest.mark.parametrize("fista", [True, False])
@pytest.mark.parametrize("shape,n_shards", [
    (shape, n) for shape in HALO1_SHAPES for n in (2, 3, 4)
    if shape[1] // n >= 2], ids=str)
def test_pair_halo1_shards_reassemble_to_one_launch(shape, n_shards, fista,
                                                    with_ref):
    """A cube cut into column shards of at least 2 columns, each paired by
    the HALO1 kernel with bands from the pre-update state and put back:
    bitwise one pair launch of the whole cube; the shards' sums add up to
    its sums within rtol 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    n1 = shape[1]
    orig, state, li, lm = _halo0_state(shape, fista, seed=8)
    ndim = len(shape)
    ref = orig + 0.1 if with_ref else None
    whole = [x.clone() for x in state]
    out = ttemporal.fused_pair_iteration(
        orig, whole[0], whole[1:1 + ndim], whole[1 + ndim:] if fista else None,
        torch.tensor(0.37, device="cuda"), torch.tensor(0.52, device="cuda"),
        li, lm, fista=fista, ref=ref)
    want_sums = torch.stack(out[3:]).double().cpu()
    bounds = [n1 * i // n_shards for i in range(n_shards + 1)]
    got_sums = 0
    for j0, j1 in zip(bounds[:-1], bounds[1:]):
        s, sums = _halo1_shard(ttemporal.fused_pair_iteration, orig, state,
                               li, lm, fista, j0, j1, ref=ref)
        got_sums = got_sums + sums
        for a, b in zip(s, whole):
            assert torch.equal(a, b[:, j0:j1]), \
                (a - b[:, j0:j1]).abs().max().item()
    torch.testing.assert_close(got_sums, want_sums, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shard,kw", [
    ((2, 1, 1, 1), dict(iterations=9)),
    ((4, 1, 1, 1), dict(iterations=(5, 4))),
    ((2, 1, 1, 1), dict(iterations=9, with_ref=True)),
    ((2, 1, 1, 1), dict(iterations=40, stop=True)),
    ((1, 2, 1, 1), dict(iterations=6)),
    ((1, 2, 1, 1), dict(iterations=9, with_ref=True)),
    ((1, 2, 1, 1), dict(iterations=40, stop=True)),
    ((2, 2, 1, 1), dict(iterations=6)),
    ((2, 2, 1, 1), dict(iterations=9, with_ref=True)),
    ((2, 2, 1, 1), dict(iterations=9, lossy=True)),
    ((2, 1, 1, 1), dict(iterations=9, lossy=True)),
    ((2, 1, 1, 1), dict(iterations=40, stop=True, lossy=True)),
    ((1, 2, 1, 1), dict(iterations=9, lossy=True)),
])
def test_mesh_run_on_the_card_bitwise_single_device(monkeypatch, shard, kw):
    """``denoise_sharded`` with ranks as threads sharing the card (gloo
    groups, slabs staged through page-locked memory) against ``denoise4D``
    on the card: recon bitwise, traces within rtol 1e-5, the HALO0 pairs
    launched on axis-0 meshes and on the 2D grid (``pairfix.PAIR_2D_GRIDS``
    set: its axis-1 seams repaired, ``parallel/pairfix.py``; K=1 launches
    only for an odd remainder), the HALO1 pairs on axis-1 meshes (LOSSY
    ones under lossy duals)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import datetime
    import threading

    import numpy as np
    import torch.distributed as dist

    from cytvdn_tpu_torch import denoise4D
    from cytvdn_tpu_torch.parallel import denoise_sharded, pairfix
    from cytvdn_tpu_torch.solver import engine

    monkeypatch.setattr(engine, "PAIR_MIN_ROW_BYTES", 0)
    monkeypatch.setattr(pairfix, "PAIR_2D_GRIDS", True)
    cube = (np.random.default_rng(5).standard_normal((16, 12, 10, 33))
            * 0.5 + 2.0).astype(np.float32)
    mu = np.full(4, 1.0, np.float32)
    args = dict(iterations=kw["iterations"], quiet=True)
    if kw.get("with_ref"):
        args["reference_data"] = (cube * 0.9).astype(np.float32)
    if kw.get("stop"):
        # between the deltas of iterations 18 and 19 (1.25e-3, 1.11e-3),
        # far from both: the run stops after 19
        args["stopping_relative_change"] = 1.18e-3
    if kw.get("lossy"):
        args.update(lossy_duals=True, FISTA=True)
    want = denoise4D(cube, mu, device="cuda", **args)
    n = int(np.prod(shard))
    store, res, errs = dist.HashStore(), [None] * n, [None] * n
    before = (ttemporal.fused_pair_iteration.halo0_launches,
              tfused.fused_iteration.halo_launches,
              ttemporal.fused_pair_iteration.lossy_launches,
              ttemporal.fused_pair_iteration.halo1_launches)

    def rank(r):
        try:
            pg = dist.ProcessGroupGloo(dist.PrefixStore("card", store), r, n,
                                       datetime.timedelta(seconds=60))
            res[r] = denoise_sharded(cube, mu, shard=shard, group=pg,
                                     device="cuda", **args)
        except BaseException as e:  # re-raised below
            errs[r] = e

    threads = [threading.Thread(target=rank, args=(r,), daemon=True)
               for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    for e in errs:
        if e is not None:
            raise e
    np.testing.assert_array_equal(res[0]["recon"], want[0])
    assert all(r["iterations_run"] == np.count_nonzero(want[2]) for r in res)
    np.testing.assert_allclose(res[0]["b_norm"], want[1], rtol=1e-5)
    np.testing.assert_allclose(res[0]["delta"], want[2], rtol=1e-5)
    if kw.get("with_ref"):
        np.testing.assert_allclose(res[0]["mse"], want[3], rtol=1e-5)
    halo0 = ttemporal.fused_pair_iteration.halo0_launches - before[0]
    k1 = tfused.fused_iteration.halo_launches - before[1]
    halo1 = ttemporal.fused_pair_iteration.halo1_launches - before[3]
    assert (halo0 > 0) == (shard[0] > 1), (halo0, halo1, k1)
    assert (halo1 > 0) == (shard[0] == 1), (halo0, halo1, k1)
    assert k1 > 0 or (halo0 + halo1 > 0 and not kw.get("stop"))
    if shard[:2] == (2, 2):
        # pairs, the odd remainder on the K=1 loop
        n = kw["iterations"]
        assert halo0 == 4 * (n // 2) and k1 == 4 * (n % 2), (halo0, k1)
    lossy = ttemporal.fused_pair_iteration.lossy_launches - before[2]
    assert lossy == (halo0 + halo1 if kw.get("lossy") else 0)


# -- the K=1 kernel's mesh-only halo modes -----------------------------------

def _mode_state(shape, fista, dtype, seed=0):
    """A random state on the card, the Jia-Zhao invariant held (each
    accumulator's leading slab along its axis zero), and scalars whose
    clip radii bind."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ndim = len(shape)

    def rnd(scale):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=dtype) * scale

    orig = rnd(0.5) + 2.0
    state = [orig + rnd(0.05)] + [rnd(0.2) for _ in range(ndim)]
    if fista:
        state += [rnd(0.2) for _ in range(ndim)]
    for j, x in enumerate(state[1:]):
        x.select(j % ndim, 0).zero_()
    li = torch.linspace(0.2, 0.35, ndim, device="cuda", dtype=dtype)
    lm = torch.linspace(1 / 32, 1 / 48, ndim, device="cuda", dtype=dtype)
    return orig, state, li, lm, torch.tensor(0.37, device="cuda",
                                             dtype=dtype)


def _mode_block(step, orig, state, li, lm, rho, fista, grid, coords, mode,
                iters=1):
    """``iters`` launches of ``step`` on one block of ``state`` with the
    halos of ``mode`` (``tests/torch_halo_blocks.py``); returns the block's
    state and sums."""
    from torch_halo_blocks import block_halos, block_state

    ndim = orig.dim()
    recon, accs = state[0], state[1:1 + ndim]
    ds = state[1 + ndim:] if fista else None
    h, edge = block_halos(recon, accs, ds, grid, coords, **mode)
    o, *s = block_state([orig] + state, grid, coords)
    sums = []
    for _ in range(iters):
        out = step(o, s[0], s[1:1 + ndim], s[1 + ndim:] if fista else None,
                   rho, li, lm, fista=fista, halos=h, edge_next=edge, **mode)
        sums.append(torch.stack(out[3:]).double().cpu())
    torch.cuda.synchronize()
    return s, torch.stack(sums)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("fista", [True, False])
@pytest.mark.parametrize("name", ["ring", "mirror", "iso-seam0", "iso-seam1",
                                  "iso-corner", "inblock2", "inblock3",
                                  "iso-q-corner", "energy"])
def test_halo_mode_kernel_bitwise_equals_plain(name, fista, dtype):
    """The HALO instantiation in each mesh-only mode (rings, mirror edges
    with their flags, iso seams and corners, in-block axes) against the
    plain version with the same halos, two launches on the first, an
    interior and the last block: state bitwise, sums within rtol 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from torch_halo_blocks import HALO_MODES, mode_coords

    mode, shape, grid, ax = HALO_MODES[name]
    orig, state, li, lm, rho = _mode_state(shape, fista, dtype)
    before = tfused.fused_iteration.mode_launches
    for i in range(3):
        coords = mode_coords(grid, ax, i)
        ks, ksum = _mode_block(tfused.fused_iteration, orig, state, li, lm,
                               rho, fista, grid, coords, mode, iters=2)
        ps, psum = _mode_block(tfused.fused_iteration_reference, orig, state,
                               li, lm, rho, fista, grid, coords, mode,
                               iters=2)
        for a, b in zip(ks, ps):
            assert torch.equal(a, b), (i, (a - b).abs().max().item())
        torch.testing.assert_close(ksum, psum, rtol=1e-5, atol=0)
    assert tfused.fused_iteration.mode_launches - before == 6


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [1, 7])
@pytest.mark.parametrize("fista", [True, False])
@pytest.mark.parametrize("name", ["iso-seam0", "iso-seam1", "iso-corner",
                                  "iso-q-corner"])
def test_iso_halo_mode_kernel_at_forced_grids(monkeypatch, name, fista, grid):
    """The ISO and HALO instantiation (iso seams and corners) at forced
    grids of 1 and 7 blocks against the plain version with the same halos,
    two launches on the first, an interior and the last block: state
    bitwise, sums within rtol 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from torch_halo_blocks import HALO_MODES, mode_coords

    mode, shape, grid_blocks, ax = HALO_MODES[name]
    orig, state, li, lm, rho = _mode_state(shape, fista, torch.float32)
    monkeypatch.setattr(tfused, "MAX_BLOCKS", grid)
    for i in range(3):
        coords = mode_coords(grid_blocks, ax, i)
        ks, ksum = _mode_block(tfused.fused_iteration, orig, state, li, lm,
                               rho, fista, grid_blocks, coords, mode, iters=2)
        ps, psum = _mode_block(tfused.fused_iteration_reference, orig, state,
                               li, lm, rho, fista, grid_blocks, coords, mode,
                               iters=2)
        for a, b in zip(ks, ps):
            assert torch.equal(a, b), (i, (a - b).abs().max().item())
        torch.testing.assert_close(ksum, psum, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("fista", [True, False])
@pytest.mark.parametrize("name", ["ring", "mirror", "iso-corner", "inblock2",
                                  "inblock3", "iso-q-corner", "energy"])
def test_halo_mode_blocks_reassemble_to_one_launch(name, fista):
    """Every block of the mode's grid launched with its halos and put
    back: bitwise one launch of the whole cube."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import itertools

    from torch_halo_blocks import HALO_MODES, block_bounds

    mode, shape, grid, _ = HALO_MODES[name]
    ndim = len(shape)
    orig, state, li, lm, rho = _mode_state(shape, fista, torch.float32, 1)
    whole = [x.clone() for x in state]
    tfused.fused_iteration(orig, whole[0], whole[1:1 + ndim],
                           whole[1 + ndim:] if fista else None, rho, li, lm,
                           fista=fista, **mode)
    cut = [x.clone() for x in state]
    for coords in itertools.product(*(range(w) for w in grid)):
        s, _ = _mode_block(tfused.fused_iteration, orig, state, li, lm, rho,
                           fista, grid, coords, mode)
        sl = tuple(slice(*b) for b in block_bounds(shape, grid, coords))
        for dst, src in zip(cut, s):
            dst[sl] = src
    torch.cuda.synchronize()
    for a, b in zip(cut, whole):
        assert torch.equal(a, b), (a - b).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,shard,kw", [
    ((16, 12, 10, 33), (2, 1, 1, 1), dict(BC_mode=0)),
    ((16, 12, 10, 33), (2, 2, 1, 1), dict(BC_mode=1)),
    ((16, 12, 10, 33), (2, 2, 1, 1),
     dict(isotropic_R=True, isotropic_Q=True)),
    ((8, 6, 16, 32), (1, 1, 2, 2), dict(isotropic_Q=True)),
    ((8, 6, 16, 32), (1, 1, 2, 1), dict()),
    ((12, 9, 70), (3, 1, 2), dict(BC_mode=0)),
    ((12, 9, 70), (2, 1, 1), dict(BC_mode=1, stop=True)),
    ((16, 12, 10, 33), (2, 1, 1, 1), dict(isotropic_R=True, with_ref=True)),
    ((4, 12, 10, 33), (4, 1, 1, 1), dict(isotropic_R=True)),
], ids=str)
def test_mode_mesh_run_on_the_card_bitwise_single_device(shape, shard, kw):
    """``denoise_sharded`` in the mesh-only modes with ranks as threads
    sharing the card against the single-device run on the card: recon
    bitwise, traces within rtol 1e-5, K=1 launches in those modes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import datetime
    import threading

    import numpy as np
    import torch.distributed as dist

    from cytvdn_tpu_torch import denoise3D, denoise4D
    from cytvdn_tpu_torch.parallel import denoise_sharded

    kw = dict(kw)
    stop, with_ref = kw.pop("stop", False), kw.pop("with_ref", False)
    cube = (np.random.default_rng(6).standard_normal(shape) * 0.5
            + 2.0).astype(np.float32)
    mu = np.full(len(shape), 1.0, np.float32)
    args = dict(iterations=30 if stop else 7, FISTA=True, quiet=True, **kw)
    if with_ref:
        args["reference_data"] = (cube * 0.9).astype(np.float32)
    single = denoise4D if len(shape) == 4 else denoise3D
    if stop:
        fixed = single(cube, mu, device="cuda", **args)[2]
        args["stopping_relative_change"] = float(np.sqrt(fixed[9] * fixed[10]))
    want = single(cube, mu, device="cuda", **args)
    n = int(np.prod(shard))
    store, res, errs = dist.HashStore(), [None] * n, [None] * n
    before = tfused.fused_iteration.mode_launches

    def rank(r):
        try:
            pg = dist.ProcessGroupGloo(dist.PrefixStore("modes", store), r,
                                       n, datetime.timedelta(seconds=60))
            res[r] = denoise_sharded(cube, mu, shard=shard, group=pg,
                                     device="cuda", **args)
        except BaseException as e:  # re-raised below
            errs[r] = e

    threads = [threading.Thread(target=rank, args=(r,), daemon=True)
               for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    for e in errs:
        if e is not None:
            raise e
    np.testing.assert_array_equal(res[0]["recon"], want[0])
    assert all(r["iterations_run"] == np.count_nonzero(want[2]) for r in res)
    if stop:
        assert res[0]["iterations_run"] == 11
    np.testing.assert_allclose(res[0]["b_norm"], want[1], rtol=1e-5)
    np.testing.assert_allclose(res[0]["delta"], want[2], rtol=1e-5)
    if with_ref:
        np.testing.assert_allclose(res[0]["mse"], want[3], rtol=1e-5)
    # the ranks are threads of this process, counting into one attribute
    assert tfused.fused_iteration.mode_launches > before


# -- lossy duals: the K=1 kernel's LOSSY instantiation -------------------------

# ragged edges on every axis, last extents 1, 31 and 33, 3D and 4D
LOSSY_SHAPES = [(37, 45, 19, 23), (13, 17, 70), (7, 9, 5, 1), (5, 7, 9, 31),
                (9, 5, 7, 33)]


def _lossy_state(shape, seed=0):
    """A random float32 state on the card with bfloat16 shadow duals."""
    orig, state = _halo_state(shape, True, torch.float32, seed=seed)
    ndim = len(shape)
    return orig, state[:1 + ndim] + [d.to(torch.bfloat16)
                                     for d in state[1 + ndim:]]


def _lossy_runs(orig, state, halos=None, iters=3):
    """``iters`` lossy launches of the kernel and of its plain version on
    copies of ``state``: each's final state and stacked sums."""
    ndim = orig.dim()
    li = torch.linspace(0.2, 0.35, ndim, device="cuda")
    lm = torch.linspace(1 / 32, 1 / 48, ndim, device="cuda")
    rho = torch.tensor(0.37, device="cuda")
    runs = []
    for step in (tfused.fused_iteration, tfused.fused_iteration_reference):
        s = [x.clone() for x in state]
        sums = []
        for _ in range(iters):
            out = step(orig, s[0], s[1:1 + ndim], s[1 + ndim:], rho, li, lm,
                       fista=True, halos=halos)
            sums.append(torch.stack(out[3:]).double().cpu())
        torch.cuda.synchronize()
        runs.append((s, torch.stack(sums)))
    return runs


def _assert_same(runs, what):
    (ks, ksum), (ps, psum) = runs
    for a, b in zip(ks, ps):
        assert a.dtype == b.dtype and torch.equal(a, b), (
            what, (a.float() - b.float()).abs().max().item())
    torch.testing.assert_close(ksum, psum, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LOSSY_SHAPES, ids=str)
def test_lossy_kernel_bitwise_equals_plain_at_forced_grids(monkeypatch,
                                                           shape):
    """Three launches of the LOSSY instantiation (bfloat16 d: widened on
    load, rounded to nearest even on store) at the wrapper's grid and at
    forced grids of 1, 7 and all blocks against the plain version, whose
    ``copy_`` into the bfloat16 d rounds: state bitwise, d included, sums
    within rtol 1e-5; the launches counted as lossy."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    orig, state = _lossy_state(shape)
    before = tfused.fused_iteration.lossy_launches
    for grid in (None, 1, 7, tfused._work_items(shape)):
        if grid is not None:
            monkeypatch.setattr(tfused, "MAX_BLOCKS", grid)
        _assert_same(_lossy_runs(orig, state), grid)
    assert tfused.fused_iteration.lossy_launches - before == 12


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["first", "interior", "last"])
@pytest.mark.parametrize("shape", HALO_SHAPES, ids=str)
def test_lossy_halo_kernel_bitwise_equals_plain(monkeypatch, shape, where):
    """The LOSSY HALO instantiation (bfloat16 d, a float32 ``next0_d``
    seam: the neighbour's d widened) against the plain version with the
    same halos on the first, an interior and the last of three slabs,
    three launches, also at a grid of 7 blocks: state bitwise, sums within
    rtol 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    ndim = len(shape)
    orig, state = _lossy_state(shape, seed=2)
    n = shape[0] // 3
    a0, a1 = {"first": (0, n), "interior": (n, 2 * n),
              "last": (2 * n, shape[0])}[where]
    h = _seams(state, ndim, a0, a1, True)
    h["next0_d"] = h["next0_d"].float()
    slab = [x[a0:a1].clone() for x in state]
    _assert_same(_lossy_runs(orig[a0:a1].contiguous(), slab, h), where)
    monkeypatch.setattr(tfused, "MAX_BLOCKS", 7)
    _assert_same(_lossy_runs(orig[a0:a1].contiguous(), slab, h), 7)


@pytest.mark.cuda
@pytest.mark.parametrize("n_slabs", [3, 4])
@pytest.mark.parametrize("shape", HALO_SHAPES, ids=str)
def test_lossy_halo_slabs_reassemble_to_one_launch(shape, n_slabs):
    """A lossy cube cut into slabs, each launched with halos from the
    pre-update state (the +1 neighbour's bfloat16 d row widened),
    reassembled: bitwise one lossy launch of the whole cube."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from cytvdn_tpu_torch.solver.outofcore import _slab_bounds

    ndim = len(shape)
    orig, state = _lossy_state(shape, seed=1)
    for k in range(ndim):
        state[1 + k].narrow(k, 0, 1).zero_()
        state[1 + ndim + k].narrow(k, 0, 1).zero_()
    whole = _lossy_runs(orig, state, iters=1)[0][0]
    cut = [x.clone() for x in state]
    for a0, a1 in _slab_bounds(shape[0], n_slabs):
        h = _seams(state, ndim, a0, a1, True)
        h["next0_d"] = h["next0_d"].float()
        s = _lossy_runs(orig[a0:a1].contiguous(),
                        [x[a0:a1].clone() for x in state], h, iters=1)[0][0]
        for dst, src in zip(cut, s):
            dst[a0:a1] = src
    for a, b in zip(cut, whole):
        assert torch.equal(a, b), (a.float() - b.float()).abs().max().item()


@pytest.mark.cuda
def test_lossy_runs_on_the_card():
    """``denoise4D(lossy_duals=True)`` ×9 on the card: one LOSSY K=8
    launch and one LOSSY K=1 launch, the recon bitwise the plain backend's
    there and ``denoise_outofcore`` in stream mode's (bfloat16 pinned host
    duals), and not the exact run's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import numpy as np

    from cytvdn_tpu_torch import denoise4D
    from cytvdn_tpu_torch.solver.outofcore import denoise_outofcore

    cube = (np.random.default_rng(5).standard_normal((22, 9, 10, 33)) * 0.5
            + 2.0).astype(np.float32)
    mu = np.full(4, 1.0, np.float32)
    kw = dict(iterations=9, FISTA=True, lossy_duals=True)
    before = (tfused.fused_iteration.lossy_launches,
              ttemporal.fused_pair_iteration.launches,
              tkstep.fused_kstep_iteration.lossy_launches,
              tres.resident_solve.launches)
    got = denoise4D(cube, mu, quiet=True, device="cuda", **kw)
    after = (tfused.fused_iteration.lossy_launches,
             ttemporal.fused_pair_iteration.launches,
             tkstep.fused_kstep_iteration.lossy_launches,
             tres.resident_solve.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 0, 1, 0]
    plain = denoise4D(cube, mu, quiet=True, device="cuda", backend="torch",
                      **kw)
    np.testing.assert_array_equal(got[0], plain[0])
    ooc = denoise_outofcore(cube, mu, n_slabs=3, device="cuda", **kw)
    np.testing.assert_array_equal(ooc[0], got[0])
    exact = denoise4D(cube, mu, iterations=9, quiet=True, device="cuda")
    assert np.abs(exact[0] - got[0]).max() > 1e-6


# -- lossy duals: the pair kernel's LOSSY instantiations -----------------------

LOSSY_PAIR_SHAPES = [(4, 9, 10, 33), (7, 9, 10, 33), (5, 13, 70), (7, 13, 70),
                     (37, 45, 19, 23)]
# (grid, strip): the wrapper's, 1 and 7 blocks, a forced strip
LOSSY_PAIR_GRIDS = [(None, None), (1, None), (7, None), (None, 3)]


def _lossy_pair_state(shape, seed=0):
    """A random Jia-Zhao state on the card with bfloat16 shadow duals."""
    orig, state, li, lm = _halo0_state(shape, True, seed=seed)
    nd = len(shape)
    return orig, state[:1 + nd] + [d.to(torch.bfloat16)
                                   for d in state[1 + nd:]], li, lm


def _assert_states(got, want, what):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), (
            what, (a.float() - b.float()).abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("with_ref", [False, True])
@pytest.mark.parametrize("shape", LOSSY_PAIR_SHAPES, ids=str)
def test_lossy_pair_kernel_bitwise_plain_and_two_lossy_k1(shape, with_ref):
    """Two pairs of the LOSSY instantiation (bfloat16 d: iteration 1's d
    stored rounded and read back by iteration 2) at the wrapper's grid, at
    forced grids of 1 and 7 blocks and at a forced strip, against the plain
    pair and (without a reference cube) two LOSSY K=1 launches per pair:
    state bitwise, d included, sums within rtol 1e-5; every launch counted
    as lossy."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    orig, state, li, lm = _lossy_pair_state(shape, seed=sum(shape) + 3)
    rhos = [torch.tensor(r, device="cuda") for r in RHOS]
    kw = {"ref": orig + 0.1} if with_ref else {}
    want = _pairs(ttemporal.fused_pair_iteration_reference, orig, state, li,
                  lm, rhos, True, **kw)
    k1 = None if with_ref else _pairs(_two_k1_launches, orig, state, li, lm,
                                      rhos, True)
    before = ttemporal.fused_pair_iteration.lossy_launches
    for grid, strip in LOSSY_PAIR_GRIDS:
        got = _pairs(ttemporal.fused_pair_iteration, orig, state, li, lm,
                     rhos, True, grid=grid, strip=strip, **kw)
        for other in [want] + ([k1] if k1 is not None else []):
            _assert_states(got[0], other[0], (grid, strip))
            torch.testing.assert_close(got[1], other[1], rtol=1e-5, atol=0)
    assert ttemporal.fused_pair_iteration.lossy_launches - before == \
        2 * len(LOSSY_PAIR_GRIDS)


@pytest.mark.cuda
@pytest.mark.parametrize("grid,strip", LOSSY_PAIR_GRIDS)
@pytest.mark.parametrize("with_ref", [False, True])
@pytest.mark.parametrize("where", ["first", "interior", "last"])
@pytest.mark.parametrize("shape", HALO0_SHAPES, ids=str)
def test_lossy_pair_halo0_bitwise_plain_and_stash(shape, where, with_ref,
                                                  grid, strip):
    """The LOSSY HALO0 pair on the first, an interior and the last 4-row
    slab, at forced grids and strips: state bitwise the plain pair with the
    same bands, d included, sums within rtol 1e-5. Its stash (below the
    last slab) holds the +1 shard's row-0 b_0 and d_0 after iteration 1:
    bitwise one plain lossy K=1 step of the whole cube there, d_0 on the
    bfloat16 grid (round_bf16 in CUDA)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    orig, state, li, lm = _lossy_pair_state(shape, seed=sum(shape) + 5)
    n = 4
    a0, a1 = {"first": (0, n), "interior": (n, 2 * n),
              "last": (shape[0] - n, shape[0])}[where]
    ref = orig + 0.1 if with_ref else None
    stash = torch.full((2,) + tuple(shape[1:]), float("nan"), device="cuda")
    before = ttemporal.fused_pair_iteration.lossy_launches
    ks, ksum = _halo0_slab(ttemporal.fused_pair_iteration, orig, state, li,
                           lm, True, a0, a1, ref=ref, grid=grid, strip=strip,
                           stash=stash)
    assert ttemporal.fused_pair_iteration.lossy_launches == before + 1
    ps, psum = _halo0_slab(ttemporal.fused_pair_iteration_reference, orig,
                           state, li, lm, True, a0, a1, ref=ref)
    _assert_states(ks, ps, where)
    torch.testing.assert_close(ksum, psum, rtol=1e-5, atol=0)
    if a1 < shape[0]:  # a slab with a +1 neighbour fills its stash
        nd = len(shape)
        s = [x.clone() for x in state]
        tfused.fused_iteration_reference(
            orig, s[0], s[1:1 + nd], s[1 + nd:],
            torch.tensor(0.37, device="cuda"), li, lm, fista=True)
        assert torch.equal(stash[0], s[1][a1])
        assert torch.equal(stash[1], s[1 + nd][a1].float())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n_slabs", [
    (shape, n) for shape in HALO0_SHAPES for n in (2, 3)
    if shape[0] // n >= 4], ids=str)
def test_lossy_pair_halo0_slabs_reassemble_to_one_launch(shape, n_slabs):
    """A lossy cube cut into axis-0 slabs of at least 4 rows, each paired
    by the LOSSY HALO0 kernel with bands from the pre-update state and put
    back: bitwise one LOSSY pair launch of the whole cube, d included."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    n0, nd = shape[0], len(shape)
    orig, state, li, lm = _lossy_pair_state(shape, seed=11)
    whole = [x.clone() for x in state]
    ttemporal.fused_pair_iteration(
        orig, whole[0], whole[1:1 + nd], whole[1 + nd:],
        torch.tensor(0.37, device="cuda"), torch.tensor(0.52, device="cuda"),
        li, lm, fista=True)
    bounds = [n0 * i // n_slabs for i in range(n_slabs + 1)]
    for a0, a1 in zip(bounds[:-1], bounds[1:]):
        s, _ = _halo0_slab(ttemporal.fused_pair_iteration, orig, state, li,
                           lm, True, a0, a1)
        _assert_states(s, [x[a0:a1] for x in whole], (a0, a1))


@pytest.mark.cuda
@pytest.mark.parametrize("grid,strip", LOSSY_PAIR_GRIDS)
@pytest.mark.parametrize("with_ref", [False, True])
@pytest.mark.parametrize("where", ["first", "interior", "last"])
@pytest.mark.parametrize("shape", HALO1_SHAPES, ids=str)
def test_lossy_pair_halo1_bitwise_plain_and_stash(shape, where, with_ref,
                                                  grid, strip):
    """The LOSSY HALO1 pair on the first, an interior and the last
    3-column shard, at forced grids and strips: state bitwise the plain
    pair with the same bands, d included, sums within rtol 1e-5. Its
    stash (beside a shard with a +1 neighbour) holds that shard's column-0
    b_1 and d_1 after iteration 1: bitwise one plain lossy K=1 step of the
    whole cube there, d_1 on the bfloat16 grid (round_bf16 in CUDA)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    orig, state, li, lm = _lossy_pair_state(shape, seed=sum(shape) + 6)
    j0, j1 = _halo1_cols(shape, where, 3)
    ref = orig + 0.1 if with_ref else None
    stash = torch.full((2, shape[0], 1) + tuple(shape[2:]), float("nan"),
                       device="cuda")
    before = ttemporal.fused_pair_iteration.lossy_launches
    ks, ksum = _halo1_shard(ttemporal.fused_pair_iteration, orig, state, li,
                            lm, True, j0, j1, ref=ref, grid=grid,
                            strip=strip, stash=stash)
    assert ttemporal.fused_pair_iteration.lossy_launches == before + 1
    ps, psum = _halo1_shard(ttemporal.fused_pair_iteration_reference, orig,
                            state, li, lm, True, j0, j1, ref=ref)
    _assert_states(ks, ps, where)
    torch.testing.assert_close(ksum, psum, rtol=1e-5, atol=0)
    if j1 < shape[1]:
        nd = len(shape)
        s = [x.clone() for x in state]
        tfused.fused_iteration_reference(
            orig, s[0], s[1:1 + nd], s[1 + nd:],
            torch.tensor(0.37, device="cuda"), li, lm, fista=True)
        assert torch.equal(stash[0], s[2][:, j1:j1 + 1])
        assert torch.equal(stash[1], s[2 + nd][:, j1:j1 + 1].float())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n_shards", [
    (shape, n) for shape in HALO1_SHAPES for n in (2, 3)
    if shape[1] // n >= 2], ids=str)
def test_lossy_pair_halo1_shards_reassemble_to_one_launch(shape, n_shards):
    """A lossy cube cut into column shards of at least 2 columns, each
    paired by the LOSSY HALO1 kernel with bands from the pre-update state
    and put back: bitwise one LOSSY pair launch of the whole cube, d
    included."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    n1, nd = shape[1], len(shape)
    orig, state, li, lm = _lossy_pair_state(shape, seed=12)
    whole = [x.clone() for x in state]
    ttemporal.fused_pair_iteration(
        orig, whole[0], whole[1:1 + nd], whole[1 + nd:],
        torch.tensor(0.37, device="cuda"), torch.tensor(0.52, device="cuda"),
        li, lm, fista=True)
    bounds = [n1 * i // n_shards for i in range(n_shards + 1)]
    for j0, j1 in zip(bounds[:-1], bounds[1:]):
        s, _ = _halo1_shard(ttemporal.fused_pair_iteration, orig, state, li,
                            lm, True, j0, j1)
        _assert_states(s, [x[:, j0:j1] for x in whole], (j0, j1))


@pytest.mark.cuda
def test_round_bf16_device_function_bitwise_torch_cast():
    """``wavefront.cuh::round_bf16`` through the stash of a LOSSY HALO0
    pair (``chip_smoke.round_bf16_through_stash``) on the lossy duals'
    canary values (ties, denormals, the carry to infinity, 4096 random
    values over 26 decades): bitwise torch's float -> bfloat16 -> float
    cast."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from chip_smoke import round_bf16_through_stash

    got, want = round_bf16_through_stash()
    assert torch.equal(got, want), (got != want).nonzero()[:8].flatten()


@pytest.mark.cuda
def test_lossy_pair_runs_on_the_card(monkeypatch):
    """Lossy runs that pair on the card (``PAIR_MIN_ROW_BYTES`` patched to
    0, K-steps off): ``denoise4D(lossy_duals=True)`` ×9 makes 4 LOSSY
    pairs and one LOSSY K=1 launch, bitwise the K=1 lossy loop (pairs
    never paying) and the plain backend; an MSE run pairs with REF+LOSSY,
    bitwise the K=1 loop; out-of-core temporal mode (K=4, 3 slabs) bitwise
    in core."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import numpy as np

    from cytvdn_tpu_torch import denoise4D
    from cytvdn_tpu_torch.solver import engine
    from cytvdn_tpu_torch.solver.outofcore import denoise_outofcore

    def k1_loop(*a, **k):
        monkeypatch.setattr(engine, "PAIR_MIN_ROW_BYTES", 2**62)
        out = denoise4D(*a, **k)
        monkeypatch.setattr(engine, "PAIR_MIN_ROW_BYTES", 0)
        return out

    monkeypatch.setattr(engine, "PAIR_MIN_ROW_BYTES", 0)
    # the K-step kernel would take these runs (its lossy runs: below)
    monkeypatch.setattr(engine, "_resolve_kstep", lambda *a: 0)
    cube = (np.random.default_rng(6).standard_normal((22, 9, 10, 33)) * 0.5
            + 2.0).astype(np.float32)
    mu = np.full(4, 1.0, np.float32)
    kw = dict(iterations=9, FISTA=True, lossy_duals=True, quiet=True,
              device="cuda")
    before = (ttemporal.fused_pair_iteration.lossy_launches,
              tfused.fused_iteration.lossy_launches,
              tkstep.fused_kstep_iteration.launches,
              tres.resident_solve.launches)
    got = denoise4D(cube, mu, **kw)
    after = (ttemporal.fused_pair_iteration.lossy_launches,
             tfused.fused_iteration.lossy_launches,
             tkstep.fused_kstep_iteration.launches,
             tres.resident_solve.launches)
    assert [a - b for a, b in zip(after, before)] == [4, 1, 0, 0]
    k1 = k1_loop(cube, mu, **kw)
    plain = denoise4D(cube, mu, backend="torch", **kw)
    for other in (k1, plain):
        np.testing.assert_array_equal(got[0], other[0])
        np.testing.assert_allclose(got[2], other[2], rtol=1e-5)
    ref = (cube * 0.9).astype(np.float32)
    mse = denoise4D(cube, mu, reference_data=ref, **kw)
    mse_k1 = k1_loop(cube, mu, reference_data=ref, **kw)
    np.testing.assert_array_equal(mse[0], mse_k1[0])
    np.testing.assert_allclose(mse[3], mse_k1[3], rtol=1e-5)
    calls = ttemporal.fused_pair_iteration.lossy_launches
    ooc = denoise_outofcore(cube, mu, iterations=8, FISTA=True, n_slabs=3,
                            temporal_k=4, lossy_duals=True, device="cuda")
    assert ttemporal.fused_pair_iteration.lossy_launches - calls == 6
    want = denoise4D(cube, mu, **dict(kw, iterations=8))
    np.testing.assert_array_equal(ooc[0], want[0])


# -- lossy duals: the K-step kernel's LOSSY instantiations ---------------------

def _lossy_kstep_state(shape, seed=0):
    """A random Jia-Zhao FISTA state on the card with bfloat16 shadow
    duals (each leading slab along its own axis zero)."""
    orig, state, li, lm, _ = _jz_state(shape, True, seed=seed)
    nd = len(shape)
    return orig, state[:1 + nd] + [d.to(torch.bfloat16)
                                   for d in state[1 + nd:]], li, lm


def _assert_lossy_runs(got, others, what):
    for s, sums in others:
        _assert_states(got[0], s, what)
        torch.testing.assert_close(got[1], sums, rtol=1e-5, atol=0)
    assert got[0][-1].dtype == torch.bfloat16


@pytest.mark.cuda
@pytest.mark.parametrize("shape", KSTEP_SHAPES, ids=str)
@pytest.mark.parametrize("k", KS)
def test_lossy_kstep_kernel_bitwise_plain_k1_and_pairs(k, shape):
    """Two launches of the LOSSY instantiation (bfloat16 d: every level's
    d stored rounded and read back by the next) at every depth, N0 = 2K
    and 2K+1, ragged and 128-bit shapes, against the plain version, K
    LOSSY K=1 launches and (K even) K/2 LOSSY pairs per launch: state
    bitwise, d included, sums within rtol 1e-5; both launches counted as
    lossy."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    shape = _at(shape, k)
    orig, state, li, lm = _lossy_kstep_state(shape, seed=sum(shape) + k)
    args = (orig, state, li, lm, k, True)
    before = tkstep.fused_kstep_iteration.lossy_launches
    got = _ksteps(tkstep.fused_kstep_iteration, *args)
    assert tkstep.fused_kstep_iteration.lossy_launches - before == 2
    others = [_ksteps(tkstep.fused_kstep_iteration_reference, *args),
              _ksteps(_k1_launches, *args)]
    if k % 2 == 0:
        others.append(_ksteps(_pair_launches, *args))
    _assert_lossy_runs(got, others, (shape, k))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(37, 45, 19, 23), ("2K+1", 13, 70)],
                         ids=str)
@pytest.mark.parametrize("k", KS)
def test_lossy_kstep_kernel_state_independent_of_grid(k, shape):
    """The LOSSY schedule is race-free at every depth: one block, 7 blocks
    and the full cooperative grid of the LOSSY instantiation give the same
    state bitwise, the plain version's; a grid one block larger is
    refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    shape = _at(shape, k)
    orig, state, li, lm = _lossy_kstep_state(shape, seed=1)
    args = (orig, state, li, lm, k, True)
    full = tkstep.cooperative_grid(torch.device("cuda"), len(shape), True, k,
                                   lossy=True)
    runs = [_ksteps(tkstep.fused_kstep_iteration, *args, grid=g)
            for g in (1, 7, full)]
    plain = _ksteps(tkstep.fused_kstep_iteration_reference, *args)
    _assert_lossy_runs(plain, runs, (shape, k))
    with pytest.raises(RuntimeError, match="launch failed"):
        _ksteps(tkstep.fused_kstep_iteration, *args, grid=full + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k", [(s, k) for s, k, _ in kstep_edge_cases()],
                         ids=str)
def test_lossy_kstep_kernel_tile_edges(shape, k):
    """The LOSSY instantiation at the vector walk's tile edges (last
    extents 1, 4, 5, 128, 129; ND-2 extents 1, 7, 9): the full grid, 1
    block and 7 blocks give the plain version's state and K LOSSY K=1
    launches', d included."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    orig, state, li, lm = _lossy_kstep_state(shape, seed=3)
    args = (orig, state, li, lm, k, True)
    got = _ksteps(tkstep.fused_kstep_iteration, *args)
    others = [_ksteps(tkstep.fused_kstep_iteration, *args, grid=g)
              for g in (1, 7)]
    others += [_ksteps(tkstep.fused_kstep_iteration_reference, *args),
               _ksteps(_k1_launches, *args)]
    _assert_lossy_runs(got, others, (shape, k))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [("N0", 9, 10, 33), ("N0", 13, 64)],
                         ids=str)
@pytest.mark.parametrize("rr", (1, 2, 3))
@pytest.mark.parametrize("k", KS)
def test_lossy_kstep_kernel_rows_per_stage(k, rr, shape):
    """R axis-0 rows per stage of the LOSSY instantiation, N0 not a
    multiple of R, at the full grid and at 1 and 7 blocks: the plain
    version's state and K LOSSY K=1 launches', d included."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    n0 = 2 * k + 1 if (2 * k + 1) % rr or rr == 1 else 2 * k + 2
    shape = (n0,) + shape[1:]
    orig, state, li, lm = _lossy_kstep_state(shape, seed=5)
    args = (orig, state, li, lm, k, True)
    runs = [_ksteps(tkstep.fused_kstep_iteration, *args, grid=g,
                          rows_per_stage=rr) for g in (None, 1, 7)]
    runs += [_ksteps(tkstep.fused_kstep_iteration_reference, *args),
             _ksteps(_k1_launches, *args)]
    _assert_lossy_runs(runs[0], runs[1:], (shape, k, rr))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [4, 1], ids=["8-byte", "2-byte"])
@pytest.mark.parametrize("shape", [(9, 9, 32), (9, 3, 7, 64)], ids=str)
def test_lossy_kstep_kernel_bfloat16_views_off_16_bytes(shape, offset):
    """bfloat16 d arrays that start 8 bytes past a 16-byte boundary keep
    the 64-bit walk (VEC needs 8-byte aligned d), those 2 bytes past it
    take the element-by-element walk: both give the plain version's state
    and K LOSSY K=1 launches', d included."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    orig, state, li, lm = _lossy_kstep_state(shape, seed=6)
    nd = len(shape)
    for q in range(1 + nd, 1 + 2 * nd):
        d = state[q]
        view = torch.empty(d.numel() + offset, dtype=torch.bfloat16,
                           device="cuda")[offset:].view(d.shape).copy_(d)
        assert view.data_ptr() % 16 == 2 * offset
        state[q] = view
    args = (orig, state, li, lm, 4, True)
    got = _ksteps(tkstep.fused_kstep_iteration, *args)
    _assert_lossy_runs(got, [
        _ksteps(tkstep.fused_kstep_iteration_reference, *args),
        _ksteps(_k1_launches, *args)], (shape, offset))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kw", [
    ((22, 9, 10, 33), dict(iterations_fista=19, iterations_unacc=0)),
    ((20, 13, 64), dict(iterations_fista=9, iterations_unacc=9)),
    ((16, 13, 70), dict(iterations_fista=11, iterations_unacc=0,
                        temporal_k=3))], ids=str)
def test_lossy_kstep_runs_on_the_card(shape, kw):
    """``run_solver`` lossy runs on the card that K-step (fixed 4D with a
    remainder, hybrid 3D with both phases K-stepping, a forced K=3):
    bitwise the lossy K=1 loop (K-steps and pairs off), the bfloat16 duals
    included, with LOSSY K-step launches made."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import numpy as np

    from cytvdn_tpu_torch.config import SolverOptions
    from cytvdn_tpu_torch.solver.engine import run_solver

    cube = torch.from_numpy((np.random.default_rng(7).standard_normal(shape)
                             * 0.5 + 2.0).astype(np.float32)).cuda()
    nd = len(shape)
    li = torch.full((nd,), 16.0, device="cuda")
    lm = torch.full((nd,), 1 / 16.0, device="cuda")
    base = dict(ndim=nd, lossy_duals=True, **kw)
    before = tkstep.fused_kstep_iteration.lossy_launches
    got = run_solver(cube, li, lm, SolverOptions(**base), keep_state=True)
    assert tkstep.fused_kstep_iteration.lossy_launches > before
    want = run_solver(cube, li, lm, SolverOptions(
        **base, temporal_kstep=False, temporal_pairs=False), keep_state=True)
    assert got["iterations_run"] == want["iterations_run"]
    assert torch.equal(got["recon"], want["recon"])
    _assert_states(got["ds"], want["ds"], shape)
    _assert_states(got["accs"], want["accs"], shape)
    assert got["ds"][0].dtype == torch.bfloat16
    torch.testing.assert_close(got["delta"].cpu(), want["delta"].cpu(),
                               rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("guard", ["real", "always"])
def test_lossy_kstep_stop_run_on_the_card(monkeypatch, guard):
    """A stop-aware lossy hybrid run on the card through LOSSY K=8 launches
    behind the guard (test_stop_aware_run_solver_equals_k1_loop's run,
    lossy) stops at the lossy K=1 loop's iteration with recon and the
    bfloat16 duals bitwise; with a guard that always allows, blocks are
    discarded (their bfloat16 checkpoint restored) and redone."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from cytvdn_tpu_torch.config import SolverOptions
    from cytvdn_tpu_torch.solver import engine

    shape = (16, 9, 10, 64)
    gen = torch.Generator(device="cuda").manual_seed(6)
    orig = torch.randn(shape, generator=gen, device="cuda") * 0.5 + 2.0
    li = torch.full((4,), 32.0, device="cuda")
    lm = torch.full((4,), 1 / 32, device="cuda")
    base = dict(ndim=4, iterations_fista=12, iterations_unacc=40,
                lossy_duals=True)
    k1 = dict(temporal_kstep=False, temporal_pairs=False)
    probe = engine.run_solver(orig, li, lm, SolverOptions(**base, **k1))
    stop = dict(stopping_relative_change=_stop_threshold(probe["delta"], 40))
    want = engine.run_solver(orig, li, lm, SolverOptions(**base, **stop, **k1),
                             keep_state=True)
    if guard == "always":
        monkeypatch.setattr(engine, "_guard_allows", lambda *a: True)
    before = tkstep.fused_kstep_iteration.lossy_launches
    got = engine.run_solver(orig, li, lm, SolverOptions(**base, **stop),
                            keep_state=True)
    assert tkstep.fused_kstep_iteration.lossy_launches > before
    assert got["iterations_run"] == want["iterations_run"] == 41
    assert got["early_stopped"] and want["early_stopped"]
    assert torch.equal(got["recon"], want["recon"])
    _assert_states(got["ds"], want["ds"], shape)
    for key in ("b_norm", "delta"):
        torch.testing.assert_close(got[key], want[key], rtol=1e-5, atol=0)


# -- the K=1 kernel's vector walk (float32 launches without halos) ------------

# the card smoke run's cases: last extents 1, 30, 31, 33 (masked) and 32,
# 64 (128-bit accesses), 3D and 4D, every BC, iso pairs, lossy duals
WALK_CASES = walk_cases()


def _walk_state(shape, fista, lossy, offset=0):
    """The card smoke run's walk state (seed 0): bfloat16 d where
    ``lossy``; with ``offset`` every array off its 16-byte boundary."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    return walk_state(shape, fista, lossy, gen, offset)


def _walk_runs(orig, state, fista, bc, iso_r, iso_q, iters=3, **kw):
    """``iters`` launches of the kernel (``kw``: its ``grid`` and
    ``band``) and of its plain version on copies of ``state``: each's
    final state and stacked sums."""
    ndim = orig.dim()
    li = torch.linspace(0.2, 0.35, ndim, device="cuda")
    lm = torch.linspace(1 / 32, 1 / 48, ndim, device="cuda")
    rho = torch.tensor(0.37, device="cuda")
    runs = []
    for step, extra in ((tfused.fused_iteration, kw),
                        (tfused.fused_iteration_reference, {})):
        s = [x.clone() for x in state]
        sums = []
        for _ in range(iters):
            out = step(orig, s[0], s[1:1 + ndim],
                       s[1 + ndim:] if fista else None, rho, li, lm,
                       fista=fista, bc=bc, iso_r=iso_r, iso_q=iso_q, **extra)
            sums.append(torch.stack(out[3:]).double().cpu())
        torch.cuda.synchronize()
        runs.append((s, torch.stack(sums)))
    return runs


@pytest.mark.cuda
@pytest.mark.parametrize("case", WALK_CASES, ids=str)
def test_walk_bitwise_equals_plain_at_forced_grids(case):
    """Three launches through the vector walk at the wrapper's grid and at
    forced grids of 1, 7 and all blocks (one per work item) against the
    plain version: state bitwise, d included, sums within rtol 1e-5; each
    launch counted as a walk launch; the default launch repeats exactly,
    state and sums."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    shape, (fista, bc, iso_r, iso_q, lossy) = case
    orig, state = _walk_state(shape, fista, lossy)
    for grid in (None, 1, 7, tfused._walk_items(shape)):
        before = tfused.fused_iteration.walk_launches
        runs = _walk_runs(orig, state, fista, bc, iso_r, iso_q, grid=grid)
        assert tfused.fused_iteration.walk_launches - before == 3
        _assert_same(runs, grid)
        if grid is None:
            again = _walk_runs(orig, state, fista, bc, iso_r, iso_q)
            assert all(torch.equal(a, b) for a, b in zip(runs[0][0],
                                                         again[0][0]))
            assert torch.equal(runs[0][1], again[0][1])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [(True, 2, False, False, False),
                                  (False, 0, False, False, False),
                                  (True, 2, True, True, False),
                                  (True, 2, False, False, True)], ids=str)
@pytest.mark.parametrize("shape", [(9, 5, 7, 32), (6, 13, 64),
                                   (5, 6, 7, 33)], ids=str)
def test_walk_unaligned_state_and_item_orders(shape, mode):
    """A state whose every array starts one element past a 16-byte
    boundary takes the element-by-element walk; launches at item orders of
    1, 2 and N1 axis-1 indices per band (4D), at 1 and 7 blocks too: each
    state bitwise the plain version's, sums within rtol 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    fista, bc, iso_r, iso_q, lossy = mode
    if (iso_r or iso_q) and len(shape) == 3:
        pytest.skip("half-isotropic pairs are 4D")
    orig, state = _walk_state(shape, fista, lossy, offset=1)
    bands = (1, 2, shape[1]) if len(shape) == 4 else (1,)
    for band in bands:
        for grid in (None, 1, 7):
            runs = _walk_runs(orig, state, fista, bc, iso_r, iso_q,
                              band=band, grid=grid)
            _assert_same(runs, (band, grid))


# -- the walk with halos (Jia-Zhao, anisotropic, seams on axes 0 and 1) ------


@pytest.mark.cuda
@pytest.mark.parametrize("mode", WALK_HALO_MODES,
                         ids=["fista", "unaccelerated", "lossy"])
@pytest.mark.parametrize("layout", sorted(WALK_HALO_LAYOUTS))
@pytest.mark.parametrize("shape", WALK_HALO_SHAPES, ids=str)
def test_walk_halo_bitwise_equals_plain(shape, layout, mode):
    """Three launches with halos through the walk on each block of the
    layout (the first, an interior and the last block along axis 0 and
    along axis 1, the four corners of a 2 x 2 grid, blocks of extent 1 on
    axis 0 and on both axes) against the plain version with the same
    halos, at the wrapper's grid and forced grids of 1, 7 and all blocks,
    and (4D) bands of 1, 2 and N1 axis-1 indices: state bitwise, d
    included, sums within rtol 1e-5, every launch a walk launch with
    halos."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    nd = len(shape)
    bands = (None, 1, 2, "N1") if nd == 4 else (None,)
    compare_walk_halo_case(shape, layout, mode, grids=(None, 1, 7, "all"),
                           bands=bands)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(WALK_HALO_LAYOUTS))
@pytest.mark.parametrize("shape", WALK_HALO_SHAPES, ids=str)
def test_walk_halo_unaligned_seams(shape, layout):
    """Every array and seam slab one element past a 16-byte boundary: the
    walk's element-by-element path with halos, exact, unaccelerated and
    lossy, at the wrapper's grid and 1 and 7 blocks, bitwise the plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for mode in WALK_HALO_MODES:
        compare_walk_halo_case(shape, layout, mode, offset=1,
                               grids=(None, 1, 7))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", WALK_HALO_MODES,
                         ids=["fista", "unaccelerated", "lossy"])
@pytest.mark.parametrize("layout", sorted(WALK_HALO_LAYOUTS))
@pytest.mark.parametrize("shape", WALK_HALO_SHAPES, ids=str)
def test_walk_halo_blocks_reassemble_to_one_launch(shape, layout, mode):
    """A Jia-Zhao state cut into every block of the layout's grid, each
    launched through the walk with halos and put back: bitwise one launch
    of the whole cube without halos, d included; the sums add up."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    walk_halo_blocks_equal_one_launch(shape, layout, mode)


def _route_launch(case):
    """One K=1 launch on the card in route case ``case`` (a block of a small
    cube with its halos, or a whole cube); returns (launches, walk launches,
    halo launches) it made and a function that makes it again with
    keyword arguments (``band``/``grid``)."""
    from torch_halo_blocks import HALO_MODES, block_halos, block_state, \
        mode_coords

    dtype = torch.float64 if case.endswith("f64") else torch.float32
    name = case.removesuffix("-f64")
    if name == "whole":
        mode, shape, grid, coords = {}, (9, 10, 11, 12), None, None
    elif name in ("slab", "block", "block3d"):
        shape = {"slab": (9, 10, 11, 12), "block": (6, 6, 11, 12),
                 "block3d": (6, 6, 33)}[name]
        grid = {"slab": (3, 1), "block": (2, 2), "block3d": (2, 2)}[name]
        grid = grid + (1,) * (len(shape) - 2)
        mode = {}
        coords = (1, int(name != "slab")) + (0,) * (len(shape) - 2)
    else:
        mode, shape, grid, ax = HALO_MODES[name]
        coords = mode_coords(grid, ax, 1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    orig, state = walk_state(shape, True, False, gen)
    orig, state = orig.to(dtype), [x.to(dtype) for x in state]
    nd = len(shape)
    li = torch.linspace(0.2, 0.35, nd, device="cuda", dtype=dtype)
    lm = torch.linspace(1 / 32, 1 / 48, nd, device="cuda", dtype=dtype)
    rho = torch.tensor(0.37, device="cuda", dtype=dtype)
    halos, edge = None, None
    if grid is not None:
        halos, edge = block_halos(state[0], state[1:1 + nd], state[1 + nd:],
                                  grid, coords, **mode)
        orig, *state = block_state([orig] + state, grid, coords)

    def launch(**kw):
        return tfused.fused_iteration(
            orig, state[0], state[1:1 + nd], state[1 + nd:], rho, li, lm,
            fista=True, halos=halos, edge_next=edge, **mode, **kw)

    f = tfused.fused_iteration
    before = (f.launches, f.walk_launches, f.halo_launches)
    launch()
    torch.cuda.synchronize()
    return (f.launches - before[0], f.walk_launches - before[1],
            f.halo_launches - before[2]), launch


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["whole-f64", "slab-f64", "ring", "mirror",
                                  "iso-seam0", "iso-seam1", "iso-corner",
                                  "inblock2", "inblock3", "iso-q-corner",
                                  "energy"])
def test_halo_and_float64_launches_take_the_scalar_passes(case):
    """Float64 launches, with halos or without, and float32 launches with
    halos on axes 2 or 3, ring or mirror halos, or iso seams and corners
    take the scalar passes: each counts as a launch but not as a walk
    launch, and refuses ``band`` and ``grid``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    counts, launch = _route_launch(case)
    assert counts[:2] == (1, 0), counts
    assert counts[2] == (case != "whole-f64")
    for kw in (dict(grid=7), dict(band=1)):
        with pytest.raises(ValueError, match="vector walk"):
            launch(**kw)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["whole", "slab", "block", "block3d"])
def test_row_axis_halo_launches_take_the_walk(case):
    """Float32 Jia-Zhao anisotropic launches without halos and with halos
    on axes 0 and 1 only (an out-of-core slab, a 2D-grid block in 4D and
    3D) take the walk: each counts as a walk launch (and, with halos, as a
    halo launch) and takes ``band`` and ``grid``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    counts, launch = _route_launch(case)
    assert counts == (1, 1, int(case != "whole")), counts
    launch(grid=7, band=1)
    torch.cuda.synchronize()
