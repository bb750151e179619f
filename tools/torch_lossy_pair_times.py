#!/usr/bin/env python3
"""Time the pair kernel's LOSSY instantiations (bfloat16 shadow duals) on
one card, in turns with the exact ones.

    python3 tools/torch_lossy_pair_times.py

At config 4, (256,256,128,128) FISTA float32: ms per pair of the exact
pair, the LOSSY pair at whole rows (the wrapper's default) and at axis-1
strips of W = 8, 16 and 32, and of two exact and two LOSSY K=1 launches.
At config 4's 2-rank shard (128,256,128,128), an interior shard with bands
on both sides: the exact and the LOSSY HALO0 pair and the plain lossy pair
with the same bands. Each set runs in turns, every name once in order and
once in reverse (CUDA events, after a warm-up call); one random Jia-Zhao
state per shape, whose d the lossy runs take rounded to bfloat16 (recon and
the accumulators are shared, so the runs keep stepping one state). Beside
each set, the bound of one launch (``utils/perf.py``): d at 4 and at 2
bytes, the shard's 24 band rows counted. Prints one JSON line, with the
card's name and power limit. Needs one CUDA device; exits non-zero
without one.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from cytvdn_tpu_torch.kernels import build  # noqa: E402
from cytvdn_tpu_torch.kernels.temporal import (  # noqa: E402
    fused_pair_iteration,
    fused_pair_iteration_reference,
)
from cytvdn_tpu_torch.utils.perf import (  # noqa: E402
    launch_bound_seconds,
    peak_bandwidth,
    peak_f32,
)


def turns(fns, n):
    """Mean ms of each of ``fns`` over two turns (in order, then reversed),
    ``n`` calls per run (one for the plain version), and the runs."""
    raw = {k: [] for k in fns}
    for k in [*fns, *reversed(fns)]:
        raw[k].append(cs.time_ms(fns[k], 1 if k.startswith("plain") else n))
    return ({k: sum(v) / len(v) for k, v in raw.items()},
            {k: [round(x, 3) for x in v] for k, v in raw.items()})


def lossy(state, nd):
    """The state with its shadow duals rounded to bfloat16 (recon and the
    accumulators shared)."""
    return state[:1 + nd] + [d.to(torch.bfloat16) for d in state[1 + nd:]]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_lossy_pair_times: no CUDA device", file=sys.stderr)
        return 1
    build.load()
    name = torch.cuda.get_device_name(0)
    bw, f32 = peak_bandwidth(name), peak_f32(name)

    def bound(shape, **kw):
        if not (bw and f32):
            return None
        return launch_bound_seconds(shape, True, 2, bw, f32, **kw)[0] * 1e3

    out = {"device": name, "nvidia_smi": cs.smi_line()}
    nd = len(cs.CFG4)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    orig, state, li, lm, rho = cs.random_state(cs.CFG4, True, torch.float32,
                                               gen, jz=True)
    low = lossy(state, nd)
    fns = {"exact_pair": cs.pair_fn(fused_pair_iteration, orig, state, li, lm,
                                    rho, True),
           "lossy_pair": cs.pair_fn(fused_pair_iteration, orig, low, li, lm,
                                    rho, True)}
    for w in (8, 16, 32):
        fns[f"lossy_pair_W{w}"] = cs.pair_fn(fused_pair_iteration, orig, low,
                                             li, lm, rho, True, strip=w)
    fns["exact_k1x2"] = cs.pair_fn(cs.two_k1, orig, state, li, lm, rho, True)
    fns["lossy_k1x2"] = cs.pair_fn(cs.two_k1, orig, low, li, lm, rho, True)
    ms, raw = turns(fns, 3)
    out[str(cs.CFG4)] = {"ms": ms, "runs": raw, "bound_ms": {
        "exact": bound(cs.CFG4), "lossy": bound(cs.CFG4, d_itemsize=2)}}
    del orig, state, low, fns
    torch.cuda.empty_cache()

    shape = cs.SHARD4
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 12)
    orig, state, li, lm = cs.halo0_state(shape, True, gen)
    h = cs.shard_bands(shape, True, gen, False, False)[0]
    low = lossy(state, nd)
    rho1 = torch.tensor(0.37, device="cuda")
    rho2 = torch.tensor(cs.RHO2, device="cuda")

    def call(step, st):
        return lambda: step(orig, st[0], st[1:1 + nd], st[1 + nd:], rho1,
                            rho2, li, lm, fista=True, halos0=h, first0=False,
                            last0=False)

    fns = {"exact_halo0": call(fused_pair_iteration, state),
           "lossy_halo0": call(fused_pair_iteration, low),
           "plain_lossy_halo0": call(fused_pair_iteration_reference, low)}
    ms, raw = turns(fns, 3)
    out[str(shape)] = {"ms": ms, "runs": raw, "bound_ms": {
        "exact": bound(shape, band_rows=24),
        "lossy": bound(shape, band_rows=24, d_itemsize=2)}}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
