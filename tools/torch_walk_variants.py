#!/usr/bin/env python3
"""Time variants of the K=1 kernel's vector walk on one card, in turns,
with each pass's device time.

    python3 tools/torch_walk_variants.py OUT_DIR

Copies this checkout's package, ``chip_smoke.py`` and ``tests`` into
``OUT_DIR/<variant>`` once per variant, with the variant's edits to
``cytvdn_tpu_torch/csrc/fused_iteration.cu``:

- ``as is``: the walk as it stands (b and d stored evict-first; the dual
  pass told that one block per SM will do, so that it may take as many
  registers as it likes);
- ``plain stores``: the dual pass through ``vec_walk.cuh::dual_item``,
  whose stores are ordinary (write-back, normal eviction priority);
- ``no bound``: no blocks-per-SM bound on the dual pass (the compiler's
  own register budget);
- ``iso held``: the iso dual pass held to the registers of 3 blocks per
  SM.

Then, for each variant in turns (up, then down), a child process builds
that copy's kernels, prints their ptxas lines and, on one Jia-Zhao FISTA
float32 state at config 4 (256,256,128,128), the device time of the dual
and recon passes (``torch.profiler``, 3 launches) of the exact, lossy
(bfloat16 d) and iso R+Q launches at the wrapper's grids and with both
passes on 1, 2 and 3 blocks per SM, and ms per launch at the wrapper's
grids (CUDA events). Prints one JSON line per run and the means by
variant. Needs one CUDA device and a CUDA toolkit; exits non-zero without
one or if a child fails.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join("cytvdn_tpu_torch", "csrc", "fused_iteration.cu")
#: (old, new) edits of fused_iteration.cu per variant
VARIANTS = {
    "as is": [],
    "plain stores": [("dual_item_cs<", "dual_item<")],
    "no bound": [("__launch_bounds__(NT, 1)", "__launch_bounds__(NT)")],
    "iso held": [("__launch_bounds__(NT, 1)",
                  "__launch_bounds__(NT, ISO ? 3 : 1)")],
}

CHILD = r"""
import json, sys, torch
import chip_smoke as cs
from cytvdn_tpu_torch.kernels import build
from cytvdn_tpu_torch.kernels.fused import fused_iteration
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
if not torch.cuda.is_available():
    sys.exit("no CUDA device")
build.load()
ptx = [p for p in cs.ptxas_summary(open(build.LOG).read()).split("; ")
       if "walk" in p]
sms = torch.cuda.get_device_properties(0).multi_processor_count


def passes(fn):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type != DeviceType.CPU]
    return [sum(e.device_time_total for e in ev if n in e.name) / 3e3
            for n in ("dualwalk_kernel", "reconwalk_kernel")]


gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
orig, st, li, lm, rho = cs.random_state((256, 256, 128, 128), True,
                                        torch.float32, gen, jz=True)
lossy = st[:5] + [d.to(torch.bfloat16) for d in st[5:]]
modes = {"exact": (st, {}), "lossy": (lossy, {}),
         "rq": (st, dict(iso_r=True, iso_q=True))}
out = {"ptxas": ptx, "passes": {}, "ms": {}}
for mode, (s, kw) in modes.items():
    for per_sm in (None, 1, 2, 3):
        grid = {} if per_sm is None else dict(grid=per_sm * sms)
        key = f"{mode} {'default' if per_sm is None else per_sm}"
        out["passes"][key] = passes(cs.step_fn(
            fused_iteration, orig, s, li, lm, rho, True, **kw, **grid))
    f = cs.step_fn(fused_iteration, orig, s, li, lm, rho, True, **kw)
    out["ms"][mode] = (cs.time_ms(f, 3) + cs.time_ms(f, 3)) / 2
print(json.dumps(out))
"""


#: what a variant's child needs of the checkout
PARTS = ("cytvdn_tpu_torch", "chip_smoke.py", "tests")


def copy_variant(out_dir: str, name: str, edits) -> str:
    dst = os.path.join(out_dir, name.replace(" ", "_"))
    shutil.rmtree(dst, ignore_errors=True)
    for part in PARTS:
        src = os.path.join(ROOT, part)
        if os.path.isdir(src):
            shutil.copytree(src, os.path.join(dst, part),
                            ignore=shutil.ignore_patterns("_build",
                                                          "__pycache__"))
        else:
            os.makedirs(dst, exist_ok=True)
            shutil.copy2(src, dst)
    path = os.path.join(dst, SRC)
    with open(path) as f:
        text = f.read()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"variant {name}: {old!r} not in {SRC}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return dst


def main(argv) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    out_dir = os.path.abspath(argv[0])
    roots = {name: copy_variant(out_dir, name, edits)
             for name, edits in VARIANTS.items()}
    order = list(VARIANTS)
    runs = {}
    for name in order + order[::-1]:
        root = roots[name]
        r = subprocess.run([sys.executable, "-c", CHILD], cwd=root,
                           env=dict(os.environ, PYTHONPATH=root),
                           capture_output=True, text=True, timeout=1200)
        if r.returncode != 0:
            print(name, r.stdout[-3000:], r.stderr[-3000:], file=sys.stderr)
            return 1
        rec = json.loads(r.stdout.strip().splitlines()[-1])
        print(json.dumps({"variant": name, **rec}), flush=True)
        runs.setdefault(name, []).append(rec)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    means = {name: {
        "ms": {m: sum(r["ms"][m] for r in recs) / len(recs)
               for m in recs[0]["ms"]},
        "passes": {k: [sum(r["passes"][k][i] for r in recs) / len(recs)
                       for i in range(2)] for k in recs[0]["passes"]},
        "ptxas": recs[0]["ptxas"]} for name, recs in runs.items()}
    print(json.dumps({"means": means, "smi": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
