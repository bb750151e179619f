#!/usr/bin/env python3
"""Check the order of global loads and stores in the built CUDA kernels.

    python3 tools/torch_sass_order.py [NAME_SUBSTRING ...]

Builds ``cytvdn_tpu_torch``'s kernels (if their sources changed), dumps
the library's SASS with ``cuobjdump -sass`` and, for every kernel
instantiation whose mangled name contains one of the substrings (default:
``pair_kernel``), looks at each global store (``STG``) whose address
register is that of an earlier global load (``LDG``): the store is sent
while that load is in flight when no instruction between them reads the
load's destination register. A store sent so, to the address its own
thread is loading, made the pair kernel 2.6-6x slower (PERF.md section 6,
PR 8). Prints one line per instantiation: its template arguments, its
stores, the stores matched to an earlier same-address load, and those sent
with that load in flight (which should be 0). Exits 1 if any is. Needs
``nvcc`` and ``cuobjdump`` (a CUDA toolkit), not a card.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from cytvdn_tpu_torch.kernels import build  # noqa: E402

_INS = re.compile(r"/\*[0-9a-f]{4}\*/\s+(.*?);")
_STG = re.compile(r"(?:@!?U?P\d\s+)?STG\S*\s+(desc\[\w+\]\[[^\]]+\])")
_LDG = re.compile(
    r"(?:@!?U?P\d\s+)?LDG\S*\s+(R\d+),\s+(desc\[\w+\]\[[^\]]+\])")


def store_order(sass_function: str):
    """(stores, stores after a same-address load, those sent while that
    load's value was not yet read) of one function's SASS."""
    lines = [m.group(1).strip() for m in _INS.finditer(sass_function)]
    stores = matched = in_flight = 0
    for i, line in enumerate(lines):
        st = _STG.match(line)
        if not st:
            continue
        stores += 1
        for j in range(i - 1, -1, -1):
            ld = _LDG.match(lines[j])
            if ld and ld.group(2) == st.group(1):
                matched += 1
                reg = re.compile(r"\b%s\b" % ld.group(1))
                # the operands of the instructions in between (after the
                # opcode and the destination)
                if not any(reg.search(lines[k].split(",", 1)[-1])
                           for k in range(j + 1, i)):
                    in_flight += 1
                break
    return stores, matched, in_flight


def main(argv) -> int:
    names = argv or ["pair_kernel"]
    build.load()
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", build._LIB],
                          capture_output=True, text=True, check=True).stdout
    bad = 0
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        mangled = fn.split("\n", 1)[0].strip()
        if not any(n in mangled for n in names):
            continue
        m = re.search(r"([a-z]+_kernel)I(.+?)EEv", mangled)
        label = f"{m.group(1)}<{m.group(2)}>" if m else mangled
        stores, matched, in_flight = store_order(fn)
        bad += in_flight
        print(f"{label}: {stores} stores, {matched} after a same-address "
              f"load, {in_flight} sent with that load in flight")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
