#!/usr/bin/env python3
"""Check the order of global loads and stores in the built CUDA kernels.

    python3 tools/torch_sass_order.py [--lines] [NAME_SUBSTRING ...]

Builds ``cytvdn_tpu_torch``'s kernels (if their sources changed), dumps
the library's SASS with ``cuobjdump -sass`` and, for every kernel
instantiation whose mangled name contains one of the substrings (default:
``pair_kernel``), looks at each global store (``STG``) whose address
register is that of an earlier global load (``LDG``): the store is sent
while that load is in flight when no instruction between them reads the
load's destination register. A store sent so, to the address its own
thread is loading, made the pair kernel 2.6-6x slower and the K=1
kernel's half-isotropic dual pass 7x slower (PERF.md section 6). The
search for that load stops at an instruction that sets the store's
address register, which then held another address before; a store
whose address the compiler computed apart from its load's is paired
with none. Prints
one line per instantiation: its template arguments, its stores, the
stores matched to an earlier same-address load, those sent with that load
in flight (which should be 0) with their SASS offsets, and its
local-memory loads and stores (``LDL``/``STL``: spills, or an array
indexed at run time). Exits 1 if any store is sent in flight.

``--lines`` also compiles every ``csrc/*.cu`` into a cubin with
``-lineinfo`` (the library's flags otherwise) and disassembles it with
``nvdisasm -g``, so that each in-flight store is printed with the source
line it comes from (the branch of the element code that holds it), and
each instantiation's ``LDL``/``STL`` are counted by source line. Needs
``nvcc``, ``cuobjdump`` and ``nvdisasm`` (a CUDA toolkit), not a card.

``--digests FILE`` also writes, as JSON, a digest of each matching
instantiation's instructions (offsets left out) by its label, so that two
trees' builds can be compared function by function:
``--compare PARENT.json CHANGE.json`` prints which of the parent's
instantiations compiled to the same code in the change (by digest, so a
template argument added to a kernel does not hide a match) and exits 1 if
any did not.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from cytvdn_tpu_torch.kernels import build  # noqa: E402

_INS = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LINE = re.compile(r'//## File "([^"]+)", line (\d+)')
_STG = re.compile(r"(?:@!?U?P\d\s+)?STG\S*\s+(desc\[\w+\]\[[^\]]+\])")
_LDG = re.compile(
    r"(?:@!?U?P\d\s+)?LDG\S*\s+(R\d+),\s+(desc\[\w+\]\[[^\]]+\])")
_LOCAL = re.compile(r"(?:@!?U?P\d\s+)?(LDL|STL)\b")
_DEST = re.compile(r"(?:@!?U?P\w+\s+)?(\S+)\s+R(\d+)\b")


def _written(line: str):
    """The registers an instruction writes: its destination, and the next
    register too where it writes a 64-bit pair (``.64``, ``.WIDE``)."""
    m = _DEST.match(line)
    if not m or m.group(1).startswith(("ST", "RED", "ATOM")):
        return set()
    r = int(m.group(2))
    return {r, r + 1} if ".64" in m.group(1) or "WIDE" in m.group(1) else {r}


def _address_regs(address: str):
    """The registers an address operand (``desc[UR..][R12.64+0x8]``)
    reads."""
    m = re.search(r"\]\[R(\d+)(\.64)?", address)
    if not m:
        return set()
    r = int(m.group(1))
    return {r, r + 1} if m.group(2) else {r}


def _instructions(sass_function: str):
    """(offset, instruction, source line or None) of each instruction."""
    out, where = [], None
    for ln in sass_function.splitlines():
        m = _LINE.search(ln)
        if m:
            where = f"{os.path.basename(m.group(1))}:{m.group(2)}"
            continue
        m = _INS.search(ln)
        if m:
            out.append((m.group(1), m.group(2).strip(), where))
    return out


def functions(sass: str):
    """(mangled name, text) of each function in ``cuobjdump -sass`` or
    ``nvdisasm`` output."""
    if "Function : " in sass:
        for fn in re.split(r"\n\s*Function : ", sass)[1:]:
            yield fn.split("\n", 1)[0].strip(), fn
        return
    parts = re.split(r"^\s*\.text\.(\S+):\s*$", sass, flags=re.M)
    for i in range(1, len(parts) - 1, 2):
        yield parts[i], parts[i + 1]


def label(mangled: str) -> str:
    m = re.search(r"([a-z]+_kernel)I(.+?)EEv", mangled)
    if m:
        return f"{m.group(1)}<{m.group(2)}>"
    # a kernel that is no template: its name without the namespace
    m = re.search(r"\d([a-z]+_kernel)E", mangled)
    return m.group(1) if m else mangled


def store_order(sass_function: str):
    """(stores, stores after a same-address load, the stores sent while
    that load's value was not yet read, as (offset, source line or None))
    of one function's SASS."""
    ins = _instructions(sass_function)
    stores = matched = 0
    in_flight = []
    for i, (off, line, where) in enumerate(ins):
        st = _STG.match(line)
        if not st:
            continue
        stores += 1
        addr = _address_regs(st.group(1))
        for j in range(i - 1, -1, -1):
            # an instruction that sets the store's address register: an
            # earlier load through that register read another address
            if addr & _written(ins[j][1]):
                break
            ld = _LDG.match(ins[j][1])
            if ld and ld.group(2) == st.group(1):
                matched += 1
                reg = re.compile(r"\b%s\b" % ld.group(1))
                # the operands of the instructions in between (after the
                # opcode and the destination)
                if not any(reg.search(ins[k][1].split(",", 1)[-1])
                           for k in range(j + 1, i)):
                    in_flight.append((off, where))
                break
    return stores, matched, in_flight


def local_memory(sass_function: str):
    """(LDL, STL) instructions of one function's SASS."""
    ops = [m.group(1) for _, line, _ in _instructions(sass_function)
           for m in [_LOCAL.match(line)] if m]
    return ops.count("LDL"), ops.count("STL")


def local_lines(sass_function: str) -> str:
    """``; local memory at LINE OPxN, ...``: the function's ``LDL``/``STL``
    counted by source line, in order of first appearance (empty without
    line information)."""
    counts = {}
    for _, line, where in _instructions(sass_function):
        m = _LOCAL.match(line)
        if m and where:
            key = f"{where} {m.group(1)}"
            counts[key] = counts.get(key, 0) + 1
    return ("; local memory at " + ", ".join(f"{k}x{n}"
                                              for k, n in counts.items())
            if counts else "")


def library_sass() -> str:
    build.load()
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", build._LIB],
                          capture_output=True, text=True, check=True).stdout


def lineinfo_sass(sources, out_dir: str) -> str:
    """The SASS of ``sources`` built as the library's objects are, with
    ``-lineinfo``, one nvcc per source started together; ``nvdisasm -g``
    output with every instruction's source line."""
    nvcc = build.nvcc_path()
    nvdisasm = os.path.join(os.path.dirname(nvcc), "nvdisasm")
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for src in sources:
        cubin = os.path.join(out_dir, os.path.basename(src) + ".cubin")
        with open(cubin + ".log", "w") as log:
            procs.append((cubin, subprocess.Popen(
                [nvcc, *build.FLAGS, "-lineinfo", "-cubin", "-o", cubin, src],
                stdout=log, stderr=subprocess.STDOUT)))
    text = []
    for cubin, p in procs:
        if p.wait() != 0:
            with open(cubin + ".log") as log:
                raise RuntimeError(f"nvcc -lineinfo failed for {cubin}: "
                                   f"{log.read()[-4000:]}")
        text.append(subprocess.run([nvdisasm, "-g", "-c", cubin],
                                   capture_output=True, text=True,
                                   check=True).stdout)
    return "\n".join(text)


def report(sass: str, names):
    """One line per matching instantiation, and the stores sent in flight."""
    rows, bad = [], 0
    for mangled, fn in functions(sass):
        if not any(n in mangled for n in names):
            continue
        stores, matched, in_flight = store_order(fn)
        ldl, stl = local_memory(fn)
        bad += len(in_flight)
        at = ", ".join(f"0x{o}" + (f" {w}" if w else "")
                       for o, w in in_flight)
        rows.append(f"{label(mangled)}: {stores} stores, {matched} after a "
                    f"same-address load, {len(in_flight)} sent with that "
                    f"load in flight{f' ({at})' if at else ''}; LDL {ldl}, "
                    f"STL {stl}{local_lines(fn)}")
    return rows, bad


def digests(sass: str, names):
    """{label: digest of the instructions} of the matching functions."""
    return {label(m): hashlib.sha256("\n".join(
        i for _, i, _ in _instructions(fn)).encode()).hexdigest()[:16]
        for m, fn in functions(sass) if any(n in m for n in names)}


def compare(parent_path: str, change_path: str) -> int:
    """Print, per parent instantiation, whether the change holds one with
    the same code; 1 if any parent instantiation has none."""
    with open(parent_path) as f:
        parent = json.load(f)
    with open(change_path) as f:
        change = json.load(f)
    by_digest = {}
    for lab, dig in change.items():
        by_digest.setdefault(dig, []).append(lab)
    missing = 0
    for lab, dig in sorted(parent.items()):
        same = by_digest.get(dig)
        missing += not same
        print(f"{lab} {dig}: " + ("same code as " + ", ".join(same) if same
                                  else "no instantiation of the change has "
                                       "this code"))
    new = sorted(lab for lab, dig in change.items()
                 if dig not in set(parent.values()))
    print(f"{len(parent) - missing} of {len(parent)} parent instantiations "
          f"unchanged; the change's instantiations with new code: {new}")
    return 1 if missing else 0


def main(argv) -> int:
    if argv[:1] == ["--compare"]:
        return compare(argv[1], argv[2])
    lines = "--lines" in argv
    out = None
    if "--digests" in argv:
        i = argv.index("--digests")
        out = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    names = [a for a in argv if a != "--lines"] or ["pair_kernel"]
    sass = library_sass()
    rows, bad = report(sass, names)
    print("\n".join(rows))
    if out:
        with open(out, "w") as f:
            json.dump(digests(sass, names), f, indent=1, sort_keys=True)
    if lines:
        srcs = sorted(glob.glob(os.path.join(ROOT, "cytvdn_tpu_torch", "csrc",
                                             "*.cu")))
        rows, _ = report(lineinfo_sass(srcs, os.path.join(build.BUILD_DIR,
                                                          "lineinfo")), names)
        print("with -lineinfo:\n" + "\n".join(rows))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
