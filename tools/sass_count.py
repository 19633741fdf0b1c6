#!/usr/bin/env python3
"""Count the SASS instructions of a CUDA kernel's loops.

    python3 tools/sass_count.py blockfp panel_apply_blockfp

Compiles ``src/repro_torch/kernels/csrc/<source>.cu`` to a cubin for
``sm_90a`` with the port's own nvcc flags, disassembles it with
``cuobjdump -sass`` and, for every kernel whose name holds the given
substring, prints each loop (a backward branch and the instructions it
jumps back over, innermost first) with its instructions counted by opcode,
and by class: global memory (``LDG``/``STG``; ``LDG...CONSTANT`` are the
``__ldg`` table reads), shared memory (``LDS``/``STS``), branches and
predicates, and the rest (integer and move instructions: the arithmetic).
Needs nvcc and cuobjdump (the CUDA toolkit); no GPU.
"""
from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import _build  # noqa: E402

LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
FUNC = re.compile(r"Function : (\S+)")


def tool(name):
    found = shutil.which(name)
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        name)


def disassemble(source):
    """{kernel name: [(address, instruction text)]} of csrc/<source>.cu."""
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, f"{source}.cubin")
        subprocess.run([tool("nvcc"), *flags, "-cubin", "-o", cubin,
                        str(_build.SRC_DIR / f"{source}.cu")], check=True)
        text = subprocess.run([tool("cuobjdump"), "-sass", cubin], check=True,
                              capture_output=True, text=True).stdout
    kernels, cur = {}, None
    for ln in text.splitlines():
        m = FUNC.search(ln)
        if m:
            cur = kernels.setdefault(m.group(1), [])
            continue
        m = LINE.search(ln)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    return kernels


def opcode(ins):
    """The opcode with its modifiers, predicate dropped."""
    ins = re.sub(r"^@!?U?P\w+\s+", "", ins)
    return ins.split()[0] if ins else ""


def klass(op):
    base = op.split(".")[0]
    if base in ("LDG", "STG", "LD", "ST", "ATOM", "RED"):
        return "global table" if "CONSTANT" in op else "global"
    if base in ("LDS", "STS", "LDSM"):
        return "shared"
    if base in ("BRA", "BSSY", "BSYNC", "EXIT", "RET", "CALL", "BAR", "WARPSYNC",
                "ISETP", "PLOP3", "P2R", "R2P"):
        return "control"
    return "arithmetic"


def loops(body):
    """(start, end) address pairs of the backward branches of ``body``."""
    out = []
    for addr, ins in body:
        m = re.search(r"\bBRA(?:\.\w+)*\s+(?:`\(\.L_x_\d+\)\s*)?(0x[0-9a-f]+)",
                      ins)
        if m and int(m.group(1), 16) <= addr:
            out.append((int(m.group(1), 16), addr))
    return sorted(out, key=lambda r: r[1] - r[0])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("source", help="csrc/<source>.cu")
    ap.add_argument("kernel", help="a substring of the kernels' names")
    ap.add_argument("--dump", help="also write each kernel's SASS to this "
                                   "directory")
    args = ap.parse_args()
    for name, body in disassemble(args.source).items():
        if args.kernel not in name:
            continue
        print(f"{name}: {len(body)} instructions")
        if args.dump:
            os.makedirs(args.dump, exist_ok=True)
            with open(os.path.join(args.dump, f"{name}.sass"), "w") as f:
                f.writelines(f"/*{a:04x}*/ {ins} ;\n" for a, ins in body)
        for start, end in loops(body):
            ops = [opcode(ins) for addr, ins in body if start <= addr <= end]
            by_class = collections.Counter(klass(op) for op in ops)
            by_op = collections.Counter(ops)
            print(f"  loop {start:#x}..{end:#x}: {len(ops)} instructions; "
                  + ", ".join(f"{k} {v}" for k, v in sorted(by_class.items()))
                  + "\n    " + ", ".join(f"{k} {v}" for k, v in
                                         by_op.most_common()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
