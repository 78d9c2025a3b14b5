#!/usr/bin/env python3
"""Kernel B5 (csrc/threefry.cu) as the compiler emitted it: its
instructions counted by the pipe of an H100 SM that runs them.

    python3 tools/b5_sass.py [--min-block N]

Builds the threefry library with this checkout's flags (ops/_build.py),
disassembles it with `cuobjdump -sass` and prints, for each kernel, every
basic block of at least N instructions (default 40: the blocks that hold a
threefry; a block starts at a branch target and ends after a branch): its
instructions by opcode, by pipe, and per store, so that a loop body of one
global store (an element) or one shared store (a folded key) reads as
instructions an element or a key.  `--raw FILE` keeps the listing.  Pipes:

    alu      the integer ALU pipe, 64 thread instructions a clock an SM
             (IADD3, LOP3, SHF, ISETP, SEL, LEA, PRMT, ...)
    fma      the FMA pipes: IMAD (any form) and the float instructions
    uniform  the uniform datapath (U* opcodes), one a warp
    memory   loads and stores
    other    control, moves, conversions, VIADD (whose pipe NVIDIA does
             not document) and everything else, by opcode

Every instruction takes one of the SM's 128 issue slots a clock.  The last
line is one JSON object {"kernels": {name: [block, ...]}}.  Needs nvcc and
cuobjdump (the CUDA toolkit); no card.
"""

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ALU = {"IADD3", "LOP3", "SHF", "ISETP", "SEL", "IMNMX", "LEA", "PRMT", "PLOP3", "FLO", "POPC",
       "BMSK", "SGXT", "IABS", "BREV", "ISCADD"}
FMA = {"IMAD", "IMUL", "FFMA", "FADD", "FMUL", "FSETP", "FSEL", "FMNMX"}
MEMORY = {"LDG", "STG", "LDS", "STS", "LD", "ST", "LDC", "ATOM", "ATOMS", "RED"}
INSTRUCTION = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)(.*)")
FUNCTION = re.compile(r"Function : (\S+)")
LABEL = re.compile(r"^\s*(\.L_\w+):")
TARGET = re.compile(r"`\((\.L_\w+)\)|\b0x([0-9a-f]+)\b")
BRANCHES = ("BRA", "EXIT", "RET", "CALL", "BRX", "JMP")


def pipe(opcode: str) -> str:
    base = opcode.split(".")[0]
    if base in ALU:
        return "alu"
    if base in FMA:
        return "fma"
    if base in MEMORY:
        return "memory"
    if base.startswith("U"):
        return "uniform"
    return "other"


def blocks(sass: str):
    """{function: [[opcode, ...] per basic block]}: a block starts at a
    branch target (a label, or an address a branch names) and ends after a
    branch."""
    code, fn = {}, None
    for line in sass.splitlines():
        m = FUNCTION.search(line)
        if m:
            fn = m.group(1)
            code[fn] = []
        elif fn is not None and LABEL.match(line):
            code[fn].append(("label", LABEL.match(line).group(1), ""))
        elif fn is not None and INSTRUCTION.search(line):
            addr, op, rest = INSTRUCTION.search(line).groups()
            code[fn].append((int(addr, 16), op, rest))
    out = {}
    for fn, rows in code.items():
        targets = set()
        for addr, op, rest in rows:
            if addr != "label" and op.split(".")[0] in BRANCHES:
                for label, hexaddr in TARGET.findall(rest.split(";")[0]):
                    targets.add(label or int(hexaddr, 16))
        bbs = [[]]
        for addr, op, _ in rows:
            if addr == "label":
                if bbs[-1]:
                    bbs.append([])
                continue
            if addr in targets and bbs[-1]:
                bbs.append([])
            bbs[-1].append(op)
            if op.split(".")[0] in BRANCHES:
                bbs.append([])
        out[fn] = [b for b in bbs if b]
    return out


def summary(ops):
    by_pipe = collections.Counter(pipe(o) for o in ops)
    stores = {"global": sum(o.startswith("STG") for o in ops),
              "shared": sum(o.startswith("STS") for o in ops)}
    per = max(stores["global"] + stores["shared"], 1)
    return {"instructions": len(ops), "by_pipe": dict(by_pipe), "stores": stores,
            "per_store": {k: v / per for k, v in by_pipe.items()},
            "by_opcode": dict(collections.Counter(ops).most_common()),
            "other": sorted({o for o in ops if pipe(o) == "other"})}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--min-block", type=int, default=40)
    ap.add_argument("--raw", help="also write cuobjdump's listing to this file")
    args = ap.parse_args()
    from caitlynrenderer_tpu_torch.ops import _build

    lib = _build.build("threefry")["path"]
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump") or tool
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    if args.raw:
        with open(args.raw, "w") as f:
            f.write(sass)
    print(f"{lib}: nvcc {' '.join(_build.NVCC_FLAGS)}")
    record = {}
    for fn, bbs in blocks(sass).items():
        total = summary([o for b in bbs for o in b])
        print(f"{fn}: {total['instructions']} instructions, {len(bbs)} blocks, by pipe "
              f"{total['by_pipe']}")
        rows = []
        for i, ops in enumerate(bbs):
            if len(ops) < args.min_block:
                continue
            row = {"block": i, **summary(ops)}
            rows.append(row)
            print(f"  block {i}: {row['instructions']} instructions, stores {row['stores']}; "
                  f"by pipe {row['by_pipe']}; per store "
                  + ", ".join(f"{k} {v:.2f}" for k, v in row["per_store"].items()))
            print(f"    by opcode {row['by_opcode']}")
        record[fn] = rows
    print(json.dumps({"kernels": record}))


if __name__ == "__main__":
    main()
