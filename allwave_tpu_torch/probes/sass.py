"""The machine code of the kernel libraries: which instructions their
loops run.

`python -m allwave_tpu_torch.probes.sass` builds the kernel libraries
of csrc/ (one nvcc each, all at once), disassembles each with
`cuobjdump -sass` and prints, for every loop of every kernel (a backward branch and the
instructions from its target to it), one JSON line with the kernel,
the loop's size and its opcode histogram. The
op counts behind the bounds (kexp2 `ops_per_step`, kexp6 `STEP_OPS`,
kexp8 `CHOICE_OPS`) are read against these histograms: whether ptxas
merges two adds into one IADD3, moves adds to the FMA pipe as IMAD,
or fuses an add and a min into one DPX VIADDMNMX.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from collections import Counter

_FUNC = re.compile(r"Function : (\S+)")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b(0x[0-9a-f]+)\b")


def opcode(text: str) -> str:
    """The opcode with its modifiers, without a guard predicate."""
    parts = text.split()
    if parts and parts[0].startswith("@"):
        parts = parts[1:]
    return parts[0] if parts else ""


def parse(sass: str):
    """{function: [(address, instruction text)]} and {function: {label:
    address}} of one `cuobjdump -sass` listing."""
    funcs, labels = {}, {}
    name, pending = None, []
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            name, pending = m.group(1), []
            funcs[name], labels[name] = [], {}
            continue
        if name is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[name][lab] = addr
            pending = []
            funcs[name].append((addr, m.group(2)))
    return funcs, labels


def loops(insns, labels):
    """[(start, end, Counter of opcodes)] for every backward branch."""
    out = []
    for addr, text in insns:
        op = opcode(text)
        if not op.startswith("BRA"):
            continue
        m = _TARGET.search(text.split(op, 1)[1])
        if m is None:
            continue
        target = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
        if target is None or target > addr:
            continue
        body = Counter(opcode(t) for a, t in insns if target <= a <= addr)
        out.append((target, addr, body))
    return out


def cuobjdump() -> str:
    from ..wfa import cuda_build

    return os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")


def report(names=None):
    """One dict per loop of every kernel in the libraries (those of
    `names`, csrc/<name>.cu, if given)."""
    from ..wfa import cuda_build

    rows = []
    cuda_build.build_all()
    for name in sorted(names or cuda_build.SIGNATURES):
        sass = subprocess.run([cuobjdump(), "-sass", cuda_build._library_path(name)],
                              capture_output=True, text=True, check=True).stdout
        funcs, labels = parse(sass)
        for func, insns in funcs.items():
            for start, end, body in loops(insns, labels[func]):
                rows.append({"source": name, "function": func, "start": start, "end": end,
                             "instructions": sum(body.values()), "ops": dict(body.most_common())})
    return rows


def main() -> int:
    for r in report():
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
