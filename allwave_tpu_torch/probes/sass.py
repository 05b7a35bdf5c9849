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

`hop_chain` reads a serial walk's dependent chain off its machine code:
the least latency, in loads and ALU instructions, from one hop's tile
load to the next (the walks' chain bounds, chip_smoke.py phases 1 and
16). `step_chain` reads a lock-step loop's (the step probes'): the
longest chain of one step, from its neighbour exchange (a shuffle or a
shared-memory load) through the dependent instructions and the step's
barrier to the next step's exchange.
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


_REG = re.compile(r"\b(U?R|U?P)(\d+)(\.64|\.128)?")
#: opcodes that write no register (stores, branches, barriers, waits)
_NO_DEST = ("ST", "RED", "BRA", "BRX", "JMP", "BSSY", "BSYNC", "BREAK", "EXIT", "RET", "CALL",
            "NOP", "YIELD", "NANOSLEEP", "BAR", "MEMBAR", "FENCE", "WARPSYNC", "CCTL", "LDGSTS",
            "LDGDEPBAR", "DEPBAR", "ERRBAR", "ENDCOLLECTIVE", "BPT", "KILL")
#: opcodes that write two predicates, then read
_TWO_PREDICATES = ("ISETP", "FSETP", "DSETP", "HSETP", "PSETP", "PLOP3", "UISETP", "UPLOP3")
#: the weight of a load against an ALU instruction when two chains are
#: compared (a shared-memory load takes ~5 times an add on an H100)
LOAD_WEIGHT = 5


def _regs(operand: str, width: int = 1):
    """The registers an operand names (a `.64` pair or `.128` quad as
    its parts; `width` widens a bare register)."""
    out = []
    for m in _REG.finditer(operand):
        n = {".64": 2, ".128": 4}.get(m.group(3) or "", width)
        out += [f"{m.group(1)}{int(m.group(2)) + k}" for k in range(n)]
    return out


def operands(text: str):
    """(guard, opcode, dests, sources) of one instruction: the registers
    (R, UR, P, UP; RZ and PT are none) it writes and reads, the guard
    predicate among the sources."""
    parts = text.split(None, 1)
    guard = []
    if parts and parts[0].startswith("@"):
        guard = _regs(parts[0])
        parts = parts[1].split(None, 1) if len(parts) > 1 else []
    op = parts[0] if parts else ""
    ops = [o.strip() for o in parts[1].split(",")] if len(parts) > 1 else []
    if op.startswith(_NO_DEST) or not ops:
        return guard, op, [], guard + [r for o in ops for r in _regs(o)]
    pred = lambda o: re.fullmatch(r"U?P(\d+|T)", o) is not None
    if op.startswith(_TWO_PREDICATES):
        n_dest = 2
    elif pred(ops[0]):
        # LOP3 P, R; SHFL P, R: a predicate, then a register
        n_dest = 2 if len(ops) > 1 and re.fullmatch(r"U?R(\d+|Z)", ops[1]) else 1
    else:
        # carry-outs follow the first operand (IADD3 R, P, P)
        n_dest = 1
        while n_dest < min(len(ops), 3) and pred(ops[n_dest]):
            n_dest += 1
    width = 4 if ".128" in op else 2 if ".64" in op or ".WIDE" in op else 1
    dests = [r for o in ops[:n_dest] for r in _regs(o, width if o[0] in "RU" else 1)]
    return guard, op, dests, guard + [r for o in ops[n_dest:] for r in _regs(o)]


def _successors(insns, labels):
    """{index: [indices]} of the instructions' control flow."""
    at = {a: i for i, (a, _) in enumerate(insns)}
    succ = {}
    for i, (_, text) in enumerate(insns):
        guard, op, _, srcs = operands(text)
        nxt = [i + 1] if i + 1 < len(insns) else []
        if op.startswith("BRA"):
            m = _TARGET.search(text.split(op, 1)[1])
            tgt = None if m is None else labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
            tgt = [at[tgt]] if tgt in at else []
            succ[i] = tgt + (nxt if guard or srcs or op != "BRA" else [])
        elif op.startswith(("EXIT", "RET", "BRX", "JMP", "BPT")):
            succ[i] = nxt if guard else []
        else:
            succ[i] = nxt
    return succ


def _cycle(succ, i):
    """The shortest path (fewest instructions) from instruction i back to
    it, as indices after i up to and including i; None if there is none."""
    prev, frontier = {}, list(succ[i])
    for j in frontier:
        prev.setdefault(j, i)
    seen = set(frontier)
    while frontier and i not in seen:
        nxt = []
        for j in frontier:
            for k in succ[j]:
                if k not in seen:
                    seen.add(k)
                    prev[k] = j
                    nxt.append(k)
        frontier = nxt
    if i not in seen:
        return None
    path, j = [i], prev[i]
    while j != i:
        path.append(j)
        j = prev[j]
    return path[::-1]


def _chain(insns, i, path):
    """(loads, alu) from load i's issue to its next issue along `path`,
    None if its next address does not depend on what it loaded. Each
    instruction issues in order, once its sources are ready, and its
    result is ready one shared-memory load (LDS) or one ALU latency
    later (any other instruction: constant and device loads take at
    least that); a predicated instruction may leave its destination as
    it was."""
    key = lambda d: LOAD_WEIGHT * d[0] + d[1]
    _, op, dests, _ = operands(insns[i][1])
    ready = {r: (1, 0) for r in dests}
    tainted = set(dests)
    issue = (0, 0)
    for j in path:
        guard, op, dests, srcs = operands(insns[j][1])
        issue = max([issue] + [ready[r] for r in srcs if r in ready], key=key)
        if j == i:
            return issue if any(r in tainted for r in srcs) else None
        done = (issue[0] + 1, issue[1]) if op.startswith("LDS") else (issue[0], issue[1] + 1)
        hit = any(r in tainted for r in srcs)
        for r in dests:
            ready[r] = max(ready.get(r, (0, 0)), done, key=key) if guard else done
            if hit:
                tainted.add(r)
            elif not guard:
                tainted.discard(r)
    return None


def hop_chain(insns, labels):
    """The least dependent chain of one hop of a serial walk, from its
    machine code (`parse`): over every shared-memory load on a loop
    without a spin wait (YIELD, NANOSLEEP) whose next address depends on
    what it loaded, the chain along that loop's shortest way round,
    from the load's issue to its next. {"loads", "alu", "at"} (the
    load's address), or None where no load qualifies."""
    succ = _successors(insns, labels)
    best = None
    for i, (addr, text) in enumerate(insns):
        if not operands(text)[1].startswith("LDS"):
            continue
        path = _cycle(succ, i)
        if path is None or any(opcode(insns[j][1]).startswith(("YIELD", "NANOSLEEP")) for j in path):
            continue
        c = _chain(insns, i, path)
        if c is not None and (best is None or LOAD_WEIGHT * c[0] + c[1] < LOAD_WEIGHT * best[0] + best[1]):
            best = (c[0], c[1], addr)
    return None if best is None else {"loads": best[0], "alu": best[1], "at": best[2]}


#: the instructions a step exchanges its neighbours' values by
EXCHANGE = ("SHFL", "LDS")
#: a step chain's counts, in this order
STEP_KINDS = ("shfl", "lds", "alu", "bar")


def _step_kind(op: str) -> int:
    for k, prefix in ((0, "SHFL"), (1, "LDS"), (3, "BAR")):
        if op.startswith(prefix):
            return k
    return 2


def _plus(t, k: int):
    return t[:k] + (t[k] + 1,) + t[k + 1:]


def _step_key(t) -> int:
    return LOAD_WEIGHT * (t[0] + t[1] + t[3]) + t[2]


def _innermost_loop(insns, labels, i):
    """(start, end) indices of the innermost loop (a backward branch and
    its target) holding instruction i, or None."""
    at = {a: k for k, (a, _) in enumerate(insns)}
    best = None
    for k, (_, text) in enumerate(insns):
        op = opcode(text)
        if not op.startswith("BRA"):
            continue
        m = _TARGET.search(text.split(op, 1)[1])
        tgt = None if m is None else labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
        if tgt not in at or at[tgt] > k or not at[tgt] <= i <= k:
            continue
        if best is None or k - at[tgt] < best[1] - best[0]:
            best = (at[tgt], k)
    return best


def _branch_target(insns, labels, at, k):
    """The index a branch instruction k jumps to, or None."""
    op = opcode(insns[k][1])
    m = _TARGET.search(insns[k][1].split(op, 1)[1])
    tgt = None if m is None else labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
    return at.get(tgt)


def _step_chains(insns, labels, i, loop, limit: int = 256):
    """The chains (shfl, lds, alu, bar) from exchange i's issue to the
    issue of the first exchange that depends on it, along every way
    round `loop` (start, end) from i: each conditional forward branch
    taken and not (at most `limit` ways), an unconditional one
    followed, the loop's back edge taken (an inner loop's not). A way
    that leaves the loop, or passes a second barrier (more than one
    step), has none. Instructions issue in order, each once its sources
    are ready; a result is ready one latency of its kind later; nothing
    issues before a barrier completes. A shared-memory store of a value
    that depends on i, then a barrier, makes every later shared-memory
    load depend on i."""
    at = {a: k for k, (a, _) in enumerate(insns)}
    start, end = loop
    zero = (0, 0, 0, 0)
    _, op, dests, _ = operands(insns[i][1])
    ready0 = {r: _plus(zero, _step_kind(op)) for r in dests}
    # (index, ready, tainted, issue, stored, visible, instructions walked)
    todo = [(i + 1, ready0, set(dests), zero, False, None, 0)]
    out, ways = [], 1
    while todo:
        k, ready, tainted, issue, stored, visible, n = todo.pop()
        while n <= 2 * (end - start + 1):
            if k > end:
                k = start
            n += 1
            guard, op, dests, srcs = operands(insns[k][1])
            via_memory = op.startswith("LDS") and visible is not None
            times = [issue] + [ready[r] for r in srcs if r in ready] + (
                [visible] if via_memory else [])
            issue = max(times, key=_step_key)
            hit = via_memory or any(r in tainted for r in srcs)
            if op.startswith(EXCHANGE) and hit:
                out.append(issue)
                break
            if k == i or (op.startswith(("EXIT", "RET")) and not guard):
                break
            if op.startswith("BAR"):
                if issue[3]:
                    break  # a second barrier: more than one step
                issue = _plus(issue, 3)
                if stored:
                    visible = issue
                k += 1
                continue
            if op.startswith("BRA"):
                tgt = _branch_target(insns, labels, at, k)
                if tgt is None or not start <= tgt <= end:
                    if not (guard or srcs):
                        break  # leaves the loop
                    k += 1
                    continue
                if not (guard or srcs):
                    k = tgt
                elif tgt > k and ways < limit:
                    ways += 1
                    todo.append((tgt, dict(ready), set(tainted), issue, stored, visible, n))
                    k += 1
                else:
                    k = tgt if tgt == start else k + 1
                continue
            if op.startswith("STS") and hit:
                stored = True
            done = _plus(issue, _step_kind(op))
            for r in dests:
                ready[r] = max(ready.get(r, zero), done, key=_step_key) if guard else done
                if hit:
                    tainted.add(r)
                elif not guard:
                    tainted.discard(r)
            k += 1
    return out


def step_chain(insns, labels):
    """The dependent chain of one step of a lock-step loop, from its
    machine code (`parse`): for every exchange instruction (SHFL, LDS)
    in a loop, the least chain over its ways round the loop to the
    first exchange that depends on it, through registers or through
    shared memory over a barrier (`_step_chains`: the fastest way a step
    that computes can take); the longest of those over the exchanges:
    {"shfl", "lds", "alu", "bar", "exchange" (its opcode), "at" (its
    address)}, or None where no exchange has one."""
    best = None
    for i, (addr, text) in enumerate(insns):
        op = operands(text)[1]
        if not op.startswith(EXCHANGE):
            continue
        loop = _innermost_loop(insns, labels, i)
        chains = [] if loop is None else _step_chains(insns, labels, i, loop)
        if not chains:
            continue
        c = min(chains, key=_step_key)
        if best is None or _step_key(c) > _step_key(best[0]):
            best = (c, op, addr)
    if best is None:
        return None
    return {**dict(zip(STEP_KINDS, best[0])), "exchange": best[1], "at": best[2]}


def kernel_name(func: str, name: str):
    """`name<a, b, ...>` for a mangled kernel name that instantiates
    template `name` with int or bool arguments (`6`, `true`), `name` for
    one that is no template; None where func is not `name`."""
    m = re.search(r"\d+" + re.escape(name) + r"(I(?:L[ib]\d+E)+E)?", func)
    if m is None:
        return None
    if m.group(1) is None:
        return name
    args = [v if t == "i" else ("false", "true")[int(v)]
            for t, v in re.findall(r"L([ib])(\d+)E", m.group(1))]
    return f"{name}<{', '.join(args)}>"


def cuobjdump() -> str:
    from ..wfa import cuda_build

    return os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")


def listing(name: str) -> str:
    """The `cuobjdump -sass` listing of library csrc/<name>.cu."""
    from ..wfa import cuda_build

    cuda_build.library(name)
    return subprocess.run([cuobjdump(), "-sass", cuda_build._library_path(name)],
                          capture_output=True, text=True, check=True).stdout


def report(names=None):
    """One dict per loop of every kernel in the libraries (those of
    `names`, csrc/<name>.cu, if given)."""
    from ..wfa import cuda_build

    rows = []
    cuda_build.build_all()
    for name in sorted(names or cuda_build.SIGNATURES):
        funcs, labels = parse(listing(name))
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
