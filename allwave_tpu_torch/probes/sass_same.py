"""Whether two trees compile a kernel to the same machine code.

    python allwave_tpu_torch/probes/sass_same.py --root DIR LIB KERNEL [OTHER_KERNEL]

Builds csrc/LIB.cu in this tree and in DIR (for example an older commit
unpacked with `git archive`), disassembles both with `cuobjdump -sass`
and compares the instructions of KERNEL here with those of OTHER_KERNEL
(default KERNEL) there, as `probes.sass.kernel_name` names them
(`wf_traceback_kernel<false>`, `segment_traceback_kernel`): opcodes,
operands and branch targets, in order. Prints one JSON line: both
kernels' instruction counts, whether the instructions are the same and,
where not, the first that differs. Needs nvcc and cuobjdump, not a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _listing(root: str, lib: str) -> str:
    """LIB's `cuobjdump -sass` listing, built by the tree at root."""
    code = (f"import sys; sys.path.insert(0, {root!r}); "
            "from allwave_tpu_torch.probes import sass; "
            f"sys.stdout.write(sass.listing({lib!r}))")
    return subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                          check=True).stdout


def instructions(root: str, lib: str, kernel: str):
    """The instruction texts of `kernel` in LIB as the tree at root builds it."""
    from allwave_tpu_torch.probes import sass

    base = kernel.split("<")[0]
    funcs, _ = sass.parse(_listing(root, lib))
    found = [f for f in funcs if sass.kernel_name(f, base) == kernel]
    if len(found) != 1:
        raise SystemExit(f"{kernel} in {lib} under {root}: {len(found)} functions match")
    return [text for _, text in funcs[found[0]]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="the other tree")
    ap.add_argument("lib")
    ap.add_argument("kernel")
    ap.add_argument("other_kernel", nargs="?")
    args = ap.parse_args(argv)
    other = args.other_kernel or args.kernel
    a = instructions(HERE, args.lib, args.kernel)
    b = instructions(os.path.abspath(args.root), args.lib, other)
    diff = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if diff is None and len(a) != len(b):
        diff = min(len(a), len(b))
    print(json.dumps({
        "lib": args.lib, "kernel": args.kernel, "other_kernel": other, "root": args.root,
        "instructions": len(a), "other_instructions": len(b), "same": diff is None,
        "first_difference": None if diff is None else
        {"at": diff, "here": a[diff] if diff < len(a) else None,
         "there": b[diff] if diff < len(b) else None},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, HERE)
    sys.exit(main())
