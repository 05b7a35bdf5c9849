"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the engines' counts, each completed job's pool index, start and
seconds, and the card on earlier lines, then one JSON
result line; with --trace 1 the cell's per-layer metrics in place of its
end-to-end ones. Exits non-zero, with no result, where CUDA or the cards
the cell needs are missing, where the program cannot be imported, or
where jax, jaxlib, flax or the JAX package is loaded after the window.

--control band|tiebreak runs one of the check's controls in place of the
program's answers (the reference confined to a fixed band of diagonals,
or with its tie order flipped); --fault plants one of the faults the
check must catch; --readings prints, for one job, the numbers compared
as the program and each control give them, and with --fault as that
fault gives them. None of them is
part of a measured run.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from gpubench import harness, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=harness.CONTROLS)
    ap.add_argument("--fault", choices=harness.FAULTS)
    ap.add_argument("--readings", action="store_true")
    args = ap.parse_args(argv)

    cell = spec.Cell(spec.load_benchmark(ROOT), args.workload, ROOT)
    os.environ.update(harness.cache_dirs(ROOT))
    os.environ["USE_FLAX"] = "0"
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 3
    try:
        import allwave_tpu_torch.cli  # noqa: F401
    except ImportError as e:
        print(f"the program cannot be imported: {e}", file=sys.stderr)
        return 4
    if args.readings:
        harness.readings(cell, args.seed, T_START, faults=[args.fault] if args.fault else [])
        return 0
    result = harness.execute(cell, args.seed, args.seconds, bool(args.trace), T_START,
                             control=args.control, fault=args.fault)
    return 0 if result is not None else 5


if __name__ == "__main__":
    sys.exit(main())
