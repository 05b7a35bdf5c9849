"""One traced window of a cell, read for where its host time and the
device's idle time go inside the program: not part of a measured run.

    python3 gpubench/split_run.py --workload <cell> --seed <n> --seconds <s>

Prints one JSON line: the cell's per-layer metrics (as a `--trace 1` run
of `run.py` reads them, without the check against the reference), the
program's span and counter totals a job, the idle gaps split over the
program's span log (`spanlog.split_idle`) with the log's agreement with
the profiler's clock, the cost of a span with the log off and on, and
two jobs' spans, the harness's and the program's, in order.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from gpubench import harness, spanlog, spec, trace  # noqa: E402


def jobs_in_order(prof, log) -> list:
    """The harness's and the program's spans of the window's second and
    third jobs, in the order they began: (name, chunk, start after the
    job's `cli` range began, length), in us."""
    _, host = trace.profile_events(prof)
    clis = sorted((a, b) for a, b, n in host if n == "cli")[1:3]
    out = []
    for ca, cb in clis:
        rows = [(n, None, a - ca, b - a) for a, b, n in host if ca <= a < cb]
        rows += [(r.name, r.chunk, r.start_ns / 1e3 - ca, (r.end_ns - r.start_ns) / 1e3)
                 for r in log if ca <= r.start_ns / 1e3 < cb]
        out.append(sorted(rows, key=lambda row: row[2]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    cell = spec.Cell(spec.load_benchmark(ROOT), args.workload, ROOT)
    os.environ.update(harness.cache_dirs(ROOT))
    import torch

    from allwave_tpu_torch.utils.telemetry import counters

    if not torch.cuda.is_available():
        print("split_run needs a CUDA device", file=sys.stderr)
        return 3
    run = harness.Run(cell, args.seed, args.seconds, True, T_START)
    try:
        run.setup()
        run.window()
        ctx = run.layer_context(torch.cuda.get_device_name(0))
        metrics = {m["name"]: spec.load_reader(m["name"])(ctx) for m in cell.per_layer}
        snap = counters.snapshot()
        log = counters.span_log()
        jobs = ctx["jobs"]
        line = {
            "cell": cell.name, "seed": args.seed, "jobs": jobs,
            "aln_per_s_traced": run.aln_per_s, "card": harness.power_limit(),
            "metrics": metrics, "span_s": ctx["span_s"],
            "spans_per_job": sum(t["count"] for t in snap["spans"].values()) / jobs,
            "per_job": {n: {"count": t["count"] / jobs, "wall_ms": 1e3 * t["wall_s"] / jobs,
                            "cpu_ms": 1e3 * t["cpu_s"] / jobs}
                        for n, t in snap["spans"].items()},
            "counts_per_job": {k: snap[k] / jobs for k in ("cells", "dispatches", "syncs", "reruns")},
            "split": spanlog.split_idle(run.prof, log),
            "cost": spanlog.span_cost(),
            "jobs_in_order": jobs_in_order(run.prof, log),
        }
        print(json.dumps(line), flush=True)
        return 0
    finally:
        if run.tmp:
            shutil.rmtree(run.tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
