"""One run of one cell: set-up, a measured window of CLI jobs back to back
(a closed loop with one client), then the check against the plain
reference, and one JSON result line.

A job is one all-vs-all run of the port's command line, called in this
process: `allwave_tpu_torch.cli.main(["-i", fasta, "-o", paf, ...])`,
FASTA in and PAF with CIGARs out. The window cycles through a pool of
distinct jobs drawn from (--seed, job index); its inputs and outputs
live in a fresh directory under TMPDIR, removed at the end.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Dict, List, Optional

import numpy as np

from . import jobs as jobgen
from . import judge, spec, trace
from .leastwork import LeastWork, peaks
from .reference import wfa

#: top-level modules that may not be loaded when the result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "allwave_tpu")
#: the control's band: the reference confined to this many diagonals
#: beyond each pair's [0, k_end] hull, with no escalation
CONTROL_BAND = 8
#: the controls, each the reference in the program's place with one of
#: the configuration's guarantees broken: `band` the exact score,
#: `tiebreak` the canonical CIGAR (an M cell's first insertion ranked
#: ahead of its mismatch)
CONTROLS = ("band", "tiebreak")
#: the program's fault plants, for the checks' own tests and readings
FAULTS = ("drop_half", "alter", "strand", "no_output", "duplicate", "crash")


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole: `allwave_tpu_torch` is not
    `allwave_tpu`."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def cache_dirs(root: str) -> Dict[str, str]:
    """Fixed cache directories inside the checkout for every compiler
    cache a run could fill. The port's own nvcc builds go to
    `allwave_tpu_torch/_build/`, also inside the checkout."""
    base = os.path.join(root, ".gpubench_cache")
    return {
        "TRITON_CACHE_DIR": os.path.join(base, "triton"),
        "TORCH_EXTENSIONS_DIR": os.path.join(base, "torch_extensions"),
        "CUDA_CACHE_PATH": os.path.join(base, "cuda"),
    }


def _alter(result) -> None:
    """The last base of the result's longest match run becomes a
    mismatch, in the CIGAR's runs or in its per-base bytes."""
    if result.cigar_runs is not None:
        ops, lens = (np.array(x) for x in result.cigar_runs)
        i = int(np.argmax(np.where(ops == ord("M"), lens, 0)))
        lens = np.concatenate([lens[:i], [lens[i] - 1, 1], lens[i + 1 :]])
        ops = np.concatenate([ops[:i], [ops[i], ord("X")], ops[i + 1 :]])
        result._cigar_runs = (ops.astype(np.uint8), lens.astype(np.int64))
    elif result.cigar_bytes is not None:
        cig = np.array(result.cigar_bytes, dtype=np.uint8)
        m = np.flatnonzero(cig == ord("M"))
        if m.size:
            cig[m[-1]] = ord("X")
        result._cigar_bytes = cig


def _plant(fault: str):
    """Break the program underneath the window; returns an undo."""
    from allwave_tpu_torch import cli
    from allwave_tpu_torch.engine.pipeline import AllPairAligner

    if fault in ("no_output", "crash"):
        main = cli.main

        def broken_main(argv=None):
            if fault == "crash":
                raise RuntimeError("planted fault: the job dies")
            return 0

        cli.main = broken_main
        return lambda: setattr(cli, "main", main)
    emit = AllPairAligner.__dict__["_emit_chunk"]

    def broken(callback, chunk, revs, aligned, stats):
        def cb(result):
            if fault == "drop_half" and (result.query_idx + result.target_idx) % 2:
                return
            if fault == "strand":
                result.is_reverse = not result.is_reverse
            if fault == "alter":
                _alter(result)
            if fault == "duplicate":
                callback(result)
            callback(result)

        emit.__func__(cb, chunk, revs, aligned, stats)

    AllPairAligner._emit_chunk = staticmethod(broken)
    return lambda: setattr(AllPairAligner, "_emit_chunk", emit)


class Run:
    def __init__(self, cell: spec.Cell, seed: int, seconds: float, traced: bool,
                 t_start: float, device: str = "cuda", control: Optional[str] = None,
                 fault: Optional[str] = None, log=sys.stderr):
        self.p = cell.params
        self.seed = seed
        self.seconds = float(seconds)
        self.traced = traced
        self.t_start = t_start
        self.device = device
        self.control = control
        self.fault = fault
        self.log = log
        self.tmp = None

    def say(self, *a):
        print(*a, file=self.log, flush=True)

    # -- set-up ---------------------------------------------------------------

    def setup(self) -> None:
        import torch

        from allwave_tpu_torch import cli
        from allwave_tpu_torch.wfa import cuda_build

        self.torch = torch
        self.cli = cli
        if self.device == "cuda":
            # every kernel library of the main path, built now (the first
            # run in a checkout pays nvcc) so that none builds in the window
            for name in sorted(cuda_build.SIGNATURES):
                if not name.startswith("probe"):
                    cuda_build.library(name)
        self.tmp = tempfile.mkdtemp(prefix="gpubench-")
        n_pool = int(self.p["pool_jobs"])
        self.pool = []
        for j in range(n_pool + 1):  # the last one is the warm-up job
            seqs = jobgen.make_job(self.p, self.seed, j)
            fa = os.path.join(self.tmp, f"job{j}.fa")
            jobgen.write_fasta(fa, seqs)
            self.pool.append((fa, os.path.join(self.tmp, f"job{j}.paf")))
        warm = self.pool.pop()
        rc = self._job(*warm)
        if rc != 0:
            raise RuntimeError(f"the warm-up job returned {rc}")
        self._sync()
        self.setup_s = time.perf_counter() - self.t_start

    def _sync(self):
        if self.device == "cuda":
            self.torch.cuda.synchronize()

    def _job(self, fasta: str, paf: str) -> int:
        argv = ["-i", fasta, "-o", paf, "-s", self.p["scores"], "-p", self.p["sparsification"],
                "--no-progress"]
        if self.p["orientation"] == "wfa":
            argv.append("--wfa-orientation")
        return self.cli.main(argv)

    # -- the window -----------------------------------------------------------

    def window(self) -> None:
        from allwave_tpu_torch.utils.telemetry import counters

        spans = trace.Spans()
        undo = []
        if self.traced:
            from allwave_tpu_torch.engine.pipeline import AllPairAligner

            for name, attr in trace.WRAPPED:
                orig = AllPairAligner.__dict__[attr]
                if isinstance(orig, staticmethod):
                    wrapped = staticmethod(spans.wrap(name, orig.__func__))
                else:
                    wrapped = spans.wrap(name, orig)
                setattr(AllPairAligner, attr, wrapped)
                undo.append(lambda a=attr, o=orig: setattr(AllPairAligner, a, o))
        if self.fault:
            undo.append(_plant(self.fault))
        run_job = spans.wrap("cli", self._job) if self.traced else self._job
        counters.reset()
        self._reset_counts()

        # a record counts when the CLI's writer turns it into its PAF line
        # at or before the window's close
        from allwave_tpu_torch import cli

        to_paf = cli.alignment_to_paf
        state = {"t_end": float("inf"), "records": 0}

        def counted(result, sequences):
            line = to_paf(result, sequences)
            if time.perf_counter() <= state["t_end"]:
                state["records"] += 1
            return line

        cli.alignment_to_paf = counted
        undo.append(lambda: setattr(cli, "alignment_to_paf", to_paf))

        self.job_s: List[float] = []
        self.completed: List[int] = []
        self.job_at: List[float] = []
        self.runs: List[int] = []
        self.attempted = self.failed = 0
        prof = None
        if self.traced:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device == "cuda" else [])
            prof = profile(activities=acts)
            prof.__enter__()
        gc.collect()
        t0 = self.t0 = time.perf_counter()
        t_end = state["t_end"] = t0 + self.seconds
        i = 0
        try:
            while time.perf_counter() < t_end:
                j = i % len(self.pool)
                fa, paf = self.pool[j]
                a = time.perf_counter()
                try:
                    rc = run_job(fa, paf)
                except Exception:
                    traceback.print_exc(file=self.log)
                    rc = -1
                self._sync()
                b = time.perf_counter()
                self.attempted += 1
                self.runs.append(j)
                if rc != 0:
                    self.failed += 1
                if b <= t_end:
                    self.job_s.append(b - a)
                    self.completed.append(j)
                    self.job_at.append(a - t0)
                i += 1
            self.run_end = time.perf_counter()
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
            for u in reversed(undo):
                u()
        self.records = state["records"]
        self.aln_per_s = self.records / self.seconds
        self.spans = spans
        self.cells_counted = counters.snapshot()["cells"]
        self.prof = prof

    def _reset_counts(self):
        from allwave_tpu_torch.wfa import dense, segmented, wf_segmented

        for c in (dense.forward_launches, dense.traceback_launches, segmented.span_launches,
                  segmented.segment_traceback_launches, wf_segmented.wf_span_launches,
                  wf_segmented.wf_traceback_launches, wf_segmented.wf_stats,
                  segmented.seg_stats):
            c.reset()

    def counts(self) -> dict:
        """The engines' own counts over the window."""
        from allwave_tpu_torch.wfa import dense, segmented, wf_segmented

        def shapes(lc):
            return {"count": lc.count, "shapes": {str(k): v for k, v in lc.shapes.items()}}

        return {
            "forward_launches": shapes(dense.forward_launches),
            "traceback_launches": shapes(dense.traceback_launches),
            "span_launches": shapes(segmented.span_launches),
            "wf_span_launches": shapes(wf_segmented.wf_span_launches),
            "wf_stats.fallbacks": wf_segmented.wf_stats.fallbacks,
            "seg_stats.overflow_reruns": segmented.seg_stats.overflow_reruns,
            "dp_cells_counted": self.cells_counted,
        }

    # -- per-layer ------------------------------------------------------------

    def layer_context(self, kind: str) -> dict:
        """What the per-layer readers read, over the traced window's jobs
        (every job of a traced window runs to its end)."""
        pen = wfa.penalties(self.p["scores"])
        work = {}
        for j in set(self.runs):
            lw = LeastWork(pen)
            for rec in judge.read_paf(self.pool[j][1]):
                lw.add_record(rec)
            work[j] = lw
        cells = sum(work[j].cells for j in self.runs)
        pk = peaks(kind)
        least_s = sum(work[j].least_seconds(pk) for j in self.runs) if pk else 0.0
        red = trace.reduce_profile(self.prof) if self.prof is not None else None
        return {
            "jobs": len(self.runs),
            "span_s": dict(self.spans.seconds),
            "cells_counted": self.cells_counted,
            "least_cells": cells,
            "least_s": least_s,
            "busy_s": red["busy_s"] if red else 0.0,
            "window_s": red["window_s"] if red else 0.0,
            "profile": red,
        }

    # -- the check ------------------------------------------------------------

    def check(self) -> Dict[str, int]:
        """Counts of disagreement with the reference over the checked jobs."""
        chk = self.p["check"]
        rng = np.random.RandomState(jobgen.job_seed(self.seed, 0, 7))
        done = sorted(set(self.completed)) or sorted(set(self.runs))
        picked = rng.choice(done, size=min(int(chk["jobs"]), len(done)), replace=False).tolist() if done else []
        total = {k: 0 for k in judge.LIMITS}
        total["jobs_failed"] = self.failed
        dev = self.device
        for j in picked:
            fa, paf = self.pool[j]
            seqs = jobgen.read_fasta(fa)
            jc = judge.JobCheck(seqs, self.p, int(chk["pairs"]), rng, judge.read_paf(paf))
            expected = jc.align(dev, int(chk["batch"]))
            lines = None
            if self.control:
                lines = control_lines(jc, self.control, dev, int(chk["batch"]))
            for k, v in jc.counts(expected, lines).items():
                total[k] += v
        if not picked:
            total["pairs_missing"] += 1  # no job finished: nothing came
        return total


def control_lines(jc: judge.JobCheck, control: str, device: str, batch: int) -> Dict[tuple, str]:
    """The sampled pairs' PAF lines as the named control answers them."""
    if control == "band":
        got = jc.align(device, batch, band=CONTROL_BAND)
    else:
        got = jc.align(device, batch, order=wfa.FLIPPED_M)
    return {k: v[1] for k, v in got.items()}


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def execute(cell: spec.Cell, seed: int, seconds: float, traced: bool, t_start: float,
            device: str = "cuda", control: Optional[str] = None, fault: Optional[str] = None,
            out=sys.stdout, log=sys.stderr) -> Optional[dict]:
    """Set-up, window, check; prints the earlier lines and the result line
    to `out` and returns the result, or None where no result may be
    printed."""
    run = Run(cell, seed, seconds, traced, t_start, device, control, fault, log)
    try:
        run.setup()
        run.window()
        torch = run.torch
        if device == "cuda":
            kind = torch.cuda.get_device_name(0)
            peak_mem = int(max(torch.cuda.max_memory_allocated(i) for i in range(cell.chips)))
        else:
            kind, peak_mem = "cpu", 0
        bad = forbidden_modules()
        if bad:
            run.say("forbidden modules loaded after the window: " + ", ".join(bad))
            return None
        counts = run.counts()
        metrics = {}
        layer = None
        if traced:
            layer = run.layer_context(kind)
            for m in cell.per_layer:
                v = spec.load_reader(m["name"])(layer)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            values = {"aln_per_s": run.aln_per_s, "setup_s": run.setup_s}
            if run.job_s:
                values["job_s_p90"] = trace.percentile(run.job_s, 90)
            for m in cell.end_to_end:
                if m["name"] in values:
                    metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
            if "job_s_p90" in metrics and len(run.job_s) < 100:
                run.say(f"warning: job_s_p90 over {len(run.job_s)} jobs, under 100")
        print(json.dumps({"counts": counts, "jobs_completed": len(run.job_s),
                          "jobs": [[j, round(a, 4), round(s, 5)]
                                   for j, a, s in zip(run.completed, run.job_at, run.job_s)],
                          "jobs_run": len(run.runs), "records_in_window": run.records,
                          "window_end_s": run.run_end - run.t0,
                          "card": power_limit() if device == "cuda" else "cpu",
                          "memory_peak_bytes": peak_mem}), file=out, flush=True)
        if layer is not None and layer["profile"] is not None:
            red = layer["profile"]
            print(json.dumps({"idle_by_label": red["idle_by_label"], "device_events": red["n_device_events"],
                              "span_s": layer["span_s"], "least_cells": layer["least_cells"],
                              "least_s": layer["least_s"], "jobs_traced": layer["jobs"]}),
                  file=out, flush=True)
        run.prof = None
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        checks = run.check()
        run.say(f"the check took {time.perf_counter() - t_check:.1f} s")
        correct = all(checks[k] <= judge.LIMITS[k] for k in judge.LIMITS)
        dev = {"platform": "gpu" if device == "cuda" else "cpu", "kind": kind, "count": cell.chips,
               "memory_peak_bytes": peak_mem}
        result = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
                  "metrics": metrics, "device": dev}
        if traced and layer is not None:
            dev["busy_s"] = layer["busy_s"]
            dev["window_s"] = layer["window_s"]
            if layer["profile"] is not None:
                red = layer["profile"]
                result["breakdown"] = {"device_ops": [[n, s] for n, s in red["device_ops"][:10]],
                                       "idle_gaps": [[n, s] for n, s in red["idle_gaps"][:10]]}
        result["checks"] = {k: {"value": checks[k], "limit": judge.LIMITS[k]} for k in judge.LIMITS}
        bad = forbidden_modules()
        if bad:
            run.say("forbidden modules loaded: " + ", ".join(bad))
            return None
        for k in judge.LIMITS:
            run.say(f"check {k} {checks[k]} limit {judge.LIMITS[k]}")
        print(json.dumps(result), file=out, flush=True)
        return result
    finally:
        if run.tmp:
            shutil.rmtree(run.tmp, ignore_errors=True)


def readings(cell: spec.Cell, seed: int, t_start: float, device: str = "cuda",
             faults=FAULTS, out=sys.stdout, log=sys.stderr) -> dict:
    """The readings that the check's limits are set from, for one seed in
    one process: the numbers of one job of the cell as the program
    answers it, with each control in the program's place, and with each
    planted fault."""
    run = Run(cell, seed, 0.0, False, t_start, device, log=log)
    try:
        run.setup()
        chk = run.p["check"]
        fa, paf = run.pool[0]
        rng = np.random.RandomState(jobgen.job_seed(seed, 0, 7))
        rc = run._job(fa, paf)
        jc = judge.JobCheck(jobgen.read_fasta(fa), run.p, int(chk["pairs"]), rng, judge.read_paf(paf))
        t = time.perf_counter()
        expected, flipped = jc.align_orders(device, int(chk["batch"]), (wfa.TIEBREAK_M, wfa.FLIPPED_M))
        res = {"reference_s": time.perf_counter() - t,
               "program": {**jc.counts(expected), "jobs_failed": int(rc != 0)}}
        res["control_tiebreak"] = {**jc.counts(expected, {k: v[1] for k, v in flipped.items()}),
                                   "jobs_failed": 0}
        lines = control_lines(jc, "band", device, int(chk["batch"]))
        res["control_band"] = {**jc.counts(expected, lines), "jobs_failed": 0}
        for fault in faults:
            undo = _plant(fault)
            try:
                rc = run._job(fa, paf + "." + fault)
            except Exception as e:  # the planted crash
                run.say(f"{fault}: {e}")
                rc = -1
            finally:
                undo()
            got = jc.with_records(judge.read_paf(paf + "." + fault))
            res[fault] = {**got.counts(expected), "jobs_failed": int(rc != 0)}
        line = {"cell": cell.name, "seed": seed, "pairs": int(jc.pairs.shape[0]),
                "sampled": len(jc.sample), "readings": res}
        print(json.dumps(line), file=out, flush=True)
        return line
    finally:
        if run.tmp:
            shutil.rmtree(run.tmp, ignore_errors=True)
