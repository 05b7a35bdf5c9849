"""Cross-engine fuzz of the port on the card (reference:
scripts/fuzz_tpu.py), with its tie-break mutation check.

    python -m allwave_tpu_torch.fuzz [seed] [budget_s] [wf_budget_s]
        [--out PATH] [--device cuda|cpu]

Defaults: seed 7777, 600 s, 300 s, `tests/artifacts/FUZZ_GPU.json`,
cuda. The cases come from `testing/fuzzgen.py`, the reference script's
generator draw for draw.

* Phase 1, the dense engines against the native oracle, for `budget_s`:
  each iteration draws a penalty set and 1-5 pairs of 12-2200 bases and
  runs them through `DenseBandAligner` and `SegmentedDenseAligner`
  (checkpoints every 512 steps) on the device, the native C++ oracle
  (`native.wfa_align_native`) where q + t <= 1400, and, on iterations
  whose pairs are all <= 400 bases, the dense engine on the CPU, whose
  wrappers run the kernels' plain versions. On `--device cpu` the engine
  already is the plain version, and that comparison is not made again.
* Phase 2, the wavefront engine against the segmented one, for
  `wf_budget_s` and at most 400 cases: batches of four 10-100 kb pairs
  with hints under three penalty sets through
  `WavefrontSegmentedAligner` and `SegmentedDenseAligner` on the device.
  A pair the wavefront engine hands back (`DENSE_FALLBACK`) counts as a
  fallback routing, not as a case compared.
* The mutation check: the same tie-rich batch (8 pairs of 20 kb) through
  both long-pair engines in two fresh processes, one with
  `ALLWAVE_TB_FLIP` unset and one with it set to 1 (the wavefront walk
  then prefers I1 over X on a tie). The fuzz detects a wrong tie-break
  bit when the clean process shows no mismatch and the flipped one some.

Scores and CIGARs must be byte-equal and every CIGAR must replay. The
artifact (`--out`) records the card, the git commit (or, where the tree
is no checkout, "unknown") and a digest of the port's sources, the seed,
the generator's revision, both budgets, each phase's counts and the
mutation check's, and a ledger of runs whose cumulative counts take, for
each (seed, revision), the largest run (one seed and revision draw the
same cases). While it runs,
`<out stem>_live.json` beside it holds the counts so far with
`in_progress: true`; a finished run removes it, so one left behind is a
run that was cut. The run exits non-zero when the oracle library is
missing, a kernel fails to build or launch, a phase compares no case, a
case fails, or the mutation check does not detect the flip.
"""

from __future__ import annotations

import argparse
import datetime
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

from . import native
from .core.cigar import validate_cigar
from .probes.step_split import _card
from .testing import fuzzgen
from .wfa.dense_engine import DenseBandAligner
from .wfa.params import resolve_penalties
from .wfa.segmented import SegmentedConfig, SegmentedDenseAligner
from .wfa.wf_segmented import WavefrontSegmentedAligner, WfSegConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "tests", "artifacts", "FUZZ_GPU.json")
#: phase 2 stops at this many cases, as the reference's does
WF_MAX_CASES = 400
#: the mutation check's tie-rich batch: pairs of this length, this many
MUTATION_BATCH = (20_000, 8)
#: pairs longer than this (q + t) are not aligned by the oracle (its
#: single-pair WFA is quadratic in the score)
ORACLE_MAX = 1400
#: iterations whose pairs are all at most this long also run the plain engine
PLAIN_MAX = 400


class FuzzError(RuntimeError):
    """A check the fuzz cannot run (no oracle, a phase with no case)."""


def _same(a, b) -> bool:
    return a[0] == b[0] and np.array_equal(np.asarray(a[1]), np.asarray(b[1]))


def _check(results, pairs, oracle, log, where) -> int:
    """The failures among one batch's results: results[e][i] is engine e's
    answer for pair i (None for a failed pair); every engine must give
    the same, its CIGAR must replay, and, where `oracle(i)` gives one,
    equal the oracle's."""
    fails = 0
    for i, (q, t) in enumerate(pairs):
        rs = [r[i] for r in results]
        if any((r is None) != (rs[0] is None) for r in rs):
            fails += 1
            log(f"{where} pair {i}: NONE MISMATCH {[r is None for r in rs]}")
            continue
        if rs[0] is None:
            continue
        if not all(_same(r, rs[0]) for r in rs[1:]):
            fails += 1
            log(f"{where} pair {i}: ENGINE MISMATCH scores {[r[0] for r in rs]}")
            continue
        try:
            validate_cigar(np.asarray(rs[0][1]), q, t)
        except ValueError as e:
            fails += 1
            log(f"{where} pair {i}: INVALID CIGAR {e}")
            continue
        o = oracle(i)
        if o is not None and not _same(o, rs[0]):
            fails += 1
            log(f"{where} pair {i}: ORACLE MISMATCH {o[0]} vs {rs[0][0]}")
    return fails


class Live:
    """The live-progress file beside the artifact: every update rewrites
    it with `in_progress: true`; `done` removes it."""

    def __init__(self, out: str):
        stem, _ = os.path.splitext(out)
        self.path = stem + "_live.json"
        self.state = {}

    def update(self, **counts):
        self.state.update(counts)
        with open(self.path, "w") as f:
            json.dump({**self.state, "in_progress": True}, f)

    def done(self):
        if os.path.exists(self.path):
            os.remove(self.path)


def phase1(seed: int, budget_s: float, device: str, max_cases=None, log=print, live=None) -> dict:
    """Phase 1 for budget_s seconds or until max_cases cases."""
    import torch

    rng = np.random.RandomState(seed)
    on_cpu = torch.device(device).type == "cpu"
    n = dict(cases=0, failures=0, oracle_compared=0, plain_compared=0, iterations=0)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < budget_s and (max_cases is None or n["cases"] < max_cases):
        params, pairs = fuzzgen.phase1_case(rng)
        pen = resolve_penalties(params)
        dense = DenseBandAligner(pen, device=device)
        seg = SegmentedDenseAligner(pen, SegmentedConfig(ckpt_every=512), dense=dense)
        results = [dense.align_pairs(pairs), seg.align_pairs(pairs)]
        if not on_cpu and all(len(q) <= PLAIN_MAX and len(t) <= PLAIN_MAX for q, t in pairs):
            results.append(DenseBandAligner(pen, device="cpu").align_pairs(pairs))
            n["plain_compared"] += len(pairs)

        def oracle(i):
            q, t = pairs[i]
            if len(q) + len(t) > ORACLE_MAX:
                return None
            o = native.wfa_align_native(q, t, pen)
            if o is None:
                raise FuzzError("the native library has no single-pair WFA")
            n["oracle_compared"] += 1
            return o

        n["failures"] += _check(results, pairs, oracle, log,
                                f"phase 1 iteration {n['iterations']} {params}")
        n["cases"] += len(pairs)
        n["iterations"] += 1
        if live is not None:
            live.update(phase1=n)
    n["seconds"] = time.perf_counter() - t0
    n["plain_engine"] = ("the engine itself (device cpu)" if on_cpu
                         else f"DenseBandAligner on the CPU, pairs <= {PLAIN_MAX} bases")
    return n


def phase2(seed: int, budget_s: float, device: str, max_cases: int = WF_MAX_CASES,
           log=print, live=None) -> dict:
    """Phase 2 for budget_s seconds or until max_cases cases, at
    `fuzzgen.WF_LENGTHS`."""
    rng = np.random.RandomState(seed ^ 0x5A5A)
    engines = {}
    n = dict(cases=0, compared=0, failures=0, fallback_routings=0, batches=0)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < budget_s and n["cases"] < max_cases:
        pi = n["batches"] % len(fuzzgen.WF_PARAMS)
        params = fuzzgen.WF_PARAMS[pi]
        pen = resolve_penalties(params)
        if pi not in engines:
            dense = DenseBandAligner(pen, device=device)
            engines[pi] = (WavefrontSegmentedAligner(pen, WfSegConfig(), dense=dense),
                           SegmentedDenseAligner(pen, SegmentedConfig(), dense=dense))
        wf, sg = engines[pi]
        L, pairs, hints = fuzzgen.phase2_batch(rng, pen.x, fuzzgen.WF_LENGTHS)
        a = wf.align_pairs(pairs, sigma_hint=hints)
        b = sg.align_pairs(pairs, sigma_hint=hints)
        keep = [i for i, r in enumerate(a) if r is not WavefrontSegmentedAligner.DENSE_FALLBACK]
        n["fallback_routings"] += len(pairs) - len(keep)
        n["failures"] += _check([[a[i] for i in keep], [b[i] for i in keep]],
                                [pairs[i] for i in keep], lambda i: None, log,
                                f"phase 2 batch {n['batches']} L={L} {params}")
        n["cases"] += len(pairs)
        n["compared"] += len(keep)
        n["batches"] += 1
        if live is not None:
            live.update(phase2=n)
    n["seconds"] = time.perf_counter() - t0
    return n


def mutation_worker(seed: int, L: int, n_pairs: int, device: str) -> None:
    """One side of the mutation check, in a fresh process: the tie-rich
    batch through the wavefront and the segmented engines under the
    production scores; prints the count of pairs whose bytes differ."""
    from .core.types import AlignmentParams
    from .wfa import wf_segmented

    pen = resolve_penalties(AlignmentParams(0, 5, 8, 2, 24, 1))
    pairs, hints = fuzzgen.tie_rich_batch(np.random.RandomState(seed), L, n_pairs)
    dense = DenseBandAligner(pen, device=device)
    wf = WavefrontSegmentedAligner(pen, WfSegConfig(), dense=dense)
    a = wf.align_pairs(pairs, sigma_hint=hints)
    b = SegmentedDenseAligner(pen, SegmentedConfig(), dense=dense).align_pairs(pairs, sigma_hint=hints)
    walked = [(x, y) for x, y in zip(a, b) if x is not WavefrontSegmentedAligner.DENSE_FALLBACK]
    mismatches = sum(1 for x, y in walked
                     if (x is None) != (y is None) or (x is not None and not _same(x, y)))
    print(json.dumps({"tb_flip": wf_segmented._TB_FLIP, "pairs": len(pairs), "walked": len(walked),
                      "mismatches": mismatches}), flush=True)


def mutation_check(device: str, L: int = 20_000, n_pairs: int = 8, seed: int = 1234,
                   timeout: float = 1200) -> dict:
    """The tie-rich batch in two fresh processes, ALLWAVE_TB_FLIP unset and
    set to 1: each one's mismatches, and whether the flip was detected
    (none clean, some flipped)."""
    code = ("from allwave_tpu_torch.fuzz import mutation_worker; "
            f"mutation_worker({seed}, {L}, {n_pairs}, {device!r})")
    out = {"length": L, "pairs": n_pairs, "seed": seed}
    base = {k: v for k, v in os.environ.items() if k != "ALLWAVE_TB_FLIP"}
    for side, env in (("clean", base), ("flipped", {**base, "ALLWAVE_TB_FLIP": "1"})):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=timeout)
        if r.returncode != 0:
            raise FuzzError(f"the {side} mutation worker failed (exit {r.returncode}):\n"
                            f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
        res = json.loads(r.stdout.strip().splitlines()[-1])
        if res["tb_flip"] != (side == "flipped") or res["walked"] == 0:
            raise FuzzError(f"the {side} mutation worker read the flag wrong or walked no "
                            f"pair: {res}")
        out[f"{side}_mismatches"] = res["mismatches"]
        out[f"{side}_walked"] = res["walked"]
        out[f"{side}_seconds"] = time.perf_counter() - t0
    out["detected"] = out["clean_mismatches"] == 0 and out["flipped_mismatches"] > 0
    return out


def _source_digest() -> str:
    """A digest of the port's sources (.py, .cu, .cuh under the package):
    which code ran, where the run's tree is no git checkout."""
    h = hashlib.sha256()
    pkg = os.path.join(ROOT, "allwave_tpu_torch")
    for d, _, files in sorted(os.walk(pkg)):
        for name in sorted(files):
            if name.endswith((".py", ".cu", ".cuh")):
                path = os.path.join(d, name)
                h.update(os.path.relpath(path, pkg).encode())
                with open(path, "rb") as f:
                    h.update(f.read())
    return h.hexdigest()[:16]


def _git() -> str:
    try:
        r = subprocess.run(["git", "rev-parse", "--short", "HEAD"], cwd=ROOT,
                           capture_output=True, text=True)
    except OSError:
        return "unknown"
    return r.stdout.strip() if r.returncode == 0 else "unknown"


def write_artifact(path: str, rec: dict) -> dict:
    """Append this run to the ledger of the artifact at path and write the
    record there, with cumulative counts over the ledger: for each
    (seed, generator revision) the largest run's cases and failures (a
    rerun of a seed draws the same cases again), summed."""
    runs = []
    if os.path.exists(path):
        with open(path) as f:
            runs = json.load(f).get("runs", [])
    runs.append({k: rec[k] for k in ("seed", "generator_rev", "git", "date", "device")}
                | {"phase1_cases": rec["phase1"]["cases"], "phase2_cases": rec["phase2"]["cases"],
                   "failures": rec["failures"]})
    counted = ("phase1_cases", "phase2_cases", "failures")
    best = {}
    for r in runs:
        key = (r["seed"], r["generator_rev"])
        b = best.get(key, dict.fromkeys(counted, 0))
        best[key] = {k: max(b[k], r[k]) for k in counted}
    rec = {**rec, "runs": runs, "cumulative": {
        "distinct_seed_revisions": len(best),
        **{k: sum(b[k] for b in best.values()) for k in counted},
    }}
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    return rec


def run(seed: int = 7777, budget_s: float = 600.0, wf_budget_s: float = 300.0,
        out: str = DEFAULT_OUT, device: str = "cuda", max_cases=None, log=print) -> dict:
    """Both phases and the mutation check (at `MUTATION_BATCH`); writes
    the artifact and returns its record. With max_cases each phase also
    stops at that many cases (phase 2 at most WF_MAX_CASES). Raises
    FuzzError where a check cannot run (no oracle, a phase with no case
    compared); failures are counted in the record (`ok` is False)."""
    import torch

    if not native.available():
        raise FuzzError("the native oracle library is unavailable: the fuzz cannot compare")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise FuzzError("--device cuda, but torch.cuda.is_available() is False")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    live = Live(out)
    live.update(seed=seed, generator_rev=fuzzgen.GENERATOR_REV)

    def ran(name, p, key):
        log(f"{name}: " + json.dumps(p))
        if p[key] == 0:
            raise FuzzError(f"{name} compared no case (budget too small?): {p}")
        return p

    p1 = ran("phase 1 (dense and segmented engines vs oracle and plain engine)",
             phase1(seed, budget_s, device, max_cases, log, live), "cases")
    p2 = ran("phase 2 (wavefront vs segmented engine)",
             phase2(seed, wf_budget_s, device, min(max_cases or WF_MAX_CASES, WF_MAX_CASES), log,
                    live), "compared")
    mut = mutation_check(device, *MUTATION_BATCH)
    log("mutation check (ALLWAVE_TB_FLIP): " + json.dumps(mut))
    failures = p1["failures"] + p2["failures"]
    rec = {
        "date": datetime.datetime.now().isoformat(timespec="seconds"),
        "git": _git(),
        "sources": _source_digest(),
        "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": torch.cuda.device_count() if dev.type == "cuda" else 0},
        "card": _card() if dev.type == "cuda" else "not measured (device cpu)",
        "seed": seed,
        "generator_rev": fuzzgen.GENERATOR_REV,
        "budget_s": budget_s,
        "wf_budget_s": wf_budget_s,
        "engines": ["DenseBandAligner", "SegmentedDenseAligner(ckpt_every=512)",
                    f"native oracle (q + t <= {ORACLE_MAX})", p1["plain_engine"],
                    "WavefrontSegmentedAligner vs SegmentedDenseAligner (phase 2)"],
        "phase1": {**p1, "cases_per_s": p1["cases"] / max(p1["seconds"], 1e-9)},
        "phase2": {**p2, "cases_per_s": p2["cases"] / max(p2["seconds"], 1e-9),
                   "mix": "10-100 kb at 0.1-1% divergence, a third tandem repeats with "
                          "homopolymer runs, 4 a batch with hints",
                   "cross_check": "segmented dense engine, byte-equal scores and CIGARs"},
        "mutation_check": mut,
        "mutation_check_tb_flip_detected": mut["detected"],
        "failures": failures,
        "ok": failures == 0 and mut["detected"],
    }
    rec = write_artifact(out, rec)
    live.done()
    log(f"artifact: {out}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("seed", nargs="?", type=int, default=7777)
    ap.add_argument("budget_s", nargs="?", type=float, default=600.0)
    ap.add_argument("wf_budget_s", nargs="?", type=float, default=300.0)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        print("device cpu: the engines run the kernels' plain versions; phase 1's plain-engine "
              "comparison is the engine itself", flush=True)
    try:
        rec = run(args.seed, args.budget_s, args.wf_budget_s, args.out, args.device)
    except FuzzError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 2
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
