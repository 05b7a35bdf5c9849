"""Check every probe kernel against its plain version, and time it.

`python -m allwave_tpu_torch.probes` runs `main`; chip_smoke.py phase 16
calls `check_all` and `time_all`. On the card, each probe's kernel is
held to its plain version with tolerance 0 (at a reduced shape, and at
the experiment's own shape where the plain version is quick), then
timed at the experiment's own shape: CUDA events around REPS calls
after one warm-up, the mean. Each timed line carries the work the call
needs (int32 operations and bytes, from its inputs) and its bound, the
least time the card could take for that work: the larger of the
operations over the card's int32 rate (SMs x 64 INT32 lanes x
the max SM clock that nvidia-smi reports) and the bytes over the HBM
rate (3.35 TB/s). The operations are the least instruction slots of the ALU
pipe, whose lanes that rate counts: sm_90 instructions with their fused
forms, the adds that can run on the FMA pipe as IMAD set beside them
(kexp6.STEP_OPS and kexp2.ops_per_step say how). The step probes'
lines (x4-x6) also carry a chain bound where one is given
(`step_chains`): the steps times one step's dependent chain, read off
the build's machine code (`sass.step_chain`: the neighbour exchange, the
dependent ALU and DPX instructions, the block's barrier), at the
latencies `latency.py` measures on the card. No serial step on 8 or 16
SMs comes near the operations bound; the chain share is the yardstick.

With `device="cpu"` nothing is checked (the wrappers run the plain
versions for CPU tensors) and the plain versions are timed at the
reduced shapes with the host clock.
"""

from __future__ import annotations

import subprocess
import time
from dataclasses import dataclass

import numpy as np
import torch

from . import kexp as K1
from . import kexp2 as K2
from . import kexp3 as K3
from . import kexp6 as K6
from . import kexp7 as K7
from . import kexp8 as K8

PROBES = ("kexp", "kexp2", "kexp3", "kexp6", "kexp7", "kexp8")
ROW = {"kexp": "x1", "kexp2": "x2", "kexp3": "x3", "kexp6": "x4", "kexp7": "x5", "kexp8": "x6"}
SCORES = "0,5,8,2,24,1"
HBM_BYTES_S = 3.35e12
INT32_LANES_PER_SM = 64

#: (TB, K, W, NSTEPS) of the step probes (x4-x6) at the reduced shape
STEP_REDUCED = (8, 256, 128, 256)
#: x1: (B, L, l_pad, K) of the reduced shape, kexp.py main()'s (its
#: microbench batch: lengths 500-1000 at 4% substitutions) and the
#: headline's band round (bench.py's 128 x 1 kb: B = 4096, K = 192)
X1_REDUCED = (64, 200, 256, 128)
X1_KEXP = (2048, 1000, 1024, 128)
X1_HEADLINE = (4096, 1000, 1024, 192)
#: x2/x3: the chain's steps at the reduced shape (kexp: STEPS x TILES)
OPS_REDUCED_STEPS = 64
#: the x2 case also held against its plain version at the full 65,536
#: steps (the one whose plain version is quick on the card)
X2_FULL_CASE = "0r 8a 0s 0m"
#: the x3 case the kernels line of chip_smoke.py reports: x2's adds with
#: 8 rolls a step
X3_ROLL_CASE = "lane  (64,128) 8r u1"
#: blocks a probe_ops call runs to fill the card: this many per SM (one
#: block of 8 warps already keeps an SM's INT32 lanes busy)
FILL_PER_SM = 1
#: timed calls after the warm-up
REPS = 5


class ProbeMismatch(AssertionError):
    pass


@dataclass
class StepChains:
    """One step's dependent chain for each kernel of csrc/probe_step.cu
    ({kernel: {"shfl", "lds", "alu", "bar", ...}}, `sass.step_chain`)
    and the card's latencies ({"lds_ns", "alu_ns", "shfl_ns", "bar_ns":
    {block threads: ns}})."""

    chains: dict
    latency: dict

    def ns(self, kernel: str, k: int) -> float:
        """One step's chain in ns for `kernel` at band K."""
        c, lat = self.chains[kernel], self.latency
        return (c["shfl"] * lat["shfl_ns"] + c["lds"] * lat["lds_ns"] + c["alu"] * lat["alu_ns"]
                + c["bar"] * lat["bar_ns"][K6.block_threads(kernel, k)])


def step_kernel_chains() -> dict:
    """{kernel: step chain or None} for every kernel of
    csrc/probe_step.cu, read off this build's machine code."""
    from . import sass

    funcs, labels = sass.parse(sass.listing("probe_step"))
    out = {}
    for func, insns in funcs.items():
        name = sass.kernel_name(func, "step_regs_kernel") or sass.kernel_name(func, K6.SMEM_KERNEL)
        if name is not None:
            out[name] = sass.step_chain(insns, labels[func])
    return out


def step_chains(device, chains=None) -> StepChains:
    """The step probes' chains (`step_kernel_chains`, unless given) and
    the latencies they are made of, measured on `device` at the block
    sizes the probes' shapes run."""
    from .latency import step_latency_ns, walk_latency_ns

    chains = step_kernel_chains() if chains is None else chains
    missing = sorted(k for k, c in chains.items() if c is None)
    if missing:
        raise ProbeMismatch(f"no step chain in the machine code of {missing}")
    sizes = {K6.REG_THREADS} | {K6.block_threads(K6.SMEM_KERNEL, k)
                                for k in (STEP_REDUCED[1], K6.K)}
    return StepChains(chains, {**walk_latency_ns(device), **step_latency_ns(device, sizes)})


# ---------------------------------------------------------------- helpers


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return _smi("name,power.limit")


def _smi(query: str, units: bool = True) -> str:
    fmt = "csv,noheader" if units else "csv,noheader,nounits"
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0].strip()


def int32_ops_s(device) -> float:
    """The card's int32 rate: SMs x 64 INT32 lanes x max SM clock."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * INT32_LANES_PER_SM * float(_smi("clocks.max.sm", units=False)) * 1e6


def bound(ops: int, nbytes: int, ops_s: float):
    """(least ms, "operations" or "bytes") for a call's work."""
    t_ops, t_bytes = ops / ops_s * 1e3, nbytes / HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def timed(fn, device, reps: int):
    """(ms, host_ms): the mean milliseconds of fn() over reps calls after
    one warm-up, by CUDA events on the card (the host clock on the CPU),
    and the host's mean milliseconds to launch one call. Where host_ms
    reaches ms, the host, not the card, sets the pace."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    if device.type != "cuda":
        return host_ms, host_ms
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps, host_ms


def timed_once(fn, device):
    """(fn(), its milliseconds): CUDA events on the card."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        return fn(), (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize(device)
    return out, start.elapsed_time(end)


def _err(a, b) -> int:
    """Largest absolute difference of two equal-shape tensors."""
    if a is None or b is None:
        if a is not b:
            raise ProbeMismatch("one output is missing")
        return 0
    if tuple(a.shape) != tuple(b.shape):
        raise ProbeMismatch(f"shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    if torch.equal(a, b):
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def _record(out: list, probe: str, variant: str, shape: dict, err: int, plain_ms=None) -> None:
    r = {"probe": ROW[probe], "file": probe, "variant": variant, **shape, "max_abs_err": err,
         "tolerance": 0}
    if plain_ms is not None:
        r["plain_ms"] = plain_ms
    out.append(r)
    if err:
        raise ProbeMismatch(f"{probe} {variant} at {shape}: kernel differs from plain by {err}")


def _t(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _step_inputs(device, tb: int, k: int):
    return tuple(_t(a, device) for a in K6.inputs(tb, k))


def _x1_inputs(device, B: int, L: int, l_pad: int, seed: int = 23):
    from ..testing.batches import random_batch

    return tuple(_t(a, device) for a in random_batch(np.random.RandomState(seed), B, L, l_pad, 0.04))


def _pen():
    from ..core.scores import parse_scores
    from ..wfa.params import resolve_penalties

    return resolve_penalties(parse_scores(SCORES))


# ----------------------------------------------------------------- checks


def check_x4(device, tb, k, w, nsteps, out):
    args = _step_inputs(device, tb, k)
    v0, plain_ms = timed_once(lambda: K6.run_ref("v0", *args, nsteps, w), device)
    refs = {"v0": v0, **K6.carried_refs(*args, nsteps, w)}
    shape = {"TB": tb, "K": k, "W": w, "n_steps": nsteps}
    for v in K6.VARIANTS:
        _record(out, "kexp6", v, shape, _err(K6.sweep(v, *args, nsteps, w), refs[v]),
                plain_ms if v == "v0" else None)


def check_x5(device, tb, k, w, nsteps, out):
    args = _step_inputs(device, tb, k)
    refs, plain_ms = timed_once(lambda: K7.refs(*args, nsteps, w), device)
    x4 = K6.sweep("v0", *args, nsteps, w)
    shape = {"TB": tb, "K": k, "W": w, "n_steps": nsteps}
    for v in K7.VARIANTS:
        s, dummy = K7.run(v, *args, nsteps, w)
        err = max(_err(s, refs[v][0]), _err(dummy, refs[v][1]), _err(s, x4))
        _record(out, "kexp7", v, shape, err, plain_ms if v == "g0" else None)


def check_x6(device, tb, k, w, nsteps, out):
    args = _step_inputs(device, tb, k)
    refs, plain_ms = timed_once(lambda: K8.refs(*args, nsteps, w), device)
    shape = {"TB": tb, "K": k, "W": w, "n_steps": nsteps}
    for m in K8.MODES:
        s, planes = K8.run(m, *args, nsteps, w)
        rs, rplanes = refs[m]
        if len(planes) != len(rplanes):
            raise ProbeMismatch(f"kexp8 {m}: {len(planes)} planes, plain has {len(rplanes)}")
        err = max([_err(s, rs)] + [_err(a, b) for a, b in zip(planes, rplanes)])
        _record(out, "kexp8", m, shape, err, plain_ms if m == "p3" else None)


def check_ops(device, steps: int, out, cases2=None, cases3=None, copies: int = 2):
    """x2 and x3: every copy of each case's kernel output against the
    plain chain of `steps` steps."""
    x = _t(K2.inputs(), device)
    for name, r, a, s, m in K2.CASES:
        if cases2 is not None and name not in cases2:
            continue
        ref, plain_ms = timed_once(lambda: K2.chain_ref(x, steps, r, a, s, m), device)
        got = K2.chain(x, steps, r, a, s, m, copies=copies)
        _record(out, "kexp2", name, {"shape": list(x.shape), "n_steps": steps, "copies": copies},
                max(_err(c, ref) for c in got), plain_ms)
    xs = {n: _t(v, device) for n, v in K3.inputs().items()}
    for name, shape, axis, r, a, u in K3.CASES:
        if cases3 is not None and name not in cases3:
            continue
        x = xs[name]
        ref, plain_ms = timed_once(lambda: K2.chain_ref(x, steps, r, a, 0, 0, axis), device)
        got = K2.chain(x, steps, r, a, 0, 0, axis=axis, unroll=u, copies=copies)
        _record(out, "kexp3", name, {"shape": list(shape), "n_steps": steps, "copies": copies},
                max(_err(c, ref) for c in got), plain_ms)


def check_x1(device, B, L, l_pad, K, out, run_cap: int = 128, edge: bool = False):
    """x1: scores and certificates against the engine's kernel
    (dense.dense_forward), and scores, certificates and planes against
    the plain version; the traceback kernel over each variant's plane
    gives the bytes it gives over dense_forward's. With `edge`, the
    batch starts with testing.batches.edge_batch's pairs (qlen = tlen =
    l_pad, |k_end| = K - 1 both ways, an infeasible pair)."""
    from ..testing.batches import edge_batch
    from ..wfa import dense as D

    pen = _pen()
    if edge:
        qs, ts, ql, tl = (_t(a, device) for a in edge_batch(np.random.RandomState(K), B, l_pad, K))
    else:
        qs, ts, ql, tl = _x1_inputs(device, B, L, l_pad)
    s_d, c_d, p_d = D.dense_forward(qs, ts, ql, tl, pen, K, l_pad)
    tb_d = D.dense_traceback(p_d, s_d, c_d, ql, tl, run_cap)
    del p_d
    ref, plain_ms = timed_once(lambda: K1.forward_ref("V1", qs, ts, ql, tl, pen, K, l_pad), device)
    shape = {"B": B, "l_pad": l_pad, "K": K, **({"edge": True} if edge else {})}
    for v in K1.VARIANTS:
        s, c, p = K1.forward(v, qs, ts, ql, tl, pen, K, l_pad)
        err = max(_err(s, s_d), _err(c.to(torch.int32), c_d.to(torch.int32)), _err(s, ref[0]),
                  _err(c.to(torch.int32), ref[1].to(torch.int32)))
        if p is not None:
            err = max(err, _err(p, ref[2]),
                      _err(D.dense_traceback(p, s, c, ql, tl, run_cap), tb_d))
        _record(out, "kexp", v, shape, err, plain_ms if v == "V1" else None)


def check_all(device, only=PROBES, full: bool = True):
    """Every probe kernel against its plain version at the reduced
    shape and, with `full`, at the experiment's own shape where the
    plain version is quick. Returns the result dicts; raises
    ProbeMismatch on the first difference."""
    out = []
    tb, k, w, n = STEP_REDUCED
    if "kexp6" in only:
        check_x4(device, tb, k, w, n, out)
        if full:
            check_x4(device, K6.TB, K6.K, K6.W, K6.NSTEPS, out)
    if "kexp7" in only:
        check_x5(device, tb, k, w, n, out)
        if full:
            check_x5(device, K7.TB, K7.K, K7.W, K7.NSTEPS, out)
    if "kexp8" in only:
        check_x6(device, tb, k, w, n, out)
        if full:
            check_x6(device, K8.TB, K8.K, K8.W, K8.NSTEPS, out)
    if "kexp2" in only or "kexp3" in only:
        check_ops(device, OPS_REDUCED_STEPS, out,
                  None if "kexp2" in only else (), None if "kexp3" in only else ())
        if full and "kexp2" in only:
            check_ops(device, K2.STEPS * K2.TILES, out, (X2_FULL_CASE,), (), copies=1)
    if "kexp" in only:
        check_x1(device, *X1_REDUCED, out)
        if full:
            check_x1(device, *X1_KEXP, out)
            check_x1(device, *X1_HEADLINE, out)
    return out


# ----------------------------------------------------------------- timing


def _line(probe, variant, label, shape, times, n_steps, work, ops_s, launches):
    (ms, host_ms), (ops, nbytes) = times, work
    r = {"probe": ROW[probe], "file": probe, "variant": variant, "label": label, **shape,
         "ms": ms, "host_ms": host_ms, "ns_per_step": ms * 1e6 / n_steps,
         "launches_per_call": launches, "int32_ops": ops, "bytes": nbytes}
    if ops_s:
        b_ms, by = bound(ops, nbytes, ops_s)
        r.update(bound_ms=b_ms, bound_by=by, share_of_bound=b_ms / ms)
    return r


def _step_line(r, kernel: str, chains):
    """A step probe's line with its kernel and, given `chains`, its chain
    bound and share."""
    r["kernel"] = kernel
    if chains is not None:
        r["chain_bound_ms"] = r["n_steps"] * chains.ns(kernel, r["K"]) * 1e-6
        r["chain_share"] = r["chain_bound_ms"] / r["ms"]
    return r


def time_all(device, only=PROBES, reps: int = REPS, full: bool = True, ops_s=None,
             latency: bool = True, chains=None):
    """Every variant of every probe timed at the experiment's own shape
    (full) or at the reduced one; x2 and x3 on the filled card and, with
    `latency`, as one copy too; the step probes with their chain bounds
    where `chains` (a StepChains) is given. Returns the result dicts."""
    out = []
    tb, k, w, n = (K6.TB, K6.K, K6.W, K6.NSTEPS) if full else STEP_REDUCED
    if "kexp6" in only:
        args = _step_inputs(device, tb, k)
        shape = {"TB": tb, "K": k, "W": w, "n_steps": n}
        for v, spec in K6.VARIANTS.items():
            times = timed(lambda: K6.sweep(v, *args, n, w), device, reps)
            out.append(_step_line(_line("kexp6", v, spec.label, shape, times, n,
                                        K6.work(v, tb, k, n), ops_s, 1),
                                  K6.kernel_for(v, k), chains))
    if "kexp7" in only:
        tb, k, w, n = (K7.TB, K7.K, K7.W, K7.NSTEPS) if full else STEP_REDUCED
        args = _step_inputs(device, tb, k)
        shape = {"TB": tb, "K": k, "W": w, "n_steps": n}
        for v, spec in K7.VARIANTS.items():
            times = timed(lambda: K7.run(v, *args, n, w), device, reps)
            r = _line("kexp7", v, spec.label, shape, times, n, K7.work(v, tb, k, n), ops_s,
                      K7.launches(v))
            r["us_per_chunk"] = r["ms"] * 1e3 / spec.nd
            out.append(_step_line(r, K7.kernel_for(v, k), chains))
    if "kexp8" in only:
        tb, k, w, n = (K8.TB, K8.K, K8.W, K8.NSTEPS) if full else STEP_REDUCED
        args = _step_inputs(device, tb, k)
        shape = {"TB": tb, "K": k, "W": w, "n_steps": n}
        for m in K8.MODES:
            times = timed(lambda: K8.run(m, *args, n, w), device, reps)
            out.append(_step_line(_line("kexp8", m, K8.LABELS[m], shape, times, n,
                                        K8.work(m, tb, k, n), ops_s, 1),
                                  K8.kernel_for(m, k), chains))
    steps = K2.STEPS * K2.TILES if full else OPS_REDUCED_STEPS
    # latency (one copy) and throughput (the card filled); one on the CPU
    copies_list = (1,)
    if device.type == "cuda":
        fill = FILL_PER_SM * torch.cuda.get_device_properties(device).multi_processor_count
        copies_list = (1, fill) if latency else (fill,)
    if "kexp2" in only:
        x = _t(K2.inputs(), device)
        for name, r, a, s, m in K2.CASES:
            for copies in copies_list:
                times = timed(lambda: K2.chain(x, steps, r, a, s, m, copies=copies), device, reps)
                line = _line("kexp2", name, name, {"shape": list(x.shape), "copies": copies}, times,
                             steps, K2.work(x.shape, steps, r, a, s, m, copies), ops_s, 1)
                line["ns_per_step_tile"] = line.pop("ns_per_step")
                out.append(line)
    if "kexp3" in only:
        xs = {nm: _t(v, device) for nm, v in K3.inputs().items()}
        for name, shape, axis, r, a, u in K3.CASES:
            for copies in copies_list:
                times = timed(lambda: K2.chain(xs[name], steps, r, a, 0, 0, axis=axis, unroll=u,
                                            copies=copies), device, reps)
                line = _line("kexp3", name, name, {"shape": list(shape), "copies": copies}, times,
                             steps, K3.work(name, steps, copies), ops_s, 1)
                line["ns_per_step_tile"] = line.pop("ns_per_step")
                out.append(line)
    if "kexp" in only:
        from ..wfa import dense as D

        pen = _pen()
        shapes = (X1_KEXP, X1_HEADLINE) if full else (X1_REDUCED,)
        for B, L, l_pad, K in shapes:
            qs, ts, ql, tl = _x1_inputs(device, B, L, l_pad)
            shape = {"B": B, "l_pad": l_pad, "K": K}
            if device.type == "cuda":
                # V0: the engine's kernel (csrc/dense_forward.cu), the baseline
                times = timed(lambda: D.dense_forward(qs, ts, ql, tl, pen, K, l_pad), device, reps)
                out.append(_line("kexp", "V0", "V0 dense_forward.cu (engine)", shape, times,
                                 2 * l_pad, K1.work("V1", ql.cpu(), tl.cpu(), K, l_pad), ops_s, 1))
            for v, (label, _, _) in K1.VARIANTS.items():
                times = timed(lambda: K1.forward(v, qs, ts, ql, tl, pen, K, l_pad), device, reps)
                out.append(_line("kexp", v, label, shape, times, 2 * l_pad,
                                 K1.work(v, ql.cpu(), tl.cpu(), K, l_pad), ops_s, 1))
    return out


# ------------------------------------------------------------------- main


def _fmt(r) -> str:
    shape = " ".join(f"{k}={r[k]}" for k in ("TB", "K", "W", "B", "l_pad", "shape", "copies")
                     if k in r)
    per = (f"{r['ns_per_step_tile']:9.2f} ns/step-tile" if "ns_per_step_tile" in r
           else f"{r['ns_per_step']:9.1f} ns/step")
    extra = f" {r['us_per_chunk']:8.2f} us/chunk" if "us_per_chunk" in r else ""
    bnd = (f"  bound {r['bound_ms']:.4f} ms ({r['bound_by']}, share {r['share_of_bound']:.3f})"
           if "bound_ms" in r else "")
    if "chain_bound_ms" in r:
        bnd += f"  chain {r['chain_bound_ms']:.4f} ms (share {r['chain_share']:.3f})"
    return (f"{r['probe']} {r['label']:40s} [{shape}] {r['ms']:10.3f} ms {per}{extra}"
            f"  host {r['host_ms']:.3f} ms{bnd}")


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(prog="python -m allwave_tpu_torch.probes",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=",".join(PROBES),
                    help=f"comma-separated probes to run, of {','.join(PROBES)}")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default): check and time the kernels on the card; cpu: "
                         "time the plain versions at the reduced shapes")
    args = ap.parse_args(argv)
    only = tuple(p.strip() for p in args.only.split(",") if p.strip())
    unknown = set(only) - set(PROBES)
    if unknown:
        ap.error(f"unknown probes: {sorted(unknown)}")
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the probes time kernels on the card "
                               "(--device cpu times the plain versions instead)")
        device = torch.device("cuda", 0)
        for r in check_all(device, only):
            print("check " + json.dumps(r), flush=True)
        steps = {"kexp6", "kexp7", "kexp8"} & set(only)
        chains = step_chains(device) if steps else None
        if chains is not None:
            print("step chains " + json.dumps({"chains": chains.chains, "latency": chains.latency}),
                  flush=True)
        results = time_all(device, only, full=True, ops_s=int32_ops_s(device), chains=chains)
    else:
        device = torch.device("cpu")
        results = time_all(device, only, full=False)
    for r in results:
        print(_fmt(r), flush=True)
    print(card() if device.type == "cuda" else "cpu: plain versions, host clock")
    return 0
