"""x4: the dense engines' anti-diagonal step, score only.

Port of scripts/experiments/kexp6.py (`step_math`; `kernel_v0`,
`make_v_carry`, `kernel_v4`; the pallas_call in `run`): TB independent
problems of K diagonals each run NSTEPS steps of the 5-band two-piece
Gotoh recurrence with the experiment's fixed penalties, and two int32
base streams of W + K lanes rotate by one lane a step (the query stream
right, the target stream left). The result is the S band after the
last step. Rolls of the bands are shifts with INF entering at lane 0
and lane K-1, as `step_math` masks them.

The step is defined once here and shared by x5 (`kexp7`) and x6
(`kexp8`): `step_terms` is the recurrence, `step_ref` one step of the
plain version, `launch_smem` the shared-memory kernel of
csrc/probe_step.cu that all three drive.

Variants, and what each means on Hopper (csrc/probe_step.cu):

* v0: the state in scratch, 2 steps a loop turn. Bands in shared
  memory, double-buffered, one `__syncthreads` a step: how
  csrc/dense_forward.cu and csrc/dense_span.cu work.
* v1, v2, v3: the state carried as values, unroll 2, 4, 8. Each thread
  keeps K/256 adjacent lanes of all five bands in registers; the
  neighbours at k-1 and k+1 come by `__shfl_up_sync`/`__shfl_down_sync`
  and, at warp edges, from a double-buffered halo in shared memory
  (one barrier a step). The step loop is unrolled 2, 4 or 8 times.
* v4: v1 with two problems interleaved in one block (the second starts
  from s_in + 1); the result is the sum of their S bands.

Unwritten stream lanes. The experiment writes only part of its stream
scratch: `kernel_v0` (and kexp7.py, kexp8.py) fill lanes W.. of the
query stream and lanes ..K of the target stream, and the rolls bring
the unwritten lanes into the band. On the CPU, Pallas interpret mode
fills unwritten int32 scratch with -2**31, deterministically; the
value-carried variants start from zeros (`make_v_carry`: jnp.zeros).
So v0 and v1 give different results, and the port takes the fill as
an argument: FILL_SCRATCH (-2**31) for the scratch variants (v0, every
x5 and x6 variant) and 0 for the value-carried ones (v1-v4).

Arithmetic wraps as the JAX code's does (the kernels add in unsigned
32-bit; torch's int32 adds wrap).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..wfa.dense import LaunchCount, _check_cuda

INF = (1 << 30) - 1
TB, K, W = 8, 1536, 256
NSTEPS = 4096
O1E1, E1, O2E2, E2, X = 10, 2, 25, 1, 5
FILL_SCRATCH = -(2**31)

#: int32 instruction slots one active lane-step of the score-only recurrence
#: needs at least. Its sm_90 instructions, with the fused forms the
#: card has (DPX VIADDMNMX, min(a + b, c); VIMNMX3, min(a, b, c); ptxas
#: emits both by itself): for each of the four gap states the open
#: term's add and one VIADDMNMX for the extend term and the min (8); the
#: substitution cost's compare and select (2); the least gap state, a
#: VIMNMX3 and a min (2); S = min(S + cost, that), one VIADDMNMX (1):
#: 13. The four adds can also run as IMAD on the FMA pipe, beside the
#: ALU pipe whose 64 lanes an SM the int32 rate counts; the other 9 run
#: on the ALU pipe only, so the least is max(9, 13 / 2) = 9 ALU slots.
#: The lane masks, the state selects and the rolls (data movement) are
#: not counted: the bound is the least work, not the kernel's.
STEP_OPS = 9

#: one launch per call of the step kernel (x4, x5, x6)
step_launches = LaunchCount()


@dataclass(frozen=True)
class Variant:
    label: str
    smem: bool  # bands in shared memory (else registers)
    unroll: int
    copies: int
    fill: int


VARIANTS = {
    "v0": Variant("v0 ref-carried, unroll2", True, 2, 1, FILL_SCRATCH),
    "v1": Variant("v1 value-carried, unroll2", False, 2, 1, 0),
    "v2": Variant("v2 value-carried, unroll4", False, 4, 1, 0),
    "v3": Variant("v3 value-carried, unroll8", False, 8, 1, 0),
    "v4": Variant("v4 2x independent interleaved", False, 2, 2, 0),
}


def inputs(tb: int = TB, k: int = K, seed: int = 0):
    """(qb0, tb0, s_in) as the experiments make them: (tb, k) int32
    numpy arrays, bases in 0..3 and start scores in 0..99."""
    rng = np.random.default_rng(seed)
    qb0 = rng.integers(0, 4, (tb, k), dtype=np.int32)
    tb0 = rng.integers(0, 4, (tb, k), dtype=np.int32)
    s_in = rng.integers(0, 100, (tb, k), dtype=np.int32)
    return qb0, tb0, s_in


def q2_for(k: int) -> int:
    """The experiments' `q2 = t2 = 2 * (K * 40)`."""
    return 2 * (k * 40)


def stream_rows(qb0, tb0, w: int, fill):
    """The two stream registers before the first roll: (TB, W + K)
    int32, the query stream's lanes W.. and the target stream's lanes
    ..K written, the rest `fill` (an int, or one per row as a (TB,)
    tensor)."""
    rows = qb0.shape[0]
    if isinstance(fill, int):
        pad = torch.full((rows, w), fill, dtype=torch.int32, device=qb0.device)
    else:
        pad = fill.to(torch.int32)[:, None].expand(rows, w)
    return torch.cat([pad, qb0], 1), torch.cat([tb0, pad], 1)


def step_terms(s, i1, d1, i2, d2, qv, tv, d: int, q2: int):
    """The recurrence of kexp6.py `step_math` at anti-diagonal d, on
    (TB, K) int32 bands and the stream values at the band's lanes.
    Returns (active, i1n, d1n, i2n, d2n, sn, diag, match, flags), flags
    the four extend-wins tests (i1x, d1x, i2x, d2x) kexp8.py records."""
    k = s.shape[1]
    lane = torch.arange(k, device=s.device)
    lo, hi = max(d - q2, -d), min(q2 - d, d)
    active = ((lane & 1) == (d & 1)) & (lane >= lo) & (lane <= hi)
    first, last = lane == 0, lane == k - 1
    s_km1 = torch.where(first, INF, torch.roll(s, 1, 1))
    s_kp1 = torch.where(last, INF, torch.roll(s, -1, 1))
    i1e = torch.where(first, INF, torch.roll(i1, 1, 1)) + E1
    d1e = torch.where(last, INF, torch.roll(d1, -1, 1)) + E1
    i2e = torch.where(first, INF, torch.roll(i2, 1, 1)) + E2
    d2e = torch.where(last, INF, torch.roll(d2, -1, 1)) + E2
    i1o, d1o = s_km1 + O1E1, s_kp1 + O1E1
    i2o, d2o = s_km1 + O2E2, s_kp1 + O2E2
    i1n, d1n = torch.minimum(i1o, i1e), torch.minimum(d1o, d1e)
    i2n, d2n = torch.minimum(i2o, i2e), torch.minimum(d2o, d2e)
    best = torch.minimum(torch.minimum(i1n, d1n), torch.minimum(i2n, d2n))
    match = qv == tv
    diag_ok = (lane <= d - 2) & (lane >= 2 - d)
    diag = torch.where(diag_ok, s + torch.where(match, 0, X).to(torch.int32), INF)
    sn = torch.minimum(diag, best)
    flags = (i1e <= i1o, d1e <= d1o, i2e <= i2o, d2e <= d2o)
    return active, i1n, d1n, i2n, d2n, sn, diag, match, flags


def roll_streams(qb, tb, w: int):
    """One step's rotation of the two stream registers, and the stream
    values at the band's lanes: (qb, tb, qv, tv)."""
    k = qb.shape[1] - w
    qb = torch.roll(qb, 1, 1)
    tb = torch.roll(tb, -1, 1)
    return qb, tb, qb[:, w:], tb[:, :k]


def step_ref(state, qb, tb, d: int, w: int, q2: int):
    """One score-only step of the plain version: (state, qb, tb) at d."""
    qb, tb, qv, tv = roll_streams(qb, tb, w)
    active, i1n, d1n, i2n, d2n, sn, _, _, _ = step_terms(*state, qv, tv, d, q2)
    new = (sn, i1n, d1n, i2n, d2n)
    return tuple(torch.where(active, n, o) for n, o in zip(new, state)), qb, tb


def initial_state(s_in):
    inf = torch.full_like(s_in, INF)
    return (s_in.clone(), inf, inf.clone(), inf.clone(), inf.clone())


def sweep_ref(qb0, tb0, s_in, nsteps: int, w: int, fill, every: int = 0):
    """Plain version of the score-only sweep: the S band after nsteps
    steps (d = 2 .. nsteps + 1), and the S band after every `every`
    steps when every > 0 (else an empty list)."""
    q2 = q2_for(s_in.shape[1])
    qb, tb = stream_rows(qb0, tb0, w, fill)
    state = initial_state(s_in)
    snaps = []
    for j in range(nsteps):
        state, qb, tb = step_ref(state, qb, tb, j + 2, w, q2)
        if every and (j + 1) % every == 0:
            snaps.append(state[0].clone())
    return state[0], snaps


def run_ref(variant: str, qb0, tb0, s_in, nsteps: int = NSTEPS, w: int = W):
    """Plain version of one x4 variant: its (TB, K) int32 output."""
    v = VARIANTS[variant]
    out, _ = sweep_ref(qb0, tb0, s_in, nsteps, w, v.fill)
    if v.copies == 2:
        out = out + sweep_ref(qb0, tb0, s_in + 1, nsteps, w, v.fill)[0]
    return out


def carried_refs(qb0, tb0, s_in, nsteps: int = NSTEPS, w: int = W):
    """Plain outputs of the value-carried variants v1-v4, {variant: (TB,
    K) int32}, from one sweep over their two problems stacked by row
    (fill 0): v1-v3's and v4's second copy."""
    out, _ = sweep_ref(qb0.repeat(2, 1), tb0.repeat(2, 1), torch.cat([s_in, s_in + 1]),
                       nsteps, w, 0)
    carried, second = out.split(s_in.shape[0])
    return {"v1": carried, "v2": carried, "v3": carried, "v4": carried + second}



def active_lane_steps(k: int, nsteps: int) -> int:
    """Lane-steps the recurrence updates over d = 2 .. nsteps + 1 (the
    lanes of d's parity inside [max(d - q2, -d), min(q2 - d, d)])."""
    q2 = q2_for(k)
    d = np.arange(2, nsteps + 2, dtype=np.int64)
    lo = np.maximum(np.maximum(d - q2, -d), 0)
    hi = np.minimum(np.minimum(q2 - d, d), k - 1)
    # lanes c in [lo, hi] with c % 2 == d % 2
    first = lo + ((lo - d) & 1)
    return int(np.maximum((hi - first) // 2 + 1, 0).sum())


def work(variant: str, tb: int = TB, k: int = K, nsteps: int = NSTEPS):
    """(int32 ops, bytes) one x4 call needs: the active lane-steps of
    each problem copy, and the three (TB, K) int32 inputs read and the
    output written once."""
    copies = VARIANTS[variant].copies
    return copies * tb * active_lane_steps(k, nsteps) * STEP_OPS, 4 * tb * k * 4


def _ptr(t):
    return None if t is None else t.data_ptr()


def launch_smem(qb0, tb0, s_in, w: int, fill: int, n0: int, n_steps: int, *, chunk=None,
                state=None, base=None, sout=None, sout_every=False, sout_last=True,
                dummy=None, plane_mode=0, planes=(None, None), shape_tag="v0"):
    """One launch of csrc/probe_step.cu's shared-memory step kernel:
    steps n0 .. n0 + n_steps - 1 (anti-diagonal d = base + step + 2,
    `base` a device int32 scalar or 0), one block a problem, the five
    bands double-buffered in shared memory. The state comes from s_in
    when n0 == 0, else from `state` (5, TB, K) int32, and goes back to
    `state` when it is given. Every `chunk` steps the S band goes to
    `sout` (when sout_every) and, as uint8, to `dummy` (TB, K); after
    the last step to `sout` when sout_last. plane_mode 1-3 store each
    step's choice plane (x6) into `planes` (from n0 = 0 only), with the
    run band in shared memory."""
    from ..wfa import cuda_build

    tb_, k = s_in.shape
    for name, t in (("qb0", qb0), ("tb0", tb0), ("s_in", s_in)):
        _check_cuda(name, t, torch.int32, (tb_, k))
    for name, t, shape in (("state", state, (5, tb_, k)), ("sout", sout, (tb_, k)),
                           ("base", base, (1,))):
        if t is not None:
            _check_cuda(name, t, torch.int32, shape)
    if dummy is not None:
        _check_cuda("dummy", dummy, torch.uint8, (tb_, k))
    if n0 > 0 and (state is None or plane_mode):
        raise ValueError("a launch after step 0 needs the state and stores no plane")
    chunk = chunk or n_steps
    if n_steps % chunk:
        raise ValueError(f"n_steps {n_steps} is not a multiple of chunk {chunk}")
    lib = cuda_build.library("probe_step")
    rc = lib.allwave_probe_step_smem(
        qb0.data_ptr(), tb0.data_ptr(), s_in.data_ptr(), tb_, k, w, fill, q2_for(k),
        n0, n_steps, chunk, _ptr(state), _ptr(base), _ptr(sout), int(sout_every),
        int(sout_last), _ptr(dummy), plane_mode, _ptr(planes[0]), _ptr(planes[1]),
        torch.cuda.current_stream(s_in.device).cuda_stream,
    )
    cuda_build.check(rc, "probe_step kernel launch")
    step_launches.launched((tb_, k, w, n_steps, shape_tag))


def sweep(variant: str, qb0, tb0, s_in, nsteps: int = NSTEPS, w: int = W):
    """One x4 variant: the plain version for CPU tensors, the
    csrc/probe_step.cu kernel for CUDA tensors. (TB, K) int32."""
    if s_in.device.type == "cpu":
        return run_ref(variant, qb0, tb0, s_in, nsteps, w)
    from ..wfa import cuda_build

    v = VARIANTS[variant]
    tb_, k = s_in.shape
    sout = torch.empty_like(s_in)
    if v.smem:
        launch_smem(qb0, tb0, s_in, w, v.fill, 0, nsteps, sout=sout, shape_tag=variant)
        return sout
    for name, t in (("qb0", qb0), ("tb0", tb0), ("s_in", s_in)):
        _check_cuda(name, t, torch.int32, (tb_, k))
    lib = cuda_build.library("probe_step")
    rc = lib.allwave_probe_step_regs(
        qb0.data_ptr(), tb0.data_ptr(), s_in.data_ptr(), tb_, k, w, v.fill, q2_for(k),
        nsteps, v.unroll, v.copies, sout.data_ptr(),
        torch.cuda.current_stream(s_in.device).cuda_stream,
    )
    cuda_build.check(rc, f"probe_step {variant} at K {k}, {nsteps} steps (K = 256 * 1, 2, 4, "
                         f"6 or 8, steps a multiple of the unroll)")
    step_launches.launched((tb_, k, w, nsteps, variant))
    return sout
