"""x6: the step with choices, storing the traceback plane in four formats.

Port of scripts/experiments/kexp8.py (`make_kernel`; the pallas_call in
`run`): x4's step (`kexp6.step_terms`) at TB=16, K=2048, W=128 over
NSTEPS=4096 steps, which also records at every lane of every step the
S source (`choice`), the four extend-wins bits and the diagonal-match
run length, as kexp8.py:84-103 computes them (its own choice codes:
D2 5, D1 3, I2 4, I1 2, diagonal mismatch 1, match 0). The plane
formats:

* p0: no plane (the score-only baseline);
* p1: two uint8 planes, the packed choice byte and the run length (the
  TPU span kernel's format);
* p2: one uint16 plane, run length in the high byte
  (csrc/dense_forward.cu's and csrc/dense_span.cu's format);
* p3: one int32 plane of the same value.

On the TPU the plane leaves in (DC, TB, K) blocks, one per grid step of
DC=32 steps. On Hopper the whole sweep is one launch of
csrc/probe_step.cu's shared-memory kernel and each step stores its
plane row directly, so DC has no counterpart. The stream scratch is
filled with kexp6.FILL_SCRATCH, as in the experiment.
"""

from __future__ import annotations

import torch

from . import kexp6 as S

TB, K, W = 16, 2048, 128
DC = 32
NSTEPS = 4096
MODES = ("p0", "p1", "p2", "p3")
LABELS = {
    "p0": "p0 no planes (score-only)",
    "p1": "p1 two uint8 planes",
    "p2": "p2 one uint16 merged plane",
    "p3": "p3 one int32 merged plane",
}
_PLANE_DTYPES = {"p1": (torch.uint8, torch.uint8), "p2": (torch.uint16,), "p3": (torch.int32,)}

#: int32 instruction slots the choice byte and the run length add to an
#: active lane-step, counted as kexp6.STEP_OPS counts them: the four
#: extend-wins compares (4); for each of the choice's five sources a
#: compare with S and a select (10); the four flag bits into the byte,
#: one P2R of their predicates and one LOP3 (2); the run length, one
#: VIADDMNMX for min(run + 1, 255), the choice == 0 compare and a select
#: (3); the run length into the high byte, one IMAD (run * 256 + byte)
#: on the FMA pipe (1). 19 of the 20 run on the ALU pipe only, so with
#: the step's they add 19 ALU slots (max(9 + 19, (13 + 20) / 2) = 28).
CHOICE_OPS = 19


def choices(sn, i1n, d1n, i2n, d2n, diag, match, flags, runl):
    """kexp8.py's choice byte and run length: (packed, newrun) int32."""
    choice = torch.zeros_like(sn)
    choice = torch.where(d2n == sn, 5, choice)
    choice = torch.where(d1n == sn, 3, choice)
    choice = torch.where(i2n == sn, 4, choice)
    choice = torch.where(i1n == sn, 2, choice)
    choice = torch.where((diag == sn) & ~match, 1, choice)
    packed = choice
    for bit, flag in zip((3, 4, 5, 6), flags):
        packed = packed | (flag.to(torch.int32) << bit)
    newrun = torch.where(choice == 0, runl.clamp(max=254) + 1, 0)
    return packed, newrun


def run_ref(mode: str, qb0, tb0, s_in, nsteps: int = NSTEPS, w: int = W):
    """Plain version of one x6 mode: (S (TB, K) int32, tuple of planes
    (nsteps, TB, K) in the mode's format)."""
    q2 = S.q2_for(s_in.shape[1])
    qb, tb = S.stream_rows(qb0, tb0, w, S.FILL_SCRATCH)
    state = S.initial_state(s_in)
    runl = torch.zeros_like(s_in)
    planes = tuple(torch.empty((nsteps, *s_in.shape), dtype=dt, device=s_in.device)
                   for dt in _PLANE_DTYPES.get(mode, ()))
    for j in range(nsteps):
        qb, tb, qv, tv = S.roll_streams(qb, tb, w)
        active, i1n, d1n, i2n, d2n, sn, diag, match, flags = S.step_terms(
            *state, qv, tv, j + 2, q2)
        if mode != "p0":
            packed, newrun = choices(sn, i1n, d1n, i2n, d2n, diag, match, flags, runl)
            if mode == "p1":
                planes[0][j] = packed.to(torch.uint8)
                planes[1][j] = newrun.to(torch.uint8)
            else:
                planes[0][j] = (packed | (newrun << 8)).to(planes[0].dtype)
            runl = torch.where(active, newrun, runl)
        state = tuple(torch.where(active, n, o)
                      for n, o in zip((sn, i1n, d1n, i2n, d2n), state))
    return state[0], planes


def refs(qb0, tb0, s_in, nsteps: int = NSTEPS, w: int = W):
    """Plain outputs of every x6 mode, {mode: (S, planes)}, from one
    sweep with the int32 plane (p3), whose bytes the other formats hold."""
    s, (p3,) = run_ref("p3", qb0, tb0, s_in, nsteps, w)
    return {
        "p0": (s, ()),
        "p1": (s, ((p3 & 0xFF).to(torch.uint8), (p3 >> 8).to(torch.uint8))),
        "p2": (s, (p3.to(torch.uint16),)),
        "p3": (s, (p3,)),
    }


def work(mode: str, tb: int = TB, k: int = K, nsteps: int = NSTEPS):
    """(int32 ops, bytes) one x6 call needs: x4's, the choice work of
    every active lane-step, and every plane byte written once."""
    ops, nbytes = S.work("v0", tb, k, nsteps)
    if mode != "p0":
        ops += tb * S.active_lane_steps(k, nsteps) * CHOICE_OPS
        nbytes += nsteps * tb * k * sum(dt.itemsize for dt in _PLANE_DTYPES[mode])
    return ops, nbytes


def run(mode: str, qb0, tb0, s_in, nsteps: int = NSTEPS, w: int = W):
    """One x6 mode: the plain version for CPU tensors, one
    csrc/probe_step.cu launch for CUDA tensors."""
    if s_in.device.type == "cpu":
        return run_ref(mode, qb0, tb0, s_in, nsteps, w)
    sout = torch.empty_like(s_in)
    planes = tuple(torch.empty((nsteps, *s_in.shape), dtype=dt, device=s_in.device)
                   for dt in _PLANE_DTYPES.get(mode, ()))
    S.launch_smem(qb0, tb0, s_in, w, S.FILL_SCRATCH, 0, nsteps, sout=sout,
                  plane_mode=MODES.index(mode),
                  planes=planes + (None,) * (2 - len(planes)), shape_tag=mode)
    return sout, planes
