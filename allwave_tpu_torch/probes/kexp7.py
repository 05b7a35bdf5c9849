"""x5: the step split into chunks, one launch a chunk.

Port of scripts/experiments/kexp7.py (`make_kernel`; the pallas_call in
`run`): x4's score-only step (`kexp6.step_terms`) at TB=16, K=1536,
W=256 over NSTEPS=4096 steps, split into nd chunks of NSTEPS/nd steps.
On the TPU a chunk is one step of a sequential grid and the state stays
in VMEM scratch between them. On Hopper nothing carries over between
launches, so a chunk is one launch of csrc/probe_step.cu's register
kernel (`kexp6.launch_regs`, unroll 2) and the five bands round-trip
through a device buffer, as wfa/segmented.py's sweep does once per span
(PERF.md section 5). The variants, as in the experiment:

* g0: one chunk;
* g1/g2, g3/g4: 16 and 128 chunks, S written out after every chunk or
  after the last only;
* g5/g6: 128 chunks, and the S band as uint8 into a dummy output that
  stays in place (const) or moves to the chunk's slot (moving);
* g7: 128 chunks, the base anti-diagonal read from a device scalar (0)
  as the TPU kernel reads it from SMEM;
* g8, g9: 32 and 64 chunks;
* g10 (Hopper only): g3's 128 chunks looped inside one launch, the
  state in registers throughout.

Every variant's S output equals x4's v0 at TB=16 (the same 4096 steps,
the stream scratch filled with kexp6.FILL_SCRATCH); a dummy output
holds the S band after its chunk as uint8 (the low byte).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import kexp6 as S

TB, K, W = 16, 1536, 256
NSTEPS = 4096


@dataclass(frozen=True)
class Chunks:
    label: str
    nd: int  # chunks
    state_every: bool = True  # S out after every chunk (else the last)
    dummy: str = ""  # "", "const" or "moving"
    device_base: bool = False
    one_launch: bool = False


VARIANTS = {
    "g0": Chunks("g0 nd=1 (one grid step)", 1),
    "g1": Chunks("g1 nd=16, state out every step", 16),
    "g2": Chunks("g2 nd=16, state out last only", 16, False),
    "g3": Chunks("g3 nd=128, state out every step", 128),
    "g4": Chunks("g4 nd=128, state out last only", 128, False),
    "g5": Chunks("g5 nd=128, + dummy const out", 128, True, "const"),
    "g6": Chunks("g6 nd=128, + dummy moving out", 128, True, "moving"),
    "g7": Chunks("g7 nd=128, + smem scalar base", 128, True, "", True),
    "g8": Chunks("g8 nd=32 (dchunk=128), state every", 32),
    "g9": Chunks("g9 nd=64 (dchunk=64), state every", 64),
    "g10": Chunks("g10 nd=128 in one launch, state every", 128, one_launch=True),
}

#: the variants kexp7.py runs (g10 exists only on Hopper)
TPU_VARIANTS = tuple(v for v in VARIANTS if v != "g10")


def _outputs(v: Chunks, s, snaps):
    if v.dummy == "const":
        return s, snaps[-1].to(torch.uint8)[None]
    if v.dummy == "moving":
        return s, torch.stack(snaps).to(torch.uint8)
    return s, None


def run_ref(variant: str, qb0, tb0, s_in, nsteps: int = NSTEPS, w: int = W):
    """Plain version of one x5 variant: (S (TB, K) int32, dummy uint8 —
    (1, TB, K) const, (nd, TB, K) moving — or None)."""
    v = VARIANTS[variant]
    s, snaps = S.sweep_ref(qb0, tb0, s_in, nsteps, w, S.FILL_SCRATCH, every=nsteps // v.nd)
    return _outputs(v, s, snaps)


def refs(qb0, tb0, s_in, nsteps: int = NSTEPS, w: int = W):
    """Plain outputs of every x5 variant, {variant: (S, dummy)}, from one
    sweep that keeps the S band after every chunk of the finest split."""
    every = nsteps // max(v.nd for v in VARIANTS.values())
    s, snaps = S.sweep_ref(qb0, tb0, s_in, nsteps, w, S.FILL_SCRATCH, every=every)
    out = {}
    for name, v in VARIANTS.items():
        per = (nsteps // v.nd) // every
        out[name] = _outputs(v, s, snaps[per - 1 :: per])
    return out


def work(variant: str, tb: int = TB, k: int = K, nsteps: int = NSTEPS):
    """(int32 ops, bytes) one x5 call needs: x4's, plus the dummy bytes
    written. The state's round trips between launches are the cost
    this probe measures, not work the function needs."""
    ops, nbytes = S.work("v0", tb, k, nsteps)
    v = VARIANTS[variant]
    nbytes += {"": 0, "const": 1, "moving": v.nd}[v.dummy] * tb * k
    return ops, nbytes


def launches(variant: str) -> int:
    v = VARIANTS[variant]
    return 1 if v.one_launch else v.nd


def kernel_for(variant: str, k: int) -> str:
    """The csrc/probe_step.cu kernel every x5 launch runs at band K."""
    return S.regs_kernel(k)


def run(variant: str, qb0, tb0, s_in, nsteps: int = NSTEPS, w: int = W):
    """One x5 variant: the plain version for CPU tensors; for CUDA
    tensors one csrc/probe_step.cu launch a chunk (one in all for g10)."""
    if s_in.device.type == "cpu":
        return run_ref(variant, qb0, tb0, s_in, nsteps, w)
    v = VARIANTS[variant]
    tb_, k = s_in.shape
    dev = s_in.device
    if nsteps % v.nd or (nsteps // v.nd) % 2:
        raise ValueError(f"{variant}: {nsteps} steps do not split into {v.nd} even chunks")
    dc = nsteps // v.nd
    sout = torch.empty_like(s_in)
    if v.one_launch:
        S.launch_regs(qb0, tb0, s_in, w, S.FILL_SCRATCH, 0, nsteps, chunk=dc, sout=sout,
                      sout_every=v.state_every, shape_tag=variant)
        return sout, None
    state = torch.empty((5, tb_, k), dtype=torch.int32, device=dev)
    base = torch.zeros(1, dtype=torch.int32, device=dev) if v.device_base else None
    dummy = None
    if v.dummy:
        dummy = torch.empty((1 if v.dummy == "const" else v.nd, tb_, k), dtype=torch.uint8,
                            device=dev)
    for dch in range(v.nd):
        S.launch_regs(qb0, tb0, s_in, w, S.FILL_SCRATCH, dch * dc, dc, state=state, base=base,
                      sout=sout, sout_every=v.state_every, sout_last=dch == v.nd - 1,
                      dummy=None if dummy is None else dummy[0 if v.dummy == "const" else dch],
                      shape_tag=variant)
    return sout, dummy
