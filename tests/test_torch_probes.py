"""The probes of allwave_tpu_torch/probes against the TPU experiments
they port (scripts/experiments/kexp*.py), on the CPU.

Each experiment file is loaded without running it: its module body is
parsed, only its imports, function definitions and assignments are
kept (which drops the top-level `run(...)` calls and loops), it is
executed with `__file__` set, its size globals are set to small values,
and its `pl` is replaced by a namespace whose `pallas_call` runs in
interpret mode. The Pallas kernels are then called as each file's
`run` calls them, and their outputs are held to the probe's plain
version with tolerance 0. The kernels themselves run on the card
(tests/test_torch_kernels.py, marker `cuda`).
"""

import ast
import functools
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from allwave_tpu_torch.core.scores import parse_scores
from allwave_tpu_torch.probes import kexp as K1
from allwave_tpu_torch.probes import kexp2 as K2
from allwave_tpu_torch.probes import kexp3 as K3
from allwave_tpu_torch.probes import kexp6 as K6
from allwave_tpu_torch.probes import kexp7 as K7
from allwave_tpu_torch.probes import kexp8 as K8
from allwave_tpu_torch.testing.batches import random_batch
from allwave_tpu_torch.wfa import dense as TD
from allwave_tpu_torch.wfa.params import resolve_penalties

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPERIMENTS = os.path.join(REPO, "scripts", "experiments")
SCORES = "0,5,8,2,24,1"


@functools.lru_cache(maxsize=None)
def load(name: str, **sizes):
    """The namespace of scripts/experiments/<name> with its size globals
    overridden and its pallas_call in interpret mode (see the module
    docstring)."""
    path = os.path.join(EXPERIMENTS, name)
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    keep = (ast.Import, ast.ImportFrom, ast.FunctionDef, ast.Assign)
    tree.body = [node for node in tree.body if isinstance(node, keep)]
    ns = {"__file__": path, "__name__": "experiment_" + name[:-3]}
    # kexp.py imports scripts/microbench.py, as its own sys.path line does
    sys.path.insert(0, os.path.dirname(EXPERIMENTS))
    try:
        exec(compile(tree, path, "exec"), ns)
    finally:
        sys.path.remove(os.path.dirname(EXPERIMENTS))
    ns.update(sizes)
    interp = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("_")})
    interp.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    ns["pl"] = interp
    return ns


def _torch(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _band_specs(tb, k):
    return pl.BlockSpec((tb, k), lambda d: (0, 0), memory_space=pltpu.VMEM)


# --------------------------------------------------------------------- x4

X4 = dict(TB=8, K=128, W=128, NSTEPS=32)


@pytest.mark.parametrize("variant", list(K6.VARIANTS))
def test_kexp6_variant_matches_experiment(variant):
    ns = load("kexp6.py", **X4)
    tb, k, w, n = X4["TB"], X4["K"], X4["W"], X4["NSTEPS"]
    kernel, scratch = {
        "v0": (ns["kernel_v0"], True),
        "v1": (ns["make_v_carry"](2), False),
        "v2": (ns["make_v_carry"](4), False),
        "v3": (ns["make_v_carry"](8), False),
        "v4": (ns["kernel_v4"], False),
    }[variant]
    qb0, tb0, s_in = K6.inputs(tb, k)
    kw = dict(out_shape=jax.ShapeDtypeStruct((tb, k), jnp.int32),
              in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 3,
              out_specs=pl.BlockSpec(memory_space=pltpu.VMEM))
    if scratch:  # as kexp6.py run(..., scratch=True)
        kw["scratch_shapes"] = ([pltpu.VMEM((tb, k), jnp.int32)] * 5
                                + [pltpu.VMEM((tb, w + k), jnp.int32)] * 2)
    want = np.asarray(ns["pl"].pallas_call(kernel, **kw)(qb0, tb0, s_in))
    got = K6.sweep(variant, *_torch(qb0, tb0, s_in), n, w)
    np.testing.assert_array_equal(got.numpy(), want)
    args = _torch(qb0, tb0, s_in)
    ref = (K6.run_ref(variant, *args, n, w) if variant == "v0"
           else K6.carried_refs(*args, n, w)[variant])
    assert torch.equal(got, ref)


def test_kexp6_fill_matters():
    """The stream lanes the scratch variants leave unwritten reach the
    band: v0 (fill -2**31) and v1 (fill 0) differ on the same inputs."""
    args = _torch(*K6.inputs(X4["TB"], X4["K"]))
    assert not torch.equal(K6.run_ref("v0", *args, 32, 128), K6.run_ref("v1", *args, 32, 128))


def test_kexp6_active_lane_steps_counts_the_mask():
    k, n = 64, 40
    q2 = K6.q2_for(k)
    lane = np.arange(k)
    want = sum(int((((lane & 1) == (d & 1)) & (lane >= max(d - q2, -d))
                    & (lane <= min(q2 - d, d))).sum()) for d in range(2, n + 2))
    assert K6.active_lane_steps(k, n) == want


# --------------------------------------------------------------------- x5

X5 = dict(TB=8, K=128, W=128, NSTEPS=256)


@pytest.mark.parametrize("variant", list(K7.TPU_VARIANTS))
def test_kexp7_variant_matches_experiment(variant):
    ns = load("kexp7.py", **X5)
    tb, k, w, n = X5["TB"], X5["K"], X5["W"], X5["NSTEPS"]
    v = K7.VARIANTS[variant]
    nd, dc = v.nd, n // v.nd
    qb0, tb0, s_in = K6.inputs(tb, k)
    band = _band_specs(tb, k)
    in_specs, args = [band] * 3, [qb0, tb0, s_in]
    if v.device_base:
        in_specs = [pl.BlockSpec(memory_space=pltpu.SMEM)] + in_specs
        args = [np.zeros((1, 1), np.int32)] + args
    out_shape, out_specs = [jax.ShapeDtypeStruct((tb, k), jnp.int32)], [band]
    if v.dummy:
        moving = v.dummy == "moving"
        out_shape.append(jax.ShapeDtypeStruct((nd if moving else 1, tb, k), jnp.uint8))
        out_specs.append(pl.BlockSpec((1, tb, k), (lambda d: (d, 0, 0)) if moving
                                      else (lambda d: (0, 0, 0)), memory_space=pltpu.VMEM))
    kern = ns["make_kernel"](dc, v.state_every, bool(v.dummy), v.device_base)
    want = ns["pl"].pallas_call(
        kern, grid=(nd,), in_specs=in_specs, out_specs=out_specs, out_shape=out_shape,
        scratch_shapes=[pltpu.VMEM((tb, k), jnp.int32)] * 5
        + [pltpu.VMEM((tb, w + k), jnp.int32)] * 2,
    )(*args)
    s, dummy = K7.run(variant, *_torch(qb0, tb0, s_in), n, w)
    np.testing.assert_array_equal(s.numpy(), np.asarray(want[0]))
    if v.dummy:
        np.testing.assert_array_equal(dummy.numpy(), np.asarray(want[1]))
    else:
        assert dummy is None
    # every x5 variant computes x4's v0 over the same steps
    assert torch.equal(s, K6.run_ref("v0", *_torch(qb0, tb0, s_in), n, w))


def test_kexp7_shared_sweep_equals_each_variant():
    """`refs` (one sweep for all variants, g10 included) gives what each
    variant's own plain run gives."""
    args = _torch(*K6.inputs(4, 64))
    all_refs = K7.refs(*args, 128, 64)
    for name in K7.VARIANTS:
        s, dummy = K7.run_ref(name, *args, 128, 64)
        assert torch.equal(all_refs[name][0], s)
        assert (dummy is None and all_refs[name][1] is None) or torch.equal(all_refs[name][1], dummy)


# --------------------------------------------------------------------- x6

X6 = dict(TB=8, K=128, W=128, NSTEPS=64, DC=8, ND=8)


@pytest.mark.parametrize("mode", list(K8.MODES))
def test_kexp8_mode_matches_experiment(mode):
    ns = load("kexp8.py", **X6)
    tb, k, w, n, dc = X6["TB"], X6["K"], X6["W"], X6["NSTEPS"], X6["DC"]
    qb0, tb0, s_in = K6.inputs(tb, k)
    band = _band_specs(tb, k)
    plane = pl.BlockSpec((dc, tb, k), lambda d: (d, 0, 0), memory_space=pltpu.VMEM)
    dtypes = {"p1": [jnp.uint8, jnp.uint8], "p2": [jnp.uint16], "p3": [jnp.int32]}.get(mode, [])
    want = ns["pl"].pallas_call(
        ns["make_kernel"](mode), grid=(n // dc,), in_specs=[band] * 3,
        out_specs=[band] + [plane] * len(dtypes),
        out_shape=[jax.ShapeDtypeStruct((tb, k), jnp.int32)]
        + [jax.ShapeDtypeStruct((n, tb, k), dt) for dt in dtypes],
        scratch_shapes=[pltpu.VMEM((tb, k), jnp.int32)] * 5
        + [pltpu.VMEM((tb, w + k), jnp.int32)] * 2 + [pltpu.VMEM((tb, k), jnp.int32)],
    )(qb0, tb0, s_in)
    args = _torch(qb0, tb0, s_in)
    s, planes = K8.run(mode, *args, n, w)
    np.testing.assert_array_equal(s.numpy(), np.asarray(want[0]))
    assert len(planes) == len(want) - 1
    for got, ref in zip(planes, want[1:]):
        np.testing.assert_array_equal(got.to(torch.int64).numpy(), np.asarray(ref).astype(np.int64))
    rs, rplanes = K8.refs(*args, n, w)[mode]
    assert torch.equal(rs, s) and all(torch.equal(a, b) for a, b in zip(rplanes, planes))


# ----------------------------------------------------------------- x2, x3

OPS = dict(STEPS=8, TILES=4)


@pytest.mark.parametrize("case", [c[0] for c in K2.CASES])
def test_kexp2_case_matches_experiment(case):
    ns = load("kexp2.py", **OPS)
    _, r, a, s, m = next(c for c in K2.CASES if c[0] == case)
    x = K2.inputs()
    want = np.asarray(ns["make"](r, a, s, m)(jnp.asarray(x)))
    got = K2.run(case, torch.from_numpy(x), OPS["STEPS"], OPS["TILES"], copies=2)
    assert got.shape == (2, *x.shape)
    for c in got:
        np.testing.assert_array_equal(c.numpy(), want)


@pytest.mark.parametrize("case", [c[0] for c in K3.CASES])
def test_kexp3_case_matches_experiment(case):
    ns = load("kexp3.py", **OPS)
    _, shape, axis, r, a, u = K3.case(case)
    x = K3.inputs()[case]
    want = np.asarray(ns["make"](shape, axis, r, a, u)(jnp.asarray(x)))
    got = K3.run(case, torch.from_numpy(x), OPS["STEPS"], OPS["TILES"])
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_kexp2_grid_carries_the_tile():
    """The experiment's sequential grid applies the chain TILES * STEPS
    times, not STEPS times."""
    ns = load("kexp2.py", **OPS)
    x = K2.inputs()
    want = np.asarray(ns["make"](0, 8, 0, 0)(jnp.asarray(x)))
    steps = OPS["STEPS"] * OPS["TILES"]
    np.testing.assert_array_equal(K2.chain_ref(torch.from_numpy(x), steps, 0, 8, 0, 0).numpy(), want)
    assert not np.array_equal(K2.chain_ref(torch.from_numpy(x), OPS["STEPS"], 0, 8, 0, 0).numpy(), want)


# --------------------------------------------------------------------- x1

X1 = dict(B=64, L=120, l_pad=128, K=128)


def _check_kexp(variant, B, L, l_pad, K):
    from allwave_tpu.core.scores import parse_scores as jparse
    from allwave_tpu.wfa.params import resolve_penalties as jresolve

    ns = load("kexp.py")
    _, opt, with_planes = K1.VARIANTS[variant]
    batch = random_batch(np.random.RandomState(3), B, L, l_pad, 0.05)
    js, jp = ns["forward_v"](*map(jnp.asarray, batch), jresolve(jparse(SCORES)), K, l_pad,
                             with_planes, opt)
    pen = resolve_penalties(parse_scores(SCORES))
    qs, ts, ql, tl = _torch(*batch)
    s, c, p = K1.forward(variant, qs, ts, ql, tl, pen, K, l_pad)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    # the engine's forward: same scores and certificates; the traceback
    # over either plane gives the same bytes
    sd, cd, pd = TD.dense_forward(qs, ts, ql, tl, pen, K, l_pad)
    assert torch.equal(s, sd) and torch.equal(c, cd)
    if with_planes:
        np.testing.assert_array_equal(p.to(torch.int64).numpy(), np.asarray(jp).astype(np.int64))
        assert torch.equal(TD.dense_traceback(p, s, c, ql, tl, 64),
                           TD.dense_traceback(pd, sd, cd, ql, tl, 64))
    else:
        assert p is None


@pytest.mark.parametrize("variant", list(K1.VARIANTS))
def test_kexp_variant_matches_experiment_and_engine(variant):
    _check_kexp(variant, X1["B"], X1["L"], X1["l_pad"], X1["K"])


@pytest.mark.parametrize("variant", list(K1.VARIANTS))
def test_kexp_variant_at_headline_band(variant):
    """K = 192, the headline's band round: six lanes a thread on the
    card, a template instance of its own."""
    _check_kexp(variant, X1["B"], X1["L"], X1["l_pad"], 192)


def test_kexp_active_cells_counts_the_band():
    """The cells x1's work counts are the cells the recurrence updates."""
    pen = resolve_penalties(parse_scores(SCORES))
    qs, ts, ql, tl = _torch(*random_batch(np.random.RandomState(4), 8, 60, 64, 0.05))
    K, l_pad = 64, 64
    _, k0, _ = TD.band_geometry(ql, tl, K)
    ks = k0[:, None] + torch.arange(K)[None, :]
    want = 0
    for d in range(1, 2 * l_pad + 1):
        lo = torch.maximum(d - 2 * ql[:, None], torch.full_like(ks, -d))
        hi = torch.minimum(2 * tl[:, None] - d, torch.full_like(ks, d))
        want += int((((ks & 1) == (d & 1)) & (ks >= lo) & (ks <= hi)).sum())
    assert K1.active_cells(ql.numpy(), tl.numpy(), k0.numpy(), K, 0, 2 * l_pad) == want
    with pytest.raises(ValueError):
        K1.forward("V1", qs, ts, ql, tl, resolve_penalties(parse_scores("0,5,8,2")), K, l_pad)


# ------------------------------------------------------ the package itself


SASS = """
		Function : _Z4loopPi
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
                                                           /* 0x000fe20000000800 */
.L_x_0:
        /*0010*/                   IADD3 R2, R2, 0x3, RZ ;  /* 0x0000000302027810 */
        /*0020*/                   VIADDMNMX R3, R2, 0x1, R3, PT ;
        /*0030*/               @P0 IMAD.IADD R4, R4, 0x1, R2 ;
        /*0040*/              @!P1 BRA `(.L_x_0) ;
        /*0050*/                   BRA 0x10 ;
        /*0060*/                   EXIT ;
"""


def test_sass_loops_count_their_opcodes():
    from allwave_tpu_torch.probes import sass

    funcs, labels = sass.parse(SASS)
    assert list(funcs) == ["_Z4loopPi"] and labels["_Z4loopPi"] == {".L_x_0": 0x10}
    loops = sass.loops(funcs["_Z4loopPi"], labels["_Z4loopPi"])
    assert [(a, b) for a, b, _ in loops] == [(0x10, 0x40), (0x10, 0x50)]
    assert loops[0][2] == {"IADD3": 1, "VIADDMNMX": 1, "IMAD.IADD": 1, "BRA": 1}
    assert sum(loops[1][2].values()) == 5


#: a walker's loop: a hop loads its entry (0x10), a fast way round that
#: moves by it in two ALU instructions (0x40, 0x50), a slow way round
#: through a spin wait (0x80-0xb0, whose load's address is fixed) and
#: three more
WALK_SASS = """
		Function : _Z4walkPi
        /*0000*/                   MOV R2, RZ ;
        /*0010*/                   LDS.U16 R3, [R2] ;
        /*0020*/                   ISETP.GT.AND P0, PT, R3, 0x10, PT ;
        /*0030*/               @P0 BRA 0x80 ;
        /*0040*/                   SHF.R.S32.HI R4, RZ, 0x8, R3 ;
        /*0050*/                   IMAD R2, R4, 0x2, R2 ;
        /*0060*/                   ISETP.NE.AND P1, PT, R4, RZ, PT ;
        /*0070*/               @P1 BRA 0x10 ;
        /*0080*/                   LDS R5, [R6] ;
        /*0090*/                   ISETP.NE.AND P2, PT, R5, RZ, PT ;
        /*00a0*/                   YIELD ;
        /*00b0*/               @P2 BRA 0x80 ;
        /*00c0*/                   IADD3 R2, R2, R3, RZ ;
        /*00d0*/                   LOP3.LUT R2, R2, 0xff, RZ, 0xc0, !PT ;
        /*00e0*/                   IADD3 R2, R2, 0x1, RZ ;
        /*00f0*/                   BRA 0x10 ;
        /*0100*/                   EXIT ;
"""


@pytest.mark.parametrize("text,dests,sources", [
    ("ISETP.GE.U32.AND P0, PT, R41, R30, PT", ["P0"], ["R41", "R30"]),
    ("@!P0 IADD3 R16, P4, R16, 0x1, RZ", ["R16", "P4"], ["P0", "R16"]),
    ("PLOP3.LUT P2, PT, P2, P1, PT, 0x20, 0x0", ["P2"], ["P2", "P1"]),
    ("LOP3.LUT P1, RZ, R8, 0x7, R27.reuse, 0xf8, !PT", ["P1"], ["R8", "R27"]),
    ("SEL R6, R41, R6, !P0", ["R6"], ["R41", "R6", "P0"]),
    ("IMAD.WIDE.U32 R4, R2, 0x4, R6", ["R4", "R5"], ["R2", "R6"]),
    ("@P0 LDS.64 R8, [R24+0x10]", ["R8", "R9"], ["P0", "R24"]),
    ("STG.E.U8 desc[UR8][R24.64], R6", [], ["UR8", "R24", "R25", "R6"]),
    ("@!P2 BRA P1, 0x2670", [], ["P2", "P1"]),
])
def test_sass_operands_name_what_an_instruction_writes_and_reads(text, dests, sources):
    from allwave_tpu_torch.probes import sass

    _, _, d, s = sass.operands(text)
    assert (d, s) == (dests, sources)


def test_sass_hop_chain_takes_the_walkers_fast_way_round():
    """The hop's load, its value's two ALU steps to the next address and
    the branch that waits on one of them: one load and three ALU
    latencies, in issue order; the spin wait's load does not count."""
    from allwave_tpu_torch.probes import sass

    funcs, labels = sass.parse(WALK_SASS)
    chain = sass.hop_chain(funcs["_Z4walkPi"], labels["_Z4walkPi"])
    assert chain == {"loads": 1, "alu": 3, "at": 0x10}
    # a walker that moves without reading what it loaded has no chain
    fixed = WALK_SASS.replace("IMAD R2, R4, 0x2, R2", "IMAD R2, R7, 0x2, R2").replace(
        "IADD3 R2, R2, R3, RZ", "IADD3 R2, R2, R7, RZ")
    funcs, labels = sass.parse(fixed)
    assert sass.hop_chain(funcs["_Z4walkPi"], labels["_Z4walkPi"]) is None


def test_probes_import_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import allwave_tpu_torch.probes.runner, allwave_tpu_torch.wfa.cuda_build as cb\n"
        "assert {'probe_forward', 'probe_step', 'probe_ops', 'probe_latency'} <= set(cb.SIGNATURES)\n"
        "assert len(cb.SIGNATURES) == 12\n"
        "assert not any(m == 'jax' or m.startswith('jax.') or m.startswith('allwave_tpu.') "
        "for m in sys.modules if sys.modules[m])\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_point_needs_cuda_unless_cpu_is_asked():
    run = functools.partial(subprocess.run, cwd=REPO, capture_output=True, text=True,
                            timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    proc = run([sys.executable, "-m", "allwave_tpu_torch.probes", "--only", "kexp6"])
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    proc = run([sys.executable, "-m", "allwave_tpu_torch.probes", "--only", "kexp6,kexp2",
                "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert sum(line.startswith("x4 ") for line in lines) == len(K6.VARIANTS)
    assert sum(line.startswith("x2 ") for line in lines) == len(K2.CASES)
    assert lines[-1].startswith("cpu")


@pytest.mark.parametrize("probe", ["walk_latency_ns", "dram_ns"])
def test_latency_probes_refuse_the_cpu(probe):
    """The latency probes time the card: asked for the CPU they raise
    before building anything."""
    from allwave_tpu_torch.probes import latency

    with pytest.raises(ValueError, match="CUDA card"):
        getattr(latency, probe)("cpu")
