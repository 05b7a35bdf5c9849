"""csrc/probe_step.cu's two schedules, emulated on the CPU
(tests/torch_step_emulation.py), against the step probes' plain
versions (allwave_tpu_torch/probes/kexp6.py, kexp7.py, kexp8.py) and the
experiments they port (scripts/experiments/kexp6.py, kexp7.py, kexp8.py
in interpret mode, loaded as tests/test_torch_probes.py loads them),
with tolerance 0; and the machine-code reader behind the step's chain
bound (`probes.sass.step_chain`), the C entry points' signatures and
the latency probes' refusal of the CPU. The kernels themselves run on
the card (tests/test_torch_kernels.py, marker `cuda`).
"""

import ctypes
import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from allwave_tpu_torch.probes import kexp6 as K6
from allwave_tpu_torch.probes import kexp7 as K7
from allwave_tpu_torch.probes import kexp8 as K8
from allwave_tpu_torch.probes import sass
from test_torch_probes import load
from torch_step_emulation import regs_launch, smem_v0

W = 128


def _torch(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@functools.lru_cache(maxsize=None)
def _inputs(tb: int, k: int):
    return K6.inputs(tb, k)


# ------------------------------------------------------------------ x4 v0

#: (TB, K, W, steps): an even K, an odd one (a last lane pair of one),
#: and x4's own K (24 warps of lanes)
V0_CASES = [(2, 256, 128, 96), (2, 255, 64, 64), (1, 1536, 256, 40)]


@pytest.mark.parametrize("tb,k,w,n", V0_CASES)
def test_v0_in_place_schedule_matches_plain(tb, k, w, n):
    qb0, tb0, s_in = _inputs(tb, k)
    got = smem_v0(qb0, tb0, s_in, n, w, K6.FILL_SCRATCH)
    np.testing.assert_array_equal(got, K6.run_ref("v0", *_torch(qb0, tb0, s_in), n, w).numpy())


def test_v0_schedule_matches_experiment():
    """The in-place schedule against kexp6.py `kernel_v0` (interpret
    mode, its scratch filled as Pallas interpret fills it)."""
    tb, k, n = 2, 256, 32
    ns = load("kexp6.py", TB=tb, K=k, W=W, NSTEPS=n)
    qb0, tb0, s_in = _inputs(tb, k)
    want = ns["pl"].pallas_call(
        ns["kernel_v0"], out_shape=jax.ShapeDtypeStruct((tb, k), jnp.int32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 3,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((tb, k), jnp.int32)] * 5
        + [pltpu.VMEM((tb, W + k), jnp.int32)] * 2,
    )(qb0, tb0, s_in)
    np.testing.assert_array_equal(smem_v0(qb0, tb0, s_in, n, W, K6.FILL_SCRATCH),
                                  np.asarray(want))


# -------------------------------------------------------- register kernel

#: the register kernel's K at LPT 1 (odd: the moving registers follow
#: the thread's parity), 2 and 6
REG_K = [256, 512, 1536]


@pytest.mark.parametrize("k", REG_K)
@pytest.mark.parametrize("variant", ["v1", "v4"])
def test_register_schedule_matches_plain(variant, k):
    n = 48 if k < 1536 else 24
    qb0, tb0, s_in = _inputs(2, k)
    v = K6.VARIANTS[variant]
    got = regs_launch(qb0, tb0, s_in, W, v.fill, 0, n, copies=v.copies)["sout"]
    want = K6.carried_refs(*_torch(qb0, tb0, s_in), n, W)[variant]
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("variant,k", [("v1", 256), ("v4", 256), ("v1", 512)])
def test_register_schedule_matches_experiment(variant, k):
    """v1 and v4 against kexp6.py's value-carried kernels (interpret
    mode: `make_v_carry(2)`, `kernel_v4`)."""
    tb, n = 2, 16
    ns = load("kexp6.py", TB=tb, K=k, W=W, NSTEPS=n)
    kernel = ns["make_v_carry"](2) if variant == "v1" else ns["kernel_v4"]
    qb0, tb0, s_in = _inputs(tb, k)
    want = ns["pl"].pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((tb, k), jnp.int32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 3,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
    )(qb0, tb0, s_in)
    got = regs_launch(qb0, tb0, s_in, W, 0, 0, n, copies=K6.VARIANTS[variant].copies)["sout"]
    np.testing.assert_array_equal(got, np.asarray(want))


# ------------------------------------------------ x5: a launch a chunk

X5_TB, X5_K, X5_N = 2, 256, 256


@functools.lru_cache(maxsize=None)
def _x5_refs():
    return K7.refs(*_torch(*_inputs(X5_TB, X5_K)), X5_N, W)


def _x5_emulated(variant):
    """x5 as kexp7.run launches it: one launch a chunk, the five bands
    through a (5, TB, K) buffer (g10: the chunks in one launch)."""
    v = K7.VARIANTS[variant]
    qb0, tb0, s_in = _inputs(X5_TB, X5_K)
    dc = X5_N // v.nd
    fill = K6.FILL_SCRATCH
    if v.one_launch:
        out = regs_launch(qb0, tb0, s_in, W, fill, 0, X5_N, chunk=dc, sout_every=v.state_every)
        return out["sout"], None
    state = np.empty((5, X5_TB, X5_K), np.int32)
    sout, dummies = None, []
    for dch in range(v.nd):
        out = regs_launch(qb0, tb0, s_in, W, fill, dch * dc, dc, state=state,
                          sout_every=v.state_every, sout_last=dch == v.nd - 1,
                          dummy=bool(v.dummy))
        sout = out["sout"] if out["sout"] is not None else sout
        dummies += out["dummy"]
    dummy = None
    if v.dummy == "const":
        dummy = dummies[-1][None]
    elif v.dummy == "moving":
        dummy = np.stack(dummies)
    return sout, dummy


@pytest.mark.parametrize("variant", list(K7.VARIANTS))
def test_register_schedule_chunks_match_x5(variant):
    """Every x5 variant: the state's round trip between launches, the S
    band after every chunk or the last, the uint8 dummy."""
    s, dummy = _x5_emulated(variant)
    rs, rdummy = _x5_refs()[variant]
    np.testing.assert_array_equal(s, rs.numpy())
    if rdummy is None:
        assert dummy is None
    else:
        np.testing.assert_array_equal(dummy, rdummy.numpy())


@pytest.mark.parametrize("variant", ["g3", "g6", "g7"])
def test_register_schedule_chunks_match_experiment(variant):
    """x5 against kexp7.py `make_kernel` (interpret mode): a sequential
    grid of chunks, the state in scratch between them."""
    ns = load("kexp7.py", TB=X5_TB, K=X5_K, W=W, NSTEPS=X5_N)
    v = K7.VARIANTS[variant]
    nd, dc = v.nd, X5_N // v.nd
    qb0, tb0, s_in = _inputs(X5_TB, X5_K)
    band = pl.BlockSpec((X5_TB, X5_K), lambda d: (0, 0), memory_space=pltpu.VMEM)
    in_specs, args = [band] * 3, [qb0, tb0, s_in]
    if v.device_base:
        in_specs = [pl.BlockSpec(memory_space=pltpu.SMEM)] + in_specs
        args = [np.zeros((1, 1), np.int32)] + args
    out_shape, out_specs = [jax.ShapeDtypeStruct((X5_TB, X5_K), jnp.int32)], [band]
    if v.dummy:
        out_shape.append(jax.ShapeDtypeStruct((nd, X5_TB, X5_K), jnp.uint8))
        out_specs.append(pl.BlockSpec((1, X5_TB, X5_K), lambda d: (d, 0, 0),
                                      memory_space=pltpu.VMEM))
    want = ns["pl"].pallas_call(
        ns["make_kernel"](dc, v.state_every, bool(v.dummy), v.device_base), grid=(nd,),
        in_specs=in_specs, out_specs=out_specs, out_shape=out_shape,
        scratch_shapes=[pltpu.VMEM((X5_TB, X5_K), jnp.int32)] * 5
        + [pltpu.VMEM((X5_TB, W + X5_K), jnp.int32)] * 2,
    )(*args)
    s, dummy = _x5_emulated(variant)
    np.testing.assert_array_equal(s, np.asarray(want[0]))
    if v.dummy:
        np.testing.assert_array_equal(dummy, np.asarray(want[1]))


# ------------------------------------------------------ x6: the planes


@pytest.mark.parametrize("k", [256, 512])
def test_register_schedule_planes_match_x6(k):
    """Every lane's entry, the idle parity's too, from the values before
    the step; the run band committed with the moving lanes."""
    n = 64
    qb0, tb0, s_in = _inputs(2, k)
    out = regs_launch(qb0, tb0, s_in, W, K6.FILL_SCRATCH, 0, n, plane=True)
    s, (p3,) = K8.refs(*_torch(qb0, tb0, s_in), n, W)["p3"]
    np.testing.assert_array_equal(out["sout"], s.numpy())
    np.testing.assert_array_equal(out["plane"], p3.numpy())


def test_idle_entries_need_the_second_halo_buffer():
    """The schedule with one halo buffer a side (x6's idle lanes at warp
    edges read the slot the neighbour warp writes in the same step)
    gives other entries: the double buffer is what keeps them right."""
    n = 64
    qb0, tb0, s_in = _inputs(2, 256)
    out = regs_launch(qb0, tb0, s_in, W, K6.FILL_SCRATCH, 0, n, plane=True,
                      idle_reads_written_buffer=True)
    _, (p3,) = K8.refs(*_torch(qb0, tb0, s_in), n, W)["p3"]
    assert not np.array_equal(out["plane"], p3.numpy())


@pytest.mark.parametrize("mode", ["p1", "p3"])
def test_register_schedule_planes_match_experiment(mode):
    """x6's entries against kexp8.py `make_kernel` (interpret mode), in
    the mode's own plane format."""
    tb, k, n, dc = 2, 256, 32, 8
    ns = load("kexp8.py", TB=tb, K=k, W=W, NSTEPS=n, DC=dc, ND=n // dc)
    qb0, tb0, s_in = _inputs(tb, k)
    band = pl.BlockSpec((tb, k), lambda d: (0, 0), memory_space=pltpu.VMEM)
    plane = pl.BlockSpec((dc, tb, k), lambda d: (d, 0, 0), memory_space=pltpu.VMEM)
    dtypes = {"p1": [jnp.uint8, jnp.uint8], "p3": [jnp.int32]}[mode]
    want = ns["pl"].pallas_call(
        ns["make_kernel"](mode), grid=(n // dc,), in_specs=[band] * 3,
        out_specs=[band] + [plane] * len(dtypes),
        out_shape=[jax.ShapeDtypeStruct((tb, k), jnp.int32)]
        + [jax.ShapeDtypeStruct((n, tb, k), dt) for dt in dtypes],
        scratch_shapes=[pltpu.VMEM((tb, k), jnp.int32)] * 5
        + [pltpu.VMEM((tb, W + k), jnp.int32)] * 2 + [pltpu.VMEM((tb, k), jnp.int32)],
    )(qb0, tb0, s_in)
    out = regs_launch(qb0, tb0, s_in, W, K6.FILL_SCRATCH, 0, n, plane=True)
    np.testing.assert_array_equal(out["sout"], np.asarray(want[0]))
    ent = out["plane"]
    planes = [ent & 0xFF, ent >> 8] if mode == "p1" else [ent]
    for got, ref in zip(planes, want[1:]):
        np.testing.assert_array_equal(got.astype(np.int64), np.asarray(ref).astype(np.int64))


# ------------------------------------------------------- the chain bound

#: a step loop: a shuffle's value through three dependent ALU
#: instructions (the shorter side of a conditional branch: one
#: instruction, then an unconditional branch past the other side's two)
#: into a halo store, the barrier, then a shared-memory load that the
#: store feeds
STEP_SASS = """
		Function : _Z4stepPi
        /*0000*/                   MOV R2, RZ ;
.L_x_1:
        /*0010*/                   SHFL.UP PT, R4, R2, 0x1, RZ ;
        /*0020*/                   IADD3 R5, R4, 0xa, RZ ;
        /*0030*/                   VIADDMNMX R6, R3, 0x2, R5, PT ;
        /*0040*/                   ISETP.GT.AND P0, PT, R7, RZ, PT ;
        /*0050*/               @P0 BRA `(.L_x_2) ;
        /*0060*/                   VIMNMX R2, R6, R8, PT ;
        /*0070*/                   BRA `(.L_x_3) ;
.L_x_2:
        /*0080*/                   IADD3 R2, R6, 0x1, RZ ;
        /*0090*/                   IADD3 R2, R2, 0x1, RZ ;
.L_x_3:
        /*00a0*/                   STS [R9], R2 ;
        /*00b0*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*00c0*/                   LDS R8, [R10] ;
        /*00d0*/               @P1 BRA `(.L_x_1) ;
        /*00e0*/                   EXIT ;
"""


def test_sass_step_chain_reads_a_step():
    funcs, labels = sass.parse(STEP_SASS)
    chain = sass.step_chain(funcs["_Z4stepPi"], labels["_Z4stepPi"])
    assert chain == {"shfl": 1, "lds": 0, "alu": 3, "bar": 1, "exchange": "SHFL.UP", "at": 0x10}


def test_sass_step_chain_through_shared_memory():
    """v0's kind of step: the exchange is a shared-memory load whose
    value reaches the next step's loads only through a store and the
    barrier; a loop whose loads feed no store has no chain."""
    lds_step = STEP_SASS.replace("SHFL.UP PT, R4, R2, 0x1, RZ", "LDS R4, [R11]")
    funcs, labels = sass.parse(lds_step)
    chain = sass.step_chain(funcs["_Z4stepPi"], labels["_Z4stepPi"])
    assert (chain["exchange"], chain["lds"], chain["alu"], chain["bar"]) == ("LDS", 1, 3, 1)
    dead = lds_step.replace("STS [R9], R2", "STS [R9], R12").replace(
        "SHFL.UP PT, R4, R2", "SHFL.UP PT, R4, R12")
    funcs, labels = sass.parse(dead.replace("VIMNMX R2, R6, R8, PT", "VIMNMX R13, R6, R8, PT"))
    assert sass.step_chain(funcs["_Z4stepPi"], labels["_Z4stepPi"]) is None


def test_sass_step_chain_spans_one_barrier():
    """A value used only after a second barrier is more than one step:
    no chain."""
    two = STEP_SASS.replace("        /*00c0*/                   LDS R8, [R10] ;\n",
                            "        /*00c0*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;\n"
                            "        /*00c8*/                   LDS R8, [R10] ;\n")
    two = two.replace("STS [R9], R2", "STS [R9], R14")
    funcs, labels = sass.parse(two)
    assert sass.step_chain(funcs["_Z4stepPi"], labels["_Z4stepPi"]) is None


@pytest.mark.parametrize("func,name,want", [
    ("_ZN12_GLOBAL__N_116step_regs_kernelILi6ELi2ELi1ELi0EEEvNS_8StepArgsE", "step_regs_kernel",
     "step_regs_kernel<6, 2, 1, 0>"),
    ("_ZN12_GLOBAL__N_116step_smem_kernelEPKiS1_S1_iiiiiPi", "step_smem_kernel",
     "step_smem_kernel"),
    ("_ZN12_GLOBAL__N_116step_smem_kernelEPKiS1_S1_iiiiiPi", "step_regs_kernel", None),
])
def test_sass_kernel_name_reads_the_template(func, name, want):
    assert sass.kernel_name(func, name) == want


def test_kernels_name_the_instantiations_the_wrappers_launch():
    assert K6.kernel_for("v0", 1536) == K6.SMEM_KERNEL
    assert K6.kernel_for("v3", 1536) == "step_regs_kernel<6, 8, 1, 0>"
    assert K6.kernel_for("v4", 256) == "step_regs_kernel<1, 2, 2, 0>"
    assert K7.kernel_for("g10", 1536) == "step_regs_kernel<6, 2, 1, 0>"
    assert K8.kernel_for("p2", 2048) == "step_regs_kernel<8, 2, 1, 2>"
    assert K6.block_threads(K6.SMEM_KERNEL, 1536) == 768
    assert K6.block_threads(K6.SMEM_KERNEL, 255) == 128
    with pytest.raises(ValueError):
        K6.regs_kernel(1000)


# ------------------------------------------------ the C entry points


def _c_entry_points(path):
    """{name: [P, I or L per parameter]} of the extern "C" functions of
    a CUDA source."""
    src = open(path).read()
    body = src[src.index('extern "C" {'):]
    out = {}
    for m in re.finditer(r"^(?:int|const char\s*\*)\s+(allwave_\w+)\(([^)]*)\)", body, re.M):
        params = [p.strip() for p in m.group(2).split(",") if p.strip()]
        out[m.group(1)] = ["P" if "*" in p else "L" if "long long" in p else "I" for p in params]
    return out


@pytest.mark.parametrize("name", ["dense_forward", "dense_traceback", "dense_span",
                                  "segment_traceback", "wf_span", "wf_traceback",
                                  "probe_forward", "probe_step", "probe_ops", "probe_latency"])
def test_signatures_match_the_c_entry_points(name):
    """ctypes passes each argument as cuda_build.SIGNATURES declares it:
    a pointer where the C function takes one (a 64-bit value), an int
    where it takes an int."""
    from allwave_tpu_torch.wfa import cuda_build

    kind = {ctypes.c_void_p: "P", ctypes.c_int: "I", ctypes.c_longlong: "L"}
    want = {fn: [kind[a] for a in args] for fn, (args, _) in cuda_build.SIGNATURES[name].items()}
    assert _c_entry_points(os.path.join(cuda_build.CSRC, name + ".cu")) == want


def test_step_latency_probe_refuses_the_cpu():
    from allwave_tpu_torch.probes import latency

    with pytest.raises(ValueError, match="CUDA card"):
        latency.step_latency_ns("cpu", (256,))
