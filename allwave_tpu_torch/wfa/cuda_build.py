"""Build and load the hand-written CUDA kernels.

Each `csrc/*.cu` source of this package is compiled on first use by
`nvcc` into a shared library with a plain C interface and loaded with
ctypes. The library's file name carries a hash of its source, of the
headers of csrc/ and of the compile flags, so an edited source is
rebuilt and an unchanged one is reused. Builds go to `allwave_tpu_torch/_build/` (git-ignored) and are
only ever made from the sources in this package.

Every C entry point takes raw pointers and the CUDA stream as
`void*` (declared `c_void_p` here: a 64-bit pointer passed as a plain
Python int would be cut to 32 bits) and returns `cudaGetLastError()`
after its launch; `check()` raises on a non-zero code.

nvcc runs with `-Xptxas -v`; what it prints is kept beside each library
(`lib<name>-<hash>.log`), and `ptxas_usage()` reads every kernel's
registers and spill bytes from it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = [
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

#: C signatures: name -> (argtypes, restype), per source
SIGNATURES = {
    "dense_forward": {
        "allwave_dense_forward": ([_P] * 4 + [_I] * 10 + [_P] * 4, _I),
        "allwave_dense_forward_design": ([_I, _I, _I], _I),
        "allwave_dense_forward_finish": ([_P, _P] + [_I] * 8 + [_P] * 4, _I),
        "allwave_cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "dense_traceback": {
        "allwave_dense_traceback": ([_P] * 5 + [_I] * 4 + [_P] * 3, _I),
    },
    "dense_span": {
        "allwave_dense_span": (
            [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
             _I, _I, _I, _P, _L, _P, _L, _P, _P],
            _I,
        ),
        "allwave_dense_span_design": ([_I] * 5, _I),
        "allwave_dense_span_max_clusters": ([_I] * 5, _I),
        "allwave_dense_sweep_barriers": ([_I, _I, _I, _I, _I, _P, _P], _I),
    },
    "segment_traceback": {
        "allwave_segment_traceback": (
            [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P, _I, _P],
            _I,
        ),
        "allwave_segment_traceback_design": ([_I, _I], _I),
    },
    "wf_span": {
        "allwave_wf_span": ([_P] * 5 + [_I] * 25 + [_P] * 8, _I),
        "allwave_wf_span_design": ([_I] * 6 + [_P], _I),
    },
    "wf_traceback": {
        "allwave_wf_traceback": (
            [_P, _I, _I, _I, _P, _I, _P] + [_I] * 17 + [_P] * 5 + [_I, _P, _I, _I, _P],
            _I,
        ),
        "allwave_wf_traceback_design": ([_I, _I], _I),
    },
    "wf_batch": {
        "allwave_wf_batch_forward": ([_P] * 4 + [_I] * 13 + [_P] * 5, _I),
        "allwave_wf_batch_forward_design": ([_I] * 8 + [_P], _I),
        "allwave_wf_batch_tier": ([_I] * 9, _I),
        "allwave_wf_batch_traceback": ([_P] * 8 + [_I] * 10 + [_P] * 6, _I),
    },
    # the probes of allwave_tpu_torch/probes (no production path)
    "probe_forward": {
        "allwave_probe_forward": ([_P] * 4 + [_I] * 10 + [_P] * 4, _I),
    },
    "probe_step": {
        "allwave_probe_step_smem": ([_P] * 3 + [_I] * 6 + [_P] * 2, _I),
        "allwave_probe_step_regs": (
            [_P] * 3 + [_I] * 10 + [_P] * 3 + [_I] * 2 + [_P, _I] + [_P] * 3,
            _I,
        ),
    },
    "probe_ops": {
        "allwave_probe_ops": ([_P] * 2 + [_I] * 10 + [_P], _I),
    },
    "probe_latency": {
        "allwave_probe_latency": ([_I, _I, _I, _P, _P], _I),
        "allwave_probe_dram": ([_P, _I, _I, _P, _P], _I),
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: seconds spent in nvcc by this process, per source
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # the source and every header of csrc/ it may include
    for path in [os.path.join(CSRC, name + ".cu")] + sorted(
            os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")):
        with open(path, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _log_path(so: str) -> str:
    return so[: -len(".so")] + ".log"


def _build(names) -> None:
    """Compile every named source whose library is missing, one nvcc
    process each, all started together. Call with _lock held."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in names:
        so = _library_path(name)
        if os.path.exists(so):
            continue
        src = os.path.join(CSRC, name + ".cu")
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        procs.append((name, src, so, tmp, proc, time.perf_counter()))
    failed = []
    for name, src, so, tmp, proc, t0 in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src} (exit {proc.returncode}):\n{out}\n{err}")
            continue
        with open(_log_path(so), "w") as f:
            f.write(out + err)
        os.replace(tmp, so)
        build_seconds[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))


def build_all() -> None:
    """Build every kernel library of the package at once."""
    with _lock:
        _build(sorted(SIGNATURES))


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library built from `csrc/<name>.cu`."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        _build([name])
        lib = ctypes.CDLL(_library_path(name))
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _libs[name] = lib
        return lib


_PTXAS_FUNC = re.compile(r"(?:Compiling entry function '|Function properties for )([^'\s]+)")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")
_PTXAS_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")


def ptxas_usage(name: str) -> Dict[str, dict]:
    """{kernel: {"registers", "stack", "spill_stores", "spill_loads"}}
    for every kernel of `csrc/<name>.cu`, from the build's ptxas report
    (names demangled by cu++filt where the toolkit has it)."""
    library(name)
    with open(_log_path(_library_path(name))) as f:
        log = f.read()
    usage: Dict[str, dict] = {}
    cur = None
    for line in log.splitlines():
        m = _PTXAS_FUNC.search(line)
        if m:
            cur = usage.setdefault(m.group(1), {})
        elif cur is not None:
            m = _PTXAS_REGS.search(line)
            if m:
                cur["registers"] = int(m.group(1))
            m = _PTXAS_SPILL.search(line)
            if m:
                cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
    filt = os.path.join(os.path.dirname(_nvcc()), "cu++filt")
    names = list(usage)
    if names and os.path.exists(filt):
        out = subprocess.run([filt], input="\n".join(names), capture_output=True,
                             text=True, check=True).stdout.splitlines()
        if len(out) == len(names):
            return {new: usage[old] for old, new in zip(names, out)}
    return usage


def check(rc: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if rc != 0:
        msg = library("dense_forward").allwave_cuda_error_string(rc)
        raise RuntimeError(
            f"{what}: CUDA error {rc} ({msg.decode() if msg else '?'})"
        )
