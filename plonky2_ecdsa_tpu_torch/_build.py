"""Builds the package's CUDA kernels with nvcc and loads them with ctypes.

At first use, every ``csrc/*.cu`` is compiled for ``sm_90a`` (one nvcc per
source, all started together) and the objects are linked into one shared
library with a plain C interface, named by a hash of the sources and flags,
under ``build/`` beside this file.  A library already built from the same
sources is loaded as it is.  What ptxas reports (registers, shared memory,
spills of each kernel) is kept beside the library as ``*.ptxas.txt``.  The
kernels launch on the stream the caller passes, and each C entry point
returns ``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import re
import shutil
import subprocess

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
NVCC_FLAGS = [*ARCH_FLAGS, "-Xptxas", "-v", "-Xcompiler", "-fPIC"]

_P, _I, _LL, _ULL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_ulonglong
_LLP = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    "p2_set_constants": [_P, _P],
    "p2_permute": [_P, _P, _LL, _P],
    "p2_sponge": [_P, _P, _LL, _LL, _I, _LL, _LL, _LL, _LL, _LL, _P],
    "p2_field_check": [_P, _P, _P, _LL, _P],
    "p2_grind": [_P, _P, _I, _I, _LL, _P],
    "ntt_sub": [_P, _P, _P, _P, _P, _LL, _I, _I, _LL, _I, _P],
    "trace_stamp": [_P, _I, _P],
    "gl_binary": [_I, _P, _LLP, _ULL, _P, _LLP, _ULL, _P, _LLP, _I, _P],
    "gl_reduce": [_P, _LLP, _P, _LLP, _LL, _P, _LLP, _I, _P],
    "fri_reduced": [_P, _P],
}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        with open(f, "rb") as fh:
            h.update(os.path.basename(f).encode() + fh.read())
    return h.hexdigest()[:16]


def run_all(commands):
    """Start every command at once; raise with the output of the first that fails.
    Returns the commands' stderr + stdout texts."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in commands]
    outs = [p.communicate()[0] for p in procs]
    for c, p, out in zip(commands, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"{' '.join(c)} failed:\n{out}")
    return outs


def library_path() -> str:
    """Path of the built library, compiling it first if it is missing."""
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    path = os.path.join(BUILD, f"libkernels_{_source_hash()}.so")
    if not os.path.exists(path):
        os.makedirs(BUILD, exist_ok=True)
        cc = nvcc()
        tmp = f"{path}.tmp{os.getpid()}"
        objs = [f"{tmp}.{os.path.basename(s)}.o" for s in srcs]
        logs = run_all([[cc, *NVCC_FLAGS, "-c", "-o", o, s] for s, o in zip(srcs, objs)])
        run_all([[cc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]])
        with open(ptxas_log_path(path), "w") as f:
            f.write("".join(logs))
        for o in objs:
            os.remove(o)
        os.replace(tmp, path)
    return path


def ptxas_log_path(lib_path: str | None = None) -> str:
    """The file that holds ptxas's report for the built library."""
    return (lib_path or library_path())[:-3] + ".ptxas.txt"


def kernel_resources() -> dict:
    """{kernel name fragment: (registers, spill store bytes, spill load bytes)}
    from ptxas's report of the built library."""
    with open(ptxas_log_path()) as f:
        text = f.read()
    out = {}
    for m in re.finditer(r"Compiling entry function '(\w+)' for 'sm_90a'(.*?)Used (\d+) registers",
                         text, re.S):
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", m.group(2))
        out[m.group(1)] = (int(m.group(3)),) + tuple(int(v) for v in spills.groups())
    return out


@functools.cache
def library():
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(library_path())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.kernels_error_string.argtypes = [ctypes.c_int]
    lib.kernels_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, what: str):
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = library().kernels_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_ptr(t) -> int:
    """The current CUDA stream of tensor t's device, as an integer handle."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check_tensors(what: str, *tensors, contiguous: bool = True):
    """Every tensor int64, on the CPU or a CUDA device, and contiguous unless
    the kernel reads it by the caller's strides (contiguous=False)."""
    import torch

    for t in tensors:
        if (t.dtype != torch.int64 or (contiguous and not t.is_contiguous())
                or t.device.type not in ("cpu", "cuda")):
            raise ValueError(f"{what}: needs {'contiguous ' if contiguous else ''}int64 CPU or "
                             f"CUDA tensors, got {t.dtype} on {t.device} "
                             f"(contiguous={t.is_contiguous()})")
        if t.device != tensors[0].device:
            raise ValueError(f"{what}: tensors on {t.device} and {tensors[0].device}")
