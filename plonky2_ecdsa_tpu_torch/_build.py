"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

At first use, every ``csrc/*.cu`` is compiled for ``sm_90a`` into one shared
library with a plain C interface, named by a hash of the sources and flags,
under ``build/`` beside this file.  A library already built from the same
sources is loaded as it is.  The kernels launch on the stream the caller
passes, and each C entry point returns ``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "p2_set_constants": [_P, _P],
    "p2_permute": [_P, _P, _LL, _P],
    "p2_grind": [_P, _P, _I, _I, _LL, _P],
    "ntt_sub": [_P, _P, _P, _P, _P, _LL, _I, _I, _LL, _I, _P],
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> str:
    """Path of the built library, compiling it first if it is missing."""
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(glob.glob(os.path.join(CSRC, "*"))):
        with open(f, "rb") as fh:
            h.update(os.path.basename(f).encode() + fh.read())
    path = os.path.join(BUILD, f"libkernels_{h.hexdigest()[:16]}.so")
    if not os.path.exists(path):
        os.makedirs(BUILD, exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, path)
    return path


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


def check_tensors(what: str, *tensors):
    """Every tensor int64, contiguous, and on the CPU or a CUDA device."""
    import torch

    for t in tensors:
        if t.dtype != torch.int64 or not t.is_contiguous() or t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{what}: needs contiguous int64 CPU or CUDA tensors, got "
                             f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
        if t.device != tensors[0].device:
            raise ValueError(f"{what}: tensors on {t.device} and {tensors[0].device}")
