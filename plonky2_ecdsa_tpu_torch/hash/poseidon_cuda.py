"""CUDA Poseidon2 kernels (``csrc/poseidon2.cu``) and their plain versions.

Counterpart of ``plonky2_ecdsa_tpu.hash.poseidon_pallas``:
  * ``permute``  replaces ``_kernel``       (poseidon_pallas.py:93, pallas_call :118);
  * ``grind``    replaces ``_grind_kernel`` (poseidon_pallas.py:144, pallas_call :208).

Each wrapper takes the plain torch version for a CPU tensor; for a CUDA
tensor it launches its kernel or raises.  ``launches`` on each wrapper counts
its kernel launches.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from ..fields import goldilocks as gl
from . import poseidon


@functools.cache
def _lib():
    lib = _build.library()
    rc = np.ascontiguousarray(poseidon.RC_TABLE, dtype=np.uint64)
    diag = np.asarray(poseidon.DIAG_M1, dtype=np.uint64)
    _build.check(lib.p2_set_constants(rc.ctypes.data, diag.ctypes.data),
                 "poseidon2 constants")
    return lib


def permute(state):
    """Poseidon2 permutation of a [12, ...] int64 state."""
    _build.check_tensors("poseidon2 permute", state)
    if state.shape[0] != poseidon.WIDTH:
        raise ValueError(f"state needs leading axis {poseidon.WIDTH}, got {tuple(state.shape)}")
    if state.device.type == "cpu":
        return poseidon.permute_plain(state)
    out = torch.empty_like(state)
    m = state.numel() // poseidon.WIDTH
    if m:
        _build.check(_lib().p2_permute(state.data_ptr(), out.data_ptr(), m,
                                       _build.stream_ptr(state)), "poseidon2 permute")
        permute.launches += 1
    return out


permute.launches = 0


def grind_plain(state, pow_bits: int, max_candidates: int):
    """Per lane of a [12, B] duplex state, the first candidate c (counting up
    from 0, c < max_candidates) for which permuting the state with word 0 set
    to c leaves the top pow_bits bits of word 7 zero.  Returns (w, found),
    both [B]; w is 0 where no candidate below the cap hits."""
    B = state.shape[1]
    dev = state.device
    w = torch.zeros(B, dtype=torch.int64, device=dev)
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    M = 1 << min(14, pow_bits + 1)   # candidates per sweep; a lane hits ~once in 2^pow_bits
    for base in range(0, max_candidates, M):
        if bool(found.all()):
            break
        m = min(M, max_candidates - base)
        s = state[:, :, None].expand(poseidon.WIDTH, B, m).clone()
        s[0] = torch.arange(base, base + m, dtype=torch.int64, device=dev)
        ok = gl.shr(poseidon.permute_plain(s)[7], 64 - pow_bits) == 0   # [B, m]
        hit = ok.any(-1)
        first = base + ok.long().argmax(-1)
        w = torch.where(~found & hit, first, w)
        found |= hit
    return w, found


def grind(state, pow_bits: int, max_candidates: int):
    """grind_plain's (w, found) for a [12, B] state: the kernel on CUDA."""
    _build.check_tensors("poseidon2 grind", state)
    if state.dim() != 2 or state.shape[0] != poseidon.WIDTH:
        raise ValueError(f"grind: state needs shape [12, B], got {tuple(state.shape)}")
    if not (0 < pow_bits <= 32 and 0 < max_candidates < (1 << 31)):
        raise ValueError(f"grind: pow_bits={pow_bits}, max_candidates={max_candidates}")
    if state.device.type == "cpu":
        return grind_plain(state, pow_bits, max_candidates)
    st = state
    B = st.shape[1]
    # row 0: each lane's first hit (all-ones: none); row 1: its ticket counter
    scratch = torch.full((2, B), -1, dtype=torch.int64, device=st.device)
    if B:
        with torch.cuda.device(st.device):
            _build.check(_lib().p2_grind(st.data_ptr(), scratch.data_ptr(), B, pow_bits,
                                         max_candidates, _build.stream_ptr(st)),
                         "poseidon2 grind")
        grind.launches += 1
    found = scratch[0] != -1
    return torch.where(found, scratch[0], 0), found


grind.launches = 0
