"""CUDA Poseidon2 kernels (``csrc/poseidon2.cu``) and their plain versions.

Counterpart of ``plonky2_ecdsa_tpu.hash.poseidon_pallas``:
  * ``permute``  replaces ``_kernel``       (poseidon_pallas.py:93, pallas_call :118);
  * ``sponge``   replaces the same kernel where it was called once per 8
    absorbed columns: the whole overwrite-mode sponge of every leaf in one
    launch, the state in registers over all absorptions;
  * ``grind``    replaces ``_grind_kernel`` (poseidon_pallas.py:144, pallas_call :208).

Each wrapper takes the plain torch version for a CPU tensor; for a CUDA
tensor it launches its kernel or raises.  ``launches`` on each wrapper counts
its kernel launches; ``replayed`` counts the kernel's launches by replays of
a captured prove (``prover/graph.py`` adds each replay's captured launches).  ``field_check`` launches the CUDA source's test entry
(the kernels' field primitives on arrays of operands; CUDA tensors only).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from ..fields import goldilocks as gl
from . import poseidon


@functools.cache
def _lib(device_index: int):
    """The kernel library, its round constants copied to CUDA device
    `device_index` (__constant__ memory is one copy per device)."""
    lib = _build.library()
    rc = np.ascontiguousarray(poseidon.RC_TABLE, dtype=np.uint64)
    diag = np.asarray(poseidon.DIAG_M1, dtype=np.uint32)
    with torch.cuda.device(device_index):
        _build.check(lib.p2_set_constants(rc.ctypes.data, diag.ctypes.data),
                     "poseidon2 constants")
    return lib


def _launch(entry: str, t, *args):
    """Call C entry point `entry` on tensor t's device and current stream."""
    with torch.cuda.device(t.device):
        fn = getattr(_lib(t.device.index), entry)
        _build.check(fn(*args, _build.stream_ptr(t)), entry)


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
        _launch("p2_permute", state, state.data_ptr(), out.data_ptr(), m)
        permute.launches += 1
    return out


permute.launches = 0
permute.replayed = 0


# The sponge's layouts: where the k absorbed words of a leaf lie in the input
# and where its 4 digest words go.
#   "poly":    [..., k, N] -> [..., N, 4]   (a poly-major LDE; leaf j = column j)
#   "leaf":    [..., L, k] -> [..., L, 4]   (leaf-major rows: Merkle pairs, FRI leaves)
#   "stacked": [k, ...]    -> [4, ...]      (hash_no_pad's stacked words)
SPONGE_LAYOUTS = ("poly", "leaf", "stacked")


def _stacked(x, layout: str):
    """x in `layout` as a [k, ...] view."""
    if layout not in SPONGE_LAYOUTS:
        raise ValueError(f"sponge: layout {layout!r} is none of {SPONGE_LAYOUTS}")
    if x.dim() < (1 if layout == "stacked" else 2):
        raise ValueError(f"sponge: layout {layout!r} of a tensor {tuple(x.shape)}")
    return x if layout == "stacked" else x.movedim(-2 if layout == "poly" else -1, 0)


def sponge_plain(x, layout: str):
    """Plain torch overwrite-mode sponge (rate 8, no padding) of every leaf of
    x (see SPONGE_LAYOUTS): one permute_plain per 8 absorbed words."""
    elems = _stacked(x, layout)
    k = elems.shape[0]
    if k == 0:
        raise ValueError("sponge: nothing to absorb")
    state = torch.zeros((poseidon.WIDTH,) + elems.shape[1:], dtype=torch.int64, device=x.device)
    for off in range(0, k, poseidon.RATE):
        chunk = elems[off:off + poseidon.RATE]
        state = poseidon.permute_plain(torch.cat([chunk, state[chunk.shape[0]:]], 0))
    return state[:4] if layout == "stacked" else state[:4].movedim(0, -1).contiguous()


def _poly_strides(x):
    """(batches, batch stride) of a poly-major view [..., k, N]: its leading
    axes must flatten to one stride (a slice of the last axis, as a rank's
    domain slice of an LDE, does)."""
    batches, sb = 1, 0
    for size, stride in reversed(list(zip(x.shape[:-2], x.stride()[:-2]))):
        if size == 1:
            continue
        if batches == 1:
            sb = stride
        elif stride != sb * batches:
            raise ValueError(f"sponge: the leading axes of a view {tuple(x.shape)} with strides "
                             f"{x.stride()} do not flatten to one stride")
        batches *= size
    return batches, sb


def sponge(x, layout: str):
    """sponge_plain's digests: one kernel launch on CUDA, whatever k.  For
    "leaf" and "stacked" x must be contiguous; a "poly" x may be any view
    whose leading axes flatten to one stride: the kernel reads it in place by
    its strides (a rank's domain slice of an LDE is hashed with no copy; the
    kernel takes its 16-byte loads only where the pointer and the strides
    allow them)."""
    _build.check_tensors("poseidon2 sponge", x, contiguous=layout != "poly")
    elems = _stacked(x, layout)
    k = elems.shape[0]
    if k == 0:
        raise ValueError("sponge: nothing to absorb")
    if x.device.type == "cpu":
        return sponge_plain(x, layout)
    # strides in words of (batch, absorbed word, point) and of the digest's
    # (word, leaf); leaf g = batch * points + point
    if layout == "poly":
        points = x.shape[-1]
        batches, sb = _poly_strides(x)
        strides = (sb, x.stride(-2), x.stride(-1), 1, 4)
        out = torch.empty(x.shape[:-2] + (points, 4), dtype=torch.int64, device=x.device)
    elif layout == "leaf":
        batches, points, strides = 1, x.numel() // k, (0, 1, k, 1, 4)
        out = torch.empty(x.shape[:-1] + (4,), dtype=torch.int64, device=x.device)
    else:
        batches, points = 1, x.numel() // k
        strides = (0, points, 1, points, 1)
        out = torch.empty((4,) + x.shape[1:], dtype=torch.int64, device=x.device)
    if points:
        _launch("p2_sponge", x, x.data_ptr(), out.data_ptr(), batches, points, k, *strides)
        sponge.launches += 1
    return out


sponge.launches = 0
sponge.replayed = 0


FIELD_CHECK_ROWS = 12   # csrc/poseidon2.cu's FIELD_CHECK_ROWS: 5 lazy rows, 7 exact ones


def field_check(a, b):
    """Rows of csrc/poseidon2.cu::field_check_kernel for operand tensors a, b
    [n] on a CUDA device: [rows, n] int64 (u64 bit patterns).  The operands
    to run it on and the values to expect are field_check_vectors.py's."""
    _build.check_tensors("poseidon2 field check", a, b)
    if a.device.type != "cuda" or a.shape != b.shape or a.dim() != 1:
        raise ValueError("field_check: needs two CUDA tensors [n]")
    out = torch.empty((FIELD_CHECK_ROWS, a.numel()), dtype=torch.int64, device=a.device)
    _launch("p2_field_check", a, a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel())
    return out


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
        _launch("p2_grind", st, st.data_ptr(), scratch.data_ptr(), B, pow_bits, max_candidates)
        grind.launches += 1
    found = scratch[0] != -1
    return torch.where(found, scratch[0], 0), found


grind.launches = 0
grind.replayed = 0
