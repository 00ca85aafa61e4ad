"""Poseidon2 permutation over Goldilocks, width 12, x^7 S-box, on int64 tensors.

Counterpart of ``plonky2_ecdsa_tpu.hash.poseidon``.  The state is stacked:
one tensor with leading axis 12.  ``permute_stacked`` sends a CUDA state to
the kernel in ``poseidon_cuda`` and a CPU state to ``permute_plain`` below.
All constants (round constants, M4, the internal diagonal) come from the
reference module, so there is one source of truth.
"""

from __future__ import annotations

import torch

from plonky2_ecdsa_tpu.hash import poseidon as _ref

from ..fields import goldilocks as gl

WIDTH = _ref.WIDTH
RATE = _ref.RATE
HALF_FULL_ROUNDS = _ref.HALF_FULL_ROUNDS
PARTIAL_ROUNDS = _ref.PARTIAL_ROUNDS
TOTAL_ROUNDS = _ref.TOTAL_ROUNDS
RC_TABLE = _ref._RC_TABLE                  # [30, 12] u64, round order
DIAG_M1 = [d - 1 for d in _ref.INTERNAL_DIAG]


def _sbox(x):
    x2 = gl.square(x)
    return gl.mul(gl.square(x2), gl.mul(x2, x))


def _ext_accum(v):
    """External layer circ(2*M4, M4, M4) on halves [12, ...] with no
    reduction: the Poseidon2 paper's M4 schedule per 4-lane group, then
    out_g = y_g + sum_h y_h.  Grows values at most 64x."""
    x = v.reshape((3, 4) + v.shape[1:])
    x0, x1, x2, x3 = x[:, 0], x[:, 1], x[:, 2], x[:, 3]
    t0 = x0 + x1
    t1 = x2 + x3
    t2 = x1 + x1 + t1
    t3 = x3 + x3 + t0
    t4 = t1 * 4 + t3
    t5 = t0 * 4 + t2
    y = torch.stack([t3 + t5, t5, t2 + t4, t4], 1)
    return (y + y.sum(0, keepdim=True)).reshape(v.shape)


def _ext_layer(s):
    return gl.recombine(_ext_accum(s & gl.M32), _ext_accum(gl.shr(s, 32)))


def _int_layer(s):
    """Internal layer ones + diag(mu - 1) on 32-bit halves (sums < 33 * 2^32)."""
    d = torch.tensor(DIAG_M1, dtype=torch.int64, device=s.device)
    d = d.reshape((WIDTH,) + (1,) * (s.dim() - 1))
    lo, hi = s & gl.M32, gl.shr(s, 32)
    return gl.recombine(lo.sum(0, keepdim=True) + lo * d,
                        hi.sum(0, keepdim=True) + hi * d)


def _rc(r, s):
    rc = gl.from_u64(RC_TABLE[r], s.device)
    return rc.reshape((WIDTH,) + (1,) * (s.dim() - 1))


def permute_plain(state):
    """Plain torch Poseidon2 permutation of a [12, ...] int64 state."""
    s = _ext_layer(state)
    r = 0
    for _ in range(HALF_FULL_ROUNDS):
        s = _ext_layer(_sbox(gl.add(s, _rc(r, s))))
        r += 1
    for _ in range(PARTIAL_ROUNDS):
        s0 = _sbox(gl.add(s[0], gl.i64(int(RC_TABLE[r, 0]))))
        s = _int_layer(torch.cat([s0[None], s[1:]], 0))
        r += 1
    for _ in range(HALF_FULL_ROUNDS):
        s = _ext_layer(_sbox(gl.add(s, _rc(r, s))))
        r += 1
    return s


def permute_stacked(state):
    """[12, ...] int64 state -> permuted state (kernel on CUDA)."""
    from .poseidon_cuda import permute

    return permute(state)


def hash_no_pad(elems):
    """Overwrite-mode sponge (rate 8) over elems [k, ...] -> digest [4, ...]."""
    k = elems.shape[0]
    assert k > 0
    state = torch.zeros((WIDTH,) + elems.shape[1:], dtype=torch.int64,
                        device=elems.device)
    for off in range(0, k, RATE):
        chunk = elems[off:off + RATE]
        state = permute_stacked(torch.cat([chunk, state[chunk.shape[0]:]], 0))
    return state[:4]


def two_to_one(left, right):
    """Compress two digests [4, ...] -> digest [4, ...]."""
    return hash_no_pad(torch.cat([left, right], 0))
