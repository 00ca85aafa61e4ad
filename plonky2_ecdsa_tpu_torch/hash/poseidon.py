"""Poseidon2 permutation over Goldilocks, width 12, x^7 S-box, on int64 tensors.

Counterpart of ``plonky2_ecdsa_tpu.hash.poseidon``.  The state is stacked:
one tensor with leading axis 12.  ``permute_stacked`` sends a CUDA state to
the kernel in ``poseidon_cuda`` and a CPU state to ``permute_plain`` below.
The round constants are derived here, by the same Grain-LFSR stream as the
reference; a test holds them against the frozen vectors and the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import goldilocks as gl

WIDTH = 12
RATE = 8
HALF_FULL_ROUNDS = 4
PARTIAL_ROUNDS = 22
TOTAL_ROUNDS = 2 * HALF_FULL_ROUNDS + PARTIAL_ROUNDS  # 30

# Internal-round diagonal mu_i (M_I[i][i] = mu_i, off-diagonal 1).
INTERNAL_DIAG = (2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 22)
DIAG_M1 = [d - 1 for d in INTERNAL_DIAG]


def _gen_round_constants():
    """Grain-LFSR round-constant stream (the Poseidon reference derivation).

    Init sequence: field tag 1 (prime field, 2 bits), sbox tag 0 (x^alpha,
    4 bits), field size 64 (12 bits), t=12 (12 bits), R_F=8 (10 bits),
    R_P=22 (10 bits), then 30 ones; 80-bit LFSR with taps 62,51,38,23,13,0;
    first 160 output bits discarded; shrinking sampler (emit the bit
    following each 1, skip the bit following each 0); 64-bit MSB-first
    candidates rejection-sampled until < p.  Poseidon2 consumes 118 values
    in application order: 4 external rounds x 12, 22 internal rounds x 1,
    4 external rounds x 12."""
    bits = []

    def push(v, w):
        bits.extend((v >> (w - 1 - i)) & 1 for i in range(w))

    push(1, 2)                       # prime field
    push(0, 4)                       # x^alpha S-box
    push(64, 12)                     # field bits
    push(WIDTH, 12)                  # t
    push(2 * HALF_FULL_ROUNDS, 10)   # R_F
    push(PARTIAL_ROUNDS, 10)         # R_P
    bits.extend([1] * 30)
    state = bits[:]
    assert len(state) == 80

    def clock():
        nb = (state[62] ^ state[51] ^ state[38] ^ state[23]
              ^ state[13] ^ state[0])
        state.pop(0)
        state.append(nb)
        return nb

    for _ in range(160):
        clock()

    def next_bit():
        while True:
            if clock() == 1:
                return clock()
            clock()

    out = []
    while len(out) < 2 * HALF_FULL_ROUNDS * WIDTH + PARTIAL_ROUNDS:
        v = 0
        for _ in range(64):
            v = (v << 1) | next_bit()
        if v < gl.P:
            out.append(v)
    return out


def _rc_table():
    """[30, 12] u64 in round order: rows 0-3 and 26-29 external, rows 4-25
    internal with only column 0 set."""
    rc = _gen_round_constants()
    nxt = HALF_FULL_ROUNDS * WIDTH
    table = np.zeros((TOTAL_ROUNDS, WIDTH), dtype=np.uint64)
    for r in range(HALF_FULL_ROUNDS):
        table[r] = rc[r * WIDTH:(r + 1) * WIDTH]
        off = nxt + PARTIAL_ROUNDS + r * WIDTH
        table[HALF_FULL_ROUNDS + PARTIAL_ROUNDS + r] = rc[off:off + WIDTH]
    table[HALF_FULL_ROUNDS:HALF_FULL_ROUNDS + PARTIAL_ROUNDS, 0] = rc[nxt:nxt + PARTIAL_ROUNDS]
    return table


RC_TABLE = _rc_table()


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
