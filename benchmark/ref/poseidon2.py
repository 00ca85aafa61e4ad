"""Poseidon2 over Goldilocks (width 12, rate 8, x^7 S-box, 8 full and 22
partial rounds) on numpy, with the sponge, the Merkle-path check and the
Fiat-Shamir challenger that the proofs use.

The round constants come from the Poseidon reference's Grain-LFSR stream
(field tag 1, S-box tag 0, 64-bit field, t = 12, R_F = 8, R_P = 22, 30 ones;
taps 62, 51, 38, 23, 13, 0; 160 bits discarded; shrinking sampler; 64-bit
MSB-first candidates below p).  The external layer is circ(2 M4, M4, M4)
with the Poseidon2 paper's M4, applied once before round 0; the internal
layer is ones + diag(mu - 1), with constants on lane 0 only.
"""

from __future__ import annotations

import numpy as np

from . import field as f

WIDTH, RATE = 12, 8
HALF_FULL, PARTIAL = 4, 22
ROUNDS = 2 * HALF_FULL + PARTIAL
MU = (2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 22)
M4 = ((5, 7, 1, 3), (4, 6, 1, 1), (1, 3, 5, 7), (1, 1, 4, 6))
ME = np.array([[M4[i % 4][j % 4] * (2 if i // 4 == j // 4 else 1) for j in range(WIDTH)]
               for i in range(WIDTH)], np.uint64)
MI = np.array([[1 + (MU[i] - 1 if i == j else 0) for j in range(WIDTH)]
               for i in range(WIDTH)], np.uint64)


def _grain_constants() -> list:
    bits = []

    def push(v, w):
        bits.extend((v >> (w - 1 - i)) & 1 for i in range(w))

    push(1, 2)
    push(0, 4)
    push(64, 12)
    push(WIDTH, 12)
    push(2 * HALF_FULL, 10)
    push(PARTIAL, 10)
    bits.extend([1] * 30)
    state = bits[:]

    def clock():
        nb = state[62] ^ state[51] ^ state[38] ^ state[23] ^ state[13] ^ state[0]
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
    while len(out) < 2 * HALF_FULL * WIDTH + PARTIAL:
        v = 0
        for _ in range(64):
            v = (v << 1) | next_bit()
        if v < f.P:
            out.append(v)
    return out


def _round_constants() -> np.ndarray:
    """[30, 12] in round order; a partial round's row holds lane 0 only."""
    rc = _grain_constants()
    table = np.zeros((ROUNDS, WIDTH), np.uint64)
    first = HALF_FULL * WIDTH
    for r in range(HALF_FULL):
        table[r] = rc[r * WIDTH:(r + 1) * WIDTH]
        off = first + PARTIAL + r * WIDTH
        table[HALF_FULL + PARTIAL + r] = rc[off:off + WIDTH]
    table[HALF_FULL:HALF_FULL + PARTIAL, 0] = rc[first:first + PARTIAL]
    return table


RC = _round_constants()


def _linear(M, s):
    """M [12, 12] of small integers times the state [12, ...] mod p."""
    lo, hi = s & f._M32, s >> f._S32
    flat = (WIDTH, -1)
    lo_acc = (M @ lo.reshape(flat)).reshape(s.shape)
    hi_acc = (M @ hi.reshape(flat)).reshape(s.shape)
    return f.recombine(lo_acc, hi_acc)


def _sbox(x):
    x2 = f.mul(x, x)
    return f.mul(f.mul(x2, x2), f.mul(x2, x))


def permute(state: np.ndarray) -> np.ndarray:
    """[12, ...] uint64 -> the permuted state."""
    s = _linear(ME, state)
    shape = (WIDTH,) + (1,) * (s.ndim - 1)
    for r in range(ROUNDS):
        if HALF_FULL <= r < HALF_FULL + PARTIAL:
            s = s.copy()
            s[0] = _sbox(f.add(s[0], RC[r, 0]))
            s = _linear(MI, s)
        else:
            s = _linear(ME, _sbox(f.add(s, RC[r].reshape(shape))))
    return s


def hash_no_pad(elems: np.ndarray) -> np.ndarray:
    """Overwrite-mode sponge over elems [k, ...] -> digest [4, ...]."""
    state = np.zeros((WIDTH,) + elems.shape[1:], np.uint64)
    for off in range(0, elems.shape[0], RATE):
        chunk = elems[off:off + RATE]
        state = permute(np.concatenate([chunk, state[chunk.shape[0]:]], 0))
    return state[:4]


def merkle_ok(leaf, idx, path, cap):
    """leaf [..., k]; idx [...]; path [..., depth, 4]; cap [..., C, 4] whose
    leading axes are those of idx's first axis, or [C, 4] -> bool [...]."""
    cur = hash_no_pad(np.moveaxis(leaf, -1, 0))
    i = idx.astype(np.int64)
    for d in range(path.shape[-2]):
        bit = (i & 1).astype(bool)
        sib = np.moveaxis(path[..., d, :], -1, 0)
        cur = hash_no_pad(np.concatenate([np.where(bit, sib, cur), np.where(bit, cur, sib)], 0))
        i = i >> 1
    if cap.ndim == 2:
        sel = cap[i]
    else:
        lead = np.arange(cap.shape[0]).reshape((-1,) + (1,) * (i.ndim - 1))
        sel = cap[lead, i]
    return (np.moveaxis(cur, 0, -1) == sel).all(-1)


class Challenger:
    """Duplex sponge in overwrite mode, rate 8, over a batch of lanes [L]:
    observed values overwrite the state's first words; a permutation runs
    when 8 are pending or a challenge is drawn; challenges are taken from
    the rate part, last word first."""

    def __init__(self, lanes: int):
        self.lanes = lanes
        self.state = np.zeros((WIDTH, lanes), np.uint64)
        self.inputs: list = []
        self.outputs: list = []

    def observe(self, x):
        self.inputs.append(np.broadcast_to(np.asarray(x, np.uint64), (self.lanes,)))
        self.outputs = []
        if len(self.inputs) == RATE:
            self._duplex()

    def observe_array(self, a):
        """a [L, K] (or [K], the same for every lane)."""
        for i in range(a.shape[-1]):
            self.observe(a[..., i])

    def observe_cap(self, cap):
        self.observe_array(cap.reshape(cap.shape[:-2] + (-1,)))

    def observe_ext_array(self, e):
        self.observe_array(np.stack([e[0], e[1]], -1).reshape(e[0].shape[:-1] + (-1,)))

    def _duplex(self):
        k = len(self.inputs)
        if k:
            self.state = np.concatenate([np.stack(self.inputs), self.state[k:]], 0)
        self.state = permute(self.state)
        self.inputs = []
        self.outputs = list(self.state[:RATE])

    def challenge(self):
        if self.inputs or not self.outputs:
            self._duplex()
        return self.outputs.pop()

    def ext_challenge(self):
        a = self.challenge()
        return (a, self.challenge())

    def pow_ok(self, witness, bits: int):
        """Absorb the witness; True per lane where the response's top `bits`
        bits are zero."""
        if self.inputs:
            self._duplex()
        self.observe(witness)
        return (self.challenge() >> np.uint64(64 - bits)) == 0
