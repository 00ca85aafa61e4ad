"""Goldilocks field GF(p), p = 2^64 - 2^32 + 1, on numpy uint64 arrays.

The host's field: circuit building, witness generation and the constraint
check run in numpy, where u64 lanes exist.  Counterpart of the numpy paths of
``plonky2_ecdsa_tpu.fields.goldilocks`` and of the ``g*`` helpers of its
``circuit.witness``; an element is one ``np.uint64`` value (no (lo, hi) pair).
Everything the prover or verifier computes over the domain uses the torch
field in ``goldilocks`` instead.  All results are canonical (< p).
"""

from __future__ import annotations

import numpy as np

P = (1 << 64) - (1 << 32) + 1
MULTIPLICATIVE_GROUP_GENERATOR = 7
TWO_ADICITY = 32
POWER_OF_TWO_GENERATOR = pow(7, (P - 1) >> 32, P)   # order 2^32
W_EXT = 7                                            # GF(p^2) = GF(p)[x] / (x^2 - 7)

_P64 = np.uint64(P)
_EPS = np.uint64(0xFFFFFFFF)
_M32 = np.uint64(0xFFFFFFFF)
_S32 = np.uint64(32)
# Wrap-around u64 arithmetic is intended.  numpy warns of it for 0-d operands
# only, and keeps its error state per thread, so each function that wraps
# sets the state for its own call (a fresh errstate each time: one instance
# is not safe across threads in every numpy version).


def root_of_unity(n: int) -> int:
    """The generator of the subgroup of order n (a power of two)."""
    assert n & (n - 1) == 0 and n <= 1 << TWO_ADICITY
    return pow(POWER_OF_TWO_GENERATOR, (1 << TWO_ADICITY) // n, P)


def geometric(first: int, ratio: int, n: int) -> np.ndarray:
    """[first * ratio^i for i < n] as u64."""
    out = np.zeros(n, dtype=np.uint64)
    acc = first % P
    for i in range(n):
        out[i] = acc
        acc = acc * ratio % P
    return out


def add(a, b):
    with np.errstate(over="ignore"):
        s = a + b
        s = s + (s < a) * _EPS  # cannot wrap again
        return np.where(s >= _P64, s - _P64, s)


def sub(a, b):
    with np.errstate(over="ignore"):
        return (a - b) - (a < b) * _EPS


def neg(a):
    return np.where(a == 0, a, _P64 - a)


def mul(a, b):
    a0, a1 = a & _M32, a >> _S32
    b0, b1 = b & _M32, b >> _S32
    with np.errstate(over="ignore"):
        ll = a0 * b0
        mid = a0 * b1
        mid2 = a1 * b0
        mid = mid + mid2
        midc = (mid < mid2).astype(np.uint64)  # carry into bit 96
        hh = a1 * b1
        lo = ll + (mid << _S32)
        c = (lo < ll).astype(np.uint64)
        hi = hh + (mid >> _S32) + (midc << _S32) + c
        # 128 -> 64 bits: lo + (hi & M32) * EPS - (hi >> 32)
        b96 = hi >> _S32
        t = lo - b96
        t = t - (lo < b96) * _EPS
        u = (hi & _M32) * _EPS
        r = t + u
        r = r + (r < u) * _EPS
        return np.where(r >= _P64, r - _P64, r)


def mul_const(a, c: int):
    c %= P
    if c == 0:
        return np.zeros_like(a)
    if c == 1:
        return a.copy()
    return mul(a, np.uint64(c))


def pow_const(a, e: int):
    r = np.ones_like(a)
    base = a
    while e:
        if e & 1:
            r = mul(r, base)
        e >>= 1
        if e:
            base = mul(base, base)
    return r


def inverse(a):
    """Elementwise a^(p-2); the inverse of 0 is 0."""
    return pow_const(a, P - 2)
