"""Goldilocks field GF(p), p = 2^64 - 2^32 + 1, and its quadratic extension
GF(p)[x] / (x^2 - 7), on numpy uint64 arrays of canonical values.

Plain arithmetic written for the benchmark's reference: a 64 x 64 product is
four 32 x 32 products and plonky2's reduction of a 128-bit value.  Extension
elements are (c0, c1) pairs of arrays.
"""

from __future__ import annotations

import numpy as np

P = (1 << 64) - (1 << 32) + 1
W_EXT = 7
MULTIPLICATIVE_GROUP_GENERATOR = 7
TWO_ADICITY = 32
POWER_OF_TWO_GENERATOR = pow(7, (P - 1) >> 32, P)

_P = np.uint64(P)
_EPS = np.uint64(0xFFFFFFFF)       # 2^64 mod p
_M32 = np.uint64(0xFFFFFFFF)
_S32 = np.uint64(32)


def root_of_unity(n: int) -> int:
    """The generator of the subgroup of order n (a power of two)."""
    assert n & (n - 1) == 0 and n <= 1 << TWO_ADICITY
    return pow(POWER_OF_TWO_GENERATOR, (1 << TWO_ADICITY) // n, P)


def arr(x) -> np.ndarray:
    """Python ints or an array -> uint64 array of canonical values."""
    if isinstance(x, np.ndarray) and x.dtype == np.uint64:
        return x
    if isinstance(x, (int, np.integer)):
        return np.array(int(x) % P, np.uint64)
    return np.array([int(v) % P for v in np.ravel(x)], np.uint64).reshape(np.shape(x))


def add(a, b):
    with np.errstate(over="ignore"):
        s = a + b
        s = np.where(s < a, s + _EPS, s)       # a carry out of 2^64 is worth 2^32 - 1
        return np.where(s >= _P, s - _P, s)


def sub(a, b):
    with np.errstate(over="ignore"):
        d = a - b
        return np.where(a < b, d - _EPS, d)


def neg(a):
    return sub(np.zeros_like(a), a)


def reduce128(hi, lo):
    """(hi 2^64 + lo) mod p, canonical."""
    with np.errstate(over="ignore"):
        hh, hl = hi >> _S32, hi & _M32
        t0 = lo - hh
        t0 = np.where(lo < hh, t0 - _EPS, t0)
        t1 = hl * _EPS
        t2 = t0 + t1
        t2 = np.where(t2 < t1, t2 + _EPS, t2)
        return np.where(t2 >= _P, t2 - _P, t2)


def mul(a, b):
    with np.errstate(over="ignore"):
        a0, a1 = a & _M32, a >> _S32
        b0, b1 = b & _M32, b >> _S32
        ll, lh, hl, hh = a0 * b0, a0 * b1, a1 * b0, a1 * b1
        mid = lh + hl
        c1 = (mid < lh).astype(np.uint64)
        lo = ll + (mid << _S32)
        c2 = (lo < ll).astype(np.uint64)
        hi = hh + (mid >> _S32) + (c1 << _S32) + c2
        return reduce128(hi, lo)


def recombine(lo_acc, hi_acc):
    """(lo_acc + hi_acc 2^32) mod p for sums of 32-bit halves below 2^63."""
    with np.errstate(over="ignore"):
        low = lo_acc + (hi_acc << _S32)
        carry = (low < lo_acc).astype(np.uint64)
        return reduce128((hi_acc >> _S32) + carry, low)


def pow_const(a, e: int):
    r = np.ones_like(a)
    while e:
        if e & 1:
            r = mul(r, a)
        e >>= 1
        if e:
            a = mul(a, a)
    return r


def inverse(a):
    return pow_const(a, P - 2)


def sum_mod(a, axis):
    """Sum along `axis` mod p (pairwise adds)."""
    a = np.moveaxis(a, axis, 0)
    acc = np.zeros(a.shape[1:], np.uint64)
    for row in a:
        acc = add(acc, row)
    return acc


# ---------------------------------------------------------------- extension
def ext(c0, c1=None):
    c0 = arr(c0)
    return (c0, np.zeros_like(c0) if c1 is None else arr(c1))


def ext_add(a, b):
    return (add(a[0], b[0]), add(a[1], b[1]))


def ext_sub(a, b):
    return (sub(a[0], b[0]), sub(a[1], b[1]))


def ext_neg(a):
    return (neg(a[0]), neg(a[1]))


def ext_mul(a, b):
    return (add(mul(a[0], b[0]), mul(mul(a[1], b[1]), np.uint64(W_EXT))),
            add(mul(a[0], b[1]), mul(a[1], b[0])))


def ext_scalar(a, s):
    return (mul(a[0], s), mul(a[1], s))


def ext_inverse(a):
    d = sub(mul(a[0], a[0]), mul(mul(a[1], a[1]), np.uint64(W_EXT)))
    di = inverse(d)
    return (mul(a[0], di), mul(neg(a[1]), di))


def ext_pow_const(a, e: int):
    r = (np.ones_like(a[0]), np.zeros_like(a[1]))
    while e:
        if e & 1:
            r = ext_mul(r, a)
        e >>= 1
        if e:
            a = ext_mul(a, a)
    return r


def ext_eq(a, b):
    return (a[0] == b[0]) & (a[1] == b[1])


class ExtAlgebra:
    """The algebra a gate's constraints are written against, over extension
    elements of a fixed batch shape (the verifier's point zeta, per lane)."""

    def __init__(self, shape):
        self.shape = tuple(shape)

    def const(self, c: int):
        z = np.zeros(self.shape, np.uint64)
        return (z + np.uint64(c % P), z)

    def zero(self):
        return self.const(0)

    def one(self):
        return self.const(1)

    def add(self, a, b):
        return ext_add(a, b)

    def sub(self, a, b):
        return ext_sub(a, b)

    def neg(self, a):
        return ext_neg(a)

    def mul(self, a, b):
        return ext_mul(a, b)

    def mul_const(self, a, c: int):
        return ext_scalar(a, np.uint64(c % P))

    def add_const(self, a, c: int):
        return (add(a[0], np.uint64(c % P)), a[1])
