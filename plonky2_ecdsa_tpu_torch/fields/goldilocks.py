"""Goldilocks field GF(p), p = 2^64 - 2^32 + 1, on int64 tensors.

Counterpart of ``plonky2_ecdsa_tpu.fields.goldilocks``.  An element is ONE
``torch.int64`` tensor holding the u64 bit pattern of its canonical value
(the reference carries a ``(lo, hi)`` u32 pair, which the TPU forced; this
package has no pairs).  The numpy host field is ``goldilocks_host``.

PyTorch has no add, shift or compare on unsigned 64-bit tensors, so:
  * an unsigned compare is a signed compare after XOR with the sign bit;
  * a logical right shift is an arithmetic shift followed by a mask;
  * the 64x64 -> 128 product is built from 32-bit halves.
int64 add, sub, mul and left shift wrap modulo 2^64 on both CPU and CUDA,
which is the u64 arithmetic the reduction needs.  Every function returns
canonical values (< p) for canonical inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .goldilocks_host import (MULTIPLICATIVE_GROUP_GENERATOR, P,  # noqa: F401
                              POWER_OF_TWO_GENERATOR, TWO_ADICITY, W_EXT, root_of_unity)

M32 = 0xFFFFFFFF
EPS = M32                      # 2^64 mod p; also (x - p) mod 2^64 == x + EPS
_SIGN = -(1 << 63)


def i64(v: int) -> int:
    """A u64 value (any Python int, taken mod p) as its int64 bit pattern."""
    v %= P
    return v - (1 << 64) if v >= 1 << 63 else v


_P_I64 = P - (1 << 64)          # p's bit pattern
_P_FLIP = _P_I64 ^ _SIGN         # ... with the sign bit flipped, for compares


def shr(x, k: int):
    """Logical right shift of the u64 pattern by 0 < k < 64."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def ult(a, b):
    """Unsigned a < b on u64 bit patterns."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _canon(s):
    """s in [0, 2^64) -> s mod p (one conditional subtraction)."""
    return torch.where((s ^ _SIGN) >= _P_FLIP, s + EPS, s)


def add(a, b):
    s = a + b
    # on carry the true sum is s + 2^64 and s + EPS == sum - p < p
    return torch.where(ult(s, a) | ((s ^ _SIGN) >= _P_FLIP), s + EPS, s)


def sub(a, b):
    d = a - b
    # on borrow the wrapped value is a - b + 2^64 == a - b + EPS (mod p)
    return torch.where(ult(a, b), d - EPS, d)


def neg(a):
    return torch.where(a == 0, a, _P_I64 - a)


def _mulhilo(a, b):
    """Full 64x64 -> (hi, lo) product of u64 patterns; b may be a Python int."""
    al = a & M32
    ah = shr(a, 32)
    if isinstance(b, int):
        bl, bh = b & M32, b >> 32
    else:
        bl, bh = b & M32, shr(b, 32)
    ll = al * bl
    mid = al * bh + shr(ll, 32)           # < 2^64, no wrap
    mid2 = ah * bl + (mid & M32)           # < 2^64, no wrap
    lo = (ll & M32) | (mid2 << 32)
    hi = ah * bh + shr(mid, 32) + shr(mid2, 32)
    return hi, lo


def reduce128(hi, lo):
    """(hi * 2^64 + lo) mod p via 2^64 = 2^32 - 1 and 2^96 = -1 (mod p)."""
    r2 = hi & M32
    r3 = shr(hi, 32)
    t = lo - r3
    t = torch.where(ult(lo, r3), t - EPS, t)
    s = t + ((r2 << 32) - r2)
    return _canon(torch.where(ult(s, t), s + EPS, s))


def recombine(qlo, qhi):
    """Non-negative half-sums (qlo + 2^32 qhi, each < 2^63) -> canonical."""
    lo = qlo + (qhi << 32)
    top = (((qlo >> 32) + (qhi & M32)) >> 32) + (qhi >> 32)
    return reduce128(top, lo)


def mul(a, b):
    """(a * b) mod p; b may be a tensor or a canonical Python int."""
    if isinstance(b, int):
        b = i64(b) & ((1 << 64) - 1)
    return reduce128(*_mulhilo(a, b))


def mul_small(a, c: int):
    return mul(a, c % P)


def square(a):
    return mul(a, a)


def pow_const(a, e: int):
    r = torch.ones_like(a)
    base = a
    while e:
        if e & 1:
            r = mul(r, base)
        e >>= 1
        if e:
            base = square(base)
    return r


def inverse(a):
    """a^(p-2); the inverse of 0 is 0 (callers guard)."""
    return pow_const(a, P - 2)


def powers(a, n: int):
    """[1, a, ..., a^(n-1)] along a NEW last axis (log-depth doubling)."""
    out = torch.ones_like(a)[..., None]
    p = a[..., None]
    while out.shape[-1] < n:
        out = torch.cat([out, mul(out, p)], -1)
        p = square(p)
    return out[..., :n]


def sum_mod(x, dim: int):
    """Sum over `dim` mod p (exact: 32-bit halves summed in int64)."""
    return recombine((x & M32).sum(dim), shr(x, 32).sum(dim))


def cumsum_mod(x, dim: int):
    """Inclusive prefix sum over `dim` mod p."""
    return recombine((x & M32).cumsum(dim), shr(x, 32).cumsum(dim))


def const(c: int, shape=(), device="cpu"):
    return torch.full(shape, i64(c), dtype=torch.int64, device=device)


# ---------------------------------------------------------------------------
# Conversions: int64 tensor <-> numpy u64
# ---------------------------------------------------------------------------

def from_u64(arr, device="cpu"):
    """numpy uint64 array (values < p) -> int64 tensor on `device`."""
    a = np.array(arr, dtype=np.uint64, order="C").view(np.int64)   # a copy; keeps 0-d
    return torch.from_numpy(a).to(device)


def to_u64(t) -> np.ndarray:
    return t.detach().contiguous().cpu().numpy().view(np.uint64)


def from_ints(values, device="cpu"):
    return from_u64(np.array([int(v) % P for v in values], dtype=np.uint64), device)


# ---------------------------------------------------------------------------
# Quadratic extension: elements are (c0, c1) tuples of tensors
# ---------------------------------------------------------------------------

def ext_add(a, b):
    return (add(a[0], b[0]), add(a[1], b[1]))


def ext_sub(a, b):
    return (sub(a[0], b[0]), sub(a[1], b[1]))


def ext_neg(a):
    return (neg(a[0]), neg(a[1]))


def ext_mul(a, b):
    c0 = add(mul(a[0], b[0]), mul_small(mul(a[1], b[1]), W_EXT))
    c1 = add(mul(a[0], b[1]), mul(a[1], b[0]))
    return (c0, c1)


def ext_scalar_mul(a, s):
    """Extension element times base-field element s."""
    return (mul(a[0], s), mul(a[1], s))


def ext_square(a):
    return ext_mul(a, a)


def ext_inverse(a):
    """(a0 + a1 x)^-1 = (a0 - a1 x) / (a0^2 - 7 a1^2)."""
    n = sub(square(a[0]), mul_small(square(a[1]), W_EXT))
    ninv = inverse(n)
    return (mul(a[0], ninv), mul(neg(a[1]), ninv))


def ext_pow_const(a, e: int):
    r = (torch.ones_like(a[0]), torch.zeros_like(a[1]))
    base = a
    while e:
        if e & 1:
            r = ext_mul(r, base)
        e >>= 1
        if e:
            base = ext_square(base)
    return r


def ext_from_base(a):
    return (a, torch.zeros_like(a))
