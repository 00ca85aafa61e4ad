"""Vectorized multi-precision integer arithmetic on limb tensors.

The witness/"UX" substrate of the TPU build (SURVEY.md §2.10): the reference's
`plonky2_ux` bounded-int gadgets and `num::BigUint` host math become elementwise
tensor programs over little-endian limb arrays.

Two limb widths coexist:
  * 16-bit limbs in uint32 containers — internal witness math.  Products of two
    limbs fit in u32, and convolution accumulation splits partial products into
    lo/hi 16-bit halves so sums of hundreds of terms stay below 2^32 (TPU lanes
    are 32-bit; nothing here needs u64).
  * 29-bit limbs — the circuit wire format (reference `BITS = 29`,
    src/gadgets/nonnative.rs:32); produced via `convert` just before values are
    scattered into the witness matrix.

`convert` mirrors the semantics of the reference's `convert_base`
(src/gadgets/biguint.rs:27-51) but is shape-static and vectorized.

Counterpart of ``plonky2_ecdsa_tpu.fields.limbs``.  Every function takes numpy
arrays (the host witness engine, u32 containers) or torch tensors on any
device (int64 containers; the reference's jax.numpy half).  numpy wraps
modulo 2^32 in its containers; the tensor code masks where numpy would wrap
(sums, sub's borrows, mul's products and accumulators), so a result turned
back into u32 equals the numpy half's.  A numpy constant met beside a tensor
is moved to the tensor's device.  Not on any proving path.
"""

from __future__ import annotations

import numpy as np
import torch

BITS = 16
MASK = np.uint32(0xFFFF)
_M32 = 0xFFFFFFFF


def _device(*arrays):
    """The device of the first tensor among `arrays`, or None (all numpy)."""
    for a in arrays:
        if isinstance(a, torch.Tensor):
            return a.device
    return None


def _on(x, dev):
    """x as the container of `dev`: unchanged for numpy (dev None), else an
    int64 tensor on dev."""
    if dev is None or isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x).astype(np.int64), device=dev)


def _zeros(shape, dev):
    if dev is None:
        return np.zeros(shape, dtype=np.uint32)
    return torch.zeros(shape, dtype=torch.int64, device=dev)


def _cat(xs, dev):
    return np.concatenate(xs, axis=-1) if dev is None else torch.cat(xs, -1)


def _stack(xs, dev):
    return np.stack(xs, axis=-1) if dev is None else torch.stack(xs, -1)


def _wrap(x, dev):
    """numpy's u32 wrap of a sum or product: nothing to do on numpy."""
    return x if dev is None else x & _M32


def _flag(b, dev):
    """A boolean array as 0/1 limbs."""
    return b.astype(np.uint32) if dev is None else b.to(torch.int64)


# ---------------------------------------------------------------------------
# Conversions (host helpers use Python ints; exact at any size)
# ---------------------------------------------------------------------------

def num_limbs(bit_len: int, bits: int = BITS) -> int:
    return -(-bit_len // bits)


def from_int(v: int, L: int, bits: int = BITS, shape=(), device=None):
    """Python int -> broadcast limb tensor of shape (*shape, L): numpy, or a
    tensor on `device`."""
    assert v >= 0 and v < 1 << (bits * L), (v, L, bits)
    limbs = np.array([(v >> (bits * i)) & ((1 << bits) - 1) for i in range(L)], dtype=np.uint32)
    if device is None:
        return np.broadcast_to(limbs, tuple(shape) + (L,))
    return _on(limbs, torch.device(device)).expand(tuple(shape) + (L,))


def from_ints(vals, L: int, bits: int = BITS):
    """Iterable of Python ints -> [N, L] uint32 numpy array."""
    out = np.zeros((len(vals), L), dtype=np.uint32)
    m = (1 << bits) - 1
    for i, v in enumerate(vals):
        assert 0 <= v < 1 << (bits * L)
        for j in range(L):
            out[i, j] = (v >> (bits * j)) & m
    return out


def to_ints(x, bits: int = BITS):
    """[..., L] limb tensor (numpy, or a tensor on any device) -> nested list
    of Python ints (host only)."""
    x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    flat = x.reshape(-1, x.shape[-1])
    res = [sum(int(l) << (bits * j) for j, l in enumerate(row)) for row in flat]
    out = np.empty(len(res), dtype=object)
    out[:] = res
    return out.reshape(x.shape[:-1])


# ---------------------------------------------------------------------------
# Core ops (16-bit limbs unless noted)
# ---------------------------------------------------------------------------

def normalize(x, bits: int = BITS):
    """Propagate multi-bit carries; x limbs may hold values up to 2^32-1.

    Loops until no carry is left.
    """
    dev = _device(x)
    while True:
        carry = x >> bits
        if not carry.any():
            return x
        assert not carry[..., -1].any(), "normalize overflow in top limb"
        x = _wrap((x & ((1 << bits) - 1)) + _cat([_zeros(carry.shape[:-1] + (1,), dev),
                                                  carry[..., :-1]], dev), dev)


def add(a, b, bits: int = BITS):
    """a + b -> limb tensor of length max(La, Lb) + 1 (no truncation)."""
    dev = _device(a, b)
    a, b = _on(a, dev), _on(b, dev)
    L = max(a.shape[-1], b.shape[-1]) + 1
    return normalize(_wrap(resize(a, L) + resize(b, L), dev), bits)


def sub(a, b, bits: int = BITS):
    """a - b limbwise with borrow chain; returns (diff, borrow_out 0/1).

    a and b must have equal limb count; diff is the wrapped (mod 2^(bits*L))
    result when b > a.
    """
    assert a.shape[-1] == b.shape[-1], (a.shape, b.shape)
    dev = _device(a, b)
    a, b = _on(a, dev), _on(b, dev)
    L = a.shape[-1]
    base = 1 << bits
    outs = []
    borrow = _zeros(np.broadcast_shapes(a.shape[:-1], b.shape[:-1]), dev)
    for i in range(L):
        d = _wrap(np.uint32(base) + a[..., i] - b[..., i] - borrow if dev is None
                  else base + a[..., i] - b[..., i] - borrow, dev)
        outs.append(d & ((1 << bits) - 1))
        borrow = _flag(d < base, dev)
    return _stack(outs, dev), borrow


def lt(a, b, bits: int = BITS):
    """a < b as 0/1 (lexicographic, equal lengths padded)."""
    L = max(a.shape[-1], b.shape[-1])
    _, borrow = sub(resize(a, L), resize(b, L), bits)
    return borrow


def le(a, b, bits: int = BITS):
    return 1 - lt(b, a, bits)


def eq(a, b):
    dev = _device(a, b)
    a, b = _on(a, dev), _on(b, dev)
    L = max(a.shape[-1], b.shape[-1])
    return _flag((resize(a, L) == resize(b, L)).all(-1), dev)


def is_zero(a):
    return _flag((a == 0).all(-1), _device(a))


def select(cond, a, b):
    """cond ? a : b, cond shape broadcastable to limb tensors' batch shape."""
    dev = _device(cond, a, b)
    if dev is None:
        return np.where(cond[..., None].astype(bool), a, b)
    cond, a, b = _on(cond, dev), _on(a, dev), _on(b, dev)
    return torch.where(cond[..., None].bool(), a, b)


def mul_bool(a, cond):
    dev = _device(a, cond)
    a, cond = _on(a, dev), _on(cond, dev)
    return a * (cond[..., None].astype(np.uint32) if dev is None else cond[..., None])


def mul(a, b, bits: int = BITS):
    """Schoolbook product -> [., La+Lb] limbs, u32-safe accumulation.

    Requires bits <= 16 so limb products fit u32; partial products are split
    into lo/hi halves accumulated separately (each term < 2^bits, so up to
    2^(32-bits) terms are safe — far above any size used here).
    """
    assert bits <= 16
    dev = _device(a, b)
    a, b = _on(a, dev), _on(b, dev)
    La, Lb = a.shape[-1], b.shape[-1]
    L = La + Lb
    shape = np.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    acc_lo = _zeros(shape + (L,), dev)
    acc_hi = _zeros(shape + (L,), dev)
    m = (1 << bits) - 1
    for i in range(La):
        p = _wrap(a[..., i : i + 1] * b, dev)  # [..., Lb], each < 2^(2*bits)
        acc_lo[..., i : i + Lb] += p & m
        acc_hi[..., i : i + Lb] += p >> bits
    acc_lo, acc_hi = _wrap(acc_lo, dev), _wrap(acc_hi, dev)
    # limb k total = acc_lo[k] + acc_hi[k-1]
    shifted = _cat([_zeros(shape + (1,), dev), acc_hi[..., :-1]], dev)
    return normalize(_wrap(acc_lo + shifted, dev), bits)


def resize(a, L: int):
    """Pad with zero limbs or truncate (caller asserts truncation is safe)."""
    La = a.shape[-1]
    if La == L:
        return a
    if La < L:
        dev = _device(a)
        return _cat([a, _zeros(a.shape[:-1] + (L - La,), dev)], dev)
    return a[..., :L]


# ---------------------------------------------------------------------------
# Base conversion (static codegen per (from_bits, to_bits, shapes))
# ---------------------------------------------------------------------------

def convert(x, from_bits: int, to_bits: int, Lout: int):
    """Repack limb widths, e.g. 16 <-> 29 bits. Exact; masks before shifting
    so no intermediate exceeds u32. Mirrors reference convert_base semantics
    (src/gadgets/biguint.rs:27-51) with a fixed output length."""
    dev = _device(x)
    Lin = x.shape[-1]
    mask_to = (1 << to_bits) - 1
    outs = []
    for j in range(Lout):
        start = to_bits * j
        a = start // from_bits
        s = start - from_bits * a
        acc = None
        t = 0
        while from_bits * t - s < to_bits:
            idx = a + t
            shift = from_bits * t - s
            if idx < Lin:
                xi = x[..., idx]
                if shift < 0:
                    term = xi >> (-shift)
                else:
                    pre = (mask_to >> shift) & ((1 << from_bits) - 1)
                    term = (xi & (np.uint32(pre) if dev is None else pre)) << shift
                acc = term if acc is None else acc | term
            t += 1
        if acc is None:
            acc = _zeros(x.shape[:-1], dev)
        outs.append(acc & (np.uint32(mask_to) if dev is None else mask_to))
    return _stack(outs, dev)


# ---------------------------------------------------------------------------
# Barrett reduction by a constant modulus
# ---------------------------------------------------------------------------

class Modulus:
    """Precomputed constants for exact division/reduction by a fixed modulus.

    Provides the witness-side equivalents of the reference hint generators:
    BigUintDivRemGenerator (src/gadgets/biguint.rs:483-548) and the q,r hints of
    MulNonnativeGenerator (src/gates/mul_nonnative.rs:249-324), vectorized.
    """

    def __init__(self, m: int, name: str = "", max_x_bits: int | None = None):
        assert m > 1
        self.m = m
        self.name = name
        self.bit_len = m.bit_length()
        self.L = num_limbs(self.bit_len)  # 16-bit limbs of m
        # Default x bound: product of two 9x29-bit values (522 bits) with slack.
        self.max_x_bits = max_x_bits or (2 * 9 * 29 + 16)
        self.Lx = num_limbs(self.max_x_bits)
        self.S = BITS * self.Lx
        self.mu = (1 << self.S) // m
        self.Lmu = num_limbs(self.mu.bit_length())
        self.m_limbs = from_int(m, self.L)
        self.mu_limbs = from_int(self.mu, self.Lmu)
        self.Lq = self.Lx - self.L + 1

    def divmod(self, x):
        """x: [..., <=Lx] limbs -> (q [..., Lq], r [..., L]) with x = q*m + r,
        0 <= r < m. Exact for any x < 2^max_x_bits."""
        assert x.shape[-1] <= self.Lx, (x.shape, self.Lx)
        dev = _device(x)
        x = resize(x, self.Lx)
        mu = _on(np.asarray(self.mu_limbs), dev)
        ml = _on(np.asarray(self.m_limbs), dev)
        prod = mul(x, mu)  # [..., Lx + Lmu]
        qhat = prod[..., self.Lx :]  # floor(x*mu / 2^S); q - qhat in {0,1,2}
        qhat = resize(qhat, self.Lq)
        qm = resize(mul(qhat, ml), self.Lx + 1)
        r_full, borrow = sub(resize(x, self.Lx + 1), qm)
        # r < 3m, fits in L+1 limbs
        r = resize(r_full, self.L + 1)
        q = qhat
        one = from_int(1, self.Lq, device=dev)
        mpad = resize(ml, self.L + 1)
        for _ in range(2):
            ge = 1 - lt(r, mpad)
            r2, _ = sub(r, mul_bool(mpad, ge))
            r = r2
            q = resize(add(q, mul_bool(one, ge)), self.Lq)
        return q, resize(r, self.L)

    def mod_mul(self, a, b):
        """(a*b) mod m with the quotient hint: returns (q, r)."""
        return self.divmod(mul(a, b))

    def mod_add(self, a, b):
        """(a+b) mod m -> (r, overflow 0/1); a, b must be < m."""
        s = add(resize(a, self.L), resize(b, self.L))
        mpad = _on(np.asarray(resize(self.m_limbs, self.L + 1)), _device(s))
        ge = 1 - lt(s, mpad)
        r, _ = sub(s, mul_bool(mpad, ge))
        return resize(r, self.L), ge

    def mod_sub(self, a, b):
        """(a-b) mod m -> (r, underflow 0/1); a, b must be < m."""
        d, borrow = sub(resize(a, self.L), resize(b, self.L))
        r = resize(add(d, mul_bool(self.m_limbs, borrow)), self.L)
        return r, borrow

    def mod_neg(self, a):
        nz = 1 - is_zero(a)
        d, _ = sub(mul_bool(self.m_limbs, nz), resize(a, self.L))
        return d

    def mod_inv(self, a):
        """Modular inverse (host numpy path: exact Python pow per element).

        inverse of 0 -> 0. Returns (inv, div) with a*inv = div*m + (a!=0)."""
        ints = to_ints(a)
        flat = np.ravel(ints)
        inv = [pow(int(v), -1, self.m) if int(v) % self.m != 0 else 0 for v in flat]
        inv_arr = _on(from_ints(inv, self.L).reshape(np.shape(ints) + (self.L,)), _device(a))
        prods = mul(resize(a, self.L), inv_arr)
        q, r = self.divmod(prods)
        return inv_arr, q

    def pow_mod(self, a, e: int):
        """a^e mod m (square-and-multiply over mod_mul)."""
        r = from_int(1, self.L, shape=a.shape[:-1], device=_device(a))
        base = resize(a, self.L)
        while e:
            if e & 1:
                _, r = self.mod_mul(r, base)
            e >>= 1
            if e:
                _, base = self.mod_mul(base, base)
        return r
