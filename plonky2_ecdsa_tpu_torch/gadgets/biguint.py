"""In-circuit unsigned bigints as vectors of 29-bit limb targets.

Parity target: the reference CircuitBuilderBiguint trait
(src/gadgets/biguint.rs:78-160): constant/zero/connect/pad/cmp/add/sub/mul/
square/mul_by_bool/mul_add/div_rem/div/rem, with div_rem hint-checked
(a = div*b + rem, rem < b; biguint.rs:386-417).

This generic-width layer composes UX-style primitive ops (the plonky2_ux
equivalents, SURVEY.md §2.10): add_many_ux / sub_ux / mul_ux built from
arithmetic gate ops + hints + pooled range checks.  The 9-limb nonnative hot
path does NOT use this module — it has fused gates (gadgets/nonnative.py);
this module serves the public BigUint API (and reduce()).

Deviation: div_rem's remainder check is strict (rem < b, via NOT(b <= rem))
where the reference's cmp allows rem == b (biguint.rs:413-414).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..circuit.builder import CircuitBuilder
from ..circuit.foreign import BITS
from ..fields.goldilocks_host import P

MASK29 = (1 << BITS) - 1


@dataclass
class BigUintTarget:
    limbs: list  # little-endian 29-bit limb targets

    def num_limbs(self):
        return len(self.limbs)

    def get_limb(self, i):
        return self.limbs[i]


def convert_base(digits: list, from_bits: int, to_bits: int) -> list:
    """Host-side radix conversion on Python ints (reference convert_base,
    src/gadgets/biguint.rs:27-51 semantics: trailing zero limbs dropped)."""
    v = 0
    for i, d in enumerate(digits):
        v |= int(d) << (from_bits * i)
    out = []
    while v:
        out.append(v & ((1 << to_bits) - 1))
        v >>= to_bits
    return out


# ---------------------------------------------------------------------------
# UX primitives (29-bit bounded ints)
# ---------------------------------------------------------------------------

def ux_add_many(b: CircuitBuilder, summands: list) -> tuple:
    """(limb, carry) with sum(summands) = limb + 2^29 * carry.
    plonky2_ux add_many_ux equivalent (used by add_biguint, biguint.rs:261)."""
    limb = b.add_virtual_target()
    carry = b.add_virtual_target()
    b.range_check(limb, BITS)
    b.range_check(carry, BITS)  # loose carry bound, as plonky2_ux

    def fill(ev, ts=list(summands), limb=limb, carry=carry):
        tot = np.zeros_like(ev.get(ts[0]))
        for t in ts:
            tot = tot + ev.get(t)  # small values, no overflow
        ev.set(limb, tot & np.uint64(MASK29))
        ev.set(carry, tot >> np.uint64(BITS))

    b.add_op(fill, [limb, carry], "ux_add_many")
    acc = summands[0]
    for t in summands[1:]:
        acc = b.add(acc, t)
    recon = b.arithmetic(1 << BITS, 1, carry, b.one(), limb)  # 2^29*carry + limb
    b.connect(acc, recon)
    return limb, carry


def ux_sub(b: CircuitBuilder, x: int, y: int, borrow: int) -> tuple:
    """(result, borrow_out): x - y - borrow = result - 2^29 * borrow_out
    (plonky2_ux sub_ux, used by sub_biguint, biguint.rs:284)."""
    res = b.add_virtual_target()
    bout = b.add_virtual_target()
    b.range_check(res, BITS)
    b.assert_bool(bout)

    def fill(ev, x=x, y=y, brw=borrow, res=res, bout=bout):
        t = ev.get(x).astype(np.int64) - ev.get(y).astype(np.int64) \
            - ev.get(brw).astype(np.int64)
        neg = (t < 0).astype(np.int64)
        ev.set(res, (t + (neg << BITS)).astype(np.uint64))
        ev.set(bout, neg.astype(np.uint64))

    b.add_op(fill, [res, bout], "ux_sub")
    # x - y - borrow + 2^29*bout - res == 0
    lhs = b.sub(x, y)
    lhs = b.sub(lhs, borrow)
    lhs = b.arithmetic(1 << BITS, 1, bout, b.one(), lhs)
    b.connect(lhs, res)
    return res, bout


def ux_mul(b: CircuitBuilder, x: int, y: int) -> tuple:
    """(lo, hi): x * y = lo + 2^29 * hi (plonky2_ux mul_ux, biguint.rs:305)."""
    lo = b.add_virtual_target()
    hi = b.add_virtual_target()
    b.range_check(lo, BITS)
    b.range_check(hi, BITS)

    def fill(ev, x=x, y=y, lo=lo, hi=hi):
        t = ev.get(x) * ev.get(y)  # < 2^58, exact in u64
        ev.set(lo, t & np.uint64(MASK29))
        ev.set(hi, t >> np.uint64(BITS))

    b.add_op(fill, [lo, hi], "ux_mul")
    prod = b.mul(x, y)
    recon = b.arithmetic(1 << BITS, 1, hi, b.one(), lo)
    b.connect(prod, recon)
    return lo, hi


# ---------------------------------------------------------------------------
# BigUint ops
# ---------------------------------------------------------------------------

def constant_biguint(b: CircuitBuilder, value: int) -> BigUintTarget:
    limbs = []
    v = value
    while v or not limbs:
        limbs.append(b.constant(v & MASK29))
        v >>= BITS
    return BigUintTarget(limbs)


def zero_biguint(b: CircuitBuilder) -> BigUintTarget:
    return constant_biguint(b, 0)


def add_virtual_biguint(b: CircuitBuilder, num_limbs: int) -> BigUintTarget:
    limbs = b.add_virtual_targets(num_limbs)
    for t in limbs:
        b.range_check(t, BITS)
    return BigUintTarget(limbs)


def connect_biguint(b: CircuitBuilder, lhs: BigUintTarget, rhs: BigUintTarget):
    nmin = min(lhs.num_limbs(), rhs.num_limbs())
    for i in range(nmin):
        b.connect(lhs.limbs[i], rhs.limbs[i])
    for t in lhs.limbs[nmin:]:
        b.assert_zero(t)
    for t in rhs.limbs[nmin:]:
        b.assert_zero(t)


def pad_biguints(b: CircuitBuilder, a: BigUintTarget, c: BigUintTarget):
    zero = b.zero()
    n = max(a.num_limbs(), c.num_limbs())
    pa = BigUintTarget(a.limbs + [zero] * (n - a.num_limbs()))
    pc = BigUintTarget(c.limbs + [zero] * (n - c.num_limbs()))
    return pa, pc


def cmp_biguint(b: CircuitBuilder, a: BigUintTarget, c: BigUintTarget) -> int:
    """BoolTarget a <= c via borrow chain (list_le equivalent,
    biguint.rs:221-229)."""
    pa, pc = pad_biguints(b, a, c)
    borrow = b.zero()
    for x, y in zip(pa.limbs, pc.limbs):
        _, borrow = ux_sub(b, y, x, borrow)  # c - a
    return b.not_(borrow)


def add_biguint(b: CircuitBuilder, a: BigUintTarget, c: BigUintTarget) -> BigUintTarget:
    """a + c -> max+1 limbs (biguint.rs:240-270)."""
    n = max(a.num_limbs(), c.num_limbs())
    pa, pc = pad_biguints(b, a, c)
    out = []
    carry = b.zero()
    for i in range(n):
        limb, carry = ux_add_many(b, [carry, pa.limbs[i], pc.limbs[i]])
        out.append(limb)
    out.append(carry)
    return BigUintTarget(out)


def sub_biguint(b: CircuitBuilder, a: BigUintTarget, c: BigUintTarget) -> BigUintTarget:
    """a - c, assuming a >= c (biguint.rs:272-293)."""
    pa, pc = pad_biguints(b, a, c)
    out = []
    borrow = b.zero()
    for x, y in zip(pa.limbs, pc.limbs):
        res, borrow = ux_sub(b, x, y, borrow)
        out.append(res)
    # final borrow must be zero for a >= c
    b.assert_zero(borrow)
    return BigUintTarget(out)


def mul_biguint(b: CircuitBuilder, a: BigUintTarget, c: BigUintTarget) -> BigUintTarget:
    """Schoolbook product (biguint.rs:295-323)."""
    na, nc = a.num_limbs(), c.num_limbs()
    total = na + nc
    to_add = [[] for _ in range(total)]
    for i in range(na):
        for j in range(nc):
            lo, hi = ux_mul(b, a.limbs[i], c.limbs[j])
            to_add[i + j].append(lo)
            to_add[i + j + 1].append(hi)
    out = []
    carry = b.zero()
    for summands in to_add:
        limb, carry = ux_add_many(b, summands + [carry])
        out.append(limb)
    out.append(carry)
    return BigUintTarget(out)


def square_biguint(b: CircuitBuilder, a: BigUintTarget) -> BigUintTarget:
    """Square reusing symmetric partial products (biguint.rs:325-358)."""
    n = a.num_limbs()
    to_add = [[] for _ in range(2 * n)]
    for i in range(n):
        for j in range(i + 1):
            lo, hi = ux_mul(b, a.limbs[i], a.limbs[j])
            to_add[i + j].append(lo)
            to_add[i + j + 1].append(hi)
            if j != i:
                to_add[i + j].append(lo)
                to_add[i + j + 1].append(hi)
    out = []
    carry = b.zero()
    for summands in to_add:
        limb, carry = ux_add_many(b, summands + [carry])
        out.append(limb)
    out.append(carry)
    return BigUintTarget(out)


def mul_biguint_by_bool(b: CircuitBuilder, a: BigUintTarget, bool_t: int) -> BigUintTarget:
    return BigUintTarget([b.mul(t, bool_t) for t in a.limbs])


def mul_add_biguint(b: CircuitBuilder, x: BigUintTarget, y: BigUintTarget,
                    z: BigUintTarget) -> BigUintTarget:
    return add_biguint(b, mul_biguint(b, x, y), z)


def div_rem_biguint(b: CircuitBuilder, a: BigUintTarget, c: BigUintTarget):
    """Hint-based division: a = div*c + rem, 0 <= rem < c (biguint.rs:386-417)."""
    a_len, c_len = a.num_limbs(), c.num_limbs()
    div_len = 0 if c_len > a_len + 1 else a_len - c_len + 1
    div = add_virtual_biguint(b, max(div_len, 1))
    rem = add_virtual_biguint(b, c_len)

    def fill(ev, a_ts=list(a.limbs), c_ts=list(c.limbs),
             d_ts=np.array(div.limbs), r_ts=np.array(rem.limbs)):
        av = ev.get(a_ts)  # [la, B]
        cv = ev.get(c_ts)
        B = av.shape[-1]
        dvals = np.zeros((len(d_ts), B), np.uint64)
        rvals = np.zeros((len(r_ts), B), np.uint64)
        for k in range(B):
            ai = sum(int(av[i, k]) << (BITS * i) for i in range(len(a_ts)))
            ci = sum(int(cv[i, k]) << (BITS * i) for i in range(len(c_ts)))
            q, r = divmod(ai, ci) if ci else (0, 0)
            for i in range(len(d_ts)):
                dvals[i, k] = (q >> (BITS * i)) & MASK29
            for i in range(len(r_ts)):
                rvals[i, k] = (r >> (BITS * i)) & MASK29
            assert q < 1 << (BITS * len(d_ts)), "div overflow"
        ev.set(d_ts, dvals)
        ev.set(r_ts, rvals)

    b.add_op(fill, list(div.limbs) + list(rem.limbs), "div_rem")
    expected = mul_add_biguint(b, div, c, rem)
    connect_biguint(b, a, expected)
    # strict rem < c  <=>  NOT (c <= rem)
    le = cmp_biguint(b, c, rem)
    b.assert_zero(le)
    return div, rem


def div_biguint(b: CircuitBuilder, a: BigUintTarget, c: BigUintTarget) -> BigUintTarget:
    d, _ = div_rem_biguint(b, a, c)
    return d


def rem_biguint(b: CircuitBuilder, a: BigUintTarget, c: BigUintTarget) -> BigUintTarget:
    _, r = div_rem_biguint(b, a, c)
    return r
