"""Nonnative field arithmetic gadgets (mod a foreign 256-bit prime inside
Goldilocks circuits), 9 x 29-bit limbs.

Parity target: the reference CircuitBuilderNonNative trait surface
(src/gadgets/nonnative.rs:53-164): add / add_many / sub / mul / mul_many /
neg / inv / reduce / conditional_neg / bit-split / mul_by_bool / if_nonnative,
all with the `range_check: bool` deferred-canonicity contract
(nonnative.rs:166-171): congruence mod m always holds; only ops with
range_check=True additionally constrain the output canonical (< m).

Deviations (documented per SURVEY.md §2 #5 note):
  * One fused MulNonNative row per mul instead of MulNonnativeGate+CheckSumGate
    (see circuit/gates.py docstring); the redundant double range check of r
    (nonnative.rs:456,458) is not replicated.
  * inv_nonnative emits one fused mul row constraining x*inv = q*m + 1
    instead of two in-circuit schoolbook biguint muls (nonnative.rs:502-536) —
    the identical soundness statement at ~6x fewer rows.
  * Limb range checks happen at value-creation sites (virtual inputs and op
    outputs); ops therefore never re-check their inputs, where the reference
    re-checks x and y on every mul (nonnative.rs:454-455).
  * Canonicity checks are strict (value <= m-1) where the reference's
    cmp_biguint-vs-modulus allows value == m (nonnative.rs:185-190).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..circuit.builder import CircuitBuilder
from ..circuit.foreign import BITS, ForeignField
from ..circuit.gates import (
    CARRY_OFFSET,
    BigCmpGate,
    MulNonNativeGate,
    NonNativeAddGate,
    NonNativeAddManyGate,
    NonNativeSubGate,
)
from ..fields import limbs as lb

N = 9  # limbs per 256-bit nonnative value
L16 = 17  # 16-bit limbs covering 9*29 = 261 bits
MASK29 = (1 << BITS) - 1


@dataclass
class NonNativeTarget:
    ff: ForeignField
    limbs: list  # up to N targets, little-endian 29-bit

    def to_target_vec(self):
        return list(self.limbs)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _get29(ev, tids, n=N):
    """Gather limb targets -> [B, n] uint32 (zero-padded)."""
    arr = ev.get(np.asarray(tids, dtype=np.int64)).T.astype(np.uint32)  # [B, len]
    if arr.shape[-1] < n:
        arr = np.concatenate(
            [arr, np.zeros(arr.shape[:-1] + (n - arr.shape[-1],), np.uint32)], axis=-1
        )
    return arr


def _set29(ev, tids, arr):
    """arr [B, len(tids)] -> store as u64."""
    ev.set(np.asarray(tids, dtype=np.int64), arr.T.astype(np.uint64))


def _to16(x29):
    return lb.convert(x29, BITS, 16, L16)


def _from16(x16, n=N):
    return lb.convert(x16, 16, BITS, n)


def constant_nonnative(b: CircuitBuilder, ff: ForeignField, value: int) -> NonNativeTarget:
    value %= ff.m
    limbs = [b.constant((value >> (BITS * i)) & MASK29) for i in range(N)]
    return NonNativeTarget(ff, limbs)


def zero_nonnative(b: CircuitBuilder, ff: ForeignField) -> NonNativeTarget:
    return constant_nonnative(b, ff, 0)


def add_virtual_nonnative(b: CircuitBuilder, ff: ForeignField,
                          num_limbs: int = N, range_check: bool = True) -> NonNativeTarget:
    """Virtual nonnative input; limbs are range-checked at creation (policy)."""
    limbs = b.add_virtual_targets(num_limbs)
    if range_check:
        for t in limbs:
            b.range_check(t, BITS)
    return NonNativeTarget(ff, limbs)


def connect_nonnative(b: CircuitBuilder, lhs: NonNativeTarget, rhs: NonNativeTarget):
    nmin = min(len(lhs.limbs), len(rhs.limbs))
    for i in range(nmin):
        b.connect(lhs.limbs[i], rhs.limbs[i])
    for t in lhs.limbs[nmin:]:
        b.assert_zero(t)
    for t in rhs.limbs[nmin:]:
        b.assert_zero(t)


def _connect_padded(b: CircuitBuilder, row: int, wire_fn, limbs):
    zero = b.zero()
    for i in range(N):
        w = b.wire(row, wire_fn(i))
        b.connect(w, limbs[i] if i < len(limbs) else zero)


def assert_canonical(b: CircuitBuilder, x: NonNativeTarget):
    """Constrain value(x) <= m - 1 (strict canonicity, BigCmpGate)."""
    ff = x.ff
    row, op = b.op_slot("bigcmp", lambda: BigCmpGate(b.cmp_ops))
    gate: BigCmpGate = b.rows[row][0]
    _connect_padded(b, row, lambda i: gate.wire_a(i, op), x.limbs)
    mm1 = ff.m - 1
    for i in range(N):
        b.connect(b.wire(row, gate.wire_b(i, op)), b.constant((mm1 >> (BITS * i)) & MASK29))
    le = b.wire(row, gate.wire_le(op))
    b.assert_one(le)
    d_ts = [b.wire(row, gate.wire_d(i, op)) for i in range(N)]
    brw_ts = [b.wire(row, gate.wire_brw(i, op)) for i in range(N)]
    for t in d_ts:
        b.range_check(t, BITS)

    x_t = list(x.limbs)

    def fill(ev, x_t=x_t, d_ts=np.array(d_ts), brw_ts=np.array(brw_ts),
             le=le, mm1=mm1):
        xv = _get29(ev, x_t)  # [B, 9]
        mv = np.array([(mm1 >> (BITS * i)) & MASK29 for i in range(N)], np.int64)
        d = np.zeros(xv.shape, np.int64)
        brw = np.zeros(xv.shape, np.int64)
        prev = np.zeros(xv.shape[0], np.int64)
        for i in range(N):
            t = mv[i] - xv[:, i].astype(np.int64) - prev
            bi = (t < 0).astype(np.int64)
            d[:, i] = t + (bi << BITS)
            brw[:, i] = bi
            prev = bi
        _set29(ev, d_ts, d.astype(np.uint32))
        _set29(ev, brw_ts, brw.astype(np.uint32))
        ev.set(le, (1 - brw[:, N - 1]).astype(np.uint64))

    b.add_op(fill, d_ts + brw_ts + [le], "cmp_const",
             rec=("cmp_const", dict(x=x_t, mv=[(mm1 >> (BITS * i)) & MASK29
                                               for i in range(N)],
                                    d=d_ts, brw=brw_ts, le=le)))


def _conv_carries(x29, y29, q29, r29, m29):
    """int64 carry-free convolution -> offset carries [B, 16] (exactness
    asserted).  Mirrors CheckSumGenerator (mul_nonnative.rs:513-531)."""
    B = x29.shape[0]
    xs = x29.astype(np.int64)
    ys = y29.astype(np.int64)
    qs = q29.astype(np.int64)
    rs = r29.astype(np.int64)
    out = np.zeros((B, 2 * N - 2), np.int64)
    prev = np.zeros(B, np.int64)
    for i in range(2 * N - 1):
        lo, hi = max(i - N + 1, 0), min(i + 1, N)
        conv = np.zeros(B, np.int64)
        for j in range(lo, hi):
            conv += m29[j] * qs[:, i - j] - xs[:, j] * ys[:, i - j]
        if i < N:
            conv += rs[:, i]
        t = conv + prev
        if i < 2 * N - 2:
            assert (t & MASK29 == 0).all(), "mul carry not divisible"
            bi = t >> BITS
            out[:, i] = bi + CARRY_OFFSET
            assert ((out[:, i] >= 0) & (out[:, i] < 1 << 34)).all()
            prev = bi
        else:
            assert (t == 0).all(), "mul convolution does not telescope to zero"
    return out


def _emit_mul_row(b: CircuitBuilder, ff: ForeignField, x: NonNativeTarget,
                  y_limbs: list, r_limbs: list | None):
    """Allocate one fused MulNonNative row.  Returns (row, q_ts, r_ts, b_ts).
    If r_limbs given, r wires are connected to them (e.g. constant 1 for inv);
    else fresh r wires are the result."""
    gate = MulNonNativeGate(ff)
    row = b.add_row(gate)
    _connect_padded(b, row, gate.wire_x, x.limbs)
    _connect_padded(b, row, gate.wire_y, y_limbs)
    if r_limbs is not None:
        _connect_padded(b, row, gate.wire_r, r_limbs)
    r_ts = [b.wire(row, gate.wire_r(i)) for i in range(N)]
    q_ts = [b.wire(row, gate.wire_q(i)) for i in range(N)]
    b_ts = [b.wire(row, gate.wire_b(i)) for i in range(2 * N - 2)]
    # r range checks only when r is a fresh output (constants need none)
    for t in q_ts + (r_ts if r_limbs is None else []):
        b.range_check(t, BITS)
    for t in b_ts:
        b.range_check(t, 34)
    return row, q_ts, r_ts, b_ts


def mul_nonnative(b: CircuitBuilder, x: NonNativeTarget, y: NonNativeTarget,
                  range_check: bool = True) -> NonNativeTarget:
    """x * y mod m; one fused gate row (reference: nonnative.rs:390-464)."""
    ff = x.ff
    _, q_ts, r_ts, b_ts = _emit_mul_row(b, ff, x, y.limbs, None)
    x_t, y_t = list(x.limbs), list(y.limbs)
    m29 = np.array(ff.limbs29, np.int64)

    def fill(ev, x_t=x_t, y_t=y_t, q_ts=np.array(q_ts), r_ts=np.array(r_ts),
             b_ts=np.array(b_ts), ff=ff, m29=m29):
        x29 = _get29(ev, x_t)
        y29 = _get29(ev, y_t)
        prod = lb.mul(_to16(x29), _to16(y29))
        q16, r16 = ff.barrett.divmod(prod)
        q29 = _from16(lb.resize(q16, L16))
        r29 = _from16(r16)
        carr = _conv_carries(x29, y29, q29, r29, m29)
        _set29(ev, q_ts, q29)
        _set29(ev, r_ts, r29)
        ev.set(b_ts, carr.T.astype(np.uint64))

    b.add_op(fill, list(q_ts) + list(r_ts) + list(b_ts), "mul_nn",
             rec=("mul_nn", dict(x=x_t, y=y_t, q=q_ts, r=r_ts, carry=b_ts, ff=ff)))
    res = NonNativeTarget(ff, list(r_ts))
    if range_check:
        assert_canonical(b, res)
    return res


def mul_many_nonnative(b: CircuitBuilder, terms: list, range_check: bool = True) -> NonNativeTarget:
    """Chained muls, only the final one canonicity-checked
    (reference nonnative.rs:466-489)."""
    assert terms
    if len(terms) == 1:
        return terms[0]
    acc = mul_nonnative(b, terms[0], terms[1],
                        range_check and len(terms) == 2)
    for i in range(2, len(terms)):
        acc = mul_nonnative(b, acc, terms[i],
                            range_check and i + 1 == len(terms))
    return acc


def inv_nonnative(b: CircuitBuilder, x: NonNativeTarget,
                  range_check: bool = True) -> NonNativeTarget:
    """Multiplicative inverse via hint + single fused mul row constraining
    x * inv = q*m + 1 (reference: nonnative.rs:502-536 with q = `div`)."""
    ff = x.ff
    inv_ts = b.add_virtual_targets(N)
    one_limbs = [b.one()] + [b.zero()] * (N - 1)
    _, q_ts, _r_ts, b_ts = _emit_mul_row(b, ff, x, inv_ts, one_limbs)
    for t in inv_ts:
        b.range_check(t, BITS)
    x_t = list(x.limbs)
    m29 = np.array(ff.limbs29, np.int64)

    def fill(ev, x_t=x_t, inv_ts=np.array(inv_ts), q_ts=np.array(q_ts),
             b_ts=np.array(b_ts), ff=ff, m29=m29):
        x29 = _get29(ev, x_t)
        inv16, _ = ff.barrett.mod_inv(_to16(x29))
        inv29 = _from16(lb.resize(inv16, L16))
        prod = lb.mul(_to16(x29), lb.resize(inv16, L16))
        # r == 1 unless x == 0; inverse of zero yields an unsatisfiable row
        # (as in the reference: x*inv = 1 + m*div cannot hold), caught by
        # check_constraints / proving.
        q16, r16 = ff.barrett.divmod(prod)
        q29 = _from16(lb.resize(q16, L16))
        r29 = _from16(r16)
        carr = _conv_carries(x29, inv29, q29, r29, m29)
        _set29(ev, inv_ts, inv29)
        _set29(ev, q_ts, q29)
        ev.set(b_ts, carr.T.astype(np.uint64))

    b.add_op(fill, list(inv_ts) + list(q_ts) + list(b_ts), "inv_nn",
             rec=("inv_nn", dict(x=x_t, inv=inv_ts, q=q_ts, carry=b_ts, ff=ff)))
    res = NonNativeTarget(ff, inv_ts)
    if range_check:
        assert_canonical(b, res)
    return res


def add_nonnative(b: CircuitBuilder, x: NonNativeTarget, y: NonNativeTarget,
                  range_check: bool = True) -> NonNativeTarget:
    """x + y with modulus fold (reference nonnative.rs:245-276)."""
    ff = x.ff
    row, op = b.op_slot(("nnadd", ff.name), lambda: NonNativeAddGate(ff, b.nn_ops))
    gate: NonNativeAddGate = b.rows[row][0]
    _connect_padded(b, row, lambda i: gate.wire_a(i, op), x.limbs)
    _connect_padded(b, row, lambda i: gate.wire_b(i, op), y.limbs)
    s_ts = [b.wire(row, gate.wire_s(i, op)) for i in range(N)]
    ovf = b.wire(row, gate.wire_ovf(op))
    c_ts = [b.wire(row, gate.wire_c(i, op)) for i in range(N - 1)]
    for t in s_ts:
        b.range_check(t, BITS)
    x_t, y_t = list(x.limbs), list(y.limbs)
    m29 = np.array(ff.limbs29, np.int64)

    def fill(ev, x_t=x_t, y_t=y_t, s_ts=np.array(s_ts), ovf=ovf,
             c_ts=np.array(c_ts), ff=ff, m29=m29):
        x29 = _get29(ev, x_t).astype(np.int64)
        y29 = _get29(ev, y_t).astype(np.int64)
        s16 = lb.add(_to16(x29.astype(np.uint32)), _to16(y29.astype(np.uint32)))
        m16 = lb.resize(ff.barrett.m_limbs, s16.shape[-1])
        ge = np.uint32(1) - lb.lt(s16, m16)
        red, _ = lb.sub(s16, lb.mul_bool(m16, ge))
        s29 = _from16(lb.resize(red, L16)).astype(np.int64)
        # carries: a_i + b_i - ovf*m_i - s_i + c_{i-1} = 2^29 c_i
        c = np.zeros((x29.shape[0], N - 1), np.int64)
        prev = np.zeros(x29.shape[0], np.int64)
        ov = ge.astype(np.int64)
        for i in range(N):
            t = x29[:, i] + y29[:, i] - ov * m29[i] - s29[:, i] + prev
            if i < N - 1:
                assert (t & MASK29 == 0).all()
                prev = t >> BITS
                c[:, i] = prev + 1
                assert ((c[:, i] >= 0) & (c[:, i] <= 2)).all()
            else:
                assert (t == 0).all()
        _set29(ev, s_ts, s29.astype(np.uint32))
        ev.set(ovf, ge.astype(np.uint64))
        _set29(ev, c_ts, c.astype(np.uint32))

    b.add_op(fill, list(s_ts) + [ovf] + list(c_ts), "add_nn",
             rec=("add_nn", dict(x=x_t, y=y_t, s=s_ts, ovf=ovf, c=c_ts, ff=ff)))
    res = NonNativeTarget(ff, s_ts)
    if range_check:
        assert_canonical(b, res)
    return res


def sub_nonnative(b: CircuitBuilder, x: NonNativeTarget, y: NonNativeTarget,
                  range_check: bool = True) -> NonNativeTarget:
    """x - y mod m (reference nonnative.rs:356-388)."""
    ff = x.ff
    row, op = b.op_slot(("nnsub", ff.name), lambda: NonNativeSubGate(ff, b.nn_ops))
    gate: NonNativeSubGate = b.rows[row][0]
    _connect_padded(b, row, lambda i: gate.wire_a(i, op), x.limbs)
    _connect_padded(b, row, lambda i: gate.wire_b(i, op), y.limbs)
    d_ts = [b.wire(row, gate.wire_d(i, op)) for i in range(N)]
    ovf = b.wire(row, gate.wire_ovf(op))
    c_ts = [b.wire(row, gate.wire_c(i, op)) for i in range(N - 1)]
    for t in d_ts:
        b.range_check(t, BITS)
    x_t, y_t = list(x.limbs), list(y.limbs)
    m29 = np.array(ff.limbs29, np.int64)

    def fill(ev, x_t=x_t, y_t=y_t, d_ts=np.array(d_ts), ovf=ovf,
             c_ts=np.array(c_ts), ff=ff, m29=m29):
        x29 = _get29(ev, x_t).astype(np.int64)
        y29 = _get29(ev, y_t).astype(np.int64)
        x16 = _to16(x29.astype(np.uint32))
        y16 = _to16(y29.astype(np.uint32))
        brw = lb.lt(x16, y16)
        m16 = lb.resize(ff.barrett.m_limbs, x16.shape[-1])
        xa = lb.add(x16, lb.mul_bool(m16, brw))
        d16, under = lb.sub(xa, lb.resize(y16, xa.shape[-1]))
        assert not under.any()
        d29 = _from16(lb.resize(d16, L16)).astype(np.int64)
        c = np.zeros((x29.shape[0], N - 1), np.int64)
        prev = np.zeros(x29.shape[0], np.int64)
        ov = brw.astype(np.int64)
        for i in range(N):
            t = x29[:, i] - y29[:, i] + ov * m29[i] - d29[:, i] + prev
            if i < N - 1:
                assert (t & MASK29 == 0).all()
                prev = t >> BITS
                c[:, i] = prev + 1
                assert ((c[:, i] >= 0) & (c[:, i] <= 2)).all()
            else:
                assert (t == 0).all()
        _set29(ev, d_ts, d29.astype(np.uint32))
        ev.set(ovf, ov.astype(np.uint64))
        _set29(ev, c_ts, c.astype(np.uint32))

    b.add_op(fill, list(d_ts) + [ovf] + list(c_ts), "sub_nn",
             rec=("sub_nn", dict(x=x_t, y=y_t, s=d_ts, ovf=ovf, c=c_ts, ff=ff)))
    res = NonNativeTarget(ff, d_ts)
    if range_check:
        assert_canonical(b, res)
    return res


def add_many_nonnative(b: CircuitBuilder, terms: list,
                       range_check: bool = True) -> NonNativeTarget:
    """Sum of up to 4 values, one gate row (reference nonnative.rs:310-353)."""
    assert 1 <= len(terms) <= 4
    if len(terms) == 1:
        return terms[0]
    ff = terms[0].ff
    while len(terms) < 4:
        terms = terms + [zero_nonnative(b, ff)]
    gate = NonNativeAddManyGate(ff, 4)
    row = b.add_row(gate)
    for t in range(4):
        _connect_padded(b, row, lambda i, t=t: gate.wire_a(t, i), terms[t].limbs)
    s_ts = [b.wire(row, gate.wire_s(i)) for i in range(N)]
    ovf = b.wire(row, gate.wire_ovf)
    c_ts = [b.wire(row, gate.wire_c(i)) for i in range(N - 1)]
    for t in s_ts:
        b.range_check(t, BITS)
    b.range_check(ovf, BITS)
    for t in c_ts:
        b.range_check(t, 34)
    term_ts = [list(t.limbs) for t in terms]
    m29 = np.array(ff.limbs29, np.int64)

    def fill(ev, term_ts=term_ts, s_ts=np.array(s_ts), ovf=ovf,
             c_ts=np.array(c_ts), ff=ff, m29=m29):
        vals29 = [_get29(ev, ts).astype(np.int64) for ts in term_ts]
        tot16 = None
        for v in vals29:
            v16 = _to16(v.astype(np.uint32))
            tot16 = v16 if tot16 is None else lb.add(tot16, lb.resize(v16, tot16.shape[-1]))
        q16, r16 = ff.barrett.divmod(tot16)
        ov = np.array([int(v) for v in lb.to_ints(q16)], np.int64)
        s29 = _from16(r16 if r16.shape[-1] >= L16 else lb.resize(r16, L16)).astype(np.int64)
        c = np.zeros((s29.shape[0], N - 1), np.int64)
        prev = np.zeros(s29.shape[0], np.int64)
        for i in range(N):
            t = sum(v[:, i] for v in vals29) - ov * m29[i] - s29[:, i] + prev
            if i < N - 1:
                assert (t & MASK29 == 0).all()
                prev = t >> BITS
                c[:, i] = prev + CARRY_OFFSET
                assert ((c[:, i] >= 0) & (c[:, i] < 1 << 34)).all()
            else:
                assert (t == 0).all()
        _set29(ev, s_ts, s29.astype(np.uint32))
        ev.set(ovf, ov.astype(np.uint64))
        ev.set(c_ts, c.T.astype(np.uint64))

    b.add_op(fill, list(s_ts) + [ovf] + list(c_ts), "add_many_nn",
             rec=("add_many_nn", dict(terms=term_ts, s=s_ts, ovf=ovf, c=c_ts, ff=ff)))
    res = NonNativeTarget(ff, s_ts)
    if range_check:
        assert_canonical(b, res)
    return res


def neg_nonnative(b: CircuitBuilder, x: NonNativeTarget,
                  range_check: bool = True) -> NonNativeTarget:
    """0 - x (reference nonnative.rs:491-500)."""
    return sub_nonnative(b, zero_nonnative(b, x.ff), x, range_check)


def mul_nonnative_by_bool(b: CircuitBuilder, x: NonNativeTarget, bool_t: int,
                          range_check: bool = False) -> NonNativeTarget:
    """Limbwise multiply by a boolean target (reference nonnative.rs:278-295).
    Output limbs are bounded by the (already-checked) input limbs; no new
    range checks needed."""
    limbs = [b.mul(t, bool_t) for t in x.limbs]
    res = NonNativeTarget(x.ff, limbs)
    if range_check:
        assert_canonical(b, res)
    return res


def if_nonnative(b: CircuitBuilder, bool_t: int, x: NonNativeTarget,
                 y: NonNativeTarget, range_check: bool = True) -> NonNativeTarget:
    """b ? x : y (reference nonnative.rs:297-308)."""
    nb = b.not_(bool_t)
    mx = mul_nonnative_by_bool(b, x, bool_t)
    my = mul_nonnative_by_bool(b, y, nb)
    return add_nonnative(b, mx, my, range_check)


def nonnative_conditional_neg(b: CircuitBuilder, x: NonNativeTarget, bool_t: int,
                              range_check: bool = True) -> NonNativeTarget:
    """b ? -x : x (reference nonnative.rs:584-596)."""
    nb = b.not_(bool_t)
    neg = neg_nonnative(b, x, False)
    t1 = mul_nonnative_by_bool(b, neg, bool_t)
    t2 = mul_nonnative_by_bool(b, x, nb)
    return add_nonnative(b, t1, t2, range_check)


def bool_to_nonnative(b: CircuitBuilder, ff: ForeignField, bool_t: int) -> NonNativeTarget:
    """Single-limb nonnative from a boolean (reference nonnative.rs:555-563)."""
    return NonNativeTarget(ff, [bool_t])


def split_nonnative_to_bits(b: CircuitBuilder, x: NonNativeTarget) -> list:
    """Little-endian bit decomposition (reference nonnative.rs:566-582)."""
    bits = []
    for limb in x.limbs:
        bits.extend(b.split_le_base2(limb, BITS))
    return bits


def reduce_biguint(b: CircuitBuilder, ff: ForeignField, x) -> NonNativeTarget:
    """x % m for a BigUintTarget x (reference nonnative.rs:539-553)."""
    from .biguint import BigUintTarget, rem_biguint, constant_biguint

    mod_t = constant_biguint(b, ff.m)
    rem = rem_biguint(b, x, mod_t)
    limbs = list(rem.limbs[:N])
    for t in rem.limbs[N:]:
        b.assert_zero(t)
    return NonNativeTarget(ff, limbs)


def reduce_nonnative(b: CircuitBuilder, x: NonNativeTarget) -> NonNativeTarget:
    from .biguint import BigUintTarget

    return reduce_biguint(b, x.ff, BigUintTarget(list(x.limbs)))
