"""Affine curve-point gadgets with incomplete arithmetic.

Parity: reference CircuitBuilderCurve (src/gadgets/curve.rs:34-94): validity,
neg / conditional_neg, double / repeated_double, add (assumes p1 != ±p2),
conditional_add, and the naive 261-step double-and-add scalar mul.

Determinism fix (SURVEY.md §7 item 4): the reference starts curve_scalar_mul's
accumulator at a random point (curve.rs:253 `rand()`); here the offset point is
the Keccak-derived deterministic point already used by the reference's MSM
(curve_msm.rs:33-37), so circuits are reproducible."""

from __future__ import annotations

from dataclasses import dataclass

from ..circuit.builder import CircuitBuilder
from ..circuit.foreign import ForeignField, base_field, scalar_field
from ..curve import native as cn
from . import nonnative as gn


@dataclass
class AffinePointTarget:
    curve: cn.CurveParams
    x: gn.NonNativeTarget
    y: gn.NonNativeTarget

    def to_vec(self):
        return [self.x, self.y]


def constant_affine_point(b: CircuitBuilder, pt: cn.Point) -> AffinePointTarget:
    assert not pt.zero, "constant_affine_point takes non-zero points"
    ff = base_field(pt.curve)
    return AffinePointTarget(
        pt.curve,
        gn.constant_nonnative(b, ff, pt.x),
        gn.constant_nonnative(b, ff, pt.y),
    )


def add_virtual_affine_point(b: CircuitBuilder, curve: cn.CurveParams) -> AffinePointTarget:
    ff = base_field(curve)
    return AffinePointTarget(
        curve,
        gn.add_virtual_nonnative(b, ff),
        gn.add_virtual_nonnative(b, ff),
    )


def connect_affine_point(b: CircuitBuilder, lhs: AffinePointTarget, rhs: AffinePointTarget):
    gn.connect_nonnative(b, lhs.x, rhs.x)
    gn.connect_nonnative(b, lhs.y, rhs.y)


def curve_assert_valid(b: CircuitBuilder, p: AffinePointTarget):
    """y^2 = x^3 + a*x + b (curve.rs:123-135)."""
    ff = base_field(p.curve)
    a_c = gn.constant_nonnative(b, ff, p.curve.a)
    b_c = gn.constant_nonnative(b, ff, p.curve.b)
    y2 = gn.mul_nonnative(b, p.y, p.y, True)
    x2 = gn.mul_nonnative(b, p.x, p.x, False)
    x3 = gn.mul_nonnative(b, x2, p.x, False)
    ax = gn.mul_nonnative(b, a_c, p.x, False)
    axb = gn.add_nonnative(b, ax, b_c, False)
    rhs = gn.add_nonnative(b, x3, axb, True)
    gn.connect_nonnative(b, y2, rhs)


def curve_neg(b: CircuitBuilder, p: AffinePointTarget, range_check: bool = True) -> AffinePointTarget:
    return AffinePointTarget(p.curve, p.x, gn.neg_nonnative(b, p.y, range_check))


def curve_conditional_neg(b: CircuitBuilder, p: AffinePointTarget, bool_t: int) -> AffinePointTarget:
    return AffinePointTarget(
        p.curve, p.x, gn.nonnative_conditional_neg(b, p.y, bool_t, True)
    )


def curve_double(b: CircuitBuilder, p: AffinePointTarget,
                 range_check: bool = True) -> AffinePointTarget:
    """lambda = (3x^2 + a) / 2y (curve.rs:160-185)."""
    ff = base_field(p.curve)
    double_y = gn.add_nonnative(b, p.y, p.y, False)
    inv_2y = gn.inv_nonnative(b, double_y, False)
    x2 = gn.mul_nonnative(b, p.x, p.x, False)
    a_c = gn.constant_nonnative(b, ff, p.curve.a)
    t3xa = gn.add_many_nonnative(b, [x2, x2, x2, a_c], False)
    lam = gn.mul_nonnative(b, t3xa, inv_2y, False)
    lam2 = gn.mul_nonnative(b, lam, lam, False)
    x_dbl = gn.add_nonnative(b, p.x, p.x, False)
    x3 = gn.sub_nonnative(b, lam2, x_dbl, range_check)
    xd = gn.sub_nonnative(b, p.x, x3, False)
    lxd = gn.mul_nonnative(b, lam, xd, False)
    y3 = gn.sub_nonnative(b, lxd, p.y, range_check)
    return AffinePointTarget(p.curve, x3, y3)


def curve_repeated_double(b: CircuitBuilder, p: AffinePointTarget, n: int,
                          range_check: bool = True) -> AffinePointTarget:
    result = p
    for _ in range(n - 1):
        result = curve_double(b, result, False)
    return curve_double(b, result, range_check)


def curve_add(b: CircuitBuilder, p1: AffinePointTarget, p2: AffinePointTarget,
              range_check: bool = True) -> AffinePointTarget:
    """Incomplete addition, assumes p1 != ±p2 (curve.rs:202-223)."""
    u = gn.sub_nonnative(b, p2.y, p1.y, False)
    v = gn.sub_nonnative(b, p2.x, p1.x, False)
    v_inv = gn.inv_nonnative(b, v, False)
    s = gn.mul_nonnative(b, u, v_inv, False)
    s2 = gn.mul_nonnative(b, s, s, False)
    x_sum = gn.add_nonnative(b, p2.x, p1.x, False)
    x3 = gn.sub_nonnative(b, s2, x_sum, range_check)
    xd = gn.sub_nonnative(b, p1.x, x3, False)
    prod = gn.mul_nonnative(b, s, xd, False)
    y3 = gn.sub_nonnative(b, prod, p1.y, range_check)
    return AffinePointTarget(p1.curve, x3, y3)


def curve_conditional_add(b: CircuitBuilder, p1: AffinePointTarget, p2: AffinePointTarget,
                          bool_t: int, range_check: bool = True) -> AffinePointTarget:
    """bool ? p1 + p2 : p1 (curve.rs:225-243)."""
    not_b = b.not_(bool_t)
    s = curve_add(b, p1, p2, False)
    x_t = gn.mul_nonnative_by_bool(b, s.x, bool_t)
    y_t = gn.mul_nonnative_by_bool(b, s.y, bool_t)
    x_f = gn.mul_nonnative_by_bool(b, p1.x, not_b)
    y_f = gn.mul_nonnative_by_bool(b, p1.y, not_b)
    x = gn.add_nonnative(b, x_t, x_f, range_check)
    y = gn.add_nonnative(b, y_t, y_f, range_check)
    return AffinePointTarget(p1.curve, x, y)


def curve_scalar_mul(b: CircuitBuilder, p: AffinePointTarget, n: gn.NonNativeTarget,
                     range_check: bool = True) -> AffinePointTarget:
    """Naive double-and-add over all 261 scalar bits (curve.rs:245-285),
    accumulator seeded with the deterministic offset point."""
    bits = gn.split_nonnative_to_bits(b, n)
    rando = cn.deterministic_offset_point(p.curve, 32)
    result = constant_affine_point(b, rando)
    two_i_p = p
    for bit in bits:
        not_bit = b.not_(bit)
        added = curve_add(b, result, two_i_p, False)
        nx_t = gn.mul_nonnative_by_bool(b, added.x, bit)
        nx_f = gn.mul_nonnative_by_bool(b, result.x, not_bit)
        ny_t = gn.mul_nonnative_by_bool(b, added.y, bit)
        ny_f = gn.mul_nonnative_by_bool(b, result.y, not_bit)
        result = AffinePointTarget(
            p.curve,
            gn.add_nonnative(b, nx_t, nx_f, False),
            gn.add_nonnative(b, ny_t, ny_f, False),
        )
        two_i_p = curve_double(b, two_i_p, False)
    neg_r = constant_affine_point(b, -rando)
    return curve_add(b, result, neg_r, range_check)
