"""4-bit windowed variable-base scalar multiplication.

Parity: reference CircuitBuilderWindowedMul
(src/gadgets/curve_windowed_mul.rs:21-173): precompute a 16-entry window table
offset by a point g (to dodge the zero point), then for each 4-bit digit (MSB
first): 4 doublings + in-circuit table gather + conditional add; finally
subtract the accumulated offset.

Determinism fix (SURVEY.md §7 item 4): the reference's table offset g is
random (curve_windowed_mul.rs:57); here it is a distinct Keccak-derived
deterministic point.  The accumulator start matches the reference: the
KeccakHash::<25>(F::ZERO)-derived point (curve_windowed_mul.rs:139-143)."""

from __future__ import annotations

from ..circuit.builder import CircuitBuilder
from ..circuit.foreign import base_field
from ..curve import native as cn
from . import nonnative as gn
from .curve import (
    AffinePointTarget,
    constant_affine_point,
    curve_add,
    curve_conditional_add,
    curve_neg,
    curve_repeated_double,
)
from .split import split_nonnative_to_4_bit_limbs

WINDOW_SIZE = 4  # curve_windowed_mul.rs:21


def precompute_window(b: CircuitBuilder, p: AffinePointTarget) -> list:
    """[g, p+g, 2p+g, ...] - g  => [g, p, 2p, ..., 15p] with index-0 slot
    holding g (never selected: digit 0 is masked) (curve_windowed_mul.rs:53-72)."""
    g = cn.deterministic_offset_point(p.curve, 31)
    neg_g = constant_affine_point(b, -g)
    multiples = [constant_affine_point(b, g)]
    for i in range(1, 1 << WINDOW_SIZE):
        multiples.append(curve_add(b, p, multiples[i - 1], True))
    for i in range(1, 1 << WINDOW_SIZE):
        multiples[i] = curve_add(b, neg_g, multiples[i], True)
    return multiples


def random_access_curve_points(b: CircuitBuilder, access_index: int,
                               v: list) -> AffinePointTarget:
    """Per-limb in-circuit gather over 16 candidate points
    (curve_windowed_mul.rs:74-118)."""
    assert len(v) == 16
    curve = v[0].curve
    ff = base_field(curve)
    num_limbs = gn.N
    zero = b.zero()

    def limb(p_nn, i):
        return p_nn.limbs[i] if i < len(p_nn.limbs) else zero

    sel_x = [b.random_access(access_index, [limb(p.x, i) for p in v])
             for i in range(num_limbs)]
    sel_y = [b.random_access(access_index, [limb(p.y, i) for p in v])
             for i in range(num_limbs)]
    return AffinePointTarget(
        curve,
        gn.NonNativeTarget(ff, sel_x),
        gn.NonNativeTarget(ff, sel_y),
    )


def if_affine_point(b: CircuitBuilder, bool_t: int, p1: AffinePointTarget,
                    p2: AffinePointTarget) -> AffinePointTarget:
    """bool ? p1 : p2 (curve_windowed_mul.rs:120-129)."""
    return AffinePointTarget(
        p1.curve,
        gn.if_nonnative(b, bool_t, p1.x, p2.x, True),
        gn.if_nonnative(b, bool_t, p1.y, p2.y, True),
    )


def curve_scalar_mul_windowed(b: CircuitBuilder, p: AffinePointTarget,
                              n: gn.NonNativeTarget,
                              range_check: bool = True) -> AffinePointTarget:
    """(curve_windowed_mul.rs:131-173)."""
    curve = p.curve
    windows = split_nonnative_to_4_bit_limbs(b, n)
    start = cn.deterministic_offset_point(curve, 25)
    start_multiplied = start
    for _ in range(len(windows) * WINDOW_SIZE):
        start_multiplied = start_multiplied.double()

    result = constant_affine_point(b, start)
    precomputation = precompute_window(b, p)
    zero = b.zero()
    for i in reversed(range(len(windows))):
        result = curve_repeated_double(b, result, WINDOW_SIZE, False)
        window = windows[i]
        to_add = random_access_curve_points(b, window, precomputation)
        is_zero = b.is_equal(window, zero)
        should_add = b.not_(is_zero)
        result = curve_conditional_add(b, result, to_add, should_add, False)
    to_subtract = constant_affine_point(b, start_multiplied)
    to_add = curve_neg(b, to_subtract, False)
    return curve_add(b, result, to_add, range_check)
