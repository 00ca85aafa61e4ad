"""Fixed-base scalar multiplication with 4-bit windows and constant tables.

Parity: reference fixed_base_curve_mul_circuit
(src/gadgets/curve_fixed_base.rs:18-66): all 66 x 15 table points
t * (16^i) * B are circuit constants (compile-time EC math via the native
layer); only the 16-way gathers and conditional adds are constrained.  The
accumulator offset is the deterministic KeccakHash::<32>(F::ZERO) point
(curve_fixed_base.rs:34-38)."""

from __future__ import annotations

from functools import lru_cache

from ..curve import native as cn
from ..circuit.builder import CircuitBuilder
from . import nonnative as gn
from .curve import (
    AffinePointTarget,
    constant_affine_point,
    curve_add,
    curve_conditional_add,
)
from .curve_windowed import random_access_curve_points
from .split import split_nonnative_to_4_bit_limbs


@lru_cache(maxsize=None)
def _window_tables(curve: cn.CurveParams, base_x: int, base_y: int, num_windows: int):
    """[(16^i)*base multiples t=1..15] for each window i (host EC math)."""
    base = cn.Point(curve, base_x, base_y)
    tables = []
    cur = base
    for _ in range(num_windows):
        row = []
        acc = cur
        for _t in range(1, 16):
            row.append(acc)
            acc = acc + cur
        tables.append(row)
        for _ in range(4):
            cur = cur.double()
    return tables


def fixed_base_curve_mul_circuit(b: CircuitBuilder, base: cn.Point,
                                 scalar: gn.NonNativeTarget) -> AffinePointTarget:
    curve = base.curve
    limbs = split_nonnative_to_4_bit_limbs(b, scalar)
    tables = _window_tables(curve, base.x, base.y, len(limbs))

    rando = cn.deterministic_offset_point(curve, 32)
    zero = b.zero()
    result = constant_affine_point(b, rando)
    for limb, row in zip(limbs, tables):
        # muls_point[t] = t * (16^i) * base, slot 0 duplicates slot 1 (masked)
        muls_point = [constant_affine_point(b, pt) for pt in row]
        muls_point.insert(0, muls_point[0])
        is_zero = b.is_equal(limb, zero)
        should_add = b.not_(is_zero)
        r = random_access_curve_points(b, limb, muls_point)
        result = curve_conditional_add(b, result, r, should_add, False)

    to_add = constant_affine_point(b, -rando)
    return curve_add(b, result, to_add, True)
