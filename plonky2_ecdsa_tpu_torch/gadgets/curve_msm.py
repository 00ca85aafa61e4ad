"""Dual-scalar MSM with shared 2-bit windows: n*p + m*q.

Parity: reference curve_msm_circuit (src/gadgets/curve_msm.rs:21-79; HEHCC
Alg. 9.23; fails if p == q): 16 precomputed combos i*p + j*q (offset by the
deterministic KeccakHash::<32>(F::ZERO) point), then per digit pair: 2
doublings + gather + conditional add; subtract 4^digits * offset at the end."""

from __future__ import annotations

from ..curve import native as cn
from ..circuit.builder import CircuitBuilder
from . import nonnative as gn
from .curve import (
    AffinePointTarget,
    constant_affine_point,
    curve_add,
    curve_conditional_add,
    curve_repeated_double,
)
from .curve_windowed import random_access_curve_points
from .split import split_nonnative_to_2_bit_limbs


def curve_msm_circuit(b: CircuitBuilder, p: AffinePointTarget, q: AffinePointTarget,
                      n: gn.NonNativeTarget, m: gn.NonNativeTarget) -> AffinePointTarget:
    curve = p.curve
    limbs_n = split_nonnative_to_2_bit_limbs(b, n)
    limbs_m = split_nonnative_to_2_bit_limbs(b, m)
    assert len(limbs_n) == len(limbs_m)
    num_limbs = len(limbs_n)

    rando = cn.deterministic_offset_point(curve, 32)
    rando_t = constant_affine_point(b, rando)
    neg_rando = constant_affine_point(b, -rando)

    # precomputation[i + 4*j] = i*p + j*q (index 0 holds rando, masked out)
    precomputation = [p] * 16
    cur_p = rando_t
    cur_q = rando_t
    for i in range(4):
        precomputation[i] = cur_p
        precomputation[4 * i] = cur_q
        if i < 3:
            cur_p = curve_add(b, cur_p, p, False)
            cur_q = curve_add(b, cur_q, q, False)
    for i in range(1, 4):
        precomputation[i] = curve_add(b, precomputation[i], neg_rando, False)
        precomputation[4 * i] = curve_add(b, precomputation[4 * i], neg_rando, False)
    for i in range(1, 4):
        for j in range(1, 4):
            precomputation[i + 4 * j] = curve_add(
                b, precomputation[i], precomputation[4 * j], False)

    four = b.constant(4)
    zero = b.zero()
    result = rando_t
    for limb_n, limb_m in reversed(list(zip(limbs_n, limbs_m))):
        result = curve_repeated_double(b, result, 2, False)
        index = b.mul_add(four, limb_m, limb_n)
        r = random_access_curve_points(b, index, precomputation)
        is_zero = b.is_equal(index, zero)
        should_add = b.not_(is_zero)
        result = curve_conditional_add(b, result, r, should_add, False)

    start_multiplied = rando
    for _ in range(2 * num_limbs):
        start_multiplied = start_multiplied.double()
    to_add = constant_affine_point(b, -start_multiplied)
    return curve_add(b, result, to_add, True)
