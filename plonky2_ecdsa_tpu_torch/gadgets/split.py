"""Scalar digit splitting: nonnative -> 2-bit / 4-bit little-endian digits.

Parity: reference CircuitBuilderSplit (src/gadgets/split_nonnative.rs:10-73) —
bit-decompose each 29-bit limb, zero-pad to a digit multiple, recombine
pairs/quads with mul_add."""

from __future__ import annotations

from ..circuit.builder import CircuitBuilder
from ..circuit.foreign import BITS
from .nonnative import NonNativeTarget


def split_nonnative_to_4_bit_limbs(b: CircuitBuilder, val: NonNativeTarget) -> list:
    bits = []
    for limb in val.limbs:
        bits.extend(b.split_le_base2(limb, BITS))
    while len(bits) % 4:
        bits.append(b.zero())
    two = b.constant(2)
    four = b.constant(4)
    out = []
    for i in range(0, len(bits), 4):
        a, c, d, e = bits[i], bits[i + 1], bits[i + 2], bits[i + 3]
        lower = b.mul_add(c, two, a)
        upper = b.mul_add(e, two, d)
        out.append(b.mul_add(upper, four, lower))
    return out


def split_nonnative_to_2_bit_limbs(b: CircuitBuilder, val: NonNativeTarget) -> list:
    bits = []
    for limb in val.limbs:
        bits.extend(b.split_le_base2(limb, BITS))
    while len(bits) % 2:
        bits.append(b.zero())
    two = b.constant(2)
    return [b.mul_add(bits[i + 1], two, bits[i]) for i in range(0, len(bits), 2)]
