"""Foreign-field descriptors: circuit-side 29-bit limb form + witness-side
Barrett engine for each nonnative modulus (secp256k1 / P-256 base & scalar).

Mirrors the role of the reference's `FF: PrimeField` type parameter threading
(src/gadgets/nonnative.rs:32-51): `BITS = 29`, 9 limbs for 256-bit fields.
"""

from __future__ import annotations

from functools import lru_cache

from ..curve import native as cn
from ..fields import limbs as lb

BITS = 29  # circuit limb width (reference src/gadgets/nonnative.rs:32)


class ForeignField:
    def __init__(self, name: str, modulus: int):
        self.name = name
        self.m = modulus
        self.num_limbs = -(-modulus.bit_length() // BITS)  # 9 for 256-bit
        self.limbs29 = [(modulus >> (BITS * i)) & ((1 << BITS) - 1) for i in range(self.num_limbs)]
        self.barrett = lb.Modulus(modulus, name)

    def __repr__(self):
        return f"ForeignField({self.name})"


@lru_cache(maxsize=None)
def _ff(name: str, m: int) -> ForeignField:
    return ForeignField(name, m)


def secp256k1_base() -> ForeignField:
    return _ff("secp256k1_base", cn.SECP256K1.p)


def secp256k1_scalar() -> ForeignField:
    return _ff("secp256k1_scalar", cn.SECP256K1.n)


def p256_base() -> ForeignField:
    return _ff("p256_base", cn.P256.p)


def p256_scalar() -> ForeignField:
    return _ff("p256_scalar", cn.P256.n)


def base_field(curve: cn.CurveParams) -> ForeignField:
    return _ff(curve.name + "_base", curve.p)


def scalar_field(curve: cn.CurveParams) -> ForeignField:
    return _ff(curve.name + "_scalar", curve.n)
