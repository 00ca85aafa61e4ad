"""Generic prime-field element classes with the plonky2 `Field` trait shape.

Equivalents of the reference's deliberately-naive P256Base / P256Scalar
(src/field/p256_base.rs, p256_scalar.rs): canonical-int representation,
BigUint-style arithmetic through Python ints, Fermat inversion, and the
plonky2 `Field` constants (ZERO/ONE/TWO/NEG_ONE, BITS, TWO_ADICITY,
MULTIPLICATIVE_GROUP_GENERATOR, POWER_OF_TWO_GENERATOR, order()).  The TPU
compute path uses the limb-tensor machinery (fields/limbs.py,
circuit/foreign.py); these classes are the out-of-circuit oracle / API
parity layer (SURVEY.md §2 #22-23) and back witness generation for P-256.
"""

from __future__ import annotations


class PrimeFieldElement:
    """Value in [0, order); subclasses define ORDER and the generators."""

    ORDER: int = 0
    BITS: int = 0
    TWO_ADICITY: int = 0
    MULTIPLICATIVE_GROUP_GENERATOR: int = 0
    POWER_OF_TWO_GENERATOR: int = 0

    __slots__ = ("v",)

    def __init__(self, v: int):
        self.v = v % self.ORDER

    # ---- plonky2 Field constants -----------------------------------------
    @classmethod
    def zero(cls):
        return cls(0)

    @classmethod
    def one(cls):
        return cls(1)

    @classmethod
    def two(cls):
        return cls(2)

    @classmethod
    def neg_one(cls):
        return cls(cls.ORDER - 1)

    @classmethod
    def order(cls) -> int:
        return cls.ORDER

    @classmethod
    def characteristic(cls) -> int:
        return cls.ORDER

    # ---- arithmetic ------------------------------------------------------
    def __add__(self, o):
        return type(self)(self.v + o.v)

    def __sub__(self, o):
        return type(self)(self.v - o.v)

    def __neg__(self):
        return type(self)(-self.v)

    def __mul__(self, o):
        return type(self)(self.v * o.v)

    def square(self):
        return type(self)(self.v * self.v)

    def double(self):
        return type(self)(self.v * 2)

    def exp_u64(self, e: int):
        return type(self)(pow(self.v, e, self.ORDER))

    def exp(self, e: int):
        return type(self)(pow(self.v, e, self.ORDER))

    def try_inverse(self):
        """Fermat's little theorem, like the reference (p256_base.rs:112-119);
        None for zero."""
        if self.v == 0:
            return None
        return type(self)(pow(self.v, self.ORDER - 2, self.ORDER))

    def inverse(self):
        inv = self.try_inverse()
        assert inv is not None, "inverse of zero"
        return inv

    def is_zero(self) -> bool:
        return self.v == 0

    def __eq__(self, o):
        return type(self) is type(o) and self.v == o.v

    def __hash__(self):
        return hash((type(self).__name__, self.v))

    def __repr__(self):
        return f"{type(self).__name__}({self.v:#x})"

    # ---- conversions (plonky2 biguint/u64-limb surface) ------------------
    @classmethod
    def from_noncanonical_int(cls, v: int):
        return cls(v)

    @classmethod
    def from_u64_limbs(cls, limbs):
        """Little-endian 64-bit limbs -> element (the reference's [u64; 4])."""
        return cls(sum(int(l) << (64 * i) for i, l in enumerate(limbs)))

    def to_u64_limbs(self, n: int = 4):
        return [(self.v >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(n)]

    @classmethod
    def rand(cls, rng):
        """Uniform element (reference Sample::rand; rng: numpy Generator)."""
        return cls(int.from_bytes(rng.bytes((cls.BITS // 8) + 8), "little"))


class P256Base(PrimeFieldElement):
    """Base field of P-256 (reference src/field/p256_base.rs:78-169)."""

    ORDER = 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF
    BITS = 256
    TWO_ADICITY = 1
    # Sage: GF(p).multiplicative_generator() (p256_base.rs:92-93)
    MULTIPLICATIVE_GROUP_GENERATOR = 11
    # g^((p-1)/2) = -1 (p256_base.rs:95-96)
    POWER_OF_TWO_GENERATOR = ORDER - 1


class P256Scalar(PrimeFieldElement):
    """Scalar field of P-256 (reference src/field/p256_scalar.rs:94-128)."""

    ORDER = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551
    BITS = 256
    TWO_ADICITY = 4  # v2(n-1) = 4
    MULTIPLICATIVE_GROUP_GENERATOR = 7
    # g^((n-1)/2^4) (p256_scalar.rs:114-119)
    POWER_OF_TWO_GENERATOR = (
        0xFFC97F062A770992BA807ACE842A3DFC1546CAD004378DAF0592D7FBB41E6602
    )


class Secp256K1Base(PrimeFieldElement):
    """secp256k1 base field (plonky2's Secp256K1Base equivalent,
    SURVEY.md §2.9; [u64;4] PrimeField surface)."""

    ORDER = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
    BITS = 256
    TWO_ADICITY = 1
    MULTIPLICATIVE_GROUP_GENERATOR = 3
    POWER_OF_TWO_GENERATOR = ORDER - 1


class Secp256K1Scalar(PrimeFieldElement):
    """secp256k1 scalar field (plonky2's Secp256K1Scalar equivalent)."""

    ORDER = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
    BITS = 256
    TWO_ADICITY = 6  # v2(n-1) = 6
    MULTIPLICATIVE_GROUP_GENERATOR = 7
    POWER_OF_TWO_GENERATOR = pow(7, (ORDER - 1) >> 6, ORDER)
