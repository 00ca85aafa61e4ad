"""Top-level ECDSA verification gadgets (the crate's main API).

Parity: reference src/gadgets/ecdsa.rs:18-78:
  verify_secp256k1_message_circuit — GLV path for u2*pk,
  verify_p256_message_circuit — 4-bit windowed path for u2*pk.
Both: assert pk on curve; c = s^-1; u1 = m*c; u2 = r*c;
P = u1*G (fixed-base) + u2*pk; assert r == P.x (scalar-typed bit-cast of the
base-field x, no extra mod-n reduction — relies on canonicity checks, as the
reference does at ecdsa.rs:48-52)."""

from __future__ import annotations

from dataclasses import dataclass

from ..circuit.builder import CircuitBuilder
from ..circuit.foreign import scalar_field
from ..curve import native as cn
from . import nonnative as gn
from .curve import AffinePointTarget, curve_add, curve_assert_valid
from .curve_fixed_base import fixed_base_curve_mul_circuit
from .curve_windowed import curve_scalar_mul_windowed
from .glv import glv_mul


@dataclass
class ECDSASecretKeyTarget:
    sk: gn.NonNativeTarget


@dataclass
class ECDSAPublicKeyTarget:
    point: AffinePointTarget


@dataclass
class ECDSASignatureTarget:
    r: gn.NonNativeTarget
    s: gn.NonNativeTarget


def verify_secp256k1_message_circuit(b: CircuitBuilder, msg: gn.NonNativeTarget,
                                     sig: ECDSASignatureTarget,
                                     pk: ECDSAPublicKeyTarget):
    curve = cn.SECP256K1
    r, s = sig.r, sig.s
    curve_assert_valid(b, pk.point)
    c = gn.inv_nonnative(b, s, False)
    u1 = gn.mul_nonnative(b, msg, c, True)
    u2 = gn.mul_nonnative(b, r, c, True)
    point1 = fixed_base_curve_mul_circuit(b, curve.generator(), u1)
    point2 = glv_mul(b, pk.point, u2)
    point = curve_add(b, point1, point2, True)
    x = gn.NonNativeTarget(scalar_field(curve), list(point.x.limbs))
    gn.connect_nonnative(b, r, x)


def verify_p256_message_circuit(b: CircuitBuilder, msg: gn.NonNativeTarget,
                                sig: ECDSASignatureTarget,
                                pk: ECDSAPublicKeyTarget):
    curve = cn.P256
    r, s = sig.r, sig.s
    curve_assert_valid(b, pk.point)
    c = gn.inv_nonnative(b, s, False)
    u1 = gn.mul_nonnative(b, msg, c, True)
    u2 = gn.mul_nonnative(b, r, c, True)
    point1 = fixed_base_curve_mul_circuit(b, curve.generator(), u1)
    point2 = curve_scalar_mul_windowed(b, pk.point, u2, True)
    point = curve_add(b, point1, point2, True)
    x = gn.NonNativeTarget(scalar_field(curve), list(point.x.limbs))
    gn.connect_nonnative(b, r, x)
