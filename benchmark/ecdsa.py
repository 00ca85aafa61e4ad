"""Plain ECDSA over secp256k1 and P-256 in Python integers: key generation,
signing and verification, in Jacobian coordinates.  The benchmark makes its
statements with it and the reference checks them with it."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Curve:
    name: str
    p: int
    a: int
    b: int
    n: int
    gx: int
    gy: int


CURVES = {
    "secp256k1": Curve(
        "secp256k1", 2**256 - 2**32 - 977, 0, 7,
        0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141,
        0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
        0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8),
    "p256": Curve(
        "p256", 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF,
        0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFC,
        0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B,
        0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551,
        0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296,
        0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5),
}


def _double(c: Curve, P):
    X, Y, Z = P
    if Z == 0 or Y == 0:
        return (1, 1, 0)
    p = c.p
    YY = Y * Y % p
    S = 4 * X * YY % p
    M = (3 * X * X + c.a * pow(Z, 4, p)) % p
    X3 = (M * M - 2 * S) % p
    return (X3, (M * (S - X3) - 8 * YY * YY) % p, 2 * Y * Z % p)


def _add(c: Curve, P, Q):
    if P[2] == 0:
        return Q
    if Q[2] == 0:
        return P
    p = c.p
    Z1Z1, Z2Z2 = P[2] * P[2] % p, Q[2] * Q[2] % p
    U1, U2 = P[0] * Z2Z2 % p, Q[0] * Z1Z1 % p
    S1, S2 = P[1] * Q[2] * Z2Z2 % p, Q[1] * P[2] * Z1Z1 % p
    if U1 == U2:
        return _double(c, P) if S1 == S2 else (1, 1, 0)
    H, R = (U2 - U1) % p, (S2 - S1) % p
    HH = H * H % p
    HHH = H * HH % p
    X3 = (R * R - HHH - 2 * U1 * HH) % p
    return (X3, (R * (U1 * HH - X3) - S1 * HHH) % p, H * P[2] * Q[2] % p)


def _affine(c: Curve, P):
    if P[2] == 0:
        return None
    zi = pow(P[2], -1, c.p)
    return (P[0] * zi * zi % c.p, P[1] * zi * zi * zi % c.p)


def mul(c: Curve, k: int, pt) -> tuple | None:
    """k * pt for an affine pt -> affine point, or None at infinity."""
    R, A = (1, 1, 0), (pt[0], pt[1], 1)
    for bit in bin(k % c.n)[2:]:
        R = _double(c, R)
        if bit == "1":
            R = _add(c, R, A)
    return _affine(c, R)


def on_curve(c: Curve, pt) -> bool:
    x, y = pt
    return (y * y - x * x * x - c.a * x - c.b) % c.p == 0


@dataclass(frozen=True)
class Statement:
    """A signature (r, s) on the message scalar msg under the key pk."""
    msg: int
    r: int
    s: int
    pk: tuple


def sign(c: Curve, sk: int, msg: int, nonce: int) -> Statement:
    """ECDSA signature with a given nonce (the next one where r would be 0)."""
    sk, msg = sk % c.n or 1, msg % c.n
    pk = mul(c, sk, (c.gx, c.gy))
    k = nonce % c.n or 1
    while True:
        R = mul(c, k, (c.gx, c.gy))
        r = R[0] % c.n if R else 0
        s = pow(k, -1, c.n) * (msg + r * sk) % c.n if r else 0
        if r and s:
            return Statement(msg=msg, r=r, s=s, pk=pk)
        k = k + 1


def verify(c: Curve, st: Statement) -> bool:
    if not (0 < st.r < c.n and 0 < st.s < c.n and on_curve(c, st.pk)):
        return False
    w = pow(st.s, -1, c.n)
    a = mul(c, st.msg * w, (c.gx, c.gy))
    b = mul(c, st.r * w, st.pk)
    R = _affine(c, _add(c, (a[0], a[1], 1) if a else (1, 1, 0),
                         (b[0], b[1], 1) if b else (1, 1, 0)))
    return R is not None and R[0] % c.n == st.r


LIMB_BITS = 29


def public_inputs(st: Statement) -> list:
    """The 45 public-input limbs that bind a proof lane to its statement:
    pk.x, pk.y, msg, r, s, each as nine little-endian 29-bit limbs."""
    mask = (1 << LIMB_BITS) - 1
    return [(v >> (LIMB_BITS * j)) & mask
            for v in (st.pk[0], st.pk[1], st.msg, st.r, st.s) for j in range(9)]
