"""GLV endomorphism scalar multiplication gadget (secp256k1 only).

Parity: reference CircuitBuilderGlv (src/gadgets/glv.rs:26-105): hint-decompose
k into (k1, k2, k1_neg, k2_neg) with |ki| < sqrt(n), check in-circuit that
k1_raw + GLV_S * k2_raw == k, apply psi(P) = (beta*x, y), then a 2-bit dual
MSM over the 128-bit scalars.  The decomposition hint is the batched native
lattice decomposition (GLVDecompositionGenerator equivalent, glv.rs:107-171)."""

from __future__ import annotations

import numpy as np

from ..circuit.builder import CircuitBuilder
from ..circuit.foreign import BITS, scalar_field, base_field
from ..curve import native as cn
from . import nonnative as gn
from .curve import AffinePointTarget, curve_conditional_neg
from .curve_msm import curve_msm_circuit

K_LIMBS = -(-129 // BITS)  # div_ceil(128+sign slack, 29) = 5 (glv.rs:62-63)
MASK29 = (1 << BITS) - 1


def secp256k1_glv_beta(b: CircuitBuilder) -> gn.NonNativeTarget:
    return gn.constant_nonnative(b, base_field(cn.SECP256K1), cn.GLV_BETA)


def decompose_secp256k1_scalar(b: CircuitBuilder, k: gn.NonNativeTarget):
    ffs = scalar_field(cn.SECP256K1)
    k1 = gn.add_virtual_nonnative(b, ffs, K_LIMBS)
    k2 = gn.add_virtual_nonnative(b, ffs, K_LIMBS)
    k1_neg = b.add_virtual_target()
    k2_neg = b.add_virtual_target()
    b.assert_bool(k1_neg)
    b.assert_bool(k2_neg)

    def fill(ev, k_ts=list(k.limbs), k1_ts=np.array(k1.limbs),
             k2_ts=np.array(k2.limbs), n1=k1_neg, n2=k2_neg):
        kv = ev.get(k_ts)  # [9, B]
        B = kv.shape[-1]
        k1v = np.zeros((K_LIMBS, B), np.uint64)
        k2v = np.zeros((K_LIMBS, B), np.uint64)
        negs1 = np.zeros(B, np.uint64)
        negs2 = np.zeros(B, np.uint64)
        for j in range(B):
            ki = sum(int(kv[i, j]) << (BITS * i) for i in range(kv.shape[0]))
            a1, a2, s1, s2 = cn.decompose_secp256k1_scalar(ki)
            for i in range(K_LIMBS):
                k1v[i, j] = (a1 >> (BITS * i)) & MASK29
                k2v[i, j] = (a2 >> (BITS * i)) & MASK29
            negs1[j] = s1
            negs2[j] = s2
        ev.set(k1_ts, k1v)
        ev.set(k2_ts, k2v)
        ev.set(n1, negs1)
        ev.set(n2, negs2)

    b.add_op(fill, list(k1.limbs) + list(k2.limbs) + [k1_neg, k2_neg], "glv_decompose")

    # Check k1_raw + GLV_S * k2_raw == k (glv.rs:76-82)
    k1_raw = gn.nonnative_conditional_neg(b, k1, k1_neg, False)
    k2_raw = gn.nonnative_conditional_neg(b, k2, k2_neg, False)
    s = gn.constant_nonnative(b, ffs, cn.GLV_S)
    should_be_k = gn.mul_nonnative(b, s, k2_raw, False)
    should_be_k = gn.add_nonnative(b, should_be_k, k1_raw, True)
    gn.connect_nonnative(b, should_be_k, k)
    return k1, k2, k1_neg, k2_neg


def glv_mul(b: CircuitBuilder, p: AffinePointTarget,
            k: gn.NonNativeTarget) -> AffinePointTarget:
    k1, k2, k1_neg, k2_neg = decompose_secp256k1_scalar(b, k)
    beta = secp256k1_glv_beta(b)
    beta_px = gn.mul_nonnative(b, beta, p.x, True)
    sp = AffinePointTarget(p.curve, beta_px, p.y)
    p_neg = curve_conditional_neg(b, p, k1_neg)
    sp_neg = curve_conditional_neg(b, sp, k2_neg)
    return curve_msm_circuit(b, p_neg, sp_neg, k1, k2)
