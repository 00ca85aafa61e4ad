"""The plain reference: a verifier of the batched plonky2-style proofs, lane
by lane, on numpy.

It takes the circuit's frozen description (``circuit.Common``: gate list,
public-input rows, lookup layout, FRI parameters and the verifying key, the
Merkle cap of the fixed polynomials) and a proof as plain arrays, and for
every lane

  * replays the Fiat-Shamir transcript (fixed cap, public inputs, wires cap,
    permutation and lookup challenges, zs cap, alphas, quotient cap, zeta,
    the openings, the FRI alpha, each FRI layer's cap and beta, the final
    polynomial, the proof-of-work response, the query indices);
  * checks the constraint identity at zeta: every gate's constraints times
    its selector, the copy-constraint (permutation) products, the LogUp
    range-lookup terms and the public-input binding, combined with powers
    of alpha, equal Z_H(zeta) times the recomposed quotient;
  * checks every query's Merkle openings of the four initial trees and of
    each FRI layer, each fold, and the final polynomial.

Nothing here is taken from the program: it reads the program's proofs only
to judge them.
"""

from __future__ import annotations

import numpy as np

from . import field as f
from . import poseidon2 as ps
from .circuit import Common

TREES = ("fixed", "wires", "zs", "quot")


def _col(e, i):
    return (e[0][:, i], e[1][:, i])


def _mid(e):
    return (e[0][:, None], e[1][:, None])


def verify(common: Common, proof: dict) -> dict:
    """Per-lane verdicts {check name: bool [L]} of a proof of L lanes; a lane
    is accepted where every entry is True."""
    cm = common
    L = proof["pis"].shape[0]
    n, N, C, nr, rate = cm.n, cm.N, cm.C, cm.num_routed, cm.N // cm.n
    verdict = {}

    # ---- transcript ----------------------------------------------------------
    ch = ps.Challenger(L)
    ch.observe_cap(np.broadcast_to(cm.fixed_cap, (L,) + cm.fixed_cap.shape))
    ch.observe_array(proof["pis"])
    ch.observe_cap(proof["wires_cap"])
    betas, gammas = [], []
    for _ in range(C):
        betas.append(ch.challenge())
        gammas.append(ch.challenge())
    lk_alphas = [ch.challenge() for _ in range(C)] if cm.lookup else []
    ch.observe_cap(proof["zs_cap"])
    alphas = [ch.challenge() for _ in range(C)]
    ch.observe_cap(proof["quotient_cap"])
    zeta = ch.ext_challenge()
    o0, o1 = proof["openings0"], proof["openings1"]
    if o0[0].shape != (L, cm.total) or o1[0].shape != (L, len(cm.z_idx)):
        raise ValueError("openings of the wrong shape")
    ch.observe_ext_array(o0)
    ch.observe_ext_array(o1)
    fri_alpha = ch.ext_challenge()
    fri_betas = []
    for cap in proof["fri_caps"]:
        ch.observe_cap(cap)
        fri_betas.append(ch.ext_challenge())
    final = proof["final_coeffs"]
    ch.observe_ext_array(final)
    verdict["pow"] = ch.pow_ok(proof["pow_witness"], cm.pow_bits)
    indices = np.stack([ch.challenge() & np.uint64(N - 1) for _ in range(cm.queries)], -1)
    verdict["indices"] = (indices == proof["indices"].astype(np.uint64)).all(-1)

    # ---- constraint identity at zeta -----------------------------------------
    f0, w0, z0, q0 = cm.offsets
    alg = f.ExtAlgebra((L,))
    one = alg.one()
    zeta_n = f.ext_pow_const(zeta, n)
    zh = f.ext_sub(zeta_n, one)

    def lagrange(row):
        """L_row(zeta) = g^row (zeta^n - 1) / (n (zeta - g^row))."""
        gr = pow(cm.g, row, f.P)
        den = f.ext_scalar(f.ext_sub(zeta, alg.const(gr)), np.uint64(n))
        return f.ext_scalar(f.ext_mul(zh, f.ext_inverse(den)), np.uint64(gr))

    l0 = lagrange(0)
    K = cm.pi_cols
    pi_at_zeta = [alg.zero() for _ in range(K)]
    for i in range(cm.pi_count):
        lag = lagrange(cm.pi_rows[i // K])
        pi_at_zeta[i % K] = f.ext_add(pi_at_zeta[i % K], f.ext_scalar(lag, proof["pis"][:, i]))

    wires = [_col(o0, w0 + j) for j in range(cm.num_wires)]
    consts = [_col(o0, f0 + j) for j in range(cm.num_consts)]
    S = len(cm.gates)
    sels = [_col(o0, f0 + cm.num_consts + gi) for gi in range(S)]
    sigmas = [_col(o0, f0 + cm.num_consts + S + j) for j in range(nr)]
    zs = [_col(o0, z0 + j) for j in range(cm.num_zs)]

    gate_terms = [alg.zero() for _ in range(cm.max_gate_constraints)]
    for gi, gate in enumerate(cm.gates):
        if gate.num_constraints == 0:
            continue
        cons = gate.eval(alg, wires[:gate.num_wires], consts, {"pi_vals": pi_at_zeta})
        for s, v in enumerate(cons):
            gate_terms[s] = f.ext_add(gate_terms[s], f.ext_mul(sels[gi], v))

    chunk, nchunks = cm.chunk, nr // cm.chunk
    identity_ok = np.ones(L, bool)
    for c in range(C):
        beta, gamma = betas[c], gammas[c]
        slots = [f.ext_mul(l0, f.ext_sub(zs[c * nchunks], one))]
        for t in range(nchunks):
            F, G = one, one
            for j in range(t * chunk, (t + 1) * chunk):
                kj = cm.k_coeffs[j]
                fj = f.ext_add(f.ext_add(wires[j], f.ext_scalar(zeta, f.mul(beta, np.uint64(kj)))),
                               (gamma, np.zeros(L, np.uint64)))
                gj = f.ext_add(f.ext_add(wires[j], f.ext_scalar(sigmas[j], beta)),
                               (gamma, np.zeros(L, np.uint64)))
                F, G = f.ext_mul(F, fj), f.ext_mul(G, gj)
            prev = zs[c * nchunks + t]
            left = zs[c * nchunks + t + 1] if t < nchunks - 1 else _col(o1, c)
            slots.append(f.ext_sub(f.ext_mul(left, G), f.ext_mul(prev, F)))
        slots += gate_terms
        if cm.lookup:
            lk = cm.lookup
            nb = lk["num_batches"]
            zoff = C * nchunks + c * (nb + 2)
            alpha_lk = (lk_alphas[c], np.zeros(L, np.uint64))
            t_open = _col(o0, f0 + lk["table_idx"])
            h_tab, zlk = zs[zoff + nb], zs[zoff + nb + 1]
            slots.append(f.ext_sub(f.ext_mul(h_tab, f.ext_sub(alpha_lk, t_open)),
                                   wires[lk["mult_col"]]))
            selsum = alg.zero()
            per_gate = []
            for gi in lk["gates"]:
                cols, scales = cm.gates[gi].lookup_cols_scales(nb)
                ds = [f.ext_sub(alpha_lk, f.ext_scalar(wires[col], np.uint64(sc)))
                      for col, sc in zip(cols, scales)]
                per_gate.append((sels[gi], ds))
                selsum = f.ext_add(selsum, sels[gi])
            hsum = alg.zero()
            for b in range(nb):
                hb = zs[zoff + b]
                hsum = f.ext_add(hsum, hb)
                val = alg.zero()
                for sel, ds in per_gate:
                    d0, d1, d2 = ds[3 * b:3 * b + 3]
                    d01 = f.ext_mul(d0, d1)
                    D = f.ext_mul(d01, d2)
                    Nv = f.ext_add(d01, f.ext_mul(f.ext_add(d0, d1), d2))
                    val = f.ext_add(val, f.ext_mul(sel, f.ext_sub(f.ext_mul(hb, D), Nv)))
                slots.append(val)
            slots.append(f.ext_add(f.ext_sub(f.ext_sub(_col(o1, C + c), zlk),
                                             f.ext_mul(selsum, hsum)), h_tab))
            slots.append(f.ext_mul(l0, zlk))
        if len(slots) != cm.num_slots:
            raise ValueError("constraint slots do not add up")
        combined, apow = alg.zero(), np.ones(L, np.uint64)
        for term in slots:
            combined = f.ext_add(combined, f.ext_scalar(term, apow))
            apow = f.mul(apow, alphas[c])
        qsum, zpow = alg.zero(), one
        for t in range(rate):
            qsum = f.ext_add(qsum, f.ext_mul(zpow, _col(o0, q0 + c * rate + t)))
            zpow = f.ext_mul(zpow, zeta_n)
        identity_ok &= f.ext_eq(combined, f.ext_mul(qsum, zh))
    verdict["identity"] = identity_ok & ~f.ext_eq(zh, alg.zero())

    # ---- FRI queries ------------------------------------------------------------
    idx = indices.astype(np.int64)
    caps = {"fixed": cm.fixed_cap, "wires": proof["wires_cap"], "zs": proof["zs_cap"],
            "quot": proof["quotient_cap"]}
    leaves = []
    for name in TREES:
        leaf = proof["initial_leaves"][name]
        verdict[f"merkle_{name}"] = ps.merkle_ok(
            leaf, idx, proof["initial_paths"][name], caps[name]).all(-1)
        leaves.append(leaf)
    leaf = np.concatenate(leaves, -1)                                   # [L, Q, T]
    if leaf.shape[-1] != cm.total:
        raise ValueError("initial leaves of the wrong width")
    G_N = f.root_of_unity(N)
    x = f.mul(np.uint64(f.MULTIPLICATIVE_GROUP_GENERATOR), _powers_at(G_N, idx))   # the coset point
    zero = np.zeros(idx.shape, np.uint64)

    def ext_powers(a, k):
        out = [(np.ones(L, np.uint64), np.zeros(L, np.uint64))]
        for _ in range(k - 1):
            out.append(f.ext_mul(out[-1], a))
        return (np.stack([p[0] for p in out], -1), np.stack([p[1] for p in out], -1))

    def reduced(apows, vals, ys, point):
        """sum_i a^i (v_i - y_i) / (x - point) over [L, Q]."""
        y = _mid(ys)
        diff = (f.sub(vals, y[0]), np.broadcast_to(f.neg(y[1]), vals.shape))
        term = f.ext_mul(_mid(apows), diff)
        red = (f.sum_mod(term[0], -1), f.sum_mod(term[1], -1))
        den = (f.sub(x, point[0][:, None]), np.broadcast_to(f.neg(point[1])[:, None], x.shape))
        return f.ext_mul(red, f.ext_inverse(den))

    apows = ext_powers(fri_alpha, cm.total)
    Fv = reduced(apows, leaf, o0, zeta)
    gz = f.ext_scalar(zeta, np.uint64(cm.g))
    zcols = [z0 + zi for zi in cm.z_idx]
    F1 = reduced(ext_powers(fri_alpha, len(cm.z_idx)), leaf[..., zcols], o1, gz)
    ap_T = f.ext_mul(_col(apows, cm.total - 1), fri_alpha)
    Fv = f.ext_add(Fv, f.ext_mul(_mid(ap_T), F1))

    fold_ok = np.ones(L, bool)
    inv2 = np.uint64(pow(2, -1, f.P))
    cur, xc, size = idx, x, N
    for li, (cap, ll, path) in enumerate(zip(proof["fri_caps"], proof["layer_leaves"],
                                             proof["layer_paths"])):
        half = size // 2
        j = cur % half
        low = cur < half
        a_val, b_val = (ll[..., 0], ll[..., 1]), (ll[..., 2], ll[..., 3])
        expect = (np.where(low, a_val[0], b_val[0]), np.where(low, a_val[1], b_val[1]))
        fold_ok &= f.ext_eq(expect, Fv).all(-1)
        verdict[f"merkle_fri{li}"] = ps.merkle_ok(ll, j, path, cap).all(-1)
        xj = np.where(low, xc, f.neg(xc))
        s_val, d_val = f.ext_add(a_val, b_val), f.ext_sub(a_val, b_val)
        inv2x = f.inverse(f.add(xj, xj))
        Fv = f.ext_add(f.ext_scalar(s_val, inv2),
                       f.ext_mul(_mid(fri_betas[li]), f.ext_scalar(d_val, inv2x)))
        xc, cur, size = f.mul(xj, xj), j, half
    verdict["fri_folds"] = fold_ok
    if final[0].shape != (L, cm.nfinal) or len(proof["fri_caps"]) != cm.num_layers:
        raise ValueError("FRI proof of the wrong shape")
    acc = (zero, zero)
    for k in range(cm.nfinal - 1, -1, -1):
        acc = f.ext_add((f.mul(acc[0], xc), f.mul(acc[1], xc)),
                        (np.broadcast_to(final[0][:, k:k + 1], xc.shape),
                         np.broadcast_to(final[1][:, k:k + 1], xc.shape)))
    verdict["fri_final"] = f.ext_eq(acc, Fv).all(-1)
    return verdict


def _powers_at(g: int, idx: np.ndarray) -> np.ndarray:
    """g^idx for an int64 index array, by square-and-multiply on the bits."""
    out = np.ones(idx.shape, np.uint64)
    base = g
    e = idx.copy()
    while e.any():
        out = np.where(e & 1, f.mul(out, np.uint64(base)), out)
        base = base * base % f.P
        e >>= 1
    return out


def accepted(verdict: dict) -> np.ndarray:
    return np.logical_and.reduce(list(verdict.values()))
