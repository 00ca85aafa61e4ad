"""Proof verifier on int64 tensors, batched over proof lanes.

Counterpart of ``plonky2_ecdsa_tpu.prover.verifier``: replays the Fiat-Shamir
transcript, checks the alpha-combined gate + permutation + lookup constraint
identity at zeta against the quotient opening, and runs the FRI query checks
(Merkle paths, fold consistency, final-polynomial agreement).  It runs on the
CircuitData's device; a host ``Proof`` (numpy u64) goes up first.

Two paths:
  * ``verify_strict`` / ``verify``: vectorised over the whole batch (one
    Poseidon2 permutation per transcript or Merkle step covers all B*Q lanes);
  * ``verify_one_exact``: Python-int re-derivation for ONE lane, the readable
    cross-check used by the tests.
"""

from __future__ import annotations

import numpy as np
import torch

from ..circuit.algebra import TorchExtAlgebra
from ..circuit.gates import PublicInputGate
from ..fields import goldilocks as gl
from ..hash import poseidon
from . import fri as fri_mod
from . import ntt
from .challenger import Challenger
from .data import CircuitData, z_columns
from .prover import Proof, _map_leaves

P = gl.P
W = gl.W_EXT


class VerifyError(AssertionError):
    pass


# ---------------------------------------------------------------------------
# Python-int extension helpers (the exact single-lane path)
# ---------------------------------------------------------------------------

def eadd(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def esub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def emul(a, b):
    return ((a[0] * b[0] + W * a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)


def escalar(a, c):
    return (a[0] * c % P, a[1] * c % P)


def einv(a):
    d = (a[0] * a[0] - W * a[1] * a[1]) % P
    di = pow(d, -1, P)
    return (a[0] * di % P, (-a[1]) * di % P)


def epow(a, e):
    r = (1, 0)
    while e:
        if e & 1:
            r = emul(r, a)
        e >>= 1
        a = emul(a, a)
    return r


# ---------------------------------------------------------------------------
# tensor helpers
# ---------------------------------------------------------------------------

def _ext_eq(a, b):
    return (a[0] == b[0]) & (a[1] == b[1])


def _col(e, i):
    """Column i of an ext [B, K] -> ext [B]."""
    return (e[0][:, i], e[1][:, i])


def _mid(e):
    """ext [B] or [B, K] -> [B, 1] or [B, 1, K]: a new axis after the batch's."""
    return (e[0][:, None], e[1][:, None])


def verify_merkle_paths(leaf, idx, path, cap):
    """Recompute the Merkle roots of many openings at once.

    leaf [..., W]; idx [...] int64; path [..., D, 4]; cap [C, 4], or [B, C, 4]
    with B the leading axis of the rest.  Returns bool [...]."""
    cur = poseidon.hash_no_pad(leaf.movedim(-1, 0).contiguous())          # [4, ...]
    i = idx
    for d in range(path.shape[-2]):
        bit = (i & 1).bool()
        sib = path[..., d, :].movedim(-1, 0)
        cur = poseidon.hash_no_pad(torch.cat([torch.where(bit, sib, cur),
                                              torch.where(bit, cur, sib)], 0))
        i = i >> 1
    if cap.dim() == 2:     # one tree shared by all lanes
        sel = cap[i]
    else:
        sel = torch.gather(cap, 1, i.reshape(i.shape[0], -1, 1).expand(-1, -1, 4))
        sel = sel.reshape(i.shape + (4,))
    return (cur.movedim(0, -1) == sel).all(-1)


def _to_device(proof: Proof, dev) -> Proof:
    """Host Proof -> the same Proof as int64 tensors on dev."""
    def up(x):
        return _map_leaves(lambda a: gl.from_u64(a, dev), x)

    fp = proof.fri_proof
    return Proof(
        pis=up(proof.pis), wires_cap=up(proof.wires_cap), zs_cap=up(proof.zs_cap),
        quotient_cap=up(proof.quotient_cap), openings0=up(proof.openings0),
        openings1=up(proof.openings1),
        fri_proof=fri_mod.FriProof(
            caps=up(fp.caps), final_coeffs=up(fp.final_coeffs),
            indices=torch.from_numpy(np.asarray(fp.indices).astype(np.int64)).to(dev),
            layer_leaves=up(fp.layer_leaves), layer_paths=up(fp.layer_paths),
            pow_witness=up(fp.pow_witness)),
        initial_leaves=up(proof.initial_leaves), initial_paths=up(proof.initial_paths),
        layout=proof.layout)


def replay_challenges_to_zeta(data: CircuitData, proof: Proof):
    """Fiat-Shamir replay of the prover's transcript up to zeta, on a proof of
    device tensors: observe the fixed cap, the PIs, the wires cap; draw betas,
    gammas [and lookup alphas]; observe the zs cap; draw alphas; observe the
    quotient cap; draw zeta.  Returns (ch, betas, gammas, lk_alphas, alphas,
    zeta, z_idx) with `ch` the live challenger just after zeta."""
    C = data.circuit.config.num_challenges
    B = proof.pis.shape[0]
    ch = Challenger((B,), proof.pis.device)
    fixed_cap = data.fixed_tree.cap
    ch.observe_cap(fixed_cap.expand((B,) + fixed_cap.shape))
    ch.observe_array(proof.pis)
    ch.observe_cap(proof.wires_cap)
    betas, gammas = [], []
    for _ in range(C):
        betas.append(ch.get_challenge())
        gammas.append(ch.get_challenge())
    lk_alphas = [ch.get_challenge() for _ in range(C)] if data.lookup is not None else []
    ch.observe_cap(proof.zs_cap)
    alphas = [ch.get_challenge() for _ in range(C)]
    ch.observe_cap(proof.quotient_cap)
    zeta = ch.get_ext()
    return ch, betas, gammas, lk_alphas, alphas, zeta, z_columns(data)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def verify(data: CircuitData, proof: Proof) -> bool:
    """True iff every batch lane's proof verifies.

    A structurally malformed proof (wrong dtypes, ranks, missing parts) makes
    the replay raise somewhere; any exception means the proof does not
    verify, so a malformed proof never crashes a verifying service."""
    try:
        verify_strict(data, proof)
    except Exception:
        return False
    return True


def verify_strict(data: CircuitData, proof: Proof):
    """Raises VerifyError with a diagnostic at the first failing check.
    `proof` is a host Proof; the checks run on data.device over all lanes."""
    circuit = data.circuit
    cfg = circuit.config
    n, N = data.n, data.N
    C = cfg.num_challenges
    nr = cfg.num_routed_wires
    chunk = cfg.permutation_chunk_size
    nchunks = nr // chunk
    S = len(circuit.gates)
    nc = cfg.num_constant_cols
    layout = proof.layout
    rate = N // n
    dev = data.device
    proof = _to_device(proof, dev)
    B = proof.pis.shape[0]
    shape = (B,)

    def req(cond, msg):
        if not bool(cond.all()):
            lane = int(torch.nonzero(~cond.reshape(B, -1).all(1))[0, 0])
            raise VerifyError(f"{msg} (first failing lane {lane})")

    # ---- transcript replay (mirrors prove_core exactly) ---------------------
    ch, betas, gammas, lk_alphas, alphas, zeta, z_idx = replay_challenges_to_zeta(data, proof)
    lk = data.lookup
    opens0, opens1 = proof.openings0, proof.openings1     # ext [B, total], [B, len(z_idx)]
    if opens0[0].shape != (B, layout.total) or opens1[0].shape != (B, len(z_idx)):
        raise VerifyError("openings have the wrong shape")
    ch.observe_ext_array(opens0)
    ch.observe_ext_array(opens1)
    fri_alpha = ch.get_ext()

    num_layers, _final_size, nfinal = fri_mod.plan(N, cfg)
    fp = proof.fri_proof
    fri_betas = []
    for li in range(num_layers):
        ch.observe_cap(fp.caps[li])
        fri_betas.append(ch.get_ext())
    final_coeffs = fp.final_coeffs                           # ext [B, nfinal]
    if final_coeffs[0].shape != (B, nfinal):
        raise VerifyError("final polynomial has the wrong length")
    ch.observe_ext_array(final_coeffs)
    if cfg.fri.proof_of_work_bits:
        if fp.pow_witness is None:
            raise VerifyError("missing FRI PoW witness")
        req(ch.check_pow(fp.pow_witness, cfg.fri.proof_of_work_bits), "FRI PoW check failed")
    indices = torch.stack(ch.get_indices(N, cfg.fri.num_query_rounds), -1)    # [B, Q]
    req(indices == fp.indices, "query indices mismatch")

    # ---- constraint identity at zeta ----------------------------------------
    # Every constraint of a challenge goes into one ext tensor [B, slots] in
    # slot order, folded with the powers of alpha at the end; the columns of
    # the permutation and lookup arguments are evaluated stacked, not one
    # wire at a time (the host issues every tensor op, so their number, not
    # their size, is what this part costs).
    sl = layout.slices()
    f0, w0, z0, q0 = (sl[k].start for k in ("fixed", "wires", "zs_partials", "quotient"))

    def cols(e, start, count):
        return (e[0][:, start:start + count], e[1][:, start:start + count])

    def ext_zeros(width):
        z = torch.zeros((B, width), dtype=torch.int64, device=dev)
        return (z, z)

    def pad_to(e, width):
        z = ext_zeros(width - e[0].shape[1])[0]
        return (torch.cat([e[0], z], 1), torch.cat([e[1], z], 1))

    def sum_cols(e):
        return (gl.sum_mod(e[0], 1), gl.sum_mod(e[1], 1))

    alg = TorchExtAlgebra(shape, dev)
    one = alg.one()
    zeta_n = gl.ext_pow_const(zeta, n)
    zh = gl.ext_sub(zeta_n, one)
    req(~_ext_eq(zh, alg.zero()), "zeta landed in H (negligible probability)")

    def lagrange(grows):
        """L_row(zeta) = g^row (zeta^n - 1) / (n (zeta - g^row)) for the rows
        whose g^row the list holds -> ext [B, len(grows)]."""
        gr = gl.from_ints(grows, dev)
        den = (gl.mul(gl.sub(zeta[0][:, None], gr), n % P), gl.mul(zeta[1], n % P)[:, None])
        den = (den[0], den[1].expand_as(den[0]))
        return gl.ext_scalar_mul(gl.ext_mul(_mid(zh), gl.ext_inverse(den)), gr)

    l0 = _col(lagrange([1]), 0)

    # PI column values at zeta: PI_j(zeta) = sum_blk pi[blk K + j] L_row(blk)(zeta)
    K = circuit.pi.num_cols
    count = circuit.pi.count
    if proof.pis.shape != (B, count):
        raise VerifyError("public inputs have the wrong shape")
    pi_at_zeta = [alg.zero()] * K
    if count:
        lag = lagrange([pow(data.g, circuit.pi.rows[i // K], P) for i in range(count)])
        terms = pad_to(gl.ext_scalar_mul(lag, proof.pis), len(circuit.pi.rows) * K)
        summed = tuple(gl.sum_mod(t.reshape(B, -1, K), 1) for t in terms)       # [B, K]
        pi_at_zeta = [_col(summed, j) for j in range(K)]

    wires_e = cols(opens0, w0, cfg.num_wires)
    wires_alg = [_col(wires_e, j) for j in range(cfg.num_wires)]
    consts_alg = [_col(opens0, f0 + j) for j in range(nc)]
    sels = [_col(opens0, f0 + nc + gi) for gi in range(S)]
    zs_e = cols(opens0, z0, layout.num_zs_partials)

    max_gate_cons = (data.num_constraint_slots - data.perm_slots
                     - (lk.slots if lk is not None else 0))
    gate_terms = ext_zeros(max_gate_cons)
    for gi, gate in enumerate(circuit.gates):
        if gate.num_constraints == 0:
            continue
        ctx = {}
        if isinstance(gate, PublicInputGate):
            ctx["pi_vals"] = pi_at_zeta
        cons = gate.eval(alg, wires_alg[:gate.num_wires], consts_alg, ctx)
        cons = (torch.stack([c[0].expand(shape) for c in cons], 1),
                torch.stack([c[1].expand(shape) for c in cons], 1))
        gate_terms = gl.ext_add(gate_terms, pad_to(gl.ext_mul(_mid(sels[gi]), cons),
                                                   max_gate_cons))

    k_coeffs = gl.from_ints(circuit.k_coeffs, dev)                      # [nr]
    routed = cols(wires_e, 0, nr)
    sigmas = cols(opens0, f0 + nc + S, nr)
    for c in range(C):
        beta, gamma = betas[c], gammas[c]
        prev = cols(zs_e, c * nchunks, nchunks)              # Z, then the partial products
        left = (torch.cat([prev[0][:, 1:], opens1[0][:, c:c + 1]], 1),
                torch.cat([prev[1][:, 1:], opens1[1][:, c:c + 1]], 1))
        # f_j = w_j + beta k_j zeta + gamma,  g_j = w_j + beta sigma_j + gamma
        f = gl.ext_add(routed, gl.ext_scalar_mul(_mid(zeta), gl.mul(beta[:, None], k_coeffs)))
        g = gl.ext_add(routed, gl.ext_scalar_mul(sigmas, beta[:, None]))
        f = (gl.add(f[0], gamma[:, None]).reshape(B, nchunks, chunk), f[1].reshape(B, nchunks, chunk))
        g = (gl.add(g[0], gamma[:, None]).reshape(B, nchunks, chunk), g[1].reshape(B, nchunks, chunk))
        F = (f[0][..., 0], f[1][..., 0])
        G = (g[0][..., 0], g[1][..., 0])
        for j in range(1, chunk):
            F = gl.ext_mul(F, (f[0][..., j], f[1][..., j]))
            G = gl.ext_mul(G, (g[0][..., j], g[1][..., j]))
        slots = [_mid(gl.ext_mul(l0, gl.ext_sub(_col(prev, 0), one))),              # L0 (Z - 1)
                 gl.ext_sub(gl.ext_mul(left, G), gl.ext_mul(prev, F)),               # chunk steps
                 gate_terms]

        if lk is not None:
            nb = lk.num_batches
            zoff = C * nchunks + c * lk.cols_per_challenge
            alpha_lk = (lk_alphas[c][:, None], torch.zeros((B, 1), dtype=torch.int64, device=dev))
            t_open = _col(opens0, f0 + lk.table_idx)
            m_open = wires_alg[lk.mult_col]
            hb = cols(zs_e, zoff, nb)
            h_tab = _col(zs_e, zoff + nb)
            zlk = _col(zs_e, zoff + nb + 1)
            # slot 0: h_tab (alpha - t) - m
            slots.append(_mid(gl.ext_sub(gl.ext_mul(h_tab, gl.ext_sub(
                (lk_alphas[c], alpha_lk[1][:, 0]), t_open)), m_open)))
            # slots 1..nb: sel_g (h_b D_b - N_b), summed over the lookup gates
            batch_slots = ext_zeros(nb)
            selsum = alg.zero()
            for gi, g_ in lk.gates:
                colsg, scalesg = g_.lookup_cols_scales(nb)
                looked = (wires_e[0][:, colsg], wires_e[1][:, colsg])             # [B, 3 nb]
                d = gl.ext_sub(alpha_lk, gl.ext_scalar_mul(looked, gl.from_ints(scalesg, dev)))
                d0, d1, d2 = ((d[0].reshape(B, nb, 3)[..., i], d[1].reshape(B, nb, 3)[..., i])
                              for i in range(3))
                d01 = gl.ext_mul(d0, d1)
                D = gl.ext_mul(d01, d2)
                Nv = gl.ext_add(d01, gl.ext_mul(gl.ext_add(d0, d1), d2))
                batch_slots = gl.ext_add(batch_slots, gl.ext_mul(
                    _mid(sels[gi]), gl.ext_sub(gl.ext_mul(hb, D), Nv)))
                selsum = gl.ext_add(selsum, sels[gi])
            slots.append(batch_slots)
            # slot nb+1: Z(g zeta) - Z - sel_sum sum_b h_b + h_tab
            slots.append(_mid(gl.ext_add(gl.ext_sub(gl.ext_sub(
                _col(opens1, C + c), zlk), gl.ext_mul(selsum, sum_cols(hb))), h_tab)))
            # slot nb+2: L0 * Z
            slots.append(_mid(gl.ext_mul(l0, zlk)))

        terms = (torch.cat([t[0] for t in slots], 1), torch.cat([t[1] for t in slots], 1))
        if terms[0].shape[1] != data.num_constraint_slots:
            raise VerifyError("constraint slots do not add up")
        combined = sum_cols(gl.ext_scalar_mul(terms, gl.powers(alphas[c], terms[0].shape[1])))

        qsum = alg.zero()
        zpow = one
        for t in range(rate):
            qsum = gl.ext_add(qsum, gl.ext_mul(zpow, _col(opens0, q0 + c * rate + t)))
            zpow = gl.ext_mul(zpow, zeta_n)
        req(_ext_eq(combined, gl.ext_mul(qsum, zh)), f"constraint identity fails (challenge {c})")

    # ---- FRI query phase, over [B, Q] ---------------------------------------
    bq = tuple(indices.shape)
    tree_caps = {"fixed": data.fixed_tree.cap, "wires": proof.wires_cap,
                 "zs": proof.zs_cap, "quot": proof.quotient_cap}
    leaf_parts = []
    for name in ("fixed", "wires", "zs", "quot"):
        leaves = proof.initial_leaves[name]                    # [B, Q, k]
        req(verify_merkle_paths(leaves, indices, proof.initial_paths[name], tree_caps[name]),
            f"initial merkle proof fails: {name}")
        leaf_parts.append(leaves)
    leaf = torch.cat(leaf_parts, -1)                           # [B, Q, total]
    T = layout.total
    if leaf.shape[-1] != T:
        raise VerifyError("leaf layout mismatch")

    x = gl.from_u64(data.x_lde, dev)[indices]                  # [B, Q]
    zero_bq = torch.zeros(bq, dtype=torch.int64, device=dev)
    x_ext = (x, zero_bq)

    def reduced(apows, vals, ys, point):
        """sum_i a^i (v_i - y_i) / (x - point): vals [B, Q, k] base field,
        ys and apows ext [B, k]."""
        y = _mid(ys)
        diff = (gl.sub(vals, y[0]), gl.neg(y[1]).expand(vals.shape))
        term = gl.ext_mul(_mid(apows), diff)
        red = (gl.sum_mod(term[0], -1), gl.sum_mod(term[1], -1))
        p = _mid(point)
        return gl.ext_mul(red, gl.ext_inverse(gl.ext_sub(x_ext, (p[0].expand(bq), p[1].expand(bq)))))

    apows = ntt.ext_powers(fri_alpha, T)                       # ext [B, T]
    Fv = reduced(apows, leaf, opens0, zeta)
    gz = (gl.mul(zeta[0], data.g), gl.mul(zeta[1], data.g))
    zcols = [sl["zs_partials"].start + zi for zi in z_idx]
    F1 = reduced(ntt.ext_powers(fri_alpha, len(z_idx)), leaf[..., zcols], opens1, gz)
    ap_T = gl.ext_mul(_col(apows, T - 1), fri_alpha)
    Fv = gl.ext_add(Fv, gl.ext_mul(_mid(ap_T), F1))

    # fold layers: x_{l+1}(i mod half) = x_l(i)^2
    cur_idx = indices
    x_cur = x
    inv2 = pow(2, -1, P)
    size = N
    for li in range(num_layers):
        half = size // 2
        j = cur_idx % half
        ll = fp.layer_leaves[li]                               # [B, Q, 4]
        a_val = (ll[..., 0], ll[..., 1])
        b_val = (ll[..., 2], ll[..., 3])
        low_half = cur_idx < half
        expect = (torch.where(low_half, a_val[0], b_val[0]),
                  torch.where(low_half, a_val[1], b_val[1]))
        req(_ext_eq(expect, Fv), f"FRI fold mismatch layer {li}")
        req(verify_merkle_paths(ll, j, fp.layer_paths[li], fp.caps[li]),
            f"FRI layer merkle fails layer {li}")
        # the fold needs x at the even representative j; x_l(j + half) = -x_l(j)
        xj = torch.where(low_half, x_cur, gl.neg(x_cur))
        s_val = gl.ext_add(a_val, b_val)
        d_val = gl.ext_sub(a_val, b_val)
        inv2x = gl.inverse(gl.add(xj, xj))
        even = (gl.mul(s_val[0], inv2), gl.mul(s_val[1], inv2))
        odd = (gl.mul(d_val[0], inv2x), gl.mul(d_val[1], inv2x))
        Fv = gl.ext_add(even, gl.ext_mul(_mid(fri_betas[li]), odd))
        x_cur = gl.square(xj)
        cur_idx = j
        size = half

    # final polynomial agreement (Horner at x_cur)
    acc = (zero_bq, zero_bq)
    for k in range(nfinal - 1, -1, -1):
        acc = (gl.mul(acc[0], x_cur), gl.mul(acc[1], x_cur))
        acc = gl.ext_add(acc, (final_coeffs[0][:, k:k + 1].expand(bq),
                               final_coeffs[1][:, k:k + 1].expand(bq)))
    req(_ext_eq(acc, Fv), "FRI final polynomial mismatch")
    return True


# ---------------------------------------------------------------------------
# exact single-lane path (Python ints)
# ---------------------------------------------------------------------------

def _chal_int(ch):
    return int(gl.to_u64(ch.get_challenge()))


def _chal_ext(ch):
    a = _chal_int(ch)
    return (a, _chal_int(ch))


def _ext_at(e, index):
    return (int(e[0][index]), int(e[1][index]))


def verify_one_exact(data: CircuitData, proof: Proof, b: int):
    """Lane b of a host Proof, re-derived in Python integers; only the
    Poseidon2 calls are tensors (the transcript, and the Merkle paths of the
    lane's queries, checked tree by tree)."""
    circuit = data.circuit
    cfg = circuit.config
    n, N = data.n, data.N
    C = cfg.num_challenges
    nr = cfg.num_routed_wires
    chunk = cfg.permutation_chunk_size
    nchunks = nr // chunk
    S = len(circuit.gates)
    nc = cfg.num_constant_cols
    layout = proof.layout
    rate = N // n
    dev = data.device

    def up(a):
        return gl.from_u64(np.asarray(a, np.uint64), dev)

    def observe_ext(ch, e):
        ch.observe(gl.const(e[0], (), dev))
        ch.observe(gl.const(e[1], (), dev))

    ch = Challenger((), dev)
    ch.observe_cap(data.fixed_tree.cap)
    ch.observe_array(up(proof.pis[b]))
    ch.observe_cap(up(proof.wires_cap[b]))
    betas, gammas = [], []
    for _ in range(C):
        betas.append(_chal_int(ch))
        gammas.append(_chal_int(ch))
    lk = data.lookup
    lk_alphas = [_chal_int(ch) for _ in range(C)] if lk is not None else []
    z_idx = z_columns(data)
    ch.observe_cap(up(proof.zs_cap[b]))
    alphas = [_chal_int(ch) for _ in range(C)]
    ch.observe_cap(up(proof.quotient_cap[b]))
    zeta = _chal_ext(ch)

    sl = layout.slices()
    opens0 = [_ext_at(proof.openings0, (b, i)) for i in range(layout.total)]
    opens1 = [_ext_at(proof.openings1, (b, i)) for i in range(len(z_idx))]
    for e in opens0 + opens1:
        observe_ext(ch, e)

    fixed_o = opens0[sl["fixed"]]
    wires_o = opens0[sl["wires"]]
    zsp_o = opens0[sl["zs_partials"]]
    quot_o = opens0[sl["quotient"]]
    consts_o = fixed_o[:nc]
    sels_o = fixed_o[nc: nc + S]
    sigmas_o = fixed_o[nc + S: nc + S + nr]

    # ---- constraint identity at zeta ----------------------------------------
    zeta_n = epow(zeta, n)
    zh = esub(zeta_n, (1, 0))
    assert zh != (0, 0), "zeta landed in H (negligible probability)"
    l0 = emul(zh, einv(escalar(esub(zeta, (1, 0)), n)))

    K = circuit.pi.num_cols
    pi_at_zeta = []
    g = data.g
    for j in range(K):
        acc = (0, 0)
        for blk, row in enumerate(circuit.pi.rows):
            idx = blk * K + j
            if idx < circuit.pi.count:
                grow = pow(g, row, P)
                lrow = emul(zh, einv(escalar(esub(zeta, (grow, 0)), n)))
                lrow = escalar(lrow, grow)
                acc = eadd(acc, escalar(lrow, int(proof.pis[b, idx])))
        pi_at_zeta.append(acc)

    # gate constraint terms (slot-major), evaluated in the extension algebra
    alg = TorchExtAlgebra((), "cpu")

    def to_alg(e):
        return (gl.const(e[0]), gl.const(e[1]))

    def from_alg(x):
        return (int(gl.to_u64(x[0])), int(gl.to_u64(x[1])))

    wires_alg = [to_alg(w) for w in wires_o]
    consts_alg = [to_alg(c) for c in consts_o]
    max_gate_cons = (data.num_constraint_slots - data.perm_slots
                     - (lk.slots if lk is not None else 0))
    gate_terms = [(0, 0)] * max_gate_cons
    for gi, gate in enumerate(circuit.gates):
        if gate.num_constraints == 0:
            continue
        ctx = {}
        if isinstance(gate, PublicInputGate):
            ctx["pi_vals"] = [to_alg(v) for v in pi_at_zeta]
        cons = gate.eval(alg, wires_alg[:gate.num_wires], consts_alg, ctx)
        sel = sels_o[gi]
        for s, cv in enumerate(cons):
            gate_terms[s] = eadd(gate_terms[s], emul(sel, from_alg(cv)))

    for c in range(C):
        beta, gamma = betas[c], gammas[c]
        z_zeta = zsp_o[c * nchunks]
        partials = zsp_o[c * nchunks + 1: c * nchunks + nchunks]
        z_gzeta = opens1[c]
        combined = (0, 0)
        apow = 1  # alpha^slot; alpha is in the base field
        alpha = alphas[c]

        def add(term, combined, apow):
            return eadd(combined, escalar(term, apow))

        # slot 0: L0 (Z - 1)
        combined = add(emul(l0, esub(z_zeta, (1, 0))), combined, apow)
        apow = apow * alpha % P
        # chunk products
        for t in range(nchunks):
            F = (1, 0)
            G = (1, 0)
            for j in range(t * chunk, (t + 1) * chunk):
                kj = circuit.k_coeffs[j]
                fj = eadd(eadd(wires_o[j], escalar(zeta, beta * kj % P)), (gamma, 0))
                gj = eadd(eadd(wires_o[j], escalar(sigmas_o[j], beta)), (gamma, 0))
                F = emul(F, fj)
                G = emul(G, gj)
            left = partials[t] if t < nchunks - 1 else z_gzeta
            prev = z_zeta if t == 0 else partials[t - 1]
            combined = add(esub(emul(left, G), emul(prev, F)), combined, apow)
            apow = apow * alpha % P
        # gate slots
        for s in range(max_gate_cons):
            combined = add(gate_terms[s], combined, apow)
            apow = apow * alpha % P

        # LogUp lookup slots (mirrors the prover's quotient)
        if lk is not None:
            nb = lk.num_batches
            BSZ = 3
            zoff = C * nchunks + c * lk.cols_per_challenge
            alpha_lk = (lk_alphas[c], 0)
            t_open = fixed_o[lk.table_idx]
            m_open = wires_o[lk.mult_col]
            h_tab = zsp_o[zoff + nb]
            combined = add(esub(emul(h_tab, esub(alpha_lk, t_open)), m_open), combined, apow)
            apow = apow * alpha % P
            gate_ds = []
            for gi, g_ in lk.gates:
                colsg, scalesg = g_.lookup_cols_scales(nb)
                ds = [esub(alpha_lk, escalar(wires_o[col], scale))
                      for col, scale in zip(colsg, scalesg)]
                gate_ds.append((sels_o[gi], ds))
            hsum = (0, 0)
            selsum = (0, 0)
            for sel, _ds in gate_ds:
                selsum = eadd(selsum, sel)
            for bi in range(nb):
                hb = zsp_o[zoff + bi]
                hsum = eadd(hsum, hb)
                slot_val = (0, 0)
                for sel, ds in gate_ds:
                    d0, d1, d2 = ds[bi * BSZ: bi * BSZ + BSZ]
                    d01 = emul(d0, d1)
                    D = emul(d01, d2)
                    Nv = eadd(d01, emul(eadd(d0, d1), d2))
                    slot_val = eadd(slot_val, emul(sel, esub(emul(hb, D), Nv)))
                combined = add(slot_val, combined, apow)
                apow = apow * alpha % P
            zlk = zsp_o[zoff + nb + 1]
            zlk_g = opens1[C + c]
            step = eadd(esub(esub(zlk_g, zlk), emul(selsum, hsum)), h_tab)
            combined = add(step, combined, apow)
            apow = apow * alpha % P
            combined = add(emul(l0, zlk), combined, apow)
            apow = apow * alpha % P

        # quotient recomposition: sum_t zeta^(n t) q_{c,t}(zeta)
        qsum = (0, 0)
        zpow = (1, 0)
        for t in range(rate):
            qsum = eadd(qsum, emul(zpow, quot_o[c * rate + t]))
            zpow = emul(zpow, zeta_n)
        assert combined == emul(qsum, zh), \
            f"constraint identity fails (batch {b}, challenge {c})"

    # ---- FRI ----------------------------------------------------------------
    fri_alpha = _chal_ext(ch)
    fp = proof.fri_proof
    num_layers, _final_size, nfinal = fri_mod.plan(N, cfg)
    layers, final_shift = fri_mod._domain_tables(N, num_layers)
    fri_betas = []
    for li in range(num_layers):
        ch.observe_cap(up(fp.caps[li][b]))
        fri_betas.append(_chal_ext(ch))
    final_coeffs = [_ext_at(fp.final_coeffs, (b, k)) for k in range(nfinal)]
    for e in final_coeffs:
        observe_ext(ch, e)
    if cfg.fri.proof_of_work_bits:
        assert fp.pow_witness is not None, "missing FRI PoW witness"
        assert bool(ch.check_pow(up(fp.pow_witness[b]), cfg.fri.proof_of_work_bits)), \
            "FRI PoW check failed"
    indices = [int(gl.to_u64(ix)) for ix in ch.get_indices(N, cfg.fri.num_query_rounds)]
    assert indices == [int(v) for v in fp.indices[b]], "query indices mismatch"

    gz = emul(zeta, (data.g, 0))
    tree_caps = {"fixed": data.fixed_tree.cap, "wires": up(proof.wires_cap[b]),
                 "zs": up(proof.zs_cap[b]), "quot": up(proof.quotient_cap[b])}
    G_N = gl.root_of_unity(N)

    def merkle_ok(leaves, idx, paths, cap):
        """The lane's Q openings of one tree at once: bool per query."""
        return verify_merkle_paths(up(leaves), torch.tensor(idx, device=dev), up(paths),
                                   cap).tolist()

    tree_order = ("fixed", "wires", "zs", "quot")
    for name in tree_order:
        ok = merkle_ok(proof.initial_leaves[name][b], indices, proof.initial_paths[name][b],
                       tree_caps[name])
        assert all(ok), f"initial merkle proof fails: {name} q{ok.index(False)} (batch {b})"
    cur = indices
    for li in range(num_layers):
        cur = [i % ((N >> li) // 2) for i in cur]
        ok = merkle_ok(fp.layer_leaves[li][b], cur, fp.layer_paths[li][b], up(fp.caps[li][b]))
        assert all(ok), f"FRI layer merkle fails layer {li} q{ok.index(False)}"

    for qi, idx in enumerate(indices):
        leaf_vals = [int(v) for name in tree_order for v in proof.initial_leaves[name][b, qi]]
        assert len(leaf_vals) == layout.total
        x = ntt.COSET_SHIFT * pow(G_N, idx, P) % P
        red0 = (0, 0)
        apow = (1, 0)
        for v, y in zip(leaf_vals, opens0):
            red0 = eadd(red0, emul(apow, esub((v, 0), y)))
            apow = emul(apow, fri_alpha)
        Fv = emul(red0, einv(esub((x, 0), zeta)))
        red1 = (0, 0)
        apow1 = (1, 0)
        for c, zi in enumerate(z_idx):
            vz = leaf_vals[sl["zs_partials"].start + zi]
            red1 = eadd(red1, emul(apow1, esub((vz, 0), opens1[c])))
            apow1 = emul(apow1, fri_alpha)
        Fv = eadd(Fv, emul(apow, emul(red1, einv(esub((x, 0), gz)))))

        # fold layers
        cur_idx = idx
        for li, (shift, gen) in enumerate(layers):
            half = (N >> li) // 2
            j = cur_idx % half
            leaf = fp.layer_leaves[li][b, qi]
            vals = [int(v) for v in leaf]
            a_val = (vals[0], vals[1])
            b_val = (vals[2], vals[3])
            expect = a_val if cur_idx < half else b_val
            assert expect == Fv, f"FRI fold mismatch layer {li} q{qi} (batch {b})"
            xj = shift * pow(gen, j, P) % P
            s_val = eadd(a_val, b_val)
            d_val = esub(a_val, b_val)
            Fv = eadd(escalar(s_val, pow(2, -1, P)),
                      emul(fri_betas[li], escalar(d_val, pow(2 * xj % P, -1, P))))
            cur_idx = j
        # final polynomial
        xfin = final_shift * pow(gl.root_of_unity(N >> num_layers), cur_idx, P) % P
        acc = (0, 0)
        xp = 1
        for coef in final_coeffs:
            acc = eadd(acc, escalar(coef, xp))
            xp = xp * xfin % P
        assert acc == Fv, f"FRI final polynomial mismatch q{qi} (batch {b})"
    return True
