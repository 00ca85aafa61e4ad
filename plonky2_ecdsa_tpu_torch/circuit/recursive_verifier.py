"""The recursive verifier: the PLONK constraint identity at zeta and the
whole FRI verification, re-evaluated IN-CIRCUIT from a proof.

Counterpart of ``plonky2_ecdsa_tpu.circuit.recursive_verifier``.  The proofs
it reads are this package's host ``Proof`` objects (numpy u64, extension
values as (c0, c1) tuples); the challenges of the standalone identity check
come from ``prover.verifier.replay_challenges_to_zeta`` on the data's device.

This consumes the recursion surface (Gate.eval_circuit /
circuit.recursion.CircuitExtAlgebra) the way plonky2's recursive verifier
consumes `eval_unfiltered_circuit` (reference: src/gates/mul_nonnative.rs:
132-166 exists precisely so an outer circuit can re-evaluate the gate's
constraints over `ExtensionTarget<D>`).  Scope (VERDICT r2 next #8): the
heavy algebraic half of verification — gate terms, permutation grand-product
terms, LogUp lookup terms, alpha folding, quotient recombination, L0/PI
interpolation — is constrained in-circuit, with the proof's openings and
challenges bound as public inputs (``add_constraint_identity_check``);
``build_recursive_verifier`` below adds the transcript and the FRI query
phase.

Mirrors prover/verifier.py verify_strict's "constraint identity at zeta"
block statement-for-statement; tests/test_torch_recursion_surface.py checks
the in-circuit identity accepts exactly the proofs the native verifier
accepts.
"""

from __future__ import annotations

import numpy as np

from ..fields import goldilocks as gl
from ..fields import goldilocks_host as glh
from ..fields.goldilocks_host import P, W_EXT
from ..prover.data import CircuitData
from ..prover.fri import FriProof
from ..prover.prover import Proof, _map_leaves
from .gates import PublicInputGate
from .recursion import CircuitExtAlgebra, ExtTarget, add_virtual_ext
from .witness import ginv, gmul, gmul_const, gneg, gsub


def ext_mul_base(b, e: ExtTarget, t: int) -> ExtTarget:
    """ExtTarget * base-field target (coordinate-wise)."""
    return ExtTarget(b.mul(e[0], t), b.mul(e[1], t))


def ext_inverse_circuit(b, e: ExtTarget) -> ExtTarget:
    """Hint + check in-circuit GF(p^2) inverse: allocate inv, fill it on the
    host, constrain e * inv == 1 (the gadget-wide hint pattern;
    an all-zero e makes the row unsatisfiable, as for base-field inv)."""
    inv = add_virtual_ext(b)

    def fill(ev, c0=e[0], c1=e[1], o=np.array([inv[0], inv[1]])):
        x0 = ev.get(np.array([c0]))[0]
        x1 = ev.get(np.array([c1]))[0]
        nrm = gsub(gmul(x0, x0), gmul_const(gmul(x1, x1), W_EXT))
        ninv = ginv(nrm)
        ev.set(o, np.stack([gmul(x0, ninv), gmul(gneg(x1), ninv)]))

    b.add_op(fill, [inv[0], inv[1]], "ext_inv")
    alg = CircuitExtAlgebra(b)
    prod = alg.mul(e, inv)
    b.assert_one(prod[0])
    b.assert_zero(prod[1])
    return inv


def ext_pow_const_circuit(b, e: ExtTarget, k: int) -> ExtTarget:
    alg = CircuitExtAlgebra(b)
    r = None
    base = e
    while k:
        if k & 1:
            r = base if r is None else alg.mul(r, base)
        k >>= 1
        if k:
            base = alg.mul(base, base)
    return r if r is not None else alg.one()


def _layout_counts(data: CircuitData):
    """(num_fixed, num_zs, total, nz1) for proofs of `data` (layout order:
    fixed | wires | zs | quotient; nz1 = Z-poly openings at g*zeta)."""
    circuit = data.circuit
    cfg = circuit.config
    C = cfg.num_challenges
    nchunks = cfg.num_routed_wires // cfg.permutation_chunk_size
    lk = data.lookup
    num_fixed = data.fixed_values.shape[0]
    cpc = lk.cols_per_challenge if lk is not None else 0
    num_zs = C * nchunks + C * cpc
    total = num_fixed + cfg.num_wires + num_zs + C * (data.N // data.n)
    nz1 = 2 * C if lk is not None else C
    return num_fixed, num_zs, total, nz1


def add_constraint_identity_check(b, data: CircuitData):
    """Build the in-circuit constraint-identity check for proofs of `data`.

    Allocates virtual targets for the proof openings and challenges,
    registers them as both named inputs (for witness feeding) and public
    inputs (the binding an outer composition layer would consume), and emits
    constraints enforcing

        sum_slots alpha_c^slot * constraint_slot(openings, challenges)
            == Z_H(zeta) * sum_t zeta^(t n) quotient_{c,t}(zeta)

    for every challenge copy c.  Returns the input-name -> target-list dict
    (layout documented per key)."""
    circuit = data.circuit
    cfg = circuit.config
    C = cfg.num_challenges
    lk = data.lookup
    _num_fixed, _num_zs, total, nz1 = _layout_counts(data)

    def ext_vec(name, k):
        es = [add_virtual_ext(b) for _ in range(k)]
        flat = [t for e in es for t in e]
        b.register_input(name, flat)
        b.register_public_inputs(flat)
        return es

    def base_vec(name, k):
        ts = b.add_virtual_targets(k)
        b.register_input(name, ts)
        b.register_public_inputs(ts)
        return ts

    open0 = ext_vec("open0", total)           # layout order: fixed|wires|zs|quot
    open1 = ext_vec("open1", nz1)             # Z polys at g*zeta
    zeta = ext_vec("zeta", 1)[0]
    alphas = base_vec("alphas", C)
    betas = base_vec("betas", C)
    gammas = base_vec("gammas", C)
    lk_alphas = base_vec("lk_alphas", C) if lk is not None else []
    pis = base_vec("pis", circuit.pi.count)
    _emit_constraint_identity(b, data, open0, open1, zeta, alphas, betas,
                              gammas, lk_alphas, pis)
    return {"open0": open0, "open1": open1, "zeta": zeta, "alphas": alphas,
            "betas": betas, "gammas": gammas, "lk_alphas": lk_alphas,
            "pis": pis, "total": total}


def _emit_constraint_identity(b, data: CircuitData, open0, open1, zeta,
                              alphas, betas, gammas, lk_alphas, pis):
    """Emit the constraint-identity connects given pre-allocated targets
    (shared by the standalone surface above and the full recursive verifier,
    which sources the challenges from its in-circuit transcript)."""
    circuit = data.circuit
    cfg = circuit.config
    n = data.n
    N = data.N
    C = cfg.num_challenges
    nr = cfg.num_routed_wires
    chunk = cfg.permutation_chunk_size
    nchunks = nr // chunk
    S = len(circuit.gates)
    nc = cfg.num_constant_cols
    rate = N // n
    lk = data.lookup
    alg = CircuitExtAlgebra(b)
    num_fixed, num_zs, total, nz1 = _layout_counts(data)
    cpc = lk.cols_per_challenge if lk is not None else 0

    o_fixed = 0
    o_wires = num_fixed
    o_zs = o_wires + cfg.num_wires
    o_quot = o_zs + num_zs

    one = alg.one()
    zeta_n = ext_pow_const_circuit(b, zeta, n)
    zh = alg.sub(zeta_n, one)
    nconst = b.constant(n % P)
    # L0(zeta) = zh / (n (zeta - 1))
    l0 = alg.mul(zh, ext_inverse_circuit(
        b, ext_mul_base(b, alg.sub(zeta, one), nconst)))

    # PI column values at zeta (Lagrange over the PI gate rows)
    K = circuit.pi.num_cols
    g = data.g
    pi_at_zeta = []
    for j in range(K):
        acc = alg.zero()
        for blk, row in enumerate(circuit.pi.rows):
            idx = blk * K + j
            if idx < circuit.pi.count:
                grow = pow(g, row, P)
                lrow = alg.mul(zh, ext_inverse_circuit(
                    b, ext_mul_base(b, alg.sub(zeta, alg.const(grow)), nconst)))
                lrow = alg.mul_const(lrow, grow)
                acc = alg.add(acc, ext_mul_base(b, lrow, pis[idx]))
        pi_at_zeta.append(acc)

    wires_o = [open0[o_wires + j] for j in range(cfg.num_wires)]
    consts_o = [open0[o_fixed + j] for j in range(nc)]
    sels = [open0[o_fixed + nc + gi] for gi in range(S)]
    sigmas = [open0[o_fixed + nc + S + j] for j in range(nr)]
    zsp = [open0[o_zs + j] for j in range(num_zs)]
    quot = [open0[o_quot + j] for j in range(C * rate)]

    # gate terms, summed over gates weighted by their selector openings
    max_gate_cons = (data.num_constraint_slots - data.perm_slots
                     - (lk.slots if lk is not None else 0))
    gate_terms = [alg.zero()] * max_gate_cons
    for gi, gate in enumerate(circuit.gates):
        if gate.num_constraints == 0:
            continue
        ctx = {}
        if isinstance(gate, PublicInputGate):
            ctx["pi_vals"] = pi_at_zeta
        cons = gate.eval_circuit(b, wires_o[: gate.num_wires], consts_o, ctx)
        for s, cv in enumerate(cons):
            gate_terms[s] = alg.add(gate_terms[s], alg.mul(sels[gi], cv))

    for c in range(C):
        beta, gamma = betas[c], gammas[c]
        z_zeta = zsp[c * nchunks]
        partials = zsp[c * nchunks + 1 : c * nchunks + nchunks]
        z_gzeta = open1[c]
        combined = alg.zero()
        apow = b.one()  # alpha^slot, base field
        alpha = alphas[c]

        def fold(term, combined, apow):
            return alg.add(combined, ext_mul_base(b, term, apow)), \
                b.mul(apow, alpha)

        combined, apow = fold(alg.mul(l0, alg.sub(z_zeta, one)), combined, apow)
        for t in range(nchunks):
            F = one
            G = one
            for j in range(t * chunk, (t + 1) * chunk):
                kj = circuit.k_coeffs[j]
                bk = b.mul_const(kj % P, beta)
                gamma_j = ExtTarget(gamma, b.zero())
                fj = alg.add(alg.add(wires_o[j], ext_mul_base(b, zeta, bk)),
                             gamma_j)
                gj = alg.add(alg.add(wires_o[j],
                                     ext_mul_base(b, sigmas[j], beta)), gamma_j)
                F = alg.mul(F, fj)
                G = alg.mul(G, gj)
            left = partials[t] if t < nchunks - 1 else z_gzeta
            prev = z_zeta if t == 0 else partials[t - 1]
            combined, apow = fold(alg.sub(alg.mul(left, G), alg.mul(prev, F)),
                                  combined, apow)
        for s in range(max_gate_cons):
            combined, apow = fold(gate_terms[s], combined, apow)

        if lk is not None:
            nb = lk.num_batches
            BSZ = 3
            zoff = C * nchunks + c * cpc
            alpha_lk = ExtTarget(lk_alphas[c], b.zero())
            t_open = open0[o_fixed + lk.table_idx]
            m_open = wires_o[lk.mult_col]
            h_tab = zsp[zoff + nb]
            combined, apow = fold(alg.sub(alg.mul(
                h_tab, alg.sub(alpha_lk, t_open)), m_open), combined, apow)
            gate_ds = []
            for gi, g_ in lk.gates:
                colsg, scalesg = g_.lookup_cols_scales(nb)
                ds = [alg.sub(alpha_lk, alg.mul_const(wires_o[col], scale))
                      for col, scale in zip(colsg, scalesg)]
                gate_ds.append((sels[gi], ds))
            hsum = alg.zero()
            selsum = alg.zero()
            for sel, _ds in gate_ds:
                selsum = alg.add(selsum, sel)
            for bi in range(nb):
                hb = zsp[zoff + bi]
                hsum = alg.add(hsum, hb)
                slot_val = alg.zero()
                for sel, ds in gate_ds:
                    d0, d1, d2 = ds[bi * BSZ : bi * BSZ + BSZ]
                    d01 = alg.mul(d0, d1)
                    D = alg.mul(d01, d2)
                    Nv = alg.add(d01, alg.mul(alg.add(d0, d1), d2))
                    slot_val = alg.add(slot_val, alg.mul(
                        sel, alg.sub(alg.mul(hb, D), Nv)))
                combined, apow = fold(slot_val, combined, apow)
            zlk = zsp[zoff + nb + 1]
            zlk_g = open1[C + c]
            step = alg.add(alg.sub(alg.sub(zlk_g, zlk),
                                   alg.mul(selsum, hsum)), h_tab)
            combined, apow = fold(step, combined, apow)
            combined, apow = fold(alg.mul(l0, zlk), combined, apow)

        qsum = alg.zero()
        zpow = one
        for t in range(rate):
            qsum = alg.add(qsum, alg.mul(zpow, quot[c * rate + t]))
            zpow = alg.mul(zpow, zeta_n)
        rhs = alg.mul(qsum, zh)
        b.connect(combined[0], rhs[0])
        b.connect(combined[1], rhs[1])


def derive_challenges(data: CircuitData, proof: Proof):
    """Replay the verifier transcript up to zeta via the SHARED helper
    (prover.verifier.replay_challenges_to_zeta: one source of truth for the
    schedule prefix), on the data's device.  Returns per-lane u64 arrays for
    feeding the in-circuit identity check."""
    from ..prover.verifier import _to_device, replay_challenges_to_zeta

    B = proof.pis.shape[0]
    (_ch, betas, gammas, lk_alphas, alphas, zeta,
     _z_idx) = replay_challenges_to_zeta(data, _to_device(proof, data.device))
    u64 = gl.to_u64
    return {
        "betas": np.stack([u64(x) for x in betas], 1),
        "gammas": np.stack([u64(x) for x in gammas], 1),
        "lk_alphas": (np.stack([u64(x) for x in lk_alphas], 1)
                      if lk_alphas else np.zeros((B, 0), np.uint64)),
        "alphas": np.stack([u64(x) for x in alphas], 1),
        "zeta": np.stack([u64(zeta[0]), u64(zeta[1])], 1),
    }


def _interleave(ext):
    """ext (c0, c1) of [B, K] u64 -> [B, 2K] u64, (c0, c1) per element."""
    a, c = (np.asarray(x, np.uint64) for x in ext)
    out = np.zeros(a.shape[:-1] + (2 * a.shape[-1],), np.uint64)
    out[..., 0::2] = a
    out[..., 1::2] = c
    return out


def verifier_inputs_from_proof(data: CircuitData, proof: Proof) -> dict:
    """Proof -> witness-input dict for the circuit built by
    add_constraint_identity_check (ext values interleaved (c0, c1))."""
    chs = derive_challenges(data, proof)
    return {
        "open0": _interleave(proof.openings0),
        "open1": _interleave(proof.openings1),
        "zeta": chs["zeta"],
        "alphas": chs["alphas"], "betas": chs["betas"],
        "gammas": chs["gammas"], "lk_alphas": chs["lk_alphas"],
        "pis": proof.pis.astype(np.uint64),
    }


# ===========================================================================
# Full recursive verifier: proof-of-a-proof
#
# Everything the native verifier (prover/verifier.py verify_strict) checks is
# re-derived IN-CIRCUIT: the Fiat-Shamir transcript (CircuitChallenger over
# PoseidonGate rows), the constraint identity at zeta
# (_emit_constraint_identity), the FRI PoW response, the query indices
# (canonical bit-split of the index challenges), every Merkle opening
# (initial trees + fold-layer trees), the reduced-polynomial values, the
# per-layer fold consistency, and the final-polynomial agreement.  The inner
# proof enters the outer circuit purely as WITNESS inputs; the inner
# circuit's fixed-commitment cap is baked in as constants (a per-circuit
# verifier, like plonky2's standard recursion); the inner public inputs are
# re-exported as the outer circuit's public inputs.
#
# The outer circuit must be built under a rate-8 (blowup 2^3) config
# (e.g. CircuitConfig.recursion_ecc_config()): PoseidonGate is
# degree 7.  One outer proof LANE verifies one inner proof lane, so a whole
# batch of inner proofs recurses as one outer batch.
# ===========================================================================


def _ilog2(x: int) -> int:
    assert x & (x - 1) == 0 and x > 0
    return x.bit_length() - 1


def _tree_depth(leaves: int, cap_height: int):
    """(depth, cap_size) exactly as merkle._build_tree_from_digests caps."""
    ch = min(cap_height, _ilog2(leaves))
    return _ilog2(leaves) - ch, 1 << ch


def build_recursive_verifier(b, data: CircuitData, prefix: str = ""):
    """Emit the complete verifier circuit for proofs of `data` into builder
    `b`.  Returns the input-layout dict consumed by
    recursive_verifier_inputs().

    `prefix` namespaces every witness-input name (and is passed through by
    recursive_verifier_inputs), so MULTIPLE verifier blocks can coexist in
    one outer circuit: the building block of proof aggregation
    (build_aggregation_verifier)."""
    from ..prover import fri as fri_mod
    from ..prover import ntt
    from .challenger_circuit import (CircuitChallenger, merkle_verify_circuit,
                                     pow_product_circuit, split_challenge_64)

    circuit = data.circuit
    cfg = circuit.config
    n, N = data.n, data.N
    C = cfg.num_challenges
    nchunks = cfg.num_routed_wires // cfg.permutation_chunk_size
    lk = data.lookup
    caph = cfg.fri.cap_height
    Q = cfg.fri.num_query_rounds
    pow_bits = cfg.fri.proof_of_work_bits
    num_layers, final_size, nfinal = fri_mod.plan(N, cfg)
    num_fixed, num_zs, total, nz1 = _layout_counts(data)
    log2N = _ilog2(N)
    init_depth, init_cap = _tree_depth(N, caph)
    layer_shapes = [_tree_depth(N >> (l + 1), caph) for l in range(num_layers)]
    alg = CircuitExtAlgebra(b)

    def base_vec(name, k):
        ts = b.add_virtual_targets(k)
        b.register_input(prefix + name, ts)
        return ts

    def ext_vec(name, k):
        es = [add_virtual_ext(b) for _ in range(k)]
        b.register_input(prefix + name, [t for e in es for t in e])
        return es

    def cap_vec(name, cap_size):
        ts = base_vec(name, cap_size * 4)
        return [ts[c * 4 : c * 4 + 4] for c in range(cap_size)]

    # ---- proof witness inputs ---------------------------------------------
    pis = base_vec("pis", circuit.pi.count)
    b.register_public_inputs(pis)
    wires_cap = cap_vec("wires_cap", init_cap)
    zs_cap = cap_vec("zs_cap", init_cap)
    quot_cap = cap_vec("quot_cap", init_cap)
    open0 = ext_vec("open0", total)
    open1 = ext_vec("open1", nz1)
    fri_caps = [cap_vec(f"fri_cap{l}", layer_shapes[l][1])
                for l in range(num_layers)]
    final_coeffs = ext_vec("final_coeffs", nfinal)
    pow_witness = base_vec("pow_witness", 1) if pow_bits else []
    init_leaves = base_vec("init_leaves", Q * total)
    init_paths = {name: base_vec(f"init_path_{name}", Q * init_depth * 4)
                  for name in ("fixed", "wires", "zs", "quot")}
    layer_leaves = base_vec("layer_leaves", Q * num_layers * 4)
    layer_paths = [base_vec(f"layer_path{l}", Q * layer_shapes[l][0] * 4)
                   for l in range(num_layers)]

    # ---- transcript (mirrors verify_strict / replay_challenges_to_zeta) ----
    ch = CircuitChallenger(b)
    fcap_u64 = gl.to_u64(data.fixed_tree.cap)  # [cap, 4]
    fixed_cap_const = [[b.constant(int(fcap_u64[c, j])) for j in range(4)]
                       for c in range(fcap_u64.shape[0])]
    ch.observe_cap(fixed_cap_const)
    for t in pis:
        ch.observe(t)
    ch.observe_cap(wires_cap)
    betas, gammas = [], []
    for _ in range(C):
        betas.append(ch.get_challenge())
        gammas.append(ch.get_challenge())
    lk_alphas = [ch.get_challenge() for _ in range(C)] if lk is not None else []
    ch.observe_cap(zs_cap)
    alphas = [ch.get_challenge() for _ in range(C)]
    ch.observe_cap(quot_cap)
    zeta = ExtTarget(*ch.get_ext())

    # constraint identity at zeta, fed by the in-circuit challenges
    _emit_constraint_identity(b, data, open0, open1, zeta, alphas, betas,
                              gammas, lk_alphas, pis)

    for e in open0:
        ch.observe_ext(e)
    for e in open1:
        ch.observe_ext(e)
    fri_alpha = ExtTarget(*ch.get_ext())
    fri_betas = []
    for l in range(num_layers):
        ch.observe_cap(fri_caps[l])
        fri_betas.append(ExtTarget(*ch.get_ext()))
    for e in final_coeffs:
        ch.observe_ext(e)
    if pow_bits:
        ch.check_pow_circuit(pow_witness[0], pow_bits)
    idx_challenges = [ch.get_challenge() for _ in range(Q)]

    # ---- shared per-proof values ------------------------------------------
    z_idx = [c * nchunks for c in range(C)]
    if lk is not None:
        cpc = lk.cols_per_challenge
        z_idx += [C * nchunks + c * cpc + cpc - 1 for c in range(C)]
    apows = [alg.one()]
    for _ in range(total - 1):
        apows.append(alg.mul(apows[-1], fri_alpha))
    apows1 = [alg.one()]
    for _ in range(len(z_idx) - 1):
        apows1.append(alg.mul(apows1[-1], fri_alpha))
    apow_T = alg.mul(apows[-1], fri_alpha)
    # Query-independent halves of the FRI reduced values, hoisted OUT of the
    # per-query loop: sum_i a^i (leaf_i - open_i) = sum_i a^i leaf_i - S0
    # with S0 = sum_i a^i open_i shared by all Q queries (leaf_i is a base
    # target, so the per-query term is a 2-op ext*base mul — this halves the
    # dominant arithmetic-row count of the verifier circuit).
    sum_open0 = alg.zero()
    for i in range(total):
        sum_open0 = alg.add(sum_open0, alg.mul(apows[i], open0[i]))
    sum_open1 = alg.zero()
    for c in range(len(z_idx)):
        sum_open1 = alg.add(sum_open1, alg.mul(apows1[c], open1[c]))
    gzeta = alg.mul_const(zeta, data.g)
    g_N = pow(glh.POWER_OF_TWO_GENERATOR, (1 << 32) // N, P)
    inv2 = pow(2, -1, P)
    sl_off = {"fixed": 0, "wires": num_fixed, "zs": num_fixed + cfg.num_wires,
              "quot": num_fixed + cfg.num_wires + num_zs}
    tree_slices = [("fixed", sl_off["fixed"], num_fixed),
                   ("wires", sl_off["wires"], cfg.num_wires),
                   ("zs", sl_off["zs"], num_zs),
                   ("quot", sl_off["quot"], C * (N // n))]
    tree_caps = {"fixed": fixed_cap_const, "wires": wires_cap,
                 "zs": zs_cap, "quot": quot_cap}

    def ext_select(bit, x, y):
        return ExtTarget(b.select(bit, x[0], y[0]), b.select(bit, x[1], y[1]))

    def inv_base_circuit(t):
        inv = b.add_virtual_target()

        def fill(ev, t=t, inv=inv):
            v = ev.get(t)
            out = np.array([pow(int(x), -1, P) if x else 0
                            for x in v.ravel()], np.uint64).reshape(v.shape)
            ev.set(np.array([inv]), out[None])

        b.add_op(fill, [inv], "inv_base")
        b.assert_one(b.mul(t, inv))
        return inv

    # ---- FRI query checks --------------------------------------------------
    for q in range(Q):
        bits64 = split_challenge_64(b, idx_challenges[q])
        ibits = bits64[:log2N]
        leaf_all = init_leaves[q * total : (q + 1) * total]
        for name, off, k in tree_slices:
            leaf = leaf_all[off : off + k]
            pt = init_paths[name][q * init_depth * 4 : (q + 1) * init_depth * 4]
            path = [pt[d * 4 : d * 4 + 4] for d in range(init_depth)]
            merkle_verify_circuit(b, leaf, ibits, path, tree_caps[name])
        x = pow_product_circuit(b, ibits, g_N, ntt.COSET_SHIFT)

        # reduced value at x: sum_i a^i leaf_i - (hoisted) sum_i a^i open_i
        red0 = alg.zero()
        for i in range(total):
            red0 = alg.add(red0, ext_mul_base(b, apows[i], leaf_all[i]))
        red0 = alg.sub(red0, sum_open0)
        inv_xz = ext_inverse_circuit(b, ExtTarget(b.sub(x, zeta[0]),
                                                  b.mul_const(P - 1, zeta[1])))
        Fv = alg.mul(red0, inv_xz)
        red1 = alg.zero()
        for c, zi in enumerate(z_idx):
            v_t = leaf_all[sl_off["zs"] + zi]
            red1 = alg.add(red1, ext_mul_base(b, apows1[c], v_t))
        red1 = alg.sub(red1, sum_open1)
        inv_xgz = ext_inverse_circuit(b, ExtTarget(b.sub(x, gzeta[0]),
                                                   b.mul_const(P - 1, gzeta[1])))
        Fv = alg.add(Fv, alg.mul(apow_T, alg.mul(red1, inv_xgz)))

        # fold layers
        size = N
        for l in range(num_layers):
            half = size // 2
            depth_l, _cap_l = layer_shapes[l]
            base_idx = (q * num_layers + l) * 4
            ll = layer_leaves[base_idx : base_idx + 4]
            a_val = ExtTarget(ll[0], ll[1])
            b_val = ExtTarget(ll[2], ll[3])
            low_half = b.not_(ibits[_ilog2(size) - 1])
            expect = ext_select(low_half, a_val, b_val)
            b.connect(expect[0], Fv[0])
            b.connect(expect[1], Fv[1])
            pt = layer_paths[l][q * depth_l * 4 : (q + 1) * depth_l * 4]
            path = [pt[d * 4 : d * 4 + 4] for d in range(depth_l)]
            merkle_verify_circuit(b, ll, ibits[: _ilog2(half)], path,
                                  fri_caps[l])
            neg_x = b.mul_const(P - 1, x)
            xj = b.select(low_half, x, neg_x)
            inv2x = inv_base_circuit(b.mul_const(2, xj))
            s_val = alg.add(a_val, b_val)
            d_val = alg.sub(a_val, b_val)
            even = alg.mul_const(s_val, inv2)
            odd = ExtTarget(b.mul(d_val[0], inv2x), b.mul(d_val[1], inv2x))
            Fv = alg.add(even, alg.mul(fri_betas[l], odd))
            x = b.mul(xj, xj)
            size = half

        # final polynomial (Horner at the final-domain point x)
        acc = alg.zero()
        for k in reversed(range(nfinal)):
            acc = alg.add(ext_mul_base(b, acc, x), final_coeffs[k])
        b.connect(acc[0], Fv[0])
        b.connect(acc[1], Fv[1])

    return {
        "total": total, "nz1": nz1, "Q": Q, "num_layers": num_layers,
        "nfinal": nfinal, "init_depth": init_depth, "init_cap": init_cap,
        "layer_shapes": layer_shapes, "pow_bits": pow_bits,
    }


def recursive_verifier_inputs(data: CircuitData, proof: Proof, prefix: str = "") -> dict:
    """Host Proof (B lanes) -> witness-input dict for the circuit built by
    build_recursive_verifier (one outer lane verifies one inner lane;
    `prefix` must match the builder call's)."""
    from ..prover import fri as fri_mod

    cfg = data.circuit.config
    num_layers, _fs, _nfinal = fri_mod.plan(data.N, cfg)
    B = proof.pis.shape[0]

    def u64(a):
        return np.asarray(a, np.uint64)

    def cap_flat(cap):
        a = u64(cap)  # [B, C, 4] (batched)
        assert a.ndim == 3, a.shape
        return a.reshape(B, -1)

    out = {
        "pis": proof.pis.astype(np.uint64),
        "wires_cap": cap_flat(proof.wires_cap),
        "zs_cap": cap_flat(proof.zs_cap),
        "quot_cap": cap_flat(proof.quotient_cap),
        "open0": _interleave(proof.openings0),
        "open1": _interleave(proof.openings1),
        "final_coeffs": _interleave(proof.fri_proof.final_coeffs),
    }
    fp = proof.fri_proof
    for l in range(num_layers):
        out[f"fri_cap{l}"] = cap_flat(fp.caps[l])
    if cfg.fri.proof_of_work_bits:
        out["pow_witness"] = u64(fp.pow_witness).reshape(B, 1)
    leaves = [u64(proof.initial_leaves[name])  # [B, Q, k]
              for name in ("fixed", "wires", "zs", "quot")]
    out["init_leaves"] = np.concatenate(leaves, axis=-1).reshape(B, -1)
    for name in ("fixed", "wires", "zs", "quot"):
        out[f"init_path_{name}"] = u64(proof.initial_paths[name]).reshape(B, -1)
    lls = [u64(fp.layer_leaves[l]) for l in range(num_layers)]  # [B, Q, 4]
    if num_layers:
        out["layer_leaves"] = np.stack(lls, axis=2).reshape(B, -1)
    else:
        out["layer_leaves"] = np.zeros((B, 0), np.uint64)
    for l in range(num_layers):
        out[f"layer_path{l}"] = u64(fp.layer_paths[l]).reshape(B, -1)
    return {prefix + k: v for k, v in out.items()}


# ===========================================================================
# Proof aggregation: one outer circuit that verifies
# TWO inner proof lanes and re-exports BOTH statements' public inputs.
# Folding a batch of 2^k proofs through k levels of this circuit compresses
# them into ONE proof whose public inputs bind every statement — the purpose
# recursion exists for.  Each verifier block is a full build_recursive_
# verifier instantiation (one outer lane per inner lane, as above);
# the blocks share the builder's gate pool, so Poseidon/arithmetic rows pack
# together.
# ===========================================================================


def verifier_circuit(data: CircuitData, config, aggregate: bool = False):
    """The built verifier circuit of proofs of `data` under `config`: one
    verifier block (build_recursive_verifier), or the 2-to-1 aggregation
    (build_aggregation_verifier)."""
    from .builder import CircuitBuilder

    b = CircuitBuilder(config)
    (build_aggregation_verifier if aggregate else build_recursive_verifier)(b, data)
    return b.build()


def build_aggregation_verifier(b, data: CircuitData, fan_in: int = 2):
    """Emit `fan_in` complete verifier blocks for proofs of `data` into
    builder `b`.  Block i's witness inputs are prefixed 'pi_'; the outer
    public inputs are block 0's inner PIs followed by block 1's (the order
    b.register_public_inputs was called in).  Returns the per-block layout
    dicts."""
    return [build_recursive_verifier(b, data, prefix=f"p{i}_")
            for i in range(fan_in)]


def aggregation_inputs(data: CircuitData, proofs: list) -> dict:
    """[fan_in] host Proofs (each B outer-lanes' worth of inner lanes) ->
    witness-input dict for build_aggregation_verifier: outer lane j verifies
    proofs[0] lane j AND proofs[1] lane j."""
    out = {}
    for i, proof in enumerate(proofs):
        out.update(recursive_verifier_inputs(data, proof, prefix=f"p{i}_"))
    return out


def split_proof_lanes(proof: Proof, stride: int = 2) -> list:
    """One B-lane host Proof -> `stride` Proofs of B/stride lanes (lane j of
    part i = original lane j*stride + i), for feeding aggregation_inputs:
    pairing lanes (2j, 2j+1) under one outer lane folds a 2^k-lane batch by
    half per recursion level.  Every array is sliced on its lane axis; the
    layout is shared."""
    def part(i):
        def cut(x):
            return _map_leaves(lambda a: np.asarray(a)[i::stride], x)

        fp = proof.fri_proof
        return Proof(**{k: cut(v) for k, v in vars(proof).items()
                        if k not in ("fri_proof", "layout")},
                     fri_proof=FriProof(**{k: cut(v) for k, v in vars(fp).items()}),
                     layout=proof.layout)

    return [part(i) for i in range(stride)]
