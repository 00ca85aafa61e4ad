"""The batched PLONK + FRI prover on int64 tensors.

Counterpart of ``plonky2_ecdsa_tpu.prover.prover``: ``prove_core`` mirrors the
reference's prove_core (prover.py:458-657) stage by stage, with the same
``stop_after`` knobs, and ``make_prover`` its make_jit_prover (prover.py:855)
with the production ``run_vals`` path: the tape's compact value table goes
up, the wires are expanded on the device, and the proof comes back as a host
``Proof`` of numpy u64 arrays (extension values as (c0, c1) tuples).  Field
arithmetic is exact, so for the same witness the proof equals the
reference's value for value.
"""

from __future__ import annotations

import hashlib
import sys
from dataclasses import dataclass

import numpy as np
import torch

from ..circuit.algebra import TorchAlgebra
from ..circuit.gates import PublicInputGate
from ..fields import goldilocks as gl
from ..hash import merkle
from . import fri, ntt
from .challenger import GRIND_EXHAUSTED, Challenger
from .data import Backend, CircuitData


@dataclass
class OpeningLayout:
    """Canonical polynomial order shared by the openings and the FRI reduction."""
    num_fixed: int
    num_wires: int
    num_zs_partials: int
    num_quotient: int

    @property
    def total(self):
        return self.num_fixed + self.num_wires + self.num_zs_partials + self.num_quotient

    def slices(self):
        o = 0
        out = {}
        for name, k in [("fixed", self.num_fixed), ("wires", self.num_wires),
                        ("zs_partials", self.num_zs_partials), ("quotient", self.num_quotient)]:
            out[name] = slice(o, o + k)
            o += k
        return out


@dataclass
class Proof:
    """Device form (prove_core): int64 tensors.  Host form (to_host): numpy
    u64 arrays, extension values as (c0, c1) tuples."""
    pis: object              # [B, npis]
    wires_cap: object        # [B, C, 4]
    zs_cap: object
    quotient_cap: object
    openings0: tuple         # ext [B, layout.total] (everything at zeta)
    openings1: tuple         # ext [B, len(z_idx)] (Z polys at g*zeta)
    fri_proof: fri.FriProof
    initial_leaves: dict     # tree name -> [B, Q, npolys]
    initial_paths: dict      # tree name -> [B, Q, depth, 4]
    layout: OpeningLayout


# Domain points per pass of the quotient and the FRI reduced polynomial:
# bounds the [B, polys, chunk] temporaries (about 1.6 GiB at B=32).
DOMAIN_CHUNK = 1 << 14


# ---------------------------------------------------------------------------
# scans and products (prover.py:41-97, 1057-1119)
# ---------------------------------------------------------------------------

def _prefix_sum_exclusive(x):
    """Z[0] = 0, Z[i] = sum_{j<i} x[j] over the last axis."""
    inc = gl.cumsum_mod(x, -1)
    return torch.cat([torch.zeros_like(inc[..., :1]), inc[..., :-1]], -1)


def _prefix_prod_exclusive(x):
    """Exclusive modular prefix product over the last axis (log depth)."""
    n = x.shape[-1]
    shift = 1
    while shift < n:
        x = torch.cat([x[..., :shift], gl.mul(x[..., shift:], x[..., :-shift])], -1)
        shift *= 2
    return torch.cat([torch.ones_like(x[..., :1]), x[..., :-1]], -1)


def _suffix_prod_exclusive(x):
    """Exclusive modular suffix product over the last axis (log depth)."""
    n = x.shape[-1]
    shift = 1
    while shift < n:
        x = torch.cat([gl.mul(x[..., :-shift], x[..., shift:]), x[..., -shift:]], -1)
        shift *= 2
    return torch.cat([x[..., 1:], torch.ones_like(x[..., :1])], -1)


def _prod_last(x):
    """Product over the last axis (a power of two long)."""
    while x.shape[-1] > 1:
        k = x.shape[-1] // 2
        x = gl.mul(x[..., :k], x[..., k:])
    return x[..., 0]


def _batch_inverse_axis1(x):
    """Montgomery batch inversion along axis 1 of [B, k, n]: one Fermat
    ladder on the product, inv_i = prefix_i * suffix_i / total."""
    if x.shape[1] == 1:
        return gl.inverse(x)
    v = x.movedim(1, -1)                                   # [B, n, k]
    pre = _prefix_prod_exclusive(v)
    suf = _suffix_prod_exclusive(v)
    tinv = gl.inverse(gl.mul(pre[..., -1], v[..., -1]))
    return gl.mul(gl.mul(pre, suf), tinv[..., None]).movedim(-1, 1)


def _chunk_prod(x, chunk: int):
    """[B, nr, n] -> per-chunk products [B, nr/chunk, n]."""
    B, nr, n = x.shape
    return _prod_last(x.reshape(B, nr // chunk, chunk, n).movedim(2, -1))


def _ext_cat(exts):
    return (torch.cat([e[0] for e in exts], -1), torch.cat([e[1] for e in exts], -1))


def _lde_commit(vals, N: int, cap_height: int):
    """Values on H [B, k, n] -> (coefficients, LDE [B, k, N], tree)."""
    coeffs = ntt.intt(vals)
    lde = ntt.coset_ntt_from_coeffs(coeffs, N)
    return coeffs, lde, merkle.build_merkle_tree_from_polys(lde, cap_height)


def _z_columns(data):
    """zs columns opened at g*zeta: each challenge's permutation Z, then
    each challenge's LogUp running sum."""
    cfg = data.circuit.config
    C = cfg.num_challenges
    nchunks = cfg.num_routed_wires // cfg.permutation_chunk_size
    z_idx = [c * nchunks for c in range(C)]
    lk = data.lookup
    if lk is not None:
        cpc = lk.cols_per_challenge
        z_idx += [C * nchunks + c * cpc + cpc - 1 for c in range(C)]
    return z_idx


def _lookup_terms(lk, gate, wires, alpha):
    """One lookup gate's 3-term batches over [B, T, m] wires: (D_b, N_b) with
    D = d0 d1 d2 and N = d0 d1 + (d0 + d1) d2, d = alpha - scale * wire."""
    cols, scales = gate.lookup_cols_scales(lk.num_batches)
    sc = gl.from_ints(scales, wires.device)[None, :, None]
    d = gl.sub(alpha[:, None, None], gl.mul(wires[:, cols], sc))
    B, _T, m = d.shape
    d = d.reshape(B, lk.num_batches, 3, m)
    d0, d1, d2 = d[:, :, 0], d[:, :, 1], d[:, :, 2]
    d01 = gl.mul(d0, d1)
    return gl.mul(d01, d2), gl.add(d01, gl.mul(gl.add(d0, d1), d2))


def _lookup_polys_all(data, wires, alphas):
    """LogUp committed columns on H, per challenge: helpers h_b, the table
    helper m / (alpha - t) and the running sum Z (prover.py:327).  All
    denominators share one batch inversion."""
    circuit = data.circuit
    lk = data.lookup
    n = data.n
    dev = wires.device
    B = wires.shape[0]
    nb = lk.num_batches
    t = np.arange(n, dtype=np.uint64)
    t[1 << circuit.config.range_lookup_limb_bits:] = 0
    t = gl.from_u64(t, dev)
    sels = [gl.from_u64(circuit.selectors[gi], dev) for gi, _g in lk.gates]

    per_c, dens = [], []
    for alpha in alphas:
        gate_Ns = []
        for _gi, g_ in lk.gates:
            D, Ng = _lookup_terms(lk, g_, wires, alpha)
            dens.append(D)
            gate_Ns.append(Ng)
        dens.append(gl.sub(alpha[:, None], t)[:, None])
        per_c.append(gate_Ns)
    inv = _batch_inverse_axis1(torch.cat(dens, 1))
    G = len(lk.gates)
    stride = G * nb + 1
    out = []
    for c, gate_Ns in enumerate(per_c):
        base = c * stride
        helpers = torch.zeros((B, nb, n), dtype=torch.int64, device=dev)
        for g, Ng in enumerate(gate_Ns):
            Dinv = inv[:, base + g * nb: base + (g + 1) * nb]
            helpers = gl.add(helpers, gl.mul(gl.mul(Ng, Dinv), sels[g]))
        h_tab = gl.mul(wires[:, lk.mult_col], inv[:, base + G * nb])
        contrib = gl.sub(gl.sum_mod(helpers, 1), h_tab)
        out.append([helpers[:, b] for b in range(nb)]
                   + [h_tab, _prefix_sum_exclusive(contrib)])
    return out


# ---------------------------------------------------------------------------
# quotient (prover.py:1165) and the FRI reduced polynomial (prover.py:1406)
# ---------------------------------------------------------------------------

def _chunks(N: int):
    return [slice(s, min(N, s + DOMAIN_CHUNK)) for s in range(0, N, DOMAIN_CHUNK)]


def _compute_quotient(data, bk, wires_lde, zs_lde, pi_lde, betas, gammas,
                      alphas, lk_alphas):
    """Combined constraints / Z_H over the LDE coset -> [B, C, N]."""
    circuit = data.circuit
    cfg = circuit.config
    n, N = data.n, data.N
    C = cfg.num_challenges
    nr = cfg.num_routed_wires
    chunk = cfg.permutation_chunk_size
    nchunks = nr // chunk
    S = len(circuit.gates)
    B = wires_lde.shape[0]
    sel_off = cfg.num_constant_cols
    lk = data.lookup
    apows = [gl.powers(a, data.num_constraint_slots) for a in alphas]   # [B, slots]
    ids_full = gl.mul(bk.x[None], bk.k_coeffs[:, None])                # [nr, N]
    zcols = _z_columns(data)
    zsh_full = torch.roll(zs_lde[:, zcols], -(N // n), -1)

    def eval_chunk(sl):
        w = wires_lde[..., sl]
        fixed = bk.fixed_lde[..., sl]
        zsc = zs_lde[..., sl]
        zshc = zsh_full[..., sl]
        pic = pi_lde[..., sl]
        l0 = bk.l0_lde[sl]
        shape = (B, w.shape[-1])
        sig = fixed[sel_off + S:sel_off + S + nr]
        comb = [torch.zeros(shape, dtype=torch.int64, device=w.device) for _ in range(C)]
        for c in range(C):
            beta = betas[c][:, None, None]
            gamma = gammas[c][:, None, None]
            f = gl.add(gl.add(w[:, :nr], gl.mul(ids_full[None, :, sl], beta)), gamma)
            g = gl.add(gl.add(w[:, :nr], gl.mul(sig[None], beta)), gamma)
            fp = _prod_last(f.reshape(B, nchunks, chunk, -1).movedim(2, -1))
            gp = _prod_last(g.reshape(B, nchunks, chunk, -1).movedim(2, -1))
            z = zsc[:, c * nchunks]
            prev = zsc[:, c * nchunks: (c + 1) * nchunks]
            left = torch.cat([prev[:, 1:], zshc[:, c][:, None]], 1)
            term = gl.sub(gl.mul(left, gp), gl.mul(prev, fp))              # [B, nchunks, m]
            wt = gl.mul(term, apows[c][:, 1:1 + nchunks, None])
            comb[c] = gl.add(comb[c], gl.sum_mod(wt, 1))
            l0z = gl.mul(l0, gl.sub(z, 1))
            comb[c] = gl.add(comb[c], gl.mul(l0z, apows[c][:, 0:1]))

        alg = TorchAlgebra(shape, w.device)
        consts = [fixed[j] for j in range(cfg.num_constant_cols)]
        for gi, gate in enumerate(circuit.gates):
            if gate.num_constraints == 0:
                continue
            ctx = {}
            if isinstance(gate, PublicInputGate):
                ctx["pi_vals"] = [pic[:, j] for j in range(gate.num_cols)]
            wires = [w[:, i] for i in range(gate.num_wires)]
            cons = torch.stack([v.expand(shape) for v in gate.eval(alg, wires, consts, ctx)])
            k = cons.shape[0]
            for c in range(C):
                av = apows[c][:, data.perm_slots:data.perm_slots + k].t()[..., None]
                term = gl.sum_mod(gl.mul(cons, av), 0)
                comb[c] = gl.add(comb[c], gl.mul(fixed[sel_off + gi], term))

        if lk is not None:
            nb = lk.num_batches
            base_slot = data.num_constraint_slots - lk.slots
            tv = fixed[lk.table_idx]
            mv = w[:, lk.mult_col]
            for c in range(C):
                a = lk_alphas[c]
                ap = apows[c]
                zoff = C * nchunks + c * lk.cols_per_challenge
                h_tab = zsc[:, zoff + nb]
                # slot 0: h_tab * (alpha - t) - m
                t0 = gl.sub(gl.mul(h_tab, gl.sub(a[:, None], tv)), mv)
                comb[c] = gl.add(comb[c], gl.mul(t0, ap[:, base_slot:base_slot + 1]))
                # slots 1..nb: sum over gates of sel * (h_b * D_b - N_b)
                hb = zsc[:, zoff:zoff + nb]
                cons = torch.zeros_like(hb)
                selsum = torch.zeros(shape, dtype=torch.int64, device=w.device)
                for gi, g_ in lk.gates:
                    sel = fixed[sel_off + gi]
                    D, Ng = _lookup_terms(lk, g_, w, a)
                    cons = gl.add(cons, gl.mul(gl.sub(gl.mul(hb, D), Ng), sel))
                    selsum = gl.add(selsum, sel.expand(shape))
                wt = gl.mul(cons, ap[:, base_slot + 1:base_slot + 1 + nb, None])
                comb[c] = gl.add(comb[c], gl.sum_mod(wt, 1))
                # slot nb+1: Z(gx) - Z(x) - sel_sum * sum_b h_b + h_tab
                zlk = zsc[:, zoff + nb + 1]
                step = gl.add(gl.sub(gl.sub(zshc[:, C + c], zlk),
                                     gl.mul(selsum, gl.sum_mod(hb, 1))), h_tab)
                comb[c] = gl.add(comb[c], gl.mul(step, ap[:, base_slot + 1 + nb:base_slot + 2 + nb]))
                # slot nb+2: L0 * Z (the running sum starts at zero)
                comb[c] = gl.add(comb[c], gl.mul(gl.mul(l0, zlk),
                                                 ap[:, base_slot + 2 + nb:base_slot + 3 + nb]))

        zh = bk.zh_inv[sl]
        return torch.stack([gl.mul(q, zh) for q in comb], 1)

    return torch.cat([eval_chunk(sl) for sl in _chunks(N)], -1)


def _reduced_poly(data, bk, layout, wires_lde, zs_lde, quot_lde, openings0,
                  open_zs_gzeta, zeta, gzeta, alpha, z_idx):
    """F(x) = sum_i a^i (p_i(x) - y_i) / (x - zeta)
            + a^T sum_j a^j (z_j(x) - y'_j) / (x - g zeta)   -> ext [B, N]."""
    N = data.N
    T = layout.total
    B = wires_lde.shape[0]
    apows = ntt.ext_powers(alpha, T)                          # ext [B, T]
    apows1 = ntt.ext_powers(alpha, len(z_idx))
    ye = gl.ext_mul(apows, openings0)
    y = (gl.sum_mod(ye[0], 1), gl.sum_mod(ye[1], 1))
    ye1 = gl.ext_mul(apows1, open_zs_gzeta)
    y1 = (gl.sum_mod(ye1[0], 1), gl.sum_mod(ye1[1], 1))
    apow_T = gl.ext_mul((apows[0][:, -1], apows[1][:, -1]), alpha)

    def bc(e):
        return (e[0][:, None], e[1][:, None])

    def eval_chunk(sl):
        x = bk.x[sl].expand(B, -1)
        inv0 = gl.ext_inverse(gl.ext_sub(gl.ext_from_base(x), bc(zeta)))
        inv1 = gl.ext_inverse(gl.ext_sub(gl.ext_from_base(x), bc(gzeta)))
        fixed = bk.fixed_lde[..., sl]
        polys = torch.cat([fixed[None].expand(B, -1, -1), wires_lde[..., sl],
                           zs_lde[..., sl], quot_lde[..., sl]], 1)   # [B, T, m]
        acc = tuple(gl.sub(gl.sum_mod(gl.mul(polys, apows[i][..., None]), 1), y[i][:, None])
                    for i in range(2))
        F = gl.ext_mul(acc, inv0)
        zp = zs_lde[:, z_idx, sl]
        acc1 = tuple(gl.sub(gl.sum_mod(gl.mul(zp, apows1[i][..., None]), 1), y1[i][:, None])
                     for i in range(2))
        return gl.ext_add(F, gl.ext_mul(bc(apow_T), gl.ext_mul(acc1, inv1)))

    parts = [eval_chunk(sl) for sl in _chunks(N)]
    return (torch.cat([p[0] for p in parts], -1), torch.cat([p[1] for p in parts], -1))


# ---------------------------------------------------------------------------
# prove_core (prover.py:458-657)
# ---------------------------------------------------------------------------

STOP_AFTER = ("commit", "challenges", "zs_vals", "zs", "quotient", "openings", "fri_all")


def prove_core(data, bk: Backend, wires, pi, pis, stop_after: str | None = None):
    """(wires [B, W, n], PI polys [B, K, n], PI values [B, npis]) int64 on
    the backend's device -> Proof of int64 tensors (see to_host).
    stop_after: one of STOP_AFTER, to compare one stage with the reference."""
    assert stop_after in (None,) + STOP_AFTER, stop_after
    cfg = data.circuit.config
    n, N = data.n, data.N
    C = cfg.num_challenges
    nr = cfg.num_routed_wires
    chunk = cfg.permutation_chunk_size
    nchunks = nr // chunk
    B = wires.shape[0]
    caph = cfg.fri.cap_height
    dev = wires.device

    wires_coeffs, wires_lde, wires_tree = _lde_commit(wires, N, caph)
    if stop_after == "commit":
        return wires_tree.cap
    pi_lde = ntt.coset_ntt_from_coeffs(ntt.intt(pi), N)

    # ---- transcript ---------------------------------------------------------
    ch = Challenger((B,), dev)
    fixed_cap = bk.fixed_levels[-1]
    ch.observe_cap(fixed_cap.expand((B,) + fixed_cap.shape))
    ch.observe_array(pis)
    ch.observe_cap(wires_tree.cap)
    betas, gammas = [], []
    for _ in range(C):
        betas.append(ch.get_challenge())
        gammas.append(ch.get_challenge())
    lk = data.lookup
    lk_alphas = [ch.get_challenge() for _ in range(C)] if lk is not None else []
    if stop_after == "challenges":
        return betas, gammas, lk_alphas

    # ---- permutation grand products ----------------------------------------
    routed = wires[:, :nr]
    zs_list = []
    for c in range(C):
        beta = betas[c][:, None, None]
        gamma = gammas[c][:, None, None]
        f = gl.add(gl.add(routed, gl.mul(bk.ids[None], beta)), gamma)
        g = gl.add(gl.add(routed, gl.mul(bk.sig[None], beta)), gamma)
        quot = gl.mul(_chunk_prod(f, chunk), _batch_inverse_axis1(_chunk_prod(g, chunk)))
        R = [quot[:, 0]]
        for t in range(1, nchunks):
            R.append(gl.mul(R[-1], quot[:, t]))
        z = _prefix_prod_exclusive(R[-1])
        zs_list.append(z)
        zs_list += [gl.mul(z, R[t]) for t in range(nchunks - 1)]
    if lk is not None:
        for cols in _lookup_polys_all(data, wires, lk_alphas):
            zs_list += cols
    zs_vals = torch.stack(zs_list, 1)
    if stop_after == "zs_vals":
        return zs_vals
    zs_coeffs, zs_lde, zs_tree = _lde_commit(zs_vals, N, caph)
    if stop_after == "zs":
        return zs_tree.cap
    ch.observe_cap(zs_tree.cap)
    alphas = [ch.get_challenge() for _ in range(C)]

    # ---- quotient -----------------------------------------------------------
    quot_vals = _compute_quotient(data, bk, wires_lde, zs_lde, pi_lde, betas,
                                  gammas, alphas, lk_alphas)
    rate = N // n
    chunks = ntt.coset_intt(quot_vals).reshape(B, C * rate, n)
    quot_lde = ntt.coset_ntt_from_coeffs(chunks, N)
    quot_tree = merkle.build_merkle_tree_from_polys(quot_lde, caph)
    ch.observe_cap(quot_tree.cap)
    if stop_after == "quotient":
        return quot_tree.cap
    zeta = ch.get_ext()

    # ---- openings -----------------------------------------------------------
    layout = OpeningLayout(num_fixed=data.fixed_values.shape[0], num_wires=cfg.num_wires,
                           num_zs_partials=zs_vals.shape[1], num_quotient=C * rate)
    zp = tuple(p[:, None] for p in ntt.ext_powers(zeta, n))       # [B, 1, n]
    gz = (gl.mul(zeta[0], data.g), gl.mul(zeta[1], data.g))
    gzp = tuple(p[:, None] for p in ntt.ext_powers(gz, n))
    z_idx = _z_columns(data)
    openings0 = _ext_cat([ntt.eval_poly_ext(bk.fixed_coeffs[None], zp),
                          ntt.eval_poly_ext(wires_coeffs, zp),
                          ntt.eval_poly_ext(zs_coeffs, zp),
                          ntt.eval_poly_ext(chunks, zp)])
    open_zs_gzeta = ntt.eval_poly_ext(zs_coeffs[:, z_idx], gzp)
    if stop_after == "openings":
        return openings0
    ch.observe_ext_array(openings0)
    ch.observe_ext_array(open_zs_gzeta)

    # ---- FRI ----------------------------------------------------------------
    F = _reduced_poly(data, bk, layout, wires_lde, zs_lde, quot_lde, openings0,
                      open_zs_gzeta, zeta, gz, ch.get_ext(), z_idx)
    fri_proof = fri.fri_prove(ch, F, N, cfg)
    if stop_after == "fri_all":
        return fri_proof

    # ---- initial tree openings ----------------------------------------------
    idx = fri_proof.indices                                        # [B, Q]
    Q = idx.shape[1]
    leaves, paths = {}, {}
    fixed_tree = merkle.MerkleTree(levels=bk.fixed_levels, cap_height=bk.fixed_cap_height)
    leaves["fixed"] = bk.fixed_lde[:, idx].permute(1, 2, 0)       # [B, Q, k]
    paths["fixed"] = fixed_tree.open(idx)
    for name, lde, tree in (("wires", wires_lde, wires_tree), ("zs", zs_lde, zs_tree),
                            ("quot", quot_lde, quot_tree)):
        k = lde.shape[1]
        leaves[name] = torch.gather(lde, 2, idx[:, None, :].expand(B, k, Q)).transpose(1, 2)
        paths[name] = tree.open(idx)

    return Proof(pis=pis, wires_cap=wires_tree.cap, zs_cap=zs_tree.cap,
                 quotient_cap=quot_tree.cap, openings0=openings0,
                 openings1=open_zs_gzeta, fri_proof=fri_proof,
                 initial_leaves=leaves, initial_paths=paths, layout=layout)


# ---------------------------------------------------------------------------
# device proof -> host proof
# ---------------------------------------------------------------------------

def _map_leaves(fn, x):
    """fn over every array of a nesting of tuples, lists and dicts."""
    if isinstance(x, tuple):
        return tuple(_map_leaves(fn, v) for v in x)
    if isinstance(x, list):
        return [_map_leaves(fn, v) for v in x]
    if isinstance(x, dict):
        return {k: _map_leaves(fn, v) for k, v in x.items()}
    return None if x is None else fn(x)


def to_host(p: Proof, pis: np.ndarray) -> Proof:
    """A proof of device tensors -> host Proof: numpy u64 everywhere, the
    query indices int64."""
    def h(x):
        return _map_leaves(gl.to_u64, x)

    fp = p.fri_proof
    return Proof(
        pis=np.asarray(pis, dtype=np.uint64), wires_cap=h(p.wires_cap), zs_cap=h(p.zs_cap),
        quotient_cap=h(p.quotient_cap), openings0=h(p.openings0), openings1=h(p.openings1),
        fri_proof=fri.FriProof(
            caps=h(fp.caps), final_coeffs=h(fp.final_coeffs),
            indices=fp.indices.cpu().numpy(), layer_leaves=h(fp.layer_leaves),
            layer_paths=h(fp.layer_paths), pow_witness=h(fp.pow_witness)),
        initial_leaves=h(p.initial_leaves), initial_paths=h(p.initial_paths), layout=p.layout)


def check_grind(proof: Proof):
    """Raise if any lane's PoW grind exhausted its candidates."""
    pw = proof.fri_proof.pow_witness
    if pw is not None and np.any(np.asarray(pw) == np.uint64(GRIND_EXHAUSTED)):
        raise RuntimeError("PoW grind exhausted candidate space")


def proof_leaves(proof: Proof):
    """(name, array) for every leaf of a host Proof, in a fixed order."""
    fp = proof.fri_proof
    out = [("pis", proof.pis)]

    def add(name, x):
        if isinstance(x, (tuple, list)):
            for i, v in enumerate(x):
                add(f"{name}[{i}]", v)
        elif isinstance(x, dict):
            for k in sorted(x):
                add(f"{name}.{k}", x[k])
        elif x is not None:
            out.append((name, np.asarray(x)))

    for name in ("wires_cap", "zs_cap", "quotient_cap", "openings0", "openings1",
                 "initial_leaves", "initial_paths"):
        add(name, getattr(proof, name))
    for name in ("caps", "final_coeffs", "indices", "layer_leaves", "layer_paths",
                 "pow_witness"):
        add(f"fri.{name}", getattr(fp, name))
    return out


def proof_digest(proof: Proof, lane: int | None = None) -> str:
    """sha256 over the leaves of a host Proof in proof_leaves order (name,
    then the little-endian bytes); with `lane`, over that batch lane alone."""
    h = hashlib.sha256()
    for name, x in proof_leaves(proof):
        if lane is not None:
            x = x[lane]
        h.update(name.encode())
        h.update(np.ascontiguousarray(x.astype("<i8" if x.dtype.kind == "i" else "<u8")).tobytes())
    return h.hexdigest()


def first_difference(a: Proof, b: Proof):
    """None if the two host proofs agree leaf for leaf (values, shapes and
    dtypes), else the name of the first leaf that differs."""
    la, lb = proof_leaves(a), proof_leaves(b)
    if [n for n, _ in la] != [n for n, _ in lb]:
        return "structure"
    for (name, x), (_, y) in zip(la, lb):
        if x.dtype != y.dtype or x.shape != y.shape or not np.array_equal(x, y):
            return name
    return None


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def host_prep(data: CircuitData, W: np.ndarray, pis: np.ndarray):
    """Witness [num_wires, n, B] u64 and PIs [B, npis] u64 -> (wires
    [B, wires, n], PI polynomial values on H [B, K, n]) u64."""
    circuit = data.circuit
    n = data.n
    B = W.shape[-1]
    wires = np.ascontiguousarray(np.moveaxis(W, -1, 0))
    K = circuit.pi.num_cols
    pi_vals = np.zeros((B, K, n), np.uint64)
    for blk, row in enumerate(circuit.pi.rows):
        for j in range(K):
            idx = blk * K + j
            if idx < circuit.pi.count:
                pi_vals[:, j, row] = pis[:, idx]
    return wires, pi_vals


def _inputs_to_device(data, W, pis):
    wires, pi_vals = host_prep(data, W, pis)
    dev = data.device
    return gl.from_u64(wires, dev), gl.from_u64(pi_vals, dev), gl.from_u64(pis, dev)


def prove(data: CircuitData, W, pis: np.ndarray) -> Proof:
    """W: witness [num_wires, n, B] u64 (host); pis [B, npis] u64 -> host
    Proof, computed on the data's device."""
    proof = to_host(prove_core(data, Backend(data), *_inputs_to_device(data, W, pis)), pis)
    check_grind(proof)
    return proof


# Tape-op output roles whose values are structurally < 2^32 (29-bit limbs,
# booleans, small in-gate carries, lookup multiplicities).  They go up as one
# u32 plane; every claim is checked again at dispatch (_vals_split).
_NARROW_ROLES = {
    "mul_nn": ("q", "r"),            # 29-bit limbs (carries are 34-bit: wide)
    "inv_nn": ("inv", "q"),
    "add_nn": ("s", "ovf", "c"),
    "sub_nn": ("s", "ovf", "c"),
    "add_many_nn": ("s", "ovf"),     # its in-gate carries can exceed 32 bits
    "cmp_const": ("d", "brw", "le"),
    "split": ("bits",),
    "is_equal": ("eq",),
    "lookup_mult": ("m_ts",),
    "range_lookup": ("limbs",),      # derived on the device (not uploaded)
    "random_access": ("bits",),
}


def _narrow_mask(circuit) -> np.ndarray:
    """[num_targets] bool: True where the value-table slot is statically
    known < 2^32 (by tape-op semantics or constant value)."""
    mask = np.zeros(circuit.num_targets, bool)
    rm = circuit.read_map
    for op in circuit.tape:
        if op.rec is None:
            continue
        kind, payload = op.rec
        for role in _NARROW_ROLES.get(kind, ()):
            if role in payload:
                mask[rm[np.ravel(np.asarray(payload[role], dtype=np.int64))]] = True
    for tid, v in circuit.constant_values.items():
        if int(v) < 1 << 32:
            mask[rm[tid]] = True
    return mask


def _scatter_maps(data: CircuitData):
    """Static gather maps that realise the witness scatter on the device.

    The tape's value table is far smaller than the wire tensor [B, wires, n],
    so it goes up compacted and is gathered on the device.  Only table rows
    the device gathers are kept (wire positions, PI positions, PI values);
    targets in circuit.derived_tids (range-lookup limbs) are left out and
    derived from their value wires after the gather.  Kept slots are ordered
    [narrow | wide]; the last compact index is a zero slot for unpopulated
    cells."""
    circuit = data.circuit
    cfg = circuit.config
    n = data.n
    T = circuit.num_targets
    keep_mask = np.zeros(T, bool)
    keep_mask[circuit.pos_tids] = True
    keep_mask[circuit.pi_tids] = True
    keep_mask[circuit.derived_tids] = False
    narrow = _narrow_mask(circuit)
    keep_ids = np.concatenate([np.nonzero(keep_mask & narrow)[0],
                               np.nonzero(keep_mask & ~narrow)[0]])
    num_narrow = int((keep_mask & narrow).sum())
    Kc = len(keep_ids)
    new_of = np.full(T + 1, Kc, np.int64)  # default -> zero slot
    new_of[keep_ids] = np.arange(Kc)
    imap = np.full(cfg.num_wires * n, Kc, np.int64)
    imap[circuit.pos_cols * n + circuit.pos_rows] = new_of[circuit.pos_tids]
    K = circuit.pi.num_cols
    imap_pi = np.full(K * n, Kc, np.int64)
    for blk, row in enumerate(circuit.pi.rows):
        for j in range(K):
            idx = blk * K + j
            if idx < circuit.pi.count:
                imap_pi[j * n + row] = new_of[circuit.pi_tids[idx]]
    pit = new_of[circuit.pi_tids]
    layouts = sorted(circuit.range_layouts.items())  # [(bits, (V, nl, lb, rows))]
    rows_arrays = [np.asarray(rows, np.int64) for _, (_V, _nl, _lb, rows) in layouts]
    layout_meta = tuple((bits, V, nl, lb) for bits, (V, nl, lb, _r) in layouts)
    return imap, imap_pi, pit, keep_ids, num_narrow, rows_arrays, layout_meta


class NarrowMisclassification(ValueError):
    """A value the tape classified as narrow (< 2^32) is wider."""


class Prover:
    """The production prover for one circuit on one device (make_jit_prover).

    run_vals takes the tape's value table [T, B] u64 (Circuit.value_table): the
    compacted table goes up (a u32 plane for the values statically known
    below 2^32, u64 for the rest, range-lookup limbs dropped), the wire,
    PI-polynomial and PI tensors are gathered and the limbs re-derived on the
    device, and the proof comes back as a host Proof."""

    def __init__(self, data: CircuitData):
        self.data = data
        self.device = dev = data.device
        self.backend = Backend(data)
        (imap, imap_pi, pit, keep_ids, num_narrow, rows_arrays,
         self._layout_meta) = _scatter_maps(data)
        self._keep_n, self._keep_w = keep_ids[:num_narrow], keep_ids[num_narrow:]
        self._imap = torch.from_numpy(imap).to(dev)
        self._imap_pi = torch.from_numpy(imap_pi).to(dev)
        self._pit = torch.from_numpy(pit).to(dev)
        self._rows = [torch.from_numpy(r).to(dev) for r in rows_arrays]
        self._host_map: np.ndarray | None = None

    def _vals_split(self, vals: np.ndarray):
        """[T, B] u64 -> (narrow u32 [B, Tn], wide u64 [B, Tw + 1]); the last
        wide slot is the zero slot that unpopulated cells gather."""
        vn = vals[self._keep_n]
        over = (vn >> np.uint64(32)).any(axis=1)
        if over.any():
            bad = self._keep_n[np.nonzero(over)[0][:5]]
            raise NarrowMisclassification(
                f"narrow-classified witness targets exceed 32 bits: {bad}")
        w = np.zeros((vals.shape[1], len(self._keep_w) + 1), np.uint64)
        w[:, :-1] = vals[self._keep_w].T
        return np.ascontiguousarray(vn.T.astype(np.uint32)), w

    def _derive_range_limbs(self, w):
        """Range-lookup limb wires from their value wires (prover.py:888):
        limb j of v is (v >> lb*j) & (2^lb - 1)."""
        B = w.shape[0]
        for (_bits, V, nl, lb), rows in zip(self._layout_meta, self._rows):
            v = w[:, :V][:, :, rows]                                 # [B, V, R]
            limbs = [gl.shr(v, lb * j) if j else v for j in range(nl)]
            st = torch.stack(limbs, 2).reshape(B, V * nl, rows.shape[0]) & ((1 << lb) - 1)
            w[:, V:V + V * nl, rows] = st
        return w

    def _expand(self, narrow, wide):
        """Compact table on the device -> (wires, PI polys, PI values)."""
        n = self.data.n
        vals = torch.cat([narrow.to(torch.int64) & gl.M32, wide], 1)   # [B, Kc + 1]
        B = vals.shape[0]
        wires = vals[:, self._imap].reshape(B, self.data.circuit.config.num_wires, n)
        wires = self._derive_range_limbs(wires)
        pi = vals[:, self._imap_pi].reshape(B, self.data.circuit.pi.num_cols, n)
        return wires, pi, vals[:, self._pit]

    def _expand_host(self, vals: np.ndarray) -> np.ndarray:
        """The value table [T, B] -> the full witness [num_wires, n, B] u64 on
        the host (prover.py:992): raw table rows through read_map (the range
        limbs are in the raw table), unpopulated cells from a zero row."""
        circuit = self.data.circuit
        n = self.data.n
        num_wires = circuit.config.num_wires
        if self._host_map is None:
            full = np.full(num_wires * n, vals.shape[0], np.int64)
            full[circuit.pos_cols * n + circuit.pos_rows] = circuit.read_map[circuit.pos_tids]
            self._host_map = full
        B = vals.shape[1]
        vz = np.concatenate([vals, np.zeros((1, B), np.uint64)])
        return vz[self._host_map].reshape(num_wires, n, B)

    def dispatch_vals(self, vals: np.ndarray, pis: np.ndarray):
        """Upload the compact table and enqueue the prove; returns a handle
        for collect().  On a narrow-plane violation the batch is not lost: a
        warning goes to stderr and the table is expanded on the host and
        proved through the full-witness path, on the same device with the
        same kernels (slower: the whole wire tensor goes up)."""
        try:
            vn, vw = self._vals_split(vals)
        except NarrowMisclassification as e:
            print(f"[prover] WARNING: {e}; falling back to the wide witness "
                  "path for this batch", file=sys.stderr)
            wires, pi, pis_dev = _inputs_to_device(self.data, self._expand_host(vals), pis)
        else:
            narrow = torch.from_numpy(vn.view(np.int32)).to(self.device)
            wires, pi, pis_dev = self._expand(narrow, gl.from_u64(vw, self.device))
        return prove_core(self.data, self.backend, wires, pi, pis_dev), pis

    def collect(self, handle) -> Proof:
        proof, pis = handle
        proof = to_host(proof, pis)
        check_grind(proof)
        return proof

    def run_vals(self, vals: np.ndarray, pis: np.ndarray) -> Proof:
        return self.collect(self.dispatch_vals(vals, pis))


def make_prover(data: CircuitData) -> Prover:
    return Prover(data)
