"""The batched PLONK + FRI prover on int64 tensors.

Counterpart of ``plonky2_ecdsa_tpu.prover.prover``: ``prove_core`` mirrors the
reference's prove_core (prover.py:458-657) stage by stage, with the same
``stop_after`` knobs and the col axis of a device mesh (``shard``, see
``parallel/mesh.py``), and ``Prover`` (``make_prover``) its make_jit_prover
(prover.py:855-1048) with the production ``run_vals`` path: the rows of the
tape's value table that the device gathers go up as one u64 table, the wires
are expanded on the device, and the proof comes back as a host ``Proof`` of
numpy u64 arrays (extension values as (c0, c1) tuples), read back as one
packed buffer (prover.py:806-838).  The reference sends the values it knows
to be below 2^32 as a u32 plane and falls back to the full witness where one
is wider; one u64 table cuts no value, so the port needs neither.  On a CUDA
device a ``Prover`` captures that device side once per path and batch size
as CUDA graphs and replays them for every batch (``_CapturedProve``,
``graph.py``), as the reference traces it once and runs each batch as one
device program; ``prove_core`` itself moves no host data to the device and
reads nothing back, so it can be captured.  Field arithmetic is exact, so for the same
witness the proof equals the reference's value for value, sharded or not,
captured or not.  The reference's streamed commit (``stream_commit``) has no
counterpart: it bounds the commit's temporaries, and on an 80 GB H100 the
batch's peak device memory is set later, by the quotient, with or without it.
"""

from __future__ import annotations

import hashlib
import math
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from .. import trace
from ..circuit.algebra import TorchAlgebra
from ..circuit.gates import PublicInputGate
from ..fields import goldilocks as gl
from ..hash import merkle
from ..utils.debug import assert_witness_ok
from . import fri, fri_cuda, graph, ntt
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


def _chunk_prod(x, chunk: int, f=gl):
    """[B, nr, n] -> the products of its runs of `chunk` (a power of two)
    columns [B, nr/chunk, n], halving along the run's axis, in the field
    operations of `f` (the module goldilocks or a TorchAlgebra)."""
    B, nr, n = x.shape
    x = x.reshape(B, nr // chunk, chunk, n)
    while x.shape[2] > 1:
        k = x.shape[2] // 2
        x = f.mul(x[:, :, :k], x[:, :, k:])
    return x[:, :, 0]


def _ext_cat(exts):
    return (torch.cat([e[0] for e in exts], -1), torch.cat([e[1] for e in exts], -1))


def _lde_commit(vals, N: int, cap_height: int):
    """Values on H [B, k, n] -> (coefficients, LDE [B, k, N], tree)."""
    coeffs = ntt.intt(vals)
    lde = ntt.coset_ntt_from_coeffs(coeffs, N)
    return coeffs, lde, merkle.build_merkle_tree_from_polys(lde, cap_height)


# ---------------------------------------------------------------------------
# the col axis of a mesh (prover.py:209-256): `shard` is (process group,
# n_shards).  The column axis is split for the INTT and LDE, the domain axis
# for the pointwise stages (leaf sponge, quotient, FRI reduced polynomial),
# with an all_gather at each stage's end; the rest runs replicated, so every
# rank's proof is the single-device proof.
# ---------------------------------------------------------------------------

def _shard_range(size: int, shard):
    """This rank's [lo, hi) of `size` positions split evenly over the shards."""
    group, ns = shard
    part = size // ns
    lo = dist.get_rank(group) * part
    return lo, lo + part


def _shard_slice(x, shard, dim: int):
    """This rank's 1/ns of x along dim, as a view."""
    lo, hi = _shard_range(x.shape[dim], shard)
    return x.narrow(dim, lo, hi - lo)


def _shard_gather(x, shard, dim: int):
    """Every rank's x joined in rank order along dim (list all_gather and
    torch.cat: the same under gloo and NCCL)."""
    group, ns = shard
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(ns)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def _tree_sharded(lde, cap_height: int, shard) -> merkle.MerkleTree:
    """Tree over a poly-major LDE [B, k, N]: each rank hashes the leaves of
    its N/ns domain slice (a strided view, read in place), the digests are
    gathered, and every rank builds the same tree."""
    digests = merkle.leaf_digests_from_polys(_shard_slice(lde, shard, -1))
    return merkle.build_tree_from_digests(_shard_gather(digests, shard, -2), cap_height)


def _lde_commit_sharded(vals, N: int, cap_height: int, shard):
    """_lde_commit with the columns split over the shards for the INTT and
    LDE (left whole where ns does not divide them) and the domain split for
    the leaf hashing; the same output on every rank."""
    split_cols = vals.shape[1] % shard[1] == 0
    loc = _shard_slice(vals, shard, 1).contiguous() if split_cols else vals
    coeffs = ntt.intt(loc)
    lde = ntt.coset_ntt_from_coeffs(coeffs, N)
    if split_cols:
        coeffs, lde = _shard_gather(coeffs, shard, 1), _shard_gather(lde, shard, 1)
    return coeffs, lde, _tree_sharded(lde, cap_height, shard)


def _lookup_terms(bk, lk, g: int, wires, alpha, f):
    """Lookup gate g's (of lk.gates) 3-term batches over [B, T, m] wires:
    (D_b, N_b) with D = d0 d1 d2 and N = d0 d1 + (d0 + d1) d2, d = alpha -
    scale * wire, in the field operations of `f` (the module goldilocks or
    a TorchAlgebra)."""
    d = f.sub(alpha[:, None, None], f.mul(wires[:, bk.lookup_cols[g]], bk.lookup_scales[g]))
    B, _T, m = d.shape
    d = d.reshape(B, lk.num_batches, 3, m)
    d0, d1, d2 = d[:, :, 0], d[:, :, 1], d[:, :, 2]
    d01 = f.mul(d0, d1)
    return f.mul(d01, d2), f.add(d01, f.mul(f.add(d0, d1), d2))


def lookup_counts(data) -> dict:
    """The LogUp work of a batch's Z stage (_lookup_polys_all), lane by
    lane: its challenges, the helper columns (3-term batches) a challenge,
    the lookup gates, and the denominator columns batch-inverted across the
    challenges (a batch's per gate and the table's).  Zeros without lookups."""
    lk = data.lookup
    if lk is None:
        return dict(challenges=0, batches=0, gates=0, denominators=0)
    C, G, nb = data.circuit.config.num_challenges, len(lk.gates), lk.num_batches
    return dict(challenges=C, batches=nb, gates=G, denominators=C * (G * nb + 1))


def _lookup_polys_all(data, bk, wires, alphas):
    """LogUp committed columns on H, per challenge: helpers h_b, the table
    helper m / (alpha - t) and the running sum Z (prover.py:327).  All
    denominators share one batch inversion."""
    lk = data.lookup
    n = data.n
    dev = wires.device
    B = wires.shape[0]
    nb = lk.num_batches
    sels = bk.lookup_sels

    per_c, dens = [], []
    for alpha in alphas:
        gate_Ns = []
        for g in range(len(lk.gates)):
            D, Ng = _lookup_terms(bk, lk, g, wires, alpha, gl)
            dens.append(D)
            gate_Ns.append(Ng)
        dens.append(gl.sub(alpha[:, None], bk.lookup_table)[:, None])
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

def _chunks(N: int, shard=None):
    """The domain slices one pass evaluates: all of [0, N), or with a shard
    this rank's [lo, hi) of it (prover.py:1360-1381)."""
    lo, hi = (0, N) if shard is None else _shard_range(N, shard)
    return [slice(s, min(hi, s + DOMAIN_CHUNK)) for s in range(lo, hi, DOMAIN_CHUNK)]


def _over_domain(eval_chunk, N: int, shard):
    """eval_chunk (a tuple of tensors per domain slice) over the domain in
    DOMAIN_CHUNK slices, each output joined on the last axis; with a shard
    over this rank's slice of the domain, then gathered."""
    outs = [eval_chunk(sl) for sl in _chunks(N, shard)]
    joined = [torch.cat(parts, -1) for parts in zip(*outs)]
    if shard is not None:
        joined = [_shard_gather(j, shard, -1) for j in joined]
    return joined


def _add_gate_constraints(alg, comb, gates, w, fixed, pic, apows, perm_slots: int,
                          num_consts: int):
    """comb[c] += sum over gates g of sel_g * sum_s alpha_c^(perm_slots + s)
    cons_{g,s} over a domain slice, in the field operations of `alg` (a
    TorchAlgebra of shape [B, m]): w [B, wires, m], fixed [cols, m] (the
    constant columns, then one selector a gate), pic [B, PI cols, m], apows
    [B, slots] a challenge.  Each gate's constraints come from
    Gate.eval_stacked as one [k, B, m] tensor."""
    consts = list(fixed[:num_consts, None].unbind(0))          # [1, m] each
    for gi, gate in enumerate(gates):
        if gate.num_constraints == 0:
            continue
        ctx = {}
        if isinstance(gate, PublicInputGate):
            ctx["pi_vals"] = list(pic[:, :gate.num_cols].unbind(1))
        cons = gate.eval_stacked(alg, w[:, :gate.num_wires].movedim(1, 0), consts, ctx)
        k = cons.shape[0]
        for c in range(len(comb)):
            av = apows[c][:, perm_slots:perm_slots + k].t()[..., None]
            term = alg.dot_mod(cons, av, 0)
            comb[c] = alg.add(comb[c], alg.mul(fixed[num_consts + gi], term))


def _quotient_chunk(data, bk, fr, w, fixed, zsc, zshc, pic, l0, zh, ids):
    """Combined constraints / Z_H over one domain slice of m points -> [B,
    C, m], from the slice's wires LDE w [B, W, m], fixed LDE [F0, m], zs LDE
    zsc [B, Z, m], Z columns one row on zshc [B, len(z_idx), m], PI LDE pic
    [B, K, m], L_0 l0 [m], 1 / Z_H zh [m] and identity columns ids [nr, m]
    (_quotient_slices), and the batch's challenges in `fr`.  The field
    arithmetic is a TorchAlgebra's: one kernel an operation on a CUDA
    device."""
    circuit = data.circuit
    cfg = circuit.config
    C = cfg.num_challenges
    nr = cfg.num_routed_wires
    chunk = cfg.permutation_chunk_size
    nchunks = nr // chunk
    S = len(circuit.gates)
    B = w.shape[0]
    sel_off = cfg.num_constant_cols
    lk = data.lookup
    apows = fr.apows
    shape = (B, w.shape[-1])
    alg = TorchAlgebra(shape, w.device)
    sig = fixed[sel_off + S:sel_off + S + nr]
    comb = [torch.zeros(shape, dtype=torch.int64, device=w.device) for _ in range(C)]

    for c in range(C):
        beta = fr.betas[c][:, None, None]
        gamma = fr.gammas[c][:, None, None]
        fp = _chunk_prod(alg.add(alg.add(w[:, :nr], alg.mul(ids[None], beta)), gamma), chunk, alg)
        gp = _chunk_prod(alg.add(alg.add(w[:, :nr], alg.mul(sig[None], beta)), gamma), chunk, alg)
        z = zsc[:, c * nchunks]
        prev = zsc[:, c * nchunks: (c + 1) * nchunks]
        left = torch.cat([prev[:, 1:], zshc[:, c][:, None]], 1)
        term = alg.sub(alg.mul(left, gp), alg.mul(prev, fp))           # [B, nchunks, m]
        comb[c] = alg.add(comb[c], alg.dot_mod(term, apows[c][:, 1:1 + nchunks, None], 1))
        l0z = alg.mul(l0, alg.sub(z, 1))
        comb[c] = alg.add(comb[c], alg.mul(l0z, apows[c][:, 0:1]))

    _add_gate_constraints(alg, comb, circuit.gates, w, fixed, pic, apows, data.perm_slots,
                          cfg.num_constant_cols)

    if lk is not None:
        nb = lk.num_batches
        base_slot = data.num_constraint_slots - lk.slots
        tv = fixed[lk.table_idx]
        mv = w[:, lk.mult_col]
        for c in range(C):
            a = fr.lk_alphas[c]
            ap = apows[c]
            zoff = C * nchunks + c * lk.cols_per_challenge
            h_tab = zsc[:, zoff + nb]
            # slot 0: h_tab * (alpha - t) - m
            t0 = alg.sub(alg.mul(h_tab, alg.sub(a[:, None], tv)), mv)
            comb[c] = alg.add(comb[c], alg.mul(t0, ap[:, base_slot:base_slot + 1]))
            # slots 1..nb: sum over gates of sel * (h_b * D_b - N_b)
            hb = zsc[:, zoff:zoff + nb]
            cons = torch.zeros_like(hb)
            selsum = torch.zeros(shape, dtype=torch.int64, device=w.device)
            for g, (gi, _g) in enumerate(lk.gates):
                sel = fixed[sel_off + gi]
                D, Ng = _lookup_terms(bk, lk, g, w, a, alg)
                cons = alg.add(cons, alg.mul(alg.sub(alg.mul(hb, D), Ng), sel))
                selsum = alg.add(selsum, sel)
            weights = ap[:, base_slot + 1:base_slot + 1 + nb, None]
            comb[c] = alg.add(comb[c], alg.dot_mod(cons, weights, 1))
            # slot nb+1: Z(gx) - Z(x) - sel_sum * sum_b h_b + h_tab
            zlk = zsc[:, zoff + nb + 1]
            step = alg.add(alg.sub(alg.sub(zshc[:, C + c], zlk),
                                   alg.mul(selsum, alg.sum_mod(hb, 1))), h_tab)
            comb[c] = alg.add(comb[c], alg.mul(step, ap[:, base_slot + 1 + nb:base_slot + 2 + nb]))
            # slot nb+2: L0 * Z (the running sum starts at zero)
            comb[c] = alg.add(comb[c], alg.mul(alg.mul(l0, zlk),
                                               ap[:, base_slot + 2 + nb:base_slot + 3 + nb]))

    return torch.stack([alg.mul(q, zh) for q in comb], 1)


def _quotient_slices(bk, fr, sl) -> tuple:
    """_quotient_chunk's per-slice inputs over the domain slice sl (views)."""
    return (fr.wires_lde[..., sl], bk.fixed_lde[..., sl], fr.zs_lde[..., sl],
            fr.zsh_full[..., sl], fr.pi_lde[..., sl], bk.l0_lde[sl], bk.zh_inv[sl],
            fr.ids_full[:, sl])


def _compute_quotient(data, bk, fr, shard=None):
    """Combined constraints / Z_H over the LDE coset -> [B, C, N]; with a
    shard each rank evaluates its domain slice and the slices are gathered."""
    def eval_chunk(sl):
        trace.stamp("quotient", start=True)
        q = _quotient_chunk(data, bk, fr, *_quotient_slices(bk, fr, sl))
        trace.stamp(f"chunk.{sl.start // DOMAIN_CHUNK}")
        return (q,)

    return _over_domain(eval_chunk, data.N, shard)[0]


def _reduced_poly(data, bk, wires_lde, zs_lde, quot_lde, openings0, open_zs_gzeta, zeta, gzeta,
                  alpha, shard=None):
    """F(x) = sum_i a^i (p_i(x) - y_i) / (x - zeta)
            + a^T sum_j a^j (z_j(x) - y'_j) / (x - g zeta)   -> ext [B, N]
    (fri_cuda.reduced_poly), one call over the domain; with a shard each
    rank evaluates its domain slice, then gathered (prover.py:1474-1496)."""
    sl = slice(*((0, data.N) if shard is None else _shard_range(data.N, shard)))
    sources = (bk.fixed_lde[..., sl], wires_lde[..., sl], zs_lde[..., sl], quot_lde[..., sl])
    F = fri_cuda.reduced_poly(bk.x[sl], sources, bk.z_rows, zeta, gzeta, alpha, openings0,
                              open_zs_gzeta)
    return F if shard is None else tuple(_shard_gather(f, shard, -1) for f in F)


# ---------------------------------------------------------------------------
# prove_core (prover.py:458-657)
# ---------------------------------------------------------------------------

STOP_AFTER = ("commit", "challenges", "zs_vals", "zs", "quotient", "openings", "fri_all")


@dataclass
class _Front:
    """What the stages up to the zs commit hand to the quotient and the
    stages after it: the two commits, the transcript, the challenges, and
    the quotient's per-batch tables."""
    ch: Challenger
    wires_coeffs: torch.Tensor
    wires_lde: torch.Tensor
    wires_tree: merkle.MerkleTree
    pi_lde: torch.Tensor
    betas: list
    gammas: list
    lk_alphas: list
    num_zs: int
    zs_coeffs: torch.Tensor
    zs_lde: torch.Tensor
    zs_tree: merkle.MerkleTree
    alphas: list
    apows: list               # per challenge alpha^i [B, slots]
    ids_full: torch.Tensor    # [nr, N] identity permutation columns on the LDE coset
    zsh_full: torch.Tensor    # [B, len(z_idx), N]: the opened Z columns one row of H on


def _front(data, bk: Backend, wires, pi, pis, stop_after=None, shard=None):
    """prove_core's stages up to the zs commit and the quotient's challenges
    -> _Front, or the value of a stop_after stage among them."""
    cfg = data.circuit.config
    n, N = data.n, data.N
    C = cfg.num_challenges
    nr = cfg.num_routed_wires
    chunk = cfg.permutation_chunk_size
    nchunks = nr // chunk
    B = wires.shape[0]
    caph = cfg.fri.cap_height
    dev = wires.device

    if shard is not None:
        wires_coeffs, wires_lde, wires_tree = _lde_commit_sharded(wires, N, caph, shard)
    else:
        wires_coeffs, wires_lde, wires_tree = _lde_commit(wires, N, caph)
    trace.stamp("commit")
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
    trace.stamp("challenges")
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
    trace.stamp("zs_perm")
    if lk is not None:
        for cols in _lookup_polys_all(data, bk, wires, lk_alphas):
            zs_list += cols
    zs_vals = torch.stack(zs_list, 1)
    trace.stamp("zs_vals")
    if stop_after == "zs_vals":
        return zs_vals
    if shard is not None:
        zs_coeffs, zs_lde, zs_tree = _lde_commit_sharded(zs_vals, N, caph, shard)
    else:
        zs_coeffs, zs_lde, zs_tree = _lde_commit(zs_vals, N, caph)
    trace.stamp("zs")
    if stop_after == "zs":
        return zs_tree.cap
    ch.observe_cap(zs_tree.cap)
    alphas = [ch.get_challenge() for _ in range(C)]
    fr = _Front(
        ch=ch, wires_coeffs=wires_coeffs, wires_lde=wires_lde, wires_tree=wires_tree,
        pi_lde=pi_lde, betas=betas, gammas=gammas, lk_alphas=lk_alphas,
        num_zs=zs_vals.shape[1], zs_coeffs=zs_coeffs, zs_lde=zs_lde, zs_tree=zs_tree,
        alphas=alphas, apows=[gl.powers(a, data.num_constraint_slots) for a in alphas],
        ids_full=gl.mul(bk.x[None], bk.k_coeffs[:, None]),
        zsh_full=torch.roll(zs_lde[:, bk.z_idx], -(N // n), -1))
    trace.stamp("alphas")
    return fr


def _back(data, bk: Backend, fr: _Front, quot_vals, pis, stop_after=None, shard=None):
    """prove_core's stages from the quotient's values [B, C, N] on: its
    commit, the openings, FRI and the initial openings -> Proof, or the value
    of a stop_after stage among them."""
    cfg = data.circuit.config
    n, N = data.n, data.N
    C = cfg.num_challenges
    B = quot_vals.shape[0]
    caph = cfg.fri.cap_height
    ch = fr.ch
    rate = N // n
    trace.stamp("back", start=True)
    chunks = ntt.coset_intt(quot_vals).reshape(B, C * rate, n)
    quot_lde = ntt.coset_ntt_from_coeffs(chunks, N)
    if shard is not None:
        quot_tree = _tree_sharded(quot_lde, caph, shard)
    else:
        quot_tree = merkle.build_merkle_tree_from_polys(quot_lde, caph)
    ch.observe_cap(quot_tree.cap)
    trace.stamp("quotient")
    if stop_after == "quotient":
        return quot_tree.cap
    zeta = ch.get_ext()

    # ---- openings -----------------------------------------------------------
    layout = OpeningLayout(num_fixed=data.fixed_values.shape[0], num_wires=cfg.num_wires,
                           num_zs_partials=fr.num_zs, num_quotient=C * rate)
    zp = tuple(p[:, None] for p in ntt.ext_powers(zeta, n))       # [B, 1, n]
    gz = (gl.mul(zeta[0], data.g), gl.mul(zeta[1], data.g))
    gzp = tuple(p[:, None] for p in ntt.ext_powers(gz, n))
    z_idx = bk.z_idx
    openings0 = _ext_cat([ntt.eval_poly_ext(bk.fixed_coeffs[None], zp),
                          ntt.eval_poly_ext(fr.wires_coeffs, zp),
                          ntt.eval_poly_ext(fr.zs_coeffs, zp),
                          ntt.eval_poly_ext(chunks, zp)])
    open_zs_gzeta = ntt.eval_poly_ext(fr.zs_coeffs[:, z_idx], gzp)
    trace.stamp("openings")
    if stop_after == "openings":
        return openings0
    ch.observe_ext_array(openings0)
    ch.observe_ext_array(open_zs_gzeta)

    # ---- FRI ----------------------------------------------------------------
    F = _reduced_poly(data, bk, fr.wires_lde, fr.zs_lde, quot_lde, openings0, open_zs_gzeta,
                      zeta, gz, ch.get_ext(), shard)
    trace.stamp("reduced")
    fri_proof = fri.fri_prove(ch, F, N, cfg)
    trace.stamp("fri_all")
    if stop_after == "fri_all":
        return fri_proof

    # ---- initial tree openings ----------------------------------------------
    idx = fri_proof.indices                                        # [B, Q]
    Q = idx.shape[1]
    leaves, paths = {}, {}
    fixed_tree = merkle.MerkleTree(levels=bk.fixed_levels, cap_height=bk.fixed_cap_height)
    leaves["fixed"] = bk.fixed_lde[:, idx].permute(1, 2, 0)       # [B, Q, k]
    paths["fixed"] = fixed_tree.open(idx)
    for name, lde, tree in (("wires", fr.wires_lde, fr.wires_tree), ("zs", fr.zs_lde, fr.zs_tree),
                            ("quot", quot_lde, quot_tree)):
        k = lde.shape[1]
        leaves[name] = torch.gather(lde, 2, idx[:, None, :].expand(B, k, Q)).transpose(1, 2)
        paths[name] = tree.open(idx)
    trace.stamp("queries")

    return Proof(pis=pis, wires_cap=fr.wires_tree.cap, zs_cap=fr.zs_tree.cap,
                 quotient_cap=quot_tree.cap, openings0=openings0,
                 openings1=open_zs_gzeta, fri_proof=fri_proof,
                 initial_leaves=leaves, initial_paths=paths, layout=layout)


def prove_core(data, bk: Backend, wires, pi, pis, stop_after: str | None = None,
               shard=None):
    """(wires [B, W, n], PI polys [B, K, n], PI values [B, npis]) int64 on
    the backend's device -> Proof of int64 tensors (see to_host).
    stop_after: one of STOP_AFTER, to compare one stage with the reference.
    shard: (process group, n_shards) of the mesh's col axis: the commits'
    columns and the pointwise stages' domain are split over the group's
    ranks, every other stage runs replicated, and every rank returns the
    single-device proof.  The stages run as _front, the quotient domain
    chunk by domain chunk (_quotient_chunk), and _back: the three parts that
    a Prover on a CUDA device captures.  Each stage's end is a trace stamp
    (trace.py), a no-op unless the thread has a stamp buffer."""
    assert stop_after in (None,) + STOP_AFTER, stop_after
    fr = _front(data, bk, wires, pi, pis, stop_after, shard)
    if not isinstance(fr, _Front):
        return fr
    return _back(data, bk, fr, _compute_quotient(data, bk, fr, shard), pis, stop_after, shard)


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


# The readback of a device proof as ONE packed buffer (prover.py:806-838):
# every leaf but the PIs (the host has them), flattened in proof_leaves order
# and joined into one int64 tensor on the device, one device-to-host copy, and
# the host Proof cut back out of it with numpy.
_PROOF_PARTS = ("wires_cap", "zs_cap", "quotient_cap", "openings0", "openings1",
                "initial_leaves", "initial_paths")
_FRI_PARTS = ("caps", "final_coeffs", "indices", "layer_leaves", "layer_paths", "pow_witness")


def _proof_parts(p: Proof) -> list:
    return [getattr(p, k) for k in _PROOF_PARTS] + [getattr(p.fri_proof, k) for k in _FRI_PARTS]


def _flatten(x, out: list):
    """x with each array replaced by its position in `out`, where it is
    appended in proof_leaves order (a dict's entries by sorted key)."""
    if isinstance(x, (tuple, list)):
        return type(x)(_flatten(v, out) for v in x)
    if isinstance(x, dict):
        pos = {k: _flatten(x[k], out) for k in sorted(x)}
        return {k: pos[k] for k in x}
    if x is None:
        return None
    out.append(x)
    return len(out) - 1


def _unflatten(skeleton, arrays: list):
    if isinstance(skeleton, (tuple, list)):
        return type(skeleton)(_unflatten(v, arrays) for v in skeleton)
    if isinstance(skeleton, dict):
        return {k: _unflatten(v, arrays) for k, v in skeleton.items()}
    return None if skeleton is None else arrays[skeleton]


def _pack_spec(p: Proof):
    """(skeleton, shapes, host dtypes, layout) of a device Proof: what
    _unpack_proof needs to cut the packed buffer back into a host Proof.
    Every leaf comes back u64 but the query indices, int64."""
    leaves: list = []
    skeleton = _flatten(_proof_parts(p), leaves)
    idx = p.fri_proof.indices
    dtypes = [np.dtype(np.int64 if t is idx else np.uint64) for t in leaves]
    return skeleton, [tuple(t.shape) for t in leaves], dtypes, p.layout


def _pack_proof(p: Proof):
    """A device Proof's leaves (PIs excluded) as one flat int64 tensor."""
    leaves: list = []
    _flatten(_proof_parts(p), leaves)
    return torch.cat([t.reshape(-1) for t in leaves])


def _unpack_proof(buf: np.ndarray, spec, pis: np.ndarray) -> Proof:
    """The packed buffer (int64 numpy) -> host Proof: numpy u64 everywhere,
    the query indices int64, each leaf an array of its own."""
    skeleton, shapes, dtypes, layout = spec
    arrays, off = [], 0
    for shape, dt in zip(shapes, dtypes):
        k = math.prod(shape)
        arrays.append(buf[off:off + k].view(dt).reshape(shape).copy())
        off += k
    assert off == buf.size, (off, buf.size)
    parts = _unflatten(skeleton, arrays)
    main, fri_parts = parts[:len(_PROOF_PARTS)], parts[len(_PROOF_PARTS):]
    return Proof(pis=np.asarray(pis, dtype=np.uint64), layout=layout,
                 fri_proof=fri.FriProof(**dict(zip(_FRI_PARTS, fri_parts))),
                 **dict(zip(_PROOF_PARTS, main)))


def to_host(p: Proof, pis: np.ndarray) -> Proof:
    """A proof of device tensors -> host Proof: numpy u64 everywhere, the
    query indices int64 (one packed readback)."""
    return _unpack_proof(_pack_proof(p).cpu().numpy(), _pack_spec(p), pis)


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

    for name in _PROOF_PARTS:
        add(name, getattr(proof, name))
    for name in _FRI_PARTS:
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
    Proof, computed on the data's device.  With PLONKY2_TPU_DEBUG=1 the
    witness sanitizer first checks the uploaded wires on the device and
    raises AssertionError naming each violated class (prover.py:442)."""
    wires, pi, pis_dev = _inputs_to_device(data, W, pis)
    if os.environ.get("PLONKY2_TPU_DEBUG") == "1":
        assert_witness_ok(data.circuit, wires.permute(1, 2, 0))     # [wires, n, B] view
    proof = to_host(prove_core(data, Backend(data), wires, pi, pis_dev), pis)
    check_grind(proof)
    return proof


def _scatter_maps(data: CircuitData):
    """Static gather maps that realise the witness scatter on the device.

    The tape's value table is far smaller than the wire tensor [B, wires, n],
    so it goes up compacted, as one u64 table, and is gathered on the device.
    Only table rows the device gathers are kept (wire positions, PI
    positions, PI values), in ascending target id; targets in
    circuit.derived_tids (range-lookup limbs) are left out and derived from
    their value wires after the gather.  The last compact index is a zero
    slot for unpopulated cells."""
    circuit = data.circuit
    cfg = circuit.config
    n = data.n
    T = circuit.num_targets
    keep_mask = np.zeros(T, bool)
    keep_mask[circuit.pos_tids] = True
    keep_mask[circuit.pi_tids] = True
    keep_mask[circuit.derived_tids] = False
    keep_ids = np.nonzero(keep_mask)[0]
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
    return imap, imap_pi, pit, keep_ids, rows_arrays, layout_meta


class Prover:
    """The production prover for one circuit on one device (make_jit_prover).

    run_vals takes the tape's value table [T, B] u64 (Circuit.value_table):
    the rows the device gathers go up whole, as one u64 table [B, Kc + 1]
    (range-lookup limbs dropped, a zero slot last), the wire, PI-polynomial
    and PI tensors are gathered and the limbs re-derived on the device, and
    the proof comes back as a host Proof.

    On a CUDA device the device side, from the compact table to the packed
    proof buffer, runs as CUDA graphs: the first dispatch of a (path, batch
    size) warms up, captures and instantiates them (``_CapturedProve``;
    ``graph_stats`` keeps their set-up figures), and every batch, the first
    included, replays them and reads the proof back as one copy.  The paths
    are "vals" (dispatch_vals) and "wide" (dispatch, the full witness;
    captured at its first use).  A capture that fails raises.  The graphs of
    one Prover share one memory pool, which goes with the Prover or with
    release().  On the CPU, and with `shard` (prove_core's col axis of a
    mesh: its collectives are not captured), every dispatch runs prove_core
    eagerly."""

    def __init__(self, data: CircuitData, shard=None):
        self.data = data
        self.shard = shard
        self.device = dev = data.device
        self.backend = Backend(data)
        imap, imap_pi, pit, self._keep, rows_arrays, self._layout_meta = _scatter_maps(data)
        self._imap = torch.from_numpy(imap).to(dev)
        self._imap_pi = torch.from_numpy(imap_pi).to(dev)
        self._pit = torch.from_numpy(pit).to(dev)
        self._rows = [torch.from_numpy(r).to(dev) for r in rows_arrays]
        self._graphs: dict = {}
        self._pool = None

    @property
    def graph_stats(self) -> dict:
        """{(path, B): the set-up figures of its graphs (_CapturedProve.stats)}."""
        return {key: g.stats() for key, g in self._graphs.items()}

    def release(self):
        """Drop the captured graphs and their memory pool."""
        self._graphs.clear()
        self._pool = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def _compact(self, vals: np.ndarray) -> np.ndarray:
        """The value table [T, B] u64 -> the upload [B, Kc + 1] u64, C-contiguous:
        the kept rows (_scatter_maps), lane-major, and the zero slot that
        unpopulated cells gather."""
        table = np.empty((vals.shape[1], len(self._keep) + 1), np.uint64)
        table[:, :-1] = vals[self._keep].T
        table[:, -1] = 0
        return table

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

    def _expand(self, table):
        """The uploaded table [B, Kc + 1] int64 on the device -> (wires, PI
        polys, PI values)."""
        n = self.data.n
        B = table.shape[0]
        wires = table[:, self._imap].reshape(B, self.data.circuit.config.num_wires, n)
        wires = self._derive_range_limbs(wires)
        pi = table[:, self._imap_pi].reshape(B, self.data.circuit.pi.num_cols, n)
        return wires, pi, table[:, self._pit]

    @property
    def _graphed(self) -> bool:
        """Whether dispatches replay captured graphs (a CUDA device, no mesh)."""
        return self.device.type == "cuda" and self.shard is None

    def _replay(self, path: str, expand, host_inputs, pending):
        """Replay the graphs of (path, B), capturing them first if new."""
        key = (path, host_inputs[0].shape[0])
        captured = self._graphs.get(key)
        if captured is None:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            captured = self._graphs[key] = _CapturedProve(self, expand, host_inputs)
        return captured(host_inputs, pending)

    def _eager(self, host_inputs, expand, pending) -> Proof:
        """prove_core run now (the CPU, a mesh rank), its stamps on the host
        clock."""
        stamps = None
        if pending is not None:
            stamps = trace.StampBuffer("cpu")
            pending.stamps_from(stamps)
        with trace.stamping(stamps):
            with trace.span("prove.load"):
                trace.stamp("upload", start=True)
                inputs = [torch.from_numpy(a).to(self.device) for a in host_inputs]
                trace.stamp("upload")
            with trace.span("prove.launch"):
                wires, pi, pis_dev = _expand_stamped(expand, inputs)
                return prove_core(self.data, self.backend, wires, pi, pis_dev, shard=self.shard)

    def dispatch(self, W: np.ndarray, pis: np.ndarray):
        """Enqueue the prove of a full witness W [num_wires, n, B] u64;
        returns a handle for collect()."""
        with trace.dispatching("wide", W.shape[-1]) as pending:
            with trace.span("prove.split"):
                host = [np.ascontiguousarray(a, np.uint64).view(np.int64)
                        for a in (*host_prep(self.data, W, pis), pis)]
            if self._graphed:
                return self._replay("wide", lambda *t: t, host, pending), pis, pending
            return self._eager(host, lambda *t: t, pending), pis, pending

    def dispatch_vals(self, vals: np.ndarray, pis: np.ndarray):
        """Enqueue the prove of a value table [T, B] u64; returns a handle for
        collect().  Batch k + 1 may be dispatched before batch k is collected.
        The table goes up as one u64 tensor (_compact), so no value is cut."""
        with trace.dispatching("vals", vals.shape[1]) as pending:
            with trace.span("prove.split"):
                host = (self._compact(vals).view(np.int64),)
            if self._graphed:
                return self._replay("vals", self._expand, host, pending), pis, pending
            return self._eager(host, self._expand, pending), pis, pending

    def collect(self, handle) -> Proof:
        """The host Proof of a dispatched batch (waits for it)."""
        ticket, pis, pending = handle
        with trace.collecting(pending):
            if isinstance(ticket, Proof):
                with trace.stamping(None if pending is None else pending.buffer):
                    trace.stamp("readback", start=True)
                    buf = _pack_proof(ticket).cpu().numpy()
                    trace.stamp("readback")
                spec = _pack_spec(ticket)
            else:
                host, done, spec = ticket
                with trace.span("prove.wait"):
                    done.synchronize()
                buf = host.numpy()
            with trace.span("prove.unpack"):
                proof = _unpack_proof(buf, spec, pis)
                check_grind(proof)
        return proof

    def run_vals(self, vals: np.ndarray, pis: np.ndarray) -> Proof:
        return self.collect(self.dispatch_vals(vals, pis))


def _expand_stamped(expand, inputs):
    """The front part's first stage: the device expand of the uploaded inputs."""
    trace.stamp("front", start=True)
    out = expand(*inputs)
    trace.stamp("expand")
    return out


class _CapturedProve:
    """The device side of one (path, B) of a Prover, captured.  Three graphs,
    which share the Prover's memory pool: "front" (the upload's expand, then
    _front: the commits and the challenges up to the quotient), "chunk" (one
    domain chunk of the quotient, _quotient_chunk, on static chunk buffers)
    and "back" (_back and the pack).  A batch loads the inputs, replays
    front, then for each domain chunk copies its slices into the chunk
    buffers, replays chunk and copies its values into the quotient, then
    replays back and reads the packed proof back.  The quotient runs as one
    chunk graph replayed per chunk, not inside one whole-program graph,
    because a graph's host memory grows with its nodes: the recursion's outer
    proof as one graph is 1 084 831 nodes and grew the process by 8.3 GB,
    where these three hold 266 417 nodes and grew it by 1.0 GB (H100 80GB
    HBM3 host, PyTorch 2.11, CUDA 12.8).

    With tracing on at capture, the stamps of the front and back graphs are
    kernel nodes writing fixed slots of `stamps` (trace.StampBuffer); the
    upload, each domain chunk (copies and replay) and the readback get eager
    stamps of their own slots, and each batch copies the slots to pinned host
    memory after its readback, in stream order, so the next batch's stamps
    land after it.  The buffer's clock is calibrated once, after the
    captures."""

    def __init__(self, run: Prover, expand, host_inputs):
        data, bk, dev = run.data, run.backend, run.device
        self.lookup = lookup_counts(data)
        self.inputs = [torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype, device=dev)
                       for a in host_inputs]
        self._load(host_inputs)
        # the warm-up, on a side stream as torch.cuda.graphs prescribes: it
        # makes every table the prover caches on the device (NTT twiddles and
        # coset powers, FRI domain tables, the gates' constant columns, the
        # kernels' round constants), which a capture must only read
        here, side = torch.cuda.current_stream(dev), torch.cuda.Stream(dev)
        side.wait_stream(here)
        with trace.span("capture.warmup") as warmup:
            with torch.cuda.stream(side):
                prove_core(data, bk, *expand(*self.inputs))
            here.wait_stream(side)
            torch.cuda.synchronize(dev)
        self.warmup_s = warmup.seconds
        rss = graph.rss_bytes()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        self.stamps = st = trace.StampBuffer(dev) if trace.enabled() else None
        ins = {}

        def front():
            # only the PIs outlive the front graph (back reads them): the
            # wires and PI polynomials die with it, so that the chunk and
            # back captures reuse their blocks of the pool
            wires, pi, ins["pis"] = _expand_stamped(expand, self.inputs)
            return _front(data, bk, wires, pi, ins["pis"])

        with trace.stamping(st):
            self.front = graph.Captured(front, dev, run._pool, "front")
            fr = self.front.out
            self.domain = _chunks(data.N)
            self.slices = [_quotient_slices(bk, fr, sl) for sl in self.domain]
            self.bufs = [torch.empty(t.shape, dtype=t.dtype, device=dev) for t in self.slices[0]]
            self.chunk = graph.Captured(lambda: _quotient_chunk(data, bk, fr, *self.bufs), dev,
                                        run._pool, "chunk")
            B, C = self.chunk.out.shape[:2]
            self.quot_vals = torch.empty((B, C, data.N), dtype=torch.int64, device=dev)
            captured = len(st.names) if st is not None else 0

            def back():
                proof = _back(data, bk, fr, self.quot_vals, ins["pis"])
                packed = _pack_proof(proof)
                trace.stamp("pack")
                return packed, _pack_spec(proof)

            self.back = graph.Captured(back, dev, run._pool, "back")
        self.out, self.spec = self.back.out
        self.host_bytes = graph.rss_bytes() - rss
        self.device_bytes = torch.cuda.memory_reserved(dev) - reserved
        # the eager stamps' slots (None: no stamps)
        self.upload = self.readback = (None, None)
        self.chunk_stamps = [(None, None)] * len(self.domain)
        if st is not None:
            graphs = list(range(len(st.names)))
            self.upload = (st.add("upload", True), st.add("upload"))
            self.chunk_stamps = [(st.add("quotient", True),
                                  st.add(f"chunk.{sl.start // DOMAIN_CHUNK}"))
                                 for sl in self.domain]
            self.readback = (st.add("readback", True), st.add("readback"))
            self.order = [*self.upload, *graphs[:captured],
                          *(s for pair in self.chunk_stamps for s in pair),
                          *graphs[captured:], *self.readback]
            st.calibrate()

    def _load(self, host_inputs, mark=lambda i: None):
        """Copy the inputs (numpy) into the static buffers, staged through
        pinned memory so that the copies queue behind the stream's work;
        mark(0) and mark(1) come before and after the copies are queued."""
        pinned = []
        for buf, a in zip(self.inputs, host_inputs):
            if tuple(buf.shape) != a.shape:
                raise ValueError(f"captured for {tuple(buf.shape)}, given {a.shape}")
            pinned.append(torch.from_numpy(np.ascontiguousarray(a)).pin_memory())
        mark(0)
        for buf, p in zip(self.inputs, pinned):
            buf.copy_(p, non_blocking=True)
        mark(1)

    def __call__(self, host_inputs, pending):
        """Queue one batch on the current stream -> (pinned host buffer, event
        after its copy, spec).  The next batch's replays write the packed
        buffer only after this copy, which the same stream runs first.  With
        a pending record (tracing on) the stamps are written and copied too."""
        st = self.stamps if pending is not None else None
        write = st.write if st is not None else (lambda slot: None)
        with trace.span("prove.load"):
            self._load(host_inputs, lambda i: write(self.upload[i]))
        with trace.span("prove.launch"):
            self.front.replay()
            for sl, views, (begin, end) in zip(self.domain, self.slices, self.chunk_stamps):
                write(begin)
                for buf, v in zip(self.bufs, views):
                    buf.copy_(v)
                self.chunk.replay()
                self.quot_vals[..., sl].copy_(self.chunk.out)
                write(end)
            self.back.replay()
            host = torch.empty(self.out.shape, dtype=self.out.dtype, pin_memory=True)
            write(self.readback[0])
            host.copy_(self.out, non_blocking=True)
            write(self.readback[1])
            if st is not None:
                times = torch.empty(len(st.names), dtype=torch.int64, pin_memory=True)
                times.copy_(st.slots[:len(st.names)], non_blocking=True)
                pending.stamps_from(st, self.order, times)
            done = torch.cuda.Event()
            done.record()
        return host, done, self.spec

    def stats(self) -> dict:
        """Set-up figures: seconds of the warm-up, of the captures on the host
        and of the instantiations (their trace spans); each graph's nodes and
        the nodes a batch runs; the growth of the process's resident memory
        over the captures (a lower bound of the graphs' host memory: they
        reuse what the warm-up freed); the device memory the captures
        reserved (the pool, the chunk buffers and the quotient's values);
        kernel launches a batch; the LogUp work of a batch (lookup_counts)."""
        parts = {"front": self.front, "chunk": self.chunk, "back": self.back}
        reps = {"front": 1, "chunk": len(self.domain), "back": 1}
        launches = {k.__name__: sum(reps[p] * g.launches[k] for p, g in parts.items())
                    for k in graph.KERNELS}
        return dict(warmup_s=self.warmup_s,
                    capture_s=sum(g.capture_s for g in parts.values()),
                    instantiate_s=sum(g.instantiate_s for g in parts.values()),
                    nodes={p: g.nodes for p, g in parts.items()},
                    nodes_per_batch=sum(reps[p] * g.nodes for p, g in parts.items()),
                    domain_chunks=len(self.domain), host_bytes=self.host_bytes,
                    device_bytes=self.device_bytes, launches=launches,
                    lookup=self.lookup)


def make_prover(data: CircuitData) -> Prover:
    return Prover(data)
