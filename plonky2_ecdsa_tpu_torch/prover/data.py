"""Per-circuit fixed data: fixed polynomials, their commitment, domain tables.

Counterpart of ``plonky2_ecdsa_tpu.prover.data`` and of the reference's
``prover.prover.Backend``.  ``build_circuit_data`` is computed once per
circuit shape and reused for every batch.  The fixed commitment (coefficients,
LDE and Merkle tree of the constants, selectors, sigmas and lookup table) is
computed by this package's own ``ntt`` and ``merkle`` on the chosen device,
where it then stays: nothing is built on the host and uploaded.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import trace
from ..circuit.builder import Circuit
from ..circuit.gates import RangeLookupGate
from ..fields import goldilocks as gl
from ..fields import goldilocks_host as glh
from ..hash import merkle
from . import fri, ntt, ntt_cuda

P = gl.P


def as_device(device) -> torch.device:
    """A torch.device with its index filled in (tables are cached by device)."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


@dataclass
class LookupInfo:
    """LogUp range-lookup metadata (None on circuits without lookups).

    Per challenge c, with alpha_c drawn after the wires commitment: the sum
    over looked-up limb terms of 1/(alpha - f) equals the sum over rows of
    m(x)/(alpha - t(x)), t the canonical-row-index fixed polynomial and m the
    multiplicity wire column.  Committed with the permutation Zs: helper
    columns h_b (batches of 3 rational terms), the table helper
    h_tab = m/(alpha - t), and the running sum Z."""
    gates: list               # [(gate_idx, RangeLookupGate)]
    mult_col: int             # wire column of multiplicities
    table_idx: int            # row of t(x) within fixed_values
    num_batches: int          # helper columns per challenge (max over gates)
    cols_per_challenge: int   # num_batches + 2 (h_tab, Z)
    slots: int                # constraint slots: 1 + num_batches + 1 + 1


@dataclass
class CircuitData:
    circuit: Circuit
    device: torch.device
    n: int
    N: int                        # LDE size = n << rate_bits
    g: int                        # subgroup generator (order n)
    fixed_values: np.ndarray      # [F0, n] u64: constants, selectors, sigmas[, table]
    fixed_coeffs: torch.Tensor    # [F0, n] on device
    fixed_lde: torch.Tensor       # [F0, N] on device
    fixed_tree: merkle.MerkleTree  # levels on device
    id_encodings: np.ndarray      # [num_routed, n] u64 (k_j * g^i)
    x_lde: np.ndarray             # [N] u64 domain points
    zh_inv: np.ndarray            # [N] u64: 1 / (x^n - 1)
    l0_lde: np.ndarray            # [N] u64: Lagrange L_0 over the coset
    num_constraint_slots: int     # perm constraints + max gate constraints [+ lookup]
    perm_slots: int
    lookup: LookupInfo | None = None


def _fixed_commit(fixed_values: np.ndarray, N: int, cap_height: int, device):
    """fixed u64 [F0, n] -> (coeffs, LDE [F0, N], tree), computed on `device`."""
    coeffs = ntt.intt(gl.from_u64(fixed_values, device))
    lde = ntt.coset_ntt_from_coeffs(coeffs, N)
    return coeffs, lde, merkle.build_merkle_tree_from_polys(lde, cap_height)


def _check_degrees(circuit: Circuit):
    """A degree-d gate's constraint has degree ~d n; the quotient is committed
    as 2^rate_bits chunks of degree < n, so d must not exceed the blow-up."""
    cfg = circuit.config
    for gi, gate in enumerate(circuit.gates):
        if len(circuit.gate_rows.get(gi, ())) > 0 and gate.degree > (1 << cfg.fri.rate_bits):
            raise ValueError(
                f"gate {gate.gate_id()} has degree {gate.degree} > blowup "
                f"2^{cfg.fri.rate_bits}: the quotient cannot represent its constraints; "
                f"use a config with rate_bits >= {max(1, (gate.degree - 1).bit_length())}")


def _lookup_info(circuit: Circuit) -> LookupInfo | None:
    cfg = circuit.config
    lk_gates = [(gi, g_) for gi, g_ in enumerate(circuit.gates)
                if isinstance(g_, RangeLookupGate) and len(circuit.gate_rows.get(gi, ())) > 0]
    if not lk_gates:
        return None
    nb = max(g_.num_batches for _gi, g_ in lk_gates)
    return LookupInfo(gates=lk_gates, mult_col=circuit.lookup_mult_col,
                      table_idx=cfg.num_constant_cols + len(circuit.gates) + cfg.num_routed_wires,
                      num_batches=nb, cols_per_challenge=nb + 2, slots=nb + 3)


def fixed_values_of(circuit: Circuit, lookup: LookupInfo | None) -> np.ndarray:
    """[F0, n] u64: constants, selectors, sigmas, and the lookup table t(x)
    (the canonical row index over [0, 2^limb_bits), then zeros)."""
    rows = [circuit.constants, circuit.selectors, circuit.sigmas]
    if lookup is not None:
        table = np.arange(circuit.n, dtype=np.uint64)
        table[1 << circuit.config.range_lookup_limb_bits:] = 0
        rows.append(table[None])
    return np.concatenate(rows, axis=0).astype(np.uint64)


def _domain_tables(circuit: Circuit, n: int, N: int, g: int):
    """(id_encodings, x_lde, zh_inv, l0_lde) as host u64."""
    ids = np.stack([glh.mul_const(glh.geometric(1, g, n), kj) for kj in circuit.k_coeffs])
    x_lde = ntt.lde_domain(N)
    # Z_H(x) = x^n - 1 over the coset: shift^n (G^n)^i - 1, of period N / n
    shift_n = pow(ntt.COSET_SHIFT, n, P)
    gn = pow(gl.root_of_unity(N), n, P)
    zh_small = [(shift_n * pow(gn, i, P) - 1) % P for i in range(N // n)]
    zh_inv = np.tile(np.array([pow(v, -1, P) for v in zh_small], dtype=np.uint64), n)
    # L_0(x) = (x^n - 1) / (n (x - 1))
    zh = np.tile(np.array(zh_small, dtype=np.uint64), n)
    denom_inv = glh.inverse(glh.mul_const(glh.sub(x_lde, np.uint64(1)), n % P))
    return ids, x_lde, zh_inv, glh.mul(zh, denom_inv)


def _slots(circuit: Circuit, lookup):
    cfg = circuit.config
    max_gate_cons = max((gate.num_constraints for gate in circuit.gates), default=0)
    # L_0 first-row constraint + one step constraint per chunk (last = Z(gx))
    perm_slots = 1 + cfg.num_routed_wires // cfg.permutation_chunk_size
    return perm_slots + max_gate_cons + (lookup.slots if lookup else 0), perm_slots


def build_circuit_data(circuit: Circuit, device="cuda") -> CircuitData:
    """The circuit's fixed data, with its commitment computed on `device`
    (the trace span "setup.fixed_commit")."""
    device = as_device(device)
    cfg = circuit.config
    n = circuit.n
    N = n << cfg.fri.rate_bits
    _check_degrees(circuit)
    g = gl.root_of_unity(n)
    lookup = _lookup_info(circuit)
    with trace.span("setup.fixed_commit"):
        fixed_values = fixed_values_of(circuit, lookup)
        coeffs, lde, tree = _fixed_commit(fixed_values, N, cfg.fri.cap_height, device)
        ids, x_lde, zh_inv, l0 = _domain_tables(circuit, n, N, g)
    slots, perm_slots = _slots(circuit, lookup)
    return CircuitData(circuit=circuit, device=device, n=n, N=N, g=g,
                       fixed_values=fixed_values, fixed_coeffs=coeffs, fixed_lde=lde,
                       fixed_tree=tree, id_encodings=ids, x_lde=x_lde, zh_inv=zh_inv,
                       l0_lde=l0, num_constraint_slots=slots, perm_slots=perm_slots,
                       lookup=lookup)


def circuit_data_from_reference(circuit: Circuit, arrays: dict, device="cuda") -> CircuitData:
    """CircuitData from the state of another build of the same circuit, given
    as plain numpy u64 arrays and Python ints: `arrays` holds n, N, g,
    num_constraint_slots, perm_slots, fixed_values, fixed_coeffs, fixed_lde,
    fixed_levels (list, leaves first), cap_height, id_encodings, x_lde,
    zh_inv and l0_lde.  `circuit` is this package's build of the circuit
    (gates and lookup layout); nothing is recomputed from it."""
    device = as_device(device)
    tree = merkle.MerkleTree(levels=[gl.from_u64(lv, device) for lv in arrays["fixed_levels"]],
                             cap_height=int(arrays["cap_height"]))
    return CircuitData(
        circuit=circuit, device=device, n=int(arrays["n"]), N=int(arrays["N"]),
        g=int(arrays["g"]), fixed_values=np.asarray(arrays["fixed_values"], np.uint64),
        fixed_coeffs=gl.from_u64(arrays["fixed_coeffs"], device),
        fixed_lde=gl.from_u64(arrays["fixed_lde"], device), fixed_tree=tree,
        id_encodings=np.asarray(arrays["id_encodings"], np.uint64),
        x_lde=np.asarray(arrays["x_lde"], np.uint64),
        zh_inv=np.asarray(arrays["zh_inv"], np.uint64),
        l0_lde=np.asarray(arrays["l0_lde"], np.uint64),
        num_constraint_slots=int(arrays["num_constraint_slots"]),
        perm_slots=int(arrays["perm_slots"]), lookup=_lookup_info(circuit))


def z_columns(data: CircuitData) -> list:
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


class Backend:
    """The prover's view of a CircuitData: everything it reads per batch as
    tensors on the data's device, made once here, so that prove_core moves
    no host data to the device (what a CUDA graph capture requires)."""

    def __init__(self, data: CircuitData):
        self.device = device = data.device
        circuit = data.circuit
        cfg = circuit.config
        nc, S, nr = cfg.num_constant_cols, len(circuit.gates), cfg.num_routed_wires
        self.fixed_lde = data.fixed_lde                                 # [F0, N]
        self.fixed_coeffs = data.fixed_coeffs                           # [F0, n]
        self.fixed_levels = data.fixed_tree.levels
        self.fixed_cap_height = data.fixed_tree.cap_height
        self.ids = gl.from_u64(data.id_encodings, device)               # [nr, n]
        self.sig = gl.from_u64(data.fixed_values[nc + S:nc + S + nr], device)
        self.x = gl.from_u64(data.x_lde, device)                        # [N]
        self.zh_inv = gl.from_u64(data.zh_inv, device)
        self.l0_lde = gl.from_u64(data.l0_lde, device)
        self.k_coeffs = gl.from_ints(circuit.k_coeffs, device)          # [nr]
        self.z_rows = tuple(z_columns(data))                            # zs columns at g*zeta
        self.z_idx = torch.tensor(self.z_rows, device=device)
        lk = data.lookup
        if lk is not None:
            # the table column t(x) on H, each lookup gate's selector on H, and
            # its looked-up wire columns and scales (in lk.gates order)
            self.lookup_table = gl.from_u64(data.fixed_values[lk.table_idx], device)    # [n]
            self.lookup_sels = [gl.from_u64(circuit.selectors[gi], device) for gi, _g in lk.gates]
            cols_scales = [g.lookup_cols_scales(lk.num_batches) for _gi, g in lk.gates]
            self.lookup_cols = [torch.tensor(c, device=device) for c, _s in cols_scales]
            self.lookup_scales = [gl.from_ints(s, device)[None, :, None] for _c, s in cols_scales]
        _warm_tables(data, device)


def _warm_tables(data, device):
    """Build the NTT and FRI tables the prover will look up, at set-up."""
    num_layers, final_size, _nf = fri.plan(data.N, data.circuit.config)
    fri.domain_tables(data.N, num_layers, device)
    for n in {data.n, data.N, final_size}:
        ntt.coset_powers(n, False, device)
        ntt.coset_powers(n, True, device)
        sizes = ntt_cuda._split2(n) if n >= ntt_cuda.FOUR_STEP_MIN else (n,)
        for inverse in (False, True):
            for n_t in sizes:
                ntt_cuda.twiddles(n_t, inverse, device)
            if n >= ntt_cuda.FOUR_STEP_MIN:
                ntt_cuda.four_step_T(n, inverse, device)
