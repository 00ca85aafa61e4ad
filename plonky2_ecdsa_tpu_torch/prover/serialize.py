"""Persistence of circuit data and proofs: the build-once / prove-many
checkpoint.

Counterpart of ``plonky2_ecdsa_tpu.prover.serialize``.  The proving half of
a CircuitData (fixed polynomials with their LDE and Merkle tree, domain
tables, gate inventory, PI layout, wire-position maps) goes to one ``.npz``
file.  Field elements are one u64 word each; what lives on the device
(``fixed_coeffs``, ``fixed_lde``, the tree's levels) is written as numpy
uint64 and comes back on the device asked for.  The witness tape is Python
closures, deterministic in (curve, config): it is reattached by rebuilding
the template (``attach_template``), which only generating NEW witnesses
needs, not proving a given value table nor verifying.

A proof goes to an ``.npz`` of its leaves under the names of
``prover.proof_leaves`` and holds no pickled object.

The files are this package's own and are not interchangeable with the
reference package's: the circuit metadata pickles this package's classes
(config, gates, PI layout).  Unpickling runs code, so load only circuit data
that this program wrote.
"""

from __future__ import annotations

import pickle

import numpy as np

from ..circuit.builder import Circuit
from ..fields import goldilocks as gl
from ..hash import merkle
from . import fri
from .data import CircuitData, _lookup_info, as_device
from .prover import OpeningLayout, Proof, proof_leaves

_CIRCUIT_ARRAYS = ("selectors", "constants", "sigmas", "row_gate_idx", "pos_rows", "pos_cols",
                   "pos_tids", "pi_tids", "derived_tids")
_HOST_TABLES = ("fixed_values", "id_encodings", "x_lde", "zh_inv", "l0_lde")


def save_circuit_data(data: CircuitData, path: str):
    """Persist the proving half of `data` to one .npz file."""
    c = data.circuit
    meta = pickle.dumps({
        "config": c.config, "n": c.n, "gates": c.gates, "pi": c.pi, "k_coeffs": c.k_coeffs,
        "num_targets": c.num_targets, "range_layouts": c.range_layouts,
        "lookup_mult_col": c.lookup_mult_col,
        "gate_rows": {k: np.asarray(v) for k, v in c.gate_rows.items()},
        "num_constraint_slots": data.num_constraint_slots, "perm_slots": data.perm_slots,
        "g": data.g, "N": data.N, "fixed_cap_height": data.fixed_tree.cap_height,
    })
    arrays = {"meta": np.frombuffer(meta, dtype=np.uint8),
              "fixed_coeffs": gl.to_u64(data.fixed_coeffs),
              "fixed_lde": gl.to_u64(data.fixed_lde)}
    arrays.update({name: getattr(data, name) for name in _HOST_TABLES})
    arrays.update({name: getattr(c, name) for name in _CIRCUIT_ARRAYS})
    for i, level in enumerate(data.fixed_tree.levels):
        arrays[f"ftree_{i}"] = gl.to_u64(level)
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def load_circuit_data(path: str, device="cuda") -> CircuitData:
    """A proving-ready CircuitData with its fixed commitment on `device`.

    It proves value tables and verifies proofs; its ``circuit.tape`` is empty:
    call ``attach_template`` (or build an ``api.EcdsaProverSystem``) before
    generating new witnesses."""
    device = as_device(device)
    with np.load(path, allow_pickle=False) as z:
        meta = pickle.loads(z["meta"].tobytes())
        levels = []
        while f"ftree_{len(levels)}" in z:
            levels.append(gl.from_u64(z[f"ftree_{len(levels)}"], device))
        circuit = Circuit(
            config=meta["config"], n=meta["n"], gates=meta["gates"],
            tape=[], read_map=np.zeros(0, np.int64), num_targets=meta["num_targets"],
            inputs={}, pi=meta["pi"], constant_values={}, k_coeffs=meta["k_coeffs"],
            gate_rows={int(k): np.asarray(v) for k, v in meta["gate_rows"].items()},
            range_layouts=meta["range_layouts"], lookup_mult_col=meta["lookup_mult_col"],
            **{name: z[name] for name in _CIRCUIT_ARRAYS})
        return CircuitData(
            circuit=circuit, device=device, n=meta["n"], N=meta["N"], g=meta["g"],
            fixed_coeffs=gl.from_u64(z["fixed_coeffs"], device),
            fixed_lde=gl.from_u64(z["fixed_lde"], device),
            fixed_tree=merkle.MerkleTree(levels=levels, cap_height=meta["fixed_cap_height"]),
            num_constraint_slots=meta["num_constraint_slots"], perm_slots=meta["perm_slots"],
            lookup=_lookup_info(circuit), **{name: z[name] for name in _HOST_TABLES})


def attach_template(data: CircuitData, built: Circuit) -> CircuitData:
    """Reattach a freshly rebuilt template's witness machinery to loaded data
    (the same curve and config, so the shapes match)."""
    c = data.circuit
    if not (built.n == c.n and len(built.gates) == len(c.gates)
            and np.array_equal(built.selectors, c.selectors)):
        raise ValueError("template mismatch: not the circuit this data was built from")
    for name in ("tape", "pos_rows", "pos_cols", "pos_tids", "read_map", "inputs", "pi_tids",
                 "constant_values", "num_targets"):
        setattr(c, name, getattr(built, name))
    return data


def save_proof(proof: Proof, path: str):
    """Persist a host Proof: its leaves by name, and the opening layout."""
    lay = proof.layout
    arrays = dict(proof_leaves(proof))
    arrays["layout"] = np.array([lay.num_fixed, lay.num_wires, lay.num_zs_partials,
                                 lay.num_quotient], np.int64)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_proof(path: str) -> Proof:
    """The host Proof that save_proof wrote."""
    with np.load(path, allow_pickle=False) as z:
        def pair(name):
            return (z[f"{name}[0]"], z[f"{name}[1]"])

        def seq(name):
            out = []
            while f"{name}[{len(out)}]" in z:
                out.append(z[f"{name}[{len(out)}]"])
            return out

        def named(name):
            prefix = name + "."
            return {k[len(prefix):]: z[k] for k in z.files if k.startswith(prefix)}

        pow_witness = z["fri.pow_witness"] if "fri.pow_witness" in z else None
        return Proof(
            pis=z["pis"], wires_cap=z["wires_cap"], zs_cap=z["zs_cap"],
            quotient_cap=z["quotient_cap"], openings0=pair("openings0"),
            openings1=pair("openings1"),
            fri_proof=fri.FriProof(
                caps=seq("fri.caps"), final_coeffs=pair("fri.final_coeffs"),
                indices=z["fri.indices"], layer_leaves=seq("fri.layer_leaves"),
                layer_paths=seq("fri.layer_paths"), pow_witness=pow_witness),
            initial_leaves=named("initial_leaves"), initial_paths=named("initial_paths"),
            layout=OpeningLayout(*(int(v) for v in z["layout"])))
