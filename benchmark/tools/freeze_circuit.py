"""Freeze a circuit's description into a configuration file's ``circuit``
entry.  Run once, by hand, on the CPU, when a configuration is added:

    python -m benchmark.tools.freeze_circuit benchmark/configs/secp256k1_ecdsa.json

The layout (n, the gate ids in selector order, the public-input rows, the
lookup gates and the multiplicity wire, the coset shifts, the FRI
parameters) is read from the circuit as ``plonky2_ecdsa_tpu_torch`` builds
it.  The verifying key (the Merkle cap of the fixed polynomials) is copied
from ``plonky2_ecdsa_tpu_torch/vectors/anchors.json``, under the key that the
configuration names as ``anchor``: the repository's reference package froze
those caps, so the reference verifier takes no key that the measured program
made.  The tool commits the fixed data with the program too and stops unless
its cap equals the anchor's; the key binds the layout, so a layout the
reference package would not build fails there.  No run of the benchmark uses
this file.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ANCHORS = os.path.join(ROOT, "plonky2_ecdsa_tpu_torch", "vectors", "anchors.json")
CONFIGS = os.path.join(ROOT, "benchmark", "configs")


def build(spec: dict, device: str = "cpu"):
    """(circuit, data) of a configuration file, built and committed by the program."""
    from plonky2_ecdsa_tpu_torch import api
    from plonky2_ecdsa_tpu_torch.circuit import recursive_verifier as rv
    from plonky2_ecdsa_tpu_torch.circuit.builder import CircuitBuilder
    from plonky2_ecdsa_tpu_torch.circuit.config import CircuitConfig
    from plonky2_ecdsa_tpu_torch.prover.data import build_circuit_data

    curve = api.CURVES[spec["curve"]]
    if spec["driver"] == "flat_ecdsa":
        system = api.EcdsaProverSystem(curve, getattr(CircuitConfig, spec["circuit_config"])(),
                                       device=device)
        return system.circuit, system.data
    with open(os.path.join(CONFIGS, f"{spec['inner_config']}.json")) as fh:
        inner_spec = json.load(fh)
    inner = api.EcdsaProverSystem(curve, getattr(CircuitConfig, inner_spec["circuit_config"])(),
                                  device=device)
    b = CircuitBuilder(getattr(CircuitConfig, spec["circuit_config"])())
    rv.build_recursive_verifier(b, inner.data)
    circuit = b.build()
    return circuit, build_circuit_data(circuit, device)


def _rows_of_4(words) -> list:
    words = list(words)
    return [words[i:i + 4] for i in range(0, len(words), 4)]


def entry(spec: dict, device: str = "cpu") -> dict:
    """The configuration's ``circuit`` entry; raises where the program's
    verifying key differs from the anchor's."""
    circuit, data = build(spec, device)
    cfg, lk = circuit.config, data.lookup
    ours = [f"{int(v):016x}" for v in data.fixed_tree.cap.cpu().numpy().view(np.uint64).ravel()]
    with open(ANCHORS) as fh:
        anchor = json.load(fh)[spec["anchor"]]
    if ours != anchor:
        raise ValueError(f"the program's fixed cap differs from anchors.json {spec['anchor']}")
    return {
        "n": int(circuit.n),
        "config": {"num_wires": cfg.num_wires, "num_routed_wires": cfg.num_routed_wires,
                   "num_constant_cols": cfg.num_constant_cols,
                   "num_challenges": cfg.num_challenges,
                   "permutation_chunk_size": cfg.permutation_chunk_size,
                   "rate_bits": cfg.fri.rate_bits, "cap_height": cfg.fri.cap_height,
                   "num_query_rounds": cfg.fri.num_query_rounds,
                   "proof_of_work_bits": cfg.fri.proof_of_work_bits,
                   "final_poly_max_degree_bits": cfg.fri.final_poly_max_degree_bits},
        "gates": [g.gate_id() for g in circuit.gates],
        "pi": {"num_cols": int(circuit.pi.num_cols), "count": int(circuit.pi.count),
               "rows": [int(r) for r in circuit.pi.rows]},
        "k_coeffs": [int(k) for k in circuit.k_coeffs],
        "lookup_gates": [int(gi) for gi, _g in lk.gates] if lk is not None else [],
        "lookup_mult_col": int(lk.mult_col) if lk is not None else None,
        "fixed_cap": _rows_of_4(anchor),
    }


def main(path: str, out: str | None = None):
    """Writes `path` with its ``circuit`` entry frozen (to `out` if given)."""
    with open(path) as fh:
        spec = json.load(fh)
    t0 = time.time()
    spec["circuit"] = entry(spec)
    with open(out or path, "w") as fh:
        json.dump(spec, fh, indent=1)
        fh.write("\n")
    print(f"{out or path}: n={spec['circuit']['n']}, {len(spec['circuit']['gates'])} gates, "
          f"{time.time() - t0:.1f} s")


if __name__ == "__main__":
    main(*sys.argv[1:3])
