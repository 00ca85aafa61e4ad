"""A circuit's description as the verifier needs it, read from a
configuration's frozen ``circuit`` entry, and the layout derived from it.

The entry holds what defines the circuit: its size n, the configuration's
widths and FRI parameters, the gate list in selector order (by gate id), the
rows of the public inputs, the lookup gates and the multiplicity wire, and
the verifying key (the Merkle cap of the fixed polynomials, hex words).
"""

from __future__ import annotations

import numpy as np

from . import field as f
from . import gates as gt


class Common:
    def __init__(self, entry: dict):
        cfg = entry["config"]
        self.n = int(entry["n"])
        self.rate_bits = int(cfg["rate_bits"])
        self.N = self.n << self.rate_bits
        self.g = f.root_of_unity(self.n)
        self.num_wires = int(cfg["num_wires"])
        self.num_routed = int(cfg["num_routed_wires"])
        self.num_consts = int(cfg["num_constant_cols"])
        self.C = int(cfg["num_challenges"])
        self.chunk = int(cfg["permutation_chunk_size"])
        self.cap_height = int(cfg["cap_height"])
        self.queries = int(cfg["num_query_rounds"])
        self.pow_bits = int(cfg["proof_of_work_bits"])
        self.gate_ids = list(entry["gates"])
        self.gates = [gt.parse(g) for g in self.gate_ids]
        self.pi_cols = int(entry["pi"]["num_cols"])
        self.pi_count = int(entry["pi"]["count"])
        self.pi_rows = [int(r) for r in entry["pi"]["rows"]]
        self.k_coeffs = [int(k) for k in entry["k_coeffs"]]
        self.fixed_cap = np.array([[int(w, 16) for w in d] for d in entry["fixed_cap"]], np.uint64)

        S = len(self.gates)
        nchunks = self.num_routed // self.chunk
        lk_gates = list(entry.get("lookup_gates") or [])
        self.lookup = None
        if lk_gates:
            nb = max(self.gates[gi].num_batches for gi in lk_gates)
            self.lookup = {"gates": lk_gates, "mult_col": int(entry["lookup_mult_col"]),
                           "table_idx": self.num_consts + S + self.num_routed,
                           "num_batches": nb}
        self.num_fixed = self.num_consts + S + self.num_routed + (1 if self.lookup else 0)
        self.num_zs = self.C * nchunks + (self.C * (self.lookup["num_batches"] + 2)
                                          if self.lookup else 0)
        self.num_quotient = self.C << self.rate_bits
        self.total = self.num_fixed + self.num_wires + self.num_zs + self.num_quotient
        self.offsets = (0, self.num_fixed, self.num_fixed + self.num_wires,
                        self.num_fixed + self.num_wires + self.num_zs)
        self.z_idx = [c * nchunks for c in range(self.C)]
        if self.lookup:
            cpc = self.lookup["num_batches"] + 2
            self.z_idx += [self.C * nchunks + c * cpc + cpc - 1 for c in range(self.C)]
        self.max_gate_constraints = max(g.num_constraints for g in self.gates)
        self.perm_slots = 1 + nchunks
        self.num_slots = (self.perm_slots + self.max_gate_constraints
                          + (self.lookup["num_batches"] + 3 if self.lookup else 0))
        final_size = min(self.N, 1 << (int(cfg["final_poly_max_degree_bits"]) + self.rate_bits))
        self.num_layers = max(0, (self.N // final_size).bit_length() - 1)
        self.nfinal = final_size >> self.rate_bits
