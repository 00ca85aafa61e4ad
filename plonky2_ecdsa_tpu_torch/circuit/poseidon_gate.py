"""PoseidonGate: one full width-12 Poseidon2 permutation per gate row.

Counterpart of ``plonky2_ecdsa_tpu.circuit.poseidon_gate``.  The in-circuit
hash primitive of recursive proof composition: the recursive verifier
re-derives the Fiat-Shamir transcript and checks Merkle paths inside a
circuit, which needs the permutation as constraints.  plonky2's PoseidonGate
is the model: store the S-box *inputs* of every round past the first as
witness wires so each constraint stays degree 7 (x^7 S-box), and carry the
partial-round linear state SYMBOLICALLY as integer coefficient vectors over
the stored-S-box basis (the mds_partial_layer_fast idea) so the eval emits
O(rounds * width) algebra ops, not O(rounds * width^2) on deep expressions.
The permutation is the package's Poseidon2 instance (hash/poseidon.py):
external layer ME = circ(2*M4, M4, M4) (applied once more before round 0),
internal layer MI = ones + diag(mu_i - 1) with round constants only on lane
0.  ME, MI and the round-order constant table are built here as explicit
integers from hash/poseidon.py's constants.

Wire layout (130 wires; fits a 136-wire row.  The gate is degree 7 and
therefore REQUIRES a blowup-8 (rate_bits=3) config):

    [0..12)    inputs (routed)
    [12..24)   outputs (routed)
    [24..60)   u_r[i], full rounds r=1..3 (S-box inputs; round 0's are
               linear in the inputs and not stored)
    [60..82)   u_p, partial rounds p=0..21 (element 0's S-box input)
    [82..130)  u_r[i], full rounds r=26..29

Constraints (118, all degree <= 7): each stored wire equals the linear image
(MDS + round constant) of the previous round's S-box outputs, where an S-box
output is (stored wire)^7; plus 12 output-binding constraints.

The witness of a row is filled by the C++ tape op ``poseidon``
(native/witness_ops.cpp), which takes ME, MI and the constants from this
module; the numpy closure ``_host_permute_trace`` stays the semantic
reference.
"""

from __future__ import annotations

import numpy as np

from ..hash import poseidon as ps
from .gates import Gate
from .witness import P, gadd, gmul, gmul_const

W = ps.WIDTH  # 12
HF = ps.HALF_FULL_ROUNDS      # 4
PR = ps.PARTIAL_ROUNDS        # 22
TR = ps.TOTAL_ROUNDS          # 30

# The Poseidon2 paper's 4x4 block, the matrix that hash/poseidon.py's
# _ext_accum applies as an addition schedule.
M4 = ((5, 7, 1, 3),
      (4, 6, 1, 1),
      (1, 3, 5, 7),
      (1, 1, 4, 6))
# external layer circ(2*M4, M4, M4), internal layer ones + diag(mu - 1),
# round constants [30][12] in round order (internal rounds: column 0 only)
ME = [[M4[i % 4][j % 4] * (2 if i // 4 == j // 4 else 1) for j in range(W)]
      for i in range(W)]
MI = [[1 + (ps.DIAG_M1[i] if i == j else 0) for j in range(W)] for i in range(W)]
RC = [[int(ps.RC_TABLE[r, i]) for i in range(W)] for r in range(TR)]
NUM_STORED = (HF - 1) * W + PR + HF * W    # 106


class PoseidonGate(Gate):
    IN = 0
    OUT = W
    FULL_A = 2 * W              # u_r for r = 1..HF-1
    PARTIAL = FULL_A + (HF - 1) * W
    FULL_B = PARTIAL + PR       # u_r for r = HF+PR .. TR-1

    def gate_id(self):
        return "Poseidon"

    @property
    def num_wires(self):
        return self.FULL_B + HF * W  # 130

    @property
    def num_constraints(self):
        return NUM_STORED + W  # 118

    degree = 7

    # ---- wire helpers ------------------------------------------------------
    def wire_in(self, i):
        return self.IN + i

    def wire_out(self, i):
        return self.OUT + i

    def wire_full_a(self, r, i):
        assert 1 <= r < HF
        return self.FULL_A + (r - 1) * W + i

    def wire_partial(self, p):
        assert 0 <= p < PR
        return self.PARTIAL + p

    def wire_full_b(self, r, i):
        assert HF + PR <= r < TR
        return self.FULL_B + (r - HF - PR) * W + i

    # ---- constraint evaluation (every algebra) -----------------------------
    def eval(self, alg, wires, consts, ctx):
        def sbox(x):
            x2 = alg.mul(x, x)
            x4 = alg.mul(x2, x2)
            x3 = alg.mul(x2, x)
            return alg.mul(x4, x3)

        def lincomb(coeffs, terms, const):
            acc = None
            for c, t in zip(coeffs, terms):
                c %= P
                if c == 0:
                    continue
                term = t if c == 1 else alg.mul_const(t, c)
                acc = term if acc is None else alg.add(acc, term)
            if acc is None:
                acc = alg.zero()
            if const % P:
                acc = alg.add_const(acc, const % P)
            return acc

        cons = []
        # round 0: S-box inputs are linear in the input wires (the initial
        # external layer composes with round 0's constants: u = ME*in + rc0)
        ins = [wires[self.wire_in(i)] for i in range(W)]
        u = [lincomb(ME[i], ins, RC[0][i]) for i in range(W)]
        sb = [sbox(x) for x in u]
        # full rounds 1..HF-1: stored wires
        for r in range(1, HF):
            ws = [wires[self.wire_full_a(r, i)] for i in range(W)]
            for i in range(W):
                cons.append(alg.sub(ws[i], lincomb(ME[i], sb, RC[r][i])))
            sb = [sbox(x) for x in ws]
        # partial block: state tracked as integer coefficients over `basis`
        # (the S-box outputs of round HF-1, then each partial round's S-box
        # output as it occurs)
        basis = list(sb)
        C = [[ME[i][j] for j in range(W)] for i in range(W)]
        d = [0] * W
        for p in range(PR):
            r = HF + p
            wsp = wires[self.wire_partial(p)]
            # u_r[0] = state[0] + rc (stored); elements 1..11 stay symbolic
            cons.append(alg.sub(wsp, lincomb(C[0], basis, d[0] + RC[r][0])))
            basis.append(sbox(wsp))
            nb = len(basis) - 1
            # rows entering the layer: element 0 is the new basis term; the
            # others keep their coefficients and pick up the round constant
            rows_C = [[0] * nb + [1]]
            rows_d = [0]
            for i in range(1, W):
                rows_C.append(C[i] + [0] * (nb + 1 - len(C[i])))
                rows_d.append((d[i] + RC[r][i]) % P)
            C = [[sum(MI[i][j] * rows_C[j][k] for j in range(W)) % P
                  for k in range(nb + 1)] for i in range(W)]
            d = [sum(MI[i][j] * rows_d[j] for j in range(W)) % P for i in range(W)]
        # final full rounds
        for r in range(HF + PR, TR):
            ws = [wires[self.wire_full_b(r, i)] for i in range(W)]
            for i in range(W):
                if r == HF + PR:
                    expr = lincomb(C[i], basis, d[i] + RC[r][i])
                else:
                    expr = lincomb(ME[i], sb, RC[r][i])
                cons.append(alg.sub(ws[i], expr))
            sb = [sbox(x) for x in ws]
        # outputs
        for i in range(W):
            cons.append(alg.sub(wires[self.wire_out(i)], lincomb(ME[i], sb, 0)))
        assert len(cons) == self.num_constraints
        return cons


# ---------------------------------------------------------------------------
# builder gadget + witness fill
# ---------------------------------------------------------------------------

def _host_permute_trace(state):
    """state: list of 12 uint64 [B] arrays.  Returns (outputs, stored) where
    stored maps exactly onto the gate's storage wires in wire order."""
    full_a, partial, full_b = [], [], []
    cur = [_host_mat_row(ME, i, state) for i in range(W)]  # initial external layer
    for r in range(TR):
        u = [gadd(cur[i], np.uint64(RC[r][i])) for i in range(W)]
        is_full = r < HF or r >= HF + PR
        if r >= 1:
            if r < HF:
                full_a.extend(u)
            elif r < HF + PR:
                partial.append(u[0])
            else:
                full_b.extend(u)
        if is_full:
            sb = [_host_sbox(x) for x in u]
            cur = [_host_mat_row(ME, i, sb) for i in range(W)]
        else:
            sb = [_host_sbox(u[0])] + u[1:]
            cur = [_host_mat_row(MI, i, sb) for i in range(W)]
    return cur, full_a + partial + full_b


def _host_sbox(x):
    x2 = gmul(x, x)
    x4 = gmul(x2, x2)
    return gmul(gmul(x4, x2), x)


def _host_mat_row(M, i, sb):
    acc = None
    for j in range(W):
        t = gmul_const(sb[j], M[i][j])
        acc = t if acc is None else gadd(acc, t)
    return acc


def poseidon_permute(b, state):
    """state: 12 targets -> 12 output targets via one PoseidonGate row."""
    gate = PoseidonGate()
    row = b.add_row(gate)
    for i in range(W):
        b.connect(b.wire(row, gate.wire_in(i)), state[i])
    outs = [b.wire(row, gate.wire_out(i)) for i in range(W)]
    stored = ([b.wire(row, gate.wire_full_a(r, i))
               for r in range(1, HF) for i in range(W)]
              + [b.wire(row, gate.wire_partial(p)) for p in range(PR)]
              + [b.wire(row, gate.wire_full_b(r, i))
                 for r in range(HF + PR, TR) for i in range(W)])

    def fill(ev, ins=np.array(state), outs=np.array(outs),
             stored=np.array(stored)):
        vals = ev.get(ins)  # [12, B]
        out_vals, stored_vals = _host_permute_trace([vals[i] for i in range(W)])
        ev.set(stored, np.stack(stored_vals))
        ev.set(outs, np.stack(out_vals))

    b.add_op(fill, stored + outs, "poseidon",
             rec=("poseidon", dict(ins=list(state), stored=stored, outs=outs)))
    return outs
