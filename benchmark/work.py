"""The work a batch needs, counted from the circuit's shapes (not from the
operations the program issues), and the least time the card could take for
it: the larger of its 32-bit integer instructions over the instruction peak
and its bytes over the memory bandwidth (``peaks.json``).

Instructions: 16 a Goldilocks multiply, 2 an add (64-bit values on 32-bit
lanes); 10 336 a Poseidon2 permutation, 10 196 a proof-of-work candidate.
"""

from __future__ import annotations

import json
import os

from .ref.circuit import Common

HERE = os.path.dirname(os.path.abspath(__file__))
INSTR_MUL, INSTR_ADD = 16, 2
INSTR_PERMUTATION, INSTR_GRIND = 10_336, 10_196
WORD = 8                                     # bytes of a field element


def _load(name: str) -> dict:
    with open(os.path.join(HERE, name)) as fh:
        return json.load(fh)


def peaks() -> dict:
    return _load("peaks.json")


def bound_s(instructions: float, nbytes: float) -> tuple:
    """(least seconds, "instructions" or "bytes": which bound it)."""
    pk = peaks()
    t_i = instructions / pk["int32_instr_per_s"]
    t_b = nbytes / pk["hbm_bytes_per_s"]
    return (t_i, "instructions") if t_i >= t_b else (t_b, "bytes")


# ---------------------------------------------------------------- quotient
def quotient_point_ops(cm: Common) -> tuple:
    """(multiplies, adds) of the constraint identity at one point of the
    quotient's domain for one lane: each gate's constraints (frozen counts,
    ``work/gate_ops.json``) and its selector filter, summed into the slots;
    then for each challenge the permutation argument (f_j = w_j + beta k_j
    x + gamma, g_j = w_j + beta sigma_j + gamma, the chunk products, the
    chunk steps, L_0 (Z - 1)), the LogUp terms, the combination with the
    powers of alpha and the division by Z_H."""
    table = _load(os.path.join("work", "gate_ops.json"))
    muls = adds = 0
    for gid, gate in zip(cm.gate_ids, cm.gates):
        if gate.num_constraints == 0:
            continue
        t = table[gid]
        muls += t["mul"] + gate.num_constraints           # the selector filter
        adds += t["add"] + gate.num_constraints           # into the slots
    adds -= cm.max_gate_constraints                       # the first term of a slot is no add
    nr, chunk = cm.num_routed, cm.chunk
    nchunks = nr // chunk
    perm_m = 2 * nr + nchunks * (2 * (chunk - 1) + 2) + 1
    perm_a = 4 * nr + nchunks + 1
    lk_m = lk_a = 0
    if cm.lookup:
        lk = cm.lookup
        nb = lk["num_batches"]
        lk_m, lk_a = 1, 2                                   # h_tab (alpha - t) - m
        for gi in lk["gates"]:
            _cols, scales = cm.gates[gi].lookup_cols_scales(nb)
            lk_m += sum(s not in (0, 1) for s in scales)    # alpha - scale w
            lk_a += sum(s != 0 for s in scales)
            lk_m += nb * (3 + 2)                            # D, N; sel (h_b D - N)
            lk_a += nb * (2 + 1 + 1)
        lk_a += len(lk["gates"]) - 1 + nb - 1               # the selector sum, the h sum
        lk_m += 1 + 1                                       # the step, L_0 Z
        lk_a += 3
    comb_m, comb_a = cm.num_slots, cm.num_slots - 1
    per_challenge_m = perm_m + lk_m + comb_m + 1            # + the Z_H division
    per_challenge_a = perm_a + lk_a + comb_a
    return muls + cm.C * per_challenge_m, adds + cm.C * per_challenge_a


def quotient_batch(cm: Common, lanes: int) -> dict:
    """The quotient of a batch over its domain of N points: instructions,
    bytes (the wires, zs, fixed and public-input columns on the domain read
    once, the tables x, L_0 and 1/Z_H, the values written once) and the
    least seconds."""
    m, a = quotient_point_ops(cm)
    points = cm.N * lanes
    instr = points * (INSTR_MUL * m + INSTR_ADD * a)
    cols_per_lane = cm.num_wires + cm.num_zs + cm.pi_cols + cm.C
    nbytes = WORD * cm.N * (lanes * cols_per_lane + cm.num_fixed + 3)
    t, by = bound_s(instr, nbytes)
    return {"instructions": instr, "bytes": nbytes, "bound_s": t, "bound_by": by}


# ---------------------------------------------------------------- Poseidon2
def _tree_permutations(leaves: int, width: int, cap_height: int) -> int:
    """A Merkle tree of `leaves` leaves of `width` elements: one permutation
    per 8 absorbed elements of a leaf, one per inner node below the cap."""
    cap = 1 << min(cap_height, leaves.bit_length() - 1)
    return leaves * -(-width // 8) + (leaves - cap)


class _CountingChallenger:
    """The transcript's duplex sponge, counting its permutations."""

    def __init__(self):
        self.pending = 0
        self.outputs = 0
        self.permutations = 0

    def observe(self, k: int = 1):
        for _ in range(k):
            self.pending += 1
            self.outputs = 0
            if self.pending == 8:
                self._duplex()

    def _duplex(self):
        self.permutations += 1
        self.pending = 0
        self.outputs = 8

    def challenge(self, k: int = 1):
        for _ in range(k):
            if self.pending or not self.outputs:
                self._duplex()
            self.outputs -= 1


def transcript_permutations(cm: Common) -> int:
    """Permutations of one lane's Fiat-Shamir transcript, in the order the
    verifier replays it (``ref/verifier.py``)."""
    ch = _CountingChallenger()
    cap = 4 << cm.cap_height
    ch.observe(cap)                              # fixed cap
    ch.observe(cm.pi_count)
    ch.observe(cap)                              # wires
    ch.challenge(2 * cm.C + (cm.C if cm.lookup else 0))
    ch.observe(cap)                              # zs
    ch.challenge(cm.C)
    ch.observe(cap)                              # quotient
    ch.challenge(2)                              # zeta
    ch.observe(2 * (cm.total + len(cm.z_idx)))
    ch.challenge(2)                              # FRI alpha
    size = cm.N
    for _ in range(cm.num_layers):
        size //= 2
        ch.observe(4 << min(cm.cap_height, size.bit_length() - 1))
        ch.challenge(2)
    ch.observe(2 * cm.nfinal)
    if ch.pending:                               # the proof-of-work response
        ch._duplex()
    ch.observe(1)
    ch.challenge(1 + cm.queries)
    return ch.permutations


def poseidon_batch(cm: Common, lanes: int, grind_candidates: int) -> dict:
    """The Poseidon2 work of a batch: the wires, zs and quotient trees, each
    FRI layer's tree (leaves of 4 elements), every lane's transcript, and the
    proof-of-work candidates these inputs needed (each lane's witness + 1,
    summed)."""
    cap_h = cm.cap_height
    per_lane = (_tree_permutations(cm.N, cm.num_wires, cap_h)
                + _tree_permutations(cm.N, cm.num_zs, cap_h)
                + _tree_permutations(cm.N, cm.num_quotient, cap_h)
                + transcript_permutations(cm))
    size = cm.N
    for _ in range(cm.num_layers):
        size //= 2
        per_lane += _tree_permutations(size, 4, cap_h)
    perms = lanes * per_lane
    instr = perms * INSTR_PERMUTATION + grind_candidates * INSTR_GRIND
    nbytes = WORD * lanes * cm.N * (cm.num_wires + cm.num_zs + cm.num_quotient)
    t, by = bound_s(instr, nbytes)
    return {"permutations": perms, "grind_candidates": grind_candidates, "instructions": instr,
            "bytes": nbytes, "bound_s": t, "bound_by": by}
