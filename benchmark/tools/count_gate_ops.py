"""Count the Goldilocks multiplies and adds of each gate's constraints at one
point, with the reference's constraint code and an algebra that counts, and
freeze them into ``benchmark/work/gate_ops.json`` (run once, when a gate is
added; the benchmark reads the file):

    python -m benchmark.tools.count_gate_ops [<gate id> ...]

A multiply by a constant other than 0 and 1 counts as a multiply; a
subtraction, a negation or an added constant as an add; an operation whose
result is known without it (a sum with 0, a product with 0 or 1) as
nothing.  Without arguments it counts every gate of every configuration
under ``benchmark/configs``."""

from __future__ import annotations

import glob
import json
import os
import sys

from ..ref import gates
from ..ref.field import P

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "work", "gate_ops.json")


ZERO, VALUE = "0", "v"


class CountingAlgebra:
    """Elements are ZERO (known to be 0) or VALUE; every operation that a
    value needs is tallied, and none whose result is known (a sum with 0, a
    product with 0 or 1)."""

    def __init__(self):
        self.muls = self.adds = 0

    def const(self, c):
        return ZERO if c % P == 0 else VALUE

    def zero(self):
        return ZERO

    def one(self):
        return VALUE

    def add(self, a, b):
        if ZERO in (a, b):
            return b if a == ZERO else a
        self.adds += 1
        return VALUE

    def sub(self, a, b):
        if b == ZERO:
            return a
        self.adds += 1
        return VALUE

    def neg(self, a):
        if a == ZERO:
            return a
        self.adds += 1
        return VALUE

    def add_const(self, a, c):
        if c % P == 0:
            return a
        if a != ZERO:
            self.adds += 1
        return VALUE

    def mul(self, a, b):
        if ZERO in (a, b):
            return ZERO
        self.muls += 1
        return VALUE

    def mul_const(self, a, c):
        if a == ZERO or c % P == 0:
            return ZERO
        if c % P != 1:
            self.muls += 1
        return VALUE


def count(gate_id: str) -> dict:
    gate = gates.parse(gate_id)
    alg = CountingAlgebra()
    cons = gate.eval(alg, [VALUE] * gate.num_wires, [VALUE] * 64, {"pi_vals": [VALUE] * 64})
    if len(cons) != gate.num_constraints:
        raise AssertionError(f"{gate_id}: {len(cons)} constraints, {gate.num_constraints} declared")
    return {"mul": alg.muls, "add": alg.adds, "constraints": gate.num_constraints}


def main(ids: list):
    table = {}
    if os.path.exists(OUT):
        with open(OUT) as fh:
            table = json.load(fh)
    if not ids:
        for path in sorted(glob.glob(os.path.join(HERE, "configs", "*.json"))):
            with open(path) as fh:
                ids += json.load(fh).get("circuit", {}).get("gates", [])
    for gid in ids:
        table[gid] = count(gid)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as fh:
        json.dump(dict(sorted(table.items())), fh, indent=1)
        fh.write("\n")
    print(json.dumps(table, indent=1))


if __name__ == "__main__":
    main(sys.argv[1:])
