"""The control of ``correct``: the program run with one of the guarantees
its configuration states broken through the program's own configuration
path, judged by the same reference, which must find it wrong.

The guarantee broken is the proof of work: the program's CircuitConfig for
the cell is replaced by the same with ``proof_of_work_bits`` 8 instead of 16
(a grind 256 times cheaper, the change that would tempt a later PR).  The
reference holds the configuration as stated and rejects every lane whose
response lacks 16 leading zero bits.  On the chip, at the cell's own size:

    python -m benchmark.selftest.control --workload secp256k1_ecdsa.b32 --seconds 10 \\
        --seeds 11 12 13

prints one line a seed with each compared number (``lanes_rejected`` and the
rest).  ``test_bench_control.py`` runs it on the CPU at one lane.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from benchmark import run

CONTROL_POW_BITS = 8


def lowered(config_name: str, pow_bits: int = CONTROL_POW_BITS):
    """Patch the program's CircuitConfig.<config_name> to state fewer proof
    of work bits; returns a function that undoes it."""
    from plonky2_ecdsa_tpu_torch.circuit.config import CircuitConfig

    original = getattr(CircuitConfig, config_name)

    def make():
        c = original()
        return dataclasses.replace(c, fri=dataclasses.replace(c.fri, proof_of_work_bits=pow_bits))

    setattr(CircuitConfig, config_name, staticmethod(make))
    return lambda: setattr(CircuitConfig, config_name, staticmethod(original))


def control_reading(workload: str, seed: int, seconds: float, device=None, root=run.HERE) -> dict:
    """One run of the cell with the control's configuration -> its result."""
    with open(os.path.join(os.getcwd(), "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cell = run.Cell(bench, workload, seed, root)
    undo = lowered(cell.config["circuit_config"])
    try:
        return run.execute(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                            "--trace", "0"], device=device, root=root)
    finally:
        undo()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the control of correct, a line a seed")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        res = control_reading(args.workload, seed, args.seconds)
        if isinstance(res, int):
            return res
        print(json.dumps({"workload": args.workload, "seed": seed, "control": f"pow_bits {CONTROL_POW_BITS}",
                          "correct": res["correct"], "checks": res["checks"],
                          "details": res["run"]["details"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
