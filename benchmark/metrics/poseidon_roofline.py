"""The least time of the traced batches' Poseidon2 work
(``work.poseidon_batch``: the wires, zs, quotient and FRI trees, the
transcript, the proof-of-work candidates up to each lane's first hit) over
the device time of the kernels named under ``kernels/poseidon/`` among the
kernels of those batches' graph launches, in %."""

import os

import numpy as np

from benchmark import work
from benchmark.run import TRACE_BATCHES
from benchmark.trace import matching

KERNELS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "kernels", "poseidon")


def names():
    return sorted(f[:-4] for f in os.listdir(KERNELS) if f.endswith(".txt"))


def _grind(record):
    return int((np.asarray(record["proof"].fri_proof.pow_witness, np.uint64) + 1).sum())


def read(run):
    k = run.graph_stats.get("domain_chunks")
    if run.trace is None or not k:
        return None
    batches = run.trace.batches(k + 2, TRACE_BATCHES)
    kernels = [kn for launches in batches for ks in launches for kn in matching(ks, names())]
    if not kernels:
        return None
    t = sum(e - s for _n, s, e in kernels) / 1e9
    bound = sum(work.poseidon_batch(run.common, run.lanes, _grind(rec))["bound_s"]
                for rec in run.traced[:len(batches)])
    return 100.0 * bound / t
