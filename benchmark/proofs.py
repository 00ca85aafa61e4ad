"""The program's host proof as the plain arrays the reference reads."""

from __future__ import annotations

import numpy as np

TREES = ("fixed", "wires", "zs", "quot")


def _ext(e):
    return (np.asarray(e[0], np.uint64), np.asarray(e[1], np.uint64))


def arrays(proof) -> dict:
    """A host Proof of the program (numpy u64, extension values as pairs)
    -> {name: uint64 arrays with the lane axis first}."""
    fp = proof.fri_proof
    u = lambda a: np.asarray(a, np.uint64)  # noqa: E731
    return {
        "pis": u(proof.pis), "wires_cap": u(proof.wires_cap), "zs_cap": u(proof.zs_cap),
        "quotient_cap": u(proof.quotient_cap), "openings0": _ext(proof.openings0),
        "openings1": _ext(proof.openings1), "fri_caps": [u(c) for c in fp.caps],
        "final_coeffs": _ext(fp.final_coeffs), "indices": np.asarray(fp.indices, np.int64),
        "layer_leaves": [u(x) for x in fp.layer_leaves],
        "layer_paths": [u(x) for x in fp.layer_paths],
        "pow_witness": u(fp.pow_witness),
        "initial_leaves": {k: u(proof.initial_leaves[k]) for k in TREES},
        "initial_paths": {k: u(proof.initial_paths[k]) for k in TREES},
    }


def lanes(parts: list) -> dict:
    """Concatenate [(arrays, lane indices)] into one proof of those lanes."""
    def take(x, sel):
        if isinstance(x, dict):
            return {k: take(v, sel) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(take(v, sel) for v in x)
        return x[sel]

    def join(xs):
        x0 = xs[0]
        if isinstance(x0, dict):
            return {k: join([x[k] for x in xs]) for k in x0}
        if isinstance(x0, (list, tuple)):
            return type(x0)(join([x[i] for x in xs]) for i in range(len(x0)))
        return np.concatenate(xs, 0)

    return join([take(a, np.asarray(sel, np.int64)) for a, sel in parts])
