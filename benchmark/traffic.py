"""The one generator of every traffic mix: a mix is a file
``traffic/<name>.json`` of parameters, read here.

    batch          statements (proof lanes) a batch
    in_flight      batches between the start of their witness and their
                   proof's arrival on the host (1: each batch waits for the
                   last; 2: the next witness overlaps the proving)
    pool_batches   distinct statement batches made from the seed (at least 2)

The loop is closed: a batch starts when one of the in_flight places frees.
Every seed gives the same sizes; the seed draws the keys, messages and
nonces of the pool and the order in which the window cycles through it.
"""

from __future__ import annotations

import json
import os

import numpy as np

from . import ecdsa

HERE = os.path.dirname(os.path.abspath(__file__))


def load(name: str, root: str = HERE) -> dict:
    with open(os.path.join(root, "traffic", f"{name}.json")) as fh:
        mix = json.load(fh)
    if int(mix["batch"]) < 1 or int(mix["in_flight"]) not in (1, 2) or int(mix["pool_batches"]) < 2:
        raise ValueError(f"traffic {name}: batch >= 1, in_flight 1 or 2, pool_batches >= 2")
    return mix


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent generator per use of the seed (any integer)."""
    return np.random.default_rng([seed & (2**64 - 1), stream])


def statement_pool(curve: str, mix: dict, seed: int) -> list:
    """pool_batches lists of `batch` signed statements, from the seed."""
    c = ecdsa.CURVES[curve]
    g = rng(seed, 0)

    def scalar():
        return int.from_bytes(g.bytes(40), "little") % c.n

    return [[ecdsa.sign(c, scalar(), scalar(), scalar()) for _ in range(int(mix["batch"]))]
            for _ in range(int(mix["pool_batches"]))]


def order(seed: int, pool_size: int, count: int) -> list:
    """The pool batch of each window batch: every pool batch once per round,
    rounds shuffled from the seed."""
    g = rng(seed, 1)
    out = []
    while len(out) < count:
        out += [int(i) for i in g.permutation(pool_size)]
    return out[:count]
