"""How ``correct`` is decided: the proofs the window read back, judged by the
plain reference (``ref/``) once the window has closed.

Numbers compared, each against its limit (an exact comparison: limit 0):

    lanes_rejected       lanes of the sample that the reference verifier
                         rejects (transcript, constraint identity at zeta,
                         Merkle openings, FRI folds and final polynomial,
                         proof of work, query indices)
    pis_unbound          lanes of the whole window whose public inputs are not
                         their statement's (every lane, not a sample)
    statements_invalid   statements of the pool that are not valid signatures
    inner_lanes_rejected (recursion) lanes of the inner proofs that the
                         reference rejects, or whose public inputs are not
                         their statement's

The sample: at least one lane of every batch of the window, and as many more
as keep the sample near SAMPLE_LANES, drawn from the seed.
"""

from __future__ import annotations

import numpy as np

from . import ecdsa, proofs
from .ref import verifier
from .ref.circuit import Common

SAMPLE_LANES = 64


def _sample(done: list, lanes: int, g) -> list:
    per = min(lanes, max(1, SAMPLE_LANES // max(1, len(done))))
    return [(proofs.arrays(p), np.sort(g.choice(lanes, per, replace=False))) for _k, p in done]


def reject_count(common: Common, parts: list) -> tuple:
    """(lanes rejected, lanes checked, {check: lanes failing it})."""
    if not parts:
        return 0, 0, {}
    merged = proofs.lanes(parts)
    try:
        verdict = verifier.verify(common, merged)
    except (ValueError, IndexError) as e:    # a proof of the wrong shape: every lane fails
        lanes = merged["pis"].shape[0]
        return lanes, lanes, {f"malformed: {e}": lanes}
    ok = verifier.accepted(verdict)
    return int((~ok).sum()), int(ok.size), {k: int((~v).sum()) for k, v in verdict.items() if not v.all()}


def unbound(pool: list, done: list) -> int:
    """Lanes whose public inputs are not their statement's."""
    bad = 0
    for k, proof in done:
        want = np.array([ecdsa.public_inputs(st) for st in pool[k]], np.uint64)
        got = np.asarray(proof.pis, np.uint64)
        bad += want.shape[0] if got.shape != want.shape else int((got != want).any(1).sum())
    return bad


def invalid_statements(curve: str, pool: list) -> int:
    c = ecdsa.CURVES[curve]
    return sum(not ecdsa.verify(c, st) for batch in pool for st in batch)


def verdict(numbers: list) -> bool:
    return all(value <= limit for _name, value, limit in numbers)


def flat(entry: dict, curve: str, pool: list, done: list, g) -> tuple:
    """(correct, [(name, value, limit)], details) of a flat cell's window."""
    lanes = len(pool[0])
    rejected, checked, why = reject_count(Common(entry), _sample(done, lanes, g))
    numbers = [("lanes_rejected", rejected, 0), ("pis_unbound", unbound(pool, done), 0),
               ("statements_invalid", invalid_statements(curve, pool), 0)]
    return verdict(numbers) and checked > 0, numbers, {"lanes_checked": checked, "failed_checks": why}
