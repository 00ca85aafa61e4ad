"""The harness's host-clock span around each batch's witness call
(value table and public inputs), median over the window's batches, in ms."""

import numpy as np


def spans(run):
    return [1e3 * (r["t1"] - r["t0"]) for r in run.records]


def read(run):
    s = spans(run)
    return float(np.median(s)) if s else None


def extra(run):
    s = spans(run)
    return {"max": max(s), "batches": len(s)} if s else {}
