"""90th percentile over every batch of the window of the seconds from the
start of its witness to its proof on the host (numpy's linear
interpolation between order statistics)."""

import numpy as np


def latencies(run):
    return [r["t3"] - r["t0"] for r in run.records]


def read(run):
    lat = latencies(run)
    return float(np.percentile(lat, 90)) if lat else None


def extra(run):
    lat = latencies(run)
    return {"batches": len(lat), "median": float(np.median(lat)), "max": max(lat)} if lat else {}
