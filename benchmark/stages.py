"""What the program's own tracer recorded (``plonky2_ecdsa_tpu_torch.trace``),
for the per-layer metrics that read it: every batch dispatched inside the
window, which runs from the first witness start to the last proof on the
host (the records' t0 and t3, on the tracer's clock), so never the set-up
batch nor the batches traced after the window.  Each batch record holds its
device stages on the host clock, grouped in parts ("upload", "front",
"quotient", "back", "readback"), and the host spans closed during its
dispatch and collect; the tracer also keeps every host span of every
thread.  A program without the tracer gives nothing to read, and each
reader then returns None."""

from __future__ import annotations

import statistics


def program_trace() -> tuple:
    """(batch records, host spans) of the program's tracer; ([], []) where
    the program has none."""
    try:
        from plonky2_ecdsa_tpu_torch import trace
    except ImportError:
        return [], []
    return trace.batches(), trace.spans()


def window_batches(run, batches=None) -> list:
    """The batch records with stages whose dispatch began inside the window."""
    if not run.records:
        return []
    if batches is None:
        batches = program_trace()[0]
    lo = min(r["t0"] for r in run.records) * 1e9
    hi = max(r["t3"] for r in run.records) * 1e9
    return [b for b in batches if b.stages and lo <= b.dispatch[0] <= hi]


def part(batch, name: str) -> list:
    return [s for s in batch.stages if s.part == name]


def extent_ms(batch, name: str) -> float | None:
    """First stamp to last of a part (a graph: its first node to its last)."""
    stages = part(batch, name)
    if not stages:
        return None
    return (max(s.end for s in stages) - min(s.start for s in stages)) / 1e6


def sum_ms(batch, name: str) -> float | None:
    """The part's stages' durations summed (the gaps between them left out)."""
    stages = part(batch, name)
    return sum(s.end - s.start for s in stages) / 1e6 if stages else None


def median(values) -> float | None:
    values = [v for v in values if v is not None]
    return float(statistics.median(values)) if values else None


def stage_medians(batches, name: str) -> dict:
    """{<stage>_ms: median ms over the batches} of one part's stages."""
    out = {}
    for b in batches:
        for s in part(b, name):
            out.setdefault(s.name, []).append((s.end - s.start) / 1e6)
    return {f"{k}_ms": median(v) for k, v in out.items()}


def union(intervals, lo: int, hi: int) -> tuple:
    """(covered ns, gaps [(start, end)]) of intervals clipped to [lo, hi]."""
    covered, gaps, cur = 0, [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s or e <= cur:
            continue
        if s > cur:
            gaps.append((cur, s))
        covered += e - max(s, cur)
        cur = e
    if cur < hi:
        gaps.append((cur, hi))
    return covered, gaps


def open_spans(spans, lo: int, hi: int) -> dict:
    """{label: ns} of [lo, hi]: each stretch named by the innermost program
    span open on each thread across it ("+" between threads), or "none"."""
    inside = [s for s in spans if s.start < hi and s.end > lo]
    cuts = sorted({lo, hi} | {t for s in inside for t in (s.start, s.end) if lo < t < hi})
    out: dict = {}
    for a, b in zip(cuts, cuts[1:]):
        deepest = {}
        for s in inside:
            if s.start <= a and s.end >= b and s.depth >= deepest.get(s.thread, (-1,))[0]:
                deepest[s.thread] = (s.depth, s.name)
        label = "+".join(sorted(n for _d, n in deepest.values())) or "none"
        out[label] = out.get(label, 0) + (b - a)
    return out
