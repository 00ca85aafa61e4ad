"""Share of the window in which the device ran none of the prover's stages,
in %: 1 - the union of every window batch's stage intervals (upload, the
front graph's stages, each quotient chunk, the back graph's stages,
readback) over the time from the first window batch's first stamp to the
last one's readback end.  From the program's tracer (``stages.py``), every
window batch, no profiler: what is idle here is launch gaps and the host's
waits, never a profiler's cost.  ``extra`` splits the idle seconds by the
program span open on the host across each gap (the innermost of each
thread), or "none"."""

from benchmark import stages


def _window(run):
    batches, spans = stages.program_trace()
    bs = stages.window_batches(run, batches)
    if not bs:
        return None
    first = min(bs, key=lambda b: b.seq)
    last = max(bs, key=lambda b: b.seq)
    lo = min(s.start for s in first.stages)
    hi = max(s.end for s in last.stages)
    covered, gaps = stages.union([(s.start, s.end) for b in bs for s in b.stages], lo, hi)
    return bs, spans, lo, hi, covered, gaps


def read(run):
    w = _window(run)
    if w is None or w[3] <= w[2]:
        return None
    _bs, _spans, lo, hi, covered, _gaps = w
    return 100.0 * (1.0 - covered / (hi - lo))


def extra(run):
    w = _window(run)
    if w is None:
        return {}
    bs, spans, lo, hi, covered, gaps = w
    idle: dict = {}
    for a, b in gaps:
        for label, ns in stages.open_spans(spans, a, b).items():
            idle[label] = idle.get(label, 0) + ns
    out = {"batches": len(bs), "window_s": (hi - lo) / 1e9, "idle_s": (hi - lo - covered) / 1e9}
    out.update({f"idle_s.{k}": v / 1e9 for k, v in sorted(idle.items(), key=lambda kv: -kv[1])})
    return out
