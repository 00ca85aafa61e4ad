"""Device time of the quotient a batch: every domain chunk's copies in,
chunk graph and copy out, summed, median over the window's batches, in ms;
from the program's tracer (``stages.py``), every window batch, no
profiler."""

from benchmark import stages


def read(run):
    return stages.median(stages.sum_ms(b, "quotient") for b in stages.window_batches(run))


def extra(run):
    bs = stages.window_batches(run)
    if not bs:
        return {}
    chunks = [(s.end - s.start) / 1e6 for b in bs for s in stages.part(b, "quotient")]
    return {"batches": len(bs), "chunks": len(stages.part(bs[0], "quotient")),
            "chunk_ms": stages.median(chunks), "chunk_max_ms": max(chunks)}
