"""Host time of the prover's entries a batch: ``dispatch_vals`` plus
``collect``, less the wait for the device inside ``collect`` (the span
"prove.wait"), median over the window's batches, in ms; from the program's
tracer (``stages.py``).  ``extra`` gives the medians of the spans inside:
the table's split, the pinned upload, the launches, the unpacking."""

from benchmark import stages

SPANS = ("prove.split", "prove.load", "prove.launch", "prove.wait", "prove.unpack")


def _span_ms(batch, name: str) -> float:
    return sum(s.end - s.start for s in batch.spans if s.name == name) / 1e6


def _host_ms(batch) -> float:
    (d0, d1), (c0, c1) = batch.dispatch, batch.collect
    return (d1 - d0 + c1 - c0) / 1e6 - _span_ms(batch, "prove.wait")


def read(run):
    return stages.median(_host_ms(b) for b in stages.window_batches(run))


def extra(run):
    bs = stages.window_batches(run)
    if not bs:
        return {}
    return {"batches": len(bs),
            **{f"{n.split('.')[1]}_ms": stages.median(_span_ms(b, n) for b in bs) for n in SPANS}}
