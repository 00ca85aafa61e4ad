"""Device time of the prover's front graph (the device expand, the wires
commit, the challenges, the Z columns and their commit, the quotient's
challenges), its first stamp to its last, median over the window's batches,
in ms; from the program's tracer (``stages.py``), every window batch, no
profiler."""

from benchmark import stages


def read(run):
    return stages.median(stages.extent_ms(b, "front") for b in stages.window_batches(run))


def extra(run):
    bs = stages.window_batches(run)
    if not bs:
        return {}
    return {"batches": len(bs), "upload_ms": stages.median(stages.sum_ms(b, "upload") for b in bs),
            **stages.stage_medians(bs, "front")}
