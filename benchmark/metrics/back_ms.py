"""Device time of the prover's back graph (the quotient's commit, the
openings, the reduced polynomial, FRI's folds, the grind, FRI's queries,
the initial openings and the pack), its first stamp to its last, median
over the window's batches, in ms; from the program's tracer
(``stages.py``), every window batch, no profiler."""

from benchmark import stages


def read(run):
    return stages.median(stages.extent_ms(b, "back") for b in stages.window_batches(run))


def extra(run):
    bs = stages.window_batches(run)
    if not bs:
        return {}
    return {"batches": len(bs), **stages.stage_medians(bs, "back"),
            "readback_ms": stages.median(stages.sum_ms(b, "readback") for b in bs)}
