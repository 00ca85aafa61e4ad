"""Device time of the permutation's Z columns in the prover's front graph,
the stage that the stamp ``zs_perm`` ends (each challenge's chunk
products, their batch inversion and the prefix products), median over the
window's batches, in ms; from the program's tracer (``stages.py``), every
window batch, no profiler.  None on a program without that stamp."""

from benchmark import stages


def read(run):
    return stages.stage_medians(stages.window_batches(run), "front").get("zs_perm_ms")


def extra(run):
    return {"batches": len(stages.window_batches(run))} if read(run) is not None else {}
