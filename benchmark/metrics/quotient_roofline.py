"""The least time of the quotient's work (``work.quotient_batch``: the
constraint identity at every point of the quotient's domain for every lane,
from the circuit's shapes) over the device time of the kernels that the
chunk graph's launches ran (union of their intervals per launch), over the
batches traced after the window, in %."""

from benchmark import work
from benchmark.run import TRACE_BATCHES
from benchmark.trace import union_s


def read(run):
    k = run.graph_stats.get("domain_chunks")
    if run.trace is None or not k:
        return None
    batches = run.trace.batches(k + 2, TRACE_BATCHES)
    if not batches:
        return None
    t = sum(union_s(kernels) for launches in batches for kernels in launches[1:-1])
    return 100.0 * len(batches) * work.quotient_batch(run.common, run.lanes)["bound_s"] / t


def extra(run):
    q = work.quotient_batch(run.common, run.lanes)
    return {"bound_by": q["bound_by"], "bound_s_per_batch": q["bound_s"]}
