"""Share of the device's time line in which it ran nothing, over the traced
batches' whole cycles: from the first kernel of the first traced batch to
the first kernel of the last, 1 - the union of every device operation's
interval there over its length, in % (torch.profiler's trace, read by
``trace.py``).  A cycle is one batch's device work and whatever kept the
device from the next batch's: launch gaps inside the batch and, between
batches, the readback, a witness that is not hidden, a late dispatch.  The
first traced batch's witness, which nothing can overlap, lies outside.

Under the profiler each launch of a CUDA graph costs the host more than it
does untraced (about a quarter of a second for the outer proof's chunk
graph on an H100 with PyTorch 2.11), so where the host's launches cannot
keep ahead of the device, part of this share is the profiler's."""

from benchmark.run import TRACE_BATCHES


def starts(run) -> list:
    """Trace clock (ns) of each traced batch's first kernel."""
    k = run.graph_stats.get("domain_chunks")
    if run.trace is None or not k:
        return []
    return [min(s for launch in b for _n, s, _e in launch)
            for b in run.trace.batches(k + 2, TRACE_BATCHES)]


def read(run):
    t = starts(run)
    if len(t) < 2:
        return None
    return 100.0 * (1.0 - run.trace.busy_s(t[0], t[-1]) / ((t[-1] - t[0]) / 1e9))


def extra(run):
    return {"cycles": max(len(starts(run)) - 1, 0)}
