"""Device time of the LogUp part of the prover's Z stage: the front stage
``zs_vals`` of a program that stamps ``zs_perm`` before it, so that it holds
the lookup denominators, their one batch inversion, the helper columns and
the running sums, and the stack of every Z column (a circuit without
lookups: the stack alone).  Median over the window's batches, in ms; from
the program's tracer (``stages.py``), every window batch, no profiler.
None on a program without the ``zs_perm`` stamp, whose ``zs_vals`` stage
also holds the permutation's columns.

``extra``: the LogUp work of a batch (``Prover.graph_stats``' ``lookup``:
challenges, helper batches a challenge, lookup gates, denominator columns
inverted a lane) and the stage's ms per denominator column."""

from benchmark import stages


def _split(run) -> list:
    """The window's batches whose front stamps zs_perm."""
    return [b for b in stages.window_batches(run)
            if any(s.name == "zs_perm" for s in stages.part(b, "front"))]


def read(run):
    return stages.stage_medians(_split(run), "front").get("zs_vals_ms")


def extra(run):
    value = read(run)
    if value is None:
        return {}
    lookup = run.graph_stats.get("lookup") or {}
    out = {"batches": len(_split(run)), **{f"lookup.{k}": v for k, v in lookup.items()}}
    if lookup.get("denominators"):
        out["ms_per_denominator"] = value / lookup["denominators"]
    return out
