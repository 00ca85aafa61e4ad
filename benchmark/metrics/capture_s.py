"""Seconds of the first batch's eager warm-up, the graphs' capture on the
host and their instantiation, from Prover.graph_stats."""


def read(run):
    g = run.graph_stats
    if not g:
        return None
    return g["warmup_s"] + g["capture_s"] + g["instantiate_s"]


def extra(run):
    g = run.graph_stats
    return {k: g[k] for k in ("warmup_s", "capture_s", "instantiate_s")} if g else {}
