"""Nodes of the prover's CUDA graphs that a batch runs (front, the chunk
graph once per quotient domain chunk, back), from Prover.graph_stats: a
count."""


def read(run):
    return run.graph_stats.get("nodes_per_batch")
