"""Seconds from the process's start to the start of the window: the
circuit build, the statement pool, the fixed commit, the first batch (the
witness tape's preparation and the graphs' warm-up, capture and
instantiation), and for the recursion the inner proofs and the outer build."""


def read(run):
    return run.setup_s
