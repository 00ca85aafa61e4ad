"""Proof lanes completed over the window's seconds: all the batches the
window started, all its time (window start to the last proof on the host)."""


def read(run):
    return run.lanes * len(run.records) / run.window_s


def extra(run):
    return {"batches": len(run.records), "window_s": run.window_s}
