"""torch.cuda.max_memory_reserved() over the window (reset at its start,
after the allocator's cache of free blocks is emptied), in GiB: the device
memory the process holds at its most, the graphs' private pool included.  (The pool's blocks are reserved, not allocated, so
max_memory_allocated() would leave them out: it reads 3.8 GiB in a B=32
window where the captures hold 36.6 GiB.)"""


def read(run):
    return run.peak_window_bytes / 2**30 if run.peak_window_bytes else None
