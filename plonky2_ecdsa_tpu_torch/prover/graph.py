"""CUDA graphs for the prover: capture, replay, and the launch counts.

The reference's make_jit_prover (prover.py:855-1048) traces prove_core once
per circuit and batch size (``jcore_vals``, :940-951) and then runs each
batch as one device program.  A ``Prover`` on a CUDA device does the same
(``prover._CapturedProve``): a warm-up run of the work on a side stream,
which fills every table the prover caches on the device, as
``torch.cuda.graphs`` prescribes; then ``Captured`` graphs of its parts;
then, for every batch, inputs copied into the graphs' static buffers,
replays, and one copy of the packed proof into pinned host memory.

The kernel wrappers count their launches in ``launches`` when they run
eagerly.  A capture records how many launches of each it made and restores
the counters (a capture launches nothing); every replay adds those numbers
to the wrappers' ``replayed`` counters.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from .. import trace
from ..fields import goldilocks_cuda
from ..hash import poseidon_cuda
from . import fri_cuda, ntt_cuda

KERNELS = (poseidon_cuda.permute, poseidon_cuda.sponge, poseidon_cuda.grind, ntt_cuda.sub_ntt,
           goldilocks_cuda.add, goldilocks_cuda.sub, goldilocks_cuda.mul, goldilocks_cuda.neg,
           goldilocks_cuda.sum_mod, goldilocks_cuda.dot_mod, fri_cuda.reduced_poly)


@functools.cache
def _libcuda():
    """libcuda, with the two calls that count a graph's nodes."""
    cu = ctypes.CDLL("libcuda.so.1")
    p = ctypes.c_void_p
    cu.cuGraphGetNodes.argtypes = [p, p, ctypes.POINTER(ctypes.c_size_t)]
    return cu


def _graph_of_capture(stream) -> ctypes.c_void_p:
    """The CUgraph being captured on `stream` (cuStreamGetCaptureInfo_v2)."""
    status, cid, graph = ctypes.c_int(), ctypes.c_ulonglong(), ctypes.c_void_p()
    deps, ndeps = ctypes.c_void_p(), ctypes.c_size_t()
    by = ctypes.byref
    rc = _libcuda().cuStreamGetCaptureInfo_v2(ctypes.c_void_p(stream.cuda_stream), by(status),
                                             by(cid), by(graph), by(deps), by(ndeps))
    if rc != 0 or status.value != 1:          # CU_STREAM_CAPTURE_STATUS_ACTIVE
        raise RuntimeError(f"cuStreamGetCaptureInfo: error {rc}, capture status {status.value}")
    return graph


def capture_nodes(stream) -> int:
    """Nodes of the graph being captured on `stream` so far."""
    count = ctypes.c_size_t()
    rc = _libcuda().cuGraphGetNodes(_graph_of_capture(stream), None, ctypes.byref(count))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes: error {rc}")
    return count.value


class Captured:
    """fn() captured as one CUDA graph named `name` in memory pool `pool`;
    `out` is what fn returned (its tensors are the graph's static outputs)
    and replay() runs the graph again on the current stream.  Every table fn
    reads from a cache must have been made before (a warm-up run of fn's
    work).

    capture_s is the captured run on the host (the trace span
    "capture.<name>"), instantiate_s the graph's instantiation (the span
    "capture.instantiate" after it), nodes its nodes, launches {kernel
    wrapper: launches per replay}."""

    def __init__(self, fn, device, pool, name: str):
        before = {k: k.launches for k in KERNELS}
        self.graph = torch.cuda.CUDAGraph()
        capture = torch.cuda.graph(self.graph, pool=pool, capture_error_mode="thread_local")
        try:
            with trace.span(f"capture.{name}") as captured:
                capture.__enter__()
                try:
                    self.out = fn()
                    self.nodes = capture_nodes(torch.cuda.current_stream(device))
                except BaseException as e:
                    capture.__exit__(type(e), e, e.__traceback__)
                    raise
            with trace.span("capture.instantiate") as instantiated:
                capture.__exit__(None, None, None)
                torch.cuda.synchronize(device)
        finally:
            self.launches = {k: k.launches - before[k] for k in KERNELS}
            for k in KERNELS:
                k.launches = before[k]
        self.capture_s, self.instantiate_s = captured.seconds, instantiated.seconds

    def replay(self):
        self.graph.replay()
        for k, n in self.launches.items():
            k.replayed += n


def rss_bytes() -> int:
    """The process's resident memory."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
