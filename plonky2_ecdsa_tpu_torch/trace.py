"""The prover's own timing: host spans and device stage stamps on one clock.

Host spans (``span(name)``) time a stretch of host code on
``time.perf_counter_ns()``, the clock of ``time.perf_counter()``; each
records its thread, because the witness of a batch is often made on another
thread than the one that proves it.  While a ``torch.profiler`` is active a
span also enters ``torch.profiler.record_function(name)``, so the spans lie
on the profiler's own timeline; ``PROFILER_OFFSET_NS`` maps the tracer's
clock onto the one the profiler's events carry (Unix time).

Device stamps (``stamp(name)``) mark where a stage of ``prove_core`` ends on
the device.  A stamp goes to the thread's stamp buffer (``StampBuffer``), if
one is set (``stamping``), and is a no-op otherwise.  On a CUDA device it is
a one-thread kernel (``csrc/trace.cu``) that writes the device's nanosecond
timer into a slot of a small static buffer: inside a captured graph a kernel
node with a fixed slot, outside one an eager launch.  ``calibrate`` maps that
timer onto the host clock.  On the CPU (and on any buffer made for the CPU) a
stamp writes the host clock: the CPU proves eagerly and synchronously, so
that is its device time.

A stamp either opens a part of the batch (``start=True``: "upload", "front",
"quotient", "back", "readback") or ends a stage of the open part, which began
at the previous stamp.  The prover's stamps, in stream order:

    upload:   upload
    front:    expand, commit, challenges, zs_perm, zs_vals, zs, alphas
    quotient: chunk.<i>, once per domain chunk (each opens "quotient" anew)
    back:     quotient, openings, reduced, fri, grind, fri_all, queries[, pack]
    readback: readback

A stage named by one of ``prover.STOP_AFTER`` ends where ``prove_core``
returns for that ``stop_after``; "zs_perm" is the permutation's Z columns
(the grand products), so "zs_vals" is the LogUp columns and their stack;
"alphas" ends the front (the quotient's challenges and tables), "reduced" is
FRI's reduced polynomial, "fri" its folds up to the grind, "queries" the
initial openings and "pack" (the card only) the proof's packing for the
readback.  Between two parts lie launch
gaps and waits, which no stage covers.  On the card the upload, the chunks'
stamps (copies in, replay, copy out) and the readback are eager launches,
the rest kernel nodes of the front and back graphs.

Every batch that ``Prover.collect`` returns becomes one record (``Batch``,
which holds no tensors): its path and batch size, a sequence number, the
host intervals of its dispatch and its collect, the host spans closed while
either was open, and its stages on the host clock.  Records and spans go
into bounded rings (the last ``BATCHES`` batches, ``SPANS`` spans), read by
``batches()`` and ``spans()``.  Tracing is on by default; ``disable()`` turns
it off: spans become one shared no-op, and graphs captured afterwards have
no stamp nodes.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import math
import threading
import time
from dataclasses import dataclass

import torch

BATCHES = 1 << 12
SPANS = 1 << 16
SLOTS = 256            # stamps a buffer holds (the outer proof's batch writes 37)
CALIBRATION_READS = 8

_on = True
_spans: collections.deque = collections.deque(maxlen=SPANS)
_batches: collections.deque = collections.deque(maxlen=BATCHES)
_seq = itertools.count()
_local = threading.local()     # .open: [open spans], .batch: _Pending, .stamps: StampBuffer
_profiling = torch._C._autograd._profiler_enabled


def _profiler_offset_ns() -> int:
    """Unix time minus the tracer's clock, from the narrowest of a few
    bracketed reads."""
    best = None
    for _ in range(16):
        a = time.perf_counter_ns()
        u = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, u - (a + b) // 2)
    return best[1]


PROFILER_OFFSET_NS = _profiler_offset_ns()


@dataclass(frozen=True)
class Span:
    """A closed host span: ns on the tracer's clock; depth 0 where no span
    of the same thread was open around it, and that span's name as parent."""
    name: str
    thread: str
    start: int
    end: int
    depth: int
    parent: str | None


@dataclass(frozen=True)
class Stage:
    """A stage of a batch on the device: ns on the tracer's clock."""
    part: str
    name: str
    start: int
    end: int


@dataclass(frozen=True)
class Batch:
    """One collected batch: path ("vals" or "wide"), batch size, sequence
    number, host (start, end) ns of its dispatch and its collect, the host
    spans closed inside either, and its device stages in stream order."""
    path: str
    batch: int
    seq: int
    dispatch: tuple
    collect: tuple
    spans: tuple
    stages: tuple


def enabled() -> bool:
    return _on


def enable():
    global _on
    _on = True


def disable():
    """Turn tracing off: no spans, no stamps, no batch records."""
    global _on
    _on = False


def clear():
    """Empty both rings."""
    _spans.clear()
    _batches.clear()


def spans() -> list:
    return list(_spans)


def batches() -> list:
    return list(_batches)


def _open_list() -> list:
    stack = getattr(_local, "open", None)
    if stack is None:
        stack = _local.open = []
    return stack


class _Span:
    __slots__ = ("name", "start", "end", "_rf")

    def __init__(self, name: str):
        self.name = name
        self.end = None
        self._rf = None

    def __enter__(self):
        if _profiling():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        _open_list().append(self.name)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        stack = _open_list()
        stack.pop()
        rec = Span(self.name, threading.current_thread().name, self.start, self.end,
                   len(stack), stack[-1] if stack else None)
        _spans.append(rec)
        batch = getattr(_local, "batch", None)
        if batch is not None:
            batch.spans.append(rec)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9


class _NullSpan:
    """What span() gives while tracing is off; its seconds are not known
    (NaN: so are the figures that read them, as Prover.graph_stats's
    seconds and EcdsaProverSystem.build_seconds)."""
    seconds = math.nan

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


def span(name: str):
    """Context manager timing the host code inside it; `.seconds` after."""
    return _Span(name) if _on else _NULL


# ---------------------------------------------------------------------------
# device stamps
# ---------------------------------------------------------------------------

class StampBuffer:
    """SLOTS int64 stamp slots on `device` and the (name, start) of each slot
    given out.  `add` gives out a slot, `write` stamps it: on a CUDA device
    a launch of the stamp kernel on the current stream (captured as a node
    inside a graph capture), on the CPU the host clock.  `offset` maps the
    slots' clock onto the tracer's (0 on the CPU; ``calibrate`` on CUDA)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.slots = torch.zeros(SLOTS, dtype=torch.int64, device=self.device)
        self.names: list = []
        self.offset = 0
        self.calibration_ns = None      # the bracket of the last calibration

    def add(self, name: str, start: bool = False) -> int:
        if len(self.names) == SLOTS - 1:             # the last slot calibrates
            raise RuntimeError(f"trace: more than {SLOTS - 1} stamps in one buffer")
        self.names.append((name, start))
        return len(self.names) - 1

    def write(self, slot: int):
        if self.device.type == "cpu":
            self.slots[slot] = time.perf_counter_ns()
            return
        from . import _build

        with torch.cuda.device(self.device):
            _build.check(_build.library().trace_stamp(self.slots.data_ptr(), slot,
                                                      _build.stream_ptr(self.slots)),
                         "trace stamp")

    def stamp(self, name: str, start: bool = False):
        self.write(self.add(name, start))

    def calibrate(self) -> int:
        """Set `offset` (host ns minus device ns) from the narrowest of
        CALIBRATION_READS host-bracketed stamps (launch, synchronize);
        returns it.  The bracket's width is kept in `calibration_ns`."""
        if self.device.type == "cpu":
            return 0
        best = None
        slot = SLOTS - 1
        for _ in range(CALIBRATION_READS):
            torch.cuda.synchronize(self.device)
            a = time.perf_counter_ns()
            self.write(slot)
            torch.cuda.synchronize(self.device)
            b = time.perf_counter_ns()
            g = int(self.slots[slot])
            if best is None or b - a < best[0]:
                best = (b - a, (a + b) // 2 - g)
        self.calibration_ns, self.offset = best
        return self.offset


@contextlib.contextmanager
def stamping(buffer: StampBuffer | None):
    """stamp() inside goes to `buffer` (None: stamps are no-ops)."""
    saved = getattr(_local, "stamps", None)
    _local.stamps = buffer
    try:
        yield buffer
    finally:
        _local.stamps = saved


def stamp(name: str, start: bool = False):
    """A stamp in the thread's stamp buffer: one that opens part `name`
    (start=True), or one that ends stage `name` of the open part."""
    if _on:
        buf = getattr(_local, "stamps", None)
        if buf is not None:
            buf.stamp(name, start)


# ---------------------------------------------------------------------------
# batch records
# ---------------------------------------------------------------------------

class _Pending:
    """A batch between its dispatch and its collect."""

    def __init__(self, path: str, batch: int):
        self.path, self.batch, self.seq = path, batch, next(_seq)
        self.spans: list = []
        self.dispatch = self.collect = None
        self.buffer = self.order = self.times = None

    def stamps_from(self, buffer: StampBuffer, order=None, times=None):
        """The batch's stamps are `buffer`'s slots in `order` (default: the
        order given out), read at collect from `times` (default: the
        buffer's own slots; a host copy made in stream order for a buffer
        that the next batch writes again)."""
        self.buffer, self.order = buffer, order
        self.times = buffer.slots if times is None else times

    def stages(self) -> tuple:
        if self.buffer is None:
            return ()
        names = self.buffer.names
        order = range(len(names)) if self.order is None else self.order
        times = self.times.tolist()
        off = self.buffer.offset
        out, part, prev = [], None, None
        for slot in order:
            name, start = names[slot]
            t = times[slot] + off
            if start:
                part = name
            elif prev is not None:
                out.append(Stage(part, name, prev, t))
            prev = t
        return tuple(out)


@contextlib.contextmanager
def _within(pending: _Pending | None, field: str):
    if pending is None:
        yield None
        return
    saved = getattr(_local, "batch", None)
    _local.batch = pending
    t0 = time.perf_counter_ns()
    try:
        yield pending
    finally:
        setattr(pending, field, (t0, time.perf_counter_ns()))
        _local.batch = saved


def dispatching(path: str, batch: int):
    """Context of a batch's dispatch: yields the pending record (None while
    tracing is off), to which the spans closed inside are added."""
    return _within(_Pending(path, batch) if _on else None, "dispatch")


@contextlib.contextmanager
def collecting(pending: _Pending | None):
    """Context of a batch's collect: at its end (the stamps have landed) the
    batch's record goes into the ring."""
    with _within(pending, "collect"):
        yield pending
    if pending is not None:
        _batches.append(Batch(pending.path, pending.batch, pending.seq, pending.dispatch,
                              pending.collect, tuple(pending.spans), pending.stages()))
