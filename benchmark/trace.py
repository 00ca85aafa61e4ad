"""The traced run's reading of the device: ``torch.profiler`` (CUPTI) over
the batches traced after the window, parsed in memory.

From the trace: the device's busy time (the union of every kernel, copy and
set interval) over the traced span; the kernels that took the most time; the
longest idle gaps, named by the harness's host spans that were open across
them; and each CUDA graph launch's kernels, linked by correlation id, with
the launches of a batch in the prover's order (front, one per quotient domain
chunk, back)."""

from __future__ import annotations

import re

SPAN = "bench.traced"                # the host span around the traced batches
HOST_SPANS = ("bench.wait", "bench.dispatch", "bench.collect")   # run.Window's


def _union(intervals, lo, hi) -> tuple:
    """(covered ns, gaps [(start, end)]) of intervals clipped to [lo, hi]."""
    covered, gaps, cur = 0, [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s or e <= cur:
            continue
        if s > cur:
            gaps.append((cur, s))
        covered += e - max(s, cur)
        cur = e
    if cur < hi:
        gaps.append((cur, hi))
    return covered, gaps


class Trace:
    def __init__(self, prof):
        from torch.autograd import DeviceType

        self.kernels, self.launches, self.spans = [], [], []
        self.window = None
        cuda = DeviceType.CUDA
        events = prof.profiler.kineto_results.events()
        annotated = bool(events) and hasattr(events[0], "is_user_annotation")
        for e in events:
            name = e.name()
            if e.device_type() == cuda:
                # the host spans' copies on the device's timeline are no device work
                if name.startswith("bench.") or (annotated and e.is_user_annotation()):
                    continue
                start = e.start_ns()
                self.kernels.append((name, start, start + e.duration_ns(), e.correlation_id(),
                                     e.linked_correlation_id()))
            elif name == SPAN:
                self.window = (e.start_ns(), e.start_ns() + e.duration_ns())
            elif name.startswith("cudaGraphLaunch"):
                self.launches.append((e.start_ns(), e.correlation_id()))
            elif name in HOST_SPANS:
                self.spans.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
        self.launches.sort()
        if self.window is None:
            raise RuntimeError(f"the trace has no {SPAN} span")

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_s(self, lo: int, hi: int) -> float:
        """Seconds of [lo, hi] (ns on the trace's clock) in which the device
        ran an operation."""
        return _union([(s, e) for _n, s, e, _c, _l in self.kernels], lo, hi)[0] / 1e9

    def busy_idle(self) -> tuple:
        """(busy seconds, [(host label, idle seconds)] of the gaps, longest first)."""
        busy, gaps = _union([(s, e) for _n, s, e, _c, _l in self.kernels], *self.window)
        named = []
        for s, e in gaps:
            open_ = sorted({n.split(".")[1] for n, a, b in self.spans if a < e and b > s})
            named.append(("+".join(open_) or "no harness span", (e - s) / 1e9))
        named.sort(key=lambda g: -g[1])
        return busy / 1e9, named

    def top_kernels(self, count: int = 10) -> list:
        total = {}
        for name, s, e, _c, _l in self.kernels:
            total[name] = total.get(name, 0) + (e - s)
        return [[n[:200], t / 1e9] for n, t in sorted(total.items(), key=lambda x: -x[1])[:count]]

    def batches(self, per_batch: int, count: int) -> list:
        """The first `count` batches launched inside the traced span: their
        graph launches, each a list of `per_batch` lists of (name, start,
        end) of the launch's kernels."""
        inside = [cid for t, cid in self.launches if t >= self.window[0]]
        ids = inside[:per_batch * count]
        by_id = {cid: [] for cid in ids}
        for name, s, e, cid, lid in self.kernels:
            for key in (cid, lid):
                if key in by_id:
                    by_id[key].append((name, s, e))
                    break
        groups = [[by_id[c] for c in ids[b * per_batch:(b + 1) * per_batch]]
                  for b in range(len(ids) // per_batch)]
        return [g for g in groups if all(g)]


def union_s(kernels) -> float:
    return _union([(s, e) for _n, s, e in kernels], min(s for _n, s, _e in kernels),
                  max(e for _n, _s, e in kernels))[0] / 1e9


def matching(kernels, names) -> list:
    """The kernels whose name holds one of `names` as a whole word."""
    pats = [re.compile(rf"\b{re.escape(n)}\b") for n in names]
    hit = {}
    for k in kernels:
        if k[0] not in hit:
            hit[k[0]] = any(p.search(k[0]) for p in pats)
    return [k for k in kernels if hit[k[0]]]
