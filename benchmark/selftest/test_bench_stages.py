"""The readers of the program's tracer (``stages.py`` and the metrics
front_ms, quotient_ms, back_ms, window_idle_share, host_prove_ms) on
synthetic tracer records: the window's filter, which drops the set-up batch
and the batches traced after the window; an idle gap named by the program
span open across it; and two batches in flight whose stage intervals
overlap, counted once."""

import json
import os

import pytest

from benchmark import stages
from benchmark.run import HERE, Cell
from plonky2_ecdsa_tpu_torch.trace import Batch, Span, Stage

MS = 1_000_000          # ns


def batch(seq: int, t: int, quotient=(40, 45), front=20, back=30, wait=0) -> Batch:
    """A batch dispatched at t ms: upload 2 ms, then `front` ms of front
    stages, the quotient chunks (ms each, 1 ms apart), `back` ms of back
    stages, readback 1 ms, the parts back to back but for the chunks' gaps;
    its dispatch 3 ms, its collect `wait` + 2 ms."""
    st, c = [], t
    st.append(Stage("upload", "upload", c * MS, (c + 2) * MS))
    c += 2
    st.append(Stage("front", "expand", c * MS, (c + 5) * MS))
    st.append(Stage("front", "commit", (c + 5) * MS, (c + front) * MS))
    c += front
    for i, q in enumerate(quotient):
        st.append(Stage("quotient", f"chunk.{i}", (c + 1) * MS, (c + 1 + q) * MS))
        c += 1 + q
    st.append(Stage("back", "quotient", c * MS, (c + 10) * MS))
    st.append(Stage("back", "openings", (c + 10) * MS, (c + back) * MS))
    c += back
    st.append(Stage("readback", "readback", c * MS, (c + 1) * MS))
    c += 1
    spans = (Span("prove.split", "MainThread", t * MS, (t + 1) * MS, 0, None),
             Span("prove.wait", "MainThread", (c - wait) * MS, c * MS, 0, None))
    return Batch("vals", 8, seq, (t * MS, (t + 3) * MS), ((c - wait) * MS, (c + 2) * MS),
                 spans, tuple(st))


class Run:
    def __init__(self, t0_ms, t3_ms):
        self.records = [{"t0": t0_ms / 1e3, "t3": t3_ms / 1e3}]


@pytest.fixture()
def readers():
    with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cell = Cell(bench, bench["workloads"][0]["name"], 1)
    return {n: cell.module("metrics", n) for n in
            ("front_ms", "quotient_ms", "back_ms", "window_idle_share", "host_prove_ms")}


def test_the_window_drops_the_set_up_and_the_traced_batches(readers, monkeypatch):
    # set-up batch at 0 ms; the window's batches at 1000 and 1200 ms; two traced at 2000+
    setup = batch(0, 0, quotient=(400, 400), front=200, back=300, wait=5)
    window = [batch(1, 1000, wait=50), batch(2, 1200, quotient=(50, 55), wait=70)]
    traced = [batch(3, 2000, quotient=(900,), front=900, back=900),
              batch(4, 2500, quotient=(900,), front=900, back=900)]
    monkeypatch.setattr(stages, "program_trace", lambda: ([setup, *window, *traced], []))
    run = Run(990, 1500)
    assert readers["front_ms"].read(run) == 20.0
    assert readers["quotient_ms"].read(run) == pytest.approx((85 + 105) / 2)
    assert readers["back_ms"].read(run) == 30.0
    for name in readers:
        assert readers[name].extra(run)["batches"] == 2, name
    front = readers["front_ms"].extra(run)
    assert (front["upload_ms"], front["expand_ms"], front["commit_ms"]) == (2.0, 5.0, 15.0)
    assert readers["quotient_ms"].extra(run)["chunks"] == 2
    assert readers["back_ms"].extra(run)["readback_ms"] == 1.0
    # dispatch 3 ms + collect (wait + 2 ms) - wait
    assert readers["host_prove_ms"].read(run) == 5.0
    assert readers["host_prove_ms"].extra(run)["wait_ms"] == 60.0


def test_an_idle_gap_is_named_by_the_span_open_across_it(readers, monkeypatch):
    a = batch(1, 0, quotient=(40,))           # stages 0 .. 94 ms, one 1 ms gap before its chunk
    b = batch(2, 105, quotient=(40,))         # 105 .. 199 ms
    tape = Span("witness.tape", "witness", 90 * MS, 104 * MS, 0, None)
    inner = Span("witness.inputs", "witness", 95 * MS, 97 * MS, 1, "witness.tape")
    split = Span("prove.split", "MainThread", 104 * MS, 106 * MS, 0, None)
    monkeypatch.setattr(stages, "program_trace", lambda: ([a, b], [tape, inner, split]))
    run = Run(0, 300)
    idle = 2 + 11                              # the chunks' gaps and the one between batches
    assert readers["window_idle_share"].read(run) == pytest.approx(100 * idle / 199)
    ex = readers["window_idle_share"].extra(run)
    assert ex["idle_s"] == pytest.approx(idle / 1e3)
    assert ex["idle_s.witness.tape"] == pytest.approx(8e-3)       # 94 .. 104 less the inner span
    assert ex["idle_s.witness.inputs"] == pytest.approx(2e-3)
    assert ex["idle_s.prove.split"] == pytest.approx(1e-3)        # 104 .. 105
    assert ex["idle_s.none"] == pytest.approx(2e-3)               # the chunks' gaps


def test_two_batches_in_flight_overlap_counted_once(readers, monkeypatch):
    a = batch(1, 0, quotient=(40,))            # 0 .. 94 ms, idle 22 .. 23
    b = batch(2, 50, quotient=(40,))           # 50 .. 144 ms, idle 72 .. 73 (inside a's back)
    monkeypatch.setattr(stages, "program_trace", lambda: ([a, b], []))
    run = Run(0, 300)
    covered, gaps = stages.union([(s.start, s.end) for x in (a, b) for s in x.stages],
                                 0, 144 * MS)
    assert covered == 144 * MS - MS and gaps == [(22 * MS, 23 * MS)]
    assert readers["window_idle_share"].read(run) == pytest.approx(100 * 1 / 144)


def test_no_tracer_no_reading(readers, monkeypatch):
    monkeypatch.setattr(stages, "program_trace", lambda: ([], []))
    for name, mod in readers.items():
        assert mod.read(Run(0, 1)) is None, name
        assert mod.extra(Run(0, 1)) == {}, name
