"""The prover's tracer (plonky2_ecdsa_tpu_torch/trace.py) on the CPU:

  (a) host spans nest, carry their thread, and the rings keep the last
      records only;
  (b) disable() leaves no records, and the proof is the same;
  (c) the CPU prover's stamps give one ordered, non-overlapping interval for
      each STOP_AFTER stage, each quotient domain chunk, the upload and the
      readback, for both of two batches in flight; and a batch's record
      from a stamp buffer read in stream order, as the card's graphs give;
  (d) proofs with tracing on equal the reference's leaf for leaf;
  (e) a span recorded under torch.profiler, mapped by the stored offset,
      lands on its record_function event;
  (f) the capture guard passes the graphs' bodies with their stamps in
      place.

On the CPU a stamp reads the host clock: the CPU proves eagerly and
synchronously.  The stamp kernel itself runs only on the card."""

import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from plonky2_ecdsa_tpu.circuit import examples as ref_examples
from plonky2_ecdsa_tpu.prover import data as ref_data_mod
from plonky2_ecdsa_tpu.prover import prover as ref_prover
from plonky2_ecdsa_tpu_torch import trace
from plonky2_ecdsa_tpu_torch.prover import prover
from test_torch_bridge import from_reference_proof
from test_torch_graph_prover import CaptureGuard, _vals_body, _wide_body, demo  # noqa: F401

FRONT = ["expand", "commit", "challenges", "zs_perm", "zs_vals", "zs", "alphas"]
BACK = ["quotient", "openings", "reduced", "fri", "grind", "fri_all", "queries"]


@pytest.fixture(autouse=True)
def fresh_trace():
    trace.enable()
    trace.clear()
    yield
    trace.enable()
    trace.clear()


@pytest.fixture(scope="module")
def reference():
    """The reference's numpy proof of the demo circuit at B=2."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PLONKY2_TPU_HOST_BUILD", "1")
    try:
        rc = ref_examples.small_demo_circuit().build()
        proof = ref_prover.prove(ref_data_mod.build_circuit_data(rc),
                                 *ref_examples.small_demo_witness(rc, batch=2))
    finally:
        mp.undo()
    return from_reference_proof(proof)


# ---------------------------------------------------------------------------
# (a) spans and the rings
# ---------------------------------------------------------------------------

def test_spans_nest_and_carry_their_thread():
    def witness():
        with trace.span("witness.tape"):
            pass

    with trace.span("prove.launch"):
        with trace.span("capture.front") as inner:
            th = threading.Thread(target=witness, name="witness")
            th.start()
            th.join()
    got = {s.name: s for s in trace.spans()}
    assert [s.name for s in trace.spans()] == ["witness.tape", "capture.front", "prove.launch"]
    outer, tape = got["prove.launch"], got["witness.tape"]
    assert (outer.depth, outer.parent, outer.thread) == (0, None, "MainThread")
    assert (got["capture.front"].depth, got["capture.front"].parent) == (1, "prove.launch")
    # another thread's stack is its own: not nested under the main thread's spans
    assert (tape.thread, tape.depth, tape.parent) == ("witness", 0, None)
    assert outer.start <= inner.start <= tape.start <= tape.end <= inner.end <= outer.end
    assert inner.seconds == (inner.end - inner.start) / 1e9


def test_the_rings_keep_the_last_records():
    for i in range(trace.SPANS + 3):
        with trace.span(f"s{i}"):
            pass
    spans = trace.spans()
    assert len(spans) == trace.SPANS
    assert (spans[0].name, spans[-1].name) == ("s3", f"s{trace.SPANS + 2}")
    for i in range(trace.BATCHES + 2):
        with trace.dispatching("vals", i) as pending:
            with trace.span("prove.split"):
                pass
        with trace.collecting(pending):
            pass
    batches = trace.batches()
    assert len(batches) == trace.BATCHES
    assert (batches[0].batch, batches[-1].batch) == (2, trace.BATCHES + 1)
    assert [s.name for s in batches[-1].spans] == ["prove.split"]
    assert batches[-1].stages == ()


# ---------------------------------------------------------------------------
# (b) off
# ---------------------------------------------------------------------------

def test_disable_leaves_no_records_and_the_same_proof(demo):
    data, _W, _pis, tables = demo
    run = prover.Prover(data)
    on = run.run_vals(*tables[0])
    assert len(trace.batches()) == 1
    before = (trace.batches(), trace.spans())
    trace.disable()
    try:
        assert trace.span("a") is trace.span("b")
        buf = trace.StampBuffer("cpu")
        with trace.stamping(buf):
            trace.stamp("commit")
        assert buf.names == []
        off = run.run_vals(*tables[0])
        assert (trace.batches(), trace.spans()) == before
    finally:
        trace.enable()
    assert prover.first_difference(on, off) is None


# ---------------------------------------------------------------------------
# (c) the stages of a batch
# ---------------------------------------------------------------------------

def _check_stages(rec, chunks: int):
    names = [(s.part, s.name) for s in rec.stages]
    assert names == ([("upload", "upload")] + [("front", n) for n in FRONT]
                     + [("quotient", f"chunk.{i}") for i in range(chunks)]
                     + [("back", n) for n in BACK] + [("readback", "readback")])
    assert {n for p, n in names if p in ("front", "back")} >= set(prover.STOP_AFTER)
    for a, b in zip(rec.stages, rec.stages[1:]):
        assert a.start <= a.end <= b.start <= b.end, (a, b)
    # prove_core runs inside the dispatch, the readback inside the collect
    assert rec.dispatch[0] <= rec.stages[0].start and rec.stages[-2].end <= rec.dispatch[1]
    assert rec.collect[0] <= rec.stages[-1].start <= rec.stages[-1].end <= rec.collect[1]


def test_stamps_give_ordered_stages_for_two_batches_in_flight(demo, reference, monkeypatch):
    """The demo's LDE domain in four quotient chunks; batch 2 dispatched
    before batch 1 is collected."""
    data, _W, _pis, tables = demo
    monkeypatch.setattr(prover, "DOMAIN_CHUNK", data.N // 4)
    run = prover.Prover(data)
    h1 = run.dispatch_vals(*tables[0])
    h2 = run.dispatch_vals(*tables[1])
    first = run.collect(h1)
    run.collect(h2)
    recs = trace.batches()
    assert [(r.path, r.batch) for r in recs] == [("vals", 2), ("vals", 2)]
    assert recs[0].seq < recs[1].seq
    for rec in recs:
        _check_stages(rec, 4)
        assert [s.name for s in rec.spans] == ["prove.split", "prove.load", "prove.launch",
                                               "prove.unpack"]
    assert recs[1].dispatch[1] <= recs[0].collect[0]
    assert prover.first_difference(reference, first) is None


def test_a_batch_record_from_a_stamp_buffer_in_stream_order():
    """The card's record: slots given out as a capture gives them (the
    graphs' first, the eager ones after), read in stream order from a host
    copy, shifted by the buffer's calibration."""
    buf = trace.StampBuffer("cpu")
    front = [buf.add("front", True), buf.add("expand")]
    back = [buf.add("back", True), buf.add("quotient")]
    upload = [buf.add("upload", True), buf.add("upload")]
    readback = [buf.add("readback", True), buf.add("readback")]
    order = upload + front + back + readback
    times = torch.zeros(len(buf.names), dtype=torch.int64)
    for k, slot in enumerate(order):
        times[slot] = 1000 + 10 * k
    buf.offset = 5
    with trace.dispatching("vals", 4) as pending:
        pending.stamps_from(buf, order, times)
    with trace.collecting(pending):
        pass
    assert [(s.part, s.name, s.start, s.end) for s in trace.batches()[-1].stages] == [
        ("upload", "upload", 1005, 1015), ("front", "expand", 1025, 1035),
        ("back", "quotient", 1045, 1055), ("readback", "readback", 1065, 1075)]


# ---------------------------------------------------------------------------
# (d) against the reference
# ---------------------------------------------------------------------------

def test_traced_proofs_equal_the_reference(demo, reference):
    """Through the value table and through the full witness, tracing on."""
    data, W, pis, tables = demo
    run = prover.Prover(data)
    assert prover.first_difference(reference, run.run_vals(*tables[0])) is None
    assert prover.first_difference(reference, run.collect(run.dispatch(W, pis))) is None
    assert [r.path for r in trace.batches()] == ["vals", "wide"]
    for rec in trace.batches():
        _check_stages(rec, 1)


# ---------------------------------------------------------------------------
# (e) on the profiler's timeline
# ---------------------------------------------------------------------------

def test_a_span_lands_on_its_profiler_event():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("trace.first"):       # a process's first record_function sets up
            pass
        with trace.span("trace.profiled"):
            time.sleep(0.003)
    with trace.span("trace.unprofiled"):
        pass
    rec = next(s for s in trace.spans() if s.name == "trace.profiled")
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "trace.profiled"]
    assert len(events) == 1
    ev = events[0]
    assert abs(rec.start + trace.PROFILER_OFFSET_NS - ev.start_ns()) < 1_000_000
    assert abs(rec.end + trace.PROFILER_OFFSET_NS - ev.start_ns() - ev.duration_ns()) < 1_000_000


# ---------------------------------------------------------------------------
# (f) the capture guard, stamps in place
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["vals", "wide"])
def test_capture_guard_passes_the_graph_bodies_with_their_stamps(path, demo, monkeypatch):
    data, W, pis, tables = demo
    run = prover.Prover(data)
    body = _vals_body(run, tables[0][0]) if path == "vals" else _wide_body(run, W, pis)
    want = body.whole()                          # the warm-up: prove_core, no stamps
    buf = trace.StampBuffer("cpu")
    with CaptureGuard(monkeypatch) as guard, trace.stamping(buf):
        got = body()
    assert torch.equal(got[0], want)
    assert guard.hazards == [] and guard.cache_misses == []
    assert buf.names == ([("front", True)] + [(n, False) for n in FRONT] + [("back", True)]
                         + [(n, False) for n in BACK] + [("pack", False)])


def test_spans_of_many_threads_all_land():
    """Eight threads closing nested spans at a short switch interval: every
    span lands in the ring once, nested under its own thread's span."""
    def work():
        for _ in range(500):
            with trace.span("outer"):
                with trace.span("inner"):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, name=f"t{i}") for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    spans = trace.spans()
    assert len(spans) == 8 * 1000
    for s in spans:
        assert (s.depth, s.parent) == ((1, "outer") if s.name == "inner" else (0, None))
    assert {s.thread for s in spans} == {f"t{i}" for i in range(8)}
