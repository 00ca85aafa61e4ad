"""Run one cell of the benchmark once and print its result as the last line:

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  The cell names a
configuration (``benchmark/configs/<config>.json``: its driver, its program
settings and its frozen circuit) and a traffic mix
(``benchmark/traffic/<traffic>.json``); each metric is read by
``benchmark/metrics/<metric>.py``.  Set-up builds the circuit, makes the
statement pool from the seed, commits the fixed data and runs one batch,
which captures the prover's graphs for the cell's batch size.  The window
then drives the program's entries in a closed loop for --seconds; the
proofs it read back are judged by the plain reference after it closes.
With --trace 1 the per-layer metrics are printed instead of the end-to-end
ones; the window runs as without, and then the same loop runs TRACE_BATCHES
more batches under torch.profiler.
"""

from __future__ import annotations

import argparse
import collections
import importlib
import importlib.util
import json
import os
import queue
import subprocess
import sys
import threading
import time

from .trace import SPAN

HERE = os.path.dirname(os.path.abspath(__file__))
# A traced run adds TRACE_BATCHES batches after the window has closed, under
# torch.profiler: once CUPTI traces kernels, every launch of a CUDA graph
# costs the host about a quarter of a second for the outer proof's 117k-node
# chunk graph (0.5 ms without; H100 80GB HBM3, PyTorch 2.11, CUDA 12.8), and
# stays so after the profile stops.  The window itself is never profiled.
TRACE_BATCHES = 2
ORDER_LENGTH = 1 << 14
FORBIDDEN = ("jax", "jaxlib", "flax", "plonky2_ecdsa_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc)."""
    with open("/proc/self/stat") as fh:
        start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        uptime = float(fh.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


class Cell:
    """One entry of BENCHMARK.json's workloads, with its files loaded."""

    def __init__(self, bench: dict, name: str, seed: int, root: str = HERE):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
        self.root, self.name, self.seed = root, name, seed
        self.spec = cells[name]
        self.config = self.load_config(self.spec["config"])
        from . import traffic
        self.traffic = traffic.load(self.spec["traffic"], root)
        self.metrics = {}
        for kind in ("end_to_end", "per_layer"):
            self.metrics[kind] = [m for m in bench[kind]
                                  if name in m.get("workloads", [name])]

    def load_config(self, name: str) -> dict:
        with open(os.path.join(self.root, "configs", f"{name}.json")) as fh:
            return json.load(fh)

    def module(self, folder: str, name: str):
        """benchmark/<folder>/<name>.py of this cell's root, loaded by path."""
        path = os.path.join(self.root, folder, f"{name}.py")
        spec = importlib.util.spec_from_file_location(f"benchmark_{folder}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def loaded_forbidden() -> list:
    """Top-level names of the loaded modules that the run must not load,
    compared whole (the program's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_info() -> dict:
    import torch
    info = {"name": torch.cuda.get_device_name(0)}
    try:
        out = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=clocks.max.sm,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20).stdout.strip()
        info["clocks_max_sm"], info["power_limit"] = [s.strip() for s in out.split(",")][:2]
    except (OSError, subprocess.SubprocessError, ValueError):
        info["clocks_max_sm"] = info["power_limit"] = "not read"
    return info


class Window:
    """The closed loop: a producer thread makes each batch's witness when one
    of the traffic's in_flight places is free; the main thread dispatches it
    and collects the oldest proof once in_flight batches are out.  New
    batches start until `seconds` have passed, or until `batches` have
    started; the window ends with the last proof on the host, so every batch
    started counts, with all its time.  The main thread's waits, dispatches
    and collects are host spans of a trace (``trace.HOST_SPANS``)."""

    def __init__(self, session, order, in_flight: int, on_card: bool,
                 seconds: float | None = None, batches: int | None = None):
        self.session, self.order, self.in_flight = session, order, in_flight
        self.seconds, self.batches, self.on_card = seconds, batches, on_card
        self.records, self.failed_batches, self.errors = [], [], []

    def run(self):
        import torch
        from torch.profiler import record_function

        s = self.session
        q: queue.Queue = queue.Queue()
        places = threading.Semaphore(self.in_flight)
        self.t_start = time.perf_counter()
        deadline = None if self.seconds is None else self.t_start + self.seconds

        def producer():
            try:
                i = 0
                while True:
                    places.acquire()
                    t0 = time.perf_counter()
                    if i and (i == self.batches or (deadline is not None and t0 >= deadline)):
                        break
                    k = self.order[i]
                    vals, pis = s.witness(k)
                    q.put((i, k, t0, time.perf_counter(), vals, pis))
                    i += 1
            except Exception as e:           # reported by the main thread
                self.errors.append(e)
            q.put(None)

        th = threading.Thread(target=producer, name="witness", daemon=True)
        th.start()
        pending = collections.deque()

        def collect():
            rec, handle = pending.popleft()
            try:
                with record_function("bench.collect"):
                    rec["proof"] = s.prover.collect(handle)
                rec["t3"] = time.perf_counter()
                self.records.append(rec)
            except Exception as e:           # a batch that fails counts as failed
                self.failed_batches.append((rec["i"], repr(e)))
            places.release()

        while True:
            with record_function("bench.wait"):
                item = q.get()
            if item is None:
                break
            i, k, t0, t1, vals, pis = item
            with record_function("bench.dispatch"):
                handle = s.prover.dispatch_vals(vals, pis)
            pending.append(({"i": i, "k": k, "t0": t0, "t1": t1}, handle))
            if len(pending) == self.in_flight:
                collect()
        while pending:
            collect()
        th.join()
        if self.on_card:
            torch.cuda.synchronize()
        self.t_end = time.perf_counter()
        if self.errors:
            raise self.errors[0]


def traced_window(session, order: list, in_flight: int):
    """TRACE_BATCHES more batches, run by the window's own loop, under
    torch.profiler -> (profile, window)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    window = Window(session, order, in_flight, on_card=True, batches=TRACE_BATCHES)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    with record_function(SPAN):
        window.run()
    prof.stop()
    return prof, window


class Run:
    """What the metric readers read."""

    def __init__(self, cell, session, window, setup_s, peak_window, stats, trace, traced):
        from .ref.circuit import Common
        self.cell = cell
        self.lanes = session.lanes
        self.records = window.records
        self.window_s = window.t_end - window.t_start
        self.setup_s = setup_s
        self.peak_window_bytes = peak_window
        self.graph_stats = stats
        self.trace, self.traced = trace, traced
        self.common = Common(cell.config["circuit"])


def _metric(spec: dict, run) -> dict | None:
    mod = run.cell.module("metrics", spec["name"])
    value = mod.read(run)
    if value is None:
        return None
    out = {"value": float(value), "unit": spec["unit"]}
    out.update(getattr(mod, "extra", lambda r: {})(run))
    return out


def main(argv=None) -> int:
    """The command: prints the result as the last line of standard output."""
    result = execute(argv)
    if isinstance(result, int):
        return result
    print(json.dumps(result, default=str))
    return 0


def execute(argv=None, device: str | None = None, root: str = HERE):
    """One run -> its result (a dict), or an exit code where there is none.
    `device` other than None skips the look for a chip and runs there, and
    `root` reads the cell's files from another folder (tests on the CPU)."""
    age0 = process_age_s()
    t_process = time.perf_counter() - age0
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench_path = os.path.join(os.getcwd(), "BENCHMARK.json")
    if not os.path.exists(bench_path):
        print(f"no BENCHMARK.json in {os.getcwd()}", file=sys.stderr)
        return 2
    with open(bench_path) as fh:
        bench = json.load(fh)
    cell = Cell(bench, args.workload, args.seed, root)

    import torch
    if device is None:
        need = int(cell.spec["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            print(f"benchmark: the cell needs {need} CUDA device(s); "
                  f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                  f"device_count={torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = "cuda"
    try:
        importlib.import_module("plonky2_ecdsa_tpu_torch")
    except ImportError as e:
        print(f"benchmark: the program is not importable here: {e}", file=sys.stderr)
        return 2
    on_card = device == "cuda"
    card = card_info() if on_card else {"name": "cpu"}

    from . import traffic
    driver = cell.module("drivers", cell.config["driver"])
    session = driver.Session(cell, device)
    mix = cell.traffic
    order = traffic.order(args.seed, len(session.pool), ORDER_LENGTH)
    # the first batch: warms the witness tape and captures the prover's graphs
    session.prover.collect(session.prover.dispatch_vals(*session.witness(0)))
    stats = session.graph_stats()
    if on_card:
        torch.cuda.synchronize()
        peak_setup = torch.cuda.max_memory_reserved()
        # the window's peak starts from what the prover holds, not from blocks
        # that set-up's transient work left in the allocator's cache
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    window = Window(session, order, int(mix["in_flight"]), on_card, seconds=args.seconds)
    setup_s = time.perf_counter() - t_process
    window.run()
    peak_window = torch.cuda.max_memory_reserved() if on_card else 0
    trace, traced = None, []
    if args.trace:
        from .trace import Trace
        prof, traced_win = traced_window(session, order[len(window.records):],
                                         int(mix["in_flight"]))
        traced = traced_win.records
        window.failed_batches += traced_win.failed_batches
        t_parse = time.perf_counter()
        trace = Trace(prof)
        del prof
        groups = trace.batches(stats.get("domain_chunks", 0) + 2, TRACE_BATCHES)
        print(f"trace: {len(trace.kernels)} device operations, {len(trace.launches)} graph "
              f"launches, {trace.window_s:.3f} s traced, whole batches {len(groups)} with "
              f"{[sum(map(len, g)) for g in groups]} operations, parsed in "
              f"{time.perf_counter() - t_parse:.1f} s", file=sys.stderr)
    session.release()

    done = [(r["k"], r["proof"]) for r in window.records + traced]
    t_judge = time.perf_counter()
    correct, numbers, details = session.judge(done, traffic.rng(args.seed, 2))
    details["judge_s"] = time.perf_counter() - t_judge
    failed_lanes = session.lanes * len(window.failed_batches)
    correct = correct and not window.failed_batches
    attempted = session.lanes * (len(done) + len(window.failed_batches))
    numbers.append(("batches_failed", len(window.failed_batches), 0))

    run = Run(cell, session, window, setup_s, peak_window, stats, trace, traced)
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    t_read = time.perf_counter()
    for spec in cell.metrics[kind]:
        m = _metric(spec, run)
        if m is not None:
            metrics[spec["name"]] = m
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed_lanes + sum(v for n, v, _l in numbers
                                           if n in ("lanes_rejected", "pis_unbound")),
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu", "kind": card["name"],
                         "count": int(cell.spec["chips"]),
                         "memory_peak_bytes": int(max(peak_setup, peak_window)) if on_card else 0}}
    details["metrics_s"] = time.perf_counter() - t_read
    if trace is not None:
        busy_s, gaps = trace.busy_idle()
        result["device"].update(busy_s=busy_s, window_s=trace.window_s)
        result["breakdown"] = {"device_ops": trace.top_kernels(10),
                               "idle_gaps": [[n, s] for n, s in gaps[:10]]}
    result["card"] = card
    result["run"] = {"batches": len(done), "window_s": run.window_s, "setup_s": setup_s,
                     "setup_spans": session.spans, "graphs": stats, "details": details}
    result["run"]["process_s"] = time.perf_counter() - t_process
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in numbers}
    for n, v, lim in numbers:
        print(f"check {n}: {v} (limit {lim})", file=sys.stderr)
    # last: the judge and every metric reader have run, and loaded what they load
    forbidden = loaded_forbidden()
    if forbidden:
        print(f"benchmark: the run loaded {forbidden}, which it must not", file=sys.stderr)
        return 3
    return result


if __name__ == "__main__":
    sys.exit(main())
