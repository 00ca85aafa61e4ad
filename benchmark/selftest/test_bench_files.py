"""BENCHMARK.json against the benchmark's contract, every file it names
found by name, a cell, a configuration and a metric added from a temporary
folder as files only, and the check that the run loads no JAX."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import run, traffic

ROOT = os.path.dirname(run.HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_top_level_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert len(bench["command"]) <= 32 and not any(w.startswith("/") for w in bench["command"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_bounds(bench):
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"]) and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("kind", ["configs", "workloads", "metrics"])
def test_every_named_file_is_found(bench, kind):
    if kind == "configs":
        for c in bench["configs"]:
            assert set(c) == {"name", "source", "file", "reduced", "why"}
            assert c["file"] == f"benchmark/configs/{c['name']}.json"
            with open(os.path.join(ROOT, c["file"])) as fh:
                assert json.load(fh)["reduced"] == c["reduced"] == []
    elif kind == "workloads":
        for w in bench["workloads"]:
            assert w["chips"] == 1 and len(w["why"]) <= 200
            cell = run.Cell(bench, w["name"], 7)
            assert cell.config["name"] == w["config"] and cell.traffic["batch"] >= 1
            assert {m["name"] for m in cell.metrics["end_to_end"]} >= {"setup_s", "proofs_per_s"}
            assert cell.metrics["per_layer"]
    else:
        for m in bench["end_to_end"] + bench["per_layer"]:
            assert callable(run.Cell(bench, bench["workloads"][0]["name"], 7)
                            .module("metrics", m["name"]).read)


def test_a_cell_config_and_metric_added_as_files_only(bench, tmp_path):
    """A later change adds a configuration, a traffic mix, a cell and a
    per-layer metric by writing files; the harness finds them by name."""
    root = tmp_path / "benchmark"
    shutil.copytree(run.HERE, root, ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((root / "configs" / "secp256k1_ecdsa.json").read_text())
    cfg["name"] = "secp256k1_ecdsa_copy"
    (root / "configs" / "secp256k1_ecdsa_copy.json").write_text(json.dumps(cfg))
    (root / "traffic" / "b4.json").write_text(json.dumps({"batch": 4, "in_flight": 1,
                                                          "pool_batches": 3}))
    (root / "metrics" / "lanes_per_batch.py").write_text(
        "def read(run):\n    return run.lanes\n")
    b = json.loads(json.dumps(bench))
    b["configs"].append({"name": "secp256k1_ecdsa_copy", "source": "x", "reduced": [],
                         "file": "benchmark/configs/secp256k1_ecdsa_copy.json", "why": "x"})
    b["workloads"].append({"name": "copy.b4", "config": "secp256k1_ecdsa_copy", "traffic": "b4",
                           "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "lanes_per_batch", "unit": "lanes", "better": "higher",
                           "source": "program_counter", "layer": "api witness tape",
                           "moves": "proofs_per_s", "workloads": ["copy.b4"]})
    cell = run.Cell(b, "copy.b4", 5, str(root))
    assert cell.config["name"] == "secp256k1_ecdsa_copy" and cell.traffic["pool_batches"] == 3
    assert [m["name"] for m in cell.metrics["per_layer"]] == ["lanes_per_batch"]

    class Fake:
        lanes = 4
    assert cell.module("metrics", "lanes_per_batch").read(Fake()) == 4
    assert len(traffic.statement_pool("secp256k1", cell.traffic, 5)) == 3


def test_forbidden_modules_are_compared_by_whole_top_level_names(monkeypatch):
    for name in ("plonky2_ecdsa_tpu_torch", "plonky2_ecdsa_tpu_torch.api", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.loaded_forbidden() == []
    for name, top in (("plonky2_ecdsa_tpu.api", "plonky2_ecdsa_tpu"), ("jaxlib", "jaxlib"),
                      ("jax.numpy", "jax"), ("flax", "flax")):
        monkeypatch.setitem(sys.modules, name, sys)
        assert top in run.loaded_forbidden()


def test_the_harness_and_what_it_drives_load_no_jax():
    """A fresh process imports the harness, every driver and reader, the
    reference, and the program's modules that the drivers call."""
    code = """
import json, os, sys
from benchmark import run, judge, work, trace, traffic, proofs
from benchmark.selftest import control
from benchmark.ref import verifier
bench = json.load(open('BENCHMARK.json'))
for w in bench['workloads']:
    cell = run.Cell(bench, w['name'], 1)
    cell.module('drivers', cell.config['driver'])
    for m in cell.metrics['end_to_end'] + cell.metrics['per_layer']:
        cell.module('metrics', m['name'])
import plonky2_ecdsa_tpu_torch.api
import plonky2_ecdsa_tpu_torch.circuit.recursive_verifier
import plonky2_ecdsa_tpu_torch.prover.prover
print(run.loaded_forbidden())
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_the_program_the_run_fails(tmp_path):
    """In a folder that holds only BENCHMARK.json and the benchmark's files
    the command exits with an error and prints no result."""
    shutil.copytree(run.HERE, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    argv = ["--workload", "secp256k1_ecdsa.b32", "--seed", "1", "--seconds", "1", "--trace", "0"]
    for code in ([sys.executable, "-m", "benchmark.run", *argv],     # no card here: refused first
                 [sys.executable, "-c", "import sys; from benchmark import run; "  # past the look
                  f"r = run.execute({argv!r}, device='cpu'); print(r); sys.exit(r)"]):
        out = subprocess.run(code, cwd=tmp_path, capture_output=True, text=True, timeout=300,
                             env={**os.environ, "PYTHONPATH": str(tmp_path)})
        assert out.returncode != 0 and out.stdout.strip() in ("", "2"), out.stderr[-2000:]
