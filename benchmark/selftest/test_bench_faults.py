"""A whole run of a flat cell on the CPU, past the look for a chip, with the
timed path broken underneath: ``correct`` must come out false for each fault
the cell can have, and true without one.

The program's proofs of the cell's statement pool are made once (a real
proof of each pool batch, two lanes each); the prover under the window is
then a stand-in that hands them back, broken as each fault says:

  * altered: one word of a lane's openings changed where it is produced;
  * half:    half of the batch left out, the other half's proofs standing in;
  * stale:   a step that returns its state unchanged: the previous batch's
             proof again;

(the exchange between chips does not exist in a one-chip cell).
"""

import copy
import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

from benchmark import run, traffic

torch.set_num_threads(2)
CELL, SEED, LANES = "secp256k1_ecdsa.cpu2", 2**31 + 11, 2


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("faults")
    root = tmp / "benchmark"
    shutil.copytree(run.HERE, root, ignore=shutil.ignore_patterns("__pycache__"))
    (root / "traffic" / "cpu2.json").write_text(json.dumps(
        {"batch": LANES, "in_flight": 1, "pool_batches": 2}))
    with open(run.HERE + "/../BENCHMARK.json") as fh:
        bench = json.load(fh)
    bench["workloads"].append({"name": CELL, "config": "secp256k1_ecdsa", "traffic": "cpu2",
                               "chips": 1, "why": "the fault test's cell"})
    cwd = tmp / "cwd"
    cwd.mkdir()
    (cwd / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, cwd


@pytest.fixture(scope="module")
def canned(folders):
    """{public inputs: the program's proof} of every pool batch."""
    from plonky2_ecdsa_tpu_torch import api
    root, _cwd = folders
    system = api.EcdsaProverSystem(device="cpu")
    out = {}
    for batch in traffic.statement_pool("secp256k1", traffic.load("cpu2", str(root)), SEED):
        stmts = [api.EcdsaStatement(msg=s.msg, r=s.r, s=s.s, pk=api.cn.Point(api.SECP256K1, *s.pk))
                 for s in batch]
        proof = system.prove(stmts)
        out[np.asarray(proof.pis, np.uint64).tobytes()] = proof
    return out


def _lanes(proof, fn):
    """proof with fn applied to every array of it (lane axis first)."""
    def walk(x):
        if isinstance(x, np.ndarray):
            return fn(x.copy())
        if isinstance(x, tuple):
            return tuple(walk(v) for v in x)
        if isinstance(x, list):
            return [walk(v) for v in x]
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{f.name: walk(getattr(x, f.name))
                                             for f in dataclasses.fields(x)
                                             if f.name != "layout"})
        return x
    return walk(proof)


def _altered(proof, _last):
    p = copy.deepcopy(proof)
    p.openings0[0][0, 5] ^= np.uint64(1)
    return p


def _half(proof, _last):
    def first_half(a):
        h = a.shape[0] // 2
        a[h:] = a[:a.shape[0] - h]
        return a
    return _lanes(proof, first_half)


def _stale(proof, last):
    return last if last is not None else proof


class Canned:
    """The prover's dispatch_vals / collect over the canned proofs."""

    graph_stats = {}

    def __init__(self, proofs, fault):
        self.proofs, self.fault, self.last = proofs, fault, None

    def dispatch_vals(self, vals, pis):
        return np.asarray(pis, np.uint64).tobytes()

    def collect(self, key):
        proof = self.proofs[key]
        out = self.fault(proof, self.last) if self.fault else proof
        self.last = proof
        return out

    def release(self):
        pass


@pytest.mark.parametrize("fault,expect", [(None, True), (_altered, False), (_half, False),
                                          (_stale, False)], ids=["none", "altered", "half", "stale"])
def test_a_fault_makes_correct_false(folders, canned, monkeypatch, fault, expect):
    from plonky2_ecdsa_tpu_torch import api
    root, cwd = folders
    stand_in = Canned(canned, fault)
    monkeypatch.setattr(api.EcdsaProverSystem, "prover", property(lambda self: stand_in))
    monkeypatch.chdir(cwd)
    res = run.execute(["--workload", CELL, "--seed", str(SEED), "--seconds", "1.5",
                       "--trace", "0"], device="cpu", root=str(root))
    assert res["run"]["batches"] >= 2
    assert res["correct"] is expect, res["checks"]
    if fault is _altered:
        assert res["checks"]["lanes_rejected"]["value"] >= 1
    if fault in (_half, _stale):
        assert res["checks"]["pis_unbound"]["value"] >= 1
