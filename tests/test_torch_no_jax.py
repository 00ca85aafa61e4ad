"""The port never needs JAX: it proves (and the reference verifier checks)
the demo circuit in a process where importing JAX fails, and no source
file of the package, nor chip_smoke.py, imports it."""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "plonky2_ecdsa_tpu_torch")

_DEMO = """
import sys
sys.modules["jax"] = None
from plonky2_ecdsa_tpu.prover.prover import prove as ref_prove
from plonky2_ecdsa_tpu_torch import api, oracle
from plonky2_ecdsa_tpu_torch.prover import prover
data, W, pis = oracle.demo(2)
proof = prover.prove(data, W, pis, "cpu")
assert api.verify(data, proof)
assert prover.first_difference(ref_prove(data, W, pis), proof) is None
assert sys.modules["jax"] is None
print("no-jax demo ok")
"""


def test_demo_proof_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", _DEMO], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "no-jax demo ok" in res.stdout


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_source_file_imports_jax():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _dirs, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            assert mod != "jax" and not mod.startswith("jax."), f"{path} imports {mod}"
