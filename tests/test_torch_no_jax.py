"""The port stands alone: it builds, proves and verifies the demo circuit in
a process where importing JAX or the reference package fails, and no source
file of the package, nor chip_smoke.py, imports either."""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "plonky2_ecdsa_tpu_torch")
BLOCKED = ("jax", "plonky2_ecdsa_tpu")

_DEMO = """
import sys
sys.modules["jax"] = None
sys.modules["plonky2_ecdsa_tpu"] = None
from plonky2_ecdsa_tpu_torch.circuit.examples import small_demo_circuit, small_demo_witness
from plonky2_ecdsa_tpu_torch.prover import prover, verifier
from plonky2_ecdsa_tpu_torch.prover.data import build_circuit_data
circuit = small_demo_circuit().build()
data = build_circuit_data(circuit, "cpu")
W, pis = small_demo_witness(circuit, 2)
assert circuit.last_tape_native
proof = prover.prove(data, W, pis)
assert verifier.verify(data, proof)
assert verifier.verify_one_exact(data, proof, 1)
proof.pis = proof.pis.copy()
proof.pis[0, 0] ^= 1
assert not verifier.verify(data, proof)
assert sys.modules["jax"] is None and sys.modules["plonky2_ecdsa_tpu"] is None
assert not [m for m in sys.modules if m.startswith(("jax.", "plonky2_ecdsa_tpu."))]
print("standalone demo ok")
"""


def test_demo_proof_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", _DEMO], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "standalone demo ok" in res.stdout


def _imported_modules(path):
    """Every module a file imports: import statements anywhere in it (also
    inside functions), and importlib.import_module / __import__ calls on a
    literal name."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", "")) in
              ("import_module", "__import__")):
            yield node.args[0].value


def _sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _dirs, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    return files


def test_no_source_file_imports_jax():
    for path in _sources():
        for mod in _imported_modules(path):
            assert mod.split(".")[0] != "jax", f"{path} imports {mod}"


def test_no_source_file_imports_the_reference_package():
    for path in _sources():
        for mod in _imported_modules(path):
            assert mod.split(".")[0] != "plonky2_ecdsa_tpu", f"{path} imports {mod}"


def test_import_scan_sees_every_form(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import os\n"
                     "def f():\n"
                     "    from plonky2_ecdsa_tpu.prover import fri\n"
                     "    import jax.numpy as jnp\n"
                     "    import importlib\n"
                     "    importlib.import_module('plonky2_ecdsa_tpu.api')\n"
                     "    from . import plonky2_ecdsa_tpu\n"
                     "    import plonky2_ecdsa_tpu_torch\n")
    found = list(_imported_modules(str(probe)))
    assert sorted(m for m in found if m.split(".")[0] in BLOCKED) == \
        ["jax.numpy", "plonky2_ecdsa_tpu.api", "plonky2_ecdsa_tpu.prover"]
    assert "plonky2_ecdsa_tpu_torch" in found


_RECURSION = """
import sys
sys.modules["jax"] = None
sys.modules["plonky2_ecdsa_tpu"] = None
from plonky2_ecdsa_tpu_torch.circuit import (challenger_circuit, poseidon_gate, recursion,
                                             recursive_verifier)
from plonky2_ecdsa_tpu_torch.circuit.builder import CircuitBuilder
from plonky2_ecdsa_tpu_torch.circuit.config import CircuitConfig
b = CircuitBuilder(CircuitConfig.standard_recursion_config())
ins = b.add_virtual_targets(12)
b.register_input("state", ins)
b.register_public_inputs(poseidon_gate.poseidon_permute(b, ins))
c = b.build()
c.generate_witness({"state": [list(range(12))]}, 1)
assert c.last_tape_native and c._native_tape().n_native == 1
assert not [m for m in sys.modules if m.startswith(("jax.", "plonky2_ecdsa_tpu."))]
print("recursion modules ok")
"""


def test_recursion_modules_import_with_jax_blocked():
    """The four recursion modules import, and a PoseidonGate row fills through
    the native tape, in a process where JAX and the reference are blocked."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", _RECURSION], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "recursion modules ok" in res.stdout


def test_scan_covers_the_recursion_modules():
    names = {os.path.relpath(p, PKG) for p in _sources()}
    for mod in ("recursion", "poseidon_gate", "challenger_circuit", "recursive_verifier"):
        assert os.path.join("circuit", f"{mod}.py") in names, mod


_MESH = """
import inspect, sys
sys.modules["jax"] = None
sys.modules["plonky2_ecdsa_tpu"] = None
from plonky2_ecdsa_tpu_torch.fields import limbs
from plonky2_ecdsa_tpu_torch.parallel import mesh
from plonky2_ecdsa_tpu_torch.prover import prover
from plonky2_ecdsa_tpu_torch.utils import debug
params = inspect.signature(prover.prove_core).parameters
assert "stream_commit" not in params and params["shard"].default is None
try:
    mesh.prover_mesh(device_type="cpu")
except RuntimeError as e:
    assert "process group" in str(e)
else:
    raise AssertionError("a mesh without a process group")
assert not [m for m in sys.modules if m.startswith(("jax.", "plonky2_ecdsa_tpu."))]
print("mesh modules ok")
"""


def test_mesh_stream_and_tensor_modules_import_with_jax_blocked():
    """parallel/mesh.py, prove_core's shard (and its one commit path: no
    stream_commit), the tensor sanitizer and the tensor limbs import where
    JAX and the reference are blocked; the mesh refuses to run without a
    process group."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", _MESH], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "mesh modules ok" in res.stdout


def test_scan_covers_the_mesh_module():
    names = {os.path.relpath(p, PKG) for p in _sources()}
    assert os.path.join("parallel", "mesh.py") in names
    assert os.path.join("parallel", "__init__.py") in names
