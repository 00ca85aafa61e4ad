"""The port's command line (python -m plonky2_ecdsa_tpu_torch) through
main([...]) on --device cpu: the reference's subcommands and statement format,
less --jit, plus --device; exit codes of verify on a small proof; and (slow)
the whole sign -> build -> prove -> verify round on the secp256k1 circuit."""

import json

import numpy as np
import pytest

from plonky2_ecdsa_tpu import api as ref_api
from plonky2_ecdsa_tpu.__main__ import main as ref_main
from plonky2_ecdsa_tpu.curve import native as ref_cn
from plonky2_ecdsa_tpu_torch import api
from plonky2_ecdsa_tpu_torch.__main__ import _load_statements, main
from plonky2_ecdsa_tpu_torch.circuit.examples import small_demo_circuit, small_demo_witness
from plonky2_ecdsa_tpu_torch.prover import prover
from plonky2_ecdsa_tpu_torch.prover.data import build_circuit_data
from plonky2_ecdsa_tpu_torch.prover.serialize import (load_circuit_data, load_proof,
                                                      save_circuit_data, save_proof)


def _exit_code(argv) -> int:
    with pytest.raises(SystemExit) as e:
        main(argv)
    return e.value.code


@pytest.mark.parametrize("curve", ["secp256k1", "p256"])
def test_sign_writes_the_references_statements(curve, tmp_path):
    out, ref_out = tmp_path / "stmts.json", tmp_path / "ref.json"
    main(["sign", "--curve", curve, "--count", "3", "--seed", "7", "--out", str(out),
          "--device", "cpu"])
    ref_main(["sign", "--curve", curve, "--count", "3", "--seed", "7", "--out", str(ref_out)])
    assert out.read_text() == ref_out.read_text()
    rows = json.loads(out.read_text())
    assert len(rows) == 3 and sorted(rows[0]) == ["msg", "pk_x", "pk_y", "r", "s"]
    stmts = _load_statements(str(out), api.CURVES[curve])
    want = api.random_statements(api.CURVES[curve], 3, seed=7)
    assert [(s.msg, s.r, s.s, s.pk.x, s.pk.y) for s in stmts] == \
        [(s.msg, s.r, s.s, s.pk.x, s.pk.y) for s in want]


def test_gates_p256_prints_the_references_circuit(capsys):
    main(["gates", "--curve", "p256", "--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    ref_sys = ref_api.EcdsaProverSystem(ref_cn.P256)
    assert got == {"curve": "p256", "config": "standard", "rows": ref_sys.num_rows,
                   "n": 8192, "gate_rows": ref_sys.gate_counts()}


@pytest.mark.parametrize("argv", [
    [],                                                       # no subcommand
    ["sign", "--count", "2"],                                 # --out is required
    ["sign", "--curve", "ed25519", "--out", "x.json"],        # unknown curve
    ["gates", "--config", "narrow"],                          # unknown config
    ["prove", "--proof", "p.npz", "--jit"],                   # the port has one prove path
    ["verify", "--data", "d.npz"],                            # --proof is required
    ["frobnicate"],
])
def test_argument_errors_exit_2(argv, capsys):
    assert _exit_code(argv) == 2
    assert "usage:" in capsys.readouterr().err


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """Saved circuit data and a saved proof of the demo circuit."""
    d = tmp_path_factory.mktemp("cli")
    c = small_demo_circuit().build()
    data = build_circuit_data(c, "cpu")
    proof = prover.prove(data, *small_demo_witness(c, 2))
    save_circuit_data(data, str(d / "demo.npz"))
    save_proof(proof, str(d / "proof.npz"))
    return d, proof


def test_verify_exit_codes_on_a_small_proof(small, capsys, tmp_path):
    d, proof = small
    argv = ["verify", "--device", "cpu", "--data", str(d / "demo.npz"), "--proof"]
    assert _exit_code(argv + [str(d / "proof.npz")]) == 0
    assert json.loads(capsys.readouterr().out) == {"verified": True}
    proof.pis = proof.pis.copy()
    proof.pis[1, 0] ^= np.uint64(1)
    save_proof(proof, str(tmp_path / "bad.npz"))
    assert _exit_code(argv + [str(tmp_path / "bad.npz")]) == 1
    assert json.loads(capsys.readouterr().out) == {"verified": False}


def test_verify_refuses_statements_the_proof_does_not_bind(small, capsys, tmp_path):
    """A valid proof whose public inputs are not the given statements' exits 1
    and names the lanes; more statements than lanes are unbound too."""
    d, _proof = small
    stmts = tmp_path / "stmts.json"
    main(["sign", "--count", "3", "--out", str(stmts), "--device", "cpu"])
    capsys.readouterr()
    code = _exit_code(["verify", "--device", "cpu", "--data", str(d / "demo.npz"),
                       "--proof", str(d / "proof.npz"), "--statements", str(stmts)])
    out, err = capsys.readouterr()
    assert code == 1 and json.loads(out) == {"verified": False}
    assert all(f"lane {i}: public inputs do NOT bind the statement" in err for i in range(3))


@pytest.mark.slow
def test_sign_build_prove_verify_round_on_the_cpu(tmp_path, capsys):
    """The full secp256k1 circuit, one statement: prove verifies before it
    writes; verify exits 0 on the statements proved and 1 with one bit of one
    statement changed; the saved data proves to the same digest."""
    stmts, data, proof = (str(tmp_path / n) for n in ("stmts.json", "circuit.npz", "proof.npz"))
    common = ["--curve", "secp256k1", "--device", "cpu"]
    main(["sign", *common, "--count", "1", "--seed", "3", "--out", stmts])
    main(["build", *common, "--data", data])
    main(["prove", *common, "--statements", stmts, "--proof", proof])
    assert _exit_code(["verify", *common, "--proof", proof, "--data", data,
                       "--statements", stmts]) == 0
    rows = json.loads(open(stmts).read())
    rows[0]["msg"] = f"{int(rows[0]['msg'], 16) ^ 1:x}"
    with open(stmts, "w") as f:
        json.dump(rows, f)
    capsys.readouterr()
    assert _exit_code(["verify", *common, "--proof", proof, "--data", data,
                       "--statements", stmts]) == 1
    assert "lane 0" in capsys.readouterr().err
    system = api.EcdsaProverSystem(api.SECP256K1, device="cpu")
    vals, pis = system.witness_vals(api.random_statements(api.SECP256K1, 1, seed=3))
    again = prover.Prover(load_circuit_data(data, "cpu")).run_vals(vals, pis)
    assert prover.proof_digest(again) == prover.proof_digest(load_proof(proof))
