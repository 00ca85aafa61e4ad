"""Command line: sign / build / gates / prove / verify.

Counterpart of ``python -m plonky2_ecdsa_tpu``, around api.EcdsaProverSystem
and prover.serialize:

    python -m plonky2_ecdsa_tpu_torch sign   --curve secp256k1 --count 4 --out stmts.json
    python -m plonky2_ecdsa_tpu_torch build  --curve secp256k1 --data circuit.npz
    python -m plonky2_ecdsa_tpu_torch prove  --curve p256 --statements stmts.json \\
        --proof proof.npz
    python -m plonky2_ecdsa_tpu_torch verify --curve p256 --proof proof.npz \\
        [--statements stmts.json] [--data circuit.npz]
    python -m plonky2_ecdsa_tpu_torch gates  --curve p256 --device cpu

Every subcommand takes --curve secp256k1|p256, --config standard|wide and
--device (default cuda: the fixed commit, the prover and the verifier run
there).  Statements are JSON: [{"msg": hex, "r": hex, "s": hex, "pk_x": hex,
"pk_y": hex}, ...], the tuple a proof lane binds as its public inputs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from . import api
from .circuit.config import CircuitConfig
from .curve import native as cn
from .prover.serialize import load_circuit_data, load_proof, save_circuit_data, save_proof
from .prover.verifier import verify

# "standard" is standard_ecc_config for either curve, as the reference's command
# line has it (the API's default for P-256 is p256_ecc_config)
CONFIGS = {"standard": CircuitConfig.standard_ecc_config, "wide": CircuitConfig.wide_ecc_config}


def _load_statements(path: str, curve) -> list:
    with open(path) as f:
        rows = json.load(f)
    return [api.EcdsaStatement(
        msg=int(r["msg"], 16), r=int(r["r"], 16), s=int(r["s"], 16),
        pk=cn.Point(curve, int(r["pk_x"], 16), int(r["pk_y"], 16))) for r in rows]


def _dump_statements(stmts, path: str):
    rows = [{"msg": f"{st.msg:x}", "r": f"{st.r:x}", "s": f"{st.s:x}",
             "pk_x": f"{st.pk.x:x}", "pk_y": f"{st.pk.y:x}"} for st in stmts]
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)


def _system(args) -> api.EcdsaProverSystem:
    t0 = time.time()
    system = api.EcdsaProverSystem(api.CURVES[args.curve], CONFIGS[args.config](),
                                   device=args.device)
    print(f"[cli] built {args.curve} circuit: n={system.n} ({time.time() - t0:.1f}s)",
          file=sys.stderr)
    return system


def cmd_sign(args):
    stmts = api.random_statements(api.CURVES[args.curve], args.count, seed=args.seed)
    _dump_statements(stmts, args.out)
    print(f"[cli] wrote {args.count} signed statements -> {args.out}", file=sys.stderr)


def cmd_build(args):
    save_circuit_data(_system(args).data, args.data)
    print(f"[cli] circuit data -> {args.data}", file=sys.stderr)


def cmd_gates(args):
    system = _system(args)
    print(json.dumps({"curve": args.curve, "config": args.config, "rows": system.num_rows,
                      "n": system.n, "gate_rows": system.gate_counts()}, indent=1))


def cmd_prove(args):
    system = _system(args)
    if args.statements:
        stmts = _load_statements(args.statements, system.curve)
    else:
        stmts = api.random_statements(system.curve, args.batch, seed=args.seed)
        print(f"[cli] no --statements given; proving {args.batch} random signed statements "
              f"(seed {args.seed})", file=sys.stderr)
    t0 = time.time()
    proof = system.prove(stmts)
    dt = time.time() - t0
    if not system.verify(proof):
        raise SystemExit("[cli] the freshly produced proof failed verification; nothing written")
    save_proof(proof, args.proof)
    print(f"[cli] proved {len(stmts)} statements in {dt:.2f}s ({len(stmts) / dt:.2f} proofs/s "
          f"with witness and set-up) -> {args.proof}", file=sys.stderr)


def cmd_verify(args):
    data = load_circuit_data(args.data, args.device) if args.data else _system(args).data
    proof = load_proof(args.proof)
    ok = verify(data, proof)
    if ok and args.statements:
        for i, st in enumerate(_load_statements(args.statements, api.CURVES[args.curve])):
            if i >= len(proof.pis) or not np.array_equal(proof.pis[i], api.statement_pis(st)):
                print(f"[cli] lane {i}: public inputs do NOT bind the statement", file=sys.stderr)
                ok = False
    print(json.dumps({"verified": bool(ok)}))
    raise SystemExit(0 if ok else 1)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="plonky2_ecdsa_tpu_torch",
                                 description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--curve", default="secp256k1", choices=sorted(api.CURVES))
        p.add_argument("--config", default="standard", choices=sorted(CONFIGS))
        p.add_argument("--device", default="cuda", help="torch device (default: cuda)")

    p = sub.add_parser("sign", help="generate random signed statements (native signer)")
    common(p)
    p.add_argument("--count", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_sign)

    p = sub.add_parser("build", help="build and persist the circuit data (.npz)")
    common(p)
    p.add_argument("--data", required=True)
    p.set_defaults(fn=cmd_build)

    p = sub.add_parser("gates", help="print the circuit's size and rows per gate")
    common(p)
    p.set_defaults(fn=cmd_gates)

    p = sub.add_parser("prove", help="prove a statement batch -> proof file")
    common(p)
    p.add_argument("--statements", help="JSON from `sign` (default: a random batch)")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--proof", required=True)
    p.set_defaults(fn=cmd_prove)

    p = sub.add_parser("verify", help="verify a proof file (and that it binds statements)")
    common(p)
    p.add_argument("--proof", required=True)
    p.add_argument("--data", help="circuit data .npz (skips the rebuild)")
    p.add_argument("--statements", help="check that the lanes bind these statements")
    p.set_defaults(fn=cmd_verify)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
