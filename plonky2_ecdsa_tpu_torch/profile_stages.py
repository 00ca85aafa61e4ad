"""Stage breakdown of the port's main path on one CUDA device.

    python3 -m plonky2_ecdsa_tpu_torch.profile_stages [secp256k1|p256|recursive] [--out FILE]

From the repository root.  Builds EcdsaProverSystem(curve), makes the
witness of B=32 statements (seed 3, as chip_smoke.py), proves once to warm
up, then times, three times each on the host clock around synchronised
calls: the device expand of the value table, prove_core cut at each
stop_after stage (cumulative), the whole prove_core and a whole run_vals
(upload, expand, prove, readback).  Last it traces one run_vals with
torch.profiler and reports the summed kernel time, its share of the traced
wall time, the kernels that take the most of it, and the time and launches
of each of the package's hand-written kernels.  Prints the card's name
and power limit first; writes every number as JSON to --out.

``recursive`` does the same for the outer proof of the recursion path
(bench.py's bench_recursive): B=8 secp256k1 proofs (seed 11) verified by the
verifier circuit under recursion_ecc_config (outer n = 2^14, N = 2^17).
Before the stage table it times the outer circuit's build, its fixed commit
and its witness through the native tape, and the tape again op by op, summed
by op label (each op timed alone, so the sum exceeds the untimed run by the
timer's own cost).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

BATCH = 32
REC_BATCH, REC_SEED = 8, 11
REPS = 3
STAGES = ("commit", "challenges", "zs_vals", "zs", "quotient", "openings", "fri_all")


def _sync_time(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


OWN_KERNELS = ("permute_kernel", "sponge_kernel", "grind_kernel", "sub_ntt_kernel")


def _kernel_table(prof, top: int):
    """(summed kernel ms, [(name, ms, calls)] of the `top` largest kernels,
    {own kernel: (ms, calls)} summed over the instantiations of each of the
    package's hand-written kernels)."""
    from torch.autograd import DeviceType

    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in kernels),
                  key=lambda r: -r[1])
    own = {k: (sum(r[1] for r in rows if k in r[0]), sum(r[2] for r in rows if k in r[0]))
           for k in OWN_KERNELS}
    return sum(r[1] for r in rows), rows[:top], own


def tape_seconds_by_label(circuit, inputs: dict, batch: int) -> dict:
    """{label: (seconds, ops)} over one run of the circuit's native tape, each
    op timed on the host clock."""
    nt = circuit._native_tape()
    spent, count = collections.defaultdict(float), collections.Counter()

    def timed(call, label):
        def run(*args):
            t0 = time.perf_counter()
            out = call(*args)
            spent[label] += time.perf_counter() - t0
            count[label] += 1
            return out
        return run

    saved = nt.steps
    nt.steps = [(native, (timed(p[0], op.label), p[1]) if native else timed(p, op.label))
                for (native, p), op in zip(saved, circuit.tape)]
    try:
        circuit.value_table(inputs, batch)
    finally:
        nt.steps = saved
    return {label: (spent[label], count[label]) for label in sorted(spent, key=lambda k: -spent[k])}


def recursive_setup(timings: dict):
    """The recursion path's outer circuit, value table and PIs, with the
    set-up times in `timings` (seconds)."""
    from plonky2_ecdsa_tpu_torch import api
    from plonky2_ecdsa_tpu_torch.circuit import recursive_verifier as rv
    from plonky2_ecdsa_tpu_torch.circuit.config import CircuitConfig
    from plonky2_ecdsa_tpu_torch.prover.data import build_circuit_data

    system = api.EcdsaProverSystem(api.SECP256K1, device="cuda")
    iproof = system.prove(api.random_statements(api.SECP256K1, REC_BATCH, seed=REC_SEED))
    t0 = time.perf_counter()
    oc = rv.verifier_circuit(system.data, CircuitConfig.recursion_ecc_config())
    timings["outer_build_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    odata = build_circuit_data(oc, "cuda")
    torch.cuda.synchronize()
    timings["outer_fixed_commit_s"] = time.perf_counter() - t0
    inputs = rv.recursive_verifier_inputs(system.data, iproof)
    for key in ("outer_witness_s", "outer_witness_again_s"):   # the first prepares the tape
        t0 = time.perf_counter()
        vals = oc.value_table(inputs, REC_BATCH)
        timings[key] = time.perf_counter() - t0
    timings["outer_tape_by_label"] = tape_seconds_by_label(oc, inputs, REC_BATCH)
    return odata, vals, oc.public_input_values()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("curve", nargs="?", default="secp256k1",
                    choices=["secp256k1", "p256", "recursive"])
    ap.add_argument("--out", default="stages_b32.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_stages: no CUDA device", file=sys.stderr)
        return 1
    from plonky2_ecdsa_tpu_torch import api
    from plonky2_ecdsa_tpu_torch.fields import goldilocks as gl
    from plonky2_ecdsa_tpu_torch.prover import prover

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"{card}; {args.curve}", flush=True)
    setup = {}
    if args.curve == "recursive":
        data, vals, pis = recursive_setup(setup)
        run, batch = prover.Prover(data), REC_BATCH
        for name, v in setup.items():
            if name == "outer_tape_by_label":
                for label, (sec, ops) in v.items():
                    print(f"  outer tape, op label {label}: {sec:.3f} s in {ops} ops", flush=True)
            else:
                print(f"{name}: {v:.3f}", flush=True)
    else:
        curve = api.CURVES[args.curve]
        system = api.EcdsaProverSystem(curve, device="cuda")
        data, run, batch = system.data, system.prover, BATCH
        vals, pis = system.witness_vals(api.random_statements(curve, BATCH, seed=3))
    vn, vw = run._vals_split(vals)

    def inputs():
        narrow = torch.from_numpy(vn.view(np.int32)).to(run.device)
        return run._expand(narrow, gl.from_u64(vw, run.device))

    run.run_vals(vals, pis)
    cases = [("expand", inputs)]
    cases += [(s, lambda s=s: prover.prove_core(data, run.backend, *inputs(), stop_after=s))
              for s in STAGES]
    cases += [("prove_core", lambda: prover.prove_core(data, run.backend, *inputs())),
              ("run_vals", lambda: run.run_vals(vals, pis))]
    stages = {}
    for name, fn in cases:
        stages[name] = [_sync_time(fn) * 1e3 for _ in range(REPS)]
        print(f"cumulative to {name}: {stages[name]} ms", flush=True)

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_ms = _sync_time(lambda: run.run_vals(vals, pis)) * 1e3
    kernel_ms, top, own = _kernel_table(prof, 15)
    print(f"traced run_vals: wall {wall_ms} ms, summed kernel time {kernel_ms} ms, "
          f"busy share {kernel_ms / wall_ms}  ({card})")
    for name, ms, calls in top:
        print(f"  {ms:10.3f} ms  {100 * ms / kernel_ms:5.1f}%  {calls:6d} calls  {name[:90]}")
    for name, (ms, calls) in own.items():
        print(f"  the package's {name}: {ms:.3f} ms in {calls} launches")
    result = dict(card=card, curve=args.curve, batch=batch, setup=setup, stages_ms=stages,
                  traced_wall_ms=wall_ms,
                  traced_kernel_ms=kernel_ms,
                  own_kernels={k: dict(ms=ms, calls=c) for k, (ms, c) in own.items()},
                  top_kernels=[dict(name=n, ms=ms, calls=c) for n, ms, c in top])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
