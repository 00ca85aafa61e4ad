#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

From the repository root, on a machine with one CUDA device:
  1. builds the port's CUDA kernels from plonky2_ecdsa_tpu_torch/csrc;
  2. holds each kernel against its plain torch version on the card, bit for
     bit, at the shapes of the main path, and times both;
  3. proves the small demo circuit (B=2) on the card and checks the proof
     against the reference's numpy proof, leaf for leaf;
  4. drives the main path: EcdsaProverSystem(SECP256K1) -> witness_vals for
     B=32 statements -> run_vals on the card -> the reference verifier; checks
     lane 0 exactly, rejects a tampered proof, checks lane 0's wires cap
     against the reference's numpy commitment, checks that every kernel was
     launched by the main path, and times steady-state batches.
Prints the card, the checks and the numbers, then a JSON line of the
kernels, and last {"ok": true, "device": {...}}.  Without a CUDA device, or
without the port beside it, it exits nonzero and prints no result.  JAX is
blocked for the whole run: the port must not need it.
"""

import sys

sys.modules["jax"] = None  # any import of JAX fails loudly

import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 32
SEED = 3
STEADY_BATCHES = 5


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps runs, after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> float:
    """Largest |a - b| over u64 values (0.0 when bit-identical)."""
    if torch.equal(a, b):
        return 0.0
    ua = a.cpu().numpy().view(np.uint64).astype(np.float64)
    ub = b.cpu().numpy().view(np.uint64).astype(np.float64)
    return float(np.abs(ua - ub).max()) or 1.0


def random_field(rng, shape, device):
    from plonky2_ecdsa_tpu_torch.fields import goldilocks as gl

    return gl.from_u64(rng.integers(0, gl.P, shape, dtype=np.uint64), device)


def check_kernels(dev, card):
    """Each kernel against its plain version at the main path's shapes."""
    from plonky2_ecdsa_tpu_torch.hash import poseidon, poseidon_cuda
    from plonky2_ecdsa_tpu_torch.prover import ntt, ntt_cuda

    rng = np.random.default_rng(SEED)
    rows = []

    # kernel 1: the wires leaf sponge's permutation at B=32, N=2^15
    x = random_field(rng, (12, 1 << 20), dev)
    k, p = poseidon_cuda.permute(x), poseidon.permute_plain(x)
    err = max_abs_err(k, p)
    ms = cuda_ms(lambda: poseidon_cuda.permute(x), 20)
    plain_ms = cuda_ms(lambda: poseidon.permute_plain(x), 2)
    print(f"poseidon2 permute [12, 2^20]: max_abs_err={err} (tolerance 0), kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms  ({card})")
    assert err == 0.0, "poseidon2 permute disagrees with the plain version"
    rows.append(dict(name="poseidon2_permute", route="cuda",
                     source="plonky2_ecdsa_tpu_torch/csrc/poseidon2.cu",
                     replaces="plonky2_ecdsa_tpu/hash/poseidon_pallas.py:118",
                     max_abs_err=err, ms=ms, plain_ms=plain_ms, fn=poseidon_cuda.permute))

    # kernel 2: the FRI grind, 32 distinct lanes at 16 bits, and exhaustion
    st = random_field(rng, (12, BATCH), dev)
    cap = 4096 << 15
    kw, kf = poseidon_cuda.grind(st, 16, cap)
    t0 = time.time()
    pw, pf = poseidon_cuda.grind_plain(st, 16, cap)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    err = max_abs_err(kw, pw)
    assert bool(kf.all()) and torch.equal(kf, pf) and err == 0.0, "grind disagrees"
    assert len(set(kw.tolist())) > 1, "grind lanes are not distinct"
    ew, ef = poseidon_cuda.grind(st, 32, 4)
    pew, pef = poseidon_cuda.grind_plain(st, 32, 4)
    assert not bool(ef.any()) and not bool(pef.any()) and torch.equal(ew, pew), \
        "grind exhaustion not reported"
    ms = cuda_ms(lambda: poseidon_cuda.grind(st, 16, cap), 5)
    print(f"poseidon2 grind B={BATCH} pow=16: witnesses {kw[:4].tolist()}... "
          f"max_abs_err={err} (tolerance 0), exhaustion found=False on all lanes; kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms  ({card})")
    rows.append(dict(name="poseidon2_grind", route="cuda",
                     source="plonky2_ecdsa_tpu_torch/csrc/poseidon2.cu",
                     replaces="plonky2_ecdsa_tpu/hash/poseidon_pallas.py:208",
                     max_abs_err=err, ms=ms, plain_ms=plain_ms, fn=poseidon_cuda.grind))

    # kernel 3: four-step transforms of the main path on [32, 8, n], plus the
    # single-pass transform of the FRI final polynomial
    n, N = 1 << 13, 1 << 15
    cases = []
    for size in (n, N):
        for inverse in (False, True):
            cases.append((f"ntt n={size} inverse={inverse}",
                          random_field(rng, (BATCH, 8, size), dev), size, inverse, None, None))
    cases.append(("coset LDE 2^13->2^15 (pre)", random_field(rng, (BATCH, 8, n), dev), N,
                  False, ntt.coset_powers(N, False, dev)[:n], None))
    cases.append(("coset INTT 2^15 (post)", random_field(rng, (BATCH, 8, N), dev), N,
                  True, None, ntt.coset_powers(N, True, dev)))
    errs = []
    for name, a, size, inverse, pre, post in cases:
        e = max_abs_err(ntt_cuda.four_step(a, size, inverse, pre, post),
                        ntt_cuda.four_step_plain(a, size, inverse, pre, post))
        errs.append(e)
        print(f"sub_ntt four-step {name} [{BATCH}, 8]: max_abs_err={e} (tolerance 0)")
    wires = random_field(rng, (BATCH, 128, n), dev)
    e = max_abs_err(ntt_cuda.four_step(wires, N, False, cases[4][4]),
                    ntt_cuda.four_step_plain(wires, N, False, cases[4][4]))
    errs.append(e)
    print(f"sub_ntt four-step coset LDE 2^13->2^15 (pre) [{BATCH}, 128] (the wires LDE): "
          f"max_abs_err={e} (tolerance 0)")
    del wires
    small = random_field(rng, (2 * BATCH, 512, 1), dev)
    e = max_abs_err(ntt_cuda.sub_ntt(small, 512, True), ntt_cuda.sub_ntt_plain(small, 512, True))
    errs.append(e)
    print(f"sub_ntt single pass n=512 [{2 * BATCH}]: max_abs_err={e} (tolerance 0)")
    err = max(errs)
    assert err == 0.0, "sub_ntt disagrees with the plain version"
    _, a, size, inverse, pre, _post = cases[4]
    ms = cuda_ms(lambda: ntt_cuda.four_step(a, size, inverse, pre), 20)
    plain_ms = cuda_ms(lambda: ntt_cuda.four_step_plain(a, size, inverse, pre), 3)
    print(f"sub_ntt coset LDE 2^13->2^15 [{BATCH}, 8] (two launches + transpose): "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms  ({card})")
    rows.append(dict(name="sub_ntt", route="cuda", source="plonky2_ecdsa_tpu_torch/csrc/ntt.cu",
                     replaces="plonky2_ecdsa_tpu/prover/ntt_pallas.py:181",
                     max_abs_err=err, ms=ms, plain_ms=plain_ms, fn=ntt_cuda.sub_ntt))
    return rows


def check_demo(dev):
    """Demo circuit at B=2: the port's proof equals the reference's."""
    from plonky2_ecdsa_tpu_torch import api, oracle
    from plonky2_ecdsa_tpu_torch.prover import prover

    data, W, pis = oracle.demo(2)
    ref = oracle.numpy_prove(data, W, pis)
    got = prover.prove(data, W, pis, dev)
    diff = prover.first_difference(ref, got)
    print(f"demo proof B=2 on {dev}: first differing leaf vs reference = {diff}")
    assert diff is None, f"demo proof differs from the reference at {diff}"
    assert api.verify(data, got), "demo proof rejected"


def main_path(dev, card, rows):
    from plonky2_ecdsa_tpu_torch import api, oracle
    from plonky2_ecdsa_tpu_torch.prover import prover

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    system = api.EcdsaProverSystem(api.SECP256K1, device=dev)
    build_s = time.time() - t0
    t0 = time.time()
    data = system.data
    data_s = time.time() - t0
    t0 = time.time()
    run = system.prover
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    stmts = api.random_statements(api.SECP256K1, BATCH, seed=SEED)
    t0 = time.time()
    vals, pis = system.witness_vals(stmts)
    witness_s = time.time() - t0
    print(f"secp256k1: n={data.n} N={data.N}; circuit build {build_s:.1f} s, host data "
          f"{data_s:.1f} s, device set-up {setup_s:.1f} s, witness B={BATCH} {witness_s:.1f} s  "
          f"({card})")

    for r in rows:
        r["fn"].launches = 0
    t0 = time.time()
    proof = run.run_vals(vals, pis)
    first_s = time.time() - t0
    for r in rows:
        r["launches"] = r.pop("fn").launches
    print("main path kernel launches: " + ", ".join(f"{r['name']}={r['launches']}" for r in rows))
    assert all(r["launches"] > 0 for r in rows), "a kernel of the main path was not launched"

    t0 = time.time()
    assert api.verify(data, proof), "B=32 proof rejected by the reference verifier"
    verify_s = time.time() - t0
    assert api.verify_one_exact(data, proof, 0), "lane 0 fails the exact verifier"
    assert all(system.verify_statement(proof, i, stmts[i]) for i in (0, BATCH - 1))
    bad = prover.Proof(**{**proof.__dict__, "pis": proof.pis.copy()})
    bad.pis[0, 0] ^= np.uint64(1)
    assert not api.verify(data, bad), "tampered proof accepted"
    print(f"B={BATCH} proof: verify True ({verify_s:.1f} s), verify_one_exact lane 0 True, "
          "statements bound, flipped pis bit rejected")

    ref_cap = oracle.numpy_wires_cap(system, stmts[:1])[0]
    got_cap = proof.wires_cap[0][0].astype(np.uint64) | (
        proof.wires_cap[1][0].astype(np.uint64) << np.uint64(32))
    assert np.array_equal(ref_cap, got_cap), "lane 0 wires cap differs from the reference"
    print("lane 0 wires cap equals the reference numpy commitment at B=1")

    t0 = time.time()
    again = [run.run_vals(vals, pis) for _ in range(STEADY_BATCHES)]
    steady_s = (time.time() - t0) / STEADY_BATCHES
    assert all(prover.first_difference(proof, p) is None for p in again), \
        "proving is not deterministic"
    print(f"first prove {first_s:.2f} s; steady state {steady_s:.2f} s/batch = "
          f"{BATCH / steady_s:.2f} proofs/s at B={BATCH} over {STEADY_BATCHES} batches; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB  ({card})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    os.environ.setdefault("PLONKY2_TPU_NATIVE_DIR",
                          os.path.join(ROOT, "plonky2_ecdsa_tpu_torch", "build"))
    from plonky2_ecdsa_tpu_torch import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    t0 = time.time()
    _build.library()
    print(f"kernels built and loaded in {time.time() - t0:.1f} s: {_build.library_path()}")

    rows = check_kernels(dev, card)
    check_demo(dev)
    main_path(dev, card, rows)
    assert "jax" not in sys.modules or sys.modules["jax"] is None
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
