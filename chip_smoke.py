#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

From the repository root, on a machine with one CUDA device:
  1. builds the port's CUDA kernels from plonky2_ecdsa_tpu_torch/csrc (and,
     beside them, the C++ witness library and the count-only cubin);
  2. runs the kernels' field primitives (lazy multiply, 96-bit layer sums,
     folds, the final canonicalisation) on directed edge operands and random
     ones against Python integers; then holds each kernel against its plain
     torch version on the card, bit for
     bit, at the shapes of the main path, times both, and works out the least
     time the card could take for the same work (its bound: the bytes, or the
     integer operations the arithmetic needs whatever the code) and, beside
     it, the issue slots that this code's own instruction count fills;
  3. proves the small demo circuit (B=2) on the card and checks the proof
     leaf for leaf against the port's own proof on the CPU (plain kernels),
     and its digest against the value frozen from the reference;
  4. drives the main path: EcdsaProverSystem(SECP256K1) -> fixed commit on
     the card -> witness_vals for B=32 statements (native tape) -> run_vals on
     the card -> the port's verifier on the card; checks lane 0 exactly,
     requires a VerifyError for a tampered proof, checks the fixed cap, lane 0's wires cap and
     lane 0's whole proof against the values frozen from the reference,
     checks that every kernel was launched by the main path, and times
     steady-state batches.
Prints the card, the checks and the numbers, then a JSON line of the
kernels, and last {"ok": true, "device": {...}}.  Without a CUDA device, or
without the port beside it, it exits nonzero and prints no result.  JAX and
the reference package are blocked for the whole run: the port stands alone.
No failure is caught and nothing carries on on the CPU.
"""

import sys

sys.modules["jax"] = None                 # any import of JAX fails loudly
sys.modules["plonky2_ecdsa_tpu"] = None   # ... and of the reference package

import concurrent.futures  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 32
SEED = 3
STEADY_BATCHES = 5
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
SCHED_LANES_PER_CLK_SM = 128   # 4 schedulers x one 32-thread instruction per clock

# The least 32-bit integer instructions the arithmetic needs, however a kernel
# is written (an estimate argued from the arithmetic, not a proof):
#   a modular multiply: 4 multiply-adds 32x32->64 for the 128-bit product, 4
#   adds with carry to join them, 8 adds and compares to fold 128 bits below p;
#   a 64-bit add or subtract, reduction left to the next multiply: 2.
MUL_OPS, ADD_OPS = 16, 2
EXT_LAYER_ADDS = 3 * 12 + 4 * 2 + 12        # M4 on three groups, column sums, spread
INT_LAYER_OPS = 11 * ADD_OPS + 12 * (2 + ADD_OPS)   # sum; small diagonal multiply-add, add
SBOXES = 8 * 12 + 22                        # x^7 is 4 multiplies; one constant add each
PERMUTE_OPS = (SBOXES * (4 * MUL_OPS + ADD_OPS) + 9 * EXT_LAYER_ADDS * ADD_OPS
               + 22 * INT_LAYER_OPS)
# a grind candidate: first layer linear in the candidate (12 multiply-adds and
# adds), and of the last layer only word 7 (18 adds)
GRIND_OPS = PERMUTE_OPS - 2 * EXT_LAYER_ADDS * ADD_OPS + 12 * (2 + ADD_OPS) + 18 * ADD_OPS
BUTTERFLY_OPS = MUL_OPS + 2 * ADD_OPS


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


class Card:
    """The card's name and power limit (as nvidia-smi prints them), its SM
    count and top SM clock, and the rates the bounds are reckoned with."""

    def __init__(self):
        def smi(query):
            return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                                  capture_output=True, text=True,
                                  check=True).stdout.strip().splitlines()[0]

        self.line = smi("name,power.limit")
        self.clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count
        self.instr_per_s = self.sms * SCHED_LANES_PER_CLK_SM * self.clock_hz

    def issue_ms(self, instrs: float) -> float:
        """Time to issue `instrs` thread-instructions at the card's issue rate."""
        return instrs / self.instr_per_s * 1e3

    def bound(self, nbytes: float, ops: float):
        """(bound_ms, bound_by): the larger of bytes over the memory rate and
        the needed integer operations over the card's issue rate."""
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = self.issue_ms(ops)
        return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def sass_instruction_counts() -> dict:
    """{kernel: SASS instruction count} of csrc/count/opcount.cu, compiled to
    a cubin that is never run; its kernels have no loops, so the count is what
    one thread executes."""
    from plonky2_ecdsa_tpu_torch import _build

    src = os.path.join(_build.CSRC, "count", "opcount.cu")
    os.makedirs(_build.BUILD, exist_ok=True)
    cubin = os.path.join(_build.BUILD, f"opcount.{os.getpid()}.cubin")
    _build.run_all([[_build.nvcc(), *_build.ARCH_FLAGS, "-cubin", "-o", cubin, src]])
    dump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([dump, "-sass", cubin], capture_output=True, text=True, check=True).stdout
    os.remove(cubin)
    names = ("permute_unrolled", "grind_candidate", "probe_base", "probe_mul", "probe_mul_lazy",
             "probe_butterfly")
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if m.group(1) in names else None
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[name] = counts.get(name, 0) + 1
    assert set(counts) == set(names), f"count-only kernels missing from the SASS: {counts}"
    return counts


def check_field(dev):
    """The kernels' field primitives against Python integers, tolerance 0:
    every pair of the directed edge operands and 2^16 random pairs."""
    from plonky2_ecdsa_tpu_torch.fields import goldilocks as gl
    from plonky2_ecdsa_tpu_torch.hash import poseidon_cuda
    import field_check_vectors

    a, b = field_check_vectors.operands(1 << 16, SEED)
    got = gl.to_u64(poseidon_cuda.field_check(gl.from_u64(a, dev), gl.from_u64(b, dev)))
    torch.cuda.synchronize()
    wrong = 0
    for i, (x, y) in enumerate(zip(a.tolist(), b.tolist())):
        lazy, exact = field_check_vectors.expected(x, y)
        col = got[:, i].tolist()
        want = lazy + exact
        have = [v % gl.P for v in col[:len(lazy)]] + col[len(lazy):]
        if have != want:
            wrong += 1
            if wrong <= 3:
                print(f"field check: operands {x:#x}, {y:#x}: rows "
                      f"{[r for r in range(len(want)) if have[r] != want[r]]} differ: kernel "
                      f"{[hex(v) for v in col]}, expected {[hex(v) for v in want]}")
    directed = len(a) - (1 << 16)
    print(f"field check: mul_lazy, sqr_lazy, fold96, add_lazy, sub_lazy (modulo p), canon, "
          f"mad96, quad96, mul (exact) on {directed} directed pairs and {1 << 16} random pairs "
          f"against Python integers: {wrong} pairs wrong (tolerance 0)")
    assert wrong == 0, "the kernels' field arithmetic is wrong"


def check_kernels(dev, card, sass):
    """Each kernel against its plain version at the main path's shapes."""
    from plonky2_ecdsa_tpu_torch.hash import poseidon, poseidon_cuda
    from plonky2_ecdsa_tpu_torch.prover import ntt, ntt_cuda

    rng = np.random.default_rng(SEED)
    rows = []
    per_perm, per_cand = sass["permute_unrolled"], sass["grind_candidate"]
    per_mul = sass["probe_mul"] - sass["probe_base"]
    per_butterfly = sass["probe_butterfly"] - sass["probe_base"]
    print(f"integer instructions the arithmetic needs (the bound) / SASS instructions this "
          f"code executes per thread: one permutation {PERMUTE_OPS} / {per_perm}, one grind "
          f"candidate {GRIND_OPS} / {per_cand}, one modular multiply {MUL_OPS} / {per_mul} "
          f"canonical, {sass['probe_mul_lazy'] - sass['probe_base']} lazy, one "
          f"butterfly {BUTTERFLY_OPS} / {per_butterfly}; issue rate {card.sms} SMs x "
          f"{SCHED_LANES_PER_CLK_SM} lanes x {card.clock_hz / 1e6:.0f} MHz = "
          f"{card.instr_per_s:.4g} per second; memory {HBM_BYTES_PER_S:.3g} B/s")

    def row(name, source, replaces, fn, err, ms, plain_ms, nbytes, ops, instrs):
        """bound_ms from the bytes and the needed operations; issue_ms, beside
        it, from this code's own instruction count."""
        bound_ms, bound_by = card.bound(nbytes, ops)
        issue_ms = card.issue_ms(instrs)
        rows.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                         max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None, issue_ms=issue_ms, fn=fn))
        return f"bound {bound_ms:.3f} ms by {bound_by}, this code's issue slots {issue_ms:.3f} ms"

    # kernel 1: the wires leaf sponge's permutation at B=32, N=2^15
    M = 1 << 20
    x = random_field(rng, (12, M), dev)
    k, p = poseidon_cuda.permute(x), poseidon.permute_plain(x)
    err = max_abs_err(k, p)
    ms = cuda_ms(lambda: poseidon_cuda.permute(x), 20)
    plain_ms = cuda_ms(lambda: poseidon.permute_plain(x), 2)
    bounds = row("poseidon2_permute", "plonky2_ecdsa_tpu_torch/csrc/poseidon2.cu",
                 "plonky2_ecdsa_tpu/hash/poseidon_pallas.py:118", poseidon_cuda.permute,
                 err, ms, plain_ms, 2 * 12 * M * 8, M * PERMUTE_OPS, M * per_perm)
    perm_rate = M / (ms * 1e-3)
    print(f"poseidon2 permute [12, 2^20]: max_abs_err={err} (tolerance 0), kernel {ms:.3f} ms "
          f"({perm_rate:.4g} permutations/s), plain {plain_ms:.3f} ms, {bounds}, no library call computes this  ({card.line})")
    assert err == 0.0, "poseidon2 permute disagrees with the plain version"

    # kernel 1b: the leaf sponge.  The wires commit's (poly-major, 128 columns
    # at B=32, N=2^15: 16 absorptions a leaf), a width that is no multiple of
    # 8, a leaf-major Merkle level of digest pairs, odd leaf-major rows, and
    # hash_no_pad's stacked words
    lde = random_field(rng, (BATCH, 128, 1 << 15), dev)
    shapes = [("poly", lde), ("poly", random_field(rng, (BATCH, 20, 1 << 12), dev)),
              ("leaf", random_field(rng, (BATCH, 1 << 14, 8), dev)),
              ("leaf", random_field(rng, (3, 1000, 13), dev)),
              ("stacked", random_field(rng, (5, BATCH, 42), dev))]
    errs = []
    for layout, t in shapes:
        launches = poseidon_cuda.sponge.launches
        got = poseidon_cuda.sponge(t, layout)
        assert poseidon_cuda.sponge.launches == launches + 1, "a sponge is one launch"
        errs.append(max_abs_err(got, poseidon_cuda.sponge_plain(t, layout)))
        print(f"poseidon2 sponge {layout} {list(t.shape)}: max_abs_err={errs[-1]} (tolerance 0)")
    err = max(errs)
    assert err == 0.0, "poseidon2 sponge disagrees with the plain version"

    def sponge_by_permutes():
        """The path the sponge kernel replaced: one copy of the whole state
        and one permute launch per 8 columns."""
        state = torch.zeros((12, BATCH, 1 << 15), dtype=torch.int64, device=dev)
        for off in range(0, 128, 8):
            state = poseidon_cuda.permute(torch.cat([lde[:, off:off + 8].movedim(1, 0),
                                                     state[8:]], 0))
        return state[:4].movedim(0, -1)

    assert max_abs_err(sponge_by_permutes().contiguous(), poseidon_cuda.sponge(lde, "poly")) == 0.0
    ms = cuda_ms(lambda: poseidon_cuda.sponge(lde, "poly"), 10)
    loop_ms = cuda_ms(sponge_by_permutes, 5)
    plain_ms = cuda_ms(lambda: poseidon_cuda.sponge_plain(lde, "poly"), 1)
    absorptions = M * (128 // 8)
    bounds = row("poseidon2_sponge", "plonky2_ecdsa_tpu_torch/csrc/poseidon2.cu",
                 "plonky2_ecdsa_tpu/hash/poseidon_pallas.py:118", poseidon_cuda.sponge,
                 err, ms, plain_ms, lde.numel() * 8 + M * 4 * 8, absorptions * PERMUTE_OPS,
                 absorptions * per_perm)
    print(f"poseidon2 sponge, the wires leaves [{BATCH}, 128, 2^15] -> [{BATCH}, 2^15, 4] (2^20 "
          f"leaves x 16 absorptions, ONE launch): kernel {ms:.3f} ms; the former path (16 "
          f"copies of the state and 16 permute launches, with this build's permute kernel) "
          f"{loop_ms:.3f} ms; plain {plain_ms:.3f} ms, {bounds}, no library call computes this  "
          f"({card.line})")
    del lde, shapes

    # kernel 2: the FRI grind, 32 distinct lanes at 16 bits; one lane alone;
    # exhaustion; and the cap edge around the largest witness
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
    late = int(pw.argmax())
    w = int(pw[late])
    one = st[:, late:late + 1].contiguous()
    for lanes_state, lane in ((one, 0), (st, late)):
        a, f = poseidon_cuda.grind(lanes_state, 16, w + 1)
        assert int(a[lane]) == w and bool(f[lane]), "cap = w + 1 must find w"
        a, f = poseidon_cuda.grind(lanes_state, 16, w)
        assert int(a[lane]) == 0 and not bool(f[lane]), "cap = w must report not found"
        assert int(f.sum()) == f.numel() - 1, "the other lanes' hits lie below the cap"
    ow, of = poseidon_cuda.grind(one, 16, cap)
    assert int(ow[0]) == w and bool(of[0]), "one lane alone disagrees"
    one_ms = cuda_ms(lambda: poseidon_cuda.grind(one, 16, cap), 5)
    ms = cuda_ms(lambda: poseidon_cuda.grind(st, 16, cap), 10)
    tried = int(pw.sum()) + BATCH          # candidates up to and with each lane's first hit
    bounds = row("poseidon2_grind", "plonky2_ecdsa_tpu_torch/csrc/poseidon2.cu",
                 "plonky2_ecdsa_tpu/hash/poseidon_pallas.py:208", poseidon_cuda.grind,
                 err, ms, plain_ms, 12 * BATCH * 8 + 2 * BATCH * 8, tried * GRIND_OPS,
                 tried * per_cand)
    print(f"poseidon2 grind B={BATCH} pow=16: witnesses {kw[:4].tolist()}... max_abs_err={err} "
          f"(tolerance 0); exhaustion found=False on all lanes; cap = w + 1 finds w = {w} and "
          f"cap = w does not, alone and among the 32; kernel {ms:.3f} ms for {tried} candidates "
          f"to the first hits ({tried / perm_rate * 1e3:.3f} ms at the bulk kernel's rate), "
          f"{bounds}; the lane of w alone {one_ms:.3f} ms; plain "
          f"{plain_ms:.3f} ms; no library call computes this  ({card.line})")

    # kernel 3: four-step transforms of the main path on [32, 8, n], plus the
    # single-pass transform of the FRI final polynomial
    n, N, N17 = 1 << 13, 1 << 15, 1 << 17
    cases = []
    for size in (n, N):
        for inverse in (False, True):
            cases.append((f"ntt n={size} inverse={inverse}",
                          random_field(rng, (BATCH, 8, size), dev), size, inverse, None, None))
    cases.append(("coset LDE 2^13->2^15 (pre)", random_field(rng, (BATCH, 8, n), dev), N,
                  False, ntt.coset_powers(N, False, dev)[:n], None))
    cases.append(("coset INTT 2^15 (post)", random_field(rng, (BATCH, 8, N), dev), N,
                  True, None, ntt.coset_powers(N, True, dev)))
    # the next size up (split 256 x 512), at a smaller batch
    cases.append(("ntt n=2^17 inverse=False", random_field(rng, (2, 3, N17), dev), N17,
                  False, None, None))
    cases.append(("ntt n=2^17 inverse=True", random_field(rng, (2, 3, N17), dev), N17,
                  True, None, None))
    cases.append(("coset LDE 2^15->2^17 (pre)", random_field(rng, (2, 3, N), dev), N17,
                  False, ntt.coset_powers(N17, False, dev)[:N], None))
    errs = []
    for name, a, size, inverse, pre, post in cases:
        e = max_abs_err(ntt_cuda.four_step(a, size, inverse, pre, post),
                        ntt_cuda.four_step_plain(a, size, inverse, pre, post))
        errs.append(e)
        print(f"sub_ntt four-step {name} {list(a.shape[:-1])}: max_abs_err={e} (tolerance 0)")
    wires = random_field(rng, (BATCH, 128, n), dev)
    e = max_abs_err(ntt_cuda.four_step(wires, N, False, cases[4][4]),
                    ntt_cuda.four_step_plain(wires, N, False, cases[4][4]))
    errs.append(e)
    wires_ms = cuda_ms(lambda: ntt_cuda.four_step(wires, N, False, cases[4][4]), 10)
    print(f"sub_ntt four-step coset LDE 2^13->2^15 (pre) [{BATCH}, 128] (the wires LDE): "
          f"max_abs_err={e} (tolerance 0)")
    del wires
    ragged = random_field(rng, (3, 64, 40), dev)       # a ragged last tile, compact rows
    scale = random_field(rng, (128, 40), dev)
    for tr in (False, True):
        e = max_abs_err(ntt_cuda.sub_ntt(ragged, 128, False, scale[:64], scale, tr),
                        ntt_cuda.sub_ntt_plain(ragged, 128, False, scale[:64], scale, tr))
        errs.append(e)
        print(f"sub_ntt n_t=128 on [3, 64, 40] (ragged tile, compact rows, pre and post), "
              f"transpose_out={tr}: max_abs_err={e} (tolerance 0)")
    small = random_field(rng, (2 * BATCH, 512, 1), dev)
    e = max_abs_err(ntt_cuda.sub_ntt(small, 512, True), ntt_cuda.sub_ntt_plain(small, 512, True))
    errs.append(e)
    print(f"sub_ntt single pass n=512 [{2 * BATCH}]: max_abs_err={e} (tolerance 0)")
    err = max(errs)
    assert err == 0.0, "sub_ntt disagrees with the plain version"
    _, a, size, inverse, pre, _post = cases[4]
    ms = cuda_ms(lambda: ntt_cuda.four_step(a, size, inverse, pre), 20)
    plain_ms = cuda_ms(lambda: ntt_cuda.four_step_plain(a, size, inverse, pre), 3)
    # the transform as a function: input, coset powers, four-step twiddles and
    # stage twiddles read once, output written once; N/2 log2 N butterflies a
    # transform, one multiply per input (coset power) and per output (twiddle)
    n1, n2 = ntt_cuda._split2(N)

    def lde_work(polys):
        """(bytes, needed operations, this code's instructions) of `polys` coset LDEs."""
        nbytes = 8 * (polys * n + n + N + n1 + n2 + polys * N)
        butterflies, scales = polys * (N // 2) * (N.bit_length() - 1), polys * (n + N)
        return (nbytes, butterflies * BUTTERFLY_OPS + scales * MUL_OPS,
                butterflies * per_butterfly + scales * per_mul)

    nbytes, ops, instrs = lde_work(BATCH * 8)
    bounds = row("sub_ntt", "plonky2_ecdsa_tpu_torch/csrc/ntt.cu",
                 "plonky2_ecdsa_tpu/prover/ntt_pallas.py:181", ntt_cuda.sub_ntt,
                 err, ms, plain_ms, nbytes, ops, instrs)
    print(f"sub_ntt coset LDE 2^13->2^15 [{BATCH}, 8] (two launches, the first storing "
          f"transposed; no copy between): kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms, {bounds} "
          f"({nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms by bytes), no library call computes this  "
          f"({card.line})")
    nbytes, ops, instrs = lde_work(BATCH * 128)
    wires_bound, wires_by = card.bound(nbytes, ops)
    print(f"sub_ntt coset LDE 2^13->2^15 [{BATCH}, 128] (the wires LDE): kernel {wires_ms:.3f} "
          f"ms, bound {wires_bound:.3f} ms by {wires_by} ({card.issue_ms(ops):.3f} ms by "
          f"operations, {nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms by bytes), this code's issue "
          f"slots {card.issue_ms(instrs):.3f} ms  ({card.line})")
    return rows


def load_anchors():
    path = os.path.join(ROOT, "plonky2_ecdsa_tpu_torch", "vectors", "anchors.json")
    with open(path) as f:
        return json.load(f)


def hex_words(t) -> list:
    from plonky2_ecdsa_tpu_torch.fields import goldilocks as gl

    return [f"{int(v):016x}" for v in gl.to_u64(t).ravel()]


def check_demo(dev, anchors):
    """Demo circuit at B=2: the card's proof equals the port's own CPU proof
    leaf for leaf, and the digest frozen from the reference."""
    from plonky2_ecdsa_tpu_torch.circuit.examples import small_demo_circuit, small_demo_witness
    from plonky2_ecdsa_tpu_torch.prover import prover, verifier
    from plonky2_ecdsa_tpu_torch.prover.data import build_circuit_data

    circuit = small_demo_circuit().build()
    W, pis = small_demo_witness(circuit, anchors["demo_batch"])
    host = prover.prove(build_circuit_data(circuit, "cpu"), W, pis)
    data = build_circuit_data(circuit, dev)
    got = prover.prove(data, W, pis)
    diff = prover.first_difference(host, got)
    digest = prover.proof_digest(got)
    print(f"demo proof B={anchors['demo_batch']} on {dev}: first leaf differing from the CPU "
          f"proof of the same code = {diff}; sha256 {digest}")
    assert diff is None, f"demo proof on the card differs from the CPU's at {diff}"
    assert digest == anchors["demo_proof_sha256"], "demo proof differs from the reference's"
    verifier.verify_strict(data, got)       # raises where a check fails
    print("demo proof: digest equals the reference's frozen digest; verified on the card")


def main_path(dev, card, rows, anchors):
    from plonky2_ecdsa_tpu_torch import api
    from plonky2_ecdsa_tpu_torch.prover import prover, verifier

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    system = api.EcdsaProverSystem(api.SECP256K1, device=dev)
    build_s = time.time() - t0
    t0 = time.time()
    data = system.data
    torch.cuda.synchronize()
    commit_s = time.time() - t0
    assert data.fixed_lde.device == dev and data.fixed_tree.cap.device == dev
    assert hex_words(data.fixed_tree.cap) == anchors["secp256k1_fixed_cap"], \
        "fixed-commit cap differs from the reference's"
    t0 = time.time()
    run = system.prover
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    stmts = api.random_statements(api.SECP256K1, BATCH, seed=anchors["seed"])
    t0 = time.time()
    vals, pis = system.witness_vals(stmts)
    witness_s = time.time() - t0
    assert system.circuit.last_tape_native, "the witness did not run through the native tape"
    print(f"secp256k1: n={data.n} N={data.N}; circuit build {build_s:.1f} s, fixed data with "
          f"the commit on the card {commit_s:.2f} s (cap equals the reference's), prover "
          f"set-up {setup_s:.2f} s, witness B={BATCH} through the native tape {witness_s:.1f} s  "
          f"({card.line})")

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
    assert system.verify(proof), "B=32 proof rejected by the port's verifier"
    torch.cuda.synchronize()
    verify_s = time.time() - t0
    t0 = time.time()
    assert api.verify_one_exact(data, proof, 0), "lane 0 fails the exact verifier"
    exact_s = time.time() - t0
    assert all(system.verify_statement(proof, i, stmts[i]) for i in (0, BATCH - 1))
    assert not np.array_equal(proof.pis[0], api.statement_pis(stmts[1])), \
        "a wrong statement was bound"
    # a tampered proof must fail one of the verifier's own checks: any other
    # exception (a launch error, a fault in the verifier) is not a rejection
    bad = prover.Proof(**{**proof.__dict__, "pis": proof.pis.copy()})
    bad.pis[0, 0] ^= np.uint64(1)
    try:
        verifier.verify_strict(data, bad)
    except verifier.VerifyError as e:
        rejected = str(e)
    else:
        raise AssertionError("tampered proof accepted")
    assert "lane 0" in rejected, f"the tampered lane is 0, the verifier said: {rejected}"
    print(f"B={BATCH} proof: the port's verifier on the card says True ({verify_s:.2f} s), "
          f"verify_one_exact lane 0 True ({exact_s:.1f} s), statements bound, flipped pis bit "
          f"of lane 0 rejected with VerifyError: {rejected}  ({card.line})")

    assert [f"{int(v):016x}" for v in proof.wires_cap[0].ravel()] == \
        anchors["secp256k1_lane0_wires_cap"], "lane 0 wires cap differs from the reference's"
    print("lane 0 wires cap equals the reference's numpy commitment at B=1 (frozen)")
    if "secp256k1_lane0_proof_sha256" in anchors:
        assert prover.proof_digest(proof, lane=0) == anchors["secp256k1_lane0_proof_sha256"], \
            "lane 0 of the proof differs from the reference's B=1 proof"
        print("lane 0 of the B=32 proof equals the reference's numpy B=1 proof (frozen digest)")

    t0 = time.time()
    again = [run.run_vals(vals, pis) for _ in range(STEADY_BATCHES)]
    steady_s = (time.time() - t0) / STEADY_BATCHES
    assert all(prover.first_difference(proof, p) is None for p in again), \
        "proving is not deterministic"
    print(f"first prove {first_s:.2f} s; steady state {steady_s:.2f} s/batch = "
          f"{BATCH / steady_s:.2f} proofs/s at B={BATCH} over {STEADY_BATCHES} batches; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB  ({card.line})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from plonky2_ecdsa_tpu_torch import _build, native

    card = Card()
    print(card.line)
    dev = torch.device("cuda", 0)
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor() as pool:   # every build at once
        jobs = [pool.submit(f) for f in (_build.library_path, sass_instruction_counts,
                                         native.get_lib)]
        sass = jobs[1].result()
        for j in jobs:
            j.result()
    _build.library()
    print(f"kernels, witness library and count-only cubin built and loaded in "
          f"{time.time() - t0:.1f} s: {_build.library_path()}  ({card.line})")
    for name, (regs, spill_st, spill_ld) in sorted(_build.kernel_resources().items()):
        print(f"ptxas: {name}: {regs} registers, {spill_st} + {spill_ld} bytes of spills")
        assert spill_st == 0 and spill_ld == 0, f"{name} spills registers"

    anchors = load_anchors()
    check_field(dev)
    rows = check_kernels(dev, card, sass)
    check_demo(dev, anchors)
    main_path(dev, card, rows, anchors)
    assert sys.modules["jax"] is None and sys.modules["plonky2_ecdsa_tpu"] is None
    assert not [m for m in sys.modules if m.startswith(("jax.", "plonky2_ecdsa_tpu."))]
    print(card.line)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
