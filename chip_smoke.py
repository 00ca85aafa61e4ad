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
     bit, at the shapes of the main path and of the recursion path's outer
     proof, times both, and works out the least time the card could take for
     the same work (its bound: the bytes, or the integer operations the
     arithmetic needs whatever the code) and, beside it, the issue slots that
     this code's own instruction count fills;
  3. proves the small demo circuit (B=2) on the card and checks the proof
     leaf for leaf against the port's own proof on the CPU (plain kernels),
     and its digest against the value frozen from the reference; then the
     demo recursion (the reference tests' inner circuit at B=2, its verifier
     circuit): the outer value table, fixed cap and lane 0 of the outer proof
     against the reference's frozen values;
  4. drives the main path, for secp256k1 (standard_ecc_config) and again for
     P-256 (p256_ecc_config: 64 constant columns, 31 range values a row, the
     windowed multiplication): EcdsaProverSystem(curve) -> fixed commit on
     the card -> witness_vals for B=32 statements (native tape) -> run_vals on
     the card -> the port's verifier on the card; checks lane 0 exactly,
     requires a VerifyError for a tampered proof, checks the fixed cap, lane
     0's wires cap and lane 0's whole proof against the values frozen from the
     reference, checks that every kernel was launched by that path (counts set
     to 0 just before it, read just after), and times steady-state batches;
  5. the wide-witness fallback on the card: a forged value table (a value of
     41 bits under a narrow-classified slot) and a misclassified role (honest
     table) both warn on stderr and are proved through the full-witness path;
  6. the command line in this process, into a temporary directory: sign ->
     build -> prove -> verify (exit 0), verify against a changed statement
     (exit 1), and the saved circuit data loaded back onto the card proving
     to the same digest;
  7. the recursion path (bench.py's bench_recursive), reusing the secp256k1
     system: B=8 inner proofs (seed 11) -> the verifier circuit under
     recursion_ecc_config (outer n = 2^14, N = 2^17, 28 queries, 16 PoW
     bits; structure and fixed cap against the reference's frozen values)
     -> witness through the native tape -> the outer proof (kernel counts
     set to 0 just before the first, read just after), steady state through
     dispatch_vals/collect -> verify_strict and verify_one_exact; the outer
     PIs are the inner statements' limbs, no fallback is taken, and a flipped
     inner statement limb breaks the outer witness;
  8. one B=2 secp256k1 proof under wide_ecc_config (234 wires, 176 routed);
  9. aggregation: 4 demo proofs -> 2 -> 1 through the 2-to-1 verifier
     circuit; the root proof verifies and binds the four statements in order.
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
import contextlib  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 32
SEED = 3
STEADY_BATCHES = 3
# column counts of the further paths, compared by the kernel checks before the
# circuits exist and asserted against the built circuits afterwards
P256_FIXED_COLS, P256_ZS_COLS = 159, 128
WIDE_WIRES, WIDE_FIXED_COLS = 234, 225
# the recursion path (bench.py's bench_recursive): B=8 inner secp256k1 proofs
# (seed 11) verified by the outer circuit under recursion_ecc_config, n = 2^14,
# N = 2^17, 136 wires; the demo recursion and the aggregation fold at the
# reference tests' seeds
REC_BATCH, REC_SEED = 8, 11
OUTER_WIRES, OUTER_LOG_N, OUTER_LOG_LDE = 136, 14, 17
AGG_BATCH, AGG_SEED = 4, 99
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


def lde_work(polys: int, n: int, N: int, per_butterfly: int, per_mul: int):
    """(bytes, needed operations, this code's instructions) of `polys` coset
    LDEs from n to N coefficients.

    Bytes: the input, the coset powers, the four-step and stage twiddles read
    once, the output written once.  Needed operations: the N/n coset
    transforms of size n, (n/2) log2 n butterflies each, and one multiply per
    coefficient per coset.  This code's instructions: the four-step runs one
    transform of size N, (N/2) log2 N butterflies (its first pass on rows
    that are zero past n), one multiply per input (coset power) and per
    output (twiddle)."""
    from plonky2_ecdsa_tpu_torch.prover import ntt_cuda

    n1, n2 = ntt_cuda._split2(N)
    nbytes = 8 * (polys * n + n + N + n1 + n2 + polys * N)
    needed = polys * ((N // n) * (n // 2) * (n.bit_length() - 1) * BUTTERFLY_OPS + N * MUL_OPS)
    run = polys * ((N // 2) * (N.bit_length() - 1) * per_butterfly + (n + N) * per_mul)
    return nbytes, needed, run


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
    rng_new = np.random.default_rng(SEED + 1)   # later shapes: the earlier ones keep their inputs
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
              ("stacked", random_field(rng, (5, BATCH, 42), dev)),
              # the P-256 fixed commit (64 constants + 14 selectors + 80 sigmas + the
              # table: 159 columns, no batch axis; its wires and zs commits are both
              # [32, 128, 2^15], the first shape), the wide config's wires (234
              # columns, B=2) and fixed commit (225), none a multiple of 8; and the
              # verifier's rows of queried leaves at those widths (42 queries)
              ("poly", random_field(rng_new, (P256_FIXED_COLS, 1 << 15), dev)),
              ("poly", random_field(rng_new, (2, WIDE_WIRES, 1 << 15), dev)),
              ("poly", random_field(rng_new, (WIDE_FIXED_COLS, 1 << 15), dev)),
              ("leaf", random_field(rng_new, (BATCH, 42, P256_FIXED_COLS), dev)),
              ("leaf", random_field(rng_new, (2, 42, WIDE_WIRES), dev))]
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
    # the further paths' widths: the P-256 fixed commit (no batch axis), the
    # P-256 zs commit (128 columns, the shape just compared), the wide
    # config's wires at B=2
    for name, a in (("[%d] (the P-256 fixed commit)" % P256_FIXED_COLS,
                     random_field(rng_new, (P256_FIXED_COLS, n), dev)),
                    ("[2, %d] (the wide config's wires)" % WIDE_WIRES,
                     random_field(rng_new, (2, WIDE_WIRES, n), dev))):
        for label, size, inverse, pre in (("INTT n=2^13", n, True, None),
                                          ("coset LDE 2^13->2^15 (pre)", N, False, cases[4][4])):
            e = max_abs_err(ntt_cuda.four_step(a, size, inverse, pre),
                            ntt_cuda.four_step_plain(a, size, inverse, pre))
            errs.append(e)
            print(f"sub_ntt four-step {label} {name}: max_abs_err={e} (tolerance 0)")
    p256_zs = random_field(rng_new, (BATCH, P256_ZS_COLS, n), dev)
    p256_zs_ms = cuda_ms(lambda: ntt_cuda.four_step(p256_zs, N, False, cases[4][4]), 10)
    del p256_zs, a
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
    nbytes, ops, instrs = lde_work(BATCH * 8, n, N, per_butterfly, per_mul)
    bounds = row("sub_ntt", "plonky2_ecdsa_tpu_torch/csrc/ntt.cu",
                 "plonky2_ecdsa_tpu/prover/ntt_pallas.py:181", ntt_cuda.sub_ntt,
                 err, ms, plain_ms, nbytes, ops, instrs)
    print(f"sub_ntt coset LDE 2^13->2^15 [{BATCH}, 8] (two launches, the first storing "
          f"transposed; no copy between): kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms, {bounds} "
          f"({nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms by bytes), no library call computes this  "
          f"({card.line})")
    nbytes, ops, instrs = lde_work(BATCH * 128, n, N, per_butterfly, per_mul)
    wires_bound, wires_by = card.bound(nbytes, ops)
    print(f"sub_ntt coset LDE 2^13->2^15 [{BATCH}, 128] (the wires LDE): kernel {wires_ms:.3f} "
          f"ms, bound {wires_bound:.3f} ms by {wires_by} ({card.issue_ms(ops):.3f} ms by "
          f"operations, {nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms by bytes), this code's issue "
          f"slots {card.issue_ms(instrs):.3f} ms  ({card.line})")
    print(f"sub_ntt coset LDE 2^13->2^15 [{BATCH}, {P256_ZS_COLS}] (the P-256 zs LDE; secp256k1's "
          f"is [{BATCH}, 120]): kernel {p256_zs_ms:.3f} ms, same bound and issue slots as the "
          f"wires LDE  ({card.line})")

    # the recursion path's outer shapes: the wires leaf sponge [8, 136, 2^17]
    # (17 absorptions a leaf) and the wires coset LDE 2^14 -> 2^17 on [8, 136]
    rng_rec = np.random.default_rng(SEED + 2)
    on, oN = 1 << OUTER_LOG_N, 1 << OUTER_LOG_LDE
    lde = random_field(rng_rec, (REC_BATCH, OUTER_WIRES, oN), dev)
    err = max_abs_err(poseidon_cuda.sponge(lde, "poly"), poseidon_cuda.sponge_plain(lde, "poly"))
    assert err == 0.0, "poseidon2 sponge disagrees with the plain version at the outer shape"
    ms = cuda_ms(lambda: poseidon_cuda.sponge(lde, "poly"), 10)
    plain_ms = cuda_ms(lambda: poseidon_cuda.sponge_plain(lde, "poly"), 1)
    leaves = REC_BATCH * oN
    absorptions = leaves * -(-OUTER_WIRES // 8)
    bounds = row("poseidon2_sponge_outer", "plonky2_ecdsa_tpu_torch/csrc/poseidon2.cu",
                 "plonky2_ecdsa_tpu/hash/poseidon_pallas.py:118", poseidon_cuda.sponge,
                 err, ms, plain_ms, lde.numel() * 8 + leaves * 4 * 8, absorptions * PERMUTE_OPS,
                 absorptions * per_perm)
    print(f"poseidon2 sponge, the outer wires leaves [{REC_BATCH}, {OUTER_WIRES}, 2^17] -> "
          f"[{REC_BATCH}, 2^17, 4] ({leaves} leaves x {absorptions // leaves} absorptions, ONE "
          f"launch): max_abs_err={err} (tolerance 0), kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"{bounds}, no library call computes this  ({card.line})")
    del lde
    coeffs = random_field(rng_rec, (REC_BATCH, OUTER_WIRES, on), dev)
    pre = ntt.coset_powers(oN, False, dev)[:on]
    err = max_abs_err(ntt_cuda.four_step(coeffs, oN, False, pre),
                      ntt_cuda.four_step_plain(coeffs, oN, False, pre))
    assert err == 0.0, "sub_ntt disagrees with the plain version at the outer shape"
    ms = cuda_ms(lambda: ntt_cuda.four_step(coeffs, oN, False, pre), 10)
    plain_ms = cuda_ms(lambda: ntt_cuda.four_step_plain(coeffs, oN, False, pre), 2)
    o1, o2 = ntt_cuda._split2(oN)
    bounds = row("sub_ntt_outer", "plonky2_ecdsa_tpu_torch/csrc/ntt.cu",
                 "plonky2_ecdsa_tpu/prover/ntt_pallas.py:181", ntt_cuda.sub_ntt,
                 err, ms, plain_ms,
                 *lde_work(REC_BATCH * OUTER_WIRES, on, oN, per_butterfly, per_mul))
    print(f"sub_ntt four-step coset LDE 2^14->2^17 (pre) [{REC_BATCH}, {OUTER_WIRES}] (the outer "
          f"wires LDE, {o1} x {o2}): max_abs_err={err} (tolerance 0), kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, {bounds}  ({card.line})")
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


def main_path(name, dev, card, rows, anchors):
    """The main path for one curve (name: the anchors' prefix).  Returns the
    system, the value table, the PIs and the proof for the later phases."""
    from plonky2_ecdsa_tpu_torch import api
    from plonky2_ecdsa_tpu_torch.prover import prover, verifier

    curve = api.CURVES[name]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    system = api.EcdsaProverSystem(curve, device=dev)
    build_s = time.time() - t0
    t0 = time.time()
    data = system.data
    torch.cuda.synchronize()
    commit_s = time.time() - t0
    assert data.fixed_lde.device == dev and data.fixed_tree.cap.device == dev
    assert data.n == anchors[f"{name}_n"]
    assert hex_words(data.fixed_tree.cap) == anchors[f"{name}_fixed_cap"], \
        "fixed-commit cap differs from the reference's"
    t0 = time.time()
    run = system.prover
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    stmts = api.random_statements(curve, BATCH, seed=anchors["seed"])
    t0 = time.time()
    vals, pis = system.witness_vals(stmts)
    witness_s = time.time() - t0
    assert system.circuit.last_tape_native, "the witness did not run through the native tape"
    cfg = system.circuit.config
    zs_cols = 2 * (cfg.num_routed_wires // cfg.permutation_chunk_size) + \
        2 * data.lookup.cols_per_challenge
    if name == "p256":
        assert (data.fixed_values.shape[0], zs_cols) == (P256_FIXED_COLS, P256_ZS_COLS), \
            "the kernel checks compared other widths than the P-256 path has"
    print(f"{name}: n={data.n} N={data.N}, {cfg.num_wires} wires, {cfg.num_constant_cols} "
          f"constant columns, {data.fixed_values.shape[0]} fixed and {zs_cols} zs columns; circuit "
          f"build {build_s:.1f} s, fixed data with the commit on the card {commit_s:.2f} s (cap "
          f"equals the reference's), prover set-up {setup_s:.2f} s, witness B={BATCH} through "
          f"the native tape {witness_s:.1f} s  ({card.line})")

    for r in rows:
        r["fn"].launches = 0
    t0 = time.time()
    proof = run.run_vals(vals, pis)
    first_s = time.time() - t0
    key = "launches" if name == "secp256k1" else f"launches_{name}"
    for r in rows:
        r[key] = r["fn"].launches
    print(f"{name} main path kernel launches a batch: "
          + ", ".join(f"{r['name']}={r[key]}" for r in rows))
    assert all(r[key] > 0 for r in rows), f"a kernel of the {name} path was not launched"

    t0 = time.time()
    verifier.verify_strict(data, proof)     # raises where a check fails
    torch.cuda.synchronize()
    verify_s = time.time() - t0
    t0 = time.time()
    assert api.verify_one_exact(data, proof, 0), "lane 0 fails the exact verifier"
    exact_s = time.time() - t0
    assert system.verify_statement(proof, 0, stmts[0]), "lane 0 does not bind its statement"
    assert all(np.array_equal(proof.pis[i], api.statement_pis(stmts[i])) for i in range(BATCH))
    assert not np.array_equal(proof.pis[0], api.statement_pis(stmts[1])), \
        "a wrong statement was bound"
    # a tampered proof must fail one of the verifier's own checks: any other
    # exception (a launch error, a fault in the verifier) is not a rejection
    bad = prover.Proof(**{**proof.__dict__, "pis": proof.pis.copy()})
    bad.pis[0, 0] ^= np.uint64(1)
    rejected = rejection(data, bad)
    assert "lane 0" in rejected, f"the tampered lane is 0, the verifier said: {rejected}"
    print(f"{name} B={BATCH} proof: the port's verifier on the card accepts it ({verify_s:.2f} s), "
          f"verify_one_exact lane 0 True ({exact_s:.1f} s), statements bound, flipped pis bit "
          f"of lane 0 rejected with VerifyError: {rejected}  ({card.line})")

    assert [f"{int(v):016x}" for v in proof.wires_cap[0].ravel()] == \
        anchors[f"{name}_lane0_wires_cap"], "lane 0 wires cap differs from the reference's"
    assert prover.proof_digest(proof, lane=0) == anchors[f"{name}_lane0_proof_sha256"], \
        "lane 0 of the proof differs from the reference's B=1 proof"
    print(f"{name}: lane 0's wires cap and lane 0 of the whole B={BATCH} proof equal the "
          f"reference's numpy B=1 commitment and proof (frozen)")

    t0 = time.time()
    again = [run.run_vals(vals, pis) for _ in range(STEADY_BATCHES)]
    steady_s = (time.time() - t0) / STEADY_BATCHES
    assert all(prover.first_difference(proof, p) is None for p in again), \
        "proving is not deterministic"
    print(f"{name}: first prove {first_s:.2f} s; steady state {steady_s:.2f} s/batch = "
          f"{BATCH / steady_s:.2f} proofs/s at B={BATCH} over {STEADY_BATCHES} batches; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB  ({card.line})")
    return system, vals, pis, proof


def rejection(data, proof) -> str:
    """The VerifyError with which the port's verifier rejects `proof`; an
    accepted proof, or any other exception, ends the run."""
    from plonky2_ecdsa_tpu_torch.prover import verifier

    try:
        verifier.verify_strict(data, proof)
    except verifier.VerifyError as e:
        return str(e)
    raise AssertionError("a proof that must be rejected was accepted")


def check_fallback(system, vals, pis, proof, card):
    """The wide-witness fallback on the card, on the first four lanes of the
    secp256k1 batch.  (a) A forged table, bit 40 set under a narrow-classified
    slot of lane 0: the warning, the very proof of the full-witness path, and
    (the forged value being wrong for the circuit) lane 0 rejected, so the
    real 64-bit value went up and no truncation.  (b) A misclassified role,
    mul_nn's 34-bit carries declared narrow, on the honest table: the
    warning, and the accepted proof that the narrow path gives."""
    from plonky2_ecdsa_tpu_torch.hash import poseidon_cuda
    from plonky2_ecdsa_tpu_torch.prover import prover, verifier

    lanes = 4
    vals, pis, data = np.ascontiguousarray(vals[:, :lanes]), pis[:lanes], system.data
    run = system.prover
    mask = prover._narrow_mask(system.circuit)
    mask[system.circuit.derived_tids] = False
    mask &= np.isin(np.arange(len(mask)), run._keep_n)
    tid = int(np.nonzero(mask)[0][0])
    forged = vals.copy()
    forged[tid, 0] |= np.uint64(1) << np.uint64(40)

    def warned(fn):
        err = io.StringIO()
        launches = poseidon_cuda.sponge.launches
        with contextlib.redirect_stderr(err):
            out = fn()
        assert "falling back to the wide witness path" in err.getvalue(), err.getvalue()
        assert poseidon_cuda.sponge.launches > launches, "the fallback left the kernels"
        return out, err.getvalue().strip()

    got, line = warned(lambda: run.run_vals(forged, pis))
    wide = prover.prove(data, run._expand_host(forged), pis)
    assert prover.first_difference(wide, got) is None, "fallback differs from the wide path"
    rejected = rejection(data, got)
    assert "lane 0" in rejected
    print(f"fallback (a), forged table B={lanes}: stderr '{line}'; the proof equals the "
          f"full-witness path's leaf for leaf; VerifyError: {rejected}")

    honest = run.run_vals(vals, pis)
    assert prover.proof_digest(honest, lane=0) == prover.proof_digest(proof, lane=0)
    roles = prover._NARROW_ROLES["mul_nn"]
    prover._NARROW_ROLES["mul_nn"] = roles + ("carry",)
    try:
        misclassified = prover.Prover(data)
    finally:
        prover._NARROW_ROLES["mul_nn"] = roles
    got, line = warned(lambda: misclassified.run_vals(vals, pis))
    verifier.verify_strict(data, got)
    assert prover.first_difference(honest, got) is None
    print(f"fallback (b), mul_nn's carries classified narrow, honest table B={lanes}: stderr "
          f"'{line[:100]}...'; verify_strict accepts the proof, which equals the narrow path's "
          f"leaf for leaf  ({card.line})")


def exit_code(argv) -> int:
    """The command line's exit code for argv, run in this process."""
    from plonky2_ecdsa_tpu_torch import __main__ as cli

    try:
        cli.main(argv)
    except SystemExit as e:
        return 0 if e.code is None else e.code
    return 0


def check_command_line(system, dev, card):
    """sign -> build -> prove -> verify for secp256k1 at a batch of 2; verify
    against a changed statement; the saved circuit data back on the card."""
    from plonky2_ecdsa_tpu_torch import __main__ as cli
    from plonky2_ecdsa_tpu_torch.prover import prover, serialize

    t0 = time.time()
    with tempfile.TemporaryDirectory() as d:
        stmts, data_path, proof_path, changed = (os.path.join(d, f) for f in (
            "stmts.json", "circuit.npz", "proof.npz", "changed.json"))
        common = ["--curve", "secp256k1", "--device", str(dev)]
        for argv in (["sign", *common, "--count", "2", "--seed", str(SEED), "--out", stmts],
                     ["build", *common, "--data", data_path],
                     ["prove", *common, "--statements", stmts, "--proof", proof_path]):
            assert exit_code(argv) == 0, argv
        verify = ["verify", *common, "--proof", proof_path, "--data", data_path, "--statements"]
        assert exit_code(verify + [stmts]) == 0, "the command line rejects its own proof"
        with open(stmts) as f:
            rows = json.load(f)
        rows[1]["r"] = f"{int(rows[1]['r'], 16) ^ 1:x}"
        with open(changed, "w") as f:
            json.dump(rows, f)
        assert exit_code(verify + [changed]) == 1, "a changed statement must exit 1"
        sizes = os.path.getsize(data_path), os.path.getsize(proof_path)
        loaded = serialize.load_circuit_data(data_path, dev)
        assert loaded.fixed_lde.device == dev and loaded.fixed_tree.cap.device == dev
        assert hex_words(loaded.fixed_tree.cap) == hex_words(system.data.fixed_tree.cap)
        saved = serialize.load_proof(proof_path)
        vals, pis = system.witness_vals(cli._load_statements(stmts, system.curve))
        again = prover.Prover(loaded).run_vals(vals, pis)
    assert prover.first_difference(saved, again) is None
    assert prover.proof_digest(again) == prover.proof_digest(system.prover.run_vals(vals, pis))
    print(f"command line on {dev}: sign, build, prove, verify exit 0; verify with one bit of "
          f"statement 1 changed exits 1; circuit data file {sizes[0]} bytes, proof file "
          f"{sizes[1]} bytes; the loaded circuit data proves the batch to the saved proof, "
          f"leaf for leaf, as the freshly built data does; {time.time() - t0:.1f} s  ({card.line})")


def check_wide_config(dev, card):
    """One B=2 secp256k1 proof under wide_ecc_config: 234 wire columns (no
    multiple of 8: the sponge's remainder path, the sub-NTT on [2, 234])."""
    from plonky2_ecdsa_tpu_torch import api
    from plonky2_ecdsa_tpu_torch.circuit.config import CircuitConfig
    from plonky2_ecdsa_tpu_torch.prover import prover, verifier

    t0 = time.time()
    system = api.EcdsaProverSystem(api.SECP256K1, CircuitConfig.wide_ecc_config(), device=dev)
    cfg = system.circuit.config
    assert (cfg.num_wires, system.data.fixed_values.shape[0]) == (WIDE_WIRES, WIDE_FIXED_COLS), \
        "the kernel checks compared other widths than the wide config has"
    stmts = api.random_statements(api.SECP256K1, 2, seed=SEED)
    proof = system.prove(stmts)
    verifier.verify_strict(system.data, proof)
    assert all(system.verify_statement(proof, i, stmts[i]) for i in range(2))
    assert proof.initial_leaves["wires"].shape[-1] == WIDE_WIRES
    bad = prover.Proof(**{**proof.__dict__, "pis": proof.pis.copy()})
    bad.pis[1, 44] ^= np.uint64(1)
    rejected = rejection(system.data, bad)
    assert "lane 1" in rejected
    print(f"wide_ecc_config: secp256k1 n={system.n}, {cfg.num_wires} wires / "
          f"{cfg.num_routed_wires} routed, B=2 proved and verified on the card, statements "
          f"bound, a flipped pis bit of lane 1 rejected ({rejected}); "
          f"{time.time() - t0:.1f} s  ({card.line})")


# ---------------------------------------------------------------------------
# recursion: the demo setting of the reference's tests/test_recursive_proof.py
# ---------------------------------------------------------------------------

def demo_inner_proof(batch, seed, dev):
    """The demo recursion's inner circuit, its data on dev and a proof of
    `batch` seeded lanes."""
    from plonky2_ecdsa_tpu_torch.circuit.examples import recursion_demo_inner, recursion_demo_inputs
    from plonky2_ecdsa_tpu_torch.prover import prover
    from plonky2_ecdsa_tpu_torch.prover.data import build_circuit_data

    ic = recursion_demo_inner()
    W = ic.generate_witness(recursion_demo_inputs(batch, seed), batch)
    idata = build_circuit_data(ic, dev)
    return idata, prover.prove(idata, W, ic.public_input_values())


def no_fallback(fn):
    """fn() with stderr captured: the wide-witness fallback must not be taken
    (an honest table has no value above its narrow classification)."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        out = fn()
    sys.stderr.write(err.getvalue())
    assert "falling back" not in err.getvalue(), f"the fallback was taken: {err.getvalue()}"
    return out


def check_demo_recursion(dev, card, anchors):
    """The demo recursion (B=2, seed 77) on the card: the outer value table,
    fixed cap and lane 0 of the outer proof equal the reference's frozen
    values; the card's verifier accepts the proof and rejects a tampered one."""
    from plonky2_ecdsa_tpu_torch.circuit import recursive_verifier as rv
    from plonky2_ecdsa_tpu_torch.circuit.examples import recursion_demo_configs
    from plonky2_ecdsa_tpu_torch.prover import prover, verifier
    from plonky2_ecdsa_tpu_torch.prover.data import build_circuit_data
    from plonky2_ecdsa_tpu_torch.utils.debug import gate_histogram, value_table_digest

    t0 = time.time()
    batch = anchors["recursion_demo_batch"]
    idata, iproof = demo_inner_proof(batch, anchors["recursion_demo_seed"], dev)
    verifier.verify_strict(idata, iproof)
    oc = rv.verifier_circuit(idata, recursion_demo_configs()[1])
    vals = oc.value_table(rv.recursive_verifier_inputs(idata, iproof), batch)
    opis = oc.public_input_values()
    assert np.array_equal(opis, iproof.pis), "the inner PIs are not re-exported"
    assert value_table_digest(vals) == anchors["recursion_demo_table_sha256"], \
        "the demo outer value table differs from the reference's"
    odata = build_circuit_data(oc, dev)
    assert hex_words(odata.fixed_tree.cap) == anchors["recursion_demo_fixed_cap"], \
        "the demo outer fixed cap differs from the reference's"
    proof = no_fallback(lambda: prover.Prover(odata).run_vals(vals, opis))
    assert prover.proof_digest(proof, lane=0) == anchors["recursion_demo_lane0_proof_sha256"], \
        "lane 0 of the demo outer proof differs from the reference's"
    verifier.verify_strict(odata, proof)
    bad = prover.Proof(**{**proof.__dict__, "pis": proof.pis.copy()})
    bad.pis[1, 2] ^= np.uint64(1)
    rejected = rejection(odata, bad)
    assert "lane 1" in rejected
    print(f"demo recursion B={batch} on {dev}: outer n={oc.n} N={odata.N} "
          f"({gate_histogram(oc)}); value table, outer fixed cap and lane 0 of the outer proof equal "
          f"the reference's frozen values; verify_strict accepts the outer proof; a flipped pis "
          f"bit of lane 1 rejected ({rejected}); {time.time() - t0:.1f} s  ({card.line})")


def production_recursion(system, dev, card, rows, anchors):
    """bench_recursive's path on the card: B=8 secp256k1 inner proofs ->
    the verifier circuit under recursion_ecc_config (outer n = 2^14, N = 2^17,
    28 queries, 16 PoW bits) -> fixed commit -> witness through the native
    tape -> the outer proof, first and in steady state -> verify."""
    from plonky2_ecdsa_tpu_torch import api
    from plonky2_ecdsa_tpu_torch.circuit import recursive_verifier as rv
    from plonky2_ecdsa_tpu_torch.circuit.config import CircuitConfig
    from plonky2_ecdsa_tpu_torch.circuit.witness import check_constraints
    from plonky2_ecdsa_tpu_torch.prover import prover, verifier
    from plonky2_ecdsa_tpu_torch.prover.data import build_circuit_data
    from plonky2_ecdsa_tpu_torch.utils.debug import (gate_histogram, gate_rows_used,
                                                     structure_digest, witness_violations)

    idata = system.data
    stmts = api.random_statements(api.SECP256K1, REC_BATCH, seed=REC_SEED)
    t0 = time.time()
    iproof = system.prover.run_vals(*system.witness_vals(stmts))
    verifier.verify_strict(idata, iproof)
    inner_s = time.time() - t0
    ipis = iproof.pis

    t0 = time.time()
    config = CircuitConfig.recursion_ecc_config()
    oc = rv.verifier_circuit(idata, config)
    build_s = time.time() - t0
    nrows = gate_rows_used(oc)
    assert (oc.n, nrows, gate_histogram(oc)) == (anchors["recursion_ecc_n"], anchors["recursion_ecc_rows"],
                                            anchors["recursion_ecc_gates"]), \
        "the outer circuit's shape differs from the reference's"
    assert structure_digest(oc) == anchors["recursion_ecc_structure_sha256"], \
        "the outer circuit's structure differs from the reference's"
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    odata = build_circuit_data(oc, dev)
    torch.cuda.synchronize()
    commit_s = time.time() - t0
    assert hex_words(odata.fixed_tree.cap) == anchors["recursion_ecc_fixed_cap"], \
        "the outer fixed cap differs from the reference's"
    t0 = time.time()
    inputs = rv.recursive_verifier_inputs(idata, iproof)
    vals = oc.value_table(inputs, REC_BATCH)
    witness_s = time.time() - t0
    assert oc.last_tape_native, "the outer witness did not run through the native tape"
    native_ops = oc._native_tape().n_native
    opis = oc.public_input_values()
    assert np.array_equal(opis, ipis), "the outer PIs are not the inner statements' limbs"
    t0 = time.time()
    run = prover.Prover(odata)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    print(f"recursion: inner secp256k1 B={REC_BATCH} (seed {REC_SEED}) proved and verified "
          f"{inner_s:.1f} s; outer circuit n={oc.n} ({nrows} rows: {gate_histogram(oc)}) built "
          f"{build_s:.1f} s, structure equals the reference's; N={odata.N}, "
          f"{odata.fixed_values.shape[0]} fixed columns, fixed commit on the card "
          f"{commit_s:.2f} s (cap equals the reference's); witness B={REC_BATCH} through the "
          f"native tape ({native_ops} of {len(oc.tape)} ops native, {vals.shape[0]} targets) "
          f"{witness_s:.1f} s; prover set-up {setup_s:.2f} s  ({card.line})")

    for r in rows:
        r["fn"].launches = 0
    t0 = time.time()
    proof = no_fallback(lambda: run.run_vals(vals, opis))
    first_s = time.time() - t0
    for r in rows:
        r["launches_recursive"] = r["fn"].launches
    print("recursion: outer proof kernel launches a batch: "
          + ", ".join(f"{r['name']}={r['launches_recursive']}" for r in rows))
    assert all(r["launches_recursive"] > 0 for r in rows), "a kernel of the outer path was not launched"

    def steady():
        pending, proofs = None, []
        for _ in range(STEADY_BATCHES):
            handle = run.dispatch_vals(vals, opis)
            if pending is not None:
                proofs.append(run.collect(pending))
            pending = handle
        proofs.append(run.collect(pending))
        return proofs

    t0 = time.time()
    again = no_fallback(steady)
    steady_s = (time.time() - t0) / STEADY_BATCHES
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert all(prover.first_difference(proof, p) is None for p in again), \
        "outer proving is not deterministic"
    print(f"recursion: first outer prove {first_s:.2f} s; steady state {steady_s:.2f} s/batch = "
          f"{REC_BATCH / steady_s:.3f} outer proofs/s at B={REC_BATCH} over {STEADY_BATCHES} "
          f"batches (dispatch_vals/collect); peak device memory {peak:.1f} GiB  ({card.line})")

    t0 = time.time()
    verifier.verify_strict(odata, proof)
    torch.cuda.synchronize()
    verify_s = time.time() - t0
    t0 = time.time()
    assert verifier.verify_one_exact(odata, proof, 0), "lane 0 fails the exact verifier"
    exact_s = time.time() - t0
    assert np.array_equal(proof.pis, ipis)

    # one inner statement limb flipped: the outer witness is well formed
    # (the sanitizer finds nothing) but no longer satisfies the circuit
    bad = prover.Proof(**{**iproof.__dict__, "pis": iproof.pis.copy()})
    bad.pis[0, 0] ^= np.uint64(1)
    Wb = oc.generate_witness(rv.recursive_verifier_inputs(idata, bad), REC_BATCH)[..., :1]
    sanitizer = witness_violations(oc, Wb)
    failures = check_constraints(oc, Wb, oc.public_input_values()[:1], raise_on_fail=False)
    assert failures, "a flipped inner statement still satisfies the outer circuit"
    print(f"recursion: verify_strict accepts the outer proof ({verify_s:.2f} s), verify_one_exact "
          f"lane 0 True ({exact_s:.1f} s), outer PIs = the {ipis.shape[1]} statement limbs of "
          f"each inner lane; one inner statement limb of lane 0 flipped: witness sanitizer "
          f"{sanitizer}, violated constraints {failures}  ({card.line})")


def check_aggregation(dev, card):
    """4 demo proofs -> 2 -> 1 on the card (the reference's 4-to-1 test):
    the root proof verifies and binds the four statements in lane order; a
    flipped leaf statement breaks the level-1 witness."""
    from plonky2_ecdsa_tpu_torch.circuit import recursive_verifier as rv
    from plonky2_ecdsa_tpu_torch.circuit.examples import recursion_demo_configs
    from plonky2_ecdsa_tpu_torch.circuit.witness import check_constraints
    from plonky2_ecdsa_tpu_torch.prover import prover, verifier
    from plonky2_ecdsa_tpu_torch.prover.data import build_circuit_data

    t0 = time.time()
    agg = recursion_demo_configs()[2]
    idata, iproof = demo_inner_proof(AGG_BATCH, AGG_SEED, dev)
    verifier.verify_strict(idata, iproof)
    level, data, proof, sizes = iproof.pis, idata, iproof, []
    for lanes in (AGG_BATCH // 2, AGG_BATCH // 4):
        ac = rv.verifier_circuit(data, agg, aggregate=True)
        vals = ac.value_table(rv.aggregation_inputs(data, rv.split_proof_lanes(proof)), lanes)
        apis = ac.public_input_values()
        assert np.array_equal(apis, np.concatenate([level[0::2], level[1::2]], axis=1))
        if lanes == AGG_BATCH // 2:
            level1 = ac
        data = build_circuit_data(ac, dev)
        proof = no_fallback(lambda: prover.Prover(data).run_vals(vals, apis))
        verifier.verify_strict(data, proof)
        level = apis
        sizes.append(ac.n)
    root = proof.pis[0].reshape(AGG_BATCH, iproof.pis.shape[1])
    assert np.array_equal(root, iproof.pis), "the root proof does not bind the four statements"
    bad = prover.Proof(**{**iproof.__dict__, "pis": iproof.pis.copy()})
    bad.pis[2, 0] ^= np.uint64(1)
    Wb = level1.generate_witness(rv.aggregation_inputs(idata, rv.split_proof_lanes(bad)),
                                 AGG_BATCH // 2)
    failures = check_constraints(level1, Wb, level1.public_input_values(), raise_on_fail=False)
    assert failures, "a flipped leaf statement still aggregates"
    print(f"aggregation: {AGG_BATCH} demo proofs -> 2 (n={sizes[0]}) -> 1 (n={sizes[1]}) on the "
          f"card, every level verified; the root proof's PIs are the four statements' PIs in "
          f"lane order; a flipped statement of leaf 2 breaks the level-1 witness ({failures}); "
          f"{time.time() - t0:.1f} s  ({card.line})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from plonky2_ecdsa_tpu_torch import _build, native

    start = time.time()
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
    check_demo_recursion(dev, card, anchors)
    system, vals, pis, proof = main_path("secp256k1", dev, card, rows, anchors)
    check_fallback(system, vals, pis, proof, card)
    check_command_line(system, dev, card)
    del vals, pis, proof
    production_recursion(system, dev, card, rows, anchors)
    del system
    main_path("p256", dev, card, rows, anchors)
    check_wide_config(dev, card)
    check_aggregation(dev, card)
    assert sys.modules["jax"] is None and sys.modules["plonky2_ecdsa_tpu"] is None
    assert not [m for m in sys.modules if m.startswith(("jax.", "plonky2_ecdsa_tpu."))]
    for r in rows:
        del r["fn"]
    print(f"chip_smoke: every phase passed in {time.time() - start:.1f} s")
    print(card.line)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
