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
     this code's own instruction count fills; the quotient's field kernels
     (csrc/field.cu: mul, add, sub, the weighted sum dot_mod) likewise, on
     the operands of a B=32 domain chunk and of one outer B=8 operation; and
     FRI's reduced polynomial (csrc/fri.cu) over the whole domain of the
     secp256k1 and P-256 B=32 and the outer B=8 layouts, as the prover
     launches it;
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
     to 0 just before it, read just after: the Prover captures its device side
     as CUDA graphs at the first batch and every batch replays them, so the
     launches a batch are the replays' launches, each graph's launches counted
     at its capture), and times steady-state batches (replays, none of which
     launches a kernel eagerly);
  5. a wide value on the card: a forged value table (a value of 41 bits
     under a 29-bit limb's slot) goes up whole, its proof equal to the
     full-witness path's proof of the forged witness, and is rejected;
  6. the command line in this process, into a temporary directory: sign ->
     build -> prove -> verify (exit 0), verify against a changed statement
     (exit 1), and the saved circuit data loaded back onto the card proving
     to the same digest;
  7. the recursion path (bench.py's bench_recursive), reusing the secp256k1
     system: B=8 inner proofs (seed 11) -> the verifier circuit under
     recursion_ecc_config (outer n = 2^14, N = 2^17, 28 queries, 16 PoW
     bits; structure and fixed cap against the reference's frozen values)
     -> witness through the native tape (lane 0 against the reference's
     frozen B=1 value table) -> the outer proof (kernel counts set to 0 just
     before the first, read just after), steady state through
     dispatch_vals/collect -> verify_strict and verify_one_exact; the outer
     PIs are the inner statements' limbs, and a flipped inner statement limb
     breaks the outer witness;
  8. one B=2 secp256k1 proof under wide_ecc_config (234 wires, 176 routed);
  9. aggregation: 4 demo proofs -> 2 -> 1 through the 2-to-1 verifier
     circuit; the root proof verifies and binds the four statements in order;
 10. the witness sanitizer on the card over the B=32 witness (all zero; one
     corrupted value gives the numpy counts) and the limb engine's tensor half
     on the card against its numpy half;
 11. the mesh (parallel/mesh.py) in spawned ranks, one card: (a) NCCL, world
     1; (b) gloo, world 2, both ranks on cuda:0, grids (dp 2, col 1) and (dp 1,
     col 2), the B=32 secp256k1 batch through make_mesh_prover(...).run_vals
     at full width, each giving the main path's digest; (c) gloo, world 4 on
     cuda:0, the demo circuit on (dp 2, col 2) and (dcn 2, dp 1, col 2), the
     reference's frozen demo digest.  Each rank's kernel launches (counts set
     to 0 just before its run) are all above 0.  The kernel phase holds the
     sponge on a strided domain slice, as the col axis hands it, against the
     plain sponge of the copied slice;
 12. the quotient's stacked constraint evaluation, for every gate of the
     secp256k1 B=32, P-256 B=32 and outer B=8 circuits: Gate.eval_stacked
     against torch.stack of Gate.eval on one DOMAIN_CHUNK slice of random
     canonical values of the real shape ([32, 128, 2^14], the outer [8, 136,
     2^14]), words wrong (0 required); and each circuit's quotient gate
     section in eager torch ops a domain chunk, counted outside the timed
     runs;
 13. the compiled prover (the Prover's CUDA graphs), after each main path and
     in the recursion phase: for secp256k1 B=32 and P-256 B=32 (seeds 3, 4,
     5) and the outer B=8 (inner seeds 11, 12, 13), eager prove_core + to_host
     of each witness against three replays with batch k + 1 dispatched before
     batch k is collected: equal digests, every proof verified (lane 0
     exactly), the main path's seed against the frozen anchors, launches a
     replay (counted at capture) equal to the eager launches; the graphs'
     capture and instantiation seconds, node counts and memory; each
     Prover's graphs released before the next path.
Prints the card, the checks and the numbers, then a JSON line of the
kernels, and last {"ok": true, "device": {...}}.  Without a CUDA device, or
without the port beside it, it exits nonzero and prints no result.  JAX and
the reference package are blocked for the whole run: the port stands alone.
No failure is caught and nothing carries on on the CPU.  The mesh ranks import
this file (spawn), so the run's work stays under the __main__ check.
"""

import sys

sys.modules["jax"] = None                 # any import of JAX fails loudly
sys.modules["plonky2_ecdsa_tpu"] = None   # ... and of the reference package

import concurrent.futures  # noqa: E402
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
# the witnesses of the graph prover's phase, by path: the main paths' seed and
# the recursion's, and two more each
GRAPH_SEEDS = {"secp256k1": (SEED, SEED + 1, SEED + 2), "p256": (SEED, SEED + 1, SEED + 2),
               "recursion": (REC_SEED, REC_SEED + 1, REC_SEED + 2)}
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


def zero_counts(rows):
    """Every kernel's counts to 0: its eager launches and its launches by
    graph replays."""
    for r in rows:
        r["fn"].launches = r["fn"].replayed = 0


def graph_line(stats) -> str:
    """The set-up figures of a Prover's graphs (Prover.graph_stats[key])."""
    return (f"graphs: warm-up {stats['warmup_s']:.2f} s, capture {stats['capture_s']:.2f} s, "
            f"instantiate {stats['instantiate_s']:.2f} s, nodes {stats['nodes']} "
            f"({stats['nodes_per_batch']} run a batch over {stats['domain_chunks']} domain "
            f"chunks), device memory reserved {stats['device_bytes'] / 2**30:.1f} GiB, host "
            f"memory grown {stats['host_bytes'] / 2**30:.2f} GiB")


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
             "probe_butterfly", "probe_add", "probe_sub", "probe_sum2", "probe_sum3", "probe_mac2",
             "probe_mac3", "probe_inverse")
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

    # the col axis's leaf hashing (prover._tree_sharded): rank 1 of 2's domain
    # slice of the wires LDE, a strided view the kernel reads in place, against
    # the plain sponge of the copied slice
    view = lde[..., 1 << 14:]
    assert not view.is_contiguous()
    got = poseidon_cuda.sponge(view, "poly")
    copy = view.contiguous()
    wrong = int((got != poseidon_cuda.sponge_plain(copy, "poly")).sum())
    strided_ms = cuda_ms(lambda: poseidon_cuda.sponge(view, "poly"), 10)
    copy_ms = cuda_ms(lambda: poseidon_cuda.sponge(copy, "poly"), 10)
    leaves = BATCH << 14
    strided_bound, strided_by = card.bound(view.numel() * 8 + leaves * 4 * 8,
                                           leaves * 16 * PERMUTE_OPS)
    print(f"poseidon2 sponge poly on a strided domain slice {list(view.shape)} of [{BATCH}, 128, "
          f"2^15] (strides {view.stride()}, read in place): {wrong} of {got.numel()} words wrong "
          f"against sponge_plain of the copied slice (tolerance 0); kernel {strided_ms:.3f} ms "
          f"on the view, {copy_ms:.3f} ms on a contiguous copy; bound {strided_bound:.3f} ms by "
          f"{strided_by}, this code's issue slots {card.issue_ms(leaves * 16 * per_perm):.3f} ms  "
          f"({card.line})")
    assert wrong == 0, "the sponge on a strided view disagrees with the plain version"
    del view, copy, got

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

    # the quotient's field kernels (csrc/field.cu) on operands of one flat
    # B=32 domain chunk, as the quotient hands them (strided views, broadcast
    # challenges), and one outer B=8 operation (PoseidonGate's [B, m] form)
    from plonky2_ecdsa_tpu_torch.fields import goldilocks as gl
    from plonky2_ecdsa_tpu_torch.fields import goldilocks_cuda as glc

    rng_q = np.random.default_rng(SEED + 3)
    m = 1 << 14
    w = random_field(rng_q, (BATCH, 128, m), dev)                     # a wires chunk
    warr = w.movedim(1, 0)                                            # the gates' view
    beta = random_field(rng_q, (BATCH, 1, 1), dev)
    cons = random_field(rng_q, (120, BATCH, m), dev)                  # a gate's constraints
    alphas = random_field(rng_q, (BATCH, 160), dev)[:, 40:].t()[..., None]   # [120, B, 1]
    outer = random_field(rng_q, (2, REC_BATCH, m), dev)
    per_lazy = sass["probe_mul_lazy"] - sass["probe_base"]
    per_add = sass["probe_add"] - sass["probe_base"]
    per_sub = sass["probe_sub"] - sass["probe_base"]
    per_add96 = sass["probe_sum3"] - sass["probe_sum2"]
    print(f"SASS instructions this code executes per thread: one canonical add {per_add}, one "
          f"canonical subtract {per_sub}, one 96-bit add of a word (a reduction's step, with "
          f"the lazy multiply {per_lazy} in a weighted one) {per_add96}  ({card.line})")
    n_mul, n_add, n_dot = BATCH * 80 * m, BATCH * m, 120 * BATCH * m
    # (name, wrapper, operands, kernel, plain, words read and written, needed
    # operations, this code's operations by the SASS probes, what)
    cases = [
        ("field_mul", glc.mul, (w[:, :80], beta), glc.mul, gl.mul, 2 * n_mul + BATCH,
         n_mul * MUL_OPS, n_mul * per_mul,
         "[32, 80, 2^14] strided view x [32, 1, 1] (the permutation's beta terms)"),
        ("field_add", glc.add, (w[:, 0], w[:, 1]), glc.add, gl.add, 3 * n_add,
         n_add * ADD_OPS, n_add * per_add, "two strided [32, 2^14] rows of the wires chunk"),
        ("field_sub", glc.sub, (warr[:40], warr[40:80]), glc.sub, gl.sub, 3 * 40 * n_add,
         40 * n_add * ADD_OPS, 40 * n_add * per_sub, "two [40, 32, 2^14] views of warr"),
        ("field_dot_mod", glc.dot_mod, (cons, alphas),
         lambda x, y: glc.dot_mod(x, y, 0), lambda x, y: gl.sum_mod(gl.mul(x, y), 0),
         n_dot + 120 * BATCH + n_add, n_dot * (MUL_OPS + ADD_OPS), n_dot * (per_lazy + per_add96),
         "[120, 32, 2^14] constraints against their [120, 32, 1] alpha powers -> [32, 2^14]"),
        ("field_mul_outer", glc.mul, (outer[0], outer[1]), glc.mul, gl.mul, 3 * REC_BATCH * m,
         REC_BATCH * m * MUL_OPS, REC_BATCH * m * per_mul,
         "[8, 2^14] x [8, 2^14] (one PoseidonGate operation of the outer proof)"),
    ]
    for name, fn, args, kernel, plain, words, ops, instrs, what in cases:
        err = max_abs_err(kernel(*args), plain(*args))
        assert err == 0.0, f"{name} disagrees with the plain version"
        ms = cuda_ms(lambda: kernel(*args), 50)
        plain_ms = cuda_ms(lambda: plain(*args), 5)
        bounds = row(name, "plonky2_ecdsa_tpu_torch/csrc/field.cu",
                     "none (the reference's quotient, plonky2_ecdsa_tpu/prover/prover.py:1165, "
                     "is XLA-fused jnp)", fn, err, ms, plain_ms, 8 * words, ops, instrs)
        print(f"{name} {what}: max_abs_err={err} (tolerance 0), kernel {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, {bounds}  ({card.line})")
    check_fri_reduced(dev, card, sass, row)
    return rows


# FRI's reduced polynomial (csrc/fri.cu): the layouts it runs at, (B, rows of
# the fixed, wires, zs and quotient LDEs, zs rows opened at g zeta, N)
FRI_LAYOUTS = {"fri_reduced_poly": (BATCH, (129, 128, 120, 8), 4, 1 << 15),
               "fri_reduced_poly_p256": (BATCH, (P256_FIXED_COLS, 128, P256_ZS_COLS, 8), 4,
                                         1 << 15),
               "fri_reduced_poly_outer": (REC_BATCH, (136, OUTER_WIRES, 64, 16), 2,
                                          1 << OUTER_LOG_LDE)}
INVERSE_MULS = 72              # gl::inverse's chain: 64 squares, 8 multiplies
# the least multiplies a point past its sums: two norms (3 each), Montgomery's
# trick over a thread's 2 V norms (3 a norm) and its one inversion
# (INVERSE_MULS / V a point)
FRI_NEEDED_POINT_MULS = 2 * 3 + 2 * 3
# the canonical multiplies fri.cu spends a point past its sums and its one
# inversion for two points: two norms (3 each), half the Montgomery trick
# (4 + 3 + 4 for four norms), two conjugates over the norm (2 each), three
# extension products (5 each)
FRI_POINT_MULS = 6 + 11 / 2 + 4 + 15


def check_fri_reduced(dev, card, sass, row):
    """The reduced polynomial against its plain version over the whole
    domain of each layout, the one launch a batch the prover makes."""
    from plonky2_ecdsa_tpu_torch.fields import goldilocks as gl
    from plonky2_ecdsa_tpu_torch.prover import fri_cuda

    per_mac = sass["probe_mac3"] - sass["probe_mac2"]
    per_inv = sass["probe_inverse"] - sass["probe_base"]
    per_mul = sass["probe_mul"] - sass["probe_base"]
    print(f"SASS instructions this code executes per thread: one 160-bit product sum step "
          f"(gl::mac160) {per_mac}, one inverse (gl::inverse, {INVERSE_MULS} multiplies) "
          f"{per_inv}  ({card.line})")
    gen = torch.Generator(dev).manual_seed(SEED + 4)

    def words(*shape):
        return gl._canon(torch.randint(-(1 << 63), (1 << 63) - 1, shape, dtype=torch.int64,
                                       device=dev, generator=gen))

    for name, (B, rows, K, N) in FRI_LAYOUTS.items():
        T = sum(rows)
        lde = (words(rows[0], N), *(words(B, r, N) for r in rows[1:]))
        lanes = [(words(B), words(B)) for _ in range(3)]
        args = (words(N), lde, tuple(range(0, rows[2], rows[2] // K))[:K], *lanes,
                (words(B, T), words(B, T)), (words(B, K), words(B, K)))
        got, want = fri_cuda.reduced_poly(*args), fri_cuda.reduced_poly_plain(*args)
        err = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
        assert err == 0.0, f"{name} disagrees with the plain version"
        ms = cuda_ms(lambda: fri_cuda.reduced_poly(*args), 10)
        plain_ms = cuda_ms(lambda: fri_cuda.reduced_poly_plain(*args), 2)
        pairs = B * N
        nbytes = 8 * (N * (B * sum(rows[1:]) + rows[0] + 1 + 2 * B) + 2 * B * (3 + T + K))
        ops = pairs * ((T + K) * 2 * (MUL_OPS + ADD_OPS)
                       + (FRI_NEEDED_POINT_MULS + INVERSE_MULS / fri_cuda.V) * MUL_OPS)
        instrs = pairs * ((T + K) * 2 * per_mac + per_inv / fri_cuda.V + FRI_POINT_MULS * per_mul)
        bounds = row(name, "plonky2_ecdsa_tpu_torch/csrc/fri.cu",
                     "none (the reference's reduction, plonky2_ecdsa_tpu/prover/prover.py:1406, "
                     "is XLA-fused jnp)", fri_cuda.reduced_poly, err, ms, plain_ms, nbytes, ops,
                     instrs)
        print(f"{name} [{B}, {T}, 2^{N.bit_length() - 1}] (rows {'x'.join(map(str, rows))}, "
              f"{K} at g zeta; the whole domain, one launch a batch): max_abs_err={err} "
              f"(tolerance 0), kernel {ms:.4f} ms, plain {plain_ms:.3f} ms "
              f"({-(-N // fri_cuda.PLAIN_CHUNK)} chunks), {bounds}, by bytes "
              f"{nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms, by operations {card.issue_ms(ops):.3f} ms"
              f"  ({card.line})")
        del lde, args, got, want


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

    zero_counts(rows)
    t0 = time.time()
    proof = run.run_vals(vals, pis)
    first_s = time.time() - t0
    key = "launches" if name == "secp256k1" else f"launches_{name}"
    for r in rows:
        r[key] = r["fn"].replayed
    graphs = run.graph_stats[("vals", BATCH)]
    print(f"{name} main path kernel launches a batch (the first batch's graph replays): "
          + ", ".join(f"{r['name']}={r[key]}" for r in rows)
          + "; the warm-up before the capture launched "
          + ", ".join(f"{r['name']}={r['fn'].launches}" for r in rows) + "; " + graph_line(graphs))
    assert all(r[key] > 0 for r in rows), f"a kernel of the {name} path was not launched"
    assert all(r[key] == graphs["launches"][r["fn"].__name__] for r in rows)

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

    zero_counts(rows)
    t0 = time.time()
    again = [run.run_vals(vals, pis) for _ in range(STEADY_BATCHES)]
    steady_s = (time.time() - t0) / STEADY_BATCHES
    assert all(prover.first_difference(proof, p) is None for p in again), \
        "proving is not deterministic"
    assert all(r["fn"].launches == 0 and r["fn"].replayed == STEADY_BATCHES * r[key]
               for r in rows), "a steady-state batch launched a kernel outside its graphs"
    print(f"{name}: first prove (warm-up, capture, instantiate, replay) {first_s:.2f} s; steady "
          f"state (graph replays) {steady_s:.2f} s/batch = {BATCH / steady_s:.2f} proofs/s at "
          f"B={BATCH} over {STEADY_BATCHES} batches; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB  ({card.line})")
    return system, vals, pis, proof


def graph_tables(system, vals, pis, name):
    """The main path's value table and PIs, then those of the further seeds
    of GRAPH_SEEDS[name]."""
    from plonky2_ecdsa_tpu_torch import api

    return [(vals, pis)] + [system.witness_vals(api.random_statements(system.curve, BATCH,
                                                                      seed=seed))
                            for seed in GRAPH_SEEDS[name][1:]]


def check_graph_prover(name, run, tables, card, anchor=None):
    """The compiled prover against eager prove_core on three witnesses of
    one batch size (GRAPH_SEEDS): each one's eager prove_core + to_host,
    with its kernel launches; then the three through the Prover's graphs
    (captured already), batch k + 1 dispatched before batch k is collected.
    Each proof's digest equals the eager one, verify_strict accepts it and
    verify_one_exact lane 0; the first (the main path's seed) meets the
    reference's frozen lane 0 where `anchor` is given; the launches a replay
    (counted at capture) equal the eager launches, and the replays launch
    nothing eagerly.  Prints the graphs' set-up figures, with the device
    memory their captures reserved, then releases the graphs."""
    from plonky2_ecdsa_tpu_torch.prover import graph, prover, verifier

    data, batch = run.data, tables[0][0].shape[1]
    kernels = graph.KERNELS                      # every kernel the graphs count
    assert ("vals", batch) in run.graph_stats, "the graph phase replays a captured path"
    eager, eager_s, eager_launches = [], [], None
    for vals, pis in tables:
        zero_counts([dict(fn=fn) for fn in kernels])
        t0 = time.time()
        inputs = run._expand(torch.from_numpy(run._compact(vals).view(np.int64)).to(data.device))
        eager.append(prover.to_host(prover.prove_core(data, run.backend, *inputs), pis))
        eager_s.append(time.time() - t0)
        launches = {fn.__name__: fn.launches for fn in kernels}
        assert eager_launches in (None, launches), "eager launches differ between witnesses"
        eager_launches = launches
        del inputs
    zero_counts([dict(fn=fn) for fn in kernels])
    t0 = time.time()
    pending, proofs = None, []
    for vals, pis in tables:
        handle = run.dispatch_vals(vals, pis)
        if pending is not None:
            proofs.append(run.collect(pending))
        pending = handle
    proofs.append(run.collect(pending))
    replay_s = (time.time() - t0) / len(tables)
    stats = run.graph_stats[("vals", batch)]
    assert stats["launches"] == eager_launches, (stats["launches"], eager_launches)
    assert all(fn.launches == 0 and fn.replayed == len(tables) * stats["launches"][fn.__name__]
               for fn in kernels), "a replayed batch launched a kernel outside its graphs"
    digests = [prover.proof_digest(p) for p in proofs]
    assert digests == [prover.proof_digest(e) for e in eager], \
        "a replayed proof differs from the eager proof of the same witness"
    assert len(set(digests)) == len(tables), "two witnesses gave one proof"
    if anchor is not None:
        assert prover.proof_digest(proofs[0], lane=0) == anchor, \
            "lane 0 of the replayed proof differs from the reference's"
    t0 = time.time()
    for p in proofs:
        verifier.verify_strict(data, p)
        assert verifier.verify_one_exact(data, p, 0), "lane 0 fails the exact verifier"
    verify_s = time.time() - t0
    frozen = (f"; seed {GRAPH_SEEDS[name][0]} lane 0 equals the reference (frozen)"
              if anchor is not None else "")
    print(f"{name} graph prover B={batch}, seeds {GRAPH_SEEDS[name]}: two batches in flight, "
          f"every proof's digest equals eager prove_core + to_host of its witness{frozen}; "
          f"verify_strict and verify_one_exact lane 0 accept all three ({verify_s:.1f} s); "
          f"launches a replay (counted at capture) {stats['launches']} = eager; eager "
          f"{[round(t, 2) for t in eager_s]} s, replays {replay_s:.2f} s/batch; "
          f"{graph_line(stats)}  ({card.line})")
    run.release()


def check_stacked_gates(name, circuit, batch, dev, card):
    """Every gate's eval_stacked (what the quotient calls) against the stack
    of its eval list on the card, on one DOMAIN_CHUNK slice of random
    canonical wires [batch, wires, chunk], constant and PI columns, in the
    quotient's calling convention; then the circuit's quotient gate section
    in eager ops a domain chunk, and each gate's stacked and per-constraint
    ops (counts do not depend on the shape)."""
    from plonky2_ecdsa_tpu_torch.circuit.algebra import TorchAlgebra
    from plonky2_ecdsa_tpu_torch.circuit.gates import Gate
    from plonky2_ecdsa_tpu_torch.prover import prover
    from plonky2_ecdsa_tpu_torch.utils.debug import EagerOpCounter, quotient_gate_ops

    cfg = circuit.config
    section = quotient_gate_ops(circuit.gates, cfg.num_constant_cols, cfg.num_challenges, dev)
    m = prover.DOMAIN_CHUNK
    rng = np.random.default_rng(SEED)
    w = random_field(rng, (batch, cfg.num_wires, m), dev)
    consts = list(random_field(rng, (cfg.num_constant_cols, 1, m), dev).unbind(0))
    ctx = {"pi_vals": list(random_field(rng, (8, batch, m), dev).unbind(0))}
    alg = TorchAlgebra((batch, m), dev)
    ops_stacked = ops_default = 0
    report = []
    t0 = time.time()
    for gate in circuit.gates:
        if gate.num_constraints == 0:
            continue
        warr = w[:, :gate.num_wires].movedim(1, 0)
        with EagerOpCounter() as stacked:
            got = gate.eval_stacked(alg, warr, consts, ctx)
        with EagerOpCounter() as default:
            want = Gate.eval_stacked(gate, alg, warr, consts, ctx)
        wrong = int((got != want).sum())
        assert got.shape == (gate.num_constraints, batch, m) and wrong == 0, \
            f"{name}: {gate.gate_id()} eval_stacked has {wrong} words wrong"
        ops_stacked += stacked.count
        ops_default += default.count
        report.append(f"{gate.gate_id()} {wrong} ({stacked.count} / {default.count} ops)")
        del got, want
    torch.cuda.synchronize()
    print(f"{name}: eval_stacked against the stacked eval on the card, [{batch}, "
          f"{cfg.num_wires}, {m}] random canonical wires, words wrong (stacked / per-constraint "
          f"ops) by gate: {'; '.join(report)}  ({time.time() - t0:.1f} s)")
    print(f"{name}: the quotient's gate section issues {section} eager torch ops a domain chunk "
          f"(eval_stacked and the alpha-weighting); the gates' stacked forms {ops_stacked} ops, "
          f"their per-constraint forms {ops_default}  ({card.line})")


def rejection(data, proof) -> str:
    """The VerifyError with which the port's verifier rejects `proof`; an
    accepted proof, or any other exception, ends the run."""
    from plonky2_ecdsa_tpu_torch.prover import verifier

    try:
        verifier.verify_strict(data, proof)
    except verifier.VerifyError as e:
        return str(e)
    raise AssertionError("a proof that must be rejected was accepted")


def check_wide_value(system, vals, pis, proof, card):
    """A value of 2^40 goes up whole on the card, on the first four lanes of
    the secp256k1 batch: a forged table, bit 40 set in lane 0 under a 29-bit
    product limb of mul_nn (a slot the reference sends in its u32 plane).
    The run_vals proof equals prover.prove of the forged witness leaf for
    leaf, no "wide" graphs exist, and (the forged value being wrong for the
    circuit) lane 0 is rejected, so the 64-bit value went up and no
    truncation; the honest table then proves to the main path's lane 0."""
    from plonky2_ecdsa_tpu_torch.prover import prover

    lanes = 4
    vals, pis, data = np.ascontiguousarray(vals[:, :lanes]), pis[:lanes], system.data
    circuit, run = system.circuit, system.prover
    up = np.setdiff1d(circuit.pos_tids, np.concatenate([circuit.derived_tids, circuit.pi_tids]))
    tid = next(int(t) for op in circuit.tape if op.rec is not None and op.rec[0] == "mul_nn"
               for t in circuit.read_map[np.ravel(op.rec[1]["r"])] if t in up)
    forged = vals.copy()
    forged[tid, 0] |= np.uint64(1) << np.uint64(40)
    got = run.run_vals(forged, pis)
    assert ("wide", lanes) not in run.graph_stats, "the forged table took the full-witness path"
    want = prover.prove(data, circuit.witness_matrix(forged), pis)
    assert prover.first_difference(want, got) is None, \
        "the forged table's proof differs from the full-witness proof of the forged witness"
    rejected = rejection(data, got)
    assert "lane 0" in rejected
    honest = run.run_vals(vals, pis)
    assert prover.proof_digest(honest, lane=0) == prover.proof_digest(proof, lane=0)
    print(f"wide value, forged table B={lanes} (bit 40 under mul_nn's limb, target {tid}): the "
          f"run_vals proof equals the full-witness proof of the forged witness leaf for leaf, no "
          f"'wide' graphs; VerifyError: {rejected}; the honest table's lane 0 equals the main "
          f"path's  ({card.line})")


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
    proof = prover.Prover(odata).run_vals(vals, opis)
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
                                                     structure_digest, value_table_digest,
                                                     witness_violations)

    idata = system.data
    t0 = time.time()
    inner = [system.prover.run_vals(*system.witness_vals(
        api.random_statements(api.SECP256K1, REC_BATCH, seed=seed)))
        for seed in GRAPH_SEEDS["recursion"]]
    iproof = inner[0]
    verifier.verify_strict(idata, iproof)
    inner_s = time.time() - t0
    ipis = iproof.pis
    system.prover.release()          # the outer proof's memory is measured alone

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
    assert anchors["recursion_ecc_seed"] == REC_SEED
    assert value_table_digest(vals[:, :1]) == anchors["recursion_ecc_lane0_table_sha256"], \
        "lane 0 of the outer value table differs from the reference's"
    t0 = time.time()
    run = prover.Prover(odata)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    print(f"recursion: inner secp256k1 B={REC_BATCH} (seeds {GRAPH_SEEDS['recursion']}) proved, "
          f"seed {REC_SEED} verified, {inner_s:.1f} s; outer circuit"
          f" n={oc.n} ({nrows} rows: {gate_histogram(oc)}) built "
          f"{build_s:.1f} s, structure equals the reference's; N={odata.N}, "
          f"{odata.fixed_values.shape[0]} fixed columns, fixed commit on the card "
          f"{commit_s:.2f} s (cap equals the reference's); witness B={REC_BATCH} through the "
          f"native tape ({native_ops} of {len(oc.tape)} ops native, {vals.shape[0]} targets) "
          f"{witness_s:.1f} s, lane 0 equals the reference's B=1 value table (frozen); prover "
          f"set-up {setup_s:.2f} s  ({card.line})")

    zero_counts(rows)
    t0 = time.time()
    proof = run.run_vals(vals, opis)
    first_s = time.time() - t0
    for r in rows:
        r["launches_recursive"] = r["fn"].replayed
    graphs = run.graph_stats[("vals", REC_BATCH)]
    print("recursion: outer proof kernel launches a batch (the first batch's graph replays): "
          + ", ".join(f"{r['name']}={r['launches_recursive']}" for r in rows)
          + "; the warm-up before the capture launched "
          + ", ".join(f"{r['name']}={r['fn'].launches}" for r in rows) + "; " + graph_line(graphs))
    assert all(r["launches_recursive"] > 0 for r in rows), "a kernel of the outer path was not launched"
    assert all(r["launches_recursive"] == graphs["launches"][r["fn"].__name__] for r in rows)

    def steady():
        pending, proofs = None, []
        for _ in range(STEADY_BATCHES):
            handle = run.dispatch_vals(vals, opis)
            if pending is not None:
                proofs.append(run.collect(pending))
            pending = handle
        proofs.append(run.collect(pending))
        return proofs

    zero_counts(rows)
    t0 = time.time()
    again = steady()
    steady_s = (time.time() - t0) / STEADY_BATCHES
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert all(prover.first_difference(proof, p) is None for p in again), \
        "outer proving is not deterministic"
    assert all(r["fn"].launches == 0
               and r["fn"].replayed == STEADY_BATCHES * r["launches_recursive"]
               for r in rows), "a steady-state outer batch launched a kernel outside its graphs"
    print(f"recursion: first outer prove (warm-up, capture, instantiate, replay) {first_s:.2f} s; "
          f"steady state (graph replays) {steady_s:.2f} s/batch = {REC_BATCH / steady_s:.3f} "
          f"outer proofs/s at B={REC_BATCH} over {STEADY_BATCHES} batches "
          f"(dispatch_vals/collect); peak device memory {peak:.1f} GiB  ({card.line})")

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

    tables = [(vals, opis)]
    for other in inner[1:]:
        tables.append((oc.value_table(rv.recursive_verifier_inputs(idata, other), REC_BATCH),
                       oc.public_input_values()))
    check_graph_prover("recursion", run, tables, card)
    del tables
    check_stacked_gates("recursion", oc, REC_BATCH, dev, card)


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
        proof = prover.Prover(data).run_vals(vals, apis)
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


# ---------------------------------------------------------------------------
# the sanitizer and the limbs on the card
# ---------------------------------------------------------------------------

def check_sanitizer_and_limbs(system, vals, pis, dev, card):
    """The witness sanitizer on the card over the B=32 witness: all zero,
    and one corrupted value gives the numpy counts, and prover.prove, armed
    by PLONKY2_TPU_DEBUG=1, refuses it; the limb engine's mul, add, sub and
    convert on the card equal the numpy half on random 256-bit inputs."""
    from plonky2_ecdsa_tpu_torch.circuit.gates import RangeLookupGate
    from plonky2_ecdsa_tpu_torch.fields import limbs as lb
    from plonky2_ecdsa_tpu_torch.prover import prover
    from plonky2_ecdsa_tpu_torch.utils.debug import witness_violations

    circuit = system.circuit
    W = circuit.witness_matrix(vals)                            # [wires, n, B] u64
    t0 = time.time()
    on_card = witness_violations(circuit, torch.from_numpy(W.view(np.int64)).to(dev))
    card_s = time.time() - t0
    assert not any(on_card.values()), f"the honest B={BATCH} witness has violations: {on_card}"
    gi, g = next((gi, g) for gi, g in enumerate(circuit.gates)
                 if isinstance(g, RangeLookupGate) and len(circuit.gate_rows[gi]))
    bad = W.copy()
    bad[g.wire_value(0), int(circuit.gate_rows[gi][0]), 5] = np.uint64((1 << 64) - 3)   # lane 5
    t0 = time.time()
    host = witness_violations(circuit, bad)
    host_s = time.time() - t0
    got = witness_violations(circuit, torch.from_numpy(bad.view(np.int64)).to(dev))
    assert got == host and got["canonicity"] == 1 and got[f"range_{g.bits}"] > 0, (got, host)
    os.environ["PLONKY2_TPU_DEBUG"] = "1"            # prover.prove checks the uploaded wires
    try:
        prover.prove(system.data, np.ascontiguousarray(bad[..., 4:6]), pis[4:6])
    except AssertionError as e:
        armed = str(e)
    else:
        raise AssertionError("PLONKY2_TPU_DEBUG=1 let a corrupted witness through prove")
    finally:
        del os.environ["PLONKY2_TPU_DEBUG"]
    assert "canonicity" in armed and "range" in armed, armed
    print(f"witness sanitizer on the card, the B={BATCH} witness {list(W.shape)}: {on_card} "
          f"({card_s:.2f} s); one value set to 2^64 - 3 under a range_{g.bits} pool: card {got} "
          f"== numpy ({host_s:.2f} s); prover.prove with PLONKY2_TPU_DEBUG=1 on lanes 4-5 "
          f"raises: {armed}  ({card.line})")

    rng = np.random.default_rng(SEED)
    L = lb.num_limbs(256)
    a = lb.from_ints([int.from_bytes(rng.bytes(32), "little") for _ in range(1024)], L)
    b = lb.from_ints([int.from_bytes(rng.bytes(32), "little") for _ in range(1024)], L)
    ta, tb = (torch.from_numpy(x.astype(np.int64)).to(dev) for x in (a, b))
    for name, fn in (("mul", lb.mul), ("add", lb.add), ("sub", lambda x, y: lb.sub(x, y)[0]),
                     ("borrow", lambda x, y: lb.sub(x, y)[1]),
                     ("convert 16->29", lambda x, _y: lb.convert(x, 16, 29, 9))):
        got = fn(ta, tb)
        assert got.device == dev, got.device
        assert np.array_equal(got.cpu().numpy().astype(np.uint32), fn(a, b)), \
            f"limbs {name} on the card differs from numpy"
    print(f"limbs on the card: mul, add, sub (with borrow), convert 16->29 on 1024 random 256-bit "
          f"pairs equal the numpy half")


# ---------------------------------------------------------------------------
# the mesh (parallel/mesh.py) on the card: one card, so world 1 under NCCL and
# ranks sharing cuda:0 under gloo; each rank a spawned process
# ---------------------------------------------------------------------------

MESH_TIMEOUT_S = 300
# phase -> (backend, world, circuit, [(grid name, dcn or None, dp, col)])
MESH_PHASES = {
    "a": ("nccl", 1, "secp256k1", [("dp1_col1", None, 1, 1)]),
    "b": ("gloo", 2, "secp256k1", [("dp2_col1", None, 2, 1), ("dp1_col2", None, 1, 2)]),
    "c": ("gloo", 4, "demo", [("dp2_col2", None, 2, 2), ("dcn2_dp1_col2", 2, 1, 2)]),
}


def mesh_rank(rank, phase, tmp):
    """One rank of a mesh phase (a spawned process): the circuit data and the
    inputs from files the parent wrote, the kernels as the parent built them;
    for each grid, this rank's kernel launches over one run (counts set to 0
    just before it), the proof's digest, and for the B=32 grids a second,
    timed run.  Results go to a JSON file; nothing is printed."""
    import datetime

    import torch.distributed as dist

    from plonky2_ecdsa_tpu_torch.fields import goldilocks_cuda
    from plonky2_ecdsa_tpu_torch.hash import poseidon_cuda
    from plonky2_ecdsa_tpu_torch.parallel import mesh
    from plonky2_ecdsa_tpu_torch.prover import fri_cuda, ntt_cuda, prover, serialize

    backend, world, circuit, grids = MESH_PHASES[phase]
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{tmp}/store_{phase}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        out = {}
        if backend == "gloo":
            x = torch.full((3,), rank, dtype=torch.int64, device="cuda")
            parts = [torch.empty_like(x) for _ in range(world)]
            dist.all_gather(parts, x)
            want = torch.arange(world, device="cuda").repeat_interleave(3)
            assert torch.equal(torch.cat(parts), want), "gloo's CUDA all_gather is wrong"
            out["gloo_cuda_all_gather"] = [str(p.device) for p in parts]
        data = serialize.load_circuit_data(os.path.join(tmp, f"{circuit}.npz"), "cuda:0")
        with np.load(os.path.join(tmp, f"{circuit}_inputs.npz")) as z:
            inputs = {k: z[k] for k in z.files}
        kernels = (poseidon_cuda.permute, poseidon_cuda.sponge, poseidon_cuda.grind,
                   ntt_cuda.sub_ntt, goldilocks_cuda.add, goldilocks_cuda.sub,
                   goldilocks_cuda.mul, goldilocks_cuda.dot_mod, fri_cuda.reduced_poly)
        for name, dcn, dp, col in grids:
            m = (mesh.prover_mesh(col_parallel=col) if dcn is None
                 else mesh.prover_mesh_2level(dcn, dp * col, col_parallel=col))
            run = mesh.make_mesh_prover(data, m)

            def prove():
                if circuit == "demo":
                    return run(inputs["W"], inputs["pis"])
                return run.run_vals(inputs["vals"], inputs["pis"])

            for fn in kernels:
                fn.launches = 0
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.time()
            proof = prove()
            first_s = time.time() - t0
            res = dict(mesh=dict(zip(m.mesh_dim_names, m.shape)), digest=prover.proof_digest(proof),
                       launches={fn.__name__: fn.launches for fn in kernels}, first_s=first_s)
            if circuit != "demo":
                torch.cuda.synchronize()
                dist.barrier()
                t0 = time.time()
                again = prove()
                res["steady_s"] = time.time() - t0
                assert prover.first_difference(proof, again) is None
            out[name] = res
        with open(os.path.join(tmp, f"{phase}_{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_mesh_phase(phase, tmp):
    """Spawn the phase's ranks; every one must exit 0 within MESH_TIMEOUT_S
    (a rank still running then is killed and the run fails)."""
    import torch.multiprocessing as torch_mp

    ctx = torch_mp.get_context("spawn")
    world = MESH_PHASES[phase][1]
    procs = [ctx.Process(target=mesh_rank, args=(r, phase, tmp)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.time() + MESH_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.time()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for r in hung:
        procs[r].kill()
        procs[r].join()
    assert not hung, f"mesh phase {phase}: ranks {hung} still running after {MESH_TIMEOUT_S} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"mesh phase {phase}: exit codes {codes}"
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"{phase}_{r}.json")) as f:
            out.append(json.load(f))
    return out


def check_mesh(system, vals, pis, proof, dev, card, rows, anchors):
    """The mesh phases: (a) NCCL, world 1; (b) gloo, world 2, both ranks on
    cuda:0, grids (dp 2, col 1) and (dp 1, col 2), the B=32 secp256k1 main
    path through make_mesh_prover(...).run_vals at full width, each grid's
    digest the main path's; (c) gloo, world 4 on cuda:0, the demo circuit on
    grids (dp 2, col 2) and (dcn 2, dp 1, col 2), the demo digest frozen from
    the reference.  Every rank launched every kernel."""
    from plonky2_ecdsa_tpu_torch.circuit.examples import small_demo_circuit, small_demo_witness
    from plonky2_ecdsa_tpu_torch.prover import prover, serialize
    from plonky2_ecdsa_tpu_torch.prover.data import build_circuit_data

    digests = {"secp256k1": prover.proof_digest(proof), "demo": anchors["demo_proof_sha256"]}
    main_rows = {}                       # kernel -> its row at the main path's shapes (the first)
    for r in rows:
        main_rows.setdefault(r["fn"].__name__, r)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        serialize.save_circuit_data(system.data, os.path.join(tmp, "secp256k1.npz"))
        np.savez(os.path.join(tmp, "secp256k1_inputs.npz"), vals=vals, pis=pis)
        demo = small_demo_circuit().build()
        W, dpis = small_demo_witness(demo, anchors["demo_batch"])
        serialize.save_circuit_data(build_circuit_data(demo, dev), os.path.join(tmp, "demo.npz"))
        np.savez(os.path.join(tmp, "demo_inputs.npz"), W=W, pis=dpis)
        print(f"mesh: circuit data and inputs saved for the ranks in {time.time() - t0:.1f} s")
        for phase, (backend, world, circuit, grids) in MESH_PHASES.items():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            t0 = time.time()
            ranks = run_mesh_phase(phase, tmp)
            phase_s = time.time() - t0
            if backend == "gloo":
                print(f"mesh ({phase}): gloo's all_gather of CUDA tensors, with no staging in this "
                      f"script or the library: correct values, outputs on "
                      f"{ranks[0]['gloo_cuda_all_gather']}")
            for name, _dcn, _dp, _col in grids:
                per_rank = [res[name] for res in ranks]
                for r, g in enumerate(per_rank):
                    where = f"mesh ({phase}) {name} rank {r}"
                    assert g["digest"] == digests[circuit], \
                        f"{where}: the proof differs from the single-device one"
                    assert all(v > 0 for v in g["launches"].values()), \
                        f"{where}: a kernel was not launched: {g['launches']}"
                for kernel, row in main_rows.items():
                    row.setdefault("launches_mesh", {})[f"{phase}_{name}"] = \
                        [g["launches"][kernel] for g in per_rank]
                times = "; ".join(
                    f"rank {r}: launches {g['launches']}, first {g['first_s']:.2f} s"
                    + (f", then {g['steady_s']:.2f} s/batch" if "steady_s" in g else "")
                    for r, g in enumerate(per_rank))
                print(f"mesh ({phase}) {backend} world {world}, {circuit}, grid "
                      f"{per_rank[0]['mesh']}: every rank's proof digest "
                      f"{per_rank[0]['digest'][:16]}... equals the "
                      f"{'main path' if circuit == 'secp256k1' else 'reference demo'} digest; "
                      f"{times}  ({card.line})")
            print(f"mesh ({phase}): {world} rank(s) spawned, run and joined in {phase_s:.1f} s")


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
    check_graph_prover("secp256k1", system.prover, graph_tables(system, vals, pis, "secp256k1"),
                       card, anchors["secp256k1_lane0_proof_sha256"])
    check_stacked_gates("secp256k1", system.circuit, BATCH, dev, card)
    check_sanitizer_and_limbs(system, vals, pis, dev, card)
    check_mesh(system, vals, pis, proof, dev, card, rows, anchors)
    check_wide_value(system, vals, pis, proof, card)
    check_command_line(system, dev, card)
    del vals, pis, proof
    production_recursion(system, dev, card, rows, anchors)
    del system
    system, vals, pis, _proof = main_path("p256", dev, card, rows, anchors)
    check_graph_prover("p256", system.prover, graph_tables(system, vals, pis, "p256"), card,
                       anchors["p256_lane0_proof_sha256"])
    check_stacked_gates("p256", system.circuit, BATCH, dev, card)
    del system, vals, pis, _proof
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
