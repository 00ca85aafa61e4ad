"""Ports with no kernel of their own, each against the reference (tolerance
0): the commit (prover._lde_commit) on column counts that fill the sponge's
rate, leave a remainder and fall short of it, with the sponge's reading of
strided poly-major views (a mesh rank's domain slice); the witness sanitizer
on int64 tensors (unsigned compares, logical shifts and the u64 wrap of its
sums, on values with the top bit set) and its PLONKY2_TPU_DEBUG=1 check in
prover.prove; and the tensor half of the limb engine (fields/limbs.py)."""

import numpy as np
import pytest
import torch

from plonky2_ecdsa_tpu.circuit.examples import nonnative_mul_chain_circuit as ref_chain_circuit
from plonky2_ecdsa_tpu.fields import limbs as ref_lb
from plonky2_ecdsa_tpu.prover import prover as ref_prover
from plonky2_ecdsa_tpu.utils import debug as ref_debug
from plonky2_ecdsa_tpu_torch.api import int_to_limbs
from plonky2_ecdsa_tpu_torch.circuit.examples import (nonnative_mul_chain_circuit,
                                                      small_demo_circuit, small_demo_witness)
from plonky2_ecdsa_tpu_torch.circuit.gates import RangeLookupGate
from plonky2_ecdsa_tpu_torch.curve import native as cn
from plonky2_ecdsa_tpu_torch.fields import goldilocks as gl
from plonky2_ecdsa_tpu_torch.fields import limbs as lb
from plonky2_ecdsa_tpu_torch.hash import poseidon_cuda
from plonky2_ecdsa_tpu_torch.prover import prover
from plonky2_ecdsa_tpu_torch.prover.data import build_circuit_data
from plonky2_ecdsa_tpu_torch.prover.verifier import verify
from plonky2_ecdsa_tpu_torch.utils.debug import assert_witness_ok, witness_violations
from test_torch_bridge import pair_to_u64, u64_to_pair

# ---------------------------------------------------------------------------
# the commit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [8, 21, 3])       # whole rate blocks, a remainder, one short block
def test_commit_equals_reference(k):
    n, N, cap = 64, 256, 2
    vals = np.random.default_rng(k).integers(0, gl.P, (3, k, n), dtype=np.uint64)
    coeffs, lde, tree = prover._lde_commit(gl.from_u64(vals), N, cap)
    (rlo, rhi), rlde, rtree = ref_prover._lde_commit(u64_to_pair(vals), n, N, cap, np)
    assert np.array_equal(gl.to_u64(coeffs), pair_to_u64((rlo, rhi)))
    assert np.array_equal(gl.to_u64(lde), pair_to_u64(rlde))
    assert len(tree.levels) == len(rtree.levels)
    for lv, rlv in zip(tree.levels, rtree.levels):
        assert np.array_equal(gl.to_u64(lv), pair_to_u64(rlv))


def test_sponge_reads_a_strided_domain_slice():
    """A rank's domain slice of a poly-major LDE goes to the sponge as a view:
    its strides describe it, and the digests equal those of a copy."""
    lde = gl.from_u64(np.random.default_rng(3).integers(0, gl.P, (3, 5, 64), dtype=np.uint64))
    view = lde[..., 32:64]
    assert not view.is_contiguous()
    assert poseidon_cuda._poly_strides(view) == (3, 5 * 64)
    assert poseidon_cuda._poly_strides(lde[1:2, :, 16:48]) == (1, 0)
    assert torch.equal(poseidon_cuda.sponge(view, "poly"),
                       poseidon_cuda.sponge_plain(view.contiguous(), "poly"))
    crossed = lde.reshape(3, 1, 5, 64).expand(3, 2, 5, 64).transpose(0, 1)
    with pytest.raises(ValueError, match="flatten"):
        poseidon_cuda._poly_strides(crossed)
    with pytest.raises(ValueError, match="contiguous"):
        poseidon_cuda.sponge(lde.transpose(1, 2), "leaf")


# ---------------------------------------------------------------------------
# the witness sanitizer on tensors
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def chain():
    """tests/test_debug_sanitizer.py's chain fixture, in the port and the
    reference."""
    c, ref_c = nonnative_mul_chain_circuit().build(), ref_chain_circuit().build()
    rng = np.random.default_rng(11)
    xs = [int.from_bytes(rng.bytes(40), "little") % cn.SECP256K1.p for _ in range(2)]
    ys = [int.from_bytes(rng.bytes(40), "little") % cn.SECP256K1.p for _ in range(2)]
    W = c.generate_witness({"x": int_to_limbs(xs), "y": int_to_limbs(ys)}, 2)
    return c, ref_c, W


def _three(chain, W, reference: bool = True) -> dict:
    """The tensor form's counts, held equal to the numpy form's and (where
    the reference's own sums are exact) the reference's on the same witness.
    The reference adds its scaled-limb count, an int64, to its u64 limb sum:
    numpy makes that a float64, inexact above 2^53."""
    c, ref_c, _W = chain
    got = witness_violations(c, torch.from_numpy(W.view(np.int64)))
    assert got == witness_violations(c, W)
    if reference:
        assert got == {k: int(v) for k, v in ref_debug.witness_violations(ref_c, W).items()}
    return got


def _lookup(c, scale_above_one: bool):
    return next((gi, g) for gi, g in enumerate(c.gates)
                if isinstance(g, RangeLookupGate) and (g.scale > 1) == scale_above_one)


def test_tensor_sanitizer_on_an_honest_witness(chain):
    counts = _three(chain, chain[2])
    assert any(k.startswith("range_") for k in counts) and not any(counts.values())
    assert_witness_ok(chain[0], torch.from_numpy(chain[2].view(np.int64)).permute(2, 0, 1)
                      .contiguous().permute(1, 2, 0))          # a non-contiguous view


def test_tensor_sanitizer_on_top_bit_values(chain):
    """Values at and above 2^63 (negative as int64): the unsigned compare
    against p, and the logical shift of a pooled value and of a limb."""
    c, _ref_c, W = chain
    gi, g = _lookup(c, True)
    row = int(c.gate_rows[gi][0])
    bad = W.copy()
    bad[0, 0, 0] = np.uint64(1 << 63)                       # canonical: below p
    bad[1, 1, 1] = np.uint64((1 << 64) - 1)                 # not canonical
    bad[2, 2, 0] = np.uint64(gl.P)                          # not canonical
    bad[g.wire_value(0), row, 0] = np.uint64((1 << 64) - 5)
    bad[g.wire_value(1), row, 1] = np.uint64((1 << 63) + 7)
    bad[g.wire_limb(0, 0), row, 1] = np.uint64((1 << 63) | 3)
    counts = _three(chain, bad)
    assert counts["canonicity"] == sum(int(v) >= gl.P for v in bad.ravel()) >= 2
    pooled = bad[:g.num_vals][:, c.gate_rows[gi], :].ravel()
    assert counts[f"range_{g.bits}"] == sum(int(v) >> g.bits for v in pooled) % (1 << 64) > 1 << 34
    assert counts[f"lookup_limb_{g.bits}"] == ((1 << 63) | 3) >> g.limb_bits


def test_tensor_sanitizer_wraps_its_sums_modulo_2_64(chain):
    """17 limbs of 2^63 in one pool: 17 * 2^60 wraps to 2^60, as the
    reference's u64 sum does."""
    c, _ref_c, W = chain
    gi, g = _lookup(c, True)
    rows = c.gate_rows[gi]
    bad = W.copy()
    cols = [g.wire_limb(v, j) for v in range(g.num_vals) for j in range(g.num_limbs)]
    for i in range(17):
        bad[cols[i % len(cols)], int(rows[i // len(cols)]), 0] = np.uint64(1 << 63)
    assert _three(chain, bad)[f"lookup_limb_{g.bits}"] == 1 << 60


def test_tensor_sanitizer_scaled_top_limb(chain):
    """A top limb inside the plain limb range but over the scaled one, beside
    a top limb with the top bit set that the scaled check must leave alone."""
    c, _ref_c, W = chain
    gi, g = _lookup(c, True)
    rows = c.gate_rows[gi]
    bad = W.copy()
    bad[g.wire_limb(0, g.num_limbs - 1), int(rows[0]), 1] = np.uint64((1 << g.limb_bits) - 1)
    bad[g.wire_limb(1, g.num_limbs - 1), int(rows[1]), 0] = np.uint64(1 << 63)
    got = _three(chain, bad, reference=False)[f"lookup_limb_{g.bits}"]
    assert got == 1 + ((1 << 63) >> g.limb_bits)


def test_prove_arms_the_sanitizer_with_the_debug_variable(monkeypatch):
    c = small_demo_circuit().build()
    data = build_circuit_data(c, "cpu")
    W, pis = small_demo_witness(c, 2)
    bad = W.copy()
    bad[3, 1, 0] = np.uint64(gl.P)
    monkeypatch.setenv("PLONKY2_TPU_DEBUG", "1")
    with pytest.raises(AssertionError, match="canonicity"):
        prover.prove(data, bad, pis)
    assert verify(data, prover.prove(data, W, pis))


# ---------------------------------------------------------------------------
# the limb engine on tensors
# ---------------------------------------------------------------------------

SECP_P = cn.SECP256K1.p
SECP_N = cn.SECP256K1.n


def _ints(rng, count, bits):
    return [int.from_bytes(rng.bytes((bits + 7) // 8), "little") % (1 << bits)
            for _ in range(count)]


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _u32(t):
    """A tensor result as the numpy half's u32 container."""
    assert t.dtype == torch.int64
    return t.numpy().astype(np.uint32)


def _same(fn, ref_fn, *args):
    """fn on tensors, fn on numpy and the reference's fn: equal after the
    tensor's turn back into u32 (tuples elementwise)."""
    got = fn(*(_t(a) for a in args))
    want = fn(*args)
    ref = ref_fn(*args)
    got, want, ref = [x if isinstance(x, tuple) else (x,) for x in (got, want, ref)]
    for g, w, r in zip(got, want, ref):
        assert np.array_equal(_u32(g), w) and np.array_equal(np.asarray(w), np.asarray(r))


@pytest.fixture
def limb_inputs():
    rng = np.random.default_rng(256)
    L = lb.num_limbs(256)
    a, b = _ints(rng, 24, 256), _ints(rng, 24, 256)
    return a, b, lb.from_ints(a, L), lb.from_ints(b, L)


@pytest.mark.parametrize("op", ["mul", "add", "sub", "lt", "le", "eq", "is_zero",
                                "convert_16_29", "convert_29_16"])
def test_limb_ops_on_tensors(op, limb_inputs):
    a, b, A, B = limb_inputs
    if op == "convert_16_29":
        _same(lambda x: lb.convert(x, 16, 29, 9), lambda x: ref_lb.convert(x, 16, 29, 9), A)
    elif op == "convert_29_16":
        A29 = lb.convert(A, 16, 29, 9)
        _same(lambda x: lb.convert(x, 29, 16, 16), lambda x: ref_lb.convert(x, 29, 16, 16), A29)
        assert list(lb.to_ints(lb.convert(_t(A29), 29, 16, 16))) == a
    elif op == "is_zero":
        Z = A.copy()
        Z[::3] = 0
        _same(lb.is_zero, ref_lb.is_zero, Z)
    else:
        _same(getattr(lb, op), getattr(ref_lb, op), A, B)
    if op == "mul":
        assert list(lb.to_ints(lb.mul(_t(A), _t(B)))) == [x * y for x, y in zip(a, b)]


def test_limb_wraps_where_numpy_wraps():
    """Limbs of up to 32 bits (unnormalised): sub's borrow chain wraps its
    u32 difference and mul its u32 products; the tensor half masks there."""
    rng = np.random.default_rng(7)
    A = rng.integers(0, 1 << 32, (16, 9), dtype=np.uint64).astype(np.uint32)
    B = rng.integers(0, 1 << 32, (16, 9), dtype=np.uint64).astype(np.uint32)
    _same(lb.sub, ref_lb.sub, A, B)
    small = (A & np.uint32(0xFFFF))[:, :4]
    wide = (B >> np.uint32(12))[:, :4]              # 20-bit limbs: products above 2^32
    small[:, -1] = 0
    wide[:, -1] = 0
    _same(lambda x, y: lb.mul(x, y), lambda x, y: ref_lb.mul(x, y), small, wide)


@pytest.mark.parametrize("modulus", [SECP_P, SECP_N])
def test_modulus_on_tensors(modulus, limb_inputs):
    a, b, _A, _B = limb_inputs
    mod, ref_mod = lb.Modulus(modulus), ref_lb.Modulus(modulus)
    ar, br = [x % modulus for x in a], [x % modulus for x in b]
    A, B = lb.from_ints(ar, mod.L), lb.from_ints(br, mod.L)
    _same(mod.mod_mul, ref_mod.mod_mul, A, B)
    _same(mod.mod_add, ref_mod.mod_add, A, B)
    _same(mod.mod_sub, ref_mod.mod_sub, A, B)
    _same(mod.mod_neg, ref_mod.mod_neg, A)
    _same(mod.mod_inv, ref_mod.mod_inv, A)
    _same(lambda x: mod.pow_mod(x, 0x1234567), lambda x: ref_mod.pow_mod(x, 0x1234567), A)
    got = lb.to_ints(mod.mod_mul(_t(A), _t(B))[1])
    assert list(got) == [x * y % modulus for x, y in zip(ar, br)]
    assert lb.from_int(5, 3, device="cpu").dtype == torch.int64
