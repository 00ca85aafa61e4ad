"""The port's int64 Goldilocks field against the reference's u32-pair field
(bit-exact): base and extension ops on random and edge values, the frozen
vectors, and the conversions at the boundary with the reference."""

import json
import os

import numpy as np
import pytest

from plonky2_ecdsa_tpu.fields import goldilocks as ref
from plonky2_ecdsa_tpu_torch.fields import goldilocks as gl

P = ref.P
EDGES = np.array([0, 1, P - 1, P - 2, 2**32 - 1, 2**32, P - 2**32, 2**63, 2**63 - 1],
                 dtype=np.uint64)
VECTORS = os.path.join(os.path.dirname(__file__), "vectors", "goldilocks.json")


def _operands(seed):
    rng = np.random.default_rng(seed)
    a = np.concatenate([rng.integers(0, P, 512, dtype=np.uint64), np.repeat(EDGES, len(EDGES))])
    b = np.concatenate([rng.integers(0, P, 512, dtype=np.uint64), np.tile(EDGES, len(EDGES))])
    return a, b


def _ref_u64(pair):
    return ref.to_u64(*pair)


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_match_reference(op):
    a, b = _operands(1)
    got = gl.to_u64(getattr(gl, op)(gl.from_u64(a), gl.from_u64(b)))
    want = _ref_u64(getattr(ref, op)(*ref.from_u64(a), *ref.from_u64(b)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("op", ["neg", "square", "inverse"])
def test_unary_ops_match_reference(op):
    a, _ = _operands(2)
    got = gl.to_u64(getattr(gl, op)(gl.from_u64(a)))
    want = _ref_u64(getattr(ref, op)(*ref.from_u64(a)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("c", [0, 1, 7, 2**32 - 1, 2**32 + 5, P - 1])
def test_mul_by_python_int_matches_reference(c):
    a, _ = _operands(3)
    want = _ref_u64(ref.mul(*ref.from_u64(a), *ref.from_int(c)))
    assert np.array_equal(gl.to_u64(gl.mul(gl.from_u64(a), c)), want)
    if c < 2**32:
        assert np.array_equal(gl.to_u64(gl.mul_small(gl.from_u64(a), c)),
                              _ref_u64(ref.mul_small(*ref.from_u64(a), c)))


def test_pow_const_and_powers_match_reference():
    a, _ = _operands(4)
    ta, ra = gl.from_u64(a), ref.from_u64(a)
    for e in (0, 1, 2, 7, 12345, P - 2):
        assert np.array_equal(gl.to_u64(gl.pow_const(ta, e)), _ref_u64(ref.pow_const(*ra, e)))
    assert np.array_equal(gl.to_u64(gl.powers(ta[:16], 37)), _ref_u64(ref.powers(ra[0][:16], ra[1][:16], 37)))


def test_sums_and_prefix_sums_are_exact():
    rng = np.random.default_rng(5)
    a = np.concatenate([rng.integers(0, P, (3, 1000), dtype=np.uint64),
                        np.full((3, 24), P - 1, np.uint64)], 1)
    ints = [[int(v) for v in row] for row in a]
    got = gl.to_u64(gl.sum_mod(gl.from_u64(a), 1))
    assert [int(v) for v in got] == [sum(r) % P for r in ints]
    cum = gl.to_u64(gl.cumsum_mod(gl.from_u64(a), 1))
    for row, crow in zip(ints, cum):
        acc = 0
        for v, c in zip(row, crow):
            acc = (acc + v) % P
            assert int(c) == acc


def _ext(seed):
    a, b = _operands(seed)
    return (a, b[::-1].copy())


@pytest.mark.parametrize("op", ["ext_add", "ext_sub", "ext_mul", "ext_scalar_mul"])
def test_ext_binary_ops_match_reference(op):
    x, y = _ext(6), _ext(7)
    tx = (gl.from_u64(x[0]), gl.from_u64(x[1]))
    rx = (ref.from_u64(x[0]), ref.from_u64(x[1]))
    if op == "ext_scalar_mul":
        got = gl.ext_scalar_mul(tx, gl.from_u64(y[0]))
        want = ref.ext_scalar_mul(rx, ref.from_u64(y[0]))
    else:
        got = getattr(gl, op)(tx, (gl.from_u64(y[0]), gl.from_u64(y[1])))
        want = getattr(ref, op)(rx, (ref.from_u64(y[0]), ref.from_u64(y[1])))
    for i in range(2):
        assert np.array_equal(gl.to_u64(got[i]), _ref_u64(want[i]))


@pytest.mark.parametrize("op", ["ext_neg", "ext_square", "ext_inverse", "ext_pow"])
def test_ext_unary_ops_match_reference(op):
    x = _ext(8)
    tx = (gl.from_u64(x[0]), gl.from_u64(x[1]))
    rx = (ref.from_u64(x[0]), ref.from_u64(x[1]))
    if op == "ext_pow":
        got, want = gl.ext_pow_const(tx, 1000003), ref.ext_pow_const(rx, 1000003)
    else:
        got, want = getattr(gl, op)(tx), getattr(ref, op)(rx)
    for i in range(2):
        assert np.array_equal(gl.to_u64(got[i]), _ref_u64(want[i]))


def test_frozen_goldilocks_vectors():
    with open(VECTORS) as f:
        rows = json.load(f)
    a = gl.from_ints([int(r["a"], 16) for r in rows])
    b = gl.from_ints([int(r["b"], 16) for r in rows])
    for name, got in (("add", gl.add(a, b)), ("sub", gl.sub(a, b)), ("mul", gl.mul(a, b)),
                      ("inv_a", gl.inverse(a))):
        assert [int(v) for v in gl.to_u64(got)] == [int(r[name], 16) for r in rows], name


def test_boundary_conversions_round_trip():
    a, _ = _operands(9)
    t = gl.from_u64(a)
    assert np.array_equal(gl.to_u64(t), a)
    lo, hi = ref.from_u64(gl.to_u64(t))
    assert np.array_equal(gl.to_u64(gl.from_u64(ref.to_u64(lo, hi))), a)
    assert gl.from_u64(np.uint64(7)).shape == () and gl.to_u64(gl.const(7)).shape == ()
    a[0] ^= np.uint64(1)
    assert int(gl.to_u64(t)[0]) != int(a[0])       # from_u64 copies its input
    assert [int(v) for v in gl.to_u64(gl.from_ints([P + 3, -1]))] == [3, P - 1]


def test_unsigned_helpers_match_numpy_u64():
    a, b = _operands(10)
    ta, tb = gl.from_u64(a), gl.from_u64(b)
    assert np.array_equal(gl.ult(ta, tb).numpy(), a < b)
    for k in (1, 13, 32, 63):
        assert np.array_equal(gl.to_u64(gl.shr(ta, k)), a >> np.uint64(k))
