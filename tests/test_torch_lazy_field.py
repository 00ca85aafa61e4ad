"""A Python-integer model of the lazy field arithmetic of the CUDA Poseidon2
kernels (csrc/goldilocks.cuh and the layers of csrc/poseidon2.cu), with the
u64 wrap-around written out, run where no GPU is needed: on the directed edge
operands that the GPU field check uses, and on whole permutations of edge
states against the port's plain permutation (itself held against the
reference).  Every range the kernels' comments state is asserted on the way
(sums below 2^70 before a fold, no second carry after a wrap fix)."""

import numpy as np
import pytest

import field_check_vectors
from plonky2_ecdsa_tpu.fields import goldilocks as ref_gl
from plonky2_ecdsa_tpu.hash import poseidon as ref_ps
from plonky2_ecdsa_tpu_torch.fields import goldilocks as gl
from plonky2_ecdsa_tpu_torch.hash import poseidon, poseidon_cuda

P = ref_gl.P
M32, M64 = (1 << 32) - 1, (1 << 64) - 1
EPS = M32
RC = [[int(v) for v in row] for row in poseidon.RC_TABLE]
seen = set()      # the rare branches that the operands reached


def canon(x):
    assert 0 <= x <= M64
    return x - P if x >= P else x


def add_lazy(a, b):
    assert 0 <= a <= M64 and 0 <= b <= (1 << 64) - (1 << 32)
    s = a + b
    if s > M64:
        seen.add("add_lazy carry")
        s = (s & M64) + EPS
        assert s <= M64, "the wrap fix carried again"
    return s


def sub_lazy(a, b):
    assert 0 <= a <= M64 and 0 <= b <= (1 << 64) - (1 << 32)
    d = a - b
    if d < 0:
        seen.add("sub_lazy borrow")
        d = (d + (1 << 64)) - EPS
        assert d >= 0, "the borrow fix borrowed again"
    return d


def reduce128_lazy(hi, lo):
    assert 0 <= hi <= M64 and 0 <= lo <= M64
    return add_lazy(sub_lazy(lo, hi >> 32), (hi & M32) * EPS)


def mul_lazy(a, b):
    assert 0 <= a <= M64 and 0 <= b <= M64
    return reduce128_lazy(*divmod(a * b, 1 << 64))


def sqr_lazy(a):
    return mul_lazy(a, a)


def add96(a, b):
    s = a[0] + b[0]
    hi = a[1] + b[1] + (s >> 64)
    assert hi <= M32
    return (s & M64, hi)


def quad96(a):
    assert a[1] < 1 << 30
    return ((a[0] << 2) & M64, ((a[1] << 2) & M32) | (a[0] >> 62))


def mad96(x, d, s):
    assert s[1] + d <= M32
    a = (x & M32) * d + (s[0] & M32)
    b = (x >> 32) * d + (a >> 32)
    b += (s[0] >> 32) | (s[1] << 32)
    assert b <= M64
    return (((b << 32) & M64) | (a & M32), b >> 32)


def value96(a):
    return a[0] + (a[1] << 64)


def fold96(a):
    assert a[1] <= M32
    return add_lazy(a[0], a[1] * EPS)


def fold_layer_word(a):
    assert value96(a) < 1 << 70, "a layer's sum outgrew the range the kernel's comment states"
    return fold96(a)


def ext_layer(x):
    y = [None] * 12
    for g in range(3):
        x0, x1, x2, x3 = ((v, 0) for v in x[4 * g:4 * g + 4])
        t0, t1 = add96(x0, x1), add96(x2, x3)
        t2, t3 = add96(add96(t1, x1), x1), add96(add96(t0, x3), x3)
        t4, t5 = add96(quad96(t1), t3), add96(quad96(t0), t2)
        y[4 * g:4 * g + 4] = add96(t3, t5), t5, add96(t2, t4), t4
    out = [None] * 12
    for i in range(4):
        s = add96(add96(y[i], y[4 + i]), y[8 + i])
        for g in range(3):
            out[4 * g + i] = fold_layer_word(add96(y[4 * g + i], s))
    return out


def int_layer(x):
    s = (x[0], 0)
    for v in x[1:]:
        s = add96(s, (v, 0))
    return [fold_layer_word(mad96(v, d, s)) for v, d in zip(x, poseidon.DIAG_M1)]


def sbox(x):
    x2 = sqr_lazy(x)
    return mul_lazy(sqr_lazy(x2), mul_lazy(x2, x))


def permute_model(x):
    """csrc/poseidon2.cu::permute on Python integers: any u64 in, canonical out."""
    x = ext_layer(list(x))
    for r in range(30):
        if r < 4 or r >= 26:
            x = ext_layer([sbox(add_lazy(v, c)) for v, c in zip(x, RC[r])])
        else:
            x = int_layer([sbox(add_lazy(x[0], RC[r][0]))] + x[1:])
    return [canon(v) for v in x]


def _operands():
    a, b = field_check_vectors.operands(256, seed=5)
    return list(zip(a.tolist(), b.tolist()))


def test_directed_operands_reach_the_rare_branches():
    seen.clear()
    pairs = _operands()[:-256]              # the directed pairs alone
    assert len(pairs) > 300
    for a, b in pairs:
        mul_lazy(a, b)
        sqr_lazy(a)
    assert seen == {"add_lazy carry", "sub_lazy borrow"}


@pytest.mark.parametrize("row", ["mul_lazy", "sqr_lazy", "fold96", "add_lazy", "sub_lazy",
                                 "canon_mul", "canon", "mad96", "quad96"])
def test_model_primitives_match_python_integers(row):
    """The model of each primitive equals what the GPU field check expects of
    the kernel (field_check_vectors.expected), pair by pair."""
    for a, b in _operands():
        lazy, exact = field_check_vectors.expected(a, b)
        s = (b, (a >> 32) & 63)
        if row == "mul_lazy":
            assert mul_lazy(a, b) % P == lazy[0]
        elif row == "sqr_lazy":
            assert sqr_lazy(a) % P == lazy[1] and sqr_lazy(b) % P == b * b % P
        elif row == "fold96":
            assert fold96((a, b & M32)) % P == lazy[2]
        elif row == "add_lazy":
            assert add_lazy(a, canon(b)) % P == lazy[3]
        elif row == "sub_lazy":
            assert sub_lazy(a, canon(b)) % P == lazy[4]
        elif row == "canon_mul":
            assert canon(mul_lazy(a, b)) == exact[0] == exact[6] == a * b % P
        elif row == "canon":
            assert canon(a) == exact[1] == a % P
        elif row == "mad96":
            assert mad96(a, a & 31, s) == (exact[2], exact[3])
        else:
            assert quad96(add96(s, (a, 0))) == (exact[4], exact[5])


def _edge_states():
    edge = [0, 1, M32, 1 << 32, P - 1, P, P + 1, (1 << 64) - (1 << 32), M64, 1 << 63]
    states = [[e] * 12 for e in edge]
    states.append([edge[i % len(edge)] for i in range(12)])
    states.append([edge[(3 * i + 1) % len(edge)] for i in range(12)])
    rng = np.random.default_rng(6)
    states += rng.integers(0, 1 << 64, (4, 12), dtype=np.uint64).tolist()
    return states


@pytest.mark.parametrize("index", range(16))
def test_model_permutation_matches_plain(index):
    """Whole permutations of edge states (non-canonical words included): the
    model's canonical output equals permute_plain's, and every layer's sum
    stayed below 2^70."""
    state = _edge_states()[index]
    t = gl.from_u64(np.array(state, dtype=np.uint64)[:, None])
    want = gl.to_u64(poseidon.permute_plain(t))[:, 0].tolist()
    assert permute_model(state) == want


def test_model_butterflies_match_python_integers():
    """gl::butterfly on lazy words: a lazy, the product canonical."""
    for a, b in _operands():
        for w in (1, P - 1, 1 << 48, 0x185629DCDA58878C):
            t = canon(mul_lazy(b, w))
            assert add_lazy(a, t) % P == (a + b * w) % P
            assert sub_lazy(a, t) % P == (a - b * w) % P


def test_model_permutation_matches_reference():
    v = np.random.default_rng(7).integers(0, P, (12, 3), dtype=np.uint64)
    want = ref_gl.to_u64(*ref_ps.permute_stacked(*ref_gl.from_u64(v)))
    for j in range(3):
        assert permute_model(v[:, j].tolist()) == want[:, j].tolist()


def test_field_check_rows_are_all_expected():
    lazy, exact = field_check_vectors.expected(3, 5)
    assert len(lazy) + len(exact) == poseidon_cuda.FIELD_CHECK_ROWS


def test_field_check_needs_a_cuda_tensor():
    x = gl.from_u64(np.arange(4, dtype=np.uint64))
    with pytest.raises(ValueError):
        poseidon_cuda.field_check(x, x)
