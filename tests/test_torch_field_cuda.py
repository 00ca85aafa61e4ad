"""The quotient's field kernels (``fields/goldilocks_cuda``, ``csrc/field.cu``).

On the CPU, where the wrappers take ``fields/goldilocks.py`` itself: a
Python-integer model of the kernels (the slot walk, the loads and the u64
arithmetic of ``csrc/field.cu`` and ``csrc/goldilocks.cuh``), run over the
launch the wrappers plan, gives ``fields/goldilocks.py``'s values over the
operand patterns the quotient hands them; the plan (shapes and strides
collapsed to four axes) walks the same words as ``torch.broadcast_tensors``;
and the wrappers refuse what the kernels do not take.

On the card (marked ``cuda``, skipped without one; this file imports
neither JAX nor the reference package, so it runs there with
``python -m pytest --noconftest tests/test_torch_field_cuda.py -m cuda``):
each kernel against its plain version on edge operands and at the
quotient's real shapes, and whole proofs of the CUDA path against the CPU
path's digests for the same witness.
"""

import math

import numpy as np
import pytest
import torch

import field_check_vectors
from plonky2_ecdsa_tpu_torch.circuit.algebra import TorchAlgebra
from plonky2_ecdsa_tpu_torch.fields import goldilocks as gl
from plonky2_ecdsa_tpu_torch.fields import goldilocks_cuda as glc

BINARY = {"add": (glc.add, gl.add), "sub": (glc.sub, gl.sub), "mul": (glc.mul, gl.mul)}


def _field(rng, shape, device="cpu"):
    return gl.from_u64(rng.integers(0, gl.P, shape, dtype=np.uint64), device)


def patterns(B: int, W: int, m: int, device="cpu", seed: int = 0) -> dict:
    """{name: (a, b)}: the operand patterns of the quotient's call tree on a
    [B, W, m] wires chunk, and three views of an even innermost axis that
    the 16-byte loads must not take (a pointer off 16 bytes, an odd row
    stride, an innermost stride above 1)."""
    rng = np.random.default_rng(seed)
    w = _field(rng, (B, W, m), device)
    warr = w.movedim(1, 0)                                        # [W, B, m], strided
    x = _field(rng, (B, 16, 8, m), device)                        # [B, nchunks, chunk, m]
    zsc = _field(rng, (B, 24, m), device)
    n = 5
    return {
        "same": (w[:, 0], w[:, 1]),
        "challenge": (w[:, :16], _field(rng, (B, 1, 1), device)),   # beta [B, 1, 1]
        "table": (_field(rng, (m,), device), w[:, 3]),              # l0, zh, a selector [m]
        "const_row": (_field(rng, (1, m), device), w[:, 2]),        # a constant column [1, m]
        "wires_view": (warr[:12], _field(rng, (12, 1, 1), device)),  # _const_col
        "mulnn_product": (warr[:n][:, None], warr[n:2 * n][None]),   # x[:, None] y[None]
        "mulnn_modulus": (_field(rng, (n, 1, 1, 1), device), warr[2 * n:3 * n][None]),
        "halves": (x[:, :, :4], x[:, :, 4:]),                       # the chunk product
        "zs_slice": (zsc[:, 3:11], zsc[:, 2:10]),                   # prev, left
        "lookup_scale": (w[:, [1, 5, 9, 2, 6, 10]], _field(rng, (1, 6, 1), device)),
        "weights": (w[:, :16].movedim(1, 0),                         # cons, alpha powers
                    _field(rng, (B, 40), device)[:, 7:23].t()[..., None]),
        "odd_inner": (w[:, :3, :m - 1], w[:, 3:6, 1:]),
        "misaligned": (_field(rng, (B, 3, m + 2), device)[..., 1:m + 1], w[:, :3]),
        "odd_stride": (_field(rng, (B, 3, m + 1), device)[..., :m], w[:, 3:6]),
        "step_two": (_field(rng, (B, 3, 2 * m), device)[..., ::2], w[:, 6:9]),
    }


INTS = [1, 2, 3, 1 << 29, 1 << 33, gl.i64(-1), gl.i64(gl.P - 2), 0]
PATTERNS = list(patterns(2, 40, 8))


def _emulate(t, strides, sizes, offset: int = 0):
    """The words a kernel reads of tensor t through its plan (strides over
    the four `sizes`, from `offset` words on), index by index, as a flat
    [prod(sizes)] tensor."""
    flat = torch.empty(0, dtype=t.dtype).set_(t.untyped_storage())
    idx = torch.zeros(sizes, dtype=torch.int64)
    for d, (size, stride) in enumerate(zip(sizes, strides)):
        shape = [1] * len(sizes)
        shape[d] = size
        idx = idx + torch.arange(size).reshape(shape) * stride
    return flat[t.storage_offset() + offset + idx.reshape(-1)]


# --------------------------------------------------------------------------
# the kernels in Python integers (csrc/field.cu, csrc/goldilocks.cuh): u64
# words as ints, the wrap-around of each C operation written out
# --------------------------------------------------------------------------

M32, M64, M96, EPS = (1 << 32) - 1, (1 << 64) - 1, (1 << 96) - 1, (1 << 32) - 1


def _canon(x):
    return (x + EPS) & M64 if x >= gl.P else x


def _add(a, b):
    s = (a + b) & M64
    return (s + EPS) & M64 if s < a or s >= gl.P else s


def _sub(a, b):
    d = (a - b) & M64
    return (d - EPS) & M64 if a < b else d


def _add_lazy(a, b):
    s = a + b                                        # add.cc, the carry by addc
    return ((s & M64) + (s >> 64) * EPS) & M64


def _sub_lazy(a, b):
    return (((a - b) & M64) - (EPS if a < b else 0)) & M64


def _mul_lazy(a, b):
    hi, lo = divmod(a * b, 1 << 64)
    return _add_lazy(_sub_lazy(lo, hi >> 32), (hi & M32) * EPS)


ARITH = {"add": _add, "sub": _sub, "mul": lambda a, b: _canon(_mul_lazy(a, b)),
         "neg": lambda a, _b: 0 if a == 0 else (gl.P - a) & M64}


def _words(t):
    """The u64 words of t's storage from t's first word on: the kernel's
    pointer."""
    flat = torch.empty(0, dtype=torch.int64).set_(t.untyped_storage())
    return flat[t.storage_offset():].numpy().view(np.uint64).tolist()


def _slots(sizes, V: int):
    """The kernel's slots in order, each (slot, its index on the four axes),
    as unravel<V> gives them."""
    n3 = sizes[3] // V
    for s in range(sizes[0] * sizes[1] * sizes[2] * n3):
        r, i3 = divmod(s, n3)
        q, i2 = divmod(r, sizes[2])
        i0, i1 = divmod(q, sizes[1])
        yield s, (i0, i1, i2, i3 * V)


def _load(operand, words, idx, V: int, along: int = 0):
    """load<V>: the V words of operand (tensor, strides, value) at index idx,
    `along` words further; a 16-byte load must be aligned."""
    t, strides, value = operand
    if t is None:
        return [value] * V
    off = sum(i * st for i, st in zip(idx, strides)) + along
    if V == 1 or strides[3] == 0:
        return [words[off]] * V
    assert (t.data_ptr() + 8 * off) % 16 == 0, "a 16-byte load off its alignment"
    return words[off:off + 2]


def kernel_binary(op: str, a, b=0):
    """a op b as field_binary_kernel computes it over the launch that
    goldilocks_cuda plans for it."""
    shape, sizes, operands, vec = glc.binary_plan(op, a, b)
    V = 2 if vec else 1
    words = [_words(t) if t is not None else None for t, _, _ in operands]
    out = [None] * math.prod(shape)
    for s, idx in _slots(sizes, V):
        x, y = (_load(o, ws, idx, V) for o, ws in zip(operands, words))
        for j in range(V):
            out[s * V + j] = ARITH[op](x[j], y[j])
    return gl.from_u64(np.array(out, dtype=np.uint64).reshape(shape))


def kernel_reduce(x, w, dim: int):
    """The sum over `dim` of x (times w where w is not None) as
    field_reduce_kernel computes it: a 96-bit sum of the lazy terms, folded
    and made canonical at the store."""
    ts = [x] if w is None else [x, w]
    out_shape, K, sizes, strides, vec = glc.reduce_plan(ts, dim)
    V = 2 if vec else 1
    operands = [(t, st, 0) for t, st in zip(ts, strides[1:])]
    words = [_words(t) for t in ts]
    out = [None] * math.prod(out_shape)
    for s, idx in _slots(sizes, V):
        acc = [0] * V
        for k in range(K):
            v = _load(operands[0], words[0], idx, V, k * strides[1][glc.DIMS])
            if w is not None:
                u = _load(operands[1], words[1], idx, V, k * strides[2][glc.DIMS])
                v = [_mul_lazy(p, q) for p, q in zip(v, u)]
            acc = [(a + b) & M96 for a, b in zip(acc, v)]
        for j in range(V):
            out[s * V + j] = _canon(_add_lazy(acc[j] & M64, (acc[j] >> 64) * EPS))
    return gl.from_u64(np.array(out, dtype=np.uint64).reshape(out_shape))


# --------------------------------------------------------------------------
# the CPU: values, plans, refusals
# --------------------------------------------------------------------------

@pytest.mark.parametrize("op", sorted(BINARY))
@pytest.mark.parametrize("name", PATTERNS)
def test_wrappers_equal_the_plain_field(name, op):
    """The kernel's values over the wrapper's launch, both operand orders,
    equal the plain field's; neg likewise."""
    a, b = patterns(2, 40, 8)[name]
    plain = BINARY[op][1]
    assert torch.equal(kernel_binary(op, a, b), plain(a, b))
    assert torch.equal(kernel_binary(op, b, a), plain(b, a))
    assert torch.equal(kernel_binary("neg", a), gl.neg(a))


@pytest.mark.parametrize("op", sorted(BINARY))
@pytest.mark.parametrize("c", INTS)
def test_wrappers_take_python_ints(op, c):
    """A Python int on either side becomes the kernel's constant word (any
    int taken mod p for mul, the int64 bit pattern for add and sub, as
    goldilocks takes it), on the vectorised launch and on the one-word
    one."""
    a = patterns(2, 40, 8)["same"][0]
    plain = BINARY[op][1]
    d = c % gl.P if op == "mul" else c
    for x in (a, a[:, 1:]):
        assert torch.equal(kernel_binary(op, x, c), plain(x, d))
        assert torch.equal(kernel_binary(op, c, x), plain(d, x))


@pytest.mark.parametrize("name", PATTERNS)
def test_plan_walks_the_broadcast_words(name):
    """Every operand's collapsed strides, walked index by index over the
    collapsed sizes, give torch.broadcast_tensors' words in the output's
    order, and the output's own strides are its contiguous ones."""
    a, b = patterns(2, 40, 8)[name]
    shape = torch.broadcast_shapes(a.shape, b.shape)
    assert glc.broadcast_shape(a.shape, b.shape) == tuple(shape)
    sizes, strides = glc.plan(shape, [a, b])
    assert len(sizes) == glc.DIMS and np.prod(sizes) == np.prod(shape)
    out = torch.arange(int(np.prod(shape)), dtype=torch.int64).reshape(shape)
    assert torch.equal(_emulate(out, strides[0], sizes), out.reshape(-1))
    for t, want in zip((a, b), torch.broadcast_tensors(a, b)):
        assert torch.equal(_emulate(t, strides[1 + (t is b)], sizes), want.reshape(-1))


@pytest.mark.parametrize("dim", [0, 1, -1])
@pytest.mark.parametrize("name", ["same", "challenge", "halves", "weights", "mulnn_product"])
def test_reduce_plan_walks_every_term(name, dim):
    """The reduction's plan: for each k, the words of term k of both
    tensors in the output's order."""
    x, w = patterns(2, 40, 8)[name]
    out_shape, K, sizes, strides, _vec = glc.reduce_plan([x, w], dim)
    assert len(sizes) == glc.DIMS and np.prod(sizes) == np.prod(out_shape)
    out = torch.arange(int(np.prod(out_shape)), dtype=torch.int64).reshape(out_shape)
    assert torch.equal(_emulate(out, strides[0], sizes), out.reshape(-1))
    for t, want, st in zip((x, w), torch.broadcast_tensors(x, w), strides[1:]):
        for k in range(K):
            got = _emulate(t, st[:glc.DIMS], sizes, offset=k * st[glc.DIMS])
            assert torch.equal(got, want.select(dim, k).reshape(-1)), k
    assert torch.equal(kernel_reduce(x, w, dim), gl.sum_mod(gl.mul(x, w), dim))
    assert torch.equal(kernel_reduce(x, None, dim), gl.sum_mod(x, dim))


def test_kernel_model_takes_both_launches():
    """The patterns reach both kernels' launches: two words a thread (the
    vectorised one) and one word (an odd or offset innermost axis)."""
    vecs = {glc.binary_plan("mul", *ab)[3] for ab in patterns(2, 40, 8).values()}
    assert vecs == {0, 1}
    x, w = patterns(2, 40, 8)["weights"]
    assert glc.reduce_plan([x, w], 0)[4] == 1 and glc.reduce_plan([x[..., 1:], w], 0)[4] == 0


def test_collapse_merges_what_walks_as_one_axis():
    # contiguous [B, k, m] and a [B, 1, 1] challenge: B stays, k and m merge
    sizes, strides = glc.collapse((4, 3, 8), [[24, 8, 1], [1, 0, 0]])
    assert sizes == [1, 1, 4, 24] and strides == [[0, 0, 24, 1], [0, 0, 1, 0]]
    # size-1 axes drop out, whatever their strides
    assert glc.collapse((1, 5, 1), [[99, 1, 7]]) == ([1, 1, 1, 5], [[0, 0, 0, 1]])
    # a scalar is one word
    assert glc.collapse((), [[]]) == ([1, 1, 1, 1], [[0, 0, 0, 0]])


def test_wrappers_refuse_other_dtypes():
    a = torch.arange(6, dtype=torch.int32)
    b = torch.arange(6, dtype=torch.int64)
    for fn in (glc.add, glc.sub, glc.mul):
        with pytest.raises(ValueError, match="int64"):
            fn(a, b)
    with pytest.raises(ValueError, match="int64"):
        glc.neg(a)
    with pytest.raises(ValueError, match="int64"):
        glc.sum_mod(a, 0)
    with pytest.raises(ValueError, match="int64"):
        glc.dot_mod(b, a, 0)
    with pytest.raises(TypeError):
        glc.add(b, 1.5)
    with pytest.raises(TypeError):
        glc.add(2, 3)
    with pytest.raises(TypeError):
        glc.dot_mod(b, 3, 0)


def test_wrappers_refuse_mixed_devices():
    a = torch.arange(6, dtype=torch.int64)
    b = torch.empty(6, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        glc.mul(a, b)
    with pytest.raises(ValueError):
        glc.dot_mod(a, b, 0)


def test_wrappers_refuse_a_rank_they_do_not_take():
    """Five axes that no stride merges; four is the kernels' most."""
    x = torch.arange(2 ** 5, dtype=torch.int64).reshape(2, 2, 2, 2, 2).permute(4, 2, 0, 3, 1)
    y = torch.arange(2 ** 5, dtype=torch.int64).reshape(2, 2, 2, 2, 2)
    with pytest.raises(ValueError, match="at most 4"):
        glc.add(x, y)
    with pytest.raises(ValueError, match="at most 4"):
        glc.sum_mod(x[None], 0)
    # five axes of which four merge into one: taken
    assert torch.equal(glc.add(y, y[..., :1]), gl.add(y, y[..., :1]))
    with pytest.raises(ValueError, match="no axis"):
        glc.sum_mod(y, 5)


def test_wrappers_refuse_more_words_than_the_kernels_index():
    """Outputs of 2^31 words and more (the kernels' slot indices are 32-bit)
    and reductions of as many terms; expanded views, so nothing is
    allocated."""
    big = torch.zeros(1, dtype=torch.int64).expand(glc.MAX_WORDS)
    with pytest.raises(ValueError, match="2\\^31"):
        glc.add(big, 1)
    with pytest.raises(ValueError, match="2\\^31"):
        glc.dot_mod(big[None].expand(2, -1), big[:1], 0)
    with pytest.raises(ValueError, match="2\\^31"):
        glc.sum_mod(big, 0)
    assert glc.binary_plan("add", big[1:], 1)[1] == [1, 1, 1, glc.MAX_WORDS - 1]


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_algebra_reductions_equal_the_plain_sums(dim, monkeypatch):
    """TorchAlgebra's field operations are goldilocks_cuda's: with the
    kernels' model in place of the wrappers, its reductions and operations
    give the plain field's values, each through its wrapper."""
    called = set()

    def through(name, model):
        def fn(*args):
            called.add(name)
            return model(*args)
        monkeypatch.setattr(glc, name, fn)

    for op in ("add", "sub", "mul"):
        through(op, lambda a, b, op=op: kernel_binary(op, a, b))
    through("sum_mod", lambda x, d: kernel_reduce(x, None, d))
    through("dot_mod", kernel_reduce)
    rng = np.random.default_rng(dim)
    x = _field(rng, (5, 3, 8))
    w = _field(rng, (5, 3, 8))[:, :1] if dim != 1 else _field(rng, (1, 3, 1))
    alg = TorchAlgebra((3, 8), "cpu")
    assert torch.equal(alg.dot_mod(x, w, dim), gl.sum_mod(gl.mul(x, w), dim))
    assert torch.equal(alg.sum_mod(x, dim), gl.sum_mod(x, dim))
    assert torch.equal(alg.mul(x, 7), gl.mul(x, 7))
    assert torch.equal(alg.sub(x, 1), gl.sub(x, 1))
    assert torch.equal(alg.add_const(x, -1), gl.add(x, gl.i64(-1)))
    assert called == {"add", "sub", "mul", "sum_mod", "dot_mod"}


# --------------------------------------------------------------------------
# the card
# --------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


def _host(t):
    return gl.to_u64(t)


@pytest.mark.cuda
def test_kernels_on_edge_operands(card):
    """add, sub, mul, neg, sum_mod and dot_mod on every pair of the field
    check's directed edge operands (0, 1, p - 1, 2^32 +- 1, p, 2^64 - 1:
    carries and borrows, canonical and not) and random ones, against the
    plain versions on the CPU, word for word."""
    a, b = field_check_vectors.operands(1 << 12, seed=14)
    n = len(a) - len(a) % 8
    ta, tb = gl.from_u64(a[:n]), gl.from_u64(b[:n])
    ca, cb = ta.to(card), tb.to(card)
    for op, (kernel, plain) in BINARY.items():
        assert np.array_equal(_host(kernel(ca, cb)), _host(plain(ta, tb))), op
        assert np.array_equal(_host(kernel(ca[1:], cb[:-1])), _host(plain(ta[1:], tb[:-1]))), op
        for c in INTS:
            c = c % gl.P if op == "mul" else c
            assert np.array_equal(_host(kernel(ca, c)), _host(plain(ta, c))), (op, c)
            assert np.array_equal(_host(kernel(c, ca)), _host(plain(c, ta))), (op, c)
    assert np.array_equal(_host(glc.neg(ca)), _host(gl.neg(ta)))
    for shape in ((8, n // 8), (n // 8, 8)):
        x, w = ta.reshape(shape), tb.reshape(shape)
        for dim in (0, 1):
            assert np.array_equal(_host(glc.sum_mod(x.to(card), dim)), _host(gl.sum_mod(x, dim)))
            assert np.array_equal(_host(glc.dot_mod(x.to(card), w.to(card), dim)),
                                  _host(gl.sum_mod(gl.mul(x, w), dim)))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 128, 1 << 14), (8, 136, 1 << 14)], ids=["flat", "outer"])
def test_kernels_at_the_quotients_shapes(card, shape):
    """Every pattern at a domain chunk of the flat B=32 and the outer B=8
    circuit, strided views included: kernel against the plain version on
    the card, and the reductions over each axis."""
    for name, (a, b) in patterns(*shape, device=card, seed=3).items():
        for op, (kernel, plain) in BINARY.items():
            assert torch.equal(kernel(a, b), plain(a, b)), (name, op)
        assert torch.equal(glc.neg(b), gl.neg(b)), name
        full = torch.broadcast_shapes(a.shape, b.shape)
        for dim in range(len(full)):
            assert torch.equal(glc.dot_mod(a, b, dim), gl.sum_mod(gl.mul(a, b), dim)), (name, dim)
            if a.dim() == len(full):
                assert torch.equal(glc.sum_mod(a, dim), gl.sum_mod(a, dim)), (name, dim)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_demo_proof_equals_the_cpu_proof(card):
    from plonky2_ecdsa_tpu_torch.circuit.examples import small_demo_circuit, small_demo_witness
    from plonky2_ecdsa_tpu_torch.prover import prover
    from plonky2_ecdsa_tpu_torch.prover.data import build_circuit_data

    c = small_demo_circuit().build()
    W, pis = small_demo_witness(c, 2)
    before = glc.mul.launches
    on_card = prover.prove(build_circuit_data(c, card), W, pis)
    assert glc.mul.launches > before
    host = prover.prove(build_circuit_data(c, "cpu"), W, pis)
    assert prover.first_difference(host, on_card) is None
    assert prover.proof_digest(on_card) == prover.proof_digest(host)


@pytest.mark.cuda
def test_secp256k1_batch_equals_the_cpu_proof(card):
    """A B=8 secp256k1 batch through the card's captured prover (graphs)
    and through the CPU's eager plain path: the same digest."""
    from plonky2_ecdsa_tpu_torch import api
    from plonky2_ecdsa_tpu_torch.prover import prover

    curve = api.CURVES["secp256k1"]
    stmts = api.random_statements(curve, 8, seed=14)
    digests = {}
    for dev in (card, torch.device("cpu")):
        system = api.EcdsaProverSystem(curve, device=dev)
        vals, pis = system.witness_vals(stmts)
        digests[dev.type] = prover.proof_digest(system.prover.run_vals(vals, pis))
        if dev.type == "cuda":
            stats = system.prover.graph_stats[("vals", 8)]
            assert all(stats["launches"][k.__name__] > 0 for k in
                       (glc.add, glc.sub, glc.mul, glc.sum_mod, glc.dot_mod))
        del system
    assert digests["cuda"] == digests["cpu"]
