"""FRI's reduced polynomial as one CUDA pass (``prover/fri_cuda``, ``csrc/fri.cu``).

On the CPU, where the wrapper takes ``reduced_poly_plain`` (the eager field
of ``fields/goldilocks.py``): a Python-integer model of the kernel (each
block's weights by doubling and its lane sums, each thread's points, the
160-bit sums of unreduced products folded once a point, the Montgomery
inversion of a thread's denominators by one Fermat chain) run over the
launch the wrapper plans, equal to ``goldilocks_host`` term by term and to
the plain version; the plan reads the LDE views in place; the wrapper
refuses what the kernel does not take; and a prove whose reduced
polynomial goes through the model gives the plain proof.

On the card (marked ``cuda``, skipped without one; this file imports
neither JAX nor the reference package, so it runs there with
``python -m pytest --noconftest tests/test_torch_fri_cuda.py -m cuda``):
the kernel against the plain version at the provers' shapes, on a domain
slice of a wider LDE and on edge operands, and B=8 proofs of both curves
through the captured prover with their frozen digests.
"""

import math

import numpy as np
import pytest
import torch

from plonky2_ecdsa_tpu_torch.fields import goldilocks as gl
from plonky2_ecdsa_tpu_torch.fields import goldilocks_host as gh
from plonky2_ecdsa_tpu_torch.prover import fri_cuda, graph

P = gl.P
M32, M64, M160, EPS = (1 << 32) - 1, (1 << 64) - 1, (1 << 160) - 1, (1 << 32) - 1
W = 7


def _field(rng, shape, device="cpu"):
    return gl.from_u64(rng.integers(0, P, shape, dtype=np.uint64), device)


def _ext(rng, shape, device="cpu"):
    return (_field(rng, shape, device), _field(rng, shape, device))


def inputs(B, rows, m, K, seed=0, device="cpu", width=None, lo=0):
    """(x, sources, z_rows, zeta, gzeta, alpha, open0, open1) of random
    words; the sources and x are views [lo, lo + m) of LDEs `width` points
    wide (a domain slice)."""
    rng = np.random.default_rng(seed)
    width = width or m
    lde = [_field(rng, (rows[0], width), device)]
    lde += [_field(rng, (B, r, width), device) for r in rows[1:]]
    x = _field(rng, (width,), device)[lo:lo + m]
    sources = tuple(t[..., lo:lo + m] for t in lde)
    z_rows = tuple(int(r) for r in rng.choice(rows[2], K, replace=False))
    T = sum(rows)
    return (x, sources, z_rows, _ext(rng, (B,), device), _ext(rng, (B,), device),
            _ext(rng, (B,), device), _ext(rng, (B, T), device), _ext(rng, (B, K), device))


def edge_inputs(device="cpu"):
    """Small inputs with the edges: words p - 1 and 0 in every source,
    alpha 0, 1 and random on three lanes, x_j - zeta = 0 on lane 0 and
    x_j - g zeta = 0 on lane 1, a ragged slice at an offset."""
    x, sources, z_rows, zeta, gzeta, alpha, o0, o1 = inputs(3, (3, 4, 5, 2), 10, 3, seed=5,
                                                            width=16, lo=3)
    for s in sources:
        s[..., 0] = gl.i64(P - 1)
        s[..., 1] = 0
        s[..., -1] = gl.i64(P - 1)
    for c in (*o0, *o1):
        c[:, 0] = gl.i64(P - 1)
        c[:, 1] = 0
    alpha[0][:2] = torch.tensor([0, 1])
    alpha[1][:2] = 0
    zeta[0][0], zeta[1][0] = x[4], 0
    gzeta[0][1], gzeta[1][1] = x[7], 0
    return tuple(_to(v, device) for v in (x, sources, z_rows, zeta, gzeta, alpha, o0, o1))


def _to(v, device):
    if isinstance(v, torch.Tensor):
        return v.to(device)
    if isinstance(v, tuple) and v and isinstance(v[0], torch.Tensor):
        return tuple(t.to(device) for t in v)
    return v


# --------------------------------------------------------------------------
# the kernel in Python integers (csrc/fri.cu, csrc/goldilocks.cuh)
# --------------------------------------------------------------------------

def _canon(x):
    return (x + EPS) & M64 if x >= P else x


def _add(a, b):
    s = (a + b) & M64
    return (s + EPS) & M64 if s < a or s >= P else s


def _sub(a, b):
    d = (a - b) & M64
    return (d - EPS) & M64 if a < b else d


def _neg(a):
    return 0 if a == 0 else P - a


def _add_lazy(a, b):
    s = a + b
    return ((s & M64) + (s >> 64) * EPS) & M64


def _sub_lazy(a, b):
    return (((a - b) & M64) - (EPS if a < b else 0)) & M64


def _reduce128_lazy(hi, lo):
    return _add_lazy(_sub_lazy(lo, hi >> 32), (hi & M32) * EPS)


def _mul_lazy(a, b):
    return _reduce128_lazy(*divmod(a * b, 1 << 64))


def _mul(a, b):
    return _canon(_mul_lazy(a, b))


def mac160(s, a, b):
    """gl::mac160: s + a b on 160 bits (lo, hi with their carry, top)."""
    return (s + a * b) & M160


def fold160(s):
    """gl::fold160: lo + 2^64 hi + 2^128 top as a lazy word."""
    return _sub_lazy(_reduce128_lazy((s >> 64) & M64, s & M64), (s >> 128) << 32)


def inverse(a):
    """gl::inverse: the addition chain x_k = a^(2^k - 1) to a^(p - 2)."""
    def sqr_n(x, n):
        for _ in range(n):
            x = _mul_lazy(x, x)
        return x

    x2 = _mul_lazy(sqr_n(a, 1), a)
    x3 = _mul_lazy(sqr_n(x2, 1), a)
    x6 = _mul_lazy(sqr_n(x3, 3), x3)
    x12 = _mul_lazy(sqr_n(x6, 6), x6)
    x24 = _mul_lazy(sqr_n(x12, 12), x12)
    x30 = _mul_lazy(sqr_n(x24, 6), x6)
    x31 = _mul_lazy(sqr_n(x30, 1), a)
    x32 = _mul_lazy(sqr_n(x31, 1), a)
    return _canon(_mul_lazy(sqr_n(x31, 33), x32))


def _ext_mul(a, b):
    return (_add(_mul(a[0], b[0]), _mul(_mul_lazy(a[1], b[1]), W)),
            _add(_mul(a[0], b[1]), _mul(a[1], b[0])))


def _ext_add(a, b):
    return (_add(a[0], b[0]), _add(a[1], b[1]))


def _ext_sub(a, b):
    return (_sub(a[0], b[0]), _sub(a[1], b[1]))


def batch_inverse(n):
    """batch_inverse: prefix products of the norms (1 for a zero one), one
    inversion, and back; 0 for a zero norm."""
    pre, acc = [], 1
    for v in n:
        acc = _mul(acc, v or 1)
        pre.append(acc)
    inv, out = inverse(acc), [0] * len(n)
    for i in reversed(range(len(n))):
        out[i] = 0 if n[i] == 0 else _mul(inv, pre[i - 1]) if i else inv
        inv = _mul(inv, n[i] or 1)
    return out


def _reader(t, lane, col):
    """word(b, i, j) of tensor t as the kernel reads it: ptr + b lane + i
    col + j, ptr at t's first word."""
    flat = torch.empty(0, dtype=torch.int64).set_(t.untyped_storage())
    words = flat[t.storage_offset():].numpy().view(np.uint64).tolist()
    return lambda b, i=0, j=0: words[b * lane + i * col + j]


def kernel_reduced(*args):
    """fri_reduced_kernel over the launch the wrapper plans -> (F as an
    extension pair of [B, m] tensors, the intermediates {name: [B][...]}:
    pw (a^0..a^T), y (y, y'), s (the two sums, per point), norm and inv
    (of x - zeta and x - g zeta, per point))."""
    plan = fri_cuda.reduced_plan(*args)
    B, m, T, K = plan["B"], plan["m"], plan["T"], plan["K"]
    src = [(_reader(t, lane, col), rows) for t, lane, col, rows in plan["src"]]
    x = _reader(*plan["x"])
    lane = {k: [_reader(*c) for c in plan[k]] for k in ("zeta", "gzeta", "alpha", "open0",
                                                         "open1")}
    F = np.zeros((2, B, m), dtype=np.uint64)
    got = {k: [] for k in ("pw", "y", "s", "norm", "inv")}
    for blk in range(plan["blocks"]):
        b, tile = blk % B, blk // B
        if tile == 0:
            for k in got:
                got[k].append({})
        # weights by doubling: [s, 2s) from [0, s) times a^s
        pw = [(1, 0)] + [None] * T
        step = tuple(c(b) for c in lane["alpha"])
        s = 1
        while s <= T:
            for i in range(min(s, T + 1 - s)):
                pw[s + i] = _ext_mul(pw[i], step)
            step = _ext_mul(step, step)
            s *= 2

        def lane_dot(o, n):
            parts = []
            for tid in range(fri_cuda.THREADS):
                s0 = s1 = 0
                for t in range(tid, n, fri_cuda.THREADS):
                    w, u0, u1 = pw[t], o[0](b, t), o[1](b, t)
                    s0 = mac160(mac160(s0, w[0], u0), _mul_lazy(w[1], u1), W)
                    s1 = mac160(mac160(s1, w[0], u1), w[1], u0)
                parts.append((_canon(fold160(s0)), _canon(fold160(s1))))
            r = (0, 0)
            for p in parts:
                r = _ext_add(r, p)
            return r

        y = (lane_dot(lane["open0"], T), lane_dot(lane["open1"], K))
        got["pw"][b], got["y"][b] = pw, y
        zs_read = src[2][0]
        for tid in range(fri_cuda.THREADS):
            first = tile * fri_cuda.TILE + tid
            if first >= m:
                continue
            js = [min(first + v * fri_cuda.THREADS, m - 1) for v in range(fri_cuda.V)]
            num, den, norm = [], [], []
            for j in js:
                acc, t = [0, 0], 0
                for read, rows in src:
                    for r in range(rows):
                        u = read(b, r, j)
                        acc = [mac160(acc[0], u, pw[t][0]), mac160(acc[1], u, pw[t][1])]
                        t += 1
                s0 = tuple(_canon(fold160(a)) for a in acc)
                acc = [0, 0]
                for k, row in enumerate(plan["z_rows"]):
                    u = zs_read(b, row, j)
                    acc = [mac160(acc[0], u, pw[k][0]), mac160(acc[1], u, pw[k][1])]
                s1 = tuple(_canon(fold160(a)) for a in acc)
                num.append((_ext_sub(s0, y[0]), _ext_sub(s1, y[1])))
                xj = x(0, 0, j)
                ds = [(_sub(xj, c[0](b)), _neg(c[1](b))) for c in (lane["zeta"], lane["gzeta"])]
                den.append(ds)
                norm += [_sub(_mul(d[0], d[0]), _mul(_mul_lazy(d[1], d[1]), W)) for d in ds]
                got["s"][b][j] = (s0, s1)
            inv = batch_inverse(norm)
            for v, j in enumerate(js):
                if first + v * fri_cuda.THREADS >= m:
                    continue
                got["norm"][b][j], got["inv"][b][j] = norm[2 * v:2 * v + 2], inv[2 * v:2 * v + 2]
                q = [_ext_mul(num[v][d], (_mul(den[v][d][0], inv[2 * v + d]),
                                          _mul(_neg(den[v][d][1]), inv[2 * v + d])))
                     for d in range(2)]
                f = _ext_add(q[0], _ext_mul(pw[T], q[1]))
                F[0, b, j], F[1, b, j] = f
    return (gl.from_u64(F[0]), gl.from_u64(F[1])), got


# --------------------------------------------------------------------------
# the host field (goldilocks_host) for the terms
# --------------------------------------------------------------------------

def _h(t):
    return gl.to_u64(t)


def _hext_mul(a, b):
    return (gh.add(gh.mul(a[0], b[0]), gh.mul_const(gh.mul(a[1], b[1]), W)),
            gh.add(gh.mul(a[0], b[1]), gh.mul(a[1], b[0])))


def _hsum(x, axis):
    out = np.zeros(np.delete(x.shape, axis), dtype=np.uint64)
    for i in range(x.shape[axis]):
        out = gh.add(out, np.take(x, i, axis))
    return out


def host_terms(x, sources, z_rows, zeta, gzeta, alpha, open0, open1) -> dict:
    """The same terms in goldilocks_host: pw [B, T + 1], y and y' [B], the
    sums [B, m], the norms and their inverses [B, m] each, F [B, m]."""
    fixed, *rest = (_h(s) for s in sources)
    B = rest[0].shape[0]
    polys = np.concatenate([np.broadcast_to(fixed, (B,) + fixed.shape)] + rest, 1)
    T = polys.shape[1]
    a = tuple(_h(c) for c in alpha)
    pw = [(np.ones(B, np.uint64), np.zeros(B, np.uint64))]
    for _ in range(T):
        pw.append(_hext_mul(pw[-1], a))
    pw = tuple(np.stack([p[i] for p in pw], 1) for i in range(2))          # [B, T + 1]

    def dot(o, n):
        prod = _hext_mul((pw[0][:, :n], pw[1][:, :n]), tuple(_h(c) for c in o))
        return tuple(_hsum(p, 1) for p in prod)

    y = (dot(open0, T), dot(open1, len(z_rows)))
    s0 = tuple(_hsum(gh.mul(polys, pw[i][:, :T, None]), 1) for i in range(2))
    zp = rest[1][:, list(z_rows)]
    s1 = tuple(_hsum(gh.mul(zp, pw[i][:, :len(z_rows), None]), 1) for i in range(2))
    xs = _h(x)[None]
    dens = [(gh.sub(xs, _h(c[0])[:, None]),
             gh.neg(np.broadcast_to(_h(c[1])[:, None], (B,) + xs.shape[1:])))
            for c in (zeta, gzeta)]
    norms = [gh.sub(gh.mul(d[0], d[0]), gh.mul_const(gh.mul(d[1], d[1]), W)) for d in dens]
    invs = [gh.inverse(n) for n in norms]
    q = []
    for s, yy, d, inv in zip((s0, s1), y, dens, invs):
        num = tuple(gh.sub(s[i], yy[i][:, None]) for i in range(2))
        q.append(_hext_mul(num, (gh.mul(d[0], inv), gh.mul(gh.neg(d[1]), inv))))
    top = (pw[0][:, T:], pw[1][:, T:])
    F = tuple(gh.add(q[0][i], _hext_mul(top, q[1])[i]) for i in range(2))
    return dict(pw=pw, y=y, s=(s0, s1), norm=norms, inv=invs, F=F)


CASES = {"random": lambda: inputs(2, (3, 4, 5, 2), 9, 2, seed=1, width=13, lo=2),
         "edges": edge_inputs}


# --------------------------------------------------------------------------
# the CPU: values, plan, refusals
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_model_equals_the_host_field_term_by_term(case):
    """The kernel's arithmetic over its planned launch gives
    goldilocks_host's weights, lane sums, point sums, norms, inverses (0
    for a zero norm) and values, and the plain version's values."""
    args = CASES[case]()
    (f0, f1), got = kernel_reduced(*args)
    want = host_terms(*args)
    B, m = f0.shape
    T = want["pw"][0].shape[1] - 1
    for b in range(B):
        assert [p[0] for p in got["pw"][b]] == want["pw"][0][b].tolist(), b
        assert [p[1] for p in got["pw"][b]] == want["pw"][1][b].tolist(), b
        for k in range(2):
            assert got["y"][b][k] == (int(want["y"][k][0][b]), int(want["y"][k][1][b])), (b, k)
        for j in range(m):
            for k in range(2):
                assert got["s"][b][j][k] == (int(want["s"][k][0][b, j]),
                                             int(want["s"][k][1][b, j])), (b, j, k)
                assert got["norm"][b][j][k] == int(want["norm"][k][b, j]), (b, j, k)
                assert got["inv"][b][j][k] == int(want["inv"][k][b, j]), (b, j, k)
    assert np.array_equal(_h(f0), want["F"][0]) and np.array_equal(_h(f1), want["F"][1])
    plain = fri_cuda.reduced_poly_plain(*args)
    assert torch.equal(f0, plain[0]) and torch.equal(f1, plain[1])
    assert T == sum(s.shape[-2] for s in args[1])
    if case == "edges":
        assert got["norm"][0][4][0] == 0 and got["inv"][0][4][0] == 0
        assert got["norm"][1][7][1] == 0 and got["inv"][1][7][1] == 0


def test_wide_sums_and_the_inverse_chain():
    """mac160's carries into top and fold160 against the exact sum mod p;
    the addition chain against goldilocks_host's inverse on edge words."""
    s, exact = 0, 0
    for i in range(3000):
        a, b = M64 - i, M64 - 7 * i                 # non-canonical words too
        s, exact = mac160(s, a, b), exact + a * b
    assert s >> 128 > 0 and _canon(fold160(s)) == exact % P
    words = [0, 1, 2, P - 1, P - 2, 1 << 32, (1 << 32) - 1, 1 << 63, 7, 0x123456789ABCDEF]
    want = gh.inverse(np.array(words, dtype=np.uint64)).tolist()
    assert [inverse(w) for w in words] == want
    assert batch_inverse(words[:4]) == want[:4]


def test_plan_reads_the_views_in_place():
    """The plan hands the kernel each LDE view's own strides and rows, the
    fixed rows with lane stride 0, and a grid of lanes x tiles."""
    args = inputs(3, (4, 5, 6, 2), 700, 3, width=1024, lo=300)
    x, sources, z_rows = args[:3]
    plan = fri_cuda.reduced_plan(*args)
    assert (plan["B"], plan["m"], plan["T"], plan["K"]) == (3, 700, 17, 3)
    assert plan["z_rows"] == list(z_rows)
    assert [(s[1], s[2], s[3]) for s in plan["src"]] == \
        [(0, 1024, 4), (5 * 1024, 1024, 5), (6 * 1024, 1024, 6), (2 * 1024, 1024, 2)]
    assert all(s[0] is t for s, t in zip(plan["src"], sources))
    assert plan["x"][0] is x and plan["x"][1:] == (0, 1)
    assert plan["blocks"] == 3 * math.ceil(700 / fri_cuda.TILE) == 6
    assert [c[1:] for c in plan["open0"]] == [(17, 1), (17, 1)]
    assert [c[1:] for c in plan["zeta"]] == [(1, 0), (1, 0)]
    args = fri_cuda._args(plan, torch.empty((2, 3, 700), dtype=torch.int64))
    assert args.src[1].ptr == sources[1].data_ptr() and args.src[0].lane == 0
    assert (args.B, args.m, args.K, list(args.zrows)[:3]) == (3, 700, 3, list(z_rows))


def test_wrapper_on_the_cpu_is_the_plain_version():
    args = CASES["random"]()
    before = fri_cuda.reduced_poly.launches
    got, want = fri_cuda.reduced_poly(*args), fri_cuda.reduced_poly_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert fri_cuda.reduced_poly.launches == before
    assert fri_cuda.reduced_poly in graph.KERNELS


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_walks_the_domain_in_chunks(case, monkeypatch):
    """PLAIN_CHUNK points at a time, the last slice ragged: the plain
    version gives its one-slice values, and the kernel model's."""
    args = CASES[case]()
    whole = fri_cuda.reduced_poly_plain(*args)
    monkeypatch.setattr(fri_cuda, "PLAIN_CHUNK", 4)
    got = fri_cuda.reduced_poly_plain(*args)
    assert _same(got, whole) and _same(got, kernel_reduced(*args)[0])


def _refusal(name):
    x, sources, z_rows, zeta, gzeta, alpha, o0, o1 = inputs(2, (3, 4, 5, 2), 8, 2, seed=2)
    fixed, wires, zs, quot = sources
    big = torch.zeros(1, dtype=torch.int64)
    if name == "int32":
        return ValueError, "int64", (x.int(), sources, z_rows, zeta, gzeta, alpha, o0, o1)
    if name == "devices":
        meta = torch.empty(wires.shape, dtype=torch.int64, device="meta")
        return ValueError, "meta", (x, (fixed, meta, zs, quot), z_rows, zeta, gzeta, alpha, o0, o1)
    if name == "three_sources":
        return TypeError, "four LDEs", (x, sources[:3], z_rows, zeta, gzeta, alpha, o0, o1)
    if name == "lanes":
        return ValueError, "share B", (x, (fixed, wires, zs[:1], quot), z_rows, zeta, gzeta,
                                       alpha, o0, o1)
    if name == "points":
        return ValueError, "share B", (x[:7], sources, z_rows, zeta, gzeta, alpha, o0, o1)
    if name == "strided_points":
        w2 = torch.cat([wires, wires], -1)[..., ::2]
        return ValueError, "adjacent", (x, (fixed, w2, zs, quot), z_rows, zeta, gzeta, alpha,
                                        o0, o1)
    if name == "z_rows":
        return ValueError, "outside", (x, sources, (0, 5), zeta, gzeta, alpha, o0, o1)
    if name == "too_many_z_rows":
        wide = tuple(c[:, :1].expand(2, fri_cuda.MAX_Z + 1) for c in o1)
        return ValueError, "at most", (x, sources, (0,) * (fri_cuda.MAX_Z + 1), zeta, gzeta,
                                       alpha, o0, wide)
    if name == "too_many_rows":
        many = torch.zeros(1, 1, 8, dtype=torch.int64).expand(2, fri_cuda.MAX_TERMS, 8)
        T = 3 + fri_cuda.MAX_TERMS + 5 + 2
        return ValueError, "at most", (x, (fixed, many, zs, quot), z_rows, zeta, gzeta, alpha,
                            tuple(big.expand(2, T) for _ in o0), o1)
    if name == "too_many_points":
        m = fri_cuda.MAX_WORDS // 2
        return ValueError, "2\\^31", (big.expand(m), (big.expand(3, m), big.expand(2, 4, m),
                                            big.expand(2, 5, m), big.expand(2, 2, m)),
                            z_rows, zeta, gzeta, alpha, o0, o1)
    if name == "openings":
        short = tuple(c[:, 1:] for c in o0)
        return ValueError, "open0", (x, sources, z_rows, zeta, gzeta, alpha, short, o1)
    if name == "ext_pair":
        return TypeError, "zeta must", (x, sources, z_rows, zeta[0], gzeta, alpha, o0, o1)
    raise KeyError(name)


REFUSALS = ["int32", "devices", "three_sources", "lanes", "points", "strided_points", "z_rows",
            "too_many_z_rows", "too_many_rows", "too_many_points", "openings", "ext_pair"]


@pytest.mark.parametrize("name", REFUSALS)
def test_wrapper_refuses_what_the_kernel_does_not_take(name):
    """int64 tensors on one device; four sources of B lanes over x's points,
    adjacent words; z_rows inside zs; at most MAX_TERMS and MAX_Z rows and
    2^31 points; openings [B, T] and [B, K] and extension pairs.  Expanded
    views, so nothing large is allocated."""
    error, match, args = _refusal(name)
    with pytest.raises(error, match=match):
        fri_cuda.reduced_poly(*args)


def test_prover_through_the_kernel_model_gives_the_plain_proof(monkeypatch):
    """The prover hands the wrapper what the kernel needs, in one call over
    the domain as on the card: with the kernel's model in place of the
    wrapper, the demo proof is the plain one (in four domain chunks), digest
    for digest."""
    from plonky2_ecdsa_tpu_torch.circuit.examples import small_demo_circuit, small_demo_witness
    from plonky2_ecdsa_tpu_torch.prover import prover
    from plonky2_ecdsa_tpu_torch.prover.data import build_circuit_data

    c = small_demo_circuit().build()
    data = build_circuit_data(c, "cpu")
    W, pis = small_demo_witness(c, 2)
    monkeypatch.setattr(fri_cuda, "PLAIN_CHUNK", data.N // 4)
    want = prover.proof_digest(prover.prove(data, W, pis))
    calls = []

    def model(*args):
        calls.append(args[0].shape[0])
        return kernel_reduced(*args)[0]

    monkeypatch.setattr(fri_cuda, "reduced_poly", model)
    assert prover.proof_digest(prover.prove(data, W, pis)) == want
    assert calls == [data.N]


# --------------------------------------------------------------------------
# the card
# --------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda", 0)


def _random_lde(shape, card, gen):
    """Canonical words drawn on the card."""
    v = torch.randint(-(1 << 63), (1 << 63) - 1, shape, dtype=torch.int64, device=card,
                      generator=gen)
    return gl._canon(v)


def _card_inputs(card, B, rows, K, m, width, lo, seed):
    gen = torch.Generator(card).manual_seed(seed)
    lde = [_random_lde((rows[0], width), card, gen)]
    lde += [_random_lde((B, r, width), card, gen) for r in rows[1:]]
    x = _random_lde((width,), card, gen)[lo:lo + m]
    T = sum(rows)

    def ext(shape):
        return (_random_lde(shape, card, gen), _random_lde(shape, card, gen))

    z_rows = tuple(range(0, rows[2], max(1, rows[2] // K)))[:K]
    return (x, tuple(t[..., lo:lo + m] for t in lde), z_rows, ext((B,)), ext((B,)), ext((B,)),
            ext((B, T)), ext((B, K)))


SHAPES = {
    # (B, (fixed, wires, zs, quotient) rows, K, N): the provers' layouts
    "secp256k1_b32": (32, (129, 128, 120, 8), 4, 1 << 15),
    "p256_b32": (32, (159, 128, 128, 8), 4, 1 << 15),
    "outer_b8": (8, (136, 136, 64, 16), 2, 1 << 17),
}


def _same(got, want):
    return torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernel_at_the_provers_shapes(card, shape):
    """One domain chunk (2^14 points) of each prover's layout, the second
    half of a 2^15-point slice of the domain as a sharded rank reads it:
    the kernel against the plain version on the card, word for word."""
    B, rows, K, N = SHAPES[shape]
    m = 1 << 14
    args = _card_inputs(card, B, rows, K, m, width=2 * m, lo=m, seed=16)
    before = fri_cuda.reduced_poly.launches
    got = fri_cuda.reduced_poly(*args)
    assert fri_cuda.reduced_poly.launches == before + 1
    assert _same(got, fri_cuda.reduced_poly_plain(*args)), shape
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_kernel_on_edge_operands(card):
    """p - 1 and 0 in every source, zero denominators, alpha 0 and 1, a
    ragged slice; then ragged tiles (one point, a tile and one) at random."""
    args = edge_inputs(card)
    assert _same(fri_cuda.reduced_poly(*args), fri_cuda.reduced_poly_plain(*args))
    for m in (1, fri_cuda.TILE + 1, 3 * fri_cuda.THREADS - 5):
        args = _card_inputs(card, 3, (5, 6, 7, 2), 3, m, width=m + 8, lo=3, seed=m)
        assert _same(fri_cuda.reduced_poly(*args), fri_cuda.reduced_poly_plain(*args)), m
    torch.cuda.synchronize()


DIGESTS = {"secp256k1": "61ada2d00b755304", "p256": "7aa8671e81241ee5"}


@pytest.mark.cuda
@pytest.mark.parametrize("curve", sorted(DIGESTS))
def test_b8_proof_keeps_its_digest(card, curve):
    """A B=8 batch (random_statements(curve, 8, seed=14)) through the card's
    captured prover: the digest frozen from the CPU path, and one launch of
    the kernel a batch."""
    from plonky2_ecdsa_tpu_torch import api
    from plonky2_ecdsa_tpu_torch.prover import prover

    c = api.CURVES[curve]
    system = api.EcdsaProverSystem(c, device=card)
    vals, pis = system.witness_vals(api.random_statements(c, 8, seed=14))
    digest = prover.proof_digest(system.prover.run_vals(vals, pis))
    assert digest.startswith(DIGESTS[curve]), digest
    assert system.prover.graph_stats[("vals", 8)]["launches"]["reduced_poly"] == 1
