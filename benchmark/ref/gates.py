"""The constraints of every gate the benchmark's circuits use, written against
an algebra (``field.ExtAlgebra`` at the verifier's point), and the parse of a
gate's id into its object.

Each gate's wire layout and constraint list follows the circuit's gate
definitions (plonky2's ArithmeticGate, ConstantGate, PublicInputGate,
BaseSum, RandomAccessGate, PoseidonGate, and the fused nonnative gates of the
secp256k1 / P-256 verify circuit: MulNonNative with its carry chain,
NonNativeAdd / Sub / AddMany, BigCmp, RangeLookup's limb recombination), in
the order the prover combines them.
"""

from __future__ import annotations

import re

from . import poseidon2 as ps
from .field import P

BITS = 29                     # nonnative limb width
CARRY_OFFSET = 1 << 33        # MulNonNative / AddMany carries are stored offset by 2^33

MODULI = {
    "secp256k1_base": 2**256 - 2**32 - 977,
    "secp256k1_scalar": 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141,
    "p256_base": 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF,
    "p256_scalar": 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551,
}


def limbs29(m: int) -> list:
    return [(m >> (BITS * i)) & ((1 << BITS) - 1) for i in range(-(-m.bit_length() // BITS))]


class Gate:
    num_constraints = 0

    def eval(self, alg, w, c, ctx):
        raise NotImplementedError


class Noop(Gate):
    num_wires = 0

    def eval(self, alg, w, c, ctx):
        return []


class Constant(Gate):
    def __init__(self, k):
        self.num_wires = self.num_constraints = k

    def eval(self, alg, w, c, ctx):
        return [alg.sub(w[i], c[i]) for i in range(self.num_wires)]


class PublicInput(Gate):
    def __init__(self, k):
        self.num_wires = self.num_constraints = k

    def eval(self, alg, w, c, ctx):
        return [alg.sub(w[i], ctx["pi_vals"][i]) for i in range(self.num_wires)]


class Arithmetic(Gate):
    """out = c0 m1 m2 + c1 addend, per op of 4 wires."""

    def __init__(self, ops):
        self.ops = ops
        self.num_wires, self.num_constraints = 4 * ops, ops

    def eval(self, alg, w, c, ctx):
        out = []
        for i in range(self.ops):
            m1, m2, ad, o = w[4 * i:4 * i + 4]
            t = alg.add(alg.mul(c[0], alg.mul(m1, m2)), alg.mul(c[1], ad))
            out.append(alg.sub(t, o))
        return out


class BaseSum2(Gate):
    """Per op: value, then `bits` little-endian bits; recomposition, then
    each bit boolean."""

    def __init__(self, ops, bits):
        self.ops, self.bits = ops, bits
        self.num_wires = self.num_constraints = ops * (1 + bits)

    def eval(self, alg, w, c, ctx):
        out = []
        for op in range(self.ops):
            base = op * (1 + self.bits)
            bits = w[base + 1:base + 1 + self.bits]
            acc = alg.zero()
            for b in reversed(bits):
                acc = alg.add(alg.mul_const(acc, 2), b)
            out.append(alg.sub(acc, w[base]))
            out.extend(alg.mul(b, alg.add_const(b, -1)) for b in bits)
        return out


class RangeLookup(Gate):
    """V values, then V x nl limbs of limb_bits; only the recombinations are
    gate constraints (the limbs' membership is the LogUp argument's)."""

    BATCH = 3

    def __init__(self, bits, vals, limb_bits):
        self.bits, self.vals, self.limb_bits = bits, vals, limb_bits
        self.nl = -(-bits // limb_bits)
        rem = bits % limb_bits
        self.scale = (1 << (limb_bits - rem)) if rem else 1
        self.num_wires, self.num_constraints = vals * (1 + self.nl), vals

    def limb(self, v, j):
        return self.vals + v * self.nl + j

    def eval(self, alg, w, c, ctx):
        out = []
        for v in range(self.vals):
            acc = alg.zero()
            for j in reversed(range(self.nl)):
                acc = alg.add(alg.mul_const(acc, 1 << self.limb_bits), w[self.limb(v, j)])
            out.append(alg.sub(acc, w[v]))
        return out

    def lookup_terms(self) -> list:
        """[(wire, scale)] looked up in the table, in order: each limb, and
        the top limb times 2^(limb_bits - rem) where the top limb is narrower."""
        out = []
        for v in range(self.vals):
            out += [(self.limb(v, j), 1) for j in range(self.nl)]
            if self.scale > 1:
                out.append((self.limb(v, self.nl - 1), self.scale))
        return out

    @property
    def num_batches(self):
        return -(-len(self.lookup_terms()) // self.BATCH)

    def lookup_cols_scales(self, nb):
        """Padded to nb batches of 3 with (wire 0, scale 0) terms."""
        terms = self.lookup_terms()
        pads = nb * self.BATCH - len(terms)
        return [t[0] for t in terms] + [0] * pads, [t[1] for t in terms] + [0] * pads


class MulNonNative(Gate):
    """x y = q m + r over 9 limbs of 29 bits, carries b_i offset by 2^33:
    conv_i + r_i + (b_{i-1} - 2^33) - 2^29 (b_i - 2^33) = 0."""

    N = 9

    def __init__(self, ff):
        self.m = limbs29(MODULI[ff])
        self.num_wires, self.num_constraints = 4 * self.N + 2 * self.N - 2, 2 * self.N - 1

    def eval(self, alg, w, c, ctx):
        N, m = self.N, self.m
        x, y, r, q, b = w[:N], w[N:2 * N], w[2 * N:3 * N], w[3 * N:4 * N], w[4 * N:]
        out, prev = [], None
        for i in range(2 * N - 1):
            acc = alg.zero()
            for j in range(max(i - N + 1, 0), min(i + 1, N)):
                acc = alg.add(acc, alg.sub(alg.mul_const(q[i - j], m[j]), alg.mul(x[j], y[i - j])))
            if i < N:
                acc = alg.add(acc, r[i])
            if prev is not None:
                acc = alg.add(acc, prev)
            if i < 2 * N - 2:
                cur = alg.add_const(b[i], -CARRY_OFFSET)
                out.append(alg.sub(acc, alg.mul_const(cur, 1 << BITS)))
                prev = cur
            else:
                out.append(acc)
        return out


class NonNativeAddSub(Gate):
    """Per op of 36 wires (a, b, s, ovf, 8 carries stored +1):
    add: a + b - s - ovf m + carries = 0; sub: a - b + ovf m - d + carries = 0;
    then ovf boolean and each stored carry in {0, 1, 2}."""

    N = 9
    WIDTH = 36

    def __init__(self, ff, ops, is_sub):
        self.m, self.ops, self.is_sub = limbs29(MODULI[ff]), ops, is_sub
        self.num_wires = ops * self.WIDTH
        self.num_constraints = ops * (2 * self.N)

    def eval(self, alg, w, c, ctx):
        N, m = self.N, self.m
        out = []
        for op in range(self.ops):
            o = op * self.WIDTH
            a, b, s = w[o:o + N], w[o + N:o + 2 * N], w[o + 2 * N:o + 3 * N]
            ovf, cs = w[o + 3 * N], w[o + 3 * N + 1:o + 4 * N]
            prev = None
            for i in range(N):
                if self.is_sub:
                    acc = alg.sub(alg.add(alg.sub(a[i], b[i]), alg.mul_const(ovf, m[i])), s[i])
                else:
                    acc = alg.sub(alg.sub(alg.add(a[i], b[i]), s[i]), alg.mul_const(ovf, m[i]))
                if prev is not None:
                    acc = alg.add(acc, prev)
                if i < N - 1:
                    cur = alg.add_const(cs[i], -1)
                    acc = alg.sub(acc, alg.mul_const(cur, 1 << BITS))
                    prev = cur
                out.append(acc)
            out.append(alg.mul(ovf, alg.add_const(ovf, -1)))
            for cv in cs:
                out.append(alg.mul(alg.mul(cv, alg.add_const(cv, -1)), alg.add_const(cv, -2)))
        return out


class NonNativeAddMany(Gate):
    """sum of k values = s + ovf m, carries offset by 2^33."""

    N = 9

    def __init__(self, ff, k):
        self.m, self.k = limbs29(MODULI[ff]), k
        self.num_wires, self.num_constraints = k * self.N + self.N + 1 + self.N - 1, self.N

    def eval(self, alg, w, c, ctx):
        N, m, k = self.N, self.m, self.k
        s, ovf, cs = w[k * N:(k + 1) * N], w[(k + 1) * N], w[(k + 1) * N + 1:]
        out, prev = [], None
        for i in range(N):
            acc = alg.zero()
            for t in range(k):
                acc = alg.add(acc, w[t * N + i])
            acc = alg.sub(alg.sub(acc, s[i]), alg.mul_const(ovf, m[i]))
            if prev is not None:
                acc = alg.add(acc, prev)
            if i < N - 1:
                cur = alg.add_const(cs[i], -CARRY_OFFSET)
                acc = alg.sub(acc, alg.mul_const(cur, 1 << BITS))
                prev = cur
            out.append(acc)
        return out


class BigCmp(Gate):
    """le = (a <= b) by a borrow chain, per op of 37 wires (a, b, le, d, brw)."""

    N = 9
    WIDTH = 2 * 9 + 1 + 9 + 9

    def __init__(self, ops):
        self.ops = ops
        self.num_wires, self.num_constraints = ops * self.WIDTH, ops * (2 * self.N + 1)

    def eval(self, alg, w, c, ctx):
        N = self.N
        out = []
        for op in range(self.ops):
            o = op * self.WIDTH
            a, b, le = w[o:o + N], w[o + N:o + 2 * N], w[o + 2 * N]
            d, brw = w[o + 2 * N + 1:o + 3 * N + 1], w[o + 3 * N + 1:o + 4 * N + 1]
            for i in range(N):
                acc = alg.sub(b[i], a[i])
                if i:
                    acc = alg.sub(acc, brw[i - 1])
                acc = alg.sub(alg.add(acc, alg.mul_const(brw[i], 1 << BITS)), d[i])
                out.append(acc)
            out.extend(alg.mul(x, alg.add_const(x, -1)) for x in brw)
            out.append(alg.sub(alg.add(le, brw[N - 1]), alg.one()))
        return out


class RandomAccess(Gate):
    """Per copy: idx, out, 2^bits items (routed), then every copy's bits,
    then two half-selects per copy where bits >= 4."""

    def __init__(self, bits, copies):
        self.bits, self.copies = bits, copies
        self.vec = 1 << bits
        self.routed = 2 + self.vec
        self.split = bits >= 4
        self.num_wires = copies * (self.routed + bits) + (2 * copies if self.split else 0)
        self.num_constraints = copies * (bits + 2 + (2 if self.split else 0))

    def _interp(self, alg, items, bits):
        for b in bits:
            items = [alg.add(items[2 * i], alg.mul(b, alg.sub(items[2 * i + 1], items[2 * i])))
                     for i in range(len(items) // 2)]
        return items[0]

    def eval(self, alg, w, c, ctx):
        out = []
        for cp in range(self.copies):
            base = cp * self.routed
            bo = self.copies * self.routed + cp * self.bits
            bits = w[bo:bo + self.bits]
            out.extend(alg.mul(b, alg.add_const(b, -1)) for b in bits)
            acc = alg.zero()
            for b in reversed(bits):
                acc = alg.add(alg.mul_const(acc, 2), b)
            out.append(alg.sub(acc, w[base]))
            items = w[base + 2:base + 2 + self.vec]
            if self.split:
                ho = self.copies * (self.routed + self.bits) + 2 * cp
                t0, t1 = w[ho], w[ho + 1]
                half = self.vec // 2
                out.append(alg.sub(self._interp(alg, items[:half], bits[:-1]), t0))
                out.append(alg.sub(self._interp(alg, items[half:], bits[:-1]), t1))
                sel = alg.add(t0, alg.mul(bits[-1], alg.sub(t1, t0)))
            else:
                sel = self._interp(alg, items, bits)
            out.append(alg.sub(sel, w[base + 1]))
        return out


class Poseidon(Gate):
    """One Poseidon2 permutation a row: 12 inputs, 12 outputs, then the
    S-box inputs of full rounds 1-3, of the 22 partial rounds (lane 0) and
    of full rounds 26-29.  Each stored wire equals the previous round's
    linear image; the outputs equal the last round's."""

    W, HF, PR = ps.WIDTH, ps.HALF_FULL, ps.PARTIAL
    num_wires = 130
    num_constraints = 118

    def eval(self, alg, w, c, ctx):
        W, HF, PR, TR = self.W, self.HF, self.PR, ps.ROUNDS
        ME, MI, RC = ps.ME.tolist(), ps.MI.tolist(), ps.RC.tolist()

        def sbox(x):
            x2 = alg.mul(x, x)
            return alg.mul(alg.mul(x2, x2), alg.mul(x2, x))

        def lincomb(row, terms, const):
            acc = alg.zero()
            for k, t in zip(row, terms):
                if k % P:
                    acc = alg.add(acc, alg.mul_const(t, k))
            return alg.add_const(acc, const) if const % P else acc

        full_a = 2 * W
        partial = full_a + (HF - 1) * W
        full_b = partial + PR
        cons = []
        sb = [sbox(lincomb(ME[i], w[:W], RC[0][i])) for i in range(W)]
        for r in range(1, HF):
            ws = w[full_a + (r - 1) * W:full_a + r * W]
            cons += [alg.sub(ws[i], lincomb(ME[i], sb, RC[r][i])) for i in range(W)]
            sb = [sbox(x) for x in ws]
        # the partial rounds' state as integer coefficients over the S-box
        # outputs met so far, plus a constant
        basis = list(sb)
        C = [list(row) for row in ME]
        d = [0] * W
        for p in range(PR):
            r = HF + p
            up = w[partial + p]
            cons.append(alg.sub(up, lincomb(C[0], basis, d[0] + RC[r][0])))
            basis.append(sbox(up))
            nb = len(basis)
            rows_C = [[0] * (nb - 1) + [1]] + [C[i] + [0] * (nb - len(C[i])) for i in range(1, W)]
            rows_d = [0] + [(d[i] + RC[r][i]) % P for i in range(1, W)]
            C = [[sum(MI[i][j] * rows_C[j][k] for j in range(W)) % P for k in range(nb)]
                 for i in range(W)]
            d = [sum(MI[i][j] * rows_d[j] for j in range(W)) % P for i in range(W)]
        for r in range(HF + PR, TR):
            ws = w[full_b + (r - HF - PR) * W:full_b + (r - HF - PR + 1) * W]
            for i in range(W):
                expr = (lincomb(C[i], basis, d[i] + RC[r][i]) if r == HF + PR
                        else lincomb(ME[i], sb, RC[r][i]))
                cons.append(alg.sub(ws[i], expr))
            sb = [sbox(x) for x in ws]
        cons += [alg.sub(w[W + i], lincomb(ME[i], sb, 0)) for i in range(W)]
        return cons


_PARSERS = [
    (r"Noop", lambda: Noop()),
    (r"Poseidon", lambda: Poseidon()),
    (r"Constant\((\d+)\)", lambda k: Constant(int(k))),
    (r"PublicInput\((\d+)\)", lambda k: PublicInput(int(k))),
    (r"Arithmetic\((\d+)\)", lambda k: Arithmetic(int(k))),
    (r"BaseSum2\((\d+),(\d+)\)", lambda o, b: BaseSum2(int(o), int(b))),
    (r"RangeLookup\((\d+),(\d+),(\d+)\)", lambda b, v, lb: RangeLookup(int(b), int(v), int(lb))),
    (r"MulNonNative\((\w+)\)", lambda ff: MulNonNative(ff)),
    (r"NonNativeAdd\((\w+),(\d+)\)", lambda ff, o: NonNativeAddSub(ff, int(o), False)),
    (r"NonNativeSub\((\w+),(\d+)\)", lambda ff, o: NonNativeAddSub(ff, int(o), True)),
    (r"NonNativeAddMany\((\w+),(\d+)\)", lambda ff, k: NonNativeAddMany(ff, int(k))),
    (r"BigCmp\((\d+)\)", lambda o: BigCmp(int(o))),
    (r"RandomAccess\((\d+),(\d+)\)", lambda b, c: RandomAccess(int(b), int(c))),
]


def parse(gate_id: str) -> Gate:
    for pattern, make in _PARSERS:
        m = re.fullmatch(pattern, gate_id)
        if m:
            return make(*m.groups())
    raise ValueError(f"no reference constraints for gate {gate_id!r}")
