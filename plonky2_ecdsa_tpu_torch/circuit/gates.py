"""Gate inventory: constraint systems of the circuit IR.

Counterpart of ``plonky2_ecdsa_tpu.circuit.gates`` (the stacked evaluators
are not carried: the prover evaluates ``Gate.eval`` with a tensor algebra;
PoseidonGate lives in ``circuit.poseidon_gate``).

Design stance (SURVEY.md §7): wide fused gates instead of the reference's
per-UX-op rows, so each nonnative operation costs 1 row plus shared
range-check rows.  Key parity points with the reference:

  * MulNonNativeGate fuses the reference's MulNonnativeGate + CheckSumGate pair
    (src/gates/mul_nonnative.rs:26-478) into one row: the 17-limb carry-free
    convolution constraints and the base-2^29 carry chain (carries offset by
    2^33, externally range-checked to (0, 2^34)) are combined by eliminating
    the intermediate check_sum wires:
        conv_i(x,y,q,r) + (b_{i-1} - 2^33) - 2^29 (b_i - 2^33) = 0
    Same soundness statement (x*y = q*m + r limbwise after carries), half the
    rows, 17 degree-2 constraints.
  * Range checks use base-4 decompositions packed many-values-per-row
    (plonky2_ux range_check_ux_circuit equivalent; SURVEY.md §2.10).
  * Selectors are boolean per-gate-instance fixed polynomials.

Every gate's `eval` is written once against an algebra adapter and runs
vectorized over the LDE coset (prover) or at zeta in GF(p^2) (verifier) —
the reference's eval_unfiltered / eval_unfiltered_circuit duality.
"""

from __future__ import annotations

from .foreign import BITS, ForeignField

CARRY_OFFSET = 1 << 33  # CheckSum carry offset (mul_nonnative.rs:373,414)
CARRY_BITS = 34         # external carry range (0, 2^34) (nonnative.rs:453)


class Gate:
    """Base class. Subclasses define wire layout + constraints.

    Wires with index < num_routed (config) participate in copy constraints;
    each gate places its connectable wires first.
    """

    def gate_id(self) -> str:
        raise NotImplementedError

    @property
    def num_wires(self) -> int:
        raise NotImplementedError

    @property
    def num_constraints(self) -> int:
        raise NotImplementedError

    @property
    def degree(self) -> int:
        raise NotImplementedError

    def eval(self, alg, wires, consts, ctx):
        """Return list of constraint values (algebra elements)."""
        raise NotImplementedError

    def eval_circuit(self, builder, wires, consts, ctx=None):
        """Evaluate this gate's constraints in-circuit over ExtTarget wires.

        plonky2 `eval_unfiltered_circuit` analogue (reference
        src/gates/mul_nonnative.rs:132-166): `wires`/`consts` are ExtTarget
        openings (in a recursive verifier: the proof's claimed openings at
        zeta); returns constraint values as ExtTargets.  Defined here on the
        base class (not monkeypatched from circuit.recursion) so availability
        never depends on import order; the algebra adapter lives in
        circuit.recursion."""
        from .recursion import CircuitExtAlgebra

        return self.eval(CircuitExtAlgebra(builder), wires, consts, ctx or {})

    def __repr__(self):
        return self.gate_id()


class NoopGate(Gate):
    def gate_id(self):
        return "Noop"

    num_wires = 0
    num_constraints = 0
    degree = 0

    def eval(self, alg, wires, consts, ctx):
        return []


class ConstantGate(Gate):
    """Exposes the row's constant-column values as routed wires.

    plonky2 ConstantGate equivalent (needed by constant_biguint etc.,
    src/gadgets/biguint.rs:165-175)."""

    def __init__(self, num_consts: int):
        self.num_consts = num_consts

    def gate_id(self):
        return f"Constant({self.num_consts})"

    @property
    def num_wires(self):
        return self.num_consts

    @property
    def num_constraints(self):
        return self.num_consts

    degree = 1

    def eval(self, alg, wires, consts, ctx):
        return [alg.sub(wires[i], consts[i]) for i in range(self.num_consts)]


class PublicInputGate(Gate):
    """K routed wires constrained to equal the public-input polynomials
    PI_j(x) (standard-PLONK public input binding: the verifier evaluates
    PI_j(zeta) = sum_i pi_{j,i} * L_{row_i}(zeta) itself; no in-circuit hash
    needed).  Fills the role of plonky2's PublicInputGate."""

    def __init__(self, num_cols: int = 8):
        self.num_cols = num_cols

    def gate_id(self):
        return f"PublicInput({self.num_cols})"

    @property
    def num_wires(self):
        return self.num_cols

    @property
    def num_constraints(self):
        return self.num_cols

    degree = 1

    def eval(self, alg, wires, consts, ctx):
        pis = ctx["pi_vals"]  # num_cols algebra elements (PI_j at the point(s))
        return [alg.sub(wires[i], pis[i]) for i in range(self.num_cols)]


class ArithmeticGate(Gate):
    """num_ops independent ops: out = c0 * m1 * m2 + c1 * addend.

    plonky2 ArithmeticGate equivalent — backs mul/add/sub/mul_add/bool logic
    (used via split recombination, src/gadgets/split_nonnative.rs:38-47, etc.).
    c0, c1 are the row's two constant-column values (shared by all ops)."""

    WIRES_PER_OP = 4  # m1, m2, addend, out

    def __init__(self, num_ops: int):
        self.num_ops = num_ops

    def gate_id(self):
        return f"Arithmetic({self.num_ops})"

    @property
    def num_wires(self):
        return self.num_ops * self.WIRES_PER_OP

    @property
    def num_constraints(self):
        return self.num_ops

    degree = 3  # c0 (committed poly) * wire * wire

    def wires_op(self, i):
        b = i * self.WIRES_PER_OP
        return b, b + 1, b + 2, b + 3  # m1, m2, addend, out

    def eval(self, alg, wires, consts, ctx):
        c0, c1 = consts[0], consts[1]
        out = []
        for i in range(self.num_ops):
            m1, m2, ad, o = self.wires_op(i)
            t = alg.mul(c0, alg.mul(wires[m1], wires[m2]))
            t = alg.add(t, alg.mul(c1, wires[ad]))
            out.append(alg.sub(t, wires[o]))
        return out


class BaseSum2Gate(Gate):
    """num_ops values decomposed into `bits` little-endian binary bits.

    Equivalent of plonky2's split_le_base::<2> rows used by
    split_nonnative_to_bits (src/gadgets/nonnative.rs:566-582) and the 2/4-bit
    digit splits (src/gadgets/split_nonnative.rs:25-72).  The bit wires are
    routed (digit recombination consumes them)."""

    def __init__(self, num_ops: int, bits: int = BITS):
        self.num_ops = num_ops
        self.bits = bits

    def gate_id(self):
        return f"BaseSum2({self.num_ops},{self.bits})"

    @property
    def num_wires(self):
        return self.num_ops * (1 + self.bits)

    @property
    def num_constraints(self):
        return self.num_ops * (1 + self.bits)

    degree = 2

    def wire_value(self, op):
        return op * (1 + self.bits)

    def wire_bit(self, op, j):
        return op * (1 + self.bits) + 1 + j

    def eval(self, alg, wires, consts, ctx):
        out = []
        for op in range(self.num_ops):
            acc = alg.zero()
            for j in reversed(range(self.bits)):
                b = wires[self.wire_bit(op, j)]
                acc = alg.add(alg.mul_const(acc, 2), b)
                # booleanity appended after recomposition below
            out.append(alg.sub(acc, wires[self.wire_value(op)]))
            for j in range(self.bits):
                b = wires[self.wire_bit(op, j)]
                out.append(alg.mul(b, alg.add_const(b, -1)))
        return out


class RangeCheckGate(Gate):
    """num_vals values each constrained < 2^bits via non-routed base-4 limbs.

    Pool-packed: CircuitBuilder accumulates pending range checks (from nonnative
    muls/adds, cmp diffs, mul carries...) and flushes them V-per-row.
    Equivalent of plonky2_ux's range_check_ux_circuit at BITS=29 and 34
    (src/gadgets/nonnative.rs:453-460)."""

    def __init__(self, bits: int, num_vals: int):
        self.bits = bits
        self.num_vals = num_vals
        self.num_limbs = -(-bits // 2)
        self.top_base = 4 if bits % 2 == 0 else 2

    def gate_id(self):
        return f"RangeCheck({self.bits},{self.num_vals})"

    @property
    def num_wires(self):
        return self.num_vals * (1 + self.num_limbs)

    @property
    def num_constraints(self):
        return self.num_vals * (1 + self.num_limbs)

    degree = 4

    def wire_value(self, v):
        return v

    def wire_limb(self, v, j):
        return self.num_vals + v * self.num_limbs + j

    def eval(self, alg, wires, consts, ctx):
        out = []
        for v in range(self.num_vals):
            acc = alg.zero()
            for j in reversed(range(self.num_limbs)):
                acc = alg.mul_const(acc, 4)
                acc = alg.add(acc, wires[self.wire_limb(v, j)])
            out.append(alg.sub(acc, wires[self.wire_value(v)]))
            for j in range(self.num_limbs):
                l = wires[self.wire_limb(v, j)]
                base = self.top_base if j == self.num_limbs - 1 else 4
                c = alg.mul(l, alg.add_const(l, -1))
                if base == 4:
                    c = alg.mul(c, alg.add_const(l, -2))
                    c = alg.mul(c, alg.add_const(l, -3))
                out.append(c)
        return out


class RangeLookupGate(Gate):
    """num_vals values each constrained < 2^bits via limb LOOKUPS (LogUp).

    The lever that replaces RangeCheckGate's base-4 decomposition: each value
    v splits into nl = ceil(bits/limb_bits) little-endian limbs of limb_bits
    bits; membership of every limb — plus, when the top limb is narrower
    (rem = bits % limb_bits != 0), of top * 2^(limb_bits-rem) — in the table
    t(x) = canonical-row-index (a fixed polynomial covering [0, 2^limb_bits))
    proves each limb's range: top * scale < 2^limb_bits iff top < 2^rem.
    The only per-gate constraints here are the V recombinations
    v = sum_j 2^(limb_bits j) l_j (degree 1); the challenge-dependent LogUp
    helper/running-sum constraints are global, emitted by the prover/verifier
    alongside the permutation argument (prover._lookup_polys /
    _compute_quotient).

    At limb_bits=13 (needs n >= 2^13): 4 wires/value vs 16-20 for the base-4
    gate -> 28 values/row at 128 wires, which brings the ECDSA circuit from
    n=2^14 to n=2^13.  plonky2 gained equivalent LogUp machinery
    (LookupGate/LookupTableGate); the reference predates it and pays ~6
    range-check rows per nonnative mul (src/gadgets/nonnative.rs:453-460).
    """

    BATCH = 3  # LogUp helper batch size (filtered constraint degree 2+BATCH <= 5)

    def __init__(self, bits: int, num_vals: int, limb_bits: int = 13):
        self.bits = bits
        self.num_vals = num_vals
        self.limb_bits = limb_bits
        self.num_limbs = -(-bits // limb_bits)
        rem = bits % limb_bits
        self.top_bits = rem if rem else limb_bits
        self.scale = (1 << (limb_bits - rem)) if rem else 1

    def gate_id(self):
        return f"RangeLookup({self.bits},{self.num_vals},{self.limb_bits})"

    @property
    def num_wires(self):
        return self.num_vals * (1 + self.num_limbs)

    @property
    def num_constraints(self):
        return self.num_vals

    degree = 1

    def wire_value(self, v):
        return v

    def wire_limb(self, v, j):
        return self.num_vals + v * self.num_limbs + j

    @property
    def terms_per_val(self):
        return self.num_limbs + (1 if self.scale > 1 else 0)

    def lookup_terms(self):
        """[(wire_col, scale)] looked up in the row-index table, in order."""
        out = []
        for v in range(self.num_vals):
            for j in range(self.num_limbs):
                out.append((self.wire_limb(v, j), 1))
            if self.scale > 1:
                out.append((self.wire_limb(v, self.num_limbs - 1), self.scale))
        return out

    @property
    def num_batches(self):
        return -(-(self.num_vals * self.terms_per_val) // self.BATCH)

    def lookup_cols_scales(self, nb: int):
        """(cols, scales) int lists of length exactly nb * BATCH: the real
        terms, then structural pads (scale=0 -> f identically 0, a lookup of
        table value 0; the multiplicity column counts one zero per pad, see
        builder._add_multiplicity_column).  Uniform 3-term batches let the
        prover evaluate all helper products as stacked tensor ops."""
        terms = self.lookup_terms()
        pads = nb * self.BATCH - len(terms)
        assert pads >= 0
        cols = [c for c, _s in terms] + [0] * pads
        scales = [s for _c, s in terms] + [0] * pads
        return cols, scales

    def eval(self, alg, wires, consts, ctx):
        out = []
        for v in range(self.num_vals):
            acc = alg.zero()
            for j in reversed(range(self.num_limbs)):
                acc = alg.mul_const(acc, 1 << self.limb_bits)
                acc = alg.add(acc, wires[self.wire_limb(v, j)])
            out.append(alg.sub(acc, wires[self.wire_value(v)]))
        return out


class MulNonNativeGate(Gate):
    """Fused nonnative modular multiplication: x*y = q*m + r in 9x29-bit limbs.

    See module docstring; reference: src/gates/mul_nonnative.rs (MulNonnative
    53 wires + CheckSum 33 wires, 17+17 deg-2 constraints) fused to 52 wires /
    17 deg-2 constraints by eliminating check_sum.  External obligations
    (performed by the mul_nonnative gadget): x, y, q, r limbs < 2^29;
    b carries < 2^34."""

    N = 9

    def __init__(self, ff: ForeignField):
        self.ff = ff

    def gate_id(self):
        return f"MulNonNative({self.ff.name})"

    @property
    def num_wires(self):
        return 4 * self.N + (2 * self.N - 2)  # x,y,r,q + 16 carries

    @property
    def num_constraints(self):
        return 2 * self.N - 1

    degree = 2

    def wire_x(self, i):
        return i

    def wire_y(self, i):
        return self.N + i

    def wire_r(self, i):
        return 2 * self.N + i

    def wire_q(self, i):
        return 3 * self.N + i

    def wire_b(self, i):
        return 4 * self.N + i

    def eval(self, alg, wires, consts, ctx):
        N = self.N
        m = self.ff.limbs29
        out = []
        prev = None  # (b_{i-1} - OFF)
        for i in range(2 * N - 1):
            lo = max(i - N + 1, 0)
            hi = min(i + 1, N)
            acc = alg.zero()
            for j in range(lo, hi):
                qm = alg.mul_const(wires[self.wire_q(i - j)], m[j])
                xy = alg.mul(wires[self.wire_x(j)], wires[self.wire_y(i - j)])
                acc = alg.add(acc, alg.sub(qm, xy))
            if i < N:
                acc = alg.add(acc, wires[self.wire_r(i)])
            if prev is not None:
                acc = alg.add(acc, prev)
            if i < 2 * N - 2:
                cur = alg.add_const(wires[self.wire_b(i)], -CARRY_OFFSET)
                out.append(alg.sub(acc, alg.mul_const(cur, 1 << BITS)))
                prev = cur
            else:
                out.append(acc)
        return out


class NonNativeAddGate(Gate):
    """num_ops independent ops: a + b = s + ovf*m limbwise with in-gate
    {0,1,2} carries.

    Replaces the reference's hint+check add_nonnative row chain
    (src/gadgets/nonnative.rs:245-276): same statement (sum + overflow bool,
    sum limbs externally range-checked; cmp vs modulus separate).  Ops pack
    op-major at OP_WIDTH=36 wires (2 per 80-routed row; the single-op row
    wasted 92 of 128 wire columns — r5 P-256 shrink).  A partially-filled
    final row is completed by fill_empty (all-zero wires do NOT satisfy the
    carry constraints: the stored carry is offset by +1)."""

    N = 9
    OP_WIDTH = 3 * 9 + 1 + (9 - 1)  # a, b, s, ovf, carries = 36

    def __init__(self, ff: ForeignField, num_ops: int = 1):
        self.ff = ff
        self.num_ops = num_ops

    def gate_id(self):
        return f"NonNativeAdd({self.ff.name},{self.num_ops})"

    @property
    def num_wires(self):
        return self.num_ops * self.OP_WIDTH

    @property
    def num_constraints(self):
        return self.num_ops * (self.N + 1 + (self.N - 1))

    degree = 3

    def wire_a(self, i, op=0):
        return op * self.OP_WIDTH + i

    def wire_b(self, i, op=0):
        return op * self.OP_WIDTH + self.N + i

    def wire_s(self, i, op=0):
        return op * self.OP_WIDTH + 2 * self.N + i

    def wire_ovf(self, op=0):
        return op * self.OP_WIDTH + 3 * self.N

    def wire_c(self, i, op=0):
        return op * self.OP_WIDTH + 3 * self.N + 1 + i

    def fill_empty(self, b, row, op):
        """Make an unused op slot satisfiable: carries to the +1 offset's
        zero point (everything else stays the default 0)."""
        one = b.one()
        for i in range(self.N - 1):
            b.connect(b.wire(row, self.wire_c(i, op)), one)

    def eval(self, alg, wires, consts, ctx):
        N = self.N
        m = self.ff.limbs29
        out = []
        for op in range(self.num_ops):
            ovf = wires[self.wire_ovf(op)]
            prev = None
            for i in range(N):
                acc = alg.add(wires[self.wire_a(i, op)], wires[self.wire_b(i, op)])
                acc = alg.sub(acc, wires[self.wire_s(i, op)])
                acc = alg.sub(acc, alg.mul_const(ovf, m[i]))
                if prev is not None:
                    acc = alg.add(acc, prev)
                if i < N - 1:
                    cur = alg.add_const(wires[self.wire_c(i, op)], -1)  # {-1,0,1}
                    acc = alg.sub(acc, alg.mul_const(cur, 1 << BITS))
                    prev = cur
                out.append(acc)
            out.append(alg.mul(ovf, alg.add_const(ovf, -1)))  # ovf boolean
            for i in range(N - 1):
                c = wires[self.wire_c(i, op)]
                t = alg.mul(c, alg.add_const(c, -1))
                out.append(alg.mul(t, alg.add_const(c, -2)))  # c' in {0,1,2}
        return out


class NonNativeSubGate(Gate):
    """num_ops independent ops: d = a - b + ovf*m limbwise (reference
    sub_nonnative semantics, src/gadgets/nonnative.rs:356-388: a = d + b -
    ovf*m).  Packing/fill_empty as NonNativeAddGate."""

    N = 9
    OP_WIDTH = 3 * 9 + 1 + (9 - 1)  # 36

    def __init__(self, ff: ForeignField, num_ops: int = 1):
        self.ff = ff
        self.num_ops = num_ops

    def gate_id(self):
        return f"NonNativeSub({self.ff.name},{self.num_ops})"

    @property
    def num_wires(self):
        return self.num_ops * self.OP_WIDTH

    @property
    def num_constraints(self):
        return self.num_ops * (self.N + 1 + (self.N - 1))

    degree = 3

    def wire_a(self, i, op=0):
        return op * self.OP_WIDTH + i

    def wire_b(self, i, op=0):
        return op * self.OP_WIDTH + self.N + i

    def wire_d(self, i, op=0):
        return op * self.OP_WIDTH + 2 * self.N + i

    def wire_ovf(self, op=0):
        return op * self.OP_WIDTH + 3 * self.N

    def wire_c(self, i, op=0):
        return op * self.OP_WIDTH + 3 * self.N + 1 + i

    def fill_empty(self, b, row, op):
        one = b.one()
        for i in range(self.N - 1):
            b.connect(b.wire(row, self.wire_c(i, op)), one)

    def eval(self, alg, wires, consts, ctx):
        N = self.N
        m = self.ff.limbs29
        out = []
        for op in range(self.num_ops):
            ovf = wires[self.wire_ovf(op)]
            prev = None
            for i in range(N):
                acc = alg.sub(wires[self.wire_a(i, op)], wires[self.wire_b(i, op)])
                acc = alg.add(acc, alg.mul_const(ovf, m[i]))
                acc = alg.sub(acc, wires[self.wire_d(i, op)])
                if prev is not None:
                    acc = alg.add(acc, prev)
                if i < N - 1:
                    cur = alg.add_const(wires[self.wire_c(i, op)], -1)
                    acc = alg.sub(acc, alg.mul_const(cur, 1 << BITS))
                    prev = cur
                out.append(acc)
            out.append(alg.mul(ovf, alg.add_const(ovf, -1)))
            for i in range(N - 1):
                c = wires[self.wire_c(i, op)]
                t = alg.mul(c, alg.add_const(c, -1))
                out.append(alg.mul(t, alg.add_const(c, -2)))
        return out


class NonNativeAddManyGate(Gate):
    """Sum of K 9-limb values = s + ovf*m; carries offset by 2^33 and
    externally range-checked (34-bit pool), ovf externally 29-bit checked —
    matching the loose overflow contract of the reference's add_many_nonnative
    (src/gadgets/nonnative.rs:310-353)."""

    N = 9

    def __init__(self, ff: ForeignField, k: int = 4):
        self.ff = ff
        self.k = k

    def gate_id(self):
        return f"NonNativeAddMany({self.ff.name},{self.k})"

    @property
    def num_wires(self):
        return self.k * self.N + self.N + 1 + (self.N - 1)

    @property
    def num_constraints(self):
        return self.N

    degree = 2

    def wire_a(self, t, i):
        return t * self.N + i

    def wire_s(self, i):
        return self.k * self.N + i

    @property
    def wire_ovf(self):
        return (self.k + 1) * self.N

    def wire_c(self, i):
        return (self.k + 1) * self.N + 1 + i

    def eval(self, alg, wires, consts, ctx):
        N = self.N
        m = self.ff.limbs29
        ovf = wires[self.wire_ovf]
        out = []
        prev = None
        for i in range(N):
            acc = alg.zero()
            for t in range(self.k):
                acc = alg.add(acc, wires[self.wire_a(t, i)])
            acc = alg.sub(acc, wires[self.wire_s(i)])
            acc = alg.sub(acc, alg.mul_const(ovf, m[i]))
            if prev is not None:
                acc = alg.add(acc, prev)
            if i < N - 1:
                cur = alg.add_const(wires[self.wire_c(i)], -CARRY_OFFSET)
                acc = alg.sub(acc, alg.mul_const(cur, 1 << BITS))
                prev = cur
            out.append(acc)
        return out


class BigCmpGate(Gate):
    """le = (a <= b) for two 9-limb values via borrow chain; diff limbs
    externally 29-bit range-checked.  Equivalent of plonky2_ux
    list_le_ux_circuit used by cmp_biguint (src/gadgets/biguint.rs:221-229)."""

    N = 9
    OP_WIDTH = 2 * 9 + 1 + 9 + 9  # a, b, le, d, brw = 38

    def __init__(self, num_ops: int = 1):
        self.num_ops = num_ops

    def gate_id(self):
        return f"BigCmp({self.num_ops})"

    @property
    def num_wires(self):
        return self.num_ops * self.OP_WIDTH

    @property
    def num_constraints(self):
        return self.num_ops * (self.N + self.N + 1)

    degree = 2

    def wire_a(self, i, op=0):
        return op * self.OP_WIDTH + i

    def wire_b(self, i, op=0):
        return op * self.OP_WIDTH + self.N + i

    def wire_le(self, op=0):
        return op * self.OP_WIDTH + 2 * self.N

    def wire_d(self, i, op=0):
        return op * self.OP_WIDTH + 2 * self.N + 1 + i

    def wire_brw(self, i, op=0):
        return op * self.OP_WIDTH + 3 * self.N + 1 + i

    def fill_empty(self, b, row, op):
        """Unused op slot: a=b=0 needs le=1 (0 <= 0) to satisfy the final
        le + brw - 1 = 0 constraint; everything else is zero-satisfied."""
        b.connect(b.wire(row, self.wire_le(op)), b.one())

    def eval(self, alg, wires, consts, ctx):
        N = self.N
        out = []
        for op in range(self.num_ops):
            prev = None
            for i in range(N):
                # b_i - a_i - brw_{i-1} + 2^29*brw_i - d_i = 0
                acc = alg.sub(wires[self.wire_b(i, op)], wires[self.wire_a(i, op)])
                if prev is not None:
                    acc = alg.sub(acc, prev)
                acc = alg.add(acc, alg.mul_const(wires[self.wire_brw(i, op)], 1 << BITS))
                acc = alg.sub(acc, wires[self.wire_d(i, op)])
                out.append(acc)
                prev = wires[self.wire_brw(i, op)]
            for i in range(N):
                b = wires[self.wire_brw(i, op)]
                out.append(alg.mul(b, alg.add_const(b, -1)))
            out.append(alg.sub(alg.add(wires[self.wire_le(op)],
                                       wires[self.wire_brw(N - 1, op)]),
                               alg.one()))
        return out


class RandomAccessGate(Gate):
    """num_copies independent 16-way selects: out = items[idx].

    plonky2 RandomAccessGate equivalent — the in-circuit gather primitive
    behind random_access_curve_points (src/gadgets/curve_windowed_mul.rs:74-118).
    idx is decomposed into `bits` in-gate bits; selection via iterated
    linear interpolation.

    Degree management: a single (bits)-deep interpolation tree has degree
    bits+1 (= 5 at 4 bits), which would force an 8x LDE blowup.  For bits >= 4
    the select is split at the TOP bit through two non-routed intermediate
    wires: t0/t1 each select within their half using the low bits-1 bits
    (degree bits), and out = t0 + b_top*(t1 - t0) (degree 2) — max in-gate
    degree `bits` (4), so the whole circuit fits a 4x blowup."""

    def __init__(self, bits: int = 4, num_copies: int = 4):
        self.bits = bits
        self.vec_size = 1 << bits
        self.num_copies = num_copies
        self._routed_per_copy = 2 + self.vec_size
        self.split = bits >= 4

    def gate_id(self):
        return f"RandomAccess({self.bits},{self.num_copies})"

    @property
    def num_wires(self):
        return (self.num_copies * self._routed_per_copy
                + self.num_copies * self.bits
                + (2 * self.num_copies if self.split else 0))

    @property
    def num_constraints(self):
        return self.num_copies * (self.bits + 2 + (2 if self.split else 0))

    @property
    def degree(self):
        return self.bits if self.split else self.bits + 1

    def wire_idx(self, c):
        return c * self._routed_per_copy

    def wire_out(self, c):
        return c * self._routed_per_copy + 1

    def wire_item(self, c, i):
        return c * self._routed_per_copy + 2 + i

    def wire_bit(self, c, j):
        return self.num_copies * self._routed_per_copy + c * self.bits + j

    def wire_half(self, c, k):
        """Intermediate select-within-half wires (split mode; k in {0,1})."""
        return (self.num_copies * (self._routed_per_copy + self.bits) + c * 2 + k)

    def _interp(self, alg, items, bits):
        for b in bits:
            items = [
                alg.add(items[2 * i], alg.mul(b, alg.sub(items[2 * i + 1], items[2 * i])))
                for i in range(len(items) // 2)
            ]
        return items[0]

    def eval(self, alg, wires, consts, ctx):
        out = []
        for c in range(self.num_copies):
            bits = [wires[self.wire_bit(c, j)] for j in range(self.bits)]
            for b in bits:
                out.append(alg.mul(b, alg.add_const(b, -1)))
            acc = alg.zero()
            for j in reversed(range(self.bits)):
                acc = alg.add(alg.mul_const(acc, 2), bits[j])
            out.append(alg.sub(acc, wires[self.wire_idx(c)]))
            items = [wires[self.wire_item(c, i)] for i in range(self.vec_size)]
            if self.split:
                half = self.vec_size // 2
                t0, t1 = wires[self.wire_half(c, 0)], wires[self.wire_half(c, 1)]
                out.append(alg.sub(self._interp(alg, items[:half], bits[:-1]), t0))
                out.append(alg.sub(self._interp(alg, items[half:], bits[:-1]), t1))
                sel = alg.add(t0, alg.mul(bits[-1], alg.sub(t1, t0)))
            else:
                sel = self._interp(alg, items, bits)
            out.append(alg.sub(sel, wires[self.wire_out(c)]))
        return out

