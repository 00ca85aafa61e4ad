"""Static circuit-template builder with a batched witness tape.

Counterpart of ``plonky2_ecdsa_tpu.circuit.builder`` (host code, numpy).

TPU-first redesign of plonky2's CircuitBuilder + generator graph (SURVEY.md §7
design stance): gadget calls

  1. allocate gate rows / wire targets and copy constraints (the template,
     built ONCE per circuit shape), and
  2. append vectorized "tape" ops — closures over numpy that compute witness
     values for a whole signature batch at a time.

The reference's per-target SimpleGenerator dependency graph
(src/gadgets/biguint.rs:483-548 etc.) disappears: tape order IS a valid
dependency order, and each op is a tensor program over the batch axis
(the axis that replaces rayon in the reference, SURVEY.md §2 parallelism
inventory).

Copy constraints are a union-find over targets; `build()` resolves classes,
packs pending range checks into pooled rows, pads to a power of two, and
emits the fixed polynomials (selectors, constants, sigmas).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..fields import goldilocks_host as gl
from .config import CircuitConfig
from .witness import gadd, gmul, gmul_const
from .gates import (
    ArithmeticGate,
    BaseSum2Gate,
    BigCmpGate,
    ConstantGate,
    Gate,
    NonNativeAddGate,
    NoopGate,
    PublicInputGate,
    RandomAccessGate,
    RangeCheckGate,
    RangeLookupGate,
)

P = gl.P


@dataclass
class TapeOp:
    fn: object          # callable(ev) -> None
    writes: list        # target ids written
    label: str = ""
    rec: object = None  # (kind, params) record for the native executor


class Evaluator:
    """Runtime context handed to tape ops: batched value table access."""

    def __init__(self, vals: np.ndarray, read_map: np.ndarray):
        self.vals = vals          # [num_targets, B] uint64
        self.read_map = read_map  # target -> written representative

    def get(self, tids):
        """tids: int or int-array -> values [B] or [..., B]."""
        return self.vals[self.read_map[np.asarray(tids)]]

    def set(self, tids, data):
        self.vals[np.asarray(tids)] = data


@dataclass
class PublicInputLayout:
    rows: list          # row indices of PI gate rows
    num_cols: int       # PIs per row
    count: int          # total registered public inputs


@dataclass
class Circuit:
    config: CircuitConfig
    n: int                      # padded row count (power of two)
    gates: list                 # distinct gate instances (selector order)
    row_gate_idx: np.ndarray    # [n] index into gates (-1 -> noop/padding)
    constants: np.ndarray       # [num_constant_cols, n] uint64
    sigmas: np.ndarray          # [num_routed, n] uint64 (position encodings)
    selectors: np.ndarray       # [num_gates, n] uint64 0/1
    pos_rows: np.ndarray        # positions with targets: row indices
    pos_cols: np.ndarray        # positions with targets: col indices
    pos_tids: np.ndarray        # resolved (read_map'd) target per position
    tape: list
    read_map: np.ndarray
    num_targets: int
    inputs: dict                # name -> np.ndarray of target ids
    pi: PublicInputLayout
    pi_tids: np.ndarray         # resolved targets of public inputs, in order
    constant_values: dict       # tid -> int
    k_coeffs: list              # cosets shifts k_j for routed columns
    gate_rows: dict             # gate_idx -> np.ndarray of row indices
    # device-derived witness targets (see _flush_range_pools): per range-check
    # pool kind {bits: (V, nl, limb_bits, rows array)}; derived_tids are
    # excluded from the uploaded value table and recomputed on device from
    # the value wires
    range_layouts: dict = field(default_factory=dict)
    derived_tids: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    # LogUp range lookups: wire column holding the table multiplicities
    # (None when the circuit has no range lookups)
    lookup_mult_col: int | None = None

    # ---- witness generation -------------------------------------------------
    def generate_witness(self, inputs: dict, batch: int,
                         native: bool = True) -> np.ndarray:
        """inputs: name -> [B, len(target_list)] uint64 arrays.
        Returns witness matrix W [num_wires, n, B] uint64 plus keeps the
        resolved value table for public-input extraction.

        native: run tape ops through the C++ executor (the ``native``
        package) where it has an op.  The numpy closures remain the
        semantic reference; both paths share the value table and give
        bit-identical results (tested).  When the native tape is asked for
        and its library does not build, this raises."""
        vals = self.value_table(inputs, batch, native)
        W = np.zeros((self.config.num_wires, self.n, batch), dtype=np.uint64)
        W[self.pos_cols, self.pos_rows] = vals[self.pos_tids]
        return W

    def value_table(self, inputs: dict, batch: int, native: bool = True) -> np.ndarray:
        """The witness tape run on `inputs` (as for generate_witness): the
        value of every target, [num_targets, B] uint64, which is what
        prover.Prover.run_vals takes.  public_input_values() reads it."""
        vals =np.zeros((self.num_targets, batch), dtype=np.uint64)
        for tid, v in self.constant_values.items():
            vals[tid] = v
        for name, tids in self.inputs.items():
            data = np.asarray(inputs[name], dtype=np.uint64)
            assert data.shape == (batch, len(tids)), (name, data.shape, len(tids))
            vals[tids] = data.T
        ev = Evaluator(vals, self.read_map)
        if native:
            self._native_tape().run(ev)
        else:
            for op in self.tape:
                op.fn(ev)
        self.last_tape_native = native
        self._last_vals = vals
        return vals

    def _native_tape(self):
        nt = getattr(self, "_native_tape_cache", None)
        if nt is None:
            from ..native import NativeTape

            nt = NativeTape(self)
            self._native_tape_cache = nt
        return nt

    def public_input_values(self) -> np.ndarray:
        """[B, num_pis] after generate_witness."""
        return self._last_vals[self.pi_tids].T


class CircuitBuilder:
    def __init__(self, config: CircuitConfig | None = None):
        self.config = config or CircuitConfig.standard_ecc_config()
        cfg = self.config
        self.rows: list[tuple[Gate, tuple]] = []   # (gate, constant col values)
        self._gate_index: dict[str, int] = {}
        self.gates: list[Gate] = []
        self.row_gate_idx: list[int] = []
        self.num_targets = 0
        self._parent: list[int] = []
        self._wire_targets: dict[tuple[int, int], int] = {}
        self.tape: list[TapeOp] = []
        self._written: set[int] = set()
        self._write_order: dict[int, int] = {}
        self.constant_values: dict[int, int] = {}
        self._const_cache: dict[int, int] = {}
        self.inputs: dict[str, list[int]] = {}
        self.public_input_targets: list[int] = []
        self._pending_range: dict[int, list[int]] = {29: [], 34: []}
        self._slots: dict = {}
        # derived packing widths
        self.arith_ops = cfg.num_routed_wires // ArithmeticGate.WIRES_PER_OP
        self.basesum_ops = min(cfg.num_routed_wires // 30, cfg.num_wires // 30)
        self.ra_copies = cfg.num_routed_wires // 18
        self.rc_vals = {29: cfg.num_wires // 16, 34: cfg.num_wires // 18}
        # nonnative add/sub + cmp pack op-major; every wire of an op must be
        # ROUTED (limbs connect to other gates), so the packing width is
        # bounded by the routed-wire count (2 at the standard 80)
        self.nn_ops = max(1, min(cfg.num_routed_wires, cfg.num_wires)
                          // NonNativeAddGate.OP_WIDTH)
        self.cmp_ops = max(1, min(cfg.num_routed_wires, cfg.num_wires)
                           // BigCmpGate.OP_WIDTH)

    # ------------------------------------------------------------------ targets
    def new_target(self) -> int:
        t = self.num_targets
        self.num_targets += 1
        self._parent.append(t)
        return t

    def new_targets(self, k: int) -> list[int]:
        return [self.new_target() for _ in range(k)]

    def _find(self, t: int) -> int:
        p = self._parent
        root = t
        while p[root] != root:
            root = p[root]
        while p[t] != root:
            p[t], t = root, p[t]
        return root

    def connect(self, a: int, b: int):
        ra, rb = self._find(a), self._find(b)
        if ra != rb:
            self._parent[max(ra, rb)] = min(ra, rb)

    # ------------------------------------------------------------------- rows
    def _gate_idx(self, gate: Gate) -> int:
        gid = gate.gate_id()
        if gid not in self._gate_index:
            assert gate.num_wires <= self.config.num_wires, (gid, gate.num_wires)
            self._gate_index[gid] = len(self.gates)
            self.gates.append(gate)
        return self._gate_index[gid]

    def add_row(self, gate: Gate, constants: tuple = ()) -> int:
        gi = self._gate_idx(gate)
        row = len(self.rows)
        self.rows.append((gate, constants))
        self.row_gate_idx.append(gi)
        return row

    def wire(self, row: int, col: int) -> int:
        key = (row, col)
        t = self._wire_targets.get(key)
        if t is None:
            t = self.new_target()
            self._wire_targets[key] = t
        return t

    def _fill_partial_slots(self):
        """Complete partially-filled pooled rows whose gate type is NOT
        satisfied by all-zero wires (NonNativeAdd/Sub carry offsets, BigCmp's
        le): the gate's fill_empty connects each unused op slot's wires to
        the satisfying constants."""
        for state in self._slots.values():
            row, used, cap = state
            gate = self.rows[row][0]
            fill = getattr(gate, "fill_empty", None)
            if fill is None:
                continue
            for op in range(used, cap):
                fill(self, row, op)
            state[1] = cap

    def op_slot(self, key, gate_factory, constants: tuple = ()):
        """Packed multi-op gates: returns (row, op_index)."""
        state = self._slots.get(key)
        if state is None or state[1] >= state[2]:
            gate = gate_factory()
            row = self.add_row(gate, constants)
            cap = None
            for attr in ("num_ops", "num_vals", "num_copies", "num_consts"):
                cap = getattr(gate, attr, None)
                if cap is not None:
                    break
            assert cap, gate
            state = [row, 0, cap]
            self._slots[key] = state
        row, idx, _ = state
        state[1] += 1
        return row, idx

    # ------------------------------------------------------------------- tape
    def add_op(self, fn, writes, label: str = "", rec=None):
        for t in writes:
            if t not in self._written:
                self._written.add(t)
                self._write_order[t] = len(self.tape)
        self.tape.append(TapeOp(fn, list(writes), label, rec))

    def mark_written(self, targets):
        for t in targets:
            if t not in self._written:
                self._written.add(t)
                self._write_order[t] = len(self.tape)

    # ------------------------------------------------ native-field operations
    def constant(self, v: int) -> int:
        v %= P
        t = self._const_cache.get(v)
        if t is not None:
            return t
        nc = self.config.num_constant_cols
        row, idx = self.op_slot("const", lambda: ConstantGate(nc), None)
        # constants tuple finalized later; store values on the row record
        gate, consts = self.rows[row]
        if consts is None:
            consts = [0] * nc
            self.rows[row] = (gate, consts)
        consts[idx] = v
        t = self.wire(row, idx)
        self.constant_values[t] = v
        self._const_cache[v] = t
        self.mark_written([t])
        return t

    def zero(self) -> int:
        return self.constant(0)

    def one(self) -> int:
        return self.constant(1)

    def add_virtual_target(self) -> int:
        return self.new_target()

    def add_virtual_targets(self, k: int) -> list[int]:
        return self.new_targets(k)

    def register_input(self, name: str, targets):
        self.inputs[name] = list(targets)
        self.mark_written(targets)

    def register_public_input(self, t: int):
        self.public_input_targets.append(t)

    def register_public_inputs(self, ts):
        for t in ts:
            self.register_public_input(t)

    def arithmetic(self, c0: int, c1: int, m1: int, m2: int, addend: int) -> int:
        """out = c0 * m1 * m2 + c1 * addend (plonky2 arithmetic op shape)."""
        c0 %= P
        c1 %= P
        row, idx = self.op_slot(("arith", c0, c1), lambda: ArithmeticGate(self.arith_ops),
                                (c0, c1))
        g: ArithmeticGate = self.rows[row][0]
        wm1, wm2, wad, wout = (self.wire(row, w) for w in g.wires_op(idx))
        self.connect(wm1, m1)
        self.connect(wm2, m2)
        self.connect(wad, addend)

        def fill(ev, tids=(m1, m2, addend), out=wout, c0=c0, c1=c1):
            a, b, c = ev.get(tids[0]), ev.get(tids[1]), ev.get(tids[2])
            ev.set(out, gadd(gmul(gmul_const(a, c0), b), gmul_const(c, c1)))

        self.add_op(fill, [wout], "arith",
                    rec=("arith", dict(m1=m1, m2=m2, ad=addend, out=wout,
                                       c0=c0, c1=c1)))
        return wout

    def mul(self, a: int, b: int) -> int:
        return self.arithmetic(1, 0, a, b, a)

    def add(self, a: int, b: int) -> int:
        one = self.one()
        return self.arithmetic(1, 1, a, one, b)

    def sub(self, a: int, b: int) -> int:
        one = self.one()
        return self.arithmetic(1, P - 1, a, one, b)

    def mul_add(self, a: int, b: int, c: int) -> int:
        """a*b + c (split recombination workhorse, split_nonnative.rs:44-47)."""
        return self.arithmetic(1, 1, a, b, c)

    def mul_const(self, c: int, a: int) -> int:
        one = self.one()
        return self.arithmetic(c, 0, a, one, one)

    def add_const(self, a: int, c: int) -> int:
        one = self.one()
        return self.arithmetic(c, 1, one, one, a)

    def assert_zero(self, a: int):
        self.connect(a, self.zero())

    def assert_one(self, a: int):
        self.connect(a, self.one())

    def assert_bool(self, b: int):
        # b*b - b == 0
        t = self.arithmetic(1, P - 1, b, b, b)
        self.assert_zero(t)

    def not_(self, b: int) -> int:
        one = self.one()
        return self.arithmetic(P - 1, 1, b, one, one)

    def and_(self, a: int, b: int) -> int:
        return self.mul(a, b)

    def select(self, b: int, x: int, y: int) -> int:
        """b ? x : y  =  b*(x-y) + y."""
        d = self.sub(x, y)
        return self.arithmetic(1, 1, b, d, y)

    def is_equal(self, a: int, b: int) -> int:
        """BoolTarget a == b via inverse hint (plonky2 is_equal semantics)."""
        d = self.sub(a, b)
        inv = self.add_virtual_target()
        eq = self.add_virtual_target()
        from .witness import gmul, gsub

        def fill(ev, d=d, inv=inv, eq=eq):
            dv = ev.get(d)
            nz = dv != 0
            iv = np.zeros_like(dv)
            if nz.any():
                flat = dv[nz]
                iv[nz] = np.array([pow(int(x), -1, P) for x in flat.ravel()],
                                  dtype=np.uint64).reshape(flat.shape)
            ev.set(inv, iv)
            ev.set(eq, (~nz).astype(np.uint64))

        self.add_op(fill, [inv, eq], "is_equal",
                    rec=("is_equal", dict(d=d, inv=inv, eq=eq)))
        # d*inv = 1 - eq  ->  d*inv + eq - 1 = 0
        t = self.arithmetic(1, 1, d, inv, eq)
        self.assert_one(t)
        # d*eq = 0
        t2 = self.mul(d, eq)
        self.assert_zero(t2)
        return eq

    # -------------------------------------------------------- structured ops
    def split_le_base2(self, x: int, bits: int = 29) -> list[int]:
        """x -> `bits` boolean targets, little-endian (split_le_base::<2>)."""
        row, idx = self.op_slot(("basesum", bits),
                                lambda: BaseSum2Gate(self.basesum_ops, bits))
        g: BaseSum2Gate = self.rows[row][0]
        wv = self.wire(row, g.wire_value(idx))
        self.connect(wv, x)
        bit_ts = [self.wire(row, g.wire_bit(idx, j)) for j in range(bits)]

        def fill(ev, x=x, outs=np.array(bit_ts), bits=bits):
            v = ev.get(x)
            data = np.stack([(v >> np.uint64(j)) & np.uint64(1) for j in range(bits)])
            ev.set(outs, data)

        self.add_op(fill, bit_ts, "split",
                    rec=("split", dict(x=x, bits=bit_ts)))
        return bit_ts

    def random_access(self, idx_t: int, items: list[int]) -> int:
        """out = items[idx]; len(items) must be 16 (4-bit window)."""
        assert len(items) == 16
        row, copy = self.op_slot("ra", lambda: RandomAccessGate(4, self.ra_copies))
        g: RandomAccessGate = self.rows[row][0]
        self.connect(self.wire(row, g.wire_idx(copy)), idx_t)
        for i, it in enumerate(items):
            self.connect(self.wire(row, g.wire_item(copy, i)), it)
        out = self.wire(row, g.wire_out(copy))
        bit_ts = [self.wire(row, g.wire_bit(copy, j)) for j in range(4)]
        half_ts = ([self.wire(row, g.wire_half(copy, k)) for k in range(2)]
                   if g.split else [])

        def fill(ev, idx_t=idx_t, items=np.array(items), out=out,
                 bits=np.array(bit_ts), halves=np.array(half_ts, dtype=np.int64)):
            iv = ev.get(idx_t).astype(np.int64)  # [B]
            vals = ev.get(items)                 # [16, B]
            ev.set(out, np.take_along_axis(vals, iv[None, :], axis=0)[0])
            ev.set(bits, np.stack([(iv >> j) & 1 for j in range(4)]).astype(np.uint64))
            if halves.size:
                low = iv & 7
                ev.set(halves, np.stack([
                    np.take_along_axis(vals[:8], low[None, :], axis=0)[0],
                    np.take_along_axis(vals[8:], low[None, :], axis=0)[0],
                ]))

        self.add_op(fill, [out] + bit_ts + half_ts, "random_access",
                    rec=("random_access", dict(idx=idx_t, items=items, out=out,
                                               bits=bit_ts, halves=half_ts)))
        return out

    def range_check(self, t: int, bits: int):
        """Queue t for a pooled range check (flushed at build)."""
        assert bits in self._pending_range, bits
        self._pending_range[bits].append(t)

    # ------------------------------------------------------------------ build
    def _flush_range_pools(self):
        """Pack pending range checks into LogUp RangeLookup rows.

        Each pooled value gets limb wires (limb_bits each) + a recombination
        constraint on the gate; limb range membership is proven by the global
        LogUp argument against the row-index table (see RangeLookupGate).
        The limbs are sink wires derived on device (range_layouts)."""
        cfg = self.config
        lb = cfg.range_lookup_limb_bits
        mask = np.uint64((1 << lb) - 1)
        self._range_rows: dict[int, list[int]] = {}
        self._range_gate_shape: dict[int, tuple] = {}  # bits -> (V, nl)
        self._range_limb_tids: list[int] = []
        self._lookup_rows: list[tuple] = []   # (gate, [value targets])
        for bits, pool in self._pending_range.items():
            if not pool:
                continue
            nl = -(-bits // lb)
            # V sized to the pool: tiny circuits get tiny gates (fewer LogUp
            # helper columns -> smaller jit module), big pools pack fully
            V = min(cfg.num_routed_wires, (cfg.num_wires - 1) // (1 + nl),
                    cfg.range_lookup_vals, len(pool))
            gate = RangeLookupGate(bits, V, lb)
            self._range_rows[bits] = []
            self._range_gate_shape[bits] = (V, nl)
            for off in range(0, len(pool), V):
                chunk = pool[off : off + V]
                row = self.add_row(gate)
                self._range_rows[bits].append(row)
                limb_ts = []
                for v, t in enumerate(chunk):
                    self.connect(self.wire(row, gate.wire_value(v)), t)
                    limb_ts.append([self.wire(row, gate.wire_limb(v, j))
                                    for j in range(nl)])
                for vl in limb_ts:
                    self._range_limb_tids.extend(vl)
                flat = np.array(limb_ts)  # [V', nl]

                def fill(ev, ts=np.array(chunk), outs=flat, nl=nl, lb=lb,
                         mask=mask):
                    v = ev.get(ts)  # [V', B]
                    limbs = np.stack(
                        [(v >> np.uint64(lb * j)) & mask for j in range(nl)],
                        axis=1)  # [V', nl, B]
                    ev.set(outs, limbs)

                self.add_op(fill, flat.ravel().tolist(), f"range{bits}",
                            rec=("range_lookup", dict(vals=chunk, limbs=flat,
                                                      nl=nl, lb=lb)))
                self._lookup_rows.append((gate, list(chunk)))
        self._pending_range = {29: [], 34: []}

    def _add_multiplicity_column(self, n: int) -> int | None:
        """Create the LogUp multiplicity wire column (last wire col, every
        row) + the tape op counting each table value's occurrences among all
        looked-up limb terms.  Returns the column index (None if no lookups)."""
        if not self._lookup_rows:
            return None
        cfg = self.config
        lb = cfg.range_lookup_limb_bits
        assert n >= (1 << lb), (
            f"LogUp limb_bits={lb} needs n >= {1 << lb}, circuit has n={n}; "
            "lower config.range_lookup_limb_bits for small circuits")
        mult_col = cfg.num_wires - 1
        m_ts = np.array([self.wire(r, mult_col) for r in range(n)])
        # group value targets by gate parameter set; count static zero terms:
        # every lookup-gate row contributes exactly nb*BATCH terms (real limb
        # reads of the chunk's values, zero-reads of unused value slots, and
        # structural batch pads) — all non-real ones are lookups of 0
        nb = max(g_.num_batches for g_, _ in self._lookup_rows)
        groups: dict = {}
        zero_terms = 0
        for gate, chunk in self._lookup_rows:
            key = (gate.bits, gate.num_limbs, gate.scale)
            groups.setdefault(key, []).extend(chunk)
            zero_terms += nb * gate.BATCH - len(chunk) * gate.terms_per_val
        ginfo = [(np.array(vals), nlimbs, scale)
                 for (bits, nlimbs, scale), vals in groups.items()]
        mask = np.uint64((1 << lb) - 1)

        def fill_m(ev, ginfo=ginfo, m_ts=m_ts, n=n, lb=lb, mask=mask,
                   zero_terms=zero_terms):
            B = ev.vals.shape[1]
            terms = []
            for vals, nlimbs, scale in ginfo:
                v = ev.get(vals)  # [K, B]
                limbs = [(v >> np.uint64(lb * j)) & mask for j in range(nlimbs)]
                terms.extend(limbs)
                if scale > 1:
                    terms.append(limbs[-1] * np.uint64(scale))
            allt = np.concatenate(terms, axis=0)  # [T, B]
            m = np.zeros((n, B), np.uint64)
            for b in range(B):
                col = allt[:, b].astype(np.int64)
                # out-of-table terms (possible only for invalid witnesses)
                # are skipped: no multiplicity can match them anyway
                m[:, b] = np.bincount(col[col < n], minlength=n)
            m[0] += np.uint64(zero_terms)
            ev.set(m_ts, m)

        self.add_op(fill_m, m_ts.tolist(), "lookup_mult",
                    rec=("lookup_mult", dict(
                        groups=[(vals, nlimbs, scale)
                                for vals, nlimbs, scale in ginfo],
                        m_ts=m_ts, n=n, lb=lb, zero_terms=zero_terms)))
        return mult_col

    def _add_public_input_rows(self) -> PublicInputLayout:
        K = 8
        rows = []
        pis = self.public_input_targets
        for off in range(0, len(pis), K):
            chunk = pis[off : off + K]
            row = self.add_row(PublicInputGate(K))
            rows.append(row)
            for j, t in enumerate(chunk):
                self.connect(self.wire(row, j), t)
            # unused PI wires constrained to 0 via PI poly value 0; leave targets unset
        return PublicInputLayout(rows=rows, num_cols=K, count=len(pis))

    def build(self) -> Circuit:
        cfg = self.config
        self._fill_partial_slots()
        self._flush_range_pools()
        pi_layout = self._add_public_input_rows()

        num_rows = len(self.rows)
        n = max(8, 1 << (num_rows - 1).bit_length())
        noop = NoopGate()
        noop_idx = self._gate_idx(noop) if num_rows < n else None
        while len(self.rows) < n:
            self.rows.append((noop, ()))
            self.row_gate_idx.append(noop_idx)
        lookup_mult_col = self._add_multiplicity_column(n)

        # constant columns
        constants = np.zeros((cfg.num_constant_cols, n), dtype=np.uint64)
        for r, (gate, consts) in enumerate(self.rows):
            if consts:
                for j, v in enumerate(consts):
                    constants[j, r] = v

        # selectors
        selectors = np.zeros((len(self.gates), n), dtype=np.uint64)
        rgi = np.array(self.row_gate_idx, dtype=np.int64)
        for gi in range(len(self.gates)):
            selectors[gi, rgi == gi] = 1
        gate_rows = {gi: np.nonzero(rgi == gi)[0] for gi in range(len(self.gates))}

        # resolve classes -> read_map
        roots = np.array([self._find(t) for t in range(self.num_targets)], dtype=np.int64)
        read_map = np.full(self.num_targets, -1, dtype=np.int64)
        order = self._write_order
        best: dict[int, tuple[int, int]] = {}
        for t in self._written:
            r = int(roots[t])
            o = order[t]
            if r not in best or o < best[r][0]:
                best[r] = (o, t)
        for t in range(self.num_targets):
            r = int(roots[t])
            read_map[t] = best[r][1] if r in best else t  # unwritten classes -> self (0s)

        # positions
        pos_rows, pos_cols, pos_tids = [], [], []
        for (row, col), t in self._wire_targets.items():
            pos_rows.append(row)
            pos_cols.append(col)
            pos_tids.append(read_map[t])
        pos_rows = np.array(pos_rows, dtype=np.int64)
        pos_cols = np.array(pos_cols, dtype=np.int64)
        pos_tids = np.array(pos_tids, dtype=np.int64)

        # sigma permutation over routed positions
        sigmas, k_coeffs = self._compute_sigmas(n, roots)

        pi_tids = np.array([read_map[t] for t in self.public_input_targets], dtype=np.int64)

        # device-derived range limbs: only sinks (singleton copy classes) are
        # safe to drop from the uploaded table
        class_size = np.bincount(roots, minlength=self.num_targets)
        limb_tids = np.array(getattr(self, "_range_limb_tids", []), dtype=np.int64)
        if limb_tids.size:
            derived_tids = limb_tids[class_size[roots[limb_tids]] == 1]
        else:
            derived_tids = np.zeros(0, np.int64)
        range_layouts = {}
        lb = cfg.range_lookup_limb_bits
        for bits, rows in getattr(self, "_range_rows", {}).items():
            if rows:
                V, nl = self._range_gate_shape[bits]
                range_layouts[bits] = (V, nl, lb, np.array(rows, dtype=np.int64))

        return Circuit(
            config=cfg,
            n=n,
            gates=self.gates,
            row_gate_idx=rgi,
            constants=constants,
            sigmas=sigmas,
            selectors=selectors,
            pos_rows=pos_rows,
            pos_cols=pos_cols,
            pos_tids=pos_tids,
            tape=self.tape,
            read_map=read_map,
            num_targets=self.num_targets,
            inputs={k: np.array(v, dtype=np.int64) for k, v in self.inputs.items()},
            pi=pi_layout,
            pi_tids=pi_tids,
            constant_values=self.constant_values,
            k_coeffs=k_coeffs,
            gate_rows=gate_rows,
            range_layouts=range_layouts,
            derived_tids=derived_tids,
            lookup_mult_col=lookup_mult_col,
        )

    def _compute_sigmas(self, n: int, roots: np.ndarray):
        cfg = self.config
        nr = cfg.num_routed_wires
        # subgroup generator of order n:
        g = gl.root_of_unity(n)
        assert pow(g, n, P) == 1 and pow(g, n // 2, P) != 1
        # coset shifts: k_j = 7^j, distinct cosets checked
        k_coeffs = [pow(7, j, P) for j in range(nr)]
        seen = {pow(k, n, P) for k in k_coeffs}
        assert len(seen) == nr, "k_i cosets collide; pick different shifts"

        # identity encoding: sigma_j[row] = k_j * g^row, then apply cycles
        g_pows = gl.geometric(1, g, n)
        sigmas = np.stack([gl.mul_const(g_pows, kj) for kj in k_coeffs])

        # group routed positions by class
        classes: dict[int, list[tuple[int, int]]] = {}
        for (row, col), t in self._wire_targets.items():
            if col < nr:
                classes.setdefault(int(roots[t]), []).append((row, col))
        for members in classes.values():
            if len(members) < 2:
                continue
            encs = [int(sigmas[c, r]) for (r, c) in members]
            # cyclic shift: position i gets encoding of position i+1
            for i, (r, c) in enumerate(members):
                sigmas[c, r] = encs[(i + 1) % len(members)]
        return sigmas, k_coeffs
