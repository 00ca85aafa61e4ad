"""The compiled prover (Prover on a CUDA device captures its device side as a
CUDA graph and replays it; prover/graph.py), held on the CPU:

  (a) a capture-safety guard around the graph's body (the device expand and
      prove_core, then the pack; or prove_core of a full witness) refuses
      everything a capture would refuse or a replay would freeze: a read of a
      tensor's value on the host (item, tolist, numpy, cpu, bool, int, index,
      float), host data made into a tensor (torch.tensor, as_tensor,
      from_numpy), an op whose output shape depends on the data (nonzero,
      masked_select, unique), indexing by a Python list or a numpy array, and
      a table cached on the device that the warm-up did not fill.  The kernels'
      plain versions stand for the kernels and are not guarded;
  (b) the packed readback equals the per-leaf readback leaf for leaf;
  (c) the Prover's proofs equal the reference's numpy proofs leaf for leaf;
  (d) two batches dispatched before either is collected give the proofs of
      the two batches proved alone.

On the CPU the Prover runs eagerly: the graph path itself runs only on the
card (chip_smoke.py)."""

import functools

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from plonky2_ecdsa_tpu.circuit import examples as ref_examples
from plonky2_ecdsa_tpu.prover import data as ref_data_mod
from plonky2_ecdsa_tpu.prover import prover as ref_prover
from plonky2_ecdsa_tpu_torch import trace
from plonky2_ecdsa_tpu_torch.api import int_to_limbs
from plonky2_ecdsa_tpu_torch.circuit import gates
from plonky2_ecdsa_tpu_torch.circuit.examples import (nonnative_mul_chain_circuit,
                                                      small_demo_circuit, small_demo_witness)
from plonky2_ecdsa_tpu_torch.curve import native as cn
from plonky2_ecdsa_tpu_torch.fields import goldilocks as gl
from plonky2_ecdsa_tpu_torch.hash import poseidon, poseidon_cuda
from plonky2_ecdsa_tpu_torch.prover import fri, ntt, ntt_cuda, prover
from plonky2_ecdsa_tpu_torch.prover.data import build_circuit_data
from test_torch_bridge import from_reference_proof
from test_torch_prover import FOLDING, REF_FOLDING

# ---------------------------------------------------------------------------
# (a) the capture-safety guard
# ---------------------------------------------------------------------------

_T = torch.Tensor
_HOST_READS = {_T.item: "Tensor.item", _T.tolist: "Tensor.tolist", _T.numpy: "Tensor.numpy",
               _T.cpu: "Tensor.cpu", _T.__bool__: "Tensor.__bool__", _T.__int__: "Tensor.__int__",
               _T.__index__: "Tensor.__index__", _T.__float__: "Tensor.__float__",
               torch.tensor: "torch.tensor", torch.as_tensor: "torch.as_tensor"}
_DATA_SHAPED = ("nonzero", "masked_select", "_unique2", "unique_dim", "unique_consecutive",
                "_local_scalar_dense", "is_nonzero")
# the device tables cached at first use: a replay would read what the capture
# left in them, so the warm-up must have made every one
_CACHED_TABLES = (ntt.coset_powers, ntt._inverse_post, ntt_cuda.twiddles, ntt_cuda.four_step_T,
                  fri.domain_tables, gates._const_col)
# the kernels' plain versions: on the card these are kernel launches
_PLAIN = ((poseidon, "permute_plain"), (poseidon_cuda, "sponge_plain"),
          (poseidon_cuda, "grind_plain"), (ntt_cuda, "sub_ntt_plain"))


def _host_index(idx) -> str | None:
    """The type name of a Python list or numpy array in an index, if any."""
    if isinstance(idx, tuple):
        return next(filter(None, map(_host_index, idx)), None)
    return type(idx).__name__ if isinstance(idx, (list, np.ndarray)) else None


class _FunctionGuard(TorchFunctionMode):
    def __init__(self, guard):
        super().__init__()
        self.guard = guard

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if not self.guard.suspended:
            if func in _HOST_READS:
                self.guard.hazards.append(_HOST_READS[func])
            elif func in (_T.__getitem__, _T.__setitem__) and _host_index(args[1]):
                self.guard.hazards.append(f"{func.__name__} by {_host_index(args[1])}")
        return func(*args, **(kwargs or {}))


class _DispatchGuard(TorchDispatchMode):
    def __init__(self, guard):
        super().__init__()
        self.guard = guard

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.guard.suspended and func.overloadpacket.__name__ in _DATA_SHAPED:
            self.guard.hazards.append(f"aten.{func.overloadpacket.__name__}")
        return func(*args, **(kwargs or {}))


class CaptureGuard:
    """Within `with CaptureGuard(monkeypatch) as g:`, g.hazards lists every
    capture hazard met, in order, and g.cache_misses the cached device
    tables built anew."""

    def __init__(self, monkeypatch):
        self.hazards, self.suspended = [], 0
        for module, name in _PLAIN:
            monkeypatch.setattr(module, name, self._unguarded(getattr(module, name)))

        def from_numpy(*args, **kwargs):
            if not self.suspended:
                self.hazards.append("torch.from_numpy")
            return real(*args, **kwargs)

        real = torch.from_numpy
        monkeypatch.setattr(torch, "from_numpy", from_numpy)

    def _unguarded(self, fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            self.suspended += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self.suspended -= 1
        return run

    def __enter__(self):
        self._misses = [t.cache_info().misses for t in _CACHED_TABLES]
        self._modes = [_FunctionGuard(self), _DispatchGuard(self)]
        for m in self._modes:
            m.__enter__()
        return self

    def __exit__(self, *exc):
        for m in reversed(self._modes):
            m.__exit__(*exc)
        self.cache_misses = [t.__name__ for t, k in zip(_CACHED_TABLES, self._misses)
                             if t.cache_info().misses != k]


# ---------------------------------------------------------------------------
# circuits, witnesses and the reference's proofs
# ---------------------------------------------------------------------------

def _nonnative_inputs(seed: int, batch: int = 2) -> dict:
    rng = np.random.default_rng(seed)
    xs = [int.from_bytes(rng.bytes(40), "little") % cn.SECP256K1.p for _ in range(batch)]
    ys = [int.from_bytes(rng.bytes(40), "little") % cn.SECP256K1.p for _ in range(batch)]
    return {"x": int_to_limbs(xs), "y": int_to_limbs(ys)}


def _demo_table(c, batch: int, seed: int):
    """small_demo_witness's statements as the tape's value table, and the PIs."""
    rng = np.random.default_rng(seed + batch)
    xs = rng.integers(0, 1 << 29, size=(batch, 1), dtype=np.uint64)
    ys = rng.integers(0, gl.P, size=(batch, 1), dtype=np.uint64) % np.uint64(gl.P)
    return c.value_table({"x": xs, "y": ys}, batch), c.public_input_values()


@pytest.fixture(scope="module")
def demo():
    """The demo circuit (one RangeLookup gate), its B=2 witness, and the value
    tables of that witness (seed 42) and of another (seed 43)."""
    c = small_demo_circuit().build()
    W, pis = small_demo_witness(c, batch=2)
    tables = [_demo_table(c, 2, seed) for seed in (42, 43)]
    assert np.array_equal(tables[0][1], pis)
    return build_circuit_data(c, "cpu"), W, pis, tables


@pytest.fixture(scope="module")
def nonnative():
    """The nonnative-mul chain under the folding config (two RangeLookup
    gates: _lookup_polys_all's batch inversion over several gates), with the
    value tables of two seeds."""
    c = nonnative_mul_chain_circuit(config=FOLDING).build()
    tables = []
    for seed in (5, 6):
        vals = c.value_table(_nonnative_inputs(seed), 2)
        tables.append((vals, c.public_input_values()))
    return build_circuit_data(c, "cpu"), tables


@pytest.fixture(scope="module")
def references():
    """The reference's numpy proofs: the demo at B=2 and the nonnative chain
    at seed 5, as host Proofs of this package."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PLONKY2_TPU_HOST_BUILD", "1")
    try:
        rc = ref_examples.small_demo_circuit().build()
        demo_proof = ref_prover.prove(ref_data_mod.build_circuit_data(rc),
                                      *ref_examples.small_demo_witness(rc, batch=2))
        rn = ref_examples.nonnative_mul_chain_circuit(config=REF_FOLDING).build()
        W = rn.generate_witness(_nonnative_inputs(5), 2)
        nn_proof = ref_prover.prove(ref_data_mod.build_circuit_data(rn), W,
                                    rn.public_input_values())
    finally:
        mp.undo()
    return from_reference_proof(demo_proof), from_reference_proof(nn_proof)


def _graph_body(run, expand, inputs):
    """What a Prover's graphs run (prover._CapturedProve), on the CPU: the
    expand and _front ("front"), _quotient_chunk on contiguous chunk buffers
    ("chunk", per domain chunk), _back and the pack ("back"), with the
    graphs' trace stamps."""
    data, bk = run.data, run.backend

    def body():
        wires, pi, pis = prover._expand_stamped(expand, inputs)
        fr = prover._front(data, bk, wires, pi, pis)
        quot = [prover._quotient_chunk(data, bk, fr, *(v.contiguous() for v in
                                                      prover._quotient_slices(bk, fr, sl)))
                for sl in prover._chunks(data.N)]
        proof = prover._back(data, bk, fr, torch.cat(quot, -1), pis)
        packed = prover._pack_proof(proof)
        trace.stamp("pack")
        return packed, prover._pack_spec(proof)

    body.whole = lambda: prover._pack_proof(prover.prove_core(data, bk, *expand(*inputs)))
    return body


def _vals_body(run, vals):
    """The "vals" graphs' body: the upload's device expand first."""
    return _graph_body(run, run._expand, (torch.from_numpy(run._compact(vals).view(np.int64)),))


def _wide_body(run, W, pis):
    """The "wide" graphs' body: prove_core's parts on a full witness."""
    return _graph_body(run, lambda *t: t, prover._inputs_to_device(run.data, W, pis))


def _guarded(body, monkeypatch):
    """prove_core on the body's inputs as the warm-up, then the body under
    the guard, which must give the same packed proof -> the guard."""
    want = body.whole()
    with CaptureGuard(monkeypatch) as guard:
        got = body()
    assert torch.equal(got[0], want), "the graphs' parts prove otherwise than prove_core"
    return guard


@pytest.mark.parametrize("case", ["demo_vals", "demo_wide", "nonnative_vals"])
def test_capture_guard_passes_the_graph_body(case, demo, nonnative, monkeypatch):
    """The graphs' bodies at B=2: the demo circuit from its value table and
    from its full witness, and the nonnative chain (two lookup gates) from
    its value table."""
    if case.startswith("demo"):
        data, W, pis, tables = demo
        run = prover.Prover(data)
        body = (_vals_body(run, tables[0][0]) if case == "demo_vals"
                else _wide_body(run, W, pis))
    else:
        data, tables = nonnative
        run = prover.Prover(data)
        body = _vals_body(run, tables[0][0])
    guard = _guarded(body, monkeypatch)
    assert guard.hazards == [], f"capture hazards in the graph body: {guard.hazards}"
    assert guard.cache_misses == [], f"tables built inside the capture: {guard.cache_misses}"


def _plant_item(x):
    x[..., :1].sum().item()


def _plant_list_index(x):
    x[..., [0, 1]]


def _plant_upload(x):
    torch.tensor([1, 2], device=x.device)


def _plant_from_numpy(x):
    gl.from_u64(np.arange(3, dtype=np.uint64), x.device)


def _plant_nonzero(x):
    torch.nonzero(x)


def _plant_bool(x):
    bool((x == 0).any())


def _plant_table(x):
    ntt.coset_powers(7, False, x.device)


@pytest.mark.parametrize("plant, hazards", [
    (_plant_item, ["Tensor.item", "aten._local_scalar_dense"]),
    (_plant_list_index, ["__getitem__ by list"]),
    (_plant_upload, ["torch.tensor"]),
    (_plant_from_numpy, ["torch.from_numpy"]),
    (_plant_nonzero, ["aten.nonzero"]),
    (_plant_bool, ["Tensor.__bool__", "aten._local_scalar_dense"]),
    (_plant_table, ["coset_powers"])])
def test_capture_guard_catches_a_planted_hazard(plant, hazards, demo, monkeypatch):
    """One hazard planted in prove_core (in the wires commit) is named by the
    guard, and nothing else of the stages up to the first challenges is."""
    data, W, pis, _tables = demo
    bk = prover.Backend(data)
    inputs = prover._inputs_to_device(data, W, pis)
    prover.prove_core(data, bk, *inputs, stop_after="challenges")
    commit = prover._lde_commit

    def planted(vals, *args):
        plant(vals)
        return commit(vals, *args)

    monkeypatch.setattr(prover, "_lde_commit", planted)
    with CaptureGuard(monkeypatch) as guard:
        prover.prove_core(data, bk, *inputs, stop_after="challenges")
    assert guard.hazards + guard.cache_misses == hazards


# ---------------------------------------------------------------------------
# (b) the packed readback
# ---------------------------------------------------------------------------

def _per_leaf_host(p, pis):
    """The readback the packed one replaced: every leaf on its own."""
    def h(x):
        return prover._map_leaves(gl.to_u64, x)

    fp = p.fri_proof
    return prover.Proof(
        pis=np.asarray(pis, dtype=np.uint64), wires_cap=h(p.wires_cap), zs_cap=h(p.zs_cap),
        quotient_cap=h(p.quotient_cap), openings0=h(p.openings0), openings1=h(p.openings1),
        fri_proof=fri.FriProof(
            caps=h(fp.caps), final_coeffs=h(fp.final_coeffs),
            indices=fp.indices.cpu().numpy(), layer_leaves=h(fp.layer_leaves),
            layer_paths=h(fp.layer_paths), pow_witness=h(fp.pow_witness)),
        initial_leaves=h(p.initial_leaves), initial_paths=h(p.initial_paths), layout=p.layout)


@pytest.mark.parametrize("case", ["demo", "nonnative"])
def test_packed_readback_equals_per_leaf_readback(case, demo, nonnative):
    if case == "demo":
        data, W, pis, _tables = demo
    else:
        data, tables = nonnative
        vals, pis = tables[0]
        W = data.circuit.witness_matrix(vals)
    device_proof = prover.prove_core(data, prover.Backend(data),
                                     *prover._inputs_to_device(data, W, pis))
    buf = prover._pack_proof(device_proof)
    assert buf.dtype == torch.int64 and buf.dim() == 1
    got = prover._unpack_proof(buf.numpy(), prover._pack_spec(device_proof), pis)
    want = _per_leaf_host(device_proof, pis)
    assert prover.first_difference(want, got) is None
    assert got.fri_proof.indices.dtype == np.int64 and got.wires_cap.dtype == np.uint64
    assert list(got.initial_leaves) == list(want.initial_leaves)      # key order kept
    assert prover.first_difference(want, prover.to_host(device_proof, pis)) is None


# ---------------------------------------------------------------------------
# (c) against the reference, (d) two batches in flight
# ---------------------------------------------------------------------------

def test_prover_proofs_equal_the_references(demo, nonnative, references):
    """run_vals (value table) and dispatch/collect (full witness) on the CPU,
    leaf for leaf against the reference's numpy proofs."""
    ref_demo, ref_nn = references
    data, W, pis, tables = demo
    run = prover.Prover(data)
    assert prover.first_difference(ref_demo, run.collect(run.dispatch(W, pis))) is None
    assert prover.first_difference(ref_demo, run.run_vals(*tables[0])) is None
    data, tables = nonnative
    run = prover.Prover(data)
    assert prover.first_difference(ref_nn, run.run_vals(*tables[0])) is None
    assert run.graph_stats == {}            # the CPU path captures nothing


def test_two_batches_in_flight(demo, references):
    """Batch 2 dispatched before batch 1 is collected: both proofs equal the
    proofs of the two batches proved alone (the first: the reference's), and
    differ from each other."""
    data, _W, _pis, tables = demo
    run = prover.Prover(data)
    alone = [references[0], run.run_vals(*tables[1])]
    h1 = run.dispatch_vals(*tables[0])
    h2 = run.dispatch_vals(*tables[1])
    got = [run.collect(h1), run.collect(h2)]
    for a, g in zip(alone, got):
        assert prover.first_difference(a, g) is None
    assert prover.proof_digest(got[0]) != prover.proof_digest(got[1])
