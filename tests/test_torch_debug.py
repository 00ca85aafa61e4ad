"""The port's witness sanitizer (utils/debug.py, numpy) against the
reference's on the cases of the reference's own sanitizer tests: an honest
witness, a non-canonical wire, a pooled value over its bound, a corrupt lookup
limb, a top limb over its scaled bound.  Tolerance 0: the counts are equal."""

import numpy as np
import pytest

from plonky2_ecdsa_tpu.circuit.examples import nonnative_mul_chain_circuit as ref_chain_circuit
from plonky2_ecdsa_tpu.utils import debug as ref_debug
from plonky2_ecdsa_tpu_torch.api import int_to_limbs
from plonky2_ecdsa_tpu_torch.circuit.examples import nonnative_mul_chain_circuit
from plonky2_ecdsa_tpu_torch.circuit.gates import RangeLookupGate
from plonky2_ecdsa_tpu_torch.curve import native as cn
from plonky2_ecdsa_tpu_torch.fields.goldilocks import P
from plonky2_ecdsa_tpu_torch.utils.debug import assert_witness_ok, witness_violations


@pytest.fixture(scope="module")
def chain():
    c, ref_c = nonnative_mul_chain_circuit().build(), ref_chain_circuit().build()
    rng = np.random.default_rng(11)
    xs = [int.from_bytes(rng.bytes(40), "little") % cn.SECP256K1.p for _ in range(2)]
    ys = [int.from_bytes(rng.bytes(40), "little") % cn.SECP256K1.p for _ in range(2)]
    W = c.generate_witness({"x": int_to_limbs(xs), "y": int_to_limbs(ys)}, 2)
    gi, g = next((gi, g) for gi, g in enumerate(c.gates) if isinstance(g, RangeLookupGate))
    return c, ref_c, W, g, int(c.gate_rows[gi][0])


def _both(chain, W) -> dict:
    """The port's counts, held equal to the reference's on the same witness."""
    c, ref_c, _W, _g, _row = chain
    got = witness_violations(c, W)
    assert got == {k: int(v) for k, v in ref_debug.witness_violations(ref_c, W).items()}
    return got


def test_honest_witness_is_clean(chain):
    counts = _both(chain, chain[2])
    assert any(k.startswith("range_") for k in counts) and not any(counts.values())
    assert_witness_ok(chain[0], chain[2])


def test_noncanonical_wire_is_counted(chain):
    bad = chain[2].copy()
    bad[0, 0, 0] = np.uint64(P)                      # == p: a second encoding of 0
    assert _both(chain, bad)["canonicity"] == 1
    with pytest.raises(AssertionError, match="canonicity"):
        assert_witness_ok(chain[0], bad)


def test_pool_value_over_its_bound_is_counted(chain):
    _c, _ref_c, W, g, row = chain
    bad = W.copy()
    bad[g.wire_value(0), row, 0] += np.uint64(1) << np.uint64(g.bits)
    assert _both(chain, bad)[f"range_{g.bits}"] >= 1


def test_corrupt_lookup_limb_is_counted(chain):
    _c, _ref_c, W, g, row = chain
    bad = W.copy()
    bad[g.wire_limb(0, 0), row, 0] = np.uint64(1) << np.uint64(g.limb_bits)
    assert _both(chain, bad)[f"lookup_limb_{g.bits}"] >= 1


def test_top_limb_over_its_scaled_bound_is_counted(chain):
    """A top limb inside the plain limb range but over the scaled table range
    (bits is no multiple of limb_bits) is caught by the scaled check alone."""
    c, _ref_c, W, _g, _row = chain
    gi, g = next((gi, g) for gi, g in enumerate(c.gates)
                 if isinstance(g, RangeLookupGate) and g.scale > 1)
    bad = W.copy()
    bad[g.wire_limb(0, g.num_limbs - 1), int(c.gate_rows[gi][0]), 1] = \
        np.uint64((1 << g.limb_bits) - 1)
    assert _both(chain, bad)[f"lookup_limb_{g.bits}"] == 1
