"""The port's Poseidon2 (plain torch permutation, sponge, grind sweep)
against the reference's numpy path, its frozen digests, and (slow) the
reference's Pallas kernels in interpret mode."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from plonky2_ecdsa_tpu.fields import goldilocks as ref_gl
from plonky2_ecdsa_tpu.hash import poseidon as ref_ps
from plonky2_ecdsa_tpu.prover.challenger import Challenger as RefChallenger
from plonky2_ecdsa_tpu.prover.prover import _batch_inverse_axis1 as ref_batch_inverse
from plonky2_ecdsa_tpu_torch.fields import goldilocks as gl
from plonky2_ecdsa_tpu_torch.hash import poseidon, poseidon_cuda
from plonky2_ecdsa_tpu_torch.prover.prover import _batch_inverse_axis1

P = ref_gl.P
DIGESTS = os.path.join(os.path.dirname(__file__), "vectors", "preflight_digests.json")


def _digest(*arrs):
    h = hashlib.sha256()
    for a in arrs:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _states(seed, shape):
    return np.random.default_rng(seed).integers(0, P, shape, dtype=np.uint64)


def test_plain_permutation_matches_reference():
    v = _states(11, (12, 64))
    want = ref_gl.to_u64(*ref_ps.permute_stacked(*ref_gl.from_u64(v)))
    assert np.array_equal(gl.to_u64(poseidon.permute_plain(gl.from_u64(v))), want)
    # the dispatching entry point takes the plain version for a CPU tensor
    assert np.array_equal(gl.to_u64(poseidon.permute_stacked(gl.from_u64(v))), want)


@pytest.mark.parametrize("bad", ["meta", "int32", "strided", "width"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    x = {"meta": torch.zeros((12, 4), dtype=torch.int64, device="meta"),
         "int32": torch.zeros((12, 4), dtype=torch.int32),
         "strided": torch.zeros((4, 12), dtype=torch.int64).t(),
         "width": torch.zeros((11, 4), dtype=torch.int64)}[bad]
    with pytest.raises(ValueError):
        poseidon_cuda.permute(x)
    with pytest.raises(ValueError):
        poseidon_cuda.grind(x, 8, 1 << 10)


def _preflight_inputs():
    """The seeded inputs of the frozen preflight digests, drawn in the
    order scripts/tpu_checks.py::_preflight_host_side draws them."""
    rng = np.random.default_rng(0xECD5A)
    v = rng.integers(0, P, (12, 2, 8192), dtype=np.uint64)
    bv = rng.integers(1, P, (32, 155, 512), dtype=np.uint64)
    seed = rng.integers(0, P, 32, dtype=np.uint64)
    return v, bv, seed


@pytest.mark.parametrize("key", ["ps", "bi"])
def test_frozen_preflight_digests(key):
    with open(DIGESTS) as f:
        frozen = json.load(f)
    v, bv, _seed = _preflight_inputs()
    if key == "ps":
        out = poseidon.permute_plain(gl.from_u64(v))
    else:
        out = _batch_inverse_axis1(gl.from_u64(bv))
    assert _digest(*ref_gl.from_u64(gl.to_u64(out))) == frozen[key]


def test_own_round_constants_equal_vectors_and_reference():
    """The port derives its constants itself: they equal the frozen vectors
    and the reference's tables."""
    with open(os.path.join(os.path.dirname(__file__), "vectors", "poseidon_constants.json")) as f:
        frozen = json.load(f)
    flat = [int(v) for v in frozen["round_constants"]]
    assert poseidon._gen_round_constants() == flat == ref_ps.ROUND_CONSTANTS
    assert list(poseidon.INTERNAL_DIAG) == [int(v) for v in frozen["internal_diag"]]
    assert poseidon.INTERNAL_DIAG == ref_ps.INTERNAL_DIAG
    assert np.array_equal(poseidon.RC_TABLE, ref_ps._RC_TABLE)
    assert (poseidon.WIDTH, poseidon.RATE, poseidon.HALF_FULL_ROUNDS, poseidon.PARTIAL_ROUNDS) == \
        (ref_ps.WIDTH, ref_ps.RATE, ref_ps.HALF_FULL_ROUNDS, ref_ps.PARTIAL_ROUNDS)


def test_batch_inverse_matches_reference():
    bv = np.random.default_rng(12).integers(1, P, (3, 7, 16), dtype=np.uint64)
    want = ref_gl.to_u64(*ref_batch_inverse(ref_gl.from_u64(bv), np))
    assert np.array_equal(gl.to_u64(_batch_inverse_axis1(gl.from_u64(bv))), want)


@pytest.mark.parametrize("k", [1, 4, 8, 9, 20])
def test_hash_no_pad_matches_reference(k):
    v = _states(13 + k, (k, 5))
    want = ref_ps.hash_no_pad([ref_gl.from_u64(row) for row in v])
    got = gl.to_u64(poseidon.hash_no_pad(gl.from_u64(v)))
    assert np.array_equal(got, np.stack([ref_gl.to_u64(*d) for d in want]))


def test_two_to_one_matches_reference():
    left, right = _states(14, (4, 3)), _states(15, (4, 3))
    want = ref_ps.two_to_one([ref_gl.from_u64(r) for r in left],
                             [ref_gl.from_u64(r) for r in right])
    got = gl.to_u64(poseidon.two_to_one(gl.from_u64(left), gl.from_u64(right)))
    assert np.array_equal(got, np.stack([ref_gl.to_u64(*d) for d in want]))


def _duplexed_lanes(B, seed):
    """A reference challenger with B distinct lanes, flushed for a grind."""
    ch = RefChallenger(np, (B,))
    ch.observe(ref_gl.from_u64(_states(seed, B)))
    ch._duplex()
    return ch, np.stack([ref_gl.to_u64(*s) for s in ch.state])


def test_plain_grind_matches_reference_sweep():
    ch, st = _duplexed_lanes(6, 16)
    w, found = poseidon_cuda.grind(gl.from_u64(st), 8, 1 << 20)
    want = ch.grind(8)
    assert bool(found.all())
    assert np.array_equal(w.numpy().astype(np.uint32), want[0])
    assert len(set(w.tolist())) > 1


def test_grind_reports_exhaustion():
    _ch, st = _duplexed_lanes(6, 17)
    w, found = poseidon_cuda.grind(gl.from_u64(st), 32, 8)
    assert not bool(found.any()) and not bool(w.any())


def test_frozen_preflight_grind_digest():
    with open(DIGESTS) as f:
        frozen = json.load(f)
    _v, _bv, seed = _preflight_inputs()
    ch = RefChallenger(np, (32,))
    ch.observe(ref_gl.from_u64(seed))
    ch._duplex()
    st = np.stack([ref_gl.to_u64(*s) for s in ch.state])
    w, found = poseidon_cuda.grind(gl.from_u64(st), 10, 1 << 20)
    assert bool(found.all())
    assert _digest(w.numpy().astype(np.uint32)) == frozen["w"]


@pytest.mark.slow
def test_plain_versions_match_pallas_kernels_interpret():
    import jax.numpy as jnp

    from plonky2_ecdsa_tpu.hash.poseidon_pallas import grind_pallas, permute_stacked_pallas

    v = _states(18, (12, 300))
    lo, hi = ref_gl.from_u64(v)
    plo, phi = permute_stacked_pallas(jnp.asarray(lo), jnp.asarray(hi), interpret=True)
    want = ref_gl.to_u64(np.asarray(plo), np.asarray(phi))
    assert np.array_equal(gl.to_u64(poseidon.permute_plain(gl.from_u64(v))), want)

    _ch, st = _duplexed_lanes(4, 19)
    slo, shi = ref_gl.from_u64(st)
    pw, pf = grind_pallas(jnp.asarray(slo), jnp.asarray(shi), 8, 1 << 20, interpret=True)
    w, found = poseidon_cuda.grind(gl.from_u64(st), 8, 1 << 20)
    assert np.array_equal(np.asarray(pf), found.numpy())
    assert np.array_equal(np.asarray(pw), w.numpy().astype(np.uint32))
