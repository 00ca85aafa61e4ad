"""The port's Merkle trees and Fiat-Shamir challenger against the
reference's numpy trees and Challenger: caps, opened paths, and a
transcript of observes, challenges, indices and a grind."""

import numpy as np
import pytest

from plonky2_ecdsa_tpu.fields import goldilocks as ref_gl
from plonky2_ecdsa_tpu.hash import merkle as ref_merkle
from plonky2_ecdsa_tpu.prover.challenger import Challenger as RefChallenger
from plonky2_ecdsa_tpu_torch.fields import goldilocks as gl
from plonky2_ecdsa_tpu_torch.hash import merkle
from plonky2_ecdsa_tpu_torch.prover.challenger import Challenger

P = ref_gl.P


def _vals(seed, shape):
    return np.random.default_rng(seed).integers(0, P, shape, dtype=np.uint64)


def _same(t, pair):
    return np.array_equal(gl.to_u64(t), ref_gl.to_u64(*pair))


@pytest.mark.parametrize("cap_height", [0, 1, 4, 9])
def test_tree_from_polys_matches_reference(cap_height):
    lde = _vals(30 + cap_height, (2, 11, 64))              # [B, k, N]
    tree = merkle.build_merkle_tree_from_polys(gl.from_u64(lde), cap_height)
    ref = ref_merkle.build_merkle_tree_from_polys(ref_gl.from_u64(lde), cap_height, np)
    assert len(tree.levels) == len(ref.levels) and tree.cap_height == ref.cap_height
    assert _same(tree.cap, ref.cap)
    idx = np.random.default_rng(31).integers(0, 64, (2, 5))
    assert _same(tree.open(gl.from_u64(idx.astype(np.uint64))), ref.open(idx))


def test_unbatched_leaf_tree_matches_reference():
    leaves = _vals(32, (32, 7))                              # [L, W]
    tree = merkle.build_merkle_tree(gl.from_u64(leaves), 2)
    ref = ref_merkle.build_merkle_tree(*ref_gl.from_u64(leaves), 2)
    assert _same(tree.cap, ref.cap)
    idx = np.random.default_rng(33).integers(0, 32, (3, 4))
    assert _same(tree.open(gl.from_u64(idx.astype(np.uint64))), ref.open(idx))


def test_transcript_matches_reference():
    B = 3
    ch, rc = Challenger((B,)), RefChallenger(np, (B,))
    for step in range(5):
        arr = _vals(40 + step, (B, 3 + 4 * step))
        ch.observe_array(gl.from_u64(arr))
        rc.observe_array(ref_gl.from_u64(arr))
        assert _same(ch.get_challenge(), rc.get_challenge())
    cap = _vals(50, (B, 4, 4))
    ch.observe_cap(gl.from_u64(cap))
    rc.observe_cap(ref_gl.from_u64(cap))
    e = _vals(51, (2, B, 5))
    ch.observe_ext_array((gl.from_u64(e[0]), gl.from_u64(e[1])))
    rc.observe_ext_array((ref_gl.from_u64(e[0]), ref_gl.from_u64(e[1])))
    got, want = ch.get_ext(), rc.get_ext()
    assert _same(got[0], want[0]) and _same(got[1], want[1])
    w, rw = ch.grind(8), rc.grind(8)
    assert np.array_equal(w.numpy().astype(np.uint32), rw[0])
    for a, b in zip(ch.get_indices(1 << 10, 7), rc.get_indices(1 << 10, 7)):
        assert np.array_equal(a.numpy(), b.astype(np.int64))
    assert _same(ch.get_challenge(), rc.get_challenge())
