"""The port's leaf sponge (poseidon_cuda.sponge / sponge_plain: the plain
version that the CUDA sponge kernel is held against on the GPU) against the
reference's numpy hash_no_pad, hash_leaves and leaf_digests_from_polys, over
absorbed widths on both sides of the rate and over all three layouts."""

import numpy as np
import pytest
import torch

from plonky2_ecdsa_tpu.fields import goldilocks as ref_gl
from plonky2_ecdsa_tpu.hash import merkle as ref_merkle
from plonky2_ecdsa_tpu.hash import poseidon as ref_ps
from plonky2_ecdsa_tpu_torch.fields import goldilocks as gl
from plonky2_ecdsa_tpu_torch.hash import merkle, poseidon, poseidon_cuda

P = ref_gl.P
WIDTHS = [1, 7, 8, 9, 20, 128]


def _vals(seed, shape):
    return np.random.default_rng(seed).integers(0, P, shape, dtype=np.uint64)


def _ref(pair):
    return ref_gl.to_u64(*pair)


@pytest.mark.parametrize("k", WIDTHS)
def test_sponge_poly_major_matches_reference(k):
    lde = _vals(50 + k, (2, k, 6))                       # [B, k, N]
    want = _ref(ref_merkle.leaf_digests_from_polys(*ref_gl.from_u64(lde), np))
    for fn in (poseidon_cuda.sponge_plain, poseidon_cuda.sponge):
        got = fn(gl.from_u64(lde), "poly")
        assert got.shape == (2, 6, 4) and got.is_contiguous()
        assert np.array_equal(gl.to_u64(got), want)
    assert np.array_equal(gl.to_u64(merkle.leaf_digests_from_polys(gl.from_u64(lde))), want)


@pytest.mark.parametrize("k", WIDTHS)
def test_sponge_leaf_major_matches_reference(k):
    leaves = _vals(60 + k, (2, 5, k))                    # [B, L, W]
    want = _ref(ref_merkle.hash_leaves(*ref_gl.from_u64(leaves)))
    for fn in (poseidon_cuda.sponge_plain, poseidon_cuda.sponge):
        got = fn(gl.from_u64(leaves), "leaf")
        assert got.shape == (2, 5, 4) and got.is_contiguous()
        assert np.array_equal(gl.to_u64(got), want)
    assert np.array_equal(gl.to_u64(merkle.hash_leaves(gl.from_u64(leaves))), want)


@pytest.mark.parametrize("k", WIDTHS)
def test_sponge_stacked_matches_reference_hash_no_pad(k):
    v = _vals(70 + k, (k, 2, 3))                         # [k, ...]
    want = np.stack([_ref(d) for d in ref_ps.hash_no_pad([ref_gl.from_u64(r) for r in v])])
    for fn in (poseidon_cuda.sponge_plain, poseidon_cuda.sponge):
        assert np.array_equal(gl.to_u64(fn(gl.from_u64(v), "stacked")), want)
    assert np.array_equal(gl.to_u64(poseidon.hash_no_pad(gl.from_u64(v))), want)


def test_layouts_agree_with_each_other():
    x = gl.from_u64(_vals(80, (3, 11, 5)))
    poly = poseidon_cuda.sponge_plain(x, "poly")                              # [3, 5, 4]
    leaf = poseidon_cuda.sponge_plain(x.transpose(1, 2).contiguous(), "leaf")
    stacked = poseidon_cuda.sponge_plain(x.movedim(1, 0).contiguous(), "stacked")
    assert torch.equal(poly, leaf) and torch.equal(poly, stacked.movedim(0, -1))


@pytest.mark.parametrize("bad", ["layout", "int32", "strided", "empty", "one axis"])
def test_sponge_rejects_what_the_kernel_does_not_take(bad):
    x, layout = {"layout": (torch.zeros((4, 4), dtype=torch.int64), "rows"),
                 "int32": (torch.zeros((4, 4), dtype=torch.int32), "poly"),
                 "strided": (torch.zeros((4, 6), dtype=torch.int64).t(), "leaf"),
                 "empty": (torch.zeros((0, 4), dtype=torch.int64), "stacked"),
                 "one axis": (torch.zeros((4,), dtype=torch.int64), "poly")}[bad]
    with pytest.raises(ValueError):
        poseidon_cuda.sponge(x, layout)
