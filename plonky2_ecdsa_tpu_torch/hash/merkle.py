"""Merkle trees over Poseidon2 digests (4 field elements), with caps.

Counterpart of ``plonky2_ecdsa_tpu.hash.merkle``.  Every level is an int64
tensor [..., size, 4], leaves first; the leading axes batch independent
trees (one per proof lane) or are absent (the fixed-polynomial tree).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import poseidon_cuda


@dataclass
class MerkleTree:
    levels: list          # int64 tensors [..., size, 4], leaves first
    cap_height: int

    @property
    def cap(self):
        return self.levels[-1]      # [..., 2^cap_height, 4]

    def open(self, idx):
        """idx: int64 [B, Q] leaf indices -> sibling paths [B, Q, depth, 4]."""
        sibs = []
        cur = idx
        for level in self.levels[:-1]:
            sidx = cur ^ 1
            if level.dim() == 2:          # unbatched tree (fixed polynomials)
                sibs.append(level[sidx])
            else:
                B, Q = sidx.shape
                sibs.append(torch.gather(level, -2, sidx[..., None].expand(B, Q, 4)))
            cur = cur >> 1
        if not sibs:
            return torch.zeros(idx.shape + (0, 4), dtype=torch.int64, device=idx.device)
        return torch.stack(sibs, -2)


def hash_leaves(leaves):
    """Leaf data [..., L, W] (contiguous, on either device: the kernel reads
    it by strides) -> digests [..., L, 4] (one sponge launch on CUDA)."""
    return poseidon_cuda.sponge(leaves, "leaf")


def leaf_digests_from_polys(lde):
    """Poly-major LDE [..., k, N] (contiguous, or a view such as a slice of
    the domain axis; on either device) -> leaf digests [..., N, 4]: leaf j is
    the sponge over the k polynomial values at domain point j, read in place
    (no leaf-major copy of the LDE; one sponge launch on CUDA)."""
    return poseidon_cuda.sponge(lde, "poly")


def build_tree_from_digests(digests, cap_height: int) -> MerkleTree:
    L = digests.shape[-2]
    assert L & (L - 1) == 0
    cap_height = min(cap_height, L.bit_length() - 1)
    levels = [digests]
    size = L
    while size > 1 << cap_height:
        pairs = levels[-1].reshape(levels[-1].shape[:-2] + (size // 2, 8))
        levels.append(hash_leaves(pairs))
        size //= 2
    return MerkleTree(levels=levels, cap_height=cap_height)


def build_merkle_tree_from_polys(lde, cap_height: int) -> MerkleTree:
    """Tree over the leaves of a poly-major LDE [..., k, N]."""
    return build_tree_from_digests(leaf_digests_from_polys(lde), cap_height)


def build_merkle_tree(leaves, cap_height: int) -> MerkleTree:
    """Leaf data [..., L, W] -> tree with a cap of 2^cap_height roots."""
    return build_tree_from_digests(hash_leaves(leaves), cap_height)
