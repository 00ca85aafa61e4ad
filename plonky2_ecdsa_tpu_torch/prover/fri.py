"""FRI commit phase, proof of work and query phase, batched over lanes.

Counterpart of ``plonky2_ecdsa_tpu.prover.fri.fri_prove`` (fri.py:93):
arity-2 folds, each committed layer's leaf holding the (F(x), F(-x))
extension pair.  The fold schedule and domain tables are the reference's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from plonky2_ecdsa_tpu.prover import fri as _ref

from ..fields import goldilocks as gl
from ..hash import merkle
from . import ntt

P = gl.P


@functools.lru_cache(maxsize=None)
def domain_tables(N: int, num_layers: int, device):
    """Per layer inv(2 x_j) [half]; and shift^-i over the final domain."""
    tables, final_shift = _ref._domain_tables(N, num_layers)
    inv2x = [gl.from_u64(t[2], device) for t in tables]
    size = N >> num_layers
    sp = np.array([pow(final_shift, -i, P) for i in range(size)], dtype=np.uint64)
    return inv2x, gl.from_u64(sp, device)


def _stack4(e, half):
    """ext pair [B, size] -> leaves [B, half, 4]: (c0[j], c1[j], c0[j+h], c1[j+h])."""
    return torch.stack([e[0][..., :half], e[1][..., :half],
                        e[0][..., half:], e[1][..., half:]], -1)


def fri_prove(challenger, F, N: int, cfg) -> _ref.FriProof:
    """F: ext pair [B, N] (the reduced polynomial's LDE) -> FriProof of
    int64 tensors (indices int64 [B, Q], pow_witness [B] or None)."""
    num_layers, _final_size, nfinal = _ref.plan(N, cfg)
    inv2x, spow = domain_tables(N, num_layers, F[0].device)
    inv2 = pow(2, -1, P)

    trees, leaves_store, caps = [], [], []
    cur = F
    size = N
    for i2x in inv2x:
        half = size // 2
        leaves = _stack4(cur, half)
        tree = merkle.build_merkle_tree(leaves, cfg.fri.cap_height)
        trees.append(tree)
        leaves_store.append(leaves)
        caps.append(tree.cap)
        challenger.observe_cap(tree.cap)
        beta = challenger.get_ext()
        a = (cur[0][..., :half], cur[1][..., :half])
        b = (cur[0][..., half:], cur[1][..., half:])
        s, d = gl.ext_add(a, b), gl.ext_sub(a, b)
        even = (gl.mul(s[0], inv2), gl.mul(s[1], inv2))
        odd = (gl.mul(d[0], i2x), gl.mul(d[1], i2x))
        cur = gl.ext_add(even, gl.ext_mul((beta[0][..., None], beta[1][..., None]), odd))
        size = half

    final = tuple(gl.mul(ntt.intt(c), spow)[..., :nfinal] for c in cur)
    challenger.observe_ext_array(final)

    pow_witness = None
    if cfg.fri.proof_of_work_bits:
        pow_witness = challenger.grind(cfg.fri.proof_of_work_bits)

    indices = torch.stack(challenger.get_indices(N, cfg.fri.num_query_rounds), -1)
    layer_leaves, layer_paths = [], []
    idx = indices
    size = N
    for tree, leaves in zip(trees, leaves_store):
        half = size // 2
        li = idx % half
        B, Q = li.shape
        layer_leaves.append(torch.gather(leaves, 1, li[..., None].expand(B, Q, 4)))
        layer_paths.append(tree.open(li))
        idx = li
        size = half

    return _ref.FriProof(caps=caps, final_coeffs=final, indices=indices,
                         layer_leaves=layer_leaves, layer_paths=layer_paths,
                         pow_witness=pow_witness)
