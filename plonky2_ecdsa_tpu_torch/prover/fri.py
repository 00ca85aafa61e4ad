"""FRI commit phase, proof of work and query phase, batched over lanes.

Counterpart of ``plonky2_ecdsa_tpu.prover.fri.fri_prove`` (fri.py:93):
arity-2 folds, each committed layer's leaf holding the (F(x), F(-x))
extension pair.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from ..fields import goldilocks as gl
from ..hash import merkle
from . import ntt

P = gl.P


def plan(N: int, cfg):
    """(num_layers, final_size, nfinal) of the fold schedule."""
    final_size = min(N, 1 << (cfg.fri.final_poly_max_degree_bits + cfg.fri.rate_bits))
    num_layers = max(0, (N // final_size).bit_length() - 1)
    return num_layers, final_size, final_size >> cfg.fri.rate_bits


def _domain_tables(N: int, num_layers: int):
    """Per layer (shift, generator) of its evaluation coset, and the final
    domain's shift (Python ints)."""
    layers = []
    shift = ntt.COSET_SHIFT
    size = N
    for _ in range(num_layers):
        layers.append((shift, gl.root_of_unity(size)))
        shift = shift * shift % P
        size //= 2
    return layers, shift


@functools.lru_cache(maxsize=None)
def domain_tables(N: int, num_layers: int, device):
    """Per layer inv(2 x_j) [half]; and shift^-i over the final domain."""
    layers, final_shift = _domain_tables(N, num_layers)
    inv2x = []
    size = N
    for shift, g in layers:
        first = gl.const(pow(2 * shift % P, -1, P), (), device)
        inv2x.append(gl.mul(gl.powers(gl.const(pow(g, -1, P), (), device), size // 2), first))
        size //= 2
    spow = gl.powers(gl.const(pow(final_shift, -1, P), (), device), N >> num_layers)
    return inv2x, spow


@dataclass
class FriProof:
    """Device form: int64 tensors.  Host form (prover.to_host): numpy u64
    arrays, extension values as (c0, c1) tuples, indices int64."""
    caps: list            # per layer [B, C, 4]
    final_coeffs: tuple   # ext [B, nfinal]
    indices: object       # [B, Q]
    layer_leaves: list    # per layer [B, Q, 4]
    layer_paths: list     # per layer [B, Q, depth, 4]
    pow_witness: object = None   # [B], None if pow_bits = 0


def _stack4(e, half):
    """ext pair [B, size] -> leaves [B, half, 4]: (c0[j], c1[j], c0[j+h], c1[j+h])."""
    return torch.stack([e[0][..., :half], e[1][..., :half],
                        e[0][..., half:], e[1][..., half:]], -1)


def fri_prove(challenger, F, N: int, cfg) -> FriProof:
    """F: ext pair [B, N] (the reduced polynomial's LDE) -> FriProof of
    int64 tensors (indices int64 [B, Q], pow_witness [B] or None)."""
    num_layers, _final_size, nfinal = plan(N, cfg)
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

    return FriProof(caps=caps, final_coeffs=final, indices=indices,
                         layer_leaves=layer_leaves, layer_paths=layer_paths,
                         pow_witness=pow_witness)
