"""Goldilocks NTT / coset LDE over the last axis of int64 tensors.

Counterpart of ``plonky2_ecdsa_tpu.prover.ntt``.  Every transform is sub-NTT
launches (``ntt_cuda``): sizes from FOUR_STEP_MIN up run as a four-step
(two sub-NTTs, the first storing its output transposed; split by ``_split2``), smaller
ones (the FRI final polynomial, test circuits) as one sub-NTT along the
transform axis.  Coset scales and 1/n fold into the sub-NTTs' pre/post
multiplies.  The transforms are exact, so the outputs equal the reference's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import goldilocks as gl
from . import ntt_cuda
from .ntt_cuda import FOUR_STEP_MIN, _split2

P = gl.P
COSET_SHIFT = gl.MULTIPLICATIVE_GROUP_GENERATOR   # plonky2's coset shift


@functools.lru_cache(maxsize=None)
def coset_powers(n: int, inverse: bool, device) -> torch.Tensor:
    """shift^i (or shift^-i), i < n."""
    s = pow(COSET_SHIFT, P - 2, P) if inverse else COSET_SHIFT
    return gl.powers(gl.const(s, (), device), n)


def lde_domain(N: int) -> np.ndarray:
    """The coset points shift * w_N^i in natural order (host u64)."""
    return gl.to_u64(gl.mul(gl.powers(gl.const(gl.root_of_unity(N)), N), COSET_SHIFT))


@functools.lru_cache(maxsize=None)
def _inverse_post(n: int, coset: bool, device) -> torch.Tensor:
    """Output scale of a small inverse transform: 1/n, times shift^-i for a coset."""
    ninv = pow(n, P - 2, P)
    if coset:
        return gl.mul(coset_powers(n, True, device), ninv)
    return gl.const(ninv, (n,), device)


def _transform(x, n: int, inverse: bool, pre=None, post=None):
    """x [..., k], k <= n (missing entries are zero coefficients) -> [..., n].
    An inverse small transform expects `post` to carry the 1/n."""
    lead, k = x.shape[:-1], x.shape[-1]
    if n >= FOUR_STEP_MIN:
        n2 = _split2(n)[1]
        if k % n2:   # compact input that is not whole rows: pad to n
            x = torch.cat([x, x.new_zeros(lead + (n - k,))], -1)
            pre = None if pre is None else torch.cat([pre, pre.new_ones(n - k)])
        return ntt_cuda.four_step(x, n, inverse, pre, post)
    y = ntt_cuda.sub_ntt(x.reshape(-1, k, 1), n, inverse,
                         pre=None if pre is None else pre[:, None],
                         post=None if post is None else post[:, None])
    return y.reshape(lead + (n,))


def ntt(x, inverse: bool = False):
    """Forward/inverse NTT over the last axis (natural order in and out)."""
    n = x.shape[-1]
    assert n & (n - 1) == 0
    if n == 1:
        return x
    post = _inverse_post(n, False, x.device) if inverse and n < FOUR_STEP_MIN else None
    return _transform(x, n, inverse, post=post)


def intt(x):
    return ntt(x, inverse=True)


def coset_ntt_from_coeffs(c, N: int | None = None):
    """Coefficients [..., k] -> evaluations on shift * K_N; with N > k the
    high coefficients are implicit zeros (compact LDE input)."""
    k = c.shape[-1]
    N = k if N is None else N
    return _transform(c, N, False, pre=coset_powers(N, False, c.device)[:k])


def coset_intt(x):
    """Evaluations on shift * K_N -> coefficients."""
    N = x.shape[-1]
    if N >= FOUR_STEP_MIN:
        return _transform(x, N, True, post=coset_powers(N, True, x.device))
    return _transform(x, N, True, post=_inverse_post(N, True, x.device))


def ext_powers(zeta, n: int):
    """[1, zeta, ..., zeta^(n-1)] along a new last axis (ext pair)."""
    out = (torch.ones_like(zeta[0])[..., None], torch.zeros_like(zeta[1])[..., None])
    p = (zeta[0][..., None], zeta[1][..., None])
    while out[0].shape[-1] < n:
        nxt = gl.ext_mul(out, p)
        out = (torch.cat([out[0], nxt[0]], -1), torch.cat([out[1], nxt[1]], -1))
        p = gl.ext_square(p)
    return (out[0][..., :n], out[1][..., :n])


def eval_poly_ext(c, zpows):
    """Base-field coefficients [..., n] at an extension point given by its
    powers (broadcastable to [..., n]) -> ext pair [...]."""
    return (gl.sum_mod(gl.mul(c, zpows[0]), -1), gl.sum_mod(gl.mul(c, zpows[1]), -1))
