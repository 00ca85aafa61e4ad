"""CUDA sub-NTT kernel (``csrc/ntt.cu``), its plain version, and four-step.

Counterpart of ``plonky2_ecdsa_tpu.prover.ntt_pallas``: ``sub_ntt`` replaces
``_sub_ntt_kernel`` (ntt_pallas.py:119, pallas_call :181) and ``four_step``
composes two of them as ntt_pallas.four_step does; the transpose between the
two passes is the first pass's own (transposed) store, not a copy.
``sub_ntt`` takes the plain torch version for a CPU tensor; for a CUDA
tensor it launches the kernel or raises.  ``sub_ntt.launches`` counts its
kernel launches, ``sub_ntt.replayed`` its launches by replays of a captured
prove (``prover/graph.py``).  Twiddle tables are built with the field on the device they
are cached for.
"""

from __future__ import annotations

import functools

import torch

from .. import _build
from ..fields import goldilocks as gl

MAX_SUB_NTT = 1 << 12     # the kernel's largest transform (csrc/ntt.cu's MAX_LOG_N)

FOUR_STEP_MIN = 1 << 10   # sizes from here up run as a four-step


def _split2(n: int):
    """n = n1 * n2 with n1 <= n2, both powers of two."""
    l = n.bit_length() - 1
    return 1 << (l // 2), 1 << (l - l // 2)


def _root(n: int, inverse: bool) -> int:
    g = gl.root_of_unity(n)
    return pow(g, gl.P - 2, gl.P) if inverse else g


@functools.lru_cache(maxsize=None)
def twiddles(n_t: int, inverse: bool, device) -> torch.Tensor:
    """Stage rows concatenated: stage s (half = 2^s) starts at half - 1 and
    holds w_{2 half}^j for j < half."""
    g = _root(n_t, inverse)
    rows = []
    m = 2
    while m <= n_t:
        rows.append(gl.powers(gl.const(pow(g, n_t // m, gl.P), (), device), m // 2))
        m *= 2
    return torch.cat(rows) if rows else torch.zeros(0, dtype=torch.int64, device=device)


@functools.lru_cache(maxsize=None)
def _bitrev(n_t: int, device) -> torch.Tensor:
    bits = n_t.bit_length() - 1
    idx = torch.arange(n_t, device=device)
    rev = torch.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


@functools.lru_cache(maxsize=None)
def four_step_T(n: int, inverse: bool, device) -> torch.Tensor:
    """T[k1, j2] = w_n^(+-k1 j2), [n1, n2]; the inverse's 1/n folded in."""
    n1, n2 = _split2(n)
    col = gl.powers(gl.const(_root(n, inverse), (), device), n1)     # w^k1
    T = gl.powers(col, n2)                                          # [n1, n2]
    return gl.mul(T, pow(n, gl.P - 2, gl.P)) if inverse else T


def sub_ntt_plain(x, n_t: int, inverse: bool, pre=None, post=None, transpose_out: bool = False):
    """Plain torch sub-NTT: x [M, rows_in, L] -> [M, n_t, L] along axis 1,
    natural order in and out.  Rows rows_in..n_t-1 are zero coefficients;
    pre [rows_in, L] multiplies the input, post [n_t, L] the output.  With
    transpose_out the result is stored as [M, L, n_t]."""
    M, rows_in, L = x.shape
    if pre is not None:
        x = gl.mul(x, pre)
    if rows_in < n_t:
        x = torch.cat([x, x.new_zeros((M, n_t - rows_in, L))], 1)
    x = x[:, _bitrev(n_t, x.device)]
    tw = twiddles(n_t, inverse, x.device)
    half = 1
    while half < n_t:
        v = x.reshape(M, n_t // (2 * half), 2 * half, L)
        t = gl.mul(v[:, :, half:], tw[half - 1:2 * half - 1].reshape(half, 1))
        a = v[:, :, :half]
        x = torch.cat([gl.add(a, t), gl.sub(a, t)], 2).reshape(M, n_t, L)
        half *= 2
    if post is not None:
        x = gl.mul(x, post)
    return x.transpose(1, 2).contiguous() if transpose_out else x


def sub_ntt(x, n_t: int, inverse: bool, pre=None, post=None, transpose_out: bool = False):
    """Sub-NTT of x [M, rows_in, L] (see sub_ntt_plain); kernel on CUDA."""
    _build.check_tensors("sub_ntt", x, *(t for t in (pre, post) if t is not None))
    M, rows_in, L = x.shape
    if n_t & (n_t - 1) or not 0 < rows_in <= n_t <= MAX_SUB_NTT:
        raise ValueError(f"sub_ntt: n_t={n_t}, rows_in={rows_in}")
    if pre is not None and tuple(pre.shape) != (rows_in, L):
        raise ValueError(f"sub_ntt: pre {tuple(pre.shape)} != {(rows_in, L)}")
    if post is not None and tuple(post.shape) != (n_t, L):
        raise ValueError(f"sub_ntt: post {tuple(post.shape)} != {(n_t, L)}")
    if x.device.type == "cpu":
        return sub_ntt_plain(x, n_t, inverse, pre, post, transpose_out)
    tw = twiddles(n_t, inverse, x.device)
    out = torch.empty((M, L, n_t) if transpose_out else (M, n_t, L), dtype=torch.int64,
                      device=x.device)
    if M and L:
        pre_p = None if pre is None else pre.data_ptr()
        post_p = None if post is None else post.data_ptr()
        with torch.cuda.device(x.device):
            _build.check(_build.library().ntt_sub(
                x.data_ptr(), out.data_ptr(), tw.data_ptr(), pre_p, post_p, M,
                n_t.bit_length() - 1, rows_in, L, int(transpose_out), _build.stream_ptr(x)),
                "sub_ntt")
        sub_ntt.launches += 1
    return out


sub_ntt.launches = 0
sub_ntt.replayed = 0


def _four_step(sub, x, n: int, inverse: bool, pre, post):
    n1, n2 = _split2(n)
    lead, k = x.shape[:-1], x.shape[-1]
    assert k % n2 == 0, (k, n2)
    rows_in = k // n2
    x = x.reshape(-1, rows_in, n2)
    y = sub(x, n1, inverse, None if pre is None else pre.reshape(rows_in, n2),
            four_step_T(n, inverse, x.device), transpose_out=True)          # [M, n2, n1]
    y = sub(y, n2, inverse, None, None if post is None else post.reshape(n2, n1))
    return y.reshape(lead + (n,))


def four_step(x, n: int, inverse: bool, pre=None, post=None):
    """Four-step NTT over the last axis (natural order in and out): x
    [..., k] with k <= n a multiple of n2 (k < n: zero-padded coefficients).
    pre [k] and post [n] are elementwise scales (coset powers); the
    inverse's 1/n is folded into the four-step twiddle."""
    return _four_step(sub_ntt, x, n, inverse, pre, post)


def four_step_plain(x, n: int, inverse: bool, pre=None, post=None):
    """four_step through the plain sub-NTT on any device."""
    return _four_step(sub_ntt_plain, x, n, inverse, pre, post)
