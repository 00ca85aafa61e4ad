"""The port's NTTs (sub-NTT plain version, four-step, coset LDE / INTT,
extension-point evaluation) against the reference's numpy transforms, and
(slow) against the reference's Pallas four-step in interpret mode."""

import numpy as np
import pytest
import torch

from plonky2_ecdsa_tpu.fields import goldilocks as ref_gl
from plonky2_ecdsa_tpu.prover import ntt as ref_ntt
from plonky2_ecdsa_tpu_torch.fields import goldilocks as gl
from plonky2_ecdsa_tpu_torch.prover import ntt, ntt_cuda

P = ref_gl.P
SIZES = [8, 512, 1024, 1 << 13]


def _vals(seed, shape):
    return np.random.default_rng(seed).integers(0, P, shape, dtype=np.uint64)


def _ref(pair):
    return ref_gl.to_u64(*pair)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_matches_reference(n, inverse):
    v = _vals(n + inverse, (3, n))
    want = _ref(ref_ntt.ntt(*ref_gl.from_u64(v), inverse=inverse))
    assert np.array_equal(gl.to_u64(ntt.ntt(gl.from_u64(v), inverse=inverse)), want)


@pytest.mark.parametrize("n", SIZES)
def test_compact_coset_lde_matches_reference(n):
    k = max(2, n // 4)
    c = _vals(n + 7, (2, 3, k))
    want = _ref(ref_ntt.coset_ntt_from_coeffs(*ref_gl.from_u64(c), 4 * k))
    assert np.array_equal(gl.to_u64(ntt.coset_ntt_from_coeffs(gl.from_u64(c), 4 * k)), want)


@pytest.mark.parametrize("n", SIZES)
def test_coset_intt_matches_reference(n):
    v = _vals(n + 9, (2, n))
    want = _ref(ref_ntt.coset_intt(*ref_gl.from_u64(v)))
    assert np.array_equal(gl.to_u64(ntt.coset_intt(gl.from_u64(v))), want)


@pytest.mark.parametrize("shape", [(16, 128), (128, 256)])
@pytest.mark.parametrize("inverse", [False, True])
def test_sub_ntt_matches_reference_axis2(shape, inverse):
    n_t, L = shape
    v = _vals(n_t + L + inverse, (2, n_t, L))
    want = _ref(ref_ntt._ntt_axis2(*ref_gl.from_u64(v), n_t, inverse, np))
    assert np.array_equal(gl.to_u64(ntt_cuda.sub_ntt(gl.from_u64(v), n_t, inverse)), want)


def test_sub_ntt_compact_rows_and_scales():
    """rows_in < n_t reads only the given rows; pre and post scale in and out."""
    n_t, rows_in, L = 64, 16, 8
    x, pre, post = _vals(20, (3, rows_in, L)), _vals(21, (rows_in, L)), _vals(22, (n_t, L))
    xp = ref_gl.mul(*ref_gl.from_u64(x), *ref_gl.from_u64(pre))
    full = np.concatenate([_ref(xp), np.zeros((3, n_t - rows_in, L), np.uint64)], 1)
    y = ref_ntt._ntt_axis2(*ref_gl.from_u64(full), n_t, False, np)
    want = _ref(ref_gl.mul(*y, *ref_gl.from_u64(post)))
    got = ntt_cuda.sub_ntt(gl.from_u64(x), n_t, False, gl.from_u64(pre), gl.from_u64(post))
    assert np.array_equal(gl.to_u64(got), want)


def test_sub_ntt_rejects_bad_shapes():
    x = gl.from_u64(_vals(23, (1, 8, 4)))
    with pytest.raises(ValueError):
        ntt_cuda.sub_ntt(x, 12, False)
    with pytest.raises(ValueError):
        ntt_cuda.sub_ntt(x, 4, False)
    with pytest.raises(ValueError):
        ntt_cuda.sub_ntt(x, 8, False, post=gl.from_u64(_vals(24, (8, 3))))
    with pytest.raises(ValueError):                      # not contiguous
        ntt_cuda.sub_ntt(x.transpose(1, 2), 4, False)
    with pytest.raises(ValueError):                      # not int64
        ntt_cuda.sub_ntt(x.to(torch.int32), 8, False)


def test_ext_powers_and_eval_poly_ext_match_reference():
    z = _vals(25, (2, 3))
    zt = (gl.from_u64(z[0]), gl.from_u64(z[1]))
    zr = (ref_gl.from_u64(z[0]), ref_gl.from_u64(z[1]))
    pw, rpw = ntt.ext_powers(zt, 37), ref_ntt.ext_powers(zr, 37)
    for i in range(2):
        assert np.array_equal(gl.to_u64(pw[i]), _ref(rpw[i]))
    c = _vals(26, (3, 37))
    got = ntt.eval_poly_ext(gl.from_u64(c), pw)
    want = ref_ntt.eval_poly_ext(*ref_gl.from_u64(c), rpw)
    for i in range(2):
        assert np.array_equal(gl.to_u64(got[i]), _ref(want[i]))


@pytest.mark.slow
@pytest.mark.parametrize("inverse", [False, True])
def test_four_step_matches_pallas_interpret(inverse):
    import jax.numpy as jnp

    from plonky2_ecdsa_tpu.prover import ntt_pallas

    n = 1 << 11
    v = _vals(27 + inverse, (2, n))
    lo, hi = ref_gl.from_u64(v)
    plo, phi = ntt_pallas.four_step(jnp.asarray(lo), jnp.asarray(hi), n, inverse,
                                    interpret=True)
    want = ref_gl.to_u64(np.asarray(plo), np.asarray(phi))
    assert np.array_equal(gl.to_u64(ntt_cuda.four_step(gl.from_u64(v), n, inverse)), want)
