"""Operands and expected values for the GPU check of the CUDA kernels' field
arithmetic (plonky2_ecdsa_tpu_torch/csrc/poseidon2.cu::field_check_kernel,
launched by poseidon_cuda.field_check).  chip_smoke.py runs the check on the
card; tests/test_torch_lazy_field.py holds a Python-integer model of the same
arithmetic against the same values where no GPU is needed.
"""

import numpy as np

P = (1 << 64) - (1 << 32) + 1   # the Goldilocks prime


def operands(n_random: int, seed: int):
    """(a, b) uint64 arrays: every ordered pair of the directed edge values
    (0, 1, powers of two, 2^32 and p and 2^64 with their neighbours: canonical
    and not), then n_random random pairs over all of u64."""
    edge = {0, 1, 2, 1 << 31, 1 << 33, 1 << 63, P // 2, (1 << 64) - (1 << 33)}
    for c in ((1 << 32) - 1, 1 << 32, P - 1, P, (1 << 64) - (1 << 32), (1 << 64) - 1):
        edge.update(v for v in (c - 1, c, c + 1) if 0 <= v < 1 << 64)
    edge = np.array(sorted(edge), dtype=np.uint64)
    a, b = (g.ravel() for g in np.meshgrid(edge, edge, indexing="ij"))
    rng = np.random.default_rng(seed)
    r = rng.integers(0, 1 << 64, (2, n_random), dtype=np.uint64)
    return np.concatenate([a, r[0]]), np.concatenate([b, r[1]])


def expected(a: int, b: int):
    """What field_check_kernel must give for one pair of operands, from Python
    integers: (the first rows' values modulo p, the other rows' exact values)."""
    M64 = (1 << 64) - 1
    canon = lambda v: v - P if v >= P else v                      # noqa: E731
    s = b + (((a >> 32) & 63) << 64)                              # a layer's 96-bit sum
    mad = a * (a & 31) + s
    quad = 4 * (s + a)
    lazy = [a * b % P, a * a % P, (a + ((b & 0xFFFFFFFF) << 64)) % P, (a + b) % P, (a - b) % P]
    exact = [a * b % P, canon(a), mad & M64, mad >> 64, quad & M64, quad >> 64, a * b % P]
    return lazy, exact
