"""Field-algebra adapters: a gate's constraints are written once
(``Gate.eval(alg, wires, consts, ctx)``) and evaluated by whichever algebra
is passed in.

Counterpart of ``plonky2_ecdsa_tpu.circuit.algebra``:
  * ``BaseAlgebra``     numpy u64 on the host (the witness constraint check);
  * ``TorchAlgebra``    int64 tensors, pointwise over a chunk of the LDE coset
                        (the prover's quotient);
  * ``TorchExtAlgebra`` GF(p^2) elements as (c0, c1) tensor tuples, at zeta
                        (the verifier), counterpart of ``ExtAlgebra``.
"""

from __future__ import annotations

import numpy as np

from ..fields import goldilocks as gl
from ..fields import goldilocks_cuda as glc
from ..fields import goldilocks_host as glh


class BaseAlgebra:
    """Elements are numpy uint64 arrays (or scalars) of canonical values."""

    ext = False

    def const(self, c: int):
        return np.uint64(c % glh.P)

    def zero(self):
        return self.const(0)

    def one(self):
        return self.const(1)

    def add(self, a, b):
        return glh.add(a, b)

    def sub(self, a, b):
        return glh.sub(a, b)

    def neg(self, a):
        return glh.neg(a)

    def mul(self, a, b):
        return glh.mul(a, b)

    def mul_const(self, a, c: int):
        return glh.mul(a, self.const(c))

    def add_const(self, a, c: int):
        return glh.add(a, self.const(c))


class TorchAlgebra:
    """Elements are int64 tensors broadcastable to `shape`; the field
    operations are ``fields/goldilocks_cuda``'s (one kernel each on a CUDA
    device, ``fields/goldilocks``'s plain functions on the CPU).  ``add``,
    ``sub`` and ``mul`` also take a Python int as either operand (as
    ``goldilocks_cuda`` does); ``sum_mod`` and ``dot_mod`` reduce one axis of
    a stacked tensor."""

    ext = False

    def __init__(self, shape, device):
        self.shape = tuple(shape)
        self.device = device

    def const(self, c: int):
        return gl.const(c, self.shape, self.device)

    def zero(self):
        return self.const(0)

    def one(self):
        return self.const(1)

    def add(self, a, b):
        return glc.add(a, b)

    def sub(self, a, b):
        return glc.sub(a, b)

    def neg(self, a):
        return glc.neg(a)

    def mul(self, a, b):
        return glc.mul(a, b)

    def mul_const(self, a, c: int):
        return glc.mul(a, c % gl.P)

    def add_const(self, a, c: int):
        return glc.add(a, gl.i64(c))

    def sum_mod(self, x, dim: int):
        """The sum over axis `dim`."""
        return glc.sum_mod(x, dim)

    def dot_mod(self, x, w, dim: int):
        """The sum over axis `dim` of x * w (broadcast together)."""
        return glc.dot_mod(x, w, dim)


class TorchExtAlgebra:
    """Elements are (c0, c1) tuples of int64 tensors of `shape`:
    GF(p^2) = GF(p)[x] / (x^2 - 7)."""

    ext = True

    def __init__(self, shape, device):
        self.shape = tuple(shape)
        self.device = device

    def const(self, c: int):
        return (gl.const(c, self.shape, self.device), gl.const(0, self.shape, self.device))

    def zero(self):
        return self.const(0)

    def one(self):
        return self.const(1)

    def add(self, a, b):
        return gl.ext_add(a, b)

    def sub(self, a, b):
        return gl.ext_sub(a, b)

    def neg(self, a):
        return gl.ext_neg(a)

    def mul(self, a, b):
        return gl.ext_mul(a, b)

    def mul_const(self, a, c: int):
        c %= gl.P
        return (gl.mul(a[0], c), gl.mul(a[1], c))

    def add_const(self, a, c: int):
        return (gl.add(a[0], gl.i64(c)), a[1])
