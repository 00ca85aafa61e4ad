"""Base-field algebra over int64 tensors for the gates' constraint code.

Counterpart of ``plonky2_ecdsa_tpu.circuit.algebra.BaseAlgebra``: each gate's
algebra-generic ``Gate.eval(alg, wires, consts, ctx)`` runs unchanged on
these elements, evaluated pointwise over a chunk of the LDE coset.
"""

from __future__ import annotations

from ..fields import goldilocks as gl


class TorchAlgebra:
    """Elements are int64 tensors broadcastable to `shape`.  Only the
    operations the gates' ``eval`` uses are provided."""

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
        return gl.add(a, b)

    def sub(self, a, b):
        return gl.sub(a, b)

    def mul(self, a, b):
        return gl.mul(a, b)

    def mul_const(self, a, c: int):
        return gl.mul(a, c)

    def add_const(self, a, c: int):
        return gl.add(a, gl.i64(c))
