"""Fiat-Shamir challenger: Poseidon2 duplex sponge over a batch of lanes.

Counterpart of ``plonky2_ecdsa_tpu.prover.challenger.Challenger``
(overwrite-mode duplex, rate 8).  Observed values and challenges are int64
tensors of the batch shape; the transcript is bit-identical to the
reference's.
"""

from __future__ import annotations

import torch

from ..fields import goldilocks as gl
from ..hash import poseidon, poseidon_cuda


GRIND_EXHAUSTED = 0xFFFFFFFF   # witness of a lane whose grind ran out of candidates


class Challenger:
    def __init__(self, batch_shape=(), device="cpu"):
        self.batch_shape = tuple(batch_shape)
        self.state = torch.zeros((poseidon.WIDTH,) + self.batch_shape,
                                 dtype=torch.int64, device=device)
        self.inputs: list = []
        self.outputs: list = []

    def observe(self, x):
        self.inputs.append(x.expand(self.batch_shape))
        self.outputs = []
        if len(self.inputs) == poseidon.RATE:
            self._duplex()

    def observe_array(self, arr):
        """arr [*batch, K]: K observes, in order along the last axis."""
        for i in range(arr.shape[-1]):
            self.observe(arr[..., i])

    def observe_cap(self, cap):
        """cap [*batch, C, 4]."""
        self.observe_array(cap.reshape(cap.shape[:-2] + (-1,)))

    def observe_ext_array(self, e):
        """ext pair of [*batch, K]: observes c0[i], c1[i] for i < K."""
        self.observe_array(torch.stack([e[0], e[1]], -1).flatten(-2))

    def _duplex(self):
        k = len(self.inputs)
        if k:
            self.state = torch.cat([torch.stack(self.inputs), self.state[k:]], 0)
        self.state = poseidon.permute_stacked(self.state)
        self.inputs = []
        self.outputs = list(self.state[:poseidon.RATE])

    def get_challenge(self):
        if self.inputs or not self.outputs:
            self._duplex()
        return self.outputs.pop()

    def get_ext(self):
        a = self.get_challenge()
        return (a, self.get_challenge())

    def get_indices(self, domain_size: int, count: int):
        """count index tensors in [0, domain_size) (a power of two: low bits)."""
        assert domain_size & (domain_size - 1) == 0
        return [self.get_challenge() & (domain_size - 1) for _ in range(count)]

    def check_pow(self, witness, pow_bits: int):
        """Absorb the witness [*batch] and draw the response; True per lane
        where its top pow_bits bits are zero (the verifier's side of grind)."""
        assert 0 < pow_bits <= 32
        if self.inputs:
            self._duplex()
        self.observe(witness)
        return gl.shr(self.get_challenge(), 64 - pow_bits) == 0

    def grind(self, pow_bits: int):
        """Find, per lane, the first witness whose response clears pow_bits
        leading zero bits; absorb it and return it [*batch].  A lane that
        exhausts the candidate cap gets GRIND_EXHAUSTED, which proof
        collection rejects.  The cap is the reference device grind's
        (max_chunks << chunk_log2)."""
        assert 0 < pow_bits <= 32
        max_candidates = 4096 << min(15, pow_bits + 4)
        if self.inputs:
            self._duplex()
        st = self.state.reshape(poseidon.WIDTH, -1)
        w, found = poseidon_cuda.grind(st, pow_bits, max_candidates)
        w = torch.where(found, w, torch.full_like(w, GRIND_EXHAUSTED))
        w = w.reshape(self.batch_shape)
        self.observe(w)
        self.get_challenge()  # consume the (zero-prefixed) response
        return w
