"""PyTorch/CUDA port of the batched plonky2-style ECDSA prover.

The JAX package ``plonky2_ecdsa_tpu`` is the reference this package is held
against by the tests; the package itself is self-contained.  It imports
``torch`` and numpy, never JAX and nothing of the reference: the circuit
construction, gadgets, witness tape (with its C++ runtime), fixed-data build,
prover and verifier are all its own.  Host code (circuit building, witness
generation) is numpy; everything computed over the domain runs on int64
tensors on an explicit device, with CUDA kernels for the Poseidon2
permutation, the FRI grind and the sub-NTT.  Entry point:
``plonky2_ecdsa_tpu_torch.api.EcdsaProverSystem``.
"""
