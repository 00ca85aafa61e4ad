"""PyTorch/CUDA port of the batched plonky2-style ECDSA prover.

The JAX package ``plonky2_ecdsa_tpu`` is the reference: this package imports
its host layers (circuit, witness tape, fixed-data build, verifier), never
imports JAX, and runs the prover on int64 tensors with CUDA kernels for the
Poseidon2 permutation, the FRI grind and the sub-NTT.  Entry point:
``plonky2_ecdsa_tpu_torch.api.EcdsaProverSystem``.
"""
