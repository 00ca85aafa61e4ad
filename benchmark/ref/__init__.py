"""The benchmark's plain reference: Goldilocks arithmetic, Poseidon2, the
gates' constraints and a verifier of the program's proofs, in numpy.  It
imports nothing of the program."""
