"""CPU tests of the benchmark, and the control that the chip runs:
``python -m pytest benchmark/selftest -q`` from the repository's root."""
