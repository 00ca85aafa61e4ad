"""The benchmark of the PyTorch and CUDA prover (plonky2_ecdsa_tpu_torch):
``python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""
