"""
The int8 experiments of the JAX package (experiments/exp_pallas_*.py),
ported: each module here is named after its original without 'pallas_'
and runs the original's variants through the port's CUDA kernels
(ops/conv_int8.py conv3x3_int8_exp, ops/gemm_int8.py gemm_int8), with
PyTorch calls as yardsticks where the original compared against XLA.

    python -m megadetector_tpu_torch.experiments.exp_int8_matmul
    python -m megadetector_tpu_torch.experiments.exp_conv3x3 --check \\
        --device cpu

_harness.py holds what they share. Nothing runs at import.
"""
