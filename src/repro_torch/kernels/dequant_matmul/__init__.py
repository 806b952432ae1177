"""Fused dequantise-matmuls (normal and transposed): the CUDA kernels'
wrappers and their plain torch versions."""
