"""Fused dequantise-matmul: CUDA kernel wrapper, build and plain version."""
