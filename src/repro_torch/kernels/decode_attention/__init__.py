"""Decode attention over a quantised KV cache: the CUDA kernel's wrapper
and its plain torch version."""
