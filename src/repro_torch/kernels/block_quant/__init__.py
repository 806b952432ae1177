"""Block-absmax quantisation: the CUDA kernel's wrapper and its plain
torch version."""
