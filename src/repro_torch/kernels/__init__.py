"""repro_torch.kernels — hand-written Hopper kernels and their dispatch.

  dequant_matmul          fused dequantise @ x          csrc/dequant_matmul.cu
  dequant_matmul_t        x @ dequantise.T (tied unembed)
                                                        csrc/dequant_matmul_t.cu
  block_quant             block-absmax quantisation; block_quant_kv
                          writes a layer's k and v in one launch
                                                        csrc/block_quant.cu
  decode_attention_quant  decode attention from quantised KV
                                                        csrc/decode_attention.cu

All CUDA C++ for sm_90a, built with nvcc at first use (one library per
source, in parallel) and bound with ctypes (``build.py``). ``ops`` sends
CUDA tensors to the kernels and CPU tensors to their plain torch versions in
``<kernel>/ref.py``.
"""
