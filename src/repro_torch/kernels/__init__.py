"""repro_torch.kernels — hand-written Hopper kernels and their dispatch.

  dequant_matmul   fused dequantise @ x, CUDA C++ for sm_90a
                   (``csrc/dequant_matmul.cu``), built with nvcc at first
                   use and bound with ctypes (``dequant_matmul/build.py``)

``ops`` sends CUDA tensors to the kernel and CPU tensors to its plain torch
version in ``<kernel>/ref.py``.
"""
