"""repro_torch — the PyTorch + CUDA port of ``repro`` for an NVIDIA H100.

It mirrors ``src/repro/``'s layout (``core``, ``kernels``, ``models``,
``serve``, ``data``, ``train``, ``launch``, ``configs``) and never imports
``repro`` or JAX.
Every TPU kernel on a ported path has a hand-written Hopper counterpart in
``kernels/csrc`` beside a plain torch version; tensors on the card take the
kernel, tensors on the CPU the plain version.
"""
