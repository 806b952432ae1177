"""repro_torch.serve — the continuous-batching engine serving packed
quantised weights through the fused ``dequant_matmul`` kernels, from a
dense or quantised (q8/q4) KV cache with ring-buffered windowed groups.

  cache   grouped KV cache geometry, KV formats and byte accounting
  engine  ``ServeEngine`` (+ ``from_quantised``) and ``greedy_generate``
"""
from .engine import (Generation, Request, ServeEngine, alloc_decode_state,
                     greedy_generate, host_to_device)

__all__ = ["Generation", "Request", "ServeEngine", "alloc_decode_state",
           "greedy_generate", "host_to_device"]
