"""repro_torch.serve — the continuous-batching engine serving packed
quantised weights through the fused ``dequant_matmul`` kernels, from a
dense or quantised (q8/q4) KV cache with ring-buffered windowed groups, and
its front end.

  cache      grouped KV cache geometry, KV formats and byte accounting
  engine     ``ServeEngine`` (+ ``from_quantised``), ``greedy_generate``
  scheduler  ``Scheduler`` (priority + aging admission, submit/stream),
             ``PrefixPool`` (shared-prefix KV prefilled once, forked)
  traffic    seeded replayable workloads and their latency/goodput report
  faults     fault injectors that drill the robustness paths
"""
from . import cache, engine, faults, scheduler, traffic
from .engine import (Generation, Request, ServeEngine, alloc_decode_state,
                     greedy_generate, host_to_device)
from .scheduler import PrefixPool, Scheduler, StreamHandle
from .traffic import TrafficSpec, Workload

__all__ = ["cache", "engine", "faults", "scheduler", "traffic", "Generation",
           "Request", "ServeEngine", "alloc_decode_state", "greedy_generate",
           "host_to_device", "PrefixPool", "Scheduler", "StreamHandle",
           "TrafficSpec", "Workload"]
