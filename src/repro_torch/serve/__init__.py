"""repro_torch.serve — the continuous-batching engine serving packed
quantised weights through the fused ``dequant_matmul`` kernels, from a
dense or quantised (q8/q4) KV cache with ring-buffered windowed groups, and
its front end.

  cache      grouped KV cache geometry, KV formats and byte accounting
  context_parallel  decode attention over a sequence-sharded KV cache
             (partials combined by log-sum-exp over a process group)
  engine     ``ServeEngine`` (+ ``from_quantised``), ``greedy_generate``
  scheduler  ``Scheduler`` (priority + aging admission, submit/stream),
             ``PrefixPool`` (shared-prefix KV prefilled once, forked)
  traffic    seeded replayable workloads and their latency/goodput report
  faults     fault injectors that drill the robustness paths
"""
from . import cache, context_parallel, engine, faults, scheduler, traffic
from .engine import (Generation, Request, ServeEngine, alloc_decode_state,
                     greedy_generate, host_to_device)
from .scheduler import PrefixPool, Scheduler, StreamHandle
from .traffic import TrafficSpec, Workload

__all__ = ["cache", "context_parallel", "engine", "faults", "scheduler",
           "traffic", "Generation", "Request", "ServeEngine",
           "alloc_decode_state", "greedy_generate", "host_to_device",
           "PrefixPool", "Scheduler", "StreamHandle", "TrafficSpec",
           "Workload"]
