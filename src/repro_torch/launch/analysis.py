"""Dry-run analysis: per-device collective bytes from the collectives a run
records, per-device FLOPs, and analytic per-device memory accounting (the
roofline's raw inputs).

Collective cost model (per-device bytes on a ring, group size n), the
reference's:
    all-gather       (n-1)/n × output_bytes
    all-reduce     2·(n-1)/n × input_bytes
    reduce-scatter   (n-1)/n × input_bytes
    all-to-all       (n-1)/n × input_bytes
    collective-permute        input_bytes

The reference reads XLA's optimised HLO text, which the port never makes.
What replaces each of its parsers:
    ``parse_collective_bytes``  → :class:`DeviceRecorder` records every
        collective one rank issues (op, bytes, group size) as DTensor
        desugars into ``torch.distributed`` calls, and
        :func:`collective_bytes` applies the cost model; ``CommDebugMode``
        counts the same calls.
    ``parse_hlo_dot_stats`` (``parse_hlo_dot_flops`` / ``_bytes``) →
        :class:`DeviceRecorder`'s ``flops`` (the ops on one rank's local
        shards, by ``torch.utils.flop_counter``'s formulas) beside
        ``FlopCounterMode``'s count over the global DTensor shapes.
    ``parse_hlo_memory_bytes`` → the local bytes of one rank's arguments
        (the dry run's ``memory.argument_bytes``) and
        :func:`analytic_bytes_per_device`.
    ``count_hlo_ops`` and ``while_trip_counts`` → nothing: eager torch has
        no fused ops or loops to count; the layer loops run in Python.
``analytic_bytes_per_device`` and ``model_flops`` are the reference's
numbers, on the port's own ``ParamSpec`` trees and configs.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

# op name → (kind, which tensor sizes it: "in" = argument index, "out")
_COLLECTIVES = {
    # functional collectives (DTensor's redistributions, the port's own)
    "all_reduce": ("all-reduce", 0),
    "all_reduce_": ("all-reduce", 0),
    "all_gather_into_tensor": ("all-gather", "out"),
    "all_gather_into_tensor_out": ("all-gather", "out"),
    "reduce_scatter_tensor": ("reduce-scatter", 0),
    "all_to_all_single": ("all-to-all", 0),
    # c10d in-place ops (``torch.distributed.all_reduce`` and friends)
    "allreduce_": ("all-reduce", 0),
    "_allgather_base_": ("all-gather", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "alltoall_base_": ("all-to-all", 1),
}
_NAMESPACES = ("_c10d_functional", "c10d_functional",
               "_c10d_functional_autograd", "c10d")


def _tensor_bytes(x) -> int:
    """Bytes of a tensor, a list of them, or the tensor fields of a
    quantised or packed tensor; one rank's shard of a DTensor."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        x = x.to_local()
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(t) for t in x)
    if dataclasses.is_dataclass(x):
        return sum(_tensor_bytes(getattr(x, f.name))
                   for f in dataclasses.fields(x))
    return 0


def _group_size(args) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in args:
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except (KeyError, ValueError, RuntimeError):
                continue
        if hasattr(a, "size") and not isinstance(a, torch.Tensor) \
                and callable(a.size):
            return int(a.size())
    raise ValueError("no process group among a collective's arguments")


def _is_fake(args) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return any(isinstance(a, FakeTensor) for a in args)


class DeviceRecorder(TorchDispatchMode):
    """One rank's view of a run over DTensors (the dry run's rank 0): every
    collective it issues, as ``{"op", "bytes", "group"}``, and the FLOPs of
    the ops it runs on local shards. A call on DTensors is left to DTensor
    (which splits it into local ops and collectives that come back here);
    ops on fake tensors (DTensor's shape propagation) are not counted.
    Enter it outside ``FlopCounterMode``, whose count is then the global
    one."""

    def __init__(self):
        super().__init__()
        self.collectives: List[dict] = []
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _is_fake(args):
            return out
        packet = func._overloadpacket
        count = flop_registry.get(packet)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        ns, _, name = str(packet).partition(".")
        if ns in _NAMESPACES and name in _COLLECTIVES:
            kind, which = _COLLECTIVES[name]
            sized = out if which == "out" else args[which]
            self.collectives.append({"op": kind,
                                     "bytes": _tensor_bytes(sized),
                                     "group": _group_size(args)})
        return out


def collective_bytes(records, n_devices: int) -> Dict[str, float]:
    """Per-device bytes by op kind (and ``total``) of recorded collectives
    ``{"op", "bytes", "group"}`` under the ring cost model; a record
    without a group size takes ``n_devices``."""
    out: Dict[str, float] = defaultdict(float)
    for r in records:
        n = r.get("group") or n_devices
        frac = (n - 1) / max(n, 1)
        op, b = r["op"], r["bytes"]
        if op == "all-reduce":
            cost = 2.0 * frac * b
        elif op in ("all-gather", "reduce-scatter", "all-to-all"):
            cost = frac * b
        else:  # collective-permute
            cost = float(b)
        out[op] += cost
        out["total"] += cost
    return dict(out)


# ---------------------------------------------------------- analytic memory

def analytic_bytes_per_device(spec_tree, mesh, rules, dtype_bytes=None) -> int:
    """Exact per-device bytes for a ParamSpec tree under a rule set."""
    from repro_torch.core.plan import flat_with_paths
    from repro_torch.launch.mesh import _axes_size, spec_for
    from repro_torch.models.api import ParamSpec, torch_dtype

    total = 0
    for _, s in flat_with_paths(spec_tree):
        if not isinstance(s, ParamSpec):
            continue
        shard = 1
        for part in spec_for(s.axes, s.shape, mesh, rules):
            if part is None:
                continue
            axes = (part,) if isinstance(part, str) else part
            shard *= _axes_size(mesh, tuple(axes))
        itemsize = torch_dtype(s.dtype).itemsize
        total += s.numel * itemsize // max(shard, 1)
    return total


# ------------------------------------------------------------ model flops

def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D for training (fwd+bwd), 2·N_active·D for decode
    (+ attention KV term), N = active params excluding embeddings' unused
    rows. D = tokens processed."""
    from repro_torch.models.api import count_params, get_family

    fam = get_family(cfg.family)
    n_total = count_params(fam.param_specs(cfg))
    # active params: for MoE, experts contribute k/E of their weight
    n_active = n_total
    if cfg.n_experts:
        E, k = cfg.n_experts, cfg.experts_per_token
        # expert tensors: 3 matrices per expert per layer
        expert_params = cfg.n_layers * E * 3 * cfg.d_model * cfg.dff_expert
        n_active = n_total - expert_params + expert_params * k / E
    # embedding rows are lookups, not matmuls: subtract embed (keep unembed)
    n_active -= cfg.vocab * cfg.d_model

    def attn_score_flops(n_passes):
        # QK^T + AV: 2 matmuls × 2 FLOPs × B × T²/2 (causal) × H × hd / layer
        if cfg.family not in ("transformer", "internvl", "whisper"):
            return 0.0
        return (n_passes * 2 * 2 * shape.batch * shape.seq ** 2 / 2
                * cfg.n_heads * cfg.hd * cfg.n_layers)

    if shape.kind == "train":
        tokens = shape.batch * shape.seq
        return 6.0 * n_active * tokens + attn_score_flops(3)  # fwd+bwd(2x)
    if shape.kind == "prefill":
        tokens = shape.batch * shape.seq
        return 2.0 * n_active * tokens + attn_score_flops(1)
    # decode: one token, KV attention reads
    tokens = shape.batch
    flops = 2.0 * n_active * tokens
    if cfg.family in ("transformer", "internvl", "whisper"):
        flops += 2 * 2 * shape.batch * shape.seq * cfg.n_heads * cfg.hd * \
            cfg.n_layers
    return flops


def local_bytes(tree) -> int:
    """Bytes one rank holds of a tree of (D)Tensors: a DTensor's local
    shard, a plain tensor whole."""
    from repro_torch.core.plan import _flat_with_paths
    return sum(_tensor_bytes(x) for _, x in _flat_with_paths(tree))
