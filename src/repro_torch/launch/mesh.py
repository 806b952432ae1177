"""Production mesh construction + logical→physical sharding rules.

Mesh: (16, 16) = 256 ranks per pod ("data", "model"); multi-pod adds a
leading "pod" axis: (2, 16, 16) = 512 ranks. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the process group that
is already initialised; importing this module touches no process group.

Logical axes (annotated on every ParamSpec in the model zoo) map to mesh
axes through ordered candidate lists with divisibility-aware fallback: a
dim that cannot shard evenly on its first candidate tries the next and
ultimately replicates (e.g. kv_heads=8 on a 16-way model axis). The rule
tables and :func:`spec_for` are the reference's (``repro/launch/mesh.py``)
as data; :func:`placements_for` turns a per-tensor-dim spec into DTensor
placements per mesh dim.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import torch.distributed as dist

AxisOption = Union[str, Tuple[str, ...]]
# one entry per tensor dim: None (replicated), a mesh axis name, or a tuple
# of names sharding that dim jointly (the reference's PartitionSpec parts)
TensorSpec = Tuple[Optional[AxisOption], ...]


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) with "pod" in
    front, over the initialised world; raises if its size differs."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh_over_world(shape, axes, device_type)


def make_host_mesh(model: int = 1, device_type: str = "cuda"):
    """A (world // model, model) ("data", "model") mesh over however many
    ranks the initialised world has — for tests."""
    n = _world_size()
    if n % model:
        raise ValueError(f"world of {n} ranks does not split into model "
                         f"groups of {model}")
    return _mesh_over_world((n // model, model), ("data", "model"),
                            device_type)


def _world_size() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group is initialised: call "
                           "torch.distributed.init_process_group first")
    return dist.get_world_size()


def _mesh_over_world(shape, axes, device_type):
    from torch.distributed.device_mesh import init_device_mesh
    n = _world_size()
    if n != math.prod(shape):
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs "
                         f"{math.prod(shape)} ranks; the world has {n}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


# Ordered candidates per logical axis. Tuples mean "use these mesh axes
# jointly" (e.g. batch over pod×data).
RuleSet = Dict[str, Sequence[AxisOption]]

TRAIN_RULES: RuleSet = {
    "batch": [("pod", "data"), "data"],
    "fsdp": [("pod", "data"), "data"],       # ZeRO-3-style parameter shard
    "vocab": ["model"],
    "heads": ["model"],
    "heads_flat": ["model"],                  # flattened H*hd projections
    "kv_heads": ["model"],                    # falls back to replicate (kv=8)
    "mlp": ["model"],
    "experts": ["model", "data"],             # EP; uneven E falls to data
    "seq": [None],
    "seq_kv": [None],
    "layers": [None],
    "groups": [None],
}

DECODE_RULES: RuleSet = {
    **TRAIN_RULES,
    "fsdp": ["data", ("pod", "data")],        # weights sharded for bandwidth
    "batch": [("pod", "data"), "data"],
    "seq_kv": [None],
}

# decode variant for GQA archs whose kv_heads don't divide the model axis:
# shard the KV cache on its *sequence* dim instead (flash-decode partial
# softmax and a small combine). 16× cache memory win vs replication.
DECODE_RULES_SEQKV: RuleSet = {
    **DECODE_RULES,
    "kv_heads": [None],
    "seq_kv": ["model"],
}


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name → size of a ``DeviceMesh``, or of any object whose
    ``.shape`` already maps names to sizes (a planning stand-in that needs
    no process group)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def decode_rules_for(n_kv_heads: int, mesh) -> RuleSet:
    if n_kv_heads % mesh_shape(mesh).get("model", 1) == 0:
        return DECODE_RULES
    return DECODE_RULES_SEQKV


# long-context decode (batch=1): context parallelism — KV sequence over the
# data axis, heads over model; pod replicates for throughput.
LONG_DECODE_RULES: RuleSet = {
    **TRAIN_RULES,
    "batch": [None],
    "fsdp": [None],                           # params replicated data-wise…
    "heads": ["model"],
    "kv_heads": ["model"],
    "seq_kv": [("pod", "data"), "data"],      # the context-parallel axis
}

RULES_BY_KIND = {
    "train": TRAIN_RULES,
    "prefill": TRAIN_RULES,
    "decode": DECODE_RULES,
    "long_decode": LONG_DECODE_RULES,
}


def _axes_size(mesh, opt: Tuple[str, ...]) -> int:
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in opt)


def spec_for(axes: Sequence[Optional[str]], shape: Sequence[int], mesh,
             rules: RuleSet) -> TensorSpec:
    """One entry per tensor dim (None, an axis name or a tuple of names),
    honouring divisibility and no-axis-reuse, with ordered fallback per
    logical axis: the reference's ``PartitionSpec`` parts."""
    sizes = mesh_shape(mesh)
    used: set = set()
    parts = []
    for dim, ax in zip(shape, axes):
        chosen: Optional[Tuple[str, ...]] = None
        if ax is not None:
            for opt in rules.get(ax, [None]):
                if opt is None:
                    break
                opt_t = (opt,) if isinstance(opt, str) else tuple(opt)
                if any(a not in sizes for a in opt_t):
                    continue
                if any(a in used for a in opt_t):
                    continue
                if dim % _axes_size(mesh, opt_t) != 0:
                    continue
                chosen = opt_t
                break
        if chosen is None:
            parts.append(None)
        else:
            used.update(chosen)
            parts.append(chosen[0] if len(chosen) == 1 else chosen)
    return tuple(parts)


def placements_for(spec: TensorSpec, mesh) -> tuple:
    """DTensor placements per mesh dim for a per-tensor-dim ``spec``:
    ``Shard(d)`` on every mesh dim that tensor dim d names, ``Replicate()``
    on the rest. A dim sharded over a tuple of axes is split over them
    left to right, the first axis the major one, which is the reference's
    layout when the tuple follows the mesh's dim order (as every rule
    does); another order raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, part in enumerate(spec):
        if part is None:
            continue
        axes = (part,) if isinstance(part, str) else tuple(part)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} of dim {d} do not follow the "
                             f"mesh's dim order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def shardings_for_specs(spec_tree, mesh, rules: RuleSet):
    """tree[ParamSpec] -> tree[placements] (one DTensor placement per mesh
    dim for each leaf)."""
    from repro_torch.core.plan import map_with_paths

    return map_with_paths(
        lambda _, s: placements_for(spec_for(s.axes, s.shape, mesh, rules),
                                    mesh), spec_tree)


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and one DTensor placement per mesh dim: the port's
    counterpart of ``jax.sharding.NamedSharding`` (what
    ``train.checkpoint.restore_checkpoint(shardings=)`` takes per leaf)."""
    mesh: object
    placements: tuple


def named_shardings(spec_tree, mesh, rules: RuleSet):
    """tree[ParamSpec] -> tree[NamedSharding] over ``mesh``: the placements
    of :func:`shardings_for_specs` with their mesh."""
    from repro_torch.core.plan import map_with_paths

    return map_with_paths(lambda _, p: NamedSharding(mesh, p),
                          shardings_for_specs(spec_tree, mesh, rules))


def describe_sharding(spec_tree, mesh, rules: RuleSet) -> str:
    from repro_torch.core.plan import flat_with_paths

    lines = []
    for path, s in flat_with_paths(spec_tree):
        ps = spec_for(s.axes, s.shape, mesh, rules)
        lines.append(f"{path:60s} {str(s.shape):28s} {ps}")
    return "\n".join(lines)
