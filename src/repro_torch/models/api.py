"""Model API: configs, parameter specs, the family registry and the shared
ragged-serving prologue.

Parameters are nested dicts of tensors. Each leaf is described by a
``ParamSpec(shape, axes, dtype)``; ``axes`` name logical mesh axes and are
kept so the specs compare field by field with the reference's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.plan import flat_with_paths, map_with_paths


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU. Without a CUDA device, only an explicit CPU device is
    accepted; nothing falls back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain torch path on the CPU")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """torch dtype of a spec dtype name ("float32", "bfloat16", ...)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: str = "float32"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in rank")

    @property
    def numel(self) -> int:
        return int(np.prod(self.shape))


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "transformer"   # transformer | rwkv6 | zamba2 | whisper | internvl
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0             # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab: int = 1024
    # --- MoE ---
    n_experts: int = 0            # 0 -> dense
    experts_per_token: int = 1
    n_shared_experts: int = 0
    d_expert: int = 0             # 0 -> d_ff
    capacity_factor: float = 1.25
    # --- attention pattern ---
    window: int = 0               # sliding-window size for local layers
    local_global_pattern: Tuple[int, ...] = ()  # e.g. (5, 1): 5 local : 1 global
    qk_norm: bool = False
    # --- ssm / hybrid ---
    ssm_state: int = 0
    d_inner: int = 0              # 0 -> 2 * d_model
    conv_kernel: int = 4
    attn_every: int = 0           # zamba2: shared attn period
    # --- enc-dec (whisper) ---
    n_enc_layers: int = 0
    enc_seq: int = 1500
    # --- vlm (internvl) ---
    n_vis_tokens: int = 0
    # --- misc ---
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"       # compute dtype
    param_dtype: str = "float32"  # master dtype
    kv_dtype: str = ""            # KV-cache storage dtype ("" = dtype)
    kv_format: str = ""           # KV-cache storage per cache group ("" =
                                  # dense; "q8"/"q4", or a comma list)
    attn_chunk: int = 1024        # flash-attention KV chunk
    linear_chunk: int = 32        # WKV/SSD block-parallel chunk (0 = scan)
    remat: str = "full"           # none | full | dots
    moe_impl: str = "sort"        # moe dispatch: "sort" | "dense"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def dff_expert(self) -> int:
        return self.d_expert or self.d_ff

    @property
    def dinner(self) -> int:
        return self.d_inner or 2 * self.d_model

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def window_pattern(self) -> np.ndarray:
        """Per-layer sliding-window sizes; 0 = global attention."""
        if not self.local_global_pattern:
            return np.zeros(self.n_layers, np.int32)
        nl, ng = self.local_global_pattern
        unit = [self.window] * nl + [0] * ng
        reps = (self.n_layers + len(unit) - 1) // len(unit)
        return np.asarray((unit * reps)[: self.n_layers], np.int32)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_FAMILIES: Dict[str, "ModelFamily"] = {}


@dataclass
class ModelFamily:
    """One architecture family's contract with the system (see the
    reference's ``repro/models/api.py`` for the full protocol).

    Weights are applied only through ``models.layers.linear`` /
    ``embed_lookup``, so any tensor declared in ``pack_layouts`` serves
    straight from packed codes. ``pack_layouts(cfg) -> {tensor-path:
    (n_lead, n_contract)}`` is required."""

    name: str
    param_specs: Callable           # (cfg) -> tree[ParamSpec]
    init: Callable                  # (cfg, seed=, device=) -> params
    apply: Callable = None          # (params, batch, cfg) -> f32 logits
    decode_state_specs: Callable = None
    decode_step: Callable = None    # (params, state, batch, cfg) -> (logits, state)
    prefill: Callable = None
    supports_ragged: bool = False
    cross_prefill: Callable = None
    cache_spec: Callable = None
    pack_layouts: Callable = None

    def __post_init__(self):
        if self.pack_layouts is None:
            raise ValueError(
                f"ModelFamily {self.name!r}: pack_layouts is required — "
                "declare the packed-serving matmul layouts (an empty dict "
                "for a family with none)")


def ragged_prologue(state, batch, reset_axes):
    """The shared prologue of the ragged serving protocol: read the per-slot
    positions, default the advance counts from ``t_valid``, and honour the
    per-slot ``reset`` mask by zeroing the named state entries (and pos).

    The wipe is **in place**: the state stacks are large (a cache is
    (L, B, S, K, hd)) and the engine owns them, so a reset slot's rows are
    zeroed where they lie with ``masked_fill_``. Returns ``(pos, adv,
    valid, entries)`` as the reference does; ``valid`` is the (B, T) mask
    of real tokens, or None for a plain T=1 call without ``t_valid``."""
    tokens = batch["tokens"]
    B, T = tokens.shape
    dev = tokens.device
    pos = state["pos"]                                     # (B,)
    t_valid = batch.get("t_valid")
    adv = (torch.full((B,), T, dtype=torch.int32, device=dev)
           if t_valid is None else t_valid)
    entries = {k: state[k] for k in reset_axes}
    reset = batch.get("reset")
    if reset is not None:
        rm = reset.to(torch.bool)
        for key, ax in reset_axes.items():
            a = entries[key]
            shape = [1] * a.ndim
            shape[ax] = a.shape[ax]
            a.masked_fill_(rm.reshape(shape), 0)
        pos = torch.where(rm, torch.zeros_like(pos), pos)
    valid = (torch.arange(T, dtype=torch.int32, device=dev)[None, :]
             < adv[:, None] if (T > 1 or t_valid is not None) else None)
    return pos, adv, valid, entries


def ring_prologue(state, batch, n_groups: int, extra_reset=None,
                  formats=None):
    """The grouped-cache variant of :func:`ragged_prologue`: every group's
    ``k{g}``/``v{g}`` stack wipes at batch axis 1 (plus scale stacks of
    quantised groups and any family extras)."""
    axes = {}
    for g in range(n_groups):
        axes[f"k{g}"] = 1
        axes[f"v{g}"] = 1
        if formats is not None and formats[g] != "f32":
            axes[f"k{g}s"] = 1
            axes[f"v{g}s"] = 1
    if extra_reset:
        axes.update(extra_reset)
    return ragged_prologue(state, batch, axes)


def register_family(fam: ModelFamily):
    _FAMILIES[fam.name] = fam
    return fam


def get_family(name: str) -> ModelFamily:
    if name not in _FAMILIES:
        from . import transformer  # noqa: F401  (registers on import)
    if name not in _FAMILIES:
        raise KeyError(f"model family {name!r} is not ported yet "
                       f"(ported: {sorted(_FAMILIES)})")
    return _FAMILIES[name]


# ---------------------------------------------------------------------------
# Spec utilities
# ---------------------------------------------------------------------------

def init_from_specs(specs, *, seed: int = 0, device=None):
    """Materialise parameters on ``device``: truncated-normal (±3σ) fan-in
    init for >=2-D leaves (std 0.02 for embeddings), ones for norm gains,
    zeros for biases and vectors. One ``torch.Generator`` seeded with
    ``seed`` on the target device draws every leaf in sorted path order.
    The numbers differ from ``jax.random``'s; tests carry reference weights
    across with ``repro_torch.interop`` instead."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def make(name, spec):
        dt = torch_dtype(spec.dtype)
        if "norm" in name or name.endswith("gain']"):
            return torch.ones(spec.shape, dtype=dt, device=dev)
        if "bias" in name or spec.numel == 0 or len(spec.shape) < 2:
            return torch.zeros(spec.shape, dtype=dt, device=dev)
        if "embed" in name:
            std = 0.02
        else:  # fan_in = numel / fan_out(last dim)
            std = 1.0 / np.sqrt(max(spec.numel // max(spec.shape[-1], 1), 1))
        x = torch.empty(spec.shape, dtype=torch.float32, device=dev)
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -3.0, 3.0, generator=gen)
        return x.mul_(std).to(dt)

    leaves = {name: make(name, spec)
              for name, spec in flat_with_paths(specs)}
    return map_with_paths(lambda name, _: leaves[name], specs)
