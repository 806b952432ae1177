"""Decode-cache geometry: per-layer-group KV specs with ring buffers.

Layers are grouped by their attention window; each window-homogeneous group
owns one stacked ``k{g}``/``v{g}`` cache of shape (L_g, B, length, K, hd).
Global groups allocate ``kv_len + slack``; windowed groups a
``min(window, kv_len) + slack`` ring written at ``pos % length``. ``slack``
is the engine's prefill chunk (chunk writes may spill past a row's valid
prefix). ``cache_bytes`` accounts the grouped allocation against the
uniform full-length baseline. See the reference's ``repro/serve/cache.py``
for the ring-correctness argument, which carries over unchanged.

This slice stores caches dense (``""``/``"f32"``); the quantised q8/q4
formats come with the ``block_quant`` and ``decode_attention_quant``
kernels. The transformer's decode step serves all-global stacks only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

KV_FORMATS = ("f32", "q8", "q4")
_PORTED_KV_FORMATS = ("f32",)


def _itemsize(dtype: str) -> int:
    return torch.empty((), dtype=getattr(torch, dtype)).element_size()


def parse_kv_formats(formats, n_groups: int, head_dim: int
                     ) -> Tuple[str, ...]:
    """Normalise a KV-format request to one format per cache group: None/""
    (all dense), a single token (broadcast), a comma list or a sequence."""
    if formats is None or formats == "":
        return ("f32",) * n_groups
    if isinstance(formats, str):
        toks = [t.strip() for t in formats.split(",") if t.strip()]
    else:
        toks = [str(t) for t in formats]
    if len(toks) == 1:
        toks = toks * n_groups
    if len(toks) != n_groups:
        raise ValueError(
            f"kv_format {formats!r}: got {len(toks)} formats for "
            f"{n_groups} cache groups")
    for t in toks:
        if t not in KV_FORMATS:
            raise ValueError(f"unknown kv format {t!r} (expected one of "
                             f"{KV_FORMATS}, or 'auto' resolved upstream)")
        if t not in _PORTED_KV_FORMATS:
            raise NotImplementedError(
                f"kv format {t!r} is not ported yet: the quantised cache "
                "needs the block_quant and decode_attention_quant kernels")
    return tuple(toks)


def layer_groups(windows) -> Tuple[Tuple[int, Tuple[int, ...]], ...]:
    """Group a per-layer window pattern into window-homogeneous cache
    groups, ordered by first appearance: ``((window, layers), ...)``."""
    order: List[int] = []
    members: Dict[int, List[int]] = {}
    for i, w in enumerate(int(w) for w in np.asarray(windows).reshape(-1)):
        if w not in members:
            members[w] = []
            order.append(w)
        members[w].append(i)
    return tuple((w, tuple(members[w])) for w in order)


@dataclass(frozen=True)
class CacheGroup:
    """One window-homogeneous layer group's KV cache geometry."""
    index: int                # group id == suffix of the state keys
    window: int               # sliding-window size; 0 = global attention
    layers: Tuple[int, ...]   # absolute layer indices in stack order
    length: int               # allocated kv slots per layer
    fmt: str = "f32"          # storage format

    @property
    def ring(self) -> bool:
        return self.window > 0

    @property
    def quantised(self) -> bool:
        return self.fmt != "f32"

    @property
    def k_key(self) -> str:
        return f"k{self.index}"

    @property
    def v_key(self) -> str:
        return f"v{self.index}"

    @property
    def group_state_keys(self) -> Tuple[str, ...]:
        return (self.k_key, self.v_key)


@dataclass(frozen=True)
class CacheSpec:
    """A model's full self-attention decode-cache geometry; ``full_length``
    is the uniform allocation's length (the accounting baseline)."""
    groups: Tuple[CacheGroup, ...]
    batch: int
    kv_heads: int
    head_dim: int
    dtype: str
    full_length: int
    layer_axis: str = "layers"
    head_axis: str = "kv_heads"

    def state_specs(self) -> dict:
        """Grouped decode-state entries: per group, dense ``k{g}``/``v{g}``
        rows at the spec dtype."""
        from repro_torch.models.api import ParamSpec
        specs = {}
        for g in self.groups:
            shape = (len(g.layers), self.batch, g.length, self.kv_heads,
                     self.head_dim)
            axes = (self.layer_axis, "batch", "seq_kv", self.head_axis, None)
            spec = ParamSpec(shape, axes, self.dtype)
            specs[g.k_key] = spec
            specs[g.v_key] = spec
        return specs

    @property
    def n_layers(self) -> int:
        return sum(len(g.layers) for g in self.groups)

    @property
    def formats(self) -> Tuple[str, ...]:
        return tuple(g.fmt for g in self.groups)

    @property
    def quantised(self) -> bool:
        return any(g.quantised for g in self.groups)

    @property
    def state_keys(self) -> Tuple[str, ...]:
        return tuple(k for g in self.groups for k in g.group_state_keys)

    def cache_bytes(self) -> dict:
        """Per-group breakdown, grouped total (``kv``) with its code/scale
        split, the grouped geometry at the dense dtype (``dense_kv``) and the
        uniform full-length baseline (``uniform_kv``) — the reference's
        keys and numbers."""
        item = _itemsize(self.dtype)
        dense_row = 2 * self.batch * self.kv_heads * self.head_dim * item
        per = []
        kv = codes = scales = dense = 0
        for g in self.groups:
            d = dense_row * len(g.layers) * g.length
            cb, sb = d, 0
            b = cb + sb
            per.append({"window": g.window, "n_layers": len(g.layers),
                        "length": g.length, "format": g.fmt, "bytes": b,
                        "code_bytes": cb, "scale_bytes": sb,
                        "dense_bytes": d,
                        "ratio_vs_dense": round(b / d, 4) if d else 1.0})
            kv += b
            codes += cb
            scales += sb
            dense += d
        uniform = dense_row * self.n_layers * self.full_length
        return {"kv": kv, "code_bytes": codes, "scale_bytes": scales,
                "dense_kv": dense,
                "cache_ratio_vs_dense": round(kv / dense, 4) if dense
                else 1.0,
                "uniform_kv": uniform,
                "cache_ratio_vs_uniform": round(kv / uniform, 4) if uniform
                else 1.0,
                "cache_groups": per}


def build_cache_spec(windows, batch: int, kv_len: int, *, slack: int = 0,
                     kv_heads: int, head_dim: int, dtype: str,
                     windowed: bool = True, layer_axis: str = "layers",
                     head_axis: str = "kv_heads",
                     formats=None) -> CacheSpec:
    """Build a model's grouped cache geometry from its per-layer window
    pattern: global groups (and every group when ``windowed=False``)
    allocate ``kv_len + slack``, windowed groups ``min(window, kv_len) +
    slack`` ring slots."""
    full = kv_len + slack
    grouped = layer_groups(windows)
    fmts = parse_kv_formats(formats, len(grouped), head_dim)
    groups = []
    for i, (w, layers) in enumerate(grouped):
        length = min(w, kv_len) + slack if (windowed and w > 0) else full
        groups.append(CacheGroup(index=i, window=w, layers=layers,
                                 length=length, fmt=fmts[i]))
    return CacheSpec(tuple(groups), batch, kv_heads, head_dim, dtype, full,
                     layer_axis, head_axis)


# ---------------------------------------------------------------------------
# Ring index math (shared with models.layers)
# ---------------------------------------------------------------------------

def ring_slots(positions, length: int):
    """Ring slot for each absolute position."""
    return positions % length


def ring_positions(last, length: int):
    """The absolute position each ring slot currently holds: slot ``s`` holds
    the most recent position ≤ ``last`` congruent to ``s`` mod ``length``;
    negative ⇒ never written. ``last``: (...,) ints → (..., length)."""
    last = torch.as_tensor(last)
    s = torch.arange(length, dtype=last.dtype, device=last.device)
    return last[..., None] - torch.remainder(last[..., None] - s, length)
