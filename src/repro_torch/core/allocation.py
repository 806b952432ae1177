"""Fisher-based variable bit-width allocation (Eq. 5, App. B.5):

    b*_t = b0 + log2 RMS(θ_t) + ½ log2 f̄_t

with b0 chosen (by bisection) to satisfy the model-level average-bits
constraint under clipping and optional integer rounding. Also implements the
paper's *heuristic* baseline (fig. 30): +2 bits for the first/last two layers
and embedding/head tensors.

Host numpy, carried over from the reference's ``repro/core/allocation.py``
unchanged, so one set of per-tensor statistics gives the same allocation in
both packages.
"""
from __future__ import annotations

import math
import re
from typing import Dict

import numpy as np


def raw_sensitivity(stats: Dict[str, dict]) -> Dict[str, float]:
    """log2 RMS + ½ log2 f̄ per tensor (the b0-independent part of Eq. 5)."""
    out = {}
    for name, s in stats.items():
        f = max(float(s["fisher_mean"]), 1e-30)
        r = max(float(s["rms"]), 1e-30)
        out[name] = math.log2(r) + 0.5 * math.log2(f)
    return out


def allocate_bits(
    stats: Dict[str, dict],
    target_bits: float,
    b_min: float = 0.5,
    b_max: float = 16.0,
    integer: bool = False,
) -> Dict[str, float]:
    """Solve for b0 such that Σ N_t clip(b0 + raw_t) == target · Σ N_t."""
    raw = raw_sensitivity(stats)
    names = list(stats)
    n = np.array([stats[t]["numel"] for t in names], dtype=np.float64)
    r = np.array([raw[t] for t in names])
    total = n.sum()

    def avg_bits(b0: float) -> float:
        b = np.clip(b0 + r, b_min, b_max)
        if integer:
            b = np.maximum(np.round(b), max(1.0, round(b_min)))
        return float((n * b).sum() / total)

    lo, hi = -64.0, 64.0
    for _ in range(80):
        mid = (lo + hi) / 2
        if avg_bits(mid) < target_bits:
            lo = mid
        else:
            hi = mid
    b0 = (lo + hi) / 2
    b = np.clip(b0 + r, b_min, b_max)
    if integer:
        b = np.maximum(np.round(b), max(1.0, round(b_min)))
    return {t: float(bi) for t, bi in zip(names, b)}


def kv_format_bytes(fmt: str, head_dim: int) -> float:
    """Resident bytes per dense cache element for a KV storage format,
    including the per-(token, head) f32 block scale amortised over the
    head dim (``serve.cache`` geometry: one scale per head_dim row)."""
    if fmt == "f32":
        return 4.0
    bits = {"q8": 8, "q4": 4}[fmt]
    return bits / 8.0 + 4.0 / head_dim


def allocate_kv_formats(
    stats: Dict[str, dict],
    budget_bytes: float,
    head_dim: int,
) -> Dict[str, str]:
    """Per-cache-group KV storage format under a resident cache-byte
    budget — the Eq. 5 machinery applied to the decode cache: each group's
    sensitivity is its b0-independent Fisher term (log2 RMS + ½ log2 f̄,
    :func:`raw_sensitivity` over :func:`repro_torch.core.fisher.estimate_kv_fisher`
    stats), and formats are demoted greedily from f32 through the
    block-scaled ladder (f32 → q8 → q4) **least-sensitive group first**
    until the budget is met — the discrete-format analogue of lowering b0.

    ``stats``: ``{group: {"numel", "rms", "fisher_mean"}}`` with ``numel``
    the group's dense f32 cache element count. Raises ``ValueError`` when
    even all-q4 exceeds the budget (the geometry, not the format, is then
    the problem)."""
    raw = raw_sensitivity(stats)
    fmt = {g: "f32" for g in stats}

    def total() -> float:
        return sum(stats[g]["numel"] * kv_format_bytes(fmt[g], head_dim)
                   for g in stats)

    order = sorted(stats, key=lambda g: raw[g])   # least sensitive first
    for down in ("q8", "q4"):
        for g in order:
            if total() <= budget_bytes:
                return fmt
            fmt[g] = down
    if total() > budget_bytes:
        raise ValueError(
            f"allocate_kv_formats: all-q4 cache needs {total():.0f} B, over "
            f"the {budget_bytes:.0f} B budget — shrink kv_len/batch or "
            "raise the budget")
    return fmt


def heuristic_bits(
    stats: Dict[str, dict],
    target_bits: float,
    n_layers: int,
    boost: float = 2.0,
) -> Dict[str, float]:
    """Paper fig. 30 baseline: +boost bits for the first two / last two
    transformer layers and the embedding / final-projection tensors."""
    def is_boosted(name: str) -> bool:
        if re.search(r"embed|lm_head|head|unembed", name):
            return True
        m = re.search(r"layers?[./\[](\d+)", name)
        if m:
            li = int(m.group(1))
            return li < 2 or li >= n_layers - 2
        return False

    names = list(stats)
    n = np.array([stats[t]["numel"] for t in names], dtype=np.float64)
    boosted = np.array([is_boosted(t) for t in names])
    total = n.sum()
    # base + boost·frac_boosted = target  =>  base = target - boost·frac
    frac = float((n * boosted).sum() / total)
    base = target_bits - boost * frac
    return {t: base + (boost if bo else 0.0) for t, bo in zip(names, boosted)}


def average_bits(alloc: Dict[str, float], stats: Dict[str, dict]) -> float:
    n = np.array([stats[t]["numel"] for t in alloc], dtype=np.float64)
    b = np.array([alloc[t] for t in alloc])
    return float((n * b).sum() / n.sum())
