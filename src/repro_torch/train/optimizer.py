"""Adam(W) from scratch, with optional **8-bit block-quantised moments**
built from the paper's own format machinery (block-absmax int8 with bf16
scales — Dettmers-style 8-bit optimizer states, reference [26] in the paper).
The reference's ``repro/train/optimizer.py`` in torch: the same formats, so
the same moment codes and scales from the same gradients.

States are nested dicts; ``adam_update`` returns new trees and leaves its
inputs untouched, so a failed step can be re-executed. The quantised path
dequantises → updates → requantises per step; block scales absorb the moment
magnitudes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.element import ElementFormat
from repro_torch.core.plan import flat_with_paths, map_with_paths
from repro_torch.core.registry import parse_format
from repro_torch.core.scaling import Scaling
from repro_torch.core.tensor_format import TensorFormat

# Moment block size. Blocks run along the LAST dim with leading dims kept
# ("block_rows"), as in the reference (its blocked layout shards like the
# parameter).
_MB = 128

# First-moment storage: block-absmax int8 (signed), bf16 scale → 8.13 b/el.
M_FORMAT = TensorFormat(
    element=parse_format("babsmax128:int8s").element,
    scaling=Scaling(granularity="block_rows", statistic="absmax",
                    block_size=_MB),
    name="brows128:int8s")
# Second moment is non-negative with huge dynamic range: store sqrt(v) on an
# unsigned 8-bit grid (what Adam consumes is sqrt(v), so the sqrt transform
# gives relative precision where it matters).
_V_ELEMENT = ElementFormat(tuple(float(x) for x in np.arange(256) / 255.0),
                           "uint8_grid")
V_FORMAT = TensorFormat(
    element=_V_ELEMENT,
    scaling=Scaling(granularity="block_rows", statistic="absmax",
                    block_size=_MB),
    name="brows128:sqrt-uint8")


@dataclass(frozen=True)
class AdamConfig:
    b1: float = 0.9
    b2: float = 0.95          # paper Table 6 QAT betas
    eps: float = 1e-8
    weight_decay: float = 0.0
    quantised_state: bool = False   # 8-bit m/v
    min_quant_numel: int = 65536    # small tensors stay f32


def _quantise_moment(x: torch.Tensor, do: bool, second: bool = False):
    if not do:
        return x
    if second:
        return V_FORMAT.quantise(torch.sqrt(torch.clamp(x, min=0.0)))
    return M_FORMAT.quantise(x)


def _dequantise_moment(q, do: bool, second: bool = False):
    if not do:
        return q
    if second:
        return torch.square(V_FORMAT.dequantise(q))
    return M_FORMAT.dequantise(q)


def _leaf_quantised(cfg: AdamConfig, x) -> bool:
    return (cfg.quantised_state and x.ndim >= 2
            and x.numel() >= cfg.min_quant_numel
            and x.shape[-1] % _MB == 0)   # odd last dims stay f32


def adam_init(params, cfg: AdamConfig):
    """Zero moments beside ``params`` (on each leaf's device), and step 0."""
    def zero_like(second):
        def f(_, x):
            z = torch.zeros(tuple(x.shape), dtype=torch.float32,
                            device=x.device)
            return _quantise_moment(z, _leaf_quantised(cfg, x), second)
        return f

    dev = flat_with_paths(params)[0][1].device
    return {
        "m": map_with_paths(zero_like(False), params),
        "v": map_with_paths(zero_like(True), params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def adam_update(grads, opt_state, params, lr, cfg: AdamConfig):
    """Returns (new_params, new_opt_state)."""
    step = opt_state["step"] + 1
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    m_flat = dict(flat_with_paths(opt_state["m"]))
    v_flat = dict(flat_with_paths(opt_state["v"]))
    p_flat = dict(flat_with_paths(params))
    new_m, new_v = {}, {}

    def upd(name, g):
        p = p_flat[name]
        quant = _leaf_quantised(cfg, p)
        g32 = g.float()
        m = _dequantise_moment(m_flat[name], quant)
        v = _dequantise_moment(v_flat[name], quant, second=True)
        m = b1 * m + (1 - b1) * g32
        v = b2 * v + (1 - b2) * torch.square(g32)
        mh = m / bc1
        vh = v / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.float()
        new_m[name] = _quantise_moment(m, quant)
        new_v[name] = _quantise_moment(v, quant, second=True)
        return (p.float() - lr * delta).to(p.dtype)

    with torch.no_grad():
        new_p = map_with_paths(upd, grads)
    return new_p, {"m": map_with_paths(lambda n, _: new_m[n], grads),
                   "v": map_with_paths(lambda n, _: new_v[n], grads),
                   "step": step}


# ---------------------------------------------------------------- schedules

def cosine_schedule(base_lr: float, total_steps: int, warmup: int = 0):
    """``lr_at(step)``: linear warmup then cosine decay to 0, in f32 on the
    step's device."""
    def lr_at(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp(step / max(warmup, 1), max=1.0) if warmup else 1.0
        frac = torch.clamp((step - warmup) / max(total_steps - warmup, 1),
                           0, 1)
        return base_lr * warm * 0.5 * (1 + torch.cos(math.pi * frac))
    return lr_at


def paper_qat_lr(element_bits: float) -> float:
    """Paper Table 6: η = 2^(-14 - b_elem)."""
    return 2.0 ** (-14.0 - element_bits)
