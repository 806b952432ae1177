"""Evaluation metrics (§4, §D): top-k KL divergence, ρ = KL·2^{2b}, R.

Torch on the logits' device; the reference's ``repro/core/metrics.py``
with the same arithmetic (f32 log-softmax, top-k taken from the reference
model, the rest folded into one tail class)."""
from __future__ import annotations

import math

import torch

_EPS = 1e-30


def topk_kl(ref_logits: torch.Tensor, test_logits: torch.Tensor,
            k: int = 128) -> torch.Tensor:
    """Top-k KL divergence per position (§D). The top-k indices always come
    from the *reference* model; non-top-k classes collapse into one tail
    class so the result is a true KL over k+1 classes (>= 0)."""
    logp = torch.log_softmax(ref_logits.float(), dim=-1)
    logq = torch.log_softmax(test_logits.float(), dim=-1)
    top_logp, idx = torch.topk(logp, k, dim=-1)
    top_logq = torch.gather(logq, -1, idx)
    p_top = torch.exp(top_logp)
    kl_top = torch.sum(p_top * (top_logp - top_logq), dim=-1)
    p_tail = torch.clamp(1.0 - torch.sum(p_top, dim=-1), _EPS, 1.0)
    q_tail = torch.clamp(1.0 - torch.sum(torch.exp(top_logq), dim=-1), _EPS,
                         1.0)
    return kl_top + p_tail * (torch.log(p_tail) - torch.log(q_tail))


def mean_topk_kl(ref_logits, test_logits, k: int = 128,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    kl = topk_kl(ref_logits, test_logits, k)
    if mask is None:
        return torch.mean(kl)
    m = mask.to(kl.dtype)
    return torch.sum(kl * m) / torch.clamp(torch.sum(m), min=1.0)


def rho(kl: float, bits: float) -> float:
    """Scaled KL divergence ρ := D_KL · 2^{2b} (fig. 8), flattening the
    Zador-limit 2^{-2b} error scaling."""
    return float(kl) * 2.0 ** (2.0 * float(bits))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return -torch.mean(ll)


def snr_db(r: float) -> float:
    """SNR = 1/R^2 in dB (Table 3)."""
    return -20.0 * math.log10(max(float(r), 1e-30))
