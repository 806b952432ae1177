"""Sparse-outlier storage (§1, §2; SqueezeLLM/SpQR-style).

The top ``frac`` of parameters by |value| are removed from the dense payload
(set to 0 before quantisation) and stored separately in bfloat16 with int32
coordinates. Overhead = frac * (32 + 16) bits/param. Packed serving refuses
formats with outliers (``QuantisationPlan.packable``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

IDX_BITS = 32.0
VAL_BITS = 16.0


@dataclass(frozen=True)
class SparseOutliers:
    frac: float = 1e-3

    def bits_per_param(self) -> float:
        return self.frac * (IDX_BITS + VAL_BITS)

    def capacity(self, numel: int) -> int:
        """Static COO capacity for a tensor of ``numel`` elements."""
        return max(1, int(round(self.frac * numel)))

    def split(self, x: torch.Tensor):
        """Return (dense, mask): exactly ``capacity`` top-|x| elements are
        outliers (zeroed in dense)."""
        flat = x.reshape(-1)
        _, idx = torch.topk(flat.float().abs(), self.capacity(flat.numel()))
        mask = torch.zeros(flat.shape, dtype=torch.bool, device=x.device)
        mask[idx] = True
        mask = mask.reshape(x.shape)
        return torch.where(mask, torch.zeros_like(x), x), mask

    def merge(self, x_hat, x_orig, mask):
        """Splice bf16 outliers back into the dequantised dense tensor."""
        outliers = x_orig.to(torch.bfloat16).to(x_hat.dtype)
        return torch.where(mask, outliers, x_hat)


def extract_topk(x: torch.Tensor, k: int):
    """COO extraction of the k largest-|.| values."""
    flat = x.reshape(-1).float()
    _, idx = torch.topk(flat.abs(), k)
    return idx.to(torch.int32), flat[idx].to(torch.bfloat16)


def scatter_coo(x_hat: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor):
    flat = x_hat.reshape(-1).clone()
    flat[idx.long()] = vals.to(flat.dtype)
    return flat.reshape(x_hat.shape)
