"""Linear scaling schemes (§2.1): tensor / channel / block granularity with
RMS / absmax / signmax statistics, plus quantised *scale formats*
(bfloat16 round-away, E8M0, E8Mx).

Torch on the tensor's device. Blocking flattens the tensor and groups the
trailing axis into blocks of B (padding with zeros as needed), exactly as
the reference's ``repro/core/scaling.py`` does, so codes and scales come out
bit-identical.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Scale formats
# ---------------------------------------------------------------------------


def _bf16_round_away(x: torch.Tensor) -> torch.Tensor:
    """Round positive values up (away from zero) to the next bfloat16.

    The next bf16 above ``y`` is its bit pattern plus one; scales are
    positive, so the sign bit is clear and the add is done on the int16
    view (torch has no uint16 arithmetic on every build)."""
    y = x.to(torch.bfloat16)
    yf = y.float()
    up = (y.view(torch.int16) + 1).view(torch.bfloat16)
    return torch.where(yf < x, up.float(), yf)


def _e8m0_round_away(x: torch.Tensor) -> torch.Tensor:
    """Round positive values up to the next power of two."""
    m, e = torch.frexp(x)  # x = m * 2^e, m in [0.5, 1)
    pow_ = torch.where(m <= 0.5, e - 1, e)
    return torch.where(x > 0, torch.exp2(pow_.float()), x)


def _e8mx_round_away(x: torch.Tensor, mantissa_bits: int) -> torch.Tensor:
    """Round positive values up at ``mantissa_bits`` of mantissa precision."""
    m, e = torch.frexp(x)  # m in [0.5, 1)
    q = 2.0 ** (mantissa_bits + 1)
    mq = torch.ceil(m * q) / q
    return torch.where(x > 0, mq * torch.exp2(e.float()), x)


def quantise_scale(x: torch.Tensor, fmt: str) -> torch.Tensor:
    """Quantise a (positive) scale tensor with round-away semantics
    (paper fig. 19: round-away avoids range clipping from a low scale)."""
    if fmt == "exact":
        return x
    if fmt == "bf16":
        return _bf16_round_away(x)
    if fmt == "e8m0":
        return _e8m0_round_away(x)
    if fmt.startswith("e8m"):
        return _e8mx_round_away(x, int(fmt[3:]))
    raise ValueError(f"unknown scale format {fmt!r}")


def scale_format_bits(fmt: str, signed: bool = False) -> float:
    """Storage bits for one scale value. Signmax needs a sign bit on formats
    that don't already carry one (§2.1)."""
    if fmt == "exact":
        base, has_sign = 32.0, True
    elif fmt == "bf16":
        base, has_sign = 16.0, True
    elif fmt == "e8m0":
        base, has_sign = 8.0, False
    elif fmt.startswith("e8m"):
        base, has_sign = 8.0 + int(fmt[3:]), False
    else:
        raise ValueError(f"unknown scale format {fmt!r}")
    return base + (1.0 if signed and not has_sign else 0.0)


# ---------------------------------------------------------------------------
# Scaling schemes
# ---------------------------------------------------------------------------

GRANULARITIES = ("tensor", "channel", "block", "block_rows", "none")
STATISTICS = ("rms", "absmax", "signmax")


@dataclass(frozen=True)
class Scaling:
    granularity: str = "block"     # "tensor" | "channel" | "block" | "none"
    statistic: str = "absmax"      # "rms" | "absmax" | "signmax"
    block_size: int = 128
    scale_format: str = "bf16"

    def __post_init__(self):
        if self.granularity not in GRANULARITIES:
            raise ValueError(f"unknown granularity {self.granularity!r}")
        if self.statistic not in STATISTICS:
            raise ValueError(f"unknown statistic {self.statistic!r}")
        if self.statistic == "signmax" and self.granularity == "none":
            raise ValueError("signmax requires a scale")

    def blocked_view(self, x: torch.Tensor):
        """Return (xb, unblock) where xb has the reduction axis last."""
        if self.granularity == "none":
            return x, lambda y: y
        if self.granularity == "tensor":
            return x.reshape(-1), lambda y: y.reshape(x.shape)
        if self.granularity == "channel":
            return x, lambda y: y
        b = self.block_size
        if self.granularity == "block_rows":
            if x.shape[-1] % b:
                raise ValueError(f"block_rows: last dim {x.shape[-1]} does "
                                 f"not tile by {b}")
            xb = x.reshape(*x.shape[:-1], x.shape[-1] // b, b)
            return xb, lambda y: y.reshape(x.shape)
        # block: flat blocks over the whole tensor, zero-padded at the end
        flat = x.reshape(-1)
        pad = (-flat.shape[0]) % b
        if pad:
            flat = torch.nn.functional.pad(flat, (0, pad))
        xb = flat.reshape(-1, b)
        numel = x.numel()

        def unblock(y):
            out = y.reshape(-1)
            if pad:
                out = out[:numel]
            return out.reshape(x.shape)

        return xb, unblock

    def raw_scale(self, xb: torch.Tensor) -> torch.Tensor:
        if self.granularity == "none":
            return torch.ones((), dtype=torch.float32, device=xb.device)
        x32 = xb.float()
        if self.granularity == "tensor":
            if self.statistic == "rms":
                return torch.sqrt(torch.mean(torch.square(x32)))
            if self.statistic == "absmax":
                return torch.max(torch.abs(x32))
            return x32.reshape(-1)[torch.argmax(torch.abs(x32))]
        if self.statistic == "rms":
            return torch.sqrt(torch.mean(torch.square(x32), dim=-1,
                                         keepdim=True))
        if self.statistic == "absmax":
            # max|x| = max(max x, -min x), without a full-size |x| temporary
            lo, hi = torch.aminmax(x32, dim=-1, keepdim=True)
            return torch.maximum(hi, -lo)
        # signmax: the signed value of the max-|.| element (first on ties)
        idx = torch.argmax(torch.abs(x32), dim=-1, keepdim=True)
        return torch.gather(x32, -1, idx)

    def quantised_scale(self, xb: torch.Tensor) -> torch.Tensor:
        n = self.raw_scale(xb)
        if self.statistic == "signmax":
            mag = quantise_scale(torch.abs(n), self.scale_format)
            return torch.where(n < 0, -mag, mag)
        return quantise_scale(n, self.scale_format)

    def normalise(self, x: torch.Tensor):
        """Return (normalised blocked data, scales, unblock fn)."""
        xb, unblock = self.blocked_view(x)
        scales = self.quantised_scale(xb)
        safe = torch.where(scales == 0, torch.ones_like(scales), scales)
        return xb / safe, scales, unblock

    def n_scales(self, shape) -> int:
        numel = int(np.prod(shape))
        if self.granularity == "none":
            return 0
        if self.granularity == "tensor":
            return 1
        if self.granularity == "channel":
            return int(numel // shape[-1]) if len(shape) else 1
        if self.granularity == "block_rows":
            return numel // self.block_size
        return math.ceil(numel / self.block_size)

    def scale_bits_per_param(self, shape) -> float:
        numel = int(np.prod(shape))
        if numel == 0 or self.granularity == "none":
            return 0.0
        bits = scale_format_bits(self.scale_format,
                                 signed=self.statistic == "signmax")
        return bits * self.n_scales(shape) / numel

    def describe(self) -> str:
        g = {"tensor": "t", "channel": "c", "block": f"b{self.block_size}",
             "none": ""}[self.granularity]
        return f"{g}{self.statistic}~{self.scale_format}"
