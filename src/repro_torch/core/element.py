"""Element (scalar) quantisation formats.

An element format is a finite codebook ``Q ⊂ R`` with round-to-nearest
quantisation. Construction is host-side (numpy/scipy), identical to the
reference's ``repro/core/element.py``; ``quantise``/``dequantise`` are torch
and run on the tensor's device.

Builders implement the paper's formats:

  * ``cube_root_rms``      — §2.1 RMS-scaled ∛p quantiser (Table 4 D')
  * ``cube_root_absmax``   — §2.1 absmax-scaled ∛p with truncated-D' mixture
  * ``cube_root_signmax``  — §2.1 signmax: pinned {0, +1} codepoints
  * ``int_format``         — INTk, symmetric / asymmetric
  * ``fp_format``          — generic EeMm minifloat (E2M1, E3M0, ...)
  * ``nf4`` / ``sf4`` / ``af4`` — literature baselines
  * ``quantile_format``    — α=1 "proportional" rule (NF4-style), any D
  * ``power_rule_*``       — generalised p^α rule (fig. 22)
  * ``uniform_grid``       — entropy-constrained optimal (§2.3), for use with
                             lossless compression (``core/compress.py``)
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from . import distributions as dist
from .distributions import Distribution


def n_codes_for_bits(bits: float) -> int:
    return max(2, int(round(2.0**bits)))


@dataclass(frozen=True)
class ElementFormat:
    """A codebook format. ``codepoints`` sorted ascending, float32."""

    codepoints: tuple  # tuple of floats for hashability
    name: str = "codebook"
    # metadata describing how the codebook was built (for accounting/repr)
    meta: dict = field(default_factory=dict, compare=False)

    @property
    def n(self) -> int:
        return len(self.codepoints)

    @property
    def bits(self) -> float:
        return math.log2(self.n)

    def np_codepoints(self) -> np.ndarray:
        return np.asarray(self.codepoints, dtype=np.float32)

    def torch_codepoints(self, device=None) -> torch.Tensor:
        return torch.tensor(self.codepoints, dtype=torch.float32,
                            device=device)

    def midpoints(self, device=None) -> torch.Tensor:
        q = self.torch_codepoints(device)
        return (q[1:] + q[:-1]) * 0.5

    def quantise(self, x: torch.Tensor) -> torch.Tensor:
        """Round-to-nearest codepoint; returns integer codes. A value on a
        midpoint takes the lower code (``right=False``, the reference's
        ``side="left"``)."""
        mids = self.midpoints(x.device)
        codes = torch.searchsorted(mids, x.float().contiguous(), right=False,
                                   out_int32=True)
        return codes if self.n > 256 else codes.to(torch.uint8)

    def dequantise(self, codes: torch.Tensor) -> torch.Tensor:
        return self.torch_codepoints(codes.device)[codes.long()]

    def fake_quant(self, x: torch.Tensor) -> torch.Tensor:
        return self.dequantise(self.quantise(x))

    def rescaled(self, factor: float, name: Optional[str] = None) -> "ElementFormat":
        cps = tuple(float(c * factor) for c in self.codepoints)
        return ElementFormat(cps, name or self.name, dict(self.meta))

    def __repr__(self):
        return f"ElementFormat({self.name}, n={self.n}, bits={self.bits:.2f})"


def _fmt(cps: np.ndarray, name: str, **meta) -> ElementFormat:
    cps = np.sort(np.asarray(cps, dtype=np.float64))
    return ElementFormat(tuple(float(c) for c in cps), name, meta)


# ---------------------------------------------------------------------------
# Cube-root (and generalised p^alpha) quantisers
# ---------------------------------------------------------------------------

def power_rule_rms(d: Distribution, bits: float, alpha: float = 1.0 / 3.0,
                   symmetric: bool = True) -> ElementFormat:
    """Codepoints with density ∝ pdf(D)^alpha, for RMS-normalised data. The
    symmetric variant has no zero codepoint; the asymmetric one pins an
    exact 0 and drops the largest positive point."""
    n = n_codes_for_bits(bits)
    dp = d.unit_rms().power(alpha)
    if symmetric:
        p = np.linspace(0.0, 1.0, n + 2)[1:-1]
        q = dp.ppf(p)
    else:
        p = np.linspace(0.0, 1.0, (n + 1) + 2)[1:-1]
        q = dp.ppf(p)[:-1]  # odd grid has exact 0; drop the largest point
        q[np.argmin(np.abs(q))] = 0.0  # pin against fp error
    return _fmt(q, f"cbrt_{getattr(d, 'name', 'd')}{n}_rms",
                alpha=alpha, dist=d, scaling="rms", symmetric=symmetric)


def cube_root_rms(d: Distribution, bits: float, symmetric: bool = True) -> ElementFormat:
    return power_rule_rms(d, bits, 1.0 / 3.0, symmetric)


def _absmax_truncated_dp(d: Distribution, block_size: int, alpha: float) -> Distribution:
    """D' for absmax-normalised data: cube-root family scaled by 1/E[absmax],
    truncated to [-1, 1] (the non-maxima mixture component, §2.1)."""
    d1 = d.with_scale(1.0)
    e_max = d1.expected_absmax(block_size)
    dp = d1.power(alpha)  # scale s'
    return dp.with_scale(dp.scale / e_max).truncate(-1.0, 1.0)


def power_rule_absmax(d: Distribution, bits: float, block_size: int,
                      alpha: float = 1.0 / 3.0, symmetric: bool = True) -> ElementFormat:
    """Absmax-scaled p^alpha quantiser: ±1 always included (the block max),
    interior codepoints from the truncated D' inverse cdf (paper App. E.2)."""
    n = n_codes_for_bits(bits)
    trunc = _absmax_truncated_dp(d, block_size, alpha)
    if symmetric:
        p = np.linspace(0.0, 1.0, n)
        q = trunc.ppf(p)  # endpoints are exactly ±1
        q[0], q[-1] = -1.0, 1.0
    else:
        p = np.linspace(0.0, 1.0, n + 1)
        q = trunc.ppf(p)
        q[0], q[-1] = -1.0, 1.0
        q[np.argmin(np.abs(q))] = 0.0  # odd grid → exact 0 (pin)
        # drop the interior point adjacent to +1 to return to n codes
        q = np.delete(q, n - 1)
    return _fmt(q, f"cbrt_{getattr(d, 'name', 'd')}{n}_absmax",
                alpha=alpha, dist=d, scaling="absmax", block_size=block_size,
                symmetric=symmetric)


def cube_root_absmax(d: Distribution, bits: float, block_size: int,
                     symmetric: bool = True) -> ElementFormat:
    return power_rule_absmax(d, bits, block_size, 1.0 / 3.0, symmetric)


def cube_root_signmax(d: Distribution, bits: float, block_size: int,
                      alpha: float = 1.0 / 3.0) -> ElementFormat:
    """Signmax scaling (§2.1): scale = signed absmax, so the max is always at
    +1. Pin {0, +1}; distribute the remaining n-2 points via the truncated
    D' rule."""
    n = n_codes_for_bits(bits)
    trunc = _absmax_truncated_dp(d, block_size, alpha)
    p = np.linspace(0.0, 1.0, (n - 2) + 2)[1:-1]
    interior = trunc.ppf(p)
    q = np.concatenate([interior, [0.0, 1.0]])
    return _fmt(q, f"cbrt_{getattr(d, 'name', 'd')}{n}_signmax",
                alpha=alpha, dist=d, scaling="signmax", block_size=block_size)


def quantile_format(d: Distribution, bits: float, symmetric: bool = True) -> ElementFormat:
    """α=1 'proportional/quantile' rule (NF4-style construction), RMS-scaled."""
    return power_rule_rms(d, bits, alpha=1.0, symmetric=symmetric)


# ---------------------------------------------------------------------------
# Integer and minifloat formats
# ---------------------------------------------------------------------------

def int_format(bits: int, symmetric: bool = False) -> ElementFormat:
    """INTk. Asymmetric (default, has exact 0): {-2^(k-1) .. 2^(k-1)-1} / (2^(k-1)-1).
    Symmetric: odd multiples of 1/(2^k - 1), covering [-1, 1] w/o zero."""
    n = 2**bits
    if symmetric:
        q = (np.arange(n) - (n - 1) / 2.0) * (2.0 / (n - 1))
    else:
        q = np.arange(-(n // 2), n // 2) / (n // 2 - 1.0)
    return _fmt(q, f"int{bits}{'s' if symmetric else ''}", symmetric=symmetric)


def fp_format(e: int, m: int, finite_max: bool = True) -> ElementFormat:
    """Generic EeMm minifloat, no inf/nan, symmetric, +0/-0 collapse to one 0,
    normalised so the maximum finite magnitude is 1 (absmax-compatible)."""
    bias = 2 ** (e - 1) - 1 if e > 0 else 0
    mags = [0.0]
    for frac in range(1, 2**m):                      # subnormals
        mags.append(2.0 ** (1 - bias) * frac / 2.0**m)
    for ex in range(1, 2**e):                        # normals
        for frac in range(2**m):
            mags.append(2.0 ** (ex - bias) * (1.0 + frac / 2.0**m))
    mags = np.unique(np.asarray(mags))
    if finite_max:
        mags = mags / mags.max()
    q = np.concatenate([-mags[1:][::-1], mags])
    return _fmt(q, f"e{e}m{m}", e=e, m=m)


# ---------------------------------------------------------------------------
# Literature baselines
# ---------------------------------------------------------------------------

_NF4_TABLE = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
)


def nf4() -> ElementFormat:
    """NF4 (Dettmers et al., QLoRA) — exact published codebook."""
    return _fmt(np.asarray(_NF4_TABLE), "nf4")


def sf4(nu: float = 5.0) -> ElementFormat:
    """SF4 (Dotzel et al.) — Student-t quantile (equal-mass) 4-bit codebook:
    ±1 pinned, equal-probability bins, asymmetric with exact zero."""
    d = dist.StudentT(nu=nu, scale=1.0)
    neg = d.ppf(np.linspace(d.cdf(-1e9) + 1e-12, 0.5, 9)[:-1])
    pos = d.ppf(np.linspace(0.5, 1.0 - 1e-12, 9))
    neg[0] = d.ppf(0.5 / 16)
    pos[-1] = d.ppf(1 - 0.5 / 16)
    q = np.unique(np.concatenate([neg, [0.0], pos]))
    q = q / np.abs(q).max()
    return _fmt(q, f"sf4_nu{nu:g}", nu=nu)


def af4(block_size: int = 64) -> ElementFormat:
    """AF4 (Yoshida) — 'abnormal floats': absmax-aware codebook optimising
    absolute (L1) error → density ∝ sqrt(p) of the truncated Normal."""
    return power_rule_absmax(dist.Normal(), 4, block_size, alpha=0.5,
                             symmetric=False)


# ---------------------------------------------------------------------------
# Uniform grid (entropy-constrained optimum, §2.3)
# ---------------------------------------------------------------------------

def uniform_grid(delta: float, max_code: int = 2**15 - 1) -> "UniformGrid":
    return UniformGrid(delta=float(delta), max_code=max_code)


@dataclass(frozen=True)
class UniformGrid:
    """Uniform lattice {delta·k}; quantise = round(x/delta) (half to even,
    as ``jnp.round``). Unbounded codebook (clipped to ±max_code), meant to
    be followed by entropy coding (§2.3)."""

    delta: float
    max_code: int = 2**15 - 1
    name: str = "grid"

    @property
    def bits(self) -> float:  # nominal; true cost is the entropy
        return math.log2(2 * self.max_code + 1)

    def quantise(self, x: torch.Tensor) -> torch.Tensor:
        k = torch.round(x / self.delta)
        return torch.clamp(k, -self.max_code, self.max_code).to(torch.int32)

    def dequantise(self, codes: torch.Tensor) -> torch.Tensor:
        return codes.float() * self.delta

    def fake_quant(self, x: torch.Tensor) -> torch.Tensor:
        return self.dequantise(self.quantise(x))
