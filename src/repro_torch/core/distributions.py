"""Distribution families used by the paper's optimal-format machinery.

Implements Normal, Laplace and Student-t with the Table-4 statistics:

  * ``rms()``                 — sqrt(E[x^2])
  * ``expected_absmax(B)``    — E[max_i |x_i|] over a block of B iid samples
  * ``power(alpha)``          — the distribution whose pdf is proportional to
                                ``pdf**alpha`` (same family, new params);
                                ``alpha=1/3`` is the paper's cube-root rule
  * ``cube_root()``           — ``power(1/3)`` (Table 4 D')
  * ``truncate(lo, hi)``      — truncated distribution (for absmax scaling)

Codebook construction happens once, on the host, so this uses scipy for
pdf/cdf/ppf. Everything downstream (quantise/dequantise) is torch. A copy of
the reference's ``repro/core/distributions.py``, kept so the port never
imports the reference package.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import scipy.stats as _st

EULER_GAMMA = 0.5772156649015329


@dataclass(frozen=True)
class Distribution:
    """Base class for a location-0 scale-family distribution."""

    scale: float = 1.0

    # -- scipy frozen dist ---------------------------------------------------
    def _frozen(self):
        raise NotImplementedError

    def pdf(self, x):
        return self._frozen().pdf(x)

    def cdf(self, x):
        return self._frozen().cdf(x)

    def ppf(self, q):
        return self._frozen().ppf(q)

    # -- Table 4 -------------------------------------------------------------
    def rms(self) -> float:
        raise NotImplementedError

    def expected_absmax(self, block_size: int) -> float:
        raise NotImplementedError

    def power(self, alpha: float) -> "Distribution":
        """Distribution with pdf proportional to ``self.pdf ** alpha``."""
        raise NotImplementedError

    def cube_root(self) -> "Distribution":
        return self.power(1.0 / 3.0)

    # -- helpers ---------------------------------------------------------------
    def with_scale(self, scale: float) -> "Distribution":
        return dataclasses.replace(self, scale=float(scale))

    def scaled_by(self, factor: float) -> "Distribution":
        return self.with_scale(self.scale * float(factor))

    def unit_rms(self) -> "Distribution":
        """Rescale so that RMS == 1 (moment matching for RMS scaling)."""
        return self.scaled_by(1.0 / self.rms())

    def truncate(self, lo: float, hi: float) -> "Truncated":
        return Truncated(base=self, lo=float(lo), hi=float(hi))


@dataclass(frozen=True)
class Normal(Distribution):
    name = "normal"

    def _frozen(self):
        return _st.norm(scale=self.scale)

    def rms(self) -> float:
        return self.scale

    def expected_absmax(self, block_size: int) -> float:
        # Table 4: sqrt(2 log(B / pi)) * s  (extreme value theory)
        return math.sqrt(2.0 * math.log(block_size / math.pi)) * self.scale

    def power(self, alpha: float) -> "Normal":
        # exp(-x^2/(2 s^2))^alpha = exp(-x^2 / (2 (s/sqrt(alpha))^2))
        return Normal(scale=self.scale / math.sqrt(alpha))


@dataclass(frozen=True)
class Laplace(Distribution):
    name = "laplace"

    def _frozen(self):
        return _st.laplace(scale=self.scale)

    def rms(self) -> float:
        return math.sqrt(2.0) * self.scale

    def expected_absmax(self, block_size: int) -> float:
        # Table 4: (gamma + log B) * s
        return (EULER_GAMMA + math.log(block_size)) * self.scale

    def power(self, alpha: float) -> "Laplace":
        return Laplace(scale=self.scale / alpha)


@dataclass(frozen=True)
class StudentT(Distribution):
    nu: float = 7.0
    name = "student_t"

    def _frozen(self):
        return _st.t(self.nu, scale=self.scale)

    def rms(self) -> float:
        if self.nu <= 2:
            raise ValueError("Student-t RMS undefined for nu <= 2")
        return math.sqrt(self.nu / (self.nu - 2.0)) * self.scale

    def expected_absmax(self, block_size: int) -> float:
        # Table 4 (empirical approximation):
        #   (2 log(B/pi))^((nu-3)/(2 nu)) * B^(1/nu) * sqrt(nu/(nu-2)) * s
        b = float(block_size)
        return (
            (2.0 * math.log(b / math.pi)) ** ((self.nu - 3.0) / (2.0 * self.nu))
            * b ** (1.0 / self.nu)
            * math.sqrt(self.nu / (self.nu - 2.0))
            * self.scale
        )

    def power(self, alpha: float) -> "StudentT":
        # (1 + x^2/(s^2 nu))^(-(nu+1)/2 * alpha) = (1 + x^2/(s'^2 nu'))^(-(nu'+1)/2)
        # => nu' = alpha (nu + 1) - 1 ;  s'^2 nu' = s^2 nu.
        nu_p = alpha * (self.nu + 1.0) - 1.0
        if nu_p <= 0:
            raise ValueError(f"power({alpha}) of Student-t(nu={self.nu}) invalid")
        return StudentT(scale=self.scale * math.sqrt(self.nu / nu_p), nu=nu_p)


@dataclass(frozen=True)
class Truncated(Distribution):
    """``base`` truncated to [lo, hi] (cdf-remapped, as in the paper's code)."""

    base: Distribution = None
    lo: float = -1.0
    hi: float = 1.0

    def _cbounds(self):
        return self.base.cdf(self.lo), self.base.cdf(self.hi)

    def pdf(self, x):
        c0, c1 = self._cbounds()
        inside = (np.asarray(x) >= self.lo) & (np.asarray(x) <= self.hi)
        return np.where(inside, self.base.pdf(x) / (c1 - c0), 0.0)

    def cdf(self, x):
        c0, c1 = self._cbounds()
        return np.clip((self.base.cdf(x) - c0) / (c1 - c0), 0.0, 1.0)

    def ppf(self, q):
        c0, c1 = self._cbounds()
        return self.base.ppf(c0 + (c1 - c0) * np.asarray(q))

    def rms(self) -> float:  # numeric; rarely needed
        xs = np.linspace(self.lo, self.hi, 20001)
        p = self.pdf(xs)
        return float(np.sqrt(np.trapezoid(xs**2 * p, xs)))
