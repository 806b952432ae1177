"""Quantiser scale & shape search (§2.2, figs 23/35).

Moment matching is the zero-cost default; explicit search over a quantiser
scale multiplier n' (and Student-t ν) minimising R — optionally weighted by
per-parameter Fisher information — is more reliable (paper fig. 35). The
reference's ``repro/core/search.py``, with R computed by torch on the
tensor's device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np
import torch

from . import distributions as dist
from .tensor_format import TensorFormat

# paper Table 6 search ranges
SCALE_RANGE: Sequence[float] = tuple(2.0 ** np.linspace(-2, 2, 17))
NU_RANGE: Sequence[float] = tuple(
    2.0 ** np.linspace(math.log2(3), math.log2(100), 12))


def with_scale_mult(fmt: TensorFormat, mult: float) -> TensorFormat:
    """Scaling the quantiser by n' == rescaling its codepoints by n'."""
    return dataclasses.replace(fmt, element=fmt.element.rescaled(float(mult)))


def search_scale(
    x: torch.Tensor,
    fmt: TensorFormat,
    weights: torch.Tensor | None = None,
    mults: Sequence[float] = SCALE_RANGE,
):
    """Return (best format, best multiplier, best R)."""
    best = (None, 1.0, float("inf"))
    for m in mults:
        f = with_scale_mult(fmt, m)
        r = float(f.relative_rms_error(x, weights))
        if r < best[2]:
            best = (f, float(m), r)
    return best


def search_student_t(
    x: torch.Tensor,
    build: Callable[[dist.Distribution], TensorFormat],
    weights: torch.Tensor | None = None,
    nus: Sequence[float] = NU_RANGE,
    mults: Sequence[float] = SCALE_RANGE,
):
    """fig. 23 (right): for each ν, search the scale; return the best of all.
    ``build(d)`` constructs the TensorFormat for Student-t distribution d."""
    best = (None, None, 1.0, float("inf"))
    for nu in nus:
        fmt = build(dist.StudentT(nu=float(nu)))
        f, m, r = search_scale(x, fmt, weights, mults)
        if r < best[3]:
            best = (f, float(nu), m, r)
    return best
