"""Format registry: spec strings → TensorFormat (the reference's grammar).

Grammar (CLI/config surface of the framework):

    <scaling>:<element>[:sp<frac>][:C]

scaling   ::=  none | t<stat> | c<stat> | b<stat><B>        [~<scalefmt>]
stat      ::=  rms | absmax | signmax
scalefmt  ::=  bf16 (default) | e8m0 | e8m<x> | exact
element   ::=  n<bits>[a] | l<bits>[a] | t<bits>[a][nu<ν>]   (∛p Normal/Laplace/Student-t,
                                                              'a' = asymmetric)
             | int<bits>[s] | e<E>m<M> | nf4 | sf4 | af4
             | q<bits> (quantile/α=1 Normal) | grid (uniform lattice, needs :C)
             | lloyd<bits> (data-fitted at plan time)
sp<frac>  ::=  sparse outliers, e.g. sp0.001
C         ::=  lossless compression (entropy-coded elements)

Examples:  "babsmax128:t4"       block-128 absmax, ∛p Student-t 4-bit
           "trms:n4:sp0.001"     tensor RMS, ∛p Normal, 0.1% outliers
           "trms:grid:C"         uniform grid + compression (§2.3 optimum)
"""
from __future__ import annotations

import re
from typing import Optional

from . import distributions as dist
from . import element as el
from .scaling import Scaling
from .sparse import SparseOutliers
from .tensor_format import TensorFormat

_SCALING_RE = re.compile(
    r"^(?:(none)|(t|c|b)(rms|absmax|signmax)(\d+)?)(?:~(\S+))?$")
_ELEMENT_RE = re.compile(r"^([nlt])(\d+(?:\.\d+)?)(a?)(?:nu(\d+(?:\.\d+)?))?$")


def parse_scaling(tok: str) -> Scaling:
    m = _SCALING_RE.match(tok)
    if not m:
        raise ValueError(f"bad scaling spec {tok!r}")
    none, gran, stat, bs, sfmt = m.groups()
    sfmt = sfmt or "bf16"
    if none:
        return Scaling(granularity="none", statistic="rms", scale_format=sfmt)
    g = {"t": "tensor", "c": "channel", "b": "block"}[gran]
    if g == "block" and not bs:
        bs = "128"
    return Scaling(granularity=g, statistic=stat,
                   block_size=int(bs) if bs else 128, scale_format=sfmt)


_DISTS = {"n": dist.Normal(), "l": dist.Laplace()}


def parse_element(tok: str, scaling: Scaling, default_nu: float = 7.0):
    """Element construction depends on the scaling statistic: RMS-matched vs
    absmax-truncated vs signmax-pinned codebooks (§2.1)."""
    tok = tok.strip()
    if tok == "grid":
        return el.uniform_grid(1.0)  # resolution fit at plan time
    if tok == "nf4":
        return el.nf4()
    if tok == "sf4":
        return el.sf4()
    if tok == "af4":
        return el.af4(scaling.block_size if scaling.granularity == "block" else 64)
    m = re.match(r"^int(\d+)(s?)$", tok)
    if m:
        return el.int_format(int(m.group(1)), symmetric=bool(m.group(2)))
    m = re.match(r"^e(\d)m(\d)$", tok)
    if m:
        return el.fp_format(int(m.group(1)), int(m.group(2)))
    m = re.match(r"^q(\d+(?:\.\d+)?)$", tok)
    if m:
        return el.quantile_format(dist.Normal(), float(m.group(1)))
    m = re.match(r"^lloyd(\d+(?:\.\d+)?)$", tok)
    if m:
        # placeholder codebook; refitted to data at plan time (core.plan)
        return el.cube_root_rms(dist.Normal(), float(m.group(1)))
    m = _ELEMENT_RE.match(tok)
    if not m:
        raise ValueError(f"bad element spec {tok!r}")
    d_key, bits, asym, nu = m.groups()
    d = dist.StudentT(nu=float(nu) if nu else default_nu) if d_key == "t" \
        else _DISTS[d_key]
    bits = float(bits)
    symmetric = not asym
    if scaling.statistic == "absmax" and scaling.granularity != "none":
        b = scaling.block_size if scaling.granularity == "block" else 4096
        return el.cube_root_absmax(d, bits, b, symmetric=symmetric)
    if scaling.statistic == "signmax":
        b = scaling.block_size if scaling.granularity == "block" else 4096
        return el.cube_root_signmax(d, bits, b)
    return el.cube_root_rms(d, bits, symmetric=symmetric)


def parse_format(spec: str) -> TensorFormat:
    parts = spec.split(":")
    if len(parts) < 2:
        raise ValueError(f"format spec needs <scaling>:<element>, got {spec!r}")
    scaling = parse_scaling(parts[0])
    element = parse_element(parts[1], scaling)
    sparse: Optional[SparseOutliers] = None
    compressed = False
    for extra in parts[2:]:
        if extra == "C":
            compressed = True
        elif extra.startswith("sp"):
            sparse = SparseOutliers(frac=float(extra[2:]))
        else:
            raise ValueError(f"unknown format modifier {extra!r}")
    return TensorFormat(element=element, scaling=scaling, sparse=sparse,
                        compressed=compressed, name=spec)


# Headline formats (fig. 1 / Table 1)
HEADLINE_FORMATS = (
    "trms:t4:C",            # Tensor RMS + Compression
    "trms:t4:sp0.001",      # Tensor RMS + Sparse outliers
    "cabsmax:t4",           # Channel Absmax
    "babsmax128:t4",        # Block Absmax
    "tabsmax:t4",           # Tensor Absmax
    "trms:t4",              # Tensor RMS (fixed-length baseline)
)
