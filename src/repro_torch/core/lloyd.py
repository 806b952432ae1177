"""Lloyd-Max (1-D k-means) quantiser design (§2.2), optionally weighted by
per-parameter Fisher information (SqueezeLLM-style).

Host-side numpy, carried over unchanged from the reference's
``repro/core/lloyd.py`` (the same ``default_rng(seed)`` draws, so the same
codebooks), following the paper's §D settings:
k-means++ init for RMS-scaled data, uniform(-1, 1) init for absmax-scaled
data, iterate until the fraction of changed assignments < 1e-4.
"""
from __future__ import annotations

import numpy as np

from .element import ElementFormat, _fmt


def _kmeanspp_init(x: np.ndarray, k: int, w: np.ndarray,
                   rng: np.random.Generator) -> np.ndarray:
    centers = np.empty(k, dtype=np.float64)
    centers[0] = x[rng.integers(len(x))]
    d2 = (x - centers[0]) ** 2
    for i in range(1, k):
        p = w * d2
        s = p.sum()
        if s <= 0:
            centers[i:] = rng.choice(x, size=k - i)
            break
        centers[i] = x[rng.choice(len(x), p=p / s)]
        d2 = np.minimum(d2, (x - centers[i]) ** 2)
    return np.sort(centers)


def lloyd_max(
    x: np.ndarray,
    bits: float,
    weights: np.ndarray | None = None,
    init: str = "kmeans++",
    tol: float = 1e-4,
    max_iter: int = 200,
    seed: int = 0,
    max_samples: int = 1 << 20,
) -> ElementFormat:
    """Design a codebook minimising sum w_i (x_i - q(x_i))^2."""
    from .element import n_codes_for_bits

    rng = np.random.default_rng(seed)
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    w = (np.ones_like(x) if weights is None
         else np.asarray(weights, dtype=np.float64).reshape(-1))
    if len(x) > max_samples:
        sel = rng.choice(len(x), size=max_samples, replace=False)
        x, w = x[sel], w[sel]
    k = n_codes_for_bits(bits)
    if init == "kmeans++":
        centers = _kmeanspp_init(x, k, w, rng)
    elif init == "uniform":
        centers = np.linspace(-1.0, 1.0, k)
    else:
        raise ValueError(f"unknown init {init!r}")

    order = np.argsort(x)
    xs, ws = x[order], w[order]
    wx = ws * xs
    cw = np.concatenate([[0.0], np.cumsum(ws)])
    cwx = np.concatenate([[0.0], np.cumsum(wx)])
    prev = None
    for _ in range(max_iter):
        mids = (centers[1:] + centers[:-1]) / 2
        assign = np.searchsorted(mids, xs)
        if prev is not None and np.mean(assign != prev) < tol:
            break
        prev = assign
        # centroid update via cumulative sums over the sorted data
        bounds = np.searchsorted(assign, np.arange(k + 1))
        wsum = cw[bounds[1:]] - cw[bounds[:-1]]
        wxsum = cwx[bounds[1:]] - cwx[bounds[:-1]]
        nonempty = wsum > 0
        centers[nonempty] = wxsum[nonempty] / wsum[nonempty]
        # re-seed empty clusters at the largest-error point
        if not nonempty.all():
            q = centers[np.clip(assign, 0, k - 1)]
            err = ws * (xs - q) ** 2
            for j in np.flatnonzero(~nonempty):
                centers[j] = xs[np.argmax(err)]
                err[np.argmax(err)] = 0
            centers = np.sort(centers)
    return _fmt(centers, f"lloyd{k}", init=init)
