"""Lossless-compression layer (§2.3): entropy models, Shannon-limit bit
accounting, and a practical Huffman codec (host-side) that approaches it.
Numpy and pure Python, carried over from the reference's
``repro/core/compress.py``: histograms, entropies, Huffman code lengths,
canonical codes and the encoded bytes are the same (the encoder's
accumulator is trimmed as it writes, so its time is linear in the stream).

The paper's result: under an *entropy* constraint the RMS-optimal quantiser
is a uniform grid, and per-element Huffman coding comes within a few % of the
Shannon limit (figs 8, 24).
"""
from __future__ import annotations

import heapq
import math
from collections import Counter
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Entropy accounting (Shannon limit)
# ---------------------------------------------------------------------------

def code_histogram(codes, n_codes: int | None = None) -> np.ndarray:
    codes = np.asarray(codes).reshape(-1)
    if n_codes is None:
        lo, hi = int(codes.min()), int(codes.max())
        codes = codes - lo
        n_codes = hi - lo + 1
    return np.bincount(codes.astype(np.int64), minlength=n_codes)


def entropy_bits(hist: np.ndarray, smoothing: float = 0.0) -> float:
    """Shannon entropy (bits/symbol) of a histogram. ``smoothing`` adds
    +smoothing to every non-empty-support bucket (paper §C: +1 smoothing
    within the training sample range)."""
    h = np.asarray(hist, dtype=np.float64)
    if smoothing:
        support = np.arange(len(h))
        lo, hi = support[h > 0][0], support[h > 0][-1]
        h = h.copy()
        h[lo : hi + 1] += smoothing
    p = h / h.sum()
    nz = p[p > 0]
    return float(-(nz * np.log2(nz)).sum())


def cross_entropy_bits(hist_data: np.ndarray, hist_model: np.ndarray,
                       smoothing: float = 1.0) -> float:
    """Bits/symbol for coding ``hist_data`` with a model fit on
    ``hist_model`` (sampling-based p^Q, §C)."""
    n = max(len(hist_data), len(hist_model))
    d = np.zeros(n); d[: len(hist_data)] = hist_data
    m = np.zeros(n); m[: len(hist_model)] = hist_model
    nz = m > 0
    lo, hi = np.argmax(nz), n - 1 - np.argmax(nz[::-1])
    m[lo : hi + 1] += smoothing
    # symbols outside the model support get an escape cost: log2(total)
    q = m / m.sum()
    pd = d / d.sum()
    esc = math.log2(max(2.0, m.sum()))
    bits = np.where(q > 0, -np.log2(np.where(q > 0, q, 1.0)), esc)
    return float((pd * bits).sum())


# ---------------------------------------------------------------------------
# Huffman codec (practical compressor, fig. 24)
# ---------------------------------------------------------------------------

@dataclass
class HuffmanCode:
    lengths: Dict[int, int]
    codes: Dict[int, Tuple[int, int]]  # symbol -> (bits-value, length)

    def mean_bits(self, hist: np.ndarray) -> float:
        total = hist.sum()
        return float(sum(hist[s] * l for s, l in self.lengths.items()) / total)

    def encode(self, symbols: np.ndarray) -> Tuple[bytes, int]:
        """Encode to a bytestring; returns (payload, n_bits). The reference's
        bytes; the accumulator keeps only the bits not yet written (the
        reference's grows with the stream, so its encode is quadratic)."""
        acc = bytearray()
        cur, nbits = 0, 0
        for s in np.asarray(symbols).reshape(-1).tolist():
            v, l = self.codes[int(s)]
            cur = (cur << l) | v
            nbits += l
            while nbits >= 8:
                nbits -= 8
                acc.append((cur >> nbits) & 0xFF)
            cur &= (1 << nbits) - 1
        total_bits = len(acc) * 8 + nbits
        if nbits:
            acc.append((cur << (8 - nbits)) & 0xFF)
        return bytes(acc), total_bits

    def decode(self, payload: bytes, n_symbols: int) -> np.ndarray:
        # build prefix tree
        tree: dict = {}
        for s, (v, l) in self.codes.items():
            node = tree
            for i in range(l - 1, -1, -1):
                b = (v >> i) & 1
                if i == 0:
                    node[b] = s
                else:
                    node = node.setdefault(b, {})
        out = np.empty(n_symbols, dtype=np.int64)
        node, j = tree, 0
        for byte in payload:
            for i in range(7, -1, -1):
                if j >= n_symbols:
                    break
                nxt = node[(byte >> i) & 1]
                if isinstance(nxt, dict):
                    node = nxt
                else:
                    out[j] = nxt
                    j += 1
                    node = tree
        return out


def build_huffman(hist: np.ndarray) -> HuffmanCode:
    """Standard heap-based Huffman over non-zero-frequency symbols."""
    items = [(int(c), i) for i, c in enumerate(hist) if c > 0]
    if len(items) == 1:
        s = items[0][1]
        return HuffmanCode({s: 1}, {s: (0, 1)})
    heap = [(c, i, ("leaf", s)) for i, (c, s) in enumerate(items)]
    heapq.heapify(heap)
    uid = len(heap)
    while len(heap) > 1:
        c1, _, n1 = heapq.heappop(heap)
        c2, _, n2 = heapq.heappop(heap)
        heapq.heappush(heap, (c1 + c2, uid, ("node", n1, n2)))
        uid += 1
    lengths: Dict[int, int] = {}

    def walk(node, depth):
        if node[0] == "leaf":
            lengths[node[1]] = max(1, depth)
        else:
            walk(node[1], depth + 1)
            walk(node[2], depth + 1)

    walk(heap[0][2], 0)
    # canonical codes
    codes: Dict[int, Tuple[int, int]] = {}
    cur, prev_len = 0, 0
    for s, l in sorted(lengths.items(), key=lambda kv: (kv[1], kv[0])):
        cur <<= l - prev_len
        codes[s] = (cur, l)
        cur += 1
        prev_len = l
    return HuffmanCode(lengths, codes)


def huffman_bits_per_symbol(codes: np.ndarray, n_codes: int | None = None) -> float:
    hist = code_histogram(codes, n_codes)
    return build_huffman(hist).mean_bits(hist)


# ---------------------------------------------------------------------------
# Grid-resolution search: hit a target entropy (bits/param) with a uniform grid
# ---------------------------------------------------------------------------

def fit_grid_delta(x: np.ndarray, target_bits: float, iters: int = 40,
                   smoothing: float = 1.0) -> float:
    """Binary-search the lattice resolution delta so that the Shannon entropy
    of round(x/delta) is ``target_bits`` (§2.3 recipe)."""
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    rms = math.sqrt(float(np.mean(x * x))) or 1.0
    lo, hi = rms * 2.0**-24, rms * 16.0

    def ent(delta):
        k = np.round(x / delta).astype(np.int64)
        return entropy_bits(np.bincount(k - k.min()), smoothing=smoothing)

    for _ in range(iters):
        mid = math.sqrt(lo * hi)
        if ent(mid) > target_bits:
            lo = mid  # too fine -> more entropy -> increase delta
        else:
            hi = mid
    return math.sqrt(lo * hi)
