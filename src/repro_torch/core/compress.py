"""Lossless-compression layer (§2.3): entropy models, Shannon-limit bit
accounting, and a practical Huffman codec (host-side) that approaches it.
Numpy and pure Python, carried over from the reference's
``repro/core/compress.py``: histograms, entropies, Huffman code lengths,
canonical codes, the encoded bytes and the decoded symbols are the same
(the encoder is numpy; the decoder reads codes through a table, chaining
only the symbols' positions in Python: both are linear in the stream, where
the reference's encoder is quadratic).

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

_TABLE_BITS = 20          # decode: codes up to this long take one lookup
_CHUNK_BITS = 1 << 20     # decode: stream bits read per numpy pass


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
        """Encode to a bytestring; returns (payload, n_bits): the
        reference's bytes (codes MSB first, the last byte zero-padded),
        built with numpy: each code lands in the one or two big-endian
        64-bit words its bit offset spans (codes never overlap, so a word
        is the sum of its parts)."""
        sym = np.asarray(symbols).reshape(-1).astype(np.int64)
        top = max(self.codes) + 1
        val = np.zeros(top, np.uint64)
        length = np.zeros(top, np.int64)
        for s, (v, l) in self.codes.items():
            val[s], length[s] = v, l
        known = (sym >= 0) & (sym < top)
        known[known] = length[sym[known]] > 0
        if not known.all():
            raise KeyError(int(sym[~known][0]))
        lens, vals = length[sym], val[sym]
        total = int(lens.sum())
        start = np.cumsum(lens) - lens
        word, end = start >> 6, (start & 63) + lens    # end <= 64 + len
        spill = end > 64
        head = np.where(spill, vals >> np.where(spill, end - 64, 0)
                        .astype(np.uint64),
                        vals << np.where(spill, 0, 64 - end)
                        .astype(np.uint64))
        words = np.zeros((total + 63) // 64 + 1, np.uint64)
        if sym.size:
            first = np.flatnonzero(np.diff(word, prepend=-1))
            words[word[first]] = np.add.reduceat(head, first)
            tail = vals[spill] << (128 - end[spill]).astype(np.uint64)
            words[word[spill] + 1] += tail
        return words.astype(">u8").tobytes()[:(total + 7) // 8], total

    def decode(self, payload: bytes, n_symbols: int) -> np.ndarray:
        """The reference's symbols. numpy reads the code starting at every
        bit position of a chunk of the stream through a table of
        ``_TABLE_BITS``-bit prefixes; the host chains the symbols' positions
        and resolves the rare longer codes bit by bit."""
        maxlen = max(l for _, l in self.codes.values())
        K = min(maxlen, _TABLE_BITS)
        tsym = np.zeros(1 << K, np.int64)
        tlen = np.zeros(1 << K, np.int64)      # 0: a code longer than K
        long_codes = {}
        for s, (v, l) in self.codes.items():
            if l <= K:
                lo = v << (K - l)
                tsym[lo:lo + (1 << (K - l))] = s
                tlen[lo:lo + (1 << (K - l))] = l
            else:
                long_codes[(v, l)] = s
        data = bytes(payload) + bytes(8)

        def long_code(pos):
            """(symbol, length) of the code longer than K at bit pos."""
            w = int.from_bytes(data[pos >> 3:(pos >> 3) + 8], "big")
            w = (w >> (64 - (pos & 7) - maxlen)) & ((1 << maxlen) - 1)
            for l in range(K + 1, maxlen + 1):
                s = long_codes.get((w >> (maxlen - l), l))
                if s is not None:
                    return s, l
            raise KeyError(f"no code at bit {pos}")

        # the 32 stream bits from each byte on: the K bits from bit position
        # i are (w32[i >> 3] << (i & 7)) >> (32 - K)
        b = np.frombuffer(data, np.uint8).astype(np.uint64)
        w32 = (b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]
        n_bits = 8 * len(payload)
        out, done, p = [], 0, 0
        while done < n_symbols and p < n_bits:
            i = np.arange(p, min(p + _CHUNK_BITS, n_bits), dtype=np.uint64)
            win = (((w32[i >> 3] << (i & 7)) & 0xFFFFFFFF)
                   >> np.uint64(32 - K)).astype(np.int64)
            step = tlen[win].tolist()
            q, n, at, fix = 0, len(step), [], {}
            while q < n:
                at.append(q)
                l = step[q]
                if not l:
                    fix[len(at) - 1], l = long_code(p + q)
                q += l
            syms = tsym[win[at]]
            for j, s in fix.items():
                syms[j] = s
            out.append(syms)
            done += len(at)
            p += q
        got = np.concatenate(out) if out else np.zeros(0, np.int64)
        return got[:n_symbols]


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
