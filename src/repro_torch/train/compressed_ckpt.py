"""Entropy-coded checkpoints (§2.3 as a framework feature).

A serving checkpoint where each tensor is quantised on a uniform grid at a
target entropy and the code stream is **Huffman-packed to actual bytes** —
the paper's optimal entropy-constrained format as storage. The reference's
``repro/train/compressed_ckpt.py`` on the port's trees, with the same files:
a checkpoint written by either package loads in the other.

Format per tensor (inside one .npz, keys are tensor paths with ``/`` → ``_``):
    <name>.__payload   uint8 Huffman bitstream
    <name>.__lengths   per-symbol code lengths (canonical code rebuild)
    <name>.__symbols   symbol values (grid indices, offset-shifted)
    <name>.__meta      [n_symbols_total, delta*2^40, lo, shape...]
Tensors the default policy does not quantise (``plan.quantisable``) are
stored raw in f32. The codec runs on the host (numpy and Python),
``plan.HOST_WINDOW`` tensors at a time, one a thread, each copied to the
host by its own thread (``plan.in_window``): the same bytes as one tensor
at a time, with at most that many tensors' host copies alive at once.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch.core.compress import (HuffmanCode, build_huffman,
                                       fit_grid_delta)
from repro_torch.core.element import uniform_grid
from repro_torch.core.plan import (_flat_with_paths, flat_with_paths,
                                   in_window, map_with_paths, quantisable)

_DELTA_SCALE = 2.0 ** 40


def _encode(x, target_bits: float):
    """One tensor's grid step, lowest code, Huffman code, histogram and
    payload, from a host f32 copy made here and dropped on return."""
    xnp = _host_f32(x)
    delta = fit_grid_delta(xnp, target_bits=target_bits)
    codes = uniform_grid(delta).quantise(torch.from_numpy(xnp)).numpy()
    lo = int(codes.min())
    sym = (codes - lo).astype(np.int64).reshape(-1)
    hist = np.bincount(sym)
    hc = build_huffman(hist)
    payload, _ = hc.encode(sym)
    return delta, lo, sym.size, hist, hc, payload


def _host_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


def save_compressed_params(ckpt_dir: str, params, target_bits: float = 4.0,
                           step: int = 0) -> str:
    """Write ``params`` to ``ckpt_dir/cstep_<step>`` (staged, then renamed):
    each quantisable tensor on a uniform grid fitted to ``target_bits`` of
    entropy (codes rounded in f32, half to even), Huffman-coded. Returns the
    checkpoint's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"cstep_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat: dict = {}
    meta_rows = []
    leaves = _flat_with_paths(params)
    coded = in_window(lambda x: _encode(x, target_bits),
                      [x for name, x in leaves if quantisable(name, x)])
    for name, x in leaves:
        key = name.replace("/", "_")
        if not quantisable(name, x):
            flat[key] = _host_f32(x)  # small tensors stored raw
            continue
        delta, lo, size, hist, hc, payload = next(coded)
        flat[key + ".__payload"] = np.frombuffer(payload, np.uint8)
        symbols = np.asarray(sorted(hc.lengths), np.int64)
        flat[key + ".__symbols"] = symbols
        flat[key + ".__lengths"] = np.asarray(
            [hc.lengths[s] for s in symbols], np.int64)
        flat[key + ".__meta"] = np.asarray(
            [size, int(delta * _DELTA_SCALE), lo, *x.shape], np.int64)
        meta_rows.append(dict(tensor=name, bits=hc.mean_bits(hist),
                              numel=int(size)))
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    total_bits = sum(r["bits"] * r["numel"] for r in meta_rows)
    total_n = sum(r["numel"] for r in meta_rows)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "format": "huffman-grid",
                   "target_bits": target_bits,
                   "achieved_bits_per_param": total_bits / max(total_n, 1),
                   "tensors": meta_rows}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _canonical_code(symbols, lengths) -> HuffmanCode:
    """Rebuild the canonical Huffman code from its (symbol, length) pairs."""
    lmap = {int(s): int(l) for s, l in zip(symbols, lengths)}
    codes: dict = {}
    cur, prev = 0, 0
    for s, l in sorted(lmap.items(), key=lambda kv: (kv[1], kv[0])):
        cur <<= l - prev
        codes[s] = (cur, l)
        cur += 1
        prev = l
    return HuffmanCode(lmap, codes)


def load_compressed_params(path: str, template) -> dict:
    """Decode back to a nested dict shaped like ``template``: f32 tensors
    (grid values ``code * delta``, raw tensors as stored) on each template
    leaf's device (the CPU for leaves without one)."""
    npz = np.load(os.path.join(path, "arrays.npz"))
    by_key: dict = {}
    for k in npz.files:
        if ".__" in k:
            base, attr = k.rsplit(".__", 1)
            by_key.setdefault(base, {})[attr] = npz[k]
        else:
            by_key[k] = npz[k]

    def decode(entry):
        if isinstance(entry, np.ndarray):
            return entry
        meta = entry["meta"]
        n, delta_q, lo = int(meta[0]), int(meta[1]), int(meta[2])
        shape = tuple(int(d) for d in meta[3:])
        hc = _canonical_code(entry["symbols"], entry["lengths"])
        sym = hc.decode(entry["payload"].tobytes(), n)
        return ((sym + lo).astype(np.float32)
                * (delta_q / _DELTA_SCALE)).reshape(shape)

    leaves = flat_with_paths(template)
    decoded = in_window(lambda name: decode(by_key[name.replace("/", "_")]),
                        [name for name, _ in leaves])
    moved = {name: torch.from_numpy(np.ascontiguousarray(next(decoded))).to(
        getattr(x, "device", "cpu")) for name, x in leaves}
    return map_with_paths(lambda name, _: moved[name], template)
