"""Model-level quantisation plans: a per-tensor map of TensorFormats.

Plans are keyed by tensor paths written like the reference's
(``"['layers']['wq']"``), built from a single spec string, and applied to
nested-dict parameter trees for direct-cast, QAT (straight-through
fake-quant) and packed-checkpoint paths. ``build_allocated_plan`` realises
a per-tensor bit allocation (Eq. 5, ``core/allocation.py``);
``fit_lloyd_plan`` fits a Lloyd-Max codebook to each tensor (§2.2).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from .element import ElementFormat
from .nibble import pack_nibbles
from .registry import parse_element, parse_format, parse_scaling
from .tensor_format import PackedTensor, QuantisedTensor, TensorFormat


def flat_with_paths(tree):
    """``[(path, leaf)]`` in sorted key order, paths in ``keystr`` form;
    quantised and packed tensors are leaves."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend((f"[{k!r}]{p}", x) for p, x in flat_with_paths(tree[k]))
        return out
    return [("", tree)]


def map_with_paths(fn, tree, prefix: str = ""):
    """Map ``fn(path, leaf)`` over a nested-dict tree, keeping its keys."""
    if isinstance(tree, dict):
        return {k: map_with_paths(fn, v, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    return fn(prefix, tree)


@dataclass
class QuantisationPlan:
    """Map tensor-path → TensorFormat (None = keep in original dtype)."""

    formats: Dict[str, Optional[TensorFormat]] = field(default_factory=dict)

    def lookup(self, name: str) -> Optional[TensorFormat]:
        return self.formats.get(name)

    def _map(self, params, fn):
        return map_with_paths(lambda p, x: fn(self.formats.get(p), x), params)

    def fake_quant(self, params):
        return self._map(params,
                         lambda f, x: x if f is None else f.fake_quant(x))

    def fake_quant_ste(self, params):
        return self._map(params,
                         lambda f, x: x if f is None else f.fake_quant_ste(x))

    def quantise(self, params):
        return self._map(params,
                         lambda f, x: x if f is None else f.quantise(x))

    def dequantise(self, qparams):
        return self._map(qparams,
                         lambda f, q: q if f is None else f.dequantise(q))

    # -- packed serving representation ---------------------------------------
    def packable(self, name: str, shape, layouts: Dict[str, tuple]) -> bool:
        """True if tensor ``name`` can be carried packed and consumed by
        ``kernels.ops.dequant_matmul``: a matmul layout is declared, the
        element is a codebook of ≤256 codes, the scaling is per-block, there
        are no sparse outliers, and whole blocks tile the output dim N."""
        f = self.formats.get(name)
        lay = layouts.get(name)
        if f is None or lay is None:
            return False
        if not isinstance(f.element, ElementFormat) or f.element.n > 256:
            return False
        if f.sparse is not None and f.sparse.frac > 0:
            return False
        if f.scaling.granularity != "block":
            return False
        n_lead, n_k = lay
        if len(shape) < n_lead + n_k + 1:
            return False
        n_out = int(np.prod(shape[n_lead + n_k:]))
        return n_out % f.scaling.block_size == 0

    def _to_packed(self, name: str, qt: QuantisedTensor,
                   layouts: Dict[str, tuple]) -> PackedTensor:
        f = self.formats[name]
        n_lead, n_k = layouts[name]
        shape = tuple(qt.shape)
        lead = shape[:n_lead]
        K = int(np.prod(shape[n_lead:n_lead + n_k]))
        out_shape = shape[n_lead + n_k:]
        N = int(np.prod(out_shape))
        b = f.scaling.block_size
        codes = qt.codes.reshape(*lead, K, N)
        scales = qt.scales.reshape(*lead, K, N // b)
        # ≤16-codepoint codebooks store two codes per byte (K-dim nibble
        # interleave); odd K falls through to one uint8 per code
        bits = 8
        if f.element.n <= 16 and K % 2 == 0:
            codes, bits = pack_nibbles(codes), 4
        return PackedTensor(codes=codes.contiguous(),
                            scales=scales.contiguous(),
                            codepoints=f.element.codepoints,
                            out_shape=out_shape, shape=shape,
                            dtype=qt.dtype, block=b, bits=bits)

    def pack_quantised(self, qparams, layouts: Dict[str, tuple]):
        """Quantised checkpoint → serving params: packable tensors become
        :class:`PackedTensor`; everything else quantised is dequantised to
        its reference dtype."""
        def one(name, q):
            f = self.formats.get(name)
            if f is None or not isinstance(q, QuantisedTensor):
                return q
            if (self.packable(name, tuple(q.shape), layouts)
                    and q.sparse_idx is None):
                return self._to_packed(name, q, layouts)
            return f.dequantise(q)
        return map_with_paths(one, qparams)

    def pack(self, params, layouts: Dict[str, tuple]):
        """Quantise + pack in one step (fresh weights → serving params)."""
        return self.pack_quantised(self.quantise(params), layouts)

    def unpack(self, packed):
        """Serving params → dense params (PackedTensor leaves dequantised)."""
        return map_with_paths(
            lambda _, x: x.dequantise() if isinstance(x, PackedTensor) else x,
            packed)

    def verify_packed(self, packed) -> int:
        """Integrity-validate every PackedTensor leaf (see
        :meth:`PackedTensor.verify`); returns the number checked."""
        return verify_packed_tree(packed)

    # -- accounting -----------------------------------------------------------
    def bits_per_param(self, params, measured: bool = False,
                       keep_bits: float = 16.0) -> float:
        total_bits, total_n = 0.0, 0
        for name, x in flat_with_paths(params):
            n = int(np.prod(tuple(x.shape)))
            f = self.formats.get(name)
            if f is None:
                total_bits += keep_bits * n
            elif measured or f.compressed:
                total_bits += f.measured_bits_per_param(x) * n
            else:
                total_bits += f.bits_per_param(tuple(x.shape)) * n
            total_n += n
        return total_bits / max(total_n, 1)


def verify_packed_tree(packed) -> int:
    """``verify()`` every PackedTensor leaf of a params tree, naming its path
    on failure; returns the number of leaves checked."""
    n = 0
    for name, leaf in flat_with_paths(packed):
        if isinstance(leaf, PackedTensor):
            leaf.verify(name=name)
            n += 1
    return n


def quantisable(name: str, x, min_ndim: int = 2,
                min_numel: int = 4096) -> bool:
    """Default policy: quantise big >=2-D tensors; keep small vectors (norm
    scales, biases) in the reference dtype."""
    shape = tuple(x.shape)
    return len(shape) >= min_ndim and int(np.prod(shape)) >= min_numel


def build_plan(params, spec: str, min_ndim: int = 2,
               overrides: Dict[str, str] | None = None) -> QuantisationPlan:
    """Uniform plan: every quantisable tensor gets ``spec``; regex overrides
    (e.g. {"embed": "babsmax128:int8"}) take precedence."""
    fmt = parse_format(spec)
    formats: Dict[str, Optional[TensorFormat]] = {}
    for name, x in flat_with_paths(params):
        chosen: Optional[TensorFormat] = None
        if quantisable(name, x, min_ndim):
            chosen = fmt
            if overrides:
                for pat, s in overrides.items():
                    if re.search(pat, name):
                        chosen = parse_format(s) if s else None
                        break
        formats[name] = chosen
    return QuantisationPlan(formats)


def build_allocated_plan(
    params,
    bit_alloc: Dict[str, float],
    scaling_spec: str,
    element_family: str = "t",
    min_bits: float = 1.0,
) -> QuantisationPlan:
    """Variable-bit plan (§2.4): per-tensor bit widths from Eq. 5, realised
    with the ∛p element family at each tensor's allocated width. Tensors
    the allocation does not name, or too small to quantise, stay dense."""
    scaling = parse_scaling(scaling_spec)
    formats: Dict[str, Optional[TensorFormat]] = {}
    for name, x in flat_with_paths(params):
        if name not in bit_alloc or not quantisable(name, x):
            formats[name] = None
            continue
        bits = max(min_bits, bit_alloc[name])
        elem = parse_element(f"{element_family}{bits:g}", scaling)
        formats[name] = TensorFormat(
            element=elem, scaling=scaling,
            name=f"{scaling_spec}:{element_family}{bits:.2f}")
    return QuantisationPlan(formats)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def fit_lloyd_plan(params, bits: float, scaling_spec: str = "trms",
                   fisher: Optional[dict] = None) -> QuantisationPlan:
    """Data-fitted Lloyd-Max plan (§2.2), optionally Fisher-weighted: each
    quantisable tensor is normalised on its own device, then its codebook
    is fitted on the host (``core/lloyd.py``, numpy)."""
    from .lloyd import lloyd_max

    scaling = parse_scaling(scaling_spec)
    fisher_flat = dict(flat_with_paths(fisher)) if fisher is not None else {}
    formats: Dict[str, Optional[TensorFormat]] = {}
    for name, x in flat_with_paths(params):
        if not quantisable(name, x):
            formats[name] = None
            continue
        with torch.no_grad():
            xb, _, unblock = scaling.normalise(x.float())
            xn = _host(unblock(xb)).reshape(-1)  # normalised, padding trimmed
        w = fisher_flat.get(name)
        init = "uniform" if scaling.statistic in ("absmax", "signmax") \
            else "kmeans++"
        elem = lloyd_max(xn, bits,
                         weights=None if w is None else _host(w).reshape(-1),
                         init=init)
        formats[name] = TensorFormat(element=elem, scaling=scaling,
                                     name=f"{scaling_spec}:lloyd{bits:g}")
    return QuantisationPlan(formats)
