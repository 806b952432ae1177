"""TensorFormat — the paper's composable format for one parameter tensor:

    TensorFormat = element format × scaling scheme × sparse outliers
                   × optional lossless compression

  * ``fake_quant(x)``        — dequantise(quantise(x)) (direct-cast);
                               ``fake_quant_ste`` is its straight-through
                               form for QAT (§D).
  * ``quantise(x)``          — codes + scales (+ COO outliers): the
                               quantised checkpoint and serving input.
  * ``bits_per_param(...)``  — storage accounting incl. scale and sparse
                               overhead; ``measured_bits_per_param`` adds
                               the Shannon entropy (or Huffman length) of
                               a compressed (``:C``) format's code stream.

``PackedTensor`` is the serving representation the fused ``dequant_matmul``
kernel consumes: codes in the matmul's (K, N) layout, nibble-packed along K
at 4 bits.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from .compress import build_huffman, cross_entropy_bits, entropy_bits
from .element import ElementFormat, UniformGrid
from .scaling import Scaling
from .sparse import SparseOutliers, extract_topk, scatter_coo


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def ste(x: torch.Tensor, x_hat: torch.Tensor) -> torch.Tensor:
    """Straight-through estimator: forward = x_hat, backward = identity."""
    return x + (x_hat - x).detach()


class IntegrityError(ValueError):
    """A packed checkpoint tensor failed integrity validation.

    One flipped scale or out-of-range code decodes to unbounded garbage that
    poisons every co-batched generation, so the serving path validates
    packed tensors at load (``ServeEngine.from_quantised(validate=True)``)
    and fails naming the offending tensor path."""


@dataclass
class QuantisedTensor:
    codes: torch.Tensor                   # uint8/int32, blocked layout
    scales: torch.Tensor                  # per tensor/channel/block, bf16
    sparse_idx: Optional[torch.Tensor]    # int32 flat indices or None
    sparse_val: Optional[torch.Tensor]    # bf16 values or None
    shape: tuple = ()
    dtype: str = "float32"


@dataclass
class PackedTensor:
    """Matmul-ready packed quantised weight (the serving representation):

        codes  uint8 (*lead, K, N)          K = contraction dim, N = output
               — or (*lead, K // 2, N) when ``bits == 4``: two codes per
               byte, K-dim nibble interleave (``core.nibble`` layout)
        scales bf16  (*lead, K, N // block) one scale per in-row block

    ``out_shape`` is the logical trailing output dims (prod == N); ``shape``
    the full logical shape of the stacked tensor. The f32 codebook tensor
    is built once, on the codes' device, and shared by the per-layer views
    that :meth:`layer` returns."""

    codes: torch.Tensor
    scales: torch.Tensor
    codepoints: tuple = ()
    out_shape: tuple = ()
    shape: tuple = ()
    dtype: str = "float32"
    block: int = 128
    bits: int = 8
    cb: Optional[torch.Tensor] = dataclasses.field(default=None, repr=False,
                                                   compare=False)

    def __post_init__(self):
        if self.cb is None:
            self.cb = torch.tensor(self.codepoints, dtype=torch.float32,
                                   device=self.codes.device)

    def codebook(self) -> torch.Tensor:
        return self.cb

    @property
    def k_dim(self) -> int:
        """Logical contraction length (codes rows × codes per byte)."""
        return self.codes.shape[-2] * (2 if self.bits == 4 else 1)

    def layer(self, i: int) -> "PackedTensor":
        """The i-th slice along the leading (layer) dim, as views of the
        stacked codes and scales with the shared codebook."""
        return dataclasses.replace(self, codes=self.codes[i],
                                   scales=self.scales[i],
                                   shape=tuple(self.shape[1:]))

    def to(self, device) -> "PackedTensor":
        return dataclasses.replace(self, codes=self.codes.to(device),
                                   scales=self.scales.to(device),
                                   cb=self.cb.to(device))

    def unpacked_codes(self) -> torch.Tensor:
        """Codes as one uint8 per element, (*lead, K, N) (nibbles expanded)."""
        if self.bits == 4:
            from .nibble import unpack_nibbles
            return unpack_nibbles(self.codes, self.k_dim)
        return self.codes

    def dequantise(self) -> torch.Tensor:
        """Materialise the dense tensor: the same elementwise codebook
        lookup × scale as ``TensorFormat.dequantise`` of the source."""
        vals = self.cb[self.unpacked_codes().long()]
        s = torch.repeat_interleave(self.scales.float(), self.block, dim=-1)
        return (vals * s).reshape(self.shape).to(_torch_dtype(self.dtype))

    def verify(self, name: str = "") -> None:
        """Integrity-check this packed tensor; raise :class:`IntegrityError`
        naming ``name`` (the tensor path) on the first violation, with the
        reference's messages: codes uint8 within the codebook range,
        nibble/K-dim layout consistent with the logical shape, scales exactly
        ``(*lead, K, N // block)`` with ``block`` tiling N, finite scales and
        codebook."""
        tag = f"packed tensor {name or '<unnamed>'}"

        def fail(msg):
            raise IntegrityError(f"{tag}: {msg}")

        if self.bits not in (4, 8):
            fail(f"unsupported storage width bits={self.bits}")
        if self.codes.dtype != torch.uint8:
            fail(f"codes stored as {_dtype_name(self.codes.dtype)}, "
                 "expected uint8")
        n_codes = len(self.codepoints)
        if n_codes == 0:
            fail("empty codebook")
        if n_codes > (16 if self.bits == 4 else 256):
            fail(f"codebook of {n_codes} points does not fit "
                 f"{self.bits}-bit codes")
        codes_shape = tuple(self.codes.shape)
        if self.codes.ndim < 2:
            fail(f"codes must be (*lead, K{'//2' if self.bits == 4 else ''},"
                 f" N), got {codes_shape}")
        lead = codes_shape[:-2]
        K, N = self.k_dim, int(codes_shape[-1])
        numel = int(np.prod(lead)) * K * N
        if int(np.prod(self.shape)) != numel:
            fail(f"codes layout {codes_shape} (bits={self.bits}: "
                 f"K={K}, N={N}) holds {numel} codes but the logical shape "
                 f"{self.shape} has {int(np.prod(self.shape))} elements")
        if self.out_shape and int(np.prod(self.out_shape)) != N:
            fail(f"out_shape {self.out_shape} disagrees with the codes "
                 f"output dim N={N}")
        if self.block <= 0 or N % self.block != 0:
            fail(f"output dim N={N} does not tile by the scale block "
                 f"{self.block}")
        expect = lead + (K, N // self.block)
        if tuple(self.scales.shape) != expect:
            fail(f"scales shape {tuple(self.scales.shape)} disagrees with "
                 f"the codes layout (expected {expect})")
        cb = self.cb.float()
        bad = int((~torch.isfinite(cb)).sum())
        if bad:
            fail(f"non-finite codebook ({bad} of {cb.numel()} entries)")
        bad = int((~torch.isfinite(self.scales.float())).sum())
        if bad:
            fail(f"non-finite block scales ({bad} of {self.scales.numel()} "
                 "entries)")
        c = self.unpacked_codes()
        cmax = int(c.max()) if c.numel() else 0
        if cmax >= n_codes:
            fail(f"code {cmax} out of codebook range [0, {n_codes})")


@dataclass(frozen=True)
class TensorFormat:
    element: Union[ElementFormat, UniformGrid]
    scaling: Scaling = Scaling()
    sparse: Optional[SparseOutliers] = None
    compressed: bool = False
    name: str = ""

    def describe(self) -> str:
        if self.name:
            return self.name
        s = f"{self.scaling.describe()}:{self.element.name}"
        if self.sparse:
            s += f":sp{self.sparse.frac:g}"
        if self.compressed:
            s += ":C"
        return s

    def fake_quant(self, x: torch.Tensor) -> torch.Tensor:
        """Direct-cast round trip."""
        x32 = x.float()
        mask = None
        dense = x32
        if self.sparse is not None and self.sparse.frac > 0:
            dense, mask = self.sparse.split(x32)
        xb, scales, unblock = self.scaling.normalise(dense)
        y = unblock(self.element.fake_quant(xb) * scales)
        if mask is not None:
            y = self.sparse.merge(y, x32, mask)
        return y.to(x.dtype)

    def fake_quant_ste(self, x: torch.Tensor) -> torch.Tensor:
        """QAT forward: quantised values, identity gradient (paper §D QAT).
        The round trip runs without autograd: the scales computed from the
        master tensor get no gradient, as in the reference."""
        with torch.no_grad():
            x_hat = self.fake_quant(x)
        return ste(x, x_hat)

    def quantise(self, x: torch.Tensor) -> QuantisedTensor:
        x32 = x.float()
        sp_idx = sp_val = None
        dense = x32
        if self.sparse is not None and self.sparse.frac > 0:
            k = self.sparse.capacity(x.numel())
            sp_idx, sp_val = extract_topk(x32, k)
            dense = scatter_coo(x32, sp_idx, torch.zeros_like(sp_val)).float()
        xb, scales, _ = self.scaling.normalise(dense)
        codes = self.element.quantise(xb)
        return QuantisedTensor(codes, scales.to(torch.bfloat16), sp_idx,
                               sp_val, tuple(x.shape), _dtype_name(x.dtype))

    def dequantise(self, qt: QuantisedTensor) -> torch.Tensor:
        vals = self.element.dequantise(qt.codes) * qt.scales.float()
        y = vals.reshape(-1)[: int(np.prod(qt.shape))].reshape(qt.shape)
        if qt.sparse_idx is not None:
            y = scatter_coo(y, qt.sparse_idx, qt.sparse_val)
        return y.to(_torch_dtype(qt.dtype))

    def element_bits(self) -> float:
        if isinstance(self.element, UniformGrid):
            raise ValueError("uniform grid bits are data-dependent (entropy); "
                             "use measured_bits_per_param")
        return self.element.bits

    def bits_per_param(self, shape) -> float:
        """Analytic bits/param (fixed-length element code)."""
        b = self.element_bits() + self.scaling.scale_bits_per_param(shape)
        if self.sparse is not None:
            b += self.sparse.bits_per_param()
        return b

    def measured_bits_per_param(self, x, practical_huffman: bool = False,
                                model_hist: np.ndarray | None = None) -> float:
        """Bits/param measured on data. For ``compressed`` formats the element
        cost is the Shannon entropy of the actual code stream (or the Huffman
        mean code length if ``practical_huffman``, or the cross-entropy
        against ``model_hist``). The codes are made and counted on ``x``'s
        device; only the histogram comes to the host."""
        shape = tuple(x.shape)
        if self.compressed:
            n_codes = (None if isinstance(self.element, UniformGrid)
                       else self.element.n)
            codes = self.quantise(x).codes.reshape(-1)[:int(np.prod(shape))]
            hist = _code_histogram(codes, n_codes)
            if practical_huffman:
                eb = build_huffman(hist).mean_bits(hist)
            elif model_hist is not None:
                eb = cross_entropy_bits(hist, model_hist)
            else:
                eb = entropy_bits(hist)
        else:
            eb = self.element_bits()
        b = eb + self.scaling.scale_bits_per_param(shape)
        if self.sparse is not None:
            b += self.sparse.bits_per_param()
        return float(b)

    def relative_rms_error(self, x: torch.Tensor,
                           weights: torch.Tensor | None = None) -> torch.Tensor:
        """R := RMS error / RMS of the data (§C); optionally Fisher-weighted."""
        x32 = torch.as_tensor(x).float()
        err = self.fake_quant(x32) - x32
        if weights is None:
            return torch.sqrt(torch.sum(err * err) / torch.sum(x32 * x32))
        w = torch.as_tensor(weights, device=x32.device).float()
        return torch.sqrt(torch.sum(w * err * err) / torch.sum(w * x32 * x32))


def _code_histogram(codes: torch.Tensor, n_codes: int | None) -> np.ndarray:
    """``compress.code_histogram`` of a code tensor, counted on its device:
    the same int64 counts (a codebook's codes from 0; a grid's from its
    least code)."""
    codes = codes.reshape(-1).long()
    if n_codes is None:
        lo, hi = torch.aminmax(codes)
        codes = codes - lo
        n_codes = int(hi - lo) + 1
    return torch.bincount(codes, minlength=n_codes).cpu().numpy()
