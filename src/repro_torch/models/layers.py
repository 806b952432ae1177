"""Shared layers: the packed-aware projection API (``linear``,
``embed_lookup``, ``expert_matmul``), RMSNorm, RoPE, single- and
multi-token decode attention over a dense or quantised KV cache, cache
writes, the teacher-forcing chunked ``flash_attention`` and ``attn_block``,
the SwiGLU and GELU MLPs, the sort-based MoE block and the depthwise
``causal_conv1d`` (zamba2's Mamba-2 layers).

Torch on the operands' device. ``linear`` is the single way a model
multiplies an activation by a parameter: dense weights take the einsum of
the call site, ``PackedTensor`` weights the fused ``dequant_matmul`` kernel
(or ``dequant_matmul_t`` when the contraction runs along the packed table's
blocked axis, the tied unembed); stacked expert weights go through
``expert_matmul``, which runs ``dequant_matmul`` with its expert lead dim
when packed. A quantised KV cache (:class:`QuantisedKV`)
is written through ``block_quant`` (k and v of a layer in one
``block_quant_kv`` call) and read through
``decode_attention_quant``. Each is the CUDA kernel on the card and its
plain version on the CPU.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.nibble import nibble_row_coords
from repro_torch.core.tensor_format import PackedTensor
from repro_torch.kernels import ops as kops

NEG_INF = -1e30


@functools.lru_cache(maxsize=None)
def _spec_orientation(spec: str) -> str:
    """Classify the weight operand of ``spec``: do its contracting labels
    lead ("normal", the dequant_matmul codes layout lead+K+out) or trail
    ("transposed", out+K — contraction along the blocked axis)?"""
    ins, out = spec.replace(" ", "").split("->")
    xs, ws = ins.split(",")
    batch = "".join(c for c in ws if c in xs and c in out)
    contract = "".join(c for c in ws if c in xs and c not in out)
    wout = "".join(c for c in ws if c not in xs)
    if not contract:
        raise ValueError(f"no contraction in spec {spec!r}")
    if ws == batch + contract + wout:
        return "normal"
    if ws == batch + wout + contract:
        return "transposed"
    raise ValueError(f"cannot orient weight subscripts in spec {spec!r}")


def linear(x, w, spec: str):
    """``einsum(spec, x, w)`` where ``w`` may be a :class:`PackedTensor`.

    Packed weights route through ``kernels.ops.dequant_matmul``: x is
    flattened to (B·T, K) (``x`` is (B, T, *k_dims) with the trailing dims
    contracting) and the result unflattened to (B, T, *out_shape). A spec
    whose weight subscripts end with the contracting labels (``"btd,vd->
    btv"``, the tied unembed) contracts along the packed table's blocked
    axis through ``dequant_matmul_t``; no transposed copy is made."""
    if isinstance(w, PackedTensor):
        B, T = x.shape[0], x.shape[1]
        if _spec_orientation(spec) == "transposed":
            n = int(np.prod(w.out_shape))
            y = kops.dequant_matmul_t(x.reshape(B * T, n).contiguous(),
                                      w.codes, w.scales, w.codebook(),
                                      block=w.block, bits=w.bits)
            return y.reshape(B, T, w.k_dim)
        y = kops.dequant_matmul(x.reshape(B * T, w.k_dim).contiguous(),
                                w.codes, w.scales, w.codebook(),
                                block=w.block, bits=w.bits)
        return y.reshape(B, T, *w.out_shape)
    return torch.einsum(spec, x, w.to(x.dtype))


def expert_matmul(x, w, spec: str):
    """Per-expert batched matmul: x (E, C, K) against a stacked expert
    weight w (E, K, N) (``spec`` e.g. "ecd,edf->ecf"). A packed stack runs
    ``dequant_matmul`` with its lead dim E: the codes of every expert stream
    packed, in one launch on the card."""
    if isinstance(w, PackedTensor):
        y = kops.dequant_matmul(x.contiguous(), w.codes, w.scales,
                                w.codebook(), block=w.block, bits=w.bits)
        return y.to(x.dtype)
    return torch.einsum(spec, x, w.to(x.dtype))


def embed_lookup(w, tokens, dtype=None):
    """Embedding row gather; packed tables dequantise only the gathered rows
    (codes (V, D) or nibble bytes (V/2, D), scales (V, D//block)).
    ``dtype``: output dtype (the serving dtype); defaults to the packed
    tensor's own dtype / the dense table's dtype."""
    if isinstance(w, PackedTensor):
        from repro_torch.models.api import torch_dtype
        out_dt = dtype if dtype is not None else torch_dtype(w.dtype)
        nib = None
        c_rows = tokens
        if w.bits == 4:
            c_rows, nib = nibble_row_coords(tokens, w.k_dim)
        c = w.codes[c_rows.long()]                 # (B, T, D) uint8
        s = w.scales[tokens.long()]                # (B, T, D // block)
        return kops.dequant_rows(c, s, w.codebook(), block=w.block,
                                 dtype=out_dt, nibble=nib)
    out = w[tokens.long()]
    return out if dtype is None else out.to(dtype)


def rms_norm(x, gain, eps: float = 1e-5, plus_one: bool = False):
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    g = gain.float()
    if plus_one:
        g = g + 1.0
    return (y * g).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _rope_freqs(hd: int, theta: float, device: torch.device) -> torch.Tensor:
    """The reference's numpy f32 frequencies, copied to ``device`` once (a
    copy per call would synchronise the host with the card every layer)."""
    freqs = 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float32) / hd))
    return torch.from_numpy(np.asarray(freqs, np.float32)).to(device)


def rope_tables(positions, hd: int, theta: float):
    """Rotation tables for ``positions`` (..., T), shaped (..., T, 1, hd) to
    broadcast over heads: (cos, cos) and (-sin, sin) per half, so that
    :func:`apply_rope` is ``x * cos + rotate_half(x) * sin``."""
    ang = positions.float()[..., None] * _rope_freqs(hd, float(theta),
                                                     positions.device)
    cos, sin = torch.cos(ang), torch.sin(ang)
    return (torch.cat([cos, cos], dim=-1)[..., None, :],
            torch.cat([-sin, sin], dim=-1)[..., None, :])


def apply_rope(x, cos, sin):
    """Rotate x (..., T, n, hd) by precomputed ``rope_tables``: the
    reference's ``[x1 cos - x2 sin, x2 cos + x1 sin]``, bit for bit (the
    sign is folded into the table)."""
    x32 = x.float()
    x1, x2 = torch.chunk(x32, 2, dim=-1)
    return (x32 * cos + torch.cat([x2, x1], dim=-1) * sin).to(x.dtype)


def rope(x, positions, theta: float):
    """Rotary embedding. x: (..., T, n, hd); positions: (..., T)."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta))


# ---------------------------------------------------------------------------
# Quantised KV cache (block-scaled codes + per-row scales)
# ---------------------------------------------------------------------------

class QuantisedKV(NamedTuple):
    """One cache stack's quantised storage: codes (..., S, K, hdc) uint8 and
    scales (..., S, K, 1) float32 (hdc = hd, or hd // 2 nibble-packed)."""
    codes: torch.Tensor
    scales: torch.Tensor


def codebook_bits(codebook) -> int:
    """Code width of a KV codebook: 16 codes -> 4 (nibble-packed), 256 -> 8."""
    n = codebook.shape[0]
    if n == 16:
        return 4
    if n == 256:
        return 8
    raise ValueError(f"KV codebook must have 16 or 256 codes, got {n}")


def quantise_kv(new, codebook, bits: int):
    """Quantise fresh K or V rows (B, T, K, hd) through ``block_quant``
    (absmax per (token, head) row -> bf16 round-away scale -> nearest
    codebook index). Returns (codes (B, T, K, hdc) uint8, scales (B, T, K,
    1) f32); 4-bit codes pack pairwise along hd (byte j = element 2j low |
    element 2j+1 high), so each row is self-contained. The reference pads
    the rows to its kernel's row tile first; padding changes no code, so
    the port does not."""
    B, T, K, hd = new.shape
    codes, scales = kops.block_quant(new.reshape(B * T * K, hd).contiguous(),
                                     codebook, block=hd, pack=bits == 4)
    return codes.reshape(B, T, K, -1), scales.reshape(B, T, K, 1)


def dequant_kv(cache: QuantisedKV, codebook, dtype=torch.float32):
    """Densify a quantised cache stack (tests and the plain path only)."""
    return kops.dequant_kv(cache.codes, cache.scales, codebook,
                           bits=codebook_bits(codebook), dtype=dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

class AttnParams(NamedTuple):
    wq: torch.Tensor   # (D, H, hd)
    wk: torch.Tensor   # (D, K, hd)
    wv: torch.Tensor   # (D, K, hd)
    wo: torch.Tensor   # (H, hd, D)
    q_norm: Optional[torch.Tensor] = None  # (hd,)
    k_norm: Optional[torch.Tensor] = None


def qkv_project(x, p: AttnParams, rot, cfg):
    """q, k, v projections, q and k rotated by ``rot``, the step's
    ``rope_tables``. The reference takes positions and builds the tables
    inside; the port builds them once per step. ``rot=None`` leaves q and k
    unrotated (the reference's ``rope_on=False``: whisper's encoder)."""
    q = linear(x, p.wq, "btd,dnh->btnh")
    k = linear(x, p.wk, "btd,dnh->btnh")
    v = linear(x, p.wv, "btd,dnh->btnh")
    if cfg.qk_norm and p.q_norm is not None:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    if rot is None:
        return q, k, v
    return apply_rope(q, *rot), apply_rope(k, *rot), v


def attention_mask(q_positions, S: int, *, window=0, ring=False):
    """(B, T, 1, 1, S) True where query t of row b may see cache slot s:
    causal, within ``window`` when > 0, and — for ring caches, whose slot
    positions are reconstructed from the row's highest written position
    (``serve.cache.ring_positions``) — written."""
    if ring:
        from repro_torch.serve.cache import ring_positions
        kv = ring_positions(q_positions[:, -1], S)                 # (B, S)
        mask = kv[:, None, :] <= q_positions[:, :, None]           # causal
        mask &= q_positions[:, :, None] - kv[:, None, :] < window
        mask &= kv[:, None, :] >= 0                                # unwritten
    else:
        kv = torch.arange(S, device=q_positions.device)
        mask = kv[None, None, :] <= q_positions[:, :, None]        # causal
        if window > 0:
            mask &= q_positions[:, :, None] - kv[None, None, :] < window
    return mask[:, :, None, None, :]


def attend(q, k_cache, v_cache, mask):
    """Softmax attention of q (B, T, H, hd) over dense caches (B, S, K, hd)
    under ``attention_mask``: einsum scores, a masked f32 softmax, einsum
    with v — with the reference's casts (k to q's dtype, scores to f32, p
    to v's dtype)."""
    B, T, H, hd = q.shape
    K = k_cache.shape[2]
    qg = q.reshape(B, T, K, H // K, hd)
    s = torch.einsum("btkgh,bskh->btkgs", qg, k_cache.to(qg.dtype))
    s = (s.float() * hd ** -0.5).masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("btkgs,bskh->btkgh", p.to(v_cache.dtype), v_cache)
    return out.reshape(B, T, H, hd).to(q.dtype)


def decode_attention(q, k_cache, v_cache, q_position, *, window=0,
                     kv_positions=None, ring=False, codebook=None):
    """Single-token attention against a KV cache: q (B, 1, H, hd), caches
    (B, S, K, hd), ``q_position`` the current position (a scalar, shared by
    every row). ``ring=True``: a ring buffer written at ``pos % S``, whose
    slot positions are reconstructed from ``q_position``, never-written
    slots masked. ``kv_positions`` (S,) overrides the slot positions of a
    linear cache. A :class:`QuantisedKV` cache (with its ``codebook``) is
    read from codes by ``decode_attention_quant``."""
    if isinstance(k_cache, QuantisedKV):
        if kv_positions is not None:
            raise ValueError("quantised caches reconstruct slot positions "
                             "in the kernel: kv_positions must be None")
        qpos = torch.as_tensor(q_position, dtype=torch.int32,
                               device=q.device).expand(q.shape[0])[:, None]
        return kops.decode_attention_quant(
            q, k_cache.codes, k_cache.scales, v_cache.codes, v_cache.scales,
            codebook, qpos.contiguous(), window, ring=ring,
            bits=codebook_bits(codebook))
    B, _, H, hd = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, K, H // K, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_cache.to(qg.dtype))
    s = s.float() * hd ** -0.5
    qp = torch.as_tensor(q_position, device=q.device)
    if ring:
        from repro_torch.serve.cache import ring_positions
        kv = ring_positions(qp.to(torch.int32), S)
        mask = (kv <= qp) & (kv >= 0)
    else:
        kv = (torch.arange(S, device=q.device) if kv_positions is None
              else torch.as_tensor(kv_positions, device=q.device))
        mask = kv <= qp
    if window > 0:
        mask = mask & (qp - kv < window)
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p.to(v_cache.dtype), v_cache)
    return out.reshape(B, 1, H, hd).to(q.dtype)


def chunked_decode_attention(q, k_cache, v_cache, q_positions, *, window=0,
                             ring=False, codebook=None):
    """Multi-token decode attention with per-slot positions: a chunk of T
    query tokens per batch row against that row's KV cache.
    q: (B, T, H, hd); caches (B, S, K, hd) — or :class:`QuantisedKV` with
    their ``codebook``, read straight from codes by
    ``decode_attention_quant`` under the same masks; q_positions (B, T)
    absolute positions (the new tokens' k/v are already written)."""
    if isinstance(k_cache, QuantisedKV):
        return kops.decode_attention_quant(
            q, k_cache.codes, k_cache.scales, v_cache.codes, v_cache.scales,
            codebook, q_positions, window, ring=ring,
            bits=codebook_bits(codebook))
    mask = attention_mask(q_positions, k_cache.shape[1], window=window,
                          ring=ring)
    return attend(q, k_cache, v_cache, mask)


def cache_slots(pos, T: int, S: int, *, ring=False):
    """Where T new entries per row land in a cache of S slots: rows (B, 1)
    and slots (B, T). Linear caches write at ``pos .. pos+T-1`` with the
    start clamped to ``S - T`` (as ``dynamic_update_slice`` clamps in the
    reference); ring caches at ``(pos + t) % S``."""
    t = torch.arange(T, dtype=pos.dtype, device=pos.device)
    if ring:
        from repro_torch.serve.cache import ring_slots
        slots = ring_slots(pos[:, None] + t, S)
    else:
        slots = pos.clamp(0, S - T)[:, None] + t
    rows = torch.arange(pos.shape[0], device=pos.device)[:, None]
    return rows, slots.long()


def kv_rows(rows, slots, S: int, K: int):
    """Flat cache rows (B·T·K,) int64 of a (B, S, K, ·) cache that the new
    (B, T, K) entries at (rows, slots) land in: ``block_quant`` writes
    there."""
    heads = torch.arange(K, device=slots.device)
    return ((rows * S + slots)[..., None] * K + heads).reshape(-1)


def write_kv(cache, new, rows, slots, codebook=None, dest=None):
    """Write new (B, T, K, hd) entries at (rows, slots) **in place**. A
    :class:`QuantisedKV` cache quantises them on the way (``codebook``
    required; ``dest`` = :func:`kv_rows`, computed here when not given)."""
    if isinstance(cache, QuantisedKV):
        B, T, K, hd = new.shape
        if dest is None:
            dest = kv_rows(rows, slots, cache.codes.shape[1], K)
        kops.block_quant(new.reshape(B * T * K, hd).contiguous(), codebook,
                         block=hd, pack=codebook_bits(codebook) == 4,
                         out=(cache.codes, cache.scales), rows=dest)
    else:
        cache[rows, slots] = new.to(cache.dtype)
    return cache


def write_kv_pair(k_cache, v_cache, k_new, v_new, rows, slots,
                  codebook=None, dest=None):
    """Write a layer's new k and v (B, T, K, hd) entries at (rows, slots)
    **in place**, as two :func:`write_kv` calls would. A quantised pair
    goes through one ``block_quant_kv`` call: one kernel launch on the card
    quantises both into their caches at the shared ``dest`` rows."""
    if not isinstance(k_cache, QuantisedKV):
        write_kv(k_cache, k_new, rows, slots)
        write_kv(v_cache, v_new, rows, slots)
        return k_cache, v_cache
    B, T, K, hd = k_new.shape
    if dest is None:
        dest = kv_rows(rows, slots, k_cache.codes.shape[1], K)
    kops.block_quant_kv(k_new.reshape(B * T * K, hd).contiguous(),
                        v_new.reshape(B * T * K, hd).contiguous(), codebook,
                        block=hd, pack=codebook_bits(codebook) == 4,
                        out_k=(k_cache.codes, k_cache.scales),
                        out_v=(v_cache.codes, v_cache.scales), rows=dest)
    return k_cache, v_cache


def update_kv_cache(cache, new, pos, *, ring=False, codebook=None):
    """Write T new entries per batch row at that row's own position, **in
    place**: cache (B, S, K, hd) — or a :class:`QuantisedKV`, whose new rows
    are quantised at write time — is a view into the engine's (L, B, S, ...)
    stack, so the stack itself is updated. new: (B, T, K, hd); pos: (B,).
    Returns the cache."""
    S = (cache.codes if isinstance(cache, QuantisedKV) else cache).shape[1]
    rows, slots = cache_slots(pos, new.shape[1], S, ring=ring)
    return write_kv(cache, new, rows, slots, codebook)


class StepGeometry(NamedTuple):
    """What every layer of one cache group shares in one decode step, built
    once per step and group by :func:`step_geometry`."""
    rot: tuple                  # rope_tables: (cos, sin), each (B, T, 1, hd)
    positions: torch.Tensor     # (B, T) int32 query positions
    rows: torch.Tensor          # (B, 1) cache write rows
    slots: torch.Tensor         # (B, T) cache write slots
    window: int                 # 0 = global
    ring: bool
    mask: Optional[torch.Tensor]      # dense groups: (B, T, 1, 1, S)
    dest: Optional[torch.Tensor]      # quantised groups: kv_rows
    codebook: Optional[torch.Tensor]  # quantised groups: the KV codebook


def step_geometry(pos, positions, rot, S: int, *, window=0, ring=False,
                  kv_heads=1, codebook=None):
    """The group's cache write coordinates and, for a dense group, its
    attention mask; a quantised group (``codebook`` given) builds its masks
    inside ``decode_attention_quant`` and takes the flat write rows."""
    rows, slots = cache_slots(pos, positions.shape[1], S, ring=ring)
    if codebook is None:
        return StepGeometry(rot, positions, rows, slots, window, ring,
                            attention_mask(positions, S, window=window,
                                           ring=ring), None, None)
    return StepGeometry(rot, positions, rows, slots, window, ring, None,
                        kv_rows(rows, slots, S, kv_heads), codebook)


def attn_decode(x, p: AttnParams, k_cache, v_cache, geo: StepGeometry, cfg):
    """One attention sub-block of the decode step: project, write the new
    k/v into the caches in place (quantising them for a quantised group),
    attend, project out."""
    q, k_new, v_new = qkv_project(x, p, geo.rot, cfg)
    write_kv_pair(k_cache, v_cache, k_new, v_new, geo.rows, geo.slots,
                  geo.codebook, geo.dest)
    if geo.mask is not None:
        o = attend(q, k_cache, v_cache, geo.mask)
    else:
        o = chunked_decode_attention(q, k_cache, v_cache, geo.positions,
                                     window=geo.window, ring=geo.ring,
                                     codebook=geo.codebook)
    return linear(o, p.wo, "btnh,nhd->btd")


# ---------------------------------------------------------------------------
# Teacher-forcing attention (apply / prefill)
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, q_positions, k_positions, *, causal: bool = True,
                    window: int = 0, chunk: int = 1024, k_valid_len=None):
    """Chunked online-softmax attention over ``chunk`` keys at a time (never
    the full score matrix): the reference's ``lax.scan`` as a loop over the
    chunks, in its order and with its casts (scores in q's dtype, then f32;
    probabilities in v's dtype). Plain torch; autograd runs through it.

    q: (B, Tq, H, hd) with H = K·G; k, v: (B, Tk, K, hd); q_positions (Tq,)
    and k_positions (Tk,). window: 0 = global, > 0 = only keys within
    ``window``. k_valid_len: optional scalar or (B,) count of valid keys.
    Tk is padded to a multiple of the chunk with keys at position 2³⁰,
    which every query masks."""
    B, Tq, H, hd = q.shape
    Tk, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, Tq, K, G, hd)
    scale = hd ** -0.5
    chunk = min(chunk, Tk)
    pad = (-Tk) % chunk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_positions = torch.nn.functional.pad(k_positions, (0, pad),
                                              value=2 ** 30)
    valid = (None if k_valid_len is None else torch.as_tensor(
        k_valid_len, device=q.device).reshape(-1, 1, 1))
    m = torch.full((B, Tq, K, G), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Tq, K, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Tq, K, G, hd), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, Tk + pad, chunk):
        kc, vc = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        kp = k_positions[c0:c0 + chunk]
        s = torch.einsum("btkgh,bskh->btkgs", qg, kc.to(qg.dtype)) * scale
        s = s.float()
        mask = (kp < 2 ** 30)[None, None, :]                 # (1, 1, chunk)
        if causal:
            mask = mask & (q_positions[:, None] >= kp[None, :])
        if window > 0:
            mask = mask & (q_positions[:, None] - kp[None, :] < window)
        if valid is not None:
            mask = mask & (kp < valid)
        mask = mask.expand(-1, Tq, -1)[:, :, None, None, :]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "btkgs,bskh->btkgh", p.to(vc.dtype), vc).float()
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, Tq, H, hd).to(q.dtype)


def attn_block(x, p: AttnParams, positions, cfg, window: int = 0):
    """The training/prefill attention block (the caller adds the pre-norm
    residual): project, rotate by ``positions`` (T,), causal chunked
    attention over the whole sequence, project out."""
    rot = rope_tables(positions, cfg.hd, cfg.rope_theta)
    q, k, v = qkv_project(x, p, rot, cfg)
    o = flash_attention(q, k, v, positions, positions, causal=True,
                        window=window, chunk=cfg.attn_chunk)
    return linear(o, p.wo, "btnh,nhd->btd")


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

class MlpParams(NamedTuple):
    w_gate: torch.Tensor  # (D, F)
    w_up: torch.Tensor    # (D, F)
    w_down: torch.Tensor  # (F, D)


def swiglu(x, p: MlpParams):
    g = linear(x, p.w_gate, "btd,df->btf")
    u = linear(x, p.w_up, "btd,df->btf")
    h = torch.nn.functional.silu(g) * u
    return linear(h, p.w_down, "btf,fd->btd")


def gelu_mlp(x, w_in, w_out):
    """The GELU MLP (whisper): ``jax.nn.gelu``'s default, the tanh
    approximation."""
    h = torch.nn.functional.gelu(linear(x, w_in, "btd,df->btf"),
                                 approximate="tanh")
    return linear(h, w_out, "btf,fd->btd")


# ---------------------------------------------------------------------------
# Mixture of experts
# ---------------------------------------------------------------------------

class MoeParams(NamedTuple):
    w_router: torch.Tensor   # (D, E)
    w_gate: torch.Tensor     # (E, D, F)
    w_up: torch.Tensor       # (E, D, F)
    w_down: torch.Tensor     # (E, F, D)
    shared: Optional[MlpParams] = None


def route(probs, k: int):
    """The top ``k`` router probabilities of each token and their experts,
    in descending order with ties to the lower expert index (as
    ``jax.lax.top_k``; ``torch.topk`` promises no order for ties): a
    stable descending sort on every device. probs (N, E) -> (N, k) each."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def moe_block(x, p: MoeParams, cfg):
    """Top-k routed experts (plus shared experts): (out (B, T, D), the
    router's load-balancing loss). The reference's expert-parallel branch
    (``moe_block_ep``) is not ported: every call takes the local
    sort-dispatch path."""
    out, probs, choice = _moe_block_local(x, p, cfg)
    return out, router_load_balancing_loss(probs, choice, cfg.n_experts)


def moe_block_out(x, p: MoeParams, cfg):
    """``moe_block``'s output alone, for the decode step, which has no use
    for the loss: its launches are never made."""
    return _moe_block_local(x, p, cfg)[0]


def _moe_block_local(x, p: MoeParams, cfg):
    """Top-k routed experts with sort-based capacity dispatch, as the
    reference's: each expert takes at most ``cap = max(ceil(capacity_factor
    · k · N / E), 4)`` of its dispatches (N = B·T, padded rows included), in
    token order; the rest fall through to the residual (plus the shared
    experts). Returns (out (B, T, D), the router's probabilities (N, E) in
    f32, the experts chosen (N, k)): the load-balancing loss is made from
    the last two by ``moe_block``, for the callers that want it.

    Dispatch writes each kept dispatch's row to its (expert, rank) slot; the
    dropped ones all go to one spare row past the E·cap slots, which is cut
    off, so no slot sums two rows and nothing depends on write order. The
    combine adds each token's k weighted expert rows in choice order, the
    order of the reference's scatter-add."""
    B, T, D = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    N = B * T
    dev = x.device
    xt = x.reshape(N, D)
    logits = linear(xt[None], p.w_router, "btd,de->bte")[0]
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, choice = route(probs, k)                  # (N, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)        # renormalise
    expert_flat = choice.reshape(-1)                     # (N·k,)
    cap = max(math.ceil(cfg.capacity_factor * k * N / E), 4)

    # rank of each dispatch within its expert (stable sort by expert id)
    order = torch.argsort(expert_flat, stable=True)
    sorted_e = expert_flat[order]
    starts = torch.searchsorted(sorted_e, torch.arange(E, device=dev),
                                side="left")
    rank = torch.empty_like(expert_flat)
    rank[order] = torch.arange(N * k, device=dev) - starts[sorted_e]
    keep = rank < cap
    safe_rank = torch.where(keep, rank, cap - 1)

    # dispatch: (E, cap, D), dropped dispatches parked in row E·cap
    tok_idx = torch.arange(N * k, device=dev) // k
    slot = expert_flat * cap + safe_rank
    buf = torch.zeros((E * cap + 1, D), dtype=x.dtype, device=dev)
    buf[torch.where(keep, slot, E * cap)] = xt[tok_idx]
    buf = buf[:E * cap].view(E, cap, D)

    g = expert_matmul(buf, p.w_gate, "ecd,edf->ecf")
    u = expert_matmul(buf, p.w_up, "ecd,edf->ecf")
    h = torch.nn.functional.silu(g) * u
    y = expert_matmul(h, p.w_down, "ecf,efd->ecd")

    # combine: gather back, weight by the (renormalised) gate, sum a
    # token's k contributions in choice order
    y_tok = y.reshape(E * cap, D)[slot]                  # (N·k, D)
    w = torch.where(keep, gate_vals.reshape(-1), 0.0).to(x.dtype)
    contrib = (y_tok * w[:, None]).view(N, k, D)
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]

    out = out.reshape(B, T, D)
    if p.shared is not None:
        out = out + swiglu(x, p.shared)
    return out, probs, choice


def router_load_balancing_loss(probs, choice, E: int):
    """Switch-style auxiliary loss: E · Σ_e f_e · P_e (f_e the share of
    tokens whose first choice is e, P_e the mean router probability)."""
    onehot = torch.nn.functional.one_hot(choice[:, 0], E).float()
    f = onehot.mean(0)
    pbar = probs.mean(0)
    return E * torch.sum(f * pbar)


# ---------------------------------------------------------------------------
# Depthwise causal convolution (zamba2)
# ---------------------------------------------------------------------------

def causal_conv1d(x, w, state=None, n_valid=None):
    """Depthwise causal conv over time, as the reference's sum of shifted
    products (not ``F.conv1d``, whose cuDNN path may round through TF32 on
    the card). x: (B, T, C); w: (Kw, C). With ``state`` ((B, Kw-1, C))
    performs streaming decode; returns (y, new_state). ``n_valid`` ((B,)
    int32) marks how many leading tokens of each row are real (ragged
    chunks): the new state is then the Kw-1 inputs preceding each row's
    valid prefix end, so padding tokens never enter the streaming state (a
    row with n_valid=0 keeps its state)."""
    Kw = w.shape[0]
    T = x.shape[1]
    if state is None:
        xp = torch.nn.functional.pad(x, (0, 0, Kw - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = xp[:, 0:T] * w[0]
    for i in range(1, Kw):
        y = y + xp[:, i:i + T] * w[i]
    if Kw <= 1:
        new_state = None
    elif n_valid is None:
        new_state = xp[:, -(Kw - 1):]
    else:
        # row b's state = xp[b, n_valid[b] : n_valid[b] + Kw-1]
        idx = n_valid.long()[:, None] + torch.arange(Kw - 1,
                                                     device=x.device)
        new_state = torch.gather(
            xp, 1, idx[:, :, None].expand(-1, -1, xp.shape[2]))
    return y.to(x.dtype), new_state
