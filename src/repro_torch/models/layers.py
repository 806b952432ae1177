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

Multi-device hooks, set by the launchers (the dry run) and the identity
until then: ``set_activation_sharding`` / ``constrain_act`` and
``set_head_axis`` / ``constrain_heads`` redistribute DTensor activations
between blocks and over heads (a plain tensor passes through);
``set_ep_mesh`` routes ``moe_block`` through ``moe_block_ep``, per-rank
expert parallelism over a ``torch.distributed`` group.
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
    if _is_dtensor(x):
        return _linear_dtensor(x, w.to(x.dtype), spec)
    return torch.einsum(spec, x, w.to(x.dtype))


def _linear_dtensor(x, w, spec: str):
    """``linear`` of DTensors (the dry run): one matmul of x's flattened
    contraction dims against the weight flattened to 2-D
    (:func:`_matmul_laid_out`), whose output is split back into the
    weight's output dims by :func:`split_dim`. The einsum itself would
    flatten the output and shard it over a mesh axis wider than its leading
    output dim (4 heads on 16), and DTensor refuses to split that back.
    Heads split unevenly over x's contraction (:func:`_row_parallel`) are
    contracted by each rank against their own rows of the weight."""
    ins, out = spec.replace(" ", "").split("->")
    xs, ws = ins.split(",")
    contract = "".join(c for c in ws if c in xs and c not in out)
    wout = "".join(c for c in ws if c not in xs)
    n_k, n_o = len(contract), len(wout)
    if not (xs.endswith(contract) and out == xs[:-n_k] + wout):
        raise ValueError(f"spec {spec!r}: x must end with the contraction "
                         "and the output be x's leading dims and w's rest")
    out_shape = tuple(w.shape[ws.index(c)] for c in wout)
    if _row_parallel(x, x.ndim - n_k, n_k):
        own = own_heads(x, x.shape[-n_k], x.ndim - n_k)
        y = torch.einsum(spec, to_own(x, own, 0, x.ndim - n_k),
                         to_own(w, own, None, ws.index(contract[0])))
        return from_own(y, own, (*x.shape[:-n_k], *out_shape), 0,
                        partial=True)
    xf = _merge_dims(x, x.ndim - n_k, n_k)
    if _spec_orientation(spec) == "transposed":
        wf = _merge_dims(_merge_dims(w, n_o, n_k), 0, n_o)
        y = _matmul_laid_out(xf, wf, "...k,nk->...n", 1)
    else:
        wf = _merge_dims(_merge_dims(w, 0, n_k), 1, n_o)
        y = _matmul_laid_out(xf, wf, "...k,kn->...n", 0)
    return split_dim(y, y.ndim - 1, out_shape)


def _matmul_laid_out(x, w, spec: str, kdim: int):
    """``einsum(spec, x, w)`` of a DTensor x (..., K) and a 2-D weight
    whose contraction dim is ``kdim``, laid out per mesh dim as the
    reference's GSPMD layout: where x splits its batch, w is gathered
    there (FSDP); where w splits its output dim, x is gathered there
    (column-parallel); where either splits K, both split it and the
    outputs are partial sums (row-parallel); where x splits another leading
    dim (the sequence), w is gathered; where neither splits, the outputs
    are. Each rank multiplies its own blocks. DTensor's own choice, by its
    cost model, replicated whole products at some shapes (llama3-405b's
    MLP down projection at 32k)."""
    if not _is_dtensor(w):
        return torch.einsum(spec, x, w)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh, xk, nd = x.device_mesh, x.ndim - 1, 1 - kdim
    x_to, w_to, y_pl = [], [], []
    for i, (xq, wq) in enumerate(zip(x.placements, w.placements)):
        x_lead = isinstance(xq, Shard) and xq.dim != xk
        if xq == Shard(0):
            x_to.append(xq), w_to.append(Replicate()), y_pl.append(xq)
        elif isinstance(wq, Shard) and wq.dim == nd:
            x_to.append(Replicate()), w_to.append(wq)
            y_pl.append(Shard(xk))
        elif xq == Shard(xk) or wq == Shard(kdim) and not x_lead:
            x_to.append(Shard(xk)), w_to.append(Shard(kdim))
            y_pl.append(Partial())
        elif x_lead:
            x_to.append(xq), w_to.append(Replicate()), y_pl.append(xq)
        elif w.shape[nd] % mesh.size(i) == 0:
            # neither splits here: each rank takes a slice of the outputs
            x_to.append(Replicate()), w_to.append(Shard(nd))
            y_pl.append(Shard(xk))
        else:
            x_to.append(Replicate()), w_to.append(Replicate())
            y_pl.append(Replicate())

    def grads(to):   # a block used whole where the ranks' products differ
        return [q if isinstance(q, Shard) else
                Partial() if not isinstance(p, Replicate) else Replicate()
                for q, p in zip(to, y_pl)]
    xl = x.redistribute(mesh, x_to).to_local(grad_placements=grads(x_to))
    wl = w.redistribute(mesh, w_to).to_local(grad_placements=grads(w_to))
    shape = (*x.shape[:-1], w.shape[nd])
    return DTensor.from_local(torch.einsum(spec, xl, wl), mesh, y_pl,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def _row_parallel(x, d0: int, n: int) -> bool:
    """Does ``x`` split its leading contraction dim ``d0`` unevenly (heads
    that do not divide the head ranks) and no other of its ``n``? Then
    ``linear`` contracts each rank's own heads against their rows of the
    weight, and sums the ranks' partial outputs where they are next read:
    merging the dims would gather them."""
    if not _is_dtensor(x) or n == 1:
        return False
    from torch.distributed.tensor import Shard
    pl = x.placements
    on = [i for i, q in enumerate(pl)
          if isinstance(q, Shard) and d0 <= q.dim < d0 + n]
    return bool(on) and all(pl[i].dim == d0 for i in on) and \
        x.shape[d0] % math.prod(x.device_mesh.size(i) for i in on) != 0


def _merge_dims(t, d0: int, n: int):
    """``t`` with its dims ``d0 .. d0+n-1`` merged into one. DTensor merges
    a shard only of the leading merged dim and only an even one: a mesh
    axis sharding another merged dim, or the leading one unevenly, is
    gathered first."""
    shape = (*t.shape[:d0], -1, *t.shape[d0 + n:])
    if not _is_dtensor(t) or n == 1:
        return t.reshape(shape)
    from torch.distributed.tensor import Replicate, Shard
    pl, mesh = t.placements, t.device_mesh
    on = [i for i, q in enumerate(pl)
          if isinstance(q, Shard) and d0 <= q.dim < d0 + n]
    lead = [i for i in on if pl[i].dim == d0]
    gather = [i for i in on if pl[i].dim > d0]
    if t.shape[d0] % math.prod(mesh.size(i) for i in lead):
        gather += lead
    if gather:
        t = t.redistribute(mesh, [Replicate() if i in gather else q
                                  for i, q in enumerate(pl)])
    return _pin(t.reshape(shape))


def _pin(t):
    """A DTensor as it is laid out, through ``redistribute``: the gradient
    that comes back is laid out so too, so the backward of the reshape
    before it (a split or merge of the other way) meets the layout the
    forward checked, not whatever the next op's backward chose."""
    return t.redistribute(t.device_mesh, t.placements)


def split_dim(t, dim: int, sizes):
    """``t`` with dim ``dim`` split into ``sizes``. A DTensor sharded on
    that dim over mesh axes whose size does not divide ``sizes[0]`` (8 KV
    heads over 16 ranks) is gathered on those axes first: DTensor refuses
    to split an uneven shard."""
    if _is_dtensor(t) and len(sizes) > 1:
        from torch.distributed.tensor import Replicate, Shard
        pl = t.placements
        on = [i for i, q in enumerate(pl) if isinstance(q, Shard)
              and q.dim == dim]
        if sizes[0] % math.prod(t.device_mesh.size(i) for i in on):
            t = t.redistribute(t.device_mesh, [
                Replicate() if i in on else q for i, q in enumerate(pl)])
        return _pin(t.reshape(*t.shape[:dim], *sizes, *t.shape[dim + 1:]))
    return t.reshape(*t.shape[:dim], *sizes, *t.shape[dim + 1:])


# ---------------------------------------------------------------------------
# Each rank on its own heads (the dry run)
# ---------------------------------------------------------------------------

class OwnHeads(NamedTuple):
    """This rank's block of a layout whose dim 0 holds B batch rows and
    another dim H heads: rows ``b0 .. b0+nb-1`` over the mesh dims
    ``batch``, heads ``h0 .. h0+nh-1`` over the mesh dims ``heads``, as
    ``torch.chunk`` splits them (⌈H ÷ m⌉ a rank or fewer, the reference's
    padded head sharding)."""
    mesh: object
    batch: tuple
    heads: tuple
    B: int
    H: int
    b0: int
    nb: int
    h0: int
    nh: int


def own_heads(x, H: int, hdim: int) -> OwnHeads:
    """The block of DTensor ``x`` this rank computes on when its dim
    ``hdim`` holds H heads (of one or more elements each): batch rows as
    ``x`` splits dim 0 or, where it does not, over the activations' batch
    axes (``set_activation_sharding``); heads as it splits ``hdim`` or,
    where it does not, over the head axis (``set_head_axis``)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, pl = x.device_mesh, x.placements
    batch = tuple(i for i, q in enumerate(pl)
                  if isinstance(q, Shard) and q.dim == 0)
    heads = tuple(i for i, q in enumerate(pl)
                  if isinstance(q, Shard) and q.dim == hdim)
    names = mesh.mesh_dim_names or ()
    if not batch and _ACT_BATCH_AXES:
        batch = tuple(names.index(a) for a in _ACT_BATCH_AXES
                      if a in names and names.index(a) not in heads)
    if not heads and _HEAD_AXIS in names and \
            names.index(_HEAD_AXIS) not in batch:
        heads = (names.index(_HEAD_AXIS),)
    B = x.shape[0]
    place = [Shard(0) if i in batch else Shard(1) if i in heads
             else Replicate() for i in range(mesh.ndim)]
    shape, off = compute_local_shape_and_global_offset((B, H), mesh, place)
    return OwnHeads(mesh, batch, heads, B, H, off[0], shape[0], off[1],
                    shape[1])


def to_own(t, own: OwnHeads, bdim=0, hdim=None, unit: int = 1):
    """This rank's share of ``t``: rows ``b0 ..`` of dim ``bdim`` (None:
    all) and, of dim ``hdim`` (None: all), the ``unit`` elements of each of
    its heads. A DTensor is laid out once (already so, heads split over the
    head ranks where they divide evenly, else gathered and cut here); its
    gradient comes back as a partial sum over the ranks whose shares of it
    differ. A plain tensor is cut where it holds the whole batch."""
    if not _is_dtensor(t):
        if bdim is not None and own.nb != own.B and t.shape[bdim] == own.B:
            t = t.narrow(bdim, own.b0, own.nb)
        if hdim is not None:
            t = t.narrow(hdim, own.h0 * unit, own.nh * unit)
        return t
    from torch.distributed.tensor import Partial, Replicate, Shard
    m = math.prod(own.mesh.size(i) for i in own.heads)
    split = hdim is not None and (
        own.H % m == 0 or unit == 1 and all(t.placements[i] == Shard(hdim)
                                            for i in own.heads))
    place, grad = [], []
    for i in range(own.mesh.ndim):
        if i in own.batch and bdim is not None:
            place.append(Shard(bdim))
            grad.append(Shard(bdim))
        elif i in own.heads and split:
            place.append(Shard(hdim))
            grad.append(Shard(hdim))
        elif i in own.batch or i in own.heads:
            place.append(Replicate())
            grad.append(Partial())
        else:
            place.append(Replicate())
            grad.append(Replicate())
    local = t.redistribute(own.mesh, place).to_local(grad_placements=grad)
    if hdim is not None and not split:
        local = local.narrow(hdim, own.h0 * unit, own.nh * unit)
    return local


def from_own(local, own: OwnHeads, shape, bdim=0, hdim=None,
             partial=False):
    """A DTensor of global ``shape`` from this rank's ``local`` share:
    batch rows on ``bdim``, heads on ``hdim`` (uneven allowed), or a
    partial sum over the head ranks (``partial``)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    place = [Shard(bdim) if i in own.batch and bdim is not None else
             Shard(hdim) if i in own.heads and hdim is not None else
             Partial() if i in own.heads and partial else Replicate()
             for i in range(own.mesh.ndim)]
    return DTensor.from_local(local, own.mesh, place, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def _heads_gather(q, K: int, kv=None) -> bool:
    """Would DTensor gather ``q``'s heads to split them into (K, H ÷ K)?
    True where the mesh dims splitting its heads do not divide K, and the
    ``kv`` cache (if given) is not split over its positions: a cache
    split so keeps the split over S."""
    if not _is_dtensor(q):
        return False
    from torch.distributed.tensor import Shard
    on = [i for i, p in enumerate(q.placements)
          if isinstance(p, Shard) and p.dim == 2]
    if K % math.prod(q.device_mesh.size(i) for i in on) == 0:
        return False
    return not _is_dtensor(kv) or not any(
        isinstance(p, Shard) and p.dim == 1 for p in kv.placements)


def _on_own_heads(fn, q, k, v, *batched):
    """``fn(q, k, v, *batched)`` on this rank's own q heads (q (B, T, H,
    hd) a DTensor, k, v (B, S, K, hd)): each rank's q heads, the K/V heads
    they read (gathered over the head ranks, picked per q head, so ``fn``
    runs with G = 1), and its rows of the ``batched`` tensors (a scalar or
    None passes through); the output wrapped back with its heads split as
    q's."""
    H = q.shape[2]
    G = H // k.shape[2]
    own = own_heads(q, H, 2)
    ql = to_own(q, own, 0, 2)
    pick = torch.arange(own.h0, own.h0 + own.nh, device=ql.device) // G
    kl, vl = (to_own(c, own, 0)[:, :, pick] for c in (k, v))
    rest = [to_own(b, own, 0) if torch.is_tensor(b) and b.ndim else b
            for b in batched]
    if own.nh:
        out = fn(ql, kl, vl, *rest)
    else:   # no head here: the K/V stay in the graph, as on the other ranks
        out = ql + 0 * (kl.sum() + vl.sum()).to(ql.dtype)
    return from_own(out, own, q.shape, 0, 2)


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


# ---------------------------------------------------------------------------
# Activation sharding (set by the launcher: the dry run)
# ---------------------------------------------------------------------------

# Batch axes and the sequence-parallel axis of (batch, seq, ...) activations
# between blocks, and the mesh axis of attention heads. None until a
# launcher sets them; a plain tensor is never touched.
_ACT_BATCH_AXES = None   # e.g. ("pod", "data") or ("data",)
_ACT_SEQ_AXIS = None     # sequence parallelism: shard T between blocks
_HEAD_AXIS = None


def set_activation_sharding(batch_axes, seq_axis=None):
    """batch_axes: tuple of mesh axis names for the batch dim, or None.
    seq_axis: optional mesh axis for sequence parallelism between blocks."""
    global _ACT_BATCH_AXES, _ACT_SEQ_AXIS
    _ACT_BATCH_AXES = tuple(batch_axes) if batch_axes else None
    _ACT_SEQ_AXIS = seq_axis


def set_head_axis(axis):
    global _HEAD_AXIS
    _HEAD_AXIS = axis


def _batch_part():
    if not _ACT_BATCH_AXES:
        return None
    return (_ACT_BATCH_AXES[0] if len(_ACT_BATCH_AXES) == 1
            else _ACT_BATCH_AXES)


def _redistribute(x, spec):
    """A DTensor ``x`` laid out as the per-dim ``spec``; anything else
    unchanged."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from repro_torch.launch.mesh import placements_for
    return x.redistribute(x.device_mesh, placements_for(spec, x.device_mesh))


def constrain_act(x):
    """Lay out a (batch, seq, ...) activation between blocks: batch over the
    batch axes, T over the sequence axis when it divides by 16. The
    identity on a plain tensor or when nothing is set."""
    if _ACT_BATCH_AXES is None and _ACT_SEQ_AXIS is None:
        return x
    seq = _ACT_SEQ_AXIS if (x.ndim >= 3 and _ACT_SEQ_AXIS is not None
                            and x.shape[1] % 16 == 0) else None
    spec = ((_batch_part(), seq) + (None,) * (x.ndim - 2) if x.ndim >= 2
            else (_batch_part(),))
    return _redistribute(x, spec)


def constrain_heads(x):
    """x: (B, T, H, hd) — H over the head axis (uneven allowed), B over the
    batch axes. The identity on a plain tensor or when no axis is set."""
    if _HEAD_AXIS is None or x.shape[-2] <= 1:
        return x
    spec = (_batch_part(),) + (None,) * (x.ndim - 3) + (_HEAD_AXIS, None)
    return _redistribute(x, spec)


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
    if rot is not None:
        q, k = apply_rope(q, *rot), apply_rope(k, *rot)
    return constrain_heads(q), constrain_heads(k), constrain_heads(v)


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
    if _heads_gather(q, K, k_cache):
        return _on_own_heads(attend, q, k_cache, v_cache, mask)
    qg = split_dim(q, 2, (K, H // K))
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
    if _heads_gather(q, K, k_cache):
        return _on_own_heads(
            lambda q, k, v: decode_attention(
                q, k, v, q_position, window=window,
                kv_positions=kv_positions, ring=ring),
            q, k_cache, v_cache)
    qg = split_dim(q, 2, (K, H // K))[:, 0]
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
    elif _is_dtensor(cache):
        _write_local(cache, new, slots)
    else:
        cache[rows, slots] = new.to(cache.dtype)
    return cache


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _write_local(cache, new, slots):
    """The in-place write of :func:`write_kv` into a DTensor cache (B, S,
    K, hd) (the dry run), made by every rank into its own shard. The new
    entries are laid out as the cache on B and K and whole on T, their
    slots as the cache on B; a rank's rows are its batch shard's, in order
    (``cache_slots`` writes every row). On a cache split on S, a rank
    writes the entries whose slot falls in its range and rewrites the
    others' clamped targets with what they held, one token t at a time so
    that no two entries of a step share a target."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, pl = cache.device_mesh, cache.placements
    local = cache.to_local()
    _, off = compute_local_shape_and_global_offset(cache.shape, mesh, pl)
    new_l = new.to(cache.dtype).redistribute(mesh, [
        q if isinstance(q, Shard) and q.dim != 1 else Replicate()
        for q in pl]).to_local()
    slots_l = slots.redistribute(mesh, [
        q if isinstance(q, Shard) and q.dim == 0 else Replicate()
        for q in pl]).to_local() - off[1]
    S_loc = local.shape[1]
    rows = torch.arange(local.shape[0], device=local.device)
    for t in range(new_l.shape[1]):
        at = slots_l[:, t]
        mine = ((at >= 0) & (at < S_loc))[:, None, None]
        at = at.clamp(0, S_loc - 1)
        local[rows, at] = torch.where(mine, new_l[:, t], local[rows, at])


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
    if _heads_gather(q, K):
        return _on_own_heads(
            lambda q, k, v, valid: flash_attention(
                q, k, v, q_positions, k_positions,
                causal=causal, window=window, chunk=chunk,
                k_valid_len=valid),
            q, k, v, k_valid_len)
    G = H // K
    qg = split_dim(q, 2, (K, G))
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
    return linear(constrain_heads(o), p.wo, "btnh,nhd->btd")


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


# Expert-parallel execution context, set by the launcher (like activation
# sharding). When set, ``moe_block`` runs ``moe_block_ep``: experts are
# owned by the ranks of the model group, activations (replicated across the
# model group, split by batch over the batch axes) are routed on every rank
# to its own experts, and the expert outputs combine with one all-reduce
# over the model group — the collective cost of a dense tensor-parallel MLP.
class _EpContext(NamedTuple):
    group: object            # the model group's ProcessGroup
    batch_groups: tuple      # ProcessGroups of the batch axes (aux mean)
    batch_axes: tuple
    model_axis: str


_EP_MESH: Optional[_EpContext] = None
_EP_PACKED_FALLBACK_LOGGED = False


def set_ep_mesh(mesh_or_group, batch_axes, model_axis="model"):
    """Route ``moe_block`` through ``moe_block_ep`` over ``model_axis`` of a
    ``DeviceMesh`` (its ``batch_axes`` take part in the aux loss's mean), or
    over a bare ``ProcessGroup`` (every rank a model rank, no batch axes);
    ``None`` turns it off."""
    global _EP_MESH
    batch_axes = tuple(batch_axes) if batch_axes else ()
    if mesh_or_group is None:
        _EP_MESH = None
    elif getattr(mesh_or_group, "mesh_dim_names", None) is None:
        if batch_axes:
            raise ValueError("batch axes need a DeviceMesh, not a bare "
                             "process group")
        _EP_MESH = _EpContext(mesh_or_group, (), (), model_axis)
    else:
        mesh = mesh_or_group
        _EP_MESH = _EpContext(mesh.get_group(model_axis),
                              tuple(mesh.get_group(a) for a in batch_axes),
                              batch_axes, model_axis)


def _ep_route(p: MoeParams) -> bool:
    """Take ``moe_block_ep``? Packed expert stacks keep the local
    sort-dispatch path (the EP path pads and casts expert weights, which
    would densify the codes), and say so once: ``dequant_matmul``'s lead dim
    still carries them."""
    global _EP_PACKED_FALLBACK_LOGGED
    if _EP_MESH is None:
        return False
    if not any(isinstance(w, PackedTensor)
               for w in (p.w_gate, p.w_up, p.w_down)):
        return True
    if not _EP_PACKED_FALLBACK_LOGGED:
        _EP_PACKED_FALLBACK_LOGGED = True
        print("[moe] packed expert stacks: the expert-parallel path falls "
              "back to local sort-dispatch (packed expert-parallel dispatch "
              "is a recorded follow-up)")
    return False


def moe_block(x, p: MoeParams, cfg):
    """Top-k routed experts (plus shared experts): (out (B, T, D), the
    router's load-balancing loss). Under ``set_ep_mesh`` dense expert
    stacks take ``moe_block_ep``; otherwise (and for packed stacks) the
    local sort-dispatch path."""
    if _ep_route(p):
        return moe_block_ep(x, p, cfg)
    out, probs, choice = _moe_block_local(x, p, cfg)
    return out, router_load_balancing_loss(probs, choice, cfg.n_experts)


def moe_block_out(x, p: MoeParams, cfg):
    """``moe_block``'s output alone, for the decode step, which has no use
    for the loss: on the local path its launches are never made."""
    if _ep_route(p):
        return moe_block_ep(x, p, cfg)[0]
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


def moe_block_ep(x, p: MoeParams, cfg):
    """Expert parallelism over the ``set_ep_mesh`` model group, run by every
    rank on its own tokens (the reference's ``shard_map`` body). E pads to
    ``E_pad``, a multiple of the group size M; dummy experts get ``NEG_INF``
    router logits; rank m owns experts ``[m·E_loc, (m+1)·E_loc)``. Each
    rank routes all its tokens, keeps the dispatches to its experts (at most
    ``cap = max(ceil(capacity_factor·k·N/E), 4)`` each, N the rank's tokens,
    ranked by a stable sort within each local expert), runs three
    ``expert_matmul`` and sums its weighted rows; one all-reduce over the
    group combines them. The aux loss is averaged over the model group and
    the batch axes.

    ``x`` (B, T, D) is a plain tensor, the same on every rank of the group
    (the batch split is the caller's), or a DTensor (the dry run): it is
    laid out batch over the batch axes and replicated over the model axis,
    and the local rows are computed on. Expert stacks are plain (E, D, F)
    on every rank, or DTensors; either way a rank reads only its slice."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol

    ctx = _EP_MESH
    M, m = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
    E, k = cfg.n_experts, cfg.experts_per_token
    E_pad = -(-E // M) * M
    E_loc = E_pad // M
    xl, wrap = _ep_local(x, ctx)
    dt = xl.dtype
    wr = _ep_whole(p.w_router).to(dt)
    if E_pad != E:
        wr = torch.nn.functional.pad(wr, (0, E_pad - E))
    wg, wu, wd = (_ep_expert_slice(w, m, M, E, E_loc, dt)
                  for w in (p.w_gate, p.w_up, p.w_down))

    Bl, Tl, D = xl.shape
    N = Bl * Tl
    dev = xl.device
    xt = xl.reshape(N, D)
    logits = linear(xt[None], wr, "btd,de->bte")[0].float()
    if E_pad != E:  # mask dummy experts
        logits = logits.masked_fill(torch.arange(E_pad, device=dev) >= E,
                                    NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, choice = route(probs, k)                  # (N, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    local_e = choice.reshape(-1) - m * E_loc             # (N·k,)
    mine = (local_e >= 0) & (local_e < E_loc)
    key = torch.where(mine, local_e, E_loc)              # others sort last
    cap = max(math.ceil(cfg.capacity_factor * k * N / E), 4)

    # rank of each dispatch within its local expert (stable sort)
    order = torch.argsort(key, stable=True)
    sorted_e = key[order]
    starts = torch.searchsorted(sorted_e, torch.arange(E_loc, device=dev),
                                side="left")
    rank = torch.empty_like(key)
    rank[order] = (torch.arange(N * k, device=dev)
                   - starts[sorted_e.clamp(max=E_loc - 1)])
    keep = mine & (rank < cap)
    safe_rank = torch.where(keep, rank, cap - 1)

    # dispatch: (E_loc, cap, D), the rest parked in row E_loc·cap
    tok_idx = torch.arange(N * k, device=dev) // k
    slot = local_e.clamp(0, E_loc - 1) * cap + safe_rank
    buf = torch.zeros((E_loc * cap + 1, D), dtype=dt, device=dev)
    buf[torch.where(keep, slot, E_loc * cap)] = xt[tok_idx]
    buf = buf[:E_loc * cap].view(E_loc, cap, D)

    g = expert_matmul(buf, wg, "ecd,edf->ecf")
    u = expert_matmul(buf, wu, "ecd,edf->ecf")
    h = torch.nn.functional.silu(g) * u
    y = expert_matmul(h, wd, "ecf,efd->ecd")

    # this rank's weighted rows in choice order, then the sum over ranks
    y_tok = y.reshape(E_loc * cap, D)[slot]
    w = torch.where(keep, gate_vals.reshape(-1), 0.0).to(dt)
    contrib = (y_tok * w[:, None]).view(N, k, D)
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
    out = funcol.all_reduce(out, "sum", ctx.group)

    aux = router_load_balancing_loss(probs[:, :E], choice, E)
    for grp in (ctx.group,) + ctx.batch_groups:
        aux = funcol.all_reduce(aux, "sum", grp) / dist.get_world_size(grp)
    out, aux = wrap(out.reshape(Bl, Tl, D), aux)
    if p.shared is not None:
        out = out + swiglu(x, p.shared)
    return out, aux


def _ep_local(x, ctx: _EpContext):
    """This rank's tokens of ``x``, and how to wrap (out, aux) back: the
    identity for a plain tensor; for a DTensor, batch over the batch axes,
    replicated over the model axis, ``out`` in that layout and ``aux``
    replicated."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x, lambda out, aux: (out, aux)
    from repro_torch.launch.mesh import placements_for
    mesh = x.device_mesh
    bax = (None if not ctx.batch_axes else ctx.batch_axes[0]
           if len(ctx.batch_axes) == 1 else ctx.batch_axes)
    pl = placements_for((bax, None, None), mesh)
    shape, stride = x.shape, x.stride()

    def wrap(out, aux):
        return (DTensor.from_local(out, mesh, pl, run_check=False,
                                   shape=shape, stride=stride),
                DTensor.from_local(aux, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False))
    return x.redistribute(mesh, pl).to_local(), wrap


def _ep_whole(w):
    """The whole of ``w`` on this rank (a DTensor is replicated first)."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(w, DTensor):
        return w.redistribute(w.device_mesh,
                              [Replicate()] * w.device_mesh.ndim).to_local()
    return w


def _ep_expert_slice(w, m: int, M: int, E: int, E_loc: int, dt):
    """Rank ``m``'s experts ``[m·E_loc, (m+1)·E_loc)`` of a stack (E, ·, ·)
    padded with zero experts to M·E_loc, in ``dt``. A DTensor stack is cast
    first (it then moves ``dt`` bytes); one whose E splits evenly over M is
    laid out E over the model axis and read locally."""
    from torch.distributed.tensor import DTensor
    if isinstance(w, DTensor):
        w = w.to(dt)
        if E == M * E_loc:
            from repro_torch.launch.mesh import placements_for
            return w.redistribute(w.device_mesh, placements_for(
                (_EP_MESH.model_axis, None, None), w.device_mesh)).to_local()
        w = _ep_whole(w)
    lo = m * E_loc
    part = w[lo:max(lo, min(lo + E_loc, E))].to(dt)
    if part.shape[0] < E_loc:
        part = torch.nn.functional.pad(
            part, (0, 0, 0, 0, 0, E_loc - part.shape[0]))
    return part


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
