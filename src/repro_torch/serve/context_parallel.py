"""Context-parallel flash-decode: attention of one query token against a
sequence-sharded KV cache, combined with the log-sum-exp trick.

For long_500k (batch=1) the KV cache is the entire working set; sharding it
over a group of ranks turns one 500k-token read into 16 parallel 32k reads.
Each shard computes a *partial* softmax (local max m, local normaliser l,
local weighted values acc); the exact combine is

    m* = max_i m_i ;  l* = Σ_i l_i·e^{m_i−m*} ;  out = Σ_i acc_i·e^{m_i−m*} / l*

— one small all-gather of (m, l, acc) per layer instead of moving the
cache. ``partial_attention`` and ``combine_partials`` are the pure math (f32,
the reference's masking; the finite ``NEG`` keeps a fully masked shard free
of NaN); ``cp_decode_attention`` runs it per rank over a
``torch.distributed`` group. The reference's ``shard_map_compat`` (a JAX
version shim around ``shard_map``) has no counterpart: each rank calls
``cp_decode_attention`` on its own slice.
"""
from __future__ import annotations

import torch

NEG = -1e30


def partial_attention(q, k, v, kv_positions, q_position, window=0):
    """One shard's partial attention. q: (B, 1, H, hd); k/v: (B, S_loc, K,
    hd); kv_positions (S_loc,). Returns (m, l, acc): (B, K, G), (B, K, G),
    (B, K, G, hd), all f32."""
    B, _, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg, k.to(qg.dtype))
    s = s.float() * hd ** -0.5
    qp = torch.as_tensor(q_position, device=q.device)
    mask = kv_positions <= qp
    if window > 0:
        mask = mask & (qp - kv_positions < window)
    s = s.masked_fill(~mask, NEG)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgs,bskh->bkgh", p.to(v.dtype), v)
    return m, l, acc.float()


def combine_partials(m, l, acc):
    """Combine partials along a leading shard axis. m/l: (S, B, K, G);
    acc: (S, B, K, G, hd) → (B, K, G, hd)."""
    m_star = m.amax(dim=0)
    corr = torch.exp(m - m_star[None])
    l_star = (l * corr).sum(dim=0)
    out = (acc * corr[..., None]).sum(dim=0)
    return out / torch.clamp(l_star[..., None], min=1e-30)


def cp_decode_attention(q, k_local, v_local, q_position, group, window=0):
    """Decode attention with the KV sequence sharded over ``group``: rank r
    holds positions ``[r·S_loc, (r+1)·S_loc)``. q: (B, 1, H, hd), the same
    on every rank; k_local/v_local: (B, S_loc, K, hd), this rank's slice (a
    DTensor sharded on S is read through ``to_local()``). The partials
    (m, l, acc) travel in one ``all_gather_into_tensor`` over the group and
    every rank combines them. Exact (== unsharded attention)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(q, DTensor):
        q = q.redistribute(q.device_mesh,
                           [Replicate()] * q.device_mesh.ndim).to_local()
    if isinstance(k_local, DTensor):
        k_local, v_local = k_local.to_local(), v_local.to_local()
    B, _, H, hd = q.shape
    S_loc = k_local.shape[1]
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    kv_pos = rank * S_loc + torch.arange(S_loc, device=q.device)
    m, l, acc = partial_attention(q, k_local, v_local, kv_pos, q_position,
                                  window)
    packed = torch.cat([m[..., None], l[..., None], acc], dim=-1)
    parts = packed.new_empty((n * B,) + packed.shape[1:])
    dist.all_gather_into_tensor(parts, packed, group=group)
    parts = parts.view((n,) + packed.shape)
    out = combine_partials(parts[..., 0], parts[..., 1], parts[..., 2:])
    return out.reshape(B, 1, H, hd).to(q.dtype)
