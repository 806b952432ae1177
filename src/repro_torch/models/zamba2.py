"""Zamba2 (arXiv:2411.15242), as the reference's ``repro/models/zamba2.py``
computes it: a Mamba-2 SSM backbone with a **shared** full-attention
transformer block applied after every ``attn_every`` Mamba layers.

Mamba-2 layer (SSD, scalar decay per head), state h ∈ R^{H×hd×N}:
    h_t = a_t·h_{t-1} + (Δ_t x_t) ⊗ B_t ,   y_t = h_t C_t + D⊙x_t
with a_t = exp(-exp(A_log)·Δ_t). The Mamba parameters are stacked (G, P,
...) over G groups of P layers; the shared block's are unstacked (true
weight sharing). The SSD recurrence is plain torch in f32 (``ssd_scan``
one step at a time, ``ssd_chunked`` the block-parallel form; the
reference's is plain jnp, not a TPU kernel), and so is the depthwise
``layers.causal_conv1d``.

Serving carries per-slot conv and SSM state (returned as new tensors) and
the shared block's KV cache: one global group whose "layers" are the G
application points (``cache_spec``, ``layer_axis="groups"``), dense or
q8/q4. The shared block's decode goes through ``layers.step_geometry`` /
``attn_decode`` / ``write_kv_pair``, as the transformer's does, so a
quantised cache is written by ``block_quant_kv`` and read by
``decode_attention_quant``. ``in_proj`` (output 2·d_inner + 2·N + H, no
multiple of 64) is left dense by the packing plan, as the reference leaves
it; ``out_proj`` packs with two lead dims, and a layer's view of it runs
``dequant_matmul``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .api import (ModelConfig, ModelFamily, ParamSpec, init_from_specs,
                  register_family, ring_prologue, torch_dtype)
from .layers import (AttnParams, MlpParams, QuantisedKV, attn_block,
                     attn_decode, causal_conv1d, constrain_act, embed_lookup,
                     linear, rms_norm, rope_tables, step_geometry, swiglu)
from .transformer import _at, _layer
from .whisper import _loop

SSM_HEAD_DIM = 64


def _dims(cfg: ModelConfig):
    di = cfg.dinner
    H = di // SSM_HEAD_DIM
    N = cfg.ssm_state or 64
    return di, H, N


def _groups(cfg: ModelConfig):
    per = cfg.attn_every or 6
    assert cfg.n_layers % per == 0, "n_layers must divide by attn_every"
    return cfg.n_layers // per, per


def mamba_param_specs(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    di, H, N = _dims(cfg)
    G, P = _groups(cfg)
    pd = cfg.param_dtype
    proj_out = 2 * di + 2 * N + H  # [z, x, B, C, dt]
    gx = lambda *s: ("groups", "layers") + tuple(s)
    return {
        "norm": ParamSpec((G, P, D), gx(None), pd),
        "in_proj": ParamSpec((G, P, D, proj_out), gx("fsdp", "heads_flat"), pd),
        "conv_w": ParamSpec((G, P, cfg.conv_kernel, di + 2 * N),
                            gx(None, None), pd),
        "A_log": ParamSpec((G, P, H), gx(None), pd),
        "D_skip": ParamSpec((G, P, H), gx(None), pd),
        "dt_bias": ParamSpec((G, P, H), gx(None), pd),
        "gate_norm": ParamSpec((G, P, di), gx(None), pd),
        "out_proj": ParamSpec((G, P, di, D), gx("heads_flat", "fsdp"), pd),
    }


def shared_block_specs(cfg: ModelConfig) -> dict:
    """One shared transformer block (attention + SwiGLU)."""
    D, Hq, hd, F_ = cfg.d_model, cfg.n_heads, cfg.hd, cfg.d_ff
    K = cfg.n_kv_heads
    pd = cfg.param_dtype
    return {
        "attn_norm": ParamSpec((D,), (None,), pd),
        "wq": ParamSpec((D, Hq, hd), ("fsdp", "heads", None), pd),
        "wk": ParamSpec((D, K, hd), ("fsdp", "kv_heads", None), pd),
        "wv": ParamSpec((D, K, hd), ("fsdp", "kv_heads", None), pd),
        "wo": ParamSpec((Hq, hd, D), ("heads", None, "fsdp"), pd),
        "mlp_norm": ParamSpec((D,), (None,), pd),
        "w_gate": ParamSpec((D, F_), ("fsdp", "mlp"), pd),
        "w_up": ParamSpec((D, F_), ("fsdp", "mlp"), pd),
        "w_down": ParamSpec((F_, D), ("mlp", "fsdp"), pd),
    }


def param_specs(cfg: ModelConfig) -> dict:
    pd = cfg.param_dtype
    return {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "fsdp"), pd),
        "mamba": mamba_param_specs(cfg),
        "shared": shared_block_specs(cfg),
        "final_norm": ParamSpec((cfg.d_model,), (None,), pd),
        "unembed": ParamSpec((cfg.d_model, cfg.vocab), ("fsdp", "vocab"), pd),
    }


# ---------------------------------------------------------------- SSD core

def ssd_scan(x, dt, a, Bm, Cm, h0=None):
    """x: (B, T, H, hd); dt, a: (B, T, H); Bm, Cm: (B, T, N), one step at a
    time in f32. Returns (y (B, T, H, hd) in x's dtype, h_final (B, H, hd,
    N) f32)."""
    B, T, H, hd = x.shape
    N = Bm.shape[-1]
    h = (torch.zeros((B, H, hd, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(T):
        dx = (dt[:, t, :, None] * x[:, t]).float()            # (B, H, hd)
        h = a[:, t, :, None, None].float() * h + \
            dx[..., :, None] * Bm[:, t, None, None, :].float()
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t].float()))
    return torch.stack(ys, dim=1).to(x.dtype), h


def ssd_chunked(x, dt, a, Bm, Cm, h0=None, chunk: int = 32):
    """Block-parallel SSD (Mamba-2's matmul form). x: (B, T, H, hd); dt, a:
    (B, T, H); Bm, Cm: (B, T, N). The state is touched once per chunk; all
    inner math in f32, log-decays floored at -20 a step and -80 cumulative
    a chunk (exp(±80) is f32-safe, and a chunk of ≤ 4 steps never reaches
    the floor), as the reference's. Matches :func:`ssd_scan`."""
    B, T, H, hd = x.shape
    N = Bm.shape[-1]
    assert T % chunk == 0
    C, n = chunk, T // chunk
    f32 = torch.float32
    xc = x.to(f32).reshape(B, n, C, H, hd)
    dtc = dt.to(f32).reshape(B, n, C, H)
    Bc = Bm.to(f32).reshape(B, n, C, N)
    Cc = Cm.to(f32).reshape(B, n, C, N)
    la = torch.clamp(torch.log(torch.clamp(a.to(f32), min=1e-38)),
                     -20.0, 0.0).reshape(B, n, C, H)
    ca = torch.clamp(torch.cumsum(la, dim=2), min=-80.0)     # inclusive
    h = (torch.zeros((B, H, hd, N), dtype=f32, device=x.device)
         if h0 is None else h0.to(f32))

    # intra-chunk: scores[t,s] = (C_t·B_s)·exp(ca_t − ca_s)·dt_s, s ≤ t
    CB = torch.einsum("bntN,bnsN->bnts", Cc, Bc)
    Et = torch.exp(ca).permute(0, 1, 3, 2)                 # (B, n, H, C)
    Esi = (torch.exp(-ca) * dtc).permute(0, 1, 3, 2)
    scores = CB[:, :, None] * Et[..., :, None] * Esi[..., None, :]
    mask = torch.tril(torch.ones((C, C), dtype=torch.bool, device=x.device))
    scores = torch.where(mask, scores, 0.0)
    y_intra = torch.einsum("bnhts,bnshp->bnthp", scores, xc)

    # inter-chunk state recurrence
    a_tot = torch.exp(ca[:, :, -1])                        # (B, n, H)
    k_rem = torch.exp(ca[:, :, -1:, :] - ca) * dtc         # (B, n, C, H)
    ys = []
    for c in range(n):
        ys.append(torch.einsum("btN,bhpN->bthp", Cc[:, c], h) *
                  torch.exp(ca[:, c])[..., None])
        h = a_tot[:, c][:, :, None, None] * h + torch.einsum(
            "bth,bthp,btN->bhpN", k_rem[:, c], xc[:, c], Bc[:, c])
    y = y_intra + torch.stack(ys, dim=1)
    return y.reshape(B, T, H, hd).to(x.dtype), h


def mamba_layer(x, lp, cfg, conv_state=None, ssm_state=None, valid=None):
    """Returns (out, (new_conv_state, new_ssm_state)). ``valid`` ((B, T)
    bool) masks ragged-chunk padding out of the streaming state: invalid
    steps get dt=0 / a=1 (the SSD identity update) and the conv state
    advances only past each row's valid prefix."""
    Bsz, T, D = x.shape
    di, H, N = _dims(cfg)
    dt_ = x.dtype
    zxbcdt = linear(x, lp["in_proj"], "btd,de->bte")
    z, xc, Bm, Cm, dt = torch.split(zxbcdt, [di, di, N, N, H], dim=-1)
    xbc = torch.cat([xc, Bm, Cm], dim=-1)
    n_valid = None if valid is None else valid.sum(1).to(torch.int32)
    xbc, conv_new = causal_conv1d(xbc, lp["conv_w"].to(dt_), conv_state,
                                  n_valid=n_valid)
    xbc = F.silu(xbc)
    xc, Bm, Cm = torch.split(xbc, [di, N, N], dim=-1)
    xh = xc.reshape(Bsz, T, H, SSM_HEAD_DIM)
    dt = F.softplus(dt.float() + lp["dt_bias"].float())
    a = torch.exp(-torch.exp(lp["A_log"].float()) * dt)
    if valid is not None:
        vm = valid[..., None]                 # (B, T, 1) over heads
        dt = torch.where(vm, dt, 0.0)         # Δx -> 0: no state injection
        a = torch.where(vm, a, 1.0)           # decay 1: h untouched
    ck = cfg.linear_chunk
    if ssm_state is None:
        use_chunked = bool(ck and T > ck and T % ck == 0)
        chunk = ck
    else:
        # serving: a multi-token chunk runs the block-parallel form seeded
        # with the carried state, at an inner chunk of at most 4 so the
        # cumulative log-decay (≥ -20 a step) never reaches the -80 floor
        chunk = next((c for c in (4, 3, 2) if T % c == 0), 1)
        use_chunked = T > 1 and chunk > 1
    args = (xh, dt.to(dt_), a.to(dt_), Bm, Cm, ssm_state)
    y, ssm_new = (ssd_chunked(*args, chunk=chunk) if use_chunked
                  else ssd_scan(*args))
    y = y + lp["D_skip"].to(dt_)[None, None, :, None] * xh
    y = y.reshape(Bsz, T, di)
    # gated RMSNorm (Mamba-2): norm(y) * silu(z)
    y = rms_norm(y, lp["gate_norm"], cfg.norm_eps) * F.silu(z)
    out = linear(y.to(dt_), lp["out_proj"], "bte,ed->btd")
    return out, (conv_new, ssm_new)


def _attn_params(sp) -> AttnParams:
    return AttnParams(sp["wq"], sp["wk"], sp["wv"], sp["wo"])


def _mlp_params(sp) -> MlpParams:
    return MlpParams(sp["w_gate"], sp["w_up"], sp["w_down"])


def _shared_attn_block(x, sp, positions, cfg):
    h = rms_norm(x, sp["attn_norm"], cfg.norm_eps)
    x = x + attn_block(h, _attn_params(sp), positions, cfg, window=0)
    h = rms_norm(x, sp["mlp_norm"], cfg.norm_eps)
    return x + swiglu(h, _mlp_params(sp))


def _group(cfg):
    """One group: its P Mamba layers, then the shared block."""
    def body(x, gp, shared, positions):
        for j in range(_groups(cfg)[1]):
            lp = _layer(gp, j)
            x = constrain_act(x)
            h, _ = mamba_layer(rms_norm(x, lp["norm"], cfg.norm_eps), lp, cfg)
            x = constrain_act(x + h)
        return constrain_act(_shared_attn_block(x, shared, positions, cfg))
    return body


def apply(params, batch, cfg: ModelConfig):
    """Teacher-forcing forward: batch {"tokens": (B, T)} -> f32 logits
    (B, T, V). Each group is rematerialised under autograd when
    ``cfg.remat`` asks."""
    tokens = batch["tokens"]
    x = embed_lookup(params["embed"], tokens, dtype=torch_dtype(cfg.dtype))
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = _loop(cfg, _group(cfg), x, params["mamba"], _groups(cfg)[0],
              params["shared"], positions)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return linear(x, params["unembed"], "btd,dv->btv").float()


# ---------------------------------------------------------------- decode

def cache_spec(cfg: ModelConfig, batch_size: int, kv_len: int,
               slack: int = 0, windowed: bool = True):
    """The shared attention's cache geometry: one full-length global group
    whose "layers" are the G application points (stacked on the ``groups``
    axis)."""
    from repro_torch.serve.cache import build_cache_spec
    G, _ = _groups(cfg)
    return build_cache_spec(
        np.zeros(G, np.int32), batch_size, kv_len, slack=slack,
        kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        dtype=cfg.kv_dtype or cfg.dtype, windowed=windowed,
        layer_axis="groups", formats=cfg.kv_format)


def decode_state_specs(cfg: ModelConfig, batch_size: int, kv_len: int,
                       slack: int = 0, windowed: bool = True) -> dict:
    di, H, N = _dims(cfg)
    G, P = _groups(cfg)
    return {
        "conv": ParamSpec((G, P, batch_size, cfg.conv_kernel - 1, di + 2 * N),
                          ("groups", "layers", "batch", None, None),
                          cfg.dtype),
        "ssm": ParamSpec((G, P, batch_size, H, SSM_HEAD_DIM, N),
                         ("groups", "layers", "batch", "heads", None, None),
                         "float32"),
        # the shared attention's KV cache, one per application point
        **cache_spec(cfg, batch_size, kv_len, slack, windowed).state_specs(),
        "pos": ParamSpec((batch_size,), ("batch",), "int32"),
    }


def decode_step(params, state, batch, cfg: ModelConfig):
    """Ragged decode step. batch: {"tokens": (B, T), "t_valid": optional
    (B,) advance counts, "reset": optional (B,) mask}. T>1 is batched
    chunked prefill through ``ssd_chunked``; each row's conv/ssm state and
    KV position advance by exactly ``t_valid[b]``, with padding masked out
    of the state updates. ``reset`` zeroes a slot's conv/ssm state and
    shared-attention KV rows (codes and scales of a quantised cache) in the
    prologue. The KV cache is written in place; conv and ssm come back as
    new tensors. Returns (logits (B, T, V) float32, state)."""
    from repro_torch.serve.cache import kv_codebook, parse_kv_formats
    tokens = batch["tokens"]
    B, T = tokens.shape
    dev = tokens.device
    dt_ = torch_dtype(cfg.dtype)
    G, P = _groups(cfg)
    fmts = parse_kv_formats(cfg.kv_format, 1, cfg.hd)
    pos, adv, valid, st = ring_prologue(
        state, batch, 1, extra_reset={"conv": 2, "ssm": 2}, formats=fmts)
    if fmts[0] == "f32":
        cb = None
        k_s, v_s = st["k0"], st["v0"]
    else:
        cb = kv_codebook(fmts[0], dev)
        k_s = QuantisedKV(st["k0"], st["k0s"])
        v_s = QuantisedKV(st["v0"], st["v0s"])
    x = embed_lookup(params["embed"], tokens, dtype=dt_)
    positions = pos[:, None] + torch.arange(T, dtype=torch.int32,
                                            device=dev)[None]
    rot = rope_tables(positions, cfg.hd, cfg.rope_theta)
    geo = step_geometry(pos, positions, rot, st["k0"].shape[2],
                        kv_heads=cfg.n_kv_heads, codebook=cb)
    shared = params["shared"]
    convs, ssms = [], []
    for g in range(G):
        gp = _layer(params["mamba"], g)
        for j in range(P):
            lp = _layer(gp, j)
            cs = st["conv"][g, j]
            h, (cs_new, ss_new) = mamba_layer(
                rms_norm(x, lp["norm"], cfg.norm_eps), lp, cfg,
                conv_state=cs, ssm_state=st["ssm"][g, j], valid=valid)
            x = x + h
            convs.append(cs_new.to(cs.dtype))
            ssms.append(ss_new)
        h = rms_norm(x, shared["attn_norm"], cfg.norm_eps)
        x = x + attn_decode(h, _attn_params(shared), _at(k_s, g),
                            _at(v_s, g), geo, cfg)
        h = rms_norm(x, shared["mlp_norm"], cfg.norm_eps)
        x = x + swiglu(h, _mlp_params(shared))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = linear(x, params["unembed"], "btd,dv->btv")
    new_state = {**st, "pos": pos + adv,
                 "conv": torch.stack(convs).unflatten(0, (G, P)),
                 "ssm": torch.stack(ssms).unflatten(0, (G, P))}
    return logits.float(), new_state


def _np_overrides(cfg: ModelConfig) -> dict:
    """The reference ``init``'s numpy leaves, drawn from
    ``np.random.default_rng(0)`` in its order (A_log, dt_bias, conv_w), and
    D_skip = 1: f32 arrays by leaf path."""
    G, P = _groups(cfg)
    di, H, N = _dims(cfg)
    rng = np.random.default_rng(0)
    a_log = np.log(rng.uniform(1, 16, (G, P, H)))
    dt_bias = np.log(np.expm1(rng.uniform(1e-3, 0.1, (G, P, H))))
    conv_w = rng.normal(0, 0.1, (G, P, cfg.conv_kernel, di + 2 * N))
    return {"['mamba']['A_log']": a_log, "['mamba']['dt_bias']": dt_bias,
            "['mamba']['D_skip']": np.ones((G, P, H)),
            "['mamba']['conv_w']": conv_w}


_OVERRIDDEN = {f"['mamba']['{n}']" for n in ("A_log", "dt_bias", "D_skip",
                                                "conv_w")}


def finish_leaf(cfg: ModelConfig, path: str, leaf):
    """The reference ``init``'s own leaves (``_np_overrides``), bit for bit;
    every other leaf is the generic draw."""
    if path not in _OVERRIDDEN:
        return leaf
    return torch.from_numpy(_np_overrides(cfg)[path].astype(np.float32)).to(
        leaf.device)


def init(cfg: ModelConfig, *, seed: int = 0, device=None):
    """Seeded random parameters on ``device`` (default the card), with the
    reference's SSM vectors and conv taps (:func:`finish_leaf`)."""
    return init_from_specs(param_specs(cfg), seed=seed, device=device,
                           finish=lambda p, a: finish_leaf(cfg, p, a))


def pack_layouts(cfg: ModelConfig) -> dict:
    """Packed-serving layouts. Mamba in/out projections carry two lead
    dims (groups, layers); the decode loop slices both off before
    ``linear`` sees the 2-D codes. The depthwise conv and the per-head SSM
    vectors are not matmuls; the shared block is unstacked (0 lead
    dims)."""
    return {
        "['mamba']['in_proj']": (2, 1),
        "['mamba']['out_proj']": (2, 1),
        "['shared']['wq']": (0, 1),
        "['shared']['wk']": (0, 1),
        "['shared']['wv']": (0, 1),
        "['shared']['wo']": (0, 2),
        "['shared']['w_gate']": (0, 1),
        "['shared']['w_up']": (0, 1),
        "['shared']['w_down']": (0, 1),
        "['embed']": (0, 1),
        "['unembed']": (0, 1),
    }


register_family(ModelFamily(
    name="zamba2",
    param_specs=param_specs,
    init=init,
    apply=apply,
    decode_state_specs=decode_state_specs,
    decode_step=decode_step,
    prefill=apply,
    supports_ragged=True,
    cache_spec=cache_spec,
    pack_layouts=pack_layouts,
    finish_leaf=finish_leaf,
))
