"""RWKV-6 "Finch" (arXiv:2404.05892), as the reference's
``repro/models/rwkv6.py`` computes it: an attention-free LM with token-shift
mixing and a data-dependent decay in the WKV linear-attention state.

Per head (dim hd), state S ∈ R^{hd×hd}:
    y_t[j] = Σ_i r_t[i] · (S[i,j] + u[i]·k_t[i]·v_t[j])
    S[i,j] ← w_t[i]·S[i,j] + k_t[i]·v_t[j],   w_t = exp(-exp(w0 + LoRA(x_t)))

The recurrence is plain torch in f32 (the reference's is plain jnp, not a
TPU kernel): ``wkv_scan`` one step at a time, ``wkv_chunked`` the
block-parallel form. Serving carries per-slot state (the token-shift inputs
``tm_x``/``cm_x`` and the WKV matrix), O(1) in the sequence length; there is
no KV cache, so the family has no ``cache_spec``. Every projection goes
through ``layers.linear`` (``dequant_matmul`` when packed): 10 a layer and
the untied unembed. The reference's ``lax.scan`` over layers is a Python
loop over layer views, as in ``models.transformer``; the decode step
returns new state tensors (a re-run step starts from the same state).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .api import (ModelConfig, ModelFamily, ParamSpec, init_from_specs,
                  ragged_prologue, register_family, torch_dtype)
from .layers import (_is_dtensor, constrain_act, embed_lookup, from_own,
                     linear, own_heads, rms_norm, to_own)
from .transformer import _layer
from .whisper import _loop

LORA_R = 64
HEAD_DIM = 64


def _n_heads(cfg):
    return cfg.d_model // HEAD_DIM


def layer_param_specs(cfg: ModelConfig) -> dict:
    D, F_, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    H, hd = _n_heads(cfg), HEAD_DIM
    pd = cfg.param_dtype
    lx = lambda *s: ("layers",) + tuple(s)
    return {
        "norm_tm": ParamSpec((L, D), lx(None), pd),
        "norm_cm": ParamSpec((L, D), lx(None), pd),
        # token-shift lerp coefficients
        "mu_r": ParamSpec((L, D), lx(None), pd),
        "mu_k": ParamSpec((L, D), lx(None), pd),
        "mu_v": ParamSpec((L, D), lx(None), pd),
        "mu_g": ParamSpec((L, D), lx(None), pd),
        "mu_w": ParamSpec((L, D), lx(None), pd),
        # data-dependent decay: w = exp(-exp(w0 + tanh(xw A) B))
        "w0": ParamSpec((L, D), lx(None), pd),
        "w_lora_a": ParamSpec((L, D, LORA_R), lx("fsdp", None), pd),
        "w_lora_b": ParamSpec((L, LORA_R, D), lx(None, "fsdp"), pd),
        "bonus_u": ParamSpec((L, H, hd), lx("heads", None), pd),
        # projections
        "wr": ParamSpec((L, D, D), lx("fsdp", "heads_flat"), pd),
        "wk": ParamSpec((L, D, D), lx("fsdp", "heads_flat"), pd),
        "wv": ParamSpec((L, D, D), lx("fsdp", "heads_flat"), pd),
        "wg": ParamSpec((L, D, D), lx("fsdp", "heads_flat"), pd),
        "wo": ParamSpec((L, D, D), lx("heads_flat", "fsdp"), pd),
        "ln_x": ParamSpec((L, D), lx(None), pd),  # per-head group norm gain
        # channel mix
        "mu_ck": ParamSpec((L, D), lx(None), pd),
        "mu_cr": ParamSpec((L, D), lx(None), pd),
        "wck": ParamSpec((L, D, F_), lx("fsdp", "mlp"), pd),
        "wcv": ParamSpec((L, F_, D), lx("mlp", "fsdp"), pd),
        "wcr": ParamSpec((L, D, D), lx("fsdp", None), pd),
    }


def param_specs(cfg: ModelConfig) -> dict:
    pd = cfg.param_dtype
    return {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "fsdp"), pd),
        "layers": layer_param_specs(cfg),
        "final_norm": ParamSpec((cfg.d_model,), (None,), pd),
        "unembed": ParamSpec((cfg.d_model, cfg.vocab), ("fsdp", "vocab"), pd),
    }


def _shift(x, last=None):
    """Token shift: x_{t-1} (zeros / ``last`` at t=0). x: (B, T, D)."""
    pad = torch.zeros_like(x[:, :1]) if last is None else last[:, None]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _group_norm(y, gain, eps):
    """Per-head LayerNorm over hd. y: (B, T, H, hd); gain: (D,). Mean and
    population variance in f32, cast to y's dtype (as ``jnp.mean`` and
    ``jnp.var`` of a bf16 array)."""
    m = y.float().mean(dim=-1, keepdim=True).to(y.dtype)
    v = y.float().var(dim=-1, keepdim=True, correction=0).to(y.dtype)
    yn = (y - m) * torch.rsqrt(v + eps)
    B, T, H, hd = y.shape
    return yn.reshape(B, T, H * hd) * gain.to(y.dtype)


def wkv_scan(r, k, v, w, u, s0=None):
    """The WKV recurrence, one step at a time, in f32. r/k/v/w: (B, T, H,
    hd); u: (H, hd). Returns (y (B, T, H, hd) in r's dtype, final state
    (B, H, hd, hd) f32)."""
    B, T, H, hd = r.shape
    s = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    u32 = u.float()[None, :, :, None]
    ys = []
    for t in range(T):
        rt, kt, vt, wt = (a[:, t].float() for a in (r, k, v, w))
        kv = kt[..., :, None] * vt[..., None, :]
        ys.append(torch.einsum("bhi,bhij->bhj", rt, s + u32 * kv))
        s = wt[..., :, None] * s + kv
    return torch.stack(ys, dim=1).to(r.dtype), s


_LOG_CLAMP = -20.0   # per-step log-decay floor (exp(-20) ≈ 2e-9: below f32
                     # visibility of the O(1) state update)
_CUM_CLAMP = -80.0   # per-chunk cumulative floor: exp(±80) stays finite in
                     # f32, and a chunk of ≤ 4 steps (serving) never hits it


def wkv_chunked(r, k, v, w, u, s0=None, chunk: int = 32):
    """Block-parallel WKV (the matmul form). Within a chunk of length C,
    with cumulative decays W_t = Π_{s≤t} w_s:
        y_t = r_t·(decay(·)·k_s v_sᵀ masked s<t) + r_t·(u⊙k_t) v_tᵀ
              + (r_t⊙W_{t-1})·S_prev
        S ← (W_C)⊙S_prev + Σ_s (k_s·W_C/W_s) v_sᵀ
    All inner math in f32 (a bf16 or TF32 step would destroy the exp(±80)
    pairwise factors); log-decays floored at -20 a step and -80 cumulative
    a chunk, as the reference's. Matches :func:`wkv_scan`."""
    B, T, H, hd = r.shape
    assert T % chunk == 0, (T, chunk)
    C, n = chunk, T // chunk
    f32 = torch.float32
    rs, ks, vs = (a.to(f32).reshape(B, n, C, H, hd) for a in (r, k, v))
    logw = torch.clamp(torch.log(torch.clamp(w.to(f32), min=1e-38)),
                       _LOG_CLAMP, 0.0).reshape(B, n, C, H, hd)
    S = (torch.zeros((B, H, hd, hd), dtype=f32, device=r.device)
         if s0 is None else s0.to(f32))
    u32 = u.to(f32)

    # cumulative within chunk: cw_t = Σ_{s<=t} log w_s (inclusive)
    cw = torch.clamp(torch.cumsum(logw, dim=2), min=_CUM_CLAMP)
    w_tot = torch.exp(cw[:, :, -1])                   # (B, n, H, hd)
    # decay applied to the incoming state at step t: Π_{s<t} w_s
    cw_excl = torch.cat([torch.zeros_like(cw[:, :, :1]), cw[:, :, :-1]],
                        dim=2)
    r_dec = rs * torch.exp(cw_excl)                   # r_t ⊙ W_{t-1}
    k_inv = ks * torch.exp(-cw)                       # k_s / W_s
    k_rem = ks * torch.exp(cw[:, :, -1:] - cw)        # k_s · W_C/W_s

    # intra-chunk attention, strictly below the diagonal
    scores = torch.einsum("bnthi,bnshi->bnhts", r_dec, k_inv)
    mask = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device),
                      diagonal=-1)
    scores = torch.where(mask, scores, 0.0)
    y_intra = torch.einsum("bnhts,bnshj->bnthj", scores, vs)
    # diagonal (current-token) bonus term: r_t·(u⊙k_t) v_t
    coef = torch.einsum("bnthi,hi->bnth", rs * ks, u32)
    y_intra = y_intra + coef[..., None] * vs

    # inter-chunk: only the state crosses chunk boundaries
    ys = []
    for c in range(n):
        ys.append(torch.einsum("bthi,bhij->bthj", r_dec[:, c], S))
        S = w_tot[:, c][..., :, None] * S + \
            torch.einsum("bthi,bthj->bhij", k_rem[:, c], vs[:, c])
    y = y_intra + torch.stack(ys, dim=1)
    return y.reshape(B, T, H, hd).to(r.dtype), S


def _last_valid(x, valid, last_x):
    """Token-shift state after a ragged chunk: row b's input at its last
    valid position (``valid``: (B, T) bool); rows with no valid token keep
    ``last_x``. x: (B, T, D)."""
    B, T, _ = x.shape
    li = torch.clamp(valid.sum(1) - 1, 0, T - 1)
    nl = x[torch.arange(B, device=x.device), li]
    if last_x is None:
        return nl
    return torch.where(valid.any(1)[:, None], nl, last_x)


def time_mix(x, lp, cfg, last_x=None, s0=None, valid=None):
    """Returns (out, (new_last_x, new_state)). ``valid`` ((B, T) bool) masks
    ragged-chunk padding out of the recurrent state: invalid steps get k=0
    and w=1 (the WKV identity update), and the token-shift state advances
    to each row's last valid input."""
    B, T, D = x.shape
    H, hd = _n_heads(cfg), HEAD_DIM
    dt = x.dtype
    xs = _shift(x, last_x)

    def lerp(mu):
        return x + (xs - x) * mu.to(dt)

    r = linear(lerp(lp["mu_r"]), lp["wr"], "btd,de->bte")
    k = linear(lerp(lp["mu_k"]), lp["wk"], "btd,de->bte")
    v = linear(lerp(lp["mu_v"]), lp["wv"], "btd,de->bte")
    g = linear(lerp(lp["mu_g"]), lp["wg"], "btd,de->bte")
    # data-dependent decay (the Finch contribution)
    w_lora = linear(torch.tanh(linear(lerp(lp["mu_w"]), lp["w_lora_a"],
                                      "btd,dr->btr")),
                    lp["w_lora_b"], "btr,rd->btd")
    w = torch.exp(-torch.exp(lp["w0"].float() + w_lora.float()))
    if valid is not None:
        vm = valid[..., None]
        k = torch.where(vm, k, 0.0).to(k.dtype)   # kv outer product -> 0
        w = torch.where(vm, w, 1.0)               # decay 1: S untouched
    ck = cfg.linear_chunk
    if s0 is None:
        use_chunked = bool(ck and T > ck and T % ck == 0)
        chunk = ck
    else:
        # serving: a multi-token chunk runs the block-parallel form seeded
        # with the carried state, at an inner chunk of at most 4 so the
        # cumulative log-decay (≥ -20 a step) never reaches the -80 floor
        chunk = next((c for c in (4, 3, 2) if T % c == 0), 1)
        use_chunked = T > 1 and chunk > 1
    wkv = functools.partial(wkv_chunked, chunk=chunk) if use_chunked \
        else wkv_scan
    mix = (r, k, v, w.to(dt), g)
    if not _is_dtensor(r):
        out, s_fin = _heads_out(*mix, lp["bonus_u"], lp["ln_x"], lp["wo"],
                                s0, cfg.norm_eps, wkv, H)
    else:
        # each rank on its own heads, laid out once a layer (T whole), so
        # the chunk loop slices local tensors; the ranks' partial outputs
        # are summed where they are next read
        own = own_heads(r, H, 2)
        out, s_fin = _heads_out(
            *(to_own(a, own, 0, 2, hd) for a in mix),
            to_own(lp["bonus_u"], own, None, 0),
            to_own(lp["ln_x"], own, None, 0, hd),
            to_own(lp["wo"], own, None, 0, hd),
            None if s0 is None else to_own(s0, own, 0, 1), cfg.norm_eps,
            wkv, own.nh)
        out = from_own(out, own, (B, T, D), 0, partial=True)
        s_fin = from_own(s_fin, own, (B, H, hd, hd), 0, 1)
    new_last = x[:, -1] if valid is None else _last_valid(x, valid, last_x)
    return out, (new_last, s_fin)


def _heads_out(r, k, v, w, g, u, gain, wo, s0, eps, wkv, H):
    """The WKV of (B, T, H·hd) r, k, v, w over H heads, its per-head group
    norm, the silu(g) gate and the output projection: (out (B, T, D), the
    final state)."""
    B, T = r.shape[:2]
    dt = r.dtype
    hsplit = lambda a: a.reshape(B, T, H, HEAD_DIM)
    y, s_fin = wkv(hsplit(r), hsplit(k), hsplit(v), hsplit(w), u, s0)
    y = _group_norm(y, gain, eps)
    y = y * F.silu(g)
    return linear(y.to(dt), wo, "btd,de->bte"), s_fin


def channel_mix(x, lp, cfg, last_x=None, valid=None):
    dt = x.dtype
    xs = _shift(x, last_x)
    xk = x + (xs - x) * lp["mu_ck"].to(dt)
    xr = x + (xs - x) * lp["mu_cr"].to(dt)
    r = torch.sigmoid(linear(xr, lp["wcr"], "btd,de->bte"))
    k = torch.square(torch.relu(linear(xk, lp["wck"], "btd,df->btf")))
    out = r * linear(k, lp["wcv"], "btf,fd->btd")
    new_last = x[:, -1] if valid is None else _last_valid(x, valid, last_x)
    return out, new_last


def _block(cfg):
    def body(x, lp):
        x = constrain_act(x)
        h, _ = time_mix(rms_norm(x, lp["norm_tm"], cfg.norm_eps), lp, cfg)
        x = x + h
        h, _ = channel_mix(rms_norm(x, lp["norm_cm"], cfg.norm_eps), lp, cfg)
        return constrain_act(x + h)
    return body


def apply(params, batch, cfg: ModelConfig):
    """Teacher-forcing forward: batch {"tokens": (B, T)} -> f32 logits
    (B, T, V). Each layer is rematerialised under autograd when
    ``cfg.remat`` asks."""
    x = embed_lookup(params["embed"], batch["tokens"],
                     dtype=torch_dtype(cfg.dtype))
    x = _loop(cfg, _block(cfg), x, params["layers"], cfg.n_layers)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return linear(x, params["unembed"], "btd,dv->btv").float()


# ---------------------------------------------------------------- decode

def decode_state_specs(cfg: ModelConfig, batch_size: int, kv_len: int,
                       slack: int = 0, windowed: bool = True) -> dict:
    """Recurrent state, O(1) in the sequence length (``kv_len``, ``slack``
    and ``windowed`` are unused: there is no KV cache). ``pos`` is
    per-slot."""
    D, L = cfg.d_model, cfg.n_layers
    H, hd = _n_heads(cfg), HEAD_DIM
    cd = cfg.dtype
    return {
        "tm_x": ParamSpec((L, batch_size, D), ("layers", "batch", None), cd),
        "cm_x": ParamSpec((L, batch_size, D), ("layers", "batch", None), cd),
        "wkv": ParamSpec((L, batch_size, H, hd, hd),
                         ("layers", "batch", "heads", None, None), "float32"),
        "pos": ParamSpec((batch_size,), ("batch",), "int32"),
    }


def decode_step(params, state, batch, cfg: ModelConfig):
    """Ragged decode step. batch: {"tokens": (B, T), "t_valid": optional
    (B,) advance counts, "reset": optional (B,) mask}. T=1 is plain decode;
    T>1 is batched chunked prefill through ``wkv_chunked``. Row b's state
    advances by exactly ``t_valid[b]`` tokens: padding is masked out of the
    WKV and token-shift updates. A set ``reset`` bit zeroes that slot's
    shift buffers and WKV matrix (in place, in the prologue) before any
    token is read. Returns (logits (B, T, V) float32, a new state)."""
    dt = torch_dtype(cfg.dtype)
    pos, adv, valid, st = ragged_prologue(
        state, batch, {"tm_x": 1, "cm_x": 1, "wkv": 1})
    x = embed_lookup(params["embed"], batch["tokens"], dtype=dt)
    tms, cms, wkvs = [], [], []
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        tm, cm = st["tm_x"][i], st["cm_x"][i]
        h, (tm_new, s_new) = time_mix(
            rms_norm(x, lp["norm_tm"], cfg.norm_eps), lp, cfg,
            last_x=tm.to(dt), s0=st["wkv"][i], valid=valid)
        x = x + h
        h, cm_new = channel_mix(
            rms_norm(x, lp["norm_cm"], cfg.norm_eps), lp, cfg,
            last_x=cm.to(dt), valid=valid)
        x = x + h
        tms.append(tm_new.to(tm.dtype))
        cms.append(cm_new.to(cm.dtype))
        wkvs.append(s_new)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = linear(x, params["unembed"], "btd,dv->btv")
    new_state = {"tm_x": torch.stack(tms), "cm_x": torch.stack(cms),
                 "wkv": torch.stack(wkvs), "pos": pos + adv}
    return logits.float(), new_state


_MU = ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "mu_ck", "mu_cr")
_MU_PATHS = {f"['layers']['{m}']" for m in _MU}


def finish_leaf(cfg: ModelConfig, path: str, leaf):
    """The reference ``init``'s own leaves: ``w0`` spreads the per-channel
    decays (-5 + 8·(i/(D-1))³, the standard RWKV init) and every ``mu_*``
    is 0.5, both f32; every other leaf is the generic draw."""
    L, D = cfg.n_layers, cfg.d_model
    if path == "['layers']['w0']":
        decay = -5.0 + 8.0 * (np.arange(D) / max(D - 1, 1)) ** 3.0
        return torch.from_numpy(np.asarray(decay, np.float32)).to(
            leaf.device).expand(L, D).contiguous()
    if path in _MU_PATHS:
        return torch.full((L, D), 0.5, dtype=torch.float32,
                          device=leaf.device)
    return leaf


def init(cfg: ModelConfig, *, seed: int = 0, device=None):
    """Seeded random parameters on ``device`` (default the card), with the
    reference's decay spread and lerp coefficients (:func:`finish_leaf`)."""
    return init_from_specs(param_specs(cfg), seed=seed, device=device,
                           finish=lambda p, a: finish_leaf(cfg, p, a))


def pack_layouts(cfg: ModelConfig) -> dict:
    """Packed-serving layouts: every projection in time-mix (r/k/v/g, the
    decay LoRA pair, the output) and channel-mix, plus embed/unembed. The
    token-shift lerp coefficients, decay bias and group-norm gains are
    elementwise vectors, never packed."""
    lay = {f"['layers']['{n}']": (1, 1)
           for n in ("wr", "wk", "wv", "wg", "wo",
                     "w_lora_a", "w_lora_b", "wck", "wcv", "wcr")}
    lay["['embed']"] = (0, 1)
    lay["['unembed']"] = (0, 1)
    return lay


register_family(ModelFamily(
    name="rwkv6",
    param_specs=param_specs,
    init=init,
    apply=apply,
    decode_state_specs=decode_state_specs,
    decode_step=decode_step,
    prefill=apply,
    supports_ragged=True,
    pack_layouts=pack_layouts,
    finish_leaf=finish_leaf,
))
