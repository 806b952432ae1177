"""Whisper-large-v3-shaped encoder-decoder (arXiv:2212.04356), as the
reference's ``repro/models/whisper.py`` computes it.

The conv/mel frontend is a stub: requests and batches carry precomputed
frame embeddings (B, enc_seq, D). Encoder layers are bidirectional
attention (no rotation) + GELU MLP; decoder layers add cross attention over
the encoder output. LayerNorm with mean subtraction, in f32. Decoder
positions use RoPE (the reference's stand-in for the learned table).

Serving: the decoder's self-attention cache is one global group (dense or
q8/q4, through the shared cache geometry; MHA, so its head axis is
``heads``). The cross-attention K/V (``xk``/``xv``, (Ld, B, enc_seq, H,
hd)) is per-slot state written at admission by :func:`cross_prefill`, which
encodes one request's frames and projects them through every decoder
layer's cross ``wk``/``wv``; it stays dense whatever ``cfg.kv_format``
says, and the step's reset mask leaves it alone. The cross read is plain
torch attention (the reference's is jnp, not a TPU kernel). The tied
embedding table serves the logits through ``dequant_matmul_t`` when packed.
The reference's ``lax.scan`` over layers is a Python loop over layer views
here, as in ``models.transformer``.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from .api import (ModelConfig, ModelFamily, ParamSpec, init_from_specs,
                  register_family, ring_prologue, torch_dtype)
from .layers import (AttnParams, QuantisedKV, attend, attention_mask,
                     attn_decode, constrain_act, embed_lookup,
                     flash_attention, gelu_mlp, linear, qkv_project,
                     rope_tables, step_geometry)
from .transformer import _at, _layer


def layer_norm(x, gain, eps: float = 1e-5):
    """LayerNorm without bias, in f32 (population variance, as
    ``jnp.var``), cast back to x's dtype."""
    x32 = x.float()
    m = x32.mean(dim=-1, keepdim=True)
    v = x32.var(dim=-1, keepdim=True, correction=0)
    return ((x32 - m) * torch.rsqrt(v + eps) * gain.float()).to(x.dtype)


def _attn_specs(L, D, H, hd, pd, prefix=""):
    lx = lambda *s: ("layers",) + tuple(s)
    return {
        prefix + "wq": ParamSpec((L, D, H, hd), lx("fsdp", "heads", None), pd),
        prefix + "wk": ParamSpec((L, D, H, hd), lx("fsdp", "heads", None), pd),
        prefix + "wv": ParamSpec((L, D, H, hd), lx("fsdp", "heads", None), pd),
        prefix + "wo": ParamSpec((L, H, hd, D), lx("heads", None, "fsdp"), pd),
        prefix + "norm": ParamSpec((L, D), lx(None), pd),
    }


def param_specs(cfg: ModelConfig) -> dict:
    D, H, hd, F, V = (cfg.d_model, cfg.n_heads, cfg.hd, cfg.d_ff, cfg.vocab)
    Le, Ld = cfg.n_enc_layers, cfg.n_layers
    pd = cfg.param_dtype
    lx = lambda *s: ("layers",) + tuple(s)

    def stack(L):
        return {
            **_attn_specs(L, D, H, hd, pd, "self_"),
            "mlp_norm": ParamSpec((L, D), lx(None), pd),
            "w_in": ParamSpec((L, D, F), lx("fsdp", "mlp"), pd),
            "w_out": ParamSpec((L, F, D), lx("mlp", "fsdp"), pd),
        }

    enc = stack(Le)
    dec = stack(Ld)
    dec.update(_attn_specs(Ld, D, H, hd, pd, "cross_"))
    return {
        "embed": ParamSpec((V, D), ("vocab", "fsdp"), pd),
        "enc": enc,
        "dec": dec,
        "enc_norm": ParamSpec((D,), (None,), pd),
        "dec_norm": ParamSpec((D,), (None,), pd),
    }


def _self_params(lp) -> AttnParams:
    return AttnParams(lp["self_wq"], lp["self_wk"], lp["self_wv"],
                      lp["self_wo"])


def _loop(cfg: ModelConfig, body, x, layers, n_layers: int, *args):
    """The reference's scan over a stacked layer tree as a loop; under
    autograd with ``cfg.remat`` "full" (or "dots") each layer keeps only its
    input and is recomputed in the backward pass."""
    remat = cfg.remat in ("full", "dots") and torch.is_grad_enabled()
    for i in range(n_layers):
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                body, x, _layer(layers, i), *args, use_reentrant=False)
        else:
            x = body(x, _layer(layers, i), *args)
    return x


def _enc_layer(cfg: ModelConfig):
    def body(x, lp, positions):
        x = constrain_act(x)
        h = layer_norm(x, lp["self_norm"], cfg.norm_eps)
        q, k, v = qkv_project(h, _self_params(lp), None, cfg)  # no rotation
        o = flash_attention(q, k, v, positions, positions, causal=False,
                            chunk=cfg.attn_chunk)
        x = x + linear(o, lp["self_wo"], "btnh,nhd->btd")
        h = layer_norm(x, lp["mlp_norm"], cfg.norm_eps)
        return constrain_act(x + gelu_mlp(h, lp["w_in"], lp["w_out"]))
    return body


def encode(params, frames, cfg: ModelConfig):
    """frames (B, enc_seq, D) -> encoder output (B, enc_seq, D) in
    ``cfg.dtype``."""
    x = frames.to(torch_dtype(cfg.dtype))
    positions = torch.arange(x.shape[1], device=x.device)
    x = _loop(cfg, _enc_layer(cfg), x, params["enc"], cfg.n_enc_layers,
              positions)
    return layer_norm(x, params["enc_norm"], cfg.norm_eps)


def _dec_layer(cfg: ModelConfig):
    def body(x, lp, enc_out, positions, enc_positions):
        x = constrain_act(x)
        # causal self attention (RoPE)
        rot = rope_tables(positions, cfg.hd, cfg.rope_theta)
        h = layer_norm(x, lp["self_norm"], cfg.norm_eps)
        q, k, v = qkv_project(h, _self_params(lp), rot, cfg)
        o = flash_attention(q, k, v, positions, positions, causal=True,
                            chunk=cfg.attn_chunk)
        x = x + linear(o, lp["self_wo"], "btnh,nhd->btd")
        # cross attention
        h = layer_norm(x, lp["cross_norm"], cfg.norm_eps)
        qc = linear(h, lp["cross_wq"], "btd,dnh->btnh")
        kc = linear(enc_out, lp["cross_wk"], "btd,dnh->btnh")
        vc = linear(enc_out, lp["cross_wv"], "btd,dnh->btnh")
        oc = flash_attention(qc, kc, vc, positions, enc_positions,
                             causal=False, chunk=cfg.attn_chunk)
        x = x + linear(oc, lp["cross_wo"], "btnh,nhd->btd")
        h = layer_norm(x, lp["mlp_norm"], cfg.norm_eps)
        return constrain_act(x + gelu_mlp(h, lp["w_in"], lp["w_out"]))
    return body


def apply(params, batch, cfg: ModelConfig):
    """batch: {"frames": (B, enc_seq, D), "tokens": (B, T)} -> f32 logits
    (B, T, V), through the tied table (``dequant_matmul_t`` when packed)."""
    enc_out = encode(params, batch["frames"], cfg)
    tokens = batch["tokens"]
    x = embed_lookup(params["embed"], tokens, dtype=torch_dtype(cfg.dtype))
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    enc_positions = torch.arange(enc_out.shape[1], device=tokens.device)
    x = _loop(cfg, _dec_layer(cfg), x, params["dec"], cfg.n_layers, enc_out,
              positions, enc_positions)
    x = layer_norm(x, params["dec_norm"], cfg.norm_eps)
    return linear(x, params["embed"], "btd,vd->btv").float()


def cache_spec(cfg: ModelConfig, batch_size: int, kv_len: int,
               slack: int = 0, windowed: bool = True):
    """The decoder's self-attention cache: one full-length global group over
    the Ld layers, MHA (head axis ``heads``). The cross-attention K/V is
    admission-owned state outside this geometry, dense whatever
    ``cfg.kv_format`` says."""
    import numpy as np

    from repro_torch.serve.cache import build_cache_spec
    return build_cache_spec(
        np.zeros(cfg.n_layers, np.int32), batch_size, kv_len, slack=slack,
        kv_heads=cfg.n_heads, head_dim=cfg.hd,
        dtype=cfg.kv_dtype or cfg.dtype, windowed=windowed,
        head_axis="heads", formats=cfg.kv_format)


def decode_state_specs(cfg: ModelConfig, batch_size: int, kv_len: int,
                       slack: int = 0, windowed: bool = True) -> dict:
    H, hd, Ld = cfg.n_heads, cfg.hd, cfg.n_layers
    cd = cfg.kv_dtype or cfg.dtype
    return {
        # grouped self-attention KV (one global group: k0/v0)
        **cache_spec(cfg, batch_size, kv_len, slack, windowed).state_specs(),
        # cross-attention KV, written per slot at admission (cross_prefill)
        "xk": ParamSpec((Ld, batch_size, cfg.enc_seq, H, hd),
                        ("layers", "batch", None, "heads", None), cd),
        "xv": ParamSpec((Ld, batch_size, cfg.enc_seq, H, hd),
                        ("layers", "batch", None, "heads", None), cd),
        "pos": ParamSpec((batch_size,), ("batch",), "int32"),
    }


def decode_step(params, state, batch, cfg: ModelConfig):
    """Ragged decode step. batch: {"tokens": (B, T), "t_valid": optional
    (B,) advance counts, "reset": optional (B,) mask}. Each row writes its
    new self-attention k/v at its own ``pos[b]`` **in place** (quantised
    through ``block_quant`` for a q8/q4 cache, read through
    ``decode_attention_quant``) and advances by ``t_valid[b]``. ``reset``
    zeroes a slot's self-attention rows and position; the cross-attention
    K/V (``xk``/``xv``) belongs to :func:`cross_prefill`, which overwrites
    the slot at admission, so the reset leaves it alone. Every encoder
    frame is visible to every decoder position. Returns (logits (B, T, V)
    float32, state)."""
    from repro_torch.serve.cache import kv_codebook, parse_kv_formats
    tokens = batch["tokens"]
    B, T = tokens.shape
    dev = tokens.device
    fmts = parse_kv_formats(cfg.kv_format, 1, cfg.hd)
    # the cross K/V is deliberately not in the reset set (see docstring)
    pos, adv, _, st = ring_prologue(state, batch, 1, formats=fmts)
    if fmts[0] == "f32":
        cb = None
        k_s, v_s = st["k0"], st["v0"]
    else:
        cb = kv_codebook(fmts[0], dev)
        k_s = QuantisedKV(st["k0"], st["k0s"])
        v_s = QuantisedKV(st["v0"], st["v0s"])
    x = embed_lookup(params["embed"], tokens, dtype=torch_dtype(cfg.dtype))
    positions = pos[:, None] + torch.arange(T, dtype=torch.int32,
                                            device=dev)[None]
    rot = rope_tables(positions, cfg.hd, cfg.rope_theta)
    geo = step_geometry(pos, positions, rot, st["k0"].shape[2],
                        kv_heads=cfg.n_heads, codebook=cb)
    # the whole encoder output is visible to every decoder position
    enc_vis = torch.full((B, T), 2 ** 30, dtype=torch.int32, device=dev)
    cross_mask = attention_mask(enc_vis, cfg.enc_seq)
    xk, xv = state["xk"], state["xv"]
    for i in range(cfg.n_layers):
        lp = _layer(params["dec"], i)
        h = layer_norm(x, lp["self_norm"], cfg.norm_eps)
        x = x + attn_decode(h, _self_params(lp), _at(k_s, i), _at(v_s, i),
                            geo, cfg)
        h = layer_norm(x, lp["cross_norm"], cfg.norm_eps)
        qc = linear(h, lp["cross_wq"], "btd,dnh->btnh")
        oc = attend(qc, xk[i], xv[i], cross_mask)
        x = x + linear(oc, lp["cross_wo"], "btnh,nhd->btd")
        h = layer_norm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + gelu_mlp(h, lp["w_in"], lp["w_out"])
    x = layer_norm(x, params["dec_norm"], cfg.norm_eps)
    logits = linear(x, params["embed"], "btd,vd->btv")  # tied, transposed
    return logits.float(), {**state, **st, "pos": pos + adv}


def cross_prefill(params, frames, cfg: ModelConfig):
    """Per-slot cross-attention prefill: encode one request's frames
    ((1, enc_seq, D)) and project them through every decoder layer's cross
    ``wk``/``wv`` (packed weights through ``dequant_matmul`` at M =
    enc_seq): the ``xk``/``xv`` entries (Ld, 1, enc_seq, H, hd) in
    ``kv_dtype or dtype`` that the engine writes into the admitted slot.
    ``frames=None`` returns zeros (a text-only request; also what wipes a
    reused slot's stale cross K/V)."""
    H, hd, Ld = cfg.n_heads, cfg.hd, cfg.n_layers
    cd = torch_dtype(cfg.kv_dtype or cfg.dtype)
    shape = (Ld, 1, cfg.enc_seq, H, hd)
    if frames is None:
        z = torch.zeros(shape, dtype=cd, device=params["dec_norm"].device)
        return {"xk": z, "xv": z}
    enc_out = encode(params, frames, cfg)          # (1, enc_seq, D)
    xk = torch.empty(shape, dtype=cd, device=enc_out.device)
    xv = torch.empty_like(xk)
    dec = params["dec"]
    for i in range(Ld):
        lp = _layer({"wk": dec["cross_wk"], "wv": dec["cross_wv"]}, i)
        xk[i] = linear(enc_out, lp["wk"], "btd,dnh->btnh").to(cd)
        xv[i] = linear(enc_out, lp["wv"], "btd,dnh->btnh").to(cd)
    return {"xk": xk, "xv": xv}


def init(cfg: ModelConfig, *, seed: int = 0, device=None):
    """Seeded random parameters on ``device`` (default the card)."""
    return init_from_specs(param_specs(cfg), seed=seed, device=device)


def pack_layouts(cfg: ModelConfig) -> dict:
    """Packed-serving layouts over both stacks: encoder and decoder self
    attention, decoder cross attention, the GELU MLPs, and the tied
    embedding table, which serves the logits transposed (contraction along
    its blocked axis) with no dense unembed."""
    lay = {}
    for stack, prefixes in (("enc", ("self_",)), ("dec", ("self_", "cross_"))):
        for pre in prefixes:
            for n in ("wq", "wk", "wv"):
                lay[f"['{stack}']['{pre}{n}']"] = (1, 1)
            lay[f"['{stack}']['{pre}wo']"] = (1, 2)
        lay[f"['{stack}']['w_in']"] = (1, 1)
        lay[f"['{stack}']['w_out']"] = (1, 1)
    lay["['embed']"] = (0, 1)
    return lay


register_family(ModelFamily(
    name="whisper",
    param_specs=param_specs,
    init=init,
    apply=apply,
    decode_state_specs=decode_state_specs,
    decode_step=decode_step,
    prefill=apply,
    supports_ragged=True,
    cross_prefill=cross_prefill,
    cache_spec=cache_spec,
    pack_layouts=pack_layouts,
))
