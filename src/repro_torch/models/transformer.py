"""Decoder-only transformer LM: parameter specs, init, the teacher-forcing
``apply``/``prefill``, the grouped KV cache geometry, the ragged
``decode_step`` and the packed-serving layouts.

Parameters keep the reference's stacked layout (``params["layers"][key]``
has a leading L dim), so checkpoints carry across unchanged. The
reference's ``lax.scan`` over layers is a Python loop here: layer ``l``
takes views ``[l]`` of the stacked weights (``PackedTensor.layer``) and,
at its group-local slot, of its cache group's (L_g, B, S, K, ·) stacks, and
writes its new k/v into those views in place. Layer groups may be global
(linear caches) or windowed (ring caches, gemma3's local layers), dense or
quantised (q8/q4 codes with per-row scales). Tied embeddings serve the
logits from the packed embedding table. ``apply`` runs the same layer
stack over whole sequences (chunked ``flash_attention``, no cache), on
dense or packed weights, with each layer rematerialised under autograd
when ``cfg.remat`` asks. MoE configs (qwen2-moe, llama4-scout) replace the
dense MLP by ``layers.moe_block``: stacked expert weights (L, E, ·, ·),
packed with two lead dims, whose layer views stream through
``dequant_matmul``'s expert lead dim; the router stays dense.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.core.tensor_format import PackedTensor

from .api import (ModelConfig, ModelFamily, ParamSpec, init_from_specs,
                  register_family, ring_prologue, torch_dtype)
from .layers import (AttnParams, MlpParams, MoeParams, QuantisedKV,
                     attn_block, attn_decode, constrain_act, embed_lookup,
                     linear, moe_block, moe_block_out, rms_norm,
                     rope_tables, step_geometry, swiglu)


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def layer_param_specs(cfg: ModelConfig, n_layers: int) -> dict:
    """Specs for the stacked decoder layers."""
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    L = n_layers
    pd = cfg.param_dtype
    p = {
        "attn_norm": ParamSpec((L, D), ("layers", None), pd),
        "wq": ParamSpec((L, D, H, hd), ("layers", "fsdp", "heads", None), pd),
        "wk": ParamSpec((L, D, K, hd), ("layers", "fsdp", "kv_heads", None), pd),
        "wv": ParamSpec((L, D, K, hd), ("layers", "fsdp", "kv_heads", None), pd),
        "wo": ParamSpec((L, H, hd, D), ("layers", "heads", None, "fsdp"), pd),
        "mlp_norm": ParamSpec((L, D), ("layers", None), pd),
    }
    if cfg.qk_norm:
        p["q_norm"] = ParamSpec((L, hd), ("layers", None), pd)
        p["k_norm"] = ParamSpec((L, hd), ("layers", None), pd)
    if cfg.n_experts:
        E, F = cfg.n_experts, cfg.dff_expert
        p.update({
            "w_router": ParamSpec((L, D, E), ("layers", "fsdp", None), pd),
            "we_gate": ParamSpec((L, E, D, F),
                                 ("layers", "experts", "fsdp", None), pd),
            "we_up": ParamSpec((L, E, D, F),
                               ("layers", "experts", "fsdp", None), pd),
            "we_down": ParamSpec((L, E, F, D),
                                 ("layers", "experts", None, "fsdp"), pd),
        })
        if cfg.n_shared_experts:
            Fs = cfg.dff_expert * cfg.n_shared_experts
            p.update({
                "ws_gate": ParamSpec((L, D, Fs), ("layers", "fsdp", "mlp"),
                                     pd),
                "ws_up": ParamSpec((L, D, Fs), ("layers", "fsdp", "mlp"), pd),
                "ws_down": ParamSpec((L, Fs, D), ("layers", "mlp", "fsdp"),
                                     pd),
            })
    else:
        F = cfg.d_ff
        p.update({
            "w_gate": ParamSpec((L, D, F), ("layers", "fsdp", "mlp"), pd),
            "w_up": ParamSpec((L, D, F), ("layers", "fsdp", "mlp"), pd),
            "w_down": ParamSpec((L, F, D), ("layers", "mlp", "fsdp"), pd),
        })
    return p


def param_specs(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    pd = cfg.param_dtype
    specs = {
        "embed": ParamSpec((cfg.vocab, D), ("vocab", "fsdp"), pd),
        "layers": layer_param_specs(cfg, cfg.n_layers),
        "final_norm": ParamSpec((D,), (None,), pd),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((D, cfg.vocab), ("fsdp", "vocab"), pd)
    return specs


def init(cfg: ModelConfig, *, seed: int = 0, device=None):
    """Seeded random parameters on ``device`` (default the card)."""
    return init_from_specs(param_specs(cfg), seed=seed, device=device)


# ---------------------------------------------------------------------------
# Forward (teacher forcing)
# ---------------------------------------------------------------------------

def _layer_attn_params(lp) -> AttnParams:
    return AttnParams(lp["wq"], lp["wk"], lp["wv"], lp["wo"],
                      lp.get("q_norm"), lp.get("k_norm"))


def _moe_params(cfg: ModelConfig, lp) -> MoeParams:
    return MoeParams(
        lp["w_router"], lp["we_gate"], lp["we_up"], lp["we_down"],
        shared=(MlpParams(lp["ws_gate"], lp["ws_up"], lp["ws_down"])
                if cfg.n_shared_experts else None))


def _mlp_params(lp) -> MlpParams:
    return MlpParams(lp["w_gate"], lp["w_up"], lp["w_down"])


def _layer_body(cfg: ModelConfig, x, lp, window: int, positions):
    """One decoder layer. x: (B, T, D). Returns (x, the MoE router's
    load-balancing loss: 0.0 for a dense MLP)."""
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    x = x + attn_block(h, _layer_attn_params(lp), positions, cfg, window)
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    if cfg.n_experts:
        y, aux = moe_block(h, _moe_params(cfg, lp), cfg)
    else:
        y, aux = swiglu(h, _mlp_params(lp)), 0.0
    return x + y, aux


def _scan_layers(cfg: ModelConfig, x, layers, positions):
    """The reference's scan over the stacked layers as a loop, each layer
    at its window from ``cfg.window_pattern()``, summing the layers' aux
    losses (f32; 0.0 for a dense stack). Under autograd, ``cfg.remat``
    "full" (and "dots": the port has no per-op save policy) keeps only each
    layer's input and recomputes the layer in the backward pass. Returns
    (x, aux)."""
    remat = cfg.remat in ("full", "dots") and torch.is_grad_enabled()
    aux = 0.0
    for i, window in enumerate(cfg.window_pattern()):
        args = (cfg, constrain_act(x), _layer(layers, i), int(window),
                positions)
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(_layer_body, *args,
                                                     use_reentrant=False)
        else:
            x, a = _layer_body(*args)
        x = constrain_act(x)
        aux = aux + a
    return x, aux


def apply(params, batch, cfg: ModelConfig):
    """Teacher-forcing forward. batch: {"tokens": (B, T) int, optional
    "vis_embed": (B, P, D) patch embeddings, prepended to the tokens}.
    Computes in ``cfg.dtype`` (f32 master weights are cast inside each
    ``linear``, so gradients reach them); packed weights run the
    ``dequant_matmul`` kernels with M = B·T. Returns f32 logits (B, T, V)
    (T + P with ``vis_embed``)."""
    tokens = batch["tokens"]
    T = tokens.shape[1]
    dt = torch_dtype(cfg.dtype)
    x = embed_lookup(params["embed"], tokens, dtype=dt)
    if "vis_embed" in batch:
        x = torch.cat([batch["vis_embed"].to(dt), x], dim=1)
        T = x.shape[1]
    positions = torch.arange(T, device=tokens.device)
    x, _ = _scan_layers(cfg, x, params["layers"], positions)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(x, params, cfg).float()


def prefill(params, batch, cfg: ModelConfig):
    """Process a full prompt, returning its logits (the serving engine
    writes its KV cache through chunked ``decode_step`` calls instead)."""
    return apply(params, batch, cfg)


# ---------------------------------------------------------------------------
# Decode path (serving)
# ---------------------------------------------------------------------------

def cache_spec(cfg: ModelConfig, batch_size: int, kv_len: int,
               slack: int = 0, windowed: bool = True):
    """Self-attention cache geometry (``serve.cache.CacheSpec``)."""
    from repro_torch.serve.cache import build_cache_spec
    return build_cache_spec(
        cfg.window_pattern(), batch_size, kv_len, slack=slack,
        kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        dtype=cfg.kv_dtype or cfg.dtype, windowed=windowed,
        formats=cfg.kv_format)


def decode_state_specs(cfg: ModelConfig, batch_size: int, kv_len: int,
                       slack: int = 0, windowed: bool = True) -> dict:
    """Grouped KV cache specs plus the per-slot positions ``pos`` (B,)."""
    spec = cache_spec(cfg, batch_size, kv_len, slack, windowed)
    return {
        **spec.state_specs(),
        "pos": ParamSpec((batch_size,), ("batch",), "int32"),
    }


def _layer(lp: dict, i: int) -> dict:
    """Layer ``i``'s parameters as views of the stacked leaves."""
    return {k: (v.layer(i) if isinstance(v, PackedTensor) else v[i])
            for k, v in lp.items()}


def _at(cache, j: int):
    """Slot ``j`` of a group's cache stack, as a view."""
    if isinstance(cache, QuantisedKV):
        return QuantisedKV(cache.codes[j], cache.scales[j])
    return cache[j]


def decode_step(params, state, batch, cfg: ModelConfig):
    """Chunked decode step with per-slot positions (the ragged protocol)
    and grouped caches.

    batch: {"tokens": (B, T) int, "t_valid": optional (B,) int32, "reset":
    optional (B,) bool}. Each row writes its T new k/v at its own
    ``state["pos"][b]`` and advances by ``t_valid[b]`` (default T); a set
    ``reset`` bit zeroes that slot's KV rows (codes and scales of quantised
    groups) and position first (``ring_prologue``). Windowed groups write
    their ring at ``pos % length`` and mask by reconstructed positions;
    global groups keep the linear full-length cache. The cache stacks in
    ``state`` are updated **in place**; the returned state holds the same
    tensors and the new ``pos``. Returns (logits (B, T, V) float32,
    state)."""
    from repro_torch.serve.cache import (kv_codebook, layer_groups,
                                         parse_kv_formats)
    tokens = batch["tokens"]
    B, T = tokens.shape
    dt = torch_dtype(cfg.dtype)
    groups = layer_groups(cfg.window_pattern())
    fmts = parse_kv_formats(cfg.kv_format, len(groups), cfg.hd)
    pos, adv, _, st = ring_prologue(state, batch, len(groups), formats=fmts)
    x = embed_lookup(params["embed"], tokens, dtype=dt)
    positions = pos[:, None] + torch.arange(T, dtype=torch.int32,
                                            device=tokens.device)[None]
    # rope tables, and per group its write coordinates and masks, are the
    # same for every layer: built once per step
    rot = rope_tables(positions, cfg.hd, cfg.rope_theta)
    caches, geos, where = [], [], {}
    for g, (window, layers) in enumerate(groups):
        if fmts[g] == "f32":
            caches.append((st[f"k{g}"], st[f"v{g}"]))
            cb = None
        else:
            caches.append((QuantisedKV(st[f"k{g}"], st[f"k{g}s"]),
                           QuantisedKV(st[f"v{g}"], st[f"v{g}s"])))
            cb = kv_codebook(fmts[g], tokens.device)
        geos.append(step_geometry(pos, positions, rot, st[f"k{g}"].shape[2],
                                  window=window, ring=window > 0,
                                  kv_heads=cfg.n_kv_heads, codebook=cb))
        where.update({layer: (g, j) for j, layer in enumerate(layers)})
    for i in range(cfg.n_layers):
        g, j = where[i]
        lp = _layer(params["layers"], i)
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        x = x + attn_decode(h, _layer_attn_params(lp),
                            _at(caches[g][0], j), _at(caches[g][1], j),
                            geos[g], cfg)
        h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        if cfg.n_experts:   # no load-balancing loss: nothing reads it
            x = x + moe_block_out(h, _moe_params(cfg, lp), cfg)
        else:
            x = x + swiglu(h, _mlp_params(lp))
    new_state = {**st, "pos": pos + adv}
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(x, params, cfg).float(), new_state


def _unembed(x, params, cfg: ModelConfig):
    """Logits through ``linear``: a tied table (V, D) contracts along its
    blocked axis (``dequant_matmul_t`` when packed)."""
    if cfg.tie_embeddings:
        return linear(x, params["embed"], "btd,vd->btv")
    return linear(x, params["unembed"], "btd,dv->btv")


def pack_layouts(cfg: ModelConfig) -> dict:
    """Matmul layouts for serving from packed quantised weights: tensor path
    → (n_lead, n_contract), the reference's declarations. Expert stacks
    carry two lead dims (layers, experts); a layer's view streams every
    expert through ``dequant_matmul``'s lead dim. The router stays dense
    (a small (D, E) matmul feeding the top-k dispatch). The embedding table
    packs too, tied or not (rows gather-dequantise through
    ``embed_lookup``; a tied table also serves the logits through
    ``dequant_matmul_t``)."""
    lay = {
        "['layers']['wq']": (1, 1),
        "['layers']['wk']": (1, 1),
        "['layers']['wv']": (1, 1),
        "['layers']['wo']": (1, 2),
    }
    if cfg.n_experts:
        for name in ("we_gate", "we_up", "we_down"):
            lay[f"['layers']['{name}']"] = (2, 1)
        if cfg.n_shared_experts:
            for name in ("ws_gate", "ws_up", "ws_down"):
                lay[f"['layers']['{name}']"] = (1, 1)
    else:
        for name in ("w_gate", "w_up", "w_down"):
            lay[f"['layers']['{name}']"] = (1, 1)
    lay["['embed']"] = (0, 1)
    if not cfg.tie_embeddings:
        lay["['unembed']"] = (0, 1)
    return lay


register_family(ModelFamily(
    name="transformer",
    param_specs=param_specs,
    init=init,
    apply=apply,
    decode_state_specs=decode_state_specs,
    decode_step=decode_step,
    prefill=prefill,
    supports_ragged=True,
    cache_spec=cache_spec,
    pack_layouts=pack_layouts,
))
