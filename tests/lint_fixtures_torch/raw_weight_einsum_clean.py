"""Lint fixture (clean twin): activation-only contractions and API-routed
weight applications in torch — zero findings expected, one documented
pragma."""
import torch
import torch.nn.functional as F


def linear(x, w, spec):
    """Stand-in for layers.linear (the blessed projection API)."""
    return torch.einsum(spec, x, w.to(x.dtype))


def embed_lookup(params, tokens):
    """Stand-in for layers.embed_lookup: the API contracts the table
    itself, so its body is not checked."""
    onehot = F.one_hot(tokens, params["embed"].shape[0]).float()
    return onehot @ params["embed"]


def attention_scores(qg, k_cache, v_cache):
    # attention math contracts activations against *cache* state, not
    # params — the rule keys on param-leaf operands and stays silent
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_cache.to(qg.dtype))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v_cache.dtype), v_cache)


def projections(x, lp):
    q = linear(x, lp["wq"], "btd,dnh->btnh")
    o = linear(q, lp["wo"], "btnh,nhd->btd")
    return o


def annotated_bonus(rs, ks, p):
    # a genuinely non-packable per-head bonus vector, documented in place
    u = p.w_bonus
    return torch.einsum("bthi,hi->bth", rs * ks, u)  # lint: allow(raw-weight-einsum) (H, hd) bonus vector, below the quantisable floor
