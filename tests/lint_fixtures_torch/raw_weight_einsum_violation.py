"""Lint fixture: raw weight contractions that bypass ``layers.linear`` in
torch — the packed-coverage bypass (a PackedTensor leaf here densifies or
fails, and the fused dequant_matmul kernel never runs)."""
import torch
import torch.nn.functional as F


def attn_out(x, params, lp):
    y = torch.einsum("btd,dk->btk", x, params["wq"])  # EXPECT: raw-weight-einsum
    w = lp["w_down"]
    z = torch.matmul(y, w.to(x.dtype))  # EXPECT: raw-weight-einsum
    return z


def unembed(x, params):
    return x @ params["embed"].to(x.dtype).t()  # EXPECT: raw-weight-einsum


def router(xt, p):
    return F.linear(xt, p.w_router.float())  # EXPECT: raw-weight-einsum


def experts(h, lp):
    return torch.bmm(h, lp["we_down"])  # EXPECT: raw-weight-einsum


def mlp(x, p):
    g = x.mm(p.w_gate.contiguous().view(-1, 8))  # EXPECT: raw-weight-einsum
    u = p.w_up.matmul(x)  # EXPECT: raw-weight-einsum
    return g * u


def head(x, params):
    return torch.tensordot(x, params["w_out"], dims=1)  # EXPECT: raw-weight-einsum
