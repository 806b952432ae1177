"""Lint fixture: decode steps that update recurrent state without the
t_valid/reset ragged-batch protocol — stale slots keep advancing."""
import torch


def decode_step(params, state, batch):  # EXPECT: unguarded-state-write
    x = batch["tokens"]
    h = torch.tanh(state["h"] + x.float().sum(-1, keepdim=True))
    state["h"].copy_(h)
    return h, dict(state, pos=state["pos"] + x.shape[1])


def rnn_decode_step(params, state, batch):  # EXPECT: unguarded-state-write
    h = state["h"] * 0.9 + batch["tokens"].float().mean(-1, keepdim=True)
    return h, dict(state, h=h)
