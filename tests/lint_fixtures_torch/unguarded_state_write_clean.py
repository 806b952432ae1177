"""Lint fixture (clean twin): decode steps that honour the ragged
protocol — via the shared prologue, by masking on t_valid/reset directly,
or by delegating to a guarded inner step."""
import torch


def ragged_prologue(state, batch, reset_axes):
    """Stand-in for models.api.ragged_prologue: wipes a reset slot's rows
    in place."""
    reset = batch.get("reset")
    if reset is not None:
        for key, ax in reset_axes.items():
            shape = [1] * state[key].ndim
            shape[ax] = -1
            state[key].masked_fill_(reset.reshape(shape), 0)
    return state, batch.get("t_valid")


def decode_step(params, state, batch):
    state, t_valid = ragged_prologue(state, batch, {"h": 0})
    x = batch["tokens"]
    h = torch.tanh(state["h"] + x.float().sum(-1, keepdim=True))
    step = 1 if t_valid is None else (t_valid > 0).to(torch.int32)
    return h, dict(state, h=h, pos=state["pos"] + step)


def masked_decode_step(params, state, batch):
    # inline guard: both protocol keys consulted before any state write
    t_valid = batch["t_valid"]
    reset = batch["reset"]
    h0 = torch.where(reset[:, None], 0.0, state["h"])
    h = h0 * 0.9 + batch["tokens"].float().mean(-1, keepdim=True)
    h = torch.where((t_valid > 0)[:, None], h, h0)
    return h, dict(state, h=h)


def outer_decode_step(params, state, batch):
    # delegation: the guarded inner step owns the protocol
    return masked_decode_step(params, state, batch)
