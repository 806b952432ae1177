"""Lint fixture (clean twin): seeded generators threaded from the caller
and the monotonic clock — the sanctioned determinism-safe patterns."""
import time

import numpy as np
import torch


def sample_token(logits, seed):
    rng = np.random.default_rng(seed)
    noise = rng.gumbel(size=logits.shape)
    return int(np.argmax(logits + noise))


def torch_sample(logits, gen):
    noise = torch.rand(logits.shape, generator=gen)
    probs = torch.softmax(logits + noise, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)


def jitter(x, seed):
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    return x.normal_(0.0, 1e-3, generator=gen)


def timed_step(fn, *args):
    # monotonic() is allowed: it feeds metrics, never model data
    t0 = time.monotonic()
    out = fn(*args)
    return out, time.monotonic() - t0


def shuffle_slots(slots, seed):
    np.random.default_rng(seed).shuffle(slots)
    return slots
