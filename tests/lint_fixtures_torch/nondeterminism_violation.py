"""Lint fixture: nondeterminism in step/serve paths — unseeded legacy
numpy RNG, stdlib random, torch's global generator and its reseeds, and
wall-clock time used as data."""
import random
import time

import numpy as np
import torch


def sample_token(logits):
    if random.random() < 0.1:  # EXPECT: nondeterminism
        return 0
    noise = np.random.gumbel(size=logits.shape)  # EXPECT: nondeterminism
    return int(np.argmax(logits + noise))


def make_request_id():
    return int(time.time() * 1e6)  # EXPECT: nondeterminism


def torch_sample(logits):
    noise = torch.rand(logits.shape)  # EXPECT: nondeterminism
    probs = torch.softmax(logits + noise, dim=-1)
    return torch.multinomial(probs, 1)  # EXPECT: nondeterminism


def jitter(x):
    x.normal_(0.0, 1e-3)  # EXPECT: nondeterminism
    return x + torch.randn_like(x)  # EXPECT: nondeterminism


def reseed(step):
    torch.manual_seed(step)  # EXPECT: nondeterminism


def shuffle_slots(slots):
    np.random.shuffle(slots)  # EXPECT: nondeterminism
    return torch.randperm(len(slots))  # EXPECT: nondeterminism
