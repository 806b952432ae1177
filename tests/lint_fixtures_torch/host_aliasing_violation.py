"""Lint fixture: zero-copy aliasing of host buffers the engine mutates in
place, in torch: ``torch.from_numpy`` always shares the numpy buffer,
``torch.as_tensor`` does whenever the dtype allows, and ``.to(device)`` is
a no-op on the CPU.

``# EXPECT: <rule-id>`` markers drive tests/test_torch_analysis.py — the
linter must flag exactly these lines with exactly these rule ids.
"""
import numpy as np
import torch


class MiniEngine:
    """Persistent host buffers staged without a snapshot — the step may
    observe mutations made after it was dispatched."""

    def __init__(self, n):
        self._slot_pos = np.zeros(n, np.int32)
        self._needs_reset = np.zeros(n, bool)
        self._live = torch.zeros(n, dtype=torch.bool)

    def step(self, state, tokens, device):
        state["pos"] = torch.from_numpy(self._slot_pos).to(device)  # EXPECT: host-aliasing
        batch = {
            "tokens": torch.from_numpy(tokens).to(device),
            "reset": torch.as_tensor(self._needs_reset, device=device),  # EXPECT: host-aliasing
            "live": torch.as_tensor(self._live),  # EXPECT: host-aliasing
        }
        self._needs_reset[:] = False
        self._slot_pos[0] += 1
        self._live.zero_()
        return state, batch


def replay_chunks(buf, chunks):
    """Loop-carried buffer: the mutation is textually before the staging
    call, but aliases into the next iteration's tensor."""
    out = []
    for c in chunks:
        buf[0] += c
        out.append(torch.from_numpy(buf))  # EXPECT: host-aliasing
    return out


def stage_then_clear(mask, device):
    staged = torch.as_tensor(mask, device=device)  # EXPECT: host-aliasing
    mask.masked_fill_(mask, False)
    return staged
