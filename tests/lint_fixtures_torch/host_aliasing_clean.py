"""Lint fixture (clean twin): every sanctioned host→device pattern the
``host-aliasing`` rule must NOT flag, in torch."""
import numpy as np
import torch


def host_to_device(buf, device):
    """Stand-in for serve.engine.host_to_device (the blessed helper)."""
    return torch.from_numpy(buf.copy()).to(device)


class MiniEngine:
    def __init__(self, n):
        self._slot_pos = np.zeros(n, np.int32)
        self._needs_reset = np.zeros(n, bool)
        self._live = np.zeros(n, bool)

    def step(self, state, prompts, device):
        # explicit snapshot: a .copy() argument is a fresh value
        state["pos"] = torch.from_numpy(self._slot_pos.copy()).to(device)
        # the blessed helper is neither from_numpy nor as_tensor here
        reset = host_to_device(self._needs_reset, device)
        # torch.tensor always copies
        live = torch.tensor(self._live)
        # fresh local assembly buffer, mutated only BEFORE staging and
        # never again: sharing its memory is harmless here
        toks = np.zeros((len(prompts), 4), np.int32)
        for i, p in enumerate(prompts):
            toks[i, : len(p)] = p
        batch = {"tokens": torch.from_numpy(toks).to(device),
                 "reset": reset, "live": live}
        self._needs_reset[:] = False
        self._slot_pos[0] += 1
        self._live[:] = True
        return state, batch


def replay_chunks(chunks, width):
    # buffer freshly reallocated inside the loop: no cross-iteration alias
    out = []
    for c in chunks:
        buf = np.zeros(width, np.int32)
        buf[0] = c
        out.append(torch.from_numpy(buf))
    return out
