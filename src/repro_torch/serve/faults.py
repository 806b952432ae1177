"""Fault-injection harness for the serving robustness layer.

Every fault the engine claims to survive has a deterministic injector
here, so the recovery paths are drilled, not assumed (the reference's
``repro/serve/faults.py`` on the port's trees and engine):

  checkpoint corruption   corrupt_codes / corrupt_scales / corrupt_layout
                          flip bytes, poison scales or break the layout of
                          one named tensor in a quantised/packed params
                          tree — ``from_quantised(validate=True)`` must
                          reject the checkpoint naming that tensor.
  poisoned logits         inject_nan_logits forces NaN logits on one slot
                          at a chosen step — the engine must quarantine
                          exactly that slot and keep the wave decoding.
  device-step failure     inject_step_failures raises from the device step
                          at chosen step indices — step retry and the
                          dense fallback must absorb it.
  stalls                  inject_slow_steps sleeps inside chosen steps —
                          the run() watchdog and the straggler monitor
                          must notice.
  admission faults        drop_admissions / duplicate_admissions lose or
                          repeat queued requests — callers must see the
                          loss (fewer generations) or the duplicate
                          instead of silent wrong results.

Injectors that wrap engine internals (``_step`` / ``_fill_slots``) patch the
*instance*, never the class, and return their counter state so callers can
assert the fault actually fired. A wrapper reaches its engine only through
a weak reference (``serve.engine.weak_method``), so a drilled engine is
freed as soon as it is dropped. Step indices count device steps (prefill
chunks included) from the moment of injection. Tensor paths are the
reference's ``keystr`` strings (``"['layers']['wq']"``).
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Iterable, List

from repro_torch.core.plan import flat_with_paths, map_with_paths
from repro_torch.core.tensor_format import PackedTensor, QuantisedTensor
from repro_torch.serve.engine import weak_method


def _is_q(x) -> bool:
    return isinstance(x, (PackedTensor, QuantisedTensor))


def packed_paths(params) -> List[str]:
    """Paths of every quantised leaf (PackedTensor or QuantisedTensor) in a
    params tree — the valid targets for the corrupt_* injectors."""
    return [p for p, x in flat_with_paths(params) if _is_q(x)]


def _replace_leaf(params, path: str, fn):
    """Rebuild ``params`` with ``fn`` applied to the quantised leaf at
    ``path`` (other leaves shared); KeyError listing the valid targets if
    the path names none."""
    if path not in packed_paths(params):
        raise KeyError(
            f"no quantised tensor at {path!r}; targets: "
            f"{packed_paths(params)}")
    return map_with_paths(lambda p, x: fn(x) if p == path else x, params)


def corrupt_codes(params, path: str, *, byte: int = 0xFF, index: int = 0):
    """Overwrite one stored code byte of the tensor at ``path`` (flat
    ``index`` into the code array) — models a flipped byte in the quantised
    stream. ``byte=0xFF`` is out of range for every ≤128-code codebook
    stored as uint8; 4-bit nibble-packed tensors split the byte into two
    codes < 16, so range checks cannot see this fault there — corrupt
    scales instead (or target an 8-bit-stored tensor)."""

    def fn(q):
        flat = q.codes.reshape(-1).clone()
        flat[index] = byte
        return dataclasses.replace(q, codes=flat.reshape(q.codes.shape))

    return _replace_leaf(params, path, fn)


def corrupt_scales(params, path: str, *, value: float = float("nan"),
                   index: int = 0):
    """Overwrite one block scale of the tensor at ``path`` (flat ``index``)
    with ``value`` (default NaN) — models scale-word corruption, the fault
    class that poisons a whole block regardless of code width."""

    def fn(q):
        flat = q.scales.reshape(-1).clone()
        flat[index] = value
        return dataclasses.replace(q, scales=flat.reshape(q.scales.shape))

    return _replace_leaf(params, path, fn)


def corrupt_layout(params, path: str):
    """Drop the last output column of a PackedTensor's codes so the byte
    layout no longer agrees with the logical shape/scales — models a
    truncated or mis-sliced checkpoint shard."""

    def fn(q):
        if not isinstance(q, PackedTensor):
            raise TypeError(f"corrupt_layout needs a PackedTensor at "
                            f"{path!r}, got {type(q).__name__}")
        return dataclasses.replace(q, codes=q.codes[..., :-1])

    return _replace_leaf(params, path, fn)


def inject_nan_logits(engine, slot: int, at_step: int, n_steps: int = 1):
    """Force NaN logits for ``slot`` on device steps
    ``[at_step, at_step + n_steps)`` (counted from injection), on the
    device logits before the host copy (cloned, so the step's own output is
    untouched). Returns the counter dict (``step``: calls seen,
    ``injected``: faults delivered)."""
    inner = weak_method(engine, "_step")
    ctr = {"step": 0, "injected": 0}

    def wrapped(p, s, b):
        logits, state = inner(p, s, b)
        step = ctr["step"]
        ctr["step"] += 1
        if at_step <= step < at_step + n_steps:
            ctr["injected"] += 1
            logits = logits.clone()
            logits[slot] = float("nan")
        return logits, state

    engine._step = wrapped
    return ctr


def inject_step_failures(engine, steps: Iterable[int],
                         exc: type = RuntimeError):
    """Raise ``exc`` from the device step at each index in ``steps``
    (counted from injection), before the step runs. The counter advances
    *before* the raise, so a retry or fallback re-execution lands on the
    next index and succeeds — the transient-fault model. Returns the counter
    dict."""
    inner = weak_method(engine, "_step")
    fail_at = set(steps)
    ctr = {"step": 0, "raised": 0}

    def wrapped(p, s, b):
        step = ctr["step"]
        ctr["step"] += 1
        if step in fail_at:
            ctr["raised"] += 1
            raise exc(f"injected device-step failure at step {step}")
        return inner(p, s, b)

    engine._step = wrapped
    return ctr


def inject_slow_steps(engine, steps: Iterable[int], delay_s: float):
    """Sleep ``delay_s`` before the device step at each index in ``steps``
    (counted from injection) — models a stalling device/host. Returns the
    counter dict (``slowed``: stalls delivered)."""
    inner = weak_method(engine, "_step")
    slow_at = set(steps)
    ctr = {"step": 0, "slowed": 0}

    def wrapped(p, s, b):
        step = ctr["step"]
        ctr["step"] += 1
        if step in slow_at:
            ctr["slowed"] += 1
            time.sleep(delay_s)
        return inner(p, s, b)

    engine._step = wrapped
    return ctr


def drop_admissions(engine, rids: Iterable[int]) -> List:
    """Silently discard queued requests with the given rids at every
    admission pass — models a lost submission. Returns the (live) list the
    dropped requests accumulate into."""
    lose = set(rids)
    ref, inner = weakref.ref(engine), weak_method(engine, "_fill_slots")
    dropped: List = []

    def wrapped():
        queue, keep = ref()._queue, []
        for r in queue:
            (dropped if r.rid in lose else keep).append(r)
        queue[:] = keep
        inner()

    engine._fill_slots = wrapped
    return dropped


def duplicate_admissions(engine, rids: Iterable[int]):
    """Re-enqueue one copy of each queued request with the given rids on
    the first admission pass — models a double submission (the engine's
    duplicate-rid warning fires at submit, this drills the post-queue
    path). Returns the state dict (``duplicated``: copies made)."""
    twice = set(rids)
    ref, inner = weakref.ref(engine), weak_method(engine, "_fill_slots")
    state = {"armed": True, "duplicated": 0}

    def wrapped():
        if state["armed"]:
            state["armed"] = False
            queue = ref()._queue
            dups = [dataclasses.replace(r, prompt=list(r.prompt))
                    for r in queue if r.rid in twice]
            state["duplicated"] = len(dups)
            queue.extend(dups)
        inner()

    engine._fill_slots = wrapped
    return state
