"""Fault-tolerance primitives for thousand-node runs (pure Python, carried
over unchanged from the reference's ``repro/train/fault_tolerance.py``).

The framework's contract (exercised in tests + the end-to-end example):
  * **Deterministic data**: batches are a pure function of (seed, step) —
    restart needs no iterator state (data/pipeline.py).
  * **Atomic checkpoints**: staging dir + rename; a crash mid-save never
    corrupts the latest checkpoint (train/checkpoint.py).
  * **Retry**: transient step failures re-execute (pure steps make this safe).
  * **Heartbeats**: per-host beat files; the launcher marks hosts dead after
    ``timeout`` and restarts the job from the latest checkpoint, possibly on
    fewer hosts (elastic restore re-shards).
  * **Straggler detection**: per-step wall-time ring buffer; steps slower
    than ``factor``× the running median flag the host for the scheduler.
"""
from __future__ import annotations

import json
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional


def retry(fn: Callable, max_attempts: int = 3, backoff_s: float = 0.0,
          on_error: Optional[Callable] = None):
    """Re-execute ``fn`` on transient failure classes, up to ``max_attempts``
    total attempts. Shared by the training loop (pure steps make re-execution
    safe) and the serving engine (``ServeEngine(step_retries=N)`` re-runs a
    failed device step before degrading). ``max_attempts`` must be ≥ 1 —
    zero attempts would raise nothing at all. After the last attempt the
    final exception is re-raised with its original traceback intact."""
    if max_attempts < 1:
        raise ValueError(
            f"retry: max_attempts must be >= 1, got {max_attempts} "
            "(zero attempts would execute nothing)")
    for attempt in range(max_attempts):
        try:
            return fn()
        except (RuntimeError, ValueError, OSError) as e:  # transient classes
            last = e
            if on_error:
                on_error(attempt, e)
            if backoff_s:
                time.sleep(backoff_s * (2 ** attempt))
    raise last.with_traceback(last.__traceback__)


@dataclass
class Heartbeat:
    run_dir: str
    host_id: int = 0

    def __post_init__(self):
        os.makedirs(os.path.join(self.run_dir, "heartbeats"), exist_ok=True)
        self._path = os.path.join(self.run_dir, "heartbeats",
                                  f"host_{self.host_id}.json")

    def beat(self, step: int):
        tmp = self._path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, "time": time.time()}, f)
        os.replace(tmp, self._path)

    @staticmethod
    def dead_hosts(run_dir: str, timeout_s: float = 300.0):
        hb_dir = os.path.join(run_dir, "heartbeats")
        if not os.path.isdir(hb_dir):
            return []
        now = time.time()
        dead = []
        for f in os.listdir(hb_dir):
            if not f.endswith(".json"):
                continue
            with open(os.path.join(hb_dir, f)) as fh:
                info = json.load(fh)
            if now - info["time"] > timeout_s:
                dead.append((f, now - info["time"]))
        return dead


@dataclass
class StragglerMonitor:
    window: int = 64
    factor: float = 2.0
    _times: deque = field(default_factory=lambda: deque(maxlen=64))
    flagged: int = 0

    def record(self, step_time: float) -> bool:
        """Returns True if this step was a straggler."""
        self._times.append(step_time)
        if len(self._times) < 8:
            return False
        med = sorted(self._times)[len(self._times) // 2]
        is_straggler = step_time > self.factor * med
        if is_straggler:
            self.flagged += 1
        return is_straggler
