"""Serving front end: continuous-batching scheduler with priority/fairness
admission and shared-prefix KV reuse (the reference's
``repro/serve/scheduler.py`` over the port's engine).

The engine (``serve.engine``) owns slots, steps and the fault machinery;
this layer owns *when work enters them*:

* **submit/stream API** — :meth:`Scheduler.submit` returns a
  :class:`StreamHandle` at once; ``handle.stream()`` is a cooperative
  generator that drives the engine one ``step_once`` at a time and yields
  tokens as they are decoded. ``Scheduler.run`` drains everything.
* **continuous batching** — the engine calls the scheduler back
  (``admission_hook``) before every slot-fill pass, including the refill at
  the end of each step, so a slot freed by a finished or quarantined
  generation is reclaimed inside the same wave.
* **priority + aging admission** — effective priority is ``priority +
  aging * steps_waited`` (higher admits sooner, FIFO ties), so a
  low-priority request cannot starve. Requests are validated by the
  engine's ``validate_request`` at ``submit``.
* **shared-prefix reuse** — a declared prompt prefix is prefilled **once**
  into a :class:`PrefixPool` entry and every admission *forks* the pooled
  KV rows into its slot: the rows of every cache group (ring and global,
  codes and scales, ``CacheSpec.state_keys``) are copied in place into the
  engine's state and the slot position jumps to the prefix length. On the
  CPU a forked slot decodes the same greedy tokens bit for bit as
  recomputing the prefix (chunked prefill is exact and slot rows are
  independent).

**Lifetime**: a handle keeps its scheduler, and the scheduler its engine;
the engine's hooks and the scheduler's record of each request hold theirs
weakly (a request whose handle no caller keeps is served all the same). A
dropped scheduler and its engine go together, with no cycle collector.

**Virtual clock**: scheduling decisions follow the engine step counter
(``vt = steps_total * step_dt`` plus idle fast-forward), never the wall
clock, so a replayed workload (``serve.traffic``) admits in the same order
every run. Wall-clock stamps ride on the ``Generation`` objects.
"""
from __future__ import annotations

import time
import warnings
import weakref
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.serve.engine import (Generation, Request, ServeEngine,
                                      alloc_decode_state, host_to_device)


# ---------------------------------------------------------------------------
# Shared-prefix KV pool
# ---------------------------------------------------------------------------

@dataclass
class _PoolEntry:
    tokens: List[int]
    length: int                       # prefix positions prefilled
    rows: Dict[str, torch.Tensor]     # per state key: donor row, (Lg, S, ...)
    prefill_steps: int                # chunk steps paid to build the entry
    last_used: int = 0                # LRU clock


class PrefixPool:
    """Pooled shared-prefix KV: prefill a prompt prefix once, fork its rows
    into any slot that declares it.

    An entry is built by streaming the prefix through the **engine's own
    step** (``engine._step``: same batch width, same chunking, donor row 0
    of a fresh zeroed state), so its KV rows are what the engine itself
    would have written; only the donor row is kept, cloned (a slice is a
    view of the donor state). Forking copies those rows into the admitted
    slot across every cache group and moves the slot position to the
    prefix length; rows past the prefix are the donor state's zeros, so the
    copy is a complete predecessor wipe and the admission reset bit is
    cleared. Entries are LRU-evicted beyond ``capacity``; forks copy, so
    evicting a pooled prefix never touches live forked slots."""

    def __init__(self, engine: ServeEngine, capacity: int = 4):
        self.engine = engine
        self.capacity = capacity
        self._tokens: Dict[str, List[int]] = {}
        self._entries: Dict[str, _PoolEntry] = {}
        self._clock = 0
        self.prefill_steps = 0      # chunk steps spent building entries
        self.evictions = 0
        spec = (engine.fam.cache_spec(
            engine.cfg, engine.B, engine.kv_len, slack=engine.prefill_chunk,
            windowed=engine.windowed_cache)
            if engine.fam.cache_spec is not None else None)
        self._cache_keys = tuple(spec.state_keys) if spec is not None else ()
        # a fork is pure KV surgery: sound only when the grouped caches (+
        # pos) are the whole per-slot state
        self.fork_capable = (
            self._cache_keys != ()
            and set(engine._state) == {"pos", *self._cache_keys})

    def register(self, key: str, tokens: List[int]) -> None:
        """Declare a prefix under ``key``. Prefill is lazy (first fork);
        re-registering the same tokens is a no-op, new tokens replace the
        entry."""
        tokens = list(tokens)
        if not tokens:
            raise ValueError(f"prefix {key!r}: empty token list")
        if len(tokens) >= self.engine.kv_len:
            raise ValueError(
                f"prefix {key!r}: length {len(tokens)} does not fit the KV "
                f"budget (kv_len={self.engine.kv_len})")
        if self._tokens.get(key) != tokens:
            self._tokens[key] = tokens
            self._entries.pop(key, None)

    def tokens(self, key: str) -> List[int]:
        if key not in self._tokens:
            raise KeyError(f"prefix {key!r} is not registered; known: "
                           f"{sorted(self._tokens)}")
        return list(self._tokens[key])

    def evict(self, key: str) -> None:
        """Drop a pooled entry (registration stays). Live forks are copies
        and keep decoding; the next fork re-prefills."""
        if self._entries.pop(key, None) is not None:
            self.evictions += 1

    @property
    def resident(self) -> List[str]:
        return sorted(self._entries)

    def ensure(self, key: str) -> _PoolEntry:
        """The pooled entry for ``key``, prefilled (once) if absent, with
        LRU eviction beyond capacity."""
        if key not in self._tokens:
            raise KeyError(f"prefix {key!r} is not registered; known: "
                           f"{sorted(self._tokens)}")
        self._clock += 1
        entry = self._entries.get(key)
        if entry is None:
            entry = self._prefill(self._tokens[key])
            # stamped before the LRU scan: a fresh entry is never its own
            # eviction victim
            entry.last_used = self._clock
            self._entries[key] = entry
            while len(self._entries) > self.capacity:
                lru = min(self._entries,
                          key=lambda k: self._entries[k].last_used)
                self.evict(lru)
        entry.last_used = self._clock
        return entry

    def _prefill(self, tokens: List[int]) -> _PoolEntry:
        """Stream the prefix through the engine's step on a fresh zeroed
        state (donor row 0; the other rows idle with ``t_valid=0``)."""
        eng = self.engine
        dev = eng.device
        with torch.inference_mode():
            state = alloc_decode_state(eng.fam, eng.cfg, eng.B, eng.kv_len,
                                       slack=eng.prefill_chunk, device=dev,
                                       windowed=eng.windowed_cache)
            pos = np.zeros(eng.B, np.int32)
            T = eng.prefill_chunk
            steps = consumed = 0
            while consumed < len(tokens):
                v = min(T, len(tokens) - consumed)
                toks = np.zeros((eng.B, T), np.int32)
                toks[0, :v] = tokens[consumed:consumed + v]
                t_valid = np.zeros(eng.B, np.int32)
                t_valid[0] = v
                state["pos"] = host_to_device(pos, dev)
                _, state = eng._step(eng.params, state,
                                     {"tokens": host_to_device(toks, dev),
                                      "t_valid": host_to_device(t_valid,
                                                                dev)})
                pos[0] += v
                consumed += v
                steps += 1
            rows = {k: state[k][:, 0].clone() for k in self._cache_keys}
        self.prefill_steps += steps
        return _PoolEntry(tokens=list(tokens), length=len(tokens),
                          rows=rows, prefill_steps=steps)

    def fork(self, slot: int, entry: _PoolEntry, prompt_len: int) -> int:
        """Copy the pooled rows into ``slot`` and move its position past
        the prefix. Returns the fork length, ``min(prefix, prompt - 1)``, so
        at least one prompt token is left to process (its logits seed
        decoding; re-processing it rewrites its rows with the same
        values)."""
        eng = self.engine
        fork_len = min(entry.length, prompt_len - 1)
        if fork_len <= 0:
            return 0
        with torch.inference_mode():     # the engine's state is inference
            for k in self._cache_keys:
                eng._state[k][:, slot].copy_(entry.rows[k])
        eng._slot_pos[slot] = fork_len
        # the copy is the wipe: clear the admission reset bit so the
        # in-step zeroing cannot destroy the forked rows
        eng._needs_reset[slot] = False
        return fork_len


# ---------------------------------------------------------------------------
# Stream handles + scheduler
# ---------------------------------------------------------------------------

class StreamHandle:
    """A submitted request's live view: ``generation`` appears at
    admission, ``tokens``/``done``/``failed`` track it, and ``stream()``
    yields tokens as they are decoded (driving the engine cooperatively)."""

    def __init__(self, sched: "Scheduler", rid: int, priority: float,
                 prefix: Optional[str], at: float):
        self._sched = sched
        self.rid = rid
        self.priority = priority
        self.prefix = prefix
        self.at = at
        self.generation: Optional[Generation] = None
        self.forked_tokens = 0     # prefix positions reused at admission

    @property
    def admitted(self) -> bool:
        return self.generation is not None

    @property
    def tokens(self) -> List[int]:
        return list(self.generation.tokens) if self.generation else []

    @property
    def done(self) -> bool:
        return bool(self.generation and self.generation.done)

    @property
    def failed(self) -> bool:
        return bool(self.generation and self.generation.failed)

    def stream(self):
        """Yield this request's tokens as they are produced, stepping the
        engine whenever none is pending (other requests progress on the
        same steps)."""
        sent = 0
        while True:
            g = self.generation
            if g is not None:
                while sent < len(g.tokens):
                    yield g.tokens[sent]
                    sent += 1
                if g.done or g.failed:
                    return
            if not self._sched.engine.step_once(self._sched._drained):
                return

    def result(self) -> Generation:
        """Drive the engine until this request finishes; returns its
        :class:`Generation`."""
        for _ in self.stream():
            pass
        if self.generation is None:
            raise RuntimeError(
                f"rid={self.rid}: engine idle before the request was "
                "admitted (arrival beyond the replay horizon?)")
        return self.generation


def _weak_hook(method):
    """``method`` (an engine hook) called through a weak reference to its
    object, a no-op once that is gone: the hook keeps nothing alive."""
    ref = weakref.WeakMethod(method)

    def hook(*args):
        live = ref()
        if live is not None:
            live(*args)
    return hook


@dataclass
class _Submitted:
    seq: int
    req: Request
    priority: float
    prefix: Optional[str]
    at: float
    handle: "weakref.ref[StreamHandle]"
    arrive_step: int = -1       # engine step at arrival (aging baseline)
    t_submit: float = 0.0
    released: bool = False


@dataclass
class QueueSample:
    """One admission-pass observation of front-end pressure."""
    step: int
    waiting: int                # arrived, not yet seated (pending + queue)
    live: int                   # seated slots
    future: int = 0             # submitted, arrival time not reached


class Scheduler:
    """Continuous-batching front end over one :class:`ServeEngine`.

    Wires itself into the engine's hooks: ``admission_hook`` releases due
    arrivals into the engine queue in effective-priority order before every
    slot-fill pass, and ``on_admit`` forks pooled shared-prefix KV into the
    seated slot. ``aging`` is the fairness knob (0 = strict priority, may
    starve); ``step_dt`` maps engine steps to the virtual-clock units of
    ``submit(at=...)`` arrival times."""

    def __init__(self, engine: ServeEngine, *, aging: float = 0.05,
                 step_dt: float = 1.0, prefix_capacity: int = 4):
        if aging < 0:
            raise ValueError(f"aging must be >= 0, got {aging}")
        if step_dt <= 0:
            raise ValueError(f"step_dt must be > 0, got {step_dt}")
        self.engine = engine
        self.aging = aging
        self.step_dt = step_dt
        self.pool = PrefixPool(engine, capacity=prefix_capacity)
        self.queue_trace: List[QueueSample] = []
        self.stats = {"forks": 0, "forked_tokens": 0, "released": 0,
                      "prefix_recompute": 0}
        self._future: List[_Submitted] = []    # at > vt, sorted (at, seq)
        self._pending: List[_Submitted] = []   # arrived, awaiting release
        self._by_rid: Dict[int, _Submitted] = {}
        self._seq = 0
        self._vt_skip = 0.0                    # idle fast-forward offset
        self._drained: List[Generation] = []   # stream()-mode sink
        self._warned_no_fork = False
        engine.admission_hook = _weak_hook(self._release)
        engine.on_admit = _weak_hook(self._on_admit)

    # ------------------------------------------------------------------ api
    def submit(self, prompt: List[int], *, max_new_tokens: int = 32,
               priority: float = 0.0, prefix: Optional[str] = None,
               at: Optional[float] = None, rid: Optional[int] = None,
               temperature: float = 0.0,
               deadline_steps: Optional[int] = None,
               frames=None) -> StreamHandle:
        """Queue a request with the front end; returns a
        :class:`StreamHandle` at once.

        ``priority``: higher admits sooner (aged). ``prefix``: key of a
        :meth:`register_prefix`-ed prefix the prompt starts with (declaring
        it lets admission fork the pooled KV instead of recomputing it).
        ``at``: virtual arrival time (engine steps × ``step_dt``); None =
        already arrived. ``frames``: the request's encoder input
        (``Request.frames``, whisper). The engine's ``validate_request``
        runs here, so a malformed request raises at the caller, not
        mid-replay."""
        if rid is None:
            rid = self._seq
        if rid in self._by_rid:
            warnings.warn(
                f"Scheduler.submit: rid={rid} resubmitted — the new handle "
                "replaces the old one", RuntimeWarning, stacklevel=2)
        if prefix is not None:
            ptoks = self.pool.tokens(prefix)   # KeyError if unregistered
            if list(prompt[:len(ptoks)]) != ptoks:
                raise ValueError(
                    f"rid={rid}: prompt does not start with prefix "
                    f"{prefix!r} ({len(ptoks)} tokens) — the prefix is part "
                    "of the prompt; declaring it only enables KV reuse")
        req = Request(prompt=list(prompt), max_new_tokens=max_new_tokens,
                      temperature=temperature, rid=rid, frames=frames,
                      deadline_steps=deadline_steps)
        self.engine.validate_request(req)
        handle = StreamHandle(self, rid, priority, prefix,
                              0.0 if at is None else at)
        sub = _Submitted(seq=self._seq, req=req, priority=priority,
                         prefix=prefix, at=handle.at,
                         handle=weakref.ref(handle),
                         t_submit=time.monotonic())
        self._seq += 1
        self._by_rid[rid] = sub
        if at is None or at <= self._vt():
            sub.arrive_step = self.engine.steps_total
            self._pending.append(sub)
        else:
            self._future.append(sub)
            self._future.sort(key=lambda s: (s.at, s.seq))
        return handle

    def register_prefix(self, key: str, tokens: List[int]) -> None:
        """Declare a shared prompt prefix (see :class:`PrefixPool`)."""
        self.pool.register(key, tokens)

    def run(self, max_steps: int = 100000,
            deadline_s: Optional[float] = None) -> List[Generation]:
        """Drive the engine until every submitted request (including
        not-yet-arrived ones: the virtual clock fast-forwards across idle
        gaps) completes, or a budget expires (``ServeEngine.run``)."""
        return self.engine.run(max_steps=max_steps, deadline_s=deadline_s)

    @property
    def waiting(self) -> int:
        """Arrived-but-unseated requests (pending + engine queue)."""
        return len(self._pending) + len(self.engine._queue)

    # ---------------------------------------------------------------- hooks
    def _vt(self) -> float:
        return self.engine.steps_total * self.step_dt + self._vt_skip

    def _release(self, eng: ServeEngine) -> None:
        """Admission-hook body: arrival release + priority ordering, before
        every slot-fill pass (so a freed slot is reoffered at once)."""
        now = eng.steps_total
        vt = self._vt()
        # idle fast-forward: engine drained but arrivals remain — jump the
        # virtual clock to the next arrival (steps only advance when slots
        # are live)
        if (not self._pending and not eng._queue and self._future
                and all(s is None for s in eng._slots)
                and self._future[0].at > vt):
            self._vt_skip += self._future[0].at - vt
            vt = self._vt()
        while self._future and self._future[0].at <= vt:
            sub = self._future.pop(0)
            sub.arrive_step = now
            sub.t_submit = time.monotonic()
            self._pending.append(sub)
        self.queue_trace.append(QueueSample(
            step=now, waiting=len(self._pending) + len(eng._queue),
            live=sum(s is not None for s in eng._slots),
            future=len(self._future)))
        free = sum(s is None for s in eng._slots) - len(eng._queue)
        if free <= 0 or not self._pending:
            return
        self._pending.sort(key=lambda s: (
            -(s.priority + self.aging * (now - s.arrive_step)), s.seq))
        for sub in self._pending[:free]:
            sub.req._t_submit = sub.t_submit         # type: ignore
            sub.req._submit_step = sub.arrive_step   # type: ignore
            sub.released = True
            eng.submit(sub.req)
            self.stats["released"] += 1
        del self._pending[:free]

    def _on_admit(self, eng: ServeEngine, slot: int, req: Request,
                  gen: Generation) -> None:
        """on_admit-hook body: attach the generation to its handle and fork
        pooled prefix KV into the seated slot."""
        sub = self._by_rid.get(req.rid)
        if sub is None or sub.req is not req:
            return                      # not ours (direct engine.submit)
        handle = sub.handle()
        if handle is not None:
            handle.generation = gen
        if sub.prefix is None:
            return
        if not self.pool.fork_capable:
            if not self._warned_no_fork:
                self._warned_no_fork = True
                warnings.warn(
                    f"Scheduler: family {eng.cfg.family!r} carries non-KV "
                    "per-slot state — shared prefixes are recomputed, not "
                    "forked (correct, just no prefill saving)",
                    RuntimeWarning, stacklevel=2)
            self.stats["prefix_recompute"] += 1
            return
        entry = self.pool.ensure(sub.prefix)
        forked = self.pool.fork(slot, entry, len(req.prompt))
        if handle is not None:
            handle.forked_tokens = forked
        if forked:
            self.stats["forks"] += 1
            self.stats["forked_tokens"] += forked
