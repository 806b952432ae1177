"""Deterministic replayable serving workloads (the reference's
``repro/serve/traffic.py`` over the port's scheduler).

A :class:`TrafficSpec` is a seed plus distribution knobs; :func:`generate`
expands it into a :class:`Workload` — a fixed list of :class:`Arrival`\\ s
(Poisson arrival times on the scheduler's virtual step clock, mixed
prompt/output lengths, a prefix-group mix, per-request priorities) plus
the shared-prefix token lists, a pure numpy function of the spec.
:func:`replay` drives a :class:`~repro_torch.serve.scheduler.Scheduler`
through the workload (optionally with ``serve.faults`` NaN injection armed
from the spec) and reports:

* **TTFT** (time-to-first-token, submit→first token) and **per-token
  latency** p50/p99, read off the ``Generation`` wall-clock stamps;
* **goodput** — completed tokens/s counting only requests that finished
  cleanly (``done`` and neither ``failed`` nor ``truncated``);
* **queue depth over time** — the scheduler's admission-pass trace.

Everything that decides *what happens* is a pure function of the spec
seed: arrivals release on the virtual step clock, admission order is
priority+aging with FIFO ties, fault steps are fixed indices — so two
replays of the same spec give the same token streams and step counts
wherever the device step is deterministic (``deterministic_signature`` is
the comparable digest; only the wall-clock latency values vary).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serve import faults as serve_faults
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import Scheduler


@dataclass(frozen=True)
class TrafficSpec:
    """Seeded description of a serving workload (all knobs deterministic).

    ``rate`` is mean arrivals per engine step on the virtual clock
    (``Scheduler.step_dt`` maps it to wall seconds if desired);
    ``prompt_len``/``output_len`` are inclusive ranges for the non-prefix
    prompt body and ``max_new_tokens``. ``prefixes`` is the shared-prefix
    mix: ``(key, length, weight)`` per group, with ``no_prefix_weight``
    the odds of a prefix-less request. ``priorities`` is a
    ``(priority, weight)`` mix. ``fault_nan`` arms
    ``serve.faults.inject_nan_logits`` at replay:
    ``(slot, at_step, n_steps)`` triples — NaN logits on ``slot`` for
    ``n_steps`` consecutive device steps from ``at_step`` (indices counted
    from injection; a multi-step window makes the fault land on a decode
    emit even if ``at_step`` itself falls inside a prefill chunk, where
    logits are never read)."""
    seed: int = 0
    n_requests: int = 24
    rate: float = 0.5
    prompt_len: Tuple[int, int] = (3, 10)
    output_len: Tuple[int, int] = (4, 12)
    vocab: int = 256
    prefixes: Tuple[Tuple[str, int, float], ...] = (("sys", 8, 0.6),)
    no_prefix_weight: float = 0.4
    priorities: Tuple[Tuple[float, float], ...] = ((0.0, 0.75), (2.0, 0.25))
    fault_nan: Tuple[Tuple[int, int, int], ...] = ()


@dataclass(frozen=True)
class Arrival:
    """One replayable request: everything ``Scheduler.submit`` needs."""
    rid: int
    at: float                   # virtual arrival time (engine steps)
    prompt: Tuple[int, ...]     # full prompt (prefix tokens included)
    max_new_tokens: int
    priority: float
    prefix: Optional[str]       # pool key, or None


@dataclass(frozen=True)
class Workload:
    spec: TrafficSpec
    prefixes: Dict[str, List[int]]
    arrivals: Tuple[Arrival, ...]


def generate(spec: TrafficSpec) -> Workload:
    """Expand a spec into its workload — a pure function of ``spec``
    (single ``default_rng(seed)`` stream, fixed draw order), so equal
    specs give equal workloads."""
    rng = np.random.default_rng(spec.seed)
    prefixes = {key: [int(t) for t in rng.integers(0, spec.vocab, size=n)]
                for key, n, _ in spec.prefixes}
    pkeys = [k for k, _, _ in spec.prefixes] + [None]
    pw = np.asarray([w for _, _, w in spec.prefixes]
                    + [spec.no_prefix_weight], float)
    pw = pw / pw.sum()
    prios = np.asarray([p for p, _ in spec.priorities], float)
    prw = np.asarray([w for _, w in spec.priorities], float)
    prw = prw / prw.sum()
    arrivals = []
    t = 0.0
    for rid in range(spec.n_requests):
        t += float(rng.exponential(1.0 / spec.rate))
        key = pkeys[int(rng.choice(len(pkeys), p=pw))]
        body = [int(x) for x in rng.integers(
            0, spec.vocab,
            size=int(rng.integers(spec.prompt_len[0],
                                  spec.prompt_len[1] + 1)))]
        prompt = tuple((prefixes[key] if key is not None else []) + body)
        arrivals.append(Arrival(
            rid=rid, at=round(t, 6), prompt=prompt,
            max_new_tokens=int(rng.integers(spec.output_len[0],
                                            spec.output_len[1] + 1)),
            priority=float(prios[int(rng.choice(len(prios), p=prw))]),
            prefix=key))
    return Workload(spec=spec, prefixes=prefixes, arrivals=tuple(arrivals))


@dataclass
class TrafficReport:
    """Replay outcome: latency/goodput metrics (wall-clock — vary between
    runs) plus the deterministic step-clock record (identical between
    replays of one spec; compare via :meth:`deterministic_signature`)."""
    metrics: Dict[str, float]
    tokens: Dict[int, List[int]]        # rid → emitted token stream
    outcomes: Dict[int, str]            # rid → done|failed|truncated
    queue_depth: List[int]              # waiting count per admission pass
    scheduler: Scheduler = field(repr=False, default=None)  # type: ignore

    def deterministic_signature(self) -> dict:
        """Everything a second replay of the same spec must reproduce
        bit-for-bit (token streams + step-clock accounting; no wall
        clock)."""
        return {"tokens": {r: list(t) for r, t in sorted(self.tokens.items())},
                "outcomes": dict(sorted(self.outcomes.items())),
                "queue_depth": list(self.queue_depth),
                "steps_total": self.metrics["steps_total"],
                "prefill_slot_steps": self.metrics["prefill_slot_steps"],
                "forks": self.metrics["forks"]}


def _pct(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs, float), q)) if xs else 0.0


def replay(engine: ServeEngine, workload: Workload, *, use_prefix: bool = True,
           aging: float = 0.05, step_dt: float = 1.0,
           prefix_capacity: int = 4, max_steps: int = 100000,
           deadline_s: Optional[float] = None) -> TrafficReport:
    """Replay a workload against a fresh engine and measure it.

    ``use_prefix=False`` submits identical prompts but without declaring
    the prefix key — the no-reuse baseline: on the CPU its token streams
    equal the reuse run's bit for bit (prompts are equal); on the card the
    two runs' different step schedules may move low-margin tokens. Only the
    prefill accounting differs. Faults from ``workload.spec.fault_nan`` are
    armed before the first step; faulted requests end ``failed`` and drop
    out of goodput.
    """
    sched = Scheduler(engine, aging=aging, step_dt=step_dt,
                      prefix_capacity=prefix_capacity)
    for key, toks in workload.prefixes.items():
        sched.register_prefix(key, toks)
    handles = {}
    for a in workload.arrivals:
        handles[a.rid] = sched.submit(
            list(a.prompt), max_new_tokens=a.max_new_tokens,
            priority=a.priority, at=a.at, rid=a.rid,
            prefix=a.prefix if use_prefix else None)
    for slot, at_step, n_steps in workload.spec.fault_nan:
        serve_faults.inject_nan_logits(engine, slot % engine.B, at_step,
                                       n_steps=n_steps)
    t0 = time.monotonic()
    sched.run(max_steps=max_steps, deadline_s=deadline_s)
    wall = max(time.monotonic() - t0, 1e-9)

    tokens: Dict[int, List[int]] = {}
    outcomes: Dict[int, str] = {}
    ttft: List[float] = []
    per_tok: List[float] = []
    queue_steps: List[int] = []
    good_tokens = 0
    for rid, h in handles.items():
        g = h.generation
        if g is None:
            tokens[rid] = []
            outcomes[rid] = "starved"
            continue
        tokens[rid] = list(g.tokens)
        outcomes[rid] = ("failed" if g.failed else
                         "truncated" if g.truncated else
                         "done" if g.done else "live")
        queue_steps.append(g.queue_steps)
        if g.tokens and g.t_first_token > 0:
            ttft.append(g.t_first_token - g.t_submit)
            if len(g.tokens) >= 2 and g.t_done > 0:
                per_tok.append((g.t_done - g.t_first_token)
                               / (len(g.tokens) - 1))
        if g.done and not g.failed and not g.truncated:
            good_tokens += len(g.tokens)
    depth = [s.waiting for s in sched.queue_trace]
    metrics = {
        "n_requests": len(workload.arrivals),
        "completed": sum(1 for o in outcomes.values() if o == "done"),
        "failed": sum(1 for o in outcomes.values() if o == "failed"),
        "truncated": sum(1 for o in outcomes.values() if o == "truncated"),
        "wall_s": round(wall, 4),
        "goodput_tok_s": round(good_tokens / wall, 2),
        "good_tokens": good_tokens,
        "ttft_p50_s": round(_pct(ttft, 50), 6),
        "ttft_p99_s": round(_pct(ttft, 99), 6),
        "per_token_p50_s": round(_pct(per_tok, 50), 6),
        "per_token_p99_s": round(_pct(per_tok, 99), 6),
        "queue_depth_mean": round(float(np.mean(depth)) if depth else 0.0, 3),
        "queue_depth_max": int(max(depth)) if depth else 0,
        "queue_steps_mean": round(float(np.mean(queue_steps))
                                  if queue_steps else 0.0, 3),
        "steps_total": engine.steps_total,
        "prefill_steps": engine.prefill_steps,
        "prefill_slot_steps": engine.prefill_slot_steps,
        "pool_prefill_steps": sched.pool.prefill_steps,
        "total_prefill_slot_steps": (engine.prefill_slot_steps
                                     + sched.pool.prefill_steps),
        "forks": sched.stats["forks"],
        "forked_tokens": sched.stats["forked_tokens"],
    }
    return TrafficReport(metrics=metrics, tokens=tokens, outcomes=outcomes,
                         queue_depth=depth, scheduler=sched)
