"""Serving engine: batched generation over fixed slots with continuous
batching, on dense or **packed-quantised** weights.

The reference's single ragged path, in eager PyTorch: per-slot positions
(``state["pos"]``: (B,) int32), batched chunked prefill (prompts stream
through ``decode_step`` in chunks of ``prefill_chunk`` tokens while
decode-phase slots ride along with one valid token each), and the in-step
``batch["reset"]`` wipe of a reused slot's KV rows. Packed weights
(``from_quantised``) keep codes + block scales resident on the device and
every projection runs the fused ``dequant_matmul`` kernel; no dense copy of
a packed tensor is ever made, and there is no dense fallback.

Robustness carried over from the reference: a slot whose logits go
non-finite is quarantined alone (``Generation.failed``, state wiped through
the reset protocol) while co-batched slots keep decoding;
``Request.deadline_steps`` bounds a request's engine steps;
``run(deadline_s=...)`` is a wall-clock watchdog returning resumable
partials; ``from_quantised(validate=True)`` integrity-checks the packed
checkpoint. Step retries, the scheduler front end and its admission hooks
come with later slices.

The step runs under ``torch.inference_mode()``; each step copies the logits
to the host (``.cpu()``), where tokens are sampled with numpy.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.plan import flat_with_paths, map_with_paths
from repro_torch.core.tensor_format import PackedTensor
from repro_torch.models.api import (ModelConfig, get_family, resolve_device,
                                    torch_dtype)


def alloc_decode_state(fam, cfg: ModelConfig, batch_slots: int, kv_len: int,
                       *, slack: int, device, windowed: bool = True):
    """Allocate zeroed decode state on ``device`` from the family's grouped
    cache specs (the one allocation the engine and :func:`greedy_generate`
    share). ``slack`` is the prefill chunk length; ``windowed=False``
    allocates every group at the full length."""
    specs = fam.decode_state_specs(cfg, batch_slots, kv_len, slack=slack,
                                   windowed=windowed)
    return {k: torch.zeros(s.shape, dtype=torch_dtype(s.dtype), device=device)
            for k, s in specs.items()}


def host_to_device(buf: np.ndarray, device):
    """The staging path for host buffers the engine mutates in place (slot
    positions, reset masks): ``torch.from_numpy`` aliases the numpy buffer
    and ``.to`` is a no-op on the CPU, so the buffer is snapshotted first and
    the step never observes a later host mutation."""
    return torch.from_numpy(buf.copy()).to(device)


def params_to(params, device):
    """Move a params tree (tensors and PackedTensors) to ``device``."""
    return map_with_paths(lambda _, x: x.to(device), params)


@dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 32
    temperature: float = 0.0
    rid: int = 0
    # max engine steps this request may occupy a slot (prefill chunks +
    # decode steps); exceeding it quarantines the request. None = no limit.
    deadline_steps: Optional[int] = None


@dataclass
class Generation:
    rid: int
    tokens: List[int] = field(default_factory=list)
    done: bool = False
    # hit the KV budget before max_new_tokens (strict_admission=False only)
    truncated: bool = False
    # quarantined (non-finite logits, deadline exceeded): partial tokens
    # kept, done stays False, fail_reason says why
    failed: bool = False
    fail_reason: str = ""
    # latency stamps (time.monotonic(); 0.0 = not reached)
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0
    queue_steps: int = 0


class ServeEngine:
    """Fixed-slot continuous-batching decode engine on ``device`` (default
    the card; ``device="cpu"`` runs the plain torch path).

    Decode state comes from the family's grouped cache specs: global groups
    at ``kv_len`` (+ chunk slack), windowed groups as ring buffers of
    ``window + slack`` slots, each dense or quantised per ``cfg.kv_format``.

    ``strict_admission`` (default True) rejects at ``submit`` a request
    whose ``prompt + max_new_tokens`` exceeds ``kv_len`` — the global
    groups' length: rings wrap and never overflow, so the budget is the same
    with or without them. With False such requests are admitted and end
    early with ``Generation.truncated``. Kill-switches: ``windowed_cache=
    False`` allocates every group at the full length (the masked-full-cache
    baseline), ``quantised_cache=False`` drops ``cfg.kv_format`` so every
    group stores dense rows."""

    def __init__(self, cfg: ModelConfig, params, batch_slots: int = 4,
                 kv_len: int = 256, prefill_chunk: int = 8,
                 strict_admission: bool = True, windowed_cache: bool = True,
                 quantised_cache: bool = True, device=None):
        self.device = resolve_device(device)
        if not quantised_cache and cfg.kv_format:
            cfg = cfg.replace(kv_format="")
        self.windowed_cache = windowed_cache
        self.cfg = cfg
        self.fam = get_family(cfg.family)
        if not self.fam.supports_ragged:
            raise ValueError(
                f"family {cfg.family!r} does not implement the ragged "
                "serving protocol (supports_ragged)")
        self.params = params_to(params, self.device)
        self.B = batch_slots
        self.kv_len = kv_len
        self.prefill_chunk = max(1, prefill_chunk)
        self.strict_admission = strict_admission
        # engine step clock: device steps over the engine lifetime
        self.steps_total = 0
        self._state = self._zero_state()
        self._slots: List[Optional[Generation]] = [None] * batch_slots
        self._queue: List[Request] = []
        self._slot_pos = np.zeros(batch_slots, np.int32)
        self._slot_steps = np.zeros(batch_slots, np.int64)  # deadline clock
        self._slot_prompt: List[List[int]] = [[] for _ in range(batch_slots)]
        # slots admitted (or quarantined) since the last step: their next
        # step carries batch["reset"] so the step wipes the old state
        self._needs_reset = np.zeros(batch_slots, bool)

    @classmethod
    def from_quantised(cls, cfg: ModelConfig, qparams, plan,
                       packed: bool = True, validate: bool = True, **kw):
        """Build an engine from a quantised checkpoint (``plan.quantise``
        output). ``packed=True`` keeps every packable planned tensor as a
        :class:`PackedTensor` served through ``dequant_matmul``; the rest is
        dequantised. ``validate=True`` integrity-checks every packed tensor
        (``QuantisationPlan.verify_packed``) and raises ``IntegrityError``
        naming the corrupted tensor path."""
        if packed:
            layouts = get_family(cfg.family).pack_layouts(cfg)
            if not layouts:
                raise ValueError(
                    f"family {cfg.family!r} declares an empty pack layout — "
                    "no tensor can serve packed; pass packed=False to serve "
                    "dequantised dense weights")
            params = plan.pack_quantised(qparams, layouts)
            if validate:
                plan.verify_packed(params)
        else:
            params = plan.dequantise(qparams)
        return cls(cfg, params, **kw)

    def _zero_state(self):
        with torch.inference_mode():
            return alloc_decode_state(self.fam, self.cfg, self.B,
                                      self.kv_len, slack=self.prefill_chunk,
                                      device=self.device,
                                      windowed=self.windowed_cache)

    # ------------------------------------------------------------ accounting
    def weight_bytes(self) -> dict:
        """Resident parameter bytes: ``codes`` (the quantised weight
        stream), ``scales``, ``codebooks`` (f32 codepoint tables),
        ``packed`` = their sum, ``dense`` (leaves served in a dense dtype),
        ``total`` and the ``family`` tag."""
        codes = scales = codebooks = dense = 0
        for _, leaf in flat_with_paths(self.params):
            if isinstance(leaf, PackedTensor):
                codes += leaf.codes.numel() * leaf.codes.element_size()
                scales += leaf.scales.numel() * leaf.scales.element_size()
                cb = leaf.codebook()
                codebooks += cb.numel() * cb.element_size()
            else:
                dense += leaf.numel() * leaf.element_size()
        packed = codes + scales + codebooks
        return {"packed": packed, "dense": dense, "total": packed + dense,
                "codes": codes, "scales": scales, "codebooks": codebooks,
                "family": self.cfg.family}

    def cache_bytes(self) -> dict:
        """Resident decode-state bytes: ``total`` over the allocated state,
        the family's cache geometry breakdown (``kv`` with its code/scale
        split, ``dense_kv``, ``uniform_kv``, ``cache_groups``, ...) and
        ``other`` (non-KV state, e.g. pos)."""
        total = sum(t.numel() * t.element_size()
                    for t in self._state.values())
        out = {"total": total, "family": self.cfg.family}
        spec = self.fam.cache_spec(self.cfg, self.B, self.kv_len,
                                   slack=self.prefill_chunk,
                                   windowed=self.windowed_cache)
        cb = spec.cache_bytes()
        out.update(cb)
        out["other"] = total - cb["kv"]
        return out

    # ------------------------------------------------------------------- api
    def submit(self, req: Request):
        """Queue a request after :meth:`validate_request`."""
        self.validate_request(req)
        req._t_submit = time.monotonic()  # type: ignore[attr-defined]
        req._submit_step = self.steps_total  # type: ignore[attr-defined]
        self._queue.append(req)

    def validate_request(self, req: Request) -> None:
        """Reject malformed or over-budget requests (the reference's checks
        and messages): empty prompt, ``max_new_tokens <= 0``,
        ``deadline_steps < 1``, a prompt that does not fit ``kv_len``, and —
        with ``strict_admission`` — prompt + max_new over ``kv_len``. A rid
        colliding with a queued or live request warns."""
        if not req.prompt:
            raise ValueError(
                f"request rid={req.rid}: empty prompt — at least one token "
                "is required to decode from")
        if req.max_new_tokens <= 0:
            raise ValueError(
                f"request rid={req.rid}: max_new_tokens="
                f"{req.max_new_tokens} must be >= 1")
        if req.deadline_steps is not None and req.deadline_steps < 1:
            raise ValueError(
                f"request rid={req.rid}: deadline_steps="
                f"{req.deadline_steps} must be >= 1 (or None)")
        active = {r.rid for r in self._queue} | {
            g.rid for g in self._slots if g is not None}
        if req.rid in active:
            warnings.warn(
                f"submit: rid={req.rid} collides with a queued or live "
                "request — sampling seeds per (rid, token index), so the "
                "two streams will be identical at temperature > 0; use "
                "unique rids", RuntimeWarning, stacklevel=2)
        if len(req.prompt) >= self.kv_len:
            raise ValueError(
                f"request rid={req.rid}: prompt length {len(req.prompt)} "
                f"does not fit the KV budget (kv_len={self.kv_len})")
        if self.strict_admission and \
                len(req.prompt) + req.max_new_tokens > self.kv_len:
            raise ValueError(
                f"request rid={req.rid}: prompt ({len(req.prompt)}) + "
                f"max_new_tokens ({req.max_new_tokens}) exceeds the KV "
                f"budget (kv_len={self.kv_len}) — the generation would be "
                "truncated; shrink the request or build the engine with "
                "strict_admission=False to accept truncated generations")

    def run(self, max_steps: int = 512,
            deadline_s: Optional[float] = None) -> List[Generation]:
        """Drive decode until queue + slots drain, ``max_steps`` expires, or
        the ``deadline_s`` wall-clock watchdog fires. Returns every
        generation that made progress: finished, quarantined, and — when a
        budget ran out — the live partials (``done=False``, with a
        RuntimeWarning); calling ``run`` again continues them."""
        finished: List[Generation] = []
        t0 = time.monotonic()
        watchdog_fired = False
        for _ in range(max_steps):
            if deadline_s is not None and time.monotonic() - t0 > deadline_s:
                watchdog_fired = True
                break
            if not self.step_once(finished):
                break
        # a slot seated by the final step's refill never ran a step: requeue
        # its request at the front instead of returning an empty partial
        requeue: List[Request] = []
        for i, g in enumerate(self._slots):
            if g is not None and self._slot_steps[i] == 0:
                requeue.append(g._req)  # type: ignore[attr-defined]
                self._slots[i] = None
        self._queue[:0] = requeue
        live = [g for g in self._slots if g is not None]
        if watchdog_fired:
            warnings.warn(
                f"ServeEngine.run: wall-clock watchdog deadline_s="
                f"{deadline_s} expired after {time.monotonic() - t0:.2f}s "
                f"with {len(live)} live slot(s) and {len(self._queue)} "
                "queued request(s); partial generations are returned with "
                "done=False and resume on the next run() call",
                RuntimeWarning, stacklevel=2)
            finished.extend(live)
        elif live or self._queue:
            warnings.warn(
                f"ServeEngine.run: max_steps={max_steps} expired with "
                f"{len(live)} live slot(s) and {len(self._queue)} queued "
                "request(s); partial generations are returned with "
                "done=False and resume on the next run() call",
                RuntimeWarning, stacklevel=2)
            finished.extend(live)
        return finished

    def step_once(self, finished: List[Generation]) -> bool:
        """One continuous-batching iteration: admit, run one device step
        over the live slots, emit/quarantine per slot, then refill any slot
        freed mid-wave. Returns False when there was nothing to run."""
        self._fill_slots()
        if all(s is None for s in self._slots):
            return False
        prefill_rows = [
            i for i, g in enumerate(self._slots)
            if g is not None and self._slot_pos[i] < len(self._slot_prompt[i])]
        T = self.prefill_chunk if prefill_rows else 1
        toks = np.zeros((self.B, T), np.int32)
        t_valid = np.zeros(self.B, np.int32)
        for i, g in enumerate(self._slots):
            if g is None:
                continue
            consumed = int(self._slot_pos[i])
            prompt = self._slot_prompt[i]
            if consumed < len(prompt):        # prefill: next chunk
                v = min(T, len(prompt) - consumed)
                toks[i, :v] = prompt[consumed:consumed + v]
            else:                             # decode: last sampled token
                v = 1
                toks[i, 0] = g.tokens[-1]
            t_valid[i] = v
        self._state["pos"] = host_to_device(self._slot_pos, self.device)
        batch = {"tokens": host_to_device(toks, self.device),
                 "t_valid": host_to_device(t_valid, self.device)}
        if self._needs_reset.any():
            batch["reset"] = host_to_device(self._needs_reset, self.device)
            self._needs_reset[:] = False
        with torch.inference_mode():
            logits, self._state = self.fam.decode_step(
                self.params, self._state, batch, self.cfg)
            logits = logits.cpu().numpy()
        self.steps_total += 1
        for i, g in enumerate(self._slots):
            if g is None:
                continue
            v = int(t_valid[i])
            self._slot_pos[i] += v
            self._slot_steps[i] += 1
            if self._slot_pos[i] >= len(self._slot_prompt[i]):
                row = logits[i, v - 1]
                if np.isfinite(row).all():
                    self._emit_token(i, g, row, finished)
                else:
                    self._quarantine(
                        i, g, "non-finite logits at token index "
                        f"{len(g.tokens)}", finished)
                    continue
            g = self._slots[i]
            if g is not None:                 # deadline check
                dl = g._req.deadline_steps  # type: ignore[attr-defined]
                if dl is not None and self._slot_steps[i] >= dl:
                    self._quarantine(
                        i, g, f"deadline_steps={dl} exceeded with "
                        f"{len(g.tokens)} token(s) generated", finished)
        self._fill_slots()
        return True

    def _quarantine(self, i: int, g: Generation, reason: str,
                    finished: List[Generation]) -> None:
        """Evict slot ``i`` alone and raise its reset bit so the next step
        wipes its (possibly poisoned) KV rows before any reuse."""
        g.failed = True
        g.fail_reason = reason
        g.t_done = time.monotonic()
        finished.append(g)
        self._slots[i] = None
        self._needs_reset[i] = True
        warnings.warn(
            f"ServeEngine: quarantined slot {i} (rid={g.rid}): {reason}; "
            "remaining slots continue undisturbed", RuntimeWarning,
            stacklevel=3)

    # ------------------------------------------------------------- internals
    def _fill_slots(self):
        for i in range(self.B):
            if self._slots[i] is None and self._queue:
                req = self._queue.pop(0)
                g = Generation(rid=req.rid)
                g.t_submit = getattr(req, "_t_submit", 0.0)
                g.t_admit = time.monotonic()
                g.queue_steps = self.steps_total - getattr(
                    req, "_submit_step", self.steps_total)
                self._slots[i] = g
                g._req = req  # type: ignore[attr-defined]
                self._slot_prompt[i] = list(req.prompt)
                self._slot_pos[i] = 0
                self._slot_steps[i] = 0
                self._needs_reset[i] = True

    def _emit_token(self, i: int, g: Generation, logits_row: np.ndarray,
                    finished: List[Generation]):
        req = g._req  # type: ignore[attr-defined]
        if req.temperature > 0:
            z = logits_row / req.temperature
            p = np.exp(z - z.max())
            p /= p.sum()
            # one stream per (rid, token index), as the reference seeds it
            rng = np.random.default_rng((req.rid & 0xFFFFFFFF,
                                         len(g.tokens)))
            tok = int(rng.choice(len(p), p=p))
        else:
            tok = int(np.argmax(logits_row))
        if not g.tokens:
            g.t_first_token = time.monotonic()
        g.tokens.append(tok)
        hit_budget = len(g.tokens) >= req.max_new_tokens
        hit_kv = self._slot_pos[i] >= self.kv_len - 1
        if hit_budget or hit_kv:
            g.done = True
            g.truncated = bool(hit_kv and not hit_budget)
            g.t_done = time.monotonic()
            finished.append(g)
            self._slots[i] = None


def greedy_generate(cfg: ModelConfig, params, prompt: np.ndarray,
                    n_new: int, kv_len: int = 256, device=None):
    """Single-sequence-per-row greedy decode, one token per step (so
    ``slack=1``), through the same allocation as the engine. ``prompt``:
    (B, P) ints; returns (B, n_new) numpy tokens."""
    dev = resolve_device(device)
    fam = get_family(cfg.family)
    params = params_to(params, dev)
    out = []
    with torch.inference_mode():
        state = alloc_decode_state(fam, cfg, prompt.shape[0], kv_len,
                                   slack=1, device=dev)
        tok = prompt[:, :1]
        for t in range(prompt.shape[1] + n_new - 1):
            batch = {"tokens": torch.from_numpy(
                np.ascontiguousarray(tok, np.int32)).to(dev)}
            logits, state = fam.decode_step(params, state, batch, cfg)
            if t + 1 < prompt.shape[1]:
                tok = prompt[:, t + 1: t + 2]
            else:
                tok = logits[:, 0].argmax(-1).cpu().numpy()[:, None]
                out.append(tok[:, 0])
    return np.stack(out, 1)
