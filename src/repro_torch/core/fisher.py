"""Diagonal Fisher information estimation (Eq. 6/8, §D), with autograd.

The paper's estimator samples a label per position from the model's own
predictive distribution and accumulates squared gradients. As in the
reference (``repro/core/fisher.py``) the estimator is *per sequence*:
sampled-label scores have zero mean, so E[(Σ_p g_p)²] = Σ_p E[g_p²] and
squaring per-sequence gradients is unbiased for Eq. 8. The port takes one
``torch.autograd.grad`` per sequence in a loop over the batch (the
reference's ``vmap``), so memory holds one sequence's activations at a
time. Labels are drawn from an explicit ``torch.Generator`` on the logits'
device; ``jax.random`` draws cannot be reproduced, so the tests fix the
labels on both sides.

Also the paper's two-stage accumulator (low-precision device accumulation,
float64 host accumulation) and the KV-cache variant of the estimator that
``--kv-format auto`` budgets with.
"""
from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

from .plan import flat_with_paths, map_with_paths


def _sample_labels(logits: torch.Tensor, generator) -> torch.Tensor:
    """ŷ ~ softmax(logits) at every position (int64, logits.shape[:-1]),
    drawn from ``generator``, which lies on the logits' device."""
    with torch.no_grad():
        probs = torch.softmax(logits.detach().float(), dim=-1)
        y = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                              generator=generator)
    return y.reshape(logits.shape[:-1])


def sampled_label_loss(apply_fn: Callable, params, batch, rng) -> torch.Tensor:
    """-Σ_p log p(ŷ_p | x) with ŷ ~ p(y | x) (Eq. 8 inner term), summed over
    positions of a single sequence batch. ``rng``: a ``torch.Generator``."""
    logits = apply_fn(params, batch)
    y = _sample_labels(logits, rng)
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, y[..., None])[..., 0]
    return -torch.sum(ll)


def one_loss(apply_fn, params, seq, rng):
    sub = {k: v[None] for k, v in seq.items()}
    return sampled_label_loss(apply_fn, params, sub, rng)


class TwoStageAccumulator:
    """Accumulate ``flush_every`` updates in a ``device_dtype`` buffer on
    each leaf's device, then fold into a float64 host buffer (§D: bf16
    updates are swamped after O(2^8) steps, so long-run accumulation must be
    wider). ``template`` and every update are params-shaped trees."""

    def __init__(self, template, device_dtype=torch.float32,
                 flush_every: int = 64):
        self.template = template
        self.device_dtype = device_dtype
        self.flush_every = flush_every
        leaves = flat_with_paths(template)
        self._dev = {p: torch.zeros(tuple(x.shape), dtype=device_dtype,
                                    device=x.device) for p, x in leaves}
        self._host = {p: np.zeros(tuple(x.shape), np.float64)
                      for p, x in leaves}
        self._pending = 0

    def add(self, update):
        for p, u in flat_with_paths(update):
            self._dev[p].add_(u.to(self.device_dtype))
        self._pending += 1
        if self._pending >= self.flush_every:
            self.flush()

    def flush(self):
        if self._pending == 0:
            return
        for p, d in self._dev.items():
            self._host[p] += d.float().cpu().numpy()   # f32 -> f64, exact
            d.zero_()
        self._pending = 0

    def value(self):
        """The float64 host sums, as a tree of numpy arrays."""
        self.flush()
        return map_with_paths(lambda p, _: self._host[p], self.template)


def _sq_grads(apply_fn, params, batch, rng):
    """Σ over the batch's sequences of each leaf's squared gradient of the
    sampled-label loss (f32, on the leaves' devices), one backward pass per
    sequence."""
    names = [p for p, _ in flat_with_paths(params)]
    bsz = batch[min(batch)].shape[0]
    out = None
    for b in range(bsz):
        leaves = {p: x.detach().requires_grad_(True)
                  for p, x in flat_with_paths(params)}
        tree = map_with_paths(lambda p, _: leaves[p], params)
        loss = one_loss(apply_fn, tree, {k: v[b] for k, v in batch.items()},
                        rng)
        grads = torch.autograd.grad(loss, [leaves[p] for p in names])
        del loss, tree, leaves
        if out is None:
            out = [g.float().square_() for g in grads]
        else:
            for o, g in zip(out, grads):
                o.addcmul_(g, g)
        del grads
    sums = dict(zip(names, out))
    return map_with_paths(lambda p, _: sums[p], params)


def estimate_diag_fisher(
    apply_fn: Callable,
    params,
    batches: Iterable,
    rng,
    max_batches: int | None = None,
    device_dtype=torch.float32,
):
    """Return a tree matching ``params`` (CPU f32 tensors) with the estimated
    diagonal Fisher F_ii ≈ (1/(M·L)) Σ_m Σ_p (∇ log p(ŷ|x))² (Eq. 8).
    ``apply_fn(params, batch)`` gives logits; ``rng`` is a
    ``torch.Generator`` on the params' device."""
    acc = TwoStageAccumulator(params, device_dtype=device_dtype)
    n_tokens = 0
    for i, batch in enumerate(batches):
        if max_batches is not None and i >= max_batches:
            break
        acc.add(_sq_grads(apply_fn, params, batch, rng))
        tok = batch[min(batch)]
        n_tokens += int(np.prod(tuple(tok.shape[:2])))

    def scale(_, f):
        np.divide(f, max(n_tokens, 1), out=f)
        return torch.from_numpy(f.astype(np.float32))
    return map_with_paths(scale, acc.value())


def estimate_kv_fisher(cfg, params, *, batch_size: int = 2, kv_len: int = 32,
                       warm_steps: int = 8, samples: int = 4, rng=None):
    """Diagonal-Fisher sensitivity of the decode-time KV cache, per cache
    group: the Eq. 8 estimator with the *cache rows* in place of the
    weights. ŷ is sampled from the model's own next-token distribution and
    the squared gradient of -log p(ŷ) w.r.t. each group's K/V rows is
    accumulated over ``samples`` label draws.

    Runs a short dense greedy decode without autograd (``cfg.kv_format``
    forced off: the sensitivity of the *values*, not of any quantised
    encoding) to populate ``warm_steps`` rows per slot, then differentiates
    one further decode step. The step writes its new k/v into the cache in
    place, so each draw differentiates with respect to a fresh leaf and
    hands the step a clone of it: a slot the step overwrites gets zero
    gradient, as the reference's functional update gives it. Each layer's
    write also bumps the version of its group's whole stack, which earlier
    layers saved for the backward pass, so the step runs under
    ``allow_mutation_on_saved_tensors`` (a saved tensor is copied before
    it is written). Returns
    ``{group_name: {"numel", "rms", "fisher_mean"}}`` keyed ``g{i}`` in
    cache-group order, with ``numel`` the group's dense cache element count
    (K and V) at this geometry, the unit
    :func:`repro_torch.core.allocation.allocate_kv_formats` budgets in.
    ``rng``: a ``torch.Generator`` on the params' device (default seed 0)."""
    from repro_torch.models.api import get_family
    from repro_torch.serve.engine import alloc_decode_state
    cfg = cfg.replace(kv_format="")
    fam = get_family(cfg.family)
    dev = flat_with_paths(params)[0][1].device
    spec = fam.cache_spec(cfg, batch_size, kv_len, slack=1)
    state = alloc_decode_state(fam, cfg, batch_size, kv_len, slack=1,
                               device=dev)
    if rng is None:
        rng = torch.Generator(device=dev).manual_seed(0)
    tok = torch.ones((batch_size, 1), dtype=torch.int32, device=dev)
    with torch.no_grad():
        for _ in range(warm_steps):
            logits, state = fam.decode_step(params, state, {"tokens": tok},
                                            cfg)
            tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]

    cache_keys = []
    for g in spec.groups:
        cache_keys += [f"k{g.index}", f"v{g.index}"]
    sq = {k: np.zeros(tuple(state[k].shape), np.float64) for k in cache_keys}
    for _ in range(samples):
        leaves = {k: state[k].detach().clone().requires_grad_(True)
                  for k in cache_keys}
        with torch.autograd.graph.allow_mutation_on_saved_tensors():
            st = dict(state, **{k: x.clone() for k, x in leaves.items()})
            logits, _ = fam.decode_step(params, st, {"tokens": tok}, cfg)
            row = logits[:, -1].float()
            y = _sample_labels(row, rng)
            logp = torch.log_softmax(row, dim=-1)
            loss = -torch.sum(torch.gather(logp, 1, y[:, None]))
            grads = torch.autograd.grad(loss,
                                        [leaves[k] for k in cache_keys])
        for k, g in zip(cache_keys, grads):
            sq[k] += np.square(g.double().cpu().numpy())
    # written rows only: every slot decoded warm_steps tokens, so rows
    # [0, warm_steps) of the seq_kv axis (axis 2) hold real K/V values —
    # averaging over the untouched zero tail would dilute both summaries
    written = min(warm_steps, min(g.length for g in spec.groups))
    stats = {}
    for g in spec.groups:
        keys = (f"k{g.index}", f"v{g.index}")
        rows = [state[k].double().cpu().numpy()[:, :, :written] for k in keys]
        fish = [sq[k][:, :, :written] / samples for k in keys]
        stats[f"g{g.index}"] = dict(
            numel=int(sum(state[k].numel() for k in keys)),
            rms=float(np.sqrt(np.mean(np.concatenate(
                [r.ravel() for r in rows]) ** 2) + 1e-30)),
            fisher_mean=float(np.mean(np.concatenate(
                [f.ravel() for f in fish]))),
        )
    return stats


def per_tensor_stats(params, fisher):
    """Summaries used by the bit-allocation scheme: (numel, rms, mean Fisher)
    per tensor, keyed by the plan's tensor paths (``"['layers']['wq']"``),
    in float64 on each tensor's device."""
    fish = dict(flat_with_paths(fisher))
    stats = {}
    for name, p in flat_with_paths(params):
        p = p.detach().double()
        stats[name] = dict(
            numel=int(p.numel()),
            rms=float(torch.sqrt(torch.mean(p ** 2) + 1e-30)),
            fisher_mean=float(torch.as_tensor(fish[name]).double().mean()),
        )
    return stats
