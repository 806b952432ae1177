"""Training loop substrate: loss functions (CE pretraining + full-KL QAT
distillation per paper §D), the train-step factory with QAT fake-quant
(STE), gradient clipping, an optional gradient-compression hook, gradient
accumulation, and a fault-tolerant outer loop (checkpoint/restart, retry,
heartbeat). The reference's ``repro/train/loop.py`` in torch: the step is
eager (autograd, no compilation), the reference's ``lax.scan`` over
microbatches is a Python loop accumulating f32 gradients, and the teacher
of a distillation step runs under ``torch.no_grad``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.plan import (QuantisationPlan, flat_with_paths,
                                   map_with_paths)
from repro_torch.models.api import ModelConfig, get_family, resolve_device
from .optimizer import AdamConfig, adam_init, adam_update


@dataclass
class TrainConfig:
    steps: int = 100
    lr: float = 3e-4
    warmup: int = 10
    grad_clip: float = 1.0
    log_every: int = 10
    ckpt_every: int = 0           # 0 = disabled
    ckpt_dir: str = ""
    seed: int = 0
    # gradient accumulation: split the global batch into N microbatches,
    # fwd+bwd per slice — divides the live-activation footprint by N
    microbatches: int = 1
    # gradient compression (simulated int8 block all-reduce)
    grad_compression: Optional[str] = None   # e.g. "babsmax256:int8s"


def shift_labels(cfg: ModelConfig, batch, logits):
    """Align logits with next-token targets; returns (logits, labels, mask).
    (The reference's visual-prefix case comes with the internvl family.)"""
    tokens = batch["tokens"]
    labels = tokens[:, 1:].long()
    return logits[:, :-1], labels, torch.ones(labels.shape,
                                              dtype=torch.float32,
                                              device=labels.device)


def ce_loss(cfg: ModelConfig, logits, batch):
    lg, labels, mask = shift_labels(cfg, batch, logits)
    logp = torch.log_softmax(lg.float(), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None])[..., 0]
    return -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def full_kl_loss(ref_logits, logits):
    """Paper §D QAT objective: full KL(ref ‖ student), mean over positions."""
    p = torch.log_softmax(ref_logits.float(), dim=-1)
    q = torch.log_softmax(logits.float(), dim=-1)
    kl = torch.sum(torch.exp(p) * (p - q), dim=-1)
    return torch.mean(kl)


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for _, x in flat_with_paths(tree)))


def clip_by_global_norm(tree, max_norm):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return map_with_paths(lambda _, x: x * scale, tree), norm


def make_train_step(
    model_cfg: ModelConfig,
    adam_cfg: AdamConfig,
    train_cfg: TrainConfig,
    lr_fn: Callable,
    qat_plan: Optional[QuantisationPlan] = None,
    distill: bool = False,
):
    """Build ``train_step(state, batch[, ref_params]) -> (state, metrics)``.

    ``qat_plan``: per-tensor fake-quant with STE is applied to parameters in
    the forward pass; the scale is recomputed from master params every step
    and only master params are updated — the paper's §D QAT recipe.
    ``distill``: loss = full KL against a reference model (teacher forward
    inside the step, without autograd). The step leaves ``state`` as it was
    and returns a new one, so a failed step can be re-executed."""
    fam = get_family(model_cfg.family)
    grad_fmt = None
    if train_cfg.grad_compression:
        from repro_torch.core import parse_format
        grad_fmt = parse_format(train_cfg.grad_compression)

    def loss_fn(params, batch, ref_params):
        ref_logits = None
        if distill:
            with torch.no_grad():
                ref_logits = fam.apply(ref_params, batch, model_cfg)
        p = qat_plan.fake_quant_ste(params) if qat_plan is not None else params
        logits = fam.apply(p, batch, model_cfg)
        if distill:
            return full_kl_loss(ref_logits, logits)
        return ce_loss(model_cfg, logits, batch)

    def value_and_grad(params, batch, ref_params):
        names = [n for n, _ in flat_with_paths(params)]
        leaves = {n: x.detach().requires_grad_(True)
                  for n, x in flat_with_paths(params)}
        loss = loss_fn(map_with_paths(lambda n, _: leaves[n], params), batch,
                       ref_params)
        grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        return loss.detach(), dict(zip(names, grads))

    def grads_of(params, batch, ref_params):
        n_mb = max(train_cfg.microbatches, 1)
        if n_mb == 1:
            loss, g = value_and_grad(params, batch, ref_params)
            return loss, map_with_paths(lambda n, _: g[n], params)
        # gradient accumulation over microbatch slices of the batch's
        # leading axis; activations live only for one slice at a time
        b = batch["tokens"].shape[0]
        if b % n_mb:
            raise ValueError(f"batch {b} does not split into {n_mb} "
                             "microbatches")
        size = b // n_mb
        acc = {n: torch.zeros(tuple(x.shape), dtype=torch.float32,
                              device=x.device)
               for n, x in flat_with_paths(params)}
        loss_sum = 0.0
        for i in range(n_mb):
            mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            loss, g = value_and_grad(params, mb, ref_params)
            for n, gi in g.items():
                acc[n] = acc[n] + gi.float()
            loss_sum = loss_sum + loss
        inv = 1.0 / n_mb
        return loss_sum * inv, map_with_paths(lambda n, _: acc[n] * inv,
                                              params)

    def train_step(state, batch, ref_params=None):
        params, opt = state["params"], state["opt"]
        loss, grads = grads_of(params, batch, ref_params)
        with torch.no_grad():
            if grad_fmt is not None:
                # simulated compressed all-reduce: block-int8 round trip on
                # the gradient (models the collective's payload precision)
                grads = map_with_paths(
                    lambda _, g: grad_fmt.fake_quant(g) if g.ndim >= 2 else g,
                    grads)
            grads, gnorm = clip_by_global_norm(grads, train_cfg.grad_clip)
            lr = lr_fn(opt["step"])
        new_params, new_opt = adam_update(grads, opt, params, lr, adam_cfg)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def init_state(seed: int, model_cfg: ModelConfig, adam_cfg: AdamConfig,
               device=None):
    """Seeded parameters (``fam.init``; ``jax.random`` draws cannot be
    reproduced) and zero Adam state, on ``device`` (default the card)."""
    fam = get_family(model_cfg.family)
    params = fam.init(model_cfg, seed=seed, device=device)
    return {"params": params, "opt": adam_init(params, adam_cfg)}


def train(
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    adam_cfg: AdamConfig,
    batch_fn: Callable[[int], dict],
    lr_fn=None,
    qat_plan=None,
    ref_params=None,
    state=None,
    on_step=None,
    device=None,
):
    """Fault-tolerant training loop: resumes from the latest checkpoint in
    ``ckpt_dir``, writes atomic checkpoints, retries transient step failures,
    emits heartbeats. Without ``state`` it starts from ``init_state`` on
    ``device`` (default the card); with one, on its device. Batches
    (numpy) move to that device each step. Returns (state, history)."""
    from .checkpoint import (latest_checkpoint, restore_checkpoint,
                             save_checkpoint)
    from .fault_tolerance import Heartbeat, retry
    from .optimizer import cosine_schedule

    if lr_fn is None:
        lr_fn = cosine_schedule(train_cfg.lr, train_cfg.steps,
                                train_cfg.warmup)
    step0 = 0
    if state is None:
        state = init_state(train_cfg.seed, model_cfg, adam_cfg,
                           device=resolve_device(device))
        if train_cfg.ckpt_dir:
            ck = latest_checkpoint(train_cfg.ckpt_dir)
            if ck is not None:
                state, meta = restore_checkpoint(ck, template=state)
                step0 = int(meta["step"])
    dev = flat_with_paths(state["params"])[0][1].device

    train_step = make_train_step(model_cfg, adam_cfg, train_cfg, lr_fn,
                                 qat_plan=qat_plan,
                                 distill=ref_params is not None)
    hb = Heartbeat(train_cfg.ckpt_dir) if train_cfg.ckpt_dir else None
    history = []
    t_last = time.monotonic()
    for step in range(step0, train_cfg.steps):
        batch = {k: torch.from_numpy(np.asarray(v)).to(dev)
                 for k, v in batch_fn(step).items()}

        def do_step():
            return train_step(state, batch, ref_params)

        state, metrics = retry(do_step, max_attempts=3)
        if hb:
            hb.beat(step)
        if step % train_cfg.log_every == 0 or step == train_cfg.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["s_per_step"] = ((time.monotonic() - t_last)
                               / max(train_cfg.log_every, 1))
            t_last = time.monotonic()
            history.append(m)
            if on_step:
                on_step(m)
        if (train_cfg.ckpt_every and train_cfg.ckpt_dir
                and (step + 1) % train_cfg.ckpt_every == 0):
            save_checkpoint(train_cfg.ckpt_dir, state, step + 1,
                            meta={"model": model_cfg.name})
    return state, history
