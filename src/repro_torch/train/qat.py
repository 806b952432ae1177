"""Quantisation-aware training (paper §D): the quantised model is a compute
graph over *master* parameters —

  1. compute block/channel/tensor scale from the master tensor
  2. divide by the scale
  3. round to the nearest centroid with a straight-through estimator
  4. multiply by the scale
  5. splice sparse outliers back (if the format has them)

Exactly ``TensorFormat.fake_quant_ste``, applied per-tensor by a
QuantisationPlan in the train step. Centroids are fixed at conversion;
scales are recomputed from masters each step; only masters receive
gradients. The reference's ``repro/train/qat.py``.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.plan import (QuantisationPlan, build_plan,
                                   map_with_paths)
from repro_torch.models.api import ModelConfig

from .loop import TrainConfig, train
from .optimizer import AdamConfig, adam_init, paper_qat_lr


def qat_plan_for(params, spec: str,
                 overrides: Optional[dict] = None) -> QuantisationPlan:
    """Plan covering all quantisable tensors (>=2-D, as in the paper: norm
    gains / small vectors stay in the reference dtype)."""
    return build_plan(params, spec, overrides=overrides)


def run_qat(
    model_cfg: ModelConfig,
    ref_params,
    spec: str,
    batch_fn,
    steps: int = 200,
    lr: float | None = None,
    seed: int = 0,
    **train_kw,
):
    """Paper §D QAT: initialise the student from the reference checkpoint,
    train with full-KL distillation against the teacher (on the teacher's
    device). Returns (state, history, plan)."""
    plan = qat_plan_for(ref_params, spec)
    if lr is None:
        elem_bits = next(f.element_bits() for f in plan.formats.values()
                         if f is not None)
        lr = paper_qat_lr(elem_bits)
    adam_cfg = AdamConfig(b1=0.9, b2=0.95)
    train_cfg = TrainConfig(steps=steps, lr=lr, warmup=max(steps // 20, 1),
                            seed=seed, **train_kw)
    state = {
        "params": map_with_paths(lambda _, x: x.detach().clone(), ref_params),
        "opt": adam_init(ref_params, adam_cfg),
    }
    state, history = train(model_cfg, train_cfg, adam_cfg, batch_fn,
                           qat_plan=plan, ref_params=ref_params, state=state)
    return state, history, plan
