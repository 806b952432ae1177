"""End-to-end training entry point.

    PYTHONPATH=src python -m repro_torch.launch.train --arch paper-100m \
        --variant small --steps 100 --batch 8 --seq 128 \
        [--qat babsmax128:int4] [--quantised-opt] [--ckpt-dir runs/x]

Runs on the card by default; ``--device cpu`` runs on the CPU. All the
fault-tolerance machinery is live: resume from the latest checkpoint in
``--ckpt-dir``, atomic saves, deterministic data. A checkpoint it writes
serves with ``python -m repro_torch.launch.serve --ckpt DIR``.
"""
from __future__ import annotations

import argparse
import json

from repro_torch import configs
from repro_torch.data.pipeline import make_batch_fn
from repro_torch.models.api import get_family, resolve_device
from repro_torch.train import AdamConfig, TrainConfig, train
from repro_torch.train.qat import qat_plan_for


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-100m")
    ap.add_argument("--variant", default="small",
                    choices=["full", "small", "smoke"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--qat", default=None,
                    help="format spec for QAT fake-quant (e.g. babsmax128:int4)")
    ap.add_argument("--quantised-opt", action="store_true")
    ap.add_argument("--grad-compression", default=None)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    try:
        cfg = configs.get_config(args.arch, args.variant)
    except AttributeError:
        cfg = configs.get_config(args.arch, "smoke")
        print(f"[train] no '{args.variant}' variant for {args.arch}; "
              f"using smoke")
    tc = TrainConfig(steps=args.steps, lr=args.lr, warmup=args.warmup,
                     log_every=args.log_every, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every, seed=args.seed,
                     grad_compression=args.grad_compression)
    ac = AdamConfig(quantised_state=args.quantised_opt)
    batch_fn = make_batch_fn(cfg, seq=args.seq, batch=args.batch,
                             seed=args.seed)
    qat_plan = None
    if args.qat:
        # the plan depends only on tensor paths and shapes
        qat_plan = qat_plan_for(get_family(cfg.family).param_specs(cfg),
                                args.qat)

    def log(m):
        print(f"step {m['step']:5d}  loss {m['loss']:.4f}  "
              f"gnorm {m['grad_norm']:.3f}  lr {m['lr']:.2e}  "
              f"{m['s_per_step']:.2f}s/step", flush=True)

    state, history = train(cfg, tc, ac, batch_fn, qat_plan=qat_plan,
                           on_step=log, device=device)
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(history, f, indent=1)
    return state, history


if __name__ == "__main__":
    main()
