"""End-to-end driver on the PyTorch port: pretrain a small LM → estimate
Fisher → build an Eq.-5 bit-allocated quantisation plan → direct-cast + QAT
→ serve the quantised model with the batched engine, packed
(``examples/train_quantise_serve.py``'s steps, in ``repro_torch``).

    PYTHONPATH=src python examples/train_quantise_serve_torch.py \
        [--steps 150] [--device cpu]

Runs on the card unless ``--device cpu`` is given; ``main`` returns the
numbers it prints. Seeds stand where the reference passes
``jax.random.PRNGKey``: the model's ``init`` takes seed 0 and the Fisher's
label draws an explicit ``torch.Generator`` seeded 1.
"""
import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import build_allocated_plan, build_plan
from repro_torch.core.allocation import allocate_bits, average_bits
from repro_torch.core.fisher import estimate_diag_fisher, per_tensor_stats
from repro_torch.core.metrics import mean_topk_kl
from repro_torch.core.plan import flat_with_paths, map_with_paths, quantisable
from repro_torch.data.pipeline import make_batch_fn
from repro_torch.models.api import get_family, resolve_device
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train import AdamConfig, TrainConfig, train
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import adam_init


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--qat-steps", type=int, default=40)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu for the plain path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = configs.get_config("paper-100m", "small")
    fam = get_family(cfg.family)
    batch_fn = make_batch_fn(cfg, seq=args.seq, batch=args.batch, seed=0)

    def batch_at(step):
        return {k: torch.from_numpy(np.asarray(v)).to(dev)
                for k, v in batch_fn(step).items()}

    def apply(p, b):
        return fam.apply(p, b, cfg)

    # --- 1. pretrain ---------------------------------------------------------
    print(f"=== pretraining {cfg.name} for {args.steps} steps ===")
    tc = TrainConfig(steps=args.steps, lr=3e-3, warmup=10, log_every=25)
    ac = AdamConfig()
    state, hist = train(cfg, tc, ac, batch_fn,
                        on_step=lambda m: print(f"  step {m['step']:4d} "
                                                f"loss {m['loss']:.3f}"),
                        device=dev)
    ref = state["params"]
    losses = [hist[0]["loss"], hist[-1]["loss"]]
    print(f"loss: {losses[0]:.3f} → {losses[1]:.3f}")

    # --- 2. Fisher + bit allocation (Eq. 5) ---------------------------------
    print("\n=== estimating diagonal Fisher (Eq. 8) ===")
    fisher = estimate_diag_fisher(
        apply, ref, (batch_at(5000 + i) for i in range(4)),
        torch.Generator(device=dev).manual_seed(1))
    stats = per_tensor_stats(ref, fisher)
    qstats = {n: s for n, s in stats.items()
              if quantisable(n, dict(flat_with_paths(ref))[n])}
    alloc = allocate_bits(qstats, target_bits=4.0, b_min=2.0, b_max=8.0)
    avg = average_bits(alloc, qstats)
    print(f"allocated avg bits: {avg:.3f} "
          f"(spread {min(alloc.values()):.1f}–{max(alloc.values()):.1f})")

    # --- 3. direct-cast: flat vs allocated ----------------------------------
    eval_batches = [batch_at(9000 + i) for i in range(2)]

    def kl_of(params_q):
        with torch.no_grad():
            return float(np.mean([
                float(mean_topk_kl(apply(ref, b), apply(params_q, b), k=128))
                for b in eval_batches]))

    flat_plan = build_plan(ref, "babsmax128:t4")
    var_plan = build_allocated_plan(ref, alloc, "babsmax128")
    kl_flat = kl_of(flat_plan.fake_quant(ref))
    kl_var = kl_of(var_plan.fake_quant(ref))
    print(f"\n=== direct-cast top-k KL @4b ===\n"
          f"  flat  babsmax128:t4 : {kl_flat:.5f}\n"
          f"  Eq.5  allocated     : {kl_var:.5f}")

    # --- 4. QAT (STE + full-KL distillation, §D) ----------------------------
    # QAT pays off where direct-cast bites: use an aggressive 3-bit format
    qat_plan = build_plan(ref, "babsmax128:int3")
    kl_dc3 = kl_of(qat_plan.fake_quant(ref))
    print(f"\n=== QAT (babsmax128:int3) for {args.qat_steps} steps ===")
    qat_lr = 3e-4
    step = make_train_step(cfg, ac, TrainConfig(steps=args.qat_steps,
                                                lr=qat_lr),
                           lambda s: qat_lr, qat_plan=qat_plan, distill=True)
    st = {"params": map_with_paths(lambda _, x: x, ref),
          "opt": adam_init(ref, ac)}
    for i in range(args.qat_steps):
        st, m = step(st, batch_at(7000 + i), ref)
        if i % 10 == 0:
            print(f"  qat step {i:3d} KL-to-teacher {float(m['loss']):.5f}")
    kl_qat = kl_of(qat_plan.fake_quant(st["params"]))
    print(f"int3 direct-cast KL {kl_dc3:.5f} → after QAT {kl_qat:.5f}")

    # --- 5. serve the quantised model ---------------------------------------
    print("\n=== serving the quantised model ===")
    qparams = flat_plan.quantise(st["params"])
    eng = ServeEngine.from_quantised(cfg, qparams, flat_plan, batch_slots=2,
                                     kv_len=64, device=dev)
    rng = np.random.default_rng(0)
    for rid in range(4):
        eng.submit(Request(prompt=rng.integers(0, cfg.vocab, 4).tolist(),
                           max_new_tokens=8, rid=rid))
    done = eng.run()
    for g in done:
        print(f"  rid={g.rid}: {g.tokens}")
    bits = flat_plan.bits_per_param(ref)
    print(f"\nbits/param served: {bits:.3f} "
          f"(vs 16.0 bf16) — ~{16 / bits:.1f}x weight-"
          f"stream reduction at decode")
    return dict(losses=losses, average_bits=avg, allocation=alloc,
                kl_flat=kl_flat, kl_allocated=kl_var, kl_int3=kl_dc3,
                kl_qat=kl_qat, tokens={g.rid: g.tokens for g in done},
                bits_served=bits)


if __name__ == "__main__":
    main()
