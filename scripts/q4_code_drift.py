"""How far a quantised KV cache amplifies bf16-level differences, on the CPU.

    PYTHONPATH=src python scripts/q4_code_drift.py [--layers 26] [--d-model 512]

Serves 4 requests of 8 tokens on a narrow gemma3-1b (its depth, head
geometry and 5:1 ring pattern; ``--d-model`` wide, vocab 4096) through the
plain path on the CPU, with a q8 and then a q4 KV cache, recording the
prefill step and the first three decode steps. Each recorded step is then
replayed twice on the CPU from an empty cache: once through the plain path
unchanged (must agree exactly), once with every dequantised weight rounded
as the card's tensor-core kernels round it (codebook to bf16, codebook x
scale to bf16 again). The second replay prints the largest logit error over
max|logit| per format: the drift that the card's rounding alone causes
when each side quantises its own K and V, because a code flips wherever a
value lies near a midpoint. Plain torch on the CPU; times are not printed.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import build_plan
from repro_torch.core.nibble import unpack_nibbles
from repro_torch.kernels import ops
from repro_torch.models import transformer
from repro_torch.serve.engine import (Request, ServeEngine,
                                      alloc_decode_state)

SPEC = "babsmax64:n4"


def card_rounded_weight(codes, scales, codebook, block, bits):
    """The dense weight as the tensor-core kernels see it: cb in bf16, then
    cb * scale rounded to bf16 (round to nearest)."""
    if bits == 4:
        codes = unpack_nibbles(codes, 2 * codes.shape[-2])
    *lead, K, N = codes.shape
    cb = codebook.float().to(torch.bfloat16).float()
    vals = cb[codes.long()].reshape(*lead, K, N // block, block)
    w = (vals * scales.float()[..., None]).to(torch.bfloat16).float()
    return w.reshape(*lead, K, N)


def card_matmul(x, codes, scales, codebook, block=128, bits=8):
    w = card_rounded_weight(codes, scales, codebook, block, bits)
    return torch.matmul(x.float(), w).to(x.dtype)


def card_matmul_t(x, codes, scales, codebook, block=128, bits=8):
    w = card_rounded_weight(codes, scales, codebook, block, bits)
    return torch.matmul(x.float(), w.t()).to(x.dtype)


def record(eng, requests, n_decode=3):
    """Serve ``requests`` and keep (pos, batch, logits) of the steps up to
    the ``n_decode``-th decode step."""
    steps, step = [], eng.fam.decode_step

    def recorder(params, state, batch, cfg):
        pos = state["pos"].clone()
        logits, state = step(params, state, batch, cfg)
        if sum(r[1]["tokens"].shape[1] == 1 for r in steps) < n_decode:
            steps.append((pos, {k: v.clone() for k, v in batch.items()},
                          logits.float()))
        return logits, state
    eng.fam = dataclasses.replace(eng.fam, decode_step=recorder)
    for rid, (prompt, n) in enumerate(requests):
        eng.submit(Request(prompt=prompt, max_new_tokens=n, rid=rid))
    eng.run(max_steps=64)
    eng.fam = dataclasses.replace(eng.fam, decode_step=step)
    return steps


def replay_drift(eng, steps):
    """Largest |replay - recorded| / max|recorded| over the valid positions
    of a replay from an empty cache."""
    state = alloc_decode_state(eng.fam, eng.cfg, eng.B, eng.kv_len,
                               slack=eng.prefill_chunk, device="cpu")
    worst = 0.0
    with torch.inference_mode():
        for pos, batch, want in steps:
            state["pos"] = pos
            got, state = eng.fam.decode_step(eng.params, state, batch,
                                             eng.cfg)
            for i, tv in enumerate(batch["t_valid"].tolist()):
                for t in range(tv):
                    w = want[i, t].numpy()
                    err = np.abs(got[i, t].numpy() - w).max()
                    worst = max(worst, float(err / np.abs(w).max()))
    return worst


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=26)
    ap.add_argument("--d-model", type=int, default=512)
    args = ap.parse_args()
    torch.set_num_threads(4)
    base = configs.get_config("gemma3-1b", "full").replace(
        n_layers=args.layers, d_model=args.d_model, d_ff=2 * args.d_model,
        vocab=4096)
    rng = np.random.default_rng(0)
    requests = [(rng.integers(0, base.vocab, 8).tolist(), 8)
                for _ in range(4)]
    for fmt in ("q8", "q4"):
        cfg = base.replace(kv_format=fmt)
        params = transformer.init(cfg, seed=0, device="cpu")
        plan = build_plan(params, SPEC)
        eng = ServeEngine.from_quantised(cfg, plan.quantise(params), plan,
                                         batch_slots=4, kv_len=64,
                                         prefill_chunk=8, device="cpu")
        steps = record(eng, requests)
        same = replay_drift(eng, steps)
        plain = ops.dequant_matmul_ref, ops.dequant_matmul_t_ref
        ops.dequant_matmul_ref, ops.dequant_matmul_t_ref = (card_matmul,
                                                            card_matmul_t)
        try:
            drift = replay_drift(eng, steps)
        finally:
            ops.dequant_matmul_ref, ops.dequant_matmul_t_ref = plain
        print(f"{fmt}: {len(steps)} steps ({args.layers} layers, d_model "
              f"{args.d_model}); plain replay {same:.4g}, card-rounded "
              f"replay {drift:.4g} of max|logit|", flush=True)


if __name__ == "__main__":
    main()
