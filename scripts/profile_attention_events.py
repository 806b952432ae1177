"""Count the ``decode_attention_quant`` device kernels that torch.profiler
records for the calls of a served run, in a fresh process on one NVIDIA
GPU.

    python3 scripts/profile_attention_events.py [--sessions N]

Builds the kernels, sets up internvl2-26b at full width and 2 layers
(babsmax64:n4 packed, q8 cache: ``chip_smoke.internvl_phase``'s engine),
serves 4 requests once unrecorded, then profiles N runs of 4 requests of 8
tokens and 4 new tokens (``chip_smoke.profile_steps``'s run: one prefill
step, three decode steps, 8 attention calls). One JSON line per session
with the wrapper's calls and the recorded device kernels by name, then one
with the count of sessions whose kernels and calls differ; the card's name
and power limit first. Needs the card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import build
    from repro_torch.serve.engine import Request
    print(cs.device_line(), flush=True)
    build.build()
    mods = cs.wrappers()
    attn = mods["decode_attention_quant"]
    dev = torch.device("cuda", 0)
    eng, _ = cs.build_engine(cs.INTERNVL_ARCH, dev, kv_len=256,
                             kv_format="q8", n_layers=cs.INTERNVL_LAYERS)
    cs.serve(eng, mods, cs.short_requests(eng.cfg.vocab), keep_logits=False)
    differ = 0
    for i in range(args.sessions):
        calls0 = attn.launches
        rng = np.random.default_rng(1)
        for rid in range(eng.B):
            eng.submit(Request(
                prompt=rng.integers(0, eng.cfg.vocab, 8).tolist(),
                max_new_tokens=4, rid=100 + rid))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.run()
            torch.cuda.synchronize()
        kernels = {}
        for e in prof.events():
            if any(n in e.name for n in cs.ATTN_DEVICE_KERNELS):
                kernels[e.name[:80]] = kernels.get(e.name[:80], 0) + 1
        calls = attn.launches - calls0
        differ += sum(kernels.values()) != calls
        print(json.dumps(dict(session=i, calls=calls, kernels=kernels)),
              flush=True)
    print(json.dumps(dict(sessions=args.sessions,
                          sessions_where_kernels_differ_from_calls=differ)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
