"""Time the tensor-core ``dequant_matmul`` at every served projection shape
under each tile width (``vec``) and K-split count it can take, beside the
wrapper's own choice, on one NVIDIA GPU.

    python3 scripts/tune_dequant_matmul.py [--out results/tune.jsonl]

For each (K, N) of paper-100m, deepseek-7b and gemma3-1b (``chip_smoke.py``'s
``PROJECTIONS``) and M = 1, 4, 32 at 4 bits: each ``vec`` the kernel has
(8 up to 8 tokens, 4) and splits of {1, half, the wrapper's rule at
that width, double, four times} (clamped to the chunk count), each checked against the plain
version and timed as ``chip_smoke.py`` times kernels (one call after an L2
flush and a GPU spin, median of 20). One JSON line per configuration goes
to ``--out``; the best per shape is printed, with the card's name and power
limit first. Needs the card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/tune_dequant_matmul.jsonl")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tune_dequant_matmul: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core.nibble import nibble_k_tile, pack_nibbles
    from repro_torch.core.registry import parse_format
    from repro_torch.kernels.dequant_matmul import dequant_matmul as dqm
    from repro_torch.kernels.dequant_matmul.ref import dequant_matmul_ref

    print(cs.device_line(), flush=True)
    dev = torch.device("cuda", 0)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    cb = parse_format(cs.SPEC).element.torch_codepoints(dev)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    block, bits = 64, 4
    with out.open("w") as f:
        for model, projs in cs.PROJECTIONS.items():
            for (K, N), _, names in projs:
                codes = pack_nibbles(torch.randint(
                    0, 16, (K, N), generator=gen, device=dev,
                    dtype=torch.int32).to(torch.uint8)).contiguous()
                scales = (torch.rand(K, N // block, generator=gen,
                                     device=dev) * 0.05 + 0.01).to(
                    torch.bfloat16)
                for M in (1, 4, 32):
                    x = torch.randn(M, K, generator=gen, device=dev).to(
                        torch.bfloat16)
                    want = dequant_matmul_ref(x, codes, scales, cb, block,
                                              bits).float()
                    scale = float(want.abs().max())
                    chosen = dqm.mma_geometry(1, M, K, N, bits, n_sm)
                    nt = -(-chosen.m_tile // 8)
                    tile = nibble_k_tile(K)
                    best = mine = None
                    for vec in (8, 4):
                        if vec == 8 and nt > 1:
                            continue
                        # the wrapper's rule at this width
                        ct = -(-N // (16 * vec))
                        s0 = max(1, min(chosen.chunks,
                                        2 * n_sm // (ct * chosen.m_tiles)))
                        g0 = chosen._replace(vec=vec, col_tiles=ct)
                        info = dqm.mma_info(bits, M, vec)
                        configs = [
                            g0._replace(splits=sp)
                            for sp in sorted({1, max(1, s0 // 2), s0,
                                              min(chosen.chunks, 2 * s0),
                                              min(chosen.chunks, 4 * s0)})]
                        for geo in configs:
                            splits = geo.splits
                            ws = geo.workspace_floats(1)
                            n_ctr = geo.counters(1)
                            y = torch.empty(M, N, dtype=torch.bfloat16,
                                            device=dev)

                            def call():
                                dqm.launch(x, codes, scales, cb, y, block,
                                           bits, tile, geo, ws, n_ctr)
                            call()
                            torch.cuda.synchronize()
                            diff = (y.float() - want).abs()
                            err = float(diff.max())
                            ok = bool((diff <= 1e-2 * scale
                                       + 1.6e-2 * want.abs()).all())
                            ms = cs.time_ms(call, flush)
                            row = dict(model=model, weights=names, K=K, N=N,
                                       M=M, vec=vec, splits=splits,
                                       chosen=geo == chosen,
                                       ms=ms, max_abs_err=err, ok=ok, **info)
                            f.write(json.dumps(row) + "\n")
                            if row["chosen"]:
                                mine = row
                            if ok and (best is None or ms < best["ms"]):
                                best = row
                    print(json.dumps(dict(best=best, chosen=mine)),
                          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
