"""Quickstart on the PyTorch port: design an optimal format with the paper's
machinery and quantise a model with it (``examples/quickstart.py``'s steps,
in ``repro_torch``).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Runs on the card unless ``--device cpu`` is given; ``main`` returns the
numbers it prints.
"""
import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import build_plan, parse_format
from repro_torch.core import distributions as dist
from repro_torch.core.element import cube_root_absmax
from repro_torch.core.plan import flat_with_paths
from repro_torch.models.api import get_family, resolve_device

FORMATS = ["babsmax128:t4", "trms:t4", "trms:t4:sp0.001", "bsignmax128:t4"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu for the plain path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {"formats": {}}

    # --- 1. element formats from the cube-root rule (§2.1) -----------------
    # block-128 absmax ∛p Student-t first, then fixed-length tensor formats:
    # the paper's headline gap
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        1 << 16).astype(np.float32)).to(dev)
    for spec in FORMATS:
        f = parse_format(spec)
        bits = f.bits_per_param(tuple(x.shape))
        r = float(f.relative_rms_error(x))
        out["formats"][spec] = {"bits": bits, "R": r}
        print(f"format {f.describe():24s} bits/param={bits:.3f}  R={r:.4f}")

    # --- 2. quantise a whole model with a per-tensor plan -------------------
    cfg = configs.get_config("paper-100m", "smoke")
    fam = get_family(cfg.family)
    params = fam.init(cfg, seed=0, device=dev)
    plan = build_plan(params, "babsmax128:int4",
                      overrides={"embed": "babsmax128:int8"})  # 8-bit embeds
    out["model_bits"] = plan.bits_per_param(params)
    print(f"\nmodel bits/param: {out['model_bits']:.3f} "
          f"(int4 weights, int8 embeddings, norms kept bf16)")

    # --- 3. direct-cast and packed round trips ------------------------------
    pq = plan.fake_quant(params)          # direct-cast (round-to-nearest)
    packed = plan.quantise(params)        # packed codes + scales (checkpoint)
    restored = plan.dequantise(packed)
    out["round_trip"] = max(
        float((a - b).abs().max())
        for (_, a), (_, b) in zip(flat_with_paths(pq),
                                  flat_with_paths(restored)))
    print(f"packed round-trip max |Δ| vs fake-quant: {out['round_trip']:.2e}")

    # --- 4. codebooks are plain arrays — inspect one -----------------------
    cb = cube_root_absmax(dist.StudentT(nu=7.0), 4, 128)
    out["codebook"] = cb.np_codepoints().tolist()
    print(f"\n∛p Student-t absmax codebook (16 pts): "
          f"{np.round(cb.np_codepoints(), 3)}")
    return out


if __name__ == "__main__":
    main()
