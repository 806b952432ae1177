"""Format-design walkthrough on the PyTorch port: reproduce the paper's §3
analysis on your own data — compare scaling schemes, block sizes,
compression, and design a format for a target bit budget
(``examples/format_design.py``'s steps, in ``repro_torch``).

    PYTHONPATH=src python examples/format_design_torch.py [--device cpu]

Runs on the card unless ``--device cpu`` is given; ``main`` returns the
numbers it prints.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import distributions as dist
from repro_torch.core import parse_format
from repro_torch.core.compress import fit_grid_delta
from repro_torch.core.element import cube_root_rms, uniform_grid
from repro_torch.core.scaling import Scaling
from repro_torch.core.search import search_student_t
from repro_torch.core.tensor_format import TensorFormat
from repro_torch.models.api import resolve_device

SAMPLES = 1 << 18
SCALINGS = ["trms:t4nu5", "tabsmax:t4nu5", "cabsmax:t4nu5",
            "babsmax128:t4nu5", "bsignmax128:t4nu5", "trms:t4nu5:sp0.001"]
TARGETS = (3.0, 4.0)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu for the plain path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {"scaling": {}, "grid": {}}

    # "your data": heavy-tailed weights (the paper finds Student-t-ish
    # tails, fig. 25)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(dist.StudentT(nu=5.0).sample(rng, (SAMPLES,))).to(dev)

    print("=== 1. which scaling scheme? (fig. 4) ===")
    for spec in SCALINGS:
        f = parse_format(spec)
        r = float(f.relative_rms_error(x))
        b = f.bits_per_param(tuple(x.shape))
        out["scaling"][spec] = {"R": r, "bits": b, "R_2b": r * 2**b}
        print(f"  {spec:24s} R·2^b = {r * 2**b:.3f}  ({b:.2f} bits)")

    print("\n=== 2. what do the tails look like? ν search (fig. 23) ===")
    s_rms = Scaling(granularity="tensor", statistic="rms",
                    scale_format="exact")
    _, nu, mult, r = search_student_t(
        x, lambda d: TensorFormat(cube_root_rms(d, 4), s_rms))
    out["nu"] = {"nu": nu, "R": r, "scale_mult": mult}
    print(f"  best Student-t ν = {nu:.1f} (R={r:.4f}, scale mult {mult:.2f})")

    print("\n=== 3. if you can afford entropy coding: uniform grid (§2.3) "
          "===")
    for target in TARGETS:
        delta = fit_grid_delta(x.cpu().numpy(), target_bits=target)
        g = TensorFormat(uniform_grid(delta), Scaling(granularity="none",
                                                      statistic="rms"),
                         compressed=True)
        r = float(g.relative_rms_error(x))
        bits = g.measured_bits_per_param(x)
        huffman = g.measured_bits_per_param(x, practical_huffman=True)
        out["grid"][target] = {"R": r, "bits": bits, "R_2b": r * 2**bits,
                               "huffman_bits": huffman}
        print(f"  grid@{target}b: R·2^b = {r * 2**bits:.3f}  ({bits:.2f} "
              f"bits, Huffman {huffman:.2f})")

    print("\ntakeaway (paper §7): under a codebook constraint use ∛p/block "
          "absmax;\nunder an entropy constraint use a uniform grid + "
          "compression.")
    return out


if __name__ == "__main__":
    main()
