"""Time one gemma3-1b layer's quantised KV write in a given checkout of the
port, on one NVIDIA GPU: the fresh k and v rows (hd 256, block 256),
quantised, packed (q4) and scattered into their two caches.

    python3 scripts/time_block_quant.py [--src DIR] [--label NAME]

``--src`` is the root of a checkout (default: this one); its
``src/repro_torch`` is imported and its kernels are built there. The write
runs as that checkout serves it: one paired ``ops.block_quant_kv`` call
where it has one, else two single-tensor ``ops.block_quant`` calls. At 4
rows (a decode step, B = 4) and 32 rows (a prefill chunk of 8), q8 and q4,
the codes and scales are checked bit for bit against the plain version, then
the write is timed by ``chip_smoke.py``'s two methods: one write between a
pair of events after an L2 flush and a GPU spin (median of 20), and
``launch_us`` (200 back-to-back writes between one event pair, with the
host's microseconds per write). One JSON line per case, after the card's
name and power limit. To compare two checkouts, run them in turns in one
session on one card (parent, change, change, parent). Needs the card;
imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_block_quant: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve() / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import ops
    from repro_torch.kernels.block_quant import block_quant as bq
    from repro_torch.kernels.block_quant.ref import (block_quant_ref,
                                                     pack_pairs)
    from repro_torch.serve.cache import kv_codebook

    print(cs.device_line(), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    paired = hasattr(ops, "block_quant_kv")
    hd = 256
    for fmt in ("q8", "q4"):
        cb = kv_codebook(fmt, dev)
        pack = fmt == "q4"
        for rows in (4, 32):
            k, v = ((torch.randn(rows, hd, generator=gen, device=dev) * 3)
                    .to(torch.bfloat16) for _ in range(2))
            dest = torch.randperm(4 * rows, generator=gen, device=dev)[:rows]
            bufs = [(torch.zeros(4 * rows, hd // 2 if pack else hd,
                                 dtype=torch.uint8, device=dev),
                     torch.zeros(4 * rows, 1, device=dev)) for _ in range(2)]

            def write():
                if paired:
                    ops.block_quant_kv(k, v, cb, hd, pack=pack,
                                       out_k=bufs[0], out_v=bufs[1],
                                       rows=dest)
                    return
                for x, b in zip((k, v), bufs):
                    ops.block_quant(x, cb, hd, pack=pack, out=b, rows=dest)
            n0 = bq.launches
            write()
            torch.cuda.synchronize()
            launches = bq.launches - n0
            for x, (c, s) in zip((k, v), bufs):
                want_c, want_s = block_quant_ref(x, cb, hd)
                cs.check(torch.equal(c[dest], pack_pairs(want_c) if pack
                                     else want_c) and
                         torch.equal(s[dest], want_s),
                         f"{fmt} rows={rows}: the write differs from the "
                         "plain version")
            print(json.dumps(dict(
                label=args.label, src=str(args.src), paired=paired, fmt=fmt,
                rows=rows, hd=hd, launches_per_write=launches,
                event_pair_ms=cs.time_ms(write, flush),
                launch_us=cs.launch_us(write, flush))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
