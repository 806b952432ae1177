"""Time ``decode_attention_quant`` at gemma3-1b's attention reads in a given
checkout of the port, on one NVIDIA GPU.

    python3 scripts/time_decode_attention.py [--src DIR] [--label NAME]
                                             [--sweep]

``--src`` is the root of a checkout (default: this one); its
``src/repro_torch`` is imported and its kernels are built there. Every case
of ``chip_smoke.ATTN_CASES`` (B=4, H=4, K=1, hd=256: ring S=520 and linear
S=1032, T=1 and 8), q8 and q4, on the inputs ``chip_smoke.attention_inputs``
makes: the call is held to the plain version (2e-2 of max|out|), its device
kernels per call are counted (torch.profiler), and it is timed by
``chip_smoke.py``'s two methods: one call between a pair of events after an
L2 flush and a GPU spin (median of 20), and ``launch_us`` (200 back-to-back
calls between one event pair, with the host's microseconds per call). One
JSON line per case, after the card's name and power limit.

``--sweep`` (this checkout's kernel only) also times each case under other
geometries (``decode_attention.geometry``), to tune the chooser: the
CUDA-core kernel with 8 warps a block and 8, 12 or 16 splits, or 4 warps
and 16 splits; the tensor-core kernel with one, two and three chunks a
split, and the CUDA-core kernel in its place. To compare two
checkouts, run them in turns on one card (parent, change, change,
parent). Needs the card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def device_kernels(fn) -> int:
    """Device kernels one call of ``fn`` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0)) > 0)


def sweep_geometries(daq, kargs, T, S, dev):
    """The geometries ``--sweep`` times beside the chooser's."""
    q, kc, vc = kargs[0], kargs[1], kargs[3]
    B, _, H, hd = q.shape
    K = kc.shape[2]
    n_sm = daq._sm_count(dev.index)
    geo = daq.geometry(B, T, H, K, S, n_sm, hd=hd,
                       tensor_cores=daq.tensor_cores_fit(q, kc, vc))
    if geo.path == 0:
        return [geo._replace(warps=w, splits=s)
                for w, s in ((8, 8), (8, 12), (8, 16), (4, 16))]
    chunks = -(-S // daq.MMA_CHUNK)
    return ([geo._replace(splits=-(-chunks // n)) for n in (1, 2, 3)
             if -(-chunks // n) <= daq.MAX_CLUSTER] +
            [daq.geometry(B, T, H, K, S, n_sm)])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT))
    ap.add_argument("--label", default="")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_decode_attention: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve() / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention as daq
    from repro_torch.kernels.decode_attention.ref import \
        decode_attention_quant_ref

    print(cs.device_line(), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    for fmt in ("q8", "q4"):
        for T, S, ring, window, starts in cs.ATTN_CASES:
            kargs, bits = cs.attention_inputs(dev, gen, T, S, starts, fmt)

            def call():
                return ops.decode_attention_quant(*kargs, window, ring=ring,
                                                  bits=bits)
            got = call()
            want = decode_attention_quant_ref(*kargs, window=window,
                                              ring=ring, bits=bits)
            scale = float(want.float().abs().max())
            err = float((got.float() - want.float()).abs().max())
            cs.check(err <= 2e-2 * scale, f"{fmt} T={T} S={S}: off the plain "
                     f"version by {err} (max|out| {scale})")
            row = dict(label=args.label, src=str(args.src), fmt=fmt, T=T, S=S,
                       ring=ring, max_abs_err=err, max_abs_y=scale,
                       kernels_per_call=device_kernels(call),
                       event_pair_ms=cs.time_ms(call, flush),
                       launch_us=cs.launch_us(call, flush))
            if args.sweep:
                row["sweep"] = []
                for geo in sweep_geometries(daq, kargs, T, S, dev):
                    out = torch.empty_like(kargs[0])

                    def forced():
                        daq.launch(*kargs, out, window, ring, bits, geo)
                    forced()
                    torch.cuda.synchronize()
                    cs.check(float((out.float() - want.float()).abs().max())
                             <= 2e-2 * scale, f"{fmt} T={T} S={S} {geo}: "
                             "off the plain version")
                    row["sweep"].append(dict(
                        geometry=geo._asdict(),
                        event_pair_ms=cs.time_ms(forced, flush),
                        launch_us=cs.launch_us(forced, flush)))
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
