"""Serving driver: random-init (seeded) weights, optionally quantised and
packed, served to a batch of requests by the continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
        --variant full --quantise babsmax64:n4 --packed --kv-format q8

Runs on the card by default; ``--device cpu`` runs the plain torch path.
``--kv-format auto --kv-budget-bytes N`` picks each cache group's format
(f32, q8 or q4) by the Fisher sensitivity of its K/V rows, measured on a
short dense decode, so that the serving cache fits N bytes. ``--ckpt DIR``
serves the parameters of a training checkpoint (``launch.train``'s, or the
reference package's: the layout is the same) instead of random ones. The
traffic replay front end comes with a later slice.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import build_plan
from repro_torch.models.api import get_family, resolve_device, torch_dtype
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-100m")
    ap.add_argument("--variant", default="small")
    ap.add_argument("--quantise", default=None,
                    help="serve with weights quantised to this format spec")
    ap.add_argument("--packed", action="store_true",
                    help="with --quantise: keep weights packed (codes — two "
                         "per byte for ≤16-point codebooks — + block scales) "
                         "and serve through dequant_matmul instead of "
                         "materialising dense fake-quant weights")
    ap.add_argument("--uniform-cache", action="store_true",
                    help="disable the rolling-window ring allocation for "
                         "local-attention layer groups and serve from the "
                         "masked full-length baseline layout")
    ap.add_argument("--kv-format", default=None,
                    help="KV-cache storage: f32 (dense, the default), q8 or "
                         "q4 (block-scaled codes + per-row scales), one for "
                         "every cache group or a comma list, one per group; "
                         "or auto (per-group Fisher allocation under "
                         "--kv-budget-bytes)")
    ap.add_argument("--kv-budget-bytes", type=int, default=None,
                    help="with --kv-format auto: resident KV cache byte "
                         "budget the Fisher allocator demotes formats "
                         "(f32 -> q8 -> q4, least-sensitive group first) "
                         "to meet")
    ap.add_argument("--prefill-chunk", type=int, default=8,
                    help="batched chunked-prefill width")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--kv-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--relaxed-admission", action="store_true",
                    help="admit requests whose prompt + max_new exceeds "
                         "--kv-len and flag the truncated generations, "
                         "instead of rejecting them at submit")
    ap.add_argument("--no-validate", action="store_true",
                    help="with --packed: skip the load-time integrity pass "
                         "over the packed checkpoint")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="wall-clock watchdog for the whole run(): on "
                         "expiry, return resumable partial generations")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain torch path)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and prompts")
    ap.add_argument("--ckpt", default=None,
                    help="serve state['params'] of this training checkpoint "
                         "(a step_* directory, or a checkpoint directory: "
                         "its latest step) instead of random weights")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.get_config(args.arch, args.variant)
    fam = get_family(cfg.family)
    if args.ckpt:
        params = _load_ckpt_params(args.ckpt, fam, cfg, device)
    else:
        params = fam.init(cfg, seed=args.seed, device=device)
    if args.kv_format == "auto":
        cfg = cfg.replace(kv_format=_auto_kv_format(cfg, fam, params, args))
    elif args.kv_format and args.kv_format != "f32":
        cfg = cfg.replace(kv_format=args.kv_format)
    kw = dict(batch_slots=args.slots, kv_len=args.kv_len,
              prefill_chunk=args.prefill_chunk,
              strict_admission=not args.relaxed_admission,
              windowed_cache=not args.uniform_cache, device=device)
    if args.quantise:
        plan = build_plan(params, args.quantise)
        bits = plan.bits_per_param(params)
        if args.packed:
            eng = ServeEngine.from_quantised(
                cfg, plan.quantise(params), plan,
                validate=not args.no_validate, **kw)
            wb = eng.weight_bytes()
            if wb["packed"] == 0:
                raise SystemExit(
                    f"[serve] --packed: no tensor of {cfg.family!r} packs "
                    f"under format {args.quantise!r} — use a block-scaled "
                    "codebook format, or drop --packed to serve dense")
            print(f"[serve] packed {args.quantise} ({bits:.2f} bits/param): "
                  f"{wb['packed']:,} packed ({wb['codes']:,} codes + "
                  f"{wb['scales']:,} scales + {wb['codebooks']:,} codebooks)"
                  f" + {wb['dense']:,} dense bytes resident")
        else:
            eng = ServeEngine(cfg, plan.fake_quant(params), **kw)
            print(f"[serve] weights quantised to {args.quantise} "
                  f"({bits:.2f} bits/param)")
    else:
        eng = ServeEngine(cfg, params, **kw)
    del params
    cb = eng.cache_bytes()
    print(f"[serve] decode cache {cb['total']:,} bytes resident "
          f"({cb['cache_ratio_vs_uniform']}x the uniform full-length "
          "dense cache)")
    if eng.cfg.kv_format:
        print(f"[serve] quantised KV ({eng.cfg.kv_format}): "
              f"{cb['kv']:,} bytes ({cb['code_bytes']:,} codes + "
              f"{cb['scale_bytes']:,} scales), "
              f"{cb['cache_ratio_vs_dense']}x the dense cache")
    for i, g in enumerate(cb["cache_groups"]):
        print(f"[serve]   group {i} [{g['format']}, window {g['window']}] "
              f"{g['n_layers']} layer(s) x {g['length']} slots: "
              f"{g['bytes']:,} bytes")
    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, size=4).tolist()
        eng.submit(Request(prompt=prompt, max_new_tokens=args.max_new,
                           rid=rid))
    t0 = time.monotonic()
    done = eng.run(deadline_s=args.deadline_s)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.monotonic() - t0
    n_tok = sum(len(g.tokens) for g in done)
    n_trunc = sum(g.truncated for g in done)
    n_failed = sum(g.failed for g in done)
    print(f"[serve] {len(done)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / max(dt, 1e-9):.1f} tok/s)"
          + (f", {n_trunc} truncated at the KV budget" if n_trunc else "")
          + (f", {n_failed} quarantined" if n_failed else ""))
    for g in done[:4]:
        print(f"  rid={g.rid} tokens={g.tokens}"
              + (f" FAILED: {g.fail_reason}" if g.failed else ""))
    return done


def _load_ckpt_params(path, fam, cfg, device):
    """``state["params"]`` of a training checkpoint on ``device``, each
    tensor checked against the config's parameter specs."""
    import os

    from repro_torch.core.plan import flat_with_paths, map_with_paths
    from repro_torch.train.checkpoint import (latest_checkpoint,
                                              restore_checkpoint)
    if not os.path.exists(os.path.join(path, "manifest.json")):
        latest = latest_checkpoint(path)
        if latest is None:
            raise SystemExit(f"[serve] --ckpt: no checkpoint in {path!r}")
        path = latest
    state, meta = restore_checkpoint(path)
    got = dict(flat_with_paths(state["params"]))
    specs = fam.param_specs(cfg)
    want = {n: tuple(s.shape) for n, s in flat_with_paths(specs)}
    have = {n: tuple(x.shape) for n, x in got.items()}
    if have != want:
        diff = sorted(set(have.items()) ^ set(want.items()))
        raise SystemExit(f"[serve] --ckpt {path}: parameters do not match "
                         f"{cfg.name}: {diff[:4]}")
    print(f"[serve] parameters of {path} (step {meta['step']})")
    return map_with_paths(lambda n, s: got[n].to(device=device,
                                                 dtype=torch_dtype(s.dtype)),
                          specs)


def _auto_kv_format(cfg, fam, params, args) -> str:
    """--kv-format auto: estimate per-cache-group Fisher sensitivity on a
    short dense decode, then demote formats (f32 -> q8 -> q4, least
    sensitive first) until the serving-geometry cache fits
    --kv-budget-bytes. Returns the explicit comma-separated format list
    the config carries from here on."""
    from repro_torch.core.allocation import (allocate_kv_formats,
                                             kv_format_bytes)
    from repro_torch.core.fisher import estimate_kv_fisher
    if args.kv_budget_bytes is None:
        raise SystemExit("[serve] --kv-format auto needs --kv-budget-bytes")
    if fam.cache_spec is None:
        raise SystemExit(f"[serve] --kv-format auto: family {cfg.family!r} "
                         "declares no cache geometry")
    stats = estimate_kv_fisher(cfg, params, batch_size=2,
                               kv_len=min(args.kv_len, 32))
    # rescale calibration numels to the serving geometry (same groups,
    # serving batch/kv_len): budget what will actually be resident
    spec = fam.cache_spec(cfg, args.slots, args.kv_len,
                          slack=args.prefill_chunk,
                          windowed=not args.uniform_cache)
    for g in spec.groups:
        stats[f"g{g.index}"]["numel"] = (
            2 * len(g.layers) * args.slots * g.length * spec.kv_heads *
            spec.head_dim)
    alloc = allocate_kv_formats(stats, args.kv_budget_bytes, cfg.hd)
    fmts = [alloc[f"g{g.index}"] for g in spec.groups]
    total = sum(stats[f"g{g.index}"]["numel"] *
                kv_format_bytes(alloc[f"g{g.index}"], cfg.hd)
                for g in spec.groups)
    print(f"[serve] kv auto allocation under {args.kv_budget_bytes:,} B: "
          f"{','.join(fmts)} (~{total:,.0f} B resident KV)")
    return ",".join(fmts)


if __name__ == "__main__":
    main()
