"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printed as JSON lines:

1. device: the card's name and power limit (nvidia-smi), then the build of
   every CUDA kernel of the serving path from ``src/repro_torch`` sources.
2. kernel: ``dequant_matmul`` against its plain torch version on the card at
   every projection shape of paper-100m and deepseek-7b (M = 1, 4, 32 at
   4 bits, one 8-bit shape, one lead-dim case), with the kernel's, the plain
   version's and one ``torch.matmul`` call's times beside the byte bound.
3. serve paper-100m full: babsmax64:n4 packed, seeded weights, 4 slots x 4
   requests; launch count, resident bytes, and card-vs-CPU logits/tokens.
4. serve deepseek-7b full: the same at kv_len 256, weights initialised,
   quantised and packed on the card.
5. the kernels summary line, then ``{"ok": true, "device": ...}``.

Any failed check raises and the script exits non-zero without the last
line. It exits non-zero at once when no CUDA device is present.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12    # H100 SXM dense bf16 tensor-core peak
SPIN_CYCLES = 2_000_000      # about 1 ms at the H100's clock
SPEC = "babsmax64:n4"
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/dequant_matmul.cu"
KERNEL_REPLACES = "src/repro/kernels/dequant_matmul/dequant_matmul.py:125"

# (K, N) of every projection on the decode path, with launches per step
PROJECTIONS = {
    "paper-100m": [((768, 768), 24, "wq+wo"), ((768, 256), 24, "wk+wv"),
                   ((768, 2048), 24, "w_gate+w_up"), ((2048, 768), 12,
                                                      "w_down"),
                   ((768, 32768), 1, "unembed")],
    "deepseek-7b": [((4096, 4096), 120, "wq+wk+wv+wo"),
                    ((4096, 11008), 60, "w_gate+w_up"),
                    ((11008, 4096), 30, "w_down"),
                    ((4096, 102400), 1, "unembed")],
}
LAUNCHES_PER_STEP = {"paper-100m": 85, "deepseek-7b": 211}
WEIGHT_BYTES = {
    "paper-100m": dict(total=66_924_096, codes=62_914_560, scales=3_932_160,
                       codebooks=576, dense=76_800),
    "deepseek-7b": dict(total=3_671_999_040, codes=3_455_057_920,
                        scales=215_941_120, codebooks=576, dense=999_424),
}


def emit(**kw):
    print(json.dumps(kw), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def time_ms(fn, flush, reps=20):
    """Median device time of ``fn`` over ``reps`` calls on cold caches.

    Before each call the stream overwrites a buffer larger than the L2 cache
    (the serving path reads each weight once per step) and then spins the
    GPU for about a millisecond, so the host has queued the start event, the
    call and the end event before the GPU reaches them: the events time the
    device work alone, not the host's launch overhead."""
    fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


# ---------------------------------------------------------------------------
# Phase 2: the kernel against its plain version


def kernel_case(dqm, ref, dev, gen, cb, flush, K, N, M, bits, lead=None):
    block = 64
    pre = () if lead is None else (lead,)
    x = torch.randn(pre + (M, K), generator=gen, device=dev).to(torch.bfloat16)
    n_codes = cb.numel()
    codes = torch.randint(0, n_codes, pre + (K, N), generator=gen,
                          device=dev, dtype=torch.int32).to(torch.uint8)
    if bits == 4:
        from repro_torch.core.nibble import pack_nibbles
        codes = pack_nibbles(codes).contiguous()
    scales = (torch.rand(pre + (K, N // block), generator=gen, device=dev)
              * 0.05 + 0.01).to(torch.bfloat16)
    y = dqm.dequant_matmul_cuda(x, codes, scales, cb, block, bits)
    y_plain = ref.dequant_matmul_ref(x, codes, scales, cb, block, bits)
    torch.cuda.synchronize()
    scale = float(y_plain.float().abs().max())
    torch.testing.assert_close(y.float(), y_plain.float(), rtol=1.6e-2,
                               atol=1e-2 * scale)
    err = float((y.float() - y_plain.float()).abs().max())
    w = ref.dequant_weight(codes, scales, cb, block, bits).to(torch.bfloat16)
    E = lead or 1
    nbytes = E * (K * N * bits // 8 + K * (N // block) * 2 + M * K * 2
                  + M * N * 2)
    flops = 2 * E * M * K * N
    out = dict(
        K=K, N=N, M=M, bits=bits, lead=lead, bytes=nbytes, flops=flops,
        bound_ms=max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S)
        * 1e3,
        kernel_ms=time_ms(lambda: dqm.dequant_matmul_cuda(
            x, codes, scales, cb, block, bits), flush),
        plain_ms=time_ms(lambda: ref.dequant_matmul_ref(
            x, codes, scales, cb, block, bits), flush),
        library_ms=time_ms(lambda: torch.matmul(x, w), flush),
        max_abs_err=err, max_abs_y=scale)
    del w
    return out


def kernel_phase(dev):
    from repro_torch.core.registry import parse_format
    from repro_torch.kernels.dequant_matmul import dequant_matmul as dqm
    from repro_torch.kernels.dequant_matmul import ref
    gen = torch.Generator(device=dev).manual_seed(0)
    cb4 = parse_format(SPEC).element.torch_codepoints(dev)
    cb8 = parse_format("babsmax64:int8").element.torch_codepoints(dev)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = []
    for model, projs in PROJECTIONS.items():
        for (K, N), per_step, names in projs:
            for M in (1, 4, 32):
                r = kernel_case(dqm, ref, dev, gen, cb4, flush, K, N, M, 4)
                r.update(model=model, weights=names,
                         launches_per_step=per_step)
                emit(phase="kernel", **r)
                rows.append(r)
    r = kernel_case(dqm, ref, dev, gen, cb8, flush, 4096, 4096, 4, 8)
    emit(phase="kernel", model="deepseek-7b", weights="wq (8-bit codes)",
         **r)
    rows.append(r)
    r = kernel_case(dqm, ref, dev, gen, cb4, flush, 768, 2048, 4, 4, lead=4)
    emit(phase="kernel", model="paper-100m", weights="lead dim 4", **r)
    rows.append(r)
    return rows


# ---------------------------------------------------------------------------
# Phases 3 and 4: serving


def build_engine(arch, dev, seed=0, kv_len=256):
    from repro_torch import configs
    from repro_torch.core import build_plan
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine
    cfg = configs.get_config(arch, "full")
    t0 = time.monotonic()
    params = transformer.init(cfg, seed=seed, device=dev)
    plan = build_plan(params, SPEC)
    quantise_leaf_by_leaf(plan, params)
    eng = ServeEngine.from_quantised(cfg, params, plan, batch_slots=4,
                                     kv_len=kv_len, prefill_chunk=8,
                                     device=dev)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return eng, time.monotonic() - t0


def quantise_leaf_by_leaf(plan, tree, prefix=""):
    """``plan.quantise`` done in place, one leaf at a time, so each f32
    leaf is freed as soon as its codes exist (deepseek-7b's f32 tree alone
    is about 28 GB)."""
    for k in list(tree):
        path = f"{prefix}[{k!r}]"
        if isinstance(tree[k], dict):
            quantise_leaf_by_leaf(plan, tree[k], path)
        elif plan.formats.get(path) is not None:
            tree[k] = plan.formats[path].quantise(tree[k])


class StepRecorder:
    """Wraps a family's decode_step: records each step's positions, batch,
    logits (to the host) and wall time after a device synchronise."""

    def __init__(self, step, keep_logits):
        self.step = step
        self.keep_logits = keep_logits
        self.records = []

    def __call__(self, params, state, batch, cfg):
        rec = {"T": int(batch["tokens"].shape[1])}
        if self.keep_logits:
            rec.update(pos=state["pos"].cpu(),
                       batch={k: v.cpu() for k, v in batch.items()})
        t0 = time.monotonic()
        logits, state = self.step(params, state, batch, cfg)
        torch.cuda.synchronize()
        rec["s"] = time.monotonic() - t0
        if self.keep_logits:
            rec["logits"] = logits.float().cpu()
        self.records.append(rec)
        return logits, state


def serve(eng, dqm, prompts, keep_logits):
    """Warm up, then serve ``prompts`` with the launch count zeroed just
    before the run and read just after."""
    from repro_torch.serve.engine import Request
    eng.submit(Request(prompt=prompts[0], max_new_tokens=2, rid=-1))
    eng.run()
    torch.cuda.synchronize()
    rec = StepRecorder(eng.fam.decode_step, keep_logits)
    eng.fam = dataclasses.replace(eng.fam, decode_step=rec)
    for rid, p in enumerate(prompts):
        eng.submit(Request(prompt=p, max_new_tokens=16, rid=rid))
    steps0 = eng.steps_total
    dqm.launches = 0
    t0 = time.monotonic()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dqm.launches
    steps = eng.steps_total - steps0
    eng.fam = dataclasses.replace(eng.fam, decode_step=rec.step)
    decode = [r["s"] for r in rec.records if r["T"] == 1]
    prefill = [r["s"] for r in rec.records if r["T"] > 1]
    n_tok = sum(len(g.tokens) for g in done)
    stats = dict(steps=steps, launches=launches, tokens=n_tok,
                 wall_s=wall, tokens_per_s=n_tok / wall,
                 decode_ms_per_step=1e3 * float(np.median(decode)),
                 prefill_ms_per_step=1e3 * float(np.median(prefill)),
                 failed=sum(g.failed for g in done),
                 done=sum(g.done for g in done))
    return done, stats, rec.records


def profile_steps(eng):
    """torch.profiler over a short extra run (4 requests x 4 tokens): the
    device's busy time against the steps' wall time, the kernels that fill
    it and the host ops that cost the most."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(1)
    for rid in range(eng.B):
        eng.submit(Request(prompt=rng.integers(0, eng.cfg.vocab, 8).tolist(),
                           max_new_tokens=4, rid=100 + rid))
    steps0 = eng.steps_total
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        eng.run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.monotonic() - t0)
    steps = eng.steps_total - steps0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    events = prof.key_averages()
    kernels = sorted((e for e in events if dev_us(e) > 0), key=dev_us,
                     reverse=True)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    host = sorted(events, key=lambda e: e.self_cpu_time_total,
                  reverse=True)[:10]
    return dict(
        steps=steps, profiled_wall_ms_per_step=wall_ms / steps,
        device_busy_ms_per_step=busy_ms / steps,
        device_busy_share_profiled=busy_ms / wall_ms,
        top_kernels=[[e.key[:70], dev_us(e) / 1e3, e.count]
                     for e in kernels[:8]],
        top_host_ops=[[e.key[:70], e.self_cpu_time_total / 1e3, e.count]
                      for e in host])


def high_margin(row):
    top2 = np.sort(row)[-2:]
    return top2[1] - top2[0] > 5e-2 * np.abs(row).max()


def compare_with_cpu(eng, records):
    """Replay the card's recorded batches through the plain path on the
    CPU (the same packed weights) and hold the card's logits to it."""
    from repro_torch.serve.engine import alloc_decode_state, params_to
    cpu = torch.device("cpu")
    params = params_to(eng.params, cpu)
    state = alloc_decode_state(eng.fam, eng.cfg, eng.B, eng.kv_len,
                               slack=eng.prefill_chunk, device=cpu)
    worst, n_margin = 0.0, 0
    with torch.inference_mode():
        for rec in records:
            state["pos"] = rec["pos"].to(torch.int32)
            logits, state = eng.fam.decode_step(params, state, rec["batch"],
                                                eng.cfg)
            tv = rec["batch"]["t_valid"].numpy()
            for i in range(len(tv)):
                for t in range(int(tv[i])):
                    want = logits[i, t].numpy()
                    got = rec["logits"][i, t].numpy()
                    bound = 5e-2 * np.abs(want).max()
                    err = float(np.abs(got - want).max())
                    worst = max(worst, float(err / np.abs(want).max()))
                    check(err <= bound, f"card logits off the CPU plain path "
                          f"by {err} > {bound} (step pos {rec['pos'][i]})")
                    if high_margin(want):
                        n_margin += 1
                        check(int(np.argmax(got)) == int(np.argmax(want)),
                              "card and CPU argmax differ at a high margin")
    check(n_margin > 0, "no high-margin token to compare")
    return worst, n_margin


def layer0_check(eng, dev):
    """Layer 0's seven packed weights and the unembed on random bf16
    activations (M = 4): kernel against the plain version on the card."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.dequant_matmul.ref import dequant_matmul_ref
    gen = torch.Generator(device=dev).manual_seed(1)
    lp = eng.params["layers"]
    ws = {k: lp[k].layer(0) for k in ("wq", "wk", "wv", "wo", "w_gate",
                                      "w_up", "w_down")}
    ws["unembed"] = eng.params["unembed"]
    worst = 0.0
    for name, w in ws.items():
        x = torch.randn(4, w.k_dim, generator=gen, device=dev).to(
            torch.bfloat16)
        y = ops.dequant_matmul(x, w.codes, w.scales, w.codebook(), w.block,
                               w.bits)
        y_plain = dequant_matmul_ref(x, w.codes, w.scales, w.codebook(),
                                     w.block, w.bits)
        scale = float(y_plain.float().abs().max())
        torch.testing.assert_close(y.float(), y_plain.float(), rtol=1.6e-2,
                                   atol=1e-2 * scale, msg=name)
        worst = max(worst, float((y.float() - y_plain.float()).abs().max()))
    return worst


def serve_phase(arch, dev, dqm, compare_cpu):
    eng, setup_s = build_engine(arch, dev)
    wb = eng.weight_bytes()
    check({k: wb[k] for k in WEIGHT_BYTES[arch]} == WEIGHT_BYTES[arch],
          f"{arch} weight_bytes {wb} != {WEIGHT_BYTES[arch]}")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, eng.cfg.vocab, 8).tolist() for _ in range(4)]
    done, stats, records = serve(eng, dqm, prompts, keep_logits=compare_cpu)
    check(stats["launches"] == LAUNCHES_PER_STEP[arch] * stats["steps"],
          f"{arch}: {stats['launches']} launches over {stats['steps']} "
          f"steps, expected {LAUNCHES_PER_STEP[arch]} per step")
    check(stats["failed"] == 0 and stats["done"] == 4 and
          all(len(g.tokens) == 16 for g in done),
          f"{arch}: requests did not all finish: {stats}")
    out = dict(phase="serve", arch=arch, setup_s=setup_s,
               weight_bytes=wb, cache_bytes=eng.cache_bytes()["total"],
               peak_mem_bytes=torch.cuda.max_memory_allocated(dev), **stats)
    emit(phase="profile", arch=arch, **profile_steps(eng))
    if compare_cpu:
        worst, n = compare_with_cpu(eng, records)
        out.update(cpu_max_rel_logit_err=worst, cpu_margin_tokens=n)
    else:
        out["layer0_max_abs_err"] = layer0_check(eng, dev)
    out["tokens"] = {g.rid: g.tokens for g in done}
    emit(**out)
    del eng
    torch.cuda.empty_cache()
    return out


def device_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
        f"nvidia-smi failed: {r.stderr.strip()}"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels.dequant_matmul import build
    from repro_torch.kernels.dequant_matmul import dequant_matmul as dqm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(device_line(), flush=True)
    t0 = time.monotonic()
    lib = build.build(verbose=True)
    report = (lib.parent / "ptxas.txt").read_text()
    emit(phase="build", seconds=time.monotonic() - t0,
         max_registers=max(int(n) for n in re.findall(
             r"Used (\d+) registers", report)),
         max_spill_store_bytes=max(int(n) for n in re.findall(
             r"(\d+) bytes spill stores", report)),
         max_stack_frame_bytes=max(int(n) for n in re.findall(
             r"(\d+) bytes stack frame", report)),
         torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0))

    rows = kernel_phase(dev)
    paper = serve_phase("paper-100m", dev, dqm, compare_cpu=True)
    deepseek = serve_phase("deepseek-7b", dev, dqm, compare_cpu=False)

    step = [r for r in rows if r.get("model") == "deepseek-7b"
            and r["M"] == 4 and r["bits"] == 4 and r.get("launches_per_step")]
    total = {k: sum(r[k] * r["launches_per_step"] for r in step)
             for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}
    emit(kernels=[{
        "name": "dequant_matmul", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": paper["launches"] + deepseek["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": total["kernel_ms"], "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"], "bound_by": "bytes",
        "library_ms": total["library_ms"], "checked": True,
        "measured_over": "one deepseek-7b decode step at M=4 "
                         "(211 launches), per-shape times x launches"}])
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
