"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printed as JSON lines:

1. device: the card's name and power limit (nvidia-smi), then the build of
   every CUDA kernel from ``src/repro_torch`` sources (one nvcc per source,
   in parallel), with registers and spills per library and per instance of
   the ``dequant_matmul_t`` tensor-core kernel, and the count of
   tensor-core (HMMA) instructions in the ``dequant_matmul``,
   ``dequant_matmul_t`` and ``decode_attention`` libraries (``cuobjdump
   -sass``), which must not be 0, and registers, spills and shared memory of
   each ``decode_attention`` instance.
2. kernel: each kernel against its plain torch version on the card, with the
   kernel's, the plain version's and one library call's times beside the
   least time the card could take:
   ``dequant_matmul`` at every projection shape of paper-100m, deepseek-7b
   and gemma3-1b (M = 1, 4, 32 at 4 bits, one 8-bit shape, one lead-dim
   case), each called twice with bitwise-equal results, with its tile
   width, K splits, registers and blocks per SM; ``dequant_matmul_t`` at
   gemma3-1b's tied unembed (262144 x 1152, M = 1, 4, 32, and 8-bit), each
   called twice with bitwise-equal results, with its registers, spills
   and blocks per SM; ``block_quant`` at hd 256 and 64, rows 4, 32 and
   256, q8 and q4, the single-tensor call and the paired k + v call
   (``block_quant_kv``, the served cache write; packed, scattered, and
   from unaligned rows), bitwise; ``decode_attention_quant`` at gemma3-1b's
   shapes (ring S = 520 and linear S = 1032, T = 1 and 8, q8 and q4, a
   wrapped ring), each called twice with bitwise-equal results, with the
   geometry it ran. Besides the one-call-per-event-pair time of each case, a
   launch-bound reading (``launch_us``: 200 back-to-back calls between one
   event pair) times ``decode_attention_quant`` and, at gemma3-1b's KV
   write shapes, the old pair of single-tensor ``block_quant`` calls and
   the paired call in turns, beside an empty kernel launched through the
   same ctypes route (the launch floor) and the host's time per call.
3. serve paper-100m full: babsmax64:n4 packed, seeded weights, 4 slots x 4
   requests; launch counts, resident bytes, and card-vs-CPU logits/tokens.
4. serve deepseek-7b full: the same at kv_len 256, weights initialised,
   quantised and packed on the card; the card's logits of the prefill step
   and the first decode step held to the CPU plain path at full depth.
5. serve gemma3-1b full with a q8 KV cache (tied embeddings, 5:1 ring
   groups): 4 requests, then one 600-token prompt that wraps the local
   groups' 520-slot rings, held step by step to the same request served
   with full-length caches (no ring); launch counts of all four kernels,
   resident weight and KV bytes, card-vs-CPU logits. Then the same 4
   requests with a q4 cache, whose prefill step and first three decode
   steps are held to the CPU plain path on the same q4 cache: the logits,
   and the codes and scales of each step's new k and v.
6. allocation (the paper's measurement path) at gemma3-1b full, seeded
   random f32 weights, tokens from numpy: the diagonal Fisher by autograd
   on the card over 2 batches of B=2, T=1024 (remat full), the Eq. 5
   allocation at 4.0 bits (2 to 8) and its babsmax128 plan beside the flat
   babsmax128:t4 one, both plans' top-k KL (k=128) on 2 held-out batches;
   a packed babsmax64:n4 ``apply`` at M = B·T = 2048 (182 ``dequant_matmul``
   and 1 ``dequant_matmul_t`` launches, counted by the wrappers and by
   torch.profiler) held position by position to the dense ``apply`` over
   the dequantised checkpoint, its KL within 5% of that one's, and one
   T=512 sequence held to the CPU plain path; the card's per-tensor Fisher
   within 5% of the CPU's on one T=256 sequence with the same labels;
   ``launch.serve --kv-format auto`` under half the all-f32 cache bytes,
   serving 4 requests on the formats it chose; both matmul kernels timed
   at M = 2048 beside torch.matmul and the bound.
7. train (the §4 pipeline and the variable-length formats): paper-100m full
   through ``launch.train`` (20 CE steps, B=8 T=256, checkpoints every 10)
   and a second run resumed from step 10, held to the first under
   deterministic algorithms: bitwise with f32 Adam moments, and with 8-bit
   moments bitwise at the first resumed step and within 1e-2 after it;
   the checkpoint's bytes and save/restore seconds; ``launch.serve
   --ckpt`` serving it packed. Then gemma3-1b full: a teacher from 20 CE
   steps (B=2 T=1024), ``run_qat`` babsmax64:n4 for 10 steps (the full KL
   to the teacher on a held-out batch must fall from the direct cast), a
   Fisher-weighted Lloyd-Max plan at 4 bits (babsmax64, Fisher of one
   sequence, fitted on the host) with each tensor's R beside
   babsmax64:t4's; each of the two checkpoints packed, its ``apply`` held
   to the dense ``apply`` over it dequantised, and served with a q8 cache
   through all four kernels; measured bits/param of trms:t4:C and a 4-bit
   trms:grid:C plan on the card against the CPU (within 1e-4), each below
   its fixed-length counterpart; one layer's wq grid codes through the
   Huffman codec and back.
8. the kernels summary line, then ``{"ok": true, "device": ...}``.

Every count of kernel launches is set to 0 just before a serve run and read
just after it. Each profile phase also holds every ``decode_attention_quant``
call of its run to one device kernel. Any failed check raises and the
script exits non-zero without the last line. It exits non-zero at once
when no CUDA device is present.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12    # H100 SXM dense bf16 tensor-core peak
SPIN_CYCLES = 2_000_000      # about 1 ms at the H100's clock
SPEC = "babsmax64:n4"
CSRC = "src/repro_torch/kernels/csrc/"
REF = "src/repro/kernels/"
# kernel -> its wrapper module (which counts launches), source, TPU kernel
KERNELS = {
    "dequant_matmul": dict(
        module="repro_torch.kernels.dequant_matmul.dequant_matmul",
        source=CSRC + "dequant_matmul.cu",
        replaces=REF + "dequant_matmul/dequant_matmul.py:171"),
    "dequant_matmul_t": dict(
        module="repro_torch.kernels.dequant_matmul.dequant_matmul_t",
        source=CSRC + "dequant_matmul_t.cu",
        replaces=REF + "dequant_matmul/dequant_matmul.py:259"),
    "block_quant": dict(
        module="repro_torch.kernels.block_quant.block_quant",
        source=CSRC + "block_quant.cu",
        replaces=REF + "block_quant/block_quant.py:53"),
    "decode_attention_quant": dict(
        module="repro_torch.kernels.decode_attention.decode_attention",
        source=CSRC + "decode_attention.cu",
        replaces=REF + "decode_attention/decode_attention.py:125"),
}

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
    "gemma3-1b": [((1152, 1024), 26, "wq"), ((1152, 256), 52, "wk+wv"),
                  ((1024, 1152), 26, "wo"), ((1152, 6912), 52,
                                              "w_gate+w_up"),
                  ((6912, 1152), 26, "w_down")],
}
# launches per decode step of each kernel (the design's numbers): gemma3-1b
# runs 7 projections per layer, the tied unembed once, block_quant once per
# layer (k and v in one block_quant_kv launch) and decode_attention_quant
# once per layer (26 layers)
LAUNCHES_PER_STEP = {
    "paper-100m": {"dequant_matmul": 85},
    "deepseek-7b": {"dequant_matmul": 211},
    "gemma3-1b": {"dequant_matmul": 182, "dequant_matmul_t": 1,
                  "block_quant": 26, "decode_attention_quant": 26},
}
# the device kernels of decode_attention.cu (profile phase: one a call)
ATTN_DEVICE_KERNELS = ("attn_rows_kernel", "attn_mma_kernel")
LAUNCH_RUN = 200                  # calls per launch-bound reading
UNEMBED_T = (262144, 1152)        # gemma3-1b's tied table (V, D)
TF_M = 2048                       # teacher-forcing rows: B=2 x T=1024
KV_BYTES = {"q8": 32_381_440, "q4": 16_439_808}   # gemma3-1b, 4 x 1024
WEIGHT_BYTES = {
    "paper-100m": dict(total=66_924_096, codes=62_914_560, scales=3_932_160,
                       codebooks=576, dense=76_800),
    "deepseek-7b": dict(total=3_671_999_040, codes=3_455_057_920,
                        scales=215_941_120, codebooks=576, dense=999_424),
    "gemma3-1b": dict(total=531_416_064, codes=499_875_840,
                      scales=31_242_240, codebooks=512, dense=297_472),
}


def emit(**kw):
    print(json.dumps(kw), flush=True)


def flat_with_paths(tree):
    from repro_torch.core.plan import flat_with_paths as flat
    return flat(tree)


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


def launch_us(fn, flush, n=LAUNCH_RUN):
    """Device and host microseconds per call of a launch-bound ``fn`` over
    ``n`` back-to-back calls: one event pair around the run, the L2 cache
    flushed once before it, and the GPU held by a spin until the host has
    queued all ``n`` calls, so the events see the device's rate and not the
    host's. The host's time per call is its clock over the same loop (no
    synchronise). The spin is sized to three times the host's time for
    ``n`` calls (timed over a short run first); ``queued_ahead`` says it
    outlasted the host's loop (the start event had not run when the loop
    ended), else the spin doubles and the run repeats, up to three
    times."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        fn()
    host_ms = (time.perf_counter() - t0) / 20 * n * 1e3
    torch.cuda.synchronize()
    cycles = int(SPIN_CYCLES * max(1.0, 3 * host_ms))
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.zero_()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host_s = time.perf_counter() - t0
        ahead = not start.query()
        end.record()
        torch.cuda.synchronize()
        if ahead:
            break
        cycles *= 2
    return dict(device_us=start.elapsed_time(end) * 1e3 / n,
                host_us=host_s * 1e6 / n, calls=n, queued_ahead=ahead)


def bound_ms(nbytes, flops):
    """Least time of the card for this work: bytes over the HBM rate or
    operations over the bf16 tensor-core peak, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3


def bound_by(nbytes, flops):
    return "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS_PER_S \
        else "operations"


def wrappers():
    """Each kernel's wrapper module, the holder of its launch count."""
    return {name: importlib.import_module(k["module"])
            for name, k in KERNELS.items()}


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version


def matmul_case(mods, dev, gen, cb, flush, K, N, M, bits, lead=None):
    from repro_torch.kernels.dequant_matmul import ref
    block = 64
    pre = () if lead is None else (lead,)
    x = torch.randn(pre + (M, K), generator=gen, device=dev).to(torch.bfloat16)
    codes = torch.randint(0, cb.numel(), pre + (K, N), generator=gen,
                          device=dev, dtype=torch.int32).to(torch.uint8)
    if bits == 4:
        from repro_torch.core.nibble import pack_nibbles
        codes = pack_nibbles(codes).contiguous()
    scales = (torch.rand(pre + (K, N // block), generator=gen, device=dev)
              * 0.05 + 0.01).to(torch.bfloat16)
    mod = mods["dequant_matmul"]
    kern = mod.dequant_matmul_cuda
    y = kern(x, codes, scales, cb, block, bits)
    y_again = kern(x, codes, scales, cb, block, bits)
    y_plain = ref.dequant_matmul_ref(x, codes, scales, cb, block, bits)
    torch.cuda.synchronize()
    check(torch.equal(y, y_again), f"dequant_matmul {K}x{N} M={M}: two calls "
          "on the same inputs differ")
    scale = float(y_plain.float().abs().max())
    torch.testing.assert_close(y.float(), y_plain.float(), rtol=1.6e-2,
                               atol=1e-2 * scale)
    err = float((y.float() - y_plain.float()).abs().max())
    w = ref.dequant_weight(codes, scales, cb, block, bits).to(torch.bfloat16)
    E = lead or 1
    _, geo, _, _ = mod._geometry(True, E, M, K, N, bits, 8, dev.index or 0)
    nbytes = E * (K * N * bits // 8 + K * (N // block) * 2 + M * K * 2
                  + M * N * 2)
    flops = 2 * E * M * K * N
    out = dict(
        K=K, N=N, M=M, bits=bits, lead=lead, bytes=nbytes, flops=flops,
        bound_ms=bound_ms(nbytes, flops), bitwise_repeat=True,
        vec=geo.vec, splits=geo.splits,
        blocks=geo.tiles * geo.splits * E, **mod.mma_info(bits, M, geo.vec),
        kernel_ms=time_ms(lambda: kern(x, codes, scales, cb, block, bits),
                          flush),
        plain_ms=time_ms(lambda: ref.dequant_matmul_ref(
            x, codes, scales, cb, block, bits), flush),
        library_ms=time_ms(lambda: torch.matmul(x, w), flush),
        max_abs_err=err, max_abs_y=scale)
    del w
    return out


def matmul_t_case(mods, dev, gen, cb, flush, V, D, M, bits, tc_ptxas):
    """The tied unembed: x (M, D) @ dequant(table (V, D)).T, with the
    library call ``torch.matmul`` against the pre-dequantised bf16 table,
    and the registers and spills of the tensor-core instance that ran
    (``tc_ptxas``, from ``ptxas_tc_instances``)."""
    from repro_torch.core.nibble import pack_nibbles
    from repro_torch.kernels.dequant_matmul import ref
    block = 64
    x = torch.randn(M, D, generator=gen, device=dev).to(torch.bfloat16)
    codes = torch.randint(0, cb.numel(), (V, D), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    if bits == 4:
        codes = pack_nibbles(codes).contiguous()   # interleaved along V
    scales = (torch.rand(V, D // block, generator=gen, device=dev) * 0.05
              + 0.01).to(torch.bfloat16)
    mod = mods["dequant_matmul_t"]
    kern = mod.dequant_matmul_t_cuda
    y = kern(x, codes, scales, cb, block, bits)
    y_again = kern(x, codes, scales, cb, block, bits)
    y_plain = ref.dequant_matmul_t_ref(x, codes, scales, cb, block, bits)
    torch.cuda.synchronize()
    check(torch.equal(y, y_again), f"dequant_matmul_t M={M} bits={bits}: "
          "two calls on the same inputs differ")
    scale = float(y_plain.float().abs().max())
    torch.testing.assert_close(y.float(), y_plain.float(), rtol=1.6e-2,
                               atol=1e-2 * scale)
    err = float((y.float() - y_plain.float()).abs().max())
    table = ref.dequant_weight(codes, scales, cb, block, bits).to(
        torch.bfloat16)
    nbytes = V * D * bits // 8 + V * (D // block) * 2 + M * D * 2 + M * V * 2
    flops = 2 * M * V * D
    out = dict(
        V=V, D=D, M=M, bits=bits, bytes=nbytes, flops=flops,
        bound_ms=bound_ms(nbytes, flops), bitwise_repeat=True,
        **tc_ptxas[f"bits{bits}_nt{mod.tc_n_tiles(M, D)}"],
        blocks_per_sm=mod.tc_blocks_per_sm(bits, M, D, block),
        kernel_ms=time_ms(lambda: kern(x, codes, scales, cb, block, bits),
                          flush),
        plain_ms=time_ms(lambda: ref.dequant_matmul_t_ref(
            x, codes, scales, cb, block, bits), flush, reps=5),
        library_ms=time_ms(lambda: torch.matmul(x, table.t()), flush),
        max_abs_err=err, max_abs_y=scale)
    del table
    return out


def block_quant_case(mods, dev, gen, flush, rows, hd, fmt):
    """Quantise ``rows`` bf16 rows of ``hd`` (the serving input: fresh k
    and v rows, block = hd): the single-tensor call, and the paired call
    (``block_quant_kv``, k and v in one launch, packed and scattered into
    two caches: the served write, which is the form timed as
    ``kernel_ms``), also from rows that start mid-tensor (unaligned: the
    scalar instance). Codes and scales must equal the plain version's bit
    for bit. ``single_ms`` times one single-tensor call of the same write
    (the parent's path made two a layer). No single PyTorch call computes
    this."""
    from repro_torch.kernels.block_quant.ref import (block_quant_ref,
                                                     pack_pairs)
    from repro_torch.serve.cache import kv_codebook
    mod = mods["block_quant"]
    cb = kv_codebook(fmt, dev)
    pack = fmt == "q4"
    k, v = ((torch.randn(rows, hd, generator=gen, device=dev) * 3).to(
        torch.bfloat16) for _ in range(2))
    k[1] = 0
    want = [block_quant_ref(x, cb, hd) for x in (k, v)]
    codes, scales = mod.block_quant_cuda(k, cb, hd)
    torch.cuda.synchronize()
    check(torch.equal(codes, want[0][0]) and torch.equal(scales, want[0][1]),
          f"block_quant {rows}x{hd} {fmt}: codes or scales differ from the "
          "plain version")
    slots = 4 * rows                  # caches of 4x the rows, scattered
    width = hd // 2 if pack else hd

    def caches():
        return [(torch.zeros(slots, width, dtype=torch.uint8, device=dev),
                 torch.zeros(slots, 1, device=dev)) for _ in range(2)]
    dest = torch.randperm(slots, generator=gen, device=dev)[:rows]

    def unaligned(x):                 # the same rows, 6 bytes past 16
        buf = torch.empty(x.numel() + 16, dtype=x.dtype, device=dev)
        off = (-buf.data_ptr() % 16) // 2 + 3
        return buf[off:off + x.numel()].view(x.shape).copy_(x)
    for kk, vv in ((k, v), (unaligned(k), unaligned(v))):
        bufs = caches()
        n0 = mod.launches
        mod.block_quant_kv_cuda(kk, vv, cb, hd, pack=pack, out_k=bufs[0],
                                out_v=bufs[1], rows=dest)
        torch.cuda.synchronize()
        check(mod.launches == n0 + 1, "block_quant_kv: not one launch")
        for (c, s_), (wc, ws) in zip(bufs, want):
            check(torch.equal(c[dest], pack_pairs(wc) if pack else wc) and
                  torch.equal(s_[dest], ws),
                  f"block_quant_kv {rows}x{hd} {fmt} (x at "
                  f"{kk.data_ptr() % 16} mod 16): the paired write differs "
                  "from the plain version")
    bufs = caches()

    def paired():
        mod.block_quant_kv_cuda(k, v, cb, hd, pack=pack, out_k=bufs[0],
                                out_v=bufs[1], rows=dest)

    def single_pair():
        for x, b in zip((k, v), bufs):
            mod.block_quant_cuda(x, cb, hd, pack=pack, out=b, rows=dest)

    def plain():
        for x, b in zip((k, v), bufs):
            c, s_ = block_quant_ref(x, cb, hd)
            b[0][dest] = pack_pairs(c) if pack else c
            b[1][dest] = s_
    nbytes = 2 * (rows * hd * 2 + rows * width + rows * 4) + rows * 8 \
        + cb.numel() * 4
    out = dict(
        rows=rows, hd=hd, fmt=fmt, tensors=2, bytes=nbytes, flops=0,
        bound_ms=bound_ms(nbytes, 0),
        kernel_ms=time_ms(paired, flush),
        single_ms=time_ms(lambda: mod.block_quant_cuda(
            k, cb, hd, pack=pack, out=bufs[0], rows=dest), flush),
        plain_ms=time_ms(plain, flush), library_ms=None, max_abs_err=0.0,
        bitwise=True)
    if hd == 256 and rows in (4, 32):     # gemma3-1b's decode and prefill
        # in turns: the old pair, the paired call, the floor, and back
        order = [("single_pair", single_pair), ("paired", paired),
                 ("floor", mod.launch_floor)]
        readings = {name: [] for name, _ in order}
        for name, fn in order + order[::-1]:
            readings[name].append(launch_us(fn, flush))
        out["launch_us"] = {
            name: dict(device_us=float(np.mean([r["device_us"] for r in rs])),
                       host_us=float(np.mean([r["host_us"] for r in rs])),
                       runs=rs) for name, rs in readings.items()}
    return out


ATTN_CASES = [
    # (T, S, ring, window, first query position of each of the 4 rows)
    (1, 520, True, 512, [515, 519, 300, 12]),
    (8, 520, True, 512, [400, 505, 200, 0]),
    (8, 520, True, 512, [600, 590, 1000, 8]),      # wrapped rings
    (1, 1032, False, 0, [1000, 17, 513, 1023]),
    (8, 1032, False, 0, [1000, 8, 500, 0]),
]


def attention_inputs(dev, gen, T, S, starts, fmt):
    """gemma3-1b's attention read (B=4, H=4, K=1, hd=256): bf16 q, K/V
    codes written by the port's own quantise_kv, positions from ``starts``
    (the first query position of each row). Returns the kernel's
    positional arguments and the code bits."""
    from repro_torch.models.layers import quantise_kv
    from repro_torch.serve.cache import kv_bits, kv_codebook
    B, H, K, hd = 4, 4, 1, 256
    bits = kv_bits(fmt)
    cb = kv_codebook(fmt, dev)
    kc, ks = quantise_kv(torch.randn(B, S, K, hd, generator=gen, device=dev),
                         cb, bits)
    vc, vs = quantise_kv(torch.randn(B, S, K, hd, generator=gen, device=dev),
                         cb, bits)
    q = torch.randn(B, T, H, hd, generator=gen, device=dev).to(torch.bfloat16)
    qp = (torch.tensor(starts, dtype=torch.int32, device=dev)[:, None]
          + torch.arange(T, dtype=torch.int32, device=dev))
    return (q, kc, ks, vc, vs, cb, qp), bits


def attn_instance(geo, bits, hd):
    """The key of the decode_attention.cu instance a geometry runs (bf16
    q), as ``ptxas_attention_instances`` names them."""
    if geo.path == 1:
        return f"mma_bits{bits}_hd{hd}"
    return f"rows_bits{bits}_bf16_rt{geo.row_tile}_e{8 if hd > 128 else 4}"


def attention_case(mods, dev, gen, flush, T, S, ring, window, starts, fmt,
                   attn_ptxas):
    """gemma3-1b's attention read (``attention_inputs``), called twice with
    bitwise-equal results, with the geometry it ran and its instance's
    ptxas figures. Library: scaled_dot_product_attention on K/V dequantised
    to bf16 beforehand, under the same boolean mask."""
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_quant_ref, dequant_kv_ref)
    from repro_torch.models.layers import attention_mask
    args, bits = attention_inputs(dev, gen, T, S, starts, fmt)
    q, kc, ks, vc, vs, cb, qp = args
    B, _, H, hd = q.shape
    K = kc.shape[2]
    mod = mods["decode_attention_quant"]
    kern = mod.decode_attention_quant_cuda
    out = kern(*args, window, ring=ring, bits=bits)
    again = kern(*args, window, ring=ring, bits=bits)
    want = decode_attention_quant_ref(*args, window=window, ring=ring,
                                      bits=bits)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), "decode_attention: non-finite")
    check(torch.equal(out, again), f"decode_attention T={T} S={S} {fmt}: "
          "two calls on the same inputs differ")
    geo = mod._geometry(B, T, H, K, S, hd, bits, True,
                        mod.tensor_cores_fit(q, kc, vc), dev.index or 0)
    scale = float(want.float().abs().max())
    torch.testing.assert_close(out.float(), want.float(), rtol=2e-2,
                               atol=2e-2 * scale)
    err = float((out.float() - want.float()).abs().max())
    kd = dequant_kv_ref(kc, ks, cb, bits, torch.bfloat16).permute(
        0, 2, 1, 3).repeat_interleave(H // K, dim=1).contiguous()
    vd = dequant_kv_ref(vc, vs, cb, bits, torch.bfloat16).permute(
        0, 2, 1, 3).repeat_interleave(H // K, dim=1).contiguous()
    qt = q.transpose(1, 2).contiguous()
    mask = attention_mask(qp, S, window=window, ring=ring).reshape(B, T, S)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    hdc = hd // 2 if bits == 4 else hd
    # the work this run's positions need: K/V rows of the slots some query
    # of the row sees (causal, window, ring), scores over visible pairs only
    slots = int(mask.any(dim=1).sum())
    pairs = int(mask.sum())
    nbytes = (2 * B * T * H * hd * 2 + 2 * slots * K * (hdc + 4) + B * T * 4)
    flops = 4 * H * hd * pairs
    return dict(
        T=T, S=S, ring=ring, window=window, fmt=fmt, starts=starts,
        visible_slots=slots, bytes=nbytes, flops=flops,
        bound_ms=bound_ms(nbytes, flops), bound_by=bound_by(nbytes, flops),
        geometry=geo._asdict(), bitwise_repeat=True,
        instance=attn_instance(geo, bits, hd),
        **attn_ptxas[attn_instance(geo, bits, hd)],
        **mod.instance_info(geo, bits, True, hd),
        kernel_ms=time_ms(lambda: kern(*args, window, ring=ring, bits=bits),
                          flush),
        launch_us=launch_us(lambda: kern(*args, window, ring=ring, bits=bits),
                            flush),
        plain_ms=time_ms(lambda: decode_attention_quant_ref(
            *args, window=window, ring=ring, bits=bits), flush),
        library_ms=time_ms(lambda: sdpa(qt, kd, vd,
                                        attn_mask=mask[:, None]), flush),
        max_abs_err=err, max_abs_y=scale)


def kernel_phase(mods, dev, tc_ptxas, attn_ptxas):
    from repro_torch.core.registry import parse_format
    gen = torch.Generator(device=dev).manual_seed(0)
    cb4 = parse_format(SPEC).element.torch_codepoints(dev)
    cb8 = parse_format("babsmax64:int8").element.torch_codepoints(dev)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = {name: [] for name in KERNELS}

    def record(name, r, **kw):
        r.update(kernel=name, **kw)
        emit(phase="kernel", **r)
        rows[name].append(r)

    for model, projs in PROJECTIONS.items():
        for (K, N), per_step, names in projs:
            for M in (1, 4, 32):
                record("dequant_matmul", matmul_case(
                    mods, dev, gen, cb4, flush, K, N, M, 4), model=model,
                    weights=names, launches_per_step=per_step)
    record("dequant_matmul", matmul_case(mods, dev, gen, cb8, flush, 4096,
                                         4096, 4, 8),
           model="deepseek-7b", weights="wq (8-bit codes)")
    record("dequant_matmul", matmul_case(mods, dev, gen, cb4, flush, 768,
                                         2048, 4, 4, lead=4),
           model="paper-100m", weights="lead dim 4")
    V, D = UNEMBED_T
    for M, bits in ((1, 4), (4, 4), (32, 4), (4, 8)):
        record("dequant_matmul_t", matmul_t_case(
            mods, dev, gen, cb4 if bits == 4 else cb8, flush, V, D, M, bits,
            tc_ptxas),
            model="gemma3-1b", weights="tied unembed")
    for fmt in ("q8", "q4"):
        for hd in (256, 64):
            for n in (4, 32, 256):
                record("block_quant", block_quant_case(
                    mods, dev, gen, flush, n, hd, fmt))
        for T, S, ring, window, starts in ATTN_CASES:
            record("decode_attention_quant", attention_case(
                mods, dev, gen, flush, T, S, ring, window, starts, fmt,
                attn_ptxas))
    del flush
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phases 3 to 5: serving


def build_engine(arch, dev, seed=0, kv_len=256, kv_format=""):
    from repro_torch import configs
    from repro_torch.core import build_plan
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine
    cfg = configs.get_config(arch, "full").replace(kv_format=kv_format)
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
    logits (to the host) and wall time after a device synchronise; with
    ``cache_decodes`` = n, also the cache stacks as the step left them (to
    the host), for every step until n decode steps have been recorded."""

    def __init__(self, step, keep_logits, cache_decodes=0):
        self.step = step
        self.keep_logits = keep_logits
        self.cache_decodes = cache_decodes
        self.decodes = 0
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
        if self.decodes < self.cache_decodes:
            rec["cache"] = {k: v.cpu() for k, v in state.items()
                            if k != "pos"}
        self.decodes += rec["T"] == 1
        self.records.append(rec)
        return logits, state


def serve(eng, mods, requests, keep_logits, warm=True, cache_decodes=0):
    """Serve ``requests`` ((prompt, max_new) pairs) after an optional warm-up,
    with every kernel's launch count set to 0 just before the run and read
    just after it (``StepRecorder`` records the steps)."""
    from repro_torch.serve.engine import Request
    if warm:
        eng.submit(Request(prompt=requests[0][0], max_new_tokens=2, rid=-1))
        eng.run()
        torch.cuda.synchronize()
    rec = StepRecorder(eng.fam.decode_step, keep_logits, cache_decodes)
    eng.fam = dataclasses.replace(eng.fam, decode_step=rec)
    for rid, (p, n) in enumerate(requests):
        eng.submit(Request(prompt=p, max_new_tokens=n, rid=rid))
    steps0 = eng.steps_total
    for m in mods.values():
        m.launches = 0
    t0 = time.monotonic()
    done = eng.run(max_steps=4096)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {name: m.launches for name, m in mods.items()}
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


def check_run(arch, done, stats, requests):
    """Every request finished with all its tokens, and each kernel ran its
    designed number of launches per step (and the others none)."""
    check(stats["failed"] == 0 and stats["done"] == len(requests) and
          sorted(len(g.tokens) for g in done) ==
          sorted(n for _, n in requests),
          f"{arch}: requests did not all finish: {stats}")
    per_step = LAUNCHES_PER_STEP[arch]
    for name, n in stats["launches"].items():
        want = per_step.get(name, 0) * stats["steps"]
        check(n == want, f"{arch}: {name} launched {n} times over "
              f"{stats['steps']} steps, expected {per_step.get(name, 0)} "
              "per step")


def profile_steps(eng, mods):
    """torch.profiler over a short extra run (4 requests x 4 tokens): the
    device's busy time against the steps' wall time, the kernels that fill
    it and the host ops that cost the most. Every ``decode_attention_quant``
    call of the run must have made exactly one device kernel of its
    library (``ATTN_DEVICE_KERNELS``)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.engine import Request
    attn = mods["decode_attention_quant"]
    calls0 = attn.launches
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
    launch_calls = sum(e.count for e in events
                       if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                    "cudaLaunchKernelExC"))
    attn_calls = attn.launches - calls0
    attn_kernels = sum(e.count for e in kernels
                       if any(n in e.key for n in ATTN_DEVICE_KERNELS))
    check(attn_kernels == attn_calls, f"decode_attention_quant: "
          f"{attn_calls} calls made {attn_kernels} device kernels")
    return dict(
        steps=steps, profiled_wall_ms_per_step=wall_ms / steps,
        attention_calls=attn_calls, attention_device_kernels=attn_kernels,
        device_busy_ms_per_step=busy_ms / steps,
        device_busy_share_profiled=busy_ms / wall_ms,
        kernel_launches_per_step=launch_calls / steps,
        top_kernels=[[e.key[:70], dev_us(e) / 1e3, e.count]
                     for e in kernels[:10]],
        top_host_ops=[[e.key[:70], e.self_cpu_time_total / 1e3, e.count]
                      for e in host])


def hold_logits(got, want, what):
    """The logits rule, at every position of (..., V) logits (numpy or
    torch, compared in torch on ``got``'s device): max error within
    5e-2·max|want| of the position, and the same argmax where want's top-2
    margin is above that. Returns (worst error ÷ max|want|, the number of
    positions whose margin was high)."""
    got = torch.as_tensor(got).float().reshape(-1, got.shape[-1])
    want = torch.as_tensor(want).float().reshape(-1, want.shape[-1]).to(
        got.device)
    scale = want.abs().amax(-1)
    err = (got - want).abs().amax(-1)
    rel = float((err / scale).max())
    check(bool((err <= 5e-2 * scale).all()), f"{what}: logits of "
          f"{int((err > 5e-2 * scale).sum())} position(s) off by more than "
          f"5e-2 of max|logit| (worst {rel})")
    top2 = torch.topk(want, 2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1] > 5e-2 * scale
    check(bool(((got.argmax(-1) == want.argmax(-1)) | ~margin).all()),
          f"{what}: argmax differs at a high margin")
    return rel, int(margin.sum())


def kv_witness(stats):
    """A ``layers.write_kv_pair`` for the card-cache replay: writes nothing,
    and holds the codes and scales the plain path gives this step's new k
    and v (the CPU's own wk/wv, k-norm, RoPE and quantisation) to those the
    card wrote at the same cache rows. Adds to ``stats``: codes compared,
    codes that differ, the largest difference in codepoints, and the
    largest relative difference of a scale."""
    from repro_torch.kernels.block_quant.ref import block_quant_ref
    from repro_torch.models.layers import QuantisedKV, codebook_bits, kv_rows

    def write_pair(k_cache, v_cache, k_new, v_new, rows, slots,
                   codebook=None, dest=None):
        for cache, new in ((k_cache, k_new), (v_cache, v_new)):
            hold(cache, new, rows, slots, codebook, dest)
        return k_cache, v_cache

    def hold(cache, new, rows, slots, codebook, dest):
        check(isinstance(cache, QuantisedKV), "the card-cache replay "
              "expects quantised caches only")
        B, T, K, hd = new.shape
        if dest is None:
            dest = kv_rows(rows, slots, cache.codes.shape[1], K)
        codes, scales = block_quant_ref(new.reshape(B * T * K, hd),
                                        codebook, hd)
        card = cache.codes.reshape(-1, cache.codes.shape[-1])[dest]
        if codebook_bits(codebook) == 4:
            card = torch.stack([card & 15, card >> 4], -1).reshape(
                codes.shape)
        step = (codes.int() - card.int()).abs()
        card_s = cache.scales.reshape(-1, 1)[dest]
        rel = (scales - card_s).abs() / torch.where(
            card_s == 0, torch.ones_like(card_s), card_s)
        stats["codes"] += step.numel()
        stats["differ"] += int((step > 0).sum())
        stats["max_codepoints"] = max(stats["max_codepoints"],
                                      int(step.max()))
        stats["max_scale_rel"] = max(stats["max_scale_rel"],
                                     float(rel.max()))
    return write_pair


def hold_kv_witness(stats):
    """The rule for ``kv_witness``'s counts: at most 10% of the codes
    differ, each by one codepoint, and no scale by more than 5e-2 of
    itself. bf16-level differences in k and v only move values that lie
    near a midpoint to the next code, and a scale by an ulp or two; a fault
    before the cache write (a wrong projection, norm or rotation) moves
    codes by many codepoints."""
    check(stats["codes"] > 0, "the K/V witness compared no code")
    share = stats["differ"] / stats["codes"]
    check(share <= 0.10 and stats["max_codepoints"] <= 1 and
          stats["max_scale_rel"] <= 5e-2,
          f"the CPU's own k/v codes disagree with the card's: {stats}")
    return dict(stats, differ_share=share)


def replay_on_cpu(eng, records, card_cache=False, kv_stats=None):
    """Replay the card's recorded batches through the plain path on the CPU
    (the same packed weights); yield (card logits, CPU logits, what) for
    every valid position.

    By default the CPU keeps its own cache, written by its own steps.
    ``card_cache=True`` runs each step instead on the cache the card left
    after that step (``StepRecorder``'s ``cache``), with a reset slot's
    position set to 0 as the step's prologue would, and the CPU's cache
    writes replaced by ``kv_witness`` (its counts go to ``kv_stats``): both
    sides then read the same quantised cache, so the logits compare holds
    the computation, not the rounding of near-midpoint values to a
    different code, and the witness holds the CPU's own new k and v to the
    codes the card wrote."""
    from repro_torch.models import layers
    from repro_torch.serve.engine import alloc_decode_state, params_to
    cpu = torch.device("cpu")
    params = params_to(eng.params, cpu)
    state = alloc_decode_state(eng.fam, eng.cfg, eng.B, eng.kv_len,
                               slack=eng.prefill_chunk, device=cpu)
    write_kv_pair = layers.write_kv_pair
    if card_cache:
        layers.write_kv_pair = kv_witness(kv_stats)
    try:
        with torch.inference_mode():
            for rec in records:
                batch, pos = rec["batch"], rec["pos"].to(torch.int32)
                if card_cache:
                    batch = {k: v for k, v in batch.items() if k != "reset"}
                    if "reset" in rec["batch"]:
                        pos = torch.where(rec["batch"]["reset"].bool(),
                                          torch.zeros_like(pos), pos)
                    state = dict(rec["cache"])
                state["pos"] = pos
                logits, state = eng.fam.decode_step(params, state, batch,
                                                    eng.cfg)
                tv = rec["batch"]["t_valid"].numpy()
                for i in range(len(tv)):
                    for t in range(int(tv[i])):
                        yield (rec["logits"][i, t].numpy(),
                               logits[i, t].numpy(),
                               f"card vs CPU plain path, step pos "
                               f"{int(rec['pos'][i])}")
    finally:
        layers.write_kv_pair = write_kv_pair


def compare_with_cpu(eng, records, card_cache=False, kv_stats=None):
    """Hold the card's logits to the plain path's replay (``replay_on_cpu``)
    under ``hold_logits``."""
    worst, n_margin = 0.0, 0
    for got, want, what in replay_on_cpu(eng, records, card_cache,
                                         kv_stats):
        rel, margin = hold_logits(got, want, what)
        worst = max(worst, rel)
        n_margin += margin
    check(n_margin > 0, "no high-margin token to compare")
    return worst, n_margin


def short_requests(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, 8).tolist(), 16) for _ in range(4)]


def serve_phase(arch, dev, mods, compare_steps=None):
    """Serve ``arch`` full and hold the card's logits to the CPU plain path
    replaying the same steps at full depth: every step, or the first
    ``compare_steps`` (the prefill step and the decode steps after it)."""
    eng, setup_s = build_engine(arch, dev)
    wb = eng.weight_bytes()
    check({k: wb[k] for k in WEIGHT_BYTES[arch]} == WEIGHT_BYTES[arch],
          f"{arch} weight_bytes {wb} != {WEIGHT_BYTES[arch]}")
    reqs = short_requests(eng.cfg.vocab)
    done, stats, records = serve(eng, mods, reqs, keep_logits=True)
    check_run(arch, done, stats, reqs)
    out = dict(phase="serve", arch=arch, setup_s=setup_s,
               weight_bytes=wb, cache_bytes=eng.cache_bytes()["total"],
               peak_mem_bytes=torch.cuda.max_memory_allocated(dev), **stats)
    emit(phase="profile", arch=arch, **profile_steps(eng, mods))
    if compare_steps is not None:
        records = records[:compare_steps]
        check(records[0]["T"] > 1 and records[-1]["T"] == 1,
              f"{arch}: the compare needs the prefill and a decode step")
    t0 = time.monotonic()
    worst, n = compare_with_cpu(eng, records)
    out.update(cpu_max_rel_logit_err=worst, cpu_margin_tokens=n,
               cpu_compared_steps=len(records),
               cpu_compared_layers=eng.cfg.n_layers,
               cpu_compare_s=time.monotonic() - t0)
    del records
    out["tokens"] = {g.rid: g.tokens for g in done}
    emit(**out)
    del eng
    torch.cuda.empty_cache()
    return out


def active_row(rec):
    """(tokens, t_valid, pos, logits) of the one row a single-request step
    fed."""
    rows = np.flatnonzero(rec["batch"]["t_valid"].numpy())
    check(len(rows) == 1, f"expected one active row, got {rows}")
    i = int(rows[0])
    tv = int(rec["batch"]["t_valid"][i])
    return (rec["batch"]["tokens"][i, :tv], tv, int(rec["pos"][i]),
            rec["logits"][i, :tv].numpy())


def compare_ring_with_full(ring_records, full_records, ring_slots):
    """Hold the ring-cache run of one long request to the same request
    served with every group at the full length (``windowed_cache=False``:
    linear caches under the window mask, no wrapped writes), step by step
    under ``hold_logits``, for as long as both steps were fed
    the same tokens (a low-margin greedy token may differ). Every prefill
    step and some positions past the ring's length must be compared."""
    check(len(ring_records) == len(full_records),
          f"ring run took {len(ring_records)} steps, full-length run "
          f"{len(full_records)}")
    worst, n_margin, wrapped, steps = 0.0, 0, 0, 0
    for a, b in zip(ring_records, full_records):
        tok_a, tv, pos, got = active_row(a)
        tok_b, tv_b, pos_b, want = active_row(b)
        if (tv, pos) != (tv_b, pos_b) or not torch.equal(tok_a, tok_b):
            break
        for t in range(tv):
            rel, margin = hold_logits(got[t], want[t], f"ring vs full-length "
                                      f"caches, position {pos + t}")
            worst = max(worst, rel)
            n_margin += margin
            wrapped += pos + t >= ring_slots
        steps += 1
    n_prefill = sum(r["T"] > 1 for r in ring_records)
    check(steps >= n_prefill, f"only {steps} of {n_prefill} prefill steps "
          "were fed the same tokens")
    check(wrapped > 0 and n_margin > 0,
          f"no position past the ring ({wrapped}) or no high-margin token "
          f"({n_margin}) compared")
    return dict(full_max_rel_logit_err=worst, full_margin_tokens=n_margin,
                full_compared_steps=steps, full_wrapped_positions=wrapped)


def gemma3_phase(dev, mods):
    """gemma3-1b full, kv_len 1024: q8 (4 requests compared with the CPU
    plain path, profiled, then a 600-token prompt that wraps the 520-slot
    rings, held to the same request on full-length caches), then the same 4
    requests with a q4 cache on the same packed weights (prefill and the
    first three decode steps compared with the CPU plain path)."""
    from repro_torch.serve.engine import ServeEngine
    arch = "gemma3-1b"
    eng, setup_s = build_engine(arch, dev, kv_len=1024, kv_format="q8")
    wb = eng.weight_bytes()
    check({k: wb[k] for k in WEIGHT_BYTES[arch]} == WEIGHT_BYTES[arch],
          f"{arch} weight_bytes {wb} != {WEIGHT_BYTES[arch]}")
    runs = []
    reqs = short_requests(eng.cfg.vocab)
    long_req = [(np.random.default_rng(2).integers(
        0, eng.cfg.vocab, 600).tolist(), 8)]
    for fmt in ("q8", "q4"):
        setup = {"setup_s": setup_s}
        if fmt == "q4":
            t0 = time.monotonic()
            eng = ServeEngine(eng.cfg.replace(kv_format="q4"), eng.params,
                              batch_slots=4, kv_len=1024, prefill_chunk=8,
                              device=dev)
            setup = {"engine_s": time.monotonic() - t0}
        cb = eng.cache_bytes()
        check(cb["kv"] == KV_BYTES[fmt] and
              [g["length"] for g in cb["cache_groups"]] == [520, 1032],
              f"{arch} {fmt}: cache_bytes {cb['kv']} (groups "
              f"{cb['cache_groups']}) != {KV_BYTES[fmt]}")
        done, stats, records = serve(eng, mods, reqs, keep_logits=True,
                                     cache_decodes=3 if fmt == "q4" else 0)
        check_run(arch, done, stats, reqs)
        out = dict(phase="serve", arch=arch, kv_format=fmt, **setup,
                   weight_bytes=wb, kv_bytes=cb["kv"],
                   kv_code_bytes=cb["code_bytes"],
                   kv_scale_bytes=cb["scale_bytes"],
                   peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
                   **stats)
        if fmt == "q8":
            emit(phase="profile", arch=arch, kv_format=fmt,
                 **profile_steps(eng, mods))
            long_done, long_stats, ring_recs = serve(
                eng, mods, long_req, keep_logits=True, warm=False)
            check_run(arch, long_done, long_stats, long_req)
            full = ServeEngine(eng.cfg, eng.params, batch_slots=4,
                               kv_len=1024, prefill_chunk=8,
                               windowed_cache=False, device=dev)
            full_done, full_stats, full_recs = serve(
                full, mods, long_req, keep_logits=True, warm=False)
            check_run(arch, full_done, full_stats, long_req)
            del full
            witness = compare_ring_with_full(ring_recs, full_recs, 520)
            del ring_recs, full_recs
            emit(phase="serve_long", arch=arch, kv_format=fmt,
                 prompt_tokens=600, ring_slots=520, **long_stats,
                 full_length_tokens=full_done[0].tokens,
                 ring_tokens=long_done[0].tokens, **witness)
            runs += [long_stats, full_stats]
            t0 = time.monotonic()
            worst, n = compare_with_cpu(eng, records)
        else:
            # the prefill step and the first three decode steps (the steps
            # whose cache was recorded), to keep the CPU replay short. A q4
            # code flips where a value lies near a midpoint, so the CPU's
            # own cache drifts from the card's with the bf16 rounding of
            # the projections: the held replay reads the card's cache, its
            # K/V witness holds the CPU's own new codes to the card's, and
            # the drift of a replay on the CPU's own cache is reported
            records = records[:sum("cache" in r for r in records)]
            check(len(records) >= 4 and records[0]["T"] > 1
                  and [r["T"] for r in records[-3:]] == [1, 1, 1],
                  "the q4 compare needs the prefill and 3 decode steps")
            out["cpu_own_cache_max_rel_logit_err"] = max(
                float(np.abs(got - want).max() / np.abs(want).max())
                for got, want, _ in replay_on_cpu(eng, records))
            t0 = time.monotonic()
            kv = dict(codes=0, differ=0, max_codepoints=0,
                      max_scale_rel=0.0)
            worst, n = compare_with_cpu(eng, records, card_cache=True,
                                        kv_stats=kv)
            out["cpu_kv_witness"] = hold_kv_witness(kv)
            out["cpu_compared_steps"] = len(records)
        out.update(cpu_max_rel_logit_err=worst, cpu_margin_tokens=n,
                   cpu_compare_s=time.monotonic() - t0)
        del records
        out["tokens"] = {g.rid: g.tokens for g in done}
        emit(**out)
        runs.append(stats)
    del eng
    torch.cuda.empty_cache()
    return runs


# ---------------------------------------------------------------------------
# Phase 6: the paper's measurement and allocation path (teacher forcing)


def count_matmul_kernels(fn):
    """Run ``fn`` under torch.profiler; the device kernels of the
    dequant_matmul (``mma::kernel``) and dequant_matmul_t (``tc::kernel``)
    libraries that it ran."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    # demangled or mangled names of the tensor-core kernels
    names = {"dequant_matmul": ("mma::kernel<", "3mma6kernel"),
             "dequant_matmul_t": ("tc::kernel<", "2tc6kernel")}
    return out, {name: sum(e.count for e in events
                           if any(k in e.key for k in keys))
                 for name, keys in names.items()}


def teacher_forcing_times(mods, dev, tc_ptxas):
    """Both matmul kernels at the teacher-forcing M = B·T = 2048 (B=2,
    T=1024), at every gemma3-1b projection shape and the tied unembed:
    kernel, plain and torch.matmul times beside the bound, reruns bitwise.
    Then the sums over one forward (launches per forward x per-call ms)."""
    from repro_torch.core.registry import parse_format
    gen = torch.Generator(device=dev).manual_seed(5)
    cb4 = parse_format(SPEC).element.torch_codepoints(dev)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = {"dequant_matmul": [], "dequant_matmul_t": []}
    for (K, N), per_fwd, names in PROJECTIONS["gemma3-1b"]:
        r = matmul_case(mods, dev, gen, cb4, flush, K, N, TF_M, 4)
        r.update(kernel="dequant_matmul", model="gemma3-1b", weights=names,
                 launches_per_forward=per_fwd, regime="teacher forcing",
                 bound_by=bound_by(r["bytes"], r["flops"]))
        emit(phase="kernel", **r)
        rows["dequant_matmul"].append(r)
    V, D = UNEMBED_T
    r = matmul_t_case(mods, dev, gen, cb4, flush, V, D, TF_M, 4, tc_ptxas)
    r.update(kernel="dequant_matmul_t", model="gemma3-1b",
             weights="tied unembed", launches_per_forward=1,
             regime="teacher forcing",
             bound_by=bound_by(r["bytes"], r["flops"]))
    emit(phase="kernel", **r)
    rows["dequant_matmul_t"].append(r)
    del flush
    torch.cuda.empty_cache()
    for name, rs in rows.items():
        emit(phase="summary", kernel=name, measured_over="one gemma3-1b "
             f"teacher-forcing forward (B=2, T=1024, M={TF_M})",
             launches=sum(r["launches_per_forward"] for r in rs),
             **per_step(rs, lambda r: True,
                        lambda r: r["launches_per_forward"]))
    return rows


def allocation_phase(dev, mods, tc_ptxas):
    """gemma3-1b full, seeded random f32 weights, remat full, tokens from
    numpy: the diagonal Fisher on the card (2 batches of B=2, T=1024), the
    Eq. 5 allocation at 4.0 bits and its plan beside the flat 4-bit one,
    their top-k KLs on 2 held-out batches, a packed babsmax64:n4 ``apply``
    (182 + 1 matmul launches, held to the dense ``apply`` over the
    dequantised checkpoint, and one T=512 sequence to the CPU plain path),
    the card's Fisher against the CPU's on one T=256 sequence with the same
    labels, ``--kv-format auto`` serving, and the matmul kernels' times at
    M = 2048. Returns the launch counts of its runs."""
    from repro_torch import configs
    from repro_torch.core import (build_allocated_plan, build_plan, fisher,
                                  metrics)
    from repro_torch.core.allocation import allocate_bits, average_bits
    from repro_torch.models import transformer
    from repro_torch.serve.engine import params_to
    t_phase = time.monotonic()
    cfg = configs.get_config("gemma3-1b", "full")
    check(cfg.remat == "full", "the Fisher runs rematerialised layers")
    params = transformer.init(cfg, seed=0, device=dev)
    rng = np.random.default_rng(3)

    def batch(b, t):
        return {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab, (b, t)).astype(np.int32)).to(dev)}

    def apply(p, b, c=cfg):
        return transformer.apply(p, b, c)
    calib = [batch(2, 1024) for _ in range(2)]
    held = [batch(2, 1024) for _ in range(2)]

    # 1. Fisher and the Eq. 5 allocation; the batches' backward passes are
    # timed apart from the accumulator's f64 fold on the host
    sq_grads, sq_s = fisher._sq_grads, []

    def timed_sq_grads(*args):
        torch.cuda.synchronize()
        t = time.monotonic()
        out = sq_grads(*args)
        torch.cuda.synchronize()
        sq_s.append(time.monotonic() - t)
        return out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fisher._sq_grads = timed_sq_grads
    t0 = time.monotonic()
    try:
        fish = fisher.estimate_diag_fisher(
            apply, params, calib, torch.Generator(device=dev).manual_seed(0))
    finally:
        fisher._sq_grads = sq_grads
    torch.cuda.synchronize()
    fisher_s = time.monotonic() - t0
    fisher_peak = torch.cuda.max_memory_allocated(dev)
    stats = fisher.per_tensor_stats(params, fish)
    del fish
    alloc = allocate_bits(stats, target_bits=4.0, b_min=2, b_max=8)
    avg = average_bits(alloc, stats)
    check(abs(avg - 4.0) <= 1e-3, f"allocation averages {avg} bits")
    plans = {"flat": build_plan(params, "babsmax128:t4"),
             "allocated": build_allocated_plan(params, alloc, "babsmax128")}
    quantised = {k: b for k, b in alloc.items()
                 if plans["allocated"].formats.get(k) is not None}
    want = {k for k, f in plans["flat"].formats.items() if f is not None}
    check(set(quantised) == want and {"['embed']", "['layers']['wq']",
                                      "['layers']['w_down']"} <= want,
          f"allocated plan quantises {sorted(quantised)}, the flat plan "
          f"{sorted(want)}")
    emit(phase="allocation", step="fisher", sequences=4, tokens_per_seq=1024,
         fisher_s=fisher_s, s_per_sequence=fisher_s / 4,
         backward_s_per_batch=sq_s, backward_s_per_sequence=sum(sq_s) / 4,
         host_fold_s=fisher_s - sum(sq_s),
         peak_mem_bytes=fisher_peak, average_bits=avg,
         min_bits=min(quantised.values()), max_bits=max(quantised.values()),
         bits=alloc, stats=stats)

    # 2. top-k KL of the flat and the allocated plan on held-out batches
    t0 = time.monotonic()
    with torch.no_grad():
        dense = [apply(params, b) for b in held]
        kl = {}
        for name, plan in plans.items():
            fq = plan.fake_quant(params)
            kl[name] = float(np.mean([
                float(metrics.mean_topk_kl(d, apply(fq, b), k=128))
                for d, b in zip(dense, held)]))
            del fq
    check(all(np.isfinite(v) and v > 0 for v in kl.values()),
          f"KLs must be finite and positive: {kl}")
    emit(phase="allocation", step="kl", k=128, held_out_batches=2,
         kl_flat_t4=kl["flat"], kl_allocated=kl["allocated"],
         bits_flat=plans["flat"].bits_per_param(params),
         bits_allocated=plans["allocated"].bits_per_param(params),
         seconds=time.monotonic() - t0)

    # 3. packed apply at M = B·T = 2048 against the dense apply over the
    # dequantised checkpoint (the same quantised weights)
    plan4 = build_plan(params, SPEC)
    qparams = plan4.quantise(params)
    packed = plan4.pack_quantised(qparams, transformer.pack_layouts(cfg))
    deq = plan4.dequantise(qparams)
    del qparams
    runs = []
    with torch.no_grad():
        apply(packed, held[0])                        # warm the tables
        for m in mods.values():
            m.launches = 0
        logits, device_kernels = count_matmul_kernels(
            lambda: apply(packed, held[0]))
        launches = {name: m.launches for name, m in mods.items()}
        runs.append({"launches": launches})
        check(launches == {"dequant_matmul": 182, "dequant_matmul_t": 1,
                           "block_quant": 0, "decode_attention_quant": 0},
              f"packed apply launched {launches}")
        check(device_kernels == {"dequant_matmul": 182,
                                 "dequant_matmul_t": 1},
              f"packed apply ran device kernels {device_kernels}")
        want = apply(deq, held[0])
        rel, margin = hold_logits(logits, want, "packed vs dequantised "
                                      "dense apply, B=2 T=1024")
        check(margin > 0, "no high-margin position to compare")
        kl_packed = float(metrics.mean_topk_kl(dense[0], logits, k=128))
        kl_deq = float(metrics.mean_topk_kl(dense[0], want, k=128))
        check(abs(kl_packed - kl_deq) <= 0.05 * kl_deq,
              f"packed KL {kl_packed} vs fake-quant KL {kl_deq}")
        del logits, want, dense
        flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
        packed_ms = time_ms(lambda: apply(packed, held[0]), flush, reps=3)
        dense_ms = time_ms(lambda: apply(deq, held[0]), flush, reps=3)
        del flush, deq
        one = {"tokens": held[1]["tokens"][:1, :512]}
        card = apply(packed, one).cpu()
    t0 = time.monotonic()
    with torch.no_grad():
        cpu = apply(params_to(packed, torch.device("cpu")),
                    {"tokens": one["tokens"].cpu()})
    cpu_s = time.monotonic() - t0
    cpu_rel, cpu_margin = hold_logits(card, cpu, "packed apply, card vs "
                                          "CPU plain path, T=512")
    check(cpu_margin > 0, "no high-margin position in the CPU compare")
    del packed, card, cpu
    emit(phase="allocation", step="packed_apply", tokens=[2, 1024],
         launches=launches, profiler_device_kernels=device_kernels,
         dequant_max_rel_logit_err=rel, dequant_margin_positions=margin,
         kl_packed=kl_packed, kl_fake_quant=kl_deq,
         kl_rel_diff=abs(kl_packed - kl_deq) / kl_deq,
         packed_apply_ms=packed_ms, dense_apply_ms=dense_ms,
         cpu_tokens=512, cpu_layers=cfg.n_layers,
         cpu_max_rel_logit_err=cpu_rel, cpu_margin_positions=cpu_margin,
         cpu_s=cpu_s)

    # 4. the card's Fisher against the CPU's, one T=256 sequence, the same
    # labels (drawn on the CPU) on both sides
    seq = [{"tokens": held[1]["tokens"][1:2, :256]}]
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 256)))
    sample = fisher._sample_labels
    fisher._sample_labels = lambda logits, gen: labels.to(logits.device)
    try:
        t0 = time.monotonic()
        f_card = fisher.per_tensor_stats(
            params, fisher.estimate_diag_fisher(apply, params, seq, None))
        card_s = time.monotonic() - t0
        cpu_params = params_to(params, torch.device("cpu"))
        t0 = time.monotonic()
        f_cpu = fisher.per_tensor_stats(
            cpu_params, fisher.estimate_diag_fisher(
                lambda p, b: apply(p, b, cfg.replace(remat="none")),
                cpu_params, [{"tokens": seq[0]["tokens"].cpu()}], None))
        cpu_s = time.monotonic() - t0
    finally:
        fisher._sample_labels = sample
    del cpu_params
    rel = {k: abs(f_card[k]["fisher_mean"] - f_cpu[k]["fisher_mean"])
           / f_cpu[k]["fisher_mean"] for k in f_cpu}
    check(max(rel.values()) <= 0.05, f"card vs CPU fisher_mean: {rel}")
    emit(phase="allocation", step="fisher_vs_cpu", tokens=256,
         max_rel_diff=max(rel.values()), rel_diff=rel, card_s=card_s,
         cpu_s=cpu_s)
    del params
    torch.cuda.empty_cache()

    # 5. --kv-format auto, then serving on the formats it chose
    import contextlib
    import io
    from repro_torch.launch import serve as serve_cli
    spec = transformer.cache_spec(cfg, 4, 1024, slack=8)
    f32_bytes = sum(2 * len(g.layers) * 4 * g.length * spec.kv_heads *
                    spec.head_dim * 4 for g in spec.groups)
    budget = f32_bytes // 2       # half the all-f32 cache: demotes a group
    for m in mods.values():
        m.launches = 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        done = serve_cli.main([
            "--arch", "gemma3-1b", "--variant", "full", "--quantise", SPEC,
            "--packed", "--kv-format", "auto", "--kv-budget-bytes",
            str(budget), "--kv-len", "1024", "--slots", "4", "--requests",
            "4", "--max-new", "8", "--device", "cuda"])
    torch.cuda.synchronize()
    launches = {name: m.launches for name, m in mods.items()}
    runs.append({"launches": launches})
    print(out.getvalue(), end="", flush=True)
    line = next(ln for ln in out.getvalue().splitlines()
                if "kv auto allocation" in ln)
    fmts = line.split(": ")[1].split(" ")[0].split(",")
    check(len(fmts) == 2 and fmts != ["f32", "f32"],
          f"--kv-format auto demoted no group: {fmts}")
    check(len(done) == 4 and all(len(g.tokens) == 8 and not g.failed
                                 for g in done),
          "--kv-format auto: requests did not all finish")
    check(launches["block_quant"] > 0 and
          launches["decode_attention_quant"] > 0,
          f"--kv-format auto served without the quantised KV path: "
          f"{launches}")
    emit(phase="allocation", step="kv_format_auto", budget_bytes=budget,
         all_f32_bytes=f32_bytes, formats=fmts, launches=launches,
         tokens={g.rid: g.tokens for g in done})

    # 6. the matmul kernels at M = 2048
    tf_rows = teacher_forcing_times(mods, dev, tc_ptxas)
    emit(phase="timing", allocation_phase_s=time.monotonic() - t_phase)
    return runs, tf_rows


# ---------------------------------------------------------------------------
# Phase 7: the §4 training pipeline and the variable-length formats


def quiet(fn, *args):
    """``fn(*args)`` with its stdout captured; returns (result, text)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(*args)
    return res, out.getvalue()


def served(mods, fn):
    """Run ``fn`` with every kernel's launch count set to 0 just before it
    and read just after it; returns (result, launches)."""
    for m in mods.values():
        m.launches = 0
    res = fn()
    torch.cuda.synchronize()
    return res, {name: m.launches for name, m in mods.items()}


def deterministic_runs(fn):
    """``fn()`` under ``torch.use_deterministic_algorithms`` (warn-only, so
    an op with no deterministic CUDA form is named, not fatal); returns
    (result, the names of such ops)."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = fn()
    finally:
        torch.use_deterministic_algorithms(False)
    ops = sorted({str(w.message).split(" does not have a deterministic")[0]
                  for w in caught
                  if "does not have a deterministic" in str(w.message)})
    return res, ops


def resume_phase(dev, mods, root):
    """paper-100m full: ``launch.train`` for 20 steps of CE (B=8, T=256, lr
    5e-4 after 4 warmup steps) with checkpoints every 10, then a second run from the step-10 checkpoint,
    held to steps 11-20 of the first: with f32 Adam moments bitwise, with
    8-bit moments (``--quantised-opt``) bitwise at step 11 and within 1e-2
    after it: the f32 moments of the checkpoint requantise to other scales
    in some blocks, and the reference's 8-bit Adam makes loss spikes that
    amplify the difference (an element whose v flushes to 0 while its m,
    on a grid without 0, does not, moves by about lr·m/eps). Then ``launch.serve --ckpt`` serves the checkpoint
    packed. Returns the serve run's launches."""
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    from repro_torch.train import checkpoint as ckpt
    base = ["--arch", "paper-100m", "--variant", "full", "--steps", "20",
            "--batch", "8", "--seq", "256", "--lr", "5e-4", "--warmup", "4",
            "--log-every", "1", "--seed", "0", "--device", "cuda"]
    out = {}
    for moments in ("f32", "8bit"):
        flags = base + (["--quantised-opt"] if moments == "8bit" else [])
        a, b = root / f"{moments}_a", root / f"{moments}_b"
        t0 = time.monotonic()
        ((state_a, hist_a), _), nondet = deterministic_runs(lambda: quiet(
            train_cli.main, flags + ["--ckpt-dir", str(a), "--ckpt-every",
                                     "10"]))
        first_s = time.monotonic() - t0
        shutil.copytree(a / "step_00000010", b / "step_00000010")
        t0 = time.monotonic()
        ((state_b, hist_b), _), nondet_b = deterministic_runs(lambda: quiet(
            train_cli.main, flags + ["--ckpt-dir", str(b)]))
        resumed_s = time.monotonic() - t0
        nondet = sorted(set(nondet) | set(nondet_b))
        losses_a = [h["loss"] for h in hist_a]
        losses_b = [h["loss"] for h in hist_b]
        emit(phase="train", step="resume_losses", moments=moments,
             losses=losses_a, resumed_losses=losses_b,
             nondeterministic_ops=nondet)
        check([h["step"] for h in hist_b] == list(range(10, 20)),
              f"resume did not start at step 10: {hist_b}")
        check(np.mean(losses_a[-3:]) < 0.9 * np.mean(losses_a[:3]),
              f"paper-100m CE did not fall: {losses_a}")
        pa, pb = (dict(flat_with_paths(s["params"])) for s in (state_a,
                                                               state_b))
        same = [n for n in pa if torch.equal(pa[n], pb[n])]
        rel = max(abs(x - y) / abs(x) for x, y in zip(losses_a[10:],
                                                      losses_b))
        bitwise = not nondet and moments == "f32"
        if bitwise:
            check(losses_b == losses_a[10:] and len(same) == len(pa),
                  f"f32-moment resume is not bitwise: losses {losses_a[10:]}"
                  f" vs {losses_b}, {len(same)} of {len(pa)} tensors equal")
        else:
            check(losses_b[0] == losses_a[10] or nondet,
                  f"first resumed loss {losses_b[0]} != {losses_a[10]}")
            check(rel <= 1e-2, f"{moments} resume: losses differ by {rel}")
        out[moments] = dict(
            losses=losses_a, resumed_losses=losses_b, max_rel_loss_diff=rel,
            bitwise_losses=losses_b == losses_a[10:],
            equal_tensors=len(same), tensors=len(pa),
            nondeterministic_ops=nondet, first_run_s=first_s,
            resumed_run_s=resumed_s,
            s_per_step=float(np.median([h["s_per_step"]
                                        for h in hist_a[1:]])))
        if moments == "f32":
            path = str(a / "step_00000020")
            nbytes = os.path.getsize(os.path.join(path, "arrays.npz"))
            t0 = time.monotonic()
            ckpt.save_checkpoint(str(root / "timed"), state_a, 20)
            save_s = time.monotonic() - t0
            t0 = time.monotonic()
            back, _ = ckpt.restore_checkpoint(
                str(root / "timed" / "step_00000020"), template=state_a)
            torch.cuda.synchronize()
            restore_s = time.monotonic() - t0
            check(all(torch.equal(x, y) for (_, x), (_, y) in zip(
                flat_with_paths(back), flat_with_paths(state_a))),
                "checkpoint round trip changed the state")
            out.update(checkpoint_bytes=nbytes, save_s=save_s,
                       restore_s=restore_s)
            del back
            shutil.rmtree(root / "timed")
        else:
            shutil.rmtree(a)       # 1.5 GB a checkpoint: keep only f32_a
        shutil.rmtree(b)
        del state_a, state_b
        torch.cuda.empty_cache()
    t0 = time.monotonic()
    (done, text), launches = served(mods, lambda: quiet(serve_cli.main, [
        "--arch", "paper-100m", "--variant", "full", "--ckpt",
        str(root / "f32_a"), "--quantise", SPEC, "--packed", "--requests",
        "4", "--max-new", "8", "--device", "cuda"]))
    check("step_00000020 (step 20)" in text, "serve --ckpt loaded "
          f"another checkpoint: {text[:300]}")
    check(len(done) == 4 and all(len(g.tokens) == 8 and not g.failed
                                 for g in done),
          "serve --ckpt: requests did not all finish")
    check(launches["dequant_matmul"] > 0, f"serve --ckpt launched "
          f"{launches}")
    emit(phase="train", step="resume", arch="paper-100m", batch=[8, 256],
         serve_launches=launches, serve_s=time.monotonic() - t0,
         serve_tokens={g.rid: g.tokens for g in done}, **out)
    return {"launches": launches}


def held_batch(cfg, dev, seed):
    from repro_torch.data.pipeline import make_batch_fn
    return {"tokens": torch.from_numpy(make_batch_fn(
        cfg, seq=1024, batch=2, seed=seed)(0)["tokens"]).to(dev)}


def hold_packed(cfg, plan, params, held, what):
    """The packed ``apply`` of ``plan``'s checkpoint held to the dense
    ``apply`` over the same checkpoint dequantised, on the card (B=2,
    T=1024): the logits rule of ``hold_logits``."""
    from repro_torch.models import transformer
    qparams = plan.quantise(params)
    with torch.no_grad():
        packed = plan.pack_quantised(qparams, transformer.pack_layouts(cfg))
        got = transformer.apply(packed, held, cfg)
        del packed
        want = transformer.apply(plan.dequantise(qparams), held, cfg)
    rel, margin = hold_logits(got, want, what)
    check(margin > 0, f"{what}: no high-margin position")
    return qparams, rel, margin


def serve_plan(cfg, qparams, plan, dev, mods, what):
    """Serve ``plan``'s quantised checkpoint packed with a q8 KV cache (all
    four kernels): 4 requests, launches counted over the run."""
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine.from_quantised(cfg.replace(kv_format="q8"), qparams,
                                     plan, batch_slots=4, kv_len=1024,
                                     prefill_chunk=8, device=dev)
    reqs = short_requests(cfg.vocab, seed=4)
    done, stats, _ = serve(eng, mods, reqs, keep_logits=False)
    check_run("gemma3-1b", done, stats, reqs)
    check(all(n > 0 for n in stats["launches"].values()),
          f"{what}: not every kernel ran: {stats['launches']}")
    del eng
    torch.cuda.empty_cache()
    return stats, {g.rid: g.tokens for g in done}


def qat_phase(dev, mods):
    """gemma3-1b full: a teacher from 20 CE steps (B=2, T=1024, lr 5e-4 after
    4 warmup steps: enough to learn the stream's bigram rule, so its
    logits have high-margin positions to hold), then
    ``run_qat`` with babsmax64:n4 for 10 steps; the full KL to the teacher
    on a held-out batch before (the direct cast) and after, which must
    fall; the student packed, held to its dense dequantised ``apply`` and
    served with a q8 cache. Returns (teacher params, serve stats)."""
    from repro_torch import configs
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.models import transformer
    from repro_torch.train import AdamConfig, TrainConfig, train
    from repro_torch.train.loop import full_kl_loss
    from repro_torch.train.optimizer import paper_qat_lr
    from repro_torch.train.qat import qat_plan_for, run_qat
    cfg = configs.get_config("gemma3-1b", "full")
    batch_fn = make_batch_fn(cfg, seq=1024, batch=2, seed=1)
    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats(dev)
    state, hist = train(cfg, TrainConfig(steps=20, lr=5e-4, warmup=4,
                                         log_every=1),
                        AdamConfig(), batch_fn, device=dev)
    teacher = state["params"]
    del state
    torch.cuda.empty_cache()
    teacher_s = time.monotonic() - t0
    teacher_peak = torch.cuda.max_memory_allocated(dev)
    held = held_batch(cfg, dev, seed=9)
    plan = qat_plan_for(teacher, SPEC)

    def kl_to_teacher(params):
        with torch.no_grad():
            ref = transformer.apply(teacher, held, cfg)
            fq = plan.fake_quant(params)
            return float(full_kl_loss(ref, transformer.apply(fq, held, cfg)))
    kl_direct = kl_to_teacher(teacher)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    state, qhist, plan = run_qat(cfg, teacher, SPEC, batch_fn, steps=10,
                                 log_every=1)
    torch.cuda.synchronize()
    qat_s = time.monotonic() - t0
    qat_peak = torch.cuda.max_memory_allocated(dev)
    student = state["params"]
    del state
    torch.cuda.empty_cache()
    kl_after = kl_to_teacher(student)
    emit(phase="train", step="qat", arch="gemma3-1b", spec=SPEC,
         batch=[2, 1024], teacher_ce=[h["loss"] for h in hist],
         teacher_s=teacher_s, teacher_peak_mem_bytes=teacher_peak,
         teacher_s_per_step=float(np.median([h["s_per_step"]
                                             for h in hist[1:]])),
         lr=paper_qat_lr(4), qat_losses=[h["loss"] for h in qhist],
         kl_direct_cast=kl_direct, kl_after=kl_after,
         s_per_step=float(np.median([h["s_per_step"] for h in qhist[1:]])),
         qat_s=qat_s, peak_mem_bytes=qat_peak)
    check(kl_after < kl_direct, f"QAT did not lower the KL to the teacher: "
          f"{kl_direct} -> {kl_after}")
    qparams, rel, margin = hold_packed(
        cfg, plan, student, held, "QAT student: packed vs dequantised dense "
        "apply, B=2 T=1024")
    del student
    stats, tokens = serve_plan(cfg, qparams, plan, dev, mods, "QAT student")
    emit(phase="train", step="qat_serve", arch="gemma3-1b", spec=SPEC,
         dequant_max_rel_logit_err=rel, dequant_margin_positions=margin,
         serve=stats, tokens=tokens)
    return teacher, stats


def lloyd_phase(dev, mods, params):
    """gemma3-1b full: the diagonal Fisher on one sequence (T=1024), the
    Fisher-weighted Lloyd-Max plan at 4 bits under babsmax64 (fitted on the
    host), each tensor's R against the babsmax64:t4 cube-root format, then
    the plan packed (16-point data-fitted codebooks), held to its dense
    dequantised ``apply`` and served with a q8 cache."""
    from repro_torch import configs
    from repro_torch.core import build_plan, fisher, fit_lloyd_plan
    from repro_torch.models import transformer
    cfg = configs.get_config("gemma3-1b", "full")
    seq = held_batch(cfg, dev, seed=11)
    t0 = time.monotonic()
    fish = fisher.estimate_diag_fisher(
        lambda p, b: transformer.apply(p, b, cfg), params,
        [{"tokens": seq["tokens"][:1]}],
        torch.Generator(device=dev).manual_seed(0))
    fisher_s = time.monotonic() - t0
    t0 = time.monotonic()
    plan = fit_lloyd_plan(params, 4, "babsmax64", fisher=fish)
    fit_s = time.monotonic() - t0
    t4 = build_plan(params, "babsmax64:t4")
    fish = dict(flat_with_paths(fish))
    r = {}
    with torch.no_grad():
        for name, x in flat_with_paths(params):
            f = plan.formats.get(name)
            if f is None:
                continue
            w = fish[name].to(dev).float()
            r[name] = dict(
                codepoints=list(f.element.codepoints),
                lloyd=float(f.relative_rms_error(x)),
                t4=float(t4.formats[name].relative_rms_error(x)),
                lloyd_fisher=float(f.relative_rms_error(x, w)),
                t4_fisher=float(t4.formats[name].relative_rms_error(x, w)))
            del w
    del fish
    emit(phase="train", step="lloyd", arch="gemma3-1b", bits=4,
         scaling="babsmax64", fisher_tokens=1024, fisher_s=fisher_s,
         fit_host_s=fit_s, tensors=r)
    cps = [np.asarray(v["codepoints"]) for v in r.values()]
    check(r and all(len(c) == 16 for c in cps),
          f"Lloyd plan fitted {len(r)} tensors")
    check(any(not np.allclose(c, -c[::-1]) for c in cps),
          "no Lloyd codebook is asymmetric")
    check(sum(v["lloyd_fisher"] < v["t4_fisher"] for v in r.values()) >=
          len(r) // 2, f"the Fisher-weighted Lloyd fit lost to t4 on most "
          f"tensors: {r}")
    qparams, rel, margin = hold_packed(
        cfg, plan, params, held_batch(cfg, dev, seed=9),
        "Lloyd plan: packed vs dequantised dense apply, B=2 T=1024")
    stats, tokens = serve_plan(cfg, qparams, plan, dev, mods, "Lloyd plan")
    emit(phase="train", step="lloyd_serve", arch="gemma3-1b",
         dequant_max_rel_logit_err=rel, dequant_margin_positions=margin,
         serve=stats, tokens=tokens)
    return stats


def grid_plan(params, bits, samples=1 << 20, seed=0):
    """trms:grid:C with each quantisable tensor's lattice step fitted
    (``compress.fit_grid_delta``) to ``bits`` of entropy on a seeded sample
    of 2^20 of its RMS-normalised values (a fit over all of gemma3-1b's
    embedding on the host would take minutes)."""
    from repro_torch.core import QuantisationPlan, parse_format
    from repro_torch.core.compress import fit_grid_delta
    from repro_torch.core.element import uniform_grid
    from repro_torch.core.plan import quantisable
    base = parse_format("trms:grid:C")
    rng = np.random.default_rng(seed)
    formats = {}
    with torch.no_grad():
        for name, x in flat_with_paths(params):
            if not quantisable(name, x):
                formats[name] = None
                continue
            xb = base.scaling.normalise(x.float())[0].reshape(-1)
            idx = torch.from_numpy(rng.integers(0, xb.numel(), samples))
            sample = xb[idx.to(xb.device)].cpu().numpy()
            formats[name] = dataclasses.replace(
                base, element=uniform_grid(fit_grid_delta(sample, bits)))
    return QuantisationPlan(formats)


def fixed_length_grid_bits(plan, params, keep_bits=16.0):
    """Bits/param of the grid's codes stored at a fixed length: each
    tensor's codes at ceil(log2(its code range)) bits, plus its scale."""
    total, n_all = 0.0, 0
    with torch.no_grad():
        for name, x in flat_with_paths(params):
            n, f = x.numel(), plan.formats.get(name)
            if f is None:
                total += keep_bits * n
            else:
                lo, hi = torch.aminmax(f.quantise(x).codes)
                total += n * (math.ceil(math.log2(int(hi - lo) + 1))
                              + f.scaling.scale_bits_per_param(x.shape))
            n_all += n
    return total / n_all


def accounting_phase(dev, params):
    """gemma3-1b full: measured bits/param of trms:t4:C and of a 4-bit
    trms:grid:C plan, the codes made and counted on the card, against the
    CPU's answer on the same weights (within 1e-4 bits: a tensor-wide RMS
    summed in another order may flip a few codes), each below its
    fixed-length counterpart; then one layer's wq grid code stream through
    the Huffman codec and back."""
    from repro_torch.core import build_plan, compress
    from repro_torch.serve.engine import params_to
    t0 = time.monotonic()
    plans = {"trms:t4:C": build_plan(params, "trms:t4:C"),
             "trms:grid:C": grid_plan(params, 4.0)}
    grid_fit_s = time.monotonic() - t0
    cpu_params = params_to(params, torch.device("cpu"))
    out = {}
    for name, plan in plans.items():
        t0 = time.monotonic()
        card = plan.bits_per_param(params, measured=True)
        card_s = time.monotonic() - t0
        t0 = time.monotonic()
        cpu = plan.bits_per_param(cpu_params, measured=True)
        cpu_s = time.monotonic() - t0
        check(abs(card - cpu) <= 1e-4, f"{name}: card {card} vs CPU {cpu} "
              "bits/param")
        out[name] = dict(card_bits=card, cpu_bits=cpu, card_s=card_s,
                         cpu_s=cpu_s)
    del cpu_params
    t4 = build_plan(params, "trms:t4")
    out["trms:t4"] = dict(bits=t4.bits_per_param(params))
    out["trms:grid:C"]["fixed_length_bits"] = fixed_length_grid_bits(
        plans["trms:grid:C"], params)
    check(out["trms:t4:C"]["card_bits"] < out["trms:t4"]["bits"],
          f"trms:t4:C is not below trms:t4: {out}")
    check(out["trms:grid:C"]["card_bits"] <
          out["trms:grid:C"]["fixed_length_bits"],
          f"the grid's entropy is not below its fixed-length codes: {out}")
    name = "['layers']['wq']"
    x = params["layers"]["wq"]
    with torch.no_grad():
        out["r_wq"] = {k: float(p.formats[name].relative_rms_error(x))
                       for k, p in (("trms:t4", t4),
                                    ("trms:grid:C", plans["trms:grid:C"]))}
        codes = plans["trms:grid:C"].formats[name].quantise(x).codes
    sym = codes.reshape(x.shape[0], -1)[0].long()
    sym = (sym - sym.min()).cpu().numpy()
    hist = np.bincount(sym)
    hc = compress.build_huffman(hist)
    t0 = time.monotonic()
    payload, n_bits = hc.encode(sym)
    enc_s = time.monotonic() - t0
    t0 = time.monotonic()
    back = hc.decode(payload, sym.size)
    dec_s = time.monotonic() - t0
    check(np.array_equal(back, sym), "Huffman round trip changed the codes")
    ent, mean = compress.entropy_bits(hist), hc.mean_bits(hist)
    check(ent <= mean < ent + 1 and n_bits == round(mean * sym.size),
          f"Huffman mean {mean} bits against entropy {ent}")
    out["huffman_wq_layer0"] = dict(
        symbols=int(sym.size), distinct=int((hist > 0).sum()),
        entropy_bits=ent, mean_bits=mean, payload_bytes=len(payload),
        encode_s=enc_s, decode_s=dec_s)
    emit(phase="train", step="accounting", arch="gemma3-1b",
         grid_fit_s=grid_fit_s, **out)


def train_phase(dev, mods):
    """The training pipeline and the paper's variable-length formats (phase
    7); checkpoints go to runs/chip_smoke_train/ in the checkout (git
    ignores it), removed at the end. Returns the serve runs' launches."""
    t_phase = time.monotonic()
    root = Path(__file__).resolve().parent / "runs" / "chip_smoke_train"
    shutil.rmtree(root, ignore_errors=True)
    try:
        runs = [resume_phase(dev, mods, root)]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit(phase="timing", resume_s=time.monotonic() - t_phase)
    teacher, qat_stats = qat_phase(dev, mods)
    emit(phase="timing", qat_end_s=time.monotonic() - t_phase)
    lloyd_stats = lloyd_phase(dev, mods, teacher)
    emit(phase="timing", lloyd_end_s=time.monotonic() - t_phase)
    accounting_phase(dev, teacher)
    del teacher
    torch.cuda.empty_cache()
    emit(phase="timing", train_phase_s=time.monotonic() - t_phase)
    return runs + [qat_stats, lloyd_stats]


def device_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
        f"nvidia-smi failed: {r.stderr.strip()}"


def ptxas_summary(build_dir):
    """Registers, spills and stack per library from nvcc's -Xptxas -v."""
    out = {}
    for name in KERNELS:
        lib = "decode_attention" if name == "decode_attention_quant" else name
        report = (build_dir / f"ptxas_{lib}.txt").read_text()

        def most(pattern):
            return max((int(n) for n in re.findall(pattern, report)),
                       default=0)
        out[name] = dict(
            max_registers=most(r"Used (\d+) registers"),
            max_spill_store_bytes=most(r"(\d+) bytes spill stores"),
            max_stack_frame_bytes=most(r"(\d+) bytes stack frame"))
    return out


def sass_check(build_dir):
    """Tensor-core instructions in the built dequant_matmul,
    dequant_matmul_t and decode_attention libraries (``cuobjdump -sass``,
    CUDA toolkit): HMMA must be in each."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name in ("dequant_matmul", "dequant_matmul_t", "decode_attention"):
        lib = build_dir / f"lib{name}.so"
        r = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                           text=True, timeout=300)
        check(r.returncode == 0, f"cuobjdump -sass {lib} failed: {r.stderr}")
        hmma = [ln for ln in r.stdout.splitlines() if "HMMA" in ln]
        emit(phase="sass", library=name, hmma_instructions=len(hmma),
             example=hmma[0].strip() if hmma else None)
        check(hmma, f"the {name} library has no HMMA instruction")


def ptxas_entries(report):
    """(mangled entry name, registers, spill stores, stack frame, static
    shared bytes) of each kernel in an nvcc -Xptxas -v report."""
    parts = re.split(r"Compiling entry function '([^']+)'", report)
    for name, body in zip(parts[1::2], parts[2::2]):
        def num(pattern):
            f = re.search(pattern, body)
            return int(f.group(1)) if f else None
        yield name, dict(registers=num(r"Used (\d+) registers"),
                         spill_store_bytes=num(r"(\d+) bytes spill stores"),
                         stack_frame_bytes=num(r"(\d+) bytes stack frame"),
                         static_smem_bytes=num(r"(\d+) bytes smem") or 0)


def ptxas_attention_instances(build_dir):
    """ptxas figures of each instance of decode_attention.cu's kernels:
    attn_rows_kernel<bits, q type, row tile, elements a lane>, keyed
    ``rows_bits8_bf16_rt4_e8`` and the like, and attn_mma_kernel<bits, hd /
    64>, keyed ``mma_bits8_hd256``. The dynamic shared memory of a
    launch is ``instance_info``'s."""
    report = (build_dir / "ptxas_decode_attention.txt").read_text()
    out = {}
    for name, fig in ptxas_entries(report):
        m = re.search(r"attn_rows_kernelILi(\d+)E(f|13__nv_bfloat16)Li(\d+)"
                      r"ELi(\d+)E", name)
        if m:
            dt = "f32" if m.group(2) == "f" else "bf16"
            out[f"rows_bits{m.group(1)}_{dt}_rt{m.group(3)}_e{m.group(4)}"] \
                = fig
        m = re.search(r"attn_mma_kernelILi(\d+)ELi(\d+)E", name)
        if m:
            out[f"mma_bits{m.group(1)}_hd{64 * int(m.group(2))}"] = fig
    check(out, "no decode_attention instance in its ptxas report")
    return out


def ptxas_tc_instances(build_dir):
    """Registers, spill stores and stack of each instance of the
    dequant_matmul_t tensor-core kernel (tc::kernel<bits, n8-tiles,
    block % 16 == 0>), from nvcc's -Xptxas -v report."""
    report = (build_dir / "ptxas_dequant_matmul_t.txt").read_text()
    out = {}
    for name, fig in ptxas_entries(report):
        m = re.search(r"tc6kernelILi(\d+)ELi(\d+)ELb([01])E", name)
        if m:
            bits, nt, blk16 = m.groups()
            out[f"bits{bits}_nt{nt}" +
                ("" if blk16 == "1" else "_block_not_16x")] = fig
    check(out, "no tc::kernel instance in the dequant_matmul_t ptxas report")
    return out


def per_step(rows, pick, launches):
    """Σ over the picked shapes of (per-call number x launches per step);
    None where a shape has no such number (no library call)."""
    picked = [r for r in rows if pick(r)]
    check(picked, "no kernel-phase shape for a per-step sum")
    out = {}
    for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms", "bytes",
              "flops"):
        vals = [r[k] for r in picked]
        out[k] = (None if None in vals else
                  sum(v * launches(r) for v, r in zip(vals, picked)))
    out["bound_by"] = bound_by(out["bytes"], out["flops"])
    return out


def summary(rows, runs):
    """The kernels line: per kernel its launches over the serve runs and,
    per gemma3-1b decode step (B = 4, q8 cache), its per-call times at that
    step's shapes times its launches per step. Also emits deepseek-7b's
    step for dequant_matmul."""
    launches = {name: sum(r["launches"][name] for r in runs)
                for name in KERNELS}
    g_step = LAUNCHES_PER_STEP["gemma3-1b"]
    # per gemma3-1b decode step (B = 4, q8 cache): each kernel's per-call
    # times at that step's shapes times its launches per step
    steps = {
        "dequant_matmul": per_step(
            rows["dequant_matmul"],
            lambda r: r.get("model") == "gemma3-1b" and r["M"] == 4,
            lambda r: r["launches_per_step"]),
        "dequant_matmul_t": per_step(
            rows["dequant_matmul_t"],
            lambda r: r["M"] == 4 and r["bits"] == 4, lambda r: 1),
        "block_quant": per_step(
            rows["block_quant"],
            lambda r: r["rows"] == 4 and r["hd"] == 256 and r["fmt"] == "q8",
            lambda r: g_step["block_quant"]),
        "decode_attention_quant": per_step(
            rows["decode_attention_quant"],
            lambda r: r["T"] == 1 and r["fmt"] == "q8",
            lambda r: 22 if r["ring"] else 4),
    }
    ds = per_step(rows["dequant_matmul"],
                  lambda r: r.get("model") == "deepseek-7b" and r["M"] == 4
                  and r.get("launches_per_step"),
                  lambda r: r["launches_per_step"])
    emit(phase="summary", measured_over="one deepseek-7b decode step at "
         "M=4 (211 launches)", kernel="dequant_matmul", **ds)
    # block_quant per gemma3-1b decode step (hd 256, 4 rows): the paired
    # call once a layer against two single-tensor calls a layer (the
    # parent's path), by one call per event pair and launch-bound
    bq = next(r for r in rows["block_quant"] if r["rows"] == 4 and
              r["hd"] == 256 and r["fmt"] == "q8")
    lu, n = bq["launch_us"], g_step["block_quant"]
    emit(phase="summary", kernel="block_quant", measured_over="one "
         f"gemma3-1b decode step (B=4, q8 cache, {n} layers)",
         paired_ms=bq["kernel_ms"] * n, single_pair_ms=bq["single_ms"] * 2 * n,
         paired_launch_bound_ms=lu["paired"]["device_us"] * n * 1e-3,
         single_pair_launch_bound_ms=lu["single_pair"]["device_us"] * n * 1e-3,
         floor_us=lu["floor"]["device_us"],
         paired_host_ms=lu["paired"]["host_us"] * n * 1e-3,
         single_pair_host_ms=lu["single_pair"]["host_us"] * n * 1e-3)
    # decode_attention_quant per gemma3-1b decode step (T=1, q8: 22 ring
    # layers at S=520, 4 global at S=1032), by both timings
    at = [r for r in rows["decode_attention_quant"]
          if r["T"] == 1 and r["fmt"] == "q8"]
    n = {True: 22, False: 4}
    emit(phase="summary", kernel="decode_attention_quant",
         measured_over="one gemma3-1b decode step (B=4, q8 cache, 26 "
         "layers)",
         event_pair_ms=sum(r["kernel_ms"] * n[r["ring"]] for r in at),
         launch_bound_ms=sum(r["launch_us"]["device_us"] * n[r["ring"]]
                             for r in at) * 1e-3,
         library_ms=sum(r["library_ms"] * n[r["ring"]] for r in at),
         bound_ms=sum(r["bound_ms"] * n[r["ring"]] for r in at))
    line = []
    for name, k in KERNELS.items():
        st = steps[name]
        line.append({
            "name": name, "route": "cuda", "source": k["source"],
            "replaces": k["replaces"], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "ms": st["kernel_ms"], "plain_ms": st["plain_ms"],
            "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
            "library_ms": st["library_ms"],
            "checked": True,
            "measured_over": f"one gemma3-1b decode step (B=4, q8 cache): "
                             f"{g_step[name]} launches, per-shape times x "
                             "launches"})
    return line


def main() -> int:
    # deterministic cuBLAS for the resume check: read when cuBLAS starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import build
    mods = wrappers()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.monotonic()
    print(device_line(), flush=True)
    t0 = time.monotonic()
    build.build(verbose=True)
    emit(phase="build", seconds=time.monotonic() - t0,
         ptxas=ptxas_summary(build.build_dir()),
         torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0))
    tc_ptxas = ptxas_tc_instances(build.build_dir())
    emit(phase="ptxas", library="dequant_matmul_t", tc_instances=tc_ptxas)
    attn_ptxas = ptxas_attention_instances(build.build_dir())
    emit(phase="ptxas", library="decode_attention", instances=attn_ptxas)
    sass_check(build.build_dir())

    rows = kernel_phase(mods, dev, tc_ptxas, attn_ptxas)
    emit(phase="timing", kernel_phase_end_s=time.monotonic() - t_start)
    paper = serve_phase("paper-100m", dev, mods)
    deepseek = serve_phase("deepseek-7b", dev, mods, compare_steps=2)
    emit(phase="timing", dense_serve_end_s=time.monotonic() - t_start)
    gemma = gemma3_phase(dev, mods)
    emit(phase="timing", gemma3_end_s=time.monotonic() - t_start)
    alloc_runs, tf_rows = allocation_phase(dev, mods, tc_ptxas)
    for name, rs in tf_rows.items():
        rows[name] += rs
    emit(phase="timing", allocation_end_s=time.monotonic() - t_start)
    train_runs = train_phase(dev, mods)
    emit(phase="timing", train_end_s=time.monotonic() - t_start)

    line = summary(rows, [paper, deepseek, *gemma, *alloc_runs, *train_runs])
    emit(phase="timing", total_s=time.monotonic() - t_start)
    emit(kernels=line)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
