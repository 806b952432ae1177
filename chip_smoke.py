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
   case; the MoE shapes of phase 9), each called twice with bitwise-equal
   results, with its tile width, K splits, registers and blocks per SM;
   ``dequant_matmul_t`` at gemma3-1b's tied unembed (262144 x 1152, M = 1, 4, 32, and 8-bit), each
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
   Each served engine of phases 3 and 4, dropped with the cycle collector
   off, must be freed at once: a weakref to it dead and the card's
   allocated bytes back within ``DROP_SLACK`` (4 MiB) of their level
   before its build (``check_dropped``).
4. serve deepseek-7b full, then internlm2-20b full (48 layers, d 6144, 48
   heads over 8 KV heads of 128, d_ff 16384, vocab 92544, untied; 10.6 GB
   packed, 337 ``dequant_matmul`` launches a step, weight and KV bytes by
   the reference's count): the same at kv_len 256, weights drawn and
   packed on the card one leaf at a time, with setup seconds and peak
   device bytes; the prefill step and the first decode step held to the
   CPU plain path on a second engine at full width and 4 layers serving
   the same requests (``DEEPSEEK_HOLD_LAYERS``, ``INTERNLM_HOLD_LAYERS``),
   and the served engine's own prefill step and first decode step
   replayed at full depth on the card's plain path (``plain_witness``: the
   kernels routed to their plain versions), by the same rule.
5. serve gemma3-1b full with a q8 KV cache (tied embeddings, 5:1 ring
   groups): 4 requests, then one 600-token prompt that wraps the local
   groups' 520-slot rings, held step by step to the same request served
   with full-length caches (no ring); launch counts of all four kernels,
   resident weight and KV bytes, card-vs-CPU logits on a second engine of
   6 layers (one 5:1 period: both cache groups) serving the same 4
   requests, every step (``GEMMA_HOLD_LAYERS``), and the full-depth
   witness of phase 4 on the 26-layer engine. Then the same 4
   requests with a q4 cache; a second q4 engine of 6 layers serves them
   too, and its prefill step and first three decode steps are held to the
   CPU plain path on the same q4 cache: the logits, and the codes and
   scales of each step's new k and v.
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
   within 5% of the CPU's on one T=256 sequence with the same labels (on a
   gemma3-1b of 6 layers at full width);
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
   Huffman codec and back. The trained paper-100m parameters also go
   through the entropy-coded checkpoint (``train.compressed_ckpt``: bytes
   beside f32 and packed, bits per parameter, the host codec's seconds; the
   embedding, unembedding and first 2 layers, ``CODEC_LAYERS``), and the
   loaded tree is served packed at that depth, held to the CPU plain
   path.
8. frontend (the serving front end) at gemma3-1b full, babsmax64:n4
   packed, q8 cache, kv_len 1024, 4 slots: a seeded 16-request workload
   (``serve.traffic``, a 128-token shared prefix on 60% of the requests)
   replayed with prefix reuse twice (equal signatures), without reuse (the
   greedy streams held to the reuse run's by the margin rule, one forked
   request's prefix K/V rows to its recomputed rows by the K/V witness
   rule), and with NaN logits injected on slot 1 (that request alone ends
   failed); ``launch.serve --traffic-replay`` with q8 and q4 caches; the
   fault drills (a corrupted scale refused at load, a step failure retried,
   the dense fallback, a retry after the cache write, a stall caught by the
   watchdog and the straggler monitor). Every replay outside the drill runs
   without the dense fallback and must launch all four kernels. Each
   timed replay's engine, under its ``Scheduler``, is dropped with them
   and held by ``check_dropped``.
9. moe (MoE serving) at qwen2-moe-a2.7b full (24 layers, d 2048, 60
   routed experts of 1408, top-4, 4 shared, vocab 151936, untied),
   babsmax64:n4 packed, seeded weights drawn and packed one leaf at a time
   (the f32 tree is 57.3 GB): 4 requests on a dense cache, then on a q8
   cache, kv_len 256, chunk 8 (both engines, dropped, held by
   ``check_dropped``). Every step launches ``dequant_matmul`` 241
   times, 72 of them over the expert stacks with the lead dim E = 60 (q8:
   also 24 ``block_quant_kv`` and 24 ``decode_attention_quant``); resident
   bytes against the shapes', peak device bytes, the dropped share of the
   dispatches per step, the profiled device-busy share, and the prefill
   step and first decode step held to the CPU plain path, each MoE call
   routed as the card routed (a routing witness counts the dispatches the
   CPU would have sent elsewhere). The kernel phase also
   holds ``dequant_matmul`` with the lead dim at qwen2-moe's (E = 60) and
   llama4-scout's (E = 16) expert shapes, M = 4, beside one ``torch.bmm``
   on the dequantised bf16 stack, and at qwen2-moe's 2-D projections. Each
   run's CPU hold is made on a second card engine of 2 of the 24 layers at
   full width (``MOE_HOLD_LAYERS``), served the same requests.
9b. llama4 at llama4-scout-17b-a16e full (48 layers, d 5120, 40 heads on 8
   KV heads of 128, 16 routed experts of 8192, top-1, 1 shared, vocab
   202048, untied: 107.77 B parameters, 431 GB in f32), babsmax64:n4
   packed in 57.3 GB. Each 128.85-GB f32 expert stack is drawn one layer
   slice at a time (``models.api.SlicedLeaf``); the build's peak device
   bytes stay under 70 GB. 4 requests on a dense cache, then on a q8
   cache: 481 ``dequant_matmul`` launches a step, 144 with the lead dim E
   = 16 (q8: also 48 ``block_quant_kv`` and 48 ``decode_attention_quant``).
   Each run's prefill step and first decode step are replayed at full
   depth on the card's plain path, routed as the card routed; the dense
   run is profiled and held to the CPU on a second engine of 2 layers
   (``LLAMA4_HOLD_LAYERS``). Then ``launch.serve`` serves it. The kernel
   phase times its 2-D projections and unembed, its KV write and its
   attention read (40 on 8 heads) at M = 4.
10. whisper (the encoder-decoder family) at whisper-large-v3 full (32
   encoder and 32 decoder layers, d 1280, 20 heads of 64, vocab 51866,
   1500 frames, tied), babsmax64:n4 packed, 4 slots, kv_len 256, chunk 8,
   dense and q8 self-attention caches: six requests of 8-token prompts and
   16 new tokens, three with seeded frames, one text-only in a slot whose
   predecessor had frames (its cross K/V rows must be exactly zero after
   admission), one repeating another's prompt and frames in another slot
   (the same tokens). Each admission with frames encodes on the card and
   projects the cross K/V: 256 ``dequant_matmul`` launches at M = 1500; a
   text-only one none. Each step launches ``dequant_matmul`` 256 times and
   ``dequant_matmul_t`` once (the tied 51866 x 1280 table, one half-split
   nibble tile), with q8 also 32 ``block_quant_kv`` and 32
   ``decode_attention_quant``. Held: one request's cross K/V against one
   CPU ``cross_prefill`` at full depth per layer, and the prefill step and
   first decode step against the CPU plain path at full depth fed the
   card's cross K/V; weight, KV and cross-K/V bytes against the
   reference's counts; a profiled run; then ``launch.serve --arch
   whisper-large-v3`` from the command line. The kernel phase also holds
   ``dequant_matmul`` at whisper's shapes for M = 4, 32 and 1500,
   ``dequant_matmul_t`` at (51866, 1280), ``block_quant`` at 20 heads of
   64 and ``decode_attention_quant`` at H = K = 20, hd 64, and at
   internvl2-26b's H = 48, K = 8, hd 128.
11. internvl (the VLM family) at internvl2-26b full (48 layers, d 6144, 48
   heads over 8 KV heads of 128, d_ff 16384, vocab 92553; 13.04 GB):
   packed with the embedding in byte codes and the unembed dense, served
   with a q8 cache (336 ``dequant_matmul``, 48 ``block_quant_kv`` and 48
   ``decode_attention_quant`` launches a step), and its ``apply`` over 256
   seeded patch tokens of width 3200 and a 64-token text (336
   ``dequant_matmul`` launches at M = 320); both held to the CPU plain path
   on a second engine at full width and 2 layers, and the served run to
   the full-depth witness of phase 4. The kernel phase holds
   ``dequant_matmul`` at the internlm2/internvl projections for M = 4, 32
   and 320.
12. rwkv6 (the attention-free recurrent family) at rwkv6-1.6b full (24
   layers, d 2048, 32 heads of 64, d_ff 7168, vocab 65536, untied),
   babsmax64:n4 packed, seeded weights drawn and packed one leaf at a time
   as the family's ``init`` makes them, 4 slots, kv_len 256, chunk 8: six
   requests of 8-token prompts and 16 new tokens, two of them in slots
   another request left; 241 ``dequant_matmul`` launches a step and no
   other kernel; the reused slot's tokens against a fresh engine's, the
   whole run repeated bit for bit, weight and state bytes, a profile, the
   prefill step and first decode step held to the CPU plain path at full
   depth, then one 128-token prompt (``RECURRENT_LONG_PROMPT``) at prefill
   chunk 8 (the block-parallel WKV form) held position by position to
   chunk 1 (the scan) by the margin rule, and ``launch.serve --arch
   rwkv6-1.6b`` from the command line.
13. zamba2 (the hybrid family) at zamba2-2.7b full (54 Mamba-2 layers in 9
   groups of 6, d 2560, d_inner 5120, state 64, a shared block of 32 heads
   of 80 applied 9 times, d_ff 10240, vocab 32000): the same, with a dense
   and a q8 shared-attention cache (118 ``dequant_matmul`` launches a step,
   with q8 also 9 ``block_quant_kv`` and 9 ``decode_attention_quant``);
   the q8 run's hold reads the card's own cache with the K/V witness; the
   dense f32 ``in_proj`` (2560 x 10448, no multiple of 64: the plan leaves
   it dense) timed as the layer calls it, 54 a step; ``launch.serve --arch
   zamba2-2.7b --kv-format q8``. The kernel phase also holds
   ``dequant_matmul`` at both families' shapes (N = 64 and K = 64 among
   them), ``block_quant`` at head dim 80 and ``decode_attention_quant`` at
   32 heads of 80.
14. multidevice (the multi-device layer; it and phase 15 run as the last
   card work of phase 16, while its CPU worker finishes) on an NCCL world
   of one rank on the card (one GPU; more ranks wait for a machine with
   more):
   ``serve.context_parallel.cp_decode_attention`` at gemma3-1b's long_500k
   global layer (S = 524,288, 4 heads over 1 KV head of 256, bf16) against
   ``layers.decode_attention`` (within 1e-2 of max|out|), and 16 slices of
   32k combined by ``combine_partials`` against one shard in f32 (within
   1e-5), at the last position and at one in the first slice (15 slices
   fully masked); ``layers.moe_block_ep`` at qwen2-moe-a2.7b's full-width
   block (60 experts of 1408, top-4, 4 shared; B = 4, T = 8, dense bf16)
   equal to ``_moe_block_local``; the same block packed under
   ``set_ep_mesh`` takes the local path: 3 lead-dim ``dequant_matmul``
   launches. On a line of its own: 3 steps of 8-bit Adam on gemma3-1b's
   (1152, 6912) MLP leaf as DTensors, bit for bit the plain update (params,
   codes, scales), and that state saved and restored with
   ``restore_checkpoint(shardings=)`` onto another layout, bit for bit once
   gathered.
15. examples: ``examples/quickstart_torch.py``, ``format_design_torch.py``
   and ``train_quantise_serve_torch.py`` through their ``main(["--device",
   "cuda"])``, held to the reference's numbers (pinned at full precision
   below): bits/param within 1e-9 and R within 1e-3 relative, ν, the exact
   packed round trip and the codebook; the §4 pipeline at its defaults with
   the paper's two claims (allocated KL below flat, KL after QAT below the
   int3 direct cast), its served bits/param, 31 ``dequant_matmul``
   launches a step of its babsmax128:t4 engine (a Student-t codebook,
   128-wide blocks, held against the plain version in the kernel phase at
   paper-100m small's shapes) and its served steps held to the CPU plain
   path.
16. family_train (training, QAT and the weight Fisher of the other
   families, at full width, seeded weights): (a) 3 CE steps of B = 1, T =
   256 under deterministic algorithms for whisper-large-v3 and rwkv6-1.6b
   through ``launch.train --variant full`` and for zamba2-2.7b (36 of 54
   layers), qwen2-moe-a2.7b (2) and internvl2-26b (1 layer) through
   ``train.loop.train``, the depths 80 GB allows (``FAMILY_TRAIN``): s a
   step, peak device bytes, the ops without a deterministic CUDA form,
   finite losses; (b) qwen2-moe at 1 layer, its state after step 2 copied
   to the host and back, step 3 bit for bit (determinism and the state's
   round trip through host memory; not the checkpoint file, whose 14.3 GB
   took 80-89 s); at a hold depth (2 layers, whisper 2 + 2, zamba2 one
   group of 6 and its shared block), in f32 with the same weights and batch on the card and the CPU: (c) one CE
   ``make_train_step`` (loss and grad_norm within 1e-4, every leaf's
   gradient within 1e-3 relative L2), (d) one babsmax64:int4 distillation
   step (KL and grad_norm within 1e-3), (e) the Fisher of one T = 256
   sequence with the same labels (each tensor's mean within 5%), each
   held to the CPU for every family (``cpu_holds``); the Eq. 5
   allocation at 4.0 bits from the card's Fisher packed babsmax64 (widths
   2-8 per tensor, every layer and expert slice of each packed leaf through
   ``dequant_matmul`` in bf16 and f32 held to its plain version) and one
   packed ``apply`` against the dense ``apply`` over the dequantised
   weights in f32 (the logits rule, and the KL within 5%) and in the
   served bf16 (the KL within 5%; its logits reading beside the bf16
   floor, the dense ``apply`` in bf16 against f32); (f) for whisper and zamba2
   the KV Fisher of ``--kv-format auto`` on both devices (within 5%), then
   ``launch.serve --kv-format auto`` at full depth under half the all-f32
   cache, which must choose the CPU statistics' formats and launch
   ``block_quant`` and ``decode_attention_quant``. The CPU's side runs on
   a worker thread while the card trains.

CPU replays (``replay_on_cpu``) dequantise each packed weight once
(``dequant_memo``), with the same bits as dequantising it at every step.
17. the kernels summary line, then ``{"ok": true, "device": ...}``.

Every count of kernel launches is set to 0 just before a serve run and read
just after it. Each profile phase also holds every ``decode_attention_quant``
call of its run to one device kernel. Any failed check raises and the
script exits non-zero without the last line. It exits non-zero at once
when no CUDA device is present.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import importlib
import importlib.util
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
import weakref
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
MOE_ARCH = "qwen2-moe-a2.7b"
# qwen2-moe-a2.7b's 2-D projections (timed at M = 4, the decode rows) and
# the expert stacks of both MoE configs through the lead dim (M = 4, the
# capacity of a decode or an 8-token prefill step of 4 slots)
MOE_PROJECTIONS = [((2048, 2048), 96, "wq+wk+wv+wo"),
                   ((2048, 5632), 48, "ws_gate+ws_up"),
                   ((5632, 2048), 24, "ws_down"),
                   ((2048, 151936), 1, "unembed")]
EXPERT_CASES = [  # (model, E, K, N, launches per step, weights)
    (MOE_ARCH, 60, 2048, 1408, 48, "we_gate+we_up"),
    (MOE_ARCH, 60, 1408, 2048, 24, "we_down"),
    ("llama4-scout-17b-a16e", 16, 5120, 8192, 96, "we_gate+we_up"),
    ("llama4-scout-17b-a16e", 16, 8192, 5120, 48, "we_down"),
]
# the design's launch shape at qwen2-moe's expert stacks (M = 4): gate/up 22
# column tiles of 64 x 60 experts, down 32 x 60 over 11 chunks of its
# whole-K (1408) nibble tile; one K split each
EXPERT_GEOMETRY = {(60, 2048, 1408): dict(vec=4, splits=1, blocks=1320,
                                          chunks=16),
                   (60, 1408, 2048): dict(vec=4, splits=1, blocks=1920,
                                          chunks=11)}
# launches per decode step of each kernel (the design's numbers): gemma3-1b
# runs 7 projections per layer, the tied unembed once, block_quant once per
# layer (k and v in one block_quant_kv launch) and decode_attention_quant
# once per layer (26 layers)
LAUNCHES_PER_STEP = {
    "paper-100m": {"dequant_matmul": 85},
    "deepseek-7b": {"dequant_matmul": 211},
    "gemma3-1b": {"dequant_matmul": 182, "dequant_matmul_t": 1,
                  "block_quant": 26, "decode_attention_quant": 26},
    # 24 layers x (4 attention + 3 expert stacks + 3 shared) + the unembed
    MOE_ARCH: {"dequant_matmul": 241},
    MOE_ARCH + " q8": {"dequant_matmul": 241, "block_quant": 24,
                       "decode_attention_quant": 24},
}
MOE_LEAD_LAUNCHES = 72            # of them with the expert lead dim E = 60
# each run's CPU hold: a second engine of this many layers at full width
MOE_HOLD_LAYERS = 2
LAUNCHES_PER_STEP[MOE_ARCH + " hold"] = {
    "dequant_matmul": 10 * MOE_HOLD_LAYERS + 1}
LAUNCHES_PER_STEP[MOE_ARCH + " q8 hold"] = {
    "dequant_matmul": 10 * MOE_HOLD_LAYERS + 1,
    "block_quant": MOE_HOLD_LAYERS, "decode_attention_quant": MOE_HOLD_LAYERS}
WHISPER_ARCH = "whisper-large-v3"
# whisper's (K, N) with launches per decode step and per admission with
# frames (at M = enc_seq = 1500); the tied (V, D) table
WHISPER_PROJECTIONS = [
    ((1280, 1280), 192, 192, "self wq+wk+wv+wo, cross wq+wo (admission: "
                             "encoder wq+wk+wv+wo, cross wk+wv)"),
    ((1280, 5120), 32, 32, "w_in"), ((5120, 1280), 32, 32, "w_out")]
WHISPER_TABLE = (51866, 1280)
WHISPER_ENC_SEQ = 1500
WHISPER_ADMIT_LAUNCHES = 256
WHISPER_COMPARE_STEPS = 2         # the prefill step and the first decode step
# 32 decoder layers x (4 self + 2 cross + 2 MLP) + the tied unembed; q8 adds
# one paired KV write and one attention read a layer
LAUNCHES_PER_STEP[WHISPER_ARCH] = {"dequant_matmul": 256,
                                   "dequant_matmul_t": 1}
LAUNCHES_PER_STEP[WHISPER_ARCH + " q8"] = {
    "dequant_matmul": 256, "dequant_matmul_t": 1, "block_quant": 32,
    "decode_attention_quant": 32}
INTERNVL_ARCH = "internvl2-26b"
INTERNLM_ARCH = "internlm2-20b"
# internlm2-20b and internvl2-26b's backbone: (K, N) of each projection with
# launches per decode step at 48 layers (internvl's unembed stays dense: its
# vocab 92553 is odd); internvl's apply runs the layers' four at M = 320
INTERNLM_PROJECTIONS = [((6144, 6144), 96, "wq+wo"),
                        ((6144, 1024), 96, "wk+wv"),
                        ((6144, 16384), 96, "w_gate+w_up"),
                        ((16384, 6144), 48, "w_down"),
                        ((6144, 92544), 1, "unembed (internlm2-20b)")]
INTERNVL_APPLY_M = 256 + 64       # patch tokens + text tokens
# both 48-layer models are served whole; their CPU holds run on a second
# engine at full width and this many layers (a full-depth CPU replay of a
# 20B model does not fit the script's time)
INTERNVL_LAYERS = 2
INTERNLM_HOLD_LAYERS = 4
LAUNCHES_PER_STEP[INTERNLM_ARCH] = {"dequant_matmul": 7 * 48 + 1}
LAUNCHES_PER_STEP[INTERNLM_ARCH + " hold"] = {
    "dequant_matmul": 7 * INTERNLM_HOLD_LAYERS + 1}
LAUNCHES_PER_STEP[INTERNVL_ARCH + " q8"] = {
    "dequant_matmul": 7 * 48, "block_quant": 48,
    "decode_attention_quant": 48}
LAUNCHES_PER_STEP[INTERNVL_ARCH + " hold"] = {
    "dequant_matmul": 7 * INTERNVL_LAYERS, "block_quant": INTERNVL_LAYERS,
    "decode_attention_quant": INTERNVL_LAYERS}
# CPU holds cut in depth to make room in the script's time: deepseek-7b's
# (30 layers, ~50 s of CPU) and gemma3-1b q8's (26 layers, every step, ~80
# s) run on a second engine of this many layers at full width; gemma3's 6
# are one period of its 5:1 local:global pattern, so both cache groups are
# held
DEEPSEEK_HOLD_LAYERS = 4
GEMMA_HOLD_LAYERS = 6
LAUNCHES_PER_STEP["deepseek-7b hold"] = {
    "dequant_matmul": 7 * DEEPSEEK_HOLD_LAYERS + 1}
LAUNCHES_PER_STEP["gemma3-1b hold"] = {
    "dequant_matmul": 7 * GEMMA_HOLD_LAYERS, "dequant_matmul_t": 1,
    "block_quant": GEMMA_HOLD_LAYERS,
    "decode_attention_quant": GEMMA_HOLD_LAYERS}
# the entropy-coded checkpoint runs on the trained paper-100m's embedding,
# unembedding and first CODEC_LAYERS of its 12 layers (the host codec took
# ~95 s over all 12, 76 s over 4), served at that depth
CODEC_LAYERS = 2
LAUNCHES_PER_STEP["paper-100m codec"] = {
    "dequant_matmul": 7 * CODEC_LAYERS + 1}
# the train_quantise_serve example serves paper-100m small (6 layers, d 256,
# d_ff 704, vocab 2048, untied) packed babsmax128:t4: w_gate and w_up do not
# pack (704 is no multiple of the 128-wide block) and are served dense, so
# a step launches wq, wk, wv, wo, w_down a layer and the unembed
EXAMPLE_SPEC = "babsmax128:t4"
EXAMPLE_PROJECTIONS = [((256, 256), 12, "wq+wo"), ((256, 128), 12, "wk+wv"),
                       ((704, 256), 6, "w_down"), ((256, 2048), 1, "unembed")]
EXAMPLE_UNPACKED = ["['layers']['w_gate']", "['layers']['w_up']"]
LAUNCHES_PER_STEP["paper-100m-small"] = {"dequant_matmul": 5 * 6 + 1}
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
    MOE_ARCH: dict(total=7_615_734_528, codes=7_156_269_056,
                   scales=447_266_816, codebooks=768, dense=12_197_888),
    # the reference's packing rules on abstract arrays (tests/
    # test_torch_whisper.py, test_torch_internvl.py): 17 packed tensors,
    # the tied table once; internvl's embedding in byte codes (odd vocab),
    # its unembed and projector dense
    WHISPER_ARCH: dict(total=815_977_808, codes=767_197_440,
                       scales=47_949_840, codebooks=1_088, dense=829_440),
    INTERNVL_ARCH + " hold": dict(total=3_505_222_336, codes=958_715_904,
                                  scales=42_149_568, codebooks=512,
                                  dense=2_504_356_352),
}
RWKV_ARCH = "rwkv6-1.6b"
ZAMBA_ARCH = "zamba2-2.7b"
# (K, N) of each family's packed projections with launches per decode step
RWKV_PROJECTIONS = [((2048, 2048), 144, "wr+wk+wv+wg+wo+wcr"),
                    ((2048, 64), 24, "w_lora_a"), ((64, 2048), 24,
                                                   "w_lora_b"),
                    ((2048, 7168), 24, "wck"), ((7168, 2048), 24, "wcv"),
                    ((2048, 65536), 1, "unembed")]
ZAMBA_PROJECTIONS = [((5120, 2560), 54, "out_proj (lead dims 9 x 6)"),
                     ((2560, 2560), 36, "shared wq+wk+wv+wo (9 points)"),
                     ((2560, 10240), 18, "shared w_gate+w_up"),
                     ((10240, 2560), 9, "shared w_down"),
                     ((2560, 32000), 1, "unembed")]
# zamba2's dense f32 in_proj (2560 x 10448: no multiple of 64, left dense
# by the plan as the reference leaves it): einsum on w.to(bf16), 54 a step
ZAMBA_IN_PROJ = (2560, 10448, 54)
# 24 layers x 10 projections + the unembed; zamba2: 54 out_proj + 9 x 7
# shared + the unembed, q8 adds one paired KV write and one attention read
# at each of the 9 application points of the shared block
LAUNCHES_PER_STEP[RWKV_ARCH] = {"dequant_matmul": 241}
LAUNCHES_PER_STEP[ZAMBA_ARCH] = {"dequant_matmul": 118}
LAUNCHES_PER_STEP[ZAMBA_ARCH + " q8"] = {
    "dequant_matmul": 118, "block_quant": 9, "decode_attention_quant": 9}
# the reference's packing rules on abstract arrays (tests/
# test_torch_rwkv6.py, test_torch_zamba2.py): rwkv6 12 packed tensors;
# zamba2 10, and its in_proj dense f32 (5,777,571,840 bytes of the dense)
WEIGHT_BYTES[RWKV_ARCH] = dict(total=843_522_816, codes=791_674_880,
                               scales=49_479_680, codebooks=768,
                               dense=2_367_488)
WEIGHT_BYTES[ZAMBA_ARCH] = dict(total=6_302_360_832, codes=488_243_200,
                                scales=30_515_200, codebooks=640,
                                dense=5_783_601_792)
# decode state of 4 slots, kv_len 256 + chunk 8 (tests hold these to the
# reference's specs): rwkv6 has no KV (token-shift inputs in bf16, WKV
# matrices in f32, pos); zamba2's shared-attention KV, dense and q8, and
# its conv (bf16) + SSM (f32) state + pos
RECURRENT_KV_BYTES = {RWKV_ARCH: {"dense": 0},
                      ZAMBA_ARCH: {"dense": 97_320_960, "q8": 51_093_504}}
RECURRENT_OTHER_BYTES = {RWKV_ARCH: 51_118_096,
                         ZAMBA_ARCH: 6_801_408 + 283_115_520 + 16}
# the long-state check's prompt: 128 tokens, 16 chunks of 8 (at 256 its
# 263 scan steps took 28 and 38 s of the host-bound rwkv6 and zamba2 phases)
RECURRENT_LONG_PROMPT = 128
# 4 slots x (256 + 8) slots a layer; the cross K/V, 4 slots x 1500 frames
# x 32 layers x 1280 x 2 (k and v) in bf16, and pos
WHISPER_KV_BYTES = {"dense": 173_015_040, "q8": 91_914_240}
WHISPER_OTHER_BYTES = 983_040_000 + 16
INTERNVL_KV_BYTES = 107_053_056              # q8, 48 layers
INTERNVL_HOLD_KV_BYTES = 4_460_544           # q8, 2 layers
INTERNLM_KV_BYTES = 207_618_048              # dense, 48 layers
# the reference's packing rules on abstract arrays (tests/
# test_torch_internvl.py): internlm2-20b packs all nine tensors (vocab 92544
# = 64 x 1446); internvl2-26b at 48 layers and at its hold's 2
WEIGHT_BYTES[INTERNLM_ARCH] = dict(total=10_553_303_616,
                                   codes=9_930_276_864, scales=620_642_304,
                                   codebooks=576, dense=2_383_872)
WEIGHT_BYTES[INTERNVL_ARCH] = dict(total=13_039_825_600,
                                   codes=9_930_332_160, scales=602_875_584,
                                   codebooks=512, dense=2_506_617_344)
LLAMA4_ARCH = "llama4-scout-17b-a16e"
# llama4-scout-17b-a16e's 2-D projections with launches per decode step at
# 48 layers (timed at M = 4; its expert stacks are in EXPERT_CASES): the
# untied unembed's N = 202048 is a multiple of 64, not of 128
LLAMA4_PROJECTIONS = [((5120, 5120), 96, "wq+wo"),
                      ((5120, 1024), 96, "wk+wv"),
                      ((5120, 8192), 96, "ws_gate+ws_up"),
                      ((8192, 5120), 48, "ws_down"),
                      ((5120, 202048), 1, "unembed")]
# 48 layers x (4 attention + 3 expert stacks + 3 shared) + the unembed, 3 a
# layer over the expert stacks with the lead dim E = 16; q8 adds one paired
# KV write and one attention read a layer (40 heads on 8 KV heads of 128)
LLAMA4_LAYERS = 48
LLAMA4_LEAD_LAUNCHES = 3 * LLAMA4_LAYERS
LAUNCHES_PER_STEP[LLAMA4_ARCH] = {"dequant_matmul": 10 * LLAMA4_LAYERS + 1}
LAUNCHES_PER_STEP[LLAMA4_ARCH + " q8"] = {
    "dequant_matmul": 10 * LLAMA4_LAYERS + 1, "block_quant": LLAMA4_LAYERS,
    "decode_attention_quant": LLAMA4_LAYERS}
# the dense run's CPU hold: a second engine at full width and this many
# layers (its CPU side dequantises 3.24 GB of codes and two 1.03-B-parameter
# tables; every layer more adds 1.1 GB of codes); at 1 layer the routing
# witness saw 36 dispatches, so one flip read 2.78% against its 5% limit
LLAMA4_HOLD_LAYERS = 2
LAUNCHES_PER_STEP[LLAMA4_ARCH + " hold"] = {
    "dequant_matmul": 10 * LLAMA4_HOLD_LAYERS + 1}
# the reference's packing rules on abstract arrays (tests/
# test_torch_llama4.py): 12 packed tensors, the router dense
WEIGHT_BYTES[LLAMA4_ARCH] = dict(total=57_268_101_888,
                                 codes=53_882_716_160,
                                 scales=3_367_669_760, codebooks=768,
                                 dense=17_715_200)
WEIGHT_BYTES[LLAMA4_ARCH + " hold"] = dict(total=3_439_534_848,
                                           codes=3_236_495_360,
                                           scales=202_280_960,
                                           codebooks=768, dense=757_760)
LLAMA4_KV_BYTES = {"dense": 207_618_048, "q8": 107_053_056}
# the build's peak device bytes: 57.3 GB packed, one 2.68-GB f32 slice of
# an expert stack (each whole stack is 128.85 GB) and its temporaries
LLAMA4_SETUP_PEAK_MAX = 70e9


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


def release():
    """Give the caching allocator's free blocks back to the card. A dropped
    engine is freed on ``del`` (nothing it holds refers back to it), so no
    cycle collector is run first."""
    torch.cuda.empty_cache()


# bytes a dropped engine may leave allocated above the level before its
# build: at most 753,664 B were left on an NVIDIA H100 80GB HBM3 (the kernel
# phase having run first), while the smallest engine held (the front end's)
# allocates 32 MB, so an engine kept alive shows
DROP_SLACK = 4 * 2**20


@contextlib.contextmanager
def collector_off():
    """The cycle collector disabled while the context lasts, so that what
    a ``del`` frees inside it is freed by reference counts alone."""
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def check_dropped(what, gone, start, dev):
    """After the last references to engines were dropped inside
    ``collector_off``: each engine (``gone``, weakrefs to them) is dead and
    the card's allocated bytes are back within ``DROP_SLACK`` of
    ``start``, their level before the engines were built. Returns the
    readings."""
    torch.cuda.synchronize(dev)
    above = torch.cuda.memory_allocated(dev) - start
    check(all(r() is None for r in gone),
          f"{what}: a dropped engine is still referenced")
    check(above <= DROP_SLACK, f"{what}: {above:,} B still allocated above "
          f"the level before the build after the engine was dropped")
    return dict(engine_freed=True, bytes_above_start=above)


def wrappers():
    """Each kernel's wrapper module, the holder of its launch count."""
    return {name: importlib.import_module(k["module"])
            for name, k in KERNELS.items()}


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version


def matmul_case(mods, dev, gen, cb, flush, K, N, M, bits, lead=None,
                block=64):
    from repro_torch.kernels.dequant_matmul import ref
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
        vec=geo.vec, splits=geo.splits, chunks=geo.chunks,
        blocks=geo.tiles * geo.splits * E, **mod.mma_info(bits, M, geo.vec),
        kernel_ms=time_ms(lambda: kern(x, codes, scales, cb, block, bits),
                          flush),
        plain_ms=time_ms(lambda: ref.dequant_matmul_ref(
            x, codes, scales, cb, block, bits), flush),
        library_ms=time_ms((lambda: torch.matmul(x, w)) if lead is None
                           else (lambda: torch.bmm(x, w)), flush),
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


# (T, S, first query position of each of the 4 rows, (H, K, hd)) of the
# linear caches of whisper-large-v3 (MHA, 20 heads of 64) and internvl2-26b
# (48 heads over 8 KV heads of 128), kv_len 256 + chunk 8
FAMILY_ATTN_CASES = [
    (1, 264, [200, 17, 100, 255], (20, 20, 64), WHISPER_ARCH),
    (8, 264, [200, 8, 100, 248], (20, 20, 64), WHISPER_ARCH),
    (1, 264, [200, 17, 100, 255], (48, 8, 128), INTERNVL_ARCH),
]


def attention_inputs(dev, gen, T, S, starts, fmt, heads=(4, 1, 256)):
    """An attention read of B=4 rows and ``heads`` (H, K, hd), gemma3-1b's
    by default: bf16 q, K/V codes written by the port's own quantise_kv,
    positions from ``starts`` (the first query position of each row).
    Returns the kernel's positional arguments and the code bits."""
    from repro_torch.models.layers import quantise_kv
    from repro_torch.serve.cache import kv_bits, kv_codebook
    B, (H, K, hd) = 4, heads
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
                   attn_ptxas, heads=(4, 1, 256)):
    """An attention read (``attention_inputs``: gemma3-1b's, or ``heads``),
    called twice with bitwise-equal results, with the geometry it ran and
    its instance's ptxas figures. Library: scaled_dot_product_attention on
    K/V dequantised to bf16 beforehand, under the same boolean mask."""
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_quant_ref, dequant_kv_ref)
    from repro_torch.models.layers import attention_mask
    args, bits = attention_inputs(dev, gen, T, S, starts, fmt, heads)
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
        heads=[H, K, hd], visible_slots=slots, bytes=nbytes, flops=flops,
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
    for (K, N), per_step, names in MOE_PROJECTIONS:
        record("dequant_matmul", matmul_case(
            mods, dev, gen, cb4, flush, K, N, 4, 4), model=MOE_ARCH,
            weights=names, launches_per_step=per_step)
    for model, E, K, N, per_step, names in EXPERT_CASES:
        r = matmul_case(mods, dev, gen, cb4, flush, K, N, 4, 4, lead=E)
        want = EXPERT_GEOMETRY.get((E, K, N))
        check(want is None or {k: r[k] for k in want} == want,
              f"dequant_matmul lead {E} {K}x{N}: geometry {r} != {want}")
        record("dequant_matmul", r, model=model,
               weights=f"{names} (lead dim {E})", launches_per_step=per_step)
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
    family_rows(mods, dev, gen, cb4, cb8, flush, tc_ptxas, attn_ptxas,
                record)
    recurrent_rows(mods, dev, gen, cb4, flush, attn_ptxas, record)
    internlm_rows(mods, dev, gen, cb4, flush, record)
    llama4_rows(mods, dev, gen, cb4, flush, attn_ptxas, record)
    example_rows(mods, dev, gen, flush, record)
    del flush
    torch.cuda.empty_cache()
    return rows


def family_rows(mods, dev, gen, cb4, cb8, flush, tc_ptxas, attn_ptxas,
                record):
    """The kernels at the shapes of phases 10 and 11: ``dequant_matmul`` at
    whisper's projections for M = 4, 32 (decode, prefill) and 1500 (the
    encoder and the cross K/V at admission); ``dequant_matmul_t`` at its
    tied (51866, 1280) table, one half-split nibble tile of 25933 byte
    rows, M = 1, 4, 32 at 4 and 8 bits; ``block_quant`` at 20 heads of 64
    (4 and 32 tokens of 4 slots); ``decode_attention_quant`` at whisper's
    and internvl's heads, q8 and q4 (internvl q8)."""
    for (K, N), per_step, per_admit, names in WHISPER_PROJECTIONS:
        for M in (4, 32, WHISPER_ENC_SEQ):
            record("dequant_matmul", matmul_case(
                mods, dev, gen, cb4, flush, K, N, M, 4), model=WHISPER_ARCH,
                weights=names, launches_per_step=per_step,
                launches_per_admission=per_admit)
    V, D = WHISPER_TABLE
    for bits in (4, 8):
        for M in (1, 4, 32):
            record("dequant_matmul_t", matmul_t_case(
                mods, dev, gen, cb4 if bits == 4 else cb8, flush, V, D, M,
                bits, tc_ptxas), model=WHISPER_ARCH, weights="tied unembed")
    for fmt in ("q8", "q4"):
        for n in (80, 640):
            record("block_quant", block_quant_case(
                mods, dev, gen, flush, n, 64, fmt), model=WHISPER_ARCH)
        for T, S, starts, heads, model in FAMILY_ATTN_CASES:
            if model == INTERNVL_ARCH and fmt == "q4":
                continue
            record("decode_attention_quant", attention_case(
                mods, dev, gen, flush, T, S, False, 0, starts, fmt,
                attn_ptxas, heads), model=model)


def internlm_rows(mods, dev, gen, cb4, flush, record):
    """``dequant_matmul`` at internlm2-20b's packed projections (internvl2-
    26b's backbone) for M = 4 and 32 (decode, prefill), and the layers'
    four at M = 320, internvl's ``apply`` over 256 patches and 64 text
    tokens."""
    for (K, N), per_step, names in INTERNLM_PROJECTIONS:
        for M in (4, 32):
            record("dequant_matmul", matmul_case(
                mods, dev, gen, cb4, flush, K, N, M, 4), model=INTERNLM_ARCH,
                weights=names, launches_per_step=per_step)
        if "unembed" not in names:
            record("dequant_matmul", matmul_case(
                mods, dev, gen, cb4, flush, K, N, INTERNVL_APPLY_M, 4),
                model=INTERNVL_ARCH, weights=names,
                launches_per_apply=per_step)


def llama4_rows(mods, dev, gen, cb4, flush, attn_ptxas, record):
    """The kernels at llama4-scout-17b-a16e's shapes, M = 4 (a decode step
    of 4 slots): ``dequant_matmul`` at its 2-D projections and its untied
    (5120, 202048) unembed (the expert stacks: ``EXPERT_CASES``);
    ``block_quant`` at 8 KV heads of 128 (the paired write of a decode
    step, 32 rows) and ``decode_attention_quant`` at 40 q heads on 8 KV
    heads of 128 (T = 1 and 8), q8."""
    for (K, N), per_step, names in LLAMA4_PROJECTIONS:
        record("dequant_matmul", matmul_case(
            mods, dev, gen, cb4, flush, K, N, 4, 4), model=LLAMA4_ARCH,
            weights=names, launches_per_step=per_step)
    record("block_quant", block_quant_case(mods, dev, gen, flush, 4 * 8,
                                           128, "q8"), model=LLAMA4_ARCH)
    for T, starts in ((1, [200, 17, 100, 255]), (8, [200, 8, 100, 248])):
        record("decode_attention_quant", attention_case(
            mods, dev, gen, flush, T, 264, False, 0, starts, "q8",
            attn_ptxas, (40, 8, 128)), model=LLAMA4_ARCH)


def example_rows(mods, dev, gen, flush, record):
    """``dequant_matmul`` as ``examples/train_quantise_serve_torch.py``
    serves it: paper-100m small's packed projections under babsmax128:t4
    (a 16-point Student-t codebook, 128-wide scale blocks), M = 2 and 8 (2
    slots: decode, and a prefill step of 4-token prompts)."""
    from repro_torch.core.registry import parse_format
    fmt = parse_format(EXAMPLE_SPEC)
    cb = fmt.element.torch_codepoints(dev)
    for (K, N), per_step, names in EXAMPLE_PROJECTIONS:
        for M in (2, 8):
            record("dequant_matmul", matmul_case(
                mods, dev, gen, cb, flush, K, N, M, 4,
                block=fmt.scaling.block_size), model="paper-100m-small",
                spec=EXAMPLE_SPEC, weights=names, launches_per_step=per_step)


def recurrent_rows(mods, dev, gen, cb4, flush, attn_ptxas, record):
    """The kernels at the shapes of phases 12 and 13: ``dequant_matmul`` at
    rwkv6-1.6b's and zamba2-2.7b's packed projections for M = 4 and 32
    (decode, prefill; rwkv6's decay LoRA pair at N = 64 and K = 64, a
    nibble tile of 64); ``block_quant`` at zamba2's head dim of 80 (32
    heads of 4 slots, decode and prefill); ``decode_attention_quant`` at
    32 heads over 32 KV heads of 80, T = 1 and 8, q8 and q4."""
    for model, projs in ((RWKV_ARCH, RWKV_PROJECTIONS),
                         (ZAMBA_ARCH, ZAMBA_PROJECTIONS)):
        for (K, N), per_step, names in projs:
            for M in (4, 32):
                record("dequant_matmul", matmul_case(
                    mods, dev, gen, cb4, flush, K, N, M, 4), model=model,
                    weights=names, launches_per_step=per_step)
    for fmt in ("q8", "q4"):
        for n in (4 * 32, 32 * 32):
            record("block_quant", block_quant_case(
                mods, dev, gen, flush, n, 80, fmt), model=ZAMBA_ARCH)
        for T, starts in ((1, [200, 17, 100, 255]), (8, [200, 8, 100, 248])):
            record("decode_attention_quant", attention_case(
                mods, dev, gen, flush, T, 264, False, 0, starts, fmt,
                attn_ptxas, (32, 32, 80)), model=ZAMBA_ARCH)


# ---------------------------------------------------------------------------
# Phases 3 to 5: serving


def build_engine(arch, dev, seed=0, kv_len=256, kv_format="", **cfg_kw):
    """``arch`` full (``cfg_kw`` may cut its depth) at seed ``seed``, served
    packed (``SPEC``) on 4 slots with prefill chunk 8 by the port's
    builder, which draws and packs one leaf at a time
    (``build_packed_engine`` over ``family_leaves``, each leaf as the
    family's ``init`` makes it): deepseek-7b's f32 tree is about 28 GB,
    qwen2-moe-a2.7b's 57.3 GB. Returns (engine, seconds)."""
    from repro_torch import configs
    from repro_torch.models.api import family_leaves
    from repro_torch.serve.engine import build_packed_engine
    cfg = configs.get_config(arch, "full").replace(kv_format=kv_format,
                                                   **cfg_kw)
    t0 = time.monotonic()
    eng, _ = build_packed_engine(
        cfg, SPEC, family_leaves(cfg, seed=seed, device=dev),
        batch_slots=4, kv_len=kv_len, prefill_chunk=8, device=dev)
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
    the host), for every step until n decode steps have been recorded; with
    ``snapshot`` (state keys), those entries of the first step's state as
    it found them (to the host: whisper's cross K/V)."""

    def __init__(self, step, keep_logits, cache_decodes=0, snapshot=()):
        self.step = step
        self.keep_logits = keep_logits
        self.cache_decodes = cache_decodes
        self.snapshot = snapshot
        self.decodes = 0
        self.records = []

    def __call__(self, params, state, batch, cfg):
        rec = {"T": int(batch["tokens"].shape[1])}
        if self.keep_logits:
            rec.update(pos=state["pos"].cpu(),
                       batch={k: v.cpu() for k, v in batch.items()})
        if self.snapshot and not self.records:
            rec["state_in"] = {k: state[k].to("cpu", copy=True)
                               for k in self.snapshot}
        t0 = time.monotonic()
        logits, state = self.step(params, state, batch, cfg)
        torch.cuda.synchronize()
        rec["s"] = time.monotonic() - t0
        if self.keep_logits:
            rec["logits"] = logits.float().cpu()
        if self.decodes < self.cache_decodes:
            rec["cache"] = {k: v.to("cpu", copy=True)
                            for k, v in state.items() if k != "pos"}
        self.decodes += rec["T"] == 1
        self.records.append(rec)
        return logits, state


def serve(eng, mods, requests, keep_logits, warm=True, cache_decodes=0,
          order=None, snapshot=()):
    """Serve ``requests`` ((prompt, max_new) pairs, or (prompt, max_new,
    frames) triples; rid = index) after an optional warm-up, submitted in
    ``order`` (rids; default in turn), with every kernel's launch count set
    to 0 just before the run and read just after it (``StepRecorder``
    records the steps)."""
    from repro_torch.serve.engine import Request
    if warm:
        eng.submit(Request(prompt=requests[0][0], max_new_tokens=2, rid=-1))
        eng.run()
        torch.cuda.synchronize()
    rec = StepRecorder(eng.fam.decode_step, keep_logits, cache_decodes,
                       snapshot)
    eng.fam = dataclasses.replace(eng.fam, decode_step=rec)
    for rid in (range(len(requests)) if order is None else order):
        p, n, *frames = requests[rid]
        eng.submit(Request(prompt=p, max_new_tokens=n, rid=rid,
                           frames=frames[0] if frames else None))
    steps0 = eng.steps_total
    for m in mods.values():
        m.launches = 0
    mods["dequant_matmul"].lead_launches = 0
    t0 = time.monotonic()
    done = eng.run(max_steps=4096)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {name: m.launches for name, m in mods.items()}
    lead_launches = mods["dequant_matmul"].lead_launches
    steps = eng.steps_total - steps0
    eng.fam = dataclasses.replace(eng.fam, decode_step=rec.step)
    decode = [r["s"] for r in rec.records if r["T"] == 1]
    prefill = [r["s"] for r in rec.records if r["T"] > 1]
    n_tok = sum(len(g.tokens) for g in done)
    stats = dict(steps=steps, launches=launches,
                 dequant_matmul_lead_launches=lead_launches, tokens=n_tok,
                 wall_s=wall, tokens_per_s=n_tok / wall,
                 decode_ms_per_step=1e3 * float(np.median(decode)),
                 prefill_ms_per_step=(1e3 * float(np.median(prefill))
                                      if prefill else None),
                 failed=sum(g.failed for g in done),
                 done=sum(g.done for g in done))
    return done, stats, rec.records


def check_run(arch, done, stats, requests, lead_per_step=0, admitted=None):
    """Every request finished with all its tokens, and each kernel ran its
    designed number of launches per step (and the others none),
    ``dequant_matmul`` ``lead_per_step`` of them with a lead dim, besides
    the launches of admissions (``admitted``: kernel -> launches, made
    outside the steps). ``arch`` names the row of ``LAUNCHES_PER_STEP``."""
    check(stats["failed"] == 0 and stats["done"] == len(requests) and
          sorted(len(g.tokens) for g in done) ==
          sorted(r[1] for r in requests),
          f"{arch}: requests did not all finish: {stats}")
    lead = stats["dequant_matmul_lead_launches"]
    check(lead == lead_per_step * stats["steps"],
          f"{arch}: dequant_matmul launched {lead} times with a lead dim "
          f"over {stats['steps']} steps, expected {lead_per_step} per step")
    per_step = LAUNCHES_PER_STEP[arch]
    for name, n in stats["launches"].items():
        extra = (admitted or {}).get(name, 0)
        want = per_step.get(name, 0) * stats["steps"] + extra
        check(n == want, f"{arch}: {name} launched {n} times over "
              f"{stats['steps']} steps and {extra} at admissions, expected "
              f"{per_step.get(name, 0)} per step")


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
    # device events only (kernels, copies): a CPU op's self device time is
    # that of the kernels it launched, which are listed again as events of
    # their own
    kernels = sorted((e for e in events
                      if e.device_type != torch.autograd.DeviceType.CPU
                      and dev_us(e) > 0), key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    host = sorted(events, key=lambda e: e.self_cpu_time_total,
                  reverse=True)[:10]
    launch_calls = sum(e.count for e in events
                       if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                    "cudaLaunchKernelExC"))
    attn_calls = attn.launches - calls0
    attn_events = [(e.key[:90], e.count) for e in kernels
                   if any(n in e.key for n in ATTN_DEVICE_KERNELS)]
    attn_kernels = sum(n for _, n in attn_events)
    check(attn_kernels == attn_calls, f"decode_attention_quant: "
          f"{attn_calls} calls made {attn_kernels} device kernels "
          f"{attn_events}")
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
    codes that differ, the sum and the largest of the differences in
    codepoints, and the largest relative difference of a scale."""
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
        stats["sum_codepoints"] = (stats.get("sum_codepoints", 0)
                                   + int(step.sum()))
        stats["max_codepoints"] = max(stats["max_codepoints"],
                                      int(step.max()))
        stats["max_scale_rel"] = max(stats["max_scale_rel"],
                                     float(rel.max()))
    return write_pair


def hold_kv_witness(stats, bits=4):
    """The rule for ``kv_witness``'s counts. By default (gemma3's q4
    replay, the front end's forked q8 rows): at most 10% of the codes
    differ, each by one codepoint, and no scale by more than 5e-2 of
    itself. bf16-level differences in k and v only move values that lie
    near a midpoint to the next code, and a scale by an ulp or two; a fault
    before the cache write (a wrong projection, norm or rotation) moves
    codes by many codepoints. q8 (``bits=8``, zamba2): each code within one
    q4 step of the card's (17 of its 255 steps), the mean difference at
    most 2 codepoints, no scale by more than 5e-2. Its grid is 17 times
    finer, and zamba2's k and v come from the residual after up to 54
    Mamba-2 layers, whose bf16 decays (cast as the reference casts them)
    carry the card's and the CPU's rounding apart by a few percent of a
    row's absmax: the H100 read a mean of 0.66 codepoints, at most 7, and
    3.5% on a scale (PERF.md §6); a wrong projection or rotation moves the
    mean by tens of codepoints."""
    check(stats["codes"] > 0, "the K/V witness compared no code")
    share = stats["differ"] / stats["codes"]
    mean = stats.get("sum_codepoints", 0) / stats["codes"]
    if bits == 4:
        ok = share <= 0.10 and stats["max_codepoints"] <= 1
    else:
        ok = stats["max_codepoints"] <= 17 and mean <= 2.0
    check(ok and stats["max_scale_rel"] <= 5e-2,
          f"the CPU's own k/v codes disagree with the card's: {stats}")
    return dict(stats, differ_share=share, mean_codepoints=mean)


class RouteRecorder:
    """While ``installed()``, records the expert choices (N, k) of every
    ``layers.route`` call (one a layer a step: the card's routing), as the
    device tensors the router returned."""

    def __init__(self):
        self.calls = []

    @contextlib.contextmanager
    def installed(self):
        from repro_torch.models import layers
        route = layers.route

        def recording(probs, k):
            vals, choice = route(probs, k)
            self.calls.append(choice)
            return vals, choice
        layers.route = recording
        try:
            yield self
        finally:
            layers.route = route


def route_stats():
    return dict(dispatches=0, differ=0, tokens=0, tokens_reordered=0)


def route_witness(calls, stats):
    """A ``layers.route`` for the CPU replay: takes the CPU's own top k,
    counts the dispatches whose expert is not among the card's choices for
    the same token (``calls``, in call order) and the tokens whose choices
    differ only in order, and returns the card's choices with the CPU's
    probabilities at them. Card and CPU round the bf16 router matmul
    differently, so a near-tie can send a token to another expert: a large
    logit difference that says nothing of the kernels. With the card's
    choices both sides dispatch, drop and combine alike."""
    from repro_torch.models import layers
    route = layers.route
    pending = iter(calls)

    def witness(probs, k):
        _, own = route(probs, k)
        card = next(pending).to(own.device)
        check(card.shape == own.shape, f"routing witness: card choices "
              f"{tuple(card.shape)} against the CPU's {tuple(own.shape)}")
        shared = (own[:, :, None] == card[:, None, :]).any(-1)
        stats["dispatches"] += own.numel()
        stats["tokens"] += own.shape[0]
        stats["differ"] += int((~shared).sum())
        stats["tokens_reordered"] += int(
            (shared.all(-1) & (own != card).any(-1)).sum())
        return torch.gather(probs, -1, card), card
    return witness


# route_witness's limits, about 3.6x and 2.5x the largest shares read on
# the H100 at qwen2-moe-a2.7b full (prefill + first decode step, dense and
# q8 caches): dispatches to another expert 1.01% and 1.39%, tokens whose
# experts came in another order 7.5% and 10.1%
ROUTE_DIFFER_MAX = 0.05
ROUTE_REORDERED_MAX = 0.25


def hold_route_witness(stats):
    """The rule for ``route_witness``'s counts: at most ``ROUTE_DIFFER_MAX``
    of the dispatches went to an expert the card did not choose, and at
    most ``ROUTE_REORDERED_MAX`` of the tokens had the card's experts in
    another order. Card and CPU round a bf16 router logit an ulp apart,
    which only moves near-ties; a fault in the card's routing (a wrong
    router matmul, a sort in the wrong direction, an order that is not
    stable) moves most tokens. Returns the counts with both shares."""
    check(stats["dispatches"] > 0, "the routing witness compared nothing")
    out = dict(stats, differ_share=stats["differ"] / stats["dispatches"],
               reordered_share=stats["tokens_reordered"] / stats["tokens"])
    check(out["differ_share"] <= ROUTE_DIFFER_MAX and
          out["reordered_share"] <= ROUTE_REORDERED_MAX,
          f"the CPU's own routing disagrees with the card's: {out}")
    return out


def dropped_dispatches(choice, E, capacity_factor):
    """Dispatches of one MoE call past their expert's capacity (``cap =
    max(ceil(capacity_factor · k · N / E), 4)``), from its choices (N, k):
    they fall through to the residual."""
    N, k = choice.shape
    cap = max(math.ceil(capacity_factor * k * N / E), 4)
    counts = torch.bincount(choice.reshape(-1), minlength=E)
    return int((counts - cap).clamp(min=0).sum())


def replay_on_cpu(eng, records, card_cache=False, kv_stats=None,
                  routes=None, route_stats=None, state_in=None,
                  device="cpu"):
    """Replay the card's recorded batches through the plain path on the CPU
    (the same packed weights); yield (card logits, CPU logits, what) for
    every valid position. ``device="cuda"`` replays on the card instead,
    where the caller routes the kernels to their plain versions
    (``plain_kernels``).

    By default the CPU keeps its own cache, written by its own steps.
    ``card_cache=True`` runs each step instead on the KV cache the card left
    after that step (``StepRecorder``'s ``cache``; a family's recurrent
    state stays the CPU's own), with a reset slot's position and recurrent
    rows set to 0 as the step's prologue would, and the CPU's cache
    writes replaced by ``kv_witness`` (its counts go to ``kv_stats``): both
    sides then read the same quantised cache, so the logits compare holds
    the computation, not the rounding of near-midpoint values to a
    different code, and the witness holds the CPU's own new k and v to the
    codes the card wrote.

    ``routes`` (the card's expert choices of these steps, a
    ``RouteRecorder``'s calls) routes every MoE call of the replay as the
    card did, through ``route_witness`` (its counts go to
    ``route_stats``).

    ``state_in`` (state entries on the host) replaces those entries of the
    CPU's state: whisper's cross K/V as the card's admissions wrote it, so
    the decode replay holds the decoder and its kernels, not a second
    encode."""
    from repro_torch.models import layers
    from repro_torch.serve.engine import alloc_decode_state, params_to
    device = torch.device(device)
    params = params_to(eng.params, device)
    memo = (dequant_memo(params) if device.type == "cpu"
            else contextlib.nullcontext())
    state = alloc_decode_state(eng.fam, eng.cfg, eng.B, eng.kv_len,
                               slack=eng.prefill_chunk, device=device)
    state.update({k: v.to(device) for k, v in (state_in or {}).items()})
    # the KV stacks of the card's cache; the other entries (recurrent, conv
    # and SSM state) are the CPU's own, wiped by hand at a reset slot
    kv_keys = (() if eng.fam.cache_spec is None else eng.fam.cache_spec(
        eng.cfg, eng.B, eng.kv_len, slack=eng.prefill_chunk,
        windowed=eng.windowed_cache).state_keys)
    batch_axis = {k: spec.axes.index("batch") for k, spec in
                  eng.fam.decode_state_specs(
                      eng.cfg, eng.B, eng.kv_len, slack=eng.prefill_chunk,
                      windowed=eng.windowed_cache).items()
                  if k != "pos" and k not in kv_keys}
    write_kv_pair, route = layers.write_kv_pair, layers.route
    if card_cache:
        layers.write_kv_pair = kv_witness(kv_stats)
    if routes is not None:
        layers.route = route_witness(routes, route_stats)
    try:
        with torch.inference_mode(), memo:
            for rec in records:
                batch = {k: v.to(device) for k, v in rec["batch"].items()}
                pos = rec["pos"].to(device, torch.int32)
                if card_cache:
                    batch = {k: v for k, v in batch.items() if k != "reset"}
                    if "reset" in rec["batch"]:
                        rm = rec["batch"]["reset"].to(device).bool()
                        pos = torch.where(rm, torch.zeros_like(pos), pos)
                        for k, ax in batch_axis.items():
                            shape = [1] * state[k].ndim
                            shape[ax] = -1
                            state[k] = state[k].masked_fill(
                                rm.reshape(shape), 0)
                    state = {**state, **{k: rec["cache"][k].to(device)
                                         for k in kv_keys}}
                state["pos"] = pos
                logits, state = eng.fam.decode_step(params, state, batch,
                                                    eng.cfg)
                logits = logits.cpu()
                tv = rec["batch"]["t_valid"].numpy()
                for i in range(len(tv)):
                    for t in range(int(tv[i])):
                        yield (rec["logits"][i, t].numpy(),
                               logits[i, t].numpy(),
                               f"card vs {device.type} plain path, step "
                               f"pos {int(rec['pos'][i])}")
    finally:
        layers.write_kv_pair, layers.route = write_kv_pair, route


def compare_with_cpu(eng, records, card_cache=False, kv_stats=None,
                     routes=None, route_stats=None, state_in=None,
                     device="cpu"):
    """Hold the card's logits to the plain path's replay (``replay_on_cpu``)
    under ``hold_logits``."""
    worst, n_margin = 0.0, 0
    for got, want, what in replay_on_cpu(eng, records, card_cache,
                                         kv_stats, routes, route_stats,
                                         state_in, device):
        rel, margin = hold_logits(got, want, what)
        worst = max(worst, rel)
        n_margin += margin
    check(n_margin > 0, "no high-margin token to compare")
    return worst, n_margin


@contextlib.contextmanager
def dequant_memo(params):
    """While the context lasts, the plain path dequantises each packed
    weight of ``params`` once and reuses that f32 tensor in every later
    step (``dequant_matmul.ref.dequant_weight``, the same bits): a CPU
    replay otherwise dequantises the whole model again at every step,
    which was most of its time. Codes outside ``params`` are not kept."""
    from repro_torch.core.tensor_format import PackedTensor
    from repro_torch.kernels.dequant_matmul import ref
    owned = {w.codes.untyped_storage().data_ptr()
             for _, w in flat_with_paths(params)
             if isinstance(w, PackedTensor)}
    dequant, kept = ref.dequant_weight, {}

    def cached(codes, scales, codebook, block=128, bits=8):
        if codes.untyped_storage().data_ptr() not in owned:
            return dequant(codes, scales, codebook, block, bits)
        key = (codes.data_ptr(), tuple(codes.shape), codes.stride(),
               scales.data_ptr(), codebook.data_ptr(), block, bits)
        if key not in kept:
            kept[key] = dequant(codes, scales, codebook, block, bits)
        return kept[key]
    ref.dequant_weight = cached
    try:
        yield
    finally:
        ref.dequant_weight = dequant
        kept.clear()


@contextlib.contextmanager
def plain_kernels():
    """Route every kernel entry of ``kernels.ops`` to its plain torch
    version on the card as well (the path a CPU tensor takes: each packed
    weight dequantised in f32 per call, no launch) while the context
    lasts."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_quant_ref)
    from repro_torch.kernels.dequant_matmul.ref import (
        dequant_matmul_ref, dequant_matmul_t_ref)

    def block_quant(x, codebook, block, *, pack, out, rows):
        return ops._block_quant_plain(x, codebook, block, pack, out, rows)

    def block_quant_kv(k, v, codebook, block, *, pack, out_k, out_v, rows):
        return (block_quant(k, codebook, block, pack=pack, out=out_k,
                            rows=rows),
                block_quant(v, codebook, block, pack=pack, out=out_v,
                            rows=rows))

    def decode_attention(q, k_codes, k_scales, v_codes, v_scales, codebook,
                         q_positions, window, *, ring, bits):
        return decode_attention_quant_ref(
            q, k_codes, k_scales, v_codes, v_scales, codebook, q_positions,
            window=window, ring=ring, bits=bits)

    plain = dict(dequant_matmul_cuda=dequant_matmul_ref,
                 dequant_matmul_t_cuda=dequant_matmul_t_ref,
                 block_quant_cuda=block_quant,
                 block_quant_kv_cuda=block_quant_kv,
                 decode_attention_quant_cuda=decode_attention)
    saved = {name: getattr(ops, name) for name in plain}
    for name, fn in plain.items():
        setattr(ops, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def plain_witness(eng, mods, records, what, routes=None):
    """A full-depth witness of a served run whose CPU hold is cut in depth:
    the served engine's own prefill step and first decode step replayed at
    full depth on the card through the plain path (``plain_kernels``: the
    same packed weights, no kernel launched), held by the margin rule.
    ``routes`` (a MoE run's expert choices, ``moe_serve``'s) routes the
    replay as the served steps routed, held by ``hold_route_witness``."""
    records = records[:2]
    check(records[0]["T"] > 1 and records[-1]["T"] == 1,
          f"{what}: the witness needs the prefill and a decode step")
    launches = {name: m.launches for name, m in mods.items()}
    rs = route_stats()
    if routes is not None:
        routes = routes[:len(records) * eng.cfg.n_layers]
    t0 = time.monotonic()
    with plain_kernels():
        worst, n = compare_with_cpu(eng, records, routes=routes,
                                    route_stats=rs, device=eng.device)
    torch.cuda.synchronize()
    check({name: m.launches for name, m in mods.items()} == launches,
          f"{what}: a kernel launched in the plain replay")
    out = dict(layers=eng.cfg.n_layers, max_rel_logit_err=worst,
               margin_tokens=n, compared_steps=len(records),
               seconds=time.monotonic() - t0)
    if routes is not None:
        out["route_witness"] = hold_route_witness(rs)
    return out


def short_requests(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, 8).tolist(), 16) for _ in range(4)]


def serve_phase(arch, dev, mods, hold_layers=None, kv_bytes=None):
    """Serve ``arch`` full and hold the card's logits: at full depth, every
    step replayed on the CPU plain path; or, with ``hold_layers``, the
    engine's own prefill step and first decode step replayed at full depth
    on the card's plain path (``plain_witness``), and the CPU hold on a
    second engine of that many layers at full width serving the same
    requests (``depth_hold``, its prefill step and first decode step).
    ``kv_bytes``: the cache's KV bytes by the reference's count."""
    start = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    eng, setup_s = build_engine(arch, dev)
    setup_peak = torch.cuda.max_memory_allocated(dev)
    gone = [weakref.ref(eng)]
    wb = eng.weight_bytes()
    check({k: wb[k] for k in WEIGHT_BYTES[arch]} == WEIGHT_BYTES[arch],
          f"{arch} weight_bytes {wb} != {WEIGHT_BYTES[arch]}")
    cb = eng.cache_bytes()
    check(kv_bytes is None or cb["kv"] == kv_bytes,
          f"{arch}: KV bytes {cb['kv']} != {kv_bytes}")
    reqs = short_requests(eng.cfg.vocab)
    done, stats, records = serve(eng, mods, reqs, keep_logits=True)
    check_run(arch, done, stats, reqs)
    out = dict(phase="serve", arch=arch, layers=eng.cfg.n_layers,
               setup_s=setup_s, setup_peak_mem_bytes=setup_peak,
               weight_bytes=wb, kv_bytes=cb["kv"], cache_bytes=cb["total"],
               peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
               launches_per_step={k: n / stats["steps"]
                                  for k, n in stats["launches"].items()},
               **stats)
    emit(phase="profile", arch=arch, **profile_steps(eng, mods))
    out["tokens"] = {g.rid: g.tokens for g in done}
    if hold_layers is not None:
        out["plain_witness"] = plain_witness(eng, mods, records, arch)
        with collector_off():
            del eng, records
            out["dropped"] = check_dropped(arch, gone, start, dev)
        torch.cuda.empty_cache()
        out["cpu_hold"] = depth_hold(arch, dev, mods, reqs, hold_layers,
                                     compare_steps=2)
        emit(**out)
        return out
    t0 = time.monotonic()
    worst, n = compare_with_cpu(eng, records)
    out.update(cpu_max_rel_logit_err=worst, cpu_margin_tokens=n,
               cpu_compared_steps=len(records),
               cpu_compared_layers=eng.cfg.n_layers,
               cpu_compare_s=time.monotonic() - t0)
    with collector_off():
        del eng, records
        out["dropped"] = check_dropped(arch, gone, start, dev)
    emit(**out)
    torch.cuda.empty_cache()
    return out


def depth_hold(arch, dev, mods, reqs, layers, compare_steps=None,
               cache_decodes=0, then=None, **engine_kw):
    """A served run's CPU hold at cut depth: a second engine of ``arch`` at
    full width and ``layers`` layers (``engine_kw``: its kv_len and cache
    format), serving the same requests with the launches of
    ``LAUNCHES_PER_STEP[arch + " hold"]``, and its steps (the first
    ``compare_steps``, or all) held to the CPU plain path at that depth.

    ``cache_decodes`` = n holds instead the prefill step and the first n
    decode steps on the cache the card left (``replay_on_cpu``'s
    ``card_cache``, with the K/V witness), and reports the drift of a
    replay on the CPU's own cache: a q4 code flips where a value lies near
    a midpoint, so the CPU's own cache drifts from the card's with the
    bf16 rounding of the projections. ``then(eng)`` returns the results of
    the caller's own checks on the engine, added to the hold's."""
    t0 = time.monotonic()
    eng, setup_s = build_engine(arch, dev, n_layers=layers, **engine_kw)
    done, stats, records = serve(eng, mods, reqs, keep_logits=True,
                                 cache_decodes=cache_decodes)
    check_run(f"{arch} hold", done, stats, reqs)
    if cache_decodes:
        records = records[:sum("cache" in r for r in records)]
        check(len(records) > cache_decodes and records[0]["T"] > 1 and
              all(r["T"] == 1 for r in records[-cache_decodes:]),
              f"{arch}: the hold needs the prefill and {cache_decodes} "
              "decode steps")
    elif compare_steps is not None:
        records = records[:compare_steps]
        check(records[0]["T"] > 1 and records[-1]["T"] == 1,
              f"{arch}: the compare needs the prefill and a decode step")
    out = dict(layers=layers, setup_s=setup_s, steps=stats["steps"],
               launches=stats["launches"],
               tokens={g.rid: g.tokens for g in done})
    t1 = time.monotonic()
    if cache_decodes:
        out["cpu_own_cache_max_rel_logit_err"] = max(
            float(np.abs(got - want).max() / np.abs(want).max())
            for got, want, _ in replay_on_cpu(eng, records))
        kv = dict(codes=0, differ=0, max_codepoints=0, max_scale_rel=0.0)
        worst, n = compare_with_cpu(eng, records, card_cache=True,
                                    kv_stats=kv)
        out["cpu_kv_witness"] = hold_kv_witness(kv)
    else:
        worst, n = compare_with_cpu(eng, records)
    out.update(cpu_max_rel_logit_err=worst, cpu_margin_tokens=n,
               cpu_compared_steps=len(records),
               cpu_compare_s=time.monotonic() - t1)
    del records
    if then is not None:
        out.update(then(eng))
    out["hold_s"] = time.monotonic() - t0
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
    """gemma3-1b full, kv_len 1024: q8 (4 requests, their prefill step and
    first decode step replayed at full depth on the card's plain path
    (``plain_witness``), profiled, then a 600-token prompt that wraps the
    520-slot rings, held to the same request on full-length caches; the CPU
    hold on a second engine of ``GEMMA_HOLD_LAYERS`` layers serving the
    same 4 requests, every step compared), then the same 4 requests with a q4 cache on the same packed
    weights (the prefill and the first three decode steps of a second q4
    engine of ``GEMMA_HOLD_LAYERS`` layers compared with the CPU plain
    path on the card's cache, with the K/V witness)."""
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
        done, stats, records = serve(eng, mods, reqs, keep_logits=True)
        check_run(arch, done, stats, reqs)
        out = dict(phase="serve", arch=arch, kv_format=fmt, **setup,
                   weight_bytes=wb, kv_bytes=cb["kv"],
                   kv_code_bytes=cb["code_bytes"],
                   kv_scale_bytes=cb["scale_bytes"],
                   peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
                   **stats)
        if fmt == "q8":
            out["plain_witness"] = plain_witness(eng, mods, records,
                                                 f"{arch} {fmt}")
        del records
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
            out["cpu_hold"] = depth_hold(arch, dev, mods, reqs,
                                         GEMMA_HOLD_LAYERS, kv_len=1024,
                                         kv_format="q8")
        else:
            # the prefill step and the first three decode steps (the steps
            # whose cache was recorded), on the card's cache with the K/V
            # witness, to keep the CPU replay short
            out["cpu_hold"] = depth_hold(arch, dev, mods, reqs,
                                         GEMMA_HOLD_LAYERS, cache_decodes=3,
                                         kv_len=1024, kv_format="q4")
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
    labels (``GEMMA_HOLD_LAYERS`` layers at full width), ``--kv-format
    auto`` serving, and the matmul kernels' times at
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
    # labels (drawn on the CPU) on both sides, on a gemma3-1b of
    # GEMMA_HOLD_LAYERS layers at full width (the full-depth CPU backward
    # took ~50-60 s)
    del params
    torch.cuda.empty_cache()
    hold_cfg = cfg.replace(n_layers=GEMMA_HOLD_LAYERS)
    params = transformer.init(hold_cfg, seed=0, device=dev)
    seq = [{"tokens": held[1]["tokens"][1:2, :256]}]
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 256)))
    sample = fisher._sample_labels
    fisher._sample_labels = lambda logits, gen: labels.to(logits.device)
    try:
        t0 = time.monotonic()
        f_card = fisher.per_tensor_stats(
            params, fisher.estimate_diag_fisher(
                lambda p, b: apply(p, b, hold_cfg), params, seq, None))
        card_s = time.monotonic() - t0
        cpu_params = params_to(params, torch.device("cpu"))
        t0 = time.monotonic()
        f_cpu = fisher.per_tensor_stats(
            cpu_params, fisher.estimate_diag_fisher(
                lambda p, b: apply(p, b, hold_cfg.replace(remat="none")),
                cpu_params, [{"tokens": seq[0]["tokens"].cpu()}], None))
        cpu_s = time.monotonic() - t0
    finally:
        fisher._sample_labels = sample
    del cpu_params
    rel = {k: abs(f_card[k]["fisher_mean"] - f_cpu[k]["fisher_mean"])
           / f_cpu[k]["fisher_mean"] for k in f_cpu}
    check(max(rel.values()) <= 0.05, f"card vs CPU fisher_mean: {rel}")
    emit(phase="allocation", step="fisher_vs_cpu", tokens=256,
         layers=GEMMA_HOLD_LAYERS, max_rel_diff=max(rel.values()),
         rel_diff=rel, card_s=card_s, cpu_s=cpu_s)
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
            "4", "--max-new", "8", "--no-dense-fallback", "--device",
            "cuda"])
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
    # 4 four-token prompts share one prefill step, then 7 decode steps
    check_packed_steps(launches, out.getvalue(), steps=8, per_step=182,
                       unembed=True, what="--kv-format auto")
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


def check_packed_steps(launches, text, *, steps, per_step, unembed, what):
    """A CLI serve run stayed on the packed path for every step: no
    "degraded to dense" line, and ``dequant_matmul`` launched ``per_step``
    times in each of its ``steps`` steps (the tied unembed's
    ``dequant_matmul_t`` once a step where ``unembed``)."""
    check("degraded to dense" not in text, f"{what} degraded to dense")
    want = {"dequant_matmul": per_step * steps,
            "dequant_matmul_t": steps if unembed else 0}
    got = {k: launches[k] for k in want}
    check(got == want, f"{what}: launches {got}, expected {want}")


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
    on a grid without 0, does not, moves by about lr·m/eps). Then the f32
    run's parameters go through the entropy-coded checkpoint
    (``compressed_checkpoint``) and ``launch.serve --ckpt`` serves the
    checkpoint packed. Returns the launches of both serve runs."""
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
            runs = [compressed_checkpoint(dev, mods, state_a["params"],
                                          root)]
        else:
            shutil.rmtree(a)       # 1.5 GB a checkpoint: keep only f32_a
        shutil.rmtree(b)
        del state_a, state_b
        torch.cuda.empty_cache()
    t0 = time.monotonic()
    (done, text), launches = served(mods, lambda: quiet(serve_cli.main, [
        "--arch", "paper-100m", "--variant", "full", "--ckpt",
        str(root / "f32_a"), "--quantise", SPEC, "--packed", "--requests",
        "4", "--max-new", "8", "--no-dense-fallback", "--device",
        "cuda"]))
    check("step_00000020 (step 20)" in text, "serve --ckpt loaded "
          f"another checkpoint: {text[:300]}")
    check(len(done) == 4 and all(len(g.tokens) == 8 and not g.failed
                                 for g in done),
          "serve --ckpt: requests did not all finish")
    check_packed_steps(launches, text, steps=8, per_step=85,
                       unembed=False, what="serve --ckpt")
    emit(phase="train", step="resume", arch="paper-100m", batch=[8, 256],
         serve_launches=launches, serve_s=time.monotonic() - t0,
         serve_tokens={g.rid: g.tokens for g in done}, **out)
    return runs + [{"launches": launches}]


def compressed_checkpoint(dev, mods, params, root):
    """The entropy-coded checkpoint (``train.compressed_ckpt``, 4 bits of
    entropy on a uniform grid, Huffman-coded on the host) of the trained
    paper-100m full parameters, cut to their first ``CODEC_LAYERS`` layers
    (the embedding and unembedding whole): its bytes beside the f32 and
    the packed babsmax64:n4 bytes, the bits per parameter, the codec's host
    seconds; the loaded tree within the grid of the saved one, then served
    packed at that depth (4 requests, no dense fallback) with the card's
    logits held to the CPU plain path."""
    from repro_torch import configs
    from repro_torch.core import build_plan
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import compressed_ckpt
    from repro_torch.core.element import uniform_grid
    from repro_torch.core.plan import _flat_with_paths
    params = {**params, "layers": {k: v[:CODEC_LAYERS]
                                   for k, v in params["layers"].items()}}
    n_params = sum(x.numel() for _, x in flat_with_paths(params))
    fitted, calls, fit = {}, [], compressed_ckpt.fit_grid_delta

    def key(x):                       # a host f32 tensor, by its bytes
        x = np.ascontiguousarray(x, np.float32)
        return x.shape, hashlib.blake2b(x.tobytes(), digest_size=16).digest()

    def recording_fit(x, **kw):       # the exact deltas, by the tensor
        delta = fit(x, **kw)          # fitted (the codec fits in threads)
        fitted[key(x)] = delta
        calls.append(delta)
        return delta
    compressed_ckpt.fit_grid_delta = recording_fit
    t0 = time.monotonic()
    try:
        path = compressed_ckpt.save_compressed_params(
            str(root / "compressed"), params, target_bits=4.0, step=20)
    finally:
        compressed_ckpt.fit_grid_delta = fit
    save_s = time.monotonic() - t0
    nbytes = os.path.getsize(os.path.join(path, "arrays.npz"))
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    t0 = time.monotonic()
    loaded = compressed_ckpt.load_compressed_params(path, params)
    torch.cuda.synchronize()
    load_s = time.monotonic() - t0
    # the codec is lossless: every quantised tensor comes back bitwise as
    # its grid codes (rounded on the host, as the save rounds them) times
    # the stored delta; the error against the trained weights is reported
    npz = np.load(os.path.join(path, "arrays.npz"))
    metas = {k[:-len(".__meta")]: npz[k] for k in npz.files
             if k.endswith(".__meta")}
    worst, worst_name, n_exact = 0.0, None, 0
    for (name, a), (_, b) in zip(_flat_with_paths(params),
                                 _flat_with_paths(loaded)):
        check(a.shape == b.shape and b.device == a.device,
              f"compressed checkpoint: {name} came back as {b.shape}")
        meta = metas.get(name.replace("/", "_"))
        if meta is None:
            check(torch.equal(a.float(), b), f"raw tensor {name} changed")
            continue
        a_host = a.detach().to("cpu", torch.float32)
        delta = fitted[key(a_host.numpy())]
        check(int(meta[1]) == int(delta * 2.0 ** 40),
              f"compressed checkpoint: {name}'s stored delta")
        want = (uniform_grid(delta).quantise(a_host).float()
                * (int(meta[1]) / 2.0 ** 40))
        check(torch.equal(want, b.cpu()), f"compressed checkpoint: {name} "
              "does not decode to its grid codes")
        n_exact += 1
        err = float((a_host - want).abs().max() / a_host.pow(2).mean()
                    .sqrt())
        if err >= worst:
            worst, worst_name = err, name
    check(n_exact == len(metas) == len(calls),
          f"{n_exact} of {len(metas)} quantised tensors checked")
    npz.close()
    check(3.9 < man["achieved_bits_per_param"] < 4.1,
          f"achieved {man['achieved_bits_per_param']} bits per parameter")
    cfg = configs.get_config("paper-100m", "full").replace(
        n_layers=CODEC_LAYERS)
    plan = build_plan(loaded, SPEC)
    eng = ServeEngine.from_quantised(cfg, plan.quantise(loaded), plan,
                                     batch_slots=4, kv_len=256,
                                     prefill_chunk=8, dense_fallback=False,
                                     device=dev)
    del loaded
    wb = eng.weight_bytes()
    reqs = short_requests(cfg.vocab, seed=6)
    done, stats, records = serve(eng, mods, reqs, keep_logits=True)
    check_run("paper-100m codec", done, stats, reqs)
    check(not eng.degraded, "the compressed checkpoint's engine degraded")
    t0 = time.monotonic()
    rel, n = compare_with_cpu(eng, records)
    emit(phase="train", step="compressed_checkpoint", arch="paper-100m",
         layers=CODEC_LAYERS, params=n_params, compressed_bytes=nbytes,
         f32_bytes=4 * n_params,
         packed_bytes=wb["total"],
         achieved_bits_per_param=man["achieved_bits_per_param"],
         file_bits_per_param=8 * nbytes / n_params, save_s=save_s,
         load_s=load_s, codec_s=save_s + load_s,
         exact_tensors=n_exact, max_err_over_rms=worst,
         worst_tensor=worst_name,
         serve_launches=stats["launches"],
         decode_ms_per_step=stats["decode_ms_per_step"],
         cpu_max_rel_logit_err=rel, cpu_margin_tokens=n,
         cpu_compare_s=time.monotonic() - t0,
         tokens={g.rid: g.tokens for g in done})
    del eng, records
    torch.cuda.empty_cache()
    return {"launches": stats["launches"]}


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
        runs = resume_phase(dev, mods, root)
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


# ---------------------------------------------------------------------------
# Phase 8: the serving front end (scheduler, prefix forks, traffic replay,
# fault drills) at gemma3-1b full


FRONTEND_KW = dict(batch_slots=4, kv_len=1024, prefill_chunk=8)
# the replayed workload: 16 requests at 0.5 a step, bodies of 16-96 tokens,
# 8-32 new tokens, a 128-token shared "sys" prefix on 60% of them, and a
# quarter of them at priority 2
FRONTEND_TRAFFIC = dict(seed=0, n_requests=16, rate=0.5, prompt_len=(16, 96),
                        output_len=(8, 32), prefixes=(("sys", 128, 0.6),),
                        no_prefix_weight=0.4,
                        priorities=((0.0, 0.75), (2.0, 0.25)))
FRONTEND_NAN = ((1, 40, 3),)      # NaN logits on slot 1, steps 40-42
PREFIX_LEN = 128


def frontend_replay(cfg, packed, dev, mods, workload, use_prefix=True,
                    probe_rid=None):
    """``traffic.replay`` of ``workload`` on a fresh engine over the shared
    packed weights (no dense fallback: a kernel failure raises), with every
    kernel's launch count set to 0 just before it and read just after it.
    Records each emitted token's logits row, which request held slot 1 at
    each device step (pool prefill steps included, as the fault injector
    counts them), the NaN injector's counter when the spec arms one, and,
    for ``probe_rid``, the first ``PREFIX_LEN`` cache rows of its slot as
    they stood when it emitted its first token."""
    from repro_torch.serve import faults, traffic
    from repro_torch.serve.engine import ServeEngine, weak_method
    eng = ServeEngine(cfg, packed, dense_fallback=False, device=dev,
                      **FRONTEND_KW)
    rows, probe, slot1, ctrs = {}, {}, [], []
    # the recorders reach the engine weakly, as the fault injectors do
    ref = weakref.ref(eng)
    emit_token, step = (weak_method(eng, "_emit_token"),
                        weak_method(eng, "_step"))

    def emit(i, g, row, finished):
        rows.setdefault(g.rid, []).append(row.copy())
        if g.rid == probe_rid and not g.tokens:
            probe.update({k: v[:, i, :PREFIX_LEN].to("cpu", copy=True)
                          for k, v in ref()._state.items() if k != "pos"})
        emit_token(i, g, row, finished)

    def holder(p, s, b):
        slot = ref()._slots[1]
        slot1.append(None if slot is None else slot.rid)
        return step(p, s, b)

    inject = faults.inject_nan_logits

    def arm(*args, **kw):
        ctrs.append(inject(*args, **kw))
        return ctrs[-1]
    eng._emit_token, eng._step = emit, holder
    faults.inject_nan_logits = arm
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            report, launches = served(mods, lambda: traffic.replay(
                eng, workload, use_prefix=use_prefix))
    finally:
        faults.inject_nan_logits = inject
    check(not eng.degraded, "a front-end replay ended degraded")
    check(all(n > 0 for n in launches.values()),
          f"not every kernel ran in the replay: {launches}")
    quarantined = sum("quarantined" in str(w.message) for w in caught)
    return dict(report=report, rows=rows, probe=probe, slot1=slot1,
                ctr=ctrs[0] if ctrs else None, launches=launches,
                quarantine_warnings=quarantined)


def timed_replay(cfg, packed, dev, mods, workload, use_prefix=True):
    """``traffic.replay`` of ``workload`` on a fresh engine with nothing
    recorded (no logits rows, no slot record, no cache probe): the front
    end's latency and goodput as a caller of ``replay`` sees them. No dense
    fallback; every kernel must launch."""
    from repro_torch.serve import traffic
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(cfg, packed, dense_fallback=False, device=dev,
                      **FRONTEND_KW)
    report, launches = served(mods, lambda: traffic.replay(
        eng, workload, use_prefix=use_prefix))
    check(not eng.degraded, "a front-end replay ended degraded")
    check(all(n > 0 for n in launches.values()),
          f"not every kernel ran in the replay: {launches}")
    return dict(report=report, launches=launches)


def replay_metrics(run):
    return dict(run["report"].metrics, launches=run["launches"])


def hold_streams(a, b, what):
    """Two replays' greedy streams under the margin rule: request by
    request, each emitted token's logits held by ``hold_logits`` for as
    long as both streams agree (a token that differs where ``hold_logits``
    passed had a low margin, and ends the compare of that request)."""
    ta, tb = a["report"].tokens, b["report"].tokens
    check(sorted(ta) == sorted(tb), f"{what}: different requests")
    worst, n_margin, compared, diverged = 0.0, 0, 0, []
    for rid in sorted(ta):
        for j, (x, y) in enumerate(zip(a["rows"].get(rid, []),
                                       b["rows"].get(rid, []))):
            rel, margin = hold_logits(x, y, f"{what}, rid {rid} token {j}")
            worst = max(worst, rel)
            n_margin += margin
            compared += 1
            if ta[rid][j] != tb[rid][j]:
                diverged.append([rid, j])
                break
    check(n_margin > 0, f"{what}: no high-margin token compared")
    return dict(max_rel_logit_err=worst, margin_tokens=n_margin,
                compared_tokens=compared,
                identical_streams=sum(ta[r] == tb[r] for r in ta),
                requests=len(ta), diverged_at=diverged)


def hold_prefix_rows(forked, recomputed):
    """The prefix's K/V rows of one request in its slot, forked from the
    pool against recomputed in place: counts of equal codes and the K/V
    witness rule (``hold_kv_witness``) on the differing ones."""
    stats = dict(codes=0, differ=0, max_codepoints=0, max_scale_rel=0.0)
    check(forked and sorted(forked) == sorted(recomputed),
          "no prefix rows recorded")
    for k in sorted(forked):
        a, b = forked[k], recomputed[k]
        if a.dtype == torch.uint8:
            step = (a.int() - b.int()).abs()
            stats["codes"] += step.numel()
            stats["differ"] += int((step > 0).sum())
            stats["max_codepoints"] = max(stats["max_codepoints"],
                                          int(step.max()))
        else:
            rel = (a - b).abs() / torch.where(b == 0, torch.ones_like(b), b)
            stats["max_scale_rel"] = max(stats["max_scale_rel"],
                                         float(rel.abs().max()))
    out = hold_kv_witness(stats)
    out["bitwise_equal_codes"] = stats["codes"] - stats["differ"]
    out["bitwise_equal_scales"] = sum(
        int((forked[k] == recomputed[k]).sum()) for k in forked
        if forked[k].dtype != torch.uint8)
    out["scales"] = sum(forked[k].numel() for k in forked
                        if forked[k].dtype != torch.uint8)
    return out


def fail_after_write(eng, steps):
    """Raise from the device step at each index in ``steps`` *after* the
    inner step ran, so its in-place cache writes have landed."""
    from repro_torch.serve.engine import weak_method
    inner = weak_method(eng, "_step")
    ctr = {"step": 0, "raised": 0}

    def wrapped(p, s, b):
        out = inner(p, s, b)
        ctr["step"] += 1
        if ctr["step"] - 1 in steps:
            ctr["raised"] += 1
            raise RuntimeError(f"injected failure after step "
                               f"{ctr['step'] - 1}")
        return out
    eng._step = wrapped
    return ctr


def drill(cfg, qparams, plan, packed, dev, mods):
    """The fault drills at gemma3-1b full: a corrupted scale refused at
    load naming the tensor; a step failure absorbed by a retry; the same
    failure without a retry degrading the engine to dense; a failure after
    the step wrote the cache, retried; a stalled step caught by the
    watchdog and the straggler monitor, the partials resumed."""
    from repro_torch.core import IntegrityError
    from repro_torch.serve import faults
    from repro_torch.serve.engine import Request, ServeEngine
    out = {}
    tensor = faults.packed_paths(qparams)[0]
    try:
        ServeEngine.from_quantised(cfg, faults.corrupt_scales(
            qparams, tensor), plan, device=dev, **FRONTEND_KW)
        check(False, "a corrupted scale was not refused")
    except IntegrityError as e:
        check(tensor in str(e) and "scales" in str(e),
              f"IntegrityError does not name {tensor}: {e}")
        out["corrupt_scales"] = dict(tensor=tensor, error=str(e))
    torch.cuda.empty_cache()
    reqs = short_requests(cfg.vocab, seed=5)

    def run(inject=None, **kw):
        eng = ServeEngine(cfg, packed, device=dev, **{**FRONTEND_KW, **kw})
        for rid, (p, n) in enumerate(reqs):
            eng.submit(Request(prompt=p, max_new_tokens=n, rid=rid))
        ctr = inject(eng) if inject else None
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            done, launches = served(mods, eng.run)
        toks = {g.rid: g.tokens for g in done}
        check(len(done) == 4 and all(g.done for g in done) and
              sorted(len(t) for t in toks.values()) ==
              sorted(n for _, n in reqs),
              f"drill requests did not finish: {sorted(toks.items())}")
        return eng, toks, ctr, launches, [str(w.message) for w in caught]
    eng, clean, _, launches, _ = run(dense_fallback=False)
    steps = eng.steps_total
    check(all(n > 0 for n in launches.values()), f"clean run: {launches}")

    eng, toks, ctr, launches, warns = run(
        lambda e: faults.inject_step_failures(e, {3}), step_retries=2)
    check(ctr["raised"] == 1 and not eng.degraded and toks == clean,
          f"retried step failure: {ctr}, degraded {eng.degraded}, tokens "
          f"equal {toks == clean}")
    out["retry"] = dict(raised=ctr["raised"], degraded=eng.degraded,
                        tokens_equal_clean=toks == clean, launches=launches)

    eng, toks, ctr, launches, warns = run(
        lambda e: faults.inject_step_failures(e, {3}), step_retries=1,
        dense_fallback=True)
    degrade_warned = any("degraded mode" in w for w in warns)
    check(ctr["raised"] == 1 and eng.degraded and degrade_warned,
          f"unretried failure did not degrade: {ctr}, {warns}")
    check(not eng._has_packed(), "the degraded engine kept packed weights")
    per = LAUNCHES_PER_STEP["gemma3-1b"]
    check(launches["dequant_matmul"] == 3 * per["dequant_matmul"] and
          launches["dequant_matmul_t"] == 3 * per["dequant_matmul_t"],
          f"steps after the degrade launched packed matmuls: {launches}")
    check(eng.steps_total == steps, f"degraded run took {eng.steps_total} "
          f"steps, the clean run {steps}")
    out["dense_fallback"] = dict(
        raised=ctr["raised"], degraded=True, runtime_warning=degrade_warned,
        launches=launches, steps=eng.steps_total,
        packed_matmul_steps=launches["dequant_matmul"]
        // per["dequant_matmul"],
        tokens_equal_clean=sum(toks[r] == clean[r] for r in clean))
    del eng
    torch.cuda.empty_cache()

    eng, toks, ctr, launches, warns = run(
        lambda e: fail_after_write(e, {0, 3, 9}), step_retries=2,
        dense_fallback=False)
    check(ctr["raised"] == 3 and toks == clean, f"retry after the cache "
          f"write: {ctr}, tokens equal {toks == clean}")
    out["retry_after_write"] = dict(raised=ctr["raised"],
                                    tokens_equal_clean=True,
                                    launches=launches)

    eng = ServeEngine(cfg, packed, dense_fallback=False, device=dev,
                      **FRONTEND_KW)
    for rid, (p, n) in enumerate(reqs):
        eng.submit(Request(prompt=p, max_new_tokens=n, rid=rid))
    ctr = faults.inject_slow_steps(eng, {10}, delay_s=3.0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        partial = eng.run(deadline_s=2.0)
    watchdog = any("watchdog" in str(w.message) for w in caught)
    check(ctr["slowed"] == 1 and watchdog and eng.straggler.flagged >= 1
          and max(eng.straggler._times) >= 3.0,
          f"the stall went unnoticed: {ctr}, watchdog {watchdog}, flagged "
          f"{eng.straggler.flagged}")
    check(partial and all(not g.done for g in partial),
          "the watchdog returned no partials")
    n_partial = len(partial)
    del eng._step                 # the engine's own step again
    done = eng.run()
    toks = {g.rid: g.tokens for g in done}
    check(toks == clean, "resumed partials differ from the clean run")
    out["stall"] = dict(slowed=ctr["slowed"], watchdog=watchdog,
                        straggler_flagged=eng.straggler.flagged,
                        stall_s=max(eng.straggler._times),
                        partials=n_partial, resumed_equal_clean=True)
    return out


def frontend_phase(dev, mods):
    """The serving front end at gemma3-1b full (babsmax64:n4 packed, seeded
    weights, q8 KV cache, kv_len 1024, 4 slots, prefill chunk 8): the
    ``FRONTEND_TRAFFIC`` workload replayed with prefix reuse twice
    (signatures equal bit for bit), without reuse (no fork, more prefill
    slot-steps, greedy streams held to the reuse run's by the margin rule,
    one forked request's prefix K/V rows held to the recomputed ones by the
    K/V witness rule) and with ``FRONTEND_NAN`` (the request in slot 1 then
    ends failed, every other completes); the reuse, no-reuse and reuse
    replays again with nothing recorded, for latency and goodput;
    ``launch.serve --traffic-replay``
    with q8 and q4 caches; the fault drills. Returns the launches of every
    run."""
    from repro_torch import configs
    from repro_torch.core import build_plan
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import transformer
    from repro_torch.serve import traffic
    from repro_torch.serve.engine import ServeEngine
    t_phase = time.monotonic()
    cfg = configs.get_config("gemma3-1b", "full").replace(kv_format="q8")
    qparams = transformer.init(cfg, seed=0, device=dev)
    plan = build_plan(qparams, SPEC)
    quantise_leaf_by_leaf(plan, qparams)
    packed = ServeEngine.from_quantised(cfg, qparams, plan, device=dev,
                                        **FRONTEND_KW).params
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t_phase
    spec = traffic.TrafficSpec(vocab=cfg.vocab, **FRONTEND_TRAFFIC)
    wl = traffic.generate(spec)
    probe = next(a.rid for a in wl.arrivals if a.prefix is not None)
    runs = []

    reuse = frontend_replay(cfg, packed, dev, mods, wl, probe_rid=probe)
    again = frontend_replay(cfg, packed, dev, mods, wl)
    sig = reuse["report"].deterministic_signature()
    check(sig == again["report"].deterministic_signature(),
          "two reuse replays of one spec differ on the card")
    m = reuse["report"].metrics
    check(m["completed"] == m["n_requests"] and m["forks"] > 0,
          f"reuse replay: {m}")
    emit(phase="frontend", step="replay_reuse", arch="gemma3-1b",
         kv_format="q8", spec=dataclasses.asdict(spec), setup_s=setup_s,
         signatures_equal=True, **replay_metrics(reuse),
         repeat=replay_metrics(again))
    runs += [{"launches": r["launches"]} for r in (reuse, again)]
    del again

    plain = frontend_replay(cfg, packed, dev, mods, wl, use_prefix=False,
                            probe_rid=probe)
    mp = plain["report"].metrics
    check(mp["forks"] == 0 and mp["completed"] == mp["n_requests"] and
          mp["total_prefill_slot_steps"] > m["total_prefill_slot_steps"],
          f"no-reuse replay: {mp}")
    streams = hold_streams(reuse, plain, "reuse vs no reuse")
    rows = hold_prefix_rows(reuse["probe"], plain["probe"])
    emit(phase="frontend", step="replay_no_reuse", arch="gemma3-1b",
         kv_format="q8", **replay_metrics(plain), margin_rule=streams,
         prefix_rows=dict(rows, rid=probe, positions=PREFIX_LEN))
    runs.append({"launches": plain["launches"]})
    plain_sig = plain["report"].deterministic_signature()
    del reuse, plain

    faulted = frontend_replay(cfg, packed, dev, mods, traffic.generate(
        dataclasses.replace(spec, fault_nan=FRONTEND_NAN)))
    mf = faulted["report"].metrics
    outcomes = faulted["report"].outcomes
    slot, at, n = FRONTEND_NAN[0]
    window = {r for r in faulted["slot1"][at:at + n] if r is not None}
    failed = {r for r, o in outcomes.items() if o == "failed"}
    check(faulted["ctr"]["injected"] == n and failed and failed <= window
          and all(o == "done" for r, o in outcomes.items()
                  if r not in failed),
          f"NaN replay: injected {faulted['ctr']}, failed {failed}, slot "
          f"{slot} held {window} in the window, outcomes {outcomes}")
    clean = sig["tokens"]
    check(all(faulted["report"].tokens[r] == clean[r][:len(
        faulted["report"].tokens[r])] for r in failed),
          "a failed request's partial tokens are not the clean replay's")
    emit(phase="frontend", step="replay_fault_nan", arch="gemma3-1b",
         kv_format="q8", fault_nan=FRONTEND_NAN, injected=faulted["ctr"],
         failed_tokens={r: len(faulted["report"].tokens[r])
                        for r in failed},
         slot1_in_window=sorted(window),
         quarantine_warnings=faulted["quarantine_warnings"],
         **replay_metrics(faulted))
    runs.append({"launches": faulted["launches"]})
    del faulted

    # the latency and goodput of record: replays with nothing recorded,
    # reuse and no reuse alternated, each signature equal to its
    # instrumented twin's; each engine, under its Scheduler, is then
    # dropped with the report that holds them and must be freed at once
    # (the packed weights are shared and stay)
    for name, use in (("reuse", True), ("no_reuse", False),
                      ("reuse_again", True)):
        start = torch.cuda.memory_allocated(dev)
        timed = timed_replay(cfg, packed, dev, mods, wl, use_prefix=use)
        check(timed["report"].deterministic_signature() ==
              (sig if use else plain_sig),
              f"the uninstrumented {name} replay differs from its "
              "instrumented twin")
        gone = [weakref.ref(timed["report"].scheduler.engine)]
        engine_bytes = torch.cuda.memory_allocated(dev) - start
        emit(phase="frontend", step="replay_timed", run=name,
             arch="gemma3-1b", kv_format="q8", signature_equal=True,
             **replay_metrics(timed))
        runs.append({"launches": timed["launches"]})
        with collector_off():
            del timed
            dropped = check_dropped(f"the front end's engine ({name})",
                                    gone, start, dev)
        emit(phase="frontend", step="dropped", run=name,
             engine_bytes=engine_bytes, **dropped)
    emit(phase="timing", frontend_replays_s=time.monotonic() - t_phase)

    for kv in ("q8", "q4"):
        t0 = time.monotonic()
        (report, text), launches = served(mods, lambda: quiet(
            serve_cli.main, [
                "--arch", "gemma3-1b", "--variant", "full", "--quantise",
                SPEC, "--packed", "--kv-format", kv, "--kv-len", "1024",
                "--slots", "4", "--requests",
                str(FRONTEND_TRAFFIC["n_requests"]), "--traffic-replay", "0",
                "--prefix", "128", "--no-dense-fallback", "--device",
                "cuda"]))
        mc = report.metrics
        check(mc["completed"] == FRONTEND_TRAFFIC["n_requests"] and
              mc["forks"] > 0 and
              "TTFT p50/p99" in text and "prefix reuse:" in text and
              not report.scheduler.engine.degraded and
              all(v > 0 for v in launches.values()),
              f"serve --traffic-replay --kv-format {kv}: {mc}, {launches}, "
              f"{text[-600:]}")
        emit(phase="frontend", step="cli", kv_format=kv,
             s=time.monotonic() - t0, launches=launches,
             report=[ln for ln in text.splitlines()
                     if ln.startswith("[serve]")][-5:],
             **{k: mc[k] for k in ("steps_total", "forks",
                                   "prefill_slot_steps", "pool_prefill_steps",
                                   "goodput_tok_s", "ttft_p50_s",
                                   "ttft_p99_s")})
        runs.append({"launches": launches})
        del report
        torch.cuda.empty_cache()
    emit(phase="timing", frontend_cli_s=time.monotonic() - t_phase)

    t0 = time.monotonic()
    drills = drill(cfg, qparams, plan, packed, dev, mods)
    emit(phase="frontend", step="drill", arch="gemma3-1b", kv_format="q8",
         s=time.monotonic() - t0, **drills)
    runs += [drills[k] for k in ("retry", "dense_fallback",
                                 "retry_after_write")]
    del qparams, packed
    torch.cuda.empty_cache()
    emit(phase="timing", frontend_phase_s=time.monotonic() - t_phase)
    return [{"launches": r["launches"]} for r in runs]


# ---------------------------------------------------------------------------
# Phase 9: MoE serving (qwen2-moe-a2.7b full)


MOE_COMPARE_STEPS = 2     # the prefill step and the first decode step


def moe_phase(dev, mods):
    """qwen2-moe-a2.7b full (24 layers, 60 routed experts of 1408, top-4, 4
    shared), babsmax64:n4 packed, seeded weights drawn and packed one leaf
    at a time: 4 requests on a dense cache, then on a q8 cache. Each run
    launches ``dequant_matmul`` 241 times a step, 72 of them over the
    expert stacks with their lead dim E = 60 (and with q8, 24
    ``block_quant_kv`` and 24 ``decode_attention_quant``), is profiled and
    reports its dropped dispatches per step. Each run's prefill step and
    first decode step are held to the CPU plain path on a second engine at
    full width and ``MOE_HOLD_LAYERS`` layers with the same cache, serving
    the same requests (``moe_hold``: the full-depth CPU replay took 95–115
    s of the script's time).
    Both holds route the CPU as the card routed (``route_witness``, held
    by ``hold_route_witness``). Then ``launch.serve`` serves the model from
    the command line (``moe_cli``)."""
    from repro_torch.serve.engine import ServeEngine
    arch = MOE_ARCH
    t_phase = time.monotonic()
    start = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    eng, setup_s = build_engine(arch, dev, kv_len=256)
    setup = {"setup_s": setup_s,
             "setup_peak_mem_bytes": torch.cuda.max_memory_allocated(dev)}
    gone = [weakref.ref(eng)]
    wb = eng.weight_bytes()
    check({k: wb[k] for k in WEIGHT_BYTES[arch]} == WEIGHT_BYTES[arch],
          f"{arch} weight_bytes {wb} != {WEIGHT_BYTES[arch]}")
    cfg = eng.cfg
    reqs = short_requests(cfg.vocab)
    runs = []
    for fmt in ("dense", "q8"):
        key = arch if fmt == "dense" else f"{arch} {fmt}"
        if fmt != "dense":
            t0 = time.monotonic()
            eng = ServeEngine(cfg.replace(kv_format=fmt), eng.params,
                              batch_slots=4, kv_len=256, prefill_chunk=8,
                              device=dev)
            gone.append(weakref.ref(eng))
            setup = {"engine_s": time.monotonic() - t0}
        done, stats, records, calls = moe_serve(eng, mods, reqs, key)
        cb = eng.cache_bytes()
        out = dict(phase="moe", arch=arch, kv_format=fmt, **setup,
                   weight_bytes=wb, kv_bytes=cb["kv"],
                   peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
                   dropped_share_per_step=moe_dropped(cfg, calls,
                                                      stats["steps"]),
                   step_tokens=[r["T"] for r in records], **stats)
        emit(phase="profile", arch=arch, kv_format=fmt,
             **profile_steps(eng, mods))
        out["cpu_hold"] = moe_hold(dev, mods, reqs,
                                   "" if fmt == "dense" else fmt)
        del records
        out["tokens"] = {g.rid: g.tokens for g in done}
        emit(**out)
        runs.append(stats)
        emit(phase="timing", moe_run_end_s=time.monotonic() - t_phase,
             kv_format=fmt)
    with collector_off():
        del eng
        dropped = check_dropped(arch, gone, start, dev)
    emit(phase="moe", step="dropped", arch=arch, engines=len(gone),
         **dropped)
    release()
    runs.append(moe_cli(mods))
    emit(phase="timing", moe_cli_end_s=time.monotonic() - t_phase)
    return runs


def moe_serve(eng, mods, reqs, key):
    """Serve ``reqs`` on a MoE engine after an unrecorded warm-up, recording
    its steps and the card's routing: (done, stats, records, the expert
    choices of each layer of each step, on the host). Checks the launches
    of ``LAUNCHES_PER_STEP[key]``, 3 a layer of them over the expert stacks
    with the lead dim (``MOE_LEAD_LAUNCHES`` at full depth), and that the
    engine stayed packed."""
    from repro_torch.serve.engine import Request
    L = eng.cfg.n_layers
    eng.submit(Request(prompt=reqs[0][0], max_new_tokens=2, rid=-1))
    eng.run()                      # warm-up, not recorded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    routes = RouteRecorder()
    with routes.installed():
        done, stats, records = serve(eng, mods, reqs, keep_logits=True,
                                     warm=False)
    check_run(key, done, stats, reqs, lead_per_step=3 * L)
    check(not eng.degraded, f"{key}: the engine degraded to dense")
    calls = [c.cpu() for c in routes.calls]
    check(len(calls) == L * stats["steps"], f"{key}: {len(calls)} "
          f"routing calls over {stats['steps']} steps of {L} layers")
    return done, stats, records, calls


def moe_dropped(cfg, calls, steps):
    """The share of each step's dispatches dropped past capacity."""
    L = cfg.n_layers
    step_calls = [calls[i * L:(i + 1) * L] for i in range(steps)]
    return [sum(dropped_dispatches(c, cfg.n_experts, cfg.capacity_factor)
                for c in cs) / sum(c.numel() for c in cs)
            for cs in step_calls]


def moe_compare(eng, records, calls, key):
    """The prefill step and the first decode step held to the CPU plain
    path at the engine's depth, routed as the card routed."""
    L = eng.cfg.n_layers
    records = records[:MOE_COMPARE_STEPS]
    check(records[0]["T"] > 1 and records[-1]["T"] == 1,
          f"{key}: the compare needs the prefill and a decode step")
    rs = route_stats()
    worst, n = compare_with_cpu(eng, records,
                                routes=calls[:len(records) * L],
                                route_stats=rs)
    return dict(cpu_max_rel_logit_err=worst, cpu_margin_tokens=n,
                cpu_compared_steps=len(records), cpu_compared_layers=L,
                route_witness=hold_route_witness(rs))


def moe_hold(dev, mods, reqs, kv_format, arch=MOE_ARCH,
             layers=MOE_HOLD_LAYERS):
    """A run's CPU hold: a second engine of ``arch`` (qwen2-moe-a2.7b) at
    full width and ``layers`` layers with the run's cache (``kv_format``:
    "" dense, or "q8"), serving the same requests with the launches of its
    depth, its prefill step and first decode step held to the CPU plain
    path at that depth."""
    t0 = time.monotonic()
    eng, setup_s = build_engine(arch, dev, kv_len=256, kv_format=kv_format,
                                n_layers=layers)
    key = arch + (f" {kv_format}" if kv_format else "") + " hold"
    done, stats, records, calls = moe_serve(eng, mods, reqs, key)
    t1 = time.monotonic()
    out = dict(layers=layers, setup_s=setup_s,
               launches=stats["launches"],
               tokens={g.rid: g.tokens for g in done},
               **moe_compare(eng, records, calls, key),
               cpu_compare_s=time.monotonic() - t1,
               hold_s=time.monotonic() - t0)
    del eng, records
    release()
    return out


def moe_cli(mods, arch=MOE_ARCH, lead_per_step=MOE_LEAD_LAUNCHES, steps=8,
            phase="moe", peak_max=None):
    """``launch.serve`` at ``arch`` full (qwen2-moe-a2.7b), packed: the
    user's entry point sets the model up one leaf at a time and serves 4
    requests of ``steps`` tokens on the packed path, each step launching
    ``dequant_matmul`` as ``LAUNCHES_PER_STEP[arch]`` says (241 for
    qwen2-moe), ``lead_per_step`` of them with the expert lead dim, with
    the resident weight bytes of ``WEIGHT_BYTES``; with ``peak_max``, the
    run's peak device bytes stay under it. Returns the run's launches."""
    from repro_torch.launch import serve as serve_cli
    t0 = time.monotonic()
    mods["dequant_matmul"].lead_launches = 0
    torch.cuda.reset_peak_memory_stats()
    (done, text), launches = served(mods, lambda: quiet(serve_cli.main, [
        "--arch", arch, "--variant", "full", "--quantise", SPEC, "--packed",
        "--kv-len", "256", "--requests", "4", "--max-new", str(steps),
        "--no-dense-fallback", "--device", "cuda"]))
    lead = mods["dequant_matmul"].lead_launches
    check(len(done) == 4 and all(len(g.tokens) == steps and not g.failed
                                 for g in done),
          f"serve --arch {arch}: requests did not all finish")
    check_packed_steps(launches, text, steps=steps,
                       per_step=LAUNCHES_PER_STEP[arch]["dequant_matmul"],
                       unembed=False, what=f"serve --arch {arch}")
    check(lead == lead_per_step * steps, f"serve --arch {arch}: "
          f"{lead} lead-dim launches over {steps} steps")
    wb = WEIGHT_BYTES[arch]
    check(f"{wb['codes']:,} codes + {wb['scales']:,} scales" in text and
          f"{wb['dense']:,} dense bytes" in text,
          f"serve --arch {arch}: weight bytes differ: {text[:600]}")
    peak = torch.cuda.max_memory_allocated()
    if peak_max is not None:
        check(peak < peak_max, f"serve --arch {arch}: peak device bytes "
              f"{peak:,} not under {peak_max:,.0f}")
    emit(phase=phase, step="cli", arch=arch, s=time.monotonic() - t0,
         peak_mem_bytes=peak,
         launches=launches, dequant_matmul_lead_launches=lead,
         report=[ln for ln in text.splitlines() if ln.startswith("[serve]")],
         tokens={g.rid: g.tokens for g in done})
    del done
    release()
    return {"launches": launches}


# ---------------------------------------------------------------------------
# Phase 9b: llama4-scout-17b-a16e served whole


def llama4_phase(dev, mods):
    """llama4-scout-17b-a16e full (48 layers, d 5120, 40 heads on 8 KV heads
    of 128, 16 routed experts of 8192 top-1, one shared, vocab 202048,
    untied), babsmax64:n4 packed: 107.77 B parameters whose f32 weights are
    431 GB, served from 57.3 GB. Each expert stack is 128.85 GB in f32, so
    ``build_packed_engine`` draws it a layer slice at a time
    (``SlicedLeaf``); the build's peak device bytes stay under
    ``LLAMA4_SETUP_PEAK_MAX``.

    4 requests on a dense cache, then on a q8 cache (a second engine over
    the same packed weights). Each step launches ``dequant_matmul`` 481
    times, 144 of them over the expert stacks with the lead dim E = 16
    (with q8 also 48 ``block_quant_kv`` and 48 ``decode_attention_quant``).
    Each run's prefill step and first decode step are replayed at full
    depth on the card's plain path, routed as the card routed
    (``plain_witness``); the dense run is profiled and also held to the
    CPU on a second engine at full width and ``LLAMA4_HOLD_LAYERS`` layers
    (``moe_hold``). Then ``launch.serve`` serves the model from the command
    line (``moe_cli``)."""
    from repro_torch.serve.engine import ServeEngine
    arch = LLAMA4_ARCH
    t_phase = time.monotonic()
    release()                   # the earlier phases' engines
    start = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    eng, setup_s = build_engine(arch, dev, kv_len=256)
    setup = {"setup_s": setup_s, "start_mem_bytes": start,
             "setup_peak_mem_bytes": torch.cuda.max_memory_allocated(dev)}
    check(setup["setup_peak_mem_bytes"] < LLAMA4_SETUP_PEAK_MAX,
          f"{arch}: the build's peak device bytes "
          f"{setup['setup_peak_mem_bytes']:,} are not under "
          f"{LLAMA4_SETUP_PEAK_MAX:,.0f}")
    wb = eng.weight_bytes()
    check({k: wb[k] for k in WEIGHT_BYTES[arch]} == WEIGHT_BYTES[arch],
          f"{arch} weight_bytes {wb} != {WEIGHT_BYTES[arch]}")
    cfg = eng.cfg
    check(cfg.n_layers == LLAMA4_LAYERS, f"{arch}: {cfg.n_layers} layers")
    reqs = short_requests(cfg.vocab)
    runs = []
    for fmt in ("dense", "q8"):
        key = arch if fmt == "dense" else f"{arch} {fmt}"
        if fmt != "dense":
            t0 = time.monotonic()
            eng = ServeEngine(cfg.replace(kv_format=fmt), eng.params,
                              batch_slots=4, kv_len=256, prefill_chunk=8,
                              device=dev)
            setup = {"engine_s": time.monotonic() - t0}
        done, stats, records, calls = moe_serve(eng, mods, reqs, key)
        cb = eng.cache_bytes()
        check(cb["kv"] == LLAMA4_KV_BYTES[fmt],
              f"{key}: KV bytes {cb['kv']} != {LLAMA4_KV_BYTES[fmt]}")
        out = dict(phase="llama4", arch=arch, kv_format=fmt, **setup,
                   weight_bytes=wb, kv_bytes=cb["kv"],
                   peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
                   dropped_share_per_step=moe_dropped(cfg, calls,
                                                      stats["steps"]),
                   step_tokens=[r["T"] for r in records], **stats)
        if fmt == "dense":
            emit(phase="profile", arch=arch, kv_format=fmt,
                 **profile_steps(eng, mods))
        out["plain_witness"] = plain_witness(eng, mods, records, key,
                                             routes=calls)
        if fmt == "dense":
            out["cpu_hold"] = moe_hold(dev, mods, reqs, "", arch=arch,
                                       layers=LLAMA4_HOLD_LAYERS)
        del records
        out["tokens"] = {g.rid: g.tokens for g in done}
        emit(**out)
        runs.append(stats)
        emit(phase="timing", llama4_run_end_s=time.monotonic() - t_phase,
             kv_format=fmt)
    del eng
    release()
    runs.append(moe_cli(mods, arch, LLAMA4_LEAD_LAUNCHES, steps=4,
                        phase="llama4", peak_max=LLAMA4_SETUP_PEAK_MAX))
    emit(phase="timing", llama4_cli_end_s=time.monotonic() - t_phase)
    return runs


# ---------------------------------------------------------------------------
# Phases 10 and 11: the encoder-decoder and vision-language families


def whisper_requests(cfg):
    """The whisper run's six requests (prompt, max_new, frames), rid =
    index, and the order they are submitted in. r0, r1 and r3 carry
    distinct seeded frames (``make_batch_fn``'s draw: standard normals of
    the data pipeline's Philox stream), r2 and r4 are text-only, r5 repeats
    r1's prompt and frames. The four first requests free their slots after
    the same step, and r5 is submitted before r4: r5 takes r0's slot and
    r4 takes r1's, so both reused slots had frames before."""
    from repro_torch.data.pipeline import make_batch_fn
    frames = make_batch_fn(cfg, seq=8, batch=3, seed=0)(0)["frames"]
    prompts = np.random.default_rng(0).integers(0, cfg.vocab,
                                                (5, 8)).tolist()
    reqs = [(prompts[0], 16, frames[0]), (prompts[1], 16, frames[1]),
            (prompts[2], 16, None), (prompts[3], 16, frames[2]),
            (prompts[4], 16, None), (prompts[1], 16, frames[1])]
    return reqs, [0, 1, 2, 3, 5, 4]


class AdmissionRecorder:
    """Wraps an engine's ``_admit_cross`` while ``installed()``: per
    admission its rid, slot, whether it had frames, its seconds (the
    device synchronised before and after), each kernel's launches and the
    rows M of every ``dequant_matmul`` call it made; a text-only
    admission's cross K/V rows are read back right after it (``zero``:
    every one exactly 0 on the card)."""

    def __init__(self, eng, mods):
        self.eng, self.mods = eng, mods
        self.admit = eng._admit_cross
        self.log = []

    @contextlib.contextmanager
    def installed(self):
        self.eng._admit_cross = self
        try:
            yield self
        finally:
            del self.eng._admit_cross     # the engine's own method again

    def __call__(self, i, req):
        from repro_torch.kernels import ops
        matmul, rows = ops.dequant_matmul, []

        def counting(x, *a, **kw):
            rows.append(int(x.shape[-2]))
            return matmul(x, *a, **kw)
        torch.cuda.synchronize()
        n0 = {name: m.launches for name, m in self.mods.items()}
        t0 = time.monotonic()
        ops.dequant_matmul = counting
        try:
            self.admit(i, req)
        finally:
            ops.dequant_matmul = matmul
        torch.cuda.synchronize()
        entry = dict(rid=req.rid, slot=i, frames=req.frames is not None,
                     s=time.monotonic() - t0, rows=sorted(set(rows)),
                     launches={n: m.launches - n0[n]
                               for n, m in self.mods.items()})
        if req.frames is None:
            st = self.eng._state
            entry["zero"] = all(int(torch.count_nonzero(st[k][:, i])) == 0
                                for k in ("xk", "xv"))
        self.log.append(entry)


def check_admissions(key, log, reqs, order):
    """Every request admitted once, in ``order``: one with frames made
    ``WHISPER_ADMIT_LAUNCHES`` ``dequant_matmul`` launches, all at M =
    ``WHISPER_ENC_SEQ``, and no other kernel's; a text-only one made none
    and left its slot's cross K/V exactly zero. Returns the launches of
    all admissions, per kernel."""
    check([e["rid"] for e in log] == list(order),
          f"{key}: admissions {[e['rid'] for e in log]}, expected {order}")
    total = {}
    for e in log:
        want = ({"dequant_matmul": WHISPER_ADMIT_LAUNCHES}
                if reqs[e["rid"]][2] is not None else {})
        got = {n: k for n, k in e["launches"].items() if k}
        check(got == want, f"{key}: admission of r{e['rid']} launched "
              f"{got}, expected {want}")
        check(e["rows"] == ([WHISPER_ENC_SEQ] if want else []),
              f"{key}: admission of r{e['rid']} ran rows {e['rows']}")
        check(e.get("zero", True), f"{key}: r{e['rid']} (text-only) found "
              "nonzero cross K/V rows in its slot")
        for n, k in got.items():
            total[n] = total.get(n, 0) + k
    return total


def hold_encoder(eng, frames, card, slot):
    """One CPU ``cross_prefill`` at full depth on the same packed weights,
    against the card's cross K/V rows of ``slot`` (``card``: xk, xv on the
    host), layer by layer: max error within 5e-2·max|CPU| of each layer's
    xk and xv. Returns the worst ratio, per entry, and the CPU's seconds."""
    from repro_torch.serve.engine import params_to
    params = params_to(eng.params, torch.device("cpu"))
    t0 = time.monotonic()
    with torch.inference_mode():
        want = eng.fam.cross_prefill(params, torch.from_numpy(frames)[None],
                                     eng.cfg)
    out = {"cpu_encode_s": time.monotonic() - t0}
    for key in ("xk", "xv"):
        got = card[key][:, slot].float()            # (Ld, enc_seq, H, hd)
        w = want[key][:, 0].float()
        rel = ((got - w).abs().amax(dim=(1, 2, 3))
               / w.abs().amax(dim=(1, 2, 3)))
        check(bool((rel <= 5e-2).all()), f"whisper encoder: {key} of "
              f"{int((rel > 5e-2).sum())} layer(s) off by more than 5e-2 "
              f"of max|{key}| (worst {float(rel.max())})")
        out[f"{key}_max_rel_err"] = float(rel.max())
    return out


def whisper_phase(dev, mods):
    """whisper-large-v3 full, babsmax64:n4 packed (seeded weights drawn and
    packed one leaf at a time), 4 slots, kv_len 256, chunk 8: the six
    requests of ``whisper_requests`` on a dense self-attention cache, then
    on a q8 one (phase 10 of the module docstring). Each run checks every
    admission (``check_admissions``) and the launches a step besides them,
    r5's tokens against r1's, the slots reused, weight, KV and cross-K/V
    bytes, and is profiled; the dense run holds r0's cross K/V to one CPU
    encode at full depth, and both runs hold their prefill step and first
    decode step to the CPU plain path at full depth fed the card's cross
    K/V. Then ``launch.serve`` from the command line (``whisper_cli``)."""
    from repro_torch.serve.engine import Request, ServeEngine
    arch = WHISPER_ARCH
    t_phase = time.monotonic()
    torch.cuda.reset_peak_memory_stats(dev)
    eng, setup_s = build_engine(arch, dev, kv_len=256)
    setup = {"setup_s": setup_s,
             "setup_peak_mem_bytes": torch.cuda.max_memory_allocated(dev)}
    wb = eng.weight_bytes()
    check({k: wb[k] for k in WEIGHT_BYTES[arch]} == WEIGHT_BYTES[arch],
          f"{arch} weight_bytes {wb} != {WEIGHT_BYTES[arch]}")
    cfg = eng.cfg
    reqs, order = whisper_requests(cfg)
    runs = []
    for fmt in ("dense", "q8"):
        key = arch if fmt == "dense" else f"{arch} {fmt}"
        if fmt != "dense":
            t0 = time.monotonic()
            eng = ServeEngine(cfg.replace(kv_format=fmt), eng.params,
                              batch_slots=4, kv_len=256, prefill_chunk=8,
                              device=dev)
            setup = {"engine_s": time.monotonic() - t0}
        # warm-up, not recorded: one admission with frames, one without
        eng.submit(Request(prompt=reqs[0][0], max_new_tokens=2, rid=-1,
                           frames=reqs[0][2]))
        eng.submit(Request(prompt=reqs[2][0], max_new_tokens=2, rid=-2))
        eng.run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        adm = AdmissionRecorder(eng, mods)
        with adm.installed():
            done, stats, records = serve(eng, mods, reqs, keep_logits=True,
                                         warm=False, order=order,
                                         snapshot=("xk", "xv"))
        admitted = check_admissions(key, adm.log, reqs, order)
        check_run(key, done, stats, reqs, admitted=admitted)
        check(not eng.degraded, f"{key}: the engine degraded to dense")
        tokens = {g.rid: g.tokens for g in done}
        slots = {e["rid"]: e["slot"] for e in adm.log}
        check(tokens[5] == tokens[1] and slots[5] != slots[1],
              f"{key}: r5 (r1's prompt and frames, slot {slots[5]}) gave "
              f"{tokens[5]}, r1 (slot {slots[1]}) {tokens[1]}")
        check(slots[4] == slots[1] and slots[5] == slots[0],
              f"{key}: slots {slots}: r4 and r5 must reuse r1's and r0's")
        cb = eng.cache_bytes()
        check(cb["kv"] == WHISPER_KV_BYTES[fmt] and
              cb["other"] == WHISPER_OTHER_BYTES,
              f"{key}: cache bytes {cb['kv']} + {cb['other']}")
        frame_s = [e["s"] for e in adm.log if e["frames"]]
        out = dict(phase="whisper", arch=arch, kv_format=fmt, **setup,
                   weight_bytes=wb, kv_bytes=cb["kv"],
                   cross_kv_bytes=cb["other"] - 16,
                   peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
                   admission_ms_with_frames=1e3 * float(np.median(frame_s)),
                   admissions=[{k: e[k] for k in ("rid", "slot", "frames",
                                                  "s", "rows")}
                               for e in adm.log],
                   admission_launches=admitted, slots=slots, **stats)
        emit(phase="profile", arch=arch, kv_format=fmt,
             **profile_steps(eng, mods))
        records = records[:WHISPER_COMPARE_STEPS]
        check(records[0]["T"] > 1 and records[-1]["T"] == 1,
              f"{key}: the compare needs the prefill and a decode step")
        cross = records[0]["state_in"]
        if fmt == "dense":
            out["encoder_hold"] = hold_encoder(eng, reqs[0][2], cross,
                                               slots[0])
        t0 = time.monotonic()
        worst, n = compare_with_cpu(eng, records, state_in=cross)
        out.update(cpu_max_rel_logit_err=worst, cpu_margin_tokens=n,
                   cpu_compared_steps=len(records),
                   cpu_compared_layers=cfg.n_layers,
                   cpu_compare_s=time.monotonic() - t0, tokens=tokens)
        del records, cross
        emit(**out)
        runs.append(stats)
        emit(phase="timing", whisper_run_end_s=time.monotonic() - t_phase,
             kv_format=fmt)
    del eng
    torch.cuda.empty_cache()
    runs.append(whisper_cli(mods))
    emit(phase="timing", whisper_cli_end_s=time.monotonic() - t_phase)
    return runs


def whisper_cli(mods):
    """``launch.serve --arch whisper-large-v3 --variant full --quantise
    babsmax64:n4 --packed --no-dense-fallback``: 4 text-only requests (the
    zero cross template, no encoder launch), 16 steps of 256
    ``dequant_matmul`` and 1 ``dequant_matmul_t`` launches, the resident
    weight bytes of ``WEIGHT_BYTES``. Returns the run's launches."""
    from repro_torch.launch import serve as serve_cli
    arch, steps = WHISPER_ARCH, 16
    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    (done, text), launches = served(mods, lambda: quiet(serve_cli.main, [
        "--arch", arch, "--variant", "full", "--quantise", SPEC, "--packed",
        "--no-dense-fallback", "--device", "cuda"]))
    check(len(done) == 4 and all(len(g.tokens) == steps and not g.failed
                                 for g in done),
          f"serve --arch {arch}: requests did not all finish")
    check_packed_steps(launches, text, steps=steps,
                       per_step=LAUNCHES_PER_STEP[arch]["dequant_matmul"],
                       unembed=True, what=f"serve --arch {arch}")
    wb = WEIGHT_BYTES[arch]
    check(f"{wb['codes']:,} codes + {wb['scales']:,} scales" in text and
          f"{wb['dense']:,} dense bytes" in text,
          f"serve --arch {arch}: weight bytes differ: {text[:600]}")
    emit(phase="whisper", step="cli", arch=arch, s=time.monotonic() - t0,
         peak_mem_bytes=torch.cuda.max_memory_allocated(),
         launches=launches,
         report=[ln for ln in text.splitlines() if ln.startswith("[serve]")],
         tokens={g.rid: g.tokens for g in done})
    del done
    torch.cuda.empty_cache()
    return {"launches": launches}


def internvl_phase(dev, mods):
    """internvl2-26b full (48 layers, d 6144, 48 heads over 8 KV heads of
    128, d_ff 16384, vocab 92553), babsmax64:n4 packed (the embedding in
    byte codes: odd vocab; the unembed dense: 92553 is no multiple of 64),
    q8 cache: 4 requests with the launches of ``LAUNCHES_PER_STEP`` (336
    ``dequant_matmul``, 48 ``block_quant_kv`` and 48
    ``decode_attention_quant`` a step), weight and KV bytes, then ``apply``
    over 256 seeded patch tokens of width 3200 and a 64-token text (336
    ``dequant_matmul`` launches at M = 320). Held on a second engine at
    full width and ``INTERNVL_LAYERS`` layers (``depth_hold``, with
    ``internvl_apply_hold``); the served prefill step and first decode step
    replayed at full depth on the card's plain path (``plain_witness``). No
    profile: late in the script the trace of this run recorded 7 device
    kernels for its 8 attention calls (the first prefill call's missing),
    in three runs out of three, and all 8 in a fresh process
    (``scripts/profile_attention_events.py``); the CPU hold of the served
    prefill step reads the attention outputs."""
    from repro_torch.data.pipeline import make_batch_fn
    arch = INTERNVL_ARCH
    t_phase = time.monotonic()
    torch.cuda.reset_peak_memory_stats(dev)
    eng, setup_s = build_engine(arch, dev, kv_len=256, kv_format="q8")
    setup_peak = torch.cuda.max_memory_allocated(dev)
    cfg = eng.cfg
    check_internvl_engine(eng, arch, INTERNVL_KV_BYTES)
    reqs = short_requests(cfg.vocab)
    done, stats, records = serve(eng, mods, reqs, keep_logits=True)
    check_run(arch + " q8", done, stats, reqs)
    out = dict(phase="internvl", arch=arch, layers=cfg.n_layers,
               kv_format="q8", setup_s=setup_s,
               setup_peak_mem_bytes=setup_peak,
               weight_bytes=eng.weight_bytes(), kv_bytes=INTERNVL_KV_BYTES,
               peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
               launches_per_step={k: n / stats["steps"]
                                  for k, n in stats["launches"].items()},
               **stats)
    out["tokens"] = {g.rid: g.tokens for g in done}
    batch = make_batch_fn(cfg, seq=64, batch=1, seed=0)(0)
    (logits, t_card), launches = served(mods, lambda: timed_apply(
        eng.fam.apply, eng.params, batch, cfg, dev))
    check_internvl_apply(logits, launches, cfg)
    out.update(apply_tokens=[cfg.n_vis_tokens, 64], apply_ms=t_card * 1e3,
               apply_launches=launches,
               apply_peak_mem_bytes=torch.cuda.max_memory_allocated(dev))
    del logits
    out["plain_witness"] = plain_witness(eng, mods, records, arch)
    del eng, records
    torch.cuda.empty_cache()
    out["cpu_hold"] = depth_hold(
        arch, dev, mods, reqs, INTERNVL_LAYERS, compare_steps=2,
        then=lambda hold: internvl_apply_hold(hold, mods, batch, dev),
        kv_len=256, kv_format="q8")
    out["phase_s"] = time.monotonic() - t_phase
    emit(**out)
    return [stats, {"launches": launches}]


def check_internvl_engine(eng, key, kv_bytes):
    """The engine's resident weight bytes (``WEIGHT_BYTES[key]``) and KV
    bytes by the reference's count; the embedding packed in byte codes and
    the unembed dense."""
    from repro_torch.core.tensor_format import PackedTensor
    wb = eng.weight_bytes()
    check({k: wb[k] for k in WEIGHT_BYTES[key]} == WEIGHT_BYTES[key],
          f"{key} weight_bytes {wb} != {WEIGHT_BYTES[key]}")
    check(eng.cache_bytes()["kv"] == kv_bytes,
          f"{key}: KV bytes {eng.cache_bytes()['kv']} != {kv_bytes}")
    emb, unemb = eng.params["embed"], eng.params["unembed"]
    check(isinstance(emb, PackedTensor) and emb.bits == 8 and
          not isinstance(unemb, PackedTensor),
          f"{key}: the embedding must pack in byte codes, the unembed "
          "stay dense")


def check_internvl_apply(logits, launches, cfg):
    """``apply`` over the patches and the text: 7 ``dequant_matmul``
    launches a layer and no other kernel, finite logits of every
    position."""
    check(launches == {"dequant_matmul": 7 * cfg.n_layers,
                       "dequant_matmul_t": 0, "block_quant": 0,
                       "decode_attention_quant": 0},
          f"{cfg.name} apply ({cfg.n_layers} layers): launches {launches}")
    check(tuple(logits.shape) == (1, cfg.n_vis_tokens + 64, cfg.vocab) and
          bool(torch.isfinite(logits).all()), f"{cfg.name} apply: logits "
          f"{tuple(logits.shape)}")


def internvl_apply_hold(eng, mods, batch, dev):
    """On internvl2-26b's cut-depth hold engine (``depth_hold``'s
    ``then``): its weight and KV bytes, then its ``apply`` over the same
    patches and text held position by position to the CPU plain path (the
    margin rule)."""
    from repro_torch.serve.engine import params_to
    cfg = eng.cfg
    check_internvl_engine(eng, INTERNVL_ARCH + " hold",
                          INTERNVL_HOLD_KV_BYTES)
    (logits, t_card), launches = served(mods, lambda: timed_apply(
        eng.fam.apply, eng.params, batch, cfg, dev))
    check_internvl_apply(logits, launches, cfg)
    t0 = time.monotonic()
    want, _ = timed_apply(eng.fam.apply, params_to(eng.params,
                                                   torch.device("cpu")),
                          batch, cfg, torch.device("cpu"))
    rel, n = hold_logits(logits[0].cpu(), want[0], f"{cfg.name} apply, card "
                         "vs CPU plain path")
    check(n > 0, f"{cfg.name} apply: no high-margin position to compare")
    return dict(apply_ms=t_card * 1e3, apply_launches=launches,
                apply_cpu_max_rel_logit_err=rel, apply_cpu_margin_positions=n,
                apply_cpu_compare_s=time.monotonic() - t0)


# ---------------------------------------------------------------------------
# Phases 12 and 13: the recurrent families


def recurrent_requests(vocab):
    """Six requests of 8-token prompts and 16 new tokens (rid = index), and
    the order they are submitted in: r5 repeats r1's prompt, and r5 and r4
    are submitted after the first four, so each takes a slot another
    request left (its recurrent state and KV rows wiped by the step's reset
    mask)."""
    prompts = np.random.default_rng(0).integers(0, vocab, (5, 8)).tolist()
    reqs = [(p, 16) for p in prompts] + [(prompts[1], 16)]
    return reqs, [0, 1, 2, 3, 5, 4]


class SlotLog:
    """The engine's ``on_admit`` hook while ``installed()``: the slot each
    rid was seated in."""

    def __init__(self, eng):
        self.eng, self.slots = eng, {}

    @contextlib.contextmanager
    def installed(self):
        hook = self.eng.on_admit
        self.eng.on_admit = lambda e, slot, req, gen: \
            self.slots.__setitem__(req.rid, slot)
        try:
            yield self
        finally:
            self.eng.on_admit = hook


def recurrent_run(eng, mods, reqs, order, key, cache_decodes=0):
    """Serve ``reqs`` in ``order`` (after a warm-up) recording every step:
    the launches of ``LAUNCHES_PER_STEP[key]``, all requests finished,
    packed throughout. Returns (tokens by rid, stats, records, slots)."""
    log = SlotLog(eng)
    with log.installed():
        done, stats, records = serve(eng, mods, reqs, keep_logits=True,
                                     order=order,
                                     cache_decodes=cache_decodes)
    check_run(key, done, stats, reqs)
    check(not eng.degraded, f"{key}: the engine degraded to dense")
    return {g.rid: g.tokens for g in done}, stats, records, log.slots


def fresh_tokens(eng, mods, prompt, n_new, key):
    """One request on a fresh engine over the same weights (no warm-up, no
    slot used before): its tokens."""
    from repro_torch.serve.engine import ServeEngine
    fresh = ServeEngine(eng.cfg, eng.params, batch_slots=eng.B,
                        kv_len=eng.kv_len, prefill_chunk=eng.prefill_chunk,
                        device=eng.device)
    done, stats, _ = serve(fresh, mods, [(prompt, n_new)], keep_logits=False,
                           warm=False)
    check_run(key, done, stats, [(prompt, n_new)])
    del fresh
    return done[0].tokens


def active_positions(records):
    """{position: (input token, logits row)} of the one request a run fed
    (``active_row`` of each step)."""
    out = {}
    for rec in records:
        tokens, tv, pos, logits = active_row(rec)
        for t in range(tv):
            out[pos + t] = (int(tokens[t]), logits[t])
    return out


def long_state_check(eng, mods, key):
    """One ``RECURRENT_LONG_PROMPT``-token prompt and 8 new tokens, served
    at prefill chunk 8 (the block-parallel WKV/SSD form, inner chunks of
    4) and at chunk 1 (the scan) on engines over the same weights: every
    position both runs fed the same token held by the margin rule
    (``hold_logits``), the last prompt position's logits among them, and
    the greedy tokens up to the first low-margin divergence."""
    from repro_torch.serve.engine import ServeEngine
    n = RECURRENT_LONG_PROMPT
    req = [(np.random.default_rng(3).integers(0, eng.cfg.vocab, n).tolist(),
            8)]
    runs = {}
    for chunk in (8, 1):
        e = ServeEngine(eng.cfg, eng.params, batch_slots=eng.B,
                        kv_len=n + 64, prefill_chunk=chunk,
                        device=eng.device)
        done, stats, records = serve(e, mods, req, keep_logits=True,
                                     warm=False)
        check_run(key, done, stats, req)
        runs[chunk] = (done[0].tokens, stats, active_positions(records))
        del e, records
    a, b = runs[8][2], runs[1][2]
    worst, n_margin, n_pos = 0.0, 0, 0
    for p in sorted(a):
        if p not in b or a[p][0] != b[p][0]:
            break
        rel, margin = hold_logits(a[p][1], b[p][1], f"{key}: chunk 8 vs "
                                  f"chunk 1, position {p}")
        worst, n_margin, n_pos = max(worst, rel), n_margin + margin, n_pos + 1
    check(n_pos >= n and n_margin > 0, f"{key}: the chunkings agreed on "
          f"{n_pos} positions ({n_margin} of high margin)")
    return dict(prompt_tokens=n, compared_positions=n_pos,
                margin_positions=n_margin, max_rel_logit_err=worst,
                last_prompt_rel_err=float(
                    np.abs(a[n - 1][1] - b[n - 1][1]).max()
                    / np.abs(b[n - 1][1]).max()),
                tokens_chunk8=runs[8][0], tokens_chunk1=runs[1][0],
                steps={c: r[1]["steps"] for c, r in runs.items()},
                wall_s={c: r[1]["wall_s"] for c, r in runs.items()})


def in_proj_cost(eng, flush):
    """zamba2's dense f32 ``in_proj`` at a decode step (x 4 x 2560 bf16):
    one call as the layer makes it (``torch.einsum`` on ``w.to(bf16)``:
    the cast reads 107 MB of f32 and writes the bf16 copy), the cast alone
    and the matmul on a bf16 copy made beforehand; per step x 54."""
    K, N, per_step = ZAMBA_IN_PROJ
    w = eng.params["mamba"]["in_proj"][0, 0]
    from repro_torch.core.tensor_format import PackedTensor
    check(not isinstance(w, PackedTensor) and
          tuple(w.shape) == (K, N) and w.dtype == torch.float32,
          f"in_proj {type(w)} {tuple(w.shape)}: expected dense f32")
    x = torch.randn(4, 1, K, device=w.device).to(torch.bfloat16)
    wb = w.to(torch.bfloat16)
    call = time_ms(lambda: torch.einsum("btd,de->bte", x, w.to(x.dtype)),
                   flush)
    cast = time_ms(lambda: w.to(torch.bfloat16), flush)
    mm = time_ms(lambda: torch.einsum("btd,de->bte", x, wb), flush)
    nbytes = K * N * 4 + K * N * 2 * 2 + 4 * K * 2 + 4 * N * 2
    return dict(K=K, N=N, launches_per_step=per_step, call_ms=call,
                cast_ms=cast, matmul_bf16_ms=mm,
                per_step_ms=call * per_step,
                bytes_per_call=nbytes,
                bound_ms_per_call=bound_ms(nbytes, 2 * 4 * K * N))


def recurrent_phase(arch, dev, mods, fmts):
    """``arch`` (rwkv6-1.6b or zamba2-2.7b) full, babsmax64:n4 packed
    (seeded weights drawn and packed one leaf at a time, each as the
    family's ``init`` makes it), 4 slots, kv_len 256, chunk 8, one run per
    KV format of ``fmts`` (rwkv6 has no KV cache): the six requests of
    ``recurrent_requests``, with the launches of ``LAUNCHES_PER_STEP``
    every step; r5 (r1's prompt, in a reused slot) against the same prompt
    on a fresh engine, token for token; the whole run served a second time
    on the same engine, every step's logits bit for bit; weight, KV and
    recurrent-state bytes; a profile; the prefill step and first decode
    step held to the CPU plain path at full depth (a quantised cache: on
    the card's own cache, with the K/V witness). Then the long-state check
    (``long_state_check``) and ``launch.serve`` from the command line."""
    from repro_torch.serve.engine import ServeEngine
    t_phase = time.monotonic()
    torch.cuda.reset_peak_memory_stats(dev)
    eng, setup_s = build_engine(arch, dev, kv_len=256)
    setup = {"setup_s": setup_s,
             "setup_peak_mem_bytes": torch.cuda.max_memory_allocated(dev)}
    wb = eng.weight_bytes()
    check({k: wb[k] for k in WEIGHT_BYTES[arch]} == WEIGHT_BYTES[arch],
          f"{arch} weight_bytes {wb} != {WEIGHT_BYTES[arch]}")
    cfg = eng.cfg
    reqs, order = recurrent_requests(cfg.vocab)
    runs, extra = [], {}
    if arch == ZAMBA_ARCH:
        flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
        extra["dense_in_proj"] = in_proj_cost(eng, flush)
        del flush
    for fmt in fmts:
        key = arch if fmt == "dense" else f"{arch} {fmt}"
        if fmt != "dense":
            t0 = time.monotonic()
            eng = ServeEngine(cfg.replace(kv_format=fmt), eng.params,
                              batch_slots=4, kv_len=256, prefill_chunk=8,
                              device=dev)
            setup = {"engine_s": time.monotonic() - t0}
        torch.cuda.reset_peak_memory_stats(dev)
        tokens, stats, records, slots = recurrent_run(
            eng, mods, reqs, order, key,
            cache_decodes=1 if fmt != "dense" else 0)
        check(tokens[5] == tokens[1] and slots[5] != slots[1],
              f"{key}: r5 (r1's prompt, slot {slots[5]}) gave {tokens[5]}, "
              f"r1 (slot {slots[1]}) {tokens[1]}")
        fresh = fresh_tokens(eng, mods, reqs[1][0], reqs[1][1], key)
        check(fresh == tokens[5], f"{key}: r5 in a reused slot gave "
              f"{tokens[5]}, a fresh engine {fresh}")
        again, stats2, records2, _ = recurrent_run(eng, mods, reqs, order,
                                                   key)
        check(again == tokens and len(records2) == len(records) and all(
            torch.equal(a["logits"], b["logits"])
            for a, b in zip(records, records2)),
              f"{key}: the second run differs from the first")
        del records2
        cb = eng.cache_bytes()
        check(cb["kv"] == RECURRENT_KV_BYTES[arch][fmt] and
              cb["other"] == RECURRENT_OTHER_BYTES[arch],
              f"{key}: cache bytes {cb['kv']} + {cb['other']}")
        out = dict(phase="recurrent", arch=arch, kv_format=fmt, **setup,
                   weight_bytes=wb, kv_bytes=cb["kv"],
                   state_bytes=cb["other"], slots=slots,
                   peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
                   repeat_bitwise=True, fresh_slot_tokens_equal=True,
                   step_tokens=[r["T"] for r in records], **stats,
                   **extra)
        emit(phase="profile", arch=arch, kv_format=fmt,
             **profile_steps(eng, mods))
        records = records[:2]
        check(records[0]["T"] > 1 and records[-1]["T"] == 1,
              f"{key}: the compare needs the prefill and a decode step")
        t0 = time.monotonic()
        if fmt == "dense":
            worst, n = compare_with_cpu(eng, records)
        else:
            kv = dict(codes=0, differ=0, max_codepoints=0,
                      max_scale_rel=0.0)
            worst, n = compare_with_cpu(eng, records, card_cache=True,
                                        kv_stats=kv)
            out["cpu_kv_witness"] = hold_kv_witness(
                kv, bits=4 if fmt == "q4" else 8)
        out.update(cpu_max_rel_logit_err=worst, cpu_margin_tokens=n,
                   cpu_compared_steps=len(records),
                   cpu_compared_layers=cfg.n_layers,
                   cpu_compare_s=time.monotonic() - t0, tokens=tokens)
        del records
        if fmt == "dense":
            out["long_state"] = long_state_check(eng, mods, key)
        emit(**out)
        runs += [stats, stats2]
        emit(phase="timing", recurrent_run_end_s=time.monotonic() - t_phase,
             arch=arch, kv_format=fmt)
    del eng
    torch.cuda.empty_cache()
    runs.append(recurrent_cli(arch, mods, fmts[-1]))
    emit(phase="timing", recurrent_cli_end_s=time.monotonic() - t_phase,
         arch=arch)
    return runs


def recurrent_cli(arch, mods, fmt):
    """``launch.serve --arch <arch> --variant full --quantise babsmax64:n4
    --packed --no-dense-fallback`` (zamba2 with ``--kv-format q8``): 4
    requests of 8 new tokens, each step with the launches of
    ``LAUNCHES_PER_STEP``, the resident weight bytes of ``WEIGHT_BYTES``.
    Returns the run's launches."""
    from repro_torch.launch import serve as serve_cli
    key, steps = (arch if fmt == "dense" else f"{arch} {fmt}"), 8
    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    argv = ["--arch", arch, "--variant", "full", "--quantise", SPEC,
            "--packed", "--kv-len", "256", "--requests", "4", "--max-new",
            str(steps), "--no-dense-fallback", "--device", "cuda"]
    if fmt != "dense":
        argv += ["--kv-format", fmt]
    (done, text), launches = served(mods, lambda: quiet(serve_cli.main,
                                                        argv))
    check(len(done) == 4 and all(len(g.tokens) == steps and not g.failed
                                 for g in done),
          f"serve --arch {arch}: requests did not all finish")
    check_packed_steps(launches, text, steps=steps,
                       per_step=LAUNCHES_PER_STEP[key]["dequant_matmul"],
                       unembed=False, what=f"serve --arch {arch}")
    for name in ("block_quant", "decode_attention_quant"):
        want = LAUNCHES_PER_STEP[key].get(name, 0) * steps
        check(launches[name] == want, f"serve --arch {arch}: {name} "
              f"launched {launches[name]} times, expected {want}")
    wb = WEIGHT_BYTES[arch]
    check(f"{wb['codes']:,} codes + {wb['scales']:,} scales" in text and
          f"{wb['dense']:,} dense bytes" in text,
          f"serve --arch {arch}: weight bytes differ: {text[:600]}")
    emit(phase="recurrent", step="cli", arch=arch, kv_format=fmt,
         s=time.monotonic() - t0,
         peak_mem_bytes=torch.cuda.max_memory_allocated(),
         launches=launches,
         report=[ln for ln in text.splitlines() if ln.startswith("[serve]")],
         tokens={g.rid: g.tokens for g in done})
    del done
    torch.cuda.empty_cache()
    return {"launches": launches}


# ---------------------------------------------------------------------------
# Phase 14: the multi-device layer on a world of one rank

# gemma3-1b's long_500k global layer: one sequence, 4 query heads over 1 KV
# head of 256, bf16 (256 MiB each for K and V); split into 16 slices of 32k
CP_SHAPE = dict(B=1, S=524_288, H=4, K=1, hd=256)
CP_SLICES = 16
EP_TOKENS = (4, 8)                # qwen2-moe-a2.7b's block at B = 4, T = 8
SHARDED_ARCH = "gemma3-1b"        # its (d_model, d_ff) MLP leaf: 8M elements


def multidevice_phase(dev, mods):
    """The multi-device layer on an NCCL world of one rank on the card
    (the machine has one GPU; NCCL refuses two ranks on one):
    ``cp_decode_attention`` at gemma3-1b's long_500k global-layer shape
    against ``layers.decode_attention`` (within 1e-2 of max|out|), and 16
    slices' partials combined against the one-shard result in f32 (within
    1e-5 of max|out|), at the last position and at one in the first slice
    (15 slices fully masked); ``moe_block_ep`` at qwen2-moe-a2.7b's
    full-width block with dense bf16 stacks equal to ``_moe_block_local``
    (out and aux); the same block packed under ``set_ep_mesh`` takes the
    local path, whose 3 lead-dim ``dequant_matmul`` launches are counted.
    The world is destroyed when the phase ends. Returns the phase's run
    (its launches). Then, on a line of its own, the training state on
    DTensors (``sharded_state_check``)."""
    import torch.distributed as dist
    t0 = time.monotonic()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        cp = cp_check(dev)
        ep, launches = ep_check(dev, mods)
        t1 = time.monotonic()
        state = sharded_state_check(dev)
        state_s = time.monotonic() - t1
    finally:
        dist.destroy_process_group()
    emit(phase="multidevice", world="nccl, 1 rank", s=time.monotonic() - t0,
         context_parallel=cp, expert_parallel=ep)
    emit(phase="multidevice", part="sharded_state", s=state_s, **state)
    return [{"launches": launches}]


def sharded_state_check(dev):
    """8-bit Adam on DTensors and a sharded restore, on the world's mesh
    of one rank: gemma3-1b's (d_model, d_ff) MLP leaf with its last dim
    sharded (so the moments' block-count dim is sharded too), 3 steps of
    ``adam_update(quantised_state=True)``, equal bit for bit to the plain
    update of the same tensors (params, and the moments' codes and
    scales); then that state saved and restored with
    ``restore_checkpoint(shardings=)`` onto its first dim: ``full_tensor()``
    equal bit for bit to the saved arrays, and the moments requantised
    through the template equal to an unsharded restore's."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    from repro_torch import configs
    from repro_torch.launch.mesh import NamedSharding
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import (AdamConfig, adam_init,
                                             adam_update)
    t0 = time.monotonic()
    cfg = configs.get_config(SHARDED_ARCH, "full")
    shape = (cfg.d_model, cfg.d_ff)
    gen = torch.Generator(device=dev).manual_seed(2)
    w = torch.randn(shape, generator=gen, device=dev)
    grads = [torch.randn(shape, generator=gen, device=dev) for _ in range(3)]
    acfg = AdamConfig(quantised_state=True)
    mesh = init_device_mesh(dev.type, (1,), mesh_dim_names=("model",))
    p, o = {"w": w}, adam_init({"w": w}, acfg)
    pd = {"w": distribute_tensor(w, mesh, [Shard(1)])}
    od = adam_init(pd, acfg)
    for g in grads:
        p, o = adam_update({"w": g}, o, p, 1e-3, acfg)
        pd, od = adam_update({"w": distribute_tensor(g, mesh, [Shard(1)])},
                             od, pd, 1e-3, acfg)
    pairs = [("params", pd["w"], p["w"])] + [
        (f"{k}.{f}", getattr(od[k]["w"], f), getattr(o[k]["w"], f))
        for k in ("m", "v") for f in ("codes", "scales")]
    for name, got, want in pairs:
        check(isinstance(got, DTensor) and got.placements == (Shard(1),)
              and torch.equal(got.full_tensor(), want),
              f"8-bit Adam on DTensors: {name} differs from the plain "
              "update")
    torch.cuda.synchronize()
    adam_s = time.monotonic() - t0

    t0 = time.monotonic()
    root = Path(__file__).resolve().parent / "runs" / "chip_smoke_sharded"
    shutil.rmtree(root, ignore_errors=True)
    try:
        path = ckpt.save_checkpoint(str(root), {"params": pd, "opt": od}, 3)
        rows = NamedSharding(mesh, (Shard(0),))
        shardings = {"params": {"w": rows},
                     "opt": {"m": {"w": rows}, "v": {"w": rows},
                             "step": NamedSharding(mesh, (Replicate(),))}}
        back, _ = ckpt.restore_checkpoint(path, shardings=shardings)
        with np.load(os.path.join(path, "arrays.npz")) as npz:
            for key, got in (("params/w", back["params"]["w"]),
                             ("opt/m/w", back["opt"]["m"]["w"]),
                             ("opt/v/w", back["opt"]["v"]["w"])):
                check(got.placements == (Shard(0),)
                      and got.to_local().device == w.device
                      and torch.equal(got.full_tensor().cpu(),
                                      torch.from_numpy(npz[key])),
                      f"sharded restore: {key} differs from the saved array")
        placed, _ = ckpt.restore_checkpoint(
            path, template={"params": pd, "opt": od}, shardings=shardings)
        whole, _ = ckpt.restore_checkpoint(
            path, template={"params": p, "opt": o})
        for k in ("m", "v"):
            for f in ("codes", "scales"):
                check(torch.equal(getattr(placed["opt"][k]["w"],
                                          f).full_tensor(),
                                  getattr(whole["opt"][k]["w"], f)),
                      f"sharded restore: requantised {k}.{f} differs from "
                      "an unsharded restore")
        nbytes = os.path.getsize(os.path.join(path, "arrays.npz"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.synchronize()
    return dict(leaf=f"{SHARDED_ARCH} mlp {shape}", steps=len(grads),
                adam_8bit_dtensor_bitwise=True, adam_s=adam_s,
                sharded_restore_bitwise=True, restore_s=time.monotonic() - t0,
                checkpoint_bytes=nbytes)


def cp_check(dev):
    import torch.distributed as dist
    from repro_torch.models.layers import decode_attention
    from repro_torch.serve.context_parallel import (NEG, combine_partials,
                                                    cp_decode_attention,
                                                    partial_attention)
    B, S, H, K, hd = (CP_SHAPE[n] for n in ("B", "S", "H", "K", "hd"))
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=dev
                           ).to(torch.bfloat16)
               for shape in ((B, 1, H, hd), (B, S, K, hd), (B, S, K, hd)))
    qf, kf, vf = q.float(), k.float(), v.float()
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    S_loc = S // CP_SLICES
    group = dist.group.WORLD
    out = []
    for qpos in (S - 1, S_loc // 2):
        got = cp_decode_attention(q, k, v, qpos, group)
        want = decode_attention(q, k, v, qpos)
        rel = float((got.float() - want.float()).abs().max()
                    / want.float().abs().max())
        check(bool(torch.isfinite(got).all()) and rel <= 1e-2,
              f"cp_decode_attention at q_position {qpos}: {rel} of max|out|")
        parts = [partial_attention(
            qf, kf[:, i * S_loc:(i + 1) * S_loc],
            vf[:, i * S_loc:(i + 1) * S_loc],
            i * S_loc + torch.arange(S_loc, device=dev), qpos)
            for i in range(CP_SLICES)]
        m, l, acc = (torch.stack([p[j] for p in parts]) for j in range(3))
        sliced = combine_partials(m, l, acc)
        one = combine_partials(*(x[None] for x in partial_attention(
            qf, kf, vf, torch.arange(S, device=dev), qpos)))
        rel16 = float((sliced - one).abs().max() / one.abs().max())
        masked = int((m.reshape(CP_SLICES, -1) == NEG).all(1).sum())
        check(bool(torch.isfinite(sliced).all()) and rel16 <= 1e-5,
              f"{CP_SLICES} slices at q_position {qpos}: {rel16} of "
              "max|out|")
        check(masked == (0 if qpos == S - 1 else CP_SLICES - 1),
              f"{masked} fully masked slices at q_position {qpos}")
        out.append(dict(
            q_position=qpos, cp_vs_decode_attention=rel,
            slices_vs_one_shard_f32=rel16, masked_slices=masked,
            cp_ms=time_ms(lambda: cp_decode_attention(q, k, v, qpos, group),
                          flush),
            decode_attention_ms=time_ms(
                lambda: decode_attention(q, k, v, qpos), flush),
            bound_ms=bound_ms(2 * k.numel() * k.element_size(), 0)))
    return out


def ep_check(dev, mods):
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.core import build_plan
    from repro_torch.models import layers
    cfg = configs.get_config(MOE_ARCH, "full")
    D, E, F = cfg.d_model, cfg.n_experts, cfg.dff_expert
    Fs = F * cfg.n_shared_experts
    gen = torch.Generator(device=dev).manual_seed(1)

    def w(*shape):
        return torch.randn(shape, generator=gen, device=dev) \
            / math.sqrt(shape[-2])
    master = layers.MoeParams(
        w(D, E), w(E, D, F), w(E, D, F), w(E, F, D),
        shared=layers.MlpParams(w(D, Fs), w(D, Fs), w(Fs, D)))
    dense = layers.MoeParams(
        *(t.to(torch.bfloat16) for t in master[:4]),
        shared=layers.MlpParams(*(t.to(torch.bfloat16)
                                  for t in master.shared)))
    x = torch.randn(EP_TOKENS + (D,), generator=gen,
                    device=dev).to(torch.bfloat16)
    names = ("w_gate", "w_up", "w_down")
    stacks = {n: getattr(master, n) for n in names}
    packed = build_plan(stacks, SPEC).pack(
        stacks, {f"['{n}']": (1, 1) for n in names})
    pp = dense._replace(**packed)
    with torch.no_grad():
        out_l, probs, choice = layers._moe_block_local(x, dense, cfg)
        aux_l = layers.router_load_balancing_loss(probs, choice, E)
        want_p = layers.moe_block(x, pp, cfg)
        layers.set_ep_mesh(dist.group.WORLD, ())
        try:
            out_e, aux_e = layers.moe_block_ep(x, dense, cfg)
            mods["dequant_matmul"].lead_launches = 0
            ((got_p, text), launches) = served(
                mods, lambda: quiet(layers.moe_block, x, pp, cfg))
            lead = mods["dequant_matmul"].lead_launches
        finally:
            layers.set_ep_mesh(None, ())
    check(torch.equal(out_e, out_l) and torch.equal(aux_e, aux_l),
          "moe_block_ep on one rank differs from _moe_block_local: "
          f"{float((out_e.float() - out_l.float()).abs().max())}, aux "
          f"{float(aux_e)} vs {float(aux_l)}")
    check("falls back to local" in text,
          f"packed stacks under set_ep_mesh: no fallback message: {text!r}")
    check(launches["dequant_matmul"] == 3 and lead == 3,
          f"packed EP layer: {launches} launches, {lead} with a lead dim")
    check(all(torch.equal(a, b) for a, b in zip(got_p, want_p)),
          "the packed layer under set_ep_mesh differs from the local path")
    return (dict(tokens=EP_TOKENS[0] * EP_TOKENS[1], experts=E, top_k=
                 cfg.experts_per_token, out_equal=True, aux=float(aux_e),
                 max_abs_out=float(out_e.float().abs().max()),
                 packed_launches=launches, packed_lead_launches=lead),
            launches)


# ---------------------------------------------------------------------------
# Phase 15: the reference's example entry points, in the port


EXAMPLES = Path(__file__).resolve().parent / "examples"
# the reference's numbers at full precision (examples/quickstart.py and
# examples/format_design.py's calls, JAX on the CPU; tests/
# test_torch_examples.py holds these pins to them): per format (bits/param,
# R); per scaling (bits/param, R, R·2^b); the ν search (ν, scale
# multiplier, R); per grid target (measured bits, R, R·2^b, Huffman bits)
QUICKSTART_REF = dict(
    formats={"babsmax128:t4": (4.125, 0.09716586023569107),
             "trms:t4": (4.000244140625, 0.11586100608110428),
             "trms:t4:sp0.001": (4.048244140625, 0.11473309993743896),
             "bsignmax128:t4": (4.125, 0.10499599575996399)},
    model_bits=5.297718419588203,
    codebook=[-1.0, -0.7047783136367798, -0.5230731964111328,
              -0.3913331925868988, -0.28597646951675415, -0.19577556848526,
              -0.11438539624214172, -0.037643104791641235,
              0.037643104791641235, 0.11438539624214172, 0.19577556848526,
              0.28597646951675415, 0.3913331925868988, 0.5230731964111328,
              0.7047783136367798, 1.0])
FORMAT_DESIGN_REF = dict(
    scaling={"trms:t4nu5": (4.00006103515625, 0.14509913325309753,
                            2.3216843519544703),
             "tabsmax:t4nu5": (4.00006103515625, 0.21155808866024017,
                               3.3850726255898613),
             "cabsmax:t4nu5": (4.00006103515625, 0.21155808866024017,
                               3.3850726255898613),
             "babsmax128:t4nu5": (4.125, 0.11162444949150085,
                                  1.9476372051997468),
             "bsignmax128:t4nu5": (4.125, 0.11417784541845322,
                                   1.9921891732461072),
             "trms:t4nu5:sp0.001": (4.04806103515625, 0.13162975013256073,
                                    2.1774182205279673)},
    nu=(5.67555451222336, 1.0, 0.14295311272144318),
    grid={3.0: (2.9968379747998637, 0.14446793496608734,
                1.1532131542153545, 3.0458717346191406),
          4.0: (3.993908901367775, 0.07151111215353012,
                1.1393572273953751, 4.024711608886719)})
# examples/train_quantise_serve.py at its defaults (JAX on the CPU): the
# served bits/param on paper-100m small's shapes, and the paper's two
# claims as ratios of its printed KLs (allocated 0.00194 / flat 0.00386;
# after QAT 0.01239 / int3 direct cast 0.02790)
TQS_REF = dict(bits_served=4.132217494974052,
               allocated_over_flat=0.00194 / 0.00386,
               qat_over_int3=0.01239 / 0.02790)


def load_example(name):
    """``examples/<name>_torch.py`` as a module (the folder is no
    package)."""
    path = EXAMPLES / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def hold_rel(got, want, tol, what):
    """``got`` within ``tol`` of ``want``, relative; returns the error."""
    rel = abs(got - want) / abs(want)
    check(rel <= tol, f"{what}: {got} against the reference's {want} "
          f"(relative {rel} > {tol})")
    return rel


def run_example(mods, mod, argv):
    """``mod.main(argv)`` of a loaded example, its printout captured, with
    every kernel's launch count set to 0 just before it and read just after
    it. Returns (the numbers ``main`` returned, its printout, launches,
    seconds)."""
    t0 = time.monotonic()
    (res, text), launches = served(mods, lambda: quiet(mod.main, argv))
    return res, text, launches, time.monotonic() - t0


def examples_phase(dev, mods):
    """The three ``examples/*_torch.py`` through their ``main(["--device",
    "cuda"])``, each held to the reference's numbers: quickstart's and
    format_design's bits/param within 1e-9 and R and R·2^b within 1e-3
    relative, ν, the exact packed round trip and the codebook;
    train_quantise_serve at its defaults (150 steps, 40 QAT steps, seq 128,
    batch 8): the loss falls, the allocation averages 4.000 bits within
    1e-3 in [2, 8], the allocated plan's direct-cast KL below the flat
    one's and the KL after QAT below the int3 direct cast's (the paper's
    claims), the served bits/param the reference's within 1e-9; its packed
    engine (babsmax128:t4: a Student-t codebook, 128-wide blocks) launches
    ``dequant_matmul`` 31 times a step, and its served steps are held to
    the CPU plain path on the same packed weights. Returns the launches of
    the three runs."""
    runs = []
    q, text, launches, secs = run_example(mods, load_example("quickstart"),
                                          ["--device", "cuda"])
    ref = QUICKSTART_REF
    check(list(q["formats"]) == list(ref["formats"]),
          f"quickstart formats {list(q['formats'])}")
    r_err = {spec: hold_rel(q["formats"][spec]["R"], r, 1e-3,
                            f"quickstart {spec} R")
             for spec, (_, r) in ref["formats"].items()}
    for spec, (bits, _) in ref["formats"].items():
        hold_rel(q["formats"][spec]["bits"], bits, 1e-9,
                 f"quickstart {spec} bits/param")
    hold_rel(q["model_bits"], ref["model_bits"], 1e-9,
             "quickstart model bits/param")
    check(q["round_trip"] == 0.0,
          f"quickstart packed round trip {q['round_trip']}")
    check(q["codebook"] == ref["codebook"],
          f"quickstart codebook {q['codebook']}")
    check(not any(launches.values()), f"quickstart launched {launches}")
    emit(phase="examples", example="quickstart", s=secs, **q,
         R_rel_err=r_err, report=text.splitlines())
    runs.append({"launches": launches})

    f, text, launches, secs = run_example(
        mods, load_example("format_design"), ["--device", "cuda"])
    ref = FORMAT_DESIGN_REF
    check(list(f["scaling"]) == list(ref["scaling"]),
          f"format_design scalings {list(f['scaling'])}")
    errs = {}
    for spec, (bits, r, r2b) in ref["scaling"].items():
        got = f["scaling"][spec]
        hold_rel(got["bits"], bits, 1e-9, f"format_design {spec} bits")
        errs[spec] = [hold_rel(got["R"], r, 1e-3, f"format_design {spec} R"),
                      hold_rel(got["R_2b"], r2b, 1e-3,
                               f"format_design {spec} R·2^b")]
    nu, mult, r = ref["nu"]
    check(f["nu"]["nu"] == nu and round(nu, 1) == 5.7 and
          f["nu"]["scale_mult"] == mult,
          f"format_design ν search {f['nu']} against the reference's "
          f"{ref['nu']}")
    errs["nu_R"] = hold_rel(f["nu"]["R"], r, 1e-3, "format_design ν's R")
    for target, (bits, r, r2b, huff) in ref["grid"].items():
        got = f["grid"][target]
        hold_rel(got["bits"], bits, 1e-9, f"grid@{target} bits")
        hold_rel(got["huffman_bits"], huff, 1e-9,
                 f"grid@{target} Huffman bits")
        errs[f"grid@{target}"] = [
            hold_rel(got["R"], r, 1e-3, f"grid@{target} R"),
            hold_rel(got["R_2b"], r2b, 1e-3, f"grid@{target} R·2^b")]
    check(not any(launches.values()), f"format_design launched {launches}")
    emit(phase="examples", example="format_design", s=secs, **f,
         rel_err=errs, report=text.splitlines())
    runs.append({"launches": launches})

    runs.append(train_quantise_serve_example(dev, mods))
    return runs


def train_quantise_serve_example(dev, mods):
    """The §4 pipeline example at its defaults (``examples_phase``)."""
    from repro_torch.core.tensor_format import PackedTensor
    mod = load_example("train_quantise_serve")
    engine_cls, served_by = mod.ServeEngine, {}

    class Recorded:
        """The example's ``ServeEngine``, whose ``from_quantised`` engine
        records its steps (``StepRecorder``)."""
        @staticmethod
        def from_quantised(*args, **kw):
            eng = engine_cls.from_quantised(*args, **kw)
            rec = StepRecorder(eng.fam.decode_step, keep_logits=True)
            eng.fam = dataclasses.replace(eng.fam, decode_step=rec)
            served_by.update(engine=eng, recorder=rec)
            return eng
    mod.ServeEngine = Recorded
    torch.cuda.reset_peak_memory_stats(dev)
    r, text, launches, secs = run_example(mods, mod, ["--device", "cuda"])
    eng, rec = served_by["engine"], served_by["recorder"]
    eng.fam = dataclasses.replace(eng.fam, decode_step=rec.step)
    records = rec.records
    what = "train_quantise_serve"
    check(r["losses"][1] < r["losses"][0], f"{what}: loss {r['losses']}")
    alloc = r["allocation"]
    check(abs(r["average_bits"] - 4.0) <= 1e-3 and
          all(2.0 <= b <= 8.0 for b in alloc.values()),
          f"{what}: allocation averages {r['average_bits']} bits, spread "
          f"{min(alloc.values())}-{max(alloc.values())}")
    check(r["kl_allocated"] < r["kl_flat"], f"{what}: the allocated plan's "
          f"KL {r['kl_allocated']} is not below the flat plan's "
          f"{r['kl_flat']}")
    check(r["kl_qat"] < r["kl_int3"], f"{what}: KL after QAT {r['kl_qat']} "
          f"is not below the int3 direct cast's {r['kl_int3']}")
    bits_err = hold_rel(r["bits_served"], TQS_REF["bits_served"], 1e-9,
                        f"{what}: served bits/param")
    check(sorted(r["tokens"]) == [0, 1, 2, 3] and
          all(len(t) == 8 for t in r["tokens"].values()),
          f"{what}: served {r['tokens']}")
    check(not eng.degraded, f"{what}: the engine degraded to dense")
    dense = [n for n, x in flat_with_paths(eng.params)
             if not isinstance(x, PackedTensor) and x.ndim >= 2
             and x.numel() >= 4096]
    check(dense == EXAMPLE_UNPACKED, f"{what}: planned tensors served "
          f"dense {dense}, expected {EXAMPLE_UNPACKED}")
    steps = eng.steps_total
    per_step = LAUNCHES_PER_STEP["paper-100m-small"]
    want = {k: per_step.get(k, 0) * steps for k in mods}
    check(launches == want, f"{what}: launches {launches} over {steps} "
          f"steps, expected {want}")
    t0 = time.monotonic()
    worst, n = compare_with_cpu(eng, records)
    emit(phase="examples", example=what, s=secs, spec=EXAMPLE_SPEC,
         peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
         losses=r["losses"], average_bits=r["average_bits"],
         min_bits=min(alloc.values()), max_bits=max(alloc.values()),
         kl_flat=r["kl_flat"], kl_allocated=r["kl_allocated"],
         kl_int3=r["kl_int3"], kl_qat=r["kl_qat"],
         allocated_over_flat=r["kl_allocated"] / r["kl_flat"],
         qat_over_int3=r["kl_qat"] / r["kl_int3"],
         reference_allocated_over_flat=TQS_REF["allocated_over_flat"],
         reference_qat_over_int3=TQS_REF["qat_over_int3"],
         bits_served=r["bits_served"], bits_rel_err=bits_err,
         dense_planned=dense, steps=steps, launches=launches,
         launches_per_step=per_step,
         decode_ms_per_step=1e3 * float(np.median(
             [x["s"] for x in records if x["T"] == 1])),
         cpu_max_rel_logit_err=worst, cpu_margin_tokens=n,
         cpu_compared_steps=len(records),
         cpu_compare_s=time.monotonic() - t0, tokens=r["tokens"],
         report=text.splitlines())
    del eng, records
    torch.cuda.empty_cache()
    return {"launches": launches}


def timed_apply(apply, params, batch, cfg, dev):
    """``apply`` on ``batch`` (numpy) moved to ``dev``, under inference
    mode; returns (logits, seconds, the device synchronised)."""
    b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    t0 = time.monotonic()
    with torch.inference_mode():
        logits = apply(params, b, cfg)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return logits, time.monotonic() - t0


# ---------------------------------------------------------------------------
# Phase 16: training, QAT and the weight Fisher of the other families

# (arch, layers of the train run, layers of the card-vs-CPU holds). A train
# step holds f32 weights, gradients and two Adam moments (16 B a parameter)
# and, while ``adam_update`` runs, the new weights and moments (12 B more)
# and each leaf's f32 temporaries: whisper and rwkv6 fit whole (44 and 47
# GB); zamba2 fits in 36 of its 54 layers (the 54-layer update asked for
# more than 80 GB: its stacked in_proj alone is 5.8 GB a copy), qwen2-moe
# in 2 (61 GB; 4 layers about 88), internvl2-26b in 1 (at 2 it peaked at
# 64-70 GB alone and ran out of memory late in the script). zamba2's hold
# is one group of 6 Mamba-2 layers and its shared block.
FAMILY_TRAIN = ((WHISPER_ARCH, None, 2), (RWKV_ARCH, None, 2),
                (ZAMBA_ARCH, 36, 6), (MOE_ARCH, 2, 2),
                (INTERNVL_ARCH, 1, 2))
FAMILY_TRAIN_STEPS = 3
FAMILY_TRAIN_SEQ = 256            # B = 1; whisper's 1500 frames, internvl's
                                  # 256 patches besides
# qwen2-moe's bitwise resume: 1 layer at full width (its state is 14.3 GB;
# two copies and a step's temporaries fit beside each other)
MOE_RESUME_LAYERS = 1
FAMILY_QAT_SPEC = "babsmax64:int4"
# intra-op threads of the thread that drives the card in the phase (its
# host work is copies); the worker making the holds' CPU side takes the
# rest, so that the two never ask for more threads than the host has cores
FAMILY_DRIVER_THREADS = 1
KV_AUTO_ARCHS = (WHISPER_ARCH, ZAMBA_ARCH)
# the card's sides of the holds hand their CPU sides to the worker in this
# order: the shortest card side first, so that the worker starts at once,
# then the longest CPU sides, so that the worker always has the next job
# queued while the card trains and serves between holds (one run of the
# script on an NVIDIA H100 80GB HBM3 and its 8-core host: card sides of
# 1.8, 25.3, 26.0, 10.8 and 6.4 s, CPU sides of 22.8, 91.9, 62.1, 33.5 and
# 17.0 s, in this order)
FAMILY_HOLD_ORDER = (WHISPER_ARCH, INTERNVL_ARCH, MOE_ARCH, ZAMBA_ARCH,
                     RWKV_ARCH)


def hold_config(cfg, layers):
    """``cfg`` at full width and ``layers`` layers (whisper's encoder cut
    alike), computing in f32 (the holds' bounds, 1e-4 and 1e-3, are f32's)
    with no rematerialisation (the same values, one forward fewer)."""
    kw = dict(n_layers=layers, dtype="float32", remat="none")
    if cfg.family == "whisper":
        kw["n_enc_layers"] = layers
    return cfg.replace(**kw)


class ThreadHooks:
    """Stand-ins for ``train.loop.adam_update`` and
    ``core.fisher._sample_labels`` for the phase, each acting for the
    thread that armed it alone (the CPU side of the holds runs on a worker
    thread while the card trains): ``spy`` keeps the gradients a step hands
    the update and skips it; ``labels`` draws the labels of a logits shape
    on the CPU from numpy, the same on either device. Other threads get
    the originals."""

    def __init__(self):
        import threading
        from repro_torch.core import fisher
        from repro_torch.train import loop
        self.local = threading.local()
        self.loop, self.fisher = loop, fisher
        self.update, self.sample = loop.adam_update, fisher._sample_labels

    def __enter__(self):
        self.loop.adam_update = self._update
        self.fisher._sample_labels = self._sample
        return self

    def __exit__(self, *exc):
        self.loop.adam_update = self.update
        self.fisher._sample_labels = self.sample

    def _update(self, grads, opt_state, params, *a, **kw):
        seen = getattr(self.local, "grads", None)
        if seen is None:
            return self.update(grads, opt_state, params, *a, **kw)
        seen.append(grads)
        return params, opt_state

    def _sample(self, logits, generator):
        seed = getattr(self.local, "seed", None)
        if seed is None:
            return self.sample(logits, generator)
        shape = tuple(logits.shape[:-1])
        y = np.random.default_rng(seed).integers(0, logits.shape[-1], shape)
        return torch.from_numpy(y).to(logits.device)

    def spied_step(self, step, *args):
        """``step(*args)`` stopped at ``adam_update``: (its metrics as
        floats, the clipped gradients it hands the update). What the holds
        compare comes before the update, which (a)'s runs make."""
        self.local.grads = []
        try:
            _, m = step(*args)
            return ({k: float(v) for k, v in m.items()},
                    self.local.grads[0])
        finally:
            self.local.grads = None

    def pinned(self, fn, seed):
        self.local.seed = seed
        try:
            return fn()
        finally:
            self.local.seed = None


def family_batch(cfg, dev, step=0):
    """``make_batch_fn``'s batch ``step`` of B = 1, T = ``FAMILY_TRAIN_SEQ``
    (with whisper's frames or internvl's patches) on ``dev``."""
    from repro_torch.data.pipeline import make_batch_fn
    b = make_batch_fn(cfg, seq=FAMILY_TRAIN_SEQ, batch=1, seed=0)(step)
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def train_run(arch, layers, dev):
    """(a): ``FAMILY_TRAIN_STEPS`` CE steps of ``arch`` under deterministic
    algorithms, through ``launch.train`` at full depth (``layers`` None) or
    ``train.loop.train`` at ``layers`` layers; s a step, peak device bytes
    beside 16 and 28 B a parameter, the ops without a deterministic CUDA
    form."""
    from repro_torch import configs
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.launch import train as train_cli
    from repro_torch.models.api import count_params, get_family
    from repro_torch.train import AdamConfig, TrainConfig, train
    cfg = configs.get_config(arch, "full")
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    n_params = count_params(get_family(cfg.family).param_specs(cfg))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    if layers is None:
        ((state, hist), _), nondet = deterministic_runs(lambda: quiet(
            train_cli.main, [
                "--arch", arch, "--variant", "full", "--steps",
                str(FAMILY_TRAIN_STEPS), "--batch", "1", "--seq",
                str(FAMILY_TRAIN_SEQ), "--log-every", "1", "--seed", "0",
                "--device", "cuda"]))
    else:
        tc = TrainConfig(steps=FAMILY_TRAIN_STEPS, lr=3e-3, warmup=10,
                         log_every=1, seed=0)
        (state, hist), nondet = deterministic_runs(lambda: train(
            cfg, tc, AdamConfig(), make_batch_fn(
                cfg, seq=FAMILY_TRAIN_SEQ, batch=1, seed=0), device=dev))
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    del state
    torch.cuda.empty_cache()
    losses = [h["loss"] for h in hist]
    check(len(losses) == FAMILY_TRAIN_STEPS and
          all(np.isfinite(v) for v in losses + [h["grad_norm"]
                                                for h in hist]),
          f"{arch} train: losses {losses}")
    return dict(layers=cfg.n_layers, params=n_params, losses=losses,
                grad_norms=[h["grad_norm"] for h in hist],
                s_per_step=[h["s_per_step"] for h in hist], run_s=secs,
                peak_mem_bytes=peak,
                state_bytes_16=16 * n_params, update_bytes_28=28 * n_params,
                nondeterministic_ops=nondet)


def moe_resume(dev):
    """(b): qwen2-moe at ``MOE_RESUME_LAYERS`` layers of full width under
    deterministic algorithms: two CE steps, the state copied to the host
    as a checkpoint holds it (f32 weights and moments, the step), step 3
    from the live state and again from the copy put back on the card: its
    loss, the parameters and both moments bit for bit. The npz round trip
    of this state (14.3 GB) is exact in f32, as the paper-100m resume
    holds, and took 80-89 s on the card's 8-core host, which
    this phase cannot pay; the copy goes to page-locked memory (pageable,
    it took 19 s)."""
    from repro_torch import configs
    from repro_torch.core.plan import map_with_paths
    from repro_torch.train import AdamConfig, TrainConfig, loop
    from repro_torch.train.optimizer import cosine_schedule
    cfg = configs.get_config(MOE_ARCH, "full").replace(
        n_layers=MOE_RESUME_LAYERS)
    step = loop.make_train_step(cfg, AdamConfig(), TrainConfig(),
                                cosine_schedule(3e-3, FAMILY_TRAIN_STEPS, 10))

    def run():
        state = loop.init_state(0, cfg, AdamConfig(), device=dev)
        losses = []
        for i in range(FAMILY_TRAIN_STEPS):
            if i == FAMILY_TRAIN_STEPS - 1:
                saved = map_with_paths(lambda _, x: torch.empty(
                    x.shape, dtype=x.dtype, pin_memory=x.is_cuda).copy_(x),
                    state)
            state, m = step(state, family_batch(cfg, dev, i))
            losses.append(float(m["loss"]))
        back = map_with_paths(lambda _, x: x.to(dev), saved)
        del saved
        again, m = step(back, family_batch(cfg, dev, i))
        del back
        a, b = (dict(flat_with_paths(s)) for s in (state, again))
        same = sum(torch.equal(a[n], b[n]) for n in a)
        return losses, float(m["loss"]), same, len(a)
    t0 = time.monotonic()
    (losses, resumed, same, n), nondet = deterministic_runs(run)
    torch.cuda.empty_cache()
    check(resumed == losses[-1] and same == n and not nondet,
          f"{MOE_ARCH} resume is not bitwise: step 3 loss {resumed} vs "
          f"{losses[-1]}, {same} of {n} tensors equal, nondeterministic "
          f"ops {nondet}")
    return dict(layers=MOE_RESUME_LAYERS, losses=losses,
                resumed_loss=resumed, bitwise=True, equal_tensors=same,
                seconds=time.monotonic() - t0, nondeterministic_ops=nondet)


def hold_side(hooks, hold, params, batch, plan, holds):
    """One device's side of the holds named in ``holds`` on ``params``:
    "ce", one CE ``make_train_step`` (its metrics and clipped gradients, on
    the CPU); "qat", one distillation step of the ``plan`` student against
    the same weights (its KL and gradient norm); "fisher", the Fisher of
    the one sequence and its per-tensor statistics; "kv", the KV Fisher as
    ``launch.serve --kv-format auto`` calls it; labels by
    ``hooks.pinned``. Returns (those, seconds of each)."""
    from repro_torch.core import fisher
    from repro_torch.models.api import get_family
    from repro_torch.train import loop
    from repro_torch.train.optimizer import AdamConfig
    fam = get_family(hold.family)
    dev = flat_with_paths(params)[0][1].device
    secs, t0 = {}, time.monotonic()

    def lap(name):
        nonlocal t0
        if dev.type == "cuda":
            torch.cuda.synchronize()
        secs[name] = time.monotonic() - t0
        t0 = time.monotonic()
    state = {"params": params,
             "opt": {"step": torch.zeros((), dtype=torch.int32, device=dev)}}
    out = {}
    if "ce" in holds:
        ce = loop.make_train_step(hold, AdamConfig(), loop.TrainConfig(),
                                  lambda s: 1e-3)
        out["ce"], grads = hooks.spied_step(ce, state, batch)
        # the clipped gradients are the step's own: on the CPU they are
        # kept as they are, from the card copied to the host
        out["grads"] = {n: g.to("cpu") for n, g in flat_with_paths(grads)}
        del grads
        lap("ce_step")
    if "qat" in holds:
        qat = loop.make_train_step(hold, AdamConfig(b1=0.9, b2=0.95),
                                   loop.TrainConfig(), lambda s: 1e-4,
                                   qat_plan=plan, distill=True)
        out["qat"], _ = hooks.spied_step(qat, state, batch, params)
        lap("qat_step")
    if "fisher" in holds:
        fish = hooks.pinned(lambda: fisher.estimate_diag_fisher(
            lambda p, b: fam.apply(p, b, hold), params, [batch], None), 5)
        out["fisher"] = fisher.per_tensor_stats(params, fish)
        del fish
        lap("fisher")
    if "kv" in holds:
        out["kv"] = hooks.pinned(lambda: fisher.estimate_kv_fisher(
            hold, params, batch_size=2, kv_len=32), 7)
        lap("kv_fisher")
    return out, secs


def packed_leaf_errors(packed, mods, dev):
    """Each packed leaf of an allocated plan (its own width, 2 to 8 bits,
    byte codes above 4), every slice of its lead dims (layers, experts),
    through ``dequant_matmul`` on 256 rows of bf16 and of f32 (the
    tensor-core and the CUDA-core kernel), held to the plain version by
    the kernel phase's rule; returns each leaf's max error ÷ max|y|. Not
    counted."""
    from repro_torch.core.tensor_format import PackedTensor
    from repro_torch.kernels.dequant_matmul import ref
    kern = mods["dequant_matmul"].dequant_matmul_cuda
    gen = torch.Generator(device=dev).manual_seed(11)
    errs = {}
    for name, w in flat_with_paths(packed):
        if not isinstance(w, PackedTensor):
            continue
        lead = w.codes.shape[:-2]
        codes = w.codes.reshape(-1, *w.codes.shape[-2:])
        scales = w.scales.reshape(-1, *w.scales.shape[-2:])
        errs[name] = 0.0
        for i in range(codes.shape[0]):
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn((256, scales.shape[-2]), generator=gen,
                                device=dev).to(dtype)
                args = (x, codes[i].contiguous(), scales[i].contiguous(),
                        w.codebook(), w.block, w.bits)
                y, y_plain = kern(*args), ref.dequant_matmul_ref(*args)
                scale = float(y_plain.float().abs().max())
                torch.testing.assert_close(
                    y.float(), y_plain.float(), rtol=1.6e-2,
                    atol=1e-2 * scale, msg=lambda m: (
                        f"{name} slice {i} of {tuple(lead)} ({w.bits}-bit "
                        f"codes, {tuple(codes.shape[1:])}, {dtype}): {m}"))
                errs[name] = max(errs[name], float(
                    (y.float() - y_plain.float()).abs().max()) / scale)
    return errs


def allocated_apply(hold, dtype, params, stats, batch, mods):
    """(e)'s allocation: the Eq. 5 bits at 4.0 (2 to 8) from the card's
    Fisher, its babsmax64 plan packed (each packed leaf's kernels held to
    their plain version), and one packed ``apply`` against the dense
    ``apply`` over the dequantised weights in each of two compute dtypes:
    the hold's f32 (the CUDA-core kernel), held by the logits rule and the
    top-k KL to the f32 model's within 5%; the served ``dtype`` (the
    tensor-core kernel), held by that KL. In bf16 the logits rule does not
    hold the kernel alone: the dense ``apply`` in bf16 against the same
    in f32 (``bf16_floor_max_rel_logit_err``) shows how far bf16 rounding
    alone moves this model's logits, and is reported beside the packed
    reading."""
    from repro_torch.core import build_allocated_plan, metrics
    from repro_torch.core.allocation import allocate_bits, average_bits
    from repro_torch.core.tensor_format import PackedTensor
    from repro_torch.models.api import get_family
    fam = get_family(hold.family)
    alloc = allocate_bits(stats, target_bits=4.0, b_min=2, b_max=8)
    avg = average_bits(alloc, stats)
    check(abs(avg - 4.0) <= 1e-3, f"{hold.name} allocation averages {avg}")
    plan = build_allocated_plan(params, alloc, "babsmax64")
    qparams = plan.quantise(params)
    served_cfg = hold.replace(dtype=dtype)
    packed = plan.pack_quantised(qparams, fam.pack_layouts(served_cfg))
    deq = plan.dequantise(qparams)
    del qparams
    packed_bits = {n: alloc[n] for n, x in flat_with_paths(packed)
                   if isinstance(x, PackedTensor)}
    check(len(set(round(b, 6) for b in packed_bits.values())) > 1,
          f"{hold.name}: the packed tensors share one width {packed_bits}")
    leaf_err = packed_leaf_errors(packed, mods, batch["tokens"].device)
    out = dict(average_bits=avg, packed_tensors=len(packed_bits),
               packed_bits_min=min(packed_bits.values()),
               packed_bits_max=max(packed_bits.values()),
               packed_widths=sorted(set(round(b, 2)
                                        for b in packed_bits.values())),
               kernel_leaf_max_err=max(leaf_err.values()),
               kernel_leaf_worst=max(leaf_err, key=leaf_err.get))
    with torch.no_grad():
        ref = fam.apply(params, batch, hold)
        dense = {}
        for key, cfg in (("f32", hold), ("served", served_cfg)):
            fam.apply(packed, batch, cfg)                 # warm the tables
            logits, launches = served(
                mods, lambda: fam.apply(packed, batch, cfg))
            want = dense[key] = fam.apply(deq, batch, cfg)
            check(launches["dequant_matmul"] > 0 and
                  (launches["dequant_matmul_t"] > 0) == hold.tie_embeddings,
                  f"{hold.name} packed apply ({key}) launched {launches}")
            kl_packed = float(metrics.mean_topk_kl(ref, logits, k=128))
            kl_deq = float(metrics.mean_topk_kl(ref, want, k=128))
            check(abs(kl_packed - kl_deq) <= 0.05 * kl_deq,
                  f"{hold.name} packed KL ({key}) {kl_packed} vs "
                  f"dequantised {kl_deq}")
            if key == "f32":
                rel, margin = hold_logits(
                    logits, want, f"{hold.name} packed vs dequantised dense "
                    "apply, f32")
                check(margin > 0, f"{hold.name}: no high-margin position")
                out.update(f32_max_rel_logit_err=rel,
                           f32_margin_positions=margin)
            else:
                out["served_dtype"] = str(dtype).split(".")[-1]
                out["served_max_rel_logit_err"] = float(
                    ((logits - want).abs().amax(-1) /
                     want.abs().amax(-1)).max())
            out[f"{key}_launches"] = launches
            out[f"{key}_kl_packed"] = kl_packed
            out[f"{key}_kl_dequantised"] = kl_deq
            out[f"{key}_kl_rel_diff"] = abs(kl_packed - kl_deq) / kl_deq
            del logits, want
        got, want = dense["served"].float(), dense["f32"]
        out["bf16_floor_max_rel_logit_err"] = float(
            ((got - want).abs().amax(-1) / want.abs().amax(-1)).max())
    del packed, deq, ref, dense
    return out


def card_hold(hooks, arch, layers, dev, mods):
    """The card's side of the holds at ``layers`` layers of full width in
    f32 (``hold_side``: all of them), then the allocation and its packed
    ``apply``; returns the CPU side's job: the card's readings, the
    weights and batch on the CPU, the QAT plan, the holds the CPU makes
    (``cpu_holds``)."""
    from repro_torch import configs
    from repro_torch.models.api import get_family
    from repro_torch.serve.engine import params_to
    from repro_torch.train.qat import qat_plan_for
    full = configs.get_config(arch, "full")
    hold = hold_config(full, layers)
    fam = get_family(hold.family)
    plan = qat_plan_for(fam.param_specs(hold), FAMILY_QAT_SPEC)
    t0 = time.monotonic()
    params = fam.init(hold, seed=0, device=dev)
    batch = family_batch(hold, dev)
    card, secs = hold_side(hooks, hold, params, batch, plan,
                           ("ce", "qat", "fisher", "kv")
                           if arch in KV_AUTO_ARCHS else
                           ("ce", "qat", "fisher"))
    t1 = time.monotonic()
    card["allocation"] = allocated_apply(hold, full.dtype, params,
                                         card["fisher"], batch, mods)
    secs["allocation"] = time.monotonic() - t1
    job = dict(arch=arch, hold=hold, plan=plan, card=card,
               params=params_to(params, torch.device("cpu")),
               batch={k: v.cpu() for k, v in batch.items()},
               holds=cpu_holds(arch))
    del params, batch
    torch.cuda.empty_cache()
    secs["total"] = time.monotonic() - t0
    card["seconds"] = secs
    return job


def cpu_holds(arch):
    """The holds the CPU makes for ``arch``: all of them, the KV Fisher
    where ``--kv-format auto`` is served (``KV_AUTO_ARCHS``)."""
    return ("ce", "qat", "fisher", "kv") if arch in KV_AUTO_ARCHS else (
        "ce", "qat", "fisher")


def cpu_hold(hooks, job, threads):
    """The CPU's side of one family's holds (``hold_side``) on the worker
    thread, on ``threads`` intra-op threads of its own, held at once to the
    card's (``hold_readings``), so that only the readings outlive the job;
    returns (them, the CPU's KV Fisher)."""
    torch.set_num_threads(threads)
    t0 = time.monotonic()
    card = job.pop("card")
    cpu, secs = hold_side(hooks, job.pop("hold"), job.pop("params"),
                          job.pop("batch"), job.pop("plan"),
                          job.pop("holds"))
    secs["total"] = time.monotonic() - t0
    cpu["seconds"] = secs
    return hold_readings(job.pop("arch"), card, cpu), cpu.get("kv")


def rel_to(got, want):
    return abs(got - want) / abs(want) if want else (
        0.0 if got == want else math.inf)


def hold_readings(arch, card, cpu):
    """(c), (d), (e): the card's readings against the CPU's that the CPU
    made, each within its bound; returns the line's fields (the card's
    readings of the holds the CPU did not make beside them)."""
    rel = {}
    for name, key, what, tol in (("loss", "ce", "loss", 1e-4),
                                 ("grad_norm", "ce", "grad_norm", 1e-4),
                                 ("qat_kl", "qat", "loss", 1e-3),
                                 ("qat_grad_norm", "qat", "grad_norm", 1e-3)):
        if key in cpu:
            rel[name] = rel_to(card[key][what], cpu[key][what])
            check(rel[name] <= tol, f"{arch} {name}: card {card[key][what]}"
                  f" vs CPU {cpu[key][what]} ({rel[name]} > {tol})")
    g_card, g_cpu = card.pop("grads"), cpu.pop("grads")
    check(g_card.keys() == g_cpu.keys(), f"{arch}: gradient leaves differ")
    grad = {}
    for n, g in g_cpu.items():
        num = float(torch.linalg.vector_norm(g_card[n] - g))
        den = float(torch.linalg.vector_norm(g))
        grad[n] = num / den if den else (0.0 if num == 0 else math.inf)
    worst = max(grad, key=grad.get)
    check(grad[worst] <= 1e-3, f"{arch} gradient of {worst}: relative L2 "
          f"{grad[worst]} > 1e-3")
    out = dict(loss=card["ce"]["loss"], grad_norm=card["ce"]["grad_norm"],
               qat_spec=FAMILY_QAT_SPEC, qat_kl=card["qat"]["loss"],
               qat_grad_norm=card["qat"]["grad_norm"],
               cpu_holds=sorted(k for k in ("ce", "qat", "fisher", "kv")
                                if k in cpu),
               rel_err=rel, grad_max_rel_l2=grad[worst],
               grad_worst_leaf=worst, grad_leaves=len(grad),
               allocation=card["allocation"],
               card_seconds=card["seconds"], cpu_seconds=cpu["seconds"])
    if "fisher" in cpu:
        fish = {n: rel_to(card["fisher"][n]["fisher_mean"],
                          s["fisher_mean"]) for n, s in cpu["fisher"].items()}
        worst_f = max(fish, key=fish.get)
        check(fish[worst_f] <= 0.05, f"{arch} Fisher of {worst_f}: card vs "
              f"CPU {fish[worst_f]} > 5%")
        out.update(fisher_max_rel_diff=fish[worst_f],
                   fisher_worst_tensor=worst_f)
    return out


def kv_auto_serve(arch, dev, mods):
    """(f)'s serve: ``launch.serve --kv-format auto`` at full depth,
    packed, under half the all-f32 cache of its geometry, 4 requests
    (whisper's with frames on two); it must launch ``block_quant`` and
    ``decode_attention_quant``. Returns (its fields, its launches)."""
    from repro_torch import configs
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.api import get_family
    from repro_torch.serve.engine import Request
    cfg = configs.get_config(arch, "full")
    fam = get_family(cfg.family)
    slots, kv_len, chunk = 4, 256, 8
    spec = fam.cache_spec(cfg, slots, kv_len, slack=chunk)
    numel = {f"g{g.index}": 2 * len(g.layers) * slots * g.length *
             spec.kv_heads * spec.head_dim for g in spec.groups}
    budget = 4 * sum(numel.values()) // 2
    argv = ["--arch", arch, "--variant", "full", "--quantise", SPEC,
            "--packed", "--kv-format", "auto", "--kv-budget-bytes",
            str(budget), "--kv-len", str(kv_len), "--slots", str(slots),
            "--prefill-chunk", str(chunk), "--requests", "4", "--max-new",
            "8", "--no-dense-fallback", "--device", "cuda"]
    make = serve_cli.Request
    if cfg.family == "whisper":
        from repro_torch.data.pipeline import make_batch_fn
        frames = make_batch_fn(cfg, seq=8, batch=2, seed=0)(0)["frames"]
        serve_cli.Request = lambda **kw: Request(
            frames=frames[kw["rid"] // 2] if kw["rid"] % 2 == 0 else None,
            **kw)
    t0 = time.monotonic()
    try:
        (done, text), launches = served(mods, lambda: quiet(serve_cli.main,
                                                            argv))
    finally:
        serve_cli.Request = make
    line = next(ln for ln in text.splitlines() if "kv auto allocation" in ln)
    check(len(done) == 4 and all(len(g.tokens) == 8 and not g.failed
                                 for g in done) and
          "degraded to dense" not in text,
          f"{arch} --kv-format auto: requests did not all finish")
    check(all(launches[k] > 0 for k in ("dequant_matmul", "block_quant",
                                        "decode_attention_quant")),
          f"{arch} --kv-format auto launched {launches}")
    torch.cuda.empty_cache()
    return dict(budget_bytes=budget, all_f32_bytes=2 * budget, numel=numel,
                formats=line.split(": ")[1].split(" ")[0].split(","),
                launches=launches, serve_s=time.monotonic() - t0,
                tokens={g.rid: g.tokens for g in done}), launches


def kv_readings(arch, served_run, card, cpu):
    """(f): the card's KV Fisher against the CPU's at hold depth (within
    5%), and the formats ``--kv-format auto`` chose at full depth against
    those the CPU's statistics give under the same budget and geometry."""
    from repro_torch import configs
    from repro_torch.core.allocation import allocate_kv_formats
    check(list(card) == list(cpu), f"{arch} KV groups {list(card)}")
    rel = {}
    for g in cpu:
        check(card[g]["numel"] == cpu[g]["numel"], f"{arch} {g} numel")
        for k in ("rms", "fisher_mean"):
            rel[f"{g}.{k}"] = rel_to(card[g][k], cpu[g][k])
            check(rel[f"{g}.{k}"] <= 0.05, f"{arch} KV Fisher {g} {k}: card "
                  f"{card[g][k]} vs CPU {cpu[g][k]}")
    stats = {g: dict(s, numel=served_run["numel"][g]) for g, s in cpu.items()}
    want = allocate_kv_formats(stats, served_run["budget_bytes"],
                               configs.get_config(arch, "full").hd)
    want = [want[g] for g in sorted(want, key=lambda g: int(g[1:]))]
    check(served_run["formats"] == want and "f32" not in want,
          f"{arch} --kv-format auto chose {served_run['formats']}, the "
          f"CPU's Fisher {want}")
    return dict(served_run, card_stats=card, cpu_stats=cpu, rel_err=rel,
                cpu_formats=want)


def family_train_phase(dev, mods, also=()):
    """Training, QAT and the weight Fisher at full width for whisper-
    large-v3 and rwkv6-1.6b (full depth), zamba2-2.7b (36 layers),
    qwen2-moe-a2.7b (2) and internvl2-26b (1): (a) 3 CE steps of B = 1,
    T = 256 each; (b) qwen2-moe's bitwise resume; (c) one CE step on the
    card against the CPU (loss and grad_norm within 1e-4, every leaf's
    gradient within 1e-3 relative L2); (d) one QAT distillation step (KL
    and grad_norm within 1e-3); (e) the Fisher (each tensor's mean within
    5%), its Eq. 5 allocation packed and applied; (f) ``--kv-format auto``
    for whisper and zamba2. (c), (d) and (e) are held to the CPU for every
    family (``cpu_holds``). The CPU's side of each hold runs on
    a worker thread (``FAMILY_DRIVER_THREADS`` of the host's intra-op
    threads left to the card's driver), the costliest first; the card
    hands it the next family's hold only when it has
    nothing queued (host memory holds one running and one waiting), and
    trains, resumes and serves meanwhile, then runs the phases of ``also``
    ((name, function) pairs: the card's work of other phases, which would
    otherwise wait for the worker's last holds). Returns the launches of
    its packed runs and the result of each phase of ``also`` by name."""
    from concurrent.futures import ThreadPoolExecutor
    t_phase = time.monotonic()
    threads = torch.get_num_threads()
    runs, cards, cpus = [], {}, {}
    out = {arch: {} for arch, _, _ in FAMILY_TRAIN}
    holds = sorted(FAMILY_TRAIN, key=lambda f: FAMILY_HOLD_ORDER.index(f[0]))
    card_work = [("resume", MOE_ARCH, None)] if MOE_ARCH in out else []
    card_work += [("train", arch, layers) for arch, layers, _ in holds]
    card_work += [("kv_auto", arch, None) for arch in KV_AUTO_ARCHS
                  if arch in out]
    card_work += [("also", name, fn) for name, fn in also]
    done_also = {}
    timeline = []
    torch.set_num_threads(min(threads, FAMILY_DRIVER_THREADS))
    try:
        with ThreadHooks() as hooks, ThreadPoolExecutor(1) as pool:
            while holds or card_work:
                t0 = time.monotonic()
                queued = sum(not f.running() and not f.done()
                             for f in cpus.values())
                if holds and not queued:
                    arch, _, hold_layers = holds.pop(0)
                    job = card_hold(hooks, arch, hold_layers, dev, mods)
                    cards[arch] = {k: job["card"][k]
                                   for k in ("allocation", "kv")
                                   if k in job["card"]}
                    runs += [{"launches": cards[arch]["allocation"][k]}
                             for k in ("f32_launches", "served_launches")]
                    cpus[arch] = pool.submit(
                        cpu_hold, hooks, job,
                        max(1, threads - FAMILY_DRIVER_THREADS))
                    del job
                    what = ("hold", arch)
                elif card_work:
                    what, arch, layers = card_work.pop(0)
                    if what == "resume":
                        out[arch]["resume"] = moe_resume(dev)
                    elif what == "train":
                        out[arch]["train"] = train_run(arch, layers, dev)
                    elif what == "also":
                        done_also[arch] = layers()
                    else:
                        out[arch]["kv_auto"], launches = kv_auto_serve(
                            arch, dev, mods)
                        runs.append({"launches": launches})
                    what = (what, arch)
                else:
                    next(f for f in cpus.values() if not f.done()).result()
                    what = ("wait", "cpu")
                timeline.append((*what, time.monotonic() - t0))
            emit(phase="timing", family_card_end_s=time.monotonic() -
                 t_phase, timeline=timeline)
            for arch, _, hold_layers in FAMILY_TRAIN:
                readings, cpu_kv = cpus.pop(arch).result()
                out[arch]["hold"] = dict(hold_layers=hold_layers,
                                         compute_dtype="float32", **readings)
                if arch in KV_AUTO_ARCHS:
                    out[arch]["kv_auto"] = kv_readings(
                        arch, out[arch]["kv_auto"], cards[arch]["kv"],
                        cpu_kv)
                emit(phase="family_train", arch=arch, **out[arch])
    finally:
        torch.set_num_threads(threads)
    emit(phase="timing", family_train_phase_s=time.monotonic() - t_phase,
         host_peak_rss_bytes=host_peak_rss())
    return runs, done_also


def host_peak_rss():
    """The process's peak resident bytes (``ru_maxrss``)."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


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
            lambda r: r.get("model") == "gemma3-1b" and r["M"] == 4 and
            r["bits"] == 4 and "regime" not in r, lambda r: 1),
        "block_quant": per_step(
            rows["block_quant"],
            lambda r: r["rows"] == 4 and r["hd"] == 256 and r["fmt"] == "q8",
            lambda r: g_step["block_quant"]),
        "decode_attention_quant": per_step(
            rows["decode_attention_quant"],
            lambda r: r["T"] == 1 and r["fmt"] == "q8" and "model" not in r,
            lambda r: 22 if r["ring"] else 4),
    }
    ds = per_step(rows["dequant_matmul"],
                  lambda r: r.get("model") == "deepseek-7b" and r["M"] == 4
                  and r.get("launches_per_step"),
                  lambda r: r["launches_per_step"])
    emit(phase="summary", measured_over="one deepseek-7b decode step at "
         "M=4 (211 launches)", kernel="dequant_matmul", **ds)
    emit(phase="summary", kernel="dequant_matmul", measured_over="one "
         f"{INTERNLM_ARCH} decode step at M=4 (337 launches)",
         **per_step(rows["dequant_matmul"],
                    lambda r: r.get("model") == INTERNLM_ARCH and
                    r["M"] == 4, lambda r: r["launches_per_step"]))
    emit(phase="summary", kernel="dequant_matmul", measured_over="one "
         f"{INTERNVL_ARCH} apply, M={INTERNVL_APPLY_M} (336 launches)",
         **per_step(rows["dequant_matmul"],
                    lambda r: r.get("model") == INTERNVL_ARCH,
                    lambda r: r["launches_per_apply"]))
    emit(phase="summary", kernel="dequant_matmul", measured_over="one "
         f"paper-100m-small {EXAMPLE_SPEC} decode step at M=2 (31 launches)",
         **per_step(rows["dequant_matmul"],
                    lambda r: r.get("model") == "paper-100m-small" and
                    r["M"] == 2, lambda r: r["launches_per_step"]))
    # qwen2-moe-a2.7b's decode step: all 241 launches, and the 72 over the
    # expert stacks (lead dim E = 60, M = 4 rows an expert)
    for what, lead in (("241 launches", None), ("its 72 expert-stack "
                                                "launches, lead dim 60", 60)):
        emit(phase="summary", kernel="dequant_matmul",
             measured_over=f"one {MOE_ARCH} decode step at M=4 ({what})",
             **per_step(rows["dequant_matmul"],
                        lambda r: r.get("model") == MOE_ARCH and
                        (lead is None or r["lead"] == lead),
                        lambda r: r["launches_per_step"]))
    # llama4-scout's decode step: all 481 launches, and the 144 over the
    # expert stacks (lead dim E = 16); with q8, its 48 paired KV writes and
    # 48 attention reads
    for what, lead in (("481 launches", None), ("its 144 expert-stack "
                                                "launches, lead dim 16", 16)):
        emit(phase="summary", kernel="dequant_matmul",
             measured_over=f"one {LLAMA4_ARCH} decode step at M=4 ({what})",
             **per_step(rows["dequant_matmul"],
                        lambda r: r.get("model") == LLAMA4_ARCH and
                        (lead is None or r["lead"] == lead),
                        lambda r: r["launches_per_step"]))
    for name, pick in (("block_quant", lambda r: r.get("model") ==
                        LLAMA4_ARCH),
                       ("decode_attention_quant", lambda r: r.get("model")
                        == LLAMA4_ARCH and r["T"] == 1)):
        emit(phase="summary", kernel=name, measured_over=f"one "
             f"{LLAMA4_ARCH} decode step (B=4, q8 cache, 48 layers)",
             **per_step(rows[name], pick, lambda r: LLAMA4_LAYERS))
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
          if r["T"] == 1 and r["fmt"] == "q8" and "model" not in r]
    n = {True: 22, False: 4}
    emit(phase="summary", kernel="decode_attention_quant",
         measured_over="one gemma3-1b decode step (B=4, q8 cache, 26 "
         "layers)",
         event_pair_ms=sum(r["kernel_ms"] * n[r["ring"]] for r in at),
         launch_bound_ms=sum(r["launch_us"]["device_us"] * n[r["ring"]]
                             for r in at) * 1e-3,
         library_ms=sum(r["library_ms"] * n[r["ring"]] for r in at),
         bound_ms=sum(r["bound_ms"] * n[r["ring"]] for r in at))
    whisper_summary(rows)
    recurrent_summary(rows)
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


def whisper_summary(rows):
    """Per whisper-large-v3 decode step (B = 4, q8 cache) each kernel's
    per-call times at that step's shapes times its launches per step, and
    per admission with frames ``dequant_matmul`` at M = 1500."""
    w = LAUNCHES_PER_STEP[WHISPER_ARCH + " q8"]
    picks = {
        "dequant_matmul": (lambda r: r.get("model") == WHISPER_ARCH and
                           r["M"] == 4, lambda r: r["launches_per_step"]),
        "dequant_matmul_t": (lambda r: r.get("model") == WHISPER_ARCH and
                             r["M"] == 4 and r["bits"] == 4, lambda r: 1),
        "block_quant": (lambda r: r.get("model") == WHISPER_ARCH and
                        r["rows"] == 80 and r["fmt"] == "q8",
                        lambda r: w["block_quant"]),
        "decode_attention_quant": (
            lambda r: r.get("model") == WHISPER_ARCH and r["T"] == 1 and
            r["fmt"] == "q8", lambda r: w["decode_attention_quant"]),
    }
    for name, (pick, n) in picks.items():
        emit(phase="summary", kernel=name, launches_per_step=w[name],
             measured_over=f"one {WHISPER_ARCH} decode step (B=4, q8 "
             "cache): per-shape times x launches",
             **per_step(rows[name], pick, n))
    emit(phase="summary", kernel="dequant_matmul",
         launches_per_admission=WHISPER_ADMIT_LAUNCHES,
         measured_over=f"one {WHISPER_ARCH} admission with frames (M = "
         f"{WHISPER_ENC_SEQ})",
         **per_step(rows["dequant_matmul"],
                    lambda r: r.get("model") == WHISPER_ARCH and
                    r["M"] == WHISPER_ENC_SEQ,
                    lambda r: r["launches_per_admission"]))


def recurrent_summary(rows):
    """Per rwkv6-1.6b decode step and per zamba2-2.7b decode step (B = 4,
    q8 cache) each kernel's per-call times at that step's shapes times its
    launches per step."""
    z = LAUNCHES_PER_STEP[ZAMBA_ARCH + " q8"]
    picks = [
        (RWKV_ARCH, "dequant_matmul", lambda r: r.get("model") == RWKV_ARCH
         and r["M"] == 4, lambda r: r["launches_per_step"], 241),
        (ZAMBA_ARCH, "dequant_matmul", lambda r: r.get("model") ==
         ZAMBA_ARCH and r["M"] == 4, lambda r: r["launches_per_step"], 118),
        (ZAMBA_ARCH, "block_quant", lambda r: r.get("model") == ZAMBA_ARCH
         and r["rows"] == 128 and r["fmt"] == "q8",
         lambda r: z["block_quant"], z["block_quant"]),
        (ZAMBA_ARCH, "decode_attention_quant", lambda r: r.get("model") ==
         ZAMBA_ARCH and r["T"] == 1 and r["fmt"] == "q8",
         lambda r: z["decode_attention_quant"], z["decode_attention_quant"]),
    ]
    for arch, name, pick, n, per in picks:
        emit(phase="summary", kernel=name, launches_per_step=per,
             measured_over=f"one {arch} decode step (B=4"
             + (", q8 cache" if arch == ZAMBA_ARCH else "")
             + "): per-shape times x launches",
             **per_step(rows[name], pick, n))


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
    deepseek = serve_phase("deepseek-7b", dev, mods,
                           hold_layers=DEEPSEEK_HOLD_LAYERS)
    emit(phase="timing", dense_serve_end_s=time.monotonic() - t_start)
    internlm = serve_phase(INTERNLM_ARCH, dev, mods,
                           hold_layers=INTERNLM_HOLD_LAYERS,
                           kv_bytes=INTERNLM_KV_BYTES)
    emit(phase="timing", internlm2_end_s=time.monotonic() - t_start)
    gemma = gemma3_phase(dev, mods)
    emit(phase="timing", gemma3_end_s=time.monotonic() - t_start)
    alloc_runs, tf_rows = allocation_phase(dev, mods, tc_ptxas)
    for name, rs in tf_rows.items():
        rows[name] += rs
    emit(phase="timing", allocation_end_s=time.monotonic() - t_start)
    train_runs = train_phase(dev, mods)
    emit(phase="timing", train_end_s=time.monotonic() - t_start)
    frontend_runs = frontend_phase(dev, mods)
    emit(phase="timing", frontend_end_s=time.monotonic() - t_start)
    moe_runs = moe_phase(dev, mods)
    emit(phase="timing", moe_end_s=time.monotonic() - t_start)
    llama4_runs = llama4_phase(dev, mods)
    emit(phase="timing", llama4_end_s=time.monotonic() - t_start)
    whisper_runs = whisper_phase(dev, mods)
    emit(phase="timing", whisper_end_s=time.monotonic() - t_start)
    internvl_runs = internvl_phase(dev, mods)
    emit(phase="timing", internvl_end_s=time.monotonic() - t_start)
    rwkv_runs = recurrent_phase(RWKV_ARCH, dev, mods, ("dense",))
    emit(phase="timing", rwkv6_end_s=time.monotonic() - t_start)
    zamba_runs = recurrent_phase(ZAMBA_ARCH, dev, mods, ("dense", "q8"))
    emit(phase="timing", zamba2_end_s=time.monotonic() - t_start)
    # the multidevice and examples phases run on the card while the family
    # holds' CPU side runs on its worker thread
    family_runs, also = family_train_phase(dev, mods, also=(
        ("multidevice", lambda: multidevice_phase(dev, mods)),
        ("examples", lambda: examples_phase(dev, mods))))
    multidevice_runs, example_runs = also["multidevice"], also["examples"]
    emit(phase="timing", family_train_end_s=time.monotonic() - t_start)

    line = summary(rows, [paper, deepseek, internlm, *gemma, *alloc_runs,
                          *train_runs, *frontend_runs, *moe_runs,
                          *llama4_runs, *whisper_runs, *internvl_runs, *rwkv_runs,
                          *zamba_runs, *multidevice_runs, *example_runs,
                          *family_runs])
    emit(phase="timing", total_s=time.monotonic() - t_start)
    emit(kernels=line)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
