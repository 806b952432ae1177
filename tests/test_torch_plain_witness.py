"""The full-depth witness of ``chip_smoke.py`` on the CPU, at smoke size.

Where a served model's CPU hold runs on a second engine of cut depth,
``chip_smoke.py`` also replays the served engine's own prefill step and
first decode step at full depth on the card, with every kernel entry of
``kernels.ops`` routed to its plain version (``plain_kernels``). Here the
routed entries are called as ``kernels.ops`` calls them, with CPU tensors,
and must equal the plain path bit for bit; and the witness itself runs on
a served smoke engine, where the "card" is the plain path: it agrees
exactly and counts no launch."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import build_plan
from repro_torch.kernels import ops
from repro_torch.models import transformer
from repro_torch.serve.cache import kv_codebook
from repro_torch.serve.engine import ServeEngine

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

ENTRIES = ("dequant_matmul_cuda", "dequant_matmul_t_cuda", "block_quant_cuda",
           "block_quant_kv_cuda", "decode_attention_quant_cuda")


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **kw: None)


def test_plain_kernels_route_each_entry_to_its_plain_version():
    gen = torch.Generator().manual_seed(0)
    cb = kv_codebook("q4", "cpu")
    K, N, V, block = 128, 256, 256, 64
    x = torch.randn(3, K, generator=gen).to(torch.bfloat16)
    codes = torch.randint(0, 256, (K // 2, N), generator=gen,
                          dtype=torch.uint8)
    scales = torch.rand(K, N // block, generator=gen)
    t_codes = torch.randint(0, 256, (V // 2, K), generator=gen,
                            dtype=torch.uint8)
    t_scales = torch.rand(V, K // block, generator=gen)
    rows_x = torch.randn(4, block, generator=gen)
    rows_v = torch.randn(4, block, generator=gen)
    rows = torch.tensor([6, 1, 3, 4])

    def buffers():
        return (torch.zeros(8, block // 2, dtype=torch.uint8),
                torch.zeros(8, 1))
    attn, bits = chip_smoke.attention_inputs(
        torch.device("cpu"), gen, 8, 64, [40, 8, 20, 56], "q4",
        heads=(4, 2, 64))
    saved = {name: getattr(ops, name) for name in ENTRIES}
    with chip_smoke.plain_kernels():
        assert all(getattr(ops, n) is not saved[n] for n in ENTRIES)
        got = [ops.dequant_matmul_cuda(x, codes, scales, cb, block, 4),
               ops.dequant_matmul_t_cuda(x, t_codes, t_scales, cb, block, 4),
               *ops.block_quant_cuda(rows_x, cb, block, pack=True, out=None,
                                     rows=None),
               *[t for pair in ops.block_quant_kv_cuda(
                   rows_x, rows_v, cb, block, pack=True, out_k=buffers(),
                   out_v=buffers(), rows=rows) for t in pair],
               ops.decode_attention_quant_cuda(*attn, 0, ring=False,
                                               bits=bits)]
    assert {name: getattr(ops, name) for name in ENTRIES} == saved
    want = [ops.dequant_matmul(x, codes, scales, cb, block, 4),
            ops.dequant_matmul_t(x, t_codes, t_scales, cb, block, 4),
            *ops.block_quant(rows_x, cb, block, pack=True),
            *[t for pair in ops.block_quant_kv(
                rows_x, rows_v, cb, block, pack=True, out_k=buffers(),
                out_v=buffers(), rows=rows) for t in pair],
            ops.decode_attention_quant(*attn, 0, ring=False, bits=bits)]
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_plain_kernels_restore_the_entries_after_an_error():
    saved = {name: getattr(ops, name) for name in ENTRIES}
    with pytest.raises(RuntimeError):
        with chip_smoke.plain_kernels():
            raise RuntimeError("inside")
    assert {name: getattr(ops, name) for name in ENTRIES} == saved


def test_plain_witness_replays_the_served_engine_at_full_depth(no_card):
    cfg = configs.get_config("gemma3-1b", "smoke").replace(kv_format="q8")
    params = transformer.init(cfg, seed=0, device="cpu")
    plan = build_plan(params, "babsmax64:n4")
    eng = ServeEngine.from_quantised(cfg, plan.quantise(params), plan,
                                     batch_slots=4, kv_len=48,
                                     prefill_chunk=8, device="cpu")
    mods = chip_smoke.wrappers()
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, cfg.vocab, 8).tolist(), 4) for _ in range(4)]
    _, _, records = chip_smoke.serve(eng, mods, reqs, keep_logits=True)
    out = chip_smoke.plain_witness(eng, mods, records, "smoke")
    assert out["layers"] == cfg.n_layers and out["compared_steps"] == 2
    assert out["max_rel_logit_err"] == 0.0 and out["margin_tokens"] > 0
    with pytest.raises(RuntimeError, match="prefill and a decode"):
        chip_smoke.plain_witness(eng, mods, records[1:], "smoke")


def test_dequant_memo_replays_the_same_logits(no_card, monkeypatch):
    """A CPU replay dequantises each packed weight of the engine once
    (``dequant_memo``) and gives the same logits, bit for bit, as one that
    dequantises every weight at every step; codes outside the engine's
    weights are never kept, and the plain dequantiser is restored."""
    import contextlib
    from repro_torch.kernels.dequant_matmul import ref
    cfg = configs.get_config("gemma3-1b", "smoke").replace(kv_format="q8")
    params = transformer.init(cfg, seed=0, device="cpu")
    plan = build_plan(params, "babsmax64:n4")
    eng = ServeEngine.from_quantised(cfg, plan.quantise(params), plan,
                                     batch_slots=4, kv_len=48,
                                     prefill_chunk=8, device="cpu")
    mods = chip_smoke.wrappers()
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, cfg.vocab, 8).tolist(), 4) for _ in range(4)]
    _, _, records = chip_smoke.serve(eng, mods, reqs, keep_logits=True)
    plain = ref.dequant_weight
    calls = []

    def counted(*a, **kw):
        calls.append(a[0].data_ptr())
        return plain(*a, **kw)
    monkeypatch.setattr(ref, "dequant_weight", counted)
    memo = [cpu for _, cpu, _ in chip_smoke.replay_on_cpu(eng, records)]
    n_memo, calls[:] = len(calls), []
    assert ref.dequant_weight is counted
    monkeypatch.setattr(chip_smoke, "dequant_memo",
                        lambda p: contextlib.nullcontext())
    every = [cpu for _, cpu, _ in chip_smoke.replay_on_cpu(eng, records)]
    assert len(records) > 2 and 0 < n_memo < len(calls)
    assert len(memo) == len(every) > 0
    assert all(np.array_equal(a, b) for a, b in zip(memo, every))

    codes = torch.randint(0, 256, (64, 128), dtype=torch.uint8)
    scales = torch.rand(64, 2)
    cb = kv_codebook("q8", "cpu")
    monkeypatch.undo()
    with chip_smoke.dequant_memo(eng.params):
        first = ref.dequant_weight(codes, scales, cb, 64, 8)
        codes.add_(1)
        again = ref.dequant_weight(codes, scales, cb, 64, 8)
    assert ref.dequant_weight is plain
    assert not torch.equal(first, again)
