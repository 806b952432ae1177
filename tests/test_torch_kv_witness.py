"""The q4 K/V witness of ``chip_smoke.py`` on the CPU, at smoke size.

``chip_smoke.py`` holds the card's gemma3 q4 logits to the plain path on
the cache the card wrote, so that compare cannot see the K/V path (wk/wv,
k-norm, RoPE on k, the quantised write). Its witness holds the plain path's
own new codes and scales of each step to those in the recorded cache. Here
the "card" is the plain path itself: an unchanged replay agrees code for
code, and a replay whose new k is wrong leaves the logits untouched but
fails the witness."""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import build_plan
from repro_torch.models import layers, transformer
from repro_torch.serve.engine import Request, ServeEngine

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def recorded():
    """A gemma3-1b smoke engine with a q4 cache, and the prefill and first
    three decode steps of 2 requests, each with the cache it left."""
    cfg = configs.get_config("gemma3-1b", "smoke").replace(kv_format="q4")
    params = transformer.init(cfg, seed=0, device="cpu")
    plan = build_plan(params, "babsmax64:n4")
    eng = ServeEngine.from_quantised(cfg, plan.quantise(params), plan,
                                     batch_slots=2, kv_len=48,
                                     prefill_chunk=4, device="cpu")
    rec = chip_smoke.StepRecorder(eng.fam.decode_step, True, 3)
    eng.fam = dataclasses.replace(eng.fam, decode_step=rec)
    rng = np.random.default_rng(0)
    for rid in range(2):
        eng.submit(Request(prompt=rng.integers(0, cfg.vocab, 4).tolist(),
                           max_new_tokens=6, rid=rid))
    sync = torch.cuda.synchronize
    torch.cuda.synchronize = lambda *a, **kw: None   # no card here
    try:
        eng.run()
    finally:
        torch.cuda.synchronize = sync
    eng.fam = dataclasses.replace(eng.fam, decode_step=rec.step)
    records = [r for r in rec.records if "cache" in r]
    assert [r["T"] for r in records][-3:] == [1, 1, 1]
    return eng, records


def replay(eng, records):
    stats = dict(codes=0, differ=0, max_codepoints=0, max_scale_rel=0.0)
    worst = max(float(np.abs(got - want).max())
                for got, want, _ in chip_smoke.replay_on_cpu(
                    eng, records, card_cache=True, kv_stats=stats))
    return worst, stats


def test_witness_agrees_with_the_path_that_wrote_the_cache(recorded):
    worst, stats = replay(*recorded)
    assert worst == 0.0
    out = chip_smoke.hold_kv_witness(stats)
    assert stats["codes"] > 0 and stats["differ"] == 0
    assert out["differ_share"] == 0.0 and stats["max_scale_rel"] == 0.0


@pytest.mark.parametrize("fault", ["negated", "rolled"])
def test_witness_sees_a_fault_the_logits_do_not(recorded, monkeypatch,
                                                fault):
    project = layers.qkv_project

    def wrong_k(*args, **kw):
        q, k, v = project(*args, **kw)
        return q, (-k if fault == "negated" else k.roll(1, -1)), v
    monkeypatch.setattr(layers, "qkv_project", wrong_k)
    worst, stats = replay(*recorded)
    assert worst == 0.0          # the logits read the recorded cache
    assert stats["max_codepoints"] > 1
    with pytest.raises(RuntimeError, match="k/v codes disagree"):
        chip_smoke.hold_kv_witness(stats)
