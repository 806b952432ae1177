"""End to end: the port's ServeEngine against the JAX engine, serving the
same babsmax64:n4-packed weights on paper-100m smoke (B = 1, 2, 4, 8) and
small (B = 4), greedy and, on smoke, sampled.

Each reference engine step is recorded (positions, batch, logits) and the
identical batches are replayed through the port's ``decode_step``
(teacher forcing on the reference's schedule and tokens), then both engines
generate greedily on their own. Weights are seeded numpy arrays fed to both
packages; the port quantises and packs them itself."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.core import build_plan as jbuild_plan
from repro.core.tensor_format import PackedTensor as JPacked
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch import configs
from repro_torch.core import build_plan
from repro_torch.core.plan import map_with_paths
from repro_torch.interop import params_from_numpy
from repro_torch.models import transformer
from repro_torch.serve.engine import (Request, ServeEngine,
                                      alloc_decode_state, greedy_generate)

SPEC = "babsmax64:n4"
KV_LEN, CHUNK, MAX_NEW = 48, 8, 6
PROMPT_LENS = (5, 11, 3, 8)


def numpy_params(cfg, seed=0):
    """Seeded numpy weights (norm gains around 1, fan-in scaled matrices)."""
    rng = np.random.default_rng(seed)

    def make(path, spec):
        if "norm" in path:
            return (1 + 0.1 * rng.standard_normal(spec.shape)
                    ).astype(np.float32)
        std = 0.02 if "embed" in path else \
            1 / np.sqrt(spec.numel // spec.shape[-1])
        return (rng.standard_normal(spec.shape) * std).astype(np.float32)
    return map_with_paths(make, transformer.param_specs(cfg))


def prompts(cfg, B, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, PROMPT_LENS[i % 4]).tolist()
            for i in range(B)]


def run_reference(variant, dtype, B, temperature=0.0):
    """JAX engine on the packed weights: tokens per rid, the recorded steps,
    and the byte accounting."""
    jcfg = jconfigs.get_config("paper-100m", variant).replace(dtype=dtype)
    np_params = numpy_params(configs.get_config("paper-100m", variant))
    jparams = jax.tree.map(jnp.asarray, np_params)
    jplan = jbuild_plan(jparams, SPEC)
    eng = JServeEngine.from_quantised(jcfg, jplan.quantise(jparams), jplan,
                                      batch_slots=B, kv_len=KV_LEN,
                                      prefill_chunk=CHUNK)
    steps = []
    step = eng._step

    def recording_step(p, s, b):
        rec = {"pos": np.asarray(s["pos"]),
               "batch": {k: np.asarray(v) for k, v in b.items()}}
        logits, new = step(p, s, b)
        rec["logits"] = np.asarray(logits)
        steps.append(rec)
        return logits, new
    eng._step = recording_step
    for rid, pr in enumerate(prompts(jcfg, B)):
        eng.submit(JRequest(prompt=pr, max_new_tokens=MAX_NEW, rid=rid,
                            temperature=temperature))
    tokens = {g.rid: g.tokens for g in eng.run()}
    return dict(tokens=tokens, steps=steps, weight=eng.weight_bytes(),
                cache=eng.cache_bytes(), np_params=np_params,
                jpacked=eng.params)


def port_engine(variant, dtype, B, np_params):
    cfg = configs.get_config("paper-100m", variant).replace(dtype=dtype)
    params = params_from_numpy(np_params, "cpu")
    plan = build_plan(params, SPEC)
    return ServeEngine.from_quantised(cfg, plan.quantise(params), plan,
                                      batch_slots=B, kv_len=KV_LEN,
                                      prefill_chunk=CHUNK, device="cpu")


def replay(eng, steps):
    """The reference's recorded batches through the port's decode_step on a
    fresh state: port logits per step."""
    state = alloc_decode_state(eng.fam, eng.cfg, eng.B, eng.kv_len,
                               slack=eng.prefill_chunk, device="cpu")
    out = []
    with torch.inference_mode():
        for rec in steps:
            state["pos"] = torch.from_numpy(rec["pos"].copy())
            batch = {k: torch.from_numpy(v.copy())
                     for k, v in rec["batch"].items()}
            logits, state = eng.fam.decode_step(eng.params, state, batch,
                                                eng.cfg)
            out.append(logits.numpy())
    return out


def valid_rows(rec):
    """(slot, t) of every real token of a recorded step."""
    tv = rec["batch"]["t_valid"]
    return [(i, t) for i in range(len(tv)) for t in range(int(tv[i]))]


def run_generate(eng, B, temperature=0.0):
    for rid, pr in enumerate(prompts(eng.cfg, B)):
        eng.submit(Request(prompt=pr, max_new_tokens=MAX_NEW, rid=rid,
                           temperature=temperature))
    return {g.rid: g.tokens for g in eng.run()}


CASES = [("smoke", 1), ("smoke", 2), ("smoke", 4), ("smoke", 8),
         ("small", 4)]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-B{c[1]}")
def f32_case(request):
    variant, B = request.param
    ref = run_reference(variant, "float32", B)
    eng = port_engine(variant, "float32", B, ref["np_params"])
    return variant, B, ref, eng


class TestFloat32:
    def test_teacher_forced_logits(self, f32_case):
        """Compute dtype f32: logits agree to rtol 1e-4 / atol 1e-4 max|logit|
        (the f32 matmuls and softmax sum in another order)."""
        _, _, ref, eng = f32_case
        for rec, got in zip(ref["steps"], replay(eng, ref["steps"])):
            rows = valid_rows(rec)
            want = np.stack([rec["logits"][i, t] for i, t in rows])
            have = np.stack([got[i, t] for i, t in rows])
            np.testing.assert_allclose(
                have, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())

    def test_greedy_tokens_identical(self, f32_case):
        _, B, ref, eng = f32_case
        assert run_generate(eng, B) == ref["tokens"]

    def test_weight_and_cache_bytes_equal(self, f32_case):
        _, _, ref, eng = f32_case
        assert eng.weight_bytes() == ref["weight"]
        assert eng.cache_bytes() == ref["cache"]


def test_sampled_tokens_equal_the_reference():
    """Compute dtype f32 at temperature 0.8: both engines draw each token
    from ``np.random.default_rng((rid, index))`` over the softmax of the
    logits, so the sampled tokens are the reference's wherever the logits
    agree (a draw that fell across a CDF boundary moved by a logit
    difference would show here as a mismatch)."""
    ref = run_reference("smoke", "float32", 4, temperature=0.8)
    eng = port_engine("smoke", "float32", 4, ref["np_params"])
    greedy = run_reference("smoke", "float32", 4)["tokens"]
    assert ref["tokens"] != greedy          # the draws did sample
    assert run_generate(eng, 4, temperature=0.8) == ref["tokens"]


@pytest.mark.parametrize("variant,B", [("smoke", 4), ("small", 4)])
def test_bf16_tokens_under_the_margin_rule(variant, B):
    """Compute dtype bf16: XLA and torch round bf16 intermediates at
    different places, so the argmax must agree wherever the reference's
    top-2 margin exceeds 5e-2 max|logit|, and the port's own greedy tokens
    must equal the reference's up to each row's first low-margin token."""
    ref = run_reference(variant, "bfloat16", B)
    eng = port_engine(variant, "bfloat16", B, ref["np_params"])
    n_checked = 0
    emitted = {i: [] for i in range(B)}   # slot -> logits row of each token
    for rec, got in zip(ref["steps"], replay(eng, ref["steps"])):
        for i, t in valid_rows(rec):
            row = rec["logits"][i, t]
            if high_margin(row):
                assert int(np.argmax(got[i, t])) == int(np.argmax(row))
                n_checked += 1
        for i, tv in enumerate(rec["batch"]["t_valid"]):
            if tv and rec["pos"][i] + tv >= PROMPT_LENS[i % 4]:
                emitted[i].append(rec["logits"][i, tv - 1])
    assert n_checked > 0
    tokens = run_generate(eng, B)
    for rid, want in ref["tokens"].items():   # one wave: rid i in slot i
        have = tokens[rid]
        n = next((k for k, (a, b) in enumerate(zip(have, want)) if a != b),
                 None)
        if n is not None:   # diverged, so the reference's margin was low
            assert not high_margin(emitted[rid][n]), (rid, n)


def high_margin(row):
    top2 = np.sort(row)[-2:]
    return top2[1] - top2[0] > 5e-2 * np.abs(row).max()


def test_interop_packed_weights_serve_identically():
    """The reference's own packed tensors, carried across as field dicts,
    serve the same tokens as the port's packing of the same weights."""
    ref = run_reference("smoke", "float32", 4)

    def fields(x):
        if isinstance(x, JPacked):
            return {"codes": np.asarray(x.codes),
                    "scales": np.asarray(x.scales),
                    "codepoints": x.codepoints, "out_shape": x.out_shape,
                    "shape": x.shape, "dtype": x.dtype, "block": x.block,
                    "bits": x.bits}
        return np.asarray(x)
    tree = jax.tree.map(fields, ref["jpacked"],
                        is_leaf=lambda x: isinstance(x, JPacked))
    cfg = configs.get_config("paper-100m", "smoke").replace(dtype="float32")
    eng = ServeEngine(cfg, params_from_numpy(tree, "cpu"), batch_slots=4,
                      kv_len=KV_LEN, prefill_chunk=CHUNK, device="cpu")
    assert run_generate(eng, 4) == ref["tokens"]
    assert eng.weight_bytes() == ref["weight"]


def test_greedy_generate_matches_engine():
    cfg = configs.get_config("paper-100m", "smoke").replace(dtype="float32")
    np_params = numpy_params(cfg)
    params = params_from_numpy(np_params, "cpu")
    plan = build_plan(params, SPEC)
    eng = ServeEngine.from_quantised(cfg, plan.quantise(params), plan,
                                     batch_slots=1, kv_len=KV_LEN,
                                     prefill_chunk=CHUNK, device="cpu")
    prompt = prompts(cfg, 1)[0]
    out = greedy_generate(cfg, eng.params, np.asarray([prompt]), MAX_NEW,
                          kv_len=KV_LEN, device="cpu")
    assert out[0].tolist() == run_generate(eng, 1)[0]


def _meta_engine(arch):
    cfg = configs.get_config(arch, "full")
    params = map_with_paths(lambda _, s: torch.empty(s.shape, device="meta"),
                            transformer.param_specs(cfg))
    plan = build_plan(params, SPEC)
    return ServeEngine.from_quantised(cfg, plan.quantise(params), plan,
                                      validate=False, device="meta")


@pytest.mark.parametrize("arch,expect", [
    ("paper-100m", dict(total=66_924_096, codes=62_914_560,
                        scales=3_932_160, codebooks=576, dense=76_800)),
    ("deepseek-7b", dict(total=3_671_999_040, codes=3_455_057_920,
                         scales=215_941_120, codebooks=576, dense=999_424)),
])
def test_full_weight_bytes_from_shapes(arch, expect):
    """Resident bytes of the full configs follow from shapes alone, so they
    are computed on meta tensors (no weights are made)."""
    wb = _meta_engine(arch).weight_bytes()
    assert {k: wb[k] for k in expect} == expect
    assert wb["packed"] == expect["codes"] + expect["scales"] + \
        expect["codebooks"]


# ---------------------------------------------------------------------------
# Engine protocol (port only: admission, quarantine, deadlines, budgets)


@pytest.fixture(scope="module")
def smoke_params():
    cfg = configs.get_config("paper-100m", "smoke").replace(dtype="float32")
    return cfg, params_from_numpy(numpy_params(cfg), "cpu")


def _engine(smoke_params, **kw):
    cfg, params = smoke_params
    kw = {"batch_slots": 2, "kv_len": 32, "prefill_chunk": 4, **kw}
    return ServeEngine(cfg, params, device="cpu", **kw)


class TestEngineProtocol:
    def test_admission_checks(self, smoke_params):
        eng = _engine(smoke_params)
        for bad, msg in [(Request(prompt=[]), "empty prompt"),
                         (Request(prompt=[1], max_new_tokens=0),
                          "max_new_tokens"),
                         (Request(prompt=[1], deadline_steps=0),
                          "deadline_steps"),
                         (Request(prompt=[1] * 32), "does not fit"),
                         (Request(prompt=[1] * 20, max_new_tokens=20),
                          "exceeds the KV budget")]:
            with pytest.raises(ValueError, match=msg):
                eng.submit(bad)

    def test_relaxed_admission_truncates_at_the_budget(self, smoke_params):
        eng = _engine(smoke_params, strict_admission=False)
        eng.submit(Request(prompt=[1] * 20, max_new_tokens=20, rid=3))
        (g,) = eng.run()
        assert g.done and g.truncated and len(g.tokens) < 20

    def test_non_finite_logits_quarantine_one_slot(self, smoke_params,
                                                   monkeypatch):
        """Slot 0's logits turn NaN: it is evicted alone, its rows are wiped
        through the reset protocol, and slot 1 finishes with the same tokens
        as when it runs alone."""
        alone = _engine(smoke_params)
        alone.submit(Request(prompt=[5, 6, 7], max_new_tokens=4, rid=1))
        want = alone.run()[0].tokens
        eng = _engine(smoke_params)
        step = eng.fam.decode_step
        calls = []

        def poisoned(params, state, batch, cfg):
            logits, state = step(params, state, batch, cfg)
            calls.append(batch.get("reset"))
            if len(calls) == 2:
                logits[0] = float("nan")
            return logits, state
        monkeypatch.setattr(eng, "fam", type(eng.fam)(
            **{**eng.fam.__dict__, "decode_step": poisoned}))
        eng.submit(Request(prompt=[9, 9], max_new_tokens=4, rid=0))
        eng.submit(Request(prompt=[5, 6, 7], max_new_tokens=4, rid=1))
        with pytest.warns(RuntimeWarning, match="quarantined slot 0"):
            out = {g.rid: g for g in eng.run()}
        assert out[0].failed and "non-finite" in out[0].fail_reason
        assert out[1].done and out[1].tokens == want
        assert bool(calls[2][0])   # the next step wipes slot 0

    def test_deadline_and_max_steps(self, smoke_params):
        eng = _engine(smoke_params)
        eng.submit(Request(prompt=[1, 2], max_new_tokens=8, rid=0,
                           deadline_steps=3))
        with pytest.warns(RuntimeWarning, match="deadline_steps=3"):
            (g,) = eng.run()
        assert g.failed and len(g.tokens) == 3   # one token per step
        eng.submit(Request(prompt=[1, 2], max_new_tokens=8, rid=1))
        with pytest.warns(RuntimeWarning, match="max_steps=2 expired"):
            (part,) = eng.run(max_steps=2)
        assert not part.done and len(part.tokens) == 2
        (rest,) = eng.run()
        assert rest is part and rest.done and len(rest.tokens) == 8

    def test_sampling_is_seeded_per_request(self, smoke_params):
        toks = []
        for _ in range(2):
            eng = _engine(smoke_params)
            eng.submit(Request(prompt=[3, 4], max_new_tokens=6,
                               temperature=1.0, rid=11))
            toks.append(eng.run()[0].tokens)
        assert toks[0] == toks[1]
