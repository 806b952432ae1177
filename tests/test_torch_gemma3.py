"""The slice end to end: gemma3-1b smoke (6 layers, 5:1 local(16):global,
QK-norm, tied embeddings), babsmax64:n4 packed, served by the port's engine
and by the JAX engine from the same seeded numpy weights, with a dense, q8,
q4 and per-group "q8,q4" KV cache. Prompts and generations cross the local
groups' ring wrap (window 16 + prefill chunk 4 = 20 ring slots; positions
reach 33).

The path runs all three kernels of the slice (their plain versions here):
``dequant_matmul_t`` (the tied unembed), ``block_quant`` (every quantised KV
write) and ``decode_attention_quant`` (every quantised KV read)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.core import build_plan as jbuild_plan
from repro.serve import cache as jcache
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch import configs
from repro_torch.core import build_plan
from repro_torch.core.plan import map_with_paths
from repro_torch.interop import params_from_numpy
from repro_torch.models import transformer
from repro_torch.serve import cache as tcache
from repro_torch.serve.engine import (Request, ServeEngine,
                                      alloc_decode_state, greedy_generate)

ARCH, SPEC = "gemma3-1b", "babsmax64:n4"
KW = dict(batch_slots=2, kv_len=48, prefill_chunk=4)
REQS = {0: ([5, 9, 3, 7, 2, 8, 1, 6, 4, 3], 24), 1: ([11, 4], 24)}
FORMATS = ["", "q8", "q4", "q8,q4"]


def numpy_params(cfg, seed=0):
    """Seeded numpy weights (norm gains around 1, fan-in scaled matrices,
    a 0.5-std tied embedding so the logits have margins)."""
    rng = np.random.default_rng(seed)

    def make(path, spec):
        if "norm" in path:
            return (1 + 0.1 * rng.standard_normal(spec.shape)
                    ).astype(np.float32)
        std = 0.5 if "embed" in path else \
            1 / np.sqrt(spec.numel // spec.shape[-1])
        return (rng.standard_normal(spec.shape) * std).astype(np.float32)
    return map_with_paths(make, transformer.param_specs(cfg))


def smoke_cfg(fmt, dtype):
    return configs.get_config(ARCH, "smoke").replace(dtype=dtype,
                                                     kv_format=fmt)


def run_reference(fmt, dtype):
    """The JAX engine on the packed weights: tokens per rid, its recorded
    steps, the byte accounting and the numpy weights."""
    jcfg = jconfigs.get_config(ARCH, "smoke").replace(dtype=dtype,
                                                      kv_format=fmt)
    np_params = numpy_params(smoke_cfg(fmt, dtype))
    jparams = jax.tree.map(jnp.asarray, np_params)
    jplan = jbuild_plan(jparams, SPEC)
    eng = JServeEngine.from_quantised(jcfg, jplan.quantise(jparams), jplan,
                                      **KW)
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
    for rid, (p, n) in REQS.items():
        eng.submit(JRequest(prompt=list(p), max_new_tokens=n, rid=rid))
    tokens = {g.rid: g.tokens for g in eng.run()}
    return dict(tokens=tokens, steps=steps, weight=eng.weight_bytes(),
                cache=eng.cache_bytes(), np_params=np_params)


def port_engine(fmt, dtype, np_params, **kw):
    cfg = smoke_cfg(fmt, dtype)
    params = params_from_numpy(np_params, "cpu")
    plan = build_plan(params, SPEC)
    return ServeEngine.from_quantised(cfg, plan.quantise(params), plan,
                                      device="cpu", **{**KW, **kw})


def run_port(eng):
    for rid, (p, n) in REQS.items():
        eng.submit(Request(prompt=list(p), max_new_tokens=n, rid=rid))
    return {g.rid: g.tokens for g in eng.run()}


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
    tv = rec["batch"]["t_valid"]
    return [(i, t) for i in range(len(tv)) for t in range(int(tv[i]))]


def high_margin(row):
    top2 = np.sort(row)[-2:]
    return top2[1] - top2[0] > 5e-2 * np.abs(row).max()


@pytest.fixture(scope="module", params=FORMATS,
                ids=lambda f: f or "dense")
def f32_case(request):
    ref = run_reference(request.param, "float32")
    eng = port_engine(request.param, "float32", ref["np_params"])
    return request.param, ref, eng


class TestFloat32:
    def test_ring_wraps(self, f32_case):
        """The run really laps the local groups' 20-slot ring."""
        _, ref, eng = f32_case
        (window, ring_len) = [(g["window"], g["length"])
                              for g in eng.cache_bytes()["cache_groups"]
                              if g["window"]][0]
        assert (window, ring_len) == (16, 20)
        assert max(int(r["pos"].max()) for r in ref["steps"]) >= 32

    def test_teacher_forced_logits(self, f32_case):
        """Compute dtype f32: logits within 1e-4 of max|logit| with a dense
        cache (f32 sums in another order). A quantised cache's codes are
        bitwise equal for equal inputs, but the f32 k/v they quantise differ
        in the last bits, so a value within rounding of a midpoint takes the
        neighbouring code: a handful of the 6,400 codes of a step (measured
        on this case), each moving one element by a codebook step (2/255 of
        its row's scale at q8). Quantised groups are held to 1e-3."""
        fmt, ref, eng = f32_case
        tol = 1e-3 if fmt else 1e-4
        for rec, got in zip(ref["steps"], replay(eng, ref["steps"])):
            rows = valid_rows(rec)
            want = np.stack([rec["logits"][i, t] for i, t in rows])
            have = np.stack([got[i, t] for i, t in rows])
            np.testing.assert_allclose(
                have, want, rtol=tol, atol=tol * np.abs(want).max())

    def test_greedy_tokens_identical(self, f32_case):
        _, ref, eng = f32_case
        assert run_port(eng) == ref["tokens"]

    def test_weight_and_cache_bytes_equal(self, f32_case):
        _, ref, eng = f32_case
        assert eng.weight_bytes() == ref["weight"]
        assert eng.cache_bytes() == ref["cache"]


@pytest.mark.parametrize("fmt", FORMATS, ids=lambda f: f or "dense")
def test_bf16_tokens_under_the_margin_rule(fmt):
    """Compute dtype bf16: XLA and torch round bf16 intermediates at
    different places, so the argmax must agree wherever the reference's
    top-2 margin exceeds 5e-2 max|logit|, and the port's greedy tokens must
    equal the reference's up to each row's first low-margin token."""
    ref = run_reference(fmt, "bfloat16")
    eng = port_engine(fmt, "bfloat16", ref["np_params"])
    n_checked = 0
    emitted = {i: [] for i in REQS}
    for rec, got in zip(ref["steps"], replay(eng, ref["steps"])):
        for i, t in valid_rows(rec):
            row = rec["logits"][i, t]
            if high_margin(row):
                assert int(np.argmax(got[i, t])) == int(np.argmax(row))
                n_checked += 1
        for i, tv in enumerate(rec["batch"]["t_valid"]):
            if tv and rec["pos"][i] + tv >= len(REQS[i][0]):
                emitted[i].append(rec["logits"][i, tv - 1])
    assert n_checked > 0
    tokens = run_port(eng)
    for rid, want in ref["tokens"].items():   # one wave: rid i in slot i
        have = tokens[rid]
        n = next((k for k, (a, b) in enumerate(zip(have, want)) if a != b),
                 None)
        if n is not None:
            assert not high_margin(emitted[rid][n]), (rid, n)


# ---------------------------------------------------------------------------
# Kill-switches and admission (port only)


@pytest.fixture(scope="module")
def np_params():
    return numpy_params(smoke_cfg("", "float32"))


def test_uniform_cache_reproduces_the_ring(np_params):
    """windowed_cache=False: every group at the full length, same tokens
    as the ring allocation, at q8 and dense."""
    for fmt in ("", "q8"):
        ring = port_engine(fmt, "float32", np_params)
        full = port_engine(fmt, "float32", np_params, windowed_cache=False)
        assert {g["length"] for g in full.cache_bytes()["cache_groups"]} \
            == {52}
        assert run_port(ring) == run_port(full)


def test_quantised_cache_off_reproduces_dense(np_params):
    """quantised_cache=False drops cfg.kv_format: the dense engine's
    tokens and state layout."""
    dense = port_engine("", "float32", np_params)
    off = port_engine("q8,q4", "float32", np_params, quantised_cache=False)
    assert off.cfg.kv_format == ""
    assert set(off._state) == set(dense._state)
    assert run_port(off) == run_port(dense)


def test_quantised_state_layout(np_params):
    eng = port_engine("q8,q4", "float32", np_params)
    st = eng._state
    assert st["k0"].dtype == torch.uint8 and st["k0"].shape == (5, 2, 20, 1,
                                                                 32)
    assert st["k1"].shape == (1, 2, 52, 1, 16)
    assert st["k0s"].dtype == torch.float32 and st["v1s"].shape == (1, 2, 52,
                                                                    1, 1)


def test_admission_budgets_the_global_length_only(np_params):
    eng = port_engine("q4", "float32", np_params, batch_slots=1)
    with pytest.raises(ValueError, match="KV budget"):
        eng.submit(Request(prompt=[1] * 8, max_new_tokens=41, rid=0))
    eng.submit(Request(prompt=[1] * 8, max_new_tokens=40, rid=1))
    (g,) = eng.run()
    assert len(g.tokens) == 40 and not g.truncated and g.done


def test_greedy_generate_matches_engine(np_params):
    eng = port_engine("q8", "float32", np_params, batch_slots=1)
    prompt, n = REQS[0]
    out = greedy_generate(eng.cfg, eng.params, np.asarray([prompt]), n,
                          kv_len=48, device="cpu")
    eng.submit(Request(prompt=list(prompt), max_new_tokens=n, rid=0))
    assert out[0].tolist() == eng.run()[0].tokens


def test_parse_kv_formats_checks_q4_head_dim():
    with pytest.raises(ValueError, match="even"):
        tcache.parse_kv_formats("q4", 1, 33)
    assert tcache.parse_kv_formats("q8,q4", 2, 32) == ("q8", "q4")
    with pytest.raises(ValueError, match="2 cache groups"):
        tcache.parse_kv_formats("q8,q4,q8", 2, 32)


def test_serve_cli_kv_format_on_cpu(capsys):
    from repro_torch.launch import serve
    done = serve.main(["--arch", ARCH, "--variant", "smoke", "--quantise",
                       SPEC, "--packed", "--kv-format", "q8,q4", "--device",
                       "cpu", "--kv-len", "48", "--max-new", "4",
                       "--requests", "2", "--slots", "2"])
    assert len(done) == 2 and all(g.done for g in done)
    assert "quantised KV (q8,q4)" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="needs --kv-budget-bytes"):
        serve.main(["--arch", ARCH, "--variant", "smoke", "--kv-format",
                    "auto", "--device", "cpu"])


# ---------------------------------------------------------------------------
# Full width, from shapes alone


def _meta_engine():
    cfg = configs.get_config(ARCH, "full")
    params = map_with_paths(lambda _, s: torch.empty(s.shape, device="meta"),
                            transformer.param_specs(cfg))
    plan = build_plan(params, SPEC)
    return ServeEngine.from_quantised(cfg, plan.quantise(params), plan,
                                      validate=False, device="meta")


def test_full_weight_bytes_from_shapes():
    """gemma3-1b full, packed babsmax64:n4: the tied (V, D) table packs
    once (no unembed), eight packed tensors with a 16-point codebook
    each."""
    wb = _meta_engine().weight_bytes()
    assert {k: wb[k] for k in ("total", "codes", "scales", "codebooks",
                               "dense")} == dict(
        total=531_416_064, codes=499_875_840, scales=31_242_240,
        codebooks=512, dense=297_472)


@pytest.mark.parametrize("fmt,kv", [("q8", 32_381_440), ("q4", 16_439_808)])
def test_full_cache_bytes_match_reference(fmt, kv):
    """The serving geometry chip_smoke uses (4 slots, kv_len 1024, chunk
    8): 22 local layers x 520 ring slots and 4 global layers x 1032."""
    cfg = configs.get_config(ARCH, "full").replace(kv_format=fmt)
    jcfg = jconfigs.get_config(ARCH, "full").replace(kv_format=fmt)
    from repro.models.transformer import cache_spec as jcache_spec
    got = transformer.cache_spec(cfg, 4, 1024, slack=8).cache_bytes()
    assert got == jcache_spec(jcfg, 4, 1024, slack=8).cache_bytes()
    assert got["kv"] == kv
    assert [g["length"] for g in got["cache_groups"]] == [520, 1032]
    assert jcache.kv_bits(fmt) == tcache.kv_bits(fmt)


def test_interop_carries_the_reference_packed_tree():
    """The reference's own packed gemma3 tree (q_norm/k_norm, a tied packed
    embed, no unembed), carried across as field dicts, serves the
    reference's q8 tokens."""
    from repro.core.tensor_format import PackedTensor as JPacked
    ref = run_reference("q8", "float32")
    jcfg = jconfigs.get_config(ARCH, "smoke").replace(dtype="float32",
                                                      kv_format="q8")
    jparams = jax.tree.map(jnp.asarray, ref["np_params"])
    jplan = jbuild_plan(jparams, SPEC)
    jeng = JServeEngine.from_quantised(jcfg, jplan.quantise(jparams), jplan,
                                       **KW)

    def fields(x):
        if isinstance(x, JPacked):
            return {"codes": np.asarray(x.codes),
                    "scales": np.asarray(x.scales),
                    "codepoints": x.codepoints, "out_shape": x.out_shape,
                    "shape": x.shape, "dtype": x.dtype, "block": x.block,
                    "bits": x.bits}
        return np.asarray(x)
    tree = jax.tree.map(fields, jeng.params,
                        is_leaf=lambda x: isinstance(x, JPacked))
    assert "unembed" not in tree and "q_norm" in tree["layers"]
    eng = ServeEngine(smoke_cfg("q8", "float32"),
                      params_from_numpy(tree, "cpu"), device="cpu", **KW)
    assert run_port(eng) == ref["tokens"]
    assert eng.weight_bytes() == ref["weight"]
