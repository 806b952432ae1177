"""internvl on the CPU: the port's VLM family against the reference's, at
internvl2-26b smoke (2 layers, d 96, 6 heads of 16 over 2 KV heads, vocab
256, 8 patch tokens of width 3200; packed babsmax32:n4, whose blocks tile
its widths) and at full width on meta tensors (babsmax64:n4).

The same seeded numpy weights and patches go into both packages. f32 within
1e-5 relative, bf16 within 1e-2, greedy tokens bit for bit. internvl2-26b's
vocab 92553 is odd and no multiple of 64: its embedding packs with one byte
a code (nibbles need an even K) and its untied unembed does not pack (whole
blocks do not tile N) and is served dense; a smoke vocab of 257 takes both
paths."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.core import build_plan as jbuild_plan
from repro.data import pipeline as jpipe
from repro.models import internvl as jv
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train import loop as jloop

from repro_torch import configs
from repro_torch.core import build_plan
from repro_torch.core.plan import flat_with_paths, map_with_paths
from repro_torch.core.tensor_format import PackedTensor
from repro_torch.data import pipeline
from repro_torch.interop import params_from_numpy
from repro_torch.models import internvl, transformer
from repro_torch.models.api import get_family
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train import loop

from test_torch_whisper import (meta_weight_bytes, reference_full_bytes,
                                spec_fields)

# smoke widths (96, 32) tile by 32-wide blocks, not by 64
ARCH, SPEC = "internvl2-26b", "babsmax32:n4"
KW = dict(batch_slots=2, kv_len=32, prefill_chunk=4)
PROMPTS = ([5, 9, 3, 7, 2, 8], [11, 4], [7, 7, 1])


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, dtype="float32"):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


def cfgs(dtype="float32", **kw):
    kw = dict(dtype=dtype, **kw)
    return (configs.get_config(ARCH, "smoke").replace(**kw),
            jconfigs.get_config(ARCH, "smoke").replace(**kw))


def numpy_params(cfg, seed=0):
    rng = np.random.default_rng(seed)

    def make(path, spec):
        if "norm" in path:
            return (1 + 0.1 * rng.standard_normal(spec.shape)
                    ).astype(np.float32)
        std = 0.5 if "embed" in path else \
            1 / np.sqrt(spec.numel // spec.shape[-1])
        return (rng.standard_normal(spec.shape) * std).astype(np.float32)
    return map_with_paths(make, internvl.param_specs(cfg))


def both_params(cfg, npp, packed):
    jparams = jax.tree.map(jnp.asarray, npp)
    params = params_from_numpy(npp, "cpu")
    if packed:
        jparams = jbuild_plan(jparams, SPEC).pack(
            jparams, jv.transformer.pack_layouts(cfg))
        params = build_plan(params, SPEC).pack(
            params, transformer.pack_layouts(cfg))
    return params, jparams


@pytest.mark.parametrize("variant", ["smoke", "full"])
def test_specs_layouts_and_config_equal(variant):
    cfg = configs.get_config(ARCH, variant)
    jcfg = jconfigs.get_config(ARCH, variant)
    assert cfg.__dict__ == {k: v for k, v in jcfg.__dict__.items()
                            if k in cfg.__dict__}
    assert spec_fields(internvl.param_specs(cfg)) == spec_fields(
        jv.param_specs(jcfg))
    assert spec_fields(internvl.decode_state_specs(cfg, 4, 256, 8)) == \
        spec_fields(jv.decode_state_specs(jcfg, 4, 256, 8))
    fam = get_family("internvl")
    assert fam.pack_layouts(cfg) == jv.transformer.pack_layouts(jcfg)
    assert internvl.D_VIT == jv.D_VIT == 3200


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_apply_with_patches(dtype, packed):
    """The projector (RMSNorm, tanh GELU between two projections) and the
    backbone over the visual prefix and the text."""
    cfg, jcfg = cfgs(dtype)
    params, jparams = both_params(cfg, numpy_params(cfg), packed)
    batch = jpipe.make_batch_fn(jcfg, seq=12, batch=2, seed=1)(0)
    tb = {k: t(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with torch.inference_mode():
        vis = internvl._project_vis(params, tb["vis"], cfg)
        logits = internvl.apply(params, tb, cfg)
    close(vis, jv._project_vis(jparams, jb["vis"], jcfg), dtype)
    want = jv.apply(jparams, jb, jcfg)
    assert tuple(logits.shape) == (2, 8 + 12, cfg.vocab)
    assert logits.dtype == torch.float32
    close(logits, want, dtype)


def test_train_loss_cuts_the_visual_prefix():
    """``shift_labels`` drops the patch positions (no text labels), as the
    reference's: the CE loss over the same logits is equal."""
    cfg, jcfg = cfgs()
    params, jparams = both_params(cfg, numpy_params(cfg), packed=False)
    batch = pipeline.make_batch_fn(cfg, seq=10, batch=2, seed=2)(3)
    with torch.inference_mode():
        logits = internvl.apply(params, {k: t(v) for k, v in batch.items()},
                                cfg)
    got = loop.ce_loss(cfg, logits, {"tokens": t(batch["tokens"])})
    want = jloop.ce_loss(jcfg, jnp.asarray(logits.numpy()),
                         {"tokens": jnp.asarray(batch["tokens"])})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    lg, labels, _ = loop.shift_labels(cfg, {"tokens": t(batch["tokens"])},
                                      logits)
    assert lg.shape[1] == labels.shape[1] == 9


def test_make_batch_fn_and_input_specs_equal():
    from repro.configs import shapes as jshapes
    from repro_torch.configs import shapes
    cfg, jcfg = cfgs()
    fn = pipeline.make_batch_fn(cfg, seq=12, batch=3, seed=5)
    jfn = jpipe.make_batch_fn(jcfg, seq=12, batch=3, seed=5)
    for step in (0, 4):
        got, want = fn(step), jfn(step)
        assert got.keys() == want.keys() == {"tokens", "vis"}
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    for variant in ("smoke", "full"):
        c = configs.get_config(ARCH, variant)
        jc = jconfigs.get_config(ARCH, variant)
        for name, shape in shapes.SHAPES.items():
            got = shapes.input_specs(c, shape)
            want = jshapes.input_specs(jc, jshapes.SHAPES[name])
            assert {k: (v.shape, v.axes, v.dtype) for k, v in got.items()} \
                == {k: (v.shape, v.axes, v.dtype) for k, v in want.items()}


def run_reference(cfg, jcfg, npp, B=2):
    jparams = jax.tree.map(jnp.asarray, npp)
    jplan = jbuild_plan(jparams, SPEC)
    eng = JServeEngine.from_quantised(jcfg, jplan.quantise(jparams), jplan,
                                      **{**KW, "batch_slots": B})
    for rid, p in enumerate(PROMPTS):
        eng.submit(JRequest(prompt=list(p), max_new_tokens=6, rid=rid))
    return {g.rid: g.tokens for g in eng.run()}, eng


@pytest.mark.parametrize("fmt", ["", "q8"], ids=["dense", "q8"])
def test_odd_vocab_serves_byte_codes_and_a_dense_unembed(fmt):
    """vocab 257: the (257, 96) embedding packs with 8-bit codes (odd K),
    the (96, 257) unembed stays dense (257 is no multiple of 32), and the
    engine serves the reference's greedy tokens with the reference's
    resident bytes."""
    cfg, jcfg = cfgs(vocab=257, kv_format=fmt)
    npp = numpy_params(cfg)
    tokens, jeng = run_reference(cfg, jcfg, npp)
    params = params_from_numpy(npp, "cpu")
    plan = build_plan(params, SPEC)
    eng = ServeEngine.from_quantised(cfg, plan.quantise(params), plan,
                                     device="cpu", **KW)
    emb, unemb = eng.params["embed"], eng.params["unembed"]
    assert isinstance(emb, PackedTensor) and emb.bits == 8
    assert tuple(emb.codes.shape) == (257, 96)
    assert not isinstance(unemb, PackedTensor)
    assert tuple(unemb.shape) == (96, 257)
    for rid, p in enumerate(PROMPTS):
        eng.submit(Request(prompt=list(p), max_new_tokens=6, rid=rid))
    assert {g.rid: g.tokens for g in eng.run()} == tokens
    assert eng.weight_bytes() == jeng.weight_bytes()
    assert eng.cache_bytes() == jeng.cache_bytes()


@pytest.mark.parametrize("n_layers", [2, 48])
def test_full_width_weight_bytes_equal_the_reference(n_layers):
    """internvl2-26b at full width, at the card run's 2 layers and at its
    48: the reference's count by its own packing rules, with the embed in
    byte codes and the unembed and projector dense."""
    cfg = configs.get_config(ARCH, "full").replace(n_layers=n_layers)
    jcfg = jconfigs.get_config(ARCH, "full").replace(n_layers=n_layers)
    got = meta_weight_bytes(cfg)
    assert got == reference_full_bytes(jcfg)
    if n_layers == 2:
        assert got == dict(total=3_505_222_336, codes=958_715_904,
                           scales=42_149_568, codebooks=512,
                           dense=2_504_356_352)
    else:
        assert got == dict(total=13_039_825_600, codes=9_930_332_160,
                           scales=602_875_584, codebooks=512,
                           dense=2_506_617_344)


INTERNLM_FULL_BYTES = dict(total=10_553_303_616, codes=9_930_276_864,
                           scales=620_642_304, codebooks=576, dense=2_383_872)


def test_internlm2_full_weight_bytes_equal_the_reference():
    """internlm2-20b full (internvl2-26b's backbone, text only): every
    projection and both tables pack (vocab 92544 = 64 x 1446, untied); the
    reference's count by its own packing rules, which the card run holds
    its engine to."""
    cfg = configs.get_config("internlm2-20b", "full")
    got = meta_weight_bytes(cfg)
    assert got == reference_full_bytes(
        jconfigs.get_config("internlm2-20b", "full"))
    assert got == INTERNLM_FULL_BYTES


@pytest.mark.parametrize("arch,fmt,kv", [
    ("internlm2-20b", "", 207_618_048), ("internvl2-26b", "q8", 107_053_056)])
def test_full_depth_kv_bytes_equal_the_reference(arch, fmt, kv):
    """The card run's serving geometry (4 slots, kv_len 256, chunk 8) at all
    48 layers: internlm2-20b's dense cache, internvl2-26b's q8 one."""
    from repro.models.api import get_family as jget_family
    cfg = configs.get_config(arch, "full").replace(kv_format=fmt)
    jcfg = jconfigs.get_config(arch, "full").replace(kv_format=fmt)
    got = get_family(cfg.family).cache_spec(cfg, 4, 256,
                                            slack=8).cache_bytes()
    assert got == jget_family(jcfg.family).cache_spec(
        jcfg, 4, 256, slack=8).cache_bytes()
    assert got["kv"] == kv


def test_serve_cli_on_cpu(capsys):
    from repro_torch.launch import serve
    done = serve.main(["--arch", ARCH, "--variant", "smoke", "--quantise",
                       SPEC, "--packed", "--kv-format", "q8", "--kv-len",
                       "32", "--requests", "3", "--max-new", "4",
                       "--device", "cpu"])
    assert len(done) == 3 and all(len(g.tokens) == 4 for g in done)
    assert "degraded" not in capsys.readouterr().out


def test_greedy_tokens_of_the_packed_engine_at_b1_and_b4():
    cfg, jcfg = cfgs()
    npp = numpy_params(cfg)
    params = params_from_numpy(npp, "cpu")
    plan = build_plan(params, SPEC)
    for B in (1, 4):
        tokens, _ = run_reference(cfg, jcfg, npp, B)
        eng = ServeEngine.from_quantised(cfg, plan.quantise(params), plan,
                                         device="cpu",
                                         **{**KW, "batch_slots": B})
        for rid, p in enumerate(PROMPTS):
            eng.submit(Request(prompt=list(p), max_new_tokens=6, rid=rid))
        assert {g.rid: g.tokens for g in eng.run()} == tokens, B
    assert [n for n, x in flat_with_paths(eng.params)
            if isinstance(x, PackedTensor) and "vis" in n] == []
