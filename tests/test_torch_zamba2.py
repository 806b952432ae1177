"""zamba2 on the CPU: the port's hybrid family against the reference's, at
zamba2-2.7b smoke (4 Mamba-2 layers in 2 groups of 2, d 128, d_inner 256,
state 16, a shared block of 4 heads of 32, d_ff 256, vocab 256) and at full
width on meta tensors and abstract arrays.

The same seeded numpy weights (with the reference ``init``'s A_log,
dt_bias, D_skip and conv taps) go into both packages, packed cases through
each package's own babsmax64:n4 packing. f32 within 1e-5 relative, bf16
within 2e-2; greedy tokens, ``causal_conv1d`` and the q8/q4 cache scales
bit for bit, the codes but for rare single-codepoint steps
(``hold_codes``). The SSD forms are held to each other in both packages
(the reference's ``tests/test_linear_attn.py``) and across them."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.core import build_plan as jbuild_plan
from repro.data import pipeline as jpipe
from repro.models import layers as jl
from repro.models import zamba2 as jz
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch import configs
from repro_torch.core import build_plan
from repro_torch.core.plan import flat_with_paths, map_with_paths
from repro_torch.core.tensor_format import PackedTensor
from repro_torch.data import pipeline
from repro_torch.interop import params_from_numpy
from repro_torch.models import layers as tl
from repro_torch.models import zamba2
from repro_torch.models.api import family_leaves, get_family
from repro_torch.serve.engine import (Request, ServeEngine,
                                      alloc_decode_state, greedy_generate)

from test_torch_whisper import (meta_weight_bytes, reference_full_bytes,
                                spec_fields)

ARCH, SPEC = "zamba2-2.7b", "babsmax64:n4"
KW = dict(batch_slots=2, kv_len=32, prefill_chunk=4)
PROMPTS = ([5, 9, 3, 7, 2, 8], [11, 4], [7, 7, 1], [3, 1, 4, 1, 5], [2])
MAX_NEW = 6


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, dtype="float32"):
    """f32 within 1e-5 relative; bf16 within 2e-2 of the largest value:
    each Mamba layer and each pass of the shared block alone lands within
    about 7e-3 (two bf16 ulps), and six of them stack."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


def hold_codes(got, want, bits, what):
    """Cache codes against the reference's: equal, but for single-codepoint
    steps on at most 1e-3 of them. The k/v written at a step come from the
    residual after the Mamba layers, which both packages compute to about
    1e-7 in f32 by different summation orders; a value that close to a
    codebook midpoint rounds to the neighbouring code."""
    got, want = got.astype(np.int32), np.asarray(want).astype(np.int32)
    if bits == 4:
        got = np.stack([got & 15, got >> 4], -1)
        want = np.stack([want & 15, want >> 4], -1)
    step = np.abs(got - want)
    assert step.max() <= 1 and (step > 0).mean() <= 1e-3, \
        (what, int((step > 0).sum()), step.size)


def cfgs(dtype="float32", **kw):
    kw = dict(dtype=dtype, **kw)
    return (configs.get_config(ARCH, "smoke").replace(**kw),
            jconfigs.get_config(ARCH, "smoke").replace(**kw))


def numpy_params(cfg, seed=0):
    """Seeded numpy weights: the reference init's SSM vectors and conv
    taps, gains around 1, fan-in scaled matrices, a 0.5-std embedding."""
    rng = np.random.default_rng(seed)
    fixed = {k: v.astype(np.float32)
             for k, v in zamba2._np_overrides(cfg).items()}

    def make(path, spec):
        if path in fixed:
            return fixed[path]
        if "norm" in path:
            return (1 + 0.1 * rng.standard_normal(spec.shape)
                    ).astype(np.float32)
        std = 0.5 if "embed" in path else \
            1 / np.sqrt(spec.numel // spec.shape[-1])
        return (rng.standard_normal(spec.shape) * std).astype(np.float32)
    return map_with_paths(make, zamba2.param_specs(cfg))


def both_params(cfg, npp, packed):
    jparams = jax.tree.map(jnp.asarray, npp)
    params = params_from_numpy(npp, "cpu")
    if packed:
        jparams = jbuild_plan(jparams, SPEC).pack(
            jparams, jz.pack_layouts(cfg))
        params = build_plan(params, SPEC).pack(params,
                                               zamba2.pack_layouts(cfg))
    return params, jparams


# ---------------------------------------------------------------------------
# Specs, configs, registration, cache geometry


@pytest.mark.parametrize("variant", ["smoke", "full"])
def test_param_specs_and_layouts_equal(variant):
    cfg = configs.get_config(ARCH, variant)
    jcfg = jconfigs.get_config(ARCH, variant)
    want = spec_fields(jz.param_specs(jcfg))
    assert spec_fields(zamba2.param_specs(cfg)) == want
    assert zamba2.pack_layouts(cfg) == jz.pack_layouts(jcfg)
    if variant == "full":
        assert sum(int(np.prod(f[0])) for f in want.values()) == \
            2_422_386_848
    for fmt in ("", "q8", "q4"):
        for B, kv in ((1, 16), (4, 256)):
            got = zamba2.decode_state_specs(cfg.replace(kv_format=fmt), B,
                                            kv, slack=8)
            ref = jz.decode_state_specs(jcfg.replace(kv_format=fmt), B, kv,
                                        slack=8)
            assert spec_fields(got) == spec_fields(ref)


def test_configs_and_registry():
    for variant in ("smoke", "full"):
        got = configs.get_config(ARCH, variant)
        want = jconfigs.get_config(ARCH, variant)
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "head_dim", "d_ff", "vocab", "ssm_state",
                  "d_inner", "attn_every", "conv_kernel", "rope_theta",
                  "linear_chunk", "remat"):
            assert getattr(got, f) == getattr(want, f), f
    fam = get_family("zamba2")
    assert fam.supports_ragged and fam.cache_spec is zamba2.cache_spec
    assert fam.finish_leaf is zamba2.finish_leaf


@pytest.mark.parametrize("fmt", ["", "q8", "q4"])
def test_cache_spec_is_one_grouped_global_group(fmt):
    """The shared attention's cache (the reference's
    ``test_serve_windowed.py`` case): one full-length global group over
    the G application points, stacked on the ``groups`` axis, with the
    reference's bytes at smoke and at the card run's full geometry."""
    for variant, B, kv in (("smoke", 2, 32), ("full", 4, 256)):
        cfg = configs.get_config(ARCH, variant).replace(kv_format=fmt)
        jcfg = jconfigs.get_config(ARCH, variant).replace(kv_format=fmt)
        spec = zamba2.cache_spec(cfg, B, kv, slack=8)
        jspec = jz.cache_spec(jcfg, B, kv, slack=8)
        cb = spec.cache_bytes()
        assert cb == jspec.cache_bytes()
        assert fmt or (cb["kv"] == cb["uniform_kv"] and
                       cb["cache_ratio_vs_uniform"] == 1.0)
        assert [tuple(g.layers) for g in spec.groups] == \
            [tuple(range(zamba2._groups(cfg)[0]))]
        assert spec.state_specs()["k0"].axes[0] == "groups"
    full = configs.get_config(ARCH, "full").replace(kv_format=fmt)
    kv = zamba2.cache_spec(full, 4, 256, slack=8).cache_bytes()["kv"]
    assert kv == {"": 97_320_960, "q8": 51_093_504, "q4": 26_763_264}[fmt]


# ---------------------------------------------------------------------------
# The SSD forms (the reference's tests/test_linear_attn.py, both packages)


def ssd_inputs(seed, B=2, T=64, H=3, hd=8, N=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (B, T, H)).astype(np.float32)
    a = rng.uniform(0.7, 0.999, (B, T, H)).astype(np.float32)
    Bm = rng.standard_normal((B, T, N)).astype(np.float32)
    Cm = rng.standard_normal((B, T, N)).astype(np.float32)
    return x, dt, a, Bm, Cm


@pytest.mark.parametrize("chunk", [2, 4, 8, 32])
def test_ssd_chunked_equals_scan_in_both_packages(chunk):
    args = ssd_inputs(chunk)
    h0 = np.random.default_rng(5).standard_normal((2, 3, 8, 4)).astype(
        np.float32)
    ty, th = zamba2.ssd_chunked(*map(t, args), t(h0), chunk=chunk)
    sy, sh = zamba2.ssd_scan(*map(t, args), t(h0))
    jargs = [jnp.asarray(a) for a in (*args, h0)]
    jy, jh = jz.ssd_chunked(*jargs, chunk=chunk)
    jsy, jsh = jz.ssd_scan(*jargs)
    for got, want in ((ty, sy), (th, sh)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-4)
    for got, want in ((ty, jy), (th, jh), (sy, jsy), (sh, jsh)):
        close(got, want)


def test_ssd_strong_decay_stays_finite():
    """Decays down to 1e-3 hit the -20 per-step clamp and the -80 floor:
    finite, and equal to the reference's chunked form."""
    x, dt, _, Bm, Cm = ssd_inputs(7)
    a = np.random.default_rng(8).uniform(1e-3, 0.5, dt.shape).astype(
        np.float32)
    y, h = zamba2.ssd_chunked(*map(t, (x, dt, a, Bm, Cm)), chunk=32)
    assert bool(torch.isfinite(y).all() and torch.isfinite(h).all())
    close(y, jz.ssd_chunked(*map(jnp.asarray, (x, dt, a, Bm, Cm)),
                            chunk=32)[0])


def test_ssd_gradients_match():
    args = ssd_inputs(2, T=32)

    def grad(fn):
        x = t(args[0]).requires_grad_()
        y, h = fn(x, *map(t, args[1:]))
        ((y * 0.1).sum() + (h * 0.01).sum()).backward()
        return x.grad

    g_chk = grad(lambda *a: zamba2.ssd_chunked(*a, chunk=8))
    g_scan = grad(zamba2.ssd_scan)
    np.testing.assert_allclose(g_chk.numpy(), g_scan.numpy(), rtol=1e-3,
                               atol=1e-4)

    def jloss(xx):
        y, h = jz.ssd_chunked(xx, *map(jnp.asarray, args[1:]), chunk=8)
        return jnp.sum(y * 0.1) + jnp.sum(h * 0.01)
    np.testing.assert_allclose(g_chk.numpy(),
                               np.asarray(jax.grad(jloss)(
                                   jnp.asarray(args[0]))),
                               rtol=1e-4, atol=1e-5)


@given(seed=st.integers(0, 1000))
@settings(max_examples=10, deadline=None)
def test_ssd_property_equivalence(seed):
    args = ssd_inputs(seed, B=1, T=32, H=1, hd=4, N=4)
    y_chk, _ = zamba2.ssd_chunked(*map(t, args), chunk=8)
    y_ref, _ = zamba2.ssd_scan(*map(t, args))
    np.testing.assert_allclose(y_chk.numpy(), y_ref.numpy(), rtol=2e-4,
                               atol=2e-4)


# ---------------------------------------------------------------------------
# causal_conv1d and the Mamba layer


@pytest.mark.parametrize("case", ["no_state", "state", "ragged"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_bitwise(case, dtype):
    """The sum of shifted products, with and without streaming state and
    with ragged ``n_valid`` (a row with 0 keeps its state): outputs and
    new states bit for bit."""
    rng = np.random.default_rng(3)
    B, T, C, Kw = 3, 6, 40, 4
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    w = rng.standard_normal((Kw, C)).astype(np.float32)
    state = (None if case == "no_state" else
             rng.standard_normal((B, Kw - 1, C)).astype(np.float32))
    n_valid = np.array([6, 2, 0], np.int32) if case == "ragged" else None
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    y, s = tl.causal_conv1d(
        t(x).to(tdt), t(w).to(tdt),
        None if state is None else t(state).to(tdt),
        n_valid=None if n_valid is None else t(n_valid))
    jy, js = jl.causal_conv1d(
        jnp.asarray(x, jdt), jnp.asarray(w, jdt),
        None if state is None else jnp.asarray(state, jdt),
        n_valid=None if n_valid is None else jnp.asarray(n_valid))
    assert y.dtype == tdt
    np.testing.assert_array_equal(y.float().numpy(),
                                  np.asarray(jy, np.float32))
    np.testing.assert_array_equal(s.float().numpy(),
                                  np.asarray(js, np.float32))
    if case == "ragged":
        assert torch.equal(s[2], t(state[2]).to(tdt))


@pytest.mark.parametrize("T", [1, 6, 8])
def test_mamba_layer_on_a_ragged_chunk(T):
    """One Mamba-2 layer with carried conv/SSM state and a ragged mask
    (1 = scan, 6 = chunks of 3, 8 = chunks of 4): output and both new
    states."""
    cfg, jcfg = cfgs()
    params, jparams = both_params(cfg, numpy_params(cfg), packed=False)
    lp = {k: v[1, 0] for k, v in params["mamba"].items()}
    jlp = jax.tree.map(lambda a: a[1, 0], jparams["mamba"])
    rng = np.random.default_rng(T)
    x = rng.standard_normal((3, T, 128)).astype(np.float32)
    cs = rng.standard_normal((3, 3, 288)).astype(np.float32)
    ss = rng.standard_normal((3, 4, 64, 16)).astype(np.float32)
    valid = np.arange(T)[None] < np.array([T, max(T - 2, 1), 0])[:, None]
    out, (c, s) = zamba2.mamba_layer(t(x), lp, cfg, t(cs), t(ss), t(valid))
    jout, (jc, js) = jz.mamba_layer(jnp.asarray(x), jlp, jcfg,
                                    jnp.asarray(cs), jnp.asarray(ss),
                                    jnp.asarray(valid))
    for got, want in ((out, jout), (c, jc), (s, js)):
        close(got, want)
    assert torch.equal(c[2], t(cs[2])) and torch.equal(s[2], t(ss[2]))


# ---------------------------------------------------------------------------
# apply


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_apply(dtype, packed):
    """64 tokens: the chunked SSD at the config's chunk of 32, and the
    shared block's flash attention at every group."""
    cfg, jcfg = cfgs(dtype)
    params, jparams = both_params(cfg, numpy_params(cfg), packed)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 64)).astype(
        np.int32)
    with torch.inference_mode():
        logits = zamba2.apply(params, {"tokens": t(toks)}, cfg)
    assert logits.dtype == torch.float32
    assert tuple(logits.shape) == (2, 64, cfg.vocab)
    close(logits, jz.apply(jparams, {"tokens": jnp.asarray(toks)}, jcfg),
          dtype)


def test_decode_matches_forward():
    """The reference's ``test_arch_smoke.py`` case on the port: eight
    single-token decode steps equal ``apply``'s logits."""
    cfg, _ = cfgs()
    params = zamba2.init(cfg, seed=3, device="cpu")
    toks = t(np.random.default_rng(3).integers(0, cfg.vocab, (1, 8)))
    with torch.inference_mode():
        ref = zamba2.apply(params, {"tokens": toks}, cfg)
        state = alloc_decode_state(get_family("zamba2"), cfg, 1, 8, slack=1,
                                   device="cpu")
        outs = []
        for i in range(8):
            logits, state = zamba2.decode_step(
                params, state, {"tokens": toks[:, i:i + 1]}, cfg)
            outs.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), ref.numpy(),
                               rtol=2e-4, atol=2e-4)


def test_apply_backward_under_remat():
    cfg, _ = cfgs(remat="full")
    params = map_with_paths(lambda _, a: a.requires_grad_(),
                            params_from_numpy(numpy_params(cfg), "cpu"))
    batch = pipeline.make_batch_fn(cfg, seq=40, batch=2)(0)
    logits = zamba2.apply(params, {"tokens": t(batch["tokens"])}, cfg)
    logits.logsumexp(-1).sum().backward()
    for group, name in (("mamba", "in_proj"), ("mamba", "A_log"),
                        ("mamba", "conv_w"), ("shared", "wq"),
                        ("shared", "w_down")):
        g = params[group][name].grad
        assert g is not None and torch.isfinite(g).all() and \
            g.abs().sum() > 0, name


# ---------------------------------------------------------------------------
# Serving against the reference's engine


def run_reference(fmt="", B=2, packed=True, n_req=None):
    """The JAX engine over the quantised checkpoint: tokens per rid, every
    step's state in and out, batch and logits, and its byte accounting."""
    cfg, jcfg = cfgs(kv_format=fmt)
    npp = numpy_params(cfg)
    jparams = jax.tree.map(jnp.asarray, npp)
    jplan = jbuild_plan(jparams, SPEC)
    eng = JServeEngine.from_quantised(jcfg, jplan.quantise(jparams), jplan,
                                      packed=packed,
                                      **{**KW, "batch_slots": B})
    steps = []
    step = eng._step

    def recording_step(p, s, b):
        rec = {"state": {k: np.asarray(v) for k, v in s.items()},
               "batch": {k: np.asarray(v) for k, v in b.items()}}
        logits, new = step(p, s, b)
        rec["logits"] = np.asarray(logits)
        rec["new"] = {k: np.asarray(v) for k, v in new.items()}
        steps.append(rec)
        return logits, new
    eng._step = recording_step
    reqs = [list(PROMPTS[i % len(PROMPTS)]) for i in range(n_req or B + 1)]
    for rid, p in enumerate(reqs):
        eng.submit(JRequest(prompt=p, max_new_tokens=MAX_NEW, rid=rid))
    tokens = {g.rid: g.tokens for g in eng.run()}
    return dict(cfg=cfg, tokens=tokens, steps=steps, npp=npp, reqs=reqs,
                weight=eng.weight_bytes(), cache=eng.cache_bytes(),
                state={k: np.asarray(v) for k, v in eng._state.items()})


def port_engine(ref, B=2, packed=True):
    params = params_from_numpy(ref["npp"], "cpu")
    plan = build_plan(params, SPEC)
    return ServeEngine.from_quantised(ref["cfg"], plan.quantise(params),
                                      plan, packed=packed, device="cpu",
                                      **{**KW, "batch_slots": B})


def run_port(eng, reqs):
    for rid, p in enumerate(reqs):
        eng.submit(Request(prompt=p, max_new_tokens=MAX_NEW, rid=rid))
    return {g.rid: g.tokens for g in eng.run()}


GREEDY = [(B, packed) for packed in (False, True) for B in (1, 2, 4)]


@pytest.mark.parametrize("B,packed", GREEDY,
                         ids=[f"B{b}-{'packed' if p else 'dense'}"
                              for b, p in GREEDY])
def test_greedy_tokens_match_the_reference(B, packed):
    """B + 1 requests, so a slot is reused; the byte accounting too."""
    ref = run_reference(B=B, packed=packed)
    eng = port_engine(ref, B, packed)
    assert run_port(eng, ref["reqs"]) == ref["tokens"]
    assert eng.weight_bytes() == ref["weight"]
    assert eng.cache_bytes() == ref["cache"]


@pytest.fixture(scope="module", params=["", "q8", "q4"],
                ids=["dense", "q8", "q4"])
def stepped(request):
    ref = run_reference(request.param, B=2, n_req=4)
    return request.param, ref, port_engine(ref)


def test_decode_step_on_the_reference_steps(stepped, monkeypatch):
    """Every recorded step of the reference's engine through the port's
    ``decode_step`` from the reference's state: the conv and SSM state it
    returns within 1e-5, and the shared block's cache as the reference left
    it (dense within 1e-5; q8/q4 scales bit for bit and codes by
    ``hold_codes``). The logits of every valid position within 1e-5: a
    quantised step is run again with the port's cache write replaced by a
    copy of the rows the reference's step wrote, so that both read the same
    codes (as ``chip_smoke.py`` holds the card to the CPU)."""
    fmt, ref, eng = stepped
    assert any("reset" in r["batch"] for r in ref["steps"])
    kv = ["k0", "v0"] + (["k0s", "v0s"] if fmt else [])
    bits = 4 if fmt == "q4" else 8

    def step(rec, state):
        batch = {k: t(v) for k, v in rec["batch"].items()}
        with torch.inference_mode():
            return zamba2.decode_step(eng.params, state, batch, eng.cfg)

    for rec in ref["steps"]:
        logits, new = step(rec, {k: t(v) for k, v in rec["state"].items()})
        for k in ("conv", "ssm"):
            close(new[k], rec["new"][k])
        for k in kv:
            if not fmt:
                close(new[k], rec["new"][k])
            elif k.endswith("s"):
                np.testing.assert_array_equal(new[k].numpy(),
                                              rec["new"][k], err_msg=k)
            else:
                hold_codes(new[k].numpy(), rec["new"][k], bits, k)
        assert new["pos"].tolist() == rec["new"]["pos"].tolist()
        if fmt:
            groups = iter(range(zamba2._groups(eng.cfg)[0]))

            def write_reference_rows(k_cache, v_cache, *a, **kw):
                g = next(groups)
                for cache, key in ((k_cache, "k0"), (v_cache, "v0")):
                    cache.codes.copy_(t(rec["new"][key][g]))
                    cache.scales.copy_(t(rec["new"][key + "s"][g]))
                return k_cache, v_cache
            with monkeypatch.context() as m:
                m.setattr(tl, "write_kv_pair", write_reference_rows)
                logits, _ = step(rec, {k: t(v)
                                       for k, v in rec["state"].items()})
        for i, tv in enumerate(rec["batch"]["t_valid"]):
            if tv:
                close(logits[i, :tv], rec["logits"][i, :tv])
    assert new["k0"].dtype == (torch.uint8 if fmt else torch.float32)


def test_quantised_cache_tokens_and_final_state(stepped):
    """The whole run on the port's engine: the reference's tokens, and its
    final cache (scales bit for bit under q8/q4, codes by ``hold_codes``)."""
    fmt, ref, eng = stepped
    assert run_port(eng, ref["reqs"]) == ref["tokens"]
    for k in ["k0", "v0"] + (["k0s", "v0s"] if fmt else []):
        if not fmt:
            close(eng._state[k], ref["state"][k])
        elif k.endswith("s"):
            np.testing.assert_array_equal(eng._state[k].numpy(),
                                          ref["state"][k], err_msg=k)
        else:
            hold_codes(eng._state[k].numpy(), ref["state"][k],
                       4 if fmt == "q4" else 8, k)
    assert eng.cache_bytes() == ref["cache"]


class TestRaggedServing:
    """The reference's ``tests/test_serve_ragged.py`` cases on the port."""

    CFG = cfgs()[0]

    def params(self):
        return params_from_numpy(numpy_params(self.CFG), "cpu")

    def test_reused_slot_matches_fresh_engine(self):
        params = self.params()
        kw = dict(batch_slots=1, kv_len=32, prefill_chunk=4, device="cpu")
        eng = ServeEngine(self.CFG, params, **kw)
        eng.submit(Request(prompt=[5, 9, 3, 7, 2], max_new_tokens=5, rid=0))
        eng.submit(Request(prompt=[11, 4, 6], max_new_tokens=5, rid=1))
        done = {g.rid: g.tokens for g in eng.run()}
        fresh = ServeEngine(self.CFG, params, **kw)
        fresh.submit(Request(prompt=[11, 4, 6], max_new_tokens=5, rid=1))
        assert done[1] == fresh.run()[0].tokens

    def test_multi_wave_matches_single_sequence(self):
        params = self.params()
        eng = ServeEngine(self.CFG, params, batch_slots=2, kv_len=32,
                          prefill_chunk=4, device="cpu")
        prompts = {0: [1, 2, 3], 1: [9, 8, 7, 6, 5], 2: [4, 13], 3: [2, 2]}
        for rid, p in prompts.items():
            eng.submit(Request(prompt=p, max_new_tokens=4, rid=rid))
        done = {g.rid: g.tokens for g in eng.run()}
        for rid, p in prompts.items():
            want = greedy_generate(self.CFG, params, np.asarray([p]), 4,
                                   kv_len=32, device="cpu")
            assert done[rid] == list(want[0]), rid

    @pytest.mark.parametrize("fmt", ["", "q8"])
    def test_chunked_prefill_equals_token_by_token(self, fmt):
        """Prefill chunk 8 (the block-parallel form, inner chunks of 4)
        against chunk 1 (the scan): the same tokens."""
        cfg = self.CFG.replace(kv_format=fmt)
        params = self.params()
        prompts = {0: [5, 9, 3, 7, 2, 8, 1, 6, 4, 10, 12], 1: [11, 4, 7]}
        outs = {}
        for chunk in (1, 8):
            eng = ServeEngine(cfg, params, batch_slots=2, kv_len=32,
                              prefill_chunk=chunk, device="cpu")
            for rid, p in prompts.items():
                eng.submit(Request(prompt=p, max_new_tokens=6, rid=rid))
            outs[chunk] = {g.rid: g.tokens for g in eng.run()}
        assert outs[1] == outs[8]

    def test_t_valid_padding_stays_out_of_the_state(self):
        """A 4-token chunk of which row 0 has 2 valid tokens leaves row 0's
        conv and SSM state as a 2-token chunk leaves them, and row 1 with
        none untouched."""
        params = self.params()
        fam = get_family("zamba2")
        toks = t(np.array([[5, 9, 3, 7], [1, 2, 3, 4]], np.int32))
        with torch.inference_mode():
            st = alloc_decode_state(fam, self.CFG, 2, 16, slack=4,
                                    device="cpu")
            st["ssm"].normal_(generator=torch.Generator().manual_seed(0))
            st["conv"].normal_(generator=torch.Generator().manual_seed(1))
            before = {k: v.clone() for k, v in st.items()}
            _, padded = zamba2.decode_step(
                params, st, {"tokens": toks,
                             "t_valid": t(np.array([2, 0], np.int32))},
                self.CFG)
            st2 = {k: v.clone() for k, v in before.items()}
            _, short = zamba2.decode_step(
                params, st2, {"tokens": toks[:, :2]}, self.CFG)
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(padded[k][:, :, 0].float().numpy(),
                                       short[k][:, :, 0].float().numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
            assert torch.equal(padded[k][:, :, 1], before[k][:, :, 1]), k
        assert padded["pos"].tolist() == [2, 0]

    def test_reset_wipes_the_slot_state(self):
        params = self.params()
        fam = get_family("zamba2")
        with torch.inference_mode():
            st = alloc_decode_state(fam, self.CFG, 2, 16, slack=4,
                                    device="cpu")
            for k in ("conv", "ssm", "k0", "v0"):
                st[k].fill_(0.5)
            st["pos"] = t(np.array([3, 5], np.int32))
            fresh = alloc_decode_state(fam, self.CFG, 1, 16, slack=4,
                                       device="cpu")
            batch = {"tokens": t(np.array([[7], [2]], np.int32)),
                     "reset": t(np.array([True, False]))}
            logits, new = zamba2.decode_step(params, st, batch, self.CFG)
            want, _ = zamba2.decode_step(
                params, fresh, {"tokens": batch["tokens"][:1]}, self.CFG)
        assert new["pos"].tolist() == [1, 6]
        close(logits[:1], want.numpy())
        assert bool((new["k0"][:, 0, 1:] == 0).all())
        assert bool((new["k0"][:, 1, :5] == 0.5).all() and
                    (new["k0"][:, 1, 6:] == 0.5).all())


def test_q8_drift_bounded():
    """The reference's ``tests/test_serve_kv_quant.py::TestGreedyDrift``
    case (its zamba2 row) on the port, over the reference's own weights
    (``init`` at PRNGKey(0)): the dense and q8 greedy tokens equal the
    reference's, and q8 flips at most one of 8 tokens."""
    from repro.serve.engine import greedy_generate as jgreedy
    cfg, jcfg = cfgs()
    jparams = jz.init(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    prompt = np.asarray([[5, 3, 11, 2, 7, 1]], np.int32)
    out = {}
    for fmt in ("", "q8"):
        got = greedy_generate(cfg.replace(kv_format=fmt), params, prompt, 8,
                              kv_len=32, device="cpu")
        want = jgreedy(jcfg.replace(kv_format=fmt), jparams, prompt, 8,
                       kv_len=32)
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=fmt)
        out[fmt] = got
    assert int((out[""] != out["q8"]).sum()) <= 1


class TestUnifiedPackedFamilies:
    """The reference's ``tests/test_serve.py::TestUnifiedPackedFamilies``
    on the port: ``out_proj`` and the shared block packed, ``in_proj``
    dense (its output, 2·256 + 2·16 + 4 = 548, is no multiple of 64, as
    zamba2-2.7b's 10448), greedy tokens equal to the dequantised-dense
    engine's."""

    def engines(self, **kw):
        cfg, _ = cfgs()
        params = params_from_numpy(numpy_params(cfg), "cpu")
        plan = build_plan(params, SPEC)
        q = plan.quantise(params)
        return (ServeEngine.from_quantised(cfg, q, plan, device="cpu", **kw),
                ServeEngine.from_quantised(cfg, q, plan, packed=False,
                                           device="cpu", **kw))

    def test_projections_held_packed(self):
        eng, _ = self.engines(batch_slots=1, kv_len=32)
        leaves = dict(flat_with_paths(eng.params))
        out = leaves["['mamba']['out_proj']"]
        assert isinstance(out, PackedTensor) and out.bits == 4
        assert tuple(out.codes.shape[:2]) == (2, 2)
        packed = [n for n, x in leaves.items() if isinstance(x, PackedTensor)]
        assert len(packed) >= 8 and isinstance(leaves["['embed']"],
                                               PackedTensor)
        assert len(packed) == 10     # out_proj, 7 shared, embed, unembed
        assert not isinstance(leaves["['mamba']['in_proj']"], PackedTensor)

    def test_packed_greedy_tokens_identical(self):
        eng_p, eng_d = self.engines(batch_slots=2, kv_len=32,
                                    prefill_chunk=4)
        for eng in (eng_p, eng_d):
            eng.submit(Request(prompt=[5, 9, 3, 7], max_new_tokens=6, rid=0))
            eng.submit(Request(prompt=[11, 4], max_new_tokens=6, rid=1))
        a = {g.rid: g.tokens for g in eng_p.run()}
        b = {g.rid: g.tokens for g in eng_d.run()}
        assert set(a) == {0, 1} and a == b


# ---------------------------------------------------------------------------
# Bytes and init at full size


def test_full_weight_bytes_equal_the_reference():
    """zamba2-2.7b full: 10 packed tensors and the dense f32 ``in_proj``
    (54 x 2560 x 10448 x 4 bytes), the count the card run holds its
    engine to."""
    cfg = configs.get_config(ARCH, "full")
    got = meta_weight_bytes(cfg)
    assert got == reference_full_bytes(jconfigs.get_config(ARCH, "full"))
    assert got == dict(total=6_302_360_832, codes=488_243_200,
                       scales=30_515_200, codebooks=640,
                       dense=5_783_601_792)


def test_family_leaves_equal_init_and_the_reference_overrides():
    """The leaf-streamed draw ``build_packed_engine`` packs equals
    ``init`` leaf by leaf, and A_log, dt_bias, D_skip and conv_w are the
    reference init's bit for bit (``np.random.default_rng(0)`` in its
    order)."""
    cfg, jcfg = cfgs()
    whole = dict(flat_with_paths(zamba2.init(cfg, seed=3, device="cpu")))
    streamed = dict(family_leaves(cfg, seed=3, device="cpu"))
    assert whole.keys() == streamed.keys()
    for k in whole:
        assert torch.equal(whole[k], streamed[k]), k
    jparams = jz.init(jax.random.PRNGKey(0), jcfg)
    for name in ("A_log", "dt_bias", "D_skip", "conv_w"):
        got = whole[f"['mamba']['{name}']"]
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jparams["mamba"][name]),
                                      err_msg=name)


# ---------------------------------------------------------------------------
# Batches, the scheduler, the command line


def test_make_batch_fn_equal():
    cfg, jcfg = cfgs()
    fn = pipeline.make_batch_fn(cfg, seq=12, batch=3, seed=5)
    jfn = jpipe.make_batch_fn(jcfg, seq=12, batch=3, seed=5)
    for step in (0, 4):
        got, want = fn(step), jfn(step)
        assert got.keys() == want.keys() == {"tokens"}
        np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_scheduler_takes_the_recompute_path():
    """zamba2 carries conv and SSM state besides its KV cache, so a shared
    prefix is recomputed, not forked, with one warning: the tokens equal a
    direct engine's."""
    from repro_torch.serve.scheduler import Scheduler
    cfg, _ = cfgs()
    params = params_from_numpy(numpy_params(cfg), "cpu")
    prefix = [5, 9, 3, 7]
    prompts = [prefix + [2, 8], prefix + [1]]
    direct = ServeEngine(cfg, params, device="cpu", **KW)
    want = run_port(direct, prompts)
    eng = ServeEngine(cfg, params, device="cpu", **KW)
    sched = Scheduler(eng)
    sched.register_prefix("sys", prefix)
    assert not sched.pool.fork_capable
    for i, pr in enumerate(prompts):
        sched.submit(list(pr), max_new_tokens=MAX_NEW, prefix="sys", rid=i)
    with pytest.warns(RuntimeWarning, match="recomputed, not forked"):
        done = {g.rid: g.tokens for g in sched.run()}
    assert done == want
    assert sched.stats["forks"] == 0


def test_serve_cli_on_cpu(capsys):
    """``launch.serve --arch zamba2-2.7b`` packed, dense and q8 caches."""
    from repro_torch.launch import serve
    for kv in ("f32", "q8"):
        done = serve.main(["--arch", ARCH, "--variant", "smoke",
                           "--quantise", SPEC, "--packed", "--kv-format", kv,
                           "--kv-len", "32", "--requests", "3",
                           "--max-new", "4", "--device", "cpu"])
        assert len(done) == 3 and all(len(g.tokens) == 4 for g in done)
    out = capsys.readouterr().out
    assert "packed babsmax64:n4" in out and "quantised KV (q8)" in out
