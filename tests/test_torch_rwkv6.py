"""rwkv6 on the CPU: the port's recurrent family against the reference's, at
rwkv6-1.6b smoke (2 layers, d 128, 2 heads of 64, d_ff 256, vocab 256) and
at full width on meta tensors and abstract arrays.

The same seeded numpy weights (with the reference ``init``'s decay spread
and lerp coefficients) go into both packages, packed cases through each
package's own babsmax64:n4 packing. f32 within 1e-5 relative, bf16 within
1e-2; greedy tokens equal. The WKV forms are held to each other in both
packages (the reference's ``tests/test_linear_attn.py``) and across them."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.core import build_plan as jbuild_plan
from repro.data import pipeline as jpipe
from repro.models import rwkv6 as jr
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch import configs
from repro_torch.core import build_plan
from repro_torch.core.plan import flat_with_paths, map_with_paths
from repro_torch.core.tensor_format import PackedTensor
from repro_torch.data import pipeline
from repro_torch.interop import params_from_numpy
from repro_torch.models import rwkv6
from repro_torch.models.api import family_leaves, get_family
from repro_torch.serve.engine import (Request, ServeEngine,
                                      alloc_decode_state, greedy_generate)

from test_torch_whisper import (meta_weight_bytes, reference_full_bytes,
                                spec_fields)

ARCH, SPEC = "rwkv6-1.6b", "babsmax64:n4"
KW = dict(batch_slots=2, kv_len=32, prefill_chunk=4)
PROMPTS = ([5, 9, 3, 7, 2, 8], [11, 4], [7, 7, 1], [3, 1, 4, 1, 5], [2])
MAX_NEW = 6
STATE = ("tm_x", "cm_x", "wkv")


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
    """Seeded numpy weights: the reference init's w0 and mu_*, gains around
    1, fan-in scaled matrices, a 0.5-std embedding."""
    rng = np.random.default_rng(seed)
    probe = torch.zeros(1)

    def make(path, spec):
        fixed = rwkv6.finish_leaf(cfg, path, probe)
        if fixed is not probe:
            return fixed.numpy()
        if "norm" in path or "ln_x" in path:
            return (1 + 0.1 * rng.standard_normal(spec.shape)
                    ).astype(np.float32)
        std = 0.5 if "embed" in path else \
            1 / np.sqrt(spec.numel // spec.shape[-1])
        return (rng.standard_normal(spec.shape) * std).astype(np.float32)
    return map_with_paths(make, rwkv6.param_specs(cfg))


def both_params(cfg, npp, packed):
    jparams = jax.tree.map(jnp.asarray, npp)
    params = params_from_numpy(npp, "cpu")
    if packed:
        jparams = jbuild_plan(jparams, SPEC).pack(
            jparams, jr.pack_layouts(cfg))
        params = build_plan(params, SPEC).pack(params,
                                               rwkv6.pack_layouts(cfg))
    return params, jparams


# ---------------------------------------------------------------------------
# Specs, configs, registration


@pytest.mark.parametrize("variant", ["smoke", "full"])
def test_param_specs_and_layouts_equal(variant):
    cfg = configs.get_config(ARCH, variant)
    jcfg = jconfigs.get_config(ARCH, variant)
    want = spec_fields(jr.param_specs(jcfg))
    assert spec_fields(rwkv6.param_specs(cfg)) == want
    assert rwkv6.pack_layouts(cfg) == jr.pack_layouts(jcfg)
    if variant == "full":
        assert sum(int(np.prod(f[0])) for f in want.values()) == \
            1_583_941_632
    for B, kv in ((1, 16), (4, 256)):
        got = rwkv6.decode_state_specs(cfg, B, kv, slack=8)
        ref = jr.decode_state_specs(jcfg, B, kv, slack=8)
        assert spec_fields(got) == spec_fields(ref)


def test_configs_and_registry():
    for variant in ("smoke", "full"):
        got = configs.get_config(ARCH, variant)
        want = jconfigs.get_config(ARCH, variant)
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab", "linear_chunk", "norm_eps",
                  "tie_embeddings", "remat"):
            assert getattr(got, f) == getattr(want, f), f
    fam = get_family("rwkv6")
    assert fam.supports_ragged and fam.cache_spec is None
    assert fam.finish_leaf is rwkv6.finish_leaf


# ---------------------------------------------------------------------------
# The WKV forms (the reference's tests/test_linear_attn.py, both packages)


def wkv_inputs(seed, B=2, T=64, H=2, hd=8, decay_lo=0.85):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(decay_lo, 0.999, (B, T, H, hd)).astype(np.float32)
    u = (rng.standard_normal((H, hd)) * 0.3).astype(np.float32)
    return r, k, v, w, u


@pytest.mark.parametrize("chunk", [2, 4, 8, 32])
def test_wkv_chunked_equals_scan_in_both_packages(chunk):
    """Chunked against scan with an initial state, in each package (1e-4,
    the reference's tolerance), and each form across the packages (1e-5
    relative): outputs and final states."""
    args = wkv_inputs(chunk)
    s0 = np.random.default_rng(9).standard_normal((2, 2, 8, 8)).astype(
        np.float32)
    ty, ts = rwkv6.wkv_chunked(*map(t, args), t(s0), chunk=chunk)
    sy, ss = rwkv6.wkv_scan(*map(t, args), t(s0))
    jargs = [jnp.asarray(a) for a in (*args, s0)]
    jy, js = jr.wkv_chunked(*jargs, chunk=chunk)
    jsy, jss = jr.wkv_scan(*jargs)
    for got, want in ((ty, sy), (ts, ss)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-4)
    for got, want in ((ty, jy), (ts, js), (sy, jsy), (ss, jss)):
        close(got, want)


def test_wkv_strong_decay_stays_finite():
    """Decays down to 0.05 hit the -20 per-step clamp: the chunked output
    stays finite and near the scan's, and equals the reference's."""
    args = wkv_inputs(2, decay_lo=0.05)
    y, _ = rwkv6.wkv_chunked(*map(t, args), chunk=16)
    ys, _ = rwkv6.wkv_scan(*map(t, args))
    assert bool(torch.isfinite(y).all())
    np.testing.assert_allclose(y.numpy(), ys.numpy(), rtol=5e-3, atol=5e-3)
    close(y, jr.wkv_chunked(*map(jnp.asarray, args), chunk=16)[0])


def test_wkv_gradients_match():
    """Autograd through the chunked form equals it through the scan, and
    the reference's gradient of the chunked form."""
    args = wkv_inputs(3, T=32)

    def grad(fn):
        r = t(args[0]).requires_grad_()
        y, s = fn(r, *map(t, args[1:]))
        ((y * 0.1).sum() + (s * 0.01).sum()).backward()
        return r.grad

    g_chk = grad(lambda *a: rwkv6.wkv_chunked(*a, chunk=8))
    g_scan = grad(rwkv6.wkv_scan)
    np.testing.assert_allclose(g_chk.numpy(), g_scan.numpy(), rtol=1e-3,
                               atol=1e-4)

    def jloss(rr):
        y, s = jr.wkv_chunked(rr, *map(jnp.asarray, args[1:]), chunk=8)
        return jnp.sum(y * 0.1) + jnp.sum(s * 0.01)
    np.testing.assert_allclose(g_chk.numpy(),
                               np.asarray(jax.grad(jloss)(
                                   jnp.asarray(args[0]))),
                               rtol=1e-4, atol=1e-5)


@given(seed=st.integers(0, 1000))
@settings(max_examples=10, deadline=None)
def test_wkv_property_equivalence(seed):
    args = wkv_inputs(seed, B=1, T=32, H=1, hd=4)
    y_chk, _ = rwkv6.wkv_chunked(*map(t, args), chunk=8)
    y_ref, _ = rwkv6.wkv_scan(*map(t, args))
    np.testing.assert_allclose(y_chk.numpy(), y_ref.numpy(), rtol=2e-4,
                               atol=2e-4)


# ---------------------------------------------------------------------------
# Layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm(dtype):
    rng = np.random.default_rng(0)
    y = (rng.standard_normal((2, 5, 2, 64)) * 3 + 1).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    tdt = getattr(torch, dtype)
    got = rwkv6._group_norm(t(y).to(tdt), t(g), 1e-5)
    assert got.dtype == tdt
    close(got, jr._group_norm(jnp.asarray(y, dtype), jnp.asarray(g), 1e-5),
          dtype)


@pytest.mark.parametrize("T", [1, 6, 8])
def test_time_and_channel_mix_on_a_ragged_chunk(T):
    """One layer's mixes with carried state and a ragged ``valid`` mask:
    outputs, the new token-shift inputs and the WKV state (the serving
    inner chunk: 1 = scan, 6 = chunks of 3, 8 = chunks of 4)."""
    cfg, jcfg = cfgs()
    params, jparams = both_params(cfg, numpy_params(cfg), packed=False)
    lp = {k: v[0] for k, v in params["layers"].items()}
    jlp = jax.tree.map(lambda a: a[0], jparams["layers"])
    rng = np.random.default_rng(T)
    x = rng.standard_normal((3, T, 128)).astype(np.float32)
    last = rng.standard_normal((3, 128)).astype(np.float32)
    s0 = rng.standard_normal((3, 2, 64, 64)).astype(np.float32)
    valid = np.arange(T)[None] < np.array([T, max(T - 2, 1), 0])[:, None]
    out, (nl, s) = rwkv6.time_mix(t(x), lp, cfg, t(last), t(s0), t(valid))
    jout, (jnl, js) = jr.time_mix(jnp.asarray(x), jlp, jcfg,
                                  jnp.asarray(last), jnp.asarray(s0),
                                  jnp.asarray(valid))
    for got, want in ((out, jout), (nl, jnl), (s, js)):
        close(got, want)
    cout, cnl = rwkv6.channel_mix(t(x), lp, cfg, t(last), t(valid))
    jcout, jcnl = jr.channel_mix(jnp.asarray(x), jlp, jcfg,
                                 jnp.asarray(last), jnp.asarray(valid))
    close(cout, jcout)
    close(cnl, jcnl)
    assert torch.equal(nl[2], t(last[2]))     # no valid token: kept


# ---------------------------------------------------------------------------
# apply


APPLY = [(dtype, packed, T) for dtype in ("float32", "bfloat16")
         for packed in (False, True) for T in (24, 64)]


@pytest.mark.parametrize("dtype,packed,T", APPLY, ids=[
    f"{d}-{'packed' if p else 'dense'}-T{T}" for d, p, T in APPLY])
def test_apply(dtype, packed, T):
    """24 tokens take the scan, 64 the chunked form at the config's chunk of
    32. There the init's fast decays (log w at the -20 clamp) reach the -80
    cumulative floor within the chunk, where the factors exp(±80) carry
    f32 rounding of the log-decay sums into the output at about 1e-5 of
    its scale (the reference's own chunked form differs from its scan by
    about 0.2 of the scale there): f32 is held within 1e-4 at T = 64."""
    cfg, jcfg = cfgs(dtype)
    params, jparams = both_params(cfg, numpy_params(cfg), packed)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, T)).astype(
        np.int32)
    with torch.inference_mode():
        logits = rwkv6.apply(params, {"tokens": t(toks)}, cfg)
    assert logits.dtype == torch.float32
    assert tuple(logits.shape) == (2, T, cfg.vocab)
    want = np.asarray(jr.apply(jparams, {"tokens": jnp.asarray(toks)}, jcfg))
    if dtype == "float32" and T > cfg.linear_chunk:
        np.testing.assert_allclose(logits.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
    else:
        close(logits, want, dtype)


def test_decode_matches_forward():
    """The reference's ``test_arch_smoke.py`` case on the port: eight
    single-token decode steps equal ``apply``'s logits."""
    cfg, _ = cfgs()
    params = rwkv6.init(cfg, seed=2, device="cpu")
    toks = t(np.random.default_rng(2).integers(0, cfg.vocab, (1, 8)))
    with torch.inference_mode():
        ref = rwkv6.apply(params, {"tokens": toks}, cfg)
        state = alloc_decode_state(get_family("rwkv6"), cfg, 1, 8, slack=1,
                                   device="cpu")
        outs = []
        for i in range(8):
            logits, state = rwkv6.decode_step(
                params, state, {"tokens": toks[:, i:i + 1]}, cfg)
            outs.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), ref.numpy(),
                               rtol=2e-4, atol=2e-4)


def test_apply_backward_under_remat():
    cfg, _ = cfgs(remat="full")
    params = map_with_paths(lambda _, a: a.requires_grad_(),
                            params_from_numpy(numpy_params(cfg), "cpu"))
    batch = pipeline.make_batch_fn(cfg, seq=40, batch=2)(0)
    logits = rwkv6.apply(params, {"tokens": t(batch["tokens"])}, cfg)
    logits.logsumexp(-1).sum().backward()
    for name in ("wr", "w_lora_a", "w0", "bonus_u", "wcv"):
        g = params["layers"][name].grad
        assert g is not None and torch.isfinite(g).all() and \
            g.abs().sum() > 0, name


# ---------------------------------------------------------------------------
# Serving against the reference's engine


def run_reference(B=2, packed=True, n_req=None, dtype="float32"):
    """The JAX engine over the quantised checkpoint: tokens per rid, every
    step's state in and out, batch and logits, and its byte accounting."""
    cfg, jcfg = cfgs(dtype)
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
                weight=eng.weight_bytes(), cache=eng.cache_bytes())


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
    """B + 1 requests, so a slot is reused; the byte accounting too (no KV
    cache: ``kv`` 0, the whole state ``other``)."""
    ref = run_reference(B=B, packed=packed)
    eng = port_engine(ref, B, packed)
    assert run_port(eng, ref["reqs"]) == ref["tokens"]
    assert eng.weight_bytes() == ref["weight"]
    assert eng.cache_bytes() == ref["cache"]
    assert eng.cache_bytes()["kv"] == 0


def test_decode_step_on_the_reference_steps():
    """Every recorded step of the reference's engine (prefill chunks with
    ragged ``t_valid`` and reset bits, decode steps) through the port's
    ``decode_step`` from the reference's state: the logits of every valid
    position and every state entry it returns within 1e-5."""
    ref = run_reference(B=2, n_req=4)
    eng = port_engine(ref)
    assert any("reset" in r["batch"] for r in ref["steps"])
    with torch.inference_mode():
        for rec in ref["steps"]:
            state = {k: t(v) for k, v in rec["state"].items()}
            batch = {k: t(v) for k, v in rec["batch"].items()}
            logits, new = rwkv6.decode_step(eng.params, state, batch, eng.cfg)
            for i, tv in enumerate(rec["batch"]["t_valid"]):
                if tv:
                    close(logits[i, :tv], rec["logits"][i, :tv])
            for k in STATE:
                close(new[k], rec["new"][k])
            assert new["pos"].tolist() == rec["new"]["pos"].tolist()


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

    def test_chunked_prefill_equals_token_by_token(self):
        """Prefill chunk 8 (the block-parallel form, inner chunks of 4)
        against chunk 1 (the scan): the same tokens."""
        params = self.params()
        prompts = {0: [5, 9, 3, 7, 2, 8, 1, 6, 4, 10, 12], 1: [11, 4, 7]}
        outs = {}
        for chunk in (1, 8):
            eng = ServeEngine(self.CFG, params, batch_slots=2, kv_len=32,
                              prefill_chunk=chunk, device="cpu")
            for rid, p in prompts.items():
                eng.submit(Request(prompt=p, max_new_tokens=6, rid=rid))
            outs[chunk] = {g.rid: g.tokens for g in eng.run()}
        assert outs[1] == outs[8]

    def test_t_valid_padding_stays_out_of_the_state(self):
        """A 4-token chunk of which row 0 has 2 valid tokens leaves row 0's
        state as a 2-token chunk leaves it, and row 1 with none untouched."""
        params = self.params()
        fam = get_family("rwkv6")
        toks = t(np.array([[5, 9, 3, 7], [1, 2, 3, 4]], np.int32))
        with torch.inference_mode():
            st = alloc_decode_state(fam, self.CFG, 2, 16, slack=4,
                                    device="cpu")
            st["wkv"].normal_(generator=torch.Generator().manual_seed(0))
            before = {k: v.clone() for k, v in st.items()}
            _, padded = rwkv6.decode_step(
                params, st, {"tokens": toks,
                             "t_valid": t(np.array([2, 0], np.int32))},
                self.CFG)
            st2 = {k: v.clone() for k, v in before.items()}
            _, short = rwkv6.decode_step(
                params, st2, {"tokens": toks[:, :2]}, self.CFG)
        for k in STATE:
            np.testing.assert_allclose(padded[k][:, 0].float().numpy(),
                                       short[k][:, 0].float().numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
            assert torch.equal(padded[k][:, 1], before[k][:, 1]), k
        assert padded["pos"].tolist() == [2, 0]

    def test_reset_wipes_the_slot_state(self):
        params = self.params()
        fam = get_family("rwkv6")
        with torch.inference_mode():
            st = alloc_decode_state(fam, self.CFG, 2, 16, slack=4,
                                    device="cpu")
            for k in STATE:
                st[k].fill_(0.5)
            st["pos"] = t(np.array([3, 5], np.int32))
            fresh = alloc_decode_state(fam, self.CFG, 1, 16, slack=4,
                                       device="cpu")
            batch = {"tokens": t(np.array([[7], [2]], np.int32)),
                     "reset": t(np.array([True, False]))}
            logits, new = rwkv6.decode_step(params, st, batch, self.CFG)
            want, _ = rwkv6.decode_step(
                params, fresh, {"tokens": batch["tokens"][:1]}, self.CFG)
        assert new["pos"].tolist() == [1, 6]
        close(logits[:1], want.numpy())


class TestUnifiedPackedFamilies:
    """The reference's ``tests/test_serve.py::TestUnifiedPackedFamilies``
    on the port: packed projections, greedy tokens equal to the
    dequantised-dense engine's."""

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
        assert isinstance(leaves["['layers']['wr']"], PackedTensor)
        assert leaves["['layers']['wr']"].bits == 4
        packed = [n for n, x in leaves.items() if isinstance(x, PackedTensor)]
        assert len(packed) >= 10 and isinstance(leaves["['embed']"],
                                                PackedTensor)
        assert len(packed) == 12       # 10 projections, embed, unembed

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
    """rwkv6-1.6b full: 12 packed tensors, the count the card run holds its
    engine to."""
    cfg = configs.get_config(ARCH, "full")
    got = meta_weight_bytes(cfg)
    assert got == reference_full_bytes(jconfigs.get_config(ARCH, "full"))
    assert got == dict(total=843_522_816, codes=791_674_880,
                       scales=49_479_680, codebooks=768, dense=2_367_488)


def test_full_state_bytes_equal_the_specs():
    """The card run's decode state (4 slots): shift buffers in bf16 and the
    WKV matrices in f32, all of it ``other``."""
    cfg = configs.get_config(ARCH, "full")
    jcfg = jconfigs.get_config(ARCH, "full")
    specs = rwkv6.decode_state_specs(cfg, 4, 256, slack=8)
    jspecs = jr.decode_state_specs(jcfg, 4, 256, slack=8)
    nbytes = lambda sp: sum(
        int(np.prod(s.shape)) * np.dtype(jnp.dtype(s.dtype)).itemsize
        for s in sp.values())
    assert nbytes(specs) == nbytes(jspecs) == 51_118_096


def test_family_leaves_equal_init_and_the_reference_overrides():
    """The leaf-streamed draw ``build_packed_engine`` packs equals
    ``init`` leaf by leaf, and w0 and every mu_* are the reference
    init's."""
    cfg, jcfg = cfgs()
    whole = dict(flat_with_paths(rwkv6.init(cfg, seed=3, device="cpu")))
    streamed = dict(family_leaves(cfg, seed=3, device="cpu"))
    assert whole.keys() == streamed.keys()
    for k in whole:
        assert torch.equal(whole[k], streamed[k]), k
    jparams = jr.init(jax.random.PRNGKey(0), jcfg)
    for name in ("w0",) + rwkv6._MU:
        want = np.asarray(jparams["layers"][name])
        got = whole[f"['layers']['{name}']"]
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    assert not torch.equal(whole["['layers']['wr']"],
                           torch.zeros_like(whole["['layers']['wr']"]))


# ---------------------------------------------------------------------------
# Batches and the command line


def test_make_batch_fn_equal():
    cfg, jcfg = cfgs()
    fn = pipeline.make_batch_fn(cfg, seq=12, batch=3, seed=5)
    jfn = jpipe.make_batch_fn(jcfg, seq=12, batch=3, seed=5)
    for step in (0, 4):
        got, want = fn(step), jfn(step)
        assert got.keys() == want.keys() == {"tokens"}
        np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_serve_cli_on_cpu(capsys):
    """``launch.serve --arch rwkv6-1.6b`` packed on the CPU: the state is
    all ``other`` and a KV format is refused."""
    from repro_torch.launch import serve
    done = serve.main(["--arch", ARCH, "--variant", "smoke", "--quantise",
                       SPEC, "--packed", "--requests", "3", "--max-new", "4",
                       "--device", "cpu"])
    assert len(done) == 3 and all(len(g.tokens) == 4 for g in done)
    out = capsys.readouterr().out
    assert "packed babsmax64:n4" in out and "quantised KV" not in out
    with pytest.raises(SystemExit, match="has no KV cache"):
        serve.main(["--arch", ARCH, "--variant", "smoke", "--kv-format",
                    "q8", "--device", "cpu"])
