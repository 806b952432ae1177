"""whisper on the CPU: the port's encoder-decoder family against the
reference's, at whisper-large-v3 smoke (2 encoder + 2 decoder layers, d 64,
4 heads of 16, vocab 256, 32 frames) and at full width on meta tensors.

The same seeded numpy weights and frames go into both packages (packed
cases through each package's own babsmax64:n4 packing). f32 within 1e-5
relative, bf16 within 1e-2; greedy tokens and q8/q4 cache codes and scales
bit for bit. Requests carry frames: each admitted slot gets its own
cross-attention K/V (``cross_prefill``), which the reset mask leaves alone
and the next admission overwrites. A vocab of 318 packs the tied table as
one half-split nibble tile (159 byte rows), the case of whisper-large-v3's
51866 rows that a 256-row smoke table never reaches."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.core import build_plan as jbuild_plan
from repro.data import pipeline as jpipe
from repro.models import api as japi
from repro.models import layers as jl
from repro.models import whisper as jw
from repro.serve import cache as jcache
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch import configs
from repro_torch.core import build_plan
from repro_torch.core.nibble import nibble_k_tile
from repro_torch.core.plan import flat_with_paths, map_with_paths
from repro_torch.core.tensor_format import PackedTensor
from repro_torch.data import pipeline
from repro_torch.interop import params_from_numpy
from repro_torch.models import layers as tl
from repro_torch.models import whisper
from repro_torch.models.api import get_family
from repro_torch.serve import cache as tcache
from repro_torch.serve.engine import (Request, ServeEngine,
                                      alloc_decode_state)
from repro_torch.serve.scheduler import Scheduler

ARCH, SPEC = "whisper-large-v3", "babsmax64:n4"
F32 = dict(rtol=1e-5)
KW = dict(batch_slots=2, kv_len=32, prefill_chunk=4)
PROMPTS = ([5, 9, 3, 7, 2, 8], [11, 4], [7, 7, 1], [3, 1, 4, 1, 5], [2])
MAX_NEW = 6


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
    """Seeded numpy weights: norm gains around 1, fan-in scaled matrices, a
    0.5-std tied embedding so the logits have margins."""
    rng = np.random.default_rng(seed)

    def make(path, spec):
        if "norm" in path:
            return (1 + 0.1 * rng.standard_normal(spec.shape)
                    ).astype(np.float32)
        std = 0.5 if "embed" in path else \
            1 / np.sqrt(spec.numel // spec.shape[-1])
        return (rng.standard_normal(spec.shape) * std).astype(np.float32)
    return map_with_paths(make, whisper.param_specs(cfg))


def frames_of(cfg, seed):
    return np.random.default_rng(100 + seed).standard_normal(
        (cfg.enc_seq, cfg.d_model)).astype(np.float32)


def both_params(cfg, npp, packed):
    """The same numpy weights in both packages, each packing its own."""
    jparams = jax.tree.map(jnp.asarray, npp)
    params = params_from_numpy(npp, "cpu")
    if packed:
        jparams = jbuild_plan(jparams, SPEC).pack(
            jparams, jw.pack_layouts(cfg))
        params = build_plan(params, SPEC).pack(params,
                                               whisper.pack_layouts(cfg))
    return params, jparams


# ---------------------------------------------------------------------------
# Specs, layouts, registration


def spec_fields(tree):
    return {name: (tuple(s.shape), tuple(s.axes), s.dtype)
            for name, s in flat_with_paths(tree)}


@pytest.mark.parametrize("variant", ["smoke", "full"])
def test_param_specs_and_layouts_equal(variant):
    cfg = configs.get_config(ARCH, variant)
    jcfg = jconfigs.get_config(ARCH, variant)
    want = spec_fields(jw.param_specs(jcfg))
    assert spec_fields(whisper.param_specs(cfg)) == want
    assert whisper.pack_layouts(cfg) == jw.pack_layouts(jcfg)
    if variant == "full":
        assert sum(int(np.prod(f[0])) for f in want.values()) == \
            1_534_602_240
    for B, kv in ((1, 16), (4, 256)):
        got = whisper.decode_state_specs(cfg, B, kv, slack=8)
        ref = jw.decode_state_specs(jcfg, B, kv, slack=8)
        assert spec_fields(got) == spec_fields(ref)


def test_configs_and_registry():
    for variant in ("smoke", "full"):
        got = configs.get_config(ARCH, variant)
        want = jconfigs.get_config(ARCH, variant)
        for f in ("name", "family", "n_layers", "n_enc_layers", "d_model",
                  "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab",
                  "enc_seq", "tie_embeddings", "rope_theta", "remat"):
            assert getattr(got, f) == getattr(want, f), f
    fam = get_family("whisper")
    assert fam.cross_prefill is whisper.cross_prefill
    assert fam.supports_ragged and fam.cache_spec is whisper.cache_spec


def test_full_cache_bytes_match_reference():
    """The serving geometry of the card run (4 slots, kv_len 256, chunk
    8): the self-attention group, dense and quantised."""
    for fmt in ("", "q8", "q4"):
        cfg = configs.get_config(ARCH, "full").replace(kv_format=fmt)
        jcfg = jconfigs.get_config(ARCH, "full").replace(kv_format=fmt)
        assert whisper.cache_spec(cfg, 4, 256, slack=8).cache_bytes() == \
            jw.cache_spec(jcfg, 4, 256, slack=8).cache_bytes()


# ---------------------------------------------------------------------------
# Layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, 64)) * 3 + 1).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    tdt = getattr(torch, dtype)
    got = whisper.layer_norm(t(x).to(tdt), t(g), 1e-5)
    want = jw.layer_norm(jnp.asarray(x, dtype), jnp.asarray(g), 1e-5)
    assert got.dtype == tdt
    close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_gelu_mlp(dtype, packed):
    """The tanh approximation (``jax.nn.gelu``'s default), dense or packed
    weights."""
    cfg, _ = cfgs(dtype)
    params, jparams = both_params(cfg, numpy_params(cfg), packed)
    lp = {k: (v.layer(0) if isinstance(v, PackedTensor) else v[0])
          for k, v in params["enc"].items()}
    jlp = jax.tree.map(lambda a: a[0], jparams["enc"])
    x = np.random.default_rng(1).standard_normal((2, 7, 64)).astype(
        np.float32) * 2
    tdt = getattr(torch, dtype)
    got = tl.gelu_mlp(t(x).to(tdt), lp["w_in"], lp["w_out"])
    want = jl.gelu_mlp(jnp.asarray(x, dtype), jlp["w_in"], jlp["w_out"])
    close(got, want, dtype)
    # the erf GELU is measurably another function at these inputs
    h = torch.nn.functional.gelu(torch.tensor([1.5]))
    assert abs(float(h) - float(jax.nn.gelu(1.5))) > 1e-5


@pytest.mark.parametrize("case", ["linear", "window", "ring", "kv_positions",
                                  "q8", "q4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention(case, dtype):
    """The single-token read, dense (causal, window, ring, given slot
    positions) and quantised; bf16 q and caches in bf16, q8/q4 codes and
    scales the reference's own."""
    B, H, K, hd, S = 3, 4, 2, 16, 12
    rng = np.random.default_rng(4)
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    tdt = getattr(torch, dtype)
    kc = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    vc = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    kw = dict(window=5 if case in ("window", "ring") else 0,
              ring=case == "ring")
    qp = 17 if case == "ring" else 7
    if case == "kv_positions":
        kw["kv_positions"] = np.arange(S)[::-1].copy() * 2
    if case in ("q8", "q4"):
        bits = 8 if case == "q8" else 4
        jcb = jcache.kv_codebook(case)
        cb = tcache.kv_codebook(case)
        jk = jl.QuantisedKV(*jl.quantise_kv(jnp.asarray(kc), jcb, bits))
        jv = jl.QuantisedKV(*jl.quantise_kv(jnp.asarray(vc), jcb, bits))
        tk = tl.QuantisedKV(t(np.asarray(jk.codes)), t(np.asarray(jk.scales)))
        tv = tl.QuantisedKV(t(np.asarray(jv.codes)), t(np.asarray(jv.scales)))
        got = tl.decode_attention(t(q).to(tdt), tk, tv, qp, codebook=cb)
        want = jl.decode_attention(jnp.asarray(q, dtype), jk, jv, qp,
                                   codebook=jcb)
    else:
        tkw = dict(kw)
        if "kv_positions" in tkw:
            tkw["kv_positions"] = t(kw["kv_positions"])
        got = tl.decode_attention(*(t(a).to(tdt) for a in (q, kc, vc)), qp,
                                  **tkw)
        want = jl.decode_attention(*(jnp.asarray(a, dtype)
                                     for a in (q, kc, vc)), qp, **kw)
    assert tuple(got.shape) == (B, 1, H, hd) and got.dtype == tdt
    close(got, want, dtype)


def test_decode_attention_equals_the_chunked_read_at_one_token():
    B, H, K, hd, S = 2, 4, 4, 16, 10
    rng = np.random.default_rng(5)
    q, kc, vc = (t(rng.standard_normal(s).astype(np.float32)) for s in
                 ((B, 1, H, hd), (B, S, K, hd), (B, S, K, hd)))
    one = tl.decode_attention(q, kc, vc, 6)
    chunked = tl.chunked_decode_attention(
        q, kc, vc, torch.full((B, 1), 6, dtype=torch.int32))
    torch.testing.assert_close(one, chunked, rtol=1e-6, atol=1e-6)


def test_qkv_project_without_rotation():
    """``rot=None`` is the reference's ``rope_on=False``: no rotation."""
    cfg, jcfg = cfgs()
    params, jparams = both_params(cfg, numpy_params(cfg), packed=False)
    lp = {k: v[0] for k, v in params["enc"].items()}
    jlp = jax.tree.map(lambda a: a[0], jparams["enc"])
    x = np.random.default_rng(2).standard_normal((1, 6, 64)).astype(
        np.float32)
    ap = tl.AttnParams(lp["self_wq"], lp["self_wk"], lp["self_wv"],
                       lp["self_wo"])
    jap = jl.AttnParams(jlp["self_wq"], jlp["self_wk"], jlp["self_wv"],
                        jlp["self_wo"])
    got = tl.qkv_project(t(x), ap, None, cfg)
    want = jl.qkv_project(jnp.asarray(x), jap, jnp.arange(6), jcfg,
                          rope_on=False)
    for g, w in zip(got, want):
        close(g, w)


# ---------------------------------------------------------------------------
# encode, apply, cross_prefill


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_encode_apply_and_cross_prefill(dtype, packed):
    cfg, jcfg = cfgs(dtype, attn_chunk=16)     # two key chunks of frames
    params, jparams = both_params(cfg, numpy_params(cfg), packed)
    batch = jpipe.make_batch_fn(jcfg, seq=9, batch=2, seed=3)(0)
    tb = {k: t(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with torch.inference_mode():
        enc = whisper.encode(params, tb["frames"], cfg)
        logits = whisper.apply(params, tb, cfg)
        cross = whisper.cross_prefill(params, tb["frames"][:1], cfg)
        zero = whisper.cross_prefill(params, None, cfg)
    close(enc, jw.encode(jparams, jb["frames"], jcfg), dtype)
    want = jw.apply(jparams, jb, jcfg)
    assert logits.dtype == torch.float32
    assert tuple(logits.shape) == (2, 9, cfg.vocab)
    close(logits, want, dtype)
    jcross = jw.cross_prefill(jparams, jb["frames"][:1], jcfg)
    for key in ("xk", "xv"):
        assert cross[key].dtype == getattr(torch, dtype)
        assert tuple(cross[key].shape) == jcross[key].shape
        close(cross[key], jcross[key], dtype)
        assert not zero[key].any() and zero[key].shape == cross[key].shape


def test_apply_backward_reaches_both_stacks():
    """Gradients flow through the encoder, the cross attention and the
    tied table under remat (the training path on the CPU)."""
    cfg, _ = cfgs(remat="full")
    params = map_with_paths(lambda _, a: a.requires_grad_(),
                            params_from_numpy(numpy_params(cfg), "cpu"))
    batch = pipeline.make_batch_fn(cfg, seq=6, batch=2)(0)
    logits = whisper.apply(params, {k: t(v) for k, v in batch.items()}, cfg)
    logits.logsumexp(-1).sum().backward()
    for g in (params["embed"].grad, params["enc"]["self_wq"].grad,
              params["dec"]["cross_wk"].grad, params["enc_norm"].grad):
        assert g is not None and torch.isfinite(g).all() and g.abs().sum() > 0


# ---------------------------------------------------------------------------
# Serving: the ragged decode step and the engine against the reference's


def requests(cfg, n, with_frames=(0, 2, 3)):
    return [(list(PROMPTS[i % len(PROMPTS)]),
             frames_of(cfg, i) if i in with_frames else None)
            for i in range(n)]


def run_reference(fmt="", B=2, packed=True, dtype="float32", n_req=None,
                  **cfg_kw):
    """The JAX engine over the quantised checkpoint: tokens per rid, its
    recorded steps (state positions, cross K/V, batch, logits), its final
    state and byte accounting, and the numpy weights."""
    cfg, jcfg = cfgs(dtype, kv_format=fmt, **cfg_kw)
    npp = numpy_params(cfg)
    jparams = jax.tree.map(jnp.asarray, npp)
    jplan = jbuild_plan(jparams, SPEC)
    eng = JServeEngine.from_quantised(jcfg, jplan.quantise(jparams), jplan,
                                      packed=packed, **{**KW,
                                                        "batch_slots": B})
    steps = []
    step = eng._step

    def recording_step(p, s, b):
        rec = {"pos": np.asarray(s["pos"]), "xk": np.asarray(s["xk"]),
               "xv": np.asarray(s["xv"]),
               "batch": {k: np.asarray(v) for k, v in b.items()}}
        logits, new = step(p, s, b)
        rec["logits"] = np.asarray(logits)
        steps.append(rec)
        return logits, new
    eng._step = recording_step
    reqs = requests(cfg, n_req or B + 1)
    for rid, (p, fr) in enumerate(reqs):
        eng.submit(JRequest(prompt=p, max_new_tokens=MAX_NEW, rid=rid,
                            frames=fr))
    tokens = {g.rid: g.tokens for g in eng.run()}
    return dict(cfg=cfg, tokens=tokens, steps=steps, npp=npp, reqs=reqs,
                weight=eng.weight_bytes(), cache=eng.cache_bytes(),
                state={k: np.asarray(v) for k, v in eng._state.items()},
                jparams=eng.params)


def port_engine(ref, B=2, packed=True):
    params = params_from_numpy(ref["npp"], "cpu")
    plan = build_plan(params, SPEC)
    return ServeEngine.from_quantised(ref["cfg"], plan.quantise(params),
                                      plan, packed=packed, device="cpu",
                                      **{**KW, "batch_slots": B})


def run_port(eng, reqs):
    for rid, (p, fr) in enumerate(reqs):
        eng.submit(Request(prompt=p, max_new_tokens=MAX_NEW, rid=rid,
                           frames=fr))
    return {g.rid: g.tokens for g in eng.run()}


GREEDY = [(B, packed) for packed in (False, True) for B in (1, 2, 4)]


@pytest.mark.parametrize("B,packed", GREEDY,
                         ids=[f"B{b}-{'packed' if p else 'dense'}"
                              for b, p in GREEDY])
def test_greedy_tokens_match_the_reference(B, packed):
    """B + 1 requests (three with frames), so a slot is reused."""
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


def test_ragged_decode_step_on_the_reference_batches(stepped):
    """The reference's recorded batches (with its cross K/V) through the
    port's decode_step: every valid position's logits within the f32
    tolerance, and the self-attention cache left bit for bit as the
    reference left it (q8/q4 codes and scales)."""
    fmt, ref, eng = stepped
    state = alloc_decode_state(eng.fam, eng.cfg, eng.B, eng.kv_len,
                               slack=eng.prefill_chunk, device="cpu")
    with torch.inference_mode():
        for rec in ref["steps"]:
            state["pos"] = t(rec["pos"])
            state["xk"].copy_(t(rec["xk"]))
            state["xv"].copy_(t(rec["xv"]))
            batch = {k: t(v) for k, v in rec["batch"].items()}
            logits, state = eng.fam.decode_step(eng.params, state, batch,
                                                eng.cfg)
            for i, tv in enumerate(rec["batch"]["t_valid"]):
                if tv:
                    close(logits[i, :tv], rec["logits"][i, :tv])
    keys = ["k0", "v0"] + (["k0s", "v0s"] if fmt else [])
    for k in keys:
        got = state[k].numpy()
        if fmt:
            np.testing.assert_array_equal(got, ref["state"][k], err_msg=k)
        else:
            np.testing.assert_allclose(got, ref["state"][k], rtol=1e-5,
                                       atol=1e-5, err_msg=k)
    assert state["k0"].dtype == (torch.uint8 if fmt else torch.float32)


def test_quantised_cache_tokens_and_state(stepped):
    fmt, ref, eng = stepped
    assert run_port(eng, ref["reqs"]) == ref["tokens"]
    for k in ("xk", "xv"):   # the cross K/V stays dense under q8/q4
        assert eng._state[k].dtype == torch.float32
        np.testing.assert_allclose(eng._state[k].numpy(), ref["state"][k],
                                   rtol=1e-5, atol=1e-5)


def test_reset_leaves_the_cross_kv_alone():
    """A step whose reset bit is raised wipes the slot's self-attention
    rows and position, not its cross K/V (admission owns it)."""
    cfg, _ = cfgs(kv_format="q8")
    params = params_from_numpy(numpy_params(cfg), "cpu")
    fam = get_family("whisper")
    state = alloc_decode_state(fam, cfg, 2, 16, slack=4, device="cpu")
    with torch.inference_mode():
        state["xk"].fill_(1.5)
        state["k0"].fill_(7)
        state["pos"] = torch.tensor([3, 5], dtype=torch.int32)
        batch = {"tokens": torch.tensor([[1], [2]], dtype=torch.int32),
                 "reset": torch.tensor([True, False])}
        _, st = whisper.decode_step(params, state, batch, cfg)
    assert bool((st["xk"] == 1.5).all())
    assert st["pos"].tolist() == [1, 6]
    assert bool((st["k0"][:, 0, 1:] == 0).all())
    assert bool((st["k0"][:, 1] == 7).any())


class TestWhisperCrossPrefill:
    """The reference's ``tests/test_serve_ragged.py::
    TestWhisperCrossPrefill`` on the port: cross-attention K/V is computed
    per admitted slot from that request's frames and never leaks into the
    next occupant."""

    CFG = configs.get_config(ARCH, "smoke").replace(dtype="float32")

    def _frames(self, seed=0):
        rng = np.random.default_rng(seed)
        return rng.standard_normal(
            (self.CFG.enc_seq, self.CFG.d_model)).astype(np.float32)

    def _params(self):
        return whisper.init(self.CFG, seed=0, device="cpu")

    def test_frames_condition_generation(self):
        params = self._params()
        eng = ServeEngine(self.CFG, params, batch_slots=2, kv_len=32,
                          prefill_chunk=4, device="cpu")
        eng.submit(Request(prompt=[5, 9, 3], max_new_tokens=6, rid=0,
                           frames=self._frames()))
        eng.submit(Request(prompt=[5, 9, 3], max_new_tokens=6, rid=1))
        done = {g.rid: g.tokens for g in eng.run()}
        # same prompt, one with encoder input: generations differ
        assert done[0] != done[1]

    def test_no_cross_leak_on_slot_reuse(self):
        params = self._params()
        kw = dict(batch_slots=1, kv_len=32, prefill_chunk=4, device="cpu")
        eng = ServeEngine(self.CFG, params, **kw)
        eng.submit(Request(prompt=[5, 9, 3], max_new_tokens=5, rid=0,
                           frames=self._frames()))
        eng.submit(Request(prompt=[5, 9, 3], max_new_tokens=5, rid=1))
        done = {g.rid: g.tokens for g in eng.run()}
        # the text-only request in the reused slot == a fresh text-only run
        fresh = ServeEngine(self.CFG, params, **kw)
        fresh.submit(Request(prompt=[5, 9, 3], max_new_tokens=5, rid=1))
        assert done[1] == fresh.run()[0].tokens
        assert not eng._state["xk"].any() and not eng._state["xv"].any()

    def test_per_slot_frames_independent(self):
        """Two slots with different frames each match their own
        single-request run (one shared engine-global encoding cannot
        satisfy both)."""
        params = self._params()
        fa, fb = self._frames(1), self._frames(2)
        eng = ServeEngine(self.CFG, params, batch_slots=2, kv_len=32,
                          prefill_chunk=4, device="cpu")
        eng.submit(Request(prompt=[5, 9, 3], max_new_tokens=5, rid=0,
                           frames=fa))
        eng.submit(Request(prompt=[5, 9, 3], max_new_tokens=5, rid=1,
                           frames=fb))
        done = {g.rid: g.tokens for g in eng.run()}
        for rid, fr in ((0, fa), (1, fb)):
            solo = ServeEngine(self.CFG, params, batch_slots=1, kv_len=32,
                               prefill_chunk=4, device="cpu")
            solo.submit(Request(prompt=[5, 9, 3], max_new_tokens=5, rid=rid,
                                frames=fr))
            assert done[rid] == solo.run()[0].tokens, f"rid={rid}"


def test_admission_writes_the_slot_rows_and_builds_one_zero_template():
    cfg, _ = cfgs()
    params = params_from_numpy(numpy_params(cfg), "cpu")
    eng = ServeEngine(cfg, params, batch_slots=2, kv_len=16,
                      prefill_chunk=4, device="cpu")
    fr = frames_of(cfg, 7)
    calls = []
    cross = eng._cross_prefill
    eng._cross_prefill = lambda p, f: calls.append(f) or cross(p, f)
    eng.submit(Request(prompt=[1, 2], max_new_tokens=1, rid=0, frames=fr))
    eng.submit(Request(prompt=[3], max_new_tokens=1, rid=1))
    eng._admit()
    want = whisper.cross_prefill(params, t(fr)[None], cfg)
    assert len(calls) == 1 and tuple(calls[0].shape) == (1, 32, 64)
    for key in ("xk", "xv"):
        assert torch.equal(eng._state[key][:, 0], want[key][:, 0])
        assert not eng._state[key][:, 1].any()
    template = eng._zero_cross
    eng.run()
    eng.submit(Request(prompt=[3], max_new_tokens=1, rid=2))
    eng.submit(Request(prompt=[4], max_new_tokens=1, rid=3))
    eng.run()
    assert eng._zero_cross is template and len(calls) == 1
    assert not eng._state["xk"].any()


# ---------------------------------------------------------------------------
# The whole-axis nibble tile of the tied table


def test_whole_axis_embed_tile_serves_the_reference_tokens():
    """vocab 318: even, not a multiple of 256, so the tied (318, 64) table
    packs as one half-split tile of 159 byte rows (an odd count, as
    whisper-large-v3's 25933); the gathers and the transposed logits read
    it through that tile, and the greedy tokens equal the reference's."""
    assert nibble_k_tile(318) == 318 and nibble_k_tile(51866) == 51866
    ref = run_reference(B=2, vocab=318)
    eng = port_engine(ref)
    emb = eng.params["embed"]
    assert isinstance(emb, PackedTensor) and emb.bits == 4
    assert tuple(emb.codes.shape) == (159, 64)
    np.testing.assert_array_equal(
        emb.codes.numpy(), np.asarray(ref["jparams"]["embed"].codes))
    assert run_port(eng, ref["reqs"]) == ref["tokens"]


# ---------------------------------------------------------------------------
# Bytes


def test_weight_bytes_of_the_benchmark_row():
    """whisper smoke as ``benchmarks/serve_packed.py`` builds its row (f32
    compute, babsmax64:n4, 2 slots, kv_len 48, chunk 4): the resident
    weight bytes of ``BENCH_serve.json``'s whisper/f32 and whisper/packed4
    rows, and the cache bytes."""
    cfg = configs.get_config(ARCH, "smoke").replace(dtype="float32",
                                                    param_dtype="float32")
    params = whisper.init(cfg, device="cpu")
    plan = build_plan(params, SPEC)
    q = plan.quantise(params)
    kw = dict(batch_slots=2, kv_len=48, prefill_chunk=4, device="cpu")
    dense = ServeEngine.from_quantised(cfg, q, plan, packed=False, **kw)
    packed = ServeEngine.from_quantised(cfg, q, plan, **kw)
    assert dense.weight_bytes()["total"] == 723_968
    wb = packed.weight_bytes()
    assert (wb["total"], wb["packed"], wb["dense"], wb["codes"],
            wb["scales"], wb["codebooks"]) == (99_904, 96_832, 3_072,
                                               90_112, 5_632, 1_088)
    n = [x for _, x in flat_with_paths(packed.params)
         if isinstance(x, PackedTensor)]
    assert len(n) == 17 and all(x.bits == 4 for x in n)
    cb = packed.cache_bytes()
    assert (cb["kv"], cb["total"]) == (106_496, 172_040)


def reference_full_bytes(cfg):
    """The reference's resident bytes of ``cfg`` packed babsmax64:n4, by
    its own packing rules on abstract arrays (``jax.eval_shape``: nothing
    is allocated)."""
    from repro.core.tensor_format import PackedTensor as JPacked
    from repro.models.api import get_family as jget_family
    fam = jget_family(cfg.family)
    abstract = jax.tree.map(
        lambda s: jax.ShapeDtypeStruct(s.shape, jnp.dtype(s.dtype)),
        fam.param_specs(cfg), is_leaf=lambda x: isinstance(x, japi.ParamSpec))
    out = jax.eval_shape(
        lambda p: jbuild_plan(p, SPEC).pack(p, fam.pack_layouts(cfg)),
        abstract)
    wb = dict(codes=0, scales=0, codebooks=0, dense=0)
    for leaf in jax.tree.leaves(out, is_leaf=lambda x: isinstance(x, JPacked)):
        if isinstance(leaf, JPacked):
            wb["codes"] += leaf.codes.size * leaf.codes.dtype.itemsize
            wb["scales"] += leaf.scales.size * leaf.scales.dtype.itemsize
            cb = leaf.codebook()
            wb["codebooks"] += cb.size * cb.dtype.itemsize
        else:
            wb["dense"] += leaf.size * leaf.dtype.itemsize
    wb["total"] = sum(wb.values())
    return wb


def meta_weight_bytes(cfg):
    """The port's engine over meta tensors of ``cfg``'s parameters, packed
    babsmax64:n4: its ``weight_bytes``, with nothing allocated."""
    fam = get_family(cfg.family)
    params = map_with_paths(lambda _, s: torch.empty(s.shape, device="meta"),
                            fam.param_specs(cfg))
    plan = build_plan(params, SPEC)
    eng = ServeEngine.from_quantised(cfg, plan.quantise(params), plan,
                                     validate=False, device="meta")
    wb = eng.weight_bytes()
    return {k: wb[k] for k in ("total", "codes", "scales", "codebooks",
                               "dense")}


def test_full_weight_bytes_equal_the_reference():
    """whisper-large-v3 full: 17 packed tensors (the tied table once) and
    the reference's count, which the card run holds its engine to."""
    cfg = configs.get_config(ARCH, "full")
    got = meta_weight_bytes(cfg)
    assert got == reference_full_bytes(jconfigs.get_config(ARCH, "full"))
    assert got == dict(total=815_977_808, codes=767_197_440,
                       scales=47_949_840, codebooks=1_088, dense=829_440)


def test_kv_fisher_with_the_same_labels(monkeypatch):
    """``--kv-format auto``'s calibration on whisper (one global group over
    the decoder's self-attention cache; the cross K/V of a text-only decode
    is zeros): the Fisher statistics equal the reference's when both
    sample the same labels."""
    from repro.core import fisher as jfisher
    from repro_torch.core import fisher
    cfg, jcfg = cfgs()
    npp = numpy_params(cfg)
    y = np.random.default_rng(16).integers(0, cfg.vocab, (2,))
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, axis=-1: jnp.asarray(y))
    monkeypatch.setattr(fisher, "_sample_labels",
                        lambda logits, generator: t(y).long())
    kw = dict(batch_size=2, kv_len=16, warm_steps=6, samples=2)
    want = jfisher.estimate_kv_fisher(jcfg, jax.tree.map(jnp.asarray, npp),
                                      **kw)
    got = fisher.estimate_kv_fisher(cfg, params_from_numpy(npp, "cpu"), **kw)
    assert list(got) == list(want) == ["g0"]
    assert got["g0"]["numel"] == want["g0"]["numel"]
    for key in ("rms", "fisher_mean"):
        np.testing.assert_allclose(got["g0"][key], want["g0"][key],
                                   rtol=1e-5, err_msg=key)


# ---------------------------------------------------------------------------
# Batches, the scheduler, the command line


def test_make_batch_fn_equal():
    cfg, jcfg = cfgs()
    fn = pipeline.make_batch_fn(cfg, seq=12, batch=3, seed=5)
    jfn = jpipe.make_batch_fn(jcfg, seq=12, batch=3, seed=5)
    for step in (0, 4):
        got, want = fn(step), jfn(step)
        assert got.keys() == want.keys() == {"tokens", "frames"}
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    assert fn(0)["frames"].shape == (3, cfg.enc_seq, cfg.d_model)


def test_input_specs_equal():
    from repro.configs import shapes as jshapes
    from repro_torch.configs import shapes
    for variant in ("smoke", "full"):
        cfg = configs.get_config(ARCH, variant)
        jcfg = jconfigs.get_config(ARCH, variant)
        for name, shape in shapes.SHAPES.items():
            got = shapes.input_specs(cfg, shape)
            want = jshapes.input_specs(jcfg, jshapes.SHAPES[name])
            assert {k: (v.shape, v.axes, v.dtype) for k, v in got.items()} \
                == {k: (v.shape, v.axes, v.dtype) for k, v in want.items()}
            assert shapes.applicable(cfg, name) == jshapes.applicable(jcfg,
                                                                     name)
    assert shapes.smoke_shape("prefill", 32, 4) == shapes.Shape(
        "smoke_prefill", "prefill", 32, 4)


def test_scheduler_submit_frames_takes_the_recompute_path():
    """whisper carries per-slot cross K/V besides its KV cache, so a
    shared prefix is recomputed, not forked (with one warning), and the
    frames reach the request: the tokens equal a direct engine's."""
    cfg, _ = cfgs()
    params = params_from_numpy(numpy_params(cfg), "cpu")
    prefix = [5, 9, 3, 7]
    prompts = [prefix + [2, 8], prefix + [1]]
    frs = [frames_of(cfg, 1), None]
    direct = ServeEngine(cfg, params, device="cpu", **KW)
    ref = run_port(direct, list(zip(prompts, frs)))
    eng = ServeEngine(cfg, params, device="cpu", **KW)
    sched = Scheduler(eng)
    sched.register_prefix("sys", prefix)
    assert not sched.pool.fork_capable
    for i, (pr, fr) in enumerate(zip(prompts, frs)):
        sched.submit(list(pr), max_new_tokens=MAX_NEW, prefix="sys", rid=i,
                     frames=fr)
    with pytest.warns(RuntimeWarning, match="recomputed, not forked"):
        done = {g.rid: g.tokens for g in sched.run()}
    assert done == ref
    assert sched.stats["forks"] == 0
    assert sched.stats["prefix_recompute"] == len(prompts)


def test_serve_cli_on_cpu(capsys):
    """``launch.serve --arch whisper-large-v3`` (text-only requests: the
    zero cross template) packed, dense cache and q8."""
    from repro_torch.launch import serve
    for kv in ("f32", "q8"):
        done = serve.main(["--arch", ARCH, "--variant", "smoke",
                           "--quantise", SPEC, "--packed", "--kv-format", kv,
                           "--kv-len", "32", "--requests", "3",
                           "--max-new", "4", "--device", "cpu"])
        assert len(done) == 3 and all(len(g.tokens) == 4 for g in done)
    out = capsys.readouterr().out
    assert "packed babsmax64:n4" in out and "degraded" not in out
