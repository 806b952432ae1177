"""MoE on the CPU: the port's ``moe_block``, ``apply`` and serving engine
against the reference's, at qwen2-moe-a2.7b smoke (8 experts, top-4, 2
shared), llama4-scout-17b-a16e smoke (4 experts, top-1, 1 shared) and the
dense internlm2-20b smoke.

Weights are seeded numpy arrays carried into both packages; packed cases
use babsmax16:n4 (the smoke expert width 48 tiles by 16). Routing is held
bit for bit: the experts each token chose (``route`` in the port,
``jax.lax.top_k`` in the reference) and the dispatch buffer each side hands
its first expert matmul, which fixes every kept dispatch's (expert, rank)
slot and every dropped one, against each other and against a numpy count
of the dispatches before it. Outputs in f32 within 1e-5."""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import build_plan as jbuild_plan
from repro.core.tensor_format import PackedTensor as JPacked
from repro.models import layers as jl
from repro.models import transformer as jt
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch import configs
from repro_torch.core import build_plan
from repro_torch.core.plan import flat_with_paths, map_with_paths
from repro_torch.core.tensor_format import PackedTensor
from repro_torch.interop import params_from_numpy
from repro_torch.models import layers as tl
from repro_torch.models import transformer
from repro_torch.models.api import init_from_specs, init_leaves
from repro_torch.serve.engine import (Request, ServeEngine,
                                      alloc_decode_state,
                                      build_packed_engine)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

SPEC = "babsmax16:n4"
QWEN, LLAMA4, INTERNLM = ("qwen2-moe-a2.7b", "llama4-scout-17b-a16e",
                          "internlm2-20b")
MOE_ARCHS = [QWEN, LLAMA4]
F32 = dict(rtol=1e-5)
KV_LEN, CHUNK, MAX_NEW = 32, 4, 6
PROMPT_LENS = (5, 11, 3, 8)


def numpy_params(cfg, seed=0):
    """Seeded numpy weights: norm gains around 1, fan-in scaled matrices, a
    0.5-std embedding so the logits have margins."""
    rng = np.random.default_rng(seed)

    def make(path, spec):
        if "norm" in path:
            return (1 + 0.1 * rng.standard_normal(spec.shape)
                    ).astype(np.float32)
        std = 0.5 if "embed" in path else \
            1 / np.sqrt(spec.numel // spec.shape[-1])
        return (rng.standard_normal(spec.shape) * std).astype(np.float32)
    return map_with_paths(make, transformer.param_specs(cfg))


def cfgs(arch, **kw):
    kw = dict(dtype="float32", **kw)
    return (configs.get_config(arch, "smoke").replace(**kw),
            jconfigs.get_config(arch, "smoke").replace(**kw))


def both_params(cfg, jcfg, npp, packed):
    """The same numpy weights in both packages, each packing its own."""
    jparams = jax.tree.map(jnp.asarray, npp)
    params = params_from_numpy(npp, "cpu")
    if packed:
        jparams = jbuild_plan(jparams, SPEC).pack(jparams,
                                                  jt.pack_layouts(jcfg))
        params = build_plan(params, SPEC).pack(
            params, transformer.pack_layouts(cfg))
    return params, jparams


def is_jpacked(x):
    return isinstance(x, JPacked)


# ---------------------------------------------------------------------------
# moe_block


def moe_params(lp, mod, cfg):
    shared = (mod.MlpParams(lp["ws_gate"], lp["ws_up"], lp["ws_down"])
              if cfg.n_shared_experts else None)
    return mod.MoeParams(lp["w_router"], lp["we_gate"], lp["we_up"],
                         lp["we_down"], shared=shared)


def run_moe(monkeypatch, arch, packed, capacity_factor=1.25, router=None,
            B=2, T=16, seed=3):
    """Layer 0's MoE block of ``arch`` smoke in both packages on the same
    x (B, T, D): each side's outputs, aux, choices and dispatch buffer."""
    cfg, jcfg = cfgs(arch, capacity_factor=capacity_factor)
    npp = numpy_params(cfg)
    if router is not None:
        npp["layers"]["w_router"] = router(npp["layers"]["w_router"])
    params, jparams = both_params(cfg, jcfg, npp, packed)
    lp = transformer._layer(params["layers"], 0)
    jlp = jax.tree.map(lambda a: a[0], jparams["layers"])
    x = np.random.default_rng(seed).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)
    seen = {"port": {}, "ref": {}}

    def recorder(side, fn, key, out_index=None):
        """``fn``, keeping the first call's output ``out_index`` (or, with
        None, its first argument) under ``key``."""
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            got = a[0] if out_index is None else out[out_index]
            seen[side].setdefault(key, np.asarray(got))
            return out
        return wrapped

    monkeypatch.setattr(tl, "route", recorder("port", tl.route, "choice", 1))
    monkeypatch.setattr(tl, "expert_matmul",
                        recorder("port", tl.expert_matmul, "buf"))
    monkeypatch.setattr(jax.lax, "top_k",
                        recorder("ref", jax.lax.top_k, "choice", 1))
    monkeypatch.setattr(jl, "expert_matmul",
                        recorder("ref", jl.expert_matmul, "buf"))
    with torch.no_grad():
        out, aux = tl.moe_block(torch.from_numpy(x), moe_params(lp, tl, cfg),
                                cfg)
    jout, jaux = jl.moe_block(jnp.asarray(x), moe_params(jlp, jl, jcfg),
                              jcfg)
    return dict(cfg=cfg, x=x, out=out.numpy(), aux=float(aux),
                jout=np.asarray(jout), jaux=float(jaux), **{
                    f"{side}_{k}": v for side in seen
                    for k, v in seen[side].items()})


def dispatch_oracle(x, choice, E, cap):
    """The dispatch buffer from a count: the j-th dispatch (token j // k,
    expert e) takes slot (e, number of earlier dispatches to e) if that is
    below ``cap``, else it is dropped. Returns (buffer, dropped count)."""
    N, k = choice.shape
    xt = x.reshape(N, -1)
    buf = np.zeros((E, cap, xt.shape[1]), np.float32)
    seen = np.zeros(E, np.int64)
    dropped = 0
    for j, e in enumerate(choice.reshape(-1)):
        if seen[e] < cap:
            buf[e, seen[e]] = xt[j // k]
        else:
            dropped += 1
        seen[e] += 1
    return buf, dropped


def hold_moe(r, expect_drops=None):
    cfg = r["cfg"]
    E, k = cfg.n_experts, cfg.experts_per_token
    N = r["x"].shape[0] * r["x"].shape[1]
    cap = max(int(np.ceil(cfg.capacity_factor * k * N / E)), 4)
    assert r["port_choice"].dtype == np.int64
    np.testing.assert_array_equal(r["port_choice"], r["ref_choice"])
    want_buf, dropped = dispatch_oracle(r["x"], r["ref_choice"], E, cap)
    assert r["port_buf"].shape == r["ref_buf"].shape == want_buf.shape
    np.testing.assert_array_equal(r["port_buf"], r["ref_buf"])
    np.testing.assert_array_equal(r["ref_buf"], want_buf)
    if expect_drops is not None:
        assert (dropped > 0) == expect_drops, dropped
    np.testing.assert_allclose(r["out"], r["jout"], rtol=1e-5,
                               atol=1e-5 * np.abs(r["jout"]).max())
    np.testing.assert_allclose(r["aux"], r["jaux"], **F32)
    return dropped


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_moe_block_matches_the_reference(monkeypatch, arch, packed):
    hold_moe(run_moe(monkeypatch, arch, packed))


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_moe_block_drops_over_capacity_as_the_reference(monkeypatch, arch,
                                                        packed):
    """capacity_factor 0.25: cap = 4 slots an expert for far more
    dispatches, so most fall through to the residual."""
    dropped = hold_moe(run_moe(monkeypatch, arch, packed,
                               capacity_factor=0.25, T=32),
                       expect_drops=True)
    assert dropped >= 16


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_block_breaks_router_ties_to_the_lower_expert(monkeypatch,
                                                          arch):
    """Zero router columns give those experts the exact same logit (0) for
    every token: ties within and across the top-k boundary, which both
    sides must break to the lower expert index."""
    def router(w):
        w = w.copy()
        w[..., w.shape[-1] // 2:] = 0.0
        return w
    r = run_moe(monkeypatch, arch, packed=True, router=router)
    hold_moe(r)
    E = r["cfg"].n_experts
    tied = r["ref_choice"] >= E // 2
    assert tied.any()
    # within each row the tied experts come in ascending index order
    for row in r["ref_choice"]:
        ties = row[row >= E // 2]
        assert list(ties) == sorted(ties)


def test_route_is_stable_on_ties():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    vals, idx = tl.route(probs, 2)
    assert idx.tolist() == [[1, 2], [0, 1]]
    assert torch.equal(vals, torch.tensor([[0.3, 0.3], [0.25, 0.25]]))


# ---------------------------------------------------------------------------
# apply (teacher forcing) and the summed aux loss


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_apply_logits_and_aux(arch, packed):
    cfg, jcfg = cfgs(arch, attn_chunk=16)
    params, jparams = both_params(cfg, jcfg, numpy_params(cfg), packed)
    tok = np.random.default_rng(1).integers(0, cfg.vocab, (2, 24)).astype(
        np.int32)
    want = np.asarray(jt.apply(jparams, {"tokens": jnp.asarray(tok)}, jcfg))
    with torch.no_grad():
        got = transformer.apply(params, {"tokens": torch.from_numpy(tok)},
                                cfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    # the aux loss summed over the layers, on the same embedded input
    x = np.random.default_rng(2).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    _, jaux = jt._scan_layers(jcfg, jnp.asarray(x), jparams["layers"],
                              jnp.arange(24))
    with torch.no_grad():
        _, aux = transformer._scan_layers(cfg, torch.from_numpy(x),
                                          params["layers"],
                                          torch.arange(24))
    np.testing.assert_allclose(float(aux), float(jaux), **F32)
    assert float(aux) > 0


def test_apply_backward_reaches_the_experts():
    """Gradients flow through the dispatch and combine into every expert
    stack and the router (the training path is held on the CPU only)."""
    cfg, _ = cfgs(QWEN, remat="full")
    params = map_with_paths(lambda _, a: a.requires_grad_(),
                            params_from_numpy(numpy_params(cfg), "cpu"))
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 8)))
    transformer.apply(params, {"tokens": tok}, cfg).logsumexp(-1).sum() \
        .backward()
    for name in ("w_router", "we_gate", "we_up", "we_down", "ws_down"):
        g = params["layers"][name].grad
        assert g is not None and torch.isfinite(g).all() and g.abs().sum() > 0


# ---------------------------------------------------------------------------
# Serving: greedy tokens and step logits against the reference engine


def prompts(vocab, B, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, PROMPT_LENS[i % 4]).tolist()
            for i in range(B)]


def run_reference(arch, B):
    """The reference engine on babsmax16:n4-packed weights: tokens per rid,
    its recorded steps and packed params, and the byte accounting."""
    cfg, jcfg = cfgs(arch)
    npp = numpy_params(cfg)
    jparams = jax.tree.map(jnp.asarray, npp)
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
    for rid, pr in enumerate(prompts(cfg.vocab, B)):
        eng.submit(JRequest(prompt=pr, max_new_tokens=MAX_NEW, rid=rid))
    tokens = {g.rid: g.tokens for g in eng.run()}
    return dict(cfg=cfg, tokens=tokens, steps=steps, npp=npp,
                weight=eng.weight_bytes(), jpacked=eng.params)


def port_engine(cfg, npp, B, packed=True):
    params = params_from_numpy(npp, "cpu")
    plan = build_plan(params, SPEC)
    return ServeEngine.from_quantised(cfg, plan.quantise(params), plan,
                                      packed=packed, batch_slots=B,
                                      kv_len=KV_LEN, prefill_chunk=CHUNK,
                                      device="cpu")


def run_generate(eng, B):
    for rid, pr in enumerate(prompts(eng.cfg.vocab, B)):
        eng.submit(Request(prompt=pr, max_new_tokens=MAX_NEW, rid=rid))
    return {g.rid: g.tokens for g in eng.run()}


SERVE_CASES = [(QWEN, 1), (QWEN, 2), (QWEN, 4), (LLAMA4, 2), (INTERNLM, 2)]


@pytest.fixture(scope="module", params=SERVE_CASES,
                ids=lambda c: f"{c[0]}-B{c[1]}")
def served(request):
    arch, B = request.param
    ref = run_reference(arch, B)
    return arch, B, ref, port_engine(ref["cfg"], ref["npp"], B)


def test_greedy_tokens_match_the_reference(served):
    arch, B, ref, eng = served
    assert run_generate(eng, B) == ref["tokens"]
    assert eng.weight_bytes() == ref["weight"]


def test_teacher_forced_step_logits(served):
    """The reference's recorded batches through the port's decode_step:
    every valid position's logits within 1e-4 of max|logit| (f32)."""
    arch, B, ref, eng = served
    state = fresh_state(eng)
    with torch.inference_mode():
        for rec in ref["steps"]:
            state["pos"] = torch.from_numpy(rec["pos"].copy())
            batch = {k: torch.from_numpy(v.copy())
                     for k, v in rec["batch"].items()}
            logits, state = eng.fam.decode_step(eng.params, state, batch,
                                                eng.cfg)
            for i, tv in enumerate(rec["batch"]["t_valid"]):
                if tv == 0:
                    continue
                want = rec["logits"][i, :tv]
                np.testing.assert_allclose(
                    logits[i, :tv].numpy(), want, rtol=1e-4,
                    atol=1e-4 * np.abs(want).max())


def fresh_state(eng):
    return alloc_decode_state(eng.fam, eng.cfg, eng.B, eng.kv_len,
                              slack=eng.prefill_chunk, device="cpu")


def test_interop_carries_4d_packed_stacks(served):
    """The reference's packed tree (expert stacks (L, E, K/2, N) with two
    lead dims) carried across as field dicts: bitwise the port's own
    packing, per-layer views of the right shape, and the same tokens."""
    arch, B, ref, eng = served

    def fields(x):
        if isinstance(x, JPacked):
            return {"codes": np.asarray(x.codes),
                    "scales": np.asarray(x.scales),
                    "codepoints": x.codepoints, "out_shape": x.out_shape,
                    "shape": x.shape, "dtype": x.dtype, "block": x.block,
                    "bits": x.bits}
        return np.asarray(x)
    tree = jax.tree.map(fields, ref["jpacked"], is_leaf=is_jpacked)
    carried = params_from_numpy(tree, "cpu")
    own = dict(flat_with_paths(eng.params))
    n4d = 0
    for name, leaf in flat_with_paths(carried):
        mine = own[name]
        assert type(leaf) is type(mine), name
        if isinstance(leaf, PackedTensor):
            assert torch.equal(leaf.codes, mine.codes), name
            assert torch.equal(leaf.scales, mine.scales), name
            assert (leaf.shape, leaf.out_shape, leaf.bits, leaf.block) == \
                (mine.shape, mine.out_shape, mine.bits, mine.block)
            leaf.verify(name)
            if leaf.codes.ndim == 4:
                n4d += 1
                view = leaf.layer(1)
                assert view.codes.shape == leaf.codes.shape[1:]
                assert view.shape == leaf.shape[1:]
        else:
            assert torch.equal(leaf, mine), name
    assert n4d == (3 if eng.cfg.n_experts else 0)
    eng2 = ServeEngine(eng.cfg, carried, batch_slots=B, kv_len=KV_LEN,
                       prefill_chunk=CHUNK, device="cpu")
    assert run_generate(eng2, B) == ref["tokens"]


def test_engine_over_expert_stacks():
    """weight_bytes, params_to, _has_packed and degrade_to_dense over the
    4-D expert stacks: the degraded engine serves the tokens of the engine
    built dense from the same quantised checkpoint."""
    cfg, _ = cfgs(QWEN)
    npp = numpy_params(cfg)
    eng = port_engine(cfg, npp, 2)
    dense = port_engine(cfg, npp, 2, packed=False)
    layers = eng.params["layers"]
    for name in ("we_gate", "we_up", "we_down", "ws_gate", "ws_up",
                 "ws_down"):
        assert isinstance(layers[name], PackedTensor) and \
            layers[name].bits == 4, name
    assert layers["we_gate"].codes.shape == (2, 8, 32, 48)
    assert not isinstance(layers["w_router"], PackedTensor)
    wb = eng.weight_bytes()
    n_packed = sum(int(np.prod(x.shape)) for _, x in flat_with_paths(
        eng.params) if isinstance(x, PackedTensor))
    assert wb["codes"] == n_packed // 2
    assert wb["scales"] == n_packed // 16 * 2
    assert wb["codebooks"] == 12 * 16 * 4
    want = run_generate(dense, 2)
    assert eng._has_packed()
    with pytest.warns(RuntimeWarning, match="12 packed tensor"):
        eng.degrade_to_dense()
    assert not eng._has_packed()
    assert run_generate(eng, 2) == want


# ---------------------------------------------------------------------------
# Setup one leaf at a time (build_packed_engine: launch.serve --packed and
# chip_smoke.py)


def test_init_leaves_equal_init():
    cfg = configs.get_config(QWEN, "smoke")
    specs = transformer.param_specs(cfg)
    whole = dict(flat_with_paths(init_from_specs(specs, seed=3,
                                                 device="cpu")))
    streamed = list(init_leaves(specs, seed=3, device="cpu"))
    assert [n for n, _ in streamed] == sorted(whole) == list(whole)
    for name, x in streamed:
        assert torch.equal(x, whole[name]), name


@pytest.mark.parametrize("arch", [QWEN, LLAMA4])
def test_pack_leaf_equals_pack(arch):
    """A leaf packed slice by slice along its first lead dim equals that
    leaf of the whole tree's ``pack``; unplanned and unpackable leaves go
    as ``pack`` sends them."""
    cfg = configs.get_config(arch, "smoke")
    params = transformer.init(cfg, seed=0, device="cpu")
    plan = build_plan(params, SPEC)
    layouts = transformer.pack_layouts(cfg)
    whole = dict(flat_with_paths(plan.pack(params, layouts)))
    for name, x in flat_with_paths(params):
        got, want = plan.pack_leaf(name, x, layouts), whole[name]
        assert type(got) is type(want), name
        if isinstance(want, PackedTensor):
            assert torch.equal(got.codes, want.codes), name
            assert torch.equal(got.scales, want.scales), name
            fields = ("codepoints", "out_shape", "shape", "dtype", "block",
                      "bits")
            assert [getattr(got, f) for f in fields] == \
                [getattr(want, f) for f in fields], name
        else:
            assert torch.equal(got, want), name


def test_streamed_engine_equals_init_and_pack():
    """``build_packed_engine`` over ``init_leaves`` (leaf-streamed draw,
    per-slice packing, plan from meta tensors) serves the weights of
    ``init`` then ``plan.pack``, at smoke size on the CPU."""
    smoke = configs.get_config(QWEN, "smoke")
    eng, bits = build_packed_engine(
        smoke, SPEC, init_leaves(transformer.param_specs(smoke), seed=0,
                                 device="cpu"),
        kv_len=KV_LEN, device="cpu")
    params = transformer.init(smoke, seed=0, device="cpu")
    plan = build_plan(params, SPEC)
    assert bits == plan.bits_per_param(params)
    want = dict(flat_with_paths(plan.pack(params,
                                          transformer.pack_layouts(smoke))))
    got = dict(flat_with_paths(eng.params))
    assert sorted(got) == sorted(want)
    for name, x in want.items():
        if isinstance(x, PackedTensor):
            assert torch.equal(got[name].codes, x.codes), name
            assert torch.equal(got[name].scales, x.scales), name
        else:
            assert torch.equal(got[name], x), name


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_cli_packed_serves_the_seeded_weights(arch, capsys):
    """``launch.serve --packed`` draws and packs one leaf at a time; its
    greedy tokens are those of the engine built from the whole seeded tree
    (``init``, ``plan.quantise``, ``from_quantised``), and its expert stacks
    serve packed."""
    from repro_torch.launch import serve
    argv = ["--arch", arch, "--variant", "smoke", "--quantise", SPEC,
            "--packed", "--kv-len", "32", "--requests", "3", "--max-new",
            "5", "--seed", "2", "--no-dense-fallback", "--device", "cpu"]
    done = serve.main(argv)
    out = capsys.readouterr().out
    cfg = configs.get_config(arch, "smoke")
    params = transformer.init(cfg, seed=2, device="cpu")
    plan = build_plan(params, SPEC)
    eng = ServeEngine.from_quantised(cfg, plan.quantise(params), plan,
                                     kv_len=32, device="cpu")
    assert isinstance(eng.params["layers"]["we_down"], PackedTensor)
    rng = np.random.default_rng(2)
    for rid in range(3):
        eng.submit(Request(prompt=rng.integers(0, cfg.vocab, 4).tolist(),
                           max_new_tokens=5, rid=rid))
    want = {g.rid: g.tokens for g in eng.run()}
    assert {g.rid: g.tokens for g in done} == want
    wb = eng.weight_bytes()
    assert (f"{wb['codes']:,} codes + {wb['scales']:,} scales" in out and
            f"{plan.bits_per_param(params):.2f} bits/param" in out)


# ---------------------------------------------------------------------------
# chip_smoke.py's routing witness, with the plain path as the "card"


@pytest.fixture(scope="module")
def routed():
    """qwen2-moe smoke packed, 2 requests: the recorded steps and each
    step's per-layer expert choices."""
    cfg, _ = cfgs(QWEN)
    eng = port_engine(cfg, numpy_params(cfg), 2)
    rec = chip_smoke.StepRecorder(eng.fam.decode_step, True)
    routes = chip_smoke.RouteRecorder()
    eng.fam = dataclasses.replace(eng.fam, decode_step=rec)
    sync = torch.cuda.synchronize
    torch.cuda.synchronize = lambda *a, **kw: None   # no card here
    try:
        with routes.installed():
            run_generate(eng, 2)
    finally:
        torch.cuda.synchronize = sync
    eng.fam = dataclasses.replace(eng.fam, decode_step=rec.step)
    return eng, rec.records, routes.calls


def test_route_recorder_counts_one_call_a_layer(routed):
    eng, records, calls = routed
    L = eng.cfg.n_layers
    assert len(calls) == len(records) * L
    for i, rec in enumerate(records):
        assert all(tuple(c.shape) == (eng.B * rec["T"], 4)
                   for c in calls[i * L:(i + 1) * L])


def test_route_witness_agrees_with_the_path_that_routed(routed):
    eng, records, calls = routed
    stats = chip_smoke.route_stats()
    worst = max(float(np.abs(got - want).max())
                for got, want, _ in chip_smoke.replay_on_cpu(
                    eng, records, routes=calls, route_stats=stats))
    assert worst == 0.0
    assert stats["dispatches"] == sum(c.numel() for c in calls)
    assert stats["differ"] == 0


def test_route_witness_replays_the_recorded_choices(routed):
    """Choices recorded from another router are what the replay uses: the
    witness counts every flipped dispatch, and the replayed logits follow
    the recorded choices, not the CPU's own."""
    eng, records, calls = routed
    flipped = [(c + 1) % eng.cfg.n_experts for c in calls]
    stats = chip_smoke.route_stats()
    worst = max(float(np.abs(got - want).max())
                for got, want, _ in chip_smoke.replay_on_cpu(
                    eng, records, routes=flipped, route_stats=stats))
    assert 0 < stats["differ"] <= stats["dispatches"]
    assert worst > 0.0


def test_hold_route_witness_rejects_a_faulty_router(routed):
    """The witness's rule passes the path that routed, and fails choices
    from a faulty router: every expert moved one up (most dispatches
    differ), or the right experts in another order (every token
    reordered)."""
    eng, records, calls = routed

    def counts(routes):
        stats = chip_smoke.route_stats()
        for _ in chip_smoke.replay_on_cpu(eng, records, routes=routes,
                                          route_stats=stats):
            pass
        return stats
    held = chip_smoke.hold_route_witness(counts(calls))
    assert held["differ_share"] == held["reordered_share"] == 0.0
    assert held["tokens"] * eng.cfg.experts_per_token == held["dispatches"]
    flipped = counts([(c + 1) % eng.cfg.n_experts for c in calls])
    assert flipped["differ"] > chip_smoke.ROUTE_DIFFER_MAX * \
        flipped["dispatches"]
    with pytest.raises(RuntimeError, match="routing disagrees"):
        chip_smoke.hold_route_witness(flipped)
    reordered = counts([c.flip(-1) for c in calls])
    assert reordered["differ"] == 0
    assert reordered["tokens_reordered"] == reordered["tokens"]
    with pytest.raises(RuntimeError, match="routing disagrees"):
        chip_smoke.hold_route_witness(reordered)


def test_dropped_share_counts_dispatches_past_capacity():
    choice = torch.tensor([[0, 1], [0, 2], [0, 3], [0, 1], [0, 2], [1, 2]])
    # N = 6, k = 2, E = 4: cap = max(ceil(1.25 * 2 * 6 / 4), 4) = 4; expert
    # 0 takes 5 dispatches, so one is dropped
    assert chip_smoke.dropped_dispatches(choice, 4, 1.25) == 1
    assert chip_smoke.dropped_dispatches(choice, 4, 2.0) == 0
