"""Port vs reference for the paper's measurement and allocation path: the
metrics, the Eq. 5 bit allocation (a numpy carry-over: results equal
exactly), the per-tensor statistics and the allocated plan, the diagonal
and KV-cache Fisher estimators, the two-stage accumulator and
``--kv-format auto``.

Labels are sampled from the model in both packages, by ``jax.random`` and
by a ``torch.Generator``, which cannot agree. So the Fisher comparisons fix
the labels on both sides: the port's sampler (``fisher._sample_labels``) and
the reference's ``jax.random.categorical`` are monkeypatched, or the
reference side is a test-side ``jax.grad`` over the reference ``apply``.
Tolerances: f32 1e-5 relative (of each leaf's largest value where stated),
numpy carry-overs exact."""
import argparse
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import configs as jconfigs
from repro.core import allocation as jalloc
from repro.core import fisher as jfisher
from repro.core import metrics as jmetrics
from repro.core import plan as jplan_mod
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.models import transformer as jt

from repro_torch import configs
from repro_torch.core import allocation, fisher, metrics
from repro_torch.core.plan import (build_allocated_plan, flat_with_paths,
                                   map_with_paths)
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import transformer
from repro_torch.models.api import get_family
from repro_torch.serve.engine import alloc_decode_state

ARCHS = ["paper-100m", "gemma3-1b"]
# the weight Fisher is also held for the MoE family (routed expert stacks)
# and the VLM (internvl: the visual prefix's logits get labels too)
FISHER_ARCHS = ARCHS + ["qwen2-moe-a2.7b", "internvl2-26b"]
T = 24                   # above gemma3-1b smoke's window of 16


def numpy_params(cfg, seed=0):
    rng = np.random.default_rng(seed)

    def make(path, spec):
        if "norm" in path:
            return (1 + 0.1 * rng.standard_normal(spec.shape)
                    ).astype(np.float32)
        std = 0.5 if "embed" in path else \
            1 / np.sqrt(spec.numel // spec.shape[-1])
        return (rng.standard_normal(spec.shape) * std).astype(np.float32)
    return map_with_paths(make, get_family(cfg.family).param_specs(cfg))


def cfgs(arch, **kw):
    kw = dict(dtype="float32", **kw)
    return (configs.get_config(arch, "smoke").replace(**kw),
            jconfigs.get_config(arch, "smoke").replace(**kw))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# metrics


def logits_pair(seed, shape=(3, 7, 64)):
    rng = np.random.default_rng(seed)
    ref = (rng.standard_normal(shape) * 3).astype(np.float32)
    test = (ref + 0.3 * rng.standard_normal(shape)).astype(np.float32)
    return ref, test


@pytest.mark.parametrize("k", [1, 16, 48])
def test_topk_kl(k):
    """k below the vocabulary of 64. Both packages sum the k top
    probabilities and take the tail mass 1 - Σp in f32, so the per-position
    KLs (about 0.05) agree within 1e-5 relative and 1e-6 absolute."""
    ref, test = logits_pair(k)
    want = jmetrics.topk_kl(jnp.asarray(ref), jnp.asarray(test), k)
    got = metrics.topk_kl(t(ref), t(test), k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert (got >= 0).all()


@pytest.mark.parametrize("masked", [False, True])
def test_mean_topk_kl(masked):
    ref, test = logits_pair(7)
    mask = (np.random.default_rng(8).random((3, 7)) < 0.6) if masked \
        else None
    want = jmetrics.mean_topk_kl(jnp.asarray(ref), jnp.asarray(test), 16,
                                 None if mask is None else jnp.asarray(mask))
    got = metrics.mean_topk_kl(t(ref), t(test), 16,
                               None if mask is None else t(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_cross_entropy_rho_snr():
    ref, _ = logits_pair(9)
    labels = np.random.default_rng(10).integers(0, 64, (3, 7))
    np.testing.assert_allclose(
        float(metrics.cross_entropy(t(ref), t(labels))),
        float(jmetrics.cross_entropy(jnp.asarray(ref), jnp.asarray(labels))),
        rtol=1e-6)
    for kl, bits in ((0.013, 4.0), (2e-4, 6.5)):
        assert metrics.rho(kl, bits) == jmetrics.rho(kl, bits)
    for r in (0.5, 1e-3, 0.0):
        assert metrics.snr_db(r) == jmetrics.snr_db(r)


# ---------------------------------------------------------------------------
# allocation (numpy carry-over: exact)


def seeded_stats(seed, n=6):
    rng = np.random.default_rng(seed)
    names = ["['embed']"] + [f"layers.{i}.w" for i in range(n - 2)] + \
        ["['unembed']"]
    return {name: dict(numel=int(rng.integers(512, 1 << 20)),
                       rms=float(10.0 ** rng.uniform(-3, 0)),
                       fisher_mean=float(10.0 ** rng.uniform(-9, -2)))
            for name in names}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("b_min,b_max", [(0.5, 16.0), (2.0, 8.0)])
def test_allocate_bits_exact(seed, integer, b_min, b_max):
    stats = seeded_stats(seed)
    assert allocation.raw_sensitivity(stats) == \
        jalloc.raw_sensitivity(stats)
    got = allocation.allocate_bits(stats, 4.0, b_min, b_max, integer)
    assert got == jalloc.allocate_bits(stats, 4.0, b_min, b_max, integer)
    assert allocation.average_bits(got, stats) == \
        jalloc.average_bits(got, stats)


@given(target=st.floats(2.0, 8.0), seed=st.integers(0, 1000))
@settings(max_examples=25, deadline=None)
def test_allocate_bits_exact_property(target, seed):
    stats = seeded_stats(seed, n=8)
    assert allocation.allocate_bits(stats, target) == \
        jalloc.allocate_bits(stats, target)


@pytest.mark.parametrize("seed", [0, 1])
def test_heuristic_bits_exact(seed):
    stats = seeded_stats(seed, n=8)
    got = allocation.heuristic_bits(stats, 4.0, n_layers=6)
    assert got == jalloc.heuristic_bits(stats, 4.0, n_layers=6)


@pytest.mark.parametrize("fmt", ["f32", "q8", "q4"])
@pytest.mark.parametrize("head_dim", [32, 64, 256])
def test_kv_format_bytes_exact(fmt, head_dim):
    assert allocation.kv_format_bytes(fmt, head_dim) == \
        jalloc.kv_format_bytes(fmt, head_dim)


@pytest.mark.parametrize("budget", [1e9, 4.9e6, 4.0e6, 1.3e6, 7e5, 1e3])
def test_allocate_kv_formats_exact(budget):
    """From all f32 through partial demotions to all q4, and an all-q4
    overrun, which both packages refuse."""
    stats = {f"g{i}": s for i, s in enumerate(seeded_stats(3, n=3).values())}
    try:
        want = jalloc.allocate_kv_formats(stats, budget, 256)
    except ValueError:
        with pytest.raises(ValueError, match="all-q4"):
            allocation.allocate_kv_formats(stats, budget, 256)
        return
    assert allocation.allocate_kv_formats(stats, budget, 256) == want


# ---------------------------------------------------------------------------
# per-tensor statistics and the allocated plan


@pytest.fixture(scope="module", params=ARCHS)
def arch_params(request):
    cfg, jcfg = cfgs(request.param)
    npp = numpy_params(cfg)
    rng = np.random.default_rng(11)
    fish = map_with_paths(lambda _, x: (rng.random(x.shape) * 1e-4).astype(
        np.float32), npp)
    return cfg, jcfg, npp, fish


def test_per_tensor_stats_names_and_values(arch_params):
    """The same keys in the same order (the plan's keystr paths), f64
    summaries equal up to summation order."""
    _, _, npp, fish = arch_params
    want = jfisher.per_tensor_stats(jax.tree.map(jnp.asarray, npp),
                                    jax.tree.map(jnp.asarray, fish))
    got = fisher.per_tensor_stats(params_from_numpy(npp, "cpu"),
                                  params_from_numpy(fish, "cpu"))
    assert list(got) == list(want)
    assert "['layers']['wq']" in got
    for name, s in got.items():
        assert s["numel"] == want[name]["numel"]
        for key in ("rms", "fisher_mean"):
            np.testing.assert_allclose(s[key], want[name][key], rtol=1e-12)


def test_build_allocated_plan(arch_params):
    """One allocation names the same tensors in both packages; the formats
    carry the same widths and codebooks, and fake-quantise the weights to
    the same values."""
    _, _, npp, fish = arch_params
    stats = jfisher.per_tensor_stats(jax.tree.map(jnp.asarray, npp),
                                     jax.tree.map(jnp.asarray, fish))
    alloc = allocation.allocate_bits(stats, 4.0, b_min=2, b_max=8)
    jparams = jax.tree.map(jnp.asarray, npp)
    params = params_from_numpy(npp, "cpu")
    want = jplan_mod.build_allocated_plan(jparams, alloc, "babsmax128")
    got = build_allocated_plan(params, alloc, "babsmax128")
    assert list(got.formats) == list(want.formats)
    quantised = 0
    for name, f in got.formats.items():
        jf = want.formats[name]
        assert (f is None) == (jf is None), name
        if f is None:
            continue
        quantised += 1
        assert f.name == jf.name
        assert f.element.codepoints == jf.element.codepoints
    assert quantised >= 7
    fq = dict(flat_with_paths(got.fake_quant(params)))
    jfq = dict(flat_with_paths(jax.tree.map(np.asarray,
                                            want.fake_quant(jparams))))
    for name, x in fq.items():
        np.testing.assert_allclose(x.numpy(), jfq[name], rtol=1e-6,
                                   atol=1e-7, err_msg=name)


# ---------------------------------------------------------------------------
# the two-stage accumulator


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_accumulator_mean_is_the_host_quotient(dtype, lazy):
    """``mean`` divides the f64 sums and rounds once to f32. With lazy host
    buffers and nothing folded it divides the device buffers in f64, with
    the bits of the host's quotient (a -0 update included: the sum is
    +0), and makes no host buffer; after a fold both take the host's
    path."""
    rng = np.random.default_rng(4)
    shapes = {"a": (3, 5), "b": (7,)}
    template = map_with_paths(lambda _, s: np.zeros(s, np.float32), shapes)
    updates = [map_with_paths(lambda _, s: (rng.standard_normal(s) * 1e3
                                            ).astype(np.float32), shapes)
               for _ in range(3)]
    updates[0]["b"][2] = -0.0
    for u in updates[1:]:
        u["b"][2] = 0.0
    dt = getattr(torch, dtype)
    acc = fisher.TwoStageAccumulator(params_from_numpy(template, "cpu"),
                                     device_dtype=dt, lazy_host=lazy)
    ref = fisher.TwoStageAccumulator(params_from_numpy(template, "cpu"),
                                     device_dtype=dt)
    for u in updates:
        acc.add(params_from_numpy(u, "cpu"))
        ref.add(params_from_numpy(u, "cpu"))
    got = dict(flat_with_paths(acc.mean(3)))
    assert (acc._host == {}) == lazy
    want = {p: torch.from_numpy(f / 3).float()
            for p, f in flat_with_paths(ref.value())}
    for p in want:
        assert got[p].dtype == torch.float32
        assert torch.equal(got[p], want[p]) and not torch.signbit(
            got[p]).logical_and(got[p] == 0).any()
    acc.flush()
    assert all(torch.equal(g, want[p])
               for p, g in flat_with_paths(acc.mean(3)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_stage_accumulator_flushes(dtype):
    """Updates sum in the device dtype until ``flush_every`` of them, then
    fold into f64 on the host; the bf16 sums round as the reference's."""
    rng = np.random.default_rng(12)
    shapes = {"a": (3, 4), "b": {"c": (5,)}}
    template = map_with_paths(lambda _, s: np.zeros(s, np.float32), shapes)
    updates = [map_with_paths(lambda _, s: (rng.standard_normal(s) * 1e3
                                            ).astype(np.float32), shapes)
               for _ in range(7)]
    acc = fisher.TwoStageAccumulator(params_from_numpy(template, "cpu"),
                                     device_dtype=getattr(torch, dtype),
                                     flush_every=3)
    jacc = jfisher.TwoStageAccumulator(jax.tree.map(jnp.asarray, template),
                                       device_dtype=jnp.dtype(dtype),
                                       flush_every=3)
    for i, u in enumerate(updates):
        acc.add(params_from_numpy(u, "cpu"))
        jacc.add(jax.tree.map(jnp.asarray, u))
        assert acc._pending == jacc._pending == (i + 1) % 3
        mine = acc._host
        theirs = dict(flat_with_paths(jacc._host))
        for p in theirs:
            np.testing.assert_array_equal(mine[p], theirs[p])
            assert (not mine[p].any()) == (i < 2)
    got = dict(flat_with_paths(acc.value()))
    want = dict(flat_with_paths(jacc.value()))
    assert set(got) == set(want)
    for p in want:
        assert got[p].dtype == np.float64
        np.testing.assert_array_equal(got[p], want[p])


# ---------------------------------------------------------------------------
# diagonal Fisher


def fixed_labels(monkeypatch, labels):
    """The port's sampler hands out ``labels`` in order, one per call."""
    queue = list(labels)

    def sample(logits, generator):
        y = queue.pop(0)
        assert tuple(y.shape) == tuple(logits.shape[:-1])
        return t(y).long().to(logits.device)
    monkeypatch.setattr(fisher, "_sample_labels", sample)
    return queue


def batches_of(cfg, n_batches, bsz, seed=13):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, (bsz, T)).astype(np.int32)
            for _ in range(n_batches)]


@pytest.mark.parametrize("arch", FISHER_ARCHS)
def test_diag_fisher_with_the_same_labels_per_sequence(arch, monkeypatch):
    """Two batches of two sequences, each with its own fixed labels: the
    port's estimator (remat full, so the rematerialised backward runs)
    against a test-side ``jax.grad`` over the reference ``apply``: each
    leaf within 1e-5 of its largest value. internvl's sequences carry
    image patches, and its visual prefix's positions labels too."""
    cfg, jcfg = cfgs(arch, remat="full")
    npp = numpy_params(cfg)
    toks = batches_of(cfg, 2, 2)
    rng = np.random.default_rng(14)
    n_pos = T + cfg.n_vis_tokens
    labels = [rng.integers(0, cfg.vocab, (1, n_pos)) for _ in range(4)]
    batches = [{"tokens": x} for x in toks]
    if cfg.family == "internvl":
        from repro_torch.models.internvl import D_VIT
        vis = np.random.default_rng(17)
        for b in batches:
            b["vis"] = vis.standard_normal(
                (2, cfg.n_vis_tokens, D_VIT)).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, npp)
    japply = japi.get_family(jcfg.family).apply

    def sq_grad(seq, y):
        def loss(p):
            logits = japply(p, {k: jnp.asarray(v)[None]
                                for k, v in seq.items()}, jcfg)
            logp = jax.nn.log_softmax(logits, axis=-1)
            return -jnp.sum(jnp.take_along_axis(
                logp, jnp.asarray(y)[..., None], axis=-1))
        return jax.tree.map(lambda g: np.square(np.asarray(g, np.float64)),
                            jax.grad(loss)(jparams))
    seqs = [{k: v[b] for k, v in batch.items()} for batch in batches
            for b in range(2)]
    sums = [sq_grad(s, y) for s, y in zip(seqs, labels)]
    want = jax.tree.map(lambda *g: sum(g) / (2 * 2 * T), *sums)

    queue = fixed_labels(monkeypatch, labels)
    apply = get_family(cfg.family).apply
    got = fisher.estimate_diag_fisher(
        lambda p, b: apply(p, b, cfg),
        params_from_numpy(npp, "cpu"),
        [{k: t(v) for k, v in batch.items()} for batch in batches],
        torch.Generator().manual_seed(0))
    assert not queue
    want = dict(flat_with_paths(want))
    got = dict(flat_with_paths(got))
    assert set(got) == set(want)
    for p, f in got.items():
        assert f.dtype == torch.float32
        np.testing.assert_allclose(f.numpy(), want[p], rtol=1e-5,
                                   atol=1e-5 * np.abs(want[p]).max(),
                                   err_msg=p)


def test_diag_fisher_against_the_reference_estimator(monkeypatch):
    """The reference's own ``estimate_diag_fisher``, its categorical draw
    replaced by one fixed label row (which its vmap and jit then give every
    sequence), against the port's given the same row: the per-tensor
    statistics agree within 1e-5, and max_batches stops both."""
    cfg, jcfg = cfgs("gemma3-1b")
    npp = numpy_params(cfg)
    toks = batches_of(cfg, 3, 2)
    y = np.random.default_rng(15).integers(0, cfg.vocab, (1, T))
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, axis=-1: jnp.asarray(y))
    jparams = jax.tree.map(jnp.asarray, npp)
    want = jfisher.estimate_diag_fisher(
        lambda p, b: jt.apply(p, b, jcfg), jparams,
        [{"tokens": jnp.asarray(x)} for x in toks], jax.random.PRNGKey(0),
        max_batches=2)
    fixed_labels(monkeypatch, [y] * 4)
    params = params_from_numpy(npp, "cpu")
    got = fisher.estimate_diag_fisher(
        lambda p, b: transformer.apply(p, b, cfg), params,
        [{"tokens": t(x)} for x in toks], torch.Generator().manual_seed(0),
        max_batches=2)
    want_stats = jfisher.per_tensor_stats(jparams, want)
    got_stats = fisher.per_tensor_stats(params, got)
    assert list(got_stats) == list(want_stats)
    for name, s in got_stats.items():
        np.testing.assert_allclose(s["fisher_mean"],
                                   want_stats[name]["fisher_mean"],
                                   rtol=1e-5, err_msg=name)
        assert s["rms"] == pytest.approx(want_stats[name]["rms"], rel=1e-12)


def test_labels_come_from_the_generator():
    """The sampler draws from the model's own distribution with the
    generator it is given: the same seed gives the same labels, and a
    near-one-hot row gives its argmax."""
    logits = torch.randn(2, 5, 32, generator=torch.Generator().manual_seed(1))
    a = fisher._sample_labels(logits, torch.Generator().manual_seed(3))
    b = fisher._sample_labels(logits, torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and a.shape == (2, 5) and a.dtype == torch.int64
    peaked = logits.clone()
    peaked[..., 7] = 1e4
    assert (fisher._sample_labels(peaked, torch.Generator()) == 7).all()


# ---------------------------------------------------------------------------
# KV-cache Fisher


KV = dict(batch_size=2, kv_len=32, warm_steps=8, samples=2)


def test_kv_fisher_label_free_parts_match():
    """numel and rms summarise the warm cache only: no labels involved,
    so both packages agree without any injection."""
    cfg, jcfg = cfgs("gemma3-1b")
    npp = numpy_params(cfg)
    want = jfisher.estimate_kv_fisher(jcfg, jax.tree.map(jnp.asarray, npp),
                                      **KV)
    got = fisher.estimate_kv_fisher(cfg, params_from_numpy(npp, "cpu"), **KV)
    assert list(got) == list(want) == ["g0", "g1"]
    for g, s in got.items():
        assert s["numel"] == want[g]["numel"]
        np.testing.assert_allclose(s["rms"], want[g]["rms"], rtol=1e-5)
        assert s["fisher_mean"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_kv_fisher_with_the_same_labels(arch, monkeypatch):
    cfg, jcfg = cfgs(arch)
    npp = numpy_params(cfg)
    y = np.random.default_rng(16).integers(0, cfg.vocab, (2,))
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, axis=-1: jnp.asarray(y))
    want = jfisher.estimate_kv_fisher(jcfg, jax.tree.map(jnp.asarray, npp),
                                      **KV)
    fixed_labels(monkeypatch, [y] * KV["samples"])
    got = fisher.estimate_kv_fisher(cfg, params_from_numpy(npp, "cpu"), **KV)
    assert list(got) == list(want)
    for g, s in got.items():
        assert s["numel"] == want[g]["numel"]
        for key in ("rms", "fisher_mean"):
            np.testing.assert_allclose(s[key], want[g][key], rtol=1e-5,
                                       err_msg=f"{g} {key}")


def test_overwritten_cache_slot_gets_zero_gradient():
    """The differentiated decode step writes its new k/v in place into a
    clone of the leaf: the slot it overwrites (position 8, in the ring and
    in the linear group) has zero gradient, the warm slots before it
    do not, and the leaf itself is left as it was."""
    cfg, _ = cfgs("gemma3-1b")
    params = params_from_numpy(numpy_params(cfg), "cpu")
    fam = get_family(cfg.family)
    state = alloc_decode_state(fam, cfg, 2, 32, slack=1, device="cpu")
    tok = torch.ones((2, 1), dtype=torch.int32)
    with torch.no_grad():
        for _ in range(8):
            logits, state = fam.decode_step(params, state, {"tokens": tok},
                                            cfg)
            tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    keys = ["k0", "v0", "k1", "v1"]
    leaves = {k: state[k].detach().clone().requires_grad_(True)
              for k in keys}
    with torch.autograd.graph.allow_mutation_on_saved_tensors():
        st = dict(state, **{k: x.clone() for k, x in leaves.items()})
        logits, _ = fam.decode_step(params, st, {"tokens": tok}, cfg)
        grads = torch.autograd.grad(logits[:, -1].logsumexp(-1).sum(),
                                    [leaves[k] for k in keys])
    for k, g in zip(keys, grads):
        assert torch.equal(leaves[k], state[k])
        assert not g[:, :, 8].any(), k
        assert g[:, :, :8].abs().sum(dim=(0, 1, 3, 4)).gt(0).all(), k
        assert not g[:, :, 9:].any(), k


# ---------------------------------------------------------------------------
# --kv-format auto


@pytest.fixture(scope="module")
def gemma_kv_stats():
    cfg, _ = cfgs("gemma3-1b")
    return fisher.estimate_kv_fisher(
        cfg, params_from_numpy(numpy_params(cfg), "cpu"), **KV)


@pytest.mark.parametrize("budget", [10 ** 7, 150_000, 100_000, 60_000,
                                    40_000, 1_000])
@pytest.mark.parametrize("uniform", [False, True])
def test_kv_format_auto_gives_the_reference_formats(gemma_kv_stats, budget,
                                                    uniform, monkeypatch,
                                                    capsys):
    """From the same calibration statistics, ``--kv-format auto`` rescales
    them to the serving geometry and picks the reference's formats (or
    refuses an all-q4 overrun as it does)."""
    import repro_torch.core.fisher as tfisher
    monkeypatch.setattr(tfisher, "estimate_kv_fisher",
                        lambda *a, **k: copy.deepcopy(gemma_kv_stats))
    monkeypatch.setattr(jfisher, "estimate_kv_fisher",
                        lambda *a, **k: copy.deepcopy(gemma_kv_stats))
    args = argparse.Namespace(kv_budget_bytes=budget, kv_len=64, slots=4,
                              prefill_chunk=8, uniform_cache=uniform)
    cfg, jcfg = cfgs("gemma3-1b")
    fam, jfam = get_family(cfg.family), japi.get_family(jcfg.family)
    try:
        want = jserve._auto_kv_format(jcfg, jfam, None, args)
    except ValueError:
        with pytest.raises(ValueError, match="all-q4"):
            serve._auto_kv_format(cfg, fam, None, args)
        return
    assert serve._auto_kv_format(cfg, fam, None, args) == want
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] and want in out[1]


def test_kv_format_auto_needs_a_budget():
    cfg, _ = cfgs("gemma3-1b")
    args = argparse.Namespace(kv_budget_bytes=None)
    with pytest.raises(SystemExit, match="kv-budget-bytes"):
        serve._auto_kv_format(cfg, get_family(cfg.family), None, args)


def test_serve_kv_format_auto_on_the_cpu(capsys):
    """The launcher end to end at gemma3-1b smoke: the allocation demotes
    under the budget, and the engine serves packed weights on the formats
    it chose."""
    done = serve.main(["--arch", "gemma3-1b", "--variant", "smoke",
                       "--quantise", "babsmax64:n4", "--packed",
                       "--kv-format", "auto", "--kv-budget-bytes", "60000",
                       "--kv-len", "64", "--requests", "2", "--max-new", "4",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if "kv auto allocation" in ln)
    fmts = line.split(": ")[1].split(" ")[0].split(",")
    assert len(fmts) == 2 and set(fmts) != {"f32"}
    assert f"quantised KV ({','.join(fmts)})" in out
    assert len(done) == 2 and all(len(g.tokens) == 4 for g in done)
