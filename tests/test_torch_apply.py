"""Port vs reference for the teacher-forcing forward: ``flash_attention``,
``transformer.apply``/``prefill`` on dense and packed weights, rematerialised
layers, and the gradients of a fixed-label loss. The same seeded numpy
weights and tokens go through ``repro`` (JAX, packed matmuls through its jnp
oracles) and ``repro_torch`` (packed matmuls through the kernels' plain
versions). Configs: paper-100m and gemma3-1b smoke, T = 40 above gemma's
window of 16, attention chunks of 16 (so Tk pads to 48).

Tolerances: f32 1e-5 relative (summation order only); bf16 1e-2 of the
largest logit (the two frameworks round bf16 at different places)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import build_plan as jbuild_plan
from repro.models import layers as jl
from repro.models import transformer as jt

from repro_torch import configs
from repro_torch.core import build_plan
from repro_torch.core.plan import flat_with_paths, map_with_paths
from repro_torch.interop import params_from_numpy
from repro_torch.models import layers as tl
from repro_torch.models import transformer
from repro_torch.models.api import get_family

SPEC = "babsmax64:n4"
ARCHS = ["paper-100m", "gemma3-1b"]
B, T, CHUNK = 2, 40, 16
F32 = dict(rtol=1e-5, atol=1e-5)


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


def cfgs(arch, dtype, **kw):
    kw = dict(dtype=dtype, attn_chunk=CHUNK, **kw)
    return (configs.get_config(arch, "smoke").replace(**kw),
            jconfigs.get_config(arch, "smoke").replace(**kw))


def tokens(cfg, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, T)).astype(np.int32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# flash_attention


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("k_valid_len", [None, 13])
@pytest.mark.parametrize("chunk", [8, 1024])
def test_flash_attention_f32(causal, window, k_valid_len, chunk):
    """Tq = Tk = 21: a chunk of 8 pads Tk to 24 with keys at 2³⁰; 1024
    takes all of Tk in one chunk."""
    rng = np.random.default_rng(chunk + window)
    Bq, Tq, H, K, hd = 2, 21, 4, 2, 16
    q = rng.standard_normal((Bq, Tq, H, hd)).astype(np.float32)
    k = rng.standard_normal((Bq, Tq, K, hd)).astype(np.float32)
    v = rng.standard_normal((Bq, Tq, K, hd)).astype(np.float32)
    pos = np.arange(Tq, dtype=np.int32)
    kw = dict(causal=causal, window=window, chunk=chunk,
              k_valid_len=k_valid_len)
    want = jl.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(pos), jnp.asarray(pos), **kw)
    got = tl.flash_attention(t(q), t(k), t(v), t(pos).long(), t(pos).long(),
                             **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_flash_attention_bf16():
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 21, h, 16)).astype(np.float32)
               for h in (4, 2, 2))
    pos = np.arange(21, dtype=np.int32)
    want = jl.flash_attention(*(jnp.asarray(a, jnp.bfloat16)
                                for a in (q, k, v)),
                              jnp.asarray(pos), jnp.asarray(pos), window=8,
                              chunk=8)
    got = tl.flash_attention(*(t(a).bfloat16() for a in (q, k, v)),
                             t(pos).long(), t(pos).long(), window=8, chunk=8)
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2,
                               atol=1e-2 * np.abs(want).max())


# ---------------------------------------------------------------------------
# apply / prefill


def run_both(arch, dtype, packed, fn="apply"):
    cfg, jcfg = cfgs(arch, dtype)
    npp = numpy_params(cfg)
    tok = tokens(cfg)
    jparams = jax.tree.map(jnp.asarray, npp)
    params = params_from_numpy(npp, "cpu")
    if packed:
        jplan = jbuild_plan(jparams, SPEC)
        jparams = jplan.pack(jparams, jt.pack_layouts(jcfg))
        plan = build_plan(params, SPEC)
        params = plan.pack(params, transformer.pack_layouts(cfg))
    want = getattr(jt, fn)(jparams, {"tokens": jnp.asarray(tok)}, jcfg)
    with torch.no_grad():
        got = getattr(get_family(cfg.family), fn)(
            params, {"tokens": t(tok)}, cfg)
    return got, np.asarray(want)


def hold(got, want, dtype):
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-2,
                                   atol=1e-2 * np.abs(want).max())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_apply_logits(arch, dtype, packed):
    hold(*run_both(arch, dtype, packed), dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits(arch):
    got, want = run_both(arch, "float32", True, fn="prefill")
    hold(got, want, "float32")


def test_apply_registered_on_the_family():
    fam = get_family("transformer")
    assert fam.apply is transformer.apply
    assert fam.prefill is transformer.prefill


def test_vis_embed_is_prepended():
    """The VLM path: patch embeddings ride in front of the token
    embeddings and get logits of their own."""
    cfg, jcfg = cfgs("paper-100m", "float32")
    npp = numpy_params(cfg)
    tok = tokens(cfg)
    vis = np.random.default_rng(3).standard_normal(
        (B, 5, cfg.d_model)).astype(np.float32)
    want = jt.apply(jax.tree.map(jnp.asarray, npp),
                    {"tokens": jnp.asarray(tok),
                     "vis_embed": jnp.asarray(vis)}, jcfg)
    with torch.no_grad():
        got = transformer.apply(params_from_numpy(npp, "cpu"),
                                {"tokens": t(tok), "vis_embed": t(vis)}, cfg)
    assert tuple(got.shape) == (B, T + 5, cfg.vocab)
    hold(got, np.asarray(want), "float32")


# ---------------------------------------------------------------------------
# gradients


def label_loss_port(params, cfg, tok, labels):
    logits = transformer.apply(params, {"tokens": t(tok)}, cfg)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, t(labels).long()[..., None]).sum()


def port_grads(npp, cfg, tok, labels):
    params = map_with_paths(lambda _, x: x.requires_grad_(True),
                            params_from_numpy(npp, "cpu"))
    loss = label_loss_port(params, cfg, tok, labels)
    leaves = flat_with_paths(params)
    grads = torch.autograd.grad(loss, [x for _, x in leaves])
    return loss, {p: g.numpy() for (p, _), g in zip(leaves, grads)}


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_full_equals_none(arch):
    """Rematerialised layers recompute the same forward in the backward
    pass: logits and every gradient are bitwise those of remat none."""
    cfg, _ = cfgs(arch, "float32")
    npp = numpy_params(cfg)
    tok = tokens(cfg)
    labels = np.random.default_rng(4).integers(0, cfg.vocab, (B, T))
    out = {}
    for remat in ("none", "full"):
        c = cfg.replace(remat=remat)
        with torch.no_grad():
            logits = transformer.apply(params_from_numpy(npp, "cpu"),
                                       {"tokens": t(tok)}, c)
        out[remat] = (logits, *port_grads(npp, c, tok, labels))
    assert torch.equal(out["none"][0], out["full"][0])
    assert torch.equal(out["none"][1], out["full"][1])
    for p, g in out["none"][2].items():
        np.testing.assert_array_equal(out["full"][2][p], g, err_msg=p)


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_of_a_fixed_label_loss_match_jax_grad(arch):
    """f32 gradients of -Σ log p(y|x) for fixed labels y, through the
    port's autograd and through ``jax.grad`` over the reference ``apply``:
    every leaf within 1e-5 relative of its largest gradient. The tied
    embedding sums its lookup's and its unembed's gradients in both."""
    cfg, jcfg = cfgs(arch, "float32")
    npp = numpy_params(cfg)
    tok = tokens(cfg)
    labels = np.random.default_rng(4).integers(0, cfg.vocab, (B, T))

    def jloss(p):
        logits = jt.apply(p, {"tokens": jnp.asarray(tok)}, jcfg)
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.sum(jnp.take_along_axis(
            logp, jnp.asarray(labels)[..., None], axis=-1))
    jval, jgrads = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, npp))
    loss, grads = port_grads(npp, cfg, tok, labels)
    np.testing.assert_allclose(float(loss.detach()), float(jval),
                               rtol=1e-5)
    want = dict(flat_with_paths(jax.tree.map(np.asarray, jgrads)))
    assert set(grads) == set(want)
    for p, g in grads.items():
        scale = np.abs(want[p]).max()
        np.testing.assert_allclose(g, want[p], rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=p)
