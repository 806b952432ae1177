"""The port's configs against the reference's: all eleven architectures,
``ASSIGNED``, a ported family for each, and llama3-405b at smoke size
through the transformer family (GQA 8 over 2 KV heads of 8). Its full size
(126 layers, d 16384, about 215 GB packed at 4.25 bits) is held to the
reference's specs only: one card does not hold it."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import transformer as jt
from repro.serve.engine import greedy_generate as jgreedy

from repro_torch import configs
from repro_torch.core.plan import flat_with_paths, map_with_paths
from repro_torch.interop import params_from_numpy
from repro_torch.models import transformer
from repro_torch.models.api import get_family
from repro_torch.serve.engine import greedy_generate

FIELDS = [f.name for f in dataclasses.fields(configs.get_config(
    "paper-100m", "smoke"))]


def test_every_reference_config_is_ported():
    assert list(configs.ARCHS) == list(jconfigs.ARCHS)
    assert configs.ASSIGNED == jconfigs.ASSIGNED
    assert len(configs.ARCHS) == 11


@pytest.mark.parametrize("arch", list(jconfigs.ARCHS))
def test_config_fields_and_family(arch):
    """Every field of ``full()`` and ``smoke()`` (and paper-100m's
    ``small()``), and a registered family of the port for each."""
    variants = ("full", "smoke") + (("small",) if arch == "paper-100m"
                                    else ())
    for variant in variants:
        got = configs.get_config(arch, variant)
        want = jconfigs.get_config(arch, variant)
        assert [getattr(got, f) for f in FIELDS] == \
            [getattr(want, f) for f in FIELDS], (arch, variant)
        assert get_family(got.family).name == got.family


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("llama3-8b")


def test_llama3_405b_full_specs_equal():
    """The full config's parameter specs and pack layouts, and its size:
    405.9 B parameters, about 216 GB at 4.25 bits."""
    cfg = configs.get_config("llama3-405b", "full")
    jcfg = jconfigs.get_config("llama3-405b", "full")
    got = {n: (tuple(s.shape), s.axes) for n, s in
           flat_with_paths(transformer.param_specs(cfg))}
    want = {n: (tuple(s.shape), s.axes) for n, s in
            flat_with_paths(jt.param_specs(jcfg))}
    assert got == want
    assert transformer.pack_layouts(cfg) == jt.pack_layouts(jcfg)
    n = sum(int(np.prod(s[0])) for s in got.values())
    assert n == 405_853_388_800
    assert 200e9 < n * 4.25 / 8 < 220e9


def numpy_params(cfg, seed=0):
    rng = np.random.default_rng(seed)

    def make(path, spec):
        if "norm" in path:
            return (1 + 0.1 * rng.standard_normal(spec.shape)
                    ).astype(np.float32)
        std = 0.5 if "embed" in path else \
            1 / np.sqrt(spec.numel // spec.shape[-1])
        return (rng.standard_normal(spec.shape) * std).astype(np.float32)
    return map_with_paths(make, transformer.param_specs(cfg))


def test_llama3_405b_smoke_apply_and_greedy_tokens():
    """llama3-405b smoke (3 layers, d 64, 8 heads over 2 KV heads of 8):
    f32 logits within 1e-5 relative, and greedy tokens equal."""
    cfg = configs.get_config("llama3-405b", "smoke").replace(dtype="float32")
    jcfg = jconfigs.get_config("llama3-405b", "smoke").replace(
        dtype="float32")
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.hd) == (8, 2, 8)
    npp = numpy_params(cfg)
    params = params_from_numpy(npp, "cpu")
    jparams = jax.tree.map(jnp.asarray, npp)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 12)).astype(
        np.int32)
    with torch.inference_mode():
        logits = transformer.apply(params, {"tokens": torch.from_numpy(toks)},
                                   cfg)
    want = np.asarray(jt.apply(jparams, {"tokens": jnp.asarray(toks)}, jcfg))
    np.testing.assert_allclose(logits.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    prompt = toks[:, :5]
    got = greedy_generate(cfg, params, prompt, 6, kv_len=32, device="cpu")
    np.testing.assert_array_equal(
        got, np.asarray(jgreedy(jcfg, jparams, prompt, 6, kv_len=32)))
