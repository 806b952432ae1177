"""The port's example entry points (``examples/*_torch.py``) on the CPU,
held to the reference's own calls on the same numpy inputs: quickstart's
formats and model plan, format_design's scaling table, ν search and
uniform grids (at 2**16 samples on both sides, to keep the test cheap), and
a few-step train → Fisher → allocate → QAT → serve run whose served
bits/param is the reference's on paper-100m small's shapes. Each script
imports only torch, numpy and ``repro_torch``, and runs on the card unless
asked for the CPU."""
import importlib.util
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.core import build_plan as jbuild_plan
from repro.core import distributions as jdist
from repro.core import parse_format as jparse_format
from repro.core.compress import fit_grid_delta as jfit_grid_delta
from repro.core.element import cube_root_absmax as jcube_root_absmax
from repro.core.element import cube_root_rms as jcube_root_rms
from repro.core.element import uniform_grid as juniform_grid
from repro.core.scaling import Scaling as JScaling
from repro.core.search import search_student_t as jsearch_student_t
from repro.core.tensor_format import TensorFormat as JTensorFormat
from repro.models import api as japi

from test_torch_boundary import imported_modules

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (the card run's pins of the numbers below)
SCRIPTS = ("quickstart", "format_design", "train_quantise_serve")
ALLOWED = ("argparse", "numpy", "torch", "repro_torch")


@pytest.fixture(autouse=True)
def one_thread():
    """The examples' tensors are small: one intra-op thread runs them as
    fast alone, and beside other test workers it spares the OpenMP spin
    waits that made them ten times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load(name):
    path = REPO / "examples" / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rel(got, want):
    return abs(got - want) / abs(want)


def abstract_params(jcfg):
    """The reference's parameters of ``jcfg`` as abstract arrays: bits per
    parameter depend on shapes alone."""
    fam = japi.get_family(jcfg.family)
    return jax.tree.map(
        lambda s: jax.ShapeDtypeStruct(s.shape, jnp.dtype(s.dtype)),
        fam.param_specs(jcfg), is_leaf=lambda x: isinstance(x, japi.ParamSpec))


@pytest.mark.parametrize("name", SCRIPTS)
def test_imports_only_torch_numpy_and_the_port(name):
    path = REPO / "examples" / f"{name}_torch.py"
    bad = [(line, mod) for line, mod in imported_modules(path)
           if mod.split(".")[0] not in ALLOWED]
    assert not bad, f"{path}: imports {bad}"


@pytest.mark.parametrize("name", SCRIPTS)
def test_default_device_is_the_card(name):
    """``--device`` left at ``cuda``: without a card the script raises at
    once, before any work; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load(name).main([])


def test_quickstart_against_the_reference():
    got = load("quickstart").main(["--device", "cpu"])
    x = jnp.asarray(np.random.default_rng(0).standard_normal(1 << 16),
                    jnp.float32)
    assert list(got["formats"]) == ["babsmax128:t4", "trms:t4",
                                    "trms:t4:sp0.001", "bsignmax128:t4"]
    pins = chip_smoke.QUICKSTART_REF
    for spec, g in got["formats"].items():
        f = jparse_format(spec)
        bits, r = f.bits_per_param(x.shape), float(f.relative_rms_error(x))
        assert g["bits"] == bits, spec
        assert rel(g["R"], r) <= 1e-5, spec
        assert pins["formats"][spec][0] == bits
        assert rel(pins["formats"][spec][1], r) <= 1e-9, spec
    jcfg = jconfigs.get_config("paper-100m", "smoke")
    params = abstract_params(jcfg)
    plan = jbuild_plan(params, "babsmax128:int4",
                       overrides={"embed": "babsmax128:int8"})
    assert got["model_bits"] == plan.bits_per_param(params) == \
        pins["model_bits"]
    assert got["round_trip"] == 0.0
    want = jcube_root_absmax(jdist.StudentT(nu=7.0), 4, 128).np_codepoints()
    assert np.array_equal(np.asarray(got["codebook"], np.float32),
                          np.asarray(want, np.float32))
    assert got["codebook"] == pins["codebook"]


def test_format_design_against_the_reference(monkeypatch):
    mod = load("format_design")
    monkeypatch.setattr(mod, "SAMPLES", 1 << 16)
    got = mod.main(["--device", "cpu"])
    x = jnp.asarray(jdist.StudentT(nu=5.0).sample(np.random.default_rng(0),
                                                  (1 << 16,)))
    assert list(got["scaling"]) == mod.SCALINGS
    for spec, g in got["scaling"].items():
        f = jparse_format(spec)
        b = f.bits_per_param(x.shape)
        assert g["bits"] == b, spec
        assert rel(g["R"], float(f.relative_rms_error(x))) <= 1e-5, spec
        assert rel(g["R_2b"], float(f.relative_rms_error(x)) * 2**b) <= 1e-5
    s_rms = JScaling(granularity="tensor", statistic="rms",
                     scale_format="exact")
    _, nu, mult, r = jsearch_student_t(
        x, lambda d: JTensorFormat(jcube_root_rms(d, 4), s_rms))
    assert got["nu"]["nu"] == nu and got["nu"]["scale_mult"] == mult
    assert rel(got["nu"]["R"], r) <= 1e-5
    for target in mod.TARGETS:
        delta = jfit_grid_delta(np.asarray(x), target_bits=target)
        g = JTensorFormat(juniform_grid(delta),
                          JScaling(granularity="none", statistic="rms"),
                          compressed=True)
        want_bits = g.measured_bits_per_param(x)
        mine = got["grid"][target]
        assert mine["bits"] == want_bits, target
        assert mine["huffman_bits"] == g.measured_bits_per_param(
            x, practical_huffman=True), target
        assert rel(mine["R"], float(g.relative_rms_error(x))) <= 1e-5, target


def test_train_quantise_serve_few_steps():
    got = load("train_quantise_serve").main(
        ["--device", "cpu", "--steps", "3", "--qat-steps", "2", "--seq",
         "16", "--batch", "2"])
    ref = abstract_params(jconfigs.get_config("paper-100m", "small"))
    want = jbuild_plan(ref, "babsmax128:t4").bits_per_param(ref)
    assert rel(got["bits_served"], want) <= 1e-9
    assert chip_smoke.TQS_REF["bits_served"] == want
    assert abs(got["average_bits"] - 4.0) <= 1e-3
    assert all(2.0 <= b <= 8.0 for b in got["allocation"].values())
    kls = [got[k] for k in ("kl_flat", "kl_allocated", "kl_int3", "kl_qat")]
    assert all(math.isfinite(k) and k >= 0 for k in kls), kls
    assert sorted(got["tokens"]) == [0, 1, 2, 3]
    assert all(len(t) == 8 for t in got["tokens"].values())
    assert all(np.isfinite(got["losses"]))


def test_format_design_pins_are_the_reference_numbers():
    """The card run's pins of format_design at its 2**18 samples: the
    reference's own calls."""
    pins = chip_smoke.FORMAT_DESIGN_REF
    x = jnp.asarray(jdist.StudentT(nu=5.0).sample(np.random.default_rng(0),
                                                  (1 << 18,)))
    for spec, (bits, r, r2b) in pins["scaling"].items():
        f = jparse_format(spec)
        want = float(f.relative_rms_error(x))
        assert bits == f.bits_per_param(x.shape), spec
        assert rel(r, want) <= 1e-9 and rel(r2b, want * 2**bits) <= 1e-9
    s_rms = JScaling(granularity="tensor", statistic="rms",
                     scale_format="exact")
    _, nu, mult, r = jsearch_student_t(
        x, lambda d: JTensorFormat(jcube_root_rms(d, 4), s_rms))
    assert pins["nu"][:2] == (nu, mult) and rel(pins["nu"][2], r) <= 1e-9
    for target, (bits, r, r2b, huff) in pins["grid"].items():
        g = JTensorFormat(juniform_grid(jfit_grid_delta(
            np.asarray(x), target_bits=target)),
            JScaling(granularity="none", statistic="rms"), compressed=True)
        want = float(g.relative_rms_error(x))
        assert bits == g.measured_bits_per_param(x), target
        assert huff == g.measured_bits_per_param(x, practical_huffman=True)
        assert rel(r, want) <= 1e-9 and rel(r2b, want * 2**bits) <= 1e-9
