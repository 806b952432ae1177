"""Port vs reference: the variable-length formats and the format-design
tools — code histograms, entropies, the Huffman codec, the uniform grid and
its delta fit, entropy-coded bit accounting, R, Lloyd-Max codebooks and
plans, scale and Student-t search, and the random-rotation baseline.

The same seeded numpy inputs go through ``repro`` (JAX) and ``repro_torch``.
Integers (histograms, Huffman codes and payload bytes, grid codes, Lloyd
codebooks, deltas, rotation matrices) must be bit-identical; measured bits
within 1e-9 absolute; R, the searches and rotated fake-quant within 1e-5
relative in f32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import compress as jcompress
from repro.core import element as jelement
from repro.core import lloyd as jlloyd
from repro.core import plan as jplan
from repro.core import rotations as jrot
from repro.core import search as jsearch
from repro.core.registry import HEADLINE_FORMATS as JHEADLINE
from repro.core.registry import parse_format as jparse_format
from repro.core.tensor_format import TensorFormat as JTensorFormat

from repro_torch import configs
from repro_torch.core import compress, element, lloyd, rotations, search
from repro_torch.core.plan import (build_plan, fit_lloyd_plan,
                                   flat_with_paths, map_with_paths)
from repro_torch.core.registry import HEADLINE_FORMATS, parse_format
from repro_torch.core.tensor_format import TensorFormat
from repro_torch.interop import params_from_numpy
from repro_torch.models import transformer

REL = dict(rtol=1e-5, atol=0)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def weights(shape, seed, heavy=False):
    """Seeded data: Student-t (heavy tails) or Normal, f32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_t(5, shape) if heavy else rng.standard_normal(shape)
    return (0.02 * x).astype(np.float32)


def numpy_params(cfg, seed=0):
    rng = np.random.default_rng(seed)

    def make(path, spec):
        if "norm" in path:
            return (1 + 0.1 * rng.standard_normal(spec.shape)
                    ).astype(np.float32)
        std = 0.02 if "embed" in path else \
            1 / np.sqrt(spec.numel // spec.shape[-1])
        return (rng.standard_t(6, spec.shape) * std).astype(np.float32)
    return map_with_paths(make, transformer.param_specs(cfg))


# ---------------------------------------------------------------------------
# compress: histograms, entropies, Huffman


@pytest.mark.parametrize("n_codes", [None, 40])
def test_code_histogram_identical(n_codes):
    rng = np.random.default_rng(0)
    codes = rng.integers(-7 if n_codes is None else 0, 33, 5000)
    np.testing.assert_array_equal(
        compress.code_histogram(codes, n_codes),
        jcompress.code_histogram(codes, n_codes))


@pytest.mark.parametrize("smoothing", [0.0, 1.0])
def test_entropies_match(smoothing):
    rng = np.random.default_rng(1)
    hist = np.bincount(rng.geometric(0.3, 4000), minlength=30)
    model = np.bincount(rng.geometric(0.25, 500), minlength=20)
    assert compress.entropy_bits(hist, smoothing) == pytest.approx(
        jcompress.entropy_bits(hist, smoothing), abs=1e-9)
    assert compress.cross_entropy_bits(hist, model, smoothing) == \
        pytest.approx(jcompress.cross_entropy_bits(hist, model, smoothing),
                      abs=1e-9)


def huffman_symbols(seed, n=3000):
    rng = np.random.default_rng(seed)
    return np.minimum(rng.geometric(0.35, n) - 1, 19).astype(np.int64)


@pytest.mark.parametrize("seed,n", [(0, 3000), (1, 3000), (2, 60_000)])
def test_huffman_codes_and_payload_bitwise(seed, n):
    """60k symbols: the port trims its encoder's accumulator as it writes
    (linear time); the bytes stay the reference's."""
    sym = huffman_symbols(seed, n)
    hist = np.bincount(sym)
    hc, jhc = compress.build_huffman(hist), jcompress.build_huffman(hist)
    assert hc.lengths == jhc.lengths and hc.codes == jhc.codes
    payload, n_bits = hc.encode(sym)
    assert (payload, n_bits) == jhc.encode(sym)
    np.testing.assert_array_equal(hc.decode(payload, sym.size), sym)
    assert hc.mean_bits(hist) == pytest.approx(jhc.mean_bits(hist), abs=1e-9)
    assert n_bits == round(hc.mean_bits(hist) * sym.size)
    assert compress.huffman_bits_per_symbol(sym) == \
        jcompress.huffman_bits_per_symbol(sym)


def test_huffman_single_symbol():
    sym = np.full(17, 3)
    hc = compress.build_huffman(np.bincount(sym))
    assert hc.encode(sym) == jcompress.build_huffman(
        np.bincount(sym)).encode(sym)
    np.testing.assert_array_equal(hc.decode(hc.encode(sym)[0], 17), sym)


@pytest.mark.parametrize("table_bits", [4, 11, 20])
def test_huffman_long_codes_bitwise(monkeypatch, table_bits):
    """Fibonacci counts give codes up to 29 bits: those longer than the
    decoder's table are resolved bit by bit; bytes and symbols stay the
    reference's, whatever the table's width."""
    counts = [1, 1]
    while len(counts) < 30:
        counts.append(counts[-1] + counts[-2])
    hist = np.asarray(counts[::-1])
    rng = np.random.default_rng(3)
    sym = np.concatenate([rng.choice(len(hist), 20_000, p=hist / hist.sum()),
                          np.arange(len(hist))])
    rng.shuffle(sym)
    hc, jhc = compress.build_huffman(hist), jcompress.build_huffman(hist)
    assert max(hc.lengths.values()) == 29
    payload, n_bits = hc.encode(sym)
    assert (payload, n_bits) == jhc.encode(sym)
    monkeypatch.setattr(compress, "_TABLE_BITS", table_bits)
    monkeypatch.setattr(compress, "_CHUNK_BITS", 4096)
    np.testing.assert_array_equal(hc.decode(payload, sym.size), sym)
    np.testing.assert_array_equal(jhc.decode(payload, sym.size), sym)


def test_huffman_unknown_symbol_and_empty_stream():
    hc = compress.build_huffman(np.bincount([0, 1, 1, 3]))
    with pytest.raises(KeyError):
        hc.encode(np.asarray([0, 2]))
    with pytest.raises(KeyError):
        hc.encode(np.asarray([4]))
    assert hc.encode(np.zeros(0, np.int64)) == (b"", 0)
    assert hc.decode(b"", 0).shape == (0,)


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 10_000), p=st.floats(0.05, 0.9))
def test_huffman_round_trip_any_stream(seed, p):
    rng = np.random.default_rng(seed)
    sym = rng.geometric(p, 400) - 1
    hc = compress.build_huffman(np.bincount(sym))
    payload, n_bits = hc.encode(sym)
    assert len(payload) == (n_bits + 7) // 8
    np.testing.assert_array_equal(hc.decode(payload, sym.size), sym)


@pytest.mark.parametrize("bits", [2.0, 3.5, 4.0])
def test_fit_grid_delta_identical(bits):
    x = weights(20_000, 3, heavy=True)
    d = compress.fit_grid_delta(x, bits)
    assert d == jcompress.fit_grid_delta(x, bits)
    codes = np.round(x / d).astype(np.int64)
    h = compress.entropy_bits(np.bincount(codes - codes.min()), 1.0)
    assert abs(h - bits) < 0.01


# ---------------------------------------------------------------------------
# the uniform grid and entropy-coded accounting


def test_uniform_grid_codes_bitwise():
    delta = 0.013
    x = weights(4096, 4).reshape(64, 64)
    x[0, :8] = np.float32(delta) * np.asarray(
        [0.5, 1.5, 2.5, -0.5, -1.5, 3.5, 0, 1e9], np.float32)   # ties, clip
    g, jg = element.uniform_grid(delta, 300), jelement.uniform_grid(delta,
                                                                    300)
    codes = g.quantise(t(x))
    assert codes.dtype == torch.int32
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(jg.quantise(jnp.asarray(x))))
    np.testing.assert_array_equal(g.fake_quant(t(x)).numpy(),
                                  np.asarray(jg.fake_quant(jnp.asarray(x))))
    assert g.bits == jg.bits


def test_headline_and_grid_formats_parse_like_the_reference():
    assert HEADLINE_FORMATS == JHEADLINE
    for spec in HEADLINE_FORMATS + ("trms:grid", "trms:grid:C",
                                    "babsmax64:t4:C", "trms:n4:sp0.01:C"):
        f, jf = parse_format(spec), jparse_format(spec)
        assert f.describe() == jf.describe() and f.compressed == jf.compressed
        if isinstance(jf.element, jelement.UniformGrid):
            assert f.element == element.UniformGrid(jf.element.delta,
                                                    jf.element.max_code)
        else:
            assert f.element.codepoints == jf.element.codepoints


def test_element_bits_refuses_a_grid():
    with pytest.raises(ValueError, match="data-dependent"):
        parse_format("trms:grid:C").element_bits()
    with pytest.raises(ValueError, match="data-dependent"):
        jparse_format("trms:grid:C").element_bits()


def grid_formats(x, bits=4.0):
    """A compressed trms grid format at a delta fitted to the normalised
    data, in both packages."""
    f = parse_format("trms:grid:C")
    xb, _, unblock = f.scaling.normalise(t(x))
    delta = compress.fit_grid_delta(unblock(xb).numpy(), bits)
    jf = jparse_format("trms:grid:C")
    return (dataclasses.replace(f, element=element.uniform_grid(delta)),
            dataclasses.replace(jf, element=jelement.uniform_grid(delta)))


def measured_cases():
    x = weights((96, 128), 5, heavy=True)
    cases = [(parse_format(s), jparse_format(s))
             for s in ("trms:t4:C", "babsmax64:t4:C", "babsmax64:t4",
                       "trms:n3:sp0.01:C")]
    return x, cases + [grid_formats(x)]


@pytest.mark.parametrize("case", range(5))
@pytest.mark.parametrize("how", ["entropy", "huffman", "model"])
def test_measured_bits_per_param_match(case, how):
    x, cases = measured_cases()
    f, jf = cases[case]
    model = np.bincount(np.random.default_rng(6).integers(0, 12, 300))
    kw = {"entropy": {}, "huffman": dict(practical_huffman=True),
          "model": dict(model_hist=model)}[how]
    got = f.measured_bits_per_param(t(x), **kw)
    want = jf.measured_bits_per_param(jnp.asarray(x), **kw)
    assert got == pytest.approx(want, abs=1e-9)
    if not f.compressed:
        assert got == pytest.approx(f.bits_per_param(x.shape), abs=1e-12)


def test_compressed_t4_costs_less_than_fixed_length():
    x = weights((256, 256), 7)
    c = parse_format("trms:t4:C").measured_bits_per_param(t(x))
    assert c < parse_format("trms:t4").bits_per_param(x.shape)


@pytest.mark.parametrize("spec", ["babsmax64:n4", "trms:t3", "cabsmax:int4"])
@pytest.mark.parametrize("weighted", [False, True])
def test_relative_rms_error_matches(spec, weighted):
    x = weights((64, 256), 8, heavy=True)
    w = np.random.default_rng(9).random(x.shape).astype(np.float32)
    r = parse_format(spec).relative_rms_error(t(x), t(w) if weighted
                                              else None)
    jr = jparse_format(spec).relative_rms_error(
        jnp.asarray(x), jnp.asarray(w) if weighted else None)
    np.testing.assert_allclose(float(r), float(jr), **REL)


# ---------------------------------------------------------------------------
# Lloyd-Max


@pytest.mark.parametrize("init", ["kmeans++", "uniform"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("max_samples", [1 << 20, 3000])
def test_lloyd_max_codebooks_bitwise(init, weighted, max_samples):
    x = weights(8000, 10, heavy=True) * 40
    if init == "uniform":
        x = np.clip(x, -1, 1)
    w = np.random.default_rng(11).random(8000) if weighted else None
    got = lloyd.lloyd_max(x, 4, weights=w, init=init, seed=3,
                          max_samples=max_samples)
    want = jlloyd.lloyd_max(x, 4, weights=w, init=init, seed=3,
                            max_samples=max_samples)
    assert got.codepoints == want.codepoints and got.name == want.name
    assert isinstance(got, element.ElementFormat)


def test_lloyd_max_refuses_an_unknown_init():
    with pytest.raises(ValueError, match="unknown init"):
        lloyd.lloyd_max(np.zeros(10), 2, init="random")


@pytest.mark.parametrize("scaling", ["trms", "babsmax64"])
@pytest.mark.parametrize("with_fisher", [False, True])
def test_fit_lloyd_plan_codebooks_bitwise(scaling, with_fisher):
    cfg = configs.get_config("paper-100m", "smoke")
    npp = numpy_params(cfg)
    rng = np.random.default_rng(12)
    fisher = (map_with_paths(lambda _, a: rng.random(a.shape), npp)
              if with_fisher else None)
    plan = fit_lloyd_plan(params_from_numpy(npp, "cpu"), 3, scaling, fisher)
    jp = jplan.fit_lloyd_plan(jax.tree.map(jnp.asarray, npp), 3, scaling,
                              fisher)
    assert plan.formats.keys() == jp.formats.keys()
    fitted = 0
    for name, f in plan.formats.items():
        jf = jp.formats[name]
        assert (f is None) == (jf is None), name
        if f is not None:
            assert f.element.codepoints == jf.element.codepoints, name
            assert f.describe() == jf.describe()
            fitted += 1
    assert fitted >= 8


# ---------------------------------------------------------------------------
# plan accounting and the QAT surface


def test_plan_measured_bits_and_unpack_match():
    cfg = configs.get_config("paper-100m", "smoke")
    npp = numpy_params(cfg, seed=2)
    params = params_from_numpy(npp, "cpu")
    jparams = jax.tree.map(jnp.asarray, npp)
    for spec in ("trms:t4:C", "babsmax64:n4"):
        plan = build_plan(params, spec)
        jp = jplan.build_plan(jparams, spec)
        for measured in (False, True):
            assert plan.bits_per_param(params, measured=measured) == \
                pytest.approx(jp.bits_per_param(jparams, measured=measured),
                              abs=1e-9)
        assert plan.lookup("['layers']['wq']").describe() == spec
    plan = build_plan(params, "babsmax64:n4")
    dense = plan.unpack(plan.pack(params, transformer.pack_layouts(cfg)))
    want = plan.dequantise(plan.quantise(params))
    for (name, a), (_, b) in zip(flat_with_paths(dense),
                                 flat_with_paths(want)):
        assert torch.equal(a, b), name


def test_fake_quant_ste_forward_and_gradient():
    x = weights((32, 128), 13)
    f, jf = parse_format("babsmax64:int2"), jparse_format("babsmax64:int2")
    xt = t(x).requires_grad_(True)
    y = f.fake_quant_ste(xt)
    np.testing.assert_array_equal(
        y.detach().numpy(), np.asarray(jf.fake_quant_ste(jnp.asarray(x))))
    (y * t(x)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), x)   # identity backward


# ---------------------------------------------------------------------------
# scale / Student-t search


@pytest.mark.parametrize("weighted", [False, True])
def test_search_scale_matches(weighted):
    x = weights((64, 256), 14, heavy=True)
    w = np.random.default_rng(15).random(x.shape).astype(np.float32)
    f, m, r = search.search_scale(t(x), parse_format("trms:t3"),
                                  t(w) if weighted else None)
    jf, jm, jr = jsearch.search_scale(jnp.asarray(x), jparse_format("trms:t3"),
                                      jnp.asarray(w) if weighted else None)
    np.testing.assert_allclose(r, jr, **REL)
    if m != jm:     # only an R tie may pick another multiplier
        rm = float(search.with_scale_mult(parse_format("trms:t3"),
                                          jm).relative_rms_error(t(x)))
        assert abs(rm - r) <= 1e-6 * r
    else:
        assert f.element.codepoints == jf.element.codepoints
    assert search.SCALE_RANGE == jsearch.SCALE_RANGE
    assert search.NU_RANGE == jsearch.NU_RANGE


def test_search_student_t_matches():
    from repro.core import element as jel
    from repro.core.scaling import Scaling as JScaling
    from repro_torch.core.scaling import Scaling
    x = weights((32, 128), 16, heavy=True)
    nus, mults = search.NU_RANGE[::4], search.SCALE_RANGE[4:13:2]

    def build(d):
        return TensorFormat(element.cube_root_rms(d, 3),
                            Scaling("tensor", "rms"))

    def jbuild(d):
        return JTensorFormat(jel.cube_root_rms(d, 3), JScaling("tensor", "rms"))
    f, nu, m, r = search.search_student_t(t(x), build, nus=nus, mults=mults)
    jf, jnu, jm, jr = jsearch.search_student_t(jnp.asarray(x), jbuild,
                                               nus=nus, mults=mults)
    np.testing.assert_allclose(r, jr, **REL)
    assert (nu, m) == (jnu, jm)


# ---------------------------------------------------------------------------
# rotations


@pytest.mark.parametrize("dim,seed", [(16, 0), (48, 3)])
def test_rotation_matrices_bitwise(dim, seed):
    np.testing.assert_array_equal(rotations._np_rotation(dim, seed),
                                  jrot._np_rotation(dim, seed))
    assert rotations.rotation(9000, 1) is None      # 9000 % 1024 != 0
    assert jrot.rotation(9000, 1) is None


@pytest.mark.parametrize("axis", [0, 1])
def test_apply_rotation_block_diagonal_matches(axis):
    """Axis 1 (48 = 3 blocks of 16) takes the block-diagonal path, axis 0
    the dense one."""
    x = weights((32, 48), 17)
    r = jrot._np_rotation(16 if axis == 1 else 32, 2)
    got = rotations.apply_rotation(t(x), r, axis)
    want = jrot.apply_rotation(jnp.asarray(x), r, axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * np.abs(x).max())


@pytest.mark.parametrize("shape", [(64, 96), (16, 9216), (4, 8, 16)])
def test_rotated_fake_quant_matches(shape):
    """Dense rotations on both dims; a 9216 dim takes the block-diagonal
    1024-block rotation; a 3-D tensor is fake-quantised unrotated."""
    x = weights(shape, 18, heavy=True)
    f, jf = parse_format("babsmax64:n4"), jparse_format("babsmax64:n4")
    got = rotations.rotated_fake_quant(t(x), f, seed=5)
    want = np.asarray(jrot.rotated_fake_quant(jnp.asarray(x), jf, seed=5))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * scale)
