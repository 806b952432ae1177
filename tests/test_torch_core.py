"""Port vs reference: nibble packing, format construction, quantisation,
packing and integrity checks, configs and layouts — bit for bit.

The same numpy inputs (from ``np.random.default_rng``) go through the JAX
package and ``repro_torch``; reference weights are carried into the port
with ``repro_torch.interop``."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from hypothesis import given, settings, strategies as st

from repro import configs as jconfigs
from repro.core import build_plan as jbuild_plan
from repro.core import nibble as jnibble
from repro.core.registry import parse_format as jparse_format
from repro.core.tensor_format import IntegrityError as JIntegrityError
from repro.core.tensor_format import PackedTensor as JPacked
from repro.models import transformer as jtransformer

from repro_torch import configs
from repro_torch.core import build_plan, nibble
from repro_torch.core.plan import map_with_paths
from repro_torch.core.registry import parse_format
from repro_torch.core.tensor_format import IntegrityError, PackedTensor
from repro_torch.interop import params_from_numpy, tensor_from_numpy
from repro_torch.models import transformer

SPECS = ["babsmax64:n4", "babsmax32:n4", "babsmax32:n5", "babsmax128:t4",
         "babsmax128:int8", "trms:n4"]


def jax_to_numpy(tree):
    """Reference params → nested dicts of numpy arrays, a PackedTensor as
    the dict of its fields (the interop input)."""
    def conv(x):
        if isinstance(x, JPacked):
            return {"codes": np.asarray(x.codes),
                    "scales": np.asarray(x.scales),
                    "codepoints": x.codepoints, "out_shape": x.out_shape,
                    "shape": x.shape, "dtype": x.dtype, "block": x.block,
                    "bits": x.bits}
        return np.asarray(x)
    return jax.tree.map(conv, tree, is_leaf=lambda x: isinstance(x, JPacked))


def numpy_params(cfg, seed=0):
    """Seeded numpy weights of a transformer config (norm gains around 1,
    fan-in scaled matrices): the one input both packages are fed."""
    rng = np.random.default_rng(seed)

    def make(path, spec):
        if "norm" in path:
            return (1 + 0.1 * rng.standard_normal(spec.shape)
                    ).astype(np.float32)
        std = 0.02 if "embed" in path else \
            1 / np.sqrt(spec.numel // spec.shape[-1])
        return (rng.standard_normal(spec.shape) * std).astype(np.float32)
    return map_with_paths(make, transformer.param_specs(cfg))


def bits16(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


# ---------------------------------------------------------------------------
# Nibble packing


class TestNibble:
    @pytest.mark.parametrize("K", [2, 64, 256, 704, 768, 2048])
    @pytest.mark.parametrize("lead", [(), (3,)])
    def test_pack_unpack_match_reference(self, K, lead):
        rng = np.random.default_rng(K)
        codes = rng.integers(0, 16, lead + (K, 24)).astype(np.uint8)
        assert nibble.nibble_k_tile(K) == jnibble.nibble_k_tile(K)
        packed = nibble.pack_nibbles(torch.from_numpy(codes))
        jpacked = np.asarray(jnibble.pack_nibbles(jnp.asarray(codes)))
        np.testing.assert_array_equal(packed.numpy(), jpacked)
        un = nibble.unpack_nibbles(packed, K)
        np.testing.assert_array_equal(un.numpy(), codes)
        np.testing.assert_array_equal(
            un.numpy(), np.asarray(jnibble.unpack_nibbles(jnp.asarray(jpacked),
                                                         K)))

    @pytest.mark.parametrize("K", [2, 64, 256, 704, 768, 2048])
    def test_row_coords_match_reference(self, K):
        rows = np.arange(K, dtype=np.int64)
        r, n = nibble.nibble_row_coords(torch.from_numpy(rows), K)
        jr, jn = jnibble.nibble_row_coords(rows, K)
        np.testing.assert_array_equal(r.numpy(), jr)
        np.testing.assert_array_equal(n.numpy(), jn)

    @settings(deadline=None, max_examples=25)
    @given(st.integers(1, 300), st.integers(1, 9))
    def test_round_trip_any_even_k(self, half_k, n):
        K = 2 * half_k
        codes = np.random.default_rng(K * 31 + n).integers(
            0, 16, (K, n)).astype(np.uint8)
        packed = nibble.pack_nibbles(torch.from_numpy(codes))
        assert packed.shape == (K // 2, n)
        np.testing.assert_array_equal(
            nibble.unpack_nibbles(packed, K).numpy(), codes)


# ---------------------------------------------------------------------------
# Formats and quantisation


class TestFormats:
    @pytest.mark.parametrize("spec", SPECS)
    def test_codepoints_equal_reference(self, spec):
        assert parse_format(spec).element.codepoints == \
            jparse_format(spec).element.codepoints

    @pytest.mark.parametrize("spec", SPECS)
    @pytest.mark.parametrize("shape", [(50, 70), (3, 128, 40)])
    def test_quantise_bit_identical(self, spec, shape):
        rng = np.random.default_rng(len(spec) * 7 + shape[0])
        x = (rng.standard_normal(shape) * 0.05).astype(np.float32)
        qt = parse_format(spec).quantise(torch.from_numpy(x))
        jq = jparse_format(spec).quantise(jnp.asarray(x))
        np.testing.assert_array_equal(qt.codes.numpy(), np.asarray(jq.codes))
        assert qt.scales.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            bits16(qt.scales),
            bits16(tensor_from_numpy(np.asarray(jq.scales), "cpu")))
        assert qt.shape == tuple(jq.shape) and qt.dtype == jq.dtype

    @pytest.mark.parametrize("spec", ["babsmax64:n4", "babsmax128:int8"])
    def test_dequantise_and_fake_quant_match(self, spec):
        x = (np.random.default_rng(3).standard_normal((48, 80)) * 0.1
             ).astype(np.float32)
        f, jf = parse_format(spec), jparse_format(spec)
        dq = f.dequantise(f.quantise(torch.from_numpy(x)))
        np.testing.assert_array_equal(
            dq.numpy(), np.asarray(jf.dequantise(jf.quantise(jnp.asarray(x)))))
        np.testing.assert_array_equal(
            f.fake_quant(torch.from_numpy(x)).numpy(),
            np.asarray(jf.fake_quant(jnp.asarray(x))))
        assert f.bits_per_param(x.shape) == jf.bits_per_param(x.shape)

    @pytest.mark.parametrize("spec", ["babsmax64:n4", "trms:n4"])
    def test_fake_quant_jit_matches_the_reference(self, spec):
        """The reference's jitted convenience wrapper and the port's plain
        one give the same values."""
        from repro.core.tensor_format import fake_quant_jit as jfqj
        from repro_torch.core.tensor_format import fake_quant_jit
        x = (np.random.default_rng(5).standard_normal((32, 128)) * 0.1
             ).astype(np.float32)
        got = fake_quant_jit(parse_format(spec), torch.from_numpy(x))
        want = jfqj(jparse_format(spec), jnp.asarray(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_bf16_round_away_is_bitwise(self):
        from repro.core.scaling import _bf16_round_away as jround
        from repro_torch.core.scaling import _bf16_round_away
        x = np.abs(np.random.default_rng(9).standard_normal(4096)
                   ).astype(np.float32) * 3 + 1e-6
        np.testing.assert_array_equal(
            _bf16_round_away(torch.from_numpy(x)).numpy(),
            np.asarray(jround(jnp.asarray(x))))


# ---------------------------------------------------------------------------
# Whole-model packing


PACK_CASES = [("paper-100m", "smoke"), ("paper-100m", "small"),
              ("deepseek-7b", "smoke")]


@pytest.fixture(scope="module")
def packed_pairs():
    """(reference packed tree, port packed tree) per config, from the same
    reference weights under babsmax64:n4."""
    out = {}
    for arch, variant in PACK_CASES:
        cfg = jconfigs.get_config(arch, variant)
        tcfg = configs.get_config(arch, variant)
        np_params = numpy_params(tcfg)
        jparams = jax.tree.map(jnp.asarray, np_params)
        jplan = jbuild_plan(jparams, "babsmax64:n4")
        jpacked = jplan.pack(jparams, jtransformer.pack_layouts(cfg))
        params = params_from_numpy(np_params, "cpu")
        plan = build_plan(params, "babsmax64:n4")
        packed = plan.pack(params, transformer.pack_layouts(tcfg))
        out[(arch, variant)] = (jax_to_numpy(jpacked), packed, plan, jplan)
    return out


@pytest.mark.parametrize("arch,variant", PACK_CASES)
class TestPacking:
    def test_same_plan(self, packed_pairs, arch, variant):
        _, _, plan, jplan = packed_pairs[(arch, variant)]
        assert plan.formats.keys() == jplan.formats.keys()
        for k, f in plan.formats.items():
            jf = jplan.formats[k]
            assert (f is None) == (jf is None), k
            if f is not None:
                assert f.element.codepoints == jf.element.codepoints
                assert dataclasses.asdict(f.scaling) == \
                    dataclasses.asdict(jf.scaling)

    def test_packed_leaves_bit_identical(self, packed_pairs, arch, variant):
        jtree, tree, _, _ = packed_pairs[(arch, variant)]
        jflat = dict(_flat(jtree))
        flat = dict(_flat(tree))
        assert flat.keys() == jflat.keys()
        n_packed = 0
        for k, leaf in flat.items():
            ref = jflat[k]
            if isinstance(leaf, PackedTensor):
                n_packed += 1
                assert isinstance(ref, dict), k
                np.testing.assert_array_equal(leaf.codes.numpy(), ref["codes"])
                np.testing.assert_array_equal(
                    bits16(leaf.scales),
                    bits16(tensor_from_numpy(ref["scales"], "cpu")))
                for f in ("codepoints", "out_shape", "shape", "dtype",
                          "block", "bits"):
                    assert getattr(leaf, f) == ref[f], (k, f)
            else:
                assert not isinstance(ref, dict), k
                np.testing.assert_array_equal(leaf.numpy(), ref)
        # every declared layout packs, except deepseek smoke's w_gate/w_up
        assert n_packed == (7 if arch == "deepseek-7b" else 9)

    def test_norm_stacks_are_quantised_then_dequantised(self, packed_pairs,
                                                        arch, variant):
        """The (L, D) norm gains have >= 4096 elements, so the plan
        quantises them and packing dequantises them — not ones any more."""
        jtree, tree, plan, _ = packed_pairs[(arch, variant)]
        cfg = configs.get_config(arch, variant)
        quantised = cfg.n_layers * cfg.d_model >= 4096
        assert (plan.formats["['layers']['attn_norm']"] is not None) \
            == quantised
        raw = numpy_params(cfg)["layers"]["attn_norm"]
        got = tree["layers"]["attn_norm"].numpy()
        np.testing.assert_array_equal(got, jtree["layers"]["attn_norm"])
        assert (not np.array_equal(got, raw)) == quantised


def _flat(tree, prefix=""):
    if isinstance(tree, dict) and "codepoints" not in tree:
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}[{k!r}]")
    else:
        yield prefix, tree


@pytest.mark.parametrize("spec,bits", [("babsmax64:n4", 4),
                                       ("babsmax64:int8", 8)])
def test_nbytes_packed_matches_the_reference(spec, bits):
    """``PackedTensor.nbytes_packed`` of a paper-100m smoke leaf packed at 4
    (nibbles) and 8 bits equals the reference's."""
    cfg = jconfigs.get_config("paper-100m", "smoke")
    np_params = numpy_params(configs.get_config("paper-100m", "smoke"))
    jparams = jax.tree.map(jnp.asarray, np_params)
    jtree = jbuild_plan(jparams, spec).pack(jparams,
                                            jtransformer.pack_layouts(cfg))
    params = params_from_numpy(np_params, "cpu")
    tree = build_plan(params, spec).pack(
        params, transformer.pack_layouts(configs.get_config("paper-100m",
                                                            "smoke")))
    got, want = tree["layers"]["wq"], jtree["layers"]["wq"]
    assert isinstance(got, PackedTensor) and got.bits == bits == want.bits
    assert got.nbytes_packed == want.nbytes_packed > 0


def test_nbytes_packed_counts_sparse_outliers_as_the_reference():
    """``QuantisedTensor.nbytes_packed`` with sparse outliers (indices and
    values) equals the reference's, and exceeds the same leaf's without."""
    x = (np.random.default_rng(11).standard_normal((64, 96)) * 0.1
         ).astype(np.float32)
    for spec in ("trms:n4:sp0.01", "trms:n4"):
        got = parse_format(spec).quantise(torch.from_numpy(x))
        want = jparse_format(spec).quantise(jnp.asarray(x))
        assert (got.sparse_idx is not None) == spec.endswith("sp0.01")
        assert got.nbytes_packed == want.nbytes_packed
    assert parse_format("trms:n4:sp0.01").quantise(
        torch.from_numpy(x)).nbytes_packed > got.nbytes_packed


def test_deepseek_smoke_mlp_stays_dense(packed_pairs):
    """d_ff=160 does not tile by the 64 block: w_gate/w_up dequantise."""
    _, tree, _, _ = packed_pairs[("deepseek-7b", "smoke")]
    assert not isinstance(tree["layers"]["w_gate"], PackedTensor)
    assert not isinstance(tree["layers"]["w_up"], PackedTensor)
    assert isinstance(tree["layers"]["w_down"], PackedTensor)


# ---------------------------------------------------------------------------
# Integrity errors


def _corrupt(kind, p):
    """Apply one corruption to a packed-field dict (numpy)."""
    p = dict(p)
    if kind == "nan_scale":
        s = np.array(p["scales"], copy=True)
        s.reshape(-1)[5] = np.nan
        p["scales"] = s
    elif kind == "code_out_of_range":
        c = np.array(p["codes"], copy=True)
        c.reshape(-1)[7] = 0xFF if p["bits"] == 8 else 0xF0 | c.reshape(-1)[7]
        p["codes"] = c
        p["codepoints"] = p["codepoints"][:12]
    elif kind == "bad_scales_shape":
        p["scales"] = np.array(p["scales"])[..., :-1]
    return p


@pytest.mark.parametrize("kind", ["nan_scale", "code_out_of_range",
                                  "bad_scales_shape"])
def test_integrity_errors_match_reference(packed_pairs, kind):
    jtree, _, _, _ = packed_pairs[("paper-100m", "smoke")]
    fields = _corrupt(kind, jtree["layers"]["wq"])
    name = "['layers']['wq']"
    jbad = JPacked(codes=jnp.asarray(fields["codes"]),
                   scales=jnp.asarray(fields["scales"]),
                   codepoints=tuple(fields["codepoints"]),
                   out_shape=fields["out_shape"], shape=fields["shape"],
                   dtype=fields["dtype"], block=fields["block"],
                   bits=fields["bits"])
    with pytest.raises(JIntegrityError) as jexc:
        jbad.verify(name)
    bad = params_from_numpy(fields, "cpu")
    with pytest.raises(IntegrityError) as exc:
        bad.verify(name)
    assert str(exc.value) == str(jexc.value)


# ---------------------------------------------------------------------------
# Configs, specs, layouts


VARIANTS = [("paper-100m", v) for v in ("full", "small", "smoke")] + \
    [("deepseek-7b", v) for v in ("full", "smoke")]


@pytest.mark.parametrize("arch,variant", VARIANTS)
def test_configs_equal_field_by_field(arch, variant):
    cfg = configs.get_config(arch, variant)
    jcfg = jconfigs.get_config(arch, variant)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    np.testing.assert_array_equal(cfg.window_pattern(),
                                  jcfg.window_pattern())


@pytest.mark.parametrize("arch,variant", VARIANTS)
def test_param_specs_and_layouts_match(arch, variant):
    cfg = configs.get_config(arch, variant)
    jcfg = jconfigs.get_config(arch, variant)
    specs = dict(_flat(transformer.param_specs(cfg)))
    jspecs = dict(_flat(jax.tree.map(
        lambda s: s, jtransformer.param_specs(jcfg),
        is_leaf=lambda x: hasattr(x, "axes"))))
    assert specs.keys() == jspecs.keys()
    for k, s in specs.items():
        js = jspecs[k]
        assert (s.shape, s.axes, s.dtype) == (js.shape, js.axes, js.dtype), k
    assert transformer.pack_layouts(cfg) == jtransformer.pack_layouts(jcfg)
