"""Port vs reference for the decode path's layers and cache geometry: the
same numpy inputs through ``repro.models.layers`` / ``repro.serve.cache``
and their ``repro_torch`` counterparts, in f32 (tolerances for summation
order only), integers exactly."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.nibble import pack_nibbles as jpack
from repro.core.tensor_format import PackedTensor as JPacked
from repro.models import api as japi
from repro.models import layers as jl
from repro.serve import cache as jcache

from repro_torch.core.nibble import pack_nibbles
from repro_torch.core.tensor_format import PackedTensor
from repro_torch.models import api
from repro_torch.models import layers as tl
from repro_torch.serve import cache as tcache

F32 = dict(rtol=1e-5, atol=1e-6)


def rng(seed):
    return np.random.default_rng(seed)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_rms_norm():
    x = rng(0).standard_normal((2, 3, 64)).astype(np.float32)
    g = (1 + 0.1 * rng(1).standard_normal(64)).astype(np.float32)
    np.testing.assert_allclose(tl.rms_norm(t(x), t(g), 1e-5).numpy(),
                               np.asarray(jl.rms_norm(jnp.asarray(x),
                                                      jnp.asarray(g))), **F32)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope(theta):
    x = rng(2).standard_normal((2, 5, 3, 32)).astype(np.float32)
    pos = rng(3).integers(0, 300, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        tl.rope(t(x), t(pos), theta).numpy(),
        np.asarray(jl.rope(jnp.asarray(x), jnp.asarray(pos), theta)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window,ring", [(0, False), (5, False), (6, True)])
def test_chunked_decode_attention(window, ring):
    B, T, H, K, hd, S = 3, 4, 4, 2, 16, 12
    q = rng(4).standard_normal((B, T, H, hd)).astype(np.float32)
    kc = rng(5).standard_normal((B, S, K, hd)).astype(np.float32)
    vc = rng(6).standard_normal((B, S, K, hd)).astype(np.float32)
    start = np.array([0, 3, 9 if ring else 8], np.int32)
    qpos = (start[:, None] + np.arange(T)).astype(np.int32)
    got = tl.chunked_decode_attention(t(q), t(kc), t(vc), t(qpos),
                                      window=window, ring=ring)
    want = jl.chunked_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(qpos),
        window=window, ring=ring)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("ring", [False, True])
def test_update_kv_cache_in_place(ring):
    """Linear writes clamp the start to S - T like dynamic_update_slice;
    ring writes wrap at S. The port writes into the cache it is given."""
    B, S, K, hd, T = 3, 10, 2, 4, 4
    cache = rng(7).standard_normal((B, S, K, hd)).astype(np.float32)
    new = rng(8).standard_normal((B, T, K, hd)).astype(np.float32)
    pos = np.array([0, 5, 8], np.int32)          # row 2 overruns S
    want = np.asarray(jl.update_kv_cache(jnp.asarray(cache),
                                         jnp.asarray(new), jnp.asarray(pos),
                                         ring=ring))
    got = t(cache.copy())
    out = tl.update_kv_cache(got, t(new), t(pos), ring=ring)
    assert out is got
    np.testing.assert_array_equal(got.numpy(), want)


def _packed_pair(K, N, block=64, seed=9):
    r = rng(seed)
    codes = r.integers(0, 16, (K, N)).astype(np.uint8)
    scales = (np.abs(r.standard_normal((K, N // block))) * 0.05 + 0.01
              ).astype(np.float32)
    cps = tuple(float(c) for c in np.sort(r.standard_normal(16)))
    jp = JPacked(codes=jpack(jnp.asarray(codes)),
                 scales=jnp.asarray(scales, jnp.bfloat16), codepoints=cps,
                 out_shape=(N,), shape=(K, N), block=block, bits=4)
    tp = PackedTensor(codes=pack_nibbles(t(codes)),
                      scales=t(scales).to(torch.bfloat16), codepoints=cps,
                      out_shape=(N,), shape=(K, N), block=block, bits=4)
    return jp, tp


def test_linear_packed_and_dense():
    jp, tp = _packed_pair(128, 256)
    x = rng(10).standard_normal((2, 3, 128)).astype(np.float32)
    got = tl.linear(t(x), tp, "btd,df->btf")
    want = jl.linear(jnp.asarray(x), jp, "btd,df->btf")
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=1e-5, atol=1e-5 * np.abs(want).max())
    w = rng(11).standard_normal((128, 4, 8)).astype(np.float32)
    np.testing.assert_allclose(
        tl.linear(t(x), t(w), "btd,dnh->btnh").numpy(),
        np.asarray(jl.linear(jnp.asarray(x), jnp.asarray(w),
                             "btd,dnh->btnh")), rtol=1e-5, atol=1e-5)


def test_linear_transposed_packed_matches_reference():
    """The transposed orientation (the tied unembed) serves through
    dequant_matmul_t, as the reference's linear does."""
    jp, tp = _packed_pair(128, 256)
    x = rng(15).standard_normal((2, 3, 256)).astype(np.float32)
    got = tl.linear(t(x), tp, "btd,vd->btv")
    want = jl.linear(jnp.asarray(x), jp, "btd,vd->btv")
    assert tuple(got.shape) == (2, 3, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_linear_refuses_the_transposed_packed_orientation():
    """In the transposed orientation linear refuses an activation whose
    width is not the packed table's contracting width (the name dates from
    when the orientation itself was refused)."""
    _, tp = _packed_pair(128, 256)
    with pytest.raises(RuntimeError):
        tl.linear(torch.zeros(1, 1, 128), tp, "btd,vd->btv")


@pytest.mark.parametrize("spec", ["btd,df->btf", "btnh,nhd->btd",
                                  "btd,vd->btv", "btd,dnh->btnh"])
def test_spec_orientation(spec):
    assert tl._spec_orientation(spec) == jl._spec_orientation(spec)


def test_embed_lookup_packed_rows():
    jp, tp = _packed_pair(256, 128, seed=12)
    tok = rng(13).integers(0, 256, (2, 5)).astype(np.int32)
    got = tl.embed_lookup(tp, t(tok), dtype=torch.float32)
    want = jl.embed_lookup(jp, jnp.asarray(tok), dtype=jnp.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Cache geometry and the ragged prologue


def test_ring_index_math():
    last = np.array([-1, 0, 5, 13, 27], np.int32)
    np.testing.assert_array_equal(
        tcache.ring_positions(t(last), 7).numpy(),
        np.asarray(jcache.ring_positions(jnp.asarray(last), 7)))
    p = np.arange(-3, 30, dtype=np.int32)
    np.testing.assert_array_equal(tcache.ring_slots(t(p), 7).numpy(),
                                  np.asarray(jcache.ring_slots(
                                      jnp.asarray(p), 7)))


@pytest.mark.parametrize("windows", [[0, 0, 0, 0], [4, 4, 0, 4, 4, 0]])
@pytest.mark.parametrize("windowed", [True, False])
@pytest.mark.parametrize("formats", [None, "q8", "q4"])
def test_cache_spec_and_bytes(windows, windowed, formats):
    kw = dict(slack=8, kv_heads=2, head_dim=16, dtype="bfloat16",
              windowed=windowed, formats=formats)
    spec = tcache.build_cache_spec(windows, 4, 64, **kw)
    jspec = jcache.build_cache_spec(windows, 4, 64, **kw)
    assert spec.cache_bytes() == jspec.cache_bytes()
    assert spec.state_keys == jspec.state_keys
    assert tcache.layer_groups(windows) == jcache.layer_groups(windows)
    for k, s in spec.state_specs().items():
        js = jspec.state_specs()[k]
        assert (s.shape, s.axes, s.dtype) == (js.shape, js.axes, js.dtype)


def test_kv_formats():
    assert tcache.parse_kv_formats("", 2, 16) == \
        jcache.parse_kv_formats("", 2, 16)
    assert tcache.parse_kv_formats("f32", 2, 16) == ("f32", "f32")
    for fmts in ("q8", "q4", "q8,f32", ["q4", "q8"]):
        assert tcache.parse_kv_formats(fmts, 2, 16) == \
            jcache.parse_kv_formats(fmts, 2, 16)
    with pytest.raises(ValueError, match="even"):
        tcache.parse_kv_formats("q4", 2, 15)
    with pytest.raises(ValueError, match="unknown kv format"):
        tcache.parse_kv_formats("q3", 2, 16)


def test_ring_prologue_wipes_reset_slots_in_place():
    r = rng(14)
    state = {"k0": r.standard_normal((2, 3, 5, 2, 4)).astype(np.float32),
             "v0": r.standard_normal((2, 3, 5, 2, 4)).astype(np.float32),
             "pos": np.array([4, 2, 7], np.int32)}
    batch = {"tokens": np.zeros((3, 2), np.int32),
             "t_valid": np.array([2, 1, 0], np.int32),
             "reset": np.array([False, True, False])}
    jpos, jadv, jvalid, jst = japi.ring_prologue(
        {k: jnp.asarray(v) for k, v in state.items()},
        {k: jnp.asarray(v) for k, v in batch.items()}, 1)
    tstate = {k: t(v.copy()) for k, v in state.items()}
    pos, adv, valid, st = api.ring_prologue(
        tstate, {k: t(v) for k, v in batch.items()}, 1)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(adv.numpy(), np.asarray(jadv))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    for k in ("k0", "v0"):
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(jst[k]))
        assert st[k] is tstate[k]
