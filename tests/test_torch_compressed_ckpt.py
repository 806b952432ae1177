"""Entropy-coded checkpoints (``train/compressed_ckpt.py``) and the small
names that came with them (``core/plan.py`` ``path_str``/
``_flat_with_paths``, ``core/distributions.py`` ``Uniform``/``by_name``/
``sample``, ``serve/cache.py`` ``CacheSpec.group_row_bytes``), against the
JAX package's.

For the same weights the two packages write the same npz arrays
(``__payload``, ``__lengths``, ``__symbols``, ``__meta`` and the raw
tensors) and the same ``manifest.json``, and a checkpoint written by either
loads in the other to equal arrays."""
import functools
import json
import os
import threading
import time
import weakref

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.core import distributions as jdist
from repro.core.plan import _flat_with_paths as j_flat_with_paths
from repro.models import api as jmapi
from repro.train import compressed_ckpt as jckpt

from repro_torch import configs
from repro_torch.core import distributions as dist
from repro_torch.core.plan import (HOST_WINDOW, _flat_with_paths, in_window,
                                   map_with_paths, path_str)
from repro_torch.models import api as mapi
from repro_torch.models import transformer
from repro_torch.train import compressed_ckpt as ckpt

CFG = configs.get_config("paper-100m", "smoke")


def numpy_params(cfg, seed=0):
    """Seeded numpy weights (norm gains around 1, fan-in scaled matrices)."""
    rng = np.random.default_rng(seed)

    def make(path, spec):
        if "norm" in path:
            return (1 + 0.1 * rng.standard_normal(spec.shape)
                    ).astype(np.float32)
        std = 0.02 if "embed" in path else \
            1 / np.sqrt(spec.numel // spec.shape[-1])
        return (rng.standard_normal(spec.shape) * std).astype(np.float32)
    return map_with_paths(make, transformer.param_specs(cfg))


def torch_tree(np_tree):
    return map_with_paths(lambda _, x: torch.from_numpy(x.copy()), np_tree)


def npz_arrays(path):
    with np.load(os.path.join(path, "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


def manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """The same seeded weights written by both packages at 4 bits."""
    root = tmp_path_factory.mktemp("cckpt")
    np_params = numpy_params(CFG)
    mine = ckpt.save_compressed_params(str(root / "port"),
                                       torch_tree(np_params), step=3)
    ref = jckpt.save_compressed_params(
        str(root / "ref"), jax.tree.map(jnp.asarray, np_params), step=3)
    return np_params, mine, ref


class TestAgainstTheReference:
    def test_npz_arrays_equal(self, written):
        _, mine, ref = written
        a, b = npz_arrays(mine), npz_arrays(ref)
        assert sorted(a) == sorted(b)
        kinds = {k.rsplit(".__", 1)[-1] for k in a if ".__" in k}
        assert kinds == {"payload", "lengths", "symbols", "meta"}
        assert any(".__" not in k for k in a)      # raw tensors too
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    def test_manifest_equal(self, written):
        _, mine, ref = written
        assert os.path.basename(mine) == os.path.basename(ref) == \
            "cstep_00000003"
        assert manifest(mine) == manifest(ref)

    def test_port_checkpoint_loads_in_the_reference(self, written):
        np_params, mine, ref = written
        template = jax.tree.map(jnp.asarray, np_params)
        got = jckpt.load_compressed_params(mine, template)
        want = jckpt.load_compressed_params(ref, template)
        for (p, x), (_, y) in zip(j_flat_with_paths(got),
                                  j_flat_with_paths(want)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), p)

    def test_reference_checkpoint_loads_in_the_port(self, written):
        np_params, mine, ref = written
        template = torch_tree(np_params)
        got = ckpt.load_compressed_params(ref, template)
        want = jckpt.load_compressed_params(
            ref, jax.tree.map(jnp.asarray, np_params))
        mine_back = ckpt.load_compressed_params(mine, template)
        j = dict(j_flat_with_paths(want))
        for (p, x), (_, y) in zip(_flat_with_paths(got),
                                  _flat_with_paths(mine_back)):
            assert x.dtype == torch.float32 and x.shape == template_shape(
                template, p)
            np.testing.assert_array_equal(x.numpy(), np.asarray(j[p]), p)
            assert torch.equal(x, y), p


def template_shape(tree, path):
    return dict(_flat_with_paths(tree))[path].shape


class TestCompressedCheckpoint:
    """The reference's own two tests (``tests/test_configs_and_ckpt.py``)
    on the port."""

    def test_roundtrip_and_size(self, tmp_path):
        params = transformer.init(CFG, seed=0, device="cpu")
        path = ckpt.save_compressed_params(str(tmp_path / "c"), params,
                                           target_bits=4.0)
        loaded = ckpt.load_compressed_params(path, params)
        for (p, a), (_, b) in zip(_flat_with_paths(params),
                                  _flat_with_paths(loaded)):
            a, b = a.float().numpy(), b.float().numpy()
            assert a.shape == b.shape
            if a.size >= 4096 and a.ndim >= 2:
                rms = np.sqrt((a ** 2).mean())
                assert np.abs(a - b).max() < rms  # grid-bounded
            else:
                np.testing.assert_array_equal(a, b)  # raw
        nbytes = os.path.getsize(os.path.join(path, "arrays.npz"))
        n_params = sum(x.numel() for _, x in _flat_with_paths(params))
        assert nbytes < n_params * 1.0  # < 8 bits/param incl. overheads

    def test_achieved_bits_near_target(self, tmp_path):
        params = transformer.init(CFG, seed=1, device="cpu")
        path = ckpt.save_compressed_params(str(tmp_path / "c2"), params,
                                           target_bits=3.0)
        assert 2.5 < manifest(path)["achieved_bits_per_param"] < 3.6

    def test_bf16_leaves_and_restaging(self, tmp_path):
        """bf16 leaves are coded from their f32 values; a stale staging
        directory and an earlier checkpoint of the same step are
        replaced."""
        params = map_with_paths(lambda _, x: x.to(torch.bfloat16),
                                transformer.init(CFG, seed=2, device="cpu"))
        root = tmp_path / "c3"
        os.makedirs(root / "cstep_00000000.tmp")
        first = ckpt.save_compressed_params(str(root), params)
        again = ckpt.save_compressed_params(str(root), params)
        assert first == again and sorted(os.listdir(root)) == \
            ["cstep_00000000"]
        f32 = map_with_paths(lambda _, x: x.float(), params)
        want = npz_arrays(ckpt.save_compressed_params(str(tmp_path / "f"),
                                                      f32))
        got = npz_arrays(first)
        assert sorted(got) == sorted(want)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], k)


@pytest.mark.parametrize("window", [1, 3])
def test_in_window_yields_in_order_with_a_bounded_flight(window):
    """``plan.in_window`` yields ``fn``'s results in the items' order and
    never has more than ``window`` calls running or finished but not yet
    taken."""
    lock, held, most = threading.Lock(), [0], [0]

    def fn(i):
        with lock:
            held[0] += 1
            most[0] = max(most[0], held[0])
        time.sleep(0.002)
        return i * i

    got = []
    for r in in_window(fn, range(17), window):
        got.append(r)
        with lock:
            held[0] -= 1
    assert got == [i * i for i in range(17)]
    assert most[0] <= window


def test_codec_holds_at_most_a_window_of_host_copies(tmp_path, monkeypatch):
    """The codec's threads copy each tensor to the host themselves: at no
    time are more than ``plan.HOST_WINDOW`` host copies alive, and the
    file is the one written a tensor at a time."""
    rng = np.random.default_rng(4)
    params = {f"w{i:02d}": torch.from_numpy(
        rng.standard_normal((64, 128)).astype(np.float32))
        for i in range(3 * HOST_WINDOW + 1)}
    host_f32, lock, live, most = ckpt._host_f32, threading.Lock(), [0], [0]

    def dropped():
        with lock:
            live[0] -= 1

    def counted(x):
        out = host_f32(x).copy()
        with lock:
            live[0] += 1
            most[0] = max(most[0], live[0])
        weakref.finalize(out, dropped)
        time.sleep(0.002)
        return out

    monkeypatch.setattr(ckpt, "_host_f32", counted)
    got = npz_arrays(ckpt.save_compressed_params(str(tmp_path / "w"),
                                                 params))
    assert 1 <= most[0] <= HOST_WINDOW and live[0] == 0
    monkeypatch.setattr(ckpt, "in_window", functools.partial(in_window,
                                                             window=1))
    want = npz_arrays(ckpt.save_compressed_params(str(tmp_path / "one"),
                                                  params))
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], k)
    back = ckpt.load_compressed_params(str(tmp_path / "w" / "cstep_00000000"),
                                       params)
    for k, x in params.items():
        assert back[k].shape == x.shape and back[k].dtype == torch.float32


def test_constant_tensor_clips_as_in_the_reference(tmp_path):
    """A constant tensor of >= 4096 elements (stacked norm gains at their
    init) has zero entropy at every grid step, so the reference's fit runs
    the step down to its floor and every code clips at 32767: the tensor
    comes back as 32767 * delta, about 0.00195, in both packages (a
    reference-side fault, kept for parity)."""
    tree = {"gains": np.ones((12, 768), np.float32)}
    mine = ckpt.save_compressed_params(str(tmp_path / "p"), torch_tree(tree))
    ref = jckpt.save_compressed_params(str(tmp_path / "r"),
                                       jax.tree.map(jnp.asarray, tree))
    a, b = npz_arrays(mine), npz_arrays(ref)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    back = ckpt.load_compressed_params(mine, torch_tree(tree))["gains"]
    delta = a["['gains'].__meta"][1] / 2.0 ** 40
    assert torch.all(back == np.float32(32767 * delta))
    assert 0.0019 < float(back[0, 0]) < 0.002


# ---------------------------------------------------------------------------
# The names that came with the module


TREES = {
    "params": lambda: numpy_params(CFG),
    "mixed": lambda: {"b": [np.zeros(2), {"z": np.ones(3), "a": None}],
                      "a": (np.ones(1), np.zeros((2, 2))),
                      "d": {3: np.ones(4), 1: [np.ones(1)]}, "c": {}},
}


@pytest.mark.parametrize("tree", sorted(TREES))
def test_flat_with_paths_equals_the_reference(tree):
    t = TREES[tree]()
    mine = _flat_with_paths(t)
    ref = j_flat_with_paths(t)
    assert [p for p, _ in mine] == [p for p, _ in ref]
    for (_, x), (_, y) in zip(mine, ref):
        assert x is y
    flat, _ = jax.tree_util.tree_flatten_with_path(t)
    assert [path_str(tuple(getattr(k, "key", getattr(k, "idx", None))
                           for k in p)) for p, _ in flat] == \
        [p for p, _ in ref]


DISTS = [("normal", {}), ("gaussian", {"scale": 2.0}), ("laplace", {}),
         ("l", {"scale": 0.5}), ("student_t", {"nu": 5.0}),
         ("Student-T", {"nu": 9.0, "scale": 3.0}), ("t", {}),
         ("uniform", {}), ("UNIFORM", {"scale": 0.25})]


@pytest.mark.parametrize("name, kw", DISTS)
def test_by_name_and_sample_equal_the_reference(name, kw):
    d, jd = dist.by_name(name, **kw), jdist.by_name(name, **kw)
    assert type(d).__name__ == type(jd).__name__ and d.scale == jd.scale
    assert d.rms() == jd.rms()
    assert d.expected_absmax(64) == jd.expected_absmax(64)
    if name.lower() not in ("t", "student_t", "student-t") or \
            kw.get("nu", 7.0) > 3:
        assert type(d.cube_root()).__name__ == type(jd.cube_root()).__name__
    a = d.sample(np.random.default_rng(7), (3, 5))
    b = jd.sample(np.random.default_rng(7), (3, 5))
    assert a.dtype == np.float32 and a.shape == (3, 5)
    np.testing.assert_array_equal(a, b)
    ta = d.truncate(-1.5, 2.0).sample(np.random.default_rng(8), (64,))
    tb = jd.truncate(-1.5, 2.0).sample(np.random.default_rng(8), (64,))
    np.testing.assert_array_equal(ta, tb)
    assert ta.min() >= -1.5 and ta.max() <= 2.0


def test_uniform_statistics():
    u = dist.Uniform(scale=2.0)
    assert u.rms() == pytest.approx(2.0 / np.sqrt(3.0))
    assert u.expected_absmax(63) == pytest.approx(2.0 * 63 / 64)
    assert u.power(1 / 3) is u and u.unit_rms().rms() == pytest.approx(1.0)
    assert float(u.cdf(0.0)) == pytest.approx(0.5)
    with pytest.raises(ValueError, match="unknown distribution"):
        dist.by_name("cauchy")


@pytest.mark.parametrize("arch", ["paper-100m", "gemma3-1b"])
@pytest.mark.parametrize("fmt", ["f32", "q8", "q4"])
def test_group_row_bytes_equals_the_reference(arch, fmt):
    kv = "" if fmt == "f32" else fmt
    cfg = configs.get_config(arch, "full").replace(kv_format=kv)
    jcfg = jconfigs.get_config(arch, "full").replace(kv_format=kv)
    spec = mapi.get_family(cfg.family).cache_spec(cfg, 4, 1024, slack=8)
    jspec = jmapi.get_family(jcfg.family).cache_spec(jcfg, 4, 1024, slack=8)
    assert spec.group_row_bytes(fmt) == jspec.group_row_bytes(fmt)
    item = torch.empty((), dtype=getattr(torch, spec.dtype)).element_size()
    assert spec.group_row_bytes(fmt) == {
        "f32": 2 * cfg.hd * item, "q8": 2 * (cfg.hd + 4),
        "q4": 2 * (cfg.hd // 2 + 4)}[fmt]
