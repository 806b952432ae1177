"""The port's sharding rules and spec utilities against the reference's:
``launch.mesh.spec_for`` for every spec of every config under every rule
set on the (16, 16) and (2, 16, 16) production mesh shapes (planning
stand-ins: no process group), the reference's ``TestSpecFor`` cases,
``placements_for``'s layout of a dim sharded over two axes on a fake
world, ``count_params``, ``model_flops``, ``analytic_bytes_per_device``,
``specs_to_sds`` and ``empty_pack_layouts``."""
import jax
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import analysis as jan
from repro.launch import mesh as jmesh
from repro.models import api as japi

from repro_torch import configs
from repro_torch.core import build_plan
from repro_torch.core.plan import flat_with_paths
from repro_torch.launch import analysis, dryrun, mesh
from repro_torch.launch.mesh import (DECODE_RULES, DECODE_RULES_SEQKV,
                                     LONG_DECODE_RULES, TRAIN_RULES,
                                     decode_rules_for, spec_for)
from repro_torch.models import api, transformer
from repro_torch.serve.engine import ServeEngine


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


MESH = FakeMesh({"data": 16, "model": 16})
MESH3 = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = {"pod256": MESH, "pod512": MESH3}
RULE_SETS = {"train": TRAIN_RULES, "decode": DECODE_RULES,
             "decode_seqkv": DECODE_RULES_SEQKV, "long": LONG_DECODE_RULES}
JRULE_SETS = {"train": jmesh.TRAIN_RULES, "decode": jmesh.DECODE_RULES,
              "decode_seqkv": jmesh.DECODE_RULES_SEQKV,
              "long": jmesh.LONG_DECODE_RULES}


def test_rule_tables_equal_the_reference():
    for name, rules in RULE_SETS.items():
        assert rules == JRULE_SETS[name], name
    assert mesh.RULES_BY_KIND == jmesh.RULES_BY_KIND


def _specs(pkg_configs, pkg_api, pkg_shapes, arch):
    """Every ParamSpec of ``arch``: parameters, decode state at decode_32k
    and the batch of each shape, by path."""
    cfg = pkg_configs.get_config(arch, "full")
    fam = pkg_api.get_family(cfg.family)
    trees = {"params": fam.param_specs(cfg)}
    if fam.decode_state_specs is not None:
        trees["state"] = fam.decode_state_specs(cfg, 128, 32768)
    for name, shape in pkg_shapes.items():
        trees[name] = pkg_configs.input_specs(cfg, shape)
    return cfg, trees


def _flat_ref(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, japi.ParamSpec))[0]
    return {jax.tree_util.keystr(p): s for p, s in flat}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list(jconfigs.ARCHS))
def test_spec_for_equals_the_reference(arch, mesh_name):
    """Every spec of the config under the four rule sets and
    ``decode_rules_for``, as tuples."""
    fake = MESHES[mesh_name]
    cfg, trees = _specs(configs, api, configs.SHAPES, arch)
    jcfg, jtrees = _specs(jconfigs, japi, jconfigs.SHAPES, arch)
    rule_sets = dict(RULE_SETS, by_kv=decode_rules_for(cfg.n_kv_heads, fake))
    jrule_sets = dict(JRULE_SETS,
                      by_kv=jmesh.decode_rules_for(jcfg.n_kv_heads, fake))
    n = 0
    for tree_name, tree in trees.items():
        ours = dict(flat_with_paths(tree))
        ref = _flat_ref(jtrees[tree_name])
        assert sorted(ours) == sorted(ref), tree_name
        for path, s in ours.items():
            r = ref[path]
            assert (tuple(s.shape), tuple(s.axes)) == \
                (tuple(r.shape), tuple(r.axes)), path
            for name, rules in rule_sets.items():
                got = spec_for(s.axes, s.shape, fake, rules)
                want = tuple(jmesh.spec_for(r.axes, r.shape, fake,
                                            jrule_sets[name]))
                assert got == want, (tree_name, path, name)
                n += 1
    assert n > 0


class TestSpecFor:
    """The reference's ``tests/test_mesh_analysis.py::TestSpecFor`` cases,
    on the port."""

    def test_heads_shard_model(self):
        s = spec_for(("layers", "fsdp", "heads", None), (126, 16384, 128, 128),
                     MESH, TRAIN_RULES)
        assert s == (None, "data", "model", None)

    def test_kv_heads_fall_back_to_replicated_for_args(self):
        s = spec_for(("layers", "fsdp", "kv_heads", None), (126, 16384, 8, 128),
                     MESH, TRAIN_RULES)
        assert s == (None, "data", None, None)

    def test_batch_uses_pod_and_data(self):
        s = spec_for(("batch", None), (256, 4096), MESH3, TRAIN_RULES)
        assert s == (("pod", "data"), None)

    def test_no_axis_reuse_within_tensor(self):
        s = spec_for(("vocab", "mlp"), (128256, 53248), MESH, TRAIN_RULES)
        assert s[0] == "model" and s[1] is None

    def test_odd_vocab_replicates_for_args(self):
        s = spec_for(("vocab", "fsdp"), (92553, 6144), MESH, TRAIN_RULES)
        assert s[0] is None and s[1] == "data"

    def test_uneven_batch_replicates(self):
        s = spec_for(("batch", None), (7, 4096), MESH, TRAIN_RULES)
        assert s == (None, None)

    def test_decode_rules_seqkv_variant(self):
        r8 = decode_rules_for(8, MESH)
        r32 = decode_rules_for(32, MESH)
        assert r8["seq_kv"] == ["model"] and r8["kv_heads"] == [None]
        assert r32["seq_kv"] == [None] and r32["kv_heads"] == ["model"]


@pytest.mark.parametrize("rank", [0, 5, 7])
def test_placements_for_two_axes_keep_the_reference_layout(rank):
    """A dim sharded over ("pod", "data") on a (2, 2, 2) mesh: rank (p, d,
    m) holds chunk p·2 + d of 4, pod major, as the reference's
    ``PartitionSpec(("pod", "data"))``."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.testing._internal.distributed.fake_pg import FakeStore
    torch.distributed.init_process_group("fake", store=FakeStore(),
                                         rank=rank, world_size=8)
    try:
        m = init_device_mesh("cpu", (2, 2, 2),
                             mesh_dim_names=("pod", "data", "model"))
        pl = mesh.placements_for((("pod", "data"), "model"), m)
        assert pl == (Shard(0), Shard(0), Shard(1))
        assert mesh.placements_for((None, None), m) == (Replicate(),) * 3
        shape, off = compute_local_shape_and_global_offset((16, 6), m, pl)
        p, d, mm = rank // 4, rank // 2 % 2, rank % 2
        assert tuple(shape) == (4, 3)
        assert tuple(off) == ((p * 2 + d) * 4, mm * 3)
        with pytest.raises(ValueError, match="dim order"):
            mesh.placements_for((("data", "pod"),), m)
    finally:
        torch.distributed.destroy_process_group()


def test_production_mesh_needs_its_world():
    with pytest.raises(RuntimeError, match="no process group"):
        mesh.make_production_mesh(device_type="cpu")
    with dryrun.fake_world(8):
        with pytest.raises(ValueError, match="needs 256 ranks"):
            mesh.make_production_mesh(device_type="cpu")
        host = mesh.make_host_mesh(model=2, device_type="cpu")
        assert mesh.mesh_shape(host) == {"data": 4, "model": 2}
    assert not torch.distributed.is_initialized()
    with dryrun.fake_world(512):
        m = mesh.make_production_mesh(multi_pod=True, device_type="cpu")
        assert mesh.mesh_shape(m) == {"pod": 2, "data": 16, "model": 16}
        out = mesh.describe_sharding(
            {"w": api.ParamSpec((64, 32), ("fsdp", "mlp"))}, m, TRAIN_RULES)
        assert out.startswith("['w']")
        assert out.endswith("(('pod', 'data'), 'model')")


@pytest.mark.parametrize("arch", list(jconfigs.ARCHS))
def test_count_params_and_model_flops_equal(arch):
    cfg = configs.get_config(arch, "full")
    jcfg = jconfigs.get_config(arch, "full")
    specs = api.get_family(cfg.family).param_specs(cfg)
    jspecs = japi.get_family(jcfg.family).param_specs(jcfg)
    assert api.count_params(specs) == japi.count_params(jspecs)
    for name in configs.SHAPES:
        got = analysis.model_flops(cfg, configs.SHAPES[name])
        want = jan.model_flops(jcfg, jconfigs.SHAPES[name])
        assert got == pytest.approx(want, rel=1e-12), name


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list(jconfigs.ARCHS))
def test_analytic_bytes_per_device_equal(arch, mesh_name):
    fake = MESHES[mesh_name]
    cfg = configs.get_config(arch, "full")
    jcfg = jconfigs.get_config(arch, "full")
    for dt in ("float32", "bfloat16"):
        specs = api.get_family(cfg.family).param_specs(
            cfg.replace(param_dtype=dt))
        jspecs = japi.get_family(jcfg.family).param_specs(
            jcfg.replace(param_dtype=dt))
        for name, rules in RULE_SETS.items():
            assert analysis.analytic_bytes_per_device(specs, fake, rules) \
                == jan.analytic_bytes_per_device(jspecs, fake,
                                                 JRULE_SETS[name]), (dt, name)


def test_specs_to_sds_are_meta_tensors():
    cfg = configs.get_config("llama3-405b", "full")
    specs = transformer.param_specs(cfg.replace(param_dtype="bfloat16"))
    sds = api.specs_to_sds(specs)
    flat = dict(flat_with_paths(sds))
    for path, s in flat_with_paths(specs):
        t = flat[path]
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(s.shape)
        assert t.dtype == torch.bfloat16
    assert sum(t.numel() for t in flat.values()) == api.count_params(specs)


class TestEmptyPackLayoutFailFast:
    """The reference's ``tests/test_serve.py::TestEmptyPackLayoutFailFast``
    on the port."""

    def test_packed_engine_refuses_empty_layout_family(self):
        cfg0 = configs.get_config("paper-100m", "smoke").replace(
            dtype="float32")
        fam = api.get_family(cfg0.family)
        stub = api.ModelFamily(
            name="_nopack_stub", param_specs=fam.param_specs, init=fam.init,
            apply=fam.apply, decode_state_specs=fam.decode_state_specs,
            decode_step=fam.decode_step, prefill=fam.prefill,
            supports_ragged=True, cache_spec=fam.cache_spec,
            pack_layouts=api.empty_pack_layouts)
        api.register_family(stub)
        try:
            cfg = cfg0.replace(family="_nopack_stub")
            params = fam.init(cfg0, seed=0, device="cpu")
            plan = build_plan(params, "babsmax32:n4")
            with pytest.raises(ValueError, match="_nopack_stub"):
                ServeEngine.from_quantised(cfg, plan.quantise(params), plan,
                                           batch_slots=1, kv_len=32,
                                           device="cpu")
            # the explicit opt-out still works
            eng = ServeEngine.from_quantised(cfg, plan.quantise(params), plan,
                                             packed=False, batch_slots=1,
                                             kv_len=32, device="cpu")
            assert eng.weight_bytes()["packed"] == 0
        finally:
            api._FAMILIES.pop("_nopack_stub", None)

    def test_pack_layouts_required_at_registration(self):
        with pytest.raises(ValueError, match="pack_layouts"):
            api.ModelFamily(name="_bad", param_specs=None, init=None,
                            apply=None)
