"""The dry run on the CPU: smoke configs on fake worlds of 4 and 8 ranks
((2, 2) and (4, 2) "data" × "model") over meta DTensors —
a dense transformer's train, prefill and decode cells and a MoE cell
through the expert-parallel block — with the record's keys, collective
bytes where a dim is sharded, FLOPs against ``model_flops``, and the world
torn down after every cell; the activation setters on plain tensors; the
recorder's FLOP and ring-model accounting; ``run_cell``'s skip record."""
import functools
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.launch import analysis as jan

from repro_torch import configs
from repro_torch.core.plan import flat_with_paths
from repro_torch.core.tensor_format import QuantisedTensor
from repro_torch.launch import analysis, dryrun, mesh
from repro_torch.models import layers
from repro_torch.train import optimizer

KEYS = ("arch", "shape", "kind", "mesh", "n_devices", "n_params", "status",
        "seconds", "analytic_param_bytes_per_device", "memory",
        "collective_counts", "collective_bytes_per_device",
        "flops_per_device", "flops_global", "model_flops_total")
CELLS = {
    "dense_train_4": ("deepseek-7b", "train", 4),
    "dense_prefill_4": ("deepseek-7b", "prefill", 4),
    "dense_decode_4": ("deepseek-7b", "decode", 4),
    "dense_decode_8": ("deepseek-7b", "decode", 8),
    "moe_decode_8": ("qwen2-moe-a2.7b", "decode", 8),
}


def world_mesh(n):
    """(n // 2, 2) ("data", "model"). A three-axis mesh works too but its
    first DTensor sharding propagation takes minutes on this CPU."""
    return mesh.make_host_mesh(model=2, device_type="cpu")


# below every smoke leaf's size, so that the train cell's leaves whose
# last dim tiles by 128 take 8-bit moments (the default, 65536, quantises
# none of them at smoke size)
MIN_QUANT_NUMEL = 1024


@pytest.fixture(scope="module")
def records():
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        acfg = optimizer.AdamConfig
        mp.setattr(optimizer, "AdamConfig", functools.partial(
            acfg, min_quant_numel=MIN_QUANT_NUMEL))
        opt_state = dryrun._opt_state

        def kept(*a, **kw):
            acfg, opt = opt_state(*a, **kw)
            out["_opt"] = opt
            return acfg, opt
        mp.setattr(dryrun, "_opt_state", kept)
        for name, (arch, kind, n) in CELLS.items():
            cfg = configs.get_config(arch, "smoke")
            shape = configs.smoke_shape(kind, seq=16, batch=4)
            with dryrun.fake_world(n):
                out[name] = dryrun.run_on_mesh(cfg, shape, world_mesh(n))
            out[name]["_initialised_after"] = dist.is_initialized()
    return out


@pytest.mark.parametrize("name", list(CELLS))
def test_cell_runs_and_records(records, name):
    rec = records[name]
    assert rec["status"] == "ok", rec.get("traceback")
    assert not rec["_initialised_after"]
    for key in KEYS:
        assert key in rec, key
    arch, kind, n = CELLS[name]
    assert rec["n_devices"] == n and rec["kind"] == kind
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["analytic_param_bytes_per_device"] > 0
    # weights and the batch shard: collectives move bytes, and each rank
    # computes a share of the global FLOPs
    assert rec["collective_bytes_per_device"]["total"] > 0
    assert sum(rec["collective_counts"].values()) == \
        rec["collective_records"] > 0
    assert 0 < rec["flops_per_device"] < rec["flops_global"]
    assert rec["flops_global"] == pytest.approx(rec["model_flops_total"],
                                                rel=0.5)
    if kind == "train":
        assert rec["adam_update"] == "ok"
    json.dumps(rec)


def test_train_cell_updates_8bit_moments_on_dtensors(records):
    """The train cell's Adam update ran with quantised moments laid out on
    the mesh: each rank quantises its own shard (``searchsorted`` has no
    DTensor strategy), and the cell records ``ok``."""
    from torch.distributed.tensor import DTensor
    quantised = [x for _, x in flat_with_paths(records["_opt"]["m"])
                 if isinstance(x, QuantisedTensor)]
    assert quantised and all(isinstance(q.codes, DTensor)
                             for q in quantised)
    assert records["dense_train_4"]["adam_update"] == "ok"


def test_a_refused_update_fails_the_cell(monkeypatch):
    """A refused update is the cell's error with its traceback, not an
    ``ok`` cell carrying a string."""
    def refuse(*a, **kw):
        raise NotImplementedError("no sharding strategy, on purpose")
    monkeypatch.setattr(optimizer, "adam_update", refuse)
    cfg = configs.get_config("deepseek-7b", "smoke").replace(n_layers=1)
    with dryrun.fake_world(4):
        rec = dryrun.run_on_mesh(cfg, configs.smoke_shape("train", 16, 4),
                                 world_mesh(4))
    assert rec["status"] == "error" and "on purpose" in rec["error"]
    assert "adam_update" in rec["traceback"]
    assert not dist.is_initialized()


def test_moe_cell_runs_the_expert_parallel_block(records):
    """The EP block all-reduces its rows over the model group: all-reduce
    bytes beyond the dense decode's on the same mesh, and the setters are
    reset afterwards."""
    moe = records["moe_decode_8"]["collective_bytes_per_device"]
    assert moe.get("all-reduce", 0) > 0
    assert layers._EP_MESH is None and layers._HEAD_AXIS is None
    assert layers._ACT_BATCH_AXES is None and layers._ACT_SEQ_AXIS is None


def test_a_failing_cell_is_recorded_and_torn_down(monkeypatch):
    def refuse(*a, **kw):
        raise RuntimeError("refused on purpose")
    monkeypatch.setattr(dryrun, "_build_cell", refuse)
    cfg = configs.get_config("qwen2-moe-a2.7b", "smoke")
    with dryrun.fake_world(4):
        rec = dryrun.run_on_mesh(cfg, configs.smoke_shape("decode", 16, 4),
                                 world_mesh(4))
    assert not dist.is_initialized()
    assert rec["status"] == "error" and "refused on purpose" in rec["error"]
    assert "Traceback" in rec["traceback"]
    assert layers._EP_MESH is None and layers._HEAD_AXIS is None


def test_fake_world_is_destroyed_on_an_exception():
    with pytest.raises(KeyError):
        with dryrun.fake_world(4):
            raise KeyError("x")
    assert not dist.is_initialized()


def test_build_cell_takes_the_reference_names():
    """``build_cell(arch_id, shape_name, mesh)``: the full config (a serving
    cell in bf16), its parameters laid out by the rules, nothing run."""
    from torch.distributed.tensor import DTensor
    with dryrun.fake_world(4):
        m = world_mesh(4)
        fn, args, meta = dryrun.build_cell("gemma3-1b", "decode_32k", m)
        params = args[0]
    assert meta["arch"] == "gemma3-1b" and meta["kind"] == "decode"
    assert meta["n_params"] == 999826048
    emb = params["embed"]
    assert isinstance(emb, DTensor) and emb.dtype == torch.bfloat16
    assert emb.device.type == "meta"


def test_run_cell_skips_without_a_world(tmp_path):
    rec = dryrun.run_cell("deepseek-7b", "long_500k", False,
                          out_dir=str(tmp_path))
    assert rec["status"] == "skipped"
    saved = json.loads((tmp_path / "pod256" /
                        "deepseek-7b__long_500k.json").read_text())
    assert saved == rec
    assert not dist.is_initialized()


def test_activation_setters_are_the_identity_on_plain_tensors():
    x = torch.randn(2, 32, 4, 8)
    layers.set_activation_sharding(("data",), "model")
    layers.set_head_axis("model")
    try:
        assert layers.constrain_act(x) is x
        assert layers.constrain_heads(x) is x
    finally:
        layers.set_activation_sharding(None)
        layers.set_head_axis(None)
    assert layers.constrain_act(x) is x and layers.constrain_heads(x) is x


def test_constrain_act_lays_out_a_dtensor():
    """Batch over "data", T over "model" when it divides by 16; heads over
    "model"."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with dryrun.fake_world(4):
        m = world_mesh(4)
        x = DTensor.from_local(torch.empty(4, 32, 4, 8, device="meta"), m,
                               [Replicate(), Replicate()], run_check=False)
        layers.set_activation_sharding(("data",), "model")
        layers.set_head_axis("model")
        try:
            assert layers.constrain_act(x).placements == (Shard(0), Shard(1))
            assert layers.constrain_act(x[:, :8]).placements == \
                (Shard(0), Replicate())
            assert layers.constrain_heads(x).placements == \
                (Shard(0), Shard(2))
        finally:
            layers.set_activation_sharding(None)
            layers.set_head_axis(None)


def test_recorder_counts_local_flops_and_collectives():
    """A matmul sharded 4 ways on M: FlopCounterMode counts the global
    2·M·K·N, the recorder one rank's quarter; a redistribution to
    replicated is one all-gather of the output."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode
    with dryrun.fake_world(4):
        from torch.distributed.device_mesh import init_device_mesh
        m = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
        a = DTensor.from_local(torch.empty(2, 8, device="meta"), m,
                               [Shard(0)], run_check=False)
        b = DTensor.from_local(torch.empty(8, 4, device="meta"), m,
                               [Replicate()], run_check=False)
        rec = analysis.DeviceRecorder()
        with rec, FlopCounterMode(display=False) as fc:
            (a @ b).redistribute(m, [Replicate()])
    assert fc.get_total_flops() == 2 * 8 * 8 * 4
    assert rec.flops == 2 * 2 * 8 * 4
    assert rec.collectives == [{"op": "all-gather", "bytes": 8 * 4 * 4,
                                "group": 4}]
    got = analysis.collective_bytes(rec.collectives, 4)
    assert got == {"all-gather": 0.75 * 128, "total": 0.75 * 128}


def test_ring_cost_model_equals_the_reference_docstring():
    recs = [{"op": "all-reduce", "bytes": 256, "group": 16},
            {"op": "all-gather", "bytes": 2048, "group": 4},
            {"op": "reduce-scatter", "bytes": 1024, "group": 8},
            {"op": "all-to-all", "bytes": 512, "group": 2},
            {"op": "collective-permute", "bytes": 64, "group": 2}]
    got = analysis.collective_bytes(recs, 256)
    assert got["all-reduce"] == 2 * 15 / 16 * 256
    assert got["all-gather"] == 3 / 4 * 2048
    assert got["reduce-scatter"] == 7 / 8 * 1024
    assert got["all-to-all"] == 512 / 2
    assert got["collective-permute"] == 64
    assert got["total"] == pytest.approx(sum(
        v for k, v in got.items() if k != "total"))
    assert set(got) - {"total"} <= set(jan.COLLECTIVE_OPS)
    assert analysis.COLLECTIVE_OPS == jan.COLLECTIVE_OPS
    assert np.isclose(analysis.collective_bytes(
        [{"op": "all-reduce", "bytes": 100}], 4)["total"], 150.0)


@pytest.mark.parametrize("spec,xs,ws", [
    ("btd,dnh->btnh", (2, 3, 8), (8, 4, 5)),
    ("btnh,nhd->btd", (2, 3, 4, 5), (4, 5, 8)),
    ("btd,vd->btv", (2, 3, 8), (11, 8)),
    ("btd,df->btf", (2, 3, 8), (8, 6))])
def test_linear_dtensor_math_equals_einsum(spec, xs, ws):
    """The DTensor path of ``linear`` (flatten, one matmul, split) is the
    einsum of the spec."""
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(xs, generator=g), torch.randn(ws, generator=g)
    np.testing.assert_allclose(layers._linear_dtensor(x, w, spec).numpy(),
                               torch.einsum(spec, x, w).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_uneven_head_shards_split_and_merge():
    """2 heads over a model axis of 4: the projection, the (K, G) split of
    q sharded on its heads and the merge back all go through (DTensor
    alone refuses the uneven split and merge)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with dryrun.fake_world(4):
        m = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
        x = DTensor.from_local(torch.empty(2, 16, 8, device="meta"), m,
                               [Replicate()], run_check=False)
        w = DTensor.from_local(torch.empty(8, 2, 4, device="meta"), m,
                               [Shard(2)], run_check=False,
                               shape=torch.Size((8, 2, 16)),
                               stride=(32, 16, 1))
        q = layers.linear(x, w, "btd,dnh->btnh")
        assert tuple(q.shape) == (2, 16, 2, 16)
        layers.set_head_axis("model")
        try:
            q = layers.constrain_heads(q)
        finally:
            layers.set_head_axis(None)
        assert q.placements == (Shard(2),)
        qg = layers.split_dim(q, 2, (1, 2))
        assert tuple(qg.shape) == (2, 16, 1, 2, 16)
        o = layers.linear(q, DTensor.from_local(
            torch.empty(2, 16, 8, device="meta"), m, [Replicate()],
            run_check=False), "btnh,nhd->btd")
        assert tuple(o.shape) == (2, 16, 8)
