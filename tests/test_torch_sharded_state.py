"""Training state on DTensors over gloo worlds of 2 and 4 ranks (spawned
once for the file by ``tests/_gloo_worlds.py``, as
``tests/test_torch_moe_ep.py`` starts its worlds):
the 8-bit Adam update of a (256, 512) leaf sharded on its first and on its
last dim, and of a (256, 384) leaf whose last-dim shards would cut a
128-element moment block (so that dim is gathered before the moments are
quantised), over 3 steps, bit for bit the plain update of the gathered
tensors; a state saved from one layout and restored onto another with
``restore_checkpoint(shardings=)``, bit for bit once gathered."""
import os

import numpy as np
import pytest
import torch

from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import AdamConfig, adam_init, adam_update

CFG = AdamConfig(quantised_state=True)
CASES = {"rows": ((256, 512), 0), "cols": ((256, 512), 1),
         "cut_blocks": ((256, 384), 1)}
STEPS = 3
LR = 1e-3


def payload_for(tmp_dir):
    rng = np.random.default_rng(0)
    out = {"dir": tmp_dir}
    for name, (shape, _) in CASES.items():
        out[name] = {
            "w": rng.standard_normal(shape).astype(np.float32),
            "g": [rng.standard_normal(shape).astype(np.float32)
                  for _ in range(STEPS)]}
    return out


def leaves(state):
    """{name: array} of a one-leaf Adam run: params and the moments' codes
    and scales, gathered (bf16 scales widened to f32, exactly)."""
    def whole(t):
        t = t.full_tensor() if hasattr(t, "full_tensor") else t
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    params, opt = state
    out = {"w": whole(params["w"])}
    for k in ("m", "v"):
        out[f"{k}_codes"] = whole(opt[k]["w"].codes)
        out[f"{k}_scales"] = whole(opt[k]["w"].scales)
    return out


def plain_run(case):
    p = {"w": torch.from_numpy(case["w"])}
    o = adam_init(p, CFG)
    for g in case["g"]:
        p, o = adam_update({"w": torch.from_numpy(g)}, o, p, LR, CFG)
    return p, o


def sharded_job(rank, n, group, payload):
    """Each case's 3 steps on DTensors over a 1-D mesh of the world; then
    the "rows" state saved and restored with its last dim sharded."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import (TRAIN_RULES, NamedSharding,
                                         named_shardings)
    from repro_torch.models.api import ParamSpec

    mesh = init_device_mesh("cpu", (n,), mesh_dim_names=("model",))
    out, states = {}, {}
    for name, (_, dim) in CASES.items():
        case = payload[name]

        def place(a):
            return distribute_tensor(torch.from_numpy(a), mesh, [Shard(dim)])
        p = {"w": place(case["w"])}
        o = adam_init(p, CFG)
        for g in case["g"]:
            p, o = adam_update({"w": place(g)}, o, p, LR, CFG)
        states[name] = (p, o)
        out.update({f"{name}_{k}": v for k, v in leaves((p, o)).items()})
        out[f"{name}_codes_sharded"] = np.asarray(
            o["m"]["w"].codes.placements[0].is_shard())
    p, o = states["rows"]
    path = ckpt.save_checkpoint(os.path.join(payload["dir"], f"world{n}"),
                                {"params": p, "opt": o}, STEPS)
    # the leaf's logical axes through the train rules: "mlp" shards over
    # "model", "fsdp" finds no "data" axis on this mesh
    spec = {"w": ParamSpec(CASES["rows"][0], ("fsdp", "mlp"))}
    cols = named_shardings(spec, mesh, TRAIN_RULES)
    assert cols["w"].placements == (Shard(1),)
    shardings = {"params": cols, "opt": {
        "m": cols, "v": cols, "step": NamedSharding(mesh, (Replicate(),))}}
    back, _ = ckpt.restore_checkpoint(path, shardings=shardings)
    for key, t in (("w", back["params"]["w"]), ("m", back["opt"]["m"]["w"]),
                   ("v", back["opt"]["v"]["w"])):
        assert t.placements == (Shard(1),)
        out[f"raw_{key}"] = t.full_tensor().numpy()
    back, _ = ckpt.restore_checkpoint(path, template={"params": p, "opt": o},
                                      shardings=shardings)
    out.update({f"tpl_{k}": v for k, v in
                leaves((back["params"], back["opt"])).items()})
    out["tpl_step"] = back["opt"]["step"].full_tensor().numpy()
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    from _gloo_worlds import spawn_worlds
    tmp = str(tmp_path_factory.mktemp("sharded"))
    payload = payload_for(tmp)
    return spawn_worlds((2, 4), tmp, sharded_job, payload), payload


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_8bit_adam_on_dtensors_equals_the_plain_update(worlds, n, name):
    """Codes, scales and params bit for bit; the moments' block-count dim
    keeps the shards where whole blocks fall on each rank (384 = 3 blocks
    does not split over 2 or 4 ranks, so it is gathered)."""
    got, payload = worlds
    want = leaves(plain_run(payload[name]))
    for key, w in want.items():
        np.testing.assert_array_equal(got[n][f"{name}_{key}"], w,
                                      err_msg=f"{name} {key} on {n} ranks")
    assert bool(got[n][f"{name}_codes_sharded"]) == (name != "cut_blocks")


@pytest.mark.parametrize("n", [2, 4])
def test_restore_places_the_saved_tree_onto_another_layout(worlds, n):
    """Saved from rows sharded on dim 0, restored with the last dim
    sharded: without a template the saved f32 arrays come back whole once
    gathered; with one, the moments are requantised shard by shard into
    what an unsharded restore gives."""
    got, payload = worlds
    path = ckpt.latest_checkpoint(os.path.join(payload["dir"], f"world{n}"))
    raw, meta = ckpt.restore_checkpoint(path)
    assert meta["step"] == STEPS
    np.testing.assert_array_equal(got[n]["raw_w"], raw["params"]["w"].numpy())
    for key in ("m", "v"):
        np.testing.assert_array_equal(got[n][f"raw_{key}"],
                                      raw["opt"][key]["w"].numpy())
    p, o = plain_run(payload["rows"])
    back, _ = ckpt.restore_checkpoint(path, template={"params": p, "opt": o})
    for key, w in leaves((back["params"], back["opt"])).items():
        np.testing.assert_array_equal(got[n][f"tpl_{key}"], w, err_msg=key)
    assert int(got[n]["tpl_step"]) == STEPS
