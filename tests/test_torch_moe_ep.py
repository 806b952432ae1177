"""Expert parallelism on the CPU: the port's ``moe_block_ep`` over gloo
worlds of 1 (in process), 2 and 4 ranks (spawned once for the file)
against the reference's ``moe_block_ep`` on a one-device
``jax.make_mesh((1,), ("model",))`` with the same weights: outputs within
1e-5 in f32, the aux loss equal on every world and within f32 rounding
of the reference's. Cases: qwen2-moe-a2.7b smoke (8 experts,
top-4, 2 shared experts) and a 6-expert top-2 block, which pads to 8 on 4
ranks (rank 3 owns only dummy experts). On one rank the EP path equals the
local path bit for bit; a packed expert stack takes the local path."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jl

from repro_torch import configs
from repro_torch.core import build_plan
from repro_torch.core.tensor_format import PackedTensor
from repro_torch.models import layers as tl
from test_torch_context_parallel import local_world, spawn_worlds

F32 = dict(rtol=1e-5, atol=1e-6)
ARCH = "qwen2-moe-a2.7b"
CASES = {"qwen_smoke": dict(),
         "e6_top2": dict(n_experts=6, experts_per_token=2,
                         n_shared_experts=0)}


def case_cfg(pkg, name):
    return pkg.get_config(ARCH, "smoke").replace(dtype="float32",
                                                 **CASES[name])


def numpy_weights(cfg, seed=0):
    """x (B, T, D) and one MoE layer's weights, seeded."""
    rng = np.random.default_rng(seed)
    D, E, F = cfg.d_model, cfg.n_experts, cfg.dff_expert

    def w(*shape):
        return (rng.standard_normal(shape)
                / np.sqrt(shape[-2])).astype(np.float32)
    out = dict(x=rng.standard_normal((2, 8, D)).astype(np.float32),
               w_router=w(D, E), w_gate=w(E, D, F), w_up=w(E, D, F),
               w_down=w(E, F, D))
    if cfg.n_shared_experts:
        Fs = F * cfg.n_shared_experts
        out.update(ws_gate=w(D, Fs), ws_up=w(D, Fs), ws_down=w(Fs, D))
    return out


def moe_params(mod, w, conv):
    shared = (mod.MlpParams(conv(w["ws_gate"]), conv(w["ws_up"]),
                            conv(w["ws_down"])) if "ws_gate" in w else None)
    return mod.MoeParams(conv(w["w_router"]), conv(w["w_gate"]),
                         conv(w["w_up"]), conv(w["w_down"]), shared=shared)


def ep_job(rank, n, group, payload):
    """Every case's EP block over ``group`` (the same x on every rank)."""
    out = {}
    tl.set_ep_mesh(group, ())
    try:
        for name in CASES:
            cfg = case_cfg(configs, name)
            w = payload[name]
            with torch.no_grad():
                o, aux = tl.moe_block(torch.from_numpy(w["x"]),
                                      moe_params(tl, w, torch.from_numpy),
                                      cfg)
            out[f"{name}_out"], out[f"{name}_aux"] = o.numpy(), aux.numpy()
    finally:
        tl.set_ep_mesh(None, ())
    return out


def reference(name, w):
    jcfg = case_cfg(jconfigs, name)
    jl.set_ep_mesh(jax.make_mesh((1,), ("model",)), (), "model")
    try:
        o, aux = jax.jit(lambda x, p: jl.moe_block(x, p, jcfg))(
            jnp.asarray(w["x"]), moe_params(jl, w, jnp.asarray))
    finally:
        jl.set_ep_mesh(None, ())
    return np.asarray(o), np.asarray(aux)


@pytest.fixture(scope="module")
def ep_worlds(tmp_path_factory):
    payload = {name: numpy_weights(case_cfg(configs, name), seed=i)
               for i, name in enumerate(CASES)}
    got = spawn_worlds((2, 4), str(tmp_path_factory.mktemp("ep")), ep_job,
                       payload)
    got[1] = local_world(ep_job, payload)
    want = {name: reference(name, payload[name]) for name in CASES}
    return got, payload, want


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_moe_block_ep_matches_the_reference(ep_worlds, n, name):
    """The aux loss equals the one-rank port's on every world (the mean
    over the group is of equal values) and the reference's within f32
    rounding: its softmax and means sum in another order (one ulp apart
    on these inputs)."""
    got, _, want = ep_worlds
    want_out, want_aux = want[name]
    np.testing.assert_allclose(got[n][f"{name}_out"], want_out, **F32)
    assert got[n][f"{name}_aux"] == got[1][f"{name}_aux"]
    np.testing.assert_allclose(got[n][f"{name}_aux"], want_aux, **F32)


@pytest.mark.parametrize("name", list(CASES))
def test_one_rank_equals_the_local_path(ep_worlds, name):
    got, payload, _ = ep_worlds
    cfg = case_cfg(configs, name)
    w = payload[name]
    with torch.no_grad():
        out, probs, choice = tl._moe_block_local(
            torch.from_numpy(w["x"]), moe_params(tl, w, torch.from_numpy),
            cfg)
    aux = tl.router_load_balancing_loss(probs, choice, cfg.n_experts)
    np.testing.assert_array_equal(got[1][f"{name}_out"], out.numpy())
    assert got[1][f"{name}_aux"] == aux.numpy()


def test_expert_slices_pad_to_the_group():
    """E = 6 on 4 ranks: 2 experts a rank, rank 3's both dummies (zeros),
    rank 2's second one."""
    w = torch.arange(6.0)[:, None, None].expand(6, 2, 3)
    parts = [tl._ep_expert_slice(w, m, 4, 6, 2, torch.float32)
             for m in range(4)]
    assert [p.shape for p in parts] == [(2, 2, 3)] * 4
    assert [p[:, 0, 0].tolist() for p in parts] == \
        [[0, 1], [2, 3], [4, 5], [0, 0]]
    parts = [tl._ep_expert_slice(w, m, 4, 6, 2, torch.float32)
             for m in range(3)]
    assert parts[2][:, 0, 0].tolist() == [4, 5]


def test_packed_stack_takes_the_local_path(capsys, monkeypatch):
    """Packed expert stacks keep the local sort-dispatch path under
    ``set_ep_mesh`` (saying so once), where ``dequant_matmul``'s lead dim
    carries them."""
    cfg = case_cfg(configs, "qwen_smoke")
    w = numpy_weights(cfg)
    p = moe_params(tl, w, torch.from_numpy)
    stacks = {"w_gate": p.w_gate, "w_up": p.w_up, "w_down": p.w_down}
    plan = build_plan(stacks, "babsmax16:n4")
    packed = plan.pack(stacks, {f"['{k}']": (1, 1) for k in stacks})
    assert all(isinstance(v, PackedTensor) for v in packed.values())
    pp = p._replace(**packed)
    monkeypatch.setattr(tl, "_EP_PACKED_FALLBACK_LOGGED", False)
    x = torch.from_numpy(w["x"])
    with torch.no_grad():
        want = tl.moe_block(x, pp, cfg)
        got = local_world(lambda *a: _under_ep(x, pp, cfg), None)
    for g, e in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), e.numpy())
    assert capsys.readouterr().out.count("falls back to local") == 1


def _under_ep(x, p, cfg):
    tl.set_ep_mesh(torch.distributed.group.WORLD, ())
    try:
        first = tl.moe_block(x, p, cfg)
        tl.moe_block(x, p, cfg)                 # no second message
        return first
    finally:
        tl.set_ep_mesh(None, ())


def test_set_ep_mesh_needs_a_mesh_for_batch_axes():
    with pytest.raises(ValueError, match="DeviceMesh"):
        tl.set_ep_mesh(object(), ("data",))
    assert tl._EP_MESH is None
