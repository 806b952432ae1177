"""Port vs reference: the §4 training pipeline — the synthetic data stream,
Adam with 8-bit moments, schedules, the train step (CE, QAT distillation,
microbatches, gradient compression), ``run_qat``, checkpoints in both
directions, fault tolerance, and the ``launch.train`` / ``serve --ckpt``
entry points on the CPU.

The same seeded numpy weights and the same batches go through ``repro``
(JAX) and ``repro_torch`` at smoke size, computing in f32. Tolerances:
batches, moment codes and checkpoint arrays bit-identical; loss and
grad_norm of one step 1e-5 relative; params after one Adam step from the
*same* gradients 1e-6 relative (step-1 Adam is sign(g)·lr, so gradients of
two frameworks would flip signs of near-zero entries); a QAT step's KL 1e-4
relative + 1e-7 absolute; schedules exact through the warmup and within
two ulps of the cosine past it."""
import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import build_plan as jbuild_plan
from repro.data import pipeline as jpipe
from repro.models.api import get_family as jget_family
from repro.train import checkpoint as jckpt
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro.train import qat as jqat
from repro.core.tensor_format import QuantisedTensor as JQuantised

from repro_torch import configs
from repro_torch.core import build_plan
from repro_torch.core.plan import flat_with_paths, map_with_paths
from repro_torch.core.tensor_format import QuantisedTensor
from repro_torch.data import pipeline
from repro_torch.interop import params_from_numpy, tensor_from_numpy
from repro_torch.models import transformer
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import fault_tolerance as ft
from repro_torch.train import loop, optimizer, qat

ARCHS = ["paper-100m", "gemma3-1b"]
REL5 = dict(rtol=1e-5, atol=0)


def cfgs(arch, **kw):
    kw = dict(dtype="float32", **kw)
    return (configs.get_config(arch, "smoke").replace(**kw),
            jconfigs.get_config(arch, "smoke").replace(**kw))


def numpy_params(cfg, seed=0):
    rng = np.random.default_rng(seed)

    def make(path, spec):
        if "norm" in path:
            return (1 + 0.1 * rng.standard_normal(spec.shape)
                    ).astype(np.float32)
        std = 0.3 if "embed" in path else \
            1 / np.sqrt(spec.numel // spec.shape[-1])
        return (rng.standard_normal(spec.shape) * std).astype(np.float32)
    return map_with_paths(make, transformer.param_specs(cfg))


def both(npp):
    return params_from_numpy(npp, "cpu"), jax.tree.map(jnp.asarray, npp)


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def torch_batch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def assert_trees_equal(tree, jtree):
    flat = dict(flat_with_paths(tree))
    jflat = {jax.tree_util.keystr(p): x
             for p, x in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    assert flat.keys() == jflat.keys()
    for k in flat:
        np.testing.assert_array_equal(to_np(flat[k]), np.asarray(jflat[k]),
                                      err_msg=k)


# ---------------------------------------------------------------------------
# data pipeline


@pytest.mark.parametrize("seed,step", [(0, 0), (7, 5), (3, 2 ** 31 + 1)])
def test_tokens_bitwise(seed, step):
    dc = pipeline.DataConfig(vocab=1000, seq=48, batch=3, seed=seed)
    jdc = jpipe.DataConfig(vocab=1000, seq=48, batch=3, seed=seed)
    got = pipeline.tokens_at(dc, step)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jpipe.tokens_at(jdc, step))
    assert pipeline.bigram_entropy_bits(dc, 4096) == \
        jpipe.bigram_entropy_bits(jdc, 4096)


@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_fn_bitwise(arch):
    cfg, jcfg = cfgs(arch)
    fn = pipeline.make_batch_fn(cfg, seq=16, batch=2, seed=4)
    jfn = jpipe.make_batch_fn(jcfg, seq=16, batch=2, seed=4)
    for step in (0, 9):
        got, want = fn(step), jfn(step)
        assert got.keys() == want.keys() == {"tokens"}
        np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_batches_of_unported_families_raise():
    """A family no module registers has no batches (every family of the
    reference's configs is ported now)."""
    cfg = configs.get_config("paper-100m", "smoke").replace(family="mamba3")
    with pytest.raises(KeyError, match="mamba3"):
        pipeline.make_batch_fn(cfg, seq=4, batch=1)


# ---------------------------------------------------------------------------
# optimizer


def test_schedules_match():
    """Exact through the warmup (cos 0 = 1); past it within one f32 ulp:
    XLA's f32 cos is not correctly rounded, and no torch or numpy cos
    reproduces its last bit (about 5% of arguments differ by one ulp)."""
    for base, total, warm in [(3e-3, 100, 10), (1e-2, 7, 0), (0.5, 5, 9)]:
        lr, jlr = (optimizer.cosine_schedule(base, total, warm),
                   jopt.cosine_schedule(base, total, warm))
        for s in range(total + 2):
            got = lr(torch.tensor(s, dtype=torch.int32))
            want = float(jlr(jnp.asarray(s, jnp.int32)))
            assert got.dtype == torch.float32
            if s <= warm:
                assert float(got) == want, (base, total, warm, s)
            else:   # two ulps of cos (≤ 2^-24 each) through base·0.5·(1+cos)
                assert abs(float(got) - want) <= base * 2.0 ** -24, \
                    (base, total, warm, s)
    for b in (1, 2, 3.5, 4, 8):
        assert optimizer.paper_qat_lr(b) == jopt.paper_qat_lr(b)


def moment_case(seed=0):
    """A params tree with quantised (≥2-D, last dim % 128) and f32 leaves."""
    rng = np.random.default_rng(seed)
    p = {"a": rng.standard_normal((4, 256)).astype(np.float32),
         "b": {"c": rng.standard_normal((3, 100)).astype(np.float32),
               "d": rng.standard_normal(128).astype(np.float32)}}
    g = map_with_paths(lambda _, x: (rng.standard_normal(x.shape) * 1e-2
                                     ).astype(np.float32), p)
    return p, g


@pytest.mark.parametrize("steps", [1, 2])
def test_adam_moment_codes_and_params_match(steps):
    """The same gradients into both packages' adam_update: int8 m and
    sqrt-uint8 v codes and scales bit-identical, params within 1e-6."""
    p, g = moment_case()
    ac = optimizer.AdamConfig(quantised_state=True, min_quant_numel=1,
                              weight_decay=0.01)
    jac = jopt.AdamConfig(quantised_state=True, min_quant_numel=1,
                          weight_decay=0.01)
    params, jparams = both(p)
    opt, jo = optimizer.adam_init(params, ac), jopt.adam_init(jparams, jac)
    assert isinstance(opt["m"]["a"], QuantisedTensor)
    assert not isinstance(opt["m"]["b"]["c"], QuantisedTensor)
    for _ in range(steps):
        params, opt = optimizer.adam_update(params_from_numpy(g, "cpu"), opt,
                                            params, 1e-3, ac)
        jparams, jo = jopt.adam_update(jax.tree.map(jnp.asarray, g), jo,
                                       jparams, 1e-3, jac)
    for key in ("m", "v"):
        q, jq = opt[key]["a"], jo[key]["a"]
        np.testing.assert_array_equal(q.codes.numpy(), np.asarray(jq.codes))
        np.testing.assert_array_equal(q.scales.float().numpy(),
                                      np.asarray(jq.scales, np.float32))
        np.testing.assert_array_equal(opt[key]["b"]["d"].numpy(),
                                      np.asarray(jo[key]["b"]["d"]))
    assert int(opt["step"]) == int(jo["step"]) == steps
    for (k, a), (_, b) in zip(flat_with_paths(params),
                              flat_with_paths(jax.tree.map(np.asarray,
                                                           jparams))):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-9,
                                   err_msg=k)


def test_adam_8bit_moments_on_zero_gradients_match_the_reference():
    """A block with one large gradient and zeros: the int8 m grid has no
    zero code (a zero m dequantises to ±scale/255) and the sqrt-uint8 v
    grid flushes small values to 0, so from step 2 such an element moves
    by about lr·m/eps — the reference's own behaviour, reproduced exactly
    (the port follows its formats; ROADMAP §3 keeps the fault)."""
    g = np.zeros((2, 128), np.float32)
    g[0, 0], g[0, 1] = 1e-3, 1e-7
    g[1] = np.random.default_rng(0).standard_normal(128) * 1e-3
    kw = dict(quantised_state=True, min_quant_numel=1)
    ac, jac = optimizer.AdamConfig(**kw), jopt.AdamConfig(**kw)
    params, jparams = both({"w": np.zeros((2, 128), np.float32)})
    opt, jo = optimizer.adam_init(params, ac), jopt.adam_init(jparams, jac)
    for _ in range(3):
        params, opt = optimizer.adam_update({"w": torch.from_numpy(g)}, opt,
                                            params, 5e-4, ac)
        jparams, jo = jopt.adam_update({"w": jnp.asarray(g)}, jo, jparams,
                                       5e-4, jac)
    np.testing.assert_allclose(params["w"].numpy(), np.asarray(jparams["w"]),
                               rtol=1e-6, atol=1e-9)
    assert float(params["w"][0, 2]) > 100 * 5e-4     # the zero-grad jump


def test_adam_converges_on_a_quadratic():
    target = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 8)).astype(np.float32))
    params = {"w": torch.zeros(8, 8)}
    cfg = optimizer.AdamConfig()
    opt = optimizer.adam_init(params, cfg)
    for _ in range(200):
        params, opt = optimizer.adam_update(
            {"w": 2 * (params["w"] - target) / 64}, opt, params, 0.05, cfg)
    assert float(torch.mean((params["w"] - target) ** 2)) < 1e-3


# ---------------------------------------------------------------------------
# the train step


def step_pair(arch, tc_kw=None, ac_kw=None, plan_spec=None, distill=False,
              batch=2, seq=24):
    """One train step of each package from the same params and batch."""
    cfg, jcfg = cfgs(arch)
    npp = numpy_params(cfg)
    params, jparams = both(npp)
    b = pipeline.make_batch_fn(cfg, seq=seq, batch=batch, seed=1)(0)
    tc = loop.TrainConfig(**(tc_kw or {}))
    jtc = jloop.TrainConfig(**(tc_kw or {}))
    ac, jac = (optimizer.AdamConfig(**(ac_kw or {})),
               jopt.AdamConfig(**(ac_kw or {})))
    plan = build_plan(params, plan_spec) if plan_spec else None
    jplan = jbuild_plan(jparams, plan_spec) if plan_spec else None
    step = loop.make_train_step(cfg, ac, tc, lambda s: 1e-3, qat_plan=plan,
                                distill=distill)
    jstep = jloop.make_train_step(jcfg, jac, jtc, lambda s: 1e-3,
                                  qat_plan=jplan, distill=distill)
    student = params
    jstudent = jparams
    if distill:     # a student away from the teacher: its direct cast
        student = map_with_paths(lambda _, x: x.clone(), params)
        jstudent = jax.tree.map(lambda x: x, jparams)
    state = {"params": student, "opt": optimizer.adam_init(student, ac)}
    jstate = {"params": jstudent, "opt": jopt.adam_init(jstudent, jac)}
    args = (params,) if distill else ()
    jargs = (jparams,) if distill else ()
    new, m = step(state, torch_batch(b), *args)
    jnew, jm = jax.jit(jstep)(jstate, jax_batch(b), *jargs)
    return dict(cfg=cfg, jcfg=jcfg, params=params, jparams=jparams, batch=b,
                new=new, m=m, jnew=jnew, jm=jm, plan=plan, jplan=jplan,
                state=state)


@pytest.mark.parametrize("arch", ARCHS)
def test_ce_step_loss_and_grad_norm_match(arch):
    r = step_pair(arch)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(r["m"][k]), float(r["jm"][k]),
                                   **REL5)
    assert np.float32(r["m"]["lr"]) == np.float32(r["jm"]["lr"])
    assert float(r["m"]["grad_norm"]) > 1.0     # the clip is exercised


@pytest.mark.parametrize("arch", ARCHS)
def test_ce_step_params_from_the_reference_grads(arch):
    """The reference's clipped gradients through the port's adam_update
    land on the reference's new params."""
    cfg, jcfg = cfgs(arch)
    npp = numpy_params(cfg)
    params, jparams = both(npp)
    b = jax_batch(pipeline.make_batch_fn(cfg, seq=24, batch=2, seed=1)(0))
    fam = jget_family(jcfg.family)
    jgrads = jax.grad(lambda p: jloop.ce_loss(jcfg, fam.apply(p, b, jcfg),
                                              b))(jparams)
    jgrads, _ = jloop.clip_by_global_norm(jgrads, 1.0)
    ac, jac = optimizer.AdamConfig(), jopt.AdamConfig()
    jnew, _ = jopt.adam_update(jgrads, jopt.adam_init(jparams, jac), jparams,
                               1e-3, jac)
    grads = params_from_numpy(jax.tree.map(np.asarray, jgrads), "cpu")
    new, _ = optimizer.adam_update(grads, optimizer.adam_init(params, ac),
                                   params, 1e-3, ac)
    for (k, a), (_, w) in zip(flat_with_paths(new), flat_with_paths(
            jax.tree.map(np.asarray, jnew))):
        np.testing.assert_allclose(a.numpy(), w, rtol=1e-6, atol=1e-9,
                                   err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("spec", ["babsmax64:n4", "babsmax64:int2"])
def test_qat_distill_step_matches(arch, spec):
    r = step_pair(arch, plan_spec=spec, distill=True)
    kl, jkl = float(r["m"]["loss"]), float(r["jm"]["loss"])
    assert kl > 1e-4
    np.testing.assert_allclose(kl, jkl, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(float(r["m"]["grad_norm"]),
                               float(r["jm"]["grad_norm"]), rtol=1e-4)
    q = r["plan"].quantise(r["params"])
    jq = r["jplan"].quantise(r["jparams"])
    for name, f in r["plan"].formats.items():
        if f is not None:
            a = dict(flat_with_paths(q))[name]
            b = {jax.tree_util.keystr(p): x for p, x in
                 jax.tree_util.tree_flatten_with_path(
                     jq, is_leaf=lambda x: hasattr(x, "codes"))[0]}[name]
            np.testing.assert_array_equal(a.codes.numpy(),
                                          np.asarray(b.codes), err_msg=name)


def test_qat_step_moves_only_the_masters():
    """The STE passes gradients to the f32 masters: the step changes them,
    and the teacher stays as it was."""
    r = step_pair("paper-100m", plan_spec="babsmax64:int2", distill=True)
    teacher = dict(flat_with_paths(r["params"]))
    moved = [n for n, x in flat_with_paths(r["new"]["params"])
             if not torch.equal(x, teacher[n])]
    assert "['layers']['wq']" in moved and "['embed']" in moved


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatches_match_one_batch(arch):
    outs = {}
    for n in (1, 4):
        r = step_pair(arch, tc_kw=dict(microbatches=n), batch=8, seq=16)
        outs[n] = (float(r["m"]["loss"]), float(r["m"]["grad_norm"]))
        jl = (float(r["jm"]["loss"]), float(r["jm"]["grad_norm"]))
        np.testing.assert_allclose(outs[n], jl, **REL5)
    np.testing.assert_allclose(outs[1], outs[4], **REL5)
    with pytest.raises(ValueError, match="microbatches"):
        step_pair(arch, tc_kw=dict(microbatches=3), batch=8, seq=8)


def test_grad_compression_matches():
    r = step_pair("paper-100m",
                  tc_kw=dict(grad_compression="babsmax256:int8s"))
    plain = step_pair("paper-100m")
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(r["m"][k]), float(r["jm"][k]),
                                   **REL5)
    assert float(r["m"]["grad_norm"]) != float(plain["m"]["grad_norm"])


def test_run_qat_history_matches():
    cfg, jcfg = cfgs("paper-100m")
    npp = numpy_params(cfg, seed=3)
    params, jparams = both(npp)
    fn = pipeline.make_batch_fn(cfg, seq=16, batch=2, seed=2)
    jfn = jpipe.make_batch_fn(jcfg, seq=16, batch=2, seed=2)
    state, hist, plan = qat.run_qat(cfg, params, "babsmax64:int2", fn,
                                    steps=3, log_every=1)
    _, jhist, _ = jqat.run_qat(jcfg, jparams, "babsmax64:int2", jfn, steps=3,
                               log_every=1)
    assert [h["step"] for h in hist] == [h["step"] for h in jhist] == [0, 1,
                                                                        2]
    for h, jh in zip(hist, jhist):
        assert abs(h["lr"] - jh["lr"]) <= h["lr"] * 2.0 ** -22
        np.testing.assert_allclose([h["loss"], h["grad_norm"]],
                                   [jh["loss"], jh["grad_norm"]], rtol=1e-4)
    assert plan.lookup("['layers']['wq']").describe() == "babsmax64:int2"
    assert hist[1]["lr"] > 0 and int(state["opt"]["step"]) == 3


# ---------------------------------------------------------------------------
# checkpoints


def port_state(jstate):
    """The reference's state as the port's: tensors from its arrays,
    quantised moments from its codes and scales."""
    def conv(x):
        if isinstance(x, JQuantised):
            return QuantisedTensor(
                tensor_from_numpy(x.codes, "cpu"),
                tensor_from_numpy(x.scales, "cpu"), None, None, x.shape,
                x.dtype)
        return tensor_from_numpy(x, "cpu")
    return jax.tree.map(conv, jstate,
                        is_leaf=lambda x: isinstance(x, JQuantised))


def quantised_states(arch="paper-100m"):
    """A state after one Adam step with 8-bit moments (``w_gate``/``w_up``
    quantise: last dim 128), in both packages."""
    cfg, _ = cfgs(arch)
    npp = numpy_params(cfg, seed=5)
    jparams = jax.tree.map(jnp.asarray, npp)
    jac = jopt.AdamConfig(quantised_state=True, min_quant_numel=1024)
    rng = np.random.default_rng(6)
    g = map_with_paths(lambda _, x: (rng.standard_normal(x.shape) * 1e-2
                                     ).astype(np.float32), npp)
    jp2, jo2 = jopt.adam_update(jax.tree.map(jnp.asarray, g),
                                jopt.adam_init(jparams, jac), jparams, 1e-3,
                                jac)
    jstate = {"params": jp2, "opt": jo2}
    state = port_state(jstate)
    assert isinstance(state["opt"]["m"]["layers"]["w_gate"], QuantisedTensor)
    return state, jstate


def npz_arrays(path):
    with np.load(os.path.join(path, "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


def test_checkpoint_arrays_equal_across_packages(tmp_path):
    state, jstate = quantised_states()
    path = ckpt.save_checkpoint(str(tmp_path / "p"), state, 7,
                                meta={"model": "m"})
    jpath = jckpt.save_checkpoint(str(tmp_path / "j"), jstate, 7,
                                  meta={"model": "m"})
    a, b = npz_arrays(path), npz_arrays(jpath)
    assert a.keys() == b.keys() and "opt/m/layers/w_gate" in a
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with open(os.path.join(path, "manifest.json")) as f, \
            open(os.path.join(jpath, "manifest.json")) as g:
        assert json.load(f) == json.load(g)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """Reference save → port restore (into a quantised template): params
    and requantised moments equal the reference's own restore."""
    state, jstate = quantised_states()
    jpath = jckpt.save_checkpoint(str(tmp_path / "j"), jstate, 3)
    got, meta = ckpt.restore_checkpoint(jpath, template=state)
    want, jmeta = jckpt.restore_checkpoint(jpath, template=jstate)
    assert meta == jmeta and int(got["opt"]["step"]) == 1
    assert_trees_equal(got["params"], want["params"])
    for key in ("m", "v"):
        q = got["opt"][key]["layers"]["w_gate"]
        jq = want["opt"][key]["layers"]["w_gate"]
        np.testing.assert_array_equal(q.codes.numpy(), np.asarray(jq.codes))
        np.testing.assert_array_equal(q.scales.float().numpy(),
                                      np.asarray(jq.scales, np.float32))
    raw, _ = ckpt.restore_checkpoint(jpath)
    assert raw["opt"]["m"]["layers"]["w_gate"].dtype == torch.float32


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    state, jstate = quantised_states()
    path = ckpt.save_checkpoint(str(tmp_path / "p"), state, 3)
    got, _ = jckpt.restore_checkpoint(path, template=jstate)
    jpath = jckpt.save_checkpoint(str(tmp_path / "j"), jstate, 3)
    want, _ = jckpt.restore_checkpoint(jpath, template=jstate)
    assert_trees_equal(jax.tree.map(np.asarray, got["params"]),
                       want["params"])
    for key in ("m", "v"):
        np.testing.assert_array_equal(
            np.asarray(got["opt"][key]["layers"]["w_gate"].codes),
            np.asarray(want["opt"][key]["layers"]["w_gate"].codes))


def test_bf16_leaves_round_trip_without_bf16_arrays(tmp_path):
    x = torch.randn(4, 8).to(torch.bfloat16)
    path = ckpt.save_checkpoint(str(tmp_path), {"p": {"x": x}}, 1)
    assert npz_arrays(path)["p/x"].dtype == np.float32
    back, _ = ckpt.restore_checkpoint(path, template={"p": {"x": x}})
    assert back["p"]["x"].dtype == torch.bfloat16
    assert torch.equal(back["p"]["x"], x)
    # placed onto a mesh (an in-process gloo world of one rank): the
    # template's dtype, then the sharding's layout, equal once gathered
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard
    from repro_torch.launch.mesh import NamedSharding
    torch.distributed.init_process_group(
        "gloo", store=torch.distributed.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("model",))
        placed, _ = ckpt.restore_checkpoint(
            path, template={"p": {"x": x}},
            shardings={"p": {"x": NamedSharding(mesh, (Shard(0),))}})
        got = placed["p"]["x"]
        assert got.placements == (Shard(0),) and got.dtype == torch.bfloat16
        assert torch.equal(got.full_tensor(), x)
    finally:
        torch.distributed.destroy_process_group()


def test_checkpoint_atomicity(tmp_path):
    d = str(tmp_path / "ck")
    state = {"params": {"w": torch.ones(3)}}
    ckpt.save_checkpoint(d, state, 1)
    stale = os.path.join(d, "step_00000002.tmp")
    os.makedirs(stale)
    open(os.path.join(stale, "junk"), "w").close()
    assert ckpt.latest_checkpoint(d).endswith("step_00000001")
    ckpt.save_checkpoint(d, {"params": {"w": torch.full((3,), 2.0)}}, 2)
    assert not os.path.exists(stale)
    assert ckpt.latest_checkpoint(d).endswith("step_00000002")
    back, meta = ckpt.restore_checkpoint(ckpt.latest_checkpoint(d))
    assert meta["step"] == 2 and torch.equal(back["params"]["w"],
                                             torch.full((3,), 2.0))
    assert ckpt.latest_checkpoint(str(tmp_path / "none")) is None


def run_steps(cfg, steps, d="", every=0, quantised=False, state=None):
    tc = loop.TrainConfig(steps=steps, lr=1e-3, warmup=0, log_every=1,
                          ckpt_every=every, ckpt_dir=d)
    ac = optimizer.AdamConfig(quantised_state=quantised,
                              min_quant_numel=1024)
    return loop.train(cfg, tc, ac,
                      pipeline.make_batch_fn(cfg, seq=16, batch=2),
                      lr_fn=lambda s: 1e-3, state=state, device="cpu")


def test_restart_is_bit_exact(tmp_path):
    """6 steps straight == 3 steps, checkpoint, restart, 3 steps."""
    cfg = configs.get_config("paper-100m", "smoke")
    full, hist = run_steps(cfg, 6)
    d = str(tmp_path / "ck")
    run_steps(cfg, 3, d, every=3)
    resumed, rhist = run_steps(cfg, 6, d)
    assert [h["step"] for h in rhist] == [3, 4, 5]
    assert [h["loss"] for h in rhist] == [h["loss"] for h in hist[3:]]
    for (k, a), (_, b) in zip(flat_with_paths(full["params"]),
                              flat_with_paths(resumed["params"])):
        assert torch.equal(a, b), k
    assert os.listdir(os.path.join(d, "heartbeats")) == ["host_0.json"]


def test_restart_with_quantised_moments(tmp_path):
    """With 8-bit moments, a restart resumes from the saved params
    exactly (its first loss is bit-equal) and from moments requantised out
    of their f32 form. Requantising is not exact: a block whose absmax
    element rounded to a lower codepoint requantises to another scale, so
    later steps are held within 1e-4 relative (2.6e-5 seen)."""
    cfg = configs.get_config("paper-100m", "smoke")
    full, hist = run_steps(cfg, 6, quantised=True)
    d = str(tmp_path / "ck")
    run_steps(cfg, 3, d, every=3, quantised=True)
    resumed, rhist = run_steps(cfg, 6, d, quantised=True)
    assert rhist[0]["loss"] == hist[3]["loss"]
    np.testing.assert_allclose([h["loss"] for h in rhist],
                               [h["loss"] for h in hist[3:]], rtol=1e-4)
    assert isinstance(resumed["opt"]["m"]["layers"]["w_gate"],
                      QuantisedTensor)


def test_quantised_params_checkpoint(tmp_path):
    cfg = configs.get_config("paper-100m", "smoke")
    params = transformer.init(cfg, seed=0, device="cpu")
    plan = build_plan(params, "babsmax128:int8")
    path = ckpt.save_quantised_params(str(tmp_path / "q"), params, plan, 1)
    loaded = ckpt.load_quantised_params(path, plan, device="cpu")
    want = plan.dequantise(plan.quantise(params))
    for (k, a), (_, b) in zip(flat_with_paths(loaded),
                              flat_with_paths(want)):
        assert torch.equal(a, b), k
    q_bytes = os.path.getsize(os.path.join(path, "arrays.npz"))
    f32_bytes = sum(x.numel() * 4 for _, x in flat_with_paths(params))
    assert q_bytes < f32_bytes / 2.5
    # the reference reads the port's quantised checkpoint
    jparams = jax.tree.map(
        jnp.asarray, map_with_paths(lambda _, x: x.numpy(), params))
    jloaded = jckpt.load_quantised_params(path,
                                          jbuild_plan(jparams,
                                                      "babsmax128:int8"))
    assert_trees_equal(loaded, jloaded)


# ---------------------------------------------------------------------------
# fault tolerance (the reference's tests, on the port's copy)


def test_retry_recovers_and_raises():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return "ok"

    assert ft.retry(flaky, max_attempts=5) == "ok" and calls["n"] == 3
    with pytest.raises(OSError, match="disk went away"):
        ft.retry(lambda: (_ for _ in ()).throw(OSError("disk went away")),
                 max_attempts=2)
    seen = []
    with pytest.raises(ValueError, match="bad"):
        ft.retry(lambda: (_ for _ in ()).throw(ValueError("bad")),
                 max_attempts=3, on_error=lambda i, e: seen.append(i))
    assert seen == [0, 1, 2]


def test_retry_rejects_zero_attempts():
    calls = {"n": 0}

    def fn():
        calls["n"] += 1

    for bad in (0, -1):
        with pytest.raises(ValueError, match="max_attempts"):
            ft.retry(fn, max_attempts=bad)
    assert calls["n"] == 0


def test_heartbeat_and_straggler_monitor(tmp_path):
    hb = ft.Heartbeat(str(tmp_path), host_id=2)
    hb.beat(3)
    assert ft.Heartbeat.dead_hosts(str(tmp_path), timeout_s=60) == []
    dead = ft.Heartbeat.dead_hosts(str(tmp_path), timeout_s=0.0)
    assert [d[0] for d in dead] == ["host_2.json"]
    assert ft.Heartbeat.dead_hosts(str(tmp_path / "none")) == []
    mon = ft.StragglerMonitor(factor=2.0)
    for _ in range(20):
        assert not mon.record(1.0)
    assert mon.record(5.0) and mon.flagged == 1


# ---------------------------------------------------------------------------
# entry points


def test_train_cli_then_serve_from_its_checkpoint(tmp_path):
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    d = str(tmp_path / "run")
    metrics = str(tmp_path / "m.json")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state, hist = train_cli.main([
            "--arch", "paper-100m", "--variant", "smoke", "--steps", "4",
            "--batch", "2", "--seq", "16", "--log-every", "1",
            "--ckpt-dir", d, "--ckpt-every", "2", "--quantised-opt",
            "--qat", "babsmax64:n4", "--grad-compression",
            "babsmax256:int8s", "--metrics-out", metrics, "--device",
            "cpu"])
    assert "step     3" in out.getvalue()
    assert sorted(os.listdir(d)) == ["heartbeats", "step_00000002",
                                     "step_00000004"]
    with open(metrics) as f:
        assert [m["step"] for m in json.load(f)] == [0, 1, 2, 3]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        done = serve_cli.main([
            "--arch", "paper-100m", "--variant", "smoke", "--ckpt", d,
            "--quantise", "babsmax64:n4", "--packed", "--requests", "2",
            "--max-new", "3", "--device", "cpu"])
    assert "step_00000004 (step 4)" in out.getvalue()
    assert len(done) == 2 and all(len(g.tokens) == 3 for g in done)
    # the served weights are the checkpoint's: greedy tokens follow them
    cfg = configs.get_config("paper-100m", "smoke")
    with contextlib.redirect_stdout(io.StringIO()):
        again = serve_cli.main([
            "--arch", "paper-100m", "--variant", "smoke", "--ckpt",
            os.path.join(d, "step_00000004"), "--quantise", "babsmax64:n4",
            "--packed", "--requests", "2", "--max-new", "3", "--device",
            "cpu"])
    assert [g.tokens for g in again] == [g.tokens for g in done]
    with pytest.raises(SystemExit, match="do not match"):
        serve_cli.main(["--arch", "gemma3-1b", "--variant", "smoke",
                        "--ckpt", d, "--device", "cpu"])
    assert cfg.name
