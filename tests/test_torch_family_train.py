"""Port vs reference: one train step of every family besides the dense
transformer (qwen2-moe's routed experts, whisper's encoder-decoder,
internvl's visual prefix, rwkv6's WKV, zamba2's SSD and shared block), a
QAT distillation step and the KV-cache Fisher of zamba2.

The same seeded numpy weights (each family's own fixed leaves through its
``finish_leaf``) and the same batch (``make_batch_fn``: tokens, whisper's
frames, internvl's patches) go through ``repro.train.loop.make_train_step``
(JAX) and ``repro_torch.train.loop.make_train_step`` at smoke size, in f32.
Tolerances: loss and grad_norm of a CE step 1e-5 relative; a QAT step's KL
1e-4 relative and the student's codes bit-identical; the KV Fisher's
``numel`` equal, ``rms`` and ``fisher_mean`` 1e-5 relative with the same
labels on both sides. Last, the thread-local hooks through which
``chip_smoke.py`` holds these steps on the card against the CPU."""
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import build_plan as jbuild_plan
from repro.core import fisher as jfisher
from repro.data import pipeline as jpipe
from repro.train import loop as jloop
from repro.train import optimizer as jopt

from repro_torch import configs
from repro_torch.core import build_plan, fisher
from repro_torch.core.plan import flat_with_paths, map_with_paths
from repro_torch.data import pipeline
from repro_torch.interop import params_from_numpy
from repro_torch.models.api import get_family
from repro_torch.train import loop, optimizer

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

ARCHS = ["qwen2-moe-a2.7b", "whisper-large-v3", "internvl2-26b",
         "rwkv6-1.6b", "zamba2-2.7b"]
REL5 = dict(rtol=1e-5, atol=0)


@pytest.fixture(autouse=True)
def one_thread():
    """Smoke tensors: one intra-op thread runs them as fast, and beside
    other test workers it spares the OpenMP spin waits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(arch):
    return (configs.get_config(arch, "smoke").replace(dtype="float32"),
            jconfigs.get_config(arch, "smoke").replace(dtype="float32"))


def numpy_params(cfg, seed=0):
    """Seeded numpy weights over ``get_family(cfg.family).param_specs``:
    the leaves the family fixes (rwkv6's w0 and mu, zamba2's SSM vectors
    and conv taps) as its ``finish_leaf`` gives them, gains around 1,
    fan-in scaled matrices, a 0.5-std embedding so the logits have
    margins."""
    fam = get_family(cfg.family)
    rng = np.random.default_rng(seed)

    def make(path, spec):
        if fam.finish_leaf is not None:
            probe = torch.zeros(spec.shape)
            fixed = fam.finish_leaf(cfg, path, probe)
            if fixed is not probe:
                return fixed.numpy().astype(np.float32)
        if "norm" in path or "ln_x" in path:
            return (1 + 0.1 * rng.standard_normal(spec.shape)
                    ).astype(np.float32)
        std = 0.5 if "embed" in path else \
            1 / np.sqrt(spec.numel // spec.shape[-1])
        return (rng.standard_normal(spec.shape) * std).astype(np.float32)
    return map_with_paths(make, fam.param_specs(cfg))


def step_pair(arch, plan_spec=None, distill=False):
    """One train step of each package from the same params and batch
    (B 2, T 16); a distillation step starts its student at the teacher."""
    cfg, jcfg = cfgs(arch)
    npp = numpy_params(cfg)
    params = params_from_numpy(npp, "cpu")
    jparams = jax.tree.map(jnp.asarray, npp)
    b = pipeline.make_batch_fn(cfg, seq=16, batch=2, seed=1)(0)
    jb = jpipe.make_batch_fn(jcfg, seq=16, batch=2, seed=1)(0)
    assert b.keys() == jb.keys()
    for k in b:
        np.testing.assert_array_equal(b[k], jb[k])
    plan = build_plan(params, plan_spec) if plan_spec else None
    jplan = jbuild_plan(jparams, plan_spec) if plan_spec else None
    ac, jac = optimizer.AdamConfig(), jopt.AdamConfig()
    step = loop.make_train_step(cfg, ac, loop.TrainConfig(), lambda s: 1e-3,
                                qat_plan=plan, distill=distill)
    jstep = jloop.make_train_step(jcfg, jac, jloop.TrainConfig(),
                                  lambda s: 1e-3, qat_plan=jplan,
                                  distill=distill)
    student = map_with_paths(lambda _, x: x.clone(), params)
    state = {"params": student, "opt": optimizer.adam_init(student, ac)}
    jstate = {"params": jparams, "opt": jopt.adam_init(jparams, jac)}
    _, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()},
                *((params,) if distill else ()))
    _, jm = jax.jit(jstep)(jstate, {k: jnp.asarray(v) for k, v in jb.items()},
                           *((jparams,) if distill else ()))
    return dict(m=m, jm=jm, params=params, jparams=jparams, plan=plan,
                jplan=jplan)


@pytest.mark.parametrize("arch", ARCHS)
def test_ce_step_loss_and_grad_norm_match(arch):
    r = step_pair(arch)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(r["m"][k]), float(r["jm"][k]),
                                   err_msg=k, **REL5)
    assert np.isfinite(float(r["m"]["loss"]))
    assert float(r["m"]["grad_norm"]) > 0


# planned tensors each family's QAT case must cover: zamba2's Mamba-2 and
# shared-block matrices, qwen2-moe's expert stacks (a lead dim of experts)
# and embedding tables, internvl's vision projection and tables
QAT_COVERS = {
    "zamba2-2.7b": {"['mamba']['in_proj']", "['shared']['wq']"},
    "qwen2-moe-a2.7b": {"['layers']['we_gate']", "['layers']['we_down']",
                        "['embed']", "['unembed']"},
    "internvl2-26b": {"['vis_proj1']", "['layers']['w_up']", "['embed']",
                      "['unembed']"},
}


@pytest.mark.parametrize("arch", list(QAT_COVERS))
def test_zamba2_qat_distill_step_matches(arch):
    """babsmax64:int2 fake-quant with the STE over the family's planned
    matrices (``QAT_COVERS``; the test began with zamba2 and now holds the
    MoE and VLM families too): the KL to the teacher and its gradient
    norm, and the codes the student's forward rounds to, bit for bit."""
    r = step_pair(arch, plan_spec="babsmax64:int2", distill=True)
    kl, jkl = float(r["m"]["loss"]), float(r["jm"]["loss"])
    assert kl > 1e-4
    np.testing.assert_allclose(kl, jkl, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(float(r["m"]["grad_norm"]),
                               float(r["jm"]["grad_norm"]), rtol=1e-4)
    q = dict(flat_with_paths(r["plan"].quantise(r["params"])))
    jq = {jax.tree_util.keystr(p): x for p, x in
          jax.tree_util.tree_flatten_with_path(
              jax.jit(r["jplan"].quantise)(r["jparams"]),
              is_leaf=lambda x: hasattr(x, "codes"))[0]}
    names = [n for n, f in r["plan"].formats.items() if f is not None]
    assert QAT_COVERS[arch] <= set(names)
    for name in names:
        np.testing.assert_array_equal(q[name].codes.numpy(),
                                      np.asarray(jq[name].codes),
                                      err_msg=name)


def test_zamba2_kv_fisher_with_the_same_labels(monkeypatch):
    """``--kv-format auto``'s calibration on zamba2 (one group: the shared
    block's cache at each of its points): the Fisher statistics equal the
    reference's when both sample the same labels."""
    cfg, jcfg = cfgs("zamba2-2.7b")
    npp = numpy_params(cfg)
    y = np.random.default_rng(16).integers(0, cfg.vocab, (2,))
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, axis=-1: jnp.asarray(y))
    monkeypatch.setattr(fisher, "_sample_labels",
                        lambda logits, generator: torch.from_numpy(y).long())
    kw = dict(batch_size=2, kv_len=16, warm_steps=6, samples=2)
    want = jfisher.estimate_kv_fisher(jcfg, jax.tree.map(jnp.asarray, npp),
                                      **kw)
    got = fisher.estimate_kv_fisher(cfg, params_from_numpy(npp, "cpu"), **kw)
    assert list(got) == list(want) and got
    for g in got:
        assert got[g]["numel"] == want[g]["numel"]
        for key in ("rms", "fisher_mean"):
            np.testing.assert_allclose(got[g][key], want[g][key],
                                       err_msg=(g, key), **REL5)


def test_card_run_hooks_act_for_their_thread_alone():
    """``chip_smoke.py``'s stand-ins for ``adam_update`` and
    ``_sample_labels`` (its card run holds on a worker thread while the
    main thread trains): the thread that arms one gets the gradients kept
    and the update skipped, or the labels drawn from numpy; another thread
    gets the originals; both are restored after."""
    params = {"w": torch.ones(4, 3)}
    grads = {"w": torch.full((4, 3), 0.5)}
    opt = optimizer.adam_init(params, optimizer.AdamConfig())
    logits = torch.zeros(2, 5, 7)

    def step(state, batch):
        new, _ = loop.adam_update(grads, state["opt"], state["params"], 0.1,
                                  optimizer.AdamConfig())
        return {"params": new}, {"loss": torch.tensor(1.5)}

    def other_thread(out):
        out["moved"] = not torch.equal(loop.adam_update(
            grads, opt, params, 0.1, optimizer.AdamConfig())[0]["w"],
            params["w"])
        out["labels"] = fisher._sample_labels(
            logits, torch.Generator().manual_seed(0))

    update, sample = loop.adam_update, fisher._sample_labels
    with chip_smoke.ThreadHooks() as hooks:
        seen = {}
        got = hooks.pinned(lambda: fisher._sample_labels(logits, None), 5)
        np.testing.assert_array_equal(
            got.numpy(), np.random.default_rng(5).integers(0, 7, (2, 5)))
        hooks.local.grads, hooks.local.seed = [], 5   # this thread armed
        worker = threading.Thread(target=other_thread, args=(seen,))
        worker.start()
        worker.join()
        hooks.local.grads = hooks.local.seed = None
        assert seen["moved"] and seen["labels"].shape == (2, 5)
        m, kept = hooks.spied_step(step, {"params": params, "opt": opt}, {})
        assert m == {"loss": 1.5} and kept is grads
    assert loop.adam_update is update and fisher._sample_labels is sample


def test_kv_fisher_runs_in_threads_at_once():
    """``estimate_kv_fisher`` called from several threads at once (the card
    run's serve beside its CPU hold) gives each the single call's
    statistics: its graphs, recorded under process-wide autograd state,
    are taken one at a time."""
    cfg = configs.get_config("zamba2-2.7b", "smoke")
    params = get_family(cfg.family).init(cfg, seed=0, device="cpu")
    want = fisher.estimate_kv_fisher(cfg, params, batch_size=2, kv_len=32)
    got, errors = [], []

    def call():
        try:
            got.append(fisher.estimate_kv_fisher(cfg, params, batch_size=2,
                                                 kv_len=32))
        except Exception as e:   # noqa: BLE001 -- reported below
            errors.append(repr(e))
    threads = [threading.Thread(target=call) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and got == [want] * 3
