"""A dropped ``ServeEngine`` is freed at once, with the cycle collector off.

The device step (``_step``) and the cross-attention prefill are methods
bound late to ``engine.fam``; the fault injectors wrap them on the
instance through a weak reference; the ``Scheduler``'s engine hooks and
its handle registry are weak. So nothing the engine holds refers back to
it, and on the card a dropped engine gives its memory back on ``del``
(``chip_smoke.py`` checks that there). Each case runs with ``gc.disable()``
and checks that a ``weakref`` to the engine dies on ``del``: a packed
paper-100m smoke engine after ``run()``, under ``Scheduler`` after a
traffic replay, and after each engine drill of ``serve.faults``. The
``corrupt_*`` injectors act on a params tree and build no engine. Last,
the late binding: a family replaced after construction is the one that
steps."""
import dataclasses
import gc
import warnings
import weakref

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import build_plan
from repro_torch.core.plan import map_with_paths
from repro_torch.interop import params_from_numpy
from repro_torch.models import transformer
from repro_torch.serve import faults, traffic
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.scheduler import Scheduler

CFG = configs.get_config("paper-100m", "smoke").replace(dtype="float32",
                                                        param_dtype="float32")
ENG_KW = dict(batch_slots=3, kv_len=64, prefill_chunk=4, device="cpu")


@pytest.fixture(scope="module")
def ckpt():
    rng = np.random.default_rng(0)

    def make(path, spec):
        if "norm" in path:
            return (1 + 0.1 * rng.standard_normal(spec.shape)
                    ).astype(np.float32)
        std = 0.02 if "embed" in path else \
            1 / np.sqrt(spec.numel // spec.shape[-1])
        return (rng.standard_normal(spec.shape) * std).astype(np.float32)
    params = params_from_numpy(
        map_with_paths(make, transformer.param_specs(CFG)), "cpu")
    plan = build_plan(params, "babsmax32:n4")
    return plan, plan.quantise(params)


@pytest.fixture(autouse=True)
def one_thread():
    """Smoke tensors: one intra-op thread runs them as fast, and beside
    other test workers it spares the OpenMP spin waits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_collector():
    gc.collect()
    gc.disable()
    yield
    gc.enable()
    gc.collect()


def _submit(eng, n=3, max_new=5):
    for r in range(n):
        eng.submit(Request(prompt=[1 + r, 2, 3, 4], max_new_tokens=max_new,
                           rid=r))


def _run(obj):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return obj.run()


def plain(eng):
    _submit(eng)
    return {"done": len(_run(eng))}


def scheduler(eng):
    spec = traffic.TrafficSpec(vocab=CFG.vocab, n_requests=6,
                               prefixes=(("sys", 6, 1.0),),
                               fault_nan=((1, 4, 2),))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        report = traffic.replay(eng, traffic.generate(spec))
    handle = report.scheduler.submit([5, 6, 7], max_new_tokens=3)
    return {"done": report.metrics["completed"],
            "forks": report.metrics["forks"],
            "streamed": len(handle.result().tokens)}


def nan_logits(eng):
    _submit(eng)
    ctr = faults.inject_nan_logits(eng, slot=0, at_step=2)
    failed = sum(g.failed for g in _run(eng))
    return {"injected": ctr["injected"], "failed": failed}


def step_failures(eng):
    eng.step_retries = 2
    _submit(eng)
    ctr = faults.inject_step_failures(eng, {1})
    done = len(_run(eng))
    return {"raised": ctr["raised"], "done": done}


def step_failures_dense_fallback(eng):
    eng.dense_fallback = True
    _submit(eng)
    ctr = faults.inject_step_failures(eng, {1})
    _run(eng)
    return {"raised": ctr["raised"], "degraded": eng.degraded}


def slow_steps(eng):
    _submit(eng)
    ctr = faults.inject_slow_steps(eng, {0}, delay_s=0.01)
    _run(eng)
    return {"slowed": ctr["slowed"]}


def drop_admissions(eng):
    _submit(eng)
    dropped = faults.drop_admissions(eng, {1})
    return {"done": len(_run(eng)), "dropped": len(dropped)}


def duplicate_admissions(eng):
    _submit(eng, n=1)
    state = faults.duplicate_admissions(eng, {0})
    return {"done": len(_run(eng)), "duplicated": state["duplicated"]}


def stacked_injectors(eng):
    eng.step_retries = 2
    _submit(eng)
    nan = faults.inject_nan_logits(eng, slot=1, at_step=3)
    fail = faults.inject_step_failures(eng, {0})
    slow = faults.inject_slow_steps(eng, {2}, delay_s=0.01)
    dropped = faults.drop_admissions(eng, {2})
    dup = faults.duplicate_admissions(eng, {0})
    _run(eng)
    return {"injected": nan["injected"], "raised": fail["raised"],
            "slowed": slow["slowed"], "dropped": len(dropped),
            "duplicated": dup["duplicated"]}


CASES = {
    plain: {"done": 3},
    scheduler: {"done": 5, "forks": 3, "streamed": 3},
    nan_logits: {"injected": 1, "failed": 1},
    step_failures: {"raised": 1, "done": 3},
    step_failures_dense_fallback: {"raised": 1, "degraded": True},
    slow_steps: {"slowed": 1},
    drop_admissions: {"done": 2, "dropped": 1},
    duplicate_admissions: {"done": 2, "duplicated": 1},
    stacked_injectors: {"injected": 1, "raised": 1, "slowed": 1,
                        "dropped": 1, "duplicated": 1},
}


@pytest.mark.parametrize("drive", list(CASES), ids=lambda f: f.__name__)
def test_dropped_engine_is_freed_without_the_collector(drive, ckpt,
                                                       no_collector):
    plan, q = ckpt
    eng = ServeEngine.from_quantised(CFG, q, plan, **ENG_KW)
    assert drive(eng) == CASES[drive]
    gone = weakref.ref(eng)
    state = weakref.ref(eng._state["pos"])
    del eng
    assert gone() is None, "the dropped engine is still referenced"
    assert state() is None, "the dropped engine's state is still referenced"


def test_a_family_replaced_after_construction_steps(ckpt, no_collector):
    """The late binding of ``_step`` to ``engine.fam``: a recorder swapped
    in after construction (as ``chip_smoke.py`` does) is called, and the
    engine is still freed on ``del`` once the recorder is swapped out."""
    plan, q = ckpt
    eng = ServeEngine.from_quantised(CFG, q, plan, **ENG_KW)
    calls = []
    step = eng.fam.decode_step

    def recording(params, state, batch, cfg):
        calls.append(int(batch["tokens"].shape[1]))
        return step(params, state, batch, cfg)
    eng.fam = dataclasses.replace(eng.fam, decode_step=recording)
    _submit(eng, n=1, max_new=3)
    assert len(_run(eng)[0].tokens) == 3
    assert calls == [4, 1, 1]
    eng.fam = dataclasses.replace(eng.fam, decode_step=step)
    gone = weakref.ref(eng)
    del eng
    assert gone() is None


def test_a_dropped_scheduler_leaves_a_plain_engine(ckpt, no_collector):
    """The scheduler's hooks hold it weakly: once it is dropped the engine
    serves its own queue as a plain engine, and a handle a caller keeps
    keeps its scheduler (and so the engine) alive."""
    plan, q = ckpt
    eng = ServeEngine.from_quantised(CFG, q, plan, **ENG_KW)
    sched = Scheduler(eng)
    handle = sched.submit([1, 2, 3], max_new_tokens=2)
    gone_sched = weakref.ref(sched)
    del sched
    assert gone_sched() is not None              # the handle keeps it
    assert len(handle.result().tokens) == 2
    del handle
    assert gone_sched() is None
    _submit(eng, n=2, max_new=2)
    assert len(_run(eng)) == 2
    gone = weakref.ref(eng)
    del eng
    assert gone() is None
