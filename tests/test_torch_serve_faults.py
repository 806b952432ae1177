"""The port's serving fault tolerance (``serve.faults`` and the engine's
robustness ladder) against the JAX package's.

Every case of ``tests/test_serve_faults.py`` runs on the port: checkpoint
integrity rejection by tensor name, slot quarantine with bitwise-equal
survivors, deadlines, the run() watchdog, the straggler monitor, step
retry, the dense fallback, admission faults. Across packages, the
injectors' target paths and the ``IntegrityError`` messages equal the
reference's for the same quantised tree. The port's cache writes are in
place, so a step that fails *after* it has written the cache and is then
retried must still give the tokens of a clean run."""
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.core import IntegrityError as JIntegrityError
from repro.core import build_plan as jbuild_plan
from repro.models import api as jmapi
from repro.serve import faults as jfaults
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch import configs
from repro_torch.core import IntegrityError, build_plan, verify_packed_tree
from repro_torch.core.plan import map_with_paths
from repro_torch.interop import params_from_numpy
from repro_torch.models import api as mapi
from repro_torch.models import transformer
from repro_torch.serve import faults
from repro_torch.serve.engine import Request, ServeEngine

CFG = configs.get_config("paper-100m", "smoke").replace(dtype="float32",
                                                        param_dtype="float32")
FMT = "babsmax32:n4"        # 4-bit nibble-packed serving checkpoint
FMT_8BIT = "babsmax32:n5"   # 32-point codebook → uint8 codes (range faults)
ENG_KW = dict(batch_slots=3, kv_len=64, prefill_chunk=4, device="cpu")


def numpy_params(cfg, seed=0, embed_std=0.02):
    """Seeded numpy weights (norm gains around 1, fan-in scaled matrices)."""
    rng = np.random.default_rng(seed)

    def make(path, spec):
        if "norm" in path:
            return (1 + 0.1 * rng.standard_normal(spec.shape)
                    ).astype(np.float32)
        std = embed_std if "embed" in path else \
            1 / np.sqrt(spec.numel // spec.shape[-1])
        return (rng.standard_normal(spec.shape) * std).astype(np.float32)
    return map_with_paths(make, transformer.param_specs(cfg))


@pytest.fixture(scope="module")
def np_params():
    return numpy_params(CFG)


@pytest.fixture(scope="module")
def ckpt(np_params):
    params = params_from_numpy(np_params, "cpu")
    plan = build_plan(params, FMT)
    return plan, plan.quantise(params), params


def _engine(plan, q, **kw):
    return ServeEngine.from_quantised(CFG, q, plan, **{**ENG_KW, **kw})


def _quiet_run(eng, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return eng.run(**kw)


def _reqs(n, max_new=6):
    return [Request(prompt=[1 + r, 2, 3, 4], max_new_tokens=max_new, rid=r)
            for r in range(n)]


def _submit_all(eng, reqs):
    for r in reqs:
        eng.submit(Request(prompt=list(r.prompt),
                           max_new_tokens=r.max_new_tokens, rid=r.rid,
                           deadline_steps=r.deadline_steps))


class TestIntegrityValidation:
    def test_clean_checkpoint_loads_and_counts_leaves(self, ckpt):
        plan, q, _ = ckpt
        assert verify_packed_tree(_engine(plan, q).params) >= 1

    def test_corrupt_scales_rejected_naming_tensor(self, ckpt):
        plan, q, _ = ckpt
        tensor = faults.packed_paths(q)[0]
        bad = faults.corrupt_scales(q, tensor)
        with pytest.raises(IntegrityError) as ei:
            _engine(plan, bad)
        assert tensor in str(ei.value)
        assert "scales" in str(ei.value)

    def test_corrupt_codes_rejected_naming_tensor(self, ckpt):
        plan, q, params = ckpt
        plan8 = build_plan(params, FMT_8BIT)
        q8 = plan8.quantise(params)
        tensor = faults.packed_paths(q8)[0]
        with pytest.raises(IntegrityError) as ei:
            _engine(plan8, faults.corrupt_codes(q8, tensor))
        assert tensor in str(ei.value)
        assert "out of codebook range" in str(ei.value)

    def test_corrupt_layout_rejected(self, ckpt):
        plan, q, _ = ckpt
        layouts = mapi.get_family(CFG.family).pack_layouts(CFG)
        packed = plan.pack_quantised(q, layouts)
        tensor = faults.packed_paths(packed)[0]
        with pytest.raises(IntegrityError) as ei:
            verify_packed_tree(faults.corrupt_layout(packed, tensor))
        assert tensor in str(ei.value)

    def test_validate_false_escape_hatch(self, ckpt):
        plan, q, _ = ckpt
        bad = faults.corrupt_scales(q, faults.packed_paths(q)[0])
        eng = ServeEngine.from_quantised(CFG, bad, plan, validate=False,
                                         **ENG_KW)
        assert eng._has_packed()  # loaded without the integrity pass

    def test_unknown_target_lists_paths(self, ckpt):
        _, q, _ = ckpt
        with pytest.raises(KeyError) as ei:
            faults.corrupt_scales(q, "['nonexistent']")
        assert "embed" in str(ei.value) and "targets" in str(ei.value)

    def test_corruption_leaves_the_source_tree_intact(self, ckpt):
        plan, q, _ = ckpt
        tensor = faults.packed_paths(q)[0]
        faults.corrupt_scales(q, tensor)
        faults.corrupt_codes(q, tensor, byte=0x11)
        assert verify_packed_tree(_engine(plan, q).params) >= 1


class TestAgainstTheReference:
    """The same quantised tree in both packages: the same target paths and
    the same IntegrityError, word for word."""

    @pytest.fixture(scope="class")
    def both(self, np_params):
        jparams = jax.tree.map(jnp.asarray, np_params)
        params = params_from_numpy(np_params, "cpu")
        out = {}
        for fmt in (FMT, FMT_8BIT):
            jplan, plan = jbuild_plan(jparams, fmt), build_plan(params, fmt)
            out[fmt] = (jplan, jplan.quantise(jparams), plan,
                        plan.quantise(params))
        return out

    def test_packed_paths_equal(self, both):
        jplan, jq, plan, q = both[FMT]
        assert faults.packed_paths(q) == jfaults.packed_paths(jq)
        layouts = mapi.get_family(CFG.family).pack_layouts(CFG)
        jlayouts = jmapi.get_family(CFG.family).pack_layouts(CFG)
        assert (faults.packed_paths(plan.pack_quantised(q, layouts))
                == jfaults.packed_paths(jplan.pack_quantised(jq, jlayouts)))

    @pytest.mark.parametrize("fault, fmt", [("scales", FMT),
                                            ("codes", FMT_8BIT)])
    def test_integrity_error_equal(self, both, fault, fmt):
        jplan, jq, plan, q = both[fmt]
        jcfg = jconfigs.get_config("paper-100m", "smoke").replace(
            dtype="float32", param_dtype="float32")
        msgs = []
        for mod, tree, make in (
                (jfaults, jq, lambda t: JServeEngine.from_quantised(
                    jcfg, t, jplan, batch_slots=3, kv_len=64)),
                (faults, q, lambda t: _engine(plan, t))):
            path = mod.packed_paths(tree)[1]
            bad = getattr(mod, f"corrupt_{fault}")(tree, path)
            with pytest.raises((IntegrityError, JIntegrityError)) as ei:
                make(bad)
            msgs.append((path, str(ei.value)))
        assert msgs[0] == msgs[1]


class TestSubmitValidation:
    def test_empty_prompt_rejected(self, ckpt):
        plan, q, _ = ckpt
        with pytest.raises(ValueError, match="empty prompt"):
            _engine(plan, q).submit(Request(prompt=[], max_new_tokens=4))

    def test_nonpositive_max_new_rejected(self, ckpt):
        plan, q, _ = ckpt
        eng = _engine(plan, q)
        for bad in (0, -3):
            with pytest.raises(ValueError, match="max_new_tokens"):
                eng.submit(Request(prompt=[1, 2], max_new_tokens=bad))

    def test_bad_deadline_rejected(self, ckpt):
        plan, q, _ = ckpt
        with pytest.raises(ValueError, match="deadline_steps"):
            _engine(plan, q).submit(Request(prompt=[1, 2], max_new_tokens=4,
                                            deadline_steps=0))

    def test_duplicate_rid_warns(self, ckpt):
        plan, q, _ = ckpt
        eng = _engine(plan, q)
        eng.submit(Request(prompt=[1, 2], max_new_tokens=2, rid=7))
        with pytest.warns(RuntimeWarning, match="rid=7"):
            eng.submit(Request(prompt=[3, 4], max_new_tokens=2, rid=7))

    def test_distinct_rids_do_not_warn(self, ckpt):
        plan, q, _ = ckpt
        eng = _engine(plan, q)
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            eng.submit(Request(prompt=[1, 2], max_new_tokens=2, rid=1))
            eng.submit(Request(prompt=[3, 4], max_new_tokens=2, rid=2))


class TestSlotQuarantine:
    def test_nan_quarantines_only_offending_slot(self, ckpt):
        plan, q, _ = ckpt
        eng_ref, eng_hit = _engine(plan, q), _engine(plan, q)
        _submit_all(eng_ref, _reqs(3))
        _submit_all(eng_hit, _reqs(3))
        ctr = faults.inject_nan_logits(eng_hit, slot=0, at_step=2)
        ref = {g.rid: g for g in _quiet_run(eng_ref)}
        with pytest.warns(RuntimeWarning, match="quarantined slot 0"):
            hit = {g.rid: g for g in eng_hit.run()}
        assert ctr["injected"] == 1
        assert len(hit) == len(ref) == 3  # nothing silently lost
        failed = [g for g in hit.values() if g.failed]
        assert len(failed) == 1 and failed[0].rid == 0
        assert not failed[0].done
        assert "non-finite logits" in failed[0].fail_reason
        for g in hit.values():
            if g.failed:
                assert g.tokens == ref[g.rid].tokens[:len(g.tokens)]
            else:
                assert g.done and g.tokens == ref[g.rid].tokens

    def test_slot_reused_after_quarantine_is_clean(self, ckpt):
        plan, q, _ = ckpt
        eng = _engine(plan, q, batch_slots=1)
        eng.submit(Request(prompt=[5, 6, 7], max_new_tokens=8, rid=0))
        eng.submit(Request(prompt=[8, 9], max_new_tokens=4, rid=1))
        faults.inject_nan_logits(eng, slot=0, at_step=1)
        gens = {g.rid: g for g in _quiet_run(eng)}
        assert gens[0].failed and not gens[1].failed
        fresh = _engine(plan, q, batch_slots=1)
        fresh.submit(Request(prompt=[8, 9], max_new_tokens=4, rid=1))
        assert gens[1].tokens == fresh.run()[0].tokens

    def test_deadline_quarantines_runaway_request(self, ckpt):
        plan, q, _ = ckpt
        eng = _engine(plan, q)
        eng.submit(Request(prompt=[1, 2, 3], max_new_tokens=30,
                           deadline_steps=3, rid=0))
        eng.submit(Request(prompt=[4, 5, 6], max_new_tokens=4, rid=1))
        gens = {g.rid: g for g in _quiet_run(eng)}
        assert gens[0].failed and "deadline_steps=3" in gens[0].fail_reason
        assert len(gens[0].tokens) < 30
        assert gens[1].done and not gens[1].failed

    def test_no_deadline_by_default(self, ckpt):
        plan, q, _ = ckpt
        eng = _engine(plan, q)
        eng.submit(Request(prompt=[1, 2, 3], max_new_tokens=6, rid=0))
        (g,) = eng.run()
        assert g.done and not g.failed and len(g.tokens) == 6


class TestRunExpiryUnderFaults:
    def test_resume_after_quarantine_is_bit_identical(self, ckpt):
        plan, q, _ = ckpt
        eng_ref, eng_hit = _engine(plan, q), _engine(plan, q)
        reqs = _reqs(3, max_new=8)
        _submit_all(eng_ref, reqs)
        _submit_all(eng_hit, reqs)
        faults.inject_nan_logits(eng_hit, slot=0, at_step=2)
        ref = {g.rid: g for g in _quiet_run(eng_ref)}
        first = _quiet_run(eng_hit, max_steps=3)   # expires mid-wave
        assert any(g.failed for g in first)
        assert any(not g.done and not g.failed for g in first)
        rest = _quiet_run(eng_hit)
        final = {g.rid: g for g in rest if g.done}
        assert set(final) == {1, 2}
        for rid, g in final.items():
            assert g.tokens == ref[rid].tokens


class TestWatchdog:
    def test_deadline_s_returns_resumable_partials(self, ckpt):
        plan, q, _ = ckpt
        eng_ref, eng_hit = _engine(plan, q), _engine(plan, q)
        reqs = _reqs(2, max_new=6)
        _submit_all(eng_ref, reqs)
        _submit_all(eng_hit, reqs)
        ref = {g.rid: g.tokens for g in _quiet_run(eng_ref)}
        orig_step = eng_hit._step
        faults.inject_slow_steps(eng_hit, range(100), delay_s=0.2)
        with pytest.warns(RuntimeWarning, match="watchdog"):
            partial = eng_hit.run(deadline_s=0.3)
        assert partial and all(not g.done for g in partial)
        eng_hit._step = orig_step
        done = {g.rid: g.tokens for g in _quiet_run(eng_hit)}
        assert done == ref

    def test_straggler_monitor_records_steps(self, ckpt):
        plan, q, _ = ckpt
        eng = _engine(plan, q)
        eng.submit(Request(prompt=[1, 2, 3], max_new_tokens=4, rid=0))
        eng.run()
        assert len(eng.straggler._times) > 0

    def test_straggler_monitor_flags_a_stall(self, ckpt):
        """A stall three times the slowest step so far is recorded and
        flagged, however loaded the host is (the monitor's window needs 8
        steps before it flags)."""
        plan, q, _ = ckpt
        eng = _engine(plan, q)
        eng.submit(Request(prompt=[1, 2, 3], max_new_tokens=14, rid=0))
        _quiet_run(eng, max_steps=10)
        delay = 3 * max(eng.straggler._times)
        ctr = faults.inject_slow_steps(eng, {0}, delay_s=delay)
        (g,) = eng.run()
        assert g.done and len(g.tokens) == 14
        assert ctr["slowed"] == 1 and eng.straggler.flagged >= 1
        assert max(eng.straggler._times) >= delay


class TestStepRetryAndFallback:
    def test_retry_absorbs_transient_failure(self, ckpt):
        plan, q, _ = ckpt
        eng_ref = _engine(plan, q)
        eng_hit = _engine(plan, q, step_retries=3)
        for e in (eng_ref, eng_hit):
            e.submit(Request(prompt=[5, 6, 7], max_new_tokens=6, rid=0))
        ctr = faults.inject_step_failures(eng_hit, {1})
        a = eng_ref.run()[0].tokens
        b = eng_hit.run()[0].tokens
        assert ctr["raised"] == 1
        assert not eng_hit.degraded       # retry succeeded, no fallback
        assert a == b

    def test_persistent_failure_degrades_to_dense(self, ckpt):
        plan, q, _ = ckpt
        eng_ref = _engine(plan, q)
        eng_hit = _engine(plan, q, dense_fallback=True)
        for e in (eng_ref, eng_hit):
            e.submit(Request(prompt=[5, 6, 7], max_new_tokens=6, rid=0))
        faults.inject_step_failures(eng_hit, {1})
        a = eng_ref.run()[0].tokens
        with pytest.warns(RuntimeWarning, match="degraded mode"):
            b = eng_hit.run()[0].tokens
        assert eng_hit.degraded
        assert not eng_hit._has_packed()  # every leaf dequantised
        assert a == b

    def test_fallback_disabled_propagates(self, ckpt):
        plan, q, _ = ckpt
        eng = _engine(plan, q, dense_fallback=False)
        eng.submit(Request(prompt=[1, 2], max_new_tokens=4, rid=0))
        faults.inject_step_failures(eng, {0})
        with pytest.raises(RuntimeError, match="injected"):
            eng.run()

    def test_fallback_is_off_by_default(self, ckpt):
        # unlike the reference's engine: a failing kernel must surface
        plan, q, _ = ckpt
        eng = _engine(plan, q)
        assert eng.dense_fallback is False
        eng.submit(Request(prompt=[1, 2], max_new_tokens=4, rid=0))
        faults.inject_step_failures(eng, {1})
        with pytest.raises(RuntimeError, match="injected"):
            eng.run()
        assert not eng.degraded and eng._has_packed()

    def test_manual_degrade_is_idempotent(self, ckpt):
        plan, q, _ = ckpt
        eng_ref, eng_hit = _engine(plan, q), _engine(plan, q)
        with pytest.warns(RuntimeWarning, match="degraded mode"):
            eng_hit.degrade_to_dense(reason="test kill-switch")
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            eng_hit.degrade_to_dense()    # second call: silent no-op
        for e in (eng_ref, eng_hit):
            e.submit(Request(prompt=[7, 8, 9], max_new_tokens=6, rid=0))
        assert eng_ref.run()[0].tokens == eng_hit.run()[0].tokens

    @pytest.mark.parametrize("retries", [0, -1])
    def test_bad_step_retries_rejected(self, ckpt, retries):
        plan, q, _ = ckpt
        with pytest.raises(ValueError, match="step_retries"):
            _engine(plan, q, step_retries=retries)


def fail_after_write(engine, steps):
    """Raise from the device step at each index in ``steps`` *after* the
    inner step has run, so its in-place cache writes have landed."""
    inner = engine._step
    ctr = {"step": 0, "raised": 0}

    def wrapped(p, s, b):
        out = inner(p, s, b)
        step = ctr["step"]
        ctr["step"] += 1
        if step in steps:
            ctr["raised"] += 1
            raise RuntimeError(f"injected failure after step {step}")
        return out

    engine._step = wrapped
    return ctr


@pytest.mark.parametrize("arch, kv", [("paper-100m", ""),
                                      ("gemma3-1b", "q8"),
                                      ("gemma3-1b", "q4")])
def test_retry_after_cache_write_is_exact(arch, kv):
    """Failures after the cache write at a reset-carrying prefill step, a
    later prefill step, decode steps and (gemma3: 20-slot rings, 26-token
    prompt) steps past the ring's wrap: retried, the run's tokens equal a
    clean run's bit for bit."""
    cfg = configs.get_config(arch, "smoke").replace(
        dtype="float32", param_dtype="float32", kv_format=kv)
    params = params_from_numpy(numpy_params(cfg, seed=3, embed_std=0.5),
                               "cpu")
    plan = build_plan(params, FMT)
    q = plan.quantise(params)
    reqs = [Request(prompt=list(range(3, 29)), max_new_tokens=8, rid=0),
            Request(prompt=[9, 8, 7], max_new_tokens=12, rid=1),
            Request(prompt=[4, 4, 2, 1, 5], max_new_tokens=6, rid=2)]
    runs = []
    for fail in (set(), {0, 2, 6, 8, 11, 14}):
        eng = ServeEngine.from_quantised(cfg, q, plan, batch_slots=2,
                                         kv_len=48, prefill_chunk=4,
                                         step_retries=2,
                                         dense_fallback=False, device="cpu")
        _submit_all(eng, reqs)
        ctr = fail_after_write(eng, fail)
        runs.append({g.rid: g.tokens for g in eng.run()})
        assert ctr["raised"] == len(fail) and not eng.degraded
    assert runs[1] == runs[0]
    assert sorted(len(t) for t in runs[0].values()) == [6, 8, 12]


class TestAdmissionFaults:
    def test_drop_admissions_loses_only_target(self, ckpt):
        plan, q, _ = ckpt
        eng = _engine(plan, q)
        _submit_all(eng, _reqs(3))
        dropped = faults.drop_admissions(eng, {1})
        assert {g.rid for g in eng.run()} == {0, 2}
        assert [r.rid for r in dropped] == [1]

    def test_duplicate_admissions_run_identically(self, ckpt):
        plan, q, _ = ckpt
        eng = _engine(plan, q)
        eng.submit(Request(prompt=[3, 4, 5], max_new_tokens=4, rid=0))
        state = faults.duplicate_admissions(eng, {0})
        gens = eng.run()
        assert state["duplicated"] == 1
        assert len(gens) == 2
        assert gens[0].tokens == gens[1].tokens  # greedy → same stream
