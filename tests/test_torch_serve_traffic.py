"""The port's serving front end (``serve.scheduler``, ``serve.traffic``)
against the JAX package's.

Every case of ``tests/test_serve_traffic.py`` runs on the port:
shared-prefix forks bitwise equal to recompute (dense transformer, gemma3's
ring groups, a packed checkpoint, a prompt equal to its prefix), rwkv6's
recurrent state taking the recompute path, pool eviction under live
forks, priority/aging admission, the stream lifecycle, expiry accounting,
deterministic replay. Forks of quantised caches (q8, q4) equal recompute as
in ``tests/test_serve_kv_quant.py``. Across packages, the same
``TrafficSpec`` replayed on the same seeded numpy weights (paper-100m smoke,
gemma3-1b smoke with a q8 cache, f32) gives the same
``deterministic_signature``: tokens, outcomes, queue depth, steps, prefill
slot-steps and forks."""
import dataclasses
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.serve import traffic as jtraffic
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch import configs
from repro_torch.core import build_plan
from repro_torch.core.plan import map_with_paths
from repro_torch.interop import params_from_numpy
from repro_torch.models import transformer
from repro_torch.serve import traffic
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.scheduler import Scheduler

CFG = configs.get_config("paper-100m", "smoke").replace(dtype="float32",
                                                        param_dtype="float32")
ENG_KW = dict(batch_slots=2, kv_len=64, prefill_chunk=4, device="cpu")
ONE_KW = dict(batch_slots=1, kv_len=64, prefill_chunk=4, device="cpu")
PREFIX = [7, 3, 9, 1, 4, 2, 8, 5]          # shared 8-token system prompt
PROMPTS = [PREFIX + [5, 6], PREFIX + [11], PREFIX + [1, 2, 3],
           PREFIX + list(range(10, 19))]   # last one crosses chunk bounds


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


def gemma3_cfg(kv_format=""):
    return configs.get_config("gemma3-1b", "smoke").replace(
        dtype="float32", param_dtype="float32", kv_format=kv_format)


@pytest.fixture(scope="module")
def params():
    return params_from_numpy(numpy_params(CFG), "cpu")


def _quiet_run(obj, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return obj.run(**kw)


def _recompute_tokens(make_engine, prompts, n_new=5):
    """Reference: the same prompts through a plain engine (no scheduler,
    no prefix declaration) — full recomputation."""
    eng = make_engine()
    for i, p in enumerate(prompts):
        eng.submit(Request(prompt=list(p), max_new_tokens=n_new, rid=i))
    done = _quiet_run(eng)
    return {g.rid: g.tokens for g in done}, eng.prefill_slot_steps


def _fork_vs_recompute(make_engine, prompts, prefix, n_new=5):
    ref, ref_prefill = _recompute_tokens(make_engine, prompts, n_new)
    eng = make_engine()
    sched = Scheduler(eng)
    sched.register_prefix("sys", prefix)
    for i, p in enumerate(prompts):
        sched.submit(list(p), max_new_tokens=n_new, prefix="sys", rid=i)
    done = {g.rid: g.tokens for g in _quiet_run(sched)}
    assert done == ref, "forked-prefix tokens differ from recompute"
    total = eng.prefill_slot_steps + sched.pool.prefill_steps
    assert total < ref_prefill, (
        f"no prefill saving: {total} >= {ref_prefill} slot-steps")
    assert sched.stats["forks"] == len(prompts)


class TestPrefixForkPerFamily:
    def test_transformer_dense(self, params):
        _fork_vs_recompute(lambda: ServeEngine(CFG, params, **ENG_KW),
                           PROMPTS, PREFIX)

    def test_gemma3_ring_groups(self):
        # 5:1 local(16):global — the fork copies ring-buffer rows and
        # full-length global rows alike
        cfg = gemma3_cfg()
        p = params_from_numpy(numpy_params(cfg, seed=1), "cpu")
        _fork_vs_recompute(lambda: ServeEngine(cfg, p, **ENG_KW), PROMPTS,
                           PREFIX)

    def test_packed_checkpoint(self, params):
        plan = build_plan(params, "babsmax32:n4")
        q = plan.quantise(params)
        _fork_vs_recompute(
            lambda: ServeEngine.from_quantised(CFG, q, plan, **ENG_KW),
            PROMPTS, PREFIX)

    def test_prompt_equal_to_prefix(self, params):
        # the fork leaves >= 1 token to process, still bitwise equal
        _fork_vs_recompute(lambda: ServeEngine(CFG, params, **ENG_KW),
                           [list(PREFIX), PREFIX + [4]], PREFIX)

    def test_non_kv_family_recomputes_with_warning(self):
        """rwkv6 carries recurrent per-slot state: forking KV rows alone
        would be wrong, so the scheduler falls back to recompute (the same
        tokens, no fork) and says so once."""
        from repro_torch.models import rwkv6
        cfg = configs.get_config("rwkv6-1.6b", "smoke").replace(
            dtype="float32", param_dtype="float32")
        p = rwkv6.init(cfg, seed=0, device="cpu")
        prompts = [PREFIX + [5, 6], PREFIX + [11]]
        ref, _ = _recompute_tokens(lambda: ServeEngine(cfg, p, **ENG_KW),
                                   prompts)
        eng = ServeEngine(cfg, p, **ENG_KW)
        sched = Scheduler(eng)
        sched.register_prefix("sys", PREFIX)
        assert not sched.pool.fork_capable
        for i, pr in enumerate(prompts):
            sched.submit(list(pr), max_new_tokens=5, prefix="sys", rid=i)
        with pytest.warns(RuntimeWarning, match="recomputed, not forked"):
            done = {g.rid: g.tokens for g in sched.run()}
        assert done == ref
        assert sched.stats["forks"] == 0
        assert sched.stats["prefix_recompute"] == len(prompts)

    @pytest.mark.parametrize("fmt", ["q8", "q4"])
    def test_prefix_fork_quantised(self, params, fmt):
        """Forks copy quantised code + scale rows verbatim: forked tokens
        equal the full recompute, with a prefill saving."""
        cfg_q = CFG.replace(kv_format=fmt)
        _fork_vs_recompute(lambda: ServeEngine(cfg_q, params, **ENG_KW),
                           PROMPTS, PREFIX, n_new=6)

    @pytest.mark.parametrize("fmt", ["q8", "q4"])
    def test_gemma3_fork_quantised_rows_equal(self, fmt):
        """The forked slot's rows of every cache group (codes and scales)
        equal those the same request writes when it recomputes the prefix,
        bit for bit."""
        cfg = gemma3_cfg(fmt)
        p = params_from_numpy(numpy_params(cfg, seed=1, embed_std=0.5),
                              "cpu")
        prompt = PREFIX + list(range(20, 31))

        def first_token_state(use_prefix):
            eng = ServeEngine(cfg, p, batch_slots=2, kv_len=64,
                              prefill_chunk=4, device="cpu")
            sched = Scheduler(eng)
            sched.register_prefix("sys", PREFIX)
            h = sched.submit(prompt, max_new_tokens=4,
                             prefix="sys" if use_prefix else None)
            next(h.stream())
            return {k: v[:, 0].clone() for k, v in eng._state.items()
                    if k != "pos"}, sched.stats["forks"]
        forked, n_forks = first_token_state(True)
        recomputed, n_plain = first_token_state(False)
        assert (n_forks, n_plain) == (1, 0)
        assert set(forked) == set(recomputed)
        for k in forked:
            assert forked[k].equal(recomputed[k]), k


class TestPrefixPool:
    def test_eviction_while_fork_live(self, params):
        # capacity 1: a "b" admission evicts the pooled "a" entry while an
        # "a" fork decodes; the live fork owns copies
        other = [9, 9, 2, 2]
        prompts = [PREFIX + [5, 6], other + [3], PREFIX + [1]]
        ref, _ = _recompute_tokens(lambda: ServeEngine(CFG, params, **ONE_KW),
                                   prompts, n_new=6)
        eng = ServeEngine(CFG, params, **ONE_KW)
        sched = Scheduler(eng, prefix_capacity=1)
        sched.register_prefix("a", PREFIX)
        sched.register_prefix("b", other)
        for i, (p, key) in enumerate(zip(prompts, ["a", "b", "a"])):
            sched.submit(list(p), max_new_tokens=6, prefix=key, rid=i)
        done = {g.rid: g.tokens for g in _quiet_run(sched)}
        assert done == ref
        assert sched.pool.evictions >= 2       # a evicted by b, b by a
        assert sched.pool.prefill_steps > 0
        assert sched.stats["forks"] == 3

    def test_explicit_evict_keeps_live_fork_decoding(self, params):
        eng = ServeEngine(CFG, params, **ONE_KW)
        sched = Scheduler(eng)
        sched.register_prefix("sys", PREFIX)
        h = sched.submit(PREFIX + [5, 6], max_new_tokens=6, prefix="sys")
        stream = h.stream()
        first = next(stream)                   # fork done, decoding started
        sched.pool.evict("sys")
        assert "sys" not in sched.pool.resident
        rest = list(stream)
        ref, _ = _recompute_tokens(lambda: ServeEngine(CFG, params, **ONE_KW),
                                   [PREFIX + [5, 6]], n_new=6)
        assert [first] + rest == ref[0]

    def test_register_validates(self, params):
        sched = Scheduler(ServeEngine(CFG, params, **ENG_KW))
        with pytest.raises(ValueError, match="empty"):
            sched.register_prefix("x", [])
        with pytest.raises(ValueError, match="KV budget"):
            sched.register_prefix("x", list(range(200)) * 2)
        with pytest.raises(KeyError, match="not registered"):
            sched.submit([1, 2], prefix="nope")

    def test_prompt_must_start_with_prefix(self, params):
        sched = Scheduler(ServeEngine(CFG, params, **ENG_KW))
        sched.register_prefix("sys", PREFIX)
        with pytest.raises(ValueError, match="does not start with prefix"):
            sched.submit([1, 2, 3], prefix="sys")


class TestPriorityAdmission:
    def test_strict_priority_order(self, params):
        eng = ServeEngine(CFG, params, **ONE_KW)
        sched = Scheduler(eng, aging=0.0)
        lo = [sched.submit([1, 2, i], max_new_tokens=3, priority=0.0)
              for i in range(2)]
        hi = sched.submit([3, 4, 5], max_new_tokens=3, priority=5.0)
        _quiet_run(sched)
        assert hi.generation.queue_steps == 0
        assert all(h.generation.queue_steps > 0 for h in lo)
        assert (lo[0].generation.queue_steps
                < lo[1].generation.queue_steps)     # FIFO among equals

    def test_aging_prevents_starvation(self, params):
        eng = ServeEngine(CFG, params, **ONE_KW)
        sched = Scheduler(eng, aging=1.0)   # 1 step of waiting = 1 priority
        lo = sched.submit([1, 2], max_new_tokens=2, priority=0.0)
        his = [sched.submit([3, 3 + i], max_new_tokens=2, priority=3.0,
                            at=float(i)) for i in range(8)]
        _quiet_run(sched)
        assert lo.done and all(h.done for h in his)
        assert lo.generation.t_admit < his[-1].generation.t_admit, \
            "aged low-priority request starved behind fresh high-priority"

    def test_all_requests_complete_under_load(self, params):
        sched = Scheduler(ServeEngine(CFG, params, **ENG_KW))
        hs = [sched.submit([1 + i, 2, 3], max_new_tokens=4,
                           priority=float(i % 3)) for i in range(9)]
        done = _quiet_run(sched)
        assert len(done) == 9
        assert all(h.done for h in hs)


class TestStreamLifecycle:
    def test_stream_yields_incrementally(self, params):
        sched = Scheduler(ServeEngine(CFG, params, **ONE_KW))
        h = sched.submit([1, 2, 3, 4], max_new_tokens=5)
        seen = []
        for tok in h.stream():
            seen.append(tok)
            assert h.tokens == seen      # no lookahead past the yield
        assert h.done and len(seen) == 5
        ref, _ = _recompute_tokens(lambda: ServeEngine(CFG, params, **ONE_KW),
                                   [[1, 2, 3, 4]])
        assert seen == ref[0]

    def test_latency_stamps_ordered(self, params):
        sched = Scheduler(ServeEngine(CFG, params, **ONE_KW))
        early = sched.submit([1, 2, 3], max_new_tokens=3)
        late = sched.submit([4, 5, 6], max_new_tokens=3)
        _quiet_run(sched)
        for h in (early, late):
            g = h.generation
            assert g.t_submit > 0
            assert g.t_submit <= g.t_admit <= g.t_first_token <= g.t_done
        assert early.generation.queue_steps == 0
        assert late.generation.queue_steps > 0   # waited for the one slot

    def test_result_drives_to_completion(self, params):
        sched = Scheduler(ServeEngine(CFG, params, **ONE_KW))
        h = sched.submit([1, 2, 3], max_new_tokens=4, at=25.0)  # future
        g = h.result()          # fast-forwards the virtual clock
        assert g.done and len(g.tokens) == 4

    def test_virtual_arrivals_release_in_order(self, params):
        sched = Scheduler(ServeEngine(CFG, params, **ONE_KW))
        a = sched.submit([1, 2], max_new_tokens=2, at=0.0)
        b = sched.submit([3, 4], max_new_tokens=2, at=50.0)
        _quiet_run(sched)
        assert a.done and b.done
        assert a.generation.t_admit <= b.generation.t_admit


class TestExpiryAccounting:
    @staticmethod
    def _two(params):
        eng = ServeEngine(CFG, params, **ONE_KW)
        for i in range(2):
            eng.submit(Request(prompt=[1, 2, 3, 4], max_new_tokens=3,
                               rid=i))
        return eng

    def test_never_stepped_slot_counts_as_queued(self, params):
        # request 0 takes 3 steps, so the refill at the end of step 3 seats
        # request 1, which has run nothing when max_steps=3 expires
        eng = self._two(params)
        with pytest.warns(RuntimeWarning,
                          match=r"0 live slot\(s\) and 1 queued"):
            done = eng.run(max_steps=3)
        assert [g.rid for g in done] == [0]
        assert len(done[0].tokens) == 3
        assert all(s is None for s in eng._slots)
        assert [r.rid for r in eng._queue] == [1]

    def test_resumption_after_expiry_is_exact(self, params):
        ref = {g.rid: g.tokens for g in _quiet_run(self._two(params))}
        eng = self._two(params)
        out = {g.rid: g.tokens for g in _quiet_run(eng, max_steps=3)}
        out.update({g.rid: g.tokens for g in _quiet_run(eng)})
        assert out == ref

    def test_queue_steps_of_unadmitted_request_stays_exact(self, params):
        eng = self._two(params)
        _quiet_run(eng, max_steps=3)
        (g,) = _quiet_run(eng)
        assert g.rid == 1 and g.queue_steps == 3


class TestTrafficReplay:
    SPEC = traffic.TrafficSpec(seed=3, n_requests=10, rate=0.7)

    @staticmethod
    def _fresh(params):
        return ServeEngine(CFG, params, batch_slots=3, kv_len=64,
                           prefill_chunk=4, device="cpu")

    def test_generate_is_pure(self):
        a = traffic.generate(self.SPEC)
        b = traffic.generate(self.SPEC)
        assert a == b
        c = traffic.generate(traffic.TrafficSpec(seed=4, n_requests=10,
                                                 rate=0.7))
        assert a != c
        assert all(x.at <= y.at for x, y in zip(a.arrivals, a.arrivals[1:]))
        for arr in a.arrivals:
            if arr.prefix is not None:
                n = len(a.prefixes[arr.prefix])
                assert list(arr.prompt[:n]) == a.prefixes[arr.prefix]

    def test_generate_equals_the_reference(self):
        spec = dict(seed=5, n_requests=12, rate=0.9, prompt_len=(2, 7),
                    prefixes=(("a", 5, 0.3), ("b", 3, 0.3)),
                    priorities=((0.0, 0.5), (1.0, 0.25), (3.0, 0.25)))
        mine = traffic.generate(traffic.TrafficSpec(**spec))
        ref = jtraffic.generate(jtraffic.TrafficSpec(**spec))
        assert mine.prefixes == ref.prefixes
        assert [dataclasses.astuple(a) for a in mine.arrivals] == \
            [dataclasses.astuple(a) for a in ref.arrivals]

    def test_replay_deterministic_and_complete(self, params):
        wl = traffic.generate(self.SPEC)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            r1 = traffic.replay(self._fresh(params), wl)
            r2 = traffic.replay(self._fresh(params), wl)
        assert (r1.deterministic_signature()
                == r2.deterministic_signature())
        m = r1.metrics
        assert m["completed"] == m["n_requests"]
        assert m["goodput_tok_s"] > 0
        assert m["ttft_p99_s"] >= m["ttft_p50_s"] >= 0
        assert m["queue_depth_max"] >= 1     # load actually queued

    def test_reuse_vs_no_reuse(self, params):
        wl = traffic.generate(self.SPEC)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            r = traffic.replay(self._fresh(params), wl)
            rn = traffic.replay(self._fresh(params), wl, use_prefix=False)
        assert r.tokens == rn.tokens
        assert (r.metrics["total_prefill_slot_steps"]
                < rn.metrics["total_prefill_slot_steps"])
        assert r.metrics["forks"] > 0 and rn.metrics["forks"] == 0

    def test_faulted_replay_deterministic(self, params):
        spec = dataclasses.replace(self.SPEC, fault_nan=((1, 4, 6),))
        wl = traffic.generate(spec)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            r1 = traffic.replay(self._fresh(params), wl)
            r2 = traffic.replay(self._fresh(params), wl)
        assert (r1.deterministic_signature()
                == r2.deterministic_signature())
        m = r1.metrics
        assert m["failed"] >= 1
        assert m["completed"] + m["failed"] == m["n_requests"]
        assert m["goodput_tok_s"] > 0
        for o in r1.outcomes.values():
            assert o in ("done", "failed")


# ---------------------------------------------------------------------------
# Across packages: one spec, one set of weights, one signature

CROSS_SPECS = {
    "seed3": traffic.TrafficSpec(seed=3, n_requests=10, rate=0.7),
    "seed8": traffic.TrafficSpec(seed=8, n_requests=10, rate=0.4,
                                 prompt_len=(2, 12)),
    "seed3_nan": traffic.TrafficSpec(seed=3, n_requests=10, rate=0.7,
                                     fault_nan=((1, 4, 6),)),
}
CROSS_MODELS = {
    "paper-100m": lambda: (configs.get_config("paper-100m", "smoke"),
                           0.02),
    "gemma3-1b-q8": lambda: (configs.get_config("gemma3-1b", "smoke"), 0.5),
}


@pytest.mark.parametrize("spec_id", sorted(CROSS_SPECS))
@pytest.mark.parametrize("model", sorted(CROSS_MODELS))
def test_replay_signature_equals_the_reference(model, spec_id):
    cfg, embed_std = CROSS_MODELS[model]()
    kv = "q8" if model.endswith("q8") else ""
    cfg = cfg.replace(dtype="float32", param_dtype="float32", kv_format=kv)
    np_params = numpy_params(cfg, seed=2, embed_std=embed_std)
    spec = CROSS_SPECS[spec_id]
    kw = dict(batch_slots=3, kv_len=64, prefill_chunk=4)
    jcfg = jconfigs.get_config(cfg.name.replace("-smoke", ""), "smoke"
                               ).replace(dtype="float32",
                                         param_dtype="float32", kv_format=kv)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        ref = jtraffic.replay(
            JServeEngine(jcfg, jax.tree.map(jnp.asarray, np_params), **kw),
            jtraffic.generate(jtraffic.TrafficSpec(
                **dataclasses.asdict(spec))))
        mine = traffic.replay(
            ServeEngine(cfg, params_from_numpy(np_params, "cpu"),
                        device="cpu", **kw), traffic.generate(spec))
    assert mine.deterministic_signature() == ref.deterministic_signature()
    assert mine.metrics["forks"] > 0
    if spec.fault_nan:
        assert mine.metrics["failed"] >= 1


def test_serve_cli_traffic_replay_on_cpu(capsys):
    from repro_torch.launch import serve
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        report = serve.main(["--arch", "gemma3-1b", "--variant", "smoke",
                             "--quantise", "babsmax64:n4", "--packed",
                             "--kv-format", "q8", "--kv-len", "64",
                             "--requests", "6", "--traffic-replay", "0",
                             "--prefix", "8", "--step-retries", "2",
                             "--no-dense-fallback", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "traffic replay: seed=0 6 requests" in out
    assert "TTFT p50/p99" in out and "goodput" in out
    assert "prefix reuse:" in out and "degraded" not in out
    assert report.metrics["completed"] == 6
    assert report.metrics["forks"] > 0
    eng = report.scheduler.engine
    assert eng.step_retries == 2 and eng.dense_fallback is False


def test_serve_cli_dense_fallback_is_opt_in():
    from repro_torch.launch import serve
    argv = ["--arch", "gemma3-1b", "--variant", "smoke", "--quantise",
            "babsmax64:n4", "--packed", "--kv-len", "64", "--requests", "2",
            "--traffic-replay", "0", "--prefix", "0", "--device", "cpu"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        off = serve.main(argv).scheduler.engine
        on = serve.main(argv + ["--dense-fallback"]).scheduler.engine
    assert off.dense_fallback is False and on.dense_fallback is True
    assert not off.degraded and not on.degraded
