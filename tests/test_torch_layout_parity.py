"""The port's multi-device layout held to the reference's on small CPU
meshes: where heads or KV heads do not divide the model axis, each rank
computes attention and rwkv6's WKV on its own heads (⌈H ÷ m⌉ or fewer), as
the reference's padded GSPMD layout does.

What is read, per smoke cell (``smoke_shape(kind, seq, batch=4)``):
- the port: rank 0 of a fake world (``dryrun.fake_world`` and
  ``run_on_mesh``, the dry run's own path): ``flops_per_device``,
  ``flops_global`` (the whole step on plain meta tensors),
  ``collective_records`` and ``collective_bytes_per_device``;
- the reference: ``tests/_layout_reference.py`` in one subprocess for the
  file (8 host CPU devices), the cell compiled with the reference's own
  rules, ``build_cell`` and setters: ``parse_hlo_dot_stats`` of the sharded
  program (one device's dot FLOPs) and of the one-device program, and
  ``parse_collective_bytes``.
The yardstick is each package's own imbalance, per-rank FLOPs × ranks ÷
its whole-cell FLOPs (the two count FLOPs differently); the port's may be
at most 1.05× the reference's. rwkv6 on (4, 2) at seq 512 moves at most
1.25× the reference's collective bytes a rank, and makes no more
collectives than at seq 128 plus one layer's worth (the count at seq 128 ÷
its layers): the WKV's chunk loop slices local tensors.

A gloo world of 4 ranks (spawned once) holds the DTensor paths to the
plain path in f32 (within 1e-5 of the largest magnitude): llama3-405b
smoke attention (K = 2 on 4: ``flash_attention`` on q/k/v DTensors, and
``attn_block`` with its projections), gemma3-1b smoke ``attn_block`` (H = 2
on 4: two ranks hold no head; the output projection sums the ranks'
partial products) and rwkv6-1.6b smoke ``time_mix`` (H = 2 on 4, two
chunks; and a serving chunk from a carried state with a ragged mask):
outputs, final states and gradients."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.launch import dryrun, mesh
from repro_torch.models import layers, rwkv6, transformer

from _gloo_worlds import spawn_worlds

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name: (arch, kind, seq, (data, model))
CELLS = {
    "llama3_prefill": ("llama3-405b", "prefill", 128, (2, 4)),
    "llama3_train": ("llama3-405b", "train", 128, (2, 4)),
    "internlm2_prefill": ("internlm2-20b", "prefill", 128, (2, 4)),
    "gemma3_prefill": ("gemma3-1b", "prefill", 128, (2, 4)),
    "rwkv6_prefill": ("rwkv6-1.6b", "prefill", 128, (2, 4)),
    "rwkv6_prefill_128": ("rwkv6-1.6b", "prefill", 128, (4, 2)),
    "rwkv6_prefill_512": ("rwkv6-1.6b", "prefill", 512, (4, 2)),
}
SPREAD = ("llama3_prefill", "llama3_train", "internlm2_prefill",
          "gemma3_prefill")
BATCH = 4


def _shape(kind, seq):
    return configs.smoke_shape(kind, seq=seq, batch=BATCH)


def _start_reference(tmp):
    """The reference's cells, compiled in a subprocess with 8 host CPU
    devices (the device count is fixed when jax starts). LLVM's
    optimisation level 0 halves the compile's CPU time and leaves the
    optimised HLO, which is what is read, unchanged."""
    cells = {name: [arch, kind, seq, BATCH, *dm, name in SPREAD]
             for name, (arch, kind, seq, dm) in CELLS.items()}
    cells_path = os.path.join(tmp, "cells.json")
    with open(cells_path, "w") as f:
        json.dump(cells, f)
    out_path = os.path.join(tmp, "reference.json")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_backend_optimization_level=0",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(ROOT, "src")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "_layout_reference.py"),
         cells_path, out_path], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    return proc, out_path


def _port_cell(arch, kind, seq, dm):
    cfg = configs.get_config(arch, "smoke")
    data, model = dm
    with dryrun.fake_world(data * model):
        return dryrun.run_on_mesh(cfg, _shape(kind, seq),
                                  mesh.make_host_mesh(model=model,
                                                      device_type="cpu"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({name: (port record, reference record)}, the gloo world's arrays):
    the reference compiles in its subprocess while the gloo world and the
    port's cells run."""
    proc, out_path = _start_reference(str(tmp_path_factory.mktemp("ref")))
    try:
        world = spawn_worlds((WORLD,), str(tmp_path_factory.mktemp("gloo")),
                             layout_job, {"seed": 0})[WORLD]
        port = {name: _port_cell(arch, kind, seq, dm)
                for name, (arch, kind, seq, dm) in CELLS.items()}
        log, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, log.decode()[-4000:]
    with open(out_path) as f:
        ref = json.load(f)
    return {name: (port[name], ref[name]) for name in CELLS}, world


@pytest.fixture(scope="module")
def cells(runs):
    return runs[0]


@pytest.mark.parametrize("name", list(CELLS))
def test_cell_runs_in_both_packages(cells, name):
    """Every cell compiles in the reference and runs ``ok`` in the port
    (rwkv6 on (2, 4) used to stop at the uneven split of its 2 heads)."""
    rec, ref = cells[name]
    assert rec["status"] == "ok", rec.get("traceback")
    assert ref["per_device"] > 0


@pytest.mark.parametrize("name", SPREAD)
def test_per_rank_flops_spread_as_the_reference(cells, name):
    """The port's per-rank FLOPs × ranks ÷ its whole-cell FLOPs is at most
    1.05× the reference's (its sharded HLO's dot FLOPs × ranks ÷ its
    one-device HLO's)."""
    rec, ref = cells[name]
    n = rec["n_devices"]
    port = rec["flops_per_device"] * n / rec["flops_global"]
    want = ref["per_device"] * n / ref["one_device"]
    assert port <= 1.05 * want, (port, want)


def test_rwkv6_collective_bytes_within_the_reference(cells):
    """rwkv6 on (4, 2) at seq 512: r, k, v, w and g laid out once a layer,
    not gathered a chunk at a time."""
    rec, ref = cells["rwkv6_prefill_512"]
    port = rec["collective_bytes_per_device"]["total"]
    want = ref["collective_bytes"]["total"]
    assert port <= 1.25 * want, (port, want)


def test_rwkv6_collectives_do_not_grow_with_chunks(cells):
    """16 chunks a layer at seq 512 against 4 at seq 128: at most one
    layer's worth more collectives."""
    n128 = cells["rwkv6_prefill_128"][0]["collective_records"]
    n512 = cells["rwkv6_prefill_512"][0]["collective_records"]
    layers_ = configs.get_config("rwkv6-1.6b", "smoke").n_layers
    assert n512 <= n128 + n128 // layers_, (n128, n512)


# ---------------------------------------------------------------------------
# a gloo world of 4: the DTensor paths against the plain path


WORLD = 4
B, T = 2, 32
CHUNK = 16


def _f32(arch, **kw):
    return configs.get_config(arch, "smoke").replace(
        dtype="float32", param_dtype="float32", **kw)


def _draws(specs, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    return {name: (scale * rng.standard_normal(s.shape[1:])).astype(
        np.float32) for name, s in specs.items()}


def _attn_weights(cfg, seed):
    specs = transformer.layer_param_specs(cfg, 1)
    keep = ("wq", "wk", "wv", "wo", "q_norm", "k_norm")
    w = _draws({k: s for k, s in specs.items() if k in keep}, seed)
    axes = {k: specs[k].axes[1:] for k in w}
    return w, axes


def _rwkv6_weights(cfg, seed):
    specs = rwkv6.layer_param_specs(cfg.replace(n_layers=1))
    w = _draws(specs, seed)
    D = cfg.d_model
    w["w0"] = (-5.0 + 8.0 * (np.arange(D) / (D - 1)) ** 3.0).astype(
        np.float32)
    for k in w:
        if k.startswith("mu_"):
            w[k] = np.full(D, 0.5, np.float32)
    return w, {k: s.axes[1:] for k, s in specs.items()}


def _placed(a, axes, dmesh, requires_grad):
    """A seeded array as the dry run places it: ``spec_for`` under the
    train rules."""
    from torch.distributed.tensor import distribute_tensor
    spec = mesh.spec_for(axes, a.shape, dmesh, mesh.TRAIN_RULES)
    t = distribute_tensor(torch.from_numpy(a), dmesh,
                          mesh.placements_for(spec, dmesh))
    return t.requires_grad_(requires_grad)


def _act(a, dmesh, spec):
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(torch.from_numpy(a), dmesh,
                             mesh.placements_for(spec, dmesh)) \
        .requires_grad_(True)


def _full(t):
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().numpy()


def _run_both(fn, arrays, place, grads, cot_seed):
    """``fn`` on plain tensors and on their placed DTensors: each output
    and the gradient of Σ outputs·cotangents for every name in
    ``grads``; {key: {"got": DTensor path, "want": plain path}}. Both run
    under ``implicit_replication`` (plain positions and masks), as the dry
    run's step does."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    res = {}
    for path in ("got", "want"):
        leaves = {k: (place(k, a) if path == "got"
                      else torch.from_numpy(a).requires_grad_(k in grads))
                  for k, a in arrays.items()}
        rng = np.random.default_rng(cot_seed)
        with implicit_replication():
            outs = fn(leaves)
            loss = 0
            for o in outs.values():
                if not o.requires_grad:
                    continue
                cot = torch.from_numpy(rng.standard_normal(
                    tuple(o.shape)).astype(np.float32))
                if path == "got":
                    cot = distribute_tensor(
                        cot, o.device_mesh, [Replicate()] * o.device_mesh.ndim)
                loss = loss + (o * cot).sum()
            if grads:
                loss.backward()
        for k, o in outs.items():
            res.setdefault(k, {})[path] = _full(o)
        for k in grads:
            res.setdefault(f"d{k}", {})[path] = _full(leaves[k].grad)
    return res


def layout_job(rank, n, group, payload):
    """Every case on a (1, n) ("data", "model") mesh with the dry run's
    head axis and activation layout; rank 0 returns each output and
    gradient of both paths."""
    from torch.distributed.device_mesh import init_device_mesh
    dmesh = init_device_mesh("cpu", (1, n), mesh_dim_names=("data", "model"))
    layers.set_head_axis("model")
    layers.set_activation_sharding(("data",), "model")
    bt = ("data", "model", None)           # constrain_act's layout
    heads = ("data", None, "model", None)  # constrain_heads' layout
    out = {}
    try:
        # llama3-405b: flash_attention on q/k/v laid out as qkv_project
        # leaves them (8 q heads, 2 KV heads on 4 ranks)
        cfg = _f32("llama3-405b")
        rng = np.random.default_rng(payload["seed"])
        arrays = {k: rng.standard_normal((B, T, h, cfg.hd)).astype(
            np.float32) for k, h in (("q", cfg.n_heads),
                                     ("k", cfg.n_kv_heads),
                                     ("v", cfg.n_kv_heads))}
        pos = torch.arange(T)

        def flash(p):
            assert not layers._is_dtensor(p["q"]) or layers._heads_gather(
                p["q"], cfg.n_kv_heads)
            return {"out": layers.flash_attention(
                p["q"], p["k"], p["v"], pos, pos, chunk=CHUNK)}
        got = _run_both(flash, arrays,
                        lambda k, a: _act(a, dmesh, heads), ("q", "k", "v"),
                        payload["seed"] + 1)
        out.update({f"llama3_flash:{k}": v for k, v in got.items()})

        # attn_block: projections, rope, attention, output projection
        for case, arch in (("llama3_block", "llama3-405b"),
                           ("gemma3_block", "gemma3-1b")):
            cfg = _f32(arch, attn_chunk=CHUNK)
            w, axes = _attn_weights(cfg, payload["seed"] + 2)
            arrays = dict(w, x=np.random.default_rng(
                payload["seed"] + 3).standard_normal(
                    (B, T, cfg.d_model)).astype(np.float32))
            axes["x"] = bt

            def block(p, cfg=cfg):
                params = layers.AttnParams(
                    p["wq"], p["wk"], p["wv"], p["wo"], p.get("q_norm"),
                    p.get("k_norm"))
                return {"out": layers.attn_block(p["x"], params, pos, cfg)}
            got = _run_both(
                block, arrays,
                lambda k, a: (_act(a, dmesh, bt) if k == "x" else
                              _placed(a, axes[k], dmesh, True)),
                ("x", "wq", "wk", "wv", "wo"), payload["seed"] + 4)
            out.update({f"{case}:{k}": v for k, v in got.items()})

        # rwkv6-1.6b time mix: 2 heads on 4 ranks, two chunks of 32
        cfg = _f32("rwkv6-1.6b")
        w, axes = _rwkv6_weights(cfg, payload["seed"] + 5)
        Tr = 2 * cfg.linear_chunk
        rng = np.random.default_rng(payload["seed"] + 6)
        arrays = dict(w, x=rng.standard_normal((B, Tr, cfg.d_model)).astype(
            np.float32))
        axes["x"] = bt

        def mix(p):
            o, (last, s) = rwkv6.time_mix(p["x"], p, cfg)
            return {"out": o, "state": s}
        got = _run_both(
            mix, arrays,
            lambda k, a: (_act(a, dmesh, bt) if k == "x" else
                          _placed(a, axes[k], dmesh, True)),
            ("x", "wr", "wk", "wv", "wg", "wo", "bonus_u", "ln_x"),
            payload["seed"] + 7)
        out.update({f"rwkv6_mix:{k}": v for k, v in got.items()})

        # a serving chunk of 8 from a carried state, two rows ragged
        H, hd = rwkv6._n_heads(cfg), rwkv6.HEAD_DIM
        arrays = dict(w, x=rng.standard_normal((B, 8, cfg.d_model)).astype(
            np.float32),
            last=rng.standard_normal((B, cfg.d_model)).astype(np.float32),
            s0=(0.1 * rng.standard_normal((B, H, hd, hd))).astype(
                np.float32))
        axes.update(x=bt, last=("data", None),
                    s0=("data", "model", None, None))
        valid = torch.arange(8)[None, :] < torch.tensor([[8], [5]])

        def serve(p):
            with torch.no_grad():
                o, (last, s) = rwkv6.time_mix(p["x"], p, cfg, p["last"],
                                              p["s0"], valid)
            return {"out": o, "state": s, "last": last}
        got = _run_both(
            serve, arrays,
            lambda k, a: (_act(a, dmesh, axes[k]) if k in ("x", "last", "s0")
                          else _placed(a, axes[k], dmesh, False)),
            (), payload["seed"] + 8)
        out.update({f"rwkv6_serve:{k}": v for k, v in got.items()})
    finally:
        layers.set_head_axis(None)
        layers.set_activation_sharding(None)
    return {f"{k}:{path}": v for k, d in out.items() for path, v in d.items()}


CASES = {
    "llama3_flash": ("out", "dq", "dk", "dv"),
    "llama3_block": ("out", "dx", "dwq", "dwk", "dwv", "dwo"),
    "gemma3_block": ("out", "dx", "dwq", "dwk", "dwv", "dwo"),
    "rwkv6_mix": ("out", "state", "dx", "dwr", "dwk", "dwv", "dwg", "dwo",
                  "dbonus_u", "dln_x"),
    "rwkv6_serve": ("out", "state", "last"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_dtensor_path_matches_the_plain_path(runs, case):
    got = runs[1]
    for key in CASES[case]:
        g, w = got[f"{case}:{key}:got"], got[f"{case}:{key}:want"]
        assert g.shape == w.shape, key
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=key)
