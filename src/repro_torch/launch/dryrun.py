"""Multi-pod dry run: run every (architecture × input shape) cell once on
the production meshes without allocating anything, proving the
distribution config is coherent, and record memory / FLOP / collective
analysis for the roofline.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-405b \\
        --shape train_4k [--multi-pod] [--out results/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

It never touches a device: the world is a fake process group of 256 (or
512) ranks made in this process (this process is rank 0; collectives
return at once), the mesh is the production (16, 16) ("data", "model") or
(2, 16, 16) with "pod" in front, and parameters, optimizer state, decode
state and batch are DTensors over ``meta`` tensors placed by
``launch.mesh.spec_for``. The step runs eagerly under
``implicit_replication()`` (the model's own position and mask tensors are
plain), ``CommDebugMode`` (collective counts) and
``analysis.DeviceRecorder`` (rank 0's collectives with their bytes and
group sizes, and the FLOPs of its local shards); ``FlopCounterMode`` then
counts the whole step on plain meta tensors (``flops_global``, the
reference's one-device count). A cell that DTensor refuses is recorded as
``error`` with its traceback, as the reference records its compile
failures.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.core.plan import _flat_with_paths, map_with_paths
from repro_torch.launch import analysis
from repro_torch.launch.mesh import (RULES_BY_KIND, _axes_size,
                                     decode_rules_for, make_production_mesh,
                                     mesh_shape, placements_for, spec_for)
from repro_torch.models import api as mapi


def rules_for(shape: configs.Shape, cfg=None, mesh=None):
    if shape.kind == "decode" and shape.batch == 1:
        return RULES_BY_KIND["long_decode"]
    if shape.kind == "decode" and cfg is not None and mesh is not None:
        return decode_rules_for(cfg.n_kv_heads, mesh)
    return RULES_BY_KIND[shape.kind]


@contextlib.contextmanager
def fake_world(n_ranks: int):
    """A fake process group of ``n_ranks`` ranks in this process (rank 0;
    collectives complete at once and move nothing), destroyed on every
    exit path."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the dry "
                           "run makes its own fake world")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def place(spec_tree, mesh, rules):
    """tree[ParamSpec] -> tree of meta DTensors laid out by ``spec_for``:
    each rank's shard is an empty ``meta`` tensor of the local shape."""
    return map_with_paths(lambda _, s: _from_global(
        torch.empty(s.shape, dtype=mapi.torch_dtype(s.dtype), device="meta"),
        spec_for(s.axes, s.shape, mesh, rules), mesh), spec_tree)


def _opt_state(params, quantised_opt: bool):
    """Adam state beside DTensor ``params``: plain moments share the
    parameter's layout; quantised moments block the LAST dim keeping the
    leading dims (block_rows), so their codes and scales take the
    parameter's layout on the leading dims and its last-dim axes on the
    block-count dim when those divide it (the reference's
    ``_opt_shardings``; ``train.optimizer`` lays them out so)."""
    from repro_torch.train.optimizer import AdamConfig, adam_init

    acfg = AdamConfig(quantised_state=quantised_opt)
    return acfg, adam_init(params, acfg)


def _from_global(t, spec, mesh):
    """A meta DTensor of ``t``'s global shape laid out by ``spec``."""
    from torch.distributed.tensor import DTensor
    local = [d // (1 if part is None else _axes_size(
        mesh, (part,) if isinstance(part, str) else part))
        for d, part in zip(t.shape, spec)]
    return DTensor.from_local(torch.empty(local, dtype=t.dtype,
                                          device="meta"),
                              mesh, placements_for(spec, mesh),
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def build_cell(arch_id: str, shape_name: str, mesh, quantised_opt=True):
    """Returns (fn, args, meta) for a full config and a named shape (the
    reference's signature): ``fn(*args)`` runs the cell's step on meta
    DTensors and returns a dict of phase outcomes."""
    return _build_cell(configs.get_config(arch_id, "full"),
                       configs.SHAPES[shape_name], mesh, quantised_opt)


def _build_cell(cfg, shape: configs.Shape, mesh, quantised_opt=True,
                plain=False):
    """``build_cell``'s body; ``plain``: the same step on plain meta tensors
    (one device), for the whole step's FLOPs."""
    if shape.kind in ("prefill", "decode"):
        # serving posture: bf16 weights
        cfg = cfg.replace(param_dtype="bfloat16")
    fam = mapi.get_family(cfg.family)
    rules = rules_for(shape, cfg, mesh)
    lay = ((lambda tree, _mesh, _rules: mapi.specs_to_sds(tree)) if plain
           else place)
    pspecs = fam.param_specs(cfg)
    params = lay(pspecs, mesh, rules)
    batch = lay(configs.input_specs(cfg, shape), mesh, rules)
    meta = {
        "arch": cfg.name, "shape": shape.name, "kind": shape.kind,
        "mesh": mesh_shape(mesh), "n_devices": mesh.size(),
        "n_params": mapi.count_params(pspecs),
        "analytic_param_bytes_per_device":
            analysis.analytic_bytes_per_device(pspecs, mesh, rules),
    }

    if shape.kind == "train":
        from repro_torch.train.loop import ce_loss, clip_by_global_norm
        from repro_torch.train.optimizer import adam_update
        # the plain step stops at the gradients: clip and Adam multiply
        # no matrices, so they add no FLOPs
        acfg, opt = (None, None) if plain else _opt_state(params,
                                                          quantised_opt)

        def fn(params, opt, batch):
            names = [n for n, _ in _flat_with_paths(params)]
            leaves = {n: x.detach().requires_grad_(True)
                      for n, x in _flat_with_paths(params)}
            p = map_with_paths(lambda n, _: leaves[n], params)
            loss = ce_loss(cfg, fam.apply(p, batch, cfg), batch)
            grads = torch.autograd.grad(loss, [leaves[n] for n in names])
            grads = dict(zip(names, grads))
            if opt is None:
                return {}
            with torch.no_grad():
                grads, _ = clip_by_global_norm(
                    map_with_paths(lambda n, _: grads[n], params), 1.0)
            adam_update(grads, opt, params, 1e-4, acfg)
            return {"adam_update": "ok"}

        return fn, (params, opt, batch), meta

    if shape.kind == "prefill":
        def fn(params, batch):
            with torch.no_grad():
                fam.prefill(params, batch, cfg)
            return {}
        return fn, (params, batch), meta

    state = lay(fam.decode_state_specs(cfg, shape.batch, shape.seq), mesh,
                rules)

    def fn(params, state, batch):
        with torch.no_grad():
            fam.decode_step(params, state, batch, cfg)
        return {}

    return fn, (params, state, batch), meta


def run_on_mesh(cfg, shape: configs.Shape, mesh, quantised_opt=True) -> dict:
    """One cell on ``mesh`` (over an initialised fake world): the record,
    status ``ok`` or ``error`` with its traceback. The activation, head and
    EP setters are set as the reference's ``run_cell`` sets them and reset
    on every exit path."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models.layers import (set_activation_sharding,
                                           set_ep_mesh, set_head_axis)
    t0 = time.monotonic()
    try:
        rules = rules_for(shape, cfg, mesh)
        sizes = mesh_shape(mesh)
        set_head_axis("model")
        batch_opts = rules.get("batch", [None])[0]
        # sequence parallelism between blocks for train/prefill
        seq_axis = "model" if shape.kind in ("train", "prefill") else None
        if batch_opts is None or shape.batch == 1:
            axes = ()
            set_activation_sharding(None, seq_axis)
        else:
            axes = ((batch_opts,) if isinstance(batch_opts, str)
                    else tuple(batch_opts))
            axes = tuple(a for a in axes if a in sizes
                         and shape.batch % sizes[a] == 0)
            set_activation_sharding(axes or None, seq_axis)
        if cfg.n_experts:
            set_ep_mesh(mesh, axes, "model")
        fn, args, meta = _build_cell(cfg, shape, mesh, quantised_opt)
        rec = analysis.DeviceRecorder()
        with implicit_replication(), CommDebugMode() as comm, rec:
            phases = fn(*args)
        counts = {str(k): v for k, v in comm.get_comm_counts().items()}
        # the whole step, for flops_global: plain meta tensors, no layout
        # (each rank computes its own heads and blocks, so FlopCounterMode
        # over the DTensor run would count local shapes there)
        set_activation_sharding(None)
        set_ep_mesh(None, ())
        set_head_axis(None)
        whole, plain_args, _ = _build_cell(cfg, shape, mesh, quantised_opt,
                                           plain=True)
        with FlopCounterMode(display=False) as flops:
            whole(*plain_args)
        return {
            **meta,
            "status": "ok",
            **phases,
            "seconds": round(time.monotonic() - t0, 2),
            "memory": {"argument_bytes": analysis.local_bytes(args)},
            "collective_counts": counts,
            "collective_records": len(rec.collectives),
            "collective_bytes_per_device":
                analysis.collective_bytes(rec.collectives, mesh.size()),
            "flops_per_device": rec.flops,
            "flops_global": flops.get_total_flops(),
            "model_flops_total": analysis.model_flops(cfg, shape),
            "conventions": (
                "per device = rank 0 of the fake world: its local shards' "
                "FLOPs and its collectives under the ring model; "
                "flops_global = FlopCounterMode over the same step on "
                "plain meta tensors (one device, the local MoE path); "
                "model_flops_total = the analytic count for the whole "
                "step"),
        }
    except Exception as e:  # record the failure — these are bugs to fix
        return {"arch": cfg.name, "shape": shape.name, "kind": shape.kind,
                "mesh": mesh_shape(mesh), "n_devices": mesh.size(),
                "status": "error", "seconds": round(time.monotonic() - t0, 2),
                "error": f"{type(e).__name__}: {str(e)[:2000]}",
                "traceback": traceback.format_exc()[-4000:]}
    finally:
        set_activation_sharding(None)
        set_ep_mesh(None, ())
        set_head_axis(None)


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             out_dir: str = "results/dryrun", quantised_opt: bool = True,
             force: bool = False) -> dict:
    mesh_tag = "pod512" if multi_pod else "pod256"
    os.makedirs(os.path.join(out_dir, mesh_tag), exist_ok=True)
    out_path = os.path.join(out_dir, mesh_tag, f"{arch_id}__{shape_name}.json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)

    cfg = configs.get_config(arch_id, "full")
    shape = configs.SHAPES[shape_name]
    ok, reason = configs.applicable(cfg, shape_name)
    if not ok:
        rec = {"arch": arch_id, "shape": shape_name, "status": "skipped",
               "reason": reason}
    else:
        with fake_world(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
            rec = run_on_mesh(cfg, shape, mesh, quantised_opt)
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--f32-opt", action="store_true",
                    help="use f32 Adam moments instead of 8-bit")
    args = ap.parse_args()
    # DTensor warns at every multi-axis redistribution
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)

    archs = configs.ASSIGNED if (args.all or not args.arch) else [args.arch]
    shapes = list(configs.SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = [(a, s, mp) for mp in meshes for a in archs for s in shapes]

    failures = 0
    for a, s, mp in cells:
        tag = f"[{'512' if mp else '256'}] {a:24s} {s:12s}"
        t0 = time.monotonic()
        rec = run_cell(a, s, mp, out_dir=args.out,
                       quantised_opt=not args.f32_opt, force=args.force)
        dt = time.monotonic() - t0
        if rec["status"] == "ok":
            mem_gb = rec["memory"]["argument_bytes"] / 2**30
            print(f"{tag} OK    {dt:6.1f}s  "
                  f"flops/dev={rec['flops_per_device']:.3e}  "
                  f"model/dev={rec['model_flops_total'] / rec['n_devices']:.3e}  "
                  f"args/dev={mem_gb:.2f}GiB  "
                  f"coll/dev={rec['collective_bytes_per_device'].get('total', 0):.3e}B")
        elif rec["status"] == "skipped":
            print(f"{tag} SKIP  ({rec['reason'][:60]})")
        else:
            failures += 1
            print(f"{tag} FAIL  {rec['error'][:120]}")
    print(f"\n{failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
