"""The reference's layout of small dry-run cells, for
``tests/test_torch_layout_parity.py``: each cell compiled by XLA on a
(data, model) mesh of the host's CPU devices, with the reference's own
``rules_for``, ``build_cell`` (``shardings_for_specs``, ``_batch_shardings``,
``_opt_shardings``) and the activation, head and EP setters as its
``run_cell`` sets them, and compiled again on one device.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \\
        python tests/_layout_reference.py CELLS.json OUT.json

CELLS.json holds ``{name: [arch, kind, seq, batch, data, model,
one_device]}`` (smoke configs); OUT.json gets, per cell, ``per_device``
(``parse_hlo_dot_stats`` of the sharded program: one device's dot FLOPs),
``one_device`` (the same of the one-device program, null unless
``one_device`` is true), ``collective_bytes`` (``parse_collective_bytes``)
and ``seconds``.

    XLA_FLAGS=--xla_force_host_platform_device_count=256 JAX_PLATFORMS=cpu \
        python tests/_layout_reference.py --full ARCH SHAPE

prints the same for a full config and a named shape on the production
(16, 16) mesh, as one JSON line with ``model_flops``, ``per_over_even``
(``per_device`` ÷ ``model_flops`` ÷ 256) and ``imbalance`` (``per_device``
× 256 ÷ ``one_device``)."""
import json
import sys
import time

import jax

jax.devices()   # fix the device count before repro.launch.dryrun sets its own

import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro import configs  # noqa: E402
from repro.launch import analysis, dryrun  # noqa: E402
from repro.models import layers  # noqa: E402


def _set_layout(cfg, shape, mesh, rules):
    """The setters as ``repro.launch.dryrun.run_cell`` sets them."""
    layers.set_head_axis("model")
    batch_opts = rules.get("batch", [None])[0]
    seq_axis = "model" if shape.kind in ("train", "prefill") else None
    axes = ()
    if batch_opts is None or shape.batch == 1:
        layers.set_activation_sharding(None, seq_axis)
    else:
        axes = ((batch_opts,) if isinstance(batch_opts, str)
                else tuple(batch_opts))
        axes = tuple(a for a in axes if a in mesh.shape
                     and shape.batch % mesh.shape[a] == 0)
        layers.set_activation_sharding(axes or None, seq_axis)
    if cfg.n_experts:
        layers.set_ep_mesh(mesh, axes, "model")


def _reset():
    layers.set_activation_sharding(None)
    layers.set_ep_mesh(None, ())
    layers.set_head_axis(None)


def run(arch, kind, seq, batch, data, model, one_device=False):
    return _run(configs.get_config(arch, "smoke"),
                configs.smoke_shape(kind, seq=seq, batch=batch), data, model,
                one_device)


def _run(cfg, shape, data, model, one_device):
    arch = cfg.name
    # build_cell reads the full config and the named shape: hand it these
    full, shapes = configs.get_config, configs.SHAPES
    configs.get_config = lambda *a, **k: cfg
    configs.SHAPES = {shape.name: shape}
    t0 = time.monotonic()
    try:
        mesh = Mesh(np.array(jax.devices()[:data * model]).reshape(
            data, model), ("data", "model"))
        _set_layout(cfg, shape, mesh, dryrun.rules_for(shape, cfg, mesh))
        fn, args, in_sh, _ = dryrun.build_cell(arch, shape.name, mesh)
        with mesh:
            hlo = jax.jit(fn, in_shardings=in_sh).lower(*args).compile() \
                .as_text()
        _reset()
        one = None
        if one_device:
            one = analysis.parse_hlo_dot_stats(
                jax.jit(fn).lower(*args).compile().as_text())[0]
        return {"per_device": analysis.parse_hlo_dot_stats(hlo)[0],
                "one_device": one,
                "collective_bytes": analysis.parse_collective_bytes(
                    hlo, data * model),
                "seconds": time.monotonic() - t0}
    finally:
        _reset()
        configs.get_config, configs.SHAPES = full, shapes


def main(cells_path, out_path):
    with open(cells_path) as f:
        cells = json.load(f)
    out = {name: run(*cell) for name, cell in cells.items()}
    with open(out_path, "w") as f:
        json.dump(out, f)


def full(arch, shape_name):
    cfg, shape = configs.get_config(arch, "full"), configs.SHAPES[shape_name]
    rec = _run(cfg, shape, 16, 16, True)
    even = analysis.model_flops(cfg, shape) / 256
    print(json.dumps({"arch": arch, "shape": shape_name, **rec,
                      "model_flops": even * 256,
                      "per_over_even": rec["per_device"] / even,
                      "imbalance": rec["per_device"] * 256 / rec["one_device"]}))


if __name__ == "__main__":
    if sys.argv[1] == "--full":
        full(*sys.argv[2:])
    else:
        main(*sys.argv[1:])
