"""Checkpointing: atomic, deterministic-restart-safe, and optionally
**quantised** (the paper's formats applied to the framework's own state).
The reference's ``repro/train/checkpoint.py`` on-disk layout, so a
checkpoint written by either package restores in the other:

    <dir>/step_000123/
        arrays.npz          flat "a/b/c" → array
        manifest.json       step, model name, ...
    <dir>/step_000123.tmp   (staging; atomic rename on completion)

States are nested dicts of tensors. Quantised Adam moments are dequantised
to f32 on save (the canonical form) and requantised into the template's
leaves on restore. No bfloat16 array goes into an npz (numpy has no such
dtype without ``ml_dtypes``): bf16 leaves are saved as f32, exactly, and
cast back to the template's dtype on restore. ``save_quantised_params`` is
the compressed path for parameter-only serving checkpoints. Arrays are
saved unsharded; the port runs on one device, so a restore takes no
shardings.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import numpy as np
import torch

from repro_torch.core.tensor_format import QuantisedTensor
from repro_torch.models.api import resolve_device


def _flatten_dict(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten_dict(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten_dict(flat):
    root: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return root


def _is_opt_state(d) -> bool:
    return isinstance(d, dict) and set(d) == {"m", "v", "step"}


def _to_numpy(x) -> np.ndarray:
    """A leaf as a numpy array for the npz: bf16 (and other sub-f32 floats)
    widened to f32, which holds them exactly."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.is_floating_point() and x.dtype != torch.float64:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _canonicalise(tree):
    """Dequantise QuantisedTensor leaves to plain f32 for serialisation.
    Adam moments use different transforms (m: linear int8; v: sqrt-uint8),
    dispatched by position in the {m, v, step} optimizer state."""
    from repro_torch.train.optimizer import _dequantise_moment

    def deq(second):
        def f(x):
            if isinstance(x, QuantisedTensor):
                x = _dequantise_moment(x, True, second)
            return _to_numpy(x)
        return f

    if _is_opt_state(tree):
        return {"m": _map_tree(deq(False), tree["m"]),
                "v": _map_tree(deq(True), tree["v"]),
                "step": _to_numpy(tree["step"])}
    if isinstance(tree, dict):
        return {k: _canonicalise(v) for k, v in tree.items()}
    return _to_numpy(tree)


def _publish(ckpt_dir: str, name: str, flat: dict, manifest: dict) -> str:
    """Write ``flat`` and ``manifest`` into a staging dir, then rename it to
    ``<ckpt_dir>/<name>`` (a stale staging dir is replaced)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, name)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)   # atomic publish
    return final


def save_checkpoint(ckpt_dir: str, state, step: int, meta: dict | None = None):
    flat = _flatten_dict(_canonicalise(state))
    return _publish(ckpt_dir, f"step_{step:08d}", flat,
                    {"step": step, "n_arrays": len(flat), **(meta or {})})


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    return os.path.join(ckpt_dir, steps[-1]) if steps else None


def restore_checkpoint(path: str, template=None, shardings=None):
    """Returns (state, meta). Without ``template`` the arrays come back as
    CPU tensors in the saved dtypes; with ``template`` (a state tree) each
    is cast to its template leaf's dtype and device, and quantised moments
    are requantised into the template's format."""
    if shardings is not None:
        raise ValueError("restore_checkpoint: the port runs on one device; "
                         "shardings must be None")
    with open(os.path.join(path, "manifest.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        tree = _unflatten_dict({k: torch.from_numpy(npz[k])
                                for k in npz.files})
    if template is not None:
        tree = _match_template(template, tree)
    return tree, meta


def _match_template(template, tree):
    from repro_torch.train.optimizer import _quantise_moment

    def conv(second):
        def f(t, x):
            if isinstance(t, QuantisedTensor):
                return _quantise_moment(
                    x.to(device=t.codes.device, dtype=torch.float32), True,
                    second)
            return x.to(device=t.device, dtype=t.dtype)
        return f

    def zip_map(fn, t, x):
        if isinstance(t, dict):
            return {k: zip_map(fn, t[k], x[k]) for k in t}
        return fn(t, x)

    if _is_opt_state(template):
        return {"m": zip_map(conv(False), template["m"], tree["m"]),
                "v": zip_map(conv(True), template["v"], tree["v"]),
                "step": tree["step"].to(device=template["step"].device,
                                        dtype=torch.int32)}
    if isinstance(template, dict):
        return {k: _match_template(template[k], tree[k]) for k in template}
    return conv(False)(template, tree)


# ------------------------------------------------------------- quantised params

def save_quantised_params(ckpt_dir: str, params, plan, step: int = 0):
    """Serving checkpoint: parameters packed with the plan's TensorFormats
    (codes + f32 scales + outliers). ~bits/32 of the f32 size."""
    qtree = plan.quantise(params)
    flat = {}
    for key, leaf in _flatten_dict(qtree).items():
        if isinstance(leaf, QuantisedTensor):
            flat[key + ".__codes"] = _to_numpy(leaf.codes)
            flat[key + ".__scales"] = _to_numpy(leaf.scales)
            if leaf.sparse_idx is not None:
                flat[key + ".__spidx"] = _to_numpy(leaf.sparse_idx)
                flat[key + ".__spval"] = _to_numpy(leaf.sparse_val)
            flat[key + ".__shape"] = np.asarray(leaf.shape)
            flat[key + ".__dtype"] = np.frombuffer(
                leaf.dtype.encode(), dtype=np.uint8)
        else:
            flat[key] = _to_numpy(leaf)
    return _publish(ckpt_dir, f"qstep_{step:08d}", flat,
                    {"step": step, "format": "quantised"})


def load_quantised_params(path: str, plan, device=None):
    """The dense parameters of a ``save_quantised_params`` checkpoint (each
    tensor dequantised by ``plan``), on ``device`` (default the card)."""
    dev = resolve_device(device)
    groups: dict = {}
    plain: dict = {}
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        for k in npz.files:
            if ".__" in k:
                base, attr = k.rsplit(".__", 1)
                groups.setdefault(base, {})[attr] = npz[k]
            else:
                plain[k] = torch.from_numpy(npz[k]).to(dev)

    def tensor(a, dtype=None):
        t = torch.from_numpy(a).to(dev)
        return t if dtype is None else t.to(dtype)

    for base, g in groups.items():
        plain[base] = QuantisedTensor(
            codes=tensor(g["codes"]),
            scales=tensor(g["scales"], torch.bfloat16),
            sparse_idx=tensor(g["spidx"]) if "spidx" in g else None,
            sparse_val=(tensor(g["spval"], torch.bfloat16)
                        if "spval" in g else None),
            shape=tuple(int(s) for s in g["shape"]),
            dtype=bytes(g["dtype"]).decode(),
        )
    return plan.dequantise(_unflatten_dict(plain))
