"""Carry the reference package's parameters across into the port.

``params_from_numpy(tree, device)`` takes the reference's parameter tree as
nested dicts of numpy arrays — a packed tensor given as the dict of its
fields (codes, scales, codepoints, out_shape, shape, dtype, block, bits) —
and returns the port's tree with the same keys: tensors on ``device`` and
:class:`~repro_torch.core.tensor_format.PackedTensor` leaves. Nothing of the
reference is imported; bfloat16 arrays (numpy dtype name ``bfloat16``, from
``ml_dtypes``) are moved bit-exactly through their 16-bit pattern.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.tensor_format import PackedTensor

PACKED_FIELDS = ("codes", "scales", "codepoints", "out_shape", "shape",
                 "dtype", "block", "bits")


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``; bf16 through its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def packed_from_fields(fields: dict, device) -> PackedTensor:
    missing = set(PACKED_FIELDS) - set(fields)
    if missing:
        raise ValueError(f"packed tensor fields missing: {sorted(missing)}")
    return PackedTensor(
        codes=tensor_from_numpy(fields["codes"], device),
        scales=tensor_from_numpy(fields["scales"], device),
        codepoints=tuple(float(c) for c in fields["codepoints"]),
        out_shape=tuple(int(d) for d in fields["out_shape"]),
        shape=tuple(int(d) for d in fields["shape"]),
        dtype=str(fields["dtype"]), block=int(fields["block"]),
        bits=int(fields["bits"]))


def params_from_numpy(tree, device):
    """Reference params (nested dicts of numpy arrays / packed-field dicts)
    → the port's params on ``device``, same keys. Layer stacks keep their
    leading L dim."""
    if isinstance(tree, dict):
        if "codes" in tree and "codepoints" in tree:
            return packed_from_fields(tree, device)
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)
