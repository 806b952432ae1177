"""Random-rotation baseline (fig. 29; QuaRot/SpinQuant-style).

θ̃ = Vᵀ · dequantise(quantise(V θ W)) · Wᵀ with random orthonormal V, W.
Full dense rotations for dims ≤ ``max_dense``, block-diagonal rotations of
``block`` otherwise (the paper similarly skips over-large dims). The
matrices come from numpy exactly as in the reference's
``repro/core/rotations.py``; they are applied by torch on the tensor's
device."""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=64)
def _np_rotation(dim: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((dim, dim))
    q, r = np.linalg.qr(a)
    q *= np.sign(np.diag(r))
    return q.astype(np.float32)


def rotation(dim: int, seed: int = 0, max_dense: int = 8192,
             block: int = 1024) -> np.ndarray | None:
    """Orthonormal (dim, dim) rotation, block-diagonal if dim > max_dense.
    Returns None when dim is not divisible by the block size (skip)."""
    if dim <= max_dense:
        return _np_rotation(dim, seed)
    if dim % block:
        return None
    return _np_rotation(block, seed)  # block-diagonal: applied via reshape


def apply_rotation(x: torch.Tensor, r: np.ndarray | None,
                   axis: int) -> torch.Tensor:
    if r is None:
        return x
    dim = x.shape[axis]
    rot = torch.from_numpy(np.ascontiguousarray(r)).to(x.device)
    if r.shape[0] == dim:
        return torch.movedim(
            torch.tensordot(torch.movedim(x, axis, -1), rot, dims=([-1], [0])),
            -1, axis)
    # block-diagonal
    b = r.shape[0]
    xm = torch.movedim(x, axis, -1)
    shp = xm.shape
    xm = xm.reshape(*shp[:-1], dim // b, b)
    xm = torch.einsum("...kb,bc->...kc", xm, rot)
    return torch.movedim(xm.reshape(shp), -1, axis)


def rotated_fake_quant(x: torch.Tensor, fmt, seed: int = 0) -> torch.Tensor:
    """fig. 29: rotate rows+cols, fake-quant, rotate back (2-D tensors)."""
    if x.ndim != 2:
        return fmt.fake_quant(x)
    v = rotation(x.shape[0], seed)
    w = rotation(x.shape[1], seed + 1)
    y = apply_rotation(apply_rotation(x, v, 0), w, 1)
    y = fmt.fake_quant(y)
    return apply_rotation(apply_rotation(y, _t(v), 0), _t(w), 1)


def _t(r):
    return None if r is None else r.T
