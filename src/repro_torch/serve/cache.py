"""Decode-cache geometry: per-layer-group KV specs with ring buffers.

Layers are grouped by their attention window; each window-homogeneous group
owns one stacked ``k{g}``/``v{g}`` cache of shape (L_g, B, length, K, hd).
Global groups allocate ``kv_len + slack``; windowed groups a
``min(window, kv_len) + slack`` ring written at ``pos % length``. ``slack``
is the engine's prefill chunk (chunk writes may spill past a row's valid
prefix). ``cache_bytes`` accounts the grouped allocation against the
uniform full-length baseline. See the reference's ``repro/serve/cache.py``
for the ring-correctness argument, which carries over unchanged.

Each group also carries a storage ``fmt``: ``"f32"`` keeps dense rows at
the spec dtype; ``"q8"``/``"q4"`` store block-scaled codes, one f32 absmax
scale per (token, head) row (scale block = ``head_dim``) and uint8 codes
into a uniform codebook of 256 / 16 points. q4 nibble-packs code pairs
along the head dim (``hd // 2`` bytes per row), so a row is
self-contained. A quantised group's state entries are ``k{g}``/``v{g}``
(codes) and ``k{g}s``/``v{g}s`` (scales, trailing dim 1).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

KV_FORMATS = ("f32", "q8", "q4")
_KV_BITS = {"f32": 0, "q8": 8, "q4": 4}

# The reference's codebooks, ``jnp.linspace(-1, 1, 2**bits, dtype=float32)``,
# as float32 bit patterns (8 hex digits each). torch.linspace and
# np.linspace differ from them in the last bit at most points, which moves
# the quantisation midpoints, so the values are kept verbatim.
_KV_CODEBOOK_HEX = {
    4: (
        "bf800000bf5ddddebf3bbbbcbf199999beeeeeefbeaaaaa9be4cccc9bd888881"
        "3d8888903e4cccd03eaaaaac3eeeeef13f19999c3f3bbbbe3f5ddde03f800000"
    ),
    8: (
        "bf800000bf7dfdfebf7bfbfcbf79f9fabf77f7f8bf75f5f6bf73f3f4bf71f1f2"
        "bf6feff0bf6dedeebf6bebecbf69e9eabf67e7e8bf65e5e6bf63e3e4bf61e1e2"
        "bf5fdfe0bf5ddddebf5bdbdcbf59d9dabf57d7d8bf55d5d6bf53d3d4bf51d1d2"
        "bf4fcfd0bf4dcdcebf4bcbccbf49c9cabf47c7c8bf45c5c6bf43c3c4bf41c1c2"
        "bf3fbfc0bf3dbdbebf3bbbbcbf39b9babf37b7b8bf35b5b6bf33b3b4bf31b1b2"
        "bf2fafb0bf2dadaebf2babacbf29a9aabf27a7a8bf25a5a6bf23a3a4bf21a1a2"
        "bf1f9fa0bf1d9d9dbf1b9b9cbf199999bf179798bf159595bf139394bf119191"
        "bf0f8f90bf0d8d8dbf0b8b8cbf098989bf078788bf058585bf038384bf018181"
        "befefeffbefafaf9bef6f6f7bef2f2f1beeeeeefbeeaeae9bee6e6e7bee2e2e1"
        "bedededfbedadad9bed6d6d7bed2d2d1becececfbecacac9bec6c6c7bec2c2c1"
        "bebebebfbebabab9beb6b6b7beb2b2b1beaeaeafbeaaaaa9bea6a6a7bea2a2a1"
        "be9e9e9fbe9a9a99be969697be929291be8e8e8fbe8a8a89be868687be828281"
        "be7cfcf9be74f4f1be6cece9be64e4e1be5cdcd9be54d4d1be4cccc9be44c4c1"
        "be3cbcb9be34b4b1be2caca9be24a4a1be1c9c99be149491be0c8c89be048481"
        "bdf8f8f1bde8e8e1bdd8d8d1bdc8c8c1bdb8b8b1bda8a8a1bd989891bd888881"
        "bd70f0e1bd50d0c1bd30b0a1bd109081bce0e0c1bca0a081bc40c081bb808001"
        "3b8081003c40c1003ca0a0c03ce0e1013d1090a03d30b0c13d50d0e13d70f101"
        "3d8888903d9898a13da8a8b13db8b8c13dc8c8d13dd8d8e13de8e8f13df8f901"
        "3e0484883e0c8c913e1494993e1c9ca13e24a4a93e2cacb13e34b4b93e3cbcc1"
        "3e44c4c93e4cccd13e54d4d93e5cdce13e64e4e93e6cecf13e74f4f93e7cfd01"
        "3e8282843e8686893e8a8a8d3e8e8e913e9292953e9696993e9a9a9d3e9e9ea1"
        "3ea2a2a53ea6a6a93eaaaaad3eaeaeb13eb2b2b53eb6b6b93ebababd3ebebec1"
        "3ec2c2c53ec6c6c93ecacacd3ececed13ed2d2d53ed6d6d93edadadd3ededee1"
        "3ee2e2e53ee6e6e93eeaeaed3eeeeef13ef2f2f53ef6f6f93efafafd3efeff01"
        "3f0181843f0383863f0585883f07878a3f09898c3f0b8b8e3f0d8d903f0f8f92"
        "3f1191943f1393963f1595983f17979a3f19999c3f1b9b9e3f1d9da03f1f9fa2"
        "3f21a1a43f23a3a63f25a5a83f27a7aa3f29a9ac3f2babae3f2dadb03f2fafb2"
        "3f31b1b43f33b3b63f35b5b83f37b7ba3f39b9bc3f3bbbbe3f3dbdc03f3fbfc2"
        "3f41c1c43f43c3c63f45c5c83f47c7ca3f49c9cc3f4bcbce3f4dcdd03f4fcfd2"
        "3f51d1d43f53d3d63f55d5d83f57d7da3f59d9dc3f5bdbde3f5ddde03f5fdfe2"
        "3f61e1e43f63e3e63f65e5e83f67e7ea3f69e9ec3f6bebee3f6dedf03f6feff2"
        "3f71f1f43f73f3f63f75f5f83f77f7fa3f79f9fc3f7bfbfe3f7dfe003f800000"
    ),
}


def kv_bits(fmt: str) -> int:
    """Code width of a KV format (0 = dense)."""
    return _KV_BITS[fmt]


def kv_codebook(fmt: str, device=None) -> torch.Tensor:
    """The uniform symmetric codebook a quantised KV format dequantises
    through: the reference's ``linspace(-1, 1, 2**bits)`` in float32, bit
    for bit. One tensor per (format, device), made once: the decode step
    asks for it every step, and a copy to the card each time would
    synchronise the host."""
    bits = kv_bits(fmt)
    if not bits:
        raise ValueError(f"dense format {fmt!r} has no codebook")
    return _codebook(bits, torch.device(device or "cpu"))


@functools.lru_cache(maxsize=None)
def _codebook(bits: int, device: torch.device) -> torch.Tensor:
    words = np.frombuffer(bytes.fromhex(_KV_CODEBOOK_HEX[bits]), dtype=">u4")
    return torch.from_numpy(
        words.astype(np.uint32).view(np.float32).copy()).to(device)


def _itemsize(dtype: str) -> int:
    return torch.empty((), dtype=getattr(torch, dtype)).element_size()


def parse_kv_formats(formats, n_groups: int, head_dim: int
                     ) -> Tuple[str, ...]:
    """Normalise a KV-format request to one format per cache group: None/""
    (all dense), a single token (broadcast), a comma list or a sequence."""
    if formats is None or formats == "":
        return ("f32",) * n_groups
    if isinstance(formats, str):
        toks = [t.strip() for t in formats.split(",") if t.strip()]
    else:
        toks = [str(t) for t in formats]
    if len(toks) == 1:
        toks = toks * n_groups
    if len(toks) != n_groups:
        raise ValueError(
            f"kv_format {formats!r}: got {len(toks)} formats for "
            f"{n_groups} cache groups")
    for t in toks:
        if t not in KV_FORMATS:
            raise ValueError(f"unknown kv format {t!r} (expected one of "
                             f"{KV_FORMATS}, or 'auto' resolved upstream)")
        if t == "q4" and head_dim % 2:
            raise ValueError(
                f"q4 nibble-packs code pairs along head_dim, which must be "
                f"even (got {head_dim})")
    return tuple(toks)


def layer_groups(windows) -> Tuple[Tuple[int, Tuple[int, ...]], ...]:
    """Group a per-layer window pattern into window-homogeneous cache
    groups, ordered by first appearance: ``((window, layers), ...)``."""
    order: List[int] = []
    members: Dict[int, List[int]] = {}
    for i, w in enumerate(int(w) for w in np.asarray(windows).reshape(-1)):
        if w not in members:
            members[w] = []
            order.append(w)
        members[w].append(i)
    return tuple((w, tuple(members[w])) for w in order)


@dataclass(frozen=True)
class CacheGroup:
    """One window-homogeneous layer group's KV cache geometry."""
    index: int                # group id == suffix of the state keys
    window: int               # sliding-window size; 0 = global attention
    layers: Tuple[int, ...]   # absolute layer indices in stack order
    length: int               # allocated kv slots per layer
    fmt: str = "f32"          # storage format

    @property
    def ring(self) -> bool:
        return self.window > 0

    @property
    def quantised(self) -> bool:
        return self.fmt != "f32"

    @property
    def k_key(self) -> str:
        return f"k{self.index}"

    @property
    def v_key(self) -> str:
        return f"v{self.index}"

    @property
    def k_scale_key(self) -> str:
        return f"k{self.index}s"

    @property
    def v_scale_key(self) -> str:
        return f"v{self.index}s"

    @property
    def group_state_keys(self) -> Tuple[str, ...]:
        """Codes (or dense rows) always; per-row scales when quantised."""
        if self.quantised:
            return (self.k_key, self.k_scale_key,
                    self.v_key, self.v_scale_key)
        return (self.k_key, self.v_key)


@dataclass(frozen=True)
class CacheSpec:
    """A model's full self-attention decode-cache geometry; ``full_length``
    is the uniform allocation's length (the accounting baseline)."""
    groups: Tuple[CacheGroup, ...]
    batch: int
    kv_heads: int
    head_dim: int
    dtype: str
    full_length: int
    layer_axis: str = "layers"
    head_axis: str = "kv_heads"

    def state_specs(self) -> dict:
        """Grouped decode-state entries: per group, ``k{g}``/``v{g}`` — dense
        rows at the spec dtype, or uint8 codes (``hd // 2`` wide for q4) —
        plus float32 ``k{g}s``/``v{g}s`` row scales when quantised."""
        from repro_torch.models.api import ParamSpec
        specs = {}
        for g in self.groups:
            lead = (len(g.layers), self.batch, g.length, self.kv_heads)
            axes = (self.layer_axis, "batch", "seq_kv", self.head_axis, None)
            if g.quantised:
                code = ParamSpec(lead + (self._code_width(g.fmt),), axes,
                                 "uint8")
                scale = ParamSpec(lead + (1,), axes, "float32")
                specs.update({g.k_key: code, g.k_scale_key: scale,
                              g.v_key: code, g.v_scale_key: scale})
            else:
                spec = ParamSpec(lead + (self.head_dim,), axes, self.dtype)
                specs[g.k_key] = spec
                specs[g.v_key] = spec
        return specs

    def _code_width(self, fmt: str) -> int:
        return self.head_dim // 2 if fmt == "q4" else self.head_dim

    @property
    def n_layers(self) -> int:
        return sum(len(g.layers) for g in self.groups)

    @property
    def formats(self) -> Tuple[str, ...]:
        return tuple(g.fmt for g in self.groups)

    @property
    def quantised(self) -> bool:
        return any(g.quantised for g in self.groups)

    @property
    def state_keys(self) -> Tuple[str, ...]:
        return tuple(k for g in self.groups for k in g.group_state_keys)

    def cache_bytes(self) -> dict:
        """Per-group breakdown, grouped total (``kv``) with its code/scale
        split, the grouped geometry at the dense dtype (``dense_kv``) and the
        uniform full-length baseline (``uniform_kv``) — the reference's
        keys and numbers."""
        item = _itemsize(self.dtype)
        dense_row = 2 * self.batch * self.kv_heads * self.head_dim * item
        per = []
        kv = codes = scales = dense = 0
        for g in self.groups:
            slots = len(g.layers) * g.length * self.batch * self.kv_heads
            d = dense_row * len(g.layers) * g.length
            if g.quantised:
                cb = 2 * slots * self._code_width(g.fmt)  # uint8, k + v
                sb = 2 * slots * 4        # one f32 scale per row, k + v
            else:
                cb, sb = d, 0
            b = cb + sb
            per.append({"window": g.window, "n_layers": len(g.layers),
                        "length": g.length, "format": g.fmt, "bytes": b,
                        "code_bytes": cb, "scale_bytes": sb,
                        "dense_bytes": d,
                        "ratio_vs_dense": round(b / d, 4) if d else 1.0})
            kv += b
            codes += cb
            scales += sb
            dense += d
        uniform = dense_row * self.n_layers * self.full_length
        return {"kv": kv, "code_bytes": codes, "scale_bytes": scales,
                "dense_kv": dense,
                "cache_ratio_vs_dense": round(kv / dense, 4) if dense
                else 1.0,
                "uniform_kv": uniform,
                "cache_ratio_vs_uniform": round(kv / uniform, 4) if uniform
                else 1.0,
                "cache_groups": per}


def build_cache_spec(windows, batch: int, kv_len: int, *, slack: int = 0,
                     kv_heads: int, head_dim: int, dtype: str,
                     windowed: bool = True, layer_axis: str = "layers",
                     head_axis: str = "kv_heads",
                     formats=None) -> CacheSpec:
    """Build a model's grouped cache geometry from its per-layer window
    pattern: global groups (and every group when ``windowed=False``)
    allocate ``kv_len + slack``, windowed groups ``min(window, kv_len) +
    slack`` ring slots."""
    full = kv_len + slack
    grouped = layer_groups(windows)
    fmts = parse_kv_formats(formats, len(grouped), head_dim)
    groups = []
    for i, (w, layers) in enumerate(grouped):
        length = min(w, kv_len) + slack if (windowed and w > 0) else full
        groups.append(CacheGroup(index=i, window=w, layers=layers,
                                 length=length, fmt=fmts[i]))
    return CacheSpec(tuple(groups), batch, kv_heads, head_dim, dtype, full,
                     layer_axis, head_axis)


# ---------------------------------------------------------------------------
# Ring index math (shared with models.layers)
# ---------------------------------------------------------------------------

def ring_slots(positions, length: int):
    """Ring slot for each absolute position."""
    return positions % length


def ring_positions(last, length: int):
    """The absolute position each ring slot currently holds: slot ``s`` holds
    the most recent position ≤ ``last`` congruent to ``s`` mod ``length``;
    negative ⇒ never written. ``last``: (...,) ints → (..., length)."""
    last = torch.as_tensor(last)
    s = torch.arange(length, dtype=last.dtype, device=last.device)
    return last[..., None] - torch.remainder(last[..., None] - s, length)
