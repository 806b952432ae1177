"""The assigned input-shape cells and their batch input specs (the
reference's ``repro/configs/shapes.py``): the one definition of each
family's non-token inputs.

  train_4k     seq 4,096   global_batch 256   (training      → train_step)
  prefill_32k  seq 32,768  global_batch 32    (inference     → prefill)
  decode_32k   seq 32,768  global_batch 128   (decode: 1 new token, 32k KV)
  long_500k    seq 524,288 global_batch 1     (long-context decode)

``long_500k`` needs sub-quadratic attention: it applies to rwkv6 / zamba2
(recurrent state) and gemma3 (5:1 local:global), not to pure
full-attention archs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

from repro_torch.models.api import ModelConfig, ParamSpec


@dataclass(frozen=True)
class Shape:
    name: str
    kind: str       # "train" | "prefill" | "decode"
    seq: int
    batch: int


SHAPES: Dict[str, Shape] = {
    "train_4k": Shape("train_4k", "train", 4096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32768, 128),
    "long_500k": Shape("long_500k", "decode", 524288, 1),
}

SUBQUADRATIC_FAMILIES = ("rwkv6", "zamba2")


def applicable(cfg: ModelConfig, shape_name: str) -> Tuple[bool, str]:
    if shape_name == "long_500k":
        if cfg.family in SUBQUADRATIC_FAMILIES:
            return True, ""
        if cfg.local_global_pattern:
            return True, ""  # gemma3: windowed locals + few globals
        return False, ("skipped: pure full-attention arch — 500k decode KV "
                       "is out of scope per assignment")
    return True, ""


def input_specs(cfg: ModelConfig, shape: Shape) -> Dict[str, ParamSpec]:
    """The batch's inputs as specs (shape, logical axes, dtype). Decode
    shapes pair with the family's ``decode_state_specs``."""
    B = shape.batch
    if shape.kind == "decode":
        return {"tokens": ParamSpec((B, 1), ("batch", None), "int32")}
    S = shape.seq
    if cfg.family == "whisper":
        return {
            "frames": ParamSpec((B, cfg.enc_seq, cfg.d_model),
                                ("batch", None, None), "float32"),
            "tokens": ParamSpec((B, S), ("batch", None), "int32"),
        }
    if cfg.family == "internvl":
        from repro_torch.models.internvl import D_VIT
        t_text = max(S - cfg.n_vis_tokens, 1)
        return {
            "tokens": ParamSpec((B, t_text), ("batch", None), "int32"),
            "vis": ParamSpec((B, cfg.n_vis_tokens, D_VIT),
                             ("batch", None, None), "float32"),
        }
    return {"tokens": ParamSpec((B, S), ("batch", None), "int32")}


def smoke_shape(kind: str = "train", seq: int = 64, batch: int = 2) -> Shape:
    return Shape(f"smoke_{kind}", kind, seq, batch)
