"""repro_torch.data — the deterministic synthetic token stream (numpy)."""
from . import pipeline
from .pipeline import DataConfig, make_batch_fn, tokens_at

__all__ = ["pipeline", "DataConfig", "make_batch_fn", "tokens_at"]
