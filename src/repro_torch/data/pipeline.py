"""Deterministic synthetic data pipeline (numpy, carried over from the
reference's ``repro/data/pipeline.py``: the same Philox streams give the
same batches).

Counter-based (Philox) generation: ``batch_at(step)`` is a pure function of
(seed, step), so restarts resume bit-exactly from a checkpoint without
replaying the stream — the fault-tolerance contract (no data iterator state
to persist or rewind).

The LM stream has learnable structure: a Zipf unigram marginal with a noisy
affine bigram transition, so cross-entropy decreases materially during a
training run (unigram entropy >> bigram entropy). Batches are numpy; the
train loop moves them to its device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from repro_torch.models.api import ModelConfig, get_family


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq: int
    batch: int
    seed: int = 0
    zipf_a: float = 1.2           # Zipf exponent for innovation tokens
    noise_p: float = 0.15         # probability of an innovation (vs bigram)
    mult: int = 7                 # bigram transition multiplier


def _rng_at(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(key=cfg.seed, counter=step))


def tokens_at(cfg: DataConfig, step: int) -> np.ndarray:
    """(batch, seq) int32, deterministic in (seed, step)."""
    rng = _rng_at(cfg, step)
    B, T, V = cfg.batch, cfg.seq, cfg.vocab
    innov = rng.zipf(cfg.zipf_a, size=(B, T)) % V
    use_innov = rng.random((B, T)) < cfg.noise_p
    out = np.empty((B, T), np.int64)
    out[:, 0] = innov[:, 0]
    for t in range(1, T):
        nxt = (cfg.mult * out[:, t - 1] + 1) % V
        out[:, t] = np.where(use_innov[:, t], innov[:, t], nxt)
    return out.astype(np.int32)


def make_batch_fn(model_cfg: ModelConfig, seq: int, batch: int, seed: int = 0):
    """Return ``batch_at(step) -> dict`` of the model family's inputs: the
    token stream, plus whisper's audio frames (B, enc_seq, d_model) or
    internvl's image patches (B, n_vis_tokens, D_VIT), drawn as the
    reference draws them (standard normals from the Philox stream at
    counter 2**31 + step). A family the port does not run raises
    ``KeyError``."""
    get_family(model_cfg.family)
    dc = DataConfig(vocab=model_cfg.vocab, seq=seq, batch=batch, seed=seed)

    def batch_at(step: int) -> dict:
        b = {"tokens": tokens_at(dc, step)}
        rng = _rng_at(dc, 2**31 + step)
        if model_cfg.family == "whisper":
            b["frames"] = rng.standard_normal(
                (batch, model_cfg.enc_seq, model_cfg.d_model)).astype(
                    np.float32)
        elif model_cfg.family == "internvl":
            from repro_torch.models.internvl import D_VIT
            b["vis"] = rng.standard_normal(
                (batch, model_cfg.n_vis_tokens, D_VIT)).astype(np.float32)
        return b

    return batch_at


def bigram_entropy_bits(cfg: DataConfig, n: int = 1 << 16) -> float:
    """Approximate per-token entropy of the stream (diagnostic)."""
    toks = tokens_at(DataConfig(cfg.vocab, n, 1, cfg.seed), 0)[0]
    # conditional entropy: innovation mass + deterministic bigram
    counts = np.bincount(toks, minlength=cfg.vocab) + 1e-9
    p = counts / counts.sum()
    h_unigram = -(p * np.log2(p)).sum()
    h_cond = (cfg.noise_p * h_unigram
              - (1 - cfg.noise_p) * math.log2(1 - cfg.noise_p + 1e-12))
    return float(h_cond)
