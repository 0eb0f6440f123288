"""Deterministic synthetic LM data: motif-repeat streams.

Each sequence tiles a random motif, so next-token prediction is learnable
(the model must copy with period `motif_len`) — the quickstart trains a
~100M model to visibly falling loss in a few hundred steps.

Batches are pure functions of (step, shard) — resume-exact data skipping
for fault tolerance: restarting at step K regenerates exactly batch K.

Counterpart of ``repro.data.tokens``: the same numpy arrays, equal
outright, for the same arguments.
"""
from __future__ import annotations

import numpy as np

from repro_torch.models.common import ModelConfig


def lm_batch(cfg: ModelConfig, batch: int, seq: int, step: int,
             shard: int = 0, n_shards: int = 1, motif_len: int = 32,
             pool_size: int = 16) -> dict:
    rng = np.random.default_rng(
        np.random.SeedSequence([step, shard, n_shards, 0xA5]))
    # motifs come from a small FIXED pool (independent of step) so the task
    # is memorizable within a few hundred steps; which motif each row gets
    # varies per step (still a pure function of (step, shard))
    pool_rng = np.random.default_rng(
        np.random.SeedSequence([shard, n_shards, 0x5EED]))
    pool = pool_rng.integers(0, cfg.vocab, (pool_size, motif_len),
                             dtype=np.int64)
    reps = -(-(seq + 1) // motif_len)
    motifs = pool[rng.integers(0, pool_size, batch)]
    stream = np.tile(motifs, (1, reps))[:, :seq + 1].astype(np.int32)
    out = {"tokens": stream[:, :-1], "targets": stream[:, 1:]}
    if cfg.frontend == "audio":
        # frame embedding stub: deterministic projection of the token id
        emb = _hash_embed(out["tokens"], cfg.d_model)
        out = {"frame_embeds": emb, "targets": out["targets"]}
    elif cfg.frontend == "vision":
        p = cfg.vision_prefix
        patches = rng.normal(0, 1, (batch, p, cfg.d_model)).astype(np.float32)
        out["patch_embeds"] = patches
    return out


def _hash_embed(tokens: np.ndarray, d: int) -> np.ndarray:
    """Cheap deterministic token -> embedding stub (audio frontend)."""
    t = tokens.astype(np.float32)[..., None]
    phase = np.arange(d, dtype=np.float32)[None, None, :]
    return (np.sin(t * 0.1 + phase * 0.7) * 0.5).astype(np.float32)
