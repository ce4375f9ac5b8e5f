"""Synthetic data pipeline — deterministic and cursor-resumable. The
port's copy of ``repro.data.synthetic`` (plain numpy): its batches are
the reference's, bit for bit.

Every batch is a pure function of (config, cursor); the cursor is committed
per step in the training WAL, so after a crash the pipeline resumes exactly
where the last durable step left it (no duplicated or skipped batches —
the data-side half of exactly-once step semantics).

Batches carry the modality extras the assigned families need: mel-frame
embeddings for whisper (conv frontend stubbed per the assignment), patch
embeddings + M-RoPE position ids for qwen2-vl.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.models.config import ModelConfig


def _tokens(rng: np.random.Generator, batch: int, seq: int, vocab: int) -> np.ndarray:
    # Mixture of zipf-ish and uniform tokens — enough structure for loss to
    # move under training without any external corpus.
    z = rng.zipf(1.3, size=(batch, seq)) % vocab
    u = rng.integers(0, vocab, size=(batch, seq))
    pick = rng.random((batch, seq)) < 0.5
    return np.where(pick, z, u).astype(np.int32)


def synthetic_batch(cfg: ModelConfig, batch: int, seq: int, cursor: int,
                    *, np_dtype=np.float32) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(cursor * 2654435761 % (2**31))
    toks = _tokens(rng, batch, seq, cfg.vocab_size)
    labels = np.concatenate(
        [toks[:, 1:], np.full((batch, 1), -1, np.int32)], axis=1)
    out: Dict[str, np.ndarray] = {"tokens": toks, "labels": labels.astype(np.int32)}
    if cfg.frontend == "audio_frames":
        out["frames"] = rng.standard_normal(
            (batch, seq, cfg.d_model)).astype(np_dtype)
    if cfg.frontend == "vision_patches":
        s_vis = max(1, seq // 4)
        out["vis_embeds"] = rng.standard_normal(
            (batch, s_vis, cfg.d_model)).astype(np_dtype)
        # M-RoPE ids: text positions identical across (t, h, w); patch
        # positions get a simple grid (the real model derives them from the
        # image layout — frontend is a stub here).
        base = np.broadcast_to(np.arange(seq, dtype=np.int32), (batch, seq))
        pos = np.stack([base, base, base])
        out["positions"] = pos.astype(np.int32)
    return out


@dataclasses.dataclass
class SyntheticPipeline:
    """Resumable iterator: ``pipeline.batch(cursor)``; the training loop owns
    the cursor and persists it in the WAL."""

    cfg: ModelConfig
    batch: int
    seq: int

    def batch_at(self, cursor: int) -> Dict[str, np.ndarray]:
        return synthetic_batch(self.cfg, self.batch, self.seq, cursor)
