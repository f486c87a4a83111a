"""Token data pipeline: deterministic, shardable, resumable.

Sources:
  * ``SyntheticLM``  — seeded zipfian token stream (CPU smoke / examples);
  * ``MemmapTokens`` — flat uint16/uint32 token file (production path).

The iterator is a pure function of (seed, step), so restoring a checkpoint
at step k reproduces the exact batch sequence — required for
checkpoint/restart equivalence (tests/test_checkpoint.py) and elastic
re-sharding (a resized data axis re-partitions the same global batch).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    path: str | None = None  # memmap file; None -> synthetic
    dtype: str = "uint16"


class SyntheticLM:
    """Zipfian unigram stream with local n-gram structure (so loss can
    actually go down during the examples' few hundred steps)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._probs = (1.0 / ranks ** 1.1)
        self._probs /= self._probs.sum()
        # Fixed bigram "grammar": each token has a few likely successors.
        self._succ = rng.integers(0, v, size=(v, 4))

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b, s = cfg.global_batch, cfg.seq_len
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.choice(cfg.vocab_size, size=b, p=self._probs)
        follow = rng.random((b, s)) < 0.7
        succ_pick = rng.integers(0, 4, size=(b, s))
        rand_toks = rng.choice(cfg.vocab_size, size=(b, s), p=self._probs)
        for t in range(s):
            nxt = self._succ[toks[:, t], succ_pick[:, t]]
            toks[:, t + 1] = np.where(follow[:, t], nxt, rand_toks[:, t])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


class MemmapTokens:
    """Flat binary token file, strided deterministic sampling."""

    def __init__(self, cfg: DataConfig):
        assert cfg.path is not None
        self.cfg = cfg
        self._data = np.memmap(cfg.path, dtype=np.dtype(cfg.dtype), mode="r")
        self._n = len(self._data) - cfg.seq_len - 1
        assert self._n > 0, "token file smaller than one sequence"

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        starts = rng.integers(0, self._n, size=cfg.global_batch)
        toks = np.stack(
            [self._data[s : s + cfg.seq_len + 1].astype(np.int32) for s in starts]
        )
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


def make_source(cfg: DataConfig):
    return MemmapTokens(cfg) if cfg.path else SyntheticLM(cfg)


class ShardedLoader:
    """Wraps a source; yields per-step batches, optionally adapted for
    model families (audio codebooks, vlm image embeds)."""

    def __init__(self, cfg: DataConfig, model_cfg=None):
        self.cfg = cfg
        self.source = make_source(cfg)
        self.model_cfg = model_cfg

    def batch(self, step: int) -> dict[str, np.ndarray]:
        out = self.source.batch(step)
        mc = self.model_cfg
        if mc is not None and mc.family == "audio":
            k = mc.num_codebooks
            out = {
                "tokens": np.repeat(out["tokens"][..., None], k, axis=-1),
                "labels": np.repeat(out["labels"][..., None], k, axis=-1),
            }
        if mc is not None and mc.family == "vlm":
            rng = np.random.default_rng((self.cfg.seed, step, 7))
            out["image_embeds"] = rng.standard_normal(
                (self.cfg.global_batch, mc.num_image_tokens, mc.d_model)
            ).astype(np.float32)  # stub frontend output (DESIGN.md §5)
        return out
