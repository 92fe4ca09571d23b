"""Deterministic, seekable synthetic data pipelines: the port's copy of
``repro.data.pipeline`` (numpy only, so both packages read the same
bytes; the reference's background ``Prefetcher`` is left out).

Every pipeline is a pure function of (seed, step): ``batch_at(step)``
always returns the same batch — so checkpoint/restart resumes the data
stream *exactly* (fault tolerance requires no data-state checkpointing),
and elastic re-sharding just re-slices the same global batch.

The LM task is a *clustered-bigram* language: tokens belong to one of
``n_clusters`` latent clusters; within a cluster the next token follows a
cluster-specific affine map (plus noise).  A mixture model with experts
that specialise per cluster fits it better than a single dense FFN of the
same active size — which is exactly the structure the paper's k>1 routing
claims to exploit (Fig. 3), so quality gaps between top-1 / top-k /
k top-1 are observable at toy scale.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    n_clusters: int = 8
    noise: float = 0.05

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        v = self.vocab_size
        # per-cluster affine next-token maps (co-prime multipliers)
        self.mult = rng.choice([m for m in range(2, v) if np.gcd(m, v) == 1],
                               size=self.n_clusters)
        self.bias = rng.randint(0, v, size=self.n_clusters)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState((self.seed * 1_000_003 + step) % (2**31 - 1))
        B, S, v = self.batch, self.seq_len, self.vocab_size
        cluster = rng.randint(0, self.n_clusters, size=(B,))
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.randint(0, v, size=(B,))
        for t in range(S):
            nxt = (toks[:, t] * self.mult[cluster] + self.bias[cluster]) % v
            noise = rng.rand(B) < self.noise
            nxt = np.where(noise, rng.randint(0, v, size=(B,)), nxt)
            toks[:, t + 1] = nxt
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


@dataclasses.dataclass
class SyntheticSeq2Seq:
    """For the enc-dec family: frames are random frontend embeddings whose
    mean encodes an affine map the decoder must apply (learnable task)."""

    vocab_size: int
    d_model: int
    batch: int
    src_len: int
    tgt_len: int
    seed: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState((self.seed * 999_983 + step) % (2**31 - 1))
        B = self.batch
        frames = rng.randn(B, self.src_len, self.d_model).astype(np.float32) * 0.1
        toks = rng.randint(0, self.vocab_size, size=(B, self.tgt_len + 1)).astype(np.int32)
        return {"frames": frames, "tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


@dataclasses.dataclass
class SyntheticMultimodal:
    """For vlm / m6: clustered-bigram text + patch embeddings that encode
    the cluster id (so attending to the image prefix helps)."""

    vocab_size: int
    d_model: int
    num_image_tokens: int
    batch: int
    seq_len: int
    seed: int = 0
    n_clusters: int = 8

    def __post_init__(self):
        self._lm = SyntheticLM(self.vocab_size, self.batch, self.seq_len,
                               self.seed, self.n_clusters)
        rng = np.random.RandomState(self.seed + 17)
        self.cluster_embeds = rng.randn(self.n_clusters, self.d_model).astype(np.float32)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState((self.seed * 7_368_787 + step) % (2**31 - 1))
        lm = self._lm.batch_at(step)
        B = self.batch
        cluster = rng.randint(0, self.n_clusters, size=(B,))
        patches = (self.cluster_embeds[cluster][:, None, :]
                   + 0.05 * rng.randn(B, self.num_image_tokens, self.d_model)).astype(np.float32)
        return {**lm, "patch_embeds": patches}


def make_pipeline(cfg, batch: int, seq_len: int, seed: int = 0):
    """Pick a pipeline matching the model family."""
    if cfg.family == "encdec":
        return SyntheticSeq2Seq(cfg.vocab_size, cfg.d_model, batch,
                                src_len=seq_len, tgt_len=seq_len, seed=seed)
    if cfg.num_image_tokens:
        return SyntheticMultimodal(cfg.vocab_size, cfg.d_model,
                                   cfg.num_image_tokens, batch,
                                   seq_len - cfg.num_image_tokens, seed=seed)
    return SyntheticLM(cfg.vocab_size, batch, seq_len, seed=seed)
