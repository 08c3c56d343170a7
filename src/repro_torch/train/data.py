"""Synthetic data pipeline of the port, the reference's
``repro/train/data.py`` in numpy (the port imports nothing of the reference
package, so it keeps its own copy).  The same config and seed give batches
equal to the reference's, the modality stubs included.

Deterministic, seeded batches shaped like a production text pipeline:
Zipf-distributed token streams segmented into documents, packed into
fixed-length rows with a prompt/response split (the response region is the
diffusion-masking loss region).  Modality stubs supply frame/patch
embeddings for the audio and vision archs.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    mean_doc_len: int = 512
    prompt_fraction: float = 0.25      # leading span treated as prompt
    n_enc_tokens: int = 0              # > 0 for the audio and vision stubs
    d_enc: int = 0


class SyntheticTextDataset:
    """Deterministic packed-document batch iterator."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._rng = np.random.default_rng(cfg.seed)

    def _sample_tokens(self, n: int) -> np.ndarray:
        c = self.cfg
        # Zipf over the real vocab (ids [3, vocab)); 0/1/2 reserved pad/bos/eos
        raw = self._rng.zipf(c.zipf_a, size=2 * n)
        raw = raw[raw < c.vocab_size - 3][:n]
        while raw.size < n:
            extra = self._rng.zipf(c.zipf_a, size=n)
            raw = np.concatenate([raw, extra[extra < c.vocab_size - 3]])[:n]
        return (raw + 2).astype(np.int32)

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()

    def next_batch(self) -> dict:
        """``{"tokens" [B, L] int32, "loss_region" [B, L] bool}``, and
        ``"enc_embeds" [B, E, d_enc]`` float32 where ``n_enc_tokens`` > 0."""
        c = self.cfg
        b, l = c.global_batch, c.seq_len
        tokens = np.empty((b, l), np.int32)
        loss_region = np.zeros((b, l), bool)
        for i in range(b):
            row = self._sample_tokens(l)
            # segment into documents with eos boundaries
            pos = 0
            while pos < l:
                dl = int(self._rng.exponential(c.mean_doc_len)) + 8
                end = min(pos + dl, l)
                if end < l:
                    row[end - 1] = 2      # eos
                pos = end
            tokens[i] = row
            p = int(l * c.prompt_fraction)
            loss_region[i, p:] = True
        out = {"tokens": tokens, "loss_region": loss_region}
        if c.n_enc_tokens:
            out["enc_embeds"] = self._rng.standard_normal(
                (b, c.n_enc_tokens, c.d_enc), dtype=np.float32)
        return out
