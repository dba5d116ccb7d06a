"""Synthetic LM token stream (counterpart of
``repro.data.pipeline.TokenPipeline``).

Same structure as the JAX pipeline: Zipf-ish token marginals from a
squared uniform, and labels that repeat the token three back with
probability 0.5 (else the next token). Each batch is a pure function of
``(seed, step)``: it is drawn on the CPU from a ``torch.Generator`` seeded
from that pair and then moved to ``device``, so every device sees the same
batches. torch cannot reproduce ``jax.random`` streams, so the numbers
differ from the JAX pipeline's; tests hand both stacks the same arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    cfg: ModelConfig
    global_batch: int
    seq: int
    seed: int = 0
    device: str = "cuda"

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        gen = torch.Generator().manual_seed(self.seed * 1_000_003 + int(step))
        B, S, V = self.global_batch, self.seq, self.cfg.vocab
        u = torch.rand((B, S), generator=gen)
        tokens = torch.clamp((u * u * V).long(), max=V - 1)
        flip = torch.rand((B, S), generator=gen) < 0.5
        recent = torch.roll(tokens, 3, dims=1)
        labels = torch.where(flip, recent, torch.roll(tokens, -1, dims=1))
        return {
            "tokens": tokens.to(self.device),
            "labels": labels.to(self.device),
        }
