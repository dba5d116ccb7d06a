"""Model configuration: the fields the dense LM family reads
(counterpart of ``repro.models.config``)."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab: int = 1024
    head_dim: Optional[int] = None
    rope_fraction: float = 1.0
    rope_base: float = 10000.0
    norm_eps: float = 1e-6
    sliding_window: Optional[int] = None
    vocab_pad_multiple: int = 256
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab // m) * m

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def smoke_variant(self) -> "ModelConfig":
        """Reduced config of the same family for CPU tests, with the same
        reductions as ``repro.models.config.ModelConfig.smoke_variant``
        applies to a dense model."""
        n_heads = min(self.n_heads, 4)
        n_kv = min(self.n_kv_heads, max(1, n_heads // 2))
        if n_heads % n_kv:
            n_kv = 1
        return self.replace(
            n_layers=2,
            d_model=min(self.d_model, 128),
            d_ff=min(self.d_ff, 256),
            vocab=min(self.vocab, 512),
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=32,
            sliding_window=16 if self.sliding_window else None,
        )
