"""Unified model configuration (counterpart of ``repro.models.config``):
every field of the JAX package's ``ModelConfig``, so a config moves
between the two packages field for field."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | encdec | vlm | ssm | hybrid | moe
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab: int = 1024

    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_fraction: float = 1.0  # 0.5 == ChatGLM "RoPE 2d" (half-rotary)
    rope_base: float = 10000.0
    act: str = "swiglu"  # swiglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-6
    sliding_window: Optional[int] = None
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    moe_top_k: int = 0
    n_shared_experts: int = 0
    moe_shared_d_ff: Optional[int] = None
    moe_parallelism: str = "tensor"  # tensor | expert
    capacity_factor: float = 1.25
    moe_group_size: int = 4096
    aux_loss_coef: float = 0.01
    moe_dispatch: str = "einsum"  # einsum (GShard one-hot) | gather (rows)

    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256

    # --- hybrid (zamba2): shared attention block every N mamba blocks ---
    attn_every: int = 6

    # --- enc-dec (whisper): encoder consumes frontend-stub embeddings ---
    n_enc_layers: int = 0
    enc_seq: int = 1500

    # --- VLM: patch-embedding prefix from the vision-frontend stub ---
    n_patches: int = 0
    vision_dim: int = 0

    # --- numerics / execution ---
    dtype: str = "float32"
    remat: bool = True
    remat_policy: str = "full"  # the port recomputes whole blocks
    pad_heads: Optional[int] = None  # zero-initialised extra q-heads
    vocab_pad_multiple: int = 256
    attn_block: int = 1024  # chunked-attention KV block (prefill)
    source: str = ""  # citation for the config

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab // m) * m

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def eff_heads(self) -> int:
        """Query heads after padding (``pad_heads``)."""
        return max(self.n_heads, self.pad_heads or 0)

    @property
    def eff_kv_heads(self) -> int:
        if self.pad_heads and self.pad_heads > self.n_heads:
            ratio = max(1, self.n_heads // max(1, self.n_kv_heads))
            return max(1, self.pad_heads // ratio)
        return self.n_kv_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def smoke_variant(self) -> "ModelConfig":
        """Reduced config of the same family for CPU smoke tests (<= 2
        layers, d_model <= 128, <= 4 experts), branch for branch the JAX
        package's ``smoke_variant``."""
        kw = dict(
            n_layers=2,
            d_model=min(self.d_model, 128),
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            dtype="float32",
            remat=False,
            moe_group_size=256,
        )
        kw["n_heads"] = min(self.n_heads, 4)
        kw["n_kv_heads"] = min(self.n_kv_heads, max(1, kw["n_heads"] // 2))
        if self.n_heads and kw["n_heads"] % kw["n_kv_heads"]:
            kw["n_kv_heads"] = 1
        kw["head_dim"] = 32
        if self.is_moe:
            kw["n_experts"] = min(self.n_experts, 4)
            kw["moe_top_k"] = min(self.moe_top_k, 2)
            kw["moe_shared_d_ff"] = (
                min(self.moe_shared_d_ff, 256) if self.moe_shared_d_ff else None
            )
        if self.ssm_state:
            kw["ssm_state"] = min(self.ssm_state, 16)
            kw["ssm_headdim"] = 16
            kw["ssm_chunk"] = 32
        if self.n_enc_layers:
            kw["n_enc_layers"] = 2
            kw["enc_seq"] = 16
        if self.n_patches:
            kw["n_patches"] = 8
            kw["vision_dim"] = 64
        if self.family == "hybrid":
            kw["n_layers"] = 5  # 2 groups: (2 mamba + attn) x2 rotation
            kw["attn_every"] = 3
        if self.sliding_window:
            kw["sliding_window"] = 16
        return self.replace(**kw)
