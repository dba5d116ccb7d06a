"""zamba2-7b [hybrid]: Mamba2 blocks + one SHARED attention block.

81 blocks, d_model=3584, shared attn 32H (kv=32, full MHA) d_ff=14336,
vocab=32000, ssm_state=64. Shared block applied every 6th position
(13 applications + 3 trailing mamba). [arXiv:2411.15242]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    attn_every=6,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab=32000,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_chunk=256,
    source="arXiv:2411.15242",
)
