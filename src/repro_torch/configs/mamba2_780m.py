"""mamba2-780m [ssm]: SSD (state-space duality), attention-free.

48L, d_model=1536, d_ff=0 (mixer includes expansion), vocab=50280,
ssm_state=128. [arXiv:2405.21060]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    head_dim=64,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_chunk=256,
    source="arXiv:2405.21060",
)
