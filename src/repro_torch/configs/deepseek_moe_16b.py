"""deepseek-moe-16b [moe]: fine-grained 64 routed top-6 + 2 shared experts.

28L, d_model=2048, 16H (kv=16), expert d_ff=1408, vocab=102400.
[arXiv:2401.06066]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab=102400,
    n_experts=64,
    moe_top_k=6,
    n_shared_experts=2,
    moe_shared_d_ff=2816,  # 2 shared experts x 1408
    source="arXiv:2401.06066",
)
