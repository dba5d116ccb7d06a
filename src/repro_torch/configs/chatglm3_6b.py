"""chatglm3-6b [dense]: RoPE 2d (half-rotary), GQA kv=2.

28L, d_model=4096, 32H (kv=2), d_ff=13696, vocab=65024.
[arXiv:2406.12793]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab=65024,
    rope_fraction=0.5,  # ChatGLM rotates half the head dim ("RoPE 2d")
    qkv_bias=True,
    source="arXiv:2406.12793",
)
