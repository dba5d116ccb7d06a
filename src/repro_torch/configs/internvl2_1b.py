"""internvl2-1b [vlm]: InternViT (stub) + InternLM2-ish decoder.

24L, d_model=896, 14H (kv=2), d_ff=4864, vocab=151655; patch-embedding
prefix provided by the vision-frontend stub. [arXiv:2404.16821]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab=151655,
    n_patches=256,
    vision_dim=1024,
    rope_base=1e6,
    source="arXiv:2404.16821",
)
