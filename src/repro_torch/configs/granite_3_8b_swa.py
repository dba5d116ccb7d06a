"""granite-3-8b-swa [dense, beyond-assignment]: sliding-window variant.

Same dims as granite-3-8b with a 4096 sliding window: the dense->SWA
variant whose bounded cache makes long_500k decode feasible.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b-swa",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab=49155,
    sliding_window=4096,
    source="hf:ibm-granite/granite-3.0-2b-base (+SWA, ours)",
)
