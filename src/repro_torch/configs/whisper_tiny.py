"""whisper-tiny [audio]: enc-dec backbone, conv frontend stubbed.

4L (enc) + 4L (dec), d_model=384, 6H (kv=6), d_ff=1536, vocab=51865.
[arXiv:2212.04356]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,
    n_enc_layers=4,
    enc_seq=1500,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab=51865,
    act="gelu",
    norm="layernorm",
    source="arXiv:2212.04356",
)
