"""Paper-native NN experiment proxy (ResNet-18/CIFAR-10 stand-in), the
same widths as ``repro.configs.paper_resnet_proxy``."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paper-resnet-proxy",
    n_layers=4,
    d_model=256,
    n_heads=8,
    n_kv_heads=8,
    head_dim=32,
    d_ff=1024,
    vocab=1024,
    source="paper Sec. 5.2 (ResNet-18/CIFAR-10), proxied",
)
