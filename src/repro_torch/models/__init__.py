from repro_torch.models import lm
from repro_torch.models.config import ModelConfig

__all__ = ["ModelConfig", "lm"]
