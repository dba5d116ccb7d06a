from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import get_family, input_specs, make_batch

__all__ = ["ModelConfig", "get_family", "input_specs", "lm", "make_batch"]
