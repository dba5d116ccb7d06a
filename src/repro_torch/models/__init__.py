from repro_torch.models import encdec, lm, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import (
    get_family,
    input_specs,
    make_batch,
    param_axes,
    serve_parallel,
    tensor_parallel,
)

__all__ = ["ModelConfig", "encdec", "get_family", "input_specs", "lm",
           "make_batch", "param_axes", "serve_parallel", "ssm", "tensor_parallel"]
