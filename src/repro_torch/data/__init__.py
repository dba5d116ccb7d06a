from repro_torch.data.pipeline import (
    LinRegDataset,
    TokenPipeline,
    linreg_grad_fn,
    make_linreg,
)

__all__ = ["LinRegDataset", "TokenPipeline", "linreg_grad_fn", "make_linreg"]
