from repro_torch.optim.optimizers import OptConfig, adam, make_optimizer

__all__ = ["OptConfig", "adam", "make_optimizer"]
