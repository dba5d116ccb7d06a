from repro_torch.nn import layers

__all__ = ["layers"]
