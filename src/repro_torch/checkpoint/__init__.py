"""Tree checkpoints in the JAX package's format (npz + msgpack)."""
from repro_torch.checkpoint.store import metadata, restore, save

__all__ = ["save", "restore", "metadata"]
