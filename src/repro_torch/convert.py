"""Weights between the two stacks, name for name.

The port keeps the JAX package's parameter tree (same dict keys, same
shapes, layer leaves stacked on a leading axis), so a tree of numpy arrays
taken from ``repro`` (``jax.tree.map(np.asarray, params)``) converts leaf
by leaf.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_map


def params_from_jax(tree_of_numpy: Any, device="cuda") -> Any:
    """Nested dict of numpy arrays → the port's parameter tree."""
    return tree_map(
        lambda x: torch.tensor(np.array(x), device=device), tree_of_numpy
    )


def params_to_numpy(params: Any) -> Any:
    """The port's parameter tree → nested dict of numpy arrays (the form
    ``repro`` takes back through ``jax.tree.map(jnp.asarray, ...)``)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)
