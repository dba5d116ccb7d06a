"""Weights, simulator states and data between the two stacks, name for
name.

The port keeps the JAX package's parameter tree (same dict keys, same
shapes, layer leaves stacked on a leading axis), so a tree of numpy arrays
taken from ``repro`` (``jax.tree.map(np.asarray, params)``) converts leaf
by leaf.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.compact import CompactState
from repro_torch.core.simulator import SimState
from repro_torch.core.sparsify import DenseState
from repro_torch.data.pipeline import LinRegDataset
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


def dense_state_from_jax(tree_of_numpy: Any, device="cuda"):
    """The JAX package's per-worker sparsifier state with numpy leaves and
    a leading worker axis on every slot (``jax.tree.map(np.asarray,
    state)``) → the port's ``DenseState``."""
    def t(name, dtype=None):
        x = torch.tensor(np.array(getattr(tree_of_numpy, name)), device=device)
        return x if dtype is None else x.to(dtype)

    return DenseState(
        eps=t("eps"), a_prev=t("a_prev"), s_prev=t("s_prev"),
        t=t("t", torch.int32),
    )


def compact_state_from_jax(tree_of_numpy: Any, device="cuda"):
    """The JAX package's ``CompactState`` with numpy leaves and a leading
    worker axis on every slot (the per-worker states stacked) → the
    port's, ``sent_w`` (the sender mass under coordinate weighting)
    included; indices become int64, the round counter int32."""
    def t(name, dtype=None):
        x = torch.tensor(np.array(getattr(tree_of_numpy, name)), device=device)
        return x if dtype is None else x.to(dtype)

    return CompactState(
        eps=t("eps"), sent_vals=t("sent_vals"), sent_g=t("sent_g"),
        sent_idx=t("sent_idx", torch.int64), sent_w=t("sent_w"),
        t=t("t", torch.int32),
    )


def sim_state_from_jax(tree_of_numpy: Any, device="cuda"):
    """The JAX simulator's state with numpy leaves
    (``jax.tree.map(np.asarray, state)``) → the port's ``SimState``, with
    ``w_agg_prev`` (coordinate weighting) when it is set. Only the
    full-participation, static-k state converts: its participation and
    controller fields must be None."""
    for name in ("pending", "pending_age", "ctrl"):
        if getattr(tree_of_numpy, name, None) is not None:
            raise ValueError(f"SimState.{name} is not ported; it must be None")
    w_agg_prev = getattr(tree_of_numpy, "w_agg_prev", None)
    return SimState(
        theta=torch.tensor(np.array(tree_of_numpy.theta), device=device),
        worker_states=dense_state_from_jax(tree_of_numpy.worker_states, device),
        g_agg_prev=torch.tensor(np.array(tree_of_numpy.g_agg_prev), device=device),
        step=int(tree_of_numpy.step),
        w_agg_prev=(None if w_agg_prev is None
                    else torch.tensor(np.array(w_agg_prev), device=device)),
    )


def sim_state_to_numpy(state) -> dict:
    """The port's ``SimState`` → a dict of numpy arrays with the JAX
    state's field names (``worker_states`` a dict of its four slots)."""
    ws = state.worker_states
    return {
        "theta": state.theta.detach().cpu().numpy(),
        "worker_states": {
            name: getattr(ws, name).detach().cpu().numpy()
            for name in ws._fields
        },
        "g_agg_prev": state.g_agg_prev.detach().cpu().numpy(),
        "step": int(state.step),
        "w_agg_prev": (None if state.w_agg_prev is None
                       else state.w_agg_prev.detach().cpu().numpy()),
    }


def linreg_from_jax(dataset_numpy: Any, device="cuda"):
    """The JAX package's ``LinRegDataset`` with numpy leaves → the
    port's, the same arrays."""
    return LinRegDataset(*(
        torch.tensor(np.array(getattr(dataset_numpy, name)), device=device)
        for name in LinRegDataset._fields
    ))
