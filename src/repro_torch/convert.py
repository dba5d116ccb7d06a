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

from repro_torch.comm.controller import ControllerState
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


def _is_compact_tree(sp_state) -> bool:
    return not isinstance(sp_state, tuple)


def trainer_state_to_jax(sp_state: Any, plan: Any) -> Any:
    """The trainer's sparsifier state (a tree of ``CompactState``, or under
    ``adaptive_k`` the pair with the controller tree) in the JAX trainer's
    layout (``repro.core.distributed.sparsifier_state_shapes``) for W
    workers of M model shards (the plan's ``shards``): ``eps [W,
    *global_shape]`` (each shard's block put back in its place; a leaf
    left whole from its first shard), ``sent_* [W, M, k]`` with
    ``sent_idx`` int32 and block-local, ``t [W]``. The controller tree is
    common to both packages. This is what a checkpoint holds."""
    from repro_torch.core.distributed import merge_blocks

    if not _is_compact_tree(sp_state):
        return (trainer_state_to_jax(sp_state[0], plan), sp_state[1])

    def leaf(st: CompactState, p) -> CompactState:
        M = p.shards
        W = st.eps.shape[0] // M

        def slots(x):
            return x.reshape(W, M, *x.shape[1:])

        return CompactState(
            eps=merge_blocks(st.eps, p),
            sent_vals=slots(st.sent_vals), sent_g=slots(st.sent_g),
            sent_idx=slots(st.sent_idx.to(torch.int32)),
            sent_w=slots(st.sent_w), t=slots(st.t)[:, 0],
        )

    return tree_map(leaf, sp_state, plan)


def trainer_state_from_jax(sp_state: Any, plan: Any) -> Any:
    """:func:`trainer_state_to_jax` undone: a state in the JAX trainer's
    layout (torch tensors, e.g. restored from a checkpoint) as the port
    keeps it, a row per (worker, model shard), worker major: ``eps [W x
    M, local_len]``, ``sent_* [W x M, k]``, ``sent_idx`` int64, ``t [W x
    M]``. ``sent_*``'s middle axis must be the plan's ``shards``."""
    from repro_torch.core.distributed import shard_blocks

    if not _is_compact_tree(sp_state):
        return (trainer_state_from_jax(sp_state[0], plan), sp_state[1])

    def leaf(st: CompactState, p) -> CompactState:
        W, M = st.eps.shape[0], p.shards
        if st.sent_vals.shape[1] != M:
            raise ValueError(
                f"a state of {st.sent_vals.shape[1]} model shards; the plan "
                f"has {M}"
            )

        def rows(x):
            return x.reshape(W * M, *x.shape[2:])

        return CompactState(
            eps=shard_blocks(st.eps, p),
            sent_vals=rows(st.sent_vals), sent_g=rows(st.sent_g),
            sent_idx=rows(st.sent_idx).to(torch.int64),
            sent_w=rows(st.sent_w),
            t=st.t.to(torch.int32).repeat_interleave(M),
        )

    return tree_map(leaf, sp_state, plan)


def sim_state_from_jax(tree_of_numpy: Any, device="cuda"):
    """The JAX simulator's state with numpy leaves
    (``jax.tree.map(np.asarray, state)``) → the port's ``SimState``, with
    the ``stale`` pending buffer, the controller state and ``w_agg_prev``
    (coordinate weighting) where they are set."""
    def opt(value, dtype=None):
        if value is None:
            return None
        x = torch.tensor(np.array(value), device=device)
        return x if dtype is None else x.to(dtype)

    ctrl = getattr(tree_of_numpy, "ctrl", None)
    return SimState(
        theta=torch.tensor(np.array(tree_of_numpy.theta), device=device),
        worker_states=dense_state_from_jax(tree_of_numpy.worker_states, device),
        g_agg_prev=torch.tensor(np.array(tree_of_numpy.g_agg_prev), device=device),
        step=int(tree_of_numpy.step),
        pending=opt(getattr(tree_of_numpy, "pending", None)),
        pending_age=opt(getattr(tree_of_numpy, "pending_age", None), torch.int32),
        ctrl=None if ctrl is None else ControllerState(
            err_ratio=opt(ctrl.err_ratio, torch.float32),
            k=opt(ctrl.k, torch.int32), t=opt(ctrl.t, torch.int32)),
        w_agg_prev=opt(getattr(tree_of_numpy, "w_agg_prev", None)),
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
        "pending": (None if state.pending is None
                    else state.pending.detach().cpu().numpy()),
        "pending_age": (None if state.pending_age is None
                        else state.pending_age.detach().cpu().numpy()),
        "ctrl": (None if state.ctrl is None else {
            name: getattr(state.ctrl, name).detach().cpu().numpy()
            for name in state.ctrl._fields}),
    }


def linreg_from_jax(dataset_numpy: Any, device="cuda"):
    """The JAX package's ``LinRegDataset`` with numpy leaves → the
    port's, the same arrays."""
    return LinRegDataset(*(
        torch.tensor(np.array(getattr(dataset_numpy, name)), device=device)
        for name in LinRegDataset._fields
    ))
