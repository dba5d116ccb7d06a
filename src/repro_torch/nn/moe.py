"""Mixture-of-Experts layer (counterpart of ``repro.nn.moe``): GShard-style
capacity routing with a one-hot (``"einsum"``) or a row (``"gather"``)
dispatch, shared experts, and the Switch load-balance loss.

The routing follows the JAX package step for step:

* the tokens are cut into groups of ``group_size``; the last group is
  padded with zero rows, and those rows route too (their logits are 0, so
  their probabilities tie and they take experts ``0 .. top_k-1``, slots
  and a share of ``f_e``), as the JAX layer routes them;
* the top-k of each token's probabilities is ``lax.top_k``'s, ties to the
  lowest expert (``core.selectors.topk_stable``; ``torch.topk`` documents
  no tie order);
* a (token, choice) takes the next slot of its expert's buffer in token
  order, and is dropped at ``capacity = max(1, int(g * top_k *
  capacity_factor / E))`` (``g`` with ``no_drop``), the capacity taken in
  Python floats;
* the constant divisions (``f_e``'s ``/ (g * top_k)``, the means over the
  group's tokens and over the groups) are products with the float32
  reciprocal, as XLA computes them under ``jit``
  (``kernels.regtopk_score.const_div``).

Tensor and expert parallelism: under a ``shard``
(``nn.tensor_parallel.ModelShard``), ``moe_apply`` runs on the rank's
blocks of the expert leaves, in the layout that ``moe_axes`` gave them:

* ``shard.splits("moe_mlp")`` (``"tensor"``): every expert, and the
  rank's columns of its FFN width, ``wg``/``wu [E, D, F/M]`` and ``wd
  [E, F/M, D]``; the expert FFN gives a partial sum over the columns;
* ``shard.splits("experts_sharded")`` (``"expert"``): the experts ``[e0,
  e0 + E/M)``, ``e0 = shard.index * E/M``, whole. The ``"einsum"``
  dispatch builds the rank's ``[g, E/M, cap]`` columns of the dispatch
  and combine tensors, the ``"gather"`` dispatch the rank's experts'
  slots (``(gate_idx - e0) * cap + pos``), every other (token, choice)
  parked in the extra row as a dropped one is;
* the shared experts under ``shard.splits("mlp")``: the rank's columns
  in and rows out, as ``nn.layers.mlp``.

The routing stays whole and the same on every rank: the router ``[D,
E]``, the softmax, ``route``, the capacity, the padded rows, the counts
and the aux loss, which no collective touches (a sum over the group
would multiply them by M). The partial outputs, the routed one after the
combine (``[g, D]`` a group, not ``[E, cap, D]``) and the shared one,
are added and leave the group together: with both split, a layer's
forward issues one all-reduce, of ``x``'s shape, and its backward one
of ``x``'s shape (the gradient of the split branches' input) and one of
the ``[g, top_k]`` float32 gates a group. Two gradients are kept whole:

* (a) only the split branches' input enters the group (``TP.enter``);
  the router's input does not, since its gradient is whole on every
  rank already, and an ``enter`` at the top of the layer (as
  ``nn.layers.mlp`` places it) would sum that part M times;
* (b) the gates enter the group before they weight the combine (the
  ``"gather"`` path's weighted sum, the ``"einsum"`` path's ``comb``):
  a rank's gradient of a gate covers only its columns or its experts,
  and the sum over the group is the whole one, the same in bits on
  every rank (gloo hands every rank the same sum), so the router, a
  whole leaf, stays equal across the ranks.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.selectors import topk_stable
from repro_torch.kernels.regtopk_score import const_div, ordered_mean
from repro_torch.nn import tensor_parallel as TP
from repro_torch.nn.layers import _normal

Params = Dict[str, torch.Tensor]

MOE_DISPATCHES = ("einsum", "gather")


def moe_init(
    gen: torch.Generator, d_model: int, d_ff: int, n_experts: int, device, *,
    n_shared: int = 0, shared_d_ff: Optional[int] = None,
    dtype: torch.dtype = torch.float32,
) -> Params:
    """``router [D, E]``, the experts' ``wg``/``wu [E, D, F]`` and ``wd [E,
    F, D]``, and, with ``n_shared``, one SwiGLU ``shared`` block of width
    ``shared_d_ff`` (default ``n_shared * d_ff``)."""
    s = d_model**-0.5
    so = d_ff**-0.5
    p = {
        "router": _normal(gen, (d_model, n_experts), s, device, dtype),
        "wg": _normal(gen, (n_experts, d_model, d_ff), s, device, dtype),
        "wu": _normal(gen, (n_experts, d_model, d_ff), s, device, dtype),
        "wd": _normal(gen, (n_experts, d_ff, d_model), so, device, dtype),
    }
    if n_shared:
        sf = shared_d_ff or (n_shared * d_ff)
        p["shared"] = {
            "wg": _normal(gen, (d_model, sf), s, device, dtype),
            "wu": _normal(gen, (d_model, sf), s, device, dtype),
            "wd": _normal(gen, (sf, d_model), sf**-0.5, device, dtype),
        }
    return p


def moe_axes(*, n_shared: int = 0, parallelism: str = "tensor"
             ) -> Dict[str, object]:
    """The logical axes of ``moe_init``'s weights under ``parallelism``:
    ``"tensor"`` shards each expert's FFN width (``moe_mlp``) and keeps
    the experts whole (``experts``); ``"expert"`` shards the experts
    (``experts_sharded``) and keeps their width whole."""
    e_ax = "experts" if parallelism == "tensor" else "experts_sharded"
    f_ax = "moe_mlp" if parallelism == "tensor" else None
    a: Dict[str, object] = {
        "router": ("embed", None),
        "wg": (e_ax, "embed", f_ax),
        "wu": (e_ax, "embed", f_ax),
        "wd": (e_ax, f_ax, "embed"),
    }
    if n_shared:
        a["shared"] = {"wg": ("embed", "mlp"), "wu": ("embed", "mlp"),
                       "wd": ("mlp", "embed")}
    return a


def _expert_ffn(p: Params, xe: torch.Tensor) -> torch.Tensor:
    """``xe [E, C, D] -> [E, C, D]``, SwiGLU per expert."""
    h = F.silu(torch.einsum("ecd,edf->ecf", xe, p["wg"].to(xe.dtype)))
    h = h * torch.einsum("ecd,edf->ecf", xe, p["wu"].to(xe.dtype))
    return torch.einsum("ecf,efd->ecd", h, p["wd"].to(xe.dtype))


def capacity(g: int, top_k: int, capacity_factor: float, n_experts: int,
             no_drop: bool = False) -> int:
    """Slots per expert in a group of ``g`` tokens.

    >>> capacity(1024, 6, 1.25, 64)
    120
    >>> capacity(3, 1, 0.5, 4), capacity(3, 1, 0.5, 4, no_drop=True)
    (1, 3)
    """
    if no_drop:
        return g
    return max(1, int(g * top_k * capacity_factor / n_experts))


def route(probs: torch.Tensor, top_k: int, cap: int):
    """Routing of one group: ``(gate_vals [g, k], gate_idx [g, k], pos [g,
    k], keep [g, k])``: the renormalized top-k gates, their experts (ties
    to the lowest expert), each choice's slot in its expert's buffer in
    (token, choice) order, and whether that slot is below ``cap``."""
    g, E = probs.shape
    gate_vals, gate_idx = topk_stable(probs, top_k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    flatoh = F.one_hot(gate_idx, E).reshape(g * top_k, E)
    pos = torch.cumsum(flatoh, dim=0) - flatoh
    pos = (pos * flatoh).sum(-1).reshape(g, top_k)
    return gate_vals, gate_idx, pos, pos < cap


def _group(p: Params, xs: torch.Tensor, xd: torch.Tensor, top_k: int,
           cap: int, dispatch: str, shard: Optional[TP.ModelShard] = None):
    """One group's ``(out [g, D], aux)``: ``xs`` routes and ``xd``, the
    same rows, is dispatched. Under ``shard`` (the experts split) ``xd``
    has entered the model group, the expert leaves are the rank's blocks
    and ``out`` is its partial sum (module docstring)."""
    g, D = xs.shape
    E = p["router"].shape[-1]
    El = p["wg"].shape[0]  # the experts this rank holds
    e0 = 0 if El == E else shard.index * El
    logits = xs.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx, pos, keep = route(probs, top_k, cap)
    if shard is not None:  # trap (b): a gate's gradient summed over the group
        gate_vals = TP.enter(gate_vals, shard)
    if dispatch == "gather":
        # each kept (token, choice) of this rank's experts written to its
        # unique slot, the others parked in one extra row that is cut off
        mine = keep & (gate_idx >= e0) & (gate_idx < e0 + El)
        slot = torch.where(mine, (gate_idx - e0) * cap + pos,
                           El * cap).reshape(-1)
        tok = torch.arange(g, device=xs.device).repeat_interleave(top_k)
        xe_flat = torch.zeros((El * cap + 1, D), dtype=xd.dtype,
                              device=xd.device).index_put((slot,), xd[tok])
        ye = _expert_ffn(p, xe_flat[: El * cap].reshape(El, cap, D))
        ye_flat = torch.cat([ye.reshape(El * cap, D),
                             torch.zeros((1, D), dtype=ye.dtype, device=ye.device)])
        picked = ye_flat[slot].reshape(g, top_k, D)
        out = torch.einsum("gk,gkd->gd", (gate_vals * keep).to(xd.dtype), picked)
    elif dispatch == "einsum":
        # the GShard one-hot [g, E, cap] dispatch and combine tensors (the
        # columns of this rank's experts); a slot at or past cap has no
        # one-hot column, as jax.nn.one_hot gives it none
        experts = torch.arange(e0, e0 + El, device=xs.device)
        slots = torch.arange(cap, device=xs.device)
        disp = torch.zeros((g, El, cap), dtype=xd.dtype, device=xd.device)
        comb = torch.zeros_like(disp)
        for c in range(top_k):
            oh = ((gate_idx[:, c, None] == experts).to(xd.dtype)[:, :, None]
                  * (pos[:, c, None] == slots).to(xd.dtype)[:, None, :])
            oh = oh * keep[:, c, None, None].to(xd.dtype)
            disp = disp + oh
            comb = comb + oh * gate_vals[:, c, None, None].to(xd.dtype)
        xe = torch.einsum("tec,td->ecd", disp, xd)
        out = torch.einsum("tec,ecd->td", comb, _expert_ffn(p, xe))
    else:
        raise ValueError(
            f"unknown moe dispatch {dispatch!r}; available: {MOE_DISPATCHES}"
        )
    # Switch aux loss: E * sum_e f_e * p_e
    # the experts' counts without bincount, which reads the largest index
    # on the host (a sync each layer of a decode step on the card)
    flat = gate_idx.reshape(-1)
    counts = torch.zeros(E, dtype=flat.dtype, device=flat.device).scatter_add_(
        0, flat, torch.ones_like(flat))
    f_e = const_div(counts.float(), float(g * top_k))
    p_e = const_div(probs.sum(0), float(g))
    aux = E * torch.sum(f_e * p_e)
    return out, aux


def moe_apply(
    p: Params, x: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25,
    group_size: int = 4096, no_drop: bool = False, dispatch: str = "einsum",
    shard: Optional[TP.ModelShard] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x [B, S, D]`` → ``(y [B, S, D], aux)``, the Switch load-balance
    loss averaged over the groups. ``no_drop`` sets the capacity to the
    group size (serving never drops a token). Under ``shard`` the expert
    leaves are the rank's blocks and ``y`` is whole on every rank (module
    docstring)."""
    B, S, D = x.shape
    E = p["router"].shape[-1]
    routed_tp = shard is not None and (shard.splits("moe_mlp")
                                       or shard.splits("experts_sharded"))
    shared_tp = shard is not None and "shared" in p and shard.splits("mlp")
    # trap (a): the split branches' input enters the group, the router's not
    xe = TP.enter(x, shard) if routed_tp or shared_tp else x
    xt = x.reshape(B * S, D)
    xd = xe.reshape(B * S, D) if routed_tp else xt
    T = xt.shape[0]
    g = min(group_size, T)
    n_groups = -(-T // g)
    pad = n_groups * g - T
    if pad:
        xt = F.pad(xt, (0, 0, 0, pad))
        xd = F.pad(xd, (0, 0, 0, pad)) if routed_tp else xt
    cap = capacity(g, top_k, capacity_factor, E, no_drop)
    outs, auxs = zip(*(_group(p, xt[i * g:(i + 1) * g], xd[i * g:(i + 1) * g],
                              top_k, cap, dispatch, shard if routed_tp else None)
                       for i in range(n_groups)), strict=True)
    y = torch.cat(outs)[:T].reshape(B, S, D)
    ys = None
    if "shared" in p:
        sp = p["shared"]
        xs = xe if shared_tp else x
        h = F.silu(xs @ sp["wg"].to(x.dtype)) * (xs @ sp["wu"].to(x.dtype))
        ys = h @ sp["wd"].to(x.dtype)
        if shared_tp == routed_tp:  # both partial sums, or both whole
            y, ys = y + ys, None
    if routed_tp:
        y = TP.leave(y, shard)
    if ys is not None:
        y = y + (TP.leave(ys, shard) if shared_tp else ys)
    return y, ordered_mean(torch.stack(auxs))
