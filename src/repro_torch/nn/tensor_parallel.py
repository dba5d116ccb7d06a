"""The model group's collectives, as autograd Functions: what GSPMD
inserts where the JAX trainer partitions the forward over the ``model``
mesh axis, written out for a rank that holds its own block of each leaf
that ``nn.sharding`` splits.

* :func:`enter`: the identity forward, an all-reduce of the gradient
  backward. A whole activation that feeds a product over the rank's
  block enters the group through it, so its gradient is the sum of every
  rank's part;
* :func:`leave`: an all-reduce forward, the identity backward. The
  product over a sharded inner dimension (the attention output over the
  rank's heads, the MLP's down projection over its columns, the MoE
  layer's combine over the rank's expert columns or experts, the
  vocabulary-parallel lookup) leaves the group through it, whole on every
  rank;
* :func:`gather_last`: the ranks' blocks of the last dimension
  concatenated in shard order (the logits over the rank's vocabulary
  rows), and back the rank's own slice of the gradient. Right only where
  every rank's consumer computes the same thing from the whole (the
  loss from the logits);
* :func:`gather_leaf`: the ranks' blocks of a parameter leaf's last
  dimension concatenated in shard order, forward; backward, the
  gradient of the whole leaf summed over the group (an all-reduce) and
  this rank's block of the sum. A leaf whose contiguous blocks do not
  line up with what each rank computes from it (the SSD mixer's
  ``in_proj``, ``conv_w`` and ``conv_b``, split on ``"d_inner"`` across
  their ``z | x | B | C | dt`` parts) is gathered whole and each rank
  takes its own columns: each rank's gradient then holds its own
  columns' part, and the sum is the whole gradient;
* :func:`gather`: the ranks' tensors stacked in shard order, forward
  only (serving runs without gradients): the decode step's query heads
  and each rank's partial attention over its cache slots.

A :class:`ModelShard` names the rank's place in its model group and the
logical axes whose leaves are split there (``"heads"``, ``"kv_heads"``,
``"mlp"``, ``"vocab"``, the MoE experts' ``"moe_mlp"`` or
``"experts_sharded"``, and the SSD mixer's ``"d_inner"`` and
``"ssm_heads"``). Each Function adds the bytes its collective returns
on this rank to ``ModelShard.traffic``: an all-reduce the tensor's
bytes, an all-gather the whole result's. Without a group (the dry run
on the meta device) the Functions move nothing and only count: a meta
tensor's all-reduce is its own shape, and its gather the blocks' shape.

The collectives are ``comm.collectives``' ``_psum`` and ``_gather`` over
the one model group; under gloo a CUDA tensor is staged through the host
by the backend, which is how several ranks share one card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Optional

import torch

from repro_torch.nn.sharding import MODEL_AXIS
from repro_torch.tree import tree_leaves


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """This rank's shard ``index`` of ``size`` in its model ``group`` (a
    process group; None counts without communicating, on the meta device
    only), and the logical axes split over it."""

    group: Optional[object]
    index: int
    size: int
    split: FrozenSet[str]
    # bytes the collectives returned on this rank, by kind
    traffic: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"all-reduce": 0, "all-gather": 0},
        compare=False)

    def splits(self, axis: str) -> bool:
        """Whether the leaves of logical ``axis`` hold this rank's block."""
        return axis in self.split


def split_axes(axes, specs) -> FrozenSet[str]:
    """The logical axes that the specs split over the model axis: one
    name per split dim of ``axes`` (the family's ``param_axes``) beside
    ``specs`` (``nn.sharding.tree_specs``). A logical axis split in one
    leaf and whole in another raises: the divisibility guard decides by
    the axis' size, which every leaf of that axis shares."""
    split, whole = set(), set()
    for ax, spec in zip(tree_leaves(axes), tree_leaves(specs), strict=True):
        for name, entry in zip(ax, spec, strict=True):
            if name is not None:
                (split if entry == MODEL_AXIS else whole).add(name)
    mixed = split & whole
    if mixed:
        raise ValueError(f"logical axes {sorted(mixed)} are split in some "
                         "leaves and whole in others")
    return frozenset(split)


def _check(x: torch.Tensor, shard: ModelShard) -> None:
    if shard.group is None and x.device.type != "meta":
        raise ValueError("a ModelShard without a process group only counts, "
                         "on the meta device")


def _all_reduce(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    _check(x, shard)
    shard.traffic["all-reduce"] += x.numel() * x.element_size()
    if shard.group is None:  # the sum's own storage, as _psum's
        return x.clone()
    from repro_torch.comm.collectives import _psum

    return _psum(x.contiguous(), (shard.group,))


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.shard), None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        return _all_reduce(x, shard)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _own_block(g: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    n = g.shape[-1] // shard.size
    return g[..., shard.index * n:(shard.index + 1) * n]


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        _check(x, shard)
        ctx.shard = shard
        shard.traffic["all-gather"] += shard.size * x.numel() * x.element_size()
        if shard.group is None:
            return torch.cat([x] * shard.size, dim=-1)
        from repro_torch.comm.collectives import _gather

        parts = _gather(x[None], (shard.group,))  # [size, *x.shape]
        return torch.cat(parts.unbind(0), dim=-1)

    @staticmethod
    def backward(ctx, g):
        return _own_block(g, ctx.shard), None


class _GatherLeaf(_GatherLast):
    @staticmethod
    def backward(ctx, g):
        return _own_block(_all_reduce(g, ctx.shard), ctx.shard).contiguous(), None


def enter(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """``x`` as it is; its gradient summed over the model group."""
    return _Enter.apply(x, shard)


def leave(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """``x`` summed over the model group; its gradient as it is."""
    return _Leave.apply(x, shard)


def gather_last(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """The model group's blocks of ``x``'s last dim, in shard order; the
    gradient of this rank's block is its slice."""
    return _GatherLast.apply(x, shard)


def gather_leaf(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """The model group's blocks of ``x``'s last dim, in shard order; the
    gradient of this rank's block is its slice of the whole gradient
    summed over the group."""
    return _GatherLeaf.apply(x, shard)


def gather(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """``[size, *x.shape]``: every rank's ``x`` in shard order, the same
    bits on every rank; forward only, for serving under ``no_grad``."""
    _check(x, shard)
    shard.traffic["all-gather"] += shard.size * x.numel() * x.element_size()
    if shard.group is None:
        return x[None].expand(shard.size, *x.shape).clone()
    from repro_torch.comm.collectives import _gather

    return _gather(x.contiguous()[None], (shard.group,))
