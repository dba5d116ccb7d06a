"""Logical-axis → mesh-axis resolution (counterpart of
``repro.nn.sharding``, MaxText-style sharding rules).

Every family's ``param_axes(cfg)`` returns a tree of logical axis name
tuples beside its ``init``'s parameters, e.g. ``("embed", "mlp")`` for an
MLP up-projection. This module maps those names onto the axes of a
``(data, model)`` mesh, with the JAX package's divisibility guard: a
logical axis is sharded only if its size is divisible by the mesh axis it
would map to and at least as large (otherwise it stays whole, e.g.
phi3's 40 heads on a 16-way model axis while its 17920-wide FFN shards).

The mesh is a plain ``{axis name: size}`` mapping (``launch.mesh``'s
``host_shape`` / ``production_shape``), not a device mesh, and a spec is a
tuple with one entry per dim: a mesh axis name, a tuple of names (the dp
axes, for ``"__dp__"``), or None. It stands in for ``PartitionSpec``.
``repro.nn.sharding.tree_shardings`` has no counterpart: it builds
``NamedSharding``s, and the port places nothing by spec. A rank of a
model group holds its own block of each leaf a spec splits over
``model`` instead: :func:`shard_params` cuts the blocks out of a whole
tree (the port's seeded init, or weights carried across from JAX by
``convert``), and :func:`unshard_params` puts them back together over the
model group. The block is the contiguous slice along the split dim,
which flattens row-major exactly as ``core.distributed.shard_blocks``
flattens a shard's block, so a rank's gradient is its round's row.

Serving lays the parameters and the decode cache out by
:func:`serve_rules`, the JAX dry run's serve rules: the kv heads split
where the model axis divides them, else the cache's slots (``kv_seq``).
:func:`serve_shard` gives a serving rank its ``ModelShard``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map

Spec = Tuple[object, ...]
MODEL_AXIS = "model"

# default logical → mesh-axis rules; batch-like axes go to data parallel.
DEFAULT_RULES: Dict[str, Optional[str]] = {
    # tensor-parallel candidates
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "moe_mlp": "model",
    "d_inner": "model",
    "ssm_heads": "model",
    "experts": None,  # default: tensor-parallel MoE (experts replicated)
    "experts_sharded": "model",  # expert-parallel layout
    # replicated
    "embed": None,
    "layers": None,
    "blocks": None,
    "head_dim": None,
    "ssm_state": None,
    "conv": None,
    "expert_in": None,
    # data-parallel (activations)
    "batch": "__dp__",  # placeholder resolved to the dp axes tuple
    "worker": "__dp__",
    "seq": None,
}


def resolve_spec(
    logical_axes: Tuple[Optional[str], ...],
    shape: Tuple[int, ...],
    mesh_shape: Mapping[str, int],
    rules: Optional[Mapping[str, Optional[str]]] = None,
    dp_axes: Tuple[str, ...] = ("data",),
) -> Spec:
    """One parameter's logical axes resolved to a spec on ``mesh_shape``.

    Divisibility guard: if ``shape[d]`` is not divisible by the mesh axis
    size (the product of the dp axes for ``"__dp__"``), or is smaller,
    that dim stays whole (None).

    >>> resolve_spec(("embed", "mlp"), (64, 128), {"data": 2, "model": 4})
    (None, 'model')
    >>> resolve_spec(("embed", "kv_heads"), (64, 2), {"data": 1, "model": 4})
    (None, None)
    """
    rules = dict(DEFAULT_RULES, **(rules or {}))
    out = []
    for dim, name in enumerate(logical_axes):
        mesh_ax = rules.get(name) if name is not None else None
        if mesh_ax is None:
            out.append(None)
            continue
        if mesh_ax == "__dp__":
            size = 1
            for ax in dp_axes:
                size *= mesh_shape[ax]
            if shape[dim] % size == 0 and shape[dim] >= size:
                out.append(tuple(dp_axes) if len(dp_axes) > 1 else dp_axes[0])
            else:
                out.append(None)
            continue
        size = mesh_shape[mesh_ax]
        out.append(mesh_ax if shape[dim] % size == 0 and shape[dim] >= size
                   else None)
    return tuple(out)


def tree_specs(
    params: object,
    axes: object,
    mesh_shape: Mapping[str, int],
    rules: Optional[Mapping[str, Optional[str]]] = None,
    dp_axes: Tuple[str, ...] = ("data",),
):
    """Map a (params, logical-axes) tree pair to a spec tree; a params
    leaf is anything with a ``shape`` (a tensor, on the ``meta`` device
    too)."""
    return tree_map(
        lambda p, ax: resolve_spec(tuple(ax), tuple(p.shape), mesh_shape,
                                   rules, dp_axes),
        params, axes,
    )


def prefix_axes(axes: object, name: str = "layers"):
    """Every logical-axes tuple of ``axes`` with ``name`` in front: the
    axes of leaves stacked on a leading axis.

    >>> prefix_axes({"w": ("embed", "mlp")})
    {'w': ('layers', 'embed', 'mlp')}
    """
    return tree_map(lambda ax: (name,) + tuple(ax), axes)


def model_dim(spec: Spec) -> Optional[int]:
    """The dim that ``spec`` splits over the model axis, None for a leaf
    whole on every rank of a model group; a leaf split over the model
    axis on two dims, or with another axis, raises.

    >>> model_dim((None, "model")), model_dim((None, None))
    (1, None)
    """
    named = [(d, ax) for d, ax in enumerate(spec) if ax is not None]
    dims = [d for d, ax in named if ax == MODEL_AXIS]
    if not dims:
        return None
    if len(named) > 1:
        raise ValueError(f"spec {spec}: a rank's block is split along one "
                         "dim, over the model axis alone")
    return dims[0]


def shard_params(params, specs, shard: int, M: int):
    """Model shard ``shard``'s block of every leaf of ``params`` (whole
    leaves) that ``specs`` splits over a model axis of ``M``: the
    contiguous slice ``shard`` of ``M`` along the split dim, in its own
    storage (so the whole tree can be let go); a whole leaf stays as it
    is.

    >>> x = torch.arange(8.).reshape(2, 4)
    >>> shard_params({"w": x}, {"w": (None, "model")}, 1, 2)["w"].tolist()
    [[2.0, 3.0], [6.0, 7.0]]
    """

    def one(x, spec):
        d = model_dim(spec)
        if d is None or M == 1:
            return x
        n = x.shape[d] // M
        return x.narrow(d, shard * n, n).clone(
            memory_format=torch.contiguous_format)

    return tree_map(one, params, specs)


def unshard_params(params, specs, group, M: int):
    """:func:`shard_params` undone across the ranks of a model ``group``
    of ``M``: each split leaf's blocks gathered in shard order and
    concatenated along its split dim, on every rank, in bits; a whole
    leaf stays as it is."""
    from repro_torch.comm.collectives import _gather

    def one(x, spec):
        d = model_dim(spec)
        if d is None or M == 1:
            return x
        parts = _gather(x[None], (group,))
        return torch.cat(parts.unbind(0), dim=d)

    return tree_map(one, params, specs)


def serve_rules(cfg, M: int) -> Dict[str, Optional[str]]:
    """The serve step's rules beside :data:`DEFAULT_RULES` on a model axis
    of ``M``: the kv heads split where ``M`` divides them (the cache's
    slots whole), else the cache's slots (``"kv_seq"``) split and the kv
    heads whole, in the parameters and the cache alike. The divisibility
    guard still applies: slots that ``M`` does not divide stay whole, and
    every rank then holds the whole cache.

    >>> from types import SimpleNamespace as C
    >>> serve_rules(C(n_heads=16, n_kv_heads=2), 4)
    {'kv_seq': 'model', 'kv_heads': None}
    >>> serve_rules(C(n_heads=16, n_kv_heads=2), 2)
    {'kv_seq': None}
    """
    if cfg.n_heads and cfg.n_kv_heads % M == 0:
        return {"kv_seq": None}
    return {"kv_seq": MODEL_AXIS, "kv_heads": None}


def serve_shard(axes, specs, cache_axes, cache_specs, group, index: int,
                M: int):
    """A serving rank's ``nn.tensor_parallel.ModelShard`` (shard
    ``index`` of ``M`` over the model ``group``; None counts on the meta
    device), None at ``M = 1``: the logical axes that the parameter specs
    (``specs`` beside ``axes``, under :func:`serve_rules`) split, plus
    ``"kv_seq"`` where the cache specs split the slots. The kv heads
    split with the query heads whole, or one of the SSD's ``"d_inner"``
    and ``"ssm_heads"`` split without the other, raises, as the trainer's
    ``core.distributed.model_shard`` does."""
    from repro_torch.nn.tensor_parallel import ModelShard, split_axes

    if M == 1:
        return None
    split = set(split_axes(axes, specs))
    for ax, spec in zip(tree_leaves(cache_axes), tree_leaves(cache_specs),
                        strict=True):
        if "kv_seq" in ax and spec[tuple(ax).index("kv_seq")] == MODEL_AXIS:
            split.add("kv_seq")
    if "kv_heads" in split and "heads" not in split:
        raise ValueError("the kv heads are split over the model axis but the "
                         "query heads are whole")
    if ("d_inner" in split) != ("ssm_heads" in split):
        raise ValueError("the SSD's 'd_inner' and 'ssm_heads' are not split "
                         "together over the model axis; the mixer splits "
                         "both or neither")
    return ModelShard(group, index, M, frozenset(split))
