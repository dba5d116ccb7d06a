"""Sparsified data-parallel training (counterpart of
``repro.core.distributed``), on one card or one rank per worker.

The JAX trainer's W is the size of its data-parallel mesh: it vmaps the W
workers' gradients in one program and aggregates their payloads over the
mesh. The port runs it in two forms:

* on one card (``mesh=None``): that leading worker axis kept on the card,
  W logical workers, each with its own batch shard, gradient and
  ``CompactState``, aggregated by the collectives' one-card ``reference``
  forms. The counterpart of the JAX trainer under
  ``--xla_force_host_platform_device_count=W``;
* across ranks (``mesh``, a ``repro_torch.launch.mesh.DpGroups``): one
  worker per rank over ``torch.distributed``, the counterpart of the JAX
  trainer's ``shard_map`` over its dp mesh axes. Each rank holds its
  worker's batch shard (rows ``r·B/W … (r+1)·B/W``), gradient and
  ``CompactState`` (a worker axis of 1), and the collectives' ``shard``
  forms reduce over the dp process groups. ``sparse_allgather`` gives
  every rank the one-card aggregate in f32 bits; the ``all_reduce`` sums
  (``dense_allreduce``, ``hierarchical``'s inner stage, kind "none"'s
  mean) follow the backend's order.

One round per leaf (``_spa_leaf``): accumulate and select
(``compact_select``, fused through the CUDA kernel on fused leaves),
encode with the codec (its fused epilogue on fused leaves), aggregate
with weight omega = 1/W, and feed the decoded contribution back into the
error, so a lossy codec's residual stays there. Under ``dense_allreduce``
the payloads are summed as dense vectors instead and ``compact_finalize``
feeds back what was selected. Under ``weighting="coordinate"`` each
coordinate is divided by the mass of the workers that sent it, and that
mass is recorded in the state for RegTop-k's next posterior. Adam then
runs once on the common aggregate.

On a ``(data, model)`` mesh (``build_plan(..., axes=, mesh=)``, the
specs from ``nn.sharding`` under ``DistConfig.rules`` and ``dp_axes``)
the round runs per (worker, model shard), as the JAX runtime's
``shard_map`` runs it: each shard's block of the leaf is flattened on its
own and gets its own ``k = sparsity_to_k(local_len, S)``, the state holds
a row per (worker, shard), and ``sent_idx`` holds block-local indices. A
leaf the divisibility guard leaves whole runs M equal rounds on the whole
leaf. On one card the forward, the parameters and Adam stay whole on
every worker. Across ranks every family shards them
(``models.tensor_parallel``: the dense, MoE and VLM decoders, the SSM
and hybrid models, the encoder-decoder model): each rank holds, computes
and updates its own block of every leaf the spec splits (tensor
parallelism, :func:`make_train_step`; the MoE experts in either layout
of ``moe_parallelism``; the SSD mixer on its channels and heads).

A partial-participation schedule (``DistConfig.participation``) draws
one mask a round, shared by every leaf: participants aggregate with the
renormalized weight ``1/|P_t|``, and a dropped worker keeps its whole
accumulated gradient in ``eps`` with its ``sent_*`` frozen. The adaptive-k
controller (``DistConfig.adaptive_k``) sizes every leaf's payload at its
``k_max`` and sends the controller's per-leaf k; the train step then
carries the pair ``(compact state tree, controller state tree)``.

Each worker's gradient is cast to ``DistConfig.state_dtype`` (the dtype
of ``eps`` and the ``sent_*`` slots; bf16 scores unfused, so it keeps the
fastpath off) and, under ``DistConfig.microbatches``, accumulated over
that many chunks of the worker's shard. ``aggregation`` is the JAX
package's older name of ``collective``.

The wire is chosen per leaf: ``DistConfig.codec="auto"`` /
``collective="auto"`` make ``build_plan`` pick each leaf's (codec,
collective) with the alpha–beta planner (``repro_torch.comm.autotune``),
and each leaf then runs its own codec and collective, on one card and
across ranks (every rank plans the same plan, so every rank issues the
leaves' collectives in one order). ``DistConfig.overlap="buckets:B"``
runs the leaves in the bucket order of ``repro_torch.comm.overlap``, each
bucket inside a ``torch.profiler.record_function("spa_bucketNNN")``
range, and the metrics gain the predicted ``timeline`` stamps: the
numbers are those of ``"off"``, bit for bit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as torch_dist

from repro_torch.comm import autotune, cost
from repro_torch.comm import fastpath as fp
from repro_torch.comm import overlap as overlap_lib
from repro_torch.comm.controller import AdaptiveKController
from repro_torch.comm.participation import Participation, worker_index
from repro_torch.comm.codec import MAX_WIRE_LEN, get_codec
from repro_torch.comm.collectives import (
    _coord_divide,
    _gather,
    _psum,
    check_weighting,
    get_collective,
)
from repro_torch.core import compact as C
from repro_torch.core.selectors import sparsity_to_k
from repro_torch.core.sparsify import SparsifierConfig
from repro_torch.kernels.regtopk_score import const_div, ordered_mean
from repro_torch.launch.mesh import DP_AXES, DpGroups, dp_axes_of
from repro_torch.models import get_family, param_axes, tensor_parallel
from repro_torch.models.config import ModelConfig
from repro_torch.nn.layers import set_fp32_matmul
from repro_torch.nn.sharding import tree_specs
from repro_torch.nn.tensor_parallel import ModelShard, split_axes
from repro_torch.optim import OptConfig, make_optimizer
from repro_torch.tree import (
    tree_leaves,
    tree_map,
    tree_unflatten,
)


STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class DistConfig:
    sparsifier: SparsifierConfig = SparsifierConfig(
        kind="regtopk", sparsity=0.001
    )
    optimizer: OptConfig = OptConfig(kind="adam", learning_rate=1e-4)
    # the JAX package's older name for the collective: used where
    # ``collective`` is None (resolved_collective)
    aggregation: str = "sparse_allgather"
    # a wire codec, or "auto": build_plan picks each leaf's
    codec: str = "coo_fp32"
    # a collective, or "auto": build_plan picks each leaf's; None is
    # ``aggregation``
    collective: Optional[str] = None
    # microbatches each worker's shard splits into, their gradients
    # accumulated in ``state_dtype`` (the CLI's --microbatches)
    microbatches: int = 1
    # the mesh axes the workers span, outermost first: ("data",) or
    # ("pod", "data"); every other mesh axis is a model axis
    dp_axes: Tuple[str, ...] = ("data",)
    # the dtype of the error ``eps`` and the ``sent_*`` slots, "float32" or
    # "bfloat16"; each worker's gradient is cast to it before the round
    state_dtype: str = "float32"
    # "on" routes every fusable leaf through the fused select→encode
    # kernel (same payload: its certificate falls back to dense selection
    # per worker); "auto" fuses the leaves a ThroughputTable prices faster,
    # on the card only; "off" is dense selection.
    fastpath: str = "off"
    # "worker" is the Eq. (8) reduction; "coordinate" divides each
    # coordinate by the mass of the workers that sent it and records that
    # mass (CompactState.sent_w) for RegTop-k's next posterior
    weighting: str = "worker"
    # the scalar link model that prices the wire and drives "auto"
    # planning (the CLI's --calibrate on one dp axis); None is
    # cost.AlphaBeta()'s defaults
    link_model: Optional[cost.AlphaBeta] = None
    # one cost.AlphaBeta per dp mesh axis, outermost first (the CLI's
    # --link-topo, or --calibrate on two dp axes); wins over link_model
    link_topo: Optional[cost.LinkTopo] = None
    # partial-participation schedule over the dp workers (the CLI's
    # --participation); None or a full schedule is the all-workers round,
    # bit for bit. 'stale' needs the simulator's pending buffer.
    participation: Optional[Participation] = None
    # error-budget-driven per-round k (the CLI's --adaptive-k); None is
    # the static k, bit for bit. Every leaf's payload capacity is then its
    # k_max, and the train step carries a ControllerState tree
    adaptive_k: Optional[AdaptiveKController] = None
    # the bucketed overlap schedule, "off" or "buckets:B" (the CLI's
    # --overlap): the leaves run bucket by bucket, with the numbers of
    # "off" bit for bit, and the metrics gain the predicted timeline
    overlap: str = "off"
    # logical axis -> mesh axis overrides of nn.sharding.DEFAULT_RULES,
    # e.g. {"experts": "model"}
    rules: Optional[Dict[str, Optional[str]]] = None

    def resolved_collective(self) -> str:
        """``collective``, else ``aggregation``."""
        return self.collective or self.aggregation

    def resolved_participation(self) -> Optional[Participation]:
        """The schedule when it drops anyone, else None."""
        part = self.participation
        return None if part is None or part.is_full else part

    def resolved_adaptive_k(self) -> Optional[AdaptiveKController]:
        """The controller, with the JAX package's gates: it drives the
        magnitude-scored fixed-k kinds under the exact selector."""
        if self.adaptive_k is None:
            return None
        if self.sparsifier.kind not in ("topk", "regtopk"):
            raise ValueError(
                "adaptive_k drives magnitude-scored fixed-k kinds "
                f"('topk'/'regtopk'); got {self.sparsifier.kind!r}"
            )
        if self.sparsifier.selector != "exact":
            raise ValueError(
                "adaptive_k requires selector='exact' (the capacity-"
                f"bounded stable top-k); got {self.sparsifier.selector!r}"
            )
        return self.adaptive_k

    def resolved_weighting(self) -> str:
        """The weighting, with the JAX package's gate: kind 'none' sends
        every coordinate, so coordinate weighting would degenerate."""
        check_weighting(self.weighting)
        if self.weighting == "coordinate" and self.sparsifier.kind == "none":
            raise ValueError(
                "weighting='coordinate' needs sparse payloads; kind='none' "
                "sends every coordinate, so the sender mass is uniformly 1 "
                "and coordinate weighting degenerates to the worker "
                "reduction — use weighting='worker'"
            )
        return self.weighting

    def resolved_fastpath(self) -> str:
        """The fastpath mode with the config gates applied: the fused
        kernel scores RegTop-k with a scalar omega, so coordinate
        weighting refuses "on" and resolves "auto" to "off"; it scores in
        f32, while a bf16 ``state_dtype`` scores in bf16 unfused, so that
        refuses "on" and resolves "auto" to "off" too. Whether the device
        can run the kernel is ``build_plan``'s to decide."""
        if self.fastpath not in fp.FASTPATH_MODES:
            raise ValueError(
                f"unknown fastpath {self.fastpath!r}; "
                f"available: {fp.FASTPATH_MODES}"
            )
        if self.fastpath == "off":
            return "off"
        if self.weighting == "coordinate" and self.sparsifier.kind == "regtopk":
            if self.fastpath == "on":
                raise ValueError(
                    "fastpath='on' cannot fuse regtopk under "
                    "weighting='coordinate': the fused score kernel bakes "
                    "a scalar omega, but coordinate weighting conditions "
                    "on the per-coordinate sender mass (sent_w) — use "
                    "fastpath='off'/'auto'"
                )
            return "off"
        if self.state_dtype != "float32":
            if self.fastpath == "on":
                raise ValueError(
                    "fastpath='on' requires state_dtype='float32': the "
                    "fused pipeline scores in f32 while the unfused path "
                    f"scores in {self.state_dtype} — selection would not "
                    "be bit-for-bit"
                )
            return "off"
        return self.fastpath

    def resolved_state_dtype(self) -> torch.dtype:
        """The torch dtype of ``state_dtype``."""
        try:
            return STATE_DTYPES[self.state_dtype]
        except KeyError:
            raise ValueError(
                f"unknown state_dtype {self.state_dtype!r}; available: "
                f"{sorted(STATE_DTYPES)}"
            ) from None

    def resolved_link_model(self) -> cost.LinkModel:
        """The per-axis topology when given, else the scalar model, else
        ``cost.AlphaBeta()``'s defaults."""
        if self.link_topo is not None:
            return self.link_topo
        return self.link_model or cost.AlphaBeta()

    def resolved_overlap(self) -> Optional[overlap_lib.OverlapConfig]:
        """The bucketed-overlap config, None when "off"; an unknown spec
        or a bucket count below 1 raises."""
        return overlap_lib.parse_overlap(self.overlap)

    @property
    def auto(self) -> bool:
        """Whether the plan picks each leaf's wire (``collective="auto"``
        plans; ``aggregation="auto"`` does not, as in the JAX
        ``build_plan``)."""
        return self.codec == "auto" or self.collective == "auto"



class LeafPlan(NamedTuple):
    global_shape: Tuple[int, ...]
    local_len: int
    k: int
    fused: bool = False
    # the leaf's own wire under "auto" planning; None is DistConfig's
    codec: Optional[str] = None
    collective: Optional[str] = None
    # one model shard's block and the leaf's spec (``nn.sharding``) on the
    # mesh it was planned on; None is the whole leaf, replicated
    local_shape: Optional[Tuple[int, ...]] = None
    spec: Optional[Tuple[object, ...]] = None
    # M, the model shards of each worker: one round a step for each, on a
    # block of the split dim, or M identical rounds on a leaf left whole
    shards: int = 1


def split_dim(p: LeafPlan) -> Optional[int]:
    """The dim of the leaf that its model shards split, None for a leaf
    left whole. A spec that names a dp axis, or names an axis on two
    dims, has no split here: the port splits a leaf's round (and, tensor
    parallel, its parameters) along one dim over one model axis."""
    if p.spec is None or p.shards == 1:
        return None
    named = [(d, ax) for d, ax in enumerate(p.spec) if ax is not None]
    if not named:
        return None
    if len(named) > 1 or isinstance(named[0][1], tuple) or (
            named[0][1] in DP_AXES):
        raise ValueError(
            f"a leaf of shape {p.global_shape} with spec {p.spec}: the port "
            "splits a leaf's rounds along one dim over the model axis only"
        )
    return named[0][0]


def shard_blocks(x: torch.Tensor, p: LeafPlan,
                 shard: Optional[int] = None) -> torch.Tensor:
    """``x [N, *global_shape]`` as the rows of its (row, model shard)
    blocks, each block flattened row-major on its own as the JAX package
    flattens a shard's local block: ``[N * M, local_len]``, row major
    with the shard fastest, or with ``shard`` that block alone, ``[N,
    local_len]``. A leaf left whole gives its M identical copies."""
    N, M, L = x.shape[0], p.shards, p.local_len
    if M == 1:
        return x.reshape(N, L)
    d = split_dim(p)
    if d is None:
        flat = x.reshape(N, 1, L)
        return flat[:, 0] if shard is not None else (
            flat.expand(N, M, L).reshape(N * M, L))
    shape = p.global_shape
    b = x.reshape(N, *shape[:d], M, shape[d] // M, *shape[d + 1:])
    if shard is not None:
        return b.select(d + 1, shard).reshape(N, L)
    return b.movedim(d + 1, 1).reshape(N * M, L)


def merge_blocks(rows: torch.Tensor, p: LeafPlan) -> torch.Tensor:
    """:func:`shard_blocks` undone: ``[N * M, local_len]`` rows → ``[N,
    *global_shape]``; a leaf left whole takes each row's first shard (the
    M are equal)."""
    M = p.shards
    N = rows.shape[0] // M
    if M == 1:
        return rows.reshape(N, *p.global_shape)
    d = split_dim(p)
    if d is None:
        return rows.reshape(N, M, p.local_len)[:, 0].reshape(
            N, *p.global_shape)
    shape = p.global_shape
    b = rows.reshape(N, M, *shape[:d], shape[d] // M, *shape[d + 1:])
    return b.movedim(1, d + 1).reshape(N, *shape)


def leaf_wire(p: LeafPlan, dist: DistConfig) -> Tuple[str, str]:
    """One leaf's (codec, collective): its plan's own, else the
    ``DistConfig``'s. ``"auto"`` must have been resolved by
    ``build_plan(..., dist=dist)``."""
    codec = p.codec or dist.codec
    coll = p.collective or dist.resolved_collective()
    if codec == "auto" or coll == "auto":
        raise ValueError(
            "codec/collective='auto' requires a plan built with "
            "build_plan(..., dist=dist) so per-leaf choices are resolved"
        )
    return codec, coll


def plan_fastpath(dist: DistConfig, device) -> str:
    """The fastpath mode a plan prices with on ``device``:
    ``dist.resolved_fastpath()``, "off" for a config the kernel cannot
    fuse, and "auto" only where the device runs the kernel
    (``fastpath.backend_supports``)."""
    mode = dist.resolved_fastpath()
    if mode != "off" and not fp.config_fusable(dist.sparsifier)[0]:
        return "off"
    if mode == "auto" and not fp.backend_supports(device):
        return "off"
    return mode


def _local_shape(shape, spec, mesh: Dict[str, int]) -> Tuple[int, ...]:
    """A shard's block: each dim divided by the mesh axes its spec names
    (``repro.core.distributed._local_shape``)."""
    out = []
    for dim, size in enumerate(shape):
        ax = spec[dim] if dim < len(spec) else None
        axes = () if ax is None else ax if isinstance(ax, tuple) else (ax,)
        out.append(size // math.prod(mesh[a] for a in axes))
    return tuple(out)


def _check_wire_len(shape, local, codec: str, collective: str,
                    dist: DistConfig) -> None:
    """Refuse a leaf whose block (``local``, the whole leaf without a
    mesh) has ``MAX_WIRE_LEN`` elements or more on a codec that sends
    int32 indices: index ``2**31 + 5`` would come back as ``-2147483643``.
    A dense wire (kind "none", ``dense_allreduce``) sends no index."""
    n = math.prod(local)
    if (n < MAX_WIRE_LEN or not get_codec(codec).int32_indices
            or dist.sparsifier.kind == "none"
            or collective == "dense_allreduce"):
        return
    raise ValueError(
        f"a leaf of shape {shape} has a block of {n} elements "
        f"{tuple(local)}, at or beyond MAX_WIRE_LEN = 2**31, and codec "
        f"{codec!r} sends its indices as int32 (the JAX package's int32 "
        "wire would wrap them): split the leaf with a model axis "
        "(build_plan(..., axes=, mesh=) with a larger model size) or send "
        "it with codec 'bitmap_dense'"
    )


def build_plan(params, sparsity: float, dist: Optional[DistConfig] = None,
               table: Optional[fp.ThroughputTable] = None, workers=None,
               axes=None, mesh: Optional[Dict[str, int]] = None):
    """Per-leaf static plan: length, ``k = sparsity_to_k(length, S)`` (the
    controller's ``k_max`` bound under ``dist.adaptive_k``: the payload
    capacity) and whether the leaf is fused (``fastpath.leaf_fused`` under
    ``dist.resolved_fastpath()``). ``"auto"`` prices each leaf with
    ``table`` (its defaults when None), and fuses only where the leaf's
    device can run the kernel (``fastpath.backend_supports``).

    ``mesh`` (an ``{axis: size}`` layout, ``launch.mesh``) with ``axes``
    (the family's ``param_axes(cfg)``) plans each leaf on one model
    shard's block, as the JAX ``build_plan`` does: its spec
    (``nn.sharding.tree_specs`` under ``dist.rules`` and
    ``dist.dp_axes``), its local shape, and the length, k and fusability
    of that block; ``shards`` is the product of the mesh's non-dp axes.
    Without a mesh every leaf is whole, one shard.

    Under ``codec``/``collective="auto"`` each leaf also gets the (codec,
    collective, fused) that ``autotune.choose_leaf`` picks on the dp
    layout ``workers`` (W, or the dp sizes outermost first; by default
    the mesh's dp axes), priced under ``dist.resolved_link_model()`` at
    the payload capacity and the schedule's expected participants.

    A block of ``MAX_WIRE_LEN`` (2**31) elements or more on a codec with
    int32 indices raises before anything is allocated (under "auto",
    once the leaf's codec is picked)."""
    ctrl = None if dist is None else dist.resolved_adaptive_k()
    if dist is not None:
        dist.resolved_weighting()
    auto = dist is not None and dist.auto
    dp_axes = ("data",) if dist is None else tuple(dist.dp_axes)
    specs, shards = tree_map(lambda _: None, params), 1
    if mesh is not None:
        if axes is None:
            raise ValueError(
                "a mesh plans each leaf on its shard's block: pass "
                "build_plan(..., axes=<the family's param_axes(cfg)>)"
            )
        specs = tree_specs(params, axes, mesh,
                           None if dist is None else dist.rules, dp_axes)
        shards = math.prod(v for a, v in mesh.items() if a not in dp_axes)
        if workers is None:
            workers = tuple(mesh[a] for a in dp_axes)
    if auto:
        if workers is None:
            raise ValueError(
                "codec/collective='auto' plans against the dp layout: pass "
                "build_plan(..., workers=W or the dp sizes)"
            )
        dp = _dp_sizes(workers)
        restrict = autotune.auto_candidates(dist.sparsifier.kind, dist.codec,
                                            dist.resolved_collective())
        participants = _participants(dist, dp)
        model = dist.resolved_link_model()
        word_bytes = dist.resolved_state_dtype().itemsize

    def mk(leaf, spec):
        shape = tuple(leaf.shape)
        if spec is None:
            spec = (None,) * len(shape)
        local = _local_shape(shape, spec, mesh) if mesh is not None else shape
        n = math.prod(local)
        k = sparsity_to_k(n, sparsity) if ctrl is None else ctrl.bounds(n)[1]
        lay = dict(local_shape=local, spec=spec, shards=shards)
        if dist is None:
            return LeafPlan(shape, n, k, **lay)
        mode = plan_fastpath(dist, leaf.device)
        if auto:
            d = autotune.choose_leaf(
                n, k, dp, model, participants=participants, fastpath=mode,
                compute=table, word_bytes=word_bytes, **restrict,
            )
            _check_wire_len(shape, local, d.codec, d.collective, dist)
            return LeafPlan(shape, n, k, d.fused, d.codec, d.collective,
                            **lay)
        _check_wire_len(shape, local, dist.codec, dist.resolved_collective(),
                        dist)
        fused = fp.leaf_fused(mode, dist.codec, dist.resolved_collective(), n,
                              k, table)
        return LeafPlan(shape, n, k, fused, **lay)

    return tree_map(mk, params, specs)


def apply_plan_decisions(plan, comm_plan):
    """Graft a ``CommPlan``'s (or its ``decisions`` tree's) per-leaf
    (codec, collective, fused) onto a ``LeafPlan`` tree: how ``replan``'s
    picks reach the round. Capacities stay, so the sparsifier and
    controller states carry over."""
    decisions = getattr(comm_plan, "decisions", comm_plan)
    return tree_map(
        lambda p, d: p._replace(codec=d.codec, collective=d.collective,
                                fused=d.fused),
        plan, decisions,
    )


def init_sparsifier_state(plan, workers: int, device="cuda",
                          dtype: torch.dtype = torch.float32,
                          shards: Optional[int] = None):
    """One ``CompactState`` per leaf of ``plan`` with a row for each
    (worker, model shard), worker major: ``workers`` x the leaf's
    ``shards`` rows of its block's length (``shards`` given: that many a
    worker, 1 on a rank, which holds its own), the error and ``sent_*``
    slots in ``dtype`` (``DistConfig.state_dtype``)."""
    return tree_map(
        lambda p: C.compact_init(
            workers * (p.shards if shards is None else shards), p.local_len,
            p.k, device, dtype),
        plan,
    )


def init_controller_state(plan, dist: DistConfig, device="cuda"):
    """One ``ControllerState`` per leaf of ``plan`` (built with ``dist``,
    so every capacity sits at ``k_max``): the static-sparsity k clipped
    into the leaf's bounds. It is common to the workers, on one card and
    on every rank."""
    ctrl = dist.resolved_adaptive_k()
    if ctrl is None:
        raise ValueError("init_controller_state needs dist.adaptive_k")
    return tree_map(
        lambda p: ctrl.init(
            sparsity_to_k(p.local_len, dist.sparsifier.sparsity),
            *ctrl.bounds(p.local_len), device=device,
        ),
        plan,
    )


def _shard_sum(x: torch.Tensor, model_group) -> torch.Tensor:
    """``x [n, S]`` summed over its S model shards in shard order on one
    card, ``[n]``; across ranks (S = 1) summed over the model group, as
    the JAX package's ``psum`` over the model axes."""
    out = x[:, 0]
    for s in range(1, x.shape[1]):
        out = out + x[:, s]
    return out if model_group is None else _psum(out, (model_group,))


def _ctrl_update(ctrl_cfg, ctrl_leaf, new_st, agg, p: LeafPlan, groups,
                 n_workers: int, model_group=None):
    """Fold one leaf's round into its controller state: each worker's
    ``||eps||`` (its shards' sums of squares added first, a leaf left
    whole M times, as the JAX package's ``psum`` over the model axes
    counts it), their mean (in worker order on one card; summed over the
    ranks of ``groups`` across ranks; then times fl(1/W), as the jitted
    ``pmean``) against ``||g_agg||``, its shards' ``agg [S, L]`` (or one
    shard's ``[L]``) summed the same way."""
    ag = agg.reshape(-1, p.local_len).float()
    S = ag.shape[0]
    eps = new_st.eps.float()
    sq = _shard_sum((eps * eps).sum(-1).reshape(-1, S), model_group)
    norms = torch.sqrt(sq)
    mean = (ordered_mean(norms) if groups is None
            else const_div(_psum(norms[0], groups), float(n_workers)))
    g_sq = _shard_sum((ag * ag).sum(-1).reshape(1, S), model_group)[0]
    lo, hi = ctrl_cfg.bounds(p.local_len)
    return ctrl_cfg.observe(
        ctrl_leaf, mean, torch.sqrt(g_sq), k_min=lo, k_max=hi,
    )


def _weighted_sum(x: torch.Tensor, weight) -> torch.Tensor:
    """``sum_w x[w] * weight_w`` one worker at a time in worker order;
    ``weight`` a scalar or a ``[W]`` tensor."""
    out = torch.zeros_like(x[0])
    for w in range(x.shape[0]):
        out = out + x[w] * (weight[w] if isinstance(weight, torch.Tensor)
                            else weight)
    return out


def _spa_leaf(g, st, p: LeafPlan, scfg, codec, collective, coord, counts,
              groups=None, part_ctx=None, k_dyn=None, shards: int = 1):
    """One leaf's round for the rows of ``g [R, local_len]``: one row for
    each (worker, model shard) of this card, worker major with the
    ``shards`` shards fastest (``shard_blocks``; R = W x shards), each
    aggregated over the W rows of its shard. Returns (the aggregate of
    each shard ``[shards, local_len]``, new state). ``groups`` (the dp
    process groups of this rank's model index, outermost first) makes it
    this rank's round, one row (``shards`` 1), reduced across the ranks.

    ``part_ctx`` ``(m, w_part)`` makes the round partial: ``m`` the mask
    entry of each row's worker (``[R]``; across ranks this rank's own)
    and ``w_part`` the renormalized participant weight ``1/|P_t|``.
    Participants aggregate with ``w_part``; a dropped worker keeps ``a``
    in ``eps`` and its ``sent_*`` frozen. ``k_dyn`` (a tensor) is the
    controller's k under the capacity ``p.k``."""
    S, L = shards, p.local_len

    def rows(x, s):
        """The W rows of shard ``s`` (a scalar weight is everyone's)."""
        if S == 1 or not isinstance(x, torch.Tensor):
            return x
        return x[s::S]

    m, w_part = part_ctx if part_ctx is not None else (None, None)
    if scfg.kind == "none":
        means = []
        for s in range(S):
            gl = rows(g, s)
            if m is not None:  # no error state: a dropped gradient is lost
                wm = rows(m, s) * w_part
                mean = (_weighted_sum(gl.float(), wm) if groups is None
                        else _psum(gl[0].float() * wm[0], groups))
            elif groups is None:  # pmean: in worker order, times fl(1/W)
                mean = ordered_mean(gl.float())
            else:  # pmean: the sum over the ranks, times fl(1/their number)
                n = math.prod(torch_dist.get_world_size(gr) for gr in groups)
                mean = const_div(_psum(gl[0].float(), groups), float(n))
            means.append(mean.to(g.dtype))
        return _stack(means), st._replace(t=st.t + 1)
    a, vals, idx = C.compact_select(
        scfg, st, g, p.k, k_dyn=k_dyn, fastpath="on" if p.fused else None,
        counts=counts,
    )
    # the aggregation weight: omega, or the participant weight times each
    # worker's mask entry on a partial round
    weight = scfg.omega if m is None else w_part * m
    aggs, dens = [], []  # per shard; the sender mass under coordinate weighting
    if collective.name == "dense_allreduce":
        # the dense vector on the wire: each worker's payload scattered
        # (added, so padding slots are no-ops) into its ghat, the weighted
        # sums taken one worker at a time in worker order
        ghat = torch.zeros_like(a).scatter_add_(1, idx, vals)
        for s in range(S):
            agg = _weighted_sum(rows(ghat, s), rows(weight, s))
            den = (_weighted_sum((rows(ghat, s) != 0).to(ghat.dtype),
                                 rows(weight, s)) if coord else None)
            if groups is not None:
                agg = _psum(agg, groups)
                den = _psum(den, groups) if coord else None
            aggs.append(_coord_divide(agg, den) if coord else agg)
            dens.append(den)
        agg, den = _stack(aggs), _stack(dens) if coord else None
        new = C.compact_finalize(st, a, vals, idx, agg, den=den)
    else:
        payload = (
            codec.encode_fused(vals, idx, L)
            if p.fused
            else codec.encode(vals, idx, L)
        )
        dvals, didx = codec.decode(payload, L)
        sent_dense = torch.zeros_like(a).scatter_add_(1, didx, dvals.to(a.dtype))
        for s in range(S):
            if groups is None:
                reduce = (collective.reference_coord if coord
                          else collective.reference)
                out = reduce(codec, {key: rows(x, s) for key, x in payload.items()},
                             rows(weight, s), L)
            else:
                reduce = collective.shard_coord if coord else collective.shard
                out = reduce(codec, payload, L, groups,
                             scfg.omega if m is None else w_part,
                             participation=None if m is None else m[0])
            agg, den = out if coord else (out, None)
            aggs.append(agg.to(a.dtype))
            dens.append(None if den is None else den.to(a.dtype))
        agg, den = _stack(aggs), _stack(dens) if coord else None
        new = C.compact_finalize_sent(st, a, dvals, didx, sent_dense, agg,
                                      den=den)
    if m is not None:
        dropped = st._replace(eps=a, t=st.t + 1)
        live = m > 0
        new = C.CompactState(*(
            torch.where(live.reshape((-1,) + (1,) * (x.dim() - 1)), x, y)
            for x, y in zip(new, dropped, strict=True)
        ))
    return agg.to(g.dtype), new


def _stack(xs: List[torch.Tensor]) -> torch.Tensor:
    """``[S, ...]`` of the S shards' tensors (a view of one)."""
    return xs[0][None] if len(xs) == 1 else torch.stack(xs)


def _merge_agg(agg: torch.Tensor, p: LeafPlan,
               mesh: Optional[DpGroups]) -> torch.Tensor:
    """The whole aggregate ``[*global_shape]`` from the shards' ``agg
    [S, local_len]``: on one card all M are here; across ranks this rank's
    block is gathered over its model group first. A leaf left whole
    takes its own (its M rounds are equal)."""
    if split_dim(p) is None:
        return agg[0].reshape(p.global_shape)
    if mesh is not None:
        agg = _gather(agg, (mesh.model_group,))
    return merge_blocks(agg, p)[0]


def _dp_groups(mesh: Optional[DpGroups], n_workers: int):
    """The dp process groups of ``mesh`` (None on one card), with W = the
    number of ranks in its dp layout."""
    if mesh is None:
        return None
    if n_workers != mesh.size:
        raise ValueError(
            f"{n_workers} workers, but the dp layout {mesh.shape} holds "
            f"{mesh.size} ranks: across ranks W is the number of ranks"
        )
    return mesh.groups_of(dp_axes_of(mesh))


def make_sparsify_aggregate(plan, dist: DistConfig, n_workers: int,
                            counts: Optional[fp.FastpathCounts] = None,
                            mesh: Optional[DpGroups] = None):
    """``spa(grads, state) -> (agg, new_state)`` over the parameter tree;
    ``grads`` leaves are ``[W, *shape]`` on one card, and this rank's
    ``[1, *shape]`` across the ranks of ``mesh`` (W = its size). Under
    ``dist.adaptive_k`` it is ``spa(grads, state, ctrl) -> (agg,
    new_state, new_ctrl)``.

    A tensor-parallel rank's gradient of a split leaf is already its
    block, ``[1, *local_shape]``: that is the round's row as it is, and
    the aggregate stays the rank's block, gathered nowhere.

    A leaf of ``shards`` M > 1 (a plan built on a mesh with a model axis)
    runs one round per (worker, model shard), as the JAX runtime's
    ``shard_map`` does: each worker's gradient is split along the spec's
    split dim into M blocks, each flattened on its own
    (:func:`shard_blocks`), with the block's own k; each shard aggregates
    over the workers, and the M aggregates are put back together in the
    leaf's shape (a leaf left whole runs M equal rounds). On one card the
    W x M rows of a leaf select in one call, so a fused leaf is one kernel
    launch a step; across ranks a rank runs its own (worker, shard), its
    shard's aggregate gathered over its model group."""
    groups = _dp_groups(mesh, n_workers)
    model_group = None if mesh is None else mesh.model_group
    part = dist.resolved_participation()
    if part is not None:
        part.validate(n_workers)
        if part.delays_payloads:
            raise ValueError(
                "participation kind 'stale' (bounded-staleness delivery) "
                "needs the server-side pending buffer and is simulator-only "
                "for now — use DistributedSim(participation=...), or a "
                "dropping schedule ('bernoulli'/'round_robin') here"
            )
    # RegTop-k's posterior subtracts this worker's contribution with the
    # weight the server used: the schedule's effective weight on a
    # partial round
    omega = 1.0 / n_workers if part is None else part.effective_omega(n_workers)
    scfg = dataclasses.replace(dist.sparsifier, omega=omega)
    coord = dist.resolved_weighting() == "coordinate"
    ctrl_cfg = dist.resolved_adaptive_k()
    plan_flat = tree_leaves(plan)
    # each leaf's own wire, resolved and checked up front
    wires = [leaf_wire(p, dist) for p in plan_flat]
    codecs = [get_codec(c) for c, _ in wires]
    colls = [get_collective(s) for _, s in wires]
    for p, (cname, sname) in zip(plan_flat, wires, strict=True):
        if p.fused:
            ok, why = fp.fusable(dist.sparsifier, cname, sname, p.local_len,
                                 p.k)
            if not ok:
                raise ValueError(
                    f"plan marks a {p.local_len}-element leaf fused but the "
                    f"({cname}, {sname}) pair is not fusable: {why}"
                )
        split_dim(p)  # a spec the split cannot follow raises here
        # a plan built without dist has not met the wire's index limit
        _check_wire_len(p.global_shape, p.local_shape or p.global_shape,
                        cname, sname, dist)
        if mesh is not None and p.shards != mesh.model:
            raise ValueError(
                f"a leaf planned on {p.shards} model shards, but the layout "
                f"has a model axis of {mesh.model}"
            )
        if ctrl_cfg is not None and p.k != ctrl_cfg.bounds(p.local_len)[1]:
            raise ValueError(
                f"adaptive-k plan capacity mismatch: a {p.local_len}-"
                f"element leaf carries k={p.k} but the controller's k_max "
                f"bound is {ctrl_cfg.bounds(p.local_len)[1]} — build the "
                "plan with build_plan(..., dist=dist) so capacities sit at "
                "k_max"
            )

    def round_ctx(state):
        """One mask a round, shared by every leaf (their round counters
        advance in lockstep): this card's workers' entries, or this
        rank's, and the participant weight 1/|P_t|."""
        if part is None:
            return None
        t0 = tree_leaves(state)[0].t
        pmask = part.round_mask(int(t0[0]), n_workers, t0.device)
        m = pmask if groups is None else pmask[worker_index(mesh)][None]
        return m, torch.ones_like(pmask[0]) / torch.clamp(pmask.sum(), min=1.0)

    # the leaves' launch order: one group in plan order, or under overlap
    # the buckets in order, each in its own profiler range. Every rank
    # plans the same buckets, so every rank issues the same collectives in
    # the same order.
    bucket_order: List[Tuple[int, ...]] = [tuple(range(len(plan_flat)))]
    bucket_names: List[Optional[str]] = [None]
    ocfg = dist.resolved_overlap()
    if ocfg is not None and plan_flat:
        bplan = overlap_lib.bucketize(
            _leaf_overlap_costs(plan, dist, _layout(n_workers, mesh)), ocfg)
        bucket_order = [b.leaves for b in bplan.buckets]
        bucket_names = [f"spa_bucket{i:03d}" for i in range(len(bucket_order))]

    def spa(grads, state, ctrl=None):
        part_ctx = round_ctx(state)
        g_flat, s_flat = tree_leaves(grads), tree_leaves(state)
        c_flat = [None] * len(plan_flat) if ctrl is None else tree_leaves(ctrl)
        outs: List[Any] = [None] * len(plan_flat)
        for name, leaves in zip(bucket_names, bucket_order, strict=True):
            with (contextlib.nullcontext() if name is None
                  else torch.profiler.record_function(name)):
                for i in leaves:
                    p = plan_flat[i]
                    S = p.shards if mesh is None else 1
                    ctx = part_ctx
                    if ctx is not None and S > 1:  # each row its worker's
                        ctx = (ctx[0].repeat_interleave(S), ctx[1])
                    # a tensor-parallel rank's block of a split leaf
                    block = tuple(g_flat[i].shape[1:]) != p.global_shape
                    rows, new = _spa_leaf(
                        g_flat[i].reshape(1, p.local_len) if block
                        else shard_blocks(g_flat[i], p,
                                          None if mesh is None else mesh.shard),
                        s_flat[i], p, scfg, codecs[i], colls[i], coord,
                        counts, groups, ctx,
                        None if c_flat[i] is None else c_flat[i].k, S,
                    )
                    # the shards' rows are kept only for the controller
                    outs[i] = (rows[0].reshape(p.local_shape) if block
                               else _merge_agg(rows, p, mesh), new,
                               None if ctrl_cfg is None else rows)
        agg = tree_unflatten(plan, [o[0] for o in outs])
        new_state = tree_unflatten(plan, [o[1] for o in outs])
        if ctrl_cfg is None:
            return agg, new_state
        new_ctrl = tree_unflatten(plan, [
            _ctrl_update(ctrl_cfg, c, o[1], o[2], p, groups, n_workers,
                         model_group)
            for c, o, p in zip(c_flat, outs, plan_flat, strict=True)
        ])
        return agg, new_state, new_ctrl

    return spa


def _one_payload(codec, length: int, k: int):
    """One worker's encoded payload of a k-entry selection (a worker axis
    of 1): its buffers' shapes and dtypes depend on ``(length, k)`` alone,
    so their bytes are what every round moves (the counterpart of the JAX
    package's ``jax.eval_shape``)."""
    return codec.encode(
        torch.zeros(1, k), torch.zeros(1, k, dtype=torch.int64), length
    )


def _payload_bytes(codec, length: int, k: int) -> int:
    """Bytes of one worker's encoded payload."""
    return cost.payload_nbytes(_one_payload(codec, length, k))


def _leaf_wire_patterns(plan, dist: DistConfig):
    """``(leaf, codec, effective collective, word bytes, dense wire)`` per
    leaf, each with its own wire (``leaf_wire``): kind "none" and
    ``dense_allreduce`` put the dense vector on the wire, in words of the
    state dtype under ``dense_allreduce`` and of f32 under kind "none"
    (its mean is taken in f32); payload collectives decode to f32, so
    their dense terms stay 4-byte words."""
    dense_word = (4 if dist.sparsifier.kind == "none"
                  else dist.resolved_state_dtype().itemsize)
    for p in tree_leaves(plan):
        cname, coll = leaf_wire(p, dist)
        dense = dist.sparsifier.kind == "none" or coll == "dense_allreduce"
        yield (p, get_codec(cname), "dense_allreduce" if dense else coll,
               dense_word if dense else cost.WORD_BYTES, dense)


def _dp_sizes(workers) -> Tuple[int, ...]:
    """The dp axis sizes, outermost first: an int is one axis of W."""
    return (workers,) if isinstance(workers, int) else tuple(workers)


def _layout(n_workers: int, mesh: Optional[DpGroups]):
    """The dp sizes the accounting prices: W on one card, the dp layout's
    shape across ranks."""
    return n_workers if mesh is None else mesh.shape


def _participants(dist: DistConfig, dp: Tuple[int, ...]) -> Optional[float]:
    """Expected on-time workers per round under ``dist.participation``,
    which partial rounds are priced with; None when every round is
    full."""
    part = dist.resolved_participation()
    if part is None:
        return None
    W = math.prod(dp)
    return part.validate(W).expected_participants(W)


def comm_round_bytes(plan, dist: DistConfig, workers) -> Tuple[int, int]:
    """(predicted, measured) bytes on the wire per worker per round, summed
    over leaves, from ``repro_torch.comm.cost``: predicted from the
    codec's bit accounting, measured from the buffers one
    ``codec.encode`` returns. ``workers`` is the dp sizes, outermost
    first (``DpGroups.shape``), or W for one dp axis. Under a partial
    schedule the predicted side prices the expected partial round, while
    the measured side stays the full round: every worker's buffer still
    crosses the wire, a dropped one with weight 0."""
    dp = _dp_sizes(workers)
    participants = _participants(dist, dp)
    pred = meas = 0
    for p, codec, coll, wb, dense in _leaf_wire_patterns(plan, dist):
        pred += cost.predicted_bytes(codec, coll, p.local_len, p.k, dp,
                                     word_bytes=wb, participants=participants)
        payload = {} if dense else _one_payload(codec, p.local_len, p.k)
        meas += cost.measured_bytes(coll, p.local_len, payload, dp,
                                    word_bytes=wb)
    return pred, meas


def comm_round_cost(plan, dist: DistConfig, workers) -> cost.CostEstimate:
    """Predicted per-worker alpha–beta cost of one round, summed over
    leaves under ``dist.resolved_link_model()``; ``workers`` as in
    ``comm_round_bytes``. A partial schedule prices the expected partial
    round."""
    model = dist.resolved_link_model()
    dp = _dp_sizes(workers)
    participants = _participants(dist, dp)
    total_bytes = total_msgs = 0
    total_seconds = 0.0
    for p, codec, coll, wb, _ in _leaf_wire_patterns(plan, dist):
        est = cost.predict(codec, coll, p.local_len, p.k, dp, model,
                           word_bytes=wb, participants=participants)
        total_bytes += est.bytes_on_wire
        total_msgs += est.n_messages
        total_seconds += est.seconds
    return cost.CostEstimate(
        bytes_on_wire=total_bytes, n_messages=total_msgs, seconds=total_seconds
    )


def _leaf_overlap_costs(plan, dist: DistConfig, workers):
    """Per-leaf ``overlap.LeafCost`` rows in plan order under
    ``dist.resolved_link_model()``, each leaf on its own wire: the
    ``bucketize`` input, priced as ``comm_round_cost`` prices the round."""
    model = dist.resolved_link_model()
    dp = _dp_sizes(workers)
    participants = _participants(dist, dp)
    return [
        overlap_lib.leaf_cost(codec, coll, p.local_len, p.k, dp, model,
                              word_bytes=wb, participants=participants)
        for p, codec, coll, wb, _ in _leaf_wire_patterns(plan, dist)
    ]


def comm_round_timeline(plan, dist: DistConfig, workers,
                        compute_seconds=None):
    """``(BucketPlan, Timeline)`` of one round under
    ``dist.resolved_overlap()`` (raises when overlap is "off");
    ``workers`` as in ``comm_round_bytes``. ``compute_seconds`` threads
    per-bucket backward times into the launch stamps."""
    ocfg = dist.resolved_overlap()
    if ocfg is None:
        raise ValueError(
            "comm_round_timeline needs DistConfig.overlap != 'off' "
            "(e.g. overlap='buckets:4')"
        )
    bplan = overlap_lib.bucketize(_leaf_overlap_costs(plan, dist, workers),
                                  ocfg)
    return bplan, overlap_lib.overlap_timeline(bplan, compute_seconds)


def model_shard(cfg: ModelConfig, plan, group, index: int
                ) -> Optional[ModelShard]:
    """Shard ``index``'s ``ModelShard`` over the model ``group`` (None on
    the meta device: counted, not moved) when the trainer shards ``cfg``'s
    forward: a plan of M > 1 model shards for a family of
    ``models.tensor_parallel`` (every family). None otherwise: the forward
    stays whole; across ranks that is reached only through a family
    module whose ``TENSOR_PARALLEL`` was emptied, as the dry run's tests
    do to count the whole forward.
    Its split axes are those of the plan's specs; the kv heads split with
    the query heads whole, or one of the SSD's channels (``"d_inner"``) and
    heads (``"ssm_heads"``) split without the other, raises."""
    M = tree_leaves(plan)[0].shards
    if M == 1 or not tensor_parallel(cfg):
        return None
    split = split_axes(param_axes(cfg), tree_map(lambda p: p.spec, plan))
    if "kv_heads" in split and "heads" not in split:
        raise ValueError("the kv heads are split over the model axis but the "
                         "query heads are whole")
    if ("d_inner" in split) != ("ssm_heads" in split):
        one, other = (("d_inner", "ssm_heads") if "d_inner" in split
                      else ("ssm_heads", "d_inner"))
        raise ValueError(
            f"{cfg.name}: the SSD's {one!r} is split over the model axis of "
            f"{M} but its {other!r} is whole; the mixer splits both or "
            "neither")
    return ModelShard(group, index, M, split)


def make_worker_grads(cfg: ModelConfig, dist: DistConfig,
                      shard: Optional[ModelShard] = None):
    """``worker_grads(params, wbatch) -> (loss, gradient leaves)``: one
    worker's forward and backward on its shard, as the train step runs
    it (under ``dist.microbatches``, accumulated in the state dtype).
    Under a ``shard`` the params are the rank's blocks (tensor
    parallelism), and so are the gradients."""
    n_mb = dist.microbatches
    if n_mb < 1:
        raise ValueError(f"microbatches must be >= 1, got {n_mb}")
    acc_dt = dist.resolved_state_dtype()
    loss_fn = get_family(cfg).loss_fn
    kw = {} if shard is None else {"shard": shard}

    def value_and_grad(params, mbatch):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = loss_fn(live, cfg, mbatch, **kw)[0]
        return loss.detach(), torch.autograd.grad(loss, tree_leaves(live))

    def worker_grads(params, wbatch):
        """The worker's loss and gradient; under ``microbatches`` its
        shard's ``n_mb`` contiguous chunks in order, the loss accumulated
        in f32 and the gradient in the state dtype from zero, each term
        times fl(1/n_mb), as the jitted JAX scan adds ``x / n_mb``."""
        if n_mb == 1:
            return value_and_grad(params, wbatch)
        rows = wbatch["tokens"].shape[0]
        if rows % n_mb:
            raise ValueError(
                f"a worker's shard of {rows} rows does not split into "
                f"{n_mb} microbatches"
            )
        per_mb = rows // n_mb
        leaves = tree_leaves(params)
        loss_acc = torch.zeros((), device=leaves[0].device)
        g_acc = [torch.zeros(p.shape, dtype=acc_dt, device=p.device)
                 for p in leaves]
        for i in range(n_mb):
            mb = {key: v[i * per_mb:(i + 1) * per_mb] for key, v in wbatch.items()}
            loss, grads = value_and_grad(params, mb)
            loss_acc = loss_acc + const_div(loss, float(n_mb))
            g_acc = [ac + const_div(gg, float(n_mb)).to(acc_dt)
                     for ac, gg in zip(g_acc, grads, strict=True)]
        return loss_acc, g_acc

    return worker_grads


def make_train_step(cfg: ModelConfig, dist: DistConfig, plan, n_workers: int,
                    counts: Optional[fp.FastpathCounts] = None,
                    mesh: Optional[DpGroups] = None):
    """``train_step(params, opt_state, sp_state, batch) -> (params,
    opt_state, sp_state, metrics)``. The global batch splits into W equal
    worker shards in order, as the JAX trainer reshapes it to ``[W, B/W,
    ...]``. Across the ranks of ``mesh`` each rank takes worker
    ``mesh.rank``'s shard (every rank of its model group the same), and
    the W losses are gathered in worker order, so the logged mean is the
    one-card mean. Matrix products run in full float32 (no TF32).

    On a plan with a model axis (``shards`` M) the sparsify stage runs
    one round per (worker, shard) (:func:`make_sparsify_aggregate`). On
    one card ``n_workers`` is W = devices / M, and the forward, the
    backward, the parameters and Adam stay whole: Adam runs on the
    reassembled aggregate, which is the JAX package's sharded update
    element by element.

    Across the ranks of ``mesh`` with M > 1, for a family that shards its
    forward (``models.tensor_parallel``, every family: the dense, MoE and
    VLM decoders, the MoE experts in either of ``moe_parallelism``'s
    layouts; the SSM and hybrid models, the SSD mixer on its channels and
    heads; the encoder-decoder model, its encoder, self- and
    cross-attention and MLPs), the step is tensor parallel: ``params``
    and the optimizer state are this rank's blocks
    (``nn.sharding.shard_params`` under the plan's specs,
    a leaf the divisibility guard leaves whole whole on every rank), the
    forward and backward run on them with the model group's collectives
    (``nn.tensor_parallel``), each split leaf's gradient is its round's
    row as it is and its aggregate stays local, Adam updates the local
    blocks, and the clip's global norm sums the split leaves' squares over
    the model group. The row-parallel sums are taken by ``all_reduce`` as
    GSPMD takes them, so the result is the one-card run's to rounding, not
    in bits; a whole leaf is equal in bits on the ranks of a model group.
    For a family left out of ``models.tensor_parallel`` only the sparsify
    stage is split across ranks: every rank of a model group runs its
    worker's whole forward and backward and holds the whole parameters
    and Adam state, and each split leaf's aggregate is gathered over the
    model group. No family is left out; the path stays for a family
    module whose ``TENSOR_PARALLEL`` is emptied (the dry run's tests count
    the whole forward that way).

    Under ``dist.microbatches`` each worker's shard splits into that many
    contiguous chunks, their gradients accumulated in
    ``dist.state_dtype``, and every worker's gradient enters the round in
    that dtype.

    Under ``dist.adaptive_k`` the sparsifier state is the pair
    ``(compact state tree, controller state tree)``
    (:func:`init_controller_state`) and the metrics gain
    ``"adaptive_k"``, the mean per-leaf k the round used. Under
    ``dist.overlap`` they gain ``"timeline"``, the ``[n_buckets, 2]`` f32
    (launch, complete) stamps of ``comm_round_timeline``."""
    set_fp32_matmul()
    shard = None if mesh is None else model_shard(
        cfg, plan, mesh.model_group, mesh.shard)
    opt = make_optimizer(dist.optimizer, split=None if shard is None else (
        mesh.model_group, [split_dim(p) is not None for p in tree_leaves(plan)]))
    spa = make_sparsify_aggregate(plan, dist, n_workers, counts, mesh)
    adaptive = dist.resolved_adaptive_k() is not None
    W = n_workers
    wire_pred, wire_meas = comm_round_bytes(plan, dist, _layout(W, mesh))
    # the predicted (launch, complete) stamps of each bucket, beside the
    # spa_bucketNNN profiler ranges the round opens
    timeline = None
    if dist.resolved_overlap() is not None:
        _, tl = comm_round_timeline(plan, dist, _layout(W, mesh))
        timeline = torch.tensor(list(zip(tl.launch, tl.complete)),
                                dtype=torch.float32)
    mine = range(W) if mesh is None else [mesh.rank]

    acc_dt = dist.resolved_state_dtype()
    worker_grads = make_worker_grads(cfg, dist, shard)

    def train_step(params, opt_state, sp_state, batch: Dict[str, Any]):
        B = batch["tokens"].shape[0]
        if B % W:
            raise ValueError(f"global batch {B} is not divisible by {W} workers")
        per = B // W
        losses, per_worker = [], []
        for n in mine:
            shard = {key: v[n * per:(n + 1) * per] for key, v in batch.items()}
            loss, grads = worker_grads(params, shard)
            losses.append(loss)
            per_worker.append(list(grads))
        # each worker's gradient in the state dtype, as the round takes it;
        # the workers' copies of a leaf are let go once it is stacked, so
        # the card holds the W gradients once and one leaf twice
        stacked = []
        for i in range(len(per_worker[0])):
            stacked.append(torch.stack([gs[i] for gs in per_worker]).to(acc_dt))
            for gs in per_worker:
                gs[i] = None
        grads_w = tree_unflatten(params, stacked)
        if adaptive:
            cp_state, ctrl_state = sp_state
            agg, new_cp, new_ctrl = spa(grads_w, cp_state, ctrl_state)
            new_sp = (new_cp, new_ctrl)
        else:
            agg, new_sp = spa(grads_w, sp_state)
        new_params, new_opt = opt.update(agg, opt_state, params)
        losses = torch.stack(losses)
        if mesh is not None:  # each worker's loss, from its first shard
            losses = _gather(losses, (torch_dist.group.WORLD,))[::mesh.model]
        metrics = {
            "loss": ordered_mean(losses),
            "comm_bytes": wire_meas,
            "comm_bytes_predicted": wire_pred,
        }
        if timeline is not None:
            metrics["timeline"] = timeline
        if adaptive:
            # the k each leaf used this round (ctrl carries the next)
            ks = torch.stack([c.k.float() for c in tree_leaves(ctrl_state)])
            metrics["adaptive_k"] = const_div(ks.sum(), float(ks.numel()))
        return new_params, new_opt, new_sp, metrics

    return train_step
