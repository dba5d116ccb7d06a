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

A partial-participation schedule (``DistConfig.participation``) draws
one mask a round, shared by every leaf: participants aggregate with the
renormalized weight ``1/|P_t|``, and a dropped worker keeps its whole
accumulated gradient in ``eps`` with its ``sent_*`` frozen. The adaptive-k
controller (``DistConfig.adaptive_k``) sizes every leaf's payload at its
``k_max`` and sends the controller's per-leaf k; the train step then
carries the pair ``(compact state tree, controller state tree)``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as torch_dist

from repro_torch.comm import cost
from repro_torch.comm import fastpath as fp
from repro_torch.comm.controller import AdaptiveKController
from repro_torch.comm.participation import Participation, worker_index
from repro_torch.comm.codec import get_codec
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
from repro_torch.kernels.regtopk_score import ieee_div
from repro_torch.launch.mesh import DpGroups, dp_axes_of
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.nn.layers import set_fp32_matmul
from repro_torch.optim import OptConfig, make_optimizer
from repro_torch.tree import (
    tree_leaves,
    tree_map,
    tree_unflatten,
    tree_unzip,
)


@dataclasses.dataclass(frozen=True)
class DistConfig:
    sparsifier: SparsifierConfig = SparsifierConfig(
        kind="regtopk", sparsity=0.001
    )
    optimizer: OptConfig = OptConfig(kind="adam", learning_rate=1e-4)
    codec: str = "coo_fp32"
    collective: str = "sparse_allgather"
    # "on" routes every fusable leaf through the fused select→encode
    # kernel (same payload: its certificate falls back to dense selection
    # per worker); "auto" fuses the leaves a ThroughputTable prices faster,
    # on the card only; "off" is dense selection.
    fastpath: str = "off"
    # "worker" is the Eq. (8) reduction; "coordinate" divides each
    # coordinate by the mass of the workers that sent it and records that
    # mass (CompactState.sent_w) for RegTop-k's next posterior
    weighting: str = "worker"
    # one cost.AlphaBeta per dp mesh axis, outermost first (the CLI's
    # --link-topo); None prices with cost.AlphaBeta()'s defaults
    link_topo: Optional[cost.LinkTopo] = None
    # partial-participation schedule over the dp workers (the CLI's
    # --participation); None or a full schedule is the all-workers round,
    # bit for bit. 'stale' needs the simulator's pending buffer.
    participation: Optional[Participation] = None
    # error-budget-driven per-round k (the CLI's --adaptive-k); None is
    # the static k, bit for bit. Every leaf's payload capacity is then its
    # k_max, and the train step carries a ControllerState tree
    adaptive_k: Optional[AdaptiveKController] = None

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
        weighting refuses "on" and resolves "auto" to "off". Whether the
        device can run the kernel is ``build_plan``'s to decide."""
        if self.fastpath not in fp.FASTPATH_MODES:
            raise ValueError(
                f"unknown fastpath {self.fastpath!r}; "
                f"available: {fp.FASTPATH_MODES}"
            )
        if (
            self.fastpath != "off"
            and self.weighting == "coordinate"
            and self.sparsifier.kind == "regtopk"
        ):
            if self.fastpath == "on":
                raise ValueError(
                    "fastpath='on' cannot fuse regtopk under "
                    "weighting='coordinate': the fused score kernel bakes "
                    "a scalar omega, but coordinate weighting conditions "
                    "on the per-coordinate sender mass (sent_w) — use "
                    "fastpath='off'/'auto'"
                )
            return "off"
        return self.fastpath

    def resolved_link_model(self) -> cost.LinkModel:
        return self.link_topo if self.link_topo is not None else cost.AlphaBeta()


class LeafPlan(NamedTuple):
    global_shape: Tuple[int, ...]
    local_len: int
    k: int
    fused: bool = False


def build_plan(params, sparsity: float, dist: Optional[DistConfig] = None,
               table: Optional[fp.ThroughputTable] = None):
    """Per-leaf static plan: length, ``k = sparsity_to_k(length, S)`` (the
    controller's ``k_max`` bound under ``dist.adaptive_k``: the payload
    capacity) and whether the leaf is fused (``fastpath.leaf_fused`` under
    ``dist.resolved_fastpath()``). ``"auto"`` prices each leaf with
    ``table`` (its defaults when None), and fuses only where the leaf's
    device can run the kernel (``fastpath.backend_supports``)."""
    mode = "off" if dist is None else dist.resolved_fastpath()
    ctrl = None if dist is None else dist.resolved_adaptive_k()
    if dist is not None:
        dist.resolved_weighting()

    def mk(leaf):
        n = leaf.numel()
        k = sparsity_to_k(n, sparsity) if ctrl is None else ctrl.bounds(n)[1]
        leaf_mode = mode
        if mode == "auto" and not fp.backend_supports(leaf.device):
            leaf_mode = "off"
        fused = leaf_mode != "off" and fp.leaf_fused(
            leaf_mode, dist.codec, dist.collective, n, k, table,
            scfg=dist.sparsifier,
        )
        return LeafPlan(tuple(leaf.shape), n, k, fused)

    return tree_map(mk, params)


def init_sparsifier_state(plan, workers: int, device="cuda"):
    return tree_map(
        lambda p: C.compact_init(workers, p.local_len, p.k, device), plan
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


def _ctrl_update(ctrl_cfg, ctrl_leaf, new_st, agg, p: LeafPlan, groups,
                 n_workers: int):
    """Fold one leaf's round into its controller state: the workers' mean
    ``||eps||`` (summed over the ranks of ``groups`` across ranks, then
    divided by W, as ``pmean``) against ``||g_agg||``."""
    eps = new_st.eps.float()
    norms = torch.sqrt((eps * eps).sum(-1))
    total = norms.sum() if groups is None else _psum(norms[0], groups)
    ag = agg.reshape(p.local_len).float()
    lo, hi = ctrl_cfg.bounds(p.local_len)
    return ctrl_cfg.observe(
        ctrl_leaf, ieee_div(total, float(n_workers)),
        torch.sqrt((ag * ag).sum()), k_min=lo, k_max=hi,
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
              groups=None, part_ctx=None, k_dyn=None):
    """One leaf's round for the W workers of ``g [W, *shape]``. Returns
    (aggregate ``[*shape]``, new state). ``groups`` (the dp process
    groups, outermost first) makes it this rank's round, ``g [1,
    *shape]``, reduced across the ranks; None keeps every worker on this
    card.

    ``part_ctx`` ``(m, w_part)`` makes the round partial: ``m`` the mask
    entries of this card's W workers (``[1]`` across ranks, this rank's
    own) and ``w_part`` the renormalized participant weight ``1/|P_t|``.
    Participants aggregate with ``w_part``; a dropped worker keeps ``a``
    in ``eps`` and its ``sent_*`` frozen. ``k_dyn`` (a tensor) is the
    controller's k under the capacity ``p.k``."""
    W = g.shape[0]
    gl = g.reshape(W, p.local_len)
    m, w_part = part_ctx if part_ctx is not None else (None, None)
    if scfg.kind == "none":
        if m is not None:  # no error state: a dropped gradient is lost
            wm = m * w_part
            mean = (_weighted_sum(gl.float(), wm) if groups is None
                    else _psum(gl[0].float() * wm[0], groups))
        elif groups is None:
            mean = gl.float().mean(0)
        else:  # pmean: the sum over the ranks, divided by their number
            n = math.prod(torch_dist.get_world_size(gr) for gr in groups)
            mean = ieee_div(_psum(gl[0].float(), groups), float(n))
        return mean.reshape(p.global_shape), st._replace(t=st.t + 1)
    a, vals, idx = C.compact_select(
        scfg, st, gl, p.k, k_dyn=k_dyn, fastpath="on" if p.fused else None,
        counts=counts,
    )
    # the aggregation weight: omega, or the participant weight times each
    # worker's mask entry on a partial round
    weight = scfg.omega if m is None else w_part * m
    den = None  # the sender mass, under coordinate weighting
    if collective.name == "dense_allreduce":
        # the dense vector on the wire: each worker's payload scattered
        # (added, so padding slots are no-ops) into its ghat, the weighted
        # sums taken one worker at a time in worker order
        ghat = torch.zeros_like(a).scatter_add_(1, idx, vals)
        agg = _weighted_sum(ghat, weight)
        if coord:
            den = _weighted_sum((ghat != 0).to(ghat.dtype), weight)
        if groups is not None:
            agg = _psum(agg, groups)
            den = _psum(den, groups) if coord else None
        if coord:
            agg = _coord_divide(agg, den)
        new = C.compact_finalize(st, a, vals, idx, agg, den=den)
    else:
        payload = (
            codec.encode_fused(vals, idx, p.local_len)
            if p.fused
            else codec.encode(vals, idx, p.local_len)
        )
        dvals, didx = codec.decode(payload, p.local_len)
        sent_dense = torch.zeros_like(a).scatter_add_(1, didx, dvals.to(a.dtype))
        if groups is None:
            reduce = collective.reference_coord if coord else collective.reference
            out = reduce(codec, payload, weight, p.local_len)
        else:
            reduce = collective.shard_coord if coord else collective.shard
            out = reduce(codec, payload, p.local_len, groups,
                         scfg.omega if m is None else w_part,
                         participation=None if m is None else m[0])
        agg, den = out if coord else (out, None)
        agg = agg.to(a.dtype)
        den = None if den is None else den.to(a.dtype)
        new = C.compact_finalize_sent(st, a, dvals, didx, sent_dense, agg,
                                      den=den)
    if m is not None:
        dropped = st._replace(eps=a, t=st.t + 1)
        live = m > 0
        new = C.CompactState(*(
            torch.where(live.reshape((-1,) + (1,) * (x.dim() - 1)), x, y)
            for x, y in zip(new, dropped, strict=True)
        ))
    return agg.reshape(p.global_shape).to(g.dtype), new


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
    new_state, new_ctrl)``."""
    groups = _dp_groups(mesh, n_workers)
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
    codec = get_codec(dist.codec)
    collective = get_collective(dist.collective)
    coord = dist.resolved_weighting() == "coordinate"
    ctrl_cfg = dist.resolved_adaptive_k()
    for p in tree_leaves(plan):
        if p.fused:
            ok, why = fp.fusable(
                dist.sparsifier, dist.codec, dist.collective, p.local_len, p.k
            )
            if not ok:
                raise ValueError(
                    f"plan marks a {p.local_len}-element leaf fused but it "
                    f"is not fusable: {why}"
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

    def spa(grads, state, ctrl=None):
        part_ctx = round_ctx(state)
        outs = tree_map(
            lambda g, s, p, c: _spa_leaf(
                g, s, p, scfg, codec, collective, coord, counts, groups,
                part_ctx, None if c is None else c.k,
            ),
            grads, state, plan,
            ctrl if ctrl is not None else tree_map(lambda _: None, plan),
        )
        agg, new_state = tree_unzip(outs, 2)
        if ctrl_cfg is None:
            return agg, new_state
        new_ctrl = tree_map(
            lambda c, o, p: _ctrl_update(ctrl_cfg, c, o[1], o[0], p, groups,
                                         n_workers),
            ctrl, outs, plan,
        )
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
    """``(leaf, effective collective, dense wire)`` per leaf: kind "none"
    and ``dense_allreduce`` put the dense f32 vector on the wire."""
    for p in tree_leaves(plan):
        dense = dist.sparsifier.kind == "none" or (
            dist.collective == "dense_allreduce"
        )
        yield p, "dense_allreduce" if dense else dist.collective, dense


def _dp_sizes(workers) -> Tuple[int, ...]:
    """The dp axis sizes, outermost first: an int is one axis of W."""
    return (workers,) if isinstance(workers, int) else tuple(workers)


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
    codec = get_codec(dist.codec)
    dp = _dp_sizes(workers)
    participants = _participants(dist, dp)
    pred = meas = 0
    for p, coll, dense in _leaf_wire_patterns(plan, dist):
        pred += cost.predicted_bytes(codec, coll, p.local_len, p.k, dp,
                                     participants=participants)
        payload = {} if dense else _one_payload(codec, p.local_len, p.k)
        meas += cost.measured_bytes(coll, p.local_len, payload, dp)
    return pred, meas


def comm_round_cost(plan, dist: DistConfig, workers) -> cost.CostEstimate:
    """Predicted per-worker alpha–beta cost of one round, summed over
    leaves under ``dist.resolved_link_model()``; ``workers`` as in
    ``comm_round_bytes``. A partial schedule prices the expected partial
    round."""
    codec = get_codec(dist.codec)
    model = dist.resolved_link_model()
    dp = _dp_sizes(workers)
    participants = _participants(dist, dp)
    total_bytes = total_msgs = 0
    total_seconds = 0.0
    for p, coll, _ in _leaf_wire_patterns(plan, dist):
        est = cost.predict(codec, coll, p.local_len, p.k, dp, model,
                           participants=participants)
        total_bytes += est.bytes_on_wire
        total_msgs += est.n_messages
        total_seconds += est.seconds
    return cost.CostEstimate(
        bytes_on_wire=total_bytes, n_messages=total_msgs, seconds=total_seconds
    )


def make_train_step(cfg: ModelConfig, dist: DistConfig, plan, n_workers: int,
                    counts: Optional[fp.FastpathCounts] = None,
                    mesh: Optional[DpGroups] = None):
    """``train_step(params, opt_state, sp_state, batch) -> (params,
    opt_state, sp_state, metrics)``. The global batch splits into W equal
    worker shards in order, as the JAX trainer reshapes it to ``[W, B/W,
    ...]``. Across the ranks of ``mesh`` each rank takes worker
    ``mesh.rank``'s shard, and the W losses are gathered in rank order,
    so the logged mean is the one-card mean. Matrix products run in full
    float32 (no TF32).

    Under ``dist.adaptive_k`` the sparsifier state is the pair
    ``(compact state tree, controller state tree)``
    (:func:`init_controller_state`) and the metrics gain
    ``"adaptive_k"``, the mean per-leaf k the round used."""
    set_fp32_matmul()
    opt = make_optimizer(dist.optimizer)
    spa = make_sparsify_aggregate(plan, dist, n_workers, counts, mesh)
    adaptive = dist.resolved_adaptive_k() is not None
    W = n_workers
    wire_pred, wire_meas = comm_round_bytes(
        plan, dist, W if mesh is None else mesh.shape
    )
    mine = range(W) if mesh is None else [mesh.rank]

    def worker_grads(params, wbatch):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        leaves = tree_leaves(live)
        loss = lm.loss_fn(live, cfg, wbatch)[0]
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), grads

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
            per_worker.append(grads)
        grads_w = tree_unflatten(
            params, [torch.stack(gs) for gs in zip(*per_worker, strict=True)]
        )
        if adaptive:
            cp_state, ctrl_state = sp_state
            agg, new_cp, new_ctrl = spa(grads_w, cp_state, ctrl_state)
            new_sp = (new_cp, new_ctrl)
        else:
            agg, new_sp = spa(grads_w, sp_state)
        new_params, new_opt = opt.update(agg, opt_state, params)
        losses = torch.stack(losses)
        if mesh is not None:
            losses = _gather(losses, (torch_dist.group.WORLD,))
        metrics = {
            "loss": losses.mean(),
            "comm_bytes": wire_meas,
            "comm_bytes_predicted": wire_pred,
        }
        if adaptive:
            # the k each leaf used this round (ctrl carries the next)
            ks = torch.stack([c.k.float() for c in tree_leaves(ctrl_state)])
            metrics["adaptive_k"] = ieee_div(ks.sum(), float(ks.numel()))
        return new_params, new_opt, new_sp, metrics

    return train_step
