"""Sparsified data-parallel training on one card (counterpart of
``repro.core.distributed``).

The JAX trainer's W is the size of its data-parallel mesh: it vmaps the W
workers' gradients in one program and aggregates their payloads over the
mesh. The port keeps that leading worker axis on one card: W logical
workers, each with its own batch shard, gradient and ``CompactState``,
aggregated by the one-card ``sparse_allgather`` or ``dense_allreduce``.
It is the counterpart of the JAX trainer under
``--xla_force_host_platform_device_count=W``.

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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.comm import cost
from repro_torch.comm import fastpath as fp
from repro_torch.comm.codec import get_codec
from repro_torch.comm.collectives import _coord_divide, check_weighting, get_collective
from repro_torch.core import compact as C
from repro_torch.core.selectors import sparsity_to_k
from repro_torch.core.sparsify import SparsifierConfig
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
    """Per-leaf static plan: length, ``k = sparsity_to_k(length, S)`` and
    whether the leaf is fused (``fastpath.leaf_fused`` under
    ``dist.resolved_fastpath()``). ``"auto"`` prices each leaf with
    ``table`` (its defaults when None), and fuses only where the leaf's
    device can run the kernel (``fastpath.backend_supports``)."""
    mode = "off" if dist is None else dist.resolved_fastpath()
    if dist is not None:
        dist.resolved_weighting()

    def mk(leaf):
        n = leaf.numel()
        k = sparsity_to_k(n, sparsity)
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


def _spa_leaf(g, st, p: LeafPlan, scfg, codec, collective, coord, counts):
    """One leaf's round for all W workers: ``g [W, *shape]``. Returns
    (aggregate ``[*shape]``, new state)."""
    W = g.shape[0]
    gl = g.reshape(W, p.local_len)
    if scfg.kind == "none":
        return gl.float().mean(0).reshape(p.global_shape), st._replace(
            t=st.t + 1
        )
    a, vals, idx = C.compact_select(
        scfg, st, gl, p.k, fastpath="on" if p.fused else None, counts=counts
    )
    den = None  # the sender mass, under coordinate weighting
    if collective.name == "dense_allreduce":
        # the dense vector on the wire: each worker's payload scattered
        # (added, so padding slots are no-ops) into its ghat, the weighted
        # sums taken one worker at a time in worker order
        ghat = torch.zeros_like(a).scatter_add_(1, idx, vals)
        presence = (ghat != 0).to(ghat.dtype)
        agg = torch.zeros_like(ghat[0])
        den = torch.zeros_like(agg) if coord else None
        for w in range(W):
            agg = agg + ghat[w] * scfg.omega
            if coord:
                den = den + presence[w] * scfg.omega
        if coord:
            agg = _coord_divide(agg, den)
        new = C.compact_finalize(st, a, vals, idx, agg, den=den)
        return agg.reshape(p.global_shape).to(g.dtype), new
    payload = (
        codec.encode_fused(vals, idx, p.local_len)
        if p.fused
        else codec.encode(vals, idx, p.local_len)
    )
    dvals, didx = codec.decode(payload, p.local_len)
    sent_dense = torch.zeros_like(a).scatter_add_(1, didx, dvals.to(a.dtype))
    if coord:
        agg, den = collective.reference_coord(
            codec, payload, scfg.omega, p.local_len
        )
        agg, den = agg.to(a.dtype), den.to(a.dtype)
    else:
        agg = collective.reference(codec, payload, scfg.omega, p.local_len)
    new = C.compact_finalize_sent(st, a, dvals, didx, sent_dense, agg, den=den)
    return agg.reshape(p.global_shape).to(g.dtype), new


def make_sparsify_aggregate(plan, dist: DistConfig, n_workers: int,
                            counts: Optional[fp.FastpathCounts] = None):
    """``spa(grads, state) -> (agg, new_state)`` over the parameter tree;
    ``grads`` leaves are ``[W, *shape]``."""
    scfg = dataclasses.replace(dist.sparsifier, omega=1.0 / n_workers)
    codec = get_codec(dist.codec)
    collective = get_collective(dist.collective)
    coord = dist.resolved_weighting() == "coordinate"
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

    def spa(grads, state):
        outs = tree_map(
            lambda g, s, p: _spa_leaf(
                g, s, p, scfg, codec, collective, coord, counts
            ),
            grads, state, plan,
        )
        return tree_unzip(outs, 2)

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


def comm_round_bytes(plan, dist: DistConfig, workers: int) -> Tuple[int, int]:
    """(predicted, measured) bytes on the wire per worker per round, summed
    over leaves, from ``repro_torch.comm.cost``: predicted from the
    codec's bit accounting, measured from the buffers one
    ``codec.encode`` returns. The W workers form one dp axis."""
    codec = get_codec(dist.codec)
    pred = meas = 0
    for p, coll, dense in _leaf_wire_patterns(plan, dist):
        pred += cost.predicted_bytes(codec, coll, p.local_len, p.k, (workers,))
        payload = {} if dense else _one_payload(codec, p.local_len, p.k)
        meas += cost.measured_bytes(coll, p.local_len, payload, (workers,))
    return pred, meas


def comm_round_cost(plan, dist: DistConfig, workers: int) -> cost.CostEstimate:
    """Predicted per-worker alpha–beta cost of one round, summed over
    leaves under ``dist.resolved_link_model()``."""
    codec = get_codec(dist.codec)
    model = dist.resolved_link_model()
    total_bytes = total_msgs = 0
    total_seconds = 0.0
    for p, coll, _ in _leaf_wire_patterns(plan, dist):
        est = cost.predict(codec, coll, p.local_len, p.k, (workers,), model)
        total_bytes += est.bytes_on_wire
        total_msgs += est.n_messages
        total_seconds += est.seconds
    return cost.CostEstimate(
        bytes_on_wire=total_bytes, n_messages=total_msgs, seconds=total_seconds
    )


def make_train_step(cfg: ModelConfig, dist: DistConfig, plan, n_workers: int,
                    counts: Optional[fp.FastpathCounts] = None):
    """``train_step(params, opt_state, sp_state, batch) -> (params,
    opt_state, sp_state, metrics)``. The global batch splits into W equal
    worker shards in order, as the JAX trainer reshapes it to ``[W, B/W,
    ...]``. Matrix products run in full float32 (no TF32)."""
    set_fp32_matmul()
    opt = make_optimizer(dist.optimizer)
    spa = make_sparsify_aggregate(plan, dist, n_workers, counts)
    W = n_workers
    wire_pred, wire_meas = comm_round_bytes(plan, dist, W)

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
        for n in range(W):
            shard = {key: v[n * per:(n + 1) * per] for key, v in batch.items()}
            loss, grads = worker_grads(params, shard)
            losses.append(loss)
            per_worker.append(grads)
        grads_w = tree_unflatten(
            params, [torch.stack(gs) for gs in zip(*per_worker, strict=True)]
        )
        agg, new_sp = spa(grads_w, sp_state)
        new_params, new_opt = opt.update(agg, opt_state, params)
        metrics = {
            "loss": torch.stack(losses).mean(),
            "comm_bytes": wire_meas,
            "comm_bytes_predicted": wire_pred,
        }
        return new_params, new_opt, new_sp, metrics

    return train_step
