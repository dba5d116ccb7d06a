"""Sparsified data-parallel training on one card (counterpart of
``repro.core.distributed``).

The JAX trainer's W is the size of its data-parallel mesh: it vmaps the W
workers' gradients in one program and aggregates their payloads over the
mesh. The port keeps that leading worker axis on one card: W logical
workers, each with its own batch shard, gradient and ``CompactState``,
aggregated by the one-card ``sparse_allgather``. It is the counterpart of
the JAX trainer under ``--xla_force_host_platform_device_count=W``.

One round per leaf (``_spa_leaf``): accumulate and select
(``compact_select``, fused through the CUDA kernel on fused leaves),
encode with the codec, aggregate with weight omega = 1/W, and feed the
decoded contribution back into the error. Adam then runs once on the
common aggregate.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.comm import fastpath as fp
from repro_torch.comm.codec import get_codec
from repro_torch.comm.collectives import get_collective
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
    # per worker); "off" is dense selection.
    fastpath: str = "off"

    def resolved_fastpath(self) -> str:
        if self.fastpath not in fp.FASTPATH_MODES:
            raise ValueError(
                f"fastpath {self.fastpath!r} is not ported; the port has "
                f"{fp.FASTPATH_MODES} ('auto' prices with a TPU memory "
                "rate and waits for a table refitted on the card)"
            )
        return self.fastpath


class LeafPlan(NamedTuple):
    global_shape: Tuple[int, ...]
    local_len: int
    k: int
    fused: bool = False


def build_plan(params, sparsity: float, dist: Optional[DistConfig] = None):
    """Per-leaf static plan: length, ``k = sparsity_to_k(length, S)`` and,
    with ``dist.fastpath == "on"``, whether the fusability matrix admits
    the leaf to the fused kernel."""
    mode = "off" if dist is None else dist.resolved_fastpath()

    def mk(leaf):
        n = leaf.numel()
        k = sparsity_to_k(n, sparsity)
        fused = mode == "on" and fp.fusable(
            dist.sparsifier, dist.codec, dist.collective, n, k
        )[0]
        return LeafPlan(tuple(leaf.shape), n, k, fused)

    return tree_map(mk, params)


def init_sparsifier_state(plan, workers: int, device="cuda"):
    return tree_map(
        lambda p: C.compact_init(workers, p.local_len, p.k, device), plan
    )


def _spa_leaf(g, st, p: LeafPlan, scfg, codec, collective, counts):
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
    payload = (
        codec.encode_fused(vals, idx, p.local_len)
        if p.fused
        else codec.encode(vals, idx, p.local_len)
    )
    dvals, didx = codec.decode(payload, p.local_len)
    sent_dense = torch.zeros_like(a).scatter_add_(1, didx, dvals.to(a.dtype))
    agg = collective.reference(codec, payload, scfg.omega, p.local_len)
    new = C.compact_finalize_sent(st, a, dvals, didx, sent_dense, agg)
    return agg.reshape(p.global_shape).to(g.dtype), new


def make_sparsify_aggregate(plan, dist: DistConfig, n_workers: int,
                            counts: Optional[fp.FastpathCounts] = None):
    """``spa(grads, state) -> (agg, new_state)`` over the parameter tree;
    ``grads`` leaves are ``[W, *shape]``."""
    scfg = dataclasses.replace(dist.sparsifier, omega=1.0 / n_workers)
    codec = get_codec(dist.codec)
    collective = get_collective(dist.collective)
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
            lambda g, s, p: _spa_leaf(g, s, p, scfg, codec, collective, counts),
            grads, state, plan,
        )
        return tree_unzip(outs, 2)

    return spa


def _payload_bytes(codec, length: int, k: int) -> int:
    """Bytes of one worker's encoded payload, summed over the buffers that
    ``codec.encode`` returns for a k-entry selection. It runs on the meta
    device, which gives the buffers' shapes and dtypes without data (the
    counterpart of the JAX package's ``jax.eval_shape``)."""
    vals = torch.empty(k, dtype=torch.float32, device="meta")
    idx = torch.empty(k, dtype=torch.int64, device="meta")
    payload = codec.encode(vals, idx, length)
    return sum(b.numel() * b.element_size() for b in payload.values())


def comm_round_bytes(plan, dist: DistConfig, workers: int) -> Tuple[int, int]:
    """(predicted, measured) bytes on the wire per worker per round, summed
    over leaves: predicted from the codec's bit accounting, measured from
    the buffers one ``codec.encode`` returns (``_payload_bytes``). Kind
    "none" moves the dense f32 vector in a ring all-reduce."""
    codec = get_codec(dist.codec)
    collective = get_collective(dist.collective)
    pred = meas = 0
    for p in tree_leaves(plan):
        if dist.sparsifier.kind == "none":
            dense = math.ceil(2 * (workers - 1) * 4 * p.local_len / workers)
            pred += dense
            meas += dense
            continue
        pb = math.ceil(codec.wire_bits(p.local_len, p.k) / 8)
        pred += collective.bytes_per_worker(pb, workers)
        meas += collective.bytes_per_worker(
            _payload_bytes(codec, p.local_len, p.k), workers
        )
    return pred, meas


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
