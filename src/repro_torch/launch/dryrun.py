"""The dry run on the meta device (counterpart of ``repro.launch.dryrun``).

    python -m repro_torch.launch.dryrun --both-meshes
    python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k

The JAX dry run lowers and compiles every (arch, shape) combo on the
production mesh of 512 host devices and records what one device holds
and does. The port runs each combo eagerly on ``device="meta"``: shapes
come from each family's ``init(cfg, device="meta")``, the specs from
``nn.sharding`` and the plan from ``build_plan(axes=, mesh=)`` on the
``{axis: size}`` layout of ``launch.mesh.production_shape``; one step is
traced by ``launch.op_cost``. Nothing is allocated on any device and no
CUDA call is made, on any machine: the meta device is the counterpart of
JAX's host devices, not a fallback from a card.

"Per device" is one rank of the layout, one (worker, model shard). A
record has the JAX record's keys and the port's own:

* ``mem.argument_bytes``: the step's arguments on one rank under their
  specs, as JAX's ``argument_size_in_bytes`` counts them: the parameters
  under ``nn.sharding``, Adam's moments under :func:`zero1_specs` and its
  step, the sparsifier state laid out as JAX's
  ``sparsifier_state_shapes`` lays it out (``eps [W, *shape]`` and
  ``sent_* [W, M, k]``), and the worker's batch rows (the decode cache and
  token, or the prompt, under ``count_serve``). It is what a port that
  shards the forward, the parameters and Adam would hold. The port's
  dtypes differ from JAX's in two fields: the tokens and labels, and
  ``sent_idx``, are int64, not int32;
* ``mem.peak_bytes``: the peak of one step as the port's trainer runs it
  across ranks: what the rank holds before the step (``rank_bytes``) and
  the most that the step's own tensors hold at once, traced on the meta
  device. ``output_bytes`` and ``temp_bytes`` have no counterpart and
  are null;
* ``flops``, ``hbm_bytes``: ``op_cost.analyze`` of that step (one
  worker's forward and backward at its rows, on the rank's blocks where
  the trainer is tensor parallel, its round and Adam; or one prefill or
  decode step). ``xla_flops_looponce`` is null;
* ``collective_bytes``: what the step's collectives return on one rank
  of the sharded layout, from the plan: ``all-gather``, the payloads
  gathered over the dp axes (W x one payload per leaf under
  ``sparse_allgather``) and ZeRO-1's gather of each dp-sharded update in
  f32, and ``all-reduce``, the dense sums (``dense_allreduce``,
  ``hierarchical``'s inner stage) and the loss mean's 4 B: at M = 1 the
  figures of JAX's walker. GSPMD's activation traffic at M > 1 is not in
  it (the port's own is in ``rank_collective_bytes``);
* ``rank_bytes``, ``rank_collective_bytes`` (the port's own): what one
  rank of the port's trainer holds and moves: the parameters, one
  gradient in the state dtype and the Adam state, its own (worker, shard)
  state rows and its worker's batch rows; the dp payloads and every
  rank's 4 B loss gathered. At M > 1 every config trains tensor parallel
  (``core.distributed.make_train_step``): the parameters, the
  gradient and Adam are the rank's blocks (ZeRO-1's dp split of the
  moments is the JAX dry run's layout, not its trainer's, and the port
  keeps the moments whole over dp), and ``all-reduce:model`` and
  ``all-gather:model`` are the model group's activation all-reduces and
  the logits' vocabulary gather (and the SSD mixer's gathered ``in_proj``,
  ``conv_w`` and ``conv_b`` and their summed gradients, and each encoder-
  decoder layer's entry of the encoder output into its cross-attention),
  counted as the traced step issues them (``nn.tensor_parallel``; remat's
  recompute included). A family module whose ``TENSOR_PARALLEL`` is
  emptied (the tests do it) holds the whole parameters and Adam state on
  every rank, and ``all-gather:model`` is then the model group's gather
  of each split leaf's aggregate. For serving (``count_serve``), the
  rank's blocks of the parameters under ``nn.sharding.serve_rules``, the
  cache block of its batch rows and its slots or kv heads (and its
  blocks of the SSD's conv channels and SSM heads; the encoder-decoder's
  cross cache by its kv heads where they split, else whole), and its
  tokens: what the JAX device's ``argument_size_in_bytes`` counts, but
  for the int64 tokens' 4 B a row; ``all-reduce:model`` and
  ``all-gather:model`` are the step's model-group collectives
  (``models.lm`` and ``models.encdec``: per layer the attention
  outputs' and the MLP's or MoE's all-reduces, in the sequence layout the
  query heads' and the partial softmaxes' gathers; per mamba block
  ``nn.ssd``'s gathers of ``zxbcdt`` and the conv output and its
  all-reduces of the squares' sum and the output; the embedding's
  all-reduce and the logits' gather). A family outside
  ``models.serve_parallel``, or any family with its module's
  ``TENSOR_PARALLEL`` emptied, holds the whole parameters and the cache
  of its rows;
* ``fits``: whether ``peak_bytes`` fits one card's ``HBM_BYTES``.

A combo that ``build_plan`` refuses (a block past the int32 wire's
``MAX_WIRE_LEN``) prints a ``FAIL`` line and the sweep goes on.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Mapping, Optional

import torch

from repro_torch import configs as cfglib
from repro_torch.comm.codec import get_codec
from repro_torch.comm.collectives import get_collective
from repro_torch.core import distributed as td
from repro_torch.core.compact import CompactState
from repro_torch.core.sparsify import SparsifierConfig
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import op_cost
from repro_torch.launch.serve import serve_layout
from repro_torch.models import get_family, input_specs, param_axes
from repro_torch.nn.sharding import shard_params, tree_specs
from repro_torch.optim import OptConfig, make_optimizer
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

OUT = os.path.join("dryrun_out", "dryrun.jsonl")

# per-arch microbatch counts for train_4k (the JAX dry run's values)
MICROBATCHES = {
    "whisper-tiny": 8,
    "qwen2.5-3b": 4,
    "internvl2-1b": 8,
    "mamba2-780m": 2,
    "chatglm3-6b": 4,
    "zamba2-7b": 4,
    "mixtral-8x7b": 8,
    "deepseek-moe-16b": 8,
    "granite-3-8b": 4,
    "granite-3-8b-swa": 4,
    "phi3-medium-14b": 16,
    "paper-resnet-proxy": 1,
}
# eps/state dtype: bf16 for the param-heavy archs, which also keep bf16
# Adam moments
STATE_DTYPE = {
    "mixtral-8x7b": "bfloat16",
    "phi3-medium-14b": "bfloat16",
    "zamba2-7b": "bfloat16",
    "chatglm3-6b": "bfloat16",
    "granite-3-8b": "bfloat16",
    "granite-3-8b-swa": "bfloat16",
    "deepseek-moe-16b": "bfloat16",
}
ATTN_BLOCK = {"phi3-medium-14b": 512}

CFG_OVERRIDES: Dict[str, Any] = {}


def _apply_overrides(cfg):
    """``cfg`` with ``CFG_OVERRIDES`` (the ``--cfg key=value`` strings)
    converted to each field's type."""
    if CFG_OVERRIDES:
        kw = {}
        for k, v in CFG_OVERRIDES.items():
            cur = getattr(cfg, k)
            if isinstance(cur, bool):
                v = v in ("1", "true", "True")
            elif isinstance(cur, int) or (cur is None and v.isdigit()):
                v = int(v)
            elif isinstance(cur, float):
                v = float(v)
            kw[k] = v
        cfg = cfg.replace(**kw)
    return cfg


def arch_dist_config(arch: str, mesh_shape: Mapping[str, int], *,
                     sparsity: float = 0.001,
                     aggregation: str = "sparse_allgather",
                     kind: str = "regtopk") -> td.DistConfig:
    big = arch in STATE_DTYPE  # the param-heavy archs
    return td.DistConfig(
        sparsifier=SparsifierConfig(kind=kind, sparsity=sparsity, mu=1.0),
        optimizer=OptConfig(
            kind="adam", learning_rate=1e-4,
            moment_dtype="bfloat16" if big else "float32"),
        aggregation=aggregation,
        microbatches=MICROBATCHES.get(arch, 4),
        dp_axes=meshlib.dp_axes_of(mesh_shape),
        state_dtype=STATE_DTYPE.get(arch, "float32"),
    )


def zero1_specs(params, param_specs, mesh_shape: Mapping[str, int], dp_axes):
    """ZeRO-1: the optimizer moments sharded like the parameters and,
    where no dp axis is taken, over the dp axes on the first dim not
    already sharded that the dp size divides."""
    dp = tuple(dp_axes)
    dp_size = math.prod(mesh_shape[a] for a in dp)
    dp_entry = dp if len(dp) > 1 else dp[0]

    def mk(leaf, spec):
        taken = {a for e in spec if e is not None
                 for a in (e if isinstance(e, tuple) else (e,))}
        if any(a in taken for a in dp):
            return spec
        for i, (d, e) in enumerate(zip(leaf.shape, spec, strict=True)):
            if e is None and d % dp_size == 0 and d >= dp_size:
                return spec[:i] + (dp_entry,) + spec[i + 1:]
        return spec

    return tree_map(mk, params, param_specs)


def _nbytes(shape, dtype: torch.dtype, spec=None,
            mesh_shape: Optional[Mapping[str, int]] = None) -> int:
    """Bytes of one device's block of a ``shape`` tensor under ``spec``."""
    if spec is not None:
        shape = td._local_shape(shape, spec, mesh_shape)
    return math.prod(shape) * dtype.itemsize


def _tree_bytes(tree) -> int:
    """Bytes of a tree's tensors, those of its ``CompactState`` leaves
    (tuples of tensors) too."""
    return sum(t.numel() * t.element_size() for x in tree_leaves(tree)
               for t in (x if isinstance(x, tuple) else (x,))
               if isinstance(t, torch.Tensor))


def _meta_batch(specs) -> Dict[str, torch.Tensor]:
    return {k: torch.empty(s, dtype=d, device="meta")
            for k, (s, d) in specs.items()}


def sparsifier_state_shapes(plan, W: int, mesh_shape: Mapping[str, int],
                            dp_axes, dtype: torch.dtype):
    """Each leaf's ``CompactState`` of ``(shape, dtype, spec)`` triples in
    the JAX layout (``repro.core.distributed.sparsifier_state_shapes``):
    the worker axis over the dp axes, ``sent_*`` with a model-shard axis.
    The port's ``sent_idx`` is int64."""
    M = mesh_shape[meshlib.MODEL_AXIS]
    dp = tuple(dp_axes) if len(dp_axes) > 1 else dp_axes[0]
    sent = (dp, meshlib.MODEL_AXIS, None)

    def mk(p: td.LeafPlan):
        return CompactState(
            eps=((W,) + p.global_shape, dtype, (dp,) + tuple(p.spec)),
            sent_vals=((W, M, p.k), dtype, sent),
            sent_g=((W, M, p.k), dtype, sent),
            sent_idx=((W, M, p.k), torch.int64, sent),
            sent_w=((W, M, p.k), dtype, sent),
            t=((W,), torch.int32, (dp,)),
        )

    return tree_map(mk, plan)


@dataclasses.dataclass
class TrainLayout:
    """One (arch, train shape) combo on a layout, nothing allocated."""

    cfg: Any
    dist: td.DistConfig
    mesh: Dict[str, int]
    W: int
    rows: int  # a worker's batch rows
    seq: int
    params: Any  # meta tensors
    param_specs: Any
    plan: Any
    opt_state: Any  # meta tensors
    mom_specs: Any
    state: Any  # sparsifier_state_shapes
    batch_specs: Dict[str, Any]  # the global batch's {name: (shape, dtype)}
    argument_bytes: Dict[str, int]


def train_layout(arch: str, shape_name: str, mesh_shape: Mapping[str, int],
                 dist: Optional[td.DistConfig] = None) -> TrainLayout:
    """The shapes, specs, plan and per-device argument bytes of ``arch``'s
    training step on ``mesh_shape`` (``lower_train``'s, with no compile)."""
    mesh = dict(mesh_shape)
    cfg = cfglib.get_config(arch).replace(dtype="bfloat16")
    if arch in ATTN_BLOCK:
        cfg = cfg.replace(attn_block=ATTN_BLOCK[arch])
    cfg = _apply_overrides(cfg)
    seq, global_batch, _ = cfglib.INPUT_SHAPES[shape_name]
    return layout_of(cfg, dist or arch_dist_config(arch, mesh), mesh,
                     global_batch, seq)


def layout_of(cfg, dist: td.DistConfig, mesh_shape: Mapping[str, int],
              global_batch: int, seq: int) -> TrainLayout:
    """:func:`train_layout` of a given config, ``DistConfig`` and batch:
    ``global_batch`` rows of ``seq`` tokens over the dp axes of
    ``mesh_shape``."""
    mesh = dict(mesh_shape)
    dp = tuple(dist.dp_axes)
    W = math.prod(mesh[a] for a in dp)
    rows = max(1, global_batch // W)
    if dist.microbatches > rows:
        dist = dataclasses.replace(dist, microbatches=rows)
    params = get_family(cfg).init(cfg, device="meta")
    axes = param_axes(cfg)
    specs = tree_specs(params, axes, mesh, dist.rules, dp)
    plan = td.build_plan(params, dist.sparsifier.sparsity, dist, axes=axes,
                         mesh=mesh)
    opt_state = make_optimizer(dist.optimizer).init(params)
    mom_specs = zero1_specs(params, specs, mesh, dp)
    state = sparsifier_state_shapes(plan, W, mesh, dp,
                                    dist.resolved_state_dtype())
    batch_specs = input_specs(cfg, global_batch, seq, kind="train")
    dp_spec = dp if len(dp) > 1 else dp[0]
    moments = [k for k in opt_state if k != "step"]
    argument_bytes = {
        "params": sum(_nbytes(p.shape, p.dtype, s, mesh) for p, s in zip(
            tree_leaves(params), tree_leaves(specs), strict=True)),
        "optimizer": opt_state["step"].element_size() + sum(
            _nbytes(m.shape, m.dtype, s, mesh)
            for k in moments for m, s in zip(
                tree_leaves(opt_state[k]), tree_leaves(mom_specs), strict=True)),
        "sparsifier": sum(_nbytes(shape, dt, spec, mesh)
                          for leaf in tree_leaves(state)
                          for shape, dt, spec in leaf),
        "batch": sum(_nbytes(s, d, (dp_spec,), mesh)
                     for s, d in batch_specs.values()),
    }
    return TrainLayout(cfg, dist, mesh, W, rows, seq, params, specs, plan,
                       opt_state, mom_specs, state, batch_specs,
                       argument_bytes)


def train_collectives(lay: TrainLayout, traffic=None):
    """``(collective_bytes, rank_collective_bytes)``: what one step's
    collectives return on one rank of the sharded layout and of the
    port's trainer (the module docstring); ``traffic``, the model group's
    activation collectives of a tensor-parallel step
    (``ModelShard.traffic``), replaces the aggregates' gather."""
    dist, mesh = lay.dist, lay.mesh
    dp_sizes = [mesh[a] for a in dist.dp_axes]
    word = dist.resolved_state_dtype().itemsize
    wire = {"all-gather": 0.0, "all-reduce": 0.0}
    zero1 = model = 0.0
    for p, mspec in zip(tree_leaves(lay.plan), tree_leaves(lay.mom_specs),
                        strict=True):
        codec, coll = td.leaf_wire(p, dist)
        if dist.sparsifier.kind == "none" or coll == "dense_allreduce":
            dense = 4 if dist.sparsifier.kind == "none" else word
            wire["all-reduce"] += p.local_len * dense
        else:
            payload = td._payload_bytes(get_codec(codec), p.local_len, p.k)
            if coll == "hierarchical":  # payloads over the outer axes
                wire["all-gather"] += math.prod(dp_sizes[:-1]) * payload
                wire["all-reduce"] += p.local_len * 4
            else:
                wire["all-gather"] += lay.W * payload
        if mspec != p.spec:  # its update, sharded over dp, gathered in f32
            zero1 += p.local_len * 4
        if td.split_dim(p) is not None:
            model += p.shards * p.local_len * word
    world = lay.W * math.prod(v for a, v in mesh.items()
                              if a not in dist.dp_axes)
    sharded = {"all-gather": wire["all-gather"] + zero1,
               "all-reduce": wire["all-reduce"] + 4}  # and the loss mean
    rank = {"all-gather": wire["all-gather"] + 4 * world,  # and the losses
            "all-reduce": wire["all-reduce"]}
    if traffic is not None:
        rank["all-reduce:model"] = float(traffic["all-reduce"])
        rank["all-gather:model"] = float(traffic["all-gather"])
    elif model:
        rank["all-gather:model"] = model
    for out in (sharded, rank):
        out["total"] = sum(out.values())
    return sharded, rank


def _rank_step(lay: TrainLayout, shard=None):
    """``step(params, opt_state, rows, batch)``: one rank's training step
    as the port's trainer runs it across ranks (``make_train_step(...,
    mesh=)``), its dp collectives left out: the worker's gradient, the
    round of the rank's (worker, shard) block with this rank's payload
    alone (``_spa_leaf``), then Adam. Under a ``shard`` (a
    ``ModelShard`` without a group, which counts the model group's
    collectives) the params and Adam state are the rank's blocks, each
    block's gradient its row and its aggregate local; otherwise the split
    leaves' aggregates are put back whole (the model group's gather) and
    Adam runs on the whole parameters."""
    dist, plan_flat = lay.dist, tree_leaves(lay.plan)
    grads_fn = td.make_worker_grads(lay.cfg, dist, shard)
    opt = make_optimizer(dist.optimizer)
    acc_dt = dist.resolved_state_dtype()
    scfg = dataclasses.replace(dist.sparsifier, omega=1.0 / lay.W)
    coord = dist.resolved_weighting() == "coordinate"
    wires = [td.leaf_wire(p, dist) for p in plan_flat]

    def step(params, opt_state, rows, batch):
        loss, grads = grads_fn(params, batch)
        aggs, new_rows = [], []
        for g, st, p, (cname, sname) in zip(grads, tree_leaves(rows),
                                            plan_flat, wires, strict=True):
            block = (g.to(acc_dt).reshape(1, p.local_len) if shard is not None
                     else td.shard_blocks(g.to(acc_dt)[None], p, 0))
            agg, new = td._spa_leaf(block, st, p, scfg, get_codec(cname),
                                    get_collective(sname), coord, None)
            if shard is not None:
                aggs.append(agg[0].reshape(p.local_shape))
            elif td.split_dim(p) is None:
                aggs.append(agg[0].reshape(p.global_shape))
            else:
                aggs.append(td.merge_blocks(agg.repeat(p.shards, 1), p)[0])
            new_rows.append(new)
        new_params, new_opt = opt.update(tree_unflatten(params, aggs),
                                         opt_state, params)
        return new_params, new_opt, new_rows, loss

    return step


def _record(arch, shape_name, mesh, kind, tag, lower_s, cost, argument,
            resident, rank_bytes, collectives, rank_collectives,
            count_s) -> Dict[str, Any]:
    """``resident``: the bytes the rank holds before the step."""
    peak = resident + cost["peak_bytes"]
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "x".join(str(v) for v in mesh.values()),
        "kind": kind,
        "tag": tag,
        "lower_s": round(lower_s, 1),
        "compile_s": None,
        "mem": {"argument_bytes": argument, "output_bytes": None,
                "temp_bytes": None, "peak_bytes": peak},
        "flops": cost["flops"],
        "hbm_bytes": cost["hbm_bytes"],
        "xla_flops_looponce": None,
        "collective_bytes": collectives,
        "rank_bytes": rank_bytes,
        "rank_collective_bytes": rank_collectives,
        "fits": peak <= meshlib.HBM_BYTES,
        "count_s": round(count_s, 1),
        "flops_by_op": cost["flops_by_op"],
    }


def count_train(arch: str, shape_name: str, mesh_shape: Mapping[str, int],
                dist: Optional[td.DistConfig] = None, tag: str = ""):
    """The record of ``arch``'s training step on one rank of
    ``mesh_shape`` (the counterpart of ``lower_train`` and the JAX
    ``run_combo``'s record)."""
    t0 = time.perf_counter()
    lay = train_layout(arch, shape_name, mesh_shape, dist)
    lower_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    c = count_layout(lay)
    return _record(arch, shape_name, lay.mesh, "train", tag, lower_s, c["cost"],
                   sum(lay.argument_bytes.values()), c["resident"],
                   c["rank_bytes"], *c["collectives"], time.perf_counter() - t0)


def count_layout(lay: TrainLayout) -> Dict[str, Any]:
    """One rank's training step on ``lay`` traced on the meta device, as
    the port's trainer runs it across ranks (tensor parallel where
    ``core.distributed.model_shard`` says so): ``cost``
    (``op_cost.analyze``), ``resident`` (the bytes the rank holds before
    the step), ``rank_bytes`` (and one gradient) and ``collectives``
    (``train_collectives``)."""
    rows = td.init_sparsifier_state(
        lay.plan, 1, "meta", lay.dist.resolved_state_dtype(), shards=1)
    batch = _meta_batch(input_specs(lay.cfg, lay.rows, lay.seq, kind="train"))
    params, opt_state = lay.params, lay.opt_state
    shard = td.model_shard(lay.cfg, lay.plan, None, 0)
    if shard is not None:  # the rank's blocks, as the trainer holds them
        specs = tree_map(lambda p: p.spec, lay.plan)

        def cut(tree):
            return shard_params(tree, specs, 0, shard.size)

        params = cut(params)
        opt_state = {k: v if k == "step" else cut(v)
                     for k, v in opt_state.items()}
    resident = (_tree_bytes(params) + _tree_bytes(opt_state)
                + _tree_bytes(rows) + _tree_bytes(batch))
    grad = (sum(p.numel() for p in tree_leaves(params))
            * lay.dist.resolved_state_dtype().itemsize)
    cost = op_cost.analyze(_rank_step(lay, shard), params, opt_state, rows,
                           batch)
    return {"cost": cost, "resident": resident, "rank_bytes": resident + grad,
            "collectives": train_collectives(
                lay, None if shard is None else shard.traffic)}


def count_serve(arch: str, shape_name: str, mesh_shape: Mapping[str, int],
                tag: str = ""):
    """The record of one prefill or decode step of ``arch`` on one rank
    of ``mesh_shape`` (the counterpart of ``lower_serve``; the count is
    :func:`serve_count`'s)."""
    t0 = time.perf_counter()
    cfg = _apply_overrides(cfglib.get_config(arch).replace(dtype="bfloat16"))
    seq, global_batch, kind = cfglib.INPUT_SHAPES[shape_name]
    c = serve_count(cfg, kind, seq, global_batch, mesh_shape)
    return _record(arch, shape_name, dict(mesh_shape), kind, tag, c["lower_s"],
                   c["cost"], c["argument_bytes"], c["rank_bytes"],
                   c["rank_bytes"], {"total": 0.0}, c["rank_collective_bytes"],
                   time.perf_counter() - t0 - c["lower_s"])


def serve_count(cfg, kind: str, seq: int, global_batch: int,
                mesh_shape: Mapping[str, int]) -> Dict[str, Any]:
    """One prefill (``kind`` "prefill": ``global_batch`` prompts of ``seq``
    tokens) or decode step (a cache of ``seq`` steps) of ``cfg`` on one
    rank of ``mesh_shape``, traced on the meta device: the batch split
    over the dp axes where they divide it, else whole on every rank; the
    parameters and the cache laid out by ``nn.sharding.serve_rules``,
    and, for a family of ``models.serve_parallel``, the step run on the
    rank's blocks. ``argument_bytes`` (every argument's block under its
    spec), ``params_bytes``, ``cache_bytes`` and ``rank_bytes`` (what the
    rank holds: its parameters, its cache block or prompt rows and its
    tokens), ``cost`` (``op_cost.analyze``), ``rank_collective_bytes``
    and ``lower_s``."""
    t0 = time.perf_counter()
    mesh = dict(mesh_shape)
    mod = get_family(cfg)
    dp = meshlib.dp_axes_of(mesh)
    params = mod.init(cfg, device="meta")
    specs, cache_specs, shard = serve_layout(cfg, params, global_batch, seq,
                                             mesh, dp)
    argument = sum(_nbytes(p.shape, p.dtype, s, mesh) for p, s in zip(
        tree_leaves(params), tree_leaves(specs), strict=True))
    dp_total = math.prod(mesh[a] for a in dp)
    split = global_batch % dp_total == 0
    b_spec = ((dp if len(dp) > 1 else dp[0]),) if split else (None,)
    rows = global_batch // dp_total if split else global_batch
    kw = {}
    if shard is not None:
        params = shard_params(params, specs, 0, shard.size)
        kw = {"shard": shard}
    if kind == "prefill":
        batch_specs = input_specs(cfg, global_batch, seq, kind="train")
        batch_specs.pop("labels")
        argument += sum(_nbytes(s, d, b_spec, mesh)
                        for s, d in batch_specs.values())
        inputs = _meta_batch(input_specs(cfg, rows, seq, kind="train"))
        inputs.pop("labels")
        fn, args = mod.prefill, (params, cfg, inputs)
    else:
        cache = mod.init_cache(cfg, global_batch, seq, device="meta")
        argument += sum(_nbytes(c.shape, c.dtype, s, mesh) for c, s in zip(
            tree_leaves(cache), tree_leaves(cache_specs), strict=True))
        (tok_shape, tok_dt), = input_specs(cfg, global_batch, seq,
                                           kind="decode").values()
        argument += _nbytes(tok_shape, tok_dt, b_spec, mesh)
        cache = mod.init_cache(cfg, rows, seq, device="meta", **kw)
        inputs = {"cache": cache, "tokens": torch.empty(
            (rows, 1), dtype=tok_dt, device="meta")}
        fn, args = mod.decode_step, (params, cfg, cache, inputs["tokens"])
    lower_s = time.perf_counter() - t0
    cost = op_cost.analyze(fn, *args, **kw)
    rank_coll = {"total": 0.0}
    if shard is not None:
        rank_coll = {"all-reduce:model": float(shard.traffic["all-reduce"]),
                     "all-gather:model": float(shard.traffic["all-gather"])}
        rank_coll["total"] = sum(rank_coll.values())
    return {"argument_bytes": argument, "params_bytes": _tree_bytes(params),
            "cache_bytes": _tree_bytes(inputs.get("cache", {})),
            "rank_bytes": _tree_bytes(params) + _tree_bytes(inputs),
            "cost": cost, "rank_collective_bytes": rank_coll,
            "lower_s": lower_s}


def run_combo(arch: str, shape_name: str, *, multi_pod: bool,
              dist: Optional[td.DistConfig] = None, tag: str = ""):
    """One combo's record on the production layout."""
    mesh = meshlib.production_shape(multi_pod)
    if cfglib.INPUT_SHAPES[shape_name][2] == "train":
        return count_train(arch, shape_name, mesh, dist, tag)
    return count_serve(arch, shape_name, mesh, tag)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--aggregation", default="sparse_allgather")
    ap.add_argument("--sparsifier", default="regtopk")
    ap.add_argument("--sparsity", type=float, default=0.001)
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--cfg", action="append", default=[],
                    help="model-config override key=value (repeatable)")
    args = ap.parse_args(argv)
    for item in args.cfg:
        k, v = item.split("=", 1)
        CFG_OVERRIDES[k] = v

    archs = ([a for a in cfglib.ARCHS if a != "paper-resnet-proxy"]
             if args.arch == "all" else [args.arch])
    shapes = list(cfglib.INPUT_SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)

    done = set()
    if os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done.add((r["arch"], r["shape"], r["mesh"], r.get("tag", "")))
                except (ValueError, KeyError):
                    pass

    n_fail = 0
    for multi in meshes:
        mesh_name = "x".join(str(v) for v in
                             meshlib.production_shape(multi).values())
        for arch in archs:
            for shape in shapes:
                if not cfglib.shape_applicable(arch, shape):
                    print(f"SKIP  {arch} x {shape} (no bounded-memory "
                          "long-context decode)", flush=True)
                    continue
                if (arch, shape, mesh_name, args.tag) in done:
                    print(f"CACHED {arch} x {shape} x {mesh_name}", flush=True)
                    continue
                try:
                    dist = None
                    if args.tag:
                        dist = arch_dist_config(
                            arch, meshlib.production_shape(multi),
                            sparsity=args.sparsity,
                            aggregation=args.aggregation, kind=args.sparsifier)
                    rec = run_combo(arch, shape, multi_pod=multi, dist=dist,
                                    tag=args.tag)
                    with open(args.out, "a") as f:
                        f.write(json.dumps(rec) + "\n")
                    peak = rec["mem"]["peak_bytes"]
                    print(
                        f"OK    {arch} x {shape} x {mesh_name}: "
                        f"peak={peak / 2**30:.2f}GiB "
                        f"flops={rec['flops']:.3e} "
                        f"coll={rec['collective_bytes']['total']:.3e}B "
                        f"(lower {rec['lower_s']}s count {rec['count_s']}s)",
                        flush=True,
                    )
                except Exception as e:  # noqa: BLE001 (one combo's failure)
                    n_fail += 1
                    print(f"FAIL  {arch} x {shape} x {mesh_name}: {e}",
                          flush=True)
                    if not (isinstance(e, ValueError)
                            and "MAX_WIRE_LEN" in str(e)):
                        traceback.print_exc()
    print(f"dry-run complete; {n_fail} failures", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
