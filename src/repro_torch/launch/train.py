"""Training launcher for the port (counterpart of ``repro.launch.train``).

    python -m repro_torch.launch.train --arch paper-resnet-proxy \
        --workers 8 --steps 10 --sparsifier regtopk --fastpath on

``--arch`` takes every config of ``repro_torch.configs.ARCHS``: the
paper's proxy, the dense, MoE and VLM decoders (``qwen2.5-3b``,
``chatglm3-6b``, ``granite-3-8b``, ``granite-3-8b-swa``,
``phi3-medium-14b``, ``mixtral-8x7b``, ``deepseek-moe-16b``,
``internvl2-1b``), the encoder-decoder ``whisper-tiny``, the state-space
``mamba2-780m`` and the hybrid ``zamba2-7b``; ``--smoke`` takes its
``smoke_variant()``.

``--workers N`` is the counterpart of the JAX trainer's host-mesh device
count: on one card N logical devices, one dp mesh axis named ``data``
(what ``--link-topo`` names). ``--model-parallel M`` lays them out as the
JAX host mesh ``(data, model) = (N/M, M)``: W = N/M workers, each
gradient split into M model shards with a RegTop-k round each (the
specs of ``nn.sharding`` on the family's ``param_axes``; the forward,
the parameters and Adam stay whole). The first line printed is the mesh
and its dp axes. Runs on ``cuda`` unless ``--device cpu`` is given.

Under ``torchrun`` (``WORLD_SIZE`` set) each rank is one (worker, model
shard), W = world / M, the counterpart of the JAX trainer's ``shard_map``
over its mesh (``repro_torch.launch.mesh``; ranks row-major with the
model axis fastest):

    torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \
        --smoke --steps 3 --device cpu

With a model axis M > 1 across ranks, every config trains tensor
parallel: each rank holds, computes and updates its model shard's block
of every leaf that ``nn.sharding`` splits
(``core.distributed.make_train_step``; the MoE experts' width or the
experts themselves, as ``moe_parallelism`` lays them out; the SSD
mixer's channels and heads; the encoder-decoder's encoder, self- and
cross-attention and MLPs). A line after the mesh's names the path the
model axis takes. ``--checkpoint`` gathers each leaf whole before it
writes and ``--resume`` cuts the blocks out again, so a checkpoint moves
between ranks and one process either way.

``--device cuda`` puts rank r on ``cuda:LOCAL_RANK`` over ``nccl``; an
explicit ``cuda:i`` is taken as given; ``--device cpu`` runs over
``gloo``. ``--backend gloo --device cuda:0`` is the explicit way to run
several ranks on one card (``nccl`` refuses that with its own error).
``--multi-pod`` lays the ranks out as ``("pod", "data", "model") = (2,
world/(2M), M)`` (the port's own host layout; the JAX host mesh has no
pod axis), and ``--link-topo`` then prices both dp axes. ``--mesh
production`` is ``(data, model) = (16, 16)``, or ``(2, 16, 16)`` with
``--multi-pod``: 256 or 512 ranks under ``torchrun``, refused otherwise
(and on one card). A layout the ranks or ``--workers`` cannot fill is
refused before anything is allocated. Only rank 0 prints.

``--participation`` (a straggler schedule: ``round_robin:2``,
``bernoulli:0.25``, ``sampled:4``) and ``--adaptive-k`` (the controller's
``budget[,k_min,k_max]``) work on one card and under ``torchrun``, as in
the JAX trainer; ``stale`` is refused (it needs the simulator's pending
buffer), and the step line gains the mean per-leaf k under
``--adaptive-k``.

The planners, as in the JAX trainer: ``--codec auto`` / ``--collective
auto`` pick each leaf's wire with the alpha–beta planner (the picks are
printed); ``--calibrate`` fits the link model from collectives timed
across the ranks (one model per dp axis under ``--multi-pod``; rank 0's
fit on every rank; skipped in one process, which has no process group
and so no wire to probe); ``--overlap buckets:B`` runs the leaves bucket
by bucket with the numbers of ``off``; ``--replan-every N`` calibrates on
the live groups every N steps, re-plans at the current k and rebuilds the
step, its state carried over.

``--microbatches N`` accumulates each worker's gradient over N chunks of
its shard; ``--aggregation`` is ``--collective``'s older name, used when
``--collective`` is not given. ``--checkpoint DIR`` saves params (with
the step reached), optimizer and sparsifier state after the last step in
the JAX trainer's format and layout (``repro_torch.checkpoint``; ``sent_*
[W, M, k]``; across ranks rank 0 writes every (worker, shard)'s state),
and ``--resume DIR`` runs
``--steps`` more steps from such a checkpoint, written by either trainer.
``DistConfig.state_dtype`` and the optimizer have no flag, as in the JAX
trainer: ``run(args, dist=...)`` takes them.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import time
from collections import Counter
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.distributed as torch_dist

from repro_torch import checkpoint as ckpt
from repro_torch import configs as cfglib
from repro_torch import convert
from repro_torch.comm import autotune, cost
from repro_torch.comm import calibrate as cal
from repro_torch.comm.codec import CODECS
from repro_torch.comm.collectives import COLLECTIVES, _gather
from repro_torch.comm.controller import parse_adaptive_k
from repro_torch.comm.fastpath import (
    FastpathCounts,
    ThroughputTable,
    backend_supports,
)
from repro_torch.comm.participation import parse_participation
from repro_torch.core.compact import CompactState, select_rows
from repro_torch.core.distributed import (
    DistConfig,
    apply_plan_decisions,
    build_plan,
    comm_round_bytes,
    comm_round_cost,
    comm_round_timeline,
    init_controller_state,
    init_sparsifier_state,
    leaf_wire,
    make_train_step,
    model_shard,
    plan_fastpath,
    split_dim,
)
from repro_torch.core.sparsify import SparsifierConfig
from repro_torch.data import TokenPipeline
from repro_torch.launch.mesh import (
    DpGroups,
    check_world,
    dp_axes_of,
    host_shape,
    make_host_groups,
    make_production_groups,
    production_shape,
)
from repro_torch.models import get_family, param_axes
from repro_torch.nn.sharding import shard_params, unshard_params
from repro_torch.optim import OptConfig, make_optimizer
from repro_torch.tree import tree_leaves, tree_map


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-resnet-proxy")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--sparsifier", default="regtopk",
                    choices=["none", "topk", "regtopk", "cyclic"])
    ap.add_argument("--sparsity", type=float, default=0.01)
    ap.add_argument("--mu", type=float, default=1.0)
    ap.add_argument("--codec", default="coo_fp32",
                    choices=[*sorted(CODECS), "auto"],
                    help="'auto' plans each leaf's codec by the alpha-beta "
                         "model")
    ap.add_argument("--aggregation", default="sparse_allgather",
                    help="older name of --collective, used when "
                         "--collective is not given")
    ap.add_argument("--collective", default=None,
                    choices=[*sorted(COLLECTIVES), "auto"],
                    help="'auto' plans each leaf's collective by the "
                         "alpha-beta model (default: --aggregation)")
    ap.add_argument("--fastpath", default="off", choices=["off", "on", "auto"],
                    help="'on' fuses every fusable leaf through the CUDA "
                         "select->encode kernel (same payload, with a "
                         "per-worker exactness fallback); 'auto' fuses the "
                         "leaves the throughput table prices faster, on "
                         "the card only; 'off' is dense selection")
    ap.add_argument("--coord-weights", action="store_true",
                    help="per-coordinate aggregation weights: divide each "
                         "coordinate by the mass of the workers that sent "
                         "it (weighting='coordinate'; RegTop-k then stays "
                         "off the fastpath)")
    ap.add_argument("--link-topo", default=None, metavar="SPEC",
                    help="link model of the dp axes that prices the comm "
                         "line: 'data:alpha,beta' or a bare 'alpha,beta' "
                         "(seconds per message, per byte); under "
                         "--multi-pod 'pod:a,b;data:a,b'")
    ap.add_argument("--calibrate", action="store_true",
                    help="fit the alpha-beta link model from collectives "
                         "timed across the ranks before planning (one per "
                         "dp axis under --multi-pod; ignored when "
                         "--link-topo is given; skipped in one process)")
    ap.add_argument("--overlap", default="off", metavar="SPEC",
                    help="bucketed overlap schedule: 'off' or 'buckets:B', "
                         "the leaves run in B size-balanced buckets (the "
                         "numbers of 'off', bit for bit; the metrics gain "
                         "the predicted per-bucket 'timeline' stamps)")
    ap.add_argument("--replan-every", type=int, default=0, metavar="N",
                    help="every N steps, re-fit the link model from "
                         "collectives timed on the live groups and re-plan "
                         "each leaf's codec/collective at the current k "
                         "(0 disables)")
    ap.add_argument("--participation", default=None, metavar="SPEC",
                    help="partial-participation schedule over the dp "
                         "workers: 'full' (default), "
                         "'bernoulli:drop_rate[,seed]', "
                         "'round_robin:n_stragglers' or 'sampled:S[,seed]'; "
                         "dropped workers keep their payload in the error "
                         "accumulator and the round aggregates with "
                         "renormalized weights ('stale:...' is "
                         "simulator-only)")
    ap.add_argument("--adaptive-k", default=None, metavar="SPEC",
                    help="error-budget-driven per-round k: "
                         "'budget[,k_min,k_max]'; bounds in (0,1) are "
                         "fractions of the leaf length, >= 1 counts; the "
                         "payload rides at the k_max capacity")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1,
                    help="split each worker's shard into this many "
                         "microbatches and accumulate their gradients")
    ap.add_argument("--checkpoint", default=None, metavar="DIR",
                    help="after the last step, save params, optimizer and "
                         "sparsifier state under DIR (the JAX trainer's "
                         "format and layout)")
    ap.add_argument("--resume", default=None, metavar="DIR",
                    help="start from the checkpoint in DIR (written by "
                         "either trainer) and run --steps more steps")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke variant of --arch")
    ap.add_argument("--workers", type=int, default=1,
                    help="logical devices on the card (the JAX trainer's "
                         "host-mesh device count): W = workers / "
                         "--model-parallel data-parallel workers")
    ap.add_argument("--mesh", default="host", choices=["host", "production"],
                    help="'host': (data, model) = (devices / M, M); "
                         "'production': (16, 16), or (2, 16, 16) with "
                         "--multi-pod, on 256 or 512 ranks under torchrun")
    ap.add_argument("--model-parallel", type=int, default=1, metavar="M",
                    help="the model axis of the host mesh: each gradient "
                         "splits into M shards, one RegTop-k round each")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (under torchrun: cuda:LOCAL_RANK), "
                         "'cuda:i' or 'cpu'")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="torch.distributed backend under torchrun (default "
                         "nccl on the card, gloo on the CPU)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="under torchrun: ('pod', 'data', 'model') = "
                         "(2, world / (2M), M); with --mesh production "
                         "(2, 16, 16)")
    return ap.parse_args(argv)


class RunResult(NamedTuple):
    losses: List[float]
    params: dict
    sp_state: dict
    counts: FastpathCounts
    plan: dict
    dist: DistConfig  # with the link model --calibrate fitted
    opt_state: dict


def dist_config(args: argparse.Namespace,
                link_topo: Optional[cost.LinkTopo] = None,
                link_model: Optional[cost.AlphaBeta] = None) -> DistConfig:
    """The ``DistConfig`` that the flags describe, with the link model of
    ``--link-topo`` or ``--calibrate``."""
    return DistConfig(
        participation=(parse_participation(args.participation)
                       if args.participation else None),
        adaptive_k=(parse_adaptive_k(args.adaptive_k)
                    if args.adaptive_k else None),
        sparsifier=SparsifierConfig(
            kind=args.sparsifier, sparsity=args.sparsity, mu=args.mu
        ),
        optimizer=OptConfig(kind="adam", learning_rate=args.lr),
        aggregation=args.aggregation,
        codec=args.codec,
        collective=args.collective,
        microbatches=args.microbatches,
        fastpath=args.fastpath,
        weighting="coordinate" if args.coord_weights else "worker",
        link_topo=link_topo,
        link_model=link_model,
        overlap=args.overlap,
    )


def layout(args: argparse.Namespace,
           mesh: Optional[DpGroups] = None) -> Dict[str, int]:
    """The ``{axis: size}`` mesh the flags describe (``launch.mesh``): on
    one card the host mesh of ``--workers`` devices with ``--model-parallel``
    as its model axis; across ranks ``mesh``'s. Raises ``SystemExit``, with
    a message, for a layout that cannot be built: ``--mesh production`` or
    ``--multi-pod`` on one card, an M that does not divide the devices,
    ``--workers`` other than 1 or the world size under ``torchrun``."""
    if mesh is not None:
        world = mesh.size * mesh.model
        if args.workers not in (1, world):
            raise SystemExit(
                f"--workers {args.workers}: under torchrun the devices are "
                f"the world's {world} ranks"
            )
        if args.mesh == "host" and args.model_parallel != mesh.model:
            raise SystemExit(
                f"--model-parallel {args.model_parallel}, but the ranks are "
                f"laid out with a model axis of {mesh.model}"
            )
        return mesh.mesh_shape
    if args.mesh == "production":
        raise SystemExit(
            "--mesh production needs 256 ranks ((data, model) = (16, 16)), "
            "or 512 with --multi-pod: run it under torchrun with that many "
            "ranks"
        )
    if args.multi_pod:
        raise SystemExit("--multi-pod lays out ranks: run under torchrun")
    try:
        return host_shape(args.workers, args.model_parallel)
    except ValueError as e:
        raise SystemExit(str(e)) from None


def _say(mesh: Optional[DpGroups]):
    """``print`` on one card and on rank 0; a no-op on the other ranks."""
    if mesh is None or mesh.row == 0:
        return lambda msg: print(msg, flush=True)
    return lambda msg: None


def run(args: argparse.Namespace, dist: Optional[DistConfig] = None,
        table: Optional[ThroughputTable] = None,
        mesh: Optional[DpGroups] = None) -> RunResult:
    """Train for ``args.steps`` steps, logging as the JAX trainer does.
    ``dist`` replaces the ``DistConfig`` the flags describe, for what the
    CLI has no flag for (as the JAX trainer has none for the selector:
    ``SparsifierConfig(selector="threshold")``). ``table`` prices
    ``--fastpath auto`` (``ThroughputTable()``'s defaults when None).

    ``mesh`` (the dp process groups of an initialised process group)
    makes this rank one worker of W = ``mesh.size``: it returns the
    common params and losses (the params and optimizer state whole, also
    where the rank trained its blocks of them), and its own worker's
    state and counts.
    Under ``--fastpath auto`` rank 0's table (``ThroughputTable.measure``
    on the card when none is given) is broadcast, and ``--calibrate`` and
    ``--replan-every`` fit rank 0's samples, so every rank builds one
    plan. ``RunResult.plan`` is the last plan the run stepped with."""
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {args.device} requested but CUDA is not available"
        )
    say = _say(mesh)
    shape = layout(args, mesh)
    axes = dp_axes_of(shape)
    dp_sizes = tuple(shape[a] for a in axes)
    W = math.prod(dp_sizes)
    say(f"mesh: {shape}, dp axes {axes}")
    cfg = cfglib.get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke_variant()
    if args.global_batch % W:
        raise SystemExit(f"--global-batch must be divisible by {W} workers")
    link_topo = link_model = None
    if args.link_topo:
        link_topo = cost.parse_link_topo(args.link_topo, axes)
        for axis, lk in zip(axes, link_topo.links, strict=True):
            say(f"link-topo {axis}: alpha={lk.alpha:.3e} s/msg "
                f"beta={lk.beta:.3e} s/B")
        if args.calibrate:
            say("--link-topo given; skipping --calibrate")
    elif args.calibrate:
        link_topo, link_model = _calibrate(mesh, axes, args.device, say)
    # the layout's dp axes are the ones the workers span
    dist = dataclasses.replace(dist or dist_config(args, link_topo, link_model),
                               dp_axes=axes)
    part = dist.participation
    if part is not None:
        part.validate(W)
        if not part.is_full:
            say(f"participation: {part.kind} — expected "
                f"{part.expected_participants(W):.2f}/{W} workers on time "
                "per round (renormalized weights)")
    ctrl = dist.adaptive_k
    if ctrl is not None:
        say(f"adaptive-k: budget={ctrl.budget:g} "
            f"bounds=[{ctrl.k_min:g}, {ctrl.k_max:g}] "
            f"momentum={ctrl.momentum:g} hysteresis={ctrl.hysteresis:g}")
    if dist.weighting == "coordinate":
        say("weighting: coordinate — per-coordinate renormalization over "
            "the workers that sent each coordinate")
    if dist.fastpath != "off":
        say(f"fastpath: {dist.fastpath} (resolved "
            f"{dist.resolved_fastpath()}) — fused select->encode on "
            "fusable leaves")
    if mesh is not None:
        say(f"ranks: {W * mesh.model} over {torch_dist.get_backend()}, dp "
            f"axes {dict(zip(axes, mesh.shape, strict=True))}, rank 0 on "
            f"{args.device}")
        if dist.resolved_fastpath() == "auto":
            if (mesh.row == 0 and table is None
                    and backend_supports(args.device)):
                table = ThroughputTable.measure(device=args.device)
            shared = [table]
            torch_dist.broadcast_object_list(shared, src=0)
            table = shared[0]
    params = get_family(cfg).init(cfg, seed=0, device=args.device)
    plan = build_plan(params, dist.sparsifier.sparsity, dist, table, dp_sizes,
                      axes=param_axes(cfg), mesh=shape)
    shard = None if mesh is None else model_shard(cfg, plan, mesh.model_group,
                                                  mesh.shard)
    M = tree_leaves(plan)[0].shards
    if M > 1:
        say(_model_axis_line(cfg, plan, mesh, shard))
    counts = FastpathCounts()
    step_fn = make_train_step(cfg, dist, plan, W, counts, mesh)
    opt_state = make_optimizer(dist.optimizer).init(params)
    sp_state = init_sparsifier_state(
        plan, W if mesh is None else 1, args.device,
        dist.resolved_state_dtype(), None if mesh is None else 1,
    )
    if ctrl is not None:
        sp_state = (sp_state, init_controller_state(plan, dist, args.device))
    start = 0
    if args.resume:
        params, opt_state, sp_state, start = _resume(
            args.resume, params, opt_state, sp_state, plan, W, mesh)
        say(f"resumed from step {start}")
    if shard is not None:  # the rank's blocks; the whole trees let go
        specs = tree_map(lambda p: p.spec, plan)

        def cut(tree):
            return shard_params(tree, specs, mesh.shard, M)

        params, opt_state = cut(params), _moments(opt_state, cut)
    pipe = TokenPipeline(cfg, args.global_batch, args.seq, 0, args.device)
    pred_b, meas_b = comm_round_bytes(plan, dist, dp_sizes)
    round_cost = comm_round_cost(plan, dist, dp_sizes)
    say(
        f"comm: codec={dist.codec} collective={dist.resolved_collective()} "
        f"{meas_b / 1e6:.3f} MB/worker/round "
        f"(predicted {pred_b / 1e6:.3f} MB, "
        f"{round_cost.seconds * 1e3:.3f} ms/round under the link model)"
    )
    if dist.resolved_overlap() is not None:
        bplan, tline = comm_round_timeline(plan, dist, dp_sizes)
        say(f"comm:   overlap {bplan.n_buckets} buckets ({dist.overlap}): "
            f"{tline.sync_seconds * 1e3:.3f} ms sync -> "
            f"{tline.seconds * 1e3:.3f} ms overlapped")
    if dist.auto:
        for (c, s), n in _picks(plan, dist):
            say(f"comm:   auto-plan {c}/{s}: {n} leaves")
    leaves = tree_leaves(plan)
    if dist.resolved_fastpath() != "off":
        say(f"comm:   fastpath: {sum(p.fused for p in leaves)}/{len(leaves)} "
            "leaves fused")

    def replan_step(t: int, plan):
        """``--replan-every``: calibrate on the live groups (rank 0's fit
        on every rank), re-plan each leaf's wire at the k being sent, and
        rebuild the step on the regrafted plan; capacities, and so every
        state, carry over, and ``counts`` goes on counting."""
        res = cal.calibrate(mesh, None if mesh is None else axes,
                            device=args.device)
        if not res.calibrated:
            say(f"replan @step {t + 1}: skipped (no dp axis with >1 worker)")
            return plan, step_fn
        part = dist.resolved_participation()
        cp = autotune.replan(
            plan, [W] if mesh is None else list(mesh.shape), res.samples,
            k_overrides=(None if ctrl is None else
                         tree_map(lambda c: int(c.k), sp_state[1])),
            participants=(None if part is None
                          else part.expected_participants(W)),
            fastpath=plan_fastpath(dist, args.device), compute=table,
            **autotune.auto_candidates(dist.sparsifier.kind, dist.codec,
                                       dist.resolved_collective()),
        )
        new_plan = apply_plan_decisions(plan, cp)
        lk = cp.model.links[0]
        say(f"replan @step {t + 1}: alpha={lk.alpha:.3e} s/msg "
            f"beta={lk.beta:.3e} s/B -> {cp.total_seconds * 1e3:.3f} "
            "ms/round predicted")
        for (c, s), n in _picks(new_plan, dist):
            say(f"replan:   {c}/{s}: {n} leaves")
        return new_plan, make_train_step(cfg, dist, new_plan, W, counts, mesh)

    losses = []
    t0 = time.time()
    end = start + args.steps
    for t in range(start, end):
        params, opt_state, sp_state, m = step_fn(
            params, opt_state, sp_state, pipe.batch_at(t)
        )
        losses.append(float(m["loss"]))
        if t % args.log_every == 0 or t == end - 1:
            dt = time.time() - t0
            extra = (f" k {float(m['adaptive_k']):7.1f}"
                     if "adaptive_k" in m else "")
            say(f"step {t:5d} loss {losses[-1]:.4f}{extra} "
                f"({dt / (t - start + 1):.2f}s/step)")
        if (args.replan_every and t < end - 1
                and (t - start + 1) % args.replan_every == 0):
            plan, step_fn = replan_step(t, plan)
    if counts.rounds:
        say(f"fastpath: certificate hit rate {counts.hit_rate:.4f} "
            f"({counts.rounds - counts.fallbacks}/{counts.rounds} "
            "worker-leaf rounds used the kernel's answer)")
    if shard is not None:  # whole again, on every rank of the model group
        specs = tree_map(lambda p: p.spec, plan)

        def whole(tree):
            return unshard_params(tree, specs, mesh.model_group, M)

        params, opt_state = whole(params), _moments(opt_state, whole)
    if args.checkpoint:
        _save(args.checkpoint, params, opt_state, sp_state, plan, end, mesh)
        say(f"checkpointed to {args.checkpoint}")
    return RunResult(losses, params, sp_state, counts, plan, dist, opt_state)


def _model_axis_line(cfg, plan, mesh: Optional[DpGroups], shard) -> str:
    """The line that names the path the model axis of M > 1 takes."""
    leaves = tree_leaves(plan)
    M, n_split = leaves[0].shards, sum(split_dim(p) is not None for p in leaves)
    blocks = f"{n_split}/{len(leaves)} leaves split"
    if mesh is None:
        return (f"model axis: {M} shards on one card — one round per (worker, "
                f"shard), {blocks}; the forward, params and Adam whole")
    if shard is None:
        return (f"model axis: {M} ranks split the sparsify stage, {blocks}; "
                f"the {cfg.family} family's forward, params and Adam whole "
                "on every rank")
    return (f"model axis: tensor parallel over {M} ranks — params, forward, "
            f"backward and Adam sharded, {blocks} (axes "
            f"{', '.join(sorted(shard.split)) or 'none'})")


def _moments(opt_state, fn):
    """``opt_state`` with ``fn`` applied to each of its parameter-shaped
    trees (Adam's ``m`` and ``v``, the momentum); the step stays."""
    return {k: v if k == "step" else fn(v) for k, v in opt_state.items()}


def _all_workers(sp_state, mesh: Optional[DpGroups]):
    """The sparsifier state of all W x M (worker, shard) rows: this one on
    one card; across ranks every rank's row gathered in rank order, which
    is the row order (the controller tree is common to the ranks)."""
    if mesh is None:
        return sp_state
    if isinstance(sp_state, tuple):
        return (_all_workers(sp_state[0], mesh), sp_state[1])
    world = (torch_dist.group.WORLD,)
    return tree_map(lambda st: CompactState(*(_gather(x, world) for x in st)),
                    sp_state)


def _rows(sp_state, rows: torch.Tensor):
    """The sparsifier state of the workers ``rows``."""
    if isinstance(sp_state, tuple):
        return (_rows(sp_state[0], rows), sp_state[1])
    return tree_map(lambda st: select_rows(st, rows), sp_state)


def _save(path: str, params, opt_state, sp_state, plan, step: int,
          mesh: Optional[DpGroups]) -> None:
    """``--checkpoint``: params (with the step reached), optimizer state
    and the W workers' sparsifier state in the JAX trainer's layout
    (``sent_* [W, M, k]``), as the JAX trainer writes them; across ranks
    rank 0 writes what every rank gathered."""
    full = _all_workers(sp_state, mesh)
    if mesh is None or mesh.row == 0:
        ckpt.save(f"{path}/params", params, metadata={"step": step})
        ckpt.save(f"{path}/opt", opt_state)
        ckpt.save(f"{path}/sparsifier", convert.trainer_state_to_jax(full, plan))
    if mesh is not None:
        torch_dist.barrier()


def _resume(path: str, params, opt_state, sp_state, plan, W: int,
            mesh: Optional[DpGroups]):
    """``--resume``: ``(params, opt_state, sp_state, step)`` from the
    checkpoint in ``path``, each tree restored into the shapes and dtypes
    of the fresh run's; across ranks each rank takes its (worker, shard)'s
    row."""
    params = ckpt.restore(f"{path}/params", params)
    opt_state = ckpt.restore(f"{path}/opt", opt_state)
    # a donor of all W x M rows: this rank's row repeated (only shapes,
    # dtypes and devices are read)
    donor = sp_state if mesh is None else _rows(
        sp_state, torch.zeros(W * mesh.model, dtype=torch.long))
    restored = ckpt.restore(f"{path}/sparsifier",
                            convert.trainer_state_to_jax(donor, plan))
    sp_state = convert.trainer_state_from_jax(restored, plan)
    if mesh is not None:
        sp_state = _rows(sp_state, torch.tensor([mesh.row]))
    return params, opt_state, sp_state, ckpt.metadata(f"{path}/params").get("step", 0)


def _picks(plan, dist: DistConfig):
    """``[((codec, collective), leaves), ...]`` of a plan, sorted."""
    return sorted(Counter(leaf_wire(p, dist) for p in tree_leaves(plan)).items())


def _calibrate(mesh: Optional[DpGroups], axes, device: str, say):
    """``--calibrate``: ``(link_topo, link_model)`` fitted from collectives
    timed across the ranks of ``mesh``, one model per dp axis on two
    axes. In one process there is no process group, so no wire to probe:
    the defaults stay."""
    if mesh is None:
        say("calibration skipped (one process: no process group, so no "
            "wire to probe); using defaults")
        return None, None
    if len(axes) > 1:
        res = cal.calibrate_topo(mesh, axes, device=device)
        if not res.calibrated:
            say("calibration skipped (no dp axis with >1 worker); using "
                "defaults")
            return None, None
        for ax, c in zip(res.axes, res.per_axis, strict=True):
            say(f"calibrated {ax}: alpha={c.model.alpha:.3e} s/msg "
                f"beta={c.model.beta:.3e} s/B (rms {c.residual:.2e}s over "
                f"{len(c.samples)} probes)" if c.calibrated
                else f"calibrated {ax}: size-1 axis, defaults kept")
        return res.topo, None
    res = cal.calibrate(mesh, axes, device=device)
    say(f"calibrated alpha={res.model.alpha:.3e} s/msg "
        f"beta={res.model.beta:.3e} s/B (rms {res.residual:.2e}s over "
        f"{len(res.samples)} probes)" if res.calibrated
        else "calibration skipped (single device); using defaults")
    return None, res.model


def rank_device(device: str) -> str:
    """The device of this rank under torchrun: a bare ``cuda`` is
    ``cuda:LOCAL_RANK``; anything else is taken as given.

    >>> rank_device("cpu"), rank_device("cuda:0")
    ('cpu', 'cuda:0')
    """
    if device == "cuda":
        return f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    return device


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if "WORLD_SIZE" not in os.environ:
        run(args)
        return 0
    # the layout is checked before the process group starts
    world = int(os.environ["WORLD_SIZE"])
    try:
        if args.mesh == "production":
            check_world(production_shape(args.multi_pod), world,
                        production=True)
        else:
            host_shape(world, args.model_parallel, args.multi_pod)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    args.device = rank_device(args.device)
    cuda = torch.device(args.device).type == "cuda"
    if cuda:
        torch.cuda.set_device(args.device)
    torch_dist.init_process_group(
        args.backend or ("nccl" if cuda else "gloo"), init_method="env://"
    )
    try:
        groups = (make_production_groups(multi_pod=args.multi_pod)
                  if args.mesh == "production" else
                  make_host_groups(args.model_parallel, args.multi_pod))
        run(args, mesh=groups)
    finally:
        torch_dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
