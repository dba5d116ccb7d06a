"""Training launcher for the port (counterpart of ``repro.launch.train``).

    python -m repro_torch.launch.train --arch paper-resnet-proxy \
        --workers 8 --steps 10 --sparsifier regtopk --fastpath on

``--workers W`` is the counterpart of the JAX trainer's host-mesh device
count: W logical data-parallel workers on one card, one dp mesh axis
named ``data`` (what ``--link-topo`` names). Runs on ``cuda`` unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List, NamedTuple, Optional

import torch

from repro_torch import configs as cfglib
from repro_torch.comm import cost
from repro_torch.comm.codec import CODECS
from repro_torch.comm.collectives import COLLECTIVES
from repro_torch.comm.fastpath import FastpathCounts, ThroughputTable
from repro_torch.core.distributed import (
    DistConfig,
    build_plan,
    comm_round_bytes,
    comm_round_cost,
    init_sparsifier_state,
    make_train_step,
)
from repro_torch.core.sparsify import SparsifierConfig
from repro_torch.data import TokenPipeline
from repro_torch.models import lm
from repro_torch.optim import OptConfig, make_optimizer
from repro_torch.tree import tree_leaves


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
    ap.add_argument("--codec", default="coo_fp32", choices=sorted(CODECS))
    ap.add_argument("--collective", default="sparse_allgather",
                    choices=sorted(COLLECTIVES))
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
                    help="link model of the dp axis 'data' that prices the "
                         "comm line: 'data:alpha,beta' or a bare "
                         "'alpha,beta' (seconds per message, per byte)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke variant of --arch")
    ap.add_argument("--workers", type=int, default=1,
                    help="data-parallel workers on the card (the JAX "
                         "trainer's host-mesh device count)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


class RunResult(NamedTuple):
    losses: List[float]
    params: dict
    sp_state: dict
    counts: FastpathCounts
    plan: dict


def run(args: argparse.Namespace, dist: Optional[DistConfig] = None,
        table: Optional[ThroughputTable] = None) -> RunResult:
    """Train for ``args.steps`` steps, logging as the JAX trainer does.
    ``dist`` replaces the ``DistConfig`` the flags describe, for what the
    CLI has no flag for (as the JAX trainer has none for the selector:
    ``SparsifierConfig(selector="threshold")``). ``table`` prices
    ``--fastpath auto`` (``ThroughputTable()``'s defaults when None)."""
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {args.device} requested but CUDA is not available"
        )
    cfg = cfglib.get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke_variant()
    W = args.workers
    if args.global_batch % W:
        raise SystemExit(f"--global-batch must be divisible by {W} workers")
    link_topo = None
    if args.link_topo:
        link_topo = cost.parse_link_topo(args.link_topo, ("data",))
        for lk in link_topo.links:
            print(f"link-topo data: alpha={lk.alpha:.3e} s/msg "
                  f"beta={lk.beta:.3e} s/B", flush=True)
    dist = dist or DistConfig(
        sparsifier=SparsifierConfig(
            kind=args.sparsifier, sparsity=args.sparsity, mu=args.mu
        ),
        optimizer=OptConfig(kind="adam", learning_rate=args.lr),
        codec=args.codec,
        collective=args.collective,
        fastpath=args.fastpath,
        weighting="coordinate" if args.coord_weights else "worker",
        link_topo=link_topo,
    )
    if dist.weighting == "coordinate":
        print("weighting: coordinate — per-coordinate renormalization over "
              "the workers that sent each coordinate", flush=True)
    if dist.fastpath != "off":
        print(f"fastpath: {dist.fastpath} (resolved "
              f"{dist.resolved_fastpath()}) — fused select->encode on "
              "fusable leaves", flush=True)
    params = lm.init(cfg, seed=0, device=args.device)
    plan = build_plan(params, dist.sparsifier.sparsity, dist, table)
    counts = FastpathCounts()
    step_fn = make_train_step(cfg, dist, plan, W, counts)
    opt_state = make_optimizer(dist.optimizer).init(params)
    sp_state = init_sparsifier_state(plan, W, args.device)
    pipe = TokenPipeline(cfg, args.global_batch, args.seq, 0, args.device)
    pred_b, meas_b = comm_round_bytes(plan, dist, W)
    round_cost = comm_round_cost(plan, dist, W)
    print(
        f"comm: codec={dist.codec} collective={dist.collective} "
        f"{meas_b / 1e6:.3f} MB/worker/round "
        f"(predicted {pred_b / 1e6:.3f} MB, "
        f"{round_cost.seconds * 1e3:.3f} ms/round under the link model)",
        flush=True,
    )
    leaves = tree_leaves(plan)
    if dist.resolved_fastpath() != "off":
        print(
            f"comm:   fastpath: {sum(p.fused for p in leaves)}/{len(leaves)} "
            "leaves fused",
            flush=True,
        )
    losses = []
    t0 = time.time()
    for t in range(args.steps):
        params, opt_state, sp_state, m = step_fn(
            params, opt_state, sp_state, pipe.batch_at(t)
        )
        losses.append(float(m["loss"]))
        if t % args.log_every == 0 or t == args.steps - 1:
            dt = time.time() - t0
            print(
                f"step {t:5d} loss {losses[-1]:.4f} "
                f"({dt / (t + 1):.2f}s/step)",
                flush=True,
            )
    if counts.rounds:
        print(
            f"fastpath: certificate hit rate {counts.hit_rate:.4f} "
            f"({counts.rounds - counts.fallbacks}/{counts.rounds} "
            "worker-leaf rounds used the kernel's answer)",
            flush=True,
        )
    return RunResult(losses, params, sp_state, counts, plan)


def main(argv: Optional[List[str]] = None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
