"""Batched decode serving (counterpart of ``repro.launch.serve``).

    python -m repro_torch.launch.serve --arch qwen2.5-3b --smoke --device cpu

Initialises a model from seed 0 (``--restore DIR`` then reads ``DIR/params``,
written by either package's checkpoint store), builds its decode cache
(for ``encdec`` the cross-attention cache of zero frames, as
``repro.launch.serve`` does: the seeded weights' LayerNorm biases are
zero, so the encoder maps those frames to zeros and that cache is all
zeros), and decodes ``--batch`` rows token by token: ``--prompt-len``
untimed steps, then ``--new-tokens`` timed ones, reporting tokens per
second. Runs on ``cuda`` unless ``--device cpu`` is given.

What the steps feed is what the JAX driver's code feeds (its comment says
"teacher forcing the prompt"; its loop does not): the first input is one
random token per row, and every step, the prompt's too, feeds back its
own argmax. The first tokens come from ``torch.Generator().manual_seed(1)``
on the host; the JAX driver draws them from ``PRNGKey(1)``, a stream torch
cannot draw.

A cache without a ring (``lm`` without a sliding window, the hybrid's
``attn_k``, ``encdec``'s ``k``) has ``--max-len`` slots, and ``run``
refuses a request of more steps before its first step: past the last slot
the JAX package's ``dynamic_update_slice`` clamps each write into that
slot, overwriting the newest key.

Across ranks (``run(args, mesh=...)`` in each rank of a
``launch.mesh.spawn``, or under ``torchrun``), each rank serves its dp
group's rows of the batch on its blocks of the parameters and the cache,
laid out as the JAX dry run's ``lower_serve`` lays them out
(``nn.sharding.serve_rules``): the kv heads split over the model axis
where it divides them, else the cache's slots, and the SSD mixers' conv
windows and SSM states by their channels and heads, and the
encoder-decoder's cross-attention cache by its kv heads where the self
cache splits them (its frames never split). Every family serves so
(``models.serve_parallel``); a family left out of its module's
``SERVE_PARALLEL`` would be refused a model axis above 1. No flag chooses
the layout, as in the JAX serve CLI.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List, NamedTuple, Optional

import torch

from repro_torch import checkpoint as ckpt
from repro_torch import configs as cfglib
from repro_torch.models import get_family, param_axes, serve_parallel
from repro_torch.models.config import ModelConfig
from repro_torch.nn.sharding import (
    serve_rules,
    serve_shard,
    shard_params,
    tree_specs,
)
from repro_torch.tree import tree_map


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke variant of --arch")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8,
                    help="untimed greedy steps before the timed ones")
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--max-len", type=int, default=64,
                    help="slots of the KV cache (a ring of the sliding "
                         "window's slots where the config has one)")
    ap.add_argument("--restore", default=None, metavar="DIR",
                    help="restore the params from DIR/params")
    ap.add_argument("--device", default="cuda", help="'cuda', 'cuda:i' or 'cpu'")
    return ap.parse_args(argv)


class ServeResult(NamedTuple):
    # across ranks, the rows of this rank's dp group
    first: torch.Tensor  # [B, 1], the first inputs
    prompt: torch.Tensor  # [B, prompt_len], the untimed steps' tokens
    tokens: torch.Tensor  # [B, new_tokens], the timed steps' tokens
    seconds: float  # the timed steps, host clock between synchronises
    tokens_per_s: float
    step_ms: List[float]  # each timed step (CUDA events on the card)


def check_length(cfg: ModelConfig, args: argparse.Namespace) -> None:
    steps = args.prompt_len + args.new_tokens
    kv = get_family(cfg).ringless_kv(cfg)
    if kv and steps > args.max_len:
        raise SystemExit(
            f"--prompt-len {args.prompt_len} + --new-tokens {args.new_tokens} "
            f"= {steps} steps exceed --max-len {args.max_len}, the slots of "
            f"{cfg.name}'s {'/'.join(kv)} cache, which has no ring: the JAX "
            "package's dynamic_update_slice would clamp every write past "
            f"slot {args.max_len - 1} into that slot, overwriting the newest "
            "key")


def serve_layout(cfg: ModelConfig, params, batch: int, max_len: int,
                 mesh_shape, dp_axes=("data",), group=None, index: int = 0):
    """``(param specs, cache specs, shard)`` of a serving rank, shard
    ``index`` of its model ``group`` on ``mesh_shape`` (``group`` None:
    counted on the meta device), for ``batch`` rows and ``max_len`` steps
    under ``nn.sharding.serve_rules``. The shard is None at a model axis
    of 1 and for a family outside ``models.serve_parallel``."""
    M = mesh_shape["model"]
    mod = get_family(cfg)
    rules = serve_rules(cfg, M)
    axes, cache_axes = param_axes(cfg), mod.cache_axes(cfg)
    specs = tree_specs(params, axes, mesh_shape, rules, dp_axes)
    cache_specs = tree_specs(mod.init_cache(cfg, batch, max_len, device="meta"),
                             cache_axes, mesh_shape, rules, dp_axes)
    shard = (serve_shard(axes, specs, cache_axes, cache_specs, group, index, M)
             if serve_parallel(cfg) else None)
    return specs, cache_specs, shard


def run(args: argparse.Namespace, params=None,
        cfg: Optional[ModelConfig] = None, mesh=None) -> ServeResult:
    """Serve as the module docstring says and print the JAX driver's two
    lines. ``cfg`` replaces the config that ``--arch`` and ``--smoke``
    name (a depth-cut one), and ``params`` (of that config, on
    ``args.device``) the seeded init, so a caller that holds the weights
    does not draw them again. ``mesh`` (a ``launch.mesh.DpGroups``)
    serves across ranks: each rank keeps its blocks of the whole
    parameters (given on any device) on ``args.device`` and decodes its dp
    group's rows of the batch, which the dp size must divide; the first
    tokens are the one-card run's, and global rank 0 prints."""
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {args.device} requested but CUDA is not available")
    if cfg is None:
        cfg = cfglib.get_config(args.arch)
        if args.smoke:
            cfg = cfg.smoke_variant()
    check_length(cfg, args)
    cuda = torch.device(args.device).type == "cuda"
    mod = get_family(cfg)
    B, rows, shard = args.batch, slice(None), None
    if mesh is not None:
        if B % mesh.size:
            raise ValueError(f"--batch {B} does not divide over {mesh.size} "
                             "dp groups")
        if mesh.model > 1 and not serve_parallel(cfg):
            raise ValueError(f"{cfg.name}: the {cfg.family} family does not "
                             "serve on a rank's blocks, so not over a model "
                             f"axis of {mesh.model}")
        n = B // mesh.size
        rows = slice(mesh.rank * n, (mesh.rank + 1) * n)
        specs, _, shard = serve_layout(
            cfg, mod.init(cfg, device="meta"), B, args.max_len,
            mesh.mesh_shape, mesh.axis_names, mesh.model_group, mesh.shard)
    if params is None:
        params = mod.init(cfg, seed=0, device=args.device)
    if args.restore:
        params = ckpt.restore(f"{args.restore}/params", params)
    kw = {} if shard is None else {"shard": shard}
    if mesh is not None:
        if shard is not None:
            params = shard_params(params, specs, mesh.shard, mesh.model)
        params = tree_map(lambda x: x.to(args.device), params)
    with torch.inference_mode():
        first = torch.randint(0, cfg.vocab, (B, 1),
                              generator=torch.Generator().manual_seed(1))[rows]
        B = first.shape[0]
        cache = mod.init_cache(cfg, B, args.max_len, device=args.device, **kw)
        if cfg.family == "encdec":
            frames = torch.zeros((B, cfg.enc_seq, cfg.d_model),
                                 dtype=cfg.torch_dtype, device=args.device)
            cache["ck"], cache["cv"] = mod.build_cross_cache(params, cfg, frames,
                                                             **kw)
        tokens = first.to(args.device)
        prompt = []
        for _ in range(args.prompt_len):
            logits, cache = mod.decode_step(params, cfg, cache, tokens, **kw)
            tokens = torch.argmax(logits[:, -1:], dim=-1)
            prompt.append(tokens)
        if cuda:
            torch.cuda.synchronize(args.device)
            marks = [torch.cuda.Event(enable_timing=True)
                     for _ in range(args.new_tokens + 1)]
            marks[0].record()
        host = [time.perf_counter()]
        out = []
        for t in range(args.new_tokens):
            logits, cache = mod.decode_step(params, cfg, cache, tokens, **kw)
            tokens = torch.argmax(logits[:, -1:], dim=-1)
            out.append(tokens)
            if cuda:
                marks[t + 1].record()
            else:
                host.append(time.perf_counter())
        if cuda:
            torch.cuda.synchronize(args.device)
        dt = time.perf_counter() - host[0]
    if cuda:
        step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        step_ms = [1e3 * (b - a) for a, b in zip(host, host[1:])]
    total = args.new_tokens * args.batch
    if mesh is None or mesh.row == 0:
        print(f"{args.arch}: decoded {total} tokens in {dt:.2f}s "
              f"({total / dt:.1f} tok/s, batch={args.batch})", flush=True)
        print("sample token ids:", [int(x[0, 0]) for x in out[:8]],
              flush=True)
    empty = torch.zeros((B, 0), dtype=torch.int64)
    return ServeResult(
        first=first,
        prompt=torch.cat(prompt, 1).cpu() if prompt else empty,
        tokens=torch.cat(out, 1).cpu() if out else empty,
        seconds=dt, tokens_per_s=total / dt, step_ms=step_ms)


def main(argv: Optional[List[str]] = None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
