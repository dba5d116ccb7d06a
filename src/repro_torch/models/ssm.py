"""SSM and hybrid models: mamba2-780m (pure SSD) and zamba2-7b (hybrid)
(counterpart of ``repro.models.ssm``, training only).

zamba2 structure (arXiv:2411.15242, as the JAX package adapts it):
``n_layers`` blocks in all; one *shared* attention+MLP block (one
parameter set) is applied every ``attn_every`` blocks, mamba2 blocks
elsewhere. The stack is ``n_groups`` groups of (``attn_every - 1`` mamba
blocks, then the shared block), then the trailing mamba blocks.

The tree is the JAX package's: ``trailing.*`` stacked on ``[n_trailing,
...]``, ``grouped.*`` on ``[n_groups, mamba_per_group, ...]``, and
``shared_attn`` one unstacked block whose gradient sums its ``n_groups``
applications. ``remat`` recomputes each mamba block and, separately, each
application of the shared block in the backward pass
(``torch.utils.checkpoint``).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import _stack_layers, _unstack, run_block, token_nll
from repro_torch.nn import layers as L
from repro_torch.nn import ssd

Params = Dict[str, Any]


def _plan(cfg: ModelConfig) -> Tuple[int, int, int]:
    """Returns (n_groups, mamba_per_group, trailing_mamba)."""
    if cfg.family != "hybrid":
        return 0, 0, cfg.n_layers
    per = cfg.attn_every  # group = (per-1) mamba + 1 shared attn
    n_groups = cfg.n_layers // per
    trailing = cfg.n_layers - n_groups * per
    return n_groups, per - 1, trailing


def _mamba_init(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    dt = cfg.torch_dtype
    return {
        "mixer": ssd.ssd_init(gen, cfg.d_model, device, d_inner=cfg.d_inner,
                              headdim=cfg.ssm_headdim, d_state=cfg.ssm_state,
                              dtype=dt),
        "norm": L.rmsnorm_init(cfg.d_model, device, dt),
    }


def _attn_block_init(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    dt = cfg.torch_dtype
    return {
        "attn": L.attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.hd, device, dtype=dt),
        "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, device, act=cfg.act,
                          dtype=dt),
        "norm1": L.rmsnorm_init(cfg.d_model, device, dt),
        "norm2": L.rmsnorm_init(cfg.d_model, device, dt),
    }


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> Params:
    """Random weights drawn from ``torch.Generator().manual_seed(seed)``,
    with the JAX package's shapes and scales: the embedding, the grouped
    mamba blocks, the shared block, the trailing blocks. Blocks are drawn
    and stacked on the host and moved to ``device`` leaf by leaf."""
    gen = torch.Generator().manual_seed(seed)
    dt = cfg.torch_dtype
    host = "meta" if torch.device(device).type == "meta" else "cpu"
    n_groups, per_group, trailing = _plan(cfg)
    params: Params = {"embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                            device, dtype=dt)}
    if n_groups * per_group:
        groups = [_stack_layers([_mamba_init(gen, cfg, host)
                                 for _ in range(per_group)], host)
                  for _ in range(n_groups)]
        params["grouped"] = _stack_layers(groups, device)
        params["shared_attn"] = _attn_block_init(gen, cfg, device)
    if trailing:
        params["trailing"] = _stack_layers(
            [_mamba_init(gen, cfg, host) for _ in range(trailing)], device)
    params["final_norm"] = L.rmsnorm_init(cfg.d_model, device, dt)
    return params


def _mamba_block(lp: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = L.rmsnorm(lp["norm"], x, eps=cfg.norm_eps)
    y, _ = ssd.ssd_block_apply(
        lp["mixer"], h, d_inner=cfg.d_inner, headdim=cfg.ssm_headdim,
        d_state=cfg.ssm_state, chunk=cfg.ssm_chunk, norm_eps=cfg.norm_eps)
    return x + y


def _attn_block(lp: Params, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor) -> torch.Tensor:
    h = L.rmsnorm(lp["norm1"], x, eps=cfg.norm_eps)
    q, k, v = L.attn_qkv(lp["attn"], h)
    q = L.rope(q, positions, base=cfg.rope_base)
    k = L.rope(k, positions, base=cfg.rope_base)
    ctx = L.attention_dense(q, k, v, causal=True)
    x = x + L.attn_out(lp["attn"], ctx)
    h = L.rmsnorm(lp["norm2"], x, eps=cfg.norm_eps)
    return x + L.mlp(lp["mlp"], h, act=cfg.act)


def forward(params: Params, cfg: ModelConfig, batch
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(logits [B, S, padded_vocab], aux)``, aux 0 (no aux loss)."""
    x = L.embed(params["embed"], batch["tokens"], cfg.torch_dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    n_groups, per_group, trailing = _plan(cfg)
    if n_groups:
        shared = params["shared_attn"]
        for group in _unstack(params["grouped"], n_groups):
            for lp in _unstack(group, per_group):
                x = run_block(_mamba_block, lp, x, cfg, remat=cfg.remat)
            x = run_block(_attn_block, shared, x, cfg, positions, remat=cfg.remat)
    if trailing:
        for lp in _unstack(params["trailing"], trailing):
            x = run_block(_mamba_block, lp, x, cfg, remat=cfg.remat)
    x = L.rmsnorm(params["final_norm"], x, eps=cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return L.unembed(params["embed"], x), aux


def loss_fn(params: Params, cfg: ModelConfig, batch) -> Tuple[torch.Tensor, Dict]:
    """Mean next-token cross-entropy, with no aux term; metrics ``{"nll",
    "aux"}``."""
    logits, aux = forward(params, cfg, batch)
    nll = token_nll(logits, cfg, batch["labels"])
    return nll, {"nll": nll, "aux": aux}
