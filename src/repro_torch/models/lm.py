"""Decoder-only transformer LM, dense family (counterpart of
``repro.models.lm``).

The parameter tree is the JAX package's: a dict with the same names, and
every per-layer leaf stacked on a leading ``n_layers`` axis
(``layers.attn.wq`` is ``[n_layers, d_model, heads, head_dim]``). The
sparsifier runs per leaf with ``k = sparsity_to_k(leaf_len, S)``, so the
stacking decides each leaf's length, k and selection; keeping it is what
lets the port be held against the JAX package leaf for leaf.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.nn import layers as L

Params = Dict[str, Any]


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> Params:
    """Random weights drawn from ``torch.Generator().manual_seed(seed)``,
    with the JAX package's shapes and scales."""
    gen = torch.Generator().manual_seed(seed)
    emb = L.embed_init(gen, cfg.padded_vocab, cfg.d_model, device)
    per_layer = [
        {
            "attn": L.attn_init(
                gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                device,
            ),
            "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, device),
            "norm1": L.rmsnorm_init(cfg.d_model, device),
            "norm2": L.rmsnorm_init(cfg.d_model, device),
        }
        for _ in range(cfg.n_layers)
    ]
    layers = {
        group: {
            name: torch.stack([lp[group][name] for lp in per_layer])
            for name in per_layer[0][group]
        }
        for group in per_layer[0]
    }
    return {
        "embed": emb,
        "layers": layers,
        "final_norm": L.rmsnorm_init(cfg.d_model, device),
    }


def _layer(params_layers: Params, i: int) -> Params:
    return {
        group: {name: leaf[i] for name, leaf in sub.items()}
        for group, sub in params_layers.items()
    }


def _block(
    lp: Params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor
) -> torch.Tensor:
    h = L.rmsnorm(lp["norm1"], x, eps=cfg.norm_eps)
    q, k, v = L.attn_qkv(lp["attn"], h)
    q = L.rope(q, positions, base=cfg.rope_base, fraction=cfg.rope_fraction)
    k = L.rope(k, positions, base=cfg.rope_base, fraction=cfg.rope_fraction)
    ctx = L.attention_dense(q, k, v, causal=True, window=cfg.sliding_window)
    x = x + L.attn_out(lp["attn"], ctx)
    h = L.rmsnorm(lp["norm2"], x, eps=cfg.norm_eps)
    return x + L.mlp(lp["mlp"], h)


def forward(params: Params, cfg: ModelConfig, batch) -> torch.Tensor:
    """Logits ``[B, S, padded_vocab]`` over the token positions."""
    x = L.embed(params["embed"], batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)
    for i in range(cfg.n_layers):
        x = _block(_layer(params["layers"], i), x, cfg, positions)
    x = L.rmsnorm(params["final_norm"], x, eps=cfg.norm_eps)
    return L.unembed(params["embed"], x)


def mask_pad_logits(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Remove the vocab-padding rows from the softmax support."""
    if cfg.padded_vocab == cfg.vocab:
        return logits
    bad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab
    return logits.masked_fill(bad, L.NEG_INF)


def loss_fn(params: Params, cfg: ModelConfig, batch) -> Tuple[torch.Tensor, Dict]:
    """Mean next-token cross-entropy. The dense family has no auxiliary
    loss, so the loss is the NLL itself."""
    logits = mask_pad_logits(forward(params, cfg, batch).float(), cfg)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["labels"][..., None])[..., 0]
    nll = (logz - gold).mean()
    return nll, {"nll": nll}
