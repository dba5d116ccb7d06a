"""Encoder-decoder transformer: the whisper-tiny backbone (counterpart of
``repro.models.encdec``, training only).

As in the JAX package, the audio frontend (mel + conv) is a stub: the
batch holds precomputed frame embeddings ``frames [B, enc_seq, d_model]``.
The encoder is bidirectional; the decoder is causal self-attention, then
cross-attention on the encoder output, then the MLP. RoPE takes the place
of Whisper's learned positions, as in the JAX package.

The tree is the JAX package's: ``enc_layers.*`` stacked on
``[n_enc_layers, ...]``, ``dec_layers.*`` (``self``, ``cross``, ``mlp``,
``norm1..3``) on ``[n_layers, ...]``, then ``enc_norm`` and
``final_norm``. ``remat`` recomputes each encoder and each decoder block
in the backward pass (``torch.utils.checkpoint``).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import (
    _norm, _stack_layers, _unstack, run_block, token_nll)
from repro_torch.nn import layers as L

Params = Dict[str, Any]


def _attn_init(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    return L.attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                       device, dtype=cfg.torch_dtype, pad_to=cfg.pad_heads)


def _enc_layer_init(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    ninit, _ = _norm(cfg)
    dt = cfg.torch_dtype
    return {"attn": _attn_init(gen, cfg, device),
            "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, device, act=cfg.act,
                              dtype=dt),
            "norm1": ninit(cfg.d_model, device, dt),
            "norm2": ninit(cfg.d_model, device, dt)}


def _dec_layer_init(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    ninit, _ = _norm(cfg)
    dt = cfg.torch_dtype
    p = {"self": _attn_init(gen, cfg, device),
         "cross": _attn_init(gen, cfg, device),
         "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, device, act=cfg.act,
                           dtype=dt)}
    for i in (1, 2, 3):
        p[f"norm{i}"] = ninit(cfg.d_model, device, dt)
    return p


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> Params:
    """Random weights drawn from ``torch.Generator().manual_seed(seed)``,
    with the JAX package's shapes and scales: the embedding, the encoder
    layers, the decoder layers, the two final norms. Layers are drawn and
    stacked on the host and moved to ``device`` leaf by leaf."""
    gen = torch.Generator().manual_seed(seed)
    dt = cfg.torch_dtype
    host = "meta" if torch.device(device).type == "meta" else "cpu"
    ninit, _ = _norm(cfg)
    return {
        "embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model, device,
                              dtype=dt),
        "enc_layers": _stack_layers(
            [_enc_layer_init(gen, cfg, host) for _ in range(cfg.n_enc_layers)],
            device),
        "dec_layers": _stack_layers(
            [_dec_layer_init(gen, cfg, host) for _ in range(cfg.n_layers)],
            device),
        "enc_norm": ninit(cfg.d_model, device, dt),
        "final_norm": ninit(cfg.d_model, device, dt),
    }


def _enc_block(lp: Params, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor) -> torch.Tensor:
    _, norm = _norm(cfg)
    h = norm(lp["norm1"], x)
    q, k, v = L.attn_qkv(lp["attn"], h)
    q = L.rope(q, positions, base=cfg.rope_base)
    k = L.rope(k, positions, base=cfg.rope_base)
    ctx = L.attention_dense(q, k, v, causal=False)
    x = x + L.attn_out(lp["attn"], ctx)
    h = norm(lp["norm2"], x)
    return x + L.mlp(lp["mlp"], h, act=cfg.act)


def _encode(params: Params, cfg: ModelConfig, frames: torch.Tensor
            ) -> torch.Tensor:
    """frames: [B, enc_seq, d_model] from the frontend stub."""
    _, norm = _norm(cfg)
    x = frames.to(cfg.torch_dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    for lp in _unstack(params["enc_layers"], cfg.n_enc_layers):
        x = run_block(_enc_block, lp, x, cfg, positions, remat=cfg.remat)
    return norm(params["enc_norm"], x)


def _dec_block(lp: Params, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor, enc_out: torch.Tensor) -> torch.Tensor:
    _, norm = _norm(cfg)
    h = norm(lp["norm1"], x)
    q, k, v = L.attn_qkv(lp["self"], h)
    q = L.rope(q, positions, base=cfg.rope_base)
    k = L.rope(k, positions, base=cfg.rope_base)
    ctx = L.attention_dense(q, k, v, causal=True)
    x = x + L.attn_out(lp["self"], ctx)
    h = norm(lp["norm2"], x)
    q, ck, cv = L.attn_qkv(lp["cross"], h, xkv=enc_out)
    ctx = L.attention_dense(q, ck, cv, causal=False)
    x = x + L.attn_out(lp["cross"], ctx)
    h = norm(lp["norm3"], x)
    return x + L.mlp(lp["mlp"], h, act=cfg.act)


def forward(params: Params, cfg: ModelConfig, batch
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(logits [B, S, padded_vocab], aux)``, aux 0 (no aux loss)."""
    enc_out = _encode(params, cfg, batch["frames"])
    x = L.embed(params["embed"], batch["tokens"], cfg.torch_dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    for lp in _unstack(params["dec_layers"], cfg.n_layers):
        x = run_block(_dec_block, lp, x, cfg, positions, enc_out,
                      remat=cfg.remat)
    _, norm = _norm(cfg)
    x = norm(params["final_norm"], x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return L.unembed(params["embed"], x), aux


def loss_fn(params: Params, cfg: ModelConfig, batch) -> Tuple[torch.Tensor, Dict]:
    """Mean next-token cross-entropy over the decoder tokens, with no aux
    term; metrics ``{"nll", "aux"}``."""
    logits, aux = forward(params, cfg, batch)
    nll = token_nll(logits, cfg, batch["labels"])
    return nll, {"nll": nll, "aux": aux}
