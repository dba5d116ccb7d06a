"""Encoder-decoder transformer: the whisper-tiny backbone (counterpart of
``repro.models.encdec``).

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

Tensor parallelism (the family is in ``TENSOR_PARALLEL``): ``loss_fn``,
``forward`` and the blocks take a ``shard`` (``nn.tensor_parallel.
ModelShard``) when the trainer's rank holds its model shard's block of
each leaf that ``nn.sharding`` splits, as ``models.lm``'s decoders do.
The encoder's attention and MLP, the decoder's self-attention, its
cross-attention and its MLP each read from the shard whether their own
logical axis is split (the query heads, the kv heads, the MLP's columns),
so at whisper-tiny's 6 heads a model axis of 4 keeps the heads whole and
splits the MLPs. The cross-attention's keys and values come from the
encoder output, which enters the model group inside each decoder layer's
``attn_qkv`` and nowhere else: each layer's share of its gradient is
summed over the group once. The embedding and the unembedding are
vocabulary parallel, the logits gathered over the model group before the
loss. The LayerNorms stay whole, equal in bits on every rank of a group.
Under ``remat`` a block's forward collectives up to its last saved
tensor run again in the backward, in the same order on every rank.

Serving: ``build_cross_cache`` runs the encoder once and projects every
decoder layer's cross-attention keys and values; the decode cache holds
those (``ck``, ``cv`` over ``enc_seq``) beside the self-attention KV
cache (``k``, ``v`` over ``max_len``), which ``decode_step`` writes in
place. The family is in ``SERVE_PARALLEL``: ``prefill``,
``build_cross_cache``, ``init_cache`` and ``decode_step`` take a serving
``shard`` (``nn.sharding.serve_rules``), under which the rank holds its
blocks of the parameters and of both caches, as the JAX dry run's
``lower_serve`` lays them out. The self cache is ``models.lm``'s: the
rank's kv heads where the model axis divides them, else its slots
(``"kv_seq"``). The cross cache has no rule for its frames
(``"enc_seq"``), so it splits by kv heads where the self cache does and
is otherwise whole on every rank, the same bits on each: a rank computes
its own block from the whole encoder output and gathers no cache.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import (
    _norm, _norm_axes, _splits, _stack_layers, _unstack, attend, mask_pad_logits,
    run_block, token_nll, write_kv)
from repro_torch.nn import layers as L
from repro_torch.nn.sharding import prefix_axes

Params = Dict[str, Any]

# the family of this module whose forward the trainer shards over the
# model axis
TENSOR_PARALLEL = frozenset({"encdec"})
# the family of this module whose serve step runs on a rank's blocks
SERVE_PARALLEL = frozenset({"encdec"})


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
    layers, the decoder layers, the two final norms. Layers are drawn on
    the host one at a time and copied into the stacked tensors on
    ``device``."""
    gen = torch.Generator().manual_seed(seed)
    dt = cfg.torch_dtype
    host = "meta" if torch.device(device).type == "meta" else "cpu"
    ninit, _ = _norm(cfg)
    return {
        "embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model, device,
                              dtype=dt),
        "enc_layers": _stack_layers(lambda: _enc_layer_init(gen, cfg, host),
                                    cfg.n_enc_layers, device),
        "dec_layers": _stack_layers(lambda: _dec_layer_init(gen, cfg, host),
                                    cfg.n_layers, device),
        "enc_norm": ninit(cfg.d_model, device, dt),
        "final_norm": ninit(cfg.d_model, device, dt),
    }


def param_axes(cfg: ModelConfig) -> Params:
    """The logical axes of ``init(cfg)``'s tree, the tree the JAX
    ``init`` returns beside the parameters (nothing drawn)."""
    enc = {"attn": L.attn_axes(), "mlp": L.mlp_axes(act=cfg.act),
           "norm1": _norm_axes(cfg), "norm2": _norm_axes(cfg)}
    dec = {"self": L.attn_axes(), "cross": L.attn_axes(),
           "mlp": L.mlp_axes(act=cfg.act),
           **{f"norm{i}": _norm_axes(cfg) for i in (1, 2, 3)}}
    return {"embed": L.embed_axes(), "enc_layers": prefix_axes(enc),
            "dec_layers": prefix_axes(dec), "enc_norm": _norm_axes(cfg),
            "final_norm": _norm_axes(cfg)}


def _enc_block(lp: Params, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor, shard=None) -> torch.Tensor:
    _, norm = _norm(cfg)
    h = norm(lp["norm1"], x)
    q, k, v = L.attn_qkv(lp["attn"], h, shard=shard)
    q = L.rope(q, positions, base=cfg.rope_base)
    k = L.rope(k, positions, base=cfg.rope_base)
    ctx = L.attention_dense(q, k, v, causal=False)
    x = x + L.attn_out(lp["attn"], ctx, shard=shard)
    h = norm(lp["norm2"], x)
    return x + L.mlp(lp["mlp"], h, act=cfg.act, shard=shard)


def _encode(params: Params, cfg: ModelConfig, frames: torch.Tensor,
            shard=None) -> torch.Tensor:
    """frames: [B, enc_seq, d_model] from the frontend stub; ``shard``
    the rank's model shard (module docstring)."""
    _, norm = _norm(cfg)
    x = frames.to(cfg.torch_dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    for lp in _unstack(params["enc_layers"], cfg.n_enc_layers):
        x = run_block(_enc_block, lp, x, cfg, positions, shard,
                      remat=cfg.remat)
    return norm(params["enc_norm"], x)


def _dec_block(lp: Params, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor, enc_out: torch.Tensor,
               mode: str = "dense", shard=None) -> torch.Tensor:
    _, norm = _norm(cfg)
    h = norm(lp["norm1"], x)
    q, k, v = L.attn_qkv(lp["self"], h, shard=shard)
    q = L.rope(q, positions, base=cfg.rope_base)
    k = L.rope(k, positions, base=cfg.rope_base)
    ctx = attend(q, k, v, cfg, mode, causal=True)
    x = x + L.attn_out(lp["self"], ctx, shard=shard)
    h = norm(lp["norm2"], x)
    # enc_out enters the model group here, once a layer (module docstring)
    q, ck, cv = L.attn_qkv(lp["cross"], h, xkv=enc_out, shard=shard)
    ctx = L.attention_dense(q, ck, cv, causal=False)
    x = x + L.attn_out(lp["cross"], ctx, shard=shard)
    h = norm(lp["norm3"], x)
    return x + L.mlp(lp["mlp"], h, act=cfg.act, shard=shard)


def forward(params: Params, cfg: ModelConfig, batch, *, mode: str = "dense",
            shard=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(logits [B, S, padded_vocab], aux)``, aux 0 (no aux loss);
    ``mode`` is the decoder's self-attention, "dense" or "chunked" (the
    encoder and the cross-attention stay dense, as in the JAX package);
    under ``shard`` the rank's blocks, the logits whole."""
    enc_out = _encode(params, cfg, batch["frames"], shard)
    x = L.embed(params["embed"], batch["tokens"], cfg.torch_dtype, shard)
    positions = torch.arange(x.shape[1], device=x.device)
    for lp in _unstack(params["dec_layers"], cfg.n_layers):
        x = run_block(_dec_block, lp, x, cfg, positions, enc_out, mode, shard,
                      remat=cfg.remat)
    _, norm = _norm(cfg)
    x = norm(params["final_norm"], x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return L.unembed(params["embed"], x, shard), aux


def loss_fn(params: Params, cfg: ModelConfig, batch, shard=None
            ) -> Tuple[torch.Tensor, Dict]:
    """Mean next-token cross-entropy over the decoder tokens, with no aux
    term; metrics ``{"nll", "aux"}``. ``shard``: the rank's model shard
    (module docstring)."""
    logits, aux = forward(params, cfg, batch, shard=shard)
    nll = token_nll(logits, cfg, batch["labels"])
    return nll, {"nll": nll, "aux": aux}


# ---------------------------------------------------------------------------
# serving: self-attention KV cache beside the precomputed cross-attention KV
# ---------------------------------------------------------------------------
@torch.no_grad()
def prefill(params: Params, cfg: ModelConfig, batch, shard=None) -> torch.Tensor:
    """Logits of the prompt, the decoder's self-attention chunked; under a
    serving ``shard`` from the rank's blocks, the logits whole."""
    return forward(params, cfg, batch, mode="chunked", shard=shard)[0]


@torch.no_grad()
def build_cross_cache(params: Params, cfg: ModelConfig, frames: torch.Tensor,
                      shard=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(ck, cv)`` ``[n_layers, B, enc_seq, kv_heads, head_dim]``: the
    encoder once over ``frames``, then each decoder layer's
    cross-attention ``wk`` and ``wv`` (no bias, as the JAX package).
    Under a serving ``shard`` the encoder runs on the rank's blocks and
    its output is whole; ``wk`` and ``wv`` are the rank's kv heads where
    ``"kv_heads"`` is split, so the result is the rank's block of the
    cache, else the whole cache."""
    enc_out = _encode(params, cfg, frames, shard)
    cross = params["dec_layers"]["cross"]
    ck = torch.einsum("bse,lehd->lbshd", enc_out, cross["wk"].to(enc_out.dtype))
    cv = torch.einsum("bse,lehd->lbshd", enc_out, cross["wv"].to(enc_out.dtype))
    return ck, cv


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda",
               shard=None) -> Dict:
    """Zero ``k``, ``v`` ``[n_layers, B, max_len, kv_heads, head_dim]``,
    ``ck``, ``cv`` ``[n_layers, B, enc_seq, kv_heads, head_dim]`` (filled
    from ``build_cross_cache``) and ``pos``. Under a serving ``shard`` the
    rank's block: of ``k`` and ``v`` its slots where ``"kv_seq"`` is
    split, of all four its kv heads where ``"kv_heads"`` is."""
    kv_heads = cfg.eff_kv_heads // _splits(shard, "kv_heads")
    kv = (cfg.n_layers, batch, max_len // _splits(shard, "kv_seq"), kv_heads,
          cfg.hd)
    ckv = (cfg.n_layers, batch, cfg.enc_seq, kv_heads, cfg.hd)
    dt = cfg.torch_dtype
    return {"k": torch.zeros(kv, dtype=dt, device=device),
            "v": torch.zeros(kv, dtype=dt, device=device),
            "ck": torch.zeros(ckv, dtype=dt, device=device),
            "cv": torch.zeros(ckv, dtype=dt, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def ringless_kv(cfg: ModelConfig) -> List[str]:
    """The KV caches that have no ring, so hold ``max_len`` steps at most:
    the self-attention's (the cross cache holds ``enc_seq`` keys)."""
    return ["k", "v"]


def cache_axes(cfg: ModelConfig) -> Dict:
    ax = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    cax = ("layers", "batch", "enc_seq", "kv_heads", "head_dim")
    return {"k": ax, "v": ax, "ck": cax, "cv": cax, "pos": ()}


@torch.no_grad()
def decode_step(params: Params, cfg: ModelConfig, cache: Dict,
                tokens: torch.Tensor, shard=None) -> Tuple[torch.Tensor, Dict]:
    """``tokens [B, 1]`` → ``(logits [B, 1, padded_vocab], cache)``: each
    decoder layer writes slot ``pos`` of its self-attention cache in place
    and attends to it, then its query (no RoPE, no bias) attends to all
    ``enc_seq`` cross-attention keys. Under a serving ``shard`` the params
    and both caches are the rank's blocks (module docstring) and the
    logits whole. The self-attention is ``models.lm``'s; the
    cross-attention reads the shard without ``"kv_seq"``, since every rank
    holds every frame of the cross cache (where the query heads are split
    and the kv heads whole, its queries are gathered over the group)."""
    x = L.embed(params["embed"], tokens, cfg.torch_dtype, shard)
    pos = cache["pos"]
    positions = pos.reshape(1, 1)
    cross_shard = (None if shard is None else
                   dataclasses.replace(shard, split=shard.split - {"kv_seq"}))
    _, norm = _norm(cfg)
    for i, lp in enumerate(_unstack(params["dec_layers"], cfg.n_layers)):
        h = norm(lp["norm1"], x)
        # the rank's query and kv heads, or the kv heads whole: local
        # products with the weights' blocks, as in models.lm.decode_step
        q, k, v = L.attn_qkv(lp["self"], h)
        q = L.rope(q, positions, base=cfg.rope_base)
        k = L.rope(k, positions, base=cfg.rope_base)
        kc, vc = cache["k"][i], cache["v"][i]
        write_kv(kc, vc, k, v, pos, shard)
        ctx = L.attention_decode(q, kc, vc, pos + 1, shard=shard)
        x = x + L.attn_out(lp["self"], ctx, shard=shard)
        h = norm(lp["norm2"], x)
        q = torch.einsum("bse,ehd->bshd", h, lp["cross"]["wq"].to(h.dtype))
        ctx = L.attention_decode(q, cache["ck"][i], cache["cv"][i], cfg.enc_seq,
                                 shard=cross_shard)
        x = x + L.attn_out(lp["cross"], ctx, shard=shard)
        h = norm(lp["norm3"], x)
        x = x + L.mlp(lp["mlp"], h, act=cfg.act, shard=shard)
    x = norm(params["final_norm"], x)
    logits = mask_pad_logits(L.unembed(params["embed"], x, shard), cfg)
    return logits, {**cache, "pos": pos + 1}
