"""Decoder-only transformer LM: the dense, MoE and VLM families
(counterpart of ``repro.models.lm``).

The parameter tree is the JAX package's: a dict with the same names, and
every per-layer leaf stacked on a leading ``n_layers`` axis
(``layers.attn.wq`` is ``[n_layers, d_model, heads, head_dim]``). The
sparsifier runs per leaf with ``k = sparsity_to_k(leaf_len, S)``, so the
stacking decides each leaf's length, k and selection; keeping it is what
lets the port be held against the JAX package leaf for leaf.

* ``dense``: GQA attention (QKV bias with ``qkv_bias``, half-rotary RoPE
  with ``rope_fraction``, sliding windows), SwiGLU or tanh-GeLU MLP,
  RMSNorm or LayerNorm;
* ``moe``: the MLP is ``nn.moe.moe_apply``, and its Switch aux loss,
  averaged over the layers, enters the loss times ``aux_loss_coef``;
* ``vlm``: ``vision_proj`` maps the vision stub's ``patches [B, P,
  vision_dim]`` to a prefix of the token embeddings; positions run over
  prefix and tokens, and the prefix is stripped before the unembedding.

``remat`` recomputes each block in the backward pass
(``torch.utils.checkpoint``), which keeps the values and frees the
activations inside the blocks.

Tensor parallelism (the families of ``TENSOR_PARALLEL``): ``loss_fn``,
``forward`` and the blocks take a ``shard`` (``nn.tensor_parallel.
ModelShard``) when the trainer's rank holds its model shard's block of
each leaf that ``nn.sharding`` splits over the model axis. Each layer
reads from the shard whether its own logical axis is split (the query
heads, the kv heads, the MLP's columns, the vocabulary rows), so the
divisibility guard decides leaf by leaf: qwen2.5-3b at M = 4 splits its
16 query heads and keeps its 2 kv heads whole. The MoE layer splits its
experts' FFN width or the experts themselves, as ``cfg.moe_parallelism``
laid them out, and its shared experts' width; its router stays whole
(``nn.moe``). The vision projection and the norms stay whole. The
vocabulary-parallel logits are gathered over the model group before the
loss, whose padding rows are masked by their global index as before.

Serving shards too (the families of ``SERVE_PARALLEL``, which are those
of ``TENSOR_PARALLEL``): ``prefill``, ``init_cache`` and ``decode_step``
take a serving rank's ``shard`` (``nn.sharding.serve_shard``), its
parameter blocks and its cache laid out by ``nn.sharding.serve_rules``.
Where the model axis divides the kv heads, each rank holds its kv heads
of the cache and attends locally; otherwise each holds its slots of
every kv head, writes the new token only into the slot it owns, and the
attention combines the ranks' partial softmaxes (``nn.layers.
attention_decode``). The embedding, the attention output, the MLP or MoE
and the logits are those of the forward.

Serving: ``forward(mode="chunked")`` (``prefill``) runs the online-softmax
attention over KV blocks of ``attn_block`` keys; ``init_cache`` and
``decode_step`` run one token at a time against a KV cache
``[n_layers, B, slots, kv_heads, head_dim]``, a ring of ``sliding_window``
slots when the config has a window. ``decode_step`` writes the new keys
and values into the cache tensors in place (a functional update would
copy the whole cache every token) and returns the cache with ``pos + 1``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.regtopk_score import const_div
from repro_torch.models.config import ModelConfig
from repro_torch.nn import layers as L
from repro_torch.nn import moe as M
from repro_torch.nn.sharding import prefix_axes

Params = Dict[str, Any]

# the families of this module whose forward the trainer shards over the
# model axis: all three
TENSOR_PARALLEL = frozenset({"dense", "moe", "vlm"})
# the families whose serve step takes a model shard, where the family is
# also in TENSOR_PARALLEL (models.registry.serve_parallel)
SERVE_PARALLEL = frozenset({"dense", "moe", "vlm"})


def _norm(cfg: ModelConfig):
    """``(init, apply)`` of the config's norm."""
    if cfg.norm == "rmsnorm":
        return L.rmsnorm_init, lambda p, x: L.rmsnorm(p, x, eps=cfg.norm_eps)
    if cfg.norm == "layernorm":
        return L.layernorm_init, lambda p, x: L.layernorm(p, x, eps=cfg.norm_eps)
    raise ValueError(f"unknown norm {cfg.norm!r}; available: rmsnorm, layernorm")


def _layer_init(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    ninit, _ = _norm(cfg)
    dt = cfg.torch_dtype
    attn = L.attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                       device, qkv_bias=cfg.qkv_bias, dtype=dt,
                       pad_to=cfg.pad_heads)
    if cfg.is_moe:
        mlp = M.moe_init(gen, cfg.d_model, cfg.d_ff, cfg.n_experts, device,
                         n_shared=cfg.n_shared_experts,
                         shared_d_ff=cfg.moe_shared_d_ff, dtype=dt)
    else:
        mlp = L.mlp_init(gen, cfg.d_model, cfg.d_ff, device, act=cfg.act,
                         dtype=dt)
    return {"attn": attn, "mlp": mlp, "norm1": ninit(cfg.d_model, device, dt),
            "norm2": ninit(cfg.d_model, device, dt)}


def _stack_layers(draw, n: int, device) -> Params:
    """``n`` layers, each drawn by ``draw()`` on the host in turn and
    copied into its slot of one tree whose leaves are stacked on axis 0 on
    ``device``: the host holds one layer at a time (deepseek-moe-16b's 28
    layers are 66.7 GB)."""
    first = draw()

    def empty(x):
        if isinstance(x, dict):
            return {key: empty(sub) for key, sub in x.items()}
        return torch.empty((n, *x.shape), dtype=x.dtype, device=device)

    def fill(dst, src, i):
        if isinstance(dst, dict):
            for key in dst:
                fill(dst[key], src[key], i)
        else:
            dst[i].copy_(src)

    out = empty(first)
    if torch.device(device).type != "meta":
        for i in range(n):
            fill(out, first if i == 0 else draw(), i)
    return out


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> Params:
    """Random weights drawn from ``torch.Generator().manual_seed(seed)``,
    with the JAX package's shapes and scales: the embedding, then layer by
    layer its attention and MLP (or MoE) weights, then ``vision_proj``.
    The layers are drawn on the host one at a time and copied into the
    stacked tensors on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    dt = cfg.torch_dtype
    host = "meta" if torch.device(device).type == "meta" else "cpu"
    ninit, _ = _norm(cfg)
    params = {
        "embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model, device,
                              dtype=dt),
        "layers": _stack_layers(lambda: _layer_init(gen, cfg, host),
                                cfg.n_layers, device),
        "final_norm": ninit(cfg.d_model, device, dt),
    }
    if cfg.family == "vlm":
        params["vision_proj"] = L.linear_init(
            gen, cfg.vision_dim, cfg.d_model, device, bias=True, dtype=dt)
    return params


def _norm_axes(cfg: ModelConfig) -> Params:
    return L.rmsnorm_axes() if cfg.norm == "rmsnorm" else L.layernorm_axes()


def param_axes(cfg: ModelConfig) -> Params:
    """The logical axes of ``init(cfg)``'s tree, the tree the JAX
    ``init`` returns beside the parameters (nothing drawn): each layer's
    under a leading ``"layers"``; the MoE experts by
    ``cfg.moe_parallelism``."""
    layer = {"attn": L.attn_axes(qkv_bias=cfg.qkv_bias),
             "mlp": (M.moe_axes(n_shared=cfg.n_shared_experts,
                                parallelism=cfg.moe_parallelism)
                     if cfg.is_moe else L.mlp_axes(act=cfg.act)),
             "norm1": _norm_axes(cfg), "norm2": _norm_axes(cfg)}
    axes = {"embed": L.embed_axes(), "layers": prefix_axes(layer),
            "final_norm": _norm_axes(cfg)}
    if cfg.family == "vlm":
        axes["vision_proj"] = L.linear_axes(None, "embed", bias=True)
    return axes


def _unstack(params_layers: Params, n: int):
    """The ``n`` layers of the stacked tree, as views: one ``unbind`` a
    leaf, whose backward stacks the layers' gradients once (indexing each
    layer would add every layer's gradient into a zero tensor of the
    whole stack)."""
    if isinstance(params_layers, dict):
        subs = {key: _unstack(sub, n) for key, sub in params_layers.items()}
        return [{key: sub[i] for key, sub in subs.items()} for i in range(n)]
    return list(params_layers.unbind(0))


def _block(
    lp: Params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
    mode: str = "dense", shard=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder block: ``(x, aux)``, aux 0 outside the MoE family.
    ``mode`` is the attention: "dense" or "chunked"; ``shard`` the
    rank's model shard (module docstring)."""
    _, norm = _norm(cfg)
    h = norm(lp["norm1"], x)
    q, k, v = L.attn_qkv(lp["attn"], h, shard=shard)
    q = L.rope(q, positions, base=cfg.rope_base, fraction=cfg.rope_fraction)
    k = L.rope(k, positions, base=cfg.rope_base, fraction=cfg.rope_fraction)
    ctx = attend(q, k, v, cfg, mode, causal=True, window=cfg.sliding_window)
    x = x + L.attn_out(lp["attn"], ctx, shard=shard)
    h = norm(lp["norm2"], x)
    if cfg.is_moe:
        y, aux = M.moe_apply(
            lp["mlp"], h, top_k=cfg.moe_top_k,
            capacity_factor=cfg.capacity_factor,
            group_size=cfg.moe_group_size, dispatch=cfg.moe_dispatch,
            shard=shard,
        )
    else:
        y = L.mlp(lp["mlp"], h, act=cfg.act, shard=shard)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y, aux


def attend(q, k, v, cfg: ModelConfig, mode: str, *, causal: bool,
           window=None) -> torch.Tensor:
    """``attention_dense``, or ``attention_chunked`` over KV blocks of
    ``cfg.attn_block`` keys."""
    if mode == "chunked":
        return L.attention_chunked(q, k, v, causal=causal, window=window,
                                   block=cfg.attn_block)
    if mode == "dense":
        return L.attention_dense(q, k, v, causal=causal, window=window)
    raise ValueError(f"unknown attention mode {mode!r}; available: dense, chunked")


def run_block(block, *args, remat: bool):
    """``block(*args)``; under ``remat`` recomputed in the backward pass
    (``torch.utils.checkpoint``), so only its inputs are kept."""
    if remat:
        return checkpoint(block, *args, use_reentrant=False)
    return block(*args)


def _stack(params_layers: Params, x: torch.Tensor, cfg: ModelConfig,
           positions: torch.Tensor, mode: str = "dense", shard=None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The blocks in layer order; the aux losses summed in layer order
    and divided by the layer count as the jitted scan does
    (``const_div``)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in _unstack(params_layers, cfg.n_layers):
        x, a = run_block(_block, lp, x, cfg, positions, mode, shard,
                         remat=cfg.remat)
        aux = aux + a
    return x, const_div(aux, float(cfg.n_layers))


def _embed_inputs(params: Params, cfg: ModelConfig, batch, shard=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x [B, S', E], positions [S'])``: the token embeddings, behind
    the projected patch prefix for the VLM family (its projection whole
    on every rank of a model group)."""
    x = L.embed(params["embed"], batch["tokens"], cfg.torch_dtype, shard)
    if cfg.family == "vlm":
        vis = L.linear(params["vision_proj"],
                       batch["patches"].to(cfg.torch_dtype))
        x = torch.cat([vis, x], dim=1)
    return x, torch.arange(x.shape[1], device=x.device)


def forward(params: Params, cfg: ModelConfig, batch, *, mode: str = "dense",
            shard=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(logits [B, S, padded_vocab], aux)`` over the token positions
    (the VLM prefix stripped); ``mode`` is the attention, "dense" or
    "chunked"; under ``shard`` the rank's blocks, the logits whole."""
    x, positions = _embed_inputs(params, cfg, batch, shard)
    x, aux = _stack(params["layers"], x, cfg, positions, mode, shard)
    _, norm = _norm(cfg)
    x = norm(params["final_norm"], x)
    if cfg.family == "vlm":
        x = x[:, -batch["tokens"].shape[1]:]
    return L.unembed(params["embed"], x, shard), aux


def mask_pad_logits(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Remove the vocab-padding rows from the softmax support."""
    if cfg.padded_vocab == cfg.vocab:
        return logits
    bad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab
    return logits.masked_fill(bad, L.NEG_INF)


def loss_fn(params: Params, cfg: ModelConfig, batch, shard=None
            ) -> Tuple[torch.Tensor, Dict]:
    """Mean next-token cross-entropy plus ``aux_loss_coef`` times the
    layers' mean aux loss (0 outside the MoE family); metrics ``{"nll",
    "aux"}``. ``shard``: the rank's model shard, for a family of
    ``TENSOR_PARALLEL`` (module docstring)."""
    logits, aux = forward(params, cfg, batch, shard=shard)
    nll = token_nll(logits, cfg, batch["labels"])
    return total_loss(nll, aux, cfg.aux_loss_coef), {"nll": nll, "aux": aux}


def token_nll(logits: torch.Tensor, cfg: ModelConfig, labels: torch.Tensor
              ) -> torch.Tensor:
    """Mean cross-entropy of ``labels`` under ``logits``, in float32 and
    over the real vocabulary (the padding rows masked)."""
    logits = mask_pad_logits(logits.float(), cfg)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (logz - gold).mean()


def total_loss(nll: torch.Tensor, aux: torch.Tensor, coef: float) -> torch.Tensor:
    """``nll + coef * aux`` rounded once: XLA:CPU contracts the JAX loss
    into a fused multiply-add under ``jit``, and ``torch.addcmul`` rounds
    once on the CPU and on the card."""
    return torch.addcmul(nll, torch.full((), coef, dtype=aux.dtype,
                                         device=aux.device), aux)


# ---------------------------------------------------------------------------
# serving: prefill and one-token decode against a KV cache
# ---------------------------------------------------------------------------
@torch.no_grad()
def prefill(params: Params, cfg: ModelConfig, batch, shard=None) -> torch.Tensor:
    """Logits of the prompt through the chunked attention (the cache is
    built by ``init_cache``, not here, as in the JAX package); under a
    ``shard`` from the rank's blocks, the logits whole."""
    return forward(params, cfg, batch, mode="chunked", shard=shard)[0]


def ringless_kv(cfg: ModelConfig) -> List[str]:
    """The KV caches that have no ring, so hold ``max_len`` steps at most:
    a sliding-window config keeps a ring of ``window`` slots."""
    return [] if cfg.sliding_window else ["k", "v"]


def cache_slots(cfg: ModelConfig, max_len: int) -> int:
    return max_len if ringless_kv(cfg) else min(max_len, cfg.sliding_window)


def _splits(shard, axis: str) -> int:
    """The shards ``axis`` is split into: ``shard.size`` where it splits
    it, else 1."""
    return shard.size if shard is not None and shard.splits(axis) else 1


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda",
               shard=None) -> Dict:
    """Zero KV cache ``k``, ``v`` ``[n_layers, B, slots, kv_heads,
    head_dim]`` and ``pos``, a 0-d int32 tensor on ``device`` (the JAX
    tree; ``k`` and ``v`` are two tensors, since the step writes them in
    place). Under a serving ``shard`` the rank's block: its slots where
    ``"kv_seq"`` is split, its kv heads where ``"kv_heads"`` is."""
    shape = (cfg.n_layers, batch,
             cache_slots(cfg, max_len) // _splits(shard, "kv_seq"),
             cfg.eff_kv_heads // _splits(shard, "kv_heads"), cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def cache_axes(cfg: ModelConfig) -> Dict:
    ax = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    return {"k": ax, "v": ax, "pos": ()}


def write_kv(cache_k: torch.Tensor, cache_v: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor, at: torch.Tensor, shard=None) -> None:
    """Write one token's ``k``, ``v`` ``[B, 1, kv_heads, head_dim]`` into
    slot ``at`` (a 0-d device tensor) of one layer's cache ``[B, slots,
    kv_heads, head_dim]``, in place. The slot must exist: the JAX
    package's ``dynamic_update_slice`` clamps a start past the end into
    the last slot, and an index past the end is an error here (on the
    card a device-side assert), so callers keep ``at < slots``
    (``launch.serve.run`` refuses a request that would not).

    Under a ``shard`` that splits ``"kv_seq"`` the cache holds the rank's
    slots ``[r S, (r + 1) S)`` and ``at`` is global: the rank that owns it
    writes its local slot, and every other rank writes its slot 0 back
    unchanged, chosen on the device (nothing is read on the host)."""
    if shard is None or not shard.splits("kv_seq"):
        idx = at.reshape(1).long()
        cache_k.index_copy_(1, idx, k)
        cache_v.index_copy_(1, idx, v)
        return
    local = at.reshape(1).long() - shard.index * cache_k.shape[1]
    mine = (local >= 0) & (local < cache_k.shape[1])
    idx = torch.where(mine, local, 0)
    for cache, new in ((cache_k, k), (cache_v, v)):
        cache.index_copy_(1, idx, torch.where(mine, new,
                                              cache.index_select(1, idx)))


@torch.no_grad()
def decode_step(params: Params, cfg: ModelConfig, cache: Dict,
                tokens: torch.Tensor, shard=None) -> Tuple[torch.Tensor, Dict]:
    """``tokens [B, 1]`` → ``(logits [B, 1, padded_vocab], cache)``, the
    vocabulary padding masked. Writes slot ``pos % slots`` with a window
    (a ring: every filled slot attends, and the keys keep their absolute
    RoPE) and slot ``pos`` without one, in place, and reads nothing on the
    host. The MoE runs with ``no_drop=True`` and the default dispatch, as
    the JAX step calls it. Under a serving ``shard`` the params and the
    cache are the rank's blocks (module docstring) and the logits whole."""
    x = L.embed(params["embed"], tokens, cfg.torch_dtype, shard)
    pos = cache["pos"]
    slots = cache["k"].shape[2] * _splits(shard, "kv_seq")
    write_at = pos if ringless_kv(cfg) else pos % slots
    filled = torch.clamp(pos + 1, max=slots)
    positions = pos.reshape(1, 1)
    _, norm = _norm(cfg)
    for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
        h = norm(lp["norm1"], x)
        # the rank's query heads and its kv heads, or the whole kv heads:
        # each a local product with the weight's block (entering the model
        # group is the identity without a backward)
        q, k, v = L.attn_qkv(lp["attn"], h)
        q = L.rope(q, positions, base=cfg.rope_base, fraction=cfg.rope_fraction)
        k = L.rope(k, positions, base=cfg.rope_base, fraction=cfg.rope_fraction)
        kc, vc = cache["k"][i], cache["v"][i]
        write_kv(kc, vc, k, v, write_at, shard)
        ctx = L.attention_decode(q, kc, vc, filled, window=None, shard=shard)
        x = x + L.attn_out(lp["attn"], ctx, shard=shard)
        h = norm(lp["norm2"], x)
        if cfg.is_moe:
            y, _ = M.moe_apply(
                lp["mlp"], h, top_k=cfg.moe_top_k,
                capacity_factor=cfg.capacity_factor,
                group_size=cfg.moe_group_size, no_drop=True, shard=shard,
            )
        else:
            y = L.mlp(lp["mlp"], h, act=cfg.act, shard=shard)
        x = x + y
    x = norm(params["final_norm"], x)
    logits = mask_pad_logits(L.unembed(params["embed"], x, shard), cfg)
    return logits, {**cache, "pos": pos + 1}
