"""SSM and hybrid models: mamba2-780m (pure SSD) and zamba2-7b (hybrid)
(counterpart of ``repro.models.ssm``).

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

Tensor parallelism (the families of ``TENSOR_PARALLEL``: both):
``loss_fn``, ``forward`` and the blocks take a ``shard``
(``nn.tensor_parallel.ModelShard``) when the trainer's rank holds its
model shard's block of each leaf that ``nn.sharding`` splits over the
model axis. The mamba mixer runs on the rank's ``"d_inner"`` channels
and ``"ssm_heads"`` (``nn.ssd``); the shared block's attention and MLP on
its heads and columns, as ``models.lm``'s blocks (its gradient the sum
of the rank's blocks over its ``n_groups`` applications); the embedding
and the unembedding on its vocabulary rows, the logits gathered over the
model group before the loss. The norms stay whole.

Serving shards too (the families of ``SERVE_PARALLEL``: both):
``prefill``, ``init_cache`` and ``decode_step`` take a serving rank's
``shard`` (``nn.sharding.serve_shard``), its parameter blocks and its
cache laid out by ``nn.sharding.serve_rules``. Each mamba block's conv
window holds the rank's contiguous block of the conv channels and its
SSM state the rank's heads, and the decode step gathers activations
(``nn.ssd``); the shared block's KV cache holds the rank's kv heads, or
its slots of every kv head, and attends as ``models.lm``'s decode step
does. The logits come out whole.

Serving: the decode cache holds each mamba block's conv window and SSM
state (``grouped.*`` on ``[n_groups, per_group, ...]``, ``trailing.*`` on
``[n_trailing, ...]``) and one KV cache per application of the shared
block (``attn_k``, ``attn_v`` on ``[n_groups, ...]``); ``decode_step``
writes all of them in place.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import (
    _splits, _stack_layers, _unstack, attend, mask_pad_logits, run_block,
    token_nll, write_kv)
from repro_torch.nn import layers as L
from repro_torch.nn import ssd
from repro_torch.nn.sharding import prefix_axes

Params = Dict[str, Any]

# the families of this module whose forward the trainer shards over the
# model axis: both
TENSOR_PARALLEL = frozenset({"ssm", "hybrid"})
# the families whose serve step takes a model shard, where the family is
# also in TENSOR_PARALLEL (models.registry.serve_parallel): both
SERVE_PARALLEL = frozenset({"ssm", "hybrid"})


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


def _regroup(tree: Params, n_groups: int, per_group: int) -> Params:
    """Each leaf's stacked axis ``[n_groups * per_group]`` as ``[n_groups,
    per_group]`` (a view)."""
    if isinstance(tree, dict):
        return {key: _regroup(sub, n_groups, per_group)
                for key, sub in tree.items()}
    return tree.view(n_groups, per_group, *tree.shape[1:])


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> Params:
    """Random weights drawn from ``torch.Generator().manual_seed(seed)``,
    with the JAX package's shapes and scales: the embedding, the grouped
    mamba blocks, the shared block, the trailing blocks. Blocks are drawn
    on the host one at a time and copied into the stacked tensors on
    ``device``."""
    gen = torch.Generator().manual_seed(seed)
    dt = cfg.torch_dtype
    host = "meta" if torch.device(device).type == "meta" else "cpu"
    n_groups, per_group, trailing = _plan(cfg)
    params: Params = {"embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                            device, dtype=dt)}
    if n_groups * per_group:
        flat = _stack_layers(lambda: _mamba_init(gen, cfg, host),
                             n_groups * per_group, device)
        params["grouped"] = _regroup(flat, n_groups, per_group)
        params["shared_attn"] = _attn_block_init(gen, cfg, device)
    if trailing:
        params["trailing"] = _stack_layers(lambda: _mamba_init(gen, cfg, host),
                                           trailing, device)
    params["final_norm"] = L.rmsnorm_init(cfg.d_model, device, dt)
    return params


def param_axes(cfg: ModelConfig) -> Params:
    """The logical axes of ``init(cfg)``'s tree, the tree the JAX
    ``init`` returns beside the parameters (nothing drawn): ``grouped.*``
    under ``("layers", "blocks")``, ``trailing.*`` under ``"layers"``."""
    n_groups, per_group, trailing = _plan(cfg)
    mamba = {"mixer": ssd.ssd_axes(), "norm": L.rmsnorm_axes()}
    axes: Params = {"embed": L.embed_axes()}
    if n_groups * per_group:
        axes["grouped"] = prefix_axes(prefix_axes(mamba, "blocks"), "layers")
        axes["shared_attn"] = {"attn": L.attn_axes(),
                               "mlp": L.mlp_axes(act=cfg.act),
                               "norm1": L.rmsnorm_axes(),
                               "norm2": L.rmsnorm_axes()}
    if trailing:
        axes["trailing"] = prefix_axes(mamba)
    axes["final_norm"] = L.rmsnorm_axes()
    return axes


def _mamba_block(lp: Params, x: torch.Tensor, cfg: ModelConfig, cache=None,
                 shard=None):
    """``(x, new_cache)``: the chunked scan without a cache (new_cache
    None), one decode step with one; ``shard`` the rank's model shard
    (module docstring)."""
    h = L.rmsnorm(lp["norm"], x, eps=cfg.norm_eps)
    y, new_cache = ssd.ssd_block_apply(
        lp["mixer"], h, d_inner=cfg.d_inner, headdim=cfg.ssm_headdim,
        d_state=cfg.ssm_state, chunk=cfg.ssm_chunk, cache=cache,
        norm_eps=cfg.norm_eps, shard=shard)
    return x + y, new_cache


def _mamba_x(lp: Params, x: torch.Tensor, cfg: ModelConfig, shard=None
             ) -> torch.Tensor:
    return _mamba_block(lp, x, cfg, shard=shard)[0]


def _attn_block(lp: Params, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, mode: str = "dense", shard=None
                ) -> torch.Tensor:
    h = L.rmsnorm(lp["norm1"], x, eps=cfg.norm_eps)
    q, k, v = L.attn_qkv(lp["attn"], h, shard=shard)
    q = L.rope(q, positions, base=cfg.rope_base)
    k = L.rope(k, positions, base=cfg.rope_base)
    ctx = attend(q, k, v, cfg, mode, causal=True)
    x = x + L.attn_out(lp["attn"], ctx, shard=shard)
    h = L.rmsnorm(lp["norm2"], x, eps=cfg.norm_eps)
    return x + L.mlp(lp["mlp"], h, act=cfg.act, shard=shard)


def forward(params: Params, cfg: ModelConfig, batch, *, mode: str = "dense",
            shard=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(logits [B, S, padded_vocab], aux)``, aux 0 (no aux loss);
    ``mode`` is the shared block's attention, "dense" or "chunked"; under
    ``shard`` the rank's blocks, the logits whole."""
    x = L.embed(params["embed"], batch["tokens"], cfg.torch_dtype, shard)
    positions = torch.arange(x.shape[1], device=x.device)
    n_groups, per_group, trailing = _plan(cfg)
    if n_groups:
        shared = params["shared_attn"]
        for group in _unstack(params["grouped"], n_groups):
            for lp in _unstack(group, per_group):
                x = run_block(_mamba_x, lp, x, cfg, shard, remat=cfg.remat)
            x = run_block(_attn_block, shared, x, cfg, positions, mode, shard,
                          remat=cfg.remat)
    if trailing:
        for lp in _unstack(params["trailing"], trailing):
            x = run_block(_mamba_x, lp, x, cfg, shard, remat=cfg.remat)
    x = L.rmsnorm(params["final_norm"], x, eps=cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return L.unembed(params["embed"], x, shard), aux


def loss_fn(params: Params, cfg: ModelConfig, batch, shard=None
            ) -> Tuple[torch.Tensor, Dict]:
    """Mean next-token cross-entropy, with no aux term; metrics ``{"nll",
    "aux"}``. ``shard``: the rank's model shard (module docstring)."""
    logits, aux = forward(params, cfg, batch, shard=shard)
    nll = token_nll(logits, cfg, batch["labels"])
    return nll, {"nll": nll, "aux": aux}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
@torch.no_grad()
def prefill(params: Params, cfg: ModelConfig, batch, shard=None) -> torch.Tensor:
    """Logits of the prompt through the chunked scan and attention (the
    cache is built by ``init_cache``, not here, as in the JAX package);
    under a ``shard`` from the rank's blocks, the logits whole."""
    return forward(params, cfg, batch, mode="chunked", shard=shard)[0]


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda",
               shard=None) -> Dict:
    """Zero decode state in the JAX tree: ``pos``; ``grouped.{conv,ssm}``
    on ``[n_groups, per_group, ...]`` and ``attn_k``, ``attn_v``
    ``[n_groups, B, max_len, kv_heads, head_dim]`` for the hybrid;
    ``trailing.{conv,ssm}`` on ``[n_trailing, ...]``. Under a serving
    ``shard`` the rank's blocks: its block of the conv channels and its
    SSM heads where ``"d_inner"`` is split, its slots where ``"kv_seq"``
    is, its kv heads where ``"kv_heads"`` is."""
    n_groups, per_group, trailing = _plan(cfg)
    dt = cfg.torch_dtype

    def ssm_cache(*lead):
        one = ssd.ssd_init_cache(batch, cfg.d_inner, cfg.ssm_headdim,
                                 cfg.ssm_state, "meta", dt,
                                 shards=_splits(shard, "d_inner"))
        return {name: torch.zeros((*lead, *x.shape), dtype=dt, device=device)
                for name, x in one.items()}

    cache: Dict[str, Any] = {"pos": torch.zeros((), dtype=torch.int32,
                                                device=device)}
    if n_groups:
        cache["grouped"] = ssm_cache(n_groups, per_group)
        kv = (n_groups, batch, max_len // _splits(shard, "kv_seq"),
              cfg.eff_kv_heads // _splits(shard, "kv_heads"), cfg.hd)
        cache["attn_k"] = torch.zeros(kv, dtype=dt, device=device)
        cache["attn_v"] = torch.zeros(kv, dtype=dt, device=device)
    if trailing:
        cache["trailing"] = ssm_cache(trailing)
    return cache


def ringless_kv(cfg: ModelConfig) -> List[str]:
    """The KV caches that have no ring, so hold ``max_len`` steps at most:
    the shared attention block's, where the config has one."""
    return ["attn_k", "attn_v"] if _plan(cfg)[0] else []


def cache_axes(cfg: ModelConfig) -> Dict:
    n_groups, per_group, trailing = _plan(cfg)
    sax = {
        "conv": ("batch", "conv", "d_inner"),
        "ssm": ("batch", "ssm_heads", None, "ssm_state"),
    }
    ax: Dict[str, Any] = {"pos": ()}
    if n_groups:
        ax["grouped"] = {name: ("layers", "blocks") + a for name, a in sax.items()}
        ax["attn_k"] = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
        ax["attn_v"] = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    if trailing:
        ax["trailing"] = {name: ("layers",) + a for name, a in sax.items()}
    return ax


def _mamba_step(lp: Params, x: torch.Tensor, cfg: ModelConfig, conv, ssm_state,
                shard=None) -> torch.Tensor:
    """One mamba block's decode step; its conv window and SSM state (the
    rank's blocks under a ``shard``) written in place."""
    x, new = _mamba_block(lp, x, cfg, cache={"conv": conv, "ssm": ssm_state},
                          shard=shard)
    conv.copy_(new["conv"])
    ssm_state.copy_(new["ssm"])
    return x


@torch.no_grad()
def decode_step(params: Params, cfg: ModelConfig, cache: Dict,
                tokens: torch.Tensor, shard=None) -> Tuple[torch.Tensor, Dict]:
    """``tokens [B, 1]`` → ``(logits [B, 1, padded_vocab], cache)``: the
    blocks in the forward's order, each mamba block one step of its
    recurrence, each application of the shared block writing slot ``pos``
    of its KV cache; every cache tensor written in place, and the cache
    returned with ``pos + 1``. Under a serving ``shard`` the params and
    the cache are the rank's blocks (module docstring) and the logits
    whole."""
    x = L.embed(params["embed"], tokens, cfg.torch_dtype, shard)
    pos = cache["pos"]
    positions = pos.reshape(1, 1)
    n_groups, per_group, trailing = _plan(cfg)
    if n_groups:
        shared = params["shared_attn"]
        gc = cache["grouped"]
        for g, group in enumerate(_unstack(params["grouped"], n_groups)):
            for j, lp in enumerate(_unstack(group, per_group)):
                x = _mamba_step(lp, x, cfg, gc["conv"][g, j], gc["ssm"][g, j],
                                shard)
            h = L.rmsnorm(shared["norm1"], x, eps=cfg.norm_eps)
            # the rank's query heads and its kv heads, or the whole kv
            # heads, as in models.lm's decode step
            q, k, v = L.attn_qkv(shared["attn"], h)
            q = L.rope(q, positions, base=cfg.rope_base)
            k = L.rope(k, positions, base=cfg.rope_base)
            kc, vc = cache["attn_k"][g], cache["attn_v"][g]
            write_kv(kc, vc, k, v, pos, shard)
            ctx = L.attention_decode(q, kc, vc, pos + 1, shard=shard)
            x = x + L.attn_out(shared["attn"], ctx, shard=shard)
            h = L.rmsnorm(shared["norm2"], x, eps=cfg.norm_eps)
            x = x + L.mlp(shared["mlp"], h, act=cfg.act, shard=shard)
    if trailing:
        tc = cache["trailing"]
        for i, lp in enumerate(_unstack(params["trailing"], trailing)):
            x = _mamba_step(lp, x, cfg, tc["conv"][i], tc["ssm"][i], shard)
    x = L.rmsnorm(params["final_norm"], x, eps=cfg.norm_eps)
    logits = mask_pad_logits(L.unembed(params["embed"], x, shard), cfg)
    return logits, {**cache, "pos": pos + 1}
