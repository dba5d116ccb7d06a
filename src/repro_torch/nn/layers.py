"""Core layers of the decoder block (counterpart of ``repro.nn.layers``).

Parameters are plain dicts of tensors with the JAX package's names and
layouts, so a weight tree moves between the two stacks name for name
(``repro_torch.convert``). Activations are ``x [B, S, E]``; attention
heads ``[B, S, H, Dh]``. Every ``*_init`` draws from an explicit CPU
``torch.Generator`` and moves the result to ``device``, so a seed gives
the same weights on any device. Beside each ``*_init``, a ``*_axes``
returns the logical axes that the JAX ``*_init`` returns with its
parameters (``nn.sharding`` resolves them on a mesh).

The attention projections, the MLP, the embedding and the unembedding
take an optional ``shard`` (a ``tensor_parallel.ModelShard``): where it
splits the function's logical axis (``"heads"``, ``"mlp"``, ``"vocab"``),
the function's leaves are this rank's blocks and it enters and leaves
the model group around its product (``nn.tensor_parallel``), as GSPMD
partitions the JAX forward. Without one, or where its axis stays whole,
the function is the one-process function.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels.regtopk_score import const_div
from repro_torch.nn import tensor_parallel as TP

Params = Dict[str, torch.Tensor]

NEG_INF = -1e30


def set_fp32_matmul() -> None:
    """Run float32 matrix products and convolutions in full float32 on the
    card: TF32 keeps about three decimal digits, and the port is held
    against a float32 reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _normal(gen: torch.Generator, shape, scale: float, device,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn on the host from ``gen`` and moved to
    ``device``; on the ``meta`` device only the shape (nothing drawn)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    # scaled in place: the same bits as ``scale * x``, a pass and an
    # allocation fewer (a whole model's draws are host-bound)
    return torch.randn(shape, generator=gen).mul_(scale).to(device, dtype)


# ---------------------------------------------------------------------------
# linear
# ---------------------------------------------------------------------------
def linear_init(
    gen: torch.Generator, in_dim: int, out_dim: int, device, *,
    bias: bool = False, dtype: torch.dtype = torch.float32,
    scale: Optional[float] = None,
) -> Params:
    scale = (in_dim**-0.5) if scale is None else scale
    p = {"w": _normal(gen, (in_dim, out_dim), scale, device, dtype)}
    if bias:
        p["b"] = torch.zeros(out_dim, dtype=dtype, device=device)
    return p


def linear_axes(in_ax: Optional[str], out_ax: Optional[str], *,
                bias: bool = False) -> Dict[str, tuple]:
    a = {"w": (in_ax, out_ax)}
    if bias:
        a["b"] = (out_ax,)
    return a


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rmsnorm_init(dim: int, device, dtype: torch.dtype = torch.float32) -> Params:
    return {"scale": torch.ones(dim, dtype=dtype, device=device)}


def rmsnorm_axes() -> Dict[str, tuple]:
    return {"scale": ("embed",)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps).to(x.dtype)
    return y * p["scale"].to(x.dtype)


def layernorm_init(dim: int, device, dtype: torch.dtype = torch.float32) -> Params:
    return {"scale": torch.ones(dim, dtype=dtype, device=device),
            "bias": torch.zeros(dim, dtype=dtype, device=device)}


def layernorm_axes() -> Dict[str, tuple]:
    return {"scale": ("embed",), "bias": ("embed",)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The variance is the population variance over the last axis
    (``unbiased=False``), as ``jnp.var`` takes it."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (full-dim, or the half-dim "2d" style with fraction=0.5)
# ---------------------------------------------------------------------------
def rope(
    x: torch.Tensor,  # [B, S, H, Dh]
    positions: torch.Tensor,  # [B, S] or [S]
    *,
    base: float = 10000.0,
    fraction: float = 1.0,
) -> torch.Tensor:
    d = x.shape[-1]
    rot = int(d * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    half = rot // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=x.device)
    freq = torch.pow(base, -ar / half)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freq  # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out, x_pass], dim=-1) if rot < d else out


# ---------------------------------------------------------------------------
# attention cores: dense, chunked online softmax (prefill), cached (decode)
# ---------------------------------------------------------------------------
def attn_scale(x: torch.Tensor, head_dim: int) -> torch.Tensor:
    """``x / sqrt(head_dim)`` as the jitted reference computes it: a
    product with the float32 reciprocal of the float32 constant
    (:func:`const_div`), which differs from the IEEE quotient in the last
    bit of about 41% of float32 values at ``head_dim = 32``."""
    return const_div(x, head_dim**0.5)


def _expand_kv(k: torch.Tensor, n_heads: int, first: int = 0,
               group: Optional[int] = None) -> torch.Tensor:
    """GQA: repeat kv heads to match query heads. k: [B, S, Kh, Dh].
    Given ``group`` (query heads per kv head over the whole model), the
    ``n_heads`` query heads are global heads ``first ...`` of a rank's
    block, each reading kv head ``(first + j) // group`` of the whole
    ``k``: GQA groups by the global head index."""
    kh = k.shape[-2]
    if group is not None:
        idx = (first + torch.arange(n_heads, device=k.device)) // group
        return k.index_select(-2, idx)
    if kh == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // kh, dim=-2)


def _mask_bias(
    q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
    window: Optional[int],
) -> torch.Tensor:
    """Additive bias [Sq, Sk] from causality / sliding window."""
    ok = torch.ones(
        (q_pos.shape[-1], k_pos.shape[-1]), dtype=torch.bool,
        device=q_pos.device,
    )
    if causal:
        ok &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        ok &= q_pos[:, None] - k_pos[None, :] < window
    return torch.where(ok, 0.0, NEG_INF)


def attention_dense(
    q: torch.Tensor,  # [B, Sq, H, Dh]
    k: torch.Tensor,  # [B, Sk, Kh, Dh]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    H, Dh = q.shape[-2], q.shape[-1]
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    scores = attn_scale(torch.einsum("bqhd,bkhd->bhqk", q, k), Dh)
    q_pos = torch.arange(q.shape[1], device=q.device)
    k_pos = torch.arange(k.shape[1], device=q.device)
    if causal or window is not None:
        scores = scores + _mask_bias(q_pos, k_pos, causal, window).to(
            scores.dtype
        )
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention_chunked(
    q: torch.Tensor,  # [B, Sq, H, Dh]
    k: torch.Tensor,  # [B, Sk, Kh, Dh]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    block: int = 1024,
) -> torch.Tensor:
    """Online softmax over KV blocks of ``block`` keys, so the live scores
    are ``[B, H, Sq, block]`` (prefill). As the JAX package: the last
    block is zero-padded and its keys at or past ``Sk`` masked; ``q`` is
    scaled, not the scores; the running max, sum and accumulator are
    float32; a block whose keys are all masked for a row adds weight 1
    per key while the row's max is still ``NEG_INF``, which the first
    unmasked block's correction ``exp(NEG_INF - m)`` zeroes."""
    B, Sq, H, Dh = q.shape
    Sk = k.shape[1]
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    nblk = -(-Sk // block)
    pad = nblk * block - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    q_pos = torch.arange(Sq, device=q.device)
    qs = attn_scale(q, Dh)
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, Dh), dtype=torch.float32, device=q.device)
    for i in range(nblk):
        kblk = k[:, i * block:(i + 1) * block]
        vblk = v[:, i * block:(i + 1) * block]
        k_pos = i * block + torch.arange(block, device=q.device)
        s = torch.einsum("bqhd,bkhd->bhqk", qs, kblk)
        ok = k_pos[None, :] < Sk
        if causal:
            ok = ok & (q_pos[:, None] >= k_pos[None, :])
        if window is not None:
            ok = ok & (q_pos[:, None] - k_pos[None, :] < window)
        s = torch.where(ok, s.float(), NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(q.dtype), vblk).float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)  # [B, Sq, H, Dh]


def attention_decode(
    q: torch.Tensor,  # [B, 1, H, Dh]
    k_cache: torch.Tensor,  # [B, S, Kh, Dh]
    v_cache: torch.Tensor,
    cache_len: Union[torch.Tensor, int],  # filled length, the new token's key included
    *,
    window: Optional[int] = None,
    shard: Optional[TP.ModelShard] = None,
) -> torch.Tensor:
    """One query token over the cache's first ``cache_len`` slots (a 0-d
    device tensor, so the step reads no value on the host), the last
    ``window`` of them when given. Each group of ``H / Kh`` query heads
    attends to its KV head of the cache in place (the JAX package repeats
    the KV heads; a repeated cache would be ``H / Kh`` times the cache's
    bytes each layer and step).

    Under a serving ``shard`` (``nn.sharding.serve_rules``), ``q`` holds
    the rank's query heads where ``"heads"`` is split, and the result its
    heads' context. Where the kv heads are split, the cache holds the
    rank's kv heads, whose GQA groups are its query heads: the attention
    is local. Otherwise the cache's kv heads are whole: the query heads
    are gathered over the group, and where ``"kv_seq"`` is split the cache
    holds the rank's slots ``[r S, (r + 1) S)`` of the global ``cache_len``
    mask. Each rank then computes, in float32 over its slots, the max
    score ``m``, the sum ``l`` and the unnormalised context ``o``; the ranks'
    ``(m, l, o)`` are gathered and combined in shard order by the same
    expression on every rank, so every rank holds the same bits. A rank
    whose slots are all masked has ``m = NEG_INF`` (finite), so its weight
    ``exp(m - max m)`` is 0."""
    if shard is None or shard.splits("kv_heads") or not (
            shard.splits("heads") or shard.splits("kv_seq")):
        return _decode_core(q, k_cache, v_cache, cache_len, window)
    heads = q.shape[-2]
    if shard.splits("heads"):
        q = torch.cat(TP.gather(q, shard).unbind(0), dim=-2)
    if shard.splits("kv_seq"):
        first = shard.index * k_cache.shape[1]
        m, l, o = _decode_partial(q, k_cache, v_cache, cache_len, window, first)
        parts = TP.gather(torch.cat([m, l, o], dim=-1), shard)
        m, l, o = parts[..., :1], parts[..., 1:2], parts[..., 2:]
        w = torch.exp(m - m.amax(0))  # 0 for a rank with no filled slot
        o = (o * w).sum(0) / (l * w).sum(0)  # [B, Kh, G, Sq, Dh]
        B, Kh, G, Sq, Dh = o.shape
        ctx = o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Kh * G, Dh).to(q.dtype)
    else:
        ctx = _decode_core(q, k_cache, v_cache, cache_len, window)
    if shard.splits("heads"):
        ctx = ctx[:, :, shard.index * heads:(shard.index + 1) * heads]
    return ctx


def _decode_scores(q, k_cache, cache_len, window, first: int = 0):
    """The masked float32 scores ``[B, Kh, H / Kh, Sq, S]`` of the cache's
    slots ``first ...`` of the global mask."""
    B, Sq, H, Dh = q.shape
    Kh = k_cache.shape[-2]
    qg = q.reshape(B, Sq, Kh, H // Kh, Dh)
    s = attn_scale(torch.einsum("bqhgd,bkhd->bhgqk", qg, k_cache), Dh)
    k_pos = first + torch.arange(k_cache.shape[1], device=q.device)
    ok = k_pos < cache_len
    if window is not None:
        ok = ok & (k_pos >= cache_len - window)
    return torch.where(ok, s.float(), NEG_INF)


def _decode_core(q, k_cache, v_cache, cache_len, window) -> torch.Tensor:
    B, Sq, H, Dh = q.shape
    p = torch.softmax(_decode_scores(q, k_cache, cache_len, window),
                      dim=-1).to(q.dtype)
    ctx = torch.einsum("bhgqk,bkhd->bqhgd", p, v_cache)
    return ctx.reshape(B, Sq, H, Dh)


def _decode_partial(q, k_cache, v_cache, cache_len, window, first: int):
    """``(m, l, o)`` of the slots ``first ...``: the max ``[B, Kh, G, Sq,
    1]``, the sum of ``exp(s - m)`` and the context it weights ``[B, Kh,
    G, Sq, Dh]``, float32."""
    s = _decode_scores(q, k_cache, cache_len, window, first)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p.to(q.dtype), v_cache).float()
    return m, p.sum(-1, keepdim=True), o


# ---------------------------------------------------------------------------
# attention projections
# ---------------------------------------------------------------------------
def attn_init(
    gen: torch.Generator, d_model: int, n_heads: int, n_kv_heads: int,
    head_dim: int, device, *, qkv_bias: bool = False,
    dtype: torch.dtype = torch.float32, pad_to: Optional[int] = None,
) -> Params:
    """``pad_to`` creates ``pad_to`` q-heads (and the proportional kv
    count) whose extra ``wq`` columns and ``wo`` rows are zero, so the
    function is the unpadded one at init."""
    n_real = n_heads
    if pad_to and pad_to > n_heads:
        ratio = max(1, n_heads // max(1, n_kv_heads))
        n_heads = pad_to
        n_kv_heads = max(1, pad_to // ratio)
    s = d_model**-0.5
    p = {
        "wq": _normal(gen, (d_model, n_heads, head_dim), s, device, dtype),
        "wk": _normal(gen, (d_model, n_kv_heads, head_dim), s, device, dtype),
        "wv": _normal(gen, (d_model, n_kv_heads, head_dim), s, device, dtype),
        "wo": _normal(gen, (n_heads, head_dim, d_model), s, device, dtype),
    }
    if n_heads > n_real:
        p["wq"][:, n_real:, :] = 0.0
        p["wo"][n_real:, :, :] = 0.0
    if qkv_bias:
        p["bq"] = torch.zeros((n_heads, head_dim), dtype=dtype, device=device)
        p["bk"] = torch.zeros((n_kv_heads, head_dim), dtype=dtype, device=device)
        p["bv"] = torch.zeros((n_kv_heads, head_dim), dtype=dtype, device=device)
    return p


def attn_axes(*, qkv_bias: bool = False) -> Dict[str, tuple]:
    """The logical axes of ``attn_init``'s weights, ``pad_to`` or not."""
    a = {
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
    }
    if qkv_bias:
        a["bq"] = ("heads", "head_dim")
        a["bk"] = ("kv_heads", "head_dim")
        a["bv"] = ("kv_heads", "head_dim")
    return a


def _project(p: Params, x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` through ``w<name>``, plus ``b<name>`` where there is one."""
    y = torch.einsum("bse,ehd->bshd", x, p[f"w{name}"].to(x.dtype))
    if f"b{name}" in p:
        y = y + p[f"b{name}"].to(x.dtype)
    return y


def attn_qkv(p: Params, x: torch.Tensor, xkv: Optional[torch.Tensor] = None,
             shard: Optional[TP.ModelShard] = None):
    """Project to q, k, v. ``xkv`` (if given) is the cross-attention
    source of k and v.

    Under a ``shard`` that splits ``"heads"``, ``wq`` is the rank's block
    of query heads and ``x`` enters the model group. Where ``"kv_heads"``
    is split too, ``wk`` and ``wv`` are the rank's kv heads, whose GQA
    groups are its query heads. Where they stay whole, k and v are
    computed whole from ``x`` and enter the group, and each of the rank's
    query heads takes the kv head of its global index (``_expand_kv``),
    so k and v come back with one head per query head."""
    src = x if xkv is None else xkv
    if shard is None or not shard.splits("heads"):
        return _project(p, x, "q"), _project(p, src, "k"), _project(p, src, "v")
    q = _project(p, TP.enter(x, shard), "q")
    if shard.splits("kv_heads"):
        src = TP.enter(src, shard)
        return q, _project(p, src, "k"), _project(p, src, "v")
    heads, kv = q.shape[-2], p["wk"].shape[-2]
    group = heads * shard.size // kv
    k, v = (_expand_kv(TP.enter(_project(p, src, n), shard), heads,
                       shard.index * heads, group) for n in "kv")
    return q, k, v


def attn_out(p: Params, ctx: torch.Tensor,
             shard: Optional[TP.ModelShard] = None) -> torch.Tensor:
    """The output projection; over the rank's heads under a ``shard``
    that splits ``"heads"``, summed over the model group."""
    y = torch.einsum("bshd,hde->bse", ctx, p["wo"].to(ctx.dtype))
    if shard is not None and shard.splits("heads"):
        return TP.leave(y, shard)
    return y


# ---------------------------------------------------------------------------
# MLP (SwiGLU or GeLU)
# ---------------------------------------------------------------------------
def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, device, *,
             act: str = "swiglu", dtype: torch.dtype = torch.float32) -> Params:
    s = d_model**-0.5
    so = d_ff**-0.5
    if act == "swiglu":
        return {
            "wg": _normal(gen, (d_model, d_ff), s, device, dtype),
            "wu": _normal(gen, (d_model, d_ff), s, device, dtype),
            "wd": _normal(gen, (d_ff, d_model), so, device, dtype),
        }
    return {
        "wu": _normal(gen, (d_model, d_ff), s, device, dtype),
        "wd": _normal(gen, (d_ff, d_model), so, device, dtype),
    }


def mlp_axes(*, act: str = "swiglu") -> Dict[str, tuple]:
    a = {"wu": ("embed", "mlp"), "wd": ("mlp", "embed")}
    if act == "swiglu":
        a["wg"] = ("embed", "mlp")
    return a


def mlp(p: Params, x: torch.Tensor, *, act: str = "swiglu",
        shard: Optional[TP.ModelShard] = None) -> torch.Tensor:
    """``act="gelu"`` is the tanh approximation, ``jax.nn.gelu``'s default
    (``torch.nn.functional.gelu`` defaults to the erf form). Under a
    ``shard`` that splits ``"mlp"``, the weights are the rank's columns
    in and rows out: ``x`` enters the model group and the down
    projection's partial sums leave it."""
    tp = shard is not None and shard.splits("mlp")
    if tp:
        x = TP.enter(x, shard)
    if act == "swiglu":
        h = torch.nn.functional.silu(x @ p["wg"].to(x.dtype)) * (
            x @ p["wu"].to(x.dtype)
        )
    else:
        h = torch.nn.functional.gelu(x @ p["wu"].to(x.dtype),
                                     approximate="tanh")
    y = h @ p["wd"].to(x.dtype)
    return TP.leave(y, shard) if tp else y


# ---------------------------------------------------------------------------
# embedding
# ---------------------------------------------------------------------------
def embed_init(
    gen: torch.Generator, vocab: int, d_model: int, device,
    scale: float = 0.02, dtype: torch.dtype = torch.float32,
) -> Params:
    return {"embedding": _normal(gen, (vocab, d_model), scale, device, dtype)}


def embed_axes() -> Dict[str, tuple]:
    return {"embedding": ("vocab", "embed")}


def embed(p: Params, tokens: torch.Tensor, dtype=None,
          shard: Optional[TP.ModelShard] = None) -> torch.Tensor:
    """The tokens' rows. Under a ``shard`` that splits ``"vocab"`` the
    table is the rank's block of rows: a token outside it looks up zeros,
    and the sum over the model group is every token's row, in bits."""
    e = p["embedding"]
    if dtype is not None:
        e = e.to(dtype)
    if shard is None or not shard.splits("vocab"):
        return e[tokens]
    local = tokens - shard.index * e.shape[0]
    mine = (local >= 0) & (local < e.shape[0])
    rows = e[torch.where(mine, local, 0)]
    return TP.leave(torch.where(mine[..., None], rows, 0.0), shard)


def unembed(p: Params, x: torch.Tensor,
            shard: Optional[TP.ModelShard] = None) -> torch.Tensor:
    """The logits over the (padded) vocabulary; under a ``shard`` that
    splits ``"vocab"``, the rank's block of them gathered over the model
    group in vocabulary order."""
    if shard is None or not shard.splits("vocab"):
        return torch.einsum("bse,ve->bsv", x, p["embedding"].to(x.dtype))
    logits = torch.einsum("bse,ve->bsv", TP.enter(x, shard),
                          p["embedding"].to(x.dtype))
    return TP.gather_last(logits, shard)
