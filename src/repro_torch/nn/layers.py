"""Core layers of the dense block (counterpart of ``repro.nn.layers``).

Parameters are plain dicts of tensors with the JAX package's names and
layouts, so a weight tree moves between the two stacks name for name
(``repro_torch.convert``). Activations are ``x [B, S, E]``; attention
heads ``[B, S, H, Dh]``. Every ``*_init`` draws from an explicit CPU
``torch.Generator`` and moves the result to ``device``, so a seed gives
the same weights on any device.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

Params = Dict[str, torch.Tensor]

NEG_INF = -1e30


def set_fp32_matmul() -> None:
    """Run float32 matrix products and convolutions in full float32 on the
    card: TF32 keeps about three decimal digits, and the port is held
    against a float32 reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _normal(gen: torch.Generator, shape, scale: float, device) -> torch.Tensor:
    return (scale * torch.randn(shape, generator=gen)).to(device)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def rmsnorm_init(dim: int, device) -> Params:
    return {"scale": torch.ones(dim, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps).to(x.dtype)
    return y * p["scale"].to(x.dtype)


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
# dense attention: matmul + masked softmax
# ---------------------------------------------------------------------------
def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """GQA: repeat kv heads to match query heads. k: [B, S, Kh, Dh]."""
    kh = k.shape[-2]
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
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / (Dh**0.5)
    q_pos = torch.arange(q.shape[1], device=q.device)
    k_pos = torch.arange(k.shape[1], device=q.device)
    if causal or window is not None:
        scores = scores + _mask_bias(q_pos, k_pos, causal, window).to(
            scores.dtype
        )
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# ---------------------------------------------------------------------------
# attention projections
# ---------------------------------------------------------------------------
def attn_init(
    gen: torch.Generator, d_model: int, n_heads: int, n_kv_heads: int,
    head_dim: int, device,
) -> Params:
    s = d_model**-0.5
    return {
        "wq": _normal(gen, (d_model, n_heads, head_dim), s, device),
        "wk": _normal(gen, (d_model, n_kv_heads, head_dim), s, device),
        "wv": _normal(gen, (d_model, n_kv_heads, head_dim), s, device),
        "wo": _normal(gen, (n_heads, head_dim, d_model), s, device),
    }


def attn_qkv(p: Params, x: torch.Tensor):
    q = torch.einsum("bse,ehd->bshd", x, p["wq"].to(x.dtype))
    k = torch.einsum("bse,ehd->bshd", x, p["wk"].to(x.dtype))
    v = torch.einsum("bse,ehd->bshd", x, p["wv"].to(x.dtype))
    return q, k, v


def attn_out(p: Params, ctx: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bshd,hde->bse", ctx, p["wo"].to(ctx.dtype))


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------
def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, device) -> Params:
    s = d_model**-0.5
    so = d_ff**-0.5
    return {
        "wg": _normal(gen, (d_model, d_ff), s, device),
        "wu": _normal(gen, (d_model, d_ff), s, device),
        "wd": _normal(gen, (d_ff, d_model), so, device),
    }


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = torch.nn.functional.silu(x @ p["wg"].to(x.dtype)) * (
        x @ p["wu"].to(x.dtype)
    )
    return h @ p["wd"].to(x.dtype)


# ---------------------------------------------------------------------------
# embedding
# ---------------------------------------------------------------------------
def embed_init(
    gen: torch.Generator, vocab: int, d_model: int, device,
    scale: float = 0.02,
) -> Params:
    return {"embedding": _normal(gen, (vocab, d_model), scale, device)}


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["embedding"][tokens]


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bse,ve->bsv", x, p["embedding"].to(x.dtype))
