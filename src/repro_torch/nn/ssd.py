"""Mamba2 / SSD (state-space duality) block (counterpart of
``repro.nn.ssd``; arXiv:2405.21060).

The chunked SSD algorithm: inside a chunk of ``chunk`` steps the scan is
dense Q x Q matrix products, and across chunks a short recurrence carries
the ``[B, H, P, N]`` state (a loop over chunks here, ``lax.scan`` in the
JAX package). It stays plain PyTorch, as the JAX package's is plain
``jnp``: no Pallas kernel of the JAX package sits on this path.

Shapes: x ``[B, S, E]``; inner: heads H = d_inner / headdim P; state N.
Every three-operand ``einsum`` of the JAX module is written as two
explicit two-operand steps, so the contraction order is the same on every
machine (``torch.einsum`` picks it through ``opt_einsum`` where that is
installed).

Tensor parallelism: under a ``shard`` (``nn.tensor_parallel.ModelShard``)
that splits ``"d_inner"`` and ``"ssm_heads"``, ``ssd_block_apply`` runs
rank r of M on its channels ``[r d_inner/M, (r+1) d_inner/M)`` of ``z``
and ``x``, its H/M heads and all of ``B`` and ``C``. ``A_log``, ``D``,
``dt_bias``, ``norm`` and ``out_proj``'s rows are its blocks of those
channels and heads. ``in_proj`` (``z | x | B | C | dt``) and ``conv_w``,
``conv_b`` (``x | B | C``) are split on ``"d_inner"`` too, but their
contiguous blocks cut across the parts (zamba2-7b at M = 4: rank 1 holds
the end of ``z`` and the start of ``x``, rank 3 the end of ``x`` and all
of ``B``, ``C``, ``dt``), so the mixer gathers them whole
(``tensor_parallel.gather_leaf``) and takes the rank's columns. The
depthwise conv is per channel, so it runs on the rank's channels alone;
``B`` and ``C`` are computed on every rank. The gated RMSNorm's sum of
squares is summed over the group, so every rank divides by the same
whole-width mean; ``out_proj``'s product over the rank's rows leaves the
group summed. A layer's collectives, forward: all-gathers of the whole
``in_proj``, ``conv_w`` and ``conv_b``, and all-reduces of the squares'
sum ``[B, S, 1]`` and of the output ``[B, S, E]``; backward: all-reduces
of those three leaves' whole gradients, of the input's gradient ``[B, S,
E]`` and of the squares' ``[B, S, 1]``.

The decode step under such a shard (serving, ``nn.sharding.serve_rules``)
gathers activations, not weights: the rank's cache holds its contiguous
block ``[r C/M, (r+1) C/M)`` of the conv window's ``C = d_inner + 2N``
channels (split as ``conv_w`` and ``conv_b`` are) and its H/M heads of
the SSM state. The rank multiplies the token by its ``in_proj`` block and
gathers the group's columns into the whole ``zxbcdt`` row; runs the
depthwise conv and ``silu`` on its conv block and gathers the whole conv
output; takes ``x`` of its heads' channels, all of ``B`` and ``C``, and
``dt`` and ``z`` of its heads from those, and steps the recurrence on its
heads. The gated norm and ``out_proj`` are the forward's. A layer's
collectives a step: all-gathers of ``zxbcdt`` ``[B, 1, 2 d_inner + 2N +
H]`` and of the conv output ``[B, C]``, and all-reduces of the squares'
sum ``[B, 1, 1]`` (float32) and of the output ``[B, 1, E]``; no weight
moves.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.regtopk_score import const_div
from repro_torch.nn import tensor_parallel as TP
from repro_torch.nn.layers import _normal

Params = Dict[str, torch.Tensor]

CONV_K = 4  # depthwise causal conv kernel width (mamba2 default)


def ssd_init(
    gen: torch.Generator, d_model: int, device, *, d_inner: int,
    headdim: int = 64, d_state: int = 128, dtype: torch.dtype = torch.float32,
) -> Params:
    """The mixer's weights with the JAX package's shapes and scales:
    ``A_log = log(linspace(1, 16, H))``, ``D`` and ``norm`` ones,
    ``dt_bias`` and ``conv_b`` zeros."""
    H = d_inner // headdim
    conv_dim = d_inner + 2 * d_state  # x, B, C share the conv (ngroups=1)
    return {
        "in_proj": _normal(gen, (d_model, 2 * d_inner + 2 * d_state + H),
                           d_model**-0.5, device, dtype),
        "conv_w": _normal(gen, (CONV_K, conv_dim), 0.1, device, dtype),
        "conv_b": torch.zeros(conv_dim, dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H)).to(device, dtype),
        "D": torch.ones(H, dtype=dtype, device=device),
        "dt_bias": torch.zeros(H, dtype=dtype, device=device),
        "norm": torch.ones(d_inner, dtype=dtype, device=device),
        "out_proj": _normal(gen, (d_inner, d_model), d_inner**-0.5, device,
                            dtype),
    }


def ssd_axes() -> Dict[str, tuple]:
    """The logical axes of ``ssd_init``'s weights."""
    return {
        "in_proj": ("embed", "d_inner"),
        "conv_w": ("conv", "d_inner"),
        "conv_b": ("d_inner",),
        "A_log": ("ssm_heads",),
        "D": ("ssm_heads",),
        "dt_bias": ("ssm_heads",),
        "norm": ("d_inner",),
        "out_proj": ("d_inner", "embed"),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus`` computes
    ``log1p(exp(x))`` below its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv: xbc [B,S,C], w [K,C] -> [B,S,C]. A left pad
    of K-1 and a correlation, as ``lax.conv_general_dilated`` computes."""
    K, C = w.shape
    lhs = F.pad(xbc.transpose(1, 2), (K - 1, 0))  # [B, C, S+K-1]
    rhs = w.transpose(0, 1)[:, None, :].to(lhs.dtype)  # [C, 1, K]
    out = F.conv1d(lhs, rhs, groups=C)
    return out.transpose(1, 2) + b.to(xbc.dtype)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x [..., Q] -> cumulative-segment-sum matrix [..., Q, Q] (i >= j)."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, -1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_scan_chunked(
    x: torch.Tensor,  # [B, S, H, P]
    dt: torch.Tensor,  # [B, S, H]  (post-softplus)
    A: torch.Tensor,  # [H] negative
    Bm: torch.Tensor,  # [B, S, N]
    Cm: torch.Tensor,  # [B, S, N]
    *,
    chunk: int = 256,
    h0: Optional[torch.Tensor] = None,  # [B, H, P, N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. Returns (y [B,S,H,P], h_final [B,H,P,N])."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = -(-S // chunk)
    pad = nc * chunk - S
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    xc = x.reshape(Bsz, nc, chunk, H, P)
    dtc = dt.reshape(Bsz, nc, chunk, H)
    Bc = Bm.reshape(Bsz, nc, chunk, N)
    Cc = Cm.reshape(Bsz, nc, chunk, N)
    dt_hq = dtc.permute(0, 1, 3, 2)  # [B,c,H,Q]

    dA = (dtc * A.to(dtc.dtype)).permute(0, 1, 3, 2)  # [B,c,H,Q]
    dA_cs = torch.cumsum(dA, -1)  # [B,c,H,Q]

    # --- intra-chunk (dense) ------------------------------------------------
    L = torch.exp(_segsum(dA.float()))  # [B,c,H,Q,Q]
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)  # [B,c,Q,Q]
    scores = (scores[:, :, None] * L.to(scores.dtype)
              * dt_hq[:, :, :, None, :])  # [B,c,H,Q,Q]
    y_diag = torch.einsum("bchij,bcjhp->bcihp", scores, xc)

    # --- chunk states: "bcjn,bchj,bcjhp->bchpn" as two steps ----------------
    decay_states = torch.exp(
        (dA_cs[..., -1:] - dA_cs).float()).to(x.dtype)  # [B,c,H,Q]
    xw = xc * (decay_states * dt_hq).permute(0, 1, 3, 2)[..., None]
    states = torch.einsum("bcjn,bcjhp->bchpn", Bc, xw)  # [B,c,H,P,N]

    # --- inter-chunk recurrence ---------------------------------------------
    chunk_decay = torch.exp(dA_cs[..., -1].float()).to(x.dtype)  # [B,c,H]
    h = (torch.zeros((Bsz, H, P, N), dtype=x.dtype, device=x.device)
         if h0 is None else h0)
    h_befores = []
    for c in range(nc):
        h_befores.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_before = torch.stack(h_befores, 1)  # [B,c,H,P,N]

    # --- off-diagonal output: "bcin,bchpn,bchi->bcihp" as two steps ---------
    state_decay = torch.exp(dA_cs.float()).to(x.dtype)  # [B,c,H,Q]
    y_off = (torch.einsum("bcin,bchpn->bcihp", Cc, h_before)
             * state_decay.permute(0, 1, 3, 2)[..., None])
    y = (y_diag + y_off).reshape(Bsz, nc * chunk, H, P)[:, :S]
    return y, h


def ssd_decode_step(
    x: torch.Tensor,  # [B, H, P]
    dt: torch.Tensor,  # [B, H]
    A: torch.Tensor,  # [H]
    Bm: torch.Tensor,  # [B, N]
    Cm: torch.Tensor,  # [B, N]
    h: torch.Tensor,  # [B, H, P, N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the recurrence: (y [B,H,P], h_new [B,H,P,N])."""
    dA = torch.exp(dt * A.to(dt.dtype))  # [B,H]
    # "bhp,bn,bh->bhpn" as two steps
    h_new = (h * dA[:, :, None, None]
             + (x * dt[:, :, None])[..., None] * Bm[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", h_new, Cm)
    return y, h_new


def _rank_mixer(p: Params, d_inner: int, headdim: int, d_state: int,
                shard: TP.ModelShard) -> Params:
    """The mixer's weights for rank ``shard.index``: ``in_proj``,
    ``conv_w`` and ``conv_b`` gathered whole and cut to the rank's columns
    of ``z``, ``x``, ``dt`` and all of ``B``, ``C`` (``[z_r | x_r | B | C |
    dt_r]`` and ``[x_r | B | C]``); the other leaves are the rank's blocks
    already."""
    M, r = shard.size, shard.index
    width, heads = d_inner // M, d_inner // headdim // M
    w = TP.gather_leaf(p["in_proj"], shard)
    xbc = 2 * d_inner  # where B | C starts in in_proj
    dt0 = xbc + 2 * d_state + r * heads
    in_proj = torch.cat([w[:, r * width:(r + 1) * width],
                         w[:, d_inner + r * width:d_inner + (r + 1) * width],
                         w[:, xbc:xbc + 2 * d_state], w[:, dt0:dt0 + heads]],
                        dim=-1)

    def conv_cols(x):
        x = TP.gather_leaf(x, shard)
        return torch.cat([x[..., r * width:(r + 1) * width],
                          x[..., d_inner:]], dim=-1)

    return {**p, "in_proj": in_proj, "conv_w": conv_cols(p["conv_w"]),
            "conv_b": conv_cols(p["conv_b"])}


def _whole(x: torch.Tensor, shard: TP.ModelShard) -> torch.Tensor:
    """The model group's contiguous blocks of ``x``'s last dim, in shard
    order, the same bits on every rank (forward only)."""
    return torch.cat(TP.gather(x, shard).unbind(0), dim=-1)


def _decode(p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor], *,
            d_inner: int, headdim: int, d_state: int,
            shard: Optional[TP.ModelShard] = None):
    """One decode step (S = 1) up to the gated norm: ``(z, y, new
    cache)``, ``z`` and ``y`` ``[B, 1, width]`` over the rank's channels
    (``width = d_inner / M``; all of them without a ``shard``). Under a
    shard the weights and the cache are the rank's blocks and the step
    gathers ``zxbcdt`` and the conv output (module docstring)."""
    M, r = (1, 0) if shard is None else (shard.size, shard.index)
    width, H = d_inner // M, d_inner // headdim // M
    conv_dim = d_inner + 2 * d_state
    block = conv_dim // M
    if cache["conv"].shape[-1] != p["conv_w"].shape[-1] or (
            p["conv_w"].shape[-1] * M != conv_dim):
        raise ValueError(
            f"the conv window's {cache['conv'].shape[-1]} channels and "
            f"conv_w's {p['conv_w'].shape[-1]} are not one block of "
            f"{conv_dim} in {M}")
    zxbcdt = x @ p["in_proj"].to(x.dtype)  # [B, 1, in_proj's columns]
    if shard is not None:
        zxbcdt = _whole(zxbcdt, shard)
    z = zxbcdt[..., r * width:(r + 1) * width]
    xbc = zxbcdt[..., d_inner + r * block:d_inner + (r + 1) * block]
    dt0 = d_inner + conv_dim + r * H
    dt = zxbcdt[:, 0, dt0:dt0 + H]
    win = torch.cat([cache["conv"], xbc], dim=1)  # [B, K, block]
    conv = F.silu(torch.einsum("bkc,kc->bc", win, p["conv_w"].to(x.dtype))
                  + p["conv_b"].to(x.dtype))
    if shard is not None:
        conv = _whole(conv, shard)  # [B, conv_dim]
    Bsz = x.shape[0]
    xh = conv[:, r * width:(r + 1) * width].reshape(Bsz, H, headdim)
    Bm, Cm = conv[:, d_inner:d_inner + d_state], conv[:, d_inner + d_state:]
    A = -torch.exp(p["A_log"].float())
    dtp = _softplus(dt.float() + p["dt_bias"].float()).to(x.dtype)
    y, h_new = ssd_decode_step(xh, dtp, A.to(x.dtype), Bm, Cm, cache["ssm"])
    y = y + p["D"].to(x.dtype)[None, :, None] * xh
    return z, y.reshape(Bsz, 1, width), {"conv": win[:, 1:], "ssm": h_new}


def ssd_block_apply(
    p: Params,
    x: torch.Tensor,  # [B, S, E]
    *,
    d_inner: int,
    headdim: int,
    d_state: int,
    chunk: int = 256,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    norm_eps: float = 1e-6,
    shard: Optional[TP.ModelShard] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full mamba2 mixer. If ``cache`` is given, runs one decode step
    (S must be 1) and returns the updated cache. Under a ``shard`` that
    splits ``"d_inner"`` the weights (and the cache) are the rank's blocks
    and the output whole (module docstring)."""
    full = d_inner
    tp = shard is not None and shard.splits("d_inner")
    new_cache = None
    if cache is not None:
        z, y, new_cache = _decode(p, x, cache, d_inner=d_inner,
                                  headdim=headdim, d_state=d_state,
                                  shard=shard if tp else None)
    else:
        if tp:
            p = _rank_mixer(p, d_inner, headdim, d_state, shard)
            x = TP.enter(x, shard)
            d_inner //= shard.size
        H = d_inner // headdim
        zxbcdt = x @ p["in_proj"].to(x.dtype)
        z, xbc, dt = torch.split(
            zxbcdt, [d_inner, d_inner + 2 * d_state, H], dim=-1)
        A = -torch.exp(p["A_log"].float())
        xbc = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"]))
        xs, Bm, Cm = torch.split(xbc, [d_inner, d_state, d_state], dim=-1)
        Bsz, S, _ = x.shape
        xh = xs.reshape(Bsz, S, H, headdim)
        dtp = _softplus(dt.float() + p["dt_bias"].float()).to(x.dtype)
        y, _ = ssd_scan_chunked(xh, dtp, A.to(x.dtype), Bm, Cm, chunk=chunk)
        y = y + p["D"].to(x.dtype)[None, None, :, None] * xh
        y = y.reshape(Bsz, S, d_inner)

    # gated RMSNorm (the mean as the jitted reference takes it: the sum
    # times fl(1/d_inner), the sum over the whole width), then the
    # out-projection
    y = y * F.silu(z)
    sq = y.float().square().sum(-1, keepdim=True)
    if tp:
        sq = TP.enter(TP.leave(sq, shard), shard)
    var = const_div(sq, float(full))
    y = (y * torch.rsqrt(var + norm_eps).to(y.dtype)) * p["norm"].to(y.dtype)
    out = y @ p["out_proj"].to(x.dtype)
    return (TP.leave(out, shard) if tp else out), new_cache


def ssd_init_cache(batch: int, d_inner: int, headdim: int, d_state: int,
                   device, dtype: torch.dtype = torch.float32, shards: int = 1
                   ) -> Dict[str, torch.Tensor]:
    """Zero decode state: the conv window ``[B, K-1, conv_dim]`` and the
    SSM state ``[B, H, P, N]``; a serving rank's blocks of them (``conv_dim
    / shards`` channels, ``H / shards`` heads) at ``shards`` > 1."""
    H = d_inner // headdim
    conv_dim = d_inner + 2 * d_state
    return {
        "conv": torch.zeros((batch, CONV_K - 1, conv_dim // shards),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, H // shards, headdim, d_state), dtype=dtype,
                           device=device),
    }
