"""Public wrappers around the kernels (counterpart of
``repro.kernels.ops``): the layout contract, the score pass and the fused
pipeline.

Layout contract (as in the JAX package): each worker's vector is
flattened, cast to f32 and zero-padded to a multiple of ``TILE`` = 8192
elements, then viewed as ``[rows, 1024]`` with ``rows % 8 == 0``; one
tile is 8 rows. The port keeps a leading worker axis, so a ``[W, ...]``
tensor tiles to ``[W, rows, 1024]``. Zero padding scores 0 and carries a
flat index at or above the true length.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import fused_encode as _fe
from repro_torch.kernels import regtopk_score as _rs

LANES = _rs.LANES
TILE = _rs.TILE


def _tile(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """``[W, ...]`` → (``[W, rows, LANES]`` contiguous f32 with rows % 8 ==
    0, n). A broadcast input (``g_prev.expand_as(a)``) is materialised: the
    kernels read every worker's row from memory."""
    flat = x.reshape(x.shape[0], -1).float()
    n = flat.shape[1]
    pad = (-n) % TILE
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(x.shape[0], -1, LANES).contiguous(), n


def regtopk_score(a, a_prev, s_prev, g_prev, *, omega: float, mu: float,
                  q: float = 1e9, y: float = 1.0) -> torch.Tensor:
    """The Alg. 2 score of ``[W, L]`` worker vectors in one kernel pass.
    Returns ``[W, L]`` f32 (as the JAX wrapper, whatever the input type)."""
    tiles = [_tile(x)[0] for x in (a, a_prev, s_prev, g_prev)]
    out = _rs.regtopk_score(*tiles, omega=omega, mu=mu, q=q, y=y)
    W, L = a.shape
    return out.reshape(W, -1)[:, :L]


def fused_select_encode(
    a, a_prev, s_prev, g_prev, *, k: int, omega: float, mu: float,
    q: float = 1e9, y: float = 1.0, m: int = 16,
):
    """Fused score→select→payload over ``[W, L]`` worker vectors.

    Returns ``(vals [W, k], idx [W, k] int64, ok [W])``: each worker's
    compact wire payload straight from the kernel's candidates, and its
    exactness certificate (``fused_encode.select_from_candidates``).
    Where ``ok`` is False the caller recomputes that worker's payload on
    the dense path."""
    at, _ = _tile(a)
    pt, _ = _tile(a_prev)
    st, _ = _tile(s_prev)
    gt, _ = _tile(g_prev)
    cs, cv, ci = _fe.fused_candidates(
        at, pt, st, gt, omega=omega, mu=mu, q=q, y=y, m=m
    )
    return _fe.select_from_candidates(cs, cv, ci, k)
