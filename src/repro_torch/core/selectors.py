"""Top-k selection primitives (counterpart of ``repro.core.selectors``)."""
from __future__ import annotations

import math
from typing import Tuple

import torch


def topk_stable(score: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k along the last axis, ties broken lowest index first.

    ``lax.top_k`` orders equal scores by index; ``torch.topk`` documents no
    tie order. A stable descending sort keeps equal scores in index order,
    so its first ``k`` entries are ``lax.top_k``'s, order included.

    >>> v, i = topk_stable(torch.tensor([1.0, 3.0, 3.0, 2.0]), 2)
    >>> v.tolist(), i.tolist()
    ([3.0, 3.0], [1, 2])
    """
    vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def sparsity_to_k(length: int, sparsity: float) -> int:
    """Paper's S = k/J; returns k = ceil(S * J), clipped to [1, J].

    The ceil is epsilon-tolerant: ``S * J`` is computed in binary floating
    point, so nominally-integer products land a few ulps above the integer
    (``0.07 * 100 == 7.000000000000001``) and a naive ceil would inflate k
    by one.

    >>> sparsity_to_k(100, 0.07)
    7
    >>> sparsity_to_k(100, 0.071), sparsity_to_k(10, 0.0)
    (8, 1)
    """
    target = sparsity * length
    eps = 1e-9 * max(1.0, abs(target))
    k = math.ceil(target - eps)
    return max(1, min(length, k))
