"""Top-k selection primitives (counterpart of ``repro.core.selectors``).

Every selector works along the last axis of a non-negative ``score``, so
a ``[N, L]`` score selects for N workers at once, and returns a ``{0,1}``
float mask or a fixed-``k`` payload. Ties go to the lowest index, as
``lax.top_k`` breaks them (:func:`topk_stable`).

Two families, as in the JAX package:

* ``exact``     — the exact top-k of the score (a stable sort);
* ``threshold`` — bisection for a threshold ``tau`` with ``count(score >=
  tau)`` the smallest count ``>= k``: a mask of about ``k`` entries.

A zero score carries no gradient and is never selected, by either family
and at any ``k`` (the JAX ``threshold_topk_mask`` returns all ones when
``k >= L``; the port keeps the contract there too). Subnormal scores are
positive numbers here: PyTorch does not flush them to zero, on the CPU
or on the card, where XLA:CPU does.
"""
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


def exact_topk_mask(score: torch.Tensor, k: int) -> torch.Tensor:
    """Exact top-k mask along the last axis; zero scores never selected,
    so the mask has ``min(k, #positive scores)`` entries per row.

    >>> exact_topk_mask(torch.tensor([0.1, 3.0, 0.2, 2.0]), 2).tolist()
    [0.0, 1.0, 0.0, 1.0]
    >>> exact_topk_mask(torch.tensor([0.0, 3.0, 0.0, 0.0]), 2).tolist()
    [0.0, 1.0, 0.0, 0.0]
    """
    k = int(k)
    live = (score > 0).to(score.dtype)
    if k <= 0:
        return torch.zeros_like(score)
    if k >= score.shape[-1]:
        return live
    _, idx = topk_stable(score, k)
    mask = torch.zeros_like(score).scatter(-1, idx, 1.0)
    return mask * live


def threshold_topk_mask(
    score: torch.Tensor, k: int, *, n_iters: int = 24
) -> torch.Tensor:
    """Approximate top-k mask along the last axis by ``n_iters`` halvings
    of ``[0, max(score)]``, keeping ``count(score >= lo) >= k``; the mask
    is ``(score >= lo) & (score > 0)``.

    >>> threshold_topk_mask(torch.tensor([0.1, 3.0, 0.2, 2.0]), 2).tolist()
    [0.0, 1.0, 0.0, 1.0]
    >>> threshold_topk_mask(torch.tensor([0.0, 0.0, 0.5]), 3).tolist()
    [0.0, 0.0, 1.0]
    """
    k = int(k)
    if k <= 0:
        return torch.zeros_like(score)
    if k >= score.shape[-1]:
        return (score > 0).to(score.dtype)
    hi = score.max(dim=-1, keepdim=True).values
    lo = torch.zeros_like(hi)
    for _ in range(n_iters):
        mid = 0.5 * (lo + hi)
        enough = (score >= mid).sum(dim=-1, keepdim=True) >= k
        lo, hi = torch.where(enough, mid, lo), torch.where(enough, hi, mid)
    return ((score >= lo) & (score > 0)).to(score.dtype)


def fixed_k_payload(
    score: torch.Tensor, values: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fixed-size payload ``(values at the top-k, their indices)``
    along the last axis: the score ranks, ``values`` travel.

    >>> v, i = fixed_k_payload(torch.tensor([0.1, 3.0, 0.2, 2.0]),
    ...                        torch.tensor([9.0, 8.0, 7.0, 6.0]), 2)
    >>> v.tolist(), i.tolist()
    ([8.0, 6.0], [1, 3])
    """
    _, idx = topk_stable(score, int(k))
    return torch.gather(values, -1, idx), idx


def mask_to_payload(
    mask: torch.Tensor, values: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """An exactly-``k`` payload of a mask along the last axis: masked
    entries ranked by ``|value|``; a mask of fewer than ``k`` entries pads
    with ``(±0.0, index 0)`` slots, which a scatter-add leaves without
    effect (see ``repro_torch.comm.collectives``).

    >>> v, i = mask_to_payload(torch.tensor([0.0, 1.0, 0.0, 0.0]),
    ...                        torch.tensor([9.0, -8.0, 7.0, 6.0]), 2)
    >>> v.tolist(), i.tolist()
    ([-8.0, 0.0], [1, 0])
    """
    live = mask > 0
    ranked = torch.where(live, torch.abs(values), -torch.inf)
    _, idx = topk_stable(ranked, int(k))
    sel = torch.gather(live, -1, idx)
    vals = torch.gather(values, -1, idx) * sel
    return vals, torch.where(sel, idx, 0)


SELECTORS = {
    "exact": exact_topk_mask,
    "threshold": threshold_topk_mask,
}


def get_selector(name: str):
    """Look up a selector family by name.

    >>> get_selector("exact") is exact_topk_mask
    True
    """
    try:
        return SELECTORS[name]
    except KeyError:
        raise ValueError(
            f"unknown selector {name!r}; available: {sorted(SELECTORS)}"
        ) from None


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
