"""Adam, ported by hand from ``repro.optim.optimizers.adam``.

``torch.optim.Adam`` is not used: it orders the bias correction and eps
differently (it folds the correction into the step size and adds eps to
``sqrt(v) / sqrt(bc2)``), so its updates would not match the JAX
package's ``lr * (m / bc1) / (sqrt(v / bc2) + eps)``. Workers run Adam
on the common aggregated gradient, so the moments are identical across
workers and the update is computed once (paper Sec. 5.3).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adam"
    learning_rate: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]  # (grads, state, params)


def adam(cfg: OptConfig) -> Optimizer:
    def init(params):
        device = tree_leaves(params)[0].device
        return {
            "step": torch.zeros((), dtype=torch.int32, device=device),
            "m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params),
        }

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        stepf = step.float()
        lr = torch.full((), cfg.learning_rate, device=step.device)
        m = tree_map(
            lambda m_, g: cfg.b1 * m_ + (1 - cfg.b1) * g.float(),
            state["m"], grads,
        )
        v = tree_map(
            lambda v_, g: cfg.b2 * v_ + (1 - cfg.b2) * g.float().square(),
            state["v"], grads,
        )
        bc1 = 1 - torch.pow(torch.full_like(stepf, cfg.b1), stepf)
        bc2 = 1 - torch.pow(torch.full_like(stepf, cfg.b2), stepf)

        def upd(p, m_, v_):
            mh = m_ / bc1
            vh = v_ / bc2
            delta = lr * mh / (torch.sqrt(vh) + cfg.eps)
            return p - delta.to(p.dtype)

        new_params = tree_map(upd, params, m, v)
        return new_params, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def make_optimizer(cfg: OptConfig) -> Optimizer:
    if cfg.kind != "adam":
        raise ValueError(
            f"optimizer {cfg.kind!r} is not ported yet; the port has 'adam'"
        )
    return adam(cfg)
