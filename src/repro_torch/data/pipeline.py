"""Synthetic data (counterpart of ``repro.data.pipeline``): the LM token
stream of the trainer and the paper's distributed linear regression
(Sec. 5.1) of the simulator.

Same structure as the JAX pipeline: Zipf-ish token marginals from a
squared uniform, and labels that repeat the token three back with
probability 0.5 (else the next token). Each batch is a pure function of
``(seed, step)``: it is drawn on the CPU from a ``torch.Generator`` seeded
from that pair and then moved to ``device``, so every device sees the same
batches. torch cannot reproduce ``jax.random`` streams, so the numbers
differ from the JAX pipeline's; tests hand both stacks the same arrays.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    cfg: ModelConfig
    global_batch: int
    seq: int
    seed: int = 0
    device: str = "cuda"

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        gen = torch.Generator().manual_seed(self.seed * 1_000_003 + int(step))
        B, S, V = self.global_batch, self.seq, self.cfg.vocab
        u = torch.rand((B, S), generator=gen)
        tokens = torch.clamp((u * u * V).long(), max=V - 1)
        flip = torch.rand((B, S), generator=gen) < 0.5
        recent = torch.roll(tokens, 3, dims=1)
        labels = torch.where(flip, recent, torch.roll(tokens, -1, dims=1))
        return {
            "tokens": tokens.to(self.device),
            "labels": labels.to(self.device),
        }


class LinRegDataset(NamedTuple):
    X: torch.Tensor  # [N, Dn, J]
    y: torch.Tensor  # [N, Dn]
    theta_star: torch.Tensor  # [J]  analytic global optimum
    t_n: torch.Tensor  # [N, J] per-worker ground truths


def make_linreg(
    seed: int,
    n_workers: int = 20,
    dim: int = 100,
    n_points: int = 500,
    *,
    mean: float = 0.0,
    sigma2: float = 5.0,
    h2: float = 1.0,
    eps2: float = 0.5,
    homogeneous: bool = False,
    device="cuda",
) -> LinRegDataset:
    """The paper's heterogeneous linear-regression data (Sec. 5.1), as
    ``repro.data.pipeline.make_linreg`` builds it: worker n's ground truth
    is ``u_n + h * N(0, I)`` with ``u_n ~ N(mean, sigma2)``, its points
    ``X ~ N(0, I)`` and labels ``X t_n + N(0, eps2)``; ``theta_star``
    solves the pooled normal equations. Drawn in float32 on the CPU from
    ``torch.Generator().manual_seed(seed)`` and moved to ``device``; the
    numbers differ from ``jax.random``'s, so tests hand both stacks the
    same arrays (``repro_torch.convert.linreg_from_jax``)."""
    gen = torch.Generator().manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen)

    if homogeneous:
        t0 = mean + math.sqrt(h2) * normal(dim)
        t_n = t0.expand(n_workers, dim).clone()
        eps2 = 0.0
    else:
        u_n = mean + math.sqrt(sigma2) * normal(n_workers)
        t_n = u_n[:, None] + math.sqrt(h2) * normal(n_workers, dim)
    X = normal(n_workers, n_points, dim)
    e = math.sqrt(eps2) * normal(n_workers, n_points)
    y = torch.einsum("ndj,nj->nd", X, t_n) + e
    A = torch.einsum("ndi,ndj->ij", X, X)
    b = torch.einsum("ndj,nd->j", X, y)
    theta_star = torch.linalg.solve(A, b)
    return LinRegDataset(
        *(x.to(device) for x in (X, y, theta_star, t_n))
    )


def linreg_grad_fn(data: LinRegDataset) -> Callable:
    """``grad_fn(theta [J], widx [n]) -> [n, J]``: the RSS gradient (paper
    Eq. 48) of each worker in ``widx``, ``2 / Dn * X_n^T (X_n theta -
    y_n)``.

    Unlike the JAX package's per-worker ``grad_fn(theta, n)``, which the
    simulator vmaps, the port's grad functions are batched over workers:
    a kernel launched through ctypes cannot run under ``torch.func.vmap``,
    so the simulator hands the whole worker index vector to one call."""
    Dn = data.X.shape[1]

    def grad_fn(theta: torch.Tensor, widx: torch.Tensor) -> torch.Tensor:
        X, y = data.X[widx], data.y[widx]
        r = torch.einsum("ndj,j->nd", X, theta) - y
        return 2.0 / Dn * torch.einsum("ndj,nd->nj", X, r)

    return grad_fn
