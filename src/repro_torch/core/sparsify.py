"""Gradient sparsifiers over dense per-worker state (counterpart of
``repro.core.sparsify``).

The six kinds of the JAX package, with its interface::

    state            = sparsifier.init(n_workers, length, device=...)
    ghat, mask, state = sparsifier.step(state, g_local, g_agg_prev)

where the JAX package vmaps one worker's step over a leading axis, the
port writes that axis out: ``g_local``, ``ghat``, ``mask`` and every
state slot but ``t`` are ``[N, L]``, ``t`` is ``[N]``, and ``g_agg_prev``
(the previous round's broadcast aggregate, which every worker knows) is
``[L]``.

* ``none``           — identity, distributed SGD without sparsification;
* ``topk``           — Alg. 1: error accumulation and magnitude top-k;
* ``regtopk``        — Alg. 2, the paper's RegTop-k: selection by
  ``|a|^y * tanh(|1 + Delta| / mu)``, unsent coordinates at ``Q``;
* ``hard_threshold`` — ``|a| >= lambda`` (variable cardinality);
* ``coordtopk``      — top-k of a staleness counter plus the normalised
  broadcast aggregate, the same mask on every worker;
* ``dgc``            — Deep Gradient Compression's momentum correction.

The state's slots mean different things per kind (``a_prev`` is
RegTop-k's accumulated gradient, DGC's momentum, CoordTopK's staleness
counter), so every rewrite of them lives here, behind the two hooks
``on_wire_residual`` and ``on_dropped``. The state class is
``DenseState``; ``tools/reprolint`` rule RPL106 keeps ``SparsifierState``
writes inside the JAX module.

``omega_prev`` (``[L]``) is the previous round's per-coordinate sender
mass ``den[j]`` under ``weighting="coordinate"``
(``repro_torch.comm.collectives``): the server divided coordinate ``j``
by ``den[j]``, so RegTop-k's posterior subtracts this worker's
contribution with the weight ``omega / den[j]``. ``None`` is worker
weighting; the other kinds ignore it, as in the JAX package.
``step_dyn`` (the adaptive-k controller's traced k) is not ported yet
(ROADMAP queue 1 item 6).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import selectors as sel_lib
from repro_torch.kernels.regtopk_score import score_chain


class DenseState(NamedTuple):
    """Per-worker state, a leading worker axis on every slot.

    eps     — sparsification error ``[N, L]`` (zeros for stateless kinds);
    a_prev  — previous accumulated gradient ``[N, L]`` (kind-specific);
    s_prev  — previous mask ``[N, L]`` in {0, 1};
    t       — round counter ``[N]`` int32; t == 0 is plain Top-k (Alg. 2
              line 2).
    """

    eps: torch.Tensor
    a_prev: torch.Tensor
    s_prev: torch.Tensor
    t: torch.Tensor


@dataclasses.dataclass(frozen=True)
class SparsifierConfig:
    """kind      — "none" | "topk" | "regtopk" | "hard_threshold" |
                   "coordtopk" | "dgc"
    sparsity  — S = k/J (paper's sparsification factor)
    mu        — RegTop-k innovation-CDF scale (paper's mu)
    y         — prior exponent |a|^y (paper Remark 4)
    q_const   — the "very large constant Q" for unsent coordinates
    omega     — this worker's aggregation weight omega_n
    selector  — "exact" (stable top-k) | "threshold" (bisection, ~k mask)
    threshold — hard-threshold lambda (hard_threshold only)
    momentum  — DGC momentum-correction factor (dgc only)
    score_fn  — optional override of RegTop-k's score (the CUDA score
                kernel plugs in here through
                ``repro_torch.comm.fastpath.make_score_fn``)
    """

    kind: str = "regtopk"
    sparsity: float = 0.01
    mu: float = 1.0
    y: float = 1.0
    q_const: float = 1e9
    omega: float = 1.0
    selector: str = "exact"
    threshold: float = 1e-3
    momentum: float = 0.9
    score_fn: Optional[object] = None


class Sparsifier:
    """Base: the error-accumulating skeleton (Algorithm 1's shape)."""

    def __init__(self, cfg: SparsifierConfig):
        self.cfg = cfg

    # -- interface ---------------------------------------------------------
    def init(self, n_workers: int, length: int, dtype=torch.float32,
             device="cuda") -> DenseState:
        z = torch.zeros((n_workers, length), dtype=dtype, device=device)
        return DenseState(
            eps=z, a_prev=z.clone(), s_prev=z.clone(),
            t=torch.zeros((n_workers,), dtype=torch.int32, device=device),
        )

    def step(
        self,
        state: DenseState,
        g_local: torch.Tensor,
        g_agg_prev: torch.Tensor,
        omega_prev: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, DenseState]:
        """Returns ``(ghat [N, L], mask [N, L], new_state)``."""
        raise NotImplementedError

    # -- runtime hooks (the only slot rewrites outside step) ---------------
    def on_wire_residual(self, state: DenseState, delta: torch.Tensor) -> DenseState:
        """A lossy codec put ``intended + delta`` on the wire: the residual
        folds into ``eps``, so error feedback covers the codec."""
        return state._replace(eps=state.eps - delta)

    def on_dropped(
        self, old_state: DenseState, new_state: DenseState, ghat: torch.Tensor
    ) -> DenseState:
        """State of a worker whose round payload was dropped: ``new_state``
        is what ``step`` produced, ``ghat`` what never arrived. Base
        (topk / regtopk / hard_threshold): the whole accumulated gradient
        returns to the error, and the posterior statistics stay at the
        last round the server saw."""
        return DenseState(
            eps=new_state.eps + ghat,
            a_prev=old_state.a_prev,
            s_prev=old_state.s_prev,
            t=new_state.t,
        )

    # -- shared helpers ----------------------------------------------------
    def _k(self, length: int) -> int:
        return sel_lib.sparsity_to_k(length, self.cfg.sparsity)

    def _select(self, score: torch.Tensor) -> torch.Tensor:
        select = sel_lib.get_selector(self.cfg.selector)
        return select(score, self._k(score.shape[-1]))

    def _finish(self, state: DenseState, a: torch.Tensor, mask: torch.Tensor):
        ghat = mask * a
        new_state = DenseState(eps=a - ghat, a_prev=a, s_prev=mask, t=state.t + 1)
        return ghat, mask, new_state


class NoneSparsifier(Sparsifier):
    """Identity compressor: distributed SGD without sparsification."""

    def step(self, state, g_local, g_agg_prev, omega_prev=None):
        return g_local, torch.ones_like(g_local), state._replace(t=state.t + 1)

    def on_dropped(self, old_state, new_state, ghat):
        # no error state: a dropped worker's gradient is lost
        return new_state


class TopK(Sparsifier):
    """Alg. 1: a = eps + g; mask = Top_k(|a|); eps' = a - mask * a."""

    def step(self, state, g_local, g_agg_prev, omega_prev=None):
        a = state.eps + g_local
        return self._finish(state, a, self._select(torch.abs(a)))


class RegTopK(Sparsifier):
    """Alg. 2 (RegTop-k).

    Line 8:  Delta = s_prev * (g_agg_prev - omega * a_prev) / (omega * a)
                     + Q * (1 - s_prev)
    Line 9:  mask  = Top_k(|a|^y * tanh(|1 + Delta| / mu)).
    Round 0 is plain Top-k. Without ``score_fn`` the score is the plain
    ``score_chain``, the chain the CUDA kernel evaluates, so the fastpath
    on and off agree bit for bit on the card.
    """

    def _score(self, state, a, g_prev, omega_prev=None):
        cfg = self.cfg
        if cfg.score_fn is not None:
            if omega_prev is not None:
                raise ValueError(
                    "the fused score kernel bakes a scalar omega; "
                    "coordinate weighting (omega_prev) requires the "
                    "reference score path (fastpath off)"
                )
            return cfg.score_fn(a, state.a_prev, state.s_prev, g_prev, cfg)
        omega = cfg.omega
        if omega_prev is not None:
            # the server divided coordinate j by den[j], so this worker's
            # weight there was omega / den[j]; where den == 0 nobody sent
            # j, s_prev is 0 there and the guard never reaches the score.
            # A tensor numerator: torch divides a Python scalar by a
            # tensor as a reciprocal times the scalar.
            w = torch.where(omega_prev > 0, omega_prev, 1.0)
            omega = torch.full_like(w, cfg.omega) / w
        return score_chain(
            a, state.a_prev, state.s_prev, g_prev,
            omega=omega, mu=cfg.mu, q=cfg.q_const, y=cfg.y,
        )

    def step(self, state, g_local, g_agg_prev, omega_prev=None):
        a = state.eps + g_local
        score = torch.where(
            (state.t == 0)[:, None],
            torch.abs(a),
            self._score(state, a, g_agg_prev, omega_prev),
        )
        return self._finish(state, a, self._select(score))

    def on_wire_residual(self, state, delta):
        # the posterior conditions on what the server decoded: a_prev
        # moves to the transmitted values, on top of the error fold
        return DenseState(
            eps=state.eps - delta,
            a_prev=state.a_prev + delta,
            s_prev=state.s_prev,
            t=state.t,
        )


class HardThreshold(Sparsifier):
    """Sahu et al. [27]: ``mask = |a| >= lambda``. Variable cardinality,
    so the simulator aggregates it dense only."""

    def step(self, state, g_local, g_agg_prev, omega_prev=None):
        a = state.eps + g_local
        mask = (torch.abs(a) >= self.cfg.threshold).to(a.dtype)
        return self._finish(state, a, mask)


class CoordTopK(Sparsifier):
    """Coordinated Top-k: ``score = staleness + |g_prev| / max|g_prev|``.

    The mask is a function of what every worker shares (the broadcast
    aggregate and the common staleness counter, kept in the ``a_prev``
    slot), so all workers select the same coordinates."""

    def step(self, state, g_local, g_agg_prev, omega_prev=None):
        a = state.eps + g_local
        stale = state.a_prev
        gmag = torch.abs(g_agg_prev)
        gn = gmag / torch.clamp(gmag.max(), min=1e-30)
        mask = self._select(stale + gn)
        ghat = mask * a
        new_state = DenseState(
            eps=a - ghat,
            a_prev=torch.where(mask > 0, 0.0, stale + 1.0),
            s_prev=mask,
            t=state.t + 1,
        )
        return ghat, mask, new_state

    def on_dropped(self, old_state, new_state, ghat):
        # the staleness counter is common information and advances in
        # lockstep; only the undelivered mass returns to eps
        return new_state._replace(eps=new_state.eps + ghat)


class DGC(Sparsifier):
    """Deep Gradient Compression (Lin et al. [26]): Top-k with momentum
    correction and momentum-factor masking.

    u = m·u + g;  v = v_residual + u;  mask = Top_k(|v|)
    send mask·v;  v_residual = v − mask·v;  u = (1 − mask)·u
    """

    def step(self, state, g_local, g_agg_prev, omega_prev=None):
        u = self.cfg.momentum * state.a_prev + g_local  # a_prev holds u
        v = state.eps + u
        mask = self._select(torch.abs(v))
        ghat = mask * v
        new_state = DenseState(
            eps=v - ghat, a_prev=(1.0 - mask) * u, s_prev=mask, t=state.t + 1
        )
        return ghat, mask, new_state

    def on_dropped(self, old_state, new_state, ghat):
        # eps = (v - ghat) + ghat = v; the masked velocity stays
        return new_state._replace(eps=new_state.eps + ghat)


KINDS = {
    "none": NoneSparsifier,
    "topk": TopK,
    "regtopk": RegTopK,
    "hard_threshold": HardThreshold,
    "coordtopk": CoordTopK,
    "dgc": DGC,
}


def make_sparsifier(cfg: SparsifierConfig) -> Sparsifier:
    try:
        cls = KINDS[cfg.kind]
    except KeyError:
        raise ValueError(
            f"unknown sparsifier kind {cfg.kind!r}; available: {sorted(KINDS)}"
        ) from None
    return cls(cfg)
