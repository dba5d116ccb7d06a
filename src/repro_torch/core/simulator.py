"""Single-process N-worker distributed-SGD simulator (counterpart of
``repro.core.simulator``).

The paper's setting (Sec. 2): N workers compute local gradients and
sparsify them with one algorithm but their own state; the server
aggregates with weights omega_n = 1/N and broadcasts the model update and
the aggregated gradient, which RegTop-k's posterior reads next round as
``g_agg_prev``. The paper's figures (the Fig. 1 toy, Fig. 3's distributed
linear regression, Table 2) drive it.

Where the JAX package vmaps one worker over a leading axis and
jit-scans the rounds, the port writes the worker axis out (every state
slot is ``[N, L]``, see ``repro_torch.core.sparsify``) and runs the
rounds in a Python loop. ``grad_fn`` is batched over workers:
``grad_fn(theta [J], widx [n]) -> [n, J]``.

With ``fastpath="on"`` (or ``"auto"`` on the card) RegTop-k scores
through the CUDA kernel ``kernels/csrc/regtopk_score.cu``, one launch per
round for all workers; it evaluates the same op chain as the plain path,
so the two runs agree bit for bit on the card. The kernel takes a scalar
omega, so ``weighting="coordinate"`` refuses ``"on"`` and ``"auto"``
declines it.

Ported: full participation, static k, no overlap, the four codecs (a
lossy codec's decode residual folds back through
``Sparsifier.on_wire_residual``), the three collectives, both weightings
and the alpha–beta cost of a round (:meth:`DistributedSim.
wire_bytes_per_round`). The other options raise ``ValueError`` naming
ROADMAP queue 1 item 6, which ports them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.comm import collectives, cost, fastpath
from repro_torch.comm.codec import get_codec
from repro_torch.core import selectors as sel_lib
from repro_torch.core.sparsify import (
    DenseState,
    Sparsifier,
    SparsifierConfig,
    make_sparsifier,
)

FASTPATH_MODES = ("off", "on", "auto")


def _not_ported(option: str, value) -> ValueError:
    return ValueError(
        f"{option}={value!r} is not ported; ROADMAP queue 1 item 6 ports it"
    )


class SimState(NamedTuple):
    theta: torch.Tensor  # [J]  global model
    worker_states: DenseState  # slots with a leading [N]
    g_agg_prev: torch.Tensor  # [J]  last broadcast aggregated gradient
    step: int  # rounds taken
    # the per-coordinate sender mass den[j] the server divided by last
    # round (weighting="coordinate" only; None is worker weighting): the
    # coordinate-wise omega RegTop-k's posterior conditions on
    w_agg_prev: Optional[torch.Tensor] = None  # [J]


@dataclasses.dataclass
class DistributedSim:
    """``grad_fn(theta [J], worker indices [n]) -> [n, J]`` local
    gradients; ``device`` holds every tensor of the run (the card unless
    the caller asks for ``"cpu"``).

    ``dp_shape`` factors the ``n_workers`` ring into a notional multi-axis
    dp mesh (outermost first) for the cost model; the simulated numbers do
    not depend on it. ``link_topo`` (one ``cost.AlphaBeta`` per axis) wins
    over the scalar ``link_model``."""

    grad_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    n_workers: int
    length: int
    sparsifier_cfg: SparsifierConfig
    learning_rate: float = 1e-2
    aggregation: str = "dense_allreduce"  # legacy alias for ``collective``
    codec: str = "coo_fp32"
    collective: Optional[str] = None
    link_model: Optional[cost.AlphaBeta] = None
    link_topo: Optional[cost.LinkTopo] = None
    dp_shape: Optional[Tuple[int, ...]] = None
    participation: Optional[object] = None
    fastpath: str = "off"
    adaptive_k: Optional[object] = None
    weighting: str = "worker"
    overlap: str = "off"
    device: str = "cuda"

    def __post_init__(self):
        self._validate()
        cfg = dataclasses.replace(self.sparsifier_cfg, omega=1.0 / self.n_workers)
        use_kernel = self.fastpath == "on" or (
            self.fastpath == "auto" and fastpath.backend_supports(self.device)
        )
        # the kernel scores with a scalar omega: coordinate weighting keeps
        # the plain chain, which takes omega_prev
        if (
            cfg.kind == "regtopk" and cfg.score_fn is None and use_kernel
            and self.weighting == "worker"
        ):
            cfg = dataclasses.replace(cfg, score_fn=fastpath.make_score_fn())
        self.sparsifier: Sparsifier = make_sparsifier(cfg)
        self.weights = torch.full(
            (self.n_workers,), 1.0 / self.n_workers, device=self.device
        )
        dp = (tuple(int(s) for s in self.dp_shape) if self.dp_shape
              else (self.n_workers,))
        if math.prod(dp) != self.n_workers:
            raise ValueError(
                f"dp_shape {dp} does not factor n_workers={self.n_workers}"
            )
        self._dp_sizes = dp
        self._codec = get_codec(self.codec)
        self._strategy = collectives.get_collective(self.resolved_collective)

    def _validate(self) -> None:
        if self.device.startswith("cuda") and not torch.cuda.is_available():
            raise RuntimeError(
                f"device={self.device!r} but CUDA is not available; pass "
                "device='cpu' to run the plain versions on the CPU"
            )
        if self.fastpath not in FASTPATH_MODES:
            raise ValueError(
                f"unknown fastpath {self.fastpath!r}; available: {FASTPATH_MODES}"
            )
        if self.participation is not None and not getattr(
            self.participation, "is_full", False
        ):
            raise _not_ported("participation", self.participation)
        if self.adaptive_k is not None:
            raise _not_ported("adaptive_k", self.adaptive_k)
        if self.overlap != "off":
            raise _not_ported("overlap", self.overlap)
        collectives.check_weighting(self.weighting)
        if self.weighting == "coordinate":
            if self.sparsifier_cfg.kind == "none":
                raise ValueError(
                    "weighting='coordinate' needs sparse payloads; "
                    "kind='none' sends every coordinate, so the sender "
                    "mass is uniformly 1 and coordinate weighting "
                    "degenerates to the worker reduction — use "
                    "weighting='worker'"
                )
            if self.fastpath == "on":
                raise ValueError(
                    "the fused score kernel bakes a scalar omega; "
                    "weighting='coordinate' requires fastpath='off' "
                    "(or 'auto', which declines the fusion)"
                )
        if self.codec == "auto":
            raise _not_ported("codec", self.codec)
        coll = self.resolved_collective
        if coll == "auto":
            raise _not_ported("collective", coll)
        if coll != "dense_allreduce" and self.sparsifier_cfg.kind == "hard_threshold":
            raise ValueError(
                "hard_threshold produces a variable-cardinality mask; the "
                f"fixed-k payload collective {coll!r} would silently drop "
                "coordinates beyond k. Use aggregation/collective="
                "'dense_allreduce' for hard_threshold (or a fixed-k "
                "sparsifier for payload collectives)."
            )

    @property
    def resolved_collective(self) -> str:
        return self.collective or self.aggregation

    @property
    def resolved_link_model(self) -> cost.LinkModel:
        """The per-axis topology when given, else the scalar model, else
        the defaults."""
        if self.link_topo is not None:
            return self.link_topo
        return self.link_model or cost.AlphaBeta()

    def init(self, theta0: torch.Tensor) -> SimState:
        theta0 = torch.as_tensor(theta0, device=self.device)
        return SimState(
            theta=theta0,
            worker_states=self.sparsifier.init(
                self.n_workers, self.length, theta0.dtype, self.device
            ),
            g_agg_prev=torch.zeros(self.length, dtype=theta0.dtype, device=self.device),
            step=0,
            # a neutral mass: round 0 scores plain Top-k (t == 0), and a
            # den of 1 keeps the posterior's unused branch finite
            w_agg_prev=(
                torch.ones(self.length, dtype=theta0.dtype, device=self.device)
                if self.weighting == "coordinate" else None
            ),
        )

    def step_fn(self, state: SimState) -> Tuple[SimState, torch.Tensor]:
        """One synchronous round; returns ``(new_state, g_agg)``. Under
        ``weighting="coordinate"`` the round also records the sender mass
        it divided by (``SimState.w_agg_prev``), which the next round's
        posterior conditions on."""
        widx = torch.arange(self.n_workers, device=self.device)
        grads = self.grad_fn(state.theta, widx)
        ghat, mask, new_ws = self.sparsifier.step(
            state.worker_states, grads, state.g_agg_prev,
            omega_prev=state.w_agg_prev,
        )
        coord = self.weighting == "coordinate"
        den = None
        # kind "none" has no fixed-k payload (its mask is all ones): it
        # always aggregates dense, as the distributed runtime does
        if (
            self.resolved_collective == "dense_allreduce"
            or self.sparsifier_cfg.kind == "none"
        ):
            if coord:
                # dense on the wire, but the sparsified gradient is zero
                # off the selected coordinates: presence names the senders
                presence = (ghat != 0).to(ghat.dtype)
                num = collectives.dense_mean(ghat, self.weights)
                den = collectives.dense_mean(presence, self.weights)
                g_agg = collectives._coord_divide(num, den)
            else:
                g_agg = collectives.dense_mean(ghat, self.weights)
        else:
            codec, L = self._codec, self.length
            k = sel_lib.sparsity_to_k(L, self.sparsifier.cfg.sparsity)
            vals, idx = sel_lib.mask_to_payload(mask, ghat, k)
            payloads = codec.encode(vals, idx, L)
            if not codec.lossless:
                # error feedback covers the codec: the decode residual
                # (transmitted minus intended) folds back through the
                # kind's own hook
                intended = torch.zeros_like(ghat).scatter_add_(1, idx, vals)
                sent = codec.decoded_dense(payloads, L)
                delta = (sent - intended).to(new_ws.eps.dtype)
                new_ws = self.sparsifier.on_wire_residual(new_ws, delta)
            if coord:
                g_agg, den = self._strategy.reference_coord(
                    codec, payloads, self.weights, L
                )
                g_agg = g_agg.to(ghat.dtype)
            else:
                g_agg = self._strategy.reference(
                    codec, payloads, self.weights, L
                ).to(ghat.dtype)
        new_state = SimState(
            theta=state.theta - self.learning_rate * g_agg,
            worker_states=new_ws,
            g_agg_prev=g_agg,
            step=state.step + 1,
            w_agg_prev=den.to(state.w_agg_prev.dtype) if coord else None,
        )
        return new_state, g_agg

    def wire_bytes_per_round(
        self, model: Optional[cost.LinkModel] = None
    ) -> cost.CostEstimate:
        """Per-worker alpha–beta cost of one round at this simulator's
        settings over its notional dp mesh (``dp_shape``); ``model``
        defaults to the simulator's own link model."""
        k = sel_lib.sparsity_to_k(self.length, self.sparsifier.cfg.sparsity)
        return cost.predict(
            self._codec,
            self.resolved_collective,
            self.length,
            k,
            self._dp_sizes,
            self.resolved_link_model if model is None else model,
        )

    def round_timeline(self, compute_seconds=None):
        raise NotImplementedError(
            "round_timeline needs comm/overlap.py; ROADMAP queue 1 item 6 "
            "ports it"
        )

    def run(
        self,
        theta0: torch.Tensor,
        n_steps: int,
        trace_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        trace_state_fn: Optional[Callable[[SimState], torch.Tensor]] = None,
    ):
        """``n_steps`` rounds; returns ``(final_state, trace [n_steps,
        ...])``. ``trace_fn`` maps each round's theta to a trace row
        (default: theta itself); ``trace_state_fn`` receives the whole new
        :class:`SimState` instead, and wins when both are given."""
        state = self.init(theta0)
        rows = []
        for _ in range(n_steps):
            state, _ = self.step_fn(state)
            if trace_state_fn is not None:
                rows.append(trace_state_fn(state))
            else:
                rows.append(trace_fn(state.theta) if trace_fn else state.theta)
        return state, torch.stack(rows)
