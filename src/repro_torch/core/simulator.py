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
so the two runs agree bit for bit on the card.

Ported: full participation, ``weighting="worker"``, static k, no overlap,
the ``coo_fp32`` codec and the ``dense_allreduce`` / ``sparse_allgather``
reductions. Every other option raises ``ValueError`` naming the ROADMAP
queue 1 item that ports it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.comm import collectives, fastpath
from repro_torch.comm.codec import get_codec
from repro_torch.core import selectors as sel_lib
from repro_torch.core.sparsify import (
    DenseState,
    Sparsifier,
    SparsifierConfig,
    make_sparsifier,
)

FASTPATH_MODES = ("off", "on", "auto")
# the JAX package's other codecs and collectives, and the ROADMAP queue 1
# item that ports each
_LATER_CODECS = {
    "coo_idx_delta": 3, "bitmap_dense": 3, "coo_q8": 3, "auto": 6,
}
_LATER_COLLECTIVES = {"hierarchical": 4, "auto": 6}


def _not_ported(option: str, value, item: int) -> ValueError:
    return ValueError(
        f"{option}={value!r} is not ported; ROADMAP queue 1 item {item} "
        "ports it"
    )


class SimState(NamedTuple):
    theta: torch.Tensor  # [J]  global model
    worker_states: DenseState  # slots with a leading [N]
    g_agg_prev: torch.Tensor  # [J]  last broadcast aggregated gradient
    step: int  # rounds taken


@dataclasses.dataclass
class DistributedSim:
    """``grad_fn(theta [J], worker indices [n]) -> [n, J]`` local
    gradients; ``device`` holds every tensor of the run (the card unless
    the caller asks for ``"cpu"``)."""

    grad_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    n_workers: int
    length: int
    sparsifier_cfg: SparsifierConfig
    learning_rate: float = 1e-2
    aggregation: str = "dense_allreduce"  # legacy alias for ``collective``
    codec: str = "coo_fp32"
    collective: Optional[str] = None
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
        if cfg.kind == "regtopk" and cfg.score_fn is None and use_kernel:
            cfg = dataclasses.replace(cfg, score_fn=fastpath.make_score_fn())
        self.sparsifier: Sparsifier = make_sparsifier(cfg)
        self.weights = torch.full(
            (self.n_workers,), 1.0 / self.n_workers, device=self.device
        )
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
            raise _not_ported("participation", self.participation, 6)
        if self.adaptive_k is not None:
            raise _not_ported("adaptive_k", self.adaptive_k, 6)
        if self.overlap != "off":
            raise _not_ported("overlap", self.overlap, 6)
        if self.weighting == "coordinate":
            raise _not_ported("weighting", self.weighting, 4)
        if self.weighting != "worker":
            raise ValueError(
                f"unknown weighting {self.weighting!r}; available: "
                "('worker', 'coordinate')"
            )
        if self.codec in _LATER_CODECS:
            raise _not_ported("codec", self.codec, _LATER_CODECS[self.codec])
        coll = self.resolved_collective
        if coll in _LATER_COLLECTIVES:
            raise _not_ported("collective", coll, _LATER_COLLECTIVES[coll])
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

    def init(self, theta0: torch.Tensor) -> SimState:
        theta0 = torch.as_tensor(theta0, device=self.device)
        return SimState(
            theta=theta0,
            worker_states=self.sparsifier.init(
                self.n_workers, self.length, theta0.dtype, self.device
            ),
            g_agg_prev=torch.zeros(self.length, dtype=theta0.dtype, device=self.device),
            step=0,
        )

    def step_fn(self, state: SimState) -> Tuple[SimState, torch.Tensor]:
        """One synchronous round; returns ``(new_state, g_agg)``."""
        widx = torch.arange(self.n_workers, device=self.device)
        grads = self.grad_fn(state.theta, widx)
        ghat, mask, new_ws = self.sparsifier.step(
            state.worker_states, grads, state.g_agg_prev
        )
        # kind "none" has no fixed-k payload (its mask is all ones): it
        # always aggregates dense, as the distributed runtime does
        if (
            self.resolved_collective == "dense_allreduce"
            or self.sparsifier_cfg.kind == "none"
        ):
            g_agg = collectives.dense_mean(ghat, self.weights)
        else:
            L = self.length
            k = sel_lib.sparsity_to_k(L, self.sparsifier.cfg.sparsity)
            vals, idx = sel_lib.mask_to_payload(mask, ghat, k)
            payloads = self._codec.encode(vals, idx, L)
            g_agg = self._strategy.reference(
                self._codec, payloads, self.weights, L
            ).to(ghat.dtype)
        new_state = SimState(
            theta=state.theta - self.learning_rate * g_agg,
            worker_states=new_ws,
            g_agg_prev=g_agg,
            step=state.step + 1,
        )
        return new_state, g_agg

    def wire_bytes_per_round(self, model=None):
        raise NotImplementedError(
            "wire_bytes_per_round needs comm/cost.py; ROADMAP queue 1 item 3 "
            "ports it"
        )

    def round_timeline(self, compute_seconds=None):
        raise NotImplementedError(
            "round_timeline needs comm/cost.py and comm/overlap.py; ROADMAP "
            "queue 1 items 3 and 6 port them"
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
