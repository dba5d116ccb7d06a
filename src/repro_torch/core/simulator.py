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

Partial participation (``repro_torch.comm.participation``) masks the
round and renormalizes the weights; a dropped worker's state is rewritten
by its kind's ``Sparsifier.on_dropped``; ``stale`` parks a straggler's
discounted contribution in the pending buffer and delivers it exactly
once; ``sampled`` gathers the S drawn clients, runs the round over S and
scatters their states back, O(S·J) a round. The adaptive-k controller
(``repro_torch.comm.controller``) sends its planned k through
``Sparsifier.step_dyn`` at the capacity ``k_max`` and observes the mean
per-worker ``||eps||`` against ``||g_agg||`` after each round. The four
codecs (a lossy codec's decode residual folds back through
``Sparsifier.on_wire_residual``), the three collectives, both weightings
and the alpha–beta cost of a round (:meth:`DistributedSim.
wire_bytes_per_round`) are the JAX simulator's. ``codec="auto"`` /
``collective="auto"`` pick the single leaf's wire at construction with
``repro_torch.comm.autotune.choose_leaf``, as ``build_plan`` picks a
leaf's; ``overlap="buckets:B"`` clamps to one bucket (one leaf) and
leaves the numbers alone, and :meth:`DistributedSim.round_timeline`
prices its schedule.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.comm import autotune, collectives, cost, fastpath
from repro_torch.comm import overlap as overlap_lib
from repro_torch.comm.codec import get_codec
from repro_torch.comm.controller import AdaptiveKController, ControllerState
from repro_torch.comm.participation import Participation
from repro_torch.core import selectors as sel_lib
from repro_torch.core.sparsify import (
    DenseState,
    Sparsifier,
    SparsifierConfig,
    make_sparsifier,
)
from repro_torch.kernels.regtopk_score import ordered_mean

FASTPATH_MODES = ("off", "on", "auto")


class SimState(NamedTuple):
    theta: torch.Tensor  # [J]  global model
    worker_states: DenseState  # slots with a leading [N]
    g_agg_prev: torch.Tensor  # [J]  last broadcast aggregated gradient
    step: int  # rounds taken
    # the undelivered payloads of the stragglers (``stale`` only, else
    # None): each worker's weighted, discounted contribution not yet
    # broadcast, and the rounds to its delivery (0: an empty slot)
    pending: Optional[torch.Tensor] = None  # [N, J]
    pending_age: Optional[torch.Tensor] = None  # [N] int32
    # the adaptive-k controller's state (None when it is off)
    ctrl: Optional[ControllerState] = None
    # the per-coordinate sender mass den[j] the server divided by last
    # round (weighting="coordinate" only; None is worker weighting): the
    # coordinate-wise omega RegTop-k's posterior conditions on
    w_agg_prev: Optional[torch.Tensor] = None  # [J]


def _rows_where(keep: torch.Tensor, live: DenseState,
                gone: DenseState) -> DenseState:
    """Per worker, ``live``'s slots where ``keep`` ``[N]`` is true, else
    ``gone``'s."""
    return DenseState(*(
        torch.where(keep.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
        for a, b in zip(live, gone, strict=True)
    ))


@dataclasses.dataclass
class DistributedSim:
    """``grad_fn(theta [J], worker indices [n]) -> [n, J]`` local
    gradients; ``device`` holds every tensor of the run (the card unless
    the caller asks for ``"cpu"``).

    ``dp_shape`` factors the ``n_workers`` ring into a notional multi-axis
    dp mesh (outermost first) for the cost model; the simulated numbers do
    not depend on it. ``link_topo`` (one ``cost.AlphaBeta`` per axis) wins
    over the scalar ``link_model``. ``participation`` (a
    ``comm.participation.Participation``; None or a full schedule is the
    all-workers round, bit for bit) and ``adaptive_k`` (a
    ``comm.controller.AdaptiveKController``; None is the static k, bit for
    bit) are the JAX simulator's. ``codec``/``collective`` take
    ``"auto"``, resolved at construction on the dp layout and link model;
    ``overlap`` (``"off"`` or ``"buckets:B"``) prices
    :meth:`round_timeline` and leaves the numbers alone."""

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
    participation: Optional[Participation] = None
    fastpath: str = "off"
    adaptive_k: Optional[AdaptiveKController] = None
    weighting: str = "worker"
    overlap: str = "off"
    device: str = "cuda"

    def __post_init__(self):
        # a bad spec fails here, not at the first round_timeline()
        self._overlap_cfg = overlap_lib.parse_overlap(self.overlap)
        self._validate()
        # a partial schedule aggregates with its effective weight: the
        # renormalized 1/E|P_t|, 1/S for client sampling, and under
        # 'stale' the on-time plus discounted late mass
        part = self._part
        omega = (1.0 / self.n_workers if part is None
                 else part.effective_omega(self.n_workers))
        cfg = dataclasses.replace(self.sparsifier_cfg, omega=omega)
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
        # the adaptive capacity k_max is the payload every round ships
        self._k_bounds: Optional[Tuple[int, int]] = (
            None if self.adaptive_k is None
            else self.adaptive_k.bounds(self.length)
        )
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
        if self.codec == "auto" or self.resolved_collective == "auto":
            self._plan_wire(cfg.kind)
        coll = self.resolved_collective
        self._codec = get_codec(self.codec)
        self._strategy = collectives.get_collective(coll)
        if coll != "dense_allreduce" and cfg.kind == "hard_threshold":
            raise ValueError(
                "hard_threshold produces a variable-cardinality mask; the "
                f"fixed-k payload collective {coll!r} would silently drop "
                "coordinates beyond k. Use aggregation/collective="
                "'dense_allreduce' for hard_threshold (or a fixed-k "
                "sparsifier for payload collectives)."
            )

    def _plan_wire(self, kind: str) -> None:
        """The single leaf's ``build_plan`` auto planning: the payload
        capacity priced on the dp layout, the link model and the expected
        participants, under ``autotune.auto_candidates``."""
        d = autotune.choose_leaf(
            self.length, self._k_payload, self._dp_sizes,
            self.resolved_link_model, participants=self._participants,
            **autotune.auto_candidates(kind, self.codec,
                                       self.resolved_collective),
        )
        if self.codec == "auto":
            self.codec = d.codec
        self.collective = self.aggregation = d.collective

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
        if self.participation is not None:
            self.participation.validate(self.n_workers)
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
            if self._part is not None and self._part.delays_payloads:
                raise ValueError(
                    "weighting='coordinate' does not compose with the "
                    "'stale' schedule: late payloads are folded into the "
                    "broadcast after the per-coordinate renormalization, "
                    "so the sender mass the server divided by would not "
                    "cover them"
                )
            if self.fastpath == "on":
                raise ValueError(
                    "the fused score kernel bakes a scalar omega; "
                    "weighting='coordinate' requires fastpath='off' "
                    "(or 'auto', which declines the fusion)"
                )
        if self.adaptive_k is not None:
            if self.sparsifier_cfg.kind not in ("topk", "regtopk"):
                raise ValueError(
                    "adaptive_k drives magnitude-scored fixed-k kinds "
                    f"('topk'/'regtopk'); got {self.sparsifier_cfg.kind!r}"
                )
            if self.sparsifier_cfg.selector != "exact":
                raise ValueError(
                    "adaptive_k requires selector='exact' (the capacity-"
                    "bounded stable top-k); got "
                    f"{self.sparsifier_cfg.selector!r}"
                )

    @property
    def resolved_collective(self) -> str:
        return self.collective or self.aggregation

    @property
    def _part(self) -> Optional[Participation]:
        """The schedule when it drops or delays anyone, else None."""
        part = self.participation
        return None if part is None or part.is_full else part

    @property
    def _participants(self) -> Optional[float]:
        """Expected on-time workers per round for the cost model (None
        when every round is full)."""
        part = self._part
        return None if part is None else part.expected_participants(self.n_workers)

    @property
    def _k_payload(self) -> int:
        """The payload's slots: the adaptive capacity k_max, else the
        static k."""
        if self._k_bounds is not None:
            return self._k_bounds[1]
        return sel_lib.sparsity_to_k(self.length, self.sparsifier.cfg.sparsity)

    @property
    def resolved_link_model(self) -> cost.LinkModel:
        """The per-axis topology when given, else the scalar model, else
        the defaults."""
        if self.link_topo is not None:
            return self.link_topo
        return self.link_model or cost.AlphaBeta()

    def init(self, theta0: torch.Tensor) -> SimState:
        theta0 = torch.as_tensor(theta0, device=self.device)
        N, L, dev = self.n_workers, self.length, self.device
        stale = self._part is not None and self._part.delays_payloads
        ctrl = None
        if self.adaptive_k is not None:
            k0 = sel_lib.sparsity_to_k(L, self.sparsifier.cfg.sparsity)
            ctrl = self.adaptive_k.init(k0, *self._k_bounds, device=dev)
        return SimState(
            theta=theta0,
            worker_states=self.sparsifier.init(N, L, theta0.dtype, dev),
            g_agg_prev=torch.zeros(L, dtype=theta0.dtype, device=dev),
            step=0,
            pending=(torch.zeros((N, L), dtype=theta0.dtype, device=dev)
                     if stale else None),
            pending_age=(torch.zeros(N, dtype=torch.int32, device=dev)
                         if stale else None),
            ctrl=ctrl,
            # a neutral mass: round 0 scores plain Top-k (t == 0), and a
            # den of 1 keeps the posterior's unused branch finite
            w_agg_prev=(
                torch.ones(L, dtype=theta0.dtype, device=dev)
                if self.weighting == "coordinate" else None
            ),
        )

    def step_fn(self, state: SimState) -> Tuple[SimState, torch.Tensor]:
        """One synchronous round; returns ``(new_state, g_agg)``. Under
        ``weighting="coordinate"`` the round also records the sender mass
        it divided by (``SimState.w_agg_prev``), which the next round's
        posterior conditions on. Under a partial schedule only the
        participants aggregate, with renormalized weights; ``g_agg_prev``
        is always what the server broadcast, late deliveries included."""
        part, dev = self._part, self.device
        stale = part is not None and part.delays_payloads
        sampled = part is not None and part.kind == "sampled"
        pmask = None
        if sampled:
            # client sampling: the round runs over the S drawn clients;
            # the others are idle and their state is untouched
            widx = part.round_participants(state.step, self.n_workers, dev)
            round_ws = DenseState(*(x[widx] for x in state.worker_states))
            weights = torch.full((widx.shape[0],), 1.0 / widx.shape[0],
                                 device=dev)
        else:
            widx = torch.arange(self.n_workers, device=dev)
            round_ws, weights = state.worker_states, self.weights
            if part is not None:
                pmask = part.round_mask(state.step, self.n_workers, dev)
        grads = self.grad_fn(state.theta, widx)
        if self.adaptive_k is None:
            ghat, mask, new_ws = self.sparsifier.step(
                round_ws, grads, state.g_agg_prev, omega_prev=state.w_agg_prev,
            )
        else:
            # the round sends the k the controller planned last round
            ghat, mask, new_ws = self.sparsifier.step_dyn(
                round_ws, grads, state.g_agg_prev, state.ctrl.k,
                self._k_bounds[1], omega_prev=state.w_agg_prev,
            )
        # a dropped worker's payload never travelled: no codec residual
        # applies to it, so on_dropped reads the state before the fold
        pre_ws = new_ws
        coord = self.weighting == "coordinate"
        den = None
        sent_stack = ghat  # each worker's contribution as the server decodes it
        # kind "none" has no fixed-k payload (its mask is all ones): it
        # always aggregates dense, as the distributed runtime does
        if (
            self.resolved_collective == "dense_allreduce"
            or self.sparsifier_cfg.kind == "none"
        ):
            w = weights if pmask is None else part.participating_weights(
                weights, state.step)
            if coord:
                # dense on the wire, but the sparsified gradient is zero
                # off the selected coordinates: presence names the senders
                presence = (ghat != 0).to(ghat.dtype)
                num = collectives.dense_mean(ghat, w)
                den = collectives.dense_mean(presence, w)
                g_agg = collectives._coord_divide(num, den)
            else:
                g_agg = collectives.dense_mean(ghat, w)
        else:
            codec, L = self._codec, self.length
            vals, idx = sel_lib.mask_to_payload(mask, ghat, self._k_payload)
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
                    codec, payloads, weights, L, participation=pmask
                )
                g_agg = g_agg.to(ghat.dtype)
            else:
                g_agg = self._strategy.reference(
                    codec, payloads, weights, L, participation=pmask
                ).to(ghat.dtype)
            if stale:
                sent_stack = codec.decoded_dense(payloads, L).to(ghat.dtype)
        pending, pending_age = state.pending, state.pending_age
        if stale:
            g_agg, pending, pending_age = self._deliver(
                state, pmask, g_agg, sent_stack)
        elif pmask is not None:
            # dropped workers sent nothing; the rewrite of their slots is
            # their kind's (Sparsifier.on_dropped)
            dropped_ws = self.sparsifier.on_dropped(
                state.worker_states, pre_ws, ghat)
            new_ws = _rows_where(pmask > 0, new_ws, dropped_ws)
        ctrl = state.ctrl
        if self.adaptive_k is not None:
            # the finished round's error statistics: the mean per-worker
            # ||eps|| (codec residual included; the S active clients when
            # sampling) against the broadcast ||g_agg||
            eps = new_ws.eps.float()
            norms = torch.sqrt((eps * eps).sum(-1))
            eps_norm = ordered_mean(norms)
            ga = g_agg.float()
            g_norm = torch.sqrt((ga * ga).sum())
            lo, hi = self._k_bounds
            ctrl = self.adaptive_k.observe(ctrl, eps_norm, g_norm,
                                           k_min=lo, k_max=hi)
        if sampled:
            # the S updated states go back into the fleet
            full = state.worker_states
            new_ws = DenseState(*(
                x.index_copy(0, widx, sub)
                for x, sub in zip(full, new_ws, strict=True)
            ))
        new_state = SimState(
            theta=state.theta - self.learning_rate * g_agg,
            worker_states=new_ws,
            g_agg_prev=g_agg,
            step=state.step + 1,
            pending=pending,
            pending_age=pending_age,
            ctrl=ctrl,
            w_agg_prev=den.to(state.w_agg_prev.dtype) if coord else None,
        )
        return new_state, g_agg

    def _deliver(self, state: SimState, pmask: torch.Tensor,
                 g_agg: torch.Tensor, sent_stack: torch.Tensor):
        """Bounded-staleness delivery: this round's stragglers park
        ``omega_n * discount`` times their decoded contribution; a parked
        payload lands exactly once, when its countdown reaches one, or
        early if its worker straggles again first. Returns ``(g_agg with
        the deliveries, pending, pending_age)``."""
        pending, age = state.pending, state.pending_age
        dropped = 1.0 - pmask
        deliver = (age > 0) & ((age == 1) | (dropped > 0))
        delivered = (deliver.to(g_agg.dtype)[:, None] * pending).sum(0)
        g_agg = g_agg + delivered.to(g_agg.dtype)
        contrib = (dropped * self.weights * self._part.discount)[:, None] * sent_stack
        pending = torch.where(
            dropped[:, None] > 0, contrib,
            torch.where(deliver[:, None], 0.0, pending),
        )
        age = torch.where(
            dropped > 0,
            self._part.staleness,
            torch.where(deliver, 0, torch.clamp(age - 1, min=0)),
        ).to(torch.int32)
        return g_agg, pending, age

    def wire_bytes_per_round(
        self, model: Optional[cost.LinkModel] = None
    ) -> cost.CostEstimate:
        """Per-worker alpha–beta cost of one round at this simulator's
        settings over its notional dp mesh (``dp_shape``); ``model``
        defaults to the simulator's own link model. A partial schedule
        prices its expected participants; adaptive runs price the payload
        capacity k_max (the bits at the controller's k are
        ``comm.controller.round_wire_bits``)."""
        return cost.predict(
            self._codec,
            self.resolved_collective,
            self.length,
            self._k_payload,
            self._dp_sizes,
            self.resolved_link_model if model is None else model,
            participants=self._participants,
        )

    def round_timeline(self, compute_seconds=None):
        """``(BucketPlan, Timeline)`` of one round under ``overlap``
        (raises when "off"), as ``distributed.comm_round_timeline`` prices
        the trainer's: the single leaf clamps to one bucket, so the
        timeline's seconds are ``wire_bytes_per_round()``'s."""
        if self._overlap_cfg is None:
            raise ValueError(
                "round_timeline needs overlap != 'off' "
                "(e.g. overlap='buckets:4')"
            )
        lc = overlap_lib.leaf_cost(
            self._codec, self.resolved_collective, self.length,
            self._k_payload, self._dp_sizes, self.resolved_link_model,
            participants=self._participants,
        )
        bplan = overlap_lib.bucketize([lc], self._overlap_cfg)
        return bplan, overlap_lib.overlap_timeline(bplan, compute_seconds)

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
