"""Adaptive compression controller: an error-budget-driven per-round k
(counterpart of ``repro.comm.controller``).

The measured ratio ``||eps|| / ||g_agg||`` says how much signal the wire
withholds. :class:`AdaptiveKController` smooths it with ``momentum``,
turns ``pressure = ratio / budget`` into a multiplicative k step clamped
to one ``gain`` factor a round and to the per-leaf bounds ``[k_min,
k_max]``, and keeps k still inside a relative ``hysteresis`` band around
pressure 1.

k stays a tensor operand: the round selects at the static capacity
``k_max`` and keeps the first k winners (``compact_select(k_dyn=...)``,
``Sparsifier.step_dyn``), so a change of k changes no shape. The ceil,
floor and clip run in float32, and ``pressure = ratio / budget`` is the
product with ``fl(1/budget)`` (``const_div``) that the jitted JAX law
computes.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels.regtopk_score import const_div

_TINY = 1e-30  # guards the error ratio against a zero aggregated gradient


class ControllerState(NamedTuple):
    """Per-leaf controller state, three scalar tensors.

    err_ratio — discounted ``||eps|| / ||g_agg||`` estimate (float32);
    k         — the k the next round sends (int32);
    t         — rounds observed (int32); t == 0 skips the discounting.
    """

    err_ratio: torch.Tensor
    k: torch.Tensor
    t: torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdaptiveKController:
    """Maps posterior error statistics to a per-round k.

    budget      — target error ratio ``||eps|| / ||g_agg||``;
    k_min/k_max — per-leaf bounds: values in (0, 1) are fractions of the
                  leaf length, values >= 1 absolute counts. ``k_max`` is
                  also the static payload capacity;
    momentum    — exponential discount on the measured ratio;
    hysteresis  — relative dead band around pressure 1;
    gain        — largest multiplicative k step per round (> 1).
    """

    budget: float
    k_min: float = 1.0
    k_max: float = 0.25
    momentum: float = 0.9
    hysteresis: float = 0.25
    gain: float = 2.0

    def __post_init__(self):
        if not self.budget > 0:
            raise ValueError(f"budget must be > 0, got {self.budget}")
        if not 0 <= self.momentum < 1:
            raise ValueError(
                f"momentum must be in [0, 1), got {self.momentum}"
            )
        if self.hysteresis < 0:
            raise ValueError(
                f"hysteresis must be >= 0, got {self.hysteresis}"
            )
        if not self.gain > 1:
            raise ValueError(f"gain must be > 1, got {self.gain}")
        if self.k_min <= 0 or self.k_max <= 0:
            raise ValueError(
                f"k bounds must be > 0, got [{self.k_min}, {self.k_max}]"
            )
        same_kind = (self.k_min < 1) == (self.k_max < 1)
        if same_kind and self.k_min > self.k_max:
            raise ValueError(f"k_min {self.k_min} > k_max {self.k_max}")

    def bounds(self, length: int) -> Tuple[int, int]:
        """``[k_min, k_max]`` as absolute ints for one leaf: fractions go
        through ``sparsity_to_k``'s epsilon-tolerant ceil, counts clip to
        ``[1, length]``, and the pair must stay ordered.

        >>> AdaptiveKController(budget=0.5).bounds(1000)
        (1, 250)
        >>> AdaptiveKController(budget=0.5, k_min=0.01, k_max=64).bounds(1000)
        (10, 64)
        """
        from repro_torch.core.selectors import sparsity_to_k

        def resolve(b: float) -> int:
            if b < 1.0:
                return sparsity_to_k(length, b)
            return max(1, min(int(length), int(b)))

        lo, hi = resolve(self.k_min), resolve(self.k_max)
        if lo > hi:
            raise ValueError(
                f"k bounds [{self.k_min}, {self.k_max}] resolve to "
                f"[{lo}, {hi}] on a length-{length} leaf"
            )
        return lo, hi

    def init(self, k0: int, k_min: int, k_max: int,
             device="cuda") -> ControllerState:
        """Start at the static k, clipped into the bounds, on ``device``.

        >>> st = AdaptiveKController(budget=0.5).init(5, 1, 250, device="cpu")
        >>> int(st.k), int(st.t)
        (5, 0)
        """
        k = max(int(k_min), min(int(k_max), int(k0)))
        return ControllerState(
            err_ratio=torch.zeros((), device=device),
            k=torch.tensor(k, dtype=torch.int32, device=device),
            t=torch.zeros((), dtype=torch.int32, device=device),
        )

    def plan_k(self, err_ratio: torch.Tensor, k: torch.Tensor,
               k_min: int, k_max: int) -> torch.Tensor:
        """One multiplicative k update: above the dead band ``ceil(k *
        min(pressure, gain))``, below it ``floor(k * max(pressure,
        1/gain))``, inside it k; clipped to ``[k_min, k_max]``.

        >>> c = AdaptiveKController(budget=0.1, hysteresis=0.25, gain=2.0)
        >>> int(c.plan_k(torch.tensor(0.4), torch.tensor(16), 1, 256))
        32
        >>> int(c.plan_k(torch.tensor(0.025), torch.tensor(16), 1, 256))
        8
        >>> int(c.plan_k(torch.tensor(0.11), torch.tensor(16), 1, 256))
        16
        """
        pressure = const_div(err_ratio.float(), self.budget)
        scale = torch.clamp(pressure, 1.0 / self.gain, self.gain)
        kf = k.float()
        kept = torch.where(
            pressure > 1.0 + self.hysteresis,
            torch.ceil(kf * scale),
            torch.where(
                pressure < 1.0 - self.hysteresis, torch.floor(kf * scale), kf
            ),
        )
        return torch.clamp(kept, k_min, k_max).to(torch.int32)

    def observe(self, state: ControllerState, eps_norm: torch.Tensor,
                g_norm: torch.Tensor, *, k_min: int,
                k_max: int) -> ControllerState:
        """Fold one round's norms into the state and plan the next k: the
        raw ratio ``eps_norm / max(g_norm, tiny)`` seeds the estimate on
        the first observation and is discounted with ``momentum`` after.

        >>> c = AdaptiveKController(budget=0.1, momentum=0.5)
        >>> st = c.observe(c.init(16, 1, 256, device="cpu"), torch.tensor(4.0),
        ...                torch.tensor(10.0), k_min=1, k_max=256)
        >>> round(float(st.err_ratio), 3), int(st.k)
        (0.4, 32)
        """
        raw = eps_norm.float() / torch.clamp(g_norm.float(), min=_TINY)
        smoothed = torch.where(
            state.t == 0,
            raw,
            self.momentum * state.err_ratio + (1.0 - self.momentum) * raw,
        )
        return ControllerState(
            err_ratio=smoothed,
            k=self.plan_k(smoothed, state.k, k_min, k_max),
            t=state.t + 1,
        )


def round_wire_bits(codec: str, length: int, k: int) -> int:
    """Bits one worker's payload puts on the wire at k: the controller
    reasons about k alone, and the codec prices it.

    >>> round_wire_bits("coo_fp32", 1000, 10)
    640
    """
    from repro_torch.comm.codec import get_codec

    return int(get_codec(codec).wire_bits(int(length), int(k)))


def parse_adaptive_k(spec: str) -> AdaptiveKController:
    """Parse the trainer's ``--adaptive-k budget[,k_min,k_max]`` spec.

    >>> parse_adaptive_k("0.1").budget
    0.1
    >>> c = parse_adaptive_k("0.1,4,64")
    >>> (c.k_min, c.k_max)
    (4.0, 64.0)
    """
    parts = [p.strip() for p in spec.split(",") if p.strip()]
    if len(parts) not in (1, 3):
        raise ValueError(
            f"expected 'budget' or 'budget,k_min,k_max', got {spec!r}"
        )
    try:
        nums = [float(p) for p in parts]
    except ValueError:
        raise ValueError(f"non-numeric --adaptive-k field in {spec!r}") from None
    if len(nums) == 1:
        return AdaptiveKController(budget=nums[0])
    return AdaptiveKController(budget=nums[0], k_min=nums[1], k_max=nums[2])
