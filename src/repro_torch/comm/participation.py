"""Partial-participation round schedules (counterpart of
``repro.comm.participation``).

A :class:`Participation` is a deterministic per-round schedule over the
flat data-parallel worker group. It composes with every collective
through one rule: mask the aggregation weights, then renormalize them
(:func:`renormalize_weights`). The collectives' ``reference`` forms take
the round's ``[N]`` mask; their ``shard`` forms take this rank's own
entry, with the participant weight every rank derives from the shared
schedule (``repro_torch.comm.collectives``).

Schedules (``kind``), as in the JAX package:

* ``full``        — every worker, every round; callers skip the
  participation logic entirely (:attr:`Participation.is_full`), so a full
  schedule is the no-participation path bit for bit;
* ``bernoulli``   — each worker drops with probability ``drop_rate``;
  worker ``round % N`` is always kept, so the renormalization stays
  finite;
* ``round_robin`` — ``n_stragglers`` consecutive workers, rotating by
  ``n_stragglers`` a round, miss each round;
* ``stale``       — the ``round_robin`` pattern, but a straggler's payload
  arrives ``staleness`` rounds late with weight ``discount * omega_n``
  (the simulator's pending buffer delivers it exactly once);
* ``sampled``     — exactly ``n_sampled`` of ``N`` clients a round; the
  others are idle and their state is untouched.

``full``, ``round_robin`` and ``stale`` are integer functions of the round
index and equal the JAX package's masks exactly. ``bernoulli`` and
``sampled`` draw where the JAX package draws with ``jax.random``, which
torch cannot reproduce: here from a CPU ``torch.Generator`` seeded from
``(seed, round)`` (:func:`round_generator`). The draw stays common
knowledge (every rank computes the same mask without communication) and
keeps the JAX package's invariants, but the streams differ from JAX's.

Masks are computed on the CPU and moved to ``device`` on request.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

PARTICIPATION_KINDS = ("full", "bernoulli", "round_robin", "stale", "sampled")


_M64 = (1 << 64) - 1


def round_generator(seed: int, round_idx: int) -> torch.Generator:
    """The CPU generator of one round's draw. The CPU generator keeps 32
    bits of its seed, so ``(seed, round)`` (seed high, round low) goes
    through splitmix64's finalizer and its low 32 bits seed the stream:
    every pair has its own stream, and every rank draws the same one.

    >>> a = torch.rand(3, generator=round_generator(0, 5))
    >>> torch.equal(a, torch.rand(3, generator=round_generator(0, 5)))
    True
    >>> torch.equal(a, torch.rand(3, generator=round_generator(1, 5)))
    False
    """
    x = ((int(seed) & 0xFFFFFFFF) << 32) | (int(round_idx) & 0xFFFFFFFF)
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return torch.Generator().manual_seed((x ^ (x >> 31)) & 0xFFFFFFFF)


@dataclasses.dataclass(frozen=True)
class Participation:
    """Deterministic per-round participation schedule over ``N`` workers.

    >>> Participation("full").is_full
    True
    >>> Participation("bogus")
    Traceback (most recent call last):
        ...
    ValueError: unknown participation kind 'bogus'; available: \
['full', 'bernoulli', 'round_robin', 'stale', 'sampled']
    """

    kind: str = "full"
    drop_rate: float = 0.0  # bernoulli: per-worker drop probability
    n_stragglers: int = 1  # round_robin/stale: dropped per round
    staleness: int = 1  # stale: rounds until the late payload lands
    discount: float = 1.0  # stale: weight multiplier on late payloads
    n_sampled: int = 1  # sampled: clients drawn per round
    seed: int = 0  # bernoulli/sampled generator seed

    def __post_init__(self):
        if self.kind not in PARTICIPATION_KINDS:
            raise ValueError(
                f"unknown participation kind {self.kind!r}; available: "
                f"{list(PARTICIPATION_KINDS)}"
            )
        if not 0.0 <= self.drop_rate < 1.0:
            raise ValueError(
                f"drop_rate must be in [0, 1), got {self.drop_rate}"
            )
        for name in ("n_stragglers", "staleness", "n_sampled"):
            if getattr(self, name) < 1:
                raise ValueError(
                    f"{name} must be >= 1, got {getattr(self, name)}"
                )
        if self.discount < 0.0:
            raise ValueError(f"discount must be >= 0, got {self.discount}")

    @property
    def is_full(self) -> bool:
        """True when the schedule never drops anyone."""
        return self.kind == "full" or (
            self.kind == "bernoulli" and self.drop_rate == 0.0
        )

    @property
    def delays_payloads(self) -> bool:
        """True when dropped payloads arrive late (``stale``) instead of
        staying in the worker's error accumulator."""
        return self.kind == "stale"

    def validate(self, n_workers: int) -> "Participation":
        """Check the schedule is realizable over ``n_workers``.

        >>> Participation("round_robin", n_stragglers=4).validate(4)
        Traceback (most recent call last):
            ...
        ValueError: n_stragglers=4 would drop every one of the 4 workers
        """
        if not self.is_full and n_workers < 2:
            raise ValueError(
                "a non-full participation schedule needs a dp group of "
                f"at least 2 workers, got {n_workers}"
            )
        if (
            self.kind in ("round_robin", "stale")
            and self.n_stragglers >= n_workers
        ):
            raise ValueError(
                f"n_stragglers={self.n_stragglers} would drop every one "
                f"of the {n_workers} workers"
            )
        if self.kind == "sampled" and self.n_sampled > n_workers:
            raise ValueError(
                f"n_sampled={self.n_sampled} exceeds the fleet size "
                f"{n_workers}"
            )
        return self

    def round_mask(self, round_idx: int, n_workers: int,
                   device="cuda") -> torch.Tensor:
        """``{0,1}`` float32 mask ``[N]`` of the round's participants on
        ``device``, a function of ``(schedule, round_idx)`` alone.

        >>> rr = Participation("round_robin", n_stragglers=1)
        >>> rr.round_mask(0, 4, device="cpu").tolist()
        [0.0, 1.0, 1.0, 1.0]
        >>> rr.round_mask(2, 4, device="cpu").tolist()
        [1.0, 1.0, 0.0, 1.0]
        """
        n, r = int(n_workers), int(round_idx)
        if self.is_full:
            return torch.ones(n, device=device)
        if self.kind == "bernoulli":
            gen = round_generator(self.seed, r)
            keep = torch.rand(n, generator=gen) < 1.0 - self.drop_rate
            keep[r % n] = True  # liveness: the weights stay finite
            return keep.float().to(device)
        mask = torch.zeros(n)
        if self.kind == "sampled":
            mask[self.round_participants(r, n, device="cpu")] = 1.0
            return mask.to(device)
        # round_robin / stale: n_stragglers consecutive workers rotate out;
        # r * ns wraps in int32, as the JAX package's traced product does
        ns = min(int(self.n_stragglers), n - 1)
        start = torch.tensor(r, dtype=torch.int32) * ns
        dropped = torch.remainder(start + torch.arange(ns, dtype=torch.int32), n)
        mask.fill_(1.0)
        mask[dropped.long()] = 0.0
        return mask.to(device)

    def round_participants(self, round_idx: int, n_workers: int,
                           device="cuda") -> torch.Tensor:
        """``sampled`` only: the round's cohort on ``device``, ``[S]``
        sorted distinct int64 worker indices (torch's indexing type; the
        JAX package's are int32).

        >>> p = Participation("sampled", n_sampled=2, seed=0)
        >>> s = p.round_participants(0, 6, device="cpu")
        >>> s.shape, bool((s[1:] > s[:-1]).all())
        (torch.Size([2]), True)
        >>> Participation("full").round_participants(0, 6, device="cpu")
        Traceback (most recent call last):
            ...
        ValueError: round_participants is defined for kind='sampled', \
got 'full'
        """
        if self.kind != "sampled":
            raise ValueError(
                "round_participants is defined for kind='sampled', "
                f"got {self.kind!r}"
            )
        n = int(n_workers)
        s = min(int(self.n_sampled), n)
        perm = torch.randperm(n, generator=round_generator(self.seed, round_idx))
        # ascending: the aggregation order does not depend on the draw
        return torch.sort(perm[:s]).values.to(device)

    def participating_weights(self, weights: torch.Tensor,
                              round_idx: int) -> torch.Tensor:
        """The round's aggregation weights: ``weights`` masked to the
        participants and renormalized to sum to one.

        >>> p = Participation("round_robin", n_stragglers=1)
        >>> p.participating_weights(torch.full((4,), 0.25), 0).tolist()
        [0.0, 0.3333333432674408, 0.3333333432674408, 0.3333333432674408]
        """
        if self.is_full:
            return weights
        mask = self.round_mask(round_idx, weights.shape[0], weights.device)
        return renormalize_weights(weights, mask)

    def expected_participants(self, n_workers: int) -> float:
        """Expected on-time workers per round, what the cost model prices
        a partial round with.

        >>> Participation("round_robin", n_stragglers=2).expected_participants(8)
        6.0
        >>> Participation("bernoulli", drop_rate=0.5).expected_participants(9)
        5.0
        """
        n = int(n_workers)
        if self.is_full:
            return float(n)
        if self.kind == "bernoulli":
            return 1.0 + (n - 1) * (1.0 - self.drop_rate)
        if self.kind == "sampled":
            return float(min(int(self.n_sampled), n))
        return float(n - min(int(self.n_stragglers), n - 1))

    def effective_omega(self, n_workers: int) -> float:
        """The aggregation weight a worker's own contribution carries in
        the broadcast, which RegTop-k's posterior subtracts: ``1 /
        E|P_t|`` for the dropping and sampling schedules, and under
        ``stale`` the on-time plus discounted late mass ``1/N + ns *
        discount / N**2``.

        >>> Participation("stale", n_stragglers=1, discount=0.5).effective_omega(4)
        0.28125
        >>> Participation("full").effective_omega(4)
        0.25
        """
        n = int(n_workers)
        if self.kind == "stale":
            ns = min(int(self.n_stragglers), n - 1)
            return 1.0 / n + ns * self.discount / float(n) ** 2
        return 1.0 / self.expected_participants(n)


def renormalize_weights(weights: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """``w*m / sum(w*m)``, with the result dtype's smallest normal as the
    floor of the divisor: zero on dropped workers, summing to one while a
    participant has positive weight.

    >>> renormalize_weights(torch.full((4,), 0.25),
    ...                     torch.tensor([1.0, 0.0, 1.0, 0.0])).tolist()
    [0.5, 0.0, 0.5, 0.0]
    """
    wm = weights * mask.to(weights.dtype)
    return wm / torch.clamp(wm.sum(), min=torch.finfo(wm.dtype).tiny)


def worker_index(mesh) -> int:
    """This worker's flat index over the dp layout ``mesh`` (a
    ``repro_torch.launch.mesh.DpGroups``): its rank, outermost axis
    slowest, which is the JAX package's ``worker_index`` over the dp mesh
    axes and the entry of :meth:`Participation.round_mask` it reads. It is
    not the worker's place in a gathered stack, where on ``("pod",
    "data")`` the pod index varies fastest (``collectives._gather``).

    >>> from repro_torch.launch.mesh import DpGroups
    >>> worker_index(DpGroups(("pod", "data"), (2, 4), (None, None), 5))
    5
    """
    return int(mesh.rank)


def parse_participation(spec: Optional[str]) -> Participation:
    """Parse the trainer's ``--participation`` spec:
    ``bernoulli:drop_rate[,seed]``, ``round_robin:n_stragglers``,
    ``stale:n_stragglers[,staleness[,discount]]``,
    ``sampled:n_sampled[,seed]``; ``full`` or an empty spec is full
    participation.

    >>> parse_participation("stale:1,2,0.5")
    Participation(kind='stale', drop_rate=0.0, n_stragglers=1, staleness=2, \
discount=0.5, n_sampled=1, seed=0)
    >>> parse_participation("full").is_full
    True
    """
    if not spec:
        return Participation("full")
    kind, _, rest = spec.strip().partition(":")
    kind = kind.strip()
    args = [a.strip() for a in rest.split(",") if a.strip()] if rest else []
    try:
        if kind == "full":
            if args:
                raise ValueError("'full' takes no parameters")
            return Participation("full")
        if kind == "bernoulli":
            if not 1 <= len(args) <= 2:
                raise ValueError("expected bernoulli:drop_rate[,seed]")
            return Participation(
                "bernoulli", drop_rate=float(args[0]),
                seed=int(args[1]) if len(args) > 1 else 0,
            )
        if kind == "round_robin":
            if len(args) != 1:
                raise ValueError("expected round_robin:n_stragglers")
            return Participation("round_robin", n_stragglers=int(args[0]))
        if kind == "stale":
            if not 1 <= len(args) <= 3:
                raise ValueError(
                    "expected stale:n_stragglers[,staleness[,discount]]"
                )
            return Participation(
                "stale", n_stragglers=int(args[0]),
                staleness=int(args[1]) if len(args) > 1 else 1,
                discount=float(args[2]) if len(args) > 2 else 1.0,
            )
        if kind == "sampled":
            if not 1 <= len(args) <= 2:
                raise ValueError("expected sampled:n_sampled[,seed]")
            return Participation(
                "sampled", n_sampled=int(args[0]),
                seed=int(args[1]) if len(args) > 1 else 0,
            )
    except ValueError as e:
        raise ValueError(f"bad --participation spec {spec!r}: {e}") from None
    raise ValueError(
        f"bad --participation spec {spec!r}: unknown kind {kind!r}; "
        f"available: {list(PARTICIPATION_KINDS)}"
    )
