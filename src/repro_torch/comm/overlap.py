"""Bucketed overlap scheduling (counterpart of ``repro.comm.overlap``, line
for line: plain arithmetic, so every bucket and every stamp equals the JAX
package's).

The leaf tree is split into size-balanced *buckets*, each launched as
soon as its slice of the backward is done, so ``hierarchical``'s slow
inter-axis payload all-gather pipelines behind the next bucket's
intra-axis work. Three pieces, all host-side planning:

* :func:`bucketize` — greedy LPT bin-pack of per-leaf predicted wire
  seconds (:func:`repro_torch.comm.cost.stage_seconds`) into a
  :class:`BucketPlan`, with a balance factor and optional min/max bucket
  byte bounds;
* :func:`overlap_timeline` — the two-stage pipeline recurrence: per-bucket
  launch / intra-done / complete stamps and the overlapped round
  ``seconds``, never above the synchronous sum and equal to it at one
  bucket;
* :func:`parse_overlap` — the ``DistConfig.overlap`` / ``--overlap``
  grammar (``"off" | "buckets:B"``).

Bucketing only reorders the independent per-leaf rounds of a step (each
bucket runs inside a ``torch.profiler.record_function`` range), so any
bucket count gives the same numbers as ``"off"``, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

from repro_torch.comm import cost as cost_lib
from repro_torch.comm.cost import WORD_BYTES, AlphaBeta, LinkModel

# numeric slack for the balance-bound check: summation noise must not
# force a pointless bucket-count reduction
_BALANCE_TOL = 1e-9


@dataclasses.dataclass(frozen=True)
class OverlapConfig:
    """Bucketed-overlap planning knobs.

    ``n_buckets`` is the requested bucket count (clamped to the leaf
    count; :func:`bucketize` may merge below it for ``min_bucket_bytes``
    or reduce it for ``balance_factor``). Every plan satisfies ``max
    bucket seconds <= balance_factor * max(total/B, max leaf seconds)``;
    4/3 is LPT's guarantee, so the default never forces a reduction.
    ``min_bucket_bytes`` merges too-small buckets; ``max_bucket_bytes``
    steers leaves away from over-full buckets (best effort)."""

    n_buckets: int = 1
    balance_factor: float = 4.0 / 3.0
    min_bucket_bytes: int = 0
    max_bucket_bytes: Optional[int] = None

    def __post_init__(self):
        if self.n_buckets < 1:
            raise ValueError(f"n_buckets must be >= 1, got {self.n_buckets}")
        if self.balance_factor < 1.0:
            raise ValueError(
                f"balance_factor must be >= 1.0, got {self.balance_factor}"
            )
        if self.min_bucket_bytes < 0:
            raise ValueError(
                f"min_bucket_bytes must be >= 0, got {self.min_bucket_bytes}"
            )
        if (
            self.max_bucket_bytes is not None
            and self.max_bucket_bytes < max(self.min_bucket_bytes, 1)
        ):
            raise ValueError(
                f"max_bucket_bytes={self.max_bucket_bytes} below "
                f"min_bucket_bytes={self.min_bucket_bytes} (or < 1)"
            )


def parse_overlap(spec: str) -> Optional[OverlapConfig]:
    """Parse a ``DistConfig.overlap`` / ``--overlap`` spec: ``"off"``
    (None, the synchronous round) or ``"buckets:B"`` with ``B >= 1``.

    >>> parse_overlap("off") is None
    True
    >>> parse_overlap("buckets:4").n_buckets
    4
    >>> parse_overlap("stream")
    Traceback (most recent call last):
        ...
    ValueError: unknown overlap spec 'stream'; expected 'off' or 'buckets:B'
    """
    s = spec.strip()
    if s == "off":
        return None
    if s.startswith("buckets:"):
        body = s[len("buckets:"):]
        try:
            n = int(body)
        except ValueError:
            raise ValueError(
                f"overlap spec {spec!r}: bucket count {body!r} is not an int"
            ) from None
        return OverlapConfig(n_buckets=n)
    raise ValueError(
        f"unknown overlap spec {spec!r}; expected 'off' or 'buckets:B'"
    )


class LeafCost(NamedTuple):
    """One leaf's predicted wire cost per dp axis (``dp_sizes`` order,
    outermost first); ``wire`` labels the (codec, collective) pair it was
    priced under."""

    bytes_on_wire: int
    axis_seconds: Tuple[float, ...]
    wire: Tuple[str, str] = ("", "")

    @property
    def seconds(self) -> float:
        return float(sum(self.axis_seconds))


class Bucket(NamedTuple):
    """One scheduled bucket: its leaf indices (ascending, into the flat
    plan order), per-axis seconds (sums over its leaves), total seconds
    and bytes, and its leaves' (codec, collective) pairs."""

    leaves: Tuple[int, ...]
    seconds: float
    bytes_on_wire: int
    axis_seconds: Tuple[float, ...]
    wire: Tuple[Tuple[str, str], ...] = ()

    @property
    def intra_seconds(self) -> float:
        """Innermost-axis stage time (the dense psum, or a flat stage)."""
        return self.axis_seconds[-1] if self.axis_seconds else 0.0

    @property
    def inter_seconds(self) -> float:
        """Outer-axes stage time (the payload all-gather)."""
        return float(sum(self.axis_seconds[:-1]))


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """An ordered bucket schedule that partitions ``range(n_leaves)``:
    every leaf in exactly one bucket, buckets in launch order."""

    buckets: Tuple[Bucket, ...]
    config: OverlapConfig

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def n_leaves(self) -> int:
        return sum(len(b.leaves) for b in self.buckets)

    def leaf_order(self) -> Tuple[int, ...]:
        """Leaf indices in launch order (bucket by bucket)."""
        return tuple(i for b in self.buckets for i in b.leaves)


class Timeline(NamedTuple):
    """Predicted per-bucket stamps of one overlapped round (seconds from
    round start): ``launch``, ``intra_done`` and ``complete``;
    ``seconds`` is ``complete[-1]`` and ``sync_seconds`` the same stages
    back to back (``seconds <= sync_seconds``, equal at one bucket)."""

    launch: Tuple[float, ...]
    intra_done: Tuple[float, ...]
    complete: Tuple[float, ...]
    seconds: float
    sync_seconds: float


def leaf_cost(
    codec,
    collective: str,
    length: int,
    k: int,
    dp_sizes: Sequence[int],
    model: LinkModel = AlphaBeta(),
    word_bytes: int = WORD_BYTES,
    participants: Optional[float] = None,
) -> LeafCost:
    """Price one leaf for :func:`bucketize`: predicted bytes plus per-axis
    stage seconds under ``model``.

    >>> from repro_torch.comm.cost import LinkTopo
    >>> topo = LinkTopo((AlphaBeta(1e-5, 1e-9), AlphaBeta(1e-6, 1e-10)))
    >>> lc = leaf_cost("coo_fp32", "hierarchical", 10**6, 10**5, (2, 4), topo)
    >>> len(lc.axis_seconds), lc.wire
    (2, ('coo_fp32', 'hierarchical'))
    """
    est = cost_lib.predict(
        codec, collective, length, k, dp_sizes, model, word_bytes,
        participants,
    )
    ax = cost_lib.stage_seconds(
        codec, collective, length, k, dp_sizes, model, word_bytes,
        participants,
    )
    cname = codec if isinstance(codec, str) else codec.name
    return LeafCost(est.bytes_on_wire, ax, (cname, collective))


def _lpt_assign(costs, order, n_buckets, max_bytes):
    """Longest-processing-time greedy: each leaf (descending seconds) into
    the least-loaded bucket, preferring buckets whose byte total stays
    under ``max_bytes`` (an empty bucket always accepts)."""
    loads = [0.0] * n_buckets
    nbytes = [0] * n_buckets
    bins: list = [[] for _ in range(n_buckets)]
    for i in order:
        cand = sorted(range(n_buckets), key=lambda j: (loads[j], j))
        pick = cand[0]
        if max_bytes is not None:
            for j in cand:
                if not bins[j] or nbytes[j] + costs[i].bytes_on_wire <= max_bytes:
                    pick = j
                    break
        bins[pick].append(i)
        loads[pick] += costs[i].seconds
        nbytes[pick] += costs[i].bytes_on_wire
    return [b for b in bins if b]


def _merge_small(bins, costs, min_bytes):
    """Fold buckets under ``min_bytes`` into the least-loaded survivor."""
    if min_bytes <= 0:
        return bins
    bins = [list(b) for b in bins]
    while len(bins) > 1:
        sizes = [sum(costs[i].bytes_on_wire for i in b) for b in bins]
        small = min(range(len(bins)), key=lambda j: (sizes[j], j))
        if sizes[small] >= min_bytes:
            break
        loads = [sum(costs[i].seconds for i in b) for b in bins]
        other = min(
            (j for j in range(len(bins)) if j != small),
            key=lambda j: (loads[j], j),
        )
        bins[other].extend(bins[small])
        del bins[small]
    return bins


def bucketize(
    costs: Sequence[LeafCost], config: OverlapConfig = OverlapConfig()
) -> BucketPlan:
    """Greedy size-balanced bin-pack of the leaf tree into a bucket
    schedule: deterministic LPT (leaves by descending seconds, ties by
    index, into the least-loaded bucket, honouring ``max_bucket_bytes``
    when possible), buckets under ``min_bucket_bytes`` merged away, and
    the bucket count reduced until ``balance_factor`` holds. Buckets come
    ordered by their smallest leaf index.

    >>> costs = [LeafCost(400, (3e-3,)), LeafCost(400, (3e-3,)),
    ...          LeafCost(200, (1e-3,)), LeafCost(200, (1e-3,))]
    >>> [b.leaves for b in bucketize(costs, OverlapConfig(n_buckets=2)).buckets]
    [(0, 2), (1, 3)]
    """
    costs = list(costs)
    if not costs:
        raise ValueError("bucketize needs at least one leaf cost")
    n_axes = len(costs[0].axis_seconds)
    if any(len(c.axis_seconds) != n_axes for c in costs):
        raise ValueError(
            "every LeafCost must decompose over the same dp axes"
        )
    order = sorted(range(len(costs)), key=lambda i: (-costs[i].seconds, i))
    total = sum(c.seconds for c in costs)
    max_leaf = max(c.seconds for c in costs)
    assign = [order]
    for nb in range(min(config.n_buckets, len(costs)), 0, -1):
        assign = _merge_small(
            _lpt_assign(costs, order, nb, config.max_bucket_bytes),
            costs,
            config.min_bucket_bytes,
        )
        loads = [sum(costs[i].seconds for i in b) for b in assign]
        ideal = max(total / len(assign), max_leaf)
        if (
            len(assign) == 1
            or max(loads) <= config.balance_factor * ideal + _BALANCE_TOL
        ):
            break
    buckets = []
    for b in sorted(assign, key=min):
        idxs = tuple(sorted(b))
        ax = tuple(
            sum(costs[i].axis_seconds[a] for i in idxs)
            for a in range(n_axes)
        )
        buckets.append(
            Bucket(
                leaves=idxs,
                seconds=float(sum(ax)),
                bytes_on_wire=sum(costs[i].bytes_on_wire for i in idxs),
                axis_seconds=ax,
                wire=tuple(costs[i].wire for i in idxs),
            )
        )
    return BucketPlan(buckets=tuple(buckets), config=config)


def overlap_timeline(
    plan: BucketPlan,
    compute_seconds: Optional[Sequence[float]] = None,
) -> Timeline:
    """Predicted timeline of one overlapped round: two serial resources,
    the intra stage (innermost dp axis) and the inter stage (outer axes),
    pipelined across buckets. Bucket ``i`` launches once its backward
    slice (``compute_seconds[i]``, cumulative) is done and the intra
    stage is free:

        ``launch[i]     = max(compute_done[i], intra_done[i-1])``
        ``intra_done[i] = launch[i] + intra[i]``
        ``complete[i]   = max(intra_done[i], complete[i-1]) + inter[i]``

    >>> two = bucketize([LeafCost(100, (2e-3, 1e-3)),
    ...                  LeafCost(100, (2e-3, 1e-3))],
    ...                 OverlapConfig(n_buckets=2))
    >>> tl = overlap_timeline(two)
    >>> tl.seconds < tl.sync_seconds
    True
    """
    comp = (
        [0.0] * plan.n_buckets
        if compute_seconds is None
        else [float(c) for c in compute_seconds]
    )
    if len(comp) != plan.n_buckets:
        raise ValueError(
            f"compute_seconds has {len(comp)} entries for "
            f"{plan.n_buckets} buckets"
        )
    if any(c < 0 for c in comp):
        raise ValueError("compute_seconds must be non-negative")
    launch, intra_done, complete = [], [], []
    comp_done = 0.0
    intra_free = 0.0
    inter_free = 0.0
    for b, c in zip(plan.buckets, comp, strict=True):
        comp_done += c
        t_launch = max(comp_done, intra_free)
        t_intra = t_launch + b.intra_seconds
        intra_free = t_intra
        t_complete = max(t_intra, inter_free) + b.inter_seconds
        inter_free = t_complete
        launch.append(t_launch)
        intra_done.append(t_intra)
        complete.append(t_complete)
    sync = sum(comp) + sum(b.seconds for b in plan.buckets)
    return Timeline(
        launch=tuple(launch),
        intra_done=tuple(intra_done),
        complete=tuple(complete),
        seconds=complete[-1],
        sync_seconds=sync,
    )
