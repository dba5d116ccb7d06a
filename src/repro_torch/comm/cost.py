"""Communication cost accounting: per-link-class alpha–beta model + measured
bytes (counterpart of ``repro.comm.cost``, line for line: plain
arithmetic, so every count and every predicted second equals the JAX
package's).

Two views of every round, per (codec, collective, mesh):

* ``predicted_bytes`` / ``predict`` — the analytic alpha–beta model
  (latency ``alpha`` per message + ``beta`` seconds/byte), computed from the
  codec's exact ``wire_bits`` accounting and the collective's communication
  pattern.
* ``measured_bytes`` — the same pattern costed with the *actual* encoded
  buffer sizes (``payload_nbytes`` over the payload pytree). Because all
  payload shapes are static, this is exact, and benchmarks assert
  ``measured <= predicted * 1.05``.

Patterns (per-worker, per-round, ring realizations):

* ``dense_allreduce``  — ring allreduce of the dense [L] vector:
  ``2·(N-1)/N·L·word`` bytes, ``2·(N-1)`` messages.
* ``sparse_allgather`` — ring allgather of the payload: ``(N-1)·payload``
  bytes received, ``N-1`` messages.
* ``hierarchical``     — allgather over the inter axes (``(B-1)·payload``)
  + dense ring allreduce over the intra axis (``2·(A-1)/A·L·word``).

Link models — scalar and per-link-class:

* :class:`AlphaBeta` — one (alpha, beta) for every link in the mesh.
* :class:`LinkTopo`  — one :class:`AlphaBeta` *per dp mesh axis*, ordered
  outermost (slowest) first, matching the repo's mesh convention
  (``dp_axes=("pod", "data")``: inter-pod NICs then intra-pod ICI).

Per-axis attribution (:func:`pattern_axes`): every collective decomposes
into per-axis (bytes, messages) contributions summing exactly to the flat
pattern, and ``seconds = sum_axis msgs_a * alpha_a + bytes_a * beta_a``. A
ring that spans *several* axes at once (``dense_allreduce`` and
``sparse_allgather`` over a multi-axis dp group) is synchronous: every step
is gated by the slowest link it crosses, which under the outermost-first
ordering is the outermost axis *with more than one worker* — so flat
stages charge that axis (size-1 axes carry no traffic and price nothing),
while ``hierarchical``'s intra stage runs (and is priced) on the
innermost axis alone. With a uniform :class:`LinkTopo` this reproduces the
scalar :class:`AlphaBeta` predictions bit-for-bit; with a slow outer axis
it is what makes ``hierarchical`` strictly preferable at all (see
``docs/comm.md`` for the uniform-model impossibility proof).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple, Union

from repro_torch.comm.codec import Codec, Payload, get_codec

WORD_BYTES = 4  # fp32 words, the dense baseline unit


@dataclasses.dataclass(frozen=True)
class AlphaBeta:
    """Classic LogP-style link model: ``alpha`` s/message, ``beta`` s/byte.

    Defaults approximate a datacenter NIC: 10 us latency, 100 GB/s links.

    >>> AlphaBeta().alpha
    1e-05
    >>> AlphaBeta(alpha=2e-6, beta=5e-12)
    AlphaBeta(alpha=2e-06, beta=5e-12)
    """

    alpha: float = 1e-5
    beta: float = 1e-11


@dataclasses.dataclass(frozen=True)
class LinkTopo:
    """Per-mesh-axis link topology: ``links[i]`` prices traffic attributed
    to dp mesh axis ``i``, outermost (slowest) first — the same ordering as
    ``dp_sizes`` / ``DistConfig.dp_axes``.

    A 2-pod mesh with slow inter-pod NICs and fast intra-pod ICI:

    >>> topo = LinkTopo((AlphaBeta(1e-5, 1e-10), AlphaBeta(1e-6, 1e-11)))
    >>> topo.n_axes
    2
    >>> topo.uniform(AlphaBeta(), 2) == LinkTopo((AlphaBeta(), AlphaBeta()))
    True
    """

    links: Tuple[AlphaBeta, ...]

    def __post_init__(self):
        links = tuple(self.links)
        if not links:
            raise ValueError("LinkTopo needs at least one per-axis link")
        if not all(isinstance(l, AlphaBeta) for l in links):
            raise TypeError("LinkTopo.links must be AlphaBeta instances")
        object.__setattr__(self, "links", links)

    @classmethod
    def uniform(cls, model: AlphaBeta, n_axes: int) -> "LinkTopo":
        """One identical link class for every axis — reproduces the scalar
        :class:`AlphaBeta` predictions bit-for-bit (see :func:`predict`)."""
        return cls((model,) * int(n_axes))

    @property
    def n_axes(self) -> int:
        return len(self.links)

    @property
    def is_uniform(self) -> bool:
        return all(l == self.links[0] for l in self.links)


LinkModel = Union[AlphaBeta, LinkTopo]


def as_topo(model: LinkModel, n_axes: int) -> LinkTopo:
    """Normalize a link model to a :class:`LinkTopo` over ``n_axes`` axes.

    A scalar :class:`AlphaBeta` broadcasts uniformly; a :class:`LinkTopo`
    must already match the dp mesh rank exactly.

    >>> as_topo(AlphaBeta(), 2).n_axes
    2
    >>> as_topo(LinkTopo.uniform(AlphaBeta(), 3), 2)
    Traceback (most recent call last):
        ...
    ValueError: LinkTopo has 3 per-axis links but the dp mesh has 2 axes
    """
    if isinstance(model, LinkTopo):
        if model.n_axes != n_axes:
            raise ValueError(
                f"LinkTopo has {model.n_axes} per-axis links but the dp "
                f"mesh has {n_axes} axes"
            )
        return model
    if isinstance(model, AlphaBeta):
        return LinkTopo.uniform(model, n_axes)
    raise TypeError(f"expected AlphaBeta or LinkTopo, got {type(model)!r}")


@dataclasses.dataclass(frozen=True)
class CostEstimate:
    bytes_on_wire: int  # per worker per round
    n_messages: int
    seconds: float


def payload_nbytes(payload: Payload) -> int:
    """Actual buffer bytes of an encoded payload (static shapes): the
    ``nbytes`` of its tensors. Pass one worker's payload, as the JAX
    package does; a ``[W, ...]`` stack counts W payloads.

    >>> import torch
    >>> payload_nbytes({"vals": torch.zeros((1, 16)),
    ...                 "idx": torch.zeros((1, 16), dtype=torch.int32)})
    128
    """
    return int(sum(x.nbytes for x in payload.values()))


def _ring_fraction(
    dp_sizes: Sequence[int], participants: Optional[float]
) -> float:
    """Participating fraction ``f`` of the *hop count* of each ring stage:
    a group of size ``g`` shrinks to ``1 + (g - 1) * f`` effective members
    (exact at full participation, never below one, strictly smaller on any
    stage with >1 worker when ``f < 1``)."""
    if participants is None:
        return 1.0
    n = math.prod(int(s) for s in dp_sizes) or 1
    if not 1.0 <= float(participants) <= n:
        raise ValueError(
            f"participants={participants} outside [1, {n}] for dp mesh "
            f"{tuple(dp_sizes)}"
        )
    return (float(participants) - 1.0) / max(n - 1, 1) if n > 1 else 1.0


def pattern_axes(
    collective: str,
    length: int,
    payload_bytes: float,
    dp_sizes: Sequence[int],
    word_bytes: int = WORD_BYTES,
    participants: Optional[float] = None,
) -> Tuple[Tuple[float, int], ...]:
    """Per-axis ``(bytes, messages)`` contributions for one worker, one
    round — aligned with ``dp_sizes`` (outermost first) and summing exactly
    to the flat pattern.

    Flat rings spanning several axes (``dense_allreduce``,
    ``sparse_allgather``, and ``hierarchical``'s inter-axis allgather when
    there are multiple outer axes) are synchronous: each step is gated by
    the slowest link crossed, i.e. the outermost axis *with more than one
    worker* in the span under the slowest-first mesh ordering (size-1 axes
    carry no traffic and must not price anything) — the whole stage is
    attributed to that axis. ``hierarchical``'s intra-axis dense allreduce
    runs on the innermost axis alone.

    ``participants`` prices a *partial* round (straggler-dropping
    schedules, see :mod:`repro.comm.participation`): it is the expected
    number of on-time workers over the whole flat group, and a ring
    stage's group size ``g`` shrinks proportionally to
    ``1 + (g - 1) * (participants - 1)/(N - 1)`` — fewer hops, so fewer
    messages and bytes on the charged axes, strictly so whenever
    ``participants < N`` on a stage with more than one worker. The one
    exception is ``hierarchical``'s intra-axis allreduce when the mesh
    has ``B > 1`` inter-axis groups: it runs as ``B`` parallel rings and
    the synchronous round is gated by the fullest of them, so that stage
    stays full-size (with ``B == 1`` it is the same single ring
    ``dense_allreduce`` prices, and shrinks identically). ``None`` (or
    ``participants == N``) reproduces the full-round pattern exactly.
    S-of-N client sampling (``Participation(kind="sampled")``) prices the
    same way with ``participants = S``: only the sampled subset puts
    payloads on the wire, so an S-of-2000 round costs like an S-worker
    ring, not a 2000-worker one.

    >>> pattern_axes("hierarchical", 1024, 128.0, (2, 4))
    ((128.0, 1), (6144.0, 6))
    >>> pattern_axes("sparse_allgather", 1024, 128.0, (2, 4))
    ((896.0, 7), (0.0, 0))
    >>> pattern_axes("sparse_allgather", 1024, 128.0, (1, 4))
    ((0.0, 0), (384.0, 3))
    >>> pattern_axes("sparse_allgather", 1024, 128.0, (8,), participants=4.5)
    ((448.0, 4),)
    """
    sizes = [int(s) for s in dp_sizes] or [1]
    m = len(sizes)
    n = math.prod(sizes)
    f = _ring_fraction(sizes, participants)
    zero = [(0.0, 0)] * m

    def gate(span_sizes):
        # outermost axis that actually has workers: the slowest link the
        # flat ring crosses (a size-1 axis contributes no hops)
        for i, s in enumerate(span_sizes):
            if s > 1:
                return i
        return 0

    def allreduce_stage(g: int, frac: float = f):
        # effective ring-group size under partial participation
        p = 1.0 + (g - 1) * frac
        return (
            2.0 * (p - 1) / max(p, 1.0) * length * word_bytes,
            math.ceil(2 * (p - 1) - 1e-9) if p > 1 else 0,
        )

    def gather_stage(g: int):
        p = 1.0 + (g - 1) * f
        return (
            (p - 1) * payload_bytes,
            math.ceil(p - 1 - 1e-9) if p > 1 else 0,
        )

    if collective == "dense_allreduce":
        zero[gate(sizes)] = allreduce_stage(n)
        return tuple(zero)
    if collective == "sparse_allgather":
        zero[gate(sizes)] = gather_stage(n)
        return tuple(zero)
    if collective == "hierarchical":
        # last dp axis = intra (fast, dense allreduce); outer axes = inter
        # (slow, compressed payload allgather) — matches Hierarchical.shard.
        # Participation shrinks the inter gather; the intra stage is B
        # parallel rings and the synchronous round is gated by the
        # fullest of them, so with B > 1 it is priced full-size (a
        # straggler thins one ring, not the critical-path one). With
        # B == 1 there is a single ring — the same ring dense_allreduce
        # prices — and it shrinks identically.
        a = sizes[-1]
        b = math.prod(sizes[:-1]) if m > 1 else 1
        inter = gather_stage(b)
        intra = allreduce_stage(a, frac=1.0 if b > 1 else f)
        if m == 1:
            return ((inter[0] + intra[0], inter[1] + intra[1]),)
        zero[gate(sizes[:-1])], zero[-1] = inter, intra
        return tuple(zero)
    raise ValueError(f"unknown collective {collective!r}")


def _pattern(
    collective: str,
    length: int,
    payload_bytes: float,
    dp_sizes: Sequence[int],
    word_bytes: int = WORD_BYTES,
    participants: Optional[float] = None,
):
    """(bytes, messages) for one worker, one round — the per-axis sums."""
    per_axis = pattern_axes(
        collective, length, payload_bytes, dp_sizes, word_bytes, participants
    )
    by = 0.0
    msgs = 0
    for b, g in per_axis:
        by += b
        msgs += g
    return by, msgs


def predicted_bytes(
    codec: Codec | str,
    collective: str,
    length: int,
    k: int,
    dp_sizes: Sequence[int],
    word_bytes: int = WORD_BYTES,
    participants: Optional[float] = None,
) -> int:
    """Per-worker bytes/round from the codec's exact bit accounting.
    ``word_bytes`` sizes the dense terms (4 for fp32, 2 for bf16 state);
    ``participants`` prices a partial-participation round (see
    :func:`pattern_axes`).

    >>> predicted_bytes("coo_fp32", "sparse_allgather", 1024, 16, (8,))
    896
    >>> predicted_bytes("coo_fp32", "sparse_allgather", 1024, 16, (8,),
    ...                 participants=4.5)
    448
    """
    c = get_codec(codec) if isinstance(codec, str) else codec
    pb = math.ceil(int(c.wire_bits(length, k)) / 8)
    by, _ = _pattern(
        collective, length, pb, dp_sizes, word_bytes, participants
    )
    return math.ceil(by)


def measured_bytes(
    collective: str,
    length: int,
    payload: Payload,
    dp_sizes: Sequence[int],
    word_bytes: int = WORD_BYTES,
) -> int:
    """Per-worker bytes/round from the *actual* encoded buffers.

    Always a full-round figure: the SPMD collectives move every worker's
    (possibly zero-masked) full-size buffer whatever the participation
    schedule, so partial-round pricing lives on the *predicted* side only
    (:func:`predicted_bytes` / :func:`predict` ``participants=``).

    >>> import torch
    >>> payload = {"vals": torch.zeros((1, 16)),
    ...            "idx": torch.zeros((1, 16), dtype=torch.int32)}
    >>> measured_bytes("sparse_allgather", 1024, payload, (8,))
    896
    """
    by, _ = _pattern(
        collective, length, payload_nbytes(payload), dp_sizes, word_bytes
    )
    return math.ceil(by)


def predict(
    codec: Codec | str,
    collective: str,
    length: int,
    k: int,
    dp_sizes: Sequence[int],
    model: LinkModel = AlphaBeta(),
    word_bytes: int = WORD_BYTES,
    participants: Optional[float] = None,
) -> CostEstimate:
    """Alpha–beta cost of one round: bytes, messages and predicted seconds.

    ``model`` is either a scalar :class:`AlphaBeta` (every link identical)
    or a :class:`LinkTopo` with one link class per dp mesh axis; the
    per-axis contributions come from :func:`pattern_axes` and

        ``seconds = sum_axis msgs_a * alpha_a + bytes_a * beta_a``.

    ``participants`` prices a partial-participation round — fewer ring
    hops, so strictly fewer bytes and messages on any charged axis with
    more than one worker (see :func:`pattern_axes`).

    A uniform topology is bit-for-bit identical to the scalar model:

    >>> uni = predict("coo_fp32", "sparse_allgather", 1024, 16, (2, 4))
    >>> topo = LinkTopo.uniform(AlphaBeta(), 2)
    >>> predict("coo_fp32", "sparse_allgather", 1024, 16, (2, 4), topo) == uni
    True

    A slow outer axis penalizes the flat collectives but only the (tiny)
    payload stage of ``hierarchical``:

    >>> slow_outer = LinkTopo((AlphaBeta(1e-5, 1e-9), AlphaBeta(1e-6, 1e-11)))
    >>> h = predict("coo_fp32", "hierarchical", 10**6, 10**5, (2, 4), slow_outer)
    >>> g = predict("coo_fp32", "sparse_allgather", 10**6, 10**5, (2, 4), slow_outer)
    >>> h.seconds < g.seconds
    True
    """
    c = get_codec(codec) if isinstance(codec, str) else codec
    pb = math.ceil(int(c.wire_bits(length, k)) / 8)
    per_axis = pattern_axes(
        collective, length, pb, dp_sizes, word_bytes, participants
    )
    by = 0.0
    msgs = 0
    for b, g in per_axis:
        by += b
        msgs += g
    topo = as_topo(model, len(per_axis))
    if topo.is_uniform:
        # scalar path, kept verbatim so a uniform LinkTopo reproduces the
        # historical AlphaBeta numbers bit-for-bit (same fp operation order)
        link = topo.links[0]
        seconds = msgs * link.alpha + by * link.beta
    else:
        seconds = sum(
            g * l.alpha + b * l.beta
            for (b, g), l in zip(per_axis, topo.links, strict=True)
        )
    return CostEstimate(
        bytes_on_wire=math.ceil(by),
        n_messages=msgs,
        seconds=seconds,
    )


def stage_seconds(
    codec: Codec | str,
    collective: str,
    length: int,
    k: int,
    dp_sizes: Sequence[int],
    model: LinkModel = AlphaBeta(),
    word_bytes: int = WORD_BYTES,
    participants: Optional[float] = None,
) -> Tuple[float, ...]:
    """Per-axis stage seconds of one leaf's round, aligned with
    ``dp_sizes`` (outermost first) — the decomposition the bucketed
    overlap scheduler (:mod:`repro.comm.overlap`) pipelines: the last
    entry is the innermost (intra) stage, everything before it the outer
    (inter) stages.

    Each axis is priced independently from its :func:`pattern_axes`
    contribution (``msgs_a * alpha_a + bytes_a * beta_a``), so the tuple
    sums to :func:`predict`'s ``seconds`` — exactly on a heterogeneous
    topology, and to fp summation order on a uniform one (where
    :func:`predict` keeps the historical scalar operation order).

    >>> slow_outer = LinkTopo((AlphaBeta(1e-5, 1e-9), AlphaBeta(1e-6, 1e-10)))
    >>> ax = stage_seconds("coo_fp32", "hierarchical", 10**6, 10**5,
    ...                    (2, 4), slow_outer)
    >>> len(ax)
    2
    >>> est = predict("coo_fp32", "hierarchical", 10**6, 10**5, (2, 4),
    ...               slow_outer)
    >>> sum(ax) == est.seconds
    True
    """
    c = get_codec(codec) if isinstance(codec, str) else codec
    pb = math.ceil(int(c.wire_bits(length, k)) / 8)
    per_axis = pattern_axes(
        collective, length, pb, dp_sizes, word_bytes, participants
    )
    topo = as_topo(model, len(per_axis))
    return tuple(
        g * lk.alpha + b * lk.beta
        for (b, g), lk in zip(per_axis, topo.links, strict=True)
    )


def parse_link_topo(spec: str, dp_axes: Sequence[str]) -> LinkTopo:
    """Parse a CLI link-topology spec into a :class:`LinkTopo` over
    ``dp_axes`` (outermost first).

    Grammar: ``;``-separated ``name:alpha,beta`` entries, where ``name`` is
    a dp mesh axis name or one of the aliases ``intra`` (the innermost dp
    axis) and ``inter`` (every outer axis). A bare ``alpha,beta`` with no
    name is uniform across all axes. Every axis must be covered exactly
    once.

    >>> parse_link_topo("inter:1e-5,1e-10;intra:1e-6,1e-11",
    ...                 ("pod", "data")).links
    (AlphaBeta(alpha=1e-05, beta=1e-10), AlphaBeta(alpha=1e-06, beta=1e-11))
    >>> parse_link_topo("2e-5,3e-11", ("data",))
    LinkTopo(links=(AlphaBeta(alpha=2e-05, beta=3e-11),))
    """
    axes = tuple(dp_axes)
    if not axes:
        raise ValueError("parse_link_topo needs at least one dp axis")
    spec = spec.strip()
    if not spec:
        raise ValueError("empty --link-topo spec")
    if ":" not in spec:
        model = _parse_alpha_beta(spec)
        return LinkTopo.uniform(model, len(axes))
    assigned: dict = {}
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        name, _, ab = entry.partition(":")
        name = name.strip()
        model = _parse_alpha_beta(ab)
        if name == "intra":
            targets = (axes[-1],)
        elif name == "inter":
            targets = axes[:-1]
            if not targets:
                raise ValueError(
                    "link class 'inter' given but the dp mesh "
                    f"{list(axes)} has no outer axes"
                )
        elif name in axes:
            targets = (name,)
        else:
            raise ValueError(
                f"unknown link class {name!r}; expected a dp axis name in "
                f"{list(axes)} or 'intra'/'inter'"
            )
        for t in targets:
            if t in assigned:
                raise ValueError(f"dp axis {t!r} assigned twice in {spec!r}")
            assigned[t] = model
    missing = [a for a in axes if a not in assigned]
    if missing:
        raise ValueError(f"dp axes {missing} not covered by {spec!r}")
    return LinkTopo(tuple(assigned[a] for a in axes))


def _parse_alpha_beta(ab: str) -> AlphaBeta:
    parts = [p.strip() for p in ab.split(",")]
    if len(parts) != 2:
        raise ValueError(
            f"expected 'alpha,beta' (seconds/message, seconds/byte), "
            f"got {ab!r}"
        )
    return AlphaBeta(alpha=float(parts[0]), beta=float(parts[1]))
