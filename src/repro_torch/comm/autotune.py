"""Per-leaf (codec x collective) planning by the alpha–beta cost model
(counterpart of ``repro.comm.autotune``: host arithmetic over the port's
``cost``, so every pick and every total equals the JAX package's).

Each leaf gets the admissible (codec, collective) pair that minimizes the
predicted round time ``n_messages * alpha + bytes_on_wire * beta``
(:func:`repro_torch.comm.cost.predict`); ties break on fewer bytes, then
on the (codec, collective) names. ``DistConfig.codec="auto"`` /
``collective="auto"`` route through here (``core.distributed.build_plan``
and the simulator); fixing one of the two restricts the candidates to it.
The lossy ``coo_q8`` is admissible only when the caller fixed it
(``allow_lossy``).

* :func:`choose_leaf` — one ``(length, k, dp_sizes)`` -> :class:`LeafDecision`;
* :func:`plan_tree` — a ``LeafPlan`` tree -> :class:`CommPlan`, optionally
  with the bucketed overlap schedule (:mod:`repro_torch.comm.overlap`);
* :func:`replan` — :func:`plan_tree` under a model fitted from measured
  samples (:mod:`repro_torch.comm.calibrate`), mid-training.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

from repro_torch.comm import cost as cost_lib
from repro_torch.comm import fastpath as fastpath_lib
from repro_torch.comm import overlap as overlap_lib
from repro_torch.comm.calibrate import fit_alpha_beta
from repro_torch.comm.codec import CODECS, get_codec
from repro_torch.comm.collectives import COLLECTIVES, get_collective
from repro_torch.comm.cost import (
    WORD_BYTES,
    AlphaBeta,
    CostEstimate,
    LinkModel,
    LinkTopo,
    as_topo,
)
from repro_torch.tree import tree_leaves, tree_map

# dense_allreduce moves the dense vector, so no codec reaches the wire: one
# canonical codec slot stands for it among the candidates
DENSE_CANONICAL_CODEC = "coo_fp32"


@dataclasses.dataclass(frozen=True)
class LeafDecision:
    """The planner's pick for one leaf and its predicted cost; ``fused``
    is the select→encode fastpath flag (always False under
    ``fastpath="off"``)."""

    codec: str
    collective: str
    cost: CostEstimate
    fused: bool = False


@dataclasses.dataclass(frozen=True)
class CommPlan:
    """Per-leaf decisions (a tree mirroring the ``LeafPlan`` tree) and
    per-worker round totals under ``model``, the :class:`LinkTopo` the
    planner scored with. ``buckets`` / ``timeline`` hold the overlap
    schedule when planned with ``overlap=``; ``total_seconds`` stays the
    synchronous per-leaf sum."""

    decisions: Any
    total_bytes: int
    total_messages: int
    total_seconds: float
    model: LinkTopo
    buckets: Optional[overlap_lib.BucketPlan] = None
    timeline: Optional[overlap_lib.Timeline] = None

    def flat(self):
        return tree_leaves(self.decisions)


def candidate_pairs(
    codecs: Optional[Sequence[str]] = None,
    collectives: Optional[Sequence[str]] = None,
    allow_lossy: bool = False,
) -> Tuple[Tuple[str, str], ...]:
    """Admissible (codec, collective) pairs for one leaf.
    ``dense_allreduce`` appears once, under the canonical codec slot (or
    the caller's single fixed codec); lossy codecs only with
    ``allow_lossy``; ``hierarchical`` stays admissible on one dp axis,
    where it ties with ``dense_allreduce``'s pattern.

    >>> candidate_pairs(codecs=["bitmap_dense"],
    ...                 collectives=["sparse_allgather"])
    (('bitmap_dense', 'sparse_allgather'),)
    >>> any(c == "coo_q8" for c, _ in candidate_pairs())
    False
    """
    codec_axis_free = codecs is None
    cnames = sorted(CODECS) if codecs is None else list(codecs)
    snames = sorted(COLLECTIVES) if collectives is None else list(collectives)
    pairs = []
    for s in snames:
        get_collective(s)  # fail fast on an unknown collective
        if s == "dense_allreduce":
            dc = DENSE_CANONICAL_CODEC if codec_axis_free else cnames[0]
            get_codec(dc)
            pairs.append((dc, s))
            continue
        for c in cnames:
            if not get_codec(c).lossless and not allow_lossy:
                continue
            pairs.append((c, s))
    if not pairs:
        raise ValueError(
            "no admissible (codec, collective) pairs: codecs="
            f"{cnames} collectives={snames} allow_lossy={allow_lossy}"
        )
    return tuple(pairs)


def auto_candidates(kind: str, codec: str, collective: str) -> dict:
    """``choose_leaf``'s candidate restrictions under ``codec`` and/or
    ``collective`` = ``"auto"``, as the JAX ``build_plan`` and simulator
    set them: a fixed codec or collective is the only one offered; kinds
    with no fixed-k payload ("none", "hard_threshold") take the dense wire
    when the collective is free; a free codec stays lossless (an
    explicitly fixed lossy codec is the user's call).

    >>> auto_candidates("regtopk", "auto", "hierarchical")["collectives"]
    ['hierarchical']
    >>> auto_candidates("none", "auto", "auto")["collectives"]
    ['dense_allreduce']
    """
    if collective != "auto":
        collectives = [collective]
    elif kind in ("none", "hard_threshold"):
        collectives = ["dense_allreduce"]
    else:
        collectives = None
    return dict(codecs=None if codec == "auto" else [codec],
                collectives=collectives, allow_lossy=codec != "auto")


def choose_leaf(
    length: int,
    k: int,
    dp_sizes: Sequence[int],
    model: LinkModel = AlphaBeta(),
    *,
    codecs: Optional[Sequence[str]] = None,
    collectives: Optional[Sequence[str]] = None,
    allow_lossy: bool = False,
    word_bytes: int = WORD_BYTES,
    participants: Optional[float] = None,
    fastpath: str = "off",
    compute: Optional[fastpath_lib.ThroughputTable] = None,
) -> LeafDecision:
    """Score every admissible pair with ``cost.predict`` and return the
    least by (seconds, bytes, codec, collective).

    Under ``fastpath`` "on" or "auto" each pair's seconds also include its
    select→encode compute stage, priced by ``compute`` (the
    :class:`~repro_torch.comm.fastpath.ThroughputTable` defaults when
    None) on the path ``fastpath.leaf_fused`` picks, and the decision
    records that ``fused`` flag. ``participants`` prices a partial round;
    ``word_bytes`` sizes ``dense_allreduce``'s words (payload collectives
    decode to f32 words).

    >>> choose_leaf(64, 2, (8,)).codec
    'coo_idx_delta'
    >>> slow_outer = LinkTopo((AlphaBeta(1e-5, 1e-10),
    ...                        AlphaBeta(1e-6, 1e-11)))
    >>> choose_leaf(10**6, 10**5, (2, 4), slow_outer).collective
    'hierarchical'
    """
    model = as_topo(model, max(len(list(dp_sizes)), 1))
    if fastpath not in fastpath_lib.FASTPATH_MODES:
        raise ValueError(
            f"unknown fastpath {fastpath!r}; "
            f"available: {fastpath_lib.FASTPATH_MODES}"
        )
    table = compute or fastpath_lib.ThroughputTable()
    best = None
    for cname, sname in candidate_pairs(codecs, collectives, allow_lossy):
        wb = word_bytes if sname == "dense_allreduce" else WORD_BYTES
        est = cost_lib.predict(
            cname, sname, length, k, dp_sizes, model, wb, participants
        )
        fused = fastpath_lib.leaf_fused(
            fastpath, cname, sname, length, k, table
        )
        seconds = est.seconds
        if fastpath != "off":
            seconds += table.seconds(length, k, fused)
        key = (seconds, est.bytes_on_wire, cname, sname)
        if best is None or key < best[0]:
            best = (key, LeafDecision(cname, sname, est, fused))
    return best[1]


def plan_tree(
    plan: Any,
    dp_sizes: Sequence[int],
    model: LinkModel = AlphaBeta(),
    *,
    codecs: Optional[Sequence[str]] = None,
    collectives: Optional[Sequence[str]] = None,
    allow_lossy: bool = False,
    word_bytes: int = WORD_BYTES,
    participants: Optional[float] = None,
    fastpath: str = "off",
    compute: Optional[fastpath_lib.ThroughputTable] = None,
    overlap: Optional[overlap_lib.OverlapConfig] = None,
) -> CommPlan:
    """Plan every leaf of a ``LeafPlan`` tree
    (``repro_torch.core.distributed``) on its local length and k with
    :func:`choose_leaf`. ``overlap`` also schedules the decided leaves into
    launch buckets (:func:`~repro_torch.comm.overlap.bucketize` over each
    leaf's per-axis stage seconds) and attaches the predicted
    :class:`~repro_torch.comm.overlap.Timeline`.

    >>> from repro_torch.core.distributed import LeafPlan
    >>> tree = {"bias": LeafPlan((64,), 64, 4),
    ...         "embed": LeafPlan((65536,), 65536, 8192)}
    >>> cp = plan_tree(tree, (8,))
    >>> cp.decisions["bias"].codec, cp.decisions["embed"].codec
    ('coo_idx_delta', 'bitmap_dense')
    """
    model = as_topo(model, max(len(list(dp_sizes)), 1))

    def mk(p) -> LeafDecision:
        return choose_leaf(
            p.local_len,
            p.k,
            dp_sizes,
            model,
            codecs=codecs,
            collectives=collectives,
            allow_lossy=allow_lossy,
            word_bytes=word_bytes,
            participants=participants,
            fastpath=fastpath,
            compute=compute,
        )

    decisions = tree_map(mk, plan)
    flat = tree_leaves(decisions)
    buckets = timeline = None
    if overlap is not None and flat:
        costs = [
            overlap_lib.leaf_cost(
                d.codec,
                d.collective,
                p.local_len,
                p.k,
                dp_sizes,
                model,
                word_bytes=(
                    word_bytes
                    if d.collective == "dense_allreduce"
                    else WORD_BYTES
                ),
                participants=participants,
            )
            for p, d in zip(tree_leaves(plan), flat, strict=True)
        ]
        buckets = overlap_lib.bucketize(costs, overlap)
        timeline = overlap_lib.overlap_timeline(buckets)
    return CommPlan(
        decisions=decisions,
        total_bytes=sum(d.cost.bytes_on_wire for d in flat),
        total_messages=sum(d.cost.n_messages for d in flat),
        total_seconds=sum(d.cost.seconds for d in flat),
        model=model,
        buckets=buckets,
        timeline=timeline,
    )


def replan(
    plan: Any,
    dp_sizes: Sequence[int],
    samples: Sequence[Any],
    *,
    k_overrides: Any = None,
    codecs: Optional[Sequence[str]] = None,
    collectives: Optional[Sequence[str]] = None,
    allow_lossy: bool = False,
    word_bytes: int = WORD_BYTES,
    participants: Optional[float] = None,
    fastpath: str = "off",
    compute: Optional[fastpath_lib.ThroughputTable] = None,
    overlap: Optional[overlap_lib.OverlapConfig] = None,
) -> CommPlan:
    """Re-plan every leaf under an :class:`AlphaBeta` fitted from measured
    ``Sample`` rows (:func:`~repro_torch.comm.calibrate.fit_alpha_beta`).
    ``k_overrides`` (a tree of ints mirroring ``plan``, e.g. the adaptive
    controller's current k) changes only the k the wire is scored at;
    capacities and state shapes stay the caller's.

    >>> from repro_torch.comm.calibrate import Sample
    >>> from repro_torch.core.distributed import LeafPlan
    >>> rows = [Sample("probe", i, m, b, m * 1e-4 + b * 1e-9)
    ...         for i, (m, b) in enumerate([(7, 1000), (14, 100000),
    ...                                     (3, 5000000)])]
    >>> replan({"w": LeafPlan((4096,), 4096, 41)}, (8,), rows).decisions["w"].codec
    'coo_idx_delta'
    """
    fitted = fit_alpha_beta(list(samples))
    scored = plan
    if k_overrides is not None:
        scored = tree_map(lambda p, kk: p._replace(k=int(kk)), plan, k_overrides)
    return plan_tree(
        scored,
        dp_sizes,
        fitted,
        codecs=codecs,
        collectives=collectives,
        allow_lossy=allow_lossy,
        word_bytes=word_bytes,
        participants=participants,
        fastpath=fastpath,
        compute=compute,
        overlap=overlap,
    )
