"""The wire (counterpart of ``repro.comm``): codecs with exact bit
accounting (``codec``), the reductions in their one-card and across-rank
(``shard``) forms and the two weightings (``collectives``), the
alpha–beta cost model (``cost``), the fused select→encode fastpath's
policy and routing (``fastpath``), the partial-participation schedules
(``participation``) and the adaptive-k controller (``controller``)."""
from repro_torch.comm import (
    codec,
    collectives,
    controller,
    cost,
    fastpath,
    participation,
)
from repro_torch.comm.codec import (
    CODECS,
    BitmapDense,
    Codec,
    CooFp32,
    CooIdxDelta,
    CooQ8,
    delta_index_dtype,
    get_codec,
)
from repro_torch.comm.collectives import (
    COLLECTIVES,
    WEIGHTINGS,
    Collective,
    DenseAllreduce,
    Hierarchical,
    SparseAllgather,
    check_weighting,
    get_collective,
)
from repro_torch.comm.controller import (
    AdaptiveKController,
    ControllerState,
    parse_adaptive_k,
    round_wire_bits,
)
from repro_torch.comm.cost import (
    AlphaBeta,
    CostEstimate,
    LinkModel,
    LinkTopo,
    as_topo,
    measured_bytes,
    parse_link_topo,
    pattern_axes,
    payload_nbytes,
    predict,
    predicted_bytes,
    stage_seconds,
)
from repro_torch.comm.fastpath import (
    FASTPATH_MODES,
    FastpathCounts,
    ThroughputTable,
    fusable,
    fused_compact_select,
)
from repro_torch.comm.participation import (
    PARTICIPATION_KINDS,
    Participation,
    parse_participation,
    renormalize_weights,
    worker_index,
)

__all__ = [
    "AdaptiveKController",
    "AlphaBeta",
    "BitmapDense",
    "CODECS",
    "COLLECTIVES",
    "Codec",
    "Collective",
    "ControllerState",
    "CooFp32",
    "CooIdxDelta",
    "CooQ8",
    "CostEstimate",
    "DenseAllreduce",
    "FASTPATH_MODES",
    "FastpathCounts",
    "Hierarchical",
    "LinkModel",
    "LinkTopo",
    "PARTICIPATION_KINDS",
    "Participation",
    "SparseAllgather",
    "ThroughputTable",
    "WEIGHTINGS",
    "as_topo",
    "check_weighting",
    "codec",
    "collectives",
    "controller",
    "cost",
    "delta_index_dtype",
    "fastpath",
    "fusable",
    "fused_compact_select",
    "get_codec",
    "get_collective",
    "measured_bytes",
    "parse_adaptive_k",
    "parse_link_topo",
    "parse_participation",
    "participation",
    "pattern_axes",
    "payload_nbytes",
    "predict",
    "predicted_bytes",
    "renormalize_weights",
    "round_wire_bits",
    "stage_seconds",
    "worker_index",
]
