"""Aggregation of the workers' payloads (counterpart of
``repro.comm.collectives``): slice 1 ports ``sparse_allgather`` in its
one-card form, the counterpart of ``SparseAllgather.reference``.

All W workers live on one card, so the all-gather is the stacked payload
itself; what is left is the weighted scatter-add, in worker-stack order.
It runs as one ``index_add_`` per worker into a running ``[L]`` sum, in
worker order: inside one worker's payload every index is distinct (it
is a top-k), so each launch adds once per slot and CUDA's atomics have
no order to change, and the sum over workers is taken in the same
sequential order as the JAX package's flat scatter-add. The aggregate is
therefore deterministic and equal to the reference bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.comm.codec import CooFp32, Payload


class SparseAllgather:
    name = "sparse_allgather"

    def reference(
        self, codec: CooFp32, payloads: Payload, weight: float, length: int
    ) -> torch.Tensor:
        """Decode the ``[W, k]`` payload stack and scatter-add every
        worker's values, times ``weight``, into one ``[L]`` aggregate."""
        vals, idx = codec.decode(payloads, length)
        wvals = vals * weight
        agg = torch.zeros(length, dtype=vals.dtype, device=vals.device)
        for n in range(vals.shape[0]):
            agg.index_add_(0, idx[n], wvals[n])
        return agg

    def bytes_per_worker(self, payload_bytes: int, workers: int) -> int:
        """Bytes each worker receives in a ring all-gather of one payload
        per worker (``repro.comm.cost``'s sparse_allgather pattern)."""
        return (workers - 1) * payload_bytes


COLLECTIVES = {SparseAllgather.name: SparseAllgather()}


def get_collective(name: str) -> SparseAllgather:
    try:
        return COLLECTIVES[name]
    except KeyError:
        raise ValueError(
            f"collective {name!r} is not ported; the port has "
            f"{sorted(COLLECTIVES)}"
        ) from None
