"""Aggregation of the workers' payloads (counterpart of
``repro.comm.collectives``), in the one-card reference form: all N
workers live on one card, so the worker axis is a real leading axis and
what is left of a collective is its reduction, the paper's Eq. (8)
weighted sum.

* ``dense_allreduce``  — the weighted sum of the decoded dense vectors;
* ``sparse_allgather`` — the weighted scatter-add of every worker's
  decoded payload into one ``[L]`` aggregate.

The scatter-add is deterministic and equal to the JAX package's flat
scatter-add bit for bit. It runs as one ``index_add_`` per worker into a
running ``[L]`` sum, in worker order, so the sum over workers is taken in
the JAX package's sequential order, and CUDA's atomics can only reorder
additions inside one worker's payload. There every index is distinct
except the padding slots of ``selectors.mask_to_payload``, ``(±0.0,
index 0)``, which may share index 0 with each other and with one real
entry. Adding ±0.0 leaves any value unchanged, except that -0.0 becomes
+0.0, and the running sum starts at +0.0 and so never holds -0.0: the
result at index 0 is the real entry's contribution whatever order the
atomics take.

Only the full-participation, worker-weighted form is ported: a
``participation`` mask (ROADMAP queue 1 item 6), coordinate weighting
(item 4), ``hierarchical`` and the forms across cards (item 4) come later.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.comm.codec import CooFp32, Payload

Weights = Union[float, torch.Tensor]


def _no_participation(participation) -> None:
    if participation is not None:
        raise ValueError(
            "participation masks are not ported; ROADMAP queue 1 item 6 "
            "ports comm/participation.py"
        )


def _worker_weights(weights: Weights, n: int, like: torch.Tensor) -> torch.Tensor:
    """``[N]`` weights from a scalar or an ``[N]`` vector."""
    if isinstance(weights, torch.Tensor) and weights.dim() == 1:
        return weights.to(like.dtype)
    return torch.full((n,), float(weights), dtype=like.dtype, device=like.device)


def dense_mean(ghat_stack: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``ghat_stack [N, L]``, ``weights [N]`` (omega_n) → ``[L]``.

    >>> dense_mean(torch.tensor([[2.0, 0.0], [0.0, 4.0]]),
    ...            torch.tensor([0.5, 0.5])).tolist()
    [1.0, 2.0]
    """
    return torch.einsum("n,nl->l", weights.to(ghat_stack.dtype), ghat_stack)


def scatter_add_payloads(
    vals: torch.Tensor, idx: torch.Tensor, weights: Weights, length: int
) -> torch.Tensor:
    """``vals``/``idx`` ``[N, k]`` → the weighted sum ``[L]``, one worker at
    a time in worker order.

    >>> scatter_add_payloads(torch.tensor([[2.0], [4.0]]),
    ...                      torch.tensor([[1], [1]]),
    ...                      torch.tensor([0.5, 0.5]), 3).tolist()
    [0.0, 3.0, 0.0]
    """
    if isinstance(weights, torch.Tensor) and weights.dim() == 1:
        wvals = weights[:, None].to(vals.dtype) * vals
    else:
        wvals = vals * weights
    agg = torch.zeros(length, dtype=vals.dtype, device=vals.device)
    for n in range(vals.shape[0]):
        agg.index_add_(0, idx[n], wvals[n])
    return agg


class SparseAllgather:
    name = "sparse_allgather"

    def reference(
        self, codec: CooFp32, payloads: Payload, weights: Weights, length: int,
        participation: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Decode the ``[N, k]`` payload stack and scatter-add every
        worker's values, times its weight (a scalar or ``[N]``), into one
        ``[L]`` aggregate."""
        _no_participation(participation)
        vals, idx = codec.decode(payloads, length)
        return scatter_add_payloads(vals, idx, weights, length)

    def bytes_per_worker(self, payload_bytes: int, workers: int) -> int:
        """Bytes each worker receives in a ring all-gather of one payload
        per worker (``repro.comm.cost``'s sparse_allgather pattern)."""
        return (workers - 1) * payload_bytes


class DenseAllreduce:
    """Uncompressed baseline: the dense vector on the wire. The reference
    form decodes the payloads (exact for ``coo_fp32``) and takes the
    weighted sum of the dense vectors."""

    name = "dense_allreduce"

    def reference(
        self, codec: CooFp32, payloads: Payload, weights: Weights, length: int,
        participation: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        _no_participation(participation)
        dense = codec.decoded_dense(payloads, length)
        return dense_mean(dense, _worker_weights(weights, dense.shape[0], dense))


COLLECTIVES = {
    c.name: c for c in (DenseAllreduce(), SparseAllgather())
}


def get_collective(name: str):
    try:
        return COLLECTIVES[name]
    except KeyError:
        raise ValueError(
            f"collective {name!r} is not ported; the port has "
            f"{sorted(COLLECTIVES)}"
        ) from None
