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
except the padding slots of ``selectors.mask_to_payload``, ``(+0.0,
index 0)``, which may share index 0 with each other and with one real
entry. Adding +0.0 leaves any value but -0.0 unchanged, and the running
sum starts at +0.0, so it never holds -0.0: the result at index 0 is the
real entry's contribution whatever order the atomics take.

Aggregation weighting is a second axis (``WEIGHTINGS``): ``"worker"`` is
the Eq. (8) reduction above, ``"coordinate"`` divides each coordinate's
weighted sum by the mass of the workers that sent it, ``den[j] = Σ_{n :
ghat_n[j] != 0} omega_n`` (``reference_coord``, which returns ``(agg,
den)``; callers thread ``den`` back into RegTop-k's posterior). Presence
is read from the decoded values, so a padding slot or a ``coo_q8`` value
that quantizes to zero carries no sender mass.

``hierarchical`` (payloads gathered over the slow outer mesh axes, dense
partials summed over the fast inner one) has the numbers of
``sparse_allgather`` in one process: the grouping only matters on a
mesh.

Only the full-participation form is ported: a ``participation`` mask
(ROADMAP queue 1 item 6) and the forms across cards (item 4b) come later.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.comm.codec import Codec, Payload

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


WEIGHTINGS = ("worker", "coordinate")


def check_weighting(name: str) -> str:
    """Validate a ``weighting=`` value.

    >>> check_weighting("coordinate")
    'coordinate'
    >>> check_weighting("per-worker")
    Traceback (most recent call last):
        ...
    ValueError: unknown weighting 'per-worker'; available: \
['worker', 'coordinate']
    """
    if name not in WEIGHTINGS:
        raise ValueError(
            f"unknown weighting {name!r}; available: {list(WEIGHTINGS)}"
        )
    return name


def _coord_num_den(codec, payloads, weights, length):
    """Decode an ``[N, ...]`` payload stack into the coordinate-weighting
    sums ``num[j] = Σ_n w_n·ghat_n[j]`` and ``den[j] = Σ_n w_n·1[ghat_n[j]
    != 0]``, both ``[L]``, each one worker at a time in worker order (the
    JAX package's flat scatter-add order, see the module docstring)."""
    vals, idx = codec.decode(payloads, length)
    w = _worker_weights(weights, vals.shape[0], vals)
    presence = (vals != 0).to(vals.dtype)
    return (
        scatter_add_payloads(vals, idx, w, length),
        scatter_add_payloads(presence, idx, w, length),
    )


def _coord_divide(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` with a floor of the dtype's smallest normal: where no
    worker sent the coordinate, ``den == 0`` and ``num == 0``, so the
    quotient is 0 and not NaN."""
    return num / torch.clamp(den, min=torch.finfo(den.dtype).tiny)


class Collective:
    """A reduction of the workers' payloads, in the one-card reference
    forms: ``reference`` (worker weighting) returns the ``[L]``
    aggregate, ``reference_coord`` (coordinate weighting) ``(agg, den)``."""

    name: str = "base"

    def reference(
        self, codec: Codec, payloads: Payload, weights: Weights, length: int,
        participation: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        raise NotImplementedError

    def reference_coord(
        self, codec: Codec, payloads: Payload, weights: Weights, length: int,
        participation: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError


class SparseAllgather(Collective):
    name = "sparse_allgather"

    def reference(self, codec, payloads, weights, length, participation=None):
        """Decode the ``[N, k]`` payload stack and scatter-add every
        worker's values, times its weight (a scalar or ``[N]``), into one
        ``[L]`` aggregate."""
        _no_participation(participation)
        vals, idx = codec.decode(payloads, length)
        return scatter_add_payloads(vals, idx, weights, length)

    def reference_coord(self, codec, payloads, weights, length,
                        participation=None):
        _no_participation(participation)
        num, den = _coord_num_den(codec, payloads, weights, length)
        return _coord_divide(num, den), den


class Hierarchical(SparseAllgather):
    """Payloads all-gathered over the outer (slow) mesh axes and decoded,
    dense partials summed over the innermost (fast) one. In one process
    the grouping is notional: the numbers are ``sparse_allgather``'s."""

    name = "hierarchical"


class DenseAllreduce(Collective):
    """Uncompressed baseline: the dense vector on the wire. The reference
    form decodes the payloads (exact for the lossless codecs) and takes
    the weighted sum of the dense vectors."""

    name = "dense_allreduce"

    def reference(self, codec, payloads, weights, length, participation=None):
        _no_participation(participation)
        dense = codec.decoded_dense(payloads, length)
        return dense_mean(dense, _worker_weights(weights, dense.shape[0], dense))

    def reference_coord(self, codec, payloads, weights, length,
                        participation=None):
        # dense on the wire, but the sparsified gradient is zero off the
        # selected coordinates: presence still names the senders
        _no_participation(participation)
        dense = codec.decoded_dense(payloads, length)
        w = _worker_weights(weights, dense.shape[0], dense)
        presence = (dense != 0).to(dense.dtype)
        num, den = dense_mean(dense, w), dense_mean(presence, w)
        return _coord_divide(num, den), den


COLLECTIVES = {
    c.name: c for c in (DenseAllreduce(), SparseAllgather(), Hierarchical())
}


def get_collective(name: str) -> Collective:
    """Look up a collective by name.

    >>> get_collective("hierarchical").name
    'hierarchical'
    >>> get_collective("bogus")
    Traceback (most recent call last):
        ...
    ValueError: unknown collective 'bogus'; available: ['dense_allreduce', \
'hierarchical', 'sparse_allgather']
    """
    try:
        return COLLECTIVES[name]
    except KeyError:
        raise ValueError(
            f"unknown collective {name!r}; available: {sorted(COLLECTIVES)}"
        ) from None
