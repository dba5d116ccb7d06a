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

The ``shard`` and ``shard_coord`` forms run on one rank per worker over
``torch.distributed``, where the JAX package's run inside ``shard_map``:
they take this rank's payload (a worker axis of 1) and a sequence of
process groups, outermost first, where the JAX forms take axis names
(``repro_torch.launch.mesh`` builds them). A gather stacks the ranks'
payloads as ``jax.lax.all_gather`` over the axes in turn stacks them (on
one axis, in rank order), then every rank decodes and scatter-adds the
stack one worker at a time, as ``reference`` does: ``sparse_allgather``
across ranks equals the one-card form and the JAX shard form in f32
bits. The sums that ``dense_allreduce`` and ``hierarchical``'s inner
stage take with ``all_reduce`` follow the backend's order, as ``psum``
follows XLA's. Every field is gathered as its bytes (gloo refuses
int16), so the wire carries the codec's own bytes. Under gloo a CUDA
tensor is staged through host memory by the backend itself.

Partial participation (``repro_torch.comm.participation``) composes
with every collective through the optional ``participation`` argument:
``reference(..., participation=mask)`` masks the ``[N]`` weights with the
round's ``{0,1}`` mask and renormalizes them to sum to one;
``shard(..., participation=m)`` scales this rank's contribution by its own
mask entry ``m``, the caller passing the renormalized participant weight,
which every rank derives from the shared schedule. A dropped rank's
payload still crosses the wire and lands with weight 0. ``None`` is the
full round, bit for bit.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.comm.codec import Codec, Payload, get_codec
from repro_torch.comm.participation import renormalize_weights

Weights = Union[float, torch.Tensor]


def _reference_weights(weights: Weights, participation, device) -> Weights:
    """One reference-form round's weights: ``weights`` as given for a full
    round, else masked by ``participation`` (the ``[N]`` mask) and
    renormalized to sum to one, float32 on ``device``."""
    if participation is None:
        return weights
    mask = participation.to(device=device, dtype=torch.float32)
    return renormalize_weights(_worker_weights(weights, mask.shape[0], mask), mask)


def _shard_weight(weight, participation, device) -> Weights:
    """This rank's weight: its participant weight times its own mask
    entry on a partial round, a float32 scalar tensor."""
    if participation is None:
        return weight
    w = torch.as_tensor(weight, dtype=torch.float32, device=device)
    return w * torch.as_tensor(participation, dtype=torch.float32,
                               device=device)


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


def _gather(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """All-gather ``x`` over each group in turn, outermost first, as the
    JAX package's ``_gather_payload`` loops over its axis names: this
    rank's ``[1, ...]`` becomes ``[N, ...]``, and a 1-D field (``coo_q8``'s
    ``scale [1]``) becomes ``[N]``. Each gather stacks the group's
    ranks in order and the next gathers that stack whole, so on two axes
    the outer axis varies fastest, as in JAX. The bytes are gathered,
    then viewed back."""
    for group in groups:
        raw = x.contiguous().view(torch.uint8)
        parts = [torch.empty_like(raw) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, raw, group=group)
        x = torch.cat(parts).view(x.dtype)
    return x


def _gather_payload(payload: Payload, groups: Sequence) -> Payload:
    """Every field of this rank's payload gathered over ``groups``
    (``_gather``): a ``[N, ...]`` stack, in the JAX shard form's order."""
    return {name: _gather(x, groups) for name, x in payload.items()}


def _psum(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """The sum of ``x`` over every rank of ``groups``, one group after
    another, in the backend's order (``x`` is left as it was)."""
    x = x.clone()
    for group in groups:
        dist.all_reduce(x, group=group)
    return x


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

    def shard(
        self, codec: Codec, payload: Payload, length: int, groups: Sequence,
        weight: float, participation: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """This rank's ``[1, ...]`` payload reduced over the process
        ``groups`` (outermost first) with this rank's ``weight``: the
        ``[L]`` aggregate, the same on every rank."""
        raise NotImplementedError

    def shard_coord(
        self, codec: Codec, payload: Payload, length: int, groups: Sequence,
        weight: float, participation: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Coordinate weighting across ranks: ``(agg, den)``."""
        raise NotImplementedError


def _shard_num_den(codec, payload, length, groups, weight, participation):
    """The coordinate-weighting sums over the ranks of ``groups``: the
    payloads and each rank's own weight (times its mask entry on a partial
    round) gathered in one stacking order, then decoded and added one
    worker at a time (``_coord_num_den``)."""
    device = next(iter(payload.values())).device
    w = _shard_weight(weight, participation, device)
    w = torch.as_tensor(w, dtype=torch.float32, device=device).reshape(1)
    return _coord_num_den(
        codec, _gather_payload(payload, groups), _gather(w, groups), length
    )


class SparseAllgather(Collective):
    name = "sparse_allgather"

    def reference(self, codec, payloads, weights, length, participation=None):
        """Decode the ``[N, k]`` payload stack and scatter-add every
        worker's values, times its weight (a scalar or ``[N]``; masked and
        renormalized on a partial round), into one ``[L]`` aggregate."""
        vals, idx = codec.decode(payloads, length)
        w = _reference_weights(weights, participation, vals.device)
        return scatter_add_payloads(vals, idx, w, length)

    def reference_coord(self, codec, payloads, weights, length,
                        participation=None):
        w = _reference_weights(
            weights, participation, next(iter(payloads.values())).device)
        num, den = _coord_num_den(codec, payloads, w, length)
        return _coord_divide(num, den), den

    def shard(self, codec, payload, length, groups, weight,
              participation=None):
        """Gather every rank's payload, then ``reference`` on the stack. On
        a partial round each rank's weight times its mask entry rides the
        gather beside its payload, so the weights arrive in the stack's
        order."""
        gathered = _gather_payload(payload, groups)
        if participation is None:
            return self.reference(codec, gathered, weight, length)
        device = next(iter(payload.values())).device
        w = _shard_weight(weight, participation, device).reshape(1)
        return self.reference(codec, gathered, _gather(w, groups), length)

    def shard_coord(self, codec, payload, length, groups, weight,
                    participation=None):
        num, den = _shard_num_den(codec, payload, length, groups, weight,
                                  participation)
        return _coord_divide(num, den), den


class Hierarchical(SparseAllgather):
    """Payloads all-gathered over the outer (slow) mesh axes and decoded,
    dense partials summed over the innermost (fast) one. In one process
    the grouping is notional: the numbers are ``sparse_allgather``'s.
    Across ranks ``groups[:-1]`` are the outer groups (none on one axis,
    where this rank's own payload is the partial) and ``groups[-1]`` the
    inner one."""

    name = "hierarchical"

    def shard(self, codec, payload, length, groups, weight,
              participation=None):
        partial = super().shard(
            codec, payload, length, groups[:-1], weight, participation
        )
        return _psum(partial, groups[-1:])

    def shard_coord(self, codec, payload, length, groups, weight,
                    participation=None):
        num, den = _shard_num_den(codec, payload, length, groups[:-1], weight,
                                  participation)
        num, den = _psum(num, groups[-1:]), _psum(den, groups[-1:])
        return _coord_divide(num, den), den


class DenseAllreduce(Collective):
    """Uncompressed baseline: the dense vector on the wire. The reference
    form decodes the payloads (exact for the lossless codecs) and takes
    the weighted sum of the dense vectors."""

    name = "dense_allreduce"

    def reference(self, codec, payloads, weights, length, participation=None):
        dense = codec.decoded_dense(payloads, length)
        w = _worker_weights(weights, dense.shape[0], dense)
        return dense_mean(dense, _reference_weights(w, participation, dense.device))

    def reference_coord(self, codec, payloads, weights, length,
                        participation=None):
        # dense on the wire, but the sparsified gradient is zero off the
        # selected coordinates: presence still names the senders
        dense = codec.decoded_dense(payloads, length)
        w = _reference_weights(_worker_weights(weights, dense.shape[0], dense),
                               participation, dense.device)
        presence = (dense != 0).to(dense.dtype)
        num, den = dense_mean(dense, w), dense_mean(presence, w)
        return _coord_divide(num, den), den

    def shard(self, codec, payload, length, groups, weight,
              participation=None):
        dense = codec.decoded_dense(payload, length)[0]
        w = _shard_weight(weight, participation, dense.device)
        return _psum(dense * w, groups)

    def shard_coord(self, codec, payload, length, groups, weight,
                    participation=None):
        dense = codec.decoded_dense(payload, length)[0]
        w = _shard_weight(weight, participation, dense.device)
        presence = (dense != 0).to(dense.dtype)
        num = _psum(dense * w, groups)
        den = _psum(presence * w, groups)
        return _coord_divide(num, den), den


COLLECTIVES = {
    c.name: c for c in (DenseAllreduce(), SparseAllgather(), Hierarchical())
}


def allreduce_dense(ghat: torch.Tensor, groups: Sequence,
                    weight: float) -> torch.Tensor:
    """Weighted dense all-reduce of this rank's ``ghat [L]`` over the
    process ``groups`` (the uncompressed pattern). Needs an initialised
    process group:

    >>> agg = allreduce_dense(ghat, mesh.groups_of(("data",)), 1.0 / 8)  # doctest: +SKIP
    """
    return _psum(ghat * weight, groups)


def allgather_scatter(vals: torch.Tensor, idx: torch.Tensor, length: int,
                      groups: Sequence, weight: float) -> torch.Tensor:
    """Compressed aggregation of this rank's ``(vals [k], idx [k])`` in the
    fp32 COO wire format, ``SparseAllgather().shard`` with ``coo_fp32``.
    Needs an initialised process group:

    >>> agg = allgather_scatter(vals, idx, L, mesh.groups_of(("data",)), w)  # doctest: +SKIP
    """
    codec = get_codec("coo_fp32")
    payload = codec.encode(vals[None], idx[None], length)
    return SparseAllgather().shard(codec, payload, length, groups, weight)


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
