"""Micro-calibration: time real collectives across ranks and fit alpha–beta
link models (counterpart of ``repro.comm.calibrate``).

The probes run over the dp process groups of a
``repro_torch.launch.mesh.DpGroups`` with the calls of the collectives'
``shard`` forms: an ``all_reduce`` of a dense f32 ``[L]``
(``dense_allreduce``) and an all-gather of an ``[L]`` buffer followed by a
local sum (``sparse_allgather``), at a geometric ladder of lengths. A
least-squares fit of

    seconds = n_messages * alpha + bytes_on_wire * beta

over the samples, whose message and byte counts come from the ring
patterns the cost model scores (:func:`repro_torch.comm.cost._pattern`),
gives the model.

* :func:`calibrate` — one :class:`AlphaBeta` for the whole dp group;
* :func:`calibrate_topo` — one per dp axis, probing each axis alone, as a
  :class:`~repro_torch.comm.cost.LinkTopo` for ``DistConfig.link_topo``.

Every rank times its own calls, so the ranks' samples differ in their last
digits. The fit is made from rank 0's samples, broadcast to every rank, so
that every rank holds one model and plans one plan. In one process there
is no process group and so no wire: the result is the default model,
``calibrated=False``. Timings include the host's dispatch, so alpha
absorbs the launch cost; each axis is timed with the others idle.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as torch_dist

from repro_torch.comm.collectives import _gather, _psum
from repro_torch.comm.cost import AlphaBeta, LinkTopo, _pattern

DEFAULT_LENGTHS = (1 << 12, 1 << 14, 1 << 16, 1 << 18)


@dataclasses.dataclass(frozen=True)
class Sample:
    """One timed collective: a row of the fit."""

    collective: str
    length: int
    n_messages: int
    bytes_on_wire: int
    seconds: float


@dataclasses.dataclass(frozen=True)
class Calibration:
    model: AlphaBeta
    samples: Tuple[Sample, ...]
    calibrated: bool
    residual: float  # RMS of the fit, seconds


@dataclasses.dataclass(frozen=True)
class TopoCalibration:
    """Per-axis calibrations and the :class:`LinkTopo` they make:
    ``axes`` outermost first, ``per_axis[i]`` that axis's
    :class:`Calibration` (``calibrated=False`` for a size-1 axis);
    ``calibrated`` when at least one axis was timed."""

    topo: LinkTopo
    per_axis: Tuple[Calibration, ...]
    axes: Tuple[str, ...]
    calibrated: bool


_DEFAULT = Calibration(model=AlphaBeta(), samples=(), calibrated=False,
                       residual=0.0)


def fit_alpha_beta(
    samples: Sequence[Sample],
    floor_alpha: float = 1e-9,
    floor_beta: float = 1e-14,
) -> AlphaBeta:
    """Least squares over the sample rows, clamped non-negative: a
    coefficient under its floor is clamped and the other term refitted
    alone.

    >>> rows = [Sample("probe", i, m, b, m * 2e-5 + b * 3e-10)
    ...         for i, (m, b) in enumerate([(7, 1000), (14, 100000),
    ...                                     (3, 5000000)])]
    >>> fit = fit_alpha_beta(rows)
    >>> round(fit.alpha, 9), round(fit.beta, 14)
    (2e-05, 3e-10)
    """
    if not samples:
        raise ValueError("cannot fit AlphaBeta from zero samples")
    A = np.array(
        [[s.n_messages, s.bytes_on_wire] for s in samples], np.float64
    )
    t = np.array([s.seconds for s in samples], np.float64)
    x, *_ = np.linalg.lstsq(A, t, rcond=None)
    alpha, beta = float(x[0]), float(x[1])
    if alpha < floor_alpha and beta < floor_beta:
        return AlphaBeta(alpha=floor_alpha, beta=floor_beta)
    if alpha < floor_alpha:
        beta = max(float(t @ A[:, 1] / (A[:, 1] @ A[:, 1])), floor_beta)
        return AlphaBeta(alpha=floor_alpha, beta=beta)
    if beta < floor_beta:
        alpha = max(float(t @ A[:, 0] / (A[:, 0] @ A[:, 0])), floor_alpha)
        return AlphaBeta(alpha=alpha, beta=floor_beta)
    return AlphaBeta(alpha=alpha, beta=beta)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_call(fn: Callable[[], torch.Tensor], device: torch.device,
               iters: int = 5, warmup: int = 2) -> float:
    """Median seconds of one call of ``fn`` on this rank: each timed call
    starts after a barrier, so the ranks start together, and ends when the
    device has finished."""
    for _ in range(warmup):
        fn()
    _sync(device)
    times = []
    for _ in range(iters):
        torch_dist.barrier()
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def _dp_sizes(groups, dp_axes: Sequence[str]) -> List[int]:
    return [groups.shape[groups.axis_names.index(a)] for a in dp_axes]


def time_collective(
    groups,
    dp_axes: Sequence[str],
    length: int,
    collective: str = "dense_allreduce",
    word_bytes: int = 4,
    iters: int = 5,
    device="cuda",
) -> Sample:
    """Time one collective over the process groups of ``dp_axes`` in the
    dp layout ``groups`` (a ``DpGroups``); every rank calls it together.
    ``dense_allreduce`` all-reduces a dense f32 ``[L]``;
    ``sparse_allgather`` all-gathers a ``length``-word buffer (the
    payload's stand-in) and sums the stack on this rank.

    >>> s = time_collective(groups, ("data",), 4096, device="cpu")  # doctest: +SKIP
    >>> s.n_messages  # 2·(N-1) ring steps at N = 8     # doctest: +SKIP
    14
    """
    dev = torch.device(device)
    gr = groups.groups_of(tuple(dp_axes))
    x = torch.ones(length, dtype=torch.float32, device=dev)
    if collective == "dense_allreduce":
        def call():
            return _psum(x, gr)

        payload_bytes = 0.0  # the dense term carries the bytes
    elif collective == "sparse_allgather":
        def call():
            return _gather(x[None], gr).sum(0)

        payload_bytes = length * word_bytes
    else:
        raise ValueError(
            f"calibration probe for {collective!r} not implemented; "
            "use 'dense_allreduce' or 'sparse_allgather'"
        )
    secs = _time_call(call, dev, iters=iters)
    by, msgs = _pattern(collective, length, payload_bytes,
                        _dp_sizes(groups, dp_axes), word_bytes)
    return Sample(collective=collective, length=length, n_messages=msgs,
                  bytes_on_wire=int(math.ceil(by)), seconds=secs)


def _rank0(samples: List[Sample]) -> List[Sample]:
    """Rank 0's samples on every rank."""
    shared = [samples]
    torch_dist.broadcast_object_list(shared, src=0)
    return shared[0]


def _resolve(groups, dp_axes) -> Tuple[Optional[object], Tuple[str, ...]]:
    """Without a dp layout there is nothing to probe; ``dp_axes`` without
    the layout that defines them is ambiguous."""
    if groups is None:
        if dp_axes is not None:
            raise ValueError(
                "dp_axes without a mesh is ambiguous: pass the mesh whose "
                f"axes {tuple(dp_axes)} should be probed"
            )
        return None, ("data",)
    return groups, tuple(dp_axes or ("data",))


def calibrate(
    groups=None,
    dp_axes: Optional[Sequence[str]] = None,
    lengths: Sequence[int] = DEFAULT_LENGTHS,
    collectives: Sequence[str] = ("dense_allreduce", "sparse_allgather"),
    iters: int = 5,
    device="cuda",
) -> Calibration:
    """Probe the collectives over ``dp_axes`` of ``groups`` and fit one
    :class:`AlphaBeta` from rank 0's samples. A dp group of fewer than two
    workers (one process, or axes of size 1) has no wire: the default
    model, ``calibrated=False``.

    >>> calibrate(device="cpu").calibrated
    False
    """
    groups, dp_axes = _resolve(groups, dp_axes)
    if groups is None or math.prod(_dp_sizes(groups, dp_axes)) < 2:
        return _DEFAULT
    samples = [
        time_collective(groups, dp_axes, L, coll, iters=iters, device=device)
        for coll in collectives for L in lengths
    ]
    samples = _rank0(samples)
    model = fit_alpha_beta(samples)
    pred = np.array(
        [s.n_messages * model.alpha + s.bytes_on_wire * model.beta
         for s in samples]
    )
    meas = np.array([s.seconds for s in samples])
    rms = float(np.sqrt(np.mean((pred - meas) ** 2)))
    return Calibration(
        model=model, samples=tuple(samples), calibrated=True, residual=rms
    )


def calibrate_topo(
    groups=None,
    dp_axes: Optional[Sequence[str]] = None,
    lengths: Sequence[int] = DEFAULT_LENGTHS,
    collectives: Sequence[str] = ("dense_allreduce", "sparse_allgather"),
    iters: int = 5,
    device="cuda",
) -> TopoCalibration:
    """One :class:`AlphaBeta` per dp axis of ``groups`` (outermost
    first), each axis timed alone with :func:`calibrate`; a size-1 axis
    keeps the default model, ``calibrated=False``.

    >>> calibrate_topo(device="cpu").topo.n_axes
    1
    """
    groups, dp_axes = _resolve(groups, dp_axes)
    per_axis = []
    for ax in dp_axes:
        if groups is None or _dp_sizes(groups, (ax,))[0] < 2:
            per_axis.append(_DEFAULT)
            continue
        per_axis.append(calibrate(groups, (ax,), lengths, collectives,
                                  iters, device))
    return TopoCalibration(
        topo=LinkTopo(tuple(c.model for c in per_axis)),
        per_axis=tuple(per_axis),
        axes=dp_axes,
        calibrated=any(c.calibrated for c in per_axis),
    )
