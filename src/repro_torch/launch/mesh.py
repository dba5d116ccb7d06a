"""The ``(data, model)`` rank layouts and their process groups
(counterpart of ``repro.launch.mesh``).

The JAX trainer lays its devices out on a named mesh and reduces over the
axes by name; the port runs one (worker, model shard) per rank and
reduces over process groups. A layout is a plain ``{axis: size}``
mapping in the JAX mesh's axis order:

* ``host_shape(n, model=M)``: ``(data, model) = (n/M, M)``, as
  ``make_host_mesh(model=M)`` lays out n devices. With ``multi_pod`` it
  is ``(pod, data, model) = (2, n/(2M), M)``: the port's own host layout
  with two dp axes (the JAX package's host mesh ignores ``--multi-pod``);
* ``production_shape()``: ``(data, model) = (16, 16)``, or ``(pod, data,
  model) = (2, 16, 16)`` with ``multi_pod``, as
  ``make_production_mesh``; only a world of 256 or 512 ranks holds it.

Ranks follow the JAX device mesh, row-major with the model axis fastest:
rank ``r`` is worker ``r // M`` (its index over the dp axes, outermost
slowest, the order of the JAX trainer's batch axis) and model shard ``r
% M``. Every rank of one worker's model group reads that worker's batch
rows. A ``DpGroups`` holds this rank's place: its group along each dp
axis (the ranks of its model index that differ from it only along that
axis), outermost first, and its model group.

The group makers are functions, not module constants: each needs an
initialised default process group, and each creates its groups with
``torch.distributed.new_group``, which every rank must call for every
group in one order (:func:`layout_groups`: the dp groups of each model
index first, then the model groups). ``init_file_store`` and ``spawn``
start ranks on one host without ``torchrun`` (the tests and
``chip_smoke.py`` use them); under ``torchrun`` the trainer initialises
from the environment instead.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import multiprocessing
import os
import tempfile
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DP_AXES = ("pod", "data")
MODEL_AXIS = "model"
ERROR_CHARS = 2000  # of each failed rank's exception, in spawn's error
PRODUCTION = {False: {"data": 16, "model": 16},
              True: {"pod": 2, "data": 16, "model": 16}}

# Hardware constants of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's
# H100 data sheet; dense rates, without sparsity), which the dry run's
# records are read against.
PEAK_FLOPS_BF16 = 989e12  # per card, on the tensor cores
PEAK_FLOPS_F32 = 67e12  # per card, outside the tensor cores (TF32 off)
HBM_BW = 3.35e12  # bytes/s per card
HBM_BYTES = 80e9  # bytes of device memory per card
NVLINK_BW = 450e9  # bytes/s per card, each way (NVLink 4, 900 GB/s total)


def host_shape(devices: int, model: int = 1,
               multi_pod: bool = False) -> Dict[str, int]:
    """The host layout of ``devices`` devices (or ranks) with a model axis
    of ``model``; raises when ``model`` (or ``2 * model`` under
    ``multi_pod``) does not divide them.

    >>> host_shape(4, model=2)
    {'data': 2, 'model': 2}
    >>> host_shape(8, model=2, multi_pod=True)
    {'pod': 2, 'data': 2, 'model': 2}
    """
    if model < 1 or devices % model:
        raise ValueError(
            f"--model-parallel {model} does not divide {devices} devices: "
            "the (data, model) layout needs devices = data x model"
        )
    if not multi_pod:
        return {"data": devices // model, MODEL_AXIS: model}
    if devices % (2 * model):
        raise ValueError(
            f"--multi-pod with --model-parallel {model} needs a multiple of "
            f"{2 * model} ranks, not {devices}: (pod, data, model) = "
            "(2, ranks / (2 x model), model)"
        )
    return {"pod": 2, "data": devices // (2 * model), MODEL_AXIS: model}


def production_shape(multi_pod: bool = False) -> Dict[str, int]:
    """The production mesh: ``(data, model) = (16, 16)``, or ``(pod, data,
    model) = (2, 16, 16)`` under ``multi_pod``.

    >>> production_shape()
    {'data': 16, 'model': 16}
    """
    return dict(PRODUCTION[multi_pod])


def check_world(shape: Mapping[str, int], world: int,
                production: bool = False) -> None:
    """Raise unless ``world`` ranks fill ``shape``; the production layouts'
    message names both of their sizes."""
    need = math.prod(shape.values())
    if world == need:
        return
    if production:
        raise ValueError(
            f"--mesh production needs {math.prod(PRODUCTION[False].values())} "
            f"ranks ((data, model) = (16, 16)) or "
            f"{math.prod(PRODUCTION[True].values())} with --multi-pod ((pod, "
            f"data, model) = (2, 16, 16)), not {world}"
        )
    raise ValueError(f"the layout {dict(shape)} holds {need} ranks, not {world}")


def dp_axes_of(layout) -> Tuple[str, ...]:
    """The dp axes of a layout (a ``DpGroups`` or an ``{axis: size}``
    mapping), outermost first: ``pod`` and ``data`` only.

    >>> dp_axes_of({"pod": 2, "data": 4, "model": 2})
    ('pod', 'data')
    """
    names = layout.axis_names if isinstance(layout, DpGroups) else tuple(layout)
    return tuple(a for a in names if a in DP_AXES)


def model_size(shape: Mapping[str, int]) -> int:
    """The product of the layout's non-dp axes: the model shards of each
    worker.

    >>> model_size({"data": 2, "model": 4})
    4
    """
    return math.prod(v for a, v in shape.items() if a not in DP_AXES)


def rank_coords(rank: int, shape: Mapping[str, int]) -> Dict[str, int]:
    """Rank ``rank``'s coordinates on the layout, row-major with the last
    axis fastest, as the JAX device mesh.

    >>> rank_coords(5, {"pod": 2, "data": 2, "model": 2})
    {'pod': 1, 'data': 0, 'model': 1}
    """
    out, rest = {}, rank
    for axis, size in reversed(list(shape.items())):
        out[axis] = rest % size
        rest //= size
    return {axis: out[axis] for axis in shape}


def _rank_of(coords: Mapping[str, int], shape: Mapping[str, int]) -> int:
    r = 0
    for axis, size in shape.items():
        r = r * size + coords[axis]
    return r


def layout_groups(shape: Mapping[str, int]) -> List[Tuple[str, List[int]]]:
    """``[(axis, ranks), ...]``: every group of the layout, in the order
    every rank creates them: for each model index, each dp axis outermost
    first, the lines along it in row-major order of the other dp axes;
    then each worker's model group. No model groups at a model axis of 1.

    >>> layout_groups({"data": 2, "model": 2})
    [('data', [0, 2]), ('data', [1, 3]), ('model', [0, 1]), ('model', [2, 3])]
    """
    dp = dp_axes_of(shape)
    model = [a for a in shape if a not in DP_AXES]
    out = []
    for mcoord in itertools.product(*(range(shape[a]) for a in model)):
        for axis in dp:
            others = [a for a in dp if a != axis]
            for ocoord in itertools.product(*(range(shape[a]) for a in others)):
                base = dict(zip(model, mcoord), **dict(zip(others, ocoord)))
                out.append((axis, [_rank_of({**base, axis: i}, shape)
                                   for i in range(shape[axis])]))
    if model_size(shape) > 1:
        for dcoord in itertools.product(*(range(shape[a]) for a in dp)):
            base = dict(zip(dp, dcoord))
            out.append((MODEL_AXIS, [
                _rank_of({**base, **dict(zip(model, mc))}, shape)
                for mc in itertools.product(*(range(shape[a]) for a in model))
            ]))
    return out


@dataclasses.dataclass(frozen=True)
class DpGroups:
    """This rank's place in the layout: the dp axis names (outermost
    first), their sizes, for each dp axis the process group of the ranks
    of its model index that differ from it only along that axis, its
    worker index, and its model shard of ``model`` with the model group
    (the ranks of its worker; None at a model axis of 1)."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    groups: Tuple[object, ...]
    rank: int  # the worker index over the dp axes, outermost axis slowest
    model: int = 1
    shard: int = 0
    model_group: Optional[object] = None

    @property
    def size(self) -> int:
        """W, the number of workers (the ranks of one model index)."""
        return math.prod(self.shape)

    @property
    def mesh_shape(self) -> Dict[str, int]:
        """The whole layout, ``{axis: size}``, the model axis last."""
        return {**dict(zip(self.axis_names, self.shape)), MODEL_AXIS: self.model}

    @property
    def row(self) -> int:
        """This rank's row among the W x M (worker, shard) rows, worker
        major: its global rank."""
        return self.rank * self.model + self.shard

    def groups_of(self, axes: Sequence[str]) -> tuple:
        """The groups of ``axes``, in the order given (JAX's axis names)."""
        return tuple(self.groups[self.axis_names.index(a)] for a in axes)


def make_groups(shape: Mapping[str, int]) -> DpGroups:
    """This rank's ``DpGroups`` on ``shape`` (which the world must fill),
    every group of :func:`layout_groups` created on every rank; a dp axis
    that spans the whole world is the default group."""
    world, rank = dist.get_world_size(), dist.get_rank()
    check_world(shape, world)
    coords = rank_coords(rank, shape)
    dp = dp_axes_of(shape)
    M = model_size(shape)
    mine: Dict[str, object] = {}
    for axis, ranks in layout_groups(shape):
        group = (dist.group.WORLD if len(ranks) == world
                 else dist.new_group(ranks))
        if rank in ranks:
            mine[axis] = group
    worker = _rank_of({a: coords[a] for a in dp}, {a: shape[a] for a in dp})
    return DpGroups(dp, tuple(shape[a] for a in dp),
                    tuple(mine[a] for a in dp), worker, M, rank % M,
                    mine.get(MODEL_AXIS))


def make_host_groups(model: int = 1, multi_pod: bool = False) -> DpGroups:
    """The host layout over every rank of the default group
    (:func:`host_shape`): ``(data, model) = (world/M, M)``, or ``(pod,
    data, model) = (2, world/(2M), M)`` under ``multi_pod``."""
    return make_groups(host_shape(dist.get_world_size(), model, multi_pod))


def make_production_groups(*, multi_pod: bool = False) -> DpGroups:
    """The production layout (:func:`production_shape`); a world of any
    other size than 256 (512 under ``multi_pod``) is refused before any
    group is made."""
    shape = production_shape(multi_pod)
    check_world(shape, dist.get_world_size(), production=True)
    return make_groups(shape)


def init_file_store(store: str, rank: int, world: int, backend: str) -> None:
    """Initialise the default process group from a file that every rank
    names (``init_method="file://..."``): no port is bound, so runs side by
    side cannot collide. The file must not exist before the first rank
    starts."""
    dist.init_process_group(
        backend, init_method=f"file://{store}", rank=rank, world_size=world
    )


def _rank_main(fn: Callable, rank: int, world: int, args: tuple,
               errors: str) -> None:
    # the host's cores shared out, as torchrun's OMP_NUM_THREADS=1 does:
    # W ranks of all-core thread pools spin against each other
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // world))
    try:
        fn(rank, world, *args)
    except Exception as e:  # the parent names it; the traceback still prints
        text = f"{type(e).__name__}: {e}"
        with open(os.path.join(errors, f"rank{rank}"), "w") as f:
            f.write(text[:ERROR_CHARS])
        raise


def spawn(fn: Callable, world: int, args: tuple = (),
          timeout: float = 120.0) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` fresh processes (the
    ``spawn`` start method, so ``fn`` is a module-level function), each
    with its share of the host's cores for its thread pool, and wait for
    all of them, at most ``timeout`` seconds in all. Raises if a rank
    fails or is still running then; a rank still running is killed. The
    error names each failed rank's exception, so the rank whose fault made
    its peers' collectives fail shows beside them."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as errors:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, args, errors))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        raised = {}
        for r in range(world):
            path = os.path.join(errors, f"rank{r}")
            if os.path.exists(path):
                with open(path) as f:
                    raised[r] = f.read()
    if hung:
        raise TimeoutError(f"ranks {hung} of {world} still ran after {timeout} s"
                           + _raised(raised))
    failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
    if failed:
        raise RuntimeError(f"ranks failed (rank: exit code): {failed}"
                           + _raised(raised))


def _raised(raised: Dict[int, str]) -> str:
    return "".join(f"\n  rank {r} raised {text}" for r, text in raised.items())
