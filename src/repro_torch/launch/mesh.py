"""Data-parallel process groups (counterpart of ``repro.launch.mesh``).

The JAX trainer names the axes of its device mesh and reduces over them
by name; the port runs one worker per rank and reduces over process
groups. A ``DpGroups`` holds this rank's group along each dp axis,
outermost first, in the JAX mesh's axis order:

* ``make_host_groups()``: one axis ``"data"`` over the whole world, the
  dp part of ``make_host_mesh(model=1)``;
* ``make_production_groups(multi_pod=True)``: ``("pod", "data") = (2,
  world/2)``, the dp part of ``make_production_mesh(multi_pod=True)``
  with a model axis of 1. Rank ``r`` sits at ``pod = r // (world/2)``,
  ``data = r % (world/2)``, so the worker order (the rank) is the order
  of the JAX trainer's batch axis, sharded over ``("pod", "data")``.

These are functions, not module constants: each needs an initialised
default process group, and each creates its groups with
``torch.distributed.new_group``, which every rank must call, in the same
order. ``init_file_store`` and ``spawn`` start W ranks on one host
without ``torchrun`` (the tests and ``chip_smoke.py`` use them); under
``torchrun`` the trainer initialises from the environment instead.
"""
from __future__ import annotations

import dataclasses
import math
import multiprocessing
import os
import time
from typing import Callable, Sequence, Tuple

import torch
import torch.distributed as dist

DP_AXES = ("pod", "data")


@dataclasses.dataclass(frozen=True)
class DpGroups:
    """This rank's place in the dp layout: the axis names (outermost
    first), their sizes, and for each axis the process group of the ranks
    that differ from this one only along it."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    groups: Tuple[object, ...]
    rank: int  # the worker index: the rank, outermost axis slowest

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def groups_of(self, axes: Sequence[str]) -> tuple:
        """The groups of ``axes``, in the order given (JAX's axis names)."""
        return tuple(self.groups[self.axis_names.index(a)] for a in axes)


def make_host_groups() -> DpGroups:
    """One dp axis ``"data"`` over every rank of the default group."""
    return DpGroups(
        ("data",), (dist.get_world_size(),), (dist.group.WORLD,),
        dist.get_rank(),
    )


def make_production_groups(*, multi_pod: bool = False) -> DpGroups:
    """``("pod", "data") = (2, world/2)`` under ``multi_pod``, else the
    host layout. Every rank creates every group, pod groups first."""
    if not multi_pod:
        return make_host_groups()
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % 2:
        raise ValueError(f"--multi-pod needs an even world size, not {world}")
    data = world // 2
    pod_group = data_group = None
    for d in range(data):
        group = dist.new_group([p * data + d for p in range(2)])
        if rank % data == d:
            pod_group = group
    for p in range(2):
        group = dist.new_group([p * data + d for d in range(data)])
        if rank // data == p:
            data_group = group
    return DpGroups(("pod", "data"), (2, data), (pod_group, data_group), rank)


def dp_axes_of(groups: DpGroups) -> Tuple[str, ...]:
    """The dp axes of a layout, outermost first.

    >>> dp_axes_of(DpGroups(("pod", "data"), (2, 4), (None, None), 0))
    ('pod', 'data')
    """
    return tuple(a for a in groups.axis_names if a in DP_AXES)


def init_file_store(store: str, rank: int, world: int, backend: str) -> None:
    """Initialise the default process group from a file that every rank
    names (``init_method="file://..."``): no port is bound, so runs side by
    side cannot collide. The file must not exist before the first rank
    starts."""
    dist.init_process_group(
        backend, init_method=f"file://{store}", rank=rank, world_size=world
    )


def _rank_main(fn: Callable, rank: int, world: int, args: tuple) -> None:
    # the host's cores shared out, as torchrun's OMP_NUM_THREADS=1 does:
    # W ranks of all-core thread pools spin against each other
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // world))
    fn(rank, world, *args)


def spawn(fn: Callable, world: int, args: tuple = (),
          timeout: float = 120.0) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` fresh processes (the
    ``spawn`` start method, so ``fn`` is a module-level function), each
    with its share of the host's cores for its thread pool, and wait for
    all of them, at most ``timeout`` seconds in all. Raises if a rank
    fails or is still running then; a rank still running is killed."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, args))
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
    if hung:
        raise TimeoutError(f"ranks {hung} of {world} still ran after {timeout} s")
    failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
    if failed:
        raise RuntimeError(f"ranks failed (rank: exit code): {failed}")
