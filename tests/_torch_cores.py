"""A pytest-xdist worker's torch thread pool, sized to its share of the
host's cores, as ``repro_torch.launch.mesh.spawn`` sizes its ranks'.

Each worker's pool defaults to every core, so N workers run N pools of
that many threads, and each parallel region's threads wait at its
barrier for cores the other pools hold. On an 8-core host under ``-n 6``
a two-step CLI test of the trainer that takes 0.3 s alone took 27 s, and
the whole suite took 1207 s against 505 s with one thread a worker.
Outside xdist (``PYTEST_XDIST_WORKER_COUNT`` unset) the pool is left as
it is. Every ``tests/test_torch_*.py`` imports this module, so a worker
sizes its pool when it collects the first of them."""
import os

import torch


def share_cores() -> None:
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        cores = len(os.sched_getaffinity(0))
        torch.set_num_threads(max(1, cores // int(workers)))


share_cores()
