"""Sparsifiers, selectors, the simulator, the compact runtime and the
trainer's sparsify-aggregate round (``repro.core``'s counterparts).

The library boundary, as ``repro.core`` offers it to ``examples/``::

    from repro_torch.core import DistributedSim, SparsifierConfig
"""
from repro_torch.core.simulator import DistributedSim, SimState
from repro_torch.core.sparsify import SparsifierConfig, make_sparsifier

__all__ = ["DistributedSim", "SimState", "SparsifierConfig", "make_sparsifier"]
