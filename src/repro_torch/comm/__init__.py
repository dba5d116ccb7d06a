from repro_torch.comm import codec, collectives, fastpath
from repro_torch.comm.codec import CooFp32, get_codec
from repro_torch.comm.collectives import (
    DenseAllreduce,
    SparseAllgather,
    get_collective,
)
from repro_torch.comm.fastpath import FASTPATH_MODES, FastpathCounts

__all__ = [
    "FASTPATH_MODES",
    "CooFp32",
    "DenseAllreduce",
    "FastpathCounts",
    "SparseAllgather",
    "codec",
    "collectives",
    "fastpath",
    "get_codec",
    "get_collective",
]
