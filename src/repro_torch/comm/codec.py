"""Wire codecs (counterpart of ``repro.comm.codec``): slice 1 ports
``coo_fp32``, the baseline fp32-value + int32-index payload.

Payloads are dicts of tensors with a leading worker axis: ``vals [W, k]``
f32 and ``idx [W, k]`` int32 on the wire. ``decode`` returns int64
indices, torch's indexing type.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

Payload = Dict[str, torch.Tensor]


class CooFp32:
    """fp32 values + int32 indices — the uncompressed-index baseline."""

    name = "coo_fp32"
    lossless = True
    supports_fused = True

    def encode(self, vals: torch.Tensor, idx: torch.Tensor, length: int) -> Payload:
        return {"vals": vals.float(), "idx": idx.int()}

    def encode_fused(self, vals: torch.Tensor, idx: torch.Tensor, length: int) -> Payload:
        """Register passthrough: the COO payload is the fused pipeline's
        output, so no dense ``[L]`` intermediate is touched."""
        return self.encode(vals, idx, length)

    def decode(self, payload: Payload, length: int) -> Tuple[torch.Tensor, torch.Tensor]:
        return payload["vals"], payload["idx"].long()

    def decoded_dense(self, payload: Payload, length: int) -> torch.Tensor:
        """``[W, L]``: each worker's payload scattered into its dense
        vector, what the receiver reconstructs. Padding slots ``(±0.0,
        index 0)`` add nothing (see ``repro_torch.comm.collectives``)."""
        vals, idx = self.decode(payload, length)
        dense = torch.zeros(
            (vals.shape[0], length), dtype=vals.dtype, device=vals.device
        )
        return dense.scatter_add_(1, idx, vals)

    def wire_bits(self, length: int, k: int) -> int:
        return 32 * k + 32 * k


CODECS = {CooFp32.name: CooFp32()}


def get_codec(name: str) -> CooFp32:
    try:
        return CODECS[name]
    except KeyError:
        raise ValueError(
            f"codec {name!r} is not ported; the port has {sorted(CODECS)}"
        ) from None
