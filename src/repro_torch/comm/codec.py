"""Wire codecs (counterpart of ``repro.comm.codec``): interchangeable
payload encodings with exact bit accounting.

A codec turns the sparsifier's fixed-k payload ``(vals, idx)`` over a
length-``L`` flat gradient into a dict of tensors whose shapes and dtypes
are functions of ``(L, k)`` alone, and back. The port keeps the worker
axis that the JAX package vmaps over: every buffer has a leading ``[W]``
axis (``vals [W, k]``, ``bitmap [W, ceil(L/8)]``, ``coo_q8``'s ``scale
[W]``). ``decode`` returns int64 indices, torch's indexing type.

* ``coo_fp32``      — fp32 values + int32 indices, 64 bits a coordinate;
* ``coo_idx_delta`` — indices sorted ascending and delta-encoded in the
  narrowest integer that every index below ``L`` fits (int8 for L < 2^7,
  int16 for L < 2^15, else int32). Lossless;
* ``bitmap_dense``  — a 1-bit presence bitmap (uint8, little-endian bit
  order) + the values in index-ascending order: ``L + 32·k`` bits;
* ``coo_q8``        — int8 values with one symmetric f32 scale a payload +
  int32 indices. Lossy: the caller folds the decode residual back into
  the error (``Sparsifier.on_wire_residual``, ``compact_finalize_sent``).
  The port quantizes in f32 whatever the input dtype; the JAX package
  quantizes in the input dtype, which breaks its error bound in bf16.

Round-trip contract: for a lossless codec, the scatter-add of the decoded
payload equals that of the encoded one exactly (decode may reorder
coordinates and merge the ``(+0.0, index 0)`` padding slots).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.regtopk_score import ieee_div

Payload = Dict[str, torch.Tensor]


class Codec:
    """Base codec. Subclasses set ``name``/``lossless`` and implement
    ``encode``/``decode``/``wire_bits``; a codec whose encoding reads only
    the k selected ``(vals, idx)`` also implements :meth:`encode_fused`
    and sets ``supports_fused``, so the fused select→encode path emits
    its payload with no dense intermediate."""

    name: str = "base"
    lossless: bool = True
    supports_fused: bool = False

    def encode(self, vals: torch.Tensor, idx: torch.Tensor, length: int) -> Payload:
        raise NotImplementedError

    def encode_fused(self, vals: torch.Tensor, idx: torch.Tensor, length: int) -> Payload:
        """Encode straight from the fused pipeline's ``(vals [W, k], idx
        [W, k])``: the same payload as ``encode``, touching no dense
        ``[W, L]`` tensor."""
        raise NotImplementedError(
            f"codec {self.name!r} has no fused encode epilogue"
        )

    def decode(self, payload: Payload, length: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns ``(vals [W, k], idx [W, k] int64)``; padding slots
        decode to ``(0, 0)``."""
        raise NotImplementedError

    def wire_bits(self, length: int, k: int) -> int:
        """Exact size of one worker's payload in bits."""
        raise NotImplementedError

    def decoded_dense(self, payload: Payload, length: int) -> torch.Tensor:
        """``[W, L]``: each worker's payload scattered into its dense
        vector, what the receiver reconstructs. Padding slots ``(+0.0,
        index 0)`` add nothing (see ``repro_torch.comm.collectives``)."""
        vals, idx = self.decode(payload, length)
        dense = torch.zeros(
            (vals.shape[0], length), dtype=vals.dtype, device=vals.device
        )
        return dense.scatter_add_(1, idx, vals)


class CooFp32(Codec):
    """fp32 values + int32 indices — the uncompressed-index baseline."""

    name = "coo_fp32"
    lossless = True
    supports_fused = True

    def encode(self, vals, idx, length):
        return {"vals": vals.float(), "idx": idx.int()}

    def encode_fused(self, vals, idx, length):
        """Register passthrough: the COO payload is the fused pipeline's
        output."""
        return self.encode(vals, idx, length)

    def decode(self, payload, length):
        return payload["vals"], payload["idx"].long()

    def wire_bits(self, length, k):
        return 32 * k + 32 * k


def delta_index_dtype(length: int) -> torch.dtype:
    """Dtype of the sorted-index deltas: every delta, and the leading
    absolute index, is below ``length``.

    >>> delta_index_dtype(100), delta_index_dtype(1 << 14), delta_index_dtype(1 << 20)
    (torch.int8, torch.int16, torch.int32)
    """
    if length < 2**7:
        return torch.int8
    if length < 2**15:
        return torch.int16
    return torch.int32


class CooIdxDelta(Codec):
    """Sorted indices, delta-encoded in the narrowest safe integer."""

    name = "coo_idx_delta"
    lossless = True
    supports_fused = True

    def encode_fused(self, vals, idx, length):
        """A k-sized sort and difference of the selected entries."""
        return self.encode(vals, idx, length)

    def encode(self, vals, idx, length):
        # stable, as jnp.argsort: padding slots repeat index 0, and an
        # unstable sort would reorder their value bits
        si, order = torch.sort(idx, dim=-1, stable=True)
        sv = torch.gather(vals, -1, order).float()
        si = si.int()
        deltas = torch.cat([si[:, :1], torch.diff(si, dim=-1)], dim=-1)
        return {"vals": sv, "deltas": deltas.to(delta_index_dtype(length))}

    def decode(self, payload, length):
        idx = torch.cumsum(payload["deltas"].to(torch.int32), dim=-1)
        return payload["vals"], idx.long()

    def wire_bits(self, length, k):
        return 32 * k + 8 * delta_index_dtype(length).itemsize * k


def _pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """{0, 1} mask ``[W, L]`` → packed uint8 ``[W, ceil(L/8)]``, bit ``i``
    of byte ``b`` for element ``8 b + i`` (little-endian bit order)."""
    W, L = mask.shape
    m = F.pad(mask.to(torch.uint8), (0, (-L) % 8)).reshape(W, -1, 8)
    weights = 2 ** torch.arange(8, dtype=torch.uint8, device=mask.device)
    return (m * weights).sum(dim=-1).to(torch.uint8)


def _unpack_bits(packed: torch.Tensor, length: int) -> torch.Tensor:
    """Packed uint8 ``[W, ceil(L/8)]`` → f32 {0, 1} mask ``[W, L]``."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(packed.shape[0], -1)[:, :length].float()


def _ranked(mask: torch.Tensor):
    """(rows, ranks, columns) of the set entries of a ``[W, L]`` mask,
    row-major: the rank of an entry is its position among its row's set
    entries. Only set entries are returned, so a scatter to their ranks
    touches no slot past the row's count, the slots that the JAX package
    drops with ``mode="drop"``."""
    live = mask > 0
    rank = torch.cumsum(live.int(), dim=-1) - 1
    rows, cols = torch.nonzero(live, as_tuple=True)
    return rows, rank[rows, cols].long(), cols


class BitmapDense(Codec):
    """1-bit presence bitmap + values in index-ascending order.

    ``L + 32·k`` bits: smaller than COO's index list when S = k/L > 1/32.
    Duplicate padding slots (index 0, value 0) merge into the bitmap; the
    values are stored index-ascending, so decode returns coordinates in
    ascending order."""

    name = "bitmap_dense"
    lossless = True
    supports_fused = False  # the wire format is the dense bitmap itself

    def encode(self, vals, idx, length):
        W, k = vals.shape
        dense = torch.zeros((W, length), device=vals.device).scatter_add_(
            1, idx, vals.float()
        )
        mask = torch.zeros((W, length), device=vals.device).scatter_(1, idx, 1.0)
        rows, ranks, cols = _ranked(mask)
        packed = torch.zeros((W, k), device=vals.device)
        packed[rows, ranks] = dense[rows, cols]
        return {"bitmap": _pack_bits(mask), "vals": packed}

    def decode(self, payload, length):
        vals = payload["vals"]
        W, k = vals.shape
        mask = _unpack_bits(payload["bitmap"], length)
        rows, ranks, cols = _ranked(mask)
        idx = torch.zeros((W, k), dtype=torch.int64, device=vals.device)
        idx[rows, ranks] = cols
        valid = torch.arange(k, device=vals.device) < mask.sum(dim=-1, keepdim=True)
        return torch.where(valid, vals, 0.0), torch.where(valid, idx, 0)

    def wire_bits(self, length, k):
        return 8 * ((length + 7) // 8) + 32 * k


class CooQ8(Codec):
    """int8 symmetric quantization of the values; indices stay int32.

    Lossy: ``decode`` dequantizes with each payload's f32 scale, and the
    caller folds ``decoded - intended`` back into the error so error
    feedback covers the codec."""

    name = "coo_q8"
    lossless = False
    supports_fused = True

    def encode(self, vals, idx, length):
        # in f32 whatever the input dtype, and with true divisions (CUDA
        # multiplies by the reciprocal when dividing by a Python scalar);
        # torch.round, like jnp.round, rounds half to even
        v = vals.float()
        amax = v.abs().amax(dim=-1, keepdim=True)
        scale = torch.where(amax > 0, ieee_div(amax, 127.0), 1.0)
        q = torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)
        return {"q": q, "scale": scale[:, 0], "idx": idx.int()}

    def encode_fused(self, vals, idx, length):
        """The amax, scale and rounding read only the k selected
        entries."""
        return self.encode(vals, idx, length)

    def decode(self, payload, length):
        vals = payload["q"].float() * payload["scale"][:, None]
        return vals, payload["idx"].long()

    def wire_bits(self, length, k):
        return 8 * k + 32 + 32 * k


CODECS = {
    c.name: c for c in (CooFp32(), CooIdxDelta(), BitmapDense(), CooQ8())
}


def get_codec(name: str) -> Codec:
    """Look up a codec by name.

    >>> get_codec("bitmap_dense").wire_bits(1024, 16)  # L + 32·k bits
    1536
    >>> get_codec("bogus")
    Traceback (most recent call last):
        ...
    ValueError: unknown codec 'bogus'; available: ['bitmap_dense', \
'coo_fp32', 'coo_idx_delta', 'coo_q8']
    """
    try:
        return CODECS[name]
    except KeyError:
        raise ValueError(
            f"unknown codec {name!r}; available: {sorted(CODECS)}"
        ) from None
