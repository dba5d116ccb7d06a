"""Checkpoint store in the JAX package's format (counterpart of
``repro.checkpoint.store``): a directory with the leaves in
``arrays.npz`` and the tree's description in ``meta.msgpack``.

* ``arrays.npz`` holds ``a0 … an`` in ``jax.tree.flatten`` order: dicts
  by sorted key, tuples, lists and NamedTuples by position, ``None`` as no
  leaf. A bfloat16 leaf is stored as its ``uint16`` view;
* ``meta.msgpack`` is one map: ``treedef`` (the tree's ``PyTreeDef``
  string, for inspection), ``n_leaves``, ``kinds`` (each leaf's dtype
  name) and ``user`` (the caller's metadata).

The ``msgpack`` package is not a dependency of the port, so that one map
is encoded and decoded by :func:`packb` and :func:`unpackb`, which write
what ``msgpack.packb`` writes and read what it reads for str, int, float,
bool, None, list and dict. A checkpoint written here restores in the JAX
package and the reverse; ``restore`` checks each leaf's shape against a
donor tree and casts to the donor's dtype and device, as JAX's does.
"""
from __future__ import annotations

import os
import struct
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# msgpack, the subset the metadata map uses
# ---------------------------------------------------------------------------


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_pack_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        n = len(raw)
        if n < 32:
            out.append(bytes([0xA0 | n]))
        elif n < 1 << 8:
            out.append(b"\xd9" + struct.pack(">B", n))
        elif n < 1 << 16:
            out.append(b"\xda" + struct.pack(">H", n))
        else:
            out.append(b"\xdb" + struct.pack(">I", n))
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        out.append(_container_head(len(obj), 0x90, b"\xdc", b"\xdd"))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        out.append(_container_head(len(obj), 0x80, b"\xde", b"\xdf"))
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__!r} to msgpack")


def _pack_int(x: int) -> bytes:
    if 0 <= x < 1 << 7:
        return bytes([x])
    if -32 <= x < 0:
        return struct.pack(">b", x)
    if x >= 0:
        for code, fmt, bits in ((0xCC, ">B", 8), (0xCD, ">H", 16),
                                (0xCE, ">I", 32), (0xCF, ">Q", 64)):
            if x < 1 << bits:
                return bytes([code]) + struct.pack(fmt, x)
    else:
        for code, fmt, bits in ((0xD0, ">b", 8), (0xD1, ">h", 16),
                                (0xD2, ">i", 32), (0xD3, ">q", 64)):
            if x >= -(1 << (bits - 1)):
                return bytes([code]) + struct.pack(fmt, x)
    raise OverflowError(f"integer {x} does not fit in 64 bits")


def _container_head(n: int, fix: int, head16: bytes, head32: bytes) -> bytes:
    if n < 16:
        return bytes([fix | n])
    if n < 1 << 16:
        return head16 + struct.pack(">H", n)
    return head32 + struct.pack(">I", n)


def packb(obj: Any) -> bytes:
    """``obj`` (str, int, float, bool, None, list, tuple, dict) encoded as
    ``msgpack.packb`` encodes it: the smallest integer format, floats as
    float64, strings as UTF-8 str, tuples as arrays.

    >>> packb({"step": 5}).hex()
    '81a47374657005'
    """
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


# type byte -> (struct format, bytes) of a number
_FIXED = {
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
# type byte -> (struct format, bytes) of the size of a str, bin, array or map
_SIZED = {
    0xD9: (">B", 1), 0xDA: (">H", 2), 0xDB: (">I", 4),
    0xC4: (">B", 1), 0xC5: (">H", 2), 0xC6: (">I", 4),
    0xDC: (">H", 2), 0xDD: (">I", 4), 0xDE: (">H", 2), 0xDF: (">I", 4),
}


def _unpack(buf: bytes, i: int) -> Tuple[Any, int]:
    code = buf[i]
    i += 1
    if code < 0x80:
        return code, i
    if code >= 0xE0:
        return code - 0x100, i
    if 0xA0 <= code <= 0xBF:
        return _str(buf, i, code & 0x1F)
    if 0x90 <= code <= 0x9F:
        return _array(buf, i, code & 0x0F)
    if 0x80 <= code <= 0x8F:
        return _map(buf, i, code & 0x0F)
    if code == 0xC0:
        return None, i
    if code in (0xC2, 0xC3):
        return code == 0xC3, i
    if code in _FIXED:
        fmt, n = _FIXED[code]
        return struct.unpack_from(fmt, buf, i)[0], i + n
    if code in _SIZED:
        fmt, n = _SIZED[code]
        size = struct.unpack_from(fmt, buf, i)[0]
        i += n
        if code in (0xD9, 0xDA, 0xDB):
            return _str(buf, i, size)
        if code in (0xC4, 0xC5, 0xC6):
            return bytes(buf[i:i + size]), i + size
        if code in (0xDC, 0xDD):
            return _array(buf, i, size)
        return _map(buf, i, size)
    raise ValueError(f"unsupported msgpack type byte 0x{code:02x}")


def _str(buf: bytes, i: int, n: int) -> Tuple[str, int]:
    return bytes(buf[i:i + n]).decode("utf-8"), i + n


def _array(buf: bytes, i: int, n: int) -> Tuple[list, int]:
    out = []
    for _ in range(n):
        x, i = _unpack(buf, i)
        out.append(x)
    return out, i


def _map(buf: bytes, i: int, n: int) -> Tuple[dict, int]:
    out = {}
    for _ in range(n):
        key, i = _unpack(buf, i)
        out[key], i = _unpack(buf, i)
    return out, i


def unpackb(buf: bytes) -> Any:
    """The object ``buf`` encodes, as ``msgpack.unpackb`` returns it
    (arrays as lists, str as str).

    >>> unpackb(packb({"user": {"step": 7}, "n_leaves": 3}))
    {'user': {'step': 7}, 'n_leaves': 3}
    """
    obj, end = _unpack(buf, 0)
    if end != len(buf):
        raise ValueError(f"{len(buf) - end} trailing bytes after the msgpack object")
    return obj


# ---------------------------------------------------------------------------
# trees, in jax.tree.flatten's order
# ---------------------------------------------------------------------------


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_flatten(tree: Any) -> Tuple[List[Any], str]:
    """``(leaves, treedef string)`` as ``jax.tree.flatten`` gives them and
    ``str(treedef)`` prints them: dicts by sorted key, tuples, lists and
    NamedTuples by position, ``None`` an empty node.

    >>> leaves, treedef = tree_flatten({"b": (1, None), "a": [2]})
    >>> leaves, treedef
    ([2, 1], "PyTreeDef({'a': [*], 'b': (*, None)})")
    """
    leaves: List[Any] = []
    return leaves, f"PyTreeDef({_flatten(tree, leaves)})"


def _flatten(x: Any, leaves: List[Any]) -> str:
    if x is None:
        return "None"
    if isinstance(x, dict):
        inner = ", ".join(f"{k!r}: {_flatten(x[k], leaves)}" for k in sorted(x))
        return "{" + inner + "}"
    if _is_namedtuple(x):
        inner = ", ".join(_flatten(c, leaves) for c in x)
        return f"CustomNode(namedtuple[{type(x).__name__}], [{inner}])"
    if isinstance(x, tuple):
        inner = ", ".join(_flatten(c, leaves) for c in x)
        return f"({inner},)" if len(x) == 1 else f"({inner})"
    if isinstance(x, list):
        return "[" + ", ".join(_flatten(c, leaves) for c in x) + "]"
    leaves.append(x)
    return "*"


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """The tree shaped like ``like`` with ``leaves`` in its flatten
    order."""
    it = iter(leaves)
    out = _rebuild(like, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def _rebuild(x: Any, it) -> Any:
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _rebuild(x[k], it) for k in sorted(x)}
    if _is_namedtuple(x):
        return type(x)(*(_rebuild(c, it) for c in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_rebuild(c, it) for c in x)
    return next(it)


# ---------------------------------------------------------------------------
# save / restore
# ---------------------------------------------------------------------------


def _to_numpy(leaf: Any) -> Tuple[np.ndarray, str]:
    """A leaf as the array ``arrays.npz`` holds and its dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(path: str, tree: Any, *, metadata: Optional[dict] = None) -> None:
    """Write ``tree`` (leaves torch tensors or numpy arrays) to the
    directory ``path`` with the caller's ``metadata``."""
    os.makedirs(path, exist_ok=True)
    leaves, treedef = tree_flatten(tree)
    arrays, kinds = {}, []
    for i, leaf in enumerate(leaves):
        arrays[f"a{i}"], kind = _to_numpy(leaf)
        kinds.append(kind)
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    meta = {"treedef": treedef, "n_leaves": len(leaves), "kinds": kinds,
            "user": metadata or {}}
    with open(os.path.join(path, "meta.msgpack"), "wb") as f:
        f.write(packb(meta))


def _meta(path: str) -> dict:
    with open(os.path.join(path, "meta.msgpack"), "rb") as f:
        return unpackb(f.read())


def restore(path: str, donor: Any) -> Any:
    """The tree at ``path`` in the structure of ``donor``: each leaf of
    the donor's shape (else ValueError), cast to the donor leaf's dtype and
    placed on its device."""
    meta = _meta(path)
    flat, _ = tree_flatten(donor)
    if meta["n_leaves"] != len(flat):
        raise ValueError(
            f"checkpoint has {meta['n_leaves']} leaves, donor has {len(flat)}"
        )
    out = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, (d, kind) in enumerate(zip(flat, meta["kinds"], strict=True)):
            arr = data[f"a{i}"]
            x = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
                 if kind == "bfloat16" else torch.from_numpy(np.array(arr)))
            if tuple(x.shape) != tuple(d.shape):
                raise ValueError(
                    f"leaf {i}: checkpoint shape {tuple(x.shape)} != donor "
                    f"{tuple(d.shape)}"
                )
            out.append(x.to(device=d.device, dtype=d.dtype))
    return tree_unflatten(donor, out)


def metadata(path: str) -> dict:
    """The caller's metadata saved with the tree at ``path``."""
    return _meta(path)["user"]
