"""Per-call cost of eager PyTorch on the meta device (counterpart of
``repro.launch.hlo_cost``).

The JAX package compiles a step and walks its HLO text, multiplying each
``while`` body by its trip count. The port has no HLO and needs no trip
counts: its layer loops and microbatch loops run in Python, so one eager
call of the step sees every iteration's ops. :func:`analyze` runs the
call once under a dispatch trace, on meta tensors (nothing is allocated
on any device), and reports, with the JAX walker's keys:

* ``flops`` — the formulas of ``torch.utils.flop_counter`` (the
  ``FlopCounterMode`` registry: matrix products, attention and
  convolutions, 2 per multiply-add) applied to each op as it runs,
  except a convolution's backward: the registry treats a grouped
  (depthwise) weight as dense and counts 289 times too much for the SSD's
  conv, so it is counted here as the gradients it returns, each the
  forward's ``2 x output elements x C_in/groups x kernel width``. Ops are
  counted as dispatched, not decomposed further (``FlopCounterMode``
  decomposes ops outside its registry, which costs more time than the
  ops and finds no product in the models here);
* ``hbm_bytes`` — 2 x the bytes of every materialised op result (a
  read+write proxy, as the walker's), skipping views, ``copy_`` into a
  buffer and factories (``empty``, ``zeros``, ``full``, the ``*_like``
  ones). Eager PyTorch fuses nothing, so where XLA keeps a fusion's
  intermediates on chip this counts them: an upper bound of the walker's
  figure for the same step;
* ``collective_bytes`` — ``{"total": 0}``: no process group runs on the
  meta device; ``launch.dryrun`` fills it from the plan;
* ``peak_bytes`` (the port's own) — the most bytes of storage that the
  call's own results held alive at once; the caller adds what it held
  before the call;
* ``flops_by_op`` (the port's own) — ``flops`` by aten op.
"""
from __future__ import annotations

import math
import weakref
from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

# ops whose results are not materialised work: buffers made or filled
# without reading anything, and copies into a buffer
_NO_BYTES = {
    aten.empty, aten.empty_like, aten.empty_strided, aten.zeros,
    aten.zeros_like, aten.ones, aten.ones_like, aten.full, aten.full_like,
    aten.scalar_tensor, aten.new_empty, aten.new_zeros, aten.new_full,
    aten.new_ones, aten.zero_, aten.fill_, aten.copy_, aten.detach,
    aten.alias, aten.lift_fresh,
}


def _conv_backward_flop(grad_out, x, w, _bias, _stride, _padding, _dilation,
                        transposed, _output_padding, _groups, output_mask,
                        out_val=None) -> int:
    """Each gradient of a (grouped) convolution costs its forward's
    multiply-adds: every output element meets ``C_in/groups x kernel``
    inputs, the weight's dims after the first."""
    if transposed:
        raise NotImplementedError("a transposed convolution's backward")
    forward = 2 * grad_out.numel() * math.prod(w.shape[1:])
    return forward * (int(output_mask[0]) + int(output_mask[1]))


# op -> its count(*args, **kwargs, out_val=result)
_FLOPS = {**flop_registry, aten.convolution_backward: _conv_backward_flop}


class _Trace(TorchDispatchMode):
    """FLOPs, result bytes and live storage bytes of every op dispatched
    under it."""

    def __init__(self):
        super().__init__()
        self.flops: Dict[str, int] = {}
        self.result_bytes = 0
        self.live = 0
        self.peak = 0
        self._held: Dict[int, int] = {}

    def _release(self, key: int) -> None:
        self.live -= self._held.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        inputs = {id(t.untyped_storage())
                  for t in tree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor)}
        out = func(*args, **kwargs)
        count = _FLOPS.get(func.overloadpacket)
        if count is not None:
            name = str(func.overloadpacket)
            self.flops[name] = self.flops.get(name, 0) + int(
                count(*args, **kwargs, out_val=out))
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            if not func.is_view and func.overloadpacket not in _NO_BYTES:
                self.result_bytes += t.numel() * t.element_size()
            st = t.untyped_storage()
            key = id(st)
            if key in inputs or key in self._held:
                continue  # a view, an in-place result, or already counted
            self._held[key] = st.nbytes()
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._release, key)
        return out


def analyze(fn: Callable, *args, **kw) -> Dict[str, Any]:
    """Run ``fn(*args, **kw)`` once under the trace; returns the cost
    dict of the module docstring."""
    trace = _Trace()
    with trace:
        fn(*args, **kw)
    by_op = {op: n for op, n in trace.flops.items() if n}
    return {
        "flops": float(sum(by_op.values())),
        "hbm_bytes": 2.0 * trace.result_bytes,
        "collective_bytes": {"total": 0},
        "peak_bytes": trace.peak,
        "flops_by_op": by_op,
    }
