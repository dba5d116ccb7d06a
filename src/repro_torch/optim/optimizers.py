"""SGD, SGD with momentum and Adam, ported by hand from
``repro.optim.optimizers``.

``torch.optim.Adam`` is not used: it orders the bias correction and eps
differently (it folds the correction into the step size and adds eps to
``sqrt(v) / sqrt(bc2)``), so its updates would not match the JAX
package's ``lr * (m / bc1) / (sqrt(v / bc2) + eps)``. Workers run the
optimizer on the common aggregated gradient, so its state is identical
across workers and the update is computed once (paper Sec. 5.3).

Every kind clips by the global norm when ``grad_clip`` is set and warms
the learning rate up linearly over ``warmup_steps``; Adam alone applies
``weight_decay`` (decoupled, ``lr * wd * p``) and keeps its moments in
``moment_dtype``.

On a rank that holds its model shard's block of some leaves (tensor
parallelism, ``core.distributed``), every update is elementwise, so it
runs on the blocks as they are and equals the JAX package's sharded
update element by element; only the clip's norm needs the whole tree:
``make_optimizer(cfg, split=(group, flags))`` sums the squares of the
flagged leaves over the model ``group`` and counts each whole leaf once.

The arithmetic is the jitted JAX update's, rounding for rounding:

* the warmup's ``(step + 1) / warmup_steps`` divides by a constant, so it
  is the product with ``fl(1/warmup_steps)`` (``const_div``); the clip's
  ``max_norm / max(norm, 1e-9)`` divides by a computed norm, a true
  division in both;
* XLA contracts each ``a * b + c`` of the update into one fused
  multiply-add (the moments, the momentum, ``p - lr * g``, the weight
  decay term); the port computes those with ``torch.addcmul``, which
  rounds once on the CPU and on the card (:func:`_fma`);
* the square root is correctly rounded, which PyTorch's vectorised CPU
  ``sqrt`` is not in every last bit (:func:`_sqrt`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.regtopk_score import const_div
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adam"  # sgd | momentum | adam
    learning_rate: float = 1e-3
    momentum: float = 0.9
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: Optional[float] = None
    moment_dtype: str = "float32"  # "bfloat16" halves Adam's state
    # linear warmup over the first warmup_steps steps, then constant
    warmup_steps: int = 0


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]  # (grads, state, params)


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once, as XLA:CPU contracts it under ``jit``;
    ``b`` a tensor or a Python scalar (taken in float32)."""
    if not isinstance(b, torch.Tensor):
        b = torch.full((), b, dtype=torch.float32, device=a.device)
    return torch.addcmul(c, a, b)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (through float64)."""
    return torch.sqrt(x.double()).float()


def _lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate of the step after ``step`` updates (an int32
    scalar): ``lr * min(1, (step + 1) / warmup_steps)`` under warmup."""
    lr = torch.full((), cfg.learning_rate, device=step.device)
    if cfg.warmup_steps > 0:
        warm = torch.clamp(const_div((step + 1).float(), float(cfg.warmup_steps)),
                           max=1.0)
        lr = lr * warm
    return lr


def _clip(grads, max_norm: Optional[float], split=None):
    """``grads`` scaled by ``min(1, max_norm / max(||grads||, 1e-9))``,
    the global f32 norm summed leaf by leaf in tree order. ``split``
    ``(group, flags)`` flags, in tree order, the leaves that are this
    rank's blocks: their sums of squares are summed over the model
    ``group`` (one all-reduce), a whole leaf's taken once."""
    if max_norm is None:
        return grads
    sums = [torch.sum(torch.square(g.float())) for g in tree_leaves(grads)]
    if split is not None:
        from repro_torch.comm.collectives import _psum

        group, flags = split
        local = torch.stack(sums)
        mine = torch.tensor(flags, device=local.device)
        total = _psum(torch.where(mine, local, 0.0), (group,))
        sums = torch.where(mine, total, local).unbind(0)
    sq = None
    for s in sums:
        sq = s if sq is None else sq + s
    gn = torch.sqrt(sq)
    scale = torch.clamp(
        torch.full_like(gn, max_norm) / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads)


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def sgd(cfg: OptConfig, split=None) -> Optimizer:
    def init(params):
        return {"step": _step0(params)}

    @torch.no_grad()
    def update(grads, state, params):
        grads = _clip(grads, cfg.grad_clip, split)
        lr = _lr_at(cfg, state["step"])
        new_params = tree_map(lambda p, g: _fma(-lr, g.float(), p), params, grads)
        return new_params, {"step": state["step"] + 1}

    return Optimizer(init, update)


def sgd_momentum(cfg: OptConfig, split=None) -> Optimizer:
    def init(params):
        return {"step": _step0(params),
                "mom": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                                params)}

    @torch.no_grad()
    def update(grads, state, params):
        grads = _clip(grads, cfg.grad_clip, split)
        lr = _lr_at(cfg, state["step"])
        mom = tree_map(lambda m, g: _fma(m, cfg.momentum, g.float()),
                       state["mom"], grads)
        new_params = tree_map(lambda p, m: _fma(-lr, m, p), params, mom)
        return new_params, {"step": state["step"] + 1, "mom": mom}

    return Optimizer(init, update)


_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _moment(prev: torch.Tensor, beta: float, x: torch.Tensor) -> torch.Tensor:
    """``beta * prev + (1 - beta) * x`` in f32, stored in ``prev``'s dtype.
    XLA contracts the product with ``prev`` into the multiply-add for f32
    moments, and the other product for bf16 moments (``prev`` widened
    from bf16)."""
    if prev.dtype == torch.float32:
        return _fma(prev, beta, (1 - beta) * x)
    return _fma(x, 1 - beta, beta * prev.float()).to(prev.dtype)


def adam(cfg: OptConfig, split=None) -> Optimizer:
    # any name but "bfloat16" keeps f32 moments, as in the JAX package
    mdt = _MOMENT_DTYPES.get(cfg.moment_dtype, torch.float32)

    def init(params):
        return {
            "step": _step0(params),
            "m": tree_map(lambda p: torch.zeros_like(p, dtype=mdt), params),
            "v": tree_map(lambda p: torch.zeros_like(p, dtype=mdt), params),
        }

    @torch.no_grad()
    def update(grads, state, params):
        grads = _clip(grads, cfg.grad_clip, split)
        step = state["step"] + 1
        stepf = step.float()
        lr = _lr_at(cfg, state["step"])
        m = tree_map(lambda m_, g: _moment(m_, cfg.b1, g.float()),
                     state["m"], grads)
        v = tree_map(lambda v_, g: _moment(v_, cfg.b2, g.float().square()),
                     state["v"], grads)
        bc1 = 1 - torch.pow(torch.full_like(stepf, cfg.b1), stepf)
        bc2 = 1 - torch.pow(torch.full_like(stepf, cfg.b2), stepf)

        def upd(p, m_, v_):
            mh = m_.float() / bc1
            vh = v_.float() / bc2
            delta = lr * mh / (_sqrt(vh) + cfg.eps)
            if cfg.weight_decay:
                delta = _fma(lr * cfg.weight_decay, p.float(), delta)
            return p - delta.to(p.dtype)

        new_params = tree_map(upd, params, m, v)
        return new_params, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


_KINDS = {"sgd": sgd, "momentum": sgd_momentum, "adam": adam}


def make_optimizer(cfg: OptConfig, split=None) -> Optimizer:
    """The optimizer of ``cfg.kind``; ``split`` ``(model group, flags in
    tree order)`` on a rank that holds blocks of the flagged leaves."""
    try:
        return _KINDS[cfg.kind](cfg, split)
    except KeyError:
        raise ValueError(
            f"unknown optimizer {cfg.kind!r}; available: {sorted(_KINDS)}"
        ) from None
