"""Family dispatch, input specs and synthetic batches (counterpart of
``repro.models.registry``).

Every family module exposes ``init(cfg, *, seed, device)``,
``param_axes(cfg)`` (the logical axes of ``init``'s tree, which the JAX
``init`` returns beside the parameters; :func:`param_axes` here),
``loss_fn(params, cfg, batch) -> (loss, metrics)``, ``prefill(params,
cfg, batch) -> logits``, ``init_cache(cfg, batch, max_len, *, device)``,
``cache_axes(cfg)`` and ``decode_step(params, cfg, cache, tokens) ->
(logits, cache)``. The ``dense``, ``moe`` and ``vlm`` families are
``models.lm``, ``encdec`` is ``models.encdec``, ``ssm`` and ``hybrid``
are ``models.ssm``.
"""
from __future__ import annotations

from types import ModuleType
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import encdec, lm, ssm
from repro_torch.models.config import ModelConfig

_FAMILIES: Dict[str, ModuleType] = {
    "dense": lm,
    "moe": lm,
    "vlm": lm,
    "encdec": encdec,
    "ssm": ssm,
    "hybrid": ssm,
}


def get_family(cfg: ModelConfig) -> ModuleType:
    """The module that trains ``cfg``'s family."""
    try:
        return _FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(
            f"unknown family {cfg.family!r}; available: {sorted(_FAMILIES)}"
        ) from None


def tensor_parallel(cfg: ModelConfig) -> bool:
    """Whether the trainer shards ``cfg``'s forward, parameters and Adam
    over the model axis: its family module lists the family in its
    ``TENSOR_PARALLEL`` (``models.lm``'s dense, MoE and VLM decoders,
    ``models.ssm``'s SSM and hybrid models, ``models.encdec``'s
    encoder-decoder: every family). A family left out of it keeps a whole
    forward, and the model axis splits its sparsify stage alone; no
    family is left out, but the mechanism stays, and the dry run's tests
    empty a module's ``TENSOR_PARALLEL`` to count that whole forward
    beside the sharded one."""
    return cfg.family in getattr(get_family(cfg), "TENSOR_PARALLEL", ())


def serve_parallel(cfg: ModelConfig) -> bool:
    """Whether the serve step (``prefill``, ``init_cache``,
    ``decode_step``) runs on a rank's blocks over the model axis: the
    family is in its module's ``SERVE_PARALLEL`` (``models.lm``'s dense,
    MoE and VLM decoders, ``models.ssm``'s SSM and hybrid models) and
    trains tensor parallel (:func:`tensor_parallel`). The encoder-decoder
    family serves whole, and its decode step refuses a shard."""
    return (tensor_parallel(cfg)
            and cfg.family in getattr(get_family(cfg), "SERVE_PARALLEL", ()))


def param_axes(cfg: ModelConfig) -> Dict:
    """The logical axes of ``cfg``'s parameter tree, nothing drawn: the
    tree ``repro.core.distributed.shapes_and_axes`` gives the JAX
    package's ``init``, which ``nn.sharding.tree_specs`` resolves on a
    mesh."""
    return get_family(cfg).param_axes(cfg)


def input_specs(cfg: ModelConfig, batch: int, seq: int, *, kind: str = "train"
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """``{input name: (shape, dtype)}`` of every model input (nothing
    allocated). ``kind`` is "train" (tokens, labels and the frontend
    stubs) or "decode" (one token)."""
    if kind == "decode":
        return {"tokens": ((batch, 1), torch.int64)}
    specs = {"tokens": ((batch, seq), torch.int64),
             "labels": ((batch, seq), torch.int64)}
    if cfg.family == "encdec":
        specs["frames"] = ((batch, cfg.enc_seq, cfg.d_model), cfg.torch_dtype)
    if cfg.family == "vlm":
        specs["patches"] = ((batch, cfg.n_patches, cfg.vision_dim),
                            cfg.torch_dtype)
    return specs


def make_batch(cfg: ModelConfig, batch: int, seq: int,
               gen: Optional[torch.Generator] = None, device="cuda") -> Dict:
    """A synthetic batch matching :func:`input_specs`, drawn on the host
    from ``gen`` (``torch.Generator().manual_seed(0)`` when None) and
    moved to ``device``."""
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    out = {}
    for name, (shape, dtype) in input_specs(cfg, batch, seq).items():
        if dtype == torch.int64:
            x = torch.randint(0, cfg.vocab, shape, generator=gen)
        else:
            x = torch.randn(shape, generator=gen).to(dtype)
        out[name] = x.to(device)
    return out
