"""The port's configs and model registry against the JAX package's.

Every config the port trains, and its ``smoke_variant()``, must equal the
JAX config field for field (exactly: they are Python values), with the
same derived properties; ``ARCHS`` is the JAX package's list in its
order, and the input shapes and the long-context set are the JAX
package's. ``get_family`` maps every family to the module the JAX
registry maps it to (``lm``, ``encdec``, ``ssm``) and refuses an unknown
one; ``input_specs`` gives the JAX shapes and dtype kinds.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import registry as jregistry
from repro_torch import configs as tconfigs
from repro_torch.models import encdec, get_family, input_specs, lm, make_batch, ssm
import _torch_cores  # noqa: F401  (this worker's share of the cores)

ARCHS = list(tconfigs.ARCHS)
PROPERTIES = ("hd", "d_inner", "padded_vocab", "is_moe", "eff_heads",
              "eff_kv_heads")


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _same_config(t, j):
    assert list(_fields(t)) == list(_fields(j))
    assert _fields(t) == _fields(j)
    for name in PROPERTIES:
        assert getattr(t, name) == getattr(j, name), name
    assert str(t.torch_dtype).split(".")[-1] == np.dtype(j.jdtype).name


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_jax_field_for_field(arch):
    _same_config(tconfigs.get_config(arch), jconfigs.get_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_variant_equals_jax_field_for_field(arch):
    _same_config(tconfigs.get_config(arch).smoke_variant(),
                 jconfigs.get_config(arch).smoke_variant())


def test_smoke_variant_branches_match_jax():
    """The branches on configs built from fields (SSM, enc-dec, hybrid, no
    d_ff, heads that do not divide), beside the configs' own."""
    from repro.models.config import ModelConfig as J
    from repro_torch.models.config import ModelConfig as T

    for kw in (dict(family="ssm", ssm_state=128, d_ff=0),
               dict(family="hybrid", ssm_state=64, n_heads=6, n_kv_heads=6),
               dict(family="encdec", n_enc_layers=4, enc_seq=1500),
               dict(n_heads=3, n_kv_heads=3, pad_heads=8),
               dict(family="moe", n_experts=8, moe_top_k=2,
                    n_shared_experts=1)):
        _same_config(T(**kw).smoke_variant(), J(**kw).smoke_variant())


def test_archs_order_and_shapes_match_jax():
    assert ARCHS == [a for a in jconfigs.ARCHS if a in tconfigs.ARCHS]
    assert set(jconfigs.ARCHS) - set(ARCHS) == set()
    assert ARCHS == list(jconfigs.ARCHS)
    assert tconfigs.INPUT_SHAPES == jconfigs.INPUT_SHAPES
    assert tconfigs.LONG_CONTEXT_OK == jconfigs.LONG_CONTEXT_OK
    for arch in jconfigs.ARCHS:
        for shape in jconfigs.INPUT_SHAPES:
            assert (tconfigs.shape_applicable(arch, shape)
                    == jconfigs.shape_applicable(arch, shape))
    assert tconfigs.get_config("whisper-tiny").family == "encdec"
    with pytest.raises(ValueError, match="unknown arch"):
        tconfigs.get_config("no-such-arch")


@pytest.mark.parametrize("family", ["dense", "moe", "vlm", "encdec", "ssm",
                                    "hybrid", "rnn"])
def test_get_family(family):
    cfg = tconfigs.get_config("paper-resnet-proxy").replace(family=family)
    if family == "rnn":
        with pytest.raises(ValueError, match="unknown family"):
            get_family(cfg)
        with pytest.raises(ValueError, match="unknown family"):
            jregistry.get_family(cfg)
        return
    want = {"dense": lm, "moe": lm, "vlm": lm, "encdec": encdec, "ssm": ssm,
            "hybrid": ssm}[family]
    assert get_family(cfg) is want
    assert (jregistry.get_family(cfg).__name__
            == want.__name__.replace("repro_torch.", "repro."))


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "internvl2-1b",
                                  "deepseek-moe-16b", "whisper-tiny"])
@pytest.mark.parametrize("kind", ["train", "decode"])
def test_input_specs_match_jax(arch, kind):
    cfg = tconfigs.get_config(arch)
    got = input_specs(cfg, 4, 32, kind=kind)
    want = jregistry.input_specs(jconfigs.get_config(arch), 4, 32, kind=kind)
    assert list(got) == list(want)
    for name, (shape, dtype) in got.items():
        assert shape == tuple(want[name].shape), name
        assert dtype.is_floating_point == jax.numpy.issubdtype(
            want[name].dtype, jax.numpy.floating), name
    if kind == "train":
        batch = make_batch(cfg.smoke_variant(), 2, 8, device="cpu")
        specs = input_specs(cfg.smoke_variant(), 2, 8)
        assert {k: (tuple(v.shape), v.dtype) for k, v in batch.items()} == specs
        assert int(batch["tokens"].max()) < cfg.smoke_variant().vocab
        assert torch.equal(batch["tokens"], make_batch(
            cfg.smoke_variant(), 2, 8, torch.Generator().manual_seed(0),
            device="cpu")["tokens"])
