"""The port's dense LM against ``repro.models.lm`` on shared weights.

Weights come from the JAX package's ``init`` and cross by
``repro_torch.convert.params_from_jax``; the batch is numpy. Loss and
every gradient leaf agree to rtol 1e-5 (float32 matmuls sum in another
order in XLA:CPU and PyTorch); a gradient leaf's absolute tolerance is
1e-5 of its largest magnitude, for entries that cancel to near zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import lm as tlm
from repro_torch.tree import tree_items

RTOL = 1e-5


def _batch(cfg, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
    }


def test_smoke_variant_matches_jax_config():
    j = jax_get_config("paper-resnet-proxy").smoke_variant()
    t = tconfigs.get_config("paper-resnet-proxy").smoke_variant()
    for name in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                 "vocab", "hd", "padded_vocab"):
        assert getattr(t, name) == getattr(j, name), name
    with pytest.raises(ValueError, match="unknown arch"):
        tconfigs.get_config("mixtral-8x7b")


def test_init_shapes_match_jax():
    jcfg = jax_get_config("paper-resnet-proxy")
    jp = jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(0), jcfg)[0])
    tp = tlm.init(tconfigs.get_config("paper-resnet-proxy"), device="cpu")
    jitems = dict(tree_items(jp))
    titems = dict(tree_items(tp))
    assert sorted(jitems) == sorted(titems)
    for path, leaf in titems.items():
        assert tuple(leaf.shape) == tuple(jitems[path].shape), path


def test_loss_and_grads_match_jax():
    jcfg = jax_get_config("paper-resnet-proxy").smoke_variant()
    tcfg = tconfigs.get_config("paper-resnet-proxy").smoke_variant()
    jparams, _ = jlm.init(jax.random.PRNGKey(1), jcfg)
    np_params = jax.tree.map(np.asarray, jparams)
    batch = _batch(jcfg)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})[0]
    )(jparams)

    tparams = convert.params_from_jax(np_params, device="cpu")
    live = {
        path: leaf.requires_grad_(True) for path, leaf in tree_items(tparams)
    }
    tbatch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    tloss, _ = tlm.loss_fn(tparams, tcfg, tbatch)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=RTOL)
    for path, want in tree_items(jax.tree.map(np.asarray, jgrads)):
        got = live[path].grad.numpy()
        np.testing.assert_allclose(
            got, want, rtol=RTOL, atol=RTOL * np.abs(want).max(), err_msg=path
        )


def test_params_roundtrip():
    tp = tlm.init(tconfigs.get_config("paper-resnet-proxy").smoke_variant(),
                  seed=3, device="cpu")
    back = convert.params_from_jax(convert.params_to_numpy(tp), device="cpu")
    for (pa, a), (pb, b) in zip(tree_items(tp), tree_items(back), strict=True):
        assert pa == pb and torch.equal(a, b)
