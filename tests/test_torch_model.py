"""The port's models, every family through each package's registry
(``models.lm`` for the dense, MoE and VLM families, ``models.encdec`` and
``models.ssm``), against the JAX package's on shared weights.

Weights come from the JAX package's ``init`` and cross by
``repro_torch.convert.params_from_jax``; the batch (and the VLM patches
and the encoder-decoder frames) is numpy. The JAX side runs under
``jax.jit``, as its trainer does. For every config's ``smoke_variant()``,
the loss, ``nll``, ``aux`` and every gradient leaf agree to rtol 1e-5
(float32 matmuls sum in another order in XLA:CPU and PyTorch); a gradient
leaf's absolute tolerance is 1e-5 of its largest magnitude, for entries
that cancel to near zero. The SSD leaves ``mixer.A_log`` and
``mixer.dt_bias`` agree to rtol 1e-4 with the same kind of floor: their
gradients sum terms of both signs through ``exp(_segsum)``, and float32
lands up to 4e-5 of the largest magnitude from a float64 evaluation
(``tests/test_torch_ssd.py``). ``nll + coef * aux`` is one fused
multiply-add under ``jit``; the port's ``total_loss`` equals it in f32
bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import get_family as jax_get_family
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import get_family
from repro_torch.models import lm as tlm
from repro_torch.tree import tree_items, tree_leaves

RTOL = 1e-5
DECAY_RTOL = 1e-4  # the SSD's A_log and dt_bias gradients (module docstring)
ARCHS = list(tconfigs.ARCHS)


def _rtol(path):
    return DECAY_RTOL if path.endswith(("mixer.A_log", "mixer.dt_bias")) else RTOL


def _batch(cfg, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    batch = {
        "tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
    }
    if cfg.family == "vlm":
        batch["patches"] = (0.1 * rng.standard_normal(
            (B, cfg.n_patches, cfg.vision_dim))).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = (0.1 * rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model))).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def test_smoke_variant_matches_jax_config():
    j = jax_get_config("paper-resnet-proxy").smoke_variant()
    t = tconfigs.get_config("paper-resnet-proxy").smoke_variant()
    for name in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                 "vocab", "hd", "padded_vocab"):
        assert getattr(t, name) == getattr(j, name), name
    with pytest.raises(ValueError, match="unknown arch"):
        tconfigs.get_config("no-such-arch")
    with pytest.raises(ValueError, match="unknown arch"):
        jax_get_config("no-such-arch")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_shapes_match_jax(arch):
    """Every dotted tree path, in the JAX leaf order, with its shape."""
    jcfg = jax_get_config(arch)
    tcfg = tconfigs.get_config(arch)
    jp = jax.eval_shape(
        lambda: jax_get_family(jcfg).init(jax.random.PRNGKey(0), jcfg)[0])
    tp = get_family(tcfg).init(tcfg, device="meta")
    jpaths = [
        ".".join(k.key for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]
    ]
    titems = tree_items(tp)
    assert [path for path, _ in titems] == jpaths
    jitems = dict(tree_items(jp))
    for path, leaf in titems:
        assert tuple(leaf.shape) == tuple(jitems[path].shape), path
        assert leaf.dtype == torch.float32, path


# every arch's smoke variant; zamba2-7b also at 7 layers (two groups and a
# trailing block: the shared block's gradient sums two applications) with
# remat (each mamba block and each shared application recomputed), and
# whisper-tiny with remat (each encoder and decoder block)
CASES = {arch: {} for arch in ARCHS}
CASES["zamba2-7b:2groups-remat"] = dict(n_layers=7, remat=True)
CASES["whisper-tiny:remat"] = dict(remat=True)


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_match_jax(case):
    arch, fields = case.split(":")[0], CASES[case]
    jcfg = jax_get_config(arch).smoke_variant().replace(**fields)
    tcfg = tconfigs.get_config(arch).smoke_variant().replace(**fields)
    jmod, tmod = jax_get_family(jcfg), get_family(tcfg)
    assert tmod.__name__.split(".")[-1] == jmod.__name__.split(".")[-1]
    jparams, _ = jmod.init(jax.random.PRNGKey(1), jcfg)
    np_params = jax.tree.map(np.asarray, jparams)
    batch = _batch(jcfg)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmod.loss_fn(p, jcfg, b), has_aux=True
    ))(jparams, {k: jnp.asarray(v) for k, v in batch.items()})

    tparams = convert.params_from_jax(np_params, device="cpu")
    live = {
        path: leaf.requires_grad_(True) for path, leaf in tree_items(tparams)
    }
    tloss, tm = tmod.loss_fn(tparams, tcfg, _torch_batch(batch))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=RTOL)
    for name in ("nll", "aux"):
        np.testing.assert_allclose(float(tm[name].detach()), float(jm[name]),
                                   rtol=RTOL, err_msg=name)
    assert (float(tm["aux"].detach()) > 0) == jcfg.is_moe
    for path, want in tree_items(jax.tree.map(np.asarray, jgrads)):
        got = live[path].grad.numpy()
        rtol = _rtol(path)
        np.testing.assert_allclose(
            got, want, rtol=rtol, atol=rtol * np.abs(want).max(), err_msg=path
        )


def test_total_loss_is_the_jitted_fma():
    """``nll + coef * aux`` in f32 bits against the jitted JAX expression
    on 3,000 pairs, of which several hundred round differently as a
    separate product and sum."""
    rng = np.random.default_rng(3)
    nll = rng.uniform(1e-3, 0.1, 3000).astype(np.float32)
    aux = rng.uniform(0.5, 2.0, 3000).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(lambda n, a: n + 0.01 * a))(nll, aux))
    got = np.stack([tlm.total_loss(torch.tensor(n), torch.tensor(a), 0.01).numpy()
                    for n, a in zip(nll, aux, strict=True)])
    separate = nll + np.float32(0.01) * aux
    assert (separate.view(np.int32) != want.view(np.int32)).sum() > 100
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("arch", ["paper-resnet-proxy", "qwen2.5-3b",
                                  "deepseek-moe-16b", "internvl2-1b"])
def test_params_roundtrip(arch):
    """``params_to_numpy`` and ``params_from_jax`` carry every leaf name
    for name (``mlp.router``, ``mlp.shared.*``, ``attn.bq/bk/bv``,
    ``vision_proj.{w,b}``), and the JAX package's ``jax.tree.leaves``
    visits the converted tree in the port's leaf order."""
    tp = tlm.init(tconfigs.get_config(arch).smoke_variant(), seed=3,
                  device="cpu")
    np_tree = convert.params_to_numpy(tp)
    back = convert.params_from_jax(np_tree, device="cpu")
    for (pa, a), (pb, b) in zip(tree_items(tp), tree_items(back), strict=True):
        assert pa == pb and torch.equal(a, b)
    for want, got in zip(tree_leaves(tp), jax.tree.leaves(np_tree), strict=True):
        np.testing.assert_array_equal(np.asarray(got), want.numpy())
