"""The port's optimizers (``repro_torch.optim``) against the JAX package's
``repro.optim`` under ``jax.jit``, on shared numpy parameters and
gradients, in f32 (and bf16) bits.

* every ``OptConfig`` field: ``momentum``, ``b1``/``b2``/``eps``,
  ``weight_decay`` (Adam's; the other kinds ignore it, as in JAX),
  ``grad_clip``, ``moment_dtype`` and ``warmup_steps``, for the kinds
  ``sgd``, ``momentum`` and ``adam``; five steps each;
* ``grad_clip`` scales by a norm that both stacks sum in their own order,
  so the clipped cases take dyadic gradients (small integers times 2^-6)
  whose squares sum exactly in f32: the norm, and so every step, is then
  equal in bits;
* the warmup's ``(step + 1) / warmup_steps`` is a product with
  ``fl(1/warmup_steps)`` under ``jit``: held at 3 and 7 steps;
* under ``jit`` XLA:CPU contracts the update's ``a * b + c`` into fused
  multiply-adds, which the port computes with ``torch.addcmul``
  (``repro_torch.optim.optimizers._fma``);
* with bf16 moments the moments are bit-equal, and the parameters within
  ``4e-3 * lr``: in about one element in 2,000 XLA's fused update reads a
  moment at another rounding than the stored bf16 one, which moves that
  step by about one bf16 step (2^-8) of its size; no ordering of the
  port's f32 operations reproduces it;
* ``make_optimizer``'s error.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import OptConfig as JaxOptConfig
from repro.optim import make_optimizer as jax_make_optimizer
from repro_torch.optim import OptConfig, make_optimizer
from repro_torch.tree import tree_items

SHAPES = {"emb": (64, 16), "layers": {"w": (3, 16, 16), "b": (3, 16)}, "out": (16,)}
STEPS = 5


def _tree(fn):
    def mk(t):
        return {k: mk(v) for k, v in t.items()} if isinstance(t, dict) else fn(t)
    return mk(SHAPES)


def _inputs(dyadic: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    params = _tree(lambda s: rng.standard_normal(s).astype(np.float32))
    if dyadic:
        grads = [_tree(lambda s: (rng.integers(-8, 9, s) / 64).astype(np.float32))
                 for _ in range(STEPS)]
    else:
        grads = [_tree(lambda s: (0.1 * rng.standard_normal(s)).astype(np.float32))
                 for _ in range(STEPS)]
    return params, grads


def _bits(x):
    x = np.asarray(x)
    if x.dtype == np.float32:
        return x.view(np.uint32)
    return x.view(np.uint16) if x.dtype.itemsize == 2 else x


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


CASES = {
    "sgd": dict(kind="sgd", learning_rate=0.05),
    "sgd-clip-warmup": dict(kind="sgd", learning_rate=0.05, grad_clip=0.5,
                            warmup_steps=3),
    "momentum": dict(kind="momentum", learning_rate=0.02, momentum=0.8),
    "momentum-wd-clip-warmup": dict(kind="momentum", learning_rate=0.02,
                                    weight_decay=0.1, grad_clip=1.0,
                                    warmup_steps=7),
    "adam": dict(kind="adam", learning_rate=1e-3),
    "adam-betas-eps": dict(kind="adam", learning_rate=3e-3, b1=0.8, b2=0.99,
                           eps=1e-6),
    "adam-wd": dict(kind="adam", learning_rate=1e-3, weight_decay=0.01),
    "adam-bf16-moments": dict(kind="adam", learning_rate=1e-3,
                              moment_dtype="bfloat16"),
    "adam-all": dict(kind="adam", learning_rate=2e-3, weight_decay=0.05,
                     grad_clip=0.3, moment_dtype="bfloat16", warmup_steps=3),
}


@pytest.mark.parametrize("name", list(CASES))
def test_optimizer_steps_match_jitted_jax_bits(name):
    kw = CASES[name]
    clip = kw.get("grad_clip") is not None
    params, grads = _inputs(dyadic=clip)
    jopt, topt = jax_make_optimizer(JaxOptConfig(**kw)), make_optimizer(OptConfig(**kw))
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = _torch(params)
    ts = topt.init(tp)
    jupdate = jax.jit(jopt.update)
    for g in grads:
        jp, js = jupdate(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = topt.update(_torch(g), ts, tp)
    for (path, t), (_, j) in zip(tree_items(tp), tree_items(jax.tree.map(np.asarray, jp)),
                                 strict=True):
        if kw.get("moment_dtype") == "bfloat16":
            np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                       atol=4e-3 * kw["learning_rate"], err_msg=path)
        else:
            np.testing.assert_array_equal(_bits(t.numpy()), _bits(j), err_msg=path)
    jstate = jax.tree.map(np.asarray, js)
    assert sorted(ts) == sorted(jstate)
    for key in ts:
        for (path, t), (_, j) in zip(tree_items(ts[key]), tree_items(jstate[key]),
                                     strict=True):
            t = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
            j = j.astype(np.float32) if j.dtype == jnp.bfloat16 else j
            assert t.dtype == j.dtype, (key, path)
            np.testing.assert_array_equal(_bits(t), _bits(j), err_msg=f"{key}.{path}")
    if kw.get("moment_dtype") == "bfloat16":
        assert all(x.dtype == torch.bfloat16 for _, x in tree_items(ts["m"]))


def test_clip_is_active_in_the_clipped_cases():
    """The clip bounds of the cases bind: the global norm of every step's
    gradient exceeds them."""
    _, grads = _inputs(dyadic=True)
    for g in grads:
        norm = np.sqrt(sum(float(np.sum(np.square(x))) for _, x in tree_items(g)))
        assert norm > 1.0


def test_warmup_ramps_the_learning_rate():
    """The first step of a 4-step warmup moves SGD by a quarter of lr."""
    params, grads = _inputs(dyadic=True)
    opt = make_optimizer(OptConfig(kind="sgd", learning_rate=1.0, warmup_steps=4))
    tp = _torch(params)
    new, _ = opt.update(_torch(grads[0]), opt.init(tp), tp)
    np.testing.assert_array_equal((tp["out"] - new["out"]).numpy(),
                                  grads[0]["out"] * np.float32(0.25))


def test_unknown_optimizer_error_matches_jax():
    with pytest.raises(ValueError) as want:
        jax_make_optimizer(JaxOptConfig(kind="lion"))
    with pytest.raises(ValueError) as got:
        make_optimizer(OptConfig(kind="lion"))
    assert str(got.value) == str(want.value)


def test_opt_config_fields_match_jax():
    import dataclasses

    assert [(f.name, f.default) for f in dataclasses.fields(OptConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(JaxOptConfig)]
