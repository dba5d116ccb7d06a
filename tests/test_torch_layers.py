"""The port's layers that only the model zoo reaches, against
``repro.nn.layers`` under ``jax.jit`` on shared numpy inputs.

* ``layernorm``: the population variance over the last axis, as
  ``jnp.var`` takes it; to rtol 1e-6 times the conditioning ``|mean| /
  std`` of the rows (at least 1): XLA:CPU and PyTorch sum the mean in
  another order, and an ulp of a mean of 100 is 1e-5 of a unit
  deviation ``x - mean``.
* ``mlp(act="gelu")``: the tanh approximation, ``jax.nn.gelu``'s
  default; ``linear`` with a bias; the output to rtol 1e-5 with an
  absolute floor of 1e-5 of its largest magnitude (float32 matmuls sum in
  another order in XLA:CPU and PyTorch), as the model's tests hold it.
* ``attn_init(pad_to=...)`` zero-initialises the padding heads, so the
  padded model is the unpadded function at init (port of
  ``tests/test_archs.py::test_pad_heads_identical_function_at_init``);
  ``attn_init``'s QKV biases and the padded shapes equal JAX's.
* cross-attention: ``attn_qkv(xkv=...)`` and ``attention_dense`` over
  Sq != Sk, to the model's tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import layers as jL
from repro_torch import configs as tconfigs
from repro_torch.models import get_family
from repro_torch.nn import layers as tL

RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _t(tree):
    return jax.tree.map(lambda x: torch.tensor(np.asarray(x)), tree)


@pytest.mark.parametrize("shift", [0.0, 100.0])
def test_layernorm_matches_jax(shift):
    """Rows of unit deviation around ``shift``."""
    rng = np.random.default_rng(0)
    x = (shift + rng.standard_normal((3, 5, 48))).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, 48).astype(np.float32),
         "bias": rng.standard_normal(48).astype(np.float32)}
    want = jax.jit(lambda p, x: jL.layernorm(p, x, eps=1e-5))(p, x)
    got = tL.layernorm(_t(p), torch.from_numpy(x), eps=1e-5)
    _close(got.numpy(), np.asarray(want), rtol=1e-6 * max(1.0, shift))
    init = tL.layernorm_init(48, "cpu")
    jinit, _ = jL.layernorm_init(48)
    for name in ("scale", "bias"):
        np.testing.assert_array_equal(init[name].numpy(), np.asarray(jinit[name]))


@pytest.mark.parametrize("act", ["gelu", "swiglu"])
def test_mlp_matches_jax(act):
    jp, _ = jL.mlp_init(jax.random.PRNGKey(0), 32, 64, act=act)
    tp = tL.mlp_init(torch.Generator().manual_seed(0), 32, 64, "cpu", act=act)
    assert sorted(tp) == sorted(jp)
    x = np.random.default_rng(1).standard_normal((2, 7, 32)).astype(np.float32)
    want = jax.jit(lambda p, x: jL.mlp(p, x, act=act))(jp, x)
    got = tL.mlp(_t(jp), torch.from_numpy(x), act=act)
    _close(got.numpy(), np.asarray(want))
    if act == "gelu":  # the erf form is another function
        erf = torch.nn.functional.gelu(torch.from_numpy(x) @ _t(jp)["wu"]) @ _t(jp)["wd"]
        assert not np.allclose(erf.numpy(), np.asarray(want), rtol=RTOL, atol=0)


def test_linear_with_bias_matches_jax():
    jp, _ = jL.linear_init(jax.random.PRNGKey(2), 24, 40, None, "embed", bias=True)
    jp = dict(jp, b=jnp.linspace(-1.0, 1.0, 40))
    x = np.random.default_rng(2).standard_normal((2, 3, 24)).astype(np.float32)
    _close(tL.linear(_t(jp), torch.from_numpy(x)).numpy(),
           np.asarray(jax.jit(jL.linear)(jp, x)))
    tp = tL.linear_init(torch.Generator().manual_seed(0), 24, 40, "cpu", bias=True)
    assert tp["w"].shape == (24, 40) and torch.equal(tp["b"], torch.zeros(40))


@pytest.mark.parametrize("qkv_bias", [False, True])
@pytest.mark.parametrize("pad_to", [None, 8])
def test_attn_init_shapes_match_jax(qkv_bias, pad_to):
    jp, _ = jL.attn_init(jax.random.PRNGKey(0), 64, 5, 5, 16,
                         qkv_bias=qkv_bias, pad_to=pad_to)
    tp = tL.attn_init(torch.Generator().manual_seed(0), 64, 5, 5, 16, "cpu",
                      qkv_bias=qkv_bias, pad_to=pad_to)
    assert sorted(tp) == sorted(jp)
    for name, leaf in tp.items():
        assert tuple(leaf.shape) == tuple(jp[name].shape), name
        if name.startswith("b"):
            assert not leaf.any()
    if pad_to:
        assert not tp["wq"][:, 5:].any() and not tp["wo"][5:].any()
        assert tp["wq"][:, :5].abs().min() > 0


def test_pad_heads_identical_function_at_init():
    """Zero-init padding heads leave the forward function unchanged: the
    padded model's logits equal the unpadded model's on the same real
    heads' weights, to rtol 1e-5."""
    cfg0 = tconfigs.get_config("phi3-medium-14b").smoke_variant().replace(
        remat=False, n_heads=5, n_kv_heads=5, head_dim=16)
    cfg1 = cfg0.replace(pad_heads=8)
    assert (cfg1.eff_heads, cfg1.eff_kv_heads) == (8, 8)
    mod = get_family(cfg0)
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg0.vocab, (2, 8), generator=gen)}
    p1 = mod.init(cfg1, seed=0, device="cpu")
    attn = p1["layers"]["attn"]
    assert not attn["wq"][:, :, cfg0.n_heads:].any()
    assert not attn["wo"][:, cfg0.n_heads:].any()
    l1, _ = mod.forward(p1, cfg1, batch)
    assert torch.isfinite(l1).all()
    # the unpadded model: the real heads' weights (kv heads as many as q)
    p0 = dict(p1, layers=dict(p1["layers"], attn={
        "wq": attn["wq"][:, :, :5], "wk": attn["wk"][:, :, :5],
        "wv": attn["wv"][:, :, :5], "wo": attn["wo"][:, :5]}))
    l0, _ = mod.forward(p0, cfg0, batch)
    _close(l1.numpy(), l0.numpy())


def test_embed_takes_a_dtype():
    p = {"embedding": torch.arange(12, dtype=torch.float32).reshape(4, 3)}
    tok = torch.tensor([[3, 0]])
    assert tL.embed(p, tok, torch.bfloat16).dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tL.embed(p, tok).numpy(),
        np.asarray(jL.embed({"embedding": p["embedding"].numpy()}, tok.numpy())))


@pytest.mark.parametrize("causal", [False, True])
def test_cross_attention_matches_jax(causal):
    """``attn_qkv(xkv=...)`` projects k and v from the encoder output, and
    ``attention_dense`` takes Sq != Sk (12 decoder queries over 20 encoder
    keys, as whisper's decoder has 448 over 1500): q, k, v and the context
    to the file's tolerance, and k, v independent of ``x``. ``causal``
    covers the mask's ``q_pos >= k_pos`` over a rectangle."""
    jp, _ = jL.attn_init(jax.random.PRNGKey(0), 32, 4, 2, 8, qkv_bias=True)
    rng = np.random.default_rng(1)
    jp = {k: (np.asarray(v) + 0.1 * rng.standard_normal(v.shape)).astype(
        np.float32) for k, v in jp.items()}
    x = rng.standard_normal((2, 12, 32)).astype(np.float32)
    enc = rng.standard_normal((2, 20, 32)).astype(np.float32)

    def jcross(p, x, enc):
        q, k, v = jL.attn_qkv(p, x, xkv=enc)
        return q, k, v, jL.attention_dense(q, k, v, causal=causal)

    want = jax.jit(jcross)(jp, x, enc)
    tp = _t(jp)
    q, k, v = tL.attn_qkv(tp, torch.from_numpy(x), xkv=torch.from_numpy(enc))
    ctx = tL.attention_dense(q, k, v, causal=causal)
    assert tuple(ctx.shape) == (2, 12, 4, 8) and tuple(k.shape) == (2, 20, 2, 8)
    for got, w in zip((q, k, v, ctx), want, strict=True):
        _close(got.numpy(), np.asarray(w))
    _, k2, v2 = tL.attn_qkv(tp, torch.zeros_like(torch.from_numpy(x)),
                            xkv=torch.from_numpy(enc))
    assert torch.equal(k, k2) and torch.equal(v, v2)
