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
* the serving cores: ``attention_chunked`` (online softmax over KV
  blocks, the last one padded) and ``attention_decode`` (a partly filled
  cache, a window) to rtol 1e-6, with an absolute floor of 1e-6 of the
  largest magnitude (the einsums sum in another order); the scale
  ``/ sqrt(head_dim)`` of every core in f32 bits against the jitted
  reference, which multiplies by ``fl(1/fl(sqrt(head_dim)))``.
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


CORE_RTOL = 1e-6


def _qkv(B=2, S=100, H=4, Kh=2, D=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, S, H, D), (B, S, Kh, D), (B, S, Kh, D)))


@pytest.mark.parametrize("window", [None, 17])
def test_attention_chunked_matches_jax(window):
    """B, S, H, Kh, D = 2, 100, 4, 2, 16 in blocks of 32: four blocks, the
    last padded with 28 masked keys; causal, with and without a window
    (rows whose first blocks are all masked)."""
    q, k, v = _qkv()
    want = jax.jit(lambda q, k, v: jL.attention_chunked(
        q, k, v, causal=True, window=window, block=32))(q, k, v)
    got = tL.attention_chunked(*map(torch.from_numpy, (q, k, v)), causal=True,
                               window=window, block=32)
    assert got.shape == (2, 100, 4, 16)
    _close(got.numpy(), np.asarray(want), rtol=CORE_RTOL)
    dense = tL.attention_dense(*map(torch.from_numpy, (q, k, v)), causal=True,
                               window=window)
    _close(got.numpy(), dense.numpy(), rtol=CORE_RTOL)


@pytest.mark.parametrize("cache_len,window", [(37, None), (100, 17), (37, 17)])
def test_attention_decode_matches_jax(cache_len, window):
    """One query over a cache of 100 slots of which ``cache_len`` are
    filled (a 0-d tensor), GQA 4 query heads over 2 KV heads."""
    q, k, v = _qkv(seed=1)
    q = q[:, :1]
    want = jax.jit(lambda q, k, v, n: jL.attention_decode(
        q, k, v, n, window=window))(q, k, v, jnp.int32(cache_len))
    got = tL.attention_decode(*map(torch.from_numpy, (q, k, v)),
                              torch.tensor(cache_len, dtype=torch.int32),
                              window=window)
    assert got.shape == (2, 1, 4, 16)
    _close(got.numpy(), np.asarray(want), rtol=CORE_RTOL)


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("head_dim", [32, 80, 128])
def test_attn_scale_is_the_jitted_division_in_bits(head_dim):
    """100,000 values divided by ``sqrt(head_dim)``: equal to jitted JAX in
    f32 bits, where the IEEE quotient differs in thousands (3,245 at
    head_dim 80, tens of thousands at 32 and 128)."""
    x = (10 * np.random.default_rng(2).standard_normal(100_000)).astype(np.float32)
    want = _bits(jax.jit(lambda x: x / (head_dim**0.5))(x))
    got = tL.attn_scale(torch.from_numpy(x), head_dim).numpy()
    np.testing.assert_array_equal(_bits(got), want)
    ieee = (torch.from_numpy(x) / head_dim**0.5).numpy()
    assert (_bits(ieee) != want).sum() > 1_000


@pytest.mark.parametrize("core", ["dense", "decode", "chunked"])
def test_attention_cores_scale_as_jitted_jax_bits(core, monkeypatch):
    """At head_dim 32 each core's scaled scores (dense, decode: the
    softmax's input) or scaled ``q`` (chunked: the scores' operand) equal
    jitted JAX's in f32 bits. ``q`` is one-hot along head_dim for the
    scores, so ``q . k`` is an entry of ``k`` exactly in both stacks and
    only the scale can differ (as an IEEE division, in 41% of values)."""
    B, S, H, Kh, D = 2, 64, 4, 2, 32
    q, k, v = _qkv(B, S, H, Kh, D, seed=3)
    if core != "chunked":
        hot = np.random.default_rng(4).integers(0, D, (B, S, H))
        q = np.eye(D, dtype=np.float32)[hot]
    seen = []
    if core == "chunked":
        einsum = torch.einsum

        def spy(eq, *ops):
            if eq == "bqhd,bkhd->bhqk":
                seen.append(ops[0])
            return einsum(eq, *ops)

        monkeypatch.setattr(torch, "einsum", spy)
        tL.attention_chunked(*map(torch.from_numpy, (q, k, v)), block=32)
        want = jax.jit(lambda q: q / (D**0.5))(q)
    else:
        softmax = torch.softmax

        def spy(x, dim):
            seen.append(x)
            return softmax(x, dim=dim)

        monkeypatch.setattr(torch, "softmax", spy)
        if core == "dense":
            tL.attention_dense(*map(torch.from_numpy, (q, k, v)), causal=False)
        else:
            q = q[:, :1]
            tL.attention_decode(*map(torch.from_numpy, (q, k, v)),
                                torch.tensor(S, dtype=torch.int32))
        want = jax.jit(lambda q, k: jnp.einsum(
            "bqhd,bkhd->bhqk", q, jL._expand_kv(k, H)) / (D**0.5))(q, k)
    got = seen[0].reshape(np.asarray(want).shape)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
