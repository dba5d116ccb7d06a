"""The port's wire codecs against the JAX package's.

Each codec encodes the same numpy payloads in both stacks: the port all W
workers at once, the JAX package one worker at a time under ``vmap``.
Payloads carry padding slots as the selectors emit them (index 0 repeated,
value +0.0 or -0.0) beside a real entry at index 0, at the lengths where
``coo_idx_delta`` changes its delta dtype (L = 127, 128, 32767, 32768).
Every buffer of the encoded payload, the decoded ``(vals, idx)``,
``decoded_dense`` and ``wire_bits`` must be equal, floats and integers
compared in bits. ``coo_q8`` is compared on f32 input; in bf16 the port
quantizes in f32 and the JAX package in bf16 (ROADMAP queue 3), and a
test holds the port to the f32 error bound there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import codec as jcodec
from repro_torch.comm import codec as tcodec
import _torch_cores  # noqa: F401  (this worker's share of the cores)

NAMES = sorted(tcodec.CODECS)
W = 3


def _payload(seed, L, k, neg_zero_pad=True):
    """``[W, k]`` f32 values and int32 indices: distinct random indices,
    then a padding tail of index 0 (value -0.0 or +0.0); worker 1 also
    sends a real entry at index 0, and worker 2 is all padding but one."""
    rng = np.random.default_rng(seed)
    vals = (3.0 * rng.standard_normal((W, k))).astype(np.float32)
    idx = np.stack([rng.choice(np.arange(1, L), k, replace=False)
                    for _ in range(W)]).astype(np.int32)
    pad = np.float32(-0.0) if neg_zero_pad else np.float32(0.0)
    n_pad = max(1, k // 3)
    vals[:, k - n_pad:] = pad
    idx[:, k - n_pad:] = 0
    idx[1, 0] = 0  # a real entry sharing index 0 with the padding
    vals[2, 1:] = pad
    idx[2, 1:] = 0
    return vals, idx


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


def _jax_encode(name, vals, idx, L):
    """The JAX encode under ``jax.jit``, as the simulator and the trainer
    run it: ``coo_q8``'s ``amax / 127.0`` is then ``amax * fl(1/127)``."""
    c = jcodec.get_codec(name)
    return jax.jit(jax.vmap(lambda v, i: c.encode(v, i, L)))(
        jnp.asarray(vals), jnp.asarray(idx))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("L", [127, 128, 32767, 32768])
@pytest.mark.parametrize("neg_zero_pad", [True, False])
def test_codec_matches_jax_bits(name, L, neg_zero_pad):
    k = 24
    vals, idx = _payload(L + len(name), L, k, neg_zero_pad)
    jc, tc = jcodec.get_codec(name), tcodec.get_codec(name)
    jpay = _jax_encode(name, vals, idx, L)
    tpay = tc.encode(torch.from_numpy(vals), torch.from_numpy(idx).long(), L)
    assert sorted(tpay) == sorted(jpay)
    for key, jx in jpay.items():
        tx = tpay[key].numpy()
        assert tx.dtype == np.asarray(jx).dtype, key
        assert tx.shape == np.asarray(jx).shape, key
        np.testing.assert_array_equal(_bits(tx), _bits(jx), err_msg=key)
    if tc.supports_fused:
        fused = tc.encode_fused(torch.from_numpy(vals), torch.from_numpy(idx).long(), L)
        for key in tpay:
            assert torch.equal(fused[key], tpay[key]), key
    else:
        with pytest.raises(NotImplementedError, match="no fused encode"):
            tc.encode_fused(torch.from_numpy(vals), torch.from_numpy(idx), L)
    assert tc.supports_fused == jc.supports_fused and tc.lossless == jc.lossless

    jv, ji = jax.vmap(lambda p: jc.decode(p, L))(jpay)
    tv, ti = tc.decode(tpay, L)
    assert ti.dtype == torch.int64
    np.testing.assert_array_equal(_bits(tv.numpy()), _bits(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    jd = jax.vmap(lambda p: jc.decoded_dense(p, L))(jpay)
    np.testing.assert_array_equal(_bits(tc.decoded_dense(tpay, L).numpy()), _bits(jd))
    assert tc.wire_bits(L, k) == int(jc.wire_bits(L, k))
    nbytes = sum(x.numel() * x.element_size() for x in tpay.values())
    assert 8 * nbytes == W * tc.wire_bits(L, k)


@pytest.mark.parametrize("L,dtype", [
    (127, torch.int8), (128, torch.int16), (32767, torch.int16), (32768, torch.int32),
])
def test_delta_dtype_thresholds_match_jax(L, dtype):
    assert tcodec.delta_index_dtype(L) is dtype
    assert jnp.dtype(jcodec.delta_index_dtype(L)).name == str(dtype).removeprefix("torch.")


def test_delta_sort_keeps_padding_order():
    """Index 0 repeats across the padding slots: the sort is stable, so
    the values there keep their order and bits (-0.0 before +0.0 before
    a real entry, as written)."""
    vals = torch.tensor([[5.0, -0.0, 0.0, 7.0, 1.0]])
    idx = torch.tensor([[3, 0, 0, 0, 1]])
    pay = tcodec.get_codec("coo_idx_delta").encode(vals, idx, 8)
    assert pay["deltas"].tolist() == [[0, 0, 0, 1, 2]]
    assert pay["vals"].view(torch.int32).tolist() == [[-2**31, 0, 1088421888, 1065353216, 1084227584]]


def test_bitmap_bit_order_is_little_endian():
    vals = torch.tensor([[1.0, 2.0, 3.0]])
    idx = torch.tensor([[0, 9, 3]])
    pay = tcodec.get_codec("bitmap_dense").encode(vals, idx, 12)
    assert pay["bitmap"].tolist() == [[0b00001001, 0b00000010]]
    assert pay["vals"].tolist() == [[1.0, 3.0, 2.0]]


def test_get_codec_error_matches_jax():
    with pytest.raises(ValueError) as want:
        jcodec.get_codec("bogus")
    with pytest.raises(ValueError) as got:
        tcodec.get_codec("bogus")
    assert str(got.value) == str(want.value)
    assert sorted(tcodec.CODECS) == sorted(jcodec.CODECS)


def _q8_case(seed, L, sparsity):
    """The JAX package's Hypothesis payload (``tests/test_comm.py``'s
    ``_random_payload``) in bf16, as numpy."""
    from repro.core.selectors import sparsity_to_k

    k = sparsity_to_k(L, sparsity)
    key = jax.random.PRNGKey(seed)
    vals = (3.0 * jax.random.normal(key, (k,), jnp.float32)).astype(jnp.bfloat16)
    idx = jax.random.choice(jax.random.fold_in(key, 1), L, (k,), replace=False)
    n_pad = seed % max(k // 2, 1)
    if n_pad:
        vals = vals.at[-n_pad:].set(0)
        idx = idx.at[-n_pad:].set(0)
    return vals, np.array(idx, np.int32)


@pytest.mark.parametrize("seed,L,sparsity", [(16107, 1487, 0.5), (3, 300, 0.2)])
def test_q8_bf16_stays_within_the_f32_bound(seed, L, sparsity):
    """Known difference (ROADMAP queue 3): in bf16 the JAX package
    quantizes in bf16 and its round-trip error can exceed half a
    quantization step (Hypothesis found seed 16107, L = 1487, S = 0.5);
    the port quantizes in f32, equals the jitted JAX encoding of the
    f32-cast values bit for bit, and keeps the bound."""
    jvals, idx = _q8_case(seed, L, sparsity)
    v32 = np.array(jvals.astype(jnp.float32))
    tvals = torch.from_numpy(v32).to(torch.bfloat16)[None]
    tc = tcodec.get_codec("coo_q8")
    tpay = tc.encode(tvals, torch.from_numpy(idx).long()[None], L)
    jpay = jax.jit(lambda v, i: jcodec.get_codec("coo_q8").encode(v, i, L))(
        jnp.asarray(v32), jnp.asarray(idx))
    for key in ("q", "scale", "idx"):
        np.testing.assert_array_equal(_bits(tpay[key][0].numpy()), _bits(jpay[key]))
    amax = float(np.abs(v32).max())
    step = amax / 127.0 if amax > 0 else 1.0
    bound = step / 2 + 1e-7 * max(amax, 1.0)
    dv, _ = tc.decode(tpay, L)
    assert float(np.abs(dv[0].numpy() - v32).max()) <= bound
    if seed == 16107:
        jc = jcodec.get_codec("coo_q8")
        jdv, _ = jc.decode(jc.encode(jvals, jnp.asarray(idx), L), L)
        assert float(np.abs(np.asarray(jdv) - v32).max()) > bound


def test_default_throughput_tables_plan_another_wire():
    """Known difference (ROADMAP queue 3, 3b): the packages' default
    ``ThroughputTable`` rates differ (the JAX package's 819e9 B/s roofline
    constant, the port's 2.98e12, kernel 2's rate measured on the H100),
    and under ``fastpath="on"`` the rates enter ``choose_leaf``'s price.
    A 4,096-element leaf at k = 41 on one dp axis of 8 with
    ``AlphaBeta()``: the JAX package plans ``bitmap_dense`` unfused, the
    port ``coo_idx_delta`` fused; with one shared table they plan alike
    (the parity tests give both packages one table)."""
    from repro.comm import autotune as jauto
    from repro.comm import fastpath as jfp
    from repro_torch.comm import autotune as tauto
    from repro_torch.comm import fastpath as tfp

    assert jfp.ThroughputTable().fused_bps == 819e9
    assert tfp.ThroughputTable().fused_bps == 2.98e12
    kw = dict(fastpath="on")
    jd = jauto.choose_leaf(4096, 41, (8,), **kw)
    td = tauto.choose_leaf(4096, 41, (8,), **kw)
    assert (jd.codec, jd.collective, jd.fused) == ("bitmap_dense", "sparse_allgather",
                                                   False)
    assert (td.codec, td.collective, td.fused) == ("coo_idx_delta", "sparse_allgather",
                                                   True)
    shared = tauto.choose_leaf(4096, 41, (8,), compute=tfp.ThroughputTable(
        fused_bps=819e9, unfused_bps=819e9), **kw)
    assert (shared.codec, shared.collective, shared.fused) == (
        jd.codec, jd.collective, jd.fused)
