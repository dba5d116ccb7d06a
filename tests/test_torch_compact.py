"""The port's compact runtime against the JAX package's, round by round.

Three rounds of ``compact_select`` (fastpath off and on) and
``compact_finalize_sent`` on the same per-worker states and gradients.
The port runs both workers in one batched call; the JAX package runs
each worker alone, its fused path through the Pallas kernel in interpret
mode. Indices and round counters must match exactly, floats to rtol 1e-6
(XLA:CPU's and PyTorch's tanh differ in the last ulp). The port's fused
and dense paths must agree bit for bit.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compact as jc
from repro.core.sparsify import SparsifierConfig as JaxSparsifierConfig
from repro_torch.comm.fastpath import FastpathCounts, candidate_budget
from repro_torch.core import compact as tc
from repro_torch.core.sparsify import SparsifierConfig

RTOL = 1e-6
L, K, W = 3 * 8192 + 17, 40, 2


def _jax_state(st, w):
    return jc.CompactState(
        eps=jnp.asarray(st.eps[w].numpy()),
        sent_vals=jnp.asarray(st.sent_vals[w].numpy()),
        sent_g=jnp.asarray(st.sent_g[w].numpy()),
        sent_idx=jnp.asarray(st.sent_idx[w].numpy(), jnp.int32),
        sent_w=jnp.asarray(st.sent_w[w].numpy()),
        t=jnp.asarray(st.t[w].numpy()),
    )


def _assert_state(st, jst, w):
    np.testing.assert_array_equal(st.sent_idx[w].numpy(), np.asarray(jst.sent_idx))
    np.testing.assert_array_equal(st.t[w].numpy(), np.asarray(jst.t))
    for name in ("eps", "sent_vals", "sent_g", "sent_w"):
        np.testing.assert_allclose(
            getattr(st, name)[w].numpy(), np.asarray(getattr(jst, name)),
            rtol=RTOL, err_msg=name,
        )


@pytest.mark.parametrize("concentrated", [False, True])
@pytest.mark.parametrize(
    "kind,y", [("topk", 1.0), ("regtopk", 1.0), ("regtopk", 2.0)]
)
def test_three_rounds_match_jax(kind, y, concentrated):
    assert candidate_budget(L, K) == 33
    cfg = SparsifierConfig(kind=kind, sparsity=K / L, mu=1.0, y=y, omega=0.5)
    jcfg = JaxSparsifierConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng([len(kind), int(y), int(concentrated)])
    st = tc.compact_init(W, L, K, device="cpu")
    counts = FastpathCounts()
    for t in range(3):
        g = rng.standard_normal((W, L)).astype(np.float32)
        if concentrated:  # tile 0 holds the mass: the certificate fails
            g[:, :200] *= 50.0
        gt = torch.from_numpy(g)
        a, vals, idx = tc.compact_select(cfg, st, gt, K, fastpath="off")
        a2, vals2, idx2 = tc.compact_select(
            cfg, st, gt, K, fastpath="on", counts=counts
        )
        assert torch.equal(a, a2)
        assert torch.equal(idx, idx2) and torch.equal(vals, vals2)
        agg = torch.from_numpy(rng.standard_normal(L).astype(np.float32))
        sent_dense = torch.zeros_like(a).scatter_add_(1, idx, vals)
        new = tc.compact_finalize_sent(st, a, vals, idx, sent_dense, agg)
        for w in range(W):
            jst = _jax_state(st, w)
            for fp in ("off", "on"):
                ja, jv, ji = jc.compact_select(
                    jcfg, jst, jnp.asarray(g[w]), K, fastpath=fp
                )
                np.testing.assert_array_equal(idx[w].numpy(), np.asarray(ji))
                np.testing.assert_allclose(vals[w].numpy(), np.asarray(jv), rtol=RTOL)
            jnew = jc.compact_finalize_sent(
                jst, ja, jv, ji, jnp.asarray(sent_dense[w].numpy()),
                jnp.asarray(agg.numpy()),
            )
            _assert_state(new, jnew, w)
        st = new
    assert counts.rounds == 3 * W
    if concentrated:
        assert counts.fallbacks == 3 * W
    elif kind == "regtopk" and y != 1.0:
        # round 0 scores |a|^y, which only the dense path orders like Top-k
        assert counts.fallbacks == W
    else:
        assert counts.fallbacks == 0


def test_fastpath_auto_is_not_ported(monkeypatch):
    """``fastpath="auto"`` is ported. On the CPU it declines the kernel
    (``fastpath.backend_supports``): the dense path, no fused round
    counted. Where the device can run the kernel (here pretended), the
    default table prices this leaf faster fused, as the JAX package's
    does, and the payload is the same. An unknown mode raises."""
    from repro.comm import fastpath as jfp
    from repro_torch.comm import fastpath as tfp

    cfg = SparsifierConfig(kind="regtopk", sparsity=K / L, mu=1.0, omega=0.5)
    st = tc.compact_init(W, L, K, device="cpu")
    g = torch.from_numpy(np.random.default_rng(3).standard_normal((W, L)).astype(np.float32))
    off = tc.compact_select(cfg, st, g, K, fastpath="off")
    counts = FastpathCounts()
    auto = tc.compact_select(cfg, st, g, K, fastpath="auto", counts=counts)
    assert all(torch.equal(x, y) for x, y in zip(auto, off, strict=True))
    assert counts.rounds == 0
    assert tfp.ThroughputTable().prefers_fused(L, K) == jfp.ThroughputTable().prefers_fused(L, K)
    monkeypatch.setattr(tfp, "backend_supports", lambda device: True)
    auto = tc.compact_select(cfg, st, g, K, fastpath="auto", counts=counts)
    assert all(torch.equal(x, y) for x, y in zip(auto, off, strict=True))
    assert counts.rounds == W
    with pytest.raises(ValueError, match="unknown fastpath"):
        tc.compact_select(cfg, st, g, K, fastpath="always")


def test_zero_score_slots_bits_match_jax():
    """ROADMAP queue 3's repro of the exact selector's zero-score slots:
    RegTop-k with y = 2 at t = 1, sent at [1, 3, 5, 6] with sent_vals,
    sent_g and sent_w all 1, omega 1, and a gradient whose tiny negative
    entries square to a zero score. Both stacks send [3, 2, +0.0, +0.0]
    at [1, 3, 0, 2], f32 bits compared; a product with the mask would
    give -0.0 in the last two slots."""
    cfg = SparsifierConfig(kind="regtopk", sparsity=0.5, mu=1.0, y=2.0, omega=1.0)
    n, k = 8, 4
    ones = torch.ones(1, k)
    st = tc.CompactState(
        eps=torch.zeros(1, n), sent_vals=ones, sent_g=ones.clone(),
        sent_idx=torch.tensor([[1, 3, 5, 6]]), sent_w=ones.clone(),
        t=torch.ones(1, dtype=torch.int32),
    )
    g = np.array([[-1e-25, 3.0, -1e-26, 2.0, 0, 0, 0, 0]], np.float32)
    _, vals, idx = tc.compact_select(cfg, st, torch.from_numpy(g), k)
    _, jv, ji = jc.compact_select(_jax_cfg(cfg), _jax_state(st, 0), jnp.asarray(g[0]), k)
    assert idx[0].tolist() == [1, 3, 0, 2] == np.asarray(ji).tolist()
    np.testing.assert_array_equal(
        vals[0].numpy().view(np.uint32), np.asarray(jv).view(np.uint32)
    )
    assert vals[0].tolist() == [3.0, 2.0, 0.0, 0.0]
    assert (vals[0, 2:].view(torch.int32) == 0).all()


def _jax_cfg(cfg):
    return JaxSparsifierConfig(**dataclasses.asdict(cfg))


def _three_rounds_with_finalize(cfg, st, seed):
    """Three rounds of the port's ``compact_select`` and
    ``compact_finalize`` against the JAX package's, worker by worker."""
    rng = np.random.default_rng(seed)
    jcfg = _jax_cfg(cfg)
    for _ in range(3):
        g = rng.standard_normal((W, L)).astype(np.float32)
        a, vals, idx = tc.compact_select(cfg, st, torch.from_numpy(g), K)
        agg = torch.from_numpy(rng.standard_normal(L).astype(np.float32))
        new = tc.compact_finalize(st, a, vals, idx, agg)
        for w in range(W):
            jst = _jax_state(st, w)
            ja, jv, ji = jc.compact_select(jcfg, jst, jnp.asarray(g[w]), K)
            np.testing.assert_array_equal(idx[w].numpy(), np.asarray(ji))
            np.testing.assert_allclose(vals[w].numpy(), np.asarray(jv), rtol=RTOL)
            jnew = jc.compact_finalize(jst, ja, jv, ji, jnp.asarray(agg.numpy()))
            _assert_state(new, jnew, w)
        st = new
    return st


@pytest.mark.parametrize("kind,y", [("topk", 1.0), ("regtopk", 1.0), ("regtopk", 2.0)])
def test_threshold_selector_three_rounds_match_jax(kind, y):
    """The bisection mask ranked into k slots by ``mask_to_payload``."""
    cfg = SparsifierConfig(kind=kind, sparsity=K / L, mu=1.0, y=y, omega=0.5,
                           selector="threshold")
    st = _three_rounds_with_finalize(cfg, tc.compact_init(W, L, K, device="cpu"),
                                     [7, int(y)])
    assert (st.t == 3).all()


@pytest.mark.parametrize("t0", [0, (2**31 - 1) // K])
def test_cyclic_three_rounds_match_jax(t0):
    """The round-robin window; from t0 = (2^31 - 1) // k the int32 product
    t * k wraps in the second round, in both packages alike."""
    cfg = SparsifierConfig(kind="cyclic", sparsity=K / L)
    st = tc.compact_init(W, L, K, device="cpu")
    st = st._replace(t=torch.full((W,), t0, dtype=torch.int32))
    st = _three_rounds_with_finalize(cfg, st, 11)
    if t0:  # the last round's t * k was past the int32 range
        assert ((st.t.long() - 1) * K > 2**31 - 1).all()


def test_unknown_selector_raises():
    st = tc.compact_init(1, 16, 2, device="cpu")
    with pytest.raises(ValueError, match="does not support selector"):
        tc.compact_select(SparsifierConfig(selector="bogus"), st,
                          torch.zeros(1, 16), 2)


@pytest.mark.parametrize(
    "kind,y", [("topk", 1.0), ("regtopk", 1.0), ("regtopk", 0.5), ("regtopk", 2.0)]
)
def test_compact_matches_dense_reference_step(kind, y):
    """The compact path against ``reference_step``, the dense sparsifier
    on the state the compact one rebuilds, five rounds, both workers."""
    n, k = 64, 8
    cfg = SparsifierConfig(kind=kind, sparsity=k / n, mu=1.5, omega=0.1, y=y)
    st = tc.compact_init(W, n, k, device="cpu")
    rng = np.random.default_rng(0)
    g_prev = torch.zeros(n)
    for _ in range(5):
        g = torch.from_numpy(rng.standard_normal((W, n)).astype(np.float32))
        ghat_ref, mask_ref, _ = tc.reference_step(cfg, st, g, g_prev, k)
        a, vals, idx = tc.compact_select(cfg, st, g, k)
        ghat = torch.zeros(W, n).scatter(1, idx, vals)
        np.testing.assert_allclose(ghat.numpy(), ghat_ref.numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert torch.equal((ghat != 0).float(), mask_ref * (ghat_ref != 0))
        agg = 0.1 * ghat.sum(0)
        st = tc.compact_finalize(st, a, vals, idx, agg)
        g_prev = agg


def _bf16_bits(x):
    return np.asarray(x).view(np.uint16) if np.asarray(x).dtype.itemsize == 2 else x


@pytest.mark.parametrize("y", [1.0, 2.0, 1.5])
@pytest.mark.parametrize("kind", ["regtopk", "topk"])
def test_bf16_state_rounds_match_jitted_jax_bits(kind, y):
    """A bf16 state (the trainer's ``state_dtype="bfloat16"``): three
    rounds of ``compact_select`` and ``compact_finalize`` on shared bf16
    gradients, against the jitted JAX functions per worker. The bf16 score
    chain (``pow_y``, tanh at mu = 1, the trade-off with the sent
    statistics) and the stable top-k over bf16 keys, which tie far more
    often than f32 ones (some selected values here share their
    magnitude), give JAX's payload: ``a``, the values, the
    indices in order and every state slot equal in bits."""
    import jax

    rng = np.random.default_rng(17)
    cfg = SparsifierConfig(kind=kind, sparsity=K / L, mu=1.0, y=y, omega=0.5)
    jcfg = JaxSparsifierConfig(**dataclasses.asdict(cfg))
    st = tc.compact_init(W, L, K, "cpu", torch.bfloat16)
    jsel = jax.jit(lambda s, g: jc.compact_select(jcfg, s, g, K))
    jfin = jax.jit(jc.compact_finalize)
    ties = 0
    for _ in range(3):
        g = torch.from_numpy(rng.standard_normal((W, L)).astype(np.float32)).to(
            torch.bfloat16)
        agg = torch.from_numpy(rng.standard_normal(L).astype(np.float32)).to(
            torch.bfloat16)
        a, vals, idx = tc.compact_select(cfg, st, g, K)
        new = tc.compact_finalize(st, a, vals, idx, agg)
        for w in range(W):
            jst = jc.CompactState(*(jnp.asarray(x[w].float().numpy()).astype(
                jnp.bfloat16) if x.dtype == torch.bfloat16
                else jnp.asarray(x[w].numpy().astype(np.int32)) for x in st))
            jg = jnp.asarray(g[w].float().numpy()).astype(jnp.bfloat16)
            ja, jv, ji = jsel(jst, jg)
            np.testing.assert_array_equal(_bf16_bits(a[w].view(torch.int16).numpy()),
                                          _bf16_bits(ja))
            np.testing.assert_array_equal(_bf16_bits(vals[w].view(torch.int16).numpy()),
                                          _bf16_bits(jv))
            np.testing.assert_array_equal(idx[w].numpy(), np.asarray(ji))
            jnew = jfin(jst, ja, jv, ji, jnp.asarray(agg.float().numpy()).astype(
                jnp.bfloat16))
            for name in ("eps", "sent_vals", "sent_g", "sent_w"):
                np.testing.assert_array_equal(
                    _bf16_bits(getattr(new, name)[w].view(torch.int16).numpy()),
                    _bf16_bits(getattr(jnew, name)), err_msg=name)
            np.testing.assert_array_equal(new.t[w].numpy(), np.asarray(jnew.t))
            ties += len(vals[w]) - len(set(vals[w].abs().float().tolist()))
        st = new
    assert ties > 0
