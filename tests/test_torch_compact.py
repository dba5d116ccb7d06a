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


def test_fastpath_auto_is_not_ported():
    st = tc.compact_init(1, 16, 2, device="cpu")
    with pytest.raises(ValueError, match="not ported"):
        tc.compact_select(
            SparsifierConfig(), st, torch.zeros(1, 16), 2, fastpath="auto"
        )
