"""The port's simulator against the JAX package's, round by round.

* the paper's Fig. 1 toy (2 workers, J = 2): the traces of Top-1,
  RegTop-1 and no sparsification agree with the JAX package's to rtol
  1e-5, and the port makes the same assertions as
  ``tests/test_sparsify.py::test_fig1_topk_stuck_regtopk_tracks``;
* distributed linear regression on the JAX package's own
  ``make_linreg(3, 4, 64, 100)`` arrays (``convert.linreg_from_jax``), 40
  rounds of every kind under both collectives: the per-round masks are
  exact for the first 5 rounds and the final theta agrees to rtol 1e-4
  (XLA:CPU and PyTorch sum the float32 products of the gradient and the
  aggregation in other orders, and 40 rounds carry that difference);
* a run continued from a JAX state (``convert.sim_state_from_jax``);
* the fastpath on equals off with ``torch.equal`` (RegTop-k through the
  kernel wrapper, which computes the plain chain on the CPU) at y = 1
  and y = 2; ``"auto"`` declines on the CPU; every option that is not
  ported raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DistributedSim as JaxSim
from repro.core import SparsifierConfig as JaxConfig
from repro.data import pipeline as jpipe
from repro_torch.convert import linreg_from_jax, sim_state_from_jax, sim_state_to_numpy
from repro_torch.core import DistributedSim, SparsifierConfig
from repro_torch.data.pipeline import linreg_grad_fn

KINDS = ["none", "topk", "regtopk", "hard_threshold", "coordtopk", "dgc"]
TOY_X = np.array([[100.0, 1.0], [-100.0, 1.0]], np.float32)


def _toy_traces(kind):
    xj, xt = jnp.asarray(TOY_X), torch.from_numpy(TOY_X)

    def jgrad(theta, n):
        e = jnp.exp(-jnp.dot(theta, xj[n]))
        return -e * xj[n] / (1 + e)

    def tgrad(theta, widx):
        xn = xt[widx]
        e = torch.exp(-(xn @ theta))[:, None]
        return -e * xn / (1 + e)

    jsim = JaxSim(jgrad, 2, 2, JaxConfig(kind=kind, sparsity=0.5, mu=1.0),
                  learning_rate=0.9)
    _, jtr = jsim.run(jnp.array([0.0, 1.0]), 60,
                      trace_fn=lambda th: jnp.mean(jnp.log(1 + jnp.exp(-xj @ th))))
    tsim = DistributedSim(tgrad, 2, 2, SparsifierConfig(kind=kind, sparsity=0.5, mu=1.0),
                          learning_rate=0.9, device="cpu")
    _, ttr = tsim.run(torch.tensor([0.0, 1.0]), 60,
                      trace_fn=lambda th: torch.log(1 + torch.exp(-xt @ th)).mean())
    return np.asarray(jtr), ttr.numpy()


def test_fig1_toy_matches_jax():
    t = {}
    for kind in ("topk", "regtopk", "none"):
        jtr, ttr = _toy_traces(kind)
        np.testing.assert_allclose(ttr, jtr, rtol=1e-5, err_msg=kind)
        t[kind] = ttr
    assert t["topk"][49] == pytest.approx(t["topk"][0])  # stuck
    assert t["regtopk"][49] < 0.05  # converging
    assert abs(t["regtopk"][49] - t["none"][49]) < 0.01  # tracks ideal


@pytest.fixture(scope="module")
def linreg():
    jdata = jpipe.make_linreg(3, 4, 64, 100)
    tdata = linreg_from_jax(jax.tree.map(np.asarray, jdata), device="cpu")
    return jdata, tdata


CASES = [(k, c) for k in KINDS for c in ("dense_allreduce", "sparse_allgather")
         if not (k == "hard_threshold" and c == "sparse_allgather")]


def _cfg(kind, cls):
    return cls(kind=kind, sparsity=0.25, mu=16.0, threshold=0.5)


@pytest.mark.parametrize("kind,collective", CASES)
def test_linreg_matches_jax(linreg, kind, collective):
    jdata, tdata = linreg
    jsim = JaxSim(jpipe.linreg_grad_fn(jdata), 4, 64, _cfg(kind, JaxConfig),
                  learning_rate=1e-2, aggregation=collective)
    jfin, jmasks = jsim.run(jnp.zeros(64), 40,
                            trace_state_fn=lambda s: s.worker_states.s_prev)
    tsim = DistributedSim(linreg_grad_fn(tdata), 4, 64, _cfg(kind, SparsifierConfig),
                          learning_rate=1e-2, aggregation=collective, device="cpu")
    tfin, tmasks = tsim.run(torch.zeros(64), 40,
                            trace_state_fn=lambda s: s.worker_states.s_prev)
    np.testing.assert_array_equal(tmasks[:5].numpy(), np.asarray(jmasks)[:5])
    np.testing.assert_allclose(tfin.theta.numpy(), np.asarray(jfin.theta),
                               rtol=1e-4, atol=1e-5)
    assert tfin.step == 40


def test_run_continues_from_a_jax_state(linreg):
    """20 JAX rounds, then 5 more in each stack from the same state."""
    jdata, tdata = linreg
    cfg = dict(kind="regtopk", sparsity=0.25, mu=16.0)
    jsim = JaxSim(jpipe.linreg_grad_fn(jdata), 4, 64, JaxConfig(**cfg),
                  learning_rate=1e-2, aggregation="sparse_allgather")
    st = jsim.init(jnp.zeros(64))
    for _ in range(20):
        st, _ = jsim.step_fn(st)
    tsim = DistributedSim(linreg_grad_fn(tdata), 4, 64, SparsifierConfig(**cfg),
                          learning_rate=1e-2, aggregation="sparse_allgather",
                          device="cpu")
    tst = sim_state_from_jax(jax.tree.map(np.asarray, st), device="cpu")
    assert tst.step == 20
    for _ in range(5):
        st, jg = jsim.step_fn(st)
        tst, tg = tsim.step_fn(tst)
        np.testing.assert_array_equal(
            tst.worker_states.s_prev.numpy(), np.asarray(st.worker_states.s_prev)
        )
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)
    got = sim_state_to_numpy(tst)
    assert got["step"] == 25
    np.testing.assert_allclose(got["theta"], np.asarray(st.theta), rtol=1e-5)


@pytest.mark.parametrize("y", [1.0, 2.0])
@pytest.mark.parametrize("collective", ["dense_allreduce", "sparse_allgather"])
def test_fastpath_on_equals_off(linreg, collective, y):
    """Through the kernel wrapper (the plain chain on the CPU) and without
    it, the runs agree bit for bit. At y = 1.5 the CPU gives no such
    guarantee: PyTorch's CPU pow can differ in the last bit between its
    vectorised body and its scalar tail, and the tiled layout moves
    elements between the two; the card has no such split."""
    _, tdata = linreg
    out = {}
    for mode in ("off", "on"):
        sim = DistributedSim(
            linreg_grad_fn(tdata), 4, 64,
            SparsifierConfig(kind="regtopk", sparsity=0.25, mu=16.0, y=y),
            learning_rate=1e-2, aggregation=collective, fastpath=mode,
            device="cpu",
        )
        assert (sim.sparsifier.cfg.score_fn is not None) == (mode == "on")
        out[mode] = sim.run(torch.zeros(64), 40,
                            trace_state_fn=lambda s: s.worker_states.s_prev)
    assert torch.equal(out["on"][1], out["off"][1])
    assert torch.equal(out["on"][0].theta, out["off"][0].theta)
    assert torch.equal(out["on"][0].g_agg_prev, out["off"][0].g_agg_prev)


def _sim(**kw):
    args = dict(grad_fn=None, n_workers=4, length=64,
                sparsifier_cfg=SparsifierConfig(kind="regtopk"), device="cpu")
    args.update(kw)
    return DistributedSim(**args)


def test_auto_declines_on_the_cpu():
    assert _sim(fastpath="auto").sparsifier.cfg.score_fn is None
    assert _sim(fastpath="on").sparsifier.cfg.score_fn is not None
    assert _sim(fastpath="on", sparsifier_cfg=SparsifierConfig(kind="topk")
                ).sparsifier.cfg.score_fn is None


class _Partial:
    is_full = False


@pytest.mark.parametrize("kw,match", [
    (dict(participation=_Partial()), "item 6"),
    (dict(adaptive_k=object()), "item 6"),
    (dict(overlap="buckets:2"), "item 6"),
    (dict(weighting="coordinate"), "item 4"),
    (dict(weighting="per-worker"), "unknown weighting"),
    (dict(codec="coo_q8"), "item 3"),
    (dict(codec="coo_idx_delta"), "item 3"),
    (dict(codec="auto"), "item 6"),
    (dict(collective="hierarchical"), "item 4"),
    (dict(collective="auto"), "item 6"),
    (dict(aggregation="ring"), "not ported"),
    (dict(fastpath="always"), "unknown fastpath"),
    (dict(sparsifier_cfg=SparsifierConfig(kind="hard_threshold"),
          collective="sparse_allgather"), "hard_threshold"),
])
def test_unsupported_options_raise(kw, match):
    with pytest.raises(ValueError, match=match):
        _sim(**kw)


def test_cost_methods_wait_for_comm_cost():
    sim = _sim()
    with pytest.raises(NotImplementedError, match="item 3"):
        sim.wire_bytes_per_round()
    with pytest.raises(NotImplementedError, match="items 3 and 6"):
        sim.round_timeline()


def test_full_participation_schedule_is_accepted():
    class _Full:
        is_full = True

    assert _sim(participation=_Full()).n_workers == 4


def test_cuda_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _sim(device="cuda")
