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
  ported raises;
* each codec, ``hierarchical`` and coordinate weighting, 40 rounds
  against the JAX simulator as above, and ``wire_bytes_per_round``
  equal to the JAX package's.
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
    (dict(weighting="coordinate", fastpath="on"), "scalar omega"),
    (dict(weighting="per-worker"), "unknown weighting"),
    (dict(weighting="coordinate",
          sparsifier_cfg=SparsifierConfig(kind="none")), "sparse payloads"),
    (dict(codec="bogus"), "unknown codec"),
    (dict(codec="auto"), "item 6"),
    (dict(dp_shape=(3, 2)), "does not factor"),
    (dict(collective="auto"), "item 6"),
    (dict(aggregation="ring"), "unknown collective"),
    (dict(fastpath="always"), "unknown fastpath"),
    (dict(sparsifier_cfg=SparsifierConfig(kind="hard_threshold"),
          collective="sparse_allgather"), "hard_threshold"),
])
def test_unsupported_options_raise(kw, match):
    with pytest.raises(ValueError, match=match):
        _sim(**kw)


def test_cost_methods_wait_for_comm_cost():
    """``wire_bytes_per_round`` is ported with ``comm/cost.py`` (its
    numbers are held against the JAX package's below);
    ``round_timeline`` waits for ``comm/overlap.py`` (ROADMAP queue 1
    item 6)."""
    est = _sim().wire_bytes_per_round()
    assert est.bytes_on_wire > 0 and est.seconds > 0
    with pytest.raises(NotImplementedError, match="item 6"):
        _sim().round_timeline()


def test_full_participation_schedule_is_accepted():
    class _Full:
        is_full = True

    assert _sim(participation=_Full()).n_workers == 4


def test_cuda_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _sim(device="cuda")


WIRE_CASES = [
    ("regtopk", "coo_idx_delta", "sparse_allgather", "worker"),
    ("regtopk", "bitmap_dense", "sparse_allgather", "worker"),
    ("regtopk", "coo_q8", "sparse_allgather", "worker"),
    ("topk", "coo_q8", "sparse_allgather", "worker"),
    ("regtopk", "coo_idx_delta", "hierarchical", "worker"),
    ("regtopk", "coo_fp32", "sparse_allgather", "coordinate"),
    ("regtopk", "coo_q8", "hierarchical", "coordinate"),
    ("regtopk", "coo_fp32", "dense_allreduce", "coordinate"),
    ("topk", "bitmap_dense", "sparse_allgather", "coordinate"),
]


@pytest.mark.parametrize("kind,codec,collective,weighting", WIRE_CASES)
def test_wire_options_match_jax(linreg, kind, codec, collective, weighting):
    """Each codec (``coo_q8``'s residual folded back into the state),
    ``hierarchical`` and coordinate weighting, 40 rounds against the JAX
    simulator: the masks of the first 5 rounds exact, the final theta to
    rtol 1e-4 as in ``test_linreg_matches_jax``; under coordinate
    weighting the last round's sender mass too.

    ``coo_q8`` adds an absolute 1e-3 to theta's tolerance: the two stacks'
    gradients differ in the last ulp (float32 sums in another order), and
    where a value sits on a rounding boundary of the quantizer that moves
    its int8 code by one, one step ``max|v| / 127`` (about 5e-4 here, times
    the learning rate in theta) that error feedback returns over the next
    rounds. The codec itself is bit-equal on equal inputs
    (``test_torch_codec.py``)."""
    jdata, tdata = linreg
    kw = dict(learning_rate=1e-2, codec=codec, collective=collective,
              weighting=weighting)
    jsim = JaxSim(jpipe.linreg_grad_fn(jdata), 4, 64, _cfg(kind, JaxConfig), **kw)
    jfin, jmasks = jsim.run(jnp.zeros(64), 40,
                            trace_state_fn=lambda s: s.worker_states.s_prev)
    tsim = DistributedSim(linreg_grad_fn(tdata), 4, 64, _cfg(kind, SparsifierConfig),
                          device="cpu", **kw)
    tfin, tmasks = tsim.run(torch.zeros(64), 40,
                            trace_state_fn=lambda s: s.worker_states.s_prev)
    np.testing.assert_array_equal(tmasks[:5].numpy(), np.asarray(jmasks)[:5])
    np.testing.assert_allclose(tfin.theta.numpy(), np.asarray(jfin.theta),
                               rtol=1e-4, atol=1e-3 if codec == "coo_q8" else 1e-5)
    if weighting == "coordinate":
        np.testing.assert_allclose(tfin.w_agg_prev.numpy(),
                                   np.asarray(jfin.w_agg_prev), rtol=1e-6)
    else:
        assert tfin.w_agg_prev is None


def test_coordinate_run_continues_from_a_jax_state(linreg):
    """``convert.sim_state_from_jax`` carries ``w_agg_prev``: 20 JAX
    rounds under coordinate weighting, then 5 more in each stack."""
    jdata, tdata = linreg
    kw = dict(learning_rate=1e-2, aggregation="sparse_allgather",
              weighting="coordinate")
    jsim = JaxSim(jpipe.linreg_grad_fn(jdata), 4, 64, _cfg("regtopk", JaxConfig), **kw)
    st = jsim.init(jnp.zeros(64))
    for _ in range(20):
        st, _ = jsim.step_fn(st)
    tsim = DistributedSim(linreg_grad_fn(tdata), 4, 64, _cfg("regtopk", SparsifierConfig),
                          device="cpu", **kw)
    tst = sim_state_from_jax(jax.tree.map(np.asarray, st), device="cpu")
    assert torch.equal(tst.w_agg_prev, torch.from_numpy(np.array(st.w_agg_prev)))
    for _ in range(5):
        st, jg = jsim.step_fn(st)
        tst, tg = tsim.step_fn(tst)
        np.testing.assert_array_equal(
            tst.worker_states.s_prev.numpy(), np.asarray(st.worker_states.s_prev))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sim_state_to_numpy(tst)["w_agg_prev"],
                               np.asarray(st.w_agg_prev), rtol=1e-6)


@pytest.mark.parametrize("codec", ["coo_fp32", "coo_idx_delta", "bitmap_dense", "coo_q8"])
def test_wire_bytes_per_round_matches_jax(codec):
    from repro.comm import cost as jcost
    from repro_torch.comm import cost as tcost

    for coll, dp, model in [
        ("sparse_allgather", None, None),
        ("hierarchical", (2, 2), None),
        ("dense_allreduce", (4,), "scalar"),
        ("hierarchical", (2, 2), "topo"),
        ("sparse_allgather", (1, 4), "topo"),
    ]:
        def link(mod):
            if model == "scalar":
                return dict(link_model=mod.AlphaBeta(2e-6, 5e-12))
            if model == "topo":
                return dict(link_topo=mod.LinkTopo(
                    (mod.AlphaBeta(1e-5, 1e-9), mod.AlphaBeta(1e-6, 1e-11))))
            return {}

        kw = dict(codec=codec, collective=coll, dp_shape=dp)
        jsim = JaxSim(None, 4, 5000, JaxConfig(kind="regtopk", sparsity=0.01),
                      **kw, **link(jcost))
        tsim = _sim(length=5000, sparsifier_cfg=SparsifierConfig(sparsity=0.01),
                    **kw, **link(tcost))
        want, got = jsim.wire_bytes_per_round(), tsim.wire_bytes_per_round()
        assert (got.bytes_on_wire, got.n_messages, got.seconds) == (
            want.bytes_on_wire, want.n_messages, want.seconds)
        m = tcost.AlphaBeta(3e-6, 2e-11)
        assert tsim.wire_bytes_per_round(m).seconds == jsim.wire_bytes_per_round(
            jcost.AlphaBeta(3e-6, 2e-11)).seconds


def test_auto_declines_the_score_kernel_under_coordinate_weighting(monkeypatch):
    """The score kernel takes a scalar omega: on a card, ``"auto"`` would
    install it, and coordinate weighting must keep the plain chain (the
    JAX package's rule), or the first round would raise."""
    from repro_torch.comm import fastpath

    monkeypatch.setattr(fastpath, "backend_supports", lambda device: True)
    assert _sim(fastpath="auto").sparsifier.cfg.score_fn is not None
    assert _sim(fastpath="auto", weighting="coordinate").sparsifier.cfg.score_fn is None
