"""The port's bucketed overlap schedule (``repro_torch.comm.overlap``)
against the JAX package's ``repro.comm.overlap``.

* The planner is host arithmetic: ``parse_overlap``, ``bucketize``,
  ``leaf_cost`` and ``overlap_timeline`` must give the JAX package's
  buckets and stamps with ``==`` (no tolerance), over the Hypothesis
  strategies of ``tests/test_overlap.py`` and the byte bounds, and the
  same errors; the JAX tests' properties hold for the port.
* The round: ``overlap="buckets:B"`` only reorders the independent
  per-leaf rounds, so the trainer's params equal ``"off"``'s in f32 bits
  (with a genuine reorder forced through synthetic costs, as the JAX test
  does, and with the real costs under ``codec="auto"``); the train step's
  ``metrics["timeline"]`` equals the JAX ``comm_round_timeline``'s
  stamps. The simulator's one leaf clamps to one bucket: its run equals
  ``"off"`` in bits and ``round_timeline`` equals the JAX simulator's.
"""
import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from repro.comm import overlap as jov
from repro.core import DistributedSim as JaxSim
from repro.core import SparsifierConfig as JaxConfig
from repro.core import distributed as jd
from repro_torch.comm import cost as tcost
from repro_torch.comm import overlap as tov
from repro_torch.core import DistributedSim, SparsifierConfig
from repro_torch.core import distributed as td
from repro_torch.models.config import ModelConfig
from repro_torch.optim import OptConfig, make_optimizer
from repro_torch.tree import tree_items, tree_leaves
import _torch_cores  # noqa: F401  (this worker's share of the cores)

TINY = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            head_dim=16, d_ff=128, vocab=256)


def _raises_alike(fn_j, fn_t):
    """Both raise ValueError with the same message."""
    with pytest.raises(ValueError) as je:
        fn_j()
    with pytest.raises(ValueError) as te:
        fn_t()
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("spec", ["off", " off ", "buckets:1", "buckets:16"])
def test_parse_overlap_matches_jax(spec):
    got, want = tov.parse_overlap(spec), jov.parse_overlap(spec)
    assert (got is None) == (want is None)
    if got is not None:
        assert _fields(got) == _fields(want)


def _fields(cfg):
    return (cfg.n_buckets, cfg.balance_factor, cfg.min_bucket_bytes,
            cfg.max_bucket_bytes)


@pytest.mark.parametrize("spec", ["buckets:0", "buckets:x", "stream", "bogus"])
def test_parse_overlap_errors_match_jax(spec):
    _raises_alike(lambda: jov.parse_overlap(spec), lambda: tov.parse_overlap(spec))


@pytest.mark.parametrize("kw", [
    dict(balance_factor=0.5), dict(min_bucket_bytes=-1),
    dict(min_bucket_bytes=100, max_bucket_bytes=50), dict(n_buckets=0),
])
def test_overlap_config_gates_match_jax(kw):
    _raises_alike(lambda: jov.OverlapConfig(**kw), lambda: tov.OverlapConfig(**kw))


def test_input_gates_match_jax():
    _raises_alike(lambda: jov.bucketize([]), lambda: tov.bucketize([]))
    _raises_alike(
        lambda: jov.bucketize([jov.LeafCost(1, (1.0,)), jov.LeafCost(1, (1.0, 2.0))]),
        lambda: tov.bucketize([tov.LeafCost(1, (1.0,)), tov.LeafCost(1, (1.0, 2.0))]))
    for comp in ([0.1, 0.2], [-1.0]):
        _raises_alike(
            lambda c=comp: jov.overlap_timeline(jov.bucketize([jov.LeafCost(10, (1e-3,))]), c),
            lambda c=comp: tov.overlap_timeline(tov.bucketize([tov.LeafCost(10, (1e-3,))]), c))


def _costs(mod, seconds, n_axes=2):
    """``tests/test_overlap.py``'s costs: each leaf's seconds split 60/40
    over two axes."""
    return [mod.LeafCost(int(1e4 * s) + 1,
                         (0.6 * s, 0.4 * s) if n_axes == 2 else (s,), ("c", "h"))
            for s in seconds]


def _same_plan(seconds, cfg_kw, n_axes=2, compute=None):
    """The port's plan and timeline equal the JAX package's exactly;
    returns the port's."""
    tp = tov.bucketize(_costs(tov, seconds, n_axes), tov.OverlapConfig(**cfg_kw))
    jp = jov.bucketize(_costs(jov, seconds, n_axes), jov.OverlapConfig(**cfg_kw))
    assert [tuple(b) for b in tp.buckets] == [tuple(b) for b in jp.buckets]
    tt, jt = tov.overlap_timeline(tp, compute), jov.overlap_timeline(jp, compute)
    assert tuple(tt) == tuple(jt)
    return tp, tt


_seconds = st.lists(st.floats(min_value=1e-6, max_value=1.0), min_size=1,
                    max_size=24)


@settings(max_examples=40, deadline=None)
@given(_seconds, st.integers(min_value=1, max_value=8))
def test_bucketize_and_timeline_match_jax(seconds, n_buckets):
    """Equal to the JAX plan and stamps, with the JAX tests' properties:
    an exact partition launched in ascending order, the balance bound, and
    a timeline never above the synchronous sum, equal to it at one
    bucket."""
    cfg = dict(n_buckets=n_buckets)
    plan, tl = _same_plan(seconds, cfg)
    assert sorted(plan.leaf_order()) == list(range(len(seconds)))
    firsts = [min(b.leaves) for b in plan.buckets]
    assert firsts == sorted(firsts)
    costs = _costs(tov, seconds)
    ideal = max(sum(c.seconds for c in costs) / plan.n_buckets,
                max(c.seconds for c in costs))
    assert plan.n_buckets == 1 or max(b.seconds for b in plan.buckets) <= (
        plan.config.balance_factor * ideal + 1e-6)
    assert tl.seconds <= tl.sync_seconds + 1e-12
    assert all(a <= b <= c for a, b, c in zip(tl.launch, tl.intra_done, tl.complete))
    _, one = _same_plan(seconds, dict(n_buckets=1))
    assert one.seconds == one.sync_seconds


@settings(max_examples=20, deadline=None)
@given(_seconds, st.integers(min_value=1, max_value=6),
       st.lists(st.floats(min_value=0.0, max_value=1e-2), min_size=6, max_size=6))
def test_timeline_with_compute_matches_jax(seconds, n_buckets, compute):
    plan, _ = _same_plan(seconds, dict(n_buckets=n_buckets), n_axes=1)
    _same_plan(seconds, dict(n_buckets=n_buckets), n_axes=1,
               compute=compute[:plan.n_buckets])


@pytest.mark.parametrize("cfg", [
    dict(n_buckets=3, min_bucket_bytes=1000),
    dict(n_buckets=4, max_bucket_bytes=100),
    dict(n_buckets=5, balance_factor=1.0),
    dict(n_buckets=3, min_bucket_bytes=3000, max_bucket_bytes=6000),
])
def test_byte_bounds_and_balance_match_jax(cfg):
    rng = np.random.default_rng(3)
    for _ in range(20):
        _same_plan(list(rng.uniform(1e-5, 0.05, rng.integers(1, 12))), cfg)


def test_strict_win_and_stage_split_as_jax():
    """Two equal buckets with a dominant inter stage hide one intra stage
    (1 ms), as in the JAX test; a bucket's stages split as JAX's do."""
    _, tl = _same_plan([3e-3, 3e-3], dict(n_buckets=2))
    assert tl.seconds < tl.sync_seconds
    assert np.isclose(tl.sync_seconds - tl.seconds, 1.2e-3)
    b = tov.Bucket(leaves=(0,), seconds=3.0, bytes_on_wire=1, axis_seconds=(2.0, 1.0))
    assert (b.inter_seconds, b.intra_seconds) == (2.0, 1.0)


@pytest.mark.parametrize("dp", [(8,), (2, 4), (1, 2)])
def test_leaf_cost_matches_jax(dp):
    from repro_torch.comm.codec import get_codec

    def models(mod):
        out = [mod.AlphaBeta(), mod.AlphaBeta(2e-6, 5e-12)]
        if len(dp) == 2:
            out.append(mod.LinkTopo((mod.AlphaBeta(1e-4, 2e-10),
                                     mod.AlphaBeta(1e-5, 1e-11))))
        return out

    for tm, jm in zip(models(tcost), models(jd.comm), strict=True):
        for codec in ("coo_fp32", "coo_idx_delta", "bitmap_dense", "coo_q8"):
            for coll in ("sparse_allgather", "hierarchical", "dense_allreduce"):
                for L in (4, 1000, 65536, 1 << 20):
                    for k in (1, max(1, L // 100), L // 2 or 1):
                        for part in (None, 0.75 * np.prod(dp)):
                            got = tov.leaf_cost(codec, coll, L, k, dp, tm,
                                                participants=part)
                            want = jov.leaf_cost(codec, coll, L, k, dp, jm,
                                                 participants=part)
                            assert tuple(got) == tuple(want)
                            # a codec object is priced as its name
                            assert tov.leaf_cost(get_codec(codec), coll, L, k, dp, tm,
                                                 participants=part) == got


# ---------------------------------------------------------------------------
# the round: bucketing reorders, the numbers stay
# ---------------------------------------------------------------------------
def _batches(n, W):
    rng = np.random.default_rng(23)
    return [{key: torch.from_numpy(rng.integers(0, TINY["vocab"], (W, 16))).long()
             for key in ("tokens", "labels")} for _ in range(n)]


def _synthetic_costs(plan, dist, workers):
    """``tests/test_overlap.py``'s nonzero heterogeneous costs: they force
    a multi-bucket schedule in a permuted leaf order."""
    n = len(tree_leaves(plan))
    return [tov.LeafCost(100 * (i + 1), (float(n - i), 1.0), ("c", "h"))
            for i in range(n)]


def _train(overlap, codec, W=2, steps=2, collective="sparse_allgather"):
    """``steps`` steps of the tiny model at W workers on one card: (params,
    last metrics, plan, dist)."""
    from repro_torch.models import lm

    cfg = ModelConfig(**TINY)
    dist = td.DistConfig(
        sparsifier=SparsifierConfig(kind="regtopk", sparsity=0.05, mu=1.0),
        optimizer=OptConfig(kind="adam", learning_rate=3e-3),
        codec=codec, collective=collective, overlap=overlap, fastpath="on")
    params = lm.init(cfg, seed=0, device="cpu")
    plan = td.build_plan(params, 0.05, dist, workers=W)
    step = td.make_train_step(cfg, dist, plan, W)
    opt_state = make_optimizer(dist.optimizer).init(params)
    sp = td.init_sparsifier_state(plan, W, "cpu")
    for b in _batches(steps, W):
        params, opt_state, sp, m = step(params, opt_state, sp, b)
    return params, m, plan, dist


def _bits(x):
    return x.detach().contiguous().view(torch.int32)


@pytest.mark.parametrize("codec", ["coo_fp32", "coo_idx_delta", "coo_q8"])
def test_bucketed_round_bitforbit_with_a_permuted_order(codec, monkeypatch):
    """The JAX test's synthetic costs make three buckets that permute the
    leaves; params equal ``"off"``'s in bits, and each bucket runs in its
    own ``spa_bucketNNN`` profiler range."""
    p_off, m_off, _, _ = _train("off", codec)
    monkeypatch.setattr(td, "_leaf_overlap_costs", _synthetic_costs)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        p_on, m_on, plan, _ = _train("buckets:3", codec, steps=2)
    for (path, a), (_, b) in zip(tree_items(p_off), tree_items(p_on), strict=True):
        assert torch.equal(_bits(a), _bits(b)), path
    assert "timeline" not in m_off
    tl = m_on["timeline"]
    assert tl.shape == (3, 2) and tl.dtype == torch.float32
    assert bool((tl[:, 0] <= tl[:, 1]).all()) and bool((tl[1:, 1] >= tl[:-1, 1]).all())
    names = {e.key for e in prof.key_averages()}
    assert {f"spa_bucket{i:03d}" for i in range(3)} <= names
    order = tov.bucketize(_synthetic_costs(plan, None, 2),
                          tov.OverlapConfig(n_buckets=3)).leaf_order()
    assert list(order) != sorted(order)


@pytest.mark.parametrize("W,codec,collective", [
    (2, "coo_fp32", "sparse_allgather"), (4, "auto", "auto"),
])
def test_bucketed_train_step_matches_off_and_jax_stamps(W, codec, collective):
    """``overlap="buckets:2"`` on the real costs: params equal ``"off"``'s
    in bits, and ``metrics["timeline"]`` equals the JAX
    ``comm_round_timeline``'s f32 (launch, complete) stamps on the same
    plan (each leaf's own wire under ``"auto"``)."""
    p_off, _, _, _ = _train("off", codec, W=W, collective=collective)
    p_on, m_on, plan, dist = _train("buckets:2", codec, W=W, collective=collective)
    for (path, a), (_, b) in zip(tree_items(p_off), tree_items(p_on), strict=True):
        assert torch.equal(_bits(a), _bits(b)), path

    class _Mesh:
        shape = {"data": W}

    jdist = jd.DistConfig(
        sparsifier=JaxConfig(kind="regtopk", sparsity=0.05, mu=1.0),
        codec=codec if codec != "auto" else "coo_fp32",
        collective=collective if collective != "auto" else "sparse_allgather",
        overlap="buckets:2")
    jplan = {path: jd.LeafPlan(p.global_shape, p.global_shape, p.local_len, p.k,
                               None, p.codec, p.collective)
             for path, p in tree_items(plan)}
    _, jtl = jd.comm_round_timeline(jplan, jdist, _Mesh())
    want = np.stack([np.asarray(jtl.launch, np.float32),
                     np.asarray(jtl.complete, np.float32)], axis=1)
    np.testing.assert_array_equal(m_on["timeline"].numpy().view(np.int32),
                                  want.view(np.int32))
    tbp, ttl = td.comm_round_timeline(plan, dist, W)
    assert tuple(ttl) == tuple(jtl)
    assert tbp.n_buckets == 2 and sorted(tbp.leaf_order()) == list(range(len(jplan)))


def test_comm_round_timeline_gates_as_jax():
    plan = {"w": td.LeafPlan((64,), 64, 4)}
    base = dict(sparsifier=SparsifierConfig(kind="regtopk", sparsity=0.05, mu=1.0))
    off = td.DistConfig(**base)
    assert off.resolved_overlap() is None
    with pytest.raises(ValueError, match="overlap != 'off'"):
        td.comm_round_timeline(plan, off, 1)
    bplan, tl = td.comm_round_timeline(plan, td.DistConfig(overlap="buckets:2", **base), 1)
    assert bplan.n_leaves == 1 and tl.seconds <= tl.sync_seconds + 1e-12
    with pytest.raises(ValueError, match="unknown overlap spec"):
        td.DistConfig(overlap="bogus", **base).resolved_overlap()


# ---------------------------------------------------------------------------
# the simulator
# ---------------------------------------------------------------------------
def _topo(mod):
    return mod.LinkTopo((mod.AlphaBeta(1e-5, 1e-9), mod.AlphaBeta(1e-6, 1e-10)))


_SIM = dict(codec="coo_fp32", collective="hierarchical", dp_shape=(2, 4))


def _jsim(**kw):
    return JaxSim(lambda th, w: th + w, 8, 2048,
                  JaxConfig(kind="regtopk", sparsity=0.02, mu=1.0),
                  link_topo=_topo(jd.comm), **_SIM, **kw)


def _tsim(**kw):
    """``tests/test_overlap.py``'s simulator: worker w's gradient is
    ``theta + w``."""
    return DistributedSim(lambda th, w: th[None] + w[:, None].to(th.dtype), 8, 2048,
                          SparsifierConfig(kind="regtopk", sparsity=0.02, mu=1.0),
                          link_topo=_topo(tcost), device="cpu", **_SIM, **kw)


def test_sim_overlap_bitforbit_and_timeline_matches_jax():
    """The JAX test's simulator: four rounds with ``buckets:4`` equal
    ``"off"``'s in bits; ``round_timeline`` equals the JAX simulator's
    (one bucket) and prices ``wire_bytes_per_round``'s seconds."""
    off, on, jsim = _tsim(), _tsim(overlap="buckets:4"), _jsim(overlap="buckets:4")
    _, tr_off = off.run(torch.zeros(2048), 4)
    _, tr_on = on.run(torch.zeros(2048), 4)
    assert torch.equal(_bits(tr_off), _bits(tr_on))
    (bplan, tl), (jbplan, jtl) = on.round_timeline(), jsim.round_timeline()
    assert bplan.n_buckets == 1
    assert [tuple(b) for b in bplan.buckets] == [tuple(b) for b in jbplan.buckets]
    assert tuple(tl) == tuple(jtl)
    assert np.isclose(tl.sync_seconds, on.wire_bytes_per_round().seconds, rtol=1e-9)
    assert tuple(on.round_timeline([1e-3])[1]) == tuple(jsim.round_timeline([1e-3])[1])


@pytest.mark.parametrize("kw,match", [
    (dict(overlap="stream"), "unknown overlap spec"),
    (dict(overlap="buckets:0"), "n_buckets must be >= 1"),
])
def test_sim_overlap_gates_as_jax(kw, match):
    _raises_alike(lambda: _jsim(**kw), lambda: _tsim(**kw))
    with pytest.raises(ValueError, match=match):
        _tsim(**kw)
    _raises_alike(lambda: _jsim().round_timeline(), lambda: _tsim().round_timeline())
