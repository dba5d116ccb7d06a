"""The trainer across ranks: one worker per rank over ``torch.distributed``
(gloo, the CPU), against the JAX package's per-worker round and the
port's one-card trainer.

* The per-rank round (``make_sparsify_aggregate(..., mesh=...)``), two
  rounds at N = 2 and 4 on a fused leaf of 3·8192+17 elements and a small
  one, against ``repro.core.distributed._spa_leaf`` under
  ``jax.vmap(axis_name="data")``: the JAX runtime's own per-worker round
  (fastpath off there: its fused path equals its dense path bit for bit,
  and its interpret-mode kernel would take a minute to compile). The
  aggregate and ``eps``, ``sent_idx``, ``sent_g``, ``sent_w`` in f32 bits,
  except where ``all_reduce`` sums more than two ranks in the backend's
  order (``dense_allreduce``, ``hierarchical``'s inner stage and kind
  "none" at N = 4): there the aggregate and ``sent_g`` to rtol 1e-6 with
  a floor of 1e-6 of the largest magnitude (kind "none" sums four dense
  gradients, which cancel to near zero at some coordinates), every rank
  holding the same bits.
* Three steps of the tiny model of ``tests/test_torch_train.py`` at two
  ranks against the one-card ``--workers 2`` run: losses, params and
  each rank's state against its worker's to that file's tolerances (rtol
  1e-5 with a floor of 1e-5 of a leaf's largest magnitude: the CPU
  backward is not deterministic), and the ranks' params equal in bits.
* ``torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train
  --smoke --device cpu``: only rank 0 prints, and its losses, printed to
  4 places, are the one-card run's.

Ranks are spawned once per world size, every case of that size in the
one spawn; each process group starts from a file under ``tmp_path`` (no
fixed port), and every wait is bounded (120 s). The rank bodies are
module-level functions and this file imports ``jax`` and ``repro`` only
inside the tests, so a spawned rank loads no JAX.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"big": (3 * 8192 + 17,), "small": (4, 33)}
SPARSITY, ROUNDS = 0.005, 2
# name -> (kind, codec, collective, weighting, the port's fastpath)
ROUND_CASES = {
    "coo_fp32": ("regtopk", "coo_fp32", "sparse_allgather", "worker", "on"),
    "idx_delta-hierarchical": ("regtopk", "coo_idx_delta", "hierarchical",
                               "worker", "off"),
    "q8-coordinate": ("regtopk", "coo_q8", "sparse_allgather", "coordinate",
                      "off"),
    "dense_allreduce": ("regtopk", "coo_fp32", "dense_allreduce", "worker",
                        "off"),
    "none": ("none", "coo_fp32", "sparse_allgather", "worker", "off"),
}
TINY = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            head_dim=16, d_ff=128, vocab=256)
STEPS, LR, TRAIN_SPARSITY, RTOL = 3, 1e-3, 0.01, 1e-5
# name -> DistConfig fields of the trainer runs
TRAIN_CASES = {
    "fastpath": dict(fastpath="on"),
    "dense_allreduce": dict(collective="dense_allreduce"),
}
AUTO_FLAGS = ["--smoke", "--steps", "2", "--seq", "16", "--fastpath", "auto",
              "--device", "cpu", "--log-every", "100"]


def _grads(n):
    """Each round's ``{leaf: [N, *shape]}`` gradients."""
    rng = np.random.default_rng(17 + n)
    return [{name: rng.standard_normal((n, *s)).astype(np.float32)
             for name, s in SHAPES.items()} for _ in range(ROUNDS)]


def _batches():
    rng = np.random.default_rng(11)
    return [{key: rng.integers(0, TINY["vocab"], (4, 16)) for key in
             ("tokens", "labels")} for _ in range(STEPS)]


def _dist(kind, codec, collective, weighting, fastpath):
    from repro_torch.core import distributed as td
    from repro_torch.core.sparsify import SparsifierConfig

    return td.DistConfig(
        sparsifier=SparsifierConfig(kind=kind, sparsity=SPARSITY, mu=1.0),
        codec=codec, collective=collective, weighting=weighting,
        fastpath=fastpath)


def _train(mesh=None, workers=2, **fields):
    """Three steps of the tiny model: (losses, params, sparsifier state)."""
    from repro_torch.core import distributed as td
    from repro_torch.core.sparsify import SparsifierConfig
    from repro_torch.models import lm
    from repro_torch.models.config import ModelConfig
    from repro_torch.optim import OptConfig, make_optimizer

    cfg = ModelConfig(**TINY)
    dist = td.DistConfig(
        sparsifier=SparsifierConfig(kind="regtopk", sparsity=TRAIN_SPARSITY),
        optimizer=OptConfig(kind="adam", learning_rate=LR), **fields)
    params = lm.init(cfg, seed=0, device="cpu")
    plan = td.build_plan(params, TRAIN_SPARSITY, dist)
    step = td.make_train_step(cfg, dist, plan, workers, mesh=mesh)
    opt_state = make_optimizer(dist.optimizer).init(params)
    sp = td.init_sparsifier_state(plan, 1 if mesh else workers, "cpu")
    losses = []
    for b in _batches():
        batch = {key: torch.from_numpy(v).long() for key, v in b.items()}
        params, opt_state, sp, m = step(params, opt_state, sp, batch)
        losses.append(float(m["loss"]))
    return losses, params, sp


def _rank(rank, world, store, out_dir):
    """One rank: every round case of this world size and, at two ranks,
    the trainer runs; results saved to ``out_dir/rank{rank}.pt``."""
    import torch.distributed as dist

    from repro_torch.comm.fastpath import FastpathCounts
    from repro_torch.core import distributed as td
    from repro_torch.launch import mesh, train
    from repro_torch.tree import tree_leaves

    mesh.init_file_store(store, rank, world, "gloo")
    try:
        host = mesh.make_host_groups()
        out = {"rounds": {}, "train": {}}
        for name, case in ROUND_CASES.items():
            dcfg = _dist(*case)
            plan = td.build_plan({n: torch.zeros(s) for n, s in SHAPES.items()},
                                 SPARSITY, dcfg)
            counts = FastpathCounts()
            spa = td.make_sparsify_aggregate(plan, dcfg, world, counts, host)
            state = td.init_sparsifier_state(plan, 1, "cpu")
            rounds = []
            for g in _grads(world):
                agg, state = spa({n: torch.from_numpy(x[rank:rank + 1])
                                  for n, x in g.items()}, state)
                rounds.append((agg, state))
            out["rounds"][name] = (rounds, counts.rounds,
                                   {n: p.fused for n, p in plan.items()})
        if world == 2:
            for name, fields in TRAIN_CASES.items():
                out["train"][name] = _train(host, **fields)
            res = train.run(train.parse_args(AUTO_FLAGS), mesh=host)
            out["auto"] = (res.losses,
                           [p.fused for p in tree_leaves(res.plan)])
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks_out(tmp_path_factory):
    """World size -> every rank's results, one spawn per size."""
    from repro_torch.core.compact import CompactState
    from repro_torch.launch import mesh

    out = {}
    for n in (2, 4):
        d = tmp_path_factory.mktemp(f"ranks{n}")
        mesh.spawn(_rank, n, (str(d / "store"), str(d)), timeout=120)
        with torch.serialization.safe_globals([CompactState]):
            out[n] = [torch.load(d / f"rank{r}.pt") for r in range(n)]
    return out


def _jax_rounds(n, kind, codec, collective, weighting):
    """The JAX runtime's per-worker round (``_spa_leaf``) for the N
    workers under ``jax.vmap(axis_name="data")``, ROUNDS rounds: per round
    ``{leaf: (agg [N, *shape], state with a leading [N] axis)}``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.comm import codec as jcodec
    from repro.core import compact as jc
    from repro.core import distributed as jd
    from repro.core.selectors import sparsity_to_k
    from repro.core.sparsify import SparsifierConfig

    scfg = SparsifierConfig(kind=kind, sparsity=SPARSITY, mu=1.0, omega=1.0 / n)
    plans = {name: jd.LeafPlan(s, s, int(np.prod(s)),
                               sparsity_to_k(int(np.prod(s)), SPARSITY), P(None))
             for name, s in SHAPES.items()}

    def init(p):
        st = jc.compact_init(p.local_len, p.k)
        one = jc.CompactState(
            eps=st.eps.reshape((1,) + p.local_shape),
            sent_vals=st.sent_vals[None, None], sent_g=st.sent_g[None, None],
            sent_idx=st.sent_idx[None, None], sent_w=st.sent_w[None, None],
            t=st.t[None])
        return jax.tree.map(lambda x: jnp.stack([x] * n), one)

    def worker(g, st):
        return {name: jd._spa_leaf(g[name], st[name], p, scfg,
                                   jcodec.get_codec(codec), collective,
                                   ("data",), weighting=weighting)
                for name, p in plans.items()}

    step = jax.jit(jax.vmap(worker, axis_name="data"))
    state = {name: init(p) for name, p in plans.items()}
    out = []
    for g in _grads(n):
        res = step({name: jnp.asarray(x[:, None]) for name, x in g.items()},
                   state)
        state = {name: r[1] for name, r in res.items()}
        out.append(res)
    return out


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", list(ROUND_CASES))
def test_rank_round_matches_jax_spa_leaf(ranks_out, case, n):
    kind, codec, collective, weighting, fastpath = ROUND_CASES[case]
    want = _jax_rounds(n, kind, codec, collective, weighting)
    # all_reduce over more than two ranks sums in the backend's order
    exact = n <= 2 or collective == "sparse_allgather" and kind != "none"
    for r in range(n):
        rounds, fused_rounds, fused = ranks_out[n][r]["rounds"][case]
        if fastpath == "on":
            assert fused["big"] and fused_rounds == ROUNDS * sum(fused.values())
        for t, ((agg, st), jres) in enumerate(zip(rounds, want, strict=True)):
            for name, s in SHAPES.items():
                jagg, jst = jres[name]
                msg = f"{case} rank {r} round {t} {name}"
                first = ranks_out[n][0]["rounds"][case][0][t][0][name]
                np.testing.assert_array_equal(_bits(agg[name]), _bits(first),
                                              err_msg=f"{msg}: rank vs rank 0")
                assert agg[name].shape == s
                assert np.count_nonzero(agg[name].numpy()) > 0
                pairs = {"agg": (agg[name].numpy(), jagg[r])}
                if kind != "none":
                    pairs.update(
                        {f: (getattr(st[name], f)[0].numpy(),
                             np.asarray(getattr(jst, f)[r]).reshape(-1))
                         for f in ("eps", "sent_g", "sent_w")})
                    np.testing.assert_array_equal(
                        st[name].sent_idx[0].numpy(),
                        np.asarray(jst.sent_idx[r]).reshape(-1), err_msg=msg)
                np.testing.assert_array_equal(
                    st[name].t.numpy(), np.asarray(jst.t[r]), err_msg=msg)
                for f, (got, exp) in pairs.items():
                    if exact or f in ("eps", "sent_w"):
                        np.testing.assert_array_equal(
                            _bits(got), _bits(np.reshape(exp, got.shape)),
                            err_msg=f"{msg} {f}")
                    else:  # a floor where four summands cancel
                        np.testing.assert_allclose(
                            got, np.reshape(exp, got.shape), rtol=1e-6,
                            atol=1e-6 * np.abs(exp).max(), err_msg=f"{msg} {f}")


def _close(got, want, msg):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max(), err_msg=msg)


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_two_rank_trainer_matches_one_card(ranks_out, case):
    from repro_torch.tree import tree_items

    losses, params, sp = _train(**TRAIN_CASES[case])
    runs = [ranks_out[2][r]["train"][case] for r in range(2)]
    for r, (rlosses, rparams, rsp) in enumerate(runs):
        assert rlosses == runs[0][0]
        np.testing.assert_allclose(rlosses, losses, rtol=RTOL)
        for (path, got), (_, first), (_, want) in zip(
                tree_items(rparams), tree_items(runs[0][1]), tree_items(params),
                strict=True):
            np.testing.assert_array_equal(_bits(got), _bits(first),
                                          err_msg=f"{path}: rank {r} vs rank 0")
            _close(got.numpy(), want.numpy(), path)
        for (path, got), (_, want) in zip(tree_items(rsp), tree_items(sp),
                                          strict=True):
            np.testing.assert_array_equal(got.t.numpy(), want.t[r:r + 1].numpy())
            _close(got.eps.numpy(), want.eps[r:r + 1].numpy(), f"{path}.eps")
            # sent sets by index: scores one ulp apart may list in either order
            np.testing.assert_array_equal(
                np.sort(got.sent_idx.numpy()[0]), np.sort(want.sent_idx.numpy()[r]),
                err_msg=path)


def test_fastpath_auto_across_ranks_builds_one_plan(ranks_out):
    """``--fastpath auto`` across ranks: rank 0's table is broadcast, every
    rank builds the same plan (on the CPU auto fuses nothing), and the run
    is the one-card run."""
    from repro_torch.launch import train

    (l0, plan0), (l1, plan1) = (ranks_out[2][r]["auto"] for r in range(2))
    assert plan0 == plan1 and not any(plan0)
    assert l0 == l1
    one_card = train.run(train.parse_args([*AUTO_FLAGS, "--workers", "2"]))
    np.testing.assert_allclose(l0, one_card.losses, rtol=RTOL)


def test_torchrun_two_ranks_on_the_cpu():
    """The CLI under ``torchrun``: two ranks, only rank 0 prints, and the
    logged losses are the one-card ``--workers 2`` run's."""
    from repro_torch.launch import train

    flags = ["--smoke", "--steps", "3", "--seq", "16", "--fastpath", "on",
             "--log-every", "1"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *flags,
         "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=120, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("comm: codec=coo_fp32") == 1
    assert "ranks: 2 over gloo, dp axes {'data': 2}" in out.stdout
    logged = [float(x) for x in re.findall(r"^step +\d+ loss (\S+)", out.stdout,
                                           re.M)]
    one_card = train.run(train.parse_args([*flags, "--workers", "2",
                                            "--device", "cpu"])).losses
    # printed to 4 places: half a unit of the print, and rtol 1e-5 (the
    # CPU backward is not deterministic)
    assert len(logged) == len(one_card)
    for got, want in zip(logged, one_card, strict=True):
        assert abs(got - want) <= 5e-5 + RTOL * abs(want)


def test_ranks_refuse_partial_participation_naming_item_6():
    """Partial participation stays ROADMAP queue 1 item 6, across ranks as
    on one card."""
    from repro_torch.comm import get_codec, get_collective

    codec = get_codec("coo_fp32")
    payload = codec.encode(torch.ones(1, 2), torch.zeros(1, 2).long(), 4)
    for name in ("sparse_allgather", "hierarchical", "dense_allreduce"):
        for fn in ("shard", "shard_coord"):
            with pytest.raises(ValueError, match="item 6"):
                getattr(get_collective(name), fn)(
                    codec, payload, 4, (), 0.5, participation=torch.ones(1))


def test_trainer_checks_workers_against_the_layout():
    """Across ranks W is the number of ranks in the dp layout."""
    from repro_torch.core import distributed as td
    from repro_torch.launch.mesh import DpGroups

    dcfg = dataclasses.replace(_dist(*ROUND_CASES["coo_fp32"]), fastpath="off")
    plan = td.build_plan({"w": torch.zeros(8)}, SPARSITY, dcfg)
    with pytest.raises(ValueError, match="W is the number of ranks"):
        td.make_sparsify_aggregate(
            plan, dcfg, 4, mesh=DpGroups(("pod", "data"), (2, 1), (None, None), 0))
