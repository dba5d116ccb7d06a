"""Tensor parallelism for the encoder-decoder family (``models.encdec``
under a ``ModelShard``: the encoder's attention and MLP, the decoder's
self-attention, cross-attention and MLP, the vocabulary-parallel
embedding and logits).

* The trainer: whisper-tiny's smoke variant (2 + 2 layers, 4 heads of 2
  kv heads, d_ff 256, a padded vocabulary of 512, 16 encoder frames) at
  ``(2, 2)`` (every axis split) with ``remat`` on both sides, so the
  collectives run again inside each recomputed block, and at ``(1, 4)``
  (one query head a rank, the 2 kv heads whole: each rank takes its
  query head's kv head of the whole keys and values, over the 16 frames
  of the encoder output in the cross-attention, against the decoder's
  12 tokens). Three steps of RegTop-k at S = 0.01 and Adam on 4 gloo
  ranks against the jitted JAX trainer on the same mesh from the same
  weights (the JAX package's ``init``; each case in its own subprocess of
  8 host devices, both started before the ranks and run while they run;
  one subprocess running both took 44 s alone on an 8-core host): losses,
  parameters and ``eps`` to rtol 1e-5 with a floor of 1e-5 of a leaf's
  largest magnitude, ``sent_idx`` per (worker, shard) as sets, round
  counters exactly; each rank holds exactly its blocks of the split
  leaves, and every whole leaf (every LayerNorm) is equal in bits on
  every rank.
* ``core.distributed.model_shard`` splits ``{heads, kv_heads, mlp,
  vocab}`` at whisper-tiny's published widths at M = 2 and ``{mlp,
  vocab}`` at M = 4 (6 heads), and the trainer names the tensor-parallel
  path, with no spawn.
* The dry run (``launch.dryrun.count_layout``) counts the
  tensor-parallel step's model-group bytes exactly at ``(2, 2)``,
  each decoder layer's entry of the encoder output included, and less
  memory and fewer FLOPs than the whole forward at the same layout.

Every wait is bounded at 120 s (the JAX subprocess at 300 s).
"""
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_model_parallel import _close, _flatten, _nest, _section

ROOT = Path(__file__).resolve().parents[1]
ARCH = "whisper-tiny"
SPARSITY, LR, STEPS, RTOL = 0.01, 1e-3, 3, 1e-5
B, S = 4, 12  # S differs from the smoke variant's 16 encoder frames
# name -> ((data, model), remat, the logical axes the model axis splits)
CASES = {
    "encdec-2x2": ((2, 2), True, {"heads", "kv_heads", "mlp", "vocab"}),
    "encdec-1x4": ((1, 4), False, {"heads", "mlp", "vocab"}),
}


def _cfg(pkg, name):
    import importlib

    cfg = importlib.import_module(f"{pkg}.configs").get_config(
        ARCH).smoke_variant()
    return cfg.replace(remat=CASES[name][1])


def _batches(cfg):
    rng = np.random.default_rng(11)
    return [{"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "frames": rng.standard_normal(
                 (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)}
            for _ in range(STEPS)]


# ---------------------------------------------------------------------------
# the JAX side: each case in its own subprocess of 8 host devices
# ---------------------------------------------------------------------------
def _jax_case(name, out_dir):
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.core import distributed as jd
    from repro.core.sparsify import SparsifierConfig
    from repro.models import get_family
    from repro.optim import OptConfig, make_optimizer

    (W, M), _, _ = CASES[name]
    cfg = _cfg("repro", name)
    mesh = jax.make_mesh((W, M), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto),
                         devices=jax.devices()[:W * M])
    dist = jd.DistConfig(
        sparsifier=SparsifierConfig(kind="regtopk", sparsity=SPARSITY),
        optimizer=OptConfig(kind="adam", learning_rate=LR),
        dp_axes=("data",))
    mod = get_family(cfg)
    asm = jd.assemble(mod, cfg, dist, mesh)
    params, _ = mod.init(jax.random.PRNGKey(0), cfg)
    p0 = _flatten(jax.tree.map(np.asarray, params))
    opt_state = make_optimizer(dist.optimizer).init(params)
    sp, _ = jd.init_sparsifier_state(asm.plan, W, mesh, ("data",), jnp.float32)
    step = jax.jit(asm.train_step)
    losses = []
    with mesh:
        for b in _batches(cfg):
            params, opt_state, sp, m = step(params, opt_state, sp,
                                            jax.tree.map(jnp.asarray, b))
            losses.append(float(m["loss"]))
    np.savez(f"{out_dir}/{name}.npz", losses=np.array(losses),
             **{f"p0/{k}": v for k, v in p0.items()},
             **{f"params/{k}": v for k, v in
                _flatten(jax.tree.map(np.asarray, params)).items()},
             **{f"state/{k}": v for k, v in
                _flatten(jax.tree.map(np.asarray, sp)).items()})


@pytest.fixture(scope="module")
def p0s():
    """Each case's weights from the JAX package's ``init``, as numpy (the
    subprocess draws the same from the same key)."""
    import jax

    from repro.models import get_family

    cfg = _cfg("repro", next(iter(CASES)))  # remat draws nothing
    params, _ = get_family(cfg).init(jax.random.PRNGKey(0), cfg)
    p0 = _flatten(jax.tree.map(np.asarray, params))
    return {name: p0 for name in CASES}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Starts each case's JAX run in its own subprocess and returns a
    function that waits for them (300 s at most) and loads the runs, so
    the port's ranks run meanwhile."""
    out = tmp_path_factory.mktemp("jax_tp_encdec")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs = {name: subprocess.Popen(
        [sys.executable, __file__, str(out), name], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in CASES}
    runs = {}

    def wait():
        for name, proc in procs.items():
            if name not in runs:
                log, _ = proc.communicate(timeout=300)
                assert proc.returncode == 0, log
                runs[name] = dict(np.load(out / f"{name}.npz"))
        return runs

    yield wait
    for proc in procs.values():
        proc.kill()
        proc.wait()


# ---------------------------------------------------------------------------
# the port on a rank
# ---------------------------------------------------------------------------
def _port_case(name, p0, groups):
    """Three steps of case ``name`` on this rank of ``groups``, tensor
    parallel from its blocks of ``p0``: the losses, the params gathered
    whole, the state of every (worker, shard) in the JAX layout, the axes
    the shard splits, each leaf's (held, block, whole) shapes and the bits
    of the whole leaves."""
    from repro_torch import convert
    from repro_torch.core import distributed as td
    from repro_torch.core.sparsify import SparsifierConfig
    from repro_torch.launch import train
    from repro_torch.models import param_axes
    from repro_torch.nn.sharding import shard_params, unshard_params
    from repro_torch.optim import OptConfig, make_optimizer
    from repro_torch.tree import tree_items, tree_map

    (W, M), _, _ = CASES[name]
    cfg = _cfg("repro_torch", name)
    dist = td.DistConfig(
        sparsifier=SparsifierConfig(kind="regtopk", sparsity=SPARSITY),
        optimizer=OptConfig(kind="adam", learning_rate=LR))
    whole = convert.params_from_jax(_nest(p0), device="cpu")
    plan = td.build_plan(whole, SPARSITY, dist, axes=param_axes(cfg),
                         mesh={"data": W, "model": M})
    specs = tree_map(lambda p: p.spec, plan)
    shard = td.model_shard(cfg, plan, groups.model_group, groups.shard)
    params = shard_params(whole, specs, groups.shard, M)
    step = td.make_train_step(cfg, dist, plan, W, mesh=groups)
    opt_state = make_optimizer(dist.optimizer).init(params)
    sp = td.init_sparsifier_state(plan, 1, "cpu", shards=1)
    losses = []
    for b in _batches(cfg):
        batch = {k: torch.from_numpy(v) for k, v in b.items()}
        batch = {k: v if k == "frames" else v.long() for k, v in batch.items()}
        params, opt_state, sp, m = step(params, opt_state, sp, batch)
        losses.append(float(m["loss"]))
    items = [(path, x, p) for (path, x), (_, p) in zip(
        tree_items(params), tree_items(plan), strict=True)]
    return {
        "losses": losses,
        "split": set(shard.split),
        "params": unshard_params(params, specs, groups.model_group, M),
        "state": convert.trainer_state_to_jax(train._all_workers(sp, groups),
                                              plan),
        "shapes": {path: (tuple(x.shape), p.local_shape, p.global_shape)
                   for path, x, p in items},
        "whole": {path: x.contiguous().view(torch.int32).numpy().tobytes()
                  for path, x, p in items if td.split_dim(p) is None},
    }


def _rank(rank, world, store, out_dir, p0s):
    """One of the 4 ranks: every case in turn; each rank saves its
    results."""
    import torch.distributed as dist

    from repro_torch.launch import mesh

    mesh.init_file_store(store, rank, world, "gloo")
    try:
        out = {name: _port_case(name, p0s[name],
                                mesh.make_host_groups(model=M))
               for name, ((_, M), _, _) in CASES.items()}
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks_out(jax_runs, p0s, tmp_path_factory):
    from repro_torch.core.compact import CompactState
    from repro_torch.launch import mesh

    d = tmp_path_factory.mktemp("ranks_tp_encdec")
    mesh.spawn(_rank, 4, (str(d / "store"), str(d), p0s), timeout=120)
    with torch.serialization.safe_globals([CompactState]):
        return [torch.load(d / f"rank{r}.pt") for r in range(4)]


@pytest.mark.parametrize("name", list(CASES))
def test_four_ranks_match_jax(jax_runs, p0s, ranks_out, name):
    from repro_torch.tree import tree_items

    (W, M), _, split = CASES[name]
    run, want = ranks_out[0][name], jax_runs()[name]
    jp0 = _section(want, "p0")  # both sides started from the same weights
    assert jp0.keys() == p0s[name].keys(), name
    assert all(np.array_equal(jp0[k], v) for k, v in p0s[name].items()), name
    assert run["split"] == split, name
    np.testing.assert_allclose(run["losses"], want["losses"], rtol=RTOL,
                               err_msg=name)
    jparams = _section(want, "params")
    for path, leaf in tree_items(run["params"]):
        _close(leaf.numpy(), jparams[path], f"{name} {path}")
    jstate = _section(want, "state")
    for path, st in tree_items(run["state"]):
        where = f"{name} {path}"
        np.testing.assert_array_equal(st.t.numpy(), jstate[f"{path}:t"],
                                      err_msg=where)
        _close(st.eps.numpy(), jstate[f"{path}:eps"], where)
        idx, jidx = st.sent_idx.numpy(), jstate[f"{path}:sent_idx"]
        for w in range(W):
            for m in range(M):
                assert sorted(idx[w, m]) == sorted(jidx[w, m]), (where, w, m)
    for o in ranks_out:  # each rank: its blocks, and the whole leaves in bits
        shapes = o[name]["shapes"]
        assert all(held == tuple(block) for held, block, _ in shapes.values())
        assert sum(math.prod(h) for h, _, _ in shapes.values()) < sum(
            math.prod(g) for _, _, g in shapes.values())
        assert o[name]["whole"] == run["whole"], name
    blocks = {path for path, (_, block, whole) in run["shapes"].items()
              if tuple(block) != tuple(whole)}
    kv = {"wk", "wv"}
    for site in ("enc_layers.attn", "dec_layers.self", "dec_layers.cross"):
        assert {f"{site}.wq", f"{site}.wo"} <= blocks, (name, site)
        # (1, 4): the 2 kv heads stay whole while the 4 query heads split
        assert ({f"{site}.{w}" for w in kv} <= blocks) == (M == 2), (name, site)
    for stack in ("enc_layers", "dec_layers"):
        assert {f"{stack}.mlp.wu", f"{stack}.mlp.wd"} <= blocks, name
    norms = {f"enc_layers.norm{i}.{w}" for i in (1, 2)
             for w in ("scale", "bias")}
    norms |= {f"dec_layers.norm{i}.{w}" for i in (1, 2, 3)
              for w in ("scale", "bias")}
    norms |= {f"{n}.{w}" for n in ("enc_norm", "final_norm")
              for w in ("scale", "bias")}
    assert norms <= set(run["whole"]), (name, norms - set(run["whole"]))
    assert "embed.embedding" in blocks, name


# ---------------------------------------------------------------------------
# the published widths' layouts, with no spawn
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("M, split", [
    (2, {"heads", "kv_heads", "mlp", "vocab"}),
    (4, {"mlp", "vocab"}),
])
def test_model_shard_at_published_widths(M, split):
    """whisper-tiny's 6 heads split over a model axis of 2 and stay whole
    over 4, where its MLPs and vocabulary still split; the trainer's
    ``model axis:`` line across ranks names the tensor-parallel path."""
    from repro_torch import configs, models
    from repro_torch.core import distributed as td
    from repro_torch.core.sparsify import SparsifierConfig
    from repro_torch.launch import train

    cfg = configs.get_config(ARCH)
    dist = td.DistConfig(
        sparsifier=SparsifierConfig(kind="regtopk", sparsity=SPARSITY))
    params = models.get_family(cfg).init(cfg, device="meta")
    plan = td.build_plan(params, SPARSITY, dist, axes=models.param_axes(cfg),
                         mesh={"data": 1, "model": M})
    shard = td.model_shard(cfg, plan, None, 0)
    assert shard is not None and shard.size == M
    assert set(shard.split) == split
    line = train._model_axis_line(cfg, plan, object(), shard)  # across ranks
    assert line.startswith(f"model axis: tensor parallel over {M} ranks — "), line


# ---------------------------------------------------------------------------
# the dry run counts the tensor-parallel step, with no spawn
# ---------------------------------------------------------------------------
def test_dry_run_counts_the_tensor_parallel_step(monkeypatch):
    """``launch.dryrun.count_layout`` at ``(2, 2)`` on the smoke fields
    traces one rank's tensor-parallel step: its blocks, and the model
    group's bytes as ``nn.layers``' docstrings count them. An encoder
    layer: the attention's two entries (q's and the kv's) and the MLP's
    entry backward, the attention output and the MLP output forward, on
    the encoder's activation. A decoder layer: the same for its
    self-attention and MLP, and for its cross-attention q's entry
    backward and its output forward, all on the decoder's activation,
    and the encoder output's entry backward, on the encoder's. The
    lookup forward and the unembedding's input backward, on the
    decoder's; the logits gathered. Without tensor parallelism the same
    layout holds more and gathers the aggregates instead."""
    from repro_torch import configs
    from repro_torch.core import distributed as td
    from repro_torch.core.sparsify import SparsifierConfig
    from repro_torch.launch import dryrun
    from repro_torch.models import encdec

    cfg = configs.get_config(ARCH).smoke_variant()
    dist = td.DistConfig(
        sparsifier=SparsifierConfig(kind="regtopk", sparsity=SPARSITY))
    lay = dryrun.layout_of(cfg, dist, {"data": 2, "model": 2}, 4, 16)
    rec = dryrun.count_layout(lay)
    E = cfg.d_model
    act = lay.rows * lay.seq * E  # the decoder's activation, in words
    enc = lay.rows * cfg.enc_seq * E  # the encoder's
    reduced = (cfg.n_enc_layers * 5 * enc + cfg.n_layers * (7 * act + enc)
               + 2 * act)
    gathered = lay.rows * lay.seq * cfg.padded_vocab
    coll = rec["collectives"][1]
    assert coll["all-reduce:model"] == 4 * reduced
    assert coll["all-gather:model"] == 4 * gathered
    monkeypatch.setattr(encdec, "TENSOR_PARALLEL", frozenset())
    whole = dryrun.count_layout(lay)
    assert "all-reduce:model" not in whole["collectives"][1]
    assert rec["rank_bytes"] < whole["rank_bytes"]
    assert rec["cost"]["peak_bytes"] < whole["cost"]["peak_bytes"]
    assert rec["cost"]["flops"] < whole["cost"]["flops"]


if __name__ == "__main__":
    _jax_case(sys.argv[2], sys.argv[1])
