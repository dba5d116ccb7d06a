"""Tensor parallelism over the model group (``nn/tensor_parallel.py``, the
shard-aware layers, ``nn.sharding.shard_params``/``unshard_params`` and
the trainer's tensor-parallel path in ``core/distributed.py``).

* Each Function of ``nn.tensor_parallel`` (``enter``, ``leave``,
  ``gather_last``), through the layers that use it (the MLP's columns in
  and rows out, the vocabulary-parallel lookup and logits, the attention
  over a rank's query heads with the kv heads split and whole), runs on
  2 gloo CPU ranks against the same computation whole in one process
  (the attention also as a cross-attention over a source of another
  length, as the encoder-decoder's decoder layers run it),
  forward and backward (rtol 1e-5; the lookup in bits). The dry run's
  ``ModelShard`` without a group counts the same bytes on meta tensors.
* ``shard_params`` and ``unshard_params`` round-trip in bits, and each
  block, flattened, is ``core.distributed.shard_blocks`` of the whole
  leaf.
* internvl2-1b's smoke variant (4 heads, 2 kv heads, d_ff 256, a padded
  vocabulary of 512, an 8-patch prefix) at ``(2, 2)`` (every axis split)
  and ``(1, 4)`` (the kv heads whole), and at ``(2, 2)`` under a
  ``grad_clip`` that scales every step, trained 3 steps on 4 gloo ranks
  against the jitted JAX trainer on the same mesh (one subprocess of 8
  host devices for the file, as ``tests/test_torch_model_parallel.py``):
  losses, parameters and ``eps`` to rtol 1e-5 with a floor of 1e-5 of a
  leaf's largest magnitude, ``sent_idx`` per (worker, shard) as sets,
  round counters exactly; each rank holds exactly its blocks of the split
  leaves, and every whole leaf is equal in bits on every rank.
* Checkpoints (the smoke proxy at ``--model-parallel 2`` on 4 ranks): the
  tree the sharded ranks write is, in bits, the whole tree a rank holds
  after the same steps (``train.run`` gathers it); it resumes on the
  ranks as the unbroken run in bits, and in one process, and a
  checkpoint one process wrote resumes on the ranks, each as the
  unbroken run of the other kind to rtol 1e-5.

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
import _torch_cores  # noqa: F401  (this worker's share of the cores)

ROOT = Path(__file__).resolve().parents[1]
SPARSITY, LR, STEPS, RTOL = 0.01, 1e-3, 3, 1e-5
B, S = 4, 16
CLIP = 0.05  # below every step's global norm, so the clip always scales
ARCH = "internvl2-1b"
# name -> ((data, model), OptConfig fields beside kind and learning rate)
CASES = {
    "vlm-2x2": ((2, 2), {}),
    "vlm-1x4": ((1, 4), {}),
    "vlm-clip-2x2": ((2, 2), {"grad_clip": CLIP}),
}
CKPT_FLAGS = ["--smoke", "--seq", "16", "--global-batch", "4", "--device",
              "cpu", "--log-every", "100", "--model-parallel", "2",
              "--fastpath", "on"]


def _cfg(pkg):
    import importlib

    return importlib.import_module(f"{pkg}.configs").get_config(
        ARCH).smoke_variant()


def _batches(cfg):
    rng = np.random.default_rng(11)
    return [{"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "patches": rng.standard_normal(
                 (B, cfg.n_patches, cfg.vision_dim)).astype(np.float32)}
            for _ in range(STEPS)]


# ---------------------------------------------------------------------------
# the JAX side, in a subprocess of 8 host devices
# ---------------------------------------------------------------------------
def _jax_case(name, out_dir):
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.core import distributed as jd
    from repro.core.sparsify import SparsifierConfig
    from repro.models import get_family
    from repro.optim import OptConfig, make_optimizer

    (W, M), opt = CASES[name]
    cfg = _cfg("repro")
    mesh = jax.make_mesh((W, M), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto),
                         devices=jax.devices()[:W * M])
    dist = jd.DistConfig(
        sparsifier=SparsifierConfig(kind="regtopk", sparsity=SPARSITY),
        optimizer=OptConfig(kind="adam", learning_rate=LR, **opt),
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
def jax_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_tp")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    res = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    return {name: dict(np.load(out / f"{name}.npz")) for name in CASES}


# ---------------------------------------------------------------------------
# the port on a rank
# ---------------------------------------------------------------------------
def _port_case(name, p0, groups):
    """Three steps of case ``name`` on this rank of ``groups``, tensor
    parallel from its blocks of ``p0``. Returns the results to compare:
    losses, the params gathered whole, the state of every (worker,
    shard) in the JAX layout, each leaf's (held, block) shapes and the
    bits of the whole leaves."""
    from repro_torch import convert
    from repro_torch.core import distributed as td
    from repro_torch.core.sparsify import SparsifierConfig
    from repro_torch.launch import train
    from repro_torch.models import param_axes
    from repro_torch.nn.sharding import shard_params, unshard_params
    from repro_torch.optim import OptConfig, make_optimizer
    from repro_torch.tree import tree_items, tree_map

    (W, M), opt = CASES[name]
    cfg = _cfg("repro_torch")
    dist = td.DistConfig(
        sparsifier=SparsifierConfig(kind="regtopk", sparsity=SPARSITY),
        optimizer=OptConfig(kind="adam", learning_rate=LR, **opt))
    whole = convert.params_from_jax(_nest(p0), device="cpu")
    plan = td.build_plan(whole, SPARSITY, dist, axes=param_axes(cfg),
                         mesh={"data": W, "model": M})
    specs = tree_map(lambda p: p.spec, plan)
    assert td.model_shard(cfg, plan, groups.model_group, groups.shard)
    params = shard_params(whole, specs, groups.shard, M)
    step = td.make_train_step(cfg, dist, plan, W, mesh=groups)
    opt_state = make_optimizer(dist.optimizer).init(params)
    sp = td.init_sparsifier_state(plan, 1, "cpu", shards=1)
    losses = []
    for b in _batches(cfg):
        batch = {k: torch.from_numpy(v) for k, v in b.items()}
        batch = {k: v.long() if k != "patches" else v for k, v in batch.items()}
        params, opt_state, sp, m = step(params, opt_state, sp, batch)
        losses.append(float(m["loss"]))
    items = [(path, x, p) for (path, x), (_, p) in zip(
        tree_items(params), tree_items(plan), strict=True)]
    return {
        "losses": losses,
        "params": unshard_params(params, specs, groups.model_group, M),
        "state": convert.trainer_state_to_jax(train._all_workers(sp, groups),
                                              plan),
        "shapes": {path: (tuple(x.shape), p.local_shape, p.global_shape)
                   for path, x, p in items},
        "whole": b"".join(x.contiguous().view(torch.int32).numpy().tobytes()
                          for _, x, p in items if td.split_dim(p) is None),
    }


def _rank(rank, world, store, out_dir, p0s):
    """One of the 4 ranks: every VLM case, then the proxy's checkpoint
    runs (``--checkpoint``, ``--resume`` of it and of the one-process
    checkpoint the parent wrote, and the unbroken run); each rank saves
    its results."""
    import torch.distributed as dist

    from repro_torch.launch import mesh, train

    mesh.init_file_store(store, rank, world, "gloo")
    try:
        out = {}
        for name, ((_, M), _) in CASES.items():
            out[name] = _port_case(name, p0s[name],
                                   mesh.make_host_groups(model=M))

        def run(*flags):
            res = train.run(train.parse_args([*CKPT_FLAGS, *flags]),
                            mesh=mesh.make_host_groups(model=2))
            return {"losses": res.losses, "params": res.params,
                    "opt": res.opt_state}

        out["ckpt"] = run("--steps", "2", "--checkpoint", f"{out_dir}/tp")
        out["resume_tp"] = run("--steps", "2", "--resume", f"{out_dir}/tp")
        out["resume_one"] = run("--steps", "2", "--resume", f"{out_dir}/one")
        out["unbroken"] = run("--steps", "4")
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _one_process(*flags):
    from repro_torch.launch import train

    return train.run(train.parse_args([*CKPT_FLAGS, "--workers", "4", *flags]))


@pytest.fixture(scope="module")
def ranks_out(jax_runs, tmp_path_factory):
    from repro_torch.core.compact import CompactState
    from repro_torch.launch import mesh

    d = tmp_path_factory.mktemp("ranks_tp")
    _one_process("--steps", "2", "--checkpoint", f"{d}/one")
    p0s = {name: _section(run, "p0") for name, run in jax_runs.items()}
    mesh.spawn(_rank, 4, (str(d / "store"), str(d), p0s), timeout=120)
    with torch.serialization.safe_globals([CompactState]):
        return d, [torch.load(d / f"rank{r}.pt") for r in range(4)]


@pytest.mark.parametrize("name", list(CASES))
def test_four_ranks_match_jax(jax_runs, ranks_out, name):
    from repro_torch.tree import tree_items

    _, outs = ranks_out
    (W, M), _ = CASES[name]
    run, want = outs[0][name], jax_runs[name]
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
    for o in outs:  # each rank: its blocks, and the whole leaves in bits
        shapes = o[name]["shapes"]
        assert all(held == tuple(block) for held, block, _ in shapes.values())
        assert sum(math.prod(h) for h, _, _ in shapes.values()) < sum(
            math.prod(g) for _, _, g in shapes.values())
        assert o[name]["whole"] == run["whole"], name
    split = {path for path, (_, block, whole) in run["shapes"].items()
             if tuple(block) != tuple(whole)}
    # (1, 4): the 2 kv heads stay whole while the 4 query heads split
    kv_whole = M == 4
    assert ("layers.attn.wk" not in split) == kv_whole, split
    assert {"layers.attn.wq", "layers.mlp.wd", "embed.embedding"} <= split
    assert "vision_proj.w" not in split


# ---------------------------------------------------------------------------
# the Functions and the layers on 2 ranks, against one process
# ---------------------------------------------------------------------------
E, F, V, H, DH = 16, 24, 32, 4, 8


def _inputs():
    g = torch.Generator().manual_seed(3)
    return {"x": torch.randn(2, 5, E, generator=g),
            "wg": torch.randn(E, F, generator=g) / 4,
            "wu": torch.randn(E, F, generator=g) / 4,
            "wd": torch.randn(F, E, generator=g) / 5,
            "emb": torch.randn(V, E, generator=g),
            "tokens": torch.randint(0, V, (2, 5), generator=g),
            "wq": torch.randn(E, H, DH, generator=g) / 4,
            "wk": torch.randn(E, 2, DH, generator=g) / 4,
            "wk1": torch.randn(E, 1, DH, generator=g) / 4,
            "wv": torch.randn(E, 2, DH, generator=g) / 4,
            "wv1": torch.randn(E, 1, DH, generator=g) / 4,
            "wo": torch.randn(H, DH, E, generator=g) / 4,
            # a cross-attention source of another length than x's 5
            "xkv": torch.randn(2, 7, E, generator=g),
            # one decode step: its query and new key and value, and a
            # cache of 8 slots of 2 kv heads
            "dq": torch.randn(2, 1, H, DH, generator=g),
            "dk": torch.randn(2, 1, 2, DH, generator=g),
            "dv": torch.randn(2, 1, 2, DH, generator=g),
            "kc": torch.randn(2, 8, 2, DH, generator=g),
            "vc": torch.randn(2, 8, 2, DH, generator=g)}


def _layer_fns():
    """``{name: (fn(leaves, shard) -> output, {leaf: split dim or None},
    the logical axes split)}``: the layers under test, whole when
    ``shard`` is None and on the rank's blocks otherwise."""
    from repro_torch.models.lm import write_kv
    from repro_torch.nn import layers as L

    def decode(pos):
        """One decode step at ``pos`` (forward only): the new key and value
        written into slot ``pos % slots`` of a copy of the cache, then the
        query over the filled slots and the output projection."""
        def fn(w, shard):
            with torch.no_grad():
                kc, vc = w["kc"].clone(), w["vc"].clone()
                slots = kc.shape[1] * (shard.size if shard is not None
                                       and shard.splits("kv_seq") else 1)
                at = torch.tensor(pos % slots, device=kc.device)
                write_kv(kc, vc, w["dk"], w["dv"], at, shard)
                ctx = L.attention_decode(
                    w["dq"], kc, vc, torch.clamp(at.new_tensor(pos + 1),
                                                 max=slots), shard=shard)
                return L.attn_out({"wo": w["wo"]}, ctx, shard=shard)
        return fn

    slots = {"dq": 2, "kc": 1, "vc": 1, "dk": None, "dv": None, "wo": 0}

    def attention(kv, cross=False):
        def fn(w, shard):
            p = {"wq": w["wq"], "wk": w[f"wk{kv}"], "wv": w[f"wv{kv}"],
                 "wo": w["wo"]}
            q, k, v = L.attn_qkv(p, w["x"], xkv=w["xkv"] if cross else None,
                                 shard=shard)
            return L.attn_out(p, L.attention_dense(q, k, v), shard=shard)
        return fn

    return {
        "mlp": (lambda w, sh: L.mlp(w, w["x"], shard=sh),
                {"wg": 1, "wu": 1, "wd": 0}, {"mlp"}),
        "embed": (lambda w, sh: L.embed({"embedding": w["emb"]}, w["tokens"],
                                        shard=sh), {"emb": 0}, {"vocab"}),
        "unembed": (lambda w, sh: L.unembed({"embedding": w["emb"]}, w["x"],
                                            shard=sh), {"emb": 0}, {"vocab"}),
        # 4 query heads of 2 kv heads, both split on 2 ranks
        "attention-kv-split": (attention(""), {"wq": 1, "wk": 1, "wv": 1,
                                               "wo": 0}, {"heads", "kv_heads"}),
        # 4 query heads of 1 kv head, which stays whole
        "attention-kv-whole": (attention("1"), {"wq": 1, "wk1": None,
                                                "wv1": None, "wo": 0},
                               {"heads"}),
        # the same over a source of 7 positions against x's 5 (the
        # encoder-decoder's cross-attention), the source whole on every rank
        "cross-attention-kv-split": (
            attention("", cross=True),
            {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "xkv": None},
            {"heads", "kv_heads"}),
        "cross-attention-kv-whole": (
            attention("1", cross=True),
            {"wq": 1, "wk1": None, "wv1": None, "wo": 0, "xkv": None},
            {"heads"}),
        # the serve step's attention: 6 of 8 slots filled, the rank's kv
        # heads of the cache
        "decode-kv-heads": (decode(5), {"dq": 2, "dk": 2, "dv": 2, "kc": 2,
                                        "vc": 2, "wo": 0},
                            {"heads", "kv_heads"}),
        # the rank's 4 slots of both kv heads, 3 slots filled: rank 1's are
        # all empty, and the query heads gathered
        "decode-slots": (decode(2), slots, {"heads", "kv_seq"}),
        # the same with the query heads whole on every rank
        "decode-slots-heads-whole": (
            decode(2), {**slots, "dq": None, "wo": None}, {"kv_seq"}),
        # a ring that has wrapped: every slot filled, step 13 written into
        # slot 5, rank 1's
        "decode-ring": (decode(13), slots, {"heads", "kv_seq"}),
    }


def _layer_results(group=None, rank=0, device="cpu"):
    """Each layer's output and the gradients of its input and leaves
    under a fixed cotangent, and the bytes its collectives returned:
    whole (``rank`` None), or rank ``rank``'s blocks of 2 over ``group``
    (None: on the meta device, counted only)."""
    from repro_torch.nn import tensor_parallel as TP

    t = {k: v.to(device) for k, v in _inputs().items()}
    out = {}
    for name, (fn, dims, split) in _layer_fns().items():
        shard = (None if rank is None
                 else TP.ModelShard(group, rank, 2, frozenset(split)))
        w = {"x": t["x"].clone().requires_grad_(True), "tokens": t["tokens"]}
        for leaf, d in dims.items():
            x = t[leaf]
            if shard is not None and d is not None:
                x = x.narrow(d, rank * (x.shape[d] // 2), x.shape[d] // 2)
            w[leaf] = x.clone().requires_grad_(True)
        y = fn(w, shard)
        grads = {}  # none for a forward-only layer (the decode step)
        if y.requires_grad:
            cot = torch.linspace(-1, 1, y.numel()).reshape(y.shape).to(device)
            live = {k: v for k, v in w.items() if v.requires_grad}
            grads = dict(zip(live, torch.autograd.grad(
                (y * cot).sum(), list(live.values()), allow_unused=True),
                strict=True))
        out[name] = {"y": y.detach(), "dims": dims,
                     "grads": {k: None if g is None else g.detach()
                               for k, g in grads.items()},
                     "traffic": None if shard is None else dict(shard.traffic)}
    return out


def _fn_rank(rank, world, store, out_dir):
    import torch.distributed as dist

    from repro_torch.core import distributed as td
    from repro_torch.launch import mesh
    from repro_torch.models import get_family, param_axes
    from repro_torch.models.config import ModelConfig
    from repro_torch.nn.sharding import shard_params, unshard_params
    from repro_torch.tree import tree_items, tree_map

    mesh.init_file_store(store, rank, world, "gloo")
    try:
        out = {"layers": _layer_results(dist.new_group([0, 1]), rank)}
        # the tiny model's blocks on a model axis of 2
        cfg = ModelConfig(family="dense", remat=False, name="tiny", n_layers=2,
                          d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                          d_ff=128, vocab=256)
        whole = get_family(cfg).init(cfg, seed=0, device="cpu")
        plan = td.build_plan(whole, SPARSITY, axes=param_axes(cfg),
                             mesh={"data": 1, "model": world})
        specs = tree_map(lambda p: p.spec, plan)
        blocks = shard_params(whole, specs, rank, world)
        back = unshard_params(blocks, specs, dist.group.WORLD, world)
        out["round_trip"] = all(
            torch.equal(a.view(torch.int32), b.view(torch.int32))
            for (_, a), (_, b) in zip(tree_items(back), tree_items(whole),
                                      strict=True))
        out["rows"] = all(
            torch.equal(x.reshape(1, -1),
                        td.shard_blocks(whole_x[None], p, rank))
            for (_, x), (_, whole_x), (_, p) in zip(
                tree_items(blocks), tree_items(whole), tree_items(plan),
                strict=True))
        out["split"] = sum(td.split_dim(p) is not None
                           for _, p in tree_items(plan))
        torch.save(out, f"{out_dir}/fn{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def fn_out(tmp_path_factory):
    from repro_torch.launch import mesh

    d = tmp_path_factory.mktemp("tp_fns")
    mesh.spawn(_fn_rank, 2, (str(d / "store"), str(d)), timeout=120)
    return [torch.load(d / f"fn{r}.pt") for r in range(2)]


@pytest.mark.parametrize("name", list(_layer_fns()))
def test_layer_on_two_ranks_equals_one_process(fn_out, name):
    """Forward and backward of each shard-aware layer on 2 gloo ranks:
    the output and the input's gradient whole on both ranks, each leaf's
    gradient the block of the whole one; the lookup in bits."""
    want = _layer_results(rank=None)[name]
    for rank, out in enumerate(fn_out):
        got = out["layers"][name]
        tol = (dict(rtol=0, atol=0) if name == "embed"
               else dict(rtol=RTOL, atol=1e-6))
        torch.testing.assert_close(got["y"], want["y"], **tol)
        for leaf, g in want["grads"].items():
            d = want["dims"].get(leaf)
            if g is not None and d is not None:
                g = g.narrow(d, rank * (g.shape[d] // 2), g.shape[d] // 2)
            torch.testing.assert_close(got["grads"][leaf], g, rtol=RTOL,
                                       atol=1e-6,
                                       msg=f"{name} {leaf} rank {rank}")


def test_functions_count_their_bytes_on_the_meta_device(fn_out):
    """A ``ModelShard`` without a group moves nothing and counts, on meta
    tensors, the bytes the ranks' collectives returned."""
    from repro_torch.nn import tensor_parallel as TP

    meta = _layer_results(None, 0, "meta")
    for name, row in meta.items():
        assert row["traffic"] == fn_out[0]["layers"][name]["traffic"], name
        assert row["traffic"] == fn_out[1]["layers"][name]["traffic"], name
        assert sum(row["traffic"].values()) > 0, name
    shard = TP.ModelShard(None, 0, 2, frozenset({"mlp"}))
    with pytest.raises(ValueError, match="meta device"):
        TP.leave(torch.ones(2), shard)


def test_shard_params_round_trip_and_rows(fn_out):
    for out in fn_out:
        assert out["round_trip"] and out["rows"] and out["split"] > 0


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def test_checkpoint_from_sharded_ranks_is_the_whole_tree(ranks_out):
    """The sharded ranks' checkpoint holds, in bits, the whole params and
    Adam state the ranks gathered after the same 2 steps, in the JAX
    layout's shapes."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.tree import tree_items

    d, outs = ranks_out
    want = outs[0]["ckpt"]
    got_p = ckpt.restore(f"{d}/tp/params", want["params"])
    got_o = ckpt.restore(f"{d}/tp/opt", want["opt"])
    for got, ref in ((got_p, want["params"]), (got_o, want["opt"])):
        for (path, a), (_, b) in zip(tree_items(got), tree_items(ref),
                                     strict=True):
            assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                               else a, b.view(torch.int32)
                               if b.is_floating_point() else b), path
    assert ckpt.metadata(f"{d}/tp/params")["step"] == 2
    for o in outs:
        assert o["ckpt"]["losses"] == want["losses"]


@pytest.mark.parametrize("case", ["ranks-from-ranks", "one-from-ranks",
                                  "ranks-from-one"])
def test_checkpoint_resumes(ranks_out, case):
    """The ranks' checkpoint resumed on the ranks is their unbroken run in
    bits; resumed in one process, or one process's resumed on the ranks,
    it is the unbroken run of the other kind to rtol 1e-5."""
    from repro_torch.tree import tree_items

    d, outs = ranks_out
    ranks = outs[0]
    if case == "ranks-from-ranks":
        got, want, bits = ranks["resume_tp"], ranks["unbroken"], True
        assert got["losses"] == want["losses"][2:]
    elif case == "one-from-ranks":
        res = _one_process("--steps", "2", "--resume", f"{d}/tp")
        got, want, bits = {"losses": res.losses, "params": res.params}, (
            _one_process("--steps", "4")), False
        want = {"losses": want.losses, "params": want.params}
    else:
        got, bits = ranks["resume_one"], False
        res = _one_process("--steps", "4")
        want = {"losses": res.losses, "params": res.params}
    np.testing.assert_allclose(got["losses"], want["losses"][2:], rtol=RTOL)
    for (path, a), (_, b) in zip(tree_items(got["params"]),
                                 tree_items(want["params"]), strict=True):
        if bits:
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), path
        else:
            _close(a.numpy(), b.numpy(), f"{case} {path}")


if __name__ == "__main__":
    for case in CASES:
        _jax_case(case, sys.argv[1])
