"""Tensor parallelism for the SSM and hybrid families (``nn.ssd``'s mixer
under a ``ModelShard`` and the trainer's tensor-parallel path for
``models.ssm``).

* The mixer alone (``ssd_block_apply``) on gloo CPU ranks against the
  same call whole in one process, forward and backward: the mamba2 smoke
  widths (d_model 128, d_inner 256, 16 heads of 16, state 16) at M = 2
  and M = 4, and a shape with P != N and S not a multiple of the chunk
  at M = 2. Every such ``in_proj`` block cuts inside ``x`` and one rank
  holds all of ``B | C | dt`` (at M = 2 rank 1 from ``x[24:]`` on; at
  M = 4 rank 1 holds the end of ``z`` and the start of ``x``, rank 3 the
  end of ``x`` and ``B | C | dt``). The output and every gradient to rtol
  1e-5 (each split leaf's gradient the block of the whole one), and the
  bytes the collectives returned, counted again by a ``ModelShard``
  without a group on meta tensors, equal to what ``nn.ssd``'s docstring
  says a layer issues. Without a shard, or under one that splits none of
  its axes, the mixer is the whole composition of its pieces in bits.
* ``core.distributed.model_shard`` refuses a plan that splits one of
  ``"d_inner"`` and ``"ssm_heads"`` without the other; the decode step
  under a serving shard issues ``nn.ssd``'s docstring's collectives of
  activations and gathers no weight, and refuses a cache that is not the
  rank's block (its parity with JAX across ranks:
  ``tests/test_torch_serve_tensor_parallel_ssm.py``); the dry run (``launch.dryrun.count_layout``) counts
  the tensor-parallel step's model-group bytes exactly, and less memory
  and fewer FLOPs than the whole forward at the same layout.
* The trainer: mamba2-780m's smoke variant at ``(1, 4)`` and zamba2-7b's
  (one group of 2 mamba blocks and the shared attention block, then 2
  trailing blocks) at ``(2, 2)``, 3 steps of RegTop-k at S = 0.01 and
  Adam on 4 gloo ranks against the jitted JAX trainer on the same mesh
  from the same weights (the JAX package's ``init``; each case in its own
  subprocess of 8 host devices, started before the ranks and run while
  they run, which also run the mixer's cases): losses, parameters and
  ``eps`` to rtol 1e-5 with a floor of 1e-5 of a leaf's largest
  magnitude (the SSD's ``A_log`` and ``dt_bias`` to 1e-4, the float32
  spread of their gradients, ``tests/test_torch_ssd.py``), ``sent_idx``
  per (worker, shard) as sets, round counters exactly; each rank holds
  exactly its blocks of the split leaves, and every whole leaf (the
  norms) is equal in bits on every rank.

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

from test_torch_model_parallel import (SSD_DECAY_RTOL, _batches, _close,
                                       _flatten, _nest, _section)
import _torch_cores  # noqa: F401  (this worker's share of the cores)

ROOT = Path(__file__).resolve().parents[1]
SPARSITY, LR, RTOL = 0.01, 1e-3, 1e-5
# name -> (config, (data, model), the logical axes the model axis splits)
CASES = {
    "mamba2-1x4": ("mamba2-780m", (1, 4), {"d_inner", "ssm_heads", "vocab"}),
    "zamba2-2x2": ("zamba2-7b", (2, 2), {"d_inner", "ssm_heads", "heads",
                                         "kv_heads", "mlp", "vocab"}),
}


def _cfg(pkg, name):
    import importlib

    arch = CASES[name][0]
    return importlib.import_module(f"{pkg}.configs").get_config(
        arch).smoke_variant()


def _decay(path):
    return path.endswith(("mixer.A_log", "mixer.dt_bias"))


# ---------------------------------------------------------------------------
# the JAX side: each case's run in a subprocess of 8 host devices, and its
# weights drawn again here for the port's ranks
# ---------------------------------------------------------------------------
def _jax_case(name, out_dir):
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.core import distributed as jd
    from repro.core.sparsify import SparsifierConfig
    from repro.models import get_family
    from repro.optim import OptConfig, make_optimizer

    _, (W, M), _ = CASES[name]
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
        for b in _batches(cfg.vocab, 7):
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

    out = {}
    for name in CASES:
        cfg = _cfg("repro", name)
        params, _ = get_family(cfg).init(jax.random.PRNGKey(0), cfg)
        out[name] = _flatten(jax.tree.map(np.asarray, params))
    return out


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Starts each case's JAX run in its own subprocess and returns a
    function that waits for them (300 s at most) and loads the runs, so
    the port's ranks run meanwhile."""
    out = tmp_path_factory.mktemp("jax_tp_ssm")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs = {}
    for name in CASES:
        procs[name] = subprocess.Popen(
            [sys.executable, __file__, str(out), name], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
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

    _, (W, M), _ = CASES[name]
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
    for b in _batches(cfg.vocab, 7):
        batch = {k: torch.from_numpy(v).long() for k, v in b.items()}
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
    """One of the 4 ranks: every layer case, then every trainer case;
    each rank saves its results."""
    import torch.distributed as dist

    from repro_torch.launch import mesh

    mesh.init_file_store(store, rank, world, "gloo")
    try:
        groups = {M: mesh.make_host_groups(model=M) for M in (2, 4)}
        out = {"layer": _layer_results(
            {M: g.model_group for M, g in groups.items()}, rank)}
        out.update({name: _port_case(name, p0s[name],
                                     groups[CASES[name][1][1]])
                    for name in CASES})
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks_out(p0s, tmp_path_factory):
    from repro_torch.core.compact import CompactState
    from repro_torch.launch import mesh

    d = tmp_path_factory.mktemp("ranks_tp_ssm")
    mesh.spawn(_rank, 4, (str(d / "store"), str(d), p0s), timeout=120)
    with torch.serialization.safe_globals([CompactState]):
        return [torch.load(d / f"rank{r}.pt") for r in range(4)]


@pytest.mark.parametrize("name", list(CASES))
def test_four_ranks_match_jax(jax_runs, p0s, ranks_out, name):
    from repro_torch.tree import tree_items

    _, (W, M), split = CASES[name]
    run, want = ranks_out[0][name], jax_runs()[name]
    jp0 = _section(want, "p0")  # both sides started from the same weights
    assert jp0.keys() == p0s[name].keys(), name
    assert all(np.array_equal(jp0[k], v) for k, v in p0s[name].items()), name
    assert run["split"] == split, name
    np.testing.assert_allclose(run["losses"], want["losses"], rtol=RTOL,
                               err_msg=name)
    jparams = _section(want, "params")
    for path, leaf in tree_items(run["params"]):
        _close(leaf.numpy(), jparams[path], f"{name} {path}",
               SSD_DECAY_RTOL if _decay(path) else RTOL)
    jstate = _section(want, "state")
    for path, st in tree_items(run["state"]):
        where = f"{name} {path}"
        np.testing.assert_array_equal(st.t.numpy(), jstate[f"{path}:t"],
                                      err_msg=where)
        _close(st.eps.numpy(), jstate[f"{path}:eps"], where,
               SSD_DECAY_RTOL if _decay(path) else RTOL)
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
    stacks = ["trailing"] + (["grouped"] if name.startswith("zamba") else [])
    for stack in stacks:
        mixer = {f"{stack}.mixer.{leaf}" for leaf in (
            "in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias", "norm",
            "out_proj")}
        assert mixer <= blocks, (name, mixer - blocks)
        assert f"{stack}.norm.scale" in run["whole"], name
    assert "embed.embedding" in blocks and "final_norm.scale" in run["whole"], name
    if name.startswith("zamba"):
        assert {"shared_attn.attn.wq", "shared_attn.attn.wk",
                "shared_attn.mlp.wg", "shared_attn.mlp.wd"} <= blocks, name
        assert {"shared_attn.norm1.scale", "shared_attn.norm2.scale"} <= set(
            run["whole"]), name


# ---------------------------------------------------------------------------
# model_shard's guard, with no spawn
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("whole", ["ssm_heads", "d_inner"])
def test_model_shard_refuses_half_a_mixer(whole):
    from repro_torch import configs, models
    from repro_torch.core import distributed as td
    from repro_torch.core.sparsify import SparsifierConfig

    cfg = configs.get_config("mamba2-780m").smoke_variant()
    dist = td.DistConfig(
        sparsifier=SparsifierConfig(kind="regtopk", sparsity=SPARSITY),
        rules={whole: None})
    params = models.get_family(cfg).init(cfg, device="meta")
    plan = td.build_plan(params, SPARSITY, dist, axes=models.param_axes(cfg),
                         mesh={"data": 1, "model": 2})
    split = "d_inner" if whole == "ssm_heads" else "ssm_heads"
    with pytest.raises(ValueError, match=rf"mamba2-780m.*'{split}' is split"
                       rf".*'{whole}' is whole"):
        td.model_shard(cfg, plan, None, 0)
    both = td.build_plan(params, SPARSITY, td.DistConfig(
        sparsifier=dist.sparsifier), axes=models.param_axes(cfg),
        mesh={"data": 1, "model": 2})
    assert {"d_inner", "ssm_heads"} <= td.model_shard(cfg, both, None, 0).split


# ---------------------------------------------------------------------------
# the dry run counts the tensor-parallel step, with no spawn
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-7b"])
def test_dry_run_counts_the_tensor_parallel_step(monkeypatch, arch):
    """``launch.dryrun.count_layout`` at ``(2, 2)`` on the smoke fields
    traces one rank's tensor-parallel step: its blocks, and the model
    group's bytes as ``nn.ssd``'s and ``nn.layers``' docstrings count
    them (each mamba block's three gathered leaves and their summed
    gradients, its squares and activations; the shared block's entries
    and leaves; the lookup, the unembedding's input and the logits);
    without tensor parallelism the same layout holds more and gathers the
    aggregates instead."""
    from repro_torch import configs
    from repro_torch.core import distributed as td
    from repro_torch.core.sparsify import SparsifierConfig
    from repro_torch.launch import dryrun
    from repro_torch.models import ssm

    cfg = configs.get_config(arch).smoke_variant()
    dist = td.DistConfig(
        sparsifier=SparsifierConfig(kind="regtopk", sparsity=SPARSITY))
    lay = dryrun.layout_of(cfg, dist, {"data": 2, "model": 2}, 4, 16)
    rec = dryrun.count_layout(lay)
    n_groups, per_group, trailing = ssm._plan(cfg)
    E, d_inner, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    act = lay.rows * lay.seq * E  # one whole activation, in words
    leaves = (E * (2 * d_inner + 2 * N + d_inner // cfg.ssm_headdim)
              + (ssm.ssd.CONV_K + 1) * (d_inner + 2 * N))
    mamba = n_groups * per_group + trailing
    # a shared block: q's and the kv's entries and the MLP's input
    # backward, the attention output and the MLP output forward
    gathered = mamba * leaves + lay.rows * lay.seq * cfg.padded_vocab
    reduced = (mamba * (leaves + 2 * act + 2 * lay.rows * lay.seq)
               + n_groups * 5 * act + 2 * act)
    coll = rec["collectives"][1]
    assert coll["all-gather:model"] == 4 * gathered, arch
    assert coll["all-reduce:model"] == 4 * reduced, arch
    monkeypatch.setattr(ssm, "TENSOR_PARALLEL", frozenset())
    whole = dryrun.count_layout(lay)
    assert "all-reduce:model" not in whole["collectives"][1], arch
    assert rec["rank_bytes"] < whole["rank_bytes"], arch
    assert rec["cost"]["peak_bytes"] < whole["cost"]["peak_bytes"], arch
    assert rec["cost"]["flops"] < whole["cost"]["flops"], arch


# ---------------------------------------------------------------------------
# the mixer on gloo ranks, against one process
# ---------------------------------------------------------------------------
# name -> (d_model, d_inner, headdim, d_state, chunk, S, M); batch 2
LAYER_CASES = {
    "smoke-m2": (128, 256, 16, 16, 32, 40, 2),
    "smoke-m4": (128, 256, 16, 16, 32, 40, 4),
    "p_ne_n-m2": (96, 192, 16, 8, 32, 48, 2),
}
LAYER_B = 2
# each leaf's split dim over the model group
LEAF_DIMS = {"in_proj": 1, "conv_w": 1, "conv_b": 0, "A_log": 0, "D": 0,
             "dt_bias": 0, "norm": 0, "out_proj": 0}


def _layer_inputs(case):
    """The mixer's weights (``ssd_init``, its zero and one vectors moved
    off their init values so that a misplaced bias or scale shows), the
    input ``[2, S, d_model]`` and the output's cotangent."""
    from repro_torch.nn import ssd

    d_model, d_inner, headdim, d_state, _, S, _ = LAYER_CASES[case]
    g = torch.Generator().manual_seed(3)
    p = ssd.ssd_init(g, d_model, "cpu", d_inner=d_inner, headdim=headdim,
                     d_state=d_state)
    for name in ("conv_b", "dt_bias", "D", "norm"):
        p[name] = p[name] + 0.1 * torch.randn(p[name].shape, generator=g)
    x = torch.randn(LAYER_B, S, d_model, generator=g)
    cot = torch.randn(LAYER_B, S, d_model, generator=g)
    return p, x, cot


def _block(x, dim, rank, M):
    n = x.shape[dim] // M
    return x.narrow(dim, rank * n, n)


def _layer_kw(case):
    _, d_inner, headdim, d_state, chunk, _, _ = LAYER_CASES[case]
    return dict(d_inner=d_inner, headdim=headdim, d_state=d_state,
                chunk=chunk)


def _layer_results(groups=None, rank=None, device="cpu"):
    """Each layer case's output, the gradients of its input and leaves
    under a fixed cotangent, and the bytes its collectives returned:
    whole (``rank`` None), or as rank ``rank`` of its case's M over
    ``groups[M]`` (None: on the meta device, counted only)."""
    from repro_torch.nn import ssd
    from repro_torch.nn import tensor_parallel as TP

    out = {}
    for name in LAYER_CASES:
        M = LAYER_CASES[name][-1]
        p, x, cot = _layer_inputs(name)
        shard = None if rank is None else TP.ModelShard(
            None if groups is None else groups[M], rank % M, M,
            frozenset({"d_inner", "ssm_heads"}))
        w = {k: (v if shard is None else _block(v, LEAF_DIMS[k], rank % M, M))
             .to(device).clone().requires_grad_(True) for k, v in p.items()}
        xin = x.to(device).requires_grad_(True)
        y, _ = ssd.ssd_block_apply(w, xin, **_layer_kw(name), shard=shard)
        grads = torch.autograd.grad((y * cot.to(device)).sum(),
                                    [xin, *w.values()])
        out[name] = {"y": y.detach(),
                     "grads": dict(zip(["x", *w], grads, strict=True)),
                     "traffic": None if shard is None else dict(shard.traffic)}
    return out


@pytest.fixture(scope="module")
def layer_out(ranks_out):
    return [out["layer"] for out in ranks_out]


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_mixer_on_ranks_equals_one_process(layer_out, name):
    """Forward and backward of ``ssd_block_apply`` across the ranks of a
    model group of M: the output and the input's gradient whole on every
    rank, each leaf's gradient the block of the whole one."""
    M = LAYER_CASES[name][-1]
    want = _layer_results()[name]
    tol = dict(rtol=RTOL, atol=RTOL * float(want["y"].abs().max()))
    for rank, out in enumerate(layer_out):
        got = out[name]
        torch.testing.assert_close(got["y"], want["y"], **tol)
        for leaf, g in want["grads"].items():
            if leaf != "x":
                g = _block(g, LEAF_DIMS[leaf], rank % M, M)
            torch.testing.assert_close(
                got["grads"][leaf], g, rtol=RTOL,
                atol=RTOL * float(g.abs().max()),
                msg=f"{name} {leaf} rank {rank}")


def test_in_proj_blocks_cut_across_the_parts():
    """The cases' ``in_proj`` blocks: every one cuts inside ``x`` and the
    last rank holds ``B | C | dt`` whole; at M = 4 a rank holds the end of
    ``z`` and the start of ``x``."""
    for name, (_, d_inner, headdim, d_state, _, _, M) in LAYER_CASES.items():
        n = (2 * d_inner + 2 * d_state + d_inner // headdim) // M
        cuts = [r * n for r in range(1, M)]
        assert any(d_inner < c < 2 * d_inner for c in cuts), name
        assert cuts[-1] <= 2 * d_inner, name
        if M == 4:
            assert cuts[0] < d_inner < cuts[1], name


def test_mixer_collectives_are_the_docstrings(layer_out):
    """Each case's bytes, as the ranks' collectives returned them and as a
    ``ModelShard`` without a group counts them on meta tensors: forward,
    the whole ``in_proj``, ``conv_w`` and ``conv_b`` gathered, the
    squares' ``[B, S, 1]`` and the output ``[B, S, E]`` all-reduced;
    backward, the three leaves' whole gradients, the input's and the
    squares' gradients all-reduced (``nn.ssd``'s docstring)."""
    from repro_torch.nn.ssd import CONV_K

    meta = _layer_results(None, 0, "meta")
    for name, (E, d_inner, headdim, N, _, S, _) in LAYER_CASES.items():
        c_in = 2 * d_inner + 2 * N + d_inner // headdim
        c_conv = d_inner + 2 * N
        leaves = E * c_in + CONV_K * c_conv + c_conv
        acts = 2 * LAYER_B * S * (E + 1)
        want = {"all-gather": 4 * leaves, "all-reduce": 4 * (leaves + acts)}
        assert meta[name]["traffic"] == want, name
        for out in layer_out:
            assert out[name]["traffic"] == want, name


def _whole_mixer(p, x, *, d_inner, headdim, d_state, chunk, norm_eps=1e-6):
    """The whole mixer composed from ``nn.ssd``'s pieces in its order, as
    ``ssd_block_apply`` computed it before it took a shard."""
    import torch.nn.functional as F

    from repro_torch.kernels.regtopk_score import const_div
    from repro_torch.nn import ssd

    H = d_inner // headdim
    z, xbc, dt = torch.split(x @ p["in_proj"],
                             [d_inner, d_inner + 2 * d_state, H], dim=-1)
    A = -torch.exp(p["A_log"])
    xbc = F.silu(ssd._causal_conv(xbc, p["conv_w"], p["conv_b"]))
    xs, Bm, Cm = torch.split(xbc, [d_inner, d_state, d_state], dim=-1)
    Bsz, S, _ = x.shape
    xh = xs.reshape(Bsz, S, H, headdim)
    dtp = ssd._softplus(dt + p["dt_bias"])
    y, _ = ssd.ssd_scan_chunked(xh, dtp, A, Bm, Cm, chunk=chunk)
    y = (y + p["D"][None, None, :, None] * xh).reshape(Bsz, S, d_inner)
    y = y * F.silu(z)
    var = const_div(y.square().sum(-1, keepdim=True), float(d_inner))
    return (y * torch.rsqrt(var + norm_eps)) * p["norm"] @ p["out_proj"]


@pytest.mark.parametrize("name", ["smoke-m2", "p_ne_n-m2"])
def test_the_mixer_whole_is_unchanged(name):
    """Without a shard, and under a shard that splits none of its axes,
    ``ssd_block_apply`` issues no collective and equals the whole
    composition in bits, output and gradients."""
    from repro_torch.nn import ssd
    from repro_torch.nn import tensor_parallel as TP

    p, x, cot = _layer_inputs(name)
    kw = _layer_kw(name)
    shard = TP.ModelShard(None, 0, 2, frozenset({"heads", "vocab"}))
    runs = []
    for fn in (lambda w, xin: _whole_mixer(w, xin, **kw),
               lambda w, xin: ssd.ssd_block_apply(w, xin, **kw)[0],
               lambda w, xin: ssd.ssd_block_apply(w, xin, **kw,
                                                  shard=shard)[0]):
        w = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xin = x.clone().requires_grad_(True)
        y = fn(w, xin)
        runs.append([y, *torch.autograd.grad((y * cot).sum(),
                                             [xin, *w.values()])])
    for other in runs[1:]:
        for a, b in zip(runs[0], other, strict=True):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name
    assert shard.traffic == {"all-reduce": 0, "all-gather": 0}


def test_the_decode_step_refuses_a_shard(monkeypatch):
    """The decode step under a serving shard, counted on meta tensors
    (``ModelShard`` without a group), rank 1 of each layer case's M: one
    step issues exactly ``nn.ssd``'s docstring's collectives, all-gathers
    of ``zxbcdt`` ``[B, 1, 2 d_inner + 2N + H]`` and of the conv output
    ``[B, d_inner + 2N]`` and all-reduces of the squares' float32 ``[B, 1,
    1]`` and of the output ``[B, 1, E]``, and gathers no weight
    (``gather_leaf`` is never called); the new cache is the rank's blocks.
    A shard whose cache is not the rank's block of the conv channels (the
    whole window) is refused before any collective."""
    from repro_torch.nn import ssd
    from repro_torch.nn import tensor_parallel as TP

    def no_weight(*_):
        raise AssertionError("the decode step gathered a weight")

    monkeypatch.setattr(TP, "gather_leaf", no_weight)
    for name, (E, d_inner, headdim, N, _, _, M) in LAYER_CASES.items():
        p, _, _ = _layer_inputs(name)
        kw = _layer_kw(name)
        blocks = {k: _block(v, LEAF_DIMS[k], 1, M).to("meta")
                  for k, v in p.items()}
        x = torch.empty(LAYER_B, 1, E, device="meta")
        cache = ssd.ssd_init_cache(LAYER_B, d_inner, headdim, N, "meta",
                                   shards=M)
        shard = TP.ModelShard(None, 1, M, frozenset({"d_inner", "ssm_heads"}))
        out, new = ssd.ssd_block_apply(blocks, x, **kw, cache=cache,
                                       shard=shard)
        H, C = d_inner // headdim, d_inner + 2 * N
        assert out.shape == (LAYER_B, 1, E), name
        assert new["conv"].shape == (LAYER_B, ssd.CONV_K - 1, C // M), name
        assert new["ssm"].shape == (LAYER_B, H // M, headdim, N), name
        assert shard.traffic == {
            "all-gather": 4 * LAYER_B * ((2 * d_inner + 2 * N + H) + C),
            "all-reduce": 4 * LAYER_B * (1 + E)}, name
        whole = ssd.ssd_init_cache(LAYER_B, d_inner, headdim, N, "meta")
        shard = TP.ModelShard(None, 1, M, frozenset({"d_inner", "ssm_heads"}))
        with pytest.raises(ValueError, match="not one block"):
            ssd.ssd_block_apply(blocks, x, **kw, cache=whole, shard=shard)
        assert shard.traffic == {"all-reduce": 0, "all-gather": 0}, name


if __name__ == "__main__":
    _jax_case(sys.argv[2], sys.argv[1])
