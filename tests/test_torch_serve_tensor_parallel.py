"""The model-parallel serve step of the decoder family (``models/lm.py``'s
``prefill``, ``init_cache`` and ``decode_step`` under a serving
``ModelShard``, ``nn.layers.attention_decode``'s combine over a rank's
cache slots, ``nn.sharding.serve_rules``/``serve_shard`` and
``launch.serve.run(..., mesh=)``).

* Each case runs the jitted JAX ``decode_step`` (or ``prefill``) with the
  in-shardings of the JAX dry run's ``lower_serve`` on its mesh (one
  subprocess of 8 host devices for the file), 12 greedy steps from a zero
  cache; the port runs the same steps on 4 gloo ranks from its blocks of
  JAX's weights, fed JAX's tokens. Held: each step's logits to rtol 1e-5
  with a floor of 1e-5 of the step's largest logit, each rank's cache
  block against the matching block of JAX's cache to rtol 1e-5, ``pos``
  exactly, and the greedy tokens equal wherever JAX's top-2 margin is at
  least 1e-3. The cases (smoke variants: 4 query heads, 2 kv heads):
  qwen2.5-3b at ``(2, 2)`` (the kv heads split) and at ``(1, 4)`` (the
  cache's slots split, 4 a rank, so rank 3's stay empty for all 12
  steps), mixtral-8x7b at ``(1, 4)`` with an 8-slot ring that wraps
  across the ranks, deepseek-moe-16b at ``(2, 2)`` in the expert layout
  (2 rows a dp group: the dropless routing does not depend on how the
  rows are grouped), qwen2.5-3b at ``(1, 4)`` with 30 slots, which 4
  does not divide (the cache whole on every rank, the query heads
  gathered), and internvl2-1b's ``prefill`` with its patch prefix at
  ``(2, 2)``.
* ``serve.run(..., mesh=)`` on the 4 ranks at ``(2, 2)`` and ``(1, 4)``
  gives the one-process run's tokens, each rank its dp group's rows.
* The dropless MoE routes each token alike whatever the grouping of the
  rows; a family outside its module's ``SERVE_PARALLEL`` is refused a
  model axis; the SSM and hybrid families' serving shard splits the
  SSD's channels and heads (their step:
  ``tests/test_torch_serve_tensor_parallel_ssm.py``), and the
  encoder-decoder's its heads, kv heads or slots and both caches (its
  step: ``tests/test_torch_serve_tensor_parallel_encdec.py``).

The ranks start while the JAX subprocess compiles and take each case as
its results appear. Every wait is bounded at 120 s (the JAX subprocess
at 300 s).
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_model_parallel import _flatten, _nest, _section
import _torch_cores  # noqa: F401  (this worker's share of the cores)

ROOT = Path(__file__).resolve().parents[1]
B, STEPS, PROMPT, RTOL, MARGIN = 4, 12, 16, 1e-5, 1e-3
# name -> (arch, (data, model), config fields, max_len, kind, the
# layout: the kv heads split, the slots split, or the cache whole)
CASES = {
    "qwen-heads-2x2": ("qwen2.5-3b", (2, 2), {}, 16, "decode", "heads"),
    "qwen-seq-1x4": ("qwen2.5-3b", (1, 4), {}, 16, "decode", "seq"),
    "mixtral-ring-1x4": ("mixtral-8x7b", (1, 4), {"sliding_window": 8}, 16,
                         "decode", "seq"),
    "deepseek-expert-2x2": ("deepseek-moe-16b", (2, 2),
                            {"moe_parallelism": "expert"}, 16, "decode",
                            "heads"),
    "qwen-guard-1x4": ("qwen2.5-3b", (1, 4), {}, 30, "decode", "whole"),
    "internvl-prefill-2x2": ("internvl2-1b", (2, 2), {}, None, "prefill",
                             "heads"),
}
SERVE_FLAGS = ["--arch", "qwen2.5-3b", "--smoke", "--batch", str(B),
               "--prompt-len", "2", "--new-tokens", "6", "--max-len", "16",
               "--device", "cpu"]
SERVE_MESHES = {"serve-2x2": 2, "serve-1x4": 4}
WAIT = 120.0


def _cfg(pkg, name):
    import importlib

    arch, _, fields, _, _, _ = CASES[name]
    return importlib.import_module(f"{pkg}.configs").get_config(
        arch).smoke_variant().replace(**fields)


def _inputs(cfg, name):
    rng = np.random.default_rng(5)
    if CASES[name][4] == "prefill":
        return {"tokens": rng.integers(0, cfg.vocab, (B, PROMPT)).astype(
                    np.int32),
                "patches": rng.standard_normal(
                    (B, cfg.n_patches, cfg.vision_dim)).astype(np.float32)}
    return {"first": rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)}


# ---------------------------------------------------------------------------
# the JAX side, in a subprocess of 8 host devices
# ---------------------------------------------------------------------------
def _jax_case(name, out_dir):
    """``lower_serve``'s layout on a ``(data, model)`` host mesh: its serve
    rules, the parameters' and the cache's specs, the batch over the dp
    axis; then the jitted step, greedy from a zero cache."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.models import get_family
    from repro.nn import sharding as shlib

    _, (W, M), _, max_len, kind, _ = CASES[name]
    cfg = _cfg("repro", name)
    mesh = jax.make_mesh((W, M), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto),
                         devices=jax.devices()[:W * M])
    mod = get_family(cfg)
    params, axes = mod.init(jax.random.PRNGKey(0), cfg)
    rules = ({"kv_seq": None} if cfg.n_heads and cfg.n_kv_heads % M == 0
             else {"kv_seq": "model", "kv_heads": None})

    def shardings(tree, tree_axes):
        specs = shlib.tree_specs(tree, tree_axes, mesh, rules=rules,
                                 dp_axes=("data",))
        return jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                            is_leaf=lambda x: isinstance(x, P))

    rows = NamedSharding(mesh, P("data"))
    inputs = _inputs(cfg, name)
    out = {f"p0/{k}": v for k, v in
           _flatten(jax.tree.map(np.asarray, params)).items()}
    with mesh:
        if kind == "prefill":
            step = jax.jit(lambda p, b: mod.prefill(p, cfg, b),
                           in_shardings=(shardings(params, axes),
                                         {k: rows for k in inputs}))
            out["logits"] = np.asarray(step(params, jax.tree.map(
                jnp.asarray, inputs)))
        else:
            cache = mod.init_cache(cfg, B, max_len)
            cs = shardings(cache, mod.cache_axes(cfg))
            step = jax.jit(lambda p, c, t: mod.decode_step(p, cfg, c, t),
                           in_shardings=(shardings(params, axes), cs, rows),
                           out_shardings=(None, cs))
            tokens, fed, logits = jnp.asarray(inputs["first"]), [], []
            for _ in range(STEPS):
                fed.append(np.asarray(tokens))
                lg, cache = step(params, cache, tokens)
                logits.append(np.asarray(lg[:, 0]))
                tokens = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
            out.update(fed=np.concatenate(fed, 1), logits=np.stack(logits, 1),
                       **{f"cache/{k}": np.asarray(v) for k, v in cache.items()})
    np.savez(f"{out_dir}/{name}.tmp.npz", **out)
    os.replace(f"{out_dir}/{name}.tmp.npz", f"{out_dir}/{name}.npz")


def _jax_main(out_dir):
    try:
        for name in CASES:
            _jax_case(name, out_dir)
    except BaseException:
        Path(out_dir, "jax.failed").write_text("failed")
        raise


# ---------------------------------------------------------------------------
# the port on a rank
# ---------------------------------------------------------------------------
def _wait_for(out_dir, name):
    deadline = time.monotonic() + WAIT
    path = Path(out_dir, f"{name}.npz")
    while not path.exists():
        if Path(out_dir, "jax.failed").exists():
            raise RuntimeError("the JAX subprocess failed")
        if time.monotonic() > deadline:
            raise TimeoutError(f"no JAX result for {name} after {WAIT} s")
        time.sleep(0.05)
    return dict(np.load(path))


def _port_case(name, jx, groups):
    """Case ``name`` on this rank of ``groups`` from its blocks of JAX's
    weights: the logits of every step (fed JAX's tokens, its dp group's
    rows), the final cache block and ``pos``, and the shard's split
    axes."""
    from repro_torch import convert
    from repro_torch.launch import serve
    from repro_torch.models import get_family
    from repro_torch.nn.sharding import shard_params

    _, (W, M), _, max_len, kind, _ = CASES[name]
    cfg = _cfg("repro_torch", name)
    mod = get_family(cfg)
    whole = convert.params_from_jax(_nest(_section(jx, "p0")), device="cpu")
    specs, _, shard = serve.serve_layout(
        cfg, whole, B, max_len or PROMPT, groups.mesh_shape,
        groups.axis_names, groups.model_group, groups.shard)
    params = shard_params(whole, specs, groups.shard, M)
    n = B // W
    rows = slice(groups.rank * n, (groups.rank + 1) * n)
    out = {"split": sorted(shard.split), "rows": (rows.start, rows.stop)}
    if kind == "prefill":
        inputs = _inputs(cfg, name)
        batch = {"tokens": torch.from_numpy(inputs["tokens"][rows]).long(),
                 "patches": torch.from_numpy(inputs["patches"][rows])}
        out["logits"] = mod.prefill(params, cfg, batch, shard=shard)
        return out
    cache = mod.init_cache(cfg, n, max_len, device="cpu", shard=shard)
    logits = []
    for t in range(STEPS):
        tokens = torch.from_numpy(jx["fed"][rows, t:t + 1]).long()
        lg, cache = mod.decode_step(params, cfg, cache, tokens, shard=shard)
        logits.append(lg[:, 0])
    out.update(logits=torch.stack(logits, 1), k=cache["k"], v=cache["v"],
               pos=int(cache["pos"]))
    return out


def _rank(rank, world, store, out_dir):
    import torch.distributed as dist

    from repro_torch.launch import mesh, serve

    mesh.init_file_store(store, rank, world, "gloo")
    try:
        out = {}
        for name, (_, (_, M), *_rest) in CASES.items():
            out[name] = _port_case(name, _wait_for(out_dir, name),
                                   mesh.make_host_groups(model=M))
        for name, M in SERVE_MESHES.items():
            res = serve.run(serve.parse_args(SERVE_FLAGS),
                            mesh=mesh.make_host_groups(model=M))
            out[name] = {"first": res.first, "prompt": res.prompt,
                         "tokens": res.tokens}
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch import mesh

    d = tmp_path_factory.mktemp("serve_tp")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.Popen([sys.executable, __file__, str(d)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        mesh.spawn(_rank, 4, (str(d / "store"), str(d)), timeout=WAIT)
    finally:
        try:
            log, _ = proc.communicate(timeout=300)
        finally:
            proc.kill()
    assert proc.returncode == 0, log
    jax_runs = {name: dict(np.load(d / f"{name}.npz")) for name in CASES}
    return jax_runs, [torch.load(d / f"rank{r}.pt") for r in range(4)]


def _close(got, want, msg):
    """rtol 1e-5 with a floor of 1e-5 of ``want``'s largest magnitude
    along its last axis (a step's logits)."""
    want = np.asarray(want, np.float32)
    floor = RTOL * np.abs(want).max(axis=-1, keepdims=True)
    diff = np.abs(np.asarray(got, np.float32) - want)
    bad = diff > RTOL * np.abs(want) + floor
    assert not bad.any(), f"{msg}: {bad.sum()} beyond, largest |diff| {diff.max()}"


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_serve_as_jax(runs, name):
    jax_runs, outs = runs
    _, (W, M), _, _, kind, layout = CASES[name]
    jx = jax_runs[name]
    want_split = {"heads": "kv_heads", "seq": "kv_seq"}.get(layout)
    for rank, out in enumerate(outs):
        got = out[name]
        where = f"{name} rank {rank}"
        assert (want_split is None
                or want_split in got["split"]), (where, got["split"])
        assert not {"kv_heads", "kv_seq"} & set(got["split"]) - {want_split}
        rows = slice(*got["rows"])
        assert rows == slice((rank // M) * (B // W), (rank // M + 1) * (B // W))
        _close(got["logits"].numpy(), jx["logits"][rows], where)
        if kind == "prefill":
            continue
        assert got["pos"] == int(jx["cache/pos"]) == STEPS, where
        for leaf in ("k", "v"):
            block = jx[f"cache/{leaf}"][:, rows]
            shard = rank % M
            if layout == "seq":
                S = block.shape[2] // M
                block = block[:, :, shard * S:(shard + 1) * S]
            elif layout == "heads":
                K = block.shape[3] // M
                block = block[:, :, :, shard * K:(shard + 1) * K]
            assert got[leaf].shape == block.shape, (where, leaf)
            np.testing.assert_allclose(got[leaf].numpy(), block, rtol=RTOL,
                                       atol=RTOL * np.abs(block).max(),
                                       err_msg=f"{where} cache {leaf}")
        # greedy: the port's argmax is JAX's next token where JAX's top-2
        # margin is clear
        logits = jx["logits"][rows]
        top2 = np.sort(logits, axis=-1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0] >= MARGIN)[:, :-1]
        mine = got["logits"].argmax(-1).numpy()[:, :-1]
        assert clear.mean() > 0.5, where
        np.testing.assert_array_equal(mine[clear], jx["fed"][rows, 1:][clear],
                                      err_msg=where)


@pytest.mark.parametrize("name", list(SERVE_MESHES))
def test_serve_run_on_ranks_equals_one_process(runs, name):
    """``serve.run(..., mesh=)``: each rank decodes its dp group's rows of
    the one-process run's batch, from the same first tokens, to the same
    greedy tokens."""
    from repro_torch.launch import serve

    _, outs = runs
    want = serve.run(serve.parse_args(SERVE_FLAGS))
    M = SERVE_MESHES[name]
    W = 4 // M
    for rank, out in enumerate(outs):
        rows = slice((rank // M) * (B // W), (rank // M + 1) * (B // W))
        got = out[name]
        assert torch.equal(got["first"], want.first[rows]), (name, rank)
        assert torch.equal(got["prompt"], want.prompt[rows]), (name, rank)
        assert torch.equal(got["tokens"], want.tokens[rows]), (name, rank)


def test_dropless_routing_ignores_the_grouping_of_rows():
    """With ``no_drop`` every token's experts, gates and output are those
    of its own routing: the rows split in two, or grouped by fewer tokens,
    give each token's output of the whole batch in one group."""
    from repro_torch.configs import get_config
    from repro_torch.nn import moe

    cfg = get_config("deepseek-moe-16b").smoke_variant()
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg.d_model, cfg.d_ff,
                     cfg.n_experts, "cpu", n_shared=cfg.n_shared_experts,
                     shared_d_ff=cfg.moe_shared_d_ff)
    x = torch.randn(4, 3, cfg.d_model, generator=torch.Generator().manual_seed(1))

    def run(x, group):
        return moe.moe_apply(p, x, top_k=cfg.moe_top_k, group_size=group,
                             no_drop=True)[0]

    whole = run(x, 12)
    for got in (torch.cat([run(x[:2], 12), run(x[2:], 12)]), run(x, 4),
                run(x, 5)):
        torch.testing.assert_close(got, whole, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("arch", ["whisper-tiny"])
def test_families_that_serve_whole_refuse_a_shard(monkeypatch, arch):
    """A family left out of its module's ``SERVE_PARALLEL`` (emptied here,
    as the dry run's tests empty ``TENSOR_PARALLEL``) has no serving shard,
    and ``serve.run`` refuses it a model axis above 1."""
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh, serve
    from repro_torch.models import get_family, serve_parallel

    cfg = get_config(arch).smoke_variant()
    mod = get_family(cfg)
    assert serve_parallel(cfg)
    monkeypatch.setattr(mod, "SERVE_PARALLEL", frozenset())
    assert not serve_parallel(cfg)
    assert serve.serve_layout(cfg, mod.init(cfg, device="meta"), B, 16,
                              {"data": 1, "model": 2})[2] is None
    groups = mesh.DpGroups(("data",), (1,), (None,), 0, 2, 0, None)
    with pytest.raises(ValueError, match="does not serve on a rank's blocks"):
        serve.run(serve.parse_args(["--arch", arch, "--smoke", "--device",
                                    "cpu"]), mesh=groups)


# whisper-tiny's serving layouts: (smoke, M, max_len) -> (the axes the
# shard splits, query heads, self cache (slots, kv heads), cross cache kv
# heads, MLP columns) a rank
ENCDEC_LAYOUTS = {
    (False, 2, 448): ({"heads", "kv_heads", "mlp", "vocab"}, 3, (448, 3), 3,
                      768),
    (False, 4, 448): ({"kv_seq", "mlp", "vocab"}, 6, (112, 6), 6, 384),
    (False, 16, 32768): ({"kv_seq", "mlp", "vocab"}, 6, (2048, 6), 6, 96),
    (True, 2, 16): ({"heads", "kv_heads", "mlp", "vocab"}, 2, (16, 1), 1, 128),
    (True, 4, 16): ({"heads", "kv_seq", "mlp", "vocab"}, 1, (4, 2), 2, 64),
}


@pytest.mark.parametrize("layout", list(ENCDEC_LAYOUTS), ids=str)
def test_the_encdec_family_serves_on_its_blocks(layout):
    """whisper-tiny's serving shard splits, at published widths and on
    the smoke fields, what the JAX serve rules split: the kv heads where
    the model axis divides them (the cross cache with them), else the self
    cache's slots, with the cross cache whole (its frames have no rule);
    the MLP's columns and the vocabulary always, the query heads where the
    axis divides them."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import encdec, serve_parallel
    from repro_torch.nn.sharding import shard_params

    smoke, M, max_len = layout
    split, heads, (slots, kv), cross_kv, mlp = ENCDEC_LAYOUTS[layout]
    cfg = get_config("whisper-tiny")
    cfg = cfg.smoke_variant() if smoke else cfg
    assert serve_parallel(cfg)
    meta = encdec.init(cfg, device="meta")
    specs, _, shard = serve.serve_layout(cfg, meta, B, max_len,
                                         {"data": 1, "model": M})
    assert shard.split == split
    blocks = shard_params(meta, specs, 0, M)["dec_layers"]
    assert blocks["self"]["wq"].shape[2] == blocks["cross"]["wq"].shape[2] == heads
    assert blocks["cross"]["wk"].shape[2] == cross_kv
    assert blocks["mlp"]["wu"].shape[2] == mlp
    cache = encdec.init_cache(cfg, B, max_len, device="meta", shard=shard)
    assert cache["k"].shape[2:4] == cache["v"].shape[2:4] == (slots, kv)
    assert cache["ck"].shape[2:4] == cache["cv"].shape[2:4] == (cfg.enc_seq,
                                                                cross_kv)


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-7b"])
def test_the_ssm_families_serve_on_their_blocks(arch):
    """The SSM and hybrid families serve over the model axis: the serving
    shard splits the SSD's channels and heads together, at published
    widths and on the smoke fields; a shard that splits only one of them
    is refused (``tests/test_torch_serve_tensor_parallel_ssm.py`` holds
    the step against JAX)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import serve_parallel, ssm
    from repro_torch.nn.sharding import serve_shard

    for cfg in (get_config(arch), get_config(arch).smoke_variant()):
        assert serve_parallel(cfg)
        for M in (2, 4):
            split = serve.serve_layout(cfg, ssm.init(cfg, device="meta"), B,
                                       16, {"data": 1, "model": M})[2].split
            assert {"d_inner", "ssm_heads", "vocab"} <= split, (cfg.name, M)
    with pytest.raises(ValueError, match="both or neither"):
        serve_shard({"w": ("d_inner",), "a": ("ssm_heads",)},
                    {"w": ("model",), "a": (None,)}, {}, {}, None, 0, 2)


def test_serve_shard_rules():
    """The serve rules and the shard they give: the kv heads split where
    the model axis divides them, else the slots, unless the guard keeps
    them whole; the kv heads split with the query heads whole raises."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.nn.sharding import serve_shard

    cfg = get_config("qwen2.5-3b").smoke_variant()
    meta = lm.init(cfg, device="meta")

    def split(M, max_len, data=1):
        return serve.serve_layout(cfg, meta, B, max_len,
                                  {"data": data, "model": M})[2].split

    assert {"heads", "kv_heads"} <= split(2, 16, 2) and "kv_seq" not in split(2, 16, 2)
    assert "kv_seq" in split(4, 16) and "kv_heads" not in split(4, 16)
    assert not {"kv_seq", "kv_heads"} & split(4, 30)
    assert serve.serve_layout(cfg, meta, B, 16, {"data": 4, "model": 1})[2] is None
    with pytest.raises(ValueError, match="query heads are whole"):
        serve_shard({"w": ("heads", "kv_heads")}, {"w": (None, "model")},
                    {}, {}, None, 0, 2)


if __name__ == "__main__":
    _jax_main(sys.argv[1])
