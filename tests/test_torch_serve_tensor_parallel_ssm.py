"""The model-parallel serve step of the SSM and hybrid families
(``models/ssm.py``'s ``prefill``, ``init_cache`` and ``decode_step``
under a serving ``ModelShard``, ``nn.ssd``'s decode step on the rank's
conv block and SSM heads, and ``launch.serve.run(..., mesh=)``).

* Each case runs the jitted JAX ``decode_step`` (or ``prefill``) with the
  in-shardings of the JAX dry run's ``lower_serve`` on its mesh (one
  subprocess of 8 host devices for the file), 12 greedy steps from a zero
  cache; the port runs the same steps on 4 gloo ranks from its blocks of
  JAX's weights, fed JAX's tokens. Held: each step's logits to rtol 1e-5
  with a floor of 1e-5 of the step's largest logit; each rank's blocks of
  the conv windows, the SSM states and the shared block's ``attn_k`` and
  ``attn_v`` against the matching blocks of JAX's cache to rtol 1e-5;
  ``pos`` exactly; and the greedy tokens equal wherever JAX's top-2
  margin is at least 1e-3. The cases (smoke variants: d_inner 256, 16
  SSM heads of 16, state 16, so 288 conv channels; zamba2's 4 query
  heads and 2 kv heads): zamba2-7b at ``(2, 2)`` (the kv heads split),
  zamba2-7b at ``(1, 4)`` (the shared block's slots split, its queries
  gathered), mamba2-780m at ``(1, 4)`` (72 conv channels a rank: rank
  3's block is the last 40 ``x`` channels and all of ``B`` and ``C``),
  and mamba2-780m's ``prefill`` at ``(2, 2)``.
* ``serve.run(..., mesh=)`` of zamba2-7b's smoke variant on the 4 ranks
  at ``(1, 4)`` gives the one-process run's tokens.

The ranks start while the JAX subprocess compiles and take each case as
its results appear. Every wait is bounded at 120 s (the JAX subprocess
at 300 s).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_model_parallel import _flatten, _nest, _section
from test_torch_serve_tensor_parallel import _close, _wait_for

ROOT = Path(__file__).resolve().parents[1]
B, STEPS, PROMPT, RTOL, MARGIN = 4, 12, 16, 1e-5, 1e-3
SSD = {"d_inner", "ssm_heads", "vocab"}
# name -> (arch, (data, model), max_len, kind, the logical axes the
# serving shard splits)
CASES = {
    "mamba-1x4": ("mamba2-780m", (1, 4), 16, "decode", SSD),
    "zamba-heads-2x2": ("zamba2-7b", (2, 2), 16, "decode",
                        SSD | {"heads", "kv_heads", "mlp"}),
    "zamba-seq-1x4": ("zamba2-7b", (1, 4), 16, "decode",
                      SSD | {"heads", "kv_seq", "mlp"}),
    "mamba-prefill-2x2": ("mamba2-780m", (2, 2), None, "prefill", SSD),
}
SERVE_FLAGS = ["--arch", "zamba2-7b", "--smoke", "--batch", str(B),
               "--prompt-len", "2", "--new-tokens", "6", "--max-len", "16",
               "--device", "cpu"]
SERVE_MODEL = 4
WAIT = 120.0


def _cfg(pkg, name):
    import importlib

    return importlib.import_module(f"{pkg}.configs").get_config(
        CASES[name][0]).smoke_variant()


def _inputs(cfg, name):
    rng = np.random.default_rng(7)
    if CASES[name][3] == "prefill":
        return {"tokens": rng.integers(0, cfg.vocab, (B, PROMPT)).astype(
            np.int32)}
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

    _, (W, M), max_len, kind, _ = CASES[name]
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
                       **{f"cache/{k}": v for k, v in _flatten(
                           jax.tree.map(np.asarray, cache)).items()})
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
def _port_case(name, jx, groups):
    """Case ``name`` on this rank of ``groups`` from its blocks of JAX's
    weights: the logits of every step (fed JAX's tokens, its dp group's
    rows), the final cache blocks by path and ``pos``, and the shard's
    split axes."""
    from repro_torch import convert
    from repro_torch.launch import serve
    from repro_torch.models import get_family
    from repro_torch.nn.sharding import shard_params

    _, (W, M), max_len, kind, _ = CASES[name]
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
        tokens = torch.from_numpy(_inputs(cfg, name)["tokens"][rows]).long()
        out["logits"] = mod.prefill(params, cfg, {"tokens": tokens},
                                    shard=shard)
        return out
    cache = mod.init_cache(cfg, n, max_len, device="cpu", shard=shard)
    logits = []
    for t in range(STEPS):
        tokens = torch.from_numpy(jx["fed"][rows, t:t + 1]).long()
        lg, cache = mod.decode_step(params, cfg, cache, tokens, shard=shard)
        logits.append(lg[:, 0])
    out.update(logits=torch.stack(logits, 1),
               cache={k: torch.from_numpy(v) for k, v in
                      _flatten(cache).items()})
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
        res = serve.run(serve.parse_args(SERVE_FLAGS),
                        mesh=mesh.make_host_groups(model=SERVE_MODEL))
        out["serve"] = {"first": res.first, "prompt": res.prompt,
                        "tokens": res.tokens}
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch import mesh

    d = tmp_path_factory.mktemp("serve_tp_ssm")
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


def _block(want, axes, split, shard, M, rows):
    """The rank's block of one whole leaf of JAX's cache: its dp group's
    rows, and its ``shard``'s contiguous block of every axis the serving
    shard splits (the conv channels on ``"d_inner"``, the SSM heads, the
    shared block's slots or kv heads)."""
    idx = []
    for dim, name in enumerate(axes):
        if name == "batch":
            idx.append(rows)
        elif name in split:
            n = want.shape[dim] // M
            idx.append(slice(shard * n, (shard + 1) * n))
        else:
            idx.append(slice(None))
    return want[tuple(idx)]


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_serve_as_jax(runs, name):
    from repro_torch.models import ssm

    jax_runs, outs = runs
    _, (W, M), _, kind, want_split = CASES[name]
    jx = jax_runs[name]
    axes = _flatten(ssm.cache_axes(_cfg("repro_torch", name)))
    for rank, out in enumerate(outs):
        got = out[name]
        where = f"{name} rank {rank}"
        assert set(got["split"]) == want_split, (where, got["split"])
        rows = slice(*got["rows"])
        assert rows == slice((rank // M) * (B // W), (rank // M + 1) * (B // W))
        _close(got["logits"].numpy(), jx["logits"][rows], where)
        if kind == "prefill":
            continue
        cache = got["cache"]
        assert int(cache["pos"]) == int(jx["cache/pos"]) == STEPS, where
        assert set(cache) == {k[len("cache/"):] for k in jx
                              if k.startswith("cache/")}, where
        for leaf in sorted(set(cache) - {"pos"}):
            block = _block(jx[f"cache/{leaf}"], tuple(axes[leaf]),
                           want_split, rank % M, M, rows)
            assert cache[leaf].shape == block.shape, (where, leaf)
            np.testing.assert_allclose(cache[leaf].numpy(), block, rtol=RTOL,
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


def test_serve_run_on_ranks_equals_one_process(runs):
    """``serve.run(..., mesh=)`` of the hybrid at ``(1, 4)``: every rank
    decodes the one-process run's batch, from the same first tokens, to
    the same greedy tokens."""
    from repro_torch.launch import serve

    _, outs = runs
    want = serve.run(serve.parse_args(SERVE_FLAGS))
    for rank, out in enumerate(outs):
        got = out["serve"]
        assert torch.equal(got["first"], want.first), rank
        assert torch.equal(got["prompt"], want.prompt), rank
        assert torch.equal(got["tokens"], want.tokens), rank


if __name__ == "__main__":
    _jax_main(sys.argv[1])
