"""The model-parallel serve step of the encoder-decoder family
(``models/encdec.py``'s ``prefill``, ``build_cross_cache``,
``init_cache`` and ``decode_step`` under a serving ``ModelShard``, and
``launch.serve.run(..., mesh=)``).

* Each case runs the jitted JAX ``build_cross_cache`` and ``decode_step``
  (or ``prefill``) with the in-shardings of the JAX dry run's
  ``lower_serve`` on its mesh (one subprocess of 8 host devices for the
  file): the cross cache from frames drawn with numpy (0.1 x a standard
  normal, so the cross-attention reads keys and values that are not
  zero), then 12 greedy steps from a zero self cache. The port runs the
  same on 4 gloo ranks from its blocks of JAX's weights, its dp group's
  rows of the frames, fed JAX's tokens. Held: each rank's blocks of
  ``ck`` and ``cv`` as ``build_cross_cache`` gives them against the
  matching blocks of JAX's; each step's logits to rtol 1e-5 with a floor
  of 1e-5 of the step's largest logit; each rank's blocks of ``k``,
  ``v``, ``ck`` and ``cv`` after the steps to rtol 1e-5; ``pos``
  exactly; and the greedy tokens equal wherever JAX's top-2 margin is at
  least 1e-3. The cases (whisper-tiny's smoke variant: 4 query heads, 2
  kv heads, 16 frames): ``(2, 2)``, where both caches split by kv heads,
  1 a rank; ``(1, 4)``, where the kv heads stay whole, the self cache's
  16 slots split 4 a rank, the cross cache is whole on every rank and
  the cross-attention's queries are gathered; and ``prefill`` at ``(2,
  2)``.
* ``serve.run(..., mesh=)`` at ``(1, 4)`` gives the one-process run's
  tokens on every rank.

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
from test_torch_serve_tensor_parallel_ssm import _block
import _torch_cores  # noqa: F401  (this worker's share of the cores)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "whisper-tiny"
B, STEPS, PROMPT, MAX_LEN, RTOL, MARGIN = 4, 12, 16, 16, 1e-5, 1e-3
# name -> ((data, model), kind, the logical axes the serving shard splits)
CASES = {
    "heads-2x2": ((2, 2), "decode", {"heads", "kv_heads", "mlp", "vocab"}),
    "seq-1x4": ((1, 4), "decode", {"heads", "kv_seq", "mlp", "vocab"}),
    "prefill-2x2": ((2, 2), "prefill", {"heads", "kv_heads", "mlp", "vocab"}),
}
DECODE = [name for name, case in CASES.items() if case[1] == "decode"]
SERVE_FLAGS = ["--arch", ARCH, "--smoke", "--batch", str(B),
               "--prompt-len", "2", "--new-tokens", "6", "--max-len",
               str(MAX_LEN), "--device", "cpu"]
SERVE_MODEL = 4
WAIT = 120.0


def _cfg(pkg):
    import importlib

    return importlib.import_module(f"{pkg}.configs").get_config(
        ARCH).smoke_variant()


def _inputs(cfg):
    rng = np.random.default_rng(9)
    return {"first": rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32),
            "tokens": rng.integers(0, cfg.vocab, (B, PROMPT)).astype(np.int32),
            "frames": (0.1 * rng.standard_normal(
                (B, cfg.enc_seq, cfg.d_model))).astype(np.float32)}


# ---------------------------------------------------------------------------
# the JAX side, in a subprocess of 8 host devices
# ---------------------------------------------------------------------------
def _jax_case(name, cfg, params, axes, inputs, out_dir):
    """``lower_serve``'s layout on a ``(data, model)`` host mesh: its serve
    rules, the parameters' and the cache's specs, the batch over the dp
    axis; then the jitted cross cache and steps, greedy from a zero self
    cache."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.models import encdec
    from repro.nn import sharding as shlib

    (W, M), kind, _ = CASES[name]
    mesh = jax.make_mesh((W, M), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto),
                         devices=jax.devices()[:W * M])
    rules = ({"kv_seq": None} if cfg.n_heads and cfg.n_kv_heads % M == 0
             else {"kv_seq": "model", "kv_heads": None})

    def shardings(tree, tree_axes):
        specs = shlib.tree_specs(tree, tree_axes, mesh, rules=rules,
                                 dp_axes=("data",))
        return jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                            is_leaf=lambda x: isinstance(x, P))

    rows = NamedSharding(mesh, P("data"))
    ps = shardings(params, axes)
    frames = jnp.asarray(inputs["frames"])
    out = {}
    with mesh:
        if kind == "prefill":
            step = jax.jit(lambda p, b: encdec.prefill(p, cfg, b),
                           in_shardings=(ps, {"tokens": rows, "frames": rows}))
            out["logits"] = np.asarray(step(params, {
                "tokens": jnp.asarray(inputs["tokens"]), "frames": frames}))
        else:
            cache = encdec.init_cache(cfg, B, MAX_LEN)
            cs = shardings(cache, encdec.cache_axes(cfg))
            cross = jax.jit(lambda p, f: encdec.build_cross_cache(p, cfg, f),
                            in_shardings=(ps, rows))
            ck, cv = cross(params, frames)
            out["cross/ck"], out["cross/cv"] = np.asarray(ck), np.asarray(cv)
            cache = {**cache, "ck": ck, "cv": cv}
            step = jax.jit(lambda p, c, t: encdec.decode_step(p, cfg, c, t),
                           in_shardings=(ps, cs, rows),
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
        import jax

        from repro.models import encdec

        cfg = _cfg("repro")
        params, axes = encdec.init(jax.random.PRNGKey(0), cfg)
        np.savez(f"{out_dir}/params.tmp.npz", **{
            f"p0/{k}": v for k, v in
            _flatten(jax.tree.map(np.asarray, params)).items()})
        os.replace(f"{out_dir}/params.tmp.npz", f"{out_dir}/params.npz")
        inputs = _inputs(cfg)
        for name in CASES:
            _jax_case(name, cfg, params, axes, inputs, out_dir)
    except BaseException:
        Path(out_dir, "jax.failed").write_text("failed")
        raise


# ---------------------------------------------------------------------------
# the port on a rank
# ---------------------------------------------------------------------------
def _port_case(name, whole, jx, groups):
    """Case ``name`` on this rank of ``groups`` from its blocks of JAX's
    weights ``whole``: the cross cache ``build_cross_cache`` gives from its
    dp group's rows of the frames, the logits of every step (fed JAX's
    tokens) and the final cache blocks; or the prompt's logits; and the
    shard's split axes."""
    from repro_torch.launch import serve
    from repro_torch.models import encdec
    from repro_torch.nn.sharding import shard_params

    (W, M), kind, _ = CASES[name]
    cfg = _cfg("repro_torch")
    specs, _, shard = serve.serve_layout(
        cfg, whole, B, MAX_LEN, groups.mesh_shape, groups.axis_names,
        groups.model_group, groups.shard)
    params = shard_params(whole, specs, groups.shard, M)
    n = B // W
    rows = slice(groups.rank * n, (groups.rank + 1) * n)
    inputs = _inputs(cfg)
    frames = torch.from_numpy(inputs["frames"][rows])
    out = {"split": sorted(shard.split), "rows": (rows.start, rows.stop)}
    if kind == "prefill":
        tokens = torch.from_numpy(inputs["tokens"][rows]).long()
        out["logits"] = encdec.prefill(params, cfg, {"tokens": tokens,
                                                     "frames": frames},
                                       shard=shard)
        return out
    cache = encdec.init_cache(cfg, n, MAX_LEN, device="cpu", shard=shard)
    cache["ck"], cache["cv"] = encdec.build_cross_cache(params, cfg, frames,
                                                        shard=shard)
    out["cross"] = {"ck": cache["ck"].clone(), "cv": cache["cv"].clone()}
    logits = []
    for t in range(STEPS):
        tokens = torch.from_numpy(jx["fed"][rows, t:t + 1]).long()
        lg, cache = encdec.decode_step(params, cfg, cache, tokens, shard=shard)
        logits.append(lg[:, 0])
    out.update(logits=torch.stack(logits, 1), cache=dict(cache))
    return out


def _rank(rank, world, store, out_dir):
    import torch.distributed as dist

    from repro_torch import convert
    from repro_torch.launch import mesh, serve

    mesh.init_file_store(store, rank, world, "gloo")
    try:
        whole = convert.params_from_jax(
            _nest(_section(_wait_for(out_dir, "params"), "p0")), device="cpu")
        out = {}
        for name, ((_, M), *_rest) in CASES.items():
            out[name] = _port_case(name, whole, _wait_for(out_dir, name),
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

    d = tmp_path_factory.mktemp("serve_tp_encdec")
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


def _held_blocks(got, jx, prefix, where, rank, name):
    """Each leaf of ``got`` (a rank's cache blocks) within rtol 1e-5 of its
    block of JAX's whole leaf ``jx[prefix + leaf]``."""
    from repro_torch.models import encdec

    (W, M), _, split = CASES[name]
    axes = encdec.cache_axes(_cfg("repro_torch"))
    rows = slice((rank // M) * (B // W), (rank // M + 1) * (B // W))
    for leaf in sorted(set(got) - {"pos"}):
        block = _block(jx[f"{prefix}{leaf}"], axes[leaf], split, rank % M, M,
                       rows)
        assert got[leaf].shape == block.shape, (where, leaf)
        # the cross cache from frames that are not zero
        assert leaf not in ("ck", "cv") or np.abs(block).max() > 0, (where,
                                                                      leaf)
        np.testing.assert_allclose(got[leaf].numpy(), block, rtol=RTOL,
                                   atol=RTOL * np.abs(block).max(),
                                   err_msg=f"{where} {prefix}{leaf}")


@pytest.mark.parametrize("name", DECODE)
def test_cross_cache_is_the_ranks_block_of_jaxs(runs, name):
    """``build_cross_cache`` under the serving shard: the rank's kv heads
    of JAX's ``ck`` and ``cv`` at ``(2, 2)``, the whole of them, every
    frame, at ``(1, 4)``, the same bits on every rank of a model group."""
    jax_runs, outs = runs
    (_, M), _, _ = CASES[name]
    for rank, out in enumerate(outs):
        got = out[name]["cross"]
        _held_blocks(got, jax_runs[name], "cross/", f"{name} rank {rank}",
                     rank, name)
        if "kv_heads" not in CASES[name][2]:
            peer = outs[rank - rank % M][name]["cross"]
            for leaf in ("ck", "cv"):
                assert torch.equal(got[leaf], peer[leaf]), (name, rank, leaf)


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_serve_as_jax(runs, name):
    jax_runs, outs = runs
    (W, M), kind, want_split = CASES[name]
    jx = jax_runs[name]
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
        assert set(cache) == {"k", "v", "ck", "cv", "pos"}, where
        _held_blocks(cache, jx, "cache/", where, rank, name)
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
    """``serve.run(..., mesh=)`` of the encoder-decoder at ``(1, 4)``:
    every rank decodes the one-process run's batch, from the same first
    tokens, to the same greedy tokens."""
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
