"""The port's serving path (``prefill``, ``init_cache``, ``cache_axes``,
``decode_step`` of each family, ``encdec.build_cross_cache`` and
``launch/serve.py``) against the JAX package's on shared weights.

Weights come from the JAX package's ``init`` and cross by
``repro_torch.convert.params_from_jax``; tokens and frames are numpy. The
JAX side runs under ``jax.jit``, as its serving driver runs its step.

* The cache: the JAX tree, shapes and dtypes for every config at its
  published size (nothing allocated: ``jax.eval_shape`` and the ``meta``
  device), and ``cache_axes`` equal to JAX's.
* 12 teacher-forced steps of the smoke variants of qwen2.5-3b,
  granite-3-8b-swa, mixtral-8x7b (at ``capacity_factor = 8.0``, dropless
  as ``tests/test_archs.py`` runs it), internvl2-1b, whisper-tiny,
  mamba2-780m and zamba2-7b: logits and every cache leaf after the last
  step to rtol 1e-5, with an absolute floor of 1e-5 of the largest
  magnitude (float32 matmuls sum in another order in XLA:CPU and
  PyTorch), ``pos`` equal. granite-3-8b-swa also runs 24 steps, which wrap
  its ring of 16 slots.
* The port against itself: its decode equals its ``forward`` to
  ``tests/test_archs.py``'s rtol = atol = 2e-3 (the VLM step has no patch
  prefix, so its forward is the one without the prefix), and its
  ``prefill`` (chunked attention) equals ``forward(mode="dense")`` to
  rtol 1e-5.
* The CLI: ``serve.run`` restores a checkpoint that ``repro.checkpoint``
  wrote and decodes, greedily, the tokens of a loop of jitted JAX steps
  from the port's first tokens, wherever the two stacks cannot part: up
  to a row's first step whose JAX top-2 logit margin is below
  ``MARGIN`` (the logits agree to about 1e-6 of their magnitude, a few
  units; a margin of 1e-3 cannot flip).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import get_config as jax_get_config
from repro.models import get_family as jax_get_family
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch import serve
from repro_torch.models import get_family, lm
from repro_torch.tree import tree_items

RTOL = 1e-5
FORWARD_TOL = 2e-3  # tests/test_archs.py's decode-vs-forward tolerance
MARGIN = 1e-3
STEPS = 12
FAMILY_ARCHS = ("qwen2.5-3b", "granite-3-8b-swa", "mixtral-8x7b",
                "internvl2-1b", "whisper-tiny", "mamba2-780m", "zamba2-7b")


def _close(got, want, rtol=RTOL, err_msg=""):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max(), err_msg=err_msg)


# a case is an arch, or "arch:name" with fields replaced in its smoke
# variant: qwen2.5-3b with a vocabulary of 500 (padded to 512, so the
# step masks 12 logits)
CASES = {"mixtral-8x7b": {"capacity_factor": 8.0},
         "qwen2.5-3b:padded-vocab": {"vocab": 500}}


def _configs(case):
    arch, fields = case.split(":")[0], CASES.get(case, {})
    return (jax_get_config(arch).smoke_variant().replace(**fields),
            tconfigs.get_config(arch).smoke_variant().replace(**fields))


def _jax_paths(tree):
    return [(".".join(str(getattr(k, "key", k)) for k in path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _models(arch, seed=1):
    jcfg, tcfg = _configs(arch)
    jmod, tmod = jax_get_family(jcfg), get_family(tcfg)
    jparams, _ = jmod.init(jax.random.PRNGKey(seed), jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    return jcfg, tcfg, jmod, tmod, jparams, tparams


def _frames(cfg, B, rng):
    return (0.1 * rng.standard_normal((B, cfg.enc_seq, cfg.d_model))
            ).astype(np.float32)


@pytest.mark.parametrize("arch", list(tconfigs.ARCHS))
def test_init_cache_matches_jax(arch):
    """Tree paths in the JAX leaf order, shapes and dtypes of the cache of
    the published config (batch 3, ``max_len`` 40), and ``cache_axes``."""
    jcfg, tcfg = jax_get_config(arch), tconfigs.get_config(arch)
    jmod, tmod = jax_get_family(jcfg), get_family(tcfg)
    want = _jax_paths(jax.eval_shape(lambda: jmod.init_cache(jcfg, 3, 40)))
    got = tree_items(tmod.init_cache(tcfg, 3, 40, device="meta"))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, t), (_, j) in zip(got, want, strict=True):
        assert tuple(t.shape) == tuple(j.shape), path
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype), path
    assert tmod.cache_axes(tcfg) == jmod.cache_axes(jcfg)


def _jax_cache(jcfg, jmod, jparams, B, max_len, frames):
    cache = jmod.init_cache(jcfg, B, max_len)
    if frames is not None:
        ck, cv = jax.jit(lambda p, f: jmod.build_cross_cache(p, jcfg, f))(
            jparams, frames)
        cache.update({"ck": ck, "cv": cv})
    return cache


def _torch_cache(tcfg, tmod, tparams, B, max_len, frames):
    cache = tmod.init_cache(tcfg, B, max_len, device="cpu")
    if frames is not None:
        cache["ck"], cache["cv"] = tmod.build_cross_cache(
            tparams, tcfg, torch.from_numpy(frames))
    return cache


def _teacher_forced(arch, steps, max_len):
    """``steps`` decode steps of both packages over the same tokens:
    (JAX logits, port logits, JAX cache, port cache, tokens, frames, port
    config and params)."""
    jcfg, tcfg, jmod, tmod, jparams, tparams = _models(arch)
    rng = np.random.default_rng(0)
    B = 2
    tokens = rng.integers(0, jcfg.vocab, (B, steps)).astype(np.int32)
    frames = _frames(jcfg, B, rng) if jcfg.family == "encdec" else None
    jcache = _jax_cache(jcfg, jmod, jparams, B, max_len, frames)
    tcache = _torch_cache(tcfg, tmod, tparams, B, max_len, frames)
    step = jax.jit(lambda p, c, t: jmod.decode_step(p, jcfg, c, t))
    jlog, tlog = [], []
    for t in range(steps):
        logits, jcache = step(jparams, jcache, tokens[:, t:t + 1])
        jlog.append(np.asarray(logits)[:, 0])
        logits, tcache = tmod.decode_step(
            tparams, tcfg, tcache, torch.from_numpy(tokens[:, t:t + 1]).long())
        tlog.append(logits[:, 0].numpy())
    return (np.stack(jlog, 1), np.stack(tlog, 1), jcache, tcache, tokens,
            frames, tcfg, tparams)


def _hold_caches(jcache, tcache):
    got = tree_items(tcache)
    want = _jax_paths(jcache)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, t), (_, j) in zip(got, want, strict=True):
        if path == "pos":
            assert t.dtype == torch.int32 and int(t) == int(j)
        else:
            _close(t.numpy(), np.asarray(j), err_msg=path)


@pytest.mark.parametrize("arch", [*FAMILY_ARCHS, "qwen2.5-3b:padded-vocab"])
def test_decode_steps_match_jitted_jax(arch):
    """12 teacher-forced steps into a cache of 12 slots: logits each step,
    every cache leaf after the last, ``pos``."""
    jlog, tlog, jcache, tcache, *_ = _teacher_forced(arch, STEPS, STEPS)
    assert tlog.shape == jlog.shape
    for t in range(STEPS):
        _close(tlog[:, t], jlog[:, t], err_msg=f"step {t}")
    _hold_caches(jcache, tcache)
    assert int(tcache["pos"]) == STEPS


def test_ring_cache_wraps_and_matches_jax_and_the_windowed_forward():
    """granite-3-8b-swa's smoke window is 16: 24 steps into ``max_len``
    24 wrap its ring of 16 slots. The logits and the ring equal JAX's, and
    the logits the windowed forward's."""
    jlog, tlog, jcache, tcache, tokens, _, tcfg, tparams = _teacher_forced(
        "granite-3-8b-swa", 24, 24)
    assert tcfg.sliding_window == 16 and tcache["k"].shape[2] == 16
    _close(tlog, jlog)
    _hold_caches(jcache, tcache)
    full, _ = lm.forward(tparams, tcfg, {"tokens": torch.from_numpy(tokens).long()})
    V = tcfg.vocab
    np.testing.assert_allclose(tlog[..., :V], full[..., :V].numpy(),
                               rtol=FORWARD_TOL, atol=FORWARD_TOL)


@pytest.mark.parametrize("arch", [*FAMILY_ARCHS, "qwen2.5-3b:padded-vocab"])
def test_decode_matches_forward_and_prefill_matches_dense(arch):
    """The port against itself on its seeded weights: 12 cached steps
    equal ``forward`` over the 12 tokens on the real vocabulary (the step
    masks the padding), and ``prefill`` (chunked, with ``attn_block`` 8,
    so the 12 keys take two blocks, the last padded) equals
    ``forward(mode="dense")``."""
    _, tcfg = _configs(arch)
    tcfg = tcfg.replace(attn_block=8)
    tmod = get_family(tcfg)
    params = tmod.init(tcfg, seed=2, device="cpu")
    rng = np.random.default_rng(3)
    B = 2
    tokens = torch.from_numpy(rng.integers(0, tcfg.vocab, (B, STEPS))).long()
    frames = _frames(tcfg, B, rng) if tcfg.family == "encdec" else None
    cache = _torch_cache(tcfg, tmod, params, B, STEPS, frames)
    steps = []
    for t in range(STEPS):
        logits, cache = tmod.decode_step(params, tcfg, cache, tokens[:, t:t + 1])
        steps.append(logits[:, 0])
    batch = {"tokens": tokens}
    if frames is not None:
        batch["frames"] = torch.from_numpy(frames)
    # the decode step has no patch prefix: the VLM's forward without it
    fcfg = tcfg.replace(family="dense") if tcfg.family == "vlm" else tcfg
    with torch.no_grad():
        full, _ = get_family(fcfg).forward(params, fcfg, batch)
    V = tcfg.vocab
    dec = torch.stack(steps, 1)
    assert bool((dec[..., V:] == -1e30).all())
    np.testing.assert_allclose(dec[..., :V].numpy(), full[..., :V].numpy(),
                               rtol=FORWARD_TOL, atol=FORWARD_TOL)
    if tcfg.family == "vlm":
        batch["patches"] = torch.from_numpy((0.1 * rng.standard_normal(
            (B, tcfg.n_patches, tcfg.vision_dim))).astype(np.float32))
    with torch.no_grad():
        dense, _ = tmod.forward(params, tcfg, batch, mode="dense")
    pre = tmod.prefill(params, tcfg, batch)
    assert pre.shape == (B, STEPS, tcfg.padded_vocab)
    _close(pre.numpy(), dense.numpy())


def test_prefill_matches_jitted_jax():
    """granite-3-8b-swa's prefill (chunked, ``attn_block`` 8 over 20
    tokens: three blocks, the last padded, under the window of 16) equals
    the jitted JAX prefill."""
    jcfg, tcfg, jmod, tmod, jparams, tparams = _models("granite-3-8b-swa")
    jcfg, tcfg = jcfg.replace(attn_block=8), tcfg.replace(attn_block=8)
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab, (2, 20)
                                               ).astype(np.int32)
    want = jax.jit(lambda p, b: jmod.prefill(p, jcfg, b))(
        jparams, {"tokens": jnp.asarray(tokens)})
    got = tmod.prefill(tparams, tcfg, {"tokens": torch.from_numpy(tokens).long()})
    _close(got.numpy(), np.asarray(want))


def test_build_cross_cache_matches_jax():
    """whisper-tiny's cross cache: the encoder once, then every decoder
    layer's ``wk`` and ``wv``."""
    jcfg, tcfg, jmod, tmod, jparams, tparams = _models("whisper-tiny")
    frames = _frames(jcfg, 2, np.random.default_rng(5))
    want = jax.jit(lambda p, f: jmod.build_cross_cache(p, jcfg, f))(
        jparams, frames)
    got = tmod.build_cross_cache(tparams, tcfg, torch.from_numpy(frames))
    for g, w, name in zip(got, want, ("ck", "cv"), strict=True):
        assert tuple(g.shape) == (jcfg.n_layers, 2, jcfg.enc_seq,
                                  jcfg.eff_kv_heads, jcfg.hd)
        _close(g.numpy(), np.asarray(w), err_msg=name)


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------
def _jax_greedy(arch, ckpt_dir, first, steps, max_len):
    """The JAX driver's loop (jitted step, argmax fed back) on the
    checkpoint, from ``first``: (tokens [B, steps], top-2 margins [B,
    steps])."""
    jcfg = jax_get_config(arch).smoke_variant()
    jmod = jax_get_family(jcfg)
    params, _ = jmod.init(jax.random.PRNGKey(0), jcfg)
    params = jckpt.restore(f"{ckpt_dir}/params", params)
    B = first.shape[0]
    cache = jmod.init_cache(jcfg, B, max_len)
    if jcfg.family == "encdec":
        frames = jnp.zeros((B, jcfg.enc_seq, jcfg.d_model), jcfg.jdtype)
        cache.update(dict(zip(("ck", "cv"),
                              jmod.build_cross_cache(params, jcfg, frames))))
    step = jax.jit(lambda p, c, t: jmod.decode_step(p, jcfg, c, t))
    tokens = jnp.asarray(first.numpy().astype(np.int32))
    out, margins = [], []
    for _ in range(steps):
        logits, cache = step(params, cache, tokens)
        last = np.asarray(logits[:, -1])
        top2 = np.sort(last, axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        tokens = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        out.append(np.asarray(tokens)[:, 0])
    return np.stack(out, 1), np.stack(margins, 1)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mixtral-8x7b", "whisper-tiny",
                                  "mamba2-780m", "zamba2-7b"])
def test_serve_restores_a_jax_checkpoint_and_decodes_jax_tokens(
        arch, tmp_path, capsys):
    """``serve.run --smoke --restore`` on a checkpoint of JAX weights that
    ``repro.checkpoint.save`` wrote (the port's seeded weights differ)
    decodes the tokens of the jitted JAX loop from the same first tokens,
    up to each row's first step whose JAX top-2 margin is below
    ``MARGIN``; and prints the JAX driver's two lines."""
    jcfg = jax_get_config(arch).smoke_variant()
    jparams, _ = jax_get_family(jcfg).init(jax.random.PRNGKey(7), jcfg)
    jckpt.save(str(tmp_path / "params"), jparams)
    args = serve.parse_args(["--arch", arch, "--smoke", "--device", "cpu",
                             "--restore", str(tmp_path), "--batch", "3",
                             "--prompt-len", "4", "--new-tokens", "12",
                             "--max-len", "16"])
    res = serve.run(args)
    lines = capsys.readouterr().out.splitlines()
    assert lines[-2].startswith(f"{arch}: decoded 36 tokens in ")
    assert lines[-1].startswith("sample token ids: [")
    assert res.first.shape == (3, 1) and res.prompt.shape == (3, 4)
    assert res.tokens.shape == (3, 12) and len(res.step_ms) == 12
    got = torch.cat([res.prompt, res.tokens], 1).numpy()
    want, margins = _jax_greedy(arch, tmp_path, res.first, 16, 16)
    compared = 0
    for row in range(3):
        low = np.flatnonzero(margins[row] < MARGIN)
        upto = low[0] + 1 if low.size else 16  # a near-tie step may differ
        np.testing.assert_array_equal(got[row, :upto], want[row, :upto],
                                      err_msg=f"row {row}")
        compared += upto
    assert compared >= 24, compared


@pytest.mark.parametrize("arch,kv", [("qwen2.5-3b", "k/v"),
                                     ("zamba2-7b", "attn_k/attn_v"),
                                     ("whisper-tiny", "k/v")])
def test_serve_refuses_a_request_past_a_cache_without_a_ring(
        arch, kv, monkeypatch):
    """8 + 24 steps into 20 slots: refused before any step (the family's
    ``decode_step`` is never reached), naming the JAX package's clamp."""
    cfg = tconfigs.get_config(arch).smoke_variant()

    def no_step(*a, **k):
        raise AssertionError("a step ran")

    monkeypatch.setattr(get_family(cfg), "decode_step", no_step)
    args = serve.parse_args(["--arch", arch, "--smoke", "--device", "cpu",
                             "--max-len", "20"])
    with pytest.raises(SystemExit, match=rf"32 steps exceed --max-len 20.*"
                       rf"{kv} cache.*dynamic_update_slice would clamp"):
        serve.run(args)


@pytest.mark.parametrize("arch", ["granite-3-8b-swa", "mamba2-780m"])
def test_serve_accepts_a_long_request_into_a_ring_or_no_kv_cache(arch):
    """A ring (granite-3-8b-swa's 16 slots) and a cache with no KV
    (mamba2-780m) take 8 + 24 steps at ``max_len`` 20."""
    cfg = tconfigs.get_config(arch)
    assert get_family(cfg).ringless_kv(cfg) == []
    res = serve.run(serve.parse_args(["--arch", arch, "--smoke", "--device",
                                      "cpu", "--max-len", "20"]))
    assert res.tokens.shape == (4, 24)
    assert ((res.tokens >= 0) & (res.tokens < 512)).all()


def test_jax_clamps_a_write_past_the_end_which_the_port_refuses():
    """The hazard the refusal guards: under ``jit`` a write at slot 6 of
    4 lands in slot 3, over the newest key. The port's ``write_kv`` raises
    instead of clamping."""
    write = jax.jit(lambda c, x, i: jax.lax.dynamic_update_slice_in_dim(
        c, x, i, axis=1))
    cache = jnp.arange(4, dtype=jnp.float32).reshape(1, 4, 1, 1)
    got = np.asarray(write(cache, jnp.full((1, 1, 1, 1), 9.0), 6)).ravel()
    np.testing.assert_array_equal(got, [0.0, 1.0, 2.0, 9.0])
    kc = torch.zeros(1, 4, 1, 1)
    vc = torch.zeros(1, 4, 1, 1)
    new = torch.ones(1, 1, 1, 1)
    lm.write_kv(kc, vc, new, new, torch.tensor(3, dtype=torch.int32))
    assert kc[0, 3].item() == 1.0
    with pytest.raises((IndexError, RuntimeError)):
        lm.write_kv(kc, vc, new, new, torch.tensor(6, dtype=torch.int32))


def test_serve_defaults_to_cuda():
    args = serve.parse_args(["--smoke"])
    assert args.device == "cuda" and args.arch == "qwen2.5-3b"
    assert (args.batch, args.prompt_len, args.new_tokens, args.max_len) == (
        4, 8, 24, 64)
    if not torch.cuda.is_available():  # no fallback to the CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.run(args)
