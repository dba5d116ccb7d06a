"""Every model family through the port's trainer against the JAX
package's: each family's smoke config, three steps at W = 2 against the
JAX step composed per worker (``test_torch_train._jax_composed_train``),
fastpath on and off, and the training CLI on every model config. Kept in
a file of its own beside ``tests/test_torch_train.py`` so that the two
share the suite's time over two workers.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import compact as jc
from repro_torch import convert
from repro_torch.comm.fastpath import FastpathCounts
from repro_torch.core import distributed as td
from repro_torch.core.sparsify import SparsifierConfig
from repro_torch.optim import OptConfig, make_optimizer
from repro_torch.tree import tree_items
from test_torch_train import LR, RTOL, SPARSITY, STEPS, _close, _jax_composed_train
import _torch_cores  # noqa: F401  (this worker's share of the cores)

# the error state of the SSD's A_log and dt_bias leaves: their gradients
# agree to rtol 1e-4 (see tests/test_torch_model.py)
SSD_DECAY_RTOL = 1e-4
# one config per family the port trains, at smoke_variant()
FAMILY_ARCHS = ("qwen2.5-3b", "deepseek-moe-16b", "internvl2-1b",
                "whisper-tiny", "mamba2-780m", "zamba2-7b")


def _batches_family(cfg, n, W, S=16):
    """``n`` global batches of W rows (one per worker) for ``cfg``, the VLM
    family's patches and the encoder-decoder family's frames included,
    from numpy."""
    rng = np.random.default_rng(17)
    out = []
    for _ in range(n):
        b = {key: rng.integers(0, cfg.vocab, (W, S)).astype(np.int32)
             for key in ("tokens", "labels")}
        if cfg.family == "vlm":
            b["patches"] = (0.1 * rng.standard_normal(
                (W, cfg.n_patches, cfg.vision_dim))).astype(np.float32)
        if cfg.family == "encdec":
            b["frames"] = (0.1 * rng.standard_normal(
                (W, cfg.enc_seq, cfg.d_model))).astype(np.float32)
        out.append(b)
    return out


@pytest.fixture(scope="module", params=FAMILY_ARCHS)
def jax_family_run(request):
    from repro.configs import get_config as jax_get_config

    cfg = jax_get_config(request.param).smoke_variant()
    batches = _batches_family(cfg, STEPS, 2)
    return request.param, batches, _jax_composed_train(2, cfg=cfg,
                                                       batches=batches)


@pytest.mark.parametrize("fastpath", ["off", "on"])
def test_family_train_steps_match_jax_at_two_workers(jax_family_run, fastpath):
    """A dense (QKV bias, GQA), an MoE (routed top-2 of 4 and a shared
    expert), a VLM (patch prefix), an encoder-decoder (frames, cross
    attention, LayerNorm), an SSM and a hybrid (grouped mamba blocks and
    the shared attention block) config at ``smoke_variant()``: three
    steps at W = 2 against the JAX step at W = 2 (``_jax_composed_train``),
    the port's fastpath on and off: losses and params to the file's
    tolerances, every worker's round counter exactly, its error to rtol
    1e-5 with the file's floor (1e-4 on the SSD's ``A_log`` and
    ``dt_bias`` leaves) and the sent sets by index; with the fastpath on,
    every leaf fused and its rounds counted."""
    from repro_torch import configs as tconfigs

    arch, batches, (p0, jlosses, _, jparams, jstate, _) = jax_family_run
    W = 2
    cfg = tconfigs.get_config(arch).smoke_variant()
    dist = td.DistConfig(
        sparsifier=SparsifierConfig(kind="regtopk", sparsity=SPARSITY),
        optimizer=OptConfig(kind="adam", learning_rate=LR), fastpath=fastpath,
    )
    params = convert.params_from_jax(p0, device="cpu")
    plan = td.build_plan(params, SPARSITY, dist)
    assert all(p.fused == (fastpath == "on") for _, p in tree_items(plan))
    counts = FastpathCounts()
    step = td.make_train_step(cfg, dist, plan, W, counts)
    opt_state = make_optimizer(dist.optimizer).init(params)
    sp = td.init_sparsifier_state(plan, W, "cpu")
    losses = []
    for b in batches:
        tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32
              else torch.from_numpy(v) for k, v in b.items()}
        params, opt_state, sp, m = step(params, opt_state, sp, tb)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL)
    for path, leaf in tree_items(params):
        _close(leaf.numpy(), dict(tree_items(jparams))[path], path)
    jflat = jax.tree.leaves(jstate, is_leaf=lambda x: isinstance(x, jc.CompactState))
    for (path, st), js in zip(tree_items(sp), jflat, strict=True):
        np.testing.assert_array_equal(st.t.numpy(), np.asarray(js.t).reshape(W))
        # the SSD's decay leaves carry their gradients' float32 spread
        # (tests/test_torch_model.py) into the error they keep
        rtol = (SSD_DECAY_RTOL if path.endswith(("mixer.A_log", "mixer.dt_bias"))
                else RTOL)
        _close(st.eps.numpy(), np.asarray(js.eps).reshape(W, -1), path, rtol=rtol)
        jidx = np.asarray(js.sent_idx).reshape(W, -1)
        for w in range(W):
            np.testing.assert_array_equal(np.sort(st.sent_idx.numpy()[w]),
                                          np.sort(jidx[w]), err_msg=f"{path} w{w}")
    if fastpath == "on":
        assert counts.rounds == STEPS * W * len(tree_items(plan))


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "chatglm3-6b", "granite-3-8b",
                                  "granite-3-8b-swa", "phi3-medium-14b",
                                  "mixtral-8x7b", "deepseek-moe-16b",
                                  "internvl2-1b", "whisper-tiny",
                                  "mamba2-780m", "zamba2-7b"])
def test_cli_trains_every_arch(arch, capsys):
    """``--arch <id> --smoke --device cpu --workers 2 --steps 3 --fastpath
    on`` for each of the eleven model configs: finite losses, every leaf
    fused, the certificate line."""
    from repro_torch.launch import train

    res = train.run(train.parse_args([
        "--arch", arch, "--smoke", "--device", "cpu", "--workers", "2",
        "--steps", "3", "--fastpath", "on", "--seq", "16"]))
    out = capsys.readouterr().out
    assert len(res.losses) == 3 and all(np.isfinite(res.losses))
    n = len(tree_items(res.plan))
    assert f"fastpath: {n}/{n} leaves fused" in out
    assert res.counts.rounds == 3 * 2 * n
    if arch == "internvl2-1b":
        assert "vision_proj" in res.params
    if arch == "whisper-tiny":
        assert {"enc_layers", "dec_layers", "enc_norm"} <= set(res.params)
    if arch == "zamba2-7b":
        assert {"grouped", "shared_attn", "trailing"} <= set(res.params)
