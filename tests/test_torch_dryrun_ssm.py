"""The dry run's training step (``repro_torch.launch.dryrun.count_train``)
against the JAX dry run's ``lower_train`` at ``(8, 1)`` for the
state-space configs, mamba2-780m (ssm) and zamba2-7b (hybrid), each on
its smoke fields at ``train_4k``'s sequence and batch (the JAX side in
one subprocess of 8 host devices, ``tests/_torch_dryrun_jax.py``).

* The FLOPs outside the convolutions equal the HLO walker's outside its
  ``2 x out x 8`` convolution guess (``hlo_cost.py``'s "depthwise K=4
  approx"), but for one named term: the gradient of the per-position
  decay operand of the SSD's two three-operand einsums
  (``bcin,bchpn,bchi->bcihp`` and ``bcjn,bchj,bcjhp->bchpn``), which JAX
  contracts as a dot over the head dim P and the port as a product and a
  sum, which no FLOP counter counts: ``2 x 2 x rows x seq x H x P`` a
  mamba block.
* The port counts the depthwise convolution exactly: its forward ``2 x
  rows x seq x C x K`` (C = d_inner + 2N channels, K taps), and its input
  and weight gradients the same each.
* ``argument_bytes`` equals ``argument_size_in_bytes`` but for the port's
  int64 tokens, labels and ``sent_idx``; the all-gather bytes equal the
  walker's, the all-reduce its 4 B.
"""
import pytest

from test_torch_dryrun import int64_extra, jax_cases, port_case
from repro_torch.models import ssm

ARCHS = ("mamba2-780m", "zamba2-7b")
CASES = {arch: f"{arch}:train_4k:8x1" for arch in ARCHS}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    return jax_cases(tmp_path_factory, list(CASES.values()))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(jax_runs, monkeypatch, arch):
    rec, lay = port_case(monkeypatch, CASES[arch])
    want = jax_runs[CASES[arch]]
    cfg = lay.cfg
    assert lay.W == 8 and lay.rows == 32 and not cfg.remat
    n_groups, per_group, trailing = ssm._plan(cfg)
    mamba = n_groups * per_group + trailing
    H, P = cfg.d_inner // cfg.ssm_headdim, cfg.ssm_headdim
    C, K = cfg.d_inner + 2 * cfg.ssm_state, ssm.ssd.CONV_K
    conv = sum(v for k, v in rec["flops_by_op"].items() if "convolution" in k)
    assert conv == mamba * 3 * 2 * lay.rows * lay.seq * C * K
    decay_grads = mamba * 2 * 2 * lay.rows * lay.seq * H * P
    assert rec["flops"] - conv + decay_grads == want["flops_without_conv"]
    assert want["flops"] > want["flops_without_conv"]
    assert rec["mem"]["argument_bytes"] - int64_extra(lay) == (
        want["argument_bytes"])
    assert rec["collective_bytes"]["all-gather"] == (
        want["collective_bytes"]["all-gather"])
    assert rec["collective_bytes"]["all-reduce"] == 4 == (
        want["collective_bytes"]["all-reduce"])
