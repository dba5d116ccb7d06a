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
* The decode step on the model axis (``decode_32k`` on the smoke fields:
  mamba2-780m at ``(2, 4)``, zamba2-7b at ``(4, 2)``, its 2 kv heads
  split): the rank holds what the JAX device's ``argument_size_in_bytes``
  counts, but for its int64 tokens' 4 B a row, and its model group's
  bytes are the count written out from ``nn.ssd``'s and
  ``launch.dryrun``'s docstrings.
"""
import pytest

from test_torch_dryrun import int64_extra, jax_cases, jside, port_case
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.models import ssm

ARCHS = ("mamba2-780m", "zamba2-7b")
CASES = {arch: f"{arch}:train_4k:8x1" for arch in ARCHS}
# the serve step on the model axis
SERVE_TP_CASES = {"mamba2-780m": "mamba2-780m:decode_32k:2x4",
                  "zamba2-7b": "zamba2-7b:decode_32k:4x2"}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    return jax_cases(tmp_path_factory, [*CASES.values(),
                                        *SERVE_TP_CASES.values()])


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


def ssm_model_group_bytes(cfg, rows: int, M: int):
    """``(all-reduce, all-gather)`` bytes of one decode step's model group
    on a rank of ``rows`` rows, in bf16, with the kv heads split: per
    mamba block the all-gathers of ``zxbcdt`` ``[rows, 1, 2 d_inner + 2N +
    H]`` and of the conv output ``[rows, d_inner + 2N]`` and the
    all-reduces of the squares' float32 ``[rows, 1, 1]`` and of the output
    ``[rows, 1, d_model]``; per application of the shared block the
    attention output's and the MLP's all-reduces; the embedding's
    all-reduce and the logits' gather."""
    bf16 = 2
    n_groups, per_group, trailing = ssm._plan(cfg)
    mamba = n_groups * per_group + trailing
    H, C = cfg.d_inner // cfg.ssm_headdim, cfg.d_inner + 2 * cfg.ssm_state
    act = rows * cfg.d_model * bf16
    reduce = (1 + 2 * n_groups) * act + mamba * (rows * 4 + act)
    gather = (M * rows * (cfg.padded_vocab // M) * bf16
              + mamba * rows * (2 * cfg.d_inner + 2 * cfg.ssm_state + H + C)
              * bf16)
    return reduce, gather


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_on_the_model_axis_holds_what_the_device_holds(
        jax_runs, monkeypatch, arch):
    case = SERVE_TP_CASES[arch]
    rec, _ = port_case(monkeypatch, case)
    _, _, data, M, _ = jside.case_overrides(configs, case)
    rows = configs.INPUT_SHAPES["decode_32k"][1] // data
    assert rec["rank_bytes"] - 4 * rows == jax_runs[case]["argument_bytes"]
    assert rec["rank_bytes"] == rec["mem"]["argument_bytes"]
    cfg = dryrun._apply_overrides(configs.get_config(arch))  # port_case's
    coll = rec["rank_collective_bytes"]
    assert (coll["all-reduce:model"], coll["all-gather:model"]) == (
        ssm_model_group_bytes(cfg, rows, M))
