"""The dry run's training step (``repro_torch.launch.dryrun.count_train``)
against the JAX dry run's ``lower_train`` at ``(8, 1)`` for the VLM and
the encoder-decoder: internvl2-1b (a patch prefix from the vision stub)
and whisper-tiny (cross-attention over the encoder's frames), each on its
smoke fields at ``train_4k``'s sequence and batch (the JAX side in one
subprocess of 8 host devices, ``tests/_torch_dryrun_jax.py``).

* FLOPs equal the HLO walker's to the FLOP (one worker's 32 rows in 8
  microbatches, forward and backward).
* ``argument_bytes`` equals ``argument_size_in_bytes`` but for the port's
  int64 tokens, labels and ``sent_idx``; the patches and frames are
  bf16 in both.
* The all-gather bytes equal the walker's, the all-reduce its 4 B.
* whisper-tiny's decode step on the model axis (``decode_32k`` on the
  smoke fields: ``(4, 2)``, its 2 kv heads split with both caches, and
  ``(2, 4)``, the self cache's slots split and the cross cache whole):
  the rank holds what the JAX device's ``argument_size_in_bytes``
  counts, but for its int64 tokens' 4 B a row and the weights the step
  does not read, which ``jax.jit`` prunes from its arguments
  (``keep_unused=False``) and the rank keeps to build its cross cache:
  its blocks of the encoder and of each decoder layer's cross-attention
  ``wk`` and ``wv``. Its model group's bytes are the count written out
  from ``models.encdec``'s, ``nn.layers.attention_decode``'s and
  ``launch.dryrun``'s docstrings.
"""
import pytest

from test_torch_dryrun import int64_extra, jax_cases, jside, port_case
from repro_torch import configs
from repro_torch.launch import dryrun
import _torch_cores  # noqa: F401  (this worker's share of the cores)

ARCHS = ("internvl2-1b", "whisper-tiny")
CASES = {arch: f"{arch}:train_4k:8x1" for arch in ARCHS}
# whisper-tiny's serve step on the model axis
SERVE_TP_CASES = {"heads": "whisper-tiny:decode_32k:4x2",
                  "seq": "whisper-tiny:decode_32k:2x4"}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    return jax_cases(tmp_path_factory, [*CASES.values(),
                                        *SERVE_TP_CASES.values()])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(jax_runs, monkeypatch, arch):
    rec, lay = port_case(monkeypatch, CASES[arch])
    want = jax_runs[CASES[arch]]
    assert lay.W == 8 and lay.rows == 32 and lay.dist.microbatches == 8
    assert rec["flops"] == want["flops"]
    assert not any("convolution" in k for k in rec["flops_by_op"])
    assert rec["mem"]["argument_bytes"] - int64_extra(lay) == (
        want["argument_bytes"])
    assert rec["collective_bytes"]["all-gather"] == (
        want["collective_bytes"]["all-gather"])
    assert rec["collective_bytes"]["all-reduce"] == 4 == (
        want["collective_bytes"]["all-reduce"])


def unread_by_decode(cfg, M: int) -> int:
    """The bytes of a serving rank's blocks of the weights that the decode
    step does not read: the encoder's and the cross-attention's ``wk`` and
    ``wv``, which only ``build_cross_cache`` reads."""
    from repro_torch.launch import serve
    from repro_torch.models import encdec
    from repro_torch.nn.sharding import shard_params
    from repro_torch.tree import tree_items

    meta = encdec.init(cfg, device="meta")
    specs = serve.serve_layout(cfg, meta, 1, 16, {"data": 1, "model": M})[0]
    return sum(x.numel() * x.element_size() for path, x in tree_items(
        shard_params(meta, specs, 0, M))
        if path.startswith("enc_") or path.startswith(("dec_layers.cross.wk",
                                                       "dec_layers.cross.wv")))


def encdec_model_group_bytes(cfg, rows: int, M: int):
    """``(all-reduce, all-gather)`` bytes of one decode step's model group
    on a rank of ``rows`` rows, in bf16: the embedding's all-reduce, per
    decoder layer the self-attention's, the cross-attention's and the
    MLP's outputs all-reduced, and the logits' gather. Where the kv heads
    stay whole and the query heads split (the smoke fields at M = 4), per
    layer the self- and cross-attention's query heads are gathered and
    the self-attention's partial softmaxes (``m``, ``l`` and the context,
    float32 over every query head) gathered over the rank's slots; the
    cross cache, every frame on every rank, combines nothing."""
    bf16, f32 = 2, 4
    act = rows * cfg.d_model * bf16
    reduce = (1 + 3 * cfg.n_layers) * act
    gather = M * rows * (cfg.padded_vocab // M) * bf16
    if cfg.n_kv_heads % M:
        queries = M * rows * (cfg.n_heads // M) * cfg.hd * bf16
        partial = M * rows * cfg.n_heads * (cfg.hd + 2) * f32
        gather += cfg.n_layers * (2 * queries + partial)
    return reduce, gather


@pytest.mark.parametrize("layout", list(SERVE_TP_CASES))
def test_serve_on_the_model_axis_holds_what_the_device_holds(
        jax_runs, monkeypatch, layout):
    case = SERVE_TP_CASES[layout]
    rec, _ = port_case(monkeypatch, case)
    _, _, data, M, _ = jside.case_overrides(configs, case)
    rows = configs.INPUT_SHAPES["decode_32k"][1] // data
    cfg = dryrun._apply_overrides(
        configs.get_config("whisper-tiny").replace(dtype="bfloat16"))
    unread = unread_by_decode(cfg, M)
    assert unread > 0
    assert rec["rank_bytes"] - 4 * rows - unread == (
        jax_runs[case]["argument_bytes"])
    assert rec["rank_bytes"] == rec["mem"]["argument_bytes"]
    assert (cfg.n_kv_heads % M == 0) == (layout == "heads")
    coll = rec["rank_collective_bytes"]
    assert (coll["all-reduce:model"], coll["all-gather:model"]) == (
        encdec_model_group_bytes(cfg, rows, M))
