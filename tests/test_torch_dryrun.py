"""The dry run on the meta device (``repro_torch.launch.dryrun`` and
``launch/op_cost.py``) against the JAX dry run (``repro.launch.dryrun``
and ``hlo_cost``) on qwen2.5-3b, and the dry run's CLI.

The JAX side runs once, in one subprocess of 8 host devices
(``tests/_torch_dryrun_jax.py``): ``lower_train`` of ``train_4k`` at
``(8, 1)`` and ``(4, 2)``, ``lower_serve`` of ``prefill_32k`` and
``decode_32k`` at ``(8, 1)``, each compiled on qwen2.5-3b's smoke fields
(``CFG_OVERRIDES``) at the shapes' own sequence and batch. The port
counts the same combos with the same overrides on the meta device
(the other families: ``tests/test_torch_dryrun_families.py``, ``_ssm.py``
and ``_moe.py``):

* FLOPs equal the HLO walker's to the FLOP: the training step at
  ``(8, 1)`` (one worker's 32 rows in 4 microbatches, forward and
  backward), the prefill and the decode step;
* ``argument_bytes`` equals ``argument_size_in_bytes`` at ``(8, 1)`` and
  ``(4, 2)`` but for two named differences: the port's tokens and labels
  are int64 (4 B more an element of the worker's rows) and its
  ``sent_idx`` is int64 (4 B more a slot, k of them a leaf);
* at ``(8, 1)`` the all-gather bytes equal the walker's (W payloads of
  each leaf and the ZeRO-1 gather of each update in f32), and the
  all-reduce is the loss mean's 4 B;
* the decode step on the model axis, at ``(4, 2)`` (the kv heads split)
  and ``(2, 4)`` (the cache's slots split): the rank holds what the JAX
  device's ``argument_size_in_bytes`` counts, but for its int64 tokens'
  4 B a row, and its model group's all-reduce and all-gather bytes are
  the count written out from ``launch.dryrun``'s docstring (JAX's
  collective bytes are not compared: GSPMD replicates the cache to write
  one slot, which is not the port's traffic);
* the CLI writes one record with the JAX record's keys, reports it
  ``CACHED`` when run again and ``SKIP``s a ``long_500k`` combo that
  ``shape_applicable`` refuses; and the dry run makes no CUDA call.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_dryrun_jax as jside  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen2.5-3b"
CASES = (f"{ARCH}:train_4k:8x1", f"{ARCH}:train_4k:4x2",
         f"{ARCH}:prefill_32k:8x1", f"{ARCH}:decode_32k:8x1")
# the serve step on the model axis: the kv heads split, the slots split
SERVE_TP_CASES = {"heads": f"{ARCH}:decode_32k:4x2",
                  "seq": f"{ARCH}:decode_32k:2x4"}
# the keys of a record of the JAX dry run (repro.launch.dryrun.run_combo)
JAX_KEYS = {"arch", "shape", "mesh", "kind", "tag", "lower_s", "compile_s",
            "mem", "flops", "hbm_bytes", "xla_flops_looponce",
            "collective_bytes"}
JAX_MEM_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes"}


def jax_cases(tmp_path_factory, cases):
    """Run the JAX side of ``cases`` in one subprocess; ``{case: dict}``."""
    out = tmp_path_factory.mktemp("jax_dryrun") / "jax.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    res = subprocess.run(
        [sys.executable, str(Path(jside.__file__)), str(out), *cases],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    return json.loads(out.read_text())


def port_case(monkeypatch, case):
    """``(record, layout or None)`` of the port's count of ``case``
    (``arch:shape:DxM[:field=value,...]``)."""
    arch, shape, data, model, cfg = jside.case_overrides(configs, case)
    monkeypatch.setattr(dryrun, "CFG_OVERRIDES", cfg)
    mesh = {"data": data, "model": model}
    if configs.INPUT_SHAPES[shape][2] != "train":
        return dryrun.count_serve(arch, shape, mesh), None
    return (dryrun.count_train(arch, shape, mesh),
            dryrun.train_layout(arch, shape, mesh))


def int64_extra(lay) -> int:
    """The port's argument bytes beyond JAX's: its tokens and labels and
    its ``sent_idx`` are int64 where JAX's are int32."""
    rows = sum(math.prod(s) for name, (s, _) in lay.batch_specs.items()
               if name in ("tokens", "labels")) // lay.W
    return 4 * rows + 4 * sum(p.k for p in tree_leaves(lay.plan))


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    return jax_cases(tmp_path_factory, CASES + tuple(SERVE_TP_CASES.values()))


def test_train_flops_args_and_collectives_match_jax(jax_runs, monkeypatch):
    rec, lay = port_case(monkeypatch, CASES[0])
    want = jax_runs[CASES[0]]
    assert lay.W == 8 and lay.rows == 32 and lay.dist.microbatches == 4
    assert rec["flops"] == want["flops"]
    assert rec["mem"]["argument_bytes"] - int64_extra(lay) == (
        want["argument_bytes"])
    coll = want["collective_bytes"]
    assert rec["collective_bytes"]["all-gather"] == coll["all-gather"]
    assert rec["collective_bytes"]["all-reduce"] == coll["all-reduce"] == 4
    # one rank of the port today: the same payloads, no ZeRO-1 gather,
    # the 8 ranks' losses gathered
    zero1 = sum(p.local_len * 4 for p, ms in zip(
        tree_leaves(lay.plan), tree_leaves(lay.mom_specs), strict=True)
        if ms != p.spec)
    assert zero1 > 0
    assert rec["rank_collective_bytes"]["all-gather"] == (
        coll["all-gather"] - zero1 + 4 * 8)


def test_arguments_match_jax_with_a_model_axis(jax_runs, monkeypatch):
    rec, lay = port_case(monkeypatch, CASES[1])
    assert lay.W == 4 and lay.rows == 64
    assert rec["mem"]["argument_bytes"] - int64_extra(lay) == (
        jax_runs[CASES[1]]["argument_bytes"])
    # the model axis of 2 shards the dense decoder's forward, params and
    # Adam (tensor parallelism): the rank holds its blocks, with Adam's
    # moments whole over dp where ZeRO-1 splits JAX's; the model group
    # all-reduces activations and gathers the logits, and no aggregate
    # is gathered
    from repro_torch.models import lm
    from repro_torch.nn.sharding import shard_params
    from repro_torch.tree import tree_map

    specs = tree_map(lambda p: p.spec, lay.plan)
    local = shard_params(lay.params, specs, 0, 2)
    # bf16 params, f32 moments and an f32 gradient an element
    per = 2 + 4 + 4 + 4
    n_local = sum(x.numel() for x in tree_leaves(local))
    n_whole = sum(x.numel() for x in tree_leaves(lay.params))
    assert (lay.cfg.dtype, lay.dist.optimizer.moment_dtype,
            lay.dist.state_dtype) == ("bfloat16", "float32", "float32")
    assert rec["rank_bytes"] > rec["mem"]["argument_bytes"]
    assert rec["rank_bytes"] - per * n_local == (  # and Adam's step
        dryrun._tree_bytes(input_specs_batch(lay)) + rows_bytes(lay) + 4)
    coll = rec["rank_collective_bytes"]
    assert coll["all-reduce:model"] > 0 and coll["all-gather:model"] > 0
    # the peak is the sharded trainer's: below the whole forward's, which
    # a family without tensor parallelism would run at this layout
    monkeypatch.setattr(lm, "TENSOR_PARALLEL", frozenset())
    whole, _ = port_case(monkeypatch, CASES[1])
    assert "all-reduce:model" not in whole["rank_collective_bytes"]
    assert whole["rank_bytes"] - rec["rank_bytes"] == per * (n_whole - n_local)
    assert rec["mem"]["peak_bytes"] < whole["mem"]["peak_bytes"]
    assert rec["flops"] < whole["flops"]


def input_specs_batch(lay):
    """A worker's batch rows on the meta device, as the dry run counts
    them."""
    from repro_torch.models import input_specs

    return dryrun._meta_batch(input_specs(lay.cfg, lay.rows, lay.seq,
                                          kind="train"))


def rows_bytes(lay) -> int:
    """The rank's own (worker, shard) sparsifier-state rows."""
    from repro_torch.core import distributed as td

    return dryrun._tree_bytes(td.init_sparsifier_state(
        lay.plan, 1, "meta", lay.dist.resolved_state_dtype(), shards=1))


@pytest.mark.parametrize("case", CASES[2:], ids=["prefill_32k", "decode_32k"])
def test_serve_flops_match_jax(jax_runs, monkeypatch, case):
    rec, _ = port_case(monkeypatch, case)
    assert rec["flops"] == jax_runs[case]["flops"]
    assert rec["collective_bytes"] == {"total": 0.0}
    assert rec["kind"] == case.split(":")[1].split("_")[0]


def model_group_bytes(cfg, rows: int, M: int, layout: str):
    """``(all-reduce, all-gather)`` bytes of one decode step's model group
    on a rank of ``rows`` rows, in bf16 (``launch.dryrun``'s docstring):
    the embedding's and each layer's attention output's and MLP's
    all-reduces of ``[rows, 1, d_model]``; the logits' gather of every
    rank's ``padded_vocab / M`` columns; in the sequence layout each
    layer's gathers of the rank's query heads ``[rows, 1, heads / M,
    head_dim]`` and of its partial softmax, ``m``, ``l`` and ``o`` of every
    head ``[rows, heads, head_dim + 2]`` in f32."""
    bf16, L, H, Dh = 2, cfg.n_layers, cfg.n_heads, cfg.hd
    reduce = (1 + 2 * L) * rows * cfg.d_model * bf16
    gather = M * rows * (cfg.padded_vocab // M) * bf16
    if layout == "seq":
        gather += L * M * (rows * (H // M) * Dh * bf16
                           + rows * H * (Dh + 2) * 4)
    return reduce, gather


@pytest.mark.parametrize("layout", list(SERVE_TP_CASES))
def test_serve_on_the_model_axis_holds_what_the_device_holds(
        jax_runs, monkeypatch, layout):
    case = SERVE_TP_CASES[layout]
    rec, _ = port_case(monkeypatch, case)
    _, _, data, M, _ = jside.case_overrides(configs, case)
    rows = configs.INPUT_SHAPES["decode_32k"][1] // data
    assert rec["rank_bytes"] - 4 * rows == jax_runs[case]["argument_bytes"]
    assert rec["rank_bytes"] == rec["mem"]["argument_bytes"]
    cfg = dryrun._apply_overrides(configs.get_config(ARCH))  # port_case's
    reduce, gather = model_group_bytes(cfg, rows, M, layout)
    coll = rec["rank_collective_bytes"]
    assert (coll["all-reduce:model"], coll["all-gather:model"]) == (
        reduce, gather)


def test_the_cli_writes_caches_and_skips(tmp_path, capsys, monkeypatch):
    """A full-width decode combo (no overrides), run twice, then a
    ``long_500k`` combo that ``shape_applicable`` refuses; no CUDA call
    and no allocation on a card."""
    monkeypatch.setattr(torch.cuda, "is_available",
                        lambda: pytest.fail("the dry run asked for CUDA"))
    out = tmp_path / "d.jsonl"
    args = ["--arch", ARCH, "--shape", "decode_32k", "--out", str(out)]
    assert dryrun.main(args) == 0
    first = capsys.readouterr().out.splitlines()
    assert first[0].startswith(f"OK    {ARCH} x decode_32k x 16x16: peak=")
    assert first[-1] == "dry-run complete; 0 failures"
    rec = json.loads(out.read_text())
    assert JAX_KEYS <= rec.keys() and set(rec["mem"]) == JAX_MEM_KEYS
    assert rec["mesh"] == "16x16" and rec["compile_s"] is None
    assert rec["flops"] > 0 and rec["fits"] is True
    assert dryrun.main(args) == 0
    assert capsys.readouterr().out.splitlines()[0] == (
        f"CACHED {ARCH} x decode_32k x 16x16")
    assert dryrun.main(["--arch", ARCH, "--shape", "long_500k", "--out",
                        str(out)]) == 0
    assert capsys.readouterr().out.startswith(f"SKIP  {ARCH} x long_500k")
    assert len(out.read_text().splitlines()) == 1
    assert dryrun.OUT == os.path.join("dryrun_out", "dryrun.jsonl")
