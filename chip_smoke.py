"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero):

1. device   — the card's name, and its name and power limit from nvidia-smi;
2. build    — every CUDA source of the port compiled with nvcc (sm_90a);
3. kernels  — the fused select→encode kernel against its plain PyTorch
              version at every leaf shape of paper-resnet-proxy at full
              width with W = 8 workers, plus a ragged length, y = 2, a
              certificate failure, and a tile with one NaN score and one
              of NaN scores only; timed beside its plain version, the
              library top-k of a precomputed dense score, and its bound;
              then bit for bit on adversarial tiles (one value, four
              values, signed zeros, subnormals, +inf) at every budget m
              from 1 to 8192;
4. score    — the RegTop-k score kernel against its plain PyTorch version,
              bit for bit, at every leaf shape of paper-resnet-proxy with
              W = 8, the model's flat length (the simulator at full width),
              Fig. 3's N = 20 x J = 100, a ragged length, y = 2 and 1.5,
              zero denominators, an all-unsent state and a NaN input; each
              timed beside its plain version and its bound;
5. select   — the sort-free selection kernels (count_above, global_max,
              block_topk_candidates) against their plain versions, bit for
              bit, at kernel_bench's shape (N = 262,144, k = 262, m = 16),
              the full-width row (the RegTop-k score of paper-resnet-proxy's
              flat J = 4,458,752 vector, k = 4,459 and 44,588, m = 16), a
              ragged length, an all-zero score, k >= L and a NaN input,
              and ``block_topk_candidates`` bit for bit on the adversarial
              tiles (those of the kernels phase and runs of -inf) at every
              budget m from 1 to 8192; the
              main path (``ops.threshold_topk_mask`` at both k and
              ``ops.hierarchical_topk`` on the full-width row, no host sync
              in the bisection) with its launches counted; the kernel-driven
              mask held bit for bit against ``core.selectors``' plain
              bisection; the hierarchical top-k's recall; each kernel, both
              whole selections, their plain versions and the library calls
              timed, with the bounds from bytes;
6. trainer  — the port's trainer (``repro_torch.launch.train``) on
              paper-resnet-proxy at full width, W = 8, RegTop-k at S = 0.01,
              fastpath on, for 10 steps: finite losses, one kernel launch
              per fused leaf per step, the certificate hit rate, one step
              held against the fastpath off, and a small run held against
              the same run on the CPU; then 10 steps each of cyclic, of
              dense_allreduce and of the threshold selector (set through
              ``DistConfig``), each with finite losses and its comm line;
7. sim      — the port's simulator (``repro_torch.core.DistributedSim``):
              the paper's Fig. 1 toy with its assertions; Fig. 3 at its
              published size (N = 20, J = 100, 2500 rounds), RegTop-k with
              the fastpath on and off equal bit for bit and one score kernel
              launch per round; and whole-model selection at full width
              (N = 8, J = 4,458,752, RegTop-k at S = 0.01, 5 rounds), fastpath
              on against off round by round, with the round times and the
              device's busy share;
8. wire     — the wire at full width: the trainer (W = 8, RegTop-k at
              S = 0.01) with coo_idx_delta and coo_q8 through the fused
              kernel (launches counted, one step's encoded payloads on ==
              off bit for bit, measured bytes <= 1.05 x predicted),
              bitmap_dense (which never fuses: no launch), coordinate
              weighting (sent_w recorded), fastpath auto under the table
              ThroughputTable.measure() fits on this card (payloads ==
              off), and a smoke run per codec against the same run on the
              CPU; the simulator (N = 8, J = 4,458,752, 5 rounds each)
              with coo_q8 on == off in theta and eps, coordinate weighting
              (auto == off, no score launch), hierarchical == sparse_allgather
              with coo_idx_delta, and wire_bytes_per_round per codec; the
              step and round time of each path;
9. ranks    — the trainer across ranks, one worker per rank over
              torch.distributed, at full width (RegTop-k at S = 0.01,
              5 steps): (a) nccl at world size 1 in this process (a
              FileStore), coo_fp32 + sparse_allgather with the fastpath on,
              params, every CompactState field and every encoded payload
              equal in bits to the one-card --workers 1 run, and
              --calibrate reporting that it skipped; (b) 8 ranks
              spawned on this one card over gloo (nccl refuses two ranks on
              one device), in turn sparse_allgather + coo_fp32 (fastpath
              on), --coord-weights, dense_allreduce (which fuses no leaf)
              hierarchical + coo_idx_delta on --multi-pod (2 x 4),
              --fastpath auto (rank 0's measured ThroughputTable, broadcast
              over the others' tables, which would fuse no leaf: one plan
              on every rank), --participation round_robin:2 and
              --adaptive-k 1.0,0.001,0.012: every rank's params equal in
              bits (and the controller's k), rank 0's losses within rtol 1e-5
              of the one-card --workers 8 run's and its params within rtol
              1e-5 with a floor of 1e-5 of a leaf's largest magnitude (bit
              mismatches and the largest difference printed; where
              all_reduce sums, at most 0.1% of the elements may be off by
              up to 2 lr a step: Adam turns a last-ulp change of a
              near-cancelling sum into a whole step), measured bytes
              equal to predicted, kernel 1's launches per rank = steps x
              fused leaves (0 under --coord-weights and dense_allreduce);
              the per-rank step time beside the one-card step (host
              clock), and one step of each under torch.profiler; for the
              round_robin and adaptive runs the difference from one card
              is reported, not held, the bytes measured against the full
              round's prediction, the partial round's printed beside it;
              the sparse_allgather run also writes --checkpoint (rank 0
              the gathered state of the 8 workers), which phase 12
              resumes;
10. stragglers — partial participation and the adaptive-k controller at
              full width: (a) the simulator (N = 8, J = 4,458,752, RegTop-k at
              S = 0.01, sparse_allgather, coo_fp32) under round_robin:2,
              bernoulli:0.25,1 and stale:2,2,0.5, 5 rounds each, fastpath on
              against off (theta, g_agg, every worker-state slot and the
              pending buffer bit-equal), sampled:8,7 over 32 clients (only
              the cohort, = round_participants, moves; idle clients
              bit-unchanged) and the controller (1.0,0.001,0.05) for 10
              rounds, k per round printed; each schedule's round time (the
              gradient fixed, host clock, median of 5); (b) the trainer (W =
              8, 5 steps) under --participation round_robin:2 and
              bernoulli:0.25 and --adaptive-k 1.0,0.001,0.012, fastpath on
              against off (params bit-equal), kernel 1's launches, the hit
              rate, each leaf's k, and measured bytes <= 1.05 x the full
              round's prediction (the partial round's printed beside it).
11. planners — the per-leaf planner, the overlap schedule and the
              calibration at full width: (a) the simulator (N = 8, J =
              4,458,752, RegTop-k at S = 0.01) under codec and collective
              "auto" with AlphaBeta(), on dp (2, 4) under a slow outer axis
              (PLAN_TOPO), and so with overlap="buckets:4", 5 rounds each,
              fastpath on against off in bits, the resolved wire, the
              predicted round and round_timeline's sync and overlapped
              seconds; (b) the trainer (W = 8, 5 steps) under --codec auto
              --collective auto --fastpath on (the per-leaf picks; kernel 1
              on the plan's fused leaves; params and payloads bit-equal to
              the same plan with the fastpath off, and params to auto with
              the fastpath off, whose plan differs), --overlap buckets:4
              (params bit-equal to off; one profiled step's spa_bucketNNN
              ranges) and --calibrate, which skips in one process; (c)
              three more runs in phase 9's spawn of 8 gloo ranks:
              --calibrate on --multi-pod (the fitted alpha and beta per
              axis, equal on every rank), --codec auto --collective auto
              --calibrate (one per-leaf plan on every rank) and
              --replan-every 2 over 6 steps (the replan lines, the picks
              and the params equal across the ranks).
12. options — the trainer's remaining options at full width (W = 8, batch
              32 x 128, RegTop-k at S = 0.01, 5 steps a run), each held in
              bits (params and every sparsifier-state field) against its
              twin: (a) --microbatches 2, fastpath on against off; (b)
              --checkpoint after 5 steps and --resume for 5 more against
              the unbroken 10 steps (losses too), with the fastpath on,
              again under --participation bernoulli:0.25 --adaptive-k
              1.0,0.001,0.012 (the controller's state too), and from the
              checkpoint phase 9's 8 gloo ranks wrote after their 5
              sparse_allgather steps, resumed with --workers 8; (c)
              state_dtype="bfloat16" through ``train.run(args, dist=...)``:
              --fastpath auto fuses no leaf and launches nothing, "on"
              raises, the state's bytes against f32's and the step time
              against the f32 step's; (d) the optimizers sgd, momentum
              (weight decay, which only Adam applies, clip and warmup) and
              Adam (weight decay, clip, warmup, bf16 moments), fastpath on
              against off; (e) --aggregation dense_allreduce against
              --collective dense_allreduce.
13. families — the model families at published widths, RegTop-k at
              S = 0.01 with the fastpath on, 3 steps each: internvl2-1b
              (12 of 24 layers; W = 4, batch 8 x
              512 behind a 256-patch prefix), qwen2.5-3b (6 of 36 layers;
              W = 2, batch 4 x 512), deepseek-moe-16b (1 of 28 layers;
              W = 2, batch 4 x 512), whisper-tiny (all 4 + 4 layers,
              through train.run's flags; W = 8, batch 16 x 448 decoder
              tokens over 1500 encoder frames), mamba2-780m (24 of 48
              layers; W = 2, batch 4 x 512) and
              zamba2-7b (8 of 81 layers: one group of five mamba blocks and
              the shared attention block, then two trailing blocks; W = 2,
              batch 4 x 512), the depth cut where the card's 80 GB forces
              it (internvl2-1b's and mamba2-780m's for the script's time
              limit), the cut configs driven through build_plan and
              make_train_step: finite losses, kernel 1's launches = steps
              x fused leaves, the certificate hit rate, the peak device
              memory beside the reckoned one, one more step from the
              trained state with the fastpath on == off (payload indices
              and values bit-equal), the step time on and off (host clock,
              median of 3) and one profiled step; then the smoke variants
              of qwen2.5-3b, deepseek-moe-16b, internvl2-1b, mixtral-8x7b,
              whisper-tiny, mamba2-780m and zamba2-7b (W = 2, 3 steps) on
              the card against the same runs on the CPU, losses within
              1e-4 relative.
14. serving — launch/serve.py and each family's prefill, init_cache and
              decode_step, models at published widths in float32 (TF32
              off), weights from the port's seeded init: qwen2.5-3b (9 of
              its 36 layers, batch 8, max_len 2048), zamba2-7b (15 of 81,
              batch 8, 2048), mamba2-780m (24 of 48, batch 8), whisper-tiny (4 +
              4, batch 8, max_len 448 over 1500 frames) and
              deepseek-moe-16b (1 of its 28 layers, batch 4, 1024: the
              whole model's host init takes ~160 s); the depths cut for the script's time
              limit. Each: prefill (chunked attention, blocks of
              1024) over 2 x 1536 tokens (448 for whisper-tiny) against
              forward(mode="dense"); 32 teacher-forced decode steps against
              forward over the same tokens (the MoE forward dropless), both
              to rtol = atol = 2e-3 (an MoE row is held up to its first
              routing flip, which fails unless the reference router's
              top-k gap there is within 1e-5, and at least half the
              positions are held); serve.run's greedy loop, 8 untimed
              steps then 64 timed (CUDA events per step): tokens per
              second, the median step beside its byte bound (the
              decoder's weights less the experts no token of the step
              routes to, the self-attention caches' filled slots averaged
              over the timed steps, the cross cache read, the recurrent
              state read and written) and beside what the einsum dispatch
              and the masked attention read (every expert, every slot),
              weights and cache bytes, peak memory, host init seconds and
              the device's busy share of a profiled step; no kernel of the
              five launches. qwen2.5-3b's and deepseek-moe-16b's greedy
              runs are recorded and saved (the weights, the served tokens,
              each step's logits, the final cache and the routings) as the
              twins of phase 15 (c)'s serving runs, and (c) reads its own
              qwen2.5-3b and deepseek-moe-16b weights from them.
              Then the smoke variants of phase 13's seven configs through
              serve.run on the card and on the CPU (the same seeded weights
              and first tokens): the logits of the card run's token
              sequence, teacher-forced on both, within 1e-4 relative, and
              the two greedy runs equal up to a step whose CPU top-2 margin
              is within that.
15. model parallel — the model axis (one RegTop-k round per (worker,
              model shard), each shard's block of a leaf flattened on its
              own with its own k): (a) on one card, where the forward, the
              params and Adam stay whole, qwen2.5-3b at 3 of 36 layers (W
              = 2 per layout's data axis, batch 4 x 512, RegTop-k at S =
              0.01, Adam, 3 steps) on the host meshes of --workers 4 with
              --model-parallel 2 ((data, model) = (2, 2)) and 4 ((1, 4),
              where 7 of 14 leaves stay whole), fastpath on against off:
              params and every sparsifier-state field in bits, each leaf's
              block and k, kernel 1 once per fused leaf per step (the W x
              M rows of a leaf in one launch), the peak beside the
              reckoned one; (b) 4 gloo ranks sharing the card at (2, 2) on
              paper-resnet-proxy at full width (phase 9's flags), tensor
              parallel (each rank its blocks of the params, forward,
              backward and Adam), 6 steps each of sparse_allgather and
              dense_allreduce against the one-card --workers 4
              --model-parallel 2 run (losses to rtol 1e-5, params by
              _param_diff's rule: rtol 1e-5 with a leaf's floor, or at
              most 0.1% of them off by at most 2 lr a step; the errors
              and sent indices reported), the same ranks with the
              fastpath off in bits, --checkpoint at step 3 and --resume
              to step 6 against the unbroken run in bits, each rank's
              state bytes; (c) tensor parallel at published widths on 4
              gloo ranks, 3 steps, after each config's one-card twin:
              qwen2.5-3b at (1, 4), 3 of 36 layers (its kv heads whole,
              its query heads split), batch 4 x 512, internvl2-1b at 3
              of 24 layers at (2, 2), batch 8 x 512 (both cut for the
              script's time limit), deepseek-moe-16b at (1, 4), 1
              of 28 layers, batch 4 x 512 (W = 1: one group of 2048
              tokens, capacity 240), in both MoE layouts (each expert's
              width split, or 16 of the 64 experts a rank), and
              zamba2-7b at (1, 4), 7 of 81 layers (one group of 5 mamba
              blocks and the shared attention block, then 1 trailing
              block; the SSD mixer on each rank's channels and heads,
              its in_proj, conv_w and conv_b gathered whole), batch 4 x
              512, and whisper-tiny at (2, 2), all 4 + 4 layers (3
              heads a rank; the encoder, the decoder's self- and
              cross-attention and the MLPs split, the encoder output
              entering the model group in each decoder layer), batch 8
              x 448 over 1500 frames, held against
              the twin as in (b) (the SSD's A_log and dt_bias at rtol
              1e-4), fastpath on == off in bits on every
              rank (the expert layout with the fastpath on only), whole
              leaves (the router, the norms) bit-equal across the ranks,
              each rank's blocks, kernel 1 once per fused leaf a step on
              every rank; the step time, each rank's peak and their sum
              beside tp_prediction, the model group's collectives a step
              under the profiler, and each MoE run's routing flips a step
              against its twin: a token routed to other experts fails
              unless the twin's top-6 gap there is within 1e-5 (a
              near-tie, as in phase 14; 1e-4 after the first step with a
              flip, whose Adam steps move the weights further apart),
              and it moves that token's loss,
              so the losses are held to rtol 1e-5 before the first step
              with a flipped token and to 5e-4 from it on, the params by
              _param_diff's rule, the router also on its own. Then, on
              the same 4 ranks, serving (TP_SERVE_RUNS): qwen2.5-3b at
              phase 14's 9 of 36 layers, batch 8, max_len 2048, at (1, 4)
              (its 2 kv heads whole, the cache's 2048 slots split, 512 a
              rank, the query heads gathered for the attention, whose
              partial softmaxes the ranks combine) and at (2, 2) (1 kv
              head and 4 rows a rank), and deepseek-moe-16b at 1 of 28
              layers, batch 4, max_len 1024, at (1, 4) (4 of its 16 kv
              heads a rank, each expert's width split), zamba2-7b at
              phase 14's 15 of 81 layers, batch 8, max_len 2048, at (1, 4)
              (8 of its 32 kv heads, 28 of 112 SSM heads and a block of
              1824 of 7296 conv channels a rank), mamba2-780m at 24 of
              48 layers, batch 8, max_len 2048, at (2, 2) (24 of 48 SSM
              heads, 1664 of 3328 conv channels, 4 rows a rank), and
              whisper-tiny whole, batch 8, max_len 448, at (2, 2) (3 of
              its 6 kv heads a rank in the self and the cross cache, 4
              rows a rank) and at (1, 4) (its kv heads whole, the self
              cache's slots split, 112 a rank, the cross cache whole on
              every rank, the MLP split 4 ways), each
              through serve.run(..., mesh=) from phase 14's weights and
              first tokens (8 untimed, 64 timed greedy steps; the SSM
              runs 8 timed, the whisper runs 16), recorded and held against phase 14's
              one-card run (its twin) over as many steps: each step's
              logits within rtol 1e-5 and a floor of 1e-5 of the step's
              largest, and every block of the cache after those steps
              within the same (the KV slots up to a row's first token
              apart from the twin's, an MoE row up to its first routing
              flip, a near-tie within 1e-5; the conv windows and SSM
              states of the rows whose inputs were the twin's), pos
              the steps taken, that first differing token at a near-tie
              of the twin's top 2 (1e-3) or after a flip, each rank's
              parameter and
              cache bytes those launch.dryrun.serve_count predicts; ms a
              step beside the twin's, the model group's collectives a
              step (count, bytes, host seconds over the untimed steps)
              and each rank's peak printed. serve.run builds whisper's
              cross cache from zero frames, as repro.launch.serve does, and
              that cache is all zeros, so each whisper run also
              teacher-forces the twin's tokens on its ranks from the
              cross cache that build_cross_cache(..., shard) makes of
              frames drawn from a seed (0.1 x a standard normal), held
              against phase 14's one-card decode of the same frames and
              tokens: each step's logits and every block of k, v, ck and
              cv as above, and no rank's ck or cv all zero; (d)
              --mesh production at a world size of 4 exits non-zero with
              its message.
16. dry run — launch/dryrun.py on the meta device, which makes no CUDA
              call: (a) one combo of its CLI path, qwen2.5-3b x train_4k
              on the (16, 16) production layout, its record and seconds,
              the card's allocated bytes unchanged across it; (b) each of
              phase 13's six runs counted at its depth, W, batch and
              float32 (TF32 off): one training step of W workers'
              forward and backward and Adam (launch/op_cost.py; the round
              with the fastpath off, as the kernels take no meta tensor,
              adds no FLOP term), divided by the device time of phase
              13's profiled step, as TFLOP/s and a share of the card's
              67 TFLOP/s in float32 (launch.mesh.PEAK_FLOPS_F32); a share
              above 1.05 fails the phase. The step's traced peak is
              printed beside phase 13's measured and reckoned peaks.

Each kernel's launch count is set to 0 just before the path that runs it
(select: ``count_above``, ``global_max``, ``block_topk_candidates``;
trainer, each fused wire run, each run of every rank, each of phase
10's, 11's and 12's trainer runs, phase 13's six training runs and each
of phase 15's runs, every rank's counted: ``fused_candidates``; sim, the
wire
simulator's fastpath-on run and phase 10's and phase 11's simulator runs:
``regtopk_score``) and read just after; the
``kernels`` line sums each kernel's main-path launches. The line before the last is the card's nvidia-smi line; before it,
the ``kernels`` JSON line. The last line is the device JSON.
``--details FILE`` also writes every phase's results to FILE as JSON.
``--parent DIR`` (a checkout of the parent commit) adds, last, the time of
kernel 1 per training step and of ``block_topk_candidates`` at full width
for both trees, measured in turns (parent, change, change, parent) in
fresh processes on this card, into the details.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# phase 13's full-width runs fill most of the card with tensors of many
# sizes; growable segments keep the allocator's free space usable
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
SCORE_OPS = 12  # f32 operations of the score chain per element, tanh as one
SCORE_BYTES = 20  # the score pass: four f32 reads and one f32 write
DEVICE = "cuda"
W = 8
STEPS = 10
TRAIN_ARGS = [
    "--arch", "paper-resnet-proxy", "--workers", str(W),
    "--sparsifier", "regtopk", "--sparsity", "0.01", "--fastpath", "on",
    "--global-batch", "32", "--seq", "128", "--log-every", "1",
]


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, iters: int = 20, warmup: int = 3, inner: int = 5) -> float:
    """Device milliseconds of one call of ``fn``: the median of ``iters``
    samples after warm-up, each the mean of ``inner`` back-to-back calls.
    A sleep kernel holds the stream while the host queues the calls, so
    the CUDA events bracket the device's work and not the host's launch
    overhead (which would dominate a small leaf)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # ~10 ms at the H100's clock
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def phase_device() -> tuple[str, str]:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    log(f"nvidia-smi: {smi}")
    return name, smi


def phase_build() -> dict:
    from repro_torch.kernels import build

    built = build.build_all()
    for name, (lib, seconds, report) in built.items():
        log(f"build: {name} -> {lib.name} in {seconds:.1f} s")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"build:   {line.strip()}")
    return {n: round(s, 3) for n, (_, s, _) in built.items()}


def _leaf_inputs(L: int, k: int, gen: torch.Generator, poison=None,
                 workers: int = W):
    """[workers, L] gradient accumulator and the dense scatter of a random
    previous payload: what fused_compact_select hands the kernel.
    ``poison`` makes the certificate fail: "concentrate" puts the mass in
    one tile, "nan" puts one NaN in tile 1, "nan tile" fills tile 1."""
    a = 1e-3 * torch.randn((workers, L), generator=gen)
    if poison == "concentrate":
        a[:, : min(L, 4096)] *= 1e3
    elif poison == "nan":
        a[:, 8192 + 5] = float("nan")
    elif poison == "nan tile":
        a[:, 8192:16384] = float("nan")
    sent = torch.stack(
        [torch.randperm(L, generator=gen)[:k] for _ in range(workers)]
    )
    ones = torch.ones((workers, k))
    z = torch.zeros((workers, L))
    s_prev = z.scatter(1, sent, ones)
    a_prev = z.scatter(1, sent, 1e-3 * torch.randn((workers, k), generator=gen))
    g_prev = z.scatter(1, sent, 1e-4 * torch.randn((workers, k), generator=gen))
    return [x.cuda() for x in (a, a_prev, s_prev, g_prev)]


def _abs_diff(x: torch.Tensor, y: torch.Tensor) -> float:
    """Largest |x - y|; NaN on both sides agrees, NaN on one side gives
    NaN."""
    both = torch.isnan(x) & torch.isnan(y)
    return float(torch.where(both, 0.0, x - y).abs().max())


def _model_leaves() -> dict:
    """{leaf path: element count} of paper-resnet-proxy at full width."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.tree import tree_items

    cfg = configs.get_config("paper-resnet-proxy")
    return {
        path: leaf.numel()
        for path, leaf in tree_items(lm.init(cfg, device="meta"))
    }


def _bit_mismatches(x: torch.Tensor, y: torch.Tensor) -> int:
    """Elements whose f32 bits differ, NaN against NaN counting as equal;
    a NaN on one side only is a mismatch."""
    both = torch.isnan(x) & torch.isnan(y)
    return int(((x.view(torch.int32) != y.view(torch.int32)) & ~both).sum())


ADVERSARIAL = ("equal", "four", "zeros", "-inf", "subnormal", "+inf")
ADVERSARIAL_M = (1, 8, 16, 36, 128, 257, 512, 8192)


def _adversarial(case: str, gen: torch.Generator, workers: int = W,
                 n: int = 3 * 8192) -> torch.Tensor:
    """``[workers, n]`` scores on the CPU that stress the per-tile radix
    select: "equal" (one value), "four" (four values, so the ties straddle
    the m-th key across threads), "zeros" (-0.0 and +0.0 mixed, a few
    positives), "-inf" (runs of -inf, a few finite scores in tile 1),
    "subnormal" (subnormals of both signs, made from their bits) and
    "+inf" (+inf among |N(0, 1)|)."""
    shape = (workers, n)
    u = torch.rand(shape, generator=gen)
    if case == "equal":
        return torch.full(shape, 1.5)
    if case == "four":
        return torch.tensor([0.5, 1.0, 2.0, 3.0])[
            torch.randint(0, 4, shape, generator=gen)]
    if case == "zeros":
        s = torch.where(u < 0.5, torch.tensor(-0.0), torch.tensor(0.0))
        return torch.where(torch.rand(shape, generator=gen) < 0.002, 1.0, s)
    if case == "subnormal":
        s = torch.randint(1, 64, shape, generator=gen, dtype=torch.int32)
        return torch.where(u < 0.3, s | -2**31, s).view(torch.float32)
    s = torch.randn(shape, generator=gen).abs()
    if case == "-inf":
        s[:, 8192:16384] = -math.inf
        s[:, 2000:2500] = -math.inf
        s[:, [8192 + 9, 8192 + 700, 16383]] = torch.tensor([2.0, 5.0, 2.0])
        return s
    return torch.where(u < 0.01, math.inf, s)


def kernel1_adversarial(gen: torch.Generator) -> dict:
    """Kernel 1 against its plain version, bit for bit, on the adversarial
    tiles at every budget: nothing sent and q = 1e9, so the score is |a|
    exactly; the gradient takes random signs, so -0.0 a-values must come
    out as +0.0 (scores are never negative, so no "-inf" tile)."""
    from repro_torch.kernels import fused_encode as fe
    from repro_torch.kernels import ops

    checked = 0
    for case in ADVERSARIAL:
        if case == "-inf":
            continue
        a = _adversarial(case, gen)
        a = torch.where(torch.rand(a.shape, generator=gen) < 0.5, -a, a)
        z = torch.zeros_like(a)
        tiles = [ops._tile(x.to(DEVICE))[0] for x in (a, z, z, z)]
        for m in ADVERSARIAL_M:
            kw = dict(omega=1.0 / W, mu=1.0, q=1e9, y=1.0, m=m)
            got = fe.fused_candidates(*tiles, **kw)
            want = fe.fused_candidates_ref(*tiles, **kw)
            torch.cuda.synchronize()
            bad = sum(_bit_mismatches(g, w) for g, w in zip(got, want, strict=True))
            if bad:
                raise AssertionError(f"kernel 1 on {case} tiles, m = {m}: {bad} "
                                     "outputs differ in bits from the plain version")
            checked += 1
    log(f"kernel: adversarial tiles ({', '.join(c for c in ADVERSARIAL if c != '-inf')})"
        f" at m = {list(ADVERSARIAL_M)}: bit-equal to the plain version")
    return {"cases": [c for c in ADVERSARIAL if c != "-inf"],
            "m": list(ADVERSARIAL_M), "checked": checked}


def phase_kernels() -> dict:
    """Kernel against plain version at the main path's shapes."""
    from repro_torch.comm import fastpath as fp
    from repro_torch.core.selectors import sparsity_to_k, topk_stable
    from repro_torch.kernels import fused_encode as fe
    from repro_torch.kernels import ops
    from repro_torch.kernels import regtopk_score as rs

    leaves = _model_leaves()
    mlp = leaves["layers.mlp.wg"]
    # (name, length, y, poison, on the trainer's path)
    cases = [(path, n, 1.0, None, True) for path, n in leaves.items()] + [
        ("ragged", 3 * 8192 + 17, 1.0, None, False),
        ("layers.mlp.wg y=2", mlp, 2.0, None, False),
        ("certificate failure", mlp, 1.0, "concentrate", False),
        ("one NaN in a tile", mlp, 1.0, "nan", False),
        ("all-NaN tile", mlp, 1.0, "nan tile", False),
    ]
    gen = torch.Generator().manual_seed(0)
    rows, max_err = [], 0.0
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    for name, L, y, poison, main_path in cases:
        k = sparsity_to_k(L, 0.01)
        m = fp.candidate_budget(L, k)
        xs = _leaf_inputs(L, k, gen, poison)
        tiles = [ops._tile(x)[0] for x in xs]
        kw = dict(omega=1.0 / W, mu=1.0, q=1e9, y=y, m=m)
        cs, cv, ci = fe.fused_candidates(*tiles, **kw)
        ref_s, ref_v, ref_i = fe.fused_candidates_ref(*tiles, **kw)
        torch.cuda.synchronize()
        if not torch.equal(ci, ref_i):
            bad = int((ci != ref_i).sum())
            raise AssertionError(f"{name}: {bad} candidate indices differ")
        err = max(_abs_diff(cs, ref_s), _abs_diff(cv, ref_v))
        bad = _bit_mismatches(cs, ref_s) + _bit_mismatches(cv, ref_v)
        if err != 0.0 or bad:
            raise AssertionError(
                f"{name}: {bad} candidate scores/values differ from the plain "
                f"version in bits (max |diff| {err:g}); the score chain must "
                "be bit-equal"
            )
        max_err = max(max_err, err)
        vals, idx, ok = fe.select_from_candidates(cs, cv, ci, k)
        score = rs.score_chain(*xs, omega=1.0 / W, mu=1.0, q=1e9, y=y)
        _, didx = topk_stable(score, k)
        dvals = torch.gather(xs[0], 1, didx) * (torch.gather(score, 1, didx) > 0)
        for w in torch.nonzero(ok)[:, 0].tolist():
            if not (torch.equal(idx[w], didx[w]) and torch.equal(vals[w], dvals[w])):
                raise AssertionError(f"{name}: certified payload of worker {w} "
                                     "differs from the dense stable top-k")
        if poison and bool(ok.any()):
            raise AssertionError(f"{name}: the certificate should fail")
        ms = median_ms(lambda t=tiles, kw=kw: fe.fused_candidates(*t, **kw))
        plain_ms = median_ms(
            lambda t=tiles, kw=kw: fe.fused_candidates_ref(*t, **kw)
        )
        library_ms = median_ms(lambda s=score, k=k: torch.topk(s, k, dim=1))
        n_el = W * fp._n_tiles(L) * fp._TILE
        bound_ms = 1e3 * max(
            W * fp.fused_hbm_bytes(L, k, m) / HBM_BYTES_PER_S,
            SCORE_OPS * n_el / F32_OPS_PER_S,
        )
        row = dict(leaf=name, length=L, workers=W, k=k, m=m, y=y,
                   certified=int(ok.sum()), ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms)
        rows.append(row)
        log("kernel: " + json.dumps(row))
        if main_path:
            for key in totals:
                totals[key] += row[key]
    adversarial = kernel1_adversarial(gen)
    return {"rows": rows, "max_abs_err": max_err, "per_step": totals,
            "adversarial": adversarial}


BENCH_N, BENCH_K = 262_144, 262  # benchmarks/kernel_bench.py's shape
SELECT_M = 16
FULL_K = (4_459, 44_588)  # S = 0.001 and 0.01 of the full-width row


def _host_ms(fn, iters: int = 10) -> float:
    """Host-clock milliseconds of one call of ``fn`` that ends in a
    synchronise: the latency a caller sees, launch overhead included."""
    fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _select_scores(gen: torch.Generator) -> list:
    """(name, score [L] on the card, thresholds' k, hierarchical k, main
    path) for the select phase."""
    from repro_torch.kernels import regtopk_score as rs

    def abs_normal(n):
        return (3.0 * torch.randn(n, generator=gen)).abs().to(DEVICE)

    J = sum(_model_leaves().values())
    xs = _leaf_inputs(J, FULL_K[1], gen, workers=1)
    wide = rs.score_chain(*xs, omega=1.0 / W, mu=1.0, q=1e9, y=1.0)[0]
    ragged = 3 * 8192 + 17
    nan = abs_normal(BENCH_N)
    nan[BENCH_N // 3] = float("nan")
    return [
        ("kernel_bench", abs_normal(BENCH_N), [BENCH_K], BENCH_K, False),
        ("full width", wide, list(FULL_K), FULL_K[0], True),
        ("ragged", abs_normal(ragged), [25], 25, False),
        ("all-zero", torch.zeros(BENCH_N, device=DEVICE), [BENCH_K], BENCH_K, False),
        ("k >= L", abs_normal(ragged), [ragged], 4 * SELECT_M, False),
        ("NaN input", nan, [BENCH_K], BENCH_K, False),
    ]


def _select_times(score, st, k_list, k_hier) -> dict:
    """Device times of each kernel per launch, the whole selections, their
    plain versions and the library calls, with the bounds from bytes, for
    one score."""
    from repro_torch.core import selectors
    from repro_torch.core.selectors import topk_stable
    from repro_torch.kernels import block_topk as bt
    from repro_torch.kernels import ops
    from repro_torch.kernels import threshold_topk as tt

    P = st.numel()
    nblk = P // 8192
    tau = 0.5 * tt.global_max(st)

    def hier_plain():
        v, i = bt.block_topk_candidates_ref(st, SELECT_M)
        top, pos = topk_stable(v.reshape(1, -1), k_hier)
        return top, torch.gather(i.reshape(1, -1), 1, pos)

    out = {"padded": P, "kernels": {
        "count_above": dict(
            ms=median_ms(lambda: tt.count_above(st, tau)),
            plain_ms=median_ms(lambda: tt.count_above_ref(st, tau)),
            library_ms=None, bound_ms=1e3 * (4 * P + 4) / HBM_BYTES_PER_S),
        "global_max": dict(
            ms=median_ms(lambda: tt.global_max(st)),
            plain_ms=median_ms(lambda: tt.global_max_ref(st)),
            library_ms=median_ms(lambda: torch.amax(score)),
            bound_ms=1e3 * (4 * P + 4) / HBM_BYTES_PER_S),
        "block_topk_candidates": dict(
            ms=median_ms(lambda: bt.block_topk_candidates(st, SELECT_M)),
            plain_ms=median_ms(lambda: bt.block_topk_candidates_ref(st, SELECT_M)),
            library_ms=median_ms(lambda: torch.topk(st.view(-1, 8192), SELECT_M)),
            bound_ms=1e3 * (4 * P + 8 * nblk * SELECT_M) / HBM_BYTES_PER_S),
    }, "selections": {}}
    sel = out["selections"]
    for k in k_list:
        sel[f"threshold k={k}"] = dict(
            ms=median_ms(lambda k=k: ops.threshold_topk_mask(score, k), inner=1),
            host_ms=_host_ms(lambda k=k: ops.threshold_topk_mask(score, k)),
            plain_ms=median_ms(
                lambda k=k: selectors.threshold_topk_mask(score, k), inner=1),
            plain_host_ms=_host_ms(
                lambda k=k: selectors.threshold_topk_mask(score, k)),
            library_ms=median_ms(lambda k=k: torch.topk(score, k)),
            # one max pass, 24 count passes, the mask's read and write
            passes_bound_ms=1e3 * 27 * 4 * P / HBM_BYTES_PER_S,
            # the score read once, the mask written once
            bound_ms=1e3 * 8 * score.numel() / HBM_BYTES_PER_S)
    sel[f"hierarchical k={k_hier}"] = dict(
        ms=median_ms(lambda: ops.hierarchical_topk(score, k_hier, SELECT_M)),
        host_ms=_host_ms(lambda: ops.hierarchical_topk(score, k_hier, SELECT_M)),
        plain_ms=median_ms(hier_plain),
        library_ms=median_ms(lambda: torch.topk(score, k_hier)),
        bound_ms=1e3 * (4 * score.numel() + 8 * k_hier) / HBM_BYTES_PER_S)
    for name, row in {**out["kernels"], **sel}.items():
        log(f"select time {name}: " + json.dumps(row))
    return out


def phase_select() -> dict:
    """The sort-free selection kernels on the card: the main path counted,
    every kernel held bit for bit against its plain version, the
    kernel-driven mask against the plain selector, recall and times."""
    from repro_torch.core import selectors
    from repro_torch.core.selectors import topk_stable
    from repro_torch.kernels import block_topk as bt
    from repro_torch.kernels import ops
    from repro_torch.kernels import threshold_topk as tt

    gen = torch.Generator().manual_seed(2)
    cases = _select_scores(gen)
    wide = next(c for c in cases if c[4])[1]
    kernels = (tt.count_above, tt.global_max, bt.block_topk_candidates)

    # the main path: both threshold selections and the hierarchical top-k
    # of the full-width row; the bisection may not sync with the host
    for fn in kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        masks = {k: ops.threshold_topk_mask(wide, k) for k in FULL_K}
    finally:
        torch.cuda.set_sync_debug_mode("default")
    hier = ops.hierarchical_topk(wide, FULL_K[0], SELECT_M)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in kernels}
    expected = {"count_above": 24 * len(FULL_K), "global_max": len(FULL_K),
                "block_topk_candidates": 1}
    if launches != expected:
        raise AssertionError(f"select: launches {launches}, expected {expected}")
    log(f"select: main path launches {json.dumps(launches)}")

    # the kernel-driven mask is the plain selector's, bit for bit (k < L)
    for k, mask in masks.items():
        want = selectors.threshold_topk_mask(wide, k)
        if not torch.equal(mask, want):
            raise AssertionError(
                f"select: ops.threshold_topk_mask (k={k}) differs from "
                f"core.selectors' in {int((mask != want).sum())} places")
        if int(mask.sum()) < k:
            raise AssertionError(f"select: the k={k} mask holds {int(mask.sum())}")
    log("select: full width, ops.threshold_topk_mask == core.selectors."
        "threshold_topk_mask bit for bit at k = " + ", ".join(map(str, FULL_K))
        + f" (mask sizes {[int(m.sum()) for m in masks.values()]})")

    errs = {fn.__name__: 0.0 for fn in kernels}
    rows = []
    for name, score, k_list, k_hier, _ in cases:
        st, _ = ops._tile(score.reshape(1, -1))
        gm, gm_ref = tt.global_max(st), tt.global_max_ref(st)
        tau = 0.5 * gm_ref
        c, c_ref = tt.count_above(st, tau), tt.count_above_ref(st, tau)
        cand = bt.block_topk_candidates(st, SELECT_M)
        cand_ref = bt.block_topk_candidates_ref(st, SELECT_M)
        mask_bad = 0
        for k in k_list:
            mask = tt.threshold_topk_mask(st, k)
            mask_bad += _bit_mismatches(mask, tt.threshold_topk_mask_ref(st, k))
        torch.cuda.synchronize()
        err = {
            "global_max": _abs_diff(gm, gm_ref),
            "count_above": float((c - c_ref).abs().max()),
            "block_topk_candidates": _abs_diff(cand[0], cand_ref[0]),
        }
        if (any(v != 0.0 for v in err.values()) or mask_bad
                or _bit_mismatches(cand[0], cand_ref[0])
                or not torch.equal(cand[1], cand_ref[1])):
            raise AssertionError(
                f"select {name}: kernels differ from their plain versions "
                f"({err}, {mask_bad} mask elements, candidate indices equal: "
                f"{torch.equal(cand[1], cand_ref[1])})")
        for key, v in err.items():
            errs[key] = max(errs[key], v)
        top_v, top_i = ops.hierarchical_topk(score, k_hier, SELECT_M)
        _, true_i = topk_stable(score.float(), k_hier)
        found = torch.isin(top_i.long(), true_i).sum()
        recall = float(found) / k_hier
        if name == "NaN input":
            if not (bool(torch.isnan(gm).all()) and bool(torch.isnan(cand[0]).any())):
                raise AssertionError("select NaN input: the NaN did not propagate")
        elif not bool(torch.isfinite(top_v).all()):
            raise AssertionError(f"select {name}: non-finite top-k values")
        row = dict(case=name, length=score.numel(), padded=st.numel(), k=k_list,
                   k_hier=k_hier, m=SELECT_M, recall=recall,
                   mask_sizes=[int(tt.threshold_topk_mask(st, k).sum())
                               for k in k_list])
        rows.append(row)
        log("select: " + json.dumps(row) + " (kernels bit-equal to plain)")

    adversarial = block_adversarial(gen)
    times = {"full width": _select_times(wide, ops._tile(wide.reshape(1, -1))[0],
                                         list(FULL_K), FULL_K[0]),
             "kernel_bench": _select_times(cases[0][1],
                                           ops._tile(cases[0][1].reshape(1, -1))[0],
                                           [BENCH_K], BENCH_K)}
    # where a whole selection's time goes: one call under the profiler,
    # against its host-clock latency
    sel = times["full width"]["selections"]
    k = FULL_K[0]
    profile = {
        "threshold": profile_step(lambda: ops.threshold_topk_mask(wide, k),
                                  sel[f"threshold k={k}"]["host_ms"]),
        "hierarchical": profile_step(
            lambda: ops.hierarchical_topk(wide, k, SELECT_M),
            sel[f"hierarchical k={k}"]["host_ms"]),
    }
    return {"launches": launches, "max_abs_err": errs, "rows": rows,
            "adversarial": adversarial, "times": times, "profile": profile,
            "recall_full_width": float(torch.isin(
                hier[1].long(), topk_stable(wide, FULL_K[0])[1]).sum()) / FULL_K[0]}


def block_adversarial(gen: torch.Generator) -> dict:
    """``block_topk_candidates`` against its plain version, bit for bit, on
    every adversarial tile at every budget."""
    from repro_torch.kernels import block_topk as bt
    from repro_torch.kernels import ops

    checked = 0
    for case in ADVERSARIAL:
        st = ops._tile(_adversarial(case, gen).to(DEVICE))[0]
        for m in ADVERSARIAL_M:
            got = bt.block_topk_candidates(st, m)
            want = bt.block_topk_candidates_ref(st, m)
            torch.cuda.synchronize()
            bad = sum(_bit_mismatches(g, w) for g, w in zip(got, want, strict=True))
            if bad:
                raise AssertionError(f"select: block_topk_candidates on {case} "
                                     f"tiles, m = {m}: {bad} outputs differ in bits")
            checked += 1
    log(f"select: block_topk_candidates on adversarial tiles ({', '.join(ADVERSARIAL)})"
        f" at m = {list(ADVERSARIAL_M)}: bit-equal to the plain version")
    return {"cases": list(ADVERSARIAL), "m": list(ADVERSARIAL_M), "checked": checked}


def phase_trainer() -> dict:
    from repro_torch.core import distributed as td
    from repro_torch.core.sparsify import SparsifierConfig
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import fused_encode as fe
    from repro_torch.launch import train
    from repro_torch.optim import OptConfig, make_optimizer
    from repro_torch.tree import tree_items, tree_leaves

    args = train.parse_args([*TRAIN_ARGS, "--steps", str(STEPS)])
    fe.fused_candidates.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = train.run(args)
    losses, params, sp_state, counts = res.losses, res.params, res.sp_state, res.counts
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fe.fused_candidates.launches
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    n_fused = sum(p.fused for p in tree_leaves(res.plan))
    if launches != STEPS * n_fused or launches == 0:
        raise AssertionError(
            f"{launches} kernel launches, expected {STEPS} steps x "
            f"{n_fused} fused leaves"
        )
    log(f"trainer: {STEPS} steps in {seconds:.2f} s, losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, {launches} kernel launches, certificate hit rate "
        f"{counts.hit_rate:.4f} ({counts.rounds - counts.fallbacks}/"
        f"{counts.rounds})")

    # one more step from the trained state, fastpath on vs off
    from repro_torch import configs

    cfg = configs.get_config(args.arch)
    batch = TokenPipeline(cfg, args.global_batch, args.seq, 1, "cuda").batch_at(0)
    runs, outs = {}, {}
    for mode in ("on", "off"):
        dist = td.DistConfig(
            sparsifier=SparsifierConfig(kind="regtopk", sparsity=args.sparsity),
            optimizer=OptConfig(learning_rate=args.lr), fastpath=mode,
        )
        plan = td.build_plan(params, args.sparsity, dist)
        step = td.make_train_step(cfg, dist, plan, W)
        opt_state = make_optimizer(dist.optimizer).init(params)
        runs[mode] = lambda step=step, o=opt_state: step(params, o, sp_state, batch)
        outs[mode] = runs[mode]()
    for (path, on), (_, off) in zip(
        tree_items(outs["on"][2]), tree_items(outs["off"][2]), strict=True
    ):
        if not torch.equal(on.sent_idx, off.sent_idx):
            raise AssertionError(f"{path}: fastpath on/off payloads differ")
        if not torch.equal(on.sent_vals, off.sent_vals):
            raise AssertionError(f"{path}: fastpath on/off values differ")
    log("trainer: one step from the trained state, fastpath on == off "
        "(payload indices and values bit-equal)")
    crowd = winners_per_tile(outs["off"][2], res.plan)
    step_ms, _ = turn_times(runs, "trainer: step time")
    profile = {m: profile_step(run, step_ms[m]) for m, run in runs.items()}

    # a small run against the same run on the CPU (plain kernel version);
    # float32 matmuls sum in another order there, hence 1e-4 relative
    small = ["--smoke", "--workers", "2", "--steps", "3", "--seq", "32",
             "--fastpath", "on", "--log-every", "100"]
    gpu = train.run(train.parse_args(small)).losses
    cpu = train.run(train.parse_args([*small, "--device", "cpu"])).losses
    for g, c in zip(gpu, cpu, strict=True):
        if abs(g - c) > 1e-4 * abs(c):
            raise AssertionError(f"card losses {gpu} vs CPU losses {cpu}")
    log(f"trainer: smoke run on the card matches the CPU run ({gpu} vs {cpu})")
    return {"losses": losses, "launches": launches, "seconds": seconds,
            "hit_rate": counts.hit_rate, "rounds": counts.rounds,
            "fallbacks": counts.fallbacks, "step_ms": step_ms,
            "profile": profile, "winners_per_tile": crowd,
            "kinds": trainer_kinds()}


def trainer_kinds() -> dict:
    """10 steps at full width, W = 8, of each selection the compact runtime
    adds in this slice: cyclic, the dense_allreduce collective, and the
    threshold selector (which the CLI has no flag for, as the JAX trainer
    has none: set through ``DistConfig``)."""
    from repro_torch.core import distributed as td
    from repro_torch.core.sparsify import SparsifierConfig
    from repro_torch.launch import train
    from repro_torch.optim import OptConfig

    base = [a for a in TRAIN_ARGS if a not in ("--fastpath", "on")]
    base += ["--fastpath", "off", "--steps", str(STEPS)]
    runs = {
        "cyclic": (["--sparsifier", "cyclic"], None),
        "dense_allreduce": (["--collective", "dense_allreduce"], None),
        "threshold": ([], lambda a: td.DistConfig(
            sparsifier=SparsifierConfig(kind=a.sparsifier, sparsity=a.sparsity,
                                        mu=a.mu, selector="threshold"),
            optimizer=OptConfig(learning_rate=a.lr))),
    }
    out = {}
    for name, (extra, make_dist) in runs.items():
        log(f"trainer {name}:")
        args = train.parse_args([*base, *extra])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = train.run(args, make_dist(args) if make_dist else None)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if len(res.losses) != STEPS or not all(math.isfinite(x) for x in res.losses):
            raise AssertionError(f"trainer {name}: losses {res.losses}")
        log(f"trainer {name}: {STEPS} steps in {seconds:.2f} s, losses "
            f"{res.losses[0]:.4f} -> {res.losses[-1]:.4f}")
        out[name] = {"losses": res.losses, "seconds": seconds}
    return out


def winners_per_tile(sp_state, plan) -> dict:
    """For each leaf, the most top-k winners any one worker has in one
    8192-element tile, beside the candidate budget m that the certificate
    needs it to stay under."""
    from repro_torch.comm import fastpath as fp
    from repro_torch.tree import tree_items

    plans = dict(tree_items(plan))
    out = {}
    for path, st in tree_items(sp_state):
        p = plans[path]
        per_tile = torch.stack([
            torch.bincount(row // fp._TILE, minlength=fp._n_tiles(p.local_len))
            for row in st.sent_idx
        ])
        out[path] = {"max": int(per_tile.max()), "tiles": fp._n_tiles(p.local_len),
                     "m": fp.candidate_budget(p.local_len, p.k), "k": p.k}
    log("trainer: most top-k winners in one tile / budget m: " + ", ".join(
        f"{path} {v['max']}/{v['m']}" for path, v in out.items()))
    return out


def turn_times(runs: dict, label: str, reps: int = 5):
    """Host-clock milliseconds of one call of each run ("on", "off") from
    the same state, in turns (on, off, off, on), ``reps`` calls a turn.
    Returns (medians, samples)."""
    times = {mode: [] for mode in runs}
    for mode in ("on", "off", "off", "on"):
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[mode]()
            torch.cuda.synchronize()
            times[mode].append(1e3 * (time.perf_counter() - t0))
    out = {mode: statistics.median(ts) for mode, ts in times.items()}
    log(f"{label} {json.dumps(out)} ms (median of {2 * reps}, fastpath "
        "on/off in turns)")
    return out, times


def profile_step(run, step_ms: float) -> dict:
    """One training step under torch.profiler: the device time of its
    kernels, their share of the unprofiled step time ``step_ms``, and the
    heaviest kernels. Only the device activity is traced: the host's
    operator events added 16–18 s to each profiled step of phase 13's
    larger runs and are not read here."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    rows = sorted(
        (
            (ev.self_device_time_total / 1e3, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
        ),
        reverse=True,
    )
    device_ms = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    log(f"profile: {launches} kernels; device busy {device_ms:.2f} ms of a {step_ms:.2f} ms step "
        f"({device_ms / step_ms:.1%}); top: "
        + "; ".join(f"{k[:40]} {ms:.2f} ms x{n}" for ms, n, k in rows[:6]))
    return {"device_ms": device_ms, "busy_share": device_ms / step_ms,
            "launches": launches, "top": [{"kernel": k, "ms": ms, "count": n} for ms, n, k in rows[:25]]}


def _unaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view_as(t)
    view.copy_(t)
    return view


def phase_score() -> dict:
    """The score kernel against its plain version, bit for bit, at the
    simulator's shapes and the edge cases of the chain."""
    from repro_torch.core.selectors import sparsity_to_k
    from repro_torch.kernels import ops
    from repro_torch.kernels import regtopk_score as rs

    leaves = _model_leaves()
    flat = sum(leaves.values())
    # (name, workers, length, y, case, the simulator's full-width round)
    cases = [(path, W, n, 1.0, None, False) for path, n in leaves.items()] + [
        ("flat model", W, flat, 1.0, None, True),
        ("fig3 N=20 J=100", 20, 100, 1.0, None, False),
        ("ragged", W, 3 * 8192 + 17, 1.0, None, False),
        ("flat model y=2", W, flat, 2.0, None, False),
        ("flat model y=1.5", W, flat, 1.5, None, False),
        ("zero denominators", W, leaves["layers.mlp.wg"], 1.0, "zero", False),
        ("all unsent", W, leaves["layers.mlp.wg"], 1.0, "unsent", False),
        ("NaN input", W, leaves["layers.mlp.wg"], 1.0, "nan", False),
        ("unaligned view", W, leaves["layers.mlp.wg"], 1.0, "unaligned", False),
    ]
    gen = torch.Generator().manual_seed(1)
    rows, max_err, main = [], 0.0, None
    for name, n_workers, L, y, case, main_path in cases:
        a, a_prev, s_prev, g_prev = _leaf_inputs(
            L, sparsity_to_k(L, 0.01), gen, workers=n_workers
        )
        if case == "zero":  # a == 0 where the coordinate was sent
            a = torch.where(s_prev > 0, 0.0, a)
        elif case == "unsent":
            s_prev = torch.zeros_like(s_prev)
        elif case == "nan":
            a[:, 5] = float("nan")
        tiles = [ops._tile(x)[0] for x in (a, a_prev, s_prev, g_prev)]
        if case == "unaligned":  # 4 bytes off 16: the kernel's scalar loop
            tiles = [_unaligned(t) for t in tiles]
        kw = dict(omega=1.0 / n_workers, mu=1.0, q=1e9, y=y)
        got = rs.regtopk_score(*tiles, **kw)
        want = rs.regtopk_score_ref(*tiles, **kw)
        torch.cuda.synchronize()
        bad = _bit_mismatches(got, want)
        if bad:
            raise AssertionError(
                f"score {name}: {bad} elements differ from the plain version "
                f"(max |diff| {_abs_diff(got, want):g}); the chain must be "
                "bit-equal"
            )
        if case == "nan" and not bool(torch.isnan(got[:, 0, 5]).all()):
            raise AssertionError("score NaN input: the NaN did not propagate")
        max_err = max(max_err, _abs_diff(got, want))
        ms = median_ms(lambda t=tiles, kw=kw: rs.regtopk_score(*t, **kw))
        plain_ms = median_ms(lambda t=tiles, kw=kw: rs.regtopk_score_ref(*t, **kw))
        n_el = tiles[0].numel()
        bound_ms = 1e3 * max(SCORE_BYTES * n_el / HBM_BYTES_PER_S,
                             SCORE_OPS * n_el / F32_OPS_PER_S)
        row = dict(case=name, workers=n_workers, length=L, padded=n_el, y=y,
                   ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bytes_per_s=SCORE_BYTES * n_el / (ms * 1e-3))
        rows.append(row)
        log("score: " + json.dumps(row))
        if main_path:
            main = row
        del a, a_prev, s_prev, g_prev, tiles, got, want
    return {"rows": rows, "max_abs_err": max_err, "per_round": main}


def phase_sim() -> dict:
    """The simulator on the card: Fig. 1, Fig. 3 and the full-width round,
    the score kernel's launches counted over the phase."""
    from repro_torch.kernels import fused_encode as fe
    from repro_torch.kernels import regtopk_score as rs

    fe.fused_candidates.launches = 0
    rs.regtopk_score.launches = 0
    fig1 = sim_fig1()
    fig3 = sim_fig3()
    wide = sim_full_width()
    launches = rs.regtopk_score.launches
    expected = fig1["rounds"] + fig3["rounds"] + wide["rounds"]
    if launches != expected or fe.fused_candidates.launches:
        raise AssertionError(
            f"sim: {launches} score kernel launches (expected {expected}: one "
            "per RegTop-k round with the fastpath on) and "
            f"{fe.fused_candidates.launches} fused_candidates launches"
        )
    log(f"sim: {launches} score kernel launches, one per RegTop-k round with "
        "the fastpath on")
    timing = sim_round_times(wide.pop("timing"))
    return {"fig1": fig1, "fig3": fig3, "full_width": wide, "timing": timing,
            "launches": launches}


def sim_fig1(rounds: int = 60) -> dict:
    """Paper Fig. 1 toy, with the assertions of tests/test_sparsify.py:
    Top-1 stuck for 50 rounds, RegTop-1 (through the score kernel) below
    0.05 and within 0.01 of no sparsification."""
    from repro_torch.core import DistributedSim, SparsifierConfig

    x = torch.tensor([[100.0, 1.0], [-100.0, 1.0]], device=DEVICE)

    def grad_fn(theta, widx):
        xn = x[widx]
        e = torch.exp(-(xn @ theta))[:, None]
        return -e * xn / (1 + e)

    traces = {}
    for kind in ("topk", "regtopk", "none"):
        sim = DistributedSim(
            grad_fn, 2, 2, SparsifierConfig(kind=kind, sparsity=0.5, mu=1.0),
            learning_rate=0.9, fastpath="on", device=DEVICE,
        )
        _, tr = sim.run(torch.tensor([0.0, 1.0]), rounds,
                        trace_fn=lambda th: torch.log(1 + torch.exp(-x @ th)).mean())
        traces[kind] = tr.tolist()
    t = traces
    if not (math.isclose(t["topk"][49], t["topk"][0], rel_tol=1e-6)
            and t["regtopk"][49] < 0.05
            and abs(t["regtopk"][49] - t["none"][49]) < 0.01):
        raise AssertionError(f"fig1: round 49 {[v[49] for v in t.values()]}")
    log(f"sim fig1: loss at round 49: topk {t['topk'][49]:.6f} (round 0 "
        f"{t['topk'][0]:.6f}), regtopk {t['regtopk'][49]:.6f}, none "
        f"{t['none'][49]:.6f}")
    return {"rounds": rounds, **{kind: tr[49] for kind, tr in traces.items()}}


def sim_fig3(rounds: int = 2500) -> dict:
    """Paper Fig. 3 at its published size: N = 20, J = 100, Dn = 500,
    eta = 1e-2, S = 0.4, mu = 16, the optimality gap every round."""
    from repro_torch.core import DistributedSim, SparsifierConfig
    from repro_torch.data import linreg_grad_fn, make_linreg
    from repro_torch.kernels import regtopk_score as rs

    data = make_linreg(42, 20, 100, 500, device=DEVICE)
    runs, traces = {}, {}
    for name, kind, mode in (("regtopk on", "regtopk", "on"),
                             ("regtopk off", "regtopk", "off"),
                             ("topk", "topk", "off")):
        sim = DistributedSim(
            linreg_grad_fn(data), 20, 100,
            SparsifierConfig(kind=kind, sparsity=0.4, mu=16.0),
            learning_rate=1e-2, fastpath=mode, device=DEVICE,
        )
        before = rs.regtopk_score.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fin, tr = sim.run(torch.zeros(100), rounds,
                          trace_fn=lambda th: torch.linalg.norm(th - data.theta_star))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = rs.regtopk_score.launches - before
        if launched != (rounds if mode == "on" else 0):
            raise AssertionError(f"fig3 {name}: {launched} kernel launches")
        runs[name] = fin
        traces[name] = tr
        gaps = (float(tr[999]), float(tr[-1]))
        if not all(math.isfinite(g) for g in gaps):
            raise AssertionError(f"fig3 {name}: gaps {gaps}")
        log(f"sim fig3 {name}: gap@1000 {gaps[0]:.6e} gap@2500 {gaps[1]:.6e} "
            f"({rounds} rounds in {seconds:.2f} s, "
            f"{1e3 * seconds / rounds:.3f} ms per round, {launched} launches)")
    on, off = runs["regtopk on"], runs["regtopk off"]
    if not (torch.equal(traces["regtopk on"], traces["regtopk off"])
            and torch.equal(on.theta, off.theta)
            and torch.equal(on.worker_states.s_prev, off.worker_states.s_prev)):
        raise AssertionError("fig3: RegTop-k fastpath on and off differ")
    log(f"sim fig3: RegTop-k fastpath on == off over {rounds} rounds "
        "(traces, final theta and masks bit-equal)")
    return {"rounds": rounds, **{
        name: {"gap@1000": float(tr[999]), "gap@2500": float(tr[-1])}
        for name, tr in traces.items()
    }}


def _flat_model(cfg=None):
    """``(grad_fn, theta0, J)`` of paper-resnet-proxy's flat parameter
    vector, as benchmarks/fig6_nn_proxy.py selects over it: the grad_fn is
    composed here from the port's lm.loss_fn, TokenPipeline and tree
    utilities, one batch shard of the global batch of 32 per worker."""
    from repro_torch import configs
    from repro_torch.data import TokenPipeline
    from repro_torch.models import lm
    from repro_torch.nn.layers import set_fp32_matmul
    from repro_torch.tree import tree_leaves, tree_unflatten

    set_fp32_matmul()
    cfg = cfg or configs.get_config("paper-resnet-proxy")
    params = lm.init(cfg, seed=0, device=DEVICE)
    shapes = [p.shape for p in tree_leaves(params)]
    sizes = [p.numel() for p in tree_leaves(params)]
    batch = TokenPipeline(cfg, 32, 128, seed=1, device=DEVICE).batch_at(0)
    per = 32 // W

    def grad_fn(theta, widx):
        out = []
        for w in widx.tolist():
            leaves = [
                x.view(s).detach().requires_grad_(True)
                for x, s in zip(torch.split(theta, sizes), shapes, strict=True)
            ]
            shard = {key: v[w * per:(w + 1) * per] for key, v in batch.items()}
            loss = lm.loss_fn(tree_unflatten(params, leaves), cfg, shard)[0]
            out.append(torch.cat([g.reshape(-1) for g in
                                  torch.autograd.grad(loss, leaves)]))
        return torch.stack(out)

    theta0 = torch.cat([p.reshape(-1) for p in tree_leaves(params)])
    return grad_fn, theta0, sum(sizes)


def sim_full_width(rounds: int = 5, cfg=None) -> dict:
    """Whole-model selection over paper-resnet-proxy's flat parameter
    vector (``_flat_model``): N = 8 workers, RegTop-k at S = 0.01. The
    fastpath-on run computes the gradients and the off run replays them,
    round by round, so the two see the same gradients even if the
    backward is not deterministic."""
    from repro_torch.core import DistributedSim, SparsifierConfig
    from repro_torch.core.selectors import sparsity_to_k

    grad_fn, theta0, J = _flat_model(cfg)
    widx = torch.arange(W, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g0 = grad_fn(theta0, widx)
    torch.cuda.synchronize()
    grad_ms = 1e3 * (time.perf_counter() - t0)
    deterministic = torch.equal(g0, grad_fn(theta0, widx))
    log(f"sim full width: J = {J}, the {W} workers' backward takes {grad_ms:.1f} "
        f"ms (host clock), deterministic: {deterministic}")

    recorded = []

    def record(theta, widx):
        recorded.append(grad_fn(theta, widx))
        return recorded[-1]

    def replay(theta, widx):
        return recorded.pop(0)

    scfg = SparsifierConfig(kind="regtopk", sparsity=0.01)
    sims = {mode: DistributedSim(fn, W, J, scfg, learning_rate=0.05,
                                 aggregation="sparse_allgather", fastpath=mode,
                                 device=DEVICE)
            for mode, fn in (("on", record), ("off", replay))}
    states = {mode: sim.init(theta0) for mode, sim in sims.items()}
    k = sparsity_to_k(J, 0.01)
    for r in range(rounds):
        outs = {mode: sims[mode].step_fn(states[mode]) for mode in ("on", "off")}
        (on, g_on), (off, g_off) = outs["on"], outs["off"]
        if not (torch.equal(on.worker_states.s_prev, off.worker_states.s_prev)
                and torch.equal(g_on, g_off) and torch.equal(on.theta, off.theta)):
            raise AssertionError(f"full width round {r}: fastpath on and off differ")
        sent = on.worker_states.s_prev.sum(dim=1)
        if not (bool(torch.isfinite(g_on).all()) and bool((sent == k).all())):
            raise AssertionError(f"full width round {r}: {sent.tolist()} sent, k={k}")
        states = {"on": on, "off": off}
    log(f"sim full width: fastpath on == off for {rounds} rounds (masks, "
        f"g_agg and theta bit-equal), k = {k} of J = {J} per worker")
    fixed = g0

    def constant(theta, widx):
        return fixed

    timing = {mode: (DistributedSim(constant, W, J, scfg, learning_rate=0.05,
                                    aggregation="sparse_allgather", fastpath=mode,
                                    device=DEVICE),
                     states[mode]) for mode in ("on", "off")}
    return {"rounds": rounds, "J": J, "k": k, "grad_ms": grad_ms,
            "backward_deterministic": deterministic, "timing": timing}


def sim_round_times(timing: dict, reps: int = 5) -> dict:
    """Host-clock milliseconds of one full-width simulator round from the
    same state, the gradient held fixed (the round's own work: score,
    selection, payload, aggregation, update), fastpath on and off in
    turns; then one round of each under the profiler."""
    runs = {mode: (lambda sim=sim, st=st: sim.step_fn(st))
            for mode, (sim, st) in timing.items()}
    for run in runs.values():
        run()
    round_ms, times = turn_times(
        runs, "sim full width: round time (gradient fixed)", reps
    )
    profile = {mode: profile_step(run, round_ms[mode]) for mode, run in runs.items()}
    return {"round_ms": round_ms, "samples": times, "profile": profile}


WIRE_STEPS = 5


def _bits_equal(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Equal dtype, shape and bits (floats compared as int32 bits)."""
    if x.dtype != y.dtype or x.shape != y.shape:
        return False
    if x.dtype == torch.float32:
        x, y = x.view(torch.int32), y.view(torch.int32)
    return torch.equal(x, y)


class _PayloadRecorder:
    """Records every payload the ``encode`` of any of ``codecs`` returns
    while installed, in call order (``encode_fused`` of every fusing codec
    calls ``encode``, so each leaf's payload is recorded once)."""

    def __init__(self, *codecs):
        self.codecs, self.payloads = codecs, []

    def __enter__(self):
        for codec in self.codecs:
            encode = type(codec).encode

            def recording(vals, idx, length, codec=codec, encode=encode):
                payload = encode(codec, vals, idx, length)
                self.payloads.append(payload)
                return payload

            codec.encode = recording
        return self

    def __exit__(self, *exc):
        for codec in self.codecs:
            del codec.encode


def _timed_step(step, params, sp_state, batch, reps: int = 3):
    """Run ``step`` from the same state ``reps`` times; returns (the last
    outputs, the median host-clock milliseconds of one step)."""
    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(params, sp_state, batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return out, statistics.median(times)


def _model_cfg(args):
    from repro_torch import configs

    cfg = configs.get_config(args.arch)
    return cfg.smoke_variant() if args.smoke else cfg


def _one_step(args, res, dist, table=None):
    """One training step from the state a run ``res`` of ``args`` reached,
    under ``dist``, on a batch that run did not see: (the new sparsifier
    state, the payloads the codec encoded, the plan, the step's median
    host-clock milliseconds, the step as a callable)."""
    from repro_torch.comm.codec import get_codec
    from repro_torch.core import distributed as td
    from repro_torch.data import TokenPipeline
    from repro_torch.optim import make_optimizer
    from repro_torch.tree import tree_leaves

    cfg = _model_cfg(args)
    batch = TokenPipeline(cfg, args.global_batch, args.seq, 1,
                          args.device).batch_at(0)
    plan = td.build_plan(res.params, dist.sparsifier.sparsity, dist, table)
    step = td.make_train_step(cfg, dist, plan, W)
    opt_state = make_optimizer(dist.optimizer).init(res.params)
    with _PayloadRecorder(get_codec(dist.codec)) as rec:
        out, ms = _timed_step(lambda p, s, b: step(p, opt_state, s, b),
                              res.params, res.sp_state, batch)
    return (out[2], rec.payloads[-len(tree_leaves(plan)):], plan, ms,
            lambda: step(res.params, opt_state, res.sp_state, batch))


def _payloads_equal(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        sorted(x) == sorted(y) and all(_bits_equal(x[k], y[k]) for k in x)
        for x, y in zip(a, b, strict=True))


def _wire_train(name: str, extra: list, steps: int = WIRE_STEPS, table=None,
                fields=None):
    """``steps`` full-width training steps with ``TRAIN_ARGS`` and
    ``extra`` flags (and the ``DistConfig`` ``fields`` the flags cannot
    set), kernel 1's launches counted from 0 around the run."""
    from repro_torch.kernels import fused_encode as fe
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves

    base = [a for a in TRAIN_ARGS if a not in ("--fastpath", "on")]
    args = train.parse_args([*base, "--steps", str(steps), *extra])
    log(f"wire trainer {name}:")
    fe.fused_candidates.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = train.run(args, table=table,
                    dist=None if fields is None else _dist_of(args, **fields))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fe.fused_candidates.launches
    if len(res.losses) != steps or not all(math.isfinite(x) for x in res.losses):
        raise AssertionError(f"wire trainer {name}: losses {res.losses}")
    n_fused = sum(p.fused for p in tree_leaves(res.plan))
    if launches != steps * n_fused:
        raise AssertionError(f"wire trainer {name}: {launches} kernel 1 launches, "
                             f"expected {steps} steps x {n_fused} fused leaves")
    return args, res, {"losses": res.losses, "seconds": seconds,
                       "launches": launches, "fused_leaves": n_fused,
                       "hit_rate": res.counts.hit_rate}


def wire_trainer(smi: str) -> dict:
    """The trainer's new wire paths at full width (see the module
    docstring, phase 8)."""
    from repro_torch.comm import cost
    from repro_torch.comm.fastpath import ThroughputTable
    from repro_torch.core import distributed as td
    from repro_torch.launch import train
    from repro_torch.tree import tree_items, tree_leaves

    out, launches = {}, 0

    for codec in ("coo_idx_delta", "coo_q8"):
        args, res, row = _wire_train(codec, ["--codec", codec, "--fastpath", "on"])
        if row["launches"] == 0:
            raise AssertionError(f"wire trainer {codec}: kernel 1 never launched")
        launches += row["launches"]
        (st_on, pay_on, plan, ms_on, run_on), (st_off, pay_off, _, ms_off, _) = (
            _one_step(args, res, _dist_of(args, fastpath=mode)) for mode in ("on", "off"))
        if not _payloads_equal(pay_on, pay_off):
            raise AssertionError(f"wire trainer {codec}: fastpath on/off payloads differ")
        for (path, a), (_, b) in zip(tree_items(st_on), tree_items(st_off), strict=True):
            if not (_bits_equal(a.sent_vals, b.sent_vals)
                    and torch.equal(a.sent_idx, b.sent_idx)):
                raise AssertionError(f"wire trainer {codec}: {path} sent_vals differ")
        pred, _ = td.comm_round_bytes(plan, _dist_of(args), W)
        meas = sum(
            cost.measured_bytes(_dist_of(args).resolved_collective(), p.local_len,
                                {k: v[:1] for k, v in pay.items()}, (W,))
            for p, pay in zip(tree_leaves(plan), pay_on, strict=True))
        if meas > 1.05 * pred:
            raise AssertionError(f"wire trainer {codec}: measured {meas} B > "
                                 f"1.05 x predicted {pred} B")
        row.update(step_ms={"on": ms_on, "off": ms_off}, measured_bytes=meas,
                   predicted_bytes=pred, profile=profile_step(run_on, ms_on))
        log(f"wire trainer {codec}: {row['launches']} kernel 1 launches in "
            f"{WIRE_STEPS} steps ({row['fused_leaves']} fused leaves), hit rate "
            f"{row['hit_rate']:.4f}; one step on == off (encoded payloads and "
            f"sent_vals bit-equal); measured {meas} B <= 1.05 x predicted {pred} B "
            f"per worker per round; step {ms_on:.1f} ms on, {ms_off:.1f} ms off "
            f"(host clock; {smi})")
        out[codec] = row

    args, res, row = _wire_train("bitmap_dense",
                                 ["--codec", "bitmap_dense", "--fastpath", "on"])
    if row["launches"] or row["fused_leaves"]:
        raise AssertionError("wire trainer bitmap_dense: fused, but it never fuses")
    *_, row["step_ms"], run = _one_step(args, res, _dist_of(args, fastpath="on"))
    row["profile"] = profile_step(run, row["step_ms"])
    log(f"wire trainer bitmap_dense: 0 kernel launches (never fuses), losses "
        f"{res.losses[0]:.4f} -> {res.losses[-1]:.4f}; step {row['step_ms']:.1f} ms "
        f"(host clock; {smi})")
    out["bitmap_dense"] = row

    args, res, row = _wire_train("coord-weights", ["--coord-weights"])
    sent_w = torch.cat([st.sent_w.reshape(-1) for _, st in tree_items(res.sp_state)])
    if bool((sent_w == 1.0).all()) or not bool(torch.isfinite(sent_w).all()):
        raise AssertionError("wire trainer coord-weights: sent_w is all 1")
    *_, row["step_ms"], run = _one_step(args, res, _dist_of(args, weighting="coordinate"))
    row["profile"] = profile_step(run, row["step_ms"])
    row["sent_w_not_one"] = float((sent_w != 1.0).float().mean())
    log(f"wire trainer coord-weights: losses {res.losses[0]:.4f} -> "
        f"{res.losses[-1]:.4f}, sent_w != 1 at {row['sent_w_not_one']:.4f} of the "
        f"sent slots; step {row['step_ms']:.1f} ms (host clock; {smi})")
    out["coord_weights"] = row

    table = ThroughputTable.measure(device=DEVICE)
    args, res, row = _wire_train("auto", ["--fastpath", "auto"], table=table)
    launches += row["launches"]
    fused = [path for path, p in tree_items(res.plan) if p.fused]
    log(f"wire trainer auto: ThroughputTable.measure() on this card: fused "
        f"{table.fused_bps:.4e} B/s, unfused {table.unfused_bps:.4e} B/s; auto "
        f"fuses {len(fused)}/{len(tree_leaves(res.plan))} leaves {fused} ({smi})")
    steps = {mode: _one_step(args, res, _dist_of(args, fastpath=mode), table)
             for mode in ("auto", "off")}
    if not _payloads_equal(steps["auto"][1], steps["off"][1]):
        raise AssertionError("wire trainer auto: payloads differ from fastpath off")
    row.update(table={"fused_bps": table.fused_bps, "unfused_bps": table.unfused_bps},
               fused_paths=fused,
               step_ms={"auto": steps["auto"][3], "off": steps["off"][3]})
    log(f"wire trainer auto: one step auto == off (payloads bit-equal); step "
        f"{steps['auto'][3]:.1f} ms auto, {steps['off'][3]:.1f} ms off "
        f"(host clock; {smi})")
    out["auto"] = row

    smoke = {}  # coo_fp32's is phase_trainer's
    for codec in ("coo_idx_delta", "bitmap_dense", "coo_q8"):
        small = ["--smoke", "--workers", "2", "--steps", "3", "--seq", "32",
                 "--fastpath", "on", "--log-every", "100", "--codec", codec]
        gpu = train.run(train.parse_args([*small, "--device", DEVICE])).losses
        cpu = train.run(train.parse_args([*small, "--device", "cpu"])).losses
        for g, c in zip(gpu, cpu, strict=True):
            if abs(g - c) > 1e-4 * abs(c):
                raise AssertionError(f"wire smoke {codec}: card {gpu} vs CPU {cpu}")
        smoke[codec] = {"card": gpu, "cpu": cpu}
    log("wire trainer: smoke run per codec on the card matches the CPU run "
        "(losses within 1e-4 relative)")
    out["smoke"] = smoke
    out["launches"] = launches
    return out


def _paired_sims(grad_fn, theta0, J, rounds, kw_a, kw_b, check, label):
    """Two simulators over the same gradients (``a`` computes them, ``b``
    replays them) for ``rounds`` rounds; ``check(r, (state, g_agg) of a,
    of b)`` raises on a difference. Returns the two simulators and their
    last states."""
    from repro_torch.core import DistributedSim, SparsifierConfig

    recorded = []

    def record(theta, widx):
        recorded.append(grad_fn(theta, widx))
        return recorded[-1]

    def replay(theta, widx):
        return recorded.pop(0)

    scfg = SparsifierConfig(kind="regtopk", sparsity=0.01)
    sims = [DistributedSim(fn, W, J, scfg, learning_rate=0.05, device=DEVICE, **kw)
            for fn, kw in ((record, kw_a), (replay, kw_b))]
    states = [sim.init(theta0) for sim in sims]
    for r in range(rounds):
        outs = [sim.step_fn(st) for sim, st in zip(sims, states, strict=True)]
        for st, g in outs:
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"wire sim {label} round {r}: non-finite g_agg")
        check(r, *outs)
        states = [o[0] for o in outs]
    return sims, states


def _round_ms(sim, state, g_fixed, reps: int = 5) -> dict:
    """Host-clock milliseconds of one round from ``state`` with the
    gradient held fixed (the round's own work), and one such round under
    the profiler."""
    sim.grad_fn = lambda theta, widx: g_fixed
    sim.step_fn(state)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.step_fn(state)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    ms = statistics.median(times)
    return {"ms": ms, "profile": profile_step(lambda: sim.step_fn(state), ms)}


def wire_sim(smi: str, rounds: int = 5, cfg=None) -> dict:
    """The simulator's new wire paths at full width (phase 8); ``cfg``
    replaces paper-resnet-proxy for a rehearsal on the CPU."""
    from repro_torch.core import DistributedSim, SparsifierConfig
    from repro_torch.kernels import regtopk_score as rs

    grad_fn, theta0, J = _flat_model(cfg)
    g0 = grad_fn(theta0, torch.arange(W, device=DEVICE))
    out = {}

    def same(fields):
        def check(r, a, b):
            (sa, ga), (sb, gb) = a, b
            pairs = {"g_agg": (ga, gb), "theta": (sa.theta, sb.theta),
                     "eps": (sa.worker_states.eps, sb.worker_states.eps),
                     "masks": (sa.worker_states.s_prev, sb.worker_states.s_prev)}
            for f in fields:
                if not _bits_equal(*pairs[f]):
                    raise AssertionError(f"wire sim round {r}: {f} differ")
        return check

    rs.regtopk_score.launches = 0
    kw = dict(codec="coo_q8", aggregation="sparse_allgather")
    sims, states = _paired_sims(grad_fn, theta0, J, rounds, {**kw, "fastpath": "on"},
                                {**kw, "fastpath": "off"},
                                same(("g_agg", "theta", "eps", "masks")), "coo_q8")
    launches = rs.regtopk_score.launches
    if launches != rounds:
        raise AssertionError(f"wire sim coo_q8: {launches} score launches, "
                             f"expected {rounds}")
    out["coo_q8"] = {"rounds": rounds, "launches": launches,
                     "round": {m: _round_ms(s, st, g0) for m, s, st in
                               zip(("on", "off"), sims, states, strict=True)}}
    log(f"wire sim coo_q8: fastpath on == off for {rounds} rounds (theta, eps, "
        f"masks and g_agg bit-equal), {launches} score launches; round "
        + ", ".join(f"{m} {r['ms']:.2f} ms" for m, r in out["coo_q8"]["round"].items())
        + f" (gradient fixed, host clock; {smi})")

    before = rs.regtopk_score.launches
    kw = dict(aggregation="sparse_allgather", weighting="coordinate")
    sims, states = _paired_sims(grad_fn, theta0, J, rounds, {**kw, "fastpath": "off"},
                                {**kw, "fastpath": "auto"},
                                same(("g_agg", "theta", "eps", "masks")), "coordinate")
    if rs.regtopk_score.launches != before:
        raise AssertionError("wire sim coordinate: auto launched the score kernel")
    den = states[0].w_agg_prev
    if den is None or bool((den == 1.0).all()):
        raise AssertionError("wire sim coordinate: no sender mass recorded")
    out["coordinate"] = {"rounds": rounds,
                         "round": _round_ms(sims[0], states[0], g0),
                         "den_max": float(den.max())}
    log(f"wire sim coordinate: {rounds} rounds, auto == off (no score launch), "
        f"sender mass up to {out['coordinate']['den_max']:.4f}; round "
        f"{out['coordinate']['round']['ms']:.2f} ms (gradient fixed, host clock; {smi})")

    kw = dict(codec="coo_idx_delta", fastpath="off")
    sims, states = _paired_sims(
        grad_fn, theta0, J, rounds, {**kw, "collective": "hierarchical", "dp_shape": (2, 4)},
        {**kw, "collective": "sparse_allgather"}, same(("g_agg", "theta", "eps")),
        "hierarchical")
    out["hierarchical"] = {"rounds": rounds,
                           "round": _round_ms(sims[0], states[0], g0)}
    log(f"wire sim hierarchical (coo_idx_delta, dp 2 x 4): == sparse_allgather for "
        f"{rounds} rounds (g_agg, theta, eps bit-equal); round "
        f"{out['hierarchical']['round']['ms']:.2f} ms (gradient fixed, host clock; "
        f"{smi})")

    wire = {}
    for codec in ("coo_fp32", "coo_idx_delta", "bitmap_dense", "coo_q8"):
        for coll in ("sparse_allgather", "hierarchical", "dense_allreduce"):
            est = DistributedSim(None, W, J, SparsifierConfig(sparsity=0.01),
                                 codec=codec, collective=coll, dp_shape=(2, 4),
                                 device=DEVICE).wire_bytes_per_round()
            wire[f"{codec}/{coll}"] = {"bytes": est.bytes_on_wire,
                                      "messages": est.n_messages,
                                      "seconds": est.seconds}
    for name, row in wire.items():
        log(f"wire sim wire_bytes_per_round {name} (dp 2 x 4, default link): "
            + json.dumps(row))
    out["wire_bytes_per_round"] = wire
    out["launches"] = launches
    return out


def phase_wire(smi: str) -> dict:
    return {"trainer": wire_trainer(smi), "sim": wire_sim(smi)}


RANK_STEPS = 5
# phase 9 (b): name -> the flags beside TRAIN_ARGS' (which set W = 8 and
# the fastpath on); --coord-weights runs with the fastpath off (the fused
# kernel takes a scalar omega)
# the adaptive-k spec of the trainer's runs: a k_max of 1.2% of each leaf
# keeps the fused leaves fused (``fastpath.shape_fusable``'s budget is about
# 1.5% of a leaf), where the default 25% would fuse none
TRAIN_ADAPTIVE = "1.0,0.001,0.012"
PLAN_AUTO = ["--codec", "auto", "--collective", "auto"]
RANK_RUNS = {
    "sparse_allgather": [],
    "coord_weights": ["--coord-weights", "--fastpath", "off"],
    "dense_allreduce": ["--collective", "dense_allreduce"],
    "hierarchical": ["--collective", "hierarchical", "--codec", "coo_idx_delta",
                     "--multi-pod"],
    "auto": ["--fastpath", "auto"],
    "round_robin": ["--participation", "round_robin:2"],
    "adaptive": ["--adaptive-k", TRAIN_ADAPTIVE],
    # phase 11 (c): the planners across ranks
    "calibrate": ["--calibrate", "--multi-pod"],
    "auto_calibrate": [*PLAN_AUTO, "--calibrate"],
    "replan": [*PLAN_AUTO, "--replan-every", "2", "--steps", "6"],
}
# whether a run's plan fuses leaves: dense_allreduce moves the dense
# vector, so it fuses none, and neither does coordinate weighting; under
# auto rank 0's measured table decides, for every rank (``_rank_body``)
RANK_FUSED = {"sparse_allgather": True, "coord_weights": False,
              "dense_allreduce": False, "hierarchical": True,
              "round_robin": True, "adaptive": True, "calibrate": True,
              "auto_calibrate": True, "replan": True}
# the runs whose sums take another order than the one card's: all_reduce
# sums in the backend's order, and on ("pod", "data") the gathered stack
# has the pod index fastest
RANK_ALL_REDUCE = ("dense_allreduce", "hierarchical", "calibrate")
# the runs whose difference from the one-card run is reported, not held:
# the controller's norm is a sum over the ranks in gloo's order, so a k at
# a rounding boundary may part the two runs; the calibrated and replanned
# plans are priced by the ranks' fitted model, the one card's by the
# defaults (it has no wire to probe)
RANK_REPORTED = ("round_robin", "adaptive", "auto_calibrate", "replan")
# the runs whose plan changes mid-run, so kernel 1's launches are held to
# the fused worker-rounds counted, not to steps x the last plan's fused leaves
RANK_REPLANNED = ("replan",)


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _rank_args(base: list, extra: list, device: str, workers: int):
    """Phase 9's trainer flags: ``base`` (``TRAIN_ARGS``), then the ones
    given here, which argparse lets override it."""
    from repro_torch.launch import train

    return train.parse_args([*base, "--workers", str(workers), "--steps",
                             str(RANK_STEPS), "--log-every", "100",
                             "--device", device, *extra])


def _dist_of(args, **fields):
    """The ``DistConfig`` that ``train.run`` builds from ``args``, with
    ``fields`` replaced."""
    import dataclasses

    from repro_torch.launch import train

    return dataclasses.replace(train.dist_config(args), **fields)


def _step_ms(args, res, mesh=None, reps: int = 3, dcfg=None):
    """Median host-clock milliseconds of one training step from the state
    run ``res`` reached (this rank's step across the ranks of ``mesh``;
    under ``dcfg``, else the flags' ``DistConfig``), and one more step
    under torch.profiler: the device time of its kernels and the host
    operators that took the most time (self time)."""
    import torch.distributed as dist

    from repro_torch.core import distributed as td
    from repro_torch.data import TokenPipeline
    from repro_torch.optim import make_optimizer

    cfg = _model_cfg(args)
    dcfg = dcfg or _dist_of(args)
    workers = args.workers if mesh is None else mesh.size
    step = td.make_train_step(cfg, dcfg, res.plan, workers, mesh=mesh)
    opt_state = make_optimizer(dcfg.optimizer).init(res.params)
    batch = TokenPipeline(cfg, args.global_batch, args.seq, 1,
                          args.device).batch_at(0)
    times = []
    for _ in range(reps):
        _sync(args.device)
        if mesh is not None:
            dist.barrier()
        t0 = time.perf_counter()
        step(res.params, opt_state, res.sp_state, batch)
        _sync(args.device)
        times.append(1e3 * (time.perf_counter() - t0))
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(args.device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        step(res.params, opt_state, res.sp_state, batch)
        _sync(args.device)
    rows = prof.key_averages()
    device_ms = sum(ev.self_device_time_total for ev in rows
                    if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    host = sorted(((ev.self_cpu_time_total / 1e3, ev.count, ev.key)
                   for ev in rows
                   if ev.device_type == torch.autograd.DeviceType.CPU),
                  reverse=True)[:8]
    return statistics.median(times), {
        "device_ms": device_ms,
        "host_top": [{"op": k, "ms": ms, "count": n} for ms, n, k in host]}


def _params_digest(params) -> str:
    import hashlib

    from repro_torch.tree import tree_leaves

    h = hashlib.sha256()
    for leaf in tree_leaves(params):
        h.update(leaf.detach().cpu().contiguous().view(torch.int32).numpy().tobytes())
    return h.hexdigest()


def _wire_bytes(args, plan, payloads, dp_sizes):
    """(predicted, measured) bytes per worker per round of one step: the
    full round's prediction of ``comm_round_bytes`` (every worker's buffer
    crosses the wire, a dropped one's too), the measurement from the
    payloads this rank encoded in its last step (none on a dense wire)."""
    from repro_torch.comm import cost
    from repro_torch.core import distributed as td
    from repro_torch.tree import tree_leaves

    dcfg = _dist_of(args, participation=None)
    pred, _ = td.comm_round_bytes(plan, dcfg, dp_sizes)
    meas, leaves = 0, tree_leaves(plan)
    last = payloads[-len(leaves):] if payloads else [{}] * len(leaves)
    for p, (_, _, coll, wb, dense), pay in zip(
            leaves, td._leaf_wire_patterns(plan, dcfg), last, strict=True):
        meas += cost.measured_bytes(coll, p.local_len, {} if dense else pay,
                                    dp_sizes, word_bytes=wb)
    return pred, meas


def _rank_body(rank: int, world: int, store: str, out_dir: str,
               device: str, base: list, ckpt_dir=None) -> None:
    """One of phase 9's ranks over gloo: every run of ``RANK_RUNS`` on the
    flags ``base`` in turn, kernel 1's launches counted from 0 around
    each. Rank 0 saves its params per run and prints its lines; every
    rank saves its numbers (its plan's wires and its link model among
    them) to ``out_dir/rank{rank}.json``. The ``sparse_allgather`` run
    also writes ``--checkpoint ckpt_dir``, which phase 12 resumes on one
    card."""
    import contextlib
    import io

    import torch.distributed as dist

    from repro_torch.comm.codec import CODECS
    from repro_torch.comm.fastpath import ThroughputTable
    from repro_torch.core import distributed as td
    from repro_torch.kernels import fused_encode as fe
    from repro_torch.launch import mesh, train
    from repro_torch.tree import tree_leaves

    if torch.device(device).type == "cuda":
        torch.cuda.set_device(device)
    mesh.init_file_store(store, rank, world, "gloo")
    try:
        out = {}
        for name, extra in RANK_RUNS.items():
            if name == "sparse_allgather" and ckpt_dir is not None:
                extra = [*extra, "--checkpoint", ckpt_dir]
            args = _rank_args(base, extra, device, world)
            groups = mesh.make_host_groups(multi_pod=args.multi_pod)
            # auto: rank 0 measures its table (outside the counted run);
            # the other ranks hold one that would fuse no leaf, so equal
            # plans show that rank 0's table reached every rank
            table = None
            if args.fastpath == "auto":
                table = (ThroughputTable.measure(device=device) if rank == 0
                         else ThroughputTable(fused_bps=1.0))
            fe.fused_candidates.launches = 0
            _sync(device)
            printed = io.StringIO()
            with (_PayloadRecorder(*CODECS.values()) as rec,
                  contextlib.redirect_stdout(printed)):
                res = train.run(args, table=table, mesh=groups)
            _sync(device)
            launches = fe.fused_candidates.launches
            print(printed.getvalue(), end="", flush=True)
            link = res.dist.link_topo or res.dist.link_model
            pred, meas = _wire_bytes(args, res.plan, rec.payloads, groups.shape)
            partial, _ = td.comm_round_bytes(res.plan, _dist_of(args), groups.shape)
            out[name] = {
                "predicted_partial_bytes": partial,
                "ks": (None if args.adaptive_k is None else
                       [int(c.k) for c in tree_leaves(res.sp_state[1])]),
                "losses": res.losses, "launches": launches,
                "fused_leaves": sum(p.fused for p in tree_leaves(res.plan)),
                "fused_paths": [path for path, p in _flat(res.plan).items()
                                if p.fused],
                "rounds": res.counts.rounds, "hit_rate": res.counts.hit_rate,
                "digest": _params_digest(res.params), "predicted_bytes": pred,
                "measured_bytes": meas, "dp": list(groups.shape),
                "steps": args.steps,
                "wires": [[path, *td.leaf_wire(p, res.dist), p.fused]
                          for path, p in _flat(res.plan).items()],
                "link": (None if link is None else
                         [[lk.alpha, lk.beta] for lk in getattr(link, "links",
                                                                 (link,))]),
                "planner_lines": [ln for ln in printed.getvalue().splitlines()
                                  if ln.startswith(("calibrat", "replan"))],
            }
            if name == "sparse_allgather":
                out[name]["step_ms"], out[name]["profile"] = _step_ms(
                    args, res, groups)
            if rank == 0:
                torch.save({k: v.cpu() for k, v in _flat(res.params).items()},
                           f"{out_dir}/{name}.pt")
        Path(f"{out_dir}/rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def _flat(tree) -> dict:
    from repro_torch.tree import tree_items

    return dict(tree_items(tree))


def _param_diff(got: dict, want: dict, adam_step: float = 0.0,
                floors=None, rtol: float = 1e-5) -> dict:
    """Two parameter trees: bit mismatches, the largest difference relative
    to ``|want| + max|leaf of want|``, and the elements beyond ``rtol``
    (1e-5) with a floor of ``rtol`` of their leaf's largest magnitude
    (``tests/test_torch_train.py``'s tolerance). ``ok`` when there are
    none; or, given ``adam_step`` (the most that flipped Adam steps can
    move an element), when at most 0.1% are beyond and by no more than
    it. The second form is for sums that ``all_reduce`` takes in another
    order than the one card: where the workers' gradients nearly cancel,
    a last-ulp difference of the sum changes its sign or zeroes it, and
    Adam's normalised step turns that into up to 2 lr a step."""
    mismatches, worst, beyond, max_abs, n = 0, 0.0, 0, 0.0, 0
    for path, w in want.items():
        g = got[path].to(w.device)
        mismatches += int((g.view(torch.int32) != w.view(torch.int32)).sum())
        # a block's floor is its whole leaf's, given in ``floors``
        floor = float(w.abs().max()) if floors is None else floors[path]
        diff = (g - w).abs()
        worst = max(worst, float((diff / (w.abs() + floor)).max()))
        beyond += int((diff > rtol * w.abs() + rtol * floor).sum())
        max_abs, n = max(max_abs, float(diff.max())), n + w.numel()
    ok = beyond == 0 or (beyond <= 1e-3 * n and max_abs <= adam_step)
    return {"mismatches": mismatches, "largest_rel_diff": worst,
            "beyond_rtol": beyond, "max_abs_diff": max_abs, "n": n, "ok": ok}


def ranks_world_one(device: str = DEVICE, backend: str = "nccl") -> dict:
    """Phase 9 (a): the trainer at world size 1 over ``backend`` in this
    process against the one-card ``--workers 1`` run, in bits."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.comm.codec import get_codec
    from repro_torch.kernels import fused_encode as fe
    from repro_torch.launch import mesh, train

    import contextlib
    import io

    args = _rank_args(TRAIN_ARGS, ["--calibrate"], device, workers=1)

    def traced(groups=None):
        fe.fused_candidates.launches = 0
        _sync(device)
        printed = io.StringIO()
        with (_PayloadRecorder(get_codec(args.codec)) as rec,
              contextlib.redirect_stdout(printed)):
            res = train.run(args, mesh=groups)
        _sync(device)
        print(printed.getvalue(), end="", flush=True)
        return res, rec.payloads, fe.fused_candidates.launches, printed.getvalue()

    one, pay_one, _, _ = traced()
    with tempfile.TemporaryDirectory() as d:
        mesh.init_file_store(f"{d}/store", 0, 1, backend)
        try:
            rk, pay_rk, launches, printed = traced(mesh.make_host_groups())
        finally:
            dist.destroy_process_group()
    skipped = "calibration skipped (single device); using defaults"
    if skipped not in printed.splitlines():
        raise AssertionError(f"ranks (a): --calibrate at world size 1 did not "
                             f"report {skipped!r}")
    for path, w in _flat(one.params).items():
        if not _bits_equal(_flat(rk.params)[path], w):
            raise AssertionError(f"ranks (a): params {path} differ from one card")
    for (path, a), b in zip(_flat(rk.sp_state).items(),
                            _flat(one.sp_state).values(), strict=True):
        for field, x, y in zip(a._fields, a, b, strict=True):
            if not _bits_equal(x, y):
                raise AssertionError(f"ranks (a): {path}.{field} differs")
    if not (pay_rk and _payloads_equal(pay_rk, pay_one)):
        raise AssertionError("ranks (a): encoded payloads differ from one card")
    n_fused = sum(p.fused for p in _flat(rk.plan).values())
    if launches != RANK_STEPS * n_fused or launches == 0:
        raise AssertionError(f"ranks (a): {launches} kernel 1 launches, expected "
                             f"{RANK_STEPS} x {n_fused}")
    log(f"ranks (a): {backend} at world size 1, {RANK_STEPS} steps: params, "
        f"CompactState and {len(pay_rk)} payloads bit-equal to the one-card "
        f"--workers 1 run; {launches} kernel 1 launches; --calibrate: "
        f"{skipped!r}")
    return {"backend": backend, "launches": launches, "losses": rk.losses,
            "payloads": len(pay_rk)}


def ranks_spawned(smi: str, device: str = f"{DEVICE}:0", world: int = W,
                  timeout: float = 480.0, ckpt_dir=None) -> dict:
    """Phase 9 (b): ``world`` ranks spawned on ``device`` over gloo, each
    run of ``RANK_RUNS`` against the one-card ``--workers world`` run; the
    ``sparse_allgather`` run checkpoints to ``ckpt_dir`` when given."""
    import tempfile

    from repro_torch.launch import mesh, train

    one_card = {}
    for name, extra in RANK_RUNS.items():
        args = _rank_args(TRAIN_ARGS, [a for a in extra if a != "--multi-pod"],
                          device, world)
        res = train.run(args)
        one_card[name] = {"params": _flat(res.params), "losses": res.losses,
                          "ks": (None if args.adaptive_k is None else
                                 [int(c.k) for c in _flat(res.sp_state[1]).values()])}
        if name == "sparse_allgather":
            one_card[name]["step_ms"], one_card[name]["profile"] = _step_ms(
                args, res)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        mesh.spawn(_rank_body, world,
                   (f"{d}/store", d, device, TRAIN_ARGS, ckpt_dir),
                   timeout=timeout)
        seconds = time.perf_counter() - t0
        ranks = [json.loads(Path(f"{d}/rank{r}.json").read_text())
                 for r in range(world)]
        params = {name: torch.load(f"{d}/{name}.pt") for name in RANK_RUNS}
    out, launches = {"seconds": seconds}, 0
    for name in RANK_RUNS:
        rows = [rk[name] for rk in ranks]
        if len({row["digest"] for row in rows}) != 1:
            raise AssertionError(f"ranks (b) {name}: ranks' params differ in bits")
        if any(row["fused_paths"] != rows[0]["fused_paths"]
               or row["wires"] != rows[0]["wires"] for row in rows):
            raise AssertionError(f"ranks (b) {name}: the ranks' plans differ")
        if any(row["link"] != rows[0]["link"] for row in rows):
            raise AssertionError(f"ranks (b) {name}: the ranks' link models differ")
        for r, row in enumerate(rows):
            # a replanned run's fused leaves change mid-run: each launch is
            # one of this rank's fused leaf-rounds
            want = (row["rounds"] if name in RANK_REPLANNED
                    else row["steps"] * row["fused_leaves"])
            if row["launches"] != want or (name in RANK_REPLANNED
                                           and not want):
                raise AssertionError(
                    f"ranks (b) {name}: rank {r} launched kernel 1 "
                    f"{row['launches']} times, expected {want} ({row['steps']} "
                    f"steps, {row['fused_leaves']} fused leaves at the end)")
            if row["measured_bytes"] != row["predicted_bytes"]:
                raise AssertionError(
                    f"ranks (b) {name}: rank {r} measured {row['measured_bytes']} "
                    f"B, predicted {row['predicted_bytes']} B")
        if RANK_FUSED.get(name, rows[0]["fused_leaves"] > 0) != (
                rows[0]["fused_leaves"] > 0):
            raise AssertionError(f"ranks (b) {name}: {rows[0]['fused_leaves']} "
                                 "fused leaves")
        args = _rank_args(TRAIN_ARGS, [], device, world)
        diff = _param_diff(params[name], one_card[name]["params"],
                           2 * args.lr * RANK_STEPS if name in RANK_ALL_REDUCE
                           else 0.0)
        held = name not in RANK_REPORTED
        if held and not diff["ok"]:
            raise AssertionError(f"ranks (b) {name}: params against the one-card "
                                 f"run {diff}")
        for got, want in zip(rows[0]["losses"], one_card[name]["losses"],
                             strict=True):
            if held and abs(got - want) > 1e-5 * abs(want):
                raise AssertionError(f"ranks (b) {name}: losses {rows[0]['losses']}"
                                     f" vs one card {one_card[name]['losses']}")
        if any(row["ks"] != rows[0]["ks"] for row in rows):
            raise AssertionError(f"ranks (b) {name}: the ranks' controllers differ")
        if rows[0]["ks"] is not None:
            log(f"ranks (b) {name}: k per leaf after {RANK_STEPS} steps, every "
                f"rank {rows[0]['ks']}, one card {one_card[name]['ks']}")
        _planner_checks(name, rows[0])
        if rows[0]["predicted_partial_bytes"] != rows[0]["predicted_bytes"]:
            log(f"ranks (b) {name}: the partial round is priced at "
                f"{rows[0]['predicted_partial_bytes']} B per worker per round")
        launches += sum(row["launches"] for row in rows)
        out[name] = {"ranks": rows, "vs_one_card": diff,
                     "one_card_losses": one_card[name]["losses"],
                     "one_card_ks": one_card[name]["ks"]}
        log(f"ranks (b) {name}: {world} ranks over gloo on one card, dp "
            f"{rows[0]['dp']}: params equal in bits across ranks; against the "
            f"one-card --workers {world} run ("
            f"{'losses within rtol 1e-5' if held else 'reported, not held'}) "
            f"{diff['mismatches']} bit mismatches, largest relative difference "
            f"{diff['largest_rel_diff']:.3e}, {diff['beyond_rtol']} elements "
            f"beyond rtol 1e-5 (largest |diff| {diff['max_abs_diff']:.3e}); "
            f"{rows[0]['launches']} kernel 1 launches per rank "
            f"({rows[0]['fused_leaves']} fused leaves); "
            f"measured = predicted = {rows[0]['measured_bytes']} B per worker per "
            f"round; losses {rows[0]['losses'][0]:.4f} -> "
            f"{rows[0]['losses'][-1]:.4f}")
    per_rank = [rk["sparse_allgather"]["step_ms"] for rk in ranks]
    one = one_card["sparse_allgather"]
    out["step_ms"] = {"ranks": per_rank, "one_card": one["step_ms"]}
    out["profile"] = {"rank0": ranks[0]["sparse_allgather"]["profile"],
                      "one_card": one["profile"]}
    out["launches"] = launches
    log(f"ranks (b) step time (host clock, sparse_allgather + coo_fp32): rank 0 "
        f"{per_rank[0]:.1f} ms, slowest rank {max(per_rank):.1f} ms, one-card "
        f"--workers {world} {one['step_ms']:.1f} ms ({smi})")
    for who, prof in out["profile"].items():
        log(f"ranks (b) profile {who}: device {prof['device_ms']:.2f} ms; host "
            "self time: " + "; ".join(f"{r['op'][:40]} {r['ms']:.1f} ms x{r['count']}"
                                      for r in prof["host_top"][:6]))
    return out


def _planner_checks(name: str, row: dict) -> None:
    """Phase 11 (c) on rank 0's row (the ranks' wires and link models are
    held equal beside it): the fitted model per dp axis, the plan's picks
    and the replans, printed; raises where one is missing."""
    default = [1e-5, 1e-11]  # cost.AlphaBeta()
    if name in ("calibrate", "auto_calibrate"):
        axes = ("pod", "data") if name == "calibrate" else ("data",)
        if row["link"] is None or len(row["link"]) != len(axes) or default in row["link"]:
            raise AssertionError(f"ranks (b) {name}: fitted link {row['link']}")
        log(f"ranks (b) {name}: every rank holds rank 0's fit: " + ", ".join(
            f"{ax} alpha={a:.4e} s/msg beta={b:.4e} s/B"
            for ax, (a, b) in zip(axes, row["link"], strict=True))
            + " (gloo; the ranks share one card)")
    if name in ("auto_calibrate", "replan"):
        picks = {}
        for _, c, coll, fused in row["wires"]:
            key = f"{c}/{coll}{' fused' if fused else ''}"
            picks[key] = picks.get(key, 0) + 1
        log(f"ranks (b) {name}: one plan on every rank: {picks}")
    if name == "replan":
        lines = row["planner_lines"]
        steps = [int(ln.split("@step ")[1].split(":")[0]) for ln in lines
                 if ln.startswith("replan @step")]
        if steps != list(range(2, row["steps"], 2)):
            raise AssertionError(f"ranks (b) replan: replans at steps {steps}")
        log("ranks (b) replan: " + " | ".join(lines))


def phase_ranks(smi: str, ckpt_dir=None) -> dict:
    one = ranks_world_one()
    spawned = ranks_spawned(smi, ckpt_dir=ckpt_dir)
    return {"world_one": one, "spawned": spawned,
            "launches": one["launches"] + spawned["launches"]}


# phase 10 (a): the schedules the simulator runs at full width, fastpath
# on against off, and the controller of its adaptive run
SIM_SCHEDULES = ("round_robin:2", "bernoulli:0.25,1", "stale:2,2,0.5")
SIM_ADAPTIVE = "1.0,0.001,0.05"
SAMPLED, SAMPLED_N = "sampled:8,7", 32


def _sim_bits_check(label: str):
    """A ``_paired_sims`` check: the two runs' theta, g_agg, g_agg_prev,
    every worker-state slot, the stale pending buffer and countdown and
    the controller's state, equal in bits every round; ``label`` begins
    the error."""
    def check(r, a, b):
        (sa, ga), (sb, gb) = a, b
        pairs = {"g_agg": (ga, gb), "theta": (sa.theta, sb.theta),
                 "g_agg_prev": (sa.g_agg_prev, sb.g_agg_prev)}
        pairs.update({f"worker_states.{f}": (x, y) for f, x, y in zip(
            sa.worker_states._fields, sa.worker_states, sb.worker_states,
            strict=True)})
        for f in ("pending", "pending_age"):
            if getattr(sa, f) is not None:
                pairs[f] = (getattr(sa, f), getattr(sb, f))
        if sa.ctrl is not None:
            pairs.update({f"ctrl.{f}": (x, y) for f, x, y in zip(
                sa.ctrl._fields, sa.ctrl, sb.ctrl, strict=True)})
        for name, (x, y) in pairs.items():
            if not _bits_equal(x, y):
                raise AssertionError(f"{label} round {r}: {name} differ "
                                     "between fastpath on and off")
    return check


def _sampled_fleet(g0, theta0, J: int, rounds: int, smi: str) -> dict:
    """``sampled:8,7`` over a fleet of 32 clients at full width, fastpath
    on against off: each round only the drawn cohort's state moves (its
    round counters are the ones that advance, and they are
    ``round_participants``), the idle clients' state is unchanged in
    bits. The 32 clients' gradients are the 8 workers' (``g0``), scaled
    per group of 8 so that no two groups are alike."""
    from repro_torch.comm import parse_participation
    from repro_torch.core import DistributedSim, SparsifierConfig
    from repro_torch.kernels import regtopk_score as rs

    part = parse_participation(SAMPLED)
    rs.regtopk_score.launches = 0
    table = torch.cat([g0 * (1.0 + 0.25 * i) for i in range(SAMPLED_N // W)])
    scfg = SparsifierConfig(kind="regtopk", sparsity=0.01)
    sims = {mode: DistributedSim(lambda theta, widx: table[widx], SAMPLED_N, J,
                                 scfg, learning_rate=0.05,
                                 aggregation="sparse_allgather",
                                 participation=part, fastpath=mode, device=DEVICE)
            for mode in ("on", "off")}
    states = {mode: sim.init(theta0) for mode, sim in sims.items()}
    check = _sim_bits_check(f"stragglers sim {SAMPLED}")
    cohorts = []
    for r in range(rounds):
        outs = {mode: sims[mode].step_fn(states[mode]) for mode in ("on", "off")}
        check(r, outs["on"], outs["off"])
        old, new = states["on"].worker_states, outs["on"][0].worker_states
        cohort = part.round_participants(r, SAMPLED_N, DEVICE)
        moved = torch.nonzero(new.t != old.t)[:, 0]
        if not torch.equal(moved, cohort):
            raise AssertionError(f"stragglers sim {SAMPLED} round {r}: clients "
                                 f"{moved.tolist()} moved, cohort {cohort.tolist()}")
        idle = torch.ones(SAMPLED_N, dtype=torch.bool, device=DEVICE)
        idle[cohort] = False
        for f, x, y in zip(old._fields, old, new, strict=True):
            if not _bits_equal(x[idle], y[idle]):
                raise AssertionError(f"stragglers sim {SAMPLED} round {r}: an idle "
                                     f"client's {f} changed")
        cohorts.append(cohort.tolist())
        states = {mode: o[0] for mode, o in outs.items()}
    launches = rs.regtopk_score.launches
    if launches != rounds:
        raise AssertionError(f"stragglers sim {SAMPLED}: {launches} score launches")
    row = {"rounds": rounds, "N": SAMPLED_N, "cohorts": cohorts,
           "launches": launches,
           "round": _round_ms(sims["on"], states["on"], table[:part.n_sampled])}
    log(f"stragglers sim {SAMPLED} (N = {SAMPLED_N}): fastpath on == off for "
        f"{rounds} rounds, only the cohort moved (= round_participants: "
        f"{cohorts}), idle clients bit-unchanged; round {row['round']['ms']:.2f} ms "
        f"(gradient fixed, host clock; {smi})")
    return row


def stragglers_sim(smi: str, rounds: int = 5, adaptive_rounds: int = 10,
                   cfg=None) -> dict:
    """Phase 10 (a): the simulator at full width (N = 8, J = 4,458,752,
    RegTop-k at S = 0.01, sparse_allgather, coo_fp32) under each straggler
    schedule and under the adaptive-k controller, fastpath on against off
    in bits; ``cfg`` replaces paper-resnet-proxy for a rehearsal on the
    CPU."""
    from repro_torch.comm import parse_adaptive_k, parse_participation
    from repro_torch.kernels import regtopk_score as rs

    grad_fn, theta0, J = _flat_model(cfg)
    g0 = grad_fn(theta0, torch.arange(W, device=DEVICE))
    kw = dict(aggregation="sparse_allgather")
    out, launches = {}, 0
    for spec in SIM_SCHEDULES:
        part = parse_participation(spec)
        rs.regtopk_score.launches = 0
        sims, states = _paired_sims(
            grad_fn, theta0, J, rounds, {**kw, "participation": part, "fastpath": "on"},
            {**kw, "participation": part, "fastpath": "off"},
            _sim_bits_check(f"stragglers sim {spec}"), spec)
        n = rs.regtopk_score.launches
        if n != rounds:
            raise AssertionError(f"stragglers sim {spec}: {n} score launches, "
                                 f"expected {rounds}")
        launches += n
        masks = [[int(x) for x in part.round_mask(r, W, DEVICE).tolist()]
                 for r in range(rounds)]
        out[spec] = {"rounds": rounds, "launches": n, "masks": masks,
                     "round": _round_ms(sims[0], states[0], g0)}
        stale = states[0].pending is not None
        pending = (f", {int((states[0].pending_age > 0).sum())} payloads pending"
                   if stale else "")
        log(f"stragglers sim {spec}: fastpath on == off for {rounds} rounds (theta, "
            f"g_agg, worker states{', pending' if stale else ''} bit-equal), {n} "
            f"score launches, masks {masks}{pending}; round "
            f"{out[spec]['round']['ms']:.2f} ms (gradient fixed, host clock; {smi})")
    out[SAMPLED] = _sampled_fleet(g0, theta0, J, rounds, smi)
    launches += out[SAMPLED]["launches"]

    ctrl, ks = parse_adaptive_k(SIM_ADAPTIVE), []
    check = _sim_bits_check("stragglers sim adaptive")

    def check_k(r, a, b):
        check(r, a, b)
        ks.append(int(a[0].ctrl.k))

    rs.regtopk_score.launches = 0
    sims, states = _paired_sims(
        grad_fn, theta0, J, adaptive_rounds, {**kw, "adaptive_k": ctrl, "fastpath": "on"},
        {**kw, "adaptive_k": ctrl, "fastpath": "off"}, check_k, "adaptive")
    n = rs.regtopk_score.launches
    if n != adaptive_rounds:
        raise AssertionError(f"stragglers sim adaptive: {n} score launches")
    launches += n
    lo, hi = ctrl.bounds(J)
    out["adaptive"] = {"rounds": adaptive_rounds, "launches": n, "k": ks,
                       "bounds": [lo, hi],
                       "err_ratio": float(states[0].ctrl.err_ratio),
                       "round": _round_ms(sims[0], states[0], g0)}
    log(f"stragglers sim adaptive ({SIM_ADAPTIVE}, k in [{lo}, {hi}], capacity "
        f"{hi}): fastpath on == off for {adaptive_rounds} rounds (theta, g_agg, "
        f"worker and controller states bit-equal), {n} score launches; k per "
        f"round {ks}, err_ratio {out['adaptive']['err_ratio']:.4f}; round "
        f"{out['adaptive']['round']['ms']:.2f} ms (gradient fixed, host clock; {smi})")
    out["launches"] = launches
    return out


def stragglers_trainer(smi: str, steps: int = WIRE_STEPS) -> dict:
    """Phase 10 (b): the trainer at full width, W = 8 on one card, under
    two straggler schedules and the adaptive-k controller, each with the
    fastpath on against off: params equal in bits, kernel 1's launches
    counted on the fused leaves, the certificate's hit rate, each leaf's
    k, and the bytes (measured per worker against the full round's
    prediction; the partial round's priced beside it)."""
    import dataclasses

    from repro_torch.core import distributed as td
    from repro_torch.tree import tree_items

    runs = {"round_robin:2": ["--participation", "round_robin:2"],
            "bernoulli:0.25": ["--participation", "bernoulli:0.25"],
            "adaptive": ["--adaptive-k", TRAIN_ADAPTIVE]}
    out, launches = {}, 0
    for name, extra in runs.items():
        args, on, row = _wire_train(f"{name} on", [*extra, "--fastpath", "on"], steps)
        _, off, row_off = _wire_train(f"{name} off", [*extra, "--fastpath", "off"],
                                      steps)
        if row["launches"] == 0 or row_off["launches"]:
            raise AssertionError(f"stragglers trainer {name}: kernel 1 launched "
                                 f"{row['launches']} times on, {row_off['launches']} off")
        bad = _mismatches(on.params, off.params)
        if bad:
            raise AssertionError(f"stragglers trainer {name}: params differ in {bad} "
                                 "elements between fastpath on and off")
        dist = _dist_of(args)
        partial, meas = td.comm_round_bytes(on.plan, dist, W)
        full, _ = td.comm_round_bytes(on.plan, dataclasses.replace(
            dist, participation=None), W)
        if meas > 1.05 * full:
            raise AssertionError(f"stragglers trainer {name}: measured {meas} B > "
                                 f"1.05 x the full round's {full} B")
        launches += row["launches"]
        ks = (None if args.adaptive_k is None else
              {path: int(c.k) for path, c in tree_items(on.sp_state[1])})
        row.update(off_losses=off.losses, predicted_bytes=full, measured_bytes=meas,
                   predicted_partial_bytes=partial, k=ks,
                   k_max={path: p.k for path, p in tree_items(on.plan)}
                   if ks else None)
        log(f"stragglers trainer {name}: {steps} steps, params bit-equal fastpath "
            f"on == off; {row['launches']} kernel 1 launches ({row['fused_leaves']} "
            f"fused leaves), hit rate {row['hit_rate']:.4f}; losses "
            f"{on.losses[0]:.4f} -> {on.losses[-1]:.4f}; measured {meas} B <= 1.05 x "
            f"the full round's {full} B per worker (the partial round priced at "
            f"{partial} B); {row['seconds'] / steps * 1e3:.1f} ms a step with the "
            f"run's setup (host clock; {smi})")
        if ks:
            log(f"stragglers trainer {name}: k per leaf after {steps} steps "
                + ", ".join(f"{p} {k}/{row['k_max'][p]}" for p, k in ks.items()))
        out[name] = row
    out["launches"] = launches
    return out


def phase_stragglers(smi: str) -> dict:
    return {"sim": stragglers_sim(smi), "trainer": stragglers_trainer(smi)}


# phase 11 (a): the simulator's planned runs. PLAN_TOPO is a slow outer
# axis over AlphaBeta()'s defaults: 10x alpha and 20x beta on (pod, data) =
# (2, 4), a slow inter-node link over a fast intra-node one
PLAN_TOPO = ((1e-4, 2e-10), (1e-5, 1e-11))
PLAN_SIM_RUNS = {
    "auto": {},
    "auto slow-outer": {"dp_shape": (2, 4), "topo": PLAN_TOPO},
    "auto slow-outer buckets:4": {"dp_shape": (2, 4), "topo": PLAN_TOPO,
                                  "overlap": "buckets:4"},
}


def _plan_sim_kw(spec: dict) -> dict:
    from repro_torch.comm import cost

    kw = dict(codec="auto", collective="auto", aggregation="sparse_allgather")
    if "topo" in spec:
        kw["link_topo"] = cost.LinkTopo(
            tuple(cost.AlphaBeta(*ab) for ab in spec["topo"]))
    kw.update({k: v for k, v in spec.items() if k in ("dp_shape", "overlap")})
    return kw


def planners_sim(smi: str, rounds: int = 5, cfg=None) -> dict:
    """Phase 11 (a): the simulator at full width (N = 8, J = 4,458,752,
    RegTop-k at S = 0.01) under ``codec="auto", collective="auto"``, on one
    dp axis under ``AlphaBeta()``, on (2, 4) under ``PLAN_TOPO``, and so
    with ``overlap="buckets:4"``; each run fastpath on against off in bits
    for ``rounds`` rounds, kernel 2 once a round, the resolved wire, the
    predicted round and the round timeline's sync and overlapped seconds;
    ``cfg`` replaces paper-resnet-proxy for a rehearsal on the CPU."""
    from repro_torch.kernels import regtopk_score as rs

    grad_fn, theta0, J = _flat_model(cfg)
    g0 = grad_fn(theta0, torch.arange(W, device=DEVICE))
    out, launches = {}, 0
    for name, spec in PLAN_SIM_RUNS.items():
        kw = _plan_sim_kw(spec)
        rs.regtopk_score.launches = 0
        sims, states = _paired_sims(
            grad_fn, theta0, J, rounds, {**kw, "fastpath": "on"},
            {**kw, "fastpath": "off"}, _sim_bits_check(f"planners sim {name}"), name)
        n = rs.regtopk_score.launches
        if n != rounds:
            raise AssertionError(f"planners sim {name}: {n} score launches, "
                                 f"expected {rounds}")
        launches += n
        wire = [(s.codec, s.resolved_collective) for s in sims]
        if wire[0] != wire[1]:
            raise AssertionError(f"planners sim {name}: on and off resolved {wire}")
        est = sims[0].wire_bytes_per_round()
        row = {"rounds": rounds, "launches": n, "wire": list(wire[0]),
               "bytes": est.bytes_on_wire, "messages": est.n_messages,
               "predicted_ms": 1e3 * est.seconds,
               "round": _round_ms(sims[0], states[0], g0)}
        timeline = ""
        if sims[0].overlap != "off":
            bplan, tl = sims[0].round_timeline()
            if not (bplan.n_buckets == 1 and tl.seconds <= tl.sync_seconds):
                raise AssertionError(f"planners sim {name}: timeline {tl}")
            row["timeline"] = {"buckets": bplan.n_buckets,
                               "sync_ms": 1e3 * tl.sync_seconds,
                               "overlapped_ms": 1e3 * tl.seconds}
            timeline = (f"; round_timeline {bplan.n_buckets} bucket (one leaf): "
                        f"{1e3 * tl.sync_seconds:.4f} ms sync -> "
                        f"{1e3 * tl.seconds:.4f} ms overlapped")
        log(f"planners sim {name}: resolved {wire[0][0]}/{wire[0][1]}, "
            f"{est.bytes_on_wire} B and {1e3 * est.seconds:.4f} ms per worker "
            f"per round predicted{timeline}; fastpath on == off for {rounds} "
            f"rounds (theta, g_agg, worker states bit-equal), {n} score "
            f"launches; round {row['round']['ms']:.2f} ms (gradient fixed, host "
            f"clock; {smi})")
        out[name] = row
    out["launches"] = launches
    return out


def _train_on_plan(args, dist, plan, steps: int):
    """``steps`` steps of a run of ``args`` from its start (train.run's
    weights, data and optimizer) on a given ``plan``: (params, state)."""
    from repro_torch.core import distributed as td
    from repro_torch.data import TokenPipeline
    from repro_torch.models import lm
    from repro_torch.optim import make_optimizer

    cfg = _model_cfg(args)
    params = lm.init(cfg, seed=0, device=args.device)
    step = td.make_train_step(cfg, dist, plan, args.workers)
    opt_state = make_optimizer(dist.optimizer).init(params)
    sp = td.init_sparsifier_state(plan, args.workers, args.device)
    pipe = TokenPipeline(cfg, args.global_batch, args.seq, 0, args.device)
    for t in range(steps):
        params, opt_state, sp, _ = step(params, opt_state, sp, pipe.batch_at(t))
    return params, sp


def _mismatches(a, b) -> int:
    """f32 bit mismatches between two parameter trees."""
    from repro_torch.tree import tree_items

    return sum(_bit_mismatches(x, y) for (_, x), (_, y) in zip(
        tree_items(a), tree_items(b), strict=True))


def _bucket_profile(args, res) -> dict:
    """One step of run ``res`` (of ``args``, under ``--overlap``) under
    torch.profiler: each ``spa_bucketNNN`` range's host and device time,
    and the step's host-clock time (median of 3)."""
    from repro_torch.core import distributed as td
    from repro_torch.data import TokenPipeline
    from repro_torch.optim import make_optimizer

    cfg, dist = _model_cfg(args), _dist_of(args)
    step = td.make_train_step(cfg, dist, res.plan, W)
    opt_state = make_optimizer(dist.optimizer).init(res.params)
    batch = TokenPipeline(cfg, args.global_batch, args.seq, 1, DEVICE).batch_at(0)
    _, step_ms = _timed_step(lambda p, s, b: step(p, opt_state, s, b),
                             res.params, res.sp_state, batch)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        step(res.params, opt_state, res.sp_state, batch)
        torch.cuda.synchronize()
    # the host-side ranges: their host time, and the device time of the
    # kernels launched inside them
    ranges = {ev.key: {"host_ms": ev.cpu_time_total / 1e3,
                       "device_ms": ev.device_time_total / 1e3}
              for ev in prof.key_averages()
              if ev.key.startswith("spa_bucket")
              and ev.device_type == torch.autograd.DeviceType.CPU}
    return {"step_ms": step_ms, "ranges": dict(sorted(ranges.items()))}


def planners_trainer(smi: str, steps: int = WIRE_STEPS) -> dict:
    """Phase 11 (b): the trainer at full width, W = 8 on one card, under
    ``--codec auto --collective auto``: with the fastpath on (the per-leaf
    picks printed; kernel 1 on the plan's fused leaves), against the same
    plan with the fastpath off and against auto with the fastpath off (a
    plan of its own), each with params equal in bits; ``--overlap
    buckets:4`` against off, params equal in bits, and one profiled step's
    ``spa_bucketNNN`` ranges; ``--calibrate``, which skips in one
    process."""
    import contextlib
    import io

    from repro_torch.core import distributed as td
    from repro_torch.launch import train
    from repro_torch.tree import tree_items, tree_map

    out = {}
    args, on, row = _wire_train("auto", [*PLAN_AUTO, "--fastpath", "on"], steps)
    if row["launches"] == 0:
        raise AssertionError("planners trainer auto: kernel 1 never launched")
    picks = {path: [p.codec, p.collective, p.fused] for path, p in tree_items(on.plan)}
    log("planners trainer auto (fastpath on) picks: " + "; ".join(
        f"{path} {c}/{s}{' fused' if f else ''}" for path, (c, s, f) in picks.items()))
    same_plan = tree_map(lambda p: p._replace(fused=False), on.plan)
    params_off, sp_off = _train_on_plan(args, _dist_of(args, fastpath="off"),
                                        same_plan, steps)
    bad = _mismatches(on.params, params_off)
    for (path, a), (_, b) in zip(tree_items(on.sp_state), tree_items(sp_off),
                                 strict=True):
        if not (_bits_equal(a.sent_vals, b.sent_vals)
                and torch.equal(a.sent_idx, b.sent_idx)):
            raise AssertionError(f"planners trainer auto: {path} payload differs "
                                 "between fastpath on and off on one plan")
    _, off, row_off = _wire_train("auto off", [*PLAN_AUTO, "--fastpath", "off"], steps)
    off_picks = {path: [p.codec, p.collective, p.fused]
                 for path, p in tree_items(off.plan)}
    bad_off = _mismatches(on.params, off.params)
    if bad or bad_off or row_off["launches"]:
        raise AssertionError(f"planners trainer auto: params differ from the same "
                             f"plan's fastpath off in {bad} elements, from auto "
                             f"off's in {bad_off}; {row_off['launches']} launches off")
    log(f"planners trainer auto: {steps} steps, {row['launches']} kernel 1 launches "
        f"({row['fused_leaves']} fused leaves), hit rate {row['hit_rate']:.4f}; "
        "params and payloads bit-equal to the same plan with the fastpath off; "
        "params bit-equal to auto with the fastpath off, whose plan differs in "
        f"{sum(off_picks[p][:2] != v[:2] for p, v in picks.items())} leaves' "
        f"codec or collective ({smi})")
    row.update(picks=picks, off_picks=off_picks, off_losses=off.losses)
    out["auto"] = row

    args_ov, ov, row_ov = _wire_train(
        "auto buckets:4", [*PLAN_AUTO, "--fastpath", "on", "--overlap", "buckets:4"],
        steps)
    bad = _mismatches(on.params, ov.params)
    if bad or row_ov["launches"] != row["launches"]:
        raise AssertionError(f"planners trainer buckets:4: params differ from off in "
                             f"{bad} elements; {row_ov['launches']} launches")
    bplan, tl = td.comm_round_timeline(ov.plan, _dist_of(args_ov), W)
    prof = _bucket_profile(args_ov, ov)
    want = [f"spa_bucket{i:03d}" for i in range(bplan.n_buckets)]
    if list(prof["ranges"]) != want:
        raise AssertionError(f"planners trainer buckets:4: profiled ranges "
                             f"{list(prof['ranges'])}, expected {want}")
    row_ov.update(buckets=[list(b.leaves) for b in bplan.buckets],
                  sync_ms=1e3 * tl.sync_seconds, overlapped_ms=1e3 * tl.seconds,
                  profile=prof,
                  on_step_ms=_bucket_profile(args, on)["step_ms"])
    log(f"planners trainer buckets:4: params bit-equal to overlap off; buckets "
        f"{row_ov['buckets']}, predicted {row_ov['sync_ms']:.4f} ms sync -> "
        f"{row_ov['overlapped_ms']:.4f} ms overlapped; profiled step "
        + ", ".join(f"{k} {v['host_ms']:.2f} ms host / {v['device_ms']:.2f} ms "
                    "device" for k, v in prof["ranges"].items())
        + f"; step {prof['step_ms']:.1f} ms, {row_ov['on_step_ms']:.1f} ms "
        f"without buckets (host clock; {smi})")
    out["overlap"] = row_ov

    base = [a for a in TRAIN_ARGS if a not in ("--fastpath", "on")]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.run(train.parse_args([*base, "--steps", "1", "--calibrate"]))
    skipped = [ln for ln in buf.getvalue().splitlines() if "calibrat" in ln]
    if skipped != ["calibration skipped (one process: no process group, so no "
                   "wire to probe); using defaults"]:
        raise AssertionError(f"planners trainer --calibrate: {skipped}")
    log(f"planners trainer --calibrate, one process: {skipped[0]}")
    out["calibrate"] = skipped[0]
    out["launches"] = row["launches"] + row_ov["launches"]
    return out


def phase_planners(smi: str) -> dict:
    return {"sim": planners_sim(smi), "trainer": planners_trainer(smi)}


# phase 12: the trainer's remaining options (microbatches, checkpoint and
# resume, bf16 state, the optimizers, aggregation), each run at full width
# (W = 8, batch 32 x 128, RegTop-k at S = 0.01) held in bits against its
# twin
OPT_STEPS = 5
OPT_OPTIMIZERS = {
    "sgd": dict(kind="sgd", learning_rate=0.05),
    "momentum": dict(kind="momentum", learning_rate=0.02, momentum=0.9,
                     weight_decay=0.1, grad_clip=1.0, warmup_steps=3),
    "adam": dict(kind="adam", learning_rate=1e-3, weight_decay=0.01,
                 grad_clip=1.0, warmup_steps=3, moment_dtype="bfloat16"),
}


def _states_equal(a, b) -> bool:
    """Two sparsifier states (a ``CompactState`` tree, or the pair with the
    controller tree) equal in every field's bits."""
    from repro_torch.tree import tree_leaves

    if isinstance(a, tuple):
        return _states_equal(a[0], b[0]) and all(
            _bits_equal(x, y) for ca, cb in zip(tree_leaves(a[1]), tree_leaves(b[1]),
                                                strict=True)
            for x, y in zip(ca, cb, strict=True))
    return all(_bits_equal(x, y) for sa, sb in zip(tree_leaves(a), tree_leaves(b),
                                                   strict=True)
               for x, y in zip(sa, sb, strict=True))


def _same_run(name: str, got, want, got_losses=None, want_losses=None) -> None:
    """Raise unless two runs end with the same params and sparsifier state
    in bits, and log the same losses (``got_losses``/``want_losses`` when
    given, else each run's)."""
    bad = _mismatches(got.params, want.params)
    if bad or not _states_equal(got.sp_state, want.sp_state):
        raise AssertionError(f"options {name}: params differ in {bad} elements "
                             "or the sparsifier states differ")
    gl = got.losses if got_losses is None else got_losses
    wl = want.losses if want_losses is None else want_losses
    if gl != wl:
        raise AssertionError(f"options {name}: losses {gl} vs {wl}")


def _state_bytes(sp_state) -> int:
    from repro_torch.tree import tree_leaves

    return sum(x.numel() * x.element_size() for st in tree_leaves(sp_state)
               for x in st)


def _on_off(name: str, extra: list, fields=None, steps: int = OPT_STEPS):
    """A run with the fastpath on against the same run off, in bits;
    returns (args, the on run, its row, the off run)."""
    args, on, row = _wire_train(f"{name} on", [*extra, "--fastpath", "on"], steps,
                                fields=fields)
    _, off, row_off = _wire_train(f"{name} off", [*extra, "--fastpath", "off"],
                                  steps, fields=fields)
    if row["launches"] == 0 or row_off["launches"]:
        raise AssertionError(f"options {name}: kernel 1 launched {row['launches']} "
                             f"times on, {row_off['launches']} off")
    _same_run(name, on, off)
    return args, on, row, off


def options_resume(ckpt_dir, steps: int = OPT_STEPS) -> dict:
    """Phase 12 (b): ``steps`` steps with ``--checkpoint``, then ``steps``
    with ``--resume``, against the unbroken ``2 x steps`` run, in bits;
    with the fastpath on, once more under ``--participation
    bernoulli:0.25 --adaptive-k``, and from the checkpoint phase 9's 8
    gloo ranks wrote after ``steps`` steps (``ckpt_dir``), resumed with
    ``--workers 8`` on the card. Returns (the results, the unbroken run
    with the fastpath on)."""
    out, launches = {}, 0
    runs = {"fastpath_on": [],
            "bernoulli_adaptive": ["--participation", "bernoulli:0.25",
                                   "--adaptive-k", TRAIN_ADAPTIVE]}
    with tempfile.TemporaryDirectory() as d:
        for name, extra in runs.items():
            flags = [*extra, "--fastpath", "on"]
            _, whole, row_whole = _wire_train(f"resume {name} whole", flags, 2 * steps)
            _, first, row_first = _wire_train(f"resume {name} first", [
                *flags, "--checkpoint", f"{d}/{name}"], steps)
            _, rest, row_rest = _wire_train(f"resume {name} resumed", [
                *flags, "--resume", f"{d}/{name}"], steps)
            _same_run(f"resume {name}", rest, whole, first.losses + rest.losses)
            n = row_whole["launches"] + row_first["launches"] + row_rest["launches"]
            launches += n
            out[name] = {"losses": whole.losses, "launches": n,
                         "seconds": {"whole": row_whole["seconds"],
                                     "first": row_first["seconds"],
                                     "resumed": row_rest["seconds"]}}
            log(f"options resume {name}: {steps} steps, --checkpoint, {steps} steps "
                f"--resume == {2 * steps} unbroken steps in bits (params, every "
                f"state field, losses); {n} kernel 1 launches")
            if name == "fastpath_on":
                unbroken = whole
    if ckpt_dir is not None:
        _, ranks, row = _wire_train("resume ranks", [
            "--fastpath", "on", "--resume", ckpt_dir], steps)
        _same_run("resume ranks", ranks, unbroken, want_losses=unbroken.losses[steps:])
        launches += row["launches"]
        out["ranks"] = {"losses": ranks.losses, "launches": row["launches"]}
        log(f"options resume ranks: the checkpoint of phase 9's {W} gloo ranks "
            f"after {steps} steps, resumed on one card with --workers {W} for "
            f"{steps} steps == the unbroken one-card run in bits; "
            f"{row['launches']} kernel 1 launches")
    out["launches"] = launches
    return out, unbroken


def phase_options(smi: str, ckpt_dir=None) -> dict:
    """Phase 12: the trainer's remaining options at full width (see the
    module docstring), each held in bits against its twin; kernel 1's
    launches counted over the fastpath-on runs."""
    import dataclasses

    from repro_torch.core import distributed as td
    from repro_torch.launch import train
    from repro_torch.optim import OptConfig
    from repro_torch.tree import tree_leaves, tree_map

    out, launches, t0 = {}, 0, time.perf_counter()
    # (a) microbatches: the gradient accumulated over 2 chunks per worker
    args, on, row, _ = _on_off("microbatches 2", ["--microbatches", "2"])
    launches += row["launches"]
    out["microbatches"] = {"losses": on.losses, "launches": row["launches"],
                           "step_ms": row["seconds"] / OPT_STEPS * 1e3,
                           "hit_rate": row["hit_rate"]}
    log(f"options microbatches 2: {OPT_STEPS} steps, params and state bit-equal "
        f"fastpath on == off; {row['launches']} kernel 1 launches "
        f"({row['fused_leaves']} fused leaves); {out['microbatches']['step_ms']:.1f} "
        f"ms a step with the run's setup (host clock; {smi})")
    f32_bytes = _state_bytes(on.sp_state)

    # (b) checkpoint and resume
    out["resume"], unbroken = options_resume(ckpt_dir)
    launches += out["resume"]["launches"]

    # (c) bf16 state: auto fuses no leaf, on raises
    args_c, bf16, row_c = _wire_train("bf16 state auto", ["--fastpath", "auto"],
                                      OPT_STEPS, fields={"state_dtype": "bfloat16"})
    if row_c["fused_leaves"] or row_c["launches"]:
        raise AssertionError(f"options bf16: {row_c['fused_leaves']} fused leaves, "
                             f"{row_c['launches']} launches under auto")
    if any(st.eps.dtype != torch.bfloat16 for st in tree_leaves(bf16.sp_state)):
        raise AssertionError("options bf16: the state is not bf16")
    try:
        train.run(args_c, dist=_dist_of(args_c, state_dtype="bfloat16", fastpath="on"))
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("options bf16: fastpath on did not raise")
    if "requires state_dtype='float32'" not in refused:
        raise AssertionError(f"options bf16: fastpath on raised {refused!r}")
    dist_c = _dist_of(args_c, state_dtype="bfloat16")
    bf16_ms, bf16_prof = _step_ms(args_c, bf16, dcfg=dist_c)
    # the f32 twin of that step: the unbroken run of (b), unfused
    f32_ms, f32_prof = _step_ms(args_c, unbroken._replace(plan=tree_map(
        lambda p: p._replace(fused=False), unbroken.plan)),
        dcfg=dataclasses.replace(dist_c, state_dtype="float32"))
    out["bf16_state"] = {
        "losses": bf16.losses, "state_bytes": _state_bytes(bf16.sp_state),
        "f32_state_bytes": f32_bytes, "step_ms": bf16_ms, "f32_step_ms": f32_ms,
        "device_ms": bf16_prof["device_ms"], "f32_device_ms": f32_prof["device_ms"],
        "refused": refused, "comm_bytes": td.comm_round_bytes(bf16.plan, dist_c, W)}
    log(f"options bf16 state: {OPT_STEPS} steps, --fastpath auto fused 0 leaves, "
        f"on raised ({refused[:60]}...); state {out['bf16_state']['state_bytes']} B "
        f"against {f32_bytes} B in f32; step {bf16_ms:.1f} ms against {f32_ms:.1f} "
        f"ms in f32 unfused (host clock, median of 3), device {bf16_prof['device_ms']:.2f}"
        f" against {f32_prof['device_ms']:.2f} ms ({smi})")

    # (d) the optimizers, fastpath on == off
    out["optimizers"] = {}
    for name, kw in OPT_OPTIMIZERS.items():
        fields = {"optimizer": OptConfig(**kw)}
        _, res, row, _ = _on_off(f"optimizer {name}", [], fields)
        launches += row["launches"]
        out["optimizers"][name] = {"losses": res.losses, "launches": row["launches"],
                                   "step_ms": row["seconds"] / OPT_STEPS * 1e3}
        log(f"options optimizer {name} {kw}: {OPT_STEPS} steps, params and state "
            f"bit-equal fastpath on == off; {row['launches']} kernel 1 launches; "
            f"losses {res.losses[0]:.4f} -> {res.losses[-1]:.4f}")

    # (e) --aggregation is --collective's older name
    _, agg, _ = _wire_train("aggregation", ["--aggregation", "dense_allreduce"])
    _, coll, _ = _wire_train("collective", ["--collective", "dense_allreduce"])
    if agg.dist.resolved_collective() != "dense_allreduce":
        raise AssertionError(f"options aggregation: {agg.dist.resolved_collective()}")
    _same_run("aggregation", agg, coll)
    log("options --aggregation dense_allreduce == --collective dense_allreduce in "
        "bits")
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    log(f"options: phase 12 took {out['seconds']:.1f} s, {launches} kernel 1 launches")
    return out


# phase 13: the model families at published widths. Each run: the layers
# it runs (None: all, through train.run's flags; else build_plan and
# make_train_step on the depth-cut config), W, the global batch and the
# sequence (FAMILY_SEQ unless given). The depth is cut where the card's
# 80 GB forces it, and internvl2-1b's and mamba2-780m's to half for the
# script's time limit (whole through train.run's flags until phase 15
# (c) trained zamba2-7b: 24 and 48 layers, 51.42 and 74.48 GB peaks).
FAMILY_STEPS = 3
FAMILY_SEQ = 512
FAMILY_RUNS = {
    "internvl2-1b": dict(layers=12, workers=4, batch=8),
    "qwen2.5-3b": dict(layers=6, workers=2, batch=4),
    "deepseek-moe-16b": dict(layers=1, workers=2, batch=4),
    # Whisper's text context: 448 decoder tokens over 1500 encoder frames
    "whisper-tiny": dict(layers=None, workers=8, batch=16, seq=448),
    "mamba2-780m": dict(layers=24, workers=2, batch=4),
    # one group (five mamba blocks and the shared attention block), then
    # two trailing blocks
    "zamba2-7b": dict(layers=8, workers=2, batch=4),
}
# the smoke variants held on the card against the CPU: one config per
# family, and mixtral-8x7b (sliding windows, MoE without shared experts)
FAMILY_SMOKE = ("qwen2.5-3b", "deepseek-moe-16b", "internvl2-1b", "mixtral-8x7b",
                "whisper-tiny", "mamba2-780m", "zamba2-7b")
FAMILY_SPARSITY = 0.01
FAMILY_LR = 1e-3


def _reckoned_bytes(params, workers: int) -> int:
    """The peak the trainer's state should reach: params, Adam's two
    moments, the aggregate and W errors, W gradients and one stacked leaf
    (about 16 + 8 W bytes a parameter; the next step's state beside this
    one's, another 12 + 4 W), and about 32 W bytes per element of the
    largest leaf for its round (a, the score, the sort's keys, int64
    indices and scratch)."""
    from repro_torch.tree import tree_leaves

    n = sum(x.numel() for x in tree_leaves(params))
    big = max(x.numel() for x in tree_leaves(params))
    return (28 + 12 * workers) * n + 32 * workers * big


def _family_train(arch: str, run: dict):
    """``FAMILY_STEPS`` training steps of ``arch`` at its published widths
    on the card, RegTop-k at S = 0.01 with the fastpath on: through
    ``train.run``'s flags at full depth, else through ``build_plan`` and
    ``make_train_step`` on the depth-cut config. Returns (config, params,
    optimizer state, sparsifier state, plan, losses, counts, launches,
    seconds, peak bytes)."""
    from repro_torch import configs
    from repro_torch.comm.fastpath import FastpathCounts
    from repro_torch.core import distributed as td
    from repro_torch.core.sparsify import SparsifierConfig
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import fused_encode as fe
    from repro_torch.launch import train
    from repro_torch.models import get_family
    from repro_torch.optim import OptConfig, make_optimizer

    W, B, S = run["workers"], run["batch"], run.get("seq", FAMILY_SEQ)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fe.fused_candidates.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if run["layers"] is None:
        args = train.parse_args([
            "--arch", arch, "--workers", str(W), "--global-batch", str(B),
            "--seq", str(S), "--steps", str(FAMILY_STEPS),
            "--sparsifier", "regtopk", "--sparsity", str(FAMILY_SPARSITY),
            "--lr", str(FAMILY_LR), "--fastpath", "on", "--log-every", "1",
            "--device", DEVICE])
        res = train.run(args)
        cfg = configs.get_config(arch)
        params, opt_state, sp, plan = res.params, res.opt_state, res.sp_state, res.plan
        losses, counts = res.losses, res.counts
    else:
        cfg = configs.get_config(arch).replace(n_layers=run["layers"])
        dist = td.DistConfig(
            sparsifier=SparsifierConfig(kind="regtopk", sparsity=FAMILY_SPARSITY),
            optimizer=OptConfig(kind="adam", learning_rate=FAMILY_LR),
            fastpath="on")
        params = get_family(cfg).init(cfg, seed=0, device=DEVICE)
        plan = td.build_plan(params, FAMILY_SPARSITY, dist)
        counts = FastpathCounts()
        step = td.make_train_step(cfg, dist, plan, W, counts)
        opt_state = make_optimizer(dist.optimizer).init(params)
        sp = td.init_sparsifier_state(plan, W, DEVICE)
        pipe = TokenPipeline(cfg, B, S, 0, DEVICE)
        losses = []
        for t in range(FAMILY_STEPS):
            params, opt_state, sp, m = step(params, opt_state, sp, pipe.batch_at(t))
            losses.append(float(m["loss"]))
            log(f"families {arch}: step {t} loss {losses[-1]:.4f}")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return (cfg, params, opt_state, sp, plan, losses, counts,
            fe.fused_candidates.launches, seconds, torch.cuda.max_memory_allocated())


def _family_on_off(cfg, params, opt_state, sp, W: int, B: int, S: int,
                   smi: str):
    """One more step from the trained state with the fastpath on and off:
    the payload indices and values of every leaf in bits (each step's
    outputs dropped but the payloads, so the card holds one step's state
    at a time); then the step time on and off in turns (host clock,
    median of 3) and one profiled fastpath-on step."""
    from repro_torch.core import distributed as td
    from repro_torch.core.sparsify import SparsifierConfig
    from repro_torch.data import TokenPipeline
    from repro_torch.optim import OptConfig
    from repro_torch.tree import tree_items

    batch = TokenPipeline(cfg, B, S, 1, DEVICE).batch_at(0)
    stage_s, t_stage = {}, time.perf_counter()
    steps, sent = {}, {}
    for mode in ("on", "off"):
        dist = td.DistConfig(
            sparsifier=SparsifierConfig(kind="regtopk", sparsity=FAMILY_SPARSITY),
            optimizer=OptConfig(kind="adam", learning_rate=FAMILY_LR),
            fastpath=mode)
        plan = td.build_plan(params, FAMILY_SPARSITY, dist)
        steps[mode] = td.make_train_step(cfg, dist, plan, W)
        new_sp = steps[mode](params, opt_state, sp, batch)[2]
        sent[mode] = [(path, st.sent_idx, st.sent_vals)
                      for path, st in tree_items(new_sp)]
        del new_sp
    for (path, i_on, v_on), (_, i_off, v_off) in zip(sent["on"], sent["off"],
                                                     strict=True):
        if not (torch.equal(i_on, i_off) and _bits_equal(v_on, v_off)):
            raise AssertionError(f"families {cfg.name}: {path}: fastpath on/off "
                                 "payloads differ")
    del sent
    stage_s["check"] = time.perf_counter() - t_stage

    def run(mode):
        steps[mode](params, opt_state, sp, batch)

    t_stage = time.perf_counter()
    times = {"on": [], "off": []}
    for _ in range(3):
        for mode in ("on", "off"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(mode)
            torch.cuda.synchronize()
            times[mode].append(1e3 * (time.perf_counter() - t0))
    step_ms = {mode: statistics.median(ts) for mode, ts in times.items()}
    stage_s["timing"] = time.perf_counter() - t_stage
    t_stage = time.perf_counter()
    prof = profile_step(lambda: run("on"), step_ms["on"])
    stage_s["profile"] = time.perf_counter() - t_stage
    log(f"families {cfg.name}: one step from the trained state, fastpath on == "
        f"off (payload indices and values bit-equal); step {step_ms['on']:.1f} ms "
        f"on, {step_ms['off']:.1f} ms off (host clock, median of 3; {smi}); "
        f"stages {json.dumps({k: round(v, 1) for k, v in stage_s.items()})} s")
    return {"step_ms": step_ms, "samples_ms": times, "profile": prof,
            "stage_seconds": stage_s}


def families_smoke() -> dict:
    """Each of ``FAMILY_SMOKE``'s smoke variants, W = 2, 3 steps with the
    fastpath on, on the card against the same run on the CPU (the plain
    kernel versions): losses within 1e-4 relative (float32 matmuls sum in
    another order there)."""
    from repro_torch.launch import train

    out = {}
    for arch in FAMILY_SMOKE:
        small = ["--arch", arch, "--smoke", "--workers", "2", "--steps", "3",
                 "--seq", "32", "--fastpath", "on", "--log-every", "100"]
        gpu = train.run(train.parse_args([*small, "--device", DEVICE])).losses
        cpu = train.run(train.parse_args([*small, "--device", "cpu"])).losses
        for g, c in zip(gpu, cpu, strict=True):
            if not abs(g - c) <= 1e-4 * abs(c):
                raise AssertionError(f"families {arch} smoke: card losses {gpu} "
                                     f"vs CPU losses {cpu}")
        log(f"families {arch} smoke: the card matches the CPU ({gpu} vs {cpu})")
        out[arch] = {"card": gpu, "cpu": cpu}
    return out


def phase_families(smi: str) -> dict:
    """Phase 13: the model families at published widths (see the module
    docstring), kernel 1's launches counted over the training runs."""
    from repro_torch.tree import tree_leaves

    out, launches, t_phase = {}, 0, time.perf_counter()
    for arch, run in FAMILY_RUNS.items():
        W, B, S = run["workers"], run["batch"], run.get("seq", FAMILY_SEQ)
        (cfg, params, opt_state, sp, plan, losses, counts, n, seconds,
         peak) = _family_train(arch, run)
        if len(losses) != FAMILY_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"families {arch}: losses {losses}")
        n_fused = sum(p.fused for p in tree_leaves(plan))
        if n != FAMILY_STEPS * n_fused or n == 0:
            raise AssertionError(f"families {arch}: {n} kernel 1 launches, expected "
                                 f"{FAMILY_STEPS} steps x {n_fused} fused leaves")
        launches += n
        n_params = sum(x.numel() for x in tree_leaves(params))
        largest = max(x.numel() for x in tree_leaves(params))
        reckoned = _reckoned_bytes(params, W)
        depth = ("all" if run["layers"] is None else
                 f"{run['layers']} of {_full_layers(arch)}")
        extra = (f" (+{cfg.n_patches} patches)" if cfg.family == "vlm" else
                 f" (over {cfg.enc_seq} encoder frames)"
                 if cfg.family == "encdec" else "")
        log(f"families {arch}: {depth} layers, W = {W}, batch {B} x {S}{extra}; "
            f"{n_params:,} parameters, largest leaf {largest:,}; {FAMILY_STEPS} "
            f"steps in {seconds:.2f} s, losses {losses[0]:.4f} -> {losses[-1]:.4f}; "
            f"{n} kernel 1 launches ({n_fused}/{len(tree_leaves(plan))} leaves "
            f"fused), certificate hit rate {counts.hit_rate:.4f} "
            f"({counts.rounds - counts.fallbacks}/{counts.rounds}); peak "
            f"{peak / 1e9:.2f} GB allocated (reckoned {reckoned / 1e9:.2f} GB)")
        row = {"layers": cfg.n_layers, "full_layers": _full_layers(arch),
               "workers": W, "batch": B, "seq": S, "losses": losses,
               "launches": n, "fused_leaves": n_fused,
               "leaves": len(tree_leaves(plan)), "hit_rate": counts.hit_rate,
               "rounds": counts.rounds, "fallbacks": counts.fallbacks,
               "seconds": seconds, "params": n_params, "largest_leaf": largest,
               "peak_bytes": peak, "reckoned_bytes": reckoned}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        row.update(_family_on_off(cfg, params, opt_state, sp, W, B, S, smi))
        row["check_peak_bytes"] = torch.cuda.max_memory_allocated()
        out[arch] = row
        del params, opt_state, sp, plan
        torch.cuda.empty_cache()
    out["smoke"] = families_smoke()
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    log(f"families: phase 13 took {out['seconds']:.1f} s, {launches} kernel 1 "
        "launches")
    return out


# phase 14: serving models at published widths. Each run: the serve
# loop's batch and max_len, and its depth where the host's weight draw
# (~10 ns a float from one generator) is cut to keep the script inside
# its time limit.
SERVE_RUNS = {
    # 9 of 36 layers (the whole model's draw took 30.7 s, 18 layers' 14.8)
    "qwen2.5-3b": dict(batch=8, max_len=2048, layers=9),
    # 15 of 81 layers: two groups of five mamba blocks and the shared
    # block, then the three trailing blocks (27 until phase 15 (c) served;
    # the whole model's host init took 48.8 s)
    "zamba2-7b": dict(batch=8, max_len=2048, layers=15),
    # 24 of 48 layers (the whole model's host init took 7.0 s)
    "mamba2-780m": dict(batch=8, max_len=2048, layers=24),
    # Whisper's text context over its 1500 encoder frames
    "whisper-tiny": dict(batch=8, max_len=448),
    # 1 of 28 layers: the whole model's host init (16.7 billion draws from
    # one generator, ~160 s) takes longer than the rest of the phase (2
    # layers' 12.0 s)
    "deepseek-moe-16b": dict(batch=4, max_len=1024, layers=1),
}
SERVE_PREFILL = (2, 1536)  # two KV blocks of 1024, the last one padded
SERVE_FORCED = 32  # teacher-forced decode steps held against forward
SERVE_PROMPT, SERVE_NEW = 8, 64
SERVE_TOL = 2e-3  # tests/test_archs.py's decode-vs-forward tolerance
SERVE_SMOKE_TOL = 1e-4
# The largest gap between the reference router's k-th and (k+1)-th
# probabilities at which two computations may choose other experts
ROUTE_TIE = 1e-5


def _all_launches() -> dict:
    from repro_torch.kernels import block_topk, fused_encode, regtopk_score
    from repro_torch.kernels import threshold_topk

    return {fn.__name__: fn.launches for fn in (
        fused_encode.fused_candidates, regtopk_score.regtopk_score,
        threshold_topk.count_above, threshold_topk.global_max,
        block_topk.block_topk_candidates)}


def _tree_bytes(tree) -> int:
    from repro_torch.tree import tree_leaves

    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def _decoder_bytes(params, cfg) -> int:
    """The weights a decode step reads: all but the encoder's."""
    from repro_torch.tree import tree_items

    return sum(x.numel() * x.element_size() for path, x in tree_items(params)
               if not (cfg.family == "encdec" and path.startswith("enc_")))


def _leaves_with_axes(tree: dict, axes: dict):
    """``(leaf, its cache_axes entry)`` of a cache tree."""
    for name, x in tree.items():
        if isinstance(x, dict):
            yield from _leaves_with_axes(x, axes[name])
        else:
            yield x, axes[name]


def _cache_bytes_needed(mod, cfg, batch: int, max_len: int, positions) -> float:
    """The cache bytes a decode step moves, the mean over steps at
    ``positions``: a self-attention cache's filled slots (``kv_seq``; the
    new key among them, written), a cross cache (``enc_seq``) read, and a
    recurrent state (the SSM's conv window and state, ``pos``) read and
    written."""
    cache = mod.init_cache(cfg, batch, max_len, device="meta")
    total = 0.0
    for x, ax in _leaves_with_axes(cache, mod.cache_axes(cfg)):
        nbytes = x.numel() * x.element_size()
        if "kv_seq" in ax:
            slots = x.shape[ax.index("kv_seq")]
            total += nbytes / slots * statistics.mean(min(p + 1, slots)
                                                      for p in positions)
        elif "enc_seq" in ax:
            total += nbytes
        else:
            total += 2 * nbytes
    return total


def _unrouted_bytes(mod, cfg, params, res, batch: int, max_len: int) -> tuple:
    """The routed experts' weights that ``serve.run``'s timed steps
    (``res``) do not need: the mean over those steps of the experts that
    no token routes to, a layer's each, times an expert's bytes (its
    ``wg``, ``wu`` and ``wd``); and the mean experts routed to, a layer a
    step. The routing is the served sequence's, teacher-forced again."""
    seq = torch.cat([res.first, res.prompt, res.tokens], 1)
    n, L = SERVE_PROMPT + SERVE_NEW, cfg.n_layers
    with torch.inference_mode():
        cache = _serve_cache(mod, cfg, params, batch, max_len, None, DEVICE)
        with _Routes() as rr:
            _forced(mod, cfg, params, cache, seq[:, :n].to(DEVICE))
        del cache
    chosen = (_per_layer(rr.maps, n * L, batch).reshape(n, L, batch, -1) > 0
              ).any(2)[SERVE_PROMPT:]  # [timed steps, layers, experts]
    mlp = params["layers"]["mlp"]
    expert = sum(mlp[w][0, 0].numel() * mlp[w].element_size()
                 for w in ("wg", "wu", "wd"))
    return (expert * (~chosen).sum((1, 2)).double().mean().item(),
            chosen.sum(-1).double().mean().item())


def _serve_cache(mod, cfg, params, batch: int, max_len: int, frames, device):
    """``init_cache``, with ``build_cross_cache`` of ``frames`` for encdec."""
    cache = mod.init_cache(cfg, batch, max_len, device=device)
    if cfg.family == "encdec":
        cache["ck"], cache["cv"] = mod.build_cross_cache(params, cfg, frames)
    return cache


def _forced(mod, cfg, params, cache, tokens: torch.Tensor, **kw) -> torch.Tensor:
    """The logits ``[B, T, V]`` of T decode steps fed ``tokens [B, T]``
    (``kw``: the serving shard), the cache's tensors written in place."""
    out = []
    for t in range(tokens.shape[1]):
        logits, cache = mod.decode_step(params, cfg, cache, tokens[:, t:t + 1],
                                        **kw)
        out.append(logits[:, 0])
    return torch.stack(out, 1)


def _close_to(got: torch.Tensor, want: torch.Tensor, tol: float, label: str) -> float:
    """rtol = atol = ``tol``; returns the largest absolute difference."""
    diff = (got - want).abs()
    if not bool((diff <= tol + tol * want.abs()).all()):
        raise AssertionError(f"{label}: beyond rtol = atol = {tol} "
                             f"(max abs diff {diff.max().item():.3e})")
    return diff.max().item()


class _Routes:
    """While active, each MoE routing (``nn.moe.route``) recorded as a
    ``[tokens, experts]`` map: 0 not chosen, 1 chosen and dropped, 2
    chosen and kept; and the router's probabilities it chose from."""

    def __init__(self):
        self.maps, self.probs = [], []

    def __enter__(self):
        from repro_torch.nn import moe

        self._moe, self._route = moe, moe.route

        def route(probs, top_k, cap):
            out = self._route(probs, top_k, cap)
            _, idx, _, keep = out
            self.maps.append(torch.zeros(probs.shape, dtype=torch.int8,
                                         device=probs.device).scatter_(
                1, idx, 1 + keep.to(torch.int8)))
            self.probs.append(probs.float())
            return out

        moe.route = route
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route


def _per_layer(maps: list, layers: int, tokens: int) -> torch.Tensor:
    """One run's routing maps (or probabilities) as ``[layers, tokens,
    experts]``: a layer's groups come one after another, the last one
    padded."""
    cat = torch.cat(maps)
    return cat.reshape(layers, -1, cat.shape[-1])[:, :tokens]


def _route_flips(a: torch.Tensor, b: torch.Tensor, probs: torch.Tensor,
                 top_k: int, label: str, tie: float = ROUTE_TIE) -> tuple:
    """Per row, the first position whose routing differs in any layer
    between two runs' maps ``[layers, rows, positions, experts]`` (the
    position count where none does), and the top-k gaps there. A flip
    is excused only as a near-tie: at the lowest layer that differs, the
    two runs choose different experts and the reference run's k-th and
    (k+1)-th probabilities (``probs``, laid out as ``b``) are within
    ``tie``. Any other difference is a fault, and raises."""
    a, b, probs = a.cpu(), b.cpu(), probs.cpu()
    bad = (a != b).any(-1)  # [layers, rows, positions]
    n_pos = bad.shape[2]
    flips, gaps = [], []
    for r in range(bad.shape[1]):
        hit = bad[:, r].any(0).nonzero()
        if not len(hit):
            flips.append(n_pos)
            continue
        n = int(hit[0, 0])
        layer = int(bad[:, r, n].nonzero()[0, 0])
        top = probs[layer, r, n].topk(top_k + 1).values
        gap = float(top[top_k - 1] - top[top_k])
        where = f"{label}: row {r}, position {n}, layer {layer}"
        if torch.equal(a[layer, r, n] > 0, b[layer, r, n] > 0):
            raise AssertionError(f"{where}: the same experts chosen, kept "
                                 "or dropped differently")
        if gap > tie:
            raise AssertionError(f"{where}: other experts chosen at a top-"
                                 f"{top_k} probability gap of {gap:.3e} "
                                 f"(a near-tie is within {tie})")
        flips.append(n)
        gaps.append(gap)
    return torch.tensor(flips), gaps


def _held_before(got, want, flips, tol: float, label: str) -> dict:
    """``got`` and ``want`` ``[rows, positions, vocab]`` within rtol =
    atol = ``tol`` at every row's positions before its first routing
    flip (a near-tie, ``_route_flips``; after it the two computations
    route a token differently); every position when there is none. Fewer
    than half the positions held is a failure."""
    err, checked = 0.0, 0
    for r in range(got.shape[0]):
        n = int(flips[r])
        if n:
            err = max(err, _close_to(got[r, :n], want[r, :n], tol, f"{label}, row {r}"))
        checked += n
    positions = got.shape[0] * got.shape[1]
    if 2 * checked < positions:
        raise AssertionError(f"{label}: {checked} of {positions} positions "
                             "held before a routing near-tie")
    return {"max_abs_err": err, "positions_checked": checked,
            "positions": positions, "first_flips": [int(f) for f in flips]}


def _serve_checks(mod, cfg, params, gen: torch.Generator, max_len: int) -> dict:
    """Prefill (chunked) against ``forward(mode="dense")`` over
    ``SERVE_PREFILL`` tokens, and ``SERVE_FORCED`` teacher-forced decode
    steps against ``forward`` over the same tokens (the MoE forward
    dropless, as the step is), on the real vocabulary, rtol = atol =
    ``SERVE_TOL``. An MoE's prefill runs a row at a time, since the
    capacity counts run over the flattened batch. An MoE's positions from
    a row's first routing flip on are not held, and a flip fails unless
    it is a near-tie (``_route_flips``, ``_held_before``)."""
    Bp, Sp = SERVE_PREFILL
    if cfg.family == "encdec":
        Sp = max_len  # the text context
    tokens = torch.randint(0, cfg.vocab, (Bp, Sp), generator=gen).to(DEVICE)
    frames = None
    if cfg.family == "encdec":
        frames = (0.1 * torch.randn((Bp, cfg.enc_seq, cfg.d_model), generator=gen)
                  ).to(DEVICE, cfg.torch_dtype)

    def batch_of(rows, n):
        b = {"tokens": tokens[rows, :n]}
        if frames is not None:
            b["frames"] = frames[rows]
        return b

    V, out, held = cfg.vocab, {}, []
    for rows in ([slice(r, r + 1) for r in range(Bp)] if cfg.is_moe
                 else [slice(0, Bp)]):
        with _Routes() as ra:
            pre = mod.prefill(params, cfg, batch_of(rows, Sp))[..., :V]
        with _Routes() as rb:
            dense = mod.forward(params, cfg, batch_of(rows, Sp), mode="dense")[0][..., :V]
        label = f"serve {cfg.name}: prefill vs dense"
        flips, gaps = torch.full((pre.shape[0],), Sp), []
        if cfg.is_moe:
            flips, gaps = _route_flips(
                *(_per_layer(x, cfg.n_layers, Sp)[:, None]
                  for x in (ra.maps, rb.maps, rb.probs)), cfg.moe_top_k, label)
        held.append({**_held_before(pre, dense, flips, SERVE_TOL, label),
                     "tie_gaps": gaps})
        del pre, dense
    out["prefill"] = {
        "max_abs_err": max(h["max_abs_err"] for h in held),
        "positions_checked": sum(h["positions_checked"] for h in held),
        "positions": sum(h["positions"] for h in held),
        "first_flips": sum((h["first_flips"] for h in held), []),
        "tie_gaps": sum((h["tie_gaps"] for h in held), [])}
    # dropless: no expert takes more than the group's tokens
    fcfg = (cfg.replace(capacity_factor=float(math.ceil(cfg.n_experts / cfg.moe_top_k)))
            if cfg.is_moe else cfg)
    T = SERVE_FORCED
    cache = _serve_cache(mod, cfg, params, Bp, max_len, frames, DEVICE)
    with _Routes() as ra:
        steps = _forced(mod, cfg, params, cache, tokens[:, :T])[..., :V]
    del cache
    with _Routes() as rb:
        full = mod.forward(params, fcfg, batch_of(slice(0, Bp), T))[0][..., :V]
    label = f"serve {cfg.name}: decode vs forward"
    flips, gaps = torch.full((Bp,), T), []
    if cfg.is_moe:
        L = cfg.n_layers  # a step routes its Bp tokens in one group a layer
        dec = _per_layer(ra.maps, T * L, Bp).reshape(T, L, Bp, -1)
        fwd, probs = (_per_layer(x, L, Bp * T).reshape(L, Bp, T, -1)
                      for x in (rb.maps, rb.probs))
        flips, gaps = _route_flips(dec.permute(1, 2, 0, 3), fwd, probs,
                                   cfg.moe_top_k, label)
    out["forced"] = {**_held_before(steps, full, flips, SERVE_TOL, label),
                     "tie_gaps": gaps}
    return out


class _ServeRecorder:
    """While active, every ``mod.decode_step`` recorded: each step's
    logits over the real vocabulary (copied on the device), the cache it
    returns (the last one kept), its ``shard`` and the bytes of the
    parameters it reads; the first ``comm_steps`` steps under ``comm``
    (phase 15 (c)'s ``_TpCounted``); after each step count in ``keep`` a
    copy of the cache on the device, by dotted path (``kept[steps]``)."""

    def __init__(self, mod, vocab: int, comm=None, comm_steps: int = 0,
                 keep=()):
        self.mod, self.vocab, self.comm, self.comm_steps = mod, vocab, comm, comm_steps
        self.logits, self.cache, self.shard, self.param_bytes = [], None, None, 0
        self.keep, self.kept = set(keep), {}
        self.traffic0 = {}

    def __enter__(self):
        self._step = self.mod.decode_step

        def step(params, cfg, cache, tokens, **kw):
            if not self.logits and kw.get("shard") is not None:
                # what the shard counted before the first step (an
                # encoder-decoder's cross cache)
                self.traffic0 = dict(kw["shard"].traffic)
            counted = self.comm is not None and len(self.logits) < self.comm_steps
            with self.comm if counted else contextlib.nullcontext():
                logits, cache = self._step(params, cfg, cache, tokens, **kw)
            self.logits.append(logits[:, 0, :self.vocab].clone())
            self.cache, self.shard = cache, kw.get("shard")
            if len(self.logits) in self.keep:
                from repro_torch.tree import tree_items

                self.kept[len(self.logits)] = {k: x.clone()
                                               for k, x in tree_items(cache)}
            self.param_bytes = _tree_bytes(params)
            return logits, cache

        self.mod.decode_step = step
        return self

    def __exit__(self, *exc):
        self.mod.decode_step = self._step


def _serve_twin(arch: str, params, res, rec: "_ServeRecorder", routes,
                step_ms: float, twin_dir: str) -> dict:
    """Phase 14's run of ``arch`` saved as the one-card twin of phase 15
    (c)'s serving runs under ``twin_dir``: the whole weights
    (``<arch>.serve.p0.pt``) and the served sequence, each step's logits,
    the cache by dotted path after each step count its serving runs hold
    (``caches``) and an MoE's routings (``<arch>.serve.twin.pt``), as
    ``_ServeRecorder`` and ``_Routes`` recorded them in ``serve.run``."""
    from repro_torch.tree import tree_items

    t0 = time.perf_counter()
    torch.save({"seq": torch.cat([res.first, res.prompt, res.tokens], 1),
                "logits": torch.stack(rec.logits, 1).cpu(),
                "caches": {n: {k: x.cpu() for k, x in c.items()}
                           for n, c in rec.kept.items()},
                "step_ms": step_ms,
                "routes": None if routes is None else {
                    "maps": [x.cpu() for x in routes.maps],
                    "probs": [x.cpu() for x in routes.probs]}},
               f"{twin_dir}/{arch}.serve.twin.pt")
    torch.save({k: x.cpu() for k, x in tree_items(params)},
               f"{twin_dir}/{arch}.serve.p0.pt")
    return {"steps": len(rec.logits), "seconds": time.perf_counter() - t0}


def _serve_twin_forced(arch: str, mod, cfg, params, res, steps: int,
                       max_len: int, twin_dir: str) -> dict:
    """The encoder-decoder twin's teacher-forced leg, saved under
    ``twin_dir`` (``<arch>.serve.forced.pt``): frames drawn from
    ``TP_SERVE_FRAMES_SEED`` (0.1 x a standard normal), the served
    sequence's first ``steps`` tokens fed to as many decode steps from the
    cross cache of those frames on the card, each step's logits over the
    real vocabulary, and the cache's tensors after them."""
    from repro_torch.tree import tree_items

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(TP_SERVE_FRAMES_SEED)
    frames = (0.1 * torch.randn((res.first.shape[0], cfg.enc_seq, cfg.d_model),
                                generator=gen)).to(cfg.torch_dtype)
    tokens = torch.cat([res.first, res.prompt, res.tokens], 1)[:, :steps]
    with torch.inference_mode():
        cache = _serve_cache(mod, cfg, params, tokens.shape[0], max_len,
                             frames.to(DEVICE), DEVICE)
        logits = _forced(mod, cfg, params, cache, tokens.to(DEVICE))
    torch.save({"frames": frames, "tokens": tokens,
                "logits": logits[..., :cfg.vocab].cpu(),
                "cache": {k: x.cpu() for k, x in tree_items(cache) if k != "pos"}},
               f"{twin_dir}/{arch}.serve.forced.pt")
    return {"steps": steps, "seconds": time.perf_counter() - t0}


def _serve_published(arch: str, run: dict, smi: str, twin_dir=None) -> dict:
    """One model at its published widths (module docstring, phase 14):
    all its layers unless ``run`` cuts them; saved under ``twin_dir``
    as a twin of phase 15 (c)'s serving runs where one names it."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import get_family
    from repro_torch.tree import tree_leaves

    cfg = configs.get_config(arch)
    full_layers = cfg.n_layers
    if run.get("layers"):
        cfg = cfg.replace(n_layers=run["layers"])
    mod = get_family(cfg)
    B, M = run["batch"], run["max_len"]
    out = {"layers": cfg.n_layers, "full_layers": full_layers, "batch": B,
           "max_len": M}
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = mod.init(cfg, seed=0, device=DEVICE)
    torch.cuda.synchronize()
    out["init_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with torch.inference_mode():
        out.update(_serve_checks(mod, cfg, params, torch.Generator().manual_seed(14), M))
    torch.cuda.synchronize()
    out["check_seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = _all_launches()
    held = {_tp_serve_steps(r) for r in TP_SERVE_RUNS.values() if r["arch"] == arch}
    twin = twin_dir is not None and bool(held)
    with (_ServeRecorder(mod, cfg.vocab, keep=held) if twin
          else contextlib.nullcontext()) as rec, \
            (_Routes() if twin and cfg.is_moe else contextlib.nullcontext()) as routes:
        res = serve.run(serve.parse_args([
            "--arch", arch, "--batch", str(B), "--prompt-len", str(SERVE_PROMPT),
            "--new-tokens", str(SERVE_NEW), "--max-len", str(M), "--device", DEVICE]),
            params=params, cfg=cfg)
    if _all_launches() != before:
        raise AssertionError(f"serve {arch}: a kernel of the five launched")
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    if res.tokens.shape != (B, SERVE_NEW) or not bool(
            ((res.tokens >= 0) & (res.tokens < cfg.vocab)).all()):
        raise AssertionError(f"serve {arch}: tokens {res.tokens.shape}")
    step_ms = statistics.median(res.step_ms)
    if twin:
        out["tp_twin"] = _serve_twin(arch, params, res, rec, routes, step_ms, twin_dir)
        del rec, routes
        if cfg.family == "encdec":
            out["tp_twin"]["forced"] = _serve_twin_forced(
                arch, mod, cfg, params, res, max(held), M, twin_dir)
    with torch.inference_mode():
        zeros = (torch.zeros((B, cfg.enc_seq, cfg.d_model), dtype=cfg.torch_dtype,
                             device=DEVICE) if cfg.family == "encdec" else None)
        cache = _serve_cache(mod, cfg, params, B, M, zeros, DEVICE)
        toks = res.tokens[:, :4].to(DEVICE)
        torch.cuda.set_sync_debug_mode("error")  # a step reads nothing on the host
        try:
            _forced(mod, cfg, params, cache, toks[:, :2])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        prof = profile_step(lambda: _forced(mod, cfg, params, cache, toks), 4 * step_ms)
        del cache
    # the byte bound: what the timed steps need; beside it, what the
    # einsum dispatch (every expert) and the masked attention (every
    # slot) read
    wb = _decoder_bytes(params, cfg)
    cb = _tree_bytes(mod.init_cache(cfg, B, M, device="meta"))
    unrouted, routed = (_unrouted_bytes(mod, cfg, params, res, B, M)
                        if cfg.is_moe else (0.0, None))
    need_w = wb - unrouted
    need_c = _cache_bytes_needed(mod, cfg, B, M,
                                 range(SERVE_PROMPT, SERVE_PROMPT + SERVE_NEW))
    bound_ms = 1e3 * (need_w + need_c) / HBM_BYTES_PER_S
    reads_ms = 1e3 * (wb + cb) / HBM_BYTES_PER_S
    out.update(tokens_per_s=res.tokens_per_s, seconds=res.seconds,
               step_ms=step_ms, step_samples_ms=res.step_ms,
               weights_bytes=wb, cache_bytes=cb,
               needed_weights_bytes=need_w, needed_cache_bytes=need_c,
               experts_routed_per_layer=routed,
               params=sum(x.numel() for x in tree_leaves(params)),
               bound_ms=bound_ms, bound_share=bound_ms / step_ms,
               dispatch_reads_ms=reads_ms,
               busy_share=prof["busy_share"],
               launches_per_step=prof["launches"] / 4, profile=prof)
    depth = ("all" if cfg.n_layers == full_layers else
             f"{cfg.n_layers} of {full_layers}")
    extra = f" over {cfg.enc_seq} frames" if cfg.family == "encdec" else ""
    pre, forced = out["prefill"], out["forced"]
    flips = (f"; first routing flips {pre['first_flips']} and "
             f"{forced['first_flips']} (near-tie gaps {pre['tie_gaps']} and "
             f"{forced['tie_gaps']})" if cfg.is_moe else "")
    moe = (f" ({routed:.2f} of {cfg.n_experts} experts routed a layer)"
           if cfg.is_moe else "")
    log(f"serve {arch}: {depth} layers, {out['params']:,} parameters; host init "
        f"{out['init_seconds']:.1f} s; prefill == dense at {pre['positions_checked']} "
        f"of {pre['positions']} positions (max abs diff {pre['max_abs_err']:.2e}), "
        f"{SERVE_FORCED} teacher-forced steps == forward at "
        f"{forced['positions_checked']} of {forced['positions']} "
        f"({forced['max_abs_err']:.2e}){flips}; serving batch "
        f"{B}, max_len {M}{extra}: {res.tokens_per_s:.1f} tok/s, {step_ms:.3f} ms "
        f"a step (median of {SERVE_NEW}) against a byte bound of {bound_ms:.3f} ms "
        f"({bound_ms / step_ms:.1%}: weights {need_w / 1e9:.3f} GB{moe} + "
        f"cache {need_c / 1e9:.3f} GB, its filled slots over the timed steps, "
        f"at {HBM_BYTES_PER_S:.3g} B/s; every weight and the whole cache "
        f"read once, as the einsum dispatch and the masked attention do: "
        f"{wb / 1e9:.3f} GB + {cb / 1e9:.3f} GB, {reads_ms:.3f} ms); peak "
        f"{out['peak_bytes'] / 1e9:.2f} GB; device busy {prof['busy_share']:.1%}, "
        f"{prof['launches'] / 4:.0f} kernels a step ({smi})")
    del params
    torch.cuda.empty_cache()
    return out


def serve_smoke() -> dict:
    """Phase 13's seven smoke variants through ``serve.run`` on the card
    and on the CPU (the same seeded weights and first tokens); the card
    run's token sequence teacher-forced on both: logits within 1e-4 of the
    largest magnitude; the CPU's greedy tokens equal the card's up to a
    step whose CPU top-2 margin is within that."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import get_family

    out = {}
    for arch in FAMILY_SMOKE:
        small = ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "4",
                 "--new-tokens", "12", "--max-len", "16"]
        card = serve.run(serve.parse_args([*small, "--device", DEVICE]))
        cpu = serve.run(serve.parse_args([*small, "--device", "cpu"]))
        if not torch.equal(card.first, cpu.first):
            raise AssertionError(f"serve {arch} smoke: first tokens differ")
        seq = torch.cat([card.first, card.prompt, card.tokens], 1)
        cfg = configs.get_config(arch).smoke_variant()
        mod = get_family(cfg)
        logits = {}
        with torch.inference_mode():
            for dev in (DEVICE, "cpu"):
                params = mod.init(cfg, seed=0, device=dev)
                frames = torch.zeros((2, cfg.enc_seq, cfg.d_model), device=dev)
                cache = _serve_cache(mod, cfg, params, 2, 16, frames, dev)
                logits[dev] = _forced(mod, cfg, params, cache,
                                      seq[:, :-1].to(dev)).cpu()
        want = logits["cpu"]
        tol = SERVE_SMOKE_TOL * want.abs().max().item()
        err = (logits[DEVICE] - want).abs().max().item()
        if not err <= tol:
            raise AssertionError(f"serve {arch} smoke: card logits {err:.3e} from "
                                 f"the CPU's (allowed {tol:.3e})")
        top2 = want.topk(2, dim=-1).values
        margin = top2[..., 0] - top2[..., 1]
        got = torch.cat([card.prompt, card.tokens], 1)
        ref = torch.cat([cpu.prompt, cpu.tokens], 1)
        for row in range(2):
            differ = (got[row] != ref[row]).nonzero()
            if len(differ) and margin[row, differ[0, 0]] > 2 * tol:
                raise AssertionError(f"serve {arch} smoke: row {row} parts at step "
                                     f"{int(differ[0, 0])} with a clear margin")
        log(f"serve {arch} smoke: the card's logits within {err:.2e} of the CPU's "
            f"(allowed {tol:.2e}); greedy tokens {'equal' if torch.equal(got, ref) else 'part at a near-tie'}")
        out[arch] = {"max_abs_err": err, "tol": tol,
                     "tokens_equal": bool(torch.equal(got, ref))}
    return out


def phase_serving(smi: str, twin_dir=None) -> dict:
    """Phase 14: serving (see the module docstring); the twins of phase
    15 (c)'s serving runs saved under ``twin_dir`` where given."""
    from repro_torch.nn import layers

    layers.set_fp32_matmul()
    out, t_phase = {}, time.perf_counter()
    for arch, run in SERVE_RUNS.items():
        out[arch] = _serve_published(arch, run, smi, twin_dir)
    out["smoke"] = serve_smoke()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"serving: phase 14 took {out['seconds']:.1f} s")
    return out


# phase 15: the model axis. (a) qwen2.5-3b at phase 13's batch and half its
# depth (for the script's time limit; 6 layers until phase 15 (c) trained
# zamba2-7b) on the host meshes of --workers 4 with a model axis of 2 and
# of 4; (b) four
# gloo ranks at (data, model) = (2, 2) on paper-resnet-proxy, tensor
# parallel; (c) four gloo ranks, tensor parallel at published widths.
MP_ARCH, MP_LAYERS, MP_BATCH, MP_DEVICES = "qwen2.5-3b", 3, 4, 4
MP_MODELS = (2, 4)
MP_RANK_STEPS, MP_RANK_CKPT = 6, 3
MP_RANK_RUNS = {"sparse_allgather": [],
                "dense_allreduce": ["--collective", "dense_allreduce"]}
# (b)'s sparse_allgather run with the fastpath off, across the ranks only
MP_RANK_OFF = {"fastpath_off": ["--fastpath", "off"]}


def _mp_train(cfg, params0, W: int, M: int, fastpath: str,
              batch: int = MP_BATCH, seq: int = FAMILY_SEQ):
    """``FAMILY_STEPS`` steps of ``cfg`` on the host mesh ``(data, model) =
    (W, M)`` of one card, from a copy of ``params0`` on the card (which
    may lie on the host), RegTop-k at ``FAMILY_SPARSITY``: one round per
    (worker, model shard), a global batch of ``batch`` rows of ``seq``
    tokens. Returns
    (params, sparsifier state, plan, losses, kernel 1 launches, seconds,
    peak bytes)."""
    from repro_torch.comm.fastpath import FastpathCounts
    from repro_torch.core import distributed as td
    from repro_torch.core.sparsify import SparsifierConfig
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import fused_encode as fe
    from repro_torch.models import param_axes
    from repro_torch.optim import OptConfig, make_optimizer
    from repro_torch.tree import tree_map

    dist = td.DistConfig(
        sparsifier=SparsifierConfig(kind="regtopk", sparsity=FAMILY_SPARSITY),
        optimizer=OptConfig(kind="adam", learning_rate=FAMILY_LR),
        fastpath=fastpath)
    params = tree_map(lambda x: x.to(DEVICE, copy=True), params0)
    plan = td.build_plan(params, FAMILY_SPARSITY, dist, axes=param_axes(cfg),
                         mesh={"data": W, "model": M})
    step = td.make_train_step(cfg, dist, plan, W, FastpathCounts())
    opt_state = make_optimizer(dist.optimizer).init(params)
    sp = td.init_sparsifier_state(plan, W, DEVICE)
    pipe = TokenPipeline(cfg, batch, seq, 0, DEVICE)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fe.fused_candidates.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for t in range(FAMILY_STEPS):
        params, opt_state, sp, m = step(params, opt_state, sp, pipe.batch_at(t))
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    return (params, sp, plan, losses, fe.fused_candidates.launches,
            time.perf_counter() - t0, torch.cuda.max_memory_allocated())


def _to_host(params, sp):
    """A run's params and sparsifier state copied to the host, so the card
    holds one run at a time."""
    from repro_torch.core.compact import CompactState
    from repro_torch.tree import tree_map

    return (tree_map(lambda x: x.cpu(), params),
            tree_map(lambda st: CompactState(*(x.cpu() for x in st)), sp))


def model_parallel_card(smi: str) -> dict:
    """Phase 15 (a): qwen2.5-3b at 3 of 36 layers, batch 4 x 512, on the
    host meshes of 4 devices with a model axis of 2 (W = 2) and of 4 (W
    = 1), fastpath on against off: params and every sparsifier-state
    field in bits, kernel 1 once per fused leaf per step (the W x M rows
    of a leaf in one launch), each leaf's block and k, the peak beside
    ``_reckoned_bytes``."""
    from repro_torch import configs
    from repro_torch.core import distributed as td
    from repro_torch.models import get_family
    from repro_torch.tree import tree_items, tree_leaves

    cfg = configs.get_config(MP_ARCH).replace(n_layers=MP_LAYERS)
    params0 = get_family(cfg).init(cfg, seed=0, device=DEVICE)
    out, launches = {}, 0
    for M in MP_MODELS:
        W = MP_DEVICES // M
        name = f"{W}x{M}"
        params, sp, plan, losses, n, seconds, peak = _mp_train(
            cfg, params0, W, M, "on")
        on = _to_host(params, sp)
        del params, sp
        off = _mp_train(cfg, params0, W, M, "off")
        leaves = dict(tree_items(plan))
        n_fused = sum(p.fused for p in leaves.values())
        if not all(math.isfinite(x) for x in losses) or off[3] != losses:
            raise AssertionError(f"model parallel {name}: losses on {losses}, "
                                 f"off {off[3]}")
        if n != FAMILY_STEPS * n_fused or n == 0 or off[4] != 0:
            raise AssertionError(
                f"model parallel {name}: {n} kernel 1 launches on ({off[4]} off), "
                f"expected {FAMILY_STEPS} steps x {n_fused} fused leaves")
        off_host = _to_host(off[0], off[1])
        bad = _mismatches(on[0], off_host[0])
        same_state = all(_bits_equal(x, y) for a, b in zip(
            tree_leaves(off_host[1]), tree_leaves(on[1]), strict=True)
            for x, y in zip(a, b, strict=True))
        if bad or not same_state:
            raise AssertionError(f"model parallel {name}: fastpath on vs off: "
                                 f"{bad} param bit mismatches, states equal "
                                 f"{same_state}")
        whole = [path for path, p in leaves.items() if td.split_dim(p) is None]
        reckoned = _reckoned_bytes(params0, W)
        for path, p in leaves.items():
            log(f"model parallel {name}: {path} {p.global_shape} -> "
                f"{p.local_shape} x {p.shards} (k = {p.k}"
                f"{', whole' if path in whole else ''})")
        log(f"model parallel {name}: W = {W}, {M} shards, batch {MP_BATCH} x "
            f"{FAMILY_SEQ}, {FAMILY_STEPS} steps in {seconds:.2f} s (fastpath "
            f"on), losses {losses[0]:.4f} -> {losses[-1]:.4f}; fastpath on == "
            f"off in bits (params and state); {n} kernel 1 launches "
            f"({n_fused}/{len(leaves)} leaves fused, predicted {FAMILY_STEPS} x "
            f"{n_fused}); {len(whole)} leaves whole; peak {peak / 1e9:.2f} GB "
            f"allocated (reckoned {reckoned / 1e9:.2f} GB; {smi})")
        launches += n
        out[name] = {"workers": W, "shards": M, "losses": losses, "launches": n,
                     "fused_leaves": n_fused, "leaves": len(leaves),
                     "whole": whole, "seconds": seconds, "peak_bytes": peak,
                     "off_peak_bytes": off[6], "reckoned_bytes": reckoned,
                     "blocks": {path: [list(p.local_shape), p.k]
                                for path, p in leaves.items()}}
        del on, off, off_host
        torch.cuda.empty_cache()
    del params0
    torch.cuda.empty_cache()
    out["launches"] = launches
    return out


def _mp_rank_body(rank: int, world: int, store: str, out_dir: str,
                  device: str) -> None:
    """One of phase 15 (b)'s 4 gloo ranks on ``device``, ``(data, model) =
    (2, 2)``: each run of ``MP_RANK_RUNS`` and ``MP_RANK_OFF`` for
    ``MP_RANK_STEPS`` steps, then ``MP_RANK_CKPT`` steps with
    ``--checkpoint`` and the rest with ``--resume``; kernel 1's launches
    counted around each. Every rank saves its numbers; rank 0 also the
    params (gathered whole by ``train.run``) and the state of every
    (worker, shard), gathered, in the JAX layout."""
    import contextlib
    import io

    import torch.distributed as dist

    from repro_torch import convert
    from repro_torch.kernels import fused_encode as fe
    from repro_torch.launch import mesh, train

    torch.cuda.set_device(device)
    mesh.init_file_store(store, rank, world, "gloo")
    try:
        out = {}
        runs = {name: (extra, ["--steps", str(MP_RANK_STEPS)])
                for name, extra in {**MP_RANK_RUNS, **MP_RANK_OFF}.items()}
        runs["checkpoint"] = ([], ["--steps", str(MP_RANK_CKPT), "--checkpoint",
                                   f"{out_dir}/ckpt"])
        runs["resume"] = ([], ["--steps", str(MP_RANK_STEPS - MP_RANK_CKPT),
                               "--resume", f"{out_dir}/ckpt"])
        for name, (extra, steps) in runs.items():
            args = _rank_args(TRAIN_ARGS, [*extra, "--model-parallel", "2",
                                           *steps], device, world)
            groups = mesh.make_host_groups(model=2)
            fe.fused_candidates.launches = 0
            _sync(device)
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                res = train.run(args, mesh=groups)
            _sync(device)
            full = convert.trainer_state_to_jax(
                train._all_workers(res.sp_state, groups), res.plan)
            out[name] = {"launches": fe.fused_candidates.launches,
                         "losses": res.losses, "digest": _params_digest(res.params),
                         "state_bytes": _state_bytes(res.sp_state),
                         "eps_bytes": sum(st.eps.numel() * st.eps.element_size()
                                          for st in _flat(res.sp_state).values()),
                         "fused_leaves": sum(p.fused for p in
                                             _flat(res.plan).values()),
                         "worker": groups.rank, "shard": groups.shard,
                         "model_axis": [ln for ln in printed.getvalue().splitlines()
                                        if ln.startswith("model axis:")]}
            if rank == 0:
                torch.save({"params": {k: v.cpu() for k, v in
                                       _flat(res.params).items()},
                            "state": {k: [x.cpu() for x in st] for k, st in
                                      _flat(full).items()}},
                           f"{out_dir}/{name}.pt")
        Path(f"{out_dir}/rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def _same_bits(a: dict, b: dict) -> bool:
    """Two ``{"params", "state"}`` dicts of host tensors equal in bits."""
    return (a["params"].keys() == b["params"].keys()
            and all(_bits_equal(a["params"][k], b["params"][k]) for k in a["params"])
            and all(_bits_equal(x, y) for k in a["state"]
                    for x, y in zip(a["state"][k], b["state"][k], strict=True)))


def _state_diff(got: dict, want: dict, adam_step: float) -> tuple:
    """Two states of every (worker, shard) in the JAX layout (``{path:
    [eps, sent_vals, sent_g, sent_idx, sent_w, t]}``): ``_param_diff`` of
    the errors under ``adam_step``'s rule, and the number of (worker,
    shard) rows whose ``sent_idx`` differ as sets."""
    eps = _param_diff({k: v[0] for k, v in got.items()},
                      {k: v[0] for k, v in want.items()}, adam_step)
    rows = sum(int((g[3].sort(-1).values != w[3].sort(-1).values).any(-1).sum())
               for g, w in ((got[k], want[k]) for k in want))
    return eps, rows


def model_parallel_ranks(smi: str, device=None) -> dict:
    """Phase 15 (b): 4 gloo ranks sharing the card at ``(data, model) = (2,
    2)`` on paper-resnet-proxy at full width, tensor parallel (the dense
    family), against the one-card ``--workers 4 --model-parallel 2`` run:
    losses to rtol 1e-5, params to rtol 1e-5 with a floor of 1e-5 of a
    leaf's largest magnitude, at most 0.1% of them off by up to 2 lr a
    step (``_param_diff``: the gloo all-reduce's row-parallel sums round
    otherwise than the one card's whole products, and a last-ulp change
    can flip a selection or the sign of a near-cancelling Adam step); the
    errors of every (worker, shard) and their ``sent_idx`` reported (after
    a flip every later gradient moves by the flipped step, and the errors
    keep it); the same ranks with the fastpath off in bits; the
    checkpointed and resumed run against the unbroken one in bits; each
    rank's state bytes beside the one-card run's per worker."""
    import tempfile

    from repro_torch import convert
    from repro_torch.kernels import fused_encode as fe
    from repro_torch.launch import mesh, train

    device = device or f"{DEVICE}:0"
    one_card, launches = {}, 0
    for name, extra in MP_RANK_RUNS.items():
        args = _rank_args(TRAIN_ARGS, [*extra, "--model-parallel", "2", "--steps",
                                       str(MP_RANK_STEPS)], device, 4)
        fe.fused_candidates.launches = 0
        res = train.run(args)
        _sync(device)
        launches += fe.fused_candidates.launches
        one_card[name] = {
            "params": {k: v.cpu() for k, v in _flat(res.params).items()},
            "state": {k: [x.cpu() for x in st] for k, st in _flat(
                convert.trainer_state_to_jax(res.sp_state, res.plan)).items()},
            "losses": res.losses, "launches": fe.fused_candidates.launches,
            "state_bytes": _state_bytes(res.sp_state)}
        del res
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        mesh.spawn(_mp_rank_body, 4, (f"{d}/store", d, device), timeout=300)
        seconds = time.perf_counter() - t0
        ranks = [json.loads(Path(f"{d}/rank{r}.json").read_text())
                 for r in range(4)]
        rank0 = {name: torch.load(f"{d}/{name}.pt")
                 for name in [*MP_RANK_RUNS, *MP_RANK_OFF, "resume"]}
    out = {"seconds": seconds, "ranks": ranks}
    adam_step = 2 * _rank_args(TRAIN_ARGS, [], device, 4).lr * MP_RANK_STEPS
    for name in [*MP_RANK_RUNS, *MP_RANK_OFF]:
        rows = [rk[name] for rk in ranks]
        if len({row["digest"] for row in rows}) != 1:
            raise AssertionError(f"model parallel (b) {name}: ranks' params "
                                 "differ in bits")
        if not any("tensor parallel" in ln for ln in rows[0]["model_axis"]):
            raise AssertionError(f"model parallel (b) {name}: not tensor "
                                 f"parallel: {rows[0]['model_axis']}")
        for r, row in enumerate(rows):
            if row["launches"] != MP_RANK_STEPS * row["fused_leaves"]:
                raise AssertionError(
                    f"model parallel (b) {name}: rank {r} launched kernel 1 "
                    f"{row['launches']} times, expected {MP_RANK_STEPS} x "
                    f"{row['fused_leaves']}")
        launches += sum(row["launches"] for row in rows)
    off = rank0["fastpath_off"]
    if (not _same_bits(off, rank0["sparse_allgather"])
            or ranks[0]["fastpath_off"]["losses"]
            != ranks[0]["sparse_allgather"]["losses"]):
        raise AssertionError(
            "model parallel (b): the 4 ranks with the fastpath on differ from "
            f"off: {_mismatches(rank0['sparse_allgather']['params'], off['params'])}"
            " param bit mismatches")
    log(f"model parallel (b): 4 ranks, tensor parallel, fastpath on == off in "
        f"bits (params, losses and the state of every (worker, shard)); "
        f"{ranks[0]['fastpath_off']['launches']} kernel 1 launches off")
    for name in MP_RANK_RUNS:
        rows = [rk[name] for rk in ranks]
        want = one_card[name]
        diff = _param_diff(rank0[name]["params"], want["params"], adam_step)
        eps, sent_rows = _state_diff(rank0[name]["state"], want["state"],
                                     adam_step)
        loss_ok = all(abs(g - w) <= 1e-5 * abs(w) for g, w in zip(
            rows[0]["losses"], want["losses"], strict=True))
        if not (diff["ok"] and loss_ok):
            raise AssertionError(
                f"model parallel (b) {name}: the 4 ranks against the one-card "
                f"run: params {diff}, eps {eps}, losses {rows[0]['losses']} vs "
                f"{want['losses']}")
        out[name] = {"one_card_losses": want["losses"],
                     "one_card_launches": want["launches"],
                     "one_card_state_bytes": want["state_bytes"],
                     "vs_one_card": diff, "eps_vs_one_card": eps,
                     "sent_idx_rows_differing": sent_rows}
        log(f"model parallel (b) {name}: 4 ranks over gloo on one card, (data, "
            f"model) = (2, 2), {rows[0]['model_axis'][0]}; params equal in bits "
            f"across the ranks; against the one-card --workers 4 "
            f"--model-parallel 2 run: losses within rtol 1e-5, params "
            f"{diff['mismatches']} bit mismatches, largest relative difference "
            f"{diff['largest_rel_diff']:.3e}, {diff['beyond_rtol']} elements "
            f"beyond rtol 1e-5 (largest |diff| {diff['max_abs_diff']:.3e}); "
            f"reported: eps {eps['beyond_rtol']} of {eps['n']} beyond (largest "
            f"|diff| {eps['max_abs_diff']:.3e}), {sent_rows} (worker, shard) "
            f"rows with other sent_idx; losses {rows[0]['losses'][0]:.4f} -> "
            f"{rows[0]['losses'][-1]:.4f}; kernel 1 {rows[0]['launches']} "
            f"launches per rank ({rows[0]['fused_leaves']} fused leaves), "
            f"{want['launches']} on one card; state bytes per rank "
            f"{[row['state_bytes'] for row in rows]} (eps "
            f"{rows[0]['eps_bytes']}), one card {want['state_bytes']} for its "
            f"4 rows")
    resumed = [rk["checkpoint"]["losses"] + rk["resume"]["losses"] for rk in ranks]
    if (not _same_bits(rank0["resume"], rank0["sparse_allgather"])
            or resumed[0] != ranks[0]["sparse_allgather"]["losses"]):
        raise AssertionError("model parallel (b): --checkpoint at step "
                             f"{MP_RANK_CKPT} and --resume differ from the "
                             "unbroken run")
    launches += sum(rk[n]["launches"] for rk in ranks for n in ("checkpoint",
                                                                 "resume"))
    log(f"model parallel (b): --checkpoint at step {MP_RANK_CKPT}, --resume to "
        f"step {MP_RANK_STEPS} on the 4 ranks == the unbroken run in bits "
        f"(params, state, losses); the spawn took {seconds:.1f} s ({smi})")
    out["launches"] = launches
    return out


# (c): each run's config, depth (None: whole), (data, model) layout and
# global batch of rows of seq tokens (FAMILY_SEQ unless given), the
# config's fields replaced and whether it also runs with the fastpath
# off. Depths cut to keep the
# script inside its time limit: qwen2.5-3b at 3 of 36 layers and
# internvl2-1b at 3 of 24 (12 and 12 until zamba2-7b came, internvl2-1b 6
# until (c) served; qwen2.5-3b's 14 layers reserved 78.9-80.9 GB of 85.0,
# PERF.md), deepseek-moe-16b's expert layout with the fastpath on only;
# deepseek-moe-16b at W = 1, so a worker routes one group of 2048 tokens
# (capacity 240), in both MoE layouts (the expert one 16 experts a rank);
# zamba2-7b at 7 of 81 layers, one group of 5 mamba blocks and the shared
# block, then 1 trailing block (8 until (c) served; tp_prediction at 8:
# 47.7 GB summed; 14 layers 77.5 GB);
# whisper-tiny whole at Whisper's decoder context of 448 tokens (phase 13's)
TP_RUNS = {
    "qwen2.5-3b": dict(arch="qwen2.5-3b", layers=3, data=1, model=4,
                       batch=4),
    "internvl2-1b": dict(arch="internvl2-1b", layers=3, data=2, model=2,
                         batch=8),
    "deepseek-moe-16b:tensor": dict(
        arch="deepseek-moe-16b", layers=1, data=1, model=4, batch=4,
        fields={"moe_parallelism": "tensor"}),
    "deepseek-moe-16b:expert": dict(
        arch="deepseek-moe-16b", layers=1, data=1, model=4, batch=4,
        fields={"moe_parallelism": "expert"}, off=False),
    "zamba2-7b": dict(arch="zamba2-7b", layers=7, data=1, model=4, batch=4),
    "whisper-tiny": dict(arch="whisper-tiny", layers=None, data=2, model=2,
                         batch=8, seq=448),
}
# phase 15 (c)'s serving runs, on the same 4 ranks after the training
# runs: phase 14's model (its depth, batch and max_len, SERVE_RUNS) on a
# (data, model) layout, held against phase 14's one-card run of the same
# weights and first tokens (its twin), over its first SERVE_PROMPT + new
# steps (SERVE_NEW unless the run says). qwen2.5-3b's 2 kv heads
# stay whole at M = 4 (the cache's slots split, 512 a rank) and split at
# M = 2; deepseek-moe-16b's 16 split 4 a rank, its experts' width split;
# zamba2-7b's 32 split 8 a rank and its mixers 4 ways (1824 of the 7296
# conv channels, 28 of 112 SSM heads a rank); mamba2-780m's mixers 2 ways
# (1664 of 3328 conv channels, 24 of 48 heads), 4 rows a dp group;
# whisper-tiny's 6 kv heads split 3 a rank at M = 2 in both caches, and
# stay whole at M = 4 (the self cache's 448 slots split, 112 a rank, the
# cross cache whole on every rank). The SSM runs take 8 + 8 steps and the
# whisper runs 8 + 16 for the script's time limit.
TP_SERVE_RUNS = {
    "qwen2.5-3b:seq": dict(arch="qwen2.5-3b", data=1, model=4, layout="seq"),
    "qwen2.5-3b:heads": dict(arch="qwen2.5-3b", data=2, model=2,
                             layout="heads"),
    "deepseek-moe-16b": dict(arch="deepseek-moe-16b", data=1, model=4,
                             layout="heads"),
    "zamba2-7b": dict(arch="zamba2-7b", data=1, model=4, layout="heads",
                      new=8),
    "mamba2-780m": dict(arch="mamba2-780m", data=2, model=2, layout="ssm",
                        new=8),
    "whisper-tiny:heads": dict(arch="whisper-tiny", data=2, model=2,
                               layout="heads", new=16),
    "whisper-tiny:seq": dict(arch="whisper-tiny", data=1, model=4,
                             layout="seq", new=16),
}
# the frames of the encoder-decoder runs' teacher-forced leg (serve.run's
# zero frames give an all-zero cross cache)
TP_SERVE_FRAMES_SEED = 15
# the axes a serving run's layout splits, beside the SSD's channels and
# heads for the SSM and hybrid families
TP_SERVE_LAYOUTS = {"seq": {"kv_seq"}, "heads": {"kv_heads"}, "ssm": set()}
TP_SERVE_RTOL = 1e-5  # and a floor of 1e-5 of the step's largest logit
TP_SERVE_MARGIN = 1e-3  # tests/test_torch_serve.py's near-tie of the top 2
TP_STEPS = 3
# an MoE run against its twin: a flipped token's top-k gap in the twin up
# to the first step with a flipped token (the weights apart by last-ulp
# sums) and after it (apart by Adam steps of up to 2 lr), and a loss's
# relative difference from that first step on (my chip runs at published
# widths: gaps at most 1.8e-7 and 6.4e-5, losses 6.6e-5 apart)
TP_ROUTE_TIE = ROUTE_TIE
TP_DRIFT_TIE = 1e-4
TP_FLIP_LOSS_RTOL = 5e-4
TP_SORT_BYTES = 32  # the dense fallback's sort, a byte count an element
# the SSD's decay leaves, held to the twin at rtol 1e-4: their gradients
# carry a float32 spread of that size (tests/test_torch_ssd.py)
TP_DECAY_LEAVES = ("mixer.A_log", "mixer.dt_bias")
TP_DECAY_RTOL = 1e-4
TP_TIMEOUT = 900.0  # seconds for the 4 ranks of every config


def _tp_config(name: str):
    from repro_torch import configs

    run = TP_RUNS[name]
    cfg = configs.get_config(run["arch"]).replace(**run.get("fields", {}))
    return cfg if run["layers"] is None else cfg.replace(n_layers=run["layers"])


def _step_flips(got: dict, want: dict, steps: int, forwards: int,
                top_k: int, label: str) -> dict:
    """Two training runs' MoE routings (``_Routes``' ``maps`` and
    ``probs``, ``steps`` equal runs of calls, the first ``forwards`` of
    each the step's forward; remat routes each layer again, the same way,
    in the backward) compared step by step. Every token whose chosen
    experts differ is held by ``_route_flips``' near-tie rule against
    ``want``'s probabilities, within ``TP_ROUTE_TIE`` up to the first step
    with a flipped token and ``TP_DRIFT_TIE`` after it; a token that
    chose alike but is kept or dropped differently is excused only after
    a flipped token of its group (its slots come after that token's),
    and raises otherwise. Per step: the (token, choice) routings to an
    expert ``want``'s token did not choose, the flipped tokens' top-k gaps
    in ``want``, the largest difference of their probabilities between
    the runs, and the tokens kept or dropped differently."""
    if len(got["maps"]) != len(want["maps"]) or len(want["maps"]) % steps:
        raise AssertionError(f"{label}: routings of {len(got['maps'])} and "
                             f"{len(want['maps'])} calls over {steps} steps")
    per = len(want["maps"]) // steps
    out = {"flips": [], "tie_gaps": [], "prob_diffs": [], "kept_apart": []}
    for t in range(steps):
        calls = slice(t * per, t * per + forwards)
        (a, pa), (b, pb) = ((torch.stack(r["maps"][calls]).cpu(),
                             torch.stack(r["probs"][calls]).cpu())
                            for r in (got, want))  # [calls, tokens, experts]
        ca, cb = a > 0, b > 0
        E = a.shape[-1]
        # each (call, token) a row of one position
        tie = TP_DRIFT_TIE if any(out["flips"]) else TP_ROUTE_TIE
        rows, gaps = _route_flips(*(x.reshape(1, -1, 1, E) for x in
                                    (ca.to(torch.int8), cb.to(torch.int8), pb)),
                                  top_k, f"{label}, step {t}", tie=tie)
        flipped = (rows == 0).reshape(a.shape[:2])
        apart = (a != b).any(-1) & ~flipped
        for c in range(a.shape[0]):
            hit, first = apart[c].nonzero(), flipped[c].nonzero()
            if len(hit) and (not len(first) or hit[0, 0] <= first[0, 0]):
                raise AssertionError(
                    f"{label}, step {t}, call {c}: token {int(hit[0, 0])} "
                    "chose the same experts, kept or dropped differently, "
                    "with no flipped token before it in its group")
        out["flips"].append(int((ca & ~cb).sum()))
        out["tie_gaps"].append(gaps)
        out["prob_diffs"].append(
            (pa - pb).abs().amax(-1)[flipped].tolist())
        out["kept_apart"].append(int(apart.sum()))
    return out


def _tp_dist(fastpath: str):
    from repro_torch.core import distributed as td
    from repro_torch.core.sparsify import SparsifierConfig
    from repro_torch.optim import OptConfig

    return td.DistConfig(
        sparsifier=SparsifierConfig(kind="regtopk", sparsity=FAMILY_SPARSITY),
        optimizer=OptConfig(kind="adam", learning_rate=FAMILY_LR),
        fastpath=fastpath)


def tp_prediction(name: str) -> dict:
    """Phase 15 (c)'s memory, predicted on the meta device (no CUDA call):
    one rank's tensor-parallel step traced by ``launch.dryrun.count_layout``
    at the run's layout, batch and float32 (the round with the fastpath
    off, which the kernel's certificate falls back to), plus
    ``TP_SORT_BYTES`` an element of the rank's largest block for the
    fallback's sort (a library op's workspace, which the trace cannot
    see); times the ranks for the card's sum. On any machine: ``python -c
    'import chip_smoke as c; print(c.tp_prediction("qwen2.5-3b"))'`` with
    ``PYTHONPATH=src`` (a ``TP_RUNS`` name)."""
    from repro_torch.launch import dryrun
    from repro_torch.tree import tree_leaves

    run, cfg = TP_RUNS[name], _tp_config(name)
    W, M = run["data"], run["model"]
    lay = dryrun.layout_of(cfg, _tp_dist("off"), {"data": W, "model": M},
                           run["batch"], run.get("seq", FAMILY_SEQ))
    rank = dryrun.count_layout(lay)
    big = max(p.local_len for p in tree_leaves(lay.plan))
    per_rank = rank["resident"] + rank["cost"]["peak_bytes"] + TP_SORT_BYTES * big
    return {"layers": cfg.n_layers, "rank_bytes": per_rank,
            "sum_bytes": W * M * per_rank,
            "rank_collective_bytes": rank["collectives"][1]}


def _tp_pooled(diffs: list, adam_step: float) -> dict:
    """The ranks' ``_param_diff`` results pooled, with ``_param_diff``'s
    ``ok`` rule over the pool."""
    pool = {"mismatches": sum(x["mismatches"] for x in diffs),
            "largest_rel_diff": max(x["largest_rel_diff"] for x in diffs),
            "beyond_rtol": sum(x["beyond_rtol"] for x in diffs),
            "max_abs_diff": max(x["max_abs_diff"] for x in diffs),
            "n": sum(x["n"] for x in diffs)}
    pool["ok"] = pool["beyond_rtol"] == 0 or (
        pool["beyond_rtol"] <= 1e-3 * pool["n"]
        and pool["max_abs_diff"] <= adam_step)
    return pool


def _tp_timed(fn, times: dict, model_group):
    """``fn(x, groups)`` (``_psum`` or ``_gather``) that adds its host
    seconds, the card synchronised on entry and exit, to ``times``
    under its name and whether it ran over the model group or a dp
    group."""
    def timed(x, groups):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(x, groups)
        torch.cuda.synchronize()
        key = (f"{fn.__name__.strip('_')}:"
               f"{'model' if tuple(groups) == (model_group,) else 'dp'}")
        times[key] = times.get(key, 0.0) + time.perf_counter() - t0
        return out
    return timed


@contextlib.contextmanager
def _tp_profile(rank: int, comm: dict, model_group):
    """The block with the model group's collectives timed into ``comm``
    (``_tp_timed``) and, on rank 0, under the torch profiler, which it
    yields (None on the other ranks)."""
    from repro_torch.comm import collectives

    plain = collectives._psum, collectives._gather
    collectives._psum = _tp_timed(plain[0], comm, model_group)
    collectives._gather = _tp_timed(plain[1], comm, model_group)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    try:
        with (torch.profiler.profile(activities=acts) if rank == 0
              else contextlib.nullcontext()) as prof:
            yield prof
    finally:
        collectives._psum, collectives._gather = plain


def _tp_arch(rank: int, device: str, name: str, out_dir: str) -> dict:
    """One run of phase 15 (c) on this gloo rank (see ``_tp_rank_body``):
    its numbers, the on == off comparison and the difference from the
    twin; rank 0 also saves the MoE routings of the fastpath-on run."""
    import hashlib

    import torch.distributed as dist

    from repro_torch.comm.fastpath import FastpathCounts
    from repro_torch.core import distributed as td
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import fused_encode as fe
    from repro_torch.launch import mesh
    from repro_torch.models import param_axes
    from repro_torch.nn.sharding import shard_params
    from repro_torch.optim import make_optimizer
    from repro_torch.tree import tree_items, tree_leaves, tree_map

    t_start = time.perf_counter()
    run = TP_RUNS[name]
    W, M = run["data"], run["model"]
    groups = mesh.make_host_groups(model=M)
    cfg = _tp_config(name)
    saved = torch.load(f"{out_dir}/{name}.pt", mmap=True)
    p0 = _nested(torch.load(f"{out_dir}/{run['arch']}.p0.pt", mmap=True))
    fastpaths = ("on", "off") if run.get("off", True) else ("on",)
    plans = {fastpath: td.build_plan(
        p0, FAMILY_SPARSITY, _tp_dist(fastpath), axes=param_axes(cfg),
        mesh={"data": W, "model": M}) for fastpath in fastpaths}
    specs = tree_map(lambda p: p.spec, plans["on"])
    blocks0 = shard_params(p0, specs, groups.shard, M)
    split = {path: td.split_dim(p) is not None
             for path, p in tree_items(plans["on"])}
    out, on = {}, None
    stages = {"load": time.perf_counter() - t_start}
    for fastpath, plan in plans.items():
        t_run = time.perf_counter()
        dcfg = _tp_dist(fastpath)
        params = tree_map(lambda x: x.to(device), blocks0)
        counts = FastpathCounts()
        step = td.make_train_step(cfg, dcfg, plan, W, counts, groups)
        opt_state = make_optimizer(dcfg.optimizer).init(params)
        sp = td.init_sparsifier_state(plan, 1, device, shards=1)
        pipe = TokenPipeline(cfg, run["batch"], run.get("seq", FAMILY_SEQ),
                             0, device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fe.fused_candidates.launches = 0
        torch.cuda.synchronize()
        dist.barrier()
        losses, times, comm, prof = [], [], {}, None
        with (_Routes() if cfg.is_moe and fastpath == "on"
              else contextlib.nullcontext()) as routes:
            for t in range(TP_STEPS):
                # the last run's last step under the profiler (the off
                # run's where there is one): the model group moves what it
                # moves with the fastpath on, and no step is added
                profiled = fastpath == fastpaths[-1] and t == TP_STEPS - 1
                t0 = time.perf_counter()
                with (_tp_profile(rank, comm, groups.model_group) if profiled
                      else contextlib.nullcontext()) as got_prof:
                    params, opt_state, sp, m = step(params, opt_state, sp,
                                                    pipe.batch_at(t))
                    losses.append(float(m["loss"]))
                    torch.cuda.synchronize()
                prof = got_prof if profiled else prof
                times.append(time.perf_counter() - t0)
        if routes is not None and rank == 0:
            torch.save({"maps": [x.cpu() for x in routes.maps],
                        "probs": [x.cpu() for x in routes.probs]},
                       f"{out_dir}/{name}.routes.pt")
        del routes
        row = {"losses": losses, "launches": fe.fused_candidates.launches,
               "step_s": times, "hit_rate": counts.hit_rate,
               "peak_bytes": torch.cuda.max_memory_allocated(),
               "reserved_bytes": torch.cuda.max_memory_reserved(),
               # the caches keep what the steps reserved: the card's free
               # bytes now are its headroom at the steps' peak
               "card_free_bytes": torch.cuda.mem_get_info()[0],
               "fused_leaves": sum(p.fused for p in tree_leaves(plan))}
        stages[fastpath] = time.perf_counter() - t_run
        if fastpath == fastpaths[-1]:
            row["comm_s"] = comm
            if rank == 0:
                evs = prof.key_averages()
                row["device_ms"] = sum(
                    ev.self_device_time_total for ev in evs
                    if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3
                row["collective_ops"] = {
                    ev.key: [ev.count, ev.cpu_time_total / 1e3] for ev in evs
                    if any(w in ev.key.replace("_", "") for w in
                           ("allreduce", "allgather"))}
        if fastpath == "on":
            t_check = time.perf_counter()
            h = hashlib.sha256()
            for path, x in tree_items(params):
                if not split[path]:
                    h.update(x.cpu().view(torch.int32).numpy().tobytes())
            row["whole_digest"] = h.hexdigest()
            row["block_shapes"] = {path: list(x.shape)
                                   for path, x in tree_items(params)}
            # the twin's blocks, compared on the card; rank 0 also holds
            # the whole leaves to it
            mine = shard_params(saved["twin"], dict(tree_items(specs)),
                                groups.shard, M)
            got = {k: x for k, x in tree_items(params)
                   if split[k] or rank == 0}
            want = {k: mine[k].to(device) for k in got}
            decay = {k for k in got if k.endswith(TP_DECAY_LEAVES)}
            row["vs_twin"] = _param_diff(
                {k: x for k, x in got.items() if k not in decay},
                {k: x for k, x in want.items() if k not in decay},
                2 * FAMILY_LR * TP_STEPS, floors=saved["floors"])
            if decay:  # the SSD's A_log and dt_bias at TP_DECAY_RTOL
                row["decay_vs_twin"] = _param_diff(
                    {k: got[k] for k in decay}, {k: want[k] for k in decay},
                    2 * FAMILY_LR * TP_STEPS, floors=saved["floors"],
                    rtol=TP_DECAY_RTOL)
            # the router, a whole leaf, also on its own
            router = [k for k in got if k.endswith("router")]
            if router:
                row["router_vs_twin"] = _param_diff(
                    {k: got[k] for k in router}, {k: want[k] for k in router},
                    2 * FAMILY_LR * TP_STEPS, floors=saved["floors"])
            del mine, got, want
            stages["checked"] = time.perf_counter() - t_check
        if fastpath == "on" and len(fastpaths) > 1:  # kept on the host
            on = (tree_map(lambda x: x.cpu(), params),
                  [[x.cpu() for x in st] for st in tree_leaves(sp)], losses)
        elif fastpath == "off":  # compared on the card, one leaf at a time
            out["on_off_param_mismatches"] = sum(
                _bit_mismatches(x.to(device), y) for (_, x), (_, y) in
                zip(tree_items(on[0]), tree_items(params), strict=True))
            out["on_off_state_equal"] = all(
                _bits_equal(x.to(device), y)
                for a, b in zip(on[1], tree_leaves(sp), strict=True)
                for x, y in zip(a, b, strict=True))
            out["on_off_losses_equal"] = on[2] == losses
        out[fastpath] = row
        del params, opt_state, sp, step
    out["shard"], out["worker"] = groups.shard, groups.rank
    out["stages_s"] = stages
    torch.cuda.empty_cache()
    return out


class _TpCounted:
    """While active, the model group's collectives (``_psum`` and
    ``_gather`` over ``model_group``) counted: calls, bytes returned and
    host seconds, the card synchronised around each."""

    def __init__(self, model_group):
        self.group, self.calls, self.bytes, self.seconds = model_group, 0, 0, 0.0

    def __enter__(self):
        from repro_torch.comm import collectives

        self._plain = collectives._psum, collectives._gather

        def counted(fn):
            def call(x, groups):
                if tuple(groups) != (self.group,):
                    return fn(x, groups)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(x, groups)
                torch.cuda.synchronize()
                self.seconds += time.perf_counter() - t0
                self.calls += 1
                self.bytes += out.numel() * out.element_size()
                return out
            return call

        collectives._psum, collectives._gather = map(counted, self._plain)
        return self

    def __exit__(self, *exc):
        from repro_torch.comm import collectives

        collectives._psum, collectives._gather = self._plain


def _tp_serve_steps(run: dict) -> int:
    """The greedy steps a serving run of phase 15 (c) takes and holds."""
    return SERVE_PROMPT + run.get("new", SERVE_NEW)


def _tp_serve_held(got, ref, axes, shard, index: int, rows: slice,
                   first_diff, flips, steps: int):
    """``(ref's block, the mask of its held entries)`` of one cache leaf:
    the twin's whole leaf ``ref`` cut to the rank's rows and to its block
    ``index`` of every axis the serving ``shard`` splits. A slot of the KV
    cache is held up to a row's first token apart from the twin's and
    before its first routing flip; a recurrent state (the conv window, the
    SSM state) only where the row's inputs were the twin's at every
    step; a cross cache (over ``enc_seq``), which no token writes,
    throughout."""
    idx, slot_dim = [], None
    for dim, name in enumerate(axes):
        if name == "batch":
            idx.append(rows)
        elif name is not None and shard.splits(name):
            n = got.shape[dim]
            idx.append(slice(index * n, (index + 1) * n))
        else:
            idx.append(slice(None))
        if name == "kv_seq":
            slot_dim = dim
    ref = ref[tuple(idx)]
    b = list(axes).index("batch")
    shape = [1] * got.dim()
    shape[b] = got.shape[b]
    if "enc_seq" in axes:
        keep = torch.ones(shape, dtype=torch.bool)
    elif slot_dim is None:
        keep = ((first_diff >= steps - 1) & (flips >= steps)).reshape(shape)
    else:
        first = idx[slot_dim].start or 0
        slot = first + torch.arange(got.shape[slot_dim])
        keep = (slot[None, :] <= first_diff[:, None]) & (slot[None, :] < flips[:, None])
        shape[slot_dim] = got.shape[slot_dim]
        keep = keep.reshape(shape)
    return ref, keep.expand_as(got)


def _tp_serve_config(arch: str):
    """Phase 14's config of ``arch``: its depth cut where ``SERVE_RUNS``
    says."""
    from repro_torch import configs

    cfg = configs.get_config(arch)
    layers = SERVE_RUNS[arch].get("layers")
    return cfg.replace(n_layers=layers) if layers else cfg


def _tp_logits_held(steps: list, want: torch.Tensor, held: torch.Tensor,
                    device: str) -> tuple:
    """``(rows beyond, largest |diff|, its largest share of the allowed)``
    of each step's logits ``steps[t] [n, V]`` against the twin's ``want[:,
    t]`` at the rows ``held[:, t]``: rtol ``TP_SERVE_RTOL`` with a floor of
    as much of the step's largest."""
    err = worst = 0.0
    beyond = 0
    for t, got in enumerate(steps):
        ref = want[:, t].to(device)
        diff = (got - ref).abs()
        limit = TP_SERVE_RTOL * (ref.abs() + ref.abs().amax(-1, keepdim=True))
        keep = held[:, t].to(device)
        beyond += int(((diff > limit).any(-1) & keep).sum())
        if bool(keep.any()):
            err = max(err, diff[keep].max().item())
            worst = max(worst, (diff / limit)[keep].max().item())
    return beyond, err, worst


def _tp_cache_held(mine: dict, refs: dict, axes: dict, shard, index: int,
                   rows: slice, first_diff, flips, steps: int) -> tuple:
    """``(held, largest |diff|)`` of a rank's cache blocks ``mine`` (by
    dotted path, ``pos`` aside) against the twin's whole leaves ``refs``
    at the entries ``_tp_serve_held`` holds, to rtol ``TP_SERVE_RTOL``
    with a floor of as much of the leaf's largest."""
    err, ok = 0.0, set(mine) - {"pos"} == set(refs) - {"pos"}
    for leaf in sorted(set(mine) - {"pos"}):
        got = mine[leaf].cpu()
        ref, keep = _tp_serve_held(got, refs[leaf], axes[leaf], shard, index,
                                   rows, first_diff, flips, steps)
        if got.shape != ref.shape:
            ok = False
            continue
        diff = (got - ref).abs()[keep]
        limit = TP_SERVE_RTOL * (ref.abs()[keep] + ref.abs().max())
        ok &= bool((diff <= limit).all())
        err = max(err, float(diff.max()) if diff.numel() else 0.0)
    return ok, err


def _tp_serve_forced(arch: str, mod, cfg, p0, groups, device: str, rows: slice,
                     batch: int, max_len: int, twin_dir: str) -> dict:
    """An encoder-decoder run's teacher-forced leg on this rank: its blocks
    of the weights, the cross cache that ``build_cross_cache(..., shard)``
    makes of its rows of the twin's seeded frames, then the twin's tokens
    fed to as many decode steps; each step's logits and every block of the
    cache after them held against the twin's one-card leg
    (``_serve_twin_forced``), and whether ``ck`` and ``cv`` hold a value
    that is not zero."""
    from repro_torch.launch import serve
    from repro_torch.nn.sharding import shard_params
    from repro_torch.tree import tree_items, tree_map

    t0 = time.perf_counter()
    twin = torch.load(f"{twin_dir}/{arch}.serve.forced.pt", mmap=True)
    specs, _, shard = serve.serve_layout(
        cfg, p0, batch, max_len, groups.mesh_shape, groups.axis_names,
        groups.model_group, groups.shard)
    params = tree_map(lambda x: x.to(device),
                      shard_params(p0, specs, groups.shard, groups.model))
    tokens = twin["tokens"][rows]
    n, T = tokens.shape
    with torch.inference_mode():
        cache = mod.init_cache(cfg, n, max_len, device=device, shard=shard)
        cache["ck"], cache["cv"] = mod.build_cross_cache(
            params, cfg, twin["frames"][rows].to(device), shard=shard)
        nonzero = {k: bool(cache[k].abs().amax() > 0) for k in ("ck", "cv")}
        logits = _forced(mod, cfg, params, cache, tokens.to(device),
                         shard=shard)[..., :cfg.vocab]
        held = torch.ones((n, T), dtype=torch.bool)
        beyond, err, worst = _tp_logits_held(list(logits.unbind(1)),
                                             twin["logits"][rows], held, device)
    full = torch.full((n,), T)
    cache_ok, cache_err = _tp_cache_held(
        dict(tree_items(cache)), twin["cache"], dict(tree_items(mod.cache_axes(cfg))),
        shard, groups.shard, rows, full, full, T)
    return {"steps": T, "cross_nonzero": nonzero, "logits_beyond": beyond,
            "max_abs_err": err, "worst_share_of_allowed": worst,
            "cache_ok": cache_ok, "cache_max_abs_err": cache_err,
            "seconds": time.perf_counter() - t0}


def _tp_serve(rank: int, device: str, name: str, twin_dir: str) -> dict:
    """One serving run of phase 15 (c) on this gloo rank (see
    ``model_parallel_tp``): ``serve.run(..., mesh=)`` from the rank's
    blocks of phase 14's weights, its dp group's rows, recorded
    (``_ServeRecorder``; the model group's collectives counted over the
    untimed steps) and held against the twin's recorded run: each step's
    logits and each slot of the final cache block up to a row's first
    token that differs from the twin's (the inputs are the twin's up to
    there) and, for an MoE, before the row's first routing flip (a
    near-tie, ``_route_flips``, or it raises); each recurrent state of the
    cache where its row's inputs were the twin's throughout
    (``_tp_serve_held``); ``pos``; and the first differing token at a
    near-tie of the twin's top 2 or after a flip. The run takes its first
    ``_tp_serve_steps`` of the twin's steps. An encoder-decoder run then
    adds its teacher-forced leg (``_tp_serve_forced``)."""
    import torch.distributed as dist

    from repro_torch.launch import mesh, serve
    from repro_torch.models import get_family
    from repro_torch.tree import tree_items

    run = TP_SERVE_RUNS[name]
    arch, W, M = run["arch"], run["data"], run["model"]
    prompt, new = SERVE_PROMPT, run.get("new", SERVE_NEW)
    srv = SERVE_RUNS[arch]
    B, max_len = srv["batch"], srv["max_len"]
    cfg = _tp_serve_config(arch)
    mod = get_family(cfg)
    groups = mesh.make_host_groups(model=M)
    t0 = time.perf_counter()
    p0 = _nested(torch.load(f"{twin_dir}/{arch}.serve.p0.pt", mmap=True))
    twin = torch.load(f"{twin_dir}/{arch}.serve.twin.pt", mmap=True)
    n = B // W
    rows = slice(groups.rank * n, (groups.rank + 1) * n)
    stages = {"load": time.perf_counter() - t0}
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    comm = _TpCounted(groups.model_group)
    with _ServeRecorder(mod, cfg.vocab, comm, prompt) as rec, \
            (_Routes() if cfg.is_moe else contextlib.nullcontext()) as routes:
        res = serve.run(serve.parse_args([
            "--arch", arch, "--batch", str(B), "--prompt-len", str(prompt),
            "--new-tokens", str(new), "--max-len", str(max_len), "--device",
            device]), params=p0, cfg=cfg, mesh=groups)
    peak = torch.cuda.max_memory_allocated()
    stages["serve"] = time.perf_counter() - t0
    forced = None
    if cfg.family == "encdec":
        forced = _tp_serve_forced(arch, mod, cfg, p0, groups, device, rows, B,
                                  max_len, twin_dir)
        stages["forced"] = forced["seconds"]
    t0 = time.perf_counter()
    del p0
    shard, cache = rec.shard, rec.cache
    T = prompt + new
    seq, want = twin["seq"][rows, :T + 1], twin["logits"][rows, :T]
    served = torch.cat([res.prompt, res.tokens], 1)
    # each row's first step whose token differs from the twin's (T: none);
    # up to it the rank's inputs are the twin's
    first_diff = torch.tensor([
        int(d[0, 0]) if len(d := (served[r] != seq[r, 1:]).nonzero()) else T
        for r in range(n)])
    flips, gaps = torch.full((n,), T), []
    if routes is not None:
        L = cfg.n_layers
        mine, tw, probs = (_per_layer(m, T * L, k).reshape(T, L, k, -1)
                           [:, :, sl].permute(1, 2, 0, 3)
                           for m, k, sl in ((routes.maps, n, slice(None)),
                                            (twin["routes"]["maps"], B, rows),
                                            (twin["routes"]["probs"], B, rows)))
        for r in range(n):  # past its first differing token a row's inputs differ
            mine[:, r, first_diff[r] + 1:] = tw[:, r, first_diff[r] + 1:]
        flips, gaps = _route_flips(mine, tw, probs, cfg.moe_top_k,
                                   f"serve tensor parallel {name}")
    held = ((torch.arange(T)[None, :] <= first_diff[:, None])
            & (torch.arange(T)[None, :] < flips[:, None]))
    with torch.inference_mode():
        beyond, err, worst = _tp_logits_held(rec.logits[:T], want, held, device)
    # every cache block against the twin's after the same steps, at the
    # entries held (a ring would put position p at slot p % slots; these
    # runs have none)
    if cfg.sliding_window:
        raise ValueError(f"{name}: the cache check reads slots as positions")
    mine = dict(tree_items(cache))
    cache_ok, cache_err = _tp_cache_held(
        mine, twin["caches"][T], dict(tree_items(mod.cache_axes(cfg))), shard,
        groups.shard, rows, first_diff, flips, T)
    # a row's first differing token: at a near-tie of the twin's top 2, or
    # after a routing flip
    top2 = want.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    tokens_ok = all(int(t) == T or margin[r, t] < TP_SERVE_MARGIN or t >= flips[r]
                    for r, t in enumerate(first_diff))
    stages["check"] = time.perf_counter() - t0
    return {"split": sorted(shard.split), "rows": [rows.start, rows.stop],
            "cache_leaves": len(mine) - 1,
            "step_ms": statistics.median(res.step_ms),
            "tokens_per_s": res.tokens_per_s, "peak_bytes": peak,
            "block_bytes": {"params": rec.param_bytes, "cache": _tree_bytes(cache)},
            "logits_held": int(held.sum()), "positions": n * T,
            "logits_beyond": beyond,
            "max_abs_err": err, "worst_share_of_allowed": worst,
            "flips": [int(f) for f in flips], "tie_gaps": gaps,
            "first_token_diffs": [int(t) for t in first_diff],
            "tokens_ok": tokens_ok,
            "cache_ok": cache_ok, "cache_max_abs_err": cache_err,
            "pos": int(cache["pos"]), "steps": T,
            "comm": {"calls": comm.calls / prompt,
                     "bytes": comm.bytes / prompt,
                     "seconds": comm.seconds / prompt},
            "traffic": {k: (v - rec.traffic0.get(k, 0)) / T
                        for k, v in shard.traffic.items()},
            "forced": forced, "stages_s": stages}


def _nested(flat: dict) -> dict:
    """``{dotted path: leaf}`` as the nested tree it came from."""
    out: dict = {}
    for path, x in flat.items():
        *head, last = path.split(".")
        d = out
        for key in head:
            d = d.setdefault(key, {})
        d[last] = x
    return out


def _tp_rank_body(rank: int, world: int, store: str, out_dir: str,
                  device: str, twin_dir=None) -> None:
    """One of phase 15 (c)'s 4 gloo ranks on ``device``: each run of
    ``TP_RUNS`` in turn, trained tensor parallel from the rank's blocks of
    the weights the parent drew (``out_dir/<arch>.p0.pt``) and held
    against the parent's one-card twin (``out_dir/<run>.pt``: its trained
    params ``twin`` and each leaf's largest magnitude ``floors``),
    ``TP_STEPS`` steps with the fastpath on (kernel 1's launches counted,
    an MoE run's routings logged), then, unless the run says ``off=False``,
    the same steps with the fastpath off; the last step of the last of
    them with the model group's collectives timed and, on rank 0, under
    the profiler. Each rank writes, per run, its numbers, the on == off
    comparison in bits, its blocks' difference from the twin's params
    (rank 0 also the whole leaves) and the digest of its whole leaves to
    ``out_dir/rank{rank}.json``. Then, given phase 14's twins in
    ``twin_dir``, each serving run of ``TP_SERVE_RUNS`` (``_tp_serve``)."""
    import torch.distributed as dist

    from repro_torch.launch import mesh

    torch.cuda.set_device(device)
    mesh.init_file_store(store, rank, world, "gloo")
    try:
        out = {name: _tp_arch(rank, device, name, out_dir) for name in TP_RUNS}
        if twin_dir is not None:
            out["serve"] = {name: _tp_serve(rank, device, name, twin_dir)
                            for name in TP_SERVE_RUNS}
        Path(f"{out_dir}/rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def _tp_weights(arch: str, cfg, twin_dir=None):
    """``cfg``'s seeded weights on the host: the first ``n_layers`` of
    phase 14's saved weights of ``arch`` where ``twin_dir`` holds
    enough of them (``init`` draws the embedding, then the layers one
    after another from one generator, so a shallower model's draws are a
    prefix of a deeper one's), else drawn."""
    from repro_torch.models import get_family

    path = f"{twin_dir}/{arch}.serve.p0.pt"
    if twin_dir is None or not os.path.exists(path):
        return get_family(cfg).init(cfg, seed=0, device="cpu")
    saved = torch.load(path, mmap=True)
    if "layers.norm1.scale" not in saved or (
            saved["final_norm.scale"].shape != (cfg.d_model,)) or (
            saved["layers.norm1.scale"].shape[0] < cfg.n_layers):
        return get_family(cfg).init(cfg, seed=0, device="cpu")
    # the layers cut into their own storage: torch.save writes a view's
    # whole storage
    return _nested({k: x[:cfg.n_layers].clone() if k.startswith("layers.")
                    else x for k, x in saved.items()})


def model_parallel_tp(smi: str, device=None, twin_dir=None) -> dict:
    """Phase 15 (c): tensor parallelism at published widths across 4 gloo
    ranks sharing the card, fastpath on, RegTop-k at S = 0.01, Adam, 3
    steps, float32: each ``TP_RUNS`` run after its one-card twin
    (``mesh=None`` at the same layout, run first, its weights and result
    handed to the ranks), held against it (losses to rtol 1e-5, params by
    ``_param_diff``'s rule), fastpath on == off in bits on every rank
    (deepseek-moe-16b's expert layout runs with the fastpath on only, to
    save the script's time), every whole leaf equal in bits across the
    ranks, each rank holding its blocks, kernel 1 once per fused leaf a
    step on every rank; the step time beside the twin's, each rank's peak
    and their sum beside ``tp_prediction``, the card's free bytes before
    the spawn and after the steps, each stage's seconds, and the model
    group's collectives a step (host clock, rank 0, the card synchronised
    around each) under the profiler. For an MoE run, rank 0's routings of
    each step's forward against the twin's (``_Routes``, ``_step_flips``):
    a last-ulp difference between the row-parallel sums and the twin's
    whole ones can flip a near-tied top-k choice, which moves its token's
    output by the gate times the difference of two experts' outputs, so
    its loss. A token that chose other experts fails unless the twin's
    top-k gap there is within ``TP_ROUTE_TIE`` (``TP_DRIFT_TIE`` after the
    first step with a flipped token, whose Adam steps move the weights
    apart by more than last ulps), a token kept or dropped
    differently fails unless a flipped token of its group came before it,
    and the (token, choice) routings that differ are counted a step. The
    losses are held to rtol 1e-5 at every step before the first step with
    a flipped token and to ``TP_FLIP_LOSS_RTOL`` from it on; the params by
    ``_param_diff``'s rule, and the router, a whole leaf, by the same rule
    on its own. Every number is printed before a failed comparison with
    the twin raises. One spawn runs every run."""
    import tempfile

    from repro_torch.launch import mesh
    from repro_torch.models import get_family
    from repro_torch.tree import tree_items

    device = device or f"{DEVICE}:0"
    twins, launches = {}, 0
    world = {run["data"] * run["model"] for run in (
        *TP_RUNS.values(), *(TP_SERVE_RUNS.values() if twin_dir else ()))}
    if len(world) != 1:
        raise ValueError(f"phase 15 (c) runs every config on one world: {world}")
    with tempfile.TemporaryDirectory() as d:
        drawn = {}  # arch -> its seeded weights, drawn once for its runs
        for name, run in TP_RUNS.items():
            cfg = _tp_config(name)
            t0 = time.perf_counter()
            arch = run["arch"]
            if arch not in drawn:
                drawn.clear()
                drawn[arch] = _tp_weights(arch, cfg, twin_dir)
                torch.save(dict(tree_items(drawn[arch])), f"{d}/{arch}.p0.pt")
            params0 = drawn[arch]
            stages = {"init": time.perf_counter() - t0}
            with (_Routes() if cfg.is_moe
                  else contextlib.nullcontext()) as routes:
                params, _, plan, losses, n, seconds, peak = _mp_train(
                    cfg, params0, run["data"], run["model"], "on",
                    batch=run["batch"], seq=run.get("seq", FAMILY_SEQ))
            if routes is not None:
                routes = {"maps": [x.cpu() for x in routes.maps],
                          "probs": [x.cpu() for x in routes.probs]}
            twin = {k: x.cpu() for k, x in tree_items(params)}
            del params, _
            torch.cuda.empty_cache()
            stages["twin"] = time.perf_counter() - t0 - stages["init"]
            t0 = time.perf_counter()
            torch.save({"twin": twin,
                        "floors": {k: float(x.abs().max())
                                   for k, x in twin.items()}},
                       f"{d}/{name}.pt")
            del params0, twin
            stages["save"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            prediction = tp_prediction(name)
            stages["predict"] = time.perf_counter() - t0
            launches += n
            twins[name] = {"plan": plan, "losses": losses, "launches": n,
                           "seconds": seconds, "peak": peak,
                           "layers": cfg.n_layers, "prediction": prediction,
                           "stages_s": stages, "routes": routes}
        drawn.clear()
        n_ranks = world.pop()
        # what the 4 ranks share: the card's free bytes with this process'
        # context and cache in place
        free0, total = torch.cuda.mem_get_info()
        parent = {"allocated": torch.cuda.memory_allocated(),
                  "reserved": torch.cuda.memory_reserved(),
                  "card_free": free0, "card_total": total}
        log(f"tensor parallel: before the spawn the card has {free0 / 1e9:.2f} "
            f"of {total / 1e9:.2f} GB free; this process holds "
            f"{parent['allocated'] / 1e9:.2f} GB allocated, "
            f"{parent['reserved'] / 1e9:.2f} reserved")
        t0 = time.perf_counter()
        mesh.spawn(_tp_rank_body, n_ranks, (f"{d}/store", d, device, twin_dir),
                   timeout=TP_TIMEOUT)
        spawn_s = time.perf_counter() - t0
        ranks = [json.loads(Path(f"{d}/rank{r}.json").read_text())
                 for r in range(n_ranks)]
        for name, tw in twins.items():
            if tw["routes"] is not None:
                if TP_RUNS[name]["data"] != 1:
                    raise ValueError(f"phase 15 (c) compares {name}'s rank 0 "
                                     "routings with the twin's at W = 1 only")
                tw["flips"] = _step_flips(
                    torch.load(f"{d}/{name}.routes.pt"), tw["routes"],
                    TP_STEPS, tw["layers"], _tp_config(name).moe_top_k,
                    f"tensor parallel {name}")
                # tokens x top-k
                tw["routings"] = tw["routes"]["maps"][0].shape[0] * _tp_config(
                    name).moe_top_k
            del tw["routes"]
    out = {"spawn_s": spawn_s, "before_spawn": parent}
    for name, run in TP_RUNS.items():
        W, M = run["data"], run["model"]
        tw = twins[name]
        plan, losses, pred = tw["plan"], tw["losses"], tw["prediction"]
        rks = [rk[name] for rk in ranks]
        on = [rk["on"] for rk in rks]
        with_off = run.get("off", True)
        n_fused = on[0]["fused_leaves"]
        for r, rk in enumerate(rks):
            off_launches = rk["off"]["launches"] if with_off else 0
            if (rk["on"]["launches"] != TP_STEPS * n_fused or not n_fused
                    or off_launches):
                raise AssertionError(
                    f"tensor parallel {name}: rank {r} launched kernel 1 "
                    f"{rk['on']['launches']} times on, {off_launches} "
                    f"off, expected {TP_STEPS} x {n_fused}")
            if with_off and (rk["on_off_param_mismatches"]
                             or not rk["on_off_state_equal"]
                             or not rk["on_off_losses_equal"]):
                raise AssertionError(
                    f"tensor parallel {name}: rank {r} fastpath on != off: "
                    f"{rk['on_off_param_mismatches']} param bit mismatches, "
                    f"state equal {rk['on_off_state_equal']}")
            if rk["on"]["whole_digest"] != on[0]["whole_digest"]:
                raise AssertionError(f"tensor parallel {name}: rank {r}'s whole "
                                     "leaves differ in bits from rank 0's")
            blocks = rk["on"]["block_shapes"]
            for path, p in tree_items(plan):
                if list(p.local_shape) != blocks[path]:
                    raise AssertionError(
                        f"tensor parallel {name}: {path} held as "
                        f"{blocks[path]}, its block is {p.local_shape}")
        adam_step = 2 * FAMILY_LR * TP_STEPS
        diff = _tp_pooled([o["vs_twin"] for o in on], adam_step)
        decays = [o["decay_vs_twin"] for o in on if "decay_vs_twin" in o]
        decay = _tp_pooled(decays, adam_step) if decays else None
        got = on[0]["losses"]
        route = tw.get("flips")
        flips = route["flips"] if route else None
        # a step's loss within rtol 1e-5 of the twin's, or within
        # TP_FLIP_LOSS_RTOL once a token has flipped in its forward or an
        # earlier one
        flipped = [bool(flips) and sum(flips[:t + 1]) > 0
                   for t in range(TP_STEPS)]
        loss_tol = [TP_FLIP_LOSS_RTOL if f else 1e-5 for f in flipped]
        loss_rel = [abs(g - w) / abs(w) for g, w in zip(got, losses, strict=True)]
        router = on[0].get("router_vs_twin")
        ok = (diff["ok"] and (router is None or router["ok"])
              and (decay is None or decay["ok"])
              and all(r <= tol for r, tol in zip(loss_rel, loss_tol, strict=True))
              and all(math.isfinite(x) for x in got))
        peaks = [o["peak_bytes"] for o in on]
        # the first step pays the card's and gloo's warm-up on every rank
        step_ms = statistics.median(1e3 * t for o in on for t in o["step_s"][1:])
        last = rks[0]["off" if with_off else "on"]  # its last step was profiled
        comm = last["comm_s"]
        launches += sum(o["launches"] for o in on)
        split = sum(p.local_shape != p.global_shape for _, p in tree_items(plan))
        row = {"layers": tw["layers"], "workers": W, "shards": M,
               "batch": run["batch"], "seq": run.get("seq", FAMILY_SEQ),
               "fields": run.get("fields", {}),
               "losses": got, "twin_losses": losses, "loss_rel_diff": loss_rel,
               "loss_held": [not f for f in flipped],
               "loss_tol": loss_tol, "vs_twin": diff, "decay_vs_twin": decay,
               "router_vs_twin": router, "route_flips": route,
               "routings_a_step": tw.get("routings"), "peaks": peaks,
               "reserved": [o["reserved_bytes"] for o in on],
               "peak_sum": sum(peaks), "prediction": pred,
               "twin_peak": tw["peak"],
               "twin_step_ms": 1e3 * tw["seconds"] / FAMILY_STEPS,
               "step_ms": step_ms, "rank_step_s": [o["step_s"] for o in on],
               "comm_s": comm, "device_ms": last["device_ms"],
               "collective_ops": last["collective_ops"],
               "launches": [o["launches"] for o in on], "fused_leaves": n_fused,
               "split_leaves": split, "hit_rate": on[0]["hit_rate"],
               "card_free": min(o["card_free_bytes"] for o in on),
               "parent_stages_s": tw["stages_s"],
               "rank_stages_s": [rk["stages_s"] for rk in rks]}
        out[name] = row
        cfg = _tp_config(name)
        frames = f" over {cfg.enc_seq} frames" if cfg.family == "encdec" else ""
        log(f"tensor parallel {name}: {tw['layers']} layers, (data, model) = "
            f"({W}, {M}), {W * M} gloo ranks on one card, batch {run['batch']} "
            f"x {run.get('seq', FAMILY_SEQ)}{frames}, {split}/"
            f"{len(tree_items(plan))} leaves split; "
            f"losses {got[0]:.4f} -> {got[-1]:.4f} (twin {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}; relative differences "
            f"{[float(f'{r:.3g}') for r in loss_rel]}, held to "
            f"{loss_tol}, {TP_FLIP_LOSS_RTOL} from a step with a flipped "
            "token on); params against the twin "
            f"{diff['mismatches']} bit mismatches, {diff['beyond_rtol']} of "
            f"{diff['n']} beyond rtol 1e-5 (largest |diff| "
            f"{diff['max_abs_diff']:.3e}, 2 lr a step {adam_step:.1e}); "
            + ("" if decay is None else
               f"the SSD's A_log and dt_bias {decay['beyond_rtol']} of "
               f"{decay['n']} beyond rtol {TP_DECAY_RTOL} (largest |diff| "
               f"{decay['max_abs_diff']:.3e}); ")
            + ("fastpath on == off in bits on every rank; " if with_off
               else "fastpath on only; ")
            + "whole leaves equal in "
            f"bits across the ranks; kernel 1 {on[0]['launches']} launches per "
            f"rank ({n_fused} fused leaves, hit rate {on[0]['hit_rate']:.3f})")
        if flips is not None:
            log(f"tensor parallel {name}: MoE routing flips against the twin, "
                f"(token, choice) routings to another expert in each step's "
                f"forward: {flips} of {row['routings_a_step']} a layer-step "
                f"x {tw['layers']} layers; the flipped tokens' top-"
                f"{_tp_config(name).moe_top_k} gaps in the twin "
                f"{[[float(f'{x:.3g}') for x in g] for g in route['tie_gaps']]}"
                f" (a near-tie is within {TP_ROUTE_TIE}, {TP_DRIFT_TIE} after "
                "the first step with a flip), their largest "
                "probability differences from the twin "
                f"{[[float(f'{x:.3g}') for x in g] for g in route['prob_diffs']]}"
                f", tokens kept or dropped differently after a flip "
                f"{route['kept_apart']}; the router against the twin "
                f"{router['beyond_rtol']} of {router['n']} beyond rtol 1e-5 "
                f"(largest |diff| {router['max_abs_diff']:.3e})")
        log(f"tensor parallel {name}: step {step_ms:.1f} ms (median over ranks "
            f"and steps 2-{TP_STEPS}, host clock; twin "
            f"{row['twin_step_ms']:.1f} ms a step over its {FAMILY_STEPS}); "
            f"peak per rank {[round(x / 1e9, 2) for x in peaks]} GB, sum "
            f"{sum(peaks) / 1e9:.2f} GB (predicted {pred['sum_bytes'] / 1e9:.2f}"
            f", {pred['rank_bytes'] / 1e9:.2f} a rank; reserved sum "
            f"{sum(row['reserved']) / 1e9:.2f}, the card "
            f"{row['card_free'] / 1e9:.2f} GB free after the steps); twin peak "
            f"{tw['peak'] / 1e9:.2f} GB; rank 0's collectives in its profiled "
            f"step (the fastpath-{'off' if with_off else 'on'} run's last): "
            + ", ".join(f"{k} {1e3 * v:.1f} ms" for k, v in comm.items())
            + f" of a step with {row['device_ms']:.1f} ms of device time; "
            "the model group's bytes a rank a step (tp_prediction): "
            f"{pred['rank_collective_bytes'].get('all-reduce:model', 0) / 1e9:.3f}"
            " GB all-reduced, "
            f"{pred['rank_collective_bytes'].get('all-gather:model', 0) / 1e9:.3f}"
            f" GB gathered ({smi})")
        r0 = row["rank_stages_s"][0]
        log(f"tensor parallel {name}: seconds, this process "
            + ", ".join(f"{k} {v:.1f}" for k, v in tw["stages_s"].items())
            + "; rank 0 " + ", ".join(f"{k} {v:.1f}" for k, v in r0.items()))
        if not ok:
            raise AssertionError(
                f"tensor parallel {name}: against the one-card twin: losses "
                f"{got} vs {losses} (relative {loss_rel}, held to {loss_tol}),"
                f" params {diff}, the router {router}, routing flips a step "
                f"{flips}, the SSD's decay leaves {decay}")
    if twin_dir is not None:
        out["serve"] = {name: _tp_serve_report(name, [rk["serve"][name] for rk in ranks],
                                               twin_dir, smi)
                        for name in TP_SERVE_RUNS}
    log(f"tensor parallel: the spawn of every run took {spawn_s:.1f} s")
    out["launches"] = launches
    return out


def _tp_serve_report(name: str, rks: list, twin_dir: str, smi: str) -> dict:
    """Phase 15 (c)'s serving run ``name`` from its ranks' results
    (``_tp_serve``), beside ``launch.dryrun.serve_count``'s prediction of
    the rank's blocks and model-group bytes at the run's layout; printed,
    then held: the layout's split axes, the blocks' bytes as predicted,
    every held step's logits, the cache blocks, ``pos`` and the greedy
    tokens as ``_tp_serve`` judged them; for an encoder-decoder run, its
    teacher-forced leg's logits and cache blocks and a cross cache that
    is not all zero on any rank."""
    from repro_torch.launch import dryrun

    run = TP_SERVE_RUNS[name]
    arch, W, M = run["arch"], run["data"], run["model"]
    srv = SERVE_RUNS[arch]
    cfg = _tp_serve_config(arch)
    pred = dryrun.serve_count(cfg, "decode", srv["max_len"], srv["batch"],
                              {"data": W, "model": M})
    twin_ms = torch.load(f"{twin_dir}/{arch}.serve.twin.pt", mmap=True)["step_ms"]
    want_split = set(TP_SERVE_LAYOUTS[run["layout"]])
    if cfg.family in ("ssm", "hybrid"):
        want_split |= {"d_inner", "ssm_heads"}
    step_ms = statistics.median(rk["step_ms"] for rk in rks)
    r0 = rks[0]
    row = {"layers": cfg.n_layers, "workers": W, "shards": M,
           "batch": srv["batch"], "max_len": srv["max_len"],
           "layout": run["layout"], "ranks": rks, "step_ms": step_ms,
           "twin_step_ms": twin_ms,
           "predicted": {k: pred[k] for k in ("params_bytes", "cache_bytes",
                                              "rank_collective_bytes")}}
    coll = pred["rank_collective_bytes"]
    log(f"tensor parallel serve {name}: {cfg.n_layers} layers, (data, model) = "
        f"({W}, {M}), {W * M} gloo ranks on one card, split axes {r0['split']}, "
        f"batch {srv['batch']} ({srv['batch'] // W} rows a rank), max_len "
        f"{srv['max_len']}; a rank holds {r0['block_bytes']['params'] / 1e9:.4f} GB "
        f"of parameters and {r0['block_bytes']['cache'] / 1e9:.4f} GB of cache "
        f"(count_serve: {pred['params_bytes'] / 1e9:.4f} and "
        f"{pred['cache_bytes'] / 1e9:.4f}); {r0['steps']} served steps against the "
        f"twin's: logits of {sum(rk['logits_held'] for rk in rks)} of "
        f"{sum(rk['positions'] for rk in rks)} rank-positions held (up to a "
        "row's first token apart from the twin's, an MoE row's first routing "
        "flip), "
        f"{sum(rk['logits_beyond'] for rk in rks)} beyond rtol {TP_SERVE_RTOL} "
        f"with a floor of {TP_SERVE_RTOL} of the step's largest (largest "
        f"|diff| {max(rk['max_abs_err'] for rk in rks):.3e}, at most "
        f"{max(rk['worst_share_of_allowed'] for rk in rks):.3f} of the allowed), "
        f"cache blocks ({r0['cache_leaves']} leaves) "
        f"{'held' if all(rk['cache_ok'] for rk in rks) else 'APART'} "
        f"(largest |diff| {max(rk['cache_max_abs_err'] for rk in rks):.3e}), pos "
        f"{[rk['pos'] for rk in rks]}; greedy tokens' first differences from "
        f"the twin {[rk['first_token_diffs'] for rk in rks]} of "
        f"{r0['steps']} steps (a near-tie of the twin's top 2 within "
        f"{TP_SERVE_MARGIN}, or after a routing flip, excuses one)"
        + (f"; routing flips at {[rk['flips'] for rk in rks]}, top-"
           f"{cfg.moe_top_k} gaps {[rk['tie_gaps'] for rk in rks]}"
           if cfg.is_moe else ""))
    log(f"tensor parallel serve {name}: {step_ms:.2f} ms a decode step (median "
        f"over the ranks of each rank's median of {r0['steps'] - SERVE_PROMPT}, CUDA events; the "
        f"one-card twin {twin_ms:.2f} ms); the model group a step, rank 0: "
        f"{r0['comm']['calls']:.0f} collectives, {r0['comm']['bytes'] / 1e6:.3f} MB "
        f"returned, {1e3 * r0['comm']['seconds']:.2f} ms of host time with the card "
        f"synchronised around each (ModelShard counts "
        f"{r0['traffic']['all-reduce'] / 1e6:.3f} MB all-reduced, "
        f"{r0['traffic']['all-gather'] / 1e6:.3f} MB gathered; count_serve "
        f"{coll.get('all-reduce:model', 0) / 1e6:.3f} and "
        f"{coll.get('all-gather:model', 0) / 1e6:.3f}); peak per rank "
        f"{[round(rk['peak_bytes'] / 1e9, 3) for rk in rks]} GB; seconds, rank 0 "
        + ", ".join(f"{k} {v:.1f}" for k, v in r0["stages_s"].items())
        + f" ({smi})")
    forced = [rk["forced"] for rk in rks]
    if cfg.family == "encdec":
        log(f"tensor parallel serve {name}: teacher-forced from frames drawn from "
            f"seed {TP_SERVE_FRAMES_SEED}, {forced[0]['steps']} steps of the twin's "
            "tokens from the cross cache build_cross_cache(..., shard) makes on each "
            "rank, against the one-card leg: logits "
            f"{sum(f['logits_beyond'] for f in forced)} rank-rows beyond (largest "
            f"|diff| {max(f['max_abs_err'] for f in forced):.3e}, at most "
            f"{max(f['worst_share_of_allowed'] for f in forced):.3f} of the "
            f"allowed), cache blocks "
            f"{'held' if all(f['cache_ok'] for f in forced) else 'APART'} (largest "
            f"|diff| {max(f['cache_max_abs_err'] for f in forced):.3e}); ck and cv "
            "not all zero on ranks "
            f"{[r for r, f in enumerate(forced) if all(f['cross_nonzero'].values())]}"
            f" ({smi})")
    faults = []
    for r, rk in enumerate(rks):
        if not want_split <= set(rk["split"]):
            faults.append(f"rank {r} splits {rk['split']}, not {sorted(want_split)}")
        if (rk["block_bytes"]["params"] != pred["params_bytes"]
                or rk["block_bytes"]["cache"] != pred["cache_bytes"]):
            faults.append(f"rank {r} holds {rk['block_bytes']}, count_serve "
                          "predicts otherwise")
        if rk["logits_beyond"] or 2 * rk["logits_held"] < rk["positions"]:
            faults.append(f"rank {r}: {rk['logits_beyond']} steps' logits apart, "
                          f"{rk['logits_held']} of {rk['positions']} held")
        if (not rk["cache_ok"] or rk["pos"] != rk["steps"]
                or rk["steps"] != _tp_serve_steps(run)):
            faults.append(f"rank {r}: cache held {rk['cache_ok']}, pos {rk['pos']}")
        if not rk["tokens_ok"]:
            faults.append(f"rank {r}: greedy tokens part from the twin's at "
                          f"{rk['first_token_diffs']} with a clear margin")
        if rk["traffic"] != rks[0]["traffic"]:
            faults.append(f"rank {r} moved other bytes than rank 0")
        f = rk["forced"]
        if cfg.family == "encdec" and (
                f is None or not all(f["cross_nonzero"].values())
                or f["logits_beyond"] or not f["cache_ok"]):
            faults.append(f"rank {r}'s teacher-forced leg from seeded frames: {f}")
    if faults:
        raise AssertionError(f"tensor parallel serve {name}: " + "; ".join(faults))
    return row


def model_parallel_refusals() -> dict:
    """Phase 15 (d): ``--mesh production`` at a world size of 4 exits
    non-zero with its message before any process group starts."""
    env = dict(os.environ, WORLD_SIZE="4", RANK="0", LOCAL_RANK="0",
               PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--mesh",
         "production", "--smoke", "--device", "cuda"],
        env=env, capture_output=True, text=True, timeout=120)
    want = "--mesh production needs 256 ranks"
    if res.returncode == 0 or want not in res.stderr or "not 4" not in res.stderr:
        raise AssertionError(f"model parallel (d): exit {res.returncode}, "
                             f"stderr {res.stderr[-500:]!r}")
    log(f"model parallel (d): --mesh production at world size 4 refused, exit "
        f"{res.returncode}: {res.stderr.strip().splitlines()[-1]}")
    return {"returncode": res.returncode, "message": res.stderr.strip()}


def phase_model_parallel(smi: str, twin_dir=None) -> dict:
    """Phase 15: the model axis (see the module docstring); kernel 1's
    launches counted over (a)'s runs and (b)'s, every rank's summed; (c)
    also serves against phase 14's twins in ``twin_dir`` where given."""
    t0 = time.perf_counter()
    card = model_parallel_card(smi)
    ranks = model_parallel_ranks(smi)
    tp = model_parallel_tp(smi, twin_dir=twin_dir)
    refusal = model_parallel_refusals()
    out = {"card": card, "ranks": ranks, "tensor_parallel": tp,
           "refusal": refusal,
           "launches": card["launches"] + ranks["launches"] + tp["launches"],
           "seconds": time.perf_counter() - t0}
    log(f"model parallel: phase 15 took {out['seconds']:.1f} s, "
        f"{out['launches']} kernel 1 launches")
    return out


# phase 16: the dry run; a share of the card's float32 peak above this is
# impossible, so the FLOP count (or the device time) is wrong
DRYRUN_COMBO = ("qwen2.5-3b", "train_4k")
MAX_F32_SHARE = 1.05


def dryrun_combo() -> dict:
    """Phase 16 (a): ``dryrun.run_combo`` as the CLI runs it, on the meta
    device: the card's allocated bytes stay as they were."""
    from repro_torch.launch import dryrun

    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    rec = dryrun.run_combo(*DRYRUN_COMBO, multi_pod=False)
    seconds = time.perf_counter() - t0
    after = torch.cuda.memory_allocated()
    mem = rec["mem"]
    if after != before or not (rec["flops"] > 0 and mem["argument_bytes"] > 0
                               and mem["peak_bytes"] >= rec["rank_bytes"] > 0):
        raise AssertionError(f"dry run (a): allocated {before} -> {after} B, "
                             f"record {json.dumps(rec)[:500]}")
    log(f"dry run (a): {' x '.join(DRYRUN_COMBO)} x {rec['mesh']} in "
        f"{seconds:.1f} s, card allocation unchanged ({after} B): "
        f"{rec['flops']:.4e} FLOPs a rank, argument {mem['argument_bytes']:,} B, "
        f"rank {rec['rank_bytes']:,} B, peak {mem['peak_bytes']:,} B "
        f"(fits 80 GB: {rec['fits']}), all-gather "
        f"{rec['collective_bytes']['all-gather']:,.0f} B")
    log(f"dry run (a): record {json.dumps(rec)}")
    return {"record": rec, "seconds": seconds}


def _step_count(cfg, W: int, B: int, S: int) -> tuple:
    """(FLOPs, traced peak bytes) of one one-card training step of ``cfg``
    at W workers and batch B x S on the meta device, phase 13's RegTop-k
    and Adam with the fastpath off."""
    from repro_torch.core import distributed as td
    from repro_torch.core.sparsify import SparsifierConfig
    from repro_torch.launch import dryrun, op_cost
    from repro_torch.models import get_family, input_specs
    from repro_torch.optim import OptConfig, make_optimizer

    dist = td.DistConfig(
        sparsifier=SparsifierConfig(kind="regtopk", sparsity=FAMILY_SPARSITY),
        optimizer=OptConfig(kind="adam", learning_rate=FAMILY_LR))
    params = get_family(cfg).init(cfg, device="meta")
    plan = td.build_plan(params, FAMILY_SPARSITY, dist)
    opt_state = make_optimizer(dist.optimizer).init(params)
    sp = td.init_sparsifier_state(plan, W, "meta")
    batch = {k: torch.empty(s, dtype=d, device="meta")
             for k, (s, d) in input_specs(cfg, B, S).items()}
    resident = sum(dryrun._tree_bytes(x)
                   for x in (params, opt_state, sp, batch))
    cost = op_cost.analyze(td.make_train_step(cfg, dist, plan, W), params,
                           opt_state, sp, batch)
    return cost["flops"], resident + cost["peak_bytes"]


def phase_dryrun(smi: str, families: dict) -> dict:
    """Phase 16: the dry run (see the module docstring); no kernel
    launches."""
    from repro_torch import configs
    from repro_torch.launch import mesh as meshlib

    t0 = time.perf_counter()
    before = torch.cuda.memory_allocated()
    out = {"combo": dryrun_combo(), "families": {}}
    for arch, run in FAMILY_RUNS.items():
        W, B, S = run["workers"], run["batch"], run.get("seq", FAMILY_SEQ)
        cfg = configs.get_config(arch)
        if run["layers"] is not None:
            cfg = cfg.replace(n_layers=run["layers"])
        t_count = time.perf_counter()
        flops, peak = _step_count(cfg, W, B, S)
        fam = families[arch]
        device_ms = fam["profile"]["device_ms"]
        rate = flops / (device_ms / 1e3)
        share = rate / meshlib.PEAK_FLOPS_F32
        log(f"dry run (b) {arch}: {flops:.4e} FLOPs a step (W = {W}, batch "
            f"{B} x {S}, counted in {time.perf_counter() - t_count:.1f} s) over "
            f"{device_ms:.1f} ms of device time = {rate / 1e12:.2f} TFLOP/s, "
            f"{share:.1%} of {meshlib.PEAK_FLOPS_F32 / 1e12:.0f} TFLOP/s in "
            f"float32 ({smi}); peak traced {peak / 1e9:.2f} GB, measured "
            f"{fam['peak_bytes'] / 1e9:.2f} GB, reckoned "
            f"{fam['reckoned_bytes'] / 1e9:.2f} GB")
        if not share <= MAX_F32_SHARE:
            raise AssertionError(f"dry run (b) {arch}: {share:.3f} of the card's "
                                 "float32 peak is impossible")
        out["families"][arch] = {
            "flops": flops, "device_ms": device_ms, "tflops": rate / 1e12,
            "f32_share": share, "traced_peak_bytes": peak,
            "measured_peak_bytes": fam["peak_bytes"],
            "reckoned_bytes": fam["reckoned_bytes"]}
    if torch.cuda.memory_allocated() != before:
        raise AssertionError("dry run: the card's allocation changed")
    out["seconds"] = time.perf_counter() - t0
    log(f"dry run: phase 16 took {out['seconds']:.1f} s, no kernel launches")
    return out


def _full_layers(arch: str) -> int:
    from repro_torch import configs

    return configs.get_config(arch).n_layers


def ab_times() -> dict:
    """Kernel 1's device time per training step (every leaf of the main
    path, W = 8, the trainer's budgets) and ``block_topk_candidates``' at
    full width (m = 16), with whatever ``repro_torch`` is on ``sys.path``:
    only calls that every tree of the port has."""
    from repro_torch.comm import fastpath as fp
    from repro_torch.core.selectors import sparsity_to_k
    from repro_torch.kernels import block_topk as bt
    from repro_torch.kernels import fused_encode as fe
    from repro_torch.kernels import ops
    from repro_torch.kernels import regtopk_score as rs

    gen = torch.Generator().manual_seed(0)
    leaves = _model_leaves()
    per_leaf = {}
    for path, L in leaves.items():
        k = sparsity_to_k(L, 0.01)
        kw = dict(omega=1.0 / W, mu=1.0, q=1e9, y=1.0,
                  m=fp.candidate_budget(L, k))
        tiles = [ops._tile(x)[0] for x in _leaf_inputs(L, k, gen)]
        per_leaf[path] = median_ms(
            lambda t=tiles, kw=kw: fe.fused_candidates(*t, **kw))
    xs = _leaf_inputs(sum(leaves.values()), FULL_K[1], gen, workers=1)
    st = ops._tile(rs.score_chain(*xs, omega=1.0 / W, mu=1.0, q=1e9, y=1.0))[0]
    block_ms = median_ms(lambda: bt.block_topk_candidates(st, SELECT_M))
    return {"fused_candidates_per_step_ms": sum(per_leaf.values()),
            "block_topk_candidates_full_width_ms": block_ms,
            "fused_candidates_per_leaf_ms": per_leaf}


def phase_ab(parent: Path) -> dict:
    """Kernels 1 and 5 of a checkout of the parent commit against this
    tree's, on this card, in turns (parent, change, change, parent): each
    turn a fresh process that builds that tree's kernels (into its own
    ``build/``) and runs ``ab_times`` on its modules."""
    trees = {"parent": parent.resolve(), "change": ROOT}
    samples = {name: [] for name in trees}
    for name in ("parent", "change", "change", "parent"):
        out = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--ab-tree",
             str(trees[name])],
            capture_output=True, text=True, timeout=600,
        )
        if out.returncode != 0:
            raise AssertionError(f"A/B turn {name} failed:\n{out.stdout}\n{out.stderr}")
        samples[name].append(json.loads(out.stdout.strip().splitlines()[-1]))
        log(f"A/B {name}: {json.dumps(samples[name][-1])}")
    return {"order": ["parent", "change", "change", "parent"], "samples": samples}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--details", type=Path, default=None,
                    help="write every phase's results to this JSON file")
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of the parent commit: time kernels 1 "
                         "and 5 of both trees in turns (into --details)")
    ap.add_argument("--ab-tree", type=Path, default=None,
                    help="build the kernels of this checkout, print "
                         "ab_times() of its modules as JSON and stop")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    tree = args.ab_tree.resolve() if args.ab_tree else ROOT
    sys.path.insert(0, str(tree / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    if args.ab_tree is not None:
        phase_build()
        print(json.dumps(ab_times()), flush=True)
        return 0

    t_script = time.perf_counter()
    device_name, smi = phase_device()
    builds = phase_build()
    kernels = phase_kernels()
    score = phase_score()
    select = phase_select()
    trainer = phase_trainer()
    sim = phase_sim()
    wire = phase_wire(smi)
    # phase 9's ranks checkpoint here, and phase 12 resumes it on one card
    with tempfile.TemporaryDirectory() as ckpt_dir:
        ranks = phase_ranks(smi, f"{ckpt_dir}/ranks")
        stragglers = phase_stragglers(smi)
        planners = phase_planners(smi)
        options = phase_options(smi, f"{ckpt_dir}/ranks")
    families = phase_families(smi)
    # phase 14's twins of phase 15 (c)'s serving runs are saved here
    with tempfile.TemporaryDirectory() as twin_dir:
        serving = phase_serving(smi, twin_dir)
        model_parallel = phase_model_parallel(smi, twin_dir)
    dry = phase_dryrun(smi, families)
    ab = phase_ab(args.parent) if args.parent is not None else None
    per_step = kernels["per_step"]
    per_round = score["per_round"]
    line = {"kernels": [{
        "name": "fused_candidates",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_encode.cu",
        "replaces": "src/repro/kernels/fused_encode.py:111",
        "launches": (trainer["launches"] + wire["trainer"]["launches"]
                     + ranks["launches"] + stragglers["trainer"]["launches"]
                     + planners["trainer"]["launches"] + options["launches"]
                     + families["launches"] + model_parallel["launches"]),
        "max_abs_err": kernels["max_abs_err"],
        "ms": per_step["ms"],
        "plain_ms": per_step["plain_ms"],
        "bound_ms": per_step["bound_ms"],
        "bound_by": "bytes",
        "library_ms": per_step["library_ms"],
    }, {
        "name": "regtopk_score",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/regtopk_score.cu",
        "replaces": "src/repro/kernels/regtopk_score.py:82",
        "launches": (sim["launches"] + wire["sim"]["launches"]
                     + stragglers["sim"]["launches"]
                     + planners["sim"]["launches"]),
        "max_abs_err": score["max_abs_err"],
        "ms": per_round["ms"],
        "plain_ms": per_round["plain_ms"],
        "bound_ms": per_round["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }]}
    wide = select["times"]["full width"]["kernels"]
    for kernel, source, replaces in (
        ("count_above", "threshold_topk.cu", "threshold_topk.py:54"),
        ("global_max", "threshold_topk.cu", "threshold_topk.py:70"),
        ("block_topk_candidates", "block_topk.cu", "block_topk.py:48"),
    ):
        line["kernels"].append({
            "name": kernel,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": select["launches"][kernel],
            "max_abs_err": select["max_abs_err"][kernel],
            "ms": wide[kernel]["ms"],
            "plain_ms": wide[kernel]["plain_ms"],
            "bound_ms": wide[kernel]["bound_ms"],
            "bound_by": "bytes",
            "library_ms": wide[kernel]["library_ms"],
        })
    seconds = time.perf_counter() - t_script
    log(f"chip_smoke: every phase passed in {seconds:.1f} s")
    if args.details is not None:
        args.details.parent.mkdir(parents=True, exist_ok=True)
        args.details.write_text(json.dumps(
            {"device": device_name, "nvidia_smi": smi, "seconds": seconds,
             "build_seconds": builds,
             "kernels": kernels, "score": score, "select": select,
             "trainer": trainer, "sim": sim, "wire": wire, "ranks": ranks,
             "stragglers": stragglers, "planners": planners,
             "options": options, "families": families, "serving": serving,
             "model_parallel": model_parallel, "dryrun": dry, "ab": ab,
             "kernels_line": line},
            indent=1,
        ))
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
