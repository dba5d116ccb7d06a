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
4. trainer  — the port's trainer (``repro_torch.launch.train``) on
              paper-resnet-proxy at full width, W = 8, RegTop-k at S = 0.01,
              fastpath on, for 10 steps: finite losses, one kernel launch
              per fused leaf per step, the certificate hit rate, one step
              held against the fastpath off, and a small run held against
              the same run on the CPU.

The line before the last is the card's nvidia-smi line; before it, the
``kernels`` JSON line. The last line is the device JSON.
``--details FILE`` also writes every phase's results to FILE as JSON.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
SCORE_OPS = 12  # f32 operations of the score chain per element, tanh as one
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


def _leaf_inputs(L: int, k: int, gen: torch.Generator, poison=None):
    """[W, L] gradient accumulator and the dense scatter of a random
    previous payload: what fused_compact_select hands the kernel.
    ``poison`` makes the certificate fail: "concentrate" puts the mass in
    one tile, "nan" puts one NaN in tile 1, "nan tile" fills tile 1."""
    a = 1e-3 * torch.randn((W, L), generator=gen)
    if poison == "concentrate":
        a[:, : min(L, 4096)] *= 1e3
    elif poison == "nan":
        a[:, 8192 + 5] = float("nan")
    elif poison == "nan tile":
        a[:, 8192:16384] = float("nan")
    sent = torch.stack([torch.randperm(L, generator=gen)[:k] for _ in range(W)])
    ones = torch.ones((W, k))
    z = torch.zeros((W, L))
    s_prev = z.scatter(1, sent, ones)
    a_prev = z.scatter(1, sent, 1e-3 * torch.randn((W, k), generator=gen))
    g_prev = z.scatter(1, sent, 1e-4 * torch.randn((W, k), generator=gen))
    return [x.cuda() for x in (a, a_prev, s_prev, g_prev)]


def _abs_diff(x: torch.Tensor, y: torch.Tensor) -> float:
    """Largest |x - y|; NaN on both sides agrees, NaN on one side gives
    NaN."""
    both = torch.isnan(x) & torch.isnan(y)
    return float(torch.where(both, 0.0, x - y).abs().max())


def phase_kernels() -> dict:
    """Kernel against plain version at the main path's shapes."""
    from repro_torch import configs
    from repro_torch.comm import fastpath as fp
    from repro_torch.core.selectors import sparsity_to_k, topk_stable
    from repro_torch.kernels import fused_encode as fe
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.tree import tree_items

    cfg = configs.get_config("paper-resnet-proxy")
    leaves = {
        path: leaf.numel()
        for path, leaf in tree_items(lm.init(cfg, device="meta"))
    }
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
        rs, rv, ri = fe.fused_candidates_ref(*tiles, **kw)
        torch.cuda.synchronize()
        if not torch.equal(ci, ri):
            bad = int((ci != ri).sum())
            raise AssertionError(f"{name}: {bad} candidate indices differ")
        err = max(_abs_diff(cs, rs), _abs_diff(cv, rv))
        if err != 0.0:
            raise AssertionError(
                f"{name}: candidate scores/values differ from the plain "
                f"version by {err:g}; the score chain must be bit-equal"
            )
        max_err = max(max_err, err)
        vals, idx, ok = fe.select_from_candidates(cs, cv, ci, k)
        score = fe.score_chain(*xs, omega=1.0 / W, mu=1.0, q=1e9, y=y)
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
    return {"rows": rows, "max_abs_err": max_err, "per_step": totals}


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
    step_ms = step_times(runs)
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
            "profile": profile, "winners_per_tile": crowd}


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


def step_times(runs: dict, reps: int = 5) -> dict:
    """Host-clock milliseconds of one training step from the same state,
    fastpath on and off in turns (on, off, off, on)."""
    times = {mode: [] for mode in runs}
    for mode in ("on", "off", "off", "on"):
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[mode]()
            torch.cuda.synchronize()
            times[mode].append(1e3 * (time.perf_counter() - t0))
    out = {mode: statistics.median(ts) for mode, ts in times.items()}
    log(f"trainer: step time {json.dumps(out)} ms (median of {2 * reps}, "
        "fastpath on/off in turns)")
    return out


def profile_step(run, step_ms: float) -> dict:
    """One training step under torch.profiler: the device time of its
    kernels, their share of the unprofiled step time ``step_ms``, and the
    heaviest kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
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
    log(f"profile: device busy {device_ms:.2f} ms of a {step_ms:.2f} ms step "
        f"({device_ms / step_ms:.1%}); top: "
        + "; ".join(f"{k[:40]} {ms:.2f} ms x{n}" for ms, n, k in rows[:6]))
    return {"device_ms": device_ms, "busy_share": device_ms / step_ms,
            "top": [{"kernel": k, "ms": ms, "count": n} for ms, n, k in rows[:25]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--details", type=Path, default=None,
                    help="write every phase's results to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    name, smi = phase_device()
    builds = phase_build()
    kernels = phase_kernels()
    trainer = phase_trainer()
    per_step = kernels["per_step"]
    line = {"kernels": [{
        "name": "fused_candidates",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_encode.cu",
        "replaces": "src/repro/kernels/fused_encode.py:111",
        "launches": trainer["launches"],
        "max_abs_err": kernels["max_abs_err"],
        "ms": per_step["ms"],
        "plain_ms": per_step["plain_ms"],
        "bound_ms": per_step["bound_ms"],
        "bound_by": "bytes",
        "library_ms": per_step["library_ms"],
    }]}
    if args.details is not None:
        args.details.parent.mkdir(parents=True, exist_ok=True)
        args.details.write_text(json.dumps(
            {"device": name, "nvidia_smi": smi, "build_seconds": builds,
             "kernels": kernels, "trainer": trainer, "kernels_line": line},
            indent=1,
        ))
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
