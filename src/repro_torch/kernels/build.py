"""Build the CUDA sources under ``csrc/`` with nvcc and load them by ctypes.

Each ``csrc/*.cu`` file is one shared library with a plain C interface,
compiled for Hopper (``sm_90a``) at first use into ``build/kernels/`` at
the root of the checkout (listed in ``.gitignore``). The library name
carries a hash of the sources and flags, so an edit rebuilds it. The
flags keep IEEE float arithmetic: no ``--use_fast_math``, and
``-fmad=false`` so that no multiply-add is contracted into an FMA — the
kernels' scores must equal the plain PyTorch versions' bit for bit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Tuple[Path, float, str]]:
    """Compile every ``csrc/*.cu`` that is not built yet, one nvcc process
    per source, all started together. Returns ``{name: (library, build
    seconds, nvcc's ptxas report)}``; raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    t0 = time.perf_counter()
    for src in sorted(CSRC.glob("*.cu")):
        out = _library_path(src.stem)
        if out.exists():
            jobs[src.stem] = (out, None)
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        jobs[src.stem] = (out, (proc, tmp))
    done = {}
    for name, (out, job) in jobs.items():
        report = ""
        if job is not None:
            proc, tmp = job
            report, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{report}")
            os.replace(tmp, out)
        done[name] = (out, time.perf_counter() - t0, report)
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    if name not in _LOADED:
        out = _library_path(name)
        if not out.exists():
            build_all()
        _LOADED[name] = ctypes.CDLL(str(out))
    return _LOADED[name]
