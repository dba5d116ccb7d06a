"""The port stands alone: no file of ``src/repro_torch/`` nor
``chip_smoke.py`` imports ``jax``, the JAX package ``repro`` or
``msgpack`` (absent where the card is: the checkpoint store carries its
own codec).

Checked twice: statically over the sources, and by importing every port
module in a fresh interpreter and reading its ``sys.modules`` (never this
process's, which the JAX tests share).
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "msgpack")


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(
            ".__init__"
        )
        for p in PORT.rglob("*.py")
    )


@pytest.mark.parametrize(
    "path", _sources(), ids=lambda p: str(p.relative_to(ROOT))
)
def test_no_jax_or_repro_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (
                f"{path.relative_to(ROOT)}:{node.lineno} imports {name}"
            )


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.split()[-1]) >= len(_modules())


def test_the_checkpoint_store_is_checked():
    """The store, which writes the JAX package's msgpack metadata with a
    codec of its own, is in both checks above."""
    assert PORT / "checkpoint" / "store.py" in _sources()
    assert "repro_torch.checkpoint.store" in _modules()


def test_the_wire_modules_are_checked():
    """The wire's modules, ``comm/cost.py`` (plain arithmetic that the JAX
    package also has) among them, and the planners (``overlap`` and
    ``autotune``, host arithmetic, and ``calibrate``) are in both checks
    above."""
    for name in ("codec", "collectives", "cost", "fastpath", "overlap",
                 "autotune", "calibrate"):
        assert PORT / "comm" / f"{name}.py" in _sources()
        assert f"repro_torch.comm.{name}" in _modules()
