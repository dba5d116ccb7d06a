"""The dry run's layouts (``repro_torch.launch.dryrun.train_layout``)
against the JAX dry run's on the two production meshes, ``(16, 16)`` and
``(2, 16, 16)``, for all twelve configs at their published widths in bf16
(``AbstractMesh``es in one subprocess, ``tests/_torch_dryrun_jax.py``; no
compile): every parameter's spec (``tree_specs``), every Adam moment's
(``zero1_specs``), the sparsifier state of every leaf (``build_plan`` and
``sparsifier_state_shapes``: shapes, dtypes and specs) and the per-device
bytes of the step's arguments. Two fields differ by design and are named:
the port's ``sent_idx`` is int64 where JAX's is int32, and so are its
tokens and labels; the per-device bytes differ by exactly those."""
import json

import pytest
import torch

from test_torch_dryrun import int64_extra, jax_cases
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as meshlib
from repro_torch.tree import tree_items
import _torch_cores  # noqa: F401  (this worker's share of the cores)

ARCHS = tuple(configs.ARCHS)
MESHES = {"16x16": False, "2x16x16": True}
CASES = [f"layout:{arch}:{mesh}" for mesh in MESHES for arch in ARCHS]
JAX_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
              torch.int32: "int32"}


def _plain(spec):
    """A spec as the JSON of the JAX side: tuples as lists."""
    return json.loads(json.dumps(list(spec)))


@pytest.fixture(scope="module")
def jax_layouts(tmp_path_factory):
    return jax_cases(tmp_path_factory, CASES)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_layouts_match_jax(jax_layouts, mesh):
    shape = meshlib.production_shape(MESHES[mesh])
    assert "x".join(map(str, shape.values())) == mesh
    for arch in ARCHS:
        want = jax_layouts[f"layout:{arch}:{mesh}"]
        lay = dryrun.train_layout(arch, "train_4k", shape)
        specs = {k: _plain(s) for k, s in tree_items(lay.param_specs)}
        assert specs == want["param_specs"], arch
        moms = {k: _plain(s) for k, s in tree_items(lay.mom_specs)}
        assert moms == want["mom_specs"], arch
        state = dict(tree_items(lay.state))
        assert state.keys() == want["state"].keys(), arch
        for path, st in state.items():
            for field, (shp, dt, spec) in st._asdict().items():
                if field == "sent_idx":  # the named difference
                    assert dt == torch.int64
                    dt = torch.int32
                got = [list(shp), JAX_DTYPES[dt], _plain(spec)]
                assert got == want["state"][path][field], (arch, path, field)
        assert sum(lay.argument_bytes.values()) - int64_extra(lay) == (
            want["argument_bytes"]), arch
