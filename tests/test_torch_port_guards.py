"""Guards of the port: it imports nothing of JAX or of ``mvdetr_tpu``, its
entry points refuse to run without a card unless asked for the CPU, and its
kernel never falls back to another path."""

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "mvdetr_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mvdetr_tpu")

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import mvdetr_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mvdetr_tpu_torch.__path__, "mvdetr_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules if m.split(".")[0] in {forbidden})
print(json.dumps({{"imported": names, "bad": bad}}))
"""


def _top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_package_and_chip_smoke_import_no_jax():
    """Every submodule and chip_smoke.py, imported in a fresh interpreter, pull
    in no JAX and no mvdetr_tpu module; and no import statement anywhere in
    them (including the ones inside functions) names one."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL.format(forbidden=set(FORBIDDEN))],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    for name in ("ops.msda_windowed", "ops.warp", "ops.sampling", "losses", "data.targets", "train.trainer",
                 "train.optim", "train.state", "models.layers", "ops.lane_broadcast", "scripts.exp_vpu_broadcast"):
        assert f"mvdetr_tpu_torch.{name}" in report["imported"], name

    sources = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in sources:
        names = set(_top_level_imports(path))
        assert not names & set(FORBIDDEN), f"{path.relative_to(ROOT)} imports {names & set(FORBIDDEN)}"


def test_entry_points_refuse_to_run_without_a_card(monkeypatch):
    """With no card, the default device="cuda" raises instead of quietly
    running on the CPU; device="cpu" works."""
    from mvdetr_tpu_torch.geometry import make_synthetic_rig
    from mvdetr_tpu_torch.interop import from_jax_variables
    from mvdetr_tpu_torch.models import MVDeTr
    from mvdetr_tpu_torch.train import eval_step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rig = make_synthetic_rig(num_cam=2, img_shape=(48, 96), worldgrid_shape=(32, 64))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MVDeTr.from_rig(rig, world_reduce=2)
    model = MVDeTr.from_rig(rig, world_reduce=2, device="cpu")
    batch = {"imgs": np.zeros((1, 2, 32, 64, 3), np.uint8), "affine_mats": np.tile(np.eye(3), (1, 2, 1, 1))}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_step(model, batch, world_reduce=2)
    _, xys, keep = eval_step(model, batch, world_reduce=2, num_candidates=16, device="cpu")
    assert xys.shape == (1, 16, 3) and keep.shape == (1, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax_variables({"params": {}, "batch_stats": {}})


def test_kernel_build_raises_without_nvcc_and_on_a_failed_build(monkeypatch, tmp_path):
    """No nvcc, or an nvcc that fails: building (and so the first launch of
    each of B1, B2, B3 and B5) raises; nothing substitutes the plain version."""
    from mvdetr_tpu_torch.ops import kernel_build, lane_broadcast, msda_windowed, warp

    loaders = {msda_windowed.KERNEL_NAME: msda_windowed.load_library,
               msda_windowed.BWD_KERNEL_NAME: msda_windowed.load_bwd_library, warp.KERNEL_NAME: warp.load_library,
               lane_broadcast.KERNEL_NAME: lane_broadcast.load_library}
    monkeypatch.setattr(kernel_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernel_build, "DEFAULT_CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path / "bin"))
    for load in loaders.values():
        load.cache_clear()
    try:
        for load in loaders.values():
            with pytest.raises(RuntimeError, match="nvcc not found"):
                load()
        fake = tmp_path / "bin" / "nvcc"
        fake.parent.mkdir()
        fake.write_text("#!/bin/sh\necho 'fatal: no sm_90a here' >&2\nexit 1\n")
        fake.chmod(0o755)
        for name in loaders:
            with pytest.raises(RuntimeError, match="no sm_90a here"):
                kernel_build.build(name)
            assert not kernel_build.library_path(name).exists()
    finally:
        for load in loaders.values():
            load.cache_clear()


@pytest.mark.parametrize("name", ["msda_windowed_fwd", "msda_windowed_bwd", "warp_bwd"])
def test_backward_kernels_use_no_atomics(name):
    """B1 and the backward kernels sum each output in one fixed order, so two
    launches, and two train steps, repeat bitwise: outside comments, their
    sources name no atomic operation (CUDA's atomic*() or PTX atom/red)."""
    code = re.sub(r"//[^\n]*", "", (PACKAGE / "csrc" / f"{name}.cu").read_text())
    assert not re.search(r"\batomic\w*\s*\(|\batom\.|\bred\.", code)
