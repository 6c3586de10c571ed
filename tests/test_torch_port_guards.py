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
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mvdetr_tpu", "tests")

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
                 "train.optim", "train.state", "models.layers", "ops.lane_broadcast", "scripts.exp_vpu_broadcast",
                 "cli", "evaluation.clear", "native", "data.augment", "data.source", "data.dataset", "data.adapters",
                 "data.prefetch", "utils.logger", "utils.profiling", "train.checkpoint", "data.png", "data.trees",
                 "scripts.hard_benchmark", "scripts.stress_ab", "scripts.tune_convergence",
                 "scripts.rehearse_realscale", "scripts.full_scale_run", "scripts.rehearse_day_one", "scripts.bench",
                 "ops.kernel_flops", "scripts.lane_vs_source", "ops.batch_norm"):
        assert f"mvdetr_tpu_torch.{name}" in report["imported"], name

    sources = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in sources:
        names = set(_top_level_imports(path))
        assert not names & set(FORBIDDEN), f"{path.relative_to(ROOT)} imports {names & set(FORBIDDEN)}"


def test_bench_twin_imports_no_chip_smoke():
    """The bench twin stands alone on the card's machine: no import statement
    in it (including the ones inside functions) names ``chip_smoke``; the
    rig it shares with ``chip_smoke.py`` lives in the twin."""
    assert "chip_smoke" not in set(_top_level_imports(PACKAGE / "scripts" / "bench.py"))
    assert "chip_smoke" not in set(_top_level_imports(PACKAGE / "ops" / "kernel_flops.py"))


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
    each of B1, B2, B3, B5, the BatchNorm kernels and gather mode's kernels)
    raises; nothing substitutes the plain version."""
    from mvdetr_tpu_torch.ops import batch_norm, kernel_build, lane_broadcast, msda, msda_windowed, warp

    loaders = {msda_windowed.KERNEL_NAME: msda_windowed.load_library,
               msda_windowed.BWD_KERNEL_NAME: msda_windowed.load_bwd_library, warp.KERNEL_NAME: warp.load_library,
               lane_broadcast.KERNEL_NAME: lane_broadcast.load_library, batch_norm.KERNEL_NAME: batch_norm.load_library,
               msda.KERNEL_NAME: msda.load_library}
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


@pytest.mark.parametrize("name", ["msda_windowed_fwd", "msda_windowed_bwd", "warp_bwd", "lane_broadcast", "batch_norm",
                                  "msda_gather"])
def test_backward_kernels_use_no_atomics(name):
    """B1, the backward kernels, B5, the BatchNorm kernels and gather mode's
    kernels sum each output in one fixed order, so two launches, and two
    train steps, repeat bitwise: outside comments, their sources name no
    atomic operation (CUDA's atomic*() or PTX atom/red)."""
    code = re.sub(r"//[^\n]*", "", (PACKAGE / "csrc" / f"{name}.cu").read_text())
    assert not re.search(r"\batomic\w*\s*\(|\batom\.|\bred\.", code)


def _gather_case(case):
    """Inputs of gather mode's kernel wrappers on the CPU (B=1, L=2 maps of
    3x4, M=2, D=8, P=4, bf16), with the one fault ``case`` names."""
    rng = np.random.default_rng(0)
    d = 12 if case == "head_not_multiple_of_8" else 8
    value = torch.from_numpy(rng.standard_normal((1, 24, 2, d), dtype=np.float32)).bfloat16()
    loc = torch.from_numpy(rng.uniform(0, 1, (1, 5, 2, 2, 4, 2)).astype(np.float32))
    wgt = torch.full((1, 5, 2, 2, 4), 0.125, dtype=torch.bfloat16)
    g = torch.ones((1, 5, 2 * d), dtype=torch.bfloat16)
    if case == "weights_dtype":
        wgt = wgt.float()
    elif case == "cotangent_dtype":
        g = g.float()
    elif case == "locations_f64":
        loc = loc.double()
    elif case == "locations_not_contiguous":
        loc = loc.transpose(1, 2).contiguous().transpose(1, 2)
    return value, loc, wgt, g


@pytest.mark.parametrize("case,match", [
    ("head_not_multiple_of_8", "multiple of 8"), ("weights_dtype", "do not fit"), ("cotangent_dtype", "msda_gather_bwd: g"),
    ("locations_f64", "f32 locations"), ("locations_not_contiguous", "locations must be contiguous"),
    ("cpu_tensors", "CUDA device only"),
])
def test_gather_kernel_wrappers_refuse_what_the_kernels_do_not_take(case, match):
    """``msda_gather_fwd`` and ``msda_gather_bwd`` raise before any build or
    launch on an input the kernels do not take: D not a multiple of 8,
    weights or a cotangent in another dtype than the value, locations not
    f32 or not contiguous; and on tensors off the card, so a CPU tensor
    never reaches them; no launch is counted."""
    from mvdetr_tpu_torch.ops import msda

    value, loc, wgt, g = _gather_case(case)
    before = (msda.msda_gather_fwd.launches, msda.msda_gather_bwd.launches)
    if case != "cotangent_dtype":
        with pytest.raises(ValueError, match=match):
            msda.msda_gather_fwd(value, loc, wgt, 3, 4)
    with pytest.raises(ValueError, match=match):
        msda.msda_gather_bwd(value, loc, wgt, g, 3, 4)
    assert (msda.msda_gather_fwd.launches, msda.msda_gather_bwd.launches) == before


def _all_imports(path: Path):
    """Every module an import statement in ``path`` names, with its line."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from ((alias.name.split(".")[0], node.lineno) for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


def test_data_path_imports_no_cv2_or_pil_but_for_the_image_decode():
    """The card's machine has neither cv2 nor PIL: no module of the port's
    data path or of its scripts imports them, except ``data/adapters.py``'s
    ``load_image_rgb`` (real datasets' JPEGs, which raises a clear error
    without both); a PNG (``data/png.py``, ``data/trees.py``) needs neither."""
    for path in sorted((PACKAGE / "data").rglob("*.py")) + sorted((PACKAGE / "native").rglob("*.py")) + sorted(
            (PACKAGE / "scripts").rglob("*.py")):
        found = [(name, line) for name, line in _all_imports(path) if name in ("cv2", "PIL")]
        if path.name == "adapters.py":
            tree = ast.parse(path.read_text())
            decode = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "load_image_rgb")
            assert found and all(decode.lineno <= line <= decode.end_lineno for _, line in found), found
        else:
            assert not found, f"{path.relative_to(ROOT)} imports {found}"
