"""What the benchmark loads: nothing of JAX or of the JAX package, whose
name ``mvdetr_tpu`` the port's ``mvdetr_tpu_torch`` begins with (top-level
names are compared whole), and a reference that loads nothing of the
program."""

import ast
import os
import subprocess
import sys

from benchmark.tests._tiny import BENCH

ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "mvdetr_tpu"}


def loaded_after(code: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sorted(sys.modules)))"],
                         cwd=ROOT, capture_output=True, text=True, check=True, env=env, timeout=600)
    return {name.split(".")[0] for name in out.stdout.split()}


def test_a_run_loads_no_jax():
    code = ("import runpy, sys, glob\n"
            "sys.path.insert(0, '.')\n"
            "runpy.run_path('benchmark/run.py', run_name='bench_run')\n"
            "import benchmark.harness.cells, benchmark.harness.readings, benchmark.harness.faults\n"
            "import benchmark.harness.flops, benchmark.harness.trace\n"
            "import mvdetr_tpu_torch.train, mvdetr_tpu_torch.models, mvdetr_tpu_torch.data.prefetch\n"
            "import mvdetr_tpu_torch.geometry, mvdetr_tpu_torch.ops.msda_windowed, mvdetr_tpu_torch.ops.warp\n"
            "import importlib.util\n"
            "for path in sorted(glob.glob('benchmark/metrics/*.py')):\n"
            "    spec = importlib.util.spec_from_file_location('m', path)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n")
    top = loaded_after(code)
    assert "mvdetr_tpu_torch" in top  # the program itself is loaded ...
    assert not top & FORBIDDEN  # ... and nothing of JAX


def reference_modules() -> list:
    """Every module of ``benchmark/reference/``, the ones a configuration can name among them."""
    return sorted(name[:-3] for name in os.listdir(os.path.join(BENCH, "reference")) if name.endswith(".py"))


def test_the_reference_loads_nothing_of_the_program():
    names = reference_modules()
    assert {"model", "train", "decode", "targets", "geometry"} <= set(names)
    top = loaded_after("\n".join(f"import benchmark.reference.{name}" for name in names))
    assert not top & (FORBIDDEN | {"mvdetr_tpu_torch"})


def test_the_reference_sources_import_nothing_of_the_program():
    folder = os.path.join(BENCH, "reference")
    for name in reference_modules():
        with open(os.path.join(folder, f"{name}.py")) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not {m.split(".")[0] for m in mods} & (FORBIDDEN | {"mvdetr_tpu_torch"}), (name, mods)
            # the reference is the harness's lowest layer: nothing of the benchmark but its own modules
            assert all(m.startswith("benchmark.reference") for m in mods if m.split(".")[0] == "benchmark"), (name, mods)
