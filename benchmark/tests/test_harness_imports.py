"""What a run may load: no JAX and no JAX package (compared by whole
top-level names, so that the port passes), and a plain reference that
imports nothing of the port."""

import os
import subprocess
import sys

from harness import guard, manifest

ROOT = manifest.ROOT


def test_names_compare_whole():
    loaded = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
              "e2e_asr_pytorch_tpu", "e2e_asr_pytorch_tpu.ops.audio",
              "e2e_asr_pytorch_tpu_torch", "e2e_asr_pytorch_tpu_torch.ops",
              "jaxtyping", "numpy"]
    assert guard.forbidden_loaded(loaded) == [
        "e2e_asr_pytorch_tpu", "e2e_asr_pytorch_tpu.ops.audio", "flax.linen",
        "jax", "jax.numpy", "jaxlib.xla_client"]


def test_the_reference_imports_nothing_of_the_port_or_jax():
    assert guard.reference_imports_of(ROOT / "benchmark" / "reference") == []


def test_the_harness_imports_no_jax():
    bad = guard.reference_imports_of(ROOT / "benchmark",
                                     banned=guard.FORBIDDEN)
    assert bad == []


def test_a_cell_run_loads_neither_jax_nor_the_jax_package():
    """Set-up, steps and reference of a debug-width cell in a fresh
    process: sys.modules holds the port and no forbidden name."""
    code = (
        "import sys, torch\n"
        "sys.path[:0] = [{bench!r}, {root!r}]\n"
        "import run\n"
        "from debug_cells import lm_cell\n"
        "res = run.execute(lm_cell(), 5, 0.2, True, torch.device('cpu'))\n"
        "from harness import guard\n"
        "assert 'e2e_asr_pytorch_tpu_torch' in sys.modules\n"
        "print('LOADED', guard.forbidden_loaded())\n").format(
            bench=str(ROOT / "benchmark"), root=str(ROOT))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "benchmark" / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(ROOT), env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout


def test_without_a_card_the_run_refuses_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        return  # the refusal is for machines without the cell's card
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "lm_best.train",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "refusing" in out.stderr


def test_a_directory_with_only_the_benchmark_fails(tmp_path):
    """Without the port beside it the run exits non-zero, no result."""
    import shutil
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    code = ("import sys, torch\n"
            "sys.path[:0] = [{b!r}, {r!r}]\n"
            "sys.path[:] = [p for p in sys.path if p != {repo!r}]\n"
            "import run\n"
            "from harness.manifest import load_cell\n"
            "run.execute(load_cell('lm_best.train'), 1, 0.1, False,\n"
            "            torch.device('cpu'))\n").format(
                b=str(tmp_path / "benchmark"), r=str(tmp_path),
                repo=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode != 0
    assert "e2e_asr_pytorch_tpu_torch" in out.stderr
    assert '"correct"' not in out.stdout
