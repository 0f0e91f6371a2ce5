"""The harness prints no result and exits non-zero where it cannot
measure: without the cell's CUDA devices, and in a copy of the benchmark
alone (BENCHMARK.json and `benchmark/`, without the program)."""

import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT


def _run(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "mono.dive",
                           "--seed", "1", "--seconds", "1"], cwd=cwd, capture_output=True,
                          text=True, timeout=300)


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_result_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
