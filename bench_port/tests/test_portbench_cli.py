"""The command prints no result and exits non-zero where it cannot
measure: no CUDA device (this CPU), and a directory that holds only
``BENCHMARK.json`` and the benchmark's files, without the program."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "poisson3162.gmres30", "--seed", str(2**32 + 11), "--seconds", "1",
        "--trace", "0"]


def _run(cwd, pythonpath=None):
    env = {"PATH": "/usr/bin:/bin"}
    if pythonpath:
        env["PYTHONPATH"] = pythonpath
    return subprocess.run([sys.executable, "bench_port/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, env=env, timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
