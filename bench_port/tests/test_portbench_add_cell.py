"""A configuration, a traffic mix, a cell and a per-layer metric added as
files alone, in a copy of the benchmark: the harness finds each by its name
and runs the new cell with no edit to any file it had."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def test_a_cell_added_as_files_runs_with_no_edit(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bp = tmp_path / "bench_port"
    (bp / "configs" / "poisson2d_64_f32.json").write_text(json.dumps(
        {"name": "poisson2d_64_f32", "nx": 64, "ny": 32, "dtype": "float32", "ranks": 1}))
    (bp / "traffic" / "gmres10_cycles.json").write_text(json.dumps(
        {"loop": "gmres_cycles", "kdim": 10, "rhs_pool": 2, "trace_steps": 3,
         "end_to_end": {"cycle_s": "per_step", "cycle_p95_s": "p95"}}))
    (bp / "limits" / "poisson64.gmres10.json").write_text(json.dumps(
        {"x_gap": 1e-4, "residual_gap": 2e-4, "matvec_gap": 1e-6}))
    (bp / "metrics" / "steps_traced.py").write_text(
        "def read(run):\n    return run.traced.steps if run.traced else None\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "poisson2d_64_f32", "source": "test",
                             "file": "bench_port/configs/poisson2d_64_f32.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "poisson64.gmres10", "config": "poisson2d_64_f32",
                               "traffic": "gmres10_cycles", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("cycle_s", "cycle_p95_s"):
            m["workloads"].append("poisson64.gmres10")
    bench["per_layer"].append({"name": "steps_traced", "unit": "steps", "better": "higher",
                               "source": "device_trace", "layer": "device", "moves": "cycle_s",
                               "workloads": ["poisson64.gmres10"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys\nfrom bench_port import session\n"
            "for trace in (False, True):\n"
            "    print(session.run_cell('poisson64.gmres10', 2**32 + 3, 0.3, trace, "
            "device='cpu')[0])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, env={"PATH": "/usr/bin:/bin",
                                         "PYTHONPATH": f"{tmp_path}:{ROOT}"})
    assert out.returncode == 0, out.stderr[-2000:]
    plain, traced = (json.loads(line) for line in out.stdout.strip().splitlines()[-2:])
    assert plain["correct"] is True
    assert set(plain["metrics"]) == {"cycle_s", "cycle_p95_s", "setup_s"}
    # the traffic mix's 3 first steps, or all of them where the window held fewer
    assert traced["metrics"]["steps_traced"]["value"] == min(3, traced["attempted"]) >= 1
