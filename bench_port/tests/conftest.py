"""Shared fixtures of the benchmark's CPU tests: a copy of
``BENCHMARK.json`` whose configurations are cut to a few thousand points,
so that a whole run of a cell takes seconds on the CPU."""

import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
#: Each configuration's sizes for a CPU run (the shapes stay, the scale is cut)
TINY = {"poisson2d_3162_f32": {"nx": 48, "ny": 48},
        "poisson2d_3162_f64": {"nx": 48, "ny": 48},
        "poisson2d_6324_f32_x4": {"nx": 48, "ny": 48}}


def full_bench(root: Path = ROOT) -> dict:
    """``BENCHMARK.json`` at full size, its configuration files by absolute path."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        c["file"] = str(root / c["file"])
    return bench


def tiny_bench(tmp: Path, root: Path = ROOT) -> dict:
    bench = full_bench(root)
    for c in bench["configs"]:
        cfg = json.loads(Path(c["file"]).read_text())
        cfg.update(TINY.get(c["name"], {}))
        path = tmp / f"{c['name']}.json"
        path.write_text(json.dumps(cfg))
        c["file"] = str(path)
    return bench


@pytest.fixture(scope="session")
def bench(tmp_path_factory):
    return tiny_bench(tmp_path_factory.mktemp("configs"))
