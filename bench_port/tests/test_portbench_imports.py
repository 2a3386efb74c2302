"""Nothing the harness or the reference imports is JAX or the JAX package,
each top-level name compared whole; the reference imports nothing of the
program."""

import subprocess
import sys
from pathlib import Path

from bench_port import harness

ROOT = Path(__file__).resolve().parents[2]


def test_forbidden_names_are_compared_whole():
    mods = {"lightkrylov_tpu_torch": 1, "lightkrylov_tpu_torch.ops": 1, "jaxtyping": 1,
            "numpy": 1}
    assert harness.forbidden_loaded(mods) == []
    assert harness.forbidden_loaded({**mods, "lightkrylov_tpu.solvers": 1}) == ["lightkrylov_tpu"]
    assert harness.forbidden_loaded({"jax._src": 1, "flax": 1}) == ["flax", "jax"]


def _modules_after(code: str) -> set:
    code += "\nimport sys\nprint(' '.join(sys.modules))"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    return {m.split(".", 1)[0] for m in out.stdout.split()}


def test_a_whole_cpu_run_loads_no_jax():
    tops = _modules_after(
        "from bench_port.tests.conftest import tiny_bench\n"
        "import tempfile, pathlib\n"
        "from bench_port import session\n"
        "b = tiny_bench(pathlib.Path(tempfile.mkdtemp()))\n"
        "session.run_cell('poisson3162.gmres30', 2**33 + 1, 0.2, True, device='cpu', bench=b)\n")
    assert "lightkrylov_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN_MODULES)


def test_the_reference_imports_nothing_of_the_program():
    tops = _modules_after("import bench_port.reference.gmres, bench_port.reference.cg, "
                          "bench_port.reference.poisson, bench_port.reference.precision")
    assert not tops & ({"lightkrylov_tpu_torch"} | set(harness.FORBIDDEN_MODULES))
