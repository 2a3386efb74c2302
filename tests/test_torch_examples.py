"""The port's examples (``lightkrylov_tpu_torch/examples/``), each run once
on the CPU at a small size through its ``main``: it finishes and prints the
lines of the JAX example it ports, and its numbers hold to loose anchors
(the small sizes cut the RK4 steps and Krylov dimensions)."""

import numpy as np
import pytest
import torch

import lightkrylov_tpu_torch as lt
from lightkrylov_tpu_torch.examples import ginzburg_landau, poisson_sharded, roessler

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _restore_default_device():
    """The examples set the default device from ``--cpu``."""
    prev = lt.constants.default_device()
    yield
    lt.constants.set_default_device(prev)


def test_poisson_sharded_example_one_process(capsys):
    """Without torchrun the example runs as one process: eighs converges to
    the closed-form spectrum (f64, 1e-10 relative)."""
    poisson_sharded.main(["--cpu", "--n", "32", "--nev", "2", "--kdim", "20"])
    out = capsys.readouterr().out
    assert "devices=1  grid=32x32" in out and "eighs: converged=True" in out
    errs = [float(line.split("exact-rel-err=")[1].split()[0])
            for line in out.splitlines() if "exact-rel-err=" in line]
    assert len(errs) == 2 and max(errs) < 1e-10


def test_ginzburg_landau_example(capsys, tmp_path):
    out_path = tmp_path / "gl.npy"
    ginzburg_landau.main(["--cpu", "--nx", "32", "--n-steps", "20", "--nev", "2", "--kdim", "10",
                          "--tau", "0.5", "--out", str(out_path)])
    out = capsys.readouterr().out
    assert "direct spectrum (converged=True" in out
    assert "adjoint propagator converged=True" in out
    # the timing summary goes through the package logger, which the
    # example's logger_setup() points at stdout
    assert "timing summary" in out and "gl_direct_eigs" in out
    assert np.load(out_path).shape == (2, 3)


def test_roessler_example(capsys):
    """At 30 RK4 steps a period the orbit still closes (Newton converges)
    with T within 1e-3 of 5.88108845 and the leading Lyapunov exponent
    within 1e-2 of 0.149141556."""
    roessler.main(["--cpu", "--attractor-steps", "100", "--upo-steps", "30", "--otd-steps", "100",
                   "--floquet-steps", "30"])
    out = capsys.readouterr().out
    line = next(line for line in out.splitlines() if line.startswith("UPO:"))
    assert "converged=True" in line
    assert abs(float(line.split("T = ")[1].split()[0]) - 5.88108845) < 1e-3
    le = out.split("Lyapunov exponents:  [")[1].split("]")[0].split()
    assert abs(float(le[0]) - 0.149141556) < 1e-2
