"""The port's operator layer, Givens rotations and records against the JAX
package's."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightkrylov_tpu as lk
import lightkrylov_tpu_torch as lt
from lightkrylov_tpu.models import poisson2d_eigvals as j_eigvals
from lightkrylov_tpu.ops.pallas import PallasPoisson2D
from lightkrylov_tpu.utils import linalg as jlinalg
from lightkrylov_tpu_torch.convert import port_operator, port_options

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """These tests ask for the CPU: the package's default device is the card."""
    prev = lt.constants.default_device()
    lt.constants.set_default_device("cpu")
    yield
    lt.constants.set_default_device(prev)


def _rand(rng, shape, dtype):
    a = rng.standard_normal(shape)
    if np.issubdtype(dtype, np.complexfloating):
        a = a + 1j * rng.standard_normal(shape)
    return a.astype(dtype)


def test_operator_algebra_matches_jax(dtype_dp):
    rng = np.random.default_rng(0)
    A, B = _rand(rng, (6, 6), dtype_dp), _rand(rng, (6, 6), dtype_dp)
    x = _rand(rng, (6,), dtype_dp)
    Aj, Bj = lk.DenseOperator(jnp.asarray(A)), lk.DenseOperator(jnp.asarray(B))
    At, Bt = port_operator(Aj), port_operator(Bj)
    tol = lk.constants.rtol(dtype_dp)
    pairs = [
        (Aj, At),
        (2.5 * Aj, 2.5 * At),
        (Aj - Bj, At - Bt),
        (Aj @ Bj, At @ Bt),
        (Aj.H, At.H),
        (lk.AxpbyOperator(0.5, Aj, -2.0, Bj, transA=True),
         lt.AxpbyOperator(0.5, At, -2.0, Bt, transA=True)),
        # default rmatvec: jax.linear_transpose vs torch.func.vjp
        (lk.MatvecOperator(lambda v: jnp.asarray(A) @ v),
         lt.MatvecOperator(lambda v: torch.from_numpy(A) @ v)),
        (lk.DiagonalOperator(jnp.asarray(x)), port_operator(lk.DiagonalOperator(jnp.asarray(x)))),
    ]
    for opj, opt in pairs:
        for kind in ("matvec", "rmatvec"):
            ref = np.asarray(getattr(opj, kind)(jnp.asarray(x)))
            got = getattr(opt, kind)(torch.from_numpy(x)).numpy()
            assert np.linalg.norm(got - ref) <= tol * np.linalg.norm(ref), (opj, kind)
    assert lt.adjoint(lt.adjoint(At)) is At
    assert isinstance(port_operator(lk.IdentityOperator()), lt.IdentityOperator)


def test_givens_rotation_matches_jax(dtype_dp):
    rng = np.random.default_rng(1)
    n, k = 6, 4
    h = _rand(rng, (n + 1,), dtype_dp)
    c = np.abs(rng.standard_normal(n))
    s = _rand(rng, (n,), dtype_dp)
    c[k:] = 0
    s[k:] = 0
    hj, cj, sj = jlinalg.apply_givens_rotation(jnp.asarray(h), jnp.asarray(c),
                                               jnp.asarray(s), k)
    ht, ct, st = lt.linalg.apply_givens_rotation(torch.from_numpy(h), torch.from_numpy(c),
                                                 torch.from_numpy(s), k)
    for got, ref in ((ht, hj), (ct, cj), (st, sj)):
        assert np.allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-14)
    for a, b in ((0.0, 0.0), (0.0, 2.0), (3.0, -4.0)):
        cj, sj = jlinalg.givens_rotation(jnp.asarray(a), jnp.asarray(b))
        ct, st = lt.linalg.givens_rotation(torch.tensor(a), torch.tensor(b))
        assert np.allclose([float(ct), float(st)], [float(cj), float(sj)])
    R = np.triu(rng.standard_normal((5, 5))) + 5 * np.eye(5)
    y = rng.standard_normal(5)
    assert np.allclose(lt.linalg.solve_triangular(torch.from_numpy(R), torch.from_numpy(y)).numpy(),
                       np.asarray(jlinalg.solve_triangular(jnp.asarray(R), jnp.asarray(y))))


def test_constants_match_jax(dtype):
    assert lt.constants.atol(dtype) == lk.constants.atol(dtype)
    assert lt.constants.rtol(dtype) == lk.constants.rtol(dtype)
    assert lt.constants.eps(dtype) == lk.constants.eps(dtype)
    tdt = lt.constants.as_torch_dtype(dtype)
    assert lt.constants.rtol(tdt) == lk.constants.rtol(dtype)
    assert lt.constants.is_complex_dtype(tdt) == lk.constants.is_complex_dtype(dtype)
    assert lt.constants.real_dtype_of(tdt) == \
        lt.constants.as_torch_dtype(lk.constants.real_dtype_of(dtype))
    assert lt.constants.get_rank() == 0 and lt.io_rank()


def test_options_mirror_jax():
    for jcls, tcls in ((lk.GMRESOptions, lt.GMRESOptions), (lk.CGOptions, lt.CGOptions)):
        jf = [(f.name, f.default) for f in dataclasses.fields(jcls)]
        assert [(f.name, f.default) for f in dataclasses.fields(tcls)] == jf
    opts = port_options(lk.GMRESOptions(kdim=7, orthogonalization="cgs2"))
    assert opts == lt.GMRESOptions(kdim=7, orthogonalization="cgs2")


def test_poisson_models_match_jax():
    op = lt.Poisson2D(6, 4)
    assert np.array_equal(op.dense().numpy(), lk.models.Poisson2D(6, 4).dense())
    assert np.array_equal(lt.poisson2d_eigvals(6, 4), j_eigvals(6, 4))
    M = lt.BlockJacobiPoisson(op)
    Mj = lk.models.BlockJacobiPoisson(lk.models.Poisson2D(6, 4))
    assert np.allclose(M.Binv.numpy(), np.asarray(Mj.Binv), rtol=1e-14)
    assert op.template().shape == (4, 6) and op.template().dtype == torch.float64


def test_check_info_and_counters():
    with pytest.raises(lt.LightKrylovError):
        lt.check_info(-3, "gram_schmidt")
    lt.check_info(-3, "gmres")   # not converged: a warning only
    lt.timer.reset_counters()
    op = lt.Poisson2D(8)
    lt.timer.count_applications(op, 3)
    assert lt.timer.get_counter("Poisson2D.matvec") == 3
    lt.timer.set_timing(True)
    try:
        lt.cg(op, torch.ones(8, 8, dtype=torch.float64))
        assert lt.global_watch.timer("cg").count == 1
    finally:
        lt.timer.set_timing(False)


# -- the package's default device -------------------------------------------------

def test_the_default_device_is_the_card():
    """A process that sets nothing gets ``cuda``; the fixture above asks for
    the CPU in this module."""
    import subprocess
    import sys
    from pathlib import Path

    out = subprocess.run(
        [sys.executable, "-c", "import lightkrylov_tpu_torch as lt; print(lt.default_device())"],
        capture_output=True, text=True, check=True, timeout=300,
        cwd=Path(__file__).resolve().parent.parent)
    assert out.stdout.strip() == "cuda"
    assert lt.default_device() == torch.device("cpu")


@pytest.mark.parametrize("make", [
    lambda: lt.Poisson2D(8),
    lambda: lt.CudaPoisson2D(8),
    lambda: lt.ConvectionDiffusion2D(8),
    lambda: port_operator(lk.models.Poisson2D(8)),
    lambda: port_operator(PallasPoisson2D(8, interpret=True)),
], ids=["Poisson2D", "CudaPoisson2D", "ConvectionDiffusion2D", "port-Poisson2D",
        "port-PallasPoisson2D"])
def test_constructors_resolve_the_default_device(make):
    """With the package's default, a model names the card, and nothing is
    allocated until a template is asked for."""
    lt.set_default_device("cuda")  # the fixture restores the CPU
    assert make().device == torch.device("cuda")
    assert lt.Poisson2D(8, device="cpu").template().device == torch.device("cpu")


def test_no_fallback_to_the_cpu_without_a_card():
    """An allocation on the default device goes to the card or fails there:
    templates, operator data, converted arrays and Block-ELL matrices."""
    import scipy.sparse as sp

    from lightkrylov_tpu_torch.convert import to_torch

    lt.set_default_device("cuda")  # the fixture restores the CPU
    makers = {
        "template": lambda: lt.Poisson2D(8).template(),
        "Toeplitz": lambda: lt.TridiagToeplitz(8, 2.0, -1.0).a,
        "GinzburgLandau": lambda: lt.GinzburgLandau(16).mu,
        "DenseOperator": lambda: lt.DenseOperator(np.eye(3)).data,
        "to_torch": lambda: to_torch({"a": np.ones(3)})["a"],
        "port_operator": lambda: port_operator(lk.DenseOperator(jnp.eye(3))).data,
        "bell_from_scipy": lambda: lt.bell_from_scipy(sp.eye(16, format="csr")).data,
    }
    for name, make in makers.items():
        if torch.cuda.is_available():
            assert make().device.type == "cuda", name
        else:
            with pytest.raises(AssertionError, match="CUDA"):
                make()
