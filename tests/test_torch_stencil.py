"""The port's stencil against the JAX Pallas kernel, the dense oracle and,
on a GPU, against the CUDA kernel.

On the CPU the wrappers of lightkrylov_tpu_torch.ops.stencil compute the
plain version; it is held against the Pallas kernels run in interpret mode,
as tests/test_pallas.py runs them.  The tests marked ``cuda`` compare the
CUDA kernel with the plain version and skip where there is no GPU; JAX is
imported only by the tests that use it, so that on a machine with a GPU and
no JAX the ``cuda`` tests run with
``python -m pytest --noconftest -m cuda tests/test_torch_stencil.py``.
"""

import numpy as np
import pytest
import torch

import lightkrylov_tpu_torch as lt
from lightkrylov_tpu_torch.convert import port_operator
from lightkrylov_tpu_torch.ops import _build, stencil
from lightkrylov_tpu_torch.utils import timer

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """These tests ask for the CPU: the package's default device is the card."""
    prev = lt.constants.default_device()
    lt.constants.set_default_device("cpu")
    yield
    lt.constants.set_default_device(prev)


@pytest.fixture
def pallas():
    """``(jax.numpy, PallasPoisson2D)`` of the JAX package."""
    import jax.numpy as jnp
    from lightkrylov_tpu.ops.pallas import PallasPoisson2D

    return jnp, PallasPoisson2D


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("shape,tile", [((64, 32), 16), ((64, 32), 64),
                                        ((50, 32), 16), ((33, 17), 8)])
def test_stencil_matches_pallas_kernel(pallas, shape, tile):
    jnp, PallasPoisson2D = pallas
    ny, nx = shape
    pal = PallasPoisson2D(nx, ny, dtype=jnp.float64, tile=tile, interpret=True)
    u = np.random.default_rng(0).standard_normal((ny, nx))
    ref = np.asarray(pal.matvec(jnp.asarray(u)))
    got = port_operator(pal).matvec(torch.from_numpy(u)).numpy()
    assert np.allclose(got, ref, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("ny,nx,ty,tx", [(64, 256, 16, 128), (100, 300, 32, 128),
                                         (200, 520, 48, 256)])
def test_stencil_2d_matches_pallas_kernel(pallas, ny, nx, ty, tx):
    jnp, PallasPoisson2D = pallas
    u = np.random.default_rng(7).standard_normal((ny, nx)).astype(np.float32)
    pal = PallasPoisson2D(nx, ny, dtype=jnp.float32, tile=ty, tile_x=tx,
                          interpret=True)
    ref = np.asarray(pal.matvec(jnp.asarray(u)))
    op = port_operator(pal)
    assert isinstance(op, lt.CudaPoisson2D) and op.tile_x == tx
    got = op.matvec(torch.from_numpy(u)).numpy()
    assert got.dtype == np.float32
    assert np.linalg.norm(got - ref) < 1e-6 * np.linalg.norm(ref)


@pytest.mark.parametrize("nx,ny", [(7, 5), (4, 9)])
def test_stencil_matches_dense_oracle(nx, ny):
    op = lt.Poisson2D(nx, ny)
    u = torch.from_numpy(np.random.default_rng(2).standard_normal((ny, nx)))
    dense = op.dense()
    assert dense.shape == (nx * ny, nx * ny)
    want = dense @ u.reshape(-1)
    for got in (op.matvec(u), lt.CudaPoisson2D(nx, ny, dtype=torch.float64).matvec(u)):
        assert torch.allclose(got.reshape(-1), want, rtol=1e-12, atol=1e-9)


def _launches(name):
    """The kernel launches counted so far under ``launches.<name>``."""
    return timer.get_counter(f"launches.{name}")


def test_cpu_tensor_launches_nothing():
    before = (_launches("stencil_matvec"), _launches("stencil_matvec_2d"))
    u = torch.ones(8, 8)
    lt.CudaPoisson2D(8).matvec(u)
    lt.CudaPoisson2D(8, tile_x=128).matvec(u)
    assert (_launches("stencil_matvec"), _launches("stencil_matvec_2d")) == before


def test_non_cpu_tensor_never_takes_the_plain_path():
    """Only a CPU tensor gets the plain version: any other device goes to
    the kernel's checks and raises there."""
    u = torch.empty(4, 4, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        lt.stencil_matvec(u, ihx2=1.0, ihy2=1.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        lt.stencil_matvec_2d(u, ihx2=1.0, ihy2=1.0)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", tmp_path / "cuda")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)
    assert _build.find_nvcc() is None
    with pytest.raises(_build.KernelCompileError, match="nvcc not found"):
        _build.build()
    with pytest.raises(_build.KernelCompileError, match="nvcc not found"):
        _build.load()


# -- on the GPU ---------------------------------------------------------------

SHAPES = [(33, 17), (50, 32), (64, 256), (100, 300), (1000, 3001), (3072, 3072)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-6), (torch.float64, 1e-13)])
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_kernel_matches_plain(cuda, shape, dtype, rel):
    ny, nx = shape
    u = torch.from_numpy(np.random.default_rng(0).standard_normal(shape)).to(cuda, dtype)
    ihx2, ihy2 = float((nx + 1) ** 2), float((ny + 1) ** 2)
    for wrapper in (lt.stencil_matvec, lt.stencil_matvec_2d):
        before = _launches(wrapper.__name__)
        got = wrapper(u, ihx2=ihx2, ihy2=ihy2)
        torch.cuda.synchronize()
        assert _launches(wrapper.__name__) == before + 1
        want = stencil.stencil_matvec_reference(u, ihx2=ihx2, ihy2=ihy2)
        assert torch.linalg.norm(got - want) <= rel * torch.linalg.norm(want)


@pytest.mark.cuda
def test_cuda_kernel_rejects_unsupported_tensors(cuda):
    with pytest.raises(TypeError):
        lt.stencil_matvec(torch.ones(4, 4, device=cuda, dtype=torch.float16),
                          ihx2=1.0, ihy2=1.0)
    with pytest.raises(ValueError):
        lt.stencil_matvec(torch.ones(4, 4, 4, device=cuda), ihx2=1.0, ihy2=1.0)
    with pytest.raises(ValueError):
        lt.stencil_matvec(torch.ones(8, 8, device=cuda).T, ihx2=1.0, ihy2=1.0)
