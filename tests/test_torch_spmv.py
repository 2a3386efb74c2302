"""The port's Block-ELL tier against the JAX package's and, on a GPU, the
CUDA kernel against its plain version.

On the CPU, ``bell_spmv`` computes the plain version; it is held against the
Pallas kernel run in interpret mode, as tests/test_pallas.py runs it, and
against scipy.  The layouts of ``bell_from_scipy`` (native assembler and
numpy path) must equal the JAX package's exactly.  Solves through the
operator use the float64 ``rtol`` of ``constants.py`` (about 3.2e-8).  The
tests marked ``cuda`` skip where there is no GPU; JAX is imported only by
the tests that use it, so that on a machine with a GPU and no JAX they run
with ``python -m pytest --noconftest -m cuda tests/test_torch_spmv.py``.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightkrylov_tpu_torch as lt
from lightkrylov_tpu_torch import native
from lightkrylov_tpu_torch.convert import port_operator
from lightkrylov_tpu_torch.ops import spmv
from lightkrylov_tpu_torch.utils import timer

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """These tests ask for the CPU: the package's default device is the card."""
    prev = lt.constants.default_device()
    lt.constants.set_default_device("cpu")
    yield
    lt.constants.set_default_device(prev)

RTOL = lt.constants.rtol(torch.float64)  # sqrt(1e-15), as in the JAX constants.py


@pytest.fixture
def jpallas():
    """``(jax.numpy, lightkrylov_tpu, lightkrylov_tpu.ops.pallas)``."""
    import jax.numpy as jnp

    import lightkrylov_tpu as lk
    from lightkrylov_tpu.ops import pallas

    return jnp, lk, pallas


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _random_csr(m, n, density, seed, eye=False):
    A = sp.random(m, n, density=density, random_state=seed, format="csr")
    return (A + sp.eye(m, n)).tocsr() if eye else A


def _assert_same_layout(got, ref):
    assert got.K == ref.K and got.shape == tuple(ref.shape) and got.nnz == ref.nnz
    assert got.fill_ratio == ref.fill_ratio
    assert got.cols.dtype == torch.int32
    assert np.array_equal(got.cols.numpy(), np.asarray(ref.cols))
    assert np.array_equal(got.data.numpy(), np.asarray(ref.data))


LAYOUTS = {
    "8x16-ragged-f64": dict(m=100, n=90, bm=8, bn=16, dtype=np.float64),
    "8x128-f64": dict(m=256, n=256, bm=8, bn=128, dtype=np.float64),
    "8x128-ragged-f32": dict(m=300, n=200, bm=8, bn=128, dtype=np.float32),
    "4x32-c128": dict(m=70, n=70, bm=4, bn=32, dtype=np.complex128),
}


@pytest.mark.parametrize("case", list(LAYOUTS))
def test_bell_layout_matches_jax(jpallas, case):
    _, _, pallas = jpallas
    c = LAYOUTS[case]
    A = _random_csr(c["m"], c["n"], 0.05, seed=1)
    if np.dtype(c["dtype"]).kind == "c":
        A = (A + 1j * _random_csr(c["m"], c["n"], 0.05, seed=2)).tocsr()
    ref = pallas.bell_from_scipy(A, bm=c["bm"], bn=c["bn"], dtype=c["dtype"])
    got = lt.bell_from_scipy(A, bm=c["bm"], bn=c["bn"], dtype=c["dtype"])
    assert got.data.dtype == lt.constants.as_torch_dtype(c["dtype"])
    _assert_same_layout(got, ref)


def test_numpy_path_matches_jax_native(jpallas, monkeypatch):
    """With the native assembler off, the numpy path gives the layout the
    JAX package's native assembler gives."""
    _, _, pallas = jpallas
    A = _random_csr(300, 300, 0.02, seed=7, eye=True)
    ref = pallas.bell_from_scipy(A, bm=8, bn=128, dtype=np.float64)
    monkeypatch.setattr(native, "available", lambda: False)
    _assert_same_layout(lt.bell_from_scipy(A, bm=8, bn=128, dtype=np.float64), ref)


def test_native_loader_matches_jax_native():
    from lightkrylov_tpu import native as jnative

    if not (native.available() and jnative.available()):
        pytest.skip("native assembler unavailable (no g++)")
    A = _random_csr(300, 280, 0.02, seed=8, eye=True)
    for dtype in (np.float32, np.float64):
        got = native.bell_assemble(A, 8, 128, dtype)
        ref = jnative.bell_assemble(A, 8, 128, dtype)
        assert got[2] == ref[2]
        assert got[0].dtype == dtype
        assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])


def test_native_loader_without_compiler_falls_back(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert not native.available()
    assert "g++ not found" in native.unavailable_reason()
    with pytest.raises(RuntimeError, match="unavailable"):
        native.bell_assemble(sp.eye(8, format="csr"), 8, 8)
    A = _random_csr(40, 40, 0.1, seed=9, eye=True)
    bell = lt.bell_from_scipy(A, bm=8, bn=16, dtype=np.float64)
    x = np.random.default_rng(0).standard_normal(40)
    y = lt.BellOperator(bell).matvec(torch.from_numpy(x)).numpy()
    assert np.allclose(y, A @ x, rtol=1e-12, atol=1e-12)


MATVEC_SHAPES = {
    "256-8x128": dict(m=256, n=256, bm=8, bn=128, eye=True, seed=2),
    "100x90-8x16": dict(m=100, n=90, bm=8, bn=16, eye=False, seed=3),
    "300x200-8x128": dict(m=300, n=200, bm=8, bn=128, eye=False, seed=4),
}


@pytest.mark.parametrize("case", list(MATVEC_SHAPES))
def test_bell_matvec_and_rmatvec_match_jax(jpallas, case):
    jnp, _, pallas = jpallas
    c = MATVEC_SHAPES[case]
    A = _random_csr(c["m"], c["n"], 0.03, seed=c["seed"], eye=c["eye"])
    op_j = pallas.BellOperator(pallas.bell_from_scipy(A, bm=c["bm"], bn=c["bn"],
                                                      dtype=np.float64), interpret=True)
    op_t = port_operator(op_j)
    assert isinstance(op_t, lt.BellOperator) and op_t.shape == (c["m"], c["n"])
    rng = np.random.default_rng(5)
    x, y = rng.standard_normal(c["n"]), rng.standard_normal(c["m"])
    got = op_t.matvec(torch.from_numpy(x)).numpy()
    assert np.allclose(got, np.asarray(op_j.matvec(jnp.asarray(x))), rtol=1e-12, atol=1e-12)
    assert np.allclose(got, A @ x, rtol=1e-12, atol=1e-12)
    gotr = op_t.rmatvec(torch.from_numpy(y)).numpy()
    assert np.allclose(gotr, np.asarray(op_j.rmatvec(jnp.asarray(y))), rtol=1e-12, atol=1e-12)
    assert np.allclose(gotr, A.T @ y, rtol=1e-12, atol=1e-12)
    assert op_t.template().shape == (c["n"],)


def test_complex_rmatvec_is_the_adjoint():
    A = (_random_csr(60, 50, 0.1, seed=10) + 1j * _random_csr(60, 50, 0.1, seed=11)).tocsr()
    op = lt.BellOperator(lt.bell_from_scipy(A, bm=4, bn=16, dtype=np.complex128))
    rng = np.random.default_rng(12)
    x = rng.standard_normal(50) + 1j * rng.standard_normal(50)
    y = rng.standard_normal(60) + 1j * rng.standard_normal(60)
    assert np.allclose(op.matvec(torch.from_numpy(x)).numpy(), A @ x, rtol=1e-12, atol=1e-12)
    assert np.allclose(op.rmatvec(torch.from_numpy(y)).numpy(), A.conj().T @ y,
                       rtol=1e-12, atol=1e-12)


def _dense_from_blocks(data, cols, n_p):
    nbr, K, bm, bn = data.shape
    dense = np.zeros((nbr * bm, n_p))
    for r in range(nbr):
        for k in range(K):
            j = cols[r, k]
            dense[r * bm:(r + 1) * bm, j * bn:(j + 1) * bn] += data[r, k]
    return dense


def _blocks_with_repeats(rng, nbr, K, bm, bn, nbc):
    """Random blocks whose block-rows repeat block-columns, with zero
    padding slots at block-column 0."""
    data = rng.standard_normal((nbr, K, bm, bn))
    cols = rng.integers(0, nbc, size=(nbr, K)).astype(np.int32)
    cols[:, 1] = cols[:, 0]           # a repeated block-column in every row
    cols[::3, -1] = 0                 # padding slots
    data[::3, -1] = 0.0
    return data, cols


def test_reference_sums_repeated_columns_and_padding():
    rng = np.random.default_rng(13)
    data, cols = _blocks_with_repeats(rng, 9, 4, 8, 16, nbc=5)
    x = rng.standard_normal(5 * 16)
    got = spmv.bell_spmv_reference(torch.from_numpy(data), torch.from_numpy(cols),
                                   torch.from_numpy(x)).numpy()
    assert np.allclose(got, _dense_from_blocks(data, cols, 80) @ x, rtol=1e-12, atol=1e-12)


def test_operator_rejects_out_of_grid_columns():
    data = torch.zeros(2, 2, 8, 16)
    cols = torch.tensor([[0, 1], [2, 0]], dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        lt.BellOperator(lt.BellMatrix(data, cols, (16, 32), nnz=0))


def _launches(name):
    """The kernel launches counted so far under ``launches.<name>``."""
    return timer.get_counter(f"launches.{name}")


def test_cpu_tensor_launches_nothing():
    before = _launches("bell_spmv")
    bell = lt.bell_from_scipy(sp.eye(32, format="csr"), bm=8, bn=16, dtype=np.float32)
    lt.BellOperator(bell).matvec(torch.ones(32))
    assert _launches("bell_spmv") == before


def test_non_cpu_tensor_never_takes_the_plain_path():
    """Only a CPU tensor gets the plain version: any other device goes to
    the kernel's checks and raises there."""
    data = torch.empty(2, 1, 8, 16, device="meta")
    cols = torch.empty(2, 1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        lt.bell_spmv(data, cols, torch.empty(16, device="meta"))


def test_cg_through_bell_matches_jax(jpallas):
    """CG on a Hermitian Block-ELL Poisson 16^2 operator, both packages
    (the JAX test_bell_poisson_cg case)."""
    jnp, lk, pallas = jpallas
    dense = lt.Poisson2D(16).dense().numpy()
    op_j = pallas.BellOperator(pallas.bell_from_scipy(sp.csr_matrix(dense), dtype=np.float64),
                               is_hermitian=True, interpret=True)
    b = np.random.default_rng(6).standard_normal(256)
    xj, infoj, metaj = lk.cg(op_j, jnp.asarray(b), options=lk.CGOptions(maxiter=400))
    xt, infot, metat = lt.cg(port_operator(op_j), torch.from_numpy(b),
                             options=lt.CGOptions(maxiter=400))
    assert infot == infoj and metat.converged and metaj.converged
    hj = np.asarray(metaj.residuals)
    assert np.linalg.norm(metat.residuals - hj) <= RTOL * np.linalg.norm(hj)
    assert np.linalg.norm(xt.numpy() - np.asarray(xj)) <= RTOL * np.linalg.norm(np.asarray(xj))
    assert np.linalg.norm(dense @ xt.numpy() - b) / np.linalg.norm(b) < 1e-7


@pytest.mark.parametrize("orth", ["dcgs2", "cgs2"])
def test_gmres_through_bell_matches_jax(jpallas, orth):
    """GMRES on the nonsymmetric convection-diffusion matrix in Block-ELL,
    with restarts, both packages."""
    jnp, lk, pallas = jpallas
    dense = lt.ConvectionDiffusion2D(12).dense().numpy()
    op_j = pallas.BellOperator(pallas.bell_from_scipy(sp.csr_matrix(dense), bm=8, bn=16,
                                                      dtype=np.float64), interpret=True)
    b = np.random.default_rng(7).standard_normal(144)
    opts = lk.GMRESOptions(kdim=10, maxiter=20, orthogonalization=orth)
    xj, infoj, metaj = lk.gmres(op_j, jnp.asarray(b), rtol=1e-10, options=opts)
    xt, infot, metat = lt.gmres(port_operator(op_j), torch.from_numpy(b), rtol=1e-10,
                                options=lt.GMRESOptions(kdim=10, maxiter=20,
                                                        orthogonalization=orth))
    assert (infot, metat.n_iter, metat.n_inner) == (infoj, metaj.n_iter, metaj.n_inner)
    assert metat.converged and metat.n_iter > 1
    hj = np.asarray(metaj.residuals)
    assert np.linalg.norm(metat.residuals - hj) <= RTOL * np.linalg.norm(hj)
    assert np.linalg.norm(xt.numpy() - np.asarray(xj)) <= RTOL * np.linalg.norm(np.asarray(xj))


# -- the block shape fitted to the matrix ----------------------------------------


def _convdiff_csr(nx=40, ny=24):
    from bench_port import harness

    return harness.load_module("loops", "bell_gmres_cycles").convdiff_csr(nx, ny, 1e-2, 1.0, 0.5)


def _dense_blocks():
    """Block-row i holds one dense 8 x 128 block at block-column i."""
    rng = np.random.default_rng(17)
    A = sp.lil_matrix((64, 1024))
    for i in range(8):
        A[8 * i:8 * i + 8, 128 * i:128 * i + 128] = rng.standard_normal((8, 128)) + 3.0
    return A.tocsr()


def _spread_rows():
    """Rows of 128 nonzeros one a block-column: the 8 x 128 lower bound
    (one block a block-row) does not decide, the count of blocks does."""
    A = sp.lil_matrix((16, 128 * 128))
    for i in range(16):
        A[i, np.arange(128) * 128 + i] = 1.0 + i
    return A.tocsr()


def _empty_and_short_rows():
    """Empty rows, rows shorter than K, a row of K, and sizes that are a
    multiple of nothing."""
    A = sp.random(103, 77, density=0.05, random_state=18, format="lil")
    A[::4] = 0
    A[7, :13] = np.arange(1.0, 14.0)
    return A.tocsr()


#: name: (matrix, dtype, the fitted shape)
FITTED = {
    "convdiff-f64": (_convdiff_csr, np.float64, (1, 1)),
    "convdiff-f32": (_convdiff_csr, np.float32, (1, 1)),
    "poisson-f64": (lambda: sp.csr_matrix(lt.Poisson2D(16).dense().numpy()), np.float64, (1, 1)),
    "random-f64": (lambda: _random_csr(300, 300, 0.02, seed=19), np.float64, (1, 1)),
    "random-c128": (lambda: _random_csr(120, 90, 0.05, seed=20), np.complex128, (1, 1)),
    "spread-rows-f32": (_spread_rows, np.float32, (1, 1)),
    "dense-8x128-blocks-f64": (_dense_blocks, np.float64, (8, 128)),
    "dense-8x128-blocks-f32": (_dense_blocks, np.float32, (8, 128)),
    "all-zero": (lambda: sp.csr_matrix((50, 60)), np.float64, (1, 1)),
    "tie-f64": (lambda: _tie(), np.float64, (8, 128)),
}


def _tie():
    """8 rows, the longest 683 long, over 8 blocks of 8 x 128: both layouts
    store 65,568 bytes in float64."""
    A = sp.lil_matrix((8, 1024))
    A[0, :683] = 1.0
    A[1, 768] = A[2, 896] = 2.0
    return A.tocsr()


def _canonical(A):
    A = sp.csr_matrix(A)
    A.sum_duplicates()
    return A


def _layout_bytes(A, bm, bn, dtype, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(native, "available", lambda: False)
        bell = lt.bell_from_scipy(A, bm=bm, bn=bn, dtype=dtype, device="cpu")
    return bell.data.numel() * bell.data.element_size() + bell.cols.numel() * 4


@pytest.mark.parametrize("case", list(FITTED))
def test_block_shape_stores_fewer_bytes(case, monkeypatch):
    """The chosen shape is the one whose layout, as the assembler builds
    it, stores fewer bytes (8 x 128 on a tie)."""
    make, dtype, want = FITTED[case]
    A = _canonical(make())
    assert spmv.bell_block_shape(A, dtype) == want
    sizes = {shape: _layout_bytes(A, *shape, dtype, monkeypatch) for shape in spmv.FITTED_SHAPES}
    other = next(s for s in spmv.FITTED_SHAPES if s != want)
    assert sizes[want] < sizes[other] or (sizes[want] == sizes[other] and want == (8, 128))


def test_block_shape_counts_blocks_only_when_the_bound_does_not_decide(monkeypatch):
    counted = []
    count = spmv._blocks_a_row
    monkeypatch.setattr(spmv, "_blocks_a_row", lambda *a: counted.append(a) or count(*a))
    assert spmv.bell_block_shape(_canonical(_convdiff_csr()), np.float64) == (1, 1)
    assert counted == []
    assert spmv.bell_block_shape(_canonical(_spread_rows()), np.float32) == (1, 1)
    assert len(counted) == 1


@pytest.mark.parametrize("case", ["convdiff-f64", "random-f64", "dense-8x128-blocks-f64"])
def test_cpu_default_is_the_jax_layout(jpallas, case):
    """On the CPU no shape means the JAX package's 8 x 128, whatever fits
    the matrix."""
    _, _, pallas = jpallas
    make, dtype, _ = FITTED[case]
    A = make()
    got = lt.bell_from_scipy(A, dtype=dtype, device="cpu")
    assert (got.bm, got.bn) == (8, 128)
    _assert_same_layout(got, pallas.bell_from_scipy(A, dtype=dtype))


@pytest.mark.parametrize("case", ["convdiff-f64", "random-f64", "empty-and-short-rows"])
def test_rows_layout_product_matches_scipy(case):
    """The 1 x 1 layout the card's assembler builds (here on CPU tensors):
    ``K`` the longest row, the product through the operator equal to the
    plain version and within 1e-14 of scipy's, the transposed product
    too."""
    A = _canonical(_empty_and_short_rows() if case == "empty-and-short-rows"
                   else FITTED[case][0]())
    m, n = A.shape
    data, cols = spmv.bell_assemble_torch(A, 1, 1, np.float64, torch.device("cpu"))
    assert data.shape == (m, int(np.diff(A.indptr).max()), 1, 1)
    op = lt.BellOperator(lt.BellMatrix(data, cols, A.shape, A.nnz))
    assert op._n_padded() == n
    rng = np.random.default_rng(21)
    x, y = rng.standard_normal(n), rng.standard_normal(m)
    got = op.matvec(torch.from_numpy(x))
    assert torch.equal(got, spmv.bell_spmv_reference(data, cols, torch.from_numpy(x)))
    want = A @ x
    assert np.linalg.norm(got.numpy() - want) <= 1e-14 * np.linalg.norm(want)
    gotr = op.rmatvec(torch.from_numpy(y)).numpy()
    assert np.linalg.norm(gotr - A.T @ y) <= 1e-14 * np.linalg.norm(A.T @ y)


# -- on the GPU ---------------------------------------------------------------

CUDA_SHAPES = {  # (m, n, bm, bn): the main path's 8x128, 8x16, and general sizes
    "8x128": (1000, 777, 8, 128),
    "8x16": (1003, 1500, 8, 16),
    "3x100": (301, 250, 3, 100),      # bn % 4 != 0: the scalar-load kernel
    "20x64": (500, 640, 20, 64),      # bm > 8: several passes per block-row
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(np.float32, 1e-5), (np.float64, 1e-13)])
@pytest.mark.parametrize("case", list(CUDA_SHAPES))
def test_cuda_kernel_matches_plain(cuda, case, dtype, rel):
    m, n, bm, bn = CUDA_SHAPES[case]
    bell = lt.bell_from_scipy(_random_csr(m, n, 0.02, seed=14, eye=True), bm=bm, bn=bn,
                              dtype=dtype, device=cuda)
    op = lt.BellOperator(bell)
    x = torch.from_numpy(np.random.default_rng(15).standard_normal(n)).to(cuda, bell.data.dtype)
    before = _launches("bell_spmv")
    got = op.matvec(x)
    torch.cuda.synchronize()
    assert _launches("bell_spmv") == before + 1
    x_p = torch.nn.functional.pad(x, (0, op._n_padded() - n))
    want = spmv.bell_spmv_reference(bell.data, bell.cols, x_p)[:m]
    assert torch.linalg.norm(got - want) <= rel * torch.linalg.norm(want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.float64, 1e-13)])
def test_cuda_kernel_sums_repeated_columns(cuda, dtype, rel):
    rng = np.random.default_rng(16)
    data, cols = _blocks_with_repeats(rng, 257, 6, 8, 128, nbc=7)
    data = torch.from_numpy(data).to(cuda, dtype)
    cols = torch.from_numpy(cols).to(cuda)
    x = torch.from_numpy(rng.standard_normal(7 * 128)).to(cuda, dtype)
    got = lt.bell_spmv(data, cols, x)
    want = spmv.bell_spmv_reference(data, cols, x)
    assert torch.linalg.norm(got - want) <= rel * torch.linalg.norm(want)


@pytest.mark.cuda
def test_cuda_kernel_rejects_unsupported_tensors(cuda):
    data = torch.ones(4, 2, 8, 16, device=cuda)
    cols = torch.zeros(4, 2, dtype=torch.int32, device=cuda)
    x = torch.ones(32, device=cuda)
    with pytest.raises(TypeError):
        lt.bell_spmv(data.half(), cols, x.half())
    with pytest.raises(TypeError):
        lt.bell_spmv(data, cols.long(), x)
    with pytest.raises(TypeError):
        lt.bell_spmv(data, cols, x.double())
    with pytest.raises(ValueError):
        lt.bell_spmv(data.transpose(2, 3).contiguous().transpose(2, 3), cols, x)
    with pytest.raises(ValueError):
        lt.bell_spmv(data, cols, torch.ones(33, device=cuda))
    with pytest.raises(ValueError):
        lt.bell_spmv(data, cols.cpu(), x)


def _row_layout(nbr, K, bm, n, seed, dtype):
    """Random single-column blocks with ragged rows: trailing padding slots
    (zero values at column 0) in every other block-row, a repeated column,
    a block-row of padding alone."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, n, (nbr, K)).astype(np.int32)
    data = rng.standard_normal((nbr, K, bm, 1))
    cols[:, 1 % K] = cols[:, 0]
    fill = rng.integers(1, K + 1, nbr)
    fill[::2] = K
    pad = np.arange(K)[None, :] >= fill[:, None]
    pad[nbr // 2] = True
    cols[pad], data[pad] = 0, 0.0
    return torch.from_numpy(data).to(dtype), torch.from_numpy(cols)


#: (nbr, K, bm, n): ELLPACK and taller single-column blocks, lengths aligned to
#: nothing; at K = 100 the tile is halved to fit the staging budget, and 16 x 1
#: blocks at K = 100 pass it at one block-row (data and cols read from global)
ROW_SHAPES = {"1x1-K5": (1003, 5, 1, 777), "2x1-K7": (517, 7, 2, 1501),
              "8x1-K3": (131, 3, 8, 999), "1x1-K100": (301, 100, 1, 4000),
              "40x1-K4": (29, 4, 40, 333), "16x1-K100": (40, 100, 16, 3001)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-6), (torch.float64, 1e-13)])
@pytest.mark.parametrize("p", [1, 2, 5, 8])
@pytest.mark.parametrize("case", list(ROW_SHAPES))
def test_cuda_row_kernel_matches_plain(cuda, case, p, dtype, rel):
    nbr, K, bm, n = ROW_SHAPES[case]
    data, cols = _row_layout(nbr, K, bm, n, seed=p, dtype=dtype)
    data, cols = data.to(cuda), cols.to(cuda)
    X = torch.from_numpy(np.random.default_rng(22).standard_normal((p, n))).to(cuda, dtype)
    before = {w: _launches(w) for w in ("bell_spmv", "bell_spmm", "bell_rows")}
    got = lt.bell_spmv(data, cols, X[0]) if p == 1 else lt.bell_spmm(data, cols, X)
    torch.cuda.synchronize()
    wrapper = "bell_spmv" if p == 1 else "bell_spmm"
    assert {w: _launches(w) - b for w, b in before.items()} == {
        "bell_spmv": int(p == 1), "bell_spmm": int(p > 1), "bell_rows": 1}, wrapper
    want = (spmv.bell_spmv_reference(data, cols, X[0]) if p == 1
            else spmv.bell_spmm_reference(data, cols, X))
    assert torch.linalg.norm(got - want) <= rel * torch.linalg.norm(want)
    again = lt.bell_spmv(data, cols, X[0]) if p == 1 else lt.bell_spmm(data, cols, X)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-6), (torch.float64, 1e-13)])
def test_cuda_row_kernel_takes_misaligned_views(cuda, dtype, rel):
    """data, cols and x starting off 16-byte alignment (views one block-row
    and one entry in), so the staging's scalar head and tail run."""
    data, cols = _row_layout(258, 5, 1, 901, seed=23, dtype=dtype)
    data, cols = data.to(cuda)[1:], cols.to(cuda)[1:]
    x = torch.from_numpy(np.random.default_rng(24).standard_normal(902)).to(cuda, dtype)[1:]
    assert data.data_ptr() % 16 and cols.data_ptr() % 16 and x.data_ptr() % 16
    got = lt.bell_spmv(data, cols, x)
    want = spmv.bell_spmv_reference(data, cols, x)
    assert torch.linalg.norm(got - want) <= rel * torch.linalg.norm(want)


@pytest.mark.cuda
def test_cuda_block_layouts_do_not_count_row_launches(cuda):
    data = torch.randn(4, 2, 8, 128, device=cuda)
    cols = torch.zeros(4, 2, dtype=torch.int32, device=cuda)
    before = _launches("bell_rows")
    lt.bell_spmv(data, cols, torch.ones(128, device=cuda))
    lt.bell_spmm(data, cols, torch.ones(3, 128, device=cuda))
    torch.cuda.synchronize()
    assert _launches("bell_rows") == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(np.float32, 1e-6), (np.float64, 1e-13)])
def test_cuda_default_layout_is_fitted(cuda, dtype, rel):
    """With no shape given the card builds convection-diffusion as ELLPACK
    (K = 5), and the operator applies it with no padding, against scipy."""
    A = _convdiff_csr(61, 37)
    bell = lt.bell_from_scipy(A, dtype=dtype, device=cuda)
    assert (bell.bm, bell.bn, bell.K) == (1, 1, 5)
    assert bell.fill_ratio == A.nnz / (A.shape[0] * 5)
    x = np.random.default_rng(25).standard_normal(A.shape[1])
    got = lt.BellOperator(bell).matvec(torch.from_numpy(x).to(cuda, bell.data.dtype))
    want = A @ x
    assert np.linalg.norm(got.cpu().double().numpy() - want) <= rel * np.linalg.norm(want)
