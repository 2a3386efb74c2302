"""The batched kernels' plain versions against ``jax.vmap`` of the JAX
package's matvecs, the operators' block forms, the port's own copy of the
Block-ELL assembler, the counting helpers and the orthonormality check; on a
GPU, the batched CUDA kernels against their plain versions.

The JAX package's block Krylov methods apply an operator to a block with
``jax.vmap(matvec)`` (its ``linops.py:103-117``), which turns the Pallas
calls of ``PallasPoisson2D`` and ``BellOperator`` into one call with a
batch grid axis; the port's counterparts are ``stencil_matvec_batched`` and
``bell_spmm``.  On the CPU they compute their plain versions, held here to
the vmapped Pallas kernels in interpret mode (as tests/test_pallas.py runs
them) within 1e-12 of the norm in float64.  The tests marked ``cuda`` hold
the kernels to their plain versions within 1e-6 (stencil) and 1e-5
(Block-ELL) of the norm in float32 and 1e-13 in float64, and skip where
there is no GPU; JAX is imported only by the tests that use it, so that on a
machine with a GPU and no JAX they run with
``python -m pytest --noconftest -m cuda tests/test_torch_batched.py``.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightkrylov_tpu_torch as lt
from lightkrylov_tpu_torch import native
from lightkrylov_tpu_torch.ops import spmv, stencil
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
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(got, want):
    return float(np.linalg.norm(np.asarray(got) - np.asarray(want)) / np.linalg.norm(want))


def _random_bell(nbr, nbc, K, bm, bn, seed, dtype=np.float64):
    """Random Block-ELL arrays with a repeated block-column and padding
    slots (zero blocks at block-column 0)."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, nbc, (nbr, K)).astype(np.int32)
    cols[:, 1] = cols[:, 0]
    data = rng.standard_normal((nbr, K, bm, bn)).astype(dtype)
    data[::3, -1] = 0
    cols[::3, -1] = 0
    return data, cols


# -- the plain batched versions against jax.vmap of the JAX matvecs --------------


@pytest.mark.parametrize("p,ny,nx,tile", [(2, 64, 32, 16), (3, 50, 32, 16), (4, 33, 17, 8)])
def test_batched_stencil_matches_vmapped_pallas(p, ny, nx, tile):
    import jax
    import jax.numpy as jnp
    from lightkrylov_tpu.models import Poisson2D
    from lightkrylov_tpu.ops.pallas import PallasPoisson2D

    u = np.random.default_rng(p).standard_normal((p, ny, nx))
    pal = PallasPoisson2D(nx, ny, dtype=jnp.float64, tile=tile, interpret=True)
    ref = np.asarray(jax.vmap(pal.matvec)(jnp.asarray(u)))
    ref_xla = np.asarray(jax.vmap(Poisson2D(nx, ny).matvec)(jnp.asarray(u)))
    op = lt.CudaPoisson2D(nx, ny, dtype=torch.float64)
    got = op.matvec_basis(torch.from_numpy(u)).numpy()
    assert got.shape == (p, ny, nx)
    assert _rel(got, ref) < 1e-12 and _rel(got, ref_xla) < 1e-12
    ihx2, ihy2 = 1.0 / op.hx**2, 1.0 / op.hy**2
    plain = lt.stencil_matvec_batched(torch.from_numpy(u), ihx2=ihx2, ihy2=ihy2).numpy()
    assert np.array_equal(plain, got)
    assert np.array_equal(op.rmatvec_basis(torch.from_numpy(u)).numpy(), got)


def test_batched_stencil_keeps_each_field_boundary():
    """Each field of the stack has its own zero boundary: the batched plain
    version equals the single-field version field by field, bit for bit,
    and a nonzero last row of one field leaves the next field's first row
    alone."""
    u = torch.zeros((3, 6, 5), dtype=torch.float64)
    u[0, -1] = 1.0
    y = lt.stencil_matvec_batched(u, ihx2=4.0, ihy2=9.0)
    assert torch.count_nonzero(y[1:]) == 0
    for i in range(3):
        assert torch.equal(y[i], lt.stencil_matvec(u[i], ihx2=4.0, ihy2=9.0))


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("bm,bn", [(8, 128), (8, 16)])
def test_bell_spmm_matches_vmapped_pallas(p, bm, bn):
    import jax
    import jax.numpy as jnp
    from lightkrylov_tpu.ops.pallas.spmv import bell_spmv as jax_bell_spmv

    nbr, nbc, K = 24, 5, 3
    data, cols = _random_bell(nbr, nbc, K, bm, bn, seed=p + bn)
    X = np.random.default_rng(bm + p).standard_normal((p, nbc * bn))
    ref = np.asarray(jax.vmap(lambda x: jax_bell_spmv(jnp.asarray(data), jnp.asarray(cols), x,
                                                      interpret=True))(jnp.asarray(X)))
    got = lt.bell_spmm(torch.from_numpy(data), torch.from_numpy(cols), torch.from_numpy(X))
    assert tuple(got.shape) == (p, nbr * bm)
    assert _rel(got.numpy(), ref) < 1e-12
    for c in range(p):
        one = spmv.bell_spmv_reference(torch.from_numpy(data), torch.from_numpy(cols),
                                       torch.from_numpy(X[c]))
        assert _rel(got[c].numpy(), one.numpy()) < 1e-14


@pytest.mark.parametrize("hermitian", [False, True])
def test_bell_operator_block_forms_match_jax(hermitian):
    """``BellOperator.matvec_basis`` and ``rmatvec_basis`` against
    ``jax.vmap`` of the JAX operator's, on a ragged shape that pads."""
    import jax
    import jax.numpy as jnp
    from lightkrylov_tpu.ops import pallas

    A = sp.random(100, 100, density=0.05, random_state=4, format="csr") + sp.eye(100)
    if hermitian:
        A = A + A.T
    jop = pallas.BellOperator(pallas.bell_from_scipy(A, bm=8, bn=16, dtype=np.float64),
                              is_hermitian=hermitian, interpret=True)
    op = lt.BellOperator(lt.bell_from_scipy(A, bm=8, bn=16, dtype=np.float64),
                         is_hermitian=hermitian)
    X = np.random.default_rng(5).standard_normal((3, 100))
    for name in ("matvec", "rmatvec"):
        ref = np.asarray(jax.vmap(getattr(jop, name))(jnp.asarray(X)))
        got = getattr(op, f"{name}_basis")(torch.from_numpy(X)).numpy()
        M = A.T if name == "rmatvec" else A
        assert got.shape == (3, 100)
        assert _rel(got, ref) < 1e-12 and _rel(got, (M @ X.T).T) < 1e-12


@pytest.mark.parametrize("p,slices", [(8, [8]), (9, [8, 1]), (12, [8, 4]), (17, [8, 8, 1])])
def test_bell_operator_wide_block_goes_in_slices(monkeypatch, p, slices):
    """A block wider than ``MAX_SPMM_COLUMNS`` goes through ``bell_spmm`` one
    slice of at most that many vectors at a time, as ``jax.vmap`` over the
    JAX kernel takes any width; the result equals the scipy product within
    1e-12 of the norm."""
    A = sp.random(100, 100, density=0.05, random_state=6, format="csr") + sp.eye(100)
    op = lt.BellOperator(lt.bell_from_scipy(A, bm=8, bn=16, dtype=np.float64))
    calls = []
    orig = spmv.bell_spmm

    def spy(data, cols, X):
        calls.append(X.shape[0])
        return orig(data, cols, X)

    monkeypatch.setattr(spmv, "bell_spmm", spy)
    X = np.random.default_rng(p).standard_normal((p, 100))
    got = op.matvec_basis(torch.from_numpy(X)).numpy()
    assert calls == slices
    assert got.shape == (p, 100) and _rel(got, (A @ X.T).T) < 1e-12


def _launches(name):
    """The kernel launches counted so far under ``launches.<name>``."""
    return timer.get_counter(f"launches.{name}")


def test_block_forms_on_the_cpu_launch_nothing():
    before = (_launches("stencil_matvec_batched"), _launches("bell_spmm"))
    lt.CudaPoisson2D(8).matvec_basis(torch.ones(2, 8, 8))
    data, cols = _random_bell(4, 2, 2, 8, 16, seed=0, dtype=np.float32)
    lt.bell_spmm(torch.from_numpy(data), torch.from_numpy(cols), torch.ones(2, 32))
    assert (_launches("stencil_matvec_batched"), _launches("bell_spmm")) == before


def test_batched_non_cpu_tensor_never_takes_the_plain_path():
    """Only a CPU tensor gets the plain version: any other device goes to
    the kernels' checks and raises there."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        lt.stencil_matvec_batched(torch.empty(2, 4, 4, device="meta"), ihx2=1.0, ihy2=1.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        lt.bell_spmm(torch.empty(4, 2, 8, 16, device="meta"),
                     torch.empty(4, 2, dtype=torch.int32, device="meta"),
                     torch.empty(2, 32, device="meta"))


# -- the port's copy of the Block-ELL assembler ------------------------------------


def test_assembler_source_is_the_ports_own_copy():
    """The native assembler builds from a file of the port, never from the
    JAX package's tree, and its layout equals the JAX ``bell_from_scipy``'s
    on one matrix."""
    from pathlib import Path

    from lightkrylov_tpu.ops import pallas

    pkg = Path(lt.__file__).resolve().parent
    assert native.SOURCE.resolve().parent == pkg / "csrc"
    assert native.SOURCE.is_file()
    if not native.available():
        pytest.skip(f"native assembler unavailable: {native.unavailable_reason()}")
    A = (sp.random(300, 280, density=0.02, random_state=11, format="csr") + sp.eye(300, 280))
    for dtype in (np.float32, np.float64):
        got = lt.bell_from_scipy(A, bm=8, bn=128, dtype=dtype)
        ref = pallas.bell_from_scipy(A, bm=8, bn=128, dtype=dtype)
        assert got.K == ref.K and got.nnz == ref.nnz
        assert np.array_equal(got.cols.numpy(), np.asarray(ref.cols))
        assert np.array_equal(got.data.numpy(), np.asarray(ref.data))


# -- matvec_counter, counters_summary, check_orthonormal ---------------------------


def test_matvec_counter_counts_each_application(monkeypatch):
    """(tests/test_utils.py:69-82; reference: apply_matvec counters,
    AbstractLinops.fypp:391-424).  The block forms count one a column and
    stay one call of the wrapped operator's block form."""
    timer.reset_counters()
    op = timer.matvec_counter(lt.DenseOperator(torch.eye(4, dtype=torch.float64)), "A")
    x = torch.ones(4, dtype=torch.float64)
    op.matvec(x)
    op.matvec(x)
    op.rmatvec(x)
    assert timer.get_counter("A.matvec") == 2
    assert timer.get_counter("A.rmatvec") == 1
    stencil_op = lt.CudaPoisson2D(6, dtype=torch.float64)
    counted = timer.matvec_counter(stencil_op, "S")
    assert counted.is_hermitian
    X = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 6, 6)))
    calls = []
    orig = stencil.stencil_matvec_batched

    def spy(u, **kw):
        calls.append(tuple(u.shape))
        return orig(u, **kw)

    monkeypatch.setattr(stencil, "stencil_matvec_batched", spy)
    got = counted.matvec_basis(X)
    counted.rmatvec_basis(X)
    assert calls == [(3, 6, 6), (3, 6, 6)]
    assert torch.equal(got, stencil_op.matvec_basis(X))
    assert timer.get_counter("S.matvec") == 3 and timer.get_counter("S.rmatvec") == 3


def test_counters_summary_format_matches_jax():
    """The same table as the JAX ``counters_summary`` on the same counts."""
    import jax.numpy as jnp

    import lightkrylov_tpu as lk
    from lightkrylov_tpu.utils import timer as jtimer

    timer.reset_counters()
    jtimer.reset_counters()
    for tm, mod, arr in ((timer, lt, torch.eye(3, dtype=torch.float64)),
                         (jtimer, lk, jnp.eye(3))):
        a = tm.matvec_counter(mod.DenseOperator(arr), "Op")
        b = tm.matvec_counter(mod.DenseOperator(arr), "Aux")
        for _ in range(3):
            a.matvec(arr[0])
        b.rmatvec(arr[0])
    got, want = timer.counters_summary(), jtimer.counters_summary()
    assert got == want
    assert got.splitlines()[0] == "== call counters =="
    assert "Op.matvec" in got and got.splitlines()[-1].strip().endswith("3")


def test_dgs_check_orthonormal_flag():
    """(tests/test_krylov.py:391-415; reference: if_chk_orthonormal,
    gram_schmidt.fypp:26-34): an orthonormal basis with zero columns passes
    and the projection is unchanged, a raw basis is a hard stop.  The port
    is eager, so the check also runs where the JAX package refuses it (under
    ``jit``)."""
    from lightkrylov_tpu_torch.krylov.gram_schmidt import double_gram_schmidt_step
    from lightkrylov_tpu_torch.utils.logger import LightKrylovError

    rng = np.random.default_rng(17)
    n = 64
    X = torch.from_numpy(rng.standard_normal((6, n)))
    Q = lt.orthonormalize_basis(X)
    Qbuf = torch.cat([Q, torch.zeros_like(Q[:2])])
    y = torch.from_numpy(rng.standard_normal(n))
    y1, p1 = double_gram_schmidt_step(y, Qbuf)
    y2, p2 = double_gram_schmidt_step(y, Qbuf, check_orthonormal=True)
    assert torch.equal(y1, y2) and torch.equal(p1, p2)
    with pytest.raises(LightKrylovError):
        double_gram_schmidt_step(y, X, check_orthonormal=True)


def test_dgs_check_orthonormal_agrees_with_jax():
    """The JAX check and the port's pass and stop on the same bases: an
    orthonormal float64 basis, one perturbed by 1e-6 (a defect below the
    float32 rtol) and one perturbed by 1e-2."""
    import jax.numpy as jnp

    from lightkrylov_tpu.krylov.gram_schmidt import double_gram_schmidt_step as jdgs
    from lightkrylov_tpu.utils.logger import LightKrylovError as JErr
    from lightkrylov_tpu_torch.krylov.gram_schmidt import double_gram_schmidt_step
    from lightkrylov_tpu_torch.utils.logger import LightKrylovError

    rng = np.random.default_rng(3)
    Q = np.linalg.qr(rng.standard_normal((40, 5)))[0].T
    y = rng.standard_normal(40)
    for eps, passes in ((0.0, True), (1e-6, True), (1e-2, False)):
        Xb = Q + eps * rng.standard_normal(Q.shape)
        outcomes = []
        for run, err in ((lambda: jdgs(jnp.asarray(y), jnp.asarray(Xb), check_orthonormal=True),
                          JErr),
                         (lambda: double_gram_schmidt_step(torch.from_numpy(y),
                                                           torch.from_numpy(Xb),
                                                           check_orthonormal=True),
                          LightKrylovError)):
            try:
                run()
                outcomes.append(True)
            except err:
                outcomes.append(False)
        assert outcomes == [passes, passes], (eps, outcomes)


# -- on the GPU -------------------------------------------------------------------

BATCH_SHAPES = [(33, 17), (64, 256), (1000, 3001), (3072, 3072)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-6), (torch.float64, 1e-13)])
@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("shape", BATCH_SHAPES)
def test_cuda_batched_stencil_matches_plain(cuda, shape, p, dtype, rel):
    ny, nx = shape
    u = torch.from_numpy(np.random.default_rng(p).standard_normal((p, ny, nx))).to(cuda, dtype)
    ihx2, ihy2 = float((nx + 1) ** 2), float((ny + 1) ** 2)
    before = _launches("stencil_matvec_batched")
    got = lt.stencil_matvec_batched(u, ihx2=ihx2, ihy2=ihy2)
    torch.cuda.synchronize()
    assert _launches("stencil_matvec_batched") == before + 1
    want = stencil.stencil_matvec_reference(u, ihx2=ihx2, ihy2=ihy2)
    assert torch.linalg.norm(got - want) <= rel * torch.linalg.norm(want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.float64, 1e-13)])
@pytest.mark.parametrize("p", [1, 2, 3, 8])
@pytest.mark.parametrize("bm,bn", [(8, 128), (8, 16), (3, 5)])
def test_cuda_bell_spmm_matches_plain(cuda, bm, bn, p, dtype, rel):
    data, cols = _random_bell(1003, 37, 5, bm, bn, seed=p)
    data = torch.from_numpy(data).to(cuda, dtype)
    cols = torch.from_numpy(cols).to(cuda)
    X = torch.from_numpy(np.random.default_rng(bn).standard_normal((p, 37 * bn))).to(cuda, dtype)
    before = _launches("bell_spmm")
    got = lt.bell_spmm(data, cols, X)
    torch.cuda.synchronize()
    assert _launches("bell_spmm") == before + 1
    want = spmv.bell_spmm_reference(data, cols, X)
    assert torch.linalg.norm(got - want) <= rel * torch.linalg.norm(want)


@pytest.mark.cuda
def test_cuda_block_forms_launch_once(cuda):
    """``matvec_basis`` of both operators is one batched launch a block."""
    op = lt.CudaPoisson2D(64, dtype=torch.float32, device=cuda)
    before = (_launches("stencil_matvec"), _launches("stencil_matvec_batched"))
    op.matvec_basis(torch.ones(3, 64, 64, device=cuda))
    assert (_launches("stencil_matvec"), _launches("stencil_matvec_batched")) == (
        before[0], before[1] + 1)
    A = sp.random(200, 200, density=0.05, random_state=1, format="csr") + sp.eye(200)
    bop = lt.BellOperator(lt.bell_from_scipy(A, dtype=np.float32, device=cuda))
    before = (_launches("bell_spmv"), _launches("bell_spmm"))
    Y = bop.matvec_basis(torch.ones(2, 200, device=cuda))
    assert (_launches("bell_spmv"), _launches("bell_spmm")) == (before[0], before[1] + 1)
    assert np.allclose(Y.cpu().numpy(), (A @ np.ones((200, 2))).T, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.float64, 1e-13)])
@pytest.mark.parametrize("p", [9, 10, 11, 12])
def test_cuda_bell_operator_wide_block_matches_plain(cuda, p, dtype, rel):
    """``BellOperator.matvec_basis`` past ``MAX_SPMM_COLUMNS``: one counted
    launch a slice of at most 8 vectors, held to the plain version."""
    A = sp.random(1000, 1000, density=0.01, random_state=p, format="csr") + sp.eye(1000)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    bell = lt.bell_from_scipy(A, dtype=np_dtype, device=cuda)
    op = lt.BellOperator(bell)
    X = torch.from_numpy(np.random.default_rng(p).standard_normal((p, 1000))).to(cuda, dtype)
    before = (_launches("bell_spmv"), _launches("bell_spmm"))
    got = op.matvec_basis(X)
    torch.cuda.synchronize()
    assert (_launches("bell_spmv"), _launches("bell_spmm")) == (before[0], before[1] + 2)
    X_p = torch.nn.functional.pad(X, (0, op._n_padded() - 1000))
    want = spmv.bell_spmm_reference(bell.data, bell.cols, X_p)[:, :1000]
    assert torch.linalg.norm(got - want) <= rel * torch.linalg.norm(want)


@pytest.mark.cuda
def test_cuda_batched_kernels_reject_unsupported_tensors(cuda):
    with pytest.raises(ValueError):
        lt.stencil_matvec_batched(torch.ones(4, 4, device=cuda), ihx2=1.0, ihy2=1.0)
    with pytest.raises(TypeError):
        lt.stencil_matvec_batched(torch.ones(2, 4, 4, device=cuda, dtype=torch.float16),
                                  ihx2=1.0, ihy2=1.0)
    data = torch.ones(4, 2, 8, 16, device=cuda)
    cols = torch.zeros(4, 2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="1 to 8"):
        lt.bell_spmm(data, cols, torch.ones(9, 32, device=cuda))
    with pytest.raises(ValueError):
        lt.bell_spmm(data, cols, torch.ones(32, device=cuda))
