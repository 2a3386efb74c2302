"""The Block-ELL layout built with torch operations (``ops.spmv``
``bell_assemble_torch``, what ``bell_from_scipy`` runs for a card) against
the host assemblers, native and numpy: ``data``, ``cols`` and ``K`` equal to
the bit.  On the CPU the torch assembler runs on CPU tensors; the test
marked ``cuda`` builds the layout on the card through ``bell_from_scipy``.
This file imports no JAX, so on the card it runs with
``python -m pytest --noconftest -m cuda tests/test_torch_bell_assembly.py``.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightkrylov_tpu_torch as lt
from bench_port import harness
from lightkrylov_tpu_torch import native
from lightkrylov_tpu_torch.ops import spmv

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """These tests ask for the CPU: the package's default device is the card."""
    prev = lt.constants.default_device()
    lt.constants.set_default_device("cpu")
    yield
    lt.constants.set_default_device(prev)


def _empty_rows():
    A = sp.random(120, 200, density=0.05, random_state=3, format="lil")
    A[::3] = 0       # every third row empty
    A[16:24] = 0     # and a whole block-row
    return A.tocsr()


def _k_reached():
    """One block-row whose rows reach every block-column of 128; the other
    block-rows hold a diagonal."""
    A = sp.eye(64, 2048, format="lil")
    A[5, ::100] = 1.5
    return A.tocsr()


def _duplicates():
    rng = np.random.default_rng(4)
    r, c = rng.integers(0, 50, 400), rng.integers(0, 70, 400)
    return sp.coo_matrix((rng.standard_normal(400), (r, c)), shape=(50, 70))


def _convdiff():
    loop = harness.load_module("loops", "bell_gmres_cycles")
    return loop.convdiff_csr(40, 24, 1e-2, 1.0, 0.5)


#: name: (matrix, bm, bn, dtype)
CASES = {
    "random-square-f64": (lambda: sp.random(300, 300, density=0.03, random_state=1), 8, 128,
                          np.float64),
    "random-wide-f32": (lambda: sp.random(100, 700, density=0.05, random_state=2), 8, 16,
                        np.float32),
    "random-tall-f64": (lambda: sp.random(1000, 90, density=0.02, random_state=5), 4, 32,
                        np.float64),
    "m-not-a-multiple-of-bm": (lambda: sp.random(101, 77, density=0.1, random_state=6), 8, 16,
                               np.float64),
    "empty-rows": (_empty_rows, 8, 16, np.float64),
    "k-reached-by-one-block-row": (_k_reached, 8, 128, np.float64),
    "duplicates-summed": (_duplicates, 8, 16, np.float64),
    "all-zero": (lambda: sp.csr_matrix((50, 60)), 8, 16, np.float64),
    "convdiff-f64": (_convdiff, 8, 128, np.float64),
    "convdiff-f32": (_convdiff, 8, 128, np.float32),
    # 1 x 1 (ELLPACK): the slot of a nonzero is its place in its row
    "rows-convdiff-f64": (_convdiff, 1, 1, np.float64),
    "rows-random-f32": (lambda: sp.random(100, 700, density=0.05, random_state=2), 1, 1,
                        np.float32),
    "rows-empty-rows": (_empty_rows, 1, 1, np.float64),
    "rows-duplicates-summed": (_duplicates, 1, 1, np.float64),
    "rows-all-zero": (lambda: sp.csr_matrix((50, 60)), 1, 1, np.float64),
}


def _csr(case):
    make, bm, bn, dtype = CASES[case]
    A = sp.csr_matrix(make())
    A.sum_duplicates()
    return A, bm, bn, dtype


def _numpy_layout(A, bm, bn, dtype, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(native, "available", lambda: False)
        bell = lt.bell_from_scipy(A, bm=bm, bn=bn, dtype=dtype, device="cpu")
    return bell.data.numpy(), bell.cols.numpy()


def _assert_bit_equal(data, cols, ref_data, ref_cols):
    data, cols = np.asarray(data), np.asarray(cols)
    assert data.dtype == ref_data.dtype and data.shape == ref_data.shape
    assert cols.dtype == ref_cols.dtype == np.int32 and cols.shape == ref_cols.shape
    assert data.tobytes() == ref_data.tobytes()
    assert cols.tobytes() == ref_cols.tobytes()


@pytest.mark.parametrize("case", list(CASES))
def test_torch_layout_is_the_numpy_layout(case, monkeypatch):
    A, bm, bn, dtype = _csr(case)
    data, cols = spmv.bell_assemble_torch(A, bm, bn, dtype, torch.device("cpu"))
    _assert_bit_equal(data.numpy(), cols.numpy(), *_numpy_layout(A, bm, bn, dtype, monkeypatch))


@pytest.mark.parametrize("case", list(CASES))
def test_torch_layout_is_the_native_layout(case):
    if not native.available():
        pytest.skip(f"native assembler unavailable: {native.unavailable_reason()}")
    A, bm, bn, dtype = _csr(case)
    data, cols = spmv.bell_assemble_torch(A, bm, bn, dtype, torch.device("cpu"))
    ref_data, ref_cols, K = native.bell_assemble(A, bm, bn, dtype)
    assert data.shape[1] == K
    _assert_bit_equal(data.numpy(), cols.numpy(), ref_data, ref_cols)


def test_complex_values_take_the_numpy_cast(monkeypatch):
    A = sp.random(70, 70, density=0.1, random_state=7, format="csr")
    A = (A + 1j * sp.random(70, 70, density=0.1, random_state=8, format="csr")).tocsr()
    A.sum_duplicates()
    data, cols = spmv.bell_assemble_torch(A, 4, 32, np.complex64, torch.device("cpu"))
    _assert_bit_equal(data.numpy(), cols.numpy(),
                      *_numpy_layout(A, 4, 32, np.complex64, monkeypatch))


def test_complex_values_take_the_numpy_cast_at_1x1(monkeypatch):
    A = sp.random(70, 70, density=0.1, random_state=7, format="csr")
    A = (A + 1j * sp.random(70, 70, density=0.1, random_state=8, format="csr")).tocsr()
    A.sum_duplicates()
    data, cols = spmv.bell_assemble_torch(A, 1, 1, np.complex64, torch.device("cpu"))
    _assert_bit_equal(data.numpy(), cols.numpy(),
                      *_numpy_layout(A, 1, 1, np.complex64, monkeypatch))


@pytest.mark.parametrize("given,want", [({}, (1, 1)), ({"bm": 8, "bn": 128}, (8, 128)),
                                        ({"bm": 4}, (4, 128)), ({"bn": 16}, (8, 16)),
                                        ({"bm": 1, "bn": 1}, (1, 1))])
def test_a_card_target_fits_the_shape_only_when_none_is_given(monkeypatch, given, want):
    """A card target with no shape builds the fitted one (1 x 1 for
    convection-diffusion); a shape given whole or in part is kept, the JAX
    package's 8 x 128 filling what is not given."""
    A = _convdiff()
    shapes, assemble = [], spmv.bell_assemble_torch

    def spy(A, bm, bn, dtype, device):
        shapes.append((bm, bn))
        return assemble(A, bm, bn, dtype, torch.device("cpu"))
    monkeypatch.setattr(spmv, "bell_assemble_torch", spy)
    bell = lt.bell_from_scipy(A, dtype=np.float64, device="cuda", **given)
    assert shapes == [want] and (bell.bm, bell.bn) == want
    cpu = lt.bell_from_scipy(A, dtype=np.float64, device="cpu", **given)
    assert (cpu.bm, cpu.bn) == (given.get("bm", 8), given.get("bn", 128))


def test_the_target_device_picks_the_assembler(monkeypatch):
    """A card target goes to the torch assembler and its tensors are the
    matrix's; a CPU target keeps the host assemblers."""
    A = sp.random(40, 50, density=0.1, random_state=9, format="csr")
    made, assemble = [], spmv.bell_assemble_torch

    def spy(A, bm, bn, dtype, device):
        made.append(device)
        return assemble(A, bm, bn, dtype, torch.device("cpu"))
    monkeypatch.setattr(spmv, "bell_assemble_torch", spy)
    bell = lt.bell_from_scipy(A, bm=8, bn=16, dtype=np.float64, device="cuda")
    assert made == [torch.device("cuda")]
    assert bell.nnz == A.nnz and bell.fill_ratio == A.nnz / bell.data.numel()
    lt.bell_from_scipy(A, bm=8, bn=16, dtype=np.float64, device="cpu")
    assert len(made) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_layout_is_the_host_layout(case, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    A, bm, bn, dtype = _csr(case)
    bell = lt.bell_from_scipy(A, bm=bm, bn=bn, dtype=dtype, device="cuda")
    assert bell.data.device.type == "cuda" and bell.cols.device.type == "cuda"
    _assert_bit_equal(bell.data.cpu().numpy(), bell.cols.cpu().numpy(),
                      *_numpy_layout(A, bm, bn, dtype, monkeypatch))
