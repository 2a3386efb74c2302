"""CG's fused vector update (lightkrylov_tpu_torch.ops.cg, csrc/cg.cu).

On the CPU: the kernels' plain versions against the update as separate
vector operations, and the solver's choice of route (only an
unpreconditioned solve of one real contiguous float32/float64 tensor with
no reduction group takes the kernels; every other solve gives the results it
gave before).  The tests marked ``cuda`` hold each kernel to its plain
version on the card, check the guards, and run whole solves through the
kernels; no JAX is imported, so on a machine with a GPU and no JAX they run
with ``python -m pytest --noconftest -m cuda tests/test_torch_cg_fused.py``.
"""

import importlib

import numpy as np
import pytest
import torch
import torch.distributed as dist

import lightkrylov_tpu_torch as lt
from lightkrylov_tpu_torch import vectors
from lightkrylov_tpu_torch.ops import cg as fused
from lightkrylov_tpu_torch.utils import timer

torch.set_num_threads(2)

cg_module = importlib.import_module("lightkrylov_tpu_torch.solvers.cg")


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


def _field(shape, dtype, device="cpu", seed=0):
    a = np.random.default_rng(seed).standard_normal(shape)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _fused_iterations():
    return timer.get_counter("cg.fused_iterations")


def _unfused(monkeypatch):
    """Make every solve take the loop of separate vector operations."""
    monkeypatch.setattr(cg_module, "_fits_fused", lambda *args: False)


# -- on the CPU ----------------------------------------------------------------

@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-6), (torch.float64, 1e-14)])
def test_plain_versions_follow_the_unfused_recurrence(dtype, rel):
    """Ten iterations of the three plain versions against the update written
    with vectors.axpby/dot/norm, as the unpreconditioned loop makes it."""
    op = lt.Poisson2D(12, 10, dtype=dtype)
    b = _field((10, 12), dtype)
    # the unfused recurrence
    xu, ru = torch.zeros_like(b), b.clone()
    pu, rzu = ru, vectors.dot(ru, ru)
    # the plain versions on their own buffers
    x, r = torch.zeros_like(b), b.clone()
    p = r.clone()
    s = fused.scalars(torch.dot(r.reshape(-1), r.reshape(-1)), torch.linalg.vector_norm(r),
                      torch.tensor(1e-30, dtype=dtype))
    hist = torch.zeros(10, dtype=dtype)
    for k in range(10):
        Apu = op.matvec(pu)
        alpha = rzu / cg_module._nonzero(vectors.dot(pu, Apu))
        xu = vectors.axpby(1.0, xu, alpha, pu)
        ru = vectors.axpby(1.0, ru, -alpha, Apu)
        res = vectors.norm(ru)
        rz_new = vectors.dot(ru, ru)
        pu = vectors.axpby(1.0, ru, rz_new / cg_module._nonzero(rzu), pu)
        rzu = rz_new

        Ap = op.matvec(p)
        fused.cg_pdot_reference(p, Ap, s)
        fused.cg_xr_reference(x, r, p, Ap, s, hist, k)
        fused.cg_p_reference(r, p, s)
        for got, want in ((x, xu), (r, ru), (p, pu)):
            assert torch.linalg.norm(got - want) <= rel * torch.linalg.norm(want)
        assert abs(float(s[fused.RES] - res)) <= rel * float(res)
        assert abs(float(s[fused.RZ] - rzu)) <= rel * float(rzu)
        assert float(hist[k]) == float(s[fused.RES]) and float(s[fused.FLAG]) == 1.0


def test_plain_versions_guard_zero_denominators():
    """A zero ``pAp`` or ``rz`` divides by 1, as the solver's _nonzero does."""
    r, Ap = _field(7, torch.float64, seed=1), _field(7, torch.float64, seed=2)
    x, p = torch.zeros(7, dtype=torch.float64), torch.zeros(7, dtype=torch.float64)
    s = fused.scalars(*(torch.tensor(v, dtype=torch.float64) for v in (3.0, 1.0, 0.5)))
    hist = torch.zeros(1, dtype=torch.float64)
    fused.cg_pdot_reference(p, Ap, s)
    assert float(s[fused.PAP]) == 0.0
    r0 = r.clone()
    fused.cg_xr_reference(x, r, p, Ap, s, hist, 0)
    assert torch.equal(r, r0 - 3.0 * Ap)  # alpha = rz / 1
    s[fused.RZ] = 0.0
    s[fused.RR] = 2.0
    fused.cg_xr_reference(x, r, p, torch.zeros_like(Ap), s, hist, 0)
    assert float(s[fused.BETA]) == float(s[fused.RR])  # beta = rr / 1


def _poisson_case(dtype=torch.float64):
    return lt.Poisson2D(16, 12, dtype=dtype), _field((12, 16), dtype, seed=3)


def _route_cases():
    def identity(dtype):
        def make():
            op, b = _poisson_case(dtype)
            return dict(A=op, b=b)
        return make

    def preconditioner():
        op, b = _poisson_case()
        return dict(A=op, b=b, preconditioner=lt.DiagonalOperator(torch.full_like(b, 0.5)))

    def pytree():
        op, b = _poisson_case()
        A = lt.MatvecOperator(lambda v: {"u": op.matvec(v["u"])}, is_hermitian=True)
        return dict(A=A, b={"u": b})

    def complex_():
        op, b = _poisson_case()
        bc = torch.complex(b, _field(b.shape, torch.float64, seed=4))
        return dict(A=lt.MatvecOperator(op.matvec, is_hermitian=True), b=bc)

    return {"identity_f64": (identity(torch.float64), True),
            "identity_f32": (identity(torch.float32), True),
            "preconditioner": (preconditioner, False),
            "pytree": (pytree, False),
            "complex": (complex_, False),
            "reduction_group": (identity(torch.float64), False)}


ROUTES = _route_cases()


@pytest.fixture
def world_of_one():
    """A one-process gloo group set as the reduction group."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    prev = vectors.set_reduction_group(dist.group.WORLD)
    try:
        yield
    finally:
        vectors.set_reduction_group(prev)
        dist.destroy_process_group()


def _solve(case):
    args = ROUTES[case][0]()
    rtol = 1e-5 if vectors.dtype_of(args["b"]) == torch.float32 else 1e-10
    return lt.cg(rtol=rtol, atol=0.0, options=lt.CGOptions(maxiter=500), **args)


@pytest.mark.parametrize("case", list(ROUTES))
def test_route_selection(case, monkeypatch, request):
    """Identity, float32/float64 and one leaf take the kernels (their plain
    versions here), counted once an iteration; a preconditioner, a pytree,
    complex vectors or a set reduction group leave the counter at 0 and give
    the bits the loop of separate operations gives."""
    if case == "reduction_group":
        request.getfixturevalue("world_of_one")
    takes_kernels = ROUTES[case][1]
    before = _fused_iterations()
    x, info, meta = _solve(case)
    assert info > 0 and meta.converged
    assert _fused_iterations() - before == (meta.n_iter if takes_kernels else 0)
    _unfused(monkeypatch)
    xu, infou, metau = _solve(case)
    leaves, leaves_u = torch.utils._pytree.tree_leaves(x), torch.utils._pytree.tree_leaves(xu)
    if takes_kernels:
        assert abs(info - infou) <= 1
        rel = 1e-4 if leaves[0].dtype == torch.float32 else 1e-9
        for a, b in zip(leaves, leaves_u):
            assert torch.linalg.norm(a - b) <= rel * torch.linalg.norm(b)
    else:
        assert info == infou and np.array_equal(meta.residuals, metau.residuals)
        assert all(torch.equal(a, b) for a, b in zip(leaves, leaves_u))


def test_fused_solve_leaves_the_callers_tensors_alone():
    op, b = _poisson_case()
    x0 = _field(b.shape, torch.float64, seed=5)
    b0, x00 = b.clone(), x0.clone()
    x, info, _ = lt.cg(op, b, x0=x0, rtol=1e-10, atol=0.0, options=lt.CGOptions(maxiter=500))
    assert info > 0
    assert torch.equal(b, b0) and torch.equal(x0, x00)
    assert x.data_ptr() not in (b.data_ptr(), x0.data_ptr())


def _launches(name):
    """The kernel launches counted so far under ``launches.<name>``."""
    return timer.get_counter(f"launches.{name}")


def test_fused_cpu_solve_launches_nothing():
    before = (_launches("cg_pdot"), _launches("cg_xr"), _launches("cg_p"))
    _solve("identity_f64")
    assert (_launches("cg_pdot"), _launches("cg_xr"), _launches("cg_p")) == before


def _bound(*vectors, s=None, hist=None, dtype=torch.float64):
    """A :class:`FusedCG` on ``x, r, p`` (copies of ``vectors`` where fewer
    than three are given), ``s`` and ``hist``."""
    x, r, p = (list(vectors) + [vectors[-1].clone() for _ in range(3 - len(vectors))])[:3]
    s = torch.zeros(8, dtype=dtype, device=x.device) if s is None else s
    hist = torch.zeros(2, dtype=dtype, device=x.device) if hist is None else hist
    return fused.FusedCG(x, r, p, s, hist)


def test_kernel_wrappers_check_their_tensors():
    v = torch.zeros(8, dtype=torch.float64)
    s = torch.zeros(8, dtype=torch.float64)
    with pytest.raises(TypeError, match="not supported"):
        _bound(v.to(torch.float16), dtype=torch.float16)
    with pytest.raises(ValueError, match="differ in length"):
        _bound(v, torch.zeros(9, dtype=torch.float64))
    with pytest.raises(ValueError, match="slots"):
        _bound(v, s=torch.zeros(4, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        _bound(torch.zeros(8, 2, dtype=torch.float64)[:, 0], v, v.clone())
    with pytest.raises(ValueError, match="the operator gave"):
        fused.cg_pdot(_bound(v), torch.zeros(9, dtype=torch.float64))
    with pytest.raises(ValueError, match="the operator gave"):
        _bound(v).update(v.to(torch.float32), 0)
    with pytest.raises(IndexError):
        fused.cg_xr(_bound(v), v.clone(), 2)


# -- on the GPU ------------------------------------------------------------------

KERNEL_SHAPES = [(3162, 3162), (1001, 999)]
TOL = {torch.float32: 1e-6, torch.float64: 1e-13}


def _kernel_inputs(shape, dtype, dev, offset):
    """``x, r, p, Ap`` and a scalar block with the true ``rz`` and ``pAp``;
    with ``offset`` each vector starts one element into its buffer, so none
    is 16-byte aligned and the kernels take their scalar loop."""
    n = int(np.prod(shape))
    out = []
    for seed in range(4):
        buf = _field(n + offset, dtype, dev, seed=10 + seed)
        out.append(buf[offset:].view(shape))
    x, r, p, ap = out
    rz = torch.dot(r.reshape(-1), r.reshape(-1))
    s = fused.scalars(rz, torch.sqrt(rz), torch.sqrt(rz) * 0.5)
    s[fused.PAP] = torch.dot(p.reshape(-1), ap.reshape(-1))
    s[fused.BETA] = 0.75
    return x, r, p, ap, s


def _close(got, want, rel, scale=None):
    scale = torch.linalg.norm(want) if scale is None else scale
    return float(torch.linalg.norm((got - want).double())) <= rel * float(scale)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", KERNEL_SHAPES)
def test_cuda_kernels_match_plain(cuda, shape, dtype, offset):
    rel = TOL[dtype]
    x, r, p, ap, s = _kernel_inputs(shape, dtype, cuda, offset)
    if offset:
        assert p.data_ptr() % 16 != 0
    dot_scale = float(torch.linalg.norm(p.double()) * torch.linalg.norm(ap.double()))

    s1, s2 = s.clone(), s.clone()
    before = _launches("cg_pdot")
    fused.cg_pdot(_bound(x.clone(), r.clone(), p, s=s1, dtype=dtype), ap)
    fused.cg_pdot_reference(p, ap, s2)
    torch.cuda.synchronize()
    assert _launches("cg_pdot") == before + 1
    assert abs(float(s1[fused.PAP]) - float(s2[fused.PAP])) <= rel * dot_scale
    assert torch.equal(s1[[0, 2, 3, 4, 5, 6]], s2[[0, 2, 3, 4, 5, 6]])

    (x1, r1), (x2, r2) = (x.clone(), r.clone()), (x.clone(), r.clone())
    s1, s2 = s.clone(), s.clone()
    h1, h2 = torch.zeros(5, dtype=dtype, device=cuda), torch.zeros(5, dtype=dtype, device=cuda)
    before = _launches("cg_xr")
    fused.cg_xr(fused.FusedCG(x1, r1, p, s1, h1), ap, 3)
    fused.cg_xr_reference(x2, r2, p, ap, s2, h2, 3)
    torch.cuda.synchronize()
    assert _launches("cg_xr") == before + 1
    assert _close(x1, x2, rel) and _close(r1, r2, rel)
    for slot in (fused.RR, fused.RES, fused.BETA, fused.RZ):
        assert abs(float(s1[slot]) - float(s2[slot])) <= rel * abs(float(s2[slot]))
    assert float(s1[fused.FLAG]) == float(s2[fused.FLAG])
    assert float(h1[3]) == float(s1[fused.RES]) and int((h1 != 0).sum()) == 1

    p1, p2 = p.clone(), p.clone()
    before = _launches("cg_p")
    fused.cg_p(_bound(x.clone(), r, p1, s=s, dtype=dtype))
    fused.cg_p_reference(r, p2, s)
    torch.cuda.synchronize()
    assert _launches("cg_p") == before + 1
    assert _close(p1, p2, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernels_guard_zero_denominators(cuda, dtype):
    x, r, p, ap, s = _kernel_inputs((1001, 999), dtype, cuda, 0)
    zero_p = torch.zeros_like(p)
    fused.cg_pdot(_bound(x.clone(), r.clone(), zero_p, s=s, dtype=dtype), ap)
    torch.cuda.synchronize()
    assert float(s[fused.PAP]) == 0.0
    rz = float(s[fused.RZ])

    def hist():
        return torch.zeros(1, dtype=dtype, device=cuda)

    (x1, r1, s1), (x2, r2, s2) = [(x.clone(), r.clone(), s.clone()) for _ in range(2)]
    fused.cg_xr(fused.FusedCG(x1, r1, zero_p, s1, hist()), ap, 0)
    fused.cg_xr_reference(x2, r2, zero_p, ap, s2, hist(), 0)
    torch.cuda.synchronize()
    assert torch.equal(x1, x)  # alpha * 0
    assert _close(r1, r - rz * ap, TOL[dtype]) and _close(r1, r2, TOL[dtype])  # alpha = rz / 1
    s1[fused.RZ] = 0.0
    s2 = s1.clone()
    fused.cg_xr(fused.FusedCG(x.clone(), r.clone(), p, s1, hist()), ap, 0)
    fused.cg_xr_reference(x.clone(), r.clone(), p, ap, s2, hist(), 0)
    torch.cuda.synchronize()
    for si in (s1, s2):
        assert float(si[fused.BETA]) == float(si[fused.RR])  # beta = rr / 1
        assert float(si[fused.RZ]) == float(si[fused.RR])


def _solve_512(dev, x0=None, rtol=1e-8, b=None):
    op = lt.CudaPoisson2D(512, dtype=torch.float64, device=dev)
    b = _field((512, 512), torch.float64, dev, seed=7) if b is None else b
    x, info, meta = lt.cg(op, b, x0=x0, rtol=rtol, atol=0.0,
                          options=lt.CGOptions(maxiter=20000))
    return op, b, x, info, meta


@pytest.mark.cuda
def test_cuda_fused_solve_matches_the_unfused_loop(cuda, monkeypatch):
    rtol = 1e-8
    before = _fused_iterations()
    launches = (_launches("cg_pdot"), _launches("cg_xr"), _launches("cg_p"))
    op, b, x, info, meta = _solve_512(cuda, rtol=rtol)
    k = meta.n_iter
    assert info == k > 0 and meta.converged
    assert _fused_iterations() - before == k
    assert (_launches("cg_pdot"), _launches("cg_xr"), _launches("cg_p")) == \
        tuple(n + k for n in launches)
    true_res = torch.linalg.norm(b - op.matvec(x)) / torch.linalg.norm(b)
    assert float(true_res) <= rtol

    _unfused(monkeypatch)
    before = _fused_iterations()
    _, _, xu, infou, metau = _solve_512(cuda, rtol=rtol)
    assert _fused_iterations() == before
    assert abs(metau.n_iter - k) <= 0.01 * metau.n_iter
    assert _close(x, xu, 1e-8)
    assert np.allclose(meta.residuals[: min(k, metau.n_iter) // 2],
                       metau.residuals[: min(k, metau.n_iter) // 2], rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_cuda_fused_solves_are_bit_equal_and_leave_the_inputs_alone(cuda):
    x0 = _field((512, 512), torch.float64, cuda, seed=8)
    b = _field((512, 512), torch.float64, cuda, seed=7)
    x00, b0 = x0.clone(), b.clone()
    _, _, x1, info1, meta1 = _solve_512(cuda, x0=x0, rtol=1e-6, b=b)
    _, _, x2, info2, meta2 = _solve_512(cuda, x0=x0, rtol=1e-6, b=b)
    torch.cuda.synchronize()
    assert info1 == info2 > 0
    assert torch.equal(x1, x2) and np.array_equal(meta1.residuals, meta2.residuals)
    assert torch.equal(x0, x00) and torch.equal(b, b0)
    assert x1.data_ptr() not in (x0.data_ptr(), b.data_ptr())
