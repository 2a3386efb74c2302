"""The port's distribution layer against the JAX package's, on the CPU.

The port's ranks are real processes: a module-scoped fixture per world size
(2, and 4 for ranks with two neighbours) hands them to
``torch.multiprocessing`` (spawn), joined over gloo through a file store
under ``tmp_path``; each rank runs every case of
``tests/_torch_parallel_ranks.py`` once, and each case is then a test of
its own.  The ranks import torch alone; the JAX side runs here, in the
parent, on the JAX package's own 8-device virtual mesh
(``tests/conftest.py``), with ``kernel="pallas", interpret=True`` where
``tests/test_parallel.py`` does so.  Both sides get the same seeded numpy
inputs; the JAX operators reach the ranks through
``convert.operator_spec``/``port_operator``.

Tolerances are those of the matching ``tests/test_parallel.py`` case,
stated beside each check: 1e-12 absolute for the f64 stencil and the
complex GL operator, 1e-6 of the norm for the f32 kernel path,
``rtol=1e-4, atol=1e-3 max|y|`` for the f32 Block-ELL products, 1e-10 for
checkpoints and resumes; the all-reduce counts are exact.  The solvers'
cases are in tests/test_torch_parallel_solvers.py.  Every join and the
process group have timeouts, so a deadlock fails the tests instead of
stalling the suite.
"""

import numpy as np
import pytest
import torch

import _torch_parallel_ranks as ranks_mod
import lightkrylov_tpu_torch as lt
from _torch_parallel_parent import JaxSide, ranks_agree, rel, result, spawn_all
from lightkrylov_tpu_torch.convert import port_operator
from lightkrylov_tpu_torch.utils import timer

torch.set_num_threads(2)

WORLDS = [2, 4]


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """These tests ask for the CPU: the package's default device is the card."""
    prev = lt.constants.default_device()
    lt.constants.set_default_device("cpu")
    yield
    lt.constants.set_default_device(prev)


# -- the checks, one a case -----------------------------------------------------


def check_stencil_plain(res, j):
    assert np.allclose(res["y"], j.ref("stencil_plain"), atol=1e-12)


def check_stencil_kernel(res, j):
    assert rel(res["y"], j.ref("stencil_kernel")) < 1e-6


def check_stencil_multitile(res, j):
    assert rel(res["y"], j.ref("stencil_multitile")) < 1e-6


def check_gl_ops(res, j):
    """The complex GL operator and its adjoint (tests/test_parallel.py:170-186:
    1e-12 absolute)."""
    y, x = j.ref("gl_ops")
    assert np.allclose(res["y"], y, atol=1e-12)
    assert np.allclose(res["x"], x, atol=1e-12)


def check_bell_matvec(res, j):
    want = j.ref("bell_matvec")
    assert np.allclose(res["y"], want, rtol=1e-4, atol=1e-3 * np.abs(want).max())
    assert np.allclose(res["y"], j.dense_mv @ j.data["bell_x"], rtol=1e-4,
                       atol=1e-3 * np.abs(want).max())


def check_bell_rmatvec(res, j):
    want = j.ref("bell_rmatvec")
    assert np.allclose(res["x"], want, rtol=1e-4, atol=1e-3 * np.abs(want).max())
    assert np.allclose(res["x"], j.dense_rmv.T @ j.data["bell_y"], rtol=1e-4,
                       atol=1e-3 * np.abs(want).max())


def check_checkpoint_arnoldi(res, j):
    assert res["roundtrip_equal"]
    assert res["file_X"].shape == (7, 32, 16)  # the file holds the global basis
    assert res["identity_err"] < 1e-10
    assert np.allclose(res["H"], j.ref("checkpoint_arnoldi"), atol=1e-10)


def check_eighs_resume(res, j):
    want, n_iter = j.ref("eighs_resume")
    assert not res["part_converged"]
    assert np.allclose(res["full"], want, atol=1e-10) and res["full_n_iter"] == n_iter
    for name in ("sharded", "jax_serial", "port_serial"):
        assert res[f"{name}_converged"], name
        assert np.allclose(res[name], res["full"], atol=1e-10), name
        assert res[f"{name}_n_iter"] == res["full_n_iter"], name


def check_counts(res, j):
    for kind, n in dict(innerprod=1, gram=1, dot=1, norm=1, cgs_pass=1, cgs2=2,
                        cholqr_pass=1).items():
        assert res[kind] == n, (kind, res[kind])
    X, y = j.data["count_X"], j.data["count_y"]
    assert np.allclose(res["innerprod_value"], np.tensordot(X, y, axes=([1, 2], [0, 1])),
                       atol=1e-12)
    Xm = X.reshape(9, -1)
    assert np.allclose(res["gram_value"], Xm @ Xm.T, atol=1e-10)
    assert abs(res["norm_value"] - np.linalg.norm(y)) < 1e-12 * np.linalg.norm(y)
    assert res["cholqr2_info"] == 0 and res["Q_orthonormal"]


def check_random(res, j):
    """A partitioned draw and a QR breakdown replacement equal the serial
    ones from the same generator state (same package: 1e-12)."""
    g = torch.Generator().manual_seed(3)
    serial = lt.rand_like(g, torch.from_numpy(j.data["count_y"])).numpy()
    assert np.array_equal(res["rand"], serial)
    X = torch.from_numpy(j.data["qr_X"].copy())
    X[2] = 0.0
    Q, R, info = lt.qr(X)
    assert res["qr_info"] == info == 3
    assert np.abs(res["Q"] - Q.numpy()).max() < 1e-12


CHECKS = {name[6:]: fn for name, fn in list(globals().items()) if name.startswith("check_")}
CASES = list(CHECKS)
# the JAX results, computed while the ranks run
JAX_REFS = [c for c in CASES if c not in ("counts", "random")]


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    return JaxSide(tmp_path_factory.mktemp("jax_side"), checkpoints=True)


@pytest.fixture(scope="module")
def all_ranks(jax_side, tmp_path_factory):
    return spawn_all(WORLDS, CASES, jax_side, tmp_path_factory, refs=JAX_REFS)


@pytest.fixture(scope="module", params=WORLDS)
def ranks(request, all_ranks):
    return all_ranks[request.param]


@pytest.mark.parametrize("case", CASES)
def test_parity(ranks, jax_side, case):
    res = result(ranks, case)
    CHECKS[case](res, jax_side)


def test_ranks_agree(ranks):
    """Every rank holds the same gathered results, eigenvalues and counts."""
    ranks_agree(ranks, CASES)


def test_jax_resumes_sharded_checkpoint(ranks, jax_side):
    """The reverse direction: a state written by the ranks resumes in a
    serial run of the JAX package and of the port, to the uninterrupted
    result (1e-10, same step count)."""
    import jax.numpy as jnp
    import lightkrylov_tpu as lk
    from lightkrylov_tpu.models import Poisson2D

    res = result(ranks, "eighs_resume")
    x0 = jax_side.data["eighs_x0"]
    w, _, _, _, meta = lk.eighs(Poisson2D(16, 32), 4, x0=jnp.asarray(x0),
                                options=lk.EigsOptions(maxiter=80),
                                resume_from=res["sharded_path"], **ranks_mod.EIGHS_KW)
    assert meta.converged and meta.n_iter == res["full_n_iter"]
    assert np.allclose(np.asarray(w), res["full"], atol=1e-10)
    w, _, _, _, meta = lt.eighs(lt.Poisson2D(16, 32, device="cpu"), 4,
                                x0=torch.from_numpy(x0), options=lt.EigsOptions(maxiter=80),
                                resume_from=res["sharded_path"], **ranks_mod.EIGHS_KW)
    assert meta.converged and meta.n_iter == res["full_n_iter"]
    assert np.allclose(w, res["full"], atol=1e-10)


# -- one process, no group --------------------------------------------------------

def test_single_process_mesh():
    """Without a group: comm_setup and comm_close do nothing, the mesh has
    size 1, distribute copies, and the sharded operators equal the serial
    ones with no collective."""
    lt.comm_setup()
    mesh = lt.make_mesh()
    assert mesh.group is None and (mesh.size, mesh.rank) == (1, 0)
    assert lt.vectors.reduction_group() is None
    u = torch.from_numpy(np.random.default_rng(0).standard_normal((24, 16)))
    ud = lt.distribute(u, mesh)
    assert torch.equal(ud, u) and ud.data_ptr() != u.data_ptr()
    assert lt.shard_rows(mesh, 24) == slice(0, 24)
    lt.timer.reset_counters()
    for kernel in ("cuda", "plain"):
        op = lt.ShardedPoisson2D(16, 24, mesh=mesh, dtype=torch.float64, kernel=kernel)
        assert torch.allclose(op.matvec(ud), lt.Poisson2D(16, 24).matvec(u), atol=1e-12)
    assert lt.timer.get_counter("operator_collectives") == 0
    assert lt.timer.get_counter("all_reduces") == 0
    lt.comm_close()
    with pytest.raises(ValueError, match="divisible"):
        lt.ShardedPoisson2D(16, 25, mesh=lt.parallel.Mesh(None, 2, 0, torch.device("cpu")))


def test_sharded_gl_jvp_vmap_single_process():
    """The matvec as an autograd.Function: torch.func.jvp gives the matvec
    of the tangent, vjp the adjoint, vmap a column loop (1e-12 against the
    serial GL operator)."""
    mesh = lt.make_mesh()
    op = lt.ShardedGinzburgLandau(64, mesh=mesh, dtype=torch.complex128)
    ser = lt.GinzburgLandau(64, dtype=torch.complex128)
    rng = np.random.default_rng(1)
    u = torch.from_numpy(rng.standard_normal(64) + 1j * rng.standard_normal(64))
    v = torch.from_numpy(rng.standard_normal(64) + 1j * rng.standard_normal(64))
    _, t = torch.func.jvp(op.matvec, (u,), (v,))
    assert torch.allclose(t, ser.matvec(v), atol=1e-12)
    _, vjp = torch.func.vjp(op.matvec, u)
    assert torch.allclose(vjp(v)[0], ser.rmatvec(v), atol=1e-12)
    assert torch.allclose(op.rmatvec(v), ser.rmatvec(v), atol=1e-12)
    batch = torch.stack([u, v])
    assert torch.allclose(torch.func.vmap(op.matvec)(batch),
                          torch.stack([ser.matvec(u), ser.matvec(v)]), atol=1e-12)


def test_sharded_matvec_skips_the_function_on_plain_tensors():
    """A plain tensor that asks for no gradient is applied directly (no
    autograd node); one that asks for a gradient goes through the
    autograd.Function, whose backward is the adjoint (1e-12 against the
    serial GL operator)."""
    mesh = lt.make_mesh()
    op = lt.ShardedGinzburgLandau(64, mesh=mesh, dtype=torch.complex128)
    ser = lt.GinzburgLandau(64, dtype=torch.complex128)
    rng = np.random.default_rng(2)
    u = torch.from_numpy(rng.standard_normal(64) + 1j * rng.standard_normal(64))
    g = torch.from_numpy(rng.standard_normal(64) + 1j * rng.standard_normal(64))
    assert op.matvec(u).grad_fn is None
    assert torch.allclose(op.matvec(u), ser.matvec(u), atol=1e-12)
    ug = u.clone().requires_grad_()
    y = op.matvec(ug)
    assert type(y.grad_fn).__name__ == "LinearApplyBackward"
    y.backward(g)
    assert torch.allclose(ug.grad, ser.rmatvec(g), atol=1e-12)


def test_port_operator_needs_the_mesh(jax_side):
    with pytest.raises(ValueError, match="mesh"):
        port_operator(jax_side.specs["poisson_xla"])


# -- on the card ------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _launches(name):
    """The kernel launches counted so far under ``launches.<name>``."""
    return timer.get_counter(f"launches.{name}")


@pytest.mark.cuda
def test_cuda_sharded_operators_launch_their_kernels(cuda):
    """On a CUDA tensor the sharded stencil launches the stencil kernel and
    the sharded Block-ELL matvec the Block-ELL kernel, once a call, and
    agree with their unsharded operators (f32: 1e-6 and 1e-5 of the norm);
    a tensor the kernel refuses raises, with no plain fallback."""
    mesh = lt.make_mesh(device=cuda)
    u = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 48))).to(cuda, torch.float32)
    op = lt.ShardedPoisson2D(48, 64, mesh=mesh)
    before = _launches("stencil_matvec")
    y = op.matvec(u)
    torch.cuda.synchronize()
    assert _launches("stencil_matvec") == before + 1
    want = lt.CudaPoisson2D(48, 64, device=cuda).matvec(u)
    assert float(torch.linalg.norm(y - want) / torch.linalg.norm(want)) < 1e-6
    with pytest.raises(ValueError, match="contiguous"):
        op.matvec(torch.ones(48, 64, device=cuda).T)
    blocks, cols, dense = ranks_mod.random_bell(64, 4, 3, 11)
    bell = lt.BellMatrix(torch.from_numpy(blocks), torch.from_numpy(cols), (512, 512),
                         nnz=blocks.size)
    op_b = lt.ShardedBellOperator(bell, mesh=mesh)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(512)).to(cuda, torch.float32)
    before = _launches("bell_spmv")
    y = op_b.matvec(x)
    torch.cuda.synchronize()
    assert _launches("bell_spmv") == before + 1
    want = torch.from_numpy(dense).to(cuda) @ x
    assert float(torch.linalg.norm(y - want) / torch.linalg.norm(want)) < 1e-5
