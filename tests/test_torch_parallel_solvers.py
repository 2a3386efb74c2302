"""The port's solvers on row-partitioned operators against the JAX package's
sharded solves, on the CPU: the companion of tests/test_torch_parallel.py
(same harness, cases split so that the two files run side by side).

The harness and the ranks are those of tests/test_torch_parallel.py, here
with the cases of the solvers: GMRES on the sharded Block-ELL matrix, CG,
GMRES with CGS2 and DCGS2 and with a 64-column basis, FGMRES, eighs, eigs with a
Krylov-Schur restart on the sharded complex GL operator, svds, kexpm and
Newton-Krylov.  Tolerances are those of the matching tests/test_parallel.py
case, stated beside each check: 1e-8 for f64 solutions and eigenvalues,
1e-7 for the GL eigenvalues and singular values, 1e-9 for ``kexpm``, 1e-6
for Newton, 1e-4 for the f32 GMRES, and a residual below 1e-3 for the
Block-ELL GMRES.
"""

import numpy as np
import pytest
import torch

import lightkrylov_tpu_torch as lt
from _torch_parallel_parent import JaxSide, ranks_agree, result, spawn_all

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


def check_bell_gmres(res, j):
    # tests/test_parallel.py:277-304: residual below 1e-3 against the dense
    # matrix (its diagonal shifted by 50)
    A = j.dense_gmres
    b = j.data["bell_b"]
    assert np.linalg.norm(A @ res["x"] - b) < 1e-3
    assert np.linalg.norm(A @ j.ref("bell_gmres") - b) < 1e-3
    assert np.linalg.norm(res["x"] - j.ref("bell_gmres")) < 1e-3


def check_cg(res, j):
    assert res["converged"]
    assert np.allclose(res["x"], j.ref("cg"), atol=1e-8)


def check_gmres_cgs2(res, j):
    assert res["converged"]
    assert np.allclose(res["x"], j.ref("gmres_cgs2"), atol=1e-8)


def check_gmres_dcgs2(res, j, per_rank):
    """The same solution, and fewer all-reduces than CGS2 (the JAX test
    counts them in the compiled solver): DCGS2 fuses its measurement into one
    a step, CGS2 spends two projections and a norm."""
    assert res["converged"]
    assert np.allclose(res["x"], j.ref("gmres_dcgs2"), atol=1e-8)
    cgs2 = per_rank[0]["gmres_cgs2"]
    assert res["all_reduces"] < cgs2["all_reduces"]
    assert res["all_reduces"] <= res["n_inner"] + 3 * res["n_outer"] + 1
    assert cgs2["all_reduces"] >= 3 * cgs2["n_inner"]


def check_fgmres(res, j):
    """Flexible GMRES (CGS2) on the sharded operator, as GMRES (1e-8)."""
    assert res["converged"]
    assert np.allclose(res["x"], j.ref("fgmres"), atol=1e-8)


def check_gmres_prefix(res, j):
    b = j.data["prefix_b"]
    A = lt.Poisson2D(32, 64, dtype=torch.float32, device="cpu")
    r = A.matvec(torch.from_numpy(res["x"])).numpy() - b
    assert np.linalg.norm(r) < 1e-4 * np.linalg.norm(b)
    assert np.allclose(res["x"], j.ref("gmres_prefix"), atol=1e-4)


def check_eighs(res, j):
    from lightkrylov_tpu.models import poisson2d_eigvals

    exact = np.sort(poisson2d_eigvals(16, 32))[::-1][:4]
    want, _ = j.ref("eighs")
    assert res["converged"]
    assert np.max(np.abs(res["evals"] - exact) / exact) < 1e-8
    assert np.max(np.abs(res["evals"] - want) / exact) < 1e-8


def check_eigs_gl(res, j):
    want, info = j.ref("eigs_gl")
    assert res["info"] > 0 and info > 0
    assert max(np.min(np.abs(w - want)) for w in res["evals"]) < 1e-7


def check_svds(res, j):
    assert res["info"] > 0
    assert np.allclose(res["S"], j.ref("svds"), rtol=1e-7)


def check_kexpm(res, j):
    want = j.ref("kexpm")
    assert res["info"] > 0
    assert np.linalg.norm(res["c"] - want) < 1e-9 * np.linalg.norm(want)


def check_newton(res, j):
    assert res["info"] > 0
    assert np.linalg.norm(res["X"] - j.data["newton_u"]) < 1e-6
    assert np.linalg.norm(res["X"] - j.ref("newton")) < 1e-6


CHECKS = {name[6:]: fn for name, fn in list(globals().items()) if name.startswith("check_")}
CASES = list(CHECKS)
# the JAX results, computed while the ranks run
JAX_REFS = CASES


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    return JaxSide(tmp_path_factory.mktemp("jax_side"))


@pytest.fixture(scope="module")
def all_ranks(jax_side, tmp_path_factory):
    return spawn_all(WORLDS, CASES, jax_side, tmp_path_factory, refs=JAX_REFS)


@pytest.fixture(scope="module", params=WORLDS)
def ranks(request, all_ranks):
    return all_ranks[request.param]


@pytest.mark.parametrize("case", CASES)
def test_parity(ranks, jax_side, case):
    res = result(ranks, case)
    if case == "gmres_dcgs2":
        CHECKS[case](res, jax_side, ranks[1])
    else:
        CHECKS[case](res, jax_side)


def test_ranks_agree(ranks):
    """Every rank holds the same gathered results, eigenvalues and counts."""
    ranks_agree(ranks, CASES)
