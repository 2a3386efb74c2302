"""The ``torch.distributed.checkpoint`` backend on gloo ranks on the CPU:
``eighs`` on a row-partitioned Poisson 16 x 32 (float64) is interrupted on 2
ranks, checkpointed to a ``.npz`` file and to a DCP directory, and resumed
from each on 2 ranks and on 4.

The DCP backend is the counterpart of the JAX package's Orbax backend,
whose files are another format, so there is no JAX run here: the DCP resume
must equal the ``.npz`` resume bit for bit, at each world size, and on 2
ranks also the uninterrupted run.  Each rank writes only its own rows:
the two ranks' files hold about half the basis each.  One spawn per world
size, through the helpers of tests/_torch_parallel_ranks.py; the ranks
import torch only.
"""

import types

import numpy as np
import pytest
import torch

import _torch_parallel_ranks as ranks_mod
import lightkrylov_tpu_torch as lt
from _torch_parallel_parent import result, spawn_all

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """These tests ask for the CPU: the package's default device is the card."""
    prev = lt.constants.default_device()
    lt.constants.set_default_device("cpu")
    yield
    lt.constants.set_default_device(prev)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2-rank save and resumes, then the 4-rank resumes from its files."""
    side = types.SimpleNamespace(specs={}, data=ranks_mod.inputs())
    two = spawn_all([2], ["dcp_save"], side, tmp_path_factory)[2]
    saved = result(two, "dcp_save")
    side.data.update(npz_src=saved["npz_path"], dcp_src=saved["dcp_path"])
    four = spawn_all([4], ["dcp_resume"], side, tmp_path_factory)[4]
    return {2: (two, "dcp_save"), 4: (four, "dcp_resume")}


def _same(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("world", [2, 4])
def test_dcp_resume_equals_npz_resume(runs, world):
    ranks, case = runs[world]
    res = result(ranks, case)
    assert res["npz_converged"] and res["dcp_converged"]
    assert res["dcp_n_iter"] == res["npz_n_iter"]
    assert _same(res["dcp"], res["npz"]) and _same(res["dcp_V"], res["npz_V"])
    exact = np.sort(lt.poisson2d_eigvals(16, 32))[::-1][:4]
    assert np.max(np.abs(res["dcp"] - exact) / exact) < 1e-8
    # every rank holds the same gathered result
    for other in ranks[1][1:]:
        for key in ("dcp", "dcp_V", "npz"):
            assert _same(other[case][key], res[key])


def test_dcp_resume_on_two_ranks_equals_the_uninterrupted_run(runs):
    res = result(runs[2][0], "dcp_save")
    assert res["full_n_iter"] == res["dcp_n_iter"]
    assert _same(res["full"], res["dcp"])


def test_dcp_ranks_write_their_own_rows(runs):
    """Two data files, one a rank, each with its half of the 25 x 32 x 16
    float64 basis (51.2 kB) and at most the small replicated leaves (H is
    4.8 kB) with the format's headers, far below the whole basis: nothing
    was gathered."""
    files = result(runs[2][0], "dcp_save")["dcp_files"]
    data = {f: n for f, n in files.items() if f.endswith(".distcp")}
    assert ".metadata" in files and len(data) == 2
    half = 25 * 16 * 16 * 8
    assert all(half <= n < 1.25 * half for n in data.values()), data


def test_backend_is_selected_by_the_trailing_separator(tmp_path):
    """A path that ends with a separator selects DCP, any other a ``.npz``
    file; an existing directory named without the separator is refused by
    the solvers instead of read as either."""
    from lightkrylov_tpu_torch.utils.checkpoint import is_dcp_path

    assert is_dcp_path(str(tmp_path / "ckpt") + "/")
    assert not is_dcp_path(str(tmp_path / "ckpt.npz"))
    assert not is_dcp_path(tmp_path / "ckpt")
    (tmp_path / "ckpt").mkdir()
    with pytest.raises(ValueError, match="ends with a separator"):
        is_dcp_path(tmp_path / "ckpt")
    op = lt.Poisson2D(8, dtype=torch.float64)
    x0 = torch.ones((8, 8), dtype=torch.float64)
    with pytest.raises(ValueError, match="is a directory"):
        lt.eighs(op, 2, x0=x0, kdim=8, resume_from=str(tmp_path / "ckpt"))
