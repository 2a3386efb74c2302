"""Restart cycles of GMRES back to back, closed loop, on an assembled sparse
matrix: the configuration's convection-diffusion operator as a scipy CSR
matrix built on the host from its formula (:func:`convdiff_csr`), handed to
the program's ``bell_from_scipy``, which builds its Block-ELL layout on the
card, and applied by ``BellOperator``.  Cycle ``i`` solves right-hand side
``i mod rhs_pool``, flattened, with ``rtol = atol = 0`` and ``maxiter = 1``,
so every cycle runs its full ``kdim`` Arnoldi steps.

Checked after the window, with the matrix freed, against the reference in
float64 (``reference/convdiff.py``, matrix-free), for the last answer of
every right-hand side: the iterate (``x_gap``), the residual the program
reports for it (``residual_gap``) and the program's operator on the
right-hand side (``matvec_gap``), which checks the assembled layout and
the kernel together."""

import math
import sys

import numpy as np
import scipy.sparse as sp
import torch

from bench_port import harness, systems
from bench_port.reference import convdiff as ref_convdiff
from bench_port.reference import gmres as ref_gmres
from bench_port.reference import poisson as ref_poisson
from bench_port.reference import precision


def convdiff_csr(nx: int, ny: int, eps: float, cx: float, cy: float) -> sp.csr_matrix:
    """The operator's matrix in float64 CSR, unknown ``k = j nx + i`` for
    the point ``(i, j)``: the five diagonals in column order, the entries
    that would reach past the boundary left out."""
    hx, hy = 1.0 / (nx + 1), 1.0 / (ny + 1)
    n = nx * ny
    k = np.arange(n, dtype=np.int64)
    i, j = k % nx, k // nx
    offsets = np.array([-nx, -1, 0, 1, nx])
    values = np.array([-eps / hy**2 - cy / (2 * hy), -eps / hx**2 - cx / (2 * hx),
                       eps * (2 / hx**2 + 2 / hy**2),
                       -eps / hx**2 + cx / (2 * hx), -eps / hy**2 + cy / (2 * hy)])
    keep = np.stack([j > 0, i > 0, np.ones(n, bool), i < nx - 1, j < ny - 1], axis=1)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(keep.sum(1), out=indptr[1:])
    cols = (k[:, None] + offsets)[keep]
    vals = np.broadcast_to(values, (n, 5))[keep]
    return sp.csr_matrix((vals, cols, indptr), shape=(n, n))


def _apply(c, u):
    return ref_convdiff.apply(u, c["nx"], c["ny"], c["eps"], c["cx"], c["cy"])


def setup(run):
    lt, c, t = run.lt, run.cell.config, run.cell.traffic
    if not hasattr(lt.ops.spmv, "bell_assemble_torch"):
        raise harness.BenchError("this program assembles Block-ELL on the host only: the "
                                 "cell's layout is built on the card")
    bell = lt.bell_from_scipy(convdiff_csr(c["nx"], c["ny"], c["eps"], c["cx"], c["cy"]),
                              dtype=systems.dtype(c), device=run.device)
    print(f"bench_port: Block-ELL bm={bell.bm} bn={bell.bn} K={bell.K} nnz={bell.nnz} "
          f"fill={bell.fill_ratio:.4%} bytes={bell.data.numel() * bell.data.element_size()}",
          file=sys.stderr, flush=True)
    op = lt.BellOperator(bell)
    op.label = "bench_operator"  # the counter key of its applications
    del bell
    run.state.update(op=op,
                     pool=[systems.global_rhs(run, j).reshape(-1) for j in range(t["rhs_pool"])],
                     opts=lt.GMRESOptions(kdim=t["kdim"], maxiter=1), answers={})
    step(run, 0)  # the window's shapes: one cycle
    run.state["answers"].clear()


def step(run, i):
    s = run.state
    j = i % len(s["pool"])
    x, _, meta = run.lt.gmres(s["op"], s["pool"][j], rtol=0.0, atol=0.0, options=s["opts"])
    res = float(meta.residuals[-1])
    s["answers"][j] = (x, res)
    return not math.isfinite(res)


def check(run):
    """The program's operator on every right-hand side, then the matrix
    freed and the reference run."""
    s = run.state
    s["matvecs"] = {j: s["op"].matvec(b) for j, b in enumerate(s["pool"])}
    systems.free_program_state(run, keep=("answers", "matvecs"))
    return compare(run, s["answers"], s["matvecs"])


def reference_answers(run, prec: str):
    """The reference put in the program's place, in precision ``prec``:
    its answers and its operator outputs, flattened as the program's."""
    c, t = run.cell.config, run.cell.traffic
    dt = precision.WORKING_DTYPE[prec]
    answers, matvecs = {}, {}
    for j in range(t["rhs_pool"]):
        b = systems.global_rhs(run, j).to(dt)
        x, res = ref_gmres.gmres_cycle(lambda u: _apply(c, u), b, t["kdim"], dtype=dt,
                                       rounding=precision.rounding(prec))
        answers[j] = (x.reshape(-1), res)
        matvecs[j] = _apply(c, b).reshape(-1)
    return answers, matvecs


def compare(run, answers, matvecs):
    c, t = run.cell.config, run.cell.traffic
    grid = (c["ny"], c["nx"])
    gaps = {"x_gap": 0.0, "residual_gap": 0.0, "matvec_gap": 0.0}

    def worst(name, value):  # a NaN is the worst reading, which max() would drop
        gaps[name] = max(gaps[name], value) if math.isfinite(value) else math.inf

    for j in sorted(answers):
        b = systems.global_rhs(run, j).double()
        x_ref, _ = ref_gmres.gmres_cycle(lambda u: _apply(c, u), b, t["kdim"])
        res_ref = float(torch.linalg.vector_norm(b - _apply(c, x_ref)))
        x, res = answers[j]
        worst("x_gap", ref_poisson.relative_gap(x.reshape(grid), x_ref))
        worst("residual_gap", abs(res - res_ref) / res_ref)
        worst("matvec_gap", ref_poisson.relative_gap(matvecs[j].reshape(grid), _apply(c, b)))
        del x_ref
    return {k: harness.check_entry(v, run.cell.limits[k]) for k, v in gaps.items()}
