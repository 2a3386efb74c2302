"""Restart cycles of GMRES back to back, closed loop: cycle ``i`` solves
right-hand side ``i mod rhs_pool`` with ``rtol = atol = 0`` and
``maxiter = 1``, so every cycle runs its full ``kdim`` Arnoldi steps.  On
several ranks the vectors are row blocks of ``ShardedPoisson2D``.

Checked after the window, against the reference in float64, for the last
answer of every right-hand side: the iterate (``x_gap``), the residual the
program reports for it (``residual_gap``) and the operator's output on the
right-hand side (``matvec_gap``)."""

import math

import torch

from bench_port import harness, systems
from bench_port.reference import gmres as ref_gmres
from bench_port.reference import poisson as ref_poisson
from bench_port.reference import precision


def setup(run):
    lt, t = run.lt, run.cell.traffic
    run.state.update(op=systems.poisson_operator(run),
                     pool=systems.rhs_pool(run, t["rhs_pool"]),
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
    """The program's operator on every right-hand side, then the reference
    on rank 0 (every rank takes part in the gathers)."""
    s = run.state
    run.state["matvecs"] = {j: s["op"].matvec(b) for j, b in enumerate(s["pool"])}
    systems.free_program_state(run, keep=("answers", "matvecs"))
    return compare(run, run.state["answers"], run.state["matvecs"])


def reference_answers(run, prec: str):
    """The reference put in the program's place, in precision ``prec``:
    its answers and its operator outputs, as :func:`compare` takes them."""
    c, t = run.cell.config, run.cell.traffic
    dt, rnd = precision.WORKING_DTYPE[prec], precision.rounding(prec) or (lambda u: u)

    def lap(u):  # the stencil on operands in the control's precision, as a TF32 convolution
        return ref_poisson.laplacian(rnd(u.to(dt)), c["nx"], c["ny"])

    answers, matvecs = {}, {}
    sl = systems.rows(run, c["ny"])
    for j in range(t["rhs_pool"]):
        b = systems.global_rhs(run, j).to(dt)
        x, res = ref_gmres.gmres_cycle(lap, b, t["kdim"], dtype=dt,
                                       rounding=precision.rounding(prec))
        answers[j] = (x[sl].contiguous(), res)
        matvecs[j] = lap(b)[sl].contiguous()
    return answers, matvecs


def compare(run, answers, matvecs):
    c, t = run.cell.config, run.cell.traffic
    gaps = {"x_gap": 0.0, "residual_gap": 0.0, "matvec_gap": 0.0}
    for j in sorted(answers):
        x = systems.gather_rows(run, answers[j][0])
        y = systems.gather_rows(run, matvecs[j])
        if run.rank != 0:
            continue
        b = systems.global_rhs(run, j).double()
        lap = lambda u: ref_poisson.laplacian(u, c["nx"], c["ny"])  # noqa: E731
        x_ref, _ = ref_gmres.gmres_cycle(lap, b, t["kdim"])
        res_ref = float(torch.linalg.vector_norm(b - lap(x_ref)))
        gaps["x_gap"] = max(gaps["x_gap"], ref_poisson.relative_gap(x, x_ref))
        gaps["residual_gap"] = max(gaps["residual_gap"], abs(answers[j][1] - res_ref) / res_ref)
        gaps["matvec_gap"] = max(gaps["matvec_gap"], ref_poisson.relative_gap(y, lap(b)))
        del x, y, x_ref
    return {k: harness.check_entry(v, run.cell.limits[k]) for k, v in gaps.items()}
