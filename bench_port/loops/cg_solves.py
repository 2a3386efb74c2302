"""Unpreconditioned CG solves back to back, closed loop: solve ``i`` takes
right-hand side ``i mod rhs_pool`` from ``x0 = 0`` to the traffic mix's
``rtol``, with ``maxiter`` above what a solve needs.

Checked after the window, in float64, for the last answer of every
right-hand side: its true relative residual (``residual``) and the
operator's output on the right-hand side (``matvec_gap``)."""

from bench_port import harness, systems
from bench_port.reference import cg as ref_cg
from bench_port.reference import poisson as ref_poisson
from bench_port.reference import precision


def setup(run):
    lt, t = run.lt, run.cell.traffic
    run.state.update(op=systems.poisson_operator(run),
                     pool=systems.rhs_pool(run, t["rhs_pool"]),
                     opts=lt.CGOptions(maxiter=t["maxiter"]), answers={})
    # the window's shapes: a few iterations of a solve
    lt.cg(run.state["op"], run.state["pool"][0], rtol=t["rtol"], atol=0.0,
          options=lt.CGOptions(maxiter=t["warm_iterations"]))


def step(run, i):
    s, t = run.state, run.cell.traffic
    j = i % len(s["pool"])
    x, info, _ = run.lt.cg(s["op"], s["pool"][j], rtol=t["rtol"], atol=0.0, options=s["opts"])
    s["answers"][j] = x
    return info <= 0


def check(run):
    s = run.state
    run.state["matvecs"] = {j: s["op"].matvec(b) for j, b in enumerate(s["pool"])}
    systems.free_program_state(run, keep=("answers", "matvecs"))
    return compare(run, run.state["answers"], run.state["matvecs"])


def reference_answers(run, prec: str):
    """The reference CG put in the program's place, in precision ``prec``
    (the control of a float64 cell: float32)."""
    c, t = run.cell.config, run.cell.traffic
    dt, rnd = precision.WORKING_DTYPE[prec], precision.rounding(prec)

    def lap(u):
        return ref_poisson.laplacian(u, c["nx"], c["ny"])

    answers, matvecs = {}, {}
    for j in range(t["rhs_pool"]):
        b = systems.global_rhs(run, j).to(dt)
        answers[j], _ = ref_cg.cg(lap, b, t["rtol"], t["maxiter"], rounding=rnd)
        matvecs[j] = lap(b)
    return answers, matvecs


def compare(run, answers, matvecs):
    c = run.cell.config
    out = {"residual": 0.0, "matvec_gap": 0.0}
    for j in sorted(answers):
        b = systems.global_rhs(run, j)
        out["residual"] = max(out["residual"],
                              ref_poisson.relative_residual(answers[j], b, c["nx"], c["ny"]))
        out["matvec_gap"] = max(out["matvec_gap"], ref_poisson.relative_gap(
            matvecs[j], ref_poisson.laplacian(b.double(), c["nx"], c["ny"])))
    return {k: harness.check_entry(v, run.cell.limits[k]) for k, v in out.items()}
