"""Calls of ``eigs`` back to back, closed loop: call ``i`` starts from field
``i mod rhs_pool`` and asks for the configuration's ``nev`` pairs with a
basis of ``kdim``, ``maxiter`` restart cycles, the traffic mix's
``tolerance`` and ``projected`` path and the default selector.  With
``tolerance = 0`` no pair converges, so every call runs its ``maxiter``
cycles and its work does not depend on the seed.  A step fails on Ritz
values or residuals that are not finite.

Checked after the window, in float64, for the last answer of every start:
the Ritz values against the reference's after the same cycles from the same
start (``ritz_gap``), each returned pair's true residual against the
residual the program reports (``residual_gap``), both over the reference's
``|lambda_1|``; the returned vectors' departure from orthonormality
(``orth_gap``, max ``|V^H V - I|``); and the operator's output on the start
(``matvec_gap``)."""

import numpy as np
import torch

from bench_port import harness, systems
from bench_port.reference import eigs as ref_eigs
from bench_port.reference import poisson as ref_poisson
from bench_port.reference import precision


def _call(run, j):
    s, c, t = run.state, run.cell.config, run.cell.traffic
    opts = run.lt.EigsOptions(maxiter=t["maxiter"], projected=t["projected"])
    w, vecs, res, _, _ = run.lt.eigs(s["op"], c["nev"], x0=s["pool"][j], kdim=c["kdim"],
                                     tolerance=t["tolerance"], options=opts,
                                     check_every=t.get("check_every"))
    return w, vecs, res


def setup(run):
    t = run.cell.traffic
    run.state.update(op=systems.poisson_operator(run),
                     pool=systems.rhs_pool(run, t["rhs_pool"]), answers={})
    # the window's shapes: a whole call (restarts, checks, the Ritz vectors)
    _call(run, 0)


def step(run, i):
    s = run.state
    j = i % len(s["pool"])
    w, vecs, res = _call(run, j)
    s["answers"][j] = (w, vecs, res)
    return not (np.all(np.isfinite(w)) and np.all(np.isfinite(res)))


def check(run):
    s = run.state
    run.state["matvecs"] = {j: s["op"].matvec(b) for j, b in enumerate(s["pool"])}
    systems.free_program_state(run, keep=("answers", "matvecs"))
    return compare(run, run.state["answers"], run.state["matvecs"])


def reference_answers(run, prec: str):
    """The reference put in the program's place, in precision ``prec``: its
    answers and its operator outputs, as :func:`compare` takes them."""
    c, t = run.cell.config, run.cell.traffic
    dt, rnd = precision.WORKING_DTYPE[prec], precision.rounding(prec) or (lambda u: u)

    def lap(u):  # the stencil on operands in the control's precision
        return ref_poisson.laplacian(rnd(u.to(dt)), c["nx"], c["ny"])

    answers, matvecs = {}, {}
    for j in range(t["rhs_pool"]):
        b = systems.global_rhs(run, j).to(dt)
        answers[j] = ref_eigs.eigs(lap, b, c["nev"], c["kdim"], t["maxiter"], dtype=dt,
                                   rounding=precision.rounding(prec))
        matvecs[j] = lap(b)
    return answers, matvecs


def _true_residuals(lap, w, vecs):
    """``||A v - lambda v|| / ||v||`` of each pair, in complex128."""
    out = []
    for lam, v in zip(w, vecs):
        v = v.to(torch.complex128)
        out.append(float(torch.linalg.vector_norm(lap(v) - complex(lam) * v)
                         / torch.linalg.vector_norm(v)))
    return np.array(out)


def _orth_gap(vecs) -> float:
    V = vecs.reshape(vecs.shape[0], -1).to(torch.complex128)
    G = V.conj() @ V.T
    return float((G - torch.eye(len(G), dtype=G.dtype, device=G.device)).abs().max())


def compare(run, answers, matvecs):
    c, t = run.cell.config, run.cell.traffic
    gaps = {"ritz_gap": 0.0, "residual_gap": 0.0, "orth_gap": 0.0, "matvec_gap": 0.0}

    def lap(u):
        return ref_poisson.laplacian(u, c["nx"], c["ny"])

    for j in sorted(answers):
        w, vecs, res = answers[j]
        b = systems.global_rhs(run, j).double()
        w_ref, _, _ = ref_eigs.eigs(lap, b, c["nev"], c["kdim"], t["maxiter"])
        scale = abs(w_ref[0])
        gaps["ritz_gap"] = max(gaps["ritz_gap"], float(np.max(np.abs(w - w_ref))) / scale)
        gaps["residual_gap"] = max(gaps["residual_gap"], float(
            np.max(np.abs(_true_residuals(lap, w, vecs) - res))) / scale)
        gaps["orth_gap"] = max(gaps["orth_gap"], _orth_gap(vecs))
        gaps["matvec_gap"] = max(gaps["matvec_gap"],
                                 ref_poisson.relative_gap(matvecs[j], lap(b)))
    return {k: harness.check_entry(v, run.cell.limits[k]) for k, v in gaps.items()}
