"""Ranks of the port's partitioned runs on the CPU, for
tests/test_torch_parallel.py.  This module imports torch and numpy only, never
jax: each rank runs in a process of its own, spawned by
``torch.multiprocessing``, joined over gloo through a file store.

``inputs()`` makes the seeded numpy inputs that the parent also gives the
JAX package; ``run_rank`` runs the named cases in order on one rank and
puts ``(rank, {case: result})`` on the queue.  A result is a dict of
numpy arrays and Python scalars, the global arrays gathered on every rank.
A case that raises records its traceback and ends the run: the other ranks
would wait in its collectives, so the later cases are marked as not run.
"""

import os
import traceback

import numpy as np


def random_bell(nbr, nbc, width, seed, bm=8, bn=128, shift=0.0):
    """A Block-ELL matrix of random blocks in numpy: ``(blocks, cols,
    dense)``, each block-row with ``width`` distinct block-columns, and
    ``shift`` added on the diagonal (tests/test_parallel.py:225-240,
    :277-296)."""
    rng = np.random.default_rng(seed)
    cols = np.zeros((nbr, width), np.int32)
    for i in range(nbr):
        cols[i] = np.sort(rng.choice(nbc, width, replace=False))
    blocks = rng.standard_normal((nbr, width, bm, bn)).astype(np.float32)
    if shift:
        for i in range(nbr):
            jblk = (i * bm) // bn
            k = int(np.where(cols[i] == jblk)[0][0])
            for r in range(bm):
                blocks[i, k, r, i * bm + r - jblk * bn] += shift
    dense = np.zeros((nbr * bm, nbc * bn), np.float32)
    for i in range(nbr):
        for k in range(width):
            j = cols[i, k]
            dense[i * bm:(i + 1) * bm, j * bn:(j + 1) * bn] += blocks[i, k]
    return blocks, cols, dense


def inputs():
    """The seeded inputs of every case (the seeds of tests/test_parallel.py)."""
    rng = np.random.default_rng
    return {
        "u_plain": rng(0).standard_normal((64, 32)),
        "u_kernel": rng(7).standard_normal((64, 32)).astype(np.float32),
        "u_tile": rng(8).standard_normal((256, 32)).astype(np.float32),
        "bell_x": rng(12).standard_normal(512).astype(np.float32),
        "bell_y": rng(14).standard_normal(512).astype(np.float32),
        "bell_b": rng(16).standard_normal(512).astype(np.float32),
        "cg_b": rng(2).standard_normal((32, 16)),
        "gmres_b": rng(12).standard_normal((64, 32)),
        "eighs_x0": rng(4).standard_normal((32, 16)),
        "svds_u0": rng(20).standard_normal((32, 16)),
        "kexpm_b": rng(21).standard_normal(128) + 1j * rng(21).standard_normal(128),
        "newton_u": rng(22).standard_normal((32, 16)),
        "arnoldi_x0": rng(23).standard_normal((32, 16)),
        "prefix_b": rng(21).standard_normal((64, 32)).astype(np.float32),
        "count_X": rng(7).standard_normal((9, 64, 32)),
        "count_y": rng(9).standard_normal((64, 32)),
        "qr_X": rng(5).standard_normal((4, 64, 32)),
    }


EIGHS_KW = dict(kdim=24, tolerance=1e-9)


def _np(t):
    return t.detach().cpu().numpy()


class _Ctx:
    def __init__(self, lt, mesh, data, specs, tmpdir):
        self.lt, self.mesh, self.data, self.specs, self.tmpdir = lt, mesh, data, specs, tmpdir

    def op(self, name):
        from lightkrylov_tpu_torch.convert import port_operator

        return port_operator(self.specs[name], mesh=self.mesh)

    def dist(self, name, dim=0):
        return self.lt.distribute(self.data[name], self.mesh, dim)

    def full(self, t, dim=0):
        return _np(self.lt.parallel.gather(t, self.mesh, dim))

    def count(self, fn):
        """``fn()`` and the vector layer's all-reduces it made."""
        timer = self.lt.timer
        timer.reset_counters()
        out = fn()
        return out, timer.get_counter("all_reduces")


def case_stencil_plain(c):
    return {"y": c.full(c.op("poisson_xla").matvec(c.dist("u_plain")))}


def case_stencil_kernel(c):
    return {"y": c.full(c.op("poisson_pallas").matvec(c.dist("u_kernel")))}


def case_stencil_multitile(c):
    return {"y": c.full(c.op("poisson_tile").matvec(c.dist("u_tile")))}


def case_gl_ops(c):
    op = c.op("gl")
    u = c.dist("kexpm_b")
    return {"y": c.full(op.matvec(u)), "x": c.full(op.rmatvec(u))}


def case_bell_matvec(c):
    return {"y": c.full(c.op("bell_mv").matvec(c.dist("bell_x")))}


def case_bell_rmatvec(c):
    return {"x": c.full(c.op("bell_rmv").rmatvec(c.dist("bell_y")))}


def case_bell_gmres(c):
    x, info, meta = c.lt.gmres(c.op("bell_gmres"), c.dist("bell_b"), atol=1e-4, rtol=0.0)
    return {"x": c.full(x), "info": info}


def case_cg(c):
    x, info, meta = c.lt.cg(c.op("poisson_16x32"), c.dist("cg_b"),
                            options=c.lt.CGOptions(maxiter=400))
    return {"x": c.full(x), "converged": meta.converged}


def _gmres_orth(c, orth):
    lt = c.lt
    (x, info, meta), n_ar = c.count(lambda: lt.gmres(
        c.op("poisson_32x64"), c.dist("gmres_b"),
        options=lt.GMRESOptions(kdim=20, maxiter=30, orthogonalization=orth)))
    return {"x": c.full(x), "converged": meta.converged, "all_reduces": n_ar,
            "n_inner": meta.n_inner, "n_outer": meta.n_iter}


def case_gmres_cgs2(c):
    return _gmres_orth(c, "cgs2")


def case_gmres_dcgs2(c):
    return _gmres_orth(c, "dcgs2")


def case_fgmres(c):
    lt = c.lt
    x, info, meta = lt.fgmres(c.op("poisson_32x64"), c.dist("gmres_b"),
                              options=lt.GMRESOptions(kdim=20, maxiter=30))
    return {"x": c.full(x), "converged": meta.converged}


def case_gmres_prefix(c):
    lt = c.lt
    x, info, meta = lt.gmres(c.op("poisson_f32"), c.dist("prefix_b"), rtol=1e-6,
                             options=lt.GMRESOptions(kdim=64, maxiter=4))
    return {"x": c.full(x)}


def case_eighs(c):
    w, V, r, info, meta = c.lt.eighs(c.op("poisson_16x32"), 4, x0=c.dist("eighs_x0"),
                                     kdim=200, tolerance=1e-9)
    return {"evals": np.asarray(w), "converged": meta.converged, "evecs": c.full(V, 1)}


def case_eigs_gl(c):
    op = c.op("gl")
    x0 = op.template() + (1.0 + 0.5j)
    w, V, r, info, meta = c.lt.eigs(op, 3, x0=x0, kdim=10, tolerance=1e-9)
    return {"evals": np.asarray(w), "info": info, "n_iter": meta.n_iter}


def case_svds(c):
    U, S, V, r, info, meta = c.lt.svds(c.op("poisson_16x32"), 3, u0=c.dist("svds_u0"),
                                       kdim=96, tolerance=1e-10)
    return {"S": np.asarray(S), "info": info}


def case_kexpm(c):
    out, info = c.lt.kexpm(c.op("gl"), c.dist("kexpm_b"), tau=0.05, tol=1e-12, kdim=64)
    return {"c": c.full(out), "info": info}


def case_newton(c):
    lt = c.lt
    A = c.op("poisson_16x32")
    u_star = c.dist("newton_u")
    f = A.matvec(u_star) + u_star**3
    system = lt.System(lambda u: A.matvec(u) + u**3 - f)
    X, info, meta = lt.newton(system, A.template(), rtol=0.0, atol=1e-10)
    return {"X": c.full(X), "info": info}


def case_checkpoint_arnoldi(c):
    """An Arnoldi factorization checkpointed after 3 steps, restored on the
    ranks and resumed to 6 (tests/test_parallel.py:392-420)."""
    lt = c.lt
    from lightkrylov_tpu_torch.krylov.arnoldi import arnoldi, initialize_arnoldi

    op = c.op("poisson_16x32")
    X, H = initialize_arnoldi(c.dist("arnoldi_x0"), 6)
    X, H, _ = arnoldi(op, X, H, kstart=1, kend=3)
    path = os.path.join(c.tmpdir, "arnoldi.npz")
    lt.save_checkpoint({"X": X, "H": H}, path, {"X": 1})
    state = lt.load_checkpoint({"X": X, "H": H}, path, {"X": 1})
    same = bool(np.array_equal(_np(state["X"]), _np(X)) and np.array_equal(_np(state["H"]), _np(H)))
    X2, H2, _ = arnoldi(op, state["X"], state["H"], kstart=4, kend=6)
    AX = lt.vectors.stack([op.matvec(X2[i]) for i in range(6)])
    XH = lt.linear_combination(X2, H2)
    return {"H": _np(H2), "roundtrip_equal": same, "file_X": np.load(path)["0001|['X']"],
            "identity_err": float(np.linalg.norm(c.full(AX, 1) - c.full(XH, 1)))}


def case_eighs_resume(c):
    """eighs interrupted after 2 cycles on the ranks and resumed, and
    resumed from the files of a serial run of each package."""
    lt = c.lt
    op, x0 = c.op("poisson_16x32"), c.dist("eighs_x0")
    full = lt.eighs(op, 4, x0=x0, options=lt.EigsOptions(maxiter=80), **EIGHS_KW)
    path = os.path.join(c.tmpdir, "eighs_sharded.npz")
    part = lt.eighs(op, 4, x0=x0, options=lt.EigsOptions(
        maxiter=2, checkpoint_every=1, checkpoint_path=path), **EIGHS_KW)
    out = {"full": full[0], "full_n_iter": full[4].n_iter, "part_converged": part[4].converged,
           "sharded_path": path}
    for name in ("sharded", "jax_serial", "port_serial"):
        src = path if name == "sharded" else c.data[f"{name}_ckpt"]
        w, V, r, info, meta = lt.eighs(op, 4, x0=x0, options=lt.EigsOptions(maxiter=80),
                                       resume_from=src, **EIGHS_KW)
        out[name] = w
        out[f"{name}_n_iter"] = meta.n_iter
        out[f"{name}_converged"] = meta.converged
    return out


def _resume_both(c, op, x0, npz, dcp):
    """eighs resumed from the ``.npz`` file and from the DCP directory:
    each run's Ritz values, step count and gathered Ritz vectors."""
    lt = c.lt
    out = {}
    for name, src in (("npz", npz), ("dcp", dcp)):
        w, V, r, info, meta = lt.eighs(op, 4, x0=x0, options=lt.EigsOptions(maxiter=80),
                                       resume_from=src, **EIGHS_KW)
        out.update({name: w, f"{name}_n_iter": meta.n_iter, f"{name}_V": c.full(V, 1),
                    f"{name}_converged": meta.converged})
    return out


def _dcp_operator(c):
    import torch

    return (c.lt.ShardedPoisson2D(16, 32, mesh=c.mesh, dtype=torch.float64),
            c.dist("eighs_x0"))


def case_dcp_save(c):
    """eighs interrupted after 2 cycles, checkpointed both to a ``.npz`` file
    and to a DCP directory, the uninterrupted run, and both resumes; the
    size of each rank's DCP file."""
    lt = c.lt
    op, x0 = _dcp_operator(c)
    npz = os.path.join(c.tmpdir, "eighs.npz")
    dcp = os.path.join(c.tmpdir, "eighs_dcp") + os.sep
    full = lt.eighs(op, 4, x0=x0, options=lt.EigsOptions(maxiter=80), **EIGHS_KW)
    for path in (npz, dcp):
        lt.eighs(op, 4, x0=x0, options=lt.EigsOptions(maxiter=2, checkpoint_every=1,
                                                     checkpoint_path=path), **EIGHS_KW)
    out = {"full": full[0], "full_n_iter": full[4].n_iter, "npz_path": npz, "dcp_path": dcp,
           "dcp_files": {f: os.path.getsize(os.path.join(dcp, f)) for f in os.listdir(dcp)}}
    out.update(_resume_both(c, op, x0, npz, dcp))
    return out


def case_dcp_resume(c):
    """Both resumes at this world size from the files written on 2 ranks."""
    op, x0 = _dcp_operator(c)
    return _resume_both(c, op, x0, c.data["npz_src"], c.data["dcp_src"])


def case_counts(c):
    """The all-reduces of each reduction: one for innerprod, gram, dot,
    norm, a CGS pass and a CholeskyQR pass (the JAX package's fused
    all-reduce counts, tests/test_parallel.py:115-153)."""
    lt = c.lt
    from lightkrylov_tpu_torch.krylov.gram_schmidt import (double_gram_schmidt_step,
                                                          orthogonalize_against_basis)
    from lightkrylov_tpu_torch.krylov.qr import _cholqr_pass

    X, y = c.dist("count_X", 1), c.dist("count_y")
    out = {}
    ip, out["innerprod"] = c.count(lambda: lt.innerprod(X, y))
    G, out["gram"] = c.count(lambda: lt.gram(X))
    _, out["dot"] = c.count(lambda: lt.dot(y, y))
    nrm, out["norm"] = c.count(lambda: lt.norm(y))
    _, out["cgs_pass"] = c.count(lambda: orthogonalize_against_basis(y, X))
    _, out["cgs2"] = c.count(lambda: double_gram_schmidt_step(y, X))
    _, out["cholqr_pass"] = c.count(lambda: _cholqr_pass(X))
    Q, R, info = lt.cholesky_qr2(X)
    out.update(innerprod_value=_np(ip), gram_value=_np(G), norm_value=float(nrm),
               cholqr2_info=info, Q_orthonormal=bool(lt.is_orthonormal(Q)))
    return out


def case_random(c):
    """``rand_like`` on a shard and a QR breakdown replacement, against the
    serial draw from the same generator state."""
    lt = c.lt
    import torch

    g = torch.Generator().manual_seed(3)
    r = lt.rand_like(g, c.dist("count_y"))
    X = c.dist("qr_X", 1)
    X[2] = 0.0  # a vanishing column: QR replaces it by a random direction
    Q, R, info = lt.qr(X)
    return {"rand": c.full(r), "Q": c.full(Q, 1), "qr_info": info}


def run_rank(rank, world, store, cases, specs, data, tmpdir, queue):
    """One rank: join the group, run ``cases`` in order, put the results."""
    import torch

    torch.set_num_threads(1)
    import lightkrylov_tpu_torch as lt

    lt.set_default_device("cpu")
    results = {}
    try:
        lt.comm_setup("gloo", init_method=f"file://{store}", world_size=world, rank=rank,
                      timeout=60)
        c = _Ctx(lt, lt.make_mesh(), data, specs, tmpdir)
        for name in cases:
            try:
                results[name] = globals()[f"case_{name}"](c)
            except Exception:  # noqa: BLE001 - reported to the parent, which fails the case
                results[name] = {"error": traceback.format_exc()}
                break
    except Exception:  # noqa: BLE001
        results["setup"] = {"error": traceback.format_exc()}
    finally:
        lt.comm_close()
        queue.put((rank, results))
