"""The parent side of tests/test_torch_parallel*.py: the JAX package's
sharded operators and results on its 8-device virtual mesh, and the spawn of
the port's gloo ranks (tests/_torch_parallel_ranks.py).  jax is imported
inside the functions here, never by the ranks."""

import functools
import queue as queue_mod

import numpy as np
import pytest
import torch

import _torch_parallel_ranks as ranks_mod
import lightkrylov_tpu_torch as lt
from lightkrylov_tpu_torch.convert import operator_spec

JOIN_S = 240


class JaxSide:
    """The JAX operators, their specs for the ranks, the serial checkpoint
    files, and each case's JAX result, computed once and cached."""

    def __init__(self, tmpdir, checkpoints: bool = False):
        import jax.numpy as jnp
        from lightkrylov_tpu.ops.pallas.spmv import BellMatrix
        from lightkrylov_tpu.parallel import (ShardedBellOperator, ShardedGinzburgLandau,
                                              ShardedPoisson2D, make_mesh)

        self.mesh = make_mesh()
        self.data = ranks_mod.inputs()
        mesh = self.mesh

        def bell(seed, width, shift=0.0):
            blocks, cols, dense = ranks_mod.random_bell(64, 4, width, seed, shift=shift)
            mat = BellMatrix(jnp.asarray(blocks), jnp.asarray(cols), (512, 512), nnz=blocks.size)
            return ShardedBellOperator(mat, mesh=mesh, interpret=True), dense

        self.ops = {
            "poisson_xla": ShardedPoisson2D(32, 64, mesh=mesh, dtype=jnp.float64),
            "poisson_pallas": ShardedPoisson2D(32, 64, mesh=mesh, dtype=jnp.float32,
                                               kernel="pallas", interpret=True),
            "poisson_tile": ShardedPoisson2D(32, 256, mesh=mesh, dtype=jnp.float32,
                                             kernel="pallas", tile=16, interpret=True),
            "poisson_16x32": ShardedPoisson2D(16, 32, mesh=mesh, dtype=jnp.float64),
            "poisson_32x64": ShardedPoisson2D(32, 64, mesh=mesh, dtype=jnp.float64),
            "poisson_f32": ShardedPoisson2D(32, 64, mesh=mesh, dtype=jnp.float32),
            "gl": ShardedGinzburgLandau(128, mesh=mesh, dtype=jnp.complex128),
        }
        (self.ops["bell_mv"], self.dense_mv) = bell(11, 3)
        (self.ops["bell_rmv"], self.dense_rmv) = bell(13, 3)
        (self.ops["bell_gmres"], dense) = bell(15, 4, shift=50.0)
        self.dense_gmres = dense
        self.specs = {name: operator_spec(op) for name, op in self.ops.items()}
        if checkpoints:
            self.data["jax_serial_ckpt"] = self._jax_serial_checkpoint(tmpdir)
            self.data["port_serial_ckpt"] = self._port_serial_checkpoint(tmpdir)

    def dist(self, name, spec=None):
        import jax.numpy as jnp
        from lightkrylov_tpu.parallel import P, distribute

        a = self.data[name]
        if spec is None:
            spec = P(self.mesh.axis_names[0], *([None] * (a.ndim - 1)))
        return distribute(jnp.asarray(a), self.mesh, spec)

    def _jax_serial_checkpoint(self, tmpdir):
        import jax.numpy as jnp
        import lightkrylov_tpu as lk
        from lightkrylov_tpu.models import Poisson2D

        path = str(tmpdir / "eighs_jax_serial.npz")
        lk.eighs(Poisson2D(16, 32), 4, x0=jnp.asarray(self.data["eighs_x0"]),
                 options=lk.EigsOptions(maxiter=2, checkpoint_every=1, checkpoint_path=path),
                 **ranks_mod.EIGHS_KW)
        return path

    def _port_serial_checkpoint(self, tmpdir):
        path = str(tmpdir / "eighs_port_serial.npz")
        lt.eighs(lt.Poisson2D(16, 32, device="cpu"), 4,
                 x0=torch.from_numpy(self.data["eighs_x0"]),
                 options=lt.EigsOptions(maxiter=2, checkpoint_every=1, checkpoint_path=path),
                 **ranks_mod.EIGHS_KW)
        return path

    @functools.cache
    def ref(self, case):
        """The JAX package's sharded result of ``case``."""
        import jax
        import jax.numpy as jnp
        import lightkrylov_tpu as lk
        from lightkrylov_tpu.parallel import P

        ops, d = self.ops, self.dist
        if case in ("stencil_plain", "stencil_kernel", "stencil_multitile"):
            op, u = {"stencil_plain": ("poisson_xla", "u_plain"),
                     "stencil_kernel": ("poisson_pallas", "u_kernel"),
                     "stencil_multitile": ("poisson_tile", "u_tile")}[case]
            return np.asarray(jax.jit(ops[op].matvec)(d(u)))
        if case == "gl_ops":
            u = d("kexpm_b")
            return (np.asarray(jax.jit(ops["gl"].matvec)(u)),
                    np.asarray(jax.jit(ops["gl"].rmatvec)(u)))
        if case == "fgmres":
            return np.asarray(lk.fgmres(ops["poisson_32x64"], d("gmres_b"),
                                        options=lk.GMRESOptions(kdim=20, maxiter=30))[0])
        if case == "bell_matvec":
            return np.asarray(jax.jit(ops["bell_mv"].matvec)(d("bell_x")))
        if case == "bell_rmatvec":
            return np.asarray(jax.jit(ops["bell_rmv"].rmatvec)(d("bell_y")))
        if case == "bell_gmres":
            return np.asarray(lk.gmres(ops["bell_gmres"], d("bell_b"), atol=1e-4, rtol=0.0)[0])
        if case == "cg":
            return np.asarray(lk.cg(ops["poisson_16x32"], d("cg_b"),
                                    options=lk.CGOptions(maxiter=400))[0])
        if case in ("gmres_cgs2", "gmres_dcgs2"):
            opts = lk.GMRESOptions(kdim=20, maxiter=30, orthogonalization=case[6:])
            return np.asarray(lk.gmres(ops["poisson_32x64"], d("gmres_b"), options=opts)[0])
        if case == "gmres_prefix":
            return np.asarray(lk.gmres(ops["poisson_f32"], d("prefix_b"), rtol=1e-6,
                                       options=lk.GMRESOptions(kdim=64, maxiter=4))[0])
        if case in ("eighs", "eighs_resume"):
            kw = dict(kdim=200, tolerance=1e-9) if case == "eighs" else dict(
                ranks_mod.EIGHS_KW, options=lk.EigsOptions(maxiter=80))
            out = lk.eighs(ops["poisson_16x32"], 4, x0=d("eighs_x0"), **kw)
            return np.asarray(out[0]), out[4].n_iter
        if case == "eigs_gl":
            x0 = ops["gl"].template() + (1.0 + 0.5j)
            out = lk.eigs(ops["gl"], nev=3, x0=x0, kdim=10, tolerance=1e-9)
            return np.asarray(out[0]), out[3]
        if case == "svds":
            return np.asarray(lk.svds(ops["poisson_16x32"], nsv=3, u0=d("svds_u0"), kdim=96,
                                      tolerance=1e-10)[1])
        if case == "kexpm":
            return np.asarray(lk.kexpm(ops["gl"], d("kexpm_b"), tau=0.05, tol=1e-12,
                                       kdim=64)[0])
        if case == "newton":
            from lightkrylov_tpu.systems import System

            A, u_star = ops["poisson_16x32"], d("newton_u")
            f = A.matvec(u_star) + u_star**3
            X0 = d("newton_u") * 0.0
            X, info, _ = lk.newton(System(lambda u: A.matvec(u) + u**3 - f), X0,
                                   rtol=0.0, atol=1e-10)
            return np.asarray(X)
        if case == "checkpoint_arnoldi":
            from lightkrylov_tpu.krylov.arnoldi import arnoldi, initialize_arnoldi

            X, H = initialize_arnoldi(d("arnoldi_x0"), 6)
            X, H, _ = arnoldi(ops["poisson_16x32"], X, H, kstart=1, kend=3)
            X = jax.device_put(X, jax.sharding.NamedSharding(
                self.mesh, P(None, self.mesh.axis_names[0], None)))
            X, H, _ = arnoldi(ops["poisson_16x32"], X, H, kstart=4, kend=6)
            return np.asarray(H)
        raise KeyError(case)


def spawn_all(worlds, cases, jax_side, tmp_path_factory, refs=()):
    """Run ``cases`` on gloo ranks for each world size of ``worlds``, all
    at once, and compute the JAX results ``refs`` while they run;
    ``{world: (world, [results of rank r])}``."""
    ctx = torch.multiprocessing.get_context("spawn")
    runs = {}
    for world in worlds:
        tmpdir = tmp_path_factory.mktemp(f"world{world}")
        q = ctx.Queue()
        procs = [ctx.Process(target=ranks_mod.run_rank,
                             args=(r, world, str(tmpdir / "store"), cases, jax_side.specs,
                                   jax_side.data, str(tmpdir), q))
                 for r in range(world)]
        for p in procs:
            p.start()
        runs[world] = (procs, q)
    try:
        for name in refs:
            jax_side.ref(name)
    finally:
        out = {world: _collect(world, *run) for world, run in runs.items()}
    return out


def _collect(world, procs, q):
    """The ranks' results, every process joined (killed past its time)."""
    out = {}
    try:
        for _ in range(world):
            rank, results = q.get(timeout=JOIN_S)
            out[rank] = results
    except queue_mod.Empty:
        pass
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert not any(p.is_alive() for p in procs)
    assert sorted(out) == list(range(world)), f"ranks {sorted(out)} of {world} reported"
    return world, [out[r] for r in range(world)]


def result(ranks, case):
    world, per_rank = ranks
    for r, results in enumerate(per_rank):
        if "setup" in results:
            pytest.fail(f"rank {r} failed to set up:\n{results['setup']['error']}")
        if case not in results:
            pytest.fail(f"rank {r} did not run {case} (an earlier case failed)")
        if "error" in results[case]:
            pytest.fail(f"rank {r}, {case}:\n{results[case]['error']}")
    return per_rank[0][case]


def rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def ranks_agree(ranks, cases):
    """Every rank holds the same gathered results, eigenvalues and counts:
    each one's host solves ran on identical all-reduced data."""
    world, per_rank = ranks
    for case in cases:
        base = result(ranks, case)
        for r in range(1, world):
            for key, val in base.items():
                other = per_rank[r][case][key]
                assert np.array_equal(np.asarray(other), np.asarray(val)), (r, case, key)
