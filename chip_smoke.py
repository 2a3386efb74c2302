#!/usr/bin/env python3
"""Drive lightkrylov_tpu_torch's main path on one CUDA GPU and check it.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure ends the script with a non-zero exit code:

1. header: the GPU's name and power limit (nvidia-smi), torch, CUDA, nvcc;
2. build the CUDA stencil kernel from csrc/ into a clean _build/, timed;
3. the kernel against its plain PyTorch version on the GPU, f32 and f64,
   at shapes up to the main path's 3072 x 3072;
4. the main path: one GMRES(30) cycle on CudaPoisson2D(3072) in f32, with
   the kernel's launch counts set to zero just before and read just after,
   checked against the same cycle on the plain Poisson2D;
5. convergence through the kernel: f64 GMRES and f32 PCG;
6. times with CUDA events (median of 25 runs after a warm-up): the stencil,
   kernel against plain, and the GMRES(30) cycle at 3072^2 with each;
7. the Block-ELL kernel (bell_spmv) against its plain version, f32 and f64:
   matrices from scipy.sparse.random in 8x16 and 8x128 blocks with ragged
   shapes, the full-size matrix of phase 8, and repeated block-columns;
8. the Block-ELL main path: one GMRES(30) cycle on a 131072^2 matrix of
   16384 x 8 blocks of 8 x 128 (f32, 537 MB, made on the GPU from a seed),
   launch counts set to zero just before and read just after, checked
   against the same cycle through the plain version; then a solve to 1e-5;
9. Block-ELL against the stencil: Poisson 1024^2 assembled with scipy and
   converted by bell_from_scipy; one matvec and eighs(nev=4, kdim=32) on
   both operators, against each other and the closed-form spectrum;
10. eighs_3072: eighs(nev=4, kdim=32, one sweep) on CudaPoisson2D(3072) f32,
    its stencil launches counted, lambda_1 against the closed form;
11. convergence gates: f64 eighs with thick restarts on TridiagToeplitz,
    f64 GMRES on ConvectionDiffusion2D(64) through Block-ELL, and CG through
    a Hermitian Block-ELL Poisson 64^2;
12. times (CUDA events, median of 25 runs after a warm-up, kernel and plain
    in turn): bell_spmv at full size, the Block-ELL GMRES(30) cycle, and the
    eighs_3072 sweep; host reads per inner iteration.

The kernel JSON line comes second to last, the GPU line before the last, and
the last line is {"ok": true, "device": {...}}.  Without a CUDA device, or
without the package beside it, the script fails before it prints any result.
"""

import json
import shutil
import statistics
import subprocess
import time

import numpy as np
import scipy.sparse as sp
import torch

import lightkrylov_tpu_torch as lt
from lightkrylov_tpu_torch import native
from lightkrylov_tpu_torch.ops import _build
from lightkrylov_tpu_torch.ops.spmv import bell_spmv_reference
from lightkrylov_tpu_torch.ops.stencil import stencil_matvec_reference

STENCIL_SHAPES = [(33, 17), (50, 32), (64, 256), (100, 300), (1000, 3001), (3072, 3072)]
# f32/f64 kernel-vs-plain bounds on ||a-b||/||b||: the kernel may contract
# the expression into FMAs, so it is a few roundings off bit-exact
REL_TOL = {torch.float32: 1e-6, torch.float64: 1e-13}
N_MAIN = 3072
TIME_SIZES = (N_MAIN, 8192)
DEVICE = "cuda:0"
RUNS = 25
L2_BYTES = 50 * 2**20
# Block-ELL: the K3 configuration of benchmarks/tpu_drive.py:174-181, made
# square, with slot 0 of each block-row on its diagonal block-column and a
# shift on the diagonal (the random part's spectral radius is about
# sqrt(K * BN) = 32), so that GMRES converges
NBR, BELL_K, BM, BN, NBC = 16384, 8, 8, 128, 1024
SHIFT = 128.0
BELL_REL_TOL = {torch.float32: 1e-5, torch.float64: 1e-13}
BELL_SHAPES = [(1003, 777, 8, 16), (1003, 1500, 8, 128), (4097, 3001, 8, 128)]
N_BELL_POISSON = 1024
N_EIGHS = 3072


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    check(proc.returncode == 0, f"{' '.join(cmd)} exited with {proc.returncode}: {proc.stderr}")
    return proc.stdout.strip()


def seeded(shape, dtype, device, seed=0):
    a = np.random.default_rng(seed).standard_normal(shape)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def stencil_args(u):
    ny, nx = u.shape
    return dict(ihx2=float((nx + 1) ** 2), ihy2=float((ny + 1) ** 2))


def median_ms(fn, runs=RUNS, per_run=1):
    """Median over ``runs`` of the CUDA-event time of ``per_run`` calls of
    ``fn(i)``, per call, in ms, after one warm-up run."""
    for i in range(per_run):
        fn(i)
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(per_run):
            fn(i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_run)
    return statistics.median(times)


def rel_err(got, want):
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


def alternating_ms(fns, runs=RUNS, per_run=1):
    """Median CUDA-event time in ms per call of each of ``fns`` (a dict of
    callables), timed in turn ``runs`` times over ``per_run`` back-to-back
    calls, after one warm-up call each.  Several calls per sample keep the
    GPU busy while the host enqueues the next, so a short kernel's time
    leaves out the wrapper's host overhead."""
    for fn in fns.values():
        fn()
    times = {name: [] for name in fns}
    for _ in range(runs):
        for name, fn in fns.items():
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(per_run):
                fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / per_run)
    return {name: statistics.median(t) for name, t in times.items()}


def bell_main_matrix(dev, seed=0):
    """The full-size Block-ELL matrix, made on the GPU from ``seed``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    cols = torch.randint(0, NBC, (NBR, BELL_K), generator=g, device=dev, dtype=torch.int32)
    data = torch.randn((NBR, BELL_K, BM, BN), generator=g, device=dev, dtype=torch.float32)
    r = torch.arange(NBR, device=dev)
    cols[:, 0] = (r * BM // BN).to(torch.int32)
    i = torch.arange(BM, device=dev)
    data[r[:, None], 0, i[None, :], (r[:, None] * BM + i[None, :]) % BN] += SHIFT
    n = NBR * BM
    return lt.BellMatrix(data, cols, (n, n), nnz=data.numel())


def plain_bell(bell):
    """The Block-ELL operator through the plain version (square matrices
    on the block grid, so no padding)."""
    return lt.MatvecOperator(lambda v: bell_spmv_reference(bell.data, bell.cols, v))


def poisson_csr(n):
    """The 5-point -Delta of Poisson2D(n) as a scipy matrix (Kronecker sums
    of the 1-D second difference, scaled by 1/h^2)."""
    h = 1.0 / (n + 1)
    T = sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1]) / h**2
    I = sp.identity(n)
    return (sp.kron(I, T) + sp.kron(T, I)).tocsr()


def bell_parity(dev):
    """Phase 7: bell_spmv against its plain version; returns the full-size
    f32 max abs error."""
    rows = []
    main_err = None
    for dtype in (torch.float32, torch.float64):
        cases = []
        for m, n, bm, bn in BELL_SHAPES:
            A = (sp.random(m, n, density=0.02, random_state=m + bn, format="csr")
                 + sp.eye(m, n)).tocsr()
            bell = lt.bell_from_scipy(A, bm=bm, bn=bn, dtype=dtype, device=dev)
            x = seeded((-(-n // bn) * bn,), dtype, dev, seed=m)
            cases.append((f"scipy {m}x{n} in {bm}x{bn}", bell.data, bell.cols, x))
        main = bell_main_matrix(dev)
        cases.append((f"full size {NBR}x{BELL_K} blocks of {BM}x{BN}",
                      main.data.to(dtype), main.cols, seeded((NBC * BN,), dtype, dev, seed=1)))
        del main
        g = torch.Generator(device=dev).manual_seed(2)
        cols = torch.randint(0, 37, (4099, 6), generator=g, device=dev, dtype=torch.int32)
        cols[:, 1] = cols[:, 0]  # a repeated block-column in every block-row
        cols[::3, -1] = 0        # and zero padding slots
        data = torch.randn((4099, 6, 8, 128), generator=g, device=dev, dtype=dtype)
        data[::3, -1] = 0
        cases.append(("repeated block-columns", data, cols, seeded((37 * 128,), dtype, dev, seed=3)))
        for name, data, cols, x in cases:
            before = lt.bell_spmv.LAUNCHES
            got = lt.bell_spmv(data, cols, x)
            torch.cuda.synchronize()
            check(lt.bell_spmv.LAUNCHES == before + 1, "bell_spmv did not count its launch")
            want = bell_spmv_reference(data, cols, x)
            rel = rel_err(got, want)
            abs_err = float((got - want).abs().max())
            check(rel <= BELL_REL_TOL[dtype],
                  f"bell_spmv {name} {dtype}: rel err {rel:.3e} > {BELL_REL_TOL[dtype]}")
            print(f"bell_spmv parity {name} {dtype}: rel {rel:.3e}, max abs {abs_err:.3e}")
            rows.append(dict(case=name, dtype=str(dtype), rel_err=rel, max_abs_err=abs_err))
            if name.startswith("full size") and dtype == torch.float32:
                main_err = abs_err
        del cases
    torch.cuda.empty_cache()
    return rows, main_err


def bell_main_path(dev, tag):
    """Phase 8: the Block-ELL GMRES(30) cycle at full size, then a solve."""
    bell = bell_main_matrix(dev)
    op_k, op_p = lt.BellOperator(bell), plain_bell(bell)
    n = bell.shape[0]
    b = torch.randn(n, generator=torch.Generator(device=dev).manual_seed(4), device=dev)
    opts = lt.GMRESOptions(kdim=30, maxiter=1)
    lt.bell_spmv.LAUNCHES = 0
    lt.timer.reset_counters()
    x_k, info_k, meta_k = lt.gmres(op_k, b, rtol=0.0, atol=0.0, options=opts)
    torch.cuda.synchronize()
    launches = lt.bell_spmv.LAUNCHES
    host_reads = lt.timer.get_counter("host_reads")
    print(f"Block-ELL main path: GMRES(30) cycle, n={n}, {bell.data.numel() * 4 / 1e6:.0f} MB "
          f"f32 blocks: info={info_k}, {launches} bell_spmv launches, {host_reads} host reads "
          f"for {meta_k.n_inner} inner iterations")
    check(launches >= 31, f"only {launches} bell_spmv launches in the cycle")
    check(bool(torch.isfinite(x_k).all()), "Block-ELL x is not finite")
    h = meta_k.residuals
    check(len(h) == 30 and np.all(np.isfinite(h)), f"Block-ELL residual history {h}")
    x_p, info_p, meta_p = lt.gmres(op_p, b, rtol=0.0, atol=0.0, options=opts)
    dx = rel_err(x_k, x_p)
    dres = abs(meta_k.residuals[-1] - meta_p.residuals[-1]) / meta_p.residuals[-1]
    print(f"Block-ELL cycle vs plain: |x_k-x_p|/|x_p| = {dx:.3e}, final residual "
          f"{meta_k.residuals[-1]:.6e} vs {meta_p.residuals[-1]:.6e} (rel {dres:.3e}); "
          f"residual history {h[0]:.3e} ... {h[-1]:.3e}")
    check(dx <= 1e-3, f"Block-ELL x differs from the plain cycle by {dx:.3e}")
    check(dres <= 1e-3, f"Block-ELL final residual differs by {dres:.3e}")
    check(info_k == info_p == -30, f"Block-ELL info {info_k} vs {info_p}")

    x, info, meta = lt.gmres(op_k, b, rtol=1e-5)
    bnorm = float(torch.linalg.norm(b))
    true_res = float(torch.linalg.norm(b - op_p.matvec(x)))
    tol = 1e-5 * bnorm + lt.constants.atol(torch.float32)
    print(f"Block-ELL GMRES rtol=1e-5: info={info}, {meta.n_inner} iterations, true residual "
          f"(plain operator) {true_res / bnorm:.3e} of |b|")
    check(meta.converged and true_res <= 1.01 * tol, "Block-ELL GMRES did not converge to 1e-5")

    cycle = alternating_ms({
        "kernel": lambda: lt.gmres(op_k, b, rtol=0.0, atol=0.0, options=opts),
        "plain": lambda: lt.gmres(op_p, b, rtol=0.0, atol=0.0, options=opts)})
    print(f"{tag} Block-ELL GMRES(30) cycle n={n} f32: kernel {cycle['kernel']:.2f} ms, "
          f"plain {cycle['plain']:.2f} ms (median of {RUNS}, in turn)")
    print(f"{tag} Block-ELL host reads per inner iteration: {host_reads / meta_k.n_inner:.3f}")

    x1 = seeded((n,), torch.float32, dev, seed=5)
    spmv_ms = alternating_ms({
        "kernel": lambda: lt.bell_spmv(bell.data, bell.cols, x1),
        "plain": lambda: bell_spmv_reference(bell.data, bell.cols, x1)}, per_run=10)
    nbytes = (bell.data.numel() + bell.cols.numel() + 2 * n) * 4
    for name, ms in spmv_ms.items():
        print(f"{tag} bell_spmv full size f32 {name}: {ms * 1e3:.1f} us (10 calls a sample), "
              f"{nbytes / (ms * 1e-3) / 1e9:.0f} GB/s of data+cols+x+y ({nbytes / 1e6:.0f} MB)")
    del bell, op_k, op_p
    torch.cuda.empty_cache()
    return dict(launches=launches, host_reads=host_reads, n_inner=meta_k.n_inner,
                x_rel_diff=dx, final_residual=float(h[-1]),
                final_residual_plain=float(meta_p.residuals[-1]),
                solve_info=info, solve_true_relres=true_res / bnorm,
                cycle_ms=cycle, spmv_ms=spmv_ms, spmv_bytes=nbytes)


def bell_vs_stencil(dev):
    """Phase 9: Block-ELL Poisson 1024^2 against CudaPoisson2D(1024)."""
    n = N_BELL_POISSON
    t0 = time.perf_counter()
    A = poisson_csr(n)
    bell = lt.bell_from_scipy(A, dtype=np.float32, device=dev)
    t_asm = time.perf_counter() - t0
    assembler = "native C++" if native.available() else f"numpy ({native.unavailable_reason()})"
    print(f"Poisson {n}^2 in Block-ELL: {assembler} assembler, K={bell.K}, fill "
          f"{bell.fill_ratio:.4f}, {bell.data.numel() * 4 / 1e9:.2f} GB f32, {t_asm:.1f} s "
          "with the scipy assembly")
    check(bell.K <= 4, f"K={bell.K} for the 5-point stencil in 8x128 blocks")
    op_b = lt.BellOperator(bell, is_hermitian=True)
    op_s = lt.CudaPoisson2D(n, dtype=torch.float32, device=dev)
    u = seeded((n, n), torch.float32, dev, seed=6)
    before = (lt.bell_spmv.LAUNCHES, lt.stencil_matvec.LAUNCHES)
    yb, ys = op_b.matvec(u.reshape(-1)), op_s.matvec(u).reshape(-1)
    torch.cuda.synchronize()
    check((lt.bell_spmv.LAUNCHES, lt.stencil_matvec.LAUNCHES) == (before[0] + 1, before[1] + 1),
          "the matvecs did not go through both kernels")
    rel = rel_err(yb, ys)
    print(f"Block-ELL vs stencil matvec {n}^2 f32: rel {rel:.3e}")
    check(rel <= BELL_REL_TOL[torch.float32], f"Block-ELL Poisson matvec differs by {rel:.3e}")
    opts = lt.EigsOptions(maxiter=1)
    before = (lt.bell_spmv.LAUNCHES, lt.stencil_matvec.LAUNCHES)
    wb = lt.eighs(op_b, 4, x0=u.reshape(-1), kdim=32, tolerance=0.0, options=opts)[0]
    ws = lt.eighs(op_s, 4, x0=u, kdim=32, tolerance=0.0, options=opts)[0]
    launches = (lt.bell_spmv.LAUNCHES - before[0], lt.stencil_matvec.LAUNCHES - before[1])
    check(launches == (32, 32), f"eighs launched (bell_spmv, stencil) {launches} times, not 32 each")
    ev = lt.poisson2d_eigvals(n)[::-1][:4]
    dw = float(np.abs(wb - ws).max() / ev[0])
    print(f"eighs(nev=4, kdim=32) {n}^2 f32: Block-ELL {wb}, stencil {ws}, closed form {ev}; "
          f"max |diff| / lambda_max = {dw:.3e}")
    check(dw <= 1e-5, f"Block-ELL and stencil Ritz values differ by {dw:.3e} of lambda_max")
    # Ritz values lie below the eigenvalues (interlacing), up to f32 rounding
    check(np.all(wb <= ev * (1 + 1e-5)) and np.all(ws <= ev * (1 + 1e-5)),
          "a Ritz value above the spectrum")
    check(ws[0] >= ev[0] * (1 - 5e-3), f"lambda_1 Ritz value {ws[0]} far below {ev[0]}")
    K = bell.K
    del bell, op_b
    torch.cuda.empty_cache()
    return dict(assembler=assembler, assembly_s=t_asm, K=K, matvec_rel=rel, ritz_rel_diff=dw)


def eighs_3072(dev, tag):
    """Phase 10: the flagship stage eighs_3072 (flagship_tpu.py:331-356)."""
    n = N_EIGHS
    op = lt.CudaPoisson2D(n, dtype=torch.float32, device=dev)
    x0 = seeded((n, n), torch.float32, dev, seed=7)
    opts = lt.EigsOptions(maxiter=1)
    lt.stencil_matvec.LAUNCHES = lt.stencil_matvec_2d.LAUNCHES = 0
    lt.timer.reset_counters()
    w, V, r, info, meta = lt.eighs(op, 4, x0=x0, kdim=32, tolerance=0.0, options=opts)
    torch.cuda.synchronize()
    launches = lt.stencil_matvec.LAUNCHES + lt.stencil_matvec_2d.LAUNCHES
    host_reads = lt.timer.get_counter("host_reads")
    h = 1.0 / (n + 1)
    lam_max = (2.0 / h**2) * (2.0 - 2.0 * np.cos(np.pi * n * h))
    dev1 = float((lam_max - w[0]) / lam_max)
    print(f"eighs_3072: {launches} stencil launches, {host_reads} host reads for "
          f"{meta.n_iter} Lanczos steps, Ritz values {w}, lambda_1 rel dev vs closed form "
          f"{dev1:.3e}")
    check(launches == meta.n_iter == 32, f"{launches} stencil launches for {meta.n_iter} steps")
    check(np.all(np.isfinite(w)) and V.shape == (4, n, n) and bool(torch.isfinite(V).all()),
          "eighs_3072 output not finite")
    check(-1e-5 <= dev1 <= 5e-3, f"lambda_1 rel dev {dev1:.3e}")
    sweep = alternating_ms({"kernel": lambda: lt.eighs(op, 4, x0=x0, kdim=32, tolerance=0.0,
                                                       options=opts)})["kernel"]
    print(f"{tag} eighs_3072 sweep (32 Lanczos steps, CGS2, host eigh) f32: {sweep:.2f} ms "
          f"(median of {RUNS}); host reads per step {host_reads / meta.n_iter:.3f}")
    del V
    torch.cuda.empty_cache()
    return dict(launches=launches, host_reads=host_reads, steps=meta.n_iter,
                lam1_rel_dev=dev1, sweep_ms=sweep)


def convergence_gates(dev):
    """Phase 11: f64 eighs with thick restarts, GMRES and CG through
    Block-ELL."""
    out = {}
    nt = 200
    op = lt.TridiagToeplitz(nt, 2.0, -1.0, device=dev)
    x0 = seeded((nt,), torch.float64, dev, seed=8)
    w, V, r, info, meta = lt.eighs(op, 4, x0=x0, kdim=20, tolerance=1e-10,
                                   options=lt.EigsOptions(maxiter=50))
    want = np.sort(lt.toeplitz_eigvals(nt, 2.0, -1.0).real)[::-1][:4]
    err = float(np.abs(w - want).max())
    print(f"eighs f64 TridiagToeplitz({nt}), kdim=20, thick restarts: info={info}, "
          f"{meta.n_iter} steps, max |lambda - closed form| = {err:.3e}")
    check(info == 4 and meta.n_iter > 20 and err <= 1e-9, "Toeplitz eighs did not converge")
    out["toeplitz"] = dict(info=info, steps=meta.n_iter, max_err=err)

    cd = lt.ConvectionDiffusion2D(64)
    A = cd.dense().numpy()
    op_b = lt.BellOperator(lt.bell_from_scipy(A, dtype=np.float64, device=dev))
    b = seeded((64 * 64,), torch.float64, dev, seed=9)
    opts = lt.GMRESOptions(kdim=30, maxiter=40)
    before = lt.bell_spmv.LAUNCHES
    x, info, meta = lt.gmres(op_b, b, rtol=1e-10, options=opts)
    launches = lt.bell_spmv.LAUNCHES - before
    relres = float(np.linalg.norm(A @ x.cpu().numpy() - b.cpu().numpy()) / np.linalg.norm(b.cpu().numpy()))
    x_cpu, info_cpu, _ = lt.gmres(cd, b.cpu().reshape(64, 64), rtol=1e-10, options=opts)
    dcpu = float(np.linalg.norm(x.cpu().numpy() - x_cpu.numpy().ravel()) / np.linalg.norm(x_cpu.numpy()))
    print(f"gmres f64 ConvectionDiffusion2D(64) through Block-ELL: info={info}, {launches} "
          f"bell_spmv launches, relres {relres:.3e}; CPU stencil solve info={info_cpu}, "
          f"|x-x_cpu|/|x_cpu| = {dcpu:.3e}")
    check(meta.converged and relres <= 1e-9, "convdiff GMRES did not converge to 1e-9")
    check(launches >= meta.n_inner and dcpu <= 1e-8, "convdiff GMRES differs from the CPU solve")
    out["convdiff_gmres"] = dict(info=info, relres=relres, x_rel_diff_cpu=dcpu)

    P = lt.Poisson2D(64).dense().numpy()
    op_p = lt.BellOperator(lt.bell_from_scipy(P, dtype=np.float64, device=dev), is_hermitian=True)
    bp = seeded((64 * 64,), torch.float64, dev, seed=10)
    x, info, meta = lt.cg(op_p, bp, rtol=1e-10, options=lt.CGOptions(maxiter=1000))
    relres = float(np.linalg.norm(P @ x.cpu().numpy() - bp.cpu().numpy()) / np.linalg.norm(bp.cpu().numpy()))
    print(f"cg f64 Poisson 64^2 through a Hermitian BellOperator: info={info}, relres {relres:.3e}")
    check(meta.converged and relres <= 1e-9, "Block-ELL CG did not converge")
    out["bell_cg"] = dict(info=info, relres=relres)
    return out


def main():
    results = {}

    # 1. header
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    dev = torch.device(DEVICE)
    gpu = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    gpu = gpu.splitlines()[0]
    print(f"gpu: {gpu}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    nvcc = _build.find_nvcc()
    check(nvcc is not None, "nvcc not found")
    print(f"nvcc: {run([nvcc, '--version']).splitlines()[-1]}")
    tag = f"[{gpu}]"

    # 2. build from the sources, into a clean build directory
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    results["build_s"] = time.perf_counter() - t0
    print(f"build: {lib_path.name} in {results['build_s']:.2f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "ptxas info" in line and ("registers" in line or "Compiling" in line):
            print(f"  {line.strip()}")
    assembler = "native C++" if native.available() else f"numpy ({native.unavailable_reason()})"
    print(f"Block-ELL host assembler: {assembler}")

    # 3. the kernel against its plain version, through both wrappers
    results["parity"] = []
    for dtype in (torch.float32, torch.float64):
        for shape in STENCIL_SHAPES:
            u = seeded(shape, dtype, dev)
            want = stencil_matvec_reference(u, **stencil_args(u))
            for wrapper in (lt.stencil_matvec, lt.stencil_matvec_2d):
                before = wrapper.LAUNCHES
                got = wrapper(u, **stencil_args(u))
                torch.cuda.synchronize()
                check(wrapper.LAUNCHES == before + 1, f"{wrapper.__name__} did not count its launch")
                rel = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
                abs_err = float((got - want).abs().max())
                check(rel <= REL_TOL[dtype],
                      f"{wrapper.__name__} {shape} {dtype}: rel err {rel:.3e} > {REL_TOL[dtype]}")
            results["parity"].append(dict(shape=shape, dtype=str(dtype), rel_err=rel,
                                          max_abs_err=abs_err))
            print(f"parity {shape} {dtype}: rel {rel:.3e}, max abs {abs_err:.3e}")
    main_err = results["parity"][len(STENCIL_SHAPES) - 1]["max_abs_err"]

    # 4. the main path: one GMRES(30) cycle at 3072^2, f32
    b = seeded((N_MAIN, N_MAIN), torch.float32, dev)
    opts = lt.GMRESOptions(kdim=30, maxiter=1)
    op_k = lt.CudaPoisson2D(N_MAIN, dtype=torch.float32, device=dev)
    op_p = lt.Poisson2D(N_MAIN, dtype=torch.float32, device=dev)
    lt.stencil_matvec.LAUNCHES = lt.stencil_matvec_2d.LAUNCHES = 0
    lt.timer.reset_counters()
    x_k, info_k, meta_k = lt.gmres(op_k, b, rtol=0.0, atol=0.0, options=opts)
    torch.cuda.synchronize()
    main_launches = lt.stencil_matvec.LAUNCHES + lt.stencil_matvec_2d.LAUNCHES
    host_reads = lt.timer.get_counter("host_reads")
    print(f"main path: GMRES(30) cycle on CudaPoisson2D({N_MAIN}) f32: info={info_k}, "
          f"{main_launches} stencil launches, {host_reads} host reads for "
          f"{meta_k.n_inner} inner iterations")
    check(main_launches >= 31, f"only {main_launches} stencil launches in the cycle")
    check(bool(torch.isfinite(x_k).all()), "x is not finite")
    h = meta_k.residuals
    check(len(h) == 30 and np.all(np.isfinite(h)), f"residual history {h}")
    # |e_{j+1}| = |s_j| |e_j| with |s_j| <= 1; allow its f32 rounding
    check(np.all(h[1:] <= h[:-1] * (1 + 1e-6)), f"residual history increases: {h}")
    x_p, info_p, meta_p = lt.gmres(op_p, b, rtol=0.0, atol=0.0, options=opts)
    dx = float(torch.linalg.norm(x_k - x_p) / torch.linalg.norm(x_p))
    true_k = float(torch.linalg.norm(b - op_p.matvec(x_k)))
    true_p = float(torch.linalg.norm(b - op_p.matvec(x_p)))
    dres = abs(meta_k.residuals[-1] - meta_p.residuals[-1]) / meta_p.residuals[-1]
    print(f"main path vs plain Poisson2D: |x_k-x_p|/|x_p| = {dx:.3e}, final residual "
          f"{meta_k.residuals[-1]:.6e} vs {meta_p.residuals[-1]:.6e} (rel {dres:.3e}), "
          f"true residual {true_k:.6e} vs {true_p:.6e}")
    check(dx <= 1e-3, f"x differs from the plain cycle by {dx:.3e}")
    check(dres <= 1e-3, f"final residual differs by {dres:.3e}")
    check(abs(true_k - true_p) <= 1e-3 * true_p, "true residuals differ")
    check(info_k == info_p == -30, f"info {info_k} vs {info_p}")
    results["main_path"] = dict(launches=main_launches, host_reads=host_reads,
                                n_inner=meta_k.n_inner, x_rel_diff=dx,
                                final_residual=float(meta_k.residuals[-1]),
                                final_residual_plain=float(meta_p.residuals[-1]))

    # 5. convergence through the kernel, and a small-input reference
    op64 = lt.CudaPoisson2D(32, dtype=torch.float64, device=dev)
    b64 = seeded((32, 32), torch.float64, dev)
    x64, info64, meta64 = lt.gmres(op64, b64, rtol=1e-10)
    relres = float(torch.linalg.norm(b64 - op64.matvec(x64)) / torch.linalg.norm(b64))
    x_cpu, info_cpu, _ = lt.gmres(lt.Poisson2D(32), b64.cpu(), rtol=1e-10)
    dcpu = float(torch.linalg.norm(x64.cpu() - x_cpu) / torch.linalg.norm(x_cpu))
    print(f"gmres f64 CudaPoisson2D(32), default options: info={info64}, relres={relres:.3e}; "
          f"CPU plain solve info={info_cpu}, |x-x_cpu|/|x_cpu| = {dcpu:.3e}")
    check(meta64.converged and relres <= 1e-9, "f64 GMRES did not converge to 1e-9")
    check(info64 == info_cpu and dcpu <= 1e-8, "f64 GMRES differs from the CPU solve")
    op128 = lt.CudaPoisson2D(128, dtype=torch.float32, device=dev)
    M = lt.BlockJacobiPoisson(lt.Poisson2D(128, dtype=torch.float32, device=dev))
    b128 = seeded((128, 128), torch.float32, dev)
    x128, info_cg, _ = lt.cg(op128, b128, preconditioner=M, rtol=1e-4,
                             options=lt.CGOptions(maxiter=600))
    relres_cg = float(torch.linalg.norm(op128.matvec(x128) - b128) / torch.linalg.norm(b128))
    print(f"pcg f32 CudaPoisson2D(128) + BlockJacobiPoisson: info={info_cg}, relres={relres_cg:.3e}")
    check(relres_cg < 1e-3, f"PCG relres {relres_cg:.3e}")
    results["convergence"] = dict(gmres_f64_info=info64, gmres_f64_relres=relres,
                                  pcg_info=info_cg, pcg_relres=relres_cg)

    # 6. times
    results["times"] = {}
    for n in TIME_SIZES:
        nbytes = n * n * 4
        # cold: rotate over enough fields that none is still in L2
        nbuf = max(1, -(-4 * L2_BYTES // nbytes))
        fields = [seeded((n, n), torch.float32, dev, seed=s) for s in range(nbuf)]
        args = stencil_args(fields[0])
        row = {}
        for name, fn in (("kernel", lt.stencil_matvec), ("plain", stencil_matvec_reference)):
            row[f"{name}_cold_ms"] = median_ms(lambda i: fn(fields[i % nbuf], **args),
                                               per_run=nbuf * 2)
            row[f"{name}_warm_ms"] = median_ms(lambda i: fn(fields[0], **args), per_run=10)
        results["times"][f"stencil_{n}"] = row
        for regime in ("cold", "warm"):
            k, p = row[f"kernel_{regime}_ms"], row[f"plain_{regime}_ms"]
            where = ("input fits L2" if nbytes < L2_BYTES else "beyond L2") if regime == "warm" \
                else f"{nbuf} fields rotated, beyond L2"
            print(f"{tag} stencil {n}x{n} f32 {regime} ({where}): kernel {k * 1e3:.1f} us "
                  f"({8 * n * n / (k * 1e-3) / 1e9:.0f} GB/s at 8 B/point), plain {p * 1e3:.1f} us "
                  f"({8 * n * n / (p * 1e-3) / 1e9:.0f} GB/s)")
        del fields

    cycle = {"kernel": [], "plain": []}
    for name, op in (("kernel", op_k), ("plain", op_p)):  # warm-up
        lt.gmres(op, b, rtol=0.0, atol=0.0, options=opts)
    for _ in range(RUNS):
        for name, op in (("kernel", op_k), ("plain", op_p)):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            lt.gmres(op, b, rtol=0.0, atol=0.0, options=opts)
            end.record()
            end.synchronize()
            cycle[name].append(start.elapsed_time(end))
    results["times"][f"gmres30_cycle_{N_MAIN}_ms"] = {k: statistics.median(v) for k, v in cycle.items()}
    print(f"{tag} GMRES(30) cycle {N_MAIN}^2 f32: CudaPoisson2D {statistics.median(cycle['kernel']):.2f} ms, "
          f"Poisson2D {statistics.median(cycle['plain']):.2f} ms (median of {RUNS})")
    print(f"{tag} host reads per inner iteration: {host_reads / meta_k.n_inner:.3f} "
          f"({host_reads} for {meta_k.n_inner})")

    # 7-12. the Block-ELL path, eighs, and their times
    results["bell_parity"], bell_err = bell_parity(dev)
    results["bell_main_path"] = bell_main_path(dev, tag)
    results["bell_vs_stencil"] = bell_vs_stencil(dev)
    results["eighs_3072"] = eighs_3072(dev, tag)
    results["convergence"].update(convergence_gates(dev))

    stencil_main = results["times"][f"stencil_{N_MAIN}"]
    bell_main = results["bell_main_path"]
    kernels = {"kernels": [{
        "name": "stencil",
        "route": "cuda",
        "source": "lightkrylov_tpu_torch/csrc/stencil.cu",
        "replaces": "lightkrylov_tpu/ops/pallas/stencil.py:167",
        "also_replaces": "lightkrylov_tpu/ops/pallas/stencil.py:361",
        "launches": main_launches,
        "max_abs_err": main_err,
        "ms": stencil_main["kernel_cold_ms"],
        "plain_ms": stencil_main["plain_cold_ms"],
    }, {
        "name": "bell_spmv",
        "route": "cuda",
        "source": "lightkrylov_tpu_torch/csrc/spmv.cu",
        "replaces": "lightkrylov_tpu/ops/pallas/spmv.py:138",
        "launches": bell_main["launches"],
        "max_abs_err": bell_err,
        "ms": bell_main["spmv_ms"]["kernel"],
        "plain_ms": bell_main["spmv_ms"]["plain"],
    }]}
    print(json.dumps(kernels))
    print(gpu)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
