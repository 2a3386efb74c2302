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
    eighs_3072 sweep; host reads per inner iteration;
13. gl512, the flagship eigenanalysis at full width: eigs(16, kdim=40) of the
    RK4 propagator of GinzburgLandauReal(512) f32, 16/16 converged, true
    residuals through the generator and the kappa-budgeted anchors of
    gl_direct_spectrum.npy; matvecs, the warm solve time and the share of
    it spent in the host projected solves (eig, schur_select);
14. the native complex GinzburgLandau(512) c64 propagator, eigs(8, kdim=16),
    with the same checks;
15. eigs_3072: eigs(nev=4, kdim=32, one sweep) on CudaPoisson2D(3072) f32,
    32 stencil launches, Ritz values against phase 10's, the sweep timed
    beside the eighs_3072 sweep;
16. eigs f64 on the non-normal ConvectionDiffusion2D(64) as a BellOperator
    (nev=6, kdim=30, Krylov-Schur restarts through bell_spmv), by true
    residual and against the same solve on the CPU stencil operator;
17. kexpm: a 96x96 dense f32 operator against scipy's expm, then one kexpm
    through CudaPoisson2D(3072) against the same call on Poisson2D;
18. library yardsticks: the five-point stencil as one cuDNN convolution
    (F.conv2d, padding 1) at 3072^2 and 8192^2 cold, and the full-size
    Block-ELL matrix as one cuSPARSE CSR product, each checked against the
    plain version and then timed beside its kernel, with each kernel's share
    of its bound (bytes over 3.35 TB/s);
19. svds_3072: one Golub-Kahan sweep (nsv=4, kdim=32) on CudaPoisson2D(3072)
    f32, 64 stencil launches (32 matvecs, 32 rmatvecs), against the same
    sweep on Poisson2D, sigma_1 below the closed-form lambda_max, timed;
20. svds_bell: the same sweep on the full-size Block-ELL matrix, 32
    bell_spmv launches, against the sweep through the plain version, and the
    share of the sweep in the plain rmatvec scatter;
21. svds_kexpm, the flagship stage: svds(ConvectionDiffusion2D(48) f32, 4,
    kdim=30, tol=5e-3) converged and against the dense SVD, then the same
    solve through bell_spmv;
22. roessler_upo: Newton-Krylov shooting for the Roessler UPO in f32, the
    period against 5.88108845, with the RK4 steps per period cut from the
    flagship's 3000 (printed);
23. roessler_otd: OTD modes at the Roessler fixed point in f32 over T = 50,
    the instantaneous eigenvalues against 0.097000856, with the step count
    cut from the flagship's 20000 (printed);
24. checkpoint/resume: an svds and an eigs on CudaPoisson2D f32 are
    interrupted in their second cycle, resumed from the checkpoint written
    at their first restart, and held to the uninterrupted runs;
25. the partitioned path at world size 1 over NCCL, in a spawned rank:
    ShardedPoisson2D(3162) f32 (10.0M DoF, BASELINE's 10M-DoF configuration):
    one matvec through the stencil kernel on the rank's shard against the
    plain partitioned body and the plain stencil on the whole grid; one
    GMRES(30) cycle and one 32-step eighs sweep, each against the same run
    on CudaPoisson2D(3162) and on the plain Poisson2D(3162) with the
    reduction group unset, with launches, all-reduces and halo exchanges
    counted; ShardedBellOperator over the full-size Block-ELL matrix, its
    matvec against the plain Block-ELL product on the same block-rows, its
    rmatvec against BellOperator, and one GMRES(30) cycle through bell_spmv
    against BellOperator and the plain product; the cycles and sweeps
    timed, and the sharded cycle's host time split by torch.profiler;
26. two ranks on the one card over gloo (both on cuda:0; the transport is
    printed, and no time here is a scaling number): ShardedPoisson2D at
    5120 x 2048 f32 (10.5M DoF), each rank's 2560 x 2048 matvec against
    the plain partitioned body and the plain stencil on the whole grid,
    each rank's ShardedBellOperator matvec against the plain product on
    its block-rows and its rmatvec against the unsharded operator, one
    GMRES(30) cycle and one eighs sweep against CudaPoisson2D and the plain
    Poisson2D, the all-reduces of a CGS pass, and each rank's stencil and
    Block-ELL launches;
27. small gates on the same two ranks: eigs with a Krylov-Schur restart on
    ShardedGinzburgLandau(128) c128, svds and Newton-Krylov on a sharded
    Poisson 16 x 32 f64, and a sharded eighs resumed from its checkpoint
    to the uninterrupted run, bit for bit;
28. the batched stencil kernel (stencil_matvec_batched, one launch for a
    (p, ny, nx) stack) against its plain version at STENCIL_SHAPES and the
    3162^2 shard shape, p = 2 and 4, f32 and f64; at 3072^2, p = 2, timed
    cold against two single stencil launches and cuDNN conv2d with batch 2;
29. block eigs through it: (a) probe block_eigs_r5, a DenseOperator of the
    64-dim spiral spectrum in f32, kdim 12, tol 5e-5, blksize 2 against 1,
    errors against the exact spectrum (blksize 2 within 10x of blksize 1);
    (b) eigs_3072_block, eigs(nev=4, kdim=32, one sweep, blksize=2) on
    CudaPoisson2D(3072) f32 through matvec_counter, exactly 16 batched and 0
    single stencil launches, 32 counted matvecs, Ritz values against the
    same sweep on the plain Poisson2D, the sweep timed beside phase 15's and
    profiled;
30. the batched Block-ELL kernel (bell_spmm) against its plain version on
    the full-size matrix, p = 2 and 4, timed against p single bell_spmv
    launches and cuSPARSE CSR SpMM; block eigs f64 at blksize 2 on
    ConvectionDiffusion2D(64) through bell_spmm, by true residual, and after
    6 cycles against the CPU stencil operator;
31. in the rank processes of phases 25 and 26: an eighs on a sharded Poisson
    16 x 32 f64 checkpointed to a .npz file and to a torch.distributed.checkpoint
    directory, each rank writing its own rows, and resumed from each: both
    resumes equal the uninterrupted run bit for bit;
32. the bandwidth probes' kernels (csrc/probes.cu): copy_tiles at every
    TPU copy case's shape and block (P1, P3, P6, P7) and at a ragged shape,
    copy_ring at the nine (depth, rows) cases of P4/P5 on 8192^2 and at a
    ragged size, each bit-equal to the plain copy; reduce_8x128 at 4096^2
    and 65536 x 1024 within 1e-5 of each entry's sum of |x| from the f64
    plain sum, and equal to itself across two runs; one counted launch a
    call; each case timed (CUDA events, 10 samples of 10 calls, kernel,
    plain and copy_ in turn, each sample queued behind a spinning kernel so
    that the host's launch cost stays out) beside its bound, with its grid
    and footprint, and the wrappers' host time a call;
    then the probe path, the five lightkrylov_tpu_torch.probes modules with
    a short timing loop, its launches counted; the phase's wall time.

The kernel JSON line comes second to last, the GPU line before the last, and
the last line is {"ok": true, "device": {...}}.  Without a CUDA device, or
without the package beside it, the script fails before it prints any result.
"""

import json
import queue
import shutil
import statistics
import subprocess
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp
import torch

import lightkrylov_tpu_torch as lt
from lightkrylov_tpu_torch import native
from lightkrylov_tpu_torch.ops import _build
from lightkrylov_tpu_torch.ops import probes as probe_ops
from lightkrylov_tpu_torch.ops.spmv import bell_spmm_reference, bell_spmv_reference
from lightkrylov_tpu_torch.ops.stencil import stencil_matvec_reference
from lightkrylov_tpu_torch.parallel.stencil import LinearApply, halo_rows
from lightkrylov_tpu_torch.probes import (copy_shape, deep_buffer, manual_out, roofline,
                                          stencil_sweep)

STENCIL_SHAPES = [(33, 17), (50, 32), (64, 256), (100, 300), (1000, 3001), (3072, 3072)]
# f32/f64 kernel-vs-plain bounds on ||a-b||/||b||: the kernel may contract
# the expression into FMAs, so it is a few roundings off bit-exact
REL_TOL = {torch.float32: 1e-6, torch.float64: 1e-13}
N_MAIN = 3072
TIME_SIZES = (N_MAIN, 8192)
DEVICE = "cuda:0"
RUNS = 25
L2_BYTES = 50 * 2**20
# clock cycles of the spinning kernel that a spaced sample waits behind (about 1 ms)
SPACER_CYCLES = 2_000_000
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
# gl512: the flagship configuration (benchmarks/flagship_tpu.py:100-194) and
# its anchors, the f64 direct spectrum with each eigenvalue's condition number
N_GL = 512
GL_TOL = 5e-6
GL_ANCHORS = Path(__file__).resolve().parent / "gl_direct_spectrum.npy"
# the H100 SXM datasheet rate of device memory, the denominator of every bound
HBM_BYTES_PER_S = 3.35e12
# the flagship stages roessler_upo and roessler_otd (flagship_tpu.py:197-215,
# 362-381), cut in RK4 steps: eager torch pays one launch per operation on a
# 3-vector, and a forward-mode jvp costs about 20 flows (CPU rehearsal), so
# the flagship's 3000 steps per period and 20000 OTD steps would take minutes
UPO_STEPS, UPO_STEPS_FLAGSHIP = 300, 3000
OTD_STEPS, OTD_STEPS_FLAGSHIP = 2000, 20000
# the partitioned phases: BASELINE's 10M-DoF Poisson (examples/poisson_sharded.py
# --n 3162) at world size 1, and benchmarks/WEAK_SCALING.md round 5's
# 5120 x 2048 grid on two ranks; each rank process has this long to report
N_SHARDED = 3162
WEAK_NY, WEAK_NX = 5120, 2048
RANK_TIMEOUT_S = 300
# phases 28-30: the block sizes the batched kernels are held at, the shard
# shape of phase 25, and probe block_eigs_r5 (benchmarks/results_tpu.json:61)
BATCH_PS = (2, 4)
R5_N, R5_NEV, R5_KDIM, R5_TOL = 64, 4, 12, 5e-5
R5_TPU_ERR = {2: 6.84e-4, 1: 1.54e-6}
# phase 32: each copy case of copy_tiles by its shape and block, with the TPU
# probes that copy so (P6's rows 256 and P1's 4096^2 are P7 cases too), a
# ragged shape, the ring's ragged size, the reduce's shapes, the main case of
# each kernel in the kernels line, and the probe path's short timing loop
TILE_CASES = {label: (shape, block, ["P7"]) for label, shape, block in copy_shape.CASES}
TILE_CASES["4096x4096_rows128"][2].insert(0, "P1")
TILE_CASES["8192x8192_rows64"][2].insert(0, "P3")
TILE_CASES["8192x8192_rows256"][2].insert(0, "P6")
TILE_CASES["8192x8192_rows128"] = ((8192, 8192), (128, 8192), ["P6"])
TILE_CASES["8192x8192_rows512"] = ((8192, 8192), (512, 8192), ["P6"])
TILE_CASES["ragged_24x136_blk8x68"] = ((24, 136), (8, 68), [])
RING_N = 8192
RING_RAGGED = ((1000, 36), 3, 64)
REDUCE_SHAPES = ((4096, 4096), (65536, 1024))
REDUCE_TOL = 1e-5
PROBE_REPLACES = {
    "copy_tiles": "P1 benchmarks/roofline_probe.py:72-80, P3 benchmarks/manual_out_probe.py:59-67, "
                  "P6 benchmarks/stencil_sweep.py:61-74, P7 benchmarks/copy_shape_probe.py:47-69",
    "copy_ring": "P4 benchmarks/manual_out_probe.py:112-126, "
                 "P5 benchmarks/deep_buffer_probe.py:86-102",
    "reduce_8x128": "P2 benchmarks/roofline_probe.py:116-126",
}
PROBE_MAIN = {"copy_tiles": "8192x8192_rows64", "copy_ring": "depth2_rows64",
              "reduce_8x128": "4096x4096"}
PROBE_LOOP = dict(min_diff=0.02, iters0=8)


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


def alternating_ms(fns, runs=RUNS, per_run=1, spacer=False):
    """Median CUDA-event time in ms per call of each of ``fns`` (a dict of
    callables), timed in turn ``runs`` times over ``per_run`` back-to-back
    calls, after one warm-up call each.  Several calls per sample keep the
    GPU busy while the host enqueues the next, so a short kernel's time
    leaves out the wrapper's host overhead.  With ``spacer`` each sample is
    queued behind a kernel that spins for about 1 ms, so the host has
    enqueued the sample's calls before the first starts: the time is the
    device's alone, even where a call's host time exceeds its kernel's."""
    for fn in fns.values():
        fn()
    times = {name: [] for name in fns}
    for _ in range(runs):
        for name, fn in fns.items():
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            if spacer:
                torch.cuda._sleep(SPACER_CYCLES)
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
                lam1_rel_dev=dev1, sweep_ms=sweep, ritz=w.tolist())


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


def flagship_budget(kappa, max_res):
    """The flagship's anchor budget, calibrated on the realified kdim=40
    solve (flagship_tpu.py:84-99)."""
    return min(0.5, max(2e-3, 5e-5 * kappa))


def first_order_budget(kappa, max_res):
    """The first-order bound kappa * backward error on an anchor's
    deviation, capped as the flagship caps its budget."""
    return min(0.5, max(2e-3, kappa * max_res))


def gl_checks(gl, V, r, nev, conj_too, budget):
    """The flagship's checks (flagship_tpu.py:134-191): Rayleigh quotients
    of the Ritz vectors through the generator ``gl.matvec``, their true
    residuals, and each anchor's distance to the nearest converged one
    (or its conjugate, for the realified operator) against
    ``budget(kappa, max true residual)``."""
    conv = r < GL_TOL
    lam, res = [], []
    for i in range(V.shape[0]):
        v = V[i]
        if gl.mu.is_complex():
            Av = gl.matvec(v)
        else:
            Av = torch.complex(gl.matvec(v.real), gl.matvec(v.imag))
        v, Av = (t.cpu().numpy().astype(np.complex128).ravel() for t in (v, Av))
        lam.append(np.vdot(v, Av) / np.vdot(v, v))
        res.append(float(np.linalg.norm(Av - lam[-1] * v) / np.linalg.norm(v)))
    lam, res = np.array(lam), np.array(res)
    check(np.all(np.isfinite(lam)) and np.all(np.isfinite(res)), "GL Ritz pairs not finite")
    n_conv = int(conv.sum())
    max_res = float(res[conv].max()) if conv.any() else float("inf")
    devs, budgets, flagship = [], [], []
    for w_re, w_im, _, kappa in np.load(GL_ANCHORS):
        w = complex(w_re, w_im)
        d = np.abs(lam[conv] - w).min() if conv.any() else np.inf
        if conj_too and conv.any():
            d = min(d, np.abs(lam[conv] - np.conj(w)).min())
        devs.append(float(d))
        budgets.append(budget(kappa, max_res))
        flagship.append(flagship_budget(kappa, max_res))
    check(n_conv >= nev, f"only {n_conv}/{nev} GL pairs converged")
    check(max_res < 5e-3, f"GL true eigen-residual {max_res:.2e} beyond 5e-3")
    for k, (d, b) in enumerate(zip(devs, budgets)):
        check(d < b, f"GL anchor {k} deviation {d:.2e} exceeds its kappa budget {b:.2e}")
    return dict(n_conv=n_conv, max_true_residual=max_res, true_residuals=res.tolist(),
                anchor_devs=devs, anchor_budgets=budgets, flagship_budgets=flagship,
                eigvals=[[float(z.real), float(z.imag)] for z in lam])


def gl512(dev, tag):
    """Phase 13: the flagship stage gl512 (flagship_tpu.py:100-194), the
    realified operator in f32 as on the TPU."""
    gl = lt.GinzburgLandauReal(N_GL, dtype=torch.float32, device=dev)
    prop = lt.GLPropagator(gl, tau=0.01, n_steps=10)
    x0 = seeded((2, N_GL), torch.float32, dev, seed=11)
    opts = lt.EigsOptions(maxiter=200)

    def solve():
        out = lt.eigs(prop, 16, x0=x0, kdim=40, tolerance=GL_TOL, options=opts)
        torch.cuda.synchronize()
        return out

    watch = lt.timer.global_watch
    spans = ("eigs.projected_eig", "krylov_schur.schur_select")
    lt.set_timing(True)
    t0 = time.perf_counter()
    solve()
    t_first = time.perf_counter() - t0
    before = {n: watch.timer(n).etime for n in spans}
    lt.timer.reset_counters()
    t0 = time.perf_counter()
    w, V, r, info, meta = solve()
    t_warm = time.perf_counter() - t0
    lt.set_timing(False)
    host = {n: watch.timer(n).etime - before[n] for n in spans}
    host_reads = lt.timer.get_counter("host_reads")
    host_s = sum(host.values())
    print(f"gl512: eigs(16, kdim=40, tol={GL_TOL}) of GLPropagator(GinzburgLandauReal({N_GL}) f32, "
          f"tau=0.01, 10 RK4 steps): info={info}, {meta.n_iter} matvecs, {host_reads} host reads")
    check(info > 0, f"gl512 eigs reported non-convergence: info={info}")
    check(V.shape == (16, 2, N_GL), f"gl512 eigvecs shape {tuple(V.shape)}")
    out = gl_checks(gl, V, r, 16, conj_too=True, budget=flagship_budget)
    print(f"gl512: {out['n_conv']}/16 converged, max true eigen-residual "
          f"{out['max_true_residual']:.2e}, anchor devs {['%.1e' % d for d in out['anchor_devs']]} "
          f"within budgets {['%.1e' % b for b in out['anchor_budgets']]}")
    print(f"{tag} gl512 solve: warm {t_warm:.3f} s (first {t_first:.3f} s), {meta.n_iter} matvecs, "
          f"{t_warm / meta.n_iter * 1e3:.2f} ms a matvec step; host projected solves "
          f"{host_s:.4f} s = {100 * host_s / t_warm:.2f}% of the warm solve "
          f"(eig {host['eigs.projected_eig']:.4f} s, schur_select "
          f"{host['krylov_schur.schur_select']:.4f} s); host reads per matvec "
          f"{host_reads / meta.n_iter:.3f}")
    out.update(info=info, matvecs=meta.n_iter, warm_s=t_warm, first_s=t_first,
               host_solve_s=host, host_solve_share=host_s / t_warm, host_reads=host_reads)
    return out


def gl512_complex(dev, tag):
    """Phase 14: the native complex operator at the reference's main.f90
    configuration, nev 8 with kdim 16.  The anchors are held to the
    first-order bound kappa * backward error: at kdim 16 in c64 the leading
    Ritz vector carries a true residual near 4e-4 although its Ritz
    residual is near 1e-7, which puts the best-conditioned anchor at
    1.5-3.2e-3 over start vectors (JAX package and port alike on the CPU),
    astride the flagship's calibrated 2e-3; that budget is printed beside
    it."""
    gl = lt.GinzburgLandau(N_GL, dtype=torch.complex64, device=dev)
    prop = lt.GLPropagator(gl, tau=0.01, n_steps=10)
    x0 = torch.complex(seeded((N_GL,), torch.float32, dev, seed=12),
                       seeded((N_GL,), torch.float32, dev, seed=13))
    t0 = time.perf_counter()
    w, V, r, info, meta = lt.eigs(prop, 8, x0=x0, kdim=16, tolerance=GL_TOL,
                                  options=lt.EigsOptions(maxiter=200))
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    check(info > 0, f"complex GL eigs reported non-convergence: info={info}")
    out = gl_checks(gl, V, r, 8, conj_too=False, budget=first_order_budget)
    print(f"{tag} complex GL: eigs(8, kdim=16) of GLPropagator(GinzburgLandau({N_GL}) c64): "
          f"info={info}, {out['n_conv']}/8 converged in {meta.n_iter} matvecs, {t_solve:.3f} s "
          f"(first call); max true eigen-residual {out['max_true_residual']:.2e}, anchor devs "
          f"{['%.1e' % d for d in out['anchor_devs']]} within kappa * backward error "
          f"{['%.1e' % b for b in out['anchor_budgets']]} (flagship budgets "
          f"{['%.1e' % b for b in out['flagship_budgets']]})")
    out.update(info=info, matvecs=meta.n_iter, solve_s=t_solve)
    return out


def eigs_3072(dev, tag, eighs_out):
    """Phase 15: eigs on the eighs_3072 configuration, one Arnoldi sweep of
    32 steps from the same start vector: the same Krylov space as phase 10."""
    n = N_EIGHS
    op = lt.CudaPoisson2D(n, dtype=torch.float32, device=dev)
    x0 = seeded((n, n), torch.float32, dev, seed=7)
    opts = lt.EigsOptions(maxiter=1)
    lt.stencil_matvec.LAUNCHES = lt.stencil_matvec_2d.LAUNCHES = 0
    lt.timer.reset_counters()
    w, V, r, info, meta = lt.eigs(op, 4, x0=x0, kdim=32, tolerance=0.0, options=opts)
    torch.cuda.synchronize()
    launches = lt.stencil_matvec.LAUNCHES + lt.stencil_matvec_2d.LAUNCHES
    host_reads = lt.timer.get_counter("host_reads")
    h = 1.0 / (n + 1)
    lam_max = (2.0 / h**2) * (2.0 - 2.0 * np.cos(np.pi * n * h))
    d_re = float(np.abs(w.real - np.array(eighs_out["ritz"])).max() / lam_max)
    d_im = float(np.abs(w.imag).max() / lam_max)
    print(f"eigs_3072: {launches} stencil launches, {host_reads} host reads for {meta.n_iter} "
          f"Arnoldi steps, Ritz values {w}; max |Re - eighs| / lambda_max = {d_re:.3e}, "
          f"max |Im| / lambda_max = {d_im:.3e}")
    check(launches == meta.n_iter == 32, f"{launches} stencil launches for {meta.n_iter} steps")
    check(V.shape == (4, n, n) and bool(torch.isfinite(V).all()), "eigs_3072 output not finite")
    check(d_re <= 1e-5 and d_im <= 1e-5, "eigs_3072 Ritz values differ from eighs_3072")
    del V
    sweep = alternating_ms({"eigs": lambda: lt.eigs(op, 4, x0=x0, kdim=32, tolerance=0.0,
                                                    options=opts)})["eigs"]
    print(f"{tag} eigs_3072 sweep (32 Arnoldi steps, CGS2, host eig) f32: {sweep:.2f} ms; "
          f"eighs_3072 sweep {eighs_out['sweep_ms']:.2f} ms (median of {RUNS} each); host reads "
          f"per Arnoldi step {host_reads / meta.n_iter:.3f}")
    torch.cuda.empty_cache()
    return dict(launches=launches, host_reads=host_reads, steps=meta.n_iter, re_dev=d_re,
                im_dev=d_im, sweep_ms=sweep)


def eigs_nonnormal(dev):
    """Phase 16: eigs in f64 on the non-normal convection-diffusion operator
    through bell_spmv, with Krylov-Schur restarts.  Its leading eigenvalues
    are crowded and ill-conditioned: the solve is scored by true residual,
    not against a dense eig.  Each restart cycle multiplies a rounding
    difference about thirtyfold (JAX package against port on the CPU, same
    inputs: 1.7e-14 after 6 cycles, 2e-3 after 20), so the comparison with
    the CPU stencil operator is made after 6 cycles, and the converged
    solves of the two may differ by percents."""
    cd = lt.ConvectionDiffusion2D(64)
    A = cd.dense().numpy()
    op_b = lt.BellOperator(lt.bell_from_scipy(A, dtype=np.float64, device=dev))
    x0 = seeded((64 * 64,), torch.float64, dev, seed=14)
    lt.bell_spmv.LAUNCHES = 0
    w, V, r, info, meta = lt.eigs(op_b, 6, x0=x0, kdim=30, tolerance=1e-10,
                                  options=lt.EigsOptions(maxiter=100))
    torch.cuda.synchronize()
    launches = lt.bell_spmv.LAUNCHES
    Vh = V.cpu().numpy()
    res = [float(np.linalg.norm(A @ Vh[i] - w[i] * Vh[i]) / np.linalg.norm(Vh[i]))
           for i in range(len(w))]
    print(f"eigs f64 ConvectionDiffusion2D(64) through Block-ELL: info={info}, {meta.n_iter} "
          f"matvecs ({launches} bell_spmv launches), eigenvalues {np.round(w, 4)}, max true "
          f"residual / |lambda_1| {max(res) / abs(w[0]):.3e}")
    check(info == 6, f"non-normal eigs info={info}")
    check(launches >= meta.n_iter, f"{launches} bell_spmv launches for {meta.n_iter} matvecs")
    check(max(res) <= 1e-8 * abs(w[0]), "non-normal eigs true residual above 1e-8 |lambda_1|")
    six = lt.EigsOptions(maxiter=6)
    w6, _, _, _, m6 = lt.eigs(op_b, 6, x0=x0, kdim=30, tolerance=1e-10, options=six)
    w6c, _, _, _, m6c = lt.eigs(cd, 6, x0=x0.cpu().reshape(64, 64), kdim=30, tolerance=1e-10,
                                options=six)
    d_cpu = float(np.abs(w6 - w6c).max() / abs(w6c[0]))
    print(f"the same, 6 restart cycles: Block-ELL {m6.n_iter} matvecs, CPU stencil "
          f"{m6c.n_iter}; max |w - w_cpu| / |lambda_1| = {d_cpu:.3e}")
    check(m6.n_iter == m6c.n_iter and d_cpu <= 1e-8,
          f"non-normal Ritz values differ from the CPU solve by {d_cpu:.3e}")
    return dict(info=info, matvecs=meta.n_iter, launches=launches,
                max_true_residual=max(res), cpu_rel_diff_6_cycles=d_cpu)


def kexpm_phase(dev):
    """Phase 17: kexpm against scipy's expm (flagship_tpu.py:308-325), then
    through the stencil kernel at 3072^2 against the plain operator."""
    rngl = np.random.default_rng(7)
    Am = (rngl.standard_normal((96, 96)) * 0.25).astype(np.float32)
    v = rngl.standard_normal(96).astype(np.float32)
    c, kinfo = lt.kexpm(lt.DenseOperator(torch.from_numpy(Am).to(dev)),
                        torch.from_numpy(v).to(dev), tau=0.8, tol=1e-6)
    ref = sla.expm(0.8 * Am.astype(np.float64)) @ v
    k_err = float(np.linalg.norm(c.cpu().numpy() - ref) / np.linalg.norm(ref))
    print(f"kexpm 96x96 dense f32, tau=0.8: info={kinfo}, rel err vs scipy expm (f64) {k_err:.3e}")
    check(k_err < 1e-4, f"kexpm rel err {k_err:.3e}")

    n = N_MAIN
    h = 1.0 / (n + 1)
    tau = -h * h / 8  # |tau| lambda_max is about 1
    b = seeded((n, n), torch.float32, dev, seed=15)
    b = b / torch.linalg.norm(b)
    op_k = lt.CudaPoisson2D(n, dtype=torch.float32, device=dev)
    op_p = lt.Poisson2D(n, dtype=torch.float32, device=dev)
    lt.stencil_matvec.LAUNCHES = lt.stencil_matvec_2d.LAUNCHES = 0
    c_k, info_k = lt.kexpm(op_k, b, tau)
    torch.cuda.synchronize()
    launches = lt.stencil_matvec.LAUNCHES + lt.stencil_matvec_2d.LAUNCHES
    c_p, info_p = lt.kexpm(op_p, b, tau)
    rel = rel_err(c_k, c_p)
    print(f"kexpm CudaPoisson2D({n}) f32, tau=-h^2/8: info={info_k} ({launches} stencil "
          f"launches), plain Poisson2D info={info_p}, |c_k - c_p| / |c_p| = {rel:.3e}, "
          f"|c| = {float(torch.linalg.norm(c_k)):.6f}")
    check(info_k > 0 and launches == info_k, f"kexpm info {info_k} with {launches} launches")
    check(info_k == info_p and rel <= 1e-5, "kexpm through the kernel differs from the plain call")
    return dict(dense_rel_err=k_err, dense_info=kinfo, info=info_k, launches=launches,
                rel_diff_plain=rel)


def bound_ms(nbytes):
    """The least time the card could take to move ``nbytes``, in ms."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def stencil_conv2d(u, ihx2, ihy2):
    """The five-point -Delta of ``u`` as one cuDNN convolution: the 3x3
    weights of the stencil, zero padding for the Dirichlet boundary."""
    w = torch.tensor([[0.0, -ihy2, 0.0], [-ihx2, 2.0 * (ihx2 + ihy2), -ihx2], [0.0, -ihy2, 0.0]],
                     dtype=u.dtype, device=u.device)
    return torch.nn.functional.conv2d(u[None, None], w[None, None], padding=1)[0, 0]


def bell_csr(bell):
    """The Block-ELL matrix as a CSR tensor on the same device, with the same
    stored values: each block-row's blocks sorted by block-column, so each
    row's column indices ascend (a repeated block-column repeats them)."""
    nbr, K, bm, bn = bell.data.shape
    order = torch.argsort(bell.cols, dim=1, stable=True)
    cols = torch.gather(bell.cols, 1, order)
    data = torch.gather(bell.data, 1, order[:, :, None, None].expand(-1, -1, bm, bn))
    values = data.permute(0, 2, 1, 3).reshape(-1)
    col = cols[:, None, :, None] * bn + torch.arange(bn, device=cols.device, dtype=cols.dtype)
    col = col.expand(nbr, bm, K, bn).reshape(-1)
    crow = torch.arange(0, nbr * bm + 1, device=cols.device, dtype=torch.int32) * (K * bn)
    n_cols = -(-bell.shape[1] // bn) * bn
    return torch.sparse_csr_tensor(crow, col, values, size=(nbr * bm, n_cols),
                                   check_invariants=False)


def yardsticks(dev, tag):
    """Phase 18: one library call for each kernel, checked against the
    plain version, then timed as phases 6 and 12 time the kernels."""
    out = {}
    for n in TIME_SIZES:
        nbytes = n * n * 4
        nbuf = max(1, -(-4 * L2_BYTES // nbytes))
        fields = [seeded((n, n), torch.float32, dev, seed=s) for s in range(nbuf)]
        args = stencil_args(fields[0])
        want = stencil_matvec_reference(fields[0], **args)
        rel = rel_err(stencil_conv2d(fields[0], **args), want)
        check(rel <= REL_TOL[torch.float32], f"conv2d stencil {n}^2 rel err {rel:.3e}")
        row = {"conv2d_rel_err": rel}
        for name, fn in (("kernel", lt.stencil_matvec), ("conv2d", stencil_conv2d)):
            row[f"{name}_cold_ms"] = median_ms(lambda i: fn(fields[i % nbuf], **args),
                                               per_run=nbuf * 2)
        row["bound_ms"] = bound_ms(2 * nbytes)
        out[f"stencil_{n}"] = row
        print(f"{tag} stencil {n}x{n} f32 cold: kernel {row['kernel_cold_ms'] * 1e3:.1f} us, "
              f"cuDNN conv2d {row['conv2d_cold_ms'] * 1e3:.1f} us (rel err vs plain {rel:.2e}), "
              f"bound {row['bound_ms'] * 1e3:.1f} us (8 B/point at 3.35 TB/s): kernel at "
              f"{100 * row['bound_ms'] / row['kernel_cold_ms']:.0f}% of its bound")
        del fields
    bell = bell_main_matrix(dev)
    csr = bell_csr(bell)
    n = bell.shape[0]
    x = seeded((n,), torch.float32, dev, seed=1)
    want = bell_spmv_reference(bell.data, bell.cols, x)
    rel = rel_err(torch.mv(csr, x), want)
    check(rel <= BELL_REL_TOL[torch.float32], f"CSR SpMV rel err {rel:.3e}")
    ms = alternating_ms({"kernel": lambda: lt.bell_spmv(bell.data, bell.cols, x),
                         "csr": lambda: torch.mv(csr, x)}, per_run=10)
    nbytes = (bell.data.numel() + bell.cols.numel() + 2 * n) * 4
    csr_bytes = (csr.values().numel() + csr.col_indices().numel()
                 + csr.crow_indices().numel() + 2 * n) * 4
    row = {"kernel_ms": ms["kernel"], "csr_ms": ms["csr"], "csr_rel_err": rel,
           "bound_ms": bound_ms(nbytes), "csr_bytes": csr_bytes}
    out["bell_spmv"] = row
    print(f"{tag} bell_spmv full size f32: kernel {ms['kernel'] * 1e3:.1f} us, cuSPARSE CSR "
          f"SpMV {ms['csr'] * 1e3:.1f} us (rel err vs plain {rel:.2e}; it reads "
          f"{row['csr_bytes'] / 1e6:.0f} MB against Block-ELL's {nbytes / 1e6:.0f} MB), bound "
          f"{row['bound_ms'] * 1e3:.1f} us: kernel at {100 * row['bound_ms'] / ms['kernel']:.0f}% "
          "of its bound (10 calls a sample, in turn)")
    del bell, csr
    torch.cuda.empty_cache()
    return out


def closed_form_lam_max(n):
    """The largest eigenvalue of Poisson2D(n), as flagship_tpu.py:346-348
    writes it."""
    h = 1.0 / (n + 1)
    return (2.0 / h**2) * (2.0 - np.cos(np.pi * n * h) - np.cos(np.pi * n * h))


def svds_3072(dev, tag, eighs_out):
    """Phase 19: one Golub-Kahan sweep on CudaPoisson2D(3072), against the
    same sweep on the plain Poisson2D."""
    n = N_EIGHS
    op_k = lt.CudaPoisson2D(n, dtype=torch.float32, device=dev)
    op_p = lt.Poisson2D(n, dtype=torch.float32, device=dev)
    u0 = seeded((n, n), torch.float32, dev, seed=16)
    opts = lt.SVDSOptions(maxiter=1)

    def sweep(op):
        return lt.svds(op, 4, u0=u0, kdim=32, tolerance=0.0, options=opts)

    lt.stencil_matvec.LAUNCHES = lt.stencil_matvec_2d.LAUNCHES = 0
    lt.timer.reset_counters()
    U, S, V, res, info, meta = sweep(op_k)
    torch.cuda.synchronize()
    launches = lt.stencil_matvec.LAUNCHES + lt.stencil_matvec_2d.LAUNCHES
    host_reads = lt.timer.get_counter("host_reads")
    check(U.shape == V.shape == (4, n, n) and bool(torch.isfinite(U).all())
          and bool(torch.isfinite(V).all()) and np.all(np.isfinite(S)),
          "svds_3072 output not finite")
    del U, V
    S_p = sweep(op_p)[1]
    lam_max = closed_form_lam_max(n)
    d_plain = float(np.abs(S - S_p).max() / S_p[0])
    d1 = float((lam_max - S[0]) / lam_max)
    print(f"svds_3072: {launches} stencil launches (32 matvecs + 32 rmatvecs), {host_reads} "
          f"host reads for {meta.n_iter} Golub-Kahan steps, singular values {S}; against the "
          f"plain sweep max |ds| / s_1 = {d_plain:.3e}; sigma_1 rel dev vs closed-form lambda_max "
          f"{d1:.3e} (eighs_3072 lambda_1: {eighs_out['lam1_rel_dev']:.3e})")
    check(launches == 64 and meta.n_iter == 32,
          f"{launches} stencil launches for {meta.n_iter} steps")
    check(d_plain <= 1e-5, f"svds_3072 differs from the plain sweep by {d_plain:.3e}")
    check(S[0] <= lam_max * (1 + 1e-6), f"sigma_1 {S[0]} above lambda_max {lam_max}")
    sweep_ms = alternating_ms({"svds": lambda: sweep(op_k)}, runs=10)["svds"]
    print(f"{tag} svds_3072 sweep (32 Golub-Kahan steps, two CGS2 a step, host SVD) f32: "
          f"{sweep_ms:.2f} ms (median of 10); eighs_3072 sweep {eighs_out['sweep_ms']:.2f} ms")
    prof = profile_row(tag, "svds_3072 sweep", lambda: sweep(op_k))
    torch.cuda.empty_cache()
    return dict(launches=launches, host_reads=host_reads, steps=meta.n_iter, sigma=S.tolist(),
                plain_rel_diff=d_plain, sigma1_rel_dev=d1, sweep_ms=sweep_ms, profile=prof)


def svds_bell(dev, tag):
    """Phase 20: the same sweep on the full-size Block-ELL matrix: matvecs
    through bell_spmv, rmatvecs through the plain einsum and scatter."""
    bell = bell_main_matrix(dev)
    op_k = lt.BellOperator(bell)
    op_p = lt.MatvecOperator(lambda v: bell_spmv_reference(bell.data, bell.cols, v),
                             rmatvec=op_k.rmatvec)
    n = bell.shape[0]
    u0 = seeded((n,), torch.float32, dev, seed=17)
    opts = lt.SVDSOptions(maxiter=1)

    def sweep(op):
        return lt.svds(op, 4, u0=u0, kdim=32, tolerance=0.0, options=opts)

    lt.bell_spmv.LAUNCHES = 0
    U, S, V, res, info, meta = sweep(op_k)
    torch.cuda.synchronize()
    launches = lt.bell_spmv.LAUNCHES
    S_p = sweep(op_p)[1]
    d_plain = float(np.abs(S - S_p).max() / S_p[0])
    print(f"svds_bell: {launches} bell_spmv launches for {meta.n_iter} Golub-Kahan steps, "
          f"singular values {S}; against the plain sweep max |ds| / s_1 = {d_plain:.3e}")
    check(launches == 32 and meta.n_iter == 32, f"{launches} bell_spmv launches")
    check(np.all(np.isfinite(S)) and bool(torch.isfinite(U).all()), "svds_bell output not finite")
    check(d_plain <= 1e-5, f"svds_bell differs from the plain sweep by {d_plain:.3e}")
    y = seeded((n,), torch.float32, dev, seed=18)
    ms = alternating_ms({"sweep": lambda: sweep(op_k)}, runs=10)
    ms.update(alternating_ms({"rmatvec": lambda: op_k.rmatvec(y)}, per_run=10))
    share = 32 * ms["rmatvec"] / ms["sweep"]
    print(f"{tag} svds_bell sweep f32: {ms['sweep']:.2f} ms (median of 10); the plain rmatvec "
          f"(einsum + index_add_) {ms['rmatvec'] * 1e3:.1f} us a call, 32 of them "
          f"{100 * share:.1f}% of the sweep")
    prof = profile_row(tag, "svds_bell sweep", lambda: sweep(op_k))
    del bell, op_k, op_p
    torch.cuda.empty_cache()
    return dict(launches=launches, steps=meta.n_iter, sigma=S.tolist(), plain_rel_diff=d_plain,
                sweep_ms=ms["sweep"], rmatvec_ms=ms["rmatvec"], rmatvec_share=share, profile=prof)


def svds_kexpm(dev, tag):
    """Phase 21: the svds half of the flagship stage svds_kexpm
    (flagship_tpu.py:278-325), on the plain operator and through bell_spmv."""
    m = 48
    cd = lt.ConvectionDiffusion2D(m, dtype=torch.float32, device=dev)
    A = cd.dense().numpy()
    s_ref = np.linalg.svd(A, compute_uv=False)[:4]
    opts = lt.SVDSOptions(maxiter=40)
    out = {}
    t0 = time.perf_counter()
    U, S, V, res, info, meta = lt.svds(cd, 4, u0=torch.ones((m, m), device=dev), kdim=30,
                                       tolerance=5e-3, options=opts)
    t_solve = time.perf_counter() - t0
    err = float(np.abs(S - s_ref).max() / np.abs(s_ref).max())
    print(f"{tag} svds_kexpm: svds(ConvectionDiffusion2D({m}) f32, 4, kdim=30, tol=5e-3): "
          f"info={info}, {meta.n_iter} steps, {t_solve:.3f} s; sigma {S} against the dense "
          f"SVD rel err {err:.2e}")
    check(info > 0, f"svds_kexpm reported non-convergence: info={info}")
    check(err < 1e-3, f"svds_kexpm sigma rel err {err:.2e}")
    out["plain"] = dict(info=info, steps=meta.n_iter, sigma_rel_err=err, solve_s=t_solve)
    op_b = lt.BellOperator(lt.bell_from_scipy(A, dtype=np.float32, device=dev))
    lt.bell_spmv.LAUNCHES = 0
    t0 = time.perf_counter()
    U, S, V, res, info, meta = lt.svds(op_b, 4, u0=torch.ones(m * m, device=dev), kdim=30,
                                       tolerance=5e-3, options=opts)
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    launches = lt.bell_spmv.LAUNCHES
    err = float(np.abs(S - s_ref).max() / np.abs(s_ref).max())
    print(f"{tag} svds_convdiff through bell_spmv: info={info}, {meta.n_iter} steps, "
          f"{launches} bell_spmv launches, {t_solve:.3f} s; sigma rel err {err:.2e}")
    check(info > 0 and err < 1e-3, f"svds through Block-ELL: info={info}, rel err {err:.2e}")
    check(launches == meta.n_iter, f"{launches} bell_spmv launches for {meta.n_iter} steps")
    out["bell"] = dict(info=info, steps=meta.n_iter, launches=launches, sigma_rel_err=err,
                       solve_s=t_solve)
    return out


def cuda_kernels(fn):
    """The CUDA kernel events of one call of ``fn``, by torch.profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def profile_row(tag, label, fn):
    """One call of ``fn`` timed with CUDA events after a warm-up, then one
    profiled call: its kernels, their device time and its share of the wall
    time, and the three kernel names that take the most device time."""
    wall = median_ms(lambda i: fn(), runs=1)
    kernels = cuda_kernels(fn)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    print(f"{tag} profile {label}: wall {wall:.2f} ms, {len(kernels)} kernels, device busy "
          f"{busy:.2f} ms ({100 * busy / wall:.0f}%); top: "
          + "; ".join(f"{name[:60]} {ms:.2f} ms" for name, ms in top))
    return dict(wall_ms=wall, kernels=len(kernels), busy_ms=busy,
                top=[[name, ms] for name, ms in top])


def roessler_upo(dev, tag):
    """Phase 22: the flagship stage roessler_upo (flagship_tpu.py:197-215)
    in f32 on the card, at UPO_STEPS RK4 steps a period."""
    n = UPO_STEPS
    sys_ = lt.upo_system(n_steps=n)
    X0 = {"pos": torch.tensor([0.0, 6.1, 1.3], device=dev), "T": torch.tensor(6.0, device=dev)}
    lt.timer.reset_counters()
    t0 = time.perf_counter()
    X, info, meta = lt.newton(sys_, X0, rtol=0.0, atol=3e-5,
                              options=lt.NewtonOptions(maxiter=60),
                              linear_solver_options=lt.GMRESOptions(kdim=4, maxiter=10))
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    jac_mv = sum(lt.timer.get_counter(f"UPOJacobian{s}.matvec")
                 for s in [""] + [f"#{i}" for i in range(1, 4 * meta.n_iter + 4)])
    T = float(X["T"])
    closure = float(torch.linalg.norm(lt.flow(X["pos"], X["T"], n) - X["pos"]))
    print(f"{tag} roessler_upo f32, {n} RK4 steps a period (cut from the flagship's "
          f"{UPO_STEPS_FLAGSHIP}): info={info}, T={T:.6f} (ref 5.88108845, |dT| "
          f"{abs(T - 5.88108845):.2e}), closure {closure:.2e}, {meta.n_iter} Newton iterations, "
          f"{meta.n_evals} evaluations, {jac_mv} Jacobian matvecs (jvp through the flow); "
          f"{t_solve:.3f} s")
    flow_prof = profile_row(tag, f"one UPO flow ({n} RK4 steps, f32)",
                            lambda: lt.flow(X["pos"], X["T"], n))
    # a Jacobian matvec is n steps of the tangent: count its kernels over 10
    J = lt.UPOJacobian(X, 10)
    per_jvp = len(cuda_kernels(lambda: J.matvec(X))) / 10 * n
    print(f"roessler_upo: {flow_prof['kernels']} kernels a flow, {per_jvp:.0f} a Jacobian "
          "matvec (counted over 10 steps)")
    per_flow = flow_prof["kernels"]
    check(meta.converged and info > 0, f"UPO Newton did not converge: info={info}")
    check(abs(T - 5.88108845) < 5e-3, f"UPO period {T} off the anchor")
    return dict(info=info, T=T, T_err=abs(T - 5.88108845), closure=closure, n_iter=meta.n_iter,
                n_evals=meta.n_evals, jacobian_matvecs=jac_mv, kernels_per_flow=per_flow,
                kernels_per_jacobian_matvec=per_jvp, solve_s=t_solve, rk4_steps=n,
                flow_profile=flow_prof)


def roessler_otd(dev, tag):
    """Phase 23: the flagship stage roessler_otd (flagship_tpu.py:362-381)
    in f32 on the card, OTD_STEPS RK4 steps over T = 50."""
    fp_minus, _ = lt.roessler_fixed_points()
    U0 = np.linalg.qr(np.random.default_rng(19).standard_normal((3, 2)))[0]
    t0 = time.perf_counter()
    x, U, Lr, lyap = lt.otd_evolve(lt.roessler_rhs,
                                   torch.tensor(fp_minus, dtype=torch.float32, device=dev),
                                   torch.tensor(U0, dtype=torch.float32, device=dev), 50.0,
                                   OTD_STEPS)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    w = np.sort(np.linalg.eigvals(Lr.cpu().numpy()).real)
    dev_ = float(np.abs(w - 0.097000856).max())
    print(f"{tag} roessler_otd f32, T=50 in {OTD_STEPS} RK4 steps (cut from the flagship's "
          f"{OTD_STEPS_FLAGSHIP}): eigenvalue real parts {w} (anchor 0.097000856, dev "
          f"{dev_:.2e}); {t_run:.3f} s, {t_run / OTD_STEPS * 1e3:.2f} ms a step")
    check(np.all(np.isfinite(w)) and dev_ < 1e-5, f"OTD eigenvalues off the anchor by {dev_:.2e}")
    return dict(eig_real=w.tolist(), anchor_dev=dev_, run_s=t_run, steps=OTD_STEPS)


class _Interrupted(Exception):
    pass


def interrupting(op, calls):
    """``op`` whose ``calls + 1``-th application (matvec or rmatvec)
    raises, as an interrupted run would stop."""
    count = [0]

    def tick():
        count[0] += 1
        if count[0] > calls:
            raise _Interrupted()

    def matvec(x):
        tick()
        return op.matvec(x)

    def rmatvec(y):
        tick()
        return op.rmatvec(y)

    return lt.MatvecOperator(matvec, rmatvec, is_hermitian=op.is_hermitian)


def checkpoint_resume(dev, tag):
    """Phase 24: an svds and an eigs on CudaPoisson2D f32 stopped in their
    second cycle and resumed from the checkpoint of their first restart."""
    n, kdim, cycles = 256, 20, 4
    op = lt.CudaPoisson2D(n, dtype=torch.float32, device=dev)
    x0 = seeded((n, n), torch.float32, dev, seed=20)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, solve, opts_cls, per_step in (
                ("svds", lambda A, o, **kw: lt.svds(A, 4, u0=x0, kdim=kdim, tolerance=1e-30,
                                                     options=o, **kw), lt.SVDSOptions, 2),
                ("eigs", lambda A, o, **kw: lt.eigs(A, 4, x0=x0, kdim=kdim, tolerance=1e-30,
                                                     options=o, **kw), lt.EigsOptions, 1)):
            path = str(Path(tmp) / f"{name}.npz")
            full = solve(op, opts_cls(maxiter=cycles))
            try:
                solve(interrupting(op, per_step * (kdim + 3)),
                      opts_cls(maxiter=cycles, checkpoint_every=1, checkpoint_path=path))
                fail(f"{name} was not interrupted")
            except _Interrupted:
                pass
            resumed = solve(op, opts_cls(maxiter=cycles), resume_from=path)
            vals = 1 if name == "svds" else 0
            meta = 5 if name == "svds" else 4
            d = float(np.abs(resumed[vals] - full[vals]).max() / np.abs(full[vals]).max())
            print(f"{tag} checkpoint/resume {name}: CudaPoisson2D({n}) f32, kdim={kdim}, "
                  f"{cycles} cycles, interrupted in cycle 2; resumed {resumed[meta].n_iter} steps "
                  f"vs {full[meta].n_iter} uninterrupted, max rel diff {d:.2e}")
            check(resumed[meta].n_iter == full[meta].n_iter and d <= 1e-6,
                  f"resumed {name} differs from the uninterrupted run by {d:.2e}")
            out[name] = dict(steps=full[meta].n_iter, rel_diff=d)
    return out


# -- 28-30: the batched kernels and block eigs -------------------------------------

def batched_stencil(dev, tag):
    """Phase 28: stencil_matvec_batched against its plain version, then
    timed cold at 3072^2, p = 2, against two single launches and cuDNN."""
    out = {"parity": []}
    main_err = None
    shapes = STENCIL_SHAPES + [(N_SHARDED, N_SHARDED)]
    for dtype in (torch.float32, torch.float64):
        for shape in shapes:
            for p in BATCH_PS:
                u = seeded((p,) + shape, dtype, dev, seed=p)
                args = stencil_args(u[0])
                before = (lt.stencil_matvec.LAUNCHES, lt.stencil_matvec_batched.LAUNCHES)
                got = lt.stencil_matvec_batched(u, **args)
                torch.cuda.synchronize()
                check((lt.stencil_matvec.LAUNCHES, lt.stencil_matvec_batched.LAUNCHES)
                      == (before[0], before[1] + 1), "stencil_matvec_batched did not count its launch")
                want = stencil_matvec_reference(u, **args)
                rel, abs_err = rel_err(got, want), float((got - want).abs().max())
                check(rel <= REL_TOL[dtype], f"batched stencil {shape} p={p} {dtype}: rel err "
                      f"{rel:.3e} > {REL_TOL[dtype]}")
                out["parity"].append(dict(shape=shape, p=p, dtype=str(dtype), rel_err=rel,
                                          max_abs_err=abs_err))
                if shape == (N_MAIN, N_MAIN) and p == 2 and dtype == torch.float32:
                    main_err = abs_err
                del u, got, want
            print(f"batched stencil parity {shape} {dtype}, p {BATCH_PS}: rel "
                  + ", ".join(f"{r['rel_err']:.3e}" for r in out["parity"][-len(BATCH_PS):]))
    torch.cuda.empty_cache()
    n, p = N_MAIN, 2
    nbytes = 8 * p * n * n
    nbuf = max(1, -(-4 * L2_BYTES // nbytes))
    stacks = [seeded((p, n, n), torch.float32, dev, seed=30 + s) for s in range(nbuf)]
    args = stencil_args(stacks[0][0])
    w = torch.tensor([[0.0, -args["ihy2"], 0.0],
                      [-args["ihx2"], 2.0 * (args["ihx2"] + args["ihy2"]), -args["ihx2"]],
                      [0.0, -args["ihy2"], 0.0]], device=dev)[None, None]
    conv = lambda u: torch.nn.functional.conv2d(u[:, None], w, padding=1)[:, 0]  # noqa: E731
    rel = rel_err(conv(stacks[0]), stencil_matvec_reference(stacks[0], **args))
    check(rel <= REL_TOL[torch.float32], f"conv2d batch-2 stencil rel err {rel:.3e}")
    fns = {"batched": lambda u: lt.stencil_matvec_batched(u, **args),
           "two_single": lambda u: [lt.stencil_matvec(u[i], **args) for i in range(p)],
           "plain": lambda u: stencil_matvec_reference(u, **args),
           "conv2d": conv}
    ms = {name: median_ms(lambda i: fn(stacks[i % nbuf]), per_run=nbuf * 2)
          for name, fn in fns.items()}
    bound = bound_ms(nbytes)
    print(f"{tag} batched stencil {p}x{n}x{n} f32 cold ({nbuf} stacks rotated): one batched "
          f"launch {ms['batched'] * 1e3:.1f} us, two single launches {ms['two_single'] * 1e3:.1f} us, "
          f"plain {ms['plain'] * 1e3:.1f} us, cuDNN conv2d batch {p} {ms['conv2d'] * 1e3:.1f} us "
          f"(rel err vs plain {rel:.2e}); bound {bound * 1e3:.1f} us (8 B/point, {p} fields, "
          f"3.35 TB/s): batched at {100 * bound / ms['batched']:.0f}% of its bound")
    del stacks
    torch.cuda.empty_cache()
    out.update(ms=ms, bound_ms=bound, conv2d_rel_err=rel, max_abs_err=main_err, p=p, n=n)
    return out


def spiral_matrix(n, seed):
    """A real matrix with a known complex spectrum: 2x2 rotation-scaling
    blocks with geometric radii, orthogonally conjugated
    (tests/test_block_eigs.py:31-49, the probe block_eigs_r5)."""
    rng = np.random.default_rng(seed)
    D = np.zeros((n, n))
    for j in range(n // 2):
        r, th = 2.5 * 0.85 ** j, 0.3 + 2.1 * j
        a, b = r * np.cos(th), r * np.sin(th)
        D[2 * j, 2 * j] = D[2 * j + 1, 2 * j + 1] = a
        D[2 * j, 2 * j + 1], D[2 * j + 1, 2 * j] = b, -b
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return Q @ D @ Q.T


def block_eigs_stencil(dev, tag, eigs_out):
    """Phase 29: probe block_eigs_r5 on the card, then eigs_3072_block."""
    out = {}
    Am = spiral_matrix(R5_N, seed=7)
    w_all = np.linalg.eigvals(Am)
    exact = w_all[np.argsort(-np.abs(w_all))][:R5_NEV]
    op = lt.DenseOperator(torch.from_numpy(Am.astype(np.float32)).to(dev))
    x0 = seeded((R5_N,), torch.float32, dev, seed=31)
    r5 = {}
    for p in (2, 1):
        w, V, r, info, meta = lt.eigs(op, R5_NEV, x0=x0, kdim=R5_KDIM, tolerance=R5_TOL,
                                      blksize=p, options=lt.EigsOptions(maxiter=100))
        d = np.abs(w[:, None] - exact[None, :])
        err = float(max(d.min(0).max(), d.min(1).max()))
        r5[p] = dict(info=info, matvecs=meta.n_iter, err=err)
        print(f"{tag} block_eigs_r5 f32, blksize {p}: info={info}, {meta.n_iter} matvecs, max "
              f"|lambda - exact| = {err:.3e} (the TPU probe: {R5_TPU_ERR[p]:.2e})")
        check(info == R5_NEV, f"block_eigs_r5 blksize {p}: info={info}")
    check(r5[2]["err"] <= 10 * max(r5[1]["err"], 1e-7),
          f"block_eigs_r5: blksize 2 error {r5[2]['err']:.2e} beyond 10x blksize 1's")
    out["block_eigs_r5"] = r5

    n = N_EIGHS
    op_k = lt.CudaPoisson2D(n, dtype=torch.float32, device=dev)
    op_p = lt.Poisson2D(n, dtype=torch.float32, device=dev)
    x0 = seeded((n, n), torch.float32, dev, seed=7)
    opts = lt.EigsOptions(maxiter=1)

    def sweep(op):
        return lt.eigs(op, 4, x0=x0, kdim=32, tolerance=0.0, blksize=2, options=opts)

    counted_op = lt.timer.matvec_counter(op_k, "eigs_3072_block")
    lt.stencil_matvec.LAUNCHES = lt.stencil_matvec_2d.LAUNCHES = 0
    lt.stencil_matvec_batched.LAUNCHES = 0
    lt.timer.reset_counters()
    w, V, r, info, meta = sweep(counted_op)
    torch.cuda.synchronize()
    launches = dict(batched=lt.stencil_matvec_batched.LAUNCHES,
                    single=lt.stencil_matvec.LAUNCHES + lt.stencil_matvec_2d.LAUNCHES)
    counted = lt.timer.get_counter("eigs_3072_block.matvec")
    host_reads = lt.timer.get_counter("host_reads")
    print(f"eigs_3072_block: {launches['batched']} batched and {launches['single']} single "
          f"stencil launches, matvec_counter {counted} matvecs, {host_reads} host reads for "
          f"{meta.n_iter} matvecs in block steps of 2; Ritz values {w}")
    print(lt.timer.counters_summary())
    check(launches == dict(batched=16, single=0), f"eigs_3072_block launches {launches}")
    check(counted == meta.n_iter == 32, f"matvec_counter counted {counted}, n_iter {meta.n_iter}")
    check(V.shape == (4, n, n) and bool(torch.isfinite(V).all()) and np.all(np.isfinite(w)),
          "eigs_3072_block output not finite")
    del V
    w_p = sweep(op_p)[0]
    lam_max = closed_form_lam_max(n)
    d = float(np.abs(w - w_p).max() / lam_max)
    print(f"eigs_3072_block against the same sweep on the plain Poisson2D: {w_p}; max |dw| / "
          f"lambda_max = {d:.3e}")
    check(d <= 1e-5, f"eigs_3072_block Ritz values differ from the plain sweep by {d:.3e}")
    sweep_ms = alternating_ms({"block": lambda: sweep(op_k)})["block"]
    print(f"{tag} eigs_3072_block sweep (16 block steps of 2, CGS2, host eig) f32: {sweep_ms:.2f} "
          f"ms; phase 15's blksize-1 sweep (32 steps) {eigs_out['sweep_ms']:.2f} ms (median of "
          f"{RUNS} each): ratio {sweep_ms / eigs_out['sweep_ms']:.3f}")
    prof = profile_row(tag, "eigs_3072_block sweep", lambda: sweep(op_k))
    torch.cuda.empty_cache()
    out["eigs_3072_block"] = dict(launches=launches, counted_matvecs=counted, steps=meta.n_iter,
                                  host_reads=host_reads, ritz=[[z.real, z.imag] for z in w],
                                  plain_rel_diff=d, sweep_ms=sweep_ms,
                                  blksize1_sweep_ms=eigs_out["sweep_ms"], profile=prof)
    return out


def batched_bell(dev, tag):
    """Phase 30: bell_spmm against its plain version on the full-size
    matrix, timed, then block eigs f64 on the convection-diffusion operator
    through it."""
    out = {"parity": [], "ms": {}}
    bell = bell_main_matrix(dev)
    csr = bell_csr(bell)
    n = bell.shape[0]
    mat_bytes = (bell.data.numel() + bell.cols.numel()) * 4
    for p in BATCH_PS:
        X = seeded((p, n), torch.float32, dev, seed=40 + p)
        before = (lt.bell_spmv.LAUNCHES, lt.bell_spmm.LAUNCHES)
        got = lt.bell_spmm(bell.data, bell.cols, X)
        torch.cuda.synchronize()
        check((lt.bell_spmv.LAUNCHES, lt.bell_spmm.LAUNCHES) == (before[0], before[1] + 1),
              "bell_spmm did not count its launch")
        want = bell_spmm_reference(bell.data, bell.cols, X)
        rel, abs_err = rel_err(got, want), float((got - want).abs().max())
        check(rel <= BELL_REL_TOL[torch.float32], f"bell_spmm p={p}: rel err {rel:.3e}")
        # the library's forms of the same product: cuSPARSE SpMM on a dense
        # (n, p) operand in row-major and in column-major order (X.T is a
        # column-major view), and p cuSPARSE SpMVs; the fastest is library_ms
        Xt = X.T.contiguous()
        library = {"csr_spmm_row_major": lambda: torch.sparse.mm(csr, Xt).T,
                   "csr_spmm_col_major": lambda: torch.sparse.mm(csr, X.T).T,
                   "csr_spmv_each": lambda: torch.stack([torch.mv(csr, X[i]) for i in range(p)])}
        lib_rel = {k: rel_err(fn(), want) for k, fn in library.items()}
        check(max(lib_rel.values()) <= BELL_REL_TOL[torch.float32],
              f"cuSPARSE forms p={p}: rel errs {lib_rel}")
        ms = alternating_ms({
            "batched": lambda: lt.bell_spmm(bell.data, bell.cols, X),
            "single": lambda: [lt.bell_spmv(bell.data, bell.cols, X[i]) for i in range(p)],
            "plain": lambda: bell_spmm_reference(bell.data, bell.cols, X), **library}, per_run=10)
        best = min(library, key=ms.get)
        bound = bound_ms(mat_bytes + p * 2 * n * 4)
        out["parity"].append(dict(p=p, rel_err=rel, max_abs_err=abs_err, library_rel_err=lib_rel))
        out["ms"][p] = dict(ms, bound_ms=bound, library=best, library_ms=ms[best])
        print(f"bell_spmm parity full size p={p} f32: rel {rel:.3e}, max abs {abs_err:.3e}")
        print(f"{tag} bell_spmm full size p={p} f32: one batched launch {ms['batched'] * 1e3:.1f} "
              f"us, {p} single bell_spmv launches {ms['single'] * 1e3:.1f} us, plain "
              f"{ms['plain'] * 1e3:.1f} us; cuSPARSE SpMM row-major operand "
              f"{ms['csr_spmm_row_major'] * 1e3:.1f} us, column-major "
              f"{ms['csr_spmm_col_major'] * 1e3:.1f} us, {p} SpMVs "
              f"{ms['csr_spmv_each'] * 1e3:.1f} us (fastest: {best}; rel errs "
              f"{', '.join(f'{v:.2e}' for v in lib_rel.values())}); bound {bound * 1e3:.1f} us "
              f"(matrix once, {p} x and y): batched at {100 * bound / ms['batched']:.0f}% of its "
              "bound (10 calls a sample, in turn)")
        del X, Xt, got, want
    del bell, csr
    torch.cuda.empty_cache()

    cd = lt.ConvectionDiffusion2D(64)
    A = cd.dense().numpy()
    op_b = lt.BellOperator(lt.bell_from_scipy(A, dtype=np.float64, device=dev))
    x0 = seeded((64 * 64,), torch.float64, dev, seed=14)
    # the kernel at this path's shape and type: a (2, n_pad) float64 stack
    X = seeded((2, op_b._n_padded()), torch.float64, dev, seed=15)
    got = lt.bell_spmm(op_b.data, op_b.cols, X)
    want = bell_spmm_reference(op_b.data, op_b.cols, X)
    rel, abs_err = rel_err(got, want), float((got - want).abs().max())
    print(f"bell_spmm parity ConvectionDiffusion2D(64) Block-ELL p=2 f64: rel {rel:.3e}, "
          f"max abs {abs_err:.3e}")
    check(rel <= BELL_REL_TOL[torch.float64], f"bell_spmm p=2 f64 convdiff: rel err {rel:.3e}")
    out["parity_convdiff_f64"] = dict(p=2, rel_err=rel, max_abs_err=abs_err)

    def solve(op, x, cycles):
        return lt.eigs(op, 6, x0=x, kdim=48, tolerance=1e-10, blksize=2,
                       generator=torch.Generator().manual_seed(3),
                       options=lt.EigsOptions(maxiter=cycles))

    lt.bell_spmv.LAUNCHES = lt.bell_spmm.LAUNCHES = 0
    w, V, r, info, meta = solve(op_b, x0, 100)
    torch.cuda.synchronize()
    launches = dict(batched=lt.bell_spmm.LAUNCHES, single=lt.bell_spmv.LAUNCHES)
    Vh = V.cpu().numpy()
    res = [float(np.linalg.norm(A @ Vh[i] - w[i] * Vh[i]) / np.linalg.norm(Vh[i]))
           for i in range(len(w))]
    print(f"block eigs f64 ConvectionDiffusion2D(64) through Block-ELL, blksize 2, kdim 48: "
          f"info={info}, {meta.n_iter} matvecs ({launches} launches), eigenvalues "
          f"{np.round(w, 4)}, max true residual / |lambda_1| {max(res) / abs(w[0]):.3e}")
    check(info == 6, f"block non-normal eigs info={info}")
    check(launches == dict(batched=meta.n_iter // 2, single=0),
          f"{launches} launches for {meta.n_iter} matvecs")
    check(max(res) <= 1e-8 * abs(w[0]), "block non-normal eigs true residual above 1e-8 |lambda_1|")
    w6, _, _, _, m6 = solve(op_b, x0, 6)
    w6c, _, _, _, m6c = solve(cd, x0.cpu().reshape(64, 64), 6)
    d_cpu = float(np.abs(w6 - w6c).max() / abs(w6c[0]))
    print(f"the same, 6 restart cycles: Block-ELL {m6.n_iter} matvecs, CPU stencil "
          f"{m6c.n_iter}; max |w - w_cpu| / |lambda_1| = {d_cpu:.3e}")
    check(m6.n_iter == m6c.n_iter and d_cpu <= 1e-8,
          f"block non-normal Ritz values differ from the CPU solve by {d_cpu:.3e}")
    out["eigs_convdiff_block"] = dict(info=info, matvecs=meta.n_iter, launches=launches,
                                      max_true_residual=max(res), cpu_rel_diff_6_cycles=d_cpu)
    return out


# -- 32: the bandwidth probes' kernels and the probe path ---------------------

def counted_call(wrapper, *args):
    """``wrapper(*args)``, synchronised, checked to count one launch."""
    before = wrapper.LAUNCHES
    out = wrapper(*args)
    torch.cuda.synchronize()
    check(wrapper.LAUNCHES == before + 1, f"{wrapper.__name__} did not count its one launch")
    return out


def probe_row(tag, name, label, fns, nbytes, grid, extra):
    """Time ``fns`` (kernel, plain and library) in turn, 10 samples of 10
    calls each, each sample behind a spinning kernel (device time), and print
    and return the case's row; ``nbytes`` is what the kernel must move (its
    bound) and ``grid`` its CTA count."""
    ms = alternating_ms(fns, runs=10, per_run=10, spacer=True)
    ms.setdefault("library", ms["plain"])
    row = {"ms": ms["kernel"], "plain_ms": ms["plain"], "library_ms": ms["library"],
           "bound_ms": bound_ms(nbytes), "grid": grid, "footprint_MB": nbytes / 1e6, **extra}
    rate = nbytes / (ms["kernel"] * 1e-3) / 1e9
    note = ", above the datasheet rate: L2, not device memory" if rate > HBM_BYTES_PER_S / 1e9 else ""
    print(f"{tag} {name} {label} (grid {grid}, {nbytes / 1e6:.1f} MB moved, L2 50 MB): kernel "
          f"{ms['kernel'] * 1e3:.1f} us ({rate:.0f} GB/s{note}), plain {ms['plain'] * 1e3:.1f} us, "
          f"library {ms['library'] * 1e3:.1f} us, bound {row['bound_ms'] * 1e3:.1f} us: kernel at "
          f"{100 * row['bound_ms'] / ms['kernel']:.0f}% of its bound")
    return row


def probe_path(dev, tag):
    """Phase 32: each probe kernel against its plain version at every TPU
    case's shape, timed, then the probe path with its launches counted."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev)
    out = {"copy_tiles": {}, "copy_ring": {}, "reduce_8x128": {}}

    for label, (shape, block, ids) in TILE_CASES.items():
        x = torch.randn(shape, generator=gen.manual_seed(0), device=dev)
        y = counted_call(probe_ops.copy_tiles, x, block)
        err = float((y - probe_ops.copy_reference(x)).abs().max())
        check(torch.equal(y, x), f"copy_tiles {label} is not the copy (max error {err:.3e})")
        out["copy_tiles"][label] = probe_row(
            tag, "copy_tiles", label,
            {"kernel": lambda: probe_ops.copy_tiles(x, block),
             "plain": lambda: probe_ops.copy_reference(x), "library": lambda: y.copy_(x)},
            2 * x.numel() * 4, probe_ops.tiles_geometry(*shape, *block)[2],
            {"replaces": ids, "shape": list(shape), "block": list(block), "max_abs_err": err})
        del x, y

    ring_cases = [(f"depth{d}_rows{r}", (RING_N, RING_N), d, r) for d, r in deep_buffer.cases()]
    ring_cases.append((f"ragged_{RING_RAGGED[0][0]}x{RING_RAGGED[0][1]}_depth{RING_RAGGED[1]}",
                       *RING_RAGGED))
    x = None
    for label, shape, depth, rows in ring_cases:
        if x is None or tuple(x.shape) != shape:
            x = torch.randn(shape, generator=gen.manual_seed(0), device=dev)
        stage = deep_buffer.ring_stage(rows)
        y = counted_call(probe_ops.copy_ring, x, depth, stage)
        err = float((y - probe_ops.copy_reference(x)).abs().max())
        check(torch.equal(y, x), f"copy_ring {label} is not the copy (max error {err:.3e})")
        out["copy_ring"][label] = probe_row(
            tag, "copy_ring", f"{label} (stage {stage} B, ring {depth * stage} B)",
            {"kernel": lambda: probe_ops.copy_ring(x, depth, stage),
             "plain": lambda: probe_ops.copy_reference(x), "library": lambda: y.copy_(x)},
            2 * x.numel() * 4, probe_ops.ring_geometry(x.numel() * 4, stage, sms)[1],
            {"replaces": ["P4", "P5"] if depth == 2 else ["P5"], "shape": list(shape),
             "depth": depth, "tpu_rows": rows, "stage_bytes": stage, "max_abs_err": err})
        del y
    del x

    small = torch.randn((64, 1024), generator=gen.manual_seed(0), device=dev)
    host = host_us({"copy_tiles": lambda: probe_ops.copy_tiles(small, (8, 1024)),
                    "copy_ring": lambda: probe_ops.copy_ring(small, 2, 12288),
                    "reduce_8x128": lambda: probe_ops.reduce_8x128(small),
                    "clone": lambda: small.clone(),
                    "reshape_sum": lambda: probe_ops.reduce_8x128_reference(small)})
    print(f"{tag} host us a call, 50 in a row on a 64 x 1024 array: " + ", ".join(
        f"{name} {v['throughput_us']:.1f}" for name, v in host.items()))

    for shape in REDUCE_SHAPES:
        label = f"{shape[0]}x{shape[1]}"
        x = torch.randn(shape, generator=gen.manual_seed(0), device=dev)
        got = counted_call(probe_ops.reduce_8x128, x)
        want = probe_ops.reduce_8x128_reference(x.double())
        scale = probe_ops.reduce_8x128_reference(x.double().abs())
        err = (got.double() - want).abs()
        worst = float((err / scale).max())
        check(worst <= REDUCE_TOL, f"reduce_8x128 {label}: error {worst:.3e} of the entry's sum of |x|")
        again = counted_call(probe_ops.reduce_8x128, x)
        check(torch.equal(got, again), f"reduce_8x128 {label} differs between two runs")
        print(f"reduce_8x128 {label}: max error {float(err.max()):.3e}, {worst:.3e} of the entry's "
              "sum of |x| (f64 plain sum), bit-equal across two runs")
        out["reduce_8x128"][label] = probe_row(
            tag, "reduce_8x128", label,
            {"kernel": lambda: probe_ops.reduce_8x128(x),
             "plain": lambda: probe_ops.reduce_8x128_reference(x)},
            x.numel() * 4 + 8 * 128 * 4, probe_ops.reduce_grid(*shape, sms),
            {"replaces": ["P2"], "shape": list(shape), "max_abs_err": float(err.max()),
             "err_of_abs_sum": worst, "library": "the plain reshape-sum"})
        del x, want, scale, err
    torch.cuda.empty_cache()

    # the probe path: the five modules as a user runs them, launches counted
    wrappers = (probe_ops.copy_tiles, probe_ops.copy_ring, probe_ops.reduce_8x128)
    for w in wrappers:
        w.LAUNCHES = 0
    path = {}
    for mod in (roofline, manual_out, deep_buffer, stencil_sweep, copy_shape):
        t0 = time.perf_counter()
        res = mod.run(dev, **PROBE_LOOP)
        check(res["device_kind"] == torch.cuda.get_device_name(dev), f"{res['probe']} device")
        path[res["probe"]] = res
        print(f"{tag} probe path: {res['probe']} in {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    launches = {w.__name__: w.LAUNCHES for w in wrappers}
    print(f"probe path launches: {launches}")
    for name, n in launches.items():
        check(n > 0, f"the probe path launched {name} no time")
    torch.cuda.empty_cache()

    loop = {"copy_tiles": {}, "copy_ring": {}, "reduce_8x128": {}}
    for case in path["copy_shape"]["cases"]:
        if case["label"] in TILE_CASES:
            loop["copy_tiles"].setdefault(case["label"], {})["P7"] = case["GBs"]
    for case in path["stencil_sweep_8192"]["copy_sweep"]:
        loop["copy_tiles"].setdefault(f"8192x8192_rows{case['rows']}", {})["P6"] = case["GBs"]
    loop["copy_tiles"]["4096x4096_rows128"]["P1"] = path["roofline"]["cuda_copy_GBs"]
    loop["copy_tiles"]["8192x8192_rows64"]["P3"] = path["manual_out"]["managed_GBs"]
    for case in path["deep_buffer"]["cases"]:
        loop["copy_ring"][f"depth{case['depth']}_rows{case['rows']}"] = {"P5": case["GBs"]}
    loop["copy_ring"]["depth2_rows64"]["P4"] = path["manual_out"]["manual_GBs"]
    loop["reduce_8x128"]["4096x4096"] = {"P2": path["roofline"]["cuda_reduce_GBs"],
                                         "P2_with_update_3_streams":
                                         path["roofline"]["cuda_reduce3_GBs"]}
    for name, rows in out.items():
        for label, row in rows.items():
            row["loop_GBs"] = loop[name].get(label)
    print(f"{tag} timing loop GB/s by case: {json.dumps(loop)}")
    print(f"{tag} roofline: copy linearity {path['roofline']['linearity_ratio']:.3f} (expect ~2), "
          f"torch a+1.0 {path['roofline']['torch_stream_GBs']:.0f} GB/s, stencils "
          f"{path['roofline']['torch_stencil_Gnnzs']:.2f} / {path['roofline']['cuda_stencil_Gnnzs']:.2f} "
          f"Gnnz/s (plain / kernel), matmul bf16 {path['roofline']['matmul_bf16_TFLOPs']:.1f} and "
          f"f32 {path['roofline']['matmul_f32_TFLOPs']:.1f} TFLOP/s")
    wall = time.perf_counter() - t_phase
    print(f"{tag} phase 32 wall time: {wall:.1f} s")
    return {"cases": out, "launches": launches, "path": path, "host_us": host, "wall_s": wall}


# -- 25-27: the partitioned path, in spawned rank processes -------------------

def unsharded(fn):
    """``fn()`` with the vector layer's reduction group unset, as a serial
    run computes: the reference for a rank's partitioned run."""
    prev = lt.vectors.set_reduction_group(None)
    try:
        return fn()
    finally:
        lt.vectors.set_reduction_group(prev)


def counted(fn):
    """``fn()`` after every count is set to 0, then synchronised; returns
    ``(out, counts)``: stencil and Block-ELL launches, the vector layer's
    all-reduces and the operators' collectives."""
    lt.stencil_matvec.LAUNCHES = lt.stencil_matvec_2d.LAUNCHES = lt.bell_spmv.LAUNCHES = 0
    lt.timer.reset_counters()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(stencil=lt.stencil_matvec.LAUNCHES + lt.stencil_matvec_2d.LAUNCHES,
                     bell_spmv=lt.bell_spmv.LAUNCHES,
                     all_reduces=lt.timer.get_counter("all_reduces"),
                     operator_collectives=lt.timer.get_counter("operator_collectives"))


def global_rel(got, want):
    """``|got - want| / |want|`` over the whole partitioned vector."""
    return float(lt.norm(got - want) / lt.norm(want))


def sharded_matvec_vs_plain(op_s, u_loc, u, rows, log):
    """The partitioned stencil matvec through the kernel, counted, against
    the plain partitioned body on the same shard (``kernel="plain"``) and
    against the plain stencil on the whole grid, sliced to this rank's
    rows: the kernel at the shape this rank gives it, held to its plain
    version."""
    op_plain = lt.ShardedPoisson2D(op_s.nx, op_s.ny, mesh=op_s.mesh, dtype=op_s.dtype_,
                                   kernel="plain")
    y, counts = counted(lambda: op_s.matvec(u_loc))
    y_plain = op_plain.matvec(u_loc)
    y_grid = stencil_matvec_reference(u, **stencil_args(u))[rows]
    d_plain, d_grid = global_rel(y, y_plain), global_rel(y, y_grid)
    abs_err = float((y - y_grid).abs().max())
    log(f"  ShardedPoisson2D {op_s.ny}x{op_s.nx} {op_s.dtype_} matvec on a {tuple(u_loc.shape)} "
        f"shard: counts {counts}; rel diff vs the plain partitioned body {d_plain:.3e}, vs the "
        f"plain stencil on the whole grid {d_grid:.3e} (max abs {abs_err:.3e})")
    check(counts["stencil"] == 1 and counts["operator_collectives"] == (op_s.mesh.group is not None),
          f"sharded stencil matvec counts {counts}")
    check(max(d_plain, d_grid) <= REL_TOL[op_s.dtype_],
          f"sharded stencil differs from its plain version by {max(d_plain, d_grid):.3e}")
    return dict(counts, rel_diff_plain=d_plain, rel_diff_grid=d_grid, max_abs_err=abs_err)


def sharded_cycle_vs_serial(op_s, refs, b_loc, b, rows, log):
    """One GMRES(30) cycle on the partitioned operator, counted, and the
    same cycle on each of ``refs`` (unsharded operators, among them the
    plain one) with the group unset."""
    opts = lt.GMRESOptions(kdim=30, maxiter=1)
    (x_s, info_s, meta_s), counts = counted(
        lambda: lt.gmres(op_s, b_loc, rtol=0.0, atol=0.0, options=opts))
    h_s = meta_s.residuals
    check(len(h_s) == 30 and np.all(np.isfinite(h_s)), f"sharded residual history {h_s}")
    log(f"  GMRES(30) cycle: info={info_s}, counts {counts} for {meta_s.n_inner} inner "
        f"iterations; final residual {h_s[-1]:.6e}")
    out = dict(counts, n_inner=meta_s.n_inner, final_residual=float(h_s[-1]), vs={})
    for name, op_u in refs.items():
        x_u, info_u, meta_u = unsharded(
            lambda: lt.gmres(op_u, b, rtol=0.0, atol=0.0, options=opts))
        h_u = meta_u.residuals
        dres = abs(h_s[-1] - h_u[-1]) / h_u[-1]
        dx = global_rel(x_s, x_u[rows])
        log(f"    vs the unsharded cycle on {name}: final residual {h_u[-1]:.6e} (rel {dres:.3e}), "
            f"|x_s - x_u| / |x_u| = {dx:.3e}")
        check(dres <= 1e-3 and dx <= 1e-3, f"the sharded cycle differs from the one on {name}")
        check(info_s == info_u == -30, f"info {info_s} vs {info_u} on {name}")
        out["vs"][name] = dict(final_residual=float(h_u[-1]), residual_rel_diff=dres,
                               x_rel_diff=dx)
    return out


def sharded_sweep_vs_serial(op_s, refs, x_loc, x, lam_max, log):
    """One 32-step eighs sweep on the partitioned operator, counted, and on
    each of ``refs`` with the group unset."""
    opts = lt.EigsOptions(maxiter=1)
    (w_s, *_), counts = counted(
        lambda: lt.eighs(op_s, 4, x0=x_loc, kdim=32, tolerance=0.0, options=opts))
    log(f"  eighs sweep (32 steps): counts {counts}; Ritz values {w_s}")
    check(counts["stencil"] == 32, f"{counts['stencil']} stencil launches in the sweep")
    out = dict(counts, ritz=w_s.tolist(), vs={})
    for name, op_u in refs.items():
        w_u = unsharded(lambda: lt.eighs(op_u, 4, x0=x, kdim=32, tolerance=0.0, options=opts)[0])
        dw = float(np.abs(w_s - w_u).max() / lam_max)
        log(f"    vs the unsharded sweep on {name}: {w_u}, max |dw| / lambda_max = {dw:.3e}")
        check(dw <= 1e-5, f"sharded Ritz values differ from {name}'s by {dw:.3e} of lambda_max")
        out["vs"][name] = dw
    return out


def bell_sharded_vs_serial(mesh, bell, log):
    """ShardedBellOperator over ``bell``: the matvec (the Block-ELL kernel
    on this rank's block-rows over the gathered x) against the kernel's
    plain version on the same block-rows and x, the rmatvec against the
    unsharded operator's, this rank's rows."""
    dev = mesh.device
    n = bell.shape[0]
    rows = lt.shard_rows(mesh, n)
    op_s, op_u = lt.ShardedBellOperator(bell, mesh=mesh), lt.BellOperator(bell)
    x, y = seeded((n,), torch.float32, dev, seed=23), seeded((n,), torch.float32, dev, seed=24)
    y_s, counts = counted(lambda: op_s.matvec(x[rows].contiguous()))
    want = bell_spmv_reference(op_s.data, op_s.cols, x)
    d_mv = rel_err(y_s, want)
    abs_err = float((y_s - want).abs().max())
    d_rmv = global_rel(op_s.rmatvec(y[rows].contiguous()), op_u.rmatvec(y)[rows])
    log(f"  ShardedBellOperator {n}^2 on {tuple(op_s.data.shape)} local blocks: matvec counts "
        f"{counts}, rel diff vs the plain Block-ELL product on the same block-rows {d_mv:.3e} "
        f"(max abs {abs_err:.3e}); rmatvec vs BellOperator {d_rmv:.3e}")
    check(counts["bell_spmv"] == 1 and counts["operator_collectives"] == (mesh.group is not None),
          f"sharded Block-ELL matvec counts {counts}")
    check(d_mv <= BELL_REL_TOL[torch.float32] and d_rmv <= BELL_REL_TOL[torch.float32],
          "ShardedBellOperator differs from its plain version")
    return op_s, op_u, dict(matvec_counts=counts, matvec_rel_diff=d_mv, max_abs_err=abs_err,
                            rmatvec_rel_diff=d_rmv)


def host_us(fns):
    """Host time in us of each of ``fns``: median of 50 calls, each followed
    by a synchronise (latency), and per call over 50 calls in a row with one
    synchronise at the end (throughput)."""
    out = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        lat = []
        for _ in range(50):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        out[name] = dict(latency_us=statistics.median(lat) * 1e6,
                         throughput_us=(time.perf_counter() - t0) / 50 * 1e6)
    return out


def collective_us(mesh, n):
    """Host time of one all-reduce of 64 values, one halo exchange of a row
    of ``n`` and, as the floor, one tiny kernel (:func:`host_us`)."""
    t = torch.ones(64, device=mesh.device)
    block = torch.ones((2, n), device=mesh.device)
    return host_us({"all_reduce": lambda: torch.distributed.all_reduce(t),
                    "halo": lambda: halo_rows(block, mesh), "kernel": lambda: t.mul_(1.0)})


def host_ops(fn):
    """One call of ``fn`` under torch.profiler (host activity): its wall
    time in ms on the host clock, and each operator's self host time in ms
    and call count."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return wall, {e.key: (e.self_cpu_time_total / 1e3, e.count) for e in prof.key_averages()}


def host_split(log, tag, label, fn, base):
    """Where the host time of ``fn`` goes beyond that of ``base``: one
    profiled call of each, the wall times, the self host time inside torch
    operators, and the eight operators whose self time grew most."""
    wall, ops = host_ops(fn)
    wall_b, ops_b = host_ops(base)
    grew = {k: ops[k][0] - ops_b.get(k, (0.0, 0))[0] for k in ops}
    top = sorted(grew.items(), key=lambda kv: -kv[1])[:8]
    in_ops, in_ops_b = (sum(v[0] for v in o.values()) for o in (ops, ops_b))
    log(f"{tag} {label} host split (profiled, host clock): wall {wall:.2f} vs {wall_b:.2f} ms, "
        f"self time in torch operators {in_ops:.2f} vs {in_ops_b:.2f} ms; grew most: "
        + "; ".join(f"{k} +{d:.2f} ms ({ops[k][1]} calls vs {ops_b.get(k, (0.0, 0))[1]})"
                    for k, d in top))
    return dict(wall_ms=wall, base_wall_ms=wall_b, op_ms=in_ops, base_op_ms=in_ops_b,
                grew=[[k, d, ops[k][1], ops_b.get(k, (0.0, 0))[1]] for k, d in top])


def phase25(mesh, log, tag):
    """World size 1 over NCCL: the 10M-DoF partitioned Poisson and the
    full-size Block-ELL matrix."""
    dev, n = mesh.device, N_SHARDED
    out = {"backend": torch.distributed.get_backend(), "world": mesh.size}
    log(f"phase 25: world size {mesh.size} over {out['backend']} on {dev}; "
        f"ShardedPoisson2D({n}) f32, {n * n / 1e6:.2f}M DoF")
    op_s = lt.ShardedPoisson2D(n, mesh=mesh, dtype=torch.float32)
    op_u = lt.CudaPoisson2D(n, dtype=torch.float32, device=dev)
    refs = {"CudaPoisson2D": op_u, "Poisson2D (plain)": lt.Poisson2D(n, dtype=torch.float32,
                                                                      device=dev)}
    rows = lt.shard_rows(mesh, n)
    b = seeded((n, n), torch.float32, dev, seed=21)
    b_loc = lt.distribute(b, mesh)
    out["matvec"] = sharded_matvec_vs_plain(op_s, b_loc, b, rows, log)
    out["gmres"] = sharded_cycle_vs_serial(op_s, refs, b_loc, b, rows, log)
    check(out["gmres"]["stencil"] == 32, f"{out['gmres']['stencil']} stencil launches in the cycle")
    out["eighs"] = sharded_sweep_vs_serial(op_s, refs, b_loc, b, closed_form_lam_max(n), log)
    opts, eopts = lt.GMRESOptions(kdim=30, maxiter=1), lt.EigsOptions(maxiter=1)
    out["ms"] = alternating_ms({
        "sharded_cycle": lambda: lt.gmres(op_s, b_loc, rtol=0.0, atol=0.0, options=opts),
        "unsharded_cycle": lambda: unsharded(
            lambda: lt.gmres(op_u, b, rtol=0.0, atol=0.0, options=opts)),
        "sharded_sweep": lambda: lt.eighs(op_s, 4, x0=b_loc, kdim=32, tolerance=0.0,
                                          options=eopts),
        "unsharded_sweep": lambda: unsharded(
            lambda: lt.eighs(op_u, 4, x0=b, kdim=32, tolerance=0.0, options=eopts))}, runs=10)
    ms = out["ms"]
    log(f"{tag} phase 25 ShardedPoisson2D({n}) f32, world {mesh.size} over {out['backend']}: "
        f"GMRES(30) cycle {ms['sharded_cycle']:.2f} ms (unsharded {ms['unsharded_cycle']:.2f} ms), "
        f"eighs sweep "
        f"{ms['sharded_sweep']:.2f} ms (unsharded {ms['unsharded_sweep']:.2f} ms), median of 10 "
        f"in turn; all-reduces per inner iteration "
        f"{out['gmres']['all_reduces'] / out['gmres']['n_inner']:.3f}, per Lanczos step "
        f"{out['eighs']['all_reduces'] / 32:.3f}")
    out["profile_sharded"] = profile_row(
        tag, "phase 25 sharded GMRES(30) cycle",
        lambda: lt.gmres(op_s, b_loc, rtol=0.0, atol=0.0, options=opts))
    out["profile_unsharded"] = profile_row(
        tag, "phase 25 unsharded GMRES(30) cycle",
        lambda: unsharded(lambda: lt.gmres(op_u, b, rtol=0.0, atol=0.0, options=opts)))
    out["host_split"] = host_split(
        log, tag, "phase 25 GMRES(30) cycle, sharded vs unsharded",
        lambda: lt.gmres(op_s, b_loc, rtol=0.0, atol=0.0, options=opts),
        lambda: unsharded(lambda: lt.gmres(op_u, b, rtol=0.0, atol=0.0, options=opts)))
    out["matvec_us"] = host_us({
        "unsharded": lambda: op_u.matvec(b), "sharded": lambda: op_s.matvec(b_loc),
        "sharded_through_autograd_function": lambda: LinearApply.apply(op_s, False, b_loc)})
    out["collective_us"] = collective_us(mesh, n)
    log(f"{tag} phase 25 one call, host us (latency with a synchronise / throughput): "
        + "; ".join(f"{k} {v['latency_us']:.1f} / {v['throughput_us']:.1f}"
                    for k, v in {**out["matvec_us"], **out["collective_us"]}.items()))
    del b, b_loc, op_u, refs
    torch.cuda.empty_cache()

    bell = bell_main_matrix(dev)
    op_bs, op_bu, out["bell"] = bell_sharded_vs_serial(mesh, bell, log)
    nb = bell.shape[0]
    bb = torch.randn(nb, generator=torch.Generator(device=dev).manual_seed(4), device=dev)
    out["bell_gmres"] = sharded_cycle_vs_serial(
        op_bs, {"BellOperator": op_bu, "the plain Block-ELL product": plain_bell(bell)},
        bb, bb, slice(None), log)
    check(out["bell_gmres"]["bell_spmv"] == 32,
          f"{out['bell_gmres']['bell_spmv']} bell_spmv launches in the cycle")
    out["bell_ms"] = alternating_ms({
        "sharded_cycle": lambda: lt.gmres(op_bs, bb, rtol=0.0, atol=0.0, options=opts),
        "unsharded_cycle": lambda: unsharded(
            lambda: lt.gmres(op_bu, bb, rtol=0.0, atol=0.0, options=opts))}, runs=10)
    log(f"{tag} phase 25 ShardedBellOperator {nb}^2 f32, world {mesh.size} over "
        f"{out['backend']}: GMRES(30) cycle {out['bell_ms']['sharded_cycle']:.2f} ms (unsharded "
        f"{out['bell_ms']['unsharded_cycle']:.2f} ms), median of 10 in turn")
    return out


def phase26(mesh, log, tag):
    """Two ranks on one card over gloo: the 10.5M-DoF grid and the full-size
    Block-ELL matrix, each rank's kernels held to their plain versions at
    its shard's shapes and its solves to the unsharded ones."""
    dev = mesh.device
    ny, nx = WEAK_NY, WEAK_NX
    out = {"backend": torch.distributed.get_backend(), "world": mesh.size}
    log(f"phase 26: rank {mesh.rank} of {mesh.size} over {out['backend']} on {dev}: gloo "
        "through the host on one device, a check of the collectives, not a scaling number")
    rows = lt.shard_rows(mesh, ny)
    op_s = lt.ShardedPoisson2D(nx, ny, mesh=mesh, dtype=torch.float32)
    op_u = lt.CudaPoisson2D(nx, ny, dtype=torch.float32, device=dev)
    refs = {"CudaPoisson2D": op_u,
            "Poisson2D (plain)": lt.Poisson2D(nx, ny, dtype=torch.float32, device=dev)}
    u = seeded((ny, nx), torch.float32, dev, seed=22)
    u_loc = lt.distribute(u, mesh)
    out["matvec"] = sharded_matvec_vs_plain(op_s, u_loc, u, rows, log)

    g = torch.Generator(device=dev).manual_seed(25)
    X = lt.distribute(torch.randn((4, ny, nx), generator=g, device=dev), mesh, dim=1)
    from lightkrylov_tpu_torch.krylov.gram_schmidt import orthogonalize_against_basis
    _, cgs = counted(lambda: orthogonalize_against_basis(u_loc, X))
    check(cgs["all_reduces"] == 1, f"a CGS pass made {cgs['all_reduces']} all-reduces")
    out["cgs_pass_all_reduces"] = cgs["all_reduces"]
    del X

    out["gmres"] = sharded_cycle_vs_serial(op_s, refs, u_loc, u, rows, log)
    check(out["gmres"]["stencil"] == 32, f"{out['gmres']['stencil']} stencil launches in the cycle")
    lam_max = sum(2.0 * (m + 1) ** 2 * (1.0 - np.cos(np.pi * m / (m + 1))) for m in (nx, ny))
    out["eighs"] = sharded_sweep_vs_serial(op_s, refs, u_loc, u, lam_max, log)
    opts = lt.GMRESOptions(kdim=30, maxiter=1)
    out["cycle_ms"] = alternating_ms({"sharded_cycle": lambda: lt.gmres(
        op_s, u_loc, rtol=0.0, atol=0.0, options=opts)}, runs=5)["sharded_cycle"]
    log(f"{tag} phase 26 rank {mesh.rank}: GMRES(30) cycle {out['cycle_ms']:.2f} ms (median of 5; "
        "both ranks share the card, gloo stages every reduction through the host)")
    out["collective_us"] = collective_us(mesh, nx)
    log(f"{tag} phase 26 rank {mesh.rank} one collective over gloo, host us (latency / "
        "throughput): " + "; ".join(f"{k} {v['latency_us']:.1f} / {v['throughput_us']:.1f}"
                                    for k, v in out["collective_us"].items()))
    del u, u_loc, op_u, refs
    torch.cuda.empty_cache()

    bell = bell_main_matrix(dev)
    op_bs, _, out["bell"] = bell_sharded_vs_serial(mesh, bell, log)
    del bell, op_bs
    torch.cuda.empty_cache()
    return out


def phase27(mesh, log, tag):
    """Small gates on the two ranks: eigs with a restart on the sharded GL
    operator, svds, Newton-Krylov, and a resumed eighs."""
    dev = mesh.device
    out = {}
    gl = lt.ShardedGinzburgLandau(128, mesh=mesh, dtype=torch.complex128)
    exact = np.linalg.eigvals(lt.GinzburgLandau(128, dtype=torch.complex128, device="cpu").dense())
    w, V, r, info, meta = lt.eigs(gl, 3, x0=gl.template() + (1.0 + 0.5j), kdim=10, tolerance=1e-9)
    err = max(float(np.min(np.abs(lam - exact))) for lam in w)
    log(f"  eigs ShardedGinzburgLandau(128) c128, kdim 10: info={info}, {meta.n_iter} matvecs, "
        f"max distance to the dense spectrum {err:.2e}")
    check(info > 0 and meta.n_iter > 10 and err < 1e-7, "sharded GL eigs")
    out["gl_eigs"] = dict(info=info, matvecs=meta.n_iter, err=err)

    op = lt.ShardedPoisson2D(16, 32, mesh=mesh, dtype=torch.float64)
    exact = np.sort(lt.poisson2d_eigvals(16, 32))[::-1]
    u0 = lt.distribute(seeded((32, 16), torch.float64, dev, seed=26), mesh)
    U, S, V, res, info, meta = lt.svds(op, 3, u0=u0, kdim=96, tolerance=1e-10)
    err = float(np.abs(S / exact[:3] - 1).max())
    log(f"  svds sharded Poisson 16x32 f64: info={info}, sigma rel err {err:.2e}")
    check(info > 0 and err < 1e-7, "sharded svds")
    out["svds"] = dict(info=info, rel_err=err)

    u_star = lt.distribute(seeded((32, 16), torch.float64, dev, seed=27), mesh)
    f = op.matvec(u_star) + u_star**3
    X, info, meta = lt.newton(lt.System(lambda v: op.matvec(v) + v**3 - f), op.template(),
                              rtol=0.0, atol=1e-10)
    err = float(lt.norm(X - u_star))
    log(f"  newton on -Lap(u) + u^3 = f, sharded 16x32 f64: info={info}, |X - u*| = {err:.2e}")
    check(info > 0 and err < 1e-6, "sharded Newton-Krylov")
    out["newton"] = dict(info=info, err=err)

    with tempfile.TemporaryDirectory() as tmp:
        # one directory for both ranks: rank 0's name, sent to rank 1
        names = [None] * mesh.size
        torch.distributed.all_gather_object(names, tmp)
        path = str(Path(names[0]) / "eighs.npz")
        x0 = lt.distribute(seeded((32, 16), torch.float64, dev, seed=28), mesh)
        kw = dict(kdim=24, tolerance=1e-9)
        full = lt.eighs(op, 4, x0=x0, options=lt.EigsOptions(maxiter=80), **kw)
        lt.eighs(op, 4, x0=x0, options=lt.EigsOptions(maxiter=2, checkpoint_every=1,
                                                      checkpoint_path=path), **kw)
        resumed = lt.eighs(op, 4, x0=x0, options=lt.EigsOptions(maxiter=80), resume_from=path,
                           **kw)
        torch.distributed.barrier()
    same = bool(np.array_equal(full[0], resumed[0])) and resumed[4].n_iter == full[4].n_iter
    log(f"  eighs checkpoint/resume on {mesh.size} ranks: {full[4].n_iter} steps uninterrupted, "
        f"{resumed[4].n_iter} resumed, Ritz values equal bit for bit: {same}")
    check(same and full[4].converged,
          "the resumed sharded eighs differs from the uninterrupted run")
    out["resume"] = dict(steps=full[4].n_iter, bit_identical=same)
    return out


def phase31(mesh, log, tag):
    """The sharded checkpoint backend: an eighs checkpointed to a .npz file
    and to a torch.distributed.checkpoint directory, resumed from each."""
    dev = mesh.device
    op = lt.ShardedPoisson2D(16, 32, mesh=mesh, dtype=torch.float64)
    x0 = lt.distribute(seeded((32, 16), torch.float64, dev, seed=28), mesh)
    kw = dict(kdim=24, tolerance=1e-9)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        names = [None] * mesh.size
        torch.distributed.all_gather_object(names, tmp)
        paths = {"npz": str(Path(names[0]) / "eighs.npz"),
                 "dcp": str(Path(names[0]) / "eighs_dcp") + "/"}
        full = lt.eighs(op, 4, x0=x0, options=lt.EigsOptions(maxiter=80), **kw)
        for name, path in paths.items():
            lt.eighs(op, 4, x0=x0, options=lt.EigsOptions(maxiter=2, checkpoint_every=1,
                                                          checkpoint_path=path), **kw)
        torch.distributed.barrier()
        files = {f.name: f.stat().st_size for f in Path(paths["dcp"]).iterdir()}
        for name, path in paths.items():
            w, V, r, info, meta = lt.eighs(op, 4, x0=x0, options=lt.EigsOptions(maxiter=80),
                                           resume_from=path, **kw)
            out[name] = dict(steps=meta.n_iter, ritz=w, V=V)
        torch.distributed.barrier()
    same = all(np.array_equal(out[k]["ritz"], full[0]) and out[k]["steps"] == full[4].n_iter
               for k in paths)
    same_v = bool(torch.equal(out["npz"]["V"], out["dcp"]["V"]))
    log(f"  phase 31, rank {mesh.rank} of {mesh.size} over {torch.distributed.get_backend()}: "
        f"eighs {full[4].n_iter} steps uninterrupted; resumed from .npz {out['npz']['steps']}, "
        f"from DCP {out['dcp']['steps']}; Ritz values equal bit for bit: {same}, Ritz vectors "
        f"of the two resumes equal: {same_v}; DCP files {files}")
    check(same and same_v and full[4].converged,
          "a resumed eighs differs from the uninterrupted run or the other resume")
    return dict(steps=full[4].n_iter, bit_identical=same and same_v, dcp_files=files)


PARTITIONED_PHASES = {"25": (phase25, phase31), "26": (phase26, phase27, phase31)}


def rank_main(phases, rank, world, backend, store, tag, q):
    """A rank process: join the group, run its phases, put its log lines
    and results, or the traceback of a failure."""
    lines = []
    try:
        lt.comm_setup(backend, init_method=f"file://{store}", world_size=world, rank=rank,
                      timeout=120, device="cuda")
        mesh = lt.make_mesh()
        out = {fn.__name__: fn(mesh, lines.append, tag) for fn in PARTITIONED_PHASES[phases]}
        lt.comm_close()
        q.put((rank, lines, out, None))
    except BaseException:  # noqa: BLE001 - the parent fails the script on any of it
        q.put((rank, lines, None, traceback.format_exc()))


def run_ranks(phases, world, backend, tag):
    """Spawn ``world`` rank processes for ``phases``; print their lines in
    rank order; fail on a failure, a missing rank or a timeout."""
    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=rank_main,
                             args=(phases, r, world, backend, str(Path(tmp) / "store"), tag, q))
                 for r in range(world)]
        for p in procs:
            p.start()
        got = {}
        try:
            for _ in range(world):
                rank, lines, out, err = q.get(timeout=RANK_TIMEOUT_S)
                got[rank] = (lines, out, err)
        except queue.Empty:
            pass
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    for rank in sorted(got):
        lines, out, err = got[rank]
        for line in lines:
            print(f"[rank {rank}] {line}")
        check(err is None, f"phases {phases}, rank {rank} failed:\n{err}")
    check(sorted(got) == list(range(world)),
          f"phases {phases}: ranks {sorted(got)} of {world} reported within {RANK_TIMEOUT_S} s")
    check(all(p.exitcode == 0 for p in procs), f"phases {phases}: exit codes "
          f"{[p.exitcode for p in procs]}")
    return [got[r][1] for r in range(world)]


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

    # 13-17. the Arnoldi family: gl512, complex GL, eigs_3072, non-normal
    # eigs through Block-ELL, kexpm
    results["gl512"] = gl512(dev, tag)
    results["gl512_complex"] = gl512_complex(dev, tag)
    results["eigs_3072"] = eigs_3072(dev, tag, results["eighs_3072"])
    results["eigs_nonnormal"] = eigs_nonnormal(dev)
    results["kexpm"] = kexpm_phase(dev)

    # 18-24. library yardsticks, svds through both kernels, the Roessler
    # stages, checkpoint/resume
    results["yardsticks"] = yardsticks(dev, tag)
    results["svds_3072"] = svds_3072(dev, tag, results["eighs_3072"])
    results["svds_bell"] = svds_bell(dev, tag)
    results["svds_kexpm"] = svds_kexpm(dev, tag)
    results["roessler_upo"] = roessler_upo(dev, tag)
    results["roessler_otd"] = roessler_otd(dev, tag)
    results["checkpoint"] = checkpoint_resume(dev, tag)

    # 28-30. the batched kernels and block eigs through them
    results["batched_stencil"] = batched_stencil(dev, tag)
    results["block_eigs"] = block_eigs_stencil(dev, tag, results["eigs_3072"])
    results["batched_bell"] = batched_bell(dev, tag)

    # 25-27 and 31. the partitioned path: world size 1 over NCCL, then two
    # ranks on the one card over gloo; each ends with phase 31
    torch.cuda.empty_cache()
    rank25 = run_ranks("25", 1, "nccl", tag)[0]
    results["phase25"] = rank25["phase25"]
    results["phase26"] = run_ranks("26", 2, "gloo", tag)
    results["phase31"] = {"world1_nccl": rank25["phase31"],
                          "two_gloo_ranks": [r["phase31"] for r in results["phase26"]]}

    # 32. the bandwidth probes' kernels and the probe path
    results["probes"] = probe_path(dev, tag)

    stencil_main = results["times"][f"stencil_{N_MAIN}"]
    bell_main = results["bell_main_path"]
    yard = results["yardsticks"]
    bst, beig, bbell = results["batched_stencil"], results["block_eigs"], results["batched_bell"]
    kernels = {"kernels": [{
        "name": "stencil",
        "route": "cuda",
        "source": "lightkrylov_tpu_torch/csrc/stencil.cu",
        "replaces": "lightkrylov_tpu/ops/pallas/stencil.py:167",
        "also_replaces": "lightkrylov_tpu/ops/pallas/stencil.py:361",
        "launches": main_launches,
        "path_launches": {"gmres_3072": main_launches,
                          "eighs_3072": results["eighs_3072"]["launches"],
                          "eigs_3072": results["eigs_3072"]["launches"],
                          "kexpm_3072": results["kexpm"]["launches"],
                          "svds_3072": results["svds_3072"]["launches"],
                          "sharded_gmres_3162": results["phase25"]["gmres"]["stencil"],
                          "sharded_eighs_3162": results["phase25"]["eighs"]["stencil"],
                          "sharded_2rank_matvec_per_rank": [
                              r["phase26"]["matvec"]["stencil"] for r in results["phase26"]],
                          "sharded_2rank_gmres_per_rank": [
                              r["phase26"]["gmres"]["stencil"] for r in results["phase26"]]},
        "max_abs_err": main_err,
        "sharded_max_abs_err": {
            "sharded_3162_world1": results["phase25"]["matvec"]["max_abs_err"],
            "sharded_2rank_per_rank": [r["phase26"]["matvec"]["max_abs_err"]
                                       for r in results["phase26"]]},
        "ms": stencil_main["kernel_cold_ms"],
        "plain_ms": stencil_main["plain_cold_ms"],
        "bound_ms": yard[f"stencil_{N_MAIN}"]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": yard[f"stencil_{N_MAIN}"]["conv2d_cold_ms"],
        "batched": {
            "entry": "stencil_matvec_batched",
            "launches": {"eigs_3072_block": beig["eigs_3072_block"]["launches"]["batched"]},
            "max_abs_err": bst["max_abs_err"],
            "shape": [bst["p"], bst["n"], bst["n"]],
            "ms": bst["ms"]["batched"],
            "two_single_ms": bst["ms"]["two_single"],
            "plain_ms": bst["ms"]["plain"],
            "bound_ms": bst["bound_ms"],
            "bound_by": "bytes",
            "library_ms": bst["ms"]["conv2d"],
        },
    }, {
        "name": "bell_spmv",
        "route": "cuda",
        "source": "lightkrylov_tpu_torch/csrc/spmv.cu",
        "replaces": "lightkrylov_tpu/ops/pallas/spmv.py:138",
        "launches": bell_main["launches"],
        "path_launches": {"bell_gmres": bell_main["launches"],
                          "eigs_convdiff": results["eigs_nonnormal"]["launches"],
                          "svds_bell": results["svds_bell"]["launches"],
                          "svds_convdiff": results["svds_kexpm"]["bell"]["launches"],
                          "sharded_bell_gmres": results["phase25"]["bell_gmres"]["bell_spmv"],
                          "sharded_2rank_bell_matvec_per_rank": [
                              r["phase26"]["bell"]["matvec_counts"]["bell_spmv"]
                              for r in results["phase26"]]},
        "max_abs_err": bell_err,
        "sharded_max_abs_err": {
            "sharded_world1": results["phase25"]["bell"]["max_abs_err"],
            "sharded_2rank_per_rank": [r["phase26"]["bell"]["max_abs_err"]
                                       for r in results["phase26"]]},
        "ms": bell_main["spmv_ms"]["kernel"],
        "plain_ms": bell_main["spmv_ms"]["plain"],
        "bound_ms": yard["bell_spmv"]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": yard["bell_spmv"]["csr_ms"],
        "batched": {
            "entry": "bell_spmm",
            "launches": {"eigs_convdiff_block": bbell["eigs_convdiff_block"]["launches"]["batched"]},
            "max_abs_err": bbell["parity"][0]["max_abs_err"],
            "p": BATCH_PS[0],
            "ms": bbell["ms"][BATCH_PS[0]]["batched"],
            "single_ms": bbell["ms"][BATCH_PS[0]]["single"],
            "plain_ms": bbell["ms"][BATCH_PS[0]]["plain"],
            "bound_ms": bbell["ms"][BATCH_PS[0]]["bound_ms"],
            "bound_by": "bytes",
            "library_ms": bbell["ms"][BATCH_PS[0]]["library_ms"],
            "library": bbell["ms"][BATCH_PS[0]]["library"],
            "path_max_abs_err": {"eigs_convdiff_block_f64_p2":
                                 bbell["parity_convdiff_f64"]["max_abs_err"]},
            "path_rel_err": {"eigs_convdiff_block_f64_p2": bbell["parity_convdiff_f64"]["rel_err"],
                             "full_size_f32_p2": bbell["parity"][0]["rel_err"]},
            "by_p": {str(p): v for p, v in bbell["ms"].items()},
        },
    }]}
    probes = results["probes"]
    for name in ("copy_tiles", "copy_ring", "reduce_8x128"):
        main_row = probes["cases"][name][PROBE_MAIN[name]]
        kernels["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": "lightkrylov_tpu_torch/csrc/probes.cu",
            "replaces": PROBE_REPLACES[name],
            "launches": probes["launches"][name],
            "max_abs_err": main_row["max_abs_err"],
            "main_case": PROBE_MAIN[name],
            "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": "bytes",
            "library_ms": main_row["library_ms"],
            "by_case": probes["cases"][name],
        })
    print(json.dumps(kernels))
    print(gpu)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
