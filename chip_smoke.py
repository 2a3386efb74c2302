#!/usr/bin/env python3
"""Drive lightkrylov_tpu_torch's main path on one CUDA GPU and check it.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure ends the script with a non-zero exit code:

1. header: the GPU's name and power limit (nvidia-smi), torch, CUDA, nvcc;
2. build the CUDA kernels from csrc/ into a clean _build/, timed, and the
   lagging-warp build of phase 33 (h) beside it in a thread (and, when a
   git archive of the parent commit is unpacked in _parent/, the parent's
   build of phase 33 (g)); print each kernel instance's registers, stack
   frame and spill bytes as ptxas reports them, and fail if the ordschur
   kernel has a stack frame or spills or the Ritz kernel spills;
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
   converted by bell_from_scipy in 8 x 128 blocks; one matvec and
   eighs(nev=4, kdim=32) on both operators, against each other and the
   closed-form spectrum; then the layout fitted on the card: the 3162^2
   convection-diffusion matrix converted with no block shape given, which
   must come out 1 x 1 (ELLPACK) with K = 5, its product through the row
   kernel held to the matrix-free float64 operator within 1e-13 and timed
   beside its byte bound, the plain version and one cuSPARSE CSR product;
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
    3162^2 shard shape, p = 2 and 4, f32 and f64; at 3072^2, p = 2 and 4,
    timed cold against p single stencil launches and cuDNN conv2d with
    batch p, beside its bound;
29. block eigs through it: (a) probe block_eigs_r5, a DenseOperator of the
    64-dim spiral spectrum in f32, kdim 12, tol 5e-5, blksize 2 against 1,
    errors against the exact spectrum (blksize 2 within 10x of blksize 1);
    (b) eigs_3072_block, eigs(nev=4, kdim=32, one sweep, blksize=2) on
    CudaPoisson2D(3072) f32 through matvec_counter, exactly 16 batched and 0
    single stencil launches, 32 counted matvecs, Ritz values against the
    same sweep on the plain Poisson2D, the sweep timed beside phase 15's and
    profiled;
30. the batched Block-ELL kernel (bell_spmm) against its plain version on
    the full-size matrix, p = 2, 4 and 8 (MAX_SPMM_COLUMNS, its widest
    launch), timed against p single bell_spmv launches and cuSPARSE CSR SpMM,
    beside its bound; block eigs f64 at blksize 2 on
    ConvectionDiffusion2D(64) through bell_spmm, by true residual, and after
    6 cycles against the CPU stencil operator;
31. in the rank processes of phases 25 and 26: an eighs on a sharded Poisson
    16 x 32 f64 checkpointed to a .npz file and to a torch.distributed.checkpoint
    directory, each rank writing its own rows, and resumed from each: both
    resumes equal the uninterrupted run bit for bit;
32. the bandwidth probes' kernels (csrc/probes.cu): copy_tiles at every
    TPU copy case's shape and block (P1, P3, P6, P7), at a ragged shape and
    at P7's 1 KB-wide blocks on two more widths (16 and 64 blocks across),
    each row with its unit a CTA; copy_ring at the nine (depth, rows) cases
    of P4/P5 on 8192^2 and at a ragged size with fewer chunks than rings,
    each row with its rings an SM (what the card reports it holds at once,
    at most 8), CTAs, chunks a CTA and bytes in flight an SM, and both ends
    of that geometry (1 and 8 rings an SM) checked to have run; each copy
    bit-equal to the plain copy;
    reduce_8x128 at 4096^2 and 65536 x 1024 within 1e-5 of each entry's sum
    of |x| from the f64 plain sum, and equal to itself across two runs; one
    counted launch a call; each case timed (CUDA events, 10 samples of 10
    calls, kernel, plain and copy_ in turn, each sample queued behind a
    spinning kernel so that the host's launch cost stays out) beside its
    bound, with its grid and footprint, and the wrappers' host time a call
    beside clone's;
    then the probe path, the five lightkrylov_tpu_torch.probes modules with
    a short timing loop, its launches counted; the phase's wall time;
33. the device projected path (csrc/hessenberg.cu): (a) hessenberg_schur
    (embedding, Hessenberg reduction, Francis sweeps, Z, real-block split)
    against its plain version and numpy's eig on seeded Hessenberg matrices
    at n = 3-300 (each change of warp count, 31-33 and 64-65; Z in shared
    memory on both sides of its limit, 119/120 in f64 and 169/170 in f32; H
    on both sides of its, 169/170 in f64 and 239/240 in f32; two rows a
    thread from 257), Arnoldi Hessenbergs at 239-300, the Krylov-Schur
    arrow form, exact conjugate pairs, k_eff < n, a zero diagonal (the
    zero-neighbour safeguard), the cyclic shift (the exceptional shift) and a
    Hessenberg too small to square unscaled, f32 and f64, eigenvalues within
    1e-5 / 1e-11 of ||H||_F, ||Z T Z^T - H|| and ||Z^T Z - I|| within
    1e-5 / 1e-12, and the plain version's sweeps and chase steps exactly (in
    f64 on every input, in f32 on every Hessenberg one);
    francis_filter_sweeps against its plain version on Arnoldi Hessenbergs
    at kdim 16-300 (Z leaving shared memory at 120 / 170, H at 170 / 241,
    f64 / f32), and at kdim 40 scaled by 2^-100 and 2^60 (f32) and
    2^-520 and 2^520 (f64), outside the range, against its plain version
    and the 2^0 run (ROADMAP F14); the plain versions of Hessenberg inputs run on the host, in
    PLAIN_WORKERS spawned processes beside the kernels, those of the dense
    inputs on the card; one hessenberg_ritz check at kdim 40 under
    set_sync_debug_mode("error"); the Ritz kernel (csrc/ritz.cu, ritz_check:
    each eigenvalue's inverse iteration, residual, place in the order and
    the converged count) against its plain version, on the Schur kernel's
    eigenvalues of Arnoldi buffers at kdim 16-321 (each edge of
    ritz_geometry(): the columns a lane of the register path, the slots a
    CTA, the staged block and the working matrices leaving shared memory),
    k_eff < kdim, block bands with p = 2 and 4 (the general path) at kdim
    40-300, the arrow form at 40 and 200 and a triangle with exact
    and near duplicates, a +-lambda tie and exact conjugate pairs, f32 and
    f64: values, order, count and zero rows exactly, eigen-residuals,
    overlaps, norms and residuals within 1e-5 / 1e-11, its plain versions on
    the host workers; checks under set_sync_debug_mode("error") for p = 1
    and 2; the ordschur kernel (csrc/ordschur.cu: the device Krylov-Schur
    restart's Schur reordering) against its plain version on the Schur
    kernel's forms of Arnoldi Hessenbergs at kdim 16-300 (Z leaving shared
    memory at 120 in f64 and 170 in f32, T at 170 and 241), with the median
    selector's mask, a random one and the larger half by real part, f32 and
    f64: sel', ok and the swap count exactly, T' within 1e-5 / 1e-12 of
    ||T||_F and Z' within 1e-5 / 1e-12, its plain versions on the host
    workers; (h) the lagging-warp build of the same
    sources against the shipping kernels, bit for bit, at n = 40 and 257
    (the ordschur kernel on a random mask, the Ritz kernel on an Arnoldi
    buffer and a band too);
    (b) gl512 under projected="device" (the phase's main path, the kernels'
    launches zeroed before and read after): 16/16 inside the kappa budgets,
    no QR host redo, no host restart, matvecs, stride, checks, host reads a
    check, restarts by kind and the warm solve beside phase 13's; (c)
    eigs_3072, (e) eighs_3072 and svds_3072 and (f) eigs_3072_block under
    projected="device" with their launch counts, against phases 15, 10, 19
    and 29b; (d) the non-normal eigs f64 through Block-ELL with IRAM
    restarts, then with a custom selector through the device Schur restart
    (the Schur kernel, the ordschur kernel and the restart's small ops), by
    true residual, with no ordschur host read and one ordschur launch a
    device Schur restart, each beside the same solve on the host path, the
    custom solve's reorder timed by its span, and the custom solve again
    with the plain reorder on the card; (g) a check, each
    kernel alone (the Schur kernel with and without Z) and the plain Schur
    core at kdim 30, 32, 40, 64, 128, f32 and f64, with sweeps, chase steps,
    us a chase step and the bound, beside the host path's read plus numpy
    eig and torch.linalg.eigvals on the card; the kernels alone at kdim 240,
    257 and 300 with their geometry (H and Z in shared or global memory,
    rows a thread); the Ritz kernel alone, its plain version and its bound
    at every kdim of (g), beside torch.linalg.eig on the card; the
    wrappers' host us a call beside clone's, the Schur wrapper's launches
    in one call (its kernel alone) and a check's (the Schur kernel, one
    fill and the Ritz kernel), by torch.profiler; the ordschur kernel alone
    and a call at kdim 30-300 on a random mask, with its swaps, us a swap
    and bound, beside its plain version on the card and the host path's
    reorder (read, LAPACK TRSEN, copy back); and, with the parent's tree
    in _parent/, the Ritz kernel at kdim 30-300 and the ordschur kernel at
    kdim 30-300 in turns with the parent commit's kernels on the same
    inputs (parent, this tree, this tree, parent);
34. the timing layer on the card: phase 15's eigs_3072 sweep with timing
    on, then global_watch.reset_all() (soft), the same sweep again, and
    global_watch.print_summary() through the package logger; every timer of
    the sweep counts the second sweep alone and holds the first's record in
    its history, the summary reaches the logger, and a hard
    reset_all(soft=False) leaves every count 0 and every history empty;
35. CG's fused update (csrc/cg.cu): cg_pdot, cg_xr and cg_p against their
    plain versions at 3162^2 f32 and f64 (1e-6 / 1e-13; the dot against
    ||p|| ||Ap||), each timed cold through a FusedCG bound once to its inputs
    (CUDA events behind a spinning kernel, two input sets rotated, each set
    beyond L2) beside its bound (2, 6 and 3 passes over 3.35 TB/s), its
    plain version and, for cg_pdot, torch.dot; then one CudaPoisson2D(3162)
    f64 solve to rtol 1e-4 through them, its launches and
    cg.fused_iterations counted, beside the same solve by separate vector
    operations;
36. a DCGS2 step as three kernels (csrc/gmres.cu): every step and the
    flush of a GMRES(30) cycle on CudaPoisson2D(3162) in f32 and f64,
    dcgs2_step and dcgs2_flush bound to a copy of the plain state against
    the plain versions (1e-6 / 1e-13 of each output's norm) and bit-equal
    when repeated; the kernel's device time and the wrapper's host us a
    call; the measurement and rank-2 update kernels at step 29 on 3162^2
    fields, f32 and f64, against their plain versions run in float64 on the
    same inputs (each dot against the product of its vectors' norms, the
    written columns against their norms; 1e-6 / 1e-13; the float32 plain
    measurement's own gap printed beside) and bit-equal when repeated, timed cold (two bases beyond
    L2 rotated, CUDA events behind a spinning kernel) beside their byte
    bound (k+2 and k+4 passes over 3.35 TB/s), their plain versions and the
    two library products the port called before them, and in f32 at every
    step of the cycle; the launches of one 3162^2 f32 cycle on each route
    by torch.profiler (a fresh process each); and GMRES(30) cycles through
    the kernels against the separate operations (iterate and residual
    history within 1e-3, the same host reads, 30 fused steps, 30 launches
    of each pass and one flush a cycle), with their times in turns.

The kernel JSON line comes second to last, the GPU line before the last, and
the last line is {"ok": true, "device": {...}}.  Without a CUDA device, or
without the package beside it, the script fails before it prints any result.
"""

import importlib
import importlib.util
import itertools
import json
import logging
import multiprocessing
import queue
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp
import torch
from scipy.optimize import linear_sum_assignment

import lightkrylov_tpu_torch as lt
from lightkrylov_tpu_torch import native
from lightkrylov_tpu_torch.ops import _build
from lightkrylov_tpu_torch.ops import cg as fused_cg
from lightkrylov_tpu_torch.ops import gmres as fused_gmres
from lightkrylov_tpu_torch.ops import hessenberg as hess_ops
from lightkrylov_tpu_torch.ops import probes as probe_ops
from lightkrylov_tpu_torch.ops.spmv import (MAX_SPMM_COLUMNS, bell_spmm_reference,
                                            bell_spmv_reference)
from lightkrylov_tpu_torch.ops.stencil import stencil_matvec_reference
from lightkrylov_tpu_torch.parallel.stencil import LinearApply, halo_rows
from lightkrylov_tpu_torch.probes import (copy_shape, deep_buffer, manual_out, roofline,
                                          stencil_sweep)
from lightkrylov_tpu_torch.utils import hessenberg as hess

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
# the widths the batched kernels are timed at, beside phase 28's parity
# widths BATCH_PS: the batched stencil at p = 2 and 4, bell_spmm (held to its
# plain version at each) up to its widest launch, MAX_SPMM_COLUMNS, which a
# block solve with blksize >= 8 launches
STENCIL_TIME_PS = (2, 4)
BELL_TIME_PS = BATCH_PS + (MAX_SPMM_COLUMNS,)
R5_N, R5_NEV, R5_KDIM, R5_TOL = 64, 4, 12, 5e-5
# phase 33: the device projected path
# the Schur kernel's sizes: the warp counts' edges (31-33, 64-65), Z leaving
# shared memory (120 in f64, 170 in f32), H leaving it (170 in f64, 240 in
# f32), and a thread owning two rows or columns (257, 300); each of the large
# sizes on an Arnoldi Hessenberg too
SCHUR_N = (3, 17, 31, 32, 33, 40, 64, 65, 119, 120, 128, 169, 170, 200, 239, 240, 256, 257, 300)
SCHUR_ARNOLDI_N = (239, 240, 256, 257, 300)
# the filter's kdims: Z leaving shared memory (120 in f64, 170 in f32), H
# leaving it (170 in f64, 241 in f32), two rows a thread (257, 300)
FILTER_KDIMS = (16, 40, 64, 119, 120, 169, 170, 240, 241, 256, 257, 300)
# the lagging-warp build against the shipping one, both kernels, both dtypes
LAG_NS = (40, 257)
# phase 33 (g): the Ritz and ordschur kernels in turns with the parent
# commit's, built from a git archive of it unpacked here (git-ignored);
# without that tree the turns are not run
PARENT_DIR = Path(__file__).resolve().parent / "_parent"
TURN_RITZ_KDIMS = (30, 40, 64, 128, 300)
# phase 2: the kernel functions of each entry of the kernels line, by the
# names ptxas reports them under
KERNEL_FUNCTIONS = {"stencil": ("stencil_kernel", "stencil_batched_kernel"),
                    "bell_spmv": ("bell_spmv_kernel", "bell_spmm_kernel", "bell_rows_kernel"),
                    "copy_tiles": ("copy_tiles_kernel",), "copy_ring": ("copy_ring_kernel",),
                    "reduce_8x128": ("reduce_partials_kernel", "reduce_final_kernel"),
                    "hessenberg_schur": ("schur_kernel",),
                    "francis_filter_sweeps": ("filter_kernel",),
                    "ritz_check": ("ritz_kernel",), "ordschur": ("ordschur_kernel",),
                    "cg": ("cg_pdot_kernel", "cg_xr_kernel", "cg_p_kernel"),
                    "dcgs2_step": ("dcgs2_kernel",),
                    "dcgs2_measure": ("dcgs2_measure_kernel",),
                    "dcgs2_update": ("dcgs2_update_kernel",)}
# the kernels timed beside their bound at sizes where H leaves shared memory
# and a thread owns two rows
LARGE_KDIMS = (240, 257, 300)
# the host processes that run the plain versions of phase 33 (a) beside the
# kernels (on the card the plain chase reads the host once a step: 516 s of
# the phase for the cases above, NVIDIA H100 80GB HBM3, 700 W)
PLAIN_WORKERS = 6
SCHUR_EIG_TOL = {torch.float32: 1e-5, torch.float64: 1e-11}   # of ||H||_F
SCHUR_ORTH_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}  # 2-norms
FILTER_EIG_TOL = {torch.float32: 1e-4, torch.float64: 1e-10}  # of ||H||_F
# the filter's range prescale (ROADMAP F14): the scales 2^e outside
# [sqrt(tiny) / eps, eps / sqrt(tiny)] at which it runs in phase 33 (a)
FILTER_PRESCALE = ((torch.float32, -100), (torch.float32, 60), (torch.float64, -520),
                   (torch.float64, 520))
RITZ_KDIMS = (30, 32, 40, 64, 128)
# phase 33 (a): the Ritz kernel against its plain version on Arnoldi buffers
# at these kdims (its working matrix leaves shared memory at 120 in f64 and
# 170 in f32, a lane owns two rows from 33) and on special buffers
RITZ_GATE_KDIMS = (16, 30, 32, 33, 40, 56, 63, 64, 65, 75, 79, 90, 97, 107, 119, 120, 128, 129,
                   137, 168, 169, 170, 236, 240, 257, 300, 321)
RITZ_TOL = {torch.float32: 1e-5, torch.float64: 1e-11}
# ||Hm v - lambda v|| / ||H||_F in f64; in f32 the method's own residual
# grows with kdim (the JAX package's f32 vectors read 1.3e-5 to 3.5e-5 at
# kdim 16-128), so there the kernel is held to the plain version's within
# RITZ_TOL alone
RITZ_RESID_TOL = {torch.float32: float("inf"), torch.float64: 1e-11}
RITZ_REPLACES = ("lightkrylov_tpu/utils/hessenberg.py:729",
                 "lightkrylov_tpu/utils/hessenberg.py:778")
HOST_US_CALLS = 50
MAIN_KDIM = 40  # gl512's, the main path's shape
# peak non-tensor-core rates of one H100 SXM at 700 W (NVIDIA's data sheet):
# float32 67 TFLOP/s, float64 34 TFLOP/s
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
HESS_REPLACES = {"hessenberg_schur": "lightkrylov_tpu/utils/hessenberg.py:226",
                 "francis_filter_sweeps": "lightkrylov_tpu/utils/hessenberg.py:687"}
# phase 33: the ordschur kernel (csrc/ordschur.cu) against its plain version
# on the Schur kernel's (T, Z) of Arnoldi Hessenbergs at these kdims (Z
# leaves shared memory at 120 in f64 and 170 in f32, T at 170 and 241, a
# thread owns two rows from 257), each with the masks of ORDSCHUR_MASKS: the
# median selector's (the larger half by modulus, as the custom-selector
# restarts keep; on these inputs the Schur form already leads with it), a
# seeded random one and the larger half by real part
ORDSCHUR_KDIMS = (16, 30, 40, 64, 119, 120, 128, 169, 170, 240, 241, 257, 300)
ORDSCHUR_MASKS = ("median", "random", "real")
ORDSCHUR_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}  # T' of ||T||_F; Z', orthogonality
ORDSCHUR_TIME_KDIMS = (30, 40, 64, 128, 240, 300)
ORDSCHUR_REPLACES = ("lightkrylov_tpu/utils/hessenberg.py:481",
                     "lightkrylov_tpu/utils/hessenberg.py:571")
ORDSCHUR_MAIN = "30_float64"  # the shape of the convdiff device solves' restarts

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
# P7's (1024, 256) blocks, 32 across at 8192^2, on arrays of the same bytes
# 16 and 64 blocks across: how much of each row the units in flight span
TILE_CASES["16384x4096_blk1024x256"] = ((16384, 4096), (1024, 256), [])
TILE_CASES["4096x16384_blk1024x256"] = ((4096, 16384), (1024, 256), [])
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


def launch_count(*names) -> int:
    """The kernel launches counted so far under ``launches.<name>`` (the
    port's counters, ``lt.timer``), summed over ``names``: a phase takes the
    difference of two readings."""
    return sum(lt.timer.get_counter(f"launches.{name}") for name in names)


def run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    check(proc.returncode == 0, f"{' '.join(cmd)} exited with {proc.returncode}: {proc.stderr}")
    return proc.stdout.strip()


def timed(fn, *args):
    """``(fn(*args), its seconds)``."""
    t0 = time.perf_counter()
    return fn(*args), time.perf_counter() - t0


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
            before = launch_count("bell_spmv")
            got = lt.bell_spmv(data, cols, x)
            torch.cuda.synchronize()
            check(launch_count("bell_spmv") == before + 1, "bell_spmv did not count its launch")
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
    lt.timer.reset_counters()
    before = launch_count("bell_spmv")
    x_k, info_k, meta_k = lt.gmres(op_k, b, rtol=0.0, atol=0.0, options=opts)
    torch.cuda.synchronize()
    launches = launch_count("bell_spmv") - before
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
    bell = lt.bell_from_scipy(A, bm=8, bn=128, dtype=np.float32, device=dev)
    t_asm = time.perf_counter() - t0
    assembler = "the card's (torch)" if dev.type == "cuda" else (
        "native C++" if native.available() else f"numpy ({native.unavailable_reason()})")
    print(f"Poisson {n}^2 in Block-ELL: {assembler} assembler, K={bell.K}, fill "
          f"{bell.fill_ratio:.4f}, {bell.data.numel() * 4 / 1e9:.2f} GB f32, {t_asm:.1f} s "
          "with the scipy assembly")
    check(bell.K <= 4, f"K={bell.K} for the 5-point stencil in 8x128 blocks")
    op_b = lt.BellOperator(bell, is_hermitian=True)
    op_s = lt.CudaPoisson2D(n, dtype=torch.float32, device=dev)
    u = seeded((n, n), torch.float32, dev, seed=6)
    before = (launch_count("bell_spmv"), launch_count("stencil_matvec"))
    yb, ys = op_b.matvec(u.reshape(-1)), op_s.matvec(u).reshape(-1)
    torch.cuda.synchronize()
    check((launch_count("bell_spmv"), launch_count("stencil_matvec")) == (before[0] + 1, before[1] + 1),
          "the matvecs did not go through both kernels")
    rel = rel_err(yb, ys)
    print(f"Block-ELL vs stencil matvec {n}^2 f32: rel {rel:.3e}")
    check(rel <= BELL_REL_TOL[torch.float32], f"Block-ELL Poisson matvec differs by {rel:.3e}")
    opts = lt.EigsOptions(maxiter=1)
    before = (launch_count("bell_spmv"), launch_count("stencil_matvec"))
    wb = lt.eighs(op_b, 4, x0=u.reshape(-1), kdim=32, tolerance=0.0, options=opts)[0]
    ws = lt.eighs(op_s, 4, x0=u, kdim=32, tolerance=0.0, options=opts)[0]
    launches = (launch_count("bell_spmv") - before[0], launch_count("stencil_matvec") - before[1])
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


def convdiff_csr(n, eps=1e-2, cx=1.0, cy=0.5):
    """ConvectionDiffusion2D(n) as a scipy CSR matrix, unknown j n + i for
    the point (i, j): its five diagonals, the entries past the boundary cut."""
    h = 1.0 / (n + 1)
    k = np.arange(n * n, dtype=np.int64)
    i, j = k % n, k // n
    offsets = np.array([-n, -1, 0, 1, n])
    values = np.array([-eps / h**2 - cy / (2 * h), -eps / h**2 - cx / (2 * h),
                       eps * 4 / h**2, -eps / h**2 + cx / (2 * h), -eps / h**2 + cy / (2 * h)])
    keep = np.stack([j > 0, i > 0, np.ones(n * n, bool), i < n - 1, j < n - 1], axis=1)
    indptr = np.zeros(n * n + 1, np.int64)
    np.cumsum(keep.sum(1), out=indptr[1:])
    return sp.csr_matrix((np.broadcast_to(values, (n * n, 5))[keep],
                          (k[:, None] + offsets)[keep], indptr), shape=(n * n, n * n))


def bell_fitted(dev, tag):
    """Phase 9, the layout fitted on the card: 3162^2 convection-diffusion
    in float64 with no block shape given."""
    n = N_SHARDED
    A = convdiff_csr(n)
    t0 = time.perf_counter()
    bell = lt.bell_from_scipy(A, dtype=np.float64, device=dev)
    torch.cuda.synchronize()
    t_asm = time.perf_counter() - t0
    nbytes = bell.data.numel() * 8 + bell.cols.numel() * 4
    print(f"fitted Block-ELL {n}^2 convection-diffusion f64: bm={bell.bm} bn={bell.bn} "
          f"K={bell.K}, fill {bell.fill_ratio:.4%}, {nbytes / 1e6:.1f} MB of data and cols, "
          f"built in {t_asm:.3f} s")
    check((bell.bm, bell.bn, bell.K) == (1, 1, 5),
          f"the card built {bell.bm}x{bell.bn} blocks, K={bell.K}, not 1x1 and K=5")
    op_b = lt.BellOperator(bell)
    op_m = lt.ConvectionDiffusion2D(n, dtype=torch.float64, device=dev)
    xs = [seeded((n * n,), torch.float64, dev, seed=s) for s in (41, 42)]
    before = (launch_count("bell_spmv"), launch_count("bell_rows"))
    got = op_b.matvec(xs[0])
    torch.cuda.synchronize()
    check((launch_count("bell_spmv"), launch_count("bell_rows")) == (before[0] + 1, before[1] + 1),
          "the matvec did not go through the row kernel")
    rel = rel_err(got, op_m.matvec(xs[0].reshape(n, n)).reshape(-1))
    print(f"fitted Block-ELL {n}^2 f64 vs the matrix-free operator: rel {rel:.3e}")
    check(rel <= BELL_REL_TOL[torch.float64], f"fitted Block-ELL product differs by {rel:.3e}")
    # the yardstick: the same product as one cuSPARSE CSR call
    csr = torch.sparse_csr_tensor(torch.from_numpy(A.indptr), torch.from_numpy(A.indices),
                                  torch.from_numpy(A.data), size=A.shape).to(dev)
    lib_rel = rel_err(torch.mv(csr, xs[0]), got)
    check(lib_rel <= BELL_REL_TOL[torch.float64], f"cuSPARSE differs by {lib_rel:.3e}")
    ms = alternating_ms({
        "kernel": lambda: lt.bell_spmv(bell.data, bell.cols, xs[0]),
        "plain": lambda: bell_spmv_reference(bell.data, bell.cols, xs[1]),
        "library": lambda: torch.mv(csr, xs[0])}, per_run=10)
    moved = nbytes + 2 * n * n * 8
    bound = bound_ms(moved)
    print(f"{tag} bell_spmv row kernel {n}^2 f64 (1x1, K=5): kernel {ms['kernel'] * 1e3:.1f} us, "
          f"plain {ms['plain'] * 1e3:.1f} us, cuSPARSE CSR {ms['library'] * 1e3:.1f} us (rel "
          f"{lib_rel:.2e}); bound {bound * 1e3:.1f} us ({moved / 1e6:.1f} MB: data, cols, x, y), "
          f"{100 * bound / ms['kernel']:.1f}% of it (10 calls a sample)")
    del bell, op_b, got, xs, csr
    torch.cuda.empty_cache()
    return dict(bm=1, bn=1, K=5, assembly_s=t_asm, matvec_rel=rel, ms=ms, bound_ms=bound)


def eighs_3072(dev, tag):
    """Phase 10: the flagship stage eighs_3072 (flagship_tpu.py:331-356)."""
    n = N_EIGHS
    op = lt.CudaPoisson2D(n, dtype=torch.float32, device=dev)
    x0 = seeded((n, n), torch.float32, dev, seed=7)
    opts = lt.EigsOptions(maxiter=1)
    lt.timer.reset_counters()
    before = launch_count("stencil_matvec", "stencil_matvec_2d")
    w, V, r, info, meta = lt.eighs(op, 4, x0=x0, kdim=32, tolerance=0.0, options=opts)
    torch.cuda.synchronize()
    launches = launch_count("stencil_matvec", "stencil_matvec_2d") - before
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
    before = launch_count("bell_spmv")
    x, info, meta = lt.gmres(op_b, b, rtol=1e-10, options=opts)
    launches = launch_count("bell_spmv") - before
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
    lt.timer.reset_counters()
    before = launch_count("stencil_matvec", "stencil_matvec_2d")
    w, V, r, info, meta = lt.eigs(op, 4, x0=x0, kdim=32, tolerance=0.0, options=opts)
    torch.cuda.synchronize()
    launches = launch_count("stencil_matvec", "stencil_matvec_2d") - before
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
                im_dev=d_im, sweep_ms=sweep, ritz=[[z.real, z.imag] for z in w])


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
    before = launch_count("bell_spmv")
    w, V, r, info, meta = lt.eigs(op_b, 6, x0=x0, kdim=30, tolerance=1e-10,
                                  options=lt.EigsOptions(maxiter=100))
    torch.cuda.synchronize()
    launches = launch_count("bell_spmv") - before
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
    before = launch_count("stencil_matvec", "stencil_matvec_2d")
    c_k, info_k = lt.kexpm(op_k, b, tau)
    torch.cuda.synchronize()
    launches = launch_count("stencil_matvec", "stencil_matvec_2d") - before
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

    lt.timer.reset_counters()
    before = launch_count("stencil_matvec", "stencil_matvec_2d")
    U, S, V, res, info, meta = sweep(op_k)
    torch.cuda.synchronize()
    launches = launch_count("stencil_matvec", "stencil_matvec_2d") - before
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

    before = launch_count("bell_spmv")
    U, S, V, res, info, meta = sweep(op_k)
    torch.cuda.synchronize()
    launches = launch_count("bell_spmv") - before
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
    before = launch_count("bell_spmv")
    t0 = time.perf_counter()
    U, S, V, res, info, meta = lt.svds(op_b, 4, u0=torch.ones(m * m, device=dev), kdim=30,
                                       tolerance=5e-3, options=opts)
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    launches = launch_count("bell_spmv") - before
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
    timed cold at 3072^2, p = 2 and 4, against p single launches and cuDNN."""
    out = {"parity": []}
    main_err = None
    shapes = STENCIL_SHAPES + [(N_SHARDED, N_SHARDED)]
    for dtype in (torch.float32, torch.float64):
        for shape in shapes:
            for p in BATCH_PS:
                u = seeded((p,) + shape, dtype, dev, seed=p)
                args = stencil_args(u[0])
                before = (launch_count("stencil_matvec"), launch_count("stencil_matvec_batched"))
                got = lt.stencil_matvec_batched(u, **args)
                torch.cuda.synchronize()
                check((launch_count("stencil_matvec"), launch_count("stencil_matvec_batched"))
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
    n, by_p = N_MAIN, {}
    for p in STENCIL_TIME_PS:
        nbytes = 8 * p * n * n
        nbuf = max(1, -(-4 * L2_BYTES // nbytes))
        stacks = [seeded((p, n, n), torch.float32, dev, seed=30 + s) for s in range(nbuf)]
        args = stencil_args(stacks[0][0])
        w = torch.tensor([[0.0, -args["ihy2"], 0.0],
                          [-args["ihx2"], 2.0 * (args["ihx2"] + args["ihy2"]), -args["ihx2"]],
                          [0.0, -args["ihy2"], 0.0]], device=dev)[None, None]
        conv = lambda u: torch.nn.functional.conv2d(u[:, None], w, padding=1)[:, 0]  # noqa: E731
        rel = rel_err(conv(stacks[0]), stencil_matvec_reference(stacks[0], **args))
        check(rel <= REL_TOL[torch.float32], f"conv2d batch-{p} stencil rel err {rel:.3e}")
        fns = {"batched": lambda u: lt.stencil_matvec_batched(u, **args),
               "single": lambda u: [lt.stencil_matvec(u[i], **args) for i in range(p)],
               "plain": lambda u: stencil_matvec_reference(u, **args),
               "conv2d": conv}
        ms = {name: median_ms(lambda i: fn(stacks[i % nbuf]), per_run=nbuf * 2)
              for name, fn in fns.items()}
        bound = bound_ms(nbytes)
        print(f"{tag} batched stencil {p}x{n}x{n} f32 cold ({nbuf} stacks rotated): one batched "
              f"launch {ms['batched'] * 1e3:.1f} us, {p} single launches {ms['single'] * 1e3:.1f} us, "
              f"plain {ms['plain'] * 1e3:.1f} us, cuDNN conv2d batch {p} {ms['conv2d'] * 1e3:.1f} us "
              f"(rel err vs plain {rel:.2e}); bound {bound * 1e3:.1f} us (8 B/point, {p} fields, "
              f"3.35 TB/s): batched at {100 * bound / ms['batched']:.0f}% of its bound")
        by_p[p] = dict(ms, bound_ms=bound, conv2d_rel_err=rel)
        del stacks
        torch.cuda.empty_cache()
    p2 = by_p[2]
    out.update(ms={"batched": p2["batched"], "two_single": p2["single"], "plain": p2["plain"],
                   "conv2d": p2["conv2d"]}, bound_ms=p2["bound_ms"],
               conv2d_rel_err=p2["conv2d_rel_err"], max_abs_err=main_err, p=2, n=n, by_p=by_p)
    return out


def spiral_matrix(n, seed, real=None):
    """A real matrix with a known complex spectrum: 2x2 rotation-scaling
    blocks with geometric radii, orthogonally conjugated
    (tests/test_block_eigs.py:31-49, the probe block_eigs_r5); with ``real``
    one more row and column holding the real eigenvalue ``real``."""
    rng = np.random.default_rng(seed)
    m = n + (real is not None)
    D = np.zeros((m, m))
    for j in range(n // 2):
        r, th = 2.5 * 0.85 ** j, 0.3 + 2.1 * j
        a, b = r * np.cos(th), r * np.sin(th)
        D[2 * j, 2 * j] = D[2 * j + 1, 2 * j + 1] = a
        D[2 * j, 2 * j + 1], D[2 * j + 1, 2 * j] = b, -b
    if real is not None:
        D[n, n] = real
    Q, _ = np.linalg.qr(rng.standard_normal((m, m)))
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
    lt.timer.reset_counters()
    before = (launch_count("stencil_matvec_batched"),
              launch_count("stencil_matvec", "stencil_matvec_2d"))
    w, V, r, info, meta = sweep(counted_op)
    torch.cuda.synchronize()
    launches = dict(batched=launch_count("stencil_matvec_batched") - before[0],
                    single=launch_count("stencil_matvec", "stencil_matvec_2d") - before[1])
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
    matrix at p = 2, 4 and MAX_SPMM_COLUMNS, timed, then block eigs f64 on the convection-diffusion operator
    through it."""
    out = {"parity": [], "ms": {}}
    bell = bell_main_matrix(dev)
    csr = bell_csr(bell)
    n = bell.shape[0]
    mat_bytes = (bell.data.numel() + bell.cols.numel()) * 4
    for p in BELL_TIME_PS:
        X = seeded((p, n), torch.float32, dev, seed=40 + p)
        before = (launch_count("bell_spmv"), launch_count("bell_spmm"))
        got = lt.bell_spmm(bell.data, bell.cols, X)
        torch.cuda.synchronize()
        check((launch_count("bell_spmv"), launch_count("bell_spmm")) == (before[0], before[1] + 1),
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

    before = (launch_count("bell_spmm"), launch_count("bell_spmv"))
    w, V, r, info, meta = solve(op_b, x0, 100)
    torch.cuda.synchronize()
    launches = dict(batched=launch_count("bell_spmm") - before[0],
                    single=launch_count("bell_spmv") - before[1])
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
    before = launch_count(wrapper.__name__)
    out = wrapper(*args)
    torch.cuda.synchronize()
    check(launch_count(wrapper.__name__) == before + 1, f"{wrapper.__name__} did not count its one launch")
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
        unit_rows, unit_cols, grid = probe_ops.tiles_geometry(*shape, *block)
        out["copy_tiles"][label] = probe_row(
            tag, "copy_tiles", f"{label} (a unit of {unit_rows} x {unit_cols} a CTA)",
            {"kernel": lambda: probe_ops.copy_tiles(x, block),
             "plain": lambda: probe_ops.copy_reference(x), "library": lambda: y.copy_(x)},
            2 * x.numel() * 4, grid,
            {"replaces": ids, "shape": list(shape), "block": list(block), "max_abs_err": err,
             "unit": [unit_rows, unit_cols]})
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
        n_chunks, rings, grid = probe_ops.card_ring_geometry(dev, x.numel() * 4, depth, stage)
        fits = probe_ops.ring_ctas_per_sm(dev, depth, stage)
        # rings an SM in use, and the stages they keep in flight
        busy = min(rings, -(-grid // sms))
        least = len(probe_ops.ring_chunks(n_chunks, grid, grid - 1))
        most = len(probe_ops.ring_chunks(n_chunks, grid, 0))
        out["copy_ring"][label] = probe_row(
            tag, "copy_ring", f"{label} (stage {stage} B, ring {depth * stage} B; {rings} rings "
            f"an SM, the card holds {fits}; {grid} CTAs of {least}-{most} chunks; "
            f"{busy * depth * stage // 1024} KB in flight an SM)",
            {"kernel": lambda: probe_ops.copy_ring(x, depth, stage),
             "plain": lambda: probe_ops.copy_reference(x), "library": lambda: y.copy_(x)},
            2 * x.numel() * 4, grid,
            {"replaces": ["P4", "P5"] if depth == 2 else ["P5"], "shape": list(shape),
             "depth": depth, "tpu_rows": rows, "stage_bytes": stage, "max_abs_err": err,
             "rings_per_sm": rings, "card_ctas_per_sm": fits, "n_chunks": n_chunks,
             "bytes_in_flight_per_sm": busy * depth * stage})
        del y
    del x
    # both ends of the ring geometry ran on the card
    ends = {row["rings_per_sm"] for row in out["copy_ring"].values()}
    check({1, probe_ops.RING_MAX_CTAS_PER_SM} <= ends,
          f"copy_ring ran at {sorted(ends)} rings an SM, not at both 1 and "
          f"{probe_ops.RING_MAX_CTAS_PER_SM}")

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
    wrappers = ("copy_tiles", "copy_ring", "reduce_8x128")
    before = {w: launch_count(w) for w in wrappers}
    path = {}
    for mod in (roofline, manual_out, deep_buffer, stencil_sweep, copy_shape):
        t0 = time.perf_counter()
        res = mod.run(dev, **PROBE_LOOP)
        check(res["device_kind"] == torch.cuda.get_device_name(dev), f"{res['probe']} device")
        path[res["probe"]] = res
        print(f"{tag} probe path: {res['probe']} in {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    launches = {w: launch_count(w) - before[w] for w in wrappers}
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
    """``fn()`` after the counters are cleared, then synchronised; returns
    ``(out, counts)``: stencil and Block-ELL launches, the vector layer's
    all-reduces and the operators' collectives."""
    lt.timer.reset_counters()
    before = (launch_count("stencil_matvec", "stencil_matvec_2d"), launch_count("bell_spmv"))
    out = fn()
    torch.cuda.synchronize()
    return out, dict(stencil=launch_count("stencil_matvec", "stencil_matvec_2d") - before[0],
                     bell_spmv=launch_count("bell_spmv") - before[1],
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



# -- phase 33: the device projected path ---------------------------------------

def match_dist(a, b):
    """Largest distance between two multisets of complex numbers, matched one
    to one."""
    a, b = np.asarray(a), np.asarray(b)
    cost = np.abs(a[:, None] - b[None, :])
    r, c = linear_sum_assignment(cost)
    return float(cost[r, c].max()) if len(r) else 0.0


def ptxas_figures(log):
    """Each kernel instance's registers, stack frame and spill bytes as
    ``ptxas -v`` reports them in the build log, by the entry of the kernels
    line whose function it is (KERNEL_FUNCTIONS): ``{entry: [{"instance",
    "registers", "stack_frame", "spill_stores", "spill_loads"}]}``.  Mangled
    names are matched by their length-prefixed identifier and shown
    demangled when ``c++filt`` is there."""
    entries, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)' for", line)
        if m:
            cur = {"mangled": m.group(1)}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur.update(stack_frame=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
            entries.append(cur)
            cur = None
    names = [e["mangled"] for e in entries]
    if shutil.which("c++filt") and names:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True, text=True)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(names):
            names = [n.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]
                     for n in out.stdout.splitlines()]
    figures = {entry: [] for entry in KERNEL_FUNCTIONS}
    for e, name in zip(entries, names):
        for entry, fns in KERNEL_FUNCTIONS.items():
            if any(f"{len(fn)}{fn}" in e["mangled"] for fn in fns):
                figures[entry].append(dict(instance=name, registers=e["registers"],
                                           stack_frame=e.get("stack_frame", 0),
                                           spill_stores=e.get("spill_stores", 0),
                                           spill_loads=e.get("spill_loads", 0)))
    return figures


def parent_ops():
    """The parent commit's ``ops.hessenberg`` and ``ops._build`` modules,
    imported from PARENT_DIR/lightkrylov_tpu_torch as the package
    ``lk_parent`` (its own build directory and launch counts), or None
    when that tree is not there."""
    pkg = PARENT_DIR / "lightkrylov_tpu_torch"
    if not (pkg / "__init__.py").is_file():
        return None
    if "lk_parent" not in sys.modules:
        spec = importlib.util.spec_from_file_location("lk_parent", pkg / "__init__.py",
                                                      submodule_search_locations=[str(pkg)])
        module = importlib.util.module_from_spec(spec)
        sys.modules["lk_parent"] = module
        spec.loader.exec_module(module)
    return (importlib.import_module("lk_parent.ops.hessenberg"),
            importlib.import_module("lk_parent.ops._build"))


def arnoldi_hessenberg(kdim, seed, n=512, real=None):
    """The ``(kdim + 1, kdim)`` Arnoldi Hessenberg of the spiral operator
    (with ``real``, one more real eigenvalue) from a seeded start vector, in
    float64 on the host: the projected matrix an eigs check sees."""
    A = spiral_matrix(n, seed, real)
    n = A.shape[0]
    V = np.zeros((n, kdim + 1))
    H = np.zeros((kdim + 1, kdim))
    v = np.random.default_rng(seed + 1).standard_normal(n)
    V[:, 0] = v / np.linalg.norm(v)
    for k in range(kdim):
        w = A @ V[:, k]
        for _ in range(2):
            h = V[:, :k + 1].T @ w
            w -= V[:, :k + 1] @ h
            H[:k + 1, k] += h
        H[k + 1, k] = np.linalg.norm(w)
        V[:, k + 1] = w / H[k + 1, k]
    return H


def filter_hessenberg(kdim, seed):
    """The filter's square Arnoldi Hessenberg at ``kdim``: the spiral
    operator's, with, for an odd kdim, one more real and dominant eigenvalue
    (3.0).  With conjugate pairs alone the Ritz values of an odd kdim hold
    one real value, last in modulus, so every odd keep count (the filter
    keeps ``kdim - n`` even) splits a pair, the keep count moves to the
    clamp and the filter applies no sweep, or a few at a boundary among Ritz
    values of modulus 1e-8."""
    return arnoldi_hessenberg(kdim, seed, real=3.0 if kdim % 2 else None)[:kdim, :kdim]


def schur_inputs(dtype):
    """(label, matrix, k_eff): seeded Hessenberg matrices at SCHUR_N, Arnoldi
    Hessenbergs at SCHUR_ARNOLDI_N, the Krylov-Schur arrow form, exact
    conjugate pairs, k_eff < n, a zero diagonal, the cyclic shift, on which
    the Wilkinson shifts stall, and a Hessenberg so small (2^-33 in f32,
    2^-300 in f64) that a chase's first vector cannot be squared unscaled."""
    rng = np.random.default_rng(33)
    cases = [(f"hess{n}", np.triu(rng.standard_normal((n, n)), -1), n) for n in SCHUR_N]
    cases += [(f"arnoldi{n}", arnoldi_hessenberg(n, seed=n)[:n, :n], n)
              for n in SCHUR_ARNOLDI_N]
    m, n = 20, 40
    arrow = np.triu(rng.standard_normal((n, n)), -1)
    arrow[:m, :m] = np.triu(arrow[:m, :m])
    arrow[m, :m] = rng.standard_normal(m)  # the spike row
    cases.append(("arrow40", arrow, n))
    D = np.zeros((n, n))
    for j in range(n // 2):
        a, b = np.cos(0.3 + j), 0.5 + 0.05 * j
        D[2 * j:2 * j + 2, 2 * j:2 * j + 2] = [[a, b], [-b, a]]
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    cases.append(("pairs40", Q @ D @ Q.T, n))
    cases.append(("keff50of64", np.triu(rng.standard_normal((64, 64)), -1), 50))
    zero_diag = np.triu(rng.standard_normal((24, 24)), -1)
    np.fill_diagonal(zero_diag, 0.0)
    cases.append(("zerodiag24", zero_diag, 24))
    cyclic = np.zeros((4, 4))
    cyclic[np.arange(1, 4), np.arange(3)] = 1.0
    cyclic[0, 3] = 1.0
    cases.append(("cyclic4", cyclic, 4))
    tiny = 2.0 ** (-33 if dtype == torch.float32 else -300)
    cases.append(("tiny24", np.triu(np.random.default_rng(5).standard_normal((24, 24)), -1)
                  * tiny, 24))
    return cases


def schur_work(n, steps, with_z, dtype):
    """Bytes moved and operations of one hessenberg_schur call: the input
    read and T, Z, wr, wi written once; the reduction's four rank-one passes
    a column (two more for Z) and 15 operations a row or column element of a
    3-row or 3-column chase update (the 3x3 reflector applied to H's rows,
    H's columns and Z's columns)."""
    size = torch.empty((), dtype=dtype).element_size()
    nbytes = size * (n * n * (3 if with_z else 2) + 2 * n)
    red = sum((8 + (4 if with_z else 0)) * (n - j - 1) * n for j in range(max(n - 2, 0)))
    chase = steps * 15 * n * (3 if with_z else 2)
    return nbytes, red + chase


def filter_work(n, steps, dtype):
    """Bytes and operations of one francis_filter_sweeps call: H, the shifts
    and their order read once, Hf and Z written once; 15 operations a row or
    column element of each chase step's three 3-wide updates."""
    size = torch.empty((), dtype=dtype).element_size()
    return size * (3 * n * n + 3 * n), steps * 15 * n * 3


def bound_of(nbytes, flops, dtype):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def plain_result(plain, key, run_on_card):
    """The plain version's outputs and seconds for ``key``: the host worker's
    (``plain[key]``, numpy arrays) or, where there is none, ``run_on_card()``
    timed (tensors on the card)."""
    if key in plain:
        outs, seconds = plain[key].result()
        return [None if a is None else torch.from_numpy(a) for a in outs], seconds, "host"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = run_on_card()
    torch.cuda.synchronize()
    return outs, time.perf_counter() - t0, "card"


def schur_checks(dev, dtype, cases, plain, out):
    """Phase 33 (a): the Schur kernel with Z and the split against its plain
    version and numpy's eig on ``cases``; rows into ``out["schur"]``."""
    for label, H, k in cases:
        Ht = torch.from_numpy(H).to(dev, dtype)
        T, Z, wr, wi, acc, ok, work = hess_ops.hessenberg_schur(Ht, k, with_z=True, split=True)
        (_, _, pwr, pwi, _, pok, pwork), plain_s, where = plain_result(
            plain, ("schur", label, dtype),
            lambda: hess_ops.hessenberg_schur_reference(Ht, k, True, True))
        w = (wr.double() + 1j * wi.double()).cpu().numpy()[:k]
        wp = (pwr.double() + 1j * pwi.double()).cpu().numpy()[:k]
        Ha = Ht.double().cpu().numpy()[:k, :k]
        norm = float(np.linalg.norm(Ha))
        d_plain = match_dist(w, wp) / norm
        d_np = match_dist(w, np.linalg.eigvals(Ha)) / norm
        Hm = hess._embed(Ht.double(), k)[0].cpu().numpy()
        Tn, Zn = T.double().cpu().numpy(), Z.double().cpu().numpy()
        fact = float(np.linalg.norm(Zn @ Tn @ Zn.T - Hm, 2) / np.linalg.norm(Hm, 2))
        orth = float(np.linalg.norm(Zn.T @ Zn - np.eye(len(Zn)), 2))
        row = dict(case=label, dtype=str(dtype), n=int(H.shape[0]), k_eff=k, ok=bool(ok),
                   sweeps=int(work[0]), steps=int(work[1]), plain_sweeps=int(pwork[0]),
                   plain_steps=int(pwork[1]), eig_vs_plain=d_plain, eig_vs_numpy=d_np,
                   factorization=fact, orthogonality=orth, max_abs_err=d_plain * norm,
                   plain_s=plain_s, plain_on=where)
        out["schur"].append(row)
        print(f"hessenberg_schur {label} {dtype}: ok {bool(ok)}, {row['sweeps']} sweeps "
              f"({row['steps']} chase steps; plain {row['plain_sweeps']}, "
              f"{row['plain_steps']}), eigenvalues vs "
              f"plain {d_plain:.2e} and vs numpy {d_np:.2e} of ||H||_F, ||ZTZ^T-H||/||H|| "
              f"{fact:.2e}, ||Z^TZ-I|| {orth:.2e}; plain {plain_s:.2f} s on the {where}")
        check(bool(ok) and bool(pok), f"hessenberg_schur {label} {dtype}: sweep budget out")
        tol, otol = SCHUR_EIG_TOL[dtype], SCHUR_ORTH_TOL[dtype]
        check(d_plain <= tol and d_np <= tol,
              f"hessenberg_schur {label} {dtype}: eigenvalues off by {d_plain:.2e} / "
              f"{d_np:.2e} of ||H||_F (gate {tol})")
        check(fact <= otol and orth <= otol,
              f"hessenberg_schur {label} {dtype}: factorization {fact:.2e}, orthogonality "
              f"{orth:.2e} (gate {otol})")
        # both sum each small product in the order the plain version
        # writes, so they take the same sweeps and chase steps: in f64 on
        # every input, in f32 on every Hessenberg input (the reduction of
        # a dense one sums in the library's order)
        if dtype == torch.float64 or not np.tril(H, -2).any():
            check([row["sweeps"], row["steps"]] == [row["plain_sweeps"], row["plain_steps"]],
                  f"hessenberg_schur {label} {dtype}: sweeps and chase steps "
                  f"{[row['sweeps'], row['steps']]}, plain "
                  f"{[row['plain_sweeps'], row['plain_steps']]}")
    rows = [r for r in out["schur"] if r["dtype"] == str(dtype)]
    same = [r["case"] for r in rows
            if [r["sweeps"], r["steps"]] == [r["plain_sweeps"], r["plain_steps"]]]
    print(f"hessenberg_schur {dtype}: the plain version's sweeps and chase steps in "
          f"{len(same)} of {len(rows)} cases; other counts in "
          f"{[r['case'] for r in rows if r['case'] not in same]}")


def filter_checks(dtype, cases, plain, out):
    """Phase 33 (a): the filter kernel against its plain version on the
    Arnoldi Hessenbergs of ``cases``; rows into ``out["filter"]``."""
    for kdim in FILTER_KDIMS:
        Hs, Ht, (wr, wi, order, n, pure, ok) = cases[dtype, kdim]
        Hf, Z, work = hess_ops.francis_filter_sweeps(Ht, wr, wi, order, n, pure)
        (Hp, _, pwork), plain_s, where = plain_result(
            plain, ("filter", kdim, dtype),
            lambda: hess_ops.francis_filter_sweeps_reference(Ht, wr, wi, order, n, pure))
        n = int(n)
        Hd = Ht.double().cpu().numpy()
        norm = float(np.linalg.norm(Hd))
        Hfn, Zn = Hf.double().cpu().numpy(), Z.double().cpu().numpy()
        fact = float(np.linalg.norm(Zn.T @ Hd @ Zn - Hfn, 2) / np.linalg.norm(Hd, 2))
        orth = float(np.linalg.norm(Zn.T @ Zn - np.eye(kdim), 2))
        kept = np.linalg.eigvals(Hfn[:n, :n])
        d_plain = match_dist(kept, np.linalg.eigvals(Hp.double().cpu().numpy()[:n, :n])) / norm
        w_all = np.linalg.eigvals(Hd)
        d_lead = match_dist(kept, w_all[np.argsort(-np.abs(w_all))][:n]) / norm
        row = dict(kdim=kdim, dtype=str(dtype), n=n, ok=bool(ok & pure),
                   sweeps=int(work[0]), steps=int(work[1]), plain_sweeps=int(pwork[0]),
                   plain_steps=int(pwork[1]), kept_vs_plain=d_plain, kept_vs_lead=d_lead,
                   factorization=fact, orthogonality=orth, max_abs_err=d_plain * norm,
                   plain_s=plain_s, plain_on=where)
        out["filter"].append(row)
        print(f"francis_filter_sweeps kdim {kdim} {dtype}: keep {n}, {row['sweeps']} sweeps "
              f"({row['steps']} chase steps; plain {row['plain_sweeps']}, "
              f"{row['plain_steps']}), kept spectrum vs "
              f"plain {d_plain:.2e} and vs the {n} largest {d_lead:.2e} of ||H||_F, "
              f"||Z^THZ-Hf||/||H|| {fact:.2e}, ||Z^TZ-I|| {orth:.2e}; plain {plain_s:.2f} s "
              f"on the {where}")
        check(bool(ok & pure) and row["sweeps"] == row["plain_sweeps"] > 0,
              f"francis_filter_sweeps kdim {kdim} {dtype}: sweeps {row}")
        tol, otol = FILTER_EIG_TOL[dtype], SCHUR_ORTH_TOL[dtype]
        check(d_plain <= tol and d_lead <= tol,
              f"francis_filter_sweeps kdim {kdim} {dtype}: kept spectrum off by "
              f"{d_plain:.2e} / {d_lead:.2e} (gate {tol})")
        check(fact <= otol and orth <= otol,
              f"francis_filter_sweeps kdim {kdim} {dtype}: factorization {fact:.2e}, "
              f"orthogonality {orth:.2e} (gate {otol})")


def filter_prescale_checks(dev, out):
    """Phase 33 (a): the filter kernel on the Arnoldi Hessenberg at kdim
    MAIN_KDIM scaled by 2^e outside the range (FILTER_PRESCALE): it scales H
    and the shifts as its plain version does (ROADMAP F14), so it takes the
    plain version's sweeps and chase steps and the 2^0 run's, keeps the
    spectrum of the 2^0 run (scaled) and its Z; rows into out["filter"]."""
    Hs = filter_hessenberg(MAIN_KDIM, seed=MAIN_KDIM)
    norm = float(np.linalg.norm(Hs))
    w = np.linalg.eigvals(Hs)
    for dtype, e in FILTER_PRESCALE:
        H0 = torch.from_numpy(Hs).to(dev, dtype)
        Ht = torch.from_numpy(Hs * 2.0 ** e).to(dev, dtype)
        shifts = hess._filter_shifts(Ht, MAIN_KDIM // 2)
        Hf, Z, work = hess_ops.francis_filter_sweeps(Ht, *shifts[:5])
        Hp, _, pwork = hess_ops.francis_filter_sweeps_reference(Ht, *shifts[:5])
        _, Z0, work0 = hess_ops.francis_filter_sweeps(
            H0, *hess._filter_shifts(H0, MAIN_KDIM // 2)[:5])
        n, s = int(shifts[3]), 2.0 ** -e
        # held at 2^0 (an exact scale): numpy's eig need not hold at 2^-520
        kept = np.linalg.eigvals(Hf.double().cpu().numpy()[:n, :n] * s)
        d_plain = match_dist(kept, np.linalg.eigvals(Hp.double().cpu().numpy()[:n, :n] * s)) / norm
        d_lead = match_dist(kept, w[np.argsort(-np.abs(w))][:n]) / norm
        d_z = float((Z - Z0).abs().max())
        row = dict(kdim=MAIN_KDIM, dtype=str(dtype), scale_exp=e, n=n,
                   ok=bool(shifts[5] & shifts[4]), sweeps=int(work[0]), steps=int(work[1]),
                   plain_sweeps=int(pwork[0]), plain_steps=int(pwork[1]),
                   sweeps_2_pow_0=int(work0[0]), kept_vs_plain=d_plain, kept_vs_lead=d_lead,
                   z_vs_2_pow_0=d_z, finite=bool(torch.isfinite(Hf).all()),
                   max_abs_err=d_plain * norm)
        out["filter"].append(row)
        print(f"francis_filter_sweeps kdim {MAIN_KDIM} {dtype} at 2^{e}: {row['sweeps']} sweeps "
              f"({row['steps']} chase steps; plain {row['plain_sweeps']}, {row['plain_steps']}; "
              f"at 2^0 {row['sweeps_2_pow_0']}), kept spectrum vs plain {d_plain:.2e} and vs "
              f"the {n} largest {d_lead:.2e} of ||H||_F at 2^0, Z vs the 2^0 run's {d_z:.2e}")
        check(row["ok"] and row["finite"]
              and [row["sweeps"], row["steps"]] == [row["plain_sweeps"], row["plain_steps"]]
              and row["sweeps"] == row["sweeps_2_pow_0"] > 0,
              f"francis_filter_sweeps at 2^{e} {dtype}: {row}")
        tol = FILTER_EIG_TOL[dtype]
        check(d_plain <= tol and d_lead <= tol and d_z <= SCHUR_ORTH_TOL[dtype],
              f"francis_filter_sweeps at 2^{e} {dtype}: kept spectrum or Z off (gate {tol}): {row}")


def check_buffer(kind, kdim, p, k):
    """The ``(kdim + p, kdim)`` buffer of a check (tests/test_torch_hessenberg.py
    _check_buffer): a block Arnoldi band (``band``), the Krylov-Schur arrow
    form after a device Schur restart (``arrow``: a triangle, the spike row,
    then Arnoldi columns), or a triangle whose eigenvalues hold exact
    duplicates, a pair a last bit apart (inside ``sep``), a real ``+-lambda``
    tie and exact conjugate pairs (``dups``)."""
    rng = np.random.default_rng(kdim * 10 + p + k)
    He = np.zeros((kdim + p, kdim))
    if kind == "band":
        He[:k + p, :k] = np.triu(rng.standard_normal((k + p, k)), -p)
    elif kind == "arrow":
        m = kdim // 2
        He[:m, :m] = np.triu(rng.standard_normal((m, m)))
        He[m, :m] = rng.standard_normal(m)
        for j in range(m, k):
            He[:j + 2, j] = rng.standard_normal(j + 2)
        He[k + 1:, :] = 0.0
        He[:, k:] = 0.0
    else:
        d = rng.standard_normal(k)
        d[3] = d[1]
        d[6] = np.nextafter(d[1], np.inf)
        d[5] = -d[2]
        T = np.triu(rng.standard_normal((k, k)))
        np.fill_diagonal(T, d)
        for i in (8, 11):
            T[i:i + 2, i:i + 2] = [[d[i], 0.7], [-0.4, d[i]]]
        He[:k, :k] = T
        He[k, k - 1] = 0.8
    return He


def ritz_inputs():
    """(label, H_ext, k_eff, p, nev, tol) of phase 33 (a)'s Ritz cases: the
    Arnoldi buffers of the spiral operator at RITZ_GATE_KDIMS, two with
    k_eff < kdim, block bands with p = 2 and 4, the arrow form and the
    duplicates' triangle, with and without inactive slots."""
    cases = [(f"arnoldi{n}", arnoldi_hessenberg(n, seed=n), n, 1, 16, 1e-6)
             for n in RITZ_GATE_KDIMS]
    cases += [(f"arnoldi{n}_keff{k}", arnoldi_hessenberg(n, seed=n), k, 1, 16, 1e-6)
              for n, k in ((40, 29), (128, 100))]
    cases += [(f"{kind}{kdim}_p{p}_keff{k}", check_buffer(kind, kdim, p, k), k, p, kdim // 2, 0.3)
              for kind, kdim, p, k in (("band", 40, 2, 34), ("band", 64, 4, 60),
                                       ("band", 97, 2, 95), ("band", 170, 2, 165),
                                       ("band", 300, 4, 296), ("arrow", 40, 1, 40),
                                       ("arrow", 200, 1, 200),
                                       ("arrow", 40, 1, 37), ("dups", 40, 1, 36),
                                       ("dups", 40, 1, 40))]
    return cases


def ritz_work(He, k, p, dtype):
    """Bytes and operations of one ritz_check call on the buffer ``He`` with
    ``k_eff = k``: the active block and the coupling read once, (wr, wi)
    read, (Vr, Vi) and (wr, wi, res) written; a slot's elimination 8
    operations an entry of each candidate row's update (the rows whose first
    nonzero column is at most the step's, as many in every slot) and its back
    substitution 8 an entry of U's upper triangle, over the kdim slots."""
    kdim = He.shape[1]
    size = torch.empty((), dtype=dtype).element_size()
    nbytes = size * (k * k + p * p + 2 * kdim + 2 * kdim * kdim + 3 * kdim)
    A = He[:k, :k] != 0
    profile = np.argmax(A | np.eye(k, dtype=bool), axis=1)
    cand = np.cumsum(np.bincount(profile, minlength=k)) - np.arange(k) if k else np.zeros(0)
    elim = sum(8 * (int(c) - 1) * (k - j) for j, c in enumerate(cand))
    return nbytes, kdim * (elim + 4 * k * k)


def unit_phase(V, Vp):
    """Largest entry of ``V - Vp e^{i phi}`` over the columns, ``phi`` the
    phase that aligns each column of ``Vp`` with ``V``'s."""
    dot = np.sum(np.conj(Vp) * V, axis=0)
    ph = np.where(np.abs(dot) > 0, dot / np.where(np.abs(dot) > 0, np.abs(dot), 1.0), 1.0)
    return float(np.abs(V - Vp * ph[None, :]).max()) if V.size else 0.0


def ritz_checks(dev, dtype, cases, plain, out):
    """Phase 33 (a): the Ritz kernel against its plain version on the Schur
    kernel's eigenvalues of ``cases``; rows into ``out["ritz"]``.  Exact: the
    values in their order, the count, the infinite residuals and the zero
    rows from k_eff.  Within RITZ_TOL: each active column's
    ||Hm v - lambda v|| / ||H||_F of the plain version's (and within
    RITZ_RESID_TOL), each column's | |v^H v_plain| - 1 | and | ||v|| - 1 |,
    and each finite residual of the plain version's, against |beta| (p = 1)
    or ||B|| (p > 1)."""
    for label, He, k, p, nev, tol in cases[dtype]:
        kdim = He.shape[1]
        Ht = torch.from_numpy(He).to(dev, dtype)
        _, _, wr, wi, _, ok, _ = hess_ops.hessenberg_schur(Ht[:kdim].contiguous(), k)
        got = [t.cpu() for t in hess_ops.ritz_check(Ht, wr, wi, ok, k, tol, nev, p)]
        want, plain_s, where = plain_result(
            plain, ("ritz", label, dtype),
            lambda: hess_ops.ritz_check_reference(Ht, wr, wi, ok, k, tol, nev, p))
        (gwr, gwi, gres, gVr, gVi, gn), (pwr, pwi, pres, pVr, pVi, pn) = got, [
            t.cpu() for t in want]
        A = Ht.double().cpu().numpy()
        Ha = A[:k, :k]
        hn = float(np.linalg.norm(Ha))
        V = gVr.double().numpy() + 1j * gVi.double().numpy()
        Vp = pVr.double().numpy() + 1j * pVi.double().numpy()
        w = gwr.double().numpy() + 1j * gwi.double().numpy()
        fin = torch.isfinite(pres).numpy()
        resid = [tuple(np.linalg.norm(Ha @ X[:k, j] - w[j] * X[:k, j]) / hn for X in (V, Vp))
                 for j in np.flatnonzero(fin)]
        overlap = np.abs(np.abs(np.sum(np.conj(Vp) * V, axis=0)) - 1.0)
        norms = np.abs(np.linalg.norm(V, axis=0) - 1.0)
        if p == 1:
            scale = abs(A[k, k - 1])
        else:
            scale = float(np.linalg.norm(A[k:k + p, max(k - p, 0):max(k - p, 0) + p], 2))
        dres = np.abs(gres.double().numpy()[fin] - pres.double().numpy()[fin])
        row = dict(case=label, dtype=str(dtype), kdim=kdim, k_eff=k, p=p, ok=bool(ok),
                   n_conv=int(gn), plain_n_conv=int(pn),
                   same_values=bool(torch.equal(gwr, pwr) and torch.equal(gwi, pwi)),
                   same_inf=bool(np.array_equal(torch.isfinite(gres).numpy(), fin)),
                   zero_rows=bool(torch.all(gVr[k:] == 0) and torch.all(gVi[k:] == 0)),
                   max_eig_resid=max((r for r, _ in resid), default=0.0),
                   max_eig_resid_vs_plain=max((abs(r - q) for r, q in resid), default=0.0),
                   max_overlap_err=float(overlap.max()), max_norm_err=float(norms.max()),
                   max_res_err=float(dres.max() / max(scale, 1e-300)) if dres.size else 0.0,
                   max_abs_err=unit_phase(V, Vp), plain_s=plain_s, plain_on=where)
        out["ritz"].append(row)
        print(f"ritz_check {label} {dtype}: n_conv {row['n_conv']} (plain {row['plain_n_conv']}), "
              f"values and order {'equal' if row['same_values'] else 'DIFFER'}, ||Hm v - lv|| "
              f"max {row['max_eig_resid']:.2e} of ||H||_F ({row['max_eig_resid_vs_plain']:.2e} "
              f"from the plain), | |v^H v_plain| - 1 | {row['max_overlap_err']:.2e}, norm "
              f"{row['max_norm_err']:.2e}, residuals {row['max_res_err']:.2e} of the scale, "
              f"max |v - v_plain e^(i phi)| {row['max_abs_err']:.2e}; plain {plain_s:.2f} s on "
              f"the {where}")
        rt = RITZ_TOL[dtype]
        check(bool(ok) and row["same_values"] and row["same_inf"] and row["zero_rows"]
              and row["n_conv"] == row["plain_n_conv"] and int(fin.sum()) == k,
              f"ritz_check {label} {dtype}: exact outputs differ: {row}")
        check(row["max_eig_resid_vs_plain"] <= rt and row["max_eig_resid"] <= RITZ_RESID_TOL[dtype]
              and row["max_overlap_err"] <= rt and row["max_norm_err"] <= rt
              and row["max_res_err"] <= rt,
              f"ritz_check {label} {dtype}: vectors or residuals off (gate {rt}): {row}")


def ordschur_mask(kind, wr, wi, n):
    """The mask of ORDSCHUR_MASKS' ``kind`` over the diagonal positions of a
    Schur form with eigenvalues ``(wr, wi)`` (numpy)."""
    if kind == "median":
        mod = np.hypot(wr, wi)
        return mod > np.median(mod)
    if kind == "real":
        return wr > np.median(wr)
    return np.random.default_rng(n).random(n) < 0.5


def ordschur_input(dev, dtype, n, kind):
    """``(T, Z, mask)`` on the card: the Schur kernel's form with ``Z`` and
    the split of the spiral operator's Arnoldi Hessenberg at kdim ``n``, and
    the mask of ``kind``."""
    A = torch.from_numpy(arnoldi_hessenberg(n, seed=n)[:n, :n]).to(dev, dtype)
    T, Z, wr, wi, _, ok, _ = hess_ops.hessenberg_schur(A, n, with_z=True, split=True)
    check(bool(ok), f"hessenberg_schur arnoldi{n} {dtype}: sweep budget out")
    mask = ordschur_mask(kind, wr.double().cpu().numpy(), wi.double().cpu().numpy(), n)
    return T, Z, torch.from_numpy(mask).to(dev)


def ordschur_work(n, nz, swaps, dtype):
    """Bytes and operations of one ordschur call: T, Z and the mask read
    once, T', Z' and sel' written once; each swap counted at its least size
    (two 1x1 blocks, m = 2): 2 m^2 operations an entry of the n + m entries
    of T's rows and columns it updates and of Z's nz rows (the 4 x 4 work
    left out)."""
    size = torch.empty((), dtype=dtype).element_size()
    return size * 2 * n * (n + nz) + 2 * n, swaps * 8 * (n + 2 + nz)


def ordschur_checks(dtype, cases, plain, out):
    """Phase 33 (a): the ordschur kernel against its plain version on
    ``cases``; rows into ``out["ordschur"]``.  Exact: sel', ok and the swap
    count.  Within ORDSCHUR_TOL: T' of ||T||_F, Z' (orthogonal), and the
    kernel's factorization Z' T' Z'^T = Z T Z^T and orthogonality."""
    for label, T, Z, mask in cases:
        got = [t.cpu() for t in hess_ops.ordschur(T, Z, mask)]
        want, plain_s, where = plain_result(plain, ("ordschur", label, dtype),
                                            lambda: hess_ops.ordschur_reference(T, Z, mask))
        (gT, gZ, gsel, gok, gsw), (pT, pZ, psel, pok, psw) = got, [t.cpu() for t in want]
        Tn, Zn = T.double().cpu().numpy(), Z.double().cpu().numpy()
        norm = float(np.linalg.norm(Tn))
        A = Zn @ Tn @ Zn.T
        G, GZ = gT.double().numpy(), gZ.double().numpy()
        d_t = float((gT.double() - pT.double()).abs().max())
        d_z = float((gZ.double() - pZ.double()).abs().max())
        fact = float(np.linalg.norm(GZ @ G @ GZ.T - A, 2) / np.linalg.norm(A, 2))
        orth = float(np.linalg.norm(GZ.T @ GZ - np.eye(len(GZ)), 2))
        row = dict(case=label, dtype=str(dtype), n=int(T.shape[0]), ok=bool(gok),
                   plain_ok=bool(pok), swaps=int(gsw), plain_swaps=int(psw),
                   selected=int(gsel.sum()), same_sel=bool(torch.equal(gsel, psel)),
                   t_err=d_t / norm, z_err=d_z, factorization=fact, orthogonality=orth,
                   max_abs_err=d_t, plain_s=plain_s, plain_on=where)
        out["ordschur"].append(row)
        print(f"ordschur {label} {dtype}: ok {row['ok']} (plain {row['plain_ok']}), "
              f"{row['swaps']} swaps (plain {row['plain_swaps']}), {row['selected']} selected, "
              f"sel' {'equal' if row['same_sel'] else 'DIFFERS'}; T' vs plain {row['t_err']:.2e} "
              f"of ||T||_F, Z' {d_z:.2e}, ||Z'T'Z'^T - ZTZ^T||/||T|| {fact:.2e}, "
              f"||Z'^TZ'-I|| {orth:.2e}; plain {plain_s:.2f} s on the {where}")
        tol = ORDSCHUR_TOL[dtype]
        check(row["same_sel"] and row["ok"] == row["plain_ok"]
              and row["swaps"] == row["plain_swaps"],
              f"ordschur {label} {dtype}: exact outputs differ: {row}")
        check(row["t_err"] <= tol and d_z <= tol and fact <= tol and orth <= tol,
              f"ordschur {label} {dtype}: T', Z' or the factorization off (gate {tol}): {row}")


def plain_on_host(kind, H, dtype, args):
    """Phase 33 (a)'s worker: the plain version of a kernel on the host, on
    ``H`` (float64 numpy) cast to ``dtype`` (its name), with ``args`` the
    Schur core's ``k_eff``, the filter's shifts ``(wr, wi, order, n,
    pure)`` as numpy arrays, the Ritz check's ``(wr, wi, ok, k_eff, p,
    nev, tol)``, or the reorder's ``(Z, mask)`` (``H`` its ``T``) ->
    ``(outputs as numpy arrays, seconds)``."""
    torch.set_num_threads(1)
    Ht = torch.from_numpy(H).to(getattr(torch, dtype))
    t0 = time.perf_counter()
    if kind == "schur":
        out = hess_ops.hessenberg_schur_reference(Ht, args, True, True)
    elif kind == "ritz":
        wr, wi, ok, k, p, nev, tol = args
        out = hess_ops.ritz_check_reference(Ht, torch.from_numpy(wr), torch.from_numpy(wi),
                                            torch.from_numpy(ok), k, tol, nev, p)
    elif kind == "ordschur":
        Z, mask = args
        out = hess_ops.ordschur_reference(Ht, torch.from_numpy(Z).to(Ht.dtype),
                                          torch.from_numpy(mask))
    else:
        out = hess_ops.francis_filter_sweeps_reference(Ht, *map(torch.from_numpy, args))
    seconds = time.perf_counter() - t0
    return [None if t is None else t.numpy() for t in out], seconds


def hessenberg_kernels(dev, tag):
    """Phase 33 (a): the Francis-QR, Ritz and ordschur kernels against their
    plain versions, f32 and f64; the check under set_sync_debug_mode("error").  The plain version of a
    Hessenberg input runs on the host, in PLAIN_WORKERS processes beside the
    kernels: its arithmetic is elementwise products and sums in a written
    order and numpy scalars, rounded alike on either device, so the host
    takes the card's sweeps and steps.  A dense input (the arrow form),
    whose reduction sums in the library's order, runs it on the card."""
    out = {"schur": [], "filter": [], "ritz": [], "ordschur": []}
    dtypes = (torch.float32, torch.float64)
    schur_cases = {dtype: schur_inputs(dtype) for dtype in dtypes}
    ordschur_cases = {dtype: [(f"arnoldi{n}_{kind}", *ordschur_input(dev, dtype, n, kind))
                              for n in ORDSCHUR_KDIMS for kind in ORDSCHUR_MASKS]
                      for dtype in dtypes}
    ritz_cases = {dtype: ritz_inputs() for dtype in dtypes}
    ritz_args = {}
    for dtype in dtypes:
        for label, He, k, p, nev, tol in ritz_cases[dtype]:
            kdim = He.shape[1]
            Hs = torch.from_numpy(He[:kdim]).to(dev, dtype)
            _, _, wr, wi, _, ok, _ = hess_ops.hessenberg_schur(Hs, k)
            ritz_args[label, dtype] = (He, [wr.cpu().numpy(), wi.cpu().numpy(),
                                            ok.cpu().numpy(), k, p, nev, tol])
    filter_cases = {}
    for dtype in dtypes:
        for kdim in FILTER_KDIMS:
            Hs = filter_hessenberg(kdim, seed=kdim)
            Ht = torch.from_numpy(Hs).to(dev, dtype)
            filter_cases[dtype, kdim] = Hs, Ht, hess._filter_shifts(Ht, kdim // 2)
    pool = ProcessPoolExecutor(PLAIN_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    try:
        jobs = [(H.shape[0], ("schur", label, dtype), ("schur", H, str(dtype)[6:], k))
                for dtype in dtypes for label, H, k in schur_cases[dtype]
                if not np.tril(H, -2).any()]
        jobs += [(kdim, ("filter", kdim, dtype),
                  ("filter", Hs, str(dtype)[6:], [t.cpu().numpy() for t in shifts[:5]]))
                 for (dtype, kdim), (Hs, _, shifts) in filter_cases.items()]
        jobs += [(He.shape[1], ("ritz", label, dtype), ("ritz", He, str(dtype)[6:], args))
                 for (label, dtype), (He, args) in ritz_args.items()]
        jobs += [(T.shape[0], ("ordschur", label, dtype),
                  ("ordschur", T.double().cpu().numpy(), str(dtype)[6:],
                   [Z.double().cpu().numpy(), mask.cpu().numpy()]))
                 for dtype in dtypes for label, T, Z, mask in ordschur_cases[dtype]]
        # the largest first, so that no worker starts a long case last
        plain = {key: pool.submit(plain_on_host, *args)
                 for _, key, args in sorted(jobs, key=lambda j: -j[0])}
        for dtype in dtypes:
            schur_checks(dev, dtype, schur_cases[dtype], plain, out)
            filter_checks(dtype, filter_cases, plain, out)
            ritz_checks(dev, dtype, ritz_cases, plain, out)
            ordschur_checks(dtype, ordschur_cases[dtype], plain, out)
        filter_prescale_checks(dev, out)
    finally:
        pool.shutdown(cancel_futures=True)
    for p in (1, 2):
        He = (arnoldi_hessenberg(MAIN_KDIM, seed=MAIN_KDIM) if p == 1
              else check_buffer("band", MAIN_KDIM, p, MAIN_KDIM))
        He = torch.from_numpy(He).to(dev, torch.float32)
        hess.hessenberg_ritz(He, MAIN_KDIM, 1e-6, 16, p=p)
        torch.cuda.synchronize()
        k = torch.full((), MAIN_KDIM - 3, device=dev)
        torch.cuda.set_sync_debug_mode("error")
        try:
            hess.hessenberg_ritz(He, k, 1e-6, 16, p=p)
            hess.hessenberg_ritz(He, MAIN_KDIM - 2, 1e-6, 16, p=p)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        print(f"hessenberg_ritz at kdim {MAIN_KDIM} f32, p = {p}, k_eff a 0-d tensor and an int, "
              "ran under set_sync_debug_mode('error'): no host round-trip in a check")
    return out


def bit_equal(got, want):
    """Outputs equal bit for bit: floats compared as integers of their width
    (-0.0 and 0.0 differ), absent outputs on both sides."""
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    return all((a is None and b is None) or torch.equal(
        a.view(ints.get(a.dtype, a.dtype)), b.view(ints.get(b.dtype, b.dtype)))
        for a, b in zip(got, want))


def lagging_warp_check(dev, tag, build_s):
    """Phase 33 (h): the lagging-warp build of the same sources
    (-DLK_LAG_WARP=1: one warp sleeps at the start of every stretch between
    two barriers; built in ``build_s`` seconds, in phase 2) against the
    shipping build, bit for bit, at LAG_NS in f32 and f64: the Schur kernel
    with Z and the split and without, the filter, the ordschur kernel on
    a random mask, and the Ritz kernel on an Arnoldi buffer (its register
    path) and a band with p = 2 (its general path).  A read that depends
    on which warp gets there first gives other outputs under the lag."""
    lib = _build.load_lagging()
    check(lib is not _build.load(), "the lagging-warp build replaced the shipping library")
    cases = {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype)[6:]
        for n in LAG_NS:
            A = np.triu(np.random.default_rng(n + 7).standard_normal((n, n)), -1)
            Ht = torch.from_numpy(A).to(dev, dtype)
            for with_z in (True, False):
                want = hess_ops.launch_schur(_build.load, Ht, n, with_z, with_z)
                got = hess_ops.launch_schur(_build.load_lagging, Ht, n, with_z, with_z)
                cases[f"schur{n}{'_z' if with_z else ''}_{name}"] = bit_equal(got, want)
            Hs = filter_hessenberg(n, seed=n + 3)
            Hs = torch.from_numpy(Hs).to(dev, dtype)
            wr, wi, order, nk, pure, _ = hess._filter_shifts(Hs, n // 2)
            want = hess_ops.launch_filter(_build.load, Hs, wr, wi, order, nk, pure)
            got = hess_ops.launch_filter(_build.load_lagging, Hs, wr, wi, order, nk, pure)
            cases[f"filter{n}_{name}"] = bit_equal(got, want)
            T, Z, mask = ordschur_input(dev, dtype, n, "random")
            want = hess_ops.launch_ordschur(_build.load, T, Z, mask)
            got = hess_ops.launch_ordschur(_build.load_lagging, T, Z, mask)
            cases[f"ordschur{n}_{name}"] = bit_equal(got, want) and int(want[4]) > 0
            for label, He, k, p in (("arnoldi", arnoldi_hessenberg(n, seed=n), n, 1),
                                    ("band", check_buffer("band", n, 2, n - 2), n - 2, 2)):
                He = torch.from_numpy(He).to(dev, dtype)
                _, _, wr, wi, _, ok, _ = hess_ops.hessenberg_schur(He[:n].contiguous(), k)
                want = hess_ops.launch_ritz(_build.load, He, wr, wi, k, ok, 1e-6, 16, p)
                got = hess_ops.launch_ritz(_build.load_lagging, He, wr, wi, k, ok, 1e-6, 16, p)
                cases[f"ritz_{label}{n}_{name}"] = bit_equal(got, want)
    torch.cuda.synchronize()
    print(f"{tag} lagging-warp build (-DLK_LAG_WARP=1) built in {build_s:.2f} s; outputs "
          f"bit-equal to the shipping kernels': {cases}")
    check(all(cases.values()), f"the lagging-warp build's outputs differ: {cases}")
    return dict(build_s=build_s, cases=cases)


def ritz_ms_of(He, wr, wi, ok, kdim):
    """The ritz_check wrapper's time on the card (the count's fill and the
    kernel; ten calls a sample queued behind a spacer, so the host's ~60 us
    a call stays out) and a call's (CUDA events around one call), ms."""
    def call():
        return hess_ops.ritz_check(He, wr, wi, ok, kdim, 1e-6, 16)

    device = alternating_ms({"ritz": call}, runs=10, per_run=10, spacer=True)["ritz"]
    return device, median_ms(lambda i: call(), runs=10)


def host_clock(fn, reps=10):
    """Host-clock ms a call of ``fn`` (the device's work included), over
    ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def ordschur_times(dev, tag):
    """Phase 33 (g): the ordschur kernel alone (ten calls a sample behind a
    spacer) and a call with its host time (CUDA events around one call) at
    ORDSCHUR_TIME_KDIMS, on the Schur kernel's form of the Arnoldi
    Hessenberg with a seeded random mask, with its swaps, us a swap and its
    bound; beside it the plain version on the card (one call) and the host
    path's reorder: (T, Z) read to the host, LAPACK TRSEN
    (utils.linalg.ordschur) and the copy back.  No PyTorch call reorders a
    Schur form."""
    rows = {}
    for dtype in (torch.float32, torch.float64):
        for n in ORDSCHUR_TIME_KDIMS:
            T, Z, mask = ordschur_input(dev, dtype, n, "random")

            def call():
                return hess_ops.ordschur(T, Z, mask)

            def host_path():
                Ts, Zs = lt.utils.linalg.ordschur(T.cpu().numpy(), Z.cpu().numpy(),
                                                  mask.cpu().numpy())
                return torch.from_numpy(Ts).to(dev), torch.from_numpy(Zs).to(dev)

            swaps = int(call()[4])
            ms = alternating_ms({"ordschur": call}, runs=10, per_run=10, spacer=True)["ordschur"]
            call_ms = median_ms(lambda i: call(), runs=10)
            plain_ms = host_clock(lambda: hess_ops.ordschur_reference(T, Z, mask), reps=1)
            host_ms = host_clock(host_path)
            bound, bound_by = bound_of(*ordschur_work(n, n, swaps, dtype), dtype)
            geo = hess_ops.ordschur_geometry(n, n, T.element_size())
            where = dict(warps=geo.warps, t="shared" if geo.h_smem else "global",
                         z="shared" if geo.z_smem else "global")
            row = dict(ms=ms, call_ms=call_ms, swaps=swaps, us_a_swap=ms * 1e3 / max(swaps, 1),
                       bound_ms=bound, bound_by=bound_by, plain_ms=plain_ms, host_path_ms=host_ms,
                       geometry=where)
            rows[f"{n}_{str(dtype)[6:]}"] = row
            print(f"{tag} ordschur kdim {n} {dtype}: {ms:.3f} ms on the card, {call_ms:.3f} ms a "
                  f"call, {swaps} swaps, {row['us_a_swap']:.3f} us a swap (bound "
                  f"{bound * 1e3:.3f} us by {bound_by}; {where}); plain on the card "
                  f"{plain_ms:.1f} ms; host path (read, TRSEN, copy back) {host_ms:.3f} ms")
    return rows


def kernel_turns(dev, tag):
    """Phase 33 (g): the Ritz kernel (with the count's fill; Arnoldi
    buffers at TURN_RITZ_KDIMS) and the ordschur kernel (a random mask at
    ORDSCHUR_TIME_KDIMS) beside the parent commit's kernels, built from its
    sources in PARENT_DIR, on the same inputs: ten calls a sample behind a
    spacer, the two alternating sample by sample, in two rounds (parent
    first, then this tree first), each side the mean of its two medians.
    None, and said so, without the parent's tree."""
    parent = parent_ops()
    if parent is None:
        print(f"{tag} no parent tree at {PARENT_DIR}: the kernels are not timed in turns with "
              "the parent's")
        return None
    p_ops = parent[0]
    rows = {}

    def turns(key, fns, per_swap=1):
        got = {"parent": [], "change": []}
        for order in (("parent", "change"), ("change", "parent")):
            ms = alternating_ms({k: fns[k] for k in order}, runs=10, per_run=10, spacer=True)
            for k in order:
                got[k].append(ms[k])
        row = {f"{k}_ms": statistics.mean(v) for k, v in got.items()}
        row.update({f"{k}_rounds_ms": v for k, v in got.items()})
        row["change_over_parent"] = row["change_ms"] / row["parent_ms"]
        if per_swap > 1:
            row.update(swaps=per_swap, parent_us_a_swap=row["parent_ms"] * 1e3 / per_swap,
                       change_us_a_swap=row["change_ms"] * 1e3 / per_swap)
        rows[key] = row
        print(f"{tag} turns {key}: parent {row['parent_ms']:.4f} ms {got['parent']}, this tree "
              f"{row['change_ms']:.4f} ms {got['change']} ({row['change_over_parent']:.3f}x)"
              + (f", {row['parent_us_a_swap']:.3f} -> {row['change_us_a_swap']:.3f} us a swap"
                 if per_swap > 1 else ""))

    for dtype in (torch.float32, torch.float64):
        name = str(dtype)[6:]
        for kdim in TURN_RITZ_KDIMS:
            He = torch.from_numpy(arnoldi_hessenberg(kdim, seed=kdim)).to(dev, dtype)
            wr, wi, ok = hess.hessenberg_eigvals(He[:kdim].contiguous(), kdim)
            want = hess_ops.ritz_check(He, wr, wi, ok, kdim, 1e-6, 16)
            got = p_ops.ritz_check(He, wr, wi, ok, kdim, 1e-6, 16)
            check(torch.equal(got[0], want[0]) and torch.equal(got[5], want[5]),
                  f"ritz_check kdim {kdim} {dtype}: the parent's values or count differ")
            turns(f"ritz{kdim}_{name}",
                  {"parent": lambda: p_ops.ritz_check(He, wr, wi, ok, kdim, 1e-6, 16),
                   "change": lambda: hess_ops.ritz_check(He, wr, wi, ok, kdim, 1e-6, 16)})
        for n in ORDSCHUR_TIME_KDIMS:
            T, Z, mask = ordschur_input(dev, dtype, n, "random")
            want = hess_ops.ordschur(T, Z, mask)
            got = p_ops.ordschur(T, Z, mask)
            check(bit_equal(got, want), f"ordschur kdim {n} {dtype}: the parent's outputs differ")
            turns(f"ordschur{n}_{name}", {"parent": lambda: p_ops.ordschur(T, Z, mask),
                                          "change": lambda: hess_ops.ordschur(T, Z, mask)},
                  per_swap=int(want[4]))
    return rows


def hessenberg_times(dev, tag):
    """Phase 33 (g): a check of hessenberg_ritz, the Schur kernel and the
    filter kernel alone, and the plain Schur core, at the kdims of the table,
    beside the host path's read plus numpy eig and torch.linalg.eigvals on the
    device; the Ritz kernel alone (with the count's fill) and its plain
    version, beside torch.linalg.eig on the card, at the same kdims and at
    LARGE_KDIMS."""
    rows = {}
    for dtype in (torch.float32, torch.float64):
        for kdim in RITZ_KDIMS:
            He = torch.from_numpy(arnoldi_hessenberg(kdim, seed=kdim)).to(dev, dtype)
            Hs = He[:kdim, :kdim].contiguous()
            ritz_ms = median_ms(lambda i: hess.hessenberg_ritz(He, kdim, 1e-6, 16), runs=10)
            schur_ms = median_ms(lambda i: hess_ops.hessenberg_schur(Hs, kdim), runs=10)
            schur_z_ms = median_ms(lambda i: hess_ops.hessenberg_schur(Hs, kdim, True, True),
                                   runs=10)
            _, _, _, _, _, _, work = hess_ops.hessenberg_schur(Hs, kdim)
            wr, wi, order, n, pure, _ = hess._filter_shifts(Hs, kdim // 2)
            filt_ms = median_ms(lambda i: hess_ops.francis_filter_sweeps(Hs, wr, wi, order, n,
                                                                         pure), runs=10)
            _, _, fwork = hess_ops.francis_filter_sweeps(Hs, wr, wi, order, n, pure)

            host_ms = host_clock(lambda: np.linalg.eig(Hs.cpu().numpy()))
            lib_ms = host_clock(lambda: torch.linalg.eigvals(Hs))
            eig_ms = host_clock(lambda: torch.linalg.eig(Hs))
            wr_s, wi_s, ok_s = hess.hessenberg_eigvals(Hs, kdim)
            rk_ms, rk_call_ms = ritz_ms_of(He, wr_s, wi_s, ok_s, kdim)
            rk_plain_ms = host_clock(lambda: hess_ops.ritz_check_reference(
                He, wr_s, wi_s, ok_s, kdim, 1e-6, 16), reps=1)
            rk_bound, rk_bound_by = bound_of(*ritz_work(He.cpu().numpy(), kdim, 1, dtype), dtype)
            plain_ms = host_clock(lambda: hess_ops.hessenberg_schur_reference(Hs, kdim), reps=1)
            fplain_ms = host_clock(lambda: hess_ops.francis_filter_sweeps_reference(
                Hs, wr, wi, order, n, pure), reps=1)
            sweeps, steps = int(work[0]), int(work[1])
            nbytes, flops = schur_work(kdim, steps, False, dtype)
            bound, bound_by = bound_of(nbytes, flops, dtype)
            zbound, _ = bound_of(*schur_work(kdim, steps, True, dtype), dtype)
            fsteps = int(fwork[1])
            fbound, fbound_by = bound_of(*filter_work(kdim, fsteps, dtype), dtype)
            row = dict(ritz_ms=ritz_ms, schur_ms=schur_ms, schur_plain_ms=plain_ms,
                       sweeps=sweeps, steps=steps, us_a_step=schur_ms * 1e3 / max(steps, 1),
                       bound_ms=bound, bound_by=bound_by, schur_z_ms=schur_z_ms,
                       z_bound_ms=zbound, filter_ms=filt_ms, filter_plain_ms=fplain_ms,
                       filter_sweeps=int(fwork[0]), filter_steps=fsteps,
                       filter_us_a_step=filt_ms * 1e3 / max(fsteps, 1), filter_bound_ms=fbound,
                       filter_bound_by=fbound_by, host_read_eig_ms=host_ms, eigvals_ms=lib_ms,
                       ritz_kernel_ms=rk_ms, ritz_call_ms=rk_call_ms, ritz_plain_ms=rk_plain_ms,
                       ritz_bound_ms=rk_bound,
                       ritz_bound_by=rk_bound_by, eig_ms=eig_ms,
                       ritz_geometry=hess_ops.ritz_geometry(kdim, Hs.element_size())._asdict())
            rows[f"{kdim}_{str(dtype)[6:]}"] = row
            print(f"{tag} kdim {kdim} {dtype}: hessenberg_ritz check {ritz_ms:.3f} ms; "
                  f"hessenberg_schur {schur_ms:.3f} ms ({sweeps} sweeps, {steps} chase steps, "
                  f"{row['us_a_step']:.3f} us a step; bound {bound * 1e3:.3f} us by "
                  f"{bound_by}), with Z and the split {schur_z_ms:.3f} ms "
                  f"({schur_z_ms / schur_ms:.2f}x; bound {zbound * 1e3:.3f} us), plain "
                  f"{plain_ms:.1f} ms; francis_filter_sweeps {filt_ms:.3f} ms "
                  f"({row['filter_sweeps']} sweeps, {fsteps} steps, "
                  f"{row['filter_us_a_step']:.3f} us a step; bound {fbound * 1e3:.3f} us), plain "
                  f"{fplain_ms:.1f} ms; ritz_check (the count's fill and the kernel) "
                  f"{rk_ms:.3f} ms on the card, {rk_call_ms:.3f} ms a call (bound "
                  f"{rk_bound * 1e3:.3f} us by {rk_bound_by}), plain "
                  f"{rk_plain_ms:.1f} ms; host read + numpy eig {host_ms:.3f} ms; "
                  f"torch.linalg.eigvals {lib_ms:.3f} ms; torch.linalg.eig {eig_ms:.3f} ms")
    for dtype in (torch.float32, torch.float64):
        for n in LARGE_KDIMS:
            He_np = arnoldi_hessenberg(n, seed=n, real=3.0 if n % 2 else None)
            He = torch.from_numpy(He_np).to(dev, dtype)
            Hs = He[:n].contiguous()
            schur_ms = median_ms(lambda i: hess_ops.hessenberg_schur(Hs, n), runs=10)
            schur_z_ms = median_ms(lambda i: hess_ops.hessenberg_schur(Hs, n, True, True),
                                   runs=10)
            work = hess_ops.hessenberg_schur(Hs, n)[6]
            wr, wi, order, nk, pure, _ = hess._filter_shifts(Hs, n // 2)
            filt_ms = median_ms(lambda i: hess_ops.francis_filter_sweeps(Hs, wr, wi, order, nk,
                                                                         pure), runs=10)
            fwork = hess_ops.francis_filter_sweeps(Hs, wr, wi, order, nk, pure)[2]
            steps, fsteps = int(work[1]), int(fwork[1])
            wr_s, wi_s, ok_s = hess.hessenberg_eigvals(Hs, n)
            rk_ms, rk_call_ms = ritz_ms_of(He, wr_s, wi_s, ok_s, n)
            ritz_ms = median_ms(lambda i: hess.hessenberg_ritz(He, n, 1e-6, 16), runs=5)
            rk_bound, rk_bound_by = bound_of(*ritz_work(He_np, n, 1, dtype), dtype)
            host_ms = host_clock(lambda: np.linalg.eig(Hs.cpu().numpy()))
            lib_ms = host_clock(lambda: torch.linalg.eigvals(Hs))
            eig_ms = host_clock(lambda: torch.linalg.eig(Hs))
            bound, bound_by = bound_of(*schur_work(n, steps, False, dtype), dtype)
            zbound, _ = bound_of(*schur_work(n, steps, True, dtype), dtype)
            fbound, fbound_by = bound_of(*filter_work(n, fsteps, dtype), dtype)
            size = Hs.element_size()
            geo = {"schur": hess_ops.geometry(n, size, False),
                   "schur_z": hess_ops.geometry(n, size, True),
                   "filter": hess_ops.geometry(n, size, True, schur=False)}
            where = {k: dict(warps=g.warps, rows_a_thread=-(-n // (32 * g.warps)),
                             h=("shared" if g.h_smem else "global"),
                             **({} if k == "schur" else
                                {"z": "shared" if g.z_smem else "global"}))
                     for k, g in geo.items()}
            row = dict(schur_ms=schur_ms, sweeps=int(work[0]), steps=steps,
                       us_a_step=schur_ms * 1e3 / max(steps, 1), bound_ms=bound,
                       bound_by=bound_by, schur_z_ms=schur_z_ms, z_bound_ms=zbound,
                       filter_ms=filt_ms, filter_sweeps=int(fwork[0]), filter_steps=fsteps,
                       filter_us_a_step=filt_ms * 1e3 / max(fsteps, 1), filter_bound_ms=fbound,
                       filter_bound_by=fbound_by, geometry=where, ritz_ms=ritz_ms,
                       ritz_kernel_ms=rk_ms, ritz_call_ms=rk_call_ms, ritz_bound_ms=rk_bound,
                       ritz_bound_by=rk_bound_by,
                       ritz_geometry=hess_ops.ritz_geometry(n, size)._asdict(),
                       host_read_eig_ms=host_ms, eigvals_ms=lib_ms, eig_ms=eig_ms)
            rows[f"{n}_{str(dtype)[6:]}"] = row
            print(f"{tag} kdim {n} {dtype}: hessenberg_schur {schur_ms:.3f} ms ({row['sweeps']} "
                  f"sweeps, {steps} chase steps, {row['us_a_step']:.3f} us a step; bound "
                  f"{bound * 1e3:.3f} us by {bound_by}), with Z and the split {schur_z_ms:.3f} ms "
                  f"(bound {zbound * 1e3:.3f} us); francis_filter_sweeps {filt_ms:.3f} ms "
                  f"({row['filter_sweeps']} sweeps, {fsteps} steps, "
                  f"{row['filter_us_a_step']:.3f} us a step; bound {fbound * 1e3:.3f} us); "
                  f"geometry {where}; hessenberg_ritz check {ritz_ms:.3f} ms, ritz_check "
                  f"{rk_ms:.3f} ms on the card, {rk_call_ms:.3f} ms a call (bound "
                  f"{rk_bound * 1e3:.3f} us by {rk_bound_by}; "
                  f"{row['ritz_geometry']}); host read + numpy eig {host_ms:.3f} ms; "
                  f"torch.linalg.eigvals {lib_ms:.3f} ms; torch.linalg.eig {eig_ms:.3f} ms")
    rows["wrapper"] = wrapper_cost(dev, tag)
    return rows


# one hessenberg_schur call under torch.profiler, in a fresh process: the
# profiler records the card's kernels only the first time a process uses it
LAUNCH_PROBE = """
import json
import numpy as np
import torch
from lightkrylov_tpu_torch.ops import hessenberg as kernels
n = {n}
H = torch.from_numpy(np.triu(np.random.default_rng(0).standard_normal((n, n)), -1))
H = H.to("cuda", torch.float32)
keff = torch.full((), n, dtype=torch.int32, device="cuda")
for _ in range(3):
    kernels.hessenberg_schur(H, keff)
torch.cuda.synchronize()
acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
with torch.profiler.profile(activities=acts) as prof:
    kernels.hessenberg_schur(H, keff)
    torch.cuda.synchronize()
print(json.dumps([e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]))
"""


# checks of hessenberg_ritz under torch.profiler in a fresh process, with
# k_eff a 0-d tensor on the card: at RITZ_KDIMS in f32 and f64 (p = 1) and at
# MAIN_KDIM with p = 2, each once after two warm calls, a synchronise between
CHECK_PROBE = """
import json
import numpy as np
import torch
from lightkrylov_tpu_torch.utils import hessenberg as hess
cases = {cases}
inputs = []
for kdim, dt, p in cases:
    He = np.triu(np.random.default_rng(kdim).standard_normal((kdim + p, kdim)), -p)
    inputs.append((torch.from_numpy(He).to("cuda", getattr(torch, dt)),
                   torch.full((), kdim - 1, device="cuda"), p))
for He, k, p in inputs:
    for _ in range(2):
        hess.hessenberg_ritz(He, k, 1e-6, 16, p=p)
torch.cuda.synchronize()
acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
with torch.profiler.profile(activities=acts) as prof:
    for He, k, p in inputs:
        hess.hessenberg_ritz(He, k, 1e-6, 16, p=p)
        torch.cuda.synchronize()
print(json.dumps([e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]))
"""


def check_launches(tag):
    """The device activities of the checks of CHECK_PROBE: a check is the
    Schur kernel, one fill (the count) and the Ritz kernel."""
    cases = [(kdim, dt, 1) for dt in ("float32", "float64") for kdim in RITZ_KDIMS]
    cases.append((MAIN_KDIM, "float32", 2))
    proc = subprocess.run([sys.executable, "-c", CHECK_PROBE.format(cases=cases)],
                          capture_output=True, text=True, timeout=300,
                          cwd=Path(__file__).resolve().parent)
    check(proc.returncode == 0, f"the check probe failed: {proc.stderr[-2000:]}")
    names = json.loads(proc.stdout.strip().splitlines()[-1])
    schur = sum("schur_kernel" in x for x in names)
    ritz = sum("ritz_kernel" in x for x in names)
    other = [x for x in names if "schur_kernel" not in x and "ritz_kernel" not in x]
    n = len(cases)
    print(f"{tag} {n} hessenberg_ritz checks (kdim {RITZ_KDIMS} f32 and f64, and {MAIN_KDIM} "
          f"with p = 2) under torch.profiler: {len(names)} device activities, {schur} Schur "
          f"kernels, {ritz} Ritz kernels, others {sorted(set(other))} x {len(other)}: "
          f"{len(names) / n:.2f} a check")
    check(schur == ritz == n and len(other) <= n,
          f"a check launched more than the Schur kernel, a fill and the Ritz kernel: {names}")
    return dict(checks=n, activities=len(names), a_check=len(names) / n, schur=schur, ritz=ritz,
                other=len(other), other_names=sorted(set(other)))


def wrapper_cost(dev, tag):
    """The Schur wrapper's launches in one call with k_eff a 0-d int32 on the
    card (torch.profiler in a fresh process, which imports the package from
    this checkout: its kernel and nothing else), and the host us a call of
    each wrapper, HOST_US_CALLS calls in a row, beside clone's."""
    He = torch.from_numpy(arnoldi_hessenberg(MAIN_KDIM, seed=MAIN_KDIM)).to(dev, torch.float32)
    Hs = He[:MAIN_KDIM, :MAIN_KDIM].contiguous()
    k32 = torch.full((), MAIN_KDIM, dtype=torch.int32, device=dev)
    wr, wi, order, n, pure, _ = hess._filter_shifts(Hs, MAIN_KDIM // 2)
    wr_s, wi_s, ok_s = hess.hessenberg_eigvals(Hs, k32)
    calls = {"hessenberg_schur": lambda: hess_ops.hessenberg_schur(Hs, k32),
             "francis_filter_sweeps": lambda: hess_ops.francis_filter_sweeps(Hs, wr, wi, order,
                                                                             n, pure),
             "ritz_check": lambda: hess_ops.ritz_check(He, wr_s, wi_s, ok_s, k32, 1e-6, 16),
             "clone": lambda: Hs.clone()}
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    proc = subprocess.run([sys.executable, "-c", LAUNCH_PROBE.format(n=MAIN_KDIM)],
                          capture_output=True, text=True, timeout=300,
                          cwd=Path(__file__).resolve().parent)
    check(proc.returncode == 0, f"the launch probe failed: {proc.stderr[-2000:]}")
    lines = proc.stdout.strip().splitlines()
    kernels = json.loads(lines[-1]) if proc.returncode == 0 and lines else []
    print(f"{tag} hessenberg_schur with an int32 k_eff on the card: device activities in "
          f"one call {kernels}")
    check(len(kernels) == 1 and "schur_kernel" in kernels[0],
          f"hessenberg_schur launched {kernels}, not its kernel alone")
    out = {"schur_call_kernels": kernels, "check_launches": check_launches(tag)}
    for name, fn in calls.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_US_CALLS):
            fn()
        out[f"{name}_host_us"] = (time.perf_counter() - t0) / HOST_US_CALLS * 1e6
        torch.cuda.synchronize()
    print(f"{tag} host us a call, {HOST_US_CALLS} in a row: hessenberg_schur "
          f"{out['hessenberg_schur_host_us']:.1f}, francis_filter_sweeps "
          f"{out['francis_filter_sweeps_host_us']:.1f}, ritz_check "
          f"{out['ritz_check_host_us']:.1f}, clone {out['clone_host_us']:.1f}")
    return out


def device_projected_path(dev, tag, results):
    """Phase 33 (b)-(f): gl512, eigs_3072, the non-normal eigs through K3
    (IRAM restarts, then a custom selector), eighs_3072, svds_3072 and
    eigs_3072_block under projected="device", each against its host-path
    phase."""
    out = {}
    eigs_mod = importlib.import_module("lightkrylov_tpu_torch.solvers.eigs")
    dev_opts = dict(projected="device")

    # (b) gl512: the main path of this phase
    gl = lt.GinzburgLandauReal(N_GL, dtype=torch.float32, device=dev)
    prop = lt.GLPropagator(gl, tau=0.01, n_steps=10)
    x0 = seeded((2, N_GL), torch.float32, dev, seed=11)
    opts = lt.EigsOptions(maxiter=200, **dev_opts)

    def solve():
        res = lt.eigs(prop, 16, x0=x0, kdim=40, tolerance=GL_TOL, options=opts)
        torch.cuda.synchronize()
        return res

    t0 = time.perf_counter()
    solve()
    t_first = time.perf_counter() - t0
    lt.timer.reset_counters()
    kernels = ("hessenberg_schur", "francis_filter_sweeps", "ritz_check")
    before = {name: launch_count(name) for name in kernels}
    t0 = time.perf_counter()
    w, V, r, info, meta = solve()
    t_warm = time.perf_counter() - t0
    launches = {name: launch_count(name) - before[name] for name in kernels}
    c = lt.timer.get_counter
    checks, reads = c("ritz_checks"), c("host_reads")
    restarts = {k: c(f"restarts.eigs.{k}") for k in ("iram", "schur_device", "host")}
    stride = eigs_mod._AdaptiveStride.chosen.get("eigs")
    host13 = results["gl512"]
    print(f"gl512 device: eigs(16, kdim=40, projected='device') of GLPropagator("
          f"GinzburgLandauReal({N_GL}) f32): info={info}, {meta.n_iter} matvecs (host path, "
          f"phase 13: {host13['matvecs']}), adaptive stride {stride}, {checks} checks, "
          f"{reads} host reads ({reads / max(checks, 1):.2f} a check, "
          f"{reads / meta.n_iter:.3f} a matvec), restarts {restarts}, QR host redos "
          f"{c('qr_host_redos')}, launches {launches}")
    check(info > 0, f"gl512 device eigs reported non-convergence: info={info}")
    gl_out = gl_checks(gl, V, r, 16, conj_too=True, budget=flagship_budget)
    print(f"gl512 device: {gl_out['n_conv']}/16 converged, max true eigen-residual "
          f"{gl_out['max_true_residual']:.2e}, anchor devs "
          f"{['%.1e' % d for d in gl_out['anchor_devs']]} within budgets "
          f"{['%.1e' % b for b in gl_out['anchor_budgets']]}")
    print(f"{tag} gl512 device solve: warm {t_warm:.3f} s (first {t_first:.3f} s); phase 13's "
          f"host-path warm solve {host13['warm_s']:.3f} s")
    check(gl_out["n_conv"] == 16, f"gl512 device: {gl_out['n_conv']}/16 converged")
    check(c("qr_host_redos") == 0, "gl512 device: a check was redone on the host")
    check(restarts["host"] == 0, f"gl512 device: host restarts {restarts}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path (gl512 device)")
    check(launches["ritz_check"] == checks,
          f"gl512 device: {launches['ritz_check']} Ritz kernel launches for {checks} checks")
    out["gl512"] = dict(info=info, matvecs=meta.n_iter, host_matvecs=host13["matvecs"],
                        stride=stride, checks=checks, host_reads=reads, restarts=restarts,
                        qr_host_redos=c("qr_host_redos"), launches=launches, warm_s=t_warm,
                        first_s=t_first, host_warm_s=host13["warm_s"], **gl_out)
    del V

    n = N_EIGHS
    h = 1.0 / (n + 1)
    lam_max = (2.0 / h**2) * (2.0 - 2.0 * np.cos(np.pi * n * h))
    op = lt.CudaPoisson2D(n, dtype=torch.float32, device=dev)
    x7 = seeded((n, n), torch.float32, dev, seed=7)
    one = lt.EigsOptions(maxiter=1, **dev_opts)

    def counted(fn):
        kernels = {"single": ("stencil_matvec", "stencil_matvec_2d"),
                   "batched": ("stencil_matvec_batched",),
                   "hessenberg_schur": ("hessenberg_schur",), "ritz_check": ("ritz_check",)}
        lt.timer.reset_counters()
        before = {key: launch_count(*names) for key, names in kernels.items()}
        res = fn()
        torch.cuda.synchronize()
        return res, dict(**{key: launch_count(*names) - before[key]
                            for key, names in kernels.items()},
                         checks=c("ritz_checks"), host_reads=c("host_reads"),
                         library_syncs=c("library_syncs"))

    # (c) eigs_3072
    (w, V, r, info, meta), k = counted(lambda: lt.eigs(op, 4, x0=x7, kdim=32, tolerance=0.0,
                                                      options=one))
    ref = np.array([complex(*z) for z in results["eigs_3072"]["ritz"]])
    d = match_dist(w, ref) / lam_max
    print(f"eigs_3072 device: {k['single']} stencil launches, {k['hessenberg_schur']} "
          f"hessenberg_schur, {k['checks']} checks, {k['host_reads']} host reads "
          f"({k['host_reads'] / max(k['checks'], 1):.2f} a check) for {meta.n_iter} steps; Ritz "
          f"values {w}; against phase 15's max |dw| / lambda_max = {d:.3e}")
    check(k["single"] == meta.n_iter == 32, f"eigs_3072 device: {k['single']} launches")
    check(bool(torch.isfinite(V).all()) and d <= 1e-5, f"eigs_3072 device Ritz values off {d:.3e}")
    out["eigs_3072"] = dict(launches=k, rel_diff=d)
    del V

    # (e) eighs_3072 and svds_3072
    (w, V, r, info, meta), k = counted(lambda: lt.eighs(op, 4, x0=x7, kdim=32, tolerance=0.0,
                                                       options=one))
    d = float(np.abs(w - np.array(results["eighs_3072"]["ritz"])).max() / lam_max)
    print(f"eighs_3072 device: {k['single']} stencil launches, {k['checks']} checks, "
          f"{k['host_reads']} host reads and {k['library_syncs']} eigh syncs "
          f"({(k['host_reads'] + k['library_syncs']) / max(k['checks'], 1):.2f} a check) for "
          f"{meta.n_iter} steps; against phase 10's max |dw| / lambda_max = {d:.3e}")
    check(k["single"] == meta.n_iter == 32 and d <= 1e-5, f"eighs_3072 device: {k}, {d:.3e}")
    out["eighs_3072"] = dict(launches=k, rel_diff=d)
    del V
    u0 = seeded((n, n), torch.float32, dev, seed=16)
    (U, S, V, r, info, meta), k = counted(lambda: lt.svds(
        op, 4, u0=u0, kdim=32, tolerance=0.0, options=lt.SVDSOptions(maxiter=1, **dev_opts)))
    sig = np.array(results["svds_3072"]["sigma"])
    d = float(np.abs(S - sig).max() / sig[0])
    print(f"svds_3072 device: {k['single']} stencil launches, {k['checks']} checks, "
          f"{k['host_reads']} host reads and {k['library_syncs']} svd syncs for {meta.n_iter} "
          f"steps; against phase 19's max |ds| / s_1 = {d:.3e}")
    check(k["single"] == 64 and meta.n_iter == 32 and d <= 1e-5, f"svds_3072 device: {k}, {d:.3e}")
    out["svds_3072"] = dict(launches=k, rel_diff=d)
    del U, V

    # (f) eigs_3072_block
    (w, V, r, info, meta), k = counted(lambda: lt.eigs(op, 4, x0=x7, kdim=32, tolerance=0.0,
                                                      blksize=2, options=one))
    ref = np.array([complex(*z) for z in results["block_eigs"]["eigs_3072_block"]["ritz"]])
    d = match_dist(w, ref) / lam_max
    print(f"eigs_3072_block device: {k['batched']} batched and {k['single']} single stencil "
          f"launches, {k['hessenberg_schur']} hessenberg_schur, {k['checks']} checks; against "
          f"phase 29b's max |dw| / lambda_max = {d:.3e}")
    check(k["batched"] == 16 and k["single"] == 0 and d <= 1e-5,
          f"eigs_3072_block device: {k}, {d:.3e}")
    out["eigs_3072_block"] = dict(launches=k, rel_diff=d)
    del V
    torch.cuda.empty_cache()

    out.update(convdiff_device_solves(dev, tag, results))
    return out


def convdiff_device_solves(dev, tag, results):
    """Phase 33 (d): the non-normal eigs f64 through K3 under
    projected="device", with IRAM restarts, then with a custom selector
    through the device Schur restart (the Schur kernel, the ordschur kernel
    and the restart's small ops), each beside the same solve on the host
    path; the custom solve's reorder timed by its span
    (krylov_schur.ordschur_device, device work included), then the same
    solve with the plain reorder on the card (host reads each swap)."""
    out = {}
    c = lt.timer.get_counter
    dev_opts = dict(projected="device")
    cd = lt.ConvectionDiffusion2D(64)
    A = cd.dense().numpy()
    op_b = lt.BellOperator(lt.bell_from_scipy(A, dtype=np.float64, device=dev))
    x14 = seeded((64 * 64,), torch.float64, dev, seed=14)
    span = lt.timer.global_watch.add_timer("krylov_schur.ordschur_device", "BaseKrylov")

    def true_res(w, V):
        Vh = V.cpu().numpy()
        return max(float(np.linalg.norm(A @ Vh[i] - w[i] * Vh[i]) / np.linalg.norm(Vh[i]))
                   for i in range(len(w)))

    def convdiff_solve(select, **opts):
        t0 = time.perf_counter()
        w, V, r, info, meta = lt.eigs(op_b, 6, x0=x14, kdim=30, tolerance=1e-10, select=select,
                                      options=lt.EigsOptions(maxiter=100, **opts))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        lt.timer.spans()  # read the device spans' events into their timers
        return w, V, info, meta, secs

    median_select = lambda v: np.abs(v) > np.median(np.abs(v))  # noqa: E731
    kernels = ("bell_spmv", "hessenberg_schur", "francis_filter_sweeps", "ritz_check", "ordschur")
    for label, select in (("iram", None), ("custom", median_select)):
        lt.timer.reset_counters()
        before = {name: launch_count(name) for name in kernels}
        span0 = (span.etime, span.count)
        lt.timer.set_timing(select is not None)
        try:
            w, V, info, meta, secs = convdiff_solve(select, **dev_opts)
        finally:
            lt.timer.set_timing(False)
        res = true_res(w, V)
        restarts = {k_: c(f"restarts.eigs.{k_}") for k_ in ("iram", "schur_device", "host")}
        row = dict(info=info, matvecs=meta.n_iter,
                   **{name: launch_count(name) - before[name] for name in kernels},
                   restarts=restarts, ordschur_reads=c("ordschur_reads"),
                   host_reads=c("host_reads"), checks=c("ritz_checks"),
                   max_true_residual=res, seconds=secs)
        if select is not None:
            row["reorder_span_s"] = span.etime - span0[0]
            row["reorder_spans"] = span.count - span0[1]
        _, _, hinfo, hmeta, hsecs = convdiff_solve(select)
        row.update(host_path_seconds=hsecs, host_path_info=hinfo, host_path_matvecs=hmeta.n_iter)
        out[f"convdiff_{label}"] = row
        share = (f", the reorder's span {row['reorder_span_s']:.3f} s in {row['reorder_spans']} "
                 f"restarts ({row['reorder_span_s'] / secs:.1%} of the solve, timing on)"
                 if select is not None else "")
        print(f"{tag} eigs f64 ConvectionDiffusion2D(64) through Block-ELL, device, {label}: "
              f"info={info}, {meta.n_iter} matvecs (phase 16: "
              f"{results['eigs_nonnormal']['matvecs']}), {row['bell_spmv']} bell_spmv, restarts "
              f"{restarts}, {row['ordschur_reads']} ordschur host reads, {row['host_reads']} host "
              f"reads, {row['checks']} checks, launches hessenberg_schur {row['hessenberg_schur']} "
              f"francis_filter_sweeps {row['francis_filter_sweeps']} ritz_check "
              f"{row['ritz_check']} ordschur {row['ordschur']}, max true residual / |lambda_1| "
              f"{res / abs(w[0]):.3e}, {secs:.2f} s{share}; the host path's solve (info={hinfo}, "
              f"{hmeta.n_iter} matvecs) {hsecs:.2f} s")
        check(info == 6 and res <= 1e-8 * abs(w[0]), f"convdiff device {label}: {row}")
        check(row["bell_spmv"] >= meta.n_iter, f"convdiff device {label}: bell_spmv launches")
        check(restarts["iram" if select is None else "schur_device"] > 0,
              f"convdiff device {label}: restarts {restarts}")
        check(row["ordschur_reads"] == 0, f"convdiff device {label}: ordschur host reads {row}")
        check(row["ordschur"] == restarts["schur_device"],
              f"convdiff device {label}: {row['ordschur']} ordschur launches for "
              f"{restarts['schur_device']} device Schur restarts")
    # the custom solve with the plain reorder on the card, its span beside
    kernel_ordschur = hess_ops.ordschur
    hess_ops.ordschur = hess_ops.ordschur_reference
    lt.timer.reset_counters()
    span0 = (span.etime, span.count)
    lt.timer.set_timing(True)
    try:
        w, V, info, meta, secs = convdiff_solve(median_select, **dev_opts)
    finally:
        lt.timer.set_timing(False)
        hess_ops.ordschur = kernel_ordschur
    res = true_res(w, V)
    row = dict(info=info, matvecs=meta.n_iter, seconds=secs, max_true_residual=res,
               ordschur_reads=c("ordschur_reads"), reorder_span_s=span.etime - span0[0],
               reorder_spans=span.count - span0[1])
    out["convdiff_custom_plain_reorder"] = row
    print(f"{tag} the same custom solve with the plain reorder on the card: info={info}, "
          f"{meta.n_iter} matvecs, {row['ordschur_reads']} ordschur host reads, {secs:.2f} s, "
          f"the reorder's span {row['reorder_span_s']:.3f} s in {row['reorder_spans']} restarts "
          f"({row['reorder_span_s'] / secs:.1%} of the solve)")
    check(info == 6 and res <= 1e-8 * abs(w[0]), f"convdiff device, plain reorder: {row}")
    return out


# -- 34: the timing layer ------------------------------------------------------

class _KeepRecords(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def timing_layer(dev, tag):
    """Phase 34: phase 15's eigs_3072 sweep twice with timing on, a soft
    reset_all between them, print_summary through the package logger, then
    a hard reset_all."""
    t_phase = time.perf_counter()
    n = N_EIGHS
    op = lt.CudaPoisson2D(n, dtype=torch.float32, device=dev)
    x0 = seeded((n, n), torch.float32, dev, seed=7)
    opts = lt.EigsOptions(maxiter=1)
    watch = lt.timer.global_watch

    def sweep():
        lt.eigs(op, 4, x0=x0, kdim=32, tolerance=0.0, options=opts)
        torch.cuda.synchronize()
        lt.timer.spans()  # read the device spans' events into their timers

    watch.reset_all(soft=False)
    lt.set_timing(True)
    try:
        sweep()
        first = {name: (t.etime, t.tmin, t.tmax, t.count)
                 for name, t in watch._timers.items() if t.count}
        watch.reset_all()
        sweep()
    finally:
        lt.set_timing(False)
    timers = {name: t for name, t in watch._timers.items() if name in first}
    second = {name: [t.etime, t.tmin, t.tmax, t.count] for name, t in timers.items()}
    check("eigs" in first and first["eigs"][3] == 1,
          f"the first sweep's timers {sorted(first)}: no single 'eigs' call")
    for name, t in timers.items():
        check(t.count == first[name][3] and not t.running and t.etime > 0,
              f"timer {name}: count {t.count} after the soft reset and one sweep, "
              f"the first sweep's {first[name][3]}")
        check(t.history == [first[name]], f"timer {name}: history {t.history}, "
              f"the first sweep's record {first[name]}")
    if not lt.utils.logger.logger.handlers:
        lt.logger_setup(log_timestamp=False)
    keep = _KeepRecords()
    lt.utils.logger.logger.addHandler(keep)
    try:
        watch.print_summary()
    finally:
        lt.utils.logger.logger.removeHandler(keep)
    check(keep.messages == [watch.summary()], "print_summary did not reach the package logger")
    watch.reset_all(soft=False)
    check(all(t.count == 0 and t.history == [] and t.etime == 0.0 for t in watch._timers.values()),
          "a hard reset_all left a count or a history")
    seconds = time.perf_counter() - t_phase
    print(f"{tag} timing layer: {len(timers)} timers of the eigs_3072 sweep ("
          + ", ".join(f"{k} n={v[3]}" for k, v in first.items())
          + f"), the second sweep's counts alone, the first's record in each history; "
          f"eigs {second['eigs'][0] * 1e3:.2f} ms after the soft reset, "
          f"{first['eigs'][0] * 1e3:.2f} ms before; a hard reset clears all; phase 34: "
          f"{seconds:.2f} s")
    return dict(first={k: list(v) for k, v in first.items()},
                second=second, seconds=seconds)


def cg_kernels(dev, tag, n=3162):
    """Phase 35: the fused CG update's kernels against their plain versions
    and timed cold on n^2 grids (the benchmark's 3162^2), then a whole solve
    through them beside the unfused loop."""
    cg_solver = importlib.import_module("lightkrylov_tpu_torch.solvers.cg")
    passes = {"cg_pdot": 2, "cg_xr": 6, "cg_p": 3}
    out = {"parity": {}, "times": {}}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype)[6:]
        nbytes = n * n * dtype.itemsize
        sets = [[seeded((n, n), dtype, dev, seed=4 * i + j) for j in range(4)] for i in range(2)]
        x, r, p, ap = sets[0]
        rz = torch.dot(r.reshape(-1), r.reshape(-1))
        s = fused_cg.scalars(rz, torch.sqrt(rz), torch.sqrt(rz) * 0.5)
        s[fused_cg.PAP] = torch.dot(p.reshape(-1), ap.reshape(-1))
        s[fused_cg.BETA] = 0.75
        hist = torch.zeros(4, dtype=dtype, device=dev)
        scale = float(torch.linalg.norm(p.double()) * torch.linalg.norm(ap.double()))
        s1, s2 = s.clone(), s.clone()
        fused_cg.cg_pdot(fused_cg.FusedCG(x.clone(), r.clone(), p, s1, hist.clone()), ap)
        fused_cg.cg_pdot_reference(p, ap, s2)
        (x1, r1, s3), (x2, r2, s4) = (x.clone(), r.clone(), s.clone()), (x.clone(), r.clone(), s.clone())
        fused_cg.cg_xr(fused_cg.FusedCG(x1, r1, p, s3, hist), ap, 0)
        fused_cg.cg_xr_reference(x2, r2, p, ap, s4, hist.clone(), 0)
        p1, p2 = p.clone(), p.clone()
        fused_cg.cg_p(fused_cg.FusedCG(x.clone(), r, p1, s, hist.clone()))
        fused_cg.cg_p_reference(r, p2, s)
        torch.cuda.synchronize()
        errs = {"cg_pdot": abs(float(s1[fused_cg.PAP] - s2[fused_cg.PAP])) / scale,
                "cg_xr": max(rel_err(x1, x2), rel_err(r1, r2),
                             *(abs(float(s3[k] - s4[k])) / abs(float(s4[k]))
                               for k in (fused_cg.RR, fused_cg.RES, fused_cg.BETA))),
                "cg_p": rel_err(p1, p2)}
        for kernel, err in errs.items():
            check(err <= REL_TOL[dtype], f"{kernel} {name} at {n}^2: rel err {err:.3e}")
        out["parity"][name] = errs
        # cold: alternate two input sets, each bound once as a solve binds its buffers;
        # alpha = rz / inf = 0 and a fixed beta keep the values bounded over the repeated
        # in-place updates, and move the same bytes
        s_pdot = [s.clone() for _ in sets]  # cg_pdot and cg_p (beta 0.75)
        s_xr = [s.clone() for _ in sets]
        for si in s_xr:
            si[fused_cg.PAP] = float("inf")
        hist = torch.zeros(1, dtype=dtype, device=dev)
        bound = [(fused_cg.FusedCG(*st[:3], s_pdot[i], hist), fused_cg.FusedCG(*st[:3], s_xr[i], hist))
                 for i, st in enumerate(sets)]
        kernel_call = {"cg_pdot": lambda i: fused_cg.cg_pdot(bound[i][0], sets[i][3]),
                       "cg_xr": lambda i: fused_cg.cg_xr(bound[i][1], sets[i][3], 0),
                       "cg_p": lambda i: fused_cg.cg_p(bound[i][0])}
        plain_call = {
            "cg_pdot": lambda i: fused_cg.cg_pdot_reference(sets[i][2], sets[i][3], s_pdot[i]),
            "cg_xr": lambda i: fused_cg.cg_xr_reference(*sets[i], s_xr[i], hist, 0),
            "cg_p": lambda i: fused_cg.cg_p_reference(sets[i][1], sets[i][2], s_pdot[i])}

        turn = itertools.count()
        for kernel in passes:
            # behind a spinning kernel, so that the wrappers' host time stays out
            fns = {"kernel_ms": lambda: kernel_call[kernel](next(turn) % 2),
                   "plain_ms": lambda: plain_call[kernel](next(turn) % 2)}
            if kernel == "cg_pdot":  # one library call computes it
                fns["library_ms"] = lambda: torch.dot(*(v.reshape(-1) for v in
                                                        sets[next(turn) % 2][2:]))
            ms = alternating_ms(fns, per_run=8, spacer=True)
            row = {**ms, "bound_ms": passes[kernel] * nbytes / HBM_BYTES_PER_S * 1e3}
            row["roofline_pct"] = 100 * row["bound_ms"] / row["kernel_ms"]
            out["times"][f"{kernel}_{name}"] = row
            library = f", torch.dot {row['library_ms'] * 1e3:.1f} us" if "library_ms" in row else ""
            print(f"{tag} {kernel} {n}^2 {name} cold: kernel {row['kernel_ms'] * 1e3:.1f} us, "
                  f"bound {row['bound_ms'] * 1e3:.1f} us ({row['roofline_pct']:.1f}%), "
                  f"plain {row['plain_ms'] * 1e3:.1f} us{library}; rel err {errs[kernel]:.3e}")
        del sets, bound, x1, r1, x2, r2, p1, p2
    op = lt.CudaPoisson2D(n, dtype=torch.float64, device=dev)
    b = seeded((n, n), torch.float64, dev, seed=11)
    opts = lt.CGOptions(maxiter=40000)
    solves = {}
    for route in ("fused", "unfused"):
        fits = cg_solver._fits_fused
        if route == "unfused":
            cg_solver._fits_fused = lambda *args: False
        try:
            before = {k: launch_count(k) for k in passes}
            iters = lt.timer.get_counter("cg.fused_iterations")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, info, meta = lt.cg(op, b, rtol=1e-4, atol=0.0, options=opts)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            cg_solver._fits_fused = fits
        relres = float(torch.linalg.norm(b - op.matvec(x)) / torch.linalg.norm(b))
        solves[route] = dict(n_iter=meta.n_iter, relres=relres, seconds=seconds,
                             fused_iterations=lt.timer.get_counter("cg.fused_iterations") - iters,
                             launches={k: launch_count(k) - before[k] for k in passes})
        print(f"{tag} cg {n}^2 f64 rtol 1e-4 {route}: {meta.n_iter} iterations, true relres "
              f"{relres:.3e}, {seconds:.3f} s, launches {solves[route]['launches']}, "
              f"cg.fused_iterations {solves[route]['fused_iterations']}")
        check(info > 0 and relres <= 4e-4, f"cg {route}: info {info}, relres {relres:.3e}")
    k = solves["fused"]["n_iter"]
    check(solves["fused"]["fused_iterations"] == k
          and all(v == k for v in solves["fused"]["launches"].values()),
          f"the fused solve's counts {solves['fused']} for {k} iterations")
    check(solves["unfused"]["fused_iterations"] == 0
          and not any(solves["unfused"]["launches"].values()),
          f"the unfused solve went through the kernels: {solves['unfused']}")
    check(abs(k - solves["unfused"]["n_iter"]) <= 0.01 * solves["unfused"]["n_iter"],
          f"iterations {k} fused against {solves['unfused']['n_iter']} unfused")
    out["solves"] = solves
    return out


GMRES_N = 3162
GMRES_KDIM = 30
GMRES_CYCLE_RUNS = 5

# one GMRES(30) cycle at GMRES_N^2 f32 under torch.profiler, in a fresh
# process (the profiler records the card's kernels only the first time a
# process uses it), on the route {route}: the host's launch calls and the
# card's activities, by name
GMRES_LAUNCH_PROBE = """
import json
import importlib
import numpy as np
import torch
import lightkrylov_tpu_torch as lt
solver = importlib.import_module("lightkrylov_tpu_torch.solvers.gmres")
if "{route}" == "separate":
    solver._fits_fused = lambda *args: False
n, kdim = {n}, {kdim}
op = lt.CudaPoisson2D(n, dtype=torch.float32, device="cuda")
b = torch.from_numpy(np.random.default_rng(3).standard_normal((n, n))).to("cuda", torch.float32)
opts = lt.GMRESOptions(kdim=kdim, maxiter=1)
for _ in range(2):
    lt.gmres(op, b, rtol=0.0, atol=0.0, options=opts)
torch.cuda.synchronize()
acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
with torch.profiler.profile(activities=acts) as prof:
    lt.gmres(op, b, rtol=0.0, atol=0.0, options=opts)
    torch.cuda.synchronize()
calls = {{"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx"}}
events = prof.events()
device = {{}}
for e in events:
    if e.device_type == torch.autograd.DeviceType.CUDA:
        device[e.name] = device.get(e.name, 0) + 1
print(json.dumps({{"launch_calls": sum(e.name in calls for e in events),
                  "memcpy_calls": sum(e.name == "cudaMemcpyAsync" for e in events),
                  "device": device}}))
"""


def dcgs2_parity(dev, dtype, tag, n=GMRES_N, kdim=GMRES_KDIM):
    """Every step and the flush of one DCGS2 cycle on CudaPoisson2D(n): the
    plain versions on the card run the cycle; before each step a
    FusedDCGS2 bound to a copy of their state takes the same step (twice,
    from two copies, for the bits).  The largest relative gap of each
    output over the cycle, and whether every repeat was bit-equal."""
    op = lt.CudaPoisson2D(n, dtype=dtype, device=dev)
    b = seeded((n, n), dtype, dev, seed=21).reshape(-1)
    beta = torch.linalg.vector_norm(b)
    V = torch.zeros(kdim + 1, n * n, dtype=dtype, device=dev)
    V[0] = b / beta
    e = torch.zeros(kdim + 1, dtype=dtype, device=dev)
    e[0] = beta
    zeros = [torch.zeros(shape, dtype=dtype, device=dev) for shape in ((kdim, kdim), kdim, kdim)]
    st = fused_gmres.DCGS2State(*zeros, e, torch.zeros(kdim, dtype=dtype, device=dev),
                                beta.clone(), torch.zeros((), dtype=dtype, device=dev),
                                lt.constants.eps(dtype))
    names = ("Ht", "hp", "fac_prev", "R", "c", "s", "e", "res", "hist")
    gaps, bits = {}, True

    def bound():
        fb = fused_gmres.FusedDCGS2(*(t.clone() for t in (st.R, st.c, st.s, st.e, st.hist)),
                                    st.res.clone(), st.tol.clone(), st.eps)
        fb.Ht.copy_(st.Ht)
        fb.hp.copy_(st.hp)
        fb.fac_prev.copy_(st.fac_prev)
        return fb

    def gap(name, got, want):
        scale = float(torch.linalg.norm(want.double()))
        err = float(torch.linalg.norm((got - want).double()))
        gaps[name] = max(gaps.get(name, 0.0), err / scale if scale else err)

    def compare(pair, outs):
        nonlocal bits
        for name in names:
            gap(name, getattr(pair[0], name), getattr(st, name))
            bits &= torch.equal(getattr(pair[0], name), getattr(pair[1], name))
        for name, (got, again, want) in outs.items():
            gap(name, got, want)
            bits &= torch.equal(got, again)

    for k in range(kdim):
        u = V[k]
        w = op.matvec(u.view(n, n)).reshape(-1)
        PR = (torch.stack([u, w]) @ V[: k + 1].T).T
        wTw = torch.dot(w, w)
        nin = max(k - 1, 0)
        pair = (bound(), bound())
        got = [fused_gmres.dcgs2_step(fb, PR, wTw, k, nin) for fb in pair]
        C, inv_gamma = fused_gmres.dcgs2_coefficients_reference(st, PR, wTw, k)
        fused_gmres.dcgs2_givens_reference(st, k, nin)
        compare(pair, {"coeff": (got[0][0], got[1][0], C),
                       "inv_gamma": (got[0][1], got[1][1], inv_gamma),
                       "flag": tuple(x.flag.to(dtype) for x in (*pair, st))})
        D = C.T @ V[: k + 1]
        V[k + 1] = inv_gamma * w - D[1]
        V[k] = D[0]
    zf = V[: kdim + 1] @ V[kdim]
    pair = (bound(), bound())
    for fb in pair:
        fused_gmres.dcgs2_flush(fb, zf, kdim, kdim - 1)
    fused_gmres.dcgs2_flush_reference(st, zf, kdim, kdim - 1)
    compare(pair, {"conv": tuple(x.conv.to(dtype) for x in (*pair, st))})
    torch.cuda.synchronize()
    name = str(dtype)[6:]
    worst = max(gaps.values())
    print(f"{tag} dcgs2_step/dcgs2_flush {n}^2 kdim {kdim} {name}, every step and the flush "
          f"against the plain versions: worst rel gap {worst:.3e} "
          f"({max(gaps, key=gaps.get)}); repeats bit-equal: {bits}")
    check(worst <= REL_TOL[dtype], f"dcgs2 {name}: rel gaps {gaps}")
    check(bits, f"dcgs2 {name}: two launches from one state differ")
    # the kernel alone at the cycle's last step, and the wrapper's host time
    k = kdim - 1
    u = V[k]
    w = op.matvec(u.view(n, n)).reshape(-1)
    PR, wTw = (torch.stack([u, w]) @ V[: k + 1].T).T, torch.dot(w, w)
    fb = bound()
    ms = alternating_ms({"kernel_ms": lambda: fused_gmres.dcgs2_step(fb, PR, wTw, k, 0)},
                        per_run=10, spacer=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_US_CALLS):
        fused_gmres.dcgs2_step(fb, PR, wTw, k, 0)
    host_us = (time.perf_counter() - t0) / HOST_US_CALLS * 1e6
    torch.cuda.synchronize()
    print(f"{tag} dcgs2_step kdim {kdim} {name} at step {k}: kernel {ms['kernel_ms'] * 1e3:.2f} us "
          f"on the card; wrapper {host_us:.1f} us of host time a call")
    del V, op
    return gaps, dict(ms, host_us=host_us)


def basis_fields(rows, n, dtype, dev, seed):
    """``rows`` seeded unit fields of ``n`` elements, made on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    V = torch.randn(rows, n, generator=g, dtype=dtype, device=dev)
    return V / torch.linalg.vector_norm(V, dim=1, keepdim=True)


def bound_basis(V):
    """A FusedDCGS2 of zeros bound to the basis ``V``."""
    kdim, dt, dev = V.shape[0] - 1, V.dtype, V.device
    z = [torch.zeros(shape, dtype=dt, device=dev) for shape in ((kdim, kdim), kdim, kdim)]
    return fused_gmres.FusedDCGS2(*z, torch.zeros(kdim + 1, dtype=dt, device=dev),
                                  torch.zeros(kdim, dtype=dt, device=dev),
                                  torch.ones((), dtype=dt, device=dev),
                                  torch.zeros((), dtype=dt, device=dev), lt.constants.eps(dt), V=V)


def measurement_gap(m, PR, wTw, V, k, w):
    """The largest gap of the measurement buffer ``m`` from ``(PR, wTw)``:
    each dot over the product of its two vectors' norms."""
    norms = torch.linalg.vector_norm(V[: k + 1].double(), dim=1)
    w_norm = torch.linalg.vector_norm(w.double())
    scale = norms[:, None] * torch.stack([norms[k], w_norm])[None, :]
    return max(float(((m[:-1].view(k + 1, 2).double() - PR.double()).abs() / scale).max()),
               abs(float(m[-1]) - float(wTw)) / float(w_norm) ** 2)


def basis_passes_parity(V, k, w, C, inv_gamma):
    """dcgs2_measure and dcgs2_update at step k on two copies of V against
    their plain versions in float64 on the same inputs, which sum more
    exactly than the float32 plain versions' cuBLAS products (those miss
    float64 by up to 1.7e-6 in the measurement at 3162^2): the
    measurement's largest gap (each dot over the product of its vectors'
    norms), the written columns' (over their norms), the float32 plain
    measurement's gap from float64 beside them, and whether the copies agree
    bit for bit and the other columns stay as they were.  V is left as it
    was."""
    copies = [V.clone(), V.clone()]
    states = [bound_basis(c) for c in copies]
    ms = [fused_gmres.dcgs2_measure(st, k, w).clone() for st in states]
    V64, w64 = V.to(torch.float64, copy=True), w.to(torch.float64, copy=True)
    PR, wTw = fused_gmres.dcgs2_measure_reference(V64, k, w64)
    gap_m = measurement_gap(ms[0], PR, wTw, V, k, w)
    plain = fused_gmres.dcgs2_measure_reference(V, k, w)
    gap_plain = measurement_gap(torch.cat([plain[0].reshape(-1), plain[1].reshape(1)]), PR, wTw,
                                V, k, w)
    for st in states:
        st.coeff[: k + 1] = C
        st.inv_gamma.copy_(inv_gamma)
        fused_gmres.dcgs2_update(st, k, w)
    fused_gmres.dcgs2_update_reference(V64, k, w64, C.double(), inv_gamma.double())
    torch.cuda.synchronize()
    got = copies[0]
    gap_u = max(rel_err(got[k].double(), V64[k]), rel_err(got[k + 1].double(), V64[k + 1]))
    same = (torch.equal(ms[0], ms[1]) and torch.equal(copies[0], copies[1])
            and torch.equal(got[:k], V[:k]) and torch.equal(got[k + 2:], V[k + 2:]))
    return gap_m, gap_u, gap_plain, same


def dcgs2_basis_kernels(dev, tag, n=GMRES_N, kdim=GMRES_KDIM):
    """Phase 36's two passes over the basis: dcgs2_measure and dcgs2_update
    at the cycle's last step on n^2 fields against their plain versions,
    then timed cold beside their byte bound, their plain versions and the
    library products the port called before them; in f32 the kernels at
    every step of the cycle."""
    k = kdim - 1
    N = n * n
    out = {"parity": {}, "times": {}, "steps": {}}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype)[6:]
        sets = [basis_fields(kdim + 2, N, dtype, dev, seed=50 + i) for i in range(2)]
        Vs, ws = [f[: kdim + 1] for f in sets], [f[kdim + 1] for f in sets]
        C = seeded((k + 1, 2), dtype, dev, seed=51)
        inv_gamma = torch.tensor(0.75, dtype=dtype, device=dev)
        gap_m, gap_u, gap_plain, same = basis_passes_parity(Vs[0], k, ws[0], C, inv_gamma)
        out["parity"][name] = dict(measure=gap_m, update=gap_u, plain_measure=gap_plain,
                                   bit_equal=same)
        print(f"{tag} dcgs2_measure / dcgs2_update {n}^2 {name} at step {k} against the plain "
              f"versions in float64: rel gaps {gap_m:.3e} / {gap_u:.3e} (the {name} plain "
              f"measurement's {gap_plain:.3e}); repeats bit-equal and other columns untouched: "
              f"{same}")
        check(gap_m <= REL_TOL[dtype] and gap_u <= REL_TOL[dtype],
              f"dcgs2 basis kernels {name}: rel gaps {gap_m:.3e} / {gap_u:.3e}")
        check(same, f"dcgs2 basis kernels {name}: repeats differ or a column moved")
        # timed: C[:, 0] = e_k keeps V[k] as it is over repeated updates, with the same bytes
        C_t = C.clone()
        C_t[:, 0] = 0
        C_t[k, 0] = 1
        states = [bound_basis(V) for V in Vs]
        for st in states:
            st.coeff[: k + 1] = C_t
            st.inv_gamma.copy_(inv_gamma)
        Y2s = [torch.stack([V[k], w]) for V, w in zip(Vs, ws)]
        turn = itertools.count()
        calls = {
            "dcgs2_measure": {
                "kernel_ms": lambda i: fused_gmres.dcgs2_measure(states[i], k, ws[i]),
                "plain_ms": lambda i: fused_gmres.dcgs2_measure_reference(Vs[i], k, ws[i]),
                "library_ms": lambda i: Y2s[i] @ Vs[i][: k + 1].mH},
            "dcgs2_update": {
                "kernel_ms": lambda i: fused_gmres.dcgs2_update(states[i], k, ws[i]),
                "plain_ms": lambda i: fused_gmres.dcgs2_update_reference(Vs[i], k, ws[i], C_t,
                                                                         inv_gamma),
                "library_ms": lambda i: C_t.T @ Vs[i][: k + 1]}}
        passes = {"dcgs2_measure": k + 2, "dcgs2_update": k + 4}
        for kernel, fns in calls.items():
            ms = alternating_ms({key: (lambda f=f: f(next(turn) % 2)) for key, f in fns.items()},
                                per_run=4, spacer=True)
            row = {**ms, "bound_ms": passes[kernel] * N * dtype.itemsize / HBM_BYTES_PER_S * 1e3}
            row["roofline_pct"] = 100 * row["bound_ms"] / row["kernel_ms"]
            out["times"][f"{kernel}_{name}"] = row
            print(f"{tag} {kernel} {n}^2 {name} at step {k} cold: kernel "
                  f"{row['kernel_ms'] * 1e3:.1f} us, bound {row['bound_ms'] * 1e3:.1f} us "
                  f"({row['roofline_pct']:.1f}%), plain {row['plain_ms'] * 1e3:.1f} us, library "
                  f"{row['library_ms'] * 1e3:.1f} us")
        if dtype == torch.float32:
            # every step of a cycle: the kernels' sum against the cycle's byte bound
            steps = []

            def rotated(fn):
                i = next(turn) % 2
                return fn(states[i], j, ws[i])

            for j in range(kdim):
                for st in states:
                    st.coeff.zero_()
                    st.coeff[j, 0] = 1
                ms = alternating_ms(
                    {"measure_ms": lambda: rotated(fused_gmres.dcgs2_measure),
                     "update_ms": lambda: rotated(fused_gmres.dcgs2_update)},
                    runs=5, per_run=4, spacer=True)
                steps.append(ms)
            total = {key: sum(r[key] for r in steps) for key in ("measure_ms", "update_ms")}
            bound = {"measure_ms": sum(j + 2 for j in range(kdim)) * N * 4 / HBM_BYTES_PER_S * 1e3,
                     "update_ms": sum(j + 4 for j in range(kdim)) * N * 4 / HBM_BYTES_PER_S * 1e3}
            out["steps"] = dict(by_step=steps, total_ms=total, bound_ms=bound)
            print(f"{tag} a GMRES({kdim}) cycle's passes over the basis {n}^2 f32, every step: "
                  f"measure {total['measure_ms']:.2f} ms (bound {bound['measure_ms']:.2f}), "
                  f"update {total['update_ms']:.2f} ms (bound {bound['update_ms']:.2f}); by step "
                  "(measure / update us): "
                  + ", ".join(f"{j}: {r['measure_ms'] * 1e3:.0f} / {r['update_ms'] * 1e3:.0f}"
                              for j, r in enumerate(steps)))
        del sets, Vs, ws, states, Y2s
    return out


def gmres_kernels(dev, tag):
    """Phase 36: the DCGS2 step's kernel against its plain version at every
    step of a 3162^2 cycle, timed; the two passes over the basis against
    theirs, timed; the launches of a cycle on each route; GMRES(30) cycles
    through the kernels beside the separate operations."""
    solver = importlib.import_module("lightkrylov_tpu_torch.solvers.gmres")
    out = {"parity": {}, "times": {}, "launches": {}, "cycles": {}}
    for dtype in (torch.float32, torch.float64):
        gaps, times = dcgs2_parity(dev, dtype, tag)
        out["parity"][str(dtype)[6:]], out["times"][str(dtype)[6:]] = gaps, times
    out["basis"] = dcgs2_basis_kernels(dev, tag)
    for route in ("kernel", "separate"):
        code = GMRES_LAUNCH_PROBE.format(route=route, n=GMRES_N, kdim=GMRES_KDIM)
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              timeout=300, cwd=Path(__file__).resolve().parent)
        check(proc.returncode == 0, f"the GMRES launch probe failed: {proc.stderr[-2000:]}")
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        out["launches"][route] = row
        top = sorted(row["device"].items(), key=lambda kv: -kv[1])[:6]
        print(f"{tag} one GMRES({GMRES_KDIM}) cycle {GMRES_N}^2 f32, {route} route, by "
              f"torch.profiler: {row['launch_calls']} launch calls "
              f"({row['launch_calls'] / (GMRES_KDIM + 1):.1f} an operator step), "
              f"{row['memcpy_calls']} cudaMemcpyAsync, {sum(row['device'].values())} device "
              f"activities; most: " + "; ".join(f"{name[:50]} x{c}" for name, c in top))
    kernel_row = out["launches"]["kernel"]
    for fn, count in (("dcgs2_kernel", GMRES_KDIM + 1), ("dcgs2_measure_kernel", GMRES_KDIM),
                      ("dcgs2_update_kernel", GMRES_KDIM)):
        check(sum(c for name, c in kernel_row["device"].items() if fn in name) == count,
              f"the fused cycle's {fn} launches: {kernel_row['device']}")
        check(not any(fn in name for name in out["launches"]["separate"]["device"]),
              f"the separate operations launched {fn}")
    op = lt.CudaPoisson2D(GMRES_N, dtype=torch.float32, device=dev)
    b = seeded((GMRES_N, GMRES_N), torch.float32, dev, seed=22)
    opts = lt.GMRESOptions(kdim=GMRES_KDIM, maxiter=2)
    fits = solver._fits_fused
    runs = {}
    for route in ("kernel", "separate"):
        if route == "separate":
            solver._fits_fused = lambda *args: False
        try:
            lt.timer.reset_counters()
            x, info, meta = lt.gmres(op, b, rtol=0.0, atol=0.0, options=opts)
            runs[route] = dict(x=x, residuals=meta.residuals, n_inner=meta.n_inner,
                               host_reads=lt.timer.get_counter("host_reads"),
                               fused_steps=lt.timer.get_counter("gmres.fused_steps"),
                               launches=[launch_count(name) for name in
                                         ("dcgs2_step", "dcgs2_flush", "dcgs2_measure",
                                          "dcgs2_update")])
        finally:
            solver._fits_fused = fits
    k, s = runs["kernel"], runs["separate"]
    x_gap = rel_err(k["x"], s["x"])
    hist_gap = float(np.linalg.norm(k["residuals"] - s["residuals"])
                     / np.linalg.norm(s["residuals"]))
    print(f"{tag} two GMRES({GMRES_KDIM}) cycles {GMRES_N}^2 f32 through the kernel against the "
          f"separate operations: x rel gap {x_gap:.3e}, residual history rel gap "
          f"{hist_gap:.3e}; host reads {k['host_reads']} / {s['host_reads']}; fused steps "
          f"{k['fused_steps']} / {s['fused_steps']}; dcgs2 launches (step, flush, measure, "
          f"update) {k['launches']} / {s['launches']}")
    check(x_gap <= 1e-3 and hist_gap <= 1e-3, f"fused cycles: x gap {x_gap}, history {hist_gap}")
    check(k["host_reads"] == s["host_reads"] and k["n_inner"] == s["n_inner"],
          f"host reads {k['host_reads']} / {s['host_reads']}")
    steps = 2 * GMRES_KDIM
    check(k["fused_steps"] == steps and k["launches"] == [steps, 2, steps, steps]
          and s["fused_steps"] == 0 and s["launches"] == [0, 0, 0, 0],
          f"fused steps and launches: {k['fused_steps']} {k['launches']}; "
          f"{s['fused_steps']} {s['launches']}")
    for route in runs:
        runs[route].pop("x")
        runs[route]["residuals"] = runs[route]["residuals"].tolist()
    out["cycles"] = dict(runs, x_gap=x_gap, history_gap=hist_gap)
    # cycle times by the host clock, the routes in turns
    opts = lt.GMRESOptions(kdim=GMRES_KDIM, maxiter=1)
    secs = {"kernel": [], "separate": []}
    for i in range(2 * GMRES_CYCLE_RUNS + 2):
        route = ("kernel", "separate", "separate", "kernel")[i % 4]
        if route == "separate":
            solver._fits_fused = lambda *args: False
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lt.gmres(op, b, rtol=0.0, atol=0.0, options=opts)
            torch.cuda.synchronize()
            if i >= 2:
                secs[route].append(time.perf_counter() - t0)
        finally:
            solver._fits_fused = fits
    cycle_ms = {route: 1e3 * statistics.median(v) for route, v in secs.items()}
    out["cycles"]["cycle_ms"] = cycle_ms
    out["cycles"]["kernel"]["launches"] = k["launches"]
    print(f"{tag} a GMRES({GMRES_KDIM}) cycle {GMRES_N}^2 f32, median of {GMRES_CYCLE_RUNS} in "
          f"turns: through the kernel {cycle_ms['kernel']:.1f} ms, separate operations "
          f"{cycle_ms['separate']:.1f} ms")
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

    # 2. build from the sources, into a clean build directory (and beside
    # it, in threads, the lagging-warp build of phase 33 (h) and, when its
    # tree is there, the parent commit's of phase 33 (g))
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    parent = parent_ops()
    if parent is not None:
        shutil.rmtree(parent[1].BUILD_DIR, ignore_errors=True)
    with ThreadPoolExecutor(2) as pool:
        lag_build = pool.submit(timed, _build.build, "lag")
        parent_build = pool.submit(timed, parent[1].build) if parent is not None else None
        t0 = time.perf_counter()
        lib_path = _build.build()
        _build.load()
        results["build_s"] = time.perf_counter() - t0
    results["lag_build_s"] = lag_build.result()[1]
    results["parent_build_s"] = parent_build.result()[1] if parent_build is not None else None
    print(f"build: {lib_path.name} in {results['build_s']:.2f} s; the lagging-warp build "
          f"{results['lag_build_s']:.2f} s; the parent's "
          + (f"{results['parent_build_s']:.2f} s" if parent is not None
             else f"not built (no tree at {PARENT_DIR})"))
    results["ptxas"] = ptxas_figures(lib_path.with_suffix(".log").read_text())
    for name, rows in results["ptxas"].items():
        for r in rows:
            print(f"  ptxas {name}: {r['instance']}: {r['registers']} registers, "
                  f"{r['stack_frame']} bytes stack frame, {r['spill_stores']} bytes spill stores, "
                  f"{r['spill_loads']} bytes spill loads")
    check(all(results["ptxas"].values()), f"a kernel of the kernels line is missing from the "
          f"build log: {[k for k, v in results['ptxas'].items() if not v]}")
    check(all(r["stack_frame"] == 0 and r["spill_stores"] == 0 == r["spill_loads"]
              for r in results["ptxas"]["ordschur"]), "the ordschur kernel has a stack frame or "
          f"spills: {results['ptxas']['ordschur']}")
    check(all(r["spill_stores"] == 0 == r["spill_loads"] for r in results["ptxas"]["ritz_check"]),
          f"the Ritz kernel spills: {results['ptxas']['ritz_check']}")
    assembler = "native C++" if native.available() else f"numpy ({native.unavailable_reason()})"
    print(f"Block-ELL host assembler (CPU targets; a card builds the layout itself): "
          f"{assembler}")

    # 3. the kernel against its plain version, through both wrappers
    results["parity"] = []
    for dtype in (torch.float32, torch.float64):
        for shape in STENCIL_SHAPES:
            u = seeded(shape, dtype, dev)
            want = stencil_matvec_reference(u, **stencil_args(u))
            for wrapper in (lt.stencil_matvec, lt.stencil_matvec_2d):
                before = launch_count(wrapper.__name__)
                got = wrapper(u, **stencil_args(u))
                torch.cuda.synchronize()
                check(launch_count(wrapper.__name__) == before + 1,
                      f"{wrapper.__name__} did not count its launch")
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
    lt.timer.reset_counters()
    before = launch_count("stencil_matvec", "stencil_matvec_2d")
    x_k, info_k, meta_k = lt.gmres(op_k, b, rtol=0.0, atol=0.0, options=opts)
    torch.cuda.synchronize()
    main_launches = launch_count("stencil_matvec", "stencil_matvec_2d") - before
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
    results["bell_fitted"] = bell_fitted(dev, tag)
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

    # 33. the device projected path: the Francis-QR kernels against their
    # plain versions, then gl512, eigs_3072, the non-normal eigs, eighs_3072,
    # svds_3072 and eigs_3072_block under projected="device", then times
    t33 = time.perf_counter()
    results["hess_kernels"] = hessenberg_kernels(dev, tag)
    results["hess_lagging_warp"] = lagging_warp_check(dev, tag, results["lag_build_s"])
    results["device_path"] = device_projected_path(dev, tag, results)
    results["hess_times"] = hessenberg_times(dev, tag)
    results["ordschur_times"] = ordschur_times(dev, tag)
    results["turns"] = kernel_turns(dev, tag)
    print(f"phase 33: {time.perf_counter() - t33:.1f} s")

    # 34. the timing layer's soft and hard resets and its summary
    results["timing_layer"] = timing_layer(dev, tag)

    # 35. CG's fused update: its kernels against their plain versions, timed,
    # and a solve through them
    results["cg_kernels"] = cg_kernels(dev, tag)

    # 36. a DCGS2 step as three kernels: each against its plain version,
    # timed, launches counted, and GMRES(30) cycles through them
    results["gmres_kernels"] = gmres_kernels(dev, tag)

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
            "by_p": {str(p): v for p, v in bst["by_p"].items()},
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
    hk, dp, ht = results["hess_kernels"], results["device_path"], results["hess_times"]
    main_key = f"{MAIN_KDIM}_float32"
    schur_main = [r for r in hk["schur"] if r["case"] == f"hess{MAIN_KDIM}"
                  and r["dtype"] == "torch.float32"][0]
    filter_main = [r for r in hk["filter"] if r["kdim"] == MAIN_KDIM
                   and r["dtype"] == "torch.float32"][0]
    for name, main_row, prefix, library in (
            ("hessenberg_schur", schur_main, "schur", ht[main_key]["eigvals_ms"]),
            ("francis_filter_sweeps", filter_main, "filter", None)):
        kernels["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": "lightkrylov_tpu_torch/csrc/hessenberg.cu",
            "replaces": HESS_REPLACES[name],
            "launches": dp["gl512"]["launches"][name],
            "path_launches": {
                "gl512_device": dp["gl512"]["launches"][name],
                "convdiff_device_iram": dp["convdiff_iram"][name],
                "convdiff_device_custom": dp["convdiff_custom"][name],
                **({"eigs_3072_device": dp["eigs_3072"]["launches"]["hessenberg_schur"],
                    "eigs_3072_block_device":
                        dp["eigs_3072_block"]["launches"]["hessenberg_schur"]}
                   if name == "hessenberg_schur" else {})},
            "max_abs_err": main_row["max_abs_err"],
            "main_case": f"kdim {MAIN_KDIM} f32",
            "ms": ht[main_key][f"{prefix}_ms"],
            "plain_ms": ht[main_key][f"{prefix}_plain_ms"],
            "bound_ms": ht[main_key]["bound_ms" if prefix == "schur" else "filter_bound_ms"],
            "bound_by": ht[main_key]["bound_by" if prefix == "schur" else "filter_bound_by"],
            "library_ms": library,
            "by_case": {case: {k: v for k, v in row.items()
                               if (k.startswith("filter") == (prefix == "filter")
                                   and not k.startswith("ritz") and k != "eig_ms")
                               or k in ("host_read_eig_ms", "eigvals_ms")}
                        for case, row in ht.items() if case != "wrapper"},
            "wrapper": ht["wrapper"],
        })
    ritz_main = [r for r in hk["ritz"] if r["case"] == f"arnoldi{MAIN_KDIM}"
                 and r["dtype"] == "torch.float32"][0]
    kernels["kernels"].append({
        "name": "ritz_check",
        "route": "cuda",
        "source": "lightkrylov_tpu_torch/csrc/ritz.cu",
        "replaces": RITZ_REPLACES[0],
        "also_replaces": RITZ_REPLACES[1],
        "launches": dp["gl512"]["launches"]["ritz_check"],
        "path_launches": {
            "gl512_device": dp["gl512"]["launches"]["ritz_check"],
            "convdiff_device_iram": dp["convdiff_iram"]["ritz_check"],
            "convdiff_device_custom": dp["convdiff_custom"]["ritz_check"],
            "eigs_3072_device": dp["eigs_3072"]["launches"]["ritz_check"],
            "eigs_3072_block_device": dp["eigs_3072_block"]["launches"]["ritz_check"]},
        "max_abs_err": ritz_main["max_abs_err"],
        "main_case": f"kdim {MAIN_KDIM} f32 (the count's fill and the kernel)",
        "ms": ht[main_key]["ritz_kernel_ms"],
        "plain_ms": ht[main_key]["ritz_plain_ms"],
        "bound_ms": ht[main_key]["ritz_bound_ms"],
        "bound_by": ht[main_key]["ritz_bound_by"],
        "library_ms": ht[main_key]["eig_ms"],
        "library": "torch.linalg.eig",
        "check_ms": ht[main_key]["ritz_ms"],
        "turns_with_parent": {k: v for k, v in (results["turns"] or {}).items()
                              if k.startswith("ritz")} or None,
        "check_launches": ht["wrapper"]["check_launches"],
        "by_case": {case: {k: v for k, v in row.items()
                           if k.startswith("ritz") or k in ("host_read_eig_ms", "eig_ms")}
                    for case, row in ht.items() if case != "wrapper"},
        "gates": {f"{r['case']}_{r['dtype'][6:]}": {
            k: r[k] for k in ("max_abs_err", "max_overlap_err", "max_eig_resid",
                              "max_eig_resid_vs_plain", "max_res_err", "n_conv")}
            for r in hk["ritz"]},
    })
    ot = results["ordschur_times"]
    ordschur_main = [r for r in hk["ordschur"] if r["case"] == "arnoldi30_random"
                     and r["dtype"] == "torch.float64"][0]
    kernels["kernels"].append({
        "name": "ordschur",
        "route": "cuda",
        "source": "lightkrylov_tpu_torch/csrc/ordschur.cu",
        "replaces": ORDSCHUR_REPLACES[0],
        "also_replaces": ORDSCHUR_REPLACES[1],
        "launches": dp["convdiff_custom"]["ordschur"],
        "path_launches": {"convdiff_device_custom": dp["convdiff_custom"]["ordschur"],
                          "convdiff_device_iram": dp["convdiff_iram"]["ordschur"],
                          "gl512_device": 0},
        "max_abs_err": ordschur_main["max_abs_err"],
        "main_case": "kdim 30 f64, a random mask (the convdiff device solves' shape)",
        "ms": ot[ORDSCHUR_MAIN]["ms"],
        "plain_ms": ot[ORDSCHUR_MAIN]["plain_ms"],
        "bound_ms": ot[ORDSCHUR_MAIN]["bound_ms"],
        "bound_by": ot[ORDSCHUR_MAIN]["bound_by"],
        "library_ms": None,
        "host_path_ms": ot[ORDSCHUR_MAIN]["host_path_ms"],
        "turns_with_parent": {k: v for k, v in (results["turns"] or {}).items()
                              if k.startswith("ordschur")} or None,
        "by_case": ot,
        "solves": {k: dp[k] for k in ("convdiff_iram", "convdiff_custom",
                                      "convdiff_custom_plain_reorder")},
        "gates": {f"{r['case']}_{r['dtype'][6:]}": {
            k: r[k] for k in ("ok", "swaps", "max_abs_err", "t_err", "z_err", "factorization")}
            for r in hk["ordschur"]},
    })
    ck = results["cg_kernels"]
    kernels["kernels"].append({
        "name": "cg",
        "route": "cuda",
        "source": "lightkrylov_tpu_torch/csrc/cg.cu",
        "replaces": None,
        "why": "CG's update after the operator, which the JAX package leaves to XLA",
        "launches": ck["solves"]["fused"]["launches"],
        "path_launches": {"cg_3162_f64_rtol1e-4": ck["solves"]["fused"]["launches"]},
        "rel_err": ck["parity"],
        "main_case": "3162^2 f64",
        "ms": {k: ck["times"][f"{k}_float64"]["kernel_ms"] for k in ("cg_pdot", "cg_xr", "cg_p")},
        "plain_ms": {k: ck["times"][f"{k}_float64"]["plain_ms"]
                     for k in ("cg_pdot", "cg_xr", "cg_p")},
        "bound_ms": {k: ck["times"][f"{k}_float64"]["bound_ms"]
                     for k in ("cg_pdot", "cg_xr", "cg_p")},
        "bound_by": "bytes",
        "library_ms": {"cg_pdot": ck["times"]["cg_pdot_float64"]["library_ms"],
                       "cg_xr": None, "cg_p": None},
        "by_case": ck["times"],
        "solves": ck["solves"],
    })
    gk = results["gmres_kernels"]
    kernels["kernels"].append({
        "name": "dcgs2_step",
        "route": "cuda",
        "source": "lightkrylov_tpu_torch/csrc/gmres.cu",
        "replaces": None,
        "why": "a DCGS2 step's k-sized work and Givens update, which the JAX package leaves "
               "to XLA",
        "launches": gk["cycles"]["kernel"]["launches"],
        "path_launches": {f"gmres30_{GMRES_N}_f32_cycle": gk["cycles"]["kernel"]["launches"]},
        "rel_err": gk["parity"],
        "main_case": f"kdim {GMRES_KDIM} float32",
        "ms": gk["times"]["float32"]["kernel_ms"],
        "bound_by": "latency",
        "library_ms": None,
        "by_case": gk["times"],
        "cycle_launches": gk["launches"],
        "cycles": gk["cycles"],
    })
    gb = gk["basis"]
    for i, (kernel, what) in enumerate((("dcgs2_measure", "the measurement Q^H [u_k, w], w.w"),
                                        ("dcgs2_update", "the rank-2 update of the basis"))):
        kernels["kernels"].append({
            "name": kernel,
            "route": "cuda",
            "source": "lightkrylov_tpu_torch/csrc/gmres.cu",
            "replaces": None,
            "why": f"DCGS2's {what}, one pass over the basis, which the JAX package leaves to "
                   "XLA (vectors.py innerprod_vpu / linear_combination_vpu)",
            "launches": gk["cycles"]["kernel"]["launches"][2 + i],
            "path_launches": {f"gmres30_{GMRES_N}_f32_cycle":
                              gk["cycles"]["kernel"]["launches"][2 + i]},
            "rel_err": {d: r[kernel[6:]] for d, r in gb["parity"].items()},
            "main_case": f"step {GMRES_KDIM - 1} of kdim {GMRES_KDIM} float32",
            "ms": gb["times"][f"{kernel}_float32"]["kernel_ms"],
            "plain_ms": gb["times"][f"{kernel}_float32"]["plain_ms"],
            "bound_ms": gb["times"][f"{kernel}_float32"]["bound_ms"],
            "bound_by": "bytes",
            "library_ms": gb["times"][f"{kernel}_float32"]["library_ms"],
            "by_case": {c: r for c, r in gb["times"].items() if c.startswith(kernel)},
            "cycle_ms": gb["steps"]["total_ms"][f"{kernel[6:]}_ms"],
        })
    for entry in kernels["kernels"]:
        entry["ptxas"] = results["ptxas"][entry["name"]]
    print(json.dumps(kernels))
    print(gpu)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
