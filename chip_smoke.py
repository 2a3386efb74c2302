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
   kernel against plain, and the GMRES(30) cycle at 3072^2 with each.

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
import torch

import lightkrylov_tpu_torch as lt
from lightkrylov_tpu_torch.ops import _build
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

    stencil_main = results["times"][f"stencil_{N_MAIN}"]
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
    }]}
    print(json.dumps(kernels))
    print(gpu)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
