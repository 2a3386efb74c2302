// A DCGS2 step's k-sized work as one kernel, with its scalars on the device.
//
// Iteration k of GMRES's delayed-reorthogonalisation cycle
// (lightkrylov_tpu_torch/solvers/gmres.py, dcgs2_cycle; the JAX package's
// dcgs2_body) first measures, over the k+1 filled basis columns,
//
//   PR = Q^H [u_k, w]   (k+1, 2)      wTw = w . w
//
// (vector work: a GEMM and a dot, summed over the reduction group by one
// all-reduce, so the same on every rank).  Everything after that, up to the
// rank-2 update's coefficients, works on vectors of length <= kdim + 1, and
// is this kernel's STEP mode:
//
//   sigma = PR[k, 0], tau = PR[k, 1], z = PR[:k, 0], p = PR[:k, 1]
//   eta = sqrt(max(sigma - z.z, 0)), inv_eta = safe_inverse(eta)
//   t = (tau - z.p) inv_eta
//   k > 0: h = hp + z fac, h[k] = eta fac;  H-tilde[:, k-1] = h
//   hp = (pt - H-tilde z) inv_eta          (pt = p with pt[k] = t)
//   gamma = sqrt(max(wTw - p.p - t^2, eps^2 wTw)), inv_gamma = safe_inverse(gamma)
//   coeff[:k, 0] = -z inv_eta,  coeff[k, 0] = inv_eta
//   coeff[:k, 1] = (p - t inv_eta z) inv_gamma,  coeff[k, 1] = t inv_eta inv_gamma
//   fac = gamma inv_eta
//
// and then, for k > 0, the least squares' Givens update of the finished
// column h (the JAX package's apply_givens_rotation): the k-1 stored
// rotations in turn, the new rotation (c[k-1], s[k-1]) as
// utils/linalg.py givens_rotation forms it, R[:, k-1], e[k-1], e[k],
// res = |e[k]|, hist[nin] = res and the flags res >= tol and res < tol.
// safe_inverse(a) is 1/a for a > 0 and 0 otherwise, so a vanishing eta (u_k
// in the span of Q) writes an exactly zero column and ends the recursion.
// FLUSH mode finishes the pending column k-1 of a cycle that ran to its
// last step from the measurement zf = Q^H u_k alone: sigma, eta, h and the
// Givens update, no coefficients.
//
// The coefficient matrix is written straight into the (kdim+1, 2) buffer
// that the rank-2 update X C reads (its first k+1 rows), and inv_gamma into
// the scalar block for the update's axpby; the host reads only a flag.
// The state lives in one workspace bound once a cycle (ops/gmres.py
// FusedDCGS2): H-tilde column-major (column j at j (kdim+1)), hp (kdim+1),
// coeff (kdim+1, 2) row-major, then the scalar block (FAC, RES, TOL, FLAG,
// CONV, INV_GAMMA).  R (kdim, kdim), c, s (kdim), e (kdim+1) and hist are
// the solver's own buffers, updated in place.
//
// One CTA of five warps.  Warps 0-3 hold a row each of hp and coeff (rows
// <= kdim <= 128); warp 4's first lane runs the Givens chain, a sequence
// of dependent 2x2 products, from shared memory, while warps 0-3 form
// H-tilde z.  Every sum runs in one fixed order: z.z, z.p and p.p each in a
// warp of its own (lane-strided partial sums, then a fixed shuffle tree),
// and row i of H-tilde z in one thread, column by column.  So repeated
// launches on the same data give the same bits.  The arithmetic is in the
// working precision (float32 or float64), as the eager operations it
// replaces; IEEE division and square root (no fast-math flags).
//
// Bound: latency.  A step moves a few KB (H-tilde's filled columns, read
// once); what takes time is the dependent chain: the three sums, the
// scalars, then H-tilde z (k dependent FMAs a row) beside the k - 1
// rotations.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (lightkrylov_tpu_torch/ops/_build.py).  The C entries
// launch on the given stream and return cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int MAX_KDIM = 128;
constexpr int ROW_THREADS = 128;
constexpr int THREADS = ROW_THREADS + 32;
// slots of the scalar block (ops/gmres.py has the same numbers)
constexpr int FAC = 0, RES = 1, TOL = 2, FLAG = 3, CONV = 4, INV_GAMMA = 5;
constexpr int STEP = 0, FLUSH = 1;

template <typename T>
__device__ __forceinline__ T safe_inverse(T a) {
  return a > T(0) ? T(1) / a : T(0);
}

// max(a, 0), NaN kept (torch.clamp_min)
template <typename T>
__device__ __forceinline__ T clamp_min0(T a) {
  return a != a ? a : (a > T(0) ? a : T(0));
}

// max(a, b), NaN kept (torch.maximum)
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  if (a != a || b != b) return a + b;
  return a > b ? a : b;
}

// The sum of v over a warp, in lane 0, by a fixed tree.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
dcgs2_kernel(int mode, const T* __restrict__ pr, long long rs, long long cs,
             const T* __restrict__ wtw, int k, long long nin, int kdim, T* __restrict__ work,
             T* __restrict__ R, T* __restrict__ c, T* __restrict__ s, T* __restrict__ e,
             T* __restrict__ hist, T eps2) {
  __shared__ T z[MAX_KDIM + 1], p[MAX_KDIM + 1], h[MAX_KDIM + 1];
  __shared__ T rc[MAX_KDIM], rsn[MAX_KDIM];
  __shared__ T sums[3];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ld = kdim + 1;
  const bool step = mode == STEP;
  const int j = k - 1;  // the column that enters the least squares
  T* ht = work;         // H-tilde, column-major
  T* hp = work + static_cast<long long>(kdim) * ld;
  T* coeff = hp + ld;
  T* scal = coeff + 2 * ld;

  // the measurement and the stored rotations into shared memory
  for (int i = tid; i <= k; i += THREADS) {
    z[i] = pr[i * rs];
    if (step) p[i] = pr[i * rs + cs];
  }
  for (int i = tid; i < j; i += THREADS) {
    rc[i] = c[i];
    rsn[i] = s[i];
  }
  __syncthreads();

  // z.z, z.p, p.p over rows < k: a warp each
  if (warp < (step ? 3 : 1)) {
    const T* a = warp == 2 ? p : z;
    const T* b = warp == 0 ? z : p;
    T acc = T(0);
    for (int i = lane; i < k; i += 32) acc = fma(a[i], b[i], acc);
    acc = warp_sum(acc);
    if (lane == 0) sums[warp] = acc;
  }
  __syncthreads();

  // the same scalars in every thread
  const T fac = scal[FAC];
  const T eta = sqrt(clamp_min0(z[k] - sums[0]));
  const T inv_eta = safe_inverse(eta);
  // the finished column k-1; in a step also column k-1 of H-tilde
  if (k > 0) {
    T* col = ht + static_cast<long long>(j) * ld;
    for (int i = tid; i <= k; i += THREADS) {
      const T v = i < k ? hp[i] + z[i] * fac : eta * fac;
      h[i] = v;
      if (step) col[i] = v;
    }
  }
  __syncthreads();

  if (step && tid < ROW_THREADS) {
    const T t = (p[k] - sums[1]) * inv_eta;
    const T w2 = *wtw;
    const T gamma = sqrt(nan_max((w2 - sums[2]) - t * t, eps2 * w2));
    const T inv_gamma = safe_inverse(gamma);
    const T ti = t * inv_eta;
    for (int i = tid; i <= kdim; i += ROW_THREADS) {
      T acc = T(0);
      if (i <= k) {
#pragma unroll 8
        for (int q = 0; q < k; ++q) acc = fma(ht[static_cast<long long>(q) * ld + i], z[q], acc);
      }
      const T pt = i < k ? p[i] : (i == k ? t : T(0));
      hp[i] = (pt - acc) * inv_eta;
      if (i < k) {
        coeff[2 * i] = -z[i] * inv_eta;
        coeff[2 * i + 1] = (p[i] - ti * z[i]) * inv_gamma;
      } else if (i == k) {
        coeff[2 * i] = inv_eta;
        coeff[2 * i + 1] = ti * inv_gamma;
      }
    }
    if (tid == 0) {
      scal[INV_GAMMA] = inv_gamma;
      scal[FAC] = gamma * inv_eta;
    }
  }

  // the Givens update of column j = k-1 (gmres.fypp:177-182)
  if (tid == ROW_THREADS && k > 0) {
    for (int i = 0; i < j; ++i) {
      const T ci = rc[i], si = rsn[i], a = h[i], b = h[i + 1];
      h[i] = ci * a + si * b;
      h[i + 1] = -si * a + ci * b;
    }
    const T a = h[j], b = h[j + 1];
    const T an = fabs(a), bn = fabs(b);
    T d = sqrt(an * an + bn * bn);
    if (d == T(0)) d = T(1);
    T cj = an / d;
    const T phase = an == T(0) ? T(1) : a / an;
    T sj = phase * b / d;
    if (an == T(0) && bn == T(0)) {
      cj = T(1);
      sj = T(0);
    }
    h[j] = cj * a + sj * b;
    for (int i = 0; i <= j; ++i) R[static_cast<long long>(i) * kdim + j] = h[i];
    c[j] = cj;
    s[j] = sj;
    const T ej = e[j];
    e[j + 1] = -sj * ej;
    e[j] = cj * ej;
    const T res = fabs(-sj * ej);
    const T tol = scal[TOL];
    hist[nin] = res;
    scal[RES] = res;
    scal[FLAG] = res >= tol ? T(1) : T(0);
    scal[CONV] = res < tol ? T(1) : T(0);
  }
}

template <typename T>
int launch(int mode, const void* pr, long long rs, long long cs, const void* wtw, int k,
           long long nin, int kdim, void* work, void* R, void* c, void* s, void* e, void* hist,
           double eps, void* stream) {
  const bool bad_mode = mode == STEP ? (k < 0 || k >= kdim || wtw == nullptr)
                                     : (mode != FLUSH || k < 1 || k > kdim);
  if (bad_mode || kdim < 1 || kdim > MAX_KDIM || nin < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  dcgs2_kernel<T><<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      mode, static_cast<const T*>(pr), rs, cs, static_cast<const T*>(wtw), k, nin, kdim,
      static_cast<T*>(work), static_cast<T*>(R), static_cast<T*>(c), static_cast<T*>(s),
      static_cast<T*>(e), static_cast<T*>(hist), static_cast<T>(eps * eps));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int lk_dcgs2_f32(int mode, const void* pr, long long rs, long long cs, const void* wtw, int k,
                 long long nin, int kdim, void* work, void* R, void* c, void* s, void* e,
                 void* hist, double eps, void* stream) {
  return launch<float>(mode, pr, rs, cs, wtw, k, nin, kdim, work, R, c, s, e, hist, eps, stream);
}

int lk_dcgs2_f64(int mode, const void* pr, long long rs, long long cs, const void* wtw, int k,
                 long long nin, int kdim, void* work, void* R, void* c, void* s, void* e,
                 void* hist, double eps, void* stream) {
  return launch<double>(mode, pr, rs, cs, wtw, k, nin, kdim, work, R, c, s, e, hist, eps,
                        stream);
}

}  // extern "C"
