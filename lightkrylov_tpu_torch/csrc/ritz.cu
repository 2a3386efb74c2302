// The inverse iteration and the Ritz analysis of one device check: a warp
// an eigenvalue.
//
// Replaces code that the JAX package computes outside Pallas, in
// lightkrylov_tpu/utils/hessenberg.py, where jax.jit compiles it into the
// fused sweep's while_loop (lightkrylov_tpu/solvers/eigs.py:159-258):
//
//   hessenberg_eigvecs (:729): one dhsein-style inverse-iteration solve an
//     eigenvalue, there on the realified 2n x 2n system;
//   hessenberg_ritz (:778): those vectors' residuals, the modulus-descending
//     stable order and the converged count.
//
// The realified system [[A, wi I], [-wi I, A]] x = b plus eps3 I, with
// A = Hm - wr' I, is the complex system (Hm - sigma I) z = b[:n] + i b[n:],
// sigma = (wr' - eps3) + i wi, z = x[:n] + i x[n:].  Hm is block diagonal
// (the active k_eff x k_eff block and the dummy diagonal), so only the active
// block is solved; rows >= k_eff of every vector are zero.  The solve is LU
// with partial pivoting, then back substitution (dhsein's), in complex
// arithmetic held as two real arrays.  The rows that can hold a nonzero in
// column j at step j are those whose first nonzero column is <= j (the
// profile, read from H): two rows a step on a Hessenberg or on the
// Krylov-Schur arrow form, p + 1 on a block Arnoldi band, all on a dense
// input.  So a step costs O(n) on the check's inputs and the solve O(n^2).
//
// Bound: latency.  A solve is a chain of n elimination steps and n
// back-substitution steps, each a pivot choice or a complex reciprocal and
// one row or column update of at most n entries: a few thousand dependent
// steps on a few hundred KB.  So the design keeps a step to one warp and
// __syncwarp, with no CTA barrier and no exchange through another warp:
//
// - A CTA of one warp an eigenvalue slot, a grid of n slots.  Each CTA
//   copies the active block into its working matrix W (n rows of odd stride
//   ld = (n + 1) | 1, real and imaginary parts apart, the right-hand side in
//   column n), in shared memory when it fits (n <= 169 in f32, 119 in f64;
//   ops/hessenberg.py ritz_geometry()) and in a global scratch slice else.
// - A step's pivot is a warp argmax of |re| + |im| over the profile's rows
//   (ties to the lower position), its elimination a lane a column.  Back
//   substitution goes a column at a time, a lane a row.
// - Each CTA counts its own place in the stable modulus-descending order
//   (O(n)) and writes wr, wi, the residual and its vector's column straight
//   into that place; the converged count is an integer atomicAdd into a
//   zeroed output, so the result does not hang on the CTAs' order.
//
// The arithmetic is the plain version's (utils/hessenberg.py
// _inverse_iteration_plain), operation for operation: every product and sum
// rounded on its own (rmul, radd, rsub; no multiply-add), the complex product
// and Smith's reciprocal in the order written there, so that the kernel and
// the plain version take the same pivots and compute the same factors.  Only
// the right-hand side's sine and the sums of squares of the two norms are
// taken in another order, which moves a vector by rounding in its own
// direction, not across it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (lightkrylov_tpu_torch/ops/_build.py).  The C entries
// launch on the given stream and return cudaGetLastError().

#include <cfloat>
#include <climits>
#include <cmath>
#include <cuda_runtime.h>

namespace {

// shared memory a CTA may take on sm_90, and what the dynamic part leaves
// for the static part (ops/hessenberg.py holds the same numbers)
constexpr int RZ_SMEM_LIMIT = 232448;
constexpr int RZ_SMEM_RESERVED = 512;
constexpr unsigned FULL = 0xffffffffu;

template <typename T> __device__ __forceinline__ T eps_of();
template <> __device__ __forceinline__ float eps_of<float>() { return FLT_EPSILON; }
template <> __device__ __forceinline__ double eps_of<double>() { return DBL_EPSILON; }

__device__ __forceinline__ float rmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double rmul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float radd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double radd(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float rsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double rsub(double a, double b) { return __dsub_rn(a, b); }

// max that propagates NaN, as torch.max does
template <typename T> __device__ __forceinline__ T maxnan(T a, T b) {
  return (b > a || b != b) ? b : a;
}

template <typename T> __device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

template <typename T> __device__ __forceinline__ T warp_max(T v) {
  for (int o = 16; o > 0; o >>= 1) v = maxnan(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// The exponent e that the active block and the eigenvalues are scaled by,
// 2^-e, before the solve: that of anrm = max |H_act| when anrm lies outside
// [sqrt(tiny) / eps, eps / sqrt(tiny)] (2^-40 and 2^40 in float32, 2^-459
// and 2^459 in float64), which brings it into [0.5, 1); else 0, and nothing
// changes (csrc/hessenberg.cu range_exp, utils/hessenberg.py
// _range_exponent).  The vectors do not depend on it; the residuals are
// taken with the unscaled coupling.
template <typename T> __device__ __forceinline__ T small_of();
template <> __device__ __forceinline__ float small_of<float>() { return 0x1p-40f; }
template <> __device__ __forceinline__ double small_of<double>() { return 0x1p-459; }

template <typename T> __device__ __forceinline__ int range_exp(T m) {
  int e = 0;
  if (m > T(0) && (m < small_of<T>() || m > T(1) / small_of<T>()) && isfinite(m)) frexp(m, &e);
  return e;
}

// an integer argument: read from device memory (bytes 8, 4 or 1) or given
__device__ __forceinline__ long long int_arg(const void* p, int bytes, long long val) {
  if (bytes == 8) return *static_cast<const long long*>(p);
  if (bytes == 4) return *static_cast<const int*>(p);
  if (bytes == 1) return *static_cast<const unsigned char*>(p);
  return val;
}

// (ar + i ai)(br + i bi), as utils/hessenberg.py _cmul
template <typename T>
__device__ __forceinline__ void cmul(T ar, T ai, T br, T bi, T& cr, T& ci) {
  cr = rsub(rmul(ar, br), rmul(ai, bi));
  ci = radd(rmul(ar, bi), rmul(ai, br));
}

// 1 / (br + i bi) by Smith's formula, as utils/hessenberg.py _recip
template <typename T> __device__ __forceinline__ void recip(T br, T bi, T& ir, T& ii) {
  if (fabs(br) >= fabs(bi)) {
    const T r = bi / br;
    const T d = radd(br, rmul(bi, r));
    ir = T(1) / d;
    ii = -(r / d);
  } else {
    const T r = br / bi;
    const T d = radd(bi, rmul(br, r));
    ir = r / d;
    ii = -(T(1) / d);
  }
}

// entry i of the inverse iteration's right-hand side before its scale,
// sin(1.7 i + 0.3) + 0.25 (utils/hessenberg.py _eigvec_rhs)
template <typename T> __device__ __forceinline__ T rhs_entry(int i) {
  return radd(sin(radd(rmul(T(1.7), T(i)), T(0.3))), T(0.25));
}

// the sort key -(wr^2 + wi^2) and the stable ascending order of torch.argsort
// on it: NaN after every number, equal keys by index
template <typename T> __device__ __forceinline__ T sort_key(T a, T b) {
  return -radd(rmul(a, a), rmul(b, b));
}

template <typename T> __device__ __forceinline__ bool key_before(T a, int ia, T b, int ib) {
  const bool an = a != a, bn = b != b;
  if (an != bn) return bn;
  if (an) return ia < ib;
  return a < b || (a == b && ia < ib);
}

// One slot s = blockIdx.x: the inverse iteration of (wr[s], wi[s]) on the
// active block of H (row stride n; rows k..k+p-1 the coupling of a check),
// then, with ritz, its residual and place in the order.  W: the working
// matrix (shared memory with WS, else the CTA's slice of scratch).
template <typename T, bool WS>
__global__ void __launch_bounds__(32)
ritz_kernel(const T* __restrict__ H, const T* __restrict__ wr, const T* __restrict__ wi,
            const void* ok_ptr, int ok_bytes, long long ok_val, const void* keff_ptr,
            int keff_bytes, long long keff_val, double tol, long long nev, int p, int ritz,
            T* __restrict__ wr_out, T* __restrict__ wi_out, T* __restrict__ res_out,
            T* __restrict__ Vr, T* __restrict__ Vi, int* n_conv, T* scratch, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x, s = blockIdx.x;
  const int ld = (n + 1) | 1;
  T* Wr;
  int* f;  // the first column of each position's row that can hold a nonzero
  if constexpr (WS) {
    Wr = reinterpret_cast<T*>(smem_raw);
    f = reinterpret_cast<int*>(Wr + 2 * static_cast<size_t>(n) * ld);
  } else {
    Wr = scratch + 2 * static_cast<size_t>(s) * n * ld;
    f = reinterpret_cast<int*>(smem_raw);
  }
  T* Wi = Wr + static_cast<size_t>(n) * ld;
  const long long kk = int_arg(keff_ptr, keff_bytes, keff_val);
  const int k = kk < 0 ? 0 : (kk > n ? n : static_cast<int>(kk));

  // the active block into W, its max |h| and each row's profile
  for (int r = lane; r < k; r += 32) f[r] = r;
  __syncwarp();
  T m = T(0);
  for (int r = 0; r < k; ++r)
    for (int c = lane; c < k; c += 32) {
      const T v = H[static_cast<size_t>(r) * n + c];
      Wr[r * ld + c] = v;
      Wi[r * ld + c] = T(0);
      m = maxnan(m, fabs(v));
      if (c < r && v != T(0)) atomicMin(f + r, c);
    }
  // the range prescale of the block and the eigenvalues (range_exp)
  m = warp_max(m);
  const int re = range_exp(m);
  if (re) {
    __syncwarp();
    for (int r = 0; r < k; ++r)
      for (int c = lane; c < k; c += 32) Wr[r * ld + c] = ldexp(Wr[r * ld + c], -re);
    m = ldexp(m, -re);
  }
  // eps3 = eps (max |Hm| + 1) over the embedded matrix, whose dummy
  // diagonal (max |H_act| + 1)(2 + i / n) lies above the active block
  const T norm = radd(m, T(1));
  T mx = m;
  for (int i = k + lane; i < n; i += 32) mx = maxnan(mx, rmul(norm, radd(T(2), T(i) / T(n))));
  mx = warp_max(mx);
  const T eps3 = rmul(eps_of<T>(), radd(mx, T(1)));
  const T sep = rmul(T(4), eps3);

  // this slot's shift: wr + sep for each earlier slot within sep (dhsein)
  const T wrs = ldexp(wr[s], -re), wis = ldexp(wi[s], -re);
  int cnt = 0;
  for (int i0 = 0; i0 < s; i0 += 32) {
    const int i = i0 + lane;
    const bool close = i < s && radd(fabs(rsub(ldexp(wr[i], -re), wrs)),
                                     fabs(rsub(ldexp(wi[i], -re), wis))) <= sep;
    cnt += __popc(__ballot_sync(FULL, close));
  }
  const T wrp = radd(wrs, rmul(T(cnt), sep));

  // the diagonal of Hm - sigma I and the scaled right-hand side
  T bss = T(0);
  for (int i = lane; i < 2 * n; i += 32) {
    const T b = rhs_entry<T>(i);
    bss = radd(bss, rmul(b, b));
  }
  const T bn = sqrt(warp_sum(bss));
  __syncwarp();
  for (int r = lane; r < k; r += 32) {
    Wr[r * ld + r] = radd(rsub(Wr[r * ld + r], wrp), eps3);
    Wi[r * ld + r] = -wis;
    Wr[r * ld + n] = rhs_entry<T>(r) / bn;
    Wi[r * ld + n] = rhs_entry<T>(n + r) / bn;
  }
  __syncwarp();

  // LU with partial pivoting among the profile's rows
  for (int j = 0; j < k; ++j) {
    T best = T(-2);
    int bpos = INT_MAX;
    for (int r = j + lane; r < k; r += 32)
      if (f[r] <= j) {
        T sc = radd(fabs(Wr[r * ld + j]), fabs(Wi[r * ld + j]));
        if (sc != sc) sc = T(-1);
        if (sc > best) {
          best = sc;
          bpos = r;
        }
      }
    for (int o = 16; o > 0; o >>= 1) {
      const T ob = __shfl_xor_sync(FULL, best, o);
      const int op = __shfl_xor_sync(FULL, bpos, o);
      if (ob > best || (ob == best && op < bpos)) {
        best = ob;
        bpos = op;
      }
    }
    const int pv = bpos;  // position j is always among the profile's rows
    if (pv != j) {
      for (int c = j + lane; c < k; c += 32) {
        const T a = Wr[j * ld + c], b = Wi[j * ld + c];
        Wr[j * ld + c] = Wr[pv * ld + c];
        Wi[j * ld + c] = Wi[pv * ld + c];
        Wr[pv * ld + c] = a;
        Wi[pv * ld + c] = b;
      }
      if (lane == 0) {
        const T a = Wr[j * ld + n], b = Wi[j * ld + n];
        Wr[j * ld + n] = Wr[pv * ld + n];
        Wi[j * ld + n] = Wi[pv * ld + n];
        Wr[pv * ld + n] = a;
        Wi[pv * ld + n] = b;
        const int t = f[j];
        f[j] = f[pv];
        f[pv] = t;
      }
      __syncwarp();
    }
    T pr = Wr[j * ld + j];
    const T pi = Wi[j * ld + j];
    if (pr == T(0) && pi == T(0)) pr = eps3;  // an exact zero pivot: eps3, as dlaein
    T ir, ii;
    recip(pr, pi, ir, ii);
    for (int r0 = j + 1; r0 < k; r0 += 32) {
      const int rr = r0 + lane;
      unsigned mask = __ballot_sync(FULL, rr < k && f[rr] <= j);
      while (mask) {
        const int r = r0 + __ffs(mask) - 1;
        mask &= mask - 1;
        T lr, li;
        cmul(Wr[r * ld + j], Wi[r * ld + j], ir, ii, lr, li);
        for (int c = j + 1 + lane; c < k; c += 32) {
          T tr, ti;
          cmul(lr, li, Wr[j * ld + c], Wi[j * ld + c], tr, ti);
          Wr[r * ld + c] = rsub(Wr[r * ld + c], tr);
          Wi[r * ld + c] = rsub(Wi[r * ld + c], ti);
        }
        if (lane == 0) {
          T tr, ti;
          cmul(lr, li, Wr[j * ld + n], Wi[j * ld + n], tr, ti);
          Wr[r * ld + n] = rsub(Wr[r * ld + n], tr);
          Wi[r * ld + n] = rsub(Wi[r * ld + n], ti);
        }
      }
    }
    __syncwarp();
  }

  // back substitution, a column at a time; x overwrites the right-hand side
  for (int c = k - 1; c >= 0; --c) {
    T pr = Wr[c * ld + c];
    const T pi = Wi[c * ld + c];
    if (pr == T(0) && pi == T(0)) pr = eps3;
    T ir, ii, xr, xi;
    recip(pr, pi, ir, ii);
    cmul(Wr[c * ld + n], Wi[c * ld + n], ir, ii, xr, xi);
    __syncwarp();  // every lane has read y_c
    if (lane == 0) {
      Wr[c * ld + n] = xr;
      Wi[c * ld + n] = xi;
    }
    for (int i = lane; i < c; i += 32) {
      T tr, ti;
      cmul(Wr[i * ld + c], Wi[i * ld + c], xr, xi, tr, ti);
      Wr[i * ld + n] = rsub(Wr[i * ld + n], tr);
      Wi[i * ld + n] = rsub(Wi[i * ld + n], ti);
    }
    __syncwarp();
  }

  // the unit vector, a zero column when its norm is 0.  x is scaled down by
  // the power of two of its largest entry first (exact), so that its sum of
  // squares cannot overflow: near a defective eigenvalue |x| reaches
  // 1 / eps3^m (utils/hessenberg.py _unit_columns)
  T mxv = T(0);
  for (int i = lane; i < k; i += 32)
    mxv = maxnan(mxv, maxnan(fabs(Wr[i * ld + n]), fabs(Wi[i * ld + n])));
  mxv = warp_max(mxv);
  int e = 0;
  if (mxv > T(0) && isfinite(mxv)) frexp(mxv, &e);
  e = e > 0 ? e : 0;
  T ss = T(0);
  for (int i = lane; i < k; i += 32) {
    const T xr = ldexp(Wr[i * ld + n], -e), xi = ldexp(Wi[i * ld + n], -e);
    Wr[i * ld + n] = xr;
    Wi[i * ld + n] = xi;
    ss = radd(ss, radd(rmul(xr, xr), rmul(xi, xi)));
  }
  const T nrm = sqrt(warp_sum(ss));
  const T inv = nrm > T(0) ? T(1) / nrm : T(0);
  __syncwarp();

  int col = s;
  T res = T(0);
  if (ritz) {
    const bool live = s < k && int_arg(ok_ptr, ok_bytes, ok_val) != 0;
    if (p == 1) {  // |H[k, k-1]| |v[k-1]|
      const int km1 = k > 0 ? k - 1 : 0;
      const T beta = fabs(H[static_cast<size_t>(k) * n + km1]);
      T vr = T(0), vi = T(0);
      if (km1 < k) {
        vr = rmul(Wr[km1 * ld + n], inv);
        vi = rmul(Wi[km1 * ld + n], inv);
      }
      res = rmul(beta, sqrt(radd(rmul(vr, vr), rmul(vi, vi))));
    } else {  // ||B y_last||, B = H[k:k+p, k-p:k]
      const int kmp = k - p > 0 ? k - p : 0;
      T acc = T(0);
      for (int r = 0; r < p; ++r) {
        T br = T(0), bi = T(0);
        for (int c = 0; c < p; ++c) {
          const T b = H[static_cast<size_t>(k + r) * n + kmp + c];
          const int row = kmp + c;
          const T yr = row < k ? rmul(Wr[row * ld + n], inv) : T(0);
          const T yi = row < k ? rmul(Wi[row * ld + n], inv) : T(0);
          br = radd(br, rmul(b, yr));
          bi = radd(bi, rmul(b, yi));
        }
        acc = radd(acc, radd(rmul(br, br), rmul(bi, bi)));
      }
      res = sqrt(acc);
    }
    if (!live) res = T(INFINITY);
    // this slot's place in the stable order of -(wr^2 + wi^2)
    const T key = sort_key(wrs, wis);
    col = 0;
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + lane;
      const bool before =
          i < n && key_before(sort_key(ldexp(wr[i], -re), ldexp(wi[i], -re)), i, key, s);
      col += __popc(__ballot_sync(FULL, before));
    }
  }
  for (int r = lane; r < n; r += 32) {
    T vr = T(0), vi = T(0);
    if (r < k) {
      vr = rmul(Wr[r * ld + n], inv);
      vi = rmul(Wi[r * ld + n], inv);
    }
    Vr[static_cast<size_t>(r) * n + col] = vr;
    Vi[static_cast<size_t>(r) * n + col] = vi;
  }
  if (ritz && lane == 0) {
    wr_out[col] = wr[s];
    wi_out[col] = wi[s];
    res_out[col] = res;
    if (col < nev && isfinite(res) && res < static_cast<T>(tol)) atomicAdd(n_conv, 1);
  }
}

// Shared memory a slot's CTA needs: W where it lives there and the profile.
// ops/hessenberg.py ritz_geometry() computes the same.
long long ritz_smem_need(int n, int elt, bool w_smem) {
  const long long w = 2LL * n * ((n + 1) | 1) * elt;
  return (w_smem ? w : 0) + 4LL * n;
}

template <typename K> cudaError_t allow_smem(K kernel, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             RZ_SMEM_LIMIT - RZ_SMEM_RESERVED);
  if (err == cudaSuccess) done[dev] = true;
  return err;
}

bool int_arg_ok(const void* ptr, int bytes) {
  return bytes == 0 || ((bytes == 1 || bytes == 4 || bytes == 8) && ptr);
}

template <typename T, bool WS>
cudaError_t launch_ritz_as(const void* H, const void* wr, const void* wi, const void* ok,
                           int ok_bytes, long long ok_val, const void* keff, int keff_bytes,
                           long long keff_val, double tol, long long nev, int p, int ritz,
                           void* wr_out, void* wi_out, void* res_out, void* Vr, void* Vi,
                           void* n_conv, void* scratch, int n, int smem, cudaStream_t stream) {
  static bool done[64] = {};
  cudaError_t err = allow_smem(ritz_kernel<T, WS>, done);
  if (err != cudaSuccess) return err;
  ritz_kernel<T, WS><<<n, 32, static_cast<size_t>(smem), stream>>>(
      static_cast<const T*>(H), static_cast<const T*>(wr), static_cast<const T*>(wi), ok,
      ok_bytes, ok_val, keff, keff_bytes, keff_val, tol, nev, p, ritz, static_cast<T*>(wr_out),
      static_cast<T*>(wi_out), static_cast<T*>(res_out), static_cast<T*>(Vr),
      static_cast<T*>(Vi), static_cast<int*>(n_conv), static_cast<T*>(scratch), n);
  return cudaGetLastError();
}

template <typename T>
int launch_ritz(const void* H, const void* wr, const void* wi, const void* ok, int ok_bytes,
                long long ok_val, const void* keff, int keff_bytes, long long keff_val,
                double tol, long long nev, int p, int ritz, void* wr_out, void* wi_out,
                void* res_out, void* Vr, void* Vi, void* n_conv, void* scratch, int n,
                int w_smem, int smem, void* stream) {
  const bool outs = !ritz || (wr_out && wi_out && res_out && n_conv);
  if (!H || !wr || !wi || !Vr || !Vi || !outs || !int_arg_ok(ok, ok_bytes) ||
      !int_arg_ok(keff, keff_bytes) || n < 1 || p < 1 || (!w_smem && !scratch) ||
      smem < ritz_smem_need(n, sizeof(T), w_smem) ||
      smem > RZ_SMEM_LIMIT - RZ_SMEM_RESERVED)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (w_smem)
    err = launch_ritz_as<T, true>(H, wr, wi, ok, ok_bytes, ok_val, keff, keff_bytes, keff_val,
                                  tol, nev, p, ritz, wr_out, wi_out, res_out, Vr, Vi, n_conv,
                                  scratch, n, smem, s);
  else
    err = launch_ritz_as<T, false>(H, wr, wi, ok, ok_bytes, ok_val, keff, keff_bytes,
                                   keff_val, tol, nev, p, ritz, wr_out, wi_out, res_out, Vr,
                                   Vi, n_conv, scratch, n, smem, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

int lk_ritz_f32(const void* H, const void* wr, const void* wi, const void* ok, int ok_bytes,
                long long ok_val, const void* keff, int keff_bytes, long long keff_val,
                double tol, long long nev, int p, int ritz, void* wr_out, void* wi_out,
                void* res_out, void* Vr, void* Vi, void* n_conv, void* scratch, int n,
                int w_smem, int smem_bytes, void* stream) {
  return launch_ritz<float>(H, wr, wi, ok, ok_bytes, ok_val, keff, keff_bytes, keff_val, tol,
                            nev, p, ritz, wr_out, wi_out, res_out, Vr, Vi, n_conv, scratch, n,
                            w_smem, smem_bytes, stream);
}

int lk_ritz_f64(const void* H, const void* wr, const void* wi, const void* ok, int ok_bytes,
                long long ok_val, const void* keff, int keff_bytes, long long keff_val,
                double tol, long long nev, int p, int ritz, void* wr_out, void* wi_out,
                void* res_out, void* Vr, void* Vi, void* n_conv, void* scratch, int n,
                int w_smem, int smem_bytes, void* stream) {
  return launch_ritz<double>(H, wr, wi, ok, ok_bytes, ok_val, keff, keff_bytes, keff_val, tol,
                             nev, p, ritz, wr_out, wi_out, res_out, Vr, Vi, n_conv, scratch, n,
                             w_smem, smem_bytes, stream);
}

}  // extern "C"
