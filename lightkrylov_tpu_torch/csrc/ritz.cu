// The inverse iteration and the Ritz analysis of one device check: a warp
// an eigenvalue, a few eigenvalues a CTA.
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
// input.
//
// Bound: latency.  A solve is a chain of k elimination steps and k
// back-substitution steps, each a pivot choice or a complex product and one
// row or column update of at most k entries: a few thousand dependent
// operations on a few hundred KB.  The design keeps the chain in registers:
//
// - A CTA holds up to RZ_MAX_SLOTS eigenvalue slots, a warp each
//   (ops/hessenberg.py ritz_geometry()).  It stages, once for its slots,
//   the active block (cp.async, into shared memory when it fits), the
//   profile (a ballot a row chunk), the rows that enter the elimination at
//   each step, the prescaled eigenvalues and the scaled right-hand side.
// - On a profile of at most two candidate rows a step (the check's
//   Hessenberg and arrow forms) the elimination carries the one row that
//   stays a candidate in registers, a lane a column (COLS columns a lane),
//   and reads the entering row from the staged block.  A step's pivot is a
//   compare of the two rows' |re| + |im| at the column (one shuffle, ties to
//   the lower position), and the pivot's reciprocal is kept in U's diagonal
//   place.  The finished row of U goes
//   to the slot's working matrix W (n rows of odd stride ld = (n + 1) | 1,
//   real and imaginary parts apart, the right-hand side in column n), off
//   the chain.  Every load of a step is made at an index inside the block
//   and selected after, so that no branch orders the loads.
// - Other profiles (a block Arnoldi band, a dense input) take the general
//   path: W built from the staged block, a warp argmax over the profile's
//   rows, the row updates in W.
// - The back substitution holds y in registers, a lane a row, and takes one
//   shuffle and no division a column (the reciprocals are elimination's).
//   With COLS = 0 (k > 320) it runs in W, a column at a time.
// - Each slot counts its own place in the stable modulus-descending order
//   and writes wr, wi, the residual and its vector's column straight into
//   that place; the converged count is an integer atomicAdd into a zeroed
//   output, so the result does not hang on the CTAs' order.
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
constexpr int RZ_MAX_SLOTS = 4;
constexpr unsigned FULL = 0xffffffffu;

// The lagging-warp build (-DLK_LAG_WARP=1, ops/_build.py load_lagging(); off
// in the shipping build): at the start of each stretch between two barriers
// of the staging one warp, turning with the stretch, sleeps before its loads
// and stores (csrc/hessenberg.cu lag()).
#ifndef LK_LAG_WARP
#define LK_LAG_WARP 0
#endif
constexpr unsigned LAG_NS = 2000;

__device__ __forceinline__ void lag(int stretch) {
#if LK_LAG_WARP
  if (static_cast<int>(threadIdx.x >> 5) == stretch % static_cast<int>(blockDim.x >> 5))
    __nanosleep(LAG_NS);
#endif
}

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

// max and sum over the CTA of one value a thread; every thread gets it
template <typename T> __device__ T block_max(T v, T* red) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T m = T(0);
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) m = maxnan(m, red[w]);
  return m;
}

template <typename T> __device__ T block_sum(T v, T* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T m = T(0);
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) m += red[w];
  return m;
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

// 1 / (br + i bi) by Smith's formula, as utils/hessenberg.py _recip, an
// exact zero first replaced by eps3 (dlaein): with |br| >= |bi|,
// r = bi / br, d = br + bi r, 1 / d - i r / d; else r = br / bi,
// d = bi + br r, r / d - i / d.  Called by a whole warp on the same
// operands: the two last divisions, independent, are one division on
// lanes 0 (1 / d) and 1 (r / d), so that the warp waits for one.
template <typename T>
__device__ __forceinline__ void recip(T br, T bi, T eps3, T& ir, T& ii) {
  if (br == T(0) && bi == T(0)) br = eps3;
  const bool big = fabs(br) >= fabs(bi);
  const T num = big ? bi : br, den = big ? br : bi;
  const T r = num / den;
  const T d = radd(den, rmul(num, r));
  const T q = ((threadIdx.x & 1) ? r : T(1)) / d;
  const T one_d = __shfl_sync(FULL, q, 0), r_d = __shfl_sync(FULL, q, 1);
  ir = big ? one_d : r_d;
  ii = big ? -r_d : -one_d;
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

// the score of a pivot candidate, |re| + |im|, a NaN as -1
template <typename T> __device__ __forceinline__ T score(T re, T im) {
  const T sc = radd(fabs(re), fabs(im));
  return sc != sc ? T(-1) : sc;
}

// v[q] for the uniform index q < COLS, with every index fixed at compile time
template <int COLS, typename T> __device__ __forceinline__ T pick(const T (&v)[COLS], int q) {
  T out = v[0];
#pragma unroll
  for (int i = 1; i < COLS; ++i)
    if (q == i) out = v[i];
  return out;
}

// one element of the global active block into shared memory, by cp.async
template <typename T> __device__ __forceinline__ void copy_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
               "n"(sizeof(T)));
}

// 2^-re as two factors whose products with an entry of the block are exact
// but for the one rounding of ldexp(v, -re): 2^-re alone when it scales
// down (it is a normal or subnormal number), two halves of it when it
// scales up (neither product rounds: the block's largest entry ends below
// 1); 1 and 1 when re = 0, which changes no bit
template <typename T> __device__ __forceinline__ void scale_factors(int re, T& s1, T& s2) {
  s1 = s2 = T(1);
  if (re > 0) s1 = ldexp(T(1), -re);
  if (re < 0) {
    s1 = ldexp(T(1), -re / 2);
    s2 = ldexp(T(1), -re - (-re / 2));
  }
}

// The working matrix of one slot and what its solve reads: the active
// block (staged or global, raw), its scale, the slot's shift
template <typename T> struct Solve {
  const T* h;  // entry (r, c) of the active block at h[r * ldh + c], unscaled
  int ldh, k, n, ld;
  T s1, s2;  // the prescale, scale_factors
  T wrp, wis, eps3;
  const T* rhs;  // the scaled right-hand side, real parts then imaginary
  // entry (r, c) of A = Hm - (wr' - eps3) I, real part (scaled block)
  __device__ __forceinline__ T a(int r, int c) const {
    const T v = rmul(rmul(h[r * ldh + c], s1), s2);
    return c == r ? radd(rsub(v, wrp), eps3) : v;
  }
  // its imaginary part: -wi on the diagonal
  __device__ __forceinline__ T ai(int r, int c) const { return c == r ? -wis : T(0); }
};

// The elimination when every step has at most two candidate rows: the row
// that stays a candidate (C, at position cpos) in registers, a lane a
// column, the entering row (F, at its own position rf) from the staged
// block; U's rows into W, its diagonal place holding the pivot's
// reciprocal, the right-hand side in column n
template <typename T, int COLS>
__device__ __forceinline__ void eliminate_two_rows(const Solve<T>& S, const int* e0,
                                                   const int* e1, T* Wr, T* Wi, int lane) {
  const int k = S.k, ld = S.ld, n = S.n;
  T Cr[COLS], Ci[COLS], Fr[COLS];
  T ycr = T(0), yci = T(0);
  int cpos = 0;
  bool have_c = false;
  for (int j = 0; j < k; ++j) {
    int rf;
    if (!have_c) {  // position j leads (its row enters now: e0[j] == j)
      const int rc = e0[j];
#pragma unroll
      for (int q = 0; q < COLS; ++q) {
        const int c = lane + 32 * q;
        const T v = S.a(rc, c < k ? c : k - 1);
        Cr[q] = c < k ? v : T(0);
        Ci[q] = S.ai(rc, c);
      }
      ycr = S.rhs[rc];
      yci = S.rhs[n + rc];
      cpos = j;
      have_c = true;
      rf = e1[j];
    } else {
      rf = e0[j];
    }
    const bool have_f = rf < INT_MAX;
    const int rfc = have_f ? rf : j;
#pragma unroll
    for (int q = 0; q < COLS; ++q) {
      const int c = lane + 32 * q;
      const T v = S.a(rfc, c < k ? c : k - 1);
      Fr[q] = have_f && c < k ? v : T(0);
    }
    const T yfr0 = S.rhs[rfc], yfi0 = S.rhs[n + rfc], fjr0 = S.a(rfc, j);
    const T yfr = have_f ? yfr0 : T(0), yfi = have_f ? yfi0 : T(0);
    const T fjr = have_f ? fjr0 : T(0), fji = have_f ? S.ai(rfc, j) : T(0);
    // C's entry in column j, from its lane
    const T cjr = __shfl_sync(FULL, pick(Cr, j >> 5), j & 31);
    const T cji = __shfl_sync(FULL, pick(Ci, j >> 5), j & 31);
    // the larger |re| + |im|, ties to the lower position
    const T sc = score(cjr, cji), sf = score(fjr, fji);
    const bool piv_f = have_f && (cpos == j ? sf > sc : sf >= sc);
    T ir, ii;
    recip(piv_f ? fjr : cjr, piv_f ? fji : cji, S.eps3, ir, ii);
    // U's row j: the pivot row
#pragma unroll
    for (int q = 0; q < COLS; ++q) {
      const int c = lane + 32 * q;
      if (c > j && c < k) {
        Wr[j * ld + c] = piv_f ? Fr[q] : Cr[q];
        Wi[j * ld + c] = piv_f ? S.ai(rfc, c) : Ci[q];
      }
    }
    if (lane == 0) {
      Wr[j * ld + j] = ir;
      Wi[j * ld + j] = ii;
      Wr[j * ld + n] = piv_f ? yfr : ycr;
      Wi[j * ld + n] = piv_f ? yfi : yci;
    }
    if (!have_f) {  // one candidate, the pivot: no elimination
      have_c = false;
      continue;
    }
    // the other row less l times the pivot row, columns > j: it is carried
    T lr, li;
    cmul(piv_f ? cjr : fjr, piv_f ? cji : fji, ir, ii, lr, li);
#pragma unroll
    for (int q = 0; q < COLS; ++q) {
      const int c = lane + 32 * q;
      const T fi = S.ai(rfc, c);
      const T pr = piv_f ? Fr[q] : Cr[q], pi = piv_f ? fi : Ci[q];
      const T orr = piv_f ? Cr[q] : Fr[q], oi = piv_f ? Ci[q] : fi;
      T tr, ti;
      cmul(lr, li, pr, pi, tr, ti);
      Cr[q] = rsub(orr, tr);
      Ci[q] = rsub(oi, ti);
    }
    T tr, ti;
    cmul(lr, li, piv_f ? yfr : ycr, piv_f ? yfi : yci, tr, ti);
    const T oyr = piv_f ? ycr : yfr, oyi = piv_f ? yci : yfi;
    ycr = rsub(oyr, tr);
    yci = rsub(oyi, ti);
    cpos = cpos + rf - j;  // the candidate position that is not j
  }
}

// The general elimination, in W: the rows of each step's profile (fpos, the
// slot's copy, swapped with its rows), a warp argmax of |re| + |im| (ties to
// the lower position), a lane a column; W[j][j] then holds the pivot's
// reciprocal
template <typename T>
__device__ __forceinline__ void eliminate_general(const Solve<T>& S, int* fpos, T* Wr, T* Wi,
                                                  int lane) {
  const int k = S.k, ld = S.ld, n = S.n;
  for (int r = 0; r < k; ++r)
    for (int c = lane; c < k; c += 32) {
      Wr[r * ld + c] = S.a(r, c);
      Wi[r * ld + c] = S.ai(r, c);
    }
  for (int r = lane; r < k; r += 32) {
    Wr[r * ld + n] = S.rhs[r];
    Wi[r * ld + n] = S.rhs[n + r];
  }
  __syncwarp();
  for (int j = 0; j < k; ++j) {
    T best = T(-2);
    int bpos = INT_MAX;
    for (int r = j + lane; r < k; r += 32)
      if (fpos[r] <= j) {
        const T sc = score(Wr[r * ld + j], Wi[r * ld + j]);
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
        const int t = fpos[j];
        fpos[j] = fpos[pv];
        fpos[pv] = t;
      }
      __syncwarp();
    }
    T ir, ii;
    recip(Wr[j * ld + j], Wi[j * ld + j], S.eps3, ir, ii);
    for (int r0 = j + 1; r0 < k; r0 += 32) {
      const int rr = r0 + lane;
      unsigned mask = __ballot_sync(FULL, rr < k && fpos[rr] <= j);
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
    if (lane == 0) {  // every lane has read the pivot (the ballots above)
      Wr[j * ld + j] = ir;
      Wi[j * ld + j] = ii;
    }
    __syncwarp();
  }
}

// The back substitution, a column at a time, x into W's column n: y in
// registers, a lane a row (COLS rows a lane), x_c = y_c / u_cc by the kept
// reciprocal, then y_i -= u_ic x_c; with COLS = 0, y in W's column n
template <typename T, int COLS>
__device__ __forceinline__ void back_substitute(int k, int ld, int n, T* Wr, T* Wi, int lane) {
  __syncwarp();
  if constexpr (COLS > 0) {
    T Yr[COLS], Yi[COLS];
#pragma unroll
    for (int q = 0; q < COLS; ++q) {
      const int i = lane + 32 * q;
      Yr[q] = i < k ? Wr[i * ld + n] : T(0);
      Yi[q] = i < k ? Wi[i * ld + n] : T(0);
    }
    for (int c = k - 1; c >= 0; --c) {
      T xr, xi;
      cmul(pick(Yr, c >> 5), pick(Yi, c >> 5), Wr[c * ld + c], Wi[c * ld + c], xr, xi);
      xr = __shfl_sync(FULL, xr, c & 31);
      xi = __shfl_sync(FULL, xi, c & 31);
      if (lane == (c & 31)) {
        Wr[c * ld + n] = xr;
        Wi[c * ld + n] = xi;
      }
#pragma unroll
      for (int q = 0; q < COLS; ++q) {
        const int i = lane + 32 * q, ii = i < c ? i : 0;
        T tr, ti;
        cmul(Wr[ii * ld + c], Wi[ii * ld + c], xr, xi, tr, ti);
        Yr[q] = i < c ? rsub(Yr[q], tr) : Yr[q];
        Yi[q] = i < c ? rsub(Yi[q], ti) : Yi[q];
      }
    }
  } else {
    for (int c = k - 1; c >= 0; --c) {
      T xr, xi;
      cmul(Wr[c * ld + n], Wi[c * ld + n], Wr[c * ld + c], Wi[c * ld + c], xr, xi);
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
  }
  __syncwarp();
}

// Slots s = blockIdx.x * slots + warp: the inverse iteration of
// (wr[s], wi[s]) on the active block of H (row stride n; rows k..k+p-1 the
// coupling of a check), then, with ritz, its residual and place in the
// order.  Shared memory: the staged block (with h_smem), the prescaled
// eigenvalues and right-hand side, the profile, the rows entering at each
// step and their counts, then each slot's W (WS) and profile copy.
template <typename T, int COLS, bool WS>
__global__ void __launch_bounds__(RZ_MAX_SLOTS * 32, 1)
ritz_kernel(const T* __restrict__ H, const T* __restrict__ wr, const T* __restrict__ wi,
            const void* ok_ptr, int ok_bytes, long long ok_val, const void* keff_ptr,
            int keff_bytes, long long keff_val, double tol, long long nev, int p, int ritz,
            T* __restrict__ wr_out, T* __restrict__ wi_out, T* __restrict__ res_out,
            T* __restrict__ Vr, T* __restrict__ Vi, int* n_conv, T* scratch, int n, int slots,
            int h_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[RZ_MAX_SLOTS];
  __shared__ int two_rows;
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int ld = (n + 1) | 1, ldh = h_smem ? (n | 1) : n;
  T* base = reinterpret_cast<T*>(smem_raw);
  T* Hs = base;
  if (h_smem) base += static_cast<size_t>(n) * ldh;
  T* wrs = base;
  T* wis = wrs + n;
  T* rhs = wis + n;  // 2n: real parts, then imaginary parts
  base = rhs + 2 * n;
  T* Wslots = base;
  if constexpr (WS) base += static_cast<size_t>(slots) * 2 * n * ld;
  int* f = reinterpret_cast<int*>(base);  // each row's first column that can hold a nonzero
  int* e0 = f + n;                        // the first and second row whose profile is j
  int* e1 = e0 + n;
  int* cnt = e1 + n;  // the rows whose profile is j
  int* fslots = cnt + n;
  const long long kk = int_arg(keff_ptr, keff_bytes, keff_val);
  const int k = kk < 0 ? 0 : (kk > n ? n : static_cast<int>(kk));

  // the active block, staged once for the CTA's slots; the right-hand
  // side's entries while the copies are in flight
  lag(0);
  if (h_smem)
    for (int idx = tid; idx < k * k; idx += nt)
      copy_async(Hs + (idx / k) * ldh + idx % k, H + static_cast<size_t>(idx / k) * n + idx % k);
  for (int i = tid; i < n; i += nt) {
    f[i] = i;
    e0[i] = INT_MAX;
    e1[i] = INT_MAX;
    cnt[i] = 0;
  }
  T bss = T(0);
  for (int i = tid; i < 2 * n; i += nt) {
    const T b = rhs_entry<T>(i);
    rhs[i] = b;
    bss = radd(bss, rmul(b, b));
  }
  if (h_smem) asm volatile("cp.async.wait_all;\n" ::: "memory");
  const T* hb = h_smem ? Hs : H;
  __syncthreads();
  // a warp a row: max |h| and the profile, each active row's first nonzero
  // left of the diagonal, a ballot a chunk of 32 columns
  lag(1);
  T m = T(0);
  for (int r = warp; r < k; r += nt >> 5) {
    int fr = r;
    for (int c0 = 0; c0 < k; c0 += 32) {
      const int c = c0 + lane;
      const T v = c < k ? hb[r * ldh + c] : T(0);
      m = maxnan(m, fabs(v));
      const unsigned bits = __ballot_sync(FULL, c < r && v != T(0));
      if (bits && fr == r) fr = c0 + __ffs(bits) - 1;
    }
    if (lane == 0) f[r] = fr;
  }
  m = block_max(m, red);  // its barriers publish f
  // the range prescale of the block and the eigenvalues (range_exp)
  const int re = range_exp(m);
  if (re) m = ldexp(m, -re);
  T s1, s2;
  scale_factors(re, s1, s2);
  lag(2);
  if (re > 0)  // the profile of the scaled block (the plain version's): an
               // entry may underflow to zero
    for (int r = warp; r < k; r += nt >> 5) {
      int fr = r;
      for (int c0 = 0; c0 < r && fr == r; c0 += 32) {
        const int c = c0 + lane;
        const T v = c < r ? rmul(rmul(hb[r * ldh + c], s1), s2) : T(0);
        const unsigned bits = __ballot_sync(FULL, v != T(0));
        if (bits) fr = c0 + __ffs(bits) - 1;
      }
      if (lane == 0) f[r] = fr;
    }
  for (int i = tid; i < n; i += nt) {
    wrs[i] = re ? ldexp(wr[i], -re) : wr[i];
    wis[i] = re ? ldexp(wi[i], -re) : wi[i];
  }
  const T bn = sqrt(block_sum(bss, red));  // its barriers publish f, wrs, wis, rhs
  lag(3);
  for (int i = tid; i < 2 * n; i += nt) rhs[i] = rhs[i] / bn;
  for (int r = tid; r < k; r += nt) {
    atomicAdd(cnt + f[r], 1);
    atomicMin(e0 + f[r], r);
  }
  __syncthreads();
  lag(4);
  for (int r = tid; r < k; r += nt)
    if (e0[f[r]] != r) atomicMin(e1 + f[r], r);
  if (warp == 0) {  // at most two candidates a step: rows with profile <= j, less j
    int carry = 0;
    bool over = false;
    for (int j0 = 0; j0 < k; j0 += 32) {
      const int j = j0 + lane;
      int v = j < k ? cnt[j] : 0;
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(FULL, v, o);
        if (lane >= o) v += u;
      }
      over |= __ballot_sync(FULL, j < k && carry + v - j > 2) != 0;
      carry += __shfl_sync(FULL, v, 31);
    }
    if (lane == 0) two_rows = COLS > 0 && !over;
  }
  __syncthreads();

  const int s = blockIdx.x * slots + warp;
  if (s >= n) return;
  T* Wr = WS ? Wslots + static_cast<size_t>(warp) * 2 * n * ld
             : scratch + 2 * static_cast<size_t>(s) * n * ld;
  T* Wi = Wr + static_cast<size_t>(n) * ld;
  // eps3 = eps (max |Hm| + 1) over the embedded matrix, whose dummy
  // diagonal (max |H_act| + 1)(2 + i / n) lies above the active block
  const T norm = radd(m, T(1));
  T mx = m;
  for (int i = k + lane; i < n; i += 32) mx = maxnan(mx, rmul(norm, radd(T(2), T(i) / T(n))));
  mx = warp_max(mx);
  const T eps3 = rmul(eps_of<T>(), radd(mx, T(1)));
  const T sep = rmul(T(4), eps3);
  // this slot's shift: wr + sep for each earlier slot within sep (dhsein)
  const T wrss = wrs[s], wiss = wis[s];
  int close_n = 0;
  for (int i0 = 0; i0 < s; i0 += 32) {
    const int i = i0 + lane;
    const bool close = i < s && radd(fabs(rsub(wrs[i], wrss)), fabs(rsub(wis[i], wiss))) <= sep;
    close_n += __popc(__ballot_sync(FULL, close));
  }
  const Solve<T> S{hb, ldh, k, n, ld, s1, s2, radd(wrss, rmul(T(close_n), sep)), wiss, eps3,
                   rhs};

  if constexpr (COLS > 0) {
    if (two_rows) {
      eliminate_two_rows<T, COLS>(S, e0, e1, Wr, Wi, lane);
    } else {
      int* fpos = fslots + warp * n;
      for (int r = lane; r < k; r += 32) fpos[r] = f[r];
      __syncwarp();
      eliminate_general(S, fpos, Wr, Wi, lane);
    }
  } else {
    int* fpos = fslots + warp * n;
    for (int r = lane; r < k; r += 32) fpos[r] = f[r];
    __syncwarp();
    eliminate_general(S, fpos, Wr, Wi, lane);
  }
  back_substitute<T, COLS>(k, ld, n, Wr, Wi, lane);

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
    const T key = sort_key(wrss, wiss);
    col = 0;
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + lane;
      const bool before = i < n && key_before(sort_key(wrs[i], wis[i]), i, key, s);
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

// Shared memory a CTA of `slots` slots needs: the staged block with
// h_smem, the eigenvalues and right-hand side (4n entries), the profile, its
// entering rows and counts (4n ints), then each slot's W with w_smem and its
// profile copy (n ints).  ops/hessenberg.py ritz_geometry() computes the
// same.
long long ritz_smem_need(int n, int elt, int slots, bool h_smem, bool w_smem) {
  const long long w = 2LL * n * ((n + 1) | 1) * elt;
  const long long h = 1LL * n * (n | 1) * elt;
  return (h_smem ? h : 0) + 4LL * n * elt + 16LL * n + slots * ((w_smem ? w : 0) + 4LL * n);
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

struct RitzArgs {
  const void *H, *wr, *wi, *ok;
  int ok_bytes;
  long long ok_val;
  const void* keff;
  int keff_bytes;
  long long keff_val;
  double tol;
  long long nev;
  int p, ritz;
  void *wr_out, *wi_out, *res_out, *Vr, *Vi, *n_conv, *scratch;
  int n, slots, h_smem, smem;
  cudaStream_t stream;
};

template <typename T, int COLS, bool WS> cudaError_t launch_ritz_as(const RitzArgs& a) {
  static bool done[64] = {};
  cudaError_t err = allow_smem(ritz_kernel<T, COLS, WS>, done);
  if (err != cudaSuccess) return err;
  const int grid = (a.n + a.slots - 1) / a.slots;
  ritz_kernel<T, COLS, WS><<<grid, 32 * a.slots, static_cast<size_t>(a.smem), a.stream>>>(
      static_cast<const T*>(a.H), static_cast<const T*>(a.wr), static_cast<const T*>(a.wi),
      a.ok, a.ok_bytes, a.ok_val, a.keff, a.keff_bytes, a.keff_val, a.tol, a.nev, a.p, a.ritz,
      static_cast<T*>(a.wr_out), static_cast<T*>(a.wi_out), static_cast<T*>(a.res_out),
      static_cast<T*>(a.Vr), static_cast<T*>(a.Vi), static_cast<int*>(a.n_conv),
      static_cast<T*>(a.scratch), a.n, a.slots, a.h_smem);
  return cudaGetLastError();
}

template <typename T, bool WS> cudaError_t launch_ritz_cols(const RitzArgs& a, int cols) {
  switch (cols) {
    case 1: return launch_ritz_as<T, 1, WS>(a);
    case 2: return launch_ritz_as<T, 2, WS>(a);
    case 4: return launch_ritz_as<T, 4, WS>(a);
    case 10: return launch_ritz_as<T, 10, WS>(a);
    default: return launch_ritz_as<T, 0, WS>(a);
  }
}

template <typename T> int launch_ritz(const RitzArgs& a, int cols, int w_smem) {
  const bool outs = !a.ritz || (a.wr_out && a.wi_out && a.res_out && a.n_conv);
  const bool cols_ok = (cols == 0 && a.n > 320) || (cols > 0 && 32 * cols >= a.n &&
                                                    (cols == 1 || cols == 2 || cols == 4 ||
                                                     cols == 10));
  if (!a.H || !a.wr || !a.wi || !a.Vr || !a.Vi || !outs || !int_arg_ok(a.ok, a.ok_bytes) ||
      !int_arg_ok(a.keff, a.keff_bytes) || a.n < 1 || a.p < 1 || (!w_smem && !a.scratch) ||
      a.slots < 1 || a.slots > RZ_MAX_SLOTS || !cols_ok ||
      a.smem < ritz_smem_need(a.n, sizeof(T), a.slots, a.h_smem, w_smem) ||
      a.smem > RZ_SMEM_LIMIT - RZ_SMEM_RESERVED)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      w_smem ? launch_ritz_cols<T, true>(a, cols) : launch_ritz_cols<T, false>(a, cols);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

int lk_ritz_f32(const void* H, const void* wr, const void* wi, const void* ok, int ok_bytes,
                long long ok_val, const void* keff, int keff_bytes, long long keff_val,
                double tol, long long nev, int p, int ritz, void* wr_out, void* wi_out,
                void* res_out, void* Vr, void* Vi, void* n_conv, void* scratch, int n,
                int slots, int h_smem, int w_smem, int cols, int smem_bytes, void* stream) {
  const RitzArgs a{H, wr, wi, ok, ok_bytes, ok_val, keff, keff_bytes, keff_val, tol, nev, p,
                   ritz, wr_out, wi_out, res_out, Vr, Vi, n_conv, scratch, n, slots, h_smem,
                   smem_bytes, static_cast<cudaStream_t>(stream)};
  return launch_ritz<float>(a, cols, w_smem);
}

int lk_ritz_f64(const void* H, const void* wr, const void* wi, const void* ok, int ok_bytes,
                long long ok_val, const void* keff, int keff_bytes, long long keff_val,
                double tol, long long nev, int p, int ritz, void* wr_out, void* wi_out,
                void* res_out, void* Vr, void* Vi, void* n_conv, void* scratch, int n,
                int slots, int h_smem, int w_smem, int cols, int smem_bytes, void* stream) {
  const RitzArgs a{H, wr, wi, ok, ok_bytes, ok_val, keff, keff_bytes, keff_val, tol, nev, p,
                   ritz, wr_out, wi_out, res_out, Vr, Vi, n_conv, scratch, n, slots, h_smem,
                   smem_bytes, static_cast<cudaStream_t>(stream)};
  return launch_ritz<double>(a, cols, w_smem);
}

}  // extern "C"
