// The projected Hessenberg eigensolve of the device projected path: Francis
// double-shift QR on one real matrix, in one CTA.
//
// Replaces code that the JAX package computes outside Pallas, in
// lightkrylov_tpu/utils/hessenberg.py, where jax.jit compiles the iteration
// into one program:
//
//   hessenberg_schur: _embed (:166), _to_hessenberg (:179), _schur_core
//     (:226, with _chase :85 and _householder3 :69), optionally
//     _split_real_blocks (:364), and _extract_eigvals (:311), as
//     hessenberg_eigvals (:341) and schur_real (:418) call them;
//   francis_filter_sweeps: the kdim // 2 sweeps of francis_filter (:687-714).
//
// Bound: latency, not bytes or operations.  The work is a chain of a few
// thousand small dependent steps (a chase step is a 3-element Householder
// reflector applied to 3 rows and 3 columns of an n x n matrix, and needs the
// previous step's result); the matrix is at most a few hundred KB.  On the
// H100 a step costs its reflector's sqrt and division and two exchanges
// through shared memory (a store, a barrier and a load, each some 150-200
// cycles), so the design keeps every step to those and takes the rest off
// the chain:
//
// - A thread a row or column (ceil(n / 32) warps, at most 8; one warp
//   synchronises by __syncwarp).  The caller decides the geometry
//   (ops/hessenberg.py, geometry()) and the launcher checks it.  Every thread
//   computes the step's reflector from the same values, so the scalars need
//   no broadcast.
// - A step's row update covers columns [p-1, n) and its column update rows
//   [0, min(p+3, hi)]: the entries outside are exact zeros of the Hessenberg
//   form, whose products the full-slice updates of the JAX code leave zero.
//   The row update's threads of columns p..p+2 also copy rows p+1 and p+2
//   of those columns into a 2 x 3 staging block, and every thread holds the
//   subdiagonal entry H[p+3, p+2], read a step ahead (row p+3's other two
//   entries there are exact zeros); after the barrier every thread forms
//   from these the three entries of column p that the next reflector reads,
//   and that reflector, before the column update, so that the column update
//   overwrites those rows with no reader left.
// - H and Z live in shared memory when they fit, H's rows padded to an odd
//   stride so that a column access is free of bank conflicts, Z transposed
//   (Z: n <= 119 in f64, 169 in f32; H alone: 169 and 239); else in the
//   output buffers.  A thread keeps its row of Z in the three columns a
//   step touches in registers, loading one entry a step ahead and storing
//   one.
// - One warp scans the subdiagonal each sweep: a ballot a chunk of 32 finds
//   the open test, the zero-neighbour test, the deflated entries, hi and lo,
//   in O(n / 32) steps; the zero-neighbour max |H| is a shuffle reduction.
//   The same warp forms the chase's first vector and publishes it with the
//   window, so that no thread of the chase reads the entries that its first
//   row update writes.
// - The reduction to Hessenberg form applies each column's reflector only
//   where its vector u is nonzero: rows and columns [j+1, m], m the last
//   nonzero row of column j (a ballot), since u's other entries are exact
//   zeros.  On an Arnoldi Hessenberg m = j+1, so a column costs O(n) and
//   three CTA barriers.
//
// The arithmetic is the JAX code's as the plain version computes it,
// operation for operation: the embedding's dummy diagonal, every column's
// reflector of the reduction (sign flips included), the 30 n sweep budget,
// the LAPACK dlahqr-style deflation test with the zero-neighbour safeguard,
// the Wilkinson and exceptional shifts, the closing Givens rotation, the
// annihilated bulge entries set to exactly zero, the block split and the
// eigenvalues.  Two departures from the JAX code, in both: a reflector's or
// a rotation's vector too small to square (its sum of squares below
// (sqrt(tiny) / eps)^2) is scaled by an exact power of two first
// (pow2_exp), which leaves every other vector's arithmetic as it was; and an
// active block whose largest entry lies outside [sqrt(tiny) / eps,
// eps / sqrt(tiny)] is scaled into [0.5, 1) by a power of two first, T and
// the eigenvalues unscaled after (range_exp, LAPACK xGEEV's prescale; the
// filter scales H and its shifts alike and unscales Hf), which changes
// nothing inside the range.  Scalar formulas round each operation
// as numpy does, and the small products of the chase, the closing rotation and the
// split are the plain version's ordered sums (utils/hessenberg.py
// _ordered_rows: sum3 and sum2 below), so on a Hessenberg input the kernel
// takes the same sweeps and chase steps as the plain version (chip_smoke.py
// phase 33 (a) and the cuda tests hold it to that).  Only the reduction's sums over a dense column
// (u^T H, H u, Z u) are taken in another order than the plain version's,
// which leaves them to the library; on a column that is already Hessenberg
// they hold one nonzero product, exact in any order.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (lightkrylov_tpu_torch/ops/_build.py).  The C entries
// launch on the given stream and return cudaGetLastError().

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int HS_MAX_WARPS = 8;
// shared memory a CTA may take on sm_90, and what the dynamic part leaves
// for the kernels' static scalars (ops/hessenberg.py holds the same numbers)
constexpr int HS_SMEM_LIMIT = 232448;
constexpr int HS_SMEM_RESERVED = 512;
constexpr unsigned FULL = 0xffffffffu;

template <typename T> __device__ __forceinline__ T eps_of();
template <> __device__ __forceinline__ float eps_of<float>() { return FLT_EPSILON; }
template <> __device__ __forceinline__ double eps_of<double>() { return DBL_EPSILON; }

// sqrt(tiny) / eps: below it the squares of a vector's entries underflow;
// and its square, which a sum of squares is held to first (the plain
// version's _underflows), so that the common path pays one comparison
template <typename T> __device__ __forceinline__ T small_of();
template <> __device__ __forceinline__ float small_of<float>() { return 0x1p-40f; }
template <> __device__ __forceinline__ double small_of<double>() { return 0x1p-459; }
template <typename T> __device__ __forceinline__ T small2_of();
template <> __device__ __forceinline__ float small2_of<float>() { return 0x1p-80f; }
template <> __device__ __forceinline__ double small2_of<double>() { return 0x1p-918; }

template <typename T> __device__ __forceinline__ T big_of();
template <> __device__ __forceinline__ float big_of<float>() { return 0x1p40f; }
template <> __device__ __forceinline__ double big_of<double>() { return 0x1p459; }

// The exponent e that the active block is scaled by, 2^-e, before the Schur
// core (LAPACK xGEEV's prescale): that of anrm = max |H_act| when anrm lies
// outside [small_of, big_of], which brings it into [0.5, 1); else 0, and
// nothing changes.  Below the range the reduction's products u (u^T H),
// cubic in the scale, fall into the subnormals (float32: from 2^-42); above
// it they overflow (utils/hessenberg.py _range_exponent).
template <typename T> __device__ __forceinline__ int range_exp(T m) {
  int e = 0;
  if (m > T(0) && (m < small_of<T>() || m > big_of<T>()) && isfinite(m)) frexp(m, &e);
  return e;
}

// The exponent e that a vector is scaled by, 2^-e: that of max |v| when it
// lies in (0, small_of), else 0.  The scale is exact, and a reflector or a
// rotation built from the scaled vector is the same (utils/hessenberg.py
// _pow2_scaled, which says why).
template <typename T> __device__ __forceinline__ int pow2_exp(T m) {
  int e = 0;
  if (m > T(0) && m < small_of<T>()) frexp(m, &e);
  return e;
}

// max that propagates NaN, as jnp.max does
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

// The plain version's arithmetic, operation for operation.  Its scalars are
// numpy's and its elementwise passes torch's: each product and sum rounded
// on its own (rmul, radd, rsub, which the compiler may not fuse into a
// multiply-add).  Its small products (P @ rows, cols @ P, G @ rows,
// cols @ G^T, the split's G^T @ rows and cols @ G) are sums in a fixed
// order, (a0 b0 + a1 b1) + a2 b2 (sum3) and a0 b0 + a1 b1 (sum2), written
// out in utils/hessenberg.py (_ordered_rows, _ordered_cols).
__device__ __forceinline__ float rmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double rmul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float radd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double radd(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float rsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double rsub(double a, double b) { return __dsub_rn(a, b); }

template <typename T>
__device__ __forceinline__ T sum3(T a0, T a1, T a2, T b0, T b1, T b2) {
  return radd(radd(rmul(a0, b0), rmul(a1, b1)), rmul(a2, b2));
}

template <typename T> __device__ __forceinline__ T sum2(T a0, T a1, T b0, T b1) {
  return radd(rmul(a0, b0), rmul(a1, b1));
}

// The lagging-warp build (-DLK_LAG_WARP=1, ops/_build.py load_lagging(); off
// in the shipping build, where lag() is empty).  At the start of each
// stretch between two barriers of a chase step, a sweep's decision, a
// reduction column and the split, one warp sleeps before its loads and
// stores; which warp turns with the step and the stretch.  A read of an entry
// that another warp writes in the same stretch then sees the other value,
// and the outputs part from the shipping build's: the cuda tests and
// chip_smoke.py phase 33 hold the two builds' outputs equal bit for bit.
#ifndef LK_LAG_WARP
#define LK_LAG_WARP 0
#endif
constexpr unsigned LAG_NS = 2000;

__device__ __forceinline__ void lag(int step, int stretch) {
#if LK_LAG_WARP
  if (static_cast<int>(threadIdx.x >> 5) == (step + stretch) % static_cast<int>(blockDim.x >> 5))
    __nanosleep(LAG_NS);
#endif
}

// barrier of the CTA, a __syncwarp for one warp
__device__ __forceinline__ void cta_sync() {
  if (blockDim.x == 32)
    __syncwarp();
  else
    __syncthreads();
}

// an integer argument: read from device memory (bytes 8, 4 or 1) or given
__device__ __forceinline__ long long int_arg(const void* p, int bytes, long long val) {
  if (bytes == 8) return *static_cast<const long long*>(p);
  if (bytes == 4) return *static_cast<const int*>(p);
  if (bytes == 1) return *static_cast<const unsigned char*>(p);
  return val;
}

// max over the CTA of one value a thread; every thread gets it
template <typename T> __device__ T block_max(T v, T* red) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T m = T(0);
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) m = maxnan(m, red[w]);
  return m;
}

// max |H| over the matrix, by one warp
template <typename T> __device__ T warp_absmax(const T* H, int ld, int n) {
  T m = T(0);
  const int lane = threadIdx.x & 31;
  for (int i = 0; i < n; ++i)
    for (int j = lane; j < n; j += 32) m = maxnan(m, fabs(H[i * ld + j]));
  return warp_max(m);
}

// P = I - 2 v v^T / (v^T v) annihilating (y, z) in (x, y, z); the identity
// when the vector already is (x, 0, 0) (hessenberg.py:69-82)
template <typename T>
__device__ __forceinline__ void householder3(T x, T y, T z, T P[9]) {
  T sq = radd(radd(rmul(x, x), rmul(y, y)), rmul(z, z));
  if (sq < small2_of<T>()) {
    const int e = pow2_exp(fmax(fabs(x), fmax(fabs(y), fabs(z))));
    x = ldexp(x, -e);
    y = ldexp(y, -e);
    z = ldexp(z, -e);
    sq = radd(radd(rmul(x, x), rmul(y, y)), rmul(z, z));
  }
  const T s = sqrt(sq);
  const T alpha = -(x >= T(0) ? s : -s);
  const T v0 = rsub(x, alpha);
  const T vn2 = radd(radd(rmul(v0, v0), rmul(y, y)), rmul(z, z));
  const T inv = vn2 > T(0) ? T(2) / vn2 : T(0);
  const T v[3] = {v0, y, z};
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      P[r * 3 + c] = rsub(r == c ? T(1) : T(0), rmul(inv, rmul(v[r], v[c])));
}

// The first column of (H - s1 I)(H - s2 I) on the window from row lo, for
// the shift sum s and product t: the chase's first vector (hessenberg.py:114-122)
template <typename T>
__device__ __forceinline__ void first_vector(const T* H, int ldh, int lo, T s, T t, T& x, T& y,
                                             T& z) {
  const T h00 = H[lo * ldh + lo], h01 = H[lo * ldh + lo + 1];
  const T h10 = H[(lo + 1) * ldh + lo], h11 = H[(lo + 1) * ldh + lo + 1];
  const T h21 = H[(lo + 2) * ldh + lo + 1];
  x = radd(rsub(radd(rmul(h00, h00), rmul(h01, h10)), rmul(s, h00)), t);
  y = rmul(h10, rsub(radd(h00, h11), s));
  z = rmul(h10, h21);
}

// One Francis double-shift bulge chase on the window [lo, hi] (size >= 3)
// from the first vector (x, y, z), then the closing Givens rotation
// (hessenberg.py:85-163), by the whole CTA.  Called after a barrier since
// the last write to H; ends with one.  H has row stride ldh; Zt, Z
// transposed (may be null), ldz; stage, 6 entries of shared memory.  Thread
// g keeps Z's row g in columns p..p+2 in registers from step to step: a
// step loads one entry, a step ahead, and stores one.  Between two barriers
// a thread reads only entries of H that no other thread writes there.
template <typename T>
__device__ void chase(T* __restrict__ H, int ldh, T* __restrict__ Zt, int ldz, int n, int lo,
                      int hi, T x, T y, T z, T* __restrict__ stage) {
  const int g = threadIdx.x, G = blockDim.x;
  T P[9];
  householder3(x, y, z, P);
  const bool zown = Zt != nullptr && g < n;
  // H[p+3, p+2] for the step p to come; the chase leaves it as it is until
  // step p's column update
  T sub3 = lo + 1 <= hi - 2 ? H[(lo + 3) * ldh + lo + 2] : T(0);
  T z0 = T(0), z1 = T(0), z2 = T(0);
  if (zown) {
    z0 = Zt[lo * ldz + g];
    z1 = Zt[(lo + 1) * ldz + g];
    z2 = Zt[(lo + 2) * ldz + g];
  }
  for (int p = lo;; ++p) {
    lag(p, 0);
    const bool more = p + 1 <= hi - 2;
    const T z3 = zown && more ? Zt[(p + 3) * ldz + g] : T(0);
    T* r0p = H + p * ldh;
    T* r1p = r0p + ldh;
    T* r2p = r1p + ldh;
    // rows p..p+2 <- P rows, over columns [p-1, n); the bulge column p-1
    // keeps its reflected head and exact zeros below it.  Rows p+1 and p+2
    // of columns p..p+2 go to the staging block too.
    for (int c = (p > 0 ? p - 1 : 0) + g; c < n; c += G) {
      const T a0 = r0p[c], a1 = r1p[c], a2 = r2p[c];
      const bool bulge = p > lo && c == p - 1;
      const T b1 = bulge ? T(0) : sum3(P[3], P[4], P[5], a0, a1, a2);
      const T b2 = bulge ? T(0) : sum3(P[6], P[7], P[8], a0, a1, a2);
      r0p[c] = sum3(P[0], P[1], P[2], a0, a1, a2);
      r1p[c] = b1;
      r2p[c] = b2;
      const unsigned sc = c - p;
      if (sc < 3u) {
        stage[sc] = b1;
        stage[3 + sc] = b2;
      }
    }
    cta_sync();
    lag(p, 1);
    // column p of rows p+1..p+3 after this step's column update: the next
    // reflector's vector (the closing rotation's, after the last step); in
    // row p+3 only H[p+3, p+2] is nonzero
    x = sum3(stage[0], stage[1], stage[2], P[0], P[3], P[6]);
    y = sum3(stage[3], stage[4], stage[5], P[0], P[3], P[6]);
    z = more ? rmul(sub3, P[6]) : T(0);
    sub3 = p + 2 <= hi - 2 ? H[(p + 4) * ldh + p + 3] : T(0);
    // columns p..p+2 <- columns P, over rows [0, min(p+3, hi)], and Z's
    // over all rows; a thread's first row beside the next reflector
    const int rend = p + 3 < hi ? p + 3 : hi;
    const bool own = g <= rend;
    T* e = H + g * ldh + p;
    T c0 = T(0), c1 = T(0), c2 = T(0);
    if (own) {
      c0 = e[0];
      c1 = e[1];
      c2 = e[2];
    }
    T Pn[9];
    householder3(x, y, z, Pn);
    if (own) {
      e[0] = sum3(c0, c1, c2, P[0], P[3], P[6]);
      e[1] = sum3(c0, c1, c2, P[1], P[4], P[7]);
      e[2] = sum3(c0, c1, c2, P[2], P[5], P[8]);
    }
    if (zown) {
      const T n0 = sum3(z0, z1, z2, P[0], P[3], P[6]);
      const T n1 = sum3(z0, z1, z2, P[1], P[4], P[7]);
      const T n2 = sum3(z0, z1, z2, P[2], P[5], P[8]);
      Zt[p * ldz + g] = n0;
      z0 = n1;
      z1 = n2;
      z2 = z3;
    }
    for (int r = g + G; r <= rend; r += G) {
      T* f = H + r * ldh + p;
      const T d0 = f[0], d1 = f[1], d2 = f[2];
      f[0] = sum3(d0, d1, d2, P[0], P[3], P[6]);
      f[1] = sum3(d0, d1, d2, P[1], P[4], P[7]);
      f[2] = sum3(d0, d1, d2, P[2], P[5], P[8]);
    }
    if (Zt)
      for (int r = g + G; r < n; r += G) {
        T* f = Zt + p * ldz + r;
        const T d0 = f[0], d1 = f[ldz], d2 = f[2 * ldz];
        f[0] = sum3(d0, d1, d2, P[0], P[3], P[6]);
        f[ldz] = sum3(d0, d1, d2, P[1], P[4], P[7]);
        f[2 * ldz] = sum3(d0, d1, d2, P[2], P[5], P[8]);
      }
    cta_sync();
    if (!more) break;
#pragma unroll
    for (int i = 0; i < 9; ++i) P[i] = Pn[i];
  }
  // closing Givens on rows/columns (hi-1, hi), zeroing H[hi, hi-2]; (x, y)
  // is column hi-2 of those rows
  lag(hi, 2);
  T sq = radd(rmul(x, x), rmul(y, y));
  if (sq < small2_of<T>()) {
    const int e = pow2_exp(fmax(fabs(x), fabs(y)));
    x = ldexp(x, -e);
    y = ldexp(y, -e);
    sq = radd(rmul(x, x), rmul(y, y));
  }
  const T r = sqrt(sq);
  const T c = r > T(0) ? x / r : T(1);
  const T sn = r > T(0) ? y / r : T(0);
  T* ra = H + (hi - 1) * ldh;
  T* rb = ra + ldh;
  for (int col = hi - 2 + g; col < n; col += G) {
    const T u = ra[col], v = rb[col];
    ra[col] = sum2(c, sn, u, v);
    rb[col] = col == hi - 2 ? T(0) : sum2(-sn, c, u, v);
  }
  cta_sync();
  lag(hi, 3);
  for (int row = g; row <= hi; row += G) {
    T* e = H + row * ldh + hi - 1;
    const T u = e[0], v = e[1];
    e[0] = sum2(u, v, c, sn);
    e[1] = sum2(u, v, -sn, c);
  }
  if (zown) {
    Zt[(hi - 1) * ldz + g] = sum2(z0, z1, c, sn);
    Zt[hi * ldz + g] = sum2(z0, z1, -sn, c);
  }
  if (Zt)
    for (int row = g + G; row < n; row += G) {
      T* e = Zt + (hi - 1) * ldz + row;
      const T u = e[0], v = e[ldz];
      e[0] = sum2(u, v, c, sn);
      e[ldz] = sum2(u, v, -sn, c);
    }
  cta_sync();
}

// The sweep decision that warp 0 makes and every thread reads, double
// buffered by sweep parity: lo, hi, action (1 chase, 0 none, -1 stop) and
// the chase's first vector (x, y, z)
template <typename T> struct Decision {
  int lo, hi, action;
  T x, y, z;
};

// the n x n matrix A (row stride ld) into out, transposed or not
template <typename T>
__device__ void copy_out(const T* A, int ld, T* out, int n, bool transpose) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int i = warp; i < n; i += nw)
    for (int j = lane; j < n; j += 32) out[i * n + j] = transpose ? A[j * ld + i] : A[i * ld + j];
}

// Z from its transpose in place, in the output buffer
template <typename T> __device__ void transpose_in_place(T* A, int n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int i = warp; i < n; i += nw)
    for (int j = i + 1 + lane; j < n; j += 32) {
      const T a = A[i * n + j];
      A[i * n + j] = A[j * n + i];
      A[j * n + i] = a;
    }
}

template <typename T, bool HS, bool ZS>
__global__ void __launch_bounds__(HS_MAX_WARPS * 32)
schur_kernel(const T* __restrict__ Hin, T* Tout, T* Zout, T* wr, T* wi, bool* acc_out,
             bool* ok_out, int* work, const void* keff_ptr, int keff_bytes, long long keff_val,
             int n, int with_z, int split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[HS_MAX_WARPS];
  __shared__ T col_inv;
  __shared__ int col_end;
  __shared__ Decision<T> dec[2];
  __shared__ T stage[6];
  const int ldh = HS ? (n | 1) : n, ldz = ZS ? (n | 1) : n;
  T* base = reinterpret_cast<T*>(smem_raw);
  T* H = Tout;
  T* Zm = Zout;
  if constexpr (HS) {
    H = base;
    base += n * ldh;
  }
  if constexpr (ZS) {
    Zm = base;
    base += n * ldz;
  }
  T* u = base;
  int* acc = reinterpret_cast<int*>(u + n);
  T* Z = with_z ? Zm : nullptr;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nw = nt >> 5;
  const int k = static_cast<int>(int_arg(keff_ptr, keff_bytes, keff_val));

  // the range prescale, then _embed: zero the inactive block, plant the
  // dummy diagonal
  T m = T(0);
  for (int i = warp; i < k && i < n; i += nw)
    for (int j = lane; j < k && j < n; j += 32) m = maxnan(m, fabs(Hin[i * n + j]));
  const T anrm = block_max(m, red);
  const int e = range_exp(anrm);
  const T norm = radd(ldexp(anrm, -e), T(1));
  for (int i = warp; i < n; i += nw)
    for (int j = lane; j < n; j += 32) {
      T val = (i < k && j < k) ? ldexp(Hin[i * n + j], -e) : T(0);
      if (i == j && i >= k) val = rmul(norm, radd(T(2), T(i) / T(n)));
      H[i * ldh + j] = val;
      if (Z) Z[i * ldz + j] = i == j ? T(1) : T(0);
    }
  for (int i = tid; i < n; i += nt) acc[i] = 0;
  __syncthreads();

  // _to_hessenberg: one Householder reflector a column, applied where its
  // vector u is nonzero, rows and columns [j+1, m]
  for (int j = 0; j + 2 < n; ++j) {
    lag(j, 0);
    if (warp == 0) {
      int mrow = j + 1;
      for (int i0 = j + 2; i0 < n; i0 += 32) {
        const int i = i0 + lane;
        const unsigned b = __ballot_sync(FULL, i < n && H[i * ldh + j] != T(0));
        if (b) mrow = i0 + 31 - __clz(b);
      }
      // one nonzero (a Hessenberg column): its square is the whole sum
      const bool one = mrow == j + 1;
      const T x0 = H[(j + 1) * ldh + j];
      T part = T(0);
      for (int i = j + 1 + lane; i <= mrow; i += 32)
        part = radd(part, rmul(H[i * ldh + j], H[i * ldh + j]));
      const T s = sqrt(one ? rmul(x0, x0) : warp_sum(part));
      const T alpha = -(x0 >= T(0) ? s : -s);
      T p2 = T(0);
      for (int i = j + 1 + lane; i <= mrow; i += 32) {
        const T ui = i == j + 1 ? rsub(x0, alpha) : H[i * ldh + j];
        u[i] = ui;
        p2 = radd(p2, rmul(ui, ui));
      }
      const T u0 = rsub(x0, alpha);
      const T un2 = one ? rmul(u0, u0) : warp_sum(p2);
      if (lane == 0) {
        col_inv = un2 > T(0) ? T(2) / un2 : T(0);
        col_end = mrow;
      }
    }
    __syncthreads();
    lag(j, 1);
    const T inv = col_inv;
    const int mrow = col_end;
    for (int c = tid; c < n; c += nt) {  // w = u^T H, then H -= inv u w^T
      T w = T(0);
      for (int i = j + 1; i <= mrow; ++i) w = fma(u[i], H[i * ldh + c], w);
      for (int i = j + 1; i <= mrow; ++i)
        H[i * ldh + c] = rsub(H[i * ldh + c], rmul(inv, rmul(u[i], w)));
    }
    __syncthreads();
    lag(j, 2);
    for (int r = tid; r < n; r += nt) {  // v = H u, H -= inv v u^T; Z's
      T* row = H + r * ldh;
      T v = T(0);
      for (int c = j + 1; c <= mrow; ++c) v = fma(row[c], u[c], v);
      for (int c = j + 1; c <= mrow; ++c) row[c] = rsub(row[c], rmul(inv, rmul(v, u[c])));
      if (Z) {  // Z is kept transposed
        T zv = T(0);
        for (int c = j + 1; c <= mrow; ++c) zv = fma(Z[c * ldz + r], u[c], zv);
        for (int c = j + 1; c <= mrow; ++c)
          Z[c * ldz + r] = rsub(Z[c * ldz + r], rmul(inv, rmul(zv, u[c])));
      }
      if (r >= j + 2 && r <= mrow) row[j] = T(0);
    }
    __syncthreads();
  }

  // _schur_core, by the CTA; warp 0 decides each sweep
  bool ok = true;
  int sweeps = 0, steps = 0;  // warp 0's
  if (n >= 2) {
    const T eps = eps_of<T>();
    const int max_sweeps = 30 * n;
    int last_hi = -1, stall = 0;
    for (int sweep = 0;; ++sweep) {
      lag(sweep, 0);
      Decision<T>& d = dec[sweep & 1];
      if (warp == 0) {
        bool open = false, need = false;
        for (int i0 = 0; i0 + 1 < n; i0 += 32) {
          const int i = i0 + lane;
          bool o = false, z = false;
          if (i + 1 < n) {
            o = H[(i + 1) * ldh + i] != T(0) && !acc[i];
            z = fabs(H[i * ldh + i]) + fabs(H[(i + 1) * ldh + i + 1]) == T(0);
          }
          open |= __ballot_sync(FULL, o) != 0;
          need |= __ballot_sync(FULL, z) != 0;
        }
        int action = -1, lo = 0, hi_c = -1;
        if (open && sweeps < max_sweeps) {
          const T hmax = need ? warp_absmax(H, ldh, n) : T(0);
          int zlast = -1;  // the last zero subdiagonal below the chunk
          for (int i0 = 0; i0 + 1 < n; i0 += 32) {
            const int i = i0 + lane;
            bool o = false, zero = false;
            if (i + 1 < n) {
              T tst = fabs(H[i * ldh + i]) + fabs(H[(i + 1) * ldh + i + 1]);
              if (tst == T(0)) tst = hmax;
              T& sub = H[(i + 1) * ldh + i];
              T sv = sub;
              if (fabs(sv) <= rmul(eps, tst)) {
                sub = T(0);
                sv = T(0);
              }
              zero = sv == T(0);
              o = !zero && !acc[i];
            }
            const unsigned mo = __ballot_sync(FULL, o), mz = __ballot_sync(FULL, zero);
            if (mo) {
              const int h = 31 - __clz(mo);
              hi_c = i0 + h;
              const unsigned below = mz & ((1u << h) - 1u);
              lo = below ? i0 + 32 - __clz(below) : zlast + 1;
            }
            if (mz) zlast = i0 + 31 - __clz(mz);
          }
          __syncwarp();  // the deflated entries, before the shifts read them
          const int hi = hi_c + 1;
          stall = hi == last_hi ? stall + 1 : 0;
          action = 0;
          if (hi_c >= 0 && hi - lo >= 2) {
            const T a11 = H[(hi - 1) * ldh + hi - 1], a12 = H[(hi - 1) * ldh + hi];
            const T a21 = H[hi * ldh + hi - 1], a22 = H[hi * ldh + hi];
            T s = radd(a11, a22), t = rsub(rmul(a11, a22), rmul(a12, a21));
            if (stall > 0 && stall % 10 == 0) {
              const T sexc = radd(fabs(a21), fabs(H[(hi - 1) * ldh + hi - 2]));
              const T wexc = radd(a22, rmul(T(0.75), sexc));
              s = rmul(T(2), wexc);
              t = rmul(wexc, wexc);
            }
            action = 1;
            steps += hi - lo - 1;
            if (lane == 0) first_vector(H, ldh, lo, s, t, d.x, d.y, d.z);
          } else if (hi_c >= 0 && lane == 0) {
            acc[hi_c] = 1;
          }
          last_hi = hi;
          ++sweeps;
        } else {
          ok = !open;
        }
        if (lane == 0) {
          d.lo = lo;
          d.hi = hi_c + 1;
          d.action = action;
        }
      }
      cta_sync();
      lag(sweep, 1);
      const int action = d.action;
      if (action < 0) break;
      if (action == 1) chase(H, ldh, Z, ldz, n, d.lo, d.hi, d.x, d.y, d.z, stage);
    }
  }
  __syncthreads();

  // _split_real_blocks: real-pair 2x2 blocks into two 1x1 blocks
  if (split && Z && n >= 2) {
    for (int i = 0; i + 1 < n; ++i) {
      if (!acc[i]) continue;
      const T a = H[i * ldh + i], b = H[i * ldh + i + 1];
      const T c = H[(i + 1) * ldh + i], d = H[(i + 1) * ldh + i + 1];
      const T mm = rmul(T(0.5), radd(a, d));
      const T disc = radd(rmul(T(0.25), rmul(rsub(a, d), rsub(a, d))), rmul(b, c));
      if (!(disc >= T(0))) continue;
      const T sq = sqrt(fabs(disc));
      const T lam = radd(mm, mm >= T(0) ? sq : -sq);
      T v1a = b, v1b = rsub(lam, a), v2a = rsub(lam, d), v2b = c;
      const int e = pow2_exp(fmax(fmax(fabs(v1a), fabs(v1b)), fmax(fabs(v2a), fabs(v2b))));
      if (e) {
        v1a = ldexp(v1a, -e);
        v1b = ldexp(v1b, -e);
        v2a = ldexp(v2a, -e);
        v2b = ldexp(v2b, -e);
      }
      const bool one = sum2(v1a, v1b, v1a, v1b) >= sum2(v2a, v2b, v2a, v2b);
      T va = one ? v1a : v2a, vb = one ? v1b : v2b;
      const T nrm = sqrt(sum2(va, vb, va, vb));
      if (nrm > T(0)) {
        va = va / nrm;
        vb = vb / nrm;
      } else {
        va = T(1);
        vb = T(0);
      }
      __syncthreads();  // every thread has read the block
      lag(i, 0);
      for (int col = tid; col < n; col += nt) {  // G^T rows, G = [[va, -vb], [vb, va]]
        const T r0 = H[i * ldh + col], r1 = H[(i + 1) * ldh + col];
        H[i * ldh + col] = sum2(va, vb, r0, r1);
        H[(i + 1) * ldh + col] = sum2(-vb, va, r0, r1);
      }
      __syncthreads();
      lag(i, 1);
      for (int row = tid; row < n; row += nt) {  // columns G, and Z's
        T* e = H + row * ldh + i;
        const T c0 = e[0], c1 = e[1];
        e[0] = sum2(c0, c1, va, vb);
        e[1] = sum2(c0, c1, -vb, va);
        T* ze = Z + i * ldz + row;
        const T z0 = ze[0], z1 = ze[ldz];
        ze[0] = sum2(z0, z1, va, vb);
        ze[ldz] = sum2(z0, z1, -vb, va);
      }
      __syncthreads();
      if (tid == 0) {
        H[(i + 1) * ldh + i] = T(0);
        acc[i] = 0;
      }
      __syncthreads();
    }
  }

  // _extract_eigvals, masked to the active block
  for (int i = tid; i < n; i += nt) {
    const bool ps = i + 1 < n && acc[i];
    const bool sec = i > 0 && acc[i - 1];
    T wri = H[i * ldh + i], wii = T(0);
    if (ps || sec) {
      const int b0 = ps ? i : i - 1;
      const T a = H[b0 * ldh + b0], b = H[b0 * ldh + b0 + 1];
      const T c = H[(b0 + 1) * ldh + b0], d = H[(b0 + 1) * ldh + b0 + 1];
      const T mm = rmul(T(0.5), radd(a, d));
      const T disc = radd(rmul(T(0.25), rmul(rsub(a, d), rsub(a, d))), rmul(b, c));
      const T sq = sqrt(fabs(disc));
      const bool real = disc >= T(0);
      if (ps) {
        wri = real ? radd(mm, sq) : mm;
        wii = real ? T(0) : sq;
      } else {
        wri = real ? rsub(mm, sq) : mm;
        wii = real ? T(0) : -sq;
      }
    }
    if (i >= k) {
      wri = T(0);
      wii = T(0);
    }
    wr[i] = ldexp(wri, e);
    wi[i] = ldexp(wii, e);
    if (i + 1 < n) acc_out[i] = acc[i] != 0;
  }
  if (e) {  // T unscaled; Z is as it is
    __syncthreads();
    for (int i = warp; i < n; i += nw)
      for (int j = lane; j < n; j += 32) H[i * ldh + j] = ldexp(H[i * ldh + j], e);
    __syncthreads();
  }
  if constexpr (HS) copy_out(H, ldh, Tout, n, false);
  if (Z) {
    if constexpr (ZS)
      copy_out(Z, ldz, Zout, n, true);
    else
      transpose_in_place(Zout, n);
  }
  if (tid == 0) {
    *ok_out = ok;
    work[0] = sweeps;
    work[1] = steps;
  }
}

template <typename T, bool HS, bool ZS>
__global__ void __launch_bounds__(HS_MAX_WARPS * 32)
filter_kernel(const T* __restrict__ Hin, T* Hout, T* Zout, const T* __restrict__ wr,
              const T* __restrict__ wi, const long long* __restrict__ order,
              const void* nkeep_ptr, int nkeep_bytes, long long nkeep_val, const void* pure_ptr,
              int pure_bytes, long long pure_val, int* work, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[HS_MAX_WARPS];
  __shared__ Decision<T> dec[2];
  __shared__ T stage[6];
  const int ldh = HS ? (n | 1) : n, ldz = ZS ? (n | 1) : n;
  T* base = reinterpret_cast<T*>(smem_raw);
  T* H = Hout;
  T* Z = Zout;
  if constexpr (HS) {
    H = base;
    base += n * ldh;
  }
  if constexpr (ZS) Z = base;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, nw = blockDim.x >> 5;
  // the range prescale of H and the shifts (range_exp; the sweeps' first
  // vector is quadratic in the scale), undone on Hf; Z does not depend on it
  T m = T(0);
  for (int i = warp; i < n; i += nw)
    for (int j = lane; j < n; j += 32) m = maxnan(m, fabs(Hin[i * n + j]));
  const int e = range_exp(block_max(m, red));
  for (int i = warp; i < n; i += nw)
    for (int j = lane; j < n; j += 32) {
      const T v = Hin[i * n + j];
      H[i * ldh + j] = e ? ldexp(v, -e) : v;
      Z[i * ldz + j] = i == j ? T(1) : T(0);
    }
  const long long nkeep = int_arg(nkeep_ptr, nkeep_bytes, nkeep_val);
  const bool pure = int_arg(pure_ptr, pure_bytes, pure_val) != 0;
  __syncthreads();
  int active = 0, steps = 0;  // warp 0's
  {
    const T eps = eps_of<T>();
    for (int j = 0; j < n / 2; ++j) {
      lag(j, 0);
      Decision<T>& d = dec[j & 1];
      if (warp == 0) {
        bool need = false;
        for (int i0 = 0; i0 + 1 < n; i0 += 32) {
          const int i = i0 + lane;
          const bool z = i + 1 < n &&
                         fabs(H[i * ldh + i]) + fabs(H[(i + 1) * ldh + i + 1]) == T(0);
          need |= __ballot_sync(FULL, z) != 0;
        }
        const T hmax = need ? warp_absmax(H, ldh, n) : T(0);
        // explicit deflation, then the top-connected block ends at row hi
        int hi = n - 1;
        for (int i0 = 0; i0 + 1 < n; i0 += 32) {
          const int i = i0 + lane;
          bool zero = false;
          if (i + 1 < n) {
            T tst = fabs(H[i * ldh + i]) + fabs(H[(i + 1) * ldh + i + 1]);
            if (tst == T(0)) tst = hmax;
            T& sub = H[(i + 1) * ldh + i];
            if (fabs(sub) <= rmul(eps, tst)) sub = T(0);
            zero = sub == T(0);
          }
          const unsigned mz = __ballot_sync(FULL, zero);
          if (mz && hi == n - 1) hi = i0 + __ffs(mz) - 1;
        }
        __syncwarp();  // the deflated entries, before the first vector reads them
        const bool act = (2 * j + 1) < (n - nkeep) && pure && hi >= 2;
        if (act) {
          ++active;
          steps += hi - 1;
          if (lane == 0) {
            const int ja = 2 * j < n - 1 ? 2 * j : n - 1;
            const int jb = 2 * j + 1 < n - 1 ? 2 * j + 1 : n - 1;
            const long long ia = order[ja], ib = order[jb];
            T ar = wr[ia], br = wr[ib], ai = wi[ia], bi = wi[ib];
            if (e) {
              ar = ldexp(ar, -e);
              br = ldexp(br, -e);
              ai = ldexp(ai, -e);
              bi = ldexp(bi, -e);
            }
            const T s = radd(ar, br);
            const T t = rsub(rmul(ar, br), rmul(ai, bi));
            first_vector(H, ldh, 0, s, t, d.x, d.y, d.z);
          }
        }
        if (lane == 0) {
          d.hi = hi;
          d.action = act ? 1 : 0;
        }
      }
      cta_sync();
      lag(j, 1);
      if (d.action == 1) chase(H, ldh, Z, ldz, n, 0, d.hi, d.x, d.y, d.z, stage);
    }
  }
  __syncthreads();
  if (e) {  // Hf unscaled
    for (int i = warp; i < n; i += nw)
      for (int j = lane; j < n; j += 32) H[i * ldh + j] = ldexp(H[i * ldh + j], e);
    __syncthreads();
  }
  if constexpr (HS) copy_out(H, ldh, Hout, n, false);
  if constexpr (ZS)
    copy_out(Z, ldz, Zout, n, true);
  else
    transpose_in_place(Zout, n);
  if (tid == 0) {
    work[0] = active;
    work[1] = steps;
  }
}

// Shared memory the kernel needs for a geometry: H and Z where they live
// there (rows of odd stride), and for the Schur kernel the reflector vector
// and the accepted flags.  ops/hessenberg.py geometry() computes the same.
long long smem_need(int n, int elt, bool schur, bool h_smem, bool z_smem) {
  const long long mat = 1LL * n * (n | 1) * elt;
  return (h_smem ? mat : 0) + (z_smem ? mat : 0) + (schur ? 1LL * n * elt + 4LL * n : 0);
}

bool geometry_ok(int n, int elt, bool schur, int warps, int h_smem, int z_smem, int smem) {
  return n >= 1 && warps >= 1 && warps <= HS_MAX_WARPS &&
         (!z_smem || h_smem) && smem >= smem_need(n, elt, schur, h_smem, z_smem) &&
         smem <= HS_SMEM_LIMIT - HS_SMEM_RESERVED;
}

// the dynamic shared-memory attribute, set once a kernel and device
template <typename K> cudaError_t allow_smem(K kernel, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             HS_SMEM_LIMIT - HS_SMEM_RESERVED);
  if (err == cudaSuccess) done[dev] = true;
  return err;
}

template <typename T, bool HS, bool ZS>
cudaError_t launch_schur_as(const void* H, void* Tm, void* Z, void* wr, void* wi, void* acc,
                            void* ok, void* work, const void* keff, int keff_bytes,
                            long long keff_val, int n, int with_z, int split, int warps,
                            int smem, cudaStream_t stream) {
  static bool done[64] = {};
  cudaError_t err = allow_smem(schur_kernel<T, HS, ZS>, done);
  if (err != cudaSuccess) return err;
  schur_kernel<T, HS, ZS><<<1, warps * 32, static_cast<size_t>(smem), stream>>>(
      static_cast<const T*>(H), static_cast<T*>(Tm), static_cast<T*>(Z), static_cast<T*>(wr),
      static_cast<T*>(wi), static_cast<bool*>(acc), static_cast<bool*>(ok),
      static_cast<int*>(work), keff, keff_bytes, keff_val, n, with_z, split);
  return cudaGetLastError();
}

template <typename T>
int launch_schur(const void* H, void* Tm, void* Z, void* wr, void* wi, void* acc, void* ok,
                 void* work, const void* keff, int keff_bytes, long long keff_val, int n,
                 int with_z, int split, int warps, int h_smem, int z_smem, int smem,
                 void* stream) {
  const bool bytes_ok = keff_bytes == 0 || ((keff_bytes == 1 || keff_bytes == 4 ||
                                             keff_bytes == 8) && keff);
  if (!H || !Tm || !wr || !wi || !ok || !work || !bytes_ok || (with_z && !Z) ||
      (n > 1 && !acc) || (z_smem && !with_z) ||
      !geometry_ok(n, sizeof(T), true, warps, h_smem, z_smem, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (z_smem)
    err = launch_schur_as<T, true, true>(H, Tm, Z, wr, wi, acc, ok, work, keff, keff_bytes,
                                         keff_val, n, with_z, split, warps, smem, s);
  else if (h_smem)
    err = launch_schur_as<T, true, false>(H, Tm, Z, wr, wi, acc, ok, work, keff, keff_bytes,
                                          keff_val, n, with_z, split, warps, smem, s);
  else
    err = launch_schur_as<T, false, false>(H, Tm, Z, wr, wi, acc, ok, work, keff, keff_bytes,
                                           keff_val, n, with_z, split, warps, smem, s);
  return static_cast<int>(err);
}

template <typename T, bool HS, bool ZS>
cudaError_t launch_filter_as(const void* H, void* Hf, void* Z, const void* wr, const void* wi,
                             const void* order, const void* nkeep, int nkeep_bytes,
                             long long nkeep_val, const void* pure, int pure_bytes,
                             long long pure_val, void* work, int n, int warps, int smem,
                             cudaStream_t stream) {
  static bool done[64] = {};
  cudaError_t err = allow_smem(filter_kernel<T, HS, ZS>, done);
  if (err != cudaSuccess) return err;
  filter_kernel<T, HS, ZS><<<1, warps * 32, static_cast<size_t>(smem), stream>>>(
      static_cast<const T*>(H), static_cast<T*>(Hf), static_cast<T*>(Z),
      static_cast<const T*>(wr), static_cast<const T*>(wi),
      static_cast<const long long*>(order), nkeep, nkeep_bytes, nkeep_val, pure, pure_bytes,
      pure_val, static_cast<int*>(work), n);
  return cudaGetLastError();
}

bool int_arg_ok(const void* p, int bytes) {
  return bytes == 0 || ((bytes == 1 || bytes == 4 || bytes == 8) && p);
}

template <typename T>
int launch_filter(const void* H, void* Hf, void* Z, const void* wr, const void* wi,
                  const void* order, const void* nkeep, int nkeep_bytes, long long nkeep_val,
                  const void* pure, int pure_bytes, long long pure_val, void* work, int n,
                  int warps, int h_smem, int z_smem, int smem, void* stream) {
  if (!H || !Hf || !Z || !wr || !wi || !order || !work || !int_arg_ok(nkeep, nkeep_bytes) ||
      !int_arg_ok(pure, pure_bytes) ||
      !geometry_ok(n, sizeof(T), false, warps, h_smem, z_smem, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (z_smem)
    err = launch_filter_as<T, true, true>(H, Hf, Z, wr, wi, order, nkeep, nkeep_bytes,
                                          nkeep_val, pure, pure_bytes, pure_val, work, n, warps,
                                          smem, s);
  else if (h_smem)
    err = launch_filter_as<T, true, false>(H, Hf, Z, wr, wi, order, nkeep, nkeep_bytes,
                                           nkeep_val, pure, pure_bytes, pure_val, work, n,
                                           warps, smem, s);
  else
    err = launch_filter_as<T, false, false>(H, Hf, Z, wr, wi, order, nkeep, nkeep_bytes,
                                            nkeep_val, pure, pure_bytes, pure_val, work, n,
                                            warps, smem, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

int lk_hessenberg_schur_f32(const void* H, void* T, void* Z, void* wr, void* wi, void* acc,
                            void* ok, void* work, const void* keff, int keff_bytes,
                            long long keff_val, int n, int with_z, int split, int warps,
                            int h_smem, int z_smem, int smem_bytes, void* stream) {
  return launch_schur<float>(H, T, Z, wr, wi, acc, ok, work, keff, keff_bytes, keff_val, n,
                             with_z, split, warps, h_smem, z_smem, smem_bytes, stream);
}

int lk_hessenberg_schur_f64(const void* H, void* T, void* Z, void* wr, void* wi, void* acc,
                            void* ok, void* work, const void* keff, int keff_bytes,
                            long long keff_val, int n, int with_z, int split, int warps,
                            int h_smem, int z_smem, int smem_bytes, void* stream) {
  return launch_schur<double>(H, T, Z, wr, wi, acc, ok, work, keff, keff_bytes, keff_val, n,
                              with_z, split, warps, h_smem, z_smem, smem_bytes, stream);
}

int lk_francis_sweeps_f32(const void* H, void* Hf, void* Z, const void* wr, const void* wi,
                          const void* order, const void* nkeep, int nkeep_bytes,
                          long long nkeep_val, const void* pure, int pure_bytes,
                          long long pure_val, void* work, int n, int warps, int h_smem,
                          int z_smem, int smem_bytes, void* stream) {
  return launch_filter<float>(H, Hf, Z, wr, wi, order, nkeep, nkeep_bytes, nkeep_val, pure,
                              pure_bytes, pure_val, work, n, warps, h_smem, z_smem,
                              smem_bytes, stream);
}

int lk_francis_sweeps_f64(const void* H, void* Hf, void* Z, const void* wr, const void* wi,
                          const void* order, const void* nkeep, int nkeep_bytes,
                          long long nkeep_val, const void* pure, int pure_bytes,
                          long long pure_val, void* work, int n, int warps, int h_smem,
                          int z_smem, int smem_bytes, void* stream) {
  return launch_filter<double>(H, Hf, Z, wr, wi, order, nkeep, nkeep_bytes, nkeep_val, pure,
                               pure_bytes, pure_val, work, n, warps, h_smem,
                               z_smem, smem_bytes, stream);
}

}  // extern "C"
