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
// Bound: latency, not bytes.  The work is a chain of a few thousand small
// dependent steps (a chase step is a 3-element Householder reflector applied
// to 3 rows and 3 columns of an n x n matrix); the matrix is at most a few
// hundred KB.  A plain PyTorch translation would read the device at every
// loop test and launch about ten kernels a chase step.  Here one CTA runs the
// whole iteration: the matrix lives in shared memory when it fits (n <= 168
// in f64, n <= 238 in f32; else in the output buffer in global memory), Z
// always in global memory.  Threads share each row and column update, one
// element a thread; every thread computes the step's reflector from the same
// values, so the scalars need no broadcast, and thread 0 alone scans the
// subdiagonal for deflation, the active window and the shifts between
// barriers.  A chase step costs two barriers: the row update, then the
// column update (and Z's).  The entry of column p-1 that a step's row update
// would write, and the bulge entries it zeroes, are written in the column
// phase by thread 0, so no thread reads them while they change.
//
// The arithmetic follows the JAX code's order: the embedding's dummy
// diagonal, the 30 n sweep budget, the LAPACK dlahqr-style deflation test
// with the zero-neighbour safeguard, the exceptional shift every 10 stalled
// sweeps, and full-slice updates with the annihilated bulge entries set to
// exactly zero.  Sums in the reduction to Hessenberg form are taken in
// another order than XLA's, and the compiler may contract products into
// FMAs, so results agree with the plain version to rounding.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (lightkrylov_tpu_torch/ops/_build.py).  The C entries
// launch on the given stream and return cudaGetLastError().

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int HS_MAX_THREADS = 256;
// dynamic shared memory a CTA may take: the H100's 227 KB less 512 bytes
// for the kernels' static scalars
constexpr int HS_SMEM_BYTES = 232448 - 512;

template <typename T> __device__ __forceinline__ T eps_of();
template <> __device__ __forceinline__ float eps_of<float>() { return FLT_EPSILON; }
template <> __device__ __forceinline__ double eps_of<double>() { return DBL_EPSILON; }

// max that propagates NaN, as jnp.max does
template <typename T> __device__ __forceinline__ T maxnan(T a, T b) {
  return (b > a || b != b) ? b : a;
}

// Sum / max of one value a thread over the block; every thread gets the
// result.  red holds 33 values.
template <typename T> __device__ T block_sum(T v, T* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    T s = T(0);
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) s += red[w];
    red[32] = s;
  }
  __syncthreads();
  return red[32];
}

template <typename T> __device__ T block_max(T v, T* red) {
  for (int o = 16; o > 0; o >>= 1) v = maxnan(v, __shfl_down_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    T m = T(0);
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) m = maxnan(m, red[w]);
    red[32] = m;
  }
  __syncthreads();
  return red[32];
}

template <typename T> __device__ T block_absmax(const T* A, long long count, T* red) {
  T m = T(0);
  for (long long e = threadIdx.x; e < count; e += blockDim.x) m = maxnan(m, fabs(A[e]));
  return block_max(m, red);
}

// P = I - 2 v v^T / (v^T v) annihilating (y, z) in (x, y, z); the identity
// when the vector already is (x, 0, 0) (hessenberg.py:69-82)
template <typename T>
__device__ __forceinline__ void householder3(T x, T y, T z, T P[9]) {
  const T s = sqrt(x * x + y * y + z * z);
  const T alpha = -(x >= T(0) ? s : -s);
  const T v0 = x - alpha;
  const T vn2 = v0 * v0 + y * y + z * z;
  const T inv = vn2 > T(0) ? T(2) / vn2 : T(0);
  const T v[3] = {v0, y, z};
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) P[r * 3 + c] = (r == c ? T(1) : T(0)) - inv * (v[r] * v[c]);
}

// One Francis double-shift bulge chase on the window [lo, hi] (size >= 3)
// with shift sum s and product t, then the closing Givens rotation
// (hessenberg.py:85-163).  Every thread calls it, after a barrier since the
// last write to H; it ends with a barrier.  Z (n x n) may be null.
template <typename T>
__device__ void chase(T* H, T* Z, int n, int lo, int hi, T s, T t) {
  if (n < 3) return;
  const int tid = threadIdx.x, nt = blockDim.x;
  const T h00 = H[lo * n + lo], h01 = H[lo * n + lo + 1], h10 = H[(lo + 1) * n + lo];
  const T h11 = H[(lo + 1) * n + lo + 1], h21 = H[(lo + 2) * n + lo + 1];
  const T x0 = h00 * h00 + h01 * h10 - s * h00 + t;
  const T y0 = h10 * (h00 + h11 - s);
  const T z0 = h10 * h21;
  __syncthreads();  // the first step's row update writes these entries
  int p = lo < 0 ? 0 : (lo > n - 3 ? n - 3 : lo);
  for (; p <= hi - 2; ++p) {
    const bool first = p == lo;
    T x = x0, y = y0, z = z0;
    if (!first) {
      x = H[p * n + p - 1];
      y = H[(p + 1) * n + p - 1];
      z = H[(p + 2) * n + p - 1];
    }
    T P[9];
    householder3(x, y, z, P);
    T* r0p = H + p * n;
    T* r1p = r0p + n;
    T* r2p = r1p + n;
    for (int c = tid; c < n; c += nt) {
      if (!first && c == p - 1) continue;  // written below, in the column phase
      const T r0 = r0p[c], r1 = r1p[c], r2 = r2p[c];
      r0p[c] = P[0] * r0 + P[1] * r1 + P[2] * r2;
      r1p[c] = P[3] * r0 + P[4] * r1 + P[5] * r2;
      r2p[c] = P[6] * r0 + P[7] * r1 + P[8] * r2;
    }
    __syncthreads();
    for (int r = tid; r < n; r += nt) {
      T* row = H + r * n + p;
      const T c0 = row[0], c1 = row[1], c2 = row[2];
      row[0] = c0 * P[0] + c1 * P[3] + c2 * P[6];
      row[1] = c0 * P[1] + c1 * P[4] + c2 * P[7];
      row[2] = c0 * P[2] + c1 * P[5] + c2 * P[8];
      if (Z) {
        T* zr = Z + r * n + p;
        const T d0 = zr[0], d1 = zr[1], d2 = zr[2];
        zr[0] = d0 * P[0] + d1 * P[3] + d2 * P[6];
        zr[1] = d0 * P[1] + d1 * P[4] + d2 * P[7];
        zr[2] = d0 * P[2] + d1 * P[5] + d2 * P[8];
      }
    }
    if (!first && tid == 0) {
      // the bulge column: its reflected head, and exact zeros below it
      r0p[p - 1] = P[0] * x + P[1] * y + P[2] * z;
      r1p[p - 1] = T(0);
      r2p[p - 1] = T(0);
    }
    __syncthreads();
  }
  // closing Givens on rows/columns (hi-1, hi), zeroing H[hi, hi-2]
  const T x = H[(hi - 1) * n + hi - 2], y = H[hi * n + hi - 2];
  const T r = sqrt(x * x + y * y);
  const T c = r > T(0) ? x / r : T(1);
  const T sn = r > T(0) ? y / r : T(0);
  T* ra = H + (hi - 1) * n;
  T* rb = ra + n;
  for (int col = tid; col < n; col += nt) {
    if (col == hi - 2) continue;
    const T a = ra[col], b = rb[col];
    ra[col] = c * a + sn * b;
    rb[col] = -sn * a + c * b;
  }
  __syncthreads();
  for (int row = tid; row < n; row += nt) {
    T* e = H + row * n + hi - 1;
    const T a = e[0], b = e[1];
    e[0] = a * c + b * sn;
    e[1] = a * -sn + b * c;
    if (Z) {
      T* ze = Z + row * n + hi - 1;
      const T za = ze[0], zb = ze[1];
      ze[0] = za * c + zb * sn;
      ze[1] = za * -sn + zb * c;
    }
  }
  if (tid == 0) {
    ra[hi - 2] = c * x + sn * y;
    rb[hi - 2] = T(0);
  }
  __syncthreads();
}

template <typename T> __host__ __device__ constexpr long long smem_need(int n) {
  return (static_cast<long long>(n) * n + 4LL * n) * static_cast<long long>(sizeof(T)) + 4LL * n;
}

template <typename T>
__global__ void __launch_bounds__(HS_MAX_THREADS)
schur_kernel(const T* __restrict__ Hin, T* Tout, T* Zout, T* wr, T* wi, int* acc_out,
             int* status, const int* keff_ptr, int n, int with_z, int split, int h_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[33];
  __shared__ T sc[2];
  __shared__ int si[8];
  T* H = h_in_smem ? reinterpret_cast<T*>(smem_raw) : Tout;
  T* vec = h_in_smem ? H + static_cast<long long>(n) * n : reinterpret_cast<T*>(smem_raw);
  T* u = vec;
  T* w = vec + n;
  T* v = vec + 2 * n;
  T* zv = vec + 3 * n;
  int* acc = reinterpret_cast<int*>(vec + 4 * n);
  T* Z = with_z ? Zout : nullptr;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int k = *keff_ptr;
  const long long nn = static_cast<long long>(n) * n;

  // _embed: zero the inactive block, plant the dummy diagonal
  T m = T(0);
  for (long long e = tid; e < nn; e += nt) {
    const int i = static_cast<int>(e / n), j = static_cast<int>(e % n);
    if (i < k && j < k) m = maxnan(m, fabs(Hin[e]));
  }
  const T norm = block_max(m, red) + T(1);
  for (long long e = tid; e < nn; e += nt) {
    const int i = static_cast<int>(e / n), j = static_cast<int>(e % n);
    T val = (i < k && j < k) ? Hin[e] : T(0);
    if (i == j && i >= k) val = norm * (T(2) + T(i) / T(n));
    H[e] = val;
    if (Z) Z[e] = i == j ? T(1) : T(0);
  }
  for (int i = tid; i < n; i += nt) acc[i] = 0;
  __syncthreads();

  // _to_hessenberg: one Householder reflector a column
  for (int j = 0; j + 2 < n; ++j) {
    T part = T(0);
    for (int i = j + 1 + tid; i < n; i += nt) part += H[i * n + j] * H[i * n + j];
    const T s = sqrt(block_sum(part, red));
    const T x0 = H[(j + 1) * n + j];
    const T alpha = -(x0 >= T(0) ? s : -s);
    for (int i = tid; i < n; i += nt)
      u[i] = i > j ? H[i * n + j] - (i == j + 1 ? alpha : T(0)) : T(0);
    __syncthreads();
    T p2 = T(0);
    for (int i = j + 1 + tid; i < n; i += nt) p2 += u[i] * u[i];
    const T un2 = block_sum(p2, red);
    const T inv = un2 > T(0) ? T(2) / un2 : T(0);
    for (int c = tid; c < n; c += nt) {  // w = u^T H
      T a = T(0);
      for (int i = j + 1; i < n; ++i) a += u[i] * H[i * n + c];
      w[c] = a;
    }
    __syncthreads();
    for (long long e = tid; e < static_cast<long long>(n - j - 1) * n; e += nt) {
      const int i = j + 1 + static_cast<int>(e / n), c = static_cast<int>(e % n);
      H[i * n + c] -= inv * (u[i] * w[c]);
    }
    __syncthreads();
    for (int r = tid; r < n; r += nt) {  // v = H u, zv = Z u
      T a = T(0), b = T(0);
      for (int c = j + 1; c < n; ++c) a += H[r * n + c] * u[c];
      if (Z)
        for (int c = j + 1; c < n; ++c) b += Z[r * n + c] * u[c];
      v[r] = a;
      zv[r] = b;
    }
    __syncthreads();
    const int width = n - j - 1;
    for (long long e = tid; e < static_cast<long long>(n) * width; e += nt) {
      const int r = static_cast<int>(e / width), c = j + 1 + static_cast<int>(e % width);
      H[r * n + c] -= inv * (v[r] * u[c]);
      if (Z) Z[r * n + c] -= inv * (zv[r] * u[c]);
    }
    __syncthreads();
    for (int i = j + 2 + tid; i < n; i += nt) H[i * n + j] = T(0);
    __syncthreads();
  }

  // _schur_core
  int ok = 1, sweeps = 0, steps = 0;  // steps: chase steps, thread 0's
  if (n >= 2) {
    const T eps = eps_of<T>();
    const int max_sweeps = 30 * n;
    int last_hi = -1, stall = 0;  // thread 0's
    while (true) {
      __syncthreads();
      if (tid == 0) {
        bool open = false;
        for (int i = 0; i + 1 < n && !open; ++i) open = H[(i + 1) * n + i] != T(0) && !acc[i];
        si[0] = open && sweeps < max_sweeps;
        bool need = false;
        for (int i = 0; si[0] && i + 1 < n && !need; ++i)
          need = fabs(H[i * n + i]) + fabs(H[(i + 1) * n + i + 1]) == T(0);
        si[1] = need;
      }
      __syncthreads();
      if (!si[0]) break;
      const T hmax = si[1] ? block_absmax(H, nn, red) : T(0);
      if (tid == 0) {
        int hi_c = -1;
        for (int i = 0; i + 1 < n; ++i) {
          T tst = fabs(H[i * n + i]) + fabs(H[(i + 1) * n + i + 1]);
          if (tst == T(0)) tst = hmax;
          T& sub = H[(i + 1) * n + i];
          if (fabs(sub) <= eps * tst) sub = T(0);
          if (sub != T(0) && !acc[i]) hi_c = i;
        }
        const int hi = hi_c + 1;
        int lo = 0;
        for (int i = 0; i < hi_c; ++i)
          if (H[(i + 1) * n + i] == T(0)) lo = i + 1;
        stall = hi == last_hi ? stall + 1 : 0;
        int action = 0;
        if (hi_c >= 0 && hi - lo >= 2) {
          const T a11 = H[(hi - 1) * n + hi - 1], a12 = H[(hi - 1) * n + hi];
          const T a21 = H[hi * n + hi - 1], a22 = H[hi * n + hi];
          T s = a11 + a22, t = a11 * a22 - a12 * a21;
          if (stall > 0 && stall % 10 == 0) {
            const T sexc = fabs(a21) + fabs(H[(hi - 1) * n + (hi - 2 > 0 ? hi - 2 : 0)]);
            const T wexc = a22 + T(0.75) * sexc;
            s = T(2) * wexc;
            t = wexc * wexc;
          }
          sc[0] = s;
          sc[1] = t;
          si[2] = lo;
          si[3] = hi;
          action = 1;
          steps += hi - lo - 1;
        } else if (hi_c >= 0) {
          acc[hi_c] = 1;
        }
        si[4] = action;
        last_hi = hi;
        ++sweeps;
      }
      __syncthreads();
      if (si[4] == 1) chase(H, Z, n, si[2], si[3], sc[0], sc[1]);
    }
    if (tid == 0)
      for (int i = 0; i + 1 < n; ++i)
        if (H[(i + 1) * n + i] != T(0) && !acc[i]) ok = 0;
  }

  // _split_real_blocks: real-pair 2x2 blocks into two 1x1 blocks
  if (split && Z && n >= 2) {
    for (int i = 0; i + 1 < n; ++i) {
      __syncthreads();
      const T a = H[i * n + i], b = H[i * n + i + 1];
      const T c = H[(i + 1) * n + i], d = H[(i + 1) * n + i + 1];
      const T mm = T(0.5) * (a + d);
      const T disc = T(0.25) * ((a - d) * (a - d)) + b * c;
      if (!(acc[i] && disc >= T(0))) continue;
      const T sq = sqrt(fabs(disc));
      const T lam = mm + (mm >= T(0) ? sq : -sq);
      const T v1a = b, v1b = lam - a, v2a = lam - d, v2b = c;
      const bool one = v1a * v1a + v1b * v1b >= v2a * v2a + v2b * v2b;
      T va = one ? v1a : v2a, vb = one ? v1b : v2b;
      const T nrm = sqrt(va * va + vb * vb);
      if (nrm > T(0)) {
        va = va / nrm;
        vb = vb / nrm;
      } else {
        va = T(1);
        vb = T(0);
      }
      __syncthreads();
      for (int col = tid; col < n; col += nt) {  // G^T rows, G = [[va, -vb], [vb, va]]
        const T r0 = H[i * n + col], r1 = H[(i + 1) * n + col];
        H[i * n + col] = va * r0 + vb * r1;
        H[(i + 1) * n + col] = -vb * r0 + va * r1;
      }
      __syncthreads();
      for (int row = tid; row < n; row += nt) {  // columns G, and Z's
        T* e = H + row * n + i;
        const T c0 = e[0], c1 = e[1];
        e[0] = c0 * va + c1 * vb;
        e[1] = c0 * -vb + c1 * va;
        T* ze = Z + row * n + i;
        const T z0 = ze[0], z1 = ze[1];
        ze[0] = z0 * va + z1 * vb;
        ze[1] = z0 * -vb + z1 * va;
      }
      __syncthreads();
      if (tid == 0) {
        H[(i + 1) * n + i] = T(0);
        acc[i] = 0;
      }
    }
  }
  __syncthreads();

  // _extract_eigvals, masked to the active block
  for (int i = tid; i < n; i += nt) {
    const bool ps = i + 1 < n && acc[i];
    const bool sec = i > 0 && acc[i - 1];
    T wri = H[i * n + i], wii = T(0);
    if (ps || sec) {
      const int b0 = ps ? i : i - 1;
      const T a = H[b0 * n + b0], b = H[b0 * n + b0 + 1];
      const T c = H[(b0 + 1) * n + b0], d = H[(b0 + 1) * n + b0 + 1];
      const T mm = T(0.5) * (a + d);
      const T disc = T(0.25) * ((a - d) * (a - d)) + b * c;
      const T sq = sqrt(fabs(disc));
      const bool real = disc >= T(0);
      if (ps) {
        wri = real ? mm + sq : mm;
        wii = real ? T(0) : sq;
      } else {
        wri = real ? mm - sq : mm;
        wii = real ? T(0) : -sq;
      }
    }
    if (i >= k) {
      wri = T(0);
      wii = T(0);
    }
    wr[i] = wri;
    wi[i] = wii;
    if (i + 1 < n) acc_out[i] = acc[i];
  }
  if (h_in_smem)
    for (long long e = tid; e < nn; e += nt) Tout[e] = H[e];
  if (tid == 0) {
    status[0] = ok;
    status[1] = sweeps;
    status[2] = steps;
  }
}

template <typename T>
__global__ void __launch_bounds__(HS_MAX_THREADS)
filter_kernel(const T* __restrict__ Hin, T* Hout, T* Zout, const T* __restrict__ wr,
              const T* __restrict__ wi, const int* __restrict__ order, const int* nkeep_ptr,
              const int* pure_ptr, int* status, int n, int h_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[33];
  __shared__ T sc[2];
  __shared__ int si[8];
  T* H = h_in_smem ? reinterpret_cast<T*>(smem_raw) : Hout;
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long nn = static_cast<long long>(n) * n;
  for (long long e = tid; e < nn; e += nt) {
    H[e] = Hin[e];
    Zout[e] = (e / n == e % n) ? T(1) : T(0);
  }
  const int nkeep = *nkeep_ptr;
  const bool pure = *pure_ptr != 0;
  const T eps = eps_of<T>();
  int active = 0, steps = 0;  // thread 0's
  for (int j = 0; j < n / 2; ++j) {
    __syncthreads();
    if (tid == 0) {
      bool need = false;
      for (int i = 0; i + 1 < n && !need; ++i)
        need = fabs(H[i * n + i]) + fabs(H[(i + 1) * n + i + 1]) == T(0);
      si[1] = need;
    }
    __syncthreads();
    const T hmax = si[1] ? block_absmax(H, nn, red) : T(0);
    if (tid == 0) {
      // explicit deflation, then the top-connected block ends at row hi
      int hi = n - 1;
      for (int i = 0; i + 1 < n; ++i) {
        T tst = fabs(H[i * n + i]) + fabs(H[(i + 1) * n + i + 1]);
        if (tst == T(0)) tst = hmax;
        T& sub = H[(i + 1) * n + i];
        if (fabs(sub) <= eps * tst) sub = T(0);
        if (sub == T(0) && hi == n - 1) hi = i;
      }
      const bool act = (2 * j + 1) < (n - nkeep) && pure && hi >= 2;
      if (act) {
        const int ja = 2 * j < n - 1 ? 2 * j : n - 1;
        const int jb = 2 * j + 1 < n - 1 ? 2 * j + 1 : n - 1;
        const int ia = order[ja], ib = order[jb];
        sc[0] = wr[ia] + wr[ib];
        sc[1] = wr[ia] * wr[ib] - wi[ia] * wi[ib];
        si[3] = hi;
        ++active;
        steps += hi - 1;
      }
      si[4] = act;
    }
    __syncthreads();
    if (si[4]) chase(H, Zout, n, 0, si[3], sc[0], sc[1]);
  }
  __syncthreads();
  if (h_in_smem)
    for (long long e = tid; e < nn; e += nt) Hout[e] = H[e];
  if (tid == 0) {
    status[0] = active;
    status[1] = steps;
  }
}

template <typename T> bool fits_smem(int n) { return smem_need<T>(n) <= HS_SMEM_BYTES; }

int threads_for(int n) {
  const int t = (n + 31) / 32 * 32;
  return t < 32 ? 32 : (t > HS_MAX_THREADS ? HS_MAX_THREADS : t);
}

// the dynamic shared-memory attribute, set once a kernel and device
template <typename K> cudaError_t allow_smem(K kernel, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, HS_SMEM_BYTES);
  if (err == cudaSuccess) done[dev] = true;
  return err;
}

template <typename T>
int launch_schur(const void* H, void* Tm, void* Z, void* wr, void* wi, void* acc, void* status,
                 const void* keff, int n, int with_z, int split, void* stream) {
  if (n < 1 || !H || !Tm || !wr || !wi || !status || !keff || (with_z && !Z) ||
      (n > 1 && !acc))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool done[64] = {};
  cudaError_t err = allow_smem(schur_kernel<T>, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool in_smem = fits_smem<T>(n);
  const long long smem = in_smem ? smem_need<T>(n) : smem_need<T>(n) - 1LL * n * n * sizeof(T);
  if (smem > HS_SMEM_BYTES) return static_cast<int>(cudaErrorInvalidValue);
  schur_kernel<T><<<1, threads_for(n), static_cast<size_t>(smem),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(H), static_cast<T*>(Tm), static_cast<T*>(Z), static_cast<T*>(wr),
      static_cast<T*>(wi), static_cast<int*>(acc), static_cast<int*>(status),
      static_cast<const int*>(keff), n, with_z, split, in_smem ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_filter(const void* H, void* Hf, void* Z, const void* wr, const void* wi,
                  const void* order, const void* nkeep, const void* pure, void* status, int n,
                  void* stream) {
  if (n < 1 || !H || !Hf || !Z || !wr || !wi || !order || !nkeep || !pure || !status)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool done[64] = {};
  cudaError_t err = allow_smem(filter_kernel<T>, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool in_smem = fits_smem<T>(n);
  // the filter needs no vectors: H alone, when it fits
  const long long smem = in_smem ? 1LL * n * n * sizeof(T) : 0;
  filter_kernel<T><<<1, threads_for(n), static_cast<size_t>(smem),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(H), static_cast<T*>(Hf), static_cast<T*>(Z),
      static_cast<const T*>(wr), static_cast<const T*>(wi), static_cast<const int*>(order),
      static_cast<const int*>(nkeep), static_cast<const int*>(pure), static_cast<int*>(status),
      n, in_smem ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int lk_hessenberg_schur_f32(const void* H, void* T, void* Z, void* wr, void* wi, void* acc,
                            void* status, const void* keff, int n, int with_z, int split,
                            void* stream) {
  return launch_schur<float>(H, T, Z, wr, wi, acc, status, keff, n, with_z, split, stream);
}

int lk_hessenberg_schur_f64(const void* H, void* T, void* Z, void* wr, void* wi, void* acc,
                            void* status, const void* keff, int n, int with_z, int split,
                            void* stream) {
  return launch_schur<double>(H, T, Z, wr, wi, acc, status, keff, n, with_z, split, stream);
}

int lk_francis_sweeps_f32(const void* H, void* Hf, void* Z, const void* wr, const void* wi,
                          const void* order, const void* nkeep, const void* pure, void* status,
                          int n, void* stream) {
  return launch_filter<float>(H, Hf, Z, wr, wi, order, nkeep, pure, status, n, stream);
}

int lk_francis_sweeps_f64(const void* H, void* Hf, void* Z, const void* wr, const void* wi,
                          const void* order, const void* nkeep, const void* pure, void* status,
                          int n, void* stream) {
  return launch_filter<double>(H, Hf, Z, wr, wi, order, nkeep, pure, status, n, stream);
}

}  // extern "C"
