// The reordering of a real Schur form of the device Krylov-Schur restart:
// LAPACK TRSEN/dtrexc's bubble sort of adjacent block swaps, in one CTA.
//
// Replaces code that the JAX package computes outside Pallas, in
// lightkrylov_tpu/utils/hessenberg.py, where jax.jit compiles the loop into
// one program: ordschur_device (:571) and its _ordschur_core (:481), whose
// swap is _swap_q_factory (:449, Bai and Demmel's direct swap, LAPACK
// dlaexc).
//
// Bound: latency.  A reorder is a chain of swaps, each of which needs the
// previous one's result: find the next swap, form its 4 x 4 transform and
// test it, apply it to four rows and four columns of T and four columns of
// Z.  The transform is a few hundred dependent scalar operations (a 1 x 1
// to 4 x 4 solve, a 4 x 2 QR, the window product); the update is a rank-4
// change of O(n) entries.  So:
//
// - One CTA, a thread a column of T for the row update and a thread a row
//   of T and Z for the column update (ops/hessenberg.py ordschur_geometry():
//   geometry()'s warps; T in shared memory when it fits, Z too when both
//   do, rows of odd stride n | 1; else the output buffers).  Three barriers
//   a swap, none inside the 4 x 4 work.
// - Warp 0 finds the next swap with a ballot a chunk of 32 positions over
//   the subdiagonal and the mask: the first block start whose block is
//   unselected with a selected block right below it.  Its lane 0 forms the
//   transform and the test and publishes them in shared memory.
// - The test holds the annihilated coupling resid to 50 eps (max |T| + 1).
//   Lane 0 first holds it to 50 eps (L + 1), L = max |W| of the window, a
//   lower bound of max |T|: a swap that passes there passes the full test,
//   so only the rest (none on the restarts' inputs, in practice) pays the
//   CTA's reduction of max |T|, and the decision is the full test's.
// - The mask is made pair-consistent in the kernel and kept in the sel
//   output; nothing is read by the host, nothing allocated.
//
// The arithmetic is the plain version's (utils/hessenberg.py
// _ordschur_plain, _swap_plain, _solve_pivoted, _householder_q), operation
// for operation: every product and sum rounded on its own (rmul, radd,
// rsub; no multiply-add), the solve's pivots, the QR's reflectors, the
// window product and the updates' sums in the order written there.  So the
// kernel and the plain version take the same swaps and decisions (sel', ok
// and the swap count equal; chip_smoke.py phase 33 and the cuda tests hold
// them to it).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (lightkrylov_tpu_torch/ops/_build.py).  The C entries
// launch on the given stream and return cudaGetLastError().

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int OS_MAX_WARPS = 8;
// shared memory a CTA may take on sm_90, and what the dynamic part leaves
// for the static part (ops/hessenberg.py holds the same numbers)
constexpr int OS_SMEM_LIMIT = 232448;
constexpr int OS_SMEM_RESERVED = 512;
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

template <typename T> __device__ __forceinline__ T warp_max(T v) {
  for (int o = 16; o > 0; o >>= 1) v = maxnan(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// The lagging-warp build (-DLK_LAG_WARP=1, ops/_build.py load_lagging(); off
// in the shipping build): at the start of each stretch between two barriers
// one warp, turning with the swap, sleeps before its loads and stores
// (csrc/hessenberg.cu lag()).
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

// A x = b for the q x q matrix A (row stride 4) by Gaussian elimination with
// partial pivoting (the first largest |a| of the column), then back
// substitution (utils/hessenberg.py _solve_pivoted); A and b are overwritten
template <typename T> __device__ void solve_pivoted(T* A, T* b, int q, T* x) {
  for (int j = 0; j < q; ++j) {
    int p = j;
    for (int r = j + 1; r < q; ++r)
      if (fabs(A[r * 4 + j]) > fabs(A[p * 4 + j])) p = r;
    if (p != j) {
      for (int c = 0; c < q; ++c) {
        const T t = A[j * 4 + c];
        A[j * 4 + c] = A[p * 4 + c];
        A[p * 4 + c] = t;
      }
      const T t = b[j];
      b[j] = b[p];
      b[p] = t;
    }
    for (int r = j + 1; r < q; ++r) {
      const T l = A[r * 4 + j] / A[j * 4 + j];
      for (int c = j + 1; c < q; ++c) A[r * 4 + c] = rsub(A[r * 4 + c], rmul(l, A[j * 4 + c]));
      b[r] = rsub(b[r], rmul(l, b[j]));
    }
  }
  for (int r = q - 1; r >= 0; --r) {
    T acc = b[r];
    for (int c = r + 1; c < q; ++c) acc = rsub(acc, rmul(A[r * 4 + c], x[c]));
    x[r] = acc / A[r * 4 + r];
  }
}

// Q (m x m, row stride 4) of the complete QR of the m x q matrix R (row
// stride 2, q < m) by Householder reflectors in LAPACK's convention
// (utils/hessenberg.py _householder_q); R is overwritten
template <typename T> __device__ void householder_q(T* R, int m, int q, T* Q) {
  T v[2][4], tau[2];
  for (int j = 0; j < q; ++j) {
    // ||x|| on the column scaled by the power of two of its largest entry
    T mx = T(0);
    for (int r = j; r < m; ++r) mx = maxnan(mx, fabs(R[r * 2 + j]));
    int e = 0;
    if (mx > T(0) && isfinite(mx)) frexp(mx, &e);
    T ss = T(0);
    for (int r = j + 1; r < m; ++r) {
      const T t = ldexp(R[r * 2 + j], -e);
      ss = radd(ss, rmul(t, t));
    }
    for (int r = 0; r < 4; ++r) v[j][r] = r == j ? T(1) : T(0);
    tau[j] = T(0);
    if (ss != T(0)) {
      const T alpha = R[j * 2 + j];
      const T a = ldexp(alpha, -e);
      const T h = ldexp(sqrt(radd(rmul(a, a), ss)), e);
      const T beta = alpha >= T(0) ? -h : h;
      tau[j] = rsub(beta, alpha) / beta;
      const T scl = T(1) / rsub(alpha, beta);
      for (int r = j + 1; r < m; ++r) v[j][r] = rmul(R[r * 2 + j], scl);
      for (int c = j + 1; c < q; ++c) {
        T w = T(0);
        for (int r = j; r < m; ++r) w = radd(w, rmul(v[j][r], R[r * 2 + c]));
        for (int r = j; r < m; ++r)
          R[r * 2 + c] = rsub(R[r * 2 + c], rmul(tau[j], rmul(v[j][r], w)));
      }
    }
  }
  for (int r = 0; r < 4; ++r)
    for (int c = 0; c < 4; ++c) Q[r * 4 + c] = r == c ? T(1) : T(0);
  for (int j = q - 1; j >= 0; --j)
    for (int c = 0; c < m; ++c) {
      T w = T(0);
      for (int r = j; r < m; ++r) w = radd(w, rmul(v[j][r], Q[r * 4 + c]));
      for (int r = j; r < m; ++r) Q[r * 4 + c] = rsub(Q[r * 4 + c], rmul(tau[j], rmul(v[j][r], w)));
    }
}

// The decision lane 0 of warp 0 publishes: the swap (i, n1, n2), what to
// do (-1 stop with ok, 1 apply, 2 hold resid to the full test first), the
// transform Q (row stride 4) and the annihilated coupling resid
template <typename T> struct Swap {
  int i, n1, n2, action, ok;
  T resid;
  T q[16];
};

// rej_factor eps (x + 1), the test's threshold (utils/hessenberg.py
// _swap_plain)
template <typename T> __device__ __forceinline__ T threshold(T x) {
  return rmul(rmul(T(50), eps_of<T>()), radd(x, T(1)));
}

// The direct swap of the blocks (n1, n2) leading the window at (i, i) of
// T (row stride ld) into d: K = kron(I, A11) - kron(A22^T, I) plus the ridge
// eps (max |K| + 1), K x = -vec(A12), Q of [X; I], then (Q^T W) Q's
// lower-left block (utils/hessenberg.py _swap_plain)
template <typename T>
__device__ void form_swap(const T* Tm, int ld, int i, int n1, int n2, Swap<T>& d) {
  const int m = n1 + n2, q = n1 * n2;
  T W[16];
  T L = T(0);
  for (int r = 0; r < m; ++r)
    for (int c = 0; c < m; ++c) {
      W[r * 4 + c] = Tm[(i + r) * ld + i + c];
      L = maxnan(L, fabs(W[r * 4 + c]));
    }
  T K[16], rhs[4], x[4];
  T kmax = T(0);
  for (int c = 0; c < n2; ++c)
    for (int r = 0; r < n1; ++r) {
      const int a = c * n1 + r;
      rhs[a] = -W[r * 4 + n1 + c];
      for (int c2 = 0; c2 < n2; ++c2)
        for (int r2 = 0; r2 < n1; ++r2) {
          const int b = c2 * n1 + r2;
          T k = T(0);
          if (c == c2 && r == r2)
            k = rsub(W[r * 4 + r], W[(n1 + c) * 4 + n1 + c]);
          else if (c == c2)
            k = W[r * 4 + r2];
          else if (r == r2)
            k = -W[(n1 + c2) * 4 + n1 + c];
          K[a * 4 + b] = k;
        }
    }
  for (int a = 0; a < q; ++a)
    for (int b = 0; b < q; ++b) kmax = maxnan(kmax, fabs(K[a * 4 + b]));
  const T reg = rmul(eps_of<T>(), radd(kmax, T(1)));
  for (int a = 0; a < q; ++a) K[a * 4 + a] = radd(K[a * 4 + a], reg);
  solve_pivoted(K, rhs, q, x);
  T M[8];
  for (int r = 0; r < 4; ++r)
    for (int c = 0; c < 2; ++c) M[r * 2 + c] = T(0);
  for (int c = 0; c < n2; ++c) {
    for (int r = 0; r < n1; ++r) M[r * 2 + c] = x[c * n1 + r];
    M[(n1 + c) * 2 + c] = T(1);
  }
  householder_q(M, m, n2, d.q);
  const T* Q = d.q;
  T resid = T(0);
  for (int r = n2; r < m; ++r) {
    T U[4];  // row r of Q^T W
    for (int c = 0; c < m; ++c) {
      T acc = rmul(Q[r], W[c]);
      for (int a = 1; a < m; ++a) acc = radd(acc, rmul(Q[a * 4 + r], W[a * 4 + c]));
      U[c] = acc;
    }
    for (int c = 0; c < n2; ++c) {
      T acc = rmul(U[0], Q[c]);
      for (int b = 1; b < m; ++b) acc = radd(acc, rmul(U[b], Q[b * 4 + c]));
      resid = maxnan(resid, fabs(acc));
    }
  }
  d.resid = resid;
  d.action = resid <= threshold(L) ? 1 : 2;
}

template <typename T, bool TS, bool ZS>
__global__ void __launch_bounds__(OS_MAX_WARPS * 32)
ordschur_kernel(const T* __restrict__ Tin, const T* __restrict__ Zin,
                const bool* __restrict__ sel_in, T* Tout, T* Zout, bool* sel, bool* ok_out,
                int* swaps_out, int n, int nz) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[OS_MAX_WARPS];
  __shared__ Swap<T> d;
  const int ldt = TS ? (n | 1) : n, ldz = ZS ? (n | 1) : n;
  T* base = reinterpret_cast<T*>(smem_raw);
  T* Tm = Tout;
  T* Zm = Zout;
  if constexpr (TS) {
    Tm = base;
    base += n * ldt;
  }
  if constexpr (ZS) Zm = base;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nw = nt >> 5;
  for (int r = warp; r < n; r += nw)
    for (int c = lane; c < n; c += 32) Tm[r * ldt + c] = Tin[r * n + c];
  for (int r = warp; r < nz; r += nw)
    for (int c = lane; c < n; c += 32) Zm[r * ldz + c] = Zin[r * n + c];
  // the mask made pair-consistent: a flag on either position of a 2x2 block
  for (int p = tid; p < n; p += nt)
    sel[p] = sel_in[p] || (p + 1 < n && Tin[(p + 1) * n + p] != T(0) && sel_in[p + 1]) ||
             (p > 0 && Tin[p * n + p - 1] != T(0) && sel_in[p - 1]);
  __syncthreads();

  const long long max_passes = 1LL * n * n + 4;
  long long passes = 0;
  int swaps = 0;
  bool ok = false;
  for (int step = 0;; ++step) {
    lag(step, 0);
    if (warp == 0) {
      // the first block start, unselected, with a selected block right below
      int i = n;
      for (int i0 = 0; i0 < n && i == n; i0 += 32) {
        const int c = i0 + lane;
        bool cand = false;
        if (c < n) {
          const bool start = c == 0 || Tm[c * ldt + c - 1] == T(0);
          const int nxt = c + 1 + (c + 1 < n && Tm[(c + 1) * ldt + c] != T(0));
          cand = start && nxt < n && !sel[c] && sel[nxt];
        }
        const unsigned b = __ballot_sync(FULL, cand);
        if (b) i = i0 + __ffs(b) - 1;
      }
      if (lane == 0) {
        d.action = -1;
        d.ok = i >= n;
        if (i < n && passes < max_passes) {
          const int n1 = 1 + (i + 1 < n && Tm[(i + 1) * ldt + i] != T(0));
          const int j = i + n1 < n - 1 ? i + n1 : n - 1;
          const int n2 = 1 + (j + 1 < n && Tm[(j + 1) * ldt + j] != T(0));
          d.i = i;
          d.n1 = n1;
          d.n2 = n2;
          form_swap(Tm, ldt, i, n1, n2, d);
        }
      }
    }
    cta_sync();
    lag(step, 1);
    const int action = d.action;
    if (action < 0) {
      ok = d.ok != 0;
      break;
    }
    ++passes;
    if (action == 2) {  // the full test: resid against 50 eps (max |T| + 1)
      T mloc = T(0);
      for (int r = warp; r < n; r += nw)
        for (int c = lane; c < n; c += 32) mloc = maxnan(mloc, fabs(Tm[r * ldt + c]));
      const T anrm = block_max(mloc, red);
      if (d.resid > threshold(anrm)) break;  // rejected: ok stays false
    }
    const int i = d.i, n1 = d.n1, n2 = d.n2, m = n1 + n2;
    T q[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) q[e] = d.q[e];
    // rows i..i+m-1 <- Q^T rows, over columns [i, n): a thread a column
    for (int c = i + tid; c < n; c += nt) {
      T a[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) a[k] = k < m ? Tm[(i + k) * ldt + c] : T(0);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (r >= m) break;
        T acc = rmul(q[r], a[0]);
#pragma unroll
        for (int k = 1; k < 4; ++k)
          if (k < m) acc = radd(acc, rmul(q[k * 4 + r], a[k]));
        Tm[(i + r) * ldt + c] = acc;
      }
    }
    cta_sync();
    lag(step, 2);
    // columns i..i+m-1 <- columns Q, over rows [0, i+m) of T, with the exact
    // zeros below the new block diagonal (the block of size n2 leads, the
    // block of size n1 follows), and over every row of Z
    for (int r = tid; r < i + m; r += nt) {
      T a[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) a[k] = k < m ? Tm[r * ldt + i + k] : T(0);
      const int rw = r - i;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c >= m) break;
        T acc = rmul(a[0], q[c]);
#pragma unroll
        for (int k = 1; k < 4; ++k)
          if (k < m) acc = radd(acc, rmul(a[k], q[k * 4 + c]));
        const bool keep = (n2 == 2 && rw == 1 && c == 0) || (n1 == 2 && rw == n2 + 1 && c == n2);
        if (rw > c && !keep) acc = T(0);
        Tm[r * ldt + i + c] = acc;
      }
    }
    for (int r = tid; r < nz; r += nt) {
      T a[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) a[k] = k < m ? Zm[r * ldz + i + k] : T(0);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c >= m) break;
        T acc = rmul(a[0], q[c]);
#pragma unroll
        for (int k = 1; k < 4; ++k)
          if (k < m) acc = radd(acc, rmul(a[k], q[k * 4 + c]));
        Zm[r * ldz + i + c] = acc;
      }
    }
    if (tid == 0)
      for (int p = i; p < i + m; ++p) sel[p] = p < i + n2;
    ++swaps;
    cta_sync();
  }
  __syncthreads();
  if constexpr (TS)
    for (int r = warp; r < n; r += nw)
      for (int c = lane; c < n; c += 32) Tout[r * n + c] = Tm[r * ldt + c];
  if constexpr (ZS)
    for (int r = warp; r < nz; r += nw)
      for (int c = lane; c < n; c += 32) Zout[r * n + c] = Zm[r * ldz + c];
  if (tid == 0) {
    *ok_out = ok;
    *swaps_out = swaps;
  }
}

// Shared memory the kernel needs for a geometry: T and Z where they live
// there, rows of odd stride.  ops/hessenberg.py ordschur_geometry() computes
// the same.
long long smem_need(int n, int nz, int elt, bool t_smem, bool z_smem) {
  const long long ld = n | 1;
  return (t_smem ? 1LL * n * ld * elt : 0) + (z_smem ? 1LL * nz * ld * elt : 0);
}

template <typename K> cudaError_t allow_smem(K kernel, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             OS_SMEM_LIMIT - OS_SMEM_RESERVED);
  if (err == cudaSuccess) done[dev] = true;
  return err;
}

template <typename T, bool TS, bool ZS>
cudaError_t launch_as(const void* Tin, const void* Zin, const void* sel_in, void* Tout,
                      void* Zout, void* sel, void* ok, void* swaps, int n, int nz, int warps,
                      int smem, cudaStream_t stream) {
  static bool done[64] = {};
  cudaError_t err = allow_smem(ordschur_kernel<T, TS, ZS>, done);
  if (err != cudaSuccess) return err;
  ordschur_kernel<T, TS, ZS><<<1, warps * 32, static_cast<size_t>(smem), stream>>>(
      static_cast<const T*>(Tin), static_cast<const T*>(Zin), static_cast<const bool*>(sel_in),
      static_cast<T*>(Tout), static_cast<T*>(Zout), static_cast<bool*>(sel),
      static_cast<bool*>(ok), static_cast<int*>(swaps), n, nz);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* Tin, const void* Zin, const void* sel_in, void* Tout, void* Zout,
           void* sel, void* ok, void* swaps, int n, int nz, int warps, int t_smem, int z_smem,
           int smem, void* stream) {
  if (!Tin || !sel_in || !Tout || !sel || !ok || !swaps || (nz > 0 && (!Zin || !Zout)) ||
      n < 1 || nz < 0 || warps < 1 || warps > OS_MAX_WARPS || (z_smem && !t_smem) ||
      smem < smem_need(n, nz, sizeof(T), t_smem, z_smem) ||
      smem > OS_SMEM_LIMIT - OS_SMEM_RESERVED)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (z_smem)
    err = launch_as<T, true, true>(Tin, Zin, sel_in, Tout, Zout, sel, ok, swaps, n, nz, warps,
                                   smem, s);
  else if (t_smem)
    err = launch_as<T, true, false>(Tin, Zin, sel_in, Tout, Zout, sel, ok, swaps, n, nz, warps,
                                    smem, s);
  else
    err = launch_as<T, false, false>(Tin, Zin, sel_in, Tout, Zout, sel, ok, swaps, n, nz,
                                     warps, smem, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

int lk_ordschur_f32(const void* Tin, const void* Zin, const void* sel_in, void* Tout, void* Zout,
                    void* sel, void* ok, void* swaps, int n, int nz, int warps, int t_smem,
                    int z_smem, int smem_bytes, void* stream) {
  return launch<float>(Tin, Zin, sel_in, Tout, Zout, sel, ok, swaps, n, nz, warps, t_smem,
                       z_smem, smem_bytes, stream);
}

int lk_ordschur_f64(const void* Tin, const void* Zin, const void* sel_in, void* Tout, void* Zout,
                    void* sel, void* ok, void* swaps, int n, int nz, int warps, int t_smem,
                    int z_smem, int smem_bytes, void* stream) {
  return launch<double>(Tin, Zin, sel_in, Tout, Zout, sel, ok, swaps, n, nz, warps, t_smem,
                        z_smem, smem_bytes, stream);
}

}  // extern "C"
