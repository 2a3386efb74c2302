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
//   do, rows of odd stride n | 1; else the output buffers).  Two barriers a
//   swap, none inside the 4 x 4 work.
// - Warp 0 finds the next swap with a ballot a chunk of 32 positions over
//   the subdiagonal and the mask: the first block start whose block is
//   unselected with a selected block right below it.  A swap changes no
//   block before its own, so the search starts at the block before the last
//   swap's.  Every lane of warp 0 then forms the transform, specialised at
//   compile time for the block sizes (n1, n2), every array at a fixed index
//   (no stack frame), and lane e < m^2 one entry of the new window (Q^T W) Q
//   and of the test's coupling; lane 0 publishes the transform.
// - After the barrier, warp 0 writes the window, and the other entries of
//   the four rows of T, the four columns of T above the window and those of
//   Z are updated together: they are disjoint.
// - The test holds the annihilated coupling resid to 50 eps (max |T| + 1).
//   Warp 0 first holds it to 50 eps (L + 1), L = max |W| of the window, a
//   lower bound of max |T|: a swap that passes there passes the full test,
//   so only the rest (none on the restarts' inputs, in practice) pays the
//   CTA's reduction of max |T|, and the decision is the full test's.
// - The mask is made pair-consistent in the kernel and kept in shared
//   memory while the loop runs, then in the sel output; nothing is read by
//   the host, nothing allocated.
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

// A x = b for the Q x Q matrix A by Gaussian elimination with partial
// pivoting (the first largest |a| of the column), then back substitution
// (utils/hessenberg.py _solve_pivoted); A and b are overwritten.  Every index
// is fixed at compile time: the row swap is a select on the pivot's row.
// Called by all of warp 0 on the same operands: a step's multipliers,
// independent, are one division, row r's on lane r.
template <typename T, int Q>
__device__ __forceinline__ void solve_pivoted(T (&A)[Q][Q], T (&b)[Q], T (&x)[Q], int lane) {
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    int p = j;
    T best = fabs(A[j][j]);
#pragma unroll
    for (int r = j + 1; r < Q; ++r)
      if (fabs(A[r][j]) > best) {
        p = r;
        best = fabs(A[r][j]);
      }
#pragma unroll
    for (int r = j + 1; r < Q; ++r)
      if (p == r) {
#pragma unroll
        for (int c = 0; c < Q; ++c) {
          const T t = A[j][c];
          A[j][c] = A[r][c];
          A[r][c] = t;
        }
        const T t = b[j];
        b[j] = b[r];
        b[r] = t;
      }
    T num = A[j + 1 < Q ? j + 1 : j][j];
#pragma unroll
    for (int r = j + 2; r < Q; ++r)
      if (lane == r) num = A[r][j];
    const T lq = num / A[j][j];
#pragma unroll
    for (int r = j + 1; r < Q; ++r) {
      const T l = __shfl_sync(FULL, lq, r);
#pragma unroll
      for (int c = j + 1; c < Q; ++c) A[r][c] = rsub(A[r][c], rmul(l, A[j][c]));
      b[r] = rsub(b[r], rmul(l, b[j]));
    }
  }
#pragma unroll
  for (int r = Q - 1; r >= 0; --r) {
    T acc = b[r];
#pragma unroll
    for (int c = r + 1; c < Q; ++c) acc = rsub(acc, rmul(A[r][c], x[c]));
    x[r] = acc / A[r][r];
  }
}

// Q (M x M) of the complete QR of the M x NQ matrix R (NQ < M) by
// Householder reflectors in LAPACK's convention (utils/hessenberg.py
// _householder_q); R is overwritten.  Called by all of warp 0 on the same
// operands: a reflector's tau and 1 / (alpha - beta) are one division, on
// lanes 0 and 1.
template <typename T, int M, int NQ>
__device__ __forceinline__ void householder_q(T (&R)[M][NQ], T (&Qm)[M][M], int lane) {
  T v[NQ][M], tau[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    // ||x|| on the column scaled by the power of two of its largest entry
    T mx = T(0);
#pragma unroll
    for (int r = j; r < M; ++r) mx = maxnan(mx, fabs(R[r][j]));
    int e = 0;
    if (mx > T(0) && isfinite(mx)) frexp(mx, &e);
    T ss = T(0);
#pragma unroll
    for (int r = j + 1; r < M; ++r) {
      const T t = ldexp(R[r][j], -e);
      ss = radd(ss, rmul(t, t));
    }
#pragma unroll
    for (int r = 0; r < M; ++r) v[j][r] = r == j ? T(1) : T(0);
    tau[j] = T(0);
    if (ss != T(0)) {
      const T alpha = R[j][j];
      const T a = ldexp(alpha, -e);
      const T h = ldexp(sqrt(radd(rmul(a, a), ss)), e);
      const T beta = alpha >= T(0) ? -h : h;
      const bool odd = lane & 1;
      const T q = (odd ? T(1) : rsub(beta, alpha)) / (odd ? rsub(alpha, beta) : beta);
      tau[j] = __shfl_sync(FULL, q, 0);
      const T scl = __shfl_sync(FULL, q, 1);
#pragma unroll
      for (int r = j + 1; r < M; ++r) v[j][r] = rmul(R[r][j], scl);
#pragma unroll
      for (int c = j + 1; c < NQ; ++c) {
        T w = T(0);
#pragma unroll
        for (int r = j; r < M; ++r) w = radd(w, rmul(v[j][r], R[r][c]));
#pragma unroll
        for (int r = j; r < M; ++r) R[r][c] = rsub(R[r][c], rmul(tau[j], rmul(v[j][r], w)));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < M; ++r)
#pragma unroll
    for (int c = 0; c < M; ++c) Qm[r][c] = r == c ? T(1) : T(0);
#pragma unroll
  for (int j = NQ - 1; j >= 0; --j)
#pragma unroll
    for (int c = 0; c < M; ++c) {
      T w = T(0);
#pragma unroll
      for (int r = j; r < M; ++r) w = radd(w, rmul(v[j][r], Qm[r][c]));
#pragma unroll
      for (int r = j; r < M; ++r) Qm[r][c] = rsub(Qm[r][c], rmul(tau[j], rmul(v[j][r], w)));
    }
}

// What warp 0 publishes for the other warps: the swap (i, n1, n2), what to
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

// The direct swap of the blocks (N1, N2) leading the window at (i, i) of T
// (row stride ld), by every lane of warp 0: K = kron(I, A11) - kron(A22^T, I)
// plus the ridge eps (max |K| + 1), K x = -vec(A12), Q of [X; I]
// (utils/hessenberg.py _swap_plain); then lane e < M^2 forms entry
// (e / M, e % M) of the new window (Q^T W) Q, each entry's sums in the
// plain version's order (the row update's, then the column update's), with
// the exact zeros below the new block diagonal, into *wv.  The test's
// resid is the warp's max of the lower-left (N1, N2) block.  Lane 0
// publishes the swap into d.
template <typename T, int N1, int N2>
__device__ __forceinline__ void form_swap(const T* Tm, int ld, int i, int lane, Swap<T>& d,
                                          T* wv, int* widx) {
  constexpr int M = N1 + N2, Q = N1 * N2;
  T W[M][M];
  T L = T(0);
#pragma unroll
  for (int r = 0; r < M; ++r)
#pragma unroll
    for (int c = 0; c < M; ++c) {
      W[r][c] = Tm[(i + r) * ld + i + c];
      L = maxnan(L, fabs(W[r][c]));
    }
  T K[Q][Q], rhs[Q], x[Q];
#pragma unroll
  for (int c = 0; c < N2; ++c)
#pragma unroll
    for (int r = 0; r < N1; ++r) {
      const int a = c * N1 + r;
      rhs[a] = -W[r][N1 + c];
#pragma unroll
      for (int c2 = 0; c2 < N2; ++c2)
#pragma unroll
        for (int r2 = 0; r2 < N1; ++r2) {
          T k = T(0);
          if (c == c2 && r == r2)
            k = rsub(W[r][r], W[N1 + c][N1 + c]);
          else if (c == c2)
            k = W[r][r2];
          else if (r == r2)
            k = -W[N1 + c2][N1 + c];
          K[a][c2 * N1 + r2] = k;
        }
    }
  T kmax = T(0);
#pragma unroll
  for (int a = 0; a < Q; ++a)
#pragma unroll
    for (int b = 0; b < Q; ++b) kmax = maxnan(kmax, fabs(K[a][b]));
  const T reg = rmul(eps_of<T>(), radd(kmax, T(1)));
#pragma unroll
  for (int a = 0; a < Q; ++a) K[a][a] = radd(K[a][a], reg);
  solve_pivoted<T, Q>(K, rhs, x, lane);
  T Mx[M][N2];
#pragma unroll
  for (int r = 0; r < M; ++r)
#pragma unroll
    for (int c = 0; c < N2; ++c) Mx[r][c] = T(0);
#pragma unroll
  for (int c = 0; c < N2; ++c) {
#pragma unroll
    for (int r = 0; r < N1; ++r) Mx[r][c] = x[c * N1 + r];
    Mx[N1 + c][c] = T(1);
  }
  T Qm[M][M];
  householder_q<T, M, N2>(Mx, Qm, lane);
  // this lane's entry (r, c) of the new window: Q's columns r and c picked
  // by selects, so that every index stays fixed
  const int r = lane / M < M ? lane / M : 0, c = lane % M;
  T qr[M], qc[M];
#pragma unroll
  for (int a = 0; a < M; ++a) {
    qr[a] = Qm[a][0];
    qc[a] = Qm[a][0];
#pragma unroll
    for (int t = 1; t < M; ++t) {
      if (r == t) qr[a] = Qm[a][t];
      if (c == t) qc[a] = Qm[a][t];
    }
  }
  T u[M];  // row r of Q^T W
#pragma unroll
  for (int b = 0; b < M; ++b) {
    T acc = rmul(qr[0], W[0][b]);
#pragma unroll
    for (int a = 1; a < M; ++a) acc = radd(acc, rmul(qr[a], W[a][b]));
    u[b] = acc;
  }
  T w = rmul(u[0], qc[0]);
#pragma unroll
  for (int b = 1; b < M; ++b) w = radd(w, rmul(u[b], qc[b]));
  const bool mine = lane < M * M;
  const T resid = warp_max(mine && r >= N2 && c < N2 ? fabs(w) : T(0));
  const bool keep = (N2 == 2 && r == 1 && c == 0) || (N1 == 2 && r == N2 + 1 && c == N2);
  *wv = r > c && !keep ? T(0) : w;
  *widx = mine ? (i + r) * ld + i + c : -1;
  if (lane == 0) {
    d.resid = resid;
    d.action = resid <= threshold(L) ? 1 : 2;
#pragma unroll
    for (int a = 0; a < M; ++a)
#pragma unroll
      for (int b = 0; b < M; ++b) d.q[a * 4 + b] = Qm[a][b];
#pragma unroll
    for (int e = 0; e < 16; ++e)
      if (e / 4 >= M || e % 4 >= M) d.q[e] = T(e / 4 == e % 4);
  }
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
  if constexpr (ZS) {
    Zm = base;
    base += nz * ldz;
  }
  bool* sel_s = reinterpret_cast<bool*>(base);  // the mask while the loop runs
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nw = nt >> 5;
  for (int r = warp; r < n; r += nw)
    for (int c = lane; c < n; c += 32) Tm[r * ldt + c] = Tin[r * n + c];
  for (int r = warp; r < nz; r += nw)
    for (int c = lane; c < n; c += 32) Zm[r * ldz + c] = Zin[r * n + c];
  // the mask made pair-consistent: a flag on either position of a 2x2 block
  for (int p = tid; p < n; p += nt)
    sel_s[p] = sel_in[p] || (p + 1 < n && Tin[(p + 1) * n + p] != T(0) && sel_in[p + 1]) ||
               (p > 0 && Tin[p * n + p - 1] != T(0) && sel_in[p - 1]);
  __syncthreads();

  const long long max_passes = 1LL * n * n + 4;
  long long passes = 0;
  int swaps = 0, last = 0;  // warp 0's: the last swap's position
  bool ok = false;
  T wv = T(0);  // warp 0's lanes: an entry of the new window and its place
  int widx = -1;
  for (int step = 0;; ++step) {
    lag(step, 0);
    if (warp == 0) {
      // the first block start, unselected, with a selected block right
      // below: none lies before the block that precedes the last swap
      int from = 0;
      if (last > 1) from = Tm[(last - 1) * ldt + last - 2] == T(0) ? last - 1 : last - 2;
      int i = n;
      for (int i0 = from; i0 < n && i == n; i0 += 32) {
        // the loads at indices inside T and the mask, selected after, so
        // that no branch orders them
        const int c = i0 + lane < n ? i0 + lane : n - 1;
        const T below = Tm[c * ldt + (c > 0 ? c - 1 : 0)];
        const T sub = Tm[(c + 1 < n ? c + 1 : c) * ldt + c];
        const bool sc = sel_s[c], s1 = sel_s[c + 1 < n ? c + 1 : c];
        const bool s2 = sel_s[c + 2 < n ? c + 2 : c];
        const bool start = c == 0 || below == T(0);
        const int nxt = c + 1 + (c + 1 < n && sub != T(0));
        const bool cand = i0 + lane < n && start && nxt < n && !sc && (nxt == c + 1 ? s1 : s2);
        const unsigned b = __ballot_sync(FULL, cand);
        if (b) i = i0 + __ffs(b) - 1;
      }
      if (i < n && passes < max_passes) {
        const int n1 = 1 + (i + 1 < n && Tm[(i + 1) * ldt + i] != T(0));
        const int j = i + n1 < n - 1 ? i + n1 : n - 1;
        const int n2 = 1 + (j + 1 < n && Tm[(j + 1) * ldt + j] != T(0));
        if (n1 == 1 && n2 == 1)
          form_swap<T, 1, 1>(Tm, ldt, i, lane, d, &wv, &widx);
        else if (n1 == 1)
          form_swap<T, 1, 2>(Tm, ldt, i, lane, d, &wv, &widx);
        else if (n2 == 1)
          form_swap<T, 2, 1>(Tm, ldt, i, lane, d, &wv, &widx);
        else
          form_swap<T, 2, 2>(Tm, ldt, i, lane, d, &wv, &widx);
        if (lane == 0) {
          d.i = i;
          d.n1 = n1;
          d.n2 = n2;
        }
        last = i;
      } else if (lane == 0) {
        d.action = -1;
        d.ok = i >= n;
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
    // the window, by warp 0; rows i..i+m-1 <- Q^T rows over columns
    // [i+m, n), a thread a column; columns i..i+m-1 <- columns Q over rows
    // [0, i) of T and every row of Z, a thread a row: disjoint, so no
    // barrier between them
    if (warp == 0 && widx >= 0) Tm[widx] = wv;
    for (int c = i + m + tid; c < n; c += nt) {
      T a[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) a[k] = Tm[(i + (k < m ? k : 0)) * ldt + c];
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
    for (int r = tid; r < i + nz; r += nt) {
      T* row = r < i ? Tm + r * ldt : Zm + (r - i) * ldz;
      T a[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) a[k] = row[i + (k < m ? k : 0)];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c >= m) break;
        T acc = rmul(a[0], q[c]);
#pragma unroll
        for (int k = 1; k < 4; ++k)
          if (k < m) acc = radd(acc, rmul(a[k], q[k * 4 + c]));
        row[i + c] = acc;
      }
    }
    if (tid == 0)
      for (int p = i; p < i + m; ++p) sel_s[p] = p < i + n2;
    ++swaps;
    cta_sync();
  }
  __syncthreads();
  for (int p = tid; p < n; p += nt) sel[p] = sel_s[p];
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
// there, rows of odd stride, then the mask (n bytes).  ops/hessenberg.py
// ordschur_geometry() computes the same.
long long smem_need(int n, int nz, int elt, bool t_smem, bool z_smem) {
  const long long ld = n | 1;
  return (t_smem ? 1LL * n * ld * elt : 0) + (z_smem ? 1LL * nz * ld * elt : 0) + n;
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
