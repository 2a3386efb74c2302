// A DCGS2 step's k-sized work as one kernel, and its two passes over the
// basis as two more, with its scalars on the device.
//
// Iteration k of GMRES's delayed-reorthogonalisation cycle
// (lightkrylov_tpu_torch/solvers/gmres.py, dcgs2_cycle; the JAX package's
// dcgs2_body) first measures, over the k+1 filled basis columns,
//
//   PR = Q^H [u_k, w]   (k+1, 2)      wTw = w . w
//
// (vector work: on one contiguous real basis the dcgs2_measure kernel
// below, else a GEMM and a dot; summed over the reduction group by one
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
// that the rank-2 update reads (its first k+1 rows), and inv_gamma into the
// scalar block; the host reads only a flag.
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
// The step's two passes over the basis are two more kernels, on the
// cycle's basis V (kdim+1 rows of n, one contiguous real tensor):
//
//   dcgs2_measure  out = [Q^H [u_k, w] row-major (k+1, 2), w . w]  reads V[:k+1], w
//   dcgs2_update   V[k]   = sum_j C[j, 0] V[j]
//                  V[k+1] = inv_gamma w - sum_j C[j, 1] V[j]       reads V[:k+1], w;
//                                                                  writes V[k], V[k+1]
//
// with u_k = V[k] (slot k holds the uncorrected direction) and C and
// inv_gamma where dcgs2_step wrote them.  They replace no Pallas kernel: the
// JAX package writes both as broadcast-multiply-reduce forms
// (lightkrylov_tpu/vectors.py innerprod_vpu, linear_combination_vpu) and
// leaves it to XLA to fuse each into one pass over the basis; the port had
// made them a cuBLAS GEMM and a CUTLASS GEMM (with a stack before and an
// axpby and two column copies after) that read the basis at a quarter to a
// third of the card's bandwidth.
//
// Bound: device-memory bytes.  A step's measurement reads the k+1 filled
// columns and w once (k+2 passes of n elements) and its update reads the
// same and writes two columns (k+4 passes): over GMRES(30)'s steps 495 and
// 555 passes, against one or two flops an element read.  Both kernels are
// persistent grid-stride loops over 16-byte loads (float4, double2), the
// grid the card's resident blocks; a column that is not 16-byte aligned (n
// not a multiple of the width, or an unaligned V or w) takes the scalar
// instance.  dcgs2_measure keeps a thread's sums for a tile of TILE = 8
// columns in registers, 17 of them: tiles of 4, 16 and 32 columns ran
// slower at every k on the card (a 32-column tile's 100 registers halve the
// resident blocks, and with them the loads in flight), so the grid's first
// dimension covers the k+1 columns in tiles of 8, each of which reads u_k
// and w again; the blocks of one stretch of elements are neighbours,
// resident together, so that those re-reads meet in L2.  Each thread's ten
// independent loads a step of its loop keep ~160 KB of loads in flight an
// SM.  Its sums are
// deterministic, with no floating-point atomics: each thread's in
// grid-stride order, each block's by a fixed shuffle tree and then the
// warps in order, one partial a block and value; the block that takes the
// last ticket of an integer counter sums the partials in block order (a
// warp a value) and resets the counter.  dcgs2_update holds C (k+1, 2) and
// inv_gamma in shared memory and sums each element's k+1 products in column
// order; it writes V[k] in place, which is safe because each element of it
// is read, by the thread that writes it, before it is written.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (lightkrylov_tpu_torch/ops/_build.py).  The C entries
// launch on the given stream and return cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

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

// -- the two passes over the basis -------------------------------------------

constexpr int BASIS_THREADS = 256;
constexpr int BASIS_WARPS = BASIS_THREADS / 32;
constexpr int TILE = 8;  // dcgs2_measure's columns a block (ops/gmres.py has the same)

// N elements moved as one load or store: 16 bytes for N = 16 / sizeof(T).
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

template <typename T, int N>
__global__ void __launch_bounds__(BASIS_THREADS)
dcgs2_measure_kernel(const T* __restrict__ V, long long n, int k, const T* __restrict__ w,
                     T* __restrict__ out, T* __restrict__ partials,
                     unsigned int* __restrict__ ticket) {
  using Vv = Vec<T, N>;
  constexpr int NV = 2 * TILE + 1;  // a tile's values: Q^H u_k, Q^H w, w . w
  __shared__ T warp_sums[BASIS_WARPS][NV];
  __shared__ bool last;
  // the tiles of one stretch of elements are neighbouring blocks, resident
  // together, so that their reads of u_k and w after the first meet in L2
  const int tile = blockIdx.x, j0 = tile * TILE, nb = gridDim.y;
  const int ncols = min(TILE, k + 1 - j0);
  const bool first = tile == 0;
  const long long ld = n / N;  // a row in vectors
  const long long stride = static_cast<long long>(nb) * BASIS_THREADS;
  const long long gid = static_cast<long long>(blockIdx.y) * BASIS_THREADS + threadIdx.x;
  const Vv* rows = reinterpret_cast<const Vv*>(V);
  const Vv* wv = reinterpret_cast<const Vv*>(w);
  T az[TILE], ap[TILE], aw = T(0);
#pragma unroll
  for (int j = 0; j < TILE; ++j) az[j] = ap[j] = T(0);
  for (long long i = gid; i < ld; i += stride) {
    const Vv u = rows[k * ld + i];
    const Vv x = wv[i];
    if (first) {
#pragma unroll
      for (int c = 0; c < N; ++c) aw = fma(x.v[c], x.v[c], aw);
    }
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      if (j < ncols) {
        const Vv q = j0 + j == k ? u : rows[(j0 + j) * ld + i];
#pragma unroll
        for (int c = 0; c < N; ++c) {
          az[j] = fma(q.v[c], u.v[c], az[j]);
          ap[j] = fma(q.v[c], x.v[c], ap[j]);
        }
      }
    }
  }

  // the block's sums: a shuffle tree in each warp, then the warps in order
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < TILE; ++j) {
    const T z = warp_sum(az[j]), p = warp_sum(ap[j]);
    if (lane == 0) {
      warp_sums[warp][j] = z;
      warp_sums[warp][TILE + j] = p;
    }
  }
  aw = warp_sum(aw);
  if (lane == 0) warp_sums[warp][2 * TILE] = aw;
  __syncthreads();
  // partials: value v of tile t from block b at (t NV + v) nb + b
  T* part = partials + static_cast<long long>(tile) * NV * nb;
  for (int v = threadIdx.x; v < NV; v += BASIS_THREADS) {
    T acc = T(0);
#pragma unroll
    for (int q = 0; q < BASIS_WARPS; ++q) acc += warp_sums[q][v];
    part[static_cast<long long>(v) * nb + blockIdx.y] = acc;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last block: each value over the blocks in block order, a warp a value
  const int nvals = gridDim.x * NV;
  for (int q = warp; q < nvals; q += BASIS_WARPS) {
    const T* row = partials + static_cast<long long>(q) * nb;
    T acc = T(0);
    for (int b = lane; b < nb; b += 32) acc += __ldcg(row + b);
    acc = warp_sum(acc);
    if (lane == 0) {
      const int t = q / NV, v = q % NV;
      const int j = t * TILE + (v < TILE ? v : v - TILE);
      if (v == 2 * TILE) {
        if (t == 0) out[2 * (k + 1)] = acc;
      } else if (j <= k) {
        out[2 * j + (v < TILE ? 0 : 1)] = acc;
      }
    }
  }
  if (threadIdx.x == 0) *ticket = 0;
}

template <typename T, int N>
__global__ void __launch_bounds__(BASIS_THREADS)
dcgs2_update_kernel(T* __restrict__ V, long long n, int k, const T* __restrict__ w,
                    const T* __restrict__ coeff, const T* __restrict__ inv_gamma) {
  using Vv = Vec<T, N>;
  __shared__ T c0[MAX_KDIM + 1], c1[MAX_KDIM + 1];
  for (int j = threadIdx.x; j <= k; j += BASIS_THREADS) {
    c0[j] = coeff[2 * j];
    c1[j] = coeff[2 * j + 1];
  }
  __syncthreads();
  const T g = *inv_gamma;
  const long long ld = n / N;
  const long long stride = static_cast<long long>(gridDim.x) * BASIS_THREADS;
  const long long gid = static_cast<long long>(blockIdx.x) * BASIS_THREADS + threadIdx.x;
  Vv* rows = reinterpret_cast<Vv*>(V);
  const Vv* wv = reinterpret_cast<const Vv*>(w);
  for (long long i = gid; i < ld; i += stride) {
    Vv d0, d1;
#pragma unroll
    for (int c = 0; c < N; ++c) d0.v[c] = d1.v[c] = T(0);
#pragma unroll 8
    for (int j = 0; j <= k; ++j) {
      const Vv q = rows[j * ld + i];
      const T a = c0[j], b = c1[j];
#pragma unroll
      for (int c = 0; c < N; ++c) {
        d0.v[c] = fma(a, q.v[c], d0.v[c]);
        d1.v[c] = fma(b, q.v[c], d1.v[c]);
      }
    }
    const Vv x = wv[i];
    Vv next;
#pragma unroll
    for (int c = 0; c < N; ++c) next.v[c] = fma(g, x.v[c], -d1.v[c]);
    rows[k * ld + i] = d0;  // read above by this thread, at j = k
    rows[(k + 1) * ld + i] = next;
  }
}

template <typename T>
constexpr int width() {
  return 16 / static_cast<int>(sizeof(T));
}

// Whether V's rows and w take 16-byte loads.
template <typename T>
bool vector_path(const void* V, const void* w, long long n) {
  const auto a = reinterpret_cast<std::uintptr_t>(V) | reinterpret_cast<std::uintptr_t>(w);
  return (a & 15) == 0 && n % width<T>() == 0;
}

// Blocks of a launch: enough for every load of a row once, at most max_blocks.
int basis_blocks(long long n, int vec, int max_blocks) {
  const long long want = (n / vec + BASIS_THREADS - 1) / BASIS_THREADS;
  return static_cast<int>(want < 1 ? 1 : (want < max_blocks ? want : max_blocks));
}

// The grid: a block a tile (x) times the stretches of elements (y), at most
// max_blocks in all; the partials hold (2 TILE + 1) max_blocks values.
template <typename T, int N>
void measure_launch(const T* V, long long n, int k, const T* w, T* out, T* partials,
                    unsigned int* ticket, int max_blocks, cudaStream_t st) {
  const int tiles = (k + TILE) / TILE;
  const int per_tile = max_blocks / tiles;
  const dim3 grid(tiles, basis_blocks(n, N, per_tile < 1 ? 1 : per_tile));
  dcgs2_measure_kernel<T, N><<<grid, BASIS_THREADS, 0, st>>>(V, n, k, w, out, partials, ticket);
}

template <typename T>
int measure(const void* V, long long n, int rows, int k, const void* w, void* out,
            void* partials, void* ticket, int max_blocks, void* stream) {
  if (n < 1 || rows < 1 || rows > MAX_KDIM + 1 || k < 0 || k >= rows || max_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* Vp = static_cast<const T*>(V);
  const auto* wp = static_cast<const T*>(w);
  auto* op = static_cast<T*>(out);
  auto* pp = static_cast<T*>(partials);
  auto* tp = static_cast<unsigned int*>(ticket);
  if (vector_path<T>(V, w, n))
    measure_launch<T, width<T>()>(Vp, n, k, wp, op, pp, tp, max_blocks, st);
  else
    measure_launch<T, 1>(Vp, n, k, wp, op, pp, tp, max_blocks, st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int update(void* V, long long n, int rows, int k, const void* w, const void* coeff,
           const void* inv_gamma, int max_blocks, void* stream) {
  if (n < 1 || rows < 2 || rows > MAX_KDIM + 1 || k < 0 || k + 1 >= rows || max_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  auto* Vp = static_cast<T*>(V);
  const auto* wp = static_cast<const T*>(w);
  const auto* cp = static_cast<const T*>(coeff);
  const auto* gp = static_cast<const T*>(inv_gamma);
  constexpr int N = width<T>();
  if (vector_path<T>(V, w, n))
    dcgs2_update_kernel<T, N><<<basis_blocks(n, N, max_blocks), BASIS_THREADS, 0, st>>>(
        Vp, n, k, wp, cp, gp);
  else
    dcgs2_update_kernel<T, 1><<<basis_blocks(n, 1, max_blocks), BASIS_THREADS, 0, st>>>(
        Vp, n, k, wp, cp, gp);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks an SM of the vector instances of dcgs2_measure and
// dcgs2_update.
template <typename T>
int basis_blocks_per_sm(int* out) {
  constexpr int N = width<T>();
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, dcgs2_measure_kernel<T, N>,
                                                                BASIS_THREADS, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 1, dcgs2_update_kernel<T, N>,
                                                      BASIS_THREADS, 0);
  return static_cast<int>(e);
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

int lk_dcgs2_measure_f32(const void* V, long long n, int rows, int k, const void* w, void* out,
                         void* partials, void* ticket, int max_blocks, void* stream) {
  return measure<float>(V, n, rows, k, w, out, partials, ticket, max_blocks, stream);
}

int lk_dcgs2_measure_f64(const void* V, long long n, int rows, int k, const void* w, void* out,
                         void* partials, void* ticket, int max_blocks, void* stream) {
  return measure<double>(V, n, rows, k, w, out, partials, ticket, max_blocks, stream);
}

int lk_dcgs2_update_f32(void* V, long long n, int rows, int k, const void* w, const void* coeff,
                        const void* inv_gamma, int max_blocks, void* stream) {
  return update<float>(V, n, rows, k, w, coeff, inv_gamma, max_blocks, stream);
}

int lk_dcgs2_update_f64(void* V, long long n, int rows, int k, const void* w, const void* coeff,
                        const void* inv_gamma, int max_blocks, void* stream) {
  return update<double>(V, n, rows, k, w, coeff, inv_gamma, max_blocks, stream);
}

int lk_dcgs2_basis_blocks_per_sm_f32(int* out) { return basis_blocks_per_sm<float>(out); }

int lk_dcgs2_basis_blocks_per_sm_f64(int* out) { return basis_blocks_per_sm<double>(out); }

}  // extern "C"
