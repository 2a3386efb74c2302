// The conjugate gradient iteration's vector update as three kernels, with
// its scalars on the device.  After the operator has given Ap = A p:
//
//   cg_pdot  pAp = p . Ap                                   reads p, Ap
//   cg_xr    alpha = rz / pAp;  x += alpha p;  r -= alpha Ap;
//            rr = r . r;  res = sqrt(rr);  hist[k] = res;
//            flag = res >= tol;  beta = rr / rz;  rz = rr   reads x, p, r, Ap;
//                                                           writes x, r
//   cg_p     p = r + beta p                                 reads r, p; writes p
//
// with the guards of the solver's _nonzero (a zero pAp or rz divides by 1).
// The recurrences are those of the JAX package's _cg_impl
// (lightkrylov_tpu/solvers/cg.py) without a preconditioner, in the vector's
// own precision; solvers/cg.py routes an unpreconditioned solve of one real
// contiguous float32 or float64 tensor here.  It replaces no Pallas kernel:
// the JAX package leaves this fusion to XLA.
//
// The scalar block s (ops/cg.py: RZ, PAP, RR, RES, TOL, BETA, FLAG) stays on
// the device: alpha and beta are computed inside the kernels, and the host
// reads only the flag, once an iteration.
//
// Bound: device-memory bytes.  Each kernel does one or two flops an element
// read, so each is bound by its passes over the vectors: 2 (cg_pdot), 6
// (cg_xr) and 3 (cg_p) passes of n elements: 11 around the operator's 2,
// where the update as separate tensor operations made 26.  Every element
// moves as part of one 16-byte load or store (float4, double2) of a
// grid-stride loop over a grid that fills the SMs once (the occupancy
// calculator's blocks an SM times the SM count); the last n mod 4 (float32)
// or n mod 2 (float64) elements are a scalar tail, and a vector that is not
// 16-byte aligned takes the scalar loop.
//
// Why three kernels and not two: beta needs the global r . r, which exists
// only after every block has updated its share of r, so p's update needs a
// second pass over r and p after cg_xr.  Likewise alpha needs the global
// p . Ap before x and r can move, hence cg_pdot first.  Computing p . Ap
// inside the operator's kernel (the stencil writes Ap and could sum p . Ap
// as it goes) would save cg_pdot's 2 passes; that is the operator layer,
// left out here.
//
// Reductions are deterministic, with no floating-point atomics: each thread
// sums its elements in grid-stride order, each block by a fixed shuffle
// tree, one partial a block; the block that takes the last ticket of an
// integer counter sums the partials in a fixed order and resets the
// counter.  The grid is fixed for a card and a length, so two solves from
// the same data give the same bits.  s is read by every block of cg_xr at
// its start and written by the last block at its end: all others have
// taken their tickets, so have read it, by then.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (lightkrylov_tpu_torch/ops/_build.py); IEEE division and
// square root (no fast-math flags).  The C entries launch on the given
// stream and return cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// slots of the scalar block (ops/cg.py)
constexpr int RZ = 0, PAP = 1, RR = 2, RES = 3, TOL = 4, BETA = 5, FLAG = 6;

// N elements moved as one load or store: 16 bytes for N = 16 / sizeof(T).
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// The block's sum, in thread 0, by a fixed tree: shuffles in each warp,
// then warp 0 over the warps' sums.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* warp_sums) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < WARPS ? warp_sums[lane] : T(0);
#pragma unroll
    for (int o = WARPS / 2; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// The sum of every thread's v over the grid.  True in thread 0 of the block
// that finishes last, which then holds the sum in *out; false elsewhere.
template <typename T>
__device__ bool grid_sum(T v, T* partials, unsigned int* ticket, T* out) {
  __shared__ T warp_sums[WARPS];
  __shared__ bool last;
  v = block_sum(v, warp_sums);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = v;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  T acc = T(0);
  for (unsigned int i = threadIdx.x; i < gridDim.x; i += THREADS) acc += __ldcg(partials + i);
  acc = block_sum(acc, warp_sums);
  if (threadIdx.x == 0) {
    *out = acc;
    *ticket = 0;
  }
  return threadIdx.x == 0;
}

template <typename T>
__device__ __forceinline__ T nonzero(T a) {
  return a == T(0) ? T(1) : a;
}

template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
cg_pdot_kernel(const T* __restrict__ p, const T* __restrict__ ap, long long n,
               T* __restrict__ partials, unsigned int* __restrict__ ticket, T* s) {
  using V = Vec<T, N>;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const long long gid = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long nv = n / N;
  const V* pv = reinterpret_cast<const V*>(p);
  const V* av = reinterpret_cast<const V*>(ap);
  T acc = T(0);
  for (long long i = gid; i < nv; i += stride) {
    const V a = pv[i], b = av[i];
#pragma unroll
    for (int c = 0; c < N; ++c) acc = fma(a.v[c], b.v[c], acc);
  }
  for (long long i = nv * N + gid; i < n; i += stride) acc = fma(p[i], ap[i], acc);
  T pap;
  if (grid_sum(acc, partials, ticket, &pap)) s[PAP] = pap;
}

template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
cg_xr_kernel(T* __restrict__ x, T* __restrict__ r, const T* __restrict__ p,
             const T* __restrict__ ap, long long n, T* __restrict__ partials,
             unsigned int* __restrict__ ticket, T* s, T* __restrict__ hist, long long k) {
  using V = Vec<T, N>;
  const T alpha = s[RZ] / nonzero(s[PAP]);
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const long long gid = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long nv = n / N;
  V* xv = reinterpret_cast<V*>(x);
  V* rv = reinterpret_cast<V*>(r);
  const V* pv = reinterpret_cast<const V*>(p);
  const V* av = reinterpret_cast<const V*>(ap);
  T acc = T(0);
  for (long long i = gid; i < nv; i += stride) {
    V xi = xv[i], ri = rv[i];
    const V pi = pv[i], ai = av[i];
#pragma unroll
    for (int c = 0; c < N; ++c) {
      xi.v[c] = fma(alpha, pi.v[c], xi.v[c]);
      ri.v[c] = fma(-alpha, ai.v[c], ri.v[c]);
      acc = fma(ri.v[c], ri.v[c], acc);
    }
    xv[i] = xi;
    rv[i] = ri;
  }
  for (long long i = nv * N + gid; i < n; i += stride) {
    x[i] = fma(alpha, p[i], x[i]);
    const T ri = fma(-alpha, ap[i], r[i]);
    r[i] = ri;
    acc = fma(ri, ri, acc);
  }
  T rr;
  if (grid_sum(acc, partials, ticket, &rr)) {
    const T res = sqrt(rr);
    const T rz = s[RZ];
    s[RR] = rr;
    s[RES] = res;
    s[FLAG] = res >= s[TOL] ? T(1) : T(0);
    s[BETA] = rr / nonzero(rz);
    s[RZ] = rr;
    hist[k] = res;
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
cg_p_kernel(const T* __restrict__ r, T* __restrict__ p, long long n, const T* __restrict__ s) {
  using V = Vec<T, N>;
  const T beta = s[BETA];
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const long long gid = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long nv = n / N;
  const V* rv = reinterpret_cast<const V*>(r);
  V* pv = reinterpret_cast<V*>(p);
  for (long long i = gid; i < nv; i += stride) {
    const V ri = rv[i];
    V pi = pv[i];
#pragma unroll
    for (int c = 0; c < N; ++c) pi.v[c] = fma(beta, pi.v[c], ri.v[c]);
    pv[i] = pi;
  }
  for (long long i = nv * N + gid; i < n; i += stride) p[i] = fma(beta, p[i], r[i]);
}

template <typename T>
constexpr int width() {
  return 16 / static_cast<int>(sizeof(T));
}

bool aligned(const void* a) { return (reinterpret_cast<std::uintptr_t>(a) & 15) == 0; }

// Blocks of the launch: enough for every 16-byte group once, at most
// max_blocks (the card's resident blocks; the partials' length).
int blocks(long long n, int vec, int max_blocks) {
  const long long want = (n / vec + THREADS - 1) / THREADS;
  return static_cast<int>(want < 1 ? 1 : (want < max_blocks ? want : max_blocks));
}

template <typename T>
int pdot(const void* p, const void* ap, long long n, void* partials, void* ticket, void* s,
         int max_blocks, void* stream) {
  if (n < 0 || max_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* pp = static_cast<const T*>(p);
  const auto* ap_ = static_cast<const T*>(ap);
  auto* part = static_cast<T*>(partials);
  auto* tick = static_cast<unsigned int*>(ticket);
  auto* sp = static_cast<T*>(s);
  constexpr int N = width<T>();
  if (aligned(p) && aligned(ap))
    cg_pdot_kernel<T, N><<<blocks(n, N, max_blocks), THREADS, 0, st>>>(pp, ap_, n, part, tick, sp);
  else
    cg_pdot_kernel<T, 1><<<blocks(n, 1, max_blocks), THREADS, 0, st>>>(pp, ap_, n, part, tick, sp);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int xr(void* x, void* r, const void* p, const void* ap, long long n, void* partials,
       void* ticket, void* s, void* hist, long long k, int max_blocks, void* stream) {
  if (n < 0 || max_blocks < 1 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  auto* xp = static_cast<T*>(x);
  auto* rp = static_cast<T*>(r);
  const auto* pp = static_cast<const T*>(p);
  const auto* ap_ = static_cast<const T*>(ap);
  auto* part = static_cast<T*>(partials);
  auto* tick = static_cast<unsigned int*>(ticket);
  auto* sp = static_cast<T*>(s);
  auto* hp = static_cast<T*>(hist);
  constexpr int N = width<T>();
  if (aligned(x) && aligned(r) && aligned(p) && aligned(ap))
    cg_xr_kernel<T, N><<<blocks(n, N, max_blocks), THREADS, 0, st>>>(xp, rp, pp, ap_, n, part,
                                                                       tick, sp, hp, k);
  else
    cg_xr_kernel<T, 1><<<blocks(n, 1, max_blocks), THREADS, 0, st>>>(xp, rp, pp, ap_, n, part,
                                                                       tick, sp, hp, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int pupdate(const void* r, void* p, long long n, const void* s, int max_blocks, void* stream) {
  if (n < 0 || max_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* rp = static_cast<const T*>(r);
  auto* pp = static_cast<T*>(p);
  const auto* sp = static_cast<const T*>(s);
  constexpr int N = width<T>();
  if (aligned(r) && aligned(p))
    cg_p_kernel<T, N><<<blocks(n, N, max_blocks), THREADS, 0, st>>>(rp, pp, n, sp);
  else
    cg_p_kernel<T, 1><<<blocks(n, 1, max_blocks), THREADS, 0, st>>>(rp, pp, n, sp);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks an SM of the vector instances of cg_pdot, cg_xr, cg_p.
template <typename T>
int blocks_per_sm(int* out) {
  constexpr int N = width<T>();
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, cg_pdot_kernel<T, N>,
                                                                THREADS, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 1, cg_xr_kernel<T, N>, THREADS, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 2, cg_p_kernel<T, N>, THREADS, 0);
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

int lk_cg_pdot_f32(const void* p, const void* ap, long long n, void* partials, void* ticket,
                   void* s, int max_blocks, void* stream) {
  return pdot<float>(p, ap, n, partials, ticket, s, max_blocks, stream);
}

int lk_cg_pdot_f64(const void* p, const void* ap, long long n, void* partials, void* ticket,
                   void* s, int max_blocks, void* stream) {
  return pdot<double>(p, ap, n, partials, ticket, s, max_blocks, stream);
}

int lk_cg_xr_f32(void* x, void* r, const void* p, const void* ap, long long n, void* partials,
                 void* ticket, void* s, void* hist, long long k, int max_blocks, void* stream) {
  return xr<float>(x, r, p, ap, n, partials, ticket, s, hist, k, max_blocks, stream);
}

int lk_cg_xr_f64(void* x, void* r, const void* p, const void* ap, long long n, void* partials,
                 void* ticket, void* s, void* hist, long long k, int max_blocks, void* stream) {
  return xr<double>(x, r, p, ap, n, partials, ticket, s, hist, k, max_blocks, stream);
}

int lk_cg_p_f32(const void* r, void* p, long long n, const void* s, int max_blocks,
                void* stream) {
  return pupdate<float>(r, p, n, s, max_blocks, stream);
}

int lk_cg_p_f64(const void* r, void* p, long long n, const void* s, int max_blocks,
                void* stream) {
  return pupdate<double>(r, p, n, s, max_blocks, stream);
}

int lk_cg_blocks_per_sm_f32(int* out) { return blocks_per_sm<float>(out); }

int lk_cg_blocks_per_sm_f64(int* out) { return blocks_per_sm<double>(out); }

}  // extern "C"
