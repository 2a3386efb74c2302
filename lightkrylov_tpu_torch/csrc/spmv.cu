// Block-ELL sparse matrix-vector product, y = A x:
//
//   y[r*bm + i] = sum_k sum_j data[r, k, i, j] * x[cols[r, k]*bn + j]
//
// data (nbr, K, bm, bn) row-major, cols (nbr, K) int32 block-column indices,
// x (nbc*bn,) zero-padded to the block grid, y (nbr*bm,).  Padding slots
// point at block-column 0 with zero values, so they read x[0:bn] and add
// nothing; a block-column that appears twice in a block-row adds twice.
//
// Replaces the Pallas TPU kernel bell_spmv (body _spmv_kernel) of
// lightkrylov_tpu/ops/pallas/spmv.py.  Its replication of x across the 8
// sublanes and its padding of nbr to a multiple of R block-rows exist for
// Mosaic's (8, 128) tiling and are not carried over.
//
// Bound: HBM bytes.  Every value of data is read once for 2 flops, and data
// is nearly all the traffic (4 B per stored entry in f32); cols, y and the
// reads of x, which L1 and L2 serve, are small beside it.  Design: one warp
// per block-row, WARPS block-rows per thread block.  Lane l owns the columns
// j = l*V + 32*V*t of every block: V-wide loads (float4 or double2, 16 bytes)
// when bn % V == 0 and both data and x are 16-byte aligned, scalar loads
// otherwise, so a warp's loads of one block row are contiguous.  Per block a
// lane loads its slice of x once and uses it for all the block's rows, whose
// partial sums stay in registers across the K loop (ROWS rows at a time; a
// taller block takes several passes over its block-row, each reading other
// rows of data).  The cross-lane reduction (warp shuffles) runs once per
// block-row and pass, after the K loop: the "reduce once" choice of the TPU
// kernel (spmv.py:121-126).  data is loaded with the streaming cache hint,
// since no value of it is read twice.
//
// Offsets into data, x and y are 64-bit: 131072 block-rows of 8 blocks of
// 8 x 128 are already 5.4e8 elements, and larger matrices pass 2^31.
//
// Any bm, bn >= 1 is taken.  The order of the sum (per lane over its columns
// and the K blocks, then across lanes) differs from the plain version's and
// the TPU kernel's, so results agree to rounding, not bit for bit.
//
// bell_spmm_kernel is the batched form, Y = A X for p vectors at once: x is
// (p, n_pad) and y (p, nbr*bm), both row-major.  It is the counterpart of
// jax.vmap over the Pallas call, which the JAX package's block Krylov methods
// make.  The warp, lane and column layout are those above; a lane loads each
// value of data once and uses it for all p vectors, whose partial sums it keeps
// in registers (P x ROWS of them), so data and cols are read once a launch
// whatever p is.  P is a template parameter from 1 to MAX_P; the C entry
// refuses any other p.
//
// Build: with stencil.cu, by lightkrylov_tpu_torch/ops/_build.py (nvcc,
// sm_90a, one shared library).  The C entries launch on the given stream
// and return cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 8;  // block-rows (one warp each) per thread block
constexpr int ROWS = 8;   // block rows whose sums a lane keeps in registers

template <typename T, int V>
struct Loads;

template <typename T>
struct Loads<T, 1> {
  static __device__ __forceinline__ void data(const T* p, T* v) { v[0] = __ldcs(p); }
  static __device__ __forceinline__ void x(const T* p, T* v) { v[0] = __ldg(p); }
};

template <>
struct Loads<float, 4> {
  static __device__ __forceinline__ void unpack(float4 t, float* v) {
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
  static __device__ __forceinline__ void data(const float* p, float* v) {
    unpack(__ldcs(reinterpret_cast<const float4*>(p)), v);
  }
  static __device__ __forceinline__ void x(const float* p, float* v) {
    unpack(__ldg(reinterpret_cast<const float4*>(p)), v);
  }
};

template <>
struct Loads<double, 2> {
  static __device__ __forceinline__ void unpack(double2 t, double* v) {
    v[0] = t.x; v[1] = t.y;
  }
  static __device__ __forceinline__ void data(const double* p, double* v) {
    unpack(__ldcs(reinterpret_cast<const double2*>(p)), v);
  }
  static __device__ __forceinline__ void x(const double* p, double* v) {
    unpack(__ldg(reinterpret_cast<const double2*>(p)), v);
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(WARPS * 32)
bell_spmv_kernel(const T* __restrict__ data, const int* __restrict__ cols,
                 const T* __restrict__ x, T* __restrict__ y, long long nbr,
                 int K, int bm, int bn) {
  const int lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (r >= nbr) return;  // the whole warp leaves together
  const long long block_elems = static_cast<long long>(bm) * bn;
  const T* row_data = data + r * K * block_elems;
  const int* row_cols = cols + r * K;

  for (int i0 = 0; i0 < bm; i0 += ROWS) {
    const int nrows = bm - i0 < ROWS ? bm - i0 : ROWS;
    T acc[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) acc[i] = T(0);

    for (int k = 0; k < K; ++k) {
      const T* blk = row_data + k * block_elems + static_cast<long long>(i0) * bn;
      const T* xs = x + static_cast<long long>(row_cols[k]) * bn;
      for (int j = lane * V; j < bn; j += 32 * V) {
        T xv[V];
        Loads<T, V>::x(xs + j, xv);
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          if (i < nrows) {
            T dv[V];
            Loads<T, V>::data(blk + static_cast<long long>(i) * bn + j, dv);
#pragma unroll
            for (int v = 0; v < V; ++v) acc[i] += dv[v] * xv[v];
          }
        }
      }
    }

    // butterfly: every lane ends with each row's total
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
    }
    T out = T(0);
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
      if (lane == i) out = acc[i];
    if (lane < nrows) y[r * bm + i0 + lane] = out;
  }
}

template <typename T, int V, int P>
__global__ void __launch_bounds__(WARPS * 32)
bell_spmm_kernel(const T* __restrict__ data, const int* __restrict__ cols,
                 const T* __restrict__ x, T* __restrict__ y, long long n_pad,
                 long long nbr, int K, int bm, int bn) {
  const int lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (r >= nbr) return;  // the whole warp leaves together
  const long long block_elems = static_cast<long long>(bm) * bn;
  const long long m = nbr * bm;
  const T* row_data = data + r * K * block_elems;
  const int* row_cols = cols + r * K;

  for (int i0 = 0; i0 < bm; i0 += ROWS) {
    const int nrows = bm - i0 < ROWS ? bm - i0 : ROWS;
    T acc[P][ROWS];
#pragma unroll
    for (int c = 0; c < P; ++c)
#pragma unroll
      for (int i = 0; i < ROWS; ++i) acc[c][i] = T(0);

    for (int k = 0; k < K; ++k) {
      const T* blk = row_data + k * block_elems + static_cast<long long>(i0) * bn;
      const T* xs = x + static_cast<long long>(row_cols[k]) * bn;
      for (int j = lane * V; j < bn; j += 32 * V) {
        T xv[P][V];
#pragma unroll
        for (int c = 0; c < P; ++c) Loads<T, V>::x(xs + c * n_pad + j, xv[c]);
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          if (i < nrows) {
            T dv[V];
            Loads<T, V>::data(blk + static_cast<long long>(i) * bn + j, dv);
#pragma unroll
            for (int c = 0; c < P; ++c)
#pragma unroll
              for (int v = 0; v < V; ++v) acc[c][i] += dv[v] * xv[c][v];
          }
        }
      }
    }

#pragma unroll
    for (int c = 0; c < P; ++c) {
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[c][i] += __shfl_xor_sync(0xffffffffu, acc[c][i], off);
      }
      T out = T(0);
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        if (lane == i) out = acc[c][i];
      if (lane < nrows) y[c * m + r * bm + i0 + lane] = out;
    }
  }
}

template <typename T, int P>
void launch_spmm(bool wide, dim3 grid, cudaStream_t s, const T* d, const int* c,
                 const T* xp, T* yp, long long n_pad, long long nbr, int K, int bm,
                 int bn) {
  constexpr int VW = 16 / sizeof(T);
  if (wide)
    bell_spmm_kernel<T, VW, P><<<grid, WARPS * 32, 0, s>>>(d, c, xp, yp, n_pad, nbr, K, bm, bn);
  else
    bell_spmm_kernel<T, 1, P><<<grid, WARPS * 32, 0, s>>>(d, c, xp, yp, n_pad, nbr, K, bm, bn);
}

constexpr int MAX_P = 8;

template <typename T>
int launch_batched(const void* data, const void* cols, const void* x, void* y, int p,
                   long long n_pad, long long nbr, int K, int bm, int bn, void* stream) {
  if (p < 1 || p > MAX_P) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int VW = 16 / sizeof(T);
  // every row of x starts 16-byte aligned when n_pad is a multiple of VW
  const bool wide = reinterpret_cast<std::uintptr_t>(data) % 16 == 0 &&
                    reinterpret_cast<std::uintptr_t>(x) % 16 == 0 && bn % VW == 0 &&
                    n_pad % VW == 0;
  const dim3 grid(static_cast<unsigned>((nbr + WARPS - 1) / WARPS));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const T*>(data);
  const auto* c = static_cast<const int*>(cols);
  const auto* xp = static_cast<const T*>(x);
  auto* yp = static_cast<T*>(y);
  switch (p) {
    case 1: launch_spmm<T, 1>(wide, grid, s, d, c, xp, yp, n_pad, nbr, K, bm, bn); break;
    case 2: launch_spmm<T, 2>(wide, grid, s, d, c, xp, yp, n_pad, nbr, K, bm, bn); break;
    case 3: launch_spmm<T, 3>(wide, grid, s, d, c, xp, yp, n_pad, nbr, K, bm, bn); break;
    case 4: launch_spmm<T, 4>(wide, grid, s, d, c, xp, yp, n_pad, nbr, K, bm, bn); break;
    case 5: launch_spmm<T, 5>(wide, grid, s, d, c, xp, yp, n_pad, nbr, K, bm, bn); break;
    case 6: launch_spmm<T, 6>(wide, grid, s, d, c, xp, yp, n_pad, nbr, K, bm, bn); break;
    case 7: launch_spmm<T, 7>(wide, grid, s, d, c, xp, yp, n_pad, nbr, K, bm, bn); break;
    default: launch_spmm<T, 8>(wide, grid, s, d, c, xp, yp, n_pad, nbr, K, bm, bn); break;
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* data, const void* cols, const void* x, void* y,
           long long nbr, int K, int bm, int bn, void* stream) {
  constexpr int VW = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<std::uintptr_t>(data) % 16 == 0 &&
                       reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
  const dim3 grid(static_cast<unsigned>((nbr + WARPS - 1) / WARPS));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const T*>(data);
  const auto* c = static_cast<const int*>(cols);
  const auto* xp = static_cast<const T*>(x);
  auto* yp = static_cast<T*>(y);
  if (aligned && bn % VW == 0)
    bell_spmv_kernel<T, VW><<<grid, WARPS * 32, 0, s>>>(d, c, xp, yp, nbr, K, bm, bn);
  else
    bell_spmv_kernel<T, 1><<<grid, WARPS * 32, 0, s>>>(d, c, xp, yp, nbr, K, bm, bn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int lk_bell_spmv_f32(const void* data, const void* cols, const void* x, void* y,
                     long long nbr, int K, int bm, int bn, void* stream) {
  return launch<float>(data, cols, x, y, nbr, K, bm, bn, stream);
}

int lk_bell_spmv_f64(const void* data, const void* cols, const void* x, void* y,
                     long long nbr, int K, int bm, int bn, void* stream) {
  return launch<double>(data, cols, x, y, nbr, K, bm, bn, stream);
}

int lk_bell_spmm_f32(const void* data, const void* cols, const void* x, void* y, int p,
                     long long n_pad, long long nbr, int K, int bm, int bn, void* stream) {
  return launch_batched<float>(data, cols, x, y, p, n_pad, nbr, K, bm, bn, stream);
}

int lk_bell_spmm_f64(const void* data, const void* cols, const void* x, void* y, int p,
                     long long n_pad, long long nbr, int K, int bm, int bn, void* stream) {
  return launch_batched<double>(data, cols, x, y, p, n_pad, nbr, K, bm, bn, stream);
}

}  // extern "C"
