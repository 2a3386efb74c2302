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
// The row design, bell_rows_kernel, takes every layout of single-column
// blocks (bn == 1; ELLPACK at bm == bn == 1), which bell_from_scipy
// (ops/spmv.py) builds on a card when it stores fewer bytes than 8 x 128
// blocks, as a matrix of a few nonzeros a row does (a 5-point stencil: K = 5
// values and column indices a row, 12 B each in f64, against 8 x 128 blocks
// 99% zeros).  It stands beside the same TPU kernel, spmv.py:138, whose
// (8, 128) blocks are Mosaic's tiling and nothing a warp needs.  Bound: HBM
// bytes, data and cols read once (x and y once each besides).  The
// warp-per-block-row kernel would run one lane of 32 at bn = 1; here a thread
// owns an output row.  A warp's tile is ROW_TILE output rows (64: two a lane
// at bm = 1), whose data (R K bm values) and cols (R K indices) are each one
// contiguous range: it copies both to shared memory with 16-byte cp.async
// copies (L2 only; element copies for a misaligned head and the tail), so its
// reads are coalesced whatever K is, then each lane sums its rows' K products
// in registers, gathering x through the read-only path (__ldg), where a
// stencil's neighbouring columns meet in L1 and L2; the copies are marked
// first to leave L2, so that x stays there.  The grid is persistent and each
// warp double-buffers: the copies of its next tile are in flight while it
// sums the present one.  (On an H100 80GB HBM3 at 700 W, 3162^2
// convection-diffusion in f64, K = 5: 85% of the byte bound so; 67% with one
// 32-row tile a warp, copied by plain loads, and no copy in flight.)  No
// barrier but __syncwarp: warps stage and sum independently.  A tile is halved while a block's buffers pass
// 48 KB, down to one block-row; past that (K above ~500 in f64 at bm = 1) the
// same loop reads data and cols from global memory.  The sum runs over k in
// order, one FMA a slot; bell_spmm's P vectors keep P sums a lane.
//
// Build: with stencil.cu, by lightkrylov_tpu_torch/ops/_build.py (nvcc,
// sm_90a, one shared library).  The C entries launch on the given stream
// and return cudaGetLastError(); at bn == 1 they launch the row design.

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

// ---- the row design: bn == 1 ------------------------------------------------

constexpr int ROW_WARPS = 4;               // warps a thread block
constexpr int ROW_TILE = 64;               // output rows a warp stages at once (P <= 2)
constexpr int ROW_SMEM_BYTES = 48 * 1024;  // a block's two buffers a warp, at most

// One buffer of a warp: R K bm values, then R K indices, each with room for
// the source's offset from 16-byte alignment, each 16-byte aligned.
struct RowTile {
  long long data_bytes, bytes;
  __host__ __device__ RowTile(int R, int K, int bm, int elem) {
    const long long vals = static_cast<long long>(R) * K * bm;
    data_bytes = (vals * elem + 16 + 15) / 16 * 16;
    bytes = data_bytes + (static_cast<long long>(R) * K * 4 + 16 + 15) / 16 * 16;
  }
};

// A 16-byte copy to shared memory through L2 alone, marked first to leave L2
// (policy from evict_first_policy), so that the stream of data and cols
// does not push x out of it.
__device__ __forceinline__ void copy_async_16(void* dst, const void* src,
                                              unsigned long long policy) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "l"(policy));
}

__device__ __forceinline__ unsigned long long evict_first_policy() {
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

template <int N>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(N));
}

// Start copying src[0, len) to dst[shift, shift + len) by the lanes of one
// warp, shift being src's offset from 16-byte alignment in elements, so that
// the body's 16-byte copies land on aligned shared addresses (a misaligned
// head and the tail go element by element); returns shift.
template <typename E>
__device__ __forceinline__ int stage(const E* src, long long len, E* dst, int lane,
                                     unsigned long long policy) {
  constexpr int W = 16 / sizeof(E);
  const int shift = static_cast<int>(reinterpret_cast<std::uintptr_t>(src) % 16 / sizeof(E));
  const long long head = (W - shift) % W < len ? (W - shift) % W : len;
  if (lane < head) copy_async<sizeof(E)>(dst + shift + lane, src + lane);
  const long long nvec = (len - head) / W;
  for (long long q = lane; q < nvec; q += 32)
    copy_async_16(dst + shift + head + q * W, src + head + q * W, policy);
  const long long done = head + nvec * W;
  if (lane < len - done) copy_async<sizeof(E)>(dst + shift + done + lane, src + done + lane);
  return shift;
}

// A persistent grid: warp w takes tiles w, w + stride, ... of R block-rows
// each.  STAGED, the copies of its next tile are in flight (cp.async, one
// group a tile) while it sums the rows of the present one from shared
// memory; else it reads data and cols from global memory.
template <typename T, int P, bool STAGED>
__global__ void __launch_bounds__(ROW_WARPS * 32)
bell_rows_kernel(const T* __restrict__ data, const int* __restrict__ cols,
                 const T* __restrict__ x, T* __restrict__ y, long long n_pad,
                 long long nbr, int K, int bm, int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long tiles = (nbr + R - 1) / R;
  const long long stride = static_cast<long long>(gridDim.x) * ROW_WARPS;
  long long t = static_cast<long long>(blockIdx.x) * ROW_WARPS + warp;
  if (t >= tiles) return;  // the whole warp leaves together
  const long long seg = static_cast<long long>(K) * bm;  // values a block-row
  const long long m = nbr * bm;
  const RowTile tile(R, K, bm, sizeof(T));
  unsigned char* buf = smem + 2 * warp * tile.bytes;
  const unsigned long long policy = evict_first_policy();
  // starts the copies of tile tt into buffer b as one group; returns the
  // shifts of its data and cols there
  auto issue = [&](long long tt, int b) {
    const long long r0 = tt * R;
    const int nr = nbr - r0 < R ? static_cast<int>(nbr - r0) : R;
    unsigned char* base = buf + b * tile.bytes;
    const int2 sh = make_int2(
        stage(data + r0 * seg, nr * seg, reinterpret_cast<T*>(base), lane, policy),
        stage(cols + r0 * K, static_cast<long long>(nr) * K,
              reinterpret_cast<int*>(base + tile.data_bytes), lane, policy));
    asm volatile("cp.async.commit_group;\n" ::);
    return sh;
  };
  int2 sh = STAGED ? issue(t, 0) : make_int2(0, 0);
  for (int b = 0; t < tiles; t += stride, b ^= 1) {
    const long long r0 = t * R;
    const int nr = nbr - r0 < R ? static_cast<int>(nbr - r0) : R;
    const T* vals = data + r0 * seg;
    const int* idx = cols + r0 * K;
    int2 next = sh;
    if constexpr (STAGED) {
      if (t + stride < tiles)
        next = issue(t + stride, b ^ 1);
      else
        asm volatile("cp.async.commit_group;\n" ::);  // an empty group keeps the count
      asm volatile("cp.async.wait_group 1;\n" ::);    // all but the newest group landed
      __syncwarp();
      vals = reinterpret_cast<const T*>(buf + b * tile.bytes) + sh.x;
      idx = reinterpret_cast<const int*>(buf + b * tile.bytes + tile.data_bytes) + sh.y;
    }
    for (int o = lane; o < nr * bm; o += 32) {
      const int lr = o / bm;
      const T* rv = vals + lr * seg + (o - lr * bm);
      const int* rc = idx + static_cast<long long>(lr) * K;
      T acc[P];
#pragma unroll
      for (int c = 0; c < P; ++c) acc[c] = T(0);
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        T v;
        int col;
        if constexpr (STAGED) {
          v = rv[static_cast<long long>(k) * bm];
          col = rc[k];
        } else {
          v = __ldcs(rv + static_cast<long long>(k) * bm);
          col = __ldcs(rc + k);
        }
#pragma unroll
        for (int c = 0; c < P; ++c) acc[c] += v * __ldg(x + c * n_pad + col);
      }
#pragma unroll
      for (int c = 0; c < P; ++c) y[c * m + r0 * bm + o] = acc[c];
    }
    if constexpr (STAGED) __syncwarp();  // buffer b is refilled next
    sh = next;
  }
}

template <typename T, int P, bool STAGED>
void launch_rows_kernel(cudaStream_t s, long long tiles, int smem, const T* d, const int* c,
                        const T* xp, T* yp, long long n_pad, long long nbr, int K, int bm,
                        int R) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bell_rows_kernel<T, P, STAGED>,
                                                ROW_WARPS * 32, smem);
  const long long blocks = (tiles + ROW_WARPS - 1) / ROW_WARPS;
  const long long resident = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  const dim3 grid(static_cast<unsigned>(blocks < resident ? blocks : resident));
  bell_rows_kernel<T, P, STAGED><<<grid, ROW_WARPS * 32, smem, s>>>(d, c, xp, yp, n_pad, nbr,
                                                                    K, bm, R);
}

// Tiles of ROW_TILE output rows, half that for more than two vectors (their
// P gathers a slot, not the staged bytes, fill the time, and a smaller tile
// keeps more warps resident), one block-row when bm is taller; halved while
// a block's buffers pass ROW_SMEM_BYTES; past that at one block-row, no
// staging.
template <typename T, int P>
void launch_rows_p(cudaStream_t s, const T* d, const int* c, const T* xp, T* yp,
                   long long n_pad, long long nbr, int K, int bm) {
  constexpr int rows = P <= 2 ? ROW_TILE : ROW_TILE / 2;
  int R = bm >= rows ? 1 : rows / bm;
  auto smem = [&](int r) { return 2 * ROW_WARPS * RowTile(r, K, bm, sizeof(T)).bytes; };
  while (R > 1 && smem(R) > ROW_SMEM_BYTES) R = (R + 1) / 2;
  const long long tiles = (nbr + R - 1) / R;
  if (smem(R) <= ROW_SMEM_BYTES)
    launch_rows_kernel<T, P, true>(s, tiles, static_cast<int>(smem(R)), d, c, xp, yp, n_pad,
                                   nbr, K, bm, R);
  else
    launch_rows_kernel<T, P, false>(s, tiles, 0, d, c, xp, yp, n_pad, nbr, K, bm, R);
}

// ---- the launches: the row design at bn == 1, else a warp a block-row --------

template <typename T, int P>
void launch_spmm(bool wide, dim3 grid, cudaStream_t s, const T* d, const int* c,
                 const T* xp, T* yp, long long n_pad, long long nbr, int K, int bm,
                 int bn) {
  constexpr int VW = 16 / sizeof(T);
  if (bn == 1)
    launch_rows_p<T, P>(s, d, c, xp, yp, n_pad, nbr, K, bm);
  else if (wide)
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
  if (bn == 1)
    launch_rows_p<T, 1>(s, d, c, xp, yp, 0, nbr, K, bm);
  else if (aligned && bn % VW == 0)
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
