// 5-point negative Laplacian, y = A u, on an (ny, nx) grid with zero
// Dirichlet values outside it:
//
//   y[i,j] = c0*u[i,j] - cx*(u[i,j-1] + u[i,j+1]) - cy*(u[i-1,j] + u[i+1,j])
//
// with c0 = 2*(1/hx^2 + 1/hy^2), cx = 1/hx^2, cy = 1/hy^2.
//
// Replaces the Pallas TPU kernels of lightkrylov_tpu/ops/pallas/stencil.py:
// stencil_matvec (body _kernel) and stencil_matvec_2d (body _kernel2d).  Both
// compute this function; their 8-row / 128-lane halo bands and manual DMA
// double-buffering exist for the TPU's (8, 128) tiling and are not carried
// over.
//
// Bound: HBM bytes.  Each point is read once and written once, 8 bytes per
// point in f32 (16 in f64), against 6 flops per point.  The design keeps
// every point of u at about one HBM read with no shared memory: a thread
// owns one column j and a segment of SEG rows, and walks down it keeping
// the rows above, at and below in registers, so each u[i,j] is loaded once
// by its own thread.  The x-neighbours u[i,j-1], u[i,j+1] are the values the
// neighbouring threads of the warp load in the same step, served from L1.
// Loads and stores of a warp are coalesced along x.  A segment re-reads one
// row above and below it (2/SEG extra, mostly from L2).  Neighbours outside
// the grid read as zero, so any ny, nx works without padding; the ragged
// edge is masked here.  (A 32x32 shared-memory tile with its halo, the first
// design, ran at 0.6x the speed of this one on an H100: PERF.md.)
//
// Coefficients arrive as doubles computed on the host and are cast to T, and
// the expression is evaluated in the order above, which is the order of the
// Pallas body (stencil.py:158-162).  The compiler may contract it into FMAs.
//
// The batched entries apply the operator to a contiguous (p, ny, nx) stack of
// fields, one launch for all p (at most 65535 row segments of SEG rows in
// all): each block finds its field from blockIdx.y and offsets the pointers
// by field*ny*nx (64-bit); each field keeps its own boundary, so the row
// tests read no row of a neighbouring field.  This is the
// counterpart of jax.vmap over the Pallas call, which the JAX package's block
// Krylov methods make (a batch grid axis).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (lightkrylov_tpu_torch/ops/_build.py).  The C entries
// launch on the given stream and return cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // columns per block
constexpr int SEG = 16;       // rows per thread

// One thread's column segment: rows i0 .. i0+SEG-1 of column j of one field.
template <typename T>
__device__ __forceinline__ void column(const T* __restrict__ u, T* __restrict__ y, int ny,
                                       int nx, T c0, T cx, T cy, long long j, long long i0) {
  const long long i1 = i0 + SEG < ny ? i0 + SEG : ny;
  const bool has_left = j > 0;
  const bool has_right = j < nx - 1;

  T down = i0 > 0 ? u[(i0 - 1) * nx + j] : T(0);
  T centre = u[i0 * nx + j];
#pragma unroll 8
  for (long long i = i0; i < i1; ++i) {
    const long long idx = i * nx + j;
    const T up = i + 1 < ny ? u[idx + nx] : T(0);
    const T left = has_left ? u[idx - 1] : T(0);
    const T right = has_right ? u[idx + 1] : T(0);
    y[idx] = c0 * centre - cx * (left + right) - cy * (down + up);
    down = centre;
    centre = up;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
stencil_kernel(const T* __restrict__ u, T* __restrict__ y, int ny, int nx,
               T c0, T cx, T cy) {
  const long long j = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (j >= nx) return;
  column<T>(u, y, ny, nx, c0, cx, cy, j, static_cast<long long>(blockIdx.y) * SEG);
}

// The batched grid folds the field into blockIdx.y: row segment
// blockIdx.y % nyb of field blockIdx.y / nyb.  (A first form that put the
// field on blockIdx.z was slower per field than single launches on an
// H100: PERF.md.)
template <typename T>
__global__ void __launch_bounds__(THREADS)
stencil_batched_kernel(const T* __restrict__ u, T* __restrict__ y, int nyb, int ny, int nx,
                       T c0, T cx, T cy) {
  const long long j = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (j >= nx) return;
  const int z = blockIdx.y / nyb;
  const long long field = static_cast<long long>(ny) * nx * z;
  column<T>(u + field, y + field, ny, nx, c0, cx, cy, j,
            static_cast<long long>(blockIdx.y - z * nyb) * SEG);
}

template <typename T>
int launch(const void* u, void* y, int p, int ny, int nx, double c0, double cx,
           double cy, void* stream) {
  const int nyb = (ny + SEG - 1) / SEG;
  if (p < 1 || static_cast<long long>(nyb) * p > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* up = static_cast<const T*>(u);
  auto* yp = static_cast<T*>(y);
  const T tc0 = static_cast<T>(c0), tcx = static_cast<T>(cx), tcy = static_cast<T>(cy);
  const dim3 grid((nx + THREADS - 1) / THREADS, nyb * p);
  if (p == 1)
    stencil_kernel<T><<<grid, THREADS, 0, s>>>(up, yp, ny, nx, tc0, tcx, tcy);
  else
    stencil_batched_kernel<T><<<grid, THREADS, 0, s>>>(up, yp, nyb, ny, nx, tc0, tcx, tcy);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int lk_stencil_f32(const void* u, void* y, int ny, int nx, double c0,
                   double cx, double cy, void* stream) {
  return launch<float>(u, y, 1, ny, nx, c0, cx, cy, stream);
}

int lk_stencil_f64(const void* u, void* y, int ny, int nx, double c0,
                   double cx, double cy, void* stream) {
  return launch<double>(u, y, 1, ny, nx, c0, cx, cy, stream);
}

int lk_stencil_batched_f32(const void* u, void* y, int p, int ny, int nx,
                           double c0, double cx, double cy, void* stream) {
  return launch<float>(u, y, p, ny, nx, c0, cx, cy, stream);
}

int lk_stencil_batched_f64(const void* u, void* y, int p, int ny, int nx,
                           double c0, double cx, double cy, void* stream) {
  return launch<double>(u, y, p, ny, nx, c0, cx, cy, stream);
}

const char* lk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
