// Bandwidth probes: three float32 kernels that replace the Pallas bodies of
// the TPU bandwidth probes in benchmarks/ (P1-P7 in PERF.md's kernel table).
// Each computes what its TPU kernels compute; none is carried over block by
// block.  All three are bound by device-memory bytes over the card's rate
// (3.35 TB/s on an H100 SXM) and do no arithmetic worth counting.
//
// copy_tiles (P1 roofline_probe.py:72-80, P3 manual_out_probe.py:59-67,
// P6 stencil_sweep.py:61-74, P7 copy_shape_probe.py:47-69): y = x for an
// (ny, nx) array cut into TPU blocks (by, bx), with 16-byte register loads
// and plain stores (the TPU's "managed" copy).  The TPU's blocks are 2-16 MB,
// so one CTA a block would leave most of the 132 SMs idle (16-128 blocks on
// an 8192^2 array).  The design splits each block over many CTAs: a CTA
// copies one unit of unit_rows x unit_cols of a block, at most 16 KB (4
// float4 a thread, all four loads before the stores), and the grid has one
// CTA a unit, numbered block by block in the TPU grid's order (block row i,
// then block column j), so the block shape sets which sub-tile a CTA copies
// and the order in which the card is handed the array.  Every TPU case gives
// full 16 KB units, so the grid is the array's size over 16 KB whatever the
// block, and a shape effect is not an occupancy effect.  (On an H100 none of
// these read faster: four CTAs an SM looping over 64 KB units, two or four
// units a CTA, streaming load and store hints, an L2 evict_first policy; a
// 32-register cap, for eight CTAs an SM, spilled and ran slower, so no
// launch bound caps the registers.  PERF.md has every variant's time.)
//
// copy_ring (P4 manual_out_probe.py:112-126 at depth 2, P5
// deep_buffer_probe.py:86-102 at depth d): y = x through a ring of `depth`
// shared-memory stages of `stage` bytes, both directions asynchronous (the
// TPU's "manual" copy).  The array is cut into chunks of one stage (the
// last may be short), and CTA b of G copies chunks b, b+G, ..., so that the
// CTAs' counts differ by at most one and the card reads and writes one
// window of the array at a time (contiguous ranges, one a CTA, ran 1.5%
// slower on an H100: PERF.md).  Two threads of a CTA drive its ring,
// decoupled by two rings of mbarriers:
//   - the producer (lane 0 of warp 0) waits for empty[s], then starts the
//     1-D TMA bulk copy of the next chunk into stage s, which completes
//     full[s] with its byte count (the manual in-DMA);
//   - the store thread (lane 0 of warp 1) waits for full[s], sends the stage
//     out with a bulk shared->global store (the manual out-DMA), and once
//     the store is done reading the stage (cp.async.bulk.wait_group.read),
//     arrives on empty[s].
// That arrival is the TPU's reuse guard out_copy(i - depth).wait(): a stage
// is loaded again only after the store that read it is done reading.  A
// freed stage is refilled at once, so a ring of depth d keeps up to d loads
// in flight; the last store is waited for in full before the CTA exits (the
// TPU's drain).  The grid is rings_per_sm x SMs CTAs: as many depth x stage
// rings as an SM holds at once, by the card's own occupancy calculator
// (lk_copy_ring_ctas_per_sm, which ops/probes.py caps at 8), so that one
// ring's prime and drain overlap another's steady state and small TPU
// stages still fill the card with bytes in flight.  The TPU's stages (2-8 MB
// of VMEM) do not fit in shared memory; the probes map them to a few tens of
// KB.  Loads and stores carry an L2 evict_first policy (x is read once, y
// not read back).  The entry refuses a grid that the SMs cannot hold at once
// (it would run in waves), and sets the kernel's shared-memory attributes
// once a device, not per launch.  What bounds it on an H100:
// not the bytes in flight (1 to 8 rings an SM, 24-192 KB, read alike), but
// the bulk stores, which write 268 MB about 5% slower than a plain-store
// fill, and the mix of bulk loads and stores, which costs more over the sum
// of the two halves than copy_'s mix does (PERF.md).
//
// reduce_8x128 (P2 roofline_probe.py:116-126): s[r, c] = sum of x[i, j]
// over i = r mod 8, j = c mod 128.  The TPU grid carries the (8, 128)
// accumulator from step to step; CTAs run in no order, so here pass 1 gives
// each of G CTAs a fixed set of (8, 128) tiles (b, b+G, ...) and writes its
// (8, 128) partial to scratch, and pass 2 adds the G partials of each entry
// in a fixed order.  No atomics: runs repeat bit for bit on a card with the
// same G.  In pass 1 warp r reads row r of a tile, 32 lanes x 16 bytes, and
// each lane keeps a float4 of sums.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (lightkrylov_tpu_torch/ops/_build.py).  The C entries
// launch on the given stream and return cudaGetLastError(), or an error
// code for arguments they do not take.

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

constexpr int COPY_THREADS = 256;
constexpr int COPY_VEC = 4;  // float4s a thread: a unit is at most 16 KB
constexpr int RING_THREADS = 64;  // warp 0 loads, warp 1 stores
constexpr int RING_MAX_DEPTH = 8;
// dynamic shared memory a ring may take: 227 KB a CTA, less 1 KB
constexpr int RING_SMEM_MAX = 227 * 1024 - 1024;
constexpr int RED_THREADS = 256;  // (8 rows) x (32 float4) of one tile
constexpr int RED_ENTRIES = 8 * 128;

__global__ void __launch_bounds__(COPY_THREADS)
copy_tiles_kernel(const float4* __restrict__ x, float4* __restrict__ y, long long nx4, int by,
                  int bx4, int unit_rows, int unit_cols4, long long gx) {
  const int units_across = bx4 / unit_cols4;
  const int units_per_block = (by / unit_rows) * units_across;
  const long long b = blockIdx.x / units_per_block;  // the TPU block, in grid order
  const int s = static_cast<int>(blockIdx.x - b * units_per_block);
  const int sr = s / units_across, sc = s - sr * units_across;
  const long long bi = b / gx, bj = b - bi * gx;
  const long long at0 = (bi * by + static_cast<long long>(sr) * unit_rows) * nx4 + bj * bx4 +
                        static_cast<long long>(sc) * unit_cols4;
  const float4* xs = x + at0;
  float4* ys = y + at0;
  const unsigned n = static_cast<unsigned>(unit_rows) * unit_cols4;
  float4 v[COPY_VEC];
  long long at[COPY_VEC];
#pragma unroll
  for (int k = 0; k < COPY_VEC; ++k) {
    const unsigned e = threadIdx.x + k * COPY_THREADS;
    if (e < n) {
      const unsigned r = e / unit_cols4;
      at[k] = static_cast<long long>(r) * nx4 + (e - r * unit_cols4);
      v[k] = xs[at[k]];
    }
  }
#pragma unroll
  for (int k = 0; k < COPY_VEC; ++k)
    if (threadIdx.x + k * COPY_THREADS < n) ys[at[k]] = v[k];
}

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(const uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem(bar)) : "memory");
}

__global__ void __launch_bounds__(RING_THREADS)
copy_ring_kernel(const char* __restrict__ x, char* __restrict__ y, long long nbytes, int stage,
                 int depth, long long n_chunks) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[RING_MAX_DEPTH], empty[RING_MAX_DEPTH];
  // chunks b, b + G, ...
  const long long first = blockIdx.x, step = gridDim.x;
  const long long mine = (n_chunks - first + step - 1) / step;
  if (threadIdx.x == 0) {
    for (int s = 0; s < depth; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem(&full[s])) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem(&empty[s])) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x % 32) return;
  // x is read once and y not read back: both go first out of L2
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));

  int s = 0;
  unsigned parity = 0;  // flips each time s wraps: the round's parity
  if (threadIdx.x == 0) {
    // the producer: refill stage s once its last store has read it
    for (long long k = 0; k < mine; ++k) {
      if (k >= depth) mbar_wait(&empty[s], parity ^ 1);
      const long long off = (first + k * step) * stage;
      const unsigned bytes = static_cast<unsigned>(nbytes - off < stage ? nbytes - off : stage);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(smem(&full[s])), "r"(bytes) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
          " [%0], [%1], %2, [%3], %4;"
          ::"r"(smem(ring + static_cast<long long>(s) * stage)), "l"(x + off), "r"(bytes),
            "r"(smem(&full[s])), "l"(policy)
          : "memory");
      if (++s == depth) s = 0, parity ^= 1;
    }
    return;
  }
  // the store thread
  for (long long k = 0; k < mine; ++k) {
    mbar_wait(&full[s], parity);
    // the stage was written by the async proxy; order it before the store reads it
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    const long long off = (first + k * step) * stage;
    const unsigned bytes = static_cast<unsigned>(nbytes - off < stage ? nbytes - off : stage);
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;"
                 ::"l"(y + off), "r"(smem(ring + static_cast<long long>(s) * stage)),
                   "r"(bytes), "l"(policy)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    // the reuse guard: free the stage once its store is done reading it
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    mbar_arrive(&empty[s]);
    if (++s == depth) s = 0, parity ^= 1;
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__global__ void __launch_bounds__(RED_THREADS)
reduce_partials_kernel(const float4* __restrict__ x, float4* __restrict__ partial, long long nx4,
                       long long ntj, long long n_tiles) {
  const int r = threadIdx.x >> 5, c = threadIdx.x & 31;
  // tile t = (ti, tj) steps by the grid size G = q * ntj + rem: no division in the loop
  const long long q = gridDim.x / ntj, rem = gridDim.x - q * ntj;
  long long t = blockIdx.x, ti = t / ntj, tj = t - ti * ntj;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (; t < n_tiles; t += gridDim.x) {
    const float4 v = x[(ti * 8 + r) * nx4 + tj * 32 + c];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
    ti += q;
    tj += rem;
    if (tj >= ntj) {
      tj -= ntj;
      ++ti;
    }
  }
  partial[static_cast<long long>(blockIdx.x) * RED_THREADS + threadIdx.x] = acc;
}

// Pass 2 on a (8, 4) grid: block (r, quarter) sums entries r * 128 + quarter * 32 + c.
// Thread (c, k) adds partials k, k + 32, ... in order, then thread (c, 0) adds
// the 32 slices in order: a fixed order, spread over 32 SMs (one CTA reading
// every partial, the first form, was slow on an H100: it alone streams the
// partials through one SM).
__global__ void __launch_bounds__(1024)
reduce_final_kernel(const float* __restrict__ partial, float* __restrict__ out, int grid) {
  __shared__ float slice[32][33];
  const int c = threadIdx.x & 31, k = threadIdx.x >> 5;
  const int e = blockIdx.x * 128 + blockIdx.y * 32 + c;
  float s = 0.f;
#pragma unroll 4
  for (int g = k; g < grid; g += 32) s += partial[static_cast<long long>(g) * RED_ENTRIES + e];
  slice[k][c] = s;
  __syncthreads();
  if (k == 0) {
    float t = 0.f;
    for (int j = 0; j < 32; ++j) t += slice[j][c];
    out[e] = t;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// What one device allows copy_ring: its SM count and, for each dynamic
// shared-memory size asked for so far, how many ring CTAs an SM holds.
struct RingFit {
  int device, smem, ctas_per_sm, sms;
};
constexpr int RING_FITS = 64;
constexpr int MAX_DEVICES = 64;
std::mutex ring_mutex;
RingFit ring_fits[RING_FITS];
int n_ring_fits = 0;
bool ring_device_ready[MAX_DEVICES];

cudaError_t ring_fit(int smem_bytes, RingFit* fit) {
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(ring_mutex);
  for (int i = 0; i < n_ring_fits; ++i)
    if (ring_fits[i].device == device && ring_fits[i].smem == smem_bytes) {
      *fit = ring_fits[i];
      return cudaSuccess;
    }
  if (!ring_device_ready[device]) {
    // once a device: the largest ring the entry takes, and shared memory
    // before L1 (the kernel reads nothing through L1)
    err = cudaFuncSetAttribute(copy_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               RING_SMEM_MAX);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(copy_ring_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    ring_device_ready[device] = true;
  }
  RingFit f{device, smem_bytes, 0, 0};
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&f.ctas_per_sm, copy_ring_kernel,
                                                      RING_THREADS, smem_bytes);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&f.sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (n_ring_fits < RING_FITS) ring_fits[n_ring_fits++] = f;
  *fit = f;
  return cudaSuccess;
}

}  // namespace

extern "C" {

int lk_copy_tiles_f32(const void* x, void* y, long long ny, long long nx, int by, int bx,
                      int unit_rows, int unit_cols, void* stream) {
  if (ny < 1 || nx < 1 || by < 1 || bx < 1 || ny % by || nx % bx || unit_rows < 1 ||
      unit_cols < 4 || unit_cols % 4 || by % unit_rows || bx % unit_cols ||
      static_cast<long long>(unit_rows) * unit_cols > 4 * COPY_THREADS * COPY_VEC ||
      !aligned16(x) || !aligned16(y))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = ny / unit_rows * (nx / unit_cols);
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  copy_tiles_kernel<<<static_cast<unsigned>(grid), COPY_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(y), nx / 4, by, bx / 4, unit_rows,
      unit_cols / 4, nx / bx);
  return static_cast<int>(cudaGetLastError());
}

int lk_copy_ring_f32(const void* x, void* y, long long nbytes, int stage, int depth, int grid,
                     void* stream) {
  if (nbytes < 16 || nbytes % 16 || stage < 16 || stage % 16 || depth < 2 ||
      depth > RING_MAX_DEPTH || static_cast<long long>(stage) * depth > RING_SMEM_MAX ||
      grid < 1 || !aligned16(x) || !aligned16(y))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_chunks = (nbytes + stage - 1) / stage;
  if (grid > n_chunks) return static_cast<int>(cudaErrorInvalidValue);
  const int smem_bytes = stage * depth;
  RingFit fit;
  const cudaError_t err = ring_fit(smem_bytes, &fit);
  if (err != cudaSuccess) return static_cast<int>(err);
  // every ring is resident at once, or the grid would run in waves
  if (grid > static_cast<long long>(fit.ctas_per_sm) * fit.sms)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  copy_ring_kernel<<<grid, RING_THREADS, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(x), static_cast<char*>(y), nbytes, stage, depth, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

// Ring CTAs of `depth` x `stage` bytes that one SM of the current device
// holds at once (the occupancy the card reports), into *ctas_per_sm.
int lk_copy_ring_ctas_per_sm(int stage, int depth, int* ctas_per_sm) {
  if (stage < 16 || stage % 16 || depth < 2 || depth > RING_MAX_DEPTH ||
      static_cast<long long>(stage) * depth > RING_SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  RingFit fit;
  const cudaError_t err = ring_fit(stage * depth, &fit);
  if (err != cudaSuccess) return static_cast<int>(err);
  *ctas_per_sm = fit.ctas_per_sm;
  return static_cast<int>(cudaSuccess);
}

int lk_reduce_8x128_f32(const void* x, void* partial, void* out, long long ny, long long nx,
                        int grid, void* stream) {
  if (ny < 8 || nx < 128 || ny % 8 || nx % 128 || grid < 1 || !aligned16(x))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const long long ntj = nx / 128;
  reduce_partials_kernel<<<grid, RED_THREADS, 0, s>>>(
      static_cast<const float4*>(x), static_cast<float4*>(partial), nx / 4, ntj, (ny / 8) * ntj);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_final_kernel<<<dim3(8, 4), 1024, 0, s>>>(static_cast<const float*>(partial),
                                                  static_cast<float*>(out), grid);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
