// profile_cube for Hopper (sm_90a): bucketize every row of a column-major
// f32 table and sum count, size and blocks, weighted by the validity row,
// into the (3, B, 10, 7) cube cell [gid, size bucket, age bucket].
//
// Replaces the Pallas TPU kernel profile_cube_pallas
// (_profile_cube_kernel) of src/repro/kernels/profile_cube/kernel.py. That
// kernel builds a (B, tile) gid one-hot and an (S*A, tile) bucket one-hot
// and runs three matrix products on the MXU: the TPU's idiom for a
// scatter-add. Here the scatter is written directly, with atomics.
//
// Bound on this card: bytes. Each row is read once: the validity row
// (4 B) and, for a valid row, gid, size, blocks and either the sb/ab
// bucket rows (prebucketed layout, 24 B a row in all; the age row of that
// layout is not read) or the age row (raw layout, 20 B a row), plus
// 3 * B * 70 * 4 B of cube written. The arithmetic (ten compares a
// bucket, three f64 products) is far below the card's rate.
//
// Design (a simple, correct first kernel; warp-aggregated atomics, a
// sorted or privatised scatter and the like are later work):
//   - one thread per row, ITEMS rows a thread per step of a grid-stride
//     loop; column c of row i is cols[c * n + i], so a warp's loads are
//     coalesced; the ragged last tile is masked here, so the caller does
//     not pad rows (nor groups);
//   - sums are f64. Every value on this path is an integer that f32 holds
//     exactly, and f64 sums of such values are exact up to 2^53 in any
//     order, so the cube is the same from run to run although blocks and
//     atomics run in no order; each cell is rounded to f32 once, at the
//     end (cast_kernel). (On the TPU the grid is sequential and carries an
//     f32 sum across steps.)
//   - the shared design: when 3 * B * 70 f64 cells fit in a block's shared
//     memory (B <= 138 on an H100), each block keeps a private cube there,
//     adds with shared-memory atomics and flushes its non-zero cells into
//     the global f64 cube with one atomic each;
//   - the global design, for larger B (up to MAX_GROUPS = 4096, a 6.9 MB
//     f64 cube that stays in the 50 MB L2): every row adds straight into
//     the global f64 cube. Tiling the group axis over blockIdx.y instead
//     would re-read the columns B / 64 times.
#include <cuda_runtime.h>

namespace profile_cube {

constexpr int THREADS = 512;
constexpr int ITEMS = 4;
constexpr int TILE = THREADS * ITEMS;
constexpr int S_BUCKETS = 10;
constexpr int A_BUCKETS = 7;
constexpr int CELLS = S_BUCKETS * A_BUCKETS;
constexpr int N_MEASURES = 3;

__device__ __forceinline__ int clip(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// f32 `x >= edge` count minus 1, clipped: ref.size_buckets / age_buckets
__device__ __forceinline__ int size_bucket(float s) {
  const int b = (s >= 0.f) + (s >= 1.f) + (s >= 32.f) + (s >= 1024.f) +
                (s >= 32768.f) + (s >= 1048576.f) + (s >= 33554432.f) +
                (s >= 1073741824.f) + (s >= 34359738368.f) +
                (s >= 1099511627776.f);
  return clip(b - 1, 0, S_BUCKETS - 1);
}

__device__ __forceinline__ int age_bucket(float a) {
  const int b = (a >= 0.f) + (a >= 3600.f) + (a >= 86400.f) +
                (a >= 604800.f) + (a >= 2592000.f) + (a >= 7776000.f) +
                (a >= 31536000.f);
  return clip(b - 1, 0, A_BUCKETS - 1);
}

template <bool SHARED>
__global__ void __launch_bounds__(THREADS) cube_kernel(
    const float* __restrict__ cols, long long n, int n_groups, int gid_col,
    int size_col, int blocks_col, int age_col, int valid_col, int sb_col,
    int ab_col, double* __restrict__ cube) {
  extern __shared__ double s_cube[];
  const int k = n_groups * CELLS;
  double* acc = cube;
  if constexpr (SHARED) {
    for (int c = threadIdx.x; c < N_MEASURES * k; c += THREADS)
      s_cube[c] = 0.0;
    __syncthreads();
    acc = s_cube;
  }
  const long long n_tiles = (n + TILE - 1) / TILE;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long base = tile * TILE + threadIdx.x;
    float w[ITEMS], size[ITEMS], blocks[ITEMS];
    int flat[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const long long i = base + static_cast<long long>(j) * THREADS;
      w[j] = 0.f;
      size[j] = 0.f;
      blocks[j] = 0.f;
      flat[j] = 0;
      if (i >= n) continue;
      w[j] = valid_col >= 0 ? cols[valid_col * n + i] : 1.f;
      if (w[j] == 0.f) continue;
      const int g = clip(__float2int_rz(cols[gid_col * n + i]), 0,
                         n_groups - 1);
      size[j] = cols[size_col * n + i];
      blocks[j] = cols[blocks_col * n + i];
      const int sb = sb_col >= 0
          ? clip(__float2int_rz(cols[sb_col * n + i]), 0, S_BUCKETS - 1)
          : size_bucket(size[j]);
      const int ab = ab_col >= 0
          ? clip(__float2int_rz(cols[ab_col * n + i]), 0, A_BUCKETS - 1)
          : age_bucket(cols[age_col * n + i]);
      flat[j] = (g * S_BUCKETS + sb) * A_BUCKETS + ab;
    }
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      if (w[j] == 0.f) continue;
      const double wd = static_cast<double>(w[j]);
      atomicAdd(acc + flat[j], wd);
      atomicAdd(acc + k + flat[j], wd * static_cast<double>(size[j]));
      atomicAdd(acc + 2 * k + flat[j], wd * static_cast<double>(blocks[j]));
    }
  }
  if constexpr (SHARED) {
    __syncthreads();
    for (int c = threadIdx.x; c < N_MEASURES * k; c += THREADS) {
      const double v = s_cube[c];
      if (v != 0.0) atomicAdd(cube + c, v);
    }
  }
}

__global__ void __launch_bounds__(THREADS) cast_kernel(
    const double* __restrict__ in, float* __restrict__ out, int m) {
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < m;
       i += gridDim.x * THREADS)
    out[i] = static_cast<float>(in[i]);
}

size_t shared_bytes(int n_groups) {
  return sizeof(double) * N_MEASURES * static_cast<size_t>(n_groups) * CELLS;
}

// 1 when the shared design runs for n_groups on the current device, 0 for
// the global one, a negative CUDA error code when the query fails.
int design(int n_groups) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return shared_bytes(n_groups) <= static_cast<size_t>(optin) ? 1 : 0;
}

}  // namespace profile_cube

extern "C" {

const char* profile_cube_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// 1: shared design, 0: global design, < 0: minus a CUDA error code.
int profile_cube_design(int n_groups) {
  return profile_cube::design(n_groups);
}

// Launches the cube build and the f64 -> f32 cast on `stream`. `scratch`
// holds 3 * n_groups * 70 doubles and must be zero; `out` 3 * n_groups * 70
// floats. Returns 0 when both launches were accepted, else the CUDA error.
int profile_cube_launch(const float* cols, long long n, int n_groups,
                        int gid_col, int size_col, int blocks_col,
                        int age_col, int valid_col, int sb_col, int ab_col,
                        double* scratch, float* out, int sms, void* stream) {
  using namespace profile_cube;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int shared = design(n_groups);
  if (shared < 0) return -shared;
  const long long tiles = (n + TILE - 1) / TILE;
  int per_sm = 2048 / THREADS;
  size_t smem = 0;
  if (shared) {
    smem = shared_bytes(n_groups);
    cudaError_t e = cudaFuncSetAttribute(
        cube_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, cube_kernel<true>, THREADS, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) per_sm = 1;
  }
  const long long cap = static_cast<long long>(sms) * per_sm;
  const int grid = static_cast<int>(tiles < cap ? tiles : cap);
  if (shared)
    cube_kernel<true><<<grid, THREADS, smem, s>>>(
        cols, n, n_groups, gid_col, size_col, blocks_col, age_col, valid_col,
        sb_col, ab_col, scratch);
  else
    cube_kernel<false><<<grid, THREADS, 0, s>>>(
        cols, n, n_groups, gid_col, size_col, blocks_col, age_col, valid_col,
        sb_col, ab_col, scratch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int m = N_MEASURES * n_groups * CELLS;
  const int cast_grid = (m + THREADS - 1) / THREADS;
  cast_kernel<<<cast_grid, THREADS, 0, s>>>(scratch, out, m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
