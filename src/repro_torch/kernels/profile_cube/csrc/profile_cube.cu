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
// 3 * B * 70 * 4 B of cube written. The arithmetic is far below the
// card's rate. What holds a scatter back is its adds: about 4e8 of them at
// 2^27 rows, each an atomic in L2 or in shared memory.
//
// Sums are integers. Every value ProfileCube passes (weight, size, blocks)
// is a non-negative integer that f32 holds, so a row's three measures
// (w, w * size, w * blocks) are added as u64: exact in any order, so the
// cube is the same from run to run although blocks and atomics run in no
// order. A row whose measures are not such integers, or reach the limit
// (2^53, or less when N rows could carry a u64 sum past 2^64), adds its
// f64 products into an f64 side cube instead. Each cell is rounded to f32
// once, at the end: float(double(u64 sum) + f64 side sum) (cast_kernel),
// so wherever the f64 sums are exact the cube is the f64 plain version
// cast to f32. (On the TPU the grid is sequential and carries an f32 sum
// across steps.)
//
// On sm_90 only the u32 add is a native shared-memory atomic (ATOMS.ADD);
// u64, f32 and f64 adds there are compare-and-swap loops. In global memory
// all are native (REDG.E.ADD.64 / .F64). So:
//   - the shared design, when the private cube fits a block's shared
//     memory (B <= 138 on an H100: 24 B a cell): each block keeps each sum
//     as a pair of u32 words, adds the low word natively and carries into
//     the high one, and flushes its non-zero sums into the global cube;
//   - the global design, for larger B (up to MAX_GROUPS = 4096): every row
//     adds straight into the global cube, whose cells are cell-major,
//     (count, volume, spc_used, pad) in one 32 B sector; lanes 4q..4q+2 of
//     a warp issue row q's three adds in one instruction, so a row costs
//     L2 one sector request, as index_add_ of (N, 3) does. It is bound by
//     those requests, and slower where many rows share a few cells.
// tools/profile_cube_designs.cu keeps the designs for large B that were
// timed against this one on an H100 and not taken (rows partitioned by
// band of groups and summed in shared memory; the low group ids kept in
// shared memory inside the global design): on uniform gids neither beat
// it; tools/cube_variants.py times them.
// One thread per row, ITEMS rows a thread per step of a grid-stride loop;
// column c of row i is cols[c * n + i], so a warp's loads are coalesced;
// the ragged last tile is masked here, so the caller pads nothing.
#include <cuda_runtime.h>

namespace profile_cube {

typedef unsigned long long u64;

constexpr int THREADS = 512;
constexpr int ITEMS = 4;
constexpr int TILE = THREADS * ITEMS;
constexpr int S_BUCKETS = 10;
constexpr int A_BUCKETS = 7;
constexpr int CELLS = S_BUCKETS * A_BUCKETS;
constexpr int N_MEASURES = 3;
constexpr int SLOTS = 4;                 // 8 B sums a cell in global memory
constexpr int WORDS = 2 * N_MEASURES;    // u32 words a cell in shared memory
// the most groups one block's private cube holds (24 B a cell in 232,448 B
// of opt-in shared memory): the shared design's limit
constexpr int BAND_GROUPS = 138;
constexpr unsigned FULL = 0xffffffffu;
constexpr double EXACT = 9007199254740992.0;    // 2^53
constexpr double U64_RANGE = 18446744073709551616.0;  // 2^64

struct Columns {
  const float* cols;
  long long n;
  int n_groups, gid_col, size_col, blocks_col, age_col, valid_col, sb_col,
      ab_col;
};

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

// Row i's weight (0: the row adds nothing), size, blocks and flat cell
// (g * 10 + sb) * 7 + ab, with gid clipped into [0, n_groups).
__device__ __forceinline__ float load_row(const Columns& c, long long i,
                                          float& size, float& blocks,
                                          int& cell) {
  size = blocks = 0.f;
  cell = 0;
  if (i >= c.n) return 0.f;
  const float w = c.valid_col >= 0 ? c.cols[c.valid_col * c.n + i] : 1.f;
  if (w == 0.f) return 0.f;
  const int g = clip(__float2int_rz(c.cols[c.gid_col * c.n + i]), 0,
                     c.n_groups - 1);
  size = c.cols[c.size_col * c.n + i];
  blocks = c.cols[c.blocks_col * c.n + i];
  const int sb = c.sb_col >= 0
      ? clip(__float2int_rz(c.cols[c.sb_col * c.n + i]), 0, S_BUCKETS - 1)
      : size_bucket(size);
  const int ab = c.ab_col >= 0
      ? clip(__float2int_rz(c.cols[c.ab_col * c.n + i]), 0, A_BUCKETS - 1)
      : age_bucket(c.cols[c.age_col * c.n + i]);
  cell = (g * S_BUCKETS + sb) * A_BUCKETS + ab;
  return w;
}

// The row's measures as u64 when w, size and blocks are non-negative
// integers and every product is below `limit` (<= 2^53, so the f64
// products are exact); false sends the row to the f64 side cube.
__device__ __forceinline__ bool as_integers(float w, float size,
                                            float blocks, double limit,
                                            u64& c, u64& v, u64& s) {
  const double wd = w;
  const double vd = wd * static_cast<double>(size);
  const double sd = wd * static_cast<double>(blocks);
  if (!(wd >= 0.0 && wd < limit && wd == trunc(wd) && size >= 0.f &&
        size == truncf(size) && blocks >= 0.f && blocks == truncf(blocks) &&
        vd < limit && sd < limit))
    return false;
  c = static_cast<u64>(wd);
  v = static_cast<u64>(vd);
  s = static_cast<u64>(sd);
  return true;
}

// The f64 products a row adds when it is not integer: the same arithmetic
// as the f64 plain version.
__device__ __forceinline__ void side_add(double* side, int cell, float w,
                                         float size, float blocks) {
  const double wd = w;
  double* p = side + static_cast<size_t>(cell) * SLOTS;
  atomicAdd(p, wd);
  atomicAdd(p + 1, wd * static_cast<double>(size));
  atomicAdd(p + 2, wd * static_cast<double>(blocks));
}

// v into a sum kept as two u32 words in shared memory: the low word by a
// native add, its carry and the high bits into the high word. Every wrap
// of the low word is seen by the one add that made it, so the pair holds
// the exact sum in any order.
__device__ __forceinline__ void shared_add(unsigned* word, u64 v) {
  const unsigned lo = static_cast<unsigned>(v);
  unsigned hi = static_cast<unsigned>(v >> 32);
  if (lo != 0u) {
    const unsigned old = atomicAdd(word, lo);
    hi += (old + lo < lo) ? 1u : 0u;
  }
  if (hi != 0u) atomicAdd(word + 1, hi);
}

// The global design: every row adds into the global cube; round r of a
// step, lane 4q + m adds measure m of row q of the round (lane 8r + q), so
// a row's three adds leave in one instruction, to one 32 B sector.
__global__ void __launch_bounds__(THREADS) global_kernel(
    Columns c, double limit, u64* __restrict__ cube,
    double* __restrict__ side) {
  const int lane = threadIdx.x & 31, m = lane & 3;
  const long long n_tiles = (c.n + TILE - 1) / TILE;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long base = tile * TILE + threadIdx.x;
    float w[ITEMS], size[ITEMS], blocks[ITEMS];
    int cell[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      w[j] = load_row(c, base + static_cast<long long>(j) * THREADS,
                      size[j], blocks[j], cell[j]);
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      u64 v0 = 0, v1 = 0, v2 = 0;
      int at = -1;                  // the cell this row adds integers to
      if (w[j] != 0.f) {
        if (as_integers(w[j], size[j], blocks[j], limit, v0, v1, v2))
          at = cell[j];
        else
          side_add(side, cell[j], w[j], size[j], blocks[j]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int src = r * 8 + (lane >> 2);
        const int to = __shfl_sync(FULL, at, src);
        const u64 a = __shfl_sync(FULL, v0, src);
        const u64 b = __shfl_sync(FULL, v1, src);
        const u64 d = __shfl_sync(FULL, v2, src);
        const u64 v = m == 0 ? a : (m == 1 ? b : d);
        if (to >= 0 && m < N_MEASURES && v != 0)
          atomicAdd(cube + static_cast<size_t>(to) * SLOTS + m, v);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS) shared_kernel(
    Columns c, double limit, u64* __restrict__ cube,
    double* __restrict__ side) {
  extern __shared__ unsigned s_cube[];
  const int k = c.n_groups * CELLS;
  for (int i = threadIdx.x; i < k * WORDS; i += THREADS) s_cube[i] = 0u;
  __syncthreads();
  const long long n_tiles = (c.n + TILE - 1) / TILE;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long base = tile * TILE + threadIdx.x;
    float w[ITEMS], size[ITEMS], blocks[ITEMS];
    int cell[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      w[j] = load_row(c, base + static_cast<long long>(j) * THREADS,
                      size[j], blocks[j], cell[j]);
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      if (w[j] == 0.f) continue;
      u64 v0, v1, v2;
      if (as_integers(w[j], size[j], blocks[j], limit, v0, v1, v2)) {
        unsigned* p = s_cube + cell[j] * WORDS;
        shared_add(p, v0);
        shared_add(p + 2, v1);
        shared_add(p + 4, v2);
      } else {
        side_add(side, cell[j], w[j], size[j], blocks[j]);
      }
    }
  }
  __syncthreads();
  // the private cube into the global one: one u64 add for each non-zero
  // sum, a cell's three from neighbouring threads
  for (int i = threadIdx.x; i < k * N_MEASURES; i += THREADS) {
    const int cell = i / N_MEASURES, m = i - cell * N_MEASURES;
    const unsigned* p = s_cube + cell * WORDS + 2 * m;
    const u64 v = p[0] | (static_cast<u64>(p[1]) << 32);
    if (v != 0) atomicAdd(cube + static_cast<size_t>(cell) * SLOTS + m, v);
  }
}

// out[m, cell] = float(double(cube[cell].m) + side[cell].m): one rounding
__global__ void __launch_bounds__(THREADS) cast_kernel(
    const u64* __restrict__ cube, const double* __restrict__ side,
    float* __restrict__ out, int k) {
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < k;
       i += gridDim.x * THREADS) {
#pragma unroll
    for (int m = 0; m < N_MEASURES; ++m) {
      const size_t at = static_cast<size_t>(i) * SLOTS + m;
      out[static_cast<size_t>(m) * k + i] = __double2float_rn(
          __ull2double_rn(cube[at]) + side[at]);
    }
  }
}

size_t shared_bytes(int n_groups) {
  return sizeof(unsigned) * WORDS * static_cast<size_t>(n_groups) * CELLS;
}

size_t cube_bytes(int n_groups) {
  return sizeof(u64) * SLOTS * static_cast<size_t>(n_groups) * CELLS;
}

// The largest value a row may add as an integer: 2^53, halved until n
// such values cannot carry a u64 sum past 2^64.
double int_limit(long long n) {
  double limit = EXACT;
  while (limit * static_cast<double>(n) > U64_RANGE) limit *= 0.5;
  return limit;
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
  return n_groups <= BAND_GROUPS &&
         shared_bytes(n_groups) <= static_cast<size_t>(optin) ? 1 : 0;
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

// The most groups one block's private cube holds: the shared design's
// limit.
int profile_cube_band_groups() { return profile_cube::BAND_GROUPS; }

// Bytes of the workspace profile_cube_launch takes for n rows and
// n_groups: the u64 cube and the f64 side cube, cell-major.
long long profile_cube_work_bytes(long long n, int n_groups) {
  (void)n;
  return static_cast<long long>(2 * profile_cube::cube_bytes(n_groups));
}

// Zeroes the workspace (profile_cube_work_bytes(n, n_groups) bytes) and
// launches the cube build and the cast to f32 into `out` (3 * n_groups * 70
// floats) on `stream`. Returns 0 when every launch was accepted, else the
// CUDA error.
int profile_cube_launch(const float* cols, long long n, int n_groups,
                        int gid_col, int size_col, int blocks_col,
                        int age_col, int valid_col, int sb_col, int ab_col,
                        void* work, float* out, int sms, void* stream) {
  using namespace profile_cube;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int shared = design(n_groups);
  if (shared < 0) return -shared;
  u64* cube = static_cast<u64*>(work);
  double* side = reinterpret_cast<double*>(static_cast<char*>(work) +
                                           cube_bytes(n_groups));
  cudaError_t e = cudaMemsetAsync(work, 0, 2 * cube_bytes(n_groups), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Columns c{cols, n, n_groups, gid_col, size_col, blocks_col,
                  age_col, valid_col, sb_col, ab_col};
  const double limit = int_limit(n);
  const long long tiles = (n + TILE - 1) / TILE;
  int per_sm = 2048 / THREADS;
  size_t smem = 0;
  if (shared) {
    smem = shared_bytes(n_groups);
    e = cudaFuncSetAttribute(shared_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, shared_kernel, THREADS, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) per_sm = 1;
  }
  const long long cap = static_cast<long long>(sms) * per_sm;
  const int grid = static_cast<int>(tiles < cap ? tiles : cap);
  if (shared)
    shared_kernel<<<grid, THREADS, smem, s>>>(c, limit, cube, side);
  else
    global_kernel<<<grid, THREADS, 0, s>>>(c, limit, cube, side);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int k = n_groups * CELLS;
  cast_kernel<<<(k + THREADS - 1) / THREADS, THREADS, 0, s>>>(cube, side,
                                                              out, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
