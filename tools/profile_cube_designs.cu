// Designs of the profile_cube kernel that were timed on an H100 against
// the shipped one (src/repro_torch/kernels/profile_cube/csrc/
// profile_cube.cu) and not taken: on uniform gids none beat it.
// tools/cube_variants.py builds this file, as it is and with its constants
// edited, beside the shipped source and times them in turns; the package
// never builds it. The C interface, the shared design, the integer sums
// with their f64 side cube and the cast are the shipped file's. What
// differs, for B above BAND_GROUPS:
//   - LARGE = 2, the banded design: pass 1 counts each block's rows (w != 0)
//     of each band of BAND_GROUPS groups, by the clipped gid; pass 2 scans
//     the counts into each block's first slot in each band; pass 3 writes
//     each row as a 16 B record (cell in band, w, size, blocks) into its
//     band's segment; pass 4, one block an SM, sums an even share of all
//     records into a band's private cube in shared memory with native u32
//     adds and flushes it once a band segment. About 56 B a row move;
//   - LARGE = 0, HOT_GROUPS > 0: the global design with the groups
//     [0, HOT_GROUPS), the frequent ones where ids follow first appearance,
//     summed per block in shared memory (GLOBAL_THREADS a block);
//   - LANE_ADDS = false: the global design's three adds a row issued by the
//     row's own thread, back to back.
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
constexpr bool LANE_ADDS = true;
// the most groups one block's private cube holds (24 B a cell in 232,448 B
// of opt-in shared memory): the shared design's limit and the banded
// design's band width
constexpr int BAND_GROUPS = 138;
constexpr int MAX_BANDS = 32;            // bands of up to 4,416 groups
constexpr int SUM_THREADS = 1024;        // band_sum_kernel, one block an SM
constexpr int MAX_BLOCKS = 1024;         // blocks of the banded passes 1, 3
// the design above BAND_GROUPS: 2 banded, 0 global
constexpr int LARGE = 2;
// the global design: groups [0, HOT_GROUPS) summed per block in shared
// memory (0: none), GLOBAL_THREADS threads a block
constexpr int HOT_GROUPS = 0;
constexpr int GLOBAL_THREADS = 512;
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

// A row's integer measures into the private cube at `cell`.
__device__ __forceinline__ void shared_row(unsigned* s_cube, int cell, u64 v0,
                                           u64 v1, u64 v2) {
  unsigned* p = s_cube + cell * WORDS;
  shared_add(p, v0);
  shared_add(p + 2, v1);
  shared_add(p + 4, v2);
}

// The private cube's k cells into the global cube at `dst`: one u64 add
// for each non-zero sum, a cell's three from neighbouring threads.
__device__ __forceinline__ void flush(const unsigned* s_cube, int k,
                                      u64* dst) {
  for (int i = threadIdx.x; i < k * N_MEASURES; i += blockDim.x) {
    const int cell = i / N_MEASURES, m = i - cell * N_MEASURES;
    const unsigned* p = s_cube + cell * WORDS + 2 * m;
    const u64 v = p[0] | (static_cast<u64>(p[1]) << 32);
    if (v != 0) atomicAdd(dst + static_cast<size_t>(cell) * SLOTS + m, v);
  }
}

// The global design, NT threads a block. With HOT > 0, groups [0, HOT)
// keep a private cube per block in shared memory and only the other rows
// add in L2.
template <int HOT, int NT>
__global__ void __launch_bounds__(NT) global_kernel(
    Columns c, double limit, u64* __restrict__ cube,
    double* __restrict__ side) {
  extern __shared__ unsigned s_cube[];
  if constexpr (HOT > 0) {
    for (int i = threadIdx.x; i < HOT * CELLS * WORDS; i += NT)
      s_cube[i] = 0u;
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const long long n_tiles = (c.n + NT * ITEMS - 1) / (NT * ITEMS);
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long base = tile * NT * ITEMS + threadIdx.x;
    float w[ITEMS], size[ITEMS], blocks[ITEMS];
    int cell[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      w[j] = load_row(c, base + static_cast<long long>(j) * NT, size[j],
                      blocks[j], cell[j]);
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      u64 v0 = 0, v1 = 0, v2 = 0;
      int at = -1;                  // the cell this row adds integers to
      if (w[j] != 0.f) {
        if (!as_integers(w[j], size[j], blocks[j], limit, v0, v1, v2))
          side_add(side, cell[j], w[j], size[j], blocks[j]);
        else if (HOT > 0 && cell[j] < HOT * CELLS)
          shared_row(s_cube, cell[j], v0, v1, v2);
        else
          at = cell[j];
      }
      if constexpr (LANE_ADDS) {
        // round r: lane 4q + m adds measure m of the round's row q (lane
        // 8r + q), so a row's three adds leave in one instruction
        const int m = lane & 3;
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
      } else if (at >= 0) {
        u64* p = cube + static_cast<size_t>(at) * SLOTS;
        if (v0 != 0) atomicAdd(p, v0);
        if (v1 != 0) atomicAdd(p + 1, v1);
        if (v2 != 0) atomicAdd(p + 2, v2);
      }
    }
  }
  if constexpr (HOT > 0) {
    __syncthreads();
    flush(s_cube, HOT * CELLS, cube);
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
      if (as_integers(w[j], size[j], blocks[j], limit, v0, v1, v2))
        shared_row(s_cube, cell[j], v0, v1, v2);
      else
        side_add(side, cell[j], w[j], size[j], blocks[j]);
    }
  }
  __syncthreads();
  flush(s_cube, k, cube);
}

// The banded design, for B > BAND_GROUPS: a band is BAND_GROUPS groups
// (the last one fewer), and a record carries a row to its band's sums.
struct __align__(16) Record {
  int cell;                     // the cell within its band
  float w, size, blocks;
};

__host__ __device__ __forceinline__ int n_bands(int n_groups) {
  return (n_groups + BAND_GROUPS - 1) / BAND_GROUPS;
}

// Rows [first, last) of block b of `blocks` in passes 1 and 3: whole
// tiles, contiguous, so both passes walk the same rows in each block.
__device__ __forceinline__ void chunk(long long n, long long& first,
                                      long long& last) {
  const long long tiles = (n + TILE - 1) / TILE;
  const long long per = (tiles + gridDim.x - 1) / gridDim.x;
  first = blockIdx.x * per * TILE;
  first = first < n ? first : n;
  last = first + per * TILE < n ? first + per * TILE : n;
}

// A warp's rows of one band take consecutive slots from `cnt[band]` by one
// shared add of their leader; returns this lane's slot (band < 0: none).
__device__ __forceinline__ unsigned claim(unsigned* cnt, int band,
                                          int lane) {
  const unsigned peers = __match_any_sync(FULL, band);
  const int leader = __ffs(peers) - 1;
  unsigned first = 0u;
  if (band >= 0 && lane == leader)
    first = atomicAdd(&cnt[band], static_cast<unsigned>(__popc(peers)));
  first = __shfl_sync(FULL, first, leader);
  return first + __popc(peers & ((1u << lane) - 1u));
}

// Pass 1: each block's rows of each band, into counts[band][block]. The
// predicate (w != 0) and the clipped gid are load_row's, as in pass 3.
__global__ void __launch_bounds__(THREADS) count_kernel(
    Columns c, unsigned* __restrict__ counts) {
  __shared__ unsigned s_cnt[MAX_BANDS];
  if (threadIdx.x < MAX_BANDS) s_cnt[threadIdx.x] = 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  long long first, last;
  chunk(c.n, first, last);
  for (long long t = first; t < last; t += TILE) {
    int band[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const long long i = t + threadIdx.x + static_cast<long long>(j) * THREADS;
      band[j] = -1;
      if (i >= last) continue;
      const float w = c.valid_col >= 0 ? c.cols[c.valid_col * c.n + i] : 1.f;
      if (w == 0.f) continue;
      band[j] = clip(__float2int_rz(c.cols[c.gid_col * c.n + i]), 0,
                     c.n_groups - 1) / BAND_GROUPS;
    }
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) claim(s_cnt, band[j], lane);
  }
  __syncthreads();
  if (threadIdx.x < n_bands(c.n_groups))
    counts[threadIdx.x * gridDim.x + blockIdx.x] = s_cnt[threadIdx.x];
}

// Pass 2, one block of 1,024 threads: the exclusive scan of counts in
// (band, block) order gives each block its first slot in each band
// (offsets) and each band its first record (start; start[bands] = all).
__global__ void __launch_bounds__(1024) scan_kernel(
    const unsigned* __restrict__ counts, u64* __restrict__ offsets,
    u64* __restrict__ start, int bands, int blocks) {
  __shared__ u64 s_warp[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = bands * blocks;
  const int per = (m + 1023) / 1024;
  const int lo = min(m, static_cast<int>(threadIdx.x) * per);
  const int hi = min(m, lo + per);
  u64 sum = 0;
  for (int i = lo; i < hi; ++i) sum += counts[i];
  u64 incl = sum;
  for (int d = 1; d < 32; d <<= 1) {
    const u64 x = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += x;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    u64 v = s_warp[lane];
    for (int d = 1; d < 32; d <<= 1) {
      const u64 x = __shfl_up_sync(FULL, v, d);
      if (lane >= d) v += x;
    }
    s_warp[lane] = v;
  }
  __syncthreads();
  u64 run = incl - sum + (warp > 0 ? s_warp[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    offsets[i] = run;
    if (i % blocks == 0) start[i / blocks] = run;
    run += counts[i];
  }
  if (threadIdx.x == 0) start[bands] = s_warp[31];
}

// Pass 3: each row with w != 0 to a record in its band's segment, at the
// block's next slot there. Order within a band does not matter, for
// integer sums are exact in any order.
__global__ void __launch_bounds__(THREADS) scatter_kernel(
    Columns c, const u64* __restrict__ offsets, Record* __restrict__ rec) {
  __shared__ u64 s_base[MAX_BANDS];
  __shared__ unsigned s_cnt[MAX_BANDS];
  if (threadIdx.x < n_bands(c.n_groups)) {
    s_base[threadIdx.x] = offsets[threadIdx.x * gridDim.x + blockIdx.x];
    s_cnt[threadIdx.x] = 0u;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  long long first, last;
  chunk(c.n, first, last);
  for (long long t = first; t < last; t += TILE) {
    float w[ITEMS], size[ITEMS], blocks[ITEMS];
    int cell[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const long long i = t + threadIdx.x + static_cast<long long>(j) * THREADS;
      w[j] = i < last ? load_row(c, i, size[j], blocks[j], cell[j]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int band = w[j] != 0.f ? cell[j] / (BAND_GROUPS * CELLS) : -1;
      const unsigned slot = claim(s_cnt, band, lane);
      if (band >= 0)
        rec[s_base[band] + slot] = Record{
            cell[j] - band * BAND_GROUPS * CELLS, w[j], size[j], blocks[j]};
    }
  }
}

__device__ __forceinline__ void band_row(const Record& r, int band,
                                         double limit, unsigned* s_cube,
                                         double* side) {
  u64 v0, v1, v2;
  if (as_integers(r.w, r.size, r.blocks, limit, v0, v1, v2))
    shared_row(s_cube, r.cell, v0, v1, v2);
  else
    side_add(side, band * BAND_GROUPS * CELLS + r.cell, r.w, r.size,
             r.blocks);
}

// Pass 4: one block an SM takes an even share of all records (work follows
// the counts, not the bands), and sums each band segment of its share in
// a private cube in shared memory, flushed once a segment.
__global__ void __launch_bounds__(SUM_THREADS) band_sum_kernel(
    const u64* __restrict__ start, const Record* __restrict__ rec,
    int n_groups, double limit, u64* __restrict__ cube,
    double* __restrict__ side) {
  extern __shared__ unsigned s_cube[];
  const u64 total = start[n_bands(n_groups)];
  const u64 mine = total * (blockIdx.x + 1) / gridDim.x;
  int band = 0;
  for (u64 lo = total * blockIdx.x / gridDim.x; lo < mine;) {
    while (start[band + 1] <= lo) ++band;
    const u64 hi = mine < start[band + 1] ? mine : start[band + 1];
    const int groups = min(BAND_GROUPS, n_groups - band * BAND_GROUPS);
    const int k = groups * CELLS;
    for (int i = threadIdx.x; i < k * WORDS; i += SUM_THREADS)
      s_cube[i] = 0u;
    __syncthreads();
    u64 i = lo + threadIdx.x;
    for (; i + 3 * SUM_THREADS < hi; i += 4 * SUM_THREADS) {
      Record r[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) r[u] = rec[i + u * SUM_THREADS];
#pragma unroll
      for (int u = 0; u < 4; ++u) band_row(r[u], band, limit, s_cube, side);
    }
    for (; i < hi; i += SUM_THREADS)
      band_row(rec[i], band, limit, s_cube, side);
    __syncthreads();
    flush(s_cube, k,
          cube + static_cast<size_t>(band) * BAND_GROUPS * CELLS * SLOTS);
    __syncthreads();
    lo = hi;
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

enum Design { GLOBAL = 0, SHARED = 1, BANDED = 2 };

size_t shared_bytes(int n_groups) {
  return sizeof(unsigned) * WORDS * static_cast<size_t>(n_groups) * CELLS;
}

size_t cube_bytes(int n_groups) {
  return sizeof(u64) * SLOTS * static_cast<size_t>(n_groups) * CELLS;
}

// the banded design's counts (u32) and offsets (u64) by band and block,
// then the bands' starts (one more), padded to 16 B for the records
constexpr size_t COUNT_BYTES = sizeof(unsigned) * MAX_BANDS * MAX_BLOCKS;
constexpr size_t OFFSET_BYTES = sizeof(u64) * MAX_BANDS * MAX_BLOCKS;
constexpr size_t BAND_BYTES =
    COUNT_BYTES + OFFSET_BYTES + sizeof(u64) * (MAX_BANDS + 2);

// Workspace bytes the launch zeroes: the u64 cube and the f64 side cube,
// cell-major. The banded design's bookkeeping and records follow.
size_t zeroed_bytes(int n_groups) { return 2 * cube_bytes(n_groups); }

// The largest value a row may add as an integer: 2^53, halved until n
// such values cannot carry a u64 sum past 2^64.
double int_limit(long long n) {
  double limit = EXACT;
  while (limit * static_cast<double>(n) > U64_RANGE) limit *= 0.5;
  return limit;
}

// The design for n_groups on the current device, or a negative CUDA error
// code when the query fails.
int design(int n_groups) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  const size_t room = static_cast<size_t>(optin);
  if (n_groups <= BAND_GROUPS && shared_bytes(n_groups) <= room)
    return SHARED;
  if (LARGE == BANDED && n_bands(n_groups) <= MAX_BANDS &&
      shared_bytes(BAND_GROUPS) <= room)
    return BANDED;
  return GLOBAL;
}

// Opts `kernel` into `smem` bytes of dynamic shared memory and reads how
// many blocks of `threads` an SM holds (at least 1).
template <typename Kernel>
cudaError_t blocks_per_sm(Kernel kernel, int threads, size_t smem,
                          int* per_sm) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                      threads, smem);
  if (*per_sm < 1) *per_sm = 1;
  return e;
}

}  // namespace profile_cube

extern "C" {

const char* profile_cube_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// 0: global design, 1: shared, 2: banded; < 0: minus a CUDA error code.
int profile_cube_design(int n_groups) {
  return profile_cube::design(n_groups);
}

// The most groups one block's private cube holds: the shared design's
// limit and the banded design's band width.
int profile_cube_band_groups() { return profile_cube::BAND_GROUPS; }

// Bytes of the workspace profile_cube_launch takes for n rows and
// n_groups (the banded design's records need 16 B a row), or minus a CUDA
// error code.
long long profile_cube_work_bytes(long long n, int n_groups) {
  using namespace profile_cube;
  const int d = design(n_groups);
  if (d < 0) return d;
  return static_cast<long long>(zeroed_bytes(n_groups)) +
         (d == BANDED ? static_cast<long long>(BAND_BYTES + sizeof(Record) * n)
                      : 0);
}

// Zeroes what the workspace (profile_cube_work_bytes(n, n_groups) bytes)
// needs zeroed, launches the cube build (one kernel, or the banded
// design's four passes) and the cast to f32 into `out` (3 * n_groups * 70
// floats) on `stream`. Returns 0 when every launch was accepted, else the
// CUDA error.
int profile_cube_launch(const float* cols, long long n, int n_groups,
                        int gid_col, int size_col, int blocks_col,
                        int age_col, int valid_col, int sb_col, int ab_col,
                        void* work, float* out, int sms, void* stream) {
  using namespace profile_cube;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = design(n_groups);
  if (d < 0) return -d;
  char* base = static_cast<char*>(work);
  u64* cube = reinterpret_cast<u64*>(base);
  double* side = reinterpret_cast<double*>(base + cube_bytes(n_groups));
  cudaError_t e = cudaMemsetAsync(work, 0, zeroed_bytes(n_groups), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Columns c{cols, n, n_groups, gid_col, size_col, blocks_col,
                  age_col, valid_col, sb_col, ab_col};
  const double limit = int_limit(n);
  const long long tiles = (n + TILE - 1) / TILE;
  auto grid = [&](int per_sm) {
    const long long cap = static_cast<long long>(sms) * per_sm;
    return static_cast<int>(tiles < cap ? tiles : cap);
  };
  int per_sm = 1;
  if (d == SHARED) {
    const size_t smem = shared_bytes(n_groups);
    e = blocks_per_sm(shared_kernel, THREADS, smem, &per_sm);
    if (e != cudaSuccess) return static_cast<int>(e);
    shared_kernel<<<grid(per_sm), THREADS, smem, s>>>(c, limit, cube, side);
  } else if (d == GLOBAL) {
    const size_t smem = shared_bytes(HOT_GROUPS);
    e = blocks_per_sm(global_kernel<HOT_GROUPS, GLOBAL_THREADS>,
                      GLOBAL_THREADS, smem, &per_sm);
    if (e != cudaSuccess) return static_cast<int>(e);
    const long long t = (n + GLOBAL_THREADS * ITEMS - 1) /
                        (GLOBAL_THREADS * ITEMS);
    const long long cap = static_cast<long long>(sms) * per_sm;
    global_kernel<HOT_GROUPS, GLOBAL_THREADS>
        <<<static_cast<int>(t < cap ? t : cap), GLOBAL_THREADS, smem, s>>>(
            c, limit, cube, side);
  } else {
    char* band = base + zeroed_bytes(n_groups);
    unsigned* counts = reinterpret_cast<unsigned*>(band);
    u64* offsets = reinterpret_cast<u64*>(band + COUNT_BYTES);
    u64* start = offsets + MAX_BANDS * MAX_BLOCKS;
    Record* rec = reinterpret_cast<Record*>(band + BAND_BYTES);
    e = blocks_per_sm(scatter_kernel, THREADS, 0, &per_sm);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int blocks = grid(per_sm) < MAX_BLOCKS ? grid(per_sm) : MAX_BLOCKS;
    count_kernel<<<blocks, THREADS, 0, s>>>(c, counts);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    scan_kernel<<<1, 1024, 0, s>>>(counts, offsets, start,
                                   n_bands(n_groups), blocks);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    scatter_kernel<<<blocks, THREADS, 0, s>>>(c, offsets, rec);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    const size_t smem = shared_bytes(BAND_GROUPS);
    e = blocks_per_sm(band_sum_kernel, SUM_THREADS, smem, &per_sm);
    if (e != cudaSuccess) return static_cast<int>(e);
    band_sum_kernel<<<sms * per_sm, SUM_THREADS, smem, s>>>(
        start, rec, n_groups, limit, cube, side);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const int k = n_groups * CELLS;
  cast_kernel<<<(k + THREADS - 1) / THREADS, THREADS, 0, s>>>(cube, side,
                                                              out, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
