// The first policy_scan kernel (csrc/policy_scan.cu before the redesign
// and its header in one file) with the variants that tools/scan_variants.py times
// to find where its time goes. It is never built into the package.
//
//   VARIANT 0: the kernel as first written: per (tile, program), 14 warp
//              shuffle reductions, a serial fold over the warps and two
//              __syncthreads;
//   VARIANT 1: v0 without the aggregate code (masks and rule only; the
//              partials are zeros, so `agg` is not checked);
//   VARIANT 2: v0 with each row's referenced columns loaded once, all
//              loads of a tile issued together, into the thread's own slots
//              in shared memory before the program loop; the interpreter
//              reads them there (the aggregates as in v0);
//   VARIANT 3: a copy kernel: it reads the same columns (those the live
//              compares reference, plus size, blocks and valid) and writes
//              R + 1 words a row; the practical ceiling of the scan.
//
// With VARIANT 0 the code that runs is the first kernel's line for line
// (the unused shared words of v2 and v3 aside). The C interface is that
// of the first package (policy_scan_launch, policy_scan_tile_rows,
// policy_scan_error_string); policy_scan_occupancy adds the resident
// blocks an SM of the scan kernel.
#include <cuda_runtime.h>

#include <cstdint>

namespace policy_scan {

constexpr int VARIANT = 0;

constexpr int MAX_STACK = 8;
constexpr int N_AGG = 14;
constexpr int N_BUCKETS = 10;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 4;
constexpr int TILE = THREADS * ITEMS;
constexpr int MAX_REF = 8;     // v2, v3: columns held a row

enum : int { OP_EQ = 0, OP_NE, OP_GT, OP_GE, OP_LT, OP_LE, OP_AND, OP_OR,
             OP_NOT };

__device__ __forceinline__ int clamp_slot(int pos) {
  return min(max(pos, 0), MAX_STACK - 1);
}

// v0, v1: column c of row `row` from device memory. v2: from the thread's
// own slots s_x[slot * TILE + item * THREADS + tid] where the compare's
// column is held, else from device memory.
__device__ __forceinline__ uint32_t eval_row(
    const float* __restrict__ cols, long long n, int n_cols, long long row,
    const int* ops, const int* colidx, const int* slots, const float* s_x,
    int local, const float* operands, int n_instr) {
  uint32_t stack = 0u;
  int sp = 0;
  for (int i = 0; i < n_instr; ++i) {
    const int op = ops[i];
    if (op < 0) continue;
    const uint32_t a = (stack >> clamp_slot(sp - 1)) & 1u;
    const uint32_t b = (stack >> clamp_slot(sp - 2)) & 1u;
    uint32_t v;
    int pos;
    if (op < 6) {
      float x;
      if (VARIANT == 2 && slots[i] >= 0) {
        x = s_x[slots[i] * TILE + local];
      } else {
        const int c = min(max(colidx[i], 0), n_cols - 1);
        x = __ldg(cols + (long long)c * n + row);
      }
      const float t = operands[i];
      switch (op) {
        case OP_EQ: v = x == t; break;
        case OP_NE: v = x != t; break;
        case OP_GT: v = x > t; break;
        case OP_GE: v = x >= t; break;
        case OP_LT: v = x < t; break;
        default:    v = x <= t; break;
      }
      pos = sp;
      sp += 1;
    } else if (op == OP_AND) {
      v = a & b; pos = sp - 2; sp -= 1;
    } else if (op == OP_OR) {
      v = a | b; pos = sp - 2; sp -= 1;
    } else if (op == OP_NOT) {
      v = a ^ 1u; pos = sp - 1;
    } else {
      v = a ^ 1u; pos = sp - 2; sp -= 1;
    }
    pos = clamp_slot(pos);
    stack = (stack & ~(1u << pos)) | (v << pos);
  }
  return (stack >> clamp_slot(sp - 1)) & 1u;
}

__device__ __forceinline__ int size_bucket(float size) {
  const float edges[N_BUCKETS] = {
      0.0f, 1.0f, 32.0f, 1024.0f, 32768.0f, 1048576.0f, 33554432.0f,
      1073741824.0f, 34359738368.0f, 1099511627776.0f};
  int b = -1;
#pragma unroll
  for (int k = 0; k < N_BUCKETS; ++k) b += size >= edges[k];
  return min(max(b, 0), N_BUCKETS - 1);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(THREADS) scan_kernel(
    const float* __restrict__ cols, long long n, int n_cols,
    const int* __restrict__ g_ops, const int* __restrict__ g_colidx,
    const float* __restrict__ g_operands, int n_progs, int n_instr,
    int size_col, int blocks_col, int valid_col, float* __restrict__ masks,
    int* __restrict__ rule, float* __restrict__ partials) {
  extern __shared__ int smem[];
  const int rp = n_progs * n_instr;
  int* s_ops = smem;
  int* s_col = s_ops + rp;
  float* s_opr = reinterpret_cast<float*>(s_col + rp);
  float* s_red = s_opr + rp;                 // [WARPS][N_AGG]
  float* s_acc = s_red + WARPS * N_AGG;      // [n_progs][N_AGG]
  int* s_slot = reinterpret_cast<int*>(s_acc + n_progs * N_AGG);  // [rp]
  int* s_ref = s_slot + rp;                  // [MAX_REF + 1]: count, cols
  float* s_x = reinterpret_cast<float*>(s_ref + MAX_REF + 1);  // v2

  for (int i = threadIdx.x; i < rp; i += THREADS) {
    s_ops[i] = g_ops[i];
    s_col[i] = g_colidx[i];
    s_opr[i] = g_operands[i];
  }
  for (int i = threadIdx.x; i < n_progs * N_AGG; i += THREADS) s_acc[i] = 0.f;
  __syncthreads();
  if (VARIANT >= 2 && threadIdx.x == 0) {  // the columns live compares read
    int k = 0;
    for (int i = 0; i < rp; ++i) {
      s_slot[i] = -1;
      if (s_ops[i] < 0 || s_ops[i] >= 6) continue;
      const int c = min(max(s_col[i], 0), n_cols - 1);
      int j = 0;
      while (j < k && s_ref[1 + j] != c) ++j;
      if (j == k && k < MAX_REF) s_ref[1 + k++] = c;
      if (j < k) s_slot[i] = j;
    }
    s_ref[0] = k;
  }
  __syncthreads();
  const int n_ref = VARIANT >= 2 ? s_ref[0] : 0;

  const long long n_tiles = (n + TILE - 1) / TILE;
  if (VARIANT == 3) {              // the ceiling: read the columns, write
    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        const long long row = tile * TILE + (long long)j * THREADS +
                              threadIdx.x;
        if (row >= n) continue;
        float s = __ldg(cols + (long long)size_col * n + row) +
                  __ldg(cols + (long long)blocks_col * n + row);
        if (valid_col >= 0) s += __ldg(cols + (long long)valid_col * n + row);
        for (int c = 0; c < n_ref; ++c)
          s += __ldg(cols + (long long)s_ref[1 + c] * n + row);
        for (int r = 0; r < n_progs; ++r)
          masks[(long long)r * n + row] = s + r;
        if (rule != nullptr) rule[row] = __float_as_int(s);
      }
    }
    for (int i = threadIdx.x; i < n_progs * N_AGG; i += THREADS)
      partials[(long long)blockIdx.x * n_progs * N_AGG + i] = 0.f;
    return;
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    long long row[ITEMS];
    bool in[ITEMS];
    float size[ITEMS], spc[ITEMS], valid[ITEMS];
    int bucket[ITEMS], first[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      row[j] = tile * TILE + (long long)j * THREADS + threadIdx.x;
      in[j] = row[j] < n;
      size[j] = in[j] ? cols[(long long)size_col * n + row[j]] : 0.f;
      spc[j] = in[j] ? cols[(long long)blocks_col * n + row[j]] : 0.f;
      valid[j] = (in[j] && valid_col >= 0)
                     ? cols[(long long)valid_col * n + row[j]] : 1.f;
      bucket[j] = size_bucket(size[j]);
      first[j] = -1;
    }
    if (VARIANT == 2) {            // every load of the tile, then the stores
      float x[ITEMS][MAX_REF];
#pragma unroll
      for (int j = 0; j < ITEMS; ++j)
#pragma unroll
        for (int c = 0; c < MAX_REF; ++c)
          x[j][c] = (c < n_ref && in[j])
                        ? __ldg(cols + (long long)s_ref[1 + c] * n + row[j])
                        : 0.f;
#pragma unroll
      for (int j = 0; j < ITEMS; ++j)
#pragma unroll
        for (int c = 0; c < MAX_REF; ++c)
          if (c < n_ref) s_x[c * TILE + j * THREADS + threadIdx.x] = x[j][c];
    }
    for (int r = 0; r < n_progs; ++r) {
      const int* ops = s_ops + r * n_instr;
      const int* cix = s_col + r * n_instr;
      const int* slots = s_slot + r * n_instr;
      const float* opr = s_opr + r * n_instr;
      float acc[N_AGG];
#pragma unroll
      for (int k = 0; k < N_AGG; ++k) acc[k] = 0.f;
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        if (!in[j]) continue;
        const float m =
            static_cast<float>(eval_row(cols, n, n_cols, row[j], ops, cix,
                                        slots, s_x, j * THREADS + threadIdx.x,
                                        opr, n_instr)) * valid[j];
        masks[(long long)r * n + row[j]] = m;
        if (r >= 1 && first[j] < 0 && m > 0.5f) first[j] = r - 1;
        if (VARIANT != 1) {
          acc[0] += m;
          acc[1] += m * size[j];
          acc[2] += m * spc[j];
#pragma unroll
          for (int k = 0; k < N_BUCKETS; ++k)
            acc[3 + k] += bucket[j] == k ? m : 0.f;
          acc[N_AGG - 1] = fmaxf(acc[N_AGG - 1], m);
        }
      }
      if (VARIANT != 1) {
#pragma unroll
        for (int k = 0; k < N_AGG; ++k) {
          const float v =
              k == N_AGG - 1 ? warp_max(acc[k]) : warp_sum(acc[k]);
          if (lane == 0) s_red[warp * N_AGG + k] = v;
        }
        __syncthreads();
        if (threadIdx.x < N_AGG) {
          const int k = threadIdx.x;
          const bool is_max = k == N_AGG - 1;
          float s = s_red[k];
          for (int w = 1; w < WARPS; ++w) {
            const float p = s_red[w * N_AGG + k];
            s = is_max ? fmaxf(s, p) : s + p;
          }
          float* dst = s_acc + r * N_AGG + k;
          *dst = is_max ? fmaxf(*dst, s) : *dst + s;
        }
        __syncthreads();
      }
    }
    if (rule != nullptr) {
#pragma unroll
      for (int j = 0; j < ITEMS; ++j)
        if (in[j]) rule[row[j]] = first[j];
    }
  }
  for (int i = threadIdx.x; i < n_progs * N_AGG; i += THREADS)
    partials[(long long)blockIdx.x * n_progs * N_AGG + i] = s_acc[i];
}

__global__ void __launch_bounds__(THREADS) reduce_kernel(
    const float* __restrict__ partials, int n_blocks, int width,
    float* __restrict__ agg) {
  __shared__ float s[THREADS];
  const int slot = blockIdx.x;
  const bool is_max = slot % N_AGG == N_AGG - 1;
  float v = 0.f;
  for (int b = threadIdx.x; b < n_blocks; b += THREADS) {
    const float p = partials[(long long)b * width + slot];
    v = is_max ? fmaxf(v, p) : v + p;
  }
  s[threadIdx.x] = v;
  __syncthreads();
  for (int h = THREADS / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) {
      const float p = s[threadIdx.x + h];
      s[threadIdx.x] = is_max ? fmaxf(s[threadIdx.x], p) : s[threadIdx.x] + p;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) agg[slot] = s[0];
}

size_t shared_bytes(int n_progs, int n_instr) {
  const size_t rp = static_cast<size_t>(n_progs) * n_instr;
  return sizeof(float) * (3 * rp + WARPS * N_AGG +
                          static_cast<size_t>(n_progs) * N_AGG + rp +
                          MAX_REF + 1 +
                          (VARIANT == 2 ? MAX_REF * TILE : 0));
}

}  // namespace policy_scan

extern "C" {

int policy_scan_tile_rows() { return policy_scan::TILE; }

const char* policy_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int policy_scan_occupancy(int n_progs, int n_instr) {
  using namespace policy_scan;
  const size_t smem = shared_bytes(n_progs, n_instr);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(scan_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, scan_kernel,
                                                    THREADS, smem) !=
      cudaSuccess)
    return -1;
  return blocks;
}

int policy_scan_launch(const float* cols, long long n, int n_cols,
                       const int* ops, const int* colidx,
                       const float* operands, int n_progs, int n_instr,
                       int size_col, int blocks_col, int valid_col,
                       float* masks, int* rule, float* partials, float* agg,
                       int grid, void* stream) {
  using namespace policy_scan;
  const size_t smem = shared_bytes(n_progs, n_instr);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  scan_kernel<<<grid, THREADS, smem, s>>>(
      cols, n, n_cols, ops, colidx, operands, n_progs, n_instr, size_col,
      blocks_col, valid_col, masks, rule, partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_kernel<<<n_progs * N_AGG, THREADS, 0, s>>>(partials, grid,
                                                    n_progs * N_AGG, agg);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
