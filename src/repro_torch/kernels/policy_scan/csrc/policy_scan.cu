// policy_scan for Hopper (sm_90a): R postfix predicate programs over a
// column-major f32 table, with first-match-wins rule attribution and
// per-program aggregates, in one pass over the rows.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/policy_scan/kernel.py:
//   policy_scan_batch_pallas (_policy_scan_batch_kernel) -> R programs,
//     rule index over programs 1..R-1;
//   policy_scan_pallas (_policy_scan_kernel) -> the same launch with R = 1
//     and no attribution (rule == nullptr).
//
// Bound on this card: bytes. Per row the scan reads the columns its
// programs reference plus size, blocks and valid (4 B each) and writes
// R * 4 B of masks and 4 B of rule index; the arithmetic, a few integer
// and f32 operations per instruction and ~15 per program for the
// aggregates, sits far below the card's rate at that traffic.
//
// Design (a simple, correct first kernel; TMA, cp.async or persistent
// blocks are later work):
//   - the (R, P) program batch is loaded once per block into shared memory;
//   - each thread takes ITEMS rows of a TILE-row tile, tiles in a
//     grid-stride loop; column c of row i is cols[c * n + i], so a warp's
//     loads are coalesced; the ragged last tile is masked here, so the
//     caller does not pad;
//   - a row's 8-deep stack is a bit-stack in one register (policy_scan.cuh);
//   - aggregates: warp shuffles, then shared memory, per (tile, program),
//     summed into a per-block accumulator in tile order and written as
//     partials (n_blocks, R, 14); a second kernel reduces them over blocks
//     in a fixed tree order (sum for slots 0-12, max for slot 13). No
//     atomics, so the sums are the same from run to run. (On the TPU the
//     grid is sequential and carries the sum across steps; here blocks run
//     in no order.)
#include <cuda_runtime.h>

#include "policy_scan.cuh"

namespace policy_scan {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 4;
constexpr int TILE = THREADS * ITEMS;

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

  for (int i = threadIdx.x; i < rp; i += THREADS) {
    s_ops[i] = g_ops[i];
    s_col[i] = g_colidx[i];
    s_opr[i] = g_operands[i];
  }
  for (int i = threadIdx.x; i < n_progs * N_AGG; i += THREADS) s_acc[i] = 0.f;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long n_tiles = (n + TILE - 1) / TILE;
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
    for (int r = 0; r < n_progs; ++r) {
      const int* ops = s_ops + r * n_instr;
      const int* cix = s_col + r * n_instr;
      const float* opr = s_opr + r * n_instr;
      float acc[N_AGG];
#pragma unroll
      for (int k = 0; k < N_AGG; ++k) acc[k] = 0.f;
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        if (!in[j]) continue;
        const float m =
            static_cast<float>(eval_row(cols, n, n_cols, row[j], ops, cix,
                                        opr, n_instr)) * valid[j];
        masks[(long long)r * n + row[j]] = m;
        if (r >= 1 && first[j] < 0 && m > 0.5f) first[j] = r - 1;
        acc[0] += m;
        acc[1] += m * size[j];
        acc[2] += m * spc[j];
#pragma unroll
        for (int k = 0; k < N_BUCKETS; ++k)
          acc[3 + k] += bucket[j] == k ? m : 0.f;
        acc[N_AGG - 1] = fmaxf(acc[N_AGG - 1], m);
      }
#pragma unroll
      for (int k = 0; k < N_AGG; ++k) {
        const float v = k == N_AGG - 1 ? warp_max(acc[k]) : warp_sum(acc[k]);
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
    if (rule != nullptr) {
#pragma unroll
      for (int j = 0; j < ITEMS; ++j)
        if (in[j]) rule[row[j]] = first[j];
    }
  }
  for (int i = threadIdx.x; i < n_progs * N_AGG; i += THREADS)
    partials[(long long)blockIdx.x * n_progs * N_AGG + i] = s_acc[i];
}

// One block per output slot (program r, aggregate k): a fixed-order tree
// over the n_blocks partials.
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

}  // namespace policy_scan

extern "C" {

int policy_scan_tile_rows() { return policy_scan::TILE; }

const char* policy_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the scan and the block reduction on `stream`. `rule` may be null
// (single-program form). `partials` holds grid * n_progs * 14 floats. Returns
// cudaGetLastError() after the launches: 0 when both were accepted.
int policy_scan_launch(const float* cols, long long n, int n_cols,
                       const int* ops, const int* colidx,
                       const float* operands, int n_progs, int n_instr,
                       int size_col, int blocks_col, int valid_col,
                       float* masks, int* rule, float* partials, float* agg,
                       int grid, void* stream) {
  using namespace policy_scan;
  const size_t smem =
      sizeof(float) * (3 * static_cast<size_t>(n_progs) * n_instr +
                       WARPS * N_AGG + static_cast<size_t>(n_progs) * N_AGG);
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
