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
// R * 4 B of masks and 4 B of rule index. What kept the first kernel at a
// quarter of that bound was instruction issue: a per-(tile, program)
// reduction of 14 aggregates through warp shuffles and two __syncthreads
// (1.7 of its 6.1 ms at R = 4 on an H100), and an interpreter that re-read
// each program word for every row.
//
// Design:
//   - a block decodes its programs once into shared memory (policy_scan.cuh:
//     NOPs dropped, stack positions worked out), and each thread runs a
//     program on its rows of a stage together, one decoded word for all of
//     them;
//   - aggregates stay in registers across the whole grid-stride loop, with
//     no barrier and no shuffle inside it: per 32 rows, one ballot per size
//     bucket shared by all programs, and per program one ballot of its mask;
//     lane k owns bucket k and adds popc(mask & bucket_k), so counts and the
//     histogram are exact integers; volume and spc_used are summed per lane
//     in f64 (exact on integer values below 2^53). A block reduces them once
//     at the end in a fixed order, and reduce_kernel sums the blocks in a
//     fixed order and casts once to f32: the same bits from run to run, and
//     program r's bits do not depend on R or on the other programs of the
//     launch (the grid depends on N and the card only, and a thread meets
//     its rows in one order whatever the stage shape);
//   - R is a template parameter up to MAX_PASS; more programs run in passes
//     of MAX_PASS, the rule index carried from pass to pass through `rule`;
//   - the columns a pass reads (stage_plan: size, blocks, valid and every
//     column a live compare reads) are worked out by each block from its
//     programs, so the host passes no plan and waits for nothing. They are
//     staged a stage at a time in shared memory by 1-D TMA bulk copies
//     (cp.async.bulk) issued by one producer thread into a ring of up to 4
//     stages, an mbarrier pair a stage (full: bytes landed; empty: every
//     consumer warp done), so a block keeps several stages of every column
//     in flight while its consumer warps interpret the one before. A stage
//     is a whole tile, or a half or a quarter of one when the columns are
//     too many for 2 whole tiles (ring_shape); every column of the table
//     fits a quarter-tile stage, so every value is read from shared memory.
//     The grid is persistent (blocks an SM from the occupancy API);
//   - a column whose start is not 16 B aligned (n % 4 != 0, or a view that
//     starts inside its storage) is copied from the 16 B boundary before
//     its first row of the stage (`shift` floats), and the ragged last
//     stage from there to the boundary after its last row, so a copy reads
//     no 16 B chunk that holds none of the tensor's rows;
//   - masks and rule index go out as coalesced streaming stores.
//
// The aggregates count a row when its mask m = bit * valid is not 0 and
// weight volume and spc_used by m: they equal the reference's sums of m
// when the validity column holds only 0 and 1, as a catalog's does.
#include <cuda_runtime.h>

#include "policy_scan.cuh"

namespace policy_scan {

constexpr int WARPS = THREADS / 32;
constexpr int BLOCK = THREADS + 32;      // and one producer warp
constexpr int MAX_PASS = 8;              // programs a pass
// a block's shared memory besides the ring (barriers, plan, programs,
// sums) that the grid leaves room for: 2 blocks an SM
constexpr int EXTRA_BYTES = 8 * 1024;
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}" ::"r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.b32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One contiguous global segment into shared memory, its bytes counted on
// `bar` (16 B aligned at both ends, a multiple of 16 B long).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__host__ __device__ constexpr size_t align8(size_t x) {
  return (x + 7) & ~static_cast<size_t>(7);
}

// Byte offsets of the dynamic shared memory of one launch: the ring first,
// then the barriers, the plan (staged columns; where each column is in a
// stage; the read set), the per-warp sums and the decoded programs.
struct Layout {
  size_t bars, stage, where, seen, n_stage, vol, spc, hist, code, opr, len,
      final_, total;
  __host__ __device__ Layout(int r, int n_instr) {
    bars = sizeof(float) * RING_FLOATS;
    stage = bars + 2 * sizeof(uint64_t) * MAX_STAGES;
    where = stage + sizeof(int) * MAX_COLS;
    seen = where + sizeof(int) * MAX_COLS;
    n_stage = seen + sizeof(uint32_t) * SEEN_WORDS;
    vol = align8(n_stage + sizeof(int));
    spc = vol + sizeof(double) * WARPS * r;
    hist = spc + sizeof(double) * WARPS * r;
    code = hist + sizeof(uint32_t) * WARPS * r * N_BUCKETS;
    opr = code + sizeof(uint32_t) * r * n_instr;
    len = opr + sizeof(float) * r * n_instr;
    final_ = len + sizeof(int) * r;
    total = final_ + sizeof(int) * r;
  }
};

// One stage of a consumer thread: its J rows from row0 (row0 + j * THREADS
// + tid), every program of the pass. The stage's column at offset o holds
// row row0 + i at seg[o + i]. Rows >= n are masked.
template <int R, int J>
__device__ __forceinline__ void scan_stage(
    long long n, long long row0, const float* seg, const uint32_t* s_code,
    const float* s_opr, const int* s_len, const int* s_final, int n_instr,
    int prog0, int size_at, int blocks_at, int valid_at, bool has_valid,
    float* __restrict__ masks, int* __restrict__ rule, uint32_t (&hist)[R],
    double (&vol)[R], double (&spc)[R]) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  bool in[J];
  float size[J], blocks[J], valid[J];
  uint32_t mine[J];           // rows of this warp's 32 in bucket `lane`
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int local = j * THREADS + tid;
    in[j] = row0 + local < n;
    size[j] = in[j] ? seg[size_at + local] : 0.f;
    blocks[j] = in[j] ? seg[blocks_at + local] : 0.f;
    valid[j] = (in[j] && has_valid) ? seg[valid_at + local] : 1.f;
    // lane k < 10 builds bucket k's mask from 4 ballots of the bucket's
    // bits (a row past n has bucket 15, in no lane's mask)
    const int bucket = in[j] ? size_bucket(size[j]) : 15;
    uint32_t m = lane < N_BUCKETS ? FULL_MASK : 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t b = __ballot_sync(FULL_MASK, (bucket >> i) & 1);
      m &= ((lane >> i) & 1) ? b : ~b;
    }
    mine[j] = m;
  }
  // every program on the J rows: bit r of bits[j] is program r's
  uint32_t bits[J];
#pragma unroll
  for (int j = 0; j < J; ++j) bits[j] = 0u;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    uint32_t bit[J];
    const int base = r * n_instr;
    eval_program(s_code + base, s_opr + base, s_len[r], s_final[r],
                 [&](int j, int at) { return seg[at + j * THREADS + tid]; },
                 bit);
#pragma unroll
    for (int j = 0; j < J; ++j) bits[j] |= bit[j] << r;
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const long long row = row0 + j * THREADS + tid;
    const double size_d = size[j], blocks_d = blocks[j];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float m = in[j] ? static_cast<float>((bits[j] >> r) & 1u) *
                                  valid[j]
                            : 0.f;
      if (in[j]) __stcs(masks + (prog0 + r) * n + row, m);
      const uint32_t set = __ballot_sync(FULL_MASK, m != 0.f);
      hist[r] += __popc(set & mine[j]);
      const double md = m;
      vol[r] = fma(md, size_d, vol[r]);
      spc[r] = fma(md, blocks_d, spc[r]);
    }
    if (rule != nullptr && in[j]) {
      // the first program r >= 1 with m > 0.5 gives rule r - 1; a later
      // pass continues the attribution of the passes before it
      uint32_t hit = valid[j] > 0.5f ? bits[j] : 0u;
      if (prog0 == 0) hit &= ~1u;
      int first = prog0 > 0 ? rule[row] : -1;
      if (first < 0 && hit != 0u) first = prog0 + __ffs(hit) - 2;
      __stcs(rule + row, first);
    }
  }
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

// The stages of a tile in order: (tile, q) for q < ITEMS / items, while a
// row of the stage is below n. The producer and the consumers walk the same
// sequence through the ring's slots s = 0, 1, ..., stages - 1, 0, ..., the
// barriers' phase flipping at each wrap.
#define FOR_EACH_STAGE(items)                                              \
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)     \
    for (int q = 0; q < ITEMS / (items); ++q)                              \
      if (const long long row0 = tile * TILE +                             \
                                 static_cast<long long>(q) * (items) *     \
                                     THREADS;                              \
          row0 < n)

// A consumer warp's whole scan with J rows a thread a stage, then its
// per-warp sums into shared memory.
template <int R, int J>
__device__ __forceinline__ void consume(
    long long n, const float* ring, const Ring& g, int n_stage,
    uint64_t* full, uint64_t* empty, const uint32_t* s_code,
    const float* s_opr, const int* s_len, const int* s_final, int n_instr,
    int prog0, int size_at, int blocks_at, int valid_at, bool has_valid,
    float* __restrict__ masks, int* __restrict__ rule, double* s_vol,
    double* s_spc, uint32_t* s_hist) {
  const int tid = threadIdx.x;
  const long long n_tiles = (n + TILE - 1) / TILE;
  const int stage_floats = n_stage * g.seg;
  uint32_t hist[R];
  double vol[R], spc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    hist[r] = 0u;
    vol[r] = 0.0;
    spc[r] = 0.0;
  }
  int s = 0;
  uint32_t phase = 0;
  FOR_EACH_STAGE(J) {
    mbar_wait(&full[s], phase);
    scan_stage<R, J>(n, row0, ring + s * stage_floats, s_code, s_opr, s_len,
                     s_final, n_instr, prog0, size_at, blocks_at, valid_at,
                     has_valid, masks, rule, hist, vol, spc);
    __syncwarp();                      // the warp is done with stage s
    if ((tid & 31) == 0) mbar_arrive(&empty[s]);
    if (++s == g.stages) {
      s = 0;
      phase ^= 1u;
    }
  }
  // once a block, in a fixed order: lanes (a shuffle tree), then warps
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const double v = warp_sum(vol[r]), p = warp_sum(spc[r]);
    if (lane == 0) {
      s_vol[warp * R + r] = v;
      s_spc[warp * R + r] = p;
    }
    if (lane < N_BUCKETS) s_hist[(warp * R + r) * N_BUCKETS + lane] = hist[r];
  }
}

// consume for part-tile stages (wide column sets), out of line: inlined
// beside the whole-tile path it cost that path registers and spills.
template <int R, int J>
__device__ __noinline__ void consume_far(
    long long n, const float* ring, const Ring& g, int n_stage,
    uint64_t* full, uint64_t* empty, const uint32_t* s_code,
    const float* s_opr, const int* s_len, const int* s_final, int n_instr,
    int prog0, int size_at, int blocks_at, int valid_at, bool has_valid,
    float* __restrict__ masks, int* __restrict__ rule, double* s_vol,
    double* s_spc, uint32_t* s_hist) {
  consume<R, J>(n, ring, g, n_stage, full, empty, s_code, s_opr, s_len,
                s_final, n_instr, prog0, size_at, blocks_at, valid_at,
                has_valid, masks, rule, s_vol, s_spc, s_hist);
}

// Programs prog0 .. prog0+R-1 of n_progs over all rows. partials: per
// (block, program) 14 words: volume and spc_used as f64, then the 10
// bucket counts as u32.
template <int R>
__global__ void __launch_bounds__(BLOCK, 2) scan_kernel(
    const float* __restrict__ cols, long long n, int n_cols,
    const int* __restrict__ g_ops, const int* __restrict__ g_colidx,
    const float* __restrict__ g_operands, int n_instr, int prog0,
    int n_progs, int size_col, int blocks_col, int valid_col,
    float* __restrict__ masks, int* __restrict__ rule,
    uint32_t* __restrict__ partials) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay(R, n_instr);
  float* ring = reinterpret_cast<float*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + MAX_STAGES;
  int* s_stage = reinterpret_cast<int*>(smem + lay.stage);
  int* s_where = reinterpret_cast<int*>(smem + lay.where);
  uint32_t* s_seen = reinterpret_cast<uint32_t*>(smem + lay.seen);
  int* s_n_stage = reinterpret_cast<int*>(smem + lay.n_stage);
  double* s_vol = reinterpret_cast<double*>(smem + lay.vol);
  double* s_spc = reinterpret_cast<double*>(smem + lay.spc);
  uint32_t* s_hist = reinterpret_cast<uint32_t*>(smem + lay.hist);
  uint32_t* s_code = reinterpret_cast<uint32_t*>(smem + lay.code);
  float* s_opr = reinterpret_cast<float*>(smem + lay.opr);
  int* s_len = reinterpret_cast<int*>(smem + lay.len);
  int* s_final = reinterpret_cast<int*>(smem + lay.final_);
  const int tid = threadIdx.x;

  // the plan: the columns the pass's live compares read, by every thread
  if (tid < SEEN_WORDS) s_seen[tid] = 0u;
  __syncthreads();
  const long long at0 = static_cast<long long>(prog0) * n_instr;
  for (int i = tid; i < R * n_instr; i += BLOCK) {
    const int c = compare_col(g_ops[at0 + i], g_colidx[at0 + i], n_cols);
    if (c >= 0) atomicOr(&s_seen[c >> 5], 1u << (c & 31));
  }
  __syncthreads();
  if (tid == 0)
    *s_n_stage = stage_list(s_seen, size_col, blocks_col, valid_col, s_stage);
  __syncthreads();
  const int n_stage = *s_n_stage;
  const Ring g = ring_shape(n_stage);
  if (tid < n_stage) {
    // where column s_stage[tid] sits in a stage: its segment, then the
    // floats its copy starts before its first row (stages start at
    // multiples of THREADS rows, so the shift is the same for every stage)
    const int col = s_stage[tid];
    const int shift = static_cast<int>(
        reinterpret_cast<uintptr_t>(cols + col * n) % 16 / sizeof(float));
    s_where[col] = tid * g.seg + shift;
  }
  if (tid == THREADS) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  if (tid < R) {
    const long long at = static_cast<long long>(prog0 + tid) * n_instr;
    s_len[tid] = decode_program(g_ops + at, g_colidx + at, g_operands + at,
                                n_instr, n_cols, s_where,
                                s_code + tid * n_instr,
                                s_opr + tid * n_instr, &s_final[tid]);
  }
  __syncthreads();

  if (tid >= THREADS) {                          // the producer warp
    if (tid == THREADS) {
      const long long n_tiles = (n + TILE - 1) / TILE;
      const int rows_max = g.items * THREADS;
      int s = 0;
      uint32_t phase = 0;
      bool wrapped = false;
      FOR_EACH_STAGE(g.items) {
        if (wrapped) mbar_wait(&empty[s], phase ^ 1u);
        // each column's copy starts at the 16 B boundary at or before its
        // first row and ends at the one at or after its last, so it reads
        // no 16 B chunk without a row in it
        const int rows = n - row0 < rows_max ? static_cast<int>(n - row0)
                                             : rows_max;
        float* dst = ring + s * n_stage * g.seg;
        uint32_t tx = 0;
        for (int c = 0; c < n_stage; ++c)
          tx += ((s_where[s_stage[c]] - c * g.seg + rows + 3) / 4) * 16;
        mbar_expect_tx(&full[s], tx);
        for (int c = 0; c < n_stage; ++c) {
          const int shift = s_where[s_stage[c]] - c * g.seg;
          bulk_load(dst + c * g.seg, cols + s_stage[c] * n + row0 - shift,
                    static_cast<uint32_t>((shift + rows + 3) / 4) * 16,
                    &full[s]);
        }
        if (++s == g.stages) {
          s = 0;
          phase ^= 1u;
          wrapped = true;
        }
      }
    }
    __syncwarp();
  } else {                                       // the consumer warps
    const bool has_valid = valid_col >= 0;
    const int size_at = s_where[size_col], blocks_at = s_where[blocks_col];
    const int valid_at = has_valid ? s_where[valid_col] : 0;
#define PS_ARGS                                                             \
  n, ring, g, n_stage, full, empty, s_code, s_opr, s_len, s_final, n_instr, \
      prog0, size_at, blocks_at, valid_at, has_valid, masks, rule, s_vol,   \
      s_spc, s_hist
    if (g.items == ITEMS)
      consume<R, ITEMS>(PS_ARGS);
    else if (g.items == ITEMS / 2)
      consume_far<R, ITEMS / 2>(PS_ARGS);
    else
      consume_far<R, 1>(PS_ARGS);
#undef PS_ARGS
    __syncwarp();
  }
  __syncthreads();
  if (tid < R * (N_BUCKETS + 2)) {
    const int r = tid / (N_BUCKETS + 2), f = tid % (N_BUCKETS + 2);
    const long long slot =
        static_cast<long long>(blockIdx.x) * n_progs + prog0 + r;
    uint32_t* out = partials + slot * N_AGG;
    if (f < N_BUCKETS) {
      uint32_t c = 0;
      for (int w = 0; w < WARPS; ++w) c += s_hist[(w * R + r) * N_BUCKETS + f];
      out[4 + f] = c;
    } else {
      const double* src = f == N_BUCKETS ? s_vol : s_spc;
      double v = 0.0;
      for (int w = 0; w < WARPS; ++w) v += src[w * R + r];
      reinterpret_cast<double*>(out)[f - N_BUCKETS] = v;
    }
  }
}
#undef FOR_EACH_STAGE

// One block per program: the blocks' partials summed in a fixed order
// (a strided walk, then a tree), cast once to f32. count is the sum of the
// bucket counts (every row lies in one bucket), any_match is count > 0.
__global__ void __launch_bounds__(THREADS) reduce_kernel(
    const uint32_t* __restrict__ partials, int n_blocks, int n_progs,
    float* __restrict__ agg) {
  __shared__ unsigned long long s_hist[N_BUCKETS][THREADS];
  __shared__ double s_sum[2][THREADS];
  const int r = blockIdx.x, t = threadIdx.x;
  unsigned long long h[N_BUCKETS] = {};
  double sum[2] = {0.0, 0.0};
  for (int b = t; b < n_blocks; b += THREADS) {
    const uint32_t* p = partials + (static_cast<long long>(b) * n_progs + r) *
                                       N_AGG;
    sum[0] += reinterpret_cast<const double*>(p)[0];
    sum[1] += reinterpret_cast<const double*>(p)[1];
#pragma unroll
    for (int k = 0; k < N_BUCKETS; ++k) h[k] += p[4 + k];
  }
#pragma unroll
  for (int k = 0; k < N_BUCKETS; ++k) s_hist[k][t] = h[k];
  s_sum[0][t] = sum[0];
  s_sum[1][t] = sum[1];
  __syncthreads();
  for (int half = THREADS / 2; half > 0; half >>= 1) {
    if (t < half) {
#pragma unroll
      for (int k = 0; k < N_BUCKETS; ++k) s_hist[k][t] += s_hist[k][t + half];
      s_sum[0][t] += s_sum[0][t + half];
      s_sum[1][t] += s_sum[1][t + half];
    }
    __syncthreads();
  }
  if (t == 0) {
    float* out = agg + r * N_AGG;
    unsigned long long count = 0;
    for (int k = 0; k < N_BUCKETS; ++k) {
      count += s_hist[k][0];
      out[3 + k] = static_cast<float>(s_hist[k][0]);
    }
    out[0] = static_cast<float>(count);
    out[1] = static_cast<float>(s_sum[0][0]);
    out[2] = static_cast<float>(s_sum[1][0]);
    out[N_AGG - 1] = count > 0 ? 1.f : 0.f;
  }
}

template <int R>
cudaError_t launch_pass(const float* cols, long long n, int n_cols,
                        const int* ops, const int* colidx,
                        const float* operands, int n_instr, int prog0,
                        int n_progs, int size_col, int blocks_col,
                        int valid_col, float* masks, int* rule,
                        uint32_t* partials, int grid, cudaStream_t s) {
  const size_t smem = Layout(R, n_instr).total;
  const cudaError_t e = cudaFuncSetAttribute(
      scan_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  scan_kernel<R><<<grid, BLOCK, smem, s>>>(
      cols, n, n_cols, ops, colidx, operands, n_instr, prog0, n_progs,
      size_col, blocks_col, valid_col, masks, rule, partials);
  return cudaGetLastError();
}

using PassFn = cudaError_t (*)(const float*, long long, int, const int*,
                               const int*, const float*, int, int, int, int,
                               int, int, float*, int*, uint32_t*, int,
                               cudaStream_t);
constexpr PassFn PASSES[MAX_PASS] = {
    launch_pass<1>, launch_pass<2>, launch_pass<3>, launch_pass<4>,
    launch_pass<5>, launch_pass<6>, launch_pass<7>, launch_pass<8>};

const void* const KERNELS[MAX_PASS] = {
    (const void*)scan_kernel<1>, (const void*)scan_kernel<2>,
    (const void*)scan_kernel<3>, (const void*)scan_kernel<4>,
    (const void*)scan_kernel<5>, (const void*)scan_kernel<6>,
    (const void*)scan_kernel<7>, (const void*)scan_kernel<8>};

// Resident blocks an SM of the pass of r programs with smem bytes of
// dynamic shared memory; -1 on error.
int occupancy(int r, size_t smem) {
  const void* k = KERNELS[r - 1];
  if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, BLOCK,
                                                    smem) != cudaSuccess)
    return -1;
  return blocks;
}

}  // namespace policy_scan

extern "C" {

int policy_scan_tile_rows() { return policy_scan::TILE; }

const char* policy_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int policy_scan_max_cols() { return policy_scan::MAX_COLS; }

// The plan a block of a pass over programs (ops, colidx)[0:count] (host
// memory) makes: the staged columns into stage[0:MAX_COLS] (returns their
// number), the rows of a stage and the ring's stages.
int policy_scan_plan(const int* ops, const int* colidx, int count,
                     int n_cols, int size_col, int blocks_col, int valid_col,
                     int* stage, int* stage_rows, int* stages) {
  using namespace policy_scan;
  const int n = stage_plan(ops, colidx, count, n_cols, size_col, blocks_col,
                           valid_col, stage);
  const Ring g = ring_shape(n);
  *stage_rows = g.items * THREADS;
  *stages = g.stages;
  return n;
}

// The persistent grid for n rows on a card of `sms` SMs: every SM's
// resident blocks of the widest pass (MAX_PASS programs, EXTRA_BYTES for
// its programs and sums), fewer when there are fewer tiles. It depends on
// n and the card alone, never on the programs, so each program's sums
// group rows alike in every launch. -1 on error.
int policy_scan_grid(long long n, int sms) {
  using namespace policy_scan;
  static int per_sm = 0;
  if (per_sm <= 0)
    per_sm = occupancy(MAX_PASS, sizeof(float) * RING_FLOATS + EXTRA_BYTES);
  if (per_sm <= 0) return -1;
  const long long tiles = (n + TILE - 1) / TILE;
  const long long grid = static_cast<long long>(sms) * per_sm;
  return static_cast<int>(tiles < grid ? (tiles > 0 ? tiles : 1) : grid);
}

// Resident blocks an SM of a launch of n_progs programs of n_instr words
// (its widest pass); -1 on error.
int policy_scan_occupancy(int n_progs, int n_instr) {
  using namespace policy_scan;
  const int r = n_progs < MAX_PASS ? n_progs : MAX_PASS;
  return occupancy(r, Layout(r, n_instr).total);
}

// Launches the scan (in passes of at most MAX_PASS programs) and the block
// reduction on `stream`. `rule` may be null (single-program form).
// `partials` holds grid * n_progs * 14 words (f64 sums, u32 counts); grid
// is policy_scan_grid's. cols has at most MAX_COLS columns. Each block
// works out from the programs which columns it stages. The aggregates
// equal the reference's when the validity column holds only 0 and 1.
// Returns cudaGetLastError() after the launches: 0 when all were accepted.
int policy_scan_launch(const float* cols, long long n, int n_cols,
                       const int* ops, const int* colidx,
                       const float* operands, int n_progs, int n_instr,
                       int size_col, int blocks_col, int valid_col,
                       float* masks, int* rule, float* partials, float* agg,
                       int grid, void* stream) {
  using namespace policy_scan;
  if (n_cols < 1 || n_cols > MAX_COLS ||
      reinterpret_cast<uintptr_t>(cols) % sizeof(float) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* part = reinterpret_cast<uint32_t*>(partials);
  for (int p0 = 0; p0 < n_progs; p0 += MAX_PASS) {
    const int r = n_progs - p0 < MAX_PASS ? n_progs - p0 : MAX_PASS;
    const cudaError_t e = PASSES[r - 1](
        cols, n, n_cols, ops, colidx, operands, n_instr, p0, n_progs,
        size_col, blocks_col, valid_col, masks, rule, part, grid, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  reduce_kernel<<<n_progs, THREADS, 0, s>>>(part, grid, n_progs, agg);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
