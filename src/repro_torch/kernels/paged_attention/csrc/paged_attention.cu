// paged_attention for Hopper (sm_90a): decode attention of one query token
// per sequence over K/V pages reached through a page table, with grouped
// query heads, an online softmax in f32 and the output in the input dtype.
//
// Replaces the Pallas TPU kernel paged_attention (_paged_attn_kernel) of
// src/repro/kernels/paged_attention/kernel.py. That kernel runs a
// sequential (B, max_pages) grid: the page id is looked up by the BlockSpec
// index map (scalar prefetch), a whole (P, K, hd) page lands in VMEM, the
// K/V heads are repeated G times and (m, l, acc) are carried in scratch
// from one grid step to the next. Hopper blocks run in parallel and in no
// order, so here the page axis is split over blocks (flash-decoding) and a
// second kernel merges the splits.
//
// Bound on this card: bytes. Every K and V row a sequence's length covers
// is read once (2 * K * hd elements a position), against 4 * hd * H flops
// a position: about one flop a byte in f32, far under the card's balance.
// One block a sequence cannot fill 132 SMs, and the longest sequence would
// set the time; splitting the page axis gives every SM blocks to run.
//
// Design:
//   - the split kernel's grid is (B, K * ceil(G / 16), S_max): a block owns
//     a sequence b, a KV head kh, a group of up to 16 of the G query heads
//     that read kh (query head h reads KV head h / G, the interleaving of
//     jnp.repeat(k, G, axis=1)) and a split s;
//   - split s covers the sequence's readable pages s * PAGES_PER_SPLIT to
//     (s + 1) * PAGES_PER_SPLIT - 1, counted in table order. A page is
//     readable when its id lies in [0, n_pages) and its start under the
//     length; a -1 hole is never read and moves no split boundary, so a
//     table with a hole and the same pages packed give the same bits.
//     PAGES_PER_SPLIT is a constant and S_max = ceil(max_pages /
//     PAGES_PER_SPLIT) comes from the table's width on the host, so a
//     sequence's result does not depend on the batch, the other
//     sequences or the card. One warp finds the block's pages by scanning
//     the table row 32 slots at a time (ballot and popcount);
//   - inside a split each page's rows under the length are staged in tiles
//     in shared memory by every thread of the block, 16 bytes a load where
//     hd allows, and consumed in page order with the reference's online
//     softmax in f32: m starts at -1e30, l at 0, a score at or below
//     -0.5e30 weighs 0. f32 runs on CUDA cores (split_kernel, a warp a
//     query head, K and V widened to f32); bf16 on tensor cores
//     (mma_split_kernel, below: the block's 16 query heads are the rows of
//     mma.sync, K and V stay bf16 and each staged row is read once);
//   - each split writes its (m, l, acc[hd]) per query head in f32 to a
//     workspace (B, H, S_max, hd + 2); a block with no readable page writes
//     (-1e30, 0) and no acc. The combine kernel, a block per (b, h), merges
//     the splits in split order, without atomics: M = max m_s, out =
//     sum e^(m_s - M) acc_s / max(sum e^(m_s - M) l_s, 1e-20), skipping the
//     acc of a split whose l is 0 (that acc is exactly 0). A sequence with
//     no readable position outputs exact zeros, never NaN;
//   - when S_max is 1 the split kernel divides and writes the output itself
//     (the same bits the combine would give) and the combine is not
//     launched;
//   - sums run in a fixed order (rows in page order, fixed shuffles, warps
//     and splits in order), so the result repeats from run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace paged_attention {

constexpr int WARP = 32;
constexpr int MAX_HD = 256;
constexpr int DPL = MAX_HD / WARP;   // q / acc values a lane keeps
constexpr int HEADS_PER_BLOCK = 16;  // query heads a block computes
constexpr int MIN_WARPS = 4;         // warps a block has at least, to stage
constexpr int TILE_ROWS = 64;        // K/V rows staged at a time (bf16)
constexpr int F32_TILE_ROWS = 32;    // K/V rows staged at a time (f32)
constexpr int F32_MIN_BLOCKS = 2;    // f32 blocks an SM must fit (registers)
constexpr int PAGES_PER_SPLIT = 8;   // readable pages a split covers
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e30f;        // the reference's mask value
constexpr float CUT = -0.5e30f;      // scores at or below weigh 0

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = WARP / 2; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = WARP / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The pages of split `split` of one sequence: warp 0 scans the table row
// 32 slots at a time; a slot is readable when its page id lies in
// [0, n_pages) and its start under `len`, and the readable slots are
// numbered in table order (ballot, popcount). Writes the slots and page ids
// of readable pages split * PAGES_PER_SPLIT .. + PAGES_PER_SPLIT - 1 to
// `slots` / `pids` and their count to `*count`; the caller syncs the block.
__device__ __forceinline__ void find_pages(const int* __restrict__ row,
                                           int len, int P, int n_pages,
                                           int max_pages, int split,
                                           int* slots, int* pids,
                                           int* count) {
  const int lane = threadIdx.x % WARP;
  const int lo = split * PAGES_PER_SPLIT, hi = lo + PAGES_PER_SPLIT;
  int seen = 0;                              // readable slots before j0
  for (int j0 = 0; j0 < max_pages && static_cast<long long>(j0) * P < len &&
                   seen < hi;
       j0 += WARP) {
    const int j = j0 + lane;
    int pid = -1;
    if (j < max_pages && static_cast<long long>(j) * P < len) pid = row[j];
    const bool ok = pid >= 0 && pid < n_pages;
    const unsigned mask = __ballot_sync(FULL, ok);
    const int r = seen + __popc(mask & ((1u << lane) - 1u));
    if (ok && r >= lo && r < hi) {
      slots[r - lo] = j;
      pids[r - lo] = pid;
    }
    seen += __popc(mask);
  }
  if (lane == 0) {
    const int n = seen - lo;
    *count = n < 0 ? 0 : (n > PAGES_PER_SPLIT ? PAGES_PER_SPLIT : n);
  }
}

// Stage `n` f32 rows of one KV head (row stride `stride` elements) into
// dst[n][ld] (ld >= hd, a multiple of 4). VEC: hd is a multiple of 4 and
// rows are 16-byte aligned, so each thread moves 16 bytes at a time.
template <bool VEC>
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const float* __restrict__ src, int n,
                                      long long stride, int hd, int ld) {
  if constexpr (VEC) {
    const int per_row = hd / 4;
#pragma unroll 4
    for (int i = threadIdx.x; i < n * per_row; i += blockDim.x) {
      const int r = i / per_row, c = (i - r * per_row) * 4;
      *reinterpret_cast<float4*>(dst + r * ld + c) =
          *reinterpret_cast<const float4*>(src + r * stride + c);
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < n * hd; i += blockDim.x) {
      const int r = i / hd, c = i - r * hd;
      dst[r * ld + c] = src[r * stride + c];
    }
  }
}

// Shared-memory row length for head_dim hd: a multiple of 4 floats whose
// quarter is odd, so the 16-byte reads of 8 lanes on 8 different rows fall
// in 8 different bank groups.
__host__ __device__ __forceinline__ int row_ld(int hd) {
  const int ld = (hd + 3) / 4 * 4;
  return (ld / 4) % 2 ? ld : ld + 4;
}

// Where a split's result goes: with one split, the output row in T;
// else the (m, l, acc[hd]) partial in the f32 workspace.
template <typename T>
struct Sink {
  T* out;
  float* work;
  int n_splits, hd;
  // the partial of (sequence b, query head h, split s)
  __device__ __forceinline__ float* partial(int b, int H, int h,
                                            int s) const {
    return work +
           ((static_cast<long long>(b) * H + h) * n_splits + s) * (hd + 2);
  }
};

// f32 on CUDA cores. Tiles of up to F32_TILE_ROWS rows of this head's K
// and V (f32 in shared memory, rows padded against bank conflicts; over
// the default 48 KB the launch opts in); every warp of the block (at least
// four) helps to stage. One warp per query head, its q row (pre-divided by
// sqrt(hd)) in shared memory; per chunk of 32 rows each lane scores one
// row (a whole dot product in four partial sums), then the warp updates m,
// l and acc (each lane holding hd / 32 of acc). Registers are capped so an
// SM holds F32_MIN_BLOCKS blocks of 16 warps.
template <bool VEC>
__global__ void __launch_bounds__(WARP * HEADS_PER_BLOCK, F32_MIN_BLOCKS)
split_kernel(const float* __restrict__ q, const float* __restrict__ k_pages,
             const float* __restrict__ v_pages,
             const int* __restrict__ page_table,
             const int* __restrict__ lengths, Sink<float> sink, int H, int K,
             int hd, int P, int n_pages, int max_pages) {
  extern __shared__ float smem[];
  __shared__ int slots[PAGES_PER_SPLIT], pids[PAGES_PER_SPLIT], n_mine;
  const int tile = P < F32_TILE_ROWS ? P : F32_TILE_ROWS;
  const int ld = row_ld(hd);
  float* ks = smem;                      // [tile][ld]
  float* vs = ks + tile * ld;            // [tile][ld]
  float* qs = vs + tile * ld;            // [warps computing][ld]

  const int G = H / K;
  const int groups = (G + HEADS_PER_BLOCK - 1) / HEADS_PER_BLOCK;
  const int b = blockIdx.x, kh = blockIdx.y / groups, split = blockIdx.z;
  const int h0 = (blockIdx.y - kh * groups) * HEADS_PER_BLOCK;
  const int rest = G - h0;
  const int n_heads = rest < HEADS_PER_BLOCK ? rest : HEADS_PER_BLOCK;
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const bool computes = warp < n_heads;
  const int h = kh * G + h0 + warp;
  const int hd4 = hd & ~3;
  const int len = lengths[b];

  if (warp == 0)
    find_pages(page_table + static_cast<long long>(b) * max_pages, len, P,
               n_pages, max_pages, split, slots, pids, &n_mine);
  // this warp's query row, divided by sqrt(hd), in shared memory
  float* qw = qs + warp * ld;
  if (computes) {
    const float root = sqrtf(static_cast<float>(hd));
    for (int d = lane; d < hd; d += WARP)
      qw[d] = q[(static_cast<long long>(b) * H + h) * hd + d] / root;
  }
  __syncthreads();
  const int n_pg = n_mine;
  if (n_pg == 0 && sink.n_splits > 1) {      // past the readable pages
    if (computes && lane == 0) {
      float* part = sink.partial(b, H, h, split);
      part[0] = NEG;
      part[1] = 0.f;
    }
    return;
  }

  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
  float m = NEG, l = 0.f;

  const long long stride = static_cast<long long>(K) * hd;  // row to row
  for (int pg = 0; pg < n_pg; ++pg) {
    const int start = slots[pg] * P;
    const int rows = len - start < P ? len - start : P;
    const long long base =
        (static_cast<long long>(pids[pg]) * P * K + kh) * hd;
    for (int r0 = 0; r0 < rows; r0 += tile) {
      const int n = rows - r0 < tile ? rows - r0 : tile;
      __syncthreads();                           // previous tile consumed
      stage<VEC>(ks, k_pages + base + r0 * stride, n, stride, hd, ld);
      stage<VEC>(vs, v_pages + base + r0 * stride, n, stride, hd, ld);
      __syncthreads();
      if (!computes) continue;
      for (int c0 = 0; c0 < n; c0 += WARP) {
        const int cn = n - c0 < WARP ? n - c0 : WARP;
        // lane t scores row c0 + t: a whole dot product, four partial
        // sums, q read as a broadcast
        float s = NEG;
        if (lane < cn) {
          const float* kr = ks + (c0 + lane) * ld;
          float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
          for (int d = 0; d < hd4; d += 4) {
            const float4 kv = *reinterpret_cast<const float4*>(kr + d);
            const float4 qv = *reinterpret_cast<const float4*>(qw + d);
            a0 = fmaf(qv.x, kv.x, a0);
            a1 = fmaf(qv.y, kv.y, a1);
            a2 = fmaf(qv.z, kv.z, a2);
            a3 = fmaf(qv.w, kv.w, a3);
          }
          for (int d = hd4; d < hd; ++d) a0 = fmaf(qw[d], kr[d], a0);
          s = (a0 + a1) + (a2 + a3);
        }
        const float m_new = fmaxf(m, warp_max(s));
        // the reference's cut: a score at or below -0.5e30 weighs nothing,
        // even at a position under the length
        const float p = (lane < cn && s > CUT) ? expf(s - m_new) : 0.f;
        const float corr = expf(m - m_new);
        l = l * corr + warp_sum(p);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[i] *= corr;
        for (int t = 0; t < cn; ++t) {
          const float pt = __shfl_sync(FULL, p, t);
          const float* vr = vs + (c0 + t) * ld;
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            const int d = lane + WARP * i;
            if (d < hd) acc[i] = fmaf(pt, vr[d], acc[i]);
          }
        }
        m = m_new;
      }
    }
  }

  if (!computes) return;
  if (sink.n_splits == 1) {
    const float denom = fmaxf(l, 1e-20f);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + WARP * i;
      if (d < hd)
        sink.out[(static_cast<long long>(b) * H + h) * hd + d] =
            acc[i] / denom;
    }
    return;
  }
  float* part = sink.partial(b, H, h, split);
  if (lane == 0) {
    part[0] = m;
    part[1] = l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + WARP * i;
    if (d < hd) part[2 + d] = acc[i];
  }
}

// A block per (b, h): merges the n_splits partials in split order. The
// splits' m and l go to shared memory first, one thread turns them into
// weights e^(m_s - M) (0 where l_s is 0: that split's acc was never
// written and is 0) and the denominator, then each thread sums its dims'
// acc over the splits in order. With one live split the result has the
// bits the split kernel's own division gives (1 * x + 0 is x).
template <typename T>
__global__ void combine_kernel(const float* __restrict__ work,
                               T* __restrict__ out, int hd, int n_splits) {
  extern __shared__ float weight[];          // [n_splits], then l [n_splits]
  __shared__ float denom;
  float* ls = weight + n_splits;
  const long long bh = blockIdx.x;
  const int width = hd + 2;
  const float* w = work + bh * n_splits * width;
  for (int s = threadIdx.x; s < n_splits; s += blockDim.x) {
    weight[s] = w[s * width];
    ls[s] = w[s * width + 1];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float M = NEG;
    for (int s = 0; s < n_splits; ++s) M = fmaxf(M, weight[s]);
    float L = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float f = ls[s] > 0.f ? expf(weight[s] - M) : 0.f;
      if (ls[s] > 0.f) L = fmaf(f, ls[s], L);
      weight[s] = f;
    }
    denom = fmaxf(L, 1e-20f);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float a = 0.f;
#pragma unroll 4
    for (int s = 0; s < n_splits; ++s)
      if (weight[s] != 0.f) a = fmaf(weight[s], w[s * width + 2 + d], a);
    out[bh * hd + d] = from_f32<T>(a / denom);
  }
}

// -- bf16 on tensor cores -----------------------------------------------
//
// The same split, block for block, with the products on tensor cores: a
// block's (up to) 16 query heads are the 16 rows of mma.sync m16n8k16 (bf16
// in, f32 accumulate); heads past G are zero rows never written. K and V
// tiles stay bf16 in shared memory, hd padded with zeros to HDP (32, 64,
// 128 or 256) and each row padded by 8 elements so ldmatrix's eight row
// reads hit eight different bank groups. Four warps; warp w owns rows
// 16w .. 16w + 15 of every 64-row tile and keeps its own (m, l, acc) for
// the 16 heads: S = Q K^T for its rows (ldmatrix of Q and K), the scores
// scaled by 1/sqrt(hd) in f32, the online softmax in f32 (the same mask,
// cut and m/l update), P rounded to bf16 and acc += P V (ldmatrix.trans of
// V), acc in f32. Each staged K and V row is read from shared memory once
// a block, by the warp that owns it. At the end the four warps' states
// merge in warp order through shared memory, as the splits do in the
// combine. The tiles and their warps follow the readable rows alone, so the
// hole and B = 1 equalities hold here too. The kernel waits on its loads:
// 16-byte loads go out MMA_BATCH at a time a thread, and registers are
// capped so an SM holds MMA_MIN_BLOCKS blocks, for more bytes in flight.

constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = MMA_WARPS * WARP;
constexpr int MMA_ROWS = HEADS_PER_BLOCK;      // query heads, tile rows a warp
static_assert(MMA_ROWS == 16, "the block's query heads are mma's 16 rows");
constexpr int MMA_BATCH = 8;                   // 16-byte loads a thread in flight
constexpr int MMA_MIN_BLOCKS = 3;              // blocks an SM must fit

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b for one m16n8k16 tile: a the row-major 16 x 16 A fragment, b0
// and b1 the column-major 16 x 8 B fragment
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__host__ __device__ constexpr int mma_ld(int hdp) { return hdp + 8; }

// Stage `n` rows (of up to TILE_ROWS) of one KV head's K and V as bf16
// into ks / vs [TILE_ROWS][mma_ld(HDP)], zeros past the rows and past hd.
// VEC: hd is a multiple of 8 and rows are 16-byte aligned, so each thread
// moves 16 bytes at a time, up to 16 loads in flight before their stores.
template <int HDP, bool VEC>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* __restrict__ ks,
                                           __nv_bfloat16* __restrict__ vs,
                                           const __nv_bfloat16* __restrict__ k,
                                           const __nv_bfloat16* __restrict__ v,
                                           int n, long long stride, int hd) {
  constexpr int LD = mma_ld(HDP);
  if constexpr (VEC) {
    constexpr int CPR = HDP / 8;                       // chunks a row
    constexpr int CHUNKS = TILE_ROWS * CPR;            // a tile of K (or V)
    constexpr int PER = 2 * CHUNKS / MMA_THREADS;      // a thread, K and V
    constexpr int BATCH = PER < MMA_BATCH ? PER : MMA_BATCH;
#pragma unroll
    for (int b0 = 0; b0 < PER; b0 += BATCH) {
      uint4 buf[BATCH];
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const int c = (b0 + i) * MMA_THREADS + threadIdx.x;
        const int kv = c / CHUNKS, rem = c - kv * CHUNKS;
        const int r = rem / CPR, col = (rem - r * CPR) * 8;
        buf[i] = make_uint4(0u, 0u, 0u, 0u);
        if (r < n && col < hd)
          buf[i] = __ldg(reinterpret_cast<const uint4*>(
              (kv ? v : k) + r * stride + col));
      }
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const int c = (b0 + i) * MMA_THREADS + threadIdx.x;
        const int kv = c / CHUNKS, rem = c - kv * CHUNKS;
        const int r = rem / CPR, col = (rem - r * CPR) * 8;
        *reinterpret_cast<uint4*>((kv ? vs : ks) + r * LD + col) = buf[i];
      }
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int i = threadIdx.x; i < TILE_ROWS * HDP; i += MMA_THREADS) {
      const int r = i / HDP, d = i - r * HDP;
      const bool in = r < n && d < hd;
      ks[r * LD + d] = in ? k[r * stride + d] : zero;
      vs[r * LD + d] = in ? v[r * stride + d] : zero;
    }
  }
}

template <int HDP, bool VEC>
__global__ void __launch_bounds__(MMA_THREADS, MMA_MIN_BLOCKS)
mma_split_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k_pages,
                 const __nv_bfloat16* __restrict__ v_pages,
                 const int* __restrict__ page_table,
                 const int* __restrict__ lengths, Sink<__nv_bfloat16> sink,
                 int H, int K, int hd, int P, int n_pages, int max_pages) {
  constexpr int LD = mma_ld(HDP);
  constexpr int NT = HDP / 8;                  // n-tiles of acc
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int slots[PAGES_PER_SPLIT], pids[PAGES_PER_SPLIT], n_mine;
  __shared__ float red_m[MMA_WARPS][MMA_ROWS], red_l[MMA_WARPS][MMA_ROWS];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + MMA_ROWS * LD;      // [TILE_ROWS][LD]
  __nv_bfloat16* vs = ks + TILE_ROWS * LD;     // [TILE_ROWS][LD]
  float* red_acc = reinterpret_cast<float*>(ks);  // after the last tile

  const int G = H / K;
  const int groups = (G + MMA_ROWS - 1) / MMA_ROWS;
  const int b = blockIdx.x, kh = blockIdx.y / groups, split = blockIdx.z;
  const int h0 = (blockIdx.y - kh * groups) * MMA_ROWS;
  const int n_heads = G - h0 < MMA_ROWS ? G - h0 : MMA_ROWS;
  const int hq = kh * G + h0;                  // first query head
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int g = lane / 4, t = lane % 4;        // mma fragment row, pair
  const int len = lengths[b];

  if (warp == 0)
    find_pages(page_table + static_cast<long long>(b) * max_pages, len, P,
               n_pages, max_pages, split, slots, pids, &n_mine);
  // the block's query rows, zeros past its heads and past hd
  for (int i = threadIdx.x; i < MMA_ROWS * HDP; i += MMA_THREADS) {
    const int r = i / HDP, d = i - r * HDP;
    qs[r * LD + d] = (r < n_heads && d < hd)
        ? q[(static_cast<long long>(b) * H + hq + r) * hd + d]
        : __float2bfloat16(0.f);
  }
  __syncthreads();
  const int n_pg = n_mine;
  if (n_pg == 0 && sink.n_splits > 1) {      // past the readable pages
    if (threadIdx.x < n_heads) {
      float* part = sink.partial(b, H, hq + threadIdx.x, split);
      part[0] = NEG;
      part[1] = 0.f;
    }
    return;
  }

  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // heads g and g + 8

  const long long stride = static_cast<long long>(K) * hd;  // row to row
  for (int pg = 0; pg < n_pg; ++pg) {
    const int start = slots[pg] * P;
    const int rows = len - start < P ? len - start : P;
    const long long base =
        (static_cast<long long>(pids[pg]) * P * K + kh) * hd;
    for (int r0 = 0; r0 < rows; r0 += TILE_ROWS) {
      const int n = rows - r0 < TILE_ROWS ? rows - r0 : TILE_ROWS;
      __syncthreads();                           // previous tile consumed
      stage_bf16<HDP, VEC>(ks, vs, k_pages + base + r0 * stride,
                           v_pages + base + r0 * stride, n, stride, hd);
      __syncthreads();
      const int w0 = warp * MMA_ROWS;            // this warp's first row
      if (w0 >= n) continue;

      // S = Q K^T over this warp's 16 rows: two n-tiles of 8 rows
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        unsigned a[4], kb[4];
        ldsm_x4(a, qs + (lane % 16) * LD + kk * 16 + (lane / 16) * 8);
        ldsm_x4(kb, ks + (w0 + (lane % 8) + (lane / 16) * 8) * LD +
                        kk * 16 + ((lane / 8) % 2) * 8);
        mma_bf16(s[0], a, kb[0], kb[1]);
        mma_bf16(s[1], a, kb[2], kb[3]);
      }
      // the online softmax in f32, rows g (e = 0, 1) and g + 8 (e = 2, 3)
      float mx[2] = {NEG, NEG};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = w0 + j * 8 + 2 * t + (e & 1);
          s[j][e] = row < n ? s[j][e] * scale : NEG;
          mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
        }
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        corr[i] = expf(m[i] - m_new);
        m[i] = m_new;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // the reference's cut: a score at or below -0.5e30 weighs 0
          s[j][e] = s[j][e] > CUT ? expf(s[j][e] - m[e / 2]) : 0.f;
          sum[e / 2] += s[j][e];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(FULL, sum[i], 1);
        sum[i] += __shfl_xor_sync(FULL, sum[i], 2);
        l[i] = l[i] * corr[i] + sum[i];
      }
      // acc = acc * corr + P V: P (16 heads x 16 rows) as the A fragment
      const unsigned pa[4] = {pack_bf16(s[0][0], s[0][1]),
                              pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]),
                              pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[j][0] *= corr[0];
        acc[j][1] *= corr[0];
        acc[j][2] *= corr[1];
        acc[j][3] *= corr[1];
      }
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        unsigned vb[4];
        ldsm_x4_trans(vb, vs + (w0 + (lane % 8) + ((lane / 8) % 2) * 8) * LD +
                              (j + lane / 16) * 8);
        mma_bf16(acc[j], pa, vb[0], vb[1]);
        mma_bf16(acc[j + 1], pa, vb[2], vb[3]);
      }
    }
  }

  // merge the four warps' states in warp order
  __syncthreads();                               // every tile consumed
  if (t == 0) {
    red_m[warp][g] = m[0];
    red_m[warp][g + 8] = m[1];
    red_l[warp][g] = l[0];
    red_l[warp][g + 8] = l[1];
  }
  float* mine = red_acc + warp * MMA_ROWS * HDP;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int d = j * 8 + 2 * t;
    *reinterpret_cast<float2*>(mine + g * HDP + d) =
        make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(mine + (g + 8) * HDP + d) =
        make_float2(acc[j][2], acc[j][3]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_heads * hd; i += MMA_THREADS) {
    const int r = i / hd, d = i - r * hd;
    float M = NEG;
#pragma unroll
    for (int w = 0; w < MMA_WARPS; ++w) M = fmaxf(M, red_m[w][r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < MMA_WARPS; ++w) {
      const float f = expf(red_m[w][r] - M);
      L = fmaf(f, red_l[w][r], L);
      A = fmaf(f, red_acc[(w * MMA_ROWS + r) * HDP + d], A);
    }
    const int h = hq + r;
    if (sink.n_splits == 1) {
      sink.out[(static_cast<long long>(b) * H + h) * hd + d] =
          __float2bfloat16(A / fmaxf(L, 1e-20f));
    } else {
      float* part = sink.partial(b, H, h, split);
      if (d == 0) {
        part[0] = M;
        part[1] = L;
      }
      part[2 + d] = A;
    }
  }
}

struct Shape {
  int B, H, K, hd, P;
};

// query-head groups of a KV head: the grid's second axis is K * groups
inline int groups(const Shape& s) {
  return (s.H / s.K + HEADS_PER_BLOCK - 1) / HEADS_PER_BLOCK;
}

inline int n_splits(int max_pages) {   // at least 1
  return max_pages > PAGES_PER_SPLIT
      ? (max_pages + PAGES_PER_SPLIT - 1) / PAGES_PER_SPLIT : 1;
}

// f32 on CUDA cores: a warp a query head, at least MIN_WARPS
inline int heads_in_block(const Shape& s) {
  const int G = s.H / s.K;
  return G < HEADS_PER_BLOCK ? G : HEADS_PER_BLOCK;
}

inline int threads(const Shape& s) {
  const int w = heads_in_block(s);
  return WARP * (w < MIN_WARPS ? MIN_WARPS : w);
}

inline size_t shared_bytes(const Shape& s) {
  const int tile = s.P < F32_TILE_ROWS ? s.P : F32_TILE_ROWS;
  return sizeof(float) * static_cast<size_t>(2 * tile + heads_in_block(s)) *
         row_ld(s.hd);
}

// bf16 on tensor cores: hd padded to HDP
inline int mma_hdp(int hd) {
  return hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 128 ? 128 : 256;
}

inline size_t mma_shared_bytes(int hd) {
  return sizeof(__nv_bfloat16) * (MMA_ROWS + 2 * TILE_ROWS) *
         static_cast<size_t>(mma_ld(mma_hdp(hd)));
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem, int nt, int* blocks_per_sm) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess && blocks_per_sm)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                      nt, smem);
  return e;
}

template <bool VEC>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const int* pt, const int* lens, void* out, float* work,
                       const Shape& s, int n_pages, int max_pages,
                       cudaStream_t stream, int* blocks_per_sm) {
  auto kernel = split_kernel<VEC>;
  cudaError_t e = opt_in(kernel, shared_bytes(s), threads(s), blocks_per_sm);
  if (e != cudaSuccess || blocks_per_sm) return e;
  const Sink<float> sink{static_cast<float*>(out), work, n_splits(max_pages),
                         s.hd};
  const dim3 grid(s.B, s.K * groups(s), sink.n_splits);
  kernel<<<grid, threads(s), shared_bytes(s), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), pt, lens, sink, s.H, s.K, s.hd, s.P,
      n_pages, max_pages);
  return cudaGetLastError();
}

template <int HDP, bool VEC>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const int* pt, const int* lens, void* out, float* work,
                       const Shape& s, int n_pages, int max_pages,
                       cudaStream_t stream, int* blocks_per_sm) {
  auto kernel = mma_split_kernel<HDP, VEC>;
  const size_t smem = mma_shared_bytes(s.hd);
  cudaError_t e = opt_in(kernel, smem, MMA_THREADS, blocks_per_sm);
  if (e != cudaSuccess || blocks_per_sm) return e;
  using bf16 = __nv_bfloat16;
  const Sink<bf16> sink{static_cast<bf16*>(out), work, n_splits(max_pages),
                        s.hd};
  const dim3 grid(s.B, s.K * groups(s), sink.n_splits);
  kernel<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), pt, lens, sink, s.H, s.K, s.hd, s.P,
      n_pages, max_pages);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const int* pt, const int* lens, void* out,
                        float* work, const Shape& s, int n_pages,
                        int max_pages, cudaStream_t stream,
                        int* blocks_per_sm) {
  switch (mma_hdp(s.hd)) {
    case 32:
      return launch_mma<32, VEC>(q, k, v, pt, lens, out, work, s, n_pages,
                                 max_pages, stream, blocks_per_sm);
    case 64:
      return launch_mma<64, VEC>(q, k, v, pt, lens, out, work, s, n_pages,
                                 max_pages, stream, blocks_per_sm);
    case 128:
      return launch_mma<128, VEC>(q, k, v, pt, lens, out, work, s, n_pages,
                                  max_pages, stream, blocks_per_sm);
    default:
      return launch_mma<256, VEC>(q, k, v, pt, lens, out, work, s, n_pages,
                                  max_pages, stream, blocks_per_sm);
  }
}

inline bool vec_ok(int hd, int elem, const void* k, const void* v) {
  return (static_cast<long long>(hd) * elem) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(v) % 16 == 0;
}

// The split launch (or, with blocks_per_sm, the occupancy query instead)
// for dtype 0 (f32) or 1 (bf16).
inline int split(const void* q, const void* k, const void* v, const int* pt,
                 const int* lens, void* out, float* work, int dtype,
                 const Shape& s, int n_pages, int max_pages,
                 cudaStream_t stream, int* blocks_per_sm) {
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0)
    e = vec_ok(s.hd, 4, k, v)
        ? launch_f32<true>(q, k, v, pt, lens, out, work, s, n_pages,
                           max_pages, stream, blocks_per_sm)
        : launch_f32<false>(q, k, v, pt, lens, out, work, s, n_pages,
                            max_pages, stream, blocks_per_sm);
  else if (dtype == 1)
    e = vec_ok(s.hd, 2, k, v)
        ? launch_bf16<true>(q, k, v, pt, lens, out, work, s, n_pages,
                            max_pages, stream, blocks_per_sm)
        : launch_bf16<false>(q, k, v, pt, lens, out, work, s, n_pages,
                             max_pages, stream, blocks_per_sm);
  return static_cast<int>(e);
}

}  // namespace paged_attention

extern "C" {

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int paged_attention_pages_per_split() {
  return paged_attention::PAGES_PER_SPLIT;
}

// Launches the split kernel on `stream`: dtype 0 runs the f32 kernel on
// CUDA cores, 1 the bf16 kernel on tensor cores (q, pages and out share
// the dtype). q and out are (B, H, hd), the pages (n_pages, P, K, hd), all
// contiguous; page_table is (B, max_pages) i32, lengths (B,) i32, on the
// card. With ceil(max_pages / PAGES_PER_SPLIT) splits above 1 it writes
// the f32 workspace (B, H, S_max, hd + 2), not out. The caller guarantees
// 1 <= hd <= 256, H % K == 0 and S_max <= 4096. Returns 0 when the launch
// was accepted, else the CUDA error.
int paged_attention_split_launch(const void* q, const void* k_pages,
                                 const void* v_pages, const int* page_table,
                                 const int* lengths, void* out, float* work,
                                 int dtype, int B, int H, int K, int hd,
                                 int P, int n_pages, int max_pages,
                                 void* stream) {
  return paged_attention::split(
      q, k_pages, v_pages, page_table, lengths, out, work, dtype,
      paged_attention::Shape{B, H, K, hd, P}, n_pages, max_pages,
      static_cast<cudaStream_t>(stream), nullptr);
}

// Launches the combine kernel on `stream`: the workspace (B, H, n_splits,
// hd + 2) f32 into out (B, H, hd) in dtype (0: f32, 1: bf16); n_splits <=
// 4096 (its weights fit the default shared memory).
int paged_attention_combine_launch(const float* work, void* out, int dtype,
                                   int B, int H, int hd, int n_splits,
                                   void* stream) {
  using namespace paged_attention;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nt = (hd + WARP - 1) / WARP * WARP;
  const unsigned blocks = static_cast<unsigned>(B) * H;
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(n_splits);
  if (dtype == 0)
    combine_kernel<float><<<blocks, nt, smem, st>>>(
        work, static_cast<float*>(out), hd, n_splits);
  else if (dtype == 1)
    combine_kernel<__nv_bfloat16><<<blocks, nt, smem, st>>>(
        work, static_cast<__nv_bfloat16*>(out), hd, n_splits);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the split kernel an SM holds at once for this shape (the
// occupancy written beside its time), or minus a CUDA error code.
int paged_attention_blocks_per_sm(int dtype, int H, int K, int hd, int P) {
  using namespace paged_attention;
  int n = 0;
  const int e = split(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                      nullptr, dtype, Shape{1, H, K, hd, P}, 1, 1, nullptr,
                      &n);
  return e == 0 ? n : -e;
}

// The split kernel's launch shape: threads a block and dynamic shared
// bytes.
int paged_attention_threads(int dtype, int H, int K) {
  using namespace paged_attention;
  return dtype == 1 ? MMA_THREADS : threads(Shape{1, H, K, 1, 1});
}

long long paged_attention_shared_bytes(int dtype, int H, int K, int hd,
                                       int P) {
  using namespace paged_attention;
  return static_cast<long long>(dtype == 1 ? mma_shared_bytes(hd)
                                           : shared_bytes(Shape{1, H, K, hd, P}));
}

}  // extern "C"
