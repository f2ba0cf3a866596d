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
// order, so here one block walks a sequence's pages itself in a loop.
//
// Bound on this card: bytes. Every K and V row a sequence's length covers
// is read once (2 * K * hd elements a position), against 4 * hd * H flops
// a position: about one flop a byte in f32, far under the card's balance.
//
// Design (a simple, correct first kernel; splitting the page axis across
// blocks (flash-decoding), TMA loads and a pipelined ring of tiles are
// later work):
//   - one block per (sequence b, KV head kh, group of up to 16 of the G
//     query heads that read kh); query head h reads KV head h / G, the
//     interleaving of jnp.repeat(k, G, axis=1);
//   - the block walks the page table in order; a page whose id is -1 (or
//     out of range) is skipped, never read, and the walk stops at the first
//     page past the length;
//   - each page's rows under the length are staged in tiles of up to 64
//     rows of this head's K and V, converted to f32, in shared memory (64 KB
//     at hd = 128, over the default 48 KB: the launch opts in); every warp
//     of the block (at least four) helps to stage, with 16-byte loads where
//     hd allows, the loop unrolled so several are in flight a thread;
//   - one warp per query head, its q row (pre-divided by sqrt(hd)) in
//     shared memory; per chunk of 32 rows each lane scores one row (a
//     whole dot product in four partial sums, K read 16 bytes at a time
//     from rows padded so the lanes' reads meet no bank conflict), then the
//     warp updates m, l and acc (each lane holding hd / 32 of acc) as the
//     reference does, in f32: m starts at -1e30, l at 0, a score at or
//     below -0.5e30 weighs 0, and the output is acc / max(l, 1e-20), so a
//     sequence with no readable position outputs exact zeros, never NaN;
//   - sums run in a fixed order (rows in page order, fixed shuffles), so
//     the result repeats from run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace paged_attention {

constexpr int WARP = 32;
constexpr int MAX_HD = 256;
constexpr int DPL = MAX_HD / WARP;   // q / acc values a lane keeps
constexpr int HEADS_PER_BLOCK = 16;  // query heads (warps) a block computes
constexpr int MIN_WARPS = 4;         // warps a block has at least, to stage
constexpr int TILE_ROWS = 64;        // K/V rows staged at a time
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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Stage `n` rows of one KV head (row stride `stride` elements) as f32 into
// dst[n][ld] (ld >= hd, a multiple of 4). VEC: hd * sizeof(T) is a
// multiple of 16 and rows are 16-byte aligned, so each thread moves 16
// bytes at a time.
template <typename T, bool VEC>
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const T* __restrict__ src, int n,
                                      long long stride, int hd, int ld) {
  if constexpr (VEC) {
    constexpr int W = 16 / sizeof(T);
    const int per_row = hd / W;
#pragma unroll 4
    for (int i = threadIdx.x; i < n * per_row; i += blockDim.x) {
      const int r = i / per_row, c = (i - r * per_row) * W;
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + r * stride + c);
      float* out = dst + r * ld + c;
      if constexpr (W == 4) {
        *reinterpret_cast<float4*>(out) =
            *reinterpret_cast<const float4*>(&raw);
      } else {
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int j = 0; j < W; j += 4)
          *reinterpret_cast<float4*>(out + j) =
              make_float4(__bfloat162float(h[j]), __bfloat162float(h[j + 1]),
                          __bfloat162float(h[j + 2]),
                          __bfloat162float(h[j + 3]));
      }
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < n * hd; i += blockDim.x) {
      const int r = i / hd, c = i - r * hd;
      dst[r * ld + c] = to_f32(src[r * stride + c]);
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

template <typename T, bool VEC>
__global__ void paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ page_table,
    const int* __restrict__ lengths, T* __restrict__ out, int H, int K,
    int hd, int P, int n_pages, int max_pages) {
  extern __shared__ float smem[];
  const int tile = P < TILE_ROWS ? P : TILE_ROWS;
  const int ld = row_ld(hd);
  float* ks = smem;                      // [tile][ld]
  float* vs = ks + tile * ld;            // [tile][ld]
  float* qs = vs + tile * ld;            // [warps computing][ld]

  const int b = blockIdx.x, kh = blockIdx.y;
  const int G = H / K;
  const int h0 = blockIdx.z * HEADS_PER_BLOCK;
  const int rest = G - h0;
  const int n_heads = rest < HEADS_PER_BLOCK ? rest : HEADS_PER_BLOCK;
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const bool computes = warp < n_heads;
  const int h = kh * G + h0 + warp;
  const int hd4 = hd & ~3;

  // this warp's query row, divided by sqrt(hd), in shared memory
  float* qw = qs + warp * ld;
  if (computes) {
    const float root = sqrtf(static_cast<float>(hd));
    for (int d = lane; d < hd; d += WARP)
      qw[d] = to_f32(q[(static_cast<long long>(b) * H + h) * hd + d]) / root;
  }
  __syncwarp();
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
  float m = NEG, l = 0.f;

  const int len = lengths[b];
  const long long stride = static_cast<long long>(K) * hd;  // row to row
  for (int j = 0; j < max_pages; ++j) {
    const int start = j * P;
    if (start >= len) break;
    const int pid = page_table[static_cast<long long>(b) * max_pages + j];
    if (pid < 0 || pid >= n_pages) continue;    // masked: never read
    const int rows = len - start < P ? len - start : P;
    const long long base =
        (static_cast<long long>(pid) * P * K + kh) * hd;
    for (int r0 = 0; r0 < rows; r0 += tile) {
      const int n = rows - r0 < tile ? rows - r0 : tile;
      __syncthreads();                           // previous tile consumed
      stage<T, VEC>(ks, k_pages + base + r0 * stride, n, stride, hd, ld);
      stage<T, VEC>(vs, v_pages + base + r0 * stride, n, stride, hd, ld);
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
  const float denom = fmaxf(l, 1e-20f);
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + WARP * i;
    if (d < hd)
      out[(static_cast<long long>(b) * H + h) * hd + d] =
          from_f32<T>(acc[i] / denom);
  }
}

struct Shape {
  int B, H, K, hd, P;
};

inline int heads_in_block(const Shape& s) {
  const int G = s.H / s.K;
  return G < HEADS_PER_BLOCK ? G : HEADS_PER_BLOCK;
}

inline int threads(const Shape& s) {
  const int w = heads_in_block(s);
  return WARP * (w < MIN_WARPS ? MIN_WARPS : w);
}

inline size_t shared_bytes(const Shape& s) {
  const int tile = s.P < TILE_ROWS ? s.P : TILE_ROWS;
  return sizeof(float) * static_cast<size_t>(2 * tile + heads_in_block(s)) *
         row_ld(s.hd);
}

template <typename T, bool VEC>
cudaError_t prepare(const Shape& s, int* blocks_per_sm) {
  const size_t smem = shared_bytes(s);
  cudaError_t e = cudaFuncSetAttribute(
      paged_attention_kernel<T, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e == cudaSuccess && blocks_per_sm)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, paged_attention_kernel<T, VEC>, threads(s), smem);
  return e;
}

template <typename T, bool VEC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* pt, const int* lens, void* out, const Shape& s,
                   int n_pages, int max_pages, cudaStream_t stream) {
  cudaError_t e = prepare<T, VEC>(s, nullptr);
  if (e != cudaSuccess) return e;
  const int G = s.H / s.K;
  const dim3 grid(s.B, s.K, (G + HEADS_PER_BLOCK - 1) / HEADS_PER_BLOCK);
  paged_attention_kernel<T, VEC><<<grid, threads(s), shared_bytes(s),
                                   stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pt, lens, static_cast<T*>(out), s.H, s.K,
      s.hd, s.P, n_pages, max_pages);
  return cudaGetLastError();
}

inline bool vec_ok(int hd, int elem, const void* k, const void* v) {
  return (static_cast<long long>(hd) * elem) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(v) % 16 == 0;
}

}  // namespace paged_attention

extern "C" {

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the kernel on `stream`. dtype 0: f32, 1: bf16 (q, pages and out
// share it). q and out are (B, H, hd), the pages (n_pages, P, K, hd), all
// contiguous; page_table is (B, max_pages) i32, lengths (B,) i32, on the
// card. The caller guarantees 1 <= hd <= 256 and H % K == 0. Returns 0 when
// the launch was accepted, else the CUDA error.
int paged_attention_launch(const void* q, const void* k_pages,
                           const void* v_pages, const int* page_table,
                           const int* lengths, void* out, int dtype, int B,
                           int H, int K, int hd, int P, int n_pages,
                           int max_pages, void* stream) {
  using namespace paged_attention;
  const Shape s{B, H, K, hd, P};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vec_ok(hd, 4, k_pages, v_pages)
        ? launch<float, true>(q, k_pages, v_pages, page_table, lengths, out,
                              s, n_pages, max_pages, st)
        : launch<float, false>(q, k_pages, v_pages, page_table, lengths,
                               out, s, n_pages, max_pages, st);
  if (dtype == 1)
    return vec_ok(hd, 2, k_pages, v_pages)
        ? launch<__nv_bfloat16, true>(q, k_pages, v_pages, page_table,
                                      lengths, out, s, n_pages, max_pages,
                                      st)
        : launch<__nv_bfloat16, false>(q, k_pages, v_pages, page_table,
                                       lengths, out, s, n_pages, max_pages,
                                       st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of the kernel an SM holds at once for this shape (the occupancy
// written beside its time), or minus a CUDA error code.
int paged_attention_blocks_per_sm(int dtype, int H, int K, int hd, int P) {
  using namespace paged_attention;
  const Shape s{1, H, K, hd, P};
  int n = 0;
  cudaError_t e = dtype == 0 ? prepare<float, true>(s, &n)
                             : prepare<__nv_bfloat16, true>(s, &n);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// The kernel's launch shape: threads a block and dynamic shared bytes.
int paged_attention_threads(int H, int K) {
  using namespace paged_attention;
  return threads(Shape{1, H, K, 1, 1});
}

long long paged_attention_shared_bytes(int H, int K, int hd, int P) {
  using namespace paged_attention;
  return static_cast<long long>(shared_bytes(Shape{1, H, K, hd, P}));
}

}  // extern "C"
