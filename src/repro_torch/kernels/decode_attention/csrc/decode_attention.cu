// decode_attention for Hopper (sm_90a): attention of one query position
// per sequence over a contiguous K/V cache, with grouped query heads (query
// head h reads KV head h / G), the mask of models.components.attention
// (kv_pos < 0 marks an empty slot; causal; a sliding window), the optional
// logit softcap, an online softmax in f32 and the output in q's dtype.
//
// Replaces no TPU kernel: the reference's attention is plain JAX
// (src/repro/models/components.py), and the port's is plain PyTorch. It was
// added because the plain decode step repeated the (B, L, K, hd) cache to
// all H = K * G query heads and cast each copy to f32 before two batched
// products: at mixtral-8x22b's widths (64 sequences, 512 slots, 8 KV heads
// of 128, G = 6) several GB of copies a layer for ~100 MB of cache, 70% of
// the decode step.
//
// Bound on this card: bytes. The valid K and V rows are read once (2 * K *
// hd elements a position), q read and the output written once, over 3.35
// TB/s; the work is 4 * G * hd f32 operations a position and KV head, far
// under the card's f32 balance, but every K and V element read is widened
// and used by G heads on CUDA cores, so the instructions a byte decide
// whether the copies stay busy.
//
// Design:
//   - a block owns one sequence b, one KV head kh, a group of up to MAX_G
//     of its G query heads and one split of the positions; every K/V row it
//     stages serves all of its query heads, and nothing is repeated or
//     widened in device memory;
//   - the split count comes from the shapes alone (B * K * head groups
//     against the card's 132 SMs, and L): 1 where the blocks already fill
//     the card, more at small B or long L. With splits each block writes
//     its (acc, m, l) in f32 to a workspace and a combine kernel merges
//     them in split order, without atomics;
//   - the block first builds its mask (one bit a position, from kv_pos,
//     q_pos, causal and the window) and the list of its tiles with a valid
//     position; a tile with none is never loaded;
//   - a producer warp streams tiles of T rows (32 for rows of 129-512 B)
//     of K and V into a ring of STAGES stages in shared memory, one bulk
//     copy (cp.async.bulk) a row, read with the cache's own strides; a
//     full mbarrier a stage counts the bytes landed, an empty one the
//     consumer warps done with it. Rows past the split's end are copied
//     from its last row (finite values; their p is 0). Staged rows are
//     padded by 16 B so that lanes reading different rows hit distinct
//     banks;
//   - four consumer warps a tile, two barriers between them: the scores
//     (warp w sums the 16 B chunks w, w + 4, ... of each row for every
//     query head of the block, a lane a row, q in shared memory as f32
//     times 1 / sqrt(hd) and read by the whole warp at once; the warps'
//     partial sums are added in warp order), the softcap and the mask; the
//     online softmax (half a warp a query head: the max, exp, masked p =
//     0, the sum, the rescale of the running state); p V (a thread a pair
//     of output columns and a run of the tile's rows, for every query head
//     of the block);
//   - the phases are short chains of shared-memory loads and multiply-adds,
//     so occupancy hides their latency: 4 consumer warps, 32-row tiles and
//     2 stages keep a block at 43 KB of shared memory and 72 registers a
//     thread at mixtral's shape, and 5 blocks fit an SM (on an H100, 8
//     consumer warps, 64-row tiles or 3 stages, with fewer blocks resident,
//     ran 1.1-1.9x slower);
//   - sums run in a fixed order (chunks, warps, positions in tile order,
//     position groups and splits in order), so a result repeats bit for
//     bit from run to run. f32 products on CUDA cores throughout; K and V
//     are widened from bf16 exactly.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace decode_attention {

constexpr int WARP = 32;
constexpr int CONSUMERS = 128;        // consumer threads a block
constexpr int CWARPS = CONSUMERS / WARP;
constexpr int THREADS = CONSUMERS + WARP;   // and one producer warp
constexpr int MAX_G = 8;              // query heads a block
constexpr int STAGES = 2;             // tiles in the ring
constexpr int MASK_LOADS = 4;         // kv_pos loads in flight a thread
constexpr int MAX_SPLIT_POS = 4096;   // positions a split covers at most
constexpr int MIN_SPLIT_TILES = 4;    // tiles a split covers at least
constexpr int SMS = 132;              // H100 SXM
constexpr int BLOCKS_PER_SM = 2;      // the splits' aim (and launch bounds)
constexpr int CONSUMER_BAR = 1;       // named barrier of the consumer warps
constexpr unsigned FULL = 0xffffffffu;
static_assert(2 * CWARPS >= MAX_G, "the softmax takes half a warp a head");
constexpr float NEG = -1e30f;         // the plain version's mask value
constexpr float CUT = -0.5e30f;       // scores at or below weigh 0

struct Params {
  const void* q;            // (B, H, hd), contiguous: the query position
  const void* k;            // (B, L, K, hd), strided, last dim contiguous
  const void* v;
  const long long* q_pos;   // (1,)
  const long long* kv_pos;  // (L,)
  void* out;                // (B, H, hd), contiguous, q's dtype
  float* part;              // splits > 1: (B, H, S, hd + 2): acc, m, l
  long long k_sb, k_sl, k_sh, v_sb, v_sl, v_sh;   // strides, in elements
  int H, K, L, hd, G, NG, GB, S, split_pos;
  int q_bf16;               // q and out: 1 bf16, 0 f32
  int causal;
  long long window;         // 0: none
  float scale, softcap;     // softcap 0: none
};

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

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync %0, %1;" ::"n"(CONSUMER_BAR), "n"(CONSUMERS)
               : "memory");
}

__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// 16 staged bytes of a row as f32: 8 bf16 or 4 f32 values
__device__ __forceinline__ void widen16(const unsigned char* p,
                                        __nv_bfloat16, float* out) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  out[0] = bf16_lo(w.x); out[1] = bf16_hi(w.x);
  out[2] = bf16_lo(w.y); out[3] = bf16_hi(w.y);
  out[4] = bf16_lo(w.z); out[5] = bf16_hi(w.z);
  out[6] = bf16_lo(w.w); out[7] = bf16_hi(w.w);
}
__device__ __forceinline__ void widen16(const unsigned char* p, float,
                                        float* out) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  out[0] = w.x; out[1] = w.y; out[2] = w.z; out[3] = w.w;
}

// two adjacent staged values as f32
__device__ __forceinline__ float2 widen2(const unsigned char* p,
                                         __nv_bfloat16) {
  const unsigned w = *reinterpret_cast<const unsigned*>(p);
  return make_float2(bf16_lo(w), bf16_hi(w));
}
__device__ __forceinline__ float2 widen2(const unsigned char* p, float) {
  return *reinterpret_cast<const float2*>(p);
}

// K/V rows a tile, for rows of row_bytes
__host__ __device__ inline int tile_rows(int row_bytes) {
  return row_bytes <= 128 ? 64 : row_bytes <= 512 ? 32 : 16;
}

// The dynamic shared memory of a block: the ring (after the last tile, the
// position groups' sums: at most 2 * CONSUMERS * MAX_G f32), then q (MAX_G x
// hd), the warps' partial scores (CWARPS x MAX_G x T), p (MAX_G x T), m, l
// and the rescale (MAX_G each), the mask bits, the list of valid tiles and
// the full and empty mbarriers of each stage.
struct Layout {
  int pitch, stage, q, part, s, m, l, corr, bits, tiles, bars, bytes;
  __host__ __device__ Layout(int hd, int elt, int T) {
    pitch = hd * elt + 16;
    stage = 2 * T * pitch;
    q = STAGES * stage;
    if (q < 2 * CONSUMERS * MAX_G * 4) q = 2 * CONSUMERS * MAX_G * 4;
    part = q + MAX_G * hd * 4;
    s = part + CWARPS * MAX_G * T * 4;
    m = s + MAX_G * T * 4;
    l = m + MAX_G * 4;
    corr = l + MAX_G * 4;
    bits = corr + MAX_G * 4;
    tiles = bits + MAX_SPLIT_POS / 32 * 4;
    bars = tiles + MAX_SPLIT_POS / T * 4;
    bytes = bars + 2 * STAGES * 8;
  }
};

__device__ __forceinline__ bool visible(long long pos, long long qp,
                                        int causal, long long window) {
  return pos >= 0 && (!causal || pos <= qp) &&
         (window == 0 || pos > qp - window);
}

// the mask bits of tile t (T rows) of a split, nonzero when any is valid
template <int T>
__device__ __forceinline__ unsigned tile_bits(const unsigned* bits, int t) {
  if (T == 64) return bits[2 * t] | bits[2 * t + 1];
  if (T == 32) return bits[t];
  return (bits[t >> 1] >> ((t & 1) * 16)) & 0xffffu;
}

template <typename KV, int T>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    split_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int n_valid;
  constexpr int VEC = 16 / sizeof(KV);        // values a 16 B chunk
  constexpr int RPT = T > WARP ? T / WARP : 1;  // rows a lane (scores)
  const int hd = p.hd;
  const Layout lay(hd, sizeof(KV), T);
  float* qs = reinterpret_cast<float*>(smem + lay.q);
  float* m_run = reinterpret_cast<float*>(smem + lay.m);
  float* l_run = reinterpret_cast<float*>(smem + lay.l);
  unsigned* bits = reinterpret_cast<unsigned*>(smem + lay.bits);
  int* tiles = reinterpret_cast<int*>(smem + lay.tiles);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, lane = tid % WARP, warp = tid / WARP;
  const int gi = blockIdx.x % p.NG;
  const int bk = blockIdx.x / p.NG;
  const int kh = bk % p.K, b = bk / p.K;
  const int split = blockIdx.y;
  const int g0 = gi * p.GB;
  const int Gb = min(p.GB, p.G - g0);          // query heads of this block
  const int h0 = kh * p.G + g0;                // the first of them
  const int lo = split * p.split_pos;
  const int hi = min(p.L, lo + p.split_pos);   // lo < hi: no empty split
  const int n_tiles = (hi - lo + T - 1) / T;
  const long long qp = p.q_pos[0];

  // q of the block's heads, scaled, as f32
  for (int i = tid; i < Gb * hd; i += THREADS) {
    const long long at = (static_cast<long long>(b) * p.H + h0) * hd + i;
    const float x = p.q_bf16
        ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.q)[at])
        : static_cast<const float*>(p.q)[at];
    qs[i] = x * p.scale;
  }
  // the mask, a bit a position of the split (whole warps: ballots), its
  // positions read MASK_LOADS at a time
  const int span = n_tiles * T;
  for (int i0 = 0; i0 < span; i0 += MASK_LOADS * THREADS) {
    bool ok[MASK_LOADS];
#pragma unroll
    for (int u = 0; u < MASK_LOADS; ++u) {
      const int i = i0 + u * THREADS + tid;
      ok[u] = i < hi - lo &&
              visible(p.kv_pos[lo + i], qp, p.causal, p.window);
    }
#pragma unroll
    for (int u = 0; u < MASK_LOADS; ++u) {
      const int i = i0 + u * THREADS + tid;
      const unsigned w = __ballot_sync(FULL, ok[u]);
      if (lane == 0 && i < span) bits[i >> 5] = w;
    }
  }
  if (tid < MAX_G) {
    m_run[tid] = NEG;
    l_run[tid] = 0.f;
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  // the tiles with a valid position, in order (ballot and popcount)
  if (warp == 0) {
    int count = 0;
    for (int t0 = 0; t0 < n_tiles; t0 += WARP) {
      const int t = t0 + lane;
      const bool any = t < n_tiles && tile_bits<T>(bits, t) != 0u;
      const unsigned w = __ballot_sync(FULL, any);
      if (any) tiles[count + __popc(w & ((1u << lane) - 1u))] = t;
      count += __popc(w);
    }
    if (lane == 0) n_valid = count;
  }
  __syncthreads();
  const int nv = n_valid;

  if (warp == CWARPS) {
    // the producer: each tile's 2 T rows, a bulk copy each, lanes in turn
    const KV* kbase = static_cast<const KV*>(p.k) + b * p.k_sb + kh * p.k_sh;
    const KV* vbase = static_cast<const KV*>(p.v) + b * p.v_sb + kh * p.v_sh;
    const uint32_t row_bytes = hd * sizeof(KV);
    for (int it = 0; it < nv; ++it) {
      const int s = it % STAGES;
      if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
      if (lane == 0) mbar_expect_tx(&full[s], 2 * T * row_bytes);
      __syncwarp();
      unsigned char* st = smem + s * lay.stage;
      const int row0 = lo + tiles[it] * T;
      for (int r = lane; r < 2 * T; r += WARP) {
        const int row = r % T;
        const long long pos = min(row0 + row, hi - 1);
        const KV* src = r < T ? kbase + pos * p.k_sl : vbase + pos * p.v_sl;
        bulk_load(st + r * lay.pitch, src, row_bytes, &full[s]);
      }
    }
    return;
  }

  // p V: a thread a pair of columns and a run of the tile's rows
  const int NP = hd / 2;
  const int JG = CONSUMERS / NP;               // position groups, >= 1
  const int pair = tid % NP, jg = tid / NP;
  const int j0 = jg * T / JG, j1 = (jg + 1) * T / JG;
  const bool vec4 = T % JG == 0 && (T / JG) % 4 == 0;
  float acc[MAX_G][2];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) acc[g][0] = acc[g][1] = 0.f;

  // scores: warp w sums the 16 B chunks w, w + CWARPS, ... of rows lane,
  // lane + 32, ..., for every query head; the warps' partial sums are added
  // in warp order in the softmax
  const int cpr = hd / VEC;                    // 16 B chunks a row
  float* part = reinterpret_cast<float*>(smem + lay.part);
  float* ss = reinterpret_cast<float*>(smem + lay.s);
  float* corr = reinterpret_cast<float*>(smem + lay.corr);
  for (int it = 0; it < nv; ++it) {
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    const unsigned char* kt = smem + s * lay.stage;
    const unsigned char* vt = kt + T * lay.pitch;
    const int tile = tiles[it];

#pragma unroll
    for (int u = 0; u < RPT; ++u) {
      const int j = lane + WARP * u;
      if (j < T) {
        float dot[MAX_G];
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) dot[g] = 0.f;
        const unsigned char* krow = kt + j * lay.pitch;
        for (int c = warp; c < cpr; c += CWARPS) {
          float kf[VEC];
          widen16(krow + c * 16, KV(), kf);
#pragma unroll
          for (int g = 0; g < MAX_G; ++g)
            if (g < Gb) {
              const float4* q4 =
                  reinterpret_cast<const float4*>(qs + g * hd + c * VEC);
#pragma unroll
              for (int x = 0; x < VEC / 4; ++x) {
                const float4 qv = q4[x];
                dot[g] = fmaf(qv.x, kf[4 * x], dot[g]);
                dot[g] = fmaf(qv.y, kf[4 * x + 1], dot[g]);
                dot[g] = fmaf(qv.z, kf[4 * x + 2], dot[g]);
                dot[g] = fmaf(qv.w, kf[4 * x + 3], dot[g]);
              }
            }
        }
#pragma unroll
        for (int g = 0; g < MAX_G; ++g)
          if (g < Gb) part[(warp * MAX_G + g) * T + j] = dot[g];
      }
    }
    consumer_sync();

    // online softmax: half a warp a query head, rows jh, jh + 16, ...
    {
      constexpr int HALF = WARP / 2;
      constexpr int PER = (T + HALF - 1) / HALF;
      const int g = warp * 2 + lane / HALF, jh = lane % HALF;
      const unsigned half = lane < HALF ? 0x0000ffffu : 0xffff0000u;
      if (g < Gb) {
        float* sg = ss + g * T;
        float sv[PER];
        float mx = NEG;
#pragma unroll
        for (int u = 0; u < PER; ++u) {
          const int jj = jh + u * HALF;
          float sc = NEG;
          if (jj < T) {
            sc = part[g * T + jj];
#pragma unroll
            for (int w = 1; w < CWARPS; ++w)
              sc += part[(w * MAX_G + g) * T + jj];
            if (p.softcap > 0.f) sc = p.softcap * tanhf(sc / p.softcap);
            const int at = tile * T + jj;
            if (!((bits[at >> 5] >> (at & 31)) & 1u)) sc = NEG;
          }
          sv[u] = sc;
          mx = fmaxf(mx, sc);
        }
#pragma unroll
        for (int o = HALF / 2; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(half, mx, o));
        const float m_old = m_run[g];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < PER; ++u) {
          const int jj = jh + u * HALF;
          const float e = sv[u] > CUT ? expf(sv[u] - m_new) : 0.f;
          if (jj < T) sg[jj] = e;
          sum += e;
        }
#pragma unroll
        for (int o = HALF / 2; o > 0; o >>= 1)
          sum += __shfl_xor_sync(half, sum, o);
        if (jh == 0) {
          const float c = expf(m_old - m_new);
          corr[g] = c;
          l_run[g] = l_run[g] * c + sum;
          m_run[g] = m_new;
        }
      }
    }
    consumer_sync();

    // acc = acc * corr + p V over rows j0 .. j1 - 1
    if (jg < JG) {
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < Gb) {
          acc[g][0] *= corr[g];
          acc[g][1] *= corr[g];
        }
      const unsigned char* vcol = vt + pair * 2 * sizeof(KV);
      if (vec4) {
        for (int jj = j0; jj < j1; jj += 4) {
          float2 vv[4];
#pragma unroll
          for (int x = 0; x < 4; ++x)
            vv[x] = widen2(vcol + (jj + x) * lay.pitch, KV());
#pragma unroll
          for (int g = 0; g < MAX_G; ++g)
            if (g < Gb) {
              const float4 pg =
                  *reinterpret_cast<const float4*>(ss + g * T + jj);
              const float pw[4] = {pg.x, pg.y, pg.z, pg.w};
#pragma unroll
              for (int x = 0; x < 4; ++x) {
                acc[g][0] = fmaf(pw[x], vv[x].x, acc[g][0]);
                acc[g][1] = fmaf(pw[x], vv[x].y, acc[g][1]);
              }
            }
        }
      } else {
        for (int jj = j0; jj < j1; ++jj) {
          const float2 vv = widen2(vcol + jj * lay.pitch, KV());
#pragma unroll
          for (int g = 0; g < MAX_G; ++g)
            if (g < Gb) {
              const float pg = ss[g * T + jj];
              acc[g][0] = fmaf(pg, vv.x, acc[g][0]);
              acc[g][1] = fmaf(pg, vv.y, acc[g][1]);
            }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);     // stage s read by this warp
  }

  // sum the position groups in order; divide, or write the split's state
  consumer_sync();                             // every tile consumed
  float* red = reinterpret_cast<float*>(smem);   // (JG, MAX_G, hd)
  if (jg < JG) {
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
      if (g < Gb)
        *reinterpret_cast<float2*>(red + (jg * MAX_G + g) * hd + 2 * pair) =
            make_float2(acc[g][0], acc[g][1]);
  }
  consumer_sync();
  for (int i = tid; i < Gb * hd; i += CONSUMERS) {
    const int g = i / hd, d = i - g * hd;
    float a = 0.f;
    for (int x = 0; x < JG; ++x) a += red[(x * MAX_G + g) * hd + d];
    const long long bh = static_cast<long long>(b) * p.H + h0 + g;
    if (p.S == 1) {
      const float o = a / fmaxf(l_run[g], 1e-20f);
      if (p.q_bf16)
        static_cast<__nv_bfloat16*>(p.out)[bh * hd + d] = __float2bfloat16(o);
      else
        static_cast<float*>(p.out)[bh * hd + d] = o;
    } else {
      float* w = p.part + (bh * p.S + split) * (hd + 2);
      w[d] = a;
      if (d == 0) {
        w[hd] = m_run[g];
        w[hd + 1] = l_run[g];
      }
    }
  }
}

// The splits of (b, h) merged in split order: M = max m_s, out = sum
// e^(m_s - M) acc_s / max(sum e^(m_s - M) l_s, 1e-20). A split with no
// valid position holds (acc 0, m -1e30, l 0) and adds nothing.
__global__ void combine_kernel(const float* __restrict__ part, void* out,
                               int q_bf16, int S, int hd) {
  const long long bh = blockIdx.x;
  const float* w = part + bh * S * (hd + 2);
  float M = NEG;
  for (int s = 0; s < S; ++s) M = fmaxf(M, w[s * (hd + 2) + hd]);
  float L = 0.f;
  for (int s = 0; s < S; ++s)
    L = fmaf(expf(w[s * (hd + 2) + hd] - M), w[s * (hd + 2) + hd + 1], L);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < S; ++s)
      a = fmaf(expf(w[s * (hd + 2) + hd] - M), w[s * (hd + 2) + d], a);
    const float o = a / fmaxf(L, 1e-20f);
    if (q_bf16)
      static_cast<__nv_bfloat16*>(out)[bh * hd + d] = __float2bfloat16(o);
    else
      static_cast<float*>(out)[bh * hd + d] = o;
  }
}

// query-head groups a KV head: G split into groups of at most MAX_G
inline int head_groups(int G) { return (G + MAX_G - 1) / MAX_G; }

// Positions a split covers (a multiple of T) for these shapes: one split
// where the blocks fill the card, else as many as give BLOCKS_PER_SM blocks
// an SM, each of MIN_SPLIT_TILES tiles at least and MAX_SPLIT_POS positions
// at most.
inline int split_positions(int B, int K, int G, int L, int T) {
  const long long blocks = static_cast<long long>(B) * K * head_groups(G);
  const long long want = static_cast<long long>(SMS) * BLOCKS_PER_SM;
  const int tiles = (L + T - 1) / T;
  long long s = blocks >= want ? 1 : (want + blocks - 1) / blocks;
  const int most = tiles / MIN_SPLIT_TILES > 1 ? tiles / MIN_SPLIT_TILES : 1;
  if (s > most) s = most;
  const long long least = (L + MAX_SPLIT_POS - 1) / MAX_SPLIT_POS;
  if (s < least) s = least;
  const long long per = (L + s - 1) / s;
  return static_cast<int>((per + T - 1) / T * T);
}

// The dynamic shared memory each split kernel may use so far, raised as
// shapes grow: by element size (4, 2) and tile rows (64, 32, 16). Internal
// linkage: two builds of the library in one process keep their own.
static int smem_set[2][3];

template <typename KV, int T>
cudaError_t launch_split(const Params& p, int B, cudaStream_t stream) {
  const Layout lay(p.hd, sizeof(KV), T);
  int& set = smem_set[sizeof(KV) == 2][T == 64 ? 0 : T == 32 ? 1 : 2];
  if (set < lay.bytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        split_kernel<KV, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        lay.bytes);
    if (e != cudaSuccess) return e;
    set = lay.bytes;
  }
  const dim3 grid(static_cast<unsigned>(B) * p.K * p.NG, p.S);
  split_kernel<KV, T><<<grid, THREADS, lay.bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename KV>
cudaError_t launch_kv(const Params& p, int B, cudaStream_t stream) {
  switch (tile_rows(p.hd * static_cast<int>(sizeof(KV)))) {
    case 64: return launch_split<KV, 64>(p, B, stream);
    case 32: return launch_split<KV, 32>(p, B, stream);
    default: return launch_split<KV, 16>(p, B, stream);
  }
}

inline int elt(int kv_dtype) { return kv_dtype == 1 ? 2 : 4; }

}  // namespace decode_attention

extern "C" {

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The number of splits the launch makes for these shapes (kv_dtype 0: f32,
// 1: bf16): the workspace holds (B, H, splits, hd + 2) f32 when above 1.
int decode_attention_splits(int kv_dtype, int B, int K, int G, int L,
                            int hd) {
  using namespace decode_attention;
  const int T = tile_rows(hd * elt(kv_dtype));
  const int per = split_positions(B, K, G, L, T);
  return (L + per - 1) / per;
}

// The split kernel's launch for these shapes, on the current device:
// shape[0..8] = K/V rows a tile, ring stages, splits, blocks, threads a
// block, dynamic shared bytes a block, resident blocks an SM, registers a
// thread and local (spilled) bytes a thread. Returns 0, else the CUDA error.
int decode_attention_launch_shape(int kv_dtype, int B, int K, int G, int L,
                                  int hd, int* shape) {
  using namespace decode_attention;
  const int T = tile_rows(hd * elt(kv_dtype));
  const void* k =
      kv_dtype == 1
          ? (T == 64 ? reinterpret_cast<const void*>(
                           split_kernel<__nv_bfloat16, 64>)
             : T == 32 ? reinterpret_cast<const void*>(
                             split_kernel<__nv_bfloat16, 32>)
                       : reinterpret_cast<const void*>(
                             split_kernel<__nv_bfloat16, 16>))
          : (T == 64 ? reinterpret_cast<const void*>(split_kernel<float, 64>)
             : T == 32 ? reinterpret_cast<const void*>(
                             split_kernel<float, 32>)
                       : reinterpret_cast<const void*>(
                             split_kernel<float, 16>));
  const int smem = Layout(hd, elt(kv_dtype), T).bytes;
  const int per = split_positions(B, K, G, L, T);
  int blocks = 0;
  cudaFuncAttributes attr{};
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, THREADS,
                                                      smem);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, k);
  shape[0] = T;
  shape[1] = STAGES;
  shape[2] = (L + per - 1) / per;
  shape[3] = B * K * head_groups(G) * shape[2];
  shape[4] = THREADS;
  shape[5] = smem;
  shape[6] = blocks;
  shape[7] = attr.numRegs;
  shape[8] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(e);
}

// Launches the split kernel, and the combine kernel when there is more than
// one split, on `stream`. q and out: (B, H, hd) contiguous, q_dtype 0 f32,
// 1 bf16; k, v: (B, L, K, hd) of kv_dtype with the given element strides
// (the last one 1; data and strides 16 B aligned); q_pos (1,) and kv_pos
// (L,) int64; work: the workspace when splits > 1. The caller guarantees
// B, K, L >= 1, H = K * G, hd a multiple of 8 up to 256, 0 < softcap or
// softcap = 0 for none. Returns 0 when both launches were accepted, else
// the CUDA error.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const long long* q_pos, const long long* kv_pos,
                            void* out, float* work, int q_dtype,
                            int kv_dtype, int B, int H, int K, int L, int hd,
                            long long k_sb, long long k_sl, long long k_sh,
                            long long v_sb, long long v_sl, long long v_sh,
                            int causal, long long window, float scale,
                            float softcap, void* stream) {
  using namespace decode_attention;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Params p;
  p.q = q; p.k = k; p.v = v; p.q_pos = q_pos; p.kv_pos = kv_pos;
  p.out = out; p.part = work;
  p.k_sb = k_sb; p.k_sl = k_sl; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_sl = v_sl; p.v_sh = v_sh;
  p.H = H; p.K = K; p.L = L; p.hd = hd;
  p.G = H / K;
  p.NG = head_groups(p.G);
  p.GB = (p.G + p.NG - 1) / p.NG;
  const int T = tile_rows(hd * elt(kv_dtype));
  p.split_pos = split_positions(B, K, p.G, L, T);
  p.S = (L + p.split_pos - 1) / p.split_pos;
  p.q_bf16 = q_dtype == 1;
  p.causal = causal; p.window = window;
  p.scale = scale; p.softcap = softcap;
  cudaError_t e;
  if (kv_dtype == 1)
    e = launch_kv<__nv_bfloat16>(p, B, st);
  else if (kv_dtype == 0)
    e = launch_kv<float>(p, B, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (e != cudaSuccess || p.S == 1) return static_cast<int>(e);
  const int threads = (hd + WARP - 1) / WARP * WARP;
  combine_kernel<<<static_cast<unsigned>(B) * H, threads, 0, st>>>(
      work, out, p.q_bf16, p.S, hd);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
