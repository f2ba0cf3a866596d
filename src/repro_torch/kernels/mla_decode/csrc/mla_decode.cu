// mla_decode for Hopper (sm_90a): the absorbed decode step of multi-head
// latent attention (DeepSeek-V3's, Kimi-K2's), one query position a sequence
// over the latent cache. Each cached position holds one 576-wide row,
// [c_kv (R = 512) | k_pe (64)], shared by every query head; the queries
// come absorbed, qf = [q_nope . W_kv_b^nope | q_pe] (B, H, 576). For every
// head: scores qf . row over positions 0..pos, times `scale`, an online
// softmax in f32, and o_lat = p . c_kv (B, H, 512), returned in bf16.
//
// Replaces no TPU kernel: the reference's latent attention is plain JAX
// (src/repro/models/), and the port's plain step is a chain of batched
// products, an f32 mask and softmax over the whole static cache and a second
// product that reads the cache again (kernels/mla_decode/ref.py).
//
// Bound on this card: bytes. The valid latent rows are read once (1,152 B a
// position), qf read and the output written once, over 3.35 TB/s. The work
// is 2 * H * (576 + 512) operations a position: at H = 64, ~121 a byte read,
// so on CUDA cores (~60 TFLOP/s of f32 FMA) it would take longer than the
// bytes; the products run on the tensor cores (wgmma, bf16 operands, f32
// sums), where they take under half of the bytes' time.
//
// Design (FlashMLA's shape):
//   - a block owns one sequence, 64 of its query heads (the wgmma's M) and
//     one split of the positions; the splits are fixed by the shapes
//     (blocks to fill the card's 132 SMs, one a block), and each block
//     derives its tiles from the position on the device, so the grid is the
//     same at every position (a CUDA graph captures it once) and a split
//     with no valid tile exits at once;
//   - one thread of a producer warpgroup loads the block's qf (64 x 576)
//     once, then streams tiles of 64 positions x 576 through a two-stage
//     ring by TMA (nine 64 x 64 boxes a tile, 128 B swizzled), full and
//     empty mbarriers a stage; positions past the cache's end load as zeros
//     and are masked. The producer warpgroup hands its registers to the two
//     consumer warpgroups (setmaxnreg: 40 and 232 a thread; at the 168 a
//     thread that 384 threads launch with, the accumulators spilled);
//   - consumer warpgroup 0 takes the scores S = qf . tile^T (m64n64k16 over
//     the 576 columns, both operands K-major in shared memory), masks
//     positions past pos, runs the online softmax in f32 (log2 domain) and
//     hands P (bf16, in its register fragments) and the rescale factors to
//     warpgroup 1 through shared memory; each warpgroup then rescales its
//     half of the 64 x 512 f32 accumulator (128 registers a thread) and adds
//     P . V for its 256 columns (m64n256k16, P from registers, V the same
//     staged tile's first 512 columns read MN-major): each latent row
//     crosses device memory once;
//   - each split writes its unnormalised f32 accumulator and (m, l) a head;
//     a combine kernel merges the splits in split order and writes bf16.
// On an H100 at kimi-k2-decode's shape the ring's depth is not what limits
// it: 32-position tiles in four stages ran 2-3% slower, and with the
// products and the softmax taken out the same stream took 88% of the time.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace mla_decode {

constexpr int R = 512;                  // latent rank: c_kv, the values
constexpr int WIDTH = R + 64;           // a cached row: c_kv and k_pe
constexpr int HB = 64;                  // query heads a block (wgmma M)
constexpr int T = 64;                   // positions a tile
constexpr int CH = 64;                  // bf16 columns a 128 B box row
constexpr int NCH = WIDTH / CH;         // 9 boxes a tile
constexpr int STAGES = 2;
constexpr int BOX_BYTES = T * CH * 2;   // 8,192 (qf's boxes: HB rows, same)
constexpr int TILE_BYTES = NCH * BOX_BYTES;   // 73,728
constexpr int WG = 128;                 // threads a warpgroup
constexpr int THREADS = 3 * WG;         // two consumer warpgroups, a producer
constexpr int PRODUCER_REGS = 40;       // setmaxnreg: 128 x 40 + 256 x 232
constexpr int CONSUMER_REGS = 232;      // = 384 x 168, the launch's registers
constexpr int SMS = 132;                // H100 SXM
constexpr int P_WORDS = 16;             // bf16 pairs of P a consumer thread
// dynamic shared memory, from a 1,024 B aligned base: qf, the ring, P and
// the rescale factors handed from warpgroup 0 to 1, the mbarriers
constexpr int OFF_Q = 0;
constexpr int OFF_RING = TILE_BYTES;
constexpr int OFF_P = OFF_RING + STAGES * TILE_BYTES;
constexpr int OFF_C = OFF_P + P_WORDS * WG * 4;
constexpr int OFF_BAR = OFF_C + 2 * WG * 4;
constexpr int SMEM_BYTES = OFF_BAR + (1 + 2 * STAGES) * 8 + 1024;
static_assert(SMEM_BYTES <= 232448, "over the 227 KB a block may have");
constexpr int BAR_P_FULL = 1;           // named barriers of the consumers
constexpr int BAR_P_EMPTY = 2;
constexpr int ENCODE_ERROR = 100000;    // + the CUDA driver API's CUresult

struct Params {
  const long long* pos;     // (): the query's position
  float* part;              // (B, H, S, R): each split's unnormalised sums
  float* ml;                // (B, H, S, 2): its running max (log2) and sum
  int H, L, S;
  float scale_log2;         // scale * log2(e)
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

// one box of a 3-D tensor map (coordinates innermost first) into shared
// memory, its bytes counted on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(2 * WG) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(2 * WG) : "memory");
}

// A wgmma shared-memory descriptor of a 128 B swizzled operand (1,024 B
// aligned atoms of 8 rows of 128 B): start address, leading and stride
// byte offsets. K-major: lbo unused (16), sbo the next 8 rows (1,024).
// MN-major: lbo the next 64 columns' box, sbo the next 8 rows along K.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFFull) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// S (64 x 64, f32) += A (64 x 16) . B (64 x 16)^T, both K-major, 128 B
// swizzled in shared memory; scale_d 0 starts S at A . B^T
__device__ __forceinline__ void wgmma_scores(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n\t}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O (64 x 256, f32) += P (64 x 16, bf16 pairs in the A fragments of a
// warpgroup's registers) . V (16 x 256), V MN-major (transposed) in shared
// memory, 128 B swizzled: 4 boxes of 64 columns at lbo
__device__ __forceinline__ void wgmma_pv(float (&d)[128], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %133, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n\t}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The consumer warpgroups of the split kernel: 0 (warps 0-3) takes the
// scores and the softmax and hands P to 1 (warps 4-7); each adds P . V for
// its 256 columns and writes them.
__device__ __forceinline__ void consume(unsigned char* smem, const Params& p,
                                        long long n, int nt, int t0,
                                        int split, long long bh0, int tid) {
  uint32_t* p_hand = reinterpret_cast<uint32_t*>(smem + OFF_P);
  float* c_hand = reinterpret_cast<float*>(smem + OFF_C);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;
  const int lane = tid % 32, warp = tid / 32;
  const int wt = tid % WG;                     // thread of its warpgroup
  const int quad = lane & 3;
  float o[128];
#pragma unroll
  for (int x = 0; x < 128; ++x) o[x] = 0.f;
  uint32_t pk[P_WORDS];

  if (warp < 4) {
    // warpgroup 0: scores, softmax, P handed over; then columns 0..255
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    mbar_wait(q_full, 0);
    for (int i = 0; i < nt; ++i) {
      const int s = i % STAGES;
      mbar_wait(&full[s], (i / STAGES) & 1);
      const unsigned char* st = smem + OFF_RING + s * TILE_BYTES;
      float sc[32];
#pragma unroll
      for (int x = 0; x < 32; ++x) sc[x] = 0.f;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int k = 0; k < CH / 16; ++k)
          wgmma_scores(
              sc,
              sw128_desc(smem + OFF_Q + c * BOX_BYTES + k * 32, 16, 1024),
              sw128_desc(st + c * BOX_BYTES + k * 32, 16, 1024),
              (c | k) != 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // mask past pos, the rows' maxima (a row over the 4 threads of a quad)
      const long long base = static_cast<long long>(t0 + i) * T;
      const bool edge = base + T > n;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        float v = sc[x] * p.scale_log2;
        if (edge && base + 8 * (x / 4) + 2 * quad + (x & 1) >= n)
          v = -INFINITY;
        sc[x] = v;
        if (x & 2)
          mx1 = fmaxf(mx1, v);
        else
          mx0 = fmaxf(mx0, v);
      }
#pragma unroll
      for (int o2 = 1; o2 < 4; o2 <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o2));
      }
      // every row has a valid position in each tile read: the new maxima
      // are finite, and exp2(-inf) = 0 for the first tile's rescale
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      const float c0 = exp2f(m0 - n0), c1 = exp2f(m1 - n1);
      m0 = n0;
      m1 = n1;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const float e = exp2f(sc[x] - ((x & 2) ? n1 : n0));
        sc[x] = e;
        if (x & 2)
          s1 += e;
        else
          s0 += e;
      }
      l0 = l0 * c0 + s0;                       // this thread's columns
      l1 = l1 * c1 + s1;
      // P in the A fragments of m64n256k16: k-step kk holds positions
      // 16 kk .. 16 kk + 15
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pk[4 * kk + 0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pk[4 * kk + 1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pk[4 * kk + 2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pk[4 * kk + 3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      if (i > 0) named_sync(BAR_P_EMPTY);      // warpgroup 1 read the last
#pragma unroll
      for (int w = 0; w < P_WORDS; ++w) p_hand[w * WG + wt] = pk[w];
      c_hand[wt] = c0;
      c_hand[WG + wt] = c1;
      __threadfence_block();
      named_arrive(BAR_P_FULL);

#pragma unroll
      for (int x = 0; x < 128; ++x) o[x] *= (x & 2) ? c1 : c0;
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_pv(o, pk + 4 * kk,
                 sw128_desc(st + kk * 16 * 128, BOX_BYTES, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    named_sync(BAR_P_EMPTY);                   // the last P was read
#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o2);
    }
    if (quad == 0) {
      const int r = (warp % 4) * 16 + lane / 4;
      float* w = p.ml + ((bh0 + r) * p.S + split) * 2;
      w[0] = m0;
      w[1] = l0;
      w = p.ml + ((bh0 + r + 8) * p.S + split) * 2;
      w[0] = m1;
      w[1] = l1;
    }
  } else {
    // warpgroup 1: columns 256..511 with warpgroup 0's P
    for (int i = 0; i < nt; ++i) {
      const int s = i % STAGES;
      mbar_wait(&full[s], (i / STAGES) & 1);
      const unsigned char* st = smem + OFF_RING + s * TILE_BYTES;
      named_sync(BAR_P_FULL);
#pragma unroll
      for (int w = 0; w < P_WORDS; ++w) pk[w] = p_hand[w * WG + wt];
      const float c0 = c_hand[wt], c1 = c_hand[WG + wt];
#pragma unroll
      for (int x = 0; x < 128; ++x) o[x] *= (x & 2) ? c1 : c0;
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_pv(o, pk + 4 * kk,
                 sw128_desc(st + 4 * BOX_BYTES + kk * 16 * 128, BOX_BYTES,
                            1024));
      wgmma_commit();
      named_arrive(BAR_P_EMPTY);               // P is in registers, issued
      wgmma_wait_all();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }

  // this warpgroup's 256 columns of the split's sums
  const int col0 = warp < 4 ? 0 : 256;
  const int r = (warp % 4) * 16 + lane / 4;
  float* w0 = p.part + ((bh0 + r) * p.S + split) * R + col0 + 2 * quad;
  float* w1 = p.part + ((bh0 + r + 8) * p.S + split) * R + col0 + 2 * quad;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    *reinterpret_cast<float2*>(w0 + 8 * j) =
        make_float2(o[4 * j], o[4 * j + 1]);
    *reinterpret_cast<float2*>(w1 + 8 * j) =
        make_float2(o[4 * j + 2], o[4 * j + 3]);
  }
}

// The split kernel: grid (S, H / 64, B).
__global__ void __launch_bounds__(THREADS, 1)
    split_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kvmap, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int split = blockIdx.x, hg = blockIdx.y, b = blockIdx.z;
  long long n = *p.pos + 1;                    // positions 0..pos are seen
  n = n < 0 ? 0 : (n > p.L ? p.L : n);
  const int n_tiles = static_cast<int>((n + T - 1) / T);
  const int t0 = static_cast<int>(static_cast<long long>(split) * n_tiles /
                                  p.S);
  const int t1 = static_cast<int>(static_cast<long long>(split + 1) *
                                  n_tiles / p.S);
  const int nt = t1 - t0;
  const long long bh0 = static_cast<long long>(b) * p.H + hg * HB;
  if (nt == 0) {                               // nothing to read: (m, l)
    if (tid < HB) {
      float* w = p.ml + ((bh0 + tid) * p.S + split) * 2;
      w[0] = -INFINITY;
      w[1] = 0.f;
    }
    return;
  }
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);                 // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // the producer warpgroup gives its registers to the consumers; its
    // first lane loads qf once, then the tiles through the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (warp == 8 && lane == 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&kvmap))
                   : "memory");
      mbar_expect_tx(q_full, TILE_BYTES);
      for (int c = 0; c < NCH; ++c)
        tma_load(smem + OFF_Q + c * BOX_BYTES, &qmap, c * CH, hg * HB, b,
                 q_full);
      for (int i = 0; i < nt; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], TILE_BYTES);
        unsigned char* st = smem + OFF_RING + s * TILE_BYTES;
        for (int c = 0; c < NCH; ++c)
          tma_load(st + c * BOX_BYTES, &kvmap, c * CH, (t0 + i) * T, b,
                   &full[s]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    consume(smem, p, n, nt, t0, split, bh0, tid);
  }
}

// The splits of (b, h) merged in split order: M = max m_s, out = sum
// 2^(m_s - M) acc_s / sum 2^(m_s - M) l_s. A split with no position read
// holds m = -inf and adds nothing (its sums are never written).
__global__ void __launch_bounds__(R / 4)
    combine_kernel(const float* __restrict__ part,
                   const float* __restrict__ ml, __nv_bfloat16* out, int S) {
  const long long bh = blockIdx.x;
  const float* w = ml + bh * S * 2;
  float M = -INFINITY;
  for (int s = 0; s < S; ++s) M = fmaxf(M, w[2 * s]);
  float Lsum = 0.f;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  const int d = 4 * threadIdx.x;
  if (M != -INFINITY) {
    for (int s = 0; s < S; ++s) {
      const float m = w[2 * s];
      if (m == -INFINITY) continue;
      const float e = exp2f(m - M);
      Lsum = fmaf(e, w[2 * s + 1], Lsum);
      const float4 v = *reinterpret_cast<const float4*>(
          part + (bh * S + s) * R + d);
      a.x = fmaf(e, v.x, a.x);
      a.y = fmaf(e, v.y, a.y);
      a.z = fmaf(e, v.z, a.z);
      a.w = fmaf(e, v.w, a.w);
    }
  }
  const float inv = Lsum > 0.f ? 1.f / Lsum : 0.f;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out + bh * R + d);
  o[0] = __floats2bfloat162_rn(a.x * inv, a.y * inv);
  o[1] = __floats2bfloat162_rn(a.z * inv, a.w * inv);
}

// Splits a call makes: enough blocks to fill the card at one a block, each
// split one tile at least.
inline int splits(int B, int H, int L) {
  const long long blocks = static_cast<long long>(B) * (H / HB);
  long long s = blocks >= SMS ? 1 : SMS / blocks;
  const int tiles = (L + T - 1) / T;
  if (s > tiles) s = tiles;
  return static_cast<int>(s < 1 ? 1 : s);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the CUDA driver API's cuTensorMapEncodeTiled, through the runtime (no
// -lcuda)
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// a (rows of WIDTH bf16) x n1 x n2 tensor with row and plane strides in
// bytes, read in boxes of 64 columns x 64 rows, 128 B swizzled
static int encode(CUtensorMap* map, const void* base, long long n1,
                  long long n2, long long s1, long long s2) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ENCODE_ERROR;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(WIDTH),
                              static_cast<cuuint64_t>(n1),
                              static_cast<cuuint64_t>(n2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(s1),
                                 static_cast<cuuint64_t>(s2)};
  const cuuint32_t box[3] = {CH, T, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + static_cast<int>(r);
}

static bool smem_set = false;

}  // namespace mla_decode

extern "C" {

const char* mla_decode_error_string(int code) {
  if (code >= mla_decode::ENCODE_ERROR)
    return "cuTensorMapEncodeTiled failed (or is missing from the CUDA driver)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int mla_decode_splits(int B, int H, int L) {
  return mla_decode::splits(B, H, L);
}

// The split kernel's launch for these shapes on the current device:
// shape[0..8] = positions a tile, ring stages, splits, blocks, threads a
// block, dynamic shared bytes a block, resident blocks an SM, registers a
// thread and local (spilled) bytes a thread. Returns 0, else the CUDA error.
int mla_decode_launch_shape(int B, int H, int L, int* shape) {
  using namespace mla_decode;
  const void* k = reinterpret_cast<const void*>(split_kernel);
  int blocks = 0;
  cudaFuncAttributes attr{};
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, THREADS,
                                                      SMEM_BYTES);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, k);
  const int S = splits(B, H, L);
  shape[0] = T;
  shape[1] = STAGES;
  shape[2] = S;
  shape[3] = S * (H / HB) * B;
  shape[4] = THREADS;
  shape[5] = SMEM_BYTES;
  shape[6] = blocks;
  shape[7] = attr.numRegs;
  shape[8] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(e);
}

// Launches the split kernel and the combine kernel on `stream`. qf: (B, H,
// 576) bf16, contiguous; latent: (B, L, 576) bf16 with element strides
// lat_sb, lat_sl (the last dim contiguous; data and strides on 16 B); pos:
// a device int64 scalar; part (B, H, S, 512) and ml (B, H, S, 2) f32
// workspaces, S = mla_decode_splits(B, H, L); out (B, H, 512) bf16. The
// caller guarantees B in [1, 65535], H a positive multiple of 64, L >= 1.
// Returns 0 when both launches were accepted, else an error code.
int mla_decode_launch(const void* qf, const void* latent,
                      const long long* pos, float* part, float* ml,
                      void* out, int B, int H, int L, long long lat_sb,
                      long long lat_sl, float scale, void* stream) {
  using namespace mla_decode;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap qmap, kvmap;
  int err = encode(&qmap, qf, H, B, static_cast<long long>(WIDTH) * 2,
                   static_cast<long long>(H) * WIDTH * 2);
  if (err != 0) return err;
  err = encode(&kvmap, latent, L, B, lat_sl * 2, lat_sb * 2);
  if (err != 0) return err;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  Params p;
  p.pos = pos;
  p.part = part;
  p.ml = ml;
  p.H = H;
  p.L = L;
  p.S = splits(B, H, L);
  p.scale_log2 = scale * 1.4426950408889634f;
  const dim3 grid(p.S, H / HB, B);
  split_kernel<<<grid, THREADS, SMEM_BYTES, st>>>(qmap, kvmap, p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  combine_kernel<<<static_cast<unsigned>(B) * H, R / 4, 0, st>>>(
      part, ml, static_cast<__nv_bfloat16*>(out), p.S);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
