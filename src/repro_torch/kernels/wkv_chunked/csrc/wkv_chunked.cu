// wkv_chunked for Hopper (sm_90a): RWKV-6's sequence form, the chunked
// linear-attention recurrence of a whole prompt in one launch. Per (batch,
// head), over chunks of C = 64 tokens with cum the inclusive cumulative
// log-decay inside the chunk and cp = cum - lw the exclusive one:
//
//   A[t,s] = sum_i r[t,i] k[s,i] exp(min(cp[t,i] - cum[s,i], 0))   (s < t)
//   A[t,t] = sum_i r[t,i] u[i] k[t,i]
//   y[t,j] = sum_i r[t,i] exp(cp[t,i]) S[i,j] + sum_{s<=t} A[t,s] v[s,j]
//   S'[i,j] = exp(cum_C[i]) S[i,j]
//             + sum_s k[s,i] exp(min(cum_C[i] - cum[s,i], 0)) v[s,j]
//
// with r, k, v, lw (B, S, H, hd) f32, u (H, hd), the state S (B, H, hd, hd)
// f32; y (B, S, H, hd) f32 and the final state written to new tensors.
// This is the plain chain of models/rwkv6.py (kernels/wkv_chunked/ref.py)
// with the same per-element exponent, every one <= 0, never factored into
// exp(cp) * exp(-cum), which overflows under strong decay.
//
// Replaces no TPU kernel: the reference's sequence form is plain JAX
// (src/repro/models/rwkv6.py wkv_chunked). The plain chain materialises
// the (B, C, C, H, hd) f32 exponent tensor a chunk, ~6 passes over it, 64
// chunks a layer walked by the host.
//
// Bound on this card at rwkv6-prefill's shape (B 8, S 4,096, H 32, hd 64):
// the bytes of r, k, v, lw read and y written, 5 x 268 MB = 1.34 GB a
// layer, ~0.40 ms at 3.35 TB/s. The per-element exponent costs this design
// C(C-1)/2 * hd exponentials a chunk and head (2.1e9 a layer), ~0.5 ms a
// layer on the SFUs at 16 a clock an SM: a cost of keeping the exponent
// unfactored, not a floor of the function (factoring it around a sub-chunk
// boundary keeps every exponent <= 0 with far fewer). The products
// (~2.6e10 FLOP a layer) are ~0.4 ms on CUDA cores in f32: no TF32, no bf16.
//
// Design:
//   - one block of 256 threads per (b, h), walking the chunks in order and
//     carrying its (hd, hd) state in shared memory; nothing carries between
//     blocks. 115,200 B of shared memory
//     at hd 64 and at most 128 registers a thread, so two blocks share an
//     SM and one block's loads and barriers hide under the other's
//     arithmetic;
//   - the chunk's r, k, lw are staged transposed ([i][t]) with a 16 B
//     XOR swizzle, v as rows; the next chunk's r and lw are fetched into
//     registers while y is computed, k and v after the state update; a
//     padded last chunk (any S) loads zeros, so lw = 0 carries cum on and
//     k = 0 adds nothing to the state;
//   - the cumulative log-decay is scanned in shared memory, 256 / hd
//     segments a column joined by warp shuffles, and kept in log2 units so
//     each exponential is one ex2.approx (the SFU);
//   - scores, where the exponentials fall: two rounds of the 256 threads, the
//     exponentials spread evenly over the four SM sub-partitions and none
//     spent above the diagonal. The 120 4 x 4 (t, s) tiles below the
//     diagonal are split over 4 lanes by the key index (i = q mod 4), the
//     16 diagonal tiles (the last warp) over 2 lanes and their 6 pairs
//     s < t alone, summed by shuffles. The (C, C) scores live in shared
//     memory only;
//   - y and the new state are 4 x 4 register tiles over shared memory in
//     f32 fused multiply-adds, y written straight from registers; the
//     warps' t-blocks are paired so that each sub-partition gets an even
//     share of the triangle A . v.
#include <cuda_runtime.h>

namespace wkv_chunked {

constexpr int C = 64;             // tokens a chunk
constexpr int THREADS = 256;
// score items: the (t, s) 4x4 tiles below the diagonal, a key quarter each;
// the diagonal tiles, a key half each
constexpr int OFF_ITEMS = C / 4 * (C / 4 - 1) / 2 * 4;
constexpr int DIAG_ITEMS = C / 4 * 2;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The transposed arrays hold row i (a key index) of C floats; its 16 B
// chunk t / 4 lies at chunk (t / 4) ^ swz(i). The four quarter lanes of a
// score tile (rows i, i+1, i+2, i+3) and the two tiles beside it land on
// distinct banks, as do 32 lanes storing consecutive t of one row.
__device__ __forceinline__ int swz(int i) {
  return ((i & 3) << 1) | ((i >> 2) & 1);
}
__device__ __forceinline__ int at(int i, int t) {
  return i * C + ((((t >> 2) ^ swz(i)) << 2) | (t & 3));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ float get(const float4& x, int a) {
  return a == 0 ? x.x : a == 1 ? x.y : a == 2 ? x.z : x.w;
}

template <int HD>
constexpr size_t smem_floats() {
  // RT, PT, KT, CT [HD][C]; V [C][HD]; AT [C][C]; S [HD][HD]; bonus [C];
  // cend [HD]
  return 4 * HD * C + C * HD + C * C + HD * HD + C + HD;
}

// A thread's share of one transposed array of a chunk (HD / 16 pieces of
// 16 B of its row t), and of the chunk's v rows.
template <int HD>
struct RowsT {
  float4 x[HD / 16];
};
template <int HD>
struct RowsV {
  float4 x[C * HD / 4 / THREADS];
};

// Reads src[t][i] of a chunk (zeros for rows t >= valid). Lanes take
// consecutive t; a thread reads HD / 16 consecutive 16 B pieces of its row.
template <int HD>
__device__ __forceinline__ RowsT<HD> fetch_t(const float* src,
                                             long long stride, int valid,
                                             int tid) {
  constexpr int PER = HD / 16;
  const int t = tid % C, q = tid / C;
  const float4* row = reinterpret_cast<const float4*>(src + t * stride);
  RowsT<HD> out;
#pragma unroll
  for (int m = 0; m < PER; ++m)
    out.x[m] = t < valid ? __ldg(row + q * PER + m)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
  return out;
}

// dst[at(i, t)] = src[t][i], from what fetch_t read.
template <int HD>
__device__ __forceinline__ void store_t(float* dst, const RowsT<HD>& in,
                                        int tid) {
  constexpr int PER = HD / 16;
  const int t = tid % C, q = tid / C;
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    const int c4 = q * PER + m;
    dst[at(4 * c4 + 0, t)] = in.x[m].x;
    dst[at(4 * c4 + 1, t)] = in.x[m].y;
    dst[at(4 * c4 + 2, t)] = in.x[m].z;
    dst[at(4 * c4 + 3, t)] = in.x[m].w;
  }
}

// The chunk's v rows.
template <int HD>
__device__ __forceinline__ RowsV<HD> fetch_v(const float* src,
                                             long long stride, int valid,
                                             int tid) {
  constexpr int JT = HD / 4;
  RowsV<HD> out;
#pragma unroll
  for (int n = 0; n < C * HD / 4 / THREADS; ++n) {
    const int e = tid + n * THREADS, s = e / JT, j4 = (e % JT) * 4;
    out.x[n] = s < valid ? __ldg(reinterpret_cast<const float4*>(
                               src + s * stride + j4))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  return out;
}

template <int HD>
__device__ __forceinline__ void store_v(float* V, const RowsV<HD>& in,
                                        int tid) {
  constexpr int JT = HD / 4;
#pragma unroll
  for (int n = 0; n < C * HD / 4 / THREADS; ++n) {
    const int e = tid + n * THREADS, s = e / JT, j4 = (e % JT) * 4;
    st4(V + s * HD + j4, in.x[n]);
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 2)
    wkv_chunked_kernel(const float* __restrict__ r,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ lw,
                       const float* __restrict__ u,
                       const float* __restrict__ s0, float* __restrict__ y,
                       float* __restrict__ s_out, int S, int H) {
  constexpr int JT = HD / 4;                    // 4-column tiles of v
  static_assert(HD % 16 == 0, "widths");
  static_assert(THREADS % HD == 0 && C % (THREADS / HD) == 0, "scan");
  static_assert(OFF_ITEMS + DIAG_ITEMS == 2 * THREADS, "score rounds");
  extern __shared__ float4 smem4[];
  float* RT = reinterpret_cast<float*>(smem4);  // r, then r exp(cp)
  float* PT = RT + HD * C;                      // cp log2(e)
  float* KT = PT + HD * C;                      // k, then its state decay
  float* CT = KT + HD * C;                      // lw, then cum log2(e)
  float* V = CT + HD * C;                       // [s][j]
  float* AT = V + C * HD;                       // scores, AT[s * C + t]
  float* SS = AT + C * C;                       // state [i][j]
  float* bonus = SS + HD * HD;                  // A[t, t]
  float* cend = bonus + C;                      // cum_C log2(e)

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long bh = blockIdx.x;
  const int h = static_cast<int>(bh % H);
  const long long b = bh / H;
  const long long stride = static_cast<long long>(H) * HD;  // a token
  const long long base = (b * S * H + h) * HD;              // token 0

  for (int e = tid; e < HD * JT; e += THREADS) {
    const int i = e / JT, j4 = (e % JT) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s0 != nullptr)
      x = __ldg(reinterpret_cast<const float4*>(s0 + (bh * HD + i) * HD +
                                                j4));
    st4(SS + i * HD + j4, x);
  }
  // chunk 0 staged here; of each later one r and lw are fetched into
  // registers under the previous chunk's y, k and v after its state update
  const int n_chunks = (S + C - 1) / C;
  if (n_chunks > 0) {
    const int valid = min(C, S);
    store_t<HD>(RT, fetch_t<HD>(r + base, stride, valid, tid), tid);
    store_t<HD>(CT, fetch_t<HD>(lw + base, stride, valid, tid), tid);
    store_t<HD>(KT, fetch_t<HD>(k + base, stride, valid, tid), tid);
    store_v<HD>(V, fetch_v<HD>(v + base, stride, valid, tid), tid);
  }
  __syncthreads();

  for (int c = 0; c < n_chunks; ++c) {
    const long long off = base + static_cast<long long>(c) * C * stride;
    const int valid = min(C, S - c * C);
    const bool more = c + 1 < n_chunks;
    const long long off_n = off + C * stride;
    const int valid_n = min(C, S - (c + 1) * C);

    // -- cumulative log-decay: SEG segments of L rows a column, joined by
    //    an exclusive shuffle scan of the segment sums
    {
      constexpr int SEG = THREADS / HD;
      constexpr int L = C / SEG;
      const int i = tid / SEG, seg = tid % SEG;
      float w[L];
#pragma unroll
      for (int m = 0; m < L / 4; ++m) {
        const float4 x = ld4(CT + at(i, seg * L + 4 * m));
        w[4 * m] = x.x;
        w[4 * m + 1] = x.y;
        w[4 * m + 2] = x.z;
        w[4 * m + 3] = x.w;
      }
      float tot = 0.f;
#pragma unroll
      for (int x = 0; x < L; ++x) tot += w[x];
      float incl = tot;
#pragma unroll
      for (int o = 1; o < SEG; o <<= 1) {
        const float n = __shfl_up_sync(0xffffffffu, incl, o, SEG);
        if (seg >= o) incl += n;
      }
      float run = __shfl_up_sync(0xffffffffu, incl, 1, SEG);
      if (seg == 0) run = 0.f;
#pragma unroll
      for (int m = 0; m < L / 4; ++m) {
        float4 cc, cp;
        run += w[4 * m];
        cc.x = run * LOG2E;
        cp.x = (run - w[4 * m]) * LOG2E;
        run += w[4 * m + 1];
        cc.y = run * LOG2E;
        cp.y = (run - w[4 * m + 1]) * LOG2E;
        run += w[4 * m + 2];
        cc.z = run * LOG2E;
        cp.z = (run - w[4 * m + 2]) * LOG2E;
        run += w[4 * m + 3];
        cc.w = run * LOG2E;
        cp.w = (run - w[4 * m + 3]) * LOG2E;
        st4(CT + at(i, seg * L + 4 * m), cc);
        st4(PT + at(i, seg * L + 4 * m), cp);
      }
      // the current token's bonus, A[t, t] = sum_i r u k
      if (tid < C) {
        const float* uh = u + static_cast<long long>(h) * HD;
        float acc = 0.f;
#pragma unroll 8
        for (int ii = 0; ii < HD; ++ii)
          acc = fmaf(RT[at(ii, tid)] * __ldg(uh + ii), KT[at(ii, tid)], acc);
        bonus[tid] = acc;
      }
    }
    __syncthreads();

    // -- scores, exactly two rounds of the block: the 120 tiles (T, Q)
    //    with Q < T, each over a quarter of the keys (i = q mod 4), then
    //    (the last warp) the 16 diagonal tiles, each over half of them
    //    (i = hf mod 2) and on its 6 pairs s < t alone
    for (int it = tid; it < OFF_ITEMS + DIAG_ITEMS; it += THREADS) {
      if (it < OFF_ITEMS) {
        const int tile = it >> 2, q = it & 3;
        int T = static_cast<int>((1.f + sqrtf(8.f * tile + 1.f)) * 0.5f);
        if (T * (T - 1) / 2 > tile) --T;
        if ((T + 1) * T / 2 <= tile) ++T;
        const int Q = tile - T * (T - 1) / 2;
        const int t0 = 4 * T, s0i = 4 * Q;
        float acc[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) acc[a][bb] = 0.f;
#pragma unroll 4
        for (int m = 0; m < HD / 4; ++m) {
          const int i = q + 4 * m;
          const float4 r4 = ld4(RT + at(i, t0));
          const float4 p4 = ld4(PT + at(i, t0));
          const float4 k4 = ld4(KT + at(i, s0i));
          const float4 c4 = ld4(CT + at(i, s0i));
          const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
          const float pp[4] = {p4.x, p4.y, p4.z, p4.w};
          const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
          const float cc[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int bb = 0; bb < 4; ++bb)
              acc[a][bb] = fmaf(rr[a] * kk[bb],
                                ex2(fminf(pp[a] - cc[bb], 0.f)), acc[a][bb]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) {
            acc[a][bb] += __shfl_xor_sync(0xffffffffu, acc[a][bb], 1);
            acc[a][bb] += __shfl_xor_sync(0xffffffffu, acc[a][bb], 2);
          }
        // lane q writes column s = s0i + q of the tile: AT[s][t0 .. t0+3]
        float o[4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          o[a] = q == 0 ? acc[a][0] : q == 1 ? acc[a][1]
               : q == 2 ? acc[a][2] : acc[a][3];
        st4(AT + (s0i + q) * C + t0, make_float4(o[0], o[1], o[2], o[3]));
      } else {
        const int d = it - OFF_ITEMS, T = d >> 1, hf = d & 1, t0 = 4 * T;
        // pairs (t, s) - t0: (1,0) (2,0) (2,1) (3,0) (3,1) (3,2)
        float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int m = 0; m < HD / 2; ++m) {
          const int i = hf + 2 * m;
          const float4 r4 = ld4(RT + at(i, t0));
          const float4 p4 = ld4(PT + at(i, t0));
          const float4 k4 = ld4(KT + at(i, t0));
          const float4 c4 = ld4(CT + at(i, t0));
          acc[0] = fmaf(r4.y * k4.x, ex2(fminf(p4.y - c4.x, 0.f)), acc[0]);
          acc[1] = fmaf(r4.z * k4.x, ex2(fminf(p4.z - c4.x, 0.f)), acc[1]);
          acc[2] = fmaf(r4.z * k4.y, ex2(fminf(p4.z - c4.y, 0.f)), acc[2]);
          acc[3] = fmaf(r4.w * k4.x, ex2(fminf(p4.w - c4.x, 0.f)), acc[3]);
          acc[4] = fmaf(r4.w * k4.y, ex2(fminf(p4.w - c4.y, 0.f)), acc[4]);
          acc[5] = fmaf(r4.w * k4.z, ex2(fminf(p4.w - c4.z, 0.f)), acc[5]);
        }
#pragma unroll
        for (int x = 0; x < 6; ++x)
          acc[x] += __shfl_xor_sync(0xffffffffu, acc[x], 1);
        // lane hf writes columns s = t0 + 2 hf and t0 + 2 hf + 1: A[t, s]
        // below the diagonal, the bonus on it, zeros above it
        const float* bt = bonus + t0;
        if (hf == 0) {
          st4(AT + t0 * C + t0, make_float4(bt[0], acc[0], acc[1], acc[3]));
          st4(AT + (t0 + 1) * C + t0,
              make_float4(0.f, bt[1], acc[2], acc[4]));
        } else {
          st4(AT + (t0 + 2) * C + t0, make_float4(0.f, 0.f, bt[2], acc[5]));
          st4(AT + (t0 + 3) * C + t0, make_float4(0.f, 0.f, 0.f, bt[3]));
        }
      }
    }
    __syncthreads();

    // -- decays in place: r exp(cp), k exp(min(cum_C - cum, 0)); cum_C kept
    for (int e = tid; e < HD * C; e += THREADS) {
      const int i = e / C, t = e % C;
      const int x = at(i, t);
      RT[x] *= ex2(PT[x]);
      KT[x] *= ex2(fminf(CT[at(i, C - 1)] - CT[x], 0.f));
    }
    if (tid < HD) cend[tid] = CT[at(tid, C - 1)];
    __syncthreads();

    // -- y[t0..t0+3][j0..j0+3] = r exp(cp) . S + A . v, with the next
    //    chunk's r and lw on their way. The t-blocks go to warps so that
    //    the two warps of each SM sub-partition share the triangle of
    //    A . v evenly
    RowsT<HD> nr, nl;
    if (more) {
      nr = fetch_t<HD>(r + off_n, stride, valid_n, tid);
      nl = fetch_t<HD>(lw + off_n, stride, valid_n, tid);
    }
    if (tid < C / 4 * JT) {
      constexpr int NW = C / 4 * JT / 32;         // warps at work
      const int grp = NW == 8 && warp >= 4 ? 11 - warp : warp;
      const int x = grp * 32 + lane;
      const int T = x / JT, j4 = (x % JT) * 4, t0 = 4 * T;
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) acc[a][bb] = 0.f;
#pragma unroll 8
      for (int i = 0; i < HD; ++i) {
        const float4 r4 = ld4(RT + at(i, t0));
        const float4 s4 = ld4(SS + i * HD + j4);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float ra = get(r4, a);
          acc[a][0] = fmaf(ra, s4.x, acc[a][0]);
          acc[a][1] = fmaf(ra, s4.y, acc[a][1]);
          acc[a][2] = fmaf(ra, s4.z, acc[a][2]);
          acc[a][3] = fmaf(ra, s4.w, acc[a][3]);
        }
      }
#pragma unroll 4
      for (int s = 0; s < t0 + 4; ++s) {
        const float4 a4 = ld4(AT + s * C + t0);
        const float4 v4 = ld4(V + s * HD + j4);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float aa = get(a4, a);
          acc[a][0] = fmaf(aa, v4.x, acc[a][0]);
          acc[a][1] = fmaf(aa, v4.y, acc[a][1]);
          acc[a][2] = fmaf(aa, v4.z, acc[a][2]);
          acc[a][3] = fmaf(aa, v4.w, acc[a][3]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
        if (t0 + a < valid)
          st4(y + off + (t0 + a) * stride + j4,
              make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]));
    }
    __syncthreads();
    if (more) {
      store_t<HD>(RT, nr, tid);
      store_t<HD>(CT, nl, tid);
    }

    // -- S[i0..i0+3][j0..j0+3] = exp(cum_C) S + kdec^T v
    if (tid < HD / 4 * JT) {
      const int i0 = 4 * (tid / JT), j4 = (tid % JT) * 4;
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float dcy = ex2(cend[i0 + a]);
        const float4 s4 = ld4(SS + (i0 + a) * HD + j4);
        acc[a][0] = dcy * s4.x;
        acc[a][1] = dcy * s4.y;
        acc[a][2] = dcy * s4.z;
        acc[a][3] = dcy * s4.w;
      }
#pragma unroll 2
      for (int s = 0; s < C; s += 4) {
        float4 k4[4], v4[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) k4[a] = ld4(KT + at(i0 + a, s));
#pragma unroll
        for (int x = 0; x < 4; ++x) v4[x] = ld4(V + (s + x) * HD + j4);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const float kx = get(k4[a], x);
            acc[a][0] = fmaf(kx, v4[x].x, acc[a][0]);
            acc[a][1] = fmaf(kx, v4[x].y, acc[a][1]);
            acc[a][2] = fmaf(kx, v4[x].z, acc[a][2]);
            acc[a][3] = fmaf(kx, v4[x].w, acc[a][3]);
          }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
        st4(SS + (i0 + a) * HD + j4,
            make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]));
    }
    __syncthreads();
    if (more) {
      store_t<HD>(KT, fetch_t<HD>(k + off_n, stride, valid_n, tid), tid);
      store_v<HD>(V, fetch_v<HD>(v + off_n, stride, valid_n, tid), tid);
      __syncthreads();
    }
  }

  for (int e = tid; e < HD * JT; e += THREADS) {
    const int i = e / JT, j4 = (e % JT) * 4;
    st4(s_out + (bh * HD + i) * HD + j4, ld4(SS + i * HD + j4));
  }
}

template <int HD>
constexpr size_t smem_bytes() {
  return smem_floats<HD>() * sizeof(float);
}

// Lets the hd = HD kernel take its dynamic shared memory, and prefer the
// largest shared carve-out, on the current device.
template <int HD>
cudaError_t allow_smem() {
  cudaError_t e = cudaFuncSetAttribute(
      wkv_chunked_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<HD>()));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(wkv_chunked_kernel<HD>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  return e;
}

template <int HD>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* lw, const float* u, const float* s0,
                   float* y, float* s_out, int B, int S, int H,
                   cudaStream_t st) {
  const cudaError_t e = allow_smem<HD>();
  if (e != cudaSuccess) return e;
  const long long blocks = static_cast<long long>(B) * H;
  wkv_chunked_kernel<HD>
      <<<static_cast<unsigned>(blocks), THREADS, smem_bytes<HD>(), st>>>(
          r, k, v, lw, u, s0, y, s_out, S, H);
  return cudaGetLastError();
}

template <int HD>
cudaError_t shape_one(int* shape) {
  const void* kern = reinterpret_cast<const void*>(wkv_chunked_kernel<HD>);
  int blocks = 0;
  cudaFuncAttributes attr{};
  cudaError_t e = allow_smem<HD>();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kern, THREADS, smem_bytes<HD>());
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kern);
  shape[0] = THREADS;
  shape[1] = C;
  shape[2] = static_cast<int>(smem_bytes<HD>());
  shape[3] = blocks;
  shape[4] = attr.numRegs;
  shape[5] = static_cast<int>(attr.localSizeBytes);
  return e;
}

}  // namespace wkv_chunked

extern "C" {

const char* wkv_chunked_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the kernel on `stream`: B * H blocks. r, k, v, lw and y are
// (B, S, H, hd), u (H, hd), s0 (B, H, hd, hd) or null (zeros), s_out
// (B, H, hd, hd), all f32, contiguous, on the card and on 16 B. The caller
// guarantees B, H >= 1, S >= 0, hd 16 or 64 and B * H < 2^31. Returns 0
// when the launch was accepted, else the CUDA error.
int wkv_chunked_launch(const float* r, const float* k, const float* v,
                       const float* lw, const float* u, const float* s0,
                       float* y, float* s_out, int B, int S, int H, int hd,
                       void* stream) {
  using namespace wkv_chunked;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch<64>(r, k, v, lw, u, s0, y, s_out, B, S, H, st);
  if (hd == 16)
    return launch<16>(r, k, v, lw, u, s0, y, s_out, B, S, H, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch shape of the hd instantiation on the current device:
// shape[0..5] = threads a block, tokens a chunk, dynamic shared bytes a
// block, resident blocks an SM, registers a thread, local (spilled) bytes a
// thread. Returns 0, else the CUDA error.
int wkv_chunked_launch_shape(int hd, int* shape) {
  using namespace wkv_chunked;
  if (hd == 64) return static_cast<int>(shape_one<64>(shape));
  if (hd == 16) return static_cast<int>(shape_one<16>(shape));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
