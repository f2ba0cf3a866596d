// The rglru_scan ring kernels with a bulk-copy producer, kept so that
// tools/rglru_variants.py can time it (design "bulk") in turns with the
// shipped csrc/rglru_scan.cu. It is never built into the package.
//
// The ring design of src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu
// (see its header) with one change: the producer warp fills a stage with
// one 1-D bulk copy (cp.async.bulk, the producer of kernels/policy_scan)
// a row of GROUP channels and input, its lanes taking a row each, lane 0
// first arming the stage's full mbarrier with the copies' bytes; the
// helper warps fence the async proxy after taking expf in place, before
// the stage is refilled. Every other line is the shipped design's: the
// direct kernels for S < STEPS, a width R that is not a multiple of 4 and
// tensors that do not start on a 16 B boundary, the walkers, the helpers,
// the same C interface. On an H100 it ran 1.7x slower than the 16 B
// cp.async producer at the training path's shapes: a block then completed
// about one 128 B copy every 33 ns, whatever the stages or the row width.
#include <cuda_runtime.h>

#include <cstdint>

namespace rglru_scan {

// the direct kernels: one thread per (b, channel), THREADS a block
constexpr int THREADS = 128;
constexpr int UNROLL = 8;
constexpr int BWD_UNROLL = 16;

// the ring kernels
constexpr int GROUP = 32;        // channels a block, one walker warp a 32
constexpr int STEPS = 32;        // time steps a tile
constexpr int FWD_STAGES = 6;    // tiles in the forward's ring
constexpr int BWD_STAGES = 4;    // tiles in the gradient's ring
constexpr int EXP_WARPS = 4;     // warps that take expf of a landed tile
constexpr int WALK = 16;         // steps a walker loads before walking them
constexpr int WALKERS = GROUP / 32;
constexpr int RING_THREADS = 32 * (1 + WALKERS + EXP_WARPS);
constexpr int TILE = STEPS * GROUP;    // floats of one input's tile
static_assert(GROUP % 32 == 0 && STEPS % WALK == 0 &&
                  TILE % (EXP_WARPS * 32) == 0,
              "the ring's shape");

// ---------------------------------------------------------------------------
// The direct kernels.
//
// One thread per (b, channel r), walking t in order with h in a register; a
// warp's 32 threads hold 32 neighbouring channels, so every load and store
// of a time step is coalesced. The t loop runs in chunks of UNROLL steps
// whose log_a and b are loaded first (no load depends on h); the ragged
// last chunk is masked.
__global__ void __launch_bounds__(THREADS)
    rglru_scan_kernel(const float* __restrict__ log_a,
                      const float* __restrict__ b,
                      const float* __restrict__ h0, float* __restrict__ h_out,
                      int S, int R) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= R) return;
  const long long batch = blockIdx.y;
  float h = h0 == nullptr ? 0.0f : h0[batch * R + r];
  const long long base = batch * static_cast<long long>(S) * R + r;
  const float* la = log_a + base;
  const float* bb = b + base;
  float* out = h_out + base;
  int t = 0;
  for (; t + UNROLL <= S; t += UNROLL) {
    float a[UNROLL], x[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long off = static_cast<long long>(t + u) * R;
      a[u] = la[off];
      x[u] = bb[off];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      h = __fadd_rn(__fmul_rn(expf(a[u]), h), x[u]);
      out[static_cast<long long>(t + u) * R] = h;
    }
  }
  for (; t < S; ++t) {
    const long long off = static_cast<long long>(t) * R;
    h = __fadd_rn(__fmul_rn(expf(la[off]), h), bb[off]);
    out[off] = h;
  }
}

// The gradient. Not a TPU kernel's port: the reference differentiates its
// own sequence recurrence (jax.lax.associative_scan in
// src/repro/models/components.py) through XLA's autodiff. Given gh = dL/dh
// (B, S, R) f32, with a_t = exp(log_a_t), walking t from S-1 down to 0:
//   g_t      = gh_t + c,         c the carry a_{t+1} g_{t+1} (0 at S-1)
//   db_t     = g_t
//   c        = g_t * a_t
//   dlog_a_t = c * h_{t-1}       (h_{-1} = h0, or 0 without h0)
// and dh0 = c after t = 0 (a_0 g_0). The direct form: the forward's thread
// layout walked backwards, its loads issued BWD_UNROLL steps at a time.
__global__ void __launch_bounds__(THREADS)
    rglru_scan_bwd_kernel(const float* __restrict__ log_a,
                          const float* __restrict__ h,
                          const float* __restrict__ gh,
                          const float* __restrict__ h0,
                          float* __restrict__ dlog_a, float* __restrict__ db,
                          float* __restrict__ dh0, int S, int R) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= R) return;
  const long long batch = blockIdx.y;
  const long long base = batch * static_cast<long long>(S) * R + r;
  const float* la = log_a + base;
  const float* hh = h + base;
  const float* gg = gh + base;
  float* dla = dlog_a + base;
  float* dbb = db + base;
  const float first = h0 == nullptr ? 0.0f : h0[batch * R + r];
  float c = 0.0f;
  int t = S - 1;
  for (; t - BWD_UNROLL + 1 >= 1; t -= BWD_UNROLL) {
    // steps t, t-1, ..., t-BWD_UNROLL+1, all with t-u >= 1: h_{t-u-1} in h
    float a[BWD_UNROLL], x[BWD_UNROLL], hp[BWD_UNROLL];
#pragma unroll
    for (int u = 0; u < BWD_UNROLL; ++u) {
      const long long off = static_cast<long long>(t - u) * R;
      a[u] = la[off];
      x[u] = gg[off];
      hp[u] = hh[off - R];
    }
#pragma unroll
    for (int u = 0; u < BWD_UNROLL; ++u) {
      const long long off = static_cast<long long>(t - u) * R;
      const float g = __fadd_rn(x[u], c);
      dbb[off] = g;
      c = __fmul_rn(g, expf(a[u]));
      dla[off] = __fmul_rn(c, hp[u]);
    }
  }
  for (; t >= 0; --t) {
    const long long off = static_cast<long long>(t) * R;
    const float g = __fadd_rn(gg[off], c);
    dbb[off] = g;
    c = __fmul_rn(g, expf(la[off]));
    dla[off] = __fmul_rn(c, t > 0 ? hh[off - R] : first);
  }
  if (dh0 != nullptr) dh0[batch * R + r] = c;
}

// ---------------------------------------------------------------------------
// The ring kernels. The mbarrier and bulk-copy helpers are those of
// kernels/policy_scan/csrc/policy_scan.cu.

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

// Dynamic shared memory of a ring of `stages` stages of `inputs` tiles:
// the tiles, then a full, a ready and an empty mbarrier a stage.
__host__ __device__ constexpr size_t ring_bytes(int stages, int inputs) {
  return sizeof(float) * static_cast<size_t>(stages) * inputs * TILE +
         3 * sizeof(uint64_t) * static_cast<size_t>(stages);
}

// A block's ring: stage s holds INPUTS tiles of TILE floats, row u of a
// tile the GROUP channels of one time step. Tile 0 is log_a, expf'd in
// place by the helper warps before the walker reads it. full[s]: the
// stage's copies landed (one arrival and the copies' bytes); ready[s]: its
// log_a tile is exp(log_a) (every helper thread); empty[s]: the walkers
// are done with it (every walker thread).
template <int STAGES, int INPUTS>
struct Ring {
  float* tiles;
  uint64_t* full;
  uint64_t* ready;
  uint64_t* empty;

  __device__ explicit Ring(float* smem)
      : tiles(smem),
        full(reinterpret_cast<uint64_t*>(smem + STAGES * INPUTS * TILE)),
        ready(full + STAGES),
        empty(full + 2 * STAGES) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&ready[s], EXP_WARPS * 32);
        mbar_init(&empty[s], WALKERS * 32);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    __syncthreads();
  }

  __device__ float* tile(int s, int input) const {
    return tiles + (s * INPUTS + input) * TILE;
  }

  // The producer warp's part for stage s: rows [0, steps) of each input's
  // tile, row u from src[i] + u * R, width channels of them, but no row 0
  // of the last input when skip0: one bulk copy a row and input, spread
  // over the lanes, the bytes expected first.
  __device__ __forceinline__ void fill(int s, const float* const* src,
                                       bool skip0, int steps, int width,
                                       int R) const {
    const int lane = threadIdx.x % 32;
    const uint32_t row_bytes = static_cast<uint32_t>(width) * 4u;
    if (lane == 0)
      mbar_expect_tx(&full[s], static_cast<uint32_t>(
                                   INPUTS * steps - (skip0 ? 1 : 0)) *
                                   row_bytes);
    __syncwarp();
    for (int u = lane; u < steps; u += 32)
#pragma unroll
      for (int i = 0; i < INPUTS; ++i)
        if (u > 0 || !skip0 || i < INPUTS - 1)
          bulk_load(tile(s, i) + u * GROUP,
                    src[i] + static_cast<long long>(u) * R, row_bytes,
                    &full[s]);
  }
};

// The helper warps' part: for each of the block's n_tiles tiles in ring
// order, log_a -> exp(log_a) in place once the stage has landed, over the
// whole tile (a ragged tile's rows past S and a short group's channels
// past R hold values no walker stores), then the ready arrival after the
// proxy fence that orders these writes before the stage's next bulk copy.
template <int STAGES, int INPUTS>
__device__ __forceinline__ void exp_tiles(const Ring<STAGES, INPUTS>& ring,
                                          int n_tiles) {
  const int tid = threadIdx.x - 32 * (1 + WALKERS);
  for (int k = 0; k < n_tiles; ++k) {
    const int s = k % STAGES;
    mbar_wait(&ring.full[s], (k / STAGES) & 1u);
    float* la = ring.tile(s, 0);
#pragma unroll
    for (int i = 0; i < TILE / (EXP_WARPS * 32); ++i) {
      const int at = tid + i * EXP_WARPS * 32;
      la[at] = expf(la[at]);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_arrive(&ring.ready[s]);
  }
}

// The forward. Grid (ceil(R / GROUP), B), RING_THREADS threads: warp 0
// the producer, warps 1..WALKERS the walkers, then the helpers. Needs
// S >= 1, R % 4 == 0 and 16 B-aligned log_a and b.
template <int STAGES>
__global__ void __launch_bounds__(RING_THREADS)
    rglru_ring_kernel(const float* __restrict__ log_a,
                      const float* __restrict__ b,
                      const float* __restrict__ h0, float* __restrict__ h_out,
                      int S, int R) {
  extern __shared__ __align__(128) float smem[];
  const Ring<STAGES, 2> ring(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = blockIdx.x * GROUP;
  const int width = min(GROUP, R - c0);
  const long long batch = blockIdx.y;
  const long long base = batch * static_cast<long long>(S) * R + c0;
  const int n_tiles = (S + STEPS - 1) / STEPS;

  if (warp == 0) {                                   // the producer
    for (int k = 0; k < n_tiles; ++k) {
      const int s = k % STAGES;
      if (k >= STAGES) mbar_wait(&ring.empty[s], ((k / STAGES) & 1u) ^ 1u);
      const int t0 = k * STEPS;
      const long long at = base + static_cast<long long>(t0) * R;
      const float* src[2] = {log_a + at, b + at};
      ring.fill(s, src, false, min(STEPS, S - t0), width, R);
    }
  } else if (warp <= WALKERS) {                      // a walker
    const int col = (warp - 1) * 32 + lane;
    const bool live = col < width;
    float h = (h0 != nullptr && live) ? h0[batch * R + c0 + col] : 0.0f;
    float* out = h_out + base + col;
    for (int k = 0; k < n_tiles; ++k) {
      const int s = k % STAGES;
      const uint32_t parity = (k / STAGES) & 1u;
      mbar_wait(&ring.full[s], parity);
      mbar_wait(&ring.ready[s], parity);
      const float* ea = ring.tile(s, 0) + col;
      const float* xb = ring.tile(s, 1) + col;
      const int t0 = k * STEPS;
      const int steps = min(STEPS, S - t0);
      float* o = out + static_cast<long long>(t0) * R;
      if (steps == STEPS) {
#pragma unroll
        for (int w = 0; w < STEPS; w += WALK) {
          float a[WALK], x[WALK];
#pragma unroll
          for (int u = 0; u < WALK; ++u) {
            a[u] = ea[(w + u) * GROUP];
            x[u] = xb[(w + u) * GROUP];
          }
#pragma unroll
          for (int u = 0; u < WALK; ++u) {
            h = __fadd_rn(__fmul_rn(a[u], h), x[u]);
            if (live) o[static_cast<long long>(w + u) * R] = h;
          }
        }
      } else {
        for (int u = 0; u < steps; ++u) {
          h = __fadd_rn(__fmul_rn(ea[u * GROUP], h), xb[u * GROUP]);
          if (live) o[static_cast<long long>(u) * R] = h;
        }
      }
      mbar_arrive(&ring.empty[s]);
    }
  } else {                                           // the helpers
    exp_tiles(ring, n_tiles);
  }
}

// The gradient, the same machine walked from the last tile down. Its ring
// holds log_a, gh and h one row lower: row u of tile 2 is h_{t0+u-1}, so
// h_{t-1} sits beside step t (the first tile's row 0 is never copied: the
// walker takes h0 there). Needs S >= 1, R % 4 == 0 and 16 B-aligned
// log_a, h and gh.
template <int STAGES>
__global__ void __launch_bounds__(RING_THREADS)
    rglru_ring_bwd_kernel(const float* __restrict__ log_a,
                          const float* __restrict__ h,
                          const float* __restrict__ gh,
                          const float* __restrict__ h0,
                          float* __restrict__ dlog_a, float* __restrict__ db,
                          float* __restrict__ dh0, int S, int R) {
  extern __shared__ __align__(128) float smem[];
  const Ring<STAGES, 3> ring(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = blockIdx.x * GROUP;
  const int width = min(GROUP, R - c0);
  const long long batch = blockIdx.y;
  const long long base = batch * static_cast<long long>(S) * R + c0;
  const int n_tiles = (S + STEPS - 1) / STEPS;

  if (warp == 0) {                                   // the producer
    for (int k = 0; k < n_tiles; ++k) {
      const int s = k % STAGES;
      if (k >= STAGES) mbar_wait(&ring.empty[s], ((k / STAGES) & 1u) ^ 1u);
      const int t0 = (n_tiles - 1 - k) * STEPS;
      const long long at = base + static_cast<long long>(t0) * R;
      const float* src[3] = {log_a + at, gh + at, h + at - R};
      ring.fill(s, src, t0 == 0, min(STEPS, S - t0), width, R);
    }
  } else if (warp <= WALKERS) {                      // a walker
    const int col = (warp - 1) * 32 + lane;
    const bool live = col < width;
    const float first =
        (h0 != nullptr && live) ? h0[batch * R + c0 + col] : 0.0f;
    float* dla = dlog_a + base + col;
    float* dbb = db + base + col;
    float c = 0.0f;
    for (int k = 0; k < n_tiles; ++k) {
      const int s = k % STAGES;
      const uint32_t parity = (k / STAGES) & 1u;
      mbar_wait(&ring.full[s], parity);
      mbar_wait(&ring.ready[s], parity);
      const float* ea = ring.tile(s, 0) + col;
      const float* xg = ring.tile(s, 1) + col;
      const float* hp = ring.tile(s, 2) + col;
      const int t0 = (n_tiles - 1 - k) * STEPS;
      const int steps = min(STEPS, S - t0);
      const long long at = static_cast<long long>(t0) * R;
      if (steps == STEPS && t0 > 0) {
#pragma unroll
        for (int w = STEPS - WALK; w >= 0; w -= WALK) {
          float a[WALK], x[WALK], p[WALK];
#pragma unroll
          for (int u = 0; u < WALK; ++u) {
            a[u] = ea[(w + u) * GROUP];
            x[u] = xg[(w + u) * GROUP];
            p[u] = hp[(w + u) * GROUP];
          }
#pragma unroll
          for (int u = WALK - 1; u >= 0; --u) {
            const long long off = at + static_cast<long long>(w + u) * R;
            const float g = __fadd_rn(x[u], c);
            if (live) dbb[off] = g;
            c = __fmul_rn(g, a[u]);
            if (live) dla[off] = __fmul_rn(c, p[u]);
          }
        }
      } else {
        for (int u = steps - 1; u >= 0; --u) {
          const long long off = at + static_cast<long long>(u) * R;
          const float g = __fadd_rn(xg[u * GROUP], c);
          if (live) dbb[off] = g;
          c = __fmul_rn(g, ea[u * GROUP]);
          if (live)
            dla[off] = __fmul_rn(c, t0 + u > 0 ? hp[u * GROUP] : first);
        }
      }
      mbar_arrive(&ring.empty[s]);
    }
    if (dh0 != nullptr && live) dh0[batch * R + c0 + col] = c;
  } else {                                           // the helpers
    exp_tiles(ring, n_tiles);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Whether a call of this S and R takes the ring kernels (given 16 B-aligned
// tensors).
bool ring_shape_ok(int S, int R) { return S >= STEPS && R % 4 == 0; }

constexpr size_t FWD_SMEM = ring_bytes(FWD_STAGES, 2);
constexpr size_t BWD_SMEM = ring_bytes(BWD_STAGES, 3);

}  // namespace rglru_scan

extern "C" {

const char* rglru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Lets the ring kernels take their dynamic shared memory on the current
// device. Called once a device, before the first launch there and outside
// any graph capture. Returns 0, else the CUDA error.
int rglru_scan_prepare() {
  using namespace rglru_scan;
  cudaError_t e = cudaFuncSetAttribute(
      rglru_ring_kernel<FWD_STAGES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(FWD_SMEM));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(rglru_ring_bwd_kernel<BWD_STAGES>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(BWD_SMEM));
  return static_cast<int>(e);
}

// Launches the forward on `stream`: the ring kernel when S >= STEPS,
// R % 4 == 0 and log_a and b start on 16 B boundaries, else the direct
// kernel. log_a, b and h are (B, S, R) f32, h0 is (B, R) f32 or null
// (zeros), all contiguous on the card. The caller guarantees B, S, R >= 1
// and B < 65536, and has called rglru_scan_prepare on this device.
// Returns 0 when the launch was accepted, else the CUDA error.
int rglru_scan_launch(const float* log_a, const float* b, const float* h0,
                      float* h, int B, int S, int R, void* stream) {
  using namespace rglru_scan;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ring_shape_ok(S, R) && aligned16(log_a) && aligned16(b)) {
    const dim3 grid((R + GROUP - 1) / GROUP, B);
    rglru_ring_kernel<FWD_STAGES><<<grid, RING_THREADS, FWD_SMEM, st>>>(
        log_a, b, h0, h, S, R);
  } else {
    const dim3 grid((R + THREADS - 1) / THREADS, B);
    rglru_scan_kernel<<<grid, THREADS, 0, st>>>(log_a, b, h0, h, S, R);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches the gradient on `stream`: the ring kernel when S >= STEPS,
// R % 4 == 0 and log_a, h and gh start on 16 B boundaries, else the
// direct kernel. log_a, h (the forward's output), gh, dlog_a and db are
// (B, S, R) f32; h0 and dh0 are (B, R) f32 or null (h0 null: zeros; dh0
// null: not written), all contiguous on the card. The caller guarantees
// B, S, R >= 1 and B < 65536, and has called rglru_scan_prepare on this
// device. Returns 0 when the launch was accepted, else the CUDA error.
int rglru_scan_bwd_launch(const float* log_a, const float* h, const float* gh,
                          const float* h0, float* dlog_a, float* db,
                          float* dh0, int B, int S, int R, void* stream) {
  using namespace rglru_scan;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ring_shape_ok(S, R) && aligned16(log_a) && aligned16(h) &&
      aligned16(gh)) {
    const dim3 grid((R + GROUP - 1) / GROUP, B);
    rglru_ring_bwd_kernel<BWD_STAGES><<<grid, RING_THREADS, BWD_SMEM, st>>>(
        log_a, h, gh, h0, dlog_a, db, dh0, S, R);
  } else {
    const dim3 grid((R + THREADS - 1) / THREADS, B);
    rglru_scan_bwd_kernel<<<grid, THREADS, 0, st>>>(log_a, h, gh, h0, dlog_a,
                                                    db, dh0, S, R);
  }
  return static_cast<int>(cudaGetLastError());
}

// Whether a call of this S and R with 16 B-aligned tensors takes the ring
// kernels (1) or the direct ones (0).
int rglru_scan_uses_ring(int S, int R) {
  return rglru_scan::ring_shape_ok(S, R) ? 1 : 0;
}

// The ring kernel's launch shape, forward (backward == 0) or gradient:
// shape[0..7] = threads a block, channels a block, time steps a tile,
// stages, dynamic shared bytes a block, resident blocks an SM on the
// current device (after rglru_scan_prepare there), registers a thread and
// local (spilled) bytes a thread. Returns 0, else the CUDA error.
int rglru_scan_ring_shape(int backward, int* shape) {
  using namespace rglru_scan;
  const void* k = backward ? reinterpret_cast<const void*>(
                                 rglru_ring_bwd_kernel<BWD_STAGES>)
                           : reinterpret_cast<const void*>(
                                 rglru_ring_kernel<FWD_STAGES>);
  const size_t smem = backward ? BWD_SMEM : FWD_SMEM;
  int blocks = 0;
  cudaFuncAttributes attr{};
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, k, RING_THREADS, smem);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, k);
  shape[0] = RING_THREADS;
  shape[1] = GROUP;
  shape[2] = STEPS;
  shape[3] = backward ? BWD_STAGES : FWD_STAGES;
  shape[4] = static_cast<int>(smem);
  shape[5] = blocks;
  shape[6] = attr.numRegs;
  shape[7] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(e);
}

}  // extern "C"
