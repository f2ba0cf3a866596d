// The first rglru_scan design (src/repro_torch/kernels/rglru_scan/csrc/
// rglru_scan.cu before the ring kernels), kept so that
// tools/rglru_variants.py and chip_smoke.py can time it in turns with the
// shipped one. It is never built into the package. Below this note the
// file is that source unchanged: one thread per (batch, channel), 128
// threads a block, each thread's loads issued a chunk of UNROLL
// (BWD_UNROLL) time steps at a time; the same C interface, without
// rglru_scan_prepare and the ring's queries.
//
// rglru_scan for Hopper (sm_90a): the RG-LRU diagonal linear recurrence
// h_t = exp(log_a_t) * h_{t-1} + b_t over (B, S, R) f32, from h0 (B, R),
// and its gradient (rglru_scan_bwd_kernel, below the forward).
//
// Replaces the Pallas TPU kernel rglru_pallas (_rglru_kernel) of
// src/repro/kernels/rglru_scan/kernel.py. That kernel walks a sequential
// (B, R / r_tile, S / block_s) grid and carries h from one time block to the
// next in a VMEM scratch row; its shapes must divide the tiles. Hopper
// blocks run in parallel and in no order, so here the time axis is a loop
// inside one thread and the carry is a register.
//
// Bound on this card: bytes. Every log_a and b value is read once and every
// h written once (12 bytes a (b, t, r) element) against three operations,
// far under the card's balance.
//
// Design (simple and right first):
//   - one thread per (b, channel r), walking t in order with h in a
//     register; a warp's 32 threads hold 32 neighbouring channels, so every
//     load and store of a time step is coalesced;
//   - the t loop runs in chunks of UNROLL steps: the chunk's log_a and b
//     are loaded first (no load depends on h), so 2 * UNROLL loads are in
//     flight a thread; the ragged last chunk is masked;
//   - each step rounds exactly as the plain version does, as three f32
//     operations (expf, a multiply, an add, never fused into an FMA), so
//     kernel and plain version agree bit for bit;
//   - any B, S >= 0 and R, nothing padded; h0 may be null (zeros).
#include <cuda_runtime.h>

namespace rglru_scan {

constexpr int THREADS = 128;
constexpr int UNROLL = 8;
constexpr int BWD_UNROLL = 16;

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

// The gradient: rglru_scan_bwd_kernel.
//
// Not a TPU kernel's port: the reference differentiates its own sequence
// recurrence (jax.lax.associative_scan in src/repro/models/components.py)
// through XLA's autodiff. The port's forward is the kernel above, so its
// gradient is a kernel too. Given gh = dL/dh (B, S, R) f32, with
// a_t = exp(log_a_t), walking t from S-1 down to 0:
//   g_t      = gh_t + c,         c the carry a_{t+1} g_{t+1} (0 at S-1)
//   db_t     = g_t
//   c        = g_t * a_t
//   dlog_a_t = c * h_{t-1}       (h_{-1} = h0, or 0 without h0)
// and dh0 = c after t = 0 (a_0 g_0).
//
// Bound on this card: bytes. log_a, the forward's h and gh are read once,
// dlog_a and db written once (20 bytes a (b, t, r) element), h0 read and
// dh0 written once, against four operations an element.
//
// Design: the forward's, walked backwards. One thread per (b, channel r)
// with the carry in a register; a warp's 32 threads hold 32 neighbouring
// channels, so every load and store of a step is coalesced; time runs
// down in chunks of BWD_UNROLL steps whose log_a, gh and h_{t-1} loads are
// issued before the chunk's sequential work (no load depends on the
// carry). 16 steps, not the forward's 8: on an H100 the gradient took
// 0.563 ms at (2, 2560, 4096) with 16, 1.691 with 8 and 1.252 with 32
// (tools/rglru_bwd_variants.py). Each step rounds as the plain version does (expf, then separate
// __fadd_rn / __fmul_rn in a fixed order, never fused), so the kernel and
// ref.rglru_bwd_ref agree bit for bit.
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

}  // namespace rglru_scan

extern "C" {

const char* rglru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the kernel on `stream`. log_a, b and h are (B, S, R) f32, h0 is
// (B, R) f32 or null (zeros), all contiguous on the card. The caller
// guarantees B, S, R >= 1 and B < 65536. Returns 0 when the launch was
// accepted, else the CUDA error.
int rglru_scan_launch(const float* log_a, const float* b, const float* h0,
                      float* h, int B, int S, int R, void* stream) {
  using namespace rglru_scan;
  const dim3 grid((R + THREADS - 1) / THREADS, B);
  rglru_scan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      log_a, b, h0, h, S, R);
  return static_cast<int>(cudaGetLastError());
}

// Launches the gradient on `stream`. log_a, h (the forward's output), gh,
// dlog_a and db are (B, S, R) f32; h0 and dh0 are (B, R) f32 or null
// (h0 null: zeros; dh0 null: not written), all contiguous on the card.
// The caller guarantees B, S, R >= 1 and B < 65536. Returns 0 when the
// launch was accepted, else the CUDA error.
int rglru_scan_bwd_launch(const float* log_a, const float* h, const float* gh,
                          const float* h0, float* dlog_a, float* db,
                          float* dh0, int B, int S, int R, void* stream) {
  using namespace rglru_scan;
  const dim3 grid((R + THREADS - 1) / THREADS, B);
  rglru_scan_bwd_kernel<<<grid, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      log_a, h, gh, h0, dlog_a, db, dh0, S, R);
  return static_cast<int>(cudaGetLastError());
}

// The kernels' launch shape: threads a block.
int rglru_scan_threads() { return rglru_scan::THREADS; }

}  // extern "C"
