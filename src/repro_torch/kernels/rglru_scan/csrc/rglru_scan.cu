// rglru_scan for Hopper (sm_90a): the RG-LRU diagonal linear recurrence
// h_t = exp(log_a_t) * h_{t-1} + b_t over (B, S, R) f32, from h0 (B, R).
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

// The kernel's launch shape: threads a block.
int rglru_scan_threads() { return rglru_scan::THREADS; }

}  // extern "C"
