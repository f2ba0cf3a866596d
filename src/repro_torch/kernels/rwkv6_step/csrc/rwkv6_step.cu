// rwkv6_step for Hopper (sm_90a): one RWKV6 decode token per (batch, head),
//   y[j]    = sum_i r[i] (S[i,j] + u[i] k[i] v[j])
//   S'[i,j] = w[i] S[i,j] + k[i] v[j]
// with r, k, v, w (B, H, hd), u (H, hd), the state S (B, H, hd, hd) f32, y
// in r's dtype and S' written to a new tensor.
//
// Replaces the Pallas TPU kernel rwkv6_step_pallas (_rwkv6_step_kernel) of
// src/repro/kernels/rwkv6_step/kernel.py. That kernel holds a whole
// (hd, hd) state tile in VMEM per (b, h) grid step and computes the
// readout as a (1, hd) x (hd, hd) matrix product. Here a block owns one
// (b, h) and streams its state through registers once.
//
// Bound on this card: bytes. The state is read once and written once (8 *
// hd^2 bytes a head) against about 6 hd^2 f32 operations, under one
// operation a byte.
//
// Design (simple and right first):
//   - one block per (b, h), one thread per value column j (hd threads,
//     hd <= 256);
//   - r, k, w and u of the head are staged in shared memory as f32; each
//     thread keeps v[j] and loops over the key index i, so the reads of
//     state row i and the writes of S' row i are coalesced across j; the
//     loop is unrolled so several rows' loads are in flight;
//   - S' rounds as the plain version does (two f32 products and an add,
//     never fused), so the new state agrees with it bit for bit; y sums over
//     i in order in f32 (fused multiply-adds), which the plain version's
//     batched product does in another order: y agrees to f32 rounding.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rwkv6_step {

constexpr int MAX_HD = 256;

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

template <typename T>
__global__ void __launch_bounds__(MAX_HD)
    rwkv6_step_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ w,
                      const T* __restrict__ u,
                      const float* __restrict__ state, T* __restrict__ y,
                      float* __restrict__ state_out, int H, int hd) {
  __shared__ float sr[MAX_HD], sk[MAX_HD], sw[MAX_HD], su[MAX_HD];
  const long long bh = blockIdx.x;           // b * H + h
  const int h = static_cast<int>(bh % H);
  const int j = threadIdx.x;
  const long long vec = bh * hd;
  sr[j] = to_f32(r[vec + j]);
  sk[j] = to_f32(k[vec + j]);
  sw[j] = to_f32(w[vec + j]);
  su[j] = to_f32(u[static_cast<long long>(h) * hd + j]);
  const float vj = to_f32(v[vec + j]);
  __syncthreads();
  const long long tile = bh * hd * hd + j;
  const float* s = state + tile;
  float* so = state_out + tile;
  float acc = 0.0f;
#pragma unroll 8
  for (int i = 0; i < hd; ++i) {
    const float sij = s[static_cast<long long>(i) * hd];
    const float kv = __fmul_rn(sk[i], vj);
    acc = fmaf(sr[i], __fadd_rn(sij, __fmul_rn(su[i], kv)), acc);
    so[static_cast<long long>(i) * hd] = __fadd_rn(__fmul_rn(sw[i], sij),
                                                   kv);
  }
  y[vec + j] = from_f32<T>(acc);
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const float* state, void* y,
                   float* state_out, int B, int H, int hd,
                   cudaStream_t stream) {
  const long long blocks = static_cast<long long>(B) * H;
  rwkv6_step_kernel<T><<<static_cast<unsigned>(blocks), hd, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(u), state, static_cast<T*>(y), state_out, H, hd);
  return cudaGetLastError();
}

}  // namespace rwkv6_step

extern "C" {

const char* rwkv6_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the kernel on `stream`. dtype 0: f32, 1: bf16 (r, k, v, w, u and
// y share it); state and state_out are f32. r, k, v, w and y are
// (B, H, hd), u (H, hd), the states (B, H, hd, hd), all contiguous on the
// card. The caller guarantees B, H >= 1, B * H < 2^31 and 1 <= hd <= 256.
// Returns 0 when the launch was accepted, else the CUDA error.
int rwkv6_step_launch(const void* r, const void* k, const void* v,
                      const void* w, const void* u, const float* state,
                      void* y, float* state_out, int dtype, int B, int H,
                      int hd, void* stream) {
  using namespace rwkv6_step;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(r, k, v, w, u, state, y, state_out, B, H, hd, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, w, u, state, y, state_out, B, H,
                                 hd, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
