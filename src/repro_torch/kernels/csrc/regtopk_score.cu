// RegTop-k score, one elementwise pass, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro.kernels.regtopk_score.regtopk_score
// (src/repro/kernels/regtopk_score.py, body _score_kernel): for every element
// of the [W, rows, 1024] f32 tiles, score = score_chain(a, a_prev, s_prev,
// g_prev), the Alg. 2 metric |a|^y * tanh(|1 + Delta| / mu) of the shared
// header, so the score equals the plain PyTorch chain bit for bit.
//
// What bounds it: device memory. Each element reads four floats and writes
// one (20 bytes) and does about a dozen floating-point operations, far below
// the card's ratio of operations to bytes. The design streams: a grid-stride
// loop over float4 groups (16-byte loads and stores, neighbouring threads on
// neighbouring addresses), with a scalar loop for the case that a pointer is
// not 16-byte aligned. The Pallas kernel's (8, 1024) blocks and sequential
// grid carry nothing from one block to the next, so nothing is lost by
// treating the tiles as one flat array.

#include <cuda_runtime.h>

#include <cstdint>

#include "score_chain.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    regtopk_score_vec4(const float4* __restrict__ a,
                       const float4* __restrict__ a_prev,
                       const float4* __restrict__ s_prev,
                       const float4* __restrict__ g_prev,
                       float4* __restrict__ out, long long n4, float omega,
                       float mu, float q, float y) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const float4 va = a[i], vp = a_prev[i], vs = s_prev[i], vg = g_prev[i];
    float4 r;
    r.x = score_chain(va.x, vp.x, vs.x, vg.x, omega, mu, q, y);
    r.y = score_chain(va.y, vp.y, vs.y, vg.y, omega, mu, q, y);
    r.z = score_chain(va.z, vp.z, vs.z, vg.z, omega, mu, q, y);
    r.w = score_chain(va.w, vp.w, vs.w, vg.w, omega, mu, q, y);
    out[i] = r;
  }
}

__global__ void __launch_bounds__(kThreads)
    regtopk_score_scalar(const float* __restrict__ a,
                         const float* __restrict__ a_prev,
                         const float* __restrict__ s_prev,
                         const float* __restrict__ g_prev,
                         float* __restrict__ out, long long n, float omega,
                         float mu, float q, float y) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = score_chain(a[i], a_prev[i], s_prev[i], g_prev[i], omega, mu, q,
                         y);
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

// Score n elements (n is a multiple of 8192, the tile) on `stream` (a
// cudaStream_t); returns cudaGetLastError() after the launch, so a refused
// launch is reported to the caller.
extern "C" int regtopk_score_launch(const void* a, const void* a_prev,
                                    const void* s_prev, const void* g_prev,
                                    void* out, long long n, float omega,
                                    float mu, float q, float y, void* stream) {
  if (n <= 0) return 0;
  static int sms = 0;  // the card's SM count, read once
  if (sms == 0) {
    int device = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  // enough resident blocks to cover the card several times over; the
  // grid-stride loop takes the rest
  const long long cap = (long long)(sms > 0 ? sms : 132) * 16;
  const cudaStream_t s = (cudaStream_t)stream;
  if (n % 4 == 0 && aligned16(a) && aligned16(a_prev) && aligned16(s_prev) &&
      aligned16(g_prev) && aligned16(out)) {
    const long long n4 = n / 4;
    const long long want = (n4 + kThreads - 1) / kThreads;
    const int blocks = (int)(want < cap ? want : cap);
    regtopk_score_vec4<<<blocks, kThreads, 0, s>>>(
        (const float4*)a, (const float4*)a_prev, (const float4*)s_prev,
        (const float4*)g_prev, (float4*)out, n4, omega, mu, q, y);
  } else {
    const long long want = (n + kThreads - 1) / kThreads;
    const int blocks = (int)(want < cap ? want : cap);
    regtopk_score_scalar<<<blocks, kThreads, 0, s>>>(
        (const float*)a, (const float*)a_prev, (const float*)s_prev,
        (const float*)g_prev, (float*)out, n, omega, mu, q, y);
  }
  return (int)cudaGetLastError();
}
