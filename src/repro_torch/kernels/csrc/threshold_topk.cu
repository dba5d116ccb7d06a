// The two reductions of the sort-free threshold top-k, for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/threshold_topk.py:
//
//   count_above  (body _count_kernel): count[w] = #{ x in tiles[w] : x >= tau[w] }
//   global_max   (body _max_kernel):   max[w]   = max over tiles[w], NaN if any
//                                                 element is NaN (as jnp.max)
//
// The bisection that drives them (repro_torch.kernels.threshold_topk) calls
// count_above once per halving with tau on the device, so no launch waits on
// the host.
//
// Layout: tiles are [W, rows, 1024] f32, each worker's vector zero-padded to
// whole 8192-element tiles; one result per worker. Grid (blocks, W); each
// block walks its worker's elements with a grid-stride loop (float4 loads
// when the pointer is 16-byte aligned, else scalar), reduces in registers,
// then across the block (warp reductions, then one warp), and adds its
// partial to the worker's result with one atomic. The TPU kernel instead
// carried the sum across a sequential grid; here blocks run in any order.
//
// Both reductions are exact whatever that order: the count is an integer
// sum, and the maximum is taken over order-preserving integer keys of the
// floats (a NaN maps above +inf), so the result equals the plain version
// bit for bit (up to the sign of a zero maximum: +0 ranks above -0 here).
//
// What bounds it: device memory. One pass reads 4 bytes per element and
// does one compare; at the port's full width (4,464,640 padded elements,
// 17.9 MB) that is 5.3 us at 3.35 TB/s, about as long as a launch, so the
// bisection's 25 launches, not the passes, set the time of a selection.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Order-preserving key of a float: key(a) < key(b) iff a < b for numbers,
// -0 just below +0, every NaN above +inf. 0 is below every float's key.
__device__ __forceinline__ unsigned max_key(float f) {
  if (f != f) return 0xffffffffu;
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_to_float(unsigned k) {
  if (k == 0xffffffffu) return __int_as_float(0x7fc00000);
  if (k == 0u) return -INFINITY;  // no element (never for whole tiles)
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
}

// One block's share of worker w's n elements: count of x >= t.
__device__ __forceinline__ int count_share(const float* x, long long n,
                                           float t) {
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  int c = 0;
  if (aligned16(x)) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (long long i = start; i < n / 4; i += stride) {
      const float4 v = x4[i];
      c += (v.x >= t) + (v.y >= t) + (v.z >= t) + (v.w >= t);
    }
  } else {
    for (long long i = start; i < n; i += stride) c += x[i] >= t;
  }
  return c;
}

__device__ __forceinline__ unsigned max_share(const float* x, long long n) {
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  unsigned k = 0u;
  if (aligned16(x)) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (long long i = start; i < n / 4; i += stride) {
      const float4 v = x4[i];
      k = max(k, max(max(max_key(v.x), max_key(v.y)),
                     max(max_key(v.z), max_key(v.w))));
    }
  } else {
    for (long long i = start; i < n; i += stride) k = max(k, max_key(x[i]));
  }
  return k;
}

__global__ void __launch_bounds__(kThreads)
    count_above_kernel(const float* __restrict__ tiles, long long n,
                       const float* __restrict__ tau, int* __restrict__ count) {
  __shared__ int warp_c[kWarps];
  const int w = blockIdx.y;
  int c = count_share(tiles + (size_t)w * n, n, tau[w]);
  c = __reduce_add_sync(0xffffffffu, c);
  if ((threadIdx.x & 31) == 0) warp_c[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x < 32) {
    c = threadIdx.x < kWarps ? warp_c[threadIdx.x] : 0;
    c = __reduce_add_sync(0xffffffffu, c);
    if (threadIdx.x == 0 && c) atomicAdd(count + w, c);
  }
}

// scratch: [W] keys and [W] finished-block counters, zeroed before the
// launch. The last block of each worker to finish turns the key into out[w].
__global__ void __launch_bounds__(kThreads)
    global_max_kernel(const float* __restrict__ tiles, long long n,
                      unsigned* __restrict__ scratch, float* __restrict__ out) {
  __shared__ unsigned warp_k[kWarps];
  const int w = blockIdx.y;
  unsigned k = max_share(tiles + (size_t)w * n, n);
  k = __reduce_max_sync(0xffffffffu, k);
  if ((threadIdx.x & 31) == 0) warp_k[threadIdx.x >> 5] = k;
  __syncthreads();
  if (threadIdx.x < 32) {
    k = threadIdx.x < kWarps ? warp_k[threadIdx.x] : 0u;
    k = __reduce_max_sync(0xffffffffu, k);
    if (threadIdx.x == 0) {
      unsigned* done = scratch + gridDim.y;
      atomicMax(scratch + w, k);
      __threadfence();
      if (atomicAdd(done + w, 1u) == gridDim.x - 1) {
        out[w] = key_to_float(atomicMax(scratch + w, 0u));
      }
    }
  }
}

int blocks_for(long long n, int workers) {
  static int sms = 0;  // the card's SM count, read once
  if (sms == 0) {
    int device = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (sms <= 0) sms = 132;
  }
  // up to eight resident blocks per SM over all workers (a full SM of
  // threads); the grid-stride loop takes the rest
  const long long want = (n / 4 + kThreads - 1) / kThreads;
  long long cap = 8LL * sms / workers;
  if (cap < 1) cap = 1;
  return (int)(want < cap ? (want > 0 ? want : 1) : cap);
}

}  // namespace

// n: elements per worker (a multiple of 8192). tau: [workers] f32 on the
// card; count: [workers] int32. Returns cudaGetLastError() after the launch.
extern "C" int count_above_launch(const void* tiles, long long n, int workers,
                                  const void* tau, void* count, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e = cudaMemsetAsync(count, 0, sizeof(int) * workers, s);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(blocks_for(n, workers), workers);
  count_above_kernel<<<grid, kThreads, 0, s>>>(
      (const float*)tiles, n, (const float*)tau, (int*)count);
  return (int)cudaGetLastError();
}

// scratch: 2 * workers uint32 on the card; out: [workers] f32.
extern "C" int global_max_launch(const void* tiles, long long n, int workers,
                                 void* scratch, void* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e =
      cudaMemsetAsync(scratch, 0, 2 * sizeof(unsigned) * workers, s);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(blocks_for(n, workers), workers);
  global_max_kernel<<<grid, kThreads, 0, s>>>(
      (const float*)tiles, n, (unsigned*)scratch, (float*)out);
  return (int)cudaGetLastError();
}
