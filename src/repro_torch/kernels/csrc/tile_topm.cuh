// Per-tile top-m selection by m rounds of a block-wide arg-max, shared by
// fused_encode.cu (kernel 1, on the Alg. 2 score) and block_topk.cu (on a
// given score).
//
// One CTA of kThreads threads owns one 8192-element tile whose scores sit in
// shared memory; thread t owns the elements t, t + 256, ..., t + 31 * 256.
// Order: score descending, flat index ascending, as the TPU kernels' masked
// max with its lowest-index tie break. A round reduces the 256 per-thread
// arg-maxima (warp shuffles, then one warp over the 8 warp winners), emits
// the winner, and only the winner's owner masks it to -inf and rescans its
// 32 elements. Callers leave NaN scores out: a NaN tile takes an early exit.

#pragma once

#include <cuda_runtime.h>

#include <climits>

namespace tile_topm {

constexpr int kThreads = 256;
constexpr int kTile = 8192;
constexpr int kPerThread = kTile / kThreads;
constexpr int kWarps = kThreads / 32;

// (score desc, flat index asc): does (s1, i1) outrank (s2, i2)?
__device__ __forceinline__ bool outranks(float s1, int i1, float s2, int i2) {
  return s1 > s2 || (s1 == s2 && i1 < i2);
}

__device__ __forceinline__ void warp_argmax(float& s, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_down_sync(0xffffffffu, s, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (outranks(os, oi, s, i)) {
      s = os;
      i = oi;
    }
  }
}

// The arg-max of thread `tid`'s 32 elements of the shared tile `score`,
// as (score, flat index) with the tile starting at flat index `tile0`.
// Ascending order with a strict '>' keeps the lowest index among equal
// scores. Starting from (-inf, the thread's lowest index) ranks -inf
// elements (masked winners included) by index too, so a tile whose finite
// scores are used up emits (-inf, lowest index), as the TPU kernel's masked
// max does, at the cost of one compare per element: the rescan is on
// every round's critical path.
__device__ __forceinline__ void thread_argmax(const float* score, int tid,
                                              int tile0, float& best_s,
                                              int& best_i) {
  best_s = -INFINITY;
  best_i = tile0 + tid;
  for (int j = 0; j < kPerThread; ++j) {
    const int local = j * kThreads + tid;
    const float s = score[local];
    if (s > best_s) {
      best_s = s;
      best_i = tile0 + local;
    }
  }
}

// m rounds over the shared tile `score`, starting from each thread's
// arg-max (best_s, best_i). Round r calls emit(r, s, i) once, on thread 0,
// with the r-th (score, flat index). Every thread of the block must call
// it; it ends on a barrier-free rescan, so a caller that reuses `score`
// afterwards synchronises first.
template <class Emit>
__device__ __forceinline__ void select_rounds(float* score, float best_s,
                                              int best_i, int tile0, int m,
                                              Emit emit) {
  __shared__ float warp_s[kWarps];
  __shared__ int warp_i[kWarps];
  __shared__ int winner;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int r = 0; r < m; ++r) {
    float s = best_s;
    int i = best_i;
    warp_argmax(s, i);
    if (lane == 0) {
      warp_s[warp] = s;
      warp_i[warp] = i;
    }
    __syncthreads();
    if (warp == 0) {
      s = lane < kWarps ? warp_s[lane] : -INFINITY;
      i = lane < kWarps ? warp_i[lane] : INT_MAX;
      warp_argmax(s, i);
      if (lane == 0) {
        winner = i;
        emit(r, s, i);
      }
    }
    __syncthreads();
    const int local_w = winner - tile0;
    if ((local_w & (kThreads - 1)) == tid) {
      score[local_w] = -INFINITY;
      thread_argmax(score, tid, tile0, best_s, best_i);
    }
  }
}

}  // namespace tile_topm
