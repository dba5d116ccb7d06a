// Fused select->encode candidates for Hopper (sm_90a).
//
// Replaces the TPU kernel repro.kernels.fused_encode.fused_candidates
// (src/repro/kernels/fused_encode.py, body _fused_kernel): for every
// 8192-element tile of every worker's gradient, compute the Alg. 2 score in
// the tile and emit its top-m (score, a-value, flat index) triples, ties to
// the lowest flat index. The dense score never leaves the SM.
//
// Layout: inputs are [W, rows, 1024] f32 (each worker's vector zero-padded
// to whole tiles, as repro_torch.kernels.ops._tile lays it out); outputs are
// [W, rows / 8, m]. One CTA per (tile, worker): grid (nblk, W), so one launch
// covers all W workers of a leaf. 256 threads; thread t owns the tile
// elements t, t + 256, ..., t + 31 * 256, so the loads are coalesced.
//
// What bounds it: the HBM bound is the four f32 input streams (16 bytes per
// element, about 40 us for the 8 x 1 Mi-element MLP leaf at 3.35 TB/s), but
// the m <= 128 selection rounds, each a block-wide arg-max with two
// barriers, dominate. The design keeps that cost off the whole tile: the
// scores sit in shared memory (32 KiB), each thread keeps the arg-max of its
// own 32 elements in registers, and the rounds of tile_topm.cuh reduce the
// 256 per-thread maxima and rescan only the winner's owner. Making the
// rounds cheaper (a radix select of the m-th score, then one pass) is later
// work.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "score_chain.cuh"
#include "tile_topm.cuh"

namespace {

using tile_topm::kPerThread;
using tile_topm::kThreads;
using tile_topm::kTile;

__global__ void __launch_bounds__(kThreads)
    fused_candidates_kernel(const float* __restrict__ a,
                            const float* __restrict__ a_prev,
                            const float* __restrict__ s_prev,
                            const float* __restrict__ g_prev,
                            float* __restrict__ cand_score,
                            float* __restrict__ cand_val,
                            int32_t* __restrict__ cand_idx, int nblk, int m,
                            float omega, float mu, float q, float y) {
  __shared__ float score[kTile];

  const int tile = blockIdx.x;
  const int worker = blockIdx.y;
  const int tid = threadIdx.x;
  const int tile0 = tile * kTile;  // flat index of the tile's first element
  const size_t base = (size_t)worker * nblk * kTile + tile0;
  const size_t out0 = ((size_t)worker * nblk + tile) * m;

  // scoring: every element once, into shared memory; ascending flat order
  // with a strict '>' keeps the lowest index among a thread's equal scores
  float best_s = -INFINITY;
  int best_i = INT_MAX;
  bool nan = false;
#pragma unroll 4
  for (int j = 0; j < kPerThread; ++j) {
    const int local = j * kThreads + tid;
    const size_t o = base + local;
    const float s =
        score_chain(a[o], a_prev[o], s_prev[o], g_prev[o], omega, mu, q, y);
    score[local] = s;
    nan |= isnan(s);
    if (s > best_s) {
      best_s = s;
      best_i = tile0 + local;
    }
  }

  // A NaN score: the TPU kernel's masked max is then NaN in every round,
  // its lowest-index match finds nothing, and it emits (NaN, 0, INT32_MAX)
  // m times, which fails the certificate. Emit the same and skip the
  // selection, so the rounds compare numbers only.
  if (__syncthreads_or(nan)) {
    for (int r = tid; r < m; r += kThreads) {
      cand_score[out0 + r] = __int_as_float(0x7fc00000);
      cand_val[out0 + r] = 0.0f;
      cand_idx[out0 + r] = INT_MAX;
    }
    return;
  }

  // selection: m rounds of a block-wide arg-max. The scores are >= 0, so
  // every winner is a real element while m <= 8192 (the wrapper's limit).
  tile_topm::select_rounds(score, best_s, best_i, tile0, m,
                           [&](int r, float s, int i) {
                             cand_score[out0 + r] = s;
                             cand_val[out0 + r] = a[base + (i - tile0)];
                             cand_idx[out0 + r] = i;
                           });
}

}  // namespace

// Launch on `stream` (a cudaStream_t); returns cudaGetLastError() after the
// launch, so a refused launch is reported to the caller.
extern "C" int fused_candidates_launch(const void* a, const void* a_prev,
                                       const void* s_prev, const void* g_prev,
                                       void* cand_score, void* cand_val,
                                       void* cand_idx, int workers, int nblk,
                                       int m, float omega, float mu, float q,
                                       float y, void* stream) {
  const dim3 grid(nblk, workers);
  fused_candidates_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)a_prev, (const float*)s_prev,
      (const float*)g_prev, (float*)cand_score, (float*)cand_val,
      (int32_t*)cand_idx, nblk, m, omega, mu, q, y);
  return (int)cudaGetLastError();
}
