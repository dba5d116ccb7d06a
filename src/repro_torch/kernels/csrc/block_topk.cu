// Per-tile top-m candidates of a score, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro.kernels.block_topk.block_topk_candidates
// (src/repro/kernels/block_topk.py, body _block_topm_kernel): for every
// 8192-element tile of every worker's score, emit its top-m (value, flat
// index) pairs by m rounds of a masked max, ties to the lowest flat index.
// The caller (repro_torch.kernels.block_topk.hierarchical_topk) then takes
// the exact top-k over the (rows / 8) * m candidates.
//
// Layout: the score is [W, rows, 1024] f32 (each worker's vector zero-padded
// to whole tiles); outputs are [W, rows / 8, m]. One CTA per (tile, worker),
// 256 threads: kernel 1's selection (tile_topm.cuh) without its score.
//
// What the TPU body does at the edges, and so this kernel too: a tile with a
// NaN has max NaN in every round, no element equals it, and it emits
// (NaN, INT32_MAX) m times; once a tile's finite scores are used up the max
// is -inf and the lowest index holding -inf wins, which after masking is the
// tile's first element.
//
// What bounds it: the m rounds, each a block-wide arg-max with two barriers.
// The read is 4 bytes per element (17.9 MB, 5.3 us at 3.35 TB/s for the
// port's full-width vector), less than one round's latency times m.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "tile_topm.cuh"

namespace {

using tile_topm::kPerThread;
using tile_topm::kThreads;
using tile_topm::kTile;

__global__ void __launch_bounds__(kThreads)
    block_topk_kernel(const float* __restrict__ score,
                      float* __restrict__ vals, int32_t* __restrict__ idx,
                      int nblk, int m) {
  __shared__ float tile_s[kTile];

  const int tile = blockIdx.x;
  const int worker = blockIdx.y;
  const int tid = threadIdx.x;
  const int tile0 = tile * kTile;  // flat index of the tile's first element
  const size_t base = (size_t)worker * nblk * kTile + tile0;
  const size_t out0 = ((size_t)worker * nblk + tile) * m;

  bool nan = false;
#pragma unroll 8
  for (int j = 0; j < kPerThread; ++j) {
    const int local = j * kThreads + tid;
    const float s = score[base + local];
    tile_s[local] = s;
    nan |= isnan(s);
  }
  if (__syncthreads_or(nan)) {
    for (int r = tid; r < m; r += kThreads) {
      vals[out0 + r] = __int_as_float(0x7fc00000);
      idx[out0 + r] = INT_MAX;
    }
    return;
  }

  float best_s;
  int best_i;
  tile_topm::thread_argmax(tile_s, tid, tile0, best_s, best_i);
  tile_topm::select_rounds(tile_s, best_s, best_i, tile0, m,
                           [&](int r, float s, int i) {
                             vals[out0 + r] = s;
                             idx[out0 + r] = i;
                           });
}

}  // namespace

// score: [workers, nblk * 8192] f32; vals, idx: [workers, nblk, m]. Launch on
// `stream` (a cudaStream_t); returns cudaGetLastError() after the launch.
extern "C" int block_topk_launch(const void* score, void* vals, void* idx,
                                 int workers, int nblk, int m, void* stream) {
  const dim3 grid(nblk, workers);
  block_topk_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)score, (float*)vals, (int32_t*)idx, nblk, m);
  return (int)cudaGetLastError();
}
