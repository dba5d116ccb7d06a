// Per-tile top-m candidates of a score, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro.kernels.block_topk.block_topk_candidates
// (src/repro/kernels/block_topk.py, body _block_topm_kernel): for every
// 8192-element tile of every worker's score, emit its top-m (value, flat
// index) pairs, as m rounds of a masked max would, ties to the lowest flat
// index. The caller (repro_torch.kernels.block_topk.hierarchical_topk) then takes
// the exact top-k over the (rows / 8) * m candidates.
//
// Layout: the score is [W, rows, 1024] f32 (each worker's vector zero-padded
// to whole tiles); outputs are [W, rows / 8, m]. One CTA per (tile, worker),
// 512 threads: kernel 1's selection (tile_topm.cuh) without its score, each
// thread loading its 16 scores as 4 float4 into the tile's shared keys.
//
// What the TPU body does at the edges, and so this kernel too: a tile with a
// NaN has max NaN in every round, no element equals it, and it emits
// (NaN, INT32_MAX) m times; once a tile's finite scores are used up the max
// is -inf and the lowest index holding -inf wins, which after masking is the
// tile's first element; and it emits the masked max itself, so a -0.0 comes
// out as +0.0 while a +0.0 at or after it is still in the tile.
//
// What bounds it: the read, 4 bytes per element (17.9 MB, 5.3 us at 3.35
// TB/s for the port's full-width vector). The selection's latency per tile
// (a radix select over the threads' maxima, a pass over the tile and a
// rank among the survivors; a few microseconds, whatever m) sets the time
// instead: 545 tiles of 512 threads at three CTAs per SM (40 registers)
// take 1.4 waves, about 15 us at m = 16 on an H100 at 700 W, where the m
// serial arg-max rounds it replaces took 22 us.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "tile_topm.cuh"

namespace {

using tile_topm::kThreads;
using tile_topm::kTile;
using tile_topm::kVecs;

__global__ void __launch_bounds__(kThreads)
    block_topk_kernel(const float* __restrict__ score,
                      float* __restrict__ vals, int32_t* __restrict__ idx,
                      int nblk, int m) {
  __shared__ tile_topm::Smem sh;
  extern __shared__ unsigned long long list[];

  const int tile = blockIdx.x;
  const int worker = blockIdx.y;
  const int tid = threadIdx.x;
  const int tile0 = tile * kTile;  // flat index of the tile's first element
  const float* ps = score + (size_t)worker * nblk * kTile + tile0;
  const size_t out0 = ((size_t)worker * nblk + tile) * m;
  const bool vec = tile_topm::aligned16(ps);

  tile_topm::begin(sh, m);
  tile_topm::Seen seen;
  bool nan = false;
  float4 v[kVecs];  // all of the thread's loads in flight at once
#pragma unroll
  for (int j = 0; j < kVecs; ++j) v[j] = tile_topm::load4(ps, j, tid, vec);
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    nan |= isnan(v[j].x) | isnan(v[j].y) | isnan(v[j].z) | isnan(v[j].w);
    tile_topm::put4(sh, j, v[j], seen);
  }
  tile_topm::end_load(sh, seen);
  if (__syncthreads_or(nan)) {
    for (int r = tid; r < m; r += kThreads) {
      vals[out0 + r] = __int_as_float(0x7fc00000);
      idx[out0 + r] = INT_MAX;
    }
    return;
  }

  tile_topm::select_top_m(sh, list, seen, m, tile0, [&](int r, float s, int i) {
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
  const size_t smem = tile_topm::list_bytes(m);
  const int err = tile_topm::prepare(block_topk_kernel, smem);
  if (err) return err;
  block_topk_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)score, (float*)vals, (int32_t*)idx, nblk, m);
  return (int)cudaGetLastError();
}
