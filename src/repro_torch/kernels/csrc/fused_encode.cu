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
// covers all W workers of a leaf. 512 threads; thread t reads the tile
// elements j * 2048 + 4 t .. + 3 (j < 4) of each input as one float4 (four
// scalar loads where an input is not 16-byte aligned), so the loads are
// coalesced and 16 bytes wide.
//
// What bounds it: the HBM bound is the four f32 input streams (16 bytes per
// element, 41 us for the 8 x 1 Mi-element MLP leaf at 3.35 TB/s). The
// selection (tile_topm.cuh) costs each tile a radix select over its 512
// threads' maxima, one pass over the tile and a rank among a few dozen
// survivors, whatever m, where m serial arg-max rounds cost about 1 us
// each; so the score chain and the loads now set the time. On an H100 at
// 700 W the MLP leaf takes about 0.07 ms, a one-wave attention leaf
// (m = 128) about 0.019 ms and a one-tile leaf about 0.012 ms, set by one
// CTA's latency. The scores never leave the SM: they sit in shared memory
// as keys (32 KiB), beside the histogram and the survivors.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "score_chain.cuh"
#include "tile_topm.cuh"

namespace {

using tile_topm::kThreads;
using tile_topm::kTile;
using tile_topm::kVecs;

__global__ void __launch_bounds__(kThreads)
    fused_candidates_kernel(const float* __restrict__ a,
                            const float* __restrict__ a_prev,
                            const float* __restrict__ s_prev,
                            const float* __restrict__ g_prev,
                            float* __restrict__ cand_score,
                            float* __restrict__ cand_val,
                            int32_t* __restrict__ cand_idx, int nblk, int m,
                            float omega, float mu, float q, float y) {
  __shared__ tile_topm::Smem sh;
  extern __shared__ unsigned long long list[];

  const int tile = blockIdx.x;
  const int worker = blockIdx.y;
  const int tid = threadIdx.x;
  const int tile0 = tile * kTile;  // flat index of the tile's first element
  const size_t base = (size_t)worker * nblk * kTile + tile0;
  const size_t out0 = ((size_t)worker * nblk + tile) * m;
  const float* pa = a + base;
  const float* pp = a_prev + base;
  const float* ps = s_prev + base;
  const float* pg = g_prev + base;
  const bool vec = tile_topm::aligned16(pa) && tile_topm::aligned16(pp) &&
                   tile_topm::aligned16(ps) && tile_topm::aligned16(pg);

  // scoring: every element once, into shared memory as keys
  tile_topm::begin(sh, m);
  tile_topm::Seen seen;
  bool nan = false;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const float4 va = tile_topm::load4(pa, j, tid, vec);
    const float4 vp = tile_topm::load4(pp, j, tid, vec);
    const float4 vs = tile_topm::load4(ps, j, tid, vec);
    const float4 vg = tile_topm::load4(pg, j, tid, vec);
    const float xa[4] = {va.x, va.y, va.z, va.w};
    const float xp[4] = {vp.x, vp.y, vp.z, vp.w};
    const float xs[4] = {vs.x, vs.y, vs.z, vs.w};
    const float xg[4] = {vg.x, vg.y, vg.z, vg.w};
    float sc[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      sc[c] = score_chain(xa[c], xp[c], xs[c], xg[c], omega, mu, q, y);
      nan |= isnan(sc[c]);
    }
    tile_topm::put4(sh, j, make_float4(sc[0], sc[1], sc[2], sc[3]), seen);
  }
  tile_topm::end_load(sh, seen);

  // A NaN score: the TPU kernel's masked max is then NaN in every round,
  // its lowest-index match finds nothing, and it emits (NaN, 0, INT32_MAX)
  // m times, which fails the certificate. Emit the same and skip the
  // selection, so it orders numbers only.
  if (__syncthreads_or(nan)) {
    for (int r = tid; r < m; r += kThreads) {
      cand_score[out0 + r] = __int_as_float(0x7fc00000);
      cand_val[out0 + r] = 0.0f;
      cand_idx[out0 + r] = INT_MAX;
    }
    return;
  }

  // The TPU body emits the a-value as a masked sum, which turns -0.0 into
  // +0.0: hence the + 0.0f. The a-value comes from L2, read a moment ago.
  tile_topm::select_top_m(sh, list, seen, m, tile0,
                          [&](int r, float s, int i) {
                            cand_score[out0 + r] = s;
                            cand_val[out0 + r] = pa[i - tile0] + 0.0f;
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
  const size_t smem = tile_topm::list_bytes(m);
  const int err = tile_topm::prepare(fused_candidates_kernel, smem);
  if (err) return err;
  fused_candidates_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)a_prev, (const float*)s_prev,
      (const float*)g_prev, (float*)cand_score, (float*)cand_val,
      (int32_t*)cand_idx, nblk, m, omega, mu, q, y);
  return (int)cudaGetLastError();
}
