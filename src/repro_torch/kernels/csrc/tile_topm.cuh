// Per-tile top-m selection by radix select, shared by fused_encode.cu
// (kernel 1, on the Alg. 2 score) and block_topk.cu (on a given score).
//
// One CTA of kThreads threads owns one 8192-element tile and stores its
// scores in shared memory as order-preserving keys (32 KiB): thread t
// writes and later reads the tile elements j * 2048 + 4 t .. + 3 (j < 4)
// as one 16-byte vector, so its loads from device memory are float4 too.
// The order to select by is the TPU kernels' masked max: score
// descending, flat index ascending. It is a total order on the 45-bit
// composite (key << 13) | (8191 - local index). A radix select over that
// composite finds the top-m in a number of passes over the tile that does
// not grow with m:
//
//   1. Radix passes of 8 bits from the top (the last of 5): a pass counts,
//      with one shared atomic per element, the digits of the elements that
//      match the digits fixed so far, and one block scan over the 256 bins
//      (largest digit first) picks the digit that holds the m-th element.
//      The select stops as soon as the chosen bin holds exactly the
//      elements still needed: after the key's 4 bytes at most, or after
//      the 13 index bits when ties straddle the m-th key (the tie cut,
//      lowest index first).
//   2. Every element whose composite prefix is at or above the one found is
//      selected: exactly m of them. One bit per element, a warp scan of the
//      counts and one shared atomic per warp place them in a shared list.
//   3. The list is ordered by counting, for each winner, the winners above
//      it (m <= kThreads, one winner per thread), or by a bitonic sort of
//      the next power of two (dynamic shared memory), and the outputs are
//      written in parallel.
//
// For m <= kThreads a cheaper bound comes first. Each thread keeps the
// largest composite of its own elements while it loads; the m-th largest
// of those kThreads maxima is at or below the tile's m-th largest element
// (the m largest maxima are m distinct elements), so a radix select over
// the maxima alone (one element per thread) gives a cut that keeps every
// winner. One pass over the tile collects the few elements at or above it
// (a few dozen on gradients) and counting ranks among them gives the top-m.
// Only where more than kThreads elements pass that cut (ties, or a tile
// whose maxima crowd together) does the select run over the whole tile.
//
// Chosen by timing variants on the H100 (ptxas -v in the build log): the
// keys live in shared memory, not in registers (32 keys per thread in
// registers took 210 registers, one CTA per SM); 512 threads per tile
// beat 256 and 1024 on kernel 1's training step, since its score chain
// and its one-tile leaves want threads more than CTAs (kernel 1 takes 58
// registers, two CTAs per SM; block_topk 40, three), and capping the
// registers for more CTAs per SM made kernel 1 spill and slowed it; one
// shared atomic per element into one histogram beat per-thread runs of
// equal digits, histogram copies per lane group and __match_any_sync; and
// in kernel 1 neither a bulk L2 prefetch of the four input tiles nor
// loads issued further ahead helped.

// Edges, as the masked-max body emits them: keys make -0.0 tie with +0.0
// (ranked by index, as its '==' does), and a zero is emitted as +0.0 while
// a +0.0 at or after its index is still in the tile (the max of a set
// holding +0.0 is +0.0), else as -0.0; a -inf is emitted at the tile's
// first index, because once the scores above -inf are used up every
// element matches the max. Callers leave NaN scores out: a NaN tile takes
// an early exit.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tile_topm {

constexpr int kThreads = 512;
constexpr int kTile = 8192;
constexpr int kStride = 4 * kThreads;  // tile elements per float4 row
constexpr int kVecs = kTile / kStride;  // float4 per thread
constexpr int kWarps = kThreads / 32;
constexpr int kIdxBits = 13;          // log2(kTile)
constexpr int kBins = 256;
static_assert(kThreads >= kBins && kVecs * 4 <= 32, "one bin per thread");

struct Smem {
  unsigned key[kTile];
  unsigned hist[kBins];
  unsigned long long cand[kThreads];  // survivors of the bound, or winners
  int warp_sum[kWarps];
  int warp_pz[kWarps];
  unsigned long long prefix;  // the composite digits fixed so far
  int k_rem;                  // elements still needed from the prefix's group
  int done;
  int count;  // elements placed in a list
};

// Bytes of dynamic shared memory for a budget of m (1 <= m <= kTile): the
// sort's list, where the winners do not fit in Smem::cand.
inline size_t list_bytes(int m) {
  if (m <= kThreads) return 0;
  size_t p = 1;
  while (p < (size_t)m) p <<= 1;
  return p * sizeof(unsigned long long);
}

// Before a kernel's launches: prefer the largest shared-memory carveout
// (once per process), and allow the dynamic list where the CTA's shared
// memory exceeds the 48 KiB a launch gets without asking. Returns a
// cudaError_t.
template <class Kernel>
inline int prepare(Kernel kernel, size_t dyn) {
  static const cudaError_t carve = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (carve != cudaSuccess) return (int)carve;
  if (dyn + sizeof(Smem) <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
}

// Order-preserving key: key(a) < key(b) iff a < b, with -0.0 mapped to
// +0.0's key. Every key is above 0, which pads the sort.
__device__ __forceinline__ unsigned order_key(float f) {
  unsigned u = __float_as_uint(f);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ unsigned long long composite(unsigned key,
                                                        int local) {
  return ((unsigned long long)key << kIdxBits) |
         (unsigned long long)(kTile - 1 - local);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
}

// Elements j * kStride + 4 tid .. + 3 of the tile at p: one float4 where p
// is 16-byte aligned, else four scalar loads.
__device__ __forceinline__ float4 load4(const float* __restrict__ p, int j,
                                        int tid, bool vec) {
  const int o = j * kStride + 4 * tid;
  if (vec) return __ldg(reinterpret_cast<const float4*>(p + o));
  return make_float4(__ldg(p + o), __ldg(p + o + 1), __ldg(p + o + 2),
                     __ldg(p + o + 3));
}

// What a thread gathers while it loads: the highest local index of a +0.0
// it has seen, and the largest composite of its elements.
struct Seen {
  int pz = -1;
  unsigned long long best = 0ull;
};

// Before the caller's first barrier: clear the histogram and start the
// prefix.
__device__ __forceinline__ void begin(Smem& sh, int m) {
  for (int i = threadIdx.x; i < kBins; i += kThreads) sh.hist[i] = 0u;
  if (threadIdx.x == 0) {
    sh.prefix = 0ull;
    sh.k_rem = m;
    sh.count = 0;
  }
}

// The scores of the tile elements j * kStride + 4 tid .. + 3: their keys
// into shared memory, and what the thread has seen.
__device__ __forceinline__ void put4(Smem& sh, int j, float4 s, Seen& seen) {
  const int local = j * kStride + 4 * threadIdx.x;
  const float x[4] = {s.x, s.y, s.z, s.w};
  unsigned k[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    k[c] = order_key(x[c]);
    if (__float_as_uint(x[c]) == 0u) seen.pz = max(seen.pz, local + c);
    const unsigned long long comp = composite(k[c], local + c);
    if (comp > seen.best) seen.best = comp;
  }
  *reinterpret_cast<uint4*>(&sh.key[local]) = make_uint4(k[0], k[1], k[2], k[3]);
}

// Before the caller's barrier after the loads: each warp's highest +0.0.
__device__ __forceinline__ void end_load(Smem& sh, const Seen& seen) {
  int pz = seen.pz;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    pz = max(pz, __shfl_xor_sync(0xffffffffu, pz, off));
  if ((threadIdx.x & 31) == 0) sh.warp_pz[threadIdx.x >> 5] = pz;
}

// Inclusive block-wide prefix sum of v in thread order. Every thread calls
// it; a caller that scans again synchronises first.
__device__ __forceinline__ int block_scan(int v, int* warp_sum) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += y;
  }
  if (lane == 31) warp_sum[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_sum[lane] : 0;
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    if (lane < kWarps) warp_sum[lane] = w;
  }
  __syncthreads();
  return v + (warp ? warp_sum[warp - 1] : 0);
}

// Descending bitonic sort of list[0, p), p a power of two.
__device__ __forceinline__ void bitonic_desc(unsigned long long* list, int p) {
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < p; i += kThreads) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long a = list[i];
          const unsigned long long b = list[ixj];
          if (((i & k) == 0) ? (a < b) : (a > b)) {
            list[i] = b;
            list[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Each thread's elements of the whole tile: f(key, local) for each.
struct TileElems {
  const Smem& sh;
  template <class F>
  __device__ __forceinline__ void operator()(F f) const {
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int local = j * kStride + 4 * threadIdx.x;
      const uint4 k4 = *reinterpret_cast<const uint4*>(&sh.key[local]);
      f(k4.x, local);
      f(k4.y, local + 1);
      f(k4.z, local + 2);
      f(k4.w, local + 3);
    }
  }
};

// One element per thread: its largest composite.
struct ThreadBest {
  unsigned long long best;
  template <class F>
  __device__ __forceinline__ void operator()(F f) const {
    f((unsigned)(best >> kIdxBits), kTile - 1 - (int)(best & (kTile - 1)));
  }
};

// A prefix of `fixed` bits of the composite: is an element's at or above?
struct Cut {
  int fixed;
  unsigned long long prefix;

  __device__ __forceinline__ bool keeps(unsigned k, int local) const {
    if (fixed <= 32) {
      const unsigned mask = fixed ? ~0u << (32 - fixed) : 0u;
      return (k & mask) >= (fixed ? (unsigned)prefix << (32 - fixed) : 0u);
    }
    const int ib = fixed - 32;
    const unsigned key = (unsigned)(prefix >> ib);
    const unsigned inv = (unsigned)(kTile - 1 - local) >> (kIdxBits - ib);
    return k > key || (k == key && inv >= ((unsigned)prefix & ((1u << ib) - 1u)));
  }
};

// After a pass's counting: pick the digit of the m-th element (bins in
// descending order, one per thread), clear the histogram and extend the
// prefix. Returns whether the chosen bin holds exactly the elements still
// needed, which ends the select.
__device__ __forceinline__ bool choose_digit(Smem& sh, int bits) {
  __syncthreads();
  const int d = (1 << bits) - 1 - (int)threadIdx.x;
  int cnt = 0;
  if (d >= 0) {
    cnt = (int)sh.hist[d];
    sh.hist[d] = 0u;
  }
  const int k_rem = sh.k_rem;
  const int incl = block_scan(cnt, sh.warp_sum);
  const int excl = incl - cnt;
  if (cnt > 0 && excl < k_rem && k_rem <= incl) {
    sh.prefix = (sh.prefix << bits) | (unsigned long long)d;
    sh.k_rem = k_rem - excl;
    sh.done = cnt == k_rem - excl;
  }
  __syncthreads();
  return sh.done;
}

// Radix select of the sh.k_rem-th largest composite among the elements that
// `elems` gives each thread, from sh.prefix = 0 and a clear histogram.
// `done` says the set holds exactly sh.k_rem elements. Returns the cut that
// keeps exactly that many.
template <class Elems>
__device__ __forceinline__ Cut radix_select(Smem& sh, Elems elems, bool done) {
  int fixed = 0;  // the same in every thread
  // the key's bytes in 32-bit arithmetic
  while (!done && fixed < 32) {
    const unsigned mask = fixed ? ~0u << (32 - fixed) : 0u;
    const unsigned want = fixed ? (unsigned)sh.prefix << (32 - fixed) : 0u;
    const int shift = 24 - fixed;
    elems([&](unsigned k, int) {
      if ((k & mask) == want) atomicAdd(&sh.hist[(k >> shift) & 0xffu], 1u);
    });
    done = choose_digit(sh, 8);
    fixed += 8;
  }
  // the inverted index, 8 bits and 5, only when ties straddle the m-th key
  while (!done) {
    const int ib = fixed - 32;
    const int bits = min(8, kIdxBits - ib);
    const unsigned key = (unsigned)(sh.prefix >> ib);
    const unsigned want = (unsigned)sh.prefix & ((1u << ib) - 1u);
    elems([&](unsigned k, int local) {
      const unsigned inv = (unsigned)(kTile - 1 - local);
      if (k == key && (inv >> (kIdxBits - ib)) == want)
        atomicAdd(&sh.hist[(inv >> (kIdxBits - ib - bits)) & ((1u << bits) - 1u)],
                  1u);
    });
    done = choose_digit(sh, bits);
    fixed += bits;
  }
  return Cut{fixed, sh.prefix};
}

// The tile's elements that `cut` keeps, as composites into list[]: one bit
// per element, a warp scan and one shared atomic per warp (sh.count, from
// 0) for their places; those past `cap` are counted, not written. Ends on
// a barrier.
__device__ __forceinline__ void collect(Smem& sh, const Cut& cut,
                                        unsigned long long* list, int cap) {
  unsigned sel = 0u;
  int e = 0;
  TileElems{sh}([&](unsigned k, int local) {
    sel |= (unsigned)cut.keeps(k, local) << e++;
  });
  const int n = __popc(sel);
  const int lane = threadIdx.x & 31;
  int incl = n;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  int base = 0;
  if (lane == 31) base = atomicAdd(&sh.count, incl);
  int pos = __shfl_sync(0xffffffffu, base, 31) + incl - n;
  for (; sel && pos < cap; ++pos) {
    const int b = __ffs(sel) - 1;
    sel &= sel - 1u;
    const int local = (b >> 2) * kStride + 4 * threadIdx.x + (b & 3);
    list[pos] = composite(sh.key[local], local);
  }
  __syncthreads();
}

// The tile's top-m of the keys in sh.key, after begin, put4 and end_load
// and a barrier. Calls emit(r, value, flat index) for r in [0, m), spread
// over the threads. `list` holds list_bytes(m) of dynamic shared memory.
template <class Emit>
__device__ __forceinline__ void select_top_m(Smem& sh, unsigned long long* list,
                                             const Seen& seen, int m,
                                             int tile0, Emit emit) {
  const int tid = threadIdx.x;
  int last_pz = -1;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) last_pz = max(last_pz, sh.warp_pz[w]);
  const auto put = [&](int r, unsigned long long c) {
    const int local = kTile - 1 - (int)(c & (kTile - 1));
    float v = key_float((unsigned)(c >> kIdxBits));
    if (v == 0.0f) v = local <= last_pz ? 0.0f : -0.0f;
    emit(r, v, v == -INFINITY ? tile0 : tile0 + local);
  };
  // the winners of a list of n composites, by counting those above each
  const auto rank_out = [&](const unsigned long long* c, int n) {
    if (tid < n) {
      const unsigned long long mine = c[tid];
      int rank = 0;
      for (int i = 0; i < n; ++i) rank += c[i] > mine;
      if (rank < m) put(rank, mine);
    }
  };

  if (m <= kThreads) {
    // the bound: the m-th largest of the threads' maxima
    const Cut bound = radix_select(sh, ThreadBest{seen.best}, m == kThreads);
    collect(sh, bound, sh.cand, kThreads);
    const int survivors = sh.count;
    if (survivors <= kThreads) {
      rank_out(sh.cand, survivors);
      return;
    }
    __syncthreads();  // every thread has read sh.count
    if (tid == 0) {
      sh.prefix = 0ull;
      sh.k_rem = m;
      sh.count = 0;
    }
    __syncthreads();
  }

  // the select over the whole tile
  const Cut cut = radix_select(sh, TileElems{sh}, m == kTile);
  if (m <= kThreads) {
    collect(sh, cut, sh.cand, kThreads);
    rank_out(sh.cand, m);
    return;
  }
  collect(sh, cut, list, m);
  int p = 1;
  while (p < m) p <<= 1;
  for (int i = m + tid; i < p; i += kThreads) list[i] = 0ull;
  __syncthreads();
  bitonic_desc(list, p);
  for (int r = tid; r < m; r += kThreads) put(r, list[r]);
}

}  // namespace tile_topm
