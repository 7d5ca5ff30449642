// Warp-level building blocks shared by the LP kernels (lp_rate.cu's warp
// path and lp_commit.cu's segment resolution): sums and scans within
// aligned lane segments, and a bitonic sort of (key, value) pairs held in
// registers.  Everything is in an anonymous namespace: each source that
// includes the header gets its own copy.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// Sum over aligned segments of SW lanes (all lanes end with it).
template <int SW>
__device__ __forceinline__ unsigned segment_sum(unsigned v) {
#pragma unroll
  for (int d = SW >> 1; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

// Inclusive sum scan within aligned segments of SW lanes; `sl` is the
// lane's index in its segment.  Sums wrap modulo 2^32.
template <int SW>
__device__ __forceinline__ unsigned segment_scan_sum(unsigned v, int sl) {
#pragma unroll
  for (int d = 1; d < SW; d <<= 1) {
    unsigned o = __shfl_up_sync(kFull, v, d, SW);
    if (sl >= d) v += o;
  }
  return v;
}

// Ascending bitonic sort of W (key, value) pairs, W a power of two: slot
// j lies at lane j % 32, item j / 32 (W >= 32), or W < 32 pairs in each
// aligned segment of W lanes, each segment sorted on its own (`sl` the
// lane's index in its segment).  Partners 32 or more apart are items of
// the same lane, nearer ones a __shfl_xor_sync away.  Equal keys end in
// no set order: callers that need a stable order make keys unique.
template <class Key, int W, int ITEMS>
__device__ __forceinline__ void warp_bitonic(Key (&key)[ITEMS], int (&val)[ITEMS], int sl) {
#pragma unroll
  for (int k = 2; k <= W; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= 32) {
        // Partner is item i ^ (j / 32) of the same lane.
#pragma unroll
        for (int i = 0; i < ITEMS; ++i) {
          const int p = i ^ (j >> 5);
          if (p > i) {
            const bool up = ((i * 32 + sl) & k) == 0;
            if ((key[i] > key[p]) == up) {
              Key tk = key[i];
              key[i] = key[p];
              key[p] = tk;
              int tv = val[i];
              val[i] = val[p];
              val[p] = tv;
            }
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < ITEMS; ++i) {
          const int e = i * 32 + sl;
          Key o = __shfl_xor_sync(kFull, key[i], j);
          int ov = __shfl_xor_sync(kFull, val[i], j);
          const bool lower = (e & j) == 0, up = (e & k) == 0;
          if (lower == up ? o < key[i] : o > key[i]) {
            key[i] = o;
            val[i] = ov;
          }
        }
      }
    }
  }
}

}  // namespace
