// LP commit kernel: movers, capacity auction and state update of one round.
//
// Replaces the TPU kernel `commit_moves` (kaminpar_tpu/ops/pallas_lp.py:654,
// body `_make_commit_kernel` :560).  Computes exactly what
// `ops/lp._commit_moves` computes, with either of its auctions:
//   mover: tconn > own_conn (or a tie with `coin` when allow_tie), desired
//   label t != current label, masked by `color` and `act` when given;
//   auction: per target label, movers are admitted in priority order while
//   they fit the label's slack (cap - label weight);
//   commit: new labels, label weights recomputed over all nodes, moves.
//
// The fact the design rests on.  For a mover i with target t and priority
// p_i let D_t(p) = sum of w_j over the movers j with target t and p_j <= p,
// and slack_t = cap_t - label_w_t.  Both auctions of the plain version
// (radix-32 and bitwise) admit i if and only if D_t(p_i) <= slack_t.  D_t
// is monotone, so each auction's greedy descent over the priority bits
// finds the largest threshold x with D_t(x - 1) <= slack_t, and p_i < x
// exactly when D_t(p_i) <= slack_t; with slack_t < 0 nobody is admitted,
// and movers of one target with equal priority go in or out together.  It
// holds on the domain the LP round draws: priorities in [0, 2^30 - 1) and
// a total node weight below 2^31, so that no int32 sum wraps.  Hence:
// - a target whose whole demand D_t(inf) fits its slack admits all its
//   movers (uncontested: the common case at the finest levels);
// - a contested target admits the movers with p_i < thr_t, thr_t = min{p_i
//   : D_t(p_i) > slack_t}.  No per-bit or per-digit pass over the nodes.
//
// What bounds it on the H100: memory.  The function reads its inputs once
// (labels, node_w, target, tconn, own_conn, prio: 6n int32; the flags it
// uses, n bytes each; label_w and the caps) and writes new_labels (n),
// new_weights (L) and the count: 0.07 ms at n = L = 5.9M.  The earlier
// design resolved the auction level by level, 6 (radix) or 30 (bitwise)
// pairs of grid-wide launches, each re-reading 13 bytes per node, 60-68x
// that bound.
//
// Design: a fixed number of launches whatever L and the priority bits.
// 1. movers pass over the nodes: decides `moved`, stores the target (-1
//    for a node that stays); a mover adds (1 << 32 | w) into its target's
//    64-bit (count, demand) word and goes to a compact list (target, prio,
//    w), one atomicAdd per block tile of kTile nodes (a block scan gives each
//    thread its slots; one atomicAdd per warp through __ballot_sync and
//    __popc serialised 185K adds on the one counter at n = 5.9M).  It
//    also zeroes the moved count, and the label passes of step 2 zero
//    new_weights.
// 2. resolution over the movers only, in one of two regimes picked from L:
//    - many labels (L > kFewLabels; clustering, L = n_pad): a contest pass
//      over the labels (contested or not, thr = INT32_MAX, a tile sum of
//      the contested movers), a one-block scan of the tile sums, an
//      offsets pass (each contested label's segment start; short segments
//      of up to kWarpSeg movers and long ones listed apart), a counting-sort
//      scatter of the contested movers' (prio, w) into their segments (one
//      device atomic on the label's cursor per mover), and a resolve pass: a
//      short segment goes to one warp, which sorts it by priority in
//      registers (warp_sort.cuh, the rating kernel's network), scans the
//      weights and reads D_t at the last of each run of equal priorities;
//      a longer segment (at RMAT scale 22 the level-0 clustering rounds
//      put up to 3,410 movers on one target) goes to one block, which
//      finds the threshold by a radix search in shared memory, kSegBits
//      bits a level.
//    - few labels (L <= kFewLabels; refinement, L = 64): one cooperative
//      launch runs the radix-32 threshold search over the mover list, its
//      6 levels separated by grid syncs; each block keeps its (L, 32)
//      histogram in shared memory and merges it with one atomic per
//      nonzero bin into that level's global histogram, then every block
//      updates every contested label's threshold from it.  The grid is at
//      most the blocks that the occupancy calculator lets reside at once.
//      The movers and accept passes keep their per-label sums in shared
//      memory too, so that a few labels are not hammered by global atomics.
// 3. accept pass, the second pass over the nodes: a mover is accepted
//    when prio < thr[t]; new labels, new_weights by atomicAdd (per block
//    in shared memory for few labels), the moved count by warp reduction.
//    (Committing the nodes that stay in pass 1 and the movers from the
//    list spares the second read of the nodes, but not the n atomics on
//    new_weights, which bound both passes in clustering: no faster there,
//    and slower when many movers share a target.)
// Every pass starts a tile's loads before any store, so that each thread
// keeps them all in flight.  Launches: 1 memset + 7 kernels (many labels)
// or 1 memset + 3 kernels (few labels); with n = 0 two memsets alone.
// With no contested mover the resolution kernels find empty lists and
// return.  The mover list's order changes from run to run
// (atomic appends), but nothing that decides a result depends on it:
// integer sums and a sort by priority whose ties are read as one run.  So
// the result is deterministic and equals the plain version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

#include "warp_sort.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;     // grid of the passes over nodes and lists
constexpr int kPrioBits = 30;
constexpr int kRadixBits = 5;       // few-label search: 6 levels of 32 digits
constexpr int kRadix = 1 << kRadixBits;
constexpr int kRadixLevels = kPrioBits / kRadixBits;
constexpr int kFewLabels = 256;     // at most: the few-label regime
constexpr int kSegBits = 10;        // long segments: 3 levels of 1024 digits
constexpr int kSegBins = 1 << kSegBits;
constexpr int kSegLevels = kPrioBits / kSegBits;
constexpr int kWarpSeg = 64;        // segments up to this many movers: one warp
constexpr int kTileItems = 8;
constexpr int kTile = kThreads * kTileItems;  // nodes or labels per block tile
constexpr int kScanThreads = 1024;
constexpr int kNoThr = 0x7fffffff;  // threshold of a label that admits all
static_assert(kPrioBits % kRadixBits == 0 && kPrioBits % kSegBits == 0, "levels");
static_assert(kSegBins % kThreads == 0, "bins per thread");

typedef cub::BlockScan<int, kThreads> BlockScanT;

struct Args {
  int n, L;
  const int* labels;
  const int* node_w;
  const int* label_w;
  const int* maxw;
  int maxw_scalar;
  const int* target;
  const int* tconn;
  const int* own_conn;
  const int* prio;
  const unsigned char* coin;
  const unsigned char* act;
  const unsigned char* color;
  int allow_tie, use_act, use_color;
  // Scratch (kp_commit_scratch_bytes).
  int* ctr;  // [0] movers listed, [1] short segments, [2] long segments
  // Per label: (movers << 32 | demand) after the movers pass; then read as
  // int2 {x: -1 uncontested / mover count, then segment cursor; y: thr}.
  unsigned long long* acc;
  int* ghist;  // few labels: kRadixLevels histograms of (L, kRadix)
  int* t_idx;  // per node: target of a mover, -1 for a node that stays
  int* list_t;  // the movers: target, priority, weight
  int* list_p;
  int* list_w;
  int* seg_p;  // many labels: contested movers grouped by target
  int* seg_w;
  int* tile_sums;
  int* seg_l;  // segments: short ones from 0 up, long ones from kmax - 1 down
  int* seg_o;
  int* seg_c;
  int kmax;
  // Outputs.
  int* new_labels;
  int* new_weights;
  int* moved_count;
};

__device__ __forceinline__ int2* acc2(const Args& a) { return reinterpret_cast<int2*>(a.acc); }

// cap - label weight, wrapping as the plain int32 subtraction does.
__device__ __forceinline__ int slack_of(const Args& a, int l) {
  return (int)((unsigned)(a.maxw_scalar ? a.maxw[0] : a.maxw[l]) - (unsigned)a.label_w[l]);
}

// Block-aggregated append: each thread of the block has `cnt` items and
// gets the first of `cnt` consecutive slots of `counter`'s range, with one
// atomicAdd per block.  `packed` holds two counts (low and high 16 bits,
// block totals below 2^16) for two counters.  All threads call.
struct Append {
  BlockScanT::TempStorage scan;
  int base[2];
};

__device__ __forceinline__ int block_append(Append& s, int cnt, int* counter) {
  int off, total;
  BlockScanT(s.scan).ExclusiveSum(cnt, off, total);
  if (threadIdx.x == 0) s.base[0] = total != 0 ? atomicAdd(counter, total) : 0;
  __syncthreads();
  const int at = s.base[0] + off;
  __syncthreads();  // s is free for the next call
  return at;
}

__device__ __forceinline__ void block_append2(Append& s, int packed, int* counter0,
                                              int* counter1, int& at0, int& at1) {
  int off, total;
  BlockScanT(s.scan).ExclusiveSum(packed, off, total);
  if (threadIdx.x == 0) {
    s.base[0] = (total & 0xffff) != 0 ? atomicAdd(counter0, total & 0xffff) : 0;
    s.base[1] = (total >> 16) != 0 ? atomicAdd(counter1, total >> 16) : 0;
  }
  __syncthreads();
  at0 = s.base[0] + (off & 0xffff);
  at1 = s.base[1] + (off >> 16);
  __syncthreads();
}

// One radix level of one label in one warp: `hv` is digit `lane`'s weight.
// j = the digits whose cumulative weight fits `room` (a prefix: the sums
// are monotone), gained = the cumulative weight of those j digits.
__device__ __forceinline__ void warp_radix_step(int hv, int room, int lane, int& j,
                                                int& gained) {
  const int cum = (int)segment_scan_sum<32>((unsigned)hv, lane);
  const unsigned fit = __ballot_sync(kFull, room >= 0 && cum <= room);
  j = __popc(fit);
  gained = __shfl_sync(kFull, cum, j > 0 ? j - 1 : 0);
  if (j == 0) gained = 0;
}

// ---------------------------------------------------------------------------
// 1. Movers pass.

// One tile of kTile nodes per block and step (item k of thread j is node
// tile + k * kThreads + j); the tile's movers take one range of the list.
template <bool kFew>
__global__ void __launch_bounds__(kThreads) movers_kernel(Args a) {
  extern __shared__ unsigned long long s_acc[];  // L entries when kFew
  __shared__ Append app;
  if (kFew) {
    for (int l = threadIdx.x; l < a.L; l += kThreads) s_acc[l] = 0;
    __syncthreads();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.moved_count = 0;
  for (long long base = (long long)blockIdx.x * kTile; base < a.n;
       base += (long long)gridDim.x * kTile) {
    // Every load of the tile first, none behind a store or a branch on
    // loaded data, so that a thread has all of them in flight at once.
    int t[kTileItems], p[kTileItems], w[kTileItems], tc[kTileItems], oc[kTileItems],
        lab[kTileItems];
    bool in[kTileItems], coin[kTileItems], keep[kTileItems];
#pragma unroll
    for (int k = 0; k < kTileItems; ++k) {
      const long long i = base + k * kThreads + threadIdx.x;
      in[k] = i < a.n;
      tc[k] = in[k] ? a.tconn[i] : 0;
      oc[k] = in[k] ? a.own_conn[i] : 0;
      lab[k] = in[k] ? a.labels[i] : 0;
      t[k] = in[k] ? a.target[i] : 0;
      w[k] = in[k] ? a.node_w[i] : 0;
      p[k] = in[k] ? a.prio[i] : 0;
      coin[k] = a.allow_tie && in[k] && a.coin[i];
      const bool col = !a.use_color || (in[k] && a.color[i]);
      const bool act = !a.use_act || (in[k] && a.act[i]);
      keep[k] = in[k] & col & act;
    }
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < kTileItems; ++k) {
      const long long i = base + k * kThreads + threadIdx.x;
      const bool better = tc[k] > oc[k] || (coin[k] && tc[k] == oc[k]);
      const bool mv = keep[k] && better && t[k] != lab[k];
      if (mv) {
        const unsigned long long add = (1ull << 32) | (unsigned)w[k];
        atomicAdd(kFew ? &s_acc[t[k]] : &a.acc[t[k]], add);
        ++cnt;
      } else {
        t[k] = -1;
      }
      if (in[k]) a.t_idx[i] = t[k];
    }
    int r = block_append(app, cnt, &a.ctr[0]);
#pragma unroll
    for (int k = 0; k < kTileItems; ++k) {
      if (t[k] >= 0) {
        a.list_t[r] = t[k];
        a.list_p[r] = p[k];
        a.list_w[r] = w[k];
        ++r;
      }
    }
  }
  if (kFew) {
    __syncthreads();
    for (int l = threadIdx.x; l < a.L; l += kThreads) {
      const unsigned long long v = s_acc[l];
      if (v != 0) atomicAdd(&a.acc[l], v);
    }
  }
}

// ---------------------------------------------------------------------------
// 2a. Many labels: contest pass, tile scan, offsets, scatter, resolve.

__global__ void __launch_bounds__(kThreads) contest_kernel(Args a) {
  typedef cub::BlockReduce<int, kThreads> Reduce;
  __shared__ typename Reduce::TempStorage tmp;
  const long long base = (long long)blockIdx.x * kTile;
  unsigned long long v[kTileItems];
  int slack[kTileItems];
#pragma unroll
  for (int k = 0; k < kTileItems; ++k) {  // loads first, as in the movers pass
    const long long l = base + k * kThreads + threadIdx.x;
    v[k] = l < a.L ? a.acc[l] : 0ull;
    slack[k] = l < a.L ? slack_of(a, (int)l) : 0;
  }
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kTileItems; ++k) {
    const long long l = base + k * kThreads + threadIdx.x;
    if (l >= a.L) continue;
    a.new_weights[l] = 0;
    const int cnt = (int)(v[k] >> 32);
    if (cnt > 0) {
      const bool contested = (int)(unsigned)v[k] > slack[k];
      acc2(a)[l] = make_int2(contested ? cnt : -1, kNoThr);
      if (contested) sum += cnt;
    }
  }
  const int tile = Reduce(tmp).Sum(sum);
  if (threadIdx.x == 0) a.tile_sums[blockIdx.x] = tile;
}

// Exclusive scan of the T tile sums, in place, by one block.
__global__ void __launch_bounds__(kScanThreads) scan_tiles_kernel(int T, int* tile_sums) {
  typedef cub::BlockScan<int, kScanThreads> Scan;
  __shared__ typename Scan::TempStorage tmp;
  int carry = 0;
  for (int base = 0; base < T; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int v = i < T ? tile_sums[i] : 0;
    int excl, total;
    Scan(tmp).ExclusiveSum(v, excl, total);
    if (i < T) tile_sums[i] = carry + excl;
    carry += total;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads) offsets_kernel(Args a) {
  __shared__ Append app;
  const long long base = (long long)blockIdx.x * kTile;
  int c[kTileItems];
  int sum = 0, nshort = 0, nlong = 0;
#pragma unroll
  for (int k = 0; k < kTileItems; ++k) {
    const long long l = base + k * kThreads + threadIdx.x;
    c[k] = l < a.L ? max(acc2(a)[l].x, 0) : 0;
    sum += c[k];
    nshort += c[k] > 0 && c[k] <= kWarpSeg;
    nlong += c[k] > kWarpSeg;
  }
  int off;
  BlockScanT(app.scan).ExclusiveSum(sum, off);
  off += a.tile_sums[blockIdx.x];
  __syncthreads();
  int qs, ql;
  block_append2(app, nshort | (nlong << 16), &a.ctr[1], &a.ctr[2], qs, ql);
#pragma unroll
  for (int k = 0; k < kTileItems; ++k) {
    if (c[k] > 0) {
      const long long l = base + k * kThreads + threadIdx.x;
      const int q = c[k] <= kWarpSeg ? qs++ : a.kmax - 1 - ql++;
      acc2(a)[l].x = off;
      a.seg_l[q] = (int)l;
      a.seg_o[q] = off;
      a.seg_c[q] = c[k];
      off += c[k];
    }
  }
}

// Each contested mover's (prio, w) into its target's segment, kTile list
// entries per block and step, at the slot an atomicAdd on the label's
// cursor gives it.
__global__ void __launch_bounds__(kThreads) scatter_kernel(Args a) {
  const int m = a.ctr[0];
  int* cursor = reinterpret_cast<int*>(a.acc);  // x of label l at 2 * l
  for (int base = blockIdx.x * kTile; base < m; base += gridDim.x * kTile) {
    int t[kTileItems], p[kTileItems], w[kTileItems];
#pragma unroll
    for (int k = 0; k < kTileItems; ++k) {
      const int e = base + k * kThreads + threadIdx.x;
      t[k] = e < m ? a.list_t[e] : -1;
      p[k] = e < m ? a.list_p[e] : 0;
      w[k] = e < m ? a.list_w[e] : 0;
    }
#pragma unroll
    for (int k = 0; k < kTileItems; ++k) {
      if (t[k] < 0 || __ldcg(cursor + 2 * (long long)t[k]) < 0) continue;
      const int pos = atomicAdd(cursor + 2 * (long long)t[k], 1);
      a.seg_p[pos] = p[k];
      a.seg_w[pos] = w[k];
    }
  }
}

// Threshold of a segment of c <= W movers in one warp: sort by priority,
// inclusive scan of the weights; thr = the first priority at the end of a
// run of equal priorities whose scan (that is D_t there) exceeds slack.
template <int W>
__device__ __forceinline__ int resolve_warp(const Args& a, int off, int c, int slack,
                                            int lane) {
  constexpr int ITEMS = W / 32;
  unsigned key[ITEMS];
  int val[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int e = i * 32 + lane;
    key[i] = e < c ? (unsigned)a.seg_p[off + e] : 0xffffffffu;
    val[i] = e < c ? a.seg_w[off + e] : 0;
  }
  warp_bitonic<unsigned, W, ITEMS>(key, val, lane);
  unsigned carry = 0;
  int thr = kNoThr;
  bool found = false;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const unsigned s = segment_scan_sum<32>((unsigned)val[i], lane) + carry;
    if (ITEMS > 1) carry = __shfl_sync(kFull, s, 31);
    unsigned next = __shfl_down_sync(kFull, key[i], 1);
    if (ITEMS > 1) {
      const unsigned next_item = __shfl_sync(kFull, key[i + 1 < ITEMS ? i + 1 : i], 0);
      if (lane == 31) next = next_item;
    }
    const int e = i * 32 + lane;
    const bool run_end = e == W - 1 || next != key[i];
    const unsigned over = __ballot_sync(kFull, e < c && run_end && (int)s > slack);
    if (!found && over != 0) {
      thr = (int)__shfl_sync(kFull, key[i], __ffs(over) - 1);
      found = true;
    }
  }
  return thr;
}

struct BlockRes {
  BlockScanT::TempStorage scan;
  int hist[kSegBins];
  int j, gain;
};

// Threshold of a long segment in one block: the radix auction of the
// plain version on this one label, kSegBits bits a level, the histogram
// in shared memory.
__device__ void resolve_block(const Args& a, BlockRes& s, int l, int off, int c) {
  constexpr int PER = kSegBins / kThreads;
  const int tid = threadIdx.x;
  const int slack = slack_of(a, l);
  int thr = 0, adm = 0;  // the same in every thread
  for (int lev = 0; lev < kSegLevels; ++lev) {
    const int shift = kPrioBits - kSegBits * (lev + 1);
    for (int b = tid; b < kSegBins; b += kThreads) s.hist[b] = 0;
    if (tid == 0) {
      s.j = 0;
      s.gain = 0;
    }
    __syncthreads();
    // kTileItems loads of each array in flight per thread: one block
    // takes a whole segment, so its loop is bound by load latency otherwise.
    for (int e0 = tid; e0 < c; e0 += kTile) {
      int p[kTileItems], w[kTileItems];
#pragma unroll
      for (int k = 0; k < kTileItems; ++k) {
        const int e = e0 + k * kThreads;
        p[k] = e < c ? a.seg_p[off + e] : -1;
        w[k] = e < c ? a.seg_w[off + e] : 0;
      }
#pragma unroll
      for (int k = 0; k < kTileItems; ++k) {
        if (p[k] >= thr && (p[k] >> (shift + kSegBits)) == (thr >> (shift + kSegBits)) &&
            w[k] != 0) {
          atomicAdd(&s.hist[(p[k] >> shift) & (kSegBins - 1)], w[k]);
        }
      }
    }
    __syncthreads();
    int v[PER];
    int sum = 0;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      v[q] = s.hist[tid * PER + q];
      sum += v[q];
    }
    int cum;
    BlockScanT(s.scan).ExclusiveSum(sum, cum);
    const int room = slack - adm;
    int cnt = 0, gain = 0;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      cum += v[q];
      if (room >= 0 && cum <= room) {
        ++cnt;
        gain = cum;
      }
    }
    if (cnt != 0) {
      atomicAdd(&s.j, cnt);
      atomicMax(&s.gain, gain);
    }
    __syncthreads();
    adm += s.gain;
    thr += s.j << shift;
    __syncthreads();
  }
  if (tid == 0) acc2(a)[l].y = thr;
}

__global__ void __launch_bounds__(kThreads) resolve_kernel(Args a) {
  __shared__ BlockRes s;
  const int nlong = a.ctr[2];
  for (int q = blockIdx.x; q < nlong; q += gridDim.x) {
    const int at = a.kmax - 1 - q;
    resolve_block(a, s, a.seg_l[at], a.seg_o[at], a.seg_c[at]);
  }
  const int nshort = a.ctr[1];
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (kThreads / 32);
  for (int q = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5); q < nshort; q += warps) {
    const int l = a.seg_l[q], off = a.seg_o[q], c = a.seg_c[q];
    const int slack = slack_of(a, l);
    const int thr = c <= 32 ? resolve_warp<32>(a, off, c, slack, lane)
                            : resolve_warp<64>(a, off, c, slack, lane);
    if (lane == 0) acc2(a)[l].y = thr;
  }
}

// ---------------------------------------------------------------------------
// 2b. Few labels: the radix-32 search in one cooperative launch.

__global__ void __launch_bounds__(kThreads) auction_few_kernel(Args a) {
  extern __shared__ int smem[];
  const int L = a.L;
  int* s_hist = smem;              // (L, kRadix)
  int* s_slack = s_hist + L * kRadix;
  int* s_adm = s_slack + L;
  int* s_thr = s_adm + L;          // kNoThr: out of the auction
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int l = tid; l < L; l += kThreads) {
    const unsigned long long v = a.acc[l];
    const int slack = slack_of(a, l);
    const bool contested = (v >> 32) != 0 && (int)(unsigned)v > slack;
    s_slack[l] = slack;
    s_adm[l] = 0;
    s_thr[l] = contested ? 0 : kNoThr;
    if (blockIdx.x == 0) a.new_weights[l] = 0;
  }
  const int m = a.ctr[0];
  for (int lev = 0; lev < kRadixLevels; ++lev) {
    const int shift = kPrioBits - kRadixBits * (lev + 1);
    for (int b = tid; b < L * kRadix; b += kThreads) s_hist[b] = 0;
    __syncthreads();
    for (int k = blockIdx.x * kThreads + tid; k < m; k += gridDim.x * kThreads) {
      const int t = a.list_t[k];
      const int th = s_thr[t];
      if (th == kNoThr) continue;
      const int p = a.list_p[k];
      if ((p >> (shift + kRadixBits)) == (th >> (shift + kRadixBits)) && p >= th) {
        const int w = a.list_w[k];
        if (w != 0) atomicAdd(&s_hist[t * kRadix + ((p >> shift) & (kRadix - 1))], w);
      }
    }
    __syncthreads();
    int* gh = a.ghist + (long long)lev * L * kRadix;
    for (int b = tid; b < L * kRadix; b += kThreads) {
      const int v = s_hist[b];
      if (v != 0) atomicAdd(&gh[b], v);
    }
    grid.sync();
    for (int l = warp; l < L; l += kThreads / 32) {
      const int th = s_thr[l];
      if (th == kNoThr) continue;
      int j, gained;
      warp_radix_step(__ldcg(&gh[l * kRadix + lane]), s_slack[l] - s_adm[l], lane, j,
                      gained);
      if (lane == 0) {
        s_adm[l] += gained;
        s_thr[l] = th + (j << shift);
      }
    }
    __syncthreads();
  }
  if (blockIdx.x == 0) {
    for (int l = tid; l < L; l += kThreads) acc2(a)[l].y = s_thr[l];
  }
}

// ---------------------------------------------------------------------------
// 3. Accept pass, the second pass over the nodes.

template <bool kFew>
__global__ void __launch_bounds__(kThreads) accept_kernel(Args a) {
  extern __shared__ int s_w[];  // L entries when kFew
  if (kFew) {
    for (int l = threadIdx.x; l < a.L; l += kThreads) s_w[l] = 0;
    __syncthreads();
  }
  const int* thr = reinterpret_cast<const int*>(a.acc) + 1;  // y of label l at 2 * l
  int local = 0;
  for (long long base = (long long)blockIdx.x * kTile; base < a.n;
       base += (long long)gridDim.x * kTile) {
    // The tile's loads first, then the threshold gathers of its movers,
    // then the stores.
    int t[kTileItems], pr[kTileItems], lab[kTileItems], w[kTileItems], th[kTileItems];
#pragma unroll
    for (int k = 0; k < kTileItems; ++k) {
      const long long i = base + k * kThreads + threadIdx.x;
      const bool in = i < a.n;
      t[k] = in ? a.t_idx[i] : -1;
      pr[k] = in ? a.prio[i] : 0;
      lab[k] = in ? a.labels[i] : 0;
      w[k] = in ? a.node_w[i] : 0;
    }
#pragma unroll
    for (int k = 0; k < kTileItems; ++k) th[k] = t[k] >= 0 ? thr[2 * (long long)t[k]] : 0;
#pragma unroll
    for (int k = 0; k < kTileItems; ++k) {
      const long long i = base + k * kThreads + threadIdx.x;
      if (i >= a.n) continue;
      const bool commit = t[k] >= 0 && pr[k] < th[k];
      const int out = commit ? t[k] : lab[k];
      a.new_labels[i] = out;
      if (w[k] != 0) atomicAdd(kFew ? &s_w[out] : &a.new_weights[out], w[k]);
      local += commit ? 1 : 0;
    }
  }
  local = (int)segment_sum<32>((unsigned)local);
  if ((threadIdx.x & 31) == 0 && local != 0) atomicAdd(a.moved_count, local);
  if (kFew) {
    __syncthreads();
    for (int l = threadIdx.x; l < a.L; l += kThreads) {
      const int v = s_w[l];
      if (v != 0) atomicAdd(&a.new_weights[l], v);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side.

struct Layout {
  size_t ctr, acc, ghist, zero_end, t_idx, list_t, list_p, list_w, seg_p, seg_w, tile_sums,
      seg_l, seg_o, seg_c, total;
};

inline size_t align_up(size_t b) { return (b + 255) & ~(size_t)255; }

inline int tiles_of(int L) { return (int)(((long long)L + kTile - 1) / kTile); }

// Byte offsets of the scratch arrays; [0, zero_end) is zeroed per call.
Layout layout_of(int n, int L) {
  const bool few = L <= kFewLabels;
  const size_t N = (size_t)n, NL = (size_t)L;
  const size_t kmax = (size_t)(n < L ? n : L);
  Layout o;
  size_t at = 0;
  auto take = [&at](size_t bytes) {
    size_t here = at;
    at = align_up(at + bytes);
    return here;
  };
  o.ctr = take(4 * sizeof(int));
  o.acc = take(NL * sizeof(unsigned long long));
  o.ghist = take(few ? (size_t)kRadixLevels * NL * kRadix * sizeof(int) : 0);
  o.zero_end = at;
  o.t_idx = take(N * sizeof(int));
  o.list_t = take(N * sizeof(int));
  o.list_p = take(N * sizeof(int));
  o.list_w = take(N * sizeof(int));
  o.seg_p = take(few ? 0 : N * sizeof(int));
  o.seg_w = take(few ? 0 : N * sizeof(int));
  o.tile_sums = take(few ? 0 : (size_t)tiles_of(L) * sizeof(int));
  o.seg_l = take(few ? 0 : kmax * sizeof(int));
  o.seg_o = take(few ? 0 : kmax * sizeof(int));
  o.seg_c = take(few ? 0 : kmax * sizeof(int));
  o.total = at;
  return o;
}

inline int grid_for(long long items, int sms) {
  long long b = (items + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * kBlocksPerSM;
  if (b > cap) b = cap;
  return b < 1 ? 1 : (int)b;
}

}  // namespace

// Bytes of scratch one commit of n nodes over L labels needs (O(n + L)).
extern "C" long long kp_commit_scratch_bytes(int n, int L) {
  return (long long)layout_of(n, L).total;
}

// One LP commit.  `scratch` holds kp_commit_scratch_bytes(n, L) bytes,
// 256-byte aligned.  Outputs: new_labels (n), new_weights (L), moved_count
// (1).  Returns the first failing call's cudaError_t, else 0.
extern "C" int kp_commit_moves(
    int n, int L, const int* labels, const int* node_w, const int* label_w,
    const int* maxw, int maxw_scalar, const int* target, const int* tconn,
    const int* own_conn, const int* prio, const unsigned char* coin,
    const unsigned char* act, const unsigned char* color, int allow_tie,
    int use_act, int use_color, void* scratch, int* new_labels, int* new_weights,
    int* moved_count, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaError_t err;
#define KP_TRY(call)                         \
  do {                                       \
    err = (call);                            \
    if (err != cudaSuccess) return (int)err; \
  } while (0)
  if (n < 0 || L < 0 || (n > 0 && L == 0)) return (int)cudaErrorInvalidValue;
  if (n == 0) {
    KP_TRY(cudaMemsetAsync(new_weights, 0, (size_t)L * sizeof(int), stream));
    KP_TRY(cudaMemsetAsync(moved_count, 0, sizeof(int), stream));
    return 0;
  }
  const bool few = L <= kFewLabels;
  const Layout o = layout_of(n, L);
  char* s = (char*)scratch;
  Args a{n, L, labels, node_w, label_w, maxw, maxw_scalar, target, tconn, own_conn, prio,
         coin, act, color, allow_tie, use_act, use_color,
         (int*)(s + o.ctr), (unsigned long long*)(s + o.acc), (int*)(s + o.ghist),
         (int*)(s + o.t_idx), (int*)(s + o.list_t), (int*)(s + o.list_p),
         (int*)(s + o.list_w), (int*)(s + o.seg_p), (int*)(s + o.seg_w),
         (int*)(s + o.tile_sums), (int*)(s + o.seg_l), (int*)(s + o.seg_o),
         (int*)(s + o.seg_c), n < L ? n : L, new_labels, new_weights, moved_count};
  int dev = 0, sms = 0;
  KP_TRY(cudaGetDevice(&dev));
  KP_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));

  KP_TRY(cudaMemsetAsync(scratch, 0, o.zero_end, stream));
  const int gt = grid_for((n + kTileItems - 1) / kTileItems, sms);  // node tiles
  if (few) {
    movers_kernel<true><<<gt, kThreads, L * sizeof(unsigned long long), stream>>>(a);
    KP_TRY(cudaGetLastError());
    const size_t smem = ((size_t)L * kRadix + 3 * (size_t)L) * sizeof(int);
    int per_sm = 0;
    KP_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, auction_few_kernel,
                                                         kThreads, smem));
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    const int blocks = sms * (per_sm < 2 ? per_sm : 2);
    void* params[] = {&a};
    KP_TRY(cudaLaunchCooperativeKernel((const void*)auction_few_kernel, dim3(blocks),
                                       dim3(kThreads), params, smem, stream));
    accept_kernel<true><<<gt, kThreads, L * sizeof(int), stream>>>(a);
    KP_TRY(cudaGetLastError());
  } else {
    movers_kernel<false><<<gt, kThreads, 0, stream>>>(a);
    KP_TRY(cudaGetLastError());
    const int T = tiles_of(L);
    contest_kernel<<<T, kThreads, 0, stream>>>(a);
    KP_TRY(cudaGetLastError());
    scan_tiles_kernel<<<1, kScanThreads, 0, stream>>>(T, a.tile_sums);
    KP_TRY(cudaGetLastError());
    offsets_kernel<<<T, kThreads, 0, stream>>>(a);
    KP_TRY(cudaGetLastError());
    scatter_kernel<<<gt, kThreads, 0, stream>>>(a);
    KP_TRY(cudaGetLastError());
    resolve_kernel<<<grid_for((long long)a.kmax * 32, sms), kThreads, 0, stream>>>(a);
    KP_TRY(cudaGetLastError());
    accept_kernel<false><<<gt, kThreads, 0, stream>>>(a);
    KP_TRY(cudaGetLastError());
  }
#undef KP_TRY
  return 0;
}
