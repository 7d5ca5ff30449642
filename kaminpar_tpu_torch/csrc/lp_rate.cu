// LP rating kernels: best move of every row of one (R, w) degree bucket.
//
// One rating body, two row loaders:
// - DenseRows (`kp_rate_bucket`) replaces the TPU kernel `_rate_bucket`
//   (kaminpar_tpu/ops/pallas_lp.py:245): the bucket's cols and wgts are
//   (R, w) matrices in device memory;
// - CompressedRows (`kp_rate_compressed_bucket`) replaces the TPU kernel
//   `_rate_compressed_bucket` (kaminpar_tpu/ops/pallas_lp.py:370, body
//   `_make_compressed_rate_kernel` :341): each row is decoded in the kernel
//   from the packed gap stream (graph/device_compressed.decode_rows), so
//   the (R, w) neighbour matrix never exists in device memory.
//
// Both compute exactly what `ops/bucketed_gains._bucket_moves` computes on
// the (decoded) bucket:
//   own = labels[node]; L[j] = labels[cols[j]]; own_conn = sum W[j] over
//   L[j] == own (wrapping int32); stable sort of the row by label; c = the
//   wrapping int32 cumsum of the sorted weights; base = c - W at run
//   starts, 0 elsewhere; rating = c - cummax(base) (signed) at run ends;
//   candidate = run end with rating > 0 (and not the own label when
//   external_only) whose label fits the cap (lw[L] + node_w <= maxw[L] or
//   the scalar maxw, the own label always fits unless external_only);
//   winner = max rating, then (when `lightest`) the lightest label, then
//   the largest tie[r, j] read at the SORTED position j, then the first
//   position.  Labels lie in [0, L) and ties are >= 0.
//
// What bounds them on the H100.  The function needs a dense slot's cols,
// wgts and tie (12 bytes, coalesced) and a compressed slot's wd/8 bytes
// of the word stream (wd <= 32) plus 4 of edge_w when weighted, and one
// random 4-byte label gather per slot: a few hundred microseconds per
// pass at 3.35 TB/s.  The sort is the only part that is more than linear,
// and the earlier design paid it as a full bitonic network of 64-bit
// keys in shared memory, log2(w)(log2(w)+1)/2 stages with a block-wide
// barrier each, over every row, pad rows too, with block barriers even
// for 8-wide rows: 15-25x the byte bound.
//
// Design:
// - Rows whose answer is fixed cost no slot loads: dense pad rows (row >=
//   real_rows, a host count) and compressed rows of degree 0 give
//   (labels[node], 0, 0, 0), which is what rating them gives.  Pad slots
//   of a compressed row (j >= deg) are not decoded: their label is the
//   own label and their weight 0, and they still take their place in the
//   sort.
// - w <= 64, warp path: one warp rates one row (w/32 slots per lane,
//   striped: slot j at lane j % 32, item j / 32), or 32/w rows of width 8
//   or 16 in segments of w lanes.  There is no shared memory and no block
//   barrier.  The row is sorted by a bitonic network on (label, slot)
//   keys in registers: partners 32 or more apart are items of the same
//   lane, nearer ones a __shfl_xor_sync away.  The key is 32 bits when
//   ceil(log2 L) + log2 w <= 32 and 64 bits beyond; the slot in the low
//   bits makes keys unique, so the network gives the stable order.  The
//   weight rides along.  The compressed loader decodes each lane's gaps
//   and turns them into column ids with a segmented shuffle scan.
// - w >= 128, block path: one block per row, w/T slots per thread in a
//   blocked arrangement (T = w/4 threads, at most 512; vector loads of
//   cols and wgts), sorted by CUB's
//   BlockRadixSort (a stable LSD radix sort, a building block inside this
//   kernel) on the label's ceil(log2 L) bits alone, the weight as value:
//   2 passes in refinement (L = 64), 5-6 in clustering (L = n_pad), each
//   a few barriers, against 28-78 bitonic stages.  The compressed loader's
//   cumsum is a BlockScan.  (Rows of 128 and 256 slots ran 1.1x and 2.9x
//   slower on the warp path, whose 4-8 slots per lane need 60-90
//   registers: PERF.md.)
// - Runs: one inclusive scan of the sorted weights (wrapping) and one of
//   the run bases (signed max), by shuffles within a warp and one
//   BlockScan each on the block path.
// - One selection: every candidate run end becomes a (rating, label
//   weight, tie, position) tuple, reduced lexicographically by shuffles
//   (and through shared memory across the warps of a block).  `tie` is
//   read at candidate run ends only.
// - Streaming loads (__ldcs) for cols, wgts, tie, the words and edge_w,
//   so that they do not push the label table out of the 50 MB L2, where
//   the random labels[col] gathers find it.
// Every sum wraps modulo 2^32 as the plain int32 sums do, and nothing
// depends on the order of atomics, so the result is deterministic and
// equals the plain version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>

#include "warp_sort.cuh"

namespace {

constexpr int kWarpBlock = 256;  // threads per block on the warp path
// Widest rows of the warp path.  The wrapper reads it through
// kp_rate_warp_max_width(), since it picks 64-bit keys for that path.
constexpr int kWarpMaxWidth = 64;

// Inputs and outputs of one launch, shared by both paths and loaders.
struct Args {
  const int* labels;
  const int* node_w;
  const int* label_w;
  const int* maxw;
  int maxw_scalar;
  const int* nodes;
  const int* tie;
  int R;
  int label_bits;
  int external_only;
  int respect_caps;
  int lightest;
  int* target;
  int* tconn;
  int* own_conn;
  unsigned char* has;
};

// A candidate run end; rating -1 stands for none.
struct Cand {
  int rating;
  int lw;
  int tie;
  int pos;
  int label;
};

__device__ __forceinline__ Cand no_cand() { return Cand{-1, 0, -1, 0x7fffffff, 0}; }

// The order of the selection: rating, then the lighter label when
// `lightest`, then the larger tie, then the smaller sorted position.
__device__ __forceinline__ bool better(const Cand& a, const Cand& b, int lightest) {
  if (a.rating != b.rating) return a.rating > b.rating;
  if (lightest && a.lw != b.lw) return a.lw < b.lw;
  if (a.tie != b.tie) return a.tie > b.tie;
  return a.pos < b.pos;
}

__device__ __forceinline__ Cand shfl_xor_cand(const Cand& c, int d) {
  return Cand{__shfl_xor_sync(kFull, c.rating, d), __shfl_xor_sync(kFull, c.lw, d),
              __shfl_xor_sync(kFull, c.tie, d), __shfl_xor_sync(kFull, c.pos, d),
              __shfl_xor_sync(kFull, c.label, d)};
}

// Best candidate over aligned segments of SW lanes (all lanes end with it).
template <int SW>
__device__ __forceinline__ Cand segment_best(Cand c, int lightest) {
#pragma unroll
  for (int d = SW >> 1; d > 0; d >>= 1) {
    Cand o = shfl_xor_cand(c, d);
    if (better(o, c, lightest)) c = o;
  }
  return c;
}

// Inclusive max scan within aligned segments of SW lanes.
template <int SW>
__device__ __forceinline__ int segment_scan_max(int v, int sl) {
#pragma unroll
  for (int d = 1; d < SW; d <<= 1) {
    int o = __shfl_up_sync(kFull, v, d, SW);
    if (sl >= d) v = max(v, o);
  }
  return v;
}

// Whether a run end at `lab` with `rating` is a candidate; sets its label
// weight when it is.
__device__ __forceinline__ bool is_candidate(const Args& a, int lab, int rating, int own,
                                             int nw, int& lw) {
  bool is_cur = lab == own;
  bool ok = rating > 0;
  if (a.external_only) ok = ok && !is_cur;
  lw = 0;
  if (ok && (a.respect_caps || a.lightest)) lw = a.label_w[lab];
  if (ok && a.respect_caps) {
    int cap = a.maxw_scalar ? a.maxw[0] : a.maxw[lab];
    bool fits = (int)((unsigned)lw + (unsigned)nw) <= cap;
    ok = a.external_only ? fits : (is_cur || fits);
  }
  return ok;
}

__device__ __forceinline__ void write_row(const Args& a, long long row, int own,
                                          unsigned own_conn, const Cand& best) {
  bool h = best.rating >= 0;
  a.target[row] = h ? best.label : own;
  a.tconn[row] = h ? best.rating : 0;
  a.own_conn[row] = (int)own_conn;
  a.has[row] = h ? 1 : 0;
}

__device__ __forceinline__ int zigzag_gap(const unsigned* words, int nwords, int wstart,
                                          int wd, int j) {
  // Words s0, s0 + 1 (s0 clipped to [0, nwords - 2]), a funnel shift by
  // bit & 31 (lo alone when the shift is 0), a mask of wd bits (all 32
  // when wd = 32), zig-zag.
  int bit = j * wd;
  int s0 = min(max(wstart + (bit >> 5), 0), nwords - 2);
  unsigned z = __funnelshift_r(__ldcs(words + s0), __ldcs(words + s0 + 1), bit & 31) &
               (0xffffffffu >> (32 - wd));
  return (int)(z >> 1) ^ -(int)(z & 1u);
}

// ---------------------------------------------------------------------------
// Row loaders.  `fixed` says whether a row's answer is (own, 0, 0, 0)
// without loading its slots; `warp_load`/`block_load` give each slot's
// label (the own label where `valid` is false: a pad slot) and weight.

struct DenseRows {
  const int* cols;
  const int* wgts;
  int real_rows;

  struct Meta {};
  __device__ Meta meta(long long) const { return {}; }
  __device__ bool fixed(const Meta&, long long row) const { return row >= real_rows; }

  // Slots j = i * 32 + lane (w >= 32) or j = sl (w < 32) of `row`.
  template <int W, int ITEMS, int SW>
  __device__ void warp_load(const Meta&, bool fixed_row, long long row, int node, int own,
                            int sl, const int* labels, int (&lab)[ITEMS],
                            int (&wt)[ITEMS]) const {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      lab[i] = own;
      wt[i] = 0;
      if (!fixed_row) {
        long long g = row * W + i * 32 + sl;
        lab[i] = labels[__ldcs(cols + g)];
        wt[i] = __ldcs(wgts + g);
      }
    }
  }

  // Slots j = t * ITEMS + i of `row`, ITEMS a multiple of 4.
  template <int W, int T, int ITEMS, class ScanU>
  __device__ void block_load(const Meta&, long long row, int node, int own,
                             const int* labels, typename ScanU::TempStorage&,
                             int (&lab)[ITEMS], int (&wt)[ITEMS]) const {
    const long long g = row * W + threadIdx.x * ITEMS;
#pragma unroll
    for (int v = 0; v < ITEMS / 4; ++v) {
      int4 c = __ldcs(reinterpret_cast<const int4*>(cols + g) + v);
      int4 x = __ldcs(reinterpret_cast<const int4*>(wgts + g) + v);
      lab[4 * v] = labels[c.x];
      lab[4 * v + 1] = labels[c.y];
      lab[4 * v + 2] = labels[c.z];
      lab[4 * v + 3] = labels[c.w];
      wt[4 * v] = x.x;
      wt[4 * v + 1] = x.y;
      wt[4 * v + 2] = x.z;
      wt[4 * v + 3] = x.w;
    }
  }
};

struct CompressedRows {
  const unsigned* words;
  int nwords;
  const int* edge_w;
  int n_edge_w;
  int weighted;
  const int* wstart;
  const int* width;
  const int* deg;
  const int* estart;

  struct Meta {
    int ws, wd, dg, es;
  };
  __device__ Meta meta(long long row) const {
    return Meta{wstart[row], width[row], deg[row], estart[row]};
  }
  __device__ bool fixed(const Meta& m, long long) const { return m.dg == 0; }

  __device__ __forceinline__ int weight(const Meta& m, int j) const {
    return weighted ? __ldcs(edge_w + min(m.es + j, n_edge_w - 1)) : 1;
  }

  // The gaps of the lane's slots, turned into column ids by a segmented
  // shuffle scan in slot order (the first gap is relative to the node id;
  // sums wrap modulo 2^32 like the plain int32 cumsum).
  template <int W, int ITEMS, int SW>
  __device__ void warp_load(const Meta& m, bool, long long, int node, int own, int sl,
                            const int* labels, int (&lab)[ITEMS],
                            int (&wt)[ITEMS]) const {
    unsigned carry = 0;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int j = i * 32 + sl;
      const bool valid = j < m.dg;
      unsigned v = 0;
      if (valid) {
        v = (unsigned)zigzag_gap(words, nwords, m.ws, m.wd, j) + (j == 0 ? (unsigned)node : 0u);
      }
      unsigned col = segment_scan_sum<SW>(v, sl) + carry;
      if (ITEMS > 1) carry = __shfl_sync(kFull, col, 31);
      lab[i] = valid ? labels[(int)col] : own;
      wt[i] = valid ? weight(m, j) : 0;
    }
  }

  template <int W, int T, int ITEMS, class ScanU>
  __device__ void block_load(const Meta& m, long long, int node, int own, const int* labels,
                             typename ScanU::TempStorage& scan, int (&lab)[ITEMS],
                             int (&wt)[ITEMS]) const {
    const int j0 = threadIdx.x * ITEMS;
    unsigned incl[ITEMS];
    unsigned sum = 0;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int j = j0 + i;
      if (j < m.dg) sum += (unsigned)zigzag_gap(words, nwords, m.ws, m.wd, j) +
                           (j == 0 ? (unsigned)node : 0u);
      incl[i] = sum;
    }
    unsigned before;
    ScanU(scan).ExclusiveSum(sum, before);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int j = j0 + i;
      const bool valid = j < m.dg;
      lab[i] = valid ? labels[(int)(before + incl[i])] : own;
      wt[i] = valid ? weight(m, j) : 0;
    }
  }
};

// ---------------------------------------------------------------------------
// Warp path: rows of width W <= kWarpMaxWidth.

template <class Rows, class Key, int W>
__global__ void __launch_bounds__(kWarpBlock) rate_warp_kernel(Rows rows, Args a) {
  static_assert(W <= kWarpMaxWidth, "the warp path's widths");
  constexpr int SW = W < 32 ? W : 32;        // lanes per row
  constexpr int ITEMS = W < 32 ? 1 : W / 32;  // slots per lane
  constexpr int LOG2W = W == 8 ? 3 : W == 16 ? 4 : W == 32 ? 5 : 6;
  const int lane = threadIdx.x & 31;
  const int sl = lane & (SW - 1);
  const long long warp = (long long)blockIdx.x * (kWarpBlock / 32) + (threadIdx.x >> 5);
  const long long row = warp * (32 / SW) + lane / SW;
  if (warp * (32 / SW) >= a.R) return;  // warp-uniform: R is a multiple of 32 / SW

  const int node = a.nodes[row];
  const int own = a.labels[node];
  const typename Rows::Meta m = rows.meta(row);
  const bool fixed_row = rows.fixed(m, row);
  if (__all_sync(kFull, fixed_row)) {
    if (sl == 0) write_row(a, row, own, 0u, no_cand());
    return;
  }
  const int nw = a.node_w[node];

  int lab[ITEMS], wt[ITEMS];
  rows.template warp_load<W, ITEMS, SW>(m, fixed_row, row, node, own, sl, a.labels, lab, wt);

  unsigned oc = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) oc += lab[i] == own ? (unsigned)wt[i] : 0u;
  oc = segment_sum<SW>(oc);

  Key key[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    key[i] = ((Key)(unsigned)lab[i] << LOG2W) | (Key)(i * 32 + sl);
  }
  warp_bitonic<Key, W, ITEMS>(key, wt, sl);
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) lab[i] = (int)(key[i] >> LOG2W);

  // Run starts and ends from the neighbouring sorted positions.
  bool start[ITEMS], end[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    int prev = __shfl_up_sync(kFull, lab[i], 1, SW);
    int next = __shfl_down_sync(kFull, lab[i], 1, SW);
    if (ITEMS > 1) {
      int prev_item = __shfl_sync(kFull, lab[i > 0 ? i - 1 : 0], 31);
      int next_item = __shfl_sync(kFull, lab[i + 1 < ITEMS ? i + 1 : i], 0);
      if (sl == 0) prev = prev_item;
      if (sl == SW - 1) next = next_item;
    }
    const int e = i * 32 + sl;
    start[i] = e == 0 || prev != lab[i];
    end[i] = e == W - 1 || next != lab[i];
  }

  // c = inclusive cumsum of the sorted weights; base = c - W at run
  // starts; rating = c - cummax(base).
  unsigned c[ITEMS];
  unsigned carry = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    c[i] = segment_scan_sum<SW>((unsigned)wt[i], sl) + carry;
    if (ITEMS > 1) carry = __shfl_sync(kFull, c[i], 31);
  }
  Cand best = no_cand();
  int mcarry = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    int base = start[i] ? (int)(c[i] - (unsigned)wt[i]) : 0;
    int run_base = max(segment_scan_max<SW>(base, sl), mcarry);
    if (ITEMS > 1) mcarry = __shfl_sync(kFull, run_base, 31);
    const int rating = (int)(c[i] - (unsigned)run_base);
    int lw;
    if (end[i] && is_candidate(a, lab[i], rating, own, nw, lw)) {
      const int e = i * 32 + sl;
      Cand cand{rating, lw, __ldcs(a.tie + row * W + e), e, lab[i]};
      if (better(cand, best, a.lightest)) best = cand;
    }
  }
  best = segment_best<SW>(best, a.lightest);
  if (sl == 0) write_row(a, row, own, oc, best);
}

// ---------------------------------------------------------------------------
// Block path: wider rows, one block of T threads per row.

struct MaxOp {
  __device__ __forceinline__ int operator()(int x, int y) const { return max(x, y); }
};

template <class Rows, int W, int T>
__global__ void __launch_bounds__(T) rate_block_kernel(Rows rows, Args a) {
  constexpr int ITEMS = W / T;
  typedef cub::BlockRadixSort<unsigned, T, ITEMS, int> Sort;
  typedef cub::BlockScan<unsigned, T> ScanU;
  typedef cub::BlockScan<int, T> ScanI;
  __shared__ union {
    typename Sort::TempStorage sort;
    typename ScanU::TempStorage scan_u;
    typename ScanI::TempStorage scan_i;
  } tmp;
  __shared__ unsigned s_first[T], s_last[T];
  __shared__ Cand s_best[T / 32];
  __shared__ unsigned s_oc;

  const long long row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const int node = a.nodes[row];
  const int own = a.labels[node];
  const typename Rows::Meta m = rows.meta(row);
  if (rows.fixed(m, row)) {  // block-uniform
    if (tid == 0) write_row(a, row, own, 0u, no_cand());
    return;
  }
  const int nw = a.node_w[node];
  if (tid == 0) s_oc = 0;

  int lab[ITEMS], wt[ITEMS];
  rows.template block_load<W, T, ITEMS, ScanU>(m, row, node, own, a.labels, tmp.scan_u, lab,
                                               wt);
  unsigned oc = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) oc += lab[i] == own ? (unsigned)wt[i] : 0u;
  oc = segment_sum<32>(oc);
  __syncthreads();  // s_oc is set; the loader's scan storage is free
  if (lane == 0) atomicAdd(&s_oc, oc);

  unsigned key[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) key[i] = (unsigned)lab[i];
  Sort(tmp.sort).Sort(key, wt, 0, a.label_bits);
  s_first[tid] = key[0];
  s_last[tid] = key[ITEMS - 1];
  unsigned incl[ITEMS];
  unsigned sum = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    sum += (unsigned)wt[i];
    incl[i] = sum;
  }
  __syncthreads();  // s_first/s_last are written; the sort's storage is free
  unsigned before;
  ScanU(tmp.scan_u).ExclusiveSum(sum, before);
  const unsigned prev0 = tid > 0 ? s_last[tid - 1] : 0u;
  const unsigned next_last = tid + 1 < T ? s_first[tid + 1] : 0u;

  int base[ITEMS];
  int local_max = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int e = tid * ITEMS + i;
    const unsigned prev = i > 0 ? key[i - 1] : prev0;
    const bool start = e == 0 || prev != key[i];
    base[i] = start ? (int)(before + incl[i] - (unsigned)wt[i]) : 0;
    local_max = max(local_max, base[i]);
    base[i] = local_max;  // the thread's own inclusive running maximum
  }
  __syncthreads();  // the sum scan's storage is free
  int max_before;
  ScanI(tmp.scan_i).ExclusiveScan(local_max, max_before, 0, MaxOp());

  Cand best = no_cand();
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int e = tid * ITEMS + i;
    const unsigned next = i + 1 < ITEMS ? key[i + 1] : next_last;
    if (e != W - 1 && next == key[i]) continue;
    const int run_base = max(max_before, base[i]);
    const int rating = (int)(before + incl[i] - (unsigned)run_base);
    const int l = (int)key[i];
    int lw;
    if (is_candidate(a, l, rating, own, nw, lw)) {
      Cand cand{rating, lw, __ldcs(a.tie + row * W + e), e, l};
      if (better(cand, best, a.lightest)) best = cand;
    }
  }
  best = segment_best<32>(best, a.lightest);
  if (lane == 0) s_best[tid >> 5] = best;
  __syncthreads();
  if (tid < 32) {
    best = lane < T / 32 ? s_best[lane] : no_cand();
    best = segment_best<32>(best, a.lightest);
    if (lane == 0) write_row(a, row, own, s_oc, best);
  }
}

// ---------------------------------------------------------------------------
// Launch: R and w are powers of two with 8 <= w <= 4096 and R >= 8.
// `key64` picks 64-bit sort keys on the warp path (the host sets it when
// label_bits + log2 w > 32).

template <class Rows, class Key, int W>
cudaError_t launch_warp(const Rows& rows, const Args& a, cudaStream_t stream) {
  constexpr int rows_per_block = (kWarpBlock / 32) * (W < 32 ? 32 / W : 1);
  const int blocks = (a.R + rows_per_block - 1) / rows_per_block;
  rate_warp_kernel<Rows, Key, W><<<blocks, kWarpBlock, 0, stream>>>(rows, a);
  return cudaGetLastError();
}

template <class Rows, int W, int T>
cudaError_t launch_block(const Rows& rows, const Args& a, cudaStream_t stream) {
  rate_block_kernel<Rows, W, T><<<a.R, T, 0, stream>>>(rows, a);
  return cudaGetLastError();
}

template <class Rows, class Key>
cudaError_t launch_warp_w(const Rows& rows, const Args& a, int w, cudaStream_t s) {
  switch (w) {
    case 8: return launch_warp<Rows, Key, 8>(rows, a, s);
    case 16: return launch_warp<Rows, Key, 16>(rows, a, s);
    case 32: return launch_warp<Rows, Key, 32>(rows, a, s);
    case 64: return launch_warp<Rows, Key, 64>(rows, a, s);
  }
  return cudaErrorInvalidValue;
}

template <class Rows>
int launch_rate(const Rows& rows, const Args& a, int w, int key64, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (w <= kWarpMaxWidth) {
    return (int)(key64 ? launch_warp_w<Rows, unsigned long long>(rows, a, w, s)
                       : launch_warp_w<Rows, unsigned>(rows, a, w, s));
  }
  switch (w) {
    case 128: return (int)launch_block<Rows, 128, 32>(rows, a, s);
    case 256: return (int)launch_block<Rows, 256, 64>(rows, a, s);
    case 512: return (int)launch_block<Rows, 512, 128>(rows, a, s);
    case 1024: return (int)launch_block<Rows, 1024, 256>(rows, a, s);
    case 2048: return (int)launch_block<Rows, 2048, 512>(rows, a, s);
    case 4096: return (int)launch_block<Rows, 4096, 512>(rows, a, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The widest rows of the warp path (the wrapper's WARP_MAX_WIDTH).
extern "C" int kp_rate_warp_max_width() { return kWarpMaxWidth; }

// Rates every row of one dense (R, w) bucket; rows >= real_rows are pad
// rows.  Returns the launch's cudaError_t.
extern "C" int kp_rate_bucket(
    const int* labels, const int* node_w, const int* label_w, const int* maxw,
    int maxw_scalar, const int* nodes, const int* cols, const int* wgts,
    const int* tie, int R, int w, int real_rows, int label_bits, int key64,
    int external_only, int respect_caps, int lightest, int* target, int* tconn,
    int* own_conn, unsigned char* has, void* stream) {
  Args a{labels, node_w, label_w, maxw, maxw_scalar, nodes, tie, R, label_bits,
         external_only, respect_caps, lightest, target, tconn, own_conn, has};
  return launch_rate(DenseRows{cols, wgts, real_rows}, a, w, key64, stream);
}

// Rates every row of one compressed bucket, decoding its (R, w) neighbour
// slots from the word stream inside the kernel.  `edge_w` has `n_edge_w`
// entries and is read only when `weighted`.
extern "C" int kp_rate_compressed_bucket(
    const int* labels, const int* node_w, const int* label_w, const int* maxw,
    int maxw_scalar, const unsigned* words, int nwords, const int* edge_w,
    int n_edge_w, int weighted, const int* nodes, const int* wstart,
    const int* width, const int* deg, const int* estart, const int* tie, int R,
    int w, int label_bits, int key64, int external_only, int respect_caps,
    int lightest, int* target, int* tconn, int* own_conn, unsigned char* has,
    void* stream) {
  Args a{labels, node_w, label_w, maxw, maxw_scalar, nodes, tie, R, label_bits,
         external_only, respect_caps, lightest, target, tconn, own_conn, has};
  CompressedRows rows{words, nwords, edge_w, n_edge_w, weighted, wstart, width, deg, estart};
  return launch_rate(rows, a, w, key64, stream);
}
