// LP rating kernels: best move of every row of one (R, w) degree bucket.
//
// One kernel body, two row loaders:
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
//   L[j] == own; stable sort of the row by label; rating of a run of equal
//   labels = its weight sum; candidate = run end with rating > 0 (and not
//   the own label when external_only) whose label fits the cap
//   (lw[L] + node_w <= maxw[L] or the scalar maxw, the own label always
//   fits unless external_only); best = max rating; ties: the lightest label
//   first when `lightest`, then the largest tie[r, j] read at the SORTED
//   position j, first position on equal ties.
//
// What bounds them on the H100: memory.  A dense slot reads cols, wgts and
// tie (12 bytes, coalesced) and gathers labels[col] (4 bytes, random).  A
// compressed slot reads wd/8 bytes of the word stream (wd = the row's gap
// width, at most 32), 4 bytes of tie and the 4-byte label gather, plus 4
// bytes of edge_w when the graph is weighted: against 16 bytes per slot on
// the dense path.  Both add one label-weight gather per run end; the
// decode, sort and reductions run in registers and shared memory and cost
// a few integer operations per slot and stage.
//
// Design (simple first): one block holds whole rows (256 / w rows per
// block for w <= 256, one row per block above).  The compressed loader has
// each thread decode its own slots: two neighbouring words (neighbouring
// slots read neighbouring words, so the loads are nearly coalesced), a
// funnel shift, a mask of wd bits and the zig-zag decode; the gaps become
// column ids through the same block scan the rating uses (a row cumsum,
// the first gap relative to the node id), and the ids stay in shared
// memory.  Each slot's (label, slot) pair is then packed into one 64-bit
// key; the keys are unique, so a bitonic network in shared memory gives
// the stable order.  Runs are reduced with one block scan over the sorted
// slots (warp shuffles, then the warp totals): an inclusive prefix sum of
// the weights and a running maximum of the run-start positions, so a run's
// rating is the prefix at its end minus the prefix before its start (the
// cumsum + cummax of the TPU kernel).  The per-row max/min selections are
// shared-memory atomicMax/atomicMin.  Integer atomics are order-free and
// the scans wrap modulo 2^32 like the plain int32 sums, so the result is
// deterministic and equals the plain version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kSmallRowThreads = 256;
constexpr int kMaxItems = 4;  // slots per thread: 4096 / kMaxThreads at most
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int key_label(unsigned long long k) {
  return (int)(k >> 32);
}

// Inclusive warp scan of (sum, max) pairs.
__device__ __forceinline__ void warp_scan(unsigned& sum, int& mx, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    unsigned os = __shfl_up_sync(kFull, sum, d);
    int om = __shfl_up_sync(kFull, mx, d);
    if (lane >= d) {
      sum += os;
      mx = max(mx, om);
    }
  }
}

// One chunk (blockDim.x slots) of an inclusive block scan of (sum, max)
// pairs, carried across chunks by (carry_sum, carry_max).  Every thread of
// the block calls it; `w_sum`/`w_max` are 32 words of shared memory each.
__device__ __forceinline__ void block_scan_chunk(unsigned& sum, int& mx,
                                                 unsigned& carry_sum,
                                                 int& carry_max, unsigned* w_sum,
                                                 int* w_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  warp_scan(sum, mx, lane);
  if (lane == 31) {
    w_sum[warp] = sum;
    w_max[warp] = mx;
  }
  __syncthreads();
  if (warp == 0) {
    unsigned ws = lane < nwarps ? w_sum[lane] : 0u;
    int wm = lane < nwarps ? w_max[lane] : 0;
    warp_scan(ws, wm, lane);
    if (lane < nwarps) {
      w_sum[lane] = ws;
      w_max[lane] = wm;
    }
  }
  __syncthreads();
  if (warp > 0) {
    sum += w_sum[warp - 1];
    mx = max(mx, w_max[warp - 1]);
  }
  sum += carry_sum;
  mx = max(mx, carry_max);
  carry_sum += w_sum[nwarps - 1];
  carry_max = max(carry_max, w_max[nwarps - 1]);
  __syncthreads();  // the warp totals are rewritten by the next chunk
}

// Shared memory the kernel body hands a row loader: per-slot scratch that
// is free until the label gather, the scan's warp totals, and the loader's
// own per-row words.
struct LoaderSmem {
  unsigned* slot_u;  // N words
  int* slot_i;       // N words (the gather overwrites them with weights)
  unsigned* w_sum;
  int* w_max;
  int* rows;  // kRowInts * rows_per_block words
  int rows_per_block;
};

// Dense bucket: the (R, w) cols and wgts matrices in device memory.
struct DenseRows {
  static constexpr int kRowInts = 0;
  const int* cols;
  const int* wgts;

  __device__ void prepare(const LoaderSmem&, const int*, long long, int,
                          int) const {}

  __device__ __forceinline__ void slot(const LoaderSmem&, int, int r, int j,
                                       long long row0, int w, int& col,
                                       int& wt) const {
    long long g = (row0 + r) * (long long)w + j;
    col = cols[g];
    wt = wgts[g];
  }
};

// Compressed bucket: per-row (word start, width, degree, edge start) and
// the packed gap stream.  `prepare` decodes every slot of the block's rows
// into shared memory; `slot` reads a decoded slot back (pad slots are the
// row's own node with weight 0, as in the dense layout).
struct CompressedRows {
  // per row: node, wstart, width, deg, estart, and the scan prefix before
  // the row's first slot
  static constexpr int kRowInts = 6;
  const unsigned* words;
  int nwords;
  const int* edge_w;
  int n_edge_w;
  int weighted;
  const int* wstart;
  const int* width;
  const int* deg;
  const int* estart;

  __device__ void prepare(const LoaderSmem& sm, const int* nodes, long long row0,
                          int w, int log2w) const {
    const int T = blockDim.x;
    const int rpb = sm.rows_per_block;
    const int N = rpb * w;
    int* s_node = sm.rows;
    int* s_ws = s_node + rpb;
    int* s_wd = s_ws + rpb;
    int* s_dg = s_wd + rpb;
    int* s_es = s_dg + rpb;
    unsigned* s_base = (unsigned*)(s_es + rpb);
    for (int r = threadIdx.x; r < rpb; r += T) {
      long long row = row0 + r;
      s_node[r] = nodes[row];
      s_ws[r] = wstart[row];
      s_wd[r] = width[row];
      s_dg[r] = deg[row];
      s_es[r] = estart[row];
    }
    __syncthreads();
    // The gap of every slot: words s0, s0 + 1 (s0 clipped to
    // [0, nwords - 2]), a funnel shift by bit & 31 (lo alone when the
    // shift is 0), a mask of wd bits (all 32 when wd = 32), zig-zag.  Then
    // the row cumsum, by the block scan: the inclusive prefix over the
    // block minus the prefix before the row.  Sums wrap modulo 2^32 like
    // the plain int32 cumsum.
    unsigned carry_sum = 0;
    int carry_max = 0;
#pragma unroll
    for (int c = 0; c < kMaxItems; ++c) {
      if (c * T >= N) break;  // uniform across the block
      int idx = c * T + threadIdx.x;
      int r = idx >> log2w, j = idx & (w - 1);
      int wd = s_wd[r];
      int bit = j * wd;
      int s0 = min(max(s_ws[r] + (bit >> 5), 0), nwords - 2);
      unsigned z = __funnelshift_r(words[s0], words[s0 + 1], bit & 31) &
                   (0xffffffffu >> (32 - wd));
      int gap = (int)(z >> 1) ^ -(int)(z & 1u);
      bool valid = j < s_dg[r];
      unsigned v = valid ? (unsigned)gap + (j == 0 ? (unsigned)s_node[r] : 0u) : 0u;
      int wt = 0;
      if (valid) wt = weighted ? edge_w[min(s_es[r] + j, n_edge_w - 1)] : 1;
      unsigned sum = v;
      int unused = 0;
      block_scan_chunk(sum, unused, carry_sum, carry_max, sm.w_sum, sm.w_max);
      sm.slot_u[idx] = sum;
      sm.slot_i[idx] = wt;
      if (j == 0) s_base[r] = sum - v;
    }
  }

  __device__ __forceinline__ void slot(const LoaderSmem& sm, int idx, int r,
                                       int j, long long, int, int& col,
                                       int& wt) const {
    const int rpb = sm.rows_per_block;
    const int* s_node = sm.rows;
    const int* s_dg = s_node + 3 * rpb;
    const unsigned* s_base = (const unsigned*)(s_node + 5 * rpb);
    col = j < s_dg[r] ? (int)(sm.slot_u[idx] - s_base[r]) : s_node[r];
    wt = sm.slot_i[idx];
  }
};

// At most 32 registers per thread, so that a full SM of 2048 threads
// stays resident: the label gathers need the latency hiding.
template <class Rows>
__global__ void __launch_bounds__(kMaxThreads, 2048 / kMaxThreads) rate_rows_kernel(
    Rows rows, const int* __restrict__ labels, const int* __restrict__ node_w,
    const int* __restrict__ label_w, const int* __restrict__ maxw,
    int maxw_scalar, const int* __restrict__ nodes,
    const int* __restrict__ tie, int w, int log2w, int rows_per_block,
    int external_only, int respect_caps, int lightest,
    int* __restrict__ target, int* __restrict__ tconn,
    int* __restrict__ own_conn, unsigned char* __restrict__ has) {
  extern __shared__ unsigned long long smem[];
  const int N = rows_per_block * w;
  unsigned long long* keys = smem;       // N sorted (label, slot) keys
  int* wv = (int*)(keys + N);            // N weights, original slot order
  unsigned* prefix = (unsigned*)(wv + N);  // N exclusive weight prefixes
  unsigned* w_sum = prefix + N;          // 32 warp totals of the scan
  int* w_start = (int*)(w_sum + 32);     // 32 warp maxima of the scan
  int* s_own = w_start + 32;             // per row: own label
  int* s_nw = s_own + rows_per_block;    // node weight
  int* s_oc = s_nw + rows_per_block;     // own connection
  int* s_best = s_oc + rows_per_block;   // best rating
  int* s_lw = s_best + rows_per_block;   // lightest eligible label weight
  int* s_tie = s_lw + rows_per_block;    // largest eligible tie value
  int* s_slot = s_tie + rows_per_block;  // first winning sorted position
  // The loader's per-row words; its per-slot scratch is `prefix` and `wv`,
  // both unused until the label gather.
  const LoaderSmem lsm{prefix, wv, w_sum, w_start, s_slot + rows_per_block,
                       rows_per_block};

  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const long long row0 = (long long)blockIdx.x * rows_per_block;

  for (int r = tid; r < rows_per_block; r += T) {
    int node = nodes[row0 + r];
    s_own[r] = labels[node];
    s_nw[r] = node_w[node];
    s_oc[r] = 0;
    s_best[r] = -1;
    s_lw[r] = 0x7fffffff;
    s_tie[r] = -1;
    s_slot[r] = w;
  }
  rows.prepare(lsm, nodes, row0, w, log2w);
  __syncthreads();

  // Gather neighbour labels; own connection.
  for (int idx = tid; idx < N; idx += T) {
    int r = idx >> log2w, j = idx & (w - 1);
    int col, wt;
    rows.slot(lsm, idx, r, j, row0, w, col, wt);
    int lab = labels[col];
    keys[idx] = ((unsigned long long)(unsigned)lab << 32) | (unsigned)j;
    wv[idx] = wt;
    if (lab == s_own[r] && wt != 0) atomicAdd(&s_oc[r], wt);
  }
  __syncthreads();

  // Bitonic sort of every row segment (ascending; keys are unique).
  for (int k = 2; k <= w; k <<= 1) {
    for (int jj = k >> 1; jj > 0; jj >>= 1) {
      for (int idx = tid; idx < N; idx += T) {
        int i = idx & (w - 1);
        int p = i ^ jj;
        if (p > i) {
          int pidx = idx ^ jj;
          unsigned long long a = keys[idx], b = keys[pidx];
          bool up = (i & k) == 0;
          if ((a > b) == up) {
            keys[idx] = b;
            keys[pidx] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  // Block scan over the sorted slots, T at a time: prefix sums of the
  // weights, and the largest run start at or before each slot (every row
  // begins a run, so a start never reaches into the previous row).
  int start_of[kMaxItems];
  unsigned incl_of[kMaxItems];  // inclusive prefix at each slot
  unsigned carry_sum = 0;
  int carry_start = 0;
#pragma unroll
  for (int c = 0; c < kMaxItems; ++c) {
    if (c * T >= N) break;  // uniform across the block
    int idx = c * T + tid;
    int r = idx >> log2w, j = idx & (w - 1);
    unsigned long long key = keys[idx];
    int lab = key_label(key);
    bool first = j == 0 || key_label(keys[idx - 1]) != lab;
    unsigned own = (unsigned)wv[r * w + (int)(key & 0xffffffffu)];
    unsigned sum = own;
    int st = first ? idx : 0;
    block_scan_chunk(sum, st, carry_sum, carry_start, w_sum, w_start);
    prefix[idx] = sum - own;
    incl_of[c] = sum;
    start_of[c] = st;
  }
  __syncthreads();

  // Candidates at run ends.  The weights are not needed any more, so `wv`
  // holds each run end's score (rating, or -1 when the run is no
  // candidate); only run ends are read below.
  int* score = wv;
#pragma unroll
  for (int c = 0; c < kMaxItems; ++c) {
    if (c * T >= N) break;
    int idx = c * T + tid;
    int r = idx >> log2w, j = idx & (w - 1);
    int lab = key_label(keys[idx]);
    bool end = (j == w - 1) || key_label(keys[idx + 1]) != lab;
    if (!end) continue;
    int st = start_of[c];
    int rating = (int)(incl_of[c] - prefix[st]);
    bool is_cur = lab == s_own[r];
    bool ok = rating > 0;
    if (external_only) ok = ok && !is_cur;
    if (respect_caps) {
      int cap = maxw_scalar ? maxw[0] : maxw[lab];
      bool fits = label_w[lab] + s_nw[r] <= cap;
      ok = external_only ? (ok && fits) : (ok && (is_cur || fits));
    }
    score[idx] = ok ? rating : -1;
    if (ok) atomicMax(&s_best[r], rating);
  }
  __syncthreads();

#define FOR_ELIGIBLE(body)                                                   \
  for (int idx = tid; idx < N; idx += T) {                                   \
    int r = idx >> log2w, j = idx & (w - 1);                                 \
    int lab = key_label(keys[idx]);                                          \
    bool end = (j == w - 1) || key_label(keys[idx + 1]) != lab;              \
    if (!end || s_best[r] < 0 || score[idx] != s_best[r]) continue;          \
    body                                                                     \
  }

  if (lightest) {
    FOR_ELIGIBLE(atomicMin(&s_lw[r], label_w[lab]);)
    __syncthreads();
  }
  FOR_ELIGIBLE(
    if (lightest && label_w[lab] != s_lw[r]) continue;
    atomicMax(&s_tie[r], tie[(row0 + r) * (long long)w + j]);)
  __syncthreads();
  FOR_ELIGIBLE(
    if (lightest && label_w[lab] != s_lw[r]) continue;
    if (tie[(row0 + r) * (long long)w + j] == s_tie[r]) atomicMin(&s_slot[r], j);)
  __syncthreads();
#undef FOR_ELIGIBLE

  for (int r = tid; r < rows_per_block; r += T) {
    long long row = row0 + r;
    int best = s_best[r];
    bool h = best >= 0;
    target[row] = h ? key_label(keys[r * w + s_slot[r]]) : s_own[r];
    tconn[row] = h ? best : 0;
    own_conn[row] = s_oc[r];
    has[row] = h ? 1 : 0;
  }
}

// Launches the kernel on one bucket.  R and w are powers of two with
// 8 <= w <= 4096 and R >= 8.  Returns the launch's cudaError_t.
template <class Rows>
int launch_rate(const Rows& rows, const int* labels, const int* node_w,
                const int* label_w, const int* maxw, int maxw_scalar,
                const int* nodes, const int* tie, int R, int w,
                int external_only, int respect_caps, int lightest, int* target,
                int* tconn, int* own_conn, unsigned char* has, void* stream) {
  int log2w = 0;
  while ((1 << log2w) < w) ++log2w;
  int rows_per_block = w >= kSmallRowThreads ? 1 : kSmallRowThreads / w;
  if (rows_per_block > R) rows_per_block = R;
  int threads = rows_per_block * w;
  if (threads > kMaxThreads) threads = kMaxThreads;
  int blocks = R / rows_per_block;
  size_t n = (size_t)rows_per_block * w;
  size_t smem = n * (sizeof(unsigned long long) + 2 * sizeof(int)) +
                64 * sizeof(int) +
                (7 + Rows::kRowInts) * (size_t)rows_per_block * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      rate_rows_kernel<Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  rate_rows_kernel<Rows><<<blocks, threads, smem, (cudaStream_t)stream>>>(
      rows, labels, node_w, label_w, maxw, maxw_scalar, nodes, tie, w, log2w,
      rows_per_block, external_only, respect_caps, lightest, target, tconn,
      own_conn, has);
  return (int)cudaGetLastError();
}

}  // namespace

// Rates every row of one dense (R, w) bucket.
extern "C" int kp_rate_bucket(
    const int* labels, const int* node_w, const int* label_w, const int* maxw,
    int maxw_scalar, const int* nodes, const int* cols, const int* wgts,
    const int* tie, int R, int w, int external_only, int respect_caps,
    int lightest, int* target, int* tconn, int* own_conn, unsigned char* has,
    void* stream) {
  DenseRows rows{cols, wgts};
  return launch_rate(rows, labels, node_w, label_w, maxw, maxw_scalar, nodes,
                     tie, R, w, external_only, respect_caps, lightest, target,
                     tconn, own_conn, has, stream);
}

// Rates every row of one compressed bucket, decoding its (R, w) neighbour
// slots from the word stream inside the kernel.  `edge_w` has `n_edge_w`
// entries and is read only when `weighted`.
extern "C" int kp_rate_compressed_bucket(
    const int* labels, const int* node_w, const int* label_w, const int* maxw,
    int maxw_scalar, const unsigned* words, int nwords, const int* edge_w,
    int n_edge_w, int weighted, const int* nodes, const int* wstart,
    const int* width, const int* deg, const int* estart, const int* tie, int R,
    int w, int external_only, int respect_caps, int lightest, int* target,
    int* tconn, int* own_conn, unsigned char* has, void* stream) {
  CompressedRows rows{words, nwords, edge_w, n_edge_w, weighted,
                      wstart, width, deg,    estart};
  return launch_rate(rows, labels, node_w, label_w, maxw, maxw_scalar, nodes,
                     tie, R, w, external_only, respect_caps, lightest, target,
                     tconn, own_conn, has, stream);
}
