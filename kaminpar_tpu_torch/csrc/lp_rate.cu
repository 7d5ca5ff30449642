// LP rating kernel: best move of every row of one (R, w) degree bucket.
//
// Replaces the TPU kernel `_rate_bucket` (kaminpar_tpu/ops/pallas_lp.py:245,
// body `_rate_rows_body` :174 with `_bitonic_sort_rows` :148).  Computes
// exactly what `ops/bucketed_gains._bucket_moves` computes:
//   own = labels[node]; L[j] = labels[cols[j]]; own_conn = sum W[j] over
//   L[j] == own; stable sort of the row by label; rating of a run of equal
//   labels = its weight sum; candidate = run end with rating > 0 (and not
//   the own label when external_only) whose label fits the cap
//   (lw[L] + node_w <= maxw[L] or the scalar maxw, the own label always
//   fits unless external_only); best = max rating; ties: the lightest label
//   first when `lightest`, then the largest tie[r, j] read at the SORTED
//   position j, first position on equal ties.
//
// What bounds it on the H100: memory.  Each slot reads cols, wgts and tie
// (12 bytes, coalesced) and gathers labels[col] (4 bytes, random), plus
// one label-weight gather per run end; the sort and the reductions run in
// shared memory and cost a few integer operations per slot and stage.
//
// Design (simple first): one block holds whole rows (256 / w rows per
// block for w <= 256, one row per block above).  Each slot's (label, slot)
// pair is packed into one 64-bit key; the keys are unique, so a bitonic
// network in shared memory gives the stable order.  Runs are reduced with
// one block scan over the sorted slots (warp shuffles, then the warp
// totals): an inclusive prefix sum of the weights and a running maximum
// of the run-start positions, so a run's rating is the prefix at its end
// minus the prefix before its start (the cumsum + cummax of the TPU
// kernel).  The per-row max/min selections are shared-memory
// atomicMax/atomicMin.  Integer atomics are order-free and the scan wraps
// modulo 2^32 like the plain int32 sums, so the result is deterministic
// and equals the plain version bit for bit.

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

// At most 32 registers per thread, so that a full SM of 2048 threads
// stays resident: the label gathers need the latency hiding.
__global__ void __launch_bounds__(kMaxThreads, 2048 / kMaxThreads) rate_rows_kernel(
    const int* __restrict__ labels, const int* __restrict__ node_w,
    const int* __restrict__ label_w, const int* __restrict__ maxw,
    int maxw_scalar, const int* __restrict__ nodes,
    const int* __restrict__ cols, const int* __restrict__ wgts,
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
  __syncthreads();

  // Gather neighbour labels; own connection.
  for (int idx = tid; idx < N; idx += T) {
    int r = idx >> log2w, j = idx & (w - 1);
    long long g = (row0 + r) * (long long)w + j;
    int lab = labels[cols[g]];
    int wt = wgts[g];
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
  const int lane = tid & 31, warp = tid >> 5, nwarps = T >> 5;
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
    warp_scan(sum, st, lane);
    if (lane == 31) {
      w_sum[warp] = sum;
      w_start[warp] = st;
    }
    __syncthreads();
    if (warp == 0) {
      unsigned ws = lane < nwarps ? w_sum[lane] : 0u;
      int wst = lane < nwarps ? w_start[lane] : 0;
      warp_scan(ws, wst, lane);
      if (lane < nwarps) {
        w_sum[lane] = ws;
        w_start[lane] = wst;
      }
    }
    __syncthreads();
    if (warp > 0) {
      sum += w_sum[warp - 1];
      st = max(st, w_start[warp - 1]);
    }
    sum += carry_sum;
    prefix[idx] = sum - own;
    incl_of[c] = sum;
    start_of[c] = max(st, carry_start);
    carry_sum += w_sum[nwarps - 1];
    carry_start = max(carry_start, w_start[nwarps - 1]);
    __syncthreads();  // the warp totals are rewritten by the next chunk
  }

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

}  // namespace

// Rates every row of one (R, w) bucket.  R and w are powers of two with
// 8 <= w <= 4096 and R >= 8.  Returns the launch's cudaError_t.
extern "C" int kp_rate_bucket(
    const int* labels, const int* node_w, const int* label_w, const int* maxw,
    int maxw_scalar, const int* nodes, const int* cols, const int* wgts,
    const int* tie, int R, int w, int external_only, int respect_caps,
    int lightest, int* target, int* tconn, int* own_conn, unsigned char* has,
    void* stream) {
  int log2w = 0;
  while ((1 << log2w) < w) ++log2w;
  int rows_per_block = w >= kSmallRowThreads ? 1 : kSmallRowThreads / w;
  if (rows_per_block > R) rows_per_block = R;
  int threads = rows_per_block * w;
  if (threads > kMaxThreads) threads = kMaxThreads;
  int blocks = R / rows_per_block;
  size_t n = (size_t)rows_per_block * w;
  size_t smem = n * (sizeof(unsigned long long) + 2 * sizeof(int)) +
                64 * sizeof(int) + 7 * (size_t)rows_per_block * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      rate_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  rate_rows_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      labels, node_w, label_w, maxw, maxw_scalar, nodes, cols, wgts, tie, w,
      log2w, rows_per_block, external_only, respect_caps, lightest, target,
      tconn, own_conn, has);
  return (int)cudaGetLastError();
}
