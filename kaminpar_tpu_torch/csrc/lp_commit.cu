// LP commit kernel: movers, capacity auction and state update of one round.
//
// Replaces the TPU kernel `commit_moves` (kaminpar_tpu/ops/pallas_lp.py:654,
// body `_make_commit_kernel` :560).  Computes exactly what
// `ops/lp._commit_moves` computes:
//   mover: tconn > own_conn (or a tie with `coin` when allow_tie), desired
//   label != current label, masked by `color` and `act` when given;
//   auction: per target label, the largest priority threshold thr such that
//   the movers with prio < thr fit the label's slack (maxw - weight),
//   resolved radix-32 (6 levels of a (L, 32) histogram of mover weight
//   over priority digits) or bitwise (30 levels of per-label demand);
//   commit: movers with prio < thr[target]; new labels, label weights by
//   scatter-add, moved count.
//
// What bounds it on the H100: memory.  Every level re-reads the mover
// arrays (prio, target, mover weight: 12 bytes per node) and scatters
// into the histogram with integer atomics; the per-label passes would
// dominate when L is large (clustering, L = n_pad) if they swept the
// whole (L, 32) histogram at every level.
//
// Design (simple first): a short sequence of grid-wide launches on the
// caller's stream, with scratch arrays allocated by the wrapper.  Only
// labels that some mover targets take part in the auction (the others'
// thresholds are never read), so the movers pass flags them, and the
// per-label passes touch the histogram rows of flagged labels only: the
// slack pass clears them and each level pass clears the row it has read,
// so no level clears the whole histogram.  Integer atomicAdd is
// order-free, so the result is deterministic and equals the plain
// version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRadixBits = 5;
constexpr int kRadix = 1 << kRadixBits;
constexpr int kPrioBits = 30;

inline int grid_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  if (b > (1LL << 30)) b = 1LL << 30;
  return (int)b;
}

__global__ void movers_kernel(int n, const int* __restrict__ labels,
                              const int* __restrict__ node_w,
                              const int* __restrict__ target,
                              const int* __restrict__ tconn,
                              const int* __restrict__ own_conn,
                              const unsigned char* __restrict__ coin,
                              const unsigned char* __restrict__ act,
                              const unsigned char* __restrict__ color,
                              int allow_tie, int use_act, int use_color,
                              int* __restrict__ t_idx, int* __restrict__ w_mover,
                              unsigned char* __restrict__ moved,
                              unsigned char* __restrict__ is_target) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    int tc = tconn[i], oc = own_conn[i];
    bool better = tc > oc;
    if (allow_tie) better = better || (tc == oc && coin[i]);
    int lab = labels[i];
    int desired = better ? target[i] : lab;
    bool mv = desired != lab;
    if (use_color) mv = mv && color[i];
    if (use_act) mv = mv && act[i];
    moved[i] = mv ? 1 : 0;
    if (mv) is_target[desired] = 1;
    t_idx[i] = mv ? desired : 0;
    w_mover[i] = mv ? node_w[i] : 0;
  }
}

// Slack, threshold and admitted weight of every target label, and its
// histogram row (`row` ints: kRadix for radix, 1 for bitwise) cleared.
__global__ void slack_kernel(int L, const int* __restrict__ maxw, int maxw_scalar,
                             const int* __restrict__ label_w,
                             const unsigned char* __restrict__ is_target, int row,
                             int* __restrict__ slack, int* __restrict__ thr,
                             int* __restrict__ admitted, int* __restrict__ hist) {
  for (long long l = blockIdx.x * (long long)blockDim.x + threadIdx.x; l < L;
       l += (long long)gridDim.x * blockDim.x) {
    if (!is_target[l]) continue;
    slack[l] = (maxw_scalar ? maxw[0] : maxw[l]) - label_w[l];
    thr[l] = 0;
    admitted[l] = 0;
    for (int d = 0; d < row; ++d) hist[l * row + d] = 0;
  }
}

__global__ void radix_hist_kernel(int n, int shift, const int* __restrict__ prio,
                                  const unsigned char* __restrict__ moved,
                                  const int* __restrict__ t_idx,
                                  const int* __restrict__ w_mover,
                                  const int* __restrict__ thr,
                                  int* __restrict__ hist) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    if (!moved[i]) continue;
    int t = t_idx[i], p = prio[i], th = thr[t];
    bool in_window = ((p >> (shift + kRadixBits)) == (th >> (shift + kRadixBits))) &&
                     p >= th;
    int wt = w_mover[i];
    if (in_window && wt != 0)
      atomicAdd(&hist[(long long)t * kRadix + ((p >> shift) & (kRadix - 1))], wt);
  }
}

__global__ void radix_level_kernel(int L, int shift,
                                   const unsigned char* __restrict__ is_target,
                                   const int* __restrict__ slack,
                                   int* __restrict__ hist,
                                   int* __restrict__ thr,
                                   int* __restrict__ admitted) {
  for (long long l = blockIdx.x * (long long)blockDim.x + threadIdx.x; l < L;
       l += (long long)gridDim.x * blockDim.x) {
    if (!is_target[l]) continue;
    int room = slack[l] - admitted[l];
    int* h = hist + l * (long long)kRadix;
    int hv[kRadix];
#pragma unroll
    for (int d = 0; d < kRadix; ++d) {
      hv[d] = h[d];
      h[d] = 0;  // cleared for the next level
    }
    int cum = 0, j = 0, gained = 0;
    // j = number of digits whose cumulative weight fits the room; gained =
    // the cumulative weight at digit j - 1 (the plain version's gather).
#pragma unroll
    for (int d = 0; d < kRadix; ++d) {
      cum += hv[d];
      if (cum <= room && room >= 0) ++j;
    }
    cum = 0;
#pragma unroll
    for (int d = 0; d < kRadix; ++d)
      if (d < j) cum += hv[d];
    gained = cum;
    admitted[l] += gained;
    thr[l] += j << shift;
  }
}

__global__ void bit_demand_kernel(int n, int bit, const int* __restrict__ prio,
                                  const unsigned char* __restrict__ moved,
                                  const int* __restrict__ t_idx,
                                  const int* __restrict__ w_mover,
                                  const int* __restrict__ thr,
                                  int* __restrict__ demand) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    if (!moved[i]) continue;
    int t = t_idx[i];
    int wt = w_mover[i];
    if (prio[i] < thr[t] + bit && wt != 0) atomicAdd(&demand[t], wt);
  }
}

__global__ void bit_level_kernel(int L, int bit,
                                 const unsigned char* __restrict__ is_target,
                                 const int* __restrict__ slack,
                                 int* __restrict__ demand,
                                 int* __restrict__ thr) {
  for (long long l = blockIdx.x * (long long)blockDim.x + threadIdx.x; l < L;
       l += (long long)gridDim.x * blockDim.x) {
    if (!is_target[l]) continue;
    if (demand[l] <= slack[l]) thr[l] += bit;
    demand[l] = 0;  // cleared for the next level
  }
}

__global__ void accept_kernel(int n, const int* __restrict__ labels,
                              const int* __restrict__ node_w,
                              const int* __restrict__ prio,
                              const unsigned char* __restrict__ moved,
                              const int* __restrict__ t_idx,
                              const int* __restrict__ thr,
                              int* __restrict__ new_labels,
                              int* __restrict__ new_weights,
                              int* __restrict__ moved_count) {
  int local = 0;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    bool commit = moved[i] && prio[i] < thr[t_idx[i]];
    int lab = commit ? t_idx[i] : labels[i];
    new_labels[i] = lab;
    int wt = node_w[i];
    if (wt != 0) atomicAdd(&new_weights[lab], wt);
    local += commit ? 1 : 0;
  }
  for (int off = 16; off > 0; off >>= 1)
    local += __shfl_down_sync(0xffffffffu, local, off);
  if ((threadIdx.x & 31) == 0 && local != 0) atomicAdd(moved_count, local);
}

}  // namespace

// One LP commit.  Scratch: t_idx, w_mover (n int32), moved (n bytes),
// is_target (L bytes), slack, thr, admitted (L int32) and hist (L * 32
// int32 for radix, L for bitwise).  Outputs: new_labels (n), new_weights (L), moved_count (1).
// Returns the first failing call's cudaError_t, else 0.
extern "C" int kp_commit_moves(
    int n, int L, const int* labels, const int* node_w, const int* label_w,
    const int* maxw, int maxw_scalar, const int* target, const int* tconn,
    const int* own_conn, const int* prio, const unsigned char* coin,
    const unsigned char* act, const unsigned char* color, int allow_tie,
    int use_act, int use_color, int radix, int* t_idx, int* w_mover,
    unsigned char* moved, unsigned char* is_target, int* slack, int* thr, int* admitted, int* hist,
    int* new_labels, int* new_weights, int* moved_count, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  cudaError_t err;
#define KP_CHECK()                                  \
  do {                                              \
    err = cudaGetLastError();                       \
    if (err != cudaSuccess) return (int)err;        \
  } while (0)

  err = cudaMemsetAsync(is_target, 0, (size_t)L, stream);
  if (err != cudaSuccess) return (int)err;
  movers_kernel<<<grid_for(n), kThreads, 0, stream>>>(
      n, labels, node_w, target, tconn, own_conn, coin, act, color, allow_tie,
      use_act, use_color, t_idx, w_mover, moved, is_target);
  KP_CHECK();
  slack_kernel<<<grid_for(L), kThreads, 0, stream>>>(
      L, maxw, maxw_scalar, label_w, is_target, radix ? kRadix : 1, slack, thr,
      admitted, hist);
  KP_CHECK();
  if (radix) {
    for (int shift = kPrioBits - kRadixBits; shift >= 0; shift -= kRadixBits) {
      radix_hist_kernel<<<grid_for(n), kThreads, 0, stream>>>(
          n, shift, prio, moved, t_idx, w_mover, thr, hist);
      KP_CHECK();
      radix_level_kernel<<<grid_for(L), kThreads, 0, stream>>>(
          L, shift, is_target, slack, hist, thr, admitted);
      KP_CHECK();
    }
  } else {
    for (int i = 0; i < kPrioBits; ++i) {
      int bit = 1 << (kPrioBits - 1 - i);
      bit_demand_kernel<<<grid_for(n), kThreads, 0, stream>>>(
          n, bit, prio, moved, t_idx, w_mover, thr, hist);
      KP_CHECK();
      bit_level_kernel<<<grid_for(L), kThreads, 0, stream>>>(L, bit, is_target,
                                                             slack, hist, thr);
      KP_CHECK();
    }
  }
  err = cudaMemsetAsync(new_weights, 0, (size_t)L * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(moved_count, 0, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  accept_kernel<<<grid_for(n), kThreads, 0, stream>>>(
      n, labels, node_w, prio, moved, t_idx, thr, new_labels, new_weights,
      moved_count);
  KP_CHECK();
#undef KP_CHECK
  return 0;
}
