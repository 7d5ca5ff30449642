/* Minimal C client of libkaminpar_tpu_torch: build a 2D grid graph in plain
 * C, partition it into 4 blocks on the card, print the cut and verify the
 * result is a valid partition.  Built by tests/test_torch_entry.py (which
 * runs it where there is no card: it must fail) and run on the card by
 * tests/test_torch_cuda.py.
 *
 * Role counterpart: the reference's C example usage of ckaminpar.h.
 */
#include <kaminpar_tpu_torch.h>

#include <stdio.h>
#include <stdlib.h>

#define SIDE 24
#define N (SIDE * SIDE)

int main(void) {
  /* 4-neighbor grid in CSR. */
  static uint64_t xadj[N + 1];
  static uint32_t adjncy[4 * N];
  uint64_t m = 0;
  for (int r = 0; r < SIDE; ++r) {
    for (int c = 0; c < SIDE; ++c) {
      int u = r * SIDE + c;
      xadj[u] = m;
      if (r > 0) adjncy[m++] = u - SIDE;
      if (r + 1 < SIDE) adjncy[m++] = u + SIDE;
      if (c > 0) adjncy[m++] = u - 1;
      if (c + 1 < SIDE) adjncy[m++] = u + 1;
    }
  }
  xadj[N] = m;

  kptpu_set_output_level(KPTPU_OUTPUT_LEVEL_QUIET);
  kptpu_solver_t *solver = kptpu_create("fast");
  if (!solver) {
    fprintf(stderr, "create failed: %s\n", kptpu_last_error());
    return 1;
  }
  if (kptpu_set_seed(solver, 1) != 0 ||
      kptpu_copy_graph(solver, N, xadj, adjncy, NULL, NULL) != 0) {
    fprintf(stderr, "copy_graph failed: %s\n", kptpu_last_error());
    return 1;
  }

  static uint32_t part[N];
  const uint32_t k = 4;
  int64_t cut = kptpu_compute_partition(solver, k, 0.03, part);
  if (cut < 0) {
    fprintf(stderr, "compute failed: %s\n", kptpu_last_error());
    return 1;
  }

  /* Validate: ids in range, every block non-empty, balance within eps. */
  uint32_t sizes[4] = {0, 0, 0, 0};
  for (int u = 0; u < N; ++u) {
    if (part[u] >= k) {
      fprintf(stderr, "block id out of range at node %d\n", u);
      return 1;
    }
    sizes[part[u]]++;
  }
  uint32_t cap = (uint32_t)((1.0 + 0.03) * ((N + k - 1) / k)) + 1;
  for (uint32_t b = 0; b < k; ++b) {
    if (sizes[b] == 0 || sizes[b] > cap) {
      fprintf(stderr, "block %u has invalid size %u (cap %u)\n", b, sizes[b],
              cap);
      return 1;
    }
  }

  /* An unknown preset must fail with a useful message. */
  kptpu_solver_t *bad = kptpu_create("no-such-preset");
  if (bad != NULL || kptpu_last_error()[0] == '\0') {
    fprintf(stderr, "expected unknown-preset failure\n");
    return 1;
  }

  printf("CAPI_OK cut=%lld\n", (long long)cut);
  kptpu_free(solver);
  return 0;
}
