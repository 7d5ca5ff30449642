/* Public C library interface of the PyTorch/CUDA port of KaMinPar-TPU:
 * the same functions and types as the JAX package's header, so a C client
 * builds against either library with only this include changed.
 *
 * Role counterpart: the reference's C API
 * (include/kaminpar-shm/ckaminpar.h) — create a solver from a preset,
 * hand it a CSR graph, set balance constraints, compute a partition into a
 * caller-owned buffer, get the cut back.  The implementation embeds a
 * CPython interpreter (the compute path is PyTorch and hand-written CUDA
 * kernels), so the library is a real C-linkable artifact while
 * partitioning runs the same pipeline as the Python API, on cuda:0: there
 * is no CPU fallback, and without a CUDA device kptpu_create fails.
 *
 * Threading: all calls are serialized through the embedded interpreter's
 * GIL; concurrent calls from multiple C threads are safe but will not
 * overlap.  There is no num_threads knob (the reference's tbb
 * thread-count parameter has no analog here).
 *
 * Types are fixed-width (the widest of the reference's build-time
 * variants): node ids/k u32, xadj offsets u64, weights i64.
 */
#ifndef KAMINPAR_TPU_TORCH_C_H
#define KAMINPAR_TPU_TORCH_C_H

#include <stdint.h>
#include <stddef.h>

#define KPTPU_VERSION_MAJOR 0
#define KPTPU_VERSION_MINOR 2
#define KPTPU_VERSION_PATCH 0

/* Mirrors kaminpar_tpu_torch.utils.logger.OutputLevel. */
typedef enum {
  KPTPU_OUTPUT_LEVEL_QUIET = 0,
  KPTPU_OUTPUT_LEVEL_PROGRESS = 1,
  KPTPU_OUTPUT_LEVEL_APPLICATION = 2,
  KPTPU_OUTPUT_LEVEL_EXPERIMENT = 3,
  KPTPU_OUTPUT_LEVEL_DEBUG = 4,
} kptpu_output_level_t;

#ifdef __cplusplus
extern "C" {
#endif

typedef struct kptpu_solver kptpu_solver_t;

/* Explicit interpreter startup.  Optional: every other entry point calls it
 * lazily.  repo_path (nullable) is prepended to sys.path so
 * `kaminpar_tpu_torch` resolves; defaults to $KPTPU_REPO, then the path
 * baked in at build time.
 * Returns 0 on success, -1 on failure (see kptpu_last_error). */
int kptpu_initialize(const char *repo_path);

/* Tear down the embedded interpreter.  Only call once, after all solvers
 * are freed; afterwards the library cannot be re-initialized (CPython
 * limitation on repeated Py_Initialize with extension modules). */
void kptpu_finalize(void);

/* Create a solver from a preset name ("default", "strong", "eco", ...;
 * unknown names fail and kptpu_last_error lists the valid ones). */
kptpu_solver_t *kptpu_create(const char *preset);
void kptpu_free(kptpu_solver_t *solver);

int kptpu_set_output_level(kptpu_output_level_t level);
int kptpu_set_seed(kptpu_solver_t *solver, int seed);

/* Copy an undirected CSR graph (both directions present, as in the
 * reference's kaminpar_copy_graph).  xadj has n+1 entries; adjncy has
 * xadj[n] entries; vwgt/adjwgt may be NULL for unit weights.  The arrays
 * are copied — the caller keeps ownership. */
int kptpu_copy_graph(kptpu_solver_t *solver, uint32_t n, const uint64_t *xadj,
                     const uint32_t *adjncy, const int64_t *vwgt,
                     const int64_t *adjwgt);

/* Balance constraints for the next compute call.  Absolute per-block
 * bounds override the epsilon defaults; clear restores them. */
int kptpu_set_absolute_max_block_weights(kptpu_solver_t *solver, uint32_t k,
                                         const int64_t *max_block_weights);
int kptpu_set_absolute_min_block_weights(kptpu_solver_t *solver, uint32_t k,
                                         const int64_t *min_block_weights);
int kptpu_clear_block_weights(kptpu_solver_t *solver);

/* Partition into k blocks; writes n block ids into partition_out (caller
 * allocates n * sizeof(uint32_t)).  Returns the edge cut (>= 0), or -1 on
 * failure. */
int64_t kptpu_compute_partition(kptpu_solver_t *solver, uint32_t k,
                                double epsilon, uint32_t *partition_out);

/* Last error message of the calling thread ("" if none). */
const char *kptpu_last_error(void);

#ifdef __cplusplus
}
#endif

#endif /* KAMINPAR_TPU_TORCH_C_H */
