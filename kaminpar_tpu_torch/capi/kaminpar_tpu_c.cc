/* C API implementation of the PyTorch/CUDA port: a thin marshalling skin
 * over an embedded CPython interpreter running kaminpar_tpu_torch.capi_bridge
 * (see the header for the design rationale; role counterpart: the
 * reference's ckaminpar.cc).
 *
 * Build: `make -C kaminpar_tpu_torch/capi` (uses python3-config --embed flags)
 * into build/capi/ at the repository root.
 */

#include "include/kaminpar_tpu_torch.h"

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>

#ifndef KPTPU_DEFAULT_REPO
#define KPTPU_DEFAULT_REPO ""
#endif
#ifndef KPTPU_DEFAULT_PYTHON
#define KPTPU_DEFAULT_PYTHON ""
#endif

struct kptpu_solver {
  PyObject *handle; /* capi_bridge.CSolver instance */
};

namespace {

std::mutex g_init_mutex;
bool g_py_inited = false;  /* interpreter started (irreversible until finalize) */
bool g_finalized = false;  /* finalize called — library is dead for good */
PyObject *g_bridge = nullptr;          /* kaminpar_tpu_torch.capi_bridge module */
PyThreadState *g_main_state = nullptr; /* released after init for GIL use */
thread_local std::string g_last_error;

void capture_py_error(const char *fallback) {
  if (!PyErr_Occurred()) {
    g_last_error = fallback;
    return;
  }
  PyObject *type = nullptr, *value = nullptr, *trace = nullptr;
  PyErr_Fetch(&type, &value, &trace);
  PyErr_NormalizeException(&type, &value, &trace);
  PyObject *str = value ? PyObject_Str(value) : nullptr;
  const char *msg = str ? PyUnicode_AsUTF8(str) : nullptr;
  g_last_error = msg ? msg : fallback;
  Py_XDECREF(str);
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(trace);
  PyErr_Clear();
}

/* RAII GIL acquisition for every public entry point. */
struct GilGuard {
  PyGILState_STATE state;
  GilGuard() : state(PyGILState_Ensure()) {}
  ~GilGuard() { PyGILState_Release(state); }
};

/* Prepend the repository to sys.path (GIL must be held). */
void add_repo_path(const char *repo_path) {
  const char *repo = repo_path && *repo_path ? repo_path : getenv("KPTPU_REPO");
  if (!repo || !*repo) repo = KPTPU_DEFAULT_REPO;
  if (repo && *repo) {
    PyObject *sys_path = PySys_GetObject("path"); /* borrowed */
    PyObject *entry = PyUnicode_FromString(repo);
    if (sys_path && entry) PyList_Insert(sys_path, 0, entry);
    Py_XDECREF(entry);
  }
}

int initialize_locked(const char *repo_path) {
  if (g_finalized) {
    g_last_error = "kptpu_finalize was called; the library cannot be "
                   "re-initialized in this process (CPython limitation)";
    return -1;
  }
  if (g_bridge) return 0;

  if (!g_py_inited) {
    PyConfig config;
    PyConfig_InitPythonConfig(&config);
    /* Point the runtime at the interpreter that owns the site-packages
     * with torch/numpy (a venv python makes getpath honor its pyvenv.cfg).
     * The build bakes in a default; $KPTPU_PYTHON overrides at runtime. */
    const char *py = getenv("KPTPU_PYTHON");
    if (!py || !*py) py = KPTPU_DEFAULT_PYTHON;
    if (py && *py) {
      PyConfig_SetBytesString(&config, &config.executable, py);
    }
    PyStatus status = Py_InitializeFromConfig(&config);
    PyConfig_Clear(&config);
    if (PyStatus_Exception(status)) {
      g_last_error = std::string("Py_InitializeFromConfig failed: ") +
                     (status.err_msg ? status.err_msg : "unknown");
      return -1;
    }
    g_py_inited = true;
    add_repo_path(repo_path);
    g_bridge = PyImport_ImportModule("kaminpar_tpu_torch.capi_bridge");
    if (!g_bridge) capture_py_error("import kaminpar_tpu_torch.capi_bridge failed");
    /* ALWAYS release the GIL, even on import failure — a held GIL would
     * deadlock every later call from another thread.  The import is
     * retried (e.g. after kptpu_initialize with a correct repo path). */
    g_main_state = PyEval_SaveThread();
    return g_bridge ? 0 : -1;
  }

  /* Interpreter is live but the bridge import failed earlier — retry. */
  GilGuard gil;
  add_repo_path(repo_path);
  g_bridge = PyImport_ImportModule("kaminpar_tpu_torch.capi_bridge");
  if (!g_bridge) {
    capture_py_error("import kaminpar_tpu_torch.capi_bridge failed");
    return -1;
  }
  return 0;
}

int ensure_initialized() {
  std::lock_guard<std::mutex> lock(g_init_mutex);
  return initialize_locked(nullptr);
}

/* Read-only memoryview over caller memory, or Py_None for NULL. */
PyObject *view_or_none(const void *ptr, Py_ssize_t bytes) {
  if (!ptr) Py_RETURN_NONE;
  return PyMemoryView_FromMemory(
      const_cast<char *>(static_cast<const char *>(ptr)), bytes, PyBUF_READ);
}

} // namespace

extern "C" {

int kptpu_initialize(const char *repo_path) {
  std::lock_guard<std::mutex> lock(g_init_mutex);
  return initialize_locked(repo_path);
}

void kptpu_finalize(void) {
  std::lock_guard<std::mutex> lock(g_init_mutex);
  if (!g_py_inited || g_finalized) return;
  PyEval_RestoreThread(g_main_state);
  Py_XDECREF(g_bridge);
  g_bridge = nullptr;
  Py_FinalizeEx();
  g_finalized = true; /* permanently — see header */
}

const char *kptpu_last_error(void) { return g_last_error.c_str(); }

kptpu_solver_t *kptpu_create(const char *preset) {
  if (ensure_initialized() != 0) return nullptr;
  GilGuard gil;
  PyObject *handle = PyObject_CallMethod(
      g_bridge, "CSolver", "s", preset ? preset : "default");
  if (!handle) {
    capture_py_error("CSolver() failed");
    return nullptr;
  }
  kptpu_solver_t *solver = new kptpu_solver{handle};
  g_last_error.clear();
  return solver;
}

void kptpu_free(kptpu_solver_t *solver) {
  if (!solver) return;
  {
    GilGuard gil;
    Py_XDECREF(solver->handle);
  }
  delete solver;
}

int kptpu_set_output_level(kptpu_output_level_t level) {
  if (ensure_initialized() != 0) return -1;
  GilGuard gil;
  PyObject *res =
      PyObject_CallMethod(g_bridge, "set_output_level", "i", (int)level);
  if (!res) {
    capture_py_error("set_output_level failed");
    return -1;
  }
  Py_DECREF(res);
  return 0;
}

int kptpu_set_seed(kptpu_solver_t *solver, int seed) {
  if (!solver) return -1;
  GilGuard gil;
  PyObject *res = PyObject_CallMethod(solver->handle, "set_seed", "i", seed);
  if (!res) {
    capture_py_error("set_seed failed");
    return -1;
  }
  Py_DECREF(res);
  return 0;
}

int kptpu_copy_graph(kptpu_solver_t *solver, uint32_t n, const uint64_t *xadj,
                     const uint32_t *adjncy, const int64_t *vwgt,
                     const int64_t *adjwgt) {
  if (!solver || !xadj || !adjncy) {
    g_last_error = "solver, xadj and adjncy must be non-NULL";
    return -1;
  }
  GilGuard gil;
  const Py_ssize_t m = (Py_ssize_t)xadj[n];
  PyObject *xadj_mv = view_or_none(xadj, (Py_ssize_t)(n + 1) * 8);
  PyObject *adj_mv = view_or_none(adjncy, m * 4);
  PyObject *vw_mv = view_or_none(vwgt, (Py_ssize_t)n * 8);
  PyObject *ew_mv = view_or_none(adjwgt, m * 8);
  PyObject *res = nullptr;
  if (xadj_mv && adj_mv && vw_mv && ew_mv) {
    res = PyObject_CallMethod(solver->handle, "copy_graph", "kOOOO",
                              (unsigned long)n, xadj_mv, adj_mv, vw_mv, ew_mv);
  }
  Py_XDECREF(xadj_mv);
  Py_XDECREF(adj_mv);
  Py_XDECREF(vw_mv);
  Py_XDECREF(ew_mv);
  if (!res) {
    capture_py_error("copy_graph failed");
    return -1;
  }
  Py_DECREF(res);
  g_last_error.clear();
  return 0;
}

static int set_block_weights(kptpu_solver_t *solver, const char *method,
                             uint32_t k, const int64_t *weights) {
  if (!solver || !weights) return -1;
  GilGuard gil;
  PyObject *mv = view_or_none(weights, (Py_ssize_t)k * 8);
  PyObject *res = nullptr;
  if (mv) {
    res = PyObject_CallMethod(solver->handle, method, "kO", (unsigned long)k,
                              mv);
  }
  Py_XDECREF(mv);
  if (!res) {
    capture_py_error(method);
    return -1;
  }
  Py_DECREF(res);
  return 0;
}

int kptpu_set_absolute_max_block_weights(kptpu_solver_t *solver, uint32_t k,
                                         const int64_t *max_block_weights) {
  return set_block_weights(solver, "set_max_block_weights", k,
                           max_block_weights);
}

int kptpu_set_absolute_min_block_weights(kptpu_solver_t *solver, uint32_t k,
                                         const int64_t *min_block_weights) {
  return set_block_weights(solver, "set_min_block_weights", k,
                           min_block_weights);
}

int kptpu_clear_block_weights(kptpu_solver_t *solver) {
  if (!solver) return -1;
  GilGuard gil;
  PyObject *res =
      PyObject_CallMethod(solver->handle, "clear_block_weights", nullptr);
  if (!res) {
    capture_py_error("clear_block_weights failed");
    return -1;
  }
  Py_DECREF(res);
  return 0;
}

int64_t kptpu_compute_partition(kptpu_solver_t *solver, uint32_t k,
                                double epsilon, uint32_t *partition_out) {
  if (!solver || !partition_out) {
    g_last_error = "solver and partition_out must be non-NULL";
    return -1;
  }
  GilGuard gil;
  PyObject *n_obj = PyObject_GetAttrString(solver->handle, "n");
  /* 64-bit local via PyLong_AsLongLong: a C long is 32-bit on LLP64
   * platforms (Windows), which would overflow for n >= 2^31 even though n
   * itself is declared uint32 on the API surface. */
  long long n = n_obj ? PyLong_AsLongLong(n_obj) : -1;
  Py_XDECREF(n_obj);
  if (n <= 0) {
    capture_py_error("no graph set");
    return -1;
  }
  PyObject *out_mv = PyMemoryView_FromMemory(
      reinterpret_cast<char *>(partition_out), (Py_ssize_t)n * 4, PyBUF_WRITE);
  PyObject *res = nullptr;
  if (out_mv) {
    res = PyObject_CallMethod(solver->handle, "compute", "kdO",
                              (unsigned long)k, epsilon, out_mv);
  }
  Py_XDECREF(out_mv);
  if (!res) {
    capture_py_error("compute_partition failed");
    return -1;
  }
  long long cut = PyLong_AsLongLong(res);
  Py_DECREF(res);
  if (cut == -1 && PyErr_Occurred()) {
    capture_py_error("compute_partition returned a non-integer");
    return -1;
  }
  g_last_error.clear();
  return (int64_t)cut;
}

} /* extern "C" */
