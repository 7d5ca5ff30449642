// Native METIS parser — the C++ IO layer of the PyTorch/CUDA port.
//
// Reference: kaminpar-io/metis_parser.cc:29-50 + util/file_toker.h:180 (the
// mmap'd whitespace tokenizer).  Same design: map the file, one forward scan,
// no per-token allocation.  Exposed as a plain C ABI and loaded via ctypes
// (kaminpar_tpu_torch/io/native.py) — no Python C API, so the library builds with
// nothing but g++.
//
// Format (docs/graph_format as implemented by the reference): header line
// "n m [fmt]" (fmt 1 = edge weights, 10 = node weights, 11 = both); line i
// lists node i's 1-indexed neighbors; '%' lines are comments; blank lines
// are degree-0 nodes.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

struct KpMetisGraph {
  int64_t n;
  int64_t m;  // directed edge count (2x undirected)
  int64_t *row_ptr;  // n + 1
  int64_t *col_idx;  // m
  int64_t *node_w;   // n, or nullptr when fmt has no node weights
  int64_t *edge_w;   // m, or nullptr when fmt has no edge weights
  const char *error;  // static message, or nullptr on success
};

static const char *kErrOpen = "cannot open file";
static const char *kErrEmpty = "empty METIS file";
static const char *kErrHeader = "malformed header";
static const char *kErrToken = "METIS tokens must be non-negative integers";
static const char *kErrLines = "more adjacency lines than nodes";
static const char *kErrCount = "edge count does not match header";
static const char *kErrRange = "neighbor id out of range";
static const char *kErrWeight = "adjacency line ends with a dangling edge weight slot";
static const char *kErrBig = "integer token too large";
static const char *kErrOom = "out of memory";

// Matches the NumPy parser's exact-float64 bound: tokens >= 2^53 are
// rejected there, so the native path must reject them too (parse results
// must not depend on which parser ran).
static const int64_t kMaxToken = (int64_t{1} << 53) - 1;

namespace {

struct Toker {
  const char *p;
  const char *end;

  void skip_ws_and_comments(bool *newline) {
    while (p < end) {
      char c = *p;
      if (c == '%') {  // comment: consume to end of line (line doesn't count)
        while (p < end && *p != '\n') ++p;
      } else if (c == '\n') {
        if (newline) *newline = true;
        ++p;
      } else if (c == ' ' || c == '\t' || c == '\r') {
        ++p;
      } else {
        return;
      }
    }
  }

  // Parse one unsigned integer; returns false at whitespace-only tail or on
  // a non-digit byte (err set).  ``same_line`` restricts the scan to the
  // current line (header tokens must not leak in from adjacency lines).
  bool next(int64_t *out, const char **err, bool same_line = false) {
    if (same_line) {
      while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
      if (p >= end || *p == '\n' || *p == '%') return false;
    } else {
      skip_ws_and_comments(nullptr);
      if (p >= end) return false;
    }
    if (*p < '0' || *p > '9') {
      *err = kErrToken;
      return false;
    }
    int64_t v = 0;
    while (p < end && *p >= '0' && *p <= '9') {
      v = v * 10 + (*p - '0');
      if (v > kMaxToken) {
        *err = kErrBig;
        return false;
      }
      ++p;
    }
    *out = v;
    return true;
  }

  // Consume whole comment lines ('%' as first non-blank char), but never a
  // blank line — blank lines ARE degree-0 nodes.
  void skip_comment_lines() {
    for (;;) {
      const char *q = p;
      while (q < end && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
      if (q < end && *q == '%') {
        while (q < end && *q != '\n') ++q;
        if (q < end) ++q;  // the newline of the comment line
        p = q;
      } else {
        return;
      }
    }
  }
};

}  // namespace

void kp_free_graph(KpMetisGraph *g) {
  if (!g) return;
  free(g->row_ptr);
  free(g->col_idx);
  free(g->node_w);
  free(g->edge_w);
  g->row_ptr = g->col_idx = g->node_w = g->edge_w = nullptr;
}

int kp_parse_metis(const char *path, KpMetisGraph *g) {
  memset(g, 0, sizeof(*g));
  int fd = open(path, O_RDONLY);
  if (fd < 0) {
    g->error = kErrOpen;
    return 1;
  }
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size == 0) {
    close(fd);
    g->error = kErrEmpty;
    return 1;
  }
  size_t size = static_cast<size_t>(st.st_size);
  const char *data =
      static_cast<const char *>(mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0));
  close(fd);
  if (data == MAP_FAILED) {
    g->error = kErrOpen;
    return 1;
  }

  Toker tk{data, data + size};
  const char *err = nullptr;
  int64_t n = 0, m_und = 0, fmt = 0;
  // header = the first line carrying tokens; comment/blank lines skip.
  // Header tokens are LINE-BOUNDED (same_line=true): a one-token header
  // must error, not silently pull n's partner from an adjacency line.
  for (;;) {
    tk.skip_comment_lines();
    if (tk.p < tk.end &&
        (*tk.p == '\n' || *tk.p == ' ' || *tk.p == '\t' || *tk.p == '\r')) {
      ++tk.p;
      continue;
    }
    break;
  }
  if (!tk.next(&n, &err, true) || !tk.next(&m_und, &err, true)) {
    munmap(const_cast<char *>(data), size);
    g->error = err ? err : kErrHeader;
    return 1;
  }
  if (!tk.next(&fmt, &err, true) && err) {  // optional fmt, same line only
    munmap(const_cast<char *>(data), size);
    g->error = err;
    return 1;
  }
  bool has_ew = fmt % 10 == 1;
  bool has_nw = (fmt / 10) % 10 == 1;
  int64_t m = 2 * m_und;
  // File-size sanity bounds header claims BEFORE any allocation: every
  // directed edge needs at least one byte of file, every node one line.
  // This also makes the (n+1)/m size_t multiplications below wrap-proof.
  if (n < 0 || m_und < 0 || n > static_cast<int64_t>(size) + 1 ||
      m > static_cast<int64_t>(size)) {
    munmap(const_cast<char *>(data), size);
    g->error = kErrHeader;
    return 1;
  }

  g->n = n;
  g->m = m;
  g->row_ptr = static_cast<int64_t *>(malloc((n + 1) * sizeof(int64_t)));
  g->col_idx = static_cast<int64_t *>(malloc((m > 0 ? m : 1) * sizeof(int64_t)));
  if (has_nw) g->node_w = static_cast<int64_t *>(malloc((n > 0 ? n : 1) * sizeof(int64_t)));
  if (has_ew) g->edge_w = static_cast<int64_t *>(malloc((m > 0 ? m : 1) * sizeof(int64_t)));
  if (!g->row_ptr || !g->col_idx || (has_nw && !g->node_w) || (has_ew && !g->edge_w)) {
    kp_free_graph(g);
    munmap(const_cast<char *>(data), size);
    g->error = kErrOom;
    return 1;
  }

  // advance past the header's newline so node 0 starts at the next line;
  // anything but whitespace/comment after the fmt token is rejected (the
  // NumPy parser rejects it too — parse results must not depend on which
  // parser ran)
  while (tk.p < tk.end && *tk.p != '\n') {
    char c = *tk.p;
    if (c == '%') {
      while (tk.p < tk.end && *tk.p != '\n') ++tk.p;
      break;
    }
    if (c != ' ' && c != '\t' && c != '\r') {
      kp_free_graph(g);
      munmap(const_cast<char *>(data), size);
      g->error = kErrToken;
      return 1;
    }
    ++tk.p;
  }
  if (tk.p < tk.end) ++tk.p;  // the newline itself

  int64_t e = 0;  // directed edges written
  for (int64_t u = 0; u < n; ++u) {
    tk.skip_comment_lines();
    g->row_ptr[u] = e;
    if (has_nw) g->node_w[u] = 1;
    bool first_tok = true;
    bool expect_weight = false;
    // consume tokens until this node's newline (comment lines were skipped
    // above; a mid-line '%' is a token error, matching the NumPy parser)
    for (;;) {
      while (tk.p < tk.end &&
             (*tk.p == ' ' || *tk.p == '\t' || *tk.p == '\r'))
        ++tk.p;
      if (tk.p >= tk.end) break;  // EOF ends the last line
      if (*tk.p == '\n') {
        ++tk.p;
        break;  // end of this node's line
      }
      if (*tk.p < '0' || *tk.p > '9') {
        kp_free_graph(g);
        munmap(const_cast<char *>(data), size);
        g->error = kErrToken;
        return 1;
      }
      int64_t v = 0;
      while (tk.p < tk.end && *tk.p >= '0' && *tk.p <= '9') {
        v = v * 10 + (*tk.p - '0');
        if (v > kMaxToken) {
          kp_free_graph(g);
          munmap(const_cast<char *>(data), size);
          g->error = kErrBig;
          return 1;
        }
        ++tk.p;
      }
      if (first_tok && has_nw) {
        g->node_w[u] = v;
        first_tok = false;
        continue;
      }
      first_tok = false;
      if (expect_weight) {
        g->edge_w[e - 1] = v;
        expect_weight = false;
      } else {
        if (e >= m) {
          kp_free_graph(g);
          munmap(const_cast<char *>(data), size);
          g->error = kErrCount;
          return 1;
        }
        if (v < 1 || v > n) {
          kp_free_graph(g);
          munmap(const_cast<char *>(data), size);
          g->error = kErrRange;
          return 1;
        }
        g->col_idx[e++] = v - 1;
        if (has_ew) expect_weight = true;
      }
    }
    if (expect_weight) {  // odd token count: neighbor without its weight
      kp_free_graph(g);
      munmap(const_cast<char *>(data), size);
      g->error = kErrWeight;
      return 1;
    }
  }
  g->row_ptr[n] = e;

  // any remaining non-whitespace content means more lines than nodes
  tk.skip_ws_and_comments(nullptr);
  if (tk.p < tk.end) {
    kp_free_graph(g);
    munmap(const_cast<char *>(data), size);
    g->error = kErrLines;
    return 1;
  }
  if (e != m) {
    kp_free_graph(g);
    munmap(const_cast<char *>(data), size);
    g->error = kErrCount;
    return 1;
  }
  munmap(const_cast<char *>(data), size);
  return 0;
}

}  // extern "C"
