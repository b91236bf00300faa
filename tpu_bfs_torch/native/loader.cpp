// Native graph-ingestion fast paths for tpu_bfs_torch, exposed via ctypes:
// the port's copy of tpu_bfs/native/loader.cpp, its symbols prefixed
// tpubfs_torch_ so that both packages' libraries can share a process.
//
// The reference's loader is C++ (readGraphFromFile, bfs.cu:829-880: ifstream
// `f >> u >> v` over m edge lines). This implementation replaces the
// formatted-stream parse with a single read() + branch-light integer scanner
// (~100x faster on multi-GB edge lists), handles '%'/'#' comment lines and
// 1-indexed MatrixMarket bodies, and returns raw endpoint arrays; CSR
// construction stays in NumPy (vectorized counting sort).
//
// Exported C ABI (see tpu_bfs_torch/utils/native.py):
//   tpubfs_torch_parse_edge_list(path, &n, &m, &u, &v) -> 0 on success
//   tpubfs_torch_free(ptr)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

struct Scanner {
  const char* p;
  const char* end;

  void skip_ws_and_comments() {
    while (p < end) {
      char c = *p;
      if (c == ' ' || c == '\t' || c == '\r' || c == '\n') {
        ++p;
      } else if (c == '%' || c == '#') {
        while (p < end && *p != '\n') ++p;
      } else {
        break;
      }
    }
  }

  // Parses a non-negative number; tolerates a floating-point tail (.5e3) by
  // consuming and ignoring it (MatrixMarket weight columns).
  bool next_int(int64_t* out) {
    skip_ws_and_comments();
    if (p >= end) return false;
    int64_t v = 0;
    bool any = false;
    while (p < end && *p >= '0' && *p <= '9') {
      v = v * 10 + (*p - '0');
      any = true;
      ++p;
    }
    if (!any) return false;
    // Swallow a fractional / exponent tail so weighted .mtx rows parse.
    if (p < end && (*p == '.' || *p == 'e' || *p == 'E')) {
      while (p < end && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r') ++p;
    }
    *out = v;
    return true;
  }

  // Count how many whitespace-separated tokens remain on the current line.
  int tokens_on_line() const {
    const char* q = p;
    int count = 0;
    bool in_tok = false;
    while (q < end && *q != '\n') {
      bool ws = (*q == ' ' || *q == '\t' || *q == '\r');
      if (!ws && !in_tok) {
        ++count;
        in_tok = true;
      } else if (ws) {
        in_tok = false;
      }
      ++q;
    }
    return count;
  }
};

}  // namespace

extern "C" {

// Returns 0 on success; 1 open failure; 2 parse failure; 3 alloc failure.
int64_t tpubfs_torch_parse_edge_list(const char* path, int64_t* out_n,
                                     int64_t* out_m, int64_t** out_u,
                                     int64_t** out_v) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  if (fseek(f, 0, SEEK_END) != 0) {  // unseekable (FIFO/pipe): refuse cleanly
    fclose(f);
    return 1;
  }
  long size = ftell(f);
  if (size < 0 || fseek(f, 0, SEEK_SET) != 0) {
    fclose(f);
    return 1;
  }
  char* buf = static_cast<char*>(malloc(size + 1));
  if (!buf) {
    fclose(f);
    return 3;
  }
  size_t got = fread(buf, 1, size, f);
  fclose(f);
  buf[got] = '\0';

  Scanner sc{buf, buf + got};
  sc.skip_ws_and_comments();
  int header_tokens = sc.tokens_on_line();
  int64_t n = 0, m = 0;
  bool one_indexed = false;
  if (header_tokens == 3) {
    // MatrixMarket size line: rows cols nnz (1-indexed body).
    int64_t rows, cols;
    if (!sc.next_int(&rows) || !sc.next_int(&cols) || !sc.next_int(&m)) {
      free(buf);
      return 2;
    }
    n = rows > cols ? rows : cols;
    one_indexed = true;
  } else if (header_tokens == 2) {
    // Reference format: "n m" (bfs.cu:845), 0-indexed body.
    if (!sc.next_int(&n) || !sc.next_int(&m)) {
      free(buf);
      return 2;
    }
  } else {
    free(buf);
    return 2;
  }

  int64_t* u = static_cast<int64_t*>(malloc(sizeof(int64_t) * (m ? m : 1)));
  int64_t* v = static_cast<int64_t*>(malloc(sizeof(int64_t) * (m ? m : 1)));
  if (!u || !v) {
    free(buf);
    free(u);
    free(v);
    return 3;
  }

  // Edge rows may carry a weight column; detect per-file from the first row.
  int row_tokens = 0;
  {
    Scanner probe = sc;
    probe.skip_ws_and_comments();
    row_tokens = probe.tokens_on_line();
  }
  bool has_weight = (row_tokens >= 3);

  int64_t base = one_indexed ? 1 : 0;
  for (int64_t i = 0; i < m; ++i) {
    int64_t a, b, w;
    if (!sc.next_int(&a) || !sc.next_int(&b)) {
      free(buf);
      free(u);
      free(v);
      return 2;
    }
    if (has_weight && !sc.next_int(&w)) {
      free(buf);
      free(u);
      free(v);
      return 2;
    }
    a -= base;
    b -= base;
    if (a < 0 || a >= n || b < 0 || b >= n) {
      free(buf);
      free(u);
      free(v);
      return 2;
    }
    u[i] = a;
    v[i] = b;
  }
  free(buf);
  *out_n = n;
  *out_m = m;
  *out_u = u;
  *out_v = v;
  return 0;
}

void tpubfs_torch_free(int64_t* ptr) { free(ptr); }

}  // extern "C"

extern "C" {

// Stable two-pass counting sort of pairs: returns the permutation that orders
// by (major, minor) ascending — the O(E) replacement for np.lexsort((minor,
// major)) in CSR construction and partitioning. Keys must lie in [0, n_major)
// / [0, n_minor). Returns 0 on success, 3 on allocation failure.
int64_t tpubfs_torch_lexsort_pairs(const int64_t* major,
                                   const int64_t* minor, int64_t e,
                                   int64_t n_major, int64_t n_minor,
                                   int64_t* out_perm) {
  // Reject out-of-range keys up front: the counting passes below index the
  // count array by key and would corrupt the heap on bad input (returning
  // nonzero triggers the caller's np.lexsort fallback instead).
  for (int64_t i = 0; i < e; ++i) {
    if (major[i] < 0 || major[i] >= n_major || minor[i] < 0 ||
        minor[i] >= n_minor) {
      return 2;
    }
  }
  int64_t* tmp = static_cast<int64_t*>(malloc(sizeof(int64_t) * (e ? e : 1)));
  int64_t nc = (n_major > n_minor ? n_major : n_minor) + 1;
  int64_t* count = static_cast<int64_t*>(calloc(nc, sizeof(int64_t)));
  if (!tmp || !count) {
    free(tmp);
    free(count);
    return 3;
  }
  // Pass 1: stable sort by minor -> tmp.
  for (int64_t i = 0; i < e; ++i) ++count[minor[i] + 1];
  for (int64_t i = 0; i < n_minor; ++i) count[i + 1] += count[i];
  for (int64_t i = 0; i < e; ++i) tmp[count[minor[i]]++] = i;
  // Pass 2: stable sort by major over tmp -> out_perm.
  memset(count, 0, sizeof(int64_t) * nc);
  for (int64_t i = 0; i < e; ++i) ++count[major[i] + 1];
  for (int64_t i = 0; i < n_major; ++i) count[i + 1] += count[i];
  for (int64_t i = 0; i < e; ++i) {
    int64_t idx = tmp[i];
    out_perm[count[major[idx]]++] = idx;
  }
  free(tmp);
  free(count);
  return 0;
}

}  // extern "C"
