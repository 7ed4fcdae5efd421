// falcon-tpu native host library.
//
// First-party replacements for the third-party native components the
// reference relies on (SURVEY.md §2.3):
//   - fastcluster (C++): O(n^2) condensed-matrix agglomerative linkage for
//     single/complete/average via Müllner's nearest-neighbor-chain
//     algorithm (reference call site: falcon/cluster/cluster.py:285).
//   - scipy.cluster.hierarchy.fcluster(..., "distance"): flat-cluster
//     extraction by cutting the sorted linkage at a threshold (reference:
//     falcon/cluster/cluster.py:283-290, 413-421).
//   - union-find connected components for the density-clustering (DBSCAN
//     with min_samples) engine of the published algorithm.
//   - the ann engine's per-component linkage, cut, precursor split and
//     medoids, a batch of eps-components a call (fc_link_components).
//   - the CSV export's natural sort of a tie group's ids on keys encoded
//     once (fc_natsort_visits) and its rows, formatted on threads and
//     written to the file (fc_export_rows).
//
// Exposed via a plain C ABI for ctypes binding (no pybind11 dependency).
//
// Build: make -C native   ->  native/libfalcon_native.so

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <functional>
#include <limits>
#include <numeric>
#include <string>
#include <thread>
#include <vector>

#include <unistd.h>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

// Condensed index for i < j in an n x n matrix.
inline int64_t condensed_index(int64_t n, int64_t i, int64_t j) {
  return n * i + j - ((i + 2) * (i + 1)) / 2;
}

enum Method { SINGLE = 0, COMPLETE = 1, AVERAGE = 2 };

struct Merge {
  int64_t a, b;   // representative point indices of the merged clusters
  double dist;
};

// Union-find with scipy-style cluster labeling: each union gets label
// n + t for merge step t.
class LabeledUnionFind {
 public:
  explicit LabeledUnionFind(int64_t n)
      : parent_(2 * n - 1, -1), next_label_(n) {}

  int64_t find(int64_t x) {
    int64_t root = x;
    while (parent_[root] != -1) root = parent_[root];
    while (parent_[x] != -1) {  // path compression
      int64_t next = parent_[x];
      parent_[x] = root;
      x = next;
    }
    return root;
  }

  // Merge the clusters containing points a, b; returns their labels.
  void merge(int64_t root_a, int64_t root_b) {
    parent_[root_a] = next_label_;
    parent_[root_b] = next_label_;
    ++next_label_;
  }

 private:
  std::vector<int64_t> parent_;
  int64_t next_label_;
};

}  // namespace

namespace {

// Agglomerative clustering of a condensed distance matrix.
//
//   d: condensed upper-triangle distances, length n*(n-1)/2 (float64),
//      CLOBBERED as workspace.
//   n: number of observations (n >= 2).
//   method: 0 = single, 1 = complete, 2 = average.
//   z_out: (n-1) * 4 doubles, scipy linkage format — rows sorted by merge
//      distance; columns (cluster_a, cluster_b, distance, size) with
//      original observations 0..n-1 and merged cluster t labeled n+t.
//
// Returns 0 on success, 1 on bad arguments, 2 if the distances are not
// all finite (NaN/inf break the nearest-neighbor comparisons below —
// the chain walk would index out of bounds, so they are rejected up
// front, matching scipy's finiteness contract for linkage inputs).
int fc_linkage_impl(double* d, int64_t n, int method, double* z_out) {
  if (n < 2 || method < 0 || method > 2) return 1;
  const int64_t n_dists = n * (n - 1) / 2;
  for (int64_t i = 0; i < n_dists; ++i) {
    if (!std::isfinite(d[i])) return 2;
  }

  std::vector<int64_t> size(n, 1);
  std::vector<uint8_t> active(n, 1);
  std::vector<int64_t> chain;
  chain.reserve(n);
  std::vector<Merge> merges;
  merges.reserve(n - 1);

  auto dget = [&](int64_t i, int64_t j) -> double& {
    return i < j ? d[condensed_index(n, i, j)]
                 : d[condensed_index(n, j, i)];
  };

  int64_t first_active = 0;
  for (int64_t step = 0; step < n - 1; ++step) {
    if (chain.empty()) {
      while (!active[first_active]) ++first_active;
      chain.push_back(first_active);
    }
    int64_t a, b;
    double min_dist;
    for (;;) {
      a = chain.back();
      // Nearest active neighbor of a; prefer the chain predecessor so
      // reciprocal pairs terminate the walk (Müllner 2011, nn_chain).
      if (chain.size() > 1) {
        b = chain[chain.size() - 2];
        min_dist = dget(a, b);
      } else {
        b = -1;
        min_dist = kInf;
      }
      for (int64_t i = 0; i < n; ++i) {
        if (!active[i] || i == a) continue;
        double dist = dget(a, i);
        if (dist < min_dist) {
          min_dist = dist;
          b = i;
        }
      }
      if (chain.size() > 1 && b == chain[chain.size() - 2]) break;
      if (b < 0) return 3;  // unreachable with finite d; never index by it
      chain.push_back(b);
    }
    // Merge a and b (reciprocal nearest neighbors).
    chain.pop_back();
    chain.pop_back();
    merges.push_back({a, b, min_dist});

    // Lance-Williams update into b's row; deactivate a.
    int64_t sa = size[a], sb = size[b];
    for (int64_t i = 0; i < n; ++i) {
      if (!active[i] || i == a || i == b) continue;
      double da = dget(a, i), db = dget(b, i);
      double nd;
      switch (method) {
        case SINGLE:
          nd = da < db ? da : db;
          break;
        case COMPLETE:
          nd = da > db ? da : db;
          break;
        default:  // AVERAGE
          nd = (static_cast<double>(sa) * da +
                static_cast<double>(sb) * db) /
               static_cast<double>(sa + sb);
      }
      dget(b, i) = nd;
    }
    size[b] = sa + sb;
    active[a] = 0;
  }

  // Sort merges by distance (stable: preserves merge order on ties) and
  // relabel with a union-find, as fastcluster/scipy do.
  std::vector<int64_t> order(merges.size());
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t x, int64_t y) {
                     return merges[x].dist < merges[y].dist;
                   });
  LabeledUnionFind uf(n);
  std::vector<int64_t> root_label(2 * n - 1);
  std::iota(root_label.begin(), root_label.end(), 0);
  std::vector<int64_t> cluster_size(2 * n - 1, 1);
  for (size_t t = 0; t < order.size(); ++t) {
    const Merge& m = merges[order[t]];
    int64_t ra = uf.find(m.a), rb = uf.find(m.b);
    int64_t la = root_label[ra], lb = root_label[rb];
    if (la > lb) std::swap(la, lb);
    int64_t new_size = cluster_size[ra] + cluster_size[rb];
    z_out[4 * t + 0] = static_cast<double>(la);
    z_out[4 * t + 1] = static_cast<double>(lb);
    z_out[4 * t + 2] = m.dist;
    z_out[4 * t + 3] = static_cast<double>(new_size);
    uf.merge(ra, rb);
    int64_t new_root = uf.find(m.a);
    root_label[new_root] = n + static_cast<int64_t>(t);
    cluster_size[new_root] = new_size;
  }
  return 0;
}

// Flat clusters by cutting a linkage at a distance threshold, matching
// scipy's fcluster(Z, t, criterion="distance") for monotone linkages:
// observations whose cophenetic distance is <= t share a flat cluster.
// Labels are 0-based and numbered by first occurrence in leaf order
// (scipy numbers 1..k by leaf traversal; callers only rely on grouping,
// cf. falcon/cluster/cluster.py:283-311 which re-sorts by label).
//
//   z: (n-1) x 4 linkage, rows sorted ascending by distance.
//   labels_out: n int32 labels.
// Returns the number of flat clusters, or -1 on error.
int64_t fc_fcluster_impl(const double* z, int64_t n, double t,
                    int32_t* labels_out) {
  if (n < 1) return -1;
  if (n == 1) {
    labels_out[0] = 0;
    return 1;
  }
  // Union merges with distance <= t.  Linkage rows refer to cluster ids;
  // map cluster id -> current flat root via parent table.
  std::vector<int64_t> parent(2 * n - 1);
  std::iota(parent.begin(), parent.end(), 0);
  std::function<int64_t(int64_t)> find = [&](int64_t x) {
    int64_t root = x;
    while (parent[root] != root) root = parent[root];
    while (parent[x] != root) {
      int64_t next = parent[x];
      parent[x] = root;
      x = next;
    }
    return root;
  };
  for (int64_t row = 0; row < n - 1; ++row) {
    double dist = z[4 * row + 2];
    if (dist > t) break;  // rows sorted ascending
    int64_t node = n + row;
    // Bounds-check the cluster ids BEFORE casting/indexing: a corrupt
    // Z (NaN or out-of-range id) must error, not index out of bounds.
    // NaN fails both comparisons, so it is rejected here too.
    double fa = z[4 * row + 0], fb = z[4 * row + 1];
    if (!(fa >= 0 && fa < static_cast<double>(node)) ||
        !(fb >= 0 && fb < static_cast<double>(node))) {
      return -1;
    }
    int64_t a = static_cast<int64_t>(fa);
    int64_t b = static_cast<int64_t>(fb);
    parent[find(a)] = node;
    parent[find(b)] = node;
  }
  // Number flat clusters by first occurrence over observations.
  std::vector<int32_t> root_to_label(2 * n - 1, -1);
  int32_t next = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t r = find(i);
    if (root_to_label[r] < 0) root_to_label[r] = next++;
    labels_out[i] = root_to_label[r];
  }
  return next;
}

namespace {

// An ASCII digit, in a numpy U-dtype (UTF-32) string.
inline bool u32_digit(uint32_t c) { return c >= '0' && c <= '9'; }

// True end of a NUL-padded fixed-width slot.
inline const uint32_t* u32_trim(const uint32_t* s, int64_t width) {
  const uint32_t* e = s + width;
  while (e > s && e[-1] == 0) --e;
  return e;
}

// Run task(0..t-1) on worker threads.  Thread construction can throw
// std::system_error (EAGAIN near the process thread limit); an
// exception escaping the extern "C"/ctypes boundary would
// std::terminate() the embedding Python process, so any tasks whose
// thread failed to start run serially on this thread instead.  Tasks
// operate on disjoint chunks, so serial-after-parallel is safe.
// Exceptions thrown INSIDE a pool thread (e.g. std::bad_alloc in a
// sort buffer) are captured per-thread and the first one rethrown on
// the calling thread after every thread has joined — an uncaught
// exception in a std::thread would std::terminate() regardless of the
// callers' noexcept barriers.
inline void run_chunked(int t, const std::function<void(int)>& task) {
  std::vector<std::thread> pool;
  std::vector<std::exception_ptr> errors(t);
  int started = 0;
  try {
    pool.reserve(t);
    for (; started < t; ++started) {
      int idx = started;
      pool.emplace_back([&task, &errors, idx] {
        try {
          task(idx);
        } catch (...) {
          errors[idx] = std::current_exception();
        }
      });
    }
  } catch (...) {
  }
  try {
    for (int i = started; i < t; ++i) task(i);
  } catch (...) {
    // Join the already-started pool threads before rethrowing: letting
    // the exception unwind past joinable std::thread destructors would
    // std::terminate() the process.
    for (auto& th : pool) th.join();
    throw;
  }
  for (auto& th : pool) th.join();
  for (auto& e : errors) {
    if (e) std::rethrow_exception(e);
  }
}

}  // namespace

// Connected components over an undirected edge list.
//   u, v: edge endpoints (n_edges), nodes in [0, n_nodes).
//   labels_out: n_nodes int32 component ids, numbered by first occurrence.
// Returns the number of components.
int64_t fc_connected_components_impl(const int64_t* u, const int64_t* v,
                                int64_t n_edges, int64_t n_nodes,
                                int32_t* labels_out) {
  if (n_nodes < 0 || n_edges < 0) return -1;
  for (int64_t e = 0; e < n_edges; ++e) {
    // An out-of-range endpoint would index the parent table out of
    // bounds; reject the edge list instead.
    if (u[e] < 0 || u[e] >= n_nodes || v[e] < 0 || v[e] >= n_nodes) {
      return -1;
    }
  }
  std::vector<int64_t> parent(n_nodes);
  std::iota(parent.begin(), parent.end(), 0);
  std::function<int64_t(int64_t)> find = [&](int64_t x) {
    int64_t root = x;
    while (parent[root] != root) root = parent[root];
    while (parent[x] != root) {
      int64_t next = parent[x];
      parent[x] = root;
      x = next;
    }
    return root;
  };
  for (int64_t e = 0; e < n_edges; ++e) {
    int64_t ru = find(u[e]), rv = find(v[e]);
    if (ru != rv) parent[ru] = rv;
  }
  std::vector<int32_t> root_to_label(n_nodes, -1);
  int32_t next = 0;
  for (int64_t i = 0; i < n_nodes; ++i) {
    int64_t r = find(i);
    if (root_to_label[r] < 0) root_to_label[r] = next++;
    labels_out[i] = root_to_label[r];
  }
  return next;
}

}  // namespace

namespace {

// Append Python's repr of a float (CPython float_repr /
// PyOS_double_to_string('r') semantics, which csv.writer reaches via
// str()): shortest round-trip digits; fixed-point notation when the
// decimal point lands in (-4, 16], otherwise scientific with a signed,
// at-least-two-digit exponent; nan/inf spelled Python-style.  The
// shortest digit string comes from std::to_chars (both it and CPython
// produce the unique shortest correctly-rounded representation);
// byte-for-byte parity with str(float) is enforced by
// tests/test_torch_export.py.
// Shortest round-trip digit string of a positive finite value via
// std::to_chars scientific; sets decpt so that value = 0.<digits> *
// 10^decpt.  Returns the digit count.
template <typename T>
int shortest_digits(T v, char* digits, int* decpt) {
  char buf[48];
  auto res = std::to_chars(buf, buf + sizeof(buf), v,
                           std::chars_format::scientific);
  const char* e = std::find(static_cast<const char*>(buf),
                            static_cast<const char*>(res.ptr), 'e');
  int n_digits = 0;
  for (const char* p = buf; p != e; ++p)
    if (*p != '.') digits[n_digits++] = *p;
  const char* p = e + 1;
  bool neg_exp = *p == '-';
  if (*p == '-' || *p == '+') ++p;
  int exp10 = 0;
  while (p != res.ptr) exp10 = exp10 * 10 + (*p++ - '0');
  if (neg_exp) exp10 = -exp10;
  *decpt = exp10 + 1;
  return n_digits;
}

// Assemble a repr from shortest digits: positional with a guaranteed
// fractional part (trailing ".0"), or scientific with a signed,
// zero-padded, at-least-two-digit exponent — the shared shape of
// CPython's and numpy's float formatting.
void assemble_float_repr(std::string& out, const char* digits,
                         int n_digits, int decpt, bool positional) {
  if (!positional) {  // scientific
    out += digits[0];
    if (n_digits > 1) {
      out += '.';
      out.append(digits + 1, n_digits - 1);
    }
    out += 'e';
    int ex = decpt - 1;
    out += ex < 0 ? '-' : '+';
    ex = std::abs(ex);
    char eb[8];
    auto er = std::to_chars(eb, eb + sizeof(eb), ex);
    if (er.ptr - eb < 2) out += '0';
    out.append(eb, er.ptr - eb);
  } else if (decpt <= 0) {  // 0.00<digits>
    out += "0.";
    out.append(-decpt, '0');
    out.append(digits, n_digits);
  } else if (decpt >= n_digits) {  // <digits>00.0
    out.append(digits, n_digits);
    out.append(decpt - n_digits, '0');
    out += ".0";
  } else {  // <dig.its>
    out.append(digits, decpt);
    out += '.';
    out.append(digits + decpt, n_digits - decpt);
  }
}

void append_py_float_repr(std::string& out, double v) {
  if (std::isnan(v)) {
    out += "nan";
    return;
  }
  if (std::isinf(v)) {
    out += v < 0 ? "-inf" : "inf";
    return;
  }
  if (v == 0.0) {
    out += std::signbit(v) ? "-0.0" : "0.0";
    return;
  }
  if (v < 0) {
    out += '-';
    v = -v;
  }
  char digits[24];
  int decpt;
  int n_digits = shortest_digits(v, digits, &decpt);
  // CPython: positional iff the decimal point lands in (-4, 16].
  assemble_float_repr(out, digits, n_digits, decpt,
                      decpt > -4 && decpt <= 16);
}

// str(np.float32(v)): shortest digits that round-trip in FLOAT32 (not
// the widened double), positional iff 1e-4 <= |v| < 1e16 — numpy
// decides on the VALUE, unlike CPython's decimal-point rule, so e.g.
// np.float32(1e-4) (= 9.9999997e-05) prints '1e-04' where its shortest
// digits alone would say '0.0001'.  Neither threshold is exactly
// representable in float32, so the comparison never lands on the
// boundary.  Parity with str(np.float32) is fuzzed in
// tests/test_torch_export.py.
void append_np_f32_repr(std::string& out, float v) {
  if (std::isnan(v)) {
    out += "nan";
    return;
  }
  if (std::isinf(v)) {
    out += v < 0 ? "-inf" : "inf";
    return;
  }
  if (v == 0.0f) {
    out += std::signbit(v) ? "-0.0" : "0.0";
    return;
  }
  if (v < 0) {
    out += '-';
    v = -v;
  }
  char digits[16];
  int decpt;
  int n_digits = shortest_digits(v, digits, &decpt);
  double a = static_cast<double>(v);
  assemble_float_repr(out, digits, n_digits, decpt,
                      a >= 1e-4 && a < 1e16);
}

inline void append_utf8(std::string& out, uint32_t c) {
  if (c < 0x80) {
    out += static_cast<char>(c);
  } else if (c < 0x800) {
    out += static_cast<char>(0xC0 | (c >> 6));
    out += static_cast<char>(0x80 | (c & 0x3F));
  } else if (c < 0x10000) {
    out += static_cast<char>(0xE0 | (c >> 12));
    out += static_cast<char>(0x80 | ((c >> 6) & 0x3F));
    out += static_cast<char>(0x80 | (c & 0x3F));
  } else {
    out += static_cast<char>(0xF0 | (c >> 18));
    out += static_cast<char>(0x80 | ((c >> 12) & 0x3F));
    out += static_cast<char>(0x80 | ((c >> 6) & 0x3F));
    out += static_cast<char>(0x80 | (c & 0x3F));
  }
}

// csv.QUOTE_MINIMAL: quote a field iff it contains the delimiter, the
// quote char, or a CR/LF (CPython checks '\r' and '\n' regardless of
// the configured lineterminator — verified empirically); embedded
// quotes are doubled.  Input is UTF-32 code points, output UTF-8.
void append_csv_str_field(std::string& out, const uint32_t* s,
                          const uint32_t* end) {
  bool quote = false;
  for (const uint32_t* p = s; p != end; ++p) {
    uint32_t c = *p;
    if (c == ',' || c == '"' || c == '\n' || c == '\r') {
      quote = true;
      break;
    }
  }
  if (quote) out += '"';
  for (const uint32_t* p = s; p != end; ++p) {
    if (*p == '"') out += '"';
    append_utf8(out, *p);
  }
  if (quote) out += '"';
}

void append_int64(std::string& out, int64_t v) {
  char buf[24];
  auto r = std::to_chars(buf, buf + sizeof(buf), v);
  out.append(buf, r.ptr - buf);
}

}  // namespace

// One visit of an export tie group: the `n` rows one shard holds of the
// group's files, each column as loaded (numpy U columns are fixed-width
// UTF-32, NUL-padded, widths in code units).  `filename_const` set: the
// one slot `filename` names every row; else `filename` is a column.
struct ExportVisit {
  int64_t n;
  const uint32_t* filename;
  int64_t filename_width;
  int64_t filename_const;
  const uint32_t* id;
  int64_t id_width;
  const int64_t* charge;
  const void* mz;
  int64_t mz_f32;
  const void* rt;
  int64_t rt_f32;
  const int64_t* cluster;
};

namespace {

// Rows at or above which the export kernels split their work over
// threads (below it a thread's start costs more than it saves).
constexpr int64_t kExportParallelRows = 1 << 14;

// Row offsets of the visits, one after the other (n_visits + 1).
std::vector<int64_t> visit_starts(const ExportVisit* v, int64_t n_visits) {
  std::vector<int64_t> starts(n_visits + 1, 0);
  for (int64_t i = 0; i < n_visits; ++i) starts[i + 1] = starts[i] + v[i].n;
  return starts;
}

// The visit that holds row r.
inline int64_t visit_of(const std::vector<int64_t>& starts, int64_t r) {
  return std::upper_bound(starts.begin() + 1, starts.end(), r)
         - (starts.begin() + 1);
}

// Write the order-preserving byte key of a UTF-32 string at p, which has
// room for nat_key_bound bytes, and return its end: two keys compare by
// memcmp, a prefix first, as utils/natsort.py's natsort_key orders their
// strings (digit runs numerically, leading zeros ignored, before text at
// the same position; text by code point; an ended string first), with
// ASCII digits as the digits.  Runs, in turn:
//   digit run: 0x01, the count of its digits without leading zeros (one
//     byte under 255, else 0xFF and eight bytes big-endian), then those
//     digits two to a byte; so numerically equal runs give equal bytes;
//   text run: 0x02, each code point in UTF-8's byte order (which is code
//     point order; NUL as 0x00 0x01, and above 0x1FFFFF as 0xF8 and four
//     bytes big-endian), then 0x00 0x00, below every code point.
// A digit run's tag sorts before a text run's, and an ended string before
// either.
unsigned char* write_nat_key(unsigned char* p, const uint32_t* s,
                             const uint32_t* end) {
  while (s < end) {
    if (u32_digit(*s)) {
      const uint32_t* e = s;
      while (e < end && u32_digit(*e)) ++e;
      while (s < e && *s == '0') ++s;
      uint64_t len = static_cast<uint64_t>(e - s);
      *p++ = 0x01;
      if (len < 0xFF) {
        *p++ = static_cast<unsigned char>(len);
      } else {
        *p++ = 0xFF;
        for (int shift = 56; shift >= 0; shift -= 8)
          *p++ = static_cast<unsigned char>(len >> shift);
      }
      for (; s + 1 < e; s += 2)
        *p++ = static_cast<unsigned char>(((s[0] - '0') << 4) | (s[1] - '0'));
      if (s < e) *p++ = static_cast<unsigned char>((*s++ - '0') << 4);
    } else {
      *p++ = 0x02;
      for (; s < end && !u32_digit(*s); ++s) {
        uint32_t c = *s;
        if (c - 1 < 0x7F) {  // 1..0x7F
          *p++ = static_cast<unsigned char>(c);
        } else if (c == 0) {
          *p++ = 0x00;
          *p++ = 0x01;
        } else if (c < 0x800) {
          *p++ = static_cast<unsigned char>(0xC0 | (c >> 6));
          *p++ = static_cast<unsigned char>(0x80 | (c & 0x3F));
        } else if (c < 0x10000) {
          *p++ = static_cast<unsigned char>(0xE0 | (c >> 12));
          *p++ = static_cast<unsigned char>(0x80 | ((c >> 6) & 0x3F));
          *p++ = static_cast<unsigned char>(0x80 | (c & 0x3F));
        } else if (c < 0x200000) {
          *p++ = static_cast<unsigned char>(0xF0 | (c >> 18));
          *p++ = static_cast<unsigned char>(0x80 | ((c >> 12) & 0x3F));
          *p++ = static_cast<unsigned char>(0x80 | ((c >> 6) & 0x3F));
          *p++ = static_cast<unsigned char>(0x80 | (c & 0x3F));
        } else {
          *p++ = 0xF8;
          for (int shift = 24; shift >= 0; shift -= 8)
            *p++ = static_cast<unsigned char>(c >> shift);
        }
      }
      *p++ = 0x00;
      *p++ = 0x00;
    }
  }
  return p;
}

// Bytes enough for the key of a string of `len` code points: a run of k
// code points takes at most 5k + 10.
inline size_t nat_key_bound(int64_t len) {
  return static_cast<size_t>(len) * 15 + 16;
}

struct NatItem {
  const unsigned char* key;
  int64_t len;
  int64_t row;
};

// Keys in memcmp order, then rows: a strict total order, so any sort of
// it gives the stable natural order.
inline bool nat_item_less(const NatItem& a, const NatItem& b) {
  int c = std::memcmp(a.key, b.key,
                      static_cast<size_t>(std::min(a.len, b.len)));
  if (c != 0) return c < 0;
  if (a.len != b.len) return a.len < b.len;
  return a.row < b.row;
}

// Rows of the visits (numbered visit after visit) in natural order of
// their ids, ties in row order (parity with the JAX package's native
// natural sort in tests/test_torch_natsort.py).  Each id is encoded once
// (write_nat_key); on several threads a sample sort cuts the keys into
// buckets by splitters drawn from an even sample, and the threads sort
// whole buckets, so no merge of all rows runs on one thread.
void natsort_visits(const ExportVisit* v, int64_t n_visits,
                    int64_t* order_out, int threads) {
  std::vector<int64_t> starts = visit_starts(v, n_visits);
  const int64_t n = starts.back();
  if (n == 0) return;
  const int t = (threads <= 1 || n < kExportParallelRows)
                    ? 1 : static_cast<int>(std::min<int64_t>(threads, n));
  std::vector<NatItem> items(n);
  std::vector<std::vector<unsigned char>> arenas(t);
  run_chunked(t, [&](int i) {
    const int64_t lo = n * i / t, hi = n * (i + 1) / t;
    std::vector<unsigned char>& arena = arenas[i];
    size_t used = 0;
    int64_t vi = visit_of(starts, lo);
    for (int64_t r = lo; r < hi; ++r) {
      while (r >= starts[vi + 1]) ++vi;
      const uint32_t* id = v[vi].id + (r - starts[vi]) * v[vi].id_width;
      const uint32_t* end = u32_trim(id, v[vi].id_width);
      const size_t room = used + nat_key_bound(end - id);
      if (room > arena.size()) arena.resize(std::max(room, 2 * arena.size()));
      items[r].len = static_cast<int64_t>(used);
      items[r].row = r;
      used = write_nat_key(arena.data() + used, id, end) - arena.data();
    }
    for (int64_t r = lo; r < hi; ++r) {
      int64_t begin = items[r].len;
      int64_t end = r + 1 < hi ? items[r + 1].len : static_cast<int64_t>(used);
      items[r].key = arena.data() + begin;
      items[r].len = end - begin;
    }
  });
  if (t == 1) {
    std::sort(items.begin(), items.end(), nat_item_less);
  } else {
    const int n_buckets = 4 * t;
    const int64_t n_sample = std::min<int64_t>(n, 64 * n_buckets);
    std::vector<NatItem> sample(n_sample);
    for (int64_t j = 0; j < n_sample; ++j) sample[j] = items[j * n / n_sample];
    std::sort(sample.begin(), sample.end(), nat_item_less);
    std::vector<NatItem> splitters;
    for (int b = 1; b < n_buckets; ++b)
      splitters.push_back(sample[b * n_sample / n_buckets]);
    std::vector<int32_t> bucket(n);
    std::vector<int64_t> counts(static_cast<size_t>(t) * n_buckets, 0);
    run_chunked(t, [&](int i) {
      int64_t* count = counts.data() + static_cast<size_t>(i) * n_buckets;
      for (int64_t r = n * i / t; r < n * (i + 1) / t; ++r) {
        bucket[r] = static_cast<int32_t>(
            std::upper_bound(splitters.begin(), splitters.end(), items[r],
                             nat_item_less) - splitters.begin());
        ++count[bucket[r]];
      }
    });
    // Where thread i's rows of bucket b go: buckets in order, and within
    // a bucket the threads' rows in thread order.
    std::vector<int64_t> bucket_start(n_buckets + 1, 0);
    std::vector<int64_t> at(counts.size());
    int64_t pos = 0;
    for (int b = 0; b < n_buckets; ++b) {
      bucket_start[b] = pos;
      for (int i = 0; i < t; ++i) {
        at[static_cast<size_t>(i) * n_buckets + b] = pos;
        pos += counts[static_cast<size_t>(i) * n_buckets + b];
      }
    }
    bucket_start[n_buckets] = pos;
    std::vector<NatItem> sorted(n);
    run_chunked(t, [&](int i) {
      int64_t* next = at.data() + static_cast<size_t>(i) * n_buckets;
      for (int64_t r = n * i / t; r < n * (i + 1) / t; ++r)
        sorted[next[bucket[r]]++] = items[r];
    });
    std::atomic<int> next_bucket{0};
    run_chunked(t, [&](int) {
      for (int b; (b = next_bucket.fetch_add(1)) < n_buckets;)
        std::sort(sorted.begin() + bucket_start[b],
                  sorted.begin() + bucket_start[b + 1], nat_item_less);
    });
    items.swap(sorted);
  }
  for (int64_t k = 0; k < n; ++k) order_out[k] = items[k].row;
}

// Append one cluster-assignment CSV row
// (filename,spectrum_id,precursor_charge,precursor_mz,retention_time,
// cluster) byte-for-byte like csv.writer(lineterminator="\n") fed str()
// of the same values (the export path's Python fallback): charge ==
// null_charge renders as an empty field; the float columns keep their
// storage precision (str(np.float32) for float32, the store's dtype,
// else str(float)).  `filename` is the row's file name field, already
// quoted and encoded.
void append_csv_row(std::string& out, const ExportVisit& v, int64_t i,
                    const std::string& filename, int64_t null_charge) {
  out += filename;
  out += ',';
  const uint32_t* id = v.id + i * v.id_width;
  append_csv_str_field(out, id, u32_trim(id, v.id_width));
  out += ',';
  if (v.charge[i] != null_charge) append_int64(out, v.charge[i]);
  out += ',';
  if (v.mz_f32)
    append_np_f32_repr(out, static_cast<const float*>(v.mz)[i]);
  else
    append_py_float_repr(out, static_cast<const double*>(v.mz)[i]);
  out += ',';
  if (v.rt_f32)
    append_np_f32_repr(out, static_cast<const float*>(v.rt)[i]);
  else
    append_py_float_repr(out, static_cast<const double*>(v.rt)[i]);
  out += ',';
  append_int64(out, v.cluster[i]);
  out += '\n';
}

// write(2) all of [data, data + len) to fd; false (errno set) on failure.
bool write_all(int fd, const char* data, size_t len) {
  while (len > 0) {
    ssize_t w = ::write(fd, data, len);
    if (w < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    data += w;
    len -= static_cast<size_t>(w);
  }
  return true;
}

// Write the visits' rows in `order` (n row numbers, visit after visit)
// to fd as CSV rows, chunk_rows rows at a time: each chunk is formatted
// in slices on threads, reading every column in place and each constant
// file name from one encoded copy, and the slices are written in order.
// Returns the bytes written; -1 on a row number out of range; -2 on a
// failed write, with its errno in *err.
int64_t export_rows(int fd, const ExportVisit* v, int64_t n_visits,
                    const int64_t* order, int64_t n, int64_t null_charge,
                    int64_t chunk_rows, int threads, int* err) {
  std::vector<int64_t> starts = visit_starts(v, n_visits);
  const int64_t n_all = starts.back();
  std::vector<std::string> const_names(n_visits);
  for (int64_t i = 0; i < n_visits; ++i) {
    if (v[i].filename_const)
      append_csv_str_field(const_names[i], v[i].filename,
                           u32_trim(v[i].filename, v[i].filename_width));
  }
  chunk_rows = std::max<int64_t>(chunk_rows, 1);
  std::vector<std::string> parts(std::max(threads, 1));
  std::vector<char> bad(parts.size(), 0);
  int64_t written = 0;
  for (int64_t c0 = 0; c0 < n; c0 += chunk_rows) {
    const int64_t m = std::min(chunk_rows, n - c0);
    const int t = (threads <= 1 || m < kExportParallelRows)
                      ? 1 : static_cast<int>(std::min<int64_t>(threads, m));
    run_chunked(t, [&](int i) {
      std::string& out = parts[i];
      std::string name;
      out.clear();
      const int64_t lo = c0 + m * i / t, hi = c0 + m * (i + 1) / t;
      out.reserve(static_cast<size_t>(hi - lo) * 96);
      for (int64_t k = lo; k < hi; ++k) {
        const int64_t r = order[k];
        if (r < 0 || r >= n_all) {
          bad[i] = 1;
          return;
        }
        const int64_t vi = visit_of(starts, r);
        const int64_t row = r - starts[vi];
        const ExportVisit& visit = v[vi];
        if (visit.filename_const) {
          append_csv_row(out, visit, row, const_names[vi], null_charge);
        } else {
          const uint32_t* fn = visit.filename + row * visit.filename_width;
          name.clear();
          append_csv_str_field(name, fn, u32_trim(fn, visit.filename_width));
          append_csv_row(out, visit, row, name, null_charge);
        }
      }
    });
    for (int i = 0; i < t; ++i) {
      if (bad[i]) return -1;
    }
    for (int i = 0; i < t; ++i) {
      if (!write_all(fd, parts[i].data(), parts[i].size())) {
        *err = errno;
        return -2;
      }
      written += static_cast<int64_t>(parts[i].size());
    }
  }
  return written;
}

}  // namespace

namespace {

// Linkage, cut, precursor split and medoids of a batch of eps-components,
// the per-component body of falcon_tpu_torch/cluster/postprocess.py's
// link_component (its oracle in tests/test_torch_linkage_batch.py) in one
// call: the spans and comparisons are made in the dtypes and order the
// NumPy code makes them, NaN included, so the labels and medoids are its
// own.

// NumPy's min / max of float64 (a NaN wins) and Python's max(a, b).
inline double np_min(const double* v, int64_t n) {
  double m = v[0];
  for (int64_t i = 1; i < n; ++i) {
    if (std::isnan(v[i])) return v[i];
    if (v[i] < m) m = v[i];
  }
  return m;
}
inline double np_max(const double* v, int64_t n) {
  double m = v[0];
  for (int64_t i = 1; i < n; ++i) {
    if (std::isnan(v[i])) return v[i];
    if (v[i] > m) m = v[i];
  }
  return m;
}
inline double py_max(double a, double b) { return b > a ? b : a; }
inline double py_min(double a, double b) { return b < a ? b : a; }

// The precursor (and, with rt, RT) span test of the whole() check and of
// postprocess_cluster's fast path, on n gathered values.
bool spans_ok(const double* mz, const double* rt, int64_t n, double tol_mass,
              bool ppm, double rt_tol) {
  double lo = np_min(mz, n);
  double span = np_max(mz, n) - lo;
  bool ok = ppm ? span / py_max(lo, 1e-12) * 1e6 <= tol_mass
                : span <= tol_mass;
  if (ok && rt != nullptr) ok = np_max(rt, n) - np_min(rt, n) <= rt_tol;
  return ok;
}

// An entry of cut_1d's heap, ordered as Python orders the tuple
// (d, a, b, va, vb): the first element that is not == decides by <.
struct CutEntry {
  double d;
  int64_t a, b, va, vb;
};
inline bool py_lt(const CutEntry& x, const CutEntry& y) {
  if (!(x.d == y.d)) return x.d < y.d;
  if (x.a != y.a) return x.a < y.a;
  if (x.b != y.b) return x.b < y.b;
  if (x.va != y.va) return x.va < y.va;
  return x.vb < y.vb;
}

// heapq's _siftdown, _siftup, heapify, heappush and heappop, so that
// entries that Python cannot order (a NaN distance) pop in Python's order
// too.
void heap_siftdown(std::vector<CutEntry>& h, size_t start, size_t pos) {
  CutEntry item = h[pos];
  while (pos > start) {
    size_t parent = (pos - 1) >> 1;
    if (!py_lt(item, h[parent])) break;
    h[pos] = h[parent];
    pos = parent;
  }
  h[pos] = item;
}
void heap_siftup(std::vector<CutEntry>& h, size_t pos) {
  size_t end = h.size(), start = pos;
  CutEntry item = h[pos];
  size_t child = 2 * pos + 1;
  while (child < end) {
    size_t right = child + 1;
    if (right < end && !py_lt(h[child], h[right])) child = right;
    h[pos] = h[child];
    pos = child;
    child = 2 * pos + 1;
  }
  h[pos] = item;
  heap_siftdown(h, start, pos);
}
void heap_push(std::vector<CutEntry>& h, const CutEntry& e) {
  h.push_back(e);
  heap_siftdown(h, 0, h.size() - 1);
}
CutEntry heap_pop(std::vector<CutEntry>& h) {
  CutEntry last = h.back();
  h.pop_back();
  if (h.empty()) return last;
  CutEntry top = h[0];
  h[0] = last;
  heap_siftup(h, 0);
  return top;
}

// numpy's stable argsort of float64: ascending, NaNs last.
void argsort_stable(const double* v, int64_t n, std::vector<int64_t>& out) {
  out.resize(n);
  std::iota(out.begin(), out.end(), 0);
  std::stable_sort(out.begin(), out.end(), [v](int64_t x, int64_t y) {
    return v[x] < v[y] || (!std::isnan(v[x]) && std::isnan(v[y]));
  });
}

// intervals.py's cut_1d: the complete-linkage cut at tol of k values,
// adjacent clusters merged in heap order.  Writes each value's group (the
// root's sorted position; only the grouping is used).
void cut_1d(const double* values, int64_t k, double tol, bool ppm,
            std::vector<int64_t>& group) {
  group.assign(k, 0);
  if (k < 2) return;
  std::vector<int64_t> order;
  argsort_stable(values, k, order);
  std::vector<double> cmin(k), cmax(k);
  for (int64_t i = 0; i < k; ++i) cmin[i] = cmax[i] = values[order[i]];
  std::vector<int64_t> parent(k), version(k, 0), left(k), right(k);
  for (int64_t i = 0; i < k; ++i) {
    parent[i] = i;
    left[i] = i - 1;
    right[i] = i + 1;
  }
  auto find = [&](int64_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  };
  auto dist = [&](int64_t a, int64_t b) {
    double d = cmax[b] - cmin[a];
    return ppm ? d / cmin[a] * 1e6 : d;
  };
  std::vector<CutEntry> heap;
  heap.reserve(2 * k);
  for (int64_t i = 0; i + 1 < k; ++i)
    heap.push_back({dist(i, i + 1), i, i + 1, 0, 0});
  for (size_t i = heap.size() / 2; i-- > 0;) heap_siftup(heap, i);
  while (!heap.empty()) {
    CutEntry e = heap_pop(heap);
    if (e.d > tol) break;
    int64_t a = e.a, b = e.b;
    if (find(a) != a || find(b) != b || right[a] != b ||
        version[a] != e.va || version[b] != e.vb)
      continue;
    parent[b] = a;
    cmax[a] = py_max(cmax[a], cmax[b]);
    cmin[a] = py_min(cmin[a], cmin[b]);
    ++version[a];
    int64_t r = right[b];
    right[a] = r;
    if (r < k) {
      left[r] = a;
      heap_push(heap, {dist(a, r), a, r, version[a], version[r]});
    }
    int64_t lft = left[a];
    if (lft >= 0 && find(lft) == lft)
      heap_push(heap, {dist(lft, a), lft, a, version[lft], version[a]});
  }
  for (int64_t i = 0; i < k; ++i) group[order[i]] = find(i);
}

// postprocess_cluster with min_samples 2 on one flat cluster of n members
// (gathered m/z and RT): labels the members start.. by first occurrence
// of their (m/z group, RT group), -1 for a group of one; returns the
// number of labels used.
int64_t split_cluster(const double* mz, const double* rt, int64_t n,
                      double tol_mass, bool ppm, double rt_tol,
                      int32_t start, int32_t* labels) {
  if (n < 2) {
    std::fill(labels, labels + n, -1);
    return 0;
  }
  if (spans_ok(mz, rt, n, tol_mass, ppm, rt_tol)) {
    std::fill(labels, labels + n, start);
    return 1;
  }
  std::vector<int64_t> g_mz, g_rt;
  cut_1d(mz, n, tol_mass, ppm, g_mz);
  if (rt != nullptr) {
    cut_1d(rt, n, rt_tol, false, g_rt);
    for (int64_t i = 0; i < n; ++i) g_mz[i] = g_mz[i] * n + g_rt[i];
  }
  // Groups numbered by first occurrence, then their sizes.
  std::vector<int64_t> key_ids(g_mz);
  std::sort(key_ids.begin(), key_ids.end());
  key_ids.erase(std::unique(key_ids.begin(), key_ids.end()), key_ids.end());
  std::vector<int64_t> group(n), first_seen(key_ids.size(), -1), count;
  int64_t n_groups = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t u = std::lower_bound(key_ids.begin(), key_ids.end(), g_mz[i]) -
                key_ids.begin();
    if (first_seen[u] < 0) {
      first_seen[u] = n_groups++;
      count.push_back(0);
    }
    group[i] = first_seen[u];
    ++count[group[i]];
  }
  std::vector<int32_t> remap(n_groups, -1);
  int32_t next = start;
  for (int64_t g = 0; g < n_groups; ++g)
    if (count[g] >= 2) remap[g] = next++;
  for (int64_t i = 0; i < n; ++i) labels[i] = remap[group[i]];
  return next - start;
}

// cluster_medoids' choice for one group of s members (rows into the
// component's condensed matrix of m rows, in the group's order): the first
// member (s <= 2), else the first minimum of the float32 row sums, each
// summed as two np.add.at passes over the triu pairs (row as ii, then as
// jj) sum it; a NaN sum is the minimum.
int64_t medoid_of(const float* pdist, int64_t m, const int64_t* rows,
                  int64_t s, std::vector<float>& row_sum) {
  if (s <= 2) return 0;
  row_sum.assign(s, 0.0f);
  auto d = [&](int64_t u, int64_t v) {
    int64_t a = rows[u], b = rows[v];
    if (a > b) std::swap(a, b);
    return pdist[condensed_index(m, a, b)];
  };
  for (int64_t u = 0; u < s; ++u)
    for (int64_t v = u + 1; v < s; ++v) row_sum[u] += d(u, v);
  for (int64_t u = 0; u < s; ++u)
    for (int64_t v = u + 1; v < s; ++v) row_sum[v] += d(u, v);
  int64_t best = 0;
  for (int64_t i = 0; i < s; ++i) {
    if (std::isnan(row_sum[i])) return i;
    if (row_sum[i] < row_sum[best]) best = i;
  }
  return best;
}

// See fc_link_components.
int64_t fc_link_components_impl(
    const float* dist, int64_t n_dist, const int64_t* comps, int64_t k,
    const int64_t* member_off, const double* mz, const double* rt,
    const int64_t* ids, int method, double eps, double eps_far,
    double tol_mass, int ppm,
    double rt_tol, int32_t* labels_out, int64_t* n_clusters_out,
    int64_t* medoids_out, int64_t* n_medoids_out) {
  std::vector<double> work, z;
  std::vector<int32_t> flat, sorted_labels;
  std::vector<int64_t> order1, rows;
  std::vector<double> mz_c, rt_c;
  std::vector<float> row_sum;
  int64_t n_whole = 0, pair_at = 0;
  for (int64_t t = 0; t < k; ++t) {
    const int64_t c = comps[t], off = member_off[c];
    const int64_t m = member_off[c + 1] - off;
    const int64_t n_pairs = m * (m - 1) / 2;
    if (m < 1 || pair_at + n_pairs > n_dist) return -1;
    const float* pdist = dist + pair_at;
    pair_at += n_pairs;
    const double* mz_m = mz + off;
    const double* rt_m = rt != nullptr ? rt + off : nullptr;
    int32_t* lab = labels_out + off;
    int64_t* med = medoids_out + off;

    // whole(): every distance within eps (a NaN maximum passes, as
    // NumPy's does) and the spans within tolerance.
    bool far = false, any_nan = false;
    for (int64_t i = 0; i < n_pairs; ++i) {
      any_nan |= std::isnan(pdist[i]);
      far |= static_cast<double>(pdist[i]) > eps_far;
    }
    if ((any_nan || !far) &&
        spans_ok(mz_m, rt_m, m, tol_mass, ppm != 0, rt_tol)) {
      std::fill(lab, lab + m, 0);
      rows.resize(m);
      std::iota(rows.begin(), rows.end(), 0);
      med[0] = ids[off + medoid_of(pdist, m, rows.data(), m, row_sum)];
      n_clusters_out[c] = 1;
      n_medoids_out[c] = 1;
      ++n_whole;
      continue;
    }

    // Link and cut at eps.
    work.assign(pdist, pdist + n_pairs);
    z.resize(4 * std::max<int64_t>(m - 1, 0));
    int rc = fc_linkage_impl(work.data(), m, method, z.data());
    if (rc == 2) return -2;
    if (rc != 0) return -3;
    flat.resize(m);
    if (fc_fcluster_impl(z.data(), m, eps, flat.data()) < 0) return -3;

    // Members in the stable order of their flat labels; each flat cluster
    // split by precursor (and RT).
    order1.resize(m);
    std::iota(order1.begin(), order1.end(), 0);
    std::stable_sort(order1.begin(), order1.end(),
                     [&](int64_t x, int64_t y) { return flat[x] < flat[y]; });
    sorted_labels.resize(m);
    mz_c.resize(m);
    if (rt_m != nullptr) rt_c.resize(m);
    for (int64_t i = 0; i < m; ++i) {
      sorted_labels[i] = flat[order1[i]];
      mz_c[i] = mz_m[order1[i]];
      if (rt_m != nullptr) rt_c[i] = rt_m[order1[i]];
    }
    int32_t current = 0;
    for (int64_t s = 0; s < m;) {
      int64_t e = s;
      while (e < m && flat[order1[e]] == flat[order1[s]]) ++e;
      current += static_cast<int32_t>(split_cluster(
          mz_c.data() + s, rt_m != nullptr ? rt_c.data() + s : nullptr, e - s,
          tol_mass, ppm != 0, rt_tol, current, sorted_labels.data() + s));
      s = e;
    }
    for (int64_t i = 0; i < m; ++i) lab[order1[i]] = sorted_labels[i];

    // Medoids in cluster_medoids' order: each demoted member, then the
    // clusters by label, members in their label-sorted order.
    int64_t n_med = 0;
    for (int64_t i = 0; i < m; ++i)
      if (sorted_labels[i] < 0) med[n_med++] = ids[off + order1[i]];
    std::vector<int64_t> starts(current + 1, 0);
    for (int64_t i = 0; i < m; ++i)
      if (sorted_labels[i] >= 0) ++starts[sorted_labels[i] + 1];
    for (int32_t l = 0; l < current; ++l) starts[l + 1] += starts[l];
    rows.resize(starts[current]);
    std::vector<int64_t> fill(starts.begin(), starts.end() - 1);
    for (int64_t i = 0; i < m; ++i)
      if (sorted_labels[i] >= 0) rows[fill[sorted_labels[i]]++] = order1[i];
    for (int32_t l = 0; l < current; ++l) {
      const int64_t* r = rows.data() + starts[l];
      int64_t s = starts[l + 1] - starts[l];
      med[n_med++] = ids[off + r[medoid_of(pdist, m, r, s, row_sum)]];
    }
    n_clusters_out[c] = current;
    n_medoids_out[c] = n_med;
  }
  return pair_at == n_dist ? n_whole : -1;
}

}  // namespace

// ---------------------------------------------------------------------------
// Public C ABI.  Each exported entry point is a noexcept exception barrier
// around its _impl: a C++ exception (std::bad_alloc from a vector/string,
// std::system_error from thread spawn) escaping a ctypes call would
// std::terminate() the embedding Python process, so the wrappers translate
// any throw into the function's error-return convention instead
// (falcon_tpu/native.py raises RuntimeError on these codes).
// ---------------------------------------------------------------------------

extern "C" {

int fc_linkage(double* d, int64_t n, int method, double* z_out) noexcept {
  try {
    return fc_linkage_impl(d, n, method, z_out);
  } catch (...) {
    return 4;  // internal error (e.g. allocation failure)
  }
}

int64_t fc_fcluster(const double* z, int64_t n, double t,
                    int32_t* labels_out) noexcept {
  try {
    return fc_fcluster_impl(z, n, t, labels_out);
  } catch (...) {
    return -1;
  }
}

// Link, cut, split and pick the medoids of a batch of eps-components, as
// falcon_tpu_torch/cluster/postprocess.py's link_component does one.
//   dist: the batch's condensed float32 distances, component after
//     component (n_dist in all).
//   comps: the k components of the batch; component c's members are rows
//     member_off[c]..member_off[c + 1] of mz, rt (null: no RT split) and
//     ids (dataset row ids), in the order of its condensed matrix.
//   method: 0 single, 1 complete, 2 average; eps: the cut; eps_far: a
//     distance above it keeps a component from closing whole.
//   Writes, at each member's row: labels_out, from 0 within its component
//     (-1 for a member split off alone); and the component's medoid ids
//     into medoids_out from its first row on, noise members first, then
//     the clusters by label; n_clusters_out[c] and n_medoids_out[c].
// Returns the number of components closed whole; -1 on bad offsets, -2 on
// a non-finite distance in a component that is linked, -3 on a failed
// linkage or cut, -4 on an internal error.
int64_t fc_link_components(
    const float* dist, int64_t n_dist, const int64_t* comps, int64_t k,
    const int64_t* member_off, const double* mz, const double* rt,
    const int64_t* ids, int method, double eps, double eps_far,
    double tol_mass, int ppm, double rt_tol, int32_t* labels_out,
    int64_t* n_clusters_out, int64_t* medoids_out,
    int64_t* n_medoids_out) noexcept {
  try {
    return fc_link_components_impl(
        dist, n_dist, comps, k, member_off, mz, rt, ids, method, eps,
        eps_far, tol_mass, ppm, rt_tol, labels_out, n_clusters_out,
        medoids_out, n_medoids_out);
  } catch (...) {
    return -4;
  }
}

int64_t fc_connected_components(const int64_t* u, const int64_t* v,
                                int64_t n_edges, int64_t n_nodes,
                                int32_t* labels_out) noexcept {
  try {
    return fc_connected_components_impl(u, v, n_edges, n_nodes, labels_out);
  } catch (...) {
    return -1;
  }
}

// Stable natural-order argsort of the ids of an export tie group's
// visits (rows numbered visit after visit; natsort_visits): order_out
// gets the n rows.  Returns 0 on success.
int fc_natsort_visits(const ExportVisit* visits, int64_t n_visits,
                      int64_t* order_out, int threads) noexcept {
  try {
    natsort_visits(visits, n_visits, order_out, threads);
    return 0;
  } catch (...) {
    return 4;
  }
}

// Write an export tie group's rows in `order` to fd as CSV rows
// (export_rows).  Returns the bytes written, or -1 on a bad row number or
// an internal error, -2 on a failed write (its errno in *err).
int64_t fc_export_rows(int fd, const ExportVisit* visits, int64_t n_visits,
                       const int64_t* order, int64_t n, int64_t null_charge,
                       int64_t chunk_rows, int threads, int* err) noexcept {
  try {
    return export_rows(fd, visits, n_visits, order, n, null_charge,
                       chunk_rows, threads, err);
  } catch (...) {
    return -1;
  }
}

}  // extern "C"
