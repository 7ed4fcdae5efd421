// falcon-tpu native ingest fast path.
//
// First-party C++ replacement for the reference's ingest hot loop
// (pyteomics MGF parsing + spectrum_utils preprocessing,
// falcon/falcon.py:362-392 and falcon/cluster/spectrum.py:73-169): one
// call parses an entire MGF file AND runs the full preprocessing chain
// (m/z range restriction, validity gates, precursor-peak removal,
// intensity filtering, scaling, L2 normalization), returning columnar
// arrays ready for the spectrum store.  Semantics mirror
// falcon_tpu/ms_io/mgf_io.py and falcon_tpu/preprocess/spectrum.py
// line for line; parity is enforced by tests/test_native_ingest.py.
//
// Exposed via a plain C ABI for ctypes binding.

#include <algorithm>
#include <charconv>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <map>
#include <memory>
#include <numeric>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

#include "falcon_ascii.h"

namespace {

constexpr double kProton = 1.0072766;  // preprocess/spectrum.py:37
constexpr int32_t kNullCharge = INT32_MIN;

inline bool ascii_space(char c) { return falcon_ascii::space(c); }
inline char ascii_upper(char c) { return falcon_ascii::upper(c); }
inline char ascii_lower(char c) { return falcon_ascii::lower(c); }
inline bool ascii_digit(char c) { return falcon_ascii::digit(c); }

// Line iterator over a byte range of a file, read with pread into one
// window that is reused: reading the range into a buffer of its own size
// costs the first touch of every page of it, which a window that stays
// mapped (and cached) does not.  The bytes an unfinished line holds are
// carried to the front of the window before the next read, so a line of
// any length is whole when given out.  A short read is EOF, so a file
// truncated meanwhile ends the scan, where an mmap of a shrinking file
// would SIGBUS the embedding process.  Returned [b, e) pointers are valid
// until the next next_line call.
class RangeReader {
 public:
  // The lines from byte `start` on; reads stop short of `end` (< 0: the
  // end of the file) by what the range's last lines need.  The partial
  // line a mid-line `start` lands in belongs to the range before: the
  // reader starts one byte early and drops the first line it finds, which
  // ends at the first newline at or after start - 1.
  RangeReader(int fd, int64_t start, int64_t end)
      : fd_(fd), end_(end), base_(start > 0 ? start - 1 : 0) {
    if (start > 0) {
      const char* b;
      const char* e;
      int64_t line_start;
      next_line(&b, &e, &line_start);
    }
  }

  // Next line (without its trailing '\n').  Returns false at EOF.
  bool next_line(const char** b, const char** e, int64_t* line_start) {
    for (;;) {
      const char* nl = len_ > pos_
                           ? static_cast<const char*>(std::memchr(
                                 buf_.get() + pos_, '\n', len_ - pos_))
                           : nullptr;
      if (nl != nullptr) {
        *b = buf_.get() + pos_;
        *e = nl;
        *line_start = base_ + static_cast<int64_t>(pos_);
        pos_ = static_cast<size_t>(nl - buf_.get()) + 1;
        return true;
      }
      if (eof_) {
        if (pos_ >= len_) return false;
        *b = buf_.get() + pos_;  // final line without newline
        *e = buf_.get() + len_;
        *line_start = base_ + static_cast<int64_t>(pos_);
        pos_ = len_;
        return true;
      }
      refill();
    }
  }

  // The bytes read and not yet given out, [*b, *e): whole lines, and a
  // partial one at the end, for a caller that parses lines in place and
  // hands back the start of the first line it did not take.
  void rest(const char** b, const char** e) const {
    *b = buf_.get() + pos_;
    *e = buf_.get() + len_;
  }
  void take_to(const char* b) { pos_ = static_cast<size_t>(b - buf_.get()); }

 private:
  static constexpr int64_t kWindow = 4 << 20;
  static constexpr int64_t kSlack = 64 << 10;

  // Keep the unread tail (a partial line), then read up to kWindow bytes
  // after it: to the range's end and kSlack beyond, and past that only
  // what finishes a line.
  void refill() {
    const size_t keep = len_ - pos_;
    const int64_t at = base_ + static_cast<int64_t>(len_);
    size_t want = static_cast<size_t>(
        end_ < 0 ? kWindow
                 : std::clamp<int64_t>(end_ + kSlack - at, kSlack, kWindow));
    if (cap_ < keep + want) {
      cap_ = keep + want;
      std::unique_ptr<char[]> grown(new char[cap_]);
      if (keep) std::memcpy(grown.get(), buf_.get() + pos_, keep);
      buf_ = std::move(grown);
    } else if (keep) {
      std::memmove(buf_.get(), buf_.get() + pos_, keep);
    }
    base_ += static_cast<int64_t>(pos_);
    pos_ = 0;
    len_ = keep;
    while (want > 0) {
      ssize_t got = pread(fd_, buf_.get() + len_, want,
                          base_ + static_cast<int64_t>(len_));
      if (got <= 0) break;
      len_ += static_cast<size_t>(got);
      want -= static_cast<size_t>(got);
    }
    if (want > 0) eof_ = true;
  }

  int fd_;
  int64_t end_;
  std::unique_ptr<char[]> buf_;
  size_t cap_ = 0, pos_ = 0, len_ = 0;
  int64_t base_;  // absolute file offset of buf_[0]
  bool eof_ = false;
};

enum Scaling { SCALE_OFF = 0, SCALE_ROOT = 1, SCALE_LOG = 2, SCALE_RANK = 3 };

struct IngestResult {
  // Per-kept-spectrum metadata.
  std::vector<double> precursor_mz;
  std::vector<int32_t> precursor_charge;  // kNullCharge if absent
  std::vector<double> retention_time;
  std::vector<int64_t> title_offsets{0};
  std::string title_bytes;
  // Ragged processed peaks.
  std::vector<int64_t> peak_offsets{0};
  std::vector<float> mz;
  std::vector<float> intensity;
  // Counters.
  int64_t n_read = 0;         // valid spectra parsed (pre-quality gate)
  int64_t n_low_quality = 0;  // rejected by a preprocessing quality gate
  // Spectra skipped for unsupported binary compression (numpress etc.,
  // mzML/mzXML only) — surfaced via fc_result_n_unsupported so ingest
  // can warn instead of silently dropping a fully-numpress file.
  int64_t n_unsupported = 0;
  // Spectra whose intensity filter cut them to the max_peaks_used most
  // intense (fc_result_n_topn).
  int64_t n_topn = 0;
  // The order in which the copies give the rows out
  // (fc_result_group_by_charge); empty: as parsed.
  std::vector<int64_t> order;
};

struct Params {
  int min_peaks;
  double min_mz_range;
  double mz_min, mz_max;            // NaN = disabled
  double remove_precursor_tol;      // NaN = disabled
  double min_intensity;             // NaN = disabled
  int max_peaks_used;               // <= 0 = disabled
  int scaling;
};

// Python-float()-compatible parse of a whitespace-trimmed token.
// Returns false on failure.  Accepts leading '+', inf/nan spellings.
// std::from_chars is locale-free and ~5x faster than strtod on this
// workload (one call per peak-line token).
bool parse_double(const char* begin, const char* end, double* out) {
  if (begin == end) return false;
  if (*begin == '+') ++begin;  // from_chars rejects a leading '+'
  auto res = std::from_chars(begin, end, *out);
  return res.ec == std::errc() && res.ptr == end;
}

// The common spelling of a number at [p, e): an optional '-', digits, and
// optionally '.' and more digits, with at most 19 digits and a value
// below 2^53.  That is w / 10^f for an integer w and f <= 22, both exact
// doubles, so the one IEEE division rounds correctly and gives
// from_chars' bits (Clinger's fast path).  Returns the end of the number
// and its value, or nullptr for any other spelling.
inline const char* fast_number(const char* p, const char* e, double* out) {
  static constexpr double kPow10[] = {
      1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,  1e8,  1e9,  1e10, 1e11,
      1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};
  const bool neg = p < e && *p == '-';
  p += neg;
  const char* int_begin = p;
  uint64_t w = 0;
  while (p < e && ascii_digit(*p)) w = w * 10 + (*p++ - '0');
  const int64_t n_int = p - int_begin;
  int64_t n_frac = 0;
  if (p < e && *p == '.') {
    const char* frac_begin = ++p;
    while (p < e && ascii_digit(*p)) w = w * 10 + (*p++ - '0');
    n_frac = p - frac_begin;
    if (n_frac == 0) return nullptr;
  }
  if (n_int == 0 || n_int + n_frac > 19 || w > (uint64_t{1} << 53) ||
      n_frac > 22) {
    return nullptr;
  }
  const double v = static_cast<double>(w) / kPow10[n_frac];
  *out = neg ? -v : v;
  return p;
}

// parse_double for a peak-line token, through fast_number where it can.
inline bool parse_number(const char* begin, const char* end, double* out) {
  return fast_number(begin, end, out) == end || parse_double(begin, end, out);
}

// A peak line at [p, e) in its common form: two fast_number spellings,
// spaces or tabs between them, optional spaces, tabs or a carriage return
// after, and its '\n' before e.  Returns the start of the next line and the
// two values, or nullptr where the line needs the general parse (which
// gives the same values where this one gives any).
inline const char* fast_peak_line(const char* p, const char* e, double* m,
                                  double* i) {
  const char* q = fast_number(p, e, m);
  if (q == nullptr || q == e || (*q != ' ' && *q != '\t')) return nullptr;
  while (q < e && (*q == ' ' || *q == '\t')) ++q;
  q = fast_number(q, e, i);
  if (q == nullptr) return nullptr;
  while (q < e && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
  return q < e && *q == '\n' ? q + 1 : nullptr;
}

// mgf_io.py:_parse_charge — first whitespace token, rstrip ',', trailing
// '+'/'-' sign, int() parse.
bool parse_charge(const std::string& value, int32_t* out) {
  size_t start = value.find_first_not_of(" \t");
  if (start == std::string::npos) return false;
  size_t stop = value.find_first_of(" \t", start);
  if (stop == std::string::npos) stop = value.size();
  std::string tok = value.substr(start, stop - start);
  while (!tok.empty() && tok.back() == ',') tok.pop_back();
  if (tok.empty()) return false;
  long sign = 1;
  if (tok.back() == '+') {
    tok.pop_back();
  } else if (tok.back() == '-') {
    sign = -1;
    tok.pop_back();
  }
  if (tok.empty()) return false;
  char* parse_end = nullptr;
  long v = std::strtol(tok.c_str(), &parse_end, 10);
  if (*parse_end != '\0') return false;
  *out = static_cast<int32_t>(sign * v);
  return true;
}

// Validity gate (preprocess/spectrum.py:63-70): >= min_peaks peaks and
// float32 m/z span >= min_mz_range.
bool spectrum_valid(const std::vector<float>& mz, const Params& p) {
  if (static_cast<int>(mz.size()) < p.min_peaks) return false;
  return static_cast<double>(mz.back() - mz.front()) >= p.min_mz_range;
}

// Buffers one thread reuses from spectrum to spectrum, so that
// preprocessing allocates nothing per spectrum, and its count of top-N cuts.
struct Scratch {
  std::vector<uint64_t> keyed;
  std::vector<double> remove_mz;
  int64_t n_topn = 0;
};

// A finite float and its position as one integer that orders as the pair
// (value, position) does under float comparison: -0.0 and 0.0 tie.
inline uint64_t order_key(float v, size_t position) {
  uint32_t bits;
  v = v == 0.0f ? 0.0f : v;
  std::memcpy(&bits, &v, sizeof bits);
  bits = bits & 0x80000000u ? ~bits : bits | 0x80000000u;
  return (static_cast<uint64_t>(bits) << 32) | position;
}

// The k-th smallest of n distinct keys (from 0), reordering them:
// quickselect whose partition moves every key by the same steps whatever
// it compares to, so that a spectrum's few hundred comparisons cost no
// mispredicted branch (std::nth_element's cost most of the
// preprocessing).
uint64_t select_kth(uint64_t* a, size_t n, size_t k) {
  size_t lo = 0, hi = n;  // the k-th lies in [lo, hi)
  while (hi - lo > 1) {
    // Median of three as the pivot, parked at hi - 1.
    size_t mid = lo + (hi - lo) / 2;
    uint64_t x = a[lo], y = a[mid], z = a[hi - 1];
    uint64_t pivot = std::max(std::min(x, y), std::min(std::max(x, y), z));
    size_t at = pivot == x ? lo : pivot == y ? mid : hi - 1;
    std::swap(a[at], a[hi - 1]);
    size_t i = lo;
    for (size_t j = lo; j + 1 < hi; ++j) {
      const uint64_t v = a[j];
      a[j] = a[i];
      a[i] = v;
      i += v < pivot;
    }
    std::swap(a[i], a[hi - 1]);
    if (k == i) return pivot;
    if (k < i) {
      hi = i;
    } else {
      lo = i + 1;
    }
  }
  return a[lo];
}

// The full preprocessing chain (preprocess/spectrum.py:136-200) on one
// spectrum's float32 peak arrays (already m/z-sorted by MGF convention;
// the Python path also assumes sorted input).  Returns false if rejected.
bool preprocess(std::vector<float>& mz, std::vector<float>& inten,
                double precursor_mz, int32_t charge, const Params& p,
                Scratch& scratch) {
  // 0. Non-finite gate (documented divergence, SURVEY.md §3.5): a
  // NaN/inf precursor m/z silently DISABLES the precursor-peak removal
  // below (every NaN comparison is false) and breaks the
  // sorted-precursor invariants that charge bucketing and the banded
  // kNN rely on, so the spectrum is rejected; non-finite peak entries
  // are dropped pairwise before any filter sees them.  Mirrors
  // preprocess/spectrum.py step 0.
  if (!std::isfinite(precursor_mz)) return false;
  size_t n_finite = 0;
  for (size_t i = 0; i < mz.size(); ++i) {
    if (std::isfinite(mz[i]) && std::isfinite(inten[i])) {
      mz[n_finite] = mz[i];
      inten[n_finite] = inten[i];
      ++n_finite;
    }
  }
  mz.resize(n_finite);
  inten.resize(n_finite);

  // 1. m/z range restriction (inclusive bounds).
  if (!std::isnan(p.mz_min) || !std::isnan(p.mz_max)) {
    double lo = std::isnan(p.mz_min)
                    ? -std::numeric_limits<double>::infinity() : p.mz_min;
    double hi = std::isnan(p.mz_max)
                    ? std::numeric_limits<double>::infinity() : p.mz_max;
    size_t w = 0;
    for (size_t i = 0; i < mz.size(); ++i) {
      double v = static_cast<double>(mz[i]);
      if (v >= lo && v <= hi) {
        mz[w] = mz[i];
        inten[w] = inten[i];
        ++w;
      }
    }
    mz.resize(w);
    inten.resize(w);
  }
  // 2. Validity gate.
  if (!spectrum_valid(mz, p)) return false;

  // 3. Precursor-peak removal at every fragment charge 1..Z (None charge
  //    treated as 1; preprocess/spectrum.py:73-95).
  if (!std::isnan(p.remove_precursor_tol)) {
    int z = charge == kNullCharge ? 1 : std::max(static_cast<int>(charge), 1);
    double neutral_mass = (precursor_mz - kProton) * z;
    std::vector<double>& remove_mz = scratch.remove_mz;
    remove_mz.clear();
    for (int c = z; c >= 1; --c) remove_mz.push_back(neutral_mass / c + kProton);
    size_t w = 0;
    for (size_t i = 0; i < mz.size(); ++i) {
      bool hit = false;
      for (double r : remove_mz) {
        if (std::fabs(static_cast<double>(mz[i]) - r) <=
            p.remove_precursor_tol) {
          hit = true;
          break;
        }
      }
      if (!hit) {
        mz[w] = mz[i];
        inten[w] = inten[i];
        ++w;
      }
    }
    mz.resize(w);
    inten.resize(w);
    if (!spectrum_valid(mz, p)) return false;
  }

  // 4. Intensity filtering (preprocess/spectrum.py:98-113): keep peaks
  //    with intensity strictly > min_intensity * base peak, then at most
  //    the max_peaks_used most intense: the tail of a stable ascending
  //    sort, so at a tie on the cut the later position is kept.
  if ((!std::isnan(p.min_intensity) || p.max_peaks_used > 0) &&
      !inten.empty()) {
    double min_int = std::isnan(p.min_intensity) ? 0.0 : p.min_intensity;
    size_t n = inten.size();
    size_t max_num = p.max_peaks_used > 0
                         ? static_cast<size_t>(p.max_peaks_used) : n;
    double threshold = min_int * static_cast<double>(
        *std::max_element(inten.begin(), inten.end()));
    size_t above = 0;
    for (float v : inten) above += static_cast<double>(v) > threshold;
    size_t w = 0;
    if (above <= max_num) {
      // The cap cuts nothing: the kept set is every peak above the
      // threshold, in original order.
      for (size_t i = 0; i < n; ++i) {
        if (static_cast<double>(inten[i]) > threshold) {
          mz[w] = mz[i];
          inten[w] = inten[i];
          ++w;
        }
      }
    } else {
      // The max_num largest by (intensity, position), all above the
      // threshold since more than max_num are: select the least of them
      // and keep what does not order below it.
      ++scratch.n_topn;
      std::vector<uint64_t>& keyed = scratch.keyed;
      keyed.resize(n);
      for (size_t i = 0; i < n; ++i) keyed[i] = order_key(inten[i], i);
      const uint64_t least = select_kth(keyed.data(), n, n - max_num);
      for (size_t i = 0; i < n; ++i) {  // about half kept: no branch
        mz[w] = mz[i];
        inten[w] = inten[i];
        w += order_key(inten[i], i) >= least;
      }
    }
    mz.resize(w);
    inten.resize(w);
    if (!spectrum_valid(mz, p)) return false;
  }

  // 5. Scaling (preprocess/spectrum.py:116-133).
  size_t n = inten.size();
  switch (p.scaling) {
    case SCALE_ROOT:
      for (auto& v : inten) v = std::sqrt(v);
      break;
    case SCALE_LOG: {
      const double ln2 = 0.6931471805599453;
      for (auto& v : inten)
        v = static_cast<float>(
            static_cast<double>(std::log1p(v)) / ln2);
      break;
    }
    case SCALE_RANK: {
      // desc_rank = argsort(argsort(x, stable)[::-1], stable);
      // scaled = max_rank - desc_rank.
      std::vector<int64_t> asc(n);
      std::iota(asc.begin(), asc.end(), 0);
      std::stable_sort(asc.begin(), asc.end(), [&](int64_t a, int64_t b) {
        return inten[a] < inten[b];
      });
      // Reversed order, then invert the permutation.
      std::vector<float> scaled(n);
      int64_t max_rank = p.max_peaks_used > 0
                             ? p.max_peaks_used : static_cast<int64_t>(n);
      for (size_t r = 0; r < n; ++r) {
        int64_t peak = asc[n - 1 - r];  // r-th most intense (ties reversed)
        scaled[peak] = static_cast<float>(max_rank - static_cast<int64_t>(r));
      }
      inten = std::move(scaled);
      break;
    }
    default:
      break;
  }

  // 6. L2 normalization.  All-zero intensities (reachable when the
  // intensity filter is disabled) would normalize to NaN vectors —
  // reject instead (preprocess/spectrum.py does the same).
  double sq = 0.0;
  for (float v : inten) sq += static_cast<double>(v) * v;
  double norm = std::sqrt(sq);
  if (norm == 0.0) return false;
  for (auto& v : inten) v = static_cast<float>(v / norm);
  return true;
}

// Case-insensitive "does line start with prefix".
bool istarts_with(const char* line, size_t len, const char* prefix) {
  size_t plen = std::strlen(prefix);
  if (len < plen) return false;
  for (size_t i = 0; i < plen; ++i) {
    if (ascii_upper(line[i]) != prefix[i]) return false;
  }
  return true;
}

// MGF spectrum parameters (per spectrum or file header; the header
// merges into each spectrum with local keys winning, pyteomics
// ``use_header=True`` default the reference inherits).
struct MgfParams {
  bool have_title = false, have_pepmass = false;
  bool have_charge = false, have_rt = false;
  std::string title, pepmass, charge, rt;
};

void finish_spectrum(IngestResult* res, const Params& p,
                     const MgfParams& prm, std::vector<float>& mz,
                     std::vector<float>& inten, Scratch& scratch) {
  const bool have_title = prm.have_title, have_pepmass = prm.have_pepmass;
  const bool have_charge = prm.have_charge, have_rt = prm.have_rt;
  const std::string& title = prm.title;
  const std::string& pepmass_raw = prm.pepmass;
  const std::string& charge_raw = prm.charge;
  const std::string& rt_raw = prm.rt;
  // mgf_io.py:_make_spectrum — params parsed only here, at END IONS (a
  // later duplicate key overrides an earlier malformed value); TITLE and
  // PEPMASS required; malformed spectra are skipped silently (not
  // counted as read).
  if (!have_title || !have_pepmass) return;
  double pepmass;
  {
    size_t stop = pepmass_raw.find_first_of(" \t");
    std::string tok = stop == std::string::npos
                          ? pepmass_raw : pepmass_raw.substr(0, stop);
    if (!parse_double(tok.data(), tok.data() + tok.size(), &pepmass))
      return;
  }
  double rt = -1.0;
  if (have_rt &&
      !parse_double(rt_raw.data(), rt_raw.data() + rt_raw.size(), &rt)) {
    return;
  }
  int32_t charge = kNullCharge;
  if (have_charge && !parse_charge(charge_raw, &charge)) return;
  res->n_read += 1;
  // Non-finite RT ("RTINSECONDS=nan") would poison the RT-refinement
  // sort; missing RT is always the finite -1.0 (SURVEY.md §3.5).
  if (!std::isfinite(rt) ||
      !preprocess(mz, inten, pepmass, charge, p, scratch)) {
    res->n_low_quality += 1;
    return;
  }
  res->precursor_mz.push_back(pepmass);
  res->precursor_charge.push_back(charge);
  res->retention_time.push_back(rt);
  res->title_bytes.append(title);
  res->title_offsets.push_back(
      static_cast<int64_t>(res->title_bytes.size()));
  res->mz.insert(res->mz.end(), mz.begin(), mz.end());
  res->intensity.insert(res->intensity.end(), inten.begin(), inten.end());
  res->peak_offsets.push_back(static_cast<int64_t>(res->mz.size()));
}

// File-header parameters: lines before the first BEGIN IONS, merged
// into every spectrum with local keys winning (pyteomics
// ``use_header=True`` default the reference inherits,
// falcon/ms_io/mgf_io.py:25).  Every byte-range worker re-reads the
// (tiny) file head so ranges that start mid-file still see the header;
// the scan is capped at 1 MB — real MGF headers are a few lines.
bool is_comment_start(char c) {
  // pyteomics MGFBase._comments = set('#;!/').
  return c == '#' || c == ';' || c == '!' || c == '/';
}

// Stash one "KEY=value" param line [b, e) with '=' at `eq` into `out`
// (key trimmed + uppercased, value trimmed) — shared by the file-header
// scan and the in-block param branch so the two stay in sync.
void apply_mgf_param(const char* b, const char* e, const char* eq,
                     MgfParams* out) {
  auto tab_space = [](char c) { return c == ' ' || c == '\t'; };
  const char* kb = b;
  const char* ke = eq;
  while (kb < ke && tab_space(*kb)) ++kb;
  while (ke > kb && tab_space(ke[-1])) --ke;
  const char* vb = eq + 1;
  const char* ve = e;
  while (vb < ve && tab_space(*vb)) ++vb;
  while (ve > vb && tab_space(ve[-1])) --ve;
  auto key_is = [&](const char* name) {
    return static_cast<size_t>(ke - kb) == std::strlen(name) &&
           istarts_with(kb, static_cast<size_t>(ke - kb), name);
  };
  if (key_is("TITLE")) {
    out->title.assign(vb, ve);
    out->have_title = true;
  } else if (key_is("PEPMASS")) {
    out->pepmass.assign(vb, ve);
    out->have_pepmass = true;
  } else if (key_is("RTINSECONDS")) {
    out->rt.assign(vb, ve);
    out->have_rt = true;
  } else if (key_is("CHARGE")) {
    out->charge.assign(vb, ve);
    out->have_charge = true;
  }
}

void read_mgf_header(const char* path, MgfParams* hdr) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return;
  char* line = nullptr;
  size_t cap = 0;
  ssize_t got;
  int64_t consumed = 0;
  const int64_t kHeaderCap = 1 << 20;
  while ((got = getline(&line, &cap, f)) != -1) {
    consumed += got;
    char* b = line;
    char* e = line + got;
    while (b < e && ascii_space(*b)) ++b;
    while (e > b && ascii_space(e[-1])) --e;
    if (b == e || is_comment_start(*b)) {
      if (consumed > kHeaderCap) break;
      continue;
    }
    size_t len = static_cast<size_t>(e - b);
    if (istarts_with(b, len, "BEGIN IONS")) break;
    const char* eq = static_cast<const char*>(std::memchr(b, '=', len));
    bool first_digit =
        ascii_digit(b[0]) || b[0] == '-';
    if (eq && !first_digit) apply_mgf_param(b, e, eq, hdr);
    if (consumed > kHeaderCap) break;
  }
  std::free(line);
  std::fclose(f);
}

// ----- MSP (NIST/GNPS spectral-library) scanner ---------------------
// Mirrors falcon_tpu/ms_io/msp_io.py line for line (which itself covers
// the format the reference PROMISES — "Supported file formats are MGF,
// MSP, mzML, mzXML", falcon/ms_io/ms_io.py:15 — but never implements).

// Comment key=value scan, equivalent to msp_io._COMMENT_KV:
// (\w[\w/.-]*)=("[^"]*"|\S+), values stripped of surrounding quotes.
void msp_scan_comment(const std::string& value,
                      std::map<std::string, std::string>* kv) {
  const size_t n = value.size();
  auto is_word = [](unsigned char c) {
    return std::isalnum(c) || c == '_';
  };
  auto is_key_char = [&](unsigned char c) {
    return is_word(c) || c == '/' || c == '.' || c == '-';
  };
  size_t i = 0;
  while (i < n) {
    if (!is_word(static_cast<unsigned char>(value[i]))) {
      ++i;
      continue;
    }
    size_t ks = i, j = i;
    while (j < n && is_key_char(static_cast<unsigned char>(value[j]))) ++j;
    bool matched = false;
    if (j < n && value[j] == '=') {
      size_t vs = j + 1;
      std::string val;
      if (vs < n && value[vs] == '"') {
        size_t close = value.find('"', vs + 1);
        if (close != std::string::npos) {
          val = value.substr(vs, close - vs + 1);
          i = close + 1;
          matched = true;
        }
      }
      if (!matched) {
        size_t ve = vs;
        while (ve < n &&
               !ascii_space(value[ve]))
          ++ve;
        if (ve > vs) {
          val = value.substr(vs, ve - vs);
          i = ve;
          matched = true;
        }
      }
      if (matched) {
        // Python: m.group(2).strip('"')
        size_t v0 = val.find_first_not_of('"');
        size_t v1 = val.find_last_not_of('"');
        val = v0 == std::string::npos
                  ? "" : val.substr(v0, v1 - v0 + 1);
        std::string key = value.substr(ks, j - ks);
        for (auto& c : key)
          c = ascii_lower(c);
        (*kv)[key] = val;
        continue;
      }
    }
    i = ks + 1;  // the regex engine retries at the next offset
  }
}

struct MspEntry {
  bool started = false, in_peaks = false, malformed = false;
  std::map<std::string, std::string> fields;  // lowercased keys
  std::map<std::string, std::string> ckv;     // Comment key=values
  std::vector<float> mz, inten;
};

// First whitespace-delimited token of a value (Python .split()[0]);
// empty if none.
std::string first_token(const std::string& s) {
  size_t b = s.find_first_not_of(" \t\r\n\v\f");
  if (b == std::string::npos) return "";
  size_t e = s.find_first_of(" \t\r\n\v\f", b);
  return e == std::string::npos ? s.substr(b) : s.substr(b, e - b);
}

// Non-empty lookup with Python falsy-string semantics ("" counts as
// absent in `a or b` chains).
const std::string* msp_get(const std::map<std::string, std::string>& m,
                           const char* key) {
  auto it = m.find(key);
  if (it == m.end() || it->second.empty()) return nullptr;
  return &it->second;
}

// msp_io._make_spectrum: Name + a precursor m/z required; malformed
// entries skipped silently (not counted as read).
void msp_finish(IngestResult* res, const Params& p, MspEntry* e,
                Scratch& scratch) {
  if (!e->started || e->malformed) return;
  auto name_it = e->fields.find("name");
  if (name_it == e->fields.end()) return;
  const std::string* pre = nullptr;
  for (const char* k : {"precursormz", "precursor_m/z", "precursor m/z"}) {
    if ((pre = msp_get(e->fields, k)) != nullptr) break;
  }
  if (!pre) pre = msp_get(e->ckv, "parent");
  if (!pre) pre = msp_get(e->fields, "mw");
  if (!pre) return;
  double precursor_mz;
  {
    std::string tok = first_token(*pre);
    if (tok.empty() ||
        !parse_double(tok.data(), tok.data() + tok.size(), &precursor_mz))
      return;
  }
  int32_t charge = kNullCharge;
  {
    const std::string* raw = msp_get(e->fields, "charge");
    if (!raw) raw = msp_get(e->ckv, "charge");
    if (raw && !parse_charge(*raw, &charge)) return;
  }
  double rt = -1.0;
  {
    const std::string* raw = msp_get(e->ckv, "rtinseconds");
    if (!raw) raw = msp_get(e->fields, "rtinseconds");
    if (!raw) raw = msp_get(e->ckv, "retentiontime");
    if (!raw) raw = msp_get(e->fields, "retentiontime");
    if (raw) {
      // Python float(raw) on the WHOLE value: leading/trailing
      // whitespace tolerated, anything else (multi-token, empty) is a
      // ValueError -> entry skipped.
      size_t b = raw->find_first_not_of(" \t\r\n\v\f");
      if (b == std::string::npos) return;
      size_t en = raw->find_last_not_of(" \t\r\n\v\f");
      std::string tok = raw->substr(b, en - b + 1);
      if (tok.find_first_of(" \t\r\n\v\f") != std::string::npos) return;
      if (!parse_double(tok.data(), tok.data() + tok.size(), &rt))
        return;
    }
  }
  res->n_read += 1;
  // containers.Spectrum sorts unsorted peaks (stable).
  bool sorted = true;
  for (size_t i = 1; i < e->mz.size(); ++i) {
    if (e->mz[i] < e->mz[i - 1]) { sorted = false; break; }
  }
  if (!sorted) {
    std::vector<int64_t> ord(e->mz.size());
    std::iota(ord.begin(), ord.end(), 0);
    std::stable_sort(ord.begin(), ord.end(), [&](int64_t a, int64_t b) {
      return e->mz[a] < e->mz[b];
    });
    std::vector<float> m2(ord.size()), i2(ord.size());
    for (size_t i = 0; i < ord.size(); ++i) {
      m2[i] = e->mz[ord[i]];
      i2[i] = e->inten[ord[i]];
    }
    e->mz = std::move(m2);
    e->inten = std::move(i2);
  }
  if (!std::isfinite(rt) ||
      !preprocess(e->mz, e->inten, precursor_mz, charge, p, scratch)) {
    res->n_low_quality += 1;
    return;
  }
  res->precursor_mz.push_back(precursor_mz);
  res->precursor_charge.push_back(charge);
  res->retention_time.push_back(rt);
  res->title_bytes.append(name_it->second);
  res->title_offsets.push_back(
      static_cast<int64_t>(res->title_bytes.size()));
  res->mz.insert(res->mz.end(), e->mz.begin(), e->mz.end());
  res->intensity.insert(res->intensity.end(), e->inten.begin(),
                        e->inten.end());
  res->peak_offsets.push_back(static_cast<int64_t>(res->mz.size()));
}

// Decode well-formed UTF-8 (Unicode's table 3-7, which Python's decoder
// follows) into code points at `out` (when not null, at most `cap` of
// them); returns their count, or -1 at the first ill-formed sequence.
int64_t utf8_decode(const unsigned char* s, const unsigned char* e,
                    uint32_t* out, int64_t cap = 0) {
  int64_t n = 0;
  while (s < e) {
    uint32_t c = *s;
    int more;
    unsigned char lo = 0x80, hi = 0xBF;  // bounds of the second byte
    if (c < 0x80) {
      more = 0;
    } else if (c >= 0xC2 && c <= 0xDF) {
      more = 1;
      c &= 0x1F;
    } else if (c >= 0xE0 && c <= 0xEF) {
      more = 2;
      if (c == 0xE0) lo = 0xA0;
      if (c == 0xED) hi = 0x9F;
      c &= 0x0F;
    } else if (c >= 0xF0 && c <= 0xF4) {
      more = 3;
      if (c == 0xF0) lo = 0x90;
      if (c == 0xF4) hi = 0x8F;
      c &= 0x07;
    } else {
      return -1;
    }
    if (e - s <= more) return -1;
    for (int k = 1; k <= more; ++k) {
      unsigned char b = s[k];
      if (b < (k == 1 ? lo : 0x80) || b > (k == 1 ? hi : 0xBF)) return -1;
      c = (c << 6) | (b & 0x3F);
    }
    s += more + 1;
    if (out != nullptr) {
      if (n >= cap) return -1;
      out[n] = c;
    }
    ++n;
  }
  return n;
}

thread_local Scratch tl_scratch;

}  // namespace

extern "C" {

// Spectra the calling thread's fc_preprocess_spectrum calls have cut to
// max_peaks_used so far: a sibling parser reads it before and after a
// parse.
int64_t fc_preprocess_topn() { return tl_scratch.n_topn; }

// Preprocessing hook for sibling parsers (falcon_mzml.cc): runs the full
// chain in place on (mz, inten, *n) and shrinks *n; returns false when
// the spectrum fails a quality gate.  Its buffers and its count of top-N
// cuts (fc_preprocess_topn) are the calling thread's.
bool fc_preprocess_spectrum(float* mz_arr, float* int_arr, int64_t* n,
                            double precursor_mz, int32_t charge,
                            int min_peaks, double min_mz_range,
                            double mz_min, double mz_max,
                            double remove_precursor_tol,
                            double min_intensity, int max_peaks_used,
                            int scaling) {
  Params p{min_peaks, min_mz_range, mz_min, mz_max,
           remove_precursor_tol, min_intensity, max_peaks_used, scaling};
  std::vector<float> mz(mz_arr, mz_arr + *n);
  std::vector<float> inten(int_arr, int_arr + *n);
  if (!preprocess(mz, inten, precursor_mz, charge, p, tl_scratch))
    return false;
  std::memcpy(mz_arr, mz.data(), mz.size() * sizeof(float));
  std::memcpy(int_arr, inten.data(), inten.size() * sizeof(float));
  *n = static_cast<int64_t>(mz.size());
  return true;
}

// Parse + preprocess an MGF byte range [start, end) of a file.
//
// Range ownership is by the byte offset of each spectrum's "BEGIN IONS"
// line start: a spectrum belongs to this range iff its BEGIN IONS line
// starts at an offset in [start, end), so splitting a file at arbitrary
// byte boundaries and concatenating the per-range results reproduces
// the whole-file parse exactly (parity enforced by
// tests/test_native_ingest.py).  end < 0 means to EOF.
//
// Returns an opaque result handle (NULL if the file cannot be opened)
// and fills out_counts = [n_spectra_kept, n_peaks_total, title_bytes,
// n_read, n_low_quality, 0, n_blocks] (n_blocks = BEGIN IONS blocks
// owned by the range, pre-parse — distinguishes "scanner saw nothing"
// from "every block was malformed").  Copy the arrays out with
// fc_mgf_result_copy, then release with fc_mgf_result_free.
//
// scaling: 0 = off, 1 = root, 2 = log, 3 = rank.  NaN disables an
// optional double parameter; max_peaks_used <= 0 disables the top-N cap.
void* fc_mgf_ingest_range(const char* path, int64_t start, int64_t end,
                          int min_peaks, double min_mz_range,
                          double mz_min, double mz_max,
                          double remove_precursor_tol, double min_intensity,
                          int max_peaks_used, int scaling,
                          int64_t* out_counts) {
  int fd = open(path, O_RDONLY | O_CLOEXEC);
  if (fd < 0) return nullptr;
  Params p{min_peaks, min_mz_range, mz_min, mz_max,
           remove_precursor_tol, min_intensity, max_peaks_used, scaling};
  auto* res = new IngestResult();
  {
    // Room for the kept peaks of a range of peak lines, so that the
    // arrays are not copied as they grow (what is never touched costs no
    // memory): a peak line takes 16 bytes or more in practice.
    struct stat st;
    int64_t bytes = end >= 0                 ? end - start
                    : fstat(fd, &st) == 0 ? st.st_size - start
                                          : 0;
    res->mz.reserve(static_cast<size_t>(std::max<int64_t>(bytes / 16, 0)));
    res->intensity.reserve(res->mz.capacity());
  }

  MgfParams hdr;
  read_mgf_header(path, &hdr);

  bool in_ions = false;
  int64_t n_blocks = 0;    // BEGIN IONS blocks owned by this range
  bool malformed = false;  // unparseable peak line -> skip the spectrum
  MgfParams cur;
  std::vector<float> mz, inten;
  mz.reserve(4096);
  inten.reserve(4096);
  Scratch scratch;

  // A peak line: at least two whitespace tokens, fewer skip the line; a
  // token that does not parse skips the whole spectrum silently, as the
  // Python parser does (and pyteomics, raising inside the reference's
  // loop).  Once the block is malformed its lines need no parse.
  auto peak_line = [&](const char* b, const char* e) {
    if (malformed) return;
    const char* s = b;
    while (s < e && !ascii_space(*s)) ++s;
    const char* tok0_e = s;
    while (s < e && ascii_space(*s)) ++s;
    const char* tok1_b = s;
    while (s < e && !ascii_space(*s)) ++s;
    if (tok1_b == s) return;
    double m, i;
    if (parse_number(b, tok0_e, &m) && parse_number(tok1_b, s, &i)) {
      mz.push_back(static_cast<float>(m));
      inten.push_back(static_cast<float>(i));
    } else {
      malformed = true;
    }
  };

  RangeReader lines(fd, start, end);
  const char* b;
  const char* e;
  int64_t line_start;
  while (lines.next_line(&b, &e, &line_start)) {
    // strip() both ends.
    while (b < e && ascii_space(*b)) ++b;
    while (e > b && ascii_space(e[-1])) --e;
    if (b == e) continue;
    // A line that starts like a number is neither BEGIN nor END IONS nor
    // a parameter: a peak line inside a block, ignored outside one.
    if (ascii_digit(*b) || *b == '-') {
      if (!in_ions) continue;
      peak_line(b, e);
      // Peak lines come one after another: parse those in the common form
      // in place, with no line split, up to the first that is not.
      if (malformed) continue;
      const char* p;
      const char* rest_end;
      lines.rest(&p, &rest_end);
      double m, i;
      while (const char* next = fast_peak_line(p, rest_end, &m, &i)) {
        mz.push_back(static_cast<float>(m));
        inten.push_back(static_cast<float>(i));
        p = next;
      }
      lines.take_to(p);
      continue;
    }
    if (is_comment_start(*b)) continue;
    size_t len = static_cast<size_t>(e - b);
    if (istarts_with(b, len, "BEGIN IONS")) {
      if (end >= 0 && line_start >= end) break;  // next range owns it
      ++n_blocks;
      in_ions = true;
      malformed = false;
      // Per-spectrum params start from the file header (local wins).
      cur = hdr;
      mz.clear();
      inten.clear();
    } else if (istarts_with(b, len, "END IONS")) {
      if (in_ions && !malformed) {
        finish_spectrum(res, p, cur, mz, inten, scratch);
      }
      in_ions = false;
    } else if (in_ions) {
      const char* eq = static_cast<const char*>(std::memchr(b, '=', len));
      if (eq) {
        apply_mgf_param(b, e, eq, &cur);
      } else {
        peak_line(b, e);
      }
    }
  }
  close(fd);
  res->n_topn = scratch.n_topn;

  out_counts[0] = static_cast<int64_t>(res->precursor_mz.size());
  out_counts[1] = static_cast<int64_t>(res->mz.size());
  out_counts[2] = static_cast<int64_t>(res->title_bytes.size());
  out_counts[3] = res->n_read;
  out_counts[4] = res->n_low_quality;
  out_counts[5] = 0;  // no truncation concept for MGF
  out_counts[6] = n_blocks;
  return res;
}

// Parse + preprocess an entire MGF file (the [0, EOF) range).
void* fc_mgf_ingest(const char* path, int min_peaks, double min_mz_range,
                    double mz_min, double mz_max,
                    double remove_precursor_tol, double min_intensity,
                    int max_peaks_used, int scaling, int64_t* out_counts) {
  return fc_mgf_ingest_range(path, 0, -1, min_peaks, min_mz_range, mz_min,
                             mz_max, remove_precursor_tol, min_intensity,
                             max_peaks_used, scaling, out_counts);
}

// Parse + preprocess the MSP entries whose "Name:" line starts in
// [start, end); same range-concatenation contract and result handle as
// fc_mgf_ingest_range.  Mirrors falcon_tpu/ms_io/msp_io.py.
void* fc_msp_ingest_range(const char* path, int64_t start, int64_t end,
                          int min_peaks, double min_mz_range,
                          double mz_min, double mz_max,
                          double remove_precursor_tol, double min_intensity,
                          int max_peaks_used, int scaling,
                          int64_t* out_counts) {
  int fd = open(path, O_RDONLY | O_CLOEXEC);
  if (fd < 0) return nullptr;
  Params p{min_peaks, min_mz_range, mz_min, mz_max,
           remove_precursor_tol, min_intensity, max_peaks_used, scaling};
  auto* res = new IngestResult();
  Scratch scratch;

  MspEntry entry;
  int64_t n_blocks = 0;
  RangeReader lines(fd, start, end);
  const char* b;
  const char* e;
  int64_t line_start;
  while (lines.next_line(&b, &e, &line_start)) {
    while (b < e && ascii_space(*b)) ++b;
    while (e > b && ascii_space(e[-1])) --e;
    if (b == e) {
      // Blank line: ends the peak list (entry boundary); tolerated
      // between header fields.
      if (entry.in_peaks) {
        msp_finish(res, p, &entry, scratch);
        entry = MspEntry();
      }
      continue;
    }
    if ((*b == '#' || *b == ';') && !entry.in_peaks) continue;
    size_t len = static_cast<size_t>(e - b);
    const char* colon =
        static_cast<const char*>(std::memchr(b, ':', len));
    if (colon != nullptr) {
      std::string key(b, colon);
      size_t k0 = key.find_first_not_of(" \t");
      size_t k1 = key.find_last_not_of(" \t");
      key = k0 == std::string::npos ? "" : key.substr(k0, k1 - k0 + 1);
      for (auto& c : key)
        c = ascii_lower(c);
      std::string value(colon + 1, e);
      size_t v0 = value.find_first_not_of(" \t");
      size_t v1 = value.find_last_not_of(" \t");
      value = v0 == std::string::npos
                  ? "" : value.substr(v0, v1 - v0 + 1);
      if (key == "name") {
        // A new Name ends the previous entry — whether in its header
        // or its peak list.
        if (end >= 0 && line_start >= end) break;  // next range owns it
        msp_finish(res, p, &entry, scratch);
        entry = MspEntry();
        entry.started = true;
        entry.fields["name"] = value;
        ++n_blocks;
        continue;
      }
      if (!entry.in_peaks) {
        if (key == "num peaks" || key == "numpeaks" ||
            key == "num_peaks") {
          entry.in_peaks = true;
        } else if (key == "comment" || key == "comments") {
          msp_scan_comment(value, &entry.ckv);
        } else {
          entry.fields[key] = value;
        }
        continue;
      }
    }
    if (entry.in_peaks) {
      // ';'-separated chunks of "mz intensity [annotations...]".
      const char* cb = b;
      while (cb < e) {
        const char* ce = static_cast<const char*>(
            std::memchr(cb, ';', static_cast<size_t>(e - cb)));
        if (ce == nullptr) ce = e;
        const char* s = cb;
        while (s < ce && ascii_space(*s)) ++s;
        const char* t0b = s;
        while (s < ce && !ascii_space(*s)) ++s;
        const char* t0e = s;
        while (s < ce && ascii_space(*s)) ++s;
        const char* t1b = s;
        while (s < ce && !ascii_space(*s)) ++s;
        const char* t1e = s;
        if (t1b != t1e) {  // >= 2 tokens; otherwise skip the chunk
          double m, i;
          if (parse_double(t0b, t0e, &m) && parse_double(t1b, t1e, &i)) {
            entry.mz.push_back(static_cast<float>(m));
            entry.inten.push_back(static_cast<float>(i));
          } else {
            entry.malformed = true;
            break;
          }
        }
        cb = ce == e ? e : ce + 1;
      }
    }
    // No colon outside a peak list: ignored, like the Python reader.
  }
  close(fd);
  msp_finish(res, p, &entry, scratch);
  res->n_topn = scratch.n_topn;

  out_counts[0] = static_cast<int64_t>(res->precursor_mz.size());
  out_counts[1] = static_cast<int64_t>(res->mz.size());
  out_counts[2] = static_cast<int64_t>(res->title_bytes.size());
  out_counts[3] = res->n_read;
  out_counts[4] = res->n_low_quality;
  out_counts[5] = 0;
  out_counts[6] = n_blocks;
  return res;
}

// Parse + preprocess an entire MSP file (the [0, EOF) range).
void* fc_msp_ingest(const char* path, int min_peaks, double min_mz_range,
                    double mz_min, double mz_max,
                    double remove_precursor_tol, double min_intensity,
                    int max_peaks_used, int scaling, int64_t* out_counts) {
  return fc_msp_ingest_range(path, 0, -1, min_peaks, min_mz_range, mz_min,
                             mz_max, remove_precursor_tol, min_intensity,
                             max_peaks_used, scaling, out_counts);
}

// Copy the result arrays into caller-allocated buffers sized per
// fc_mgf_ingest's out_counts.  peak_offsets and title_offsets must hold
// n_spectra_kept + 1 entries.
int fc_mgf_result_copy(void* handle, double* precursor_mz, int32_t* charge,
                       double* retention_time, int64_t* peak_offsets,
                       float* mz, float* intensity, int64_t* title_offsets,
                       char* title_bytes) {
  if (!handle) return 1;
  auto* res = static_cast<IngestResult*>(handle);
  size_t n = res->precursor_mz.size();
  if (res->order.empty()) {
    std::memcpy(precursor_mz, res->precursor_mz.data(), n * sizeof(double));
    std::memcpy(charge, res->precursor_charge.data(), n * sizeof(int32_t));
    std::memcpy(retention_time, res->retention_time.data(),
                n * sizeof(double));
    std::memcpy(peak_offsets, res->peak_offsets.data(),
                (n + 1) * sizeof(int64_t));
    std::memcpy(mz, res->mz.data(), res->mz.size() * sizeof(float));
    std::memcpy(intensity, res->intensity.data(),
                res->intensity.size() * sizeof(float));
    std::memcpy(title_offsets, res->title_offsets.data(),
                (n + 1) * sizeof(int64_t));
    std::memcpy(title_bytes, res->title_bytes.data(),
                res->title_bytes.size());
    return 0;
  }
  peak_offsets[0] = title_offsets[0] = 0;
  for (size_t k = 0; k < n; ++k) {
    const int64_t i = res->order[k];
    precursor_mz[k] = res->precursor_mz[i];
    charge[k] = res->precursor_charge[i];
    retention_time[k] = res->retention_time[i];
    const int64_t p0 = res->peak_offsets[i], p1 = res->peak_offsets[i + 1];
    std::memcpy(mz + peak_offsets[k], res->mz.data() + p0,
                (p1 - p0) * sizeof(float));
    std::memcpy(intensity + peak_offsets[k], res->intensity.data() + p0,
                (p1 - p0) * sizeof(float));
    peak_offsets[k + 1] = peak_offsets[k] + (p1 - p0);
    const int64_t t0 = res->title_offsets[i], t1 = res->title_offsets[i + 1];
    std::memcpy(title_bytes + title_offsets[k], res->title_bytes.data() + t0,
                t1 - t0);
    title_offsets[k + 1] = title_offsets[k] + (t1 - t0);
  }
  return 0;
}

void fc_mgf_result_free(void* handle) {
  delete static_cast<IngestResult*>(handle);
}

// Spectra skipped for unsupported binary compression (numpress etc.) in
// the parse behind `handle`.  Guarded by hasattr on the Python side so
// a stale library build degrades to "no warning", never to a crash.
int64_t fc_result_n_unsupported(void* handle) {
  return static_cast<IngestResult*>(handle)->n_unsupported;
}

// Spectra of the parse behind `handle` that the intensity filter cut to
// max_peaks_used.
int64_t fc_result_n_topn(void* handle) {
  return static_cast<IngestResult*>(handle)->n_topn;
}

// Give the rows of the result behind `handle` out (fc_mgf_result_copy,
// fc_result_titles_u32) so that the rows of one store charge come
// together, in ascending order of that charge and each in file order: the
// order in which the store writes a batch.  The store charge is the charge
// cast to int16, with a missing charge (and the int16 sentinel itself) at
// INT16_MIN.
void fc_result_group_by_charge(void* handle) {
  auto* r = static_cast<IngestResult*>(handle);
  const size_t n = r->precursor_mz.size();
  std::vector<int16_t> key(n);
  bool grouped = true;
  for (size_t i = 0; i < n; ++i) {
    int32_t c = r->precursor_charge[i];
    key[i] = c == kNullCharge || c == INT16_MIN ? INT16_MIN
                                                : static_cast<int16_t>(c);
    grouped = grouped && (i == 0 || key[i - 1] <= key[i]);
  }
  r->order.clear();
  if (grouped) return;
  r->order.resize(n);
  std::iota(r->order.begin(), r->order.end(), 0);
  std::stable_sort(r->order.begin(), r->order.end(),
                   [&](int64_t a, int64_t b) { return key[a] < key[b]; });
}

// Width in code points of the longest title of the result behind `handle`
// (what NumPy's U dtype of the decoded titles takes), or -1 where a title
// is not well-formed UTF-8, so that decode("utf-8", "replace") would
// replace some of its bytes.
int64_t fc_result_title_width(void* handle) {
  auto* r = static_cast<IngestResult*>(handle);
  const auto* bytes =
      reinterpret_cast<const unsigned char*>(r->title_bytes.data());
  int64_t width = 0;
  for (size_t i = 0; i + 1 < r->title_offsets.size(); ++i) {
    int64_t n = utf8_decode(bytes + r->title_offsets[i],
                            bytes + r->title_offsets[i + 1], nullptr);
    if (n < 0) return -1;
    width = std::max(width, n);
  }
  return width;
}

// The titles as UCS4 code points, `width` a title, zero-padded: the bytes
// of a NumPy U{width} array.  `width` is at least fc_result_title_width's.
int fc_result_titles_u32(void* handle, uint32_t* out, int64_t width) {
  auto* r = static_cast<IngestResult*>(handle);
  const auto* bytes =
      reinterpret_cast<const unsigned char*>(r->title_bytes.data());
  const size_t n = r->title_offsets.size() - 1;
  std::memset(out, 0, n * width * sizeof(uint32_t));
  for (size_t k = 0; k < n; ++k) {
    const int64_t i = r->order.empty() ? static_cast<int64_t>(k) : r->order[k];
    int64_t got = utf8_decode(bytes + r->title_offsets[i],
                              bytes + r->title_offsets[i + 1],
                              out + k * width, width);
    if (got < 0) return 1;
  }
  return 0;
}

}  // extern "C"
