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
#include <numeric>
#include <string>
#include <vector>

#include "falcon_ascii.h"

namespace {

constexpr double kProton = 1.0072766;  // preprocess/spectrum.py:37
constexpr int32_t kNullCharge = INT32_MIN;

inline bool ascii_space(char c) { return falcon_ascii::space(c); }
inline char ascii_upper(char c) { return falcon_ascii::upper(c); }
inline char ascii_lower(char c) { return falcon_ascii::lower(c); }
inline bool ascii_digit(char c) { return falcon_ascii::digit(c); }

// Buffered line iterator over a file: fills a window with large freads
// and splits lines with memchr — the per-line getline it replaced
// measured ~1.8x slower on MGF scanning (per-line libc call + copy),
// while staying robust to concurrent truncation (a short read is EOF;
// an mmap of a shrinking file would SIGBUS the embedding process).
// Returned [b, e) pointers are valid until the next next_line call.
struct LineWindow {
  explicit LineWindow(FILE* f, int64_t base) : f_(f), base_(base) {
    window_.reserve(kChunk + 4096);
  }

  // Next line (without its trailing '\n').  Returns false at EOF.
  bool next_line(const char** b, const char** e, int64_t* line_start) {
    for (;;) {
      const char* nl = static_cast<const char*>(
          std::memchr(window_.data() + pos_, '\n', window_.size() - pos_));
      if (nl != nullptr) {
        *b = window_.data() + pos_;
        *e = nl;
        *line_start = base_ + static_cast<int64_t>(pos_);
        pos_ = static_cast<size_t>(nl - window_.data()) + 1;
        return true;
      }
      if (eof_) {
        if (pos_ >= window_.size()) return false;
        *b = window_.data() + pos_;  // final line without newline
        *e = window_.data() + window_.size();
        *line_start = base_ + static_cast<int64_t>(pos_);
        pos_ = window_.size();
        return true;
      }
      // Drop consumed bytes, then read more.
      base_ += static_cast<int64_t>(pos_);
      window_.erase(0, pos_);
      pos_ = 0;
      size_t old = window_.size();
      window_.resize(old + kChunk);
      size_t got = std::fread(&window_[old], 1, kChunk, f_);
      window_.resize(old + got);
      if (got == 0) eof_ = true;
    }
  }

 private:
  static constexpr size_t kChunk = 4 << 20;
  FILE* f_;
  std::string window_;
  size_t pos_ = 0;
  int64_t base_;  // absolute file offset of window_[0]
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

// The full preprocessing chain (preprocess/spectrum.py:136-200) on one
// spectrum's float32 peak arrays (already m/z-sorted by MGF convention;
// the Python path also assumes sorted input).  Returns false if rejected.
bool preprocess(std::vector<float>& mz, std::vector<float>& inten,
                double precursor_mz, int32_t charge, const Params& p) {
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
    std::vector<double> remove_mz;
    remove_mz.reserve(z);
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
  //    the max_peaks_used most intense; stable ascending sort so ties
  //    resolve by peak position.
  if ((!std::isnan(p.min_intensity) || p.max_peaks_used > 0) &&
      !inten.empty()) {
    double min_int = std::isnan(p.min_intensity) ? 0.0 : p.min_intensity;
    size_t n = inten.size();
    int64_t max_num = p.max_peaks_used > 0
                          ? p.max_peaks_used : static_cast<int64_t>(n);
    if (static_cast<int64_t>(n) <= max_num) {
      // Common case (most spectra have fewer peaks than the cap): the
      // top-N cut is inactive, so the sorted order is only needed for
      // the base peak — the kept set is exactly "intensity strictly
      // above min_int * base", in original order.  Skips the
      // stable_sort, which dominates the preprocessing profile.
      double base = static_cast<double>(
          *std::max_element(inten.begin(), inten.end()));
      double threshold = min_int * base;
      size_t w = 0;
      for (size_t i = 0; i < n; ++i) {
        if (static_cast<double>(inten[i]) > threshold) {
          mz[w] = mz[i];
          inten[w] = inten[i];
          ++w;
        }
      }
      mz.resize(w);
      inten.resize(w);
    } else {
      std::vector<int64_t> order(n);
      std::iota(order.begin(), order.end(), 0);
      std::stable_sort(order.begin(), order.end(),
                       [&](int64_t a, int64_t b) {
        return inten[a] < inten[b];
      });
      double threshold =
          min_int * static_cast<double>(inten[order.back()]);
      // side='right' searchsorted: first index with value > threshold.
      int64_t start_i = 0;
      while (start_i < static_cast<int64_t>(n) &&
             static_cast<double>(inten[order[start_i]]) <= threshold) {
        ++start_i;
      }
      int64_t lo = std::max(start_i, static_cast<int64_t>(n) - max_num);
      std::vector<uint8_t> keep(n, 0);
      for (int64_t i = lo; i < static_cast<int64_t>(n); ++i)
        keep[order[i]] = 1;
      size_t w = 0;
      for (size_t i = 0; i < n; ++i) {
        if (keep[i]) {
          mz[w] = mz[i];
          inten[w] = inten[i];
          ++w;
        }
      }
      mz.resize(w);
      inten.resize(w);
    }
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
                     std::vector<float>& inten) {
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
  if (!std::isfinite(rt) || !preprocess(mz, inten, pepmass, charge, p)) {
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
  std::string key(b, eq);
  size_t k0 = key.find_first_not_of(" \t");
  size_t k1 = key.find_last_not_of(" \t");
  key = k0 == std::string::npos ? "" : key.substr(k0, k1 - k0 + 1);
  for (auto& c : key) c = ascii_upper(c);
  std::string value(eq + 1, e);
  size_t v0 = value.find_first_not_of(" \t");
  size_t v1 = value.find_last_not_of(" \t");
  value = v0 == std::string::npos ? "" : value.substr(v0, v1 - v0 + 1);
  if (key == "TITLE") {
    out->title = value;
    out->have_title = true;
  } else if (key == "PEPMASS") {
    out->pepmass = value;
    out->have_pepmass = true;
  } else if (key == "RTINSECONDS") {
    out->rt = value;
    out->have_rt = true;
  } else if (key == "CHARGE") {
    out->charge = value;
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
void msp_finish(IngestResult* res, const Params& p, MspEntry* e) {
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
      !preprocess(e->mz, e->inten, precursor_mz, charge, p)) {
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

// Fill out_counts from a (possibly empty) result and hand it back —
// used when a range seek lands past EOF so the caller still gets a
// well-formed empty handle rather than NULL ("cannot open").
void* res_counts_empty(IngestResult* res, int64_t* out_counts) {
  out_counts[0] = static_cast<int64_t>(res->precursor_mz.size());
  out_counts[1] = static_cast<int64_t>(res->mz.size());
  out_counts[2] = static_cast<int64_t>(res->title_bytes.size());
  out_counts[3] = res->n_read;
  out_counts[4] = res->n_low_quality;
  out_counts[5] = 0;
  out_counts[6] = 0;
  return res;
}

}  // namespace

extern "C" {

// Preprocessing hook for sibling parsers (falcon_mzml.cc): runs the full
// chain in place on (mz, inten, *n) and shrinks *n; returns false when
// the spectrum fails a quality gate.
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
  if (!preprocess(mz, inten, precursor_mz, charge, p)) return false;
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
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  Params p{min_peaks, min_mz_range, mz_min, mz_max,
           remove_precursor_tol, min_intensity, max_peaks_used, scaling};
  auto* res = new IngestResult();

  int64_t base = 0;
  if (start > 0) {
    // A range that begins mid-line must not see that partial line: peek
    // at the byte before `start` — if it is not a newline, the line
    // containing `start` began earlier and belongs to the previous
    // range, so skip to the next line.
    if (std::fseek(f, static_cast<long>(start - 1), SEEK_SET) != 0) {
      std::fclose(f);
      return res_counts_empty(res, out_counts);
    }
    int prev = std::fgetc(f);
    base = start;
    if (prev != '\n' && prev != EOF) {
      int c;
      while ((c = std::fgetc(f)) != EOF) {
        ++base;
        if (c == '\n') break;
      }
    }
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

  LineWindow lines(f, base);
  const char* b;
  const char* e;
  int64_t line_start;
  while (lines.next_line(&b, &e, &line_start)) {
    // strip() both ends.
    while (b < e && ascii_space(*b)) ++b;
    while (e > b && ascii_space(e[-1])) --e;
    if (b == e || is_comment_start(*b)) continue;
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
        finish_spectrum(res, p, cur, mz, inten);
      }
      in_ions = false;
    } else if (in_ions) {
      const char* eq = static_cast<const char*>(std::memchr(b, '=', len));
      bool first_digit = ascii_digit(b[0]) || b[0] == '-';
      if (eq && !first_digit) {
        apply_mgf_param(b, e, eq, &cur);
      } else {
        // Peak line: >= 2 whitespace tokens; parse failures skip the line.
        const char* s = b;
        const char* tok0_b = s;
        while (s < e && !ascii_space(*s)) ++s;
        const char* tok0_e = s;
        while (s < e && ascii_space(*s)) ++s;
        const char* tok1_b = s;
        while (s < e && !ascii_space(*s)) ++s;
        const char* tok1_e = s;
        if (tok1_b == tok1_e) continue;  // fewer than 2 tokens
        double m, i;
        if (parse_double(tok0_b, tok0_e, &m) &&
            parse_double(tok1_b, tok1_e, &i)) {
          mz.push_back(static_cast<float>(m));
          inten.push_back(static_cast<float>(i));
        } else {
          // Mirrors the Python parser (and pyteomics raising inside the
          // reference's loop): the whole spectrum is skipped silently.
          malformed = true;
        }
      }
    }
  }
  std::fclose(f);

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
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  Params p{min_peaks, min_mz_range, mz_min, mz_max,
           remove_precursor_tol, min_intensity, max_peaks_used, scaling};
  auto* res = new IngestResult();

  int64_t base = 0;
  if (start > 0) {
    // Skip the partial line a mid-line range start would otherwise see
    // (same contract as fc_mgf_ingest_range).
    if (std::fseek(f, static_cast<long>(start - 1), SEEK_SET) != 0) {
      std::fclose(f);
      return res_counts_empty(res, out_counts);
    }
    int prev = std::fgetc(f);
    base = start;
    if (prev != '\n' && prev != EOF) {
      int c;
      while ((c = std::fgetc(f)) != EOF) {
        ++base;
        if (c == '\n') break;
      }
    }
  }

  MspEntry entry;
  int64_t n_blocks = 0;
  LineWindow lines(f, base);
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
        msp_finish(res, p, &entry);
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
        msp_finish(res, p, &entry);
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
  std::fclose(f);
  msp_finish(res, p, &entry);

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

void fc_mgf_result_free(void* handle) {
  delete static_cast<IngestResult*>(handle);
}

// Spectra skipped for unsupported binary compression (numpress etc.) in
// the parse behind `handle`.  Guarded by hasattr on the Python side so
// a stale library build degrades to "no warning", never to a crash.
int64_t fc_result_n_unsupported(void* handle) {
  return static_cast<IngestResult*>(handle)->n_unsupported;
}

}  // extern "C"
