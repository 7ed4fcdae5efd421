// falcon-tpu native mzML ingest fast path.
//
// First-party C++ streaming mzML scanner + the same preprocessing chain
// as the MGF fast path (falcon_ingest.cc), replacing the reference's
// pyteomics/lxml parse (falcon/ms_io/mzml_io.py:14-38) for the hot
// 1M-spectrum multi-file ingest (BASELINE config #2).  Semantics mirror
// falcon_tpu/ms_io/mzml_io.py: MS level > 1 only, id attribute as the
// identifier, scan start time normalized to SECONDS (minute-unit
// cvParams converted), charge from "charge state" falling back to
// "possible charge state", little-endian 32/64-bit float peak arrays,
// base64 + optional zlib; malformed spectra are skipped silently.
// Parity is enforced by tests/test_native_ingest.py.
//
// The scanner is NOT a general XML parser: it locates <spectrum ...>
// ... </spectrum> blocks and reads cvParam/binary elements inside them,
// which is exactly the subset the (machine-written) mzML format uses.
// A file whose tail is truncated mid-spectrum yields its complete
// blocks and sets the truncated flag (out_counts[5]) so the caller can
// warn like the Python reader does.

#include <algorithm>
#include <cctype>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <numeric>
#include <string>
#include <string_view>
#include <vector>

#include <zlib.h>

#include "falcon_ascii.h"

namespace {

constexpr int32_t kNullCharge = INT32_MIN;

// ---- shared with falcon_ingest.cc (kept in one translation unit each;
// the struct layout must match for the shared copy/free ABI).
struct IngestResult {
  std::vector<double> precursor_mz;
  std::vector<int32_t> precursor_charge;
  std::vector<double> retention_time;
  std::vector<int64_t> title_offsets{0};
  std::string title_bytes;
  std::vector<int64_t> peak_offsets{0};
  std::vector<float> mz;
  std::vector<float> intensity;
  int64_t n_read = 0;
  int64_t n_low_quality = 0;
  // Spectra skipped for unsupported binary compression (numpress
  // etc.) — surfaced so ingest can warn instead of silently
  // dropping a fully-numpress file.
  int64_t n_unsupported = 0;
  int64_t n_topn = 0;  // spectra cut to max_peaks_used
  std::vector<int64_t> order;  // the copies' row order; empty: as parsed
};

struct Params {
  int min_peaks;
  double min_mz_range;
  double mz_min, mz_max;
  double remove_precursor_tol;
  double min_intensity;
  int max_peaks_used;
  int scaling;
};

}  // namespace

// Preprocessing hook implemented in falcon_ingest.cc.
extern "C" bool fc_preprocess_spectrum(float* mz, float* inten, int64_t* n,
                                       double precursor_mz, int32_t charge,
                                       int min_peaks, double min_mz_range,
                                       double mz_min, double mz_max,
                                       double remove_precursor_tol,
                                       double min_intensity,
                                       int max_peaks_used, int scaling);
// The calling thread's count of top-N cuts so far (falcon_ingest.cc).
extern "C" int64_t fc_preprocess_topn();

namespace {

bool parse_double_sv(std::string_view s, double* out) {
  if (s.empty()) return false;
  if (s.front() == '+') s.remove_prefix(1);
  auto res = std::from_chars(s.data(), s.data() + s.size(), *out);
  return res.ec == std::errc() && res.ptr == s.data() + s.size();
}

// ---- base64 ----------------------------------------------------------
const int8_t kB64[256] = {
    // clang-format off
    -1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,
    -1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,
    -1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,62,-1,-1,-1,63,
    52,53,54,55,56,57,58,59,60,61,-1,-1,-1,-2,-1,-1,
    -1, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9,10,11,12,13,14,
    15,16,17,18,19,20,21,22,23,24,25,-1,-1,-1,-1,-1,
    -1,26,27,28,29,30,31,32,33,34,35,36,37,38,39,40,
    41,42,43,44,45,46,47,48,49,50,51,-1,-1,-1,-1,-1,
    -1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,
    -1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,
    -1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,
    -1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,
    -1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,
    -1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,
    -1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,
    -1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,
    // clang-format on
};

// The base64 decoder tests whitespace per byte of peak data, where a
// locale-aware libc call is measurable overhead (falcon_ascii.h).
inline bool ascii_space_c(char c) { return falcon_ascii::space(c); }

bool b64_decode(std::string_view in, std::vector<uint8_t>* out) {
  out->clear();
  out->reserve(in.size() * 3 / 4 + 4);
  uint32_t acc = 0;
  int bits = 0;
  for (char c : in) {
    int8_t v = kB64[static_cast<uint8_t>(c)];
    if (v == -2) break;  // '=' padding: done
    if (v < 0) {
      if (ascii_space_c(c)) continue;
      return false;
    }
    acc = (acc << 6) | static_cast<uint32_t>(v);
    bits += 6;
    if (bits >= 8) {
      bits -= 8;
      out->push_back(static_cast<uint8_t>((acc >> bits) & 0xFF));
    }
  }
  return true;
}

bool zlib_inflate(const std::vector<uint8_t>& in, std::vector<uint8_t>* out) {
  out->clear();
  out->resize(in.size() * 4 + 64);
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = const_cast<Bytef*>(in.data());
  zs.avail_in = static_cast<uInt>(in.size());
  size_t written = 0;
  int rc = Z_OK;
  while (rc != Z_STREAM_END) {
    if (written == out->size()) out->resize(out->size() * 2);
    zs.next_out = out->data() + written;
    zs.avail_out = static_cast<uInt>(out->size() - written);
    rc = inflate(&zs, Z_NO_FLUSH);
    if (rc != Z_OK && rc != Z_STREAM_END) {
      inflateEnd(&zs);
      return false;
    }
    written = zs.total_out;
  }
  inflateEnd(&zs);
  out->resize(written);
  return true;
}

// ---- shared ranged streaming scan ------------------------------------

size_t find_tag_open(const std::string& s, std::string_view name,
                     size_t from);

// Stream <open_name ...>...<close_tag> blocks of a byte range through
// `parse`.  Range ownership is by the absolute byte offset of each
// block's OPEN tag: a block belongs to [start, end) iff its open tag
// starts at an offset in [start, end), so splitting a file at arbitrary
// byte boundaries and concatenating the per-range results reproduces
// the whole-file scan exactly (a tag straddling `start` appears
// truncated in this range's window and cannot match — its owner is the
// previous range, which reads past its own `end` until every owned
// block closes).  end < 0 means to EOF.  advance_past_open: after a
// parse, resume searching just past the open tag instead of past the
// close tag (mzXML nests MS2 scans inside MS1 blocks).  Returns the
// truncated flag: an owned open tag whose block never closes by EOF.
template <typename ParseFn>
bool scan_blocks_range(FILE* f, int64_t start, int64_t end,
                       std::string_view open_name,
                       std::string_view close_tag,
                       bool advance_past_open, ParseFn parse) {
  if (start > 0 && std::fseek(f, static_cast<long>(start), SEEK_SET) != 0)
    return false;  // unseekable start: empty range, not truncation
  int64_t window_base = start;  // absolute file offset of window[0]
  std::string window;
  window.reserve(8 << 20);
  std::vector<char> buf(4 << 20);
  size_t search_from = 0;
  bool done = false;
  for (;;) {
    size_t got = std::fread(buf.data(), 1, buf.size(), f);
    if (got == 0) break;
    window.append(buf.data(), got);
    size_t pos;
    while ((pos = find_tag_open(window, open_name, search_from)) !=
           std::string::npos) {
      if (end >= 0 && window_base + static_cast<int64_t>(pos) >= end) {
        done = true;  // next range owns this block
        break;
      }
      size_t close = window.find(close_tag.data(), pos, close_tag.size());
      if (close == std::string::npos) {
        // Keep from this block's start; need more data.
        window_base += static_cast<int64_t>(pos);
        window.erase(0, pos);
        search_from = 0;
        break;
      }
      parse(std::string_view(window).substr(
          pos, close + close_tag.size() - pos));
      search_from = advance_past_open ? pos + open_name.size()
                                      : close + close_tag.size();
    }
    if (done) break;
    if (pos == std::string::npos) {
      // No block start in the searched region: keep a small tail in
      // case the open tag straddles the chunk boundary.
      size_t keep = window.size() > 16 ? 16 : window.size();
      window_base += static_cast<int64_t>(window.size() - keep);
      window.erase(0, window.size() - keep);
      search_from = 0;
      // Every offset still reachable is >= window_base: once that
      // passes `end`, no owned block can remain.
      if (end >= 0 && window_base >= end) break;
    }
  }
  if (!done) {
    // Unconsumed owned open tag at EOF = truncated document.
    size_t pos = find_tag_open(window, open_name, search_from);
    if (pos != std::string::npos &&
        (end < 0 || window_base + static_cast<int64_t>(pos) < end))
      return true;
  }
  return false;
}

// ---- tiny XML helpers (attribute scan within one tag) ----------------

// Find an element open tag "<name" followed by whitespace or a
// tag-ending character, so "<spectrum\n  id=...>" matches just like
// "<spectrum id=...>" (a bare prefix match would also hit e.g.
// "<spectrumList").  Returns npos when the name sits at the very end of
// the window (possibly split by the chunk boundary) — the caller keeps a
// tail and retries after the next read.
size_t find_tag_open(const std::string& s, std::string_view name,
                     size_t from) {
  size_t pos = from;
  while ((pos = s.find(name.data(), pos, name.size())) !=
         std::string::npos) {
    size_t after = pos + name.size();
    if (after >= s.size()) return std::string::npos;
    char c = s[after];
    if (c == ' ' || c == '\t' || c == '\r' || c == '\n' || c == '>' ||
        c == '/')
      return pos;
    ++pos;
  }
  return std::string::npos;
}

// Find attribute value inside tag text [tag_b, tag_e): name="value".
bool attr_value(std::string_view tag, std::string_view name,
                std::string_view* out) {
  size_t pos = 0;
  while ((pos = tag.find(name, pos)) != std::string_view::npos) {
    size_t after = pos + name.size();
    // must be preceded by space and followed by =" (attribute, not a
    // substring of another name)
    if (pos > 0 && !ascii_space_c(tag[pos - 1])) {
      pos = after;
      continue;
    }
    size_t eq = tag.find_first_not_of(" \t\r\n", after);
    if (eq == std::string_view::npos || tag[eq] != '=') {
      pos = after;
      continue;
    }
    size_t q = tag.find_first_of("\"'", eq + 1);
    if (q == std::string_view::npos) return false;
    char quote = tag[q];
    size_t end = tag.find(quote, q + 1);
    if (end == std::string_view::npos) return false;
    *out = tag.substr(q + 1, end - q - 1);
    return true;
  }
  return false;
}

// One cvParam's (accession, value, unit) inside a tag.
struct CvParam {
  std::string_view accession, value, unit_name, unit_acc;
};

// Iterate <cvParam .../> tags within [b, e); calls fn(param).
template <typename Fn>
void for_each_cvparam(std::string_view block, Fn fn) {
  size_t pos = 0;
  while ((pos = block.find("<cvParam", pos)) != std::string_view::npos) {
    size_t end = block.find('>', pos);
    if (end == std::string_view::npos) return;
    std::string_view tag = block.substr(pos, end - pos);
    CvParam p;
    attr_value(tag, "accession", &p.accession);
    attr_value(tag, "value", &p.value);
    attr_value(tag, "unitName", &p.unit_name);
    attr_value(tag, "unitAccession", &p.unit_acc);
    fn(p);
    pos = end + 1;
  }
}

struct BinaryArray {
  bool is_mz = false, is_intensity = false;
  bool f64 = true, zlib_c = false;
  // MS-Numpress compressions (MS:1002312-14 plain, MS:1002746-48 +zlib
  // combos) are not supported: decoding their payload as raw IEEE
  // floats would be silent garbage, so the spectrum is skipped
  // (mirrors ms_io/mzml_io.py:_ACC_NUMPRESS).
  bool unsupported = false;
  std::string_view payload;
};

bool is_numpress_accession(std::string_view acc) {
  return acc == "MS:1002312" || acc == "MS:1002313" ||
         acc == "MS:1002314" || acc == "MS:1002746" ||
         acc == "MS:1002747" || acc == "MS:1002748";
}

// Decode one <binaryDataArray> block.
bool parse_binary_array(std::string_view block, BinaryArray* out) {
  for_each_cvparam(block, [&](const CvParam& p) {
    if (p.accession == "MS:1000523") out->f64 = true;
    else if (p.accession == "MS:1000521") out->f64 = false;
    else if (p.accession == "MS:1000574") out->zlib_c = true;
    else if (p.accession == "MS:1000514") out->is_mz = true;
    else if (p.accession == "MS:1000515") out->is_intensity = true;
    else if (is_numpress_accession(p.accession)) out->unsupported = true;
  });
  // NB: "<binary" alone would also match the enclosing
  // <binaryDataArray> tag — require a tag-ending character after it.
  size_t b = 0;
  for (;;) {
    b = block.find("<binary", b);
    if (b == std::string_view::npos) return false;
    char next = b + 7 < block.size() ? block[b + 7] : '\0';
    if (next == '>' || next == ' ' || next == '/' || next == '\t') break;
    b += 7;
  }
  size_t open_end = block.find('>', b);
  if (open_end == std::string_view::npos) return false;
  if (block[open_end - 1] == '/') {  // <binary/>: empty
    out->payload = std::string_view();
    return true;
  }
  size_t close = block.find("</binary>", open_end);
  if (close == std::string_view::npos) return false;
  out->payload = block.substr(open_end + 1, close - open_end - 1);
  return true;
}

// Parse one <spectrum ...>...</spectrum> block into the result.
void parse_spectrum_block(std::string_view block, const Params& p,
                          IngestResult* res) {
  size_t tag_end = block.find('>');
  if (tag_end == std::string_view::npos) return;
  std::string_view open_tag = block.substr(0, tag_end);
  std::string_view id;
  if (!attr_value(open_tag, "id", &id)) return;

  int ms_level = -1;
  double rt = -1.0;
  double precursor_mz = std::nan("");
  int32_t charge = kNullCharge;
  bool have_possible_charge = false;
  int32_t possible_charge = kNullCharge;

  // Top-level + nested cvParams: scan sections separately so the scan /
  // selectedIon params use the right unit/fallback rules.
  // 1. ms level: anywhere before binaryDataArrayList (direct child in
  //    practice; accession is unique to it).
  for_each_cvparam(block, [&](const CvParam& p2) {
    if (p2.accession == "MS:1000511") {
      double v;
      if (parse_double_sv(p2.value, &v)) ms_level = static_cast<int>(v);
    }
  });
  if (ms_level <= 1) return;

  // 2. scan start time within <scanList>.
  size_t scan_b = block.find("<scanList");
  if (scan_b != std::string_view::npos) {
    size_t scan_e = block.find("</scanList>", scan_b);
    if (scan_e == std::string_view::npos) scan_e = block.size();
    for_each_cvparam(block.substr(scan_b, scan_e - scan_b),
                     [&](const CvParam& p2) {
      if (p2.accession == "MS:1000016") {
        double v;
        if (parse_double_sv(p2.value, &v)) {
          // Normalize to SECONDS (SURVEY.md §3.5 divergence): minute
          // units are converted.
          bool minutes =
              p2.unit_acc == "UO:0000031" ||
              (p2.unit_name.size() >= 6 &&
               p2.unit_name.substr(0, 6) == "minute");
          rt = minutes ? v * 60.0 : v;
        }
      }
    });
  }

  // 3. precursor selected ion.
  size_t ion_b = block.find("<selectedIon");
  if (ion_b != std::string_view::npos) {
    size_t ion_e = block.find("</selectedIon>", ion_b);
    if (ion_e == std::string_view::npos)
      ion_e = block.find("/>", ion_b);  // self-closing (no cvParams)
    if (ion_e == std::string_view::npos) ion_e = block.size();
    for_each_cvparam(block.substr(ion_b, ion_e - ion_b),
                     [&](const CvParam& p2) {
      double v;
      if (p2.accession == "MS:1000744") {
        if (parse_double_sv(p2.value, &v)) precursor_mz = v;
      } else if (p2.accession == "MS:1000041") {
        if (parse_double_sv(p2.value, &v))
          charge = static_cast<int32_t>(v);
      } else if (p2.accession == "MS:1000633") {
        if (parse_double_sv(p2.value, &v)) {
          have_possible_charge = true;
          possible_charge = static_cast<int32_t>(v);
        }
      }
    });
  }
  if (charge == kNullCharge && have_possible_charge)
    charge = possible_charge;
  if (std::isnan(precursor_mz)) return;  // incomplete: skip silently

  // 4. binary peak arrays.
  std::vector<float> mz_arr, int_arr;
  bool have_mz = false, have_int = false;
  size_t pos = 0;
  std::vector<uint8_t> raw, inflated;
  while ((pos = block.find("<binaryDataArray", pos)) !=
         std::string_view::npos) {
    size_t bda_e = block.find("</binaryDataArray>", pos);
    if (bda_e == std::string_view::npos) break;
    BinaryArray arr;
    if (parse_binary_array(block.substr(pos, bda_e - pos), &arr) &&
        (arr.is_mz || arr.is_intensity)) {
      if (arr.unsupported) {  // numpress payload: skip the spectrum
        ++res->n_unsupported;
        return;
      }
      if (!b64_decode(arr.payload, &raw)) return;  // malformed: skip
      const std::vector<uint8_t>* bytes = &raw;
      if (arr.zlib_c) {
        if (!zlib_inflate(raw, &inflated)) return;
        bytes = &inflated;
      }
      std::vector<float>* dst = arr.is_mz ? &mz_arr : &int_arr;
      if (arr.f64) {
        size_t count = bytes->size() / 8;
        dst->resize(count);
        const double* src =
            reinterpret_cast<const double*>(bytes->data());
        for (size_t i = 0; i < count; ++i)
          (*dst)[i] = static_cast<float>(src[i]);
      } else {
        size_t count = bytes->size() / 4;
        dst->resize(count);
        std::memcpy(dst->data(), bytes->data(), count * 4);
      }
      (arr.is_mz ? have_mz : have_int) = true;
    }
    pos = bda_e + 1;
  }
  if (!have_mz || !have_int) return;  // incomplete: skip silently
  size_t n_peaks = std::min(mz_arr.size(), int_arr.size());
  mz_arr.resize(n_peaks);
  int_arr.resize(n_peaks);

  // Guarantee m/z-sorted peaks (containers.Spectrum does the same).
  bool sorted = true;
  for (size_t i = 1; i < n_peaks; ++i) {
    if (mz_arr[i] < mz_arr[i - 1]) {
      sorted = false;
      break;
    }
  }
  if (!sorted) {
    std::vector<int64_t> order(n_peaks);
    std::iota(order.begin(), order.end(), 0);
    std::stable_sort(order.begin(), order.end(),
                     [&](int64_t a, int64_t b) {
                       return mz_arr[a] < mz_arr[b];
                     });
    std::vector<float> m2(n_peaks), i2(n_peaks);
    for (size_t i = 0; i < n_peaks; ++i) {
      m2[i] = mz_arr[order[i]];
      i2[i] = int_arr[order[i]];
    }
    mz_arr = std::move(m2);
    int_arr = std::move(i2);
  }

  res->n_read += 1;
  int64_t n = static_cast<int64_t>(n_peaks);
  // Non-finite RT would poison the RT-refinement sort; missing RT is
  // always the finite -1.0 (SURVEY.md §3.5).
  if (!std::isfinite(rt) ||
      !fc_preprocess_spectrum(mz_arr.data(), int_arr.data(), &n,
                              precursor_mz, charge, p.min_peaks,
                              p.min_mz_range, p.mz_min, p.mz_max,
                              p.remove_precursor_tol, p.min_intensity,
                              p.max_peaks_used, p.scaling)) {
    res->n_low_quality += 1;
    return;
  }
  res->precursor_mz.push_back(precursor_mz);
  res->precursor_charge.push_back(charge);
  res->retention_time.push_back(rt);
  res->title_bytes.append(id.data(), id.size());
  res->title_offsets.push_back(
      static_cast<int64_t>(res->title_bytes.size()));
  res->mz.insert(res->mz.end(), mz_arr.begin(), mz_arr.begin() + n);
  res->intensity.insert(res->intensity.end(), int_arr.begin(),
                        int_arr.begin() + n);
  res->peak_offsets.push_back(static_cast<int64_t>(res->mz.size()));
}

}  // namespace

extern "C" {

// Parse + preprocess an mzML byte range [start, end) of a file (block
// ownership by <spectrum ...> open-tag offset — see scan_blocks_range;
// end < 0 means to EOF).  Same result ABI as fc_mgf_ingest (copy with
// fc_mgf_result_copy, free with fc_mgf_result_free); out_counts =
// [n_kept, n_peaks, title_bytes, n_read, n_low_quality,
// truncated_flag, n_blocks].
void* fc_mzml_ingest_range(const char* path, int64_t start, int64_t end,
                           int min_peaks, double min_mz_range,
                           double mz_min, double mz_max,
                           double remove_precursor_tol,
                           double min_intensity, int max_peaks_used,
                           int scaling, int64_t* out_counts) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  Params p{min_peaks, min_mz_range, mz_min, mz_max,
           remove_precursor_tol, min_intensity, max_peaks_used, scaling};
  auto* res = new IngestResult();
  const int64_t topn0 = fc_preprocess_topn();
  int64_t n_blocks = 0;  // structural <spectrum> elements found (any
                         // MS level) — distinguishes "scanner saw
                         // nothing" from "file has no MS2 spectra"
  bool truncated = scan_blocks_range(
      f, start, end, "<spectrum", "</spectrum>", false,
      [&](std::string_view block) {
        ++n_blocks;
        parse_spectrum_block(block, p, res);
      });
  std::fclose(f);
  res->n_topn = fc_preprocess_topn() - topn0;

  out_counts[0] = static_cast<int64_t>(res->precursor_mz.size());
  out_counts[1] = static_cast<int64_t>(res->mz.size());
  out_counts[2] = static_cast<int64_t>(res->title_bytes.size());
  out_counts[3] = res->n_read;
  out_counts[4] = res->n_low_quality;
  out_counts[5] = truncated ? 1 : 0;
  out_counts[6] = n_blocks;
  return res;
}

// Parse + preprocess an entire mzML file (the [0, EOF) range).
void* fc_mzml_ingest(const char* path, int min_peaks, double min_mz_range,
                     double mz_min, double mz_max,
                     double remove_precursor_tol, double min_intensity,
                     int max_peaks_used, int scaling, int64_t* out_counts) {
  return fc_mzml_ingest_range(path, 0, -1, min_peaks, min_mz_range,
                              mz_min, mz_max, remove_precursor_tol,
                              min_intensity, max_peaks_used, scaling,
                              out_counts);
}

}  // extern "C"

// ---------------------------------------------------------------------
// mzXML: same streaming-scanner approach for <scan> blocks.  Semantics
// mirror falcon_tpu/ms_io/mzxml_io.py: msLevel > 1 only, identifier =
// the scan "num", retentionTime xs:duration normalized to SECONDS,
// precursorMz element text + precursorCharge attribute, <peaks> base64
// with network (big-endian) byte order, 32/64-bit floats, interleaved
// m/z-intensity pairs, optional zlib.  mzXML nests MS2 scans inside
// MS1 scans, so the scanner advances past each scan OPEN tag rather
// than past the block (inner scans are then found on later iterations;
// the outer MS1 block parse skips at the msLevel gate before touching
// peaks).

namespace {

// xs:duration ("PT123.4S", "PT2M30S", ...) or plain number -> seconds.
// Mirrors mzxml_io._parse_retention_time.
double parse_duration_seconds(std::string_view s) {
  if (s.empty()) return -1.0;
  double plain;
  if (parse_double_sv(s, &plain)) return plain;
  size_t i = 0;
  double sign = 1.0;
  if (s[i] == '-') { sign = -1.0; ++i; }
  if (i >= s.size() || s[i] != 'P') return -1.0;
  ++i;
  bool in_time = false;
  double total = 0.0;
  while (i < s.size()) {
    if (s[i] == 'T') { in_time = true; ++i; continue; }
    size_t j = i;
    while (j < s.size() &&
           (falcon_ascii::digit(s[j]) || s[j] == '.'))
      ++j;
    if (j == i || j >= s.size()) return -1.0;
    double v;
    if (!parse_double_sv(s.substr(i, j - i), &v)) return -1.0;
    switch (s[j]) {
      case 'D': total += v * 86400.0; break;
      case 'H': total += v * 3600.0; break;
      case 'M': total += in_time ? v * 60.0 : 0.0; break;
      case 'S': total += v; break;
      default: return -1.0;
    }
    i = j + 1;
  }
  return sign * total;
}

void parse_scan_block(std::string_view block, const Params& p,
                      IngestResult* res) {
  size_t tag_end = block.find('>');
  if (tag_end == std::string_view::npos) return;
  std::string_view open_tag = block.substr(0, tag_end);
  std::string_view num, level_s, rt_s;
  if (!attr_value(open_tag, "num", &num)) return;
  double level = -1.0;
  if (attr_value(open_tag, "msLevel", &level_s))
    parse_double_sv(level_s, &level);
  if (level <= 1.0) return;
  double rt = -1.0;
  if (attr_value(open_tag, "retentionTime", &rt_s))
    rt = parse_duration_seconds(rt_s);

  // <precursorMz ...>value</precursorMz> (first occurrence).
  double precursor_mz = std::nan("");
  int32_t charge = kNullCharge;
  size_t pm = block.find("<precursorMz");
  if (pm != std::string_view::npos) {
    size_t open_end = block.find('>', pm);
    size_t close = block.find("</precursorMz>", pm);
    if (open_end != std::string_view::npos &&
        close != std::string_view::npos && close > open_end) {
      std::string_view tag = block.substr(pm, open_end - pm);
      std::string_view charge_s;
      if (attr_value(tag, "precursorCharge", &charge_s)) {
        double cv;
        if (parse_double_sv(charge_s, &cv))
          charge = static_cast<int32_t>(cv);
      }
      std::string_view text =
          block.substr(open_end + 1, close - open_end - 1);
      // strip whitespace
      while (!text.empty() && ascii_space_c(text.front()))
        text.remove_prefix(1);
      while (!text.empty() && ascii_space_c(text.back()))
        text.remove_suffix(1);
      parse_double_sv(text, &precursor_mz);
    }
  }
  if (std::isnan(precursor_mz)) return;  // incomplete: skip silently

  // <peaks ...>b64</peaks>
  size_t pk = block.find("<peaks");
  if (pk == std::string_view::npos) return;
  size_t open_end = block.find('>', pk);
  size_t close = block.find("</peaks>", pk);
  if (open_end == std::string_view::npos ||
      close == std::string_view::npos || close <= open_end)
    return;
  std::string_view tag = block.substr(pk, open_end - pk);
  std::string_view prec_s, comp_s, order_s;
  bool f64 = false;
  if (attr_value(tag, "precision", &prec_s)) f64 = prec_s == "64";
  bool zl = false;
  if (attr_value(tag, "compressionType", &comp_s)) {
    std::string low(comp_s);
    for (auto& c : low) c = falcon_ascii::lower(c);
    zl = low == "zlib";
    // Unknown compression (e.g. MS-Numpress): raw-float decode would be
    // silent garbage — skip the scan (ms_io/mzxml_io.py does the same).
    if (!zl && low != "none" && !low.empty()) {
      ++res->n_unsupported;
      return;
    }
  }
  bool big_endian = true;  // mzXML "network" default
  if (attr_value(tag, "byteOrder", &order_s)) {
    std::string low(order_s);
    for (auto& c : low) c = falcon_ascii::lower(c);
    big_endian = low == "network" || low == "big";
  }
  std::vector<uint8_t> raw, inflated;
  if (!b64_decode(block.substr(open_end + 1, close - open_end - 1), &raw))
    return;
  const std::vector<uint8_t>* bytes = &raw;
  if (zl) {
    if (!zlib_inflate(raw, &inflated)) return;
    bytes = &inflated;
  }
  size_t width = f64 ? 8 : 4;
  size_t n_vals = bytes->size() / width;
  size_t n_peaks = n_vals / 2;
  // Consume only complete (m/z, intensity) pairs: corrupt payloads can
  // decode to an odd n_vals, and the final unpaired value would write
  // mz_arr[n_peaks] — one past the end.
  n_vals = n_peaks * 2;
  std::vector<float> mz_arr(n_peaks), int_arr(n_peaks);
  for (size_t i = 0; i < n_vals; ++i) {
    uint64_t u = 0;
    const uint8_t* b = bytes->data() + i * width;
    if (big_endian) {
      for (size_t k = 0; k < width; ++k) u = (u << 8) | b[k];
    } else {
      for (size_t k = width; k > 0; --k) u = (u << 8) | b[k - 1];
    }
    double v;
    if (f64) {
      uint64_t bits = u;
      std::memcpy(&v, &bits, 8);
    } else {
      uint32_t bits = static_cast<uint32_t>(u);
      float fv;
      std::memcpy(&fv, &bits, 4);
      v = fv;
    }
    if (i % 2 == 0) mz_arr[i / 2] = static_cast<float>(v);
    else int_arr[i / 2] = static_cast<float>(v);
  }

  // Guarantee m/z-sorted peaks (containers.Spectrum does the same).
  bool sorted = true;
  for (size_t i = 1; i < n_peaks; ++i) {
    if (mz_arr[i] < mz_arr[i - 1]) { sorted = false; break; }
  }
  if (!sorted) {
    std::vector<int64_t> ord(n_peaks);
    std::iota(ord.begin(), ord.end(), 0);
    std::stable_sort(ord.begin(), ord.end(), [&](int64_t a, int64_t b) {
      return mz_arr[a] < mz_arr[b];
    });
    std::vector<float> m2(n_peaks), i2(n_peaks);
    for (size_t i = 0; i < n_peaks; ++i) {
      m2[i] = mz_arr[ord[i]];
      i2[i] = int_arr[ord[i]];
    }
    mz_arr = std::move(m2);
    int_arr = std::move(i2);
  }

  res->n_read += 1;
  int64_t n = static_cast<int64_t>(n_peaks);
  // Non-finite RT would poison the RT-refinement sort; missing RT is
  // always the finite -1.0 (SURVEY.md §3.5).
  if (!std::isfinite(rt) ||
      !fc_preprocess_spectrum(mz_arr.data(), int_arr.data(), &n,
                              precursor_mz, charge, p.min_peaks,
                              p.min_mz_range, p.mz_min, p.mz_max,
                              p.remove_precursor_tol, p.min_intensity,
                              p.max_peaks_used, p.scaling)) {
    res->n_low_quality += 1;
    return;
  }
  res->precursor_mz.push_back(precursor_mz);
  res->precursor_charge.push_back(charge);
  res->retention_time.push_back(rt);
  res->title_bytes.append(num.data(), num.size());
  res->title_offsets.push_back(
      static_cast<int64_t>(res->title_bytes.size()));
  res->mz.insert(res->mz.end(), mz_arr.begin(), mz_arr.begin() + n);
  res->intensity.insert(res->intensity.end(), int_arr.begin(),
                        int_arr.begin() + n);
  res->peak_offsets.push_back(static_cast<int64_t>(res->mz.size()));
}

}  // namespace

extern "C" {

// Parse + preprocess an mzXML byte range [start, end); same ABI and
// range semantics as fc_mzml_ingest_range.  Ownership is by each
// <scan> open tag's own offset (MS1 and nested MS2 alike), and the
// scanner advances past each OPEN tag only, so nested MS2 scans are
// found on later iterations exactly like the whole-file scan — a range
// may thus start inside an outer MS1 block and still own the nested
// MS2 scans whose open tags fall inside it.
void* fc_mzxml_ingest_range(const char* path, int64_t start, int64_t end,
                            int min_peaks, double min_mz_range,
                            double mz_min, double mz_max,
                            double remove_precursor_tol,
                            double min_intensity, int max_peaks_used,
                            int scaling, int64_t* out_counts) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  Params p{min_peaks, min_mz_range, mz_min, mz_max,
           remove_precursor_tol, min_intensity, max_peaks_used, scaling};
  auto* res = new IngestResult();
  const int64_t topn0 = fc_preprocess_topn();
  int64_t n_blocks = 0;  // structural <scan> elements found (any level)
  bool truncated = scan_blocks_range(
      f, start, end, "<scan", "</scan>", true,
      [&](std::string_view block) {
        ++n_blocks;
        parse_scan_block(block, p, res);
      });
  std::fclose(f);
  res->n_topn = fc_preprocess_topn() - topn0;

  out_counts[0] = static_cast<int64_t>(res->precursor_mz.size());
  out_counts[1] = static_cast<int64_t>(res->mz.size());
  out_counts[2] = static_cast<int64_t>(res->title_bytes.size());
  out_counts[3] = res->n_read;
  out_counts[4] = res->n_low_quality;
  out_counts[5] = truncated ? 1 : 0;
  out_counts[6] = n_blocks;
  return res;
}

// Parse + preprocess an entire mzXML file; same ABI as fc_mzml_ingest.
void* fc_mzxml_ingest(const char* path, int min_peaks, double min_mz_range,
                      double mz_min, double mz_max,
                      double remove_precursor_tol, double min_intensity,
                      int max_peaks_used, int scaling,
                      int64_t* out_counts) {
  return fc_mzxml_ingest_range(path, 0, -1, min_peaks, min_mz_range,
                               mz_min, mz_max, remove_precursor_tol,
                               min_intensity, max_peaks_used, scaling,
                               out_counts);
}

}  // extern "C"
