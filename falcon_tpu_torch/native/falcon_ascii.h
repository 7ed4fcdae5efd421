// Locale-independent ASCII character classes shared by the native
// scanners.  The scanners must not use std::isspace/toupper/tolower:
// those are locale-aware libc calls per character (measurable in the
// line-strip loops) whose behavior for bytes >= 0x80 depends on the
// embedding process's locale (CPython coerces C to C.UTF-8), which
// would make parses non-deterministic across environments.  The sets
// below equal the "C"-locale classifications for all bytes.
#ifndef FALCON_ASCII_H_
#define FALCON_ASCII_H_

namespace falcon_ascii {

inline bool space(char c) { return c == ' ' || (c >= '\t' && c <= '\r'); }

inline char upper(char c) {
  return c >= 'a' && c <= 'z' ? static_cast<char>(c - 32) : c;
}

inline char lower(char c) {
  return c >= 'A' && c <= 'Z' ? static_cast<char>(c + 32) : c;
}

inline bool digit(char c) { return c >= '0' && c <= '9'; }

}  // namespace falcon_ascii

#endif  // FALCON_ASCII_H_
