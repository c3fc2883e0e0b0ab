// Tar index over an in-memory archive, for the image loaders.
//
// The port's own copy of `native/keystone_io.cpp:198-300` (`tar_octal`,
// `ks_tar_index`: ustar, pax and GNU long names). It links nothing but
// the C++ runtime, so it builds on a machine without libjpeg; the JPEG
// decoder is `jpeg_baseline.cpp`.
//
// Built by `ops/_build.py`'s host route: c++ -O3 -fPIC -shared -pthread
// -std=c++17.

#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {

// ------------------------------------------------------------- tar (ustar)
//
// The reference streams training archives with commons-compress
// (loaders/ImageLoaderUtils.scala:56-94). Here: an in-memory ustar index
// over an mmap'able buffer — offsets let Python slice entries zero-copy.

static int64_t tar_octal(const uint8_t* p, int n) {
  // GNU base-256 extension: high bit of first byte set.
  if (p[0] & 0x80) {
    int64_t v = p[0] & 0x7f;
    for (int i = 1; i < n; ++i) v = (v << 8) | p[i];
    return v;
  }
  int64_t v = 0;
  for (int i = 0; i < n; ++i) {
    const uint8_t c = p[i];
    if (c == 0 || c == ' ') { if (v) break; else continue; }
    if (c < '0' || c > '7') return -1;
    v = v * 8 + (c - '0');
  }
  return v;
}

// Scan a tar buffer. Fills up to `cap` entries: data offset, data size,
// and the entry name (NUL-terminated, truncated to name_cap incl. NUL).
// Returns the total number of regular-file entries (may exceed cap), or
// -1 on a malformed archive.
int64_t ks_tar_index(const uint8_t* buf, int64_t len, int64_t* out_offsets,
                     int64_t* out_sizes, char* out_names, int64_t name_cap,
                     int64_t cap) {
  if (!buf || len < 0) return -1;
  int64_t pos = 0, count = 0;
  char longname[4096];
  bool have_longname = false;
  while (pos + 512 <= len) {
    const uint8_t* h = buf + pos;
    bool empty = true;
    for (int i = 0; i < 512 && empty; ++i) empty = (h[i] == 0);
    if (empty) break;  // end-of-archive marker
    const int64_t size = tar_octal(h + 124, 12);
    // overflow-safe bounds check (size can be attacker-controlled)
    if (size < 0 || size > len - 512 - pos) return -1;
    const uint8_t type = h[156];
    const int64_t data = pos + 512;
    if (type == 'L') {  // GNU longname: data block holds the real name
      int64_t m = size < (int64_t)sizeof(longname) - 1
                      ? size : (int64_t)sizeof(longname) - 1;
      memcpy(longname, buf + data, m);
      longname[m] = 0;
      have_longname = true;
    } else if (type == 'x' || type == 'X') {
      // PAX extended header (Python tarfile's default format): records are
      // "<len> key=value\n"; a "path" record overrides the next entry's name.
      const uint8_t* p = buf + data;
      int64_t rem = size;
      while (rem > 0) {
        int64_t rl = 0, di = 0;
        while (di < rem && p[di] >= '0' && p[di] <= '9') {
          rl = rl * 10 + (p[di] - '0');
          ++di;
        }
        if (di >= rem || p[di] != ' ' || rl <= 0 || rl > rem) break;
        const uint8_t* kv = p + di + 1;
        const int64_t kvlen = rl - di - 1;
        if (kvlen > 5 && memcmp(kv, "path=", 5) == 0) {
          int64_t m = kvlen - 5;
          if (m > 0 && kv[5 + m - 1] == '\n') --m;
          if (m > (int64_t)sizeof(longname) - 1) m = sizeof(longname) - 1;
          memcpy(longname, kv + 5, m);
          longname[m] = 0;
          have_longname = true;
        }
        p += rl;
        rem -= rl;
      }
    } else if (type == 0 || type == '0') {  // regular file
      if (count < cap) {
        out_offsets[count] = data;
        out_sizes[count] = size;
        char* dst = out_names + count * name_cap;
        if (have_longname) {
          strncpy(dst, longname, name_cap - 1);
          dst[name_cap - 1] = 0;
        } else {
          // POSIX ustar ("ustar\0"): optional 155-byte prefix at 345.
          // Old-GNU ("ustar  ") reuses that region for atime — skip it.
          char name[101], prefix[156];
          memcpy(name, h, 100); name[100] = 0;
          memcpy(prefix, h + 345, 155); prefix[155] = 0;
          const bool posix_ustar = memcmp(h + 257, "ustar\0", 6) == 0;
          if (posix_ustar && prefix[0])
            snprintf(dst, name_cap, "%s/%s", prefix, name);
          else {
            strncpy(dst, name, name_cap - 1);
            dst[name_cap - 1] = 0;
          }
        }
      }
      have_longname = false;
      ++count;
    } else if (type != 'g') {
      // 'g' (pax global) keeps any pending longname; others consume it
      have_longname = false;
    }
    pos = data + ((size + 511) / 512) * 512;
  }
  return count;
}

}  // extern "C"
