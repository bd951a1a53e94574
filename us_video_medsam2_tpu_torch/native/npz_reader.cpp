// Native NPZ reader: the data pipeline's C++ reader of NPZ videos.
//
// The training pipeline streams NPZ medical videos (imgs/gts arrays). Python's
// zipfile+numpy path holds the GIL during inflate, so a Python thread pool
// cannot overlap decode with the training step. This library parses the zip
// central directory and inflates entries with zlib entirely in C++; the ctypes
// binding releases the GIL, so a plain Python ThreadPool achieves true parallel
// decode + host-side prefetch while the device runs.
//
// Exposed C ABI (see us_video_medsam2_tpu_torch/training/native_npz.py):
//   npz_list(path, out_json, cap)        -> entries as a tiny JSON list
//   npz_array_info(path, name, ...)      -> dtype char, itemsize, ndim, shape
//   npz_read_array(path, name, out, cap) -> raw array bytes (C order)
//
// Built at first use by training/native_npz.py:
//   c++ -O3 -fPIC -std=c++17 -shared npz_reader.cpp -o <build>/libnpz_reader-<hash>.so -lz

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <zlib.h>

namespace {

struct Entry {
  std::string name;
  uint64_t header_offset;
  uint64_t comp_size;
  uint64_t uncomp_size;
  uint16_t method;  // 0 = stored, 8 = deflate
};

uint16_t rd16(const uint8_t* p) { return (uint16_t)p[0] | ((uint16_t)p[1] << 8); }
uint32_t rd32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

bool read_file(const char* path, std::vector<uint8_t>& buf) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  buf.resize(n);
  size_t got = fread(buf.data(), 1, n, f);
  fclose(f);
  return got == (size_t)n;
}

// Parse the central directory (EOCD scan from the end).
bool parse_zip(const std::vector<uint8_t>& z, std::vector<Entry>& entries) {
  if (z.size() < 22) return false;
  size_t eocd = std::string::npos;
  size_t scan_from = z.size() >= 22 + 65536 ? z.size() - 22 - 65536 : 0;
  for (size_t i = z.size() - 22; ; --i) {
    if (rd32(&z[i]) == 0x06054b50) { eocd = i; break; }
    if (i == scan_from) break;
  }
  if (eocd == std::string::npos) return false;
  uint16_t total = rd16(&z[eocd + 10]);
  uint32_t cd_off = rd32(&z[eocd + 16]);
  size_t p = cd_off;
  for (uint16_t i = 0; i < total; i++) {
    if (p + 46 > z.size() || rd32(&z[p]) != 0x02014b50) return false;
    Entry e;
    e.method = rd16(&z[p + 10]);
    e.comp_size = rd32(&z[p + 20]);
    e.uncomp_size = rd32(&z[p + 24]);
    uint16_t name_len = rd16(&z[p + 28]);
    uint16_t extra_len = rd16(&z[p + 30]);
    uint16_t comment_len = rd16(&z[p + 32]);
    e.header_offset = rd32(&z[p + 42]);
    e.name.assign((const char*)&z[p + 46], name_len);
    entries.push_back(e);
    p += 46 + name_len + extra_len + comment_len;
  }
  return true;
}

bool extract(const std::vector<uint8_t>& z, const Entry& e, std::vector<uint8_t>& out) {
  size_t p = e.header_offset;
  if (p + 30 > z.size() || rd32(&z[p]) != 0x04034b50) return false;
  uint16_t name_len = rd16(&z[p + 26]);
  uint16_t extra_len = rd16(&z[p + 28]);
  size_t data = p + 30 + name_len + extra_len;
  out.resize(e.uncomp_size);
  if (e.method == 0) {
    if (data + e.uncomp_size > z.size()) return false;
    memcpy(out.data(), &z[data], e.uncomp_size);
    return true;
  }
  if (e.method != 8) return false;
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -15) != Z_OK) return false;  // raw deflate
  zs.next_in = const_cast<uint8_t*>(&z[data]);
  zs.avail_in = (uInt)e.comp_size;
  zs.next_out = out.data();
  zs.avail_out = (uInt)out.size();
  int rc = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  return rc == Z_STREAM_END;
}

// Parse an .npy header: returns dtype char + itemsize + shape; data_off set to
// the start of the raw buffer. Only C-order little-endian arrays (numpy default).
bool parse_npy(const std::vector<uint8_t>& npy, char* dtype_char, int* itemsize,
               int64_t* shape, int* ndim, size_t* data_off) {
  if (npy.size() < 10 || memcmp(npy.data(), "\x93NUMPY", 6) != 0) return false;
  uint8_t major = npy[6];
  size_t hlen, hoff;
  if (major == 1) { hlen = rd16(&npy[8]); hoff = 10; }
  else { hlen = rd32(&npy[8]); hoff = 12; }
  std::string hdr((const char*)&npy[hoff], hlen);
  *data_off = hoff + hlen;

  size_t dpos = hdr.find("'descr':");
  size_t q1 = hdr.find('\'', dpos + 8);
  size_t q2 = hdr.find('\'', q1 + 1);
  std::string descr = hdr.substr(q1 + 1, q2 - q1 - 1);
  if (descr.size() >= 3 && descr[0] == '>') return false;  // big endian unsupported
  *dtype_char = descr[descr.size() - 2];
  *itemsize = atoi(descr.c_str() + descr.size() - 1);
  // multi-digit itemsize (e.g. <f16? rare) — re-parse digits
  {
    size_t d = 1;
    while (d < descr.size() && !isdigit(descr[d])) d++;
    if (d < descr.size()) {
      *itemsize = atoi(descr.c_str() + d);
      *dtype_char = descr[d - 1];
    }
  }
  if (hdr.find("'fortran_order': True") != std::string::npos) return false;

  size_t spos = hdr.find("'shape':");
  size_t o1 = hdr.find('(', spos);
  size_t o2 = hdr.find(')', o1);
  std::string tup = hdr.substr(o1 + 1, o2 - o1 - 1);
  int n = 0;
  const char* c = tup.c_str();
  while (*c) {
    while (*c == ' ' || *c == ',') c++;
    if (!*c) break;
    shape[n++] = strtoll(c, (char**)&c, 10);
    if (n >= 8) break;
  }
  *ndim = n;
  return true;
}

bool find_entry(const std::vector<Entry>& entries, const char* name, Entry& out) {
  std::string want1 = std::string(name);
  std::string want2 = want1 + ".npy";
  for (const auto& e : entries) {
    if (e.name == want1 || e.name == want2) { out = e; return true; }
  }
  return false;
}

}  // namespace

extern "C" {

// JSON list of entry names -> out (null-terminated). Returns 0 on success.
int npz_list(const char* path, char* out, int64_t cap) {
  std::vector<uint8_t> z;
  if (!read_file(path, z)) return -1;
  std::vector<Entry> entries;
  if (!parse_zip(z, entries)) return -2;
  std::string json = "[";
  for (size_t i = 0; i < entries.size(); i++) {
    std::string n = entries[i].name;
    if (n.size() > 4 && n.substr(n.size() - 4) == ".npy") n = n.substr(0, n.size() - 4);
    json += "\"" + n + "\"";
    if (i + 1 < entries.size()) json += ",";
  }
  json += "]";
  if ((int64_t)json.size() + 1 > cap) return -3;
  memcpy(out, json.c_str(), json.size() + 1);
  return 0;
}

// dtype char ('f','i','u','b'), itemsize, ndim, shape[8]. Returns 0 on success.
int npz_array_info(const char* path, const char* name, char* dtype_char,
                   int* itemsize, int* ndim, int64_t* shape) {
  std::vector<uint8_t> z;
  if (!read_file(path, z)) return -1;
  std::vector<Entry> entries;
  if (!parse_zip(z, entries)) return -2;
  Entry e;
  if (!find_entry(entries, name, e)) return -4;
  std::vector<uint8_t> npy;
  if (!extract(z, e, npy)) return -5;
  size_t off;
  if (!parse_npy(npy, dtype_char, itemsize, shape, ndim, &off)) return -6;
  return 0;
}

// Raw array bytes (C order) into out. Returns bytes written, negative on error.
int64_t npz_read_array(const char* path, const char* name, uint8_t* out, int64_t cap) {
  std::vector<uint8_t> z;
  if (!read_file(path, z)) return -1;
  std::vector<Entry> entries;
  if (!parse_zip(z, entries)) return -2;
  Entry e;
  if (!find_entry(entries, name, e)) return -4;
  std::vector<uint8_t> npy;
  if (!extract(z, e, npy)) return -5;
  char dt; int isz, nd; int64_t shp[8]; size_t off;
  if (!parse_npy(npy, &dt, &isz, shp, &nd, &off)) return -6;
  int64_t nbytes = (int64_t)(npy.size() - off);
  if (nbytes > cap) return -3;
  memcpy(out, npy.data() + off, nbytes);
  return nbytes;
}

}  // extern "C"
